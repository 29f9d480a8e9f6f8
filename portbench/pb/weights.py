"""Weights drawn from the run's seed on the device, in the type the port
holds each in, a few large draws: one per group of leaves that share an
init scale and a type.  The program gets them wrapped in its ``Model``;
the reference reads the same tensors."""
from __future__ import annotations

from collections import defaultdict

import torch

DRAW = 1 << 30          # elements a draw: 2 GiB of bf16


def draw(leaves, seed: int, layout: dict, device) -> dict:
    """{name: tensor} for the reference's ``leaves``, (name, shape, std,
    kind) or (name, shape, std, kind, mean): mean + std·N(0, 1), the mean
    0 where the leaf states none; norms (kind "norm") 1 + N(0, std) stored
    as the offset (N(0, std)); embedding rows and head columns past the
    vocabulary zero.  Each leaf is drawn in the type ``layout`` ({name:
    (shape, dtype)}, ``program.layout``) gives it: float32 where the port
    holds it so (the router, a Mamba layer's ``A_log``, ``D`` and
    ``dt_bias``) in bf16 weights too."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups = defaultdict(list)
    for name, shape, std, kind, *mean in leaves:
        if name not in layout:
            raise ValueError(f"{name}: the port holds no such parameter")
        groups[(std, layout[name][1])].append((name, shape, mean))
    out = {}
    for (std, dt), members in sorted(groups.items(),
                                     key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [_numel(shape) for _, shape, _ in members]
        flat = torch.empty(sum(sizes), dtype=dt, device=device)
        for start in range(0, flat.numel(), DRAW):
            flat[start:start + DRAW].normal_(0.0, std, generator=gen)
        for (name, shape, mean), part in zip(members, flat.split(sizes)):
            out[name] = part.view(shape)
            if mean:
                out[name].add_(mean[0])
    return out


def zero_padding(weights: dict, leaves, vocab: int) -> None:
    """Zero the embedding rows and head columns past ``vocab``."""
    for name, shape, _, kind, *_ in leaves:
        if kind == "embed" and shape[0] > vocab:
            weights[name][vocab:] = 0
        elif kind == "head" and shape[1] > vocab:
            weights[name][:, vocab:] = 0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
