"""Weights drawn from the run's seed on the device, in the type they are
served in, a few large draws: one per group of leaves that share an init
scale.  The program gets them wrapped in its ``Model``; the reference reads
the same tensors."""
from __future__ import annotations

from collections import defaultdict

import torch

DRAW = 1 << 30          # elements a draw: 2 GiB of bf16


def draw(leaves, seed: int, dtype, device) -> dict:
    """{name: tensor} for the reference's ``leaves``: normal draws times
    their std; norms 1 + N(0, std) stored as the offset (N(0, std));
    embedding rows and head columns past the vocabulary zero; the router
    (kind "router") in float32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups = defaultdict(list)
    for name, shape, std, kind in leaves:
        dt = torch.float32 if kind == "router" else dtype
        groups[(std, dt)].append((name, shape, kind))
    out = {}
    for (std, dt), members in sorted(groups.items(),
                                     key=lambda kv: (kv[0][0], str(kv[0][1]))):
        sizes = [_numel(shape) for _, shape, _ in members]
        flat = torch.empty(sum(sizes), dtype=dt, device=device)
        for start in range(0, flat.numel(), DRAW):
            flat[start:start + DRAW].normal_(0.0, std, generator=gen)
        for (name, shape, _), part in zip(members, flat.split(sizes)):
            out[name] = part.view(shape)
    return out


def zero_padding(weights: dict, leaves, vocab: int) -> None:
    """Zero the embedding rows and head columns past ``vocab``."""
    for name, shape, _, kind in leaves:
        if kind == "embed" and shape[0] > vocab:
            weights[name][vocab:] = 0
        elif kind == "head" and shape[1] > vocab:
            weights[name][:, vocab:] = 0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
