"""AdamW + LR schedules (cosine, and WSD for MiniCPM) in PyTorch.

Port of ``repro/training/optimizer.py`` with the same rules, written out
rather than taken from ``torch.optim.AdamW``, whose results differ:

* one global-norm clip over every gradient handed in (masked ones
  included, so a zero gradient adds nothing to the norm);
* bias correction by ``b1 ** (step + 1)`` and ``b2 ** (step + 1)``;
* decoupled weight decay on every parameter with ``ndim >= 2``, whatever
  its gradient: a parameter whose gradient the caller masked to zero
  still shrinks by ``lr * weight_decay * p`` per step.

Parameters and gradients are a list or a dict of tensors; the state holds
``m`` and ``v`` in float32 in the same layout and ``step`` as a Python int.
The update is functional: it returns new tensors and leaves its inputs as
they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Union

import torch

Tensors = Union[List[torch.Tensor], Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"      # cosine | wsd | const
    wsd_stable_frac: float = 0.8  # fraction of post-warmup steps held stable
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: int) -> float:
    step = float(step)
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    t = min(max((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + math.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # warmup -> stable plateau -> sharp decay tail (MiniCPM, arXiv:2404.06395)
        s = cfg.wsd_stable_frac
        tail = min(max((t - s) / max(1 - s, 1e-9), 0.0), 1.0)
        decay = 1.0 if t < s else cfg.min_lr_frac ** tail
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def _items(tree: Tensors):
    return list(tree.items()) if isinstance(tree, dict) else list(
        enumerate(tree))


def _like(tree: Tensors, values):
    if isinstance(tree, dict):
        return dict(zip(tree, values))
    return list(values)


def init_opt_state(params: Tensors) -> dict:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for _, p in _items(params)]
    return {"m": _like(params, zeros),
            "v": _like(params, [z.clone() for z in zeros]), "step": 0}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors,
                 opt_state: dict):
    """Returns (new_params, new_opt_state, metrics).  The clip scale stays a
    device tensor, so a step reads nothing back to the host."""
    step = opt_state["step"]
    keys = [k for k, _ in _items(params)]
    flat_p = [params[k] for k in keys]
    flat_g = [grads[k] for k in keys]
    flat_m = [opt_state["m"][k] for k in keys]
    flat_v = [opt_state["v"][k] for k in keys]
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** (step + 1)
    c2 = 1.0 - b2 ** (step + 1)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        newp = p.float() - lr * (u + wd * p.float())
        return newp.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                    flat_v)]
    new_params = _like(params, [o[0] for o in out])
    new_state = {"m": _like(params, [o[1] for o in out]),
                 "v": _like(params, [o[2] for o in out]), "step": step + 1}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
