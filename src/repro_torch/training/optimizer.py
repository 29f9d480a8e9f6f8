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
``adamw_step_`` applies the rules in place, leaf by leaf (the trainer's
step: at minicpm-2b's 2.7 B parameters a functional update would hold a
second set of parameters and moments, 32.7 GB).  ``adamw_update`` is the
functional form, ``adamw_step_`` on copies, for callers that keep their
inputs (the predictor's trainer, the parity tests).  Both
take ``decay``, one flag per leaf in the parameters' layout, where the
caller's leaves do not carry the reference's ``ndim`` (the trainer's
per-layer leaves lack the JAX tree's stacked repeat axis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Union

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
    zeros = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for _, p in _items(params)]
    return {"m": _like(params, zeros),
            "v": _like(params, [z.clone() for z in zeros]), "step": 0}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors,
                 opt_state: dict, decay: Optional[Tensors] = None):
    """Returns (new_params, new_opt_state, metrics): ``adamw_step_`` on
    copies of the parameters and moments, so the inputs stay as they are.
    ``decay``: whether each leaf decays (default: ``ndim >= 2``)."""
    keys = [k for k, _ in _items(params)]
    new_params = _like(params, [params[k].clone() for k in keys])
    new_state = {"m": _like(params, [opt_state["m"][k].clone() for k in keys]),
                 "v": _like(params, [opt_state["v"][k].clone() for k in keys]),
                 "step": opt_state["step"]}
    return new_params, new_state, adamw_step_(cfg, new_params, grads,
                                              new_state, decay)


@torch.no_grad()
def adamw_step_(cfg: AdamWConfig, params: Tensors, grads: Tensors,
                opt_state: dict, decay: Optional[Tensors] = None) -> dict:
    """The update in place: updates the tensors of ``params`` and the
    state's ``m`` and ``v``, advances its ``step``, and returns the metrics.
    One leaf at a time, so the extra memory is a few temporaries of the
    largest leaf.  The clip scale stays a device tensor, so a step reads
    nothing back to the host."""
    step = opt_state["step"]
    b1, b2 = cfg.b1, cfg.b2
    lr, c1, c2 = lr_at(cfg, step), 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    keys = [k for k, _ in _items(params)]
    gnorm = _global_norm([grads[k] for k in keys])
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    for k in keys:
        p, m, v = params[k], opt_state["m"][k], opt_state["v"][k]
        wd = cfg.weight_decay if (p.ndim >= 2 if decay is None
                                  else decay[k]) else 0.0
        g = grads[k].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        u = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        u.add_(wd * p.float()).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p.float() - u)
    opt_state["step"] += 1
    return {"grad_norm": gnorm, "lr": lr}
