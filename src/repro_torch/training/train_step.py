"""Train step: mixed-precision loss + grads + AdamW update.

Counterpart of ``repro/training/train_step.py``: ``cast_half`` (:20-30),
``make_loss_fn`` (:33-47), ``make_train_step`` (:50-65) and
``make_grad_accum_step`` (:68-96), with the sharding context as their
third argument, as the reference's (under a mesh the parameters are
DTensors and the backward pass runs in ``sharded_scope``).  The
parameters are the port's ``Model``, its float32 leaves the masters.  The
loss casts them to bf16 (the cast is differentiable) and runs the model's
plain training forward (``model_forward(..., train=True)``) on the casts
by parameter name, so ``backward()`` leaves float32 gradients in the
masters' ``.grad``: the micro-batches of the accumulation step sum there,
in float32.  The MoE router stays float32 for routing stability.
Differences:

* a step updates the model and the optimizer state in place
  (``optimizer.adamw_step_``) and returns them with its metrics; the
  gradients stay in ``.grad`` until the next step starts;
* a step turns on the gradients of the model's parameters, which the
  port builds frozen for serving;
* a leaf of a layer counts one more dimension than it has, the stage's
  repeat axis of the JAX tree (``jax_ndim``), wherever the reference
  reads ``ndim``: so a layer's norm weights are cast to bf16 and decay,
  as the reference's stacked ones do.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import NULL_CTX, ShardCtx, sharded_scope
from repro_torch.models.model import Model, lm_head_weight, model_forward
from repro_torch.training.loss import chunked_cross_entropy
from repro_torch.training.optimizer import AdamWConfig, adamw_step_

_KEEP_F32 = {"router", "A_log", "D", "dt_bias"}


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The ``ndim`` of parameter ``name``'s leaf in the JAX tree, which
    stacks each layer's leaves over its stage's repeats."""
    return t.ndim + name.startswith("layers.")


def cast_half(params: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """``dtype`` copies of the float32 leaves with ``jax_ndim >= 2``, but
    ``router``, ``A_log``, ``D`` and ``dt_bias``; the other leaves as
    they are.  ``params``: tensors by ``named_parameters`` name."""
    def keep(name, a):
        return (name.rsplit(".", 1)[-1] in _KEEP_F32
                or jax_ndim(name, a) < 2 or a.dtype != torch.float32)
    return {name: a if keep(name, a) else a.to(dtype)
            for name, a in params.items()}


def decay_flags(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """Whether AdamW decays each leaf: ``jax_ndim >= 2``, as the reference
    decays its stacked leaves."""
    return {n: jax_ndim(n, p) >= 2 for n, p in params.items()}


def trainable(model: Model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by name, with their gradients turned on."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def make_loss_fn(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX,
                 ce_chunk: int = 512, remat: bool = True):
    if cfg.logits_scaling != 1.0:
        # the chunked cross entropy forms h @ w_head itself
        raise NotImplementedError(
            f"{cfg.name}: the training loss takes no logits_scaling "
            f"({cfg.logits_scaling})")

    def loss_fn(model: Model, tokens, labels, mask, prefix_embeds=None):
        p_half = cast_half(dict(model.named_parameters()))
        hidden, aux = model_forward(model, tokens, prefix_embeds, ctx,
                                    train=True, remat=remat, params=p_half)
        w = lm_head_weight(model, p_half)
        with sharded_scope(ctx):
            nll, ntok = chunked_cross_entropy(hidden, w, labels, mask,
                                              chunk=ce_chunk, ctx=ctx)
            total = nll
            if cfg.moe is not None:
                total = total + cfg.moe.router_aux_weight * aux
        return total, {"nll": nll, "aux_loss": aux, "n_tokens": ntok}
    return loss_fn


def _start(model: Model) -> Dict[str, torch.nn.Parameter]:
    params = trainable(model)
    for p in params.values():
        p.grad = None
    return params


def _update(opt_cfg: AdamWConfig, params, opt_state: dict) -> dict:
    """AdamW in place on the gradients in ``.grad`` (zeros for a parameter
    the loss did not reach, as JAX's gradient would be)."""
    grads = {n: torch.zeros_like(p, dtype=torch.float32) if p.grad is None
             else p.grad for n, p in params.items()}
    return adamw_step_(opt_cfg, params, grads, opt_state, decay_flags(params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    ctx: ShardCtx = NULL_CTX, ce_chunk: int = 512,
                    remat: bool = True):
    loss_fn = make_loss_fn(cfg, ctx, ce_chunk, remat)

    def train_step(model: Model, opt_state: dict, tokens, labels, mask,
                   prefix_embeds=None):
        params = _start(model)
        total, metrics = loss_fn(model, tokens, labels, mask, prefix_embeds)
        with sharded_scope(ctx):
            total.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(_update(opt_cfg, params, opt_state))
        metrics["loss"] = total.detach()
        return model, opt_state, metrics

    return train_step


def make_grad_accum_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int,
                         ctx: ShardCtx = NULL_CTX, ce_chunk: int = 512):
    """Micro-batched variant: batch leading dim is [accum, micro, ...].  The
    micro-batches' gradients sum in ``.grad`` in float32 and are divided by
    ``accum``; the loss reported is the mean micro loss."""
    loss_fn = make_loss_fn(cfg, ctx, ce_chunk)

    def step(model: Model, opt_state: dict, tokens, labels, mask,
             prefix_embeds=None):
        params = _start(model)
        loss_sum = torch.zeros((), device=model.device)
        with sharded_scope(ctx):
            for i in range(accum):
                pre = None if prefix_embeds is None else prefix_embeds[i]
                total, _ = loss_fn(model, tokens[i], labels[i], mask[i], pre)
                total.backward()
                loss_sum = loss_sum + total.detach()
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(accum)
            metrics = {"loss": loss_sum / accum}
            metrics.update(_update(opt_cfg, params, opt_state))
        return model, opt_state, metrics

    return step
