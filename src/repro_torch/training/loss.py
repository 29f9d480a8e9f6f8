"""Sequence-chunked cross-entropy.

Counterpart of ``repro/training/loss.py:17-47``.  Materialising [B, S, V] logits for V up to 262k is the
dominant activation cost; the loss instead runs over sequence chunks whose
body is rematerialised (``torch.utils.checkpoint``), so peak logits memory
is [B, chunk, V] and the backward pass recomputes each chunk's logits from
(hidden, lm_head).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.context import (NULL_CTX, ShardCtx, _is_dtensor,
                                            replicated_like)


def _chunk_nll(h, w_head, labels, mask):
    """Summed masked NLL of one chunk: h [B, C, d], labels/mask [B, C].  A
    DTensor's target logit is a masked sum over the (vocab-sharded)
    columns, exact (one term is not zero), where a gather would need the
    columns whole."""
    logits = (h @ w_head).float()                              # [B, C, V]
    lse = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        cols = replicated_like(
            torch.arange(logits.shape[-1], device=labels.device), logits)
        tgt = torch.where(cols == labels[..., None], logits, 0.0).sum(-1)
    else:
        tgt = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mask.float())


def chunked_cross_entropy(hidden, w_head, labels, mask, chunk: int = 512,
                          ctx: ShardCtx = NULL_CTX):
    """hidden: [B, S, d]; w_head: [d, V] (the padded vocab's columns join the
    logsumexp, as in JAX); labels/mask: [B, S].  S is padded to the chunk
    with label 0 and mask 0.

    Returns (mean_nll, n_tokens), the mean over ``max(sum(mask), 1)``."""
    B, S = hidden.shape[:2]
    # re-gather the sequence-parallel residual stream once before chunking
    hidden = ctx.constraint(hidden, ctx.batch_spec_entry(B), None, None)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_nll, hidden[:, sl], w_head,
                                   labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    n_tok = torch.clamp(torch.sum(mask.float()), min=1.0)
    return total / n_tok, n_tok
