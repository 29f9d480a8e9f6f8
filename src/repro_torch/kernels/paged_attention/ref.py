"""Plain PyTorch version of the paged decode kernel: the CPU path of
``ops.paged_attention`` and the oracle the kernel is held to.

Same function as ``repro/kernels/paged_attention/ref.py:paged_attention_ref``
except at ``context_lens == 0``: the JAX oracle then averages V uniformly,
while the Pallas kernel (and the CUDA kernel of this port) returns zeros.
This version pins the kernels' behaviour.  ``softcap`` caps the scaled
scores as ``tanh(s / c) * c`` before the mask and the softmax, as the
JAX model's ``_sdpa`` does (``repro/models/layers.py:119-128``)."""
from __future__ import annotations

from typing import Optional

import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """q: [B, H, hd]; k/v_pages: [P, page, KV, hd];
    block_tables: [B, n_pages] int32; context_lens: [B] int32 -> [B, H, hd].
    Scores scaled by ``scale``, or hd ** -0.5 where it is None."""
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    G = H // KV
    S = block_tables.shape[1] * page
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, S, KV, hd).float()
    v = v_pages[bt].reshape(B, S, KV, hd).float()
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) \
        * (hd ** -0.5 if scale is None else scale)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    ctx = context_lens.long()
    valid = torch.arange(S, device=q.device)[None] < ctx[:, None]
    s = s.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v)
    o = torch.where((ctx > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, H, hd).to(q.dtype)
