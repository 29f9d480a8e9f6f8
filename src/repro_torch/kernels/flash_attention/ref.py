"""Plain PyTorch version of the flash-attention kernel: the CPU path of
``ops.flash_attention`` and the oracle the kernel is held to.  Same
function as ``repro/kernels/flash_attention/ref.py:attention_ref``."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """q: [B, Lq, H, hd]; k/v: [B, Lk, KV, hd] -> [B, Lq, H, hd].  q rows
    are the tail of k: row i sits at absolute position i + Lk - Lq."""
    B, Lq, H, hd = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Lq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    ki = torch.arange(Lk, device=q.device)[None, :]
    m = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    s = s.masked_fill(~m, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Lq, H, hd).to(q.dtype)
