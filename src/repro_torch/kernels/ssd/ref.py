"""Plain PyTorch version of the SSD chunked-scan kernel: the CPU path of
``ops.ssd`` and the oracle the kernel is held to.

Computes the function of ``repro/kernels/ssd/ssd.py:ssd_pallas`` chunk by
chunk, as ``repro/models/ssd.py:ssd_chunked`` does.  Everything is float32,
as in the Pallas kernel (``ssd.py:28-33``); ``ssd_chunked`` instead casts
the intra-chunk weights to ``x.dtype`` before their product with x
(``models/ssd.py:103``), which differs from the kernel for bf16 inputs.
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B_, C, chunk: int):
    """x: [B, L, H, P]; dt: [B, L, H] (post-softplus step sizes); A: [H]
    (negative decay rates); B_/C: [B, L, G, N]; L a multiple of ``chunk``.
    Returns (y [B, L, H, P] f32, final state [B, H, P, N] f32)."""
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    f32 = torch.float32
    A = A.to(f32)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    state = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = [torch.zeros((Bsz, 0, H, P), dtype=f32, device=x.device)]
    for c0 in range(0, L, chunk):
        xc = x[:, c0:c0 + chunk].to(f32)                          # [B,Q,H,P]
        dtc = dt[:, c0:c0 + chunk].to(f32)                        # [B,Q,H]
        Bc = B_[:, c0:c0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        Cc = C[:, c0:c0 + chunk].to(f32).repeat_interleave(rep, dim=2)
        seg = torch.cumsum(dtc * A, dim=1)                        # [B,Q,H]
        # intra-chunk: att[i,j] = (C_i . B_j) exp(seg_i - seg_j) dt_j, j <= i;
        # masked before the exp, so no overflow above the diagonal
        cb = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        sh = seg.transpose(1, 2)                                  # [B,H,Q]
        diff = (sh[..., :, None] - sh[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        att = cb * torch.exp(diff) * dtc.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", att, xc)
        # inter-chunk: y_i += (C_i exp(seg_i)) . state^T
        y = y + torch.einsum("bihn,bhpn->bihp",
                             Cc * torch.exp(seg)[..., None], state)
        # state = exp(seg_last) state + sum_j exp(seg_last - seg_j) dt_j x_j B_j
        w = torch.exp(seg[:, -1:] - seg) * dtc                    # [B,Q,H]
        state = (torch.exp(seg[:, -1])[:, :, None, None] * state
                 + torch.einsum("bjhp,bjhn->bhpn", xc * w[..., None], Bc))
        ys.append(y)
    return torch.cat(ys, dim=1), state
