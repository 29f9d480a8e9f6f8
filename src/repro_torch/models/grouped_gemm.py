"""Grouped (per-expert) GEMM with the reference's memory-safe backward.

Counterpart of ``repro/models/grouped_gemm.py``: ``grouped_gemm`` (:53-56,
``lax.ragged_dot``) and its custom VJP (:59-80) as a
``torch.autograd.Function``.  Both gradients are grouped GEMMs:

    y      = x_g @ w[g]              per group g of rows      [M, N]
    dx     = dy_g @ w[g]^T                                     [M, K]
    dw[g]  = x_g^T dy_g  in float32, cast to w's dtype         [G, K, N]

``group_sizes`` gets no gradient.  Plain torch, one matmul per group: the
reference runs no Pallas kernel here, and, as there, no model path calls
it (``repro/models/layers.py:21`` only imports it; the MoE FFN dispatches
into capacity slots with batched matmuls).  The group sizes are read on
the host.
"""
from __future__ import annotations

import torch


def _bounds(group_sizes: torch.Tensor):
    sizes = [int(s) for s in group_sizes.tolist()]
    starts = [0]
    for s in sizes:
        starts.append(starts[-1] + s)
    return list(zip(starts[:-1], starts[1:]))


class _GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        out = lhs.new_zeros((lhs.shape[0], rhs.shape[2]))
        for g, (a, b) in enumerate(_bounds(group_sizes)):
            out[a:b] = lhs[a:b] @ rhs[g]
        return out

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        f32 = torch.float32
        d_lhs = torch.zeros(lhs.shape, dtype=f32, device=lhs.device)
        d_rhs = torch.zeros(rhs.shape, dtype=f32, device=rhs.device)
        for g, (a, b) in enumerate(_bounds(group_sizes)):
            d_lhs[a:b] = dy[a:b].to(f32) @ rhs[g].to(f32).T
            d_rhs[g] = lhs[a:b].to(f32).T @ dy[a:b].to(f32)
        return d_lhs.to(lhs.dtype), d_rhs.to(rhs.dtype), None


def grouped_gemm(lhs, rhs, group_sizes):
    """lhs: [M, K] rows sorted by group; rhs: [G, K, N]; group_sizes: [G]
    int.  Returns [M, N] where row m is lhs[m] @ rhs[group(m)]; rows past
    ``sum(group_sizes)`` are zero."""
    return _GroupedGemm.apply(lhs, rhs, group_sizes)
