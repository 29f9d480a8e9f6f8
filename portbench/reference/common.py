"""Arithmetic shared by the references: RMSNorm, rotary embedding, causal
attention, SiLU-gated MLP and the matrix product, which in ``fp8`` mode
rounds both operands to float8 e4m3 first (the control of the check)."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def to_fp8(x, dim: int):
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Arith:
    """The precision the reference computes in: ``fp32`` (the reference)
    or ``fp8`` (every weight product with its operands in e4m3: activations
    scaled per row, weights per output column)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def weight(self, w):
        """A weight [.., in, out] in float32 as this mode holds it."""
        w = w.float()
        return to_fp8(w, dim=-2) if self.mode == "fp8" else w

    def mm(self, x, w):
        """x [.., in] @ w [in, out] (w from ``weight``)."""
        if self.mode == "fp8":
            x = to_fp8(x, dim=-1)
        return x @ w


def rms_norm(x, w, eps: float):
    """x / rms(x) * (1 + w): the weight is stored as its offset from 1."""
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, positions, theta: float):
    """Rotary embedding of x [L, H, d] at integer ``positions`` [L], the
    two halves of each head rotated as pairs (i, i + d/2)."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (positions.double()[:, None] * inv)[:, None, :]       # [L, 1, half]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, block: int = 512):
    """softmax(q k^T * scale) v over causal positions, one sequence.
    q [L, H, dq], k [L, H, dq], v [L, H, dv] -> [L, H * dv], in query
    blocks so that the scores stay small."""
    L, H, _ = q.shape
    out = []
    keys = torch.arange(L, device=q.device)
    for s in range(0, L, block):
        qb = q[s:s + block]
        sc = torch.einsum("qhd,khd->hqk", qb, k) * scale
        mask = keys[None, :] > (s + torch.arange(qb.shape[0],
                                                 device=q.device))[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v).reshape(qb.shape[0], -1))
    return torch.cat(out)


def gated_mlp(arith: Arith, h, w_gate, w_up, w_down):
    """down(silu(h gate) * (h up)); weights from ``Arith.weight``."""
    g = arith.mm(h, w_gate)
    return arith.mm(torch.nn.functional.silu(g) * arith.mm(h, w_up), w_down)


def no_tf32():
    """Float32 products in float32 (the card would use TF32 otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def head_dim(conf) -> int:
    return conf["hidden_size"] // conf["num_attention_heads"]
