"""Mamba-2 SSD mixer of the port  [arXiv:2405.21060].

Counterparts of ``repro/models/ssd.py``: ``init_mamba`` (:30-59),
``_causal_conv`` (:62-67), ``ssd_chunked`` (:70-131), ``mamba_forward``
(:134-193) and ``mamba_decode`` (:196-241).  Serving, the chunked scan of
``mamba_forward`` goes through the ``ssd`` kernel wrapper
(``kernels/ssd/ops.py``), which runs the CUDA kernel on the card and its
plain version on the CPU, float32 throughout, as the Pallas kernel
computes it; the JAX layer calls the kernel only with ``use_kernel=True``.
Training (``mamba_forward(..., train=True)``) runs ``ssd_chunked``, as the
reference's training path does (``use_kernel=False``): plain,
differentiable torch that casts the intra-chunk weights to ``x.dtype``
as the reference does (:103), where the kernel keeps float32.  The one-token
decode update runs outside any kernel in JAX too, so here it is plain
torch ops on the device, updating the states in place.  Parameters are
``nn.ParameterDict``s keyed like the JAX pytree; ``A_log``, ``D`` and
``dt_bias`` are float32 in any weight dtype, as JAX keeps them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import _normal, frozen, rms_norm


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype):
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    dev = gen.device
    std = d ** -0.5
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    kw = s.d_conv ** -0.5
    return frozen({
        "ln": torch.zeros((d,), dtype=dtype, device=dev),
        "w_z": _normal(gen, (d, di), std, dtype),
        "w_x": _normal(gen, (d, di), std, dtype),
        "w_B": _normal(gen, (d, gn), std, dtype),
        "w_C": _normal(gen, (d, gn), std, dtype),
        "w_dt": _normal(gen, (d, nh), std, dtype),
        "conv_x": _normal(gen, (s.d_conv, di), kw, dtype),
        "conv_B": _normal(gen, (s.d_conv, gn), kw, dtype),
        "conv_C": _normal(gen, (s.d_conv, gn), kw, dtype),
        "conv_bx": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_bB": torch.zeros((gn,), dtype=dtype, device=dev),
        "conv_bC": torch.zeros((gn,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "gn": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": _normal(gen, (di, d), di ** -0.5, dtype),
    })


def _causal_conv(u, w, b):
    """Depthwise causal conv1d.  u: [B, L, C]; w: [K, C].  The K shifted
    products summed as JAX sums them (no ``F.conv1d``: cuDNN would run an
    fp32 convolution in TF32)."""
    K, L = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L] * w[i] for i in range(K))
    return F.silu(out + b)


def _heads(p, h):
    """The five input projections of the normed input h."""
    return (h @ p["w_z"], h @ p["w_x"], h @ p["w_B"], h @ p["w_C"],
            h @ p["w_dt"])


def ssd_chunked(x, dt, A, B_, C, chunk: int):
    """Chunked SSD scan, the reference's plain training path.

    x: [B, L, H, P]; dt: [B, L, H] (post-softplus, float32); A: [H]
    (negative decay rates); B_/C: [B, L, G, N]; L a multiple of ``chunk``.
    Returns y [B, L, H, P] float32 and the final state [B, H, P, N] f32.
    The intra-chunk weights ``att`` are cast to ``x.dtype`` before their
    product with x (bf16 in training), as in the reference."""
    Bsz, L, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if L % chunk:
        raise ValueError(f"length {L} is not a multiple of the chunk {chunk}")
    nc = L // chunk
    rep = H // G
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, Pd)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bh = B_.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = C.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                               # [B,nc,Q,H]  (negative)
    seg = torch.cumsum(dA, dim=2)              # within-chunk cumulative decay

    # intra-chunk (dense, causal-masked before the exp: no overflow)
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch.to(f32), Bh.to(f32))
    seg_h = seg.transpose(2, 3)                # [B,nc,H,Q]
    diff = seg_h[..., :, None] - seg_h[..., None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    att = cb * decay * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att.to(x.dtype), xc)

    # per-chunk states: S_c = sum_j exp(seg_last - seg_j) dt_j x_j B_j
    last = seg[:, :, -1:, :]
    w_in = torch.exp(last - seg) * dtc         # [B,nc,Q,H]
    S = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w_in, xc.to(f32), Bh.to(f32))

    # inter-chunk recurrence over the chunk states: the state before each
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B,nc,H]
    h = torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_before = torch.stack(before, dim=1)      # [B,nc,H,P,N]

    # inter-chunk output: y_i += (C_i exp(seg_i)) . h_before
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Ch.to(f32) * torch.exp(seg)[..., None], h_before)
    y = y_intra.to(f32) + y_inter
    return y.reshape(Bsz, L, H, Pd), h


def mamba_forward(p, cfg: ModelConfig, x, return_state: bool = False,
                  train: bool = False):
    """Full-sequence Mamba-2 block.  x: [B, L, d] -> [B, L, d]; with
    ``return_state`` also (conv tail {"x", "B", "C"} of the raw projections
    [B, K-1, ·], final SSM state [B, H, P, N] f32) for the decode cache.
    The scan runs the ``ssd`` kernel wrapper, or with ``train`` the plain,
    differentiable ``ssd_chunked``."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    B, L, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z, x_raw, B_raw, C_raw, dt_raw = _heads(p, h)

    xs = _causal_conv(x_raw, p["conv_x"], p["conv_bx"])
    Bv = _causal_conv(B_raw, p["conv_B"], p["conv_bB"])
    Cv = _causal_conv(C_raw, p["conv_C"], p["conv_bC"])
    xs = xs.reshape(B, L, nh, s.head_dim)
    Bv = Bv.reshape(B, L, s.n_groups, s.d_state)
    Cv = Cv.reshape(B, L, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    # pad L to the chunk: zero dt leaves the state unchanged on the padding
    pad = (-L) % s.chunk
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, 0, 0, pad))
    else:
        xs_p = xs
    if train:
        y, state = ssd_chunked(xs_p, dt, A, Bv, Cv, s.chunk)
    else:
        y, state = ssd(xs_p, dt, A, Bv, Cv, chunk=s.chunk)
    y = y[:, :L] + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(B, L, di)
    y = rms_norm(y.to(x.dtype) * F.silu(z.float()).to(x.dtype), p["gn"],
                 cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    tail = s.d_conv - 1

    def tail_of(u):
        return u[:, L - tail:] if L >= tail else F.pad(u, (0, 0, tail - L, 0))

    conv_state = {"x": tail_of(x_raw), "B": tail_of(B_raw),
                  "C": tail_of(C_raw)}
    return out, (conv_state, state)


def mamba_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """Single-token recurrent update, in place.  x: [B, 1, d]; conv_state:
    {"x": [B, K-1, di], "B"/"C": [B, K-1, G·N]} (pre-conv history);
    ssm_state: [B, H, P, N] f32.  Both states are updated in place (the
    engine passes its per-slot tensors whole, row b being slot b).  Returns
    (out [B, 1, d], (conv_state, ssm_state)), the states being the updated
    arguments."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    h = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    z, x_new, B_new, C_new, dt_raw = _heads(p, h)

    def conv_step(hist, new, w, b):
        cat = torch.cat([hist, new[:, None, :]], dim=1)
        out = torch.einsum("bkc,kc->bc", cat[:, -w.shape[0]:], w) + b
        hist.copy_(cat[:, 1:])
        return F.silu(out)

    xs = conv_step(conv_state["x"], x_new, p["conv_x"], p["conv_bx"])
    Bv = conv_step(conv_state["B"], B_new, p["conv_B"], p["conv_bB"])
    Cv = conv_step(conv_state["C"], C_new, p["conv_C"], p["conv_bC"])

    xs = xs.reshape(-1, nh, s.head_dim).float()
    rep = nh // s.n_groups

    def per_head(u):       # [B, G·N] -> [B, H, N]: a group's N to its heads
        u = u.reshape(-1, s.n_groups, 1, s.d_state).float()
        return u.expand(-1, -1, rep, -1).reshape(-1, nh, s.d_state)

    Bv, Cv = per_head(Bv), per_head(Cv)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # [B, H]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    ssm_state.mul_(dA[:, :, None, None]).add_(
        (dt[:, :, None] * xs)[..., None] * Bv[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Cv)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(-1, di)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gn"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], (conv_state, ssm_state)
