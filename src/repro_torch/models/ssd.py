"""Mamba-2 SSD mixer of the port  [arXiv:2405.21060].

Counterparts of ``repro/models/ssd.py``: ``init_mamba`` (:30-59),
``_causal_conv`` (:62-67), ``mamba_forward`` (:134-193) and
``mamba_decode`` (:196-241).  The chunked scan of ``mamba_forward`` always
goes through the ``ssd`` kernel wrapper (``kernels/ssd/ops.py``), which
runs the CUDA kernel on the card and its plain version on the CPU; the
JAX layer calls the kernel only with ``use_kernel=True``.  The scan is
float32 throughout, as the Pallas kernel computes it.  The one-token
decode update runs outside any kernel in JAX too, so here it is plain
torch ops on the device.  Parameters are ``nn.ParameterDict``s keyed like
the JAX pytree; ``A_log``, ``D`` and ``dt_bias`` are float32 in any
weight dtype, as JAX keeps them.
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


def mamba_forward(p, cfg: ModelConfig, x, return_state: bool = False):
    """Full-sequence Mamba-2 block.  x: [B, L, d] -> [B, L, d]; with
    ``return_state`` also (conv tail {"x", "B", "C"} of the raw projections
    [B, K-1, ·], final SSM state [B, H, P, N] f32) for the decode cache."""
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
    """Single-token recurrent update.  x: [B, 1, d]; conv_state: {"x":
    [B, K-1, di], "B"/"C": [B, K-1, G·N]} (pre-conv history); ssm_state:
    [B, H, P, N] f32.  Returns (out [B, 1, d], (new conv_state, new
    ssm_state))."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    h = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    z, x_new, B_new, C_new, dt_raw = _heads(p, h)

    def conv_step(hist, new, w, b):
        cat = torch.cat([hist, new[:, None, :]], dim=1)
        out = torch.einsum("bkc,kc->bc", cat[:, -w.shape[0]:], w) + b
        return F.silu(out), cat[:, 1:]

    xs, nhx = conv_step(conv_state["x"], x_new, p["conv_x"], p["conv_bx"])
    Bv, nhB = conv_step(conv_state["B"], B_new, p["conv_B"], p["conv_bB"])
    Cv, nhC = conv_step(conv_state["C"], C_new, p["conv_C"], p["conv_bC"])
    new_conv = {"x": nhx, "B": nhB, "C": nhC}

    xs = xs.reshape(-1, nh, s.head_dim).float()
    rep = nh // s.n_groups
    Bv = Bv.reshape(-1, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).float()
    Cv = Cv.reshape(-1, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # [B, H]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    new_state = (dA[:, :, None, None] * ssm_state
                 + (dt[:, :, None] * xs)[..., None] * Bv[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cv)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(-1, di)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gn"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], (new_conv, new_state)
