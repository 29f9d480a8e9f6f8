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
``dt_bias`` are float32 in any weight dtype, as JAX keeps them.  Under a
``ShardCtx`` the projections are DTensors constrained where the reference
constrains them (:142-163), and the kernel runs inside ``local_map`` on
each rank's shard: the batch over the data axes, the heads over the model
axis where they divide it, each rank holding the B/C groups its heads read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (NULL_CTX, ShardCtx, _is_dtensor,
                                            contiguous_grads, replicated_like)
from repro_torch.distributed.sharding import placements
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.models.layers import (_normal, block_input, frozen,
                                       generator_of, local_heads, rms_norm,
                                       split_heads)


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype):
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    dev = gen.device
    std = d ** -0.5
    u = torch.rand((nh,), generator=generator_of(gen), dtype=torch.float32,
                   device=dev)
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


def _conv(u, w, b, ctx: ShardCtx = NULL_CTX):
    """``_causal_conv``; under a mesh on each rank's shard (``local_map``):
    the batch over the data axes, the channels over the model axis where
    they divide it.  Gradients: u's on its own shard, w's and b's this
    data shard's part (summed over the data axes)."""
    if not (ctx.enabled and _is_dtensor(u)):
        return _causal_conv(u, w, b)
    from torch.distributed.tensor.experimental import local_map
    ch = ctx.model_axis_if_divides(u.shape[-1])
    u_pl = placements((ctx.batch_spec_entry(u.shape[0]), None, ch), ctx.mesh)
    w_spec, b_spec = (None, ch), (ch,)
    return local_map(
        _causal_conv, out_placements=(u_pl,),
        in_placements=(u_pl, placements(w_spec, ctx.mesh),
                       placements(b_spec, ctx.mesh)),
        in_grad_placements=(u_pl, ctx.data_partial(w_spec),
                            ctx.data_partial(b_spec)),
        device_mesh=ctx.mesh, redistribute_inputs=True)(u, w, b)


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
    causal = replicated_like(torch.ones((chunk, chunk), dtype=torch.bool,
                                        device=x.device).tril(), x)
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    att = cb * decay * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att.to(x.dtype), xc)

    # per-chunk states: S_c = sum_j exp(seg_last - seg_j) dt_j x_j B_j
    last = seg[:, :, -1:, :]
    w_in = torch.exp(last - seg) * dtc         # [B,nc,Q,H]
    S = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w_in, xc.to(f32), Bh.to(f32))

    # inter-chunk recurrence over the chunk states: the state before each
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B,nc,H]
    h = replicated_like(torch.zeros((Bsz, H, Pd, N), dtype=f32,
                                    device=x.device), x)
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


def _scan(xs, dt, A, Bv, Cv, chunk: int, train: bool):
    """The chunked scan over L padded to the chunk (zero dt leaves the state
    unchanged on the padding): y [B, L, H, P] f32 and the final state."""
    L = xs.shape[1]
    pad = (-L) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, 0, 0, pad))
    if train:
        y, state = ssd_chunked(xs, dt, A, Bv, Cv, chunk)
    else:
        y, state = ssd(xs, dt, A, Bv, Cv, chunk=chunk)
    return y[:, :L], state


def _scan_sharded(xs, dt, A, Bv, Cv, chunk: int, ctx: ShardCtx,
                  train: bool):
    """``_scan`` on each rank's shard, under ``local_map``: through the
    kernel, or with ``train`` the plain ``ssd_chunked`` (whose DTensor
    einsums would flatten sharded dims).  Gradients: x's and dt's on their
    own shard; A's this data shard's part; B's and C's also each model
    rank's part where the heads are sharded but the groups are not."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    B, _, H, _ = xs.shape
    G = Bv.shape[2]
    bspec = ctx.batch_spec_entry(B)
    h_ax = ctx.model_axis_if_divides(H)
    g_ax = ctx.model_axis_if_divides(G) if h_ax else None

    def pl(*spec):
        return placements(spec, ctx.mesh)

    def body(x, dt_, A_, B_, C_):
        x, dt_, A_, B_, C_ = contiguous_grads(x, dt_, A_, B_, C_)
        if h_ax and not g_ax:
            r = ctx.mesh.get_local_rank(ctx.model_axis)
            B_, C_ = (local_heads(t, H, x.shape[2], r) for t in (B_, C_))
        return _scan(x.contiguous(), dt_.contiguous(), A_.contiguous(),
                     B_.contiguous(), C_.contiguous(), chunk, train)
    x_pl, dt_pl, bc = (pl(bspec, None, h_ax, None), pl(bspec, None, h_ax),
                       pl(bspec, None, g_ax, None))
    bc_grad = bc
    if h_ax and not g_ax:
        bc_grad = tuple(Partial() if a == ctx.model_axis else p
                        for a, p in zip(ctx.mesh.mesh_dim_names, bc))
    return local_map(
        body, out_placements=(x_pl, pl(bspec, h_ax, None, None)),
        in_placements=(x_pl, dt_pl, pl(h_ax), bc, bc),
        in_grad_placements=(x_pl, dt_pl, ctx.data_partial((h_ax,)), bc_grad,
                            bc_grad),
        device_mesh=ctx.mesh, redistribute_inputs=True)(xs, dt, A, Bv, Cv)


def mamba_forward(p, cfg: ModelConfig, x, ctx: ShardCtx = NULL_CTX,
                  return_state: bool = False, train: bool = False):
    """Full-sequence Mamba-2 block.  x: [B, L, d] -> [B, L, d]; with
    ``return_state`` also (conv tail {"x", "B", "C"} of the raw projections
    [B, K-1, ·], final SSM state [B, H, P, N] f32) for the decode cache.
    The scan runs the ``ssd`` kernel wrapper, or with ``train`` the plain,
    differentiable ``ssd_chunked``; under a mesh either runs inside
    ``local_map``."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    B, L, _ = x.shape
    bspec = ctx.batch_spec_entry(B)
    h = block_input(x, p["ln"], cfg, ctx)
    z, x_raw, B_raw, C_raw, dt_raw = _heads(p, h)
    z = ctx.constraint(z, bspec, None, ctx.model_axis_if_divides(di))
    x_raw = ctx.constraint(x_raw, bspec, None, ctx.model_axis_if_divides(di))

    xs = _conv(x_raw, p["conv_x"], p["conv_bx"], ctx)
    Bv = _conv(B_raw, p["conv_B"], p["conv_bB"], ctx)
    Cv = _conv(C_raw, p["conv_C"], p["conv_bC"], ctx)
    xs = split_heads(xs, nh, ctx)
    Bv = Bv.reshape(B, L, s.n_groups, s.d_state)
    Cv = Cv.reshape(B, L, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = ctx.constraint(xs, bspec, None, ctx.model_axis_if_divides(nh), None)
    if ctx.enabled and _is_dtensor(xs):
        y, state = _scan_sharded(xs, dt, A, Bv, Cv, s.chunk, ctx, train)
    else:
        y, state = _scan(xs, dt, A, Bv, Cv, s.chunk, train)
    y = y + xs.float() * p["D"][None, None, :, None]
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
