"""A dense layer's elementwise glue, fused: the wrappers around
``csrc/decode_fused.cu``.

These kernels take the place of the PyTorch elementwise, reduction and
index kernels between a dense layer's GEMMs and its attention kernel, in
the decode step and in prefill (no TPU kernel: XLA fuses this glue inside
the JAX package's jitted step and prefill):

* :func:`add_rms_norm`: the residual add, the block's output times a
  residual multiplier ``alpha`` (muP; 1 by default), folded into the next
  RMSNorm;
* :func:`rope_kv_write`: qk_norm where the config has it, the rotary
  embedding of q and k at each row's position (none for a NoPE config,
  ``theta`` None), and the new K/V's store into its page or ring slot, the
  position and slot formed on the device;
* :func:`rope_kv_prefill`: the same for the rows of a prompt or chunk at
  positions ``pos0`` onward, the rotated K (and V) stored where the flash
  kernel reads them: the prompt's own K buffer or the staging cache;
* :func:`act_mul`: the gated FFN's ``act(g) * u``.

A CUDA tensor in bf16 or fp32 launches the kernel; a CPU tensor takes the
plain chain in ``ref.py``; any other dtype raises.  Each wrapper's
``launches`` counts its kernel launches, one a call.  Forward only: with
grad mode on, an input that requires grad raises (``_build.refuse_grad``),
on the CPU too.  On meta tensors (a dry run) a wrapper computes nothing:
it returns empty outputs and reports its kernel's flops and bytes to
``_build.record_cost`` (``rope_kv_prefill`` takes CPU and CUDA tensors
only: the dry run's meta tensors take the plain layers).
The fused layer loop, ``models.model._fused_layers``, calls them:
``add_rms_norm`` for the residual policy, and through the layers
``rope_kv_write`` (``decode_step``), ``rope_kv_prefill`` (``prefill``,
``prefill_chunk`` and the serving ``model_forward`` on CPU and CUDA
tensors outside a mesh) and ``act_mul``.  The plain loop,
``_plain_layers`` (the mesh paths, meta tensors and the ring decode), and
training call none.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_fused.ref import (act_mul_ref,
                                                  add_rms_norm_ref,
                                                  rope_kv_prefill_ref,
                                                  rope_kv_write_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
ACTS = ("silu", "gelu")          # act_mul's activations, in kernel order
MAX_HEAD_DIM = 256               # rope_kv_write: 4 pairs a lane

# (theta, head dim, device) -> rope's frequencies [hd / 2] fp32 there
_ROPE_TABLES: Dict[Tuple[float, int, torch.device], torch.Tensor] = {}


def rope_table(theta: float, hd: int, device: torch.device) -> torch.Tensor:
    """``layers.rope``'s frequencies [hd / 2] on ``device``, built there
    with rope's own expression at the first call and kept.  The first call
    for a key must not be under CUDA graph capture (the engine's warm-up
    steps run before it captures)."""
    key = (float(theta), hd, device)
    if key not in _ROPE_TABLES:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("rope_kv_write's first call at a theta and "
                               "head dim must run before CUDA graph capture")
        from repro_torch.models.layers import rope_freqs
        _ROPE_TABLES[key] = rope_freqs(hd, theta, device)
    return _ROPE_TABLES[key]


def _same(name: str, *tensors) -> None:
    """One device and one dtype of fp32/bf16, every tensor contiguous."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs lie on different devices")
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or not dts <= set(_DTYPES):
        raise TypeError(f"{name}: want one dtype of fp32/bf16, got "
                        f"{sorted(map(str, dts))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _vec(n: int, *tensors) -> int:
    """1 where ``n`` elements a row and every pointer allow the kernels'
    16-byte vectors, else 0."""
    per = 16 // tensors[0].element_size()
    return int(n % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def add_rms_norm(x, y, w, eps: float, alpha: float = 1.0):
    """x, y: [..., d] (y None: no add); w: [d] -> (s, rms_norm(s, w, eps))
    with s = x + alpha * y formed in fp32 and rounded once to x's dtype (x
    itself where y is None)."""
    ins = (x, w) if y is None else (x, y, w)
    _same("add_rms_norm", *ins)
    d = x.shape[-1]
    if tuple(w.shape) != (d,) or (y is not None and y.shape != x.shape):
        raise ValueError(f"add_rms_norm: want x, y [..., d], w [d]; got "
                         f"{tuple(x.shape)}, "
                         f"{None if y is None else tuple(y.shape)}, "
                         f"{tuple(w.shape)}")
    _build.refuse_grad("add_rms_norm", *ins)
    if x.device.type == "cpu":
        return add_rms_norm_ref(x, y, w, eps, alpha)
    s = x if y is None else torch.empty_like(x)
    out = torch.empty_like(x)
    if x.device.type == "meta":
        n = x.numel()
        # x and out, with y the sum's read and write too, and w
        _build.record_cost("add_rms_norm", 5.0 * n, x.element_size()
                           * ((2 if y is None else 4) * n + d))
        return s, out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows = x.numel() // d
    if rows == 0:
        return s, out
    fn = _build.entry("decode_fused", "add_rms_norm_launch",
                      [_P] * 5 + [_I] * 2 + [ctypes.c_float] * 2 + [_I] * 2
                      + [_P])
    err = fn(x.data_ptr(), None if y is None else y.data_ptr(), w.data_ptr(),
             None if y is None else s.data_ptr(), out.data_ptr(), rows, d,
             float(eps), float(alpha), _vec(d, *ins, s, out),
             int(x.dtype == torch.bfloat16), _stream(x))
    _build.check("decode_fused", err)
    add_rms_norm.launches += 1
    return s, out


add_rms_norm.launches = 0


def _check_rope(q, k, v, context_lens, tables, k_pages, v_pages, q_norm,
                k_norm, ring):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"rope_kv_write: want q [B,H,hd], k/v [B,KV,hd], "
                         f"k/v_pages [P,page,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, _, hd = q.shape
    if k.shape[0] != B or k.shape[2] != hd or k_pages.shape[2:] != k.shape[1:]:
        raise ValueError("rope_kv_write: q, k/v and the pages disagree on "
                         "batch, KV heads or head dim")
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"rope_kv_write: head dim {hd} is odd or above "
                         f"{MAX_HEAD_DIM}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("rope_kv_write: give both of q_norm, k_norm or "
                         "neither")
    norms = () if q_norm is None else (q_norm, k_norm)
    if any(tuple(t.shape) != (hd,) for t in norms):
        raise ValueError("rope_kv_write: q_norm and k_norm must be [hd]")
    if (tables.dim() != 2 or tables.shape[0] != B or tables.shape[1] == 0
            or tuple(context_lens.shape) != (B,)):
        raise ValueError("rope_kv_write: want tables [B, n>0], "
                         "context_lens [B]")
    if tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("rope_kv_write: tables and context_lens must be "
                        "int32")
    if tables.stride(1) != 1 or not context_lens.is_contiguous():
        raise ValueError("rope_kv_write: tables' rows and context_lens must "
                         "be contiguous")
    if ring is not None and ring <= 0:
        raise ValueError(f"rope_kv_write: ring of {ring} rows")
    _same("rope_kv_write", q, k, v, k_pages, v_pages, *norms)
    if len({t.device for t in (q, tables, context_lens)}) != 1:
        raise ValueError("rope_kv_write: inputs lie on different devices")


def rope_kv_write(q, k, v, context_lens, tables, k_pages, v_pages,
                  theta: Optional[float], q_norm=None, k_norm=None,
                  eps: float = 1e-6, ring: Optional[int] = None):
    """q [B, H, hd], k/v [B, KV, hd] (one token a row); context_lens int32
    [B] counts the new token; tables int32 [B, n] name each row's pages of
    k/v_pages [P, page, KV, hd].  Applies ``q_norm``/``k_norm`` [hd] where
    given, rotates q and k at the row's position (``theta`` None: no
    rotation, NoPE), stores k and v into the row's slot in place and
    returns the (rotated) q [B, H, hd].  ``ring``
    None: paged rows, position and slot row ``context_lens - 1``; ``ring``
    S: a window ring of S rows, position ``max(context_lens - 1, 0)``, slot
    row ``position % S``."""
    _check_rope(q, k, v, context_lens, tables, k_pages, v_pages, q_norm,
                k_norm, ring)
    _build.refuse_grad("rope_kv_write", q, k, v, k_pages, v_pages)
    if q.device.type == "cpu":
        return rope_kv_write_ref(q, k, v, context_lens, tables, k_pages,
                                 v_pages, theta, q_norm, k_norm, eps, ring)
    out = torch.empty_like(q)
    B, H, hd = q.shape
    KV = k.shape[1]
    if q.device.type == "meta":
        elems = B * (H + KV) * hd
        _build.record_cost(
            "rope_kv_write", (3.0 * (theta is not None)
                              + 4.0 * (q_norm is not None)) * elems,
            q.element_size() * (2 * elems + 2 * B * KV * hd
                                + 2 * hd * (q_norm is not None))
            + 4 * (hd // 2 + 2 * B))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if B == 0:
        return out
    freq = None if theta is None else rope_table(theta, hd, q.device)
    fn = _build.entry("decode_fused", "rope_kv_write_launch",
                      [_P] * 11 + [_I] * 7 + [ctypes.c_float, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if q_norm is None else q_norm.data_ptr(),
             None if k_norm is None else k_norm.data_ptr(),
             None if freq is None else freq.data_ptr(),
             context_lens.data_ptr(), tables.data_ptr(), out.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), B, H, KV, hd,
             k_pages.shape[1], tables.stride(0), ring or 0, float(eps),
             int(q.dtype == torch.bfloat16), _stream(q))
    _build.check("decode_fused", err)
    rope_kv_write.launches += 1
    return out


rope_kv_write.launches = 0


def rope_kv_prefill(q, k, v, pos0: int, theta: Optional[float],
                    q_norm=None, k_norm=None, eps: float = 1e-6,
                    k_out=None, v_out=None):
    """q [B, L, H, hd], k/v [B, L, KV, hd] (contiguous): the projections of
    a prompt's or chunk's rows, row i at position ``pos0 + i``.  Applies
    ``q_norm``/``k_norm`` [hd] where given and rotates q and k (``theta``
    None: no rotation, NoPE).  ``k_out`` and ``v_out`` [B, L, KV, hd],
    given together (rows of KV * hd in one stride; the staging cache's rows
    ``pos0`` onward): the rotated k and v are stored there in place.
    Returns (rotated q, rotated k): a new [B, L, KV, hd] where ``k_out`` is
    None (v is then left where it is), else ``k_out``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"rope_kv_prefill: want q [B,L,H,hd], k/v "
                         f"[B,L,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lr, H, hd = q.shape
    KV = k.shape[2]
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"rope_kv_prefill: head dim {hd} is odd or above "
                         f"{MAX_HEAD_DIM}")
    if (q_norm is None) != (k_norm is None) or (k_out is None) != \
            (v_out is None):
        raise ValueError("rope_kv_prefill: give both of q_norm, k_norm and "
                         "both of k_out, v_out, or neither")
    norms = () if q_norm is None else (q_norm, k_norm)
    if any(tuple(t.shape) != (hd,) for t in norms):
        raise ValueError("rope_kv_prefill: q_norm and k_norm must be [hd]")
    outs = () if k_out is None else (k_out, v_out)
    if any(t.shape != k.shape for t in outs) or (outs and (
            k_out.stride() != v_out.stride()
            or k_out.stride()[1:] != (KV * hd, hd, 1))):
        raise ValueError("rope_kv_prefill: k_out and v_out must be "
                         "[B, L, KV, hd] with rows of KV * hd in one stride")
    if pos0 < 0:
        raise ValueError(f"rope_kv_prefill: pos0 {pos0}")
    _same("rope_kv_prefill", q, k, v, *norms)
    if any(t.device != q.device or t.dtype != q.dtype for t in outs):
        raise ValueError("rope_kv_prefill: k_out and v_out must be on q's "
                         "device, in its dtype")
    _build.refuse_grad("rope_kv_prefill", q, k, v, *outs)
    if q.device.type == "cpu":
        return rope_kv_prefill_ref(q, k, v, pos0, theta, q_norm, k_norm, eps,
                                   k_out, v_out)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q_out = torch.empty_like(q)
    k_rot = torch.empty_like(k) if k_out is None else k_out
    if q.numel() == 0:
        return q_out, k_rot
    freq = None if theta is None else rope_table(theta, hd, q.device)
    fn = _build.entry("decode_fused", "rope_kv_prefill_launch",
                      [_P] * 9 + [ctypes.c_longlong] + [_I] * 6
                      + [ctypes.c_float, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if q_norm is None else q_norm.data_ptr(),
             None if k_norm is None else k_norm.data_ptr(),
             None if freq is None else freq.data_ptr(), q_out.data_ptr(),
             k_rot.data_ptr(), None if v_out is None else v_out.data_ptr(),
             k_rot.stride(0) if B > 1 else Lr * KV * hd, B, Lr, H, KV, hd,
             pos0, float(eps),
             int(q.dtype == torch.bfloat16), _stream(q))
    _build.check("decode_fused", err)
    rope_kv_prefill.launches += 1
    return q_out, k_rot


rope_kv_prefill.launches = 0


def act_mul(g, u, act: str):
    """``act(g) * u`` for g, u of one shape: silu, or tanh-gelu for
    ``act == "gelu"``; rounded to their dtype after the activation and
    after the product."""
    if act not in ACTS:
        raise ValueError(f"act_mul: activation {act!r} is none of {ACTS}")
    _same("act_mul", g, u)
    if g.shape != u.shape:
        raise ValueError(f"act_mul: shapes {tuple(g.shape)} and "
                         f"{tuple(u.shape)} differ")
    _build.refuse_grad("act_mul", g, u)
    if g.device.type == "cpu":
        return act_mul_ref(g, u, act)
    out = torch.empty_like(g)
    n = g.numel()
    if g.device.type == "meta":
        _build.record_cost("act_mul", (5.0 if act == "silu" else 10.0) * n,
                           3.0 * g.element_size() * n)
        return out
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if n == 0:
        return out
    fn = _build.entry("decode_fused", "act_mul_launch",
                      [_P] * 3 + [ctypes.c_longlong] + [_I] * 3 + [_P])
    err = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), n, ACTS.index(act),
             _vec(n, g, u, out), int(g.dtype == torch.bfloat16), _stream(g))
    _build.check("decode_fused", err)
    act_mul.launches += 1
    return out


act_mul.launches = 0
