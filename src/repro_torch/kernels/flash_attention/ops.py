"""Flash attention: the wrapper around ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/ops.py`` (the jit wrapper
of ``flash_attention_pallas``).  A CUDA tensor launches the hand-written
kernel or raises; a CPU tensor takes the plain version in ``ref.py``.
The C entry point picks one of three CUDA kernels by dtype and head dim
(:func:`cuda_kernel` reports which): bf16 at hd 64, 128 or 256 runs on the
tensor cores with ``wgmma`` (TMA; at gemma3-12b's hd 256 with 384 threads,
the consumers raised to 232 registers by setmaxnreg); fp32 at hd 16, 32,
64 or 128 runs on the tensor cores too, each fp32 product as three TF32
products on ``mma.sync`` (every operand split into a TF32 high and low
part, which keeps fp32's accuracy); the rest on the fp32 FMA kernel: fp32
at 48, 80, 96, 112 and 256, bf16 at 16, 32, 48, 80, 96 and 112.  A launch
that fails raises; no call retreats to another kernel.  Head dims:
multiples of 16 up to 128, and 256.
``flash_attention.launches`` counts kernel launches.  ``scale`` replaces
the scores' 1/sqrt(hd) (a muP config's attention multiplier); left None,
the kernels compute 1/sqrt(hd) as they always have.
Forward only: with grad mode on, an input that requires grad raises
(``_build.refuse_grad``), on the CPU too.  On meta tensors (the dry run)
the wrapper computes nothing: it returns an empty output and reports the
kernel's flops (4·H·hd per (q, k) pair under the mask) and bytes (q, k, v
read once, the output written once) to ``_build.record_cost``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 4 + [_I, _I] + [ctypes.c_float] * 2 \
    + [_I, _P]


def _check(q, k, v, window, softcap, scale=None):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Lq,H,hd], k/v [B,Lk,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError("q and k/v disagree on batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if not ((hd % 16 == 0 and 16 <= hd <= 128) or hd == 256):
        raise ValueError(f"head dim {hd} is neither a multiple of 16 in "
                         f"[16, 128] nor 256")
    if Lq > k.shape[1]:
        raise ValueError("q rows align to the tail of k: need Lq <= Lk")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"want one dtype of fp32/bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if B and not all(t[0].is_contiguous() for t in (q, k, v)):
        raise ValueError("each sequence of q/k/v must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if scale is not None and not 0 < scale < float("inf"):
        raise ValueError(f"scale must be positive and finite, got {scale}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: [B, Lq, H, hd]; k/v: [B, Lk, KV, hd] -> [B, Lq, H, hd] in q's
    dtype.  q row i sits at absolute position i + Lk - Lq.  The batch
    stride is free, so k/v may be a prefix ``buf[:, :n]`` of a longer
    buffer.  Scores scaled by ``scale`` (None: 1/sqrt(hd))."""
    _check(q, k, v, window, softcap, scale)
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    B, Lq, H, hd = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        _build.record_cost(
            "flash_attention",
            4.0 * B * H * hd * attention_pairs(Lq, Lk, causal, window),
            q.element_size() * (2 * q.numel() + 2 * k.numel()))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if B == 0 or Lq == 0:
        return out
    _build.check_aligned(q, k, v)
    fn = _build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Lq, Lk, H, KV, hd, q.stride(0), k.stride(0), v.stride(0),
             out.stride(0), int(causal), window or 0, float(softcap or 0.0),
             float(scale or 0.0), int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.lru_cache(maxsize=None)
def attention_pairs(Lq: int, Lk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """The (q, k) pairs a call attends over: q row i at position
    i + Lk - Lq, under the causal mask and the window."""
    off = Lk - Lq
    n = 0
    for i in range(Lq):
        hi = min(Lk, i + off + 1) if causal else Lk
        lo = max(0, i + off + 1 - window) if window else 0
        n += max(0, hi - lo)
    return n


_ROUTES = {0: "fma", 1: "wgmma", 2: "tf32x3"}


def cuda_kernel(dtype, hd: int) -> str:
    """Which CUDA kernel a call with this dtype and head dim launches, as
    the C entry point decides: ``"wgmma"`` (bf16 at hd 64, 128 and 256),
    ``"tf32x3"`` (fp32 at hd 16, 32, 64 and 128: three TF32 tensor-core
    products per fp32 product) or ``"fma"`` (the fp32 CUDA cores: the
    other head dims).  Builds the library on first use."""
    f = _build.entry("flash_attention", "flash_attention_route", [_I, _I])
    return _ROUTES[f(int(dtype == torch.bfloat16), hd)]
