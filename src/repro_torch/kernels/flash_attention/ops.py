"""Flash attention: the wrapper around ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/ops.py`` (the jit wrapper
of ``flash_attention_pallas``).  A CUDA tensor launches the hand-written
kernel or raises; a CPU tensor takes the plain version in ``ref.py``.
The C entry point picks the CUDA kernel by dtype and head dim
(:func:`cuda_kernel` reports which): bf16 at hd 64 or 128 runs on the
tensor cores (wgmma, TMA), everything else on the fp32 FMA kernel.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 4 + [_I, _I, ctypes.c_float, _I, _P]


def _check(q, k, v, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Lq,H,hd], k/v [B,Lk,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError("q and k/v disagree on batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(f"head dim {hd} is not a multiple of 16 in [16, 128]")
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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: [B, Lq, H, hd]; k/v: [B, Lk, KV, hd] -> [B, Lq, H, hd] in q's
    dtype.  q row i sits at absolute position i + Lk - Lq.  The batch
    stride is free, so k/v may be a prefix ``buf[:, :n]`` of a longer
    buffer."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Lq, H, hd = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return out
    _build.check_aligned(q, k, v)
    fn = _build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Lq, Lk, H, KV, hd, q.stride(0), k.stride(0), v.stride(0),
             out.stride(0), int(causal), window or 0, float(softcap or 0.0),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def cuda_kernel(dtype, hd: int) -> str:
    """Which CUDA kernel a call with this dtype and head dim launches:
    ``"wgmma"`` (tensor cores) or ``"fma"`` (fp32 CUDA cores), as the C
    entry point decides.  Builds the library on first use."""
    f = _build.entry("flash_attention", "flash_attention_uses_wgmma",
                     [_I, _I])
    return "wgmma" if f(int(dtype == torch.bfloat16), hd) else "fma"
