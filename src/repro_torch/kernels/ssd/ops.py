"""Mamba-2 SSD chunked scan: the wrapper around ``csrc/ssd.cu``.

Counterpart of ``repro/kernels/ssd/ops.py`` (the jit wrapper of
``ssd_pallas``).  A CUDA tensor launches the hand-written kernel or raises;
a CPU tensor takes the plain version in ``ref.py``.  The kernel runs in
three passes over fp32 workspaces that the wrapper allocates
(:func:`workspace_shapes`); ``ssd.launches`` counts calls, one per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 8 + [_P]

MAX_HEAD_DIM, MAX_STATE = 64, 128    # the kernel's shared-memory tiles
TILE = 64                            # rows of a C Bᵀ tile


def workspace_shapes(Bsz: int, L: int, H: int, G: int, P: int, N: int,
                     chunk: int) -> dict:
    """The fp32 workspaces of one call, in the kernel's argument order:
    ``seg`` (cumsum of dt·A within each chunk), ``states`` (each chunk's own
    state contribution), ``start`` (each chunk's starting state; for bf16
    inputs its bf16 hi and lo parts in the same bytes) and ``cb`` (C Bᵀ of
    each chunk and group, rows and columns rounded up to whole 64-row
    tiles)."""
    nc = L // chunk
    qp = -(-chunk // TILE) * TILE
    return {"seg": (Bsz, H, L), "states": (Bsz, nc, H, P, N),
            "start": (Bsz, nc, H, P, N), "cb": (Bsz, nc, G, qp, qp)}


def _check(x, dt, A, B_, C, chunk: int):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 4 \
            or B_.shape != C.shape:
        raise ValueError(
            f"want x [B,L,H,P], dt [B,L,H], A [H], B/C [B,L,G,N]; got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(B_.shape)}, {tuple(C.shape)}")
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,) \
            or tuple(B_.shape[:2]) != (Bsz, L):
        raise ValueError("x, dt, A and B/C disagree on batch, length or "
                         "heads")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not group over {G} B/C groups")
    if chunk <= 0 or L % chunk:
        raise ValueError(f"length {L} is not a multiple of the chunk {chunk}")
    if P % 8 or not 0 < P <= MAX_HEAD_DIM or N % 8 \
            or not 0 < N <= MAX_STATE:
        raise ValueError(f"head dim {P} and state size {N} must be multiples "
                         f"of 8, at most {MAX_HEAD_DIM} and {MAX_STATE}")
    if not (x.dtype == B_.dtype == C.dtype) or x.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"want x, B and C in one dtype of fp32/bf16, got "
                        f"{x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    tensors = (x, dt, A, B_, C)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def ssd(x, dt, A, B_, C, *, chunk: int = 256):
    """x: [B, L, H, P]; dt: [B, L, H] (post-softplus, f32); A: [H] f32;
    B_/C: [B, L, G, N]; L a multiple of ``chunk``.  Returns (y [B, L, H, P]
    f32, final state [B, H, P, N] f32)."""
    _check(x, dt, A, B_, C, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B_, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz == 0:
        return y, state
    _build.check_aligned(x, B_, C)
    ws = [torch.empty(shape, dtype=torch.float32, device=x.device)
          for shape in workspace_shapes(Bsz, L, H, G, P, N, chunk).values()]
    fn = _build.entry("ssd", "ssd_launch", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(),
             *(w.data_ptr() for w in ws),
             Bsz, L, H, G, P, N, chunk, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd", err)
    ssd.launches += 1
    return y, state


ssd.launches = 0
