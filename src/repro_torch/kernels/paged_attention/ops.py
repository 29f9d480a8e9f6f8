"""Paged decode attention: the wrapper around ``csrc/paged_attention.cu``.

Counterpart of ``repro/kernels/paged_attention/ops.py`` (the jit wrapper
of ``paged_attention_pallas``).  A CUDA tensor launches the hand-written
kernel or raises; a CPU tensor takes the plain version in ``ref.py``.
The kernel runs in two passes (flash-decoding): one block per (KV head,
sequence, split) writes partial softmax results to an fp32 workspace, and
a second kernel merges the splits.  :func:`partition` picks the splits
from shapes alone, so a call never reads ``context_lens`` on the host.
``paged_attention.launches`` counts wrapper calls that launched the
kernel, one per call whatever the number of passes.  Head dims: multiples
of 16 up to 128, and 256 (gemma3-12b): pass 1 runs bf16 on the tensor
cores (mma.sync) and fp32 on the CUDA cores at every one of them.  The
engine also calls it over window layers' per-slot rings.  ``softcap``
caps the scaled scores as ``tanh(s / c) * c`` before the mask and the
softmax (the JAX model's ``_sdpa``), an argument of the same kernels: a
call without a cap runs no tanh.  ``scale`` replaces the scores'
1/sqrt(hd) (a muP config's attention multiplier); left None, the kernel
computes 1/sqrt(hd) as it always has.
Forward only: with grad mode on, an input that requires grad raises
(``_build.refuse_grad``), on the CPU too.  On meta tensors (a dry run)
the wrapper computes nothing: it returns an empty output and reports to
``_build.record_cost`` the work of every row at its table's full width
(the context lengths are data it cannot read): 4·H·hd flops a (q, key)
pair, and the bytes of q, the output, the tables and the K/V rows the
tables name.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 8 + [ctypes.c_float] * 2 + [_I, _P]

TILE = 64              # splits are whole tiles: kSplitAlign in the .cu
MIN_SPLIT_TILES = 4    # a split streams at least 256 tokens
BLOCKS_PER_SM = 2      # blocks of pass 1 aimed at per SM
MAX_GROUP = 8          # query heads per KV head that the kernel takes


def partition(B: int, KV: int, n_pages: int, page: int, sm_count: int):
    """``(splits, split_tokens)``: each sequence's ``n_pages * page`` token
    slots cut into ``splits`` ranges of ``split_tokens`` (a whole number of
    tiles), enough for about ``BLOCKS_PER_SM`` blocks of (KV head, sequence,
    split) per SM, none shorter than ``MIN_SPLIT_TILES`` tiles unless the
    table is, and none wholly past the table."""
    tiles = -(-n_pages * page // TILE)
    want = -(-BLOCKS_PER_SM * sm_count // (B * KV))
    splits = max(1, min(want, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // splits)
    return -(-tiles // per), per * TILE


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k_pages, v_pages, block_tables, context_lens, softcap,
           scale=None):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q [B,H,hd], k/v_pages [P,page,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != hd:
        raise ValueError("q and the pages disagree on head dim")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if not ((hd % 16 == 0 and 16 <= hd <= 128) or hd == 256):
        raise ValueError(f"head dim {hd} is neither a multiple of 16 in "
                         f"[16, 128] nor 256")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] == 0 or tuple(context_lens.shape) != (B,)):
        raise ValueError("want block_tables [B, n_pages>0], context_lens [B]")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"want one dtype of fp32/bf16, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if scale is not None and not 0 < scale < float("inf"):
        raise ValueError(f"scale must be positive and finite, got {scale}")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: [B, H, hd]; k/v_pages: [P, page, KV, hd]; block_tables int32
    [B, n_pages]; context_lens int32 [B] -> [B, H, hd] in q's dtype.
    A sequence with context length 0 gets zeros.  Scores scaled by
    ``scale`` (None: 1/sqrt(hd)); ``softcap`` (> 0) caps the scaled scores
    at +-softcap through tanh."""
    _check(q, k_pages, v_pages, block_tables, context_lens, softcap, scale)
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, softcap, scale)
    B, H, hd = q.shape
    P, page, KV, _ = k_pages.shape
    n_pages = block_tables.shape[1]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        keys = B * n_pages * page
        _build.record_cost(
            "paged_attention", 4.0 * H * hd * keys,
            q.element_size() * (2 * q.numel() + 2 * keys * KV * hd)
            + 4 * (block_tables.numel() + B))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if B == 0:
        return out
    _build.check_aligned(q, k_pages, v_pages)
    splits, split_tokens = partition(B, KV, n_pages, page,
                                     sm_count(q.device))
    # acc [B, KV, splits, G, hd], then (m, l) [B, KV, splits, 2, G]
    ws = torch.empty(B * H * splits * (hd + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.entry("paged_attention", "paged_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
             ws.data_ptr(), B, H, KV, hd, page, n_pages, splits, split_tokens,
             float(softcap or 0.0), float(scale or 0.0),
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
