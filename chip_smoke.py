#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX.  Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, the
   build of every kernel from ``src/repro_torch/kernels/*/csrc`` (three:
   paged decode, flash attention, SSD scan), ptxas's registers and spills,
   and the count of tensor-core instructions (``HGMMA``, ``HMMA``) that
   ``cuobjdump -sass`` finds in the flash and SSD libraries, where the
   toolkit has ``cuobjdump``;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, with its time (device time: the timed calls are
   replayed from a CUDA graph), the plain version's, one PyTorch
   library call's where one computes the same function
   (``scaled_dot_product_attention`` on the attention inputs made dense, a
   yardstick the port never calls; none computes the SSD scan) and the
   bound: the larger of the bytes moved over 3.35 TB/s and the flops over
   the peak rate for the arithmetic's type (989 TFLOP/s bf16 tensor cores,
   67 TFLOP/s fp32).  Attention: fp32 max abs err <= 1e-4, bf16 <= 2e-2.
   The paged decode kernel runs in two passes (splits of each sequence,
   then their merge); its lines print the partition (splits per sequence,
   split length, blocks of the first pass).  Its B=1 rows are timed over
   six page pools and block tables in turn, more than the 50 MB L2, so
   each call reads cold K/V as each layer of a decode step does
   (``ms_warm_l2`` repeats one pool); the library call is timed the same
   way.  It also runs small untimed shapes (``PAGED_BRANCHES``: groupings
   1, 4, 5, 7 and 8, head dims 64 and 128, pages of 8, 16 and 32, fp32
   and bf16, ctx 0, 1, one page, one token either side of a split
   boundary, a table within one split, B=1 over many splits).  Their
   padded table entries point at a page that no row names, and every such
   page, and every slot past ctx, holds NaN: a kernel that read one would
   fail.  Flash attention also runs small untimed shapes that reach every
   branch of its two CUDA kernels (``FLASH_BRANCHES``: head dims,
   groupings, ragged edges, window, softcap, non-causal, a k/v prefix of
   a longer buffer, and one shape each routed to the fp32 FMA kernel).
   SSD: both input types are computed in fp32 by the kernel and the plain
   version alike (bf16 products on the tensor cores with each fp32
   operand split into two bf16 parts), so both are held to 1e-4 of the
   plain output's largest magnitude, y and the final state apart
   (``rel_err_y``, ``rel_err_state``), with dt and A drawn as the model
   draws them so that terms far across tiles and chunks count.  Its flops
   count C Bᵀ once per group; its bound takes the route's rate (989
   TFLOP/s for bf16 on the tensor cores, 67 for fp32 on FMAs;
   ``bound_fp32_ms`` is the fp32-rate bound of both).  ``ms_cold`` cycles
   over input sets larger in all than twice the L2.  Small untimed shapes
   (``SSD_BRANCHES``, each in fp32 and bf16) reach every pass and branch:
   groups, head dims, state sizes, chunk lengths, one and many chunks,
   B=3, and trailing rows with dt = 0 whose state must match the unpadded
   run's; their outputs and workspaces are NaN until a pass writes them;
3. reduced: reduced llama3.1-8b and reduced mamba2-1.3b in fp32, each
   served on the kernel path and on the CPU plain path with the same
   weights: greedy tokens must match;
4. serve: full-width llama3.1-8b, then full-width mamba2-1.3b, in bf16
   (random weights from a seed), each on two engines sharing one weight
   set, 12 requests through the EMA-routed launcher; llama's odd engine
   prefills in chunks, mamba's engines both prefill in one shot.  Every
   request must finish, and every prefill and decode layer must have
   launched its kernel: the launch counts are set to 0 just before each
   model's run and read just after it.

Then the ``kernels`` line (launch counts from the phase-4 run of the model
whose path runs each kernel), the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
without that last line, as does a machine without a CUDA device.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COLD_POOLS = 6     # B=1 paged pools timed in turn: 6 x 16.8 MB in bf16 > L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured in a
    CUDA graph and the graph is replayed between two events, so that the
    host's cost of issuing them (Python, the ctypes wrappers) is not
    counted where it exceeds a call's device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def tensor_core_count(name: str) -> dict:
    """Tensor-core instructions in the SASS of kernel library ``name``:
    ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync), as ``cuobjdump -sass`` reads
    them, or why they were not counted."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {"counted": False, "why": f"no {tool} in this toolkit"}
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {"counted": True, "HGMMA": sass.count("HGMMA"),
            "HMMA": sass.count("HMMA")}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(B: int, dtype_name: str, seed: int):
    """llama3.1-8b's decode attention (H=32 over KV=8, hd=128, page 16)
    over tables of 4096 token slots, timed.  At B=1 the timed calls cycle
    over ``COLD_POOLS`` page pools and tables, as do the library calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         partition, sm_count)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    H, KV, hd, page, max_ctx = 32, 8, 128, 16, 4096
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = max_ctx // page
    P = B * n_pages
    S = n_pages * page
    pools, dense = [], []
    for i in range(COLD_POOLS if B == 1 else 1):
        q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
        kp = torch.randn((P, page, KV, hd), generator=g, device="cuda").to(dt)
        vp = torch.randn((P, page, KV, hd), generator=g, device="cuda").to(dt)
        bt = torch.randperm(P, generator=g, device="cuda").to(torch.int32)
        bt = bt.view(B, n_pages).contiguous()
        if i == 0:
            ctx = torch.randint(1, max_ctx + 1, (B,), generator=g,
                                device="cuda")
            if B > 1:
                ctx[0], ctx[1] = 0, max_ctx   # an empty sequence, a full one
            ctx = ctx.to(torch.int32)
            mask = (torch.arange(S, device="cuda")[None]
                    < ctx.long()[:, None])[:, None, None, :]
        pools.append((q, kp, vp, bt, ctx))
        # the library yardstick: SDPA over the same K/V gathered dense
        kd = kp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2)
        vd = vp[bt.long()].reshape(B, S, KV, hd).transpose(1, 2)
        dense.append((q[:, :, None], kd.repeat_interleave(H // KV, dim=1),
                      vd.repeat_interleave(H // KV, dim=1)))
    args = pools[0]
    out = paged_attention(*args)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    if B > 1 and out[0].abs().max().item() != 0.0:
        raise AssertionError("paged kernel: ctx=0 row is not zeros")
    tot = int(ctx.long().sum())
    es = args[0].element_size()
    nbytes = es * (2 * tot * KV * hd + 2 * B * H * hd) + 4 * (B * n_pages + B)
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * tot, dtype_name)
    splits, split_tokens = partition(B, KV, n_pages, page, sm_count(
        args[0].device))
    turn = itertools.cycle(range(len(pools)))
    lib_turn = itertools.cycle(range(len(pools)))
    row = {
        "B": B, "dtype": dtype_name, "ctx_sum": tot,
        "ctx_max": int(ctx.max()), "splits": splits,
        "split_tokens": split_tokens, "blocks": KV * B * splits,
        "pools": len(pools), "max_abs_err": err,
        "ms": time_ms(lambda: paged_attention(*pools[next(turn)])),
        "plain_ms": time_ms(lambda: paged_attention_ref(*args), iters=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *dense[next(lib_turn)], attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if len(pools) > 1:
        row["ms_warm_l2"] = time_ms(lambda: paged_attention(*args))
        row["library_warm_l2_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(*dense[0], attn_mask=mask))
    return row


# Small untimed shapes that reach every branch of the paged kernel:
# (B, H, KV, hd, page, n_pages, dtype, context lengths); "split-1" and
# "split+1" are one token either side of the first split boundary that
# ``partition`` picks on this card.
PAGED_BRANCHES = [
    (4, 8, 8, 128, 16, 64, "bfloat16", [0, 1, 16, 1024]),            # G = 1
    (3, 32, 8, 128, 16, 48, "float32", ["split-1", "split+1", 1]),   # G = 4
    (2, 40, 8, 128, 32, 24, "bfloat16", ["split+1", 32]),            # G = 5
    (3, 14, 2, 64, 8, 100, "bfloat16", ["split-1", "split+1", 8]),   # G = 7
    (2, 64, 8, 128, 16, 16, "float32", [256, 100]),        # G = 8, 1 split
    (1, 32, 8, 128, 16, 256, "bfloat16", [4000]),          # B = 1, 16 splits
    (2, 8, 8, 64, 32, 40, "float32", [0, 1280]),
    (2, 16, 2, 64, 16, 20, "bfloat16", [0, 320]),          # G = 8, 1 split
    (1, 10, 2, 64, 8, 64, "float32", ["split-1"]),
    (2, 56, 8, 128, 16, 40, "float32", ["split+1", 16]),
]


def paged_branch_case(B, H, KV, hd, page, n_pages, dtype_name, ctxs, seed):
    """One ``PAGED_BRANCHES`` shape against the plain version.  Page 0 is
    the pad page that short rows' table entries name, as the engine pads;
    it and every other page that no row's first ceil(ctx/page) entries
    name are NaN, and so is every slot of a row's last page past its ctx.
    The plain version, which multiplies masked rows by 0, reads the same
    pools without the NaN."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         partition, sm_count)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    splits, split_tokens = partition(B, KV, n_pages, page,
                                     sm_count(torch.device("cuda", 0)))
    near = {"split-1": split_tokens - 1, "split+1": split_tokens + 1}
    if any(c in near for c in ctxs) and splits < 2:
        raise AssertionError(f"paged branch {ctxs} has one split")
    ctx = [near.get(c, c) for c in ctxs]
    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(seed)
    P = B * n_pages + 1
    q = torch.randn((B, H, hd), generator=g).to(dt)
    kp = torch.randn((P, page, KV, hd), generator=g).to(dt)
    vp = torch.randn((P, page, KV, hd), generator=g).to(dt)
    free = (torch.randperm(P - 1, generator=g) + 1).tolist()
    bt = torch.zeros((B, n_pages), dtype=torch.int32)
    named = torch.zeros(P, dtype=torch.bool)
    k_nan, v_nan = kp.clone(), vp.clone()
    for b, c in enumerate(ctx):
        used = -(-c // page)
        bt[b, :used] = torch.tensor(free[b * n_pages:b * n_pages + used],
                                    dtype=torch.int32)
        named[bt[b, :used].long()] = True
        if c % page:
            k_nan[bt[b, used - 1], c % page:] = float("nan")
            v_nan[bt[b, used - 1], c % page:] = float("nan")
    k_nan[~named] = float("nan")
    v_nan[~named] = float("nan")
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    cuda = [t.to("cuda") for t in (q, k_nan, v_nan, kp, vp, bt, ctx_t)]
    q, k_nan, v_nan, kp, vp, bt, ctx_t = cuda
    out = paged_attention(q, k_nan, v_nan, bt, ctx_t)
    ref = paged_attention_ref(q, kp, vp, bt, ctx_t)
    torch.cuda.synchronize()
    empty = [b for b, c in enumerate(ctx) if c == 0]
    return {"B": B, "H": H, "KV": KV, "hd": hd, "page": page,
            "n_pages": n_pages, "dtype": dtype_name, "ctx": ctx,
            "splits": splits, "split_tokens": split_tokens,
            "blocks": KV * B * splits, "max_abs_err": max_err(out, ref),
            "ctx0_rows_zero": all(out[b].abs().max().item() == 0.0
                                  for b in empty)}


def _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed, buf_len=None):
    """q [B, Lq, H, hd] and k/v [B, Lk, KV, hd] on the card.  With
    ``buf_len`` > Lk, k/v are the prefix ``buf[:, :Lk]`` of a longer
    buffer, as ``attn_chunk`` passes them, and the rows past Lk are NaN: a
    kernel that read them would turn its output NaN."""
    import torch
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Lq, H, hd), generator=g, device="cuda").to(dt)
    S = buf_len or Lk
    kv = [torch.randn((B, S, KV, hd), generator=g, device="cuda").to(dt)
          for _ in range(2)]
    for t in kv:
        t[:, Lk:] = float("nan")
    return q, kv[0][:, :Lk], kv[1][:, :Lk]


def flash_case(Lq: int, Lk: int, dtype_name: str, seed: int):
    """llama3.1-8b's prefill attention (H=32 over KV=8, hd=128), timed.
    ``library_ms`` is SDPA with ``is_causal=True`` and no mask where Lq = Lk,
    so that PyTorch may take its flash backend; ``is_causal`` aligns
    top-left, so the chunk shape (Lq < Lk) keeps the explicit bottom-right
    mask.  ``library_masked_ms`` is the masked call at every shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (cuda_kernel,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, H, KV, hd = 1, 32, 8, 128
    q, k, v = _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed)
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    off = Lk - Lq
    pairs = sum(min(Lk, i + off + 1) for i in range(Lq))   # causal (q, k)
    es = q.element_size()
    nbytes = es * (2 * B * Lq * H * hd + 2 * B * Lk * KV * hd)
    b_ms, b_by = bound(nbytes, 4.0 * B * H * hd * pairs, dtype_name)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qi = torch.arange(Lq, device="cuda")[:, None] + off
    mask = torch.arange(Lk, device="cuda")[None] <= qi
    masked_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    library_ms = masked_ms if Lq != Lk else time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
    return {
        "Lq": Lq, "Lk": Lk, "dtype": dtype_name,
        "route": cuda_kernel(q.dtype, hd), "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True),
                            iters=3),
        "library_ms": library_ms, "library_masked_ms": masked_ms,
        "bound_ms": b_ms, "bound_by": b_by,
    }


# Small untimed shapes that reach every branch of the two flash kernels:
# (B, Lq, Lk, H, KV, hd, dtype, keyword arguments, k/v buffer length)
FLASH_BRANCHES = [
    (1, 256, 256, 8, 8, 64, "bfloat16", {}, None),            # hd 64, G = 1
    (1, 256, 256, 8, 8, 128, "bfloat16", {}, None),           # hd 128, G = 1
    (1, 300, 300, 40, 8, 128, "bfloat16", {}, None),          # G = 5
    (1, 17, 17, 4, 1, 128, "bfloat16", {}, None),             # ragged, G = 4
    (1, 9, 25, 4, 2, 64, "bfloat16", {}, None),               # ragged chunk
    (1, 300, 300, 8, 2, 128, "bfloat16", {"window": 40}, None),
    (1, 200, 264, 8, 2, 128, "bfloat16", {"softcap": 30.0}, None),
    (1, 130, 300, 8, 2, 64, "bfloat16", {"causal": False}, None),
    (1, 130, 300, 8, 2, 128, "bfloat16",
     {"causal": False, "window": 50}, None),
    (2, 77, 333, 8, 2, 128, "bfloat16", {}, 700),             # prefix
    (2, 200, 450, 8, 2, 64, "bfloat16", {}, 600),             # prefix
    (2, 77, 333, 8, 2, 128, "float32", {}, 700),              # fma: fp32
    (1, 256, 256, 4, 2, 32, "bfloat16", {}, None),            # fma: hd 32
]


def flash_branch_case(B, Lq, Lk, H, KV, hd, dtype_name, kw, buf_len, seed):
    import torch
    from repro_torch.kernels.flash_attention.ops import (cuda_kernel,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed, buf_len)
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    return {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "KV": KV, "hd": hd,
            "dtype": dtype_name, **kw, "buf_len": buf_len,
            "route": cuda_kernel(q.dtype, hd),
            "max_abs_err": max_err(out, ref)}


def _ssd_inputs(B, L, H, P, G, N, dtype_name, g):
    """x, dt, A, B, C on the card, dt and A drawn as ``init_mamba`` draws
    them (dt = softplus(noise + dt_bias), dt_bias for dt in [1e-3, 0.1];
    A = -1..-H), so the slow heads carry O(1) weight across key tiles and
    chunks."""
    import torch
    import torch.nn.functional as F
    dt_ = getattr(torch, dtype_name)
    x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt_)
    dt0 = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
        (H,), generator=g, device="cuda"))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")
                    + dt_bias)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    Bm = (0.3 * torch.randn((B, L, G, N), generator=g, device="cuda")).to(dt_)
    Cm = (0.3 * torch.randn((B, L, G, N), generator=g, device="cuda")).to(dt_)
    return x, dt, A, Bm, Cm


def _ssd_errors(y, st, yr, str_) -> dict:
    """Max abs error and the errors of y and of the state relative to the
    plain output's largest magnitude (NaN stays NaN)."""
    ey, es = max_err(y, yr), max_err(st, str_)
    ry = ey / yr.abs().max().item()
    rs = es / str_.abs().max().item()
    return {"max_abs_err": max(ey, es), "rel_err_y": ry, "rel_err_state": rs,
            "rel_err": max(ry, rs) if ry == ry and rs == rs else math.nan}


def ssd_case(L: int, dtype_name: str, seed: int):
    """mamba2-1.3b's scan at B=1: H=64 heads of P=64, one group of N=128,
    chunk 256.  ``ms`` repeats one input set (warm in the 50 MB L2);
    ``ms_cold`` cycles over enough input sets (at least three) that their
    bytes exceed twice the L2."""
    import torch
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    B, H, P, G, N, Q = 1, 64, 64, 1, 128, 256
    g = torch.Generator(device="cuda").manual_seed(seed)
    args = _ssd_inputs(B, L, H, P, G, N, dtype_name, g)
    y, st = ssd(*args, chunk=Q)
    yr, str_ = ssd_ref(*args, chunk=Q)
    torch.cuda.synchronize()
    # C Bᵀ once per (batch, group, chunk): the H/G heads of a group share
    # it.  Per head: att·x over the causal pairs, C·state and the update.
    pairs = Q * (Q + 1) // 2
    flops = (B * G * (L // Q) * 2 * N * pairs
             + B * H * (L // Q) * (2 * P * pairs + 4 * Q * N * P))
    es = args[0].element_size()
    nbytes = (es * (B * L * H * P + 2 * B * L * G * N) + 4 * (B * L * H + H)
              + 4 * (B * L * H * P + B * H * P * N))
    # the route's rate: bf16 on the tensor cores, fp32 on FMAs
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    n_sets = max(3, math.ceil(2 * 50e6 / nbytes))
    sets = [args] + [_ssd_inputs(B, L, H, P, G, N, dtype_name, g)
                     for _ in range(n_sets - 1)]
    turn = itertools.cycle(range(n_sets))
    return {
        "B": B, "L": L, "dtype": dtype_name, **_ssd_errors(y, st, yr, str_),
        "ms": time_ms(lambda: ssd(*args, chunk=Q)),
        "ms_cold": time_ms(lambda: ssd(*sets[next(turn)], chunk=Q)),
        "cold_sets": n_sets,
        "plain_ms": time_ms(lambda: ssd_ref(*args, chunk=Q), iters=5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bound_fp32_ms": bound(nbytes, flops, "float32")[0],
    }


# Small untimed shapes that reach every pass and branch of the SSD kernel,
# each run in fp32 and in bf16: (B, L, H, P, G, N, chunk, unpadded length).
# With an unpadded length, the rows past it have dt = 0, as
# ``models/ssd.py`` pads a prompt to the chunk, and the state must equal
# that of the unpadded rows run at chunk 16.
SSD_BRANCHES = [
    (1, 256, 8, 64, 1, 128, 256, None),     # one chunk, G = 1
    (1, 16, 8, 16, 4, 16, 16, None),        # one chunk of 16, G = 4
    (3, 192, 8, 16, 2, 16, 16, None),       # 12 chunks, B = 3, G = 2
    (2, 768, 8, 24, 4, 40, 64, None),       # 12 chunks, P = 24, N = 40
    (1, 512, 8, 8, 2, 8, 256, None),        # P = 8, N = 8
    (1, 3072, 8, 64, 1, 128, 256, None),    # 12 chunks of 256
    (2, 128, 8, 64, 2, 128, 64, 80),        # trailing dt = 0 rows
    (1, 512, 8, 16, 1, 16, 256, 496),       # trailing rows in a long chunk
]


def _poison(shapes) -> bool:
    """Fill fresh blocks of the caching allocator with NaN at ``shapes`` and
    free them, so that the next ``torch.empty`` calls of those shapes (the
    SSD wrapper's outputs and workspaces) get NaN memory.  Returns whether
    an ``empty`` of each shape then reads all NaN."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = [torch.full(s, math.nan, device="cuda") for s in shapes]
    del held
    probe = [torch.empty(s, device="cuda") for s in shapes]
    ok = all(bool(t.isnan().all()) for t in probe)
    del probe
    return ok


def ssd_branch_case(B, L, H, P, G, N, Q, real, dtype_name, seed):
    """One ``SSD_BRANCHES`` shape against the plain version, on outputs and
    workspaces that hold NaN until a pass writes them."""
    import torch
    from repro_torch.kernels.ssd.ops import ssd, workspace_shapes
    from repro_torch.kernels.ssd.ref import ssd_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dt, A, Bm, Cm = _ssd_inputs(B, L, H, P, G, N, dtype_name, g)
    if real is not None:
        dt[:, real:] = 0.0
    shapes = [(B, L, H, P), (B, H, P, N),
              *workspace_shapes(B, L, H, G, P, N, Q).values()]
    poisoned = _poison(shapes)
    y, st = ssd(x, dt, A, Bm, Cm, chunk=Q)
    yr, str_ = ssd_ref(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    row = {"B": B, "L": L, "H": H, "P": P, "G": G, "N": N, "chunk": Q,
           "dtype": dtype_name, "poisoned": poisoned,
           **_ssd_errors(y, st, yr, str_)}
    if real is not None:
        cut = [t[:, :real].contiguous() for t in (x, dt, Bm, Cm)]
        y2, st2 = ssd(cut[0], cut[1], A, cut[2], cut[3], chunk=16)
        torch.cuda.synchronize()
        cmp = _ssd_errors(y[:, :real], st, y2, st2)
        row.update(unpadded=real, rel_err_vs_unpadded=cmp["rel_err"])
        row["rel_err"] = max(row["rel_err"], cmp["rel_err"])
    return row


def check_kernels():
    cases = {"paged_attention": [], "flash_attention": [], "ssd": []}
    for dtype_name in ("float32", "bfloat16"):
        for B in (1, 8):
            cases["paged_attention"].append(paged_case(B, dtype_name, B))
        for Lq, Lk in ((2000, 2000), (512, 1536)):
            cases["flash_attention"].append(flash_case(Lq, Lk, dtype_name, Lq))
        for L in (2048, 512):
            cases["ssd"].append(ssd_case(L, dtype_name, L))
    for name, rows in cases.items():
        for r in rows:
            emit({"phase": "kernel", "name": name, **r})
            ok = (r["rel_err"] <= TOL["float32"] if name == "ssd"
                  else r["max_abs_err"] <= TOL[r["dtype"]])   # NaN fails
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {r}")
    for i, shape in enumerate(PAGED_BRANCHES):
        r = paged_branch_case(*shape, seed=200 + i)
        emit({"phase": "kernel_branch", "name": "paged_attention", **r})
        if not (r["max_abs_err"] <= TOL[r["dtype"]]   # NaN fails too
                and r["ctx0_rows_zero"]):
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version: {r}")
    for i, shape in enumerate(FLASH_BRANCHES):
        r = flash_branch_case(*shape, seed=100 + i)
        emit({"phase": "kernel_branch", "name": "flash_attention", **r})
        if not r["max_abs_err"] <= TOL[r["dtype"]]:   # NaN fails too
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version: {r}")
    for i, shape in enumerate(SSD_BRANCHES):
        for dtype_name in ("float32", "bfloat16"):
            r = ssd_branch_case(*shape, dtype_name, seed=300 + i)
            emit({"phase": "kernel_branch", "name": "ssd", **r})
            if not (r["rel_err"] <= TOL["float32"] and r["poisoned"]):
                raise AssertionError(f"ssd disagrees with its plain version: "
                                     f"{r}")
    return cases


# ---------------------------------------------------------------------------
# phase 3: reduced model, kernel path against the CPU plain path
# ---------------------------------------------------------------------------

def wrappers():
    """{kernel name: its wrapper, which carries the ``launches`` count}."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.ssd.ops import ssd
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention, "ssd": ssd}


def path_kernels(cfg):
    """The kernels the serving path of ``cfg`` launches."""
    from repro_torch.models.model import layer_caches
    by_cache = {"kv": {"flash_attention", "paged_attention"}, "ssm": {"ssd"}}
    return set().union(*(by_cache[kind] for kind, _ in layer_caches(cfg)))


def check_reduced(arch: str):
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    from repro_torch.models.model import init_params
    cfg = reduce_config(get_config(arch), layers_per_stage=2)
    cpu = init_params(cfg, torch.Generator().manual_seed(7),
                      dtype=torch.float32, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = torch.Generator().manual_seed(1)
    batched = [list(range(5 + i, 13 + i)) for i in range(5)]
    # mamba (16-row chunks): its engines gate chunked prefill off, so
    # "chunked" runs one-shot too, over one and two chunks
    chunked = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (17, 9)]
    w = wrappers()
    before = {n: f.launches for n, f in w.items()}
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        for name, prompts, kw in (("batched", batched, dict(max_batch=3)),
                                  ("chunked", chunked,
                                   dict(max_batch=2, prefill_chunk=8))):
            eng = InferenceEngine(cfg, model, max_len=64, device=dev, **kw)
            for rid, p in enumerate(prompts):
                eng.submit(EngineRequest(rid=rid, tokens=list(p),
                                         prompt_len=len(p), max_new_tokens=6))
            out[dev, name] = {r.rid: r.generated
                              for r in eng.run_until_drained()}
    launches = {n: f.launches - before[n] for n, f in w.items()}
    res = {"phase": "reduced", "config": cfg.name, "launches": launches,
           "tokens_equal": all(out["cpu", n] == out["cuda", n]
                               for n in ("batched", "chunked")),
           "n_requests": sum(len(v) for (d, _), v in out.items()
                             if d == "cuda")}
    emit(res)
    if not (res["tokens_equal"] and res["n_requests"] == 7
            and all(launches[n] > 0 for n in path_kernels(cfg))):
        raise AssertionError(f"reduced kernel path disagrees: {res} {out}")


# ---------------------------------------------------------------------------
# phase 4: full-width models through the EMA-routed launcher
# ---------------------------------------------------------------------------

def serve_full_width(arch: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    max_new, n_req = 32, 12
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines = serve.build_engines(cfg, 2, "full", "cuda", seed=0)
    requests = serve.make_requests(cfg, n_req, max_new, "full", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w = wrappers()
    for f in w.values():
        f.launches = 0
    report = serve.serve(engines, requests)
    launches = {n: f.launches for n, f in w.items()}
    done = [r for e in engines for r in e.completed]
    events = [ev for evs in report["events"] for ev in evs]
    prefills = [dt for kind, _, dt in events if kind == "prefill"]
    decodes = [(n, dt) for kind, n, dt in events if kind == "decode"]
    # one flash or ssd launch per layer per one-shot prefill or prefill
    # chunk, one paged launch per attention layer per decode step
    prefill_calls = sum(
        1 if e.prefill_chunk is None else math.ceil(r.prompt_len
                                                    / e.prefill_chunk)
        for e in engines for r in e.completed)
    res = {
        "phase": "serve", "config": cfg.name, "dtype": "bfloat16",
        "prefill_chunk": [e.prefill_chunk for e in engines],
        "engines": len(engines), "requests": n_req, "finished": len(done),
        "routed": report["routed"],
        "prompt_tokens": sum(r.prompt_len for r in done),
        "generated_tokens": sum(len(r.generated) for r in done),
        "setup_s": setup_s, "serve_s": report["seconds"],
        "prefill_calls": prefill_calls, "decode_steps": len(decodes),
        "launches": launches,
        # TTFT: prefill start to first token, queueing excluded; TPOT: one
        # batched decode iteration
        "median_ttft_s": statistics.median(prefills),
        "median_tpot_s": statistics.median(dt for _, dt in decodes),
        "decode_tokens_per_s": (sum(n for n, _ in decodes)
                                / sum(dt for _, dt in decodes)),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(res)
    L = cfg.num_layers
    kernels = path_kernels(cfg)
    want = {"flash_attention": L * prefill_calls, "ssd": L * prefill_calls,
            "paged_attention": L * len(decodes)}
    want = {n: want[n] if n in kernels else 0 for n in want}
    if not (len(done) == n_req
            and all(len(r.generated) == max_new for r in done)
            and launches == want and all(want[n] > 0 for n in kernels)
            and {0, 1} <= set(report["routed"])):
        raise AssertionError(f"full-width serve incomplete: {res}, "
                             f"launches wanted {want}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Performance Loss" in ln]
                    for n, log in logs.items()},
          "flash_sass": tensor_core_count("flash_attention"),
          "ssd_sass": tensor_core_count("ssd")})

    cases = check_kernels()
    for arch in ("llama3.1-8b", "mamba2-1.3b"):
        check_reduced(arch)
    launches = {}
    for arch in ("llama3.1-8b", "mamba2-1.3b"):
        ran = serve_full_width(arch)
        launches.update({n: ran[n] for n in path_kernels(get_config(arch))})

    def line(name, route, source, replaces, row):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "at": {k: row[k] for k in row if k in
                       ("B", "L", "Lq", "Lk", "dtype", "ctx_sum",
                        "ctx_max")}}
    paged = next(r for r in cases["paged_attention"]
                 if r["dtype"] == "bfloat16" and r["B"] == 8)
    flash = next(r for r in cases["flash_attention"]
                 if r["dtype"] == "bfloat16" and r["Lq"] == 2000)
    scan = next(r for r in cases["ssd"]
                if r["dtype"] == "bfloat16" and r["L"] == 2048)
    emit({"kernels": [
        line("paged_attention", "cuda",
             "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/paged_attention.py:33", paged),
        line("flash_attention", "cuda",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:23", flash),
        line("ssd", "cuda", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/ssd.py:20", scan),
    ], "not_ported": []})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
