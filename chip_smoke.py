#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (written for an H100) and ``nvcc``; imports nothing of
JAX.  Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, the
   build of every kernel library from ``src/repro_torch/kernels/*/csrc``
   (four: paged decode, flash attention, SSD scan, and the decode step's
   fused glue), ptxas's registers and spills,
   and the count of tensor-core instructions (``HGMMA``, ``HMMA``) that
   ``cuobjdump -sass`` finds in the flash and SSD libraries, where the
   toolkit has ``cuobjdump``; then ``ptxas`` lines: ptxas's report
   for ``flash_wgmma_kernel<256>`` (gemma3-12b's prefill) and for
   ``flash_tf32x3_kernel<64>`` and ``<128>`` (the fp32 route), and for
   the paged kernel's bf16 pass 1 at hd 128 and 256, softcap branch
   included (``paged_split_mma_kernel<HD>``), each of which must show
   no spill and no C7512/C7518 note (``wgmma`` serialised), and the
   highest register its SASS names (the wgmma kernel's consumers hold
   more than the launch count that ptxas reports, after ``setmaxnreg``);
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, with its time (device time: the timed calls are
   replayed from a CUDA graph), the plain version's, one PyTorch
   library call's where one computes the same function
   (``scaled_dot_product_attention`` on the attention inputs made dense, a
   yardstick the port never calls; none computes the SSD scan; the flash
   lines name the kernels it ran, from a profiler trace, and its distance
   from the plain version) and the
   bound: the larger of the bytes moved over 3.35 TB/s and the flops over
   the peak rate for the arithmetic's type (989 TFLOP/s bf16 tensor cores,
   67 TFLOP/s fp32 CUDA cores; the split-TF32 flash route does three
   products for each fp32 product, so its bound is 3 x the flops over
   TF32's 494.7 TFLOP/s, with ``bound_fma_ms``, the flops at 67, beside
   it).  Attention: fp32 max abs err <= 1e-4, bf16 <= 2e-2.
   The paged decode kernel runs in two passes (splits of each sequence,
   then their merge); its lines print the partition (splits per sequence,
   split length, blocks of the first pass).  Its B=1 rows are timed over
   six page pools and block tables in turn, more than the 50 MB L2, so
   each call reads cold K/V as each layer of a decode step does
   (``ms_warm_l2`` repeats one pool); the library call is timed the same
   way.  It also runs small untimed shapes (``PAGED_BRANCHES``: groupings
   1, 2, 4, 5, 7 and 8, head dims 64, 128 and 256, pages of 8, 16 and 32,
   fp32 and bf16, ctx 0, 1, one page, one token either side of a split
   boundary, a table within one split, B=1 over many splits).  Their
   padded table entries point at a page that no row names, and every such
   page, and every slot past ctx, holds NaN: a kernel that read one would
   fail.  Flash attention also runs small untimed shapes that reach every
   branch of its three CUDA kernels (``FLASH_BRANCHES``: head dims,
   groupings, ragged edges, window, softcap, non-causal, a k/v prefix of
   a longer buffer; bf16 at hd 256 on the ``wgmma`` kernel with G = 1, 2
   and 8, Lq not a multiple of 128 and below 64, windows of 20 and 1024,
   non-causal, softcap, chunks, B=2 prefixes; fp32 at hd 64 and 128 on
   the split-TF32 kernel with G = 1, 4, 5 and 8, ragged edges, Lq below
   64, windows of 40 and 20, softcap, non-causal with and without a
   window, B=2 prefixes and q and k scaled by 4 (peaked scores, where one
   TF32 product would break 1e-4), and at the reduced configs' hd 16 and
   32; and shapes routed to the FMA kernel: fp32 at hd 96 and 256, bf16
   at hd 32); each line must name the kernel ``flash_route`` says the
   shape takes.
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
   run's; their outputs and workspaces are NaN until a pass writes them.
   Then bf16 paged decode at B=1 and B=8 with every row at context 256,
   over the engine's fixed-width tables of 4096 token slots and over the
   tables cut to the context (``kernel_width`` lines: the splits past the
   context cost what ``ms`` less ``ms_cut`` shows).  Last, timed bf16 rows
   at the other served models' shapes (``MODEL_ROWS``, ``kernel_model``
   lines): paged decode at qwen3-32b's (B=4, H=64 over KV=8, hd 128),
   minicpm-2b's (B=8, H=36 over KV=36, hd 64: one query row per KV head),
   internvl2-1b's (B=8, H=14 over KV=2, hd 64: seven) and gemma3-12b's
   (B=8, H=16 over KV=8, hd 256) with every row at ctx 1025 over the
   engine's 4096-slot table, and at a gemma3-27b window layer's (B=8,
   H=32 over KV=16, hd 128, ctx 1024 over its full 64-page ring, the
   identity table), flash attention at minicpm-2b's prefill (Lq=Lk=2000,
   H=36 over KV=36, hd 64), at a gemma3-27b window layer's (H=32 over
   KV=16, hd 128, window 1024), at gemma3-12b's (H=16 over KV=8, hd
   256, on ``wgmma``: a global layer, a window layer of 1024 and engine
   1's third chunk, Lq=512 over Lk=1536, window 1024; each ``wgmma``
   row's ``schedule`` counts its blocks' key tiles per SM, from the
   shapes; and in fp32, on the split-TF32 route, at minicpm-2b's and the
   gemma3-27b window layer's shapes), and the SSD scan
   at jamba-v0.1-52b's prefill (B=1, L=2048, H=128 heads of P=64, one
   group of N=16, chunk 256; ``SSD_BRANCHES`` holds an untimed P=64, N=16
   shape too).  Then the paged kernel with an attention softcap
   (``softcap`` lines): timed at the B=8 row's shape in bf16 and fp32 and
   at gemma3-12b's hd 256 over pages (ctx 1025, the 4096-slot table) and
   over its rings of 1024 and 512 rows, c = 50 (Gemma 2's
   ``attn_logit_softcapping``), each beside the same call without the cap
   (``ms_uncapped``; no PyTorch call computes a capped attention, so
   ``library_ms`` is null); and ``PAGED_SOFTCAP_BRANCHES``: c = 50 and 5
   (a cap that bites), bf16 and fp32, G 1 and 8, hd 128 and 256, over
   pages and over a ring, each with a row at ctx 0 and one whose ctx ends
   inside the second split, on pools that are NaN wherever the kernel
   must not read, each timed capped and uncapped.  Then the decode
   step's fused glue (``decode_fused`` lines): ``add_rms_norm`` (with and
   without the residual add), ``rope_kv_write`` and ``act_mul``, each
   against its plain chain (``kernels/decode_fused/ref.py``) on the same
   inputs, the page pools compared whole after both wrote into them,
   within one bf16 rounding step of the largest output (1e-5 of it in
   fp32; ``FUSED_TOL``), timed beside the chain at minicpm-2b's decode
   (B=16, d 2304, H=KV=36, hd 64) and qwen3-32b's (B=4, d 5120, qk_norm,
   H 64 over KV 8, hd 128) in bf16 (``FUSED_ROWS``), and untimed on
   ``FUSED_BRANCHES``: hd 16-256, qk_norm, tanh-gelu, rows and sizes no
   16-byte vector divides, paged rows with a free row on the scratch
   page, window rings before and after they wrap; last, one minicpm-2b
   decode replay (16 slots of 1024-token prompts) profiled with the fused
   glue and with the plain chains (``decode_replay`` lines: kernels a
   replay, device busy ms, ms a replay outside the profiler).  Then the
   prefill's fused glue (``prefill_fused`` lines): ``add_rms_norm``,
   ``rope_kv_prefill`` and ``act_mul`` over a minicpm-2b prompt's rows
   (``PREFILL_ROWS``: 2000 rows one-shot, [2000, 2304] and [2000, 5760],
   36/36 heads at hd 64; a 512-row chunk at pos0 1536 into a staging
   cache), each timed beside its plain chain and equal to it bit for bit
   (``bit_equal``: the sums of squares run in PyTorch's own order), and
   untimed on
   ``PREFILL_BRANCHES`` (hd 16-256, qk_norm, NoPE, two prompts into a
   staging cache); last, one minicpm-2b one-shot call of 1024 tokens and
   one 512-token chunk with the fused glue and with the plain chains
   (``prefill_call`` lines: the wrappers' launches, kernels and device
   busy ms a call from a profiler trace, median wall ms of 10 calls; a
   ``prefill_call_equal`` line holds their logits and K/V rows equal bit
   for bit);
3. reduced: reduced llama3.1-8b, mamba2-1.3b, a hybrid (a mamba layer,
   then full attention), minicpm-2b, qwen3-32b (qk_norm), internvl2-1b,
   musicgen-medium, deepseek-v2-lite-16b (MLA and MoE: no kernel, the
   latent cache), jamba-v0.1-52b (two periods: mamba, attention and
   MoE in one decode graph), gemma3-27b and gemma3-12b (window layers
   over per-slot rings beside a full layer over pages, window 16) and
   mixtral-8x22b (window layers and MoE, no paged cache), reduced
   llama3.1-8b with an attention softcap of 50 and reduced gemma3-27b
   with its window layers at 16 and 8 (two ring stacks) in fp32, each
   served on the kernel path and on the CPU plain path with the same
   weights, in three cases: batched,
   chunked, and staggered (rows finishing at different steps, pages
   handed out again): greedy tokens must match, and every decode step of
   every card engine must be a replay of its CUDA graph.  For the two
   configs with prefix embeddings, ``prefill`` logits and the forward
   pass's hidden states with random prefix embeddings must agree within
   1e-4 (the engine serves them text-only);
4. serve: full-width llama3.1-8b, mamba2-1.3b, qwen3-32b, minicpm-2b,
   deepseek-v2-lite-16b (whole: 27 layers, 15.7 B parameters),
   jamba-v0.1-52b at two of its four periods (16 of 32 layers, 26.0 B
   parameters; the line's ``cut``), gemma3-27b (whole: 62 layers, 27.0 B
   parameters, 52 window layers over 1024-row rings), gemma3-12b (whole:
   48 layers, hd 256) and mixtral-8x22b at 8 of its 56 layers (20.4 B
   parameters, window 4096, MoE; ``cut``), in bf16 (random weights from
   a seed), and llama3.1-8b again in fp32, the JAX engine's dtype (32.1
   GB of weights; its prefill runs the split-TF32 flash route, its decode
   the paged kernel's fp32 pass), each on two engines sharing one weight
   set, 12 requests
   through the EMA-routed launcher; each model's memory is freed before
   the next is built.  qwen3-32b's engines hold 4 slots each, not 8: its
   65.5 GB of weights leave no room for 8 slots of 4096 tokens twice (the
   line's ``cut``).  The full- and window-attention models' odd engine prefills
   in chunks; the models with mamba or MLA layers prefill in one shot on
   both.  Every request must finish, and every prefill and decode layer
   must have launched its kernel, exactly: flash and paged once per
   attention layer (full or window) per prefill call and decode step,
   ssd once per mamba layer per prefill call (deepseek: none), and the
   fused glue as ``fused_counts`` gives it (per prefill call and decode
   step an ``add_rms_norm`` per attention layer and dense FFN and one
   more, an ``act_mul`` per dense FFN, per attention layer a
   ``rope_kv_prefill`` a prefill call and a ``rope_kv_write`` a decode
   step).  The
   launch counts are set to 0 just before each model's run and read just
   after it (the engines, built before, capture their decode graphs
   without counting; each replay counts the launches its capture
   recorded).  Each engine's decode steps
   must all be graph replays; the ``decode_graph`` line gives each
   engine's capture seconds beside TPOT, decode tokens/s and peak memory
   (the ``serve`` line puts the card's ``nvidia-smi`` line beside it, and
   the time to read every weight once at 3.35 TB/s: decode's capacity
   dispatch runs every expert each step).  Last, ``serve_variant`` lines:
   gemma3-12b whole on one weight set, as published and with an
   attention softcap of 50 and its window layers at 1024 and 512, each
   on one engine at a time (one-shot, then 512-token chunks), 6 requests
   of 128-2048 prompt and 32 new tokens: TTFT, TPOT, peak memory, ring
   bytes and exact flash and paged launches (B1 capped over pages and
   rings of two sizes, B2 capped at hd 256 on ``wgmma``);
5. goodput: GoodServe's decision path through ``repro_torch.launch.goodput``.
   (a) ``measure_engine_profile`` on full-width llama3.1-8b in bf16
   (random weights from seed 0, one-shot prefill, ``max_len`` 4096, page
   16) over decode batches 1, 2, 4, 8 by contexts 256, 1024, 2048, 3968 and
   prefills of 128, 512, 1024 and 2048 tokens (each decode entry the
   median of 32 steps less the slowest, each prefill entry the median of 5
   prompts; ``meta`` holds each entry's spread), after one untimed pass
   over the grid: a ``measured-cuda`` profile of the H100 entry, printed
   beside the analytic H800 profile at the same points, with the
   paged-decode and flash-attention launches it made (counts set to 0
   just before, read just after) and its peak memory.  Every entry must
   be finite and positive, no entry may be the analytic stand-in that
   the profile takes where a point had no full-batch decode step
   (``analytic_points``), and both kernels must have launched.  (b) The
   paper-scale ``MoEPredictor`` (9 experts, ~44.7M parameters) fitted on
   the card on ``train_corpus(n=2000, seed=1)`` (40 epochs, lr 1e-3): fit
   time, held-out MAE on ``train_corpus(n=300, seed=9)`` beside
   ``HistoryPredictor``'s, the median time of one ``predict`` at batch 1;
   a copy of the fitted module on the CPU must predict the same 300
   prompts within 1e-4 of the largest log1p prediction (log scale).
   (c) fig6's loop: 8 routers, n=400 at 10 requests/s, seed 3, SLO scales
   1, 2 and 3, over the paper pool (H800, A800, A40, V100, analytic) and
   the same pool with the H100 on the measured profile in place of the
   H800; one line per (pool, scale, router) and GoodServe's margin over
   the best baseline.  Every run must finish all 400 requests.  (d) The
   rest of the control plane on the same trace at SLO scale 2 over the
   pool with the measured H100 (``goodput.policy_runs``): GoodServe with
   admission control, with the reactive pool controller, with the
   fairness policy over a trace with an abusive tenant, four sharded
   gateway replicas over views synced every second, and the bandit router
   warm-started from a recorded trace, its doubly-robust estimate beside
   its what-if replay.  Every request of each run must be finished, shed,
   throttled, cascaded or lost, and the bandit's estimates must keep the
   bounds the estimator guarantees (``dr_bounds_hold``: the direct value,
   the what-if value and the match rate in [0, 1], the estimate finite
   and within 20 x the match rate of the direct value);
6. train: training through ``repro_torch.training``, which runs no kernel
   (the reference trains through plain attention and the plain scan; the
   kernel wrappers refuse inputs that require grad).  (a) ``train_parity``:
   one ``make_train_step`` of reduced llama3.1-8b, mamba2-1.3b,
   deepseek-v2-lite-16b, gemma3-27b and jamba-v0.1-52b on the card and on
   the CPU from the same weights and ``SyntheticLM`` batch, in float32
   (the same function: loss within 1e-4 relative, every leaf's gradient
   at cosine >= 0.9999, its norm within 0.1%) and in bf16 as the
   reference casts (loss within 1e-2 relative; every leaf's gradient at
   cosine >= 0.99 with its norm within 2%, or, where the leaf's own bf16
   rounding, the CPU's bf16 gradient against its float32 one, is already
   past that, within twice that gap: ``1 - cosine`` at most twice the
   floor's, the norm difference at most twice the floor's relative
   distance; the three nearest their limits are listed with both
   readings).  (b) ``train_full_width``: minicpm-2b whole (40
   layers, 2,724,878,592 parameters, WSD) and mamba2-1.3b whole, fp32
   masters drawn on the card, ``make_grad_accum_step`` at accum 4 (2 for
   mamba) x micro-batch 2 x 4096 tokens (``cut``: train_4k's global batch
   of 256 sequences cut to 8 or 4), one untimed step and two timed: step
   seconds, tokens/s, ``mfu`` (6 x parameters x tokens over step seconds
   x 989e12; attention flops left out), peak memory, losses, grad norm,
   lr; after the first step every leaf must hold a finite, non-zero
   gradient, and no kernel may have launched.  (c) ``train_eval``: the
   trained minicpm-2b in bf16 on a held-out 1 x 2048 batch: the mean NLL
   through the serving forward (flash) and the plain training forward
   within 1e-2, flash launched once per layer (40; the
   ``launches_by_path`` entry ``minicpm-2b train eval``).  (d)
   ``train_launcher``: ``launch.train.main`` for reduced llama3.1-8b, 100
   steps, checkpoints under the checkout's ``build/``: the final loss
   below ln 512, the last checkpoint restoring with every leaf finite.
7. distributed: the port's distributed layer (``repro_torch.distributed``,
   ``launch/specs.py``, ``launch/dryrun.py``, ``launch/sharded.py``).
   (a) ``dryrun``: ``dryrun.run_cell`` in a fake world (256 ranks for the
   16 x 16 mesh, 512 for 2 x 16 x 16), on meta tensors placed by the
   sharding rules, one rank's work counted by ``launch/op_cost.py``:
   internvl2-1b train_4k, mamba2-1.3b prefill_32k (B3 under ``local_map``)
   and deepseek-v2-lite-16b decode_32k (the MoE ``local_map`` branch, MLA
   sequence sharding) on the single-pod mesh, the decode cell on the
   multi-pod one (``DRYRUN_CELLS``; the full grid of 72 records is host
   work, ``python -m repro_torch.launch.dryrun --all --both-meshes``); each
   line holds the record and its summary; the card must hold no more
   memory after it.  (b) the sharded path on the card: a 1 x 1 (data,
   model) mesh over NCCL at world size 1, full width, bf16 unless said, each
   run held to the unsharded function on the same card:
   ``sharded_prefill`` lines for llama3.1-8b (8 x 1024 tokens: B2 exactly
   32 launches under ``local_map``), mamba2-1.3b (B3 exactly 48) and
   deepseek-v2-lite-16b whole (every MoE layer through the ``local_map``
   branch, an NCCL all-reduce at world size 1; no kernel), logits within
   2e-2; ``sharded_ring_decode``: 8 greedy ``ring_decode_step``s of
   llama3.1-8b over the ring cache of the sharded prefill against the
   engine's decode step (B1 over pages) from the unsharded prefill, every
   row's tokens equal up to a near tie (both top-2 gaps within
   ``NEAR_TIE_ULPS`` bf16 spacings of the top logit: bf16 logits tie
   exactly), after which that row is not compared further;
   ``sharded_train``: one ``make_train_step`` of minicpm-2b whole (fp32
   masters, 2 x 4096 tokens) on DTensor masters placed by the FSDP specs
   against the unsharded step: the loss within 1e-4 relative, every
   leaf's update at cosine >= 0.9999 with its norm within 0.1%.  (c)
   ``engine_under_mesh`` lines: the engine under that mesh
   (``InferenceEngine(..., ctx=)``: a placed copy of the weights, the
   reference's ring cache, prefill and the chunk step with their kernels
   under ``local_map``, each prompt spliced into its slot, the ring decode
   captured into the engine's CUDA graph) beside the unsharded engine (B1
   over pages) on the same weights and requests, one engine at a time, 8
   slots of 4096 tokens, 32 new tokens a request (``MESH_ENGINES``):
   llama3.1-8b whole in bf16 (12 requests of 128-2048 prompt tokens,
   one-shot and then in 512-token chunks); mamba2-1.3b and
   deepseek-v2-lite-16b whole in bf16, 6 requests, one-shot.  Each line gives both engines' TTFT, TPOT, peak memory,
   ``capture_s``, ``graph_replays`` and launches, the memory
   ``placed_copy`` added, and (b)'s eager ring decode step beside them (a
   ring of 1032 rows, not 4096).  Every request must finish, every decode step be a replay, the
   launches be exact (B2 once per attention layer per prefill call, B3
   once per mamba layer per prefill, no B1 under the mesh).  The mesh
   engine's tokens are held pick by pick to the unsharded ring path
   (plain tensors, eager, the same admission, ``splice_ring`` and
   ``ring_decode_step``) fed the same tokens: a different pick only at a
   near tie, and the logits at most ``NEAR_TIE_ULPS`` bf16 spacings apart
   (``logit_diff_spacings``: per pick, the largest difference at the
   second path's 20 top logits).  Against the unsharded engine (B1 over
   pages) the tokens are compared as in (b), and a difference outside a
   near tie must be the ring path's own: the same ring path fed the
   unsharded engine's tokens (the control) picks the mesh's token there,
   its logits within ``CONTROL_SPACINGS`` of the unsharded engine's.  For
   deepseek-v2-lite-16b the warm-up and capture must issue every MoE
   layer's three all-reduces (the expert and shared-expert sums, aux's
   mean) as functional NCCL all-reduces (counted where the layer calls
   them), and one replay's trace must name NCCL's one-rank kernel
   (``onerank.cu``: at world size 1 NCCL runs the mean as that kernel and
   the sums as device copies); every mesh run's line gives one replay's
   device time by kernel, and every one-shot run one admission's wall
   time beside its kernels' device time (``admission_trace``).  Each line
   gives the run's wall seconds and launches; the ``phase7_done`` line
   the phase's seconds; the process group is destroyed at its end.

Then the ``kernels`` line (``smoke_s``: the run's seconds so far, the
build included; ``launches``: the count from the phase-4 run of
llama3.1-8b or mamba2-1.3b, whichever runs each kernel, in bf16;
``flash_attention_fp32``, the split-TF32 route, with the fp32
llama3.1-8b serve's count; ``at_softcap_rows``: the paged kernel's capped
rows; ``cuda_kernel``: the flash route of the
line's row; ``launches_by_path``:
each path's count, every phase-4 model's, the phase-5 profile's,
phase 6's evaluation and phase 7's sharded runs;
``at_model_rows``: the kernel's timed rows at the other served models'
shapes, in the line's dtype), the card's ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero without that last line, as does a machine without a CUDA device.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
# dense peaks: bf16 and TF32 on the tensor cores, fp32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COLD_POOLS = 6     # B=1 paged pools timed in turn: 6 x 16.8 MB in bf16 > L2
SOFTCAP = 50.0     # Gemma 2's attn_logit_softcapping (hf:google/gemma-2-9b)
NO_LIBRARY_CAP = "none: SDPA has no softcap"


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


def ptxas_report(log: str, mangled: str) -> list:
    """ptxas's lines for the one kernel whose mangled name holds
    ``mangled``: from its ``Compiling entry function`` line to the next
    entry's, and every note elsewhere that names it."""
    out, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = mangled in ln
        if mine or (mangled in ln and "Performance Loss" in ln):
            out.append(ln.strip())
    return out


def _sass(name: str):
    """``cuobjdump -sass`` of kernel library ``name``, or None where the
    toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    return subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def tensor_core_count(name: str) -> dict:
    """Tensor-core instructions in the SASS of kernel library ``name``:
    ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync), as ``cuobjdump -sass`` reads
    them, or why they were not counted."""
    sass = _sass(name)
    if sass is None:
        return {"counted": False, "why": "no cuobjdump in this toolkit"}
    return {"counted": True, "HGMMA": sass.count("HGMMA"),
            "HMMA": sass.count("HMMA")}


def sass_top_register(name: str, mangled: str):
    """The highest register ``R<n>`` that the SASS of the one kernel of
    library ``name`` whose mangled name holds ``mangled`` names: what its
    threads really hold, where setmaxnreg lifts them past the launch count
    that ptxas reports.  None without ``cuobjdump``."""
    sass = _sass(name)
    if sass is None:
        return None
    for part in sass.split("Function : ")[1:]:
        if mangled in part.split("\n", 1)[0]:
            return max(int(r) for r in re.findall(r"\bR(\d+)\b", part))
    raise AssertionError(f"no {mangled} in the SASS of {name}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(B: int, dtype_name: str, seed: int, softcap=None):
    """llama3.1-8b's decode attention (H=32 over KV=8, hd=128, page 16)
    over tables of 4096 token slots, timed.  At B=1 the timed calls cycle
    over ``COLD_POOLS`` page pools and tables, as do the library calls.
    With ``softcap`` the scores are capped, there is no library call, and
    ``ms_uncapped`` times the same calls without the cap."""
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
    out = paged_attention(*args, softcap=softcap)
    ref = paged_attention_ref(*args, softcap=softcap)
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
        "pools": len(pools), "softcap": softcap, "max_abs_err": err,
        "ms": time_ms(lambda: paged_attention(*pools[next(turn)],
                                              softcap=softcap)),
        "plain_ms": time_ms(lambda: paged_attention_ref(*args,
                                                        softcap=softcap),
                            iters=5),
        "library_ms": None if softcap else time_ms(
            lambda: F.scaled_dot_product_attention(*dense[next(lib_turn)],
                                                   attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if softcap:
        row["library"] = NO_LIBRARY_CAP
        row["ms_uncapped"] = time_ms(lambda: paged_attention(
            *pools[next(turn)]))
    elif len(pools) > 1:
        row["ms_warm_l2"] = time_ms(lambda: paged_attention(*args))
        row["library_warm_l2_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(*dense[0], attn_mask=mask))
    return row


def paged_width_case(B: int, seed: int, ctx: int = 256, width: int = 4096,
                     H: int = 32, KV: int = 8, hd: int = 128,
                     ring: bool = False, softcap=None, scale=None):
    """bf16 paged decode with every row at context ``ctx`` (llama3.1-8b's
    attention shape unless H, KV, hd say another model's), over block
    tables of ``width`` token slots (the engine's fixed width at
    ``max_len`` 4096: entries past a row's pages name one scratch page)
    and over the same tables cut to the context's pages.  The kernel picks
    its splits from the table width, so the full-width call runs splits
    that lie wholly past ctx; both are timed from a graph, with the same
    bound.  A last page holds ctx % page live slots; the rest are NaN.
    With ``ring``, the table is a window layer's: row b names pages b * n
    .. b * n + n - 1 in order (``WindowCache``'s identity table), and ctx
    is min(context, ring size).  With ``softcap`` the scores are capped,
    there is no library call, and ``ms_uncapped`` times the full-width
    call without the cap.  ``scale`` (a muP config's attention
    multiplier) scales the scores in place of 1/sqrt(hd)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         partition, sm_count)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    page = 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    used, n_pages = -(-ctx // page), width // page
    P = B * used + 1                                  # the last is scratch
    dt = torch.bfloat16
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    kp = torch.randn((P, page, KV, hd), generator=g, device="cuda").to(dt)
    vp = torch.randn((P, page, KV, hd), generator=g, device="cuda").to(dt)
    full = torch.full((B, n_pages), P - 1, dtype=torch.int32, device="cuda")
    order = (torch.arange(P - 1, device="cuda") if ring else
             torch.randperm(P - 1, generator=g, device="cuda"))
    full[:, :used] = order.view(B, used).to(torch.int32)
    cut = full[:, :used].contiguous()
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    ref = paged_attention_ref(q, kp, vp, cut, lens, softcap, scale)
    if ctx % page:                 # slots past ctx on each row's last page
        k_nan, v_nan = kp.clone(), vp.clone()
        k_nan[cut[:, -1].long(), ctx % page:] = float("nan")
        v_nan[cut[:, -1].long(), ctx % page:] = float("nan")
    else:
        k_nan, v_nan = kp, vp
    out_full = paged_attention(q, k_nan, v_nan, full, lens, softcap, scale)
    out_cut = paged_attention(q, k_nan, v_nan, cut, lens, softcap, scale)
    torch.cuda.synchronize()
    nbytes = 2 * (2 * B * ctx * KV * hd + 2 * B * H * hd) + 4 * (B * used + B)
    b_ms, b_by = bound(nbytes, 4.0 * H * hd * B * ctx, "bfloat16")
    S = used * page
    kd = kp[cut.long()].reshape(B, S, KV, hd).transpose(1, 2)
    vd = vp[cut.long()].reshape(B, S, KV, hd).transpose(1, 2)
    dense = (q[:, :, None], kd.repeat_interleave(H // KV, dim=1),
             vd.repeat_interleave(H // KV, dim=1))
    mask = None if S == ctx else (torch.arange(S, device="cuda") < ctx)[None]
    sm = sm_count(q.device)
    row = {
        "B": B, "H": H, "KV": KV, "hd": hd, "dtype": "bfloat16", "ctx": ctx,
        "ring": ring, "softcap": softcap, "scale": scale, "ctx_sum": B * ctx,
        "table_tokens": {"full": width, "cut": S},
        "splits": {"full": partition(B, KV, n_pages, page, sm),
                   "cut": partition(B, KV, used, page, sm)},
        "max_abs_err": max(max_err(out_full, ref), max_err(out_cut, ref)),
        "ms": time_ms(lambda: paged_attention(q, kp, vp, full, lens,
                                              softcap, scale)),
        "ms_cut": time_ms(lambda: paged_attention(q, kp, vp, cut, lens,
                                                  softcap, scale)),
        "plain_ms": time_ms(lambda: paged_attention_ref(q, kp, vp, full,
                                                        lens, softcap, scale),
                            iters=5),
        "library_ms": None if softcap else time_ms(
            lambda: F.scaled_dot_product_attention(*dense, attn_mask=mask,
                                                   scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if softcap:
        row["library"] = NO_LIBRARY_CAP
        row["ms_uncapped"] = time_ms(lambda: paged_attention(q, kp, vp, full,
                                                             lens))
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
    (3, 36, 36, 64, 16, 80, "bfloat16", [0, "split+1", 1025]),  # G = 1, hd 64
    (3, 16, 8, 256, 16, 80, "bfloat16", [0, "split+1", 1025]),  # hd 256, G = 2
    (2, 16, 8, 256, 16, 64, "float32", ["split-1", 1]),        # hd 256 fp32
    (2, 8, 8, 256, 32, 20, "bfloat16", [640, 33]),             # hd 256, G = 1
    (1, 64, 8, 256, 16, 256, "float32", [4000]),        # hd 256, G = 8, B = 1
]

# bf16 rows at the decode and prefill shapes of the other served models,
# timed as the llama and mamba rows are: (kernel, model, keyword
# arguments).  Decode rows hold every sequence at ctx 1025 over the
# engine's 4096-slot table.  The last two flash rows are fp32 (the
# split-TF32 route) at minicpm-2b's hd 64 and a gemma3-27b window layer's
# shape.
MODEL_ROWS = [
    ("paged_attention", "qwen3-32b", dict(B=4, H=64, KV=8, hd=128, ctx=1025)),
    ("paged_attention", "minicpm-2b", dict(B=8, H=36, KV=36, hd=64, ctx=1025)),
    ("paged_attention", "internvl2-1b", dict(B=8, H=14, KV=2, hd=64, ctx=1025)),
    # a gemma3-27b window layer: its 64-page ring (1024 rows), full
    ("paged_attention", "gemma3-27b window", dict(B=8, H=32, KV=16, hd=128,
                                                  ctx=1024, width=1024,
                                                  ring=True)),
    ("paged_attention", "gemma3-12b", dict(B=8, H=16, KV=8, hd=256, ctx=1025)),
    ("flash_attention", "minicpm-2b", dict(Lq=2000, Lk=2000, H=36, KV=36,
                                           hd=64)),
    ("flash_attention", "gemma3-27b window", dict(Lq=2000, Lk=2000, H=32,
                                                  KV=16, hd=128,
                                                  window=1024)),
    ("flash_attention", "gemma3-12b", dict(Lq=2000, Lk=2000, H=16, KV=8,
                                           hd=256)),
    ("ssd", "jamba-v0.1-52b", dict(L=2048, H=128, P=64, G=1, N=16)),
    # a gemma3-12b window layer, one-shot and engine 1's third chunk
    ("flash_attention", "gemma3-12b window", dict(Lq=2000, Lk=2000, H=16,
                                                  KV=8, hd=256, window=1024)),
    ("flash_attention", "gemma3-12b chunk", dict(Lq=512, Lk=1536, H=16, KV=8,
                                                 hd=256, window=1024)),
    ("flash_attention", "minicpm-2b fp32", dict(Lq=2000, Lk=2000, H=36,
                                                KV=36, hd=64,
                                                dtype_name="float32")),
    ("flash_attention", "gemma3-27b window fp32", dict(
        Lq=2000, Lk=2000, H=32, KV=16, hd=128, window=1024,
        dtype_name="float32")),
    # granite-4.0-h-small: NoPE GQA at its attention multiplier 1/128 (B1 at
    # 16 decode rows, B2 one-shot), the scan of its Mamba-2 layers (B3)
    ("paged_attention", "granite-4.0-h-small",
     dict(B=16, H=32, KV=8, hd=128, ctx=1025, scale=1 / 128)),
    ("flash_attention", "granite-4.0-h-small",
     dict(Lq=2000, Lk=2000, H=32, KV=8, hd=128, scale=1 / 128)),
    ("ssd", "granite-4.0-h-small", dict(L=2048, H=128, P=64, G=1, N=128)),
]


def _branch_pools(B, H, KV, hd, page, n_pages, dtype_name, ctx, seed,
                  ring=False):
    """(q, k/v pools holding NaN wherever the kernel must not read, the
    same pools without the NaN, block tables, context lengths) on the
    card.  Page 0 is the pad page that short rows' table entries name, as
    the engine pads; it and every other page that no row's first
    ceil(ctx/page) entries name are NaN, and so is every slot of a row's
    last page past its ctx.  With ``ring`` there is no pad page and row b
    names pages b * n_pages .. in order (``WindowCache``'s identity
    table)."""
    import torch
    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(seed)
    P = B * n_pages + (0 if ring else 1)
    q = torch.randn((B, H, hd), generator=g).to(dt)
    kp = torch.randn((P, page, KV, hd), generator=g).to(dt)
    vp = torch.randn((P, page, KV, hd), generator=g).to(dt)
    if ring:
        bt = torch.arange(P, dtype=torch.int32).view(B, n_pages)
    else:
        free = (torch.randperm(P - 1, generator=g) + 1).tolist()
        bt = torch.zeros((B, n_pages), dtype=torch.int32)
    named = torch.zeros(P, dtype=torch.bool)
    k_nan, v_nan = kp.clone(), vp.clone()
    for b, c in enumerate(ctx):
        used = -(-c // page)
        if not ring:
            bt[b, :used] = torch.tensor(free[b * n_pages:b * n_pages + used],
                                        dtype=torch.int32)
        named[bt[b, :used].long()] = True
        if c % page:
            k_nan[bt[b, used - 1], c % page:] = float("nan")
            v_nan[bt[b, used - 1], c % page:] = float("nan")
    k_nan[~named] = float("nan")
    v_nan[~named] = float("nan")
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    return [t.to("cuda") for t in (q, k_nan, v_nan, kp, vp, bt, ctx_t)]


def paged_branch_case(B, H, KV, hd, page, n_pages, dtype_name, ctxs, seed):
    """One ``PAGED_BRANCHES`` shape against the plain version, on pools
    that hold NaN wherever the kernel must not read (``_branch_pools``).
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
    q, k_nan, v_nan, kp, vp, bt, ctx_t = _branch_pools(
        B, H, KV, hd, page, n_pages, dtype_name, ctx, seed)
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


# The capped paged kernel at the served shapes, timed (``softcap`` lines):
# the B=8 row's shape (``paged_case``) in bf16 and fp32, and gemma3-12b's
# decode (H=16 over KV=8, hd 256) over pages and over its rings of 1024
# and 512 rows (``paged_width_case``), c = SOFTCAP.
SOFTCAP_ROWS = [
    ("paged_case", "llama3.1-8b", dict(B=8, dtype_name="bfloat16", seed=8)),
    ("paged_case", "llama3.1-8b", dict(B=8, dtype_name="float32", seed=8)),
    ("paged_width_case", "gemma3-12b", dict(B=8, H=16, KV=8, hd=256,
                                            ctx=1025, seed=600)),
    ("paged_width_case", "gemma3-12b window 1024", dict(
        B=8, H=16, KV=8, hd=256, ctx=1024, width=1024, ring=True, seed=601)),
    ("paged_width_case", "gemma3-12b window 512", dict(
        B=8, H=16, KV=8, hd=256, ctx=512, width=512, ring=True, seed=602)),
]

# Small shapes of the capped paged kernel (``kernel_branch`` lines with a
# ``softcap``): (cap, dtype, G, hd, ring), every combination; c = 5 bites
PAGED_SOFTCAP_BRANCHES = list(itertools.product(
    (SOFTCAP, 5.0), ("bfloat16", "float32"), (1, 8), (128, 256),
    (False, True)))


def paged_softcap_case(cap, dtype_name, G, hd, ring, seed):
    """One ``PAGED_SOFTCAP_BRANCHES`` shape: B=3 rows over 64 pages of 16
    (KV=2; 4 splits of 256 on an H100), at ctx 0, 37 tokens into the
    second split, and 1000 over shuffled pages or 1024 over a ring, on
    pools that hold NaN wherever the kernel must not read
    (``_branch_pools``); the plain version reads the same pools without
    the NaN.  Timed capped (``ms``) and uncapped (``ms_uncapped``) on the
    clean pools."""
    import torch
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         partition, sm_count)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, KV, page, n_pages = 3, 2, 16, 64
    H = G * KV
    splits, split_tokens = partition(B, KV, n_pages, page,
                                     sm_count(torch.device("cuda", 0)))
    ctx = [0, split_tokens + 37, n_pages * page if ring else 1000]
    if splits < 2 or ctx[1] >= min(2 * split_tokens, ctx[2]):
        raise AssertionError(f"softcap branch: ctx {ctx[1]} is not inside "
                             f"the second of {splits} splits")
    q, k_nan, v_nan, kp, vp, bt, ctx_t = _branch_pools(
        B, H, KV, hd, page, n_pages, dtype_name, ctx, seed, ring)
    out = paged_attention(q, k_nan, v_nan, bt, ctx_t, cap)
    ref = paged_attention_ref(q, kp, vp, bt, ctx_t, cap)
    plain = paged_attention_ref(q, kp, vp, bt, ctx_t)
    torch.cuda.synchronize()
    return {"softcap": cap, "dtype": dtype_name, "B": B, "H": H, "KV": KV,
            "hd": hd, "page": page, "n_pages": n_pages, "ring": ring,
            "ctx": ctx, "splits": splits, "split_tokens": split_tokens,
            "max_abs_err": max_err(out, ref),
            "cap_moves_output_by": max_err(ref, plain),
            "ctx0_rows_zero": out[0].abs().max().item() == 0.0,
            "ms": time_ms(lambda: paged_attention(q, kp, vp, bt, ctx_t, cap)),
            "ms_uncapped": time_ms(lambda: paged_attention(q, kp, vp, bt,
                                                           ctx_t))}


def _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed, buf_len=None,
                 qk_scale=1.0):
    """q [B, Lq, H, hd] and k/v [B, Lk, KV, hd] on the card, q and k
    standard normal times ``qk_scale`` (4: scores 16 times as large, so
    that an error of the products shows through a peaked softmax).  With
    ``buf_len`` > Lk, k/v are the prefix ``buf[:, :Lk]`` of a longer
    buffer, as ``attn_chunk`` passes them, and the rows past Lk are NaN: a
    kernel that read them would turn its output NaN."""
    import torch
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, Lq, H, hd), generator=g, device="cuda")
         * qk_scale).to(dt)
    S = buf_len or Lk
    k = torch.randn((B, S, KV, hd), generator=g, device="cuda") * qk_scale
    v = torch.randn((B, S, KV, hd), generator=g, device="cuda")
    kv = [k.to(dt), v.to(dt)]
    for t in kv:
        t[:, Lk:] = float("nan")
    return q, kv[0][:, :Lk], kv[1][:, :Lk]


def wgmma_schedule(Lq: int, Lk: int, H: int, B: int, hd: int, sms: int,
                   window=None) -> dict:
    """How the ``wgmma`` route's causal blocks fall on the SMs, from the
    shapes alone: the key tiles each block visits (128 q rows, 128-key
    tiles at hd 64, else 64, as ``flash_wgmma_kernel`` cuts them), the
    blocks handed out in launch order (heads fastest, heaviest q tile
    first), each to the SM that frees first, one block an SM.  ``tail``
    is the busiest SM's tiles over the mean: the time the last wave adds
    if every tile costs the same."""
    bk, off = (128 if hd == 64 else 64), Lk - Lq
    tiles = []
    for _ in range(B):
        for q0 in reversed(range(0, Lq, 128)):
            k_lo = max(0, q0 + off - window + 1) if window else 0
            k_hi = min(Lk, min(q0 + 128, Lq) + off)
            tiles += [-(-(k_hi - k_lo // bk * bk) // bk)] * H
    free = [0] * sms
    for t in tiles:
        i = free.index(min(free))
        free[i] += t
    mean = sum(tiles) / sms
    return {"blocks": len(tiles), "waves": len(tiles) / sms,
            "sm_tiles_max": max(free), "sm_tiles_mean": mean,
            "tail": max(free) / mean}


def library_kernels(fn) -> list:
    """The device kernels one call of ``fn`` runs, from a
    ``torch.profiler`` trace: each name up to its argument list, at most
    100 characters."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sorted({e.key.split("(")[0][:100] for e in prof.key_averages()
                   if e.device_type == cuda})


def flash_case(Lq: int, Lk: int, dtype_name: str, seed: int, H: int = 32,
               KV: int = 8, hd: int = 128, window=None, scale=None):
    """llama3.1-8b's prefill attention (H=32 over KV=8, hd=128, unless H,
    KV, hd say another model's; ``window`` for a window layer), timed.
    ``library_ms`` is SDPA with ``is_causal=True`` and no mask where Lq = Lk
    and there is no window, so that PyTorch may take its flash backend;
    ``is_causal`` aligns top-left and knows no window, so the chunk shape
    (Lq < Lk) and a window keep the explicit mask.  ``library_masked_ms``
    is the masked call at every shape; ``library_kernels`` the kernels the
    ``library_ms`` call runs (from a profiler trace) and
    ``library_max_abs_err`` its output's distance from the plain version.
    The bound takes the route's rate: the split-TF32 route does three TF32
    products for each fp32 product (``bound_fma_ms``: the same flops at
    the fp32 CUDA cores' 67 TFLOP/s).  ``scale`` (a muP config's attention
    multiplier) scales the scores in place of 1/sqrt(hd), in every call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (cuda_kernel,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B = 1
    q, k, v = _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed)
    out = flash_attention(q, k, v, causal=True, window=window, scale=scale)
    ref = attention_ref(q, k, v, causal=True, window=window, scale=scale)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    off = Lk - Lq
    # (q, k) pairs under the causal mask and the window
    pairs = sum(min(Lk, i + off + 1) - max(0, i + off + 1 - (window or Lk))
                for i in range(Lq))
    es = q.element_size()
    nbytes = es * (2 * B * Lq * H * hd + 2 * B * Lk * KV * hd)
    flops = 4.0 * B * H * hd * pairs
    route = cuda_kernel(q.dtype, hd)
    b_ms, b_by = (bound(nbytes, 3 * flops, "tf32") if route == "tf32x3"
                  else bound(nbytes, flops, dtype_name))
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    qi = torch.arange(Lq, device="cuda")[:, None] + off
    ki = torch.arange(Lk, device="cuda")[None]
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window

    def masked():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=scale)

    def library():
        if Lq != Lk or window is not None:
            return masked()
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              scale=scale)
    lib_err = max_err(library().transpose(1, 2), ref)
    masked_ms = time_ms(masked)
    library_ms = (masked_ms if Lq != Lk or window is not None
                  else time_ms(library))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {
        "Lq": Lq, "Lk": Lk, "H": H, "KV": KV, "hd": hd, "dtype": dtype_name,
        "window": window, "scale": scale, "pairs": pairs,
        "route": route, "max_abs_err": err,
        "schedule": (wgmma_schedule(Lq, Lk, H, B, hd, sms, window)
                     if route == "wgmma" else None),
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window, scale=scale)),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                  window=window, scale=scale),
                            iters=3),
        "library_ms": library_ms, "library_masked_ms": masked_ms,
        "library_kernels": library_kernels(library),
        "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_fma_ms": (bound(nbytes, flops, "float32")[0]
                         if dtype_name == "float32" else None),
    }


# Small untimed shapes that reach every branch of the three flash kernels:
# (B, Lq, Lk, H, KV, hd, dtype, keyword arguments, k/v buffer length); a
# ``qk_scale`` keyword scales q and k (``_attn_inputs``), the rest go to
# ``flash_attention``
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
    (1, 256, 256, 4, 2, 32, "bfloat16", {}, None),            # fma: hd 32
    (2, 77, 333, 16, 8, 256, "float32", {"window": 100}, 700),  # fma: hd 256
    (1, 100, 130, 4, 2, 96, "float32", {}, None),             # fma: hd 96
    (1, 300, 300, 32, 16, 128, "bfloat16", {"window": 128}, None),  # gemma3
    # bf16 at hd 256 (gemma3-12b): wgmma, 384 threads, 64-key tiles
    (1, 256, 256, 8, 8, 256, "bfloat16", {}, None),           # G = 1
    (1, 300, 300, 16, 8, 256, "bfloat16", {}, None),          # G = 2, ragged
    (1, 200, 200, 16, 2, 256, "bfloat16", {}, None),          # G = 8
    (1, 40, 40, 4, 2, 256, "bfloat16", {}, None),             # Lq < 64
    (1, 9, 25, 4, 1, 256, "bfloat16", {}, None),              # chunk, Lq < 64
    (1, 300, 300, 8, 8, 256, "bfloat16", {"window": 64}, None),
    (1, 300, 300, 8, 4, 256, "bfloat16", {"window": 20}, None),  # < a tile
    (1, 1100, 1100, 4, 2, 256, "bfloat16", {"window": 1024}, None),
    (1, 130, 300, 8, 2, 256, "bfloat16", {"causal": False}, None),
    (1, 130, 300, 8, 2, 256, "bfloat16",
     {"causal": False, "window": 50}, None),
    (1, 200, 264, 8, 2, 256, "bfloat16", {"softcap": 30.0}, None),
    (1, 77, 333, 8, 2, 256, "bfloat16", {}, None),            # chunk
    (2, 130, 130, 16, 8, 256, "bfloat16", {}, 200),           # prefix, B = 2
    (2, 77, 333, 16, 8, 256, "bfloat16", {"window": 100}, 700),
    (1, 512, 1100, 4, 2, 256, "bfloat16", {"window": 1024}, 1300),
    # fp32 at hd 16-128: three TF32 products on mma.sync, 128-row q tiles
    (1, 256, 256, 8, 8, 64, "float32", {}, None),             # hd 64, G = 1
    (1, 256, 256, 8, 8, 128, "float32", {}, None),            # hd 128, G = 1
    (1, 300, 300, 16, 4, 128, "float32", {}, None),           # G = 4, ragged
    (1, 300, 300, 40, 8, 128, "float32", {}, None),           # G = 5
    (1, 200, 200, 16, 2, 64, "float32", {}, None),            # G = 8
    (1, 17, 17, 4, 1, 128, "float32", {}, None),              # ragged, G = 4
    (1, 9, 25, 4, 2, 64, "float32", {}, None),                # ragged chunk
    (1, 40, 40, 4, 2, 128, "float32", {}, None),              # Lq < 64
    (1, 300, 300, 8, 2, 128, "float32", {"window": 40}, None),
    (1, 300, 300, 8, 4, 64, "float32", {"window": 20}, None),  # < a tile
    (1, 200, 264, 8, 2, 128, "float32", {"softcap": 30.0}, None),
    (1, 130, 300, 8, 2, 64, "float32", {"causal": False}, None),
    (1, 130, 300, 8, 2, 128, "float32",
     {"causal": False, "window": 50}, None),
    (2, 77, 333, 8, 2, 128, "float32", {}, 700),              # prefix, B = 2
    (2, 200, 450, 8, 2, 64, "float32", {}, 600),              # prefix, B = 2
    (1, 512, 512, 8, 2, 128, "float32", {"qk_scale": 4.0}, None),  # peaked
    (1, 512, 512, 8, 2, 64, "float32", {"qk_scale": 4.0}, None),
    # the reduced configs' head dims: 16 (4 heads) and 32 (2 heads)
    (1, 100, 100, 4, 4, 16, "float32", {}, None),
    (2, 9, 40, 4, 1, 16, "float32", {"window": 16}, 64),      # chunk prefix
    (1, 100, 100, 2, 1, 32, "float32", {"window": 16}, None),
    (1, 130, 300, 2, 2, 32, "float32", {"causal": False}, None),
]


def flash_route(dtype_name: str, hd: int) -> str:
    """The CUDA kernel a flash call must take: ``wgmma`` (the tensor cores)
    for bf16 at hd 64, 128 and 256; ``tf32x3`` (the tensor cores, three
    TF32 products per fp32 product) for fp32 at hd 16, 32, 64 and 128; the
    fp32 FMA kernel, ``fma``, for the rest."""
    if dtype_name == "bfloat16":
        return "wgmma" if hd in (64, 128, 256) else "fma"
    return "tf32x3" if hd in (16, 32, 64, 128) else "fma"


def flash_branch_case(B, Lq, Lk, H, KV, hd, dtype_name, kw, buf_len, seed):
    import torch
    from repro_torch.kernels.flash_attention.ops import (cuda_kernel,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    kw = dict(kw)
    scale = kw.pop("qk_scale", 1.0)
    q, k, v = _attn_inputs(B, Lq, Lk, H, KV, hd, dtype_name, seed, buf_len,
                           scale)
    out = flash_attention(q, k, v, **kw)
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    return {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "KV": KV, "hd": hd,
            "dtype": dtype_name, **kw, "buf_len": buf_len, "qk_scale": scale,
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


def ssd_case(L: int, dtype_name: str, seed: int, H: int = 64, P: int = 64,
             G: int = 1, N: int = 128):
    """mamba2-1.3b's scan at B=1 (H=64 heads of P=64, one group of N=128,
    unless H, P, G, N say another model's), chunk 256.  ``ms`` repeats one
    input set (warm in the 50 MB L2); ``ms_cold`` cycles over enough input
    sets (at least three) that their bytes exceed twice the L2."""
    import torch
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    B, Q = 1, 256
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
        "B": B, "L": L, "H": H, "P": P, "G": G, "N": N, "chunk": Q,
        "dtype": dtype_name, **_ssd_errors(y, st, yr, str_),
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
    (1, 512, 16, 64, 1, 16, 256, 400),      # jamba's P = 64, N = 16
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
    for B in (1, 8):
        r = paged_width_case(B, 400 + B)
        emit({"phase": "kernel_width", "name": "paged_attention", **r})
        if not r["max_abs_err"] <= TOL["bfloat16"]:       # NaN fails too
            raise AssertionError(f"paged_attention at a fixed-width table "
                                 f"disagrees with its plain version: {r}")
    for i, (name, model, kw) in enumerate(MODEL_ROWS):
        if name == "paged_attention":
            kw = dict(kw)
            r = paged_width_case(kw.pop("B"), 500 + i, **kw)
        elif name == "flash_attention":
            r = flash_case(**{"dtype_name": "bfloat16", **kw}, seed=500 + i)
        else:
            r = ssd_case(dtype_name="bfloat16", seed=500 + i, **kw)
        emit({"phase": "kernel_model", "name": name, "model": model, **r})
        cases.setdefault("model_rows", []).append(
            {"name": name, "model": model, **r})
        ok = (r["rel_err"] <= TOL["float32"] if name == "ssd"
              else r["max_abs_err"] <= TOL[r["dtype"]])
        if name == "flash_attention":                     # NaN fails too
            ok = ok and r["route"] == flash_route(r["dtype"], r["hd"])
        if not ok:
            raise AssertionError(f"{name} at {model}'s shape disagrees with "
                                 f"its plain version: {r}")
    for name in ("paged_attention", "flash_attention", "ssd"):
        for r in cases[name]:
            emit({"phase": "kernel", "name": name, **r})
            ok = (r["rel_err"] <= TOL["float32"] if name == "ssd"
                  else r["max_abs_err"] <= TOL[r["dtype"]])   # NaN fails
            if name == "flash_attention":
                ok = ok and r["route"] == flash_route(r["dtype"], r["hd"])
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
        if r["route"] != flash_route(r["dtype"], r["hd"]):
            raise AssertionError(f"flash_attention took the wrong kernel: "
                                 f"{r}")
    for i, shape in enumerate(SSD_BRANCHES):
        for dtype_name in ("float32", "bfloat16"):
            r = ssd_branch_case(*shape, dtype_name, seed=300 + i)
            emit({"phase": "kernel_branch", "name": "ssd", **r})
            if not (r["rel_err"] <= TOL["float32"] and r["poisoned"]):
                raise AssertionError(f"ssd disagrees with its plain version: "
                                     f"{r}")
    check_softcap(cases)
    return cases


def check_softcap(cases: dict):
    """The capped paged kernel: ``SOFTCAP_ROWS`` timed (into
    ``cases["softcap_rows"]``), then ``PAGED_SOFTCAP_BRANCHES``, each
    within the dtype's tolerance of the capped plain version, ctx 0 rows
    zeros."""
    for fn, model, kw in SOFTCAP_ROWS:
        r = (paged_case(softcap=SOFTCAP, **kw) if fn == "paged_case"
             else paged_width_case(softcap=SOFTCAP, **kw))
        r = {"name": "paged_attention", "model": model, **r}
        emit({"phase": "softcap", **r})
        cases.setdefault("softcap_rows", []).append(r)
        if not r["max_abs_err"] <= TOL[r["dtype"]]:       # NaN fails too
            raise AssertionError(f"capped paged_attention at {model}'s shape "
                                 f"disagrees with its plain version: {r}")
    for i, shape in enumerate(PAGED_SOFTCAP_BRANCHES):
        r = paged_softcap_case(*shape, seed=700 + i)
        emit({"phase": "kernel_branch", "name": "paged_attention", **r})
        if not (r["max_abs_err"] <= TOL[r["dtype"]]   # NaN fails too
                and r["ctx0_rows_zero"]):
            raise AssertionError(f"capped paged_attention disagrees with its "
                                 f"plain version: {r}")


# (arch, B, d, H, KV, hd, d_ff, qk_norm, act) of the timed fused-glue rows:
# the decode step of minicpm-2b (two engines of 16 slots) and of qwen3-32b
# (qk_norm, GQA 64/8 at hd 128; 4 slots an engine at full width)
FUSED_ROWS = [("minicpm-2b", 16, 2304, 36, 36, 64, 5760, False, "silu"),
              ("qwen3-32b", 4, 5120, 64, 8, 128, 25600, True, "silu"),
              # NoPE (no rotation) and the residual multiplier 0.22
              ("granite-4.0-h-small", 16, 4096, 32, 8, 128, 768, False,
               "silu")]
# (B, d, H, KV, hd, qk_norm, act, ring, page, dtype_name) of the untimed
# fused-glue branches: head dims 16-256, qk_norm, tanh-gelu, rows (d) and
# sizes (B x d_ff) that take no 16-byte vectors, window rings before and
# after they wrap
FUSED_BRANCHES = [
    (3, 64, 4, 2, 16, False, "silu", None, 4, "float32"),
    (3, 100, 4, 4, 32, True, "gelu", None, 8, "bfloat16"),
    (5, 256, 8, 2, 64, True, "silu", 16, 4, "float32"),
    (5, 256, 8, 2, 64, False, "gelu", 16, 4, "bfloat16"),
    (2, 384, 6, 3, 128, True, "gelu", 40, 16, "bfloat16"),
    (4, 512, 4, 2, 256, True, "silu", None, 16, "bfloat16"),
    (4, 512, 4, 2, 256, False, "gelu", 1024, 16, "float32"),
    (3, 2304, 36, 36, 64, False, "silu", None, 16, "float32"),
]
# a kernel against its plain chain: within one rounding step of the
# largest output in bf16, 1e-5 of it in fp32 (the kernels take each sum of
# squares in PyTorch's own order, so each line's ``bit_equal`` says whether
# they also agree bit for bit, as they should)
FUSED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}


def _fused_err(pairs, dtype_name: str) -> dict:
    """max abs err over (kernel output, plain output) pairs, and its limit:
    ``FUSED_TOL`` of the plain outputs' largest magnitude."""
    err = max(max_err(a, b) for a, b in pairs)
    top = max(b.float().abs().max().item() for _, b in pairs)
    return {"max_abs_err": err, "tol": FUSED_TOL[dtype_name] * max(top, 1.0)}


def _fused_inputs(B, d, H, KV, hd, qk_norm, ring, page, dtype_name, seed,
                  d_ff=None, n_pages=None):
    """The fused glue's inputs at one decode step's shapes: the residual
    x and a block output y [B, 1, d], a norm weight, q/k/v, their norms,
    page pools holding each row's pages, the tables and context lengths
    (row 0 free: length 1 on the scratch page, or 0 before a ring), and
    the gate and up [B, 1, d_ff] (by default 3 d + 5, which no 16-byte
    vector divides)."""
    import torch
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dt)
    if ring is None:
        n = n_pages or 8
        lens = torch.randint(1, n * page + 1, (B,), generator=g,
                             device="cuda")
        lens[0] = 1
        tables = (torch.arange(B * n, device="cuda") + 1).reshape(B, n)
        tables[0] = 0                     # the scratch page
        P = B * n + 1
    else:
        n = -(-ring // page)
        lens = torch.randint(1, 3 * ring, (B,), generator=g, device="cuda")
        lens[0], lens[-1] = 0, ring + 1   # a free row; one just past the wrap
        tables = torch.arange(B * n, device="cuda").reshape(B, n)
        P = B * n
    ff = d_ff or 3 * d + 5
    return dict(x=rnd(B, 1, d), y=rnd(B, 1, d), w=rnd(d, std=0.1),
                q=rnd(B, H, hd), k=rnd(B, KV, hd), v=rnd(B, KV, hd),
                q_norm=rnd(hd, std=0.1) if qk_norm else None,
                k_norm=rnd(hd, std=0.1) if qk_norm else None,
                k_pages=rnd(P, page, KV, hd), v_pages=rnd(P, page, KV, hd),
                tables=tables.to(torch.int32).contiguous(),
                lens=lens.to(torch.int32), g=rnd(B, 1, ff, std=2.0),
                u=rnd(B, 1, ff), ring=ring)


def fused_case(B, d, H, KV, hd, qk_norm, act, ring, page, dtype_name, seed,
               d_ff=None, n_pages=None, timed=False, theta=1e6, eps=1e-6,
               alpha=1.0):
    """``add_rms_norm`` (with and without y), ``rope_kv_write`` and
    ``act_mul`` on the card against their plain chains (``ref.py``) on the
    same inputs: outputs, and the whole page pools after each wrote its
    slots.  ``timed``: each kernel's and chain's device ms, and bounds.
    ``theta`` None: no rotation (NoPE); ``alpha``: the residual multiplier
    of ``add_rms_norm``'s y."""
    import torch
    from repro_torch.kernels.decode_fused import ops, ref
    a = _fused_inputs(B, d, H, KV, hd, qk_norm, ring, page, dtype_name, seed,
                      d_ff, n_pages)
    pools = [(a["k_pages"].clone(), a["v_pages"].clone()) for _ in range(2)]

    def rope(fn, kp, vp):
        return lambda: fn(a["q"], a["k"], a["v"], a["lens"], a["tables"], kp,
                          vp, theta, a["q_norm"], a["k_norm"], eps, ring)
    runs = {
        "add_rms_norm": (lambda: ops.add_rms_norm(a["x"], a["y"], a["w"], eps,
                                                  alpha),
                         lambda: ref.add_rms_norm_ref(a["x"], a["y"], a["w"],
                                                      eps, alpha)),
        "rms_norm": (lambda: ops.add_rms_norm(a["x"], None, a["w"], eps),
                     lambda: ref.add_rms_norm_ref(a["x"], None, a["w"], eps)),
        "rope_kv_write": (rope(ops.rope_kv_write, *pools[0]),
                          rope(ref.rope_kv_write_ref, *pools[1])),
        "act_mul": (lambda: ops.act_mul(a["g"], a["u"], act),
                    lambda: ref.act_mul_ref(a["g"], a["u"], act)),
    }
    es = a["x"].element_size()
    n, n_ff, qkv = B * d, a["g"].numel(), B * (H + 2 * KV) * hd
    nbytes = {"add_rms_norm": es * (4 * n + d), "rms_norm": es * (2 * n + d),
              "rope_kv_write": es * (qkv + B * H * hd + 2 * B * KV * hd)
              + 8 * B + 4 * (hd // 2),
              "act_mul": 3 * es * n_ff}
    rows = []
    for name, (fused, plain) in runs.items():
        got, want = fused(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        pairs = list(zip(got, want))
        if name == "rope_kv_write":
            pairs += list(zip(pools[0], pools[1]))
        row = {"name": name, "B": B, "d": d, "H": H, "KV": KV, "hd": hd,
               "qk_norm": qk_norm, "act": act, "ring": ring, "page": page,
               "theta": theta, "alpha": alpha,
               "dtype": dtype_name, "d_ff": a["g"].shape[-1],
               "bit_equal": all(torch.equal(x, y) for x, y in pairs),
               **_fused_err(pairs, dtype_name)}
        if timed:
            b_ms, by = bound(nbytes[name], 0.0, dtype_name)
            row.update(ms=time_ms(fused), plain_ms=time_ms(plain),
                       bound_ms=b_ms, bound_by=by, library_ms=None)
        rows.append(row)
    return rows


def decode_replay_case(card: str, plain: bool, steps: int = 5) -> dict:
    """One captured decode step of minicpm-2b at full width, 16 slots of
    1024-token prompts: the kernels in one replay of the engine's graph
    (``profile_step``'s trace of ``steps`` replays), its device busy ms,
    and its ms outside the profiler (20 replays between two events).
    ``plain``: the step's glue through the plain chains, the step as it
    ran before the fused kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    from repro_torch.launch.profile_step import _traced
    from repro_torch.models.model import init_params
    _free_card()
    cfg = get_config("minicpm-2b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    with plain_glue() if plain else contextlib.nullcontext():
        eng = InferenceEngine(cfg, params, max_batch=16, max_len=2048,
                              device="cuda")
        g = torch.Generator().manual_seed(0)
        for rid in range(16):
            eng.submit(EngineRequest(
                rid=rid, prompt_len=1024, max_new_tokens=512,
                tokens=torch.randint(0, cfg.vocab_size, (1024,),
                                     generator=g).tolist()))
        eng.step()
        out = ROOT / "build" / "fused_replay"
        out.mkdir(parents=True, exist_ok=True)
        line = _traced("plain" if plain else "fused", eng._graph.replay,
                       steps, out)
        eng._graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            eng._graph.replay()
        end.record()
        end.synchronize()
    res = {"phase": "decode_replay", "config": cfg.name, "slots": 16,
           "prompt": 1024, "glue": "plain" if plain else "fused",
           "kernels_per_replay": line["launches_per_step"],
           "device_busy_ms": line["device_busy_ms"],
           "replay_ms": start.elapsed_time(end) / 20,
           "device_ms_by_kind": line["device_ms_by_kind"],
           "port_kernels": line["port_kernels"], "nvidia_smi": card}
    del eng, params
    _free_card()
    return res


@contextlib.contextmanager
def plain_glue():
    """The decode step's and prefill's glue through the plain chains of
    ``kernels/decode_fused/ref.py`` in place of the fused kernels."""
    from repro_torch.kernels.decode_fused import ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    saved = M.add_rms_norm, L.rope_kv_write, L.rope_kv_prefill, L.act_mul
    M.add_rms_norm, L.rope_kv_write, L.rope_kv_prefill, L.act_mul = (
        ref.add_rms_norm_ref, ref.rope_kv_write_ref, ref.rope_kv_prefill_ref,
        ref.act_mul_ref)
    try:
        yield
    finally:
        M.add_rms_norm, L.rope_kv_write, L.rope_kv_prefill, L.act_mul = saved


def check_decode_fused(cases: dict, card: str):
    """The fused decode glue: ``FUSED_ROWS`` timed (into
    ``cases["fused_rows"]``), ``FUSED_BRANCHES`` untimed, each kernel within
    ``FUSED_TOL`` of its plain chain; then one minicpm-2b replay's kernels
    with the fused glue and with the plain chains (``cases["replays"]``)."""
    from repro_torch.configs import get_config
    for i, (arch, B, d, H, KV, hd, d_ff, qk, act) in enumerate(FUSED_ROWS):
        cfg = get_config(arch)
        for r in fused_case(B, d, H, KV, hd, qk, act, None, 16, "bfloat16",
                            seed=800 + i, d_ff=d_ff, n_pages=256, timed=True,
                            theta=cfg.rope_theta if cfg.rotary else None,
                            eps=cfg.norm_eps, alpha=cfg.residual_multiplier):
            r = {"model": arch, **r}
            emit({"phase": "decode_fused", **r})
            cases.setdefault("fused_rows", []).append(r)
            if not r["max_abs_err"] <= r["tol"]:          # NaN fails too
                raise AssertionError(f"{r['name']} at {arch}'s shape "
                                     f"disagrees with its plain chain: {r}")
    for i, shape in enumerate(FUSED_BRANCHES):
        for r in fused_case(*shape, seed=900 + i):
            emit({"phase": "kernel_branch", **r})
            if not r["max_abs_err"] <= r["tol"]:          # NaN fails too
                raise AssertionError(f"{r['name']} disagrees with its plain "
                                     f"chain: {r}")
    replays = [decode_replay_case(card, plain) for plain in (True, False)]
    for r in replays:
        emit(r)
    cases["replays"] = replays
    if not replays[1]["kernels_per_replay"] < replays[0]["kernels_per_replay"]:
        raise AssertionError(f"the fused glue launches no fewer kernels a "
                             f"replay: {replays}")


# (name, B, L, pos0, staging rows or None, d, H, KV, hd, d_ff, qk_norm, act,
# theta, alpha) of the timed fused-prefill rows: a minicpm-2b one-shot
# prompt of 2000 tokens (K into its own buffer, V left where it is) and
# engine 1's fourth 512-token chunk (K and V into the staging cache's rows
# 1536 onward)
PREFILL_ROWS = [
    ("minicpm-2b one-shot", 1, 2000, 0, None, 2304, 36, 36, 64, 5760, False,
     "silu", 10000.0, 1.0),
    ("minicpm-2b chunk", 1, 512, 1536, 4096, 2304, 36, 36, 64, 5760, False,
     "silu", 10000.0, 1.0),
]
# (B, L, pos0, staging rows or None, d, H, KV, hd, d_ff, qk_norm, act,
# theta, alpha, dtype_name) of the untimed fused-prefill branches: head
# dims 16-256, qk_norm, NoPE with a residual multiplier, two prompts into
# a staging cache (its batch stride), rows and sizes no 16-byte vector
# divides
PREFILL_BRANCHES = [
    (1, 37, 0, None, 64, 4, 4, 16, 197, False, "silu", 1e4, 1.0, "float32"),
    (2, 21, 5, 40, 100, 4, 2, 32, 303, True, "gelu", 1e6, 1.0, "bfloat16"),
    (2, 33, 0, None, 256, 8, 2, 128, 768, False, "silu", None, 0.22,
     "bfloat16"),
    (1, 19, 100, 128, 512, 4, 1, 256, 1024, True, "gelu", 1e4, 1.0,
     "bfloat16"),
    (2, 50, 7, 64, 2304, 36, 36, 64, 5760, False, "silu", 1e4, 1.0,
     "float32"),
]


def prefill_fused_case(B, Lr, pos0, staging, d, H, KV, hd, d_ff, qk_norm,
                       act, theta, alpha, dtype_name, seed, timed=False,
                       eps=1e-6):
    """``add_rms_norm``, ``rope_kv_prefill`` and ``act_mul`` over a
    prompt's rows on the card against their plain chains (``ref.py``) on
    the same inputs: outputs and, with ``staging`` rows, the whole staging
    layers after both wrote rows ``pos0`` onward.  ``bit_equal``: every
    pair equal bit for bit; ``n_differ``: the elements that are not.
    ``timed``: each kernel's and chain's device ms, and bounds."""
    import torch
    from repro_torch.kernels.decode_fused import ops, ref
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dt)
    n = B * Lr
    x, y, w = rnd(n, d), rnd(n, d), rnd(d, std=0.1)
    q, k, v = rnd(B, Lr, H, hd), rnd(B, Lr, KV, hd), rnd(B, Lr, KV, hd)
    qn = rnd(hd, std=0.1) if qk_norm else None
    kn = rnd(hd, std=0.1) if qk_norm else None
    gate, up = rnd(n, d_ff, std=2.0), rnd(n, d_ff)
    pools = []
    if staging:
        base = (rnd(B, staging, KV, hd), rnd(B, staging, KV, hd))
        pools = [tuple(t.clone() for t in base) for _ in range(2)]

    def rope(fn, i):
        outs = () if not staging else tuple(t[:, pos0:pos0 + Lr]
                                            for t in pools[i])
        return lambda: fn(q, k, v, pos0, theta, qn, kn, eps, *outs)
    runs = {
        "add_rms_norm": (lambda: ops.add_rms_norm(x, y, w, eps, alpha),
                         lambda: ref.add_rms_norm_ref(x, y, w, eps, alpha)),
        "rope_kv_prefill": (rope(ops.rope_kv_prefill, 0),
                            rope(ref.rope_kv_prefill_ref, 1)),
        "act_mul": (lambda: ops.act_mul(gate, up, act),
                    lambda: ref.act_mul_ref(gate, up, act)),
    }
    es = x.element_size()
    heads = B * Lr * (H + KV) * hd
    nbytes = {"add_rms_norm": es * (4 * n * d + d),
              "rope_kv_prefill": es * (2 * heads + 2 * B * Lr * KV * hd
                                       * bool(staging)
                                       + 2 * hd * qk_norm)
              + 4 * (hd // 2),
              "act_mul": 3 * es * n * d_ff}
    rows = []
    for name, (fused, plain) in runs.items():
        got, want = fused(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)))
        if name == "rope_kv_prefill":
            pairs += list(zip(pools[0], pools[1])) if staging else []
        row = {"name": name, "B": B, "L": Lr, "pos0": pos0,
               "staging": staging, "d": d, "H": H, "KV": KV, "hd": hd,
               "d_ff": d_ff, "qk_norm": qk_norm, "act": act, "theta": theta,
               "alpha": alpha, "dtype": dtype_name,
               "bit_equal": all(torch.equal(a, b) for a, b in pairs),
               "n_differ": sum(int((a != b).sum()) for a, b in pairs),
               **_fused_err(pairs, dtype_name)}
        if timed:
            b_ms, by = bound(nbytes[name], 0.0, dtype_name)
            row.update(ms=time_ms(fused), plain_ms=time_ms(plain),
                       bound_ms=b_ms, bound_by=by, library_ms=None)
        rows.append(row)
    return rows


PREFILL_CALL_PROMPT = 1024     # the one-shot prompt; its second half is
PREFILL_CALL_CHUNK = 512       # the chunk, at pos0 512 of a staging cache


def prefill_call_case(card: str) -> list:
    """One minicpm-2b admission at full width in bf16, through the fused
    glue and through the plain chains (``plain_glue``), on one weight set:
    a one-shot prompt of ``PREFILL_CALL_PROMPT`` tokens (the engine's
    ``_prefill_into_slot``: prefill, the page writes, the sample) and one
    chunk of ``PREFILL_CALL_CHUNK`` at pos0 512 (``prefill_chunk``).  Per
    call and glue: the wrappers' launches, the kernels and device busy ms
    of a profiled call, and the median wall ms of 10 calls outside the
    profiler, each between two synchronises.  The fused and plain calls'
    last-token logits and every K/V row they wrote, compared."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    from repro_torch.launch.profile_step import _traced
    from repro_torch.models.model import init_params, prefill, prefill_chunk
    _free_card()
    cfg = get_config("minicpm-2b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=2048,
                          prefill_chunk=PREFILL_CALL_CHUNK, device="cuda")
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_CALL_PROMPT,),
                           generator=g)
    toks = prompt.to("cuda")[None]
    head, tail = toks[:, :512], toks[:, 512:512 + PREFILL_CALL_CHUNK]
    sc = eng._stage_cache

    def one_shot():
        eng._prefill_into_slot(0, EngineRequest(
            rid=0, tokens=prompt.tolist(), prompt_len=len(prompt),
            max_new_tokens=1))
        eng._free(0)

    def chunk():
        sc["pos"] = 512
        prefill_chunk(params, sc, tail)
        torch.cuda.synchronize()

    out = ROOT / "build" / "prefill_call"
    out.mkdir(parents=True, exist_ok=True)
    rows, seen = [], {}
    for glue in ("plain", "fused"):
        with plain_glue() if glue == "plain" else contextlib.nullcontext():
            with torch.no_grad():
                logits, states = prefill(params, toks)
                sc["pos"] = 0
                prefill_chunk(params, sc, head)
                chunk_logits, _ = prefill_chunk(params, sc, tail)
                # the logits first, then every K/V row written
                seen[glue] = [logits, chunk_logits,
                              *(t for st in states for t in st),
                              sc["k"][:, :, :1024].clone(),
                              sc["v"][:, :, :1024].clone()]
                del states
                for call, fn in (("one-shot", one_shot), ("chunk", chunk)):
                    fn()
                    torch.cuda.synchronize()
                    _zero_counts()
                    fn()
                    launches = {k: c for k, c in _path_counts().items() if c}
                    line = _traced(f"{glue}_{call}", fn, 3, out)
                    walls = []
                    for _ in range(10):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    rows.append({
                        "phase": "prefill_call", "config": cfg.name,
                        "call": call, "glue": glue,
                        "tokens": (PREFILL_CALL_PROMPT if call == "one-shot"
                                   else PREFILL_CALL_CHUNK),
                        "wrapper_launches": launches,
                        "wrapper_launches_total": sum(launches.values()),
                        "kernels_per_call": line["launches_per_step"],
                        "device_busy_ms": line["device_busy_ms"],
                        "wall_ms": statistics.median(walls),
                        "wall_ms_all": walls,
                        "device_ms_by_kind": line["device_ms_by_kind"],
                        "nvidia_smi": card})
    pairs = list(zip(seen["plain"], seen["fused"]))
    rows.append({"phase": "prefill_call_equal", "config": cfg.name,
                 "bit_equal": all(torch.equal(a, b) for a, b in pairs),
                 "n_differ": sum(int((a != b).sum()) for a, b in pairs),
                 "tensors": len(pairs),
                 "kv_max_abs_err": max(max_err(a, b) for a, b in pairs[2:]),
                 "logits_max_abs_err": max(max_err(a, b)
                                           for a, b in pairs[:2]),
                 "logits_max": max(a.float().abs().max().item()
                                   for a, _ in pairs[:2]),
                 "nvidia_smi": card})
    del eng, params, seen
    _free_card()
    return rows


def check_prefill_fused(cases: dict, card: str):
    """The fused prefill glue: ``PREFILL_ROWS`` timed (into
    ``cases["prefill_rows"]``), ``PREFILL_BRANCHES`` untimed, each kernel
    equal to its plain chain bit for bit; then one minicpm-2b one-shot call
    and one chunk call with the fused glue and with the plain chains
    (``cases["prefill_calls"]``), which must launch fewer kernels fused and
    give the same logits and K/V rows, bit for bit."""
    for i, (name, *shape) in enumerate(PREFILL_ROWS):
        for r in prefill_fused_case(*shape, "bfloat16", seed=700 + i,
                                    timed=True):
            r = {"model": name, **r}
            emit({"phase": "prefill_fused", **r})
            cases.setdefault("prefill_rows", []).append(r)
            if not r["bit_equal"]:
                raise AssertionError(f"{r['name']} at {name}'s shape "
                                     f"disagrees with its plain chain: {r}")
    for i, shape in enumerate(PREFILL_BRANCHES):
        for r in prefill_fused_case(*shape, seed=750 + i):
            emit({"phase": "kernel_branch", **r})
            if not r["bit_equal"]:
                raise AssertionError(f"{r['name']} disagrees with its plain "
                                     f"chain: {r}")
    rows = prefill_call_case(card)
    for r in rows:
        emit(r)
    cases["prefill_calls"] = rows
    calls = {(r["call"], r["glue"]): r for r in rows
             if r["phase"] == "prefill_call"}
    for call in ("one-shot", "chunk"):
        if not (calls[call, "fused"]["kernels_per_call"]
                < calls[call, "plain"]["kernels_per_call"]):
            raise AssertionError(f"the fused prefill glue launches no fewer "
                                 f"kernels a {call} call: {rows}")
    if not rows[-1]["bit_equal"]:
        raise AssertionError(f"fused and plain prefill disagree: {rows[-1]}")


# ---------------------------------------------------------------------------
# phase 3: reduced model, kernel path against the CPU plain path
# ---------------------------------------------------------------------------

REDUCED_ARCHS = ("llama3.1-8b", "mamba2-1.3b", "hybrid", "minicpm-2b",
                 "qwen3-32b", "internvl2-1b", "musicgen-medium",
                 "deepseek-v2-lite-16b", "jamba-v0.1-52b", "gemma3-27b",
                 "gemma3-12b", "mixtral-8x22b", "llama3.1-8b softcap",
                 "gemma3-27b windows")
REDUCED_WINDOWS = (16, 8)    # "gemma3-27b windows": its window layers' sizes


def wrappers():
    """{kernel name: its wrapper, which carries the ``launches`` count}."""
    from repro_torch.engine.engine import KERNELS
    return {k.__name__: k for k in KERNELS}


def path_kernels(cfg):
    """The kernels the serving path of ``cfg`` launches (MLA runs none of
    the attention kernels)."""
    from repro_torch.models.model import layer_caches
    attn = {"flash_attention", "paged_attention"}
    by_cache = {"kv": attn, "win": attn, "ssm": {"ssd"}, "mla": set()}
    return set().union(*(by_cache[kind] for kind, _ in layer_caches(cfg)),
                       (k for k, n in fused_counts(cfg, 1, 1).items() if n))


def fused_counts(cfg, decodes: int, prefills: int) -> dict:
    """The fused glue's launches in ``decodes`` decode steps and
    ``prefills`` prefill calls (one-shot prompts or chunks) of ``cfg``
    outside a mesh: in each, an ``add_rms_norm`` before each attention
    (full or window) layer and dense FFN and one at the final norm, one
    ``act_mul`` per dense FFN, and per attention layer one
    ``rope_kv_write`` (decode) or ``rope_kv_prefill`` (prefill); MLA,
    mamba and MoE blocks run none."""
    n = layer_counts(cfg)
    attn = n["kv"] + n["win"]
    dense = sum(b.ffn == "dense" for b in cfg.layer_list())
    calls = decodes + prefills
    return {"add_rms_norm": (attn + dense + 1) * calls,
            "rope_kv_write": attn * decodes,
            "rope_kv_prefill": attn * prefills, "act_mul": dense * calls}


def layer_counts(cfg) -> dict:
    """{cache kind: the layers that use it}: "kv" full attention, "win"
    window attention (a per-slot ring), "mla", "ssm"."""
    from repro_torch.models.model import layer_caches
    kinds = [kind for kind, _ in layer_caches(cfg)]
    return {k: kinds.count(k) for k in ("kv", "win", "mla", "ssm")}


def reduced_config(arch: str):
    """Reduced ``arch`` at two layers per stage (deepseek-v2-lite-16b: 3
    MLA layers; jamba-v0.1-52b: 16, two periods; gemma3-27b: 14, two 5:1
    periods and two window layers; gemma3-12b: 12; mixtral-8x22b: 2 window
    layers with MoE; window 16, so rings wrap); ``hybrid`` is reduced
    mamba2-1.3b cut to a mamba layer and a full-attention layer with a dense
    FFN, so one decode graph holds both caches; ``llama3.1-8b softcap`` is
    reduced llama3.1-8b with an attention softcap of ``SOFTCAP``, and
    ``gemma3-27b windows`` reduced gemma3-27b with its window layers at
    ``REDUCED_WINDOWS`` in turn (two ring stacks)."""
    import dataclasses
    from repro_torch.configs import base, get_config, reduce_config
    from repro_torch.launch.serve import alternate_windows
    if arch == "llama3.1-8b softcap":
        cfg = reduce_config(get_config("llama3.1-8b"), layers_per_stage=2)
        return dataclasses.replace(cfg, name=cfg.name + "-softcap",
                                   logit_softcap=SOFTCAP)
    if arch == "gemma3-27b windows":
        cfg = alternate_windows(reduce_config(get_config("gemma3-27b"),
                                              layers_per_stage=2),
                                REDUCED_WINDOWS)
        return dataclasses.replace(cfg, name=cfg.name + "-windows")
    if arch != "hybrid":
        return reduce_config(get_config(arch), layers_per_stage=2)
    cfg = reduce_config(get_config("mamba2-1.3b"))
    stage = base.Stage(pattern=(base.BlockSpec("mamba", "none"),
                                base.BlockSpec("full", "dense")), repeat=1)
    return dataclasses.replace(cfg, name="hybrid-reduced", family="hybrid",
                               num_layers=2, stages=(stage,))


def staggered(vocab: int, seed: int = 11):
    """(engine step at which it arrives, prompt, max_new_tokens): six
    requests in four waves with staggered lengths, so that rows finish at
    different steps, never more than three of four slots run at once, and
    released pages are handed out again."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(w, [int(t) for t in rng.integers(1, vocab, n)], m)
            for w, n, m in zip((0, 0, 2, 5, 5, 9), (13, 6, 17, 9, 21, 11),
                               (3, 7, 2, 6, 4, 5))]


def check_reduced(arch: str):
    """Reduced ``arch`` in fp32 on the card and on the CPU, same weights:
    ``batched`` (5 requests over 3 slots), ``chunked`` (prefill in chunks of
    8 where the config allows it) and ``staggered`` (rows finishing at
    different steps, free rows in every step, 18 pages of 4 tokens for
    requests that need 27 in all).  Greedy tokens must match, and every
    decode step of every card engine must be a replay of its graph."""
    import torch
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    from repro_torch.models.model import init_params
    cfg = reduced_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(7),
                      dtype=torch.float32, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = torch.Generator().manual_seed(1)
    batched = [(0, list(range(5 + i, 13 + i)), 6) for i in range(5)]
    # mamba (16-row chunks): its engines gate chunked prefill off, so
    # "chunked" runs one-shot too, over one and two chunks
    chunked = [(0, torch.randint(0, cfg.vocab_size, (n,),
                                 generator=rng).tolist(), 6) for n in (17, 9)]
    cases = (("batched", batched, dict(max_batch=3)),
             ("chunked", chunked, dict(max_batch=2, prefill_chunk=8)),
             ("staggered", staggered(cfg.vocab_size),
              dict(max_batch=4, page_size=4, num_pages=18)))
    w = wrappers()
    before = {n: f.launches for n, f in w.items()}
    out, replays = {}, {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        for name, schedule, kw in cases:
            eng = InferenceEngine(cfg, model, max_len=64, device=dev, **kw)
            for t in range(max(wave for wave, _, _ in schedule) + 1):
                for rid, (wave, p, m) in enumerate(schedule):
                    if wave == t:
                        eng.submit(EngineRequest(rid=rid, tokens=list(p),
                                                 prompt_len=len(p),
                                                 max_new_tokens=m))
                eng.step()
            out[dev, name] = {r.rid: r.generated
                              for r in eng.run_until_drained()}
            if dev == "cuda":
                steps = sum(kind == "decode" for kind, _, _ in eng.events)
                replays[name] = [eng.graph_replays, steps]
    launches = {n: f.launches - before[n] for n, f in w.items()}
    res = {"phase": "reduced", "config": cfg.name, "launches": launches,
           "tokens_equal": {n: out["cpu", n] == out["cuda", n]
                            for n, _, _ in cases},
           "graph_replays_and_decode_steps": replays,
           "n_requests": sum(len(v) for (d, _), v in out.items()
                             if d == "cuda")}
    prefix_ok = True
    if cfg.n_prefix_embeds:
        # the engine serves text only; the model's prefix path runs here
        from repro_torch.models.model import model_forward, prefill
        pre = torch.randn((2, cfg.n_prefix_embeds, cfg.d_model), generator=rng)
        toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=rng)
        got = [(prefill(m, toks.to(m.device), pre.to(m.device))[0],
                model_forward(m, toks.to(m.device), pre.to(m.device))[0])
               for m in (cpu, gpu)]
        res["prefix_max_abs_err"] = {
            "prefill_logits": max_err(got[1][0].cpu(), got[0][0]),
            "forward_hidden": max_err(got[1][1].cpu(), got[0][1])}
        prefix_ok = max(res["prefix_max_abs_err"].values()) <= TOL["float32"]
    emit(res)
    if not (all(res["tokens_equal"].values()) and res["n_requests"] == 13
            and all(r == n > 0 for r, n in replays.values())
            and all(launches[n] > 0 for n in path_kernels(cfg))
            and prefix_ok):
        raise AssertionError(f"reduced kernel path disagrees: {res} {out}")


# ---------------------------------------------------------------------------
# phase 4: full-width models through the EMA-routed launcher
# ---------------------------------------------------------------------------

# (arch, slots per engine or None for the size's 8, periods of the stage or
# None for all, dtype or None for the size's bf16): qwen3-32b's 65.5 GB of
# bf16 weights leave room for 2 x 4 slots of 4096 tokens (8.6 GB of KV);
# jamba-v0.1-52b's four periods are 102.9 GB, two (16 of 32 layers) 52.0
# GB; gemma3-27b (54.0 GB) holds 8 slots per engine because its 52 window
# layers keep 1024-row rings; mixtral-8x22b's 56 one-layer periods are
# 281.3 GB, 8 of them 40.9 GB.  llama3.1-8b is served a second time in
# fp32, the JAX engine's dtype (32.1 GB of weights, 17.2 GB of pages):
# its prefill runs the split-TF32 flash route
SERVED = (("llama3.1-8b", None, None, None), ("mamba2-1.3b", None, None, None),
          ("qwen3-32b", 4, None, None), ("minicpm-2b", None, None, None),
          ("deepseek-v2-lite-16b", None, None, None),
          ("jamba-v0.1-52b", None, 2, None), ("gemma3-27b", None, None, None),
          ("gemma3-12b", None, None, None), ("mixtral-8x22b", None, 8, None),
          ("llama3.1-8b", None, None, "float32"))


def served_config(arch: str, periods=None):
    """``arch``'s config, its one stage repeated ``periods`` times where
    given (full width, cut depth)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cut_periods
    cfg = get_config(arch)
    return cfg if periods is None else cut_periods(cfg, periods)


def serve_full_width(arch: str, card: str, max_batch=None, periods=None,
                     dtype_name=None):
    """``arch`` at full width on two engines of ``max_batch`` slots (the
    size's 8 unless given), at ``periods`` periods of its stage where
    given, in ``dtype_name`` (the size's bf16 unless given), after the
    previous model's memory is freed."""
    import gc
    import torch
    from repro_torch.launch import serve
    cfg = served_config(arch, periods)
    dtype = (getattr(torch, dtype_name) if dtype_name
             else serve.SIZES["full"]["dtype"])
    max_new, n_req = 32, 12
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines = serve.build_engines(cfg, 2, "full", "cuda", seed=0,
                                  max_batch=max_batch, dtype=dtype)
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
    # one flash or ssd launch per attention (full or window) or mamba layer
    # per one-shot prefill or prefill chunk, one paged launch per attention
    # layer per decode step (full layers over pages, window layers over
    # their rings)
    prefill_calls = sum(
        1 if e.prefill_chunk is None else math.ceil(r.prompt_len
                                                    / e.prefill_chunk)
        for e in engines for r in e.completed)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engines[0].params.parameters())
    res = {
        "phase": "serve", "config": cfg.name,
        "dtype": str(dtype).removeprefix("torch."),
        "n_params": cfg.param_count(), "num_layers": cfg.num_layers,
        "layers_by_cache": layer_counts(cfg),
        "max_batch": [e.max_batch for e in engines],
        "max_len": [e.max_len for e in engines],
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
        "weights_gb": weight_bytes / 1e9,
        "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "nvidia_smi": card,
    }
    cuts = []
    if max_batch is not None:
        cuts.append(f"max_batch {max_batch} per engine (size default "
                    f"{serve.SIZES['full']['max_batch']}): weights and KV "
                    f"must fit the card")
    if periods is not None:
        full = served_config(arch)
        cuts.append(f"depth: {cfg.num_layers} of {full.num_layers} layers, "
                    f"the stage repeated {periods} times, not "
                    f"{full.stages[0].repeat} ({full.param_count():,} "
                    f"parameters do not fit the card in bf16)")
    if cuts:
        res["cut"] = "; ".join(cuts)
    emit(res)
    # every decode step of every engine replayed the engine's graph
    steps = [sum(kind == "decode" for kind, _, _ in evs)
             for evs in report["events"]]
    graph = {"phase": "decode_graph", "config": cfg.name,
             "dtype": res["dtype"],
             "capture_s": [e.capture_s for e in engines],
             "graph_replays": [e.graph_replays for e in engines],
             "decode_steps": steps, "median_tpot_s": res["median_tpot_s"],
             "decode_tokens_per_s": res["decode_tokens_per_s"],
             "peak_memory_gb": res["peak_memory_gb"]}
    emit(graph)
    n = layer_counts(cfg)
    kernels = path_kernels(cfg)
    want = {"flash_attention": (n["kv"] + n["win"]) * prefill_calls,
            "ssd": n["ssm"] * prefill_calls,
            "paged_attention": (n["kv"] + n["win"]) * len(decodes),
            **fused_counts(cfg, len(decodes), prefill_calls)}
    if not (len(done) == n_req
            and all(len(r.generated) == max_new for r in done)
            and launches == want and all(want[n] > 0 for n in kernels)
            and graph["graph_replays"] == steps
            and {0, 1} <= set(report["routed"])):
        raise AssertionError(f"full-width serve incomplete: {res}, "
                             f"launches wanted {want}")
    return launches


VARIANT_WINDOWS = (1024, 512)  # the variant's window layers, in turn


def with_config(model, cfg):
    """A model over ``model``'s own parameters that runs ``cfg``, whose
    layers hold the same parameters (another softcap or other window
    sizes)."""
    from repro_torch.models.model import Block, Model
    return Model(cfg, model.top, [
        Block(spec, blk.attn, blk.ffn, blk.mixer)
        for spec, blk in zip(cfg.layer_list(), model.layers)])


def serve_variant(card: str) -> dict:
    """gemma3-12b whole on one weight set (seed 0), as published and with
    an attention softcap of ``SOFTCAP`` and its window layers at
    ``VARIANT_WINDOWS`` in turn, on one engine at a time: one-shot, then
    in 512-token chunks, each admission in the turns published, variant,
    variant, published (host time moves a step by ~10% between runs),
    every engine serving the same 6 requests of 128-2048 prompt and 32
    new tokens.  Every request must finish, every decode step be a replay
    of the engine's graph, and the flash and paged kernels launch exactly
    once per attention layer per prefill call and decode step.  Returns
    {path: launches of its four engines}."""
    import dataclasses
    import torch
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    base = served_config("gemma3-12b")
    variant = dataclasses.replace(
        serve.alternate_windows(base, VARIANT_WINDOWS),
        name=f"{base.name}-softcap-windows", logit_softcap=SOFTCAP)
    size = serve.SIZES["full"]
    max_new, n_req = 32, 6
    _free_card()
    params = init_params(base, seed=0, dtype=size["dtype"], device="cuda")
    models = {base.name: params, variant.name: with_config(params, variant)}
    by_path = {f"{name} one-engine serve": {} for name in models}
    for chunk in (None, size["prefill_chunk"]):
        for turn, cfg in enumerate((base, variant, variant, base)):
            model = models[cfg.name]
            n = layer_counts(cfg)
            _free_card()
            eng = InferenceEngine(cfg, model, max_batch=size["max_batch"],
                                  max_len=size["max_len"],
                                  page_size=size["page_size"],
                                  prefill_chunk=chunk, device="cuda")
            requests = serve.make_requests(cfg, n_req, max_new, "full",
                                           seed=0)
            _zero_counts()
            report = serve.serve([eng], requests)
            launches = _path_counts()
            events = report["events"][0]
            prefills = [dt for kind, _, dt in events if kind == "prefill"]
            decodes = [(k, dt) for kind, k, dt in events if kind == "decode"]
            calls = sum(1 if chunk is None else math.ceil(r.prompt_len / chunk)
                        for r in eng.completed)
            want = {"flash_attention": (n["kv"] + n["win"]) * calls,
                    "paged_attention": (n["kv"] + n["win"]) * len(decodes),
                    "ssd": 0, **fused_counts(cfg, len(decodes), calls)}
            res = {"phase": "serve_variant", "config": cfg.name,
                   "turn": turn, "softcap": cfg.logit_softcap,
                   "windows": sorted({b.window for b in cfg.layer_list()
                                      if b.mixer == "window"}),
                   "layers_by_cache": n,
                   "admission": "one-shot" if chunk is None
                   else f"chunks of {chunk}",
                   "requests": n_req, "finished": len(eng.completed),
                   "prompt_tokens": sum(r.prompt_len for r in eng.completed),
                   "prefill_calls": calls, "decode_steps": len(decodes),
                   "graph_replays": eng.graph_replays,
                   "capture_s": eng.capture_s, "launches": launches,
                   "median_ttft_s": statistics.median(prefills),
                   "median_tpot_s": statistics.median(dt for _, dt
                                                      in decodes),
                   "decode_tokens_per_s": (sum(k for k, _ in decodes)
                                           / sum(dt for _, dt in decodes)),
                   "ring_gb": eng.window.nbytes / 1e9,
                   "ring_stacks": [st.size for st in eng.window.stacks],
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "nvidia_smi": card}
            emit(res)
            if not (len(eng.completed) == n_req
                    and all(len(r.generated) == max_new
                            for r in eng.completed)
                    and launches == want
                    and eng.graph_replays == len(decodes) > 0):
                raise AssertionError(f"gemma3-12b serve failed: {res}, "
                                     f"launches wanted {want}")
            total = by_path[f"{cfg.name} one-engine serve"]
            for k, c in launches.items():
                total[k] = total.get(k, 0) + c
            del eng
    del params, models, model
    _free_card()
    return by_path


# ---------------------------------------------------------------------------
# phase 5: GoodServe's decision path on a profile measured on this card
# ---------------------------------------------------------------------------

PREDICT_TOL = 1e-4     # card vs CPU predictions, of the largest log1p value


def goodput_profile():
    import torch
    from repro_torch.launch import goodput
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w = wrappers()
    for f in w.values():
        f.launches = 0
    t0 = time.perf_counter()
    prof = goodput.measure_profile("full", "cuda")
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in w.items()}
    ana = goodput.analytic_beside(prof)
    res = {"phase": "goodput_profile", "hardware": prof.hardware,
           "model": prof.model, "provenance": prof.provenance,
           "decode_batches": prof.decode_batches,
           "decode_ctxs": prof.decode_ctxs, "decode_s": prof.decode_s,
           "analytic_h800_decode_s": ana.decode_s,
           "prefill_tokens": prof.prefill_tokens, "prefill_s": prof.prefill_s,
           "analytic_h800_prefill_s": ana.prefill_s,
           "overhead_s": prof.overhead_s, "meta": prof.meta,
           "launches": launches, "seconds": seconds,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(res)
    flat = [t for row in prof.decode_s for t in row] + list(prof.prefill_s)
    if not (prof.provenance == "measured-cuda"
            and all(math.isfinite(t) and t > 0 for t in flat)
            and prof.meta["analytic_points"] == []
            and launches["paged_attention"] > 0
            and launches["flash_attention"] > 0 and launches["ssd"] == 0):
        raise AssertionError(f"goodput profile failed: {res}")
    return prof, launches


def goodput_predictor():
    import numpy as np
    import torch
    from repro_torch.cluster.workload import train_corpus
    from repro_torch.launch import goodput
    pred, fit = goodput.fit_predictor("full", "cuda")
    test = train_corpus(n=300, seed=9)
    cpu = copy.copy(pred)
    cpu.params = copy.deepcopy(pred.params).to("cpu")
    cpu.device = torch.device("cpu")
    on_card = np.log1p(pred.predict_requests(test))
    on_cpu = np.log1p(cpu.predict_requests(test))
    err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    res = {"phase": "goodput_predictor", "scale": "PAPER_SCALE",
           "num_experts": pred.K, **fit, "cpu_max_rel_log_err": err,
           "tol": PREDICT_TOL, "device": str(pred.device)}
    emit(res)
    if not (err <= PREDICT_TOL and math.isfinite(fit["mae"])
            and pred.device.type == "cuda"):
        raise AssertionError(f"goodput predictor failed: {res}")
    return pred


def goodput_runs(pred, prof, n: int = 400):
    from repro_torch.launch import goodput
    rows = goodput.run_goodput(pred, prof, n=n, scales=(1.0, 2.0, 3.0))
    for r in rows:
        emit({"phase": "goodput", **r})
    runs = [r for r in rows if "router" in r]
    if not (len(runs) == 2 * 3 * len(goodput.ROUTERS)
            and all(r["n_finished"] == n for r in runs)):
        raise AssertionError("goodput: a run did not finish every request")


def dr_bounds_hold(row: dict, max_weight: float) -> bool:
    """What the bandit's doubly-robust estimate guarantees: rewards are 0
    or 1, so the direct model's value, the what-if value and the match
    rate lie in [0, 1]; each matched event adds ``w (reward - Q)`` with
    ``w <= max_weight`` and ``|reward - Q| <= 1``, so the estimate is
    finite and within ``max_weight * match_rate`` of the direct value
    (it may leave [0, 1])."""
    return (all(0.0 <= row[k] <= 1.0
                for k in ("dr_direct", "whatif_value", "dr_match_rate"))
            and math.isfinite(row["dr_value"])
            and abs(row["dr_value"] - row["dr_direct"])
            <= max_weight * row["dr_match_rate"])


def goodput_policies(pred, prof, n: int = 400):
    """Phase 5 (d): the rest of the control plane on fig6's trace over the
    pool with the measured H100 (``goodput.policy_runs``).  Every request
    of each run must be accounted for: finished, shed, throttled,
    cascaded or lost, none left open; the bandit's estimates must keep
    ``dr_bounds_hold``."""
    import inspect
    from repro_torch.core.replay import dr_estimate
    from repro_torch.launch import goodput
    rows = goodput.policy_runs(pred, prof, n=n)
    for r in rows:
        emit({"phase": "goodput_policy", **r})
    bad = [r["policy"] for r in rows
           if not (r["n"] == n == sum(r["accounting"].values())
                   and r["accounting"]["open"] == 0
                   and math.isfinite(r["goodput_rps"]))]
    bandit = next(r for r in rows if r["policy"] == "bandit")
    max_weight = inspect.signature(dr_estimate).parameters[
        "max_weight"].default
    if (bad or [r["policy"] for r in rows] != goodput.POLICIES
            or not dr_bounds_hold(bandit, max_weight)):
        raise AssertionError(f"goodput policies: unaccounted requests, a "
                             f"failed run in {bad}, or the bandit's "
                             f"estimates out of bounds: {bandit}")


# ---------------------------------------------------------------------------
# phase 6: training through the plain path (no kernel), and the launcher
# ---------------------------------------------------------------------------

TRAIN_PARITY_ARCHS = ("llama3.1-8b", "mamba2-1.3b", "deepseek-v2-lite-16b",
                      "gemma3-27b", "jamba-v0.1-52b")
TRAIN_TOL = {"loss_rel": 1e-2, "cosine": 0.99, "norm_rel": 2e-2,
             "eval_nll_abs": 1e-2}
TRAIN_TOL_F32 = {"loss_rel": 1e-4, "cosine": 0.9999, "norm_rel": 1e-3}
# (arch, grad-accumulation micro-batches): micro-batch 2 x 4096 tokens
TRAIN_FULL = (("minicpm-2b", 4), ("mamba2-1.3b", 2))
TRAIN_MICRO, TRAIN_SEQ, TRAIN_TIMED = 2, 4096, 2


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _grad_gap(a, b):
    """(cosine, relative norm difference, relative distance ``|a - b|``) of
    two gradients, both relative to the larger norm; (1, 0, 0) where both
    are zero."""
    na, nb = a.norm().item(), b.norm().item()
    if na == nb == 0.0:
        return 1.0, 0.0, 0.0
    cos = (a.flatten() @ b.flatten()).item() / (na * nb) if na * nb else 0.0
    return cos, abs(nb - na) / max(na, nb), (a - b).norm().item() / max(na, nb)


def _limit(tol, floor=None):
    """(least cosine, largest relative norm difference) a leaf's card-vs-CPU
    gradient gap is held to: ``tol``'s bound, or, where ``floor`` (the
    leaf's CPU bf16 gradient against its CPU float32 one) is already past
    the bound on either measure, the looser of the bound and twice the
    floor's gap: ``1 - cosine`` doubled, and the norm difference held to
    twice the floor's relative distance (one draw of bf16 rounding can
    leave the norm nearly as it was while moving the gradient far; the
    distance bounds the norm difference of any draw of its size)."""
    cos, norm = tol["cosine"], tol["norm_rel"]
    if floor is not None and (floor[0] < cos or floor[1] > norm):
        cos = min(cos, 1.0 - 2.0 * (1.0 - floor[0]))
        norm = max(norm, 2.0 * floor[2])
    return cos, norm


def _within(gap, limit) -> bool:
    return gap[0] >= limit[0] and gap[1] <= limit[1]


def train_parity(arch: str):
    """(a) One ``make_train_step`` of reduced ``arch`` (phase 3's sizes) on
    the card and on the CPU from the same weights and a ``SyntheticLM``
    batch (2 x 64), in float32 (``cast_half`` patched to the identity,
    TF32 off) and in bf16 as the reference casts.  float32: the same
    function, the loss within 1e-4 relative, every leaf's gradient at
    cosine >= 0.9999 with its norm within 0.1%.  bf16: the loss within
    1e-2 relative, each leaf's gradient at cosine >= 0.99 with its norm
    within 2%, where bf16's own rounding allows it: a leaf whose CPU bf16
    gradient is already further than that from its CPU float32 gradient
    (an MoE or scan layer's at cancellation-heavy init) is held to twice
    its own gap (``_limit``), and the three nearest their limit are listed
    with both readings."""
    from unittest import mock
    import torch
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.training import train_step
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    _free_card()
    cfg = reduced_config(arch)
    base = init_params(cfg, torch.Generator().manual_seed(3),
                       dtype=torch.float32, device="cpu")
    batch = [torch.from_numpy(a) for a in
             SyntheticLM(cfg.vocab_size, seed=0).batch(0, 2, 64)]
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, total_steps=10), ce_chunk=32)
    loss, grads = {}, {}
    for dtype in ("bfloat16", "float32"):
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(dev)
            opt = init_opt_state(dict(model.named_parameters()))
            with mock.patch.object(train_step, "cast_half",
                                   lambda p, dtype=None: p) \
                    if dtype == "float32" else contextlib.nullcontext():
                m = step(model, opt, *(t.to(dev) for t in batch))[2]
            loss[dtype, dev] = float(m["loss"])
            grads[dtype, dev] = {n: p.grad.double().cpu()
                                 for n, p in model.named_parameters()}
            del model, opt
    res = {"phase": "train_parity", "config": cfg.name,
           "leaves": len(grads["float32", "cpu"]),
           "tol": {"bfloat16": TRAIN_TOL, "float32": TRAIN_TOL_F32}}
    bad = []
    for dtype, tol in (("float32", TRAIN_TOL_F32), ("bfloat16", TRAIN_TOL)):
        gaps = {n: _grad_gap(grads[dtype, "cpu"][n], grads[dtype, "cuda"][n])
                for n in grads[dtype, "cpu"]}
        floor = {n: _grad_gap(grads["float32", "cpu"][n],
                              grads["bfloat16", "cpu"][n]) for n in gaps}
        limit = {n: _limit(tol, floor[n] if dtype == "bfloat16" else None)
                 for n in gaps}
        noisy = [n for n in gaps if limit[n] != _limit(tol)]
        rel = abs(loss[dtype, "cuda"] - loss[dtype, "cpu"]) \
            / abs(loss[dtype, "cpu"])
        res[dtype] = {
            "loss_cpu": loss[dtype, "cpu"], "loss_cuda": loss[dtype, "cuda"],
            "loss_rel_err": rel,
            "worst_grad_cosine": min(gaps[n][0] for n in gaps),
            "worst_grad_norm_rel": max(gaps[n][1] for n in gaps),
            "leaves_at_the_bound": len(gaps) - len(noisy)}
        if noisy:      # the count, and the three nearest their own limit
            def use(n):
                return max((1.0 - gaps[n][0]) / (1.0 - limit[n][0]),
                           gaps[n][1] / limit[n][1])
            res[dtype]["held_to_twice_their_bf16_floor"] = {
                "leaves": len(noisy), "worst_share_of_limit": max(
                    use(n) for n in noisy),
                "nearest": {n: {"card_vs_cpu": gaps[n],
                                "cpu_bf16_vs_f32": floor[n],
                                "limit": limit[n]}
                            for n in sorted(noisy, key=use)[-3:]}}
        bad += [f"{dtype} loss"] if rel > tol["loss_rel"] else []
        bad += [f"{dtype} {n}" for n in gaps if not _within(gaps[n],
                                                            limit[n])]
    emit(res)
    if bad:
        raise AssertionError(f"training on the card disagrees with the CPU: "
                             f"{res}, failing {bad}")


def _mean_nll(model, tokens, labels, mask, train: bool):
    import torch
    from repro_torch.models.model import lm_head_weight, model_forward
    from repro_torch.training.loss import chunked_cross_entropy
    with torch.no_grad():
        hidden, _ = model_forward(model, tokens, train=train, remat=False)
        return float(chunked_cross_entropy(hidden, lm_head_weight(model),
                                           labels, mask)[0])


def train_full_width(arch: str, accum: int, card: str):
    """(b) ``arch`` whole at full width: fp32 masters drawn on the card from
    seed 0, AdamW (lr 3e-4, 100 total steps, 10 warmup, WSD where the
    config prescribes it), ``make_grad_accum_step`` over ``accum``
    micro-batches of 2 x 4096 tokens; one untimed step, then two timed.
    After the first step every leaf must hold a finite, non-zero
    gradient.  Returns the model for (c)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_grad_accum_step
    _free_card()
    cfg = get_config(arch)
    data = SyntheticLM(cfg.vocab_size, seed=0)
    t0 = time.perf_counter()
    batches = [[torch.from_numpy(a).reshape(accum, TRAIN_MICRO, TRAIN_SEQ)
                .to("cuda") for a in data.batch(i, accum * TRAIN_MICRO,
                                                TRAIN_SEQ)]
               for i in range(1 + TRAIN_TIMED)]
    data_s = time.perf_counter() - t0
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    opt = init_opt_state(dict(model.named_parameters()))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                       schedule=("wsd" if cfg.lr_schedule == "wsd"
                                 else "cosine"))
    step = make_grad_accum_step(cfg, ocfg, accum)
    w = wrappers()
    for f in w.values():
        f.launches = 0
    secs, losses, gnorms, lrs, lacking = [], [], [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(model, opt, *batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(m["lr"])
        if i == 0:
            lacking = [n for n, p in model.named_parameters()
                       if p.grad is None or not bool(p.grad.any())
                       or not bool(torch.isfinite(p.grad).all())]
    timed = secs[1:]
    tokens = accum * TRAIN_MICRO * TRAIN_SEQ
    step_s = statistics.median(timed)
    n = cfg.param_count()
    full = get_config("llama3.1-8b").param_count()
    res = {"phase": "train_full_width", "config": cfg.name, "n_params": n,
           "num_layers": cfg.num_layers, "schedule": ocfg.schedule,
           "masters": "float32", "compute": "bfloat16 (cast_half)",
           "accum": accum, "micro_batch": TRAIN_MICRO, "seq": TRAIN_SEQ,
           "tokens_per_step": tokens, "first_step_s": secs[0],
           "step_s": timed, "median_step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "mfu": 6 * n * tokens / (step_s * PEAK_FLOPS["bfloat16"]),
           "mfu_formula": "6 * n_params * tokens / (step_s * 989e12); "
                          "attention flops left out",
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "grad_norm": gnorms, "lr": lrs,
           "leaves": sum(1 for _ in model.parameters()),
           "leaves_zero_or_nonfinite_grad": len(lacking),
           "kernel_launches": {k: f.launches for k, f in w.items()},
           "data_s": data_s, "nvidia_smi": card,
           "cut": f"batch: {tokens} tokens a step, train_4k's global batch "
                  f"cut from 256 to {accum * TRAIN_MICRO} sequences of "
                  f"{TRAIN_SEQ}; {1 + TRAIN_TIMED} steps"}
    res["why_not_llama3.1-8b"] = (f"{full:,} parameters x 16 B (fp32 "
                                  f"masters, grads, m, v) exceed 80 GB")
    emit(res)
    if not (lacking == [] and all(map(math.isfinite, losses + gnorms))
            and not any(res["kernel_launches"].values())):
        raise AssertionError(f"full-width training failed: {res}, leaves "
                             f"lacking a gradient {lacking}")
    return model, opt


def train_eval(model, opt):
    """(c) The trained weights cast to bf16 on a held-out batch (1 x 2048):
    the mean NLL through the serving forward (flash attention) and the
    plain training forward, under ``no_grad``, within 1e-2; the flash
    kernel launched once per attention layer.  Returns the launches."""
    import torch
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models.model import layer_caches
    cfg = model.cfg
    for p in model.parameters():
        p.grad = None
    opt.clear()
    _free_card()
    model.to(torch.bfloat16)
    toks, labels, mask = (torch.from_numpy(a).to("cuda") for a in
                          SyntheticLM(cfg.vocab_size, seed=1).batch(0, 1,
                                                                    2048))
    w = wrappers()
    for f in w.values():
        f.launches = 0
    serve = _mean_nll(model, toks, labels, mask, train=False)
    launches = {n: f.launches for n, f in w.items()}
    plain = _mean_nll(model, toks, labels, mask, train=True)
    attn = sum(kind in ("kv", "win") for kind, _ in layer_caches(cfg))
    res = {"phase": "train_eval", "config": cfg.name, "dtype": "bfloat16",
           "tokens": 2048, "nll_serve_flash": serve, "nll_train_plain": plain,
           "abs_err": abs(serve - plain), "tol": TRAIN_TOL["eval_nll_abs"],
           "launches": launches, "attention_layers": attn}
    emit(res)
    if not (res["abs_err"] <= TRAIN_TOL["eval_nll_abs"]
            and launches["flash_attention"] == attn
            and launches["ssd"] == launches["paged_attention"] == 0
            and math.isfinite(serve)):
        raise AssertionError(f"serving and training forwards disagree on "
                             f"the trained weights: {res}")
    return launches


def train_launcher():
    """(d) ``python -m repro_torch.launch.train --arch llama3.1-8b --reduced
    --steps 100 --ckpt-dir DIR`` (its ``main``, in this process), DIR under
    the checkout's ``build/``: the final loss below ln 512, and the last
    checkpoint restoring with every leaf finite."""
    import io
    import shutil
    import numpy as np
    from repro_torch.launch import train
    from repro_torch.training.checkpoint import latest_step, restore_checkpoint
    _free_card()
    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(["--arch", "llama3.1-8b", "--reduced", "--steps",
                             "100", "--ckpt-dir", str(ckpt)])
    seconds = time.perf_counter() - t0
    last = latest_step(ckpt)

    def flat(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, list):
            return [a for v in node for a in flat(v)]
        return [np.asarray(node)]

    leaves = flat(restore_checkpoint(ckpt, last))
    res = {"phase": "train_launcher", "argv": "--arch llama3.1-8b --reduced "
           "--steps 100", "seconds": seconds, "first_loss": losses[0],
           "final_loss": losses[-1], "uniform_entropy": math.log(512),
           "last_checkpoint": last, "leaves": len(leaves),
           "all_finite": all(np.isfinite(a).all() for a in leaves),
           "last_line": out.getvalue().strip().splitlines()[-1]}
    shutil.rmtree(ckpt, ignore_errors=True)
    emit(res)
    if not (res["final_loss"] < math.log(512) and last == 100
            and res["all_finite"]):
        raise AssertionError(f"the training launcher failed: {res}")


def train_phase(card: str) -> dict:
    """Phase 6: (a) to (d).  Returns the flash launches of (c)."""
    for arch in TRAIN_PARITY_ARCHS:
        train_parity(arch)
    evals = None
    for arch, accum in TRAIN_FULL:
        model, opt = train_full_width(arch, accum, card)
        if evals is None:
            evals = train_eval(model, opt)
        del model, opt
    train_launcher()
    _free_card()
    return evals


# ---------------------------------------------------------------------------
# phase 7: the distributed layer: the dry run, and the sharded path on the
# card
# ---------------------------------------------------------------------------

# (multi-pod, arch, shape): one cell of each kind on the single-pod mesh
# (a train cell takes 16-175 s of host time there): the cheapest train
# cell, the B3 prefill, the MoE local_map + MLA decode; on the multi-pod
# mesh the decode cell (its train and prefill cells take 71-365 s of host
# time, DTensor planning redistributions over three mesh dims)
DRYRUN_CELLS = ((False, "internvl2-1b", "train_4k"),
                (False, "mamba2-1.3b", "prefill_32k"),
                (False, "deepseek-v2-lite-16b", "decode_32k"),
                (True, "deepseek-v2-lite-16b", "decode_32k"))
SHARD_B, SHARD_L, SHARD_STEPS = 8, 1024, 8
NEAR_TIE_ULPS = 2     # a top-2 gap two kernels' bf16 rounding may reverse
# (c)'s control: B1 over pages against the ring's ``_sdpa`` on one history
# differs by up to 3.0 bf16 spacings in llama3.1-8b's bf16 logits on an
# H100; a fault of the ring path, which the control shares with the mesh,
# shows far above
CONTROL_SPACINGS = 4


def dryrun_phase():
    """(a) The dry run on the production meshes (16 x 16 and 2 x 16 x 16)
    in a fake world of 256 and 512 ranks: each cell of ``DRYRUN_CELLS``,
    one summary record each.  Host work: nothing on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    mem0 = torch.cuda.memory_allocated()
    for multi_pod, arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod, save=False)
        emit({"phase": "dryrun", "summary": dryrun._summary_line(rec),
              **rec})
        if not (rec["flops_per_device"] > 0
                and rec["memory"]["argument_bytes"] > 0):
            raise AssertionError(f"empty dry-run record: {rec}")
    dist.destroy_process_group()
    if torch.cuda.memory_allocated() != mem0:
        raise AssertionError("the dry run allocated on the card")


def _path_counts():
    return {n: f.launches for n, f in wrappers().items()}


def _zero_counts():
    for f in wrappers().values():
        f.launches = 0


def _top2_rows(logits) -> list:
    """Per row of logits [B, V]: (top-2 gap, bf16 spacing at the top
    logit)."""
    top = logits.float().topk(2, dim=-1).values.tolist()
    return [(a - b, 2.0 ** (math.floor(math.log2(max(abs(a), 2.0 ** -126)))
                            - 7)) for a, b in top]


def _by_row(step_logits) -> list:
    """Per row, per step: ``_top2_rows`` of each step's logits [B, V]."""
    return [list(r) for r in zip(*(_top2_rows(l) for l in step_logits))]


def _sharded_prefill(arch: str, ctx, card: str, want: dict, before=None):
    """``prefill`` of ``SHARD_B`` x ``SHARD_L`` random prompts through
    ``arch`` at full width in bf16, unsharded and then with the model
    placed on ``ctx``'s mesh; the sharded run's logits within 2e-2 of the
    unsharded ones, its launches exactly ``want`` and, for a MoE config,
    every MoE layer through the ``local_map`` branch.  ``before(model,
    logits, states)`` runs on the unsharded model and its prefill first.
    Returns (model, sharded logits, sharded states, the sharded run's
    counts, what ``before`` returned)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharded as SH
    from repro_torch.models import layers as L
    from repro_torch.models.model import init_params, prefill
    _free_card()
    cfg = get_config(arch)
    model = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (SHARD_B, SHARD_L), generator=g,
                         device="cuda")
    with torch.no_grad():
        ref_logits, ref_states = prefill(model, toks)
    extra = before(model, ref_logits, ref_states) if before else None
    del ref_states
    SH.place_model(model, ctx, fsdp=False)
    moe_calls = []
    real = L._moe_sharded
    L._moe_sharded = lambda *a: moe_calls.append(1) or real(*a)
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, states = prefill(model, SH.place_batch(toks, ctx),
                                     ctx=ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _path_counts()
    finally:
        L._moe_sharded = real
    err = max_err(SH.full(logits), ref_logits)
    n_moe = sum(b.ffn == "moe" for b in cfg.layer_list())
    res = {"phase": "sharded_prefill", "config": cfg.name,
           "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)),
           "backend": torch.distributed.get_backend(), "batch": SHARD_B,
           "prompt_len": SHARD_L, "wall_s": wall, "launches": counts,
           "moe_local_map_calls": len(moe_calls), "max_abs_err": err,
           "tol": TOL["bfloat16"], "nvidia_smi": card}
    emit(res)
    if not (err <= TOL["bfloat16"] and counts == want
            and len(moe_calls) == n_moe):
        raise AssertionError(f"sharded prefill failed: {res}, launches "
                             f"wanted {want}, {n_moe} MoE layers")
    return model, logits, states, counts, extra


def _paged_decode(model, ref_logits, ref_states):
    """The engine's decode step (B1 over a paged cache) for ``SHARD_STEPS``
    greedy steps after the unsharded prefill: tokens [B, 1 + steps] and
    each step's logits."""
    import torch
    from repro_torch.engine.kv_cache import PagedKVCache
    from repro_torch.models.model import decode_step
    cfg = model.cfg
    max_len = SHARD_L + SHARD_STEPS + 16
    cache = PagedKVCache(cfg, SHARD_B * -(-max_len // 16), 16,
                         slots=SHARD_B, max_len=max_len, dtype=model.dtype,
                         device="cuda")
    for b in range(SHARD_B):
        cache.allocate(b, SHARD_L)
        idx = cache.token_index(b, 0, SHARD_L)
        for layer, (k, v) in enumerate(ref_states):
            cache.write(layer, idx, k[b], v[b])
    nxt = ref_logits.argmax(-1)
    toks_out, logits_out = [nxt], [ref_logits]
    with torch.no_grad():
        for _ in range(SHARD_STEPS):
            for b in range(SHARD_B):
                cache.extend(b, 1)
            logits = decode_step(model, nxt, cache.decode_view())
            nxt = logits.argmax(-1)
            toks_out.append(nxt)
            logits_out.append(logits)
    return torch.stack(toks_out, 1), logits_out


def _ring_decode(model, ctx, logits, states):
    """``ring_decode_step`` over the sharded prefill's ring cache for
    ``SHARD_STEPS`` greedy steps: tokens [B, 1 + steps], each step's
    logits (whole), wall seconds and launches."""
    import torch
    from repro_torch.launch import sharded as SH
    from repro_torch.models.model import ring_decode_step, to_ring_cache
    cfg = model.cfg
    max_len = SHARD_L + SHARD_STEPS
    cache = SH.place_cache(to_ring_cache(cfg, states, max_len, SHARD_L), cfg,
                           ctx, max_len)
    full = SH.full(logits)
    nxt = full.argmax(-1)
    toks_out, logits_out = [nxt], [full]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(SHARD_STEPS):
            step_logits, cache = ring_decode_step(
                model, SH.place_batch(nxt[:, None], ctx), cache, ctx)
            full = SH.full(step_logits)
            nxt = full.argmax(-1)
            toks_out.append(nxt)
            logits_out.append(full)
    torch.cuda.synchronize()
    return (torch.stack(toks_out, 1), logits_out,
            time.perf_counter() - t0, _path_counts())


def _compare_tokens(ring, ring_top2, paged, paged_top2) -> dict:
    """Greedy tokens of the ring decode against the paged one, row by row
    up to the first difference (``ring[b]``, ``paged[b]``: row b's tokens;
    ``*_top2[b][t]``: the top-2 gap and bf16 spacing of the logits that
    picked token t); a difference must be a near tie (both paths' top-2
    logit gaps within ``NEAR_TIE_ULPS`` bf16 spacings of their top logit),
    after which the rows diverge and are not compared further."""
    flips, bad, compared = [], [], 0
    for b in range(len(ring)):
        for t in range(min(len(ring[b]), len(paged[b]))):
            compared += 1
            if ring[b][t] == paged[b][t]:
                continue
            (g_r, u_r), (g_p, u_p) = ring_top2[b][t], paged_top2[b][t]
            tie = g_r <= NEAR_TIE_ULPS * u_r and g_p <= NEAR_TIE_ULPS * u_p
            (flips if tie else bad).append(
                {"row": b, "step": t, "top2_gap_ring": g_r,
                 "top2_gap_paged": g_p, "bf16_spacing": max(u_r, u_p)})
            break
    return {"tokens_compared": compared, "near_tie_flips": flips,
            "mismatches": bad}


def _sharded_train(ctx, card: str):
    """One ``make_train_step`` of minicpm-2b at full width (fp32 masters,
    seed 0, batch 2 x 4096), unsharded and then on DTensor masters placed
    by the FSDP specs: the loss within 1e-4 relative, and every leaf's
    update (new less old) at cosine >= 0.9999 with its norm within 0.1%
    of the unsharded one's (phase 6 (a)'s fp32 limits)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.distributed.context import NULL_CTX
    from repro_torch.launch import sharded as SH
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg = get_config("minicpm-2b")
    batch = [torch.from_numpy(a).to("cuda") for a in SyntheticLM(
        cfg.vocab_size, seed=0).batch(0, TRAIN_MICRO, TRAIN_SEQ)]
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                       schedule="wsd")
    runs = []
    for sharded in (False, True):
        _free_card()
        model = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
        old = {n: p.detach().cpu() for n, p in model.named_parameters()}
        args = batch
        if sharded:
            SH.place_model(model, ctx, fsdp=True)
            args = [SH.place_batch(t, ctx) for t in batch]
        opt = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, ocfg, ctx if sharded else NULL_CTX,
                               ce_chunk=512)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(model, opt, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {n: SH.full(p.detach()).cpu() - old[n]
                 for n, p in model.named_parameters()}
        runs.append((float(SH.full(m["loss"])), delta, wall, _path_counts(),
                     torch.cuda.max_memory_allocated() / 1e9))
        del model, opt, old, m
    (loss0, d0, wall0, _, peak0), (loss1, d1, wall1, counts, peak1) = runs
    worst = (1.0, 0.0, "")
    for n in d0:
        a, b = d0[n].cuda(), d1[n].cuda()
        cos, norm, _ = _grad_gap(a, b)
        if (cos, -norm) < (worst[0], -worst[1]):
            worst = (cos, norm, n)
    loss_rel = abs(loss1 - loss0) / abs(loss0)
    res = {"phase": "sharded_train", "config": cfg.name,
           "mesh": dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.mesh.shape)),
           "batch": [TRAIN_MICRO, TRAIN_SEQ], "masters": "float32",
           "loss_unsharded": loss0, "loss_sharded": loss1,
           "loss_rel": loss_rel, "worst_update_cosine": worst[0],
           "worst_update_norm_rel": worst[1], "worst_leaf": worst[2],
           "wall_s_unsharded": wall0, "wall_s_sharded": wall1,
           "peak_gb_unsharded": peak0, "peak_gb_sharded": peak1,
           "launches": counts, "nvidia_smi": card}
    emit(res)
    if not (loss_rel <= TRAIN_TOL_F32["loss_rel"]
            and worst[0] >= TRAIN_TOL_F32["cosine"]
            and worst[1] <= TRAIN_TOL_F32["norm_rel"]
            and not any(counts.values())):
        raise AssertionError(f"sharded train step failed: {res}")
    return counts


# (c) the engine under the mesh: (arch, dtype, requests, prefill chunk sizes
# (None: one-shot))
MESH_ENGINES = (("llama3.1-8b", "bfloat16", 12, (None, 512)),
                ("mamba2-1.3b", "bfloat16", 6, (None,)),
                ("deepseek-v2-lite-16b", "bfloat16", 6, (None,)))


def _recording_engine():
    """``InferenceEngine`` that keeps, per request, the logits that picked
    each generated token (``picks``: the prefill's, and each decode
    step's from a copy taken inside the step, inside the graph on the
    card), on the host, for ``_compare_tokens`` and ``_logit_diff``."""
    import torch
    from repro_torch.engine.engine import InferenceEngine

    class Recording(InferenceEngine):
        def __init__(self, *a, **kw):
            self.picks, self._rows, self._seen, self._first = {}, [], None, None
            super().__init__(*a, **kw)

        def _greedy(self, logits):
            self._first = logits[0].to("cpu", copy=True)
            return InferenceEngine._greedy(logits)

        def _prefill_into_slot(self, slot, req, call=None):
            super()._prefill_into_slot(slot, req, call)
            self.picks[req.rid] = [self._first]

        def _finish_staged(self, logits):
            req = self._staging["req"]
            super()._finish_staged(logits)
            self.picks[req.rid] = [self._first]

        def _step_logits(self):
            logits = super()._step_logits()
            if self._seen is None:
                self._seen = torch.empty_like(logits)
            self._seen.copy_(logits)
            return logits

        def _fill_inputs(self, active):
            super()._fill_inputs(active)
            self._rows = [(i, self.slots[i]) for i in active]

        def step(self):
            self._rows = []
            n = super().step()
            if self._rows:
                seen = self._seen.to("cpu", copy=True)
                for i, req in self._rows:
                    self.picks[req.rid].append(seen[i])
            return n
    return Recording


def _logit_diff(a_tokens, a_logits, b_tokens, b_logits, top: int = 20):
    """The two paths' logit difference on the histories they share: per
    row, at every pick before the rows' first differing token, the
    largest difference at ``b``'s ``top`` logits in bf16 spacings of its
    top logit.  Returns {"max", "mean", "picks"}."""
    diffs = []
    for ta, la, tb, lb in zip(a_tokens, a_logits, b_tokens, b_logits):
        for t in range(min(len(ta), len(tb))):
            ref = lb[t].float()
            idx = ref.topk(top).indices
            spacing = _top2_rows(ref[None])[0][1]
            diffs.append(float((la[t].float()[idx] - ref[idx]).abs().max())
                         / spacing)
            if ta[t] != tb[t]:
                break
    return {"max": max(diffs), "mean": sum(diffs) / len(diffs),
            "picks": len(diffs)}


def _ring_reference(model, requests, chunk, max_batch: int,
                    max_len: int) -> list:
    """Per request (an engine's finished ``EngineRequest``), the logits
    that pick each of its generated tokens on the unsharded ring path:
    plain tensors, ``NULL_CTX``, eager, fed the request's own tokens.  Its
    prompt is admitted as the engine under a mesh admits one (``prefill``
    and ``to_ring_cache``, or ``prefill_chunk`` in chunks of ``chunk`` into
    one staging cache and ``ring_convert_cache``) and spliced into a slot
    of one ring cache of ``max_batch`` x ``max_len`` (``splice_ring``);
    then ``ring_decode_step`` runs every slot at [max_batch, 1], 0 in a
    free row, ``max_batch`` requests at a time.  The arithmetic of the
    engine's step on the 1 x 1 mesh, through the code paths of plain
    tensors (``splice_ring``'s and the ring write's), the prompt's glue
    through the plain chains as the mesh engine's (``plain_glue``)."""
    import torch
    from repro_torch.models.model import (init_cache, prefill, prefill_chunk,
                                          ring_convert_cache,
                                          ring_decode_step, splice_ring,
                                          to_ring_cache)
    cfg, dev = model.cfg, model.device
    ring = init_cache(cfg, max_batch, max_len, dtype=model.dtype, device=dev,
                      ring=True)
    stage = (init_cache(cfg, 1, max_len, dtype=model.dtype, device=dev)
             if chunk else None)
    out = []
    with torch.no_grad(), plain_glue():
        for g in range(0, len(requests), max_batch):
            group = requests[g:g + max_batch]
            for slot, r in enumerate(group):
                prompt = torch.tensor(r.tokens[:r.prompt_len],
                                      dtype=torch.long, device=dev)[None]
                if chunk is None:
                    logits, states = prefill(model, prompt)
                    one = to_ring_cache(cfg, states, max_len, r.prompt_len)
                else:
                    stage["pos"] = 0
                    for s in range(0, r.prompt_len, chunk):
                        logits, _ = prefill_chunk(model, stage,
                                                  prompt[:, s:s + chunk])
                    one = ring_convert_cache(cfg, stage, max_len,
                                             r.prompt_len)
                splice_ring(ring, one, slot)
                out.append([logits[0].to("cpu", copy=True)])
            for t in range(max(len(r.generated) for r in group) - 1):
                tok = torch.zeros(max_batch, 1, dtype=torch.long)
                pos = torch.zeros(max_batch, dtype=torch.int32)
                live = [i for i, r in enumerate(group)
                        if t + 1 < len(r.generated)]
                for i in live:
                    tok[i, 0] = group[i].generated[t]
                    pos[i] = group[i].prompt_len + t
                logits, _ = ring_decode_step(
                    model, tok.to(dev),
                    {"layers": ring["layers"], "pos": pos.to(dev)})
                logits = logits.to("cpu")
                for i in live:
                    out[g + i].append(logits[i].clone())
    return out


def _held_pick_by_pick(tokens, top2, ref_logits) -> dict:
    """Each generated token (``tokens[b][t]``, picked by logits of top-2
    gap and bf16 spacing ``top2[b][t]``) against the reference's logits on
    the same history (``ref_logits[b][t]``, which was fed these tokens):
    a different pick must be a near tie on both sides, as in
    ``_compare_tokens``; the histories stay shared, so every pick is
    compared."""
    import torch
    flips, bad, compared = [], [], 0
    for b, (row, row_top2, ref) in enumerate(zip(tokens, top2, ref_logits)):
        ref = torch.stack(ref)
        picks, ref_top2 = ref.float().argmax(-1).tolist(), _top2_rows(ref)
        for t, (a, r) in enumerate(zip(row, picks)):
            compared += 1
            if a == r:
                continue
            (g_a, u_a), (g_r, u_r) = row_top2[t], ref_top2[t]
            tie = g_a <= NEAR_TIE_ULPS * u_a and g_r <= NEAR_TIE_ULPS * u_r
            (flips if tie else bad).append(
                {"row": b, "step": t, "top2_gap": g_a,
                 "top2_gap_reference": g_r, "bf16_spacing": max(u_a, u_r)})
    return {"picks_compared": compared, "near_tie_flips": flips,
            "mismatches": bad}


def _replay_profile(replay, n: int = 3) -> list:
    """[(device ms per replay, launches per replay, kernel name up to 160
    characters)] of ``n`` replays of a captured step, from a
    ``torch.profiler`` trace, the busiest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.device_time_total / n / 1e3, e.count // n, e.key[:160])
            for e in prof.key_averages() if e.device_type == cuda]
    return sorted(rows, reverse=True)


def _admission_trace(eng, prompt) -> dict:
    """One one-shot admission of ``prompt`` into free slots of ``eng``
    (every request done): its wall time untraced, then the device time and
    number of its kernels from a ``torch.profiler`` trace of a second one;
    what the card does not cover of the wall time is the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.engine.engine import EngineRequest

    def admit(slot):
        eng._prefill_into_slot(slot, EngineRequest(
            rid=-1, tokens=list(prompt), prompt_len=len(prompt),
            max_new_tokens=1))
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    admit(0)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        admit(1)
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages() if e.device_type == cuda]
    return {"prompt_tokens": len(prompt), "wall_ms": wall * 1e3,
            "device_busy_ms": sum(e.device_time_total for e in ev) / 1e3,
            "kernels": sum(e.count for e in ev)}


def _capture_collectives(fn) -> tuple:
    """(what ``fn`` returned, the functional all-reduces it issued): the
    MoE ``local_map`` branch's NCCL all-reduces while an engine warms up
    and captures its step, counted where ``layers._AllReduce`` calls
    ``funcol.all_reduce``."""
    import torch.distributed._functional_collectives as funcol
    calls = []
    real = funcol.all_reduce
    funcol.all_reduce = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        return fn(), len(calls)
    finally:
        funcol.all_reduce = real


def engine_under_mesh(arch: str, dtype_name: str, n_req: int, chunks, ctx,
                      card: str, eager: dict) -> dict:
    """(c) ``arch`` at full width in ``dtype_name`` (seed 0) through
    ``InferenceEngine(..., ctx=)`` on the 1 x 1 mesh: the weights placed
    once (``placed_copy``; the memory it adds is reported), the ring
    cache, prefill and the chunk step under ``local_map``, every decode
    step a replay of the ring decode captured in the engine's CUDA graph;
    beside it the unsharded engine (B1 over pages) on the same weights and
    requests, one engine at a time, for each admission in ``chunks``.
    ``n_req`` requests of 128-2048 prompt and 32 new tokens; every one
    must finish, the launches be exact (B2 once per attention layer per
    prefill call, B3 once per mamba layer per prefill, B1 none under the
    mesh and once per attention layer per step without), every decode
    step a replay.  The mesh engine's tokens are held pick by pick to the
    unsharded ring path fed the same tokens (``_ring_reference``,
    ``_held_pick_by_pick``: a different pick only at a near tie, the
    logits at most ``NEAR_TIE_ULPS`` bf16 spacings apart); against the
    unsharded engine's (``_compare_tokens``) a difference must be a near
    tie or the ring path's own, which the control shows: the ring path
    fed the unsharded engine's tokens picks the mesh's token there, its
    logits at most ``CONTROL_SPACINGS`` from the unsharded engine's.  With
    MoE layers the capture must issue the ``local_map``
    branch's all-reduces (``_capture_collectives``) and a replay run
    NCCL's kernel; each mesh run reports one replay's device time by
    kernel (``_replay_profile``).  ``eager``: (b)'s eager ring decode
    step, put beside the TPOT.  Returns each path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import NULL_CTX
    from repro_torch.engine.engine import WARMUP_STEPS
    from repro_torch.launch import serve
    from repro_torch.launch import sharded as SH
    from repro_torch.models.model import init_params
    recording = _recording_engine()
    cfg = get_config(arch)
    size = serve.SIZES["full"]
    n = layer_counts(cfg)
    max_new = 32
    _free_card()
    model = init_params(cfg, seed=0, dtype=getattr(torch, dtype_name),
                        device="cuda")
    mem0 = torch.cuda.memory_allocated()
    placed = SH.placed_copy(model, ctx)
    placed_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
    by_path = {}
    for chunk in chunks:
        runs, out = {}, {}
        admission = "one-shot" if chunk is None else f"chunks of {chunk}"
        for name, c in (("unsharded", NULL_CTX), ("mesh", ctx)):
            _free_card()
            t0 = time.perf_counter()

            def build(c=c):
                return recording(
                    cfg, placed if c.enabled else model,
                    max_batch=size["max_batch"], max_len=size["max_len"],
                    page_size=size["page_size"], prefill_chunk=chunk, ctx=c,
                    device="cuda")
            if c.enabled and cfg.moe is not None:
                eng, all_reduces = _capture_collectives(build)
            else:
                eng, all_reduces = build(), 0
            build_s = time.perf_counter() - t0
            requests = serve.make_requests(cfg, n_req, max_new, "full",
                                           seed=0)
            _zero_counts()
            report = serve.serve([eng], requests)
            launches = _path_counts()
            events = report["events"][0]
            prefills = [dt for kind, _, dt in events if kind == "prefill"]
            steps = [dt for kind, _, dt in events if kind == "decode"]
            calls = sum(1 if chunk is None else math.ceil(r.prompt_len / chunk)
                        for r in eng.completed)
            attn = n["kv"] + n["win"]
            # the mesh engine's prefill and ring decode run no paged or
            # fused kernel
            want = {"flash_attention": attn * calls, "ssd": n["ssm"] * calls,
                    "paged_attention": 0 if c.enabled else attn * len(steps),
                    **{k: 0 if c.enabled else m for k, m in
                       fused_counts(cfg, len(steps), calls).items()}}
            runs[name] = {
                "finished": len(eng.completed), "prefill_calls": calls,
                "decode_steps": len(steps), "graph_replays": eng.graph_replays,
                "capture_s": eng.capture_s, "build_s": build_s,
                "all_reduces_in_warmup_and_capture": all_reduces,
                "launches": launches, "launches_wanted": want,
                "median_ttft_s": statistics.median(prefills),
                "median_tpot_s": statistics.median(steps),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "ok": (len(eng.completed) == n_req
                       and all(len(r.generated) == max_new
                               for r in eng.completed)
                       and launches == want
                       and eng.graph_replays == len(steps) > 0)}
            if c.enabled:
                prof = _replay_profile(eng._graph.replay)
                runs[name]["replay_busy_ms"] = sum(r[0] for r in prof)
                runs[name]["replay_top_kernels"] = prof[:8]
                # at world size 1 NCCL runs an average as its one-rank
                # kernel (``onerank.cu``) and a sum as a copy
                runs[name]["replay_nccl_kernels"] = [
                    r for r in prof if "onerank" in r[2] or "nccl" in r[2]]
            if chunk is None:
                mid = sorted(eng.completed, key=lambda r: r.prompt_len)[
                    len(eng.completed) // 2]
                runs[name]["admission_trace"] = _admission_trace(
                    eng, mid.tokens[:mid.prompt_len])
            out[name] = ({r.rid: r for r in eng.completed}, eng.picks)
            by_path[f"{arch} {dtype_name} {name} engine (7c), "
                    f"{admission}"] = launches
            del eng
        rids = sorted(out["mesh"][0])
        reqs = {k: [o[0][r] for r in rids] for k, o in out.items()}
        tokens = {k: [r.generated for r in v] for k, v in reqs.items()}
        logits = {k: [o[1][r] for r in rids] for k, o in out.items()}
        top2 = {k: [_top2_rows(torch.stack(row)) for row in v]
                for k, v in logits.items()}
        cmp = _compare_tokens(tokens["mesh"], top2["mesh"],
                              tokens["unsharded"], top2["unsharded"])
        # the unsharded ring path fed each engine's own tokens: the mesh
        # engine is held to it pick by pick, and the paged engine read
        # against it (the control: B1 against the ring's ``_sdpa``, no mesh)
        _free_card()
        ref = {k: _ring_reference(model, v, chunk, size["max_batch"],
                                  size["max_len"]) for k, v in reqs.items()}
        held = _held_pick_by_pick(tokens["mesh"], top2["mesh"], ref["mesh"])
        control = _held_pick_by_pick(tokens["unsharded"], top2["unsharded"],
                                     ref["unsharded"])
        diffs = {"mesh_vs_unsharded": _logit_diff(
                     tokens["mesh"], logits["mesh"], tokens["unsharded"],
                     logits["unsharded"]),
                 "mesh_vs_ring_reference": _logit_diff(
                     tokens["mesh"], logits["mesh"], tokens["mesh"],
                     ref["mesh"]),
                 "unsharded_vs_ring_reference": _logit_diff(
                     tokens["unsharded"], logits["unsharded"],
                     tokens["unsharded"], ref["unsharded"])}
        # a pick of the mesh's that differs from the paged engine's outside
        # a near tie is on the history both shared up to it, so the ring
        # path fed the paged engine's tokens must pick it too: the
        # difference is then the ring path's own, not the mesh's
        unexplained = [
            m for m in cmp["mismatches"]
            if int(ref["unsharded"][m["row"]][m["step"]].float().argmax())
            != tokens["mesh"][m["row"]][m["step"]]]
        del out, logits, ref
        # per MoE layer and step: the expert and shared-expert sums over the
        # model axis and aux's mean over the data axis
        n_moe = sum(b.ffn == "moe" for b in cfg.layer_list())
        want_ar = n_moe * 3 * (WARMUP_STEPS + 1)
        res = {"phase": "engine_under_mesh", "config": cfg.name,
               "dtype": dtype_name,
               "mesh": dict(zip(ctx.mesh.mesh_dim_names,
                                ctx.mesh.mesh.shape)),
               "backend": torch.distributed.get_backend(),
               "admission": admission, "requests": n_req,
               "max_new_tokens": max_new, "max_batch": size["max_batch"],
               "max_len": size["max_len"], "placed_copy_gb": placed_gb,
               **eager, "near_tie_ulps": NEAR_TIE_ULPS,
               "against_ring_reference": held,
               "against_unsharded_engine": {
                   **cmp, "mismatches_not_the_ring_paths": unexplained},
               "control_unsharded_against_ring_reference": control,
               "logit_diff_spacings": diffs,
               "all_reduces_wanted": want_ar, "runs": runs,
               "nvidia_smi": card}
        emit(res)
        if not (all(r["ok"] for r in runs.values())
                and not held["mismatches"]
                and diffs["mesh_vs_ring_reference"]["max"] <= NEAR_TIE_ULPS
                and diffs["unsharded_vs_ring_reference"]["max"]
                <= CONTROL_SPACINGS
                and not unexplained
                and runs["mesh"]["all_reduces_in_warmup_and_capture"]
                == want_ar
                and bool(runs["mesh"]["replay_nccl_kernels"]) == bool(n_moe)):
            raise AssertionError(f"engine under the mesh failed: {res}")
    del model, placed
    _free_card()
    return by_path


def sharded_phase(card: str) -> dict:
    """(b) The sharded path on the card: a 1 x 1 (data, model) mesh over
    NCCL at world size 1 (one card holds one NCCL rank), each run held to
    the unsharded function on the same card; then (c) the engine under the
    same mesh (``MESH_ENGINES``).  Returns each path's launches."""
    import torch.distributed as dist
    from repro_torch.launch import sharded as SH
    SH.start_world(device="cuda")
    ctx = SH.mesh_ctx(1, 1, device="cuda")
    by_path = {}
    none = {n: 0 for n in wrappers()}
    # llama3.1-8b: B2 once per layer; then the ring decode against the
    # engine's decode step (B1 over pages) from the unsharded prefill
    model, logits, states, counts, (paged, paged_logits) = _sharded_prefill(
        "llama3.1-8b", ctx, card, {**none, "flash_attention": 32},
        before=_paged_decode)
    by_path["llama3.1-8b sharded prefill"] = counts
    ring, ring_logits, wall, counts = _ring_decode(model, ctx, logits, states)
    res = {"phase": "sharded_ring_decode", "config": model.cfg.name,
           "steps": SHARD_STEPS, "batch": SHARD_B, "wall_s": wall,
           "launches": counts, "near_tie_ulps": NEAR_TIE_ULPS,
           **_compare_tokens(ring.tolist(), _by_row(ring_logits),
                             paged.tolist(), _by_row(paged_logits)),
           "nvidia_smi": card}
    emit(res)
    if res["mismatches"] or any(counts.values()):
        raise AssertionError(f"ring decode disagrees with B1's: {res}")
    by_path["llama3.1-8b sharded ring decode"] = counts
    # (c) puts its TPOT beside this eager step, whose ring is shorter
    eager = {"eager_ring_step_s": wall / SHARD_STEPS,
             "eager_ring_rows": SHARD_L + SHARD_STEPS,
             "eager_ring_batch": SHARD_B}
    del model, logits, states, paged_logits, ring_logits
    # mamba2-1.3b: B3 once per layer
    by_path["mamba2-1.3b sharded prefill"] = _sharded_prefill(
        "mamba2-1.3b", ctx, card, {**none, "ssd": 48})[3]
    # deepseek-v2-lite-16b whole: MLA (no kernel) and the MoE local_map
    # branch, an NCCL all-reduce at world size 1
    by_path["deepseek-v2-lite-16b sharded prefill"] = _sharded_prefill(
        "deepseek-v2-lite-16b", ctx, card, none)[3]
    by_path["minicpm-2b sharded train step"] = _sharded_train(ctx, card)
    for arch, dtype_name, n_req, chunks in MESH_ENGINES:
        by_path.update(engine_under_mesh(arch, dtype_name, n_req, chunks,
                                         ctx, card, eager))
    dist.destroy_process_group()
    _free_card()
    return by_path


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
    t_start = t0 = time.perf_counter()
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
    # gemma3-12b's prefill route (128 O accumulators a consumer thread),
    # the fp32 route at the served head dims, and the paged kernel's bf16
    # pass 1, whose softcap branch must not spill (hd 256: a 64 x 256 fp32
    # output fragment a warp)
    for lib, kernel, args in (
            ("flash_attention", "flash_wgmma_kernel", (256,)),
            ("flash_attention", "flash_tf32x3_kernel", (64,)),
            ("flash_attention", "flash_tf32x3_kernel", (128,)),
            ("paged_attention", "paged_split_mma_kernel", (128,)),
            ("paged_attention", "paged_split_mma_kernel", (256,))):
        mangled = kernel + "I" + "".join(f"Li{a}E" for a in args)
        name = f"{kernel}<{', '.join(map(str, args))}>"
        report = ptxas_report(logs[lib], mangled)
        emit({"phase": "ptxas", "kernel": name, "report": report,
              "sass_top_register": sass_top_register(lib, mangled)})
        spills = [int(n) for ln in report for n in
                  re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)]
        if not spills or any(spills) or any(
                c in ln for ln in report for c in ("C7512", "C7518")):
            raise AssertionError(f"{name} spills or serialises its "
                                 f"wgmma: {report}")

    cases = check_kernels()
    check_decode_fused(cases, card)
    check_prefill_fused(cases, card)
    for arch in REDUCED_ARCHS:
        check_reduced(arch)
    launches, by_path = {}, {}
    for arch, max_batch, periods, dtype_name in SERVED:
        ran = serve_full_width(arch, card, max_batch, periods, dtype_name)
        if arch in ("llama3.1-8b", "mamba2-1.3b") and dtype_name is None:
            for n in path_kernels(get_config(arch)):
                launches.setdefault(n, ran[n])
        cut = "" if periods is None else f" ({periods} periods)"
        by_path[f"{arch}{cut}{' ' + dtype_name if dtype_name else ''} "
                f"serve"] = ran
    by_path.update(serve_variant(card))
    prof, by_path["goodput profile (llama3.1-8b)"] = goodput_profile()
    pred = goodput_predictor()
    goodput_runs(pred, prof)
    goodput_policies(pred, prof)
    t6 = time.perf_counter()
    by_path["minicpm-2b train eval"] = train_phase(card)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t6})
    t7 = time.perf_counter()
    dryrun_phase()
    by_path.update(sharded_phase(card))
    emit({"phase": "phase7_done", "seconds": time.perf_counter() - t7})

    def line(name, route, source, replaces, row, launched=None):
        at_models = {r["model"]: {k: r[k] for k in ("ms", "bound_ms",
                                                     "bound_by", "plain_ms",
                                                     "library_ms")}
                     for r in cases["model_rows"]
                     if r["name"] == name and r["dtype"] == row["dtype"]}
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": launches[name] if launched is None else launched,
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "cuda_kernel": row.get("route"),
                "bound_fma_ms": row.get("bound_fma_ms"),
                "at": {k: row[k] for k in row if k in
                       ("B", "L", "Lq", "Lk", "dtype", "ctx_sum",
                        "ctx_max")},
                "at_model_rows": at_models,
                "at_softcap_rows": {
                    f"{r['model']} {r['dtype']}": {k: r.get(k) for k in (
                        "ms", "ms_uncapped", "bound_ms", "bound_by",
                        "plain_ms", "library_ms", "max_abs_err", "softcap")}
                    for r in cases["softcap_rows"] if r["name"] == name}}
    paged = next(r for r in cases["paged_attention"]
                 if r["dtype"] == "bfloat16" and r["B"] == 8)
    flash = next(r for r in cases["flash_attention"]
                 if r["dtype"] == "bfloat16" and r["Lq"] == 2000)
    flash32 = next(r for r in cases["flash_attention"]
                   if r["dtype"] == "float32" and r["Lq"] == 2000)
    flash_src = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu")
    flash_tpu = "src/repro/kernels/flash_attention/flash_attention.py:23"
    scan = next(r for r in cases["ssd"]
                if r["dtype"] == "bfloat16" and r["L"] == 2048)
    emit({"kernels": [
        line("paged_attention", "cuda",
             "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention/paged_attention.py:33", paged),
        line("flash_attention", "cuda", flash_src, flash_tpu, flash),
        # the fp32 route: its launches are the fp32 llama3.1-8b serve's
        dict(line("flash_attention", "cuda", flash_src, flash_tpu, flash32,
                  by_path["llama3.1-8b float32 serve"]["flash_attention"]),
             name="flash_attention_fp32"),
        line("ssd", "cuda", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/ssd.py:20", scan),
        *(line(name, "cuda", "src/repro_torch/kernels/decode_fused/csrc/"
               "decode_fused.cu", "none: XLA fuses this glue in the JAX step",
               next(r for r in cases["fused_rows"] if r["name"] == name))
          for name in ("add_rms_norm", "rope_kv_write", "act_mul")),
        line("rope_kv_prefill", "cuda", "src/repro_torch/kernels/"
             "decode_fused/csrc/decode_fused.cu",
             "none: XLA fuses this glue in the JAX prefill",
             next(r for r in cases["prefill_rows"]
                  if r["name"] == "rope_kv_prefill")),
    ], "decode_replays": cases["replays"],
        "prefill_calls": cases["prefill_calls"], "not_ported": [],
        "smoke_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
