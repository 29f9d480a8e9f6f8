"""The port's sharded path against its unsharded one, over gloo on the CPU.

One ``torch.multiprocessing.spawn`` per world size (2 ranks: meshes 1x2 and
2x1 of (data, model); 4 ranks: 2x2), each rank on one torch thread.  In
every mesh, for reduced llama3.1-8b (GQA, one KV head), gemma3-27b (window
layers), deepseek-v2-lite-16b (MLA and the MoE ``local_map`` branch) and
mamba2-1.3b (the SSD scan under ``local_map``), reduced llama3.1-8b with 3 query
heads (heads that divide no model axis) and reduced minicpm-2b (KV heads
that divide it: the ring decode under ``local_map``), each rank runs the
model
unsharded and sharded from the same weights (seed 0):

* ``prefill`` logits of 4 x 32 tokens;
* 4 ``ring_decode_step`` logits over the ring cache built from the
  prefill's states (``to_ring_cache``), the same greedy tokens fed to both;
* one fp32 ``make_train_step`` (``cast_half`` the identity; FSDP specs):
  the loss and every updated leaf;
* ``chunk`` (the configs of full and window layers only): 3 chunks of 8
  of the 4 prompts through ``prefill_chunk(ctx=)`` into a staging cache
  placed by ``place_staging``, each chunk's logits and the staging rows;
* ``engine``: ``InferenceEngine(..., ctx=)`` (a placed copy of the
  weights, the ring cache) serving 3 prompts over 2 slots, one-shot and,
  where chunkable, in chunks of 8, against the unsharded engine's greedy
  tokens on the same weights (1.0 where any token differs, else 0.0).

The sharded MoE averages its aux loss over the data shards, as the
reference's ``shard_map`` branch does, so the unsharded oracle of a MoE
train step at more than one data shard takes the batch's NLL plus the
mean of each shard's aux.  Tolerance 1e-5 (fp32): the sharded reductions
sum in another order.
"""
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

ARCHS = ("llama3.1-8b", "gemma3-27b", "deepseek-v2-lite-16b", "mamba2-1.3b",
         "llama-3-heads", "minicpm-2b")
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
B, L, MAX_LEN, STEPS = 4, 32, 48, 4
TOL = 1e-5
WHAT = ("prefill", "decode", "train_loss", "train_leaves", "chunk", "engine")
CHUNK = 8


def _max_diff(a, b) -> float:
    from repro_torch.launch.sharded import full
    return (full(a).float() - b.float()).abs().max().item()


def _unsharded_step(cfg, model, opt, batch, dp):
    """The unsharded train step, the MoE aux averaged over ``dp`` batch
    shards as the sharded step averages it over the data axes."""
    from repro_torch.training import train_step as TTS
    from repro_torch.training.optimizer import AdamWConfig
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=10)
    if cfg.moe is None or dp == 1:
        return TTS.make_train_step(cfg, opt_cfg, ce_chunk=16)(
            model, opt, *batch)[2]["loss"]
    loss_fn = TTS.make_loss_fn(cfg, ce_chunk=16)
    params = TTS._start(model)
    _, m = loss_fn(model, *batch)
    n = B // dp
    auxes = [loss_fn(model, *(t[s * n:(s + 1) * n] for t in batch))[1]
             ["aux_loss"] for s in range(dp)]
    total = m["nll"] + cfg.moe.router_aux_weight * sum(auxes) / dp
    total.backward()
    TTS._update(opt_cfg, params, opt)
    return total.detach()


def _config(arch):
    """Reduced ``arch``; ``llama-3-heads`` is reduced llama3.1-8b with 3
    query heads of 16 over one KV head: heads that divide no model axis
    here, the path minicpm-2b, internvl2-1b and musicgen-medium take at
    tp = 16."""
    import dataclasses
    from repro_torch.configs import get_config, reduce_config
    if arch == "llama-3-heads":
        return dataclasses.replace(reduce_config(get_config("llama3.1-8b")),
                                   num_heads=3, num_kv_heads=1, head_dim=16)
    return reduce_config(get_config(arch))


def _chunkable(cfg) -> bool:
    return {b.mixer for b in cfg.layer_list()} <= {"full", "window"}


def _check_chunks(cfg, base, model, toks, ctx) -> float:
    """Worst gap of ``prefill_chunk(ctx=)``'s logits and staging rows from
    the unsharded run's over 3 chunks of ``CHUNK``."""
    from repro_torch.launch import sharded as SH
    from repro_torch.models import model as M
    n = 3 * CHUNK
    ref = M.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    got = SH.place_staging(M.init_cache(cfg, B, n, dtype=torch.float32,
                                        device="cpu"), cfg, ctx)
    worst = 0.0
    for s in range(0, n, CHUNK):
        chunk = toks[:, s:s + CHUNK]
        ref_l, ref = M.prefill_chunk(base, ref, chunk)
        l, got = M.prefill_chunk(model, got, SH.place_batch(chunk, ctx), ctx)
        worst = max(worst, _max_diff(l, ref_l))
    return max(worst, _max_diff(got["k"], ref["k"]),
               _max_diff(got["v"], ref["v"]))


def _check_engine(cfg, base, toks, ctx) -> float:
    """0.0 where the sharded engine's greedy tokens equal the unsharded
    engine's, one-shot and (chunkable configs) in chunks, else 1.0."""
    from repro_torch.engine.engine import EngineRequest, InferenceEngine
    prompts = [toks[0, :11].tolist(), toks[1, :7].tolist(),
               toks[2, :16].tolist()]
    chunks = (None, CHUNK) if _chunkable(cfg) else (None,)
    for chunk in chunks:
        outs = []
        for c in (None, ctx):
            eng = InferenceEngine(cfg, base, max_batch=2, max_len=MAX_LEN,
                                  prefill_chunk=chunk, device="cpu",
                                  **({"ctx": c} if c else {}))
            for rid, p in enumerate(prompts):
                eng.submit(EngineRequest(rid=rid, tokens=list(p),
                                         prompt_len=len(p), max_new_tokens=4))
            outs.append({r.rid: r.generated for r in eng.run_until_drained()})
        if outs[0] != outs[1] or len(outs[0]) != len(prompts):
            return 1.0
    return 0.0


def _check_arch(arch, ctx, dp):
    import copy
    from unittest import mock
    from repro_torch.launch import sharded as SH
    from repro_torch.models import model as M
    from repro_torch.training import train_step as TTS
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = _config(arch)
    base = M.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=g)
    out = {}
    with torch.no_grad():
        ref_logits, ref_states = M.prefill(base, toks)
        model, _ = SH.place_model(copy.deepcopy(base), ctx, fsdp=True)
        logits, states = M.prefill(model, SH.place_batch(toks, ctx), ctx=ctx)
        out["prefill"] = _max_diff(logits, ref_logits)
        ref_cache = M.to_ring_cache(cfg, ref_states, MAX_LEN, L)
        cache = SH.place_cache(M.to_ring_cache(cfg, states, MAX_LEN, L), cfg,
                               ctx, MAX_LEN)
        nxt, worst = ref_logits.argmax(-1)[:, None], 0.0
        for _ in range(STEPS):
            ref_l, ref_cache = M.ring_decode_step(base, nxt, ref_cache)
            got, cache = M.ring_decode_step(model, SH.place_batch(nxt, ctx),
                                            cache, ctx)
            worst = max(worst, _max_diff(got, ref_l))
            nxt = ref_l.argmax(-1)[:, None]
        out["decode"] = worst
        if _chunkable(cfg):
            out["chunk"] = _check_chunks(cfg, base, model, toks, ctx)
        out["engine"] = _check_engine(cfg, base, toks, ctx)
    labels = torch.randint(0, cfg.vocab_size, (B, L), generator=g)
    mask = (torch.rand((B, L), generator=g) > 0.2).float()
    with mock.patch.object(TTS, "cast_half", lambda p, dtype=None: p):
        ref_model = copy.deepcopy(base)
        ref_opt = init_opt_state(dict(ref_model.named_parameters()))
        ref_loss = _unsharded_step(cfg, ref_model, ref_opt,
                                   (toks, labels, mask), dp)
        model, _ = SH.place_model(copy.deepcopy(base), ctx, fsdp=True)
        opt = init_opt_state(dict(model.named_parameters()))
        step = TTS.make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=10),
                                   ctx, ce_chunk=16)
        _, _, m = step(model, opt, *(SH.place_batch(t, ctx)
                                     for t in (toks, labels, mask)))
    out["train_loss"] = _max_diff(m["loss"], ref_loss)
    ref_p = dict(ref_model.named_parameters())
    out["train_leaves"] = max(_max_diff(p.detach(), ref_p[n].detach())
                              for n, p in model.named_parameters())
    return out


def _worker(rank, world, path, store):
    torch.set_num_threads(1)
    from repro_torch.launch import sharded as SH
    SH.start_world(device="cpu", rank=rank, world_size=world,
                   init_method=f"file://{store}")
    results = {}
    for data, model_ax in MESHES[world]:
        ctx = SH.mesh_ctx(data, model_ax, device="cpu")
        for arch in ARCHS:
            for k, v in _check_arch(arch, ctx, data).items():
                results[f"{data}x{model_ax}/{arch}/{k}"] = v
    if rank == 0:
        with open(path, "w") as f:
            json.dump(results, f)
    torch.distributed.destroy_process_group()


_RUNS = {}


def _results(world: int) -> dict:
    """Spawn ``world`` ranks once and return rank 0's errors by check."""
    if world not in _RUNS:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as d:
            path, store = os.path.join(d, "out.json"), os.path.join(d, "s")
            mp.spawn(_worker, args=(world, path, store), nprocs=world)
            with open(path) as f:
                _RUNS[world] = json.load(f)
    return _RUNS[world]


CASES = [(w, f"{d}x{m}", arch, what) for w, meshes in MESHES.items()
         for d, m in meshes for arch in ARCHS for what in WHAT
         if what != "chunk" or _chunkable(_config(arch))]


@pytest.mark.parametrize("world,mesh,arch,what", CASES)
def test_sharded_matches_unsharded(world, mesh, arch, what):
    err = _results(world)[f"{mesh}/{arch}/{what}"]
    assert err <= TOL, (mesh, arch, what, err)
