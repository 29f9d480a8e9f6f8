"""Plain reference of DeepSeek-V2 (arXiv:2405.04434) as its configuration
file states it: multi-head latent attention without a query LoRA (the
keys and values expanded from the normed latent ``c_kv``, a shared rotary
key), a dense SiLU-gated MLP in the first ``first_k_dense_replace`` layers,
then softmax-routed experts (top ``num_experts_per_tok``, renormalised
where ``norm_topk_prob``) beside ``n_shared_experts`` shared ones, with the
file's ``capacity_factor`` dropping a prompt's (token, expert) pairs past
an expert's capacity.  The rotary halves are paired (i, i + d/2), a fixed
permutation of the published interleaved pairs: with drawn weights the two
are the same model.  Float32, every sequence's tokens together through the
weight products, one sequence at a time through attention."""
from __future__ import annotations

import copy
import math

import torch

from reference import common as C


def leaves(conf, vocab_rows: int):
    """(program parameter name, shape, init std, kind), as
    ``dense_decoder.leaves``; the router comes in float32, the type the
    port holds it in."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    r, rope = conf["kv_lora_rank"], conf["qk_rope_head_dim"]
    nope, vd = conf["qk_nope_head_dim"], conf["v_head_dim"]
    E, f = conf["n_routed_experts"], conf["moe_intermediate_size"]
    fs = f * conf["n_shared_experts"]
    ff = conf["intermediate_size"]
    out = [("top.embed", (vocab_rows, d), d ** -0.5, "embed"),
           ("top.final_norm", (d,), 0.1, "norm")]
    if not conf["tie_word_embeddings"]:
        out.append(("top.lm_head", (d, vocab_rows), d ** -0.5, "head"))
    for i in range(conf["num_hidden_layers"]):
        a, m = f"layers.{i}.attn.", f"layers.{i}.ffn."
        out += [(a + "ln", (d,), 0.1, "norm"),
                (a + "wq", (d, H * (nope + rope)), d ** -0.5, "weight"),
                (a + "w_dkv", (d, r + rope), d ** -0.5, "weight"),
                (a + "kv_norm", (r,), 0.1, "norm"),
                (a + "w_uk", (r, H * nope), r ** -0.5, "weight"),
                (a + "w_uv", (r, H * vd), r ** -0.5, "weight"),
                (a + "wo", (H * vd, d), (H * vd) ** -0.5, "weight"),
                (m + "ln", (d,), 0.1, "norm")]
        if i < conf["first_k_dense_replace"]:
            out += [(m + "w_gate", (d, ff), d ** -0.5, "weight"),
                    (m + "w_up", (d, ff), d ** -0.5, "weight"),
                    (m + "w_down", (ff, d), ff ** -0.5, "weight")]
        else:
            out += [(m + "router", (d, E), d ** -0.5, "router"),
                    (m + "w_gate", (E, d, f), d ** -0.5, "weight"),
                    (m + "w_up", (E, d, f), d ** -0.5, "weight"),
                    (m + "w_down", (E, f, d), f ** -0.5, "weight"),
                    (m + "shared_w_gate", (d, fs), d ** -0.5, "weight"),
                    (m + "shared_w_up", (d, fs), d ** -0.5, "weight"),
                    (m + "shared_w_down", (fs, d), fs ** -0.5, "weight")]
    return out


def reduced(conf):
    """``conf`` at a size the CPU tests hold: the same architecture (a
    dense layer, then MoE layers) at small widths, the reference's keys
    and the port's section cut alike."""
    c = copy.deepcopy(conf)
    c["port"].update(d_model=64, num_heads=4, num_kv_heads=4, head_dim=48,
                     d_ff=128, vocab_size=256, num_layers=3,
                     layers=[{"mixer": "mla", "ffn": "dense", "repeat": 1},
                             {"mixer": "mla", "ffn": "moe", "repeat": 2}],
                     moe=dict(num_experts=8, top_k=2, d_ff_expert=32,
                              num_shared=2, d_ff_shared=64,
                              capacity_factor=2.0),
                     mla=dict(kv_lora_rank=32, rope_head_dim=16,
                              nope_head_dim=32, v_head_dim=32))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=128, vocab_size=256, num_hidden_layers=3,
             n_routed_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=32, n_shared_experts=2,
             kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
             v_head_dim=32)
    return c


def capacity(T: int, K: int, E: int, cf: float) -> int:
    """An expert's slots when T tokens route together."""
    return int(min(T * K, max(math.ceil(T * K * cf / E), 16)))


def route(conf, h, router, groups):
    """Top-k experts and their weights for the tokens h [N, d], and which
    (token, choice) pairs each expert keeps: an expert keeps the first
    ``capacity`` pairs of a group in token-major order.  ``groups``: the
    (start, end) rows routed together (rows in no group drop nothing)."""
    K, E = conf["num_experts_per_tok"], conf["n_routed_experts"]
    probs = torch.softmax(h @ router.float(), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    if conf["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    w = w * conf["routed_scaling_factor"]
    keep = torch.ones_like(idx, dtype=torch.bool)
    for s, e in groups:
        cap = capacity(e - s, K, E, conf["capacity_factor"])
        hit = torch.nn.functional.one_hot(idx[s:e].reshape(-1), E)  # [T*K, E]
        rank = torch.cumsum(hit, dim=0) * hit
        keep[s:e] = (rank.sum(dim=-1) <= cap).view(e - s, K)
    return w, idx, keep


def moe(arith: C.Arith, conf, W, pre, h, groups):
    """Routed experts plus the shared ones; returns (y, dropped pairs)."""
    w, idx, keep = route(conf, h, W[pre + "router"], groups)
    y = C.gated_mlp(arith, h, arith.weight(W[pre + "shared_w_gate"]),
                    arith.weight(W[pre + "shared_w_up"]),
                    arith.weight(W[pre + "shared_w_down"]))
    wg, wu, wd = (arith.weight(W[pre + n]) for n in ("w_gate", "w_up",
                                                      "w_down"))
    for e in range(conf["n_routed_experts"]):
        t, k = torch.nonzero((idx == e) & keep, as_tuple=True)
        if len(t):
            y.index_add_(0, t, w[t, k, None]
                         * C.gated_mlp(arith, h[t], wg[e], wu[e], wd[e]))
    return y, int((~keep).sum())


def logits(conf, W, seqs, arith: C.Arith, stats: dict | None = None):
    """Logits at positions ``first .. len - 1`` of each (tokens, first):
    the prompt is ``tokens[:first + 1]``, routed as one group; each later
    token is decoded alone.  ``stats["dropped"]`` counts dropped pairs."""
    C.no_tf32()
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    r, rope = conf["kv_lora_rank"], conf["qk_rope_head_dim"]
    nope, vd = conf["qk_nope_head_dim"], conf["v_head_dim"]
    V, eps = conf["vocab_size"], conf["rms_norm_eps"]
    theta = conf["rope_theta"]
    # YaRN at factor 1 interpolates no frequency and scales no softmax.
    assert (conf["rope_scaling"] or {}).get("factor", 1) == 1
    dev = W["top.embed"].device
    toks = [torch.tensor(t, device=dev) for t, _ in seqs]
    cuts = [0]
    for t in toks:
        cuts.append(cuts[-1] + len(t))
    groups = [(cuts[s], cuts[s] + first + 1) for s, (_, first) in enumerate(seqs)]
    x = arith.weight(W["top.embed"][:V].T).T[torch.cat(toks)]
    pos = [torch.arange(len(t), device=dev) for t in toks]
    scale = (nope + rope) ** -0.5
    dropped = 0
    for i in range(conf["num_hidden_layers"]):
        a, m = f"layers.{i}.attn.", f"layers.{i}.ffn."
        h = C.rms_norm(x, W[a + "ln"], eps)
        q = arith.mm(h, arith.weight(W[a + "wq"])).view(-1, H, nope + rope)
        ckv = arith.mm(h, arith.weight(W[a + "w_dkv"]))
        c = C.rms_norm(ckv[:, :r], W[a + "kv_norm"], eps)
        k_nope = arith.mm(c, arith.weight(W[a + "w_uk"])).view(-1, H, nope)
        v = arith.mm(c, arith.weight(W[a + "w_uv"])).view(-1, H, vd)
        att = []
        for s, p in enumerate(pos):
            sl = slice(cuts[s], cuts[s + 1])
            qs = torch.cat([q[sl, :, :nope],
                            C.rope(q[sl, :, nope:], p, theta)], dim=-1)
            kr = C.rope(ckv[sl, None, r:], p, theta).expand(-1, H, -1)
            ks = torch.cat([k_nope[sl], kr], dim=-1)
            att.append(C.causal_attention(qs, ks, v[sl], scale))
        x = x + arith.mm(torch.cat(att), arith.weight(W[a + "wo"]))
        h = C.rms_norm(x, W[m + "ln"], eps)
        if i < conf["first_k_dense_replace"]:
            x = x + C.gated_mlp(arith, h, arith.weight(W[m + "w_gate"]),
                                arith.weight(W[m + "w_up"]),
                                arith.weight(W[m + "w_down"]))
        else:
            y, n = moe(arith, conf, W, m, h, groups)
            x, dropped = x + y, dropped + n
    if stats is not None:
        stats["dropped"] = dropped
    rows = torch.cat([torch.arange(cuts[s] + first, cuts[s + 1], device=dev)
                      for s, (_, first) in enumerate(seqs)])
    h = C.rms_norm(x[rows], W["top.final_norm"], eps)
    head = arith.weight(W["top.lm_head"][:, :V])
    out = torch.cat([arith.mm(h[j:j + 1024], head)
                     for j in range(0, len(rows), 1024)])
    sizes = [cuts[s + 1] - cuts[s] - first for s, (_, first) in enumerate(seqs)]
    return list(out.split(sizes))
