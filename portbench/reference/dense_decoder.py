"""Plain reference of a dense decoder of the Llama family as MiniCPM
publishes it (arXiv:2404.06395): RMSNorm, grouped-query attention with
rotary embedding, a SiLU-gated MLP, MiniCPM's three muP scalings
(``scale_emb``, ``scale_depth``, ``dim_model_base``) and tied or untied
embeddings.  Float32, one sequence at a time through attention, every
sequence's tokens together through the weight products, layer by layer."""
from __future__ import annotations

import copy
import math

import torch

from reference import common as C


def leaves(conf, vocab_rows: int):
    """The weights the benchmark draws, by the program's parameter names:
    (name, shape, init std, kind); ``kind`` "norm" is drawn as an offset
    from 1, "embed"/"head" have ``vocab_rows`` rows (columns) of which
    those past ``vocab_size`` are zero."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    KV, hd = conf["num_key_value_heads"], C.head_dim(conf)
    ff = conf["intermediate_size"]
    out = [("top.embed", (vocab_rows, d), d ** -0.5, "embed"),
           ("top.final_norm", (d,), 0.1, "norm")]
    if not conf["tie_word_embeddings"]:
        out.append(("top.lm_head", (d, vocab_rows), d ** -0.5, "head"))
    for i in range(conf["num_hidden_layers"]):
        a, f = f"layers.{i}.attn.", f"layers.{i}.ffn."
        out += [(a + "ln", (d,), 0.1, "norm"),
                (a + "wq", (d, H * hd), d ** -0.5, "weight"),
                (a + "wk", (d, KV * hd), d ** -0.5, "weight"),
                (a + "wv", (d, KV * hd), d ** -0.5, "weight"),
                (a + "wo", (H * hd, d), (H * hd) ** -0.5, "weight"),
                (f + "ln", (d,), 0.1, "norm"),
                (f + "w_gate", (d, ff), d ** -0.5, "weight"),
                (f + "w_up", (d, ff), d ** -0.5, "weight"),
                (f + "w_down", (ff, d), ff ** -0.5, "weight")]
    return out


def reduced(conf):
    """``conf`` at a size the CPU tests hold: the same architecture at
    small widths, the reference's keys and the port's section cut alike."""
    c = copy.deepcopy(conf)
    c["port"].update(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                     d_ff=128, vocab_size=250, num_layers=2,
                     layers=[{"mixer": "full", "ffn": "dense", "repeat": 2}])
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             intermediate_size=128, vocab_size=250, num_hidden_layers=2,
             dim_model_base=64, scale_depth=2 ** 0.5)
    return c


def logits(conf, W, seqs, arith: C.Arith, stats: dict | None = None):
    """Logits over the vocabulary at positions ``first .. len - 1`` of
    each (tokens, first) in ``seqs``: a list of float32 [len - first, V].
    ``stats`` is left as it is: a dense model drops nothing."""
    C.no_tf32()
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    KV, hd = conf["num_key_value_heads"], C.head_dim(conf)
    V, eps, L = conf["vocab_size"], conf["rms_norm_eps"], conf["num_hidden_layers"]
    dev = W["top.embed"].device
    toks = [torch.tensor(t, device=dev) for t, _ in seqs]
    cuts = [0]
    for t in toks:
        cuts.append(cuts[-1] + len(t))
    emb = arith.weight(W["top.embed"][:V].T).T          # [V, d]
    x = emb[torch.cat(toks)] * conf["scale_emb"]
    res = conf["scale_depth"] / math.sqrt(L)
    pos = [torch.arange(len(t), device=dev) for t in toks]
    for i in range(L):
        a, f = f"layers.{i}.attn.", f"layers.{i}.ffn."
        h = C.rms_norm(x, W[a + "ln"], eps)
        q = arith.mm(h, arith.weight(W[a + "wq"])).view(-1, H, hd)
        k = arith.mm(h, arith.weight(W[a + "wk"])).view(-1, KV, hd)
        v = arith.mm(h, arith.weight(W[a + "wv"])).view(-1, KV, hd)
        att = []
        for s, p in enumerate(pos):
            sl = slice(cuts[s], cuts[s + 1])
            qs = C.rope(q[sl], p, conf["rope_theta"])
            ks = C.rope(k[sl], p, conf["rope_theta"])
            rep = H // KV
            att.append(C.causal_attention(
                qs, ks.repeat_interleave(rep, dim=1),
                v[sl].repeat_interleave(rep, dim=1), hd ** -0.5))
        x = x + res * arith.mm(torch.cat(att), arith.weight(W[a + "wo"]))
        h = C.rms_norm(x, W[f + "ln"], eps)
        x = x + res * C.gated_mlp(arith, h, arith.weight(W[f + "w_gate"]),
                                  arith.weight(W[f + "w_up"]),
                                  arith.weight(W[f + "w_down"]))
    rows = torch.cat([torch.arange(cuts[s] + first, cuts[s + 1], device=dev)
                      for s, (_, first) in enumerate(seqs)])
    h = C.rms_norm(x[rows], W["top.final_norm"], eps)
    h = h / (d / conf["dim_model_base"])
    head = (emb.T if conf["tie_word_embeddings"]
            else arith.weight(W["top.lm_head"][:, :V]))
    out = torch.cat([arith.mm(h[r:r + 1024], head)
                     for r in range(0, len(rows), 1024)])
    sizes = [cuts[s + 1] - cuts[s] - first for s, (_, first) in enumerate(seqs)]
    return list(out.split(sizes))
