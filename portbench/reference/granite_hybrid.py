"""Plain reference of granite-4.0-h (GraniteMoeHybrid) as its
configuration file states it.

Each of ``num_hidden_layers`` layers is a Mamba-2 mixer or a GQA attention
layer (``layer_types``), then routed experts beside a shared expert, each
block behind an RMSNorm and joining the residual times
``residual_multiplier``:

* the embedding times ``embedding_multiplier``;
* a Mamba-2 mixer: the input projection to z, x, B, C and dt (no bias);
  a causal depthwise convolution of width ``mamba_d_conv`` with its bias,
  then SiLU, over x, B and C; dt = softplus(dt + dt_bias); A = -exp(A_log);
  the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t
  + D x_t per head (``mamba_n_groups`` groups of B and C shared by their
  heads); RMSNorm(y * SiLU(z)) over all ``mamba_n_heads * mamba_d_head``
  channels; ``out_proj``;
* or attention with ``num_key_value_heads`` KV heads, no bias and no
  positional encoding (``position_embedding_type`` "nope"; "rope" rotates
  q and k at ``rope_theta``, the halves of each head paired), scores
  scaled by ``attention_multiplier``;
* the top ``num_experts_per_tok`` of ``num_local_experts`` SiLU-gated
  experts by the router's logits, their gates a softmax over the chosen
  logits, plus the shared expert of ``shared_intermediate_size``;
* the final RMSNorm, the tied head, the logits divided by
  ``logits_scaling``.

The recurrence is written here from those equations as a chunked
quadratic form in float32 (within a chunk of ``mamba_chunk_size`` the
decays between every pair of positions, across chunks the carried state),
which equals the sequential scan up to float32 rounding.  Float32
throughout, TF32 off; every sequence's tokens together through the weight
products, one sequence at a time through the convolution, the scan and
attention; weights cast to float32 where they are used and the experts
one at a time, so that the reference fits on the card beside the
program's bf16 weights.

Departures, each as the configuration file's ``departures`` lists them:
RMSNorm weights are stored as their offset from 1 (the port's layout:
x / rms(x) * (1 + w)); a prompt's (token, expert) pairs past an expert's
capacity are dropped by the file's ``capacity_factor`` rule, as the
program's dispatch drops them; positions stop at the serving ``max_len``
(``max_position_embeddings`` cut to 4096), which a NoPE model never
reads."""
from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F

from reference import common as C

DT = 0.01                  # the dt that dt_bias is drawn around
VOCAB_BLOCK = 16384        # head columns a product


def _sizes(conf):
    d = conf["hidden_size"]
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    nh, P = conf["mamba_n_heads"], conf["mamba_d_head"]
    G, N = conf["mamba_n_groups"], conf["mamba_d_state"]
    return d, H, KV, d // H, nh, P, G, N, nh * P, G * N


def _log_spread(n: int):
    """The mean and standard deviation of log(1), ..., log(n)."""
    logs = [math.log(i) for i in range(1, n + 1)]
    mean = sum(logs) / n
    return mean, math.sqrt(sum((v - mean) ** 2 for v in logs) / n)


def leaves(conf, vocab_rows: int):
    """(program parameter name, shape, init std, kind[, mean]): weights at
    fan_in ** -0.5; the tied embedding at 1 / (``embedding_multiplier`` ·
    sqrt(d)), so that a token's own logit through the tied head stands
    about one spread above the others' (at unit scale it would exceed
    them all and every served token would repeat the one before it);
    norms as offsets from 1 (std 0.1);
    conv biases N(0, 0.1); ``A_log`` around log(1..H), ``D`` around 1,
    ``dt_bias`` around softplus^-1(0.01), spread over dt in [0.001, 0.1]
    (the file's ``assumed``)."""
    d, H, KV, hd, nh, P, G, N, di, gn = _sizes(conf)
    K, E = conf["mamba_d_conv"], conf["num_local_experts"]
    f, fs = conf["intermediate_size"], conf["shared_intermediate_size"]
    a_mean, a_std = _log_spread(nh)

    def w(name, shape, fan):
        return (name, shape, fan ** -0.5, "weight")
    out = [("top.embed", (vocab_rows, d),
            1.0 / (conf["embedding_multiplier"] * math.sqrt(d)), "embed"),
           ("top.final_norm", (d,), 0.1, "norm")]
    for i, kind in enumerate(conf["layer_types"]):
        if kind == "mamba":
            m = f"layers.{i}.mixer."
            out += [(m + "ln", (d,), 0.1, "norm"),
                    w(m + "w_z", (d, di), d), w(m + "w_x", (d, di), d),
                    w(m + "w_B", (d, gn), d), w(m + "w_C", (d, gn), d),
                    w(m + "w_dt", (d, nh), d), w(m + "conv_x", (K, di), K),
                    w(m + "conv_B", (K, gn), K), w(m + "conv_C", (K, gn), K),
                    (m + "conv_bx", (di,), 0.1, "bias"),
                    (m + "conv_bB", (gn,), 0.1, "bias"),
                    (m + "conv_bC", (gn,), 0.1, "bias"),
                    (m + "A_log", (nh,), a_std, "scalar", a_mean),
                    (m + "D", (nh,), 0.1, "scalar", 1.0),
                    (m + "dt_bias", (nh,), 1.15, "scalar",
                     math.log(math.expm1(DT))),
                    (m + "gn", (di,), 0.1, "norm"),
                    w(m + "out_proj", (di, d), di)]
        else:
            a = f"layers.{i}.attn."
            out += [(a + "ln", (d,), 0.1, "norm"),
                    w(a + "wq", (d, H * hd), d), w(a + "wk", (d, KV * hd), d),
                    w(a + "wv", (d, KV * hd), d),
                    w(a + "wo", (H * hd, d), H * hd)]
        m = f"layers.{i}.ffn."
        out += [(m + "ln", (d,), 0.1, "norm"),
                (m + "router", (d, E), d ** -0.5, "router"),
                w(m + "w_gate", (E, d, f), d), w(m + "w_up", (E, d, f), d),
                w(m + "w_down", (E, f, d), f),
                w(m + "shared_w_gate", (d, fs), d),
                w(m + "shared_w_up", (d, fs), d),
                w(m + "shared_w_down", (fs, d), fs)]
    return out


def reduced(conf):
    """``conf`` at a size the CPU tests hold: one period of ten layers
    (nine Mamba-2, one attention) at small widths, 8 experts top-2 beside
    the shared one, the muP scalars and NoPE as published; the reference's
    keys and the port's section cut alike."""
    c = copy.deepcopy(conf)
    period = c["layer_types"][:10]
    c["port"].update(
        num_layers=10, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        layers=[{"pattern": [{"mixer": "full" if t == "attention"
                              else "mamba", "ffn": "moe"} for t in period],
                 "repeat": 1}],
        moe=dict(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1,
                 d_ff_shared=64, capacity_factor=2.0),
        ssm=dict(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                 chunk=16))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
             mamba_chunk_size=16, num_local_experts=8, num_experts_per_tok=2,
             intermediate_size=32, shared_intermediate_size=64,
             vocab_size=256, num_hidden_layers=10, layer_types=period)
    return c


def capacity(T: int, K: int, E: int, cf: float) -> int:
    """An expert's slots when T tokens route together."""
    return int(min(T * K, max(math.ceil(T * K * cf / E), 16)))


def route(conf, h, router, groups):
    """The top-k experts of the tokens h [N, d] by the router's logits,
    their gates a softmax over those k logits, and which (token, choice)
    pairs each expert keeps: an expert keeps the first ``capacity`` pairs
    of a group in token-major order.  ``groups``: the (start, end) rows
    routed together (rows in no group drop nothing)."""
    K, E = conf["num_experts_per_tok"], conf["num_local_experts"]
    top, idx = torch.topk(h @ router.float(), K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    keep = torch.ones_like(idx, dtype=torch.bool)
    for s, e in groups:
        cap = capacity(e - s, K, E, conf["capacity_factor"])
        hit = F.one_hot(idx[s:e].reshape(-1), E)              # [T*K, E]
        rank = torch.cumsum(hit, dim=0) * hit
        keep[s:e] = (rank.sum(dim=-1) <= cap).view(e - s, K)
    return gates, idx, keep


def moe(arith: C.Arith, conf, W, pre, h, groups):
    """Routed experts, one at a time, plus the shared one; returns (y,
    dropped pairs)."""
    gates, idx, keep = route(conf, h, W[pre + "router"], groups)
    y = C.gated_mlp(arith, h, arith.weight(W[pre + "shared_w_gate"]),
                    arith.weight(W[pre + "shared_w_up"]),
                    arith.weight(W[pre + "shared_w_down"]))
    for e in range(conf["num_local_experts"]):
        t, k = torch.nonzero((idx == e) & keep, as_tuple=True)
        if len(t):
            y.index_add_(0, t, gates[t, k, None] * C.gated_mlp(
                arith, h[t], *(arith.weight(W[pre + n][e])
                               for n in ("w_gate", "w_up", "w_down"))))
    return y, int((~keep).sum())


def causal_conv(u, w, b):
    """SiLU of the causal depthwise convolution of u [L, C] with w [K, C]
    (w[k] weighs the input K - 1 - k steps back) and its bias b [C]."""
    K, L = w.shape[0], u.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return F.silu(sum(pad[k:k + L] * w[k] for k in range(K)) + b)


def ssd_scan(x, dt, A, B, Cm, chunk: int):
    """The Mamba-2 recurrence of one sequence from zero state, float32:
    x [L, H, P], dt [L, H] (after softplus), A [H] (negative), B and Cm
    [L, G, N], each group's B and C read by H / G consecutive heads.
    Within a chunk y_i = sum_{j <= i} C_i.B_j exp(s_i - s_j) dt_j x_j with
    s the running sum of dt A; the state carried into a chunk adds
    exp(s_i) C_i . h.  Returns y [L, H, P]."""
    L, H, Pd = x.shape
    G, N = B.shape[1], B.shape[2]
    Bh = B.repeat_interleave(H // G, dim=1)                  # [L, H, N]
    Ch = Cm.repeat_interleave(H // G, dim=1)
    h = x.new_zeros((H, Pd, N))
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        xc, dtc, Bc, Cc = x[sl], dt[sl], Bh[sl], Ch[sl]
        Q = xc.shape[0]
        s = torch.cumsum(dtc * A, dim=0)                     # [Q, H]
        diff = s.T[:, :, None] - s.T[:, None, :]             # [H, Q, Q]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("ihn,jhn->hij", Cc, Bc)
        att = cb * decay * dtc.T[:, None, :]
        y = torch.einsum("hij,jhp->ihp", att, xc)
        y = y + torch.einsum("ihn,hpn->ihp", Cc, h) * torch.exp(s)[..., None]
        w_in = torch.exp(s[-1] - s) * dtc                    # [Q, H]
        h = torch.exp(s[-1])[:, None, None] * h + torch.einsum(
            "jh,jhp,jhn->hpn", w_in, xc, Bc)
        ys.append(y)
    return torch.cat(ys)


def mamba(arith: C.Arith, conf, W, pre, h, cuts):
    """The Mamba-2 mixer of the normed input h [N, d], each sequence
    (rows ``cuts[s]:cuts[s + 1]``) convolved and scanned on its own."""
    d, H, KV, hd, nh, P, G, N, di, gn = _sizes(conf)
    eps = conf["rms_norm_eps"]
    z = arith.mm(h, arith.weight(W[pre + "w_z"]))
    xr = arith.mm(h, arith.weight(W[pre + "w_x"]))
    Br = arith.mm(h, arith.weight(W[pre + "w_B"]))
    Cr = arith.mm(h, arith.weight(W[pre + "w_C"]))
    dt = F.softplus(arith.mm(h, arith.weight(W[pre + "w_dt"]))
                    + W[pre + "dt_bias"].float())
    A = -torch.exp(W[pre + "A_log"].float())
    Dh = W[pre + "D"].float()
    convs = [(W[pre + "conv_" + k].float(), W[pre + "conv_b" + k].float())
             for k in ("x", "B", "C")]
    ys = []
    for s in range(len(cuts) - 1):
        sl = slice(cuts[s], cuts[s + 1])
        xs, Bs, Cs = (causal_conv(u[sl], w, b)
                      for u, (w, b) in zip((xr, Br, Cr), convs))
        xs = xs.view(-1, nh, P)
        y = ssd_scan(xs, dt[sl], A, Bs.view(-1, G, N), Cs.view(-1, G, N),
                     conf["mamba_chunk_size"])
        ys.append((y + Dh[:, None] * xs).reshape(-1, di))
    y = C.rms_norm(torch.cat(ys) * F.silu(z), W[pre + "gn"], eps)
    return arith.mm(y, arith.weight(W[pre + "out_proj"]))


def attention(arith: C.Arith, conf, W, pre, h, cuts):
    """GQA of the normed input h [N, d], one sequence at a time, rotated
    only where ``position_embedding_type`` is "rope"."""
    d, H, KV, hd, *_ = _sizes(conf)
    q = arith.mm(h, arith.weight(W[pre + "wq"])).view(-1, H, hd)
    k = arith.mm(h, arith.weight(W[pre + "wk"])).view(-1, KV, hd)
    v = arith.mm(h, arith.weight(W[pre + "wv"])).view(-1, KV, hd)
    k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    out = []
    for a, b in zip(cuts, cuts[1:]):
        qs, ks = q[a:b], k[a:b]
        if conf["position_embedding_type"] == "rope":
            pos = torch.arange(b - a, device=h.device)
            qs, ks = (C.rope(t, pos, conf["rope_theta"]) for t in (qs, ks))
        out.append(C.causal_attention(qs, ks, v[a:b],
                                      conf["attention_multiplier"]))
    return arith.mm(torch.cat(out), arith.weight(W[pre + "wo"]))


def logits(conf, W, seqs, arith: C.Arith, stats: dict | None = None):
    """Logits at positions ``first .. len - 1`` of each (tokens, first):
    the prompt is ``tokens[:first + 1]``, routed as one group; each later
    token is decoded alone.  ``stats["dropped"]`` counts dropped pairs."""
    C.no_tf32()
    V, eps = conf["vocab_size"], conf["rms_norm_eps"]
    alpha = conf["residual_multiplier"]
    dev = W["top.embed"].device
    toks = [torch.tensor(t, device=dev) for t, _ in seqs]
    cuts = [0]
    for t in toks:
        cuts.append(cuts[-1] + len(t))
    groups = [(cuts[s], cuts[s] + first + 1)
              for s, (_, first) in enumerate(seqs)]
    x = arith.weight(W["top.embed"][torch.cat(toks)].T).T \
        * conf["embedding_multiplier"]
    dropped = 0
    for i, kind in enumerate(conf["layer_types"]):
        if kind == "mamba":
            pre = f"layers.{i}.mixer."
            y = mamba(arith, conf, W, pre, C.rms_norm(x, W[pre + "ln"], eps),
                      cuts)
        else:
            pre = f"layers.{i}.attn."
            y = attention(arith, conf, W, pre,
                          C.rms_norm(x, W[pre + "ln"], eps), cuts)
        x = x + alpha * y
        pre = f"layers.{i}.ffn."
        y, n = moe(arith, conf, W, pre, C.rms_norm(x, W[pre + "ln"], eps),
                   groups)
        x, dropped = x + alpha * y, dropped + n
    if stats is not None:
        stats["dropped"] = dropped
    rows = torch.cat([torch.arange(cuts[s] + first, cuts[s + 1], device=dev)
                      for s, (_, first) in enumerate(seqs)])
    h = C.rms_norm(x[rows], W["top.final_norm"], eps)
    head = W["top.embed"]
    out = torch.cat([arith.mm(h, arith.weight(head[v0:min(v0 + VOCAB_BLOCK,
                                                           V)].T))
                     for v0 in range(0, V, VOCAB_BLOCK)], dim=1)
    out = out / conf["logits_scaling"]
    sizes = [cuts[s + 1] - cuts[s] - first for s, (_, first) in enumerate(seqs)]
    return list(out.split(sizes))
