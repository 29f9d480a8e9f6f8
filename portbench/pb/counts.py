"""Operations and bytes, counted from a configuration's sizes and the
shapes a run served: the yardstick of the roofline and MFU metrics.

Peaks are the published ones of one NVIDIA H100 SXM (dense bf16 on the
tensor cores, HBM3).  Flops count a multiply-add as two."""
from __future__ import annotations

import dataclasses

from pb import spec

PEAK_FLOPS = 989e12           # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bytes a second
MIXERS = ("full", "window", "mla", "mamba")
FFNS = ("dense", "moe", "none")
F32 = 4                       # bytes of a float32 (a Mamba state, dt, y)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _pairs(n: int, window) -> int:
    """Causal (query, key) pairs of ``n`` tokens, each query seeing at
    most ``window`` keys (itself included) where a window is given."""
    if not window or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


@dataclasses.dataclass(frozen=True)
class Counts:
    """Per-token and per-layer sizes of a configuration's ``port`` section.

    A ``mamba`` layer (Mamba-2, ``ssm``: ``d_state`` N, ``head_dim`` P,
    ``n_groups`` G, ``expand``, ``d_conv`` K, ``chunk``; di = expand · d
    inner channels in H = di / P heads) holds the z, x, B, C and dt
    projections, d · (2·di + 2·G·N + H), the depthwise conv, K · (di +
    2·G·N), and ``out_proj``, di · d; it keeps no KV and attends over no
    pairs, and scans instead (``ssd_call``, ``mamba_step``)."""
    d: int
    vocab: int
    layers: tuple             # (mixer, ffn, window) per layer
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    moe: dict | None
    mla: dict | None
    tie: bool
    ssm: dict | None = None
    prefix: bool = False      # a frontend's d x d prefix projection
    dtype_bytes: int = 2

    @classmethod
    def of(cls, conf: dict) -> "Counts":
        p = conf["port"]
        layers = tuple((b["mixer"], b["ffn"], b.get("window"))
                       for pattern, repeat in spec.stages(p)
                       for _ in range(repeat) for b in pattern)
        for mx, ff, _ in layers:
            if mx not in MIXERS or ff not in FFNS:
                raise ValueError(f"no count for a layer of mixer {mx!r}, "
                                 f"ffn {ff!r}")
        return cls(p["d_model"], p["vocab_size"], layers, p["num_heads"],
                   p["num_kv_heads"], p["head_dim"], p["d_ff"],
                   p.get("moe"), p.get("mla"), p["tie_embeddings"],
                   p.get("ssm"), bool(p.get("n_prefix_embeds")))

    # -- parameters ----------------------------------------------------------

    def ssm_sizes(self):
        """(di, H, P, G, N, K) of the Mamba layers."""
        s = self.ssm
        di = s["expand"] * self.d
        return (di, di // s["head_dim"], s["head_dim"], s["n_groups"],
                s["d_state"], s["d_conv"])

    def mixer_params(self, mixer: str) -> int:
        d, H = self.d, self.heads
        if mixer == "mla":
            m = self.mla
            r, rope = m["kv_lora_rank"], m["rope_head_dim"]
            nope, v = m["nope_head_dim"], m["v_head_dim"]
            return (d * H * (nope + rope) + d * (r + rope) + r * H * nope
                    + r * H * v + H * v * d)
        if mixer == "mamba":
            di, nh, _, G, N, K = self.ssm_sizes()
            return d * (2 * di + 2 * G * N + nh) + K * (di + 2 * G * N) \
                + di * d
        hd = self.head_dim
        return 2 * d * H * hd + 2 * d * self.kv_heads * hd

    def ffn_params(self, ffn: str, active: bool) -> int:
        d = self.d
        if ffn == "none":
            return 0
        if ffn == "dense":
            return 3 * d * self.d_ff
        m = self.moe
        experts = m["top_k"] if active else m["num_experts"]
        return (d * m["num_experts"] + 3 * d * m["d_ff_expert"] * experts
                + 3 * d * m.get("d_ff_shared", 0))

    def layer_params(self, active: bool) -> int:
        """Weights of the layers (no embedding, no head, no norms)."""
        return sum(self.mixer_params(mx) + self.ffn_params(ff, active)
                   for mx, ff, _ in self.layers)

    def all_params(self) -> int:
        """Every weight but the vectors (norms, biases, a Mamba layer's
        per-head A_log, D and dt_bias) and the padded vocabulary rows."""
        return (self.layer_params(False) + self.vocab * self.d
                * (1 if self.tie else 2) + self.prefix * self.d * self.d)

    def kv_bytes_per_token(self) -> int:
        n = 0
        for mx, _, _ in self.layers:
            if mx == "mla":
                n += (self.mla["kv_lora_rank"] + self.mla["rope_head_dim"]) \
                    * self.dtype_bytes
            elif mx != "mamba":
                n += 2 * self.kv_heads * self.head_dim * self.dtype_bytes
        return n

    def state_bytes_per_slot(self) -> int:
        """What a slot holds whatever its length, over the Mamba layers:
        the float32 state [H, P, N] and the conv history, the last K - 1
        rows of x, B and C in the weights' type."""
        if self.ssm is None:
            return 0
        di, nh, P, G, N, K = self.ssm_sizes()
        per_layer = nh * P * N * F32 + (K - 1) * (di + 2 * G * N) \
            * self.dtype_bytes
        return per_layer * self.mamba_layers()

    # -- model flops ---------------------------------------------------------

    def pair_flops(self, mixer: str) -> int:
        """Attention flops of one (query, key) pair in one layer."""
        H = self.heads
        if mixer == "mla":
            m = self.mla
            return 2 * H * (m["nope_head_dim"] + m["rope_head_dim"]) \
                + 2 * H * m["v_head_dim"]
        if mixer == "mamba":
            return 0
        return 4 * H * self.head_dim

    def decode_flops(self, ctxs) -> float:
        """Model flops of one decode step over rows of context ``ctxs``
        (each counting the new token): the layers' weights (active experts
        only), the head, attention over each context (a window layer's
        over at most its window) and each Mamba layer's state update."""
        per_tok = 2 * self.layer_params(True) + 2 * self.d * self.vocab
        attn = sum(self.pair_flops(mx) * sum(min(c, w or c) for c in ctxs)
                   for mx, _, w in self.layers)
        scan = self.mamba_layers() * self.mamba_step(len(ctxs))[0] \
            if self.ssm else 0
        return per_tok * len(ctxs) + attn + scan

    def prefill_flops(self, n: int) -> float:
        """Model flops of prefilling ``n`` tokens (causal pairs, a window
        layer's capped at its window; each Mamba layer's chunked scan),
        with the head on the last token."""
        attn = sum(self.pair_flops(mx) * _pairs(n, w)
                   for mx, _, w in self.layers)
        scan = self.mamba_layers() * self.ssd_call(n)[0] if self.ssm else 0
        return 2 * self.layer_params(True) * n + 2 * self.d * self.vocab \
            + attn + scan

    # -- the port's attention kernels (one call = one layer) -----------------

    def flash_call(self, lq: int, lk: int):
        """(flops, bytes) of one causal flash call: ``lq`` queries at the
        tail of ``lk`` keys; q, k, v read once and the output written."""
        pairs = lq * (lk - lq) + lq * (lq + 1) // 2
        hd = self.head_dim
        flops = 4 * self.heads * hd * pairs
        nbytes = self.dtype_bytes * hd * (2 * lq * self.heads
                                          + 2 * lk * self.kv_heads)
        return flops, nbytes

    def paged_call(self, ctxs):
        """(flops, bytes) of one paged decode call over the active rows of
        context ``ctxs``: every context row of K and V read once, q read
        and the output written once a row."""
        hd = self.head_dim
        n = sum(ctxs)
        flops = 4 * self.heads * hd * n
        nbytes = self.dtype_bytes * hd * (2 * self.kv_heads * n
                                          + 2 * self.heads * len(ctxs))
        return flops, nbytes

    def flash_layers(self) -> int:
        return sum(mx in ("full", "window") for mx, _, _ in self.layers)

    # -- the Mamba layers: kernel B3 and the decode update (one layer) -------

    def mamba_layers(self) -> int:
        return sum(mx == "mamba" for mx, _, _ in self.layers)

    def ssd_call(self, L: int):
        """(flops, bytes) of one B3 call, one Mamba layer's chunked scan of
        one sequence of ``L`` tokens.  Flops: the causal pairs inside each
        chunk (the last one holding L mod chunk) x (2·G·N for C·B, the
        heads of a group sharing it, + 2·H·P for the weighted sum of x),
        plus L·H·4·N·P for the chunk states and their read-out.  Bytes: x,
        B and C in the weights' type and dt in float32 read once, y in
        float32 written once, and the final float32 state written once."""
        _, nh, P, G, N, _ = self.ssm_sizes()
        full, rest = divmod(L, self.ssm["chunk"])
        pairs = full * _pairs(self.ssm["chunk"], None) + _pairs(rest, None)
        flops = pairs * (2 * G * N + 2 * nh * P) + L * nh * 4 * N * P
        nbytes = L * (nh * P * self.dtype_bytes + nh * F32
                      + 2 * G * N * self.dtype_bytes + nh * P * F32) \
            + nh * P * N * F32
        return flops, nbytes

    def mamba_step(self, rows: int):
        """(flops, bytes) of one Mamba layer's decode update over ``rows``
        slots.  Flops a slot: 5·H·P·N, the state's decay (a multiply), its
        input dt·x ⊗ B (a multiply-add) and the read-out C·h (a
        multiply-add).  Bytes a slot: the float32 state read and written
        once, and the conv history, K - 1 rows of x, B and C, read."""
        di, nh, P, G, N, K = self.ssm_sizes()
        flops = rows * 5 * nh * P * N
        nbytes = rows * (2 * nh * P * N * F32
                         + (K - 1) * (di + 2 * G * N) * self.dtype_bytes)
        return flops, nbytes
