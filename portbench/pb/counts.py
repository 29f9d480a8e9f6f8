"""Operations and bytes, counted from a configuration's sizes and the
shapes a run served: the yardstick of the roofline and MFU metrics.

Peaks are the published ones of one NVIDIA H100 SXM (dense bf16 on the
tensor cores, HBM3).  Flops count a multiply-add as two."""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12           # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bytes a second


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


@dataclasses.dataclass(frozen=True)
class Counts:
    """Per-token and per-layer sizes of a configuration's ``port`` section."""
    d: int
    vocab: int
    layers: tuple             # (mixer, ffn) per layer
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    moe: dict | None
    mla: dict | None
    tie: bool
    dtype_bytes: int = 2

    @classmethod
    def of(cls, conf: dict) -> "Counts":
        p = conf["port"]
        layers = tuple((l["mixer"], l["ffn"]) for l in p["layers"]
                       for _ in range(l["repeat"]))
        return cls(p["d_model"], p["vocab_size"], layers, p["num_heads"],
                   p["num_kv_heads"], p["head_dim"], p["d_ff"],
                   p.get("moe"), p.get("mla"), p["tie_embeddings"])

    # -- parameters ----------------------------------------------------------

    def mixer_params(self, mixer: str) -> int:
        d, H = self.d, self.heads
        if mixer == "mla":
            m = self.mla
            r, rope = m["kv_lora_rank"], m["rope_head_dim"]
            nope, v = m["nope_head_dim"], m["v_head_dim"]
            return (d * H * (nope + rope) + d * (r + rope) + r * H * nope
                    + r * H * v + H * v * d)
        hd = self.head_dim
        return 2 * d * H * hd + 2 * d * self.kv_heads * hd

    def ffn_params(self, ffn: str, active: bool) -> int:
        d = self.d
        if ffn == "dense":
            return 3 * d * self.d_ff
        m = self.moe
        experts = m["top_k"] if active else m["num_experts"]
        return (d * m["num_experts"] + 3 * d * m["d_ff_expert"] * experts
                + 3 * d * m.get("d_ff_shared", 0))

    def layer_params(self, active: bool) -> int:
        """Weights of the layers (no embedding, no head, no norms)."""
        return sum(self.mixer_params(mx) + self.ffn_params(ff, active)
                   for mx, ff in self.layers)

    def all_params(self) -> int:
        return (self.layer_params(False) + self.vocab * self.d
                * (1 if self.tie else 2))

    def kv_bytes_per_token(self) -> int:
        n = 0
        for mx, _ in self.layers:
            if mx == "mla":
                n += (self.mla["kv_lora_rank"] + self.mla["rope_head_dim"]) \
                    * self.dtype_bytes
            else:
                n += 2 * self.kv_heads * self.head_dim * self.dtype_bytes
        return n

    # -- model flops ---------------------------------------------------------

    def pair_flops(self, mixer: str) -> int:
        """Attention flops of one (query, key) pair in one layer."""
        H = self.heads
        if mixer == "mla":
            m = self.mla
            return 2 * H * (m["nope_head_dim"] + m["rope_head_dim"]) \
                + 2 * H * m["v_head_dim"]
        return 4 * H * self.head_dim

    def decode_flops(self, ctxs) -> float:
        """Model flops of one decode step over rows of context ``ctxs``
        (each counting the new token): the layers' weights (active experts
        only), the head, and attention over each context."""
        per_tok = 2 * self.layer_params(True) + 2 * self.d * self.vocab
        pairs = sum(ctxs)
        attn = sum(self.pair_flops(mx) for mx, _ in self.layers) * pairs
        return per_tok * len(ctxs) + attn

    def prefill_flops(self, n: int) -> float:
        """Model flops of prefilling ``n`` tokens (causal pairs), with the
        head on the last token."""
        pairs = n * (n + 1) // 2
        attn = sum(self.pair_flops(mx) for mx, _ in self.layers) * pairs
        return 2 * self.layer_params(True) * n + 2 * self.d * self.vocab + attn

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
        return sum(mx in ("full", "window") for mx, _ in self.layers)
