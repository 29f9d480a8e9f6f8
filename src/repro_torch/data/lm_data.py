"""Deterministic synthetic LM data pipeline.

Copy of ``repro/data/lm_data.py`` (numpy only), kept in the port so that it
imports nothing of ``repro``: a given ``(seed, step)`` gives byte-equal
batches in both packages.

Markov-chain token streams with zipfian unigrams: enough structure for a
small LM to visibly learn (loss drops well below uniform entropy), fully
deterministic in (seed, step) so a resumed job sees exactly the batches
it would have seen — the data side of fault-tolerant training.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0, order_mix: float = 0.7):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.order_mix = order_mix
        # sparse "grammar": each token has a handful of likely successors
        self.succ = rng.integers(0, vocab_size, size=(vocab_size, 4))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int, batch: int, seq: int):
        """Returns (tokens, labels, mask) for a given global step."""
        rng = np.random.default_rng((step + 1) * 7919)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(seq):
            follow = rng.random(batch) < self.order_mix
            pick = rng.integers(0, 4, size=batch)
            markov = self.succ[toks[:, t], pick]
            rand = rng.choice(self.vocab, size=batch, p=self.unigram)
            toks[:, t + 1] = np.where(follow, markov, rand)
        tokens = toks[:, :-1]
        labels = toks[:, 1:]
        mask = np.ones_like(labels, np.float32)
        return tokens, labels, mask
