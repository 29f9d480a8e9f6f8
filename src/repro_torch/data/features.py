"""TF-IDF featurization for the output-length predictor (paper Sec. 3.2).

Copy of ``repro/data/features.py`` (numpy and plain Python),
kept in the port so that it imports nothing of ``repro``.  Its imports
and references name ``repro_torch`` where the reference names
``repro``; any other line that differs carries a comment saying so.
Everything else, float expressions and iteration orders included, is
as written there.

Word-level tokenization + feature hashing + IDF weighting, fit on the
training corpus.  Two scalar side-features are appended (normalized
prompt length and tokens-generated-so-far) — the latter feeds the
periodic mid-request re-prediction (Sec. 3.4).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def _hash_token(tok: str, dim: int) -> int:
    h = 2166136261
    for ch in tok.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % dim


@dataclasses.dataclass
class TfIdfVectorizer:
    dim: int = 512
    idf: Optional[np.ndarray] = None

    def _counts(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for tok in t.lower().split():
                out[i, _hash_token(tok, self.dim)] += 1.0
        return out

    def fit(self, texts: Sequence[str]) -> "TfIdfVectorizer":
        counts = self._counts(texts)
        df = (counts > 0).sum(axis=0)
        self.idf = np.log((1 + len(texts)) / (1 + df)).astype(np.float32) + 1.0
        return self

    def transform(self, texts: Sequence[str]) -> np.ndarray:
        assert self.idf is not None, "call fit() first"
        tf = self._counts(texts)
        tf /= np.maximum(tf.sum(axis=1, keepdims=True), 1.0)
        x = tf * self.idf[None, :]
        norm = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(norm, 1e-8)


def featurize(vec: TfIdfVectorizer, prompts: Sequence[str],
              input_lens: Sequence[int],
              generated_so_far: Optional[Sequence[int]] = None) -> np.ndarray:
    x = vec.transform(prompts)
    il = np.asarray(input_lens, np.float32)[:, None] / 2048.0
    g = (np.zeros_like(il) if generated_so_far is None
         else np.asarray(generated_so_far, np.float32)[:, None] / 2048.0)
    return np.concatenate([x, il, g], axis=1)


def feature_dim(vec: TfIdfVectorizer) -> int:
    return vec.dim + 2
