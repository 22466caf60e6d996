"""Synthetic training data, copied from the JAX package's
``training/data.py`` (NumPy only): an infinite token stream with a planted
bigram structure, and the deterministic hash tokenizer stub.  The same seed
gives the same batches as the JAX package's ``TokenDataset``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..configs.base import ModelConfig


@dataclass
class DataConfig:
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    # zipf-ish unigram skew so the loss has learnable structure
    zipf_a: float = 1.3


class TokenDataset:
    """Infinite synthetic LM stream with a planted bigram structure so a
    few hundred training steps show a measurably decreasing loss."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig | None = None):
        self.cfg = cfg
        self.d = dcfg or DataConfig()
        self.rng = np.random.default_rng(self.d.seed)
        V = cfg.vocab_size
        # planted structure: each token deterministically prefers a successor
        self._succ = np.arange(V)
        self.rng.shuffle(self._succ)

    def _sample_seq(self, length: int) -> np.ndarray:
        V = self.cfg.vocab_size
        out = np.empty(length + 1, dtype=np.int32)
        out[0] = self.rng.integers(0, V)
        noise = self.rng.random(length)
        rand_next = self.rng.integers(0, V, size=length)
        for t in range(length):
            out[t + 1] = (self._succ[out[t]] if noise[t] < 0.8
                          else rand_next[t])
        return out

    def batches(self) -> Iterator[dict]:
        B, S = self.d.global_batch, self.d.seq_len
        while True:
            seqs = np.stack([self._sample_seq(S) for _ in range(B)])
            if self.cfg.input_mode == "embeddings":
                emb = self.rng.standard_normal(
                    (B, S, self.cfg.d_model)).astype(np.float32)
                yield {"embeddings": emb, "labels": seqs[:, 1:]}
            else:
                yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def hash_tokenize(text: str, length: int | None = None,
                  vocab: int = 32000) -> np.ndarray:
    """Deterministic tokenizer stub: bytes → rolling-hash token ids."""
    data = text.encode()
    n = length or max(1, len(data) // 4)
    out = np.empty(n, dtype=np.int32)
    h = 2166136261
    for i in range(n):
        for b in data[i * 4: (i + 1) * 4] or b"\0":
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        out[i] = h % vocab
    return out
