"""Synthetic tokenized LM data pipeline: a NumPy copy of the JAX package's
``training/data.py`` (the same draws, so the same batches from a seed).

Deterministic, seeded, and cheap: a Zipfian token stream with short-range
structure (Markov-ish bigram mixing) so a model actually has something to
learn in the training examples — loss decreases measurably within a few
hundred steps, unlike uniform-random tokens.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_size: int,
        *,
        seed: int = 0,
        embed_dim: Optional[int] = None,   # if set, yields embeddings (VLM stub)
        enc_seq: Optional[int] = None,     # if set, adds encoder frames (audio stub)
        d_model: Optional[int] = None,
    ):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.embed_dim = embed_dim
        self.enc_seq = enc_seq
        self.d_model = d_model
        # Zipf weights over a capped support for speed
        support = min(vocab_size, 50_000)
        w = 1.0 / np.arange(1, support + 1) ** 1.1
        self.probs = w / w.sum()
        self.support = support
        # bigram successor table: token t prefers (t*7+3)%support
        self.succ = (np.arange(support) * 7 + 3) % support

    def _sample_seq(self) -> np.ndarray:
        out = np.empty(self.seq + 1, dtype=np.int32)
        out[0] = self.rng.choice(self.support, p=self.probs)
        noise = self.rng.random(self.seq)
        fresh = self.rng.choice(self.support, p=self.probs, size=self.seq)
        for i in range(1, self.seq + 1):
            out[i] = self.succ[out[i - 1]] if noise[i - 1] < 0.7 else fresh[i - 1]
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        seqs = np.stack([self._sample_seq() for _ in range(self.batch)])
        batch = {
            "inputs": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }
        if self.embed_dim is not None:
            batch["inputs"] = self.rng.standard_normal(
                (self.batch, self.seq, self.embed_dim), dtype=np.float32
            )
        if self.enc_seq is not None:
            batch["enc_inputs"] = self.rng.standard_normal(
                (self.batch, self.enc_seq, self.d_model), dtype=np.float32
            )
        return batch
