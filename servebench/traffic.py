"""One general generator for every traffic mix in ``traffic/<mix>.json``.

A mix file gives the loop (``open``: Poisson arrivals at ``rate_per_s``;
``backlog``: a closed loop whose queue always holds at least as many
waiting requests as the engine has slots), the prompt and output length
distributions (lognormal by ``median`` and ``sigma``, clipped to ``min``
and ``max``) and ``block``.

Lengths: every seed gets the same lengths in another order.  Requests come
in blocks of ``block``, and each block holds the lengths at the quantiles
(j + 0.5) / block, j < block, of each distribution, shuffled by the seed.

Arrivals: a Poisson process at the rate, given its count in each span of
the run (the lead-in, the window, what follows it), with the same gaps
under every seed in another order.  A span of ``s`` seconds holds
n = round(rate x s) arrivals.  Its n + 1 gaps (before the first arrival,
between arrivals, after the last) are the exponential's quantiles at
(j + 0.5) / (n + 1), j <= n, scaled to sum to ``s`` and shuffled by the
seed: the spacings of a Poisson process known to hold n arrivals are
exponentials scaled so, so the bursts and lulls are the Poisson's (the
gaps exponential, a bin's count of the Poisson's variance), and every
seed offers the window the same requests at the same set of gaps, in
another order.

Token ids are uniform over the vocabulary.  Request ``i``'s lengths and
tokens depend only on the seed and ``i``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

LOOPS = ("open", "backlog")


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """The ``n`` stratified lengths of a clipped lognormal."""
    nd = NormalDist()
    out = []
    for j in range(n):
        x = dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf((j + 0.5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return np.array(out, dtype=np.int64)


def poisson_gaps(n: int, span: float) -> np.ndarray:
    """The n + 1 gaps of n arrivals in ``span`` seconds, in ascending order:
    the exponential's stratified quantiles, scaled to sum to ``span``."""
    q = -np.log1p(-(np.arange(n + 1) + 0.5) / (n + 1))
    return q * (span / q.sum())


def _seed_words(seed: int) -> List[int]:
    """A seed of any size as 64-bit words, for ``np.random.SeedSequence``."""
    s = int(seed) % (1 << 128)
    return [s & ((1 << 64) - 1), s >> 64]


@dataclass
class Arrival:
    index: int
    due_s: float          # seconds after the schedule starts (0 in a backlog)
    prompt: np.ndarray    # int32 token ids
    output_len: int       # output tokens the request runs, the first included


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: Dict, seed: int, vocab_size: int):
        if mix["loop"] not in LOOPS:
            raise ValueError(f"unknown loop {mix['loop']!r}; known: {LOOPS}")
        self.mix, self.seed, self.vocab = mix, seed, vocab_size
        self.block = int(mix["block"])
        self._prompts = quantile_lengths(mix["prompt"], self.block)
        self._outputs = quantile_lengths(mix["output"], self.block)
        self._blocks: Dict[int, tuple] = {}

    def _rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(_seed_words(self.seed) + list(stream)))

    def _block(self, b: int):
        if b not in self._blocks:
            rng = self._rng(1, b)
            self._blocks[b] = (rng.permutation(self._prompts), rng.permutation(self._outputs))
        return self._blocks[b]

    @property
    def prompt_lengths(self) -> np.ndarray:
        """Every prompt length a block holds (the shapes set-up warms)."""
        return np.sort(self._prompts)

    def request(self, i: int, due_s: float = 0.0) -> Arrival:
        b, j = divmod(i, self.block)
        prompts, outputs = self._block(b)
        tokens = self._rng(2, i).integers(0, self.vocab, int(prompts[j]), dtype=np.int64)
        return Arrival(i, due_s, tokens.astype(np.int32), int(outputs[j]))

    def arrival_times(self, rate_per_s: float, spans: Sequence[float]) -> np.ndarray:
        """Every arrival time of the open loop, in seconds from its start:
        span ``k`` of ``spans[k]`` seconds holds round(rate x spans[k])
        arrivals, at the span's ``poisson_gaps`` in the seed's order."""
        out, start = [], 0.0
        for k, span in enumerate(spans):
            n = int(round(rate_per_s * span))
            gaps = self._rng(4, k).permutation(poisson_gaps(n, span))
            out.append(start + np.cumsum(gaps)[:n])
            start += span
        return np.concatenate(out) if out else np.zeros(0)

    def open_schedule(self, rate_per_s: float, spans: Sequence[float]) -> List[Arrival]:
        """Every request of the open loop over ``spans``, in order of arrival."""
        return [self.request(i, float(t))
                for i, t in enumerate(self.arrival_times(rate_per_s, spans))]
