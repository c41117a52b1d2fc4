"""Load monitor (paper §III-B2).

Watches the arrival stream in sliding sampling windows and exposes the
statistics the procurement policies plug into: smoothed rate (EWMA),
windowed peak, and the peak-to-median ratio that Observation 4 says
predicts whether mixed procurement pays off.

Two implementations of the same contract:

:class:`LoadMonitor`
    The seed scalar monitor — one arrival stream, a deque window.

:class:`PoolLoadMonitor`
    The vectorized streaming counterpart for heterogeneous per-arch
    arrival matrices: every arch keeps its own EWMA and sliding window
    in one ``[A, W]`` ring buffer.  Window order statistics (peak and
    the two middle ranks the median needs) are maintained
    *incrementally*: each arch carries a small sorted **band** of
    consecutive order statistics around the median, so a steady-state
    tick is O(A) classification work plus tiny ``[n, band]`` edits —
    the full ``[A, W]`` pass survives only in the rare re-centering
    refill.  (The previous implementation recomputed ``np.median`` over
    the whole window every tick: O(A*W) partition work per tick, the
    pool-scale hot spot `sim_throughput.py` now benchmarks at A=256.)
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np


@dataclass
class LoadMonitor:
    window_s: int = 300
    ewma_alpha: float = 0.3
    _hist: Deque[float] = field(default_factory=deque)
    _ewma: Optional[float] = None

    def observe(self, rate: float) -> None:
        self._hist.append(float(rate))
        while len(self._hist) > self.window_s:
            self._hist.popleft()
        self._ewma = (
            rate
            if self._ewma is None
            else self.ewma_alpha * rate + (1 - self.ewma_alpha) * self._ewma
        )

    @property
    def rate(self) -> float:
        """Smoothed current arrival rate (req/s)."""
        return self._ewma or 0.0

    @property
    def peak(self) -> float:
        return max(self._hist) if self._hist else 0.0

    @property
    def median(self) -> float:
        return float(np.median(self._hist)) if self._hist else 0.0

    @property
    def peak_to_median(self) -> float:
        """Observation-4 statistic over the sampling window."""
        m = self.median
        return self.peak / m if m > 0 else 1.0

    def bursty(self, threshold: float = 1.5) -> bool:
        """True when the window shows spike structure worth offloading."""
        return len(self._hist) >= self.window_s // 4 and self.peak_to_median >= threshold


class PoolLoadMonitor:
    """Per-arch load statistics over a pool, vectorized and streaming.

    Semantically one :class:`LoadMonitor` per architecture; all A windows
    live in a single ``[A, W]`` ring buffer.  Built for heterogeneous
    arrival matrices (:mod:`repro_torch.core.workloads`), where each arch's
    stream has its own burst structure and the share-invariant trick the
    engine uses for a single pool trace (every arch = share x pool) no
    longer holds.

    **Incremental order statistics.**  Once a window is full, each row
    maintains

    * a running ``peak`` (grown with each arrival; recomputed for the
      ~1/W of rows whose *leaving* sample was the peak), and
    * a sorted *band* — the ``<= band_width`` consecutive window order
      statistics ``start_rank .. start_rank + n - 1`` bracketing the two
      middle ranks the median averages.  A tick classifies the leaving
      and arriving samples against the band edges in O(A); samples
      landing inside the band trigger an ``[n, band_width]`` insert /
      delete on just those rows; samples below the band only shift
      ``start_rank``.  When drift or shrinkage pushes the middle ranks
      out of the band, the affected rows (rare — drift must cross the
      band margin) are refilled with one sort of their window.

    Results are *bit-identical* to the per-row :class:`LoadMonitor`
    (``tests/test_workloads.py`` asserts it); the first ``window_s - 1``
    ticks use growing windows, matching the filling deque, and fall back
    to direct reductions while ranks still move with the window length.
    """

    def __init__(self, n_archs: int, window_s: int = LoadMonitor.window_s,
                 ewma_alpha: float = LoadMonitor.ewma_alpha, *,
                 band_width: int = 32, incremental: bool = True):
        self.window_s = int(window_s)
        self.ewma_alpha = float(ewma_alpha)
        self.buf = np.zeros((n_archs, self.window_s), dtype=np.float64)
        self.ewma = np.zeros(n_archs, dtype=np.float64)
        self._seen = 0
        # the two middle (0-indexed) ranks np.median averages
        self._k1 = (self.window_s - 1) // 2
        self._k2 = self.window_s // 2
        self.incremental = bool(incremental)
        self._B = max(int(band_width), (self._k2 - self._k1 + 1) + 4)
        self._rows = np.arange(n_archs)
        self._band = np.full((n_archs, self._B), np.inf)
        self._nb = np.zeros(n_archs, dtype=np.int64)     # valid band entries
        self._sr = np.zeros(n_archs, dtype=np.int64)     # rank of band[:, 0]
        self._peak = np.zeros(n_archs, dtype=np.float64)
        self._median = np.zeros(n_archs, dtype=np.float64)

    @property
    def filled(self) -> int:
        """How many window columns hold real observations."""
        return min(self._seen, self.window_s)

    # -- band primitives (sub: [n, B] rows, inf-padded past the count) -----
    @staticmethod
    def _band_delete(sub: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Drop the element at per-row ``pos``, shift left, pad with inf."""
        n, B = sub.shape
        tmp = np.concatenate([sub, np.full((n, 1), np.inf)], axis=1)
        j = np.arange(B)[None, :]
        return np.take_along_axis(tmp, j + (j >= pos[:, None]), axis=1)

    @staticmethod
    def _band_insert(sub: np.ndarray, pos: np.ndarray, val: np.ndarray) -> np.ndarray:
        """Insert ``val`` at per-row ``pos``, shift right (top falls off)."""
        _, B = sub.shape
        j = np.arange(B)[None, :]
        out = np.take_along_axis(sub, np.maximum(j - (j > pos[:, None]), 0), axis=1)
        np.put_along_axis(out, pos[:, None], val[:, None], axis=1)
        return out

    def _refill(self, idx: np.ndarray) -> None:
        """Rebuild band + peak for ``idx`` rows from their full windows."""
        if idx.size == 0:
            return
        margin = (self._B - (self._k2 - self._k1 + 1)) // 2
        lo = max(self._k1 - margin, 0)
        hi = min(self._k2 + margin, self.window_s - 1)
        sub = np.sort(self.buf[idx], axis=1)
        self._band[idx] = np.inf
        self._band[idx, : hi - lo + 1] = sub[:, lo: hi + 1]
        self._nb[idx] = hi - lo + 1
        self._sr[idx] = lo
        self._peak[idx] = sub[:, -1]

    def _steady_update(self, out: np.ndarray, new: np.ndarray) -> None:
        band, nb, sr = self._band, self._nb, self._sr
        rows = self._rows
        # ---- remove the leaving sample from the order statistics --------
        b0 = band[:, 0]
        btop = band[rows, np.maximum(nb - 1, 0)]
        below = out < b0
        sr -= below
        inside = (~below) & (out <= btop) & (nb > 0)
        idx = np.flatnonzero(inside)
        if idx.size:
            sub = band[idx]
            band[idx] = self._band_delete(sub, (sub < out[idx, None]).sum(axis=1))
            nb[idx] -= 1
        # ---- insert the arriving sample ---------------------------------
        b0 = band[:, 0]
        btop = band[rows, np.maximum(nb - 1, 0)]
        below = (new < b0) & (nb > 0)
        sr += below
        inside = (~below) & (new <= btop) & (nb > 0)
        idx = np.flatnonzero(inside)
        if idx.size:
            # full bands drop one end; dropping left means start_rank += 1,
            # pick the side with more slack around the tracked ranks
            over = nb[idx] == self._B
            drop_left = over & (self._k1 - sr[idx] >= sr[idx] + nb[idx] - 1 - self._k2)
            if drop_left.any():
                di = idx[drop_left]
                band[di] = self._band_delete(
                    band[di], np.zeros(drop_left.sum(), np.int64)
                )
                nb[di] -= 1
                sr[di] += 1
            sub = band[idx]
            band[idx] = self._band_insert(
                sub, (sub < new[idx, None]).sum(axis=1), new[idx]
            )
            nb[idx] = np.minimum(nb[idx] + 1, self._B)
        # ---- peak: grows with arrivals; recompute only the rows whose
        # leaving sample was (possibly) the unique window max
        stale = (out >= self._peak) & (out > new)
        np.maximum(self._peak, new, out=self._peak)
        idx = np.flatnonzero(stale)
        if idx.size:
            self._peak[idx] = self.buf[idx].max(axis=1)
        # ---- re-center rows whose band no longer brackets the medians ---
        bad = (sr > self._k1) | (sr + nb - 1 < self._k2) | (nb <= 0)
        self._refill(np.flatnonzero(bad))
        self._median = 0.5 * (
            band[rows, self._k1 - sr] + band[rows, self._k2 - sr]
        )

    def observe(self, rates: np.ndarray) -> None:
        """Record one tick's per-arch arrival rates (``rates[a]``)."""
        rates = np.asarray(rates, dtype=np.float64)
        col = self._seen % self.window_s
        full = self._seen >= self.window_s
        out = self.buf[:, col].copy() if full else None
        self.buf[:, col] = rates
        self.ewma = (
            rates.copy() if self._seen == 0
            else self.ewma_alpha * rates + (1 - self.ewma_alpha) * self.ewma
        )
        self._seen += 1
        if not self.incremental:
            return
        if full:
            self._steady_update(out, rates)
        elif self._seen == self.window_s:
            self._refill(self._rows)
            band, sr = self._band, self._sr
            self._median = 0.5 * (
                band[self._rows, self._k1 - sr]
                + band[self._rows, self._k2 - sr]
            )

    def _steady(self) -> bool:
        return self.incremental and self._seen >= self.window_s

    @property
    def rate(self) -> np.ndarray:
        """Smoothed per-arch arrival rate (req/s), ``[A]``."""
        return self.ewma

    @property
    def peak(self) -> np.ndarray:
        if self._steady():
            return self._peak
        f = self.filled
        if f == 0:
            return np.zeros(self.buf.shape[0])
        return self.buf[:, :f].max(axis=1)

    @property
    def median(self) -> np.ndarray:
        if self._steady():
            return self._median
        f = self.filled
        if f == 0:
            return np.zeros(self.buf.shape[0])
        return np.median(self.buf[:, :f], axis=1)

    def stats(self) -> tuple:
        """One-pass snapshot ``(ewma, peak, median, peak_to_median)``,
        each ``[A]`` — what a per-tick consumer (the engine) wants.  In
        the steady state these are O(A) reads of the incrementally
        maintained statistics."""
        peak, med = self.peak, self.median
        p2m = np.where(med > 0, peak / np.where(med > 0, med, 1.0), 1.0)
        return self.ewma, peak, med, p2m

    @property
    def peak_to_median(self) -> np.ndarray:
        """Observation-4 statistic per arch, ``[A]``."""
        return self.stats()[3]

    def bursty(self, threshold: float = 1.5) -> np.ndarray:
        """Boolean ``[A]``: archs whose window shows spike structure."""
        if self.filled < self.window_s // 4:
            return np.zeros(self.buf.shape[0], dtype=bool)
        return self.peak_to_median >= threshold


def pool_stats_trajectory(
    arrivals: np.ndarray, *, window_s: int = LoadMonitor.window_s,
    ewma_alpha: float = LoadMonitor.ewma_alpha,
) -> tuple:
    """Functional form of the monitor: the full per-tick statistics
    trajectory for a known ``[A, T]`` arrival matrix.

    The monitor's outputs are a pure function of the arrival stream —
    independent of policy and fleet state — so the batched torch engine
    (``sim/torch_engine.py``) materializes them up front and feeds them
    to its tick loop as inputs instead of carrying the order-statistic
    machinery as state.  Returns ``(ewma, peak, p2m)``, each
    ``[T, A]``, bit-identical to calling ``observe``/``stats`` tick by
    tick (it *is* that loop, run against the streaming monitor).
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    n_archs, ticks = arrivals.shape
    mon = PoolLoadMonitor(n_archs, window_s=window_s, ewma_alpha=ewma_alpha)
    ewma = np.empty((ticks, n_archs), dtype=np.float64)
    peak = np.empty((ticks, n_archs), dtype=np.float64)
    p2m = np.empty((ticks, n_archs), dtype=np.float64)
    for t in range(ticks):
        mon.observe(arrivals[:, t])
        e, pk, _, pm = mon.stats()
        ewma[t] = e
        peak[t] = pk
        p2m[t] = pm
    return ewma, peak, p2m
