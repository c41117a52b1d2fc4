"""Age-bucketed request queues.

Two implementations of the same FIFO-with-ages contract:

:class:`BucketQueue`
    The scalar deque-of-buckets queue the seed simulator used — one
    instance per (arch, class).  Kept for the reference simulator and as
    the readable specification of queue semantics.

:class:`QueueArray`
    The vectorized pool queue: one instance per latency class holds the
    age-bucketed queues of *all* architectures as a ``[A, W]`` ring
    buffer (structure-of-arrays), where column ``arrival_tick % W``
    counts the requests that arrived at that tick.  Because every queue
    is drained of entries older than the abandon window every tick, a
    window of ``3 * slo + 2`` columns is provably enough, and serving
    oldest-first becomes a cumulative sum — the hot path is O(A * W)
    NumPy work per tick instead of per-arch Python.  A backlog flag
    short-circuits the common well-provisioned tick (only this tick's
    arrivals queued, all of them served) down to O(A).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import numpy as np


def cumsum_serve(counts, capacity, late_mask):
    """Serve ``capacity[a]`` from ``counts[a, w]`` buckets oldest-first.

    ``counts`` columns must be ordered oldest -> newest; a cumulative sum
    allocates capacity front-to-back and ``late_mask`` scores which
    buckets violate.  :class:`QueueArray` runs it; the batched engine
    (``sim/torch_engine.py``) runs the same expression on torch tensors.
    Returns ``(left, served, late)``.
    """
    before = np.cumsum(counts, axis=1) - counts
    take = np.minimum(counts, np.clip(capacity[:, None] - before, 0.0, None))
    served = take.sum(axis=1)
    late = (take * late_mask).sum(axis=1)
    return counts - take, served, late


# ---------------------------------------------------------------------------
# Scalar reference queue (seed implementation).
# ---------------------------------------------------------------------------
class BucketQueue:
    __slots__ = ("buckets",)

    def __init__(self) -> None:
        self.buckets: Deque[List[float]] = deque()  # [arrival_tick, count]

    def push(self, tick: int, count: float) -> None:
        if count > 0:
            self.buckets.append([tick, count])

    def __len__(self) -> int:
        return int(sum(c for _, c in self.buckets))

    @property
    def total(self) -> float:
        return sum(c for _, c in self.buckets)

    def pop(self, amount: float) -> List[Tuple[int, float]]:
        """Serve ``amount`` oldest-first; returns [(arrival_tick, count)]."""
        out: List[Tuple[int, float]] = []
        while amount > 1e-9 and self.buckets:
            t0, c = self.buckets[0]
            take = min(c, amount)
            out.append((t0, take))
            amount -= take
            if take >= c - 1e-12:
                self.buckets.popleft()
            else:
                self.buckets[0][1] = c - take
        return out

    def pop_older_than(self, tick: int, max_age: int) -> float:
        """Remove and return the count of entries with age > max_age."""
        n = 0.0
        while self.buckets and tick - self.buckets[0][0] > max_age:
            n += self.buckets.popleft()[1]
        return n


# ---------------------------------------------------------------------------
# Vectorized pool queue: all archs of one latency class, SoA.
# ---------------------------------------------------------------------------
class QueueArray:
    """Pool-wide age-bucketed FIFO queues for one latency class.

    ``slack[a]`` is the per-arch integer age beyond which a served
    request counts as an SLO violation; ``drop_age`` (3 x the class SLO)
    is the abandon window after which unserved requests are dropped.
    """

    def __init__(self, n_archs: int, slo_s: float, slack: np.ndarray):
        self.slo_s = float(slo_s)
        self.slack = np.asarray(slack, dtype=np.int64)
        self.drop_age = int(3 * slo_s)
        # ages 0..drop_age live between ticks; +1 transient before the
        # drop step runs; +1 spare so "this tick's" column is always free
        self.window = self.drop_age + 2
        self.buf = np.zeros((n_archs, self.window), dtype=np.float64)
        # incremental per-arch mass, and whether any mass is older than
        # the current tick's column (the slow-path trigger)
        self.total = np.zeros(n_archs, dtype=np.float64)
        self.backlog = False
        # precomputed geometry: for tick t, the columns oldest -> newest
        # are _cols[t % W]; their ages are always W-1 .. 0
        w = self.window
        self._cols = np.stack([np.arange(r + 1, r + 1 + w) % w for r in range(w)])
        ages = np.arange(w - 1, -1, -1)
        self._late_mask = ages[None, :] > self.slack[:, None]

    # -- admission ----------------------------------------------------------
    def push(self, tick: int, counts: np.ndarray) -> None:
        """Admit this tick's arrivals (``counts[a]`` requests per arch)."""
        self.buf[:, tick % self.window] += counts
        self.total += counts

    def totals(self) -> np.ndarray:
        return self.total

    def age_quantile(self, tick: int, q: float = 0.99) -> np.ndarray:
        """Per-arch ``q``-quantile of queued-request ages at this tick
        (seconds; 0 for empty queues) — the telemetry recorder's
        queue-age gauge.  The quantile age is the smallest age holding
        at least ``q`` of the arch's queued mass at or below it."""
        counts = self.buf[:, self._cols[tick % self.window]]   # oldest->newest
        total = counts.sum(axis=1)
        by_age = counts[:, ::-1]                               # ages 0..W-1
        cum = np.cumsum(by_age, axis=1)
        k = np.argmax(cum >= (q * total)[:, None], axis=1)
        return np.where(total > 0, k, 0)

    def late_mask_for(self, slack: np.ndarray) -> np.ndarray:
        """An alternative ``[A, W]`` lateness mask for ``serve``: a served
        request is late when its age exceeds ``slack[a]`` (which may be
        negative — e.g. a remote tier whose egress adder alone blows the
        SLO makes even age-0 service late)."""
        ages = np.arange(self.window - 1, -1, -1)
        return ages[None, :] > np.asarray(slack, dtype=np.int64)[:, None]

    # -- serving ------------------------------------------------------------
    def serve(
        self, tick: int, capacity: np.ndarray,
        late_mask: np.ndarray = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve up to ``capacity[a]`` requests oldest-first.

        Returns ``(served[a], late[a])`` where ``late`` counts served
        requests whose queueing age exceeded the arch's slack —
        evaluated against ``late_mask`` (from :meth:`late_mask_for`)
        instead of the arch's own slack when given, which is how capacity
        with a per-request latency adder (a remote region's egress)
        books its tighter lateness threshold.
        """
        if not self.backlog and late_mask is None:
            # only this tick's arrivals are queued: age 0, never late
            col = tick % self.window
            counts = self.buf[:, col]
            take = np.minimum(counts, capacity)
            left = counts - take
            self.buf[:, col] = left
            self.total = left.copy()
            self.backlog = bool(left.any())
            return take, np.zeros_like(take)

        idx = self._cols[tick % self.window]
        counts = self.buf[:, idx]
        mask = self._late_mask if late_mask is None else late_mask
        left, served, late = cumsum_serve(counts, capacity, mask)
        self.buf[:, idx] = left
        self.total = self.total - served
        self.backlog = bool(self.total.any())
        return served, late

    # -- burst offload ------------------------------------------------------
    def drain(self, mask: np.ndarray) -> np.ndarray:
        """Empty the queues of archs selected by boolean ``mask[a]``;
        returns the drained counts (0 elsewhere)."""
        out = self.total * mask
        self.buf[mask] = 0.0
        self.total = self.total * ~mask
        self.backlog = bool(self.total.any())
        return out

    # -- abandonment --------------------------------------------------------
    def drop_expired(self, tick: int) -> np.ndarray:
        """Drop the bucket that just aged past the abandon window.

        Because this runs every tick, at most one column (age
        ``drop_age + 1``) can hold expired mass.
        """
        arrival = tick - self.drop_age - 1
        if arrival < 0 or not self.backlog:
            return np.zeros(self.buf.shape[0])
        col = arrival % self.window
        out = self.buf[:, col].copy()
        self.buf[:, col] = 0.0
        self.total = self.total - out
        self.backlog = bool(self.total.any())
        return out

    def pop_older_than_slack(self, tick: int) -> np.ndarray:
        """End-of-trace sweep: remove everything older than each arch's
        slack (it would violate if it were ever served)."""
        idx = self._cols[tick % self.window]
        counts = self.buf[:, idx]
        old = self._late_mask
        out = (counts * old).sum(axis=1)
        self.buf[:, idx] = counts * ~old
        self.total = self.total - out
        self.backlog = bool(self.total.any())
        return out
