"""Continuous batching: a request queue feeding the engine's slots.

Implements the serving loop a reserved slice runs: admit waiting requests
into free decode lanes (prefill-on-insert), decode all lanes in lockstep,
retire finished requests, repeat.  Tracks per-request latency so the
serving examples can report SLO attainment like the simulator predicts.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

import numpy as np

from repro_torch.serving.engine import Engine, Request


@dataclass
class BatchStats:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    latencies: List[float] = field(default_factory=list)

    def summary(self) -> dict:
        lat = np.array(self.latencies) if self.latencies else np.zeros(1)
        return {
            "admitted": self.admitted,
            "finished": self.finished,
            "decode_steps": self.decode_steps,
            "latency_mean_s": float(lat.mean()),
            "latency_p99_s": float(np.quantile(lat, 0.99)),
        }


class ContinuousBatcher:
    """Drives an :class:`Engine` from a FIFO request queue."""

    def __init__(self, engine: Engine, *, clock=time.perf_counter):
        self.engine = engine
        self.queue: Deque[Request] = deque()
        self.stats = BatchStats()
        self.clock = clock

    def submit(self, req: Request) -> None:
        req.enqueued_at = self.clock()
        self.queue.append(req)

    @property
    def idle(self) -> bool:
        return not self.queue and self.engine.live == 0

    def run_step(self) -> List[Request]:
        """One scheduler iteration: admit -> decode -> retire."""
        # admit as many waiting requests as there are free slots
        for slot in self.engine.free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            self.engine.insert(req, slot)
            self.stats.admitted += 1
        finished = self.engine.step()
        self.stats.decode_steps += 1
        now = self.clock()
        for req in finished:
            req.finished_at = now
            self.stats.latencies.append(now - req.enqueued_at)
            self.stats.finished += 1
        return finished

    def run_until_idle(self, max_steps: int = 100_000) -> BatchStats:
        steps = 0
        while not self.idle and steps < max_steps:
            self.run_step()
            steps += 1
        return self.stats
