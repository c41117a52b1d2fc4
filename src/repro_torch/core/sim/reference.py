"""The seed per-arch-loop simulator, kept as the behavioral reference.

This is the original ``ServingSim`` implementation: a Python loop over
architectures with scalar :class:`BucketQueue` state.  It is O(A) Python
work per tick and therefore slow on large pools, but it is the readable
specification the vectorized engine must match — the golden equivalence
test (``tests/test_sim_engine.py``) asserts both produce the same
``SimResult.summary()`` on the seed workload, and the throughput
benchmark measures the engine's speedup against it.

The only intentional divergence: on workloads that *use the spot tier*,
the engine draws all archs' preemption reclaims in one vectorized
binomial per tick while this loop draws per arch, so the two RNG streams
(and exact preemption counts) differ; everything deterministic matches.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.core.hardware import PRICING, FleetPricing
from repro_torch.core.load_monitor import LoadMonitor
from repro_torch.core.profiles import ModelProfile, get_profile
from repro_torch.core.sim.accounting import SimResult
from repro_torch.core.sim.queues import BucketQueue
from repro_torch.core.sim.types import RELAXED, STRICT, Action, ArchLoad, ArchObs, Policy


class _ArchState:
    def __init__(self, load: ArchLoad, pricing: FleetPricing, prewarm: bool):
        self.load = load
        self.prof: ModelProfile = get_profile(load.arch, req=STRICT)
        self.throughput = self.prof.throughput(STRICT)
        assert self.throughput > 0, f"{load.arch} cannot meet the strict SLO"
        self.lat_b1 = self.prof.request_latency(STRICT, 1)
        self.slack = {
            "strict": max(0, int(STRICT.slo_s - self.lat_b1)),
            "relaxed": max(0, int(RELAXED.slo_s - self.lat_b1)),
        }
        self.queues = {"strict": BucketQueue(), "relaxed": BucketQueue()}
        self.n_active = 0
        self.pending: List[int] = []           # ready ticks
        self.n_spot = 0
        self.spot_pending: List[int] = []
        self.monitor = LoadMonitor()
        self.last_util = 0.0
        # burst pool warmth: last tick the pool saw this model
        self.burst_last_used = 0.0 if prewarm else -math.inf
        self.pricing = pricing
        # provider-batched burst billing (see ModelProfile.burst_cost_per_request)
        self.burst_per_req = (
            self.prof.chips / self.throughput
        ) * pricing.burst_chip_s + pricing.burst_invocation_fee

    # -- burst ----------------------------------------------------------------
    def burst_latency(self, tick: int) -> float:
        cold = (tick - self.burst_last_used) > self.pricing.burst_idle_timeout_s
        lat = self.pricing.burst_spinup_s + self.lat_b1
        if cold:
            lat += self.prof.cold_start_s()
        return lat


class ReferenceSim:
    """Stepwise seed simulator: ``observe() -> actions -> apply()``."""

    def __init__(
        self,
        trace: np.ndarray,
        workload: List[ArchLoad],
        *,
        pricing: FleetPricing = PRICING,
        prewarm: bool = True,
        warm_start: bool = True,
        seed: int = 0,
    ):
        self.trace = trace
        self.pricing = pricing
        self.rng = np.random.default_rng(seed)   # spot preemption draws
        self.states = {w.key: _ArchState(w, pricing, prewarm) for w in workload}
        self.res = SimResult()
        self.tick = 0
        if warm_start:
            for st in self.states.values():
                st.n_active = max(
                    1, math.ceil(trace[0] * st.load.share / st.throughput)
                )

    @property
    def done(self) -> bool:
        return self.tick >= len(self.trace)

    def observe(self) -> Dict[str, ArchObs]:
        """Admit this tick's arrivals and return per-arch observations."""
        tick = self.tick
        rate = float(self.trace[tick])
        obs: Dict[str, ArchObs] = {}
        for arch, st in self.states.items():
            a_rate = rate * st.load.share
            st.monitor.observe(a_rate)
            n_strict = a_rate * st.load.strict_frac
            st.queues["strict"].push(tick, n_strict)
            st.queues["relaxed"].push(tick, a_rate - n_strict)
            self.res.total_requests += a_rate
            obs[arch] = ArchObs(
                arch=arch,
                rate=a_rate,
                ewma_rate=st.monitor.rate,
                window_peak=st.monitor.peak,
                peak_to_median=st.monitor.peak_to_median,
                queue_len=st.queues["strict"].total + st.queues["relaxed"].total,
                n_active=st.n_active,
                n_pending=len(st.pending),
                n_spot=st.n_spot,
                throughput=st.throughput,
                utilization=st.last_util,
            )
        self._last_obs = obs
        return obs

    def apply(self, actions: Dict[str, Action]) -> dict:
        """Apply procurement actions, serve the tick, advance time.

        Returns this tick's marginal metrics (for RL rewards)."""
        tick = self.tick
        res = self.res
        pricing = self.pricing
        obs = self._last_obs
        cost0, viol0 = res.cost_total, res.violations
        for arch, st in self.states.items():
            act = actions.get(arch, Action(target=st.n_active))

            # provisioning pipeline
            ready = [r for r in st.pending if r <= tick]
            st.n_active += len(ready)
            st.pending = [r for r in st.pending if r > tick]
            in_flight = st.n_active + len(st.pending)
            if act.target > in_flight:
                st.pending.extend(
                    [tick + int(pricing.reserved_provision_s)]
                    * (act.target - in_flight)
                )
            elif act.target < in_flight:
                # cancel not-yet-ready slices first, then release active ones
                cancel = min(len(st.pending), in_flight - act.target)
                if cancel:
                    st.pending = st.pending[: len(st.pending) - cancel]
                st.n_active = min(st.n_active, max(act.target, 0))

            # --- spot tier (§VI extension): Poisson reclaim, then scale ---
            if st.n_spot > 0:
                p_reclaim = 1.0 - math.exp(-pricing.spot_preempt_rate)
                reclaimed = int(self.rng.binomial(st.n_spot, p_reclaim))
                if reclaimed:
                    st.n_spot -= reclaimed
                    res.preemptions += reclaimed
            ready_s = [r for r in st.spot_pending if r <= tick]
            st.n_spot += len(ready_s)
            st.spot_pending = [r for r in st.spot_pending if r > tick]
            spot_in_flight = st.n_spot + len(st.spot_pending)
            if act.spot_target > spot_in_flight:
                st.spot_pending.extend(
                    [tick + int(pricing.spot_provision_s)]
                    * (act.spot_target - spot_in_flight)
                )
            elif act.spot_target < spot_in_flight:
                cancel = min(len(st.spot_pending), spot_in_flight - act.spot_target)
                if cancel:
                    st.spot_pending = st.spot_pending[: len(st.spot_pending) - cancel]
                st.n_spot = min(st.n_spot, max(act.spot_target, 0))

            # serve from queues, strict first
            capacity = (st.n_active + st.n_spot) * st.throughput
            served = 0.0
            for cls in ("strict", "relaxed"):
                take = st.queues[cls].pop(capacity - served)
                for t0, cnt in take:
                    if tick - t0 > st.slack[cls]:
                        res.violations += cnt
                        if cls == "strict":
                            res.violations_strict += cnt
                    served += cnt
                    res.served_vm += cnt
            st.last_util = served / capacity if capacity > 0 else 1.0

            # offload decision (see engine._step for the mode semantics).
            # Only the pool-warming FIRST invocation of a cold batch pays
            # the cold start; the rest of the batch hits the warm pool.
            if act.offload in ("blind", "slack_aware"):
                classes = ("strict", "relaxed") if act.offload == "blind" else ("strict",)
                for cls in classes:
                    slo = STRICT.slo_s if cls == "strict" else RELAXED.slo_s
                    offl = st.queues[cls].pop_older_than(tick, -1)
                    if offl <= 0:
                        continue
                    blat_first = st.burst_latency(tick)
                    blat_warm = pricing.burst_spinup_s + st.lat_b1
                    st.burst_last_used = tick
                    res.cost_burst += st.burst_per_req * offl
                    res.served_burst += offl
                    first = min(offl, 1.0)
                    viol = first * (blat_first > slo) + (offl - first) * (
                        blat_warm > slo
                    )
                    if viol > 0:
                        res.violations += viol
                        if cls == "strict":
                            res.violations_strict += viol

            # abandon hopeless VM-only waiters (count violation once)
            for cls in ("strict", "relaxed"):
                slo = STRICT.slo_s if cls == "strict" else RELAXED.slo_s
                dropped = st.queues[cls].pop_older_than(tick, int(3 * slo))
                if dropped > 0:
                    res.violations += dropped
                    if cls == "strict":
                        res.violations_strict += dropped
                    res.served_vm += dropped   # still answered, just very late

            # accounting
            chips = st.n_active * st.prof.chips
            spot_chips = st.n_spot * st.prof.chips
            res.cost_reserved += chips * pricing.reserved_chip_s
            res.cost_spot += (
                spot_chips * pricing.reserved_chip_s * pricing.spot_discount
            )
            res.chip_seconds += chips + spot_chips
            need = math.ceil(obs[arch].rate / st.throughput) * st.prof.chips
            res.chip_seconds_needed += need
            res.chip_seconds_over += max(0, chips + spot_chips - need)

        self.tick += 1
        if self.done:
            self._finalize()
        return {
            "cost": res.cost_total - cost0,
            "violations": res.violations - viol0,
        }

    def _finalize(self) -> None:
        # end-of-trace: whatever is still queued past its slack violates
        for st in self.states.values():
            for cls in ("strict", "relaxed"):
                late = st.queues[cls].pop_older_than(len(self.trace), st.slack[cls])
                self.res.violations += late
                if cls == "strict":
                    self.res.violations_strict += late


def simulate_reference(
    trace: np.ndarray,
    workload: List[ArchLoad],
    policy: Policy,
    *,
    pricing: FleetPricing = PRICING,
    prewarm: bool = True,
    warm_start: bool = True,
) -> SimResult:
    """Closed-loop run of the reference per-arch loop."""
    sim = ReferenceSim(
        trace, workload, pricing=pricing, prewarm=prewarm, warm_start=warm_start
    )
    while not sim.done:
        obs = sim.observe()
        sim.apply(policy(sim.tick, obs))
    return sim.res
