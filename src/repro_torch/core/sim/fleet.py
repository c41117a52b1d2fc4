"""Resource tiers — the procurement side of the serving fleet.

The paper's system buys capacity from heterogeneous cloud offerings —
its "confounding array of resource types": long-lived reserved slices
(VMs), preemptible spot slices (§VI), deeply-discounted harvest VMs
whose availability follows a pool-correlated signal, a second reserved
region behind a network-egress adder, and a per-invocation burst pool
(serverless functions).  Each offering is one :class:`ResourceTier`: it
owns its pool-wide instance counts as arrays, runs its provisioning
pipeline each tick, and knows its price.  Adding a new offering is one
subclass — the engine only speaks the tier interface
(:class:`HarvestVMTier` and :class:`MultiRegionReservedTier` are
exactly that: zero engine-tick-loop changes beyond registration).

All state is structure-of-arrays over the pool: ``active[a]`` instances
per arch, and a :class:`ProvisionPipeline` ring buffer of launches in
flight, so a tick is O(A) NumPy work regardless of pool size.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.hardware import FleetPricing
from repro_torch.core.sim.accounting import Ledger

# ---------------------------------------------------------------------------
# Explicit randomness for tier-internal events.
#
# The stochastic tiers (spot reclaims, the harvest signal) draw from
# *tier-owned seeded streams whose position is a pure function of the
# tick index*, never from shared engine RNG state.  That makes every
# random trajectory reproducible from ``(seed, tick)`` alone, so the
# batched torch engine (``sim/torch_engine.py``) can precompute the exact
# same draws host-side and stay in lockstep with this engine — reclaim
# for reclaim — instead of only matching in distribution.
# ---------------------------------------------------------------------------

#: shared cap on the inverse-CDF walk in :func:`binomial_from_uniform`.
#: Both the NumPy and the torch twin stop after this many CDF terms, so the
#: two implementations return identical counts for identical uniforms.
#: 64 is > mean + 8 sigma for every reclaim regime the simulator uses
#: (p = 1 - exp(-1/1800) at fleet sizes, p = 0.05 in the stress tests).
BINOMIAL_KMAX = 64

_SPOT_STREAM_TAG = 0x5907  # domain-separates the spot uniform stream


def binomial_from_uniform(n: np.ndarray, p: float, u: np.ndarray) -> np.ndarray:
    """Exact inverse-CDF Binomial(n, p) sample from one uniform per row.

    Deterministic given ``u``: walks the CDF with the pmf recurrence
    ``pmf(k+1) = pmf(k) * (n-k)/(k+1) * p/(1-p)`` and returns the number
    of CDF terms <= u, capped at :data:`BINOMIAL_KMAX` (and at ``n``).
    ``p >= 1`` returns ``n`` exactly, ``p <= 0`` returns zeros — the
    degenerate cases the tier tests pin must not depend on float walks.
    """
    n = np.asarray(n, dtype=np.int64)
    if p <= 0.0:
        return np.zeros_like(n)
    if p >= 1.0:
        return n.copy()
    u = np.asarray(u, dtype=np.float64)
    nf = n.astype(np.float64)
    q = 1.0 - p
    pmf = q ** nf                       # P(X = 0)
    cdf = pmf.copy()
    k = (u >= cdf).astype(np.int64)
    for j in range(1, BINOMIAL_KMAX + 1):
        still = u >= cdf
        if not still.any():
            break
        pmf = np.maximum(pmf * ((nf - (j - 1)) / j) * (p / q), 0.0)
        cdf = cdf + pmf
        k += (u >= cdf).astype(np.int64)
    return np.minimum(k, n)


def spot_uniform_stream(seed: int) -> np.random.Generator:
    """The seeded stream behind a :class:`SpotTier`'s reclaim draws."""
    return np.random.default_rng((_SPOT_STREAM_TAG, seed))


def spot_reclaim_uniforms(seed: int, ticks: int, n_archs: int) -> np.ndarray:
    """Precompute the ``[ticks, 2, n_archs]`` uniform schedule a
    :class:`SpotTier` with this seed consumes: slot 0 drives the active
    reclaim draw, slot 1 the in-flight (pipeline) one.  A single bulk
    ``random()`` fill is bitwise-identical to the tier's one-draw-per-tick
    consumption of the same stream."""
    return spot_uniform_stream(seed).random((ticks, 2, n_archs))


def harvest_level_trajectory(
    seed: int, ticks: int, *, level0: float = 1.0,
) -> np.ndarray:
    """Precompute ``ticks`` steps of the harvest availability signal.

    ``out[t]`` is the level a :class:`HarvestVMTier` with this seed holds
    *during* engine tick ``t`` (after its per-tick advance), replayed
    from the same seeded stream — the signal is a pure function of time,
    so the batched engine materializes it host-side."""
    rng = np.random.default_rng(seed + 0x9A27)
    noise = rng.standard_normal(ticks)
    out = np.empty(ticks, dtype=np.float64)
    level = level0
    for t in range(ticks):
        level = float(np.clip(
            level
            + HarvestVMTier.LEVEL_KAPPA * (HarvestVMTier.LEVEL_MEAN - level)
            + HarvestVMTier.LEVEL_SIGMA * noise[t],
            HarvestVMTier.LEVEL_MIN, 1.0,
        ))
        out[t] = level
    return out


# ---------------------------------------------------------------------------
# Fixed-latency provisioning pipeline, vectorized over the pool.
# ---------------------------------------------------------------------------
class ProvisionPipeline:
    """Launches become ready exactly ``latency_s`` ticks later.

    ``buf[a, t % L]`` counts instances arch ``a`` launched at tick ``t``;
    cancellations remove the *newest* launches first (matching the seed
    semantics: not-yet-ready slices are cancelled before active ones are
    released).
    """

    def __init__(self, n_archs: int, latency_s: float):
        self.lat = max(int(latency_s), 1)
        self.buf = np.zeros((n_archs, self.lat), dtype=np.int64)
        self.total = np.zeros(n_archs, dtype=np.int64)

    def pop_ready(self, tick: int) -> np.ndarray:
        """Instances launched ``lat`` ticks ago come online now."""
        col = tick % self.lat
        ready = self.buf[:, col].copy()
        self.buf[:, col] = 0
        self.total -= ready
        return ready

    def launch(self, tick: int, counts: np.ndarray) -> None:
        self.buf[:, tick % self.lat] += counts
        self.total += counts

    def cancel_newest(self, tick: int, counts: np.ndarray) -> None:
        """Cancel up to ``counts[a]`` in-flight launches, newest first."""
        launch_ticks = np.arange(tick, tick - self.lat, -1)   # newest -> oldest
        idx = launch_ticks % self.lat
        pending = self.buf[:, idx]
        before = np.cumsum(pending, axis=1) - pending
        take = np.minimum(pending, np.clip(counts[:, None] - before, 0, None))
        self.buf[:, idx] = pending - take
        self.total -= take.sum(axis=1)


# ---------------------------------------------------------------------------
# Model-variant swap pipeline (INFaaS-style runtime variant switching).
# ---------------------------------------------------------------------------
class SwapPipeline:
    """Variant swaps in flight, vectorized over the pool.

    A swap requested at tick ``t`` becomes effective at ``t + lat``; the
    arch keeps serving (and billing) at the **old** variant until then —
    the weight reload occupies the held slices, like a provisioning
    pipeline occupies the lead time.  At most one swap per arch is in
    flight; semantics mirror provisioning's cancel-newest-first:

    * a request for a *different* target replaces the in-flight swap and
      restarts the clock (the newest decision wins, the not-yet-ready
      one is cancelled);
    * re-requesting the in-flight target leaves its clock alone;
    * re-requesting the *current* variant cancels the in-flight swap
      outright (nothing ever becomes ready).
    """

    def __init__(self, current: np.ndarray, latency_s: float):
        self.lat = max(int(latency_s), 1)
        self.current = np.asarray(current, dtype=np.int64).copy()
        n = len(self.current)
        self.pending = np.full(n, -1, dtype=np.int64)
        self.ready_at = np.zeros(n, dtype=np.int64)
        self.completed = 0                     # lifetime swap count

    @property
    def in_flight(self) -> np.ndarray:
        return self.pending >= 0

    def pop_ready(self, tick: int) -> np.ndarray:
        """Complete due swaps; returns the boolean completion mask."""
        done = (self.pending >= 0) & (self.ready_at <= tick)
        if done.any():
            self.current[done] = self.pending[done]
            self.pending[done] = -1
            self.completed += int(done.sum())
        return done

    def request(self, tick: int, target: np.ndarray) -> np.ndarray:
        """Apply per-arch swap requests (``target[a] = -1`` means hold);
        returns the boolean mask of swaps that newly entered the
        pipeline (telemetry's swap-request events)."""
        t = np.asarray(target, dtype=np.int64)
        cancel = (t >= 0) & (t == self.current)
        self.pending[cancel] = -1
        start = (t >= 0) & (t != self.current) & (t != self.pending)
        if start.any():
            self.pending[start] = t[start]
            self.ready_at[start] = tick + self.lat
        return start


# ---------------------------------------------------------------------------
# Tier base: reserved (on-demand) slices.
# ---------------------------------------------------------------------------
class ResourceTier:
    """A pool of slices with a provisioning pipeline and a price.

    Tick protocol (driven by the engine):
      ``begin_tick``  — tier-internal events (e.g. spot reclaims)
      ``set_target``  — provisioning: admit ready launches, then grow or
                        shrink toward the policy's per-arch target
      ``account``     — bill this tick's held capacity into the ledger
    """

    name = "reserved"

    #: optional :class:`~repro_torch.core.sim.telemetry.Telemetry` hook the
    #: engine attaches; ``None`` (the default) keeps every tick on the
    #: pre-telemetry fast path
    telemetry = None

    def __init__(self, n_archs: int, pricing: FleetPricing):
        self.pricing = pricing
        self.active = np.zeros(n_archs, dtype=np.int64)
        self.pipeline = ProvisionPipeline(n_archs, self.provision_latency_s())

    # -- per-tier knobs ------------------------------------------------------
    def provision_latency_s(self) -> float:
        return self.pricing.reserved_provision_s

    def price_per_chip_s(self) -> float:
        return self.pricing.reserved_chip_s

    def egress_latency_s(self) -> float:
        """Per-request latency adder for capacity served from this tier
        (0 for in-region tiers; the engine serves strict-class traffic
        from zero-egress capacity first)."""
        return 0.0

    # -- tick protocol -------------------------------------------------------
    def begin_tick(self, tick: int, rng: np.random.Generator, ledger: Ledger) -> None:
        """Tier-internal events before provisioning (default: none)."""

    def idle_tick(self, tick: int) -> None:
        """Called on ticks the tier is neither held nor targeted, so
        provider-side state (e.g. an availability signal) keeps evolving
        as a function of time, not of usage history (default: none)."""

    def set_target(self, tick: int, target: np.ndarray) -> None:
        tel = self.telemetry
        ready = self.pipeline.pop_ready(tick)
        self.active += ready
        in_flight = self.active + self.pipeline.total
        grow = np.maximum(target - in_flight, 0)
        if grow.any():
            self.pipeline.launch(tick, grow)
        shrink = in_flight - target
        cancel = released = None
        if (shrink > 0).any():
            cancel = np.clip(np.minimum(self.pipeline.total, shrink), 0, None)
            if cancel.any():
                self.pipeline.cancel_newest(tick, cancel)
            active = np.where(
                shrink > 0,
                np.minimum(self.active, np.maximum(target, 0)),
                self.active,
            )
            if tel is not None:
                released = self.active - active
            self.active = active
        if tel is not None:
            tel.on_provision(tick, self.name, ready, grow, cancel, released)

    def account(self, ledger: Ledger, chips_per_instance: np.ndarray) -> np.ndarray:
        """Bill held capacity; returns this tier's chip-seconds per arch."""
        chip_s = self.active * chips_per_instance
        ledger.add_tier_cost(self.name, float(chip_s.sum()) * self.price_per_chip_s())
        return chip_s

    @property
    def pending_total(self) -> np.ndarray:
        return self.pipeline.total


# ---------------------------------------------------------------------------
# Spot tier: cheap, preemptible (paper §VI future work, implemented).
# ---------------------------------------------------------------------------
class SpotTier(ResourceTier):
    """Reclaim draws come from a tier-owned seeded uniform stream that
    advances exactly one ``[2, A]`` block per engine tick (``begin_tick``
    while engaged, ``idle_tick`` otherwise), so the uniforms consumed at
    tick ``t`` are a pure function of ``(seed, t)`` — the batched torch
    engine precomputes the identical schedule with
    :func:`spot_reclaim_uniforms` and reproduces reclaims exactly.  The
    ``rng`` argument of ``begin_tick`` is part of the tier protocol but
    unused here."""

    name = "spot"

    def __init__(self, n_archs: int, pricing: FleetPricing, seed: int = 0):
        super().__init__(n_archs, pricing)
        self._u_rng = spot_uniform_stream(seed)

    def provision_latency_s(self) -> float:
        return self.pricing.spot_provision_s

    def price_per_chip_s(self) -> float:
        return self.pricing.reserved_chip_s * self.pricing.spot_discount

    def reclaim_probability(self) -> float:
        """Per-instance per-tick reclaim probability (policy observable)."""
        return 1.0 - math.exp(-self.pricing.spot_preempt_rate)

    def idle_tick(self, tick: int) -> None:
        # keep the stream position a function of the tick, not of usage
        self._u_rng.random((2, len(self.active)))

    def begin_tick(self, tick: int, rng: np.random.Generator, ledger: Ledger) -> None:
        p_reclaim = self.reclaim_probability()
        u = self._u_rng.random((2, len(self.active)))
        if self.active.any():
            reclaimed = binomial_from_uniform(self.active, p_reclaim, u[0])
            self.active -= reclaimed
            ledger.add_preemptions(int(reclaimed.sum()))
            if self.telemetry is not None:
                self.telemetry.on_reclaim(
                    tick, "spot_reclaim", self.name, reclaimed)
        if self.pipeline.total.any():
            # in-flight launches are NOT immune: the provider reclaims
            # provisioning slices at the same rate, so a policy cannot
            # hide capacity in the pipeline through a reclaim wave.  The
            # loss is drawn on the per-arch in-flight total and lands on
            # the newest launches first (the ones a same-tick reprovision
            # would re-request anyway).
            lost = binomial_from_uniform(self.pipeline.total, p_reclaim, u[1])
            self.pipeline.cancel_newest(tick, lost)
            ledger.add_preemptions(int(lost.sum()))
            if self.telemetry is not None:
                self.telemetry.on_reclaim(
                    tick, "spot_reclaim_pending", self.name, lost)


# ---------------------------------------------------------------------------
# Harvest-VM tier: spare capacity carved from running hosts — the deepest
# discount, but availability follows a pool-correlated harvest signal.
# ---------------------------------------------------------------------------
class HarvestVMTier(ResourceTier):
    """Deeply discounted instances built from harvested spare capacity.

    The provider's harvestable capacity is a seeded mean-reverting signal
    ``level(t)`` in ``[LEVEL_MIN, 1]`` shared by the whole pool: each arch
    may hold at most ``floor(level x harvest_cap_per_arch)`` instances,
    and when the signal drops, every arch's excess above the new ceiling
    is evicted in the same tick — reclaims are *correlated across the
    pool* (the datacenter got busy), unlike the spot tier's i.i.d.
    per-instance draws.  The signal advances exactly once per engine
    tick (``begin_tick`` while the tier is engaged, ``idle_tick``
    otherwise) from the tier's own seeded generator, so the trajectory
    is a pure function of time — deterministic, independent of both the
    engine's spot-reclaim stream and of which policy happens to use the
    tier.
    """

    name = "harvest"

    LEVEL_MIN = 0.25               # deepest harvest trough
    LEVEL_MEAN = 0.85              # long-run availability
    LEVEL_KAPPA = 0.02             # mean reversion per tick
    LEVEL_SIGMA = 0.03             # per-tick signal noise

    def __init__(self, n_archs: int, pricing: FleetPricing, seed: int = 0):
        super().__init__(n_archs, pricing)
        self.level = 1.0
        self._sig_rng = np.random.default_rng(seed + 0x9A27)

    def provision_latency_s(self) -> float:
        return self.pricing.harvest_provision_s

    def price_per_chip_s(self) -> float:
        return self.pricing.reserved_chip_s * self.pricing.harvest_discount

    def ceiling(self) -> int:
        """Per-arch instance ceiling at the current harvest level."""
        return int(self.level * self.pricing.harvest_cap_per_arch)

    def _advance(self) -> None:
        self.level = float(np.clip(
            self.level
            + self.LEVEL_KAPPA * (self.LEVEL_MEAN - self.level)
            + self.LEVEL_SIGMA * self._sig_rng.standard_normal(),
            self.LEVEL_MIN, 1.0,
        ))

    def idle_tick(self, tick: int) -> None:
        self._advance()

    def begin_tick(self, tick: int, rng: np.random.Generator, ledger: Ledger) -> None:
        self._advance()
        ceiling = self.ceiling()
        evicted = np.maximum(self.active - ceiling, 0)
        if evicted.any():
            self.active -= evicted
            ledger.add_preemptions(int(evicted.sum()))
            if self.telemetry is not None:
                self.telemetry.on_reclaim(
                    tick, "harvest_evict", self.name, evicted)
        # in-flight launches above the remaining room never materialize
        # (cancelled, not evicted: they were never running)
        over = np.maximum(self.active + self.pipeline.total - ceiling, 0)
        if over.any():
            self.pipeline.cancel_newest(tick, over)
            if self.telemetry is not None:
                self.telemetry.on_reclaim(
                    tick, "harvest_cancel", self.name, over)

    def set_target(self, tick: int, target: np.ndarray) -> None:
        # the provider only grants capacity under the harvested ceiling
        super().set_target(tick, np.minimum(target, self.ceiling()))


# ---------------------------------------------------------------------------
# Multi-region reserved tier: a second reserved pool, cheaper but farther.
# ---------------------------------------------------------------------------
class MultiRegionReservedTier(ResourceTier):
    """Reserved slices in a second region: same reliability, a discount,
    a much longer slice-acquisition latency, and a per-request network
    egress adder on everything it serves — which is why the engine serves
    strict-class traffic from local (zero-egress) capacity first."""

    name = "remote"

    def provision_latency_s(self) -> float:
        return self.pricing.remote_provision_s

    def price_per_chip_s(self) -> float:
        return self.pricing.reserved_chip_s * self.pricing.remote_discount

    def egress_latency_s(self) -> float:
        return self.pricing.remote_egress_s


# ---------------------------------------------------------------------------
# Burst tier: per-invocation serverless pool (no instances held).
# ---------------------------------------------------------------------------
class BurstTier:
    """The serverless analog: requests offloaded here never queue — they
    pay a premium per invocation and a spin-up (plus cold-start when the
    pool has not seen the model within the idle timeout)."""

    name = "burst"

    #: optional telemetry hook, attached by the engine (see ResourceTier)
    telemetry = None

    def __init__(
        self,
        pricing: FleetPricing,
        lat_b1: np.ndarray,            # batch-1 model latency per arch
        cold_start_s: np.ndarray,      # weight-fetch cold start per arch
        cost_per_request: np.ndarray,  # provider-batched billing per arch
        prewarm: bool,
    ):
        n = len(lat_b1)
        self.pricing = pricing
        self.lat_b1 = np.asarray(lat_b1, dtype=np.float64)
        self.cold_start_s = np.asarray(cold_start_s, dtype=np.float64)
        self.cost_per_request = np.asarray(cost_per_request, dtype=np.float64)
        self.last_used = np.zeros(n) if prewarm else np.full(n, -math.inf)

    def latency(self, tick: int) -> np.ndarray:
        """Latency the *first* invocation of the tick observes (the
        pool-warming one; followers in the same tick hit a warm pool)."""
        cold = (tick - self.last_used) > self.pricing.burst_idle_timeout_s
        return self.pricing.burst_spinup_s + self.lat_b1 + cold * self.cold_start_s

    def offload(
        self, tick: int, counts: np.ndarray, slo_s: float, strict: bool,
        ledger: Ledger,
    ) -> np.ndarray:
        """Send ``counts[a]`` requests to the burst pool right now;
        returns the per-arch violation counts (requests whose burst
        latency exceeded the class SLO).

        Only the pool-warming FIRST invocation of a cold batch pays
        ``cold_start_s`` — every request after it in the same tick hits
        the pool it just warmed (the idle timeout is minutes, not
        sub-second), so a cold batch of N violates at most 1 + the warm
        late mass, not N."""
        lat_first = self.latency(tick)
        lat_warm = self.pricing.burst_spinup_s + self.lat_b1
        first = np.minimum(counts, 1.0)
        viol = first * (lat_first > slo_s) + (counts - first) * (lat_warm > slo_s)
        cost_vec = self.cost_per_request * counts
        ledger.add_burst(
            cost=float(cost_vec.sum()),
            served=float(counts.sum()),
            violations=float(viol.sum()),
            strict=strict,
        )
        if self.telemetry is not None:
            cold = (tick - self.last_used) > self.pricing.burst_idle_timeout_s
            self.telemetry.on_cold_start(tick, cold & (counts > 0))
            self.telemetry.on_burst(tick, strict, counts, viol, cost_vec)
        self.last_used = np.where(counts > 0, float(tick), self.last_used)
        return viol
