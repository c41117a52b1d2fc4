"""The tick engine: admit -> provision -> serve -> offload -> drop -> account.

Time-stepped fluid simulation at 1 s ticks (paper §II-C / §IV
methodology): trace-driven arrivals fan out over a model pool, each
(arch, latency-class) pair keeps an age-bucketed FIFO queue
(:mod:`repro_torch.core.sim.queues`), resource tiers serve at their profiled
throughput (:mod:`repro_torch.core.sim.fleet` — reserved / spot / harvest /
remote behind one interface, driven by generic provision / serve /
account loops; strict-class traffic is served from zero-egress local
capacity first), and a procurement policy decides — every tick — the
per-tier fleet targets and which queued requests to offload to burst
instances.  Metrics accumulate in the ledger
(:mod:`repro_torch.core.sim.accounting`), tier costs keyed by tier name.

All pool state is structure-of-arrays, so one tick costs O(A) NumPy work
however many architectures the pool holds; a 64-arch 24 h trace runs in
seconds.  Policies can speak either interface:

* the legacy dict form — ``observe() -> {arch: ArchObs}``,
  ``apply({arch: Action})`` — unchanged from the seed simulator;
* the vectorized form — ``observe_pool() -> PoolObs``,
  ``apply_pool(PoolAction)`` — arrays end-to-end, used by the
  ``Vector*`` schedulers on large pools.

Arrivals come in two shapes (``trace`` argument):

* a 1-D ``[T]`` pool trace — every arch sees ``share x trace`` (the
  seed behavior); the load monitor exploits the shared shape and scales
  precomputed pool statistics by share;
* a 2-D ``[A, T]`` arrival matrix (:mod:`repro_torch.core.workloads`) — each
  arch has its own stream, and a vectorized streaming per-arch monitor
  (:class:`~repro_torch.core.load_monitor.PoolLoadMonitor`) computes
  ``PoolObs.ewma_rate / window_peak / peak_to_median`` per arch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.hardware import PRICING, FleetPricing
from repro_torch.core.load_monitor import LoadMonitor, PoolLoadMonitor
from repro_torch.core.profiles import ModelProfile, get_profile
from repro_torch.core.sim.accounting import Ledger, SimResult
from repro_torch.core.sim.fleet import (
    BurstTier,
    HarvestVMTier,
    MultiRegionReservedTier,
    ResourceTier,
    SpotTier,
    SwapPipeline,
)
from repro_torch.core.sim.queues import QueueArray
from repro_torch.core.sim.types import (
    OFFLOAD_MODES,
    RELAXED,
    STRICT,
    Action,
    ArchLoad,
    ArchObs,
    PoolAction,
    PoolObs,
    VariantCatalog,
    shares,
)

_OFFLOAD_CODE = {m: i for i, m in enumerate(OFFLOAD_MODES)}

# monitor parameters come from LoadMonitor so the engine's precomputed
# window statistics can never drift from the reference simulator's
MONITOR_WINDOW_S = LoadMonitor.window_s
MONITOR_EWMA_ALPHA = LoadMonitor.ewma_alpha


def _trace_window_stats(trace: np.ndarray, window: int):
    """Sliding-window peak and median of the whole trace, precomputed.

    The load monitor's window statistics depend only on the (known)
    trace, so one upfront O(T * W) pass replaces a per-tick ``np.median``
    in the hot loop.  The first ``window - 1`` ticks use growing windows,
    matching the seed :class:`~repro_torch.core.load_monitor.LoadMonitor`.
    """
    n = len(trace)
    peak = np.empty(n)
    med = np.empty(n)
    for t in range(min(window - 1, n)):
        peak[t] = trace[: t + 1].max()
        med[t] = np.median(trace[: t + 1])
    if n >= window:
        sw = np.lib.stride_tricks.sliding_window_view(trace, window)
        for s in range(0, len(sw), 8192):   # chunk: bounds partition scratch
            blk = sw[s: s + 8192]
            peak[window - 1 + s: window - 1 + s + len(blk)] = blk.max(axis=1)
            med[window - 1 + s: window - 1 + s + len(blk)] = np.median(blk, axis=1)
    return peak, med


# ---------------------------------------------------------------------------
# Per-arch compatibility views over the SoA state.
# ---------------------------------------------------------------------------
class _QueueView:
    """Scalar window into one arch's row of a :class:`QueueArray`."""

    __slots__ = ("_q", "_i")

    def __init__(self, q: QueueArray, i: int):
        self._q, self._i = q, i

    @property
    def total(self) -> float:
        return float(self._q.buf[self._i].sum())

    def __len__(self) -> int:
        return int(self.total)


class _MonitorView:
    """Per-arch window into the engine's materialized monitor vectors
    (shared-trace runs: share x pool statistics; matrix runs: the
    streaming per-arch monitor's own statistics)."""

    __slots__ = ("_sim", "_i")

    def __init__(self, sim: "ServingSim", i: int):
        self._sim, self._i = sim, i

    @property
    def rate(self) -> float:
        return float(self._sim._ewma_vec[self._i])

    @property
    def peak(self) -> float:
        return float(self._sim._peak_vec[self._i])

    @property
    def peak_to_median(self) -> float:
        return float(self._sim._p2m_vec[self._i])


class ArchView:
    """Read view of one arch's slice of the engine state — what the seed
    simulator called ``_ArchState``.  Kept so stepwise drivers (the RL
    env) can keep reading per-arch fields."""

    def __init__(self, sim: "ServingSim", i: int, load: ArchLoad,
                 prof: ModelProfile):
        self._sim, self._i = sim, i
        self.load = load
        self.prof = prof
        self.queues = {
            "strict": _QueueView(sim.q_strict, i),
            "relaxed": _QueueView(sim.q_relaxed, i),
        }
        self.monitor = _MonitorView(sim, i)

    @property
    def throughput(self) -> float:
        return float(self._sim.eff_throughput[self._i])

    @property
    def n_active(self) -> int:
        return int(self._sim.reserved.active[self._i])

    @property
    def n_spot(self) -> int:
        return int(self._sim.spot.active[self._i])

    @property
    def n_pending(self) -> int:
        return int(self._sim.reserved.pending_total[self._i])

    @property
    def slack(self) -> Dict[str, int]:
        return {
            "strict": int(self._sim.q_strict.slack[self._i]),
            "relaxed": int(self._sim.q_relaxed.slack[self._i]),
        }


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
class ServingSim:
    """Stepwise serving simulator: ``observe() -> actions -> apply()``."""

    def __init__(
        self,
        trace: np.ndarray,                 # [T] pool trace or [A, T] matrix
        workload: List[ArchLoad],
        *,
        pricing: FleetPricing = PRICING,
        prewarm: bool = True,
        warm_start: bool = True,
        seed: int = 0,
        catalog: Optional[VariantCatalog] = None,
        telemetry: Optional["Telemetry"] = None,
    ):
        arr = np.asarray(trace, dtype=np.float64)
        self.pricing = pricing
        # tier-protocol generator (the stochastic tiers own per-tick
        # seeded streams instead — see sim/fleet.py)
        self.rng = np.random.default_rng(seed)
        self.tick = 0

        keys = [w.key for w in workload]
        assert len(set(keys)) == len(keys), "workload keys must be unique"
        self.keys = keys
        n = len(workload)

        if arr.ndim == 2:
            assert arr.shape[0] == n, (
                f"arrival matrix has {arr.shape[0]} rows for {n} archs"
            )
            self.arrivals: Optional[np.ndarray] = arr   # [A, T]
            self.trace = arr.sum(axis=0)                # pooled view
        else:
            self.arrivals = None
            self.trace = arr

        profs = [get_profile(w.arch, req=STRICT) for w in workload]
        self.share = shares(workload)
        self.strict_frac = np.array([w.strict_frac for w in workload])
        self.throughput = np.array([p.throughput(STRICT) for p in profs])
        for w, thr in zip(workload, self.throughput):
            assert thr > 0, f"{w.arch} cannot meet the strict SLO"
        self.chips = np.array([p.chips for p in profs], dtype=np.float64)
        lat_b1 = np.array([p.request_latency(STRICT, 1) for p in profs])
        self.lat_b1 = lat_b1

        # model-variant axis: each arch serves its *active* variant's
        # service rate / chip footprint / accuracy, and burst invocations
        # observe its batch-1 latency; without a catalog the arch is its
        # own sole variant (multipliers 1.0 — bit-identical to the
        # variant-blind engine).  Queue slack stays pinned to the base
        # variant's batch-1 latency: it encodes the stream's SLO
        # geometry, not the deployed weights.
        self.acc_floor = np.array([w.min_accuracy for w in workload])
        if catalog is None:
            self.var_acc = np.array([[p.cfg.quality] for p in profs])
            self.var_smult = np.ones((n, 1))
            self.var_cmult = np.ones((n, 1))
            self.var_lmult = np.ones((n, 1))
            self.var_n = np.ones(n, dtype=np.int64)
            base_idx = np.zeros(n, dtype=np.int64)
            self.var_lo = np.zeros(n, dtype=np.int64)
            self.var_cheapest = np.zeros(n, dtype=np.int64)
        else:
            va = catalog.as_arrays(workload)
            self.var_acc = va["accuracy"]
            self.var_smult = va["service_mult"]
            self.var_cmult = va["cost_mult"]
            self.var_lmult = va["lat_mult"]
            self.var_n = va["n_variants"]
            base_idx = va["base_idx"]
            self.var_lo = va["floor_lo"]
            self.var_cheapest = va["floor_cheapest"]
        self.catalog = catalog
        self.swap = SwapPipeline(base_idx, pricing.variant_swap_s)

        # class queues: slack = SLO minus the batch-1 model latency
        slack_strict = np.maximum(0, (STRICT.slo_s - lat_b1).astype(np.int64))
        slack_relaxed = np.maximum(0, (RELAXED.slo_s - lat_b1).astype(np.int64))
        self.q_strict = QueueArray(n, STRICT.slo_s, slack_strict)
        self.q_relaxed = QueueArray(n, RELAXED.slo_s, slack_relaxed)

        # resource tiers: reserved / spot / harvest / remote slices serve
        # the queues; the burst pool absorbs offloads per-invocation.
        # The engine only speaks the ResourceTier interface — a new
        # offering registers in ``aux_tiers`` below and the generic
        # provision / serve / account loops drive it.
        self.reserved = ResourceTier(n, pricing)
        self.spot = SpotTier(n, pricing, seed=seed)
        self.harvest = HarvestVMTier(n, pricing, seed=seed)
        self.remote = MultiRegionReservedTier(n, pricing)
        #: policy-targetable tiers beyond reserved, keyed by action field
        self.aux_tiers: Dict[str, ResourceTier] = {
            "spot": self.spot, "harvest": self.harvest, "remote": self.remote,
        }
        # lazily-activated: an untargeted tier costs nothing per tick
        self._tier_live: Dict[str, bool] = {k: False for k in self.aux_tiers}
        # local (zero-egress) capacity serves strict-class traffic first;
        # remote-group capacity pays its egress adder on lateness.  Both
        # groups are derived from the tier interface, so a new tier
        # lands in the right serve group by registration alone.
        self._remote_group = [
            t for t in (self.reserved, *self.aux_tiers.values())
            if t.egress_latency_s() > 0
        ]
        self._local_aux = [
            t for t in self.aux_tiers.values() if t.egress_latency_s() == 0
        ]
        self.burst = BurstTier(
            pricing,
            lat_b1=lat_b1,
            cold_start_s=np.array([p.cold_start_s() for p in profs]),
            cost_per_request=(
                self.chips / self.throughput
            ) * pricing.burst_chip_s + pricing.burst_invocation_fee,
            prewarm=prewarm,
        )

        # effective (active-variant) serving state; with every arch on its
        # base variant this is exactly the base state (multipliers 1.0)
        self._refresh_variant_state()
        # single-variant world: the variant observation never changes, so
        # one read-only record serves every tick (keeps the seed fast
        # path free of per-tick copies/gathers for the new fields)
        self._variants_live = self.var_smult.shape[1] > 1
        if not self._variants_live:
            ones = np.ones(n)
            statics = {
                "active_variant": self.swap.current,
                "n_variants": self.var_n,
                "accuracy": self.cur_acc,
                "accuracy_floor": self.acc_floor,
                "variant_lo": self.var_lo,
                "variant_cheapest": self.var_cheapest,
                "variant_in_flight": np.zeros(n, dtype=bool),
                "variant_up_ratio": ones,
                "variant_down_ratio": ones,
                "variant_pending_ratio": ones,
            }
            for a in statics.values():
                a.setflags(write=False)
            self._static_variant_obs = statics
        # floor-free streams cannot violate the accuracy SLO — skip the
        # per-tick comparison and share one read-only zero marginal
        self._acc_floor_live = bool((self.acc_floor > 0).any())
        self._zero_arch = np.zeros(n)
        self._zero_arch.setflags(write=False)

        self.ledger = Ledger()
        self.last_util = np.zeros(n)
        self._ewma: Optional[float] = None
        if self.arrivals is None:
            # shared trace: every arch is share x pool, so the window
            # statistics are one precomputed pool pass scaled by share
            self._wpeak, self._wmed = _trace_window_stats(
                self.trace, MONITOR_WINDOW_S
            )
            self.pool_monitor: Optional[PoolLoadMonitor] = None
        else:
            # heterogeneous streams: per-arch streaming monitor
            self._wpeak = self._wmed = None
            self.pool_monitor = PoolLoadMonitor(n)
        # materialized per-arch monitor vectors (what policies see)
        self._ewma_vec = np.zeros(n)
        self._peak_vec = np.zeros(n)
        self._p2m_vec = np.ones(n)
        self._rates = np.zeros(n)
        self._pool_obs: Optional[PoolObs] = None

        # tier-portfolio observation state: idle tiers share precomputed
        # read-only records (the common reserved-only tick stays O(A)
        # with no extra copies); live tiers overwrite their entries
        zeros_i = np.zeros(n, dtype=np.int64)
        zeros_i.setflags(write=False)
        risk = np.full(n, self.spot.reclaim_probability())
        risk.setflags(write=False)
        self._static_tier_obs = {
            "n_spot_pending": zeros_i,
            "n_harvest": zeros_i, "n_harvest_pending": zeros_i,
            "n_remote": zeros_i, "n_remote_pending": zeros_i,
            "spot_reclaim_risk": risk,
        }
        # remote-group capacity books lateness against an egress-tightened
        # slack (which may be negative: egress alone can blow the SLO)
        egress = max(
            (t.egress_latency_s() for t in self._remote_group), default=0.0
        )
        self._remote_late_strict = self.q_strict.late_mask_for(
            np.floor(STRICT.slo_s - lat_b1 - egress)
        )
        self._remote_late_relaxed = self.q_relaxed.late_mask_for(
            np.floor(RELAXED.slo_s - lat_b1 - egress)
        )

        # hot-path observation buffers: observe_pool refills these in
        # place every tick instead of allocating fresh [A] vectors, so
        # the telemetry-disabled tick allocates no obs arrays even at
        # fleet scale (A=256+).  The PoolObs contract is unchanged in
        # practice: a returned observation is stable until the *next*
        # observe_pool call; consumers that keep values across ticks
        # copy fields out (env._prev_rate does).
        self._share_pos = self.share > 0
        self._nstrict_buf = np.zeros(n)
        self._nrelaxed_buf = np.zeros(n)
        self._qlen_buf = np.zeros(n)
        self._qs_buf = np.zeros(n)
        self._qr_buf = np.zeros(n)
        self._nact_buf = np.zeros(n, dtype=np.int64)
        self._npend_buf = np.zeros(n, dtype=np.int64)
        self._nspot_buf = np.zeros(n, dtype=np.int64)
        self._thr_buf = np.zeros(n)
        self._util_buf = np.zeros(n)
        self._lviol_buf = np.zeros(n)
        self._harv_level_buf = np.zeros(n)
        self._harv_ceil_buf = np.zeros(n, dtype=np.int64)
        self._tier_obs_buf = {
            k: np.zeros(n, dtype=np.int64)
            for k in ("n_spot_pending", "n_harvest", "n_harvest_pending",
                      "n_remote", "n_remote_pending")
        }
        self._tobs = dict(self._static_tier_obs)
        self._tobs["harvest_level"] = self._harv_level_buf
        self._tobs["harvest_ceiling"] = self._harv_ceil_buf

        # per-arch flow accounting (arrived == served_vm + served_burst +
        # dropped + queued, every tick; `per_arch_counts` exposes copies)
        self.arrived_arch = np.zeros(n)
        self.served_vm_arch = np.zeros(n)
        self.served_burst_arch = np.zeros(n)
        self.dropped_arch = np.zeros(n)
        self.expired_end_arch = np.zeros(n)
        self.violations_arch = np.zeros(n)
        # per-arch reward surface: cumulative $ cost attributed to each
        # arch (reserved/spot by held capacity, burst by invocation) and
        # the violations booked during the previous tick — what a
        # pool-wide controller decomposes its reward from
        self.cost_arch = np.zeros(n)
        self.last_viol_arch = np.zeros(n)
        # delivered-accuracy accounting: answered mass x active-variant
        # accuracy, and the mass answered below each stream's floor
        self.acc_weight_arch = np.zeros(n)
        self.acc_viol_arch = np.zeros(n)

        self.states: Dict[str, ArchView] = {
            k: ArchView(self, i, w, p)
            for i, (k, w, p) in enumerate(zip(keys, workload, profs))
        }

        t0_rates = (
            self.trace[0] * self.share if self.arrivals is None
            else self.arrivals[:, 0]
        )
        if warm_start:
            self.reserved.active = np.maximum(
                1, np.ceil(t0_rates / self.eff_throughput)
            ).astype(np.int64)

        # observability: every emission below is gated on `telemetry is
        # not None`, so the disabled engine is bit-identical to (and as
        # fast as) the pre-telemetry one
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.bind(self)
            for tier in (self.reserved, *self.aux_tiers.values(), self.burst):
                tier.telemetry = telemetry

    # ------------------------------------------------------------------
    def _refresh_variant_state(self) -> None:
        """Re-gather the active variant's effective serving vectors.

        Called at init and whenever a swap completes (rare), so the hot
        loop reads plain ``[A]`` vectors.  On base variants every gather
        returns multiplier 1.0 and the products are bit-identical to the
        variant-blind quantities (``x * 1.0 == x`` in IEEE-754).
        """
        cur = self.swap.current[:, None]
        self.cur_acc = np.take_along_axis(self.var_acc, cur, 1)[:, 0]
        smult = np.take_along_axis(self.var_smult, cur, 1)[:, 0]
        cmult = np.take_along_axis(self.var_cmult, cur, 1)[:, 0]
        lmult = np.take_along_axis(self.var_lmult, cur, 1)[:, 0]
        self.cur_smult = smult
        self.eff_throughput = self.throughput * smult
        self.eff_chips = self.chips * cmult
        # burst invocations hit the *active* variant's warm pool: both
        # the billing and the batch-1 latency follow the swap
        self.burst.cost_per_request = (
            self.eff_chips / self.eff_throughput
        ) * self.pricing.burst_chip_s + self.pricing.burst_invocation_fee
        self.burst.lat_b1 = self.lat_b1 * lmult

    # ------------------------------------------------------------------
    @property
    def res(self) -> SimResult:
        return self.ledger.res

    @property
    def done(self) -> bool:
        return self.tick >= len(self.trace)

    # ------------------------------------------------------------------
    # Admit + observe.
    # ------------------------------------------------------------------
    def observe_pool(self) -> PoolObs:
        """Admit this tick's arrivals and return the pool observation.

        The returned ``PoolObs`` aliases per-tick buffers owned by the
        engine — valid until the next ``observe_pool`` call (every
        scheduler and the step-wise RL loop consume it within the tick;
        callers that need history copy fields out)."""
        tick = self.tick
        rates = self._rates

        if self.arrivals is None:
            rate = float(self.trace[tick])
            # load monitor, vectorized: every arch's stream is share x the
            # pool stream, so EWMA/peak/median scale by share and the
            # peak-to-median ratio is share-invariant
            self._ewma = (
                rate if self._ewma is None
                else MONITOR_EWMA_ALPHA * rate + (1 - MONITOR_EWMA_ALPHA) * self._ewma
            )
            window_peak = float(self._wpeak[tick])
            med = float(self._wmed[tick])
            p2m = window_peak / med if med > 0 else 1.0

            np.multiply(rate, self.share, out=rates)
            np.multiply(self._ewma, self.share, out=self._ewma_vec)
            np.multiply(window_peak, self.share, out=self._peak_vec)
            # zero-share rows stay at their initial 1.0 forever
            np.copyto(self._p2m_vec, p2m, where=self._share_pos)
        else:
            # heterogeneous streams: one streaming monitor update, every
            # statistic per arch (share scaling cannot express these)
            np.copyto(rates, self.arrivals[:, tick])
            self.pool_monitor.observe(rates)
            self._ewma_vec, self._peak_vec, _, self._p2m_vec = (
                self.pool_monitor.stats()
            )

        n_strict = np.multiply(rates, self.strict_frac, out=self._nstrict_buf)
        self.q_strict.push(tick, n_strict)
        self.q_relaxed.push(
            tick, np.subtract(rates, n_strict, out=self._nrelaxed_buf)
        )
        self.ledger.add_arrivals(float(rates.sum()))
        self.arrived_arch += rates
        if self.telemetry is not None:
            self.telemetry.on_arrivals(tick, rates)

        # variant observation: neighbor / in-flight service-rate ratios
        # are what swap-aware policies need to judge (and pre-provision
        # for) a move; in the single-variant world the whole record is
        # the precomputed read-only constant
        if not self._variants_live:
            vobs = self._static_variant_obs
        else:
            cur = self.swap.current
            up = np.minimum(cur + 1, self.var_n - 1)[:, None]
            dn = np.maximum(cur - 1, 0)[:, None]
            pend = self.swap.pending
            vobs = {
                "active_variant": cur.copy(),
                "n_variants": self.var_n.copy(),
                "accuracy": self.cur_acc.copy(),
                "accuracy_floor": self.acc_floor.copy(),
                "variant_lo": self.var_lo.copy(),
                "variant_cheapest": self.var_cheapest.copy(),
                "variant_in_flight": self.swap.in_flight.copy(),
                "variant_up_ratio": (
                    np.take_along_axis(self.var_smult, up, 1)[:, 0]
                    / self.cur_smult
                ),
                "variant_down_ratio": (
                    np.take_along_axis(self.var_smult, dn, 1)[:, 0]
                    / self.cur_smult
                ),
                "variant_pending_ratio": np.where(
                    pend >= 0,
                    np.take_along_axis(
                        self.var_smult, np.maximum(pend, 0)[:, None], 1
                    )[:, 0] / self.cur_smult,
                    1.0,
                ),
            }

        # tier-portfolio state: idle tiers alias the precomputed read-only
        # statics; live tiers refill their persistent buffers.  The
        # harvest signal is provider-side time-varying state, so its
        # level/ceiling are re-broadcast every tick (the signal advances
        # whether or not any policy holds harvest capacity).
        tobs = self._tobs
        self._harv_level_buf.fill(self.harvest.level)
        self._harv_ceil_buf.fill(self.harvest.ceiling())
        for obs_key, live, src in (
            ("n_spot_pending", self._tier_live["spot"],
             self.spot.pipeline.total),
            ("n_harvest", self._tier_live["harvest"], self.harvest.active),
            ("n_harvest_pending", self._tier_live["harvest"],
             self.harvest.pipeline.total),
            ("n_remote", self._tier_live["remote"], self.remote.active),
            ("n_remote_pending", self._tier_live["remote"],
             self.remote.pipeline.total),
        ):
            if live:
                buf = self._tier_obs_buf[obs_key]
                np.copyto(buf, src)
                tobs[obs_key] = buf
            else:
                # _tier_live is NOT monotonic (a drained tier goes idle
                # again) — restore the static zeros when it does
                tobs[obs_key] = self._static_tier_obs[obs_key]

        np.copyto(self._nact_buf, self.reserved.active)
        np.copyto(self._npend_buf, self.reserved.pending_total)
        np.copyto(self._nspot_buf, self.spot.active)
        np.copyto(self._thr_buf, self.eff_throughput)
        np.copyto(self._util_buf, self.last_util)
        np.copyto(self._qs_buf, self.q_strict.totals())
        np.copyto(self._qr_buf, self.q_relaxed.totals())
        np.copyto(self._lviol_buf, self.last_viol_arch)
        np.add(self._qs_buf, self._qr_buf, out=self._qlen_buf)
        self._pool_obs = PoolObs(
            keys=self.keys,
            rate=rates,
            ewma_rate=self._ewma_vec,
            window_peak=self._peak_vec,
            peak_to_median=self._p2m_vec,
            queue_len=self._qlen_buf,
            n_active=self._nact_buf,
            n_pending=self._npend_buf,
            n_spot=self._nspot_buf,
            throughput=self._thr_buf,
            utilization=self._util_buf,
            queue_strict=self._qs_buf,
            queue_relaxed=self._qr_buf,
            last_violations=self._lviol_buf,
            **tobs,
            **vobs,
        )
        return self._pool_obs

    def observe(self) -> Dict[str, ArchObs]:
        """Dict form of :meth:`observe_pool` (legacy policy interface)."""
        p = self.observe_pool()
        return {
            k: ArchObs(
                arch=k,
                rate=float(p.rate[i]),
                ewma_rate=float(p.ewma_rate[i]),
                window_peak=float(p.window_peak[i]),
                peak_to_median=float(p.peak_to_median[i]),
                queue_len=float(p.queue_len[i]),
                n_active=int(p.n_active[i]),
                n_pending=int(p.n_pending[i]),
                n_spot=int(p.n_spot[i]),
                throughput=float(p.throughput[i]),
                utilization=float(p.utilization[i]),
                n_spot_pending=int(p.n_spot_pending[i]),
                n_harvest=int(p.n_harvest[i]),
                n_harvest_pending=int(p.n_harvest_pending[i]),
                n_remote=int(p.n_remote[i]),
                n_remote_pending=int(p.n_remote_pending[i]),
                spot_reclaim_risk=float(p.spot_reclaim_risk[i]),
                harvest_level=float(p.harvest_level[i]),
                harvest_ceiling=int(p.harvest_ceiling[i]),
                active_variant=int(p.active_variant[i]),
                n_variants=int(p.n_variants[i]),
                accuracy=float(p.accuracy[i]),
                accuracy_floor=float(p.accuracy_floor[i]),
                variant_lo=int(p.variant_lo[i]),
                variant_cheapest=int(p.variant_cheapest[i]),
                variant_in_flight=bool(p.variant_in_flight[i]),
                variant_up_ratio=float(p.variant_up_ratio[i]),
                variant_down_ratio=float(p.variant_down_ratio[i]),
                variant_pending_ratio=float(p.variant_pending_ratio[i]),
            )
            for i, k in enumerate(self.keys)
        }

    # ------------------------------------------------------------------
    # Apply.
    # ------------------------------------------------------------------
    def apply(self, actions: Dict[str, Action]) -> dict:
        """Apply per-arch dict actions, serve the tick, advance time.

        Returns this tick's marginal metrics (for RL rewards)."""
        n = len(self.keys)
        target = np.empty(n, dtype=np.int64)
        offload = np.zeros(n, dtype=np.int64)
        spot_target = np.zeros(n, dtype=np.int64)
        harvest_target = np.zeros(n, dtype=np.int64)
        remote_target = np.zeros(n, dtype=np.int64)
        variant_target = np.full(n, -1, dtype=np.int64)
        for i, k in enumerate(self.keys):
            act = actions.get(k)
            if act is None:
                target[i] = self.reserved.active[i]
            else:
                target[i] = act.target
                # unknown offload values mean "none", as in the seed loop
                offload[i] = _OFFLOAD_CODE.get(act.offload, 0)
                spot_target[i] = act.spot_target
                harvest_target[i] = act.harvest_target
                remote_target[i] = act.remote_target
                variant_target[i] = act.variant
        return self._step(target, offload, spot_target, variant_target,
                          harvest_target, remote_target)

    def apply_pool(self, action: PoolAction) -> dict:
        """Vectorized counterpart of :meth:`apply`."""
        n = len(self.keys)
        return self._step(
            np.asarray(action.target, dtype=np.int64),
            action.offload_codes(n),
            action.spot_targets(n),
            action.variant_targets(n),
            action.harvest_targets(n),
            action.remote_targets(n),
        )

    def _step(
        self,
        target: np.ndarray,
        offload: np.ndarray,
        spot_target: np.ndarray,
        variant_target: Optional[np.ndarray] = None,
        harvest_target: Optional[np.ndarray] = None,
        remote_target: Optional[np.ndarray] = None,
    ) -> dict:
        assert self._pool_obs is not None, "call observe() before apply()"
        tick = self.tick
        led = self.ledger
        res = led.res
        cost0, viol0 = res.cost_total, res.violations
        cost0_arch = self.cost_arch.copy()
        viol0_arch = self.violations_arch.copy()

        # variant swaps: due swaps take effect for THIS tick's serving
        # (like provisioning: ready launches join before the queues are
        # served), then new requests enter the pipeline — the arch keeps
        # serving at the old variant's rate until theirs completes
        # (single-variant world: every request is a held/cancelled no-op)
        tel = self.telemetry
        if self._variants_live:
            done_swaps = self.swap.pop_ready(tick)
            if done_swaps.any():
                led.add_variant_swaps(int(done_swaps.sum()))
                self._refresh_variant_state()
                if tel is not None:
                    tel.on_swap_landed(tick, done_swaps)
            if variant_target is not None and (variant_target >= 0).any():
                req = np.minimum(variant_target, self.var_n - 1)
                started = self.swap.request(tick, req)
                if tel is not None:
                    tel.on_swap_request(tick, started, req)

        # provision: each tier runs its events + pipeline toward its
        # target.  Aux tiers activate lazily — an untargeted tier is
        # skipped entirely, so the reserved-only tick stays unchanged.
        self.reserved.begin_tick(tick, self.rng, led)
        self.reserved.set_target(tick, target)
        aux_targets = {
            "spot": spot_target, "harvest": harvest_target,
            "remote": remote_target,
        }
        for name, tier in self.aux_tiers.items():
            tgt = aux_targets[name]
            if self._tier_live[name] or (tgt is not None and tgt.any()):
                tier.begin_tick(tick, self.rng, led)
                tier.set_target(tick, tgt)
                self._tier_live[name] = bool(
                    tier.active.any() or tier.pipeline.total.any()
                )
            else:
                # provider-side state (the harvest availability signal)
                # evolves with time, not with usage
                tier.idle_tick(tick)

        # serve from the class queues, strict first, oldest first, at the
        # ACTIVE variant's service rate (old variant while a swap is in
        # flight — the weight reload has not landed yet).  Strict traffic
        # prefers LOCAL capacity: zero-egress tiers serve first; the
        # remote group's capacity follows, booking lateness against its
        # egress-tightened slack.
        remote_live = any(
            self._tier_live.get(t.name, False) for t in self._remote_group
        )
        local_active = self.reserved.active
        for t in self._local_aux:
            local_active = local_active + t.active
        capacity = local_active * self.eff_throughput
        served_s, late_s = self.q_strict.serve(tick, capacity)
        if remote_live:
            remote_cap = sum(
                t.active for t in self._remote_group
            ) * self.eff_throughput
            srs, lrs = self.q_strict.serve(
                tick, remote_cap, late_mask=self._remote_late_strict
            )
            served_r, late_r = self.q_relaxed.serve(tick, capacity - served_s)
            srr, lrr = self.q_relaxed.serve(
                tick, remote_cap - srs, late_mask=self._remote_late_relaxed
            )
            served_s, late_s = served_s + srs, late_s + lrs
            served_r, late_r = served_r + srr, late_r + lrr
            capacity = capacity + remote_cap
        else:
            served_r, late_r = self.q_relaxed.serve(tick, capacity - served_s)
        served = served_s + served_r
        answered = served.copy()       # accuracy accounting: who answered
        led.add_served_vm(float(served.sum()))
        led.add_violations(float(late_s.sum() + late_r.sum()), float(late_s.sum()))
        self.served_vm_arch += served
        self.violations_arch += late_s + late_r
        if tel is not None:
            tel.on_serve(tick, served, late_s, late_r)
        self.last_util = np.where(
            capacity > 0, served / np.where(capacity > 0, capacity, 1.0), 1.0
        )

        # offload decision: what leaves the queue for burst instances.
        #   blind       — anything unserved goes now, both classes
        #                 (MArk/Spock assume one global SLO)
        #   slack_aware — Paragon: strict queries offload when a VM slot
        #                 is unavailable; relaxed queries NEVER pay the
        #                 burst premium ("does not offload to lambdas for
        #                 relaxed latency queries", §IV-B)
        for q, mask, strict in (
            (self.q_strict, offload >= 1, True),
            (self.q_relaxed, offload == 1, False),
        ):
            if mask.any():
                counts = q.drain(mask)
                # sub-epsilon residue of the cumsum serve is not real
                # offload mass (the seed's BucketQueue absorbed it at its
                # 1e-12 threshold) and must not warm the burst pool
                counts[counts <= 1e-9] = 0.0
                if counts.any():
                    burst_viol = self.burst.offload(
                        tick, counts, q.slo_s, strict, led
                    )
                    self.served_burst_arch += counts
                    answered += counts
                    self.violations_arch += burst_viol
                    self.cost_arch += self.burst.cost_per_request * counts

        # abandon hopeless VM-only waiters (count violation once):
        # anything older than 3x its SLO is recorded and dropped so
        # queues cannot grow without bound under sustained shortfall.
        for q, strict in ((self.q_strict, True), (self.q_relaxed, False)):
            dropped_a = q.drop_expired(tick)
            dropped = float(dropped_a.sum())
            if dropped > 0:
                led.add_violations(dropped, dropped if strict else 0.0)
                led.add_served_vm(dropped)   # still answered, just very late
                self.dropped_arch += dropped_a
                self.violations_arch += dropped_a
                answered += dropped_a
                if tel is not None:
                    tel.on_drop(tick, strict, dropped_a)

        # delivered accuracy: every answered request carries the active
        # variant's accuracy; mass answered below the stream's floor is
        # an accuracy-SLO violation (conserved: the per-arch weights sum
        # to the ledger totals, tick by tick)
        acc_w = answered * self.cur_acc
        self.acc_weight_arch += acc_w
        led.add_accuracy(float(acc_w.sum()), float(answered.sum()))
        if self._acc_floor_live:
            acc_viol = answered * (self.cur_acc < self.acc_floor - 1e-12)
            if acc_viol.any():
                self.acc_viol_arch += acc_viol
                led.add_acc_violations(float(acc_viol.sum()))
        else:
            acc_viol = self._zero_arch
        if tel is not None:
            tel.on_accuracy(tick, acc_w, acc_viol)

        # accounting (cost attributed per arch as each tier posts — by
        # name, at the active variant's chip footprint; a new tier needs
        # no ledger changes beyond its registration above)
        chip_s = self.reserved.account(led, self.eff_chips)
        self.cost_arch += chip_s * self.reserved.price_per_chip_s()
        if tel is not None:
            tel.on_tier_cost(
                tick, "reserved",
                float(chip_s.sum()) * self.reserved.price_per_chip_s())
        for name, tier in self.aux_tiers.items():
            if self._tier_live[name]:
                t_chip_s = tier.account(led, self.eff_chips)
                self.cost_arch += t_chip_s * tier.price_per_chip_s()
                chip_s = chip_s + t_chip_s
                if tel is not None:
                    tel.on_tier_cost(
                        tick, name,
                        float(t_chip_s.sum()) * tier.price_per_chip_s())
        led.add_capacity(chip_s, self._rates, self.eff_throughput, self.eff_chips)
        if tel is not None:
            # mirror add_capacity's arithmetic exactly (reconciliation
            # compares these event magnitudes `==` against the ledger)
            need = np.ceil(self._rates / self.eff_throughput) * self.eff_chips
            tel.on_capacity(
                tick, float(chip_s.sum()), float(need.sum()),
                float(np.maximum(chip_s - need, 0.0).sum()))
            tel.end_tick(self, tick)

        self.tick += 1
        if self.done:
            self._finalize()
        self.last_viol_arch = self.violations_arch - viol0_arch
        return {
            "cost": res.cost_total - cost0,
            "violations": res.violations - viol0,
            "cost_arch": self.cost_arch - cost0_arch,
            "violations_arch": self.last_viol_arch.copy(),
            "accuracy": float(acc_w.sum()),
            "accuracy_arch": acc_w,
            "acc_violations": float(acc_viol.sum()),
            "acc_violations_arch": acc_viol,
        }

    def _finalize(self) -> None:
        # end-of-trace: whatever is still queued past its slack violates
        end = len(self.trace)
        for q, strict in ((self.q_strict, True), (self.q_relaxed, False)):
            late_a = q.pop_older_than_slack(end)
            late = float(late_a.sum())
            self.ledger.add_violations(late, late if strict else 0.0)
            self.violations_arch += late_a
            self.expired_end_arch += late_a
            if self.telemetry is not None:
                self.telemetry.on_expired(end, strict, late_a)

    def per_arch_counts(self) -> Dict[str, np.ndarray]:
        """Per-arch flow totals so far, each an ``[A]`` copy.

        ``arrived == served_vm + served_burst + dropped + expired_end +
        queued`` holds per arch after every tick (``dropped`` is the
        abandoned mass the ledger books as served-but-violated;
        ``expired_end`` is the still-queued late mass the end-of-trace
        sweep removes without serving)."""
        return {
            "arrived": self.arrived_arch.copy(),
            "served_vm": self.served_vm_arch.copy(),
            "served_burst": self.served_burst_arch.copy(),
            "dropped": self.dropped_arch.copy(),
            "expired_end": self.expired_end_arch.copy(),
            "violations": self.violations_arch.copy(),
            "queued": self.q_strict.totals() + self.q_relaxed.totals(),
            # the accuracy axis (answered == served_vm + served_burst +
            # dropped; acc_weight / answered is delivered accuracy)
            "acc_weight": self.acc_weight_arch.copy(),
            "acc_violations": self.acc_viol_arch.copy(),
        }

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        queued = self.q_strict.totals() + self.q_relaxed.totals()
        return {
            "t": self.tick,
            "rate": float(self.trace[min(self.tick, len(self.trace) - 1)]),
            "active": {
                k: int(self.reserved.active[i]) for i, k in enumerate(self.keys)
            },
            "queued": {k: float(queued[i]) for i, k in enumerate(self.keys)},
        }


def simulate(
    trace: np.ndarray,                       # [T] pool req/s or [A, T] matrix
    workload: List[ArchLoad],
    policy,                                  # Policy or VectorPolicy
    *,
    pricing: FleetPricing = PRICING,
    prewarm: bool = True,
    warm_start: bool = True,                 # fleet starts sized for t=0 load
    record_timeline: bool = False,
    catalog: Optional[VariantCatalog] = None,
    telemetry: Optional["Telemetry"] = None,
) -> SimResult:
    """Closed-loop run: the policy drives :class:`ServingSim` over the trace.

    ``trace`` may be a 1-D pool trace (fanned out by ``share``) or a 2-D
    per-arch arrival matrix from :mod:`repro_torch.core.workloads` (e.g.
    ``Scenario.build(len(workload))``).  Policies with a truthy
    ``vectorized`` attribute get the SoA interface (``PoolObs ->
    PoolAction``); everything else gets the dict interface.  ``catalog``
    opens the model-variant axis (runtime swaps via
    ``PoolAction.variant_target`` / ``Action.variant``).
    """
    sim = ServingSim(
        trace, workload, pricing=pricing, prewarm=prewarm,
        warm_start=warm_start, catalog=catalog, telemetry=telemetry,
    )
    vectorized = bool(getattr(policy, "vectorized", False))
    while not sim.done:
        if vectorized:
            pobs = sim.observe_pool()
            action = policy(sim.tick, pobs)
            if record_timeline:
                sim.res.timeline.append(sim.snapshot())
            sim.apply_pool(action)
        else:
            obs = sim.observe()
            actions = policy(sim.tick, obs)
            if record_timeline:
                sim.res.timeline.append(sim.snapshot())
            sim.apply(actions)
    return sim.res
