"""Observability for the serving simulator.

The paper's §V controller is a feedback loop — it can only manage what
it can observe — yet the engine historically reported a single
end-of-run :meth:`SimResult.summary` dict.  This module adds the three
observability surfaces every later PR (MPC, fleet-scale RL, packing)
reports through:

1. **Per-tick time-series recorder** (:class:`TimeSeriesRecorder`):
   preallocated ``[R, A]`` structure-of-arrays buffers (``R = ceil(T /
   stride)``) of fleet / queue / flow / cost state.  Gauges are
   last-write-wins within a stride bucket, flows accumulate.
2. **Structured event log**: typed :class:`TelemetryEvent` records
   emitted from ``engine._step`` and the fleet tiers.  The stream is
   *reconcilable* against the :class:`~repro_torch.core.sim.accounting.Ledger`
   — :func:`reconcile_events` re-derives every ledger total bit-exactly
   by replaying event magnitudes in the engine's posting order.
3. **SLO burn-rate / anomaly monitors** (:func:`detect_incidents`):
   multi-window burn rate per latency class, queue-age p99, and
   cost-per-served-request drift, summarized as an incidents table.

Everything hangs off one :class:`Telemetry` object attached to
:class:`~repro_torch.core.sim.engine.ServingSim` behind a
zero-cost-when-disabled flag: with ``telemetry=None`` (the default) the
engine takes a handful of ``is not None`` branches and is bit-identical
to the pre-telemetry engine.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sim.types import RELAXED, STRICT, TelemetryEvent

__all__ = [
    "EVENT_TYPES",
    "Incident",
    "JsonlWriter",
    "MonitorConfig",
    "Telemetry",
    "TelemetryEvent",
    "TimeSeriesRecorder",
    "detect_incidents",
    "events_from_jsonl",
    "global_counters",
    "incidents_table",
    "reconcile_events",
    "set_global_counter",
]


# ---------------------------------------------------------------------------
# Event vocabulary.  One entry per ``TelemetryEvent.etype`` the engine or
# a tier can emit — the single doc source for docs/TELEMETRY.md, and the
# coverage test pins that every emitted etype appears here.
# ---------------------------------------------------------------------------
EV_ARRIVAL = "arrival"
EV_SERVE = "serve"
EV_SLO_VIOLATION = "slo_violation"
EV_DROP = "drop"
EV_EXPIRED = "expired"
EV_BURST_OFFLOAD = "burst_offload"
EV_BURST_COLD = "burst_cold_start"
EV_ACCURACY = "accuracy"
EV_ACC_VIOLATION = "acc_violation"
EV_TIER_COST = "tier_cost"
EV_CHIP = "chip_seconds"
EV_CHIP_NEED = "chip_seconds_needed"
EV_CHIP_OVER = "chip_seconds_over"
EV_PROVISION_REQUEST = "provision_request"
EV_PROVISION_LANDED = "provision_landed"
EV_PROVISION_CANCELLED = "provision_cancelled"
EV_RELEASE = "release"
EV_SPOT_RECLAIM = "spot_reclaim"
EV_SPOT_RECLAIM_PENDING = "spot_reclaim_pending"
EV_HARVEST_EVICT = "harvest_evict"
EV_HARVEST_CANCEL = "harvest_cancel"
EV_SWAP_REQUEST = "swap_request"
EV_SWAP_LANDED = "swap_landed"

#: etype -> one-line description (magnitude semantics in parentheses).
EVENT_TYPES: Dict[str, str] = {
    EV_ARRIVAL: "requests admitted for an arch this tick (requests)",
    EV_SERVE: "requests served from VM capacity this tick (requests)",
    EV_SLO_VIOLATION: "late-served mass; tier=vm|burst, cls=strict|relaxed "
                      "(requests)",
    EV_DROP: "hopeless queued mass abandoned past 3x SLO; booked as "
             "served-but-violated (requests)",
    EV_EXPIRED: "still-queued mass swept late at end of trace; emitted at "
                "tick == len(trace) (requests)",
    EV_BURST_OFFLOAD: "requests offloaded to the serverless burst pool "
                      "(requests; cost = dollars billed for this arch)",
    EV_BURST_COLD: "a burst invocation hit a cold pool — the model was idle "
                   "past the warm timeout (cold batches this tick)",
    EV_ACCURACY: "accuracy-weighted answered mass at the active variant "
                 "(requests x accuracy)",
    EV_ACC_VIOLATION: "answered mass whose active variant sits below the "
                      "stream's accuracy floor (requests)",
    EV_TIER_COST: "one tier's bill for this tick; pool-level, "
                  "magnitude == cost (dollars)",
    EV_CHIP: "chip-seconds held across all tiers this tick; pool-level "
             "(chip-seconds)",
    EV_CHIP_NEED: "minimally-needed chip-seconds for this tick's arrivals; "
                  "pool-level (chip-seconds)",
    EV_CHIP_OVER: "held-above-needed chip-seconds this tick; pool-level "
                  "(chip-seconds)",
    EV_PROVISION_REQUEST: "instances a tier starts provisioning toward the "
                          "policy target (instances)",
    EV_PROVISION_LANDED: "in-flight launches that came online this tick "
                         "(instances)",
    EV_PROVISION_CANCELLED: "in-flight launches cancelled by a shrinking "
                            "target, newest first (instances)",
    EV_RELEASE: "active instances released by a shrinking target "
                "(instances)",
    EV_SPOT_RECLAIM: "active spot instances reclaimed by the provider; "
                     "counted as preemptions (instances)",
    EV_SPOT_RECLAIM_PENDING: "in-flight spot launches reclaimed before "
                             "landing; counted as preemptions (instances)",
    EV_HARVEST_EVICT: "active harvest instances evicted by a falling "
                      "availability signal; counted as preemptions "
                      "(instances)",
    EV_HARVEST_CANCEL: "in-flight harvest launches over the new ceiling; "
                       "cancelled, NOT preemptions (instances)",
    EV_SWAP_REQUEST: "a runtime variant swap entered the swap pipeline "
                     "(magnitude 1; cost field carries the target variant "
                     "index)",
    EV_SWAP_LANDED: "an in-flight variant swap completed and took effect "
                    "(magnitude 1)",
}

#: recorder cost-column order (every tier that can post dollars)
TIER_ORDER: Tuple[str, ...] = ("reserved", "spot", "harvest", "remote", "burst")

_CLS = ("strict", "relaxed")


# ---------------------------------------------------------------------------
# Module-level counters (e.g. runner trace counts) — keyed by a
# Prometheus-style ``name{label="v",...}`` string, exported by
# :meth:`Telemetry.prometheus_text`.
# ---------------------------------------------------------------------------
GLOBAL_COUNTERS: Dict[str, float] = {}


def set_global_counter(key: str, value: float) -> None:
    GLOBAL_COUNTERS[key] = float(value)


def global_counters() -> Dict[str, float]:
    return dict(GLOBAL_COUNTERS)


# ---------------------------------------------------------------------------
# Per-tick time-series recorder.
# ---------------------------------------------------------------------------
class TimeSeriesRecorder:
    """Preallocated SoA buffers over ``R = ceil(ticks / stride)`` rows.

    *Flows* (``arrived``, ``served_vm``, ...) accumulate within a stride
    bucket; *gauges* (fleet, queues, variants) are last-write-wins, i.e.
    the bucket reports its final tick's state.

    Buffers are sized ``R x A`` from the stride at allocation, and the
    gauge series are narrow (float32 / int32): they are observability
    state, not ledger inputs, and at fleet scale (A=256+) the ``[R, A]``
    gauge buffers dominate the recorder's footprint.  Flows and
    ``tier_cost`` stay float64 — the event-log reconciliation asserts
    exact agreement between their sums and the billing ledger."""

    FLOW_NAMES = (
        "arrived", "served_vm", "served_burst", "dropped",
        "viol_strict", "viol_relaxed", "acc_weight", "acc_viol",
    )

    def __init__(self, n_archs: int, ticks: int, stride: int = 1,
                 tier_names: Sequence[str] = ("reserved", "spot", "harvest",
                                              "remote")):
        self.n_archs = int(n_archs)
        self.ticks = int(ticks)
        self.stride = max(int(stride), 1)
        self.rows = max(-(-self.ticks // self.stride), 1)
        self.tier_names = tuple(tier_names)
        R, A = self.rows, self.n_archs
        self.tick = np.full(R, -1, dtype=np.int64)
        self.tier_active = {t: np.zeros((R, A), np.int32) for t in self.tier_names}
        self.tier_pending = {t: np.zeros((R, A), np.int32) for t in self.tier_names}
        self.queue_depth = {c: np.zeros((R, A), np.float32) for c in _CLS}
        self.queue_age_p99 = {c: np.zeros((R, A), np.int32) for c in _CLS}
        self.flows = {name: np.zeros((R, A)) for name in self.FLOW_NAMES}
        self.tier_cost = np.zeros((R, len(TIER_ORDER)))
        self.active_variant = np.zeros((R, A), np.int32)
        self.swap_in_flight = np.zeros((R, A), bool)
        self.acc_rate = np.zeros((R, A), np.float32)
        self.utilization = np.zeros((R, A), np.float32)
        self.harvest_level = np.zeros(R, np.float32)
        self._touched = 0                    # rows actually written

    def row(self, tick: int) -> int:
        r = min(tick // self.stride, self.rows - 1)
        self._touched = max(self._touched, r + 1)
        return r

    # -- flows ---------------------------------------------------------------
    def add_flow(self, tick: int, name: str, vec: np.ndarray) -> None:
        self.flows[name][self.row(tick)] += vec

    def add_cost(self, tick: int, tier: str, dollars: float) -> None:
        self.tier_cost[self.row(tick), TIER_ORDER.index(tier)] += dollars

    # -- views ---------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._touched

    def pool_flow(self, name: str) -> np.ndarray:
        """``[n_rows]`` pool-total of a flow."""
        return self.flows[name][: self._touched].sum(axis=1)

    def as_dict(self) -> Dict[str, np.ndarray]:
        """Trimmed copy of every buffer (rows actually written)."""
        n = self._touched
        out: Dict[str, np.ndarray] = {"tick": self.tick[:n].copy()}
        for t in self.tier_names:
            out[f"active_{t}"] = self.tier_active[t][:n].copy()
            out[f"pending_{t}"] = self.tier_pending[t][:n].copy()
        for c in _CLS:
            out[f"queue_{c}"] = self.queue_depth[c][:n].copy()
            out[f"queue_age_p99_{c}"] = self.queue_age_p99[c][:n].copy()
        for name in self.FLOW_NAMES:
            out[name] = self.flows[name][:n].copy()
        out["tier_cost"] = self.tier_cost[:n].copy()
        out["active_variant"] = self.active_variant[:n].copy()
        out["swap_in_flight"] = self.swap_in_flight[:n].copy()
        out["acc_rate"] = self.acc_rate[:n].copy()
        out["utilization"] = self.utilization[:n].copy()
        out["harvest_level"] = self.harvest_level[:n].copy()
        return out


# ---------------------------------------------------------------------------
# The telemetry hook the engine and tiers call into.
# ---------------------------------------------------------------------------
class Telemetry:
    """Event log + recorder + counters for one engine run.

    Attach via ``ServingSim(..., telemetry=Telemetry())`` (or the
    ``simulate(..., telemetry=)`` passthrough).  ``bind`` is called by
    the engine and starts a fresh event list / recorder, so re-using one
    ``Telemetry`` across episodes (the RL env does) observes the latest
    episode; ``counters`` accumulate over the object's lifetime."""

    def __init__(self, *, events: bool = True, record: bool = True,
                 stride: int = 1):
        self.events_on = bool(events)
        self.record_on = bool(record)
        self.stride = max(int(stride), 1)
        self.events: List[TelemetryEvent] = []
        self.recorder: Optional[TimeSeriesRecorder] = None
        self.counters: Dict[str, float] = {}
        self.n_archs = 0
        self.ticks = 0

    # -- lifecycle -----------------------------------------------------------
    def bind(self, sim) -> None:
        """Called by ``ServingSim.__init__``: size buffers to the run."""
        self.n_archs = len(sim.keys)
        self.ticks = len(sim.trace)
        self.events = []
        self.recorder = (
            TimeSeriesRecorder(self.n_archs, self.ticks, self.stride)
            if self.record_on else None
        )

    # -- primitive emitters --------------------------------------------------
    def emit(self, tick: int, etype: str, *, arch: int = -1, tier: str = "",
             cls: str = "", magnitude: float = 1.0, cost: float = 0.0) -> None:
        if self.events_on:
            self.events.append(TelemetryEvent(
                tick, etype, arch, tier, cls, float(magnitude), float(cost)))
            self.counters[etype] = self.counters.get(etype, 0.0) + 1.0

    def emit_flow(self, tick: int, etype: str, vec: np.ndarray, *,
                  tier: str = "", cls: str = "",
                  cost_vec: Optional[np.ndarray] = None) -> None:
        """Emit one event per nonzero entry of ``vec`` (exact values —
        the reconciliation rebuilds the full vector from them)."""
        if not self.events_on:
            return
        for a in np.nonzero(vec)[0]:
            self.emit(tick, etype, arch=int(a), tier=tier, cls=cls,
                      magnitude=float(vec[a]),
                      cost=float(cost_vec[a]) if cost_vec is not None else 0.0)

    def counter(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    # -- engine hooks (one per posting site, in tick order) ------------------
    def on_arrivals(self, tick: int, rates: np.ndarray) -> None:
        self.emit_flow(tick, EV_ARRIVAL, rates)
        if self.recorder is not None:
            self.recorder.add_flow(tick, "arrived", rates)

    def on_swap_landed(self, tick: int, done_mask: np.ndarray) -> None:
        for a in np.nonzero(done_mask)[0]:
            self.emit(tick, EV_SWAP_LANDED, arch=int(a))

    def on_swap_request(self, tick: int, start_mask: np.ndarray,
                        targets: np.ndarray) -> None:
        for a in np.nonzero(start_mask)[0]:
            self.emit(tick, EV_SWAP_REQUEST, arch=int(a),
                      cost=float(targets[a]))

    def on_serve(self, tick: int, served: np.ndarray, late_s: np.ndarray,
                 late_r: np.ndarray) -> None:
        self.emit_flow(tick, EV_SERVE, served)
        self.emit_flow(tick, EV_SLO_VIOLATION, late_s, tier="vm", cls="strict")
        self.emit_flow(tick, EV_SLO_VIOLATION, late_r, tier="vm", cls="relaxed")
        rec = self.recorder
        if rec is not None:
            rec.add_flow(tick, "served_vm", served)
            rec.add_flow(tick, "viol_strict", late_s)
            rec.add_flow(tick, "viol_relaxed", late_r)

    def on_burst(self, tick: int, strict: bool, counts: np.ndarray,
                 viol: np.ndarray, cost_vec: np.ndarray) -> None:
        cls = "strict" if strict else "relaxed"
        self.emit_flow(tick, EV_BURST_OFFLOAD, counts, tier="burst", cls=cls,
                       cost_vec=cost_vec)
        self.emit_flow(tick, EV_SLO_VIOLATION, viol, tier="burst", cls=cls)
        rec = self.recorder
        if rec is not None:
            rec.add_flow(tick, "served_burst", counts)
            rec.add_flow(tick, f"viol_{cls}", viol)
            rec.add_cost(tick, "burst", float(cost_vec.sum()))

    def on_cold_start(self, tick: int, cold_mask: np.ndarray) -> None:
        for a in np.nonzero(cold_mask)[0]:
            self.emit(tick, EV_BURST_COLD, arch=int(a), tier="burst")

    def on_drop(self, tick: int, strict: bool, dropped: np.ndarray) -> None:
        cls = "strict" if strict else "relaxed"
        self.emit_flow(tick, EV_DROP, dropped, cls=cls)
        rec = self.recorder
        if rec is not None:
            rec.add_flow(tick, "dropped", dropped)
            rec.add_flow(tick, f"viol_{cls}", dropped)

    def on_accuracy(self, tick: int, acc_w: np.ndarray,
                    acc_viol: np.ndarray) -> None:
        self.emit_flow(tick, EV_ACCURACY, acc_w)
        self.emit_flow(tick, EV_ACC_VIOLATION, acc_viol)
        rec = self.recorder
        if rec is not None:
            rec.add_flow(tick, "acc_weight", acc_w)
            rec.add_flow(tick, "acc_viol", acc_viol)

    def on_tier_cost(self, tick: int, tier: str, dollars: float) -> None:
        self.emit(tick, EV_TIER_COST, tier=tier, magnitude=dollars,
                  cost=dollars)
        if self.recorder is not None:
            self.recorder.add_cost(tick, tier, dollars)

    def on_capacity(self, tick: int, chip: float, need: float,
                    over: float) -> None:
        self.emit(tick, EV_CHIP, magnitude=chip)
        self.emit(tick, EV_CHIP_NEED, magnitude=need)
        self.emit(tick, EV_CHIP_OVER, magnitude=over)

    def on_expired(self, tick: int, strict: bool, late: np.ndarray) -> None:
        self.emit_flow(tick, EV_EXPIRED, late,
                       cls="strict" if strict else "relaxed")

    # -- tier hooks ----------------------------------------------------------
    def on_provision(self, tick: int, tier: str, ready: np.ndarray,
                     grow: np.ndarray, cancel: Optional[np.ndarray],
                     released: Optional[np.ndarray]) -> None:
        self.emit_flow(tick, EV_PROVISION_LANDED, ready, tier=tier)
        self.emit_flow(tick, EV_PROVISION_REQUEST, grow, tier=tier)
        if cancel is not None:
            self.emit_flow(tick, EV_PROVISION_CANCELLED, cancel, tier=tier)
        if released is not None:
            self.emit_flow(tick, EV_RELEASE, released, tier=tier)

    def on_reclaim(self, tick: int, etype: str, tier: str,
                   counts: np.ndarray) -> None:
        self.emit_flow(tick, etype, counts, tier=tier)

    # -- end-of-tick gauges --------------------------------------------------
    def end_tick(self, sim, tick: int) -> None:
        rec = self.recorder
        if rec is None:
            return
        r = rec.row(tick)
        rec.tick[r] = tick
        rec.tier_active["reserved"][r] = sim.reserved.active
        rec.tier_pending["reserved"][r] = sim.reserved.pipeline.total
        for name, tier in sim.aux_tiers.items():
            rec.tier_active[name][r] = tier.active
            rec.tier_pending[name][r] = tier.pipeline.total
        for cls, q in (("strict", sim.q_strict), ("relaxed", sim.q_relaxed)):
            rec.queue_depth[cls][r] = q.totals()
            rec.queue_age_p99[cls][r] = q.age_quantile(tick, 0.99)
        rec.active_variant[r] = sim.swap.current
        rec.swap_in_flight[r] = sim.swap.in_flight
        # delivered-accuracy rate at the serving (post-pop) variant —
        # name-aligned with the batched engine's trajectory gauge "acc_rate"
        rec.acc_rate[r] = sim.cur_acc
        rec.utilization[r] = sim.last_util
        rec.harvest_level[r] = sim.harvest.level

    # -- exporters -----------------------------------------------------------
    def events_as_dicts(self) -> List[dict]:
        return [e._asdict() for e in self.events]

    def to_jsonl(self, path: str) -> int:
        """Write the event log as JSONL; returns the record count."""
        w = JsonlWriter(path)
        for e in self.events:
            w.write(e._asdict())
        w.close()
        return len(self.events)

    def prometheus_text(self, result=None) -> str:
        """Prometheus text-exposition dump of counters (event totals,
        magnitude sums, global counters) and, when ``result`` is given,
        the run's ledger gauges."""
        lines = ["# TYPE repro_sim_events_total counter"]
        for etype in sorted(self.counters):
            lines.append(
                f'repro_sim_events_total{{etype="{etype}"}} '
                f"{self.counters[etype]:g}")
        mags: Dict[str, float] = {}
        for e in self.events:
            mags[e.etype] = mags.get(e.etype, 0.0) + e.magnitude
        if mags:
            lines.append("# TYPE repro_sim_event_magnitude_total counter")
            for etype in sorted(mags):
                lines.append(
                    f'repro_sim_event_magnitude_total{{etype="{etype}"}} '
                    f"{mags[etype]:.10g}")
        if GLOBAL_COUNTERS:
            lines.append("# TYPE repro_counter gauge")
            for key in sorted(GLOBAL_COUNTERS):
                lines.append(f"repro_{key} {GLOBAL_COUNTERS[key]:g}")
        if result is not None:
            lines.append("# TYPE repro_sim_result gauge")
            for k, v in result.summary().items():
                lines.append(f'repro_sim_result{{metric="{k}"}} {v:g}')
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSONL plumbing (event export, RL training log).
# ---------------------------------------------------------------------------
class JsonlWriter:
    """Line-per-record JSON writer; creates parent directories."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, mode)

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "JsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def events_from_jsonl(path: str) -> List[TelemetryEvent]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(TelemetryEvent(**json.loads(line)))
    return out


# ---------------------------------------------------------------------------
# Event-log <-> Ledger reconciliation.
# ---------------------------------------------------------------------------
def _scatter(events: Sequence[TelemetryEvent], ticks: int, n_archs: int):
    """Scatter the event stream into per-tick ``[ticks+1, A]`` vectors
    (row ``ticks`` holds the end-of-trace sweep) plus per-tick scalars."""
    A = n_archs
    T1 = ticks + 1
    grids = {
        "arrival": np.zeros((T1, A)), "serve": np.zeros((T1, A)),
        "vm_viol_strict": np.zeros((T1, A)), "vm_viol_relaxed": np.zeros((T1, A)),
        "burst_strict": np.zeros((T1, A)), "burst_relaxed": np.zeros((T1, A)),
        "burst_cost_strict": np.zeros((T1, A)),
        "burst_cost_relaxed": np.zeros((T1, A)),
        "burst_viol_strict": np.zeros((T1, A)),
        "burst_viol_relaxed": np.zeros((T1, A)),
        "drop_strict": np.zeros((T1, A)), "drop_relaxed": np.zeros((T1, A)),
        "acc_w": np.zeros((T1, A)), "acc_viol": np.zeros((T1, A)),
        "expired_strict": np.zeros((T1, A)), "expired_relaxed": np.zeros((T1, A)),
    }
    chip = {k: np.zeros(T1) for k in ("chip", "need", "over")}
    tier_cost: Dict[str, np.ndarray] = {}
    preemptions = 0
    swaps = 0
    for e in events:
        t, a = e.tick, e.arch
        if e.etype == EV_ARRIVAL:
            grids["arrival"][t, a] = e.magnitude
        elif e.etype == EV_SERVE:
            grids["serve"][t, a] = e.magnitude
        elif e.etype == EV_SLO_VIOLATION:
            key = ("vm_viol_" if e.tier == "vm" else "burst_viol_") + e.cls
            grids[key][t, a] = e.magnitude
        elif e.etype == EV_BURST_OFFLOAD:
            grids[f"burst_{e.cls}"][t, a] = e.magnitude
            grids[f"burst_cost_{e.cls}"][t, a] = e.cost
        elif e.etype == EV_DROP:
            grids[f"drop_{e.cls}"][t, a] = e.magnitude
        elif e.etype == EV_EXPIRED:
            grids[f"expired_{e.cls}"][t, a] = e.magnitude
        elif e.etype == EV_ACCURACY:
            grids["acc_w"][t, a] = e.magnitude
        elif e.etype == EV_ACC_VIOLATION:
            grids["acc_viol"][t, a] = e.magnitude
        elif e.etype == EV_TIER_COST:
            if e.tier not in tier_cost:       # first-post order, like the
                tier_cost[e.tier] = np.zeros(T1)   # ledger's cost_other dict
            tier_cost[e.tier][t] = e.cost
        elif e.etype == EV_CHIP:
            chip["chip"][t] = e.magnitude
        elif e.etype == EV_CHIP_NEED:
            chip["need"][t] = e.magnitude
        elif e.etype == EV_CHIP_OVER:
            chip["over"][t] = e.magnitude
        elif e.etype in (EV_SPOT_RECLAIM, EV_SPOT_RECLAIM_PENDING,
                         EV_HARVEST_EVICT):
            preemptions += int(e.magnitude)
        elif e.etype == EV_SWAP_LANDED:
            swaps += 1
    return grids, chip, tier_cost, preemptions, swaps


def reconcile_events(events: Sequence[TelemetryEvent], n_archs: int,
                     ticks: int) -> Dict[str, object]:
    """Re-derive the run's ledger totals and per-arch flows from the
    event log alone, **bit-exactly**.

    The engine posts float *sums of per-arch vectors* into the ledger in
    a fixed order each tick; float addition is order-sensitive, so this
    replays the identical computation: rebuild each full ``[A]`` vector
    from the (nonzero-only) events, reduce it with the same ``.sum()``
    the engine used, and accumulate the per-tick scalars in the same
    posting order.  The returned totals compare ``==`` (not merely
    close) against the :class:`SimResult` of the run that emitted the
    events — the reconciliation test relies on that."""
    g, chip, tier_cost, preemptions, swaps = _scatter(events, ticks, n_archs)
    A = n_archs
    total_requests = served_vm = served_burst = 0.0
    violations = violations_strict = 0.0
    cost_burst = acc_weighted = acc_served = acc_violations = 0.0
    per = {k: np.zeros(A) for k in (
        "arrived", "served_vm", "served_burst", "dropped", "expired_end",
        "violations", "acc_weight", "acc_violations")}
    for t in range(ticks):
        total_requests += g["arrival"][t].sum()
        per["arrived"] += g["arrival"][t]
        # serve (engine: add_served_vm, then add_violations(vm_s + vm_r))
        serve = g["serve"][t]
        served_vm += serve.sum()
        per["served_vm"] += serve
        vm_s, vm_r = g["vm_viol_strict"][t], g["vm_viol_relaxed"][t]
        violations += vm_s.sum() + vm_r.sum()
        violations_strict += vm_s.sum()
        per["violations"] += vm_s + vm_r
        # burst offload, strict then relaxed
        for cls in _CLS:
            counts = g[f"burst_{cls}"][t]
            cost_burst += g[f"burst_cost_{cls}"][t].sum()
            served_burst += counts.sum()
            bviol = g[f"burst_viol_{cls}"][t]
            violations += bviol.sum()
            if cls == "strict":
                violations_strict += bviol.sum()
            per["served_burst"] += counts
            per["violations"] += bviol
        # expiry drops, strict then relaxed (booked served-but-violated)
        for cls in _CLS:
            drop = g[f"drop_{cls}"][t]
            d = drop.sum()
            violations += d
            if cls == "strict":
                violations_strict += d
            served_vm += d
            per["dropped"] += drop
            per["violations"] += drop
        # accuracy: answered = serve + burst_s + burst_r + drop_s + drop_r
        answered = serve.copy()
        answered += g["burst_strict"][t]
        answered += g["burst_relaxed"][t]
        answered += g["drop_strict"][t]
        answered += g["drop_relaxed"][t]
        acc_w = g["acc_w"][t]
        acc_weighted += acc_w.sum()
        acc_served += answered.sum()
        per["acc_weight"] += acc_w
        acc_v = g["acc_viol"][t]
        acc_violations += acc_v.sum()
        per["acc_violations"] += acc_v
    # end-of-trace sweep (row `ticks`), strict then relaxed
    for cls in _CLS:
        exp = g[f"expired_{cls}"][ticks]
        e = exp.sum()
        violations += e
        if cls == "strict":
            violations_strict += e
        per["violations"] += exp
        per["expired_end"] += exp
    # supply side: per-tier dollars in tick order; chip-second totals
    cost_by_tier = {t: _seq_sum(v) for t, v in tier_cost.items()}
    out: Dict[str, object] = {
        "total_requests": total_requests,
        "served_vm": served_vm,
        "served_burst": served_burst,
        "violations": violations,
        "violations_strict": violations_strict,
        "cost_burst": cost_burst,
        "cost_reserved": cost_by_tier.pop("reserved", 0.0),
        "cost_spot": cost_by_tier.pop("spot", 0.0),
        "cost_other": cost_by_tier,
        "preemptions": preemptions,
        "variant_swaps": swaps,
        "accuracy_weighted": acc_weighted,
        "accuracy_served": acc_served,
        "acc_violations": acc_violations,
        "chip_seconds": _seq_sum(chip["chip"]),
        "chip_seconds_needed": _seq_sum(chip["need"]),
        "chip_seconds_over": _seq_sum(chip["over"]),
        "per_arch": per,
    }
    out["cost_total"] = (out["cost_reserved"] + out["cost_spot"]
                         + out["cost_burst"]
                         + sum(out["cost_other"].values()))
    return out


def _seq_sum(values: np.ndarray) -> float:
    """Strict left-to-right float accumulation (``+=`` per tick), matching
    the ledger's one-scalar-add-per-tick order — ``np.sum`` is pairwise
    and would differ in the last bits."""
    acc = 0.0
    for v in values:
        acc += v
    return acc


# ---------------------------------------------------------------------------
# Streaming SLO burn-rate / anomaly monitors.
# ---------------------------------------------------------------------------
@dataclass
class MonitorConfig:
    """Thresholds for :func:`detect_incidents` (tick units; windows are
    converted to recorder rows via the stride)."""

    slo_budget: float = 0.01          # tolerated violation fraction
    burn_threshold: float = 5.0       # burn multiple that pages
    short_window: int = 60            # fast window (ticks)
    long_window: int = 300            # confirmation window (ticks)
    queue_age_factor: float = 2.0     # p99 age limit = factor x class SLO
    cost_window: int = 300            # cost-drift trailing window (ticks)
    cost_drift_factor: float = 2.0    # x baseline $/request that pages
    min_window_requests: float = 1.0  # ignore windows with ~no traffic


@dataclass
class Incident:
    kind: str          # "slo_burn" | "queue_age" | "cost_drift"
    label: str         # latency class or metric the monitor watched
    start_tick: int
    end_tick: int
    peak: float        # worst monitor reading inside the incident
    detail: str = ""


def _rolling_sum(x: np.ndarray, w: int) -> np.ndarray:
    """Trailing-window sums: ``out[i] = sum(x[max(0, i-w+1) : i+1])``."""
    c = np.concatenate([[0.0], np.cumsum(x)])
    idx = np.arange(len(x)) + 1
    lo = np.maximum(idx - w, 0)
    return c[idx] - c[lo]


def _mask_to_incidents(mask: np.ndarray, ticks: np.ndarray, peak: np.ndarray,
                       kind: str, label: str, detail: str) -> List[Incident]:
    out: List[Incident] = []
    if not mask.any():
        return out
    edges = np.flatnonzero(np.diff(np.concatenate([[0], mask.view(np.int8), [0]])))
    for s, e in zip(edges[::2], edges[1::2]):   # [s, e) row runs
        out.append(Incident(
            kind=kind, label=label,
            start_tick=int(ticks[s]), end_tick=int(ticks[e - 1]),
            peak=float(peak[s:e].max()), detail=detail,
        ))
    return out


def detect_incidents(recorder: TimeSeriesRecorder,
                     cfg: MonitorConfig = MonitorConfig()) -> List[Incident]:
    """Run every monitor over the recorded series; returns incidents
    sorted by start tick.

    * **slo_burn** — SRE-style multi-window burn rate per latency class:
      ``burn = (violations / arrivals in window) / slo_budget``; pages
      when BOTH the short and the long window exceed ``burn_threshold``.
    * **queue_age** — per-class pool-max p99 queue age above
      ``queue_age_factor x`` the class SLO.
    * **cost_drift** — trailing cost-per-served-request above
      ``cost_drift_factor x`` the run's median.
    """
    n = recorder.n_rows
    if n == 0:
        return []
    stride = recorder.stride
    ticks = recorder.tick[:n]
    rows = lambda w: max(1, int(round(w / stride)))
    out: List[Incident] = []

    arrived = recorder.pool_flow("arrived")
    for cls, slo_s in (("strict", STRICT.slo_s), ("relaxed", RELAXED.slo_s)):
        viol = recorder.flows[f"viol_{cls}"][:n].sum(axis=1)
        # strict-class arrivals are not split out in the flows; burn is
        # measured against total pool arrivals, which only *understates*
        # the per-class burn — good enough to page on
        burns = []
        for w in (cfg.short_window, cfg.long_window):
            r = rows(w)
            va, aa = _rolling_sum(viol, r), _rolling_sum(arrived, r)
            ok = aa >= cfg.min_window_requests
            burns.append(np.where(
                ok, va / np.maximum(aa, 1e-9) / cfg.slo_budget, 0.0))
        mask = (burns[0] > cfg.burn_threshold) & (burns[1] > cfg.burn_threshold)
        out += _mask_to_incidents(
            mask, ticks, burns[0], "slo_burn", cls,
            f"burn > {cfg.burn_threshold:g}x budget "
            f"({cfg.slo_budget:.2%}) in both {cfg.short_window}s and "
            f"{cfg.long_window}s windows")

        age_limit = cfg.queue_age_factor * slo_s
        age = recorder.queue_age_p99[cls][:n].max(axis=1)
        out += _mask_to_incidents(
            age > age_limit, ticks, age.astype(float), "queue_age", cls,
            f"pool-max p99 queue age > {age_limit:g}s")

    cost = recorder.tier_cost[:n].sum(axis=1)
    served = (recorder.pool_flow("served_vm")
              + recorder.pool_flow("served_burst"))
    r = rows(cfg.cost_window)
    cs, ss = _rolling_sum(cost, r), _rolling_sum(served, r)
    valid = ss >= cfg.min_window_requests
    cpr = np.where(valid, cs / np.maximum(ss, 1e-9), np.nan)
    if valid.any():
        baseline = float(np.nanmedian(cpr))
        if baseline > 0:
            mask = valid & (cpr > cfg.cost_drift_factor * baseline)
            out += _mask_to_incidents(
                mask, ticks, np.nan_to_num(cpr / baseline), "cost_drift",
                "cost_per_request",
                f"trailing $/request > {cfg.cost_drift_factor:g}x the run "
                f"median (${baseline:.3g}/req)")
    out.sort(key=lambda i: (i.start_tick, i.kind, i.label))
    return out


def incidents_table(incidents: Sequence[Incident]) -> str:
    """Fixed-width text table of detected incidents."""
    if not incidents:
        return "no incidents detected\n"
    head = ("kind", "class", "start", "end", "peak", "detail")
    rows = [head] + [
        (i.kind, i.label, str(i.start_tick), str(i.end_tick),
         f"{i.peak:.2f}", i.detail)
        for i in incidents
    ]
    widths = [max(len(r[c]) for r in rows) for c in range(len(head) - 1)]
    lines = []
    for r in rows:
        cells = [r[c].ljust(widths[c]) for c in range(len(head) - 1)]
        lines.append("  ".join(cells) + "  " + r[-1])
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines) + "\n"
