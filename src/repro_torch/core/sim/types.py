"""Shared vocabulary of the simulation package.

Everything a *policy* needs to speak to the engine lives here: the
workload description (:class:`ArchLoad`), the two latency classes, the
per-arch observation/action records of the legacy dict interface, their
structure-of-arrays counterparts (:class:`PoolObs` / :class:`PoolAction`)
used by vectorized policies on large pools, and the **model-variant
axis**: :class:`VariantCatalog`, the per-arch ordered variant sets
(accuracy / service-rate / cost multipliers derived from the Fig-2
profile pool) a variant-aware engine run swaps between at runtime.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.profiles import RequestClass

STRICT = RequestClass("strict", 512, 64, slo_s=2.0, strict=True)
RELAXED = RequestClass("relaxed", 512, 64, slo_s=20.0, strict=False)

#: latency classes in serving priority order (strict is served first)
CLASSES = (STRICT, RELAXED)

#: ``Action.offload`` modes, index == integer code in ``PoolAction.offload``
OFFLOAD_MODES = ("none", "blind", "slack_aware")
OFFLOAD_NONE, OFFLOAD_BLIND, OFFLOAD_SLACK_AWARE = range(3)


# ---------------------------------------------------------------------------
# Telemetry event record.
# ---------------------------------------------------------------------------
class TelemetryEvent(NamedTuple):
    """One structured observability record emitted by the engine or a tier.

    ``arch`` is the pool index the event concerns (``-1`` = pool-level),
    ``tier`` the resource tier name (``""`` when not tier-scoped), ``cls``
    the latency class (``"strict"``/``"relaxed"``, ``""`` when classless).
    ``magnitude`` carries the event's primary quantity (requests, instances,
    chip-seconds — see :data:`repro_torch.core.sim.telemetry.EVENT_TYPES`) and
    ``cost`` its dollar amount when one applies.  The event stream is the
    ground truth the :class:`~repro_torch.core.sim.accounting.Ledger` is
    reconciled against: summing event magnitudes in tick order reproduces
    every ledger total bit-exactly."""

    tick: int
    etype: str
    arch: int = -1
    tier: str = ""
    cls: str = ""
    magnitude: float = 1.0
    cost: float = 0.0


# ---------------------------------------------------------------------------
# Workload description.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ArchLoad:
    """One pool member.  ``share`` only splits a 1-D pool trace; when the
    engine is driven by a per-arch ``[A, T]`` arrival matrix
    (:mod:`repro_torch.core.workloads`) each row IS the arch's stream and
    ``share`` is ignored for admission (``strict_frac`` still applies).

    ``min_accuracy`` is the stream's accuracy SLO: requests answered by a
    variant below this floor count as accuracy violations (0.0 = no
    constraint, the default)."""

    arch: str
    share: float                   # fraction of total arrivals
    strict_frac: float = 0.5       # strict vs relaxed query mix (workload-1)
    name: Optional[str] = None     # pool key; lets one arch appear many
                                   # times in a large pool (defaults to arch)
    min_accuracy: float = 0.0      # per-stream accuracy floor (accuracy SLO)

    @property
    def key(self) -> str:
        return self.name or self.arch


def shares(workload: List["ArchLoad"]) -> np.ndarray:
    """The workload's share vector ``[A]`` — what fans a 1-D pool trace
    out per arch, and what :func:`repro_torch.core.workloads.from_pool_trace`
    needs to rebuild those arrivals as a matrix."""
    return np.array([w.share for w in workload], dtype=np.float64)


def uniform_pool_workload(archs: List[str], strict_frac: float = 0.5) -> List[ArchLoad]:
    return [ArchLoad(a, 1.0 / len(archs), strict_frac) for a in archs]


def replicate_pool(
    archs: List[str], n: int, strict_frac: float = 0.5
) -> List[ArchLoad]:
    """An ``n``-entry pool cycling through ``archs`` with unique keys —
    the pool-scale workloads (50-100 model variants) of INFaaS-style
    model-less serving, built from the profiled architectures we have."""
    return [
        ArchLoad(archs[i % len(archs)], 1.0 / n, strict_frac,
                 name=f"{archs[i % len(archs)]}@{i}")
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# The model-variant axis (INFaaS / Cocktail: model-less serving).
# ---------------------------------------------------------------------------
def filter_pool_candidates(
    pool: Mapping[str, dict],
    *,
    min_accuracy: float = 0.0,
    max_latency_s: float = float("inf"),
) -> Dict[str, dict]:
    """The accuracy/latency candidate filter over a Fig-2 style pool dict
    (:func:`repro_torch.core.profiles.model_pool` entries).

    This is the single implementation both accuracy axes consume: the
    offline selector (:mod:`repro_torch.core.model_selection`) filters a
    query's feasible set with it, and :class:`VariantCatalog` filters an
    arch's runtime variant set with it — so the two can never drift.
    """
    return {
        a: e
        for a, e in pool.items()
        if e["accuracy"] >= min_accuracy and e["latency_s"] <= max_latency_s
    }


@dataclass(frozen=True)
class Variant:
    """One runtime substitute for an arch's base model.

    Multipliers are *relative to the arch's base variant* (the arch
    itself, whose multipliers are exactly 1.0): switching to this variant
    scales the arch's per-instance service rate by ``service_mult``, its
    per-instance chip footprint (and therefore held-capacity cost) by
    ``cost_mult``, and its batch-1 request latency — what a burst
    invocation of the swapped pool observes — by ``lat_mult``; answered
    requests deliver ``accuracy``.  ``cost_per_1k`` is the Fig-2 cost
    basis "cheapest" decisions rank by.
    """

    arch: str
    accuracy: float
    service_mult: float
    cost_mult: float
    cost_per_1k: float
    lat_mult: float = 1.0


class VariantCatalog:
    """Per-arch ordered variant sets, derived from the Fig-2 profile pool.

    For every arch the catalog holds a tuple of :class:`Variant` ordered
    by accuracy ascending (ties broken by cost, then name) — index 0 is
    the least accurate substitute, the last index the most accurate —
    plus the index of the arch's *base* variant (itself; multipliers
    exactly 1.0, so a run that never swaps is bit-identical to a
    variant-blind run).  The engine gathers per-tick effective
    throughput / chips / accuracy from these sets via the per-arch
    ``active_variant`` index.
    """

    def __init__(self, per_arch: Dict[str, Tuple[Variant, ...]],
                 base_idx: Dict[str, int]):
        assert set(per_arch) == set(base_idx)
        for arch, vs in per_arch.items():
            assert len(vs) >= 1, arch
            accs = [v.accuracy for v in vs]
            assert accs == sorted(accs), f"{arch}: variants not accuracy-ordered"
            b = base_idx[arch]
            assert 0 <= b < len(vs), arch
            assert vs[b].arch == arch, f"{arch}: base variant must be itself"
            assert vs[b].service_mult == 1.0 and vs[b].cost_mult == 1.0, arch
        self.per_arch = dict(per_arch)
        self.base_idx = dict(base_idx)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_pool(
        cls,
        pool: Mapping[str, dict],
        archs: Optional[Sequence[str]] = None,
        *,
        candidates: Optional[Sequence[str]] = None,
        min_accuracy: float = 0.0,
        max_latency_s: float = float("inf"),
    ) -> "VariantCatalog":
        """Build the catalog from a Fig-2 style pool dict.

        ``archs`` names the pool members that get a variant set (default:
        every pool entry); ``candidates`` names the entries allowed to
        serve as variants (default: ``archs`` — the deployable pool;
        widen it explicitly to let swaps reach models outside the
        operated fleet).  Candidates are filtered through
        :func:`filter_pool_candidates` plus a positive service rate; an
        arch's own entry always joins its set (it is the base), so every
        arch has at least one variant.
        """
        archs = list(archs if archs is not None else pool)
        cand_pool = {
            a: pool[a] for a in (archs if candidates is None else candidates)
        }
        cands = {
            a: e
            for a, e in filter_pool_candidates(
                cand_pool, min_accuracy=min_accuracy,
                max_latency_s=max_latency_s,
            ).items()
            if e["throughput_rps"] > 0 and math.isfinite(e["cost_per_1k"])
        }
        per_arch: Dict[str, Tuple[Variant, ...]] = {}
        base_idx: Dict[str, int] = {}
        for arch in archs:
            base = pool[arch]
            members = dict(cands)
            members[arch] = base           # the base always belongs
            ordered = sorted(
                members,
                key=lambda a: (members[a]["accuracy"],
                               members[a]["cost_per_1k"], a),
            )
            vs = tuple(
                Variant(
                    arch=a,
                    accuracy=float(members[a]["accuracy"]),
                    service_mult=(
                        1.0 if a == arch else
                        float(members[a]["throughput_rps"])
                        / float(base["throughput_rps"])
                    ),
                    cost_mult=(
                        1.0 if a == arch else
                        float(members[a]["chips"]) / float(base["chips"])
                    ),
                    cost_per_1k=float(members[a]["cost_per_1k"]),
                    lat_mult=(
                        1.0 if a == arch else
                        float(members[a]["latency_s"])
                        / float(base["latency_s"])
                    ),
                )
                for a in ordered
            )
            per_arch[arch] = vs
            base_idx[arch] = ordered.index(arch)
        return cls(per_arch, base_idx)

    @classmethod
    def for_workload(
        cls,
        workload: List["ArchLoad"],
        req: Optional[RequestClass] = None,
        *,
        candidates: Optional[Sequence[str]] = None,
        min_accuracy: float = 0.0,
        max_latency_s: Optional[float] = None,
    ) -> "VariantCatalog":
        """Catalog over a workload's archs from the live Fig-2 pool
        (:func:`repro_torch.core.profiles.model_pool` — the single source of
        truth for the accuracy / service-rate / cost numbers).  Variants
        default to the workload's own archs (the deployable pool); the
        latency bound defaults to the strict class SLO, so every variant
        can serve strict queries."""
        from repro_torch.core.profiles import model_pool  # late: keep import light

        req = STRICT if req is None else req
        bound = req.slo_s if max_latency_s is None else max_latency_s
        return cls.from_pool(
            model_pool(req),
            sorted({w.arch for w in workload}),
            candidates=candidates,
            min_accuracy=min_accuracy,
            max_latency_s=bound,
        )

    # -- queries ------------------------------------------------------------
    def variants(self, arch: str) -> Tuple[Variant, ...]:
        return self.per_arch[arch]

    def n_variants(self, arch: str) -> int:
        return len(self.per_arch[arch])

    def floor_indices(self, arch: str, floor: float) -> Tuple[int, int]:
        """``(lo, cheapest)`` for an accuracy floor: the lowest variant
        index meeting it and the cheapest (Fig-2 cost basis) index
        meeting it.  When no variant meets the floor both fall back to
        the most accurate variant (the closest the arch can get)."""
        vs = self.per_arch[arch]
        ok = [i for i, v in enumerate(vs) if v.accuracy >= floor - 1e-12]
        if not ok:
            top = len(vs) - 1
            return top, top
        return ok[0], min(ok, key=lambda i: (vs[i].cost_per_1k, i))

    def as_arrays(self, workload: List["ArchLoad"]) -> Dict[str, np.ndarray]:
        """Padded SoA view for the engine: ``accuracy`` / ``service_mult``
        / ``cost_mult`` / ``lat_mult`` are ``[A, Vmax]`` (rows padded with
        their last variant — indices are clipped to ``n_variants - 1`` so
        padding is never addressed), plus ``n_variants`` / ``base_idx`` /
        ``floor_lo`` / ``floor_cheapest`` ``[A]`` integer vectors (the
        floor indices evaluated at each stream's ``min_accuracy``)."""
        sets = [self.per_arch[w.arch] for w in workload]
        vmax = max(len(vs) for vs in sets)
        n = len(workload)
        acc = np.empty((n, vmax)); smult = np.empty((n, vmax))
        cmult = np.empty((n, vmax)); lmult = np.empty((n, vmax))
        nvar = np.empty(n, dtype=np.int64)
        base = np.empty(n, dtype=np.int64)
        lo = np.empty(n, dtype=np.int64)
        cheap = np.empty(n, dtype=np.int64)
        for i, (w, vs) in enumerate(zip(workload, sets)):
            row_acc = [v.accuracy for v in vs]
            row_s = [v.service_mult for v in vs]
            row_c = [v.cost_mult for v in vs]
            row_l = [v.lat_mult for v in vs]
            pad = vmax - len(vs)
            acc[i] = row_acc + [row_acc[-1]] * pad
            smult[i] = row_s + [row_s[-1]] * pad
            cmult[i] = row_c + [row_c[-1]] * pad
            lmult[i] = row_l + [row_l[-1]] * pad
            nvar[i] = len(vs)
            base[i] = self.base_idx[w.arch]
            lo[i], cheap[i] = self.floor_indices(w.arch, w.min_accuracy)
        return {
            "accuracy": acc, "service_mult": smult, "cost_mult": cmult,
            "lat_mult": lmult,
            "n_variants": nvar, "base_idx": base,
            "floor_lo": lo, "floor_cheapest": cheap,
        }


# ---------------------------------------------------------------------------
# Policy interface (legacy dict form — one record per arch per tick).
# ---------------------------------------------------------------------------
@dataclass
class ArchObs:
    arch: str
    rate: float                    # this tick's arrivals (req/s)
    ewma_rate: float
    window_peak: float
    peak_to_median: float
    queue_len: float
    n_active: int
    n_pending: int
    n_spot: int
    throughput: float              # per-instance req/s (active variant)
    utilization: float             # served / capacity, last tick
    # --- tier-portfolio state (defaults = the reserved-only world) --------
    n_spot_pending: int = 0        # spot launches in flight
    n_harvest: int = 0             # active harvest-VM instances
    n_harvest_pending: int = 0
    n_remote: int = 0              # active remote-region reserved instances
    n_remote_pending: int = 0
    spot_reclaim_risk: float = 0.0   # per-instance per-tick reclaim prob.
    harvest_level: float = 1.0       # current harvest availability signal
    harvest_ceiling: int = 0         # instances the provider grants at it
    # --- model-variant state (defaults = the single-variant world) -------
    active_variant: int = 0        # index into the arch's ordered variant set
    n_variants: int = 1
    accuracy: float = 0.0          # accuracy delivered by the active variant
    accuracy_floor: float = 0.0    # this stream's accuracy SLO
    variant_lo: int = 0            # lowest index meeting the floor
    variant_cheapest: int = 0      # cheapest index meeting the floor
    variant_in_flight: bool = False  # a swap is mid-pipeline
    variant_up_ratio: float = 1.0    # service-rate ratio of the next
                                     # variant up (1.0 at the top)
    variant_down_ratio: float = 1.0  # ... of the next variant down
    variant_pending_ratio: float = 1.0  # ... of the in-flight target


@dataclass
class Action:
    """Per-arch procurement decision for this tick.

    ``offload`` semantics (who may go to burst, and when):
      ``none``        — VM-only procurement (reactive / util_aware / exascale)
      ``blind``       — ANY request not served this tick is offloaded
                        immediately (MArk/Spock: one global SLO assumption)
      ``slack_aware`` — a request offloads only when its own latency class
                        is about to violate (paper's Paragon: relaxed
                        queries ride out the spike in queue first)
    """

    target: int                    # desired reserved (on-demand) instances
    offload: str = "none"          # none | blind | slack_aware
    spot_target: int = 0           # desired SPOT instances (preemptible,
                                   # spot_discount x price — §VI extension)
    variant: int = -1              # desired variant index (-1 = hold; a
                                   # swap serves at the OLD rate for
                                   # pricing.variant_swap_s first)
    harvest_target: int = 0        # desired harvest-VM instances (capped
                                   # by the provider's harvest ceiling)
    remote_target: int = 0         # desired remote-region reserved
                                   # instances (egress adder per request)


Policy = Callable[[int, Dict[str, ArchObs]], Dict[str, Action]]


# ---------------------------------------------------------------------------
# Vectorized policy interface (structure-of-arrays over the whole pool).
# ---------------------------------------------------------------------------
@dataclass
class PoolObs:
    """One tick's observation for the whole pool, each field an ``[A]``
    array aligned with ``keys``.  Field meanings match :class:`ArchObs`;
    the tail fields below the line have no dict counterpart — they are
    the per-class queue split and last-tick violation feedback the
    pool-wide RL controller's feature vector needs.

    .. warning:: **Aliasing contract.**  ``ServingSim.observe_pool``
       returns engine-OWNED buffers, refilled in place every tick to
       keep the hot loop allocation-free.  A ``PoolObs`` is therefore
       valid only until the next ``observe_pool`` call: a policy that
       retains one across ticks will see its arrays silently mutate
       under it.  Schedulers that need history must call :meth:`copy`
       (or copy individual fields out) before the next tick.
    """

    keys: List[str]
    rate: np.ndarray
    ewma_rate: np.ndarray
    window_peak: np.ndarray
    peak_to_median: np.ndarray
    queue_len: np.ndarray
    n_active: np.ndarray
    n_pending: np.ndarray
    n_spot: np.ndarray
    throughput: np.ndarray
    utilization: np.ndarray
    queue_strict: Optional[np.ndarray] = None
    queue_relaxed: Optional[np.ndarray] = None
    last_violations: Optional[np.ndarray] = None   # violations booked last tick
    # --- tier-portfolio state, each [A] (engine always fills these) -------
    n_spot_pending: Optional[np.ndarray] = None
    n_harvest: Optional[np.ndarray] = None
    n_harvest_pending: Optional[np.ndarray] = None
    n_remote: Optional[np.ndarray] = None
    n_remote_pending: Optional[np.ndarray] = None
    spot_reclaim_risk: Optional[np.ndarray] = None  # per-tick reclaim prob.
    harvest_level: Optional[np.ndarray] = None      # availability signal
    harvest_ceiling: Optional[np.ndarray] = None    # granted instance cap
    # --- model-variant state, each [A] (engine always fills these) -------
    active_variant: Optional[np.ndarray] = None    # int index per arch
    n_variants: Optional[np.ndarray] = None
    accuracy: Optional[np.ndarray] = None          # active variant's accuracy
    accuracy_floor: Optional[np.ndarray] = None    # per-stream accuracy SLO
    variant_lo: Optional[np.ndarray] = None        # lowest index meeting floor
    variant_cheapest: Optional[np.ndarray] = None  # cheapest index meeting floor
    variant_in_flight: Optional[np.ndarray] = None  # bool: swap mid-pipeline
    variant_up_ratio: Optional[np.ndarray] = None   # smult(next up) / smult(cur)
    variant_down_ratio: Optional[np.ndarray] = None  # smult(next down) / smult(cur)
    variant_pending_ratio: Optional[np.ndarray] = None  # smult(pending) / smult(cur)

    def copy(self) -> "PoolObs":
        """A deep, caller-owned snapshot safe to retain across ticks
        (see the aliasing contract in the class docstring)."""
        import dataclasses as _dc

        return PoolObs(**{
            f.name: (
                v.copy() if isinstance(v, np.ndarray) else
                list(v) if f.name == "keys" else v
            )
            for f in _dc.fields(self)
            for v in (getattr(self, f.name),)
        })


@dataclass
class PoolAction:
    """Whole-pool procurement decision: ``target`` is required; ``offload``
    holds integer codes indexing :data:`OFFLOAD_MODES`;
    ``variant_target`` holds desired variant indices (-1 = hold, the
    default — a pool that never sets it is bit-identical to the
    variant-blind engine)."""

    target: np.ndarray
    offload: Optional[np.ndarray] = None   # defaults to all-"none"
    spot_target: Optional[np.ndarray] = None
    variant_target: Optional[np.ndarray] = None   # defaults to all-hold (-1)
    harvest_target: Optional[np.ndarray] = None
    remote_target: Optional[np.ndarray] = None

    def offload_codes(self, n: int) -> np.ndarray:
        return (np.zeros(n, dtype=np.int64)
                if self.offload is None else self.offload)

    def spot_targets(self, n: int) -> np.ndarray:
        return (np.zeros(n, dtype=np.int64)
                if self.spot_target is None else self.spot_target)

    def variant_targets(self, n: int) -> np.ndarray:
        return (np.full(n, -1, dtype=np.int64)
                if self.variant_target is None else self.variant_target)

    def harvest_targets(self, n: int) -> np.ndarray:
        return (np.zeros(n, dtype=np.int64)
                if self.harvest_target is None else self.harvest_target)

    def remote_targets(self, n: int) -> np.ndarray:
        return (np.zeros(n, dtype=np.int64)
                if self.remote_target is None else self.remote_target)


VectorPolicy = Callable[[int, PoolObs], PoolAction]
