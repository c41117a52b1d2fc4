"""Cost / violation / over-provision ledger.

:class:`SimResult` is the reported record (the paper's three metrics:
cost, SLO violations, over-provisioning); :class:`Ledger` is the
write-side the engine and tiers post into each tick.  Keeping the
accumulation behind one interface means a new tier only needs a name —
``add_tier_cost("harvest", ...)`` — and the demand-side bookkeeping
stays in one place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: What every :meth:`SimResult.summary` key means (docs/TELEMETRY.md is
#: generated against this; the coverage test keeps the two in sync).
#: ``cost_<tier>`` covers the dynamic keys tiers beyond the canonical
#: three post under their own names (``cost_harvest``, ``cost_remote``).
SUMMARY_KEY_DOCS: Dict[str, str] = {
    "cost_total": "total $ across every tier (reserved + spot + burst "
                  "+ any cost_<tier> entries)",
    "cost_reserved": "$ accrued by the reserved / multi-region reserved tier",
    "cost_spot": "$ accrued by the spot tier",
    "cost_burst": "$ paid to the serverless burst backend (per-request "
                  "premium pricing)",
    "cost_<tier>": "$ accrued by a non-canonical tier, keyed by its posted "
                   "name — present iff that tier was ever live in the run",
    "preemptions": "spot instances reclaimed by the provider mid-run",
    "violation_rate": "SLO-violating requests / total arrivals "
                      "(late-served + dropped + expired-at-end)",
    "violations_strict": "violating requests from the strict latency class",
    "served_vm": "requests answered by pool VMs (includes late ones; "
                 "dropped requests are counted served-late here)",
    "served_burst": "requests offloaded to and answered by the burst tier",
    "overprovision_ratio": "idle chip-seconds / needed chip-seconds "
                           "(the paper's over-provisioning metric)",
    "chip_seconds": "total provisioned chip-seconds across the run",
    "mean_accuracy": "answered-request-weighted mean accuracy of the "
                     "serving variants (variant-aware runs only)",
    "acc_violation_rate": "answered requests below their stream's accuracy "
                          "floor / all answered (variant-aware runs only)",
    "variant_swaps": "completed runtime model-variant swaps "
                     "(variant-aware runs only)",
}


@dataclass
class SimResult:
    cost_reserved: float = 0.0
    cost_spot: float = 0.0
    cost_burst: float = 0.0
    # tiers beyond the three canonical ones post here, keyed by tier name
    cost_other: Dict[str, float] = field(default_factory=dict)
    served_vm: float = 0.0
    served_burst: float = 0.0
    violations: float = 0.0
    violations_strict: float = 0.0
    total_requests: float = 0.0
    chip_seconds: float = 0.0
    chip_seconds_needed: float = 0.0
    chip_seconds_over: float = 0.0
    timeline: List[dict] = field(default_factory=list)

    preemptions: int = 0

    # --- delivered accuracy (the model-variant axis) ---------------------
    # ``accuracy_weighted`` accumulates answered-requests x the accuracy
    # of the variant that answered them; ``accuracy_served`` is the
    # matching answered mass, so weighted / served is the delivered mean.
    # Runs through a variant-blind path (the reference loop) never post
    # these, and ``summary()`` omits the derived keys in that case.
    accuracy_weighted: float = 0.0
    accuracy_served: float = 0.0
    acc_violations: float = 0.0          # answered below the accuracy floor
    variant_swaps: int = 0               # completed runtime variant swaps

    @property
    def cost_total(self) -> float:
        return (self.cost_reserved + self.cost_spot + self.cost_burst
                + sum(self.cost_other.values()))

    @property
    def violation_rate(self) -> float:
        return self.violations / max(self.total_requests, 1e-9)

    @property
    def mean_accuracy(self) -> float:
        """Delivered accuracy over every answered request."""
        return self.accuracy_weighted / max(self.accuracy_served, 1e-9)

    @property
    def acc_violation_rate(self) -> float:
        return self.acc_violations / max(self.accuracy_served, 1e-9)

    @property
    def overprovision_ratio(self) -> float:
        """Idle-capacity chip-seconds as a fraction of needed chip-seconds."""
        return self.chip_seconds_over / max(self.chip_seconds_needed, 1e-9)

    def summary(self) -> dict:
        s = {
            "cost_total": round(self.cost_total, 4),
            "cost_reserved": round(self.cost_reserved, 4),
            "cost_spot": round(self.cost_spot, 4),
            "cost_burst": round(self.cost_burst, 4),
            # tiers beyond the canonical three (harvest, remote, ...)
            # appear under their posted names — runs that never used them
            # report the same keys as before
            **{
                f"cost_{t}": round(v, 4)
                for t, v in sorted(self.cost_other.items())
            },
            "preemptions": self.preemptions,
            "violation_rate": round(self.violation_rate, 5),
            "violations_strict": round(self.violations_strict, 1),
            "served_vm": round(self.served_vm, 1),
            "served_burst": round(self.served_burst, 1),
            "overprovision_ratio": round(self.overprovision_ratio, 4),
            "chip_seconds": round(self.chip_seconds, 1),
        }
        if self.accuracy_served > 0:   # variant-aware run: report accuracy
            s["mean_accuracy"] = round(self.mean_accuracy, 5)
            s["acc_violation_rate"] = round(self.acc_violation_rate, 5)
            s["variant_swaps"] = self.variant_swaps
        return s


class Ledger:
    """Write-side of :class:`SimResult` used by the engine and the tiers."""

    def __init__(self) -> None:
        self.res = SimResult()

    # -- demand side ---------------------------------------------------------
    def add_arrivals(self, n: float) -> None:
        self.res.total_requests += n

    def add_served_vm(self, n: float) -> None:
        self.res.served_vm += n

    def add_violations(self, n: float, strict: float = 0.0) -> None:
        self.res.violations += n
        self.res.violations_strict += strict

    # -- supply side ---------------------------------------------------------
    def add_tier_cost(self, tier: str, dollars: float) -> None:
        attr = f"cost_{tier}"
        if hasattr(self.res, attr):
            setattr(self.res, attr, getattr(self.res, attr) + dollars)
        else:                       # a tier type added after this ledger
            other = self.res.cost_other
            other[tier] = other.get(tier, 0.0) + dollars

    def add_burst(self, cost: float, served: float, violations: float,
                  strict: bool) -> None:
        self.res.cost_burst += cost
        self.res.served_burst += served
        self.add_violations(violations, violations if strict else 0.0)

    def add_preemptions(self, n: int) -> None:
        self.res.preemptions += n

    # -- the model-variant axis ----------------------------------------------
    def add_accuracy(self, weighted: float, served: float) -> None:
        """Post one tick's answered mass and its accuracy-weighted sum."""
        self.res.accuracy_weighted += weighted
        self.res.accuracy_served += served

    def add_acc_violations(self, n: float) -> None:
        self.res.acc_violations += n

    def add_variant_swaps(self, n: int) -> None:
        self.res.variant_swaps += n

    def add_capacity(
        self,
        chip_seconds: np.ndarray,       # held chip-seconds per arch, all tiers
        rates: np.ndarray,              # this tick's arrivals per arch
        throughput: np.ndarray,         # per-instance req/s per arch
        chips_per_instance: np.ndarray,
    ) -> None:
        """Over-provisioning bookkeeping: held vs minimally-needed chips."""
        need = np.ceil(rates / throughput) * chips_per_instance
        self.res.chip_seconds += float(chip_seconds.sum())
        self.res.chip_seconds_needed += float(need.sum())
        self.res.chip_seconds_over += float(
            np.maximum(chip_seconds - need, 0.0).sum()
        )
