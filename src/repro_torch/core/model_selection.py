"""Model selection (paper §III-A, §IV-C2).

A query arrives with an (accuracy, latency) constraint pair; the selector
maps it to a member of the model pool:

  ``naive``   — constraint-blind default: grab the most accurate model that
                responds within the latency bound, cost be damned (the
                paper's "naive constraints-unaware" baseline, Fig 9c).
  ``paragon`` — the paper's scheme: among ALL models satisfying both the
                accuracy and the latency constraints, pick the one with the
                least serving cost ("chooses the least costing model").

The accuracy/latency candidate filter itself lives with the runtime
variant axis (:func:`repro_torch.core.sim.types.filter_pool_candidates`) — the
offline selector here and the engine's :class:`~repro_torch.core.sim.types.VariantCatalog`
are two consumers of the same predicate, so the offline and runtime
accuracy axes cannot drift.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.profiles import RequestClass, STANDARD, model_pool
from repro_torch.core.sim.types import filter_pool_candidates


@dataclass(frozen=True)
class Constraint:
    min_accuracy: float = 0.0
    max_latency_s: float = float("inf")


class NoFeasibleModel(Exception):
    pass


def feasible_set(c: Constraint, req: RequestClass = STANDARD) -> Dict[str, dict]:
    return filter_pool_candidates(
        model_pool(req),
        min_accuracy=c.min_accuracy,
        max_latency_s=c.max_latency_s,
    )


def select_naive(c: Constraint, req: RequestClass = STANDARD) -> str:
    """Max-accuracy-within-latency, oblivious to cost and to the accuracy
    constraint actually requested (it always over-delivers)."""
    cands = filter_pool_candidates(
        model_pool(req), max_latency_s=c.max_latency_s
    )
    if not cands:
        raise NoFeasibleModel(str(c))
    return max(cands, key=lambda a: cands[a]["accuracy"])


def select_paragon(c: Constraint, req: RequestClass = STANDARD) -> str:
    """Least-cost model satisfying BOTH constraints (paper Fig 9c)."""
    cands = feasible_set(c, req)
    if not cands:
        raise NoFeasibleModel(str(c))
    return min(cands, key=lambda a: cands[a]["cost_per_1k"])


SELECTORS = {"naive": select_naive, "paragon": select_paragon}


def selection_cost(
    constraints: List[Constraint],
    selector: str,
    req: RequestClass = STANDARD,
    requests_per_constraint: float = 1000.0,
) -> dict:
    """Serve each constraint's stream with the selector's model choice and
    report aggregate cost + delivered accuracy/latency."""
    pool = model_pool(req)
    pick = SELECTORS[selector]
    total_cost = 0.0
    accs, lats = [], []
    choices = []
    for c in constraints:
        arch = pick(c, req)
        e = pool[arch]
        total_cost += e["cost_per_1k"] * requests_per_constraint / 1000.0
        accs.append(e["accuracy"])
        lats.append(e["latency_s"])
        choices.append(arch)
    return {
        "selector": selector,
        "cost": total_cost,
        "mean_accuracy": sum(accs) / len(accs),
        "mean_latency": sum(lats) / len(lats),
        "choices": choices,
    }


def selection_workload(
    constraints: List[Constraint],
    selector: str,
    *,
    strict_frac: float = 0.25,
    req: RequestClass = STANDARD,
):
    """Route a constraint stream through a selector into per-arch traffic
    shares (the paper's workload-2 as a *dynamic* workload: each query's
    model is chosen by the selection policy, and the resulting shares
    drive the fleet simulator).

    Returns (ArchLoad list, skipped) where ``skipped`` counts constraints
    no model satisfies (dropped from the stream).
    """
    from repro_torch.core.sim import ArchLoad  # local: avoid import cycle

    pick = SELECTORS[selector]
    counts: Dict[str, int] = {}
    skipped = 0
    for c in constraints:
        try:
            arch = pick(c, req)
        except NoFeasibleModel:
            skipped += 1
            continue
        counts[arch] = counts.get(arch, 0) + 1
    total = max(sum(counts.values()), 1)
    loads = [
        ArchLoad(arch, n / total, strict_frac)
        for arch, n in sorted(counts.items())
    ]
    return loads, skipped
