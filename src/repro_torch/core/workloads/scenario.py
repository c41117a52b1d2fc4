"""Declarative, seeded, serializable workload scenarios.

A :class:`Scenario` names a generator (:data:`~repro_torch.core.workloads.generators.GENERATORS`),
its parameters, a duration, a pool-mean rate, and a seed — everything a
benchmark, test, or RL env needs to rebuild the exact same ``[A, T]``
arrival matrix, as a plain dict/JSON round-trippable record:

    sc = Scenario("flash", kind="flash_crowd", params={"mode": "anti"})
    arrivals = sc.build(n_archs=8)          # [8, 3600], deterministic
    sc2 = Scenario.from_json(sc.to_json())  # == sc

**Composition** (``kind="compose"``): a scenario may combine *child*
scenarios (serialized inline as dicts in ``params["children"]``) by

* ``op="sum"`` — a weighted mix of the children's matrices (weights
  normalized, so ``mean_rps`` stays the pool mean), or
* ``op="splice"`` — a time-splice: child k owns the trace segment
  between consecutive ``splits`` fractions (children are built over the
  full duration and sliced, so their internal time structure — diurnal
  phase, event times — stays aligned with the clock).

Seed overrides propagate to children as a *delta* against the parent's
spec seed, so re-rolling a composed scenario (the RL env samples a fresh
realization per episode) re-rolls every child coherently.

The :data:`SCENARIO_ZOO` holds the named presets the scenario-grid
benchmark and the examples run: one shared-trace baseline plus the
heterogeneous shapes (phase-shifted diurnals, correlated / anti-correlated
flash crowds, MMPP bursts, trending-model hotswap, a diurnal/flash-crowd
splice) that share scaling cannot express.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np

from repro_torch.core.workloads.generators import GENERATORS

DEFAULT_DURATION_S = 3600
DEFAULT_MEAN_RPS = 100.0

#: the pseudo-kind that combines child scenarios (not a row generator)
COMPOSE_KIND = "compose"


@dataclass(frozen=True)
class Scenario:
    """A named, seeded recipe for a per-arch arrival matrix."""

    name: str
    kind: str                                  # key into GENERATORS
    duration_s: int = DEFAULT_DURATION_S
    mean_rps: float = DEFAULT_MEAN_RPS         # pool mean (req/s)
    seed: int = 0
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind == COMPOSE_KIND:
            children = self.params.get("children", ())
            assert len(children) >= 2, "compose needs >= 2 children"
            op = self.params.get("op", "sum")
            assert op in ("sum", "splice"), f"unknown compose op {op!r}"
            kids = [Scenario.from_dict(c) for c in children]   # validates kinds
            if op == "sum":
                w = self.params.get("weights")
                assert w is None or len(w) == len(kids)
            else:
                splits = self.params.get("splits")
                assert splits is None or (
                    len(splits) == len(kids) - 1
                    and all(0.0 < s < 1.0 for s in splits)
                    and list(splits) == sorted(splits)
                ), f"bad splice splits {splits!r}"
            return
        assert self.kind in GENERATORS, (
            f"unknown scenario kind {self.kind!r}; have "
            f"{sorted(GENERATORS) + [COMPOSE_KIND]}"
        )

    # -- building -----------------------------------------------------------
    def build(self, n_archs: int, *, seed: Optional[int] = None,
              duration_s: Optional[int] = None,
              mean_rps: Optional[float] = None) -> np.ndarray:
        """Materialize the ``[n_archs, duration_s]`` arrival matrix.

        ``seed`` (and the other overrides) re-roll one realization
        without mutating the spec — the RL env uses this to sample a
        fresh episode from the same scenario family.
        """
        eff_seed = int(self.seed if seed is None else seed)
        eff_dur = int(self.duration_s if duration_s is None else duration_s)
        eff_rps = float(self.mean_rps if mean_rps is None else mean_rps)
        if self.kind == COMPOSE_KIND:
            return self._build_composed(n_archs, eff_seed, eff_dur, eff_rps)
        gen = GENERATORS[self.kind]
        mat = gen(n_archs, eff_dur, eff_rps, eff_seed, **dict(self.params))
        assert mat.shape[0] == n_archs
        return mat

    def _build_composed(self, n_archs: int, seed: int, duration_s: int,
                        mean_rps: float) -> np.ndarray:
        """Sum or time-splice the children's ``[A, T]`` realizations."""
        delta = seed - self.seed          # override propagates as a delta
        kids = [Scenario.from_dict(c) for c in self.params["children"]]
        mats = [
            k.build(n_archs, seed=k.seed + delta, duration_s=duration_s,
                    mean_rps=mean_rps)
            for k in kids
        ]
        if self.params.get("op", "sum") == "sum":
            w = self.params.get("weights")
            w = (np.full(len(kids), 1.0 / len(kids)) if w is None
                 else np.asarray(w, dtype=np.float64))
            w = w / w.sum()
            return sum(wk * m for wk, m in zip(w, mats))
        # splice: child k owns [bounds[k], bounds[k+1])
        splits = self.params.get("splits")
        if splits is None:
            splits = [(i + 1) / len(kids) for i in range(len(kids) - 1)]
        bounds = [0] + [int(round(s * duration_s)) for s in splits] + [duration_s]
        out = np.empty((n_archs, duration_s))
        for m, lo, hi in zip(mats, bounds[:-1], bounds[1:]):
            out[:, lo:hi] = m[:, lo:hi]
        return out

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "duration_s": self.duration_s,
            "mean_rps": self.mean_rps,
            "seed": self.seed,
            "params": dict(self.params),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Scenario":
        return cls(
            name=d["name"],
            kind=d["kind"],
            duration_s=int(d.get("duration_s", DEFAULT_DURATION_S)),
            mean_rps=float(d.get("mean_rps", DEFAULT_MEAN_RPS)),
            seed=int(d.get("seed", 0)),
            params=dict(d.get("params", {})),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Named presets.
# ---------------------------------------------------------------------------
SCENARIO_ZOO: Dict[str, Scenario] = {
    sc.name: sc
    for sc in (
        # today's behavior: one pool trace, static share
        Scenario("shared_berkeley", kind="pool_trace",
                 params={"trace": "berkeley"}),
        # regions in different time zones: arch peaks spread over the cycle
        Scenario("diurnal_phases", kind="diurnal",
                 params={"phase_jitter": 1.0, "amp_jitter": 0.5}),
        # a launch event hits half the pool at once
        Scenario("flash_correlated", kind="flash_crowd",
                 params={"mode": "correlated", "n_events": 3}),
        # attention shifts: one model trends while the others drain
        Scenario("flash_anti", kind="flash_crowd",
                 params={"mode": "anti", "n_events": 3, "dip": 0.6}),
        # decorrelated heavy-tailed bursts per arch
        Scenario("mmpp_bursts", kind="mmpp",
                 params={"burst_mult": 4.0}),
        # trending-model popularity migration over a smooth pool trace
        Scenario("trending_hotswap", kind="hotswap",
                 params={"n_shifts": 3, "boost": 5.0}),
        # composed: a diurnal first half splicing into an afternoon of
        # anti-correlated flash crowds (attention shifts mid-day)
        Scenario("diurnal_flash_splice", kind=COMPOSE_KIND,
                 params={
                     "op": "splice",
                     "splits": [0.5],
                     "children": [
                         Scenario("base", kind="diurnal",
                                  params={"phase_jitter": 0.6,
                                          "amp_jitter": 0.4}).to_dict(),
                         Scenario("crowd", kind="flash_crowd",
                                  params={"mode": "anti", "n_events": 3,
                                          "dip": 0.6}, seed=1).to_dict(),
                     ],
                 }),
    )
}


def get_scenario(name: str) -> Scenario:
    return SCENARIO_ZOO[name]
