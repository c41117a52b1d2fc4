"""Resource-procurement policies (paper §II-C, §II-D, §IV).

All five schemes share one interface: ``policy(tick, obs) -> {arch: Action}``.

  reactive    — scale to the smoothed current demand; no burst.  The
                paper's normalization baseline.
  util_aware  — spawn when utilization crosses 80% (prior work [14]-[16]);
                equivalently holds capacity at demand/0.8.
  exascale    — provision ABOVE a windowed peak prediction (Tributary-style
                [17]): headroom x recent peak.
  mixed       — reactive VM fleet + blind burst offload of ANY query about
                to miss its SLO (MArk [12] / Spock [13]).
  paragon     — this paper's scheme: latency-class-aware offload (strict
                queries only; relaxed ones ride out the spike in queue) on
                top of reactive scaling, consulting the load monitor.

Beyond-paper tiers ride the same interface: ``spot_paragon`` (on-demand
floor + preemptible spot base) and ``portfolio`` (reserved floor +
remote-region relaxed base + harvest VMs split by reclaim risk + spot
churn buffer — the full tier portfolio).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.core.sim import (
    OFFLOAD_BLIND,
    OFFLOAD_SLACK_AWARE,
    Action,
    ArchObs,
    PoolAction,
    PoolObs,
)


def _scale_target(o: ArchObs, demand: float, headroom: float = 1.0) -> int:
    return max(1, math.ceil(demand * headroom / o.throughput))


@dataclass
class ReactivePolicy:
    """Track smoothed demand 1:1 — cheap, but spikes hit the provisioning
    latency window and violate SLOs."""

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        return {
            a: Action(target=_scale_target(o, o.ewma_rate)) for a, o in obs.items()
        }


@dataclass
class UtilAwarePolicy:
    """Spawn when utilization reaches ``util_target`` (80% in most prior
    work [14]); release only when it falls below ``scale_down_util``.
    The hysteresis is the over-provisioning the paper measures in Fig 5:
    utilization is a lagging, spike-inflated indicator, so VMs spawned for
    a burst linger long after it drains."""

    util_target: float = 0.8
    scale_down_util: float = 0.4
    up_cooldown_s: int = 30        # scale up eagerly on sustained pressure
    down_cooldown_s: int = 120     # release conservatively (the paper's point:
                                   # spike-spawned VMs linger -> over-provision)
    _targets: Dict[str, int] = field(default_factory=dict)
    _last_up: Dict[str, int] = field(default_factory=dict)
    _last_down: Dict[str, int] = field(default_factory=dict)

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = {}
        for a, o in obs.items():
            cur = self._targets.get(a, max(o.n_active + o.n_pending, 1))
            if (
                o.utilization > self.util_target
                and tick - self._last_up.get(a, -10**9) >= self.up_cooldown_s
            ):
                # spawn enough to bring utilization back under target
                cur = max(
                    cur + 1, _scale_target(o, o.ewma_rate, 1.0 / self.util_target)
                )
                self._last_up[a] = tick
            elif (
                o.utilization < self.scale_down_util
                and cur > 1
                and tick - self._last_down.get(a, -10**9) >= self.down_cooldown_s
            ):
                cur -= 1
                self._last_down[a] = tick
            self._targets[a] = cur
            out[a] = Action(target=cur)
        return out


@dataclass
class ExascalePolicy:
    """Provision for the windowed peak plus headroom ("spawn additional VMs
    than predicted demand")."""

    headroom: float = 1.15

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        return {
            a: Action(
                target=_scale_target(
                    o, max(o.window_peak, o.ewma_rate), self.headroom
                )
            )
            for a, o in obs.items()
        }


@dataclass
class MixedPolicy:
    """Reactive fleet + blind offload: every query about to miss its SLO is
    handed to a burst instance, regardless of its latency class."""

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        return {
            a: Action(target=_scale_target(o, o.ewma_rate), offload="blind")
            for a, o in obs.items()
        }


@dataclass
class ParagonPolicy:
    """The paper's scheme (§IV): constraint-aware procurement.

    * strict-latency queries offload to burst when the VM queue would
      violate them;
    * relaxed-latency queries NEVER pay the burst premium — their slack
      absorbs the spike while reactive scaling catches up;
    * when the load-monitor window says the trace is flat
      (peak/median < ``bursty_threshold``, Observation 4), provisioning
      gets a small cushion instead, because burst would not pay off.
    """

    bursty_threshold: float = 1.5
    flat_cushion: float = 1.1
    drain_horizon_s: float = 5.0   # drain relaxed backlog within its slack

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = {}
        for a, o in obs.items():
            bursty = o.peak_to_median >= self.bursty_threshold
            headroom = 1.0 if bursty else self.flat_cushion
            # right-size for demand PLUS queued (relaxed) work: the backlog
            # must drain within the relaxed slack, on VMs, not on burst
            demand = o.ewma_rate + o.queue_len / self.drain_horizon_s
            out[a] = Action(
                target=_scale_target(o, demand, headroom),
                offload="slack_aware",
            )
        return out


SCHEDULERS = {
    "reactive": ReactivePolicy,
    "util_aware": UtilAwarePolicy,
    "exascale": ExascalePolicy,
    "mixed": MixedPolicy,
    "paragon": ParagonPolicy,
}


def get_scheduler(name: str, **kw):
    return SCHEDULERS[name](**kw)


@dataclass
class SpotParagonPolicy(ParagonPolicy):
    """Beyond-paper (§VI "Limitations"): Paragon + a SPOT tier.

    The steady base load runs on preemptible spot slices at
    ``spot_discount`` x the on-demand price; an on-demand floor sized for
    the strict-class share guarantees SLO-critical capacity through
    preemptions, and the class-aware burst offload (inherited) covers the
    transient dips a reclaim leaves behind.
    """

    strict_share: float = 0.25     # workload's strict fraction (floor sizing)
    spot_buffer: float = 1.25      # spot over-provision vs residual demand
                                   # (preemption churn absorber)

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = {}
        for a, o in obs.items():
            demand = o.ewma_rate + o.queue_len / self.drain_horizon_s
            floor = max(1, math.ceil(demand * self.strict_share / o.throughput))
            residual = max(0.0, demand - floor * o.throughput)
            spot = math.ceil(residual * self.spot_buffer / o.throughput)
            out[a] = Action(target=floor, spot_target=spot, offload="slack_aware")
        return out


SCHEDULERS["spot_paragon"] = SpotParagonPolicy


@dataclass
class PortfolioPolicy(ParagonPolicy):
    """Beyond-paper: the full TIER PORTFOLIO over Paragon's class-aware
    offload — the paper's "confounding array of resource types" under
    one procurement rule.

    Capacity is layered by reliability and price:

    * an on-demand **reserved** floor sized for the strict-class share
      (SLO-critical capacity that survives any reclaim wave);
    * a **remote**-region reserved slice for a fraction of the steady
      relaxed base (cheaper, slower to provision, pays a per-request
      egress adder — which is fine for relaxed traffic, and the engine
      serves strict from local capacity first anyway);
    * **harvest** VMs for the bulk of the residual base load — the
      deepest discount, sized *by reclaim risk*: the harvest share
      follows the provider's availability signal (level high -> lean on
      harvest; level sagging -> shift toward spot before the ceiling
      evicts), and is capped by the granted ceiling;
    * **spot** for whatever the harvest grant leaves uncovered, with a
      churn buffer against its i.i.d. reclaims;
    * class-aware burst offload (inherited) absorbs the transient dips
      any reclaim leaves behind.
    """

    strict_share: float = 0.25     # reserved floor = strict-class share
    remote_frac: float = 0.3       # fraction of the steady relaxed base
                                   # placed in the remote region
    harvest_margin: float = 0.15   # risk margin under the harvest signal
    harvest_max_frac: float = 0.8  # never bet more of the residual on
                                   # harvest than this
    harvest_buffer: float = 1.1    # small headroom on the harvest slice
    spot_buffer: float = 1.25      # preemption churn absorber

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = {}
        for a, o in obs.items():
            demand = o.ewma_rate + o.queue_len / self.drain_horizon_s
            floor = max(1, math.ceil(demand * self.strict_share / o.throughput))
            remote = int(
                self.remote_frac * (1 - self.strict_share) * o.ewma_rate
                / o.throughput
            )
            residual = max(
                0.0, demand - (floor + remote) * o.throughput
            )
            h_frac = min(
                max(o.harvest_level - self.harvest_margin, 0.0),
                self.harvest_max_frac,
            )
            h_want = math.ceil(
                residual * h_frac * self.harvest_buffer / o.throughput
            )
            harvest = min(h_want, o.harvest_ceiling)
            spot_resid = max(0.0, residual - harvest * o.throughput)
            spot = math.ceil(spot_resid * self.spot_buffer / o.throughput)
            out[a] = Action(
                target=floor, spot_target=spot, harvest_target=harvest,
                remote_target=remote, offload="slack_aware",
            )
        return out


SCHEDULERS["portfolio"] = PortfolioPolicy


# ---------------------------------------------------------------------------
# Variant-aware policies (the model-heterogeneity half of the paper's
# joint model x resource decision space).  Both ride on Paragon's
# class-aware procurement and add a ``variant`` decision per arch; on a
# variant-blind engine run (single-variant catalog) they degrade to
# exactly Paragon.
# ---------------------------------------------------------------------------
def _swap_aware_target_scalar(o: ArchObs, bursty_threshold: float,
                              flat_cushion: float,
                              drain_horizon_s: float) -> int:
    """Paragon sizing against the slower of the active / in-flight
    variant's service rate — the dict-form analog of the vector
    :func:`_swap_aware_target`, shared by both variant-aware dict
    policies so the rule cannot diverge between them."""
    bursty = o.peak_to_median >= bursty_threshold
    headroom = 1.0 if bursty else flat_cushion
    demand = o.ewma_rate + o.queue_len / drain_horizon_s
    thr = o.throughput * min(1.0, o.variant_pending_ratio)
    return max(1, math.ceil(demand * headroom / thr))


@dataclass
class InfaasVariantPolicy(ParagonPolicy):
    """INFaaS-style variant tuning: upgrade on slack, downgrade on queue
    pressure (along the accuracy-ordered variant set, never below the
    stream's accuracy floor), with a per-arch cooldown so the swap
    pipeline is not thrashed.

    Swap-aware guards: a downgrade must land on a strictly *faster*
    variant (pressure wants service rate, and accuracy order does not
    imply rate order), an upgrade must keep the projected post-swap
    utilization under ``post_swap_util``, and while a swap is in flight
    the fleet is sized for the slower of the old/new service rates (the
    reload lands before provisioning could catch up otherwise)."""

    up_util: float = 0.55          # upgrade only when the fleet has slack
    down_util: float = 0.9         # downgrade when saturated / backlogged
    post_swap_util: float = 0.75   # projected utilization bound after an
                                   # upgrade lands
    queue_pressure_s: float = 2.0  # backlog worth this many seconds of
                                   # service counts as pressure
    cooldown_s: int = 120
    _last_move: Dict[str, int] = field(default_factory=dict)

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = super().__call__(tick, obs)
        for a, o in obs.items():
            out[a].target = _swap_aware_target_scalar(
                o, self.bursty_threshold, self.flat_cushion,
                self.drain_horizon_s,
            )
            if (
                o.variant_in_flight
                or tick - self._last_move.get(a, -(10**9)) < self.cooldown_s
            ):
                continue
            cap = max(o.n_active, 1) * o.throughput
            # queue_len includes this tick's (not yet served) arrivals;
            # pressure / slack are about the carried-over backlog
            backlog = o.queue_len - o.rate
            pressure = (
                o.utilization >= self.down_util
                or backlog > self.queue_pressure_s * cap
            )
            slack = o.utilization <= self.up_util and backlog <= 1e-6
            if (
                pressure
                and o.active_variant > o.variant_lo
                and o.variant_down_ratio > 1.0 + 1e-9
            ):
                out[a].variant = o.active_variant - 1
                self._last_move[a] = tick
            elif (
                slack
                and not pressure
                and o.active_variant < o.n_variants - 1
                and o.utilization / o.variant_up_ratio <= self.post_swap_util
            ):
                out[a].variant = o.active_variant + 1
                self._last_move[a] = tick
        return out


@dataclass
class AccuracyFloorPolicy(ParagonPolicy):
    """Constraint-first variant choice: pin every arch to the cheapest
    variant meeting its accuracy floor (the runtime form of the paper's
    least-cost selection, recomputed as swaps land).  Sizing is
    swap-aware: while a reload is in flight the fleet covers the slower
    of the old/new service rates."""

    def __call__(self, tick: int, obs: Dict[str, ArchObs]) -> Dict[str, Action]:
        out = super().__call__(tick, obs)
        for a, o in obs.items():
            out[a].target = _swap_aware_target_scalar(
                o, self.bursty_threshold, self.flat_cushion,
                self.drain_horizon_s,
            )
            if not o.variant_in_flight and o.active_variant != o.variant_cheapest:
                out[a].variant = o.variant_cheapest
        return out


SCHEDULERS["infaas_variant"] = InfaasVariantPolicy
SCHEDULERS["accuracy_floor"] = AccuracyFloorPolicy


# ---------------------------------------------------------------------------
# Vectorized policies (structure-of-arrays, for pool-scale simulations).
#
# Same decision rules as their dict counterparts above, expressed over
# ``PoolObs`` arrays so a 50-100 arch pool costs a handful of NumPy ops
# per tick instead of a Python loop.  ``vectorized = True`` routes them
# through the engine's SoA interface in ``simulate``.
# ---------------------------------------------------------------------------
def _scale_target_vec(
    throughput: np.ndarray, demand: np.ndarray, headroom=1.0
) -> np.ndarray:
    return np.maximum(1, np.ceil(demand * headroom / throughput)).astype(np.int64)


@dataclass
class VectorReactivePolicy:
    """Vector form of :class:`ReactivePolicy`."""

    vectorized = True

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        return PoolAction(target=_scale_target_vec(obs.throughput, obs.ewma_rate))


@dataclass
class VectorParagonPolicy:
    """Vector form of :class:`ParagonPolicy` (same knobs, same decisions)."""

    vectorized = True
    bursty_threshold: float = 1.5
    flat_cushion: float = 1.1
    drain_horizon_s: float = 5.0

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        bursty = obs.peak_to_median >= self.bursty_threshold
        headroom = np.where(bursty, 1.0, self.flat_cushion)
        demand = obs.ewma_rate + obs.queue_len / self.drain_horizon_s
        return PoolAction(
            target=_scale_target_vec(obs.throughput, demand, headroom),
            offload=np.full(len(obs.keys), OFFLOAD_SLACK_AWARE, dtype=np.int64),
        )


@dataclass
class VectorUtilAwarePolicy:
    """Vector form of :class:`UtilAwarePolicy`: the per-arch target /
    cooldown dicts become ``[A]`` arrays initialized on the first call."""

    vectorized = True
    util_target: float = 0.8
    scale_down_util: float = 0.4
    up_cooldown_s: int = 30
    down_cooldown_s: int = 120
    _targets: np.ndarray = None
    _last_up: np.ndarray = None
    _last_down: np.ndarray = None

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        n = len(obs.keys)
        if self._targets is None:
            self._targets = np.maximum(obs.n_active + obs.n_pending, 1).astype(
                np.int64
            )
            self._last_up = np.full(n, -10**9, dtype=np.int64)
            self._last_down = np.full(n, -10**9, dtype=np.int64)
        cur = self._targets
        up = (obs.utilization > self.util_target) & (
            tick - self._last_up >= self.up_cooldown_s
        )
        down = (
            ~up
            & (obs.utilization < self.scale_down_util)
            & (cur > 1)
            & (tick - self._last_down >= self.down_cooldown_s)
        )
        up_target = np.maximum(
            cur + 1,
            _scale_target_vec(obs.throughput, obs.ewma_rate, 1.0 / self.util_target),
        )
        cur = np.where(up, up_target, np.where(down, cur - 1, cur))
        self._last_up = np.where(up, tick, self._last_up)
        self._last_down = np.where(down, tick, self._last_down)
        self._targets = cur
        return PoolAction(target=cur)


@dataclass
class VectorExascalePolicy:
    """Vector form of :class:`ExascalePolicy`."""

    vectorized = True
    headroom: float = 1.15

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        return PoolAction(
            target=_scale_target_vec(
                obs.throughput,
                np.maximum(obs.window_peak, obs.ewma_rate),
                self.headroom,
            )
        )


@dataclass
class VectorMixedPolicy:
    """Vector form of :class:`MixedPolicy`."""

    vectorized = True

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        return PoolAction(
            target=_scale_target_vec(obs.throughput, obs.ewma_rate),
            offload=np.full(len(obs.keys), OFFLOAD_BLIND, dtype=np.int64),
        )


@dataclass
class VectorSpotParagonPolicy(VectorParagonPolicy):
    """Vector form of :class:`SpotParagonPolicy` (same knobs, same
    decisions: on-demand floor for the strict share, spot for the rest)."""

    strict_share: float = 0.25
    spot_buffer: float = 1.25

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        demand = obs.ewma_rate + obs.queue_len / self.drain_horizon_s
        floor = _scale_target_vec(obs.throughput, demand, self.strict_share)
        residual = np.maximum(0.0, demand - floor * obs.throughput)
        spot = np.ceil(residual * self.spot_buffer / obs.throughput).astype(
            np.int64
        )
        return PoolAction(
            target=floor,
            spot_target=spot,
            offload=np.full(len(obs.keys), OFFLOAD_SLACK_AWARE, dtype=np.int64),
        )


@dataclass
class VectorPortfolioPolicy(VectorParagonPolicy):
    """Vector form of :class:`PortfolioPolicy` (same knobs, same
    decisions: reserved floor, remote relaxed base, harvest by reclaim
    risk under the granted ceiling, spot for the rest)."""

    strict_share: float = 0.25
    remote_frac: float = 0.3
    harvest_margin: float = 0.15
    harvest_max_frac: float = 0.8
    harvest_buffer: float = 1.1
    spot_buffer: float = 1.25

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        thr = obs.throughput
        demand = obs.ewma_rate + obs.queue_len / self.drain_horizon_s
        floor = _scale_target_vec(thr, demand, self.strict_share)
        remote = (
            self.remote_frac * (1 - self.strict_share) * obs.ewma_rate / thr
        ).astype(np.int64)
        residual = np.maximum(0.0, demand - (floor + remote) * thr)
        h_frac = np.minimum(
            np.maximum(obs.harvest_level - self.harvest_margin, 0.0),
            self.harvest_max_frac,
        )
        h_want = np.ceil(residual * h_frac * self.harvest_buffer / thr)
        harvest = np.minimum(h_want, obs.harvest_ceiling).astype(np.int64)
        spot_resid = np.maximum(0.0, residual - harvest * thr)
        spot = np.ceil(spot_resid * self.spot_buffer / thr).astype(np.int64)
        return PoolAction(
            target=floor,
            spot_target=spot,
            harvest_target=harvest,
            remote_target=remote,
            offload=np.full(len(obs.keys), OFFLOAD_SLACK_AWARE, dtype=np.int64),
        )


# ---------------------------------------------------------------------------
# Variant decision math on ``[A]`` arrays.
# These are the single source of truth for the variant-aware policies:
# the dict schedulers and the vectorized schedulers below evaluate the
# same expressions, so the two cannot drift.  ``o`` maps
# :class:`PoolObs` field names to ``[A]`` arrays (see
# :func:`_variant_obs_dict`).  The ``*_torch``
# forms repeat each expression for torch tensors (which have no
# ``astype``) for the batched engine's ``TORCH_POLICIES``
# (``sim/torch_engine.py``); ``tests/test_torch_sim_engine.py`` holds
# each to its NumPy form.
# ---------------------------------------------------------------------------
def swap_aware_target_arrays(o, *, bursty_threshold: float,
                             flat_cushion: float, drain_horizon_s: float):
    """Paragon sizing against the slower of the active / in-flight
    variant's service rate (shared by the variant-aware policies)."""
    bursty = o["peak_to_median"] >= bursty_threshold
    headroom = np.where(bursty, 1.0, flat_cushion)
    demand = o["ewma_rate"] + o["queue_len"] / drain_horizon_s
    thr = o["throughput"] * np.minimum(1.0, o["variant_pending_ratio"])
    return np.maximum(1, np.ceil(demand * headroom / thr)).astype(np.int64)


def infaas_variant_move_arrays(o, tick, last_move, *, up_util: float,
                               down_util: float, post_swap_util: float,
                               queue_pressure_s: float, cooldown_s: int):
    """The INFaaS-style up/down variant move as one branchless pass.

    Returns ``(variant_target, new_last_move)``: ``variant_target`` in
    engine codes (-1 = hold), ``new_last_move`` the updated per-arch
    cooldown state the caller carries between ticks.  ``down`` and
    ``up`` are mutually exclusive (pressure vs ~pressure), so the
    where-chain reproduces the masked-assignment form exactly."""
    cap = np.maximum(o["n_active"], 1) * o["throughput"]
    # queue_len includes this tick's (not yet served) arrivals;
    # pressure / slack are about the carried-over backlog
    backlog = o["queue_len"] - o["rate"]
    pressure = (o["utilization"] >= down_util) | (
        backlog > queue_pressure_s * cap
    )
    slack = (o["utilization"] <= up_util) & (backlog <= 1e-6)
    ready = (~o["variant_in_flight"]) & (tick - last_move >= cooldown_s)
    down = (
        pressure & ready
        & (o["active_variant"] > o["variant_lo"])
        & (o["variant_down_ratio"] > 1.0 + 1e-9)
    )
    up = (
        slack & ~pressure & ready
        & (o["active_variant"] < o["n_variants"] - 1)
        & (o["utilization"] / o["variant_up_ratio"] <= post_swap_util)
    )
    tgt = np.where(
        down, o["active_variant"] - 1,
        np.where(up, o["active_variant"] + 1, -1),
    ).astype(np.int64)
    new_last_move = np.where(down | up, tick, last_move)
    return tgt, new_last_move


def accuracy_floor_move_arrays(o):
    """Cocktail-style least-cost selection: move to the cheapest variant
    meeting the stream's floor (hold while a swap is in flight)."""
    return np.where(
        (~o["variant_in_flight"])
        & (o["active_variant"] != o["variant_cheapest"]),
        o["variant_cheapest"],
        -1,
    ).astype(np.int64)


def swap_aware_target_torch(o, *, bursty_threshold, flat_cushion,
                            drain_horizon_s):
    """:func:`swap_aware_target_arrays` on torch tensors; the knobs may
    be Python numbers or tensors that broadcast (``[B, 1]`` per cell)."""
    bursty = o["peak_to_median"] >= bursty_threshold
    # a float64 operand keeps two Python numbers out of torch.where,
    # which would give the default (float32) dtype
    headroom = torch.where(bursty, torch.ones_like(o["ewma_rate"]),
                           flat_cushion)
    demand = o["ewma_rate"] + o["queue_len"] / drain_horizon_s
    thr = o["throughput"] * torch.clamp(o["variant_pending_ratio"], max=1.0)
    return torch.clamp(torch.ceil(demand * headroom / thr), min=1).to(
        torch.int64)


def infaas_variant_move_torch(o, tick, last_move, *, up_util, down_util,
                              post_swap_util, queue_pressure_s, cooldown_s):
    """:func:`infaas_variant_move_arrays` on torch tensors."""
    cap = torch.clamp(o["n_active"], min=1) * o["throughput"]
    backlog = o["queue_len"] - o["rate"]
    pressure = (o["utilization"] >= down_util) | (
        backlog > queue_pressure_s * cap
    )
    slack = (o["utilization"] <= up_util) & (backlog <= 1e-6)
    ready = (~o["variant_in_flight"]) & (tick - last_move >= cooldown_s)
    down = (
        pressure & ready
        & (o["active_variant"] > o["variant_lo"])
        & (o["variant_down_ratio"] > 1.0 + 1e-9)
    )
    up = (
        slack & ~pressure & ready
        & (o["active_variant"] < o["n_variants"] - 1)
        & (o["utilization"] / o["variant_up_ratio"] <= post_swap_util)
    )
    tgt = torch.where(
        down, o["active_variant"] - 1,
        torch.where(up, o["active_variant"] + 1, -1),
    ).to(torch.int64)
    new_last_move = torch.where(down | up, tick, last_move)
    return tgt, new_last_move


def accuracy_floor_move_torch(o):
    """:func:`accuracy_floor_move_arrays` on torch tensors."""
    return torch.where(
        (~o["variant_in_flight"])
        & (o["active_variant"] != o["variant_cheapest"]),
        o["variant_cheapest"],
        -1,
    ).to(torch.int64)


def _variant_obs_dict(obs: PoolObs) -> dict:
    """The ``[A]``-array view of a :class:`PoolObs` the ``*_arrays``
    variant math consumes."""
    return {
        "rate": obs.rate,
        "ewma_rate": obs.ewma_rate,
        "peak_to_median": obs.peak_to_median,
        "queue_len": obs.queue_len,
        "n_active": obs.n_active,
        "utilization": obs.utilization,
        "throughput": obs.throughput,
        "active_variant": obs.active_variant,
        "n_variants": obs.n_variants,
        "variant_lo": obs.variant_lo,
        "variant_cheapest": obs.variant_cheapest,
        "variant_in_flight": obs.variant_in_flight,
        "variant_up_ratio": obs.variant_up_ratio,
        "variant_down_ratio": obs.variant_down_ratio,
        "variant_pending_ratio": obs.variant_pending_ratio,
    }


def _swap_aware_target(obs: PoolObs, bursty_threshold: float,
                       flat_cushion: float, drain_horizon_s: float) -> np.ndarray:
    return swap_aware_target_arrays(
        _variant_obs_dict(obs), bursty_threshold=bursty_threshold,
        flat_cushion=flat_cushion, drain_horizon_s=drain_horizon_s,
    )


@dataclass
class VectorInfaasVariantPolicy(VectorParagonPolicy):
    """Vector form of :class:`InfaasVariantPolicy` (same knobs, same
    decisions, the per-arch cooldown dict an ``[A]`` array)."""

    up_util: float = 0.55
    down_util: float = 0.9
    post_swap_util: float = 0.75
    queue_pressure_s: float = 2.0
    cooldown_s: int = 120
    _last_move: np.ndarray = None

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        act = super().__call__(tick, obs)
        act.target = _swap_aware_target(
            obs, self.bursty_threshold, self.flat_cushion, self.drain_horizon_s
        )
        n = len(obs.keys)
        if self._last_move is None:
            self._last_move = np.full(n, -(10**9), dtype=np.int64)
        tgt, self._last_move = infaas_variant_move_arrays(
            _variant_obs_dict(obs), tick, self._last_move,
            up_util=self.up_util, down_util=self.down_util,
            post_swap_util=self.post_swap_util,
            queue_pressure_s=self.queue_pressure_s,
            cooldown_s=self.cooldown_s,
        )
        act.variant_target = tgt
        return act


@dataclass
class VectorAccuracyFloorPolicy(VectorParagonPolicy):
    """Vector form of :class:`AccuracyFloorPolicy`."""

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        act = super().__call__(tick, obs)
        act.target = _swap_aware_target(
            obs, self.bursty_threshold, self.flat_cushion, self.drain_horizon_s
        )
        act.variant_target = accuracy_floor_move_arrays(_variant_obs_dict(obs))
        return act


VECTOR_SCHEDULERS = {
    "reactive": VectorReactivePolicy,
    "util_aware": VectorUtilAwarePolicy,
    "exascale": VectorExascalePolicy,
    "mixed": VectorMixedPolicy,
    "paragon": VectorParagonPolicy,
    "spot_paragon": VectorSpotParagonPolicy,
    "portfolio": VectorPortfolioPolicy,
    "infaas_variant": VectorInfaasVariantPolicy,
    "accuracy_floor": VectorAccuracyFloorPolicy,
}

# The learned pool controller (paper §V) rides the same vectorized
# interface so benchmarks evaluate it head-to-head with the classical
# schemes.  Imported late: repro_torch.core.rl reuses the sim types above.
from repro_torch.core.rl.policy import RLPoolPolicy  # noqa: E402

VECTOR_SCHEDULERS["rl_pool"] = RLPoolPolicy
