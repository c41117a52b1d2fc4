"""Batched torch twin of the tick engine.

The port's counterpart of ``src/repro/core/sim/jax_engine.py``.  The
NumPy engine (:mod:`repro_torch.core.sim.engine`) advances one tick per
Python call: admit -> provision -> serve -> offload -> drop -> account.
This module runs the same pipeline as float64 tensor code over a leading
cell axis: every tensor is ``[B, ...]``, so a whole (scenario x seed x
policy-params) grid advances together, one Python iteration per tick,
and :func:`run_scenario` is :func:`run_grid` with ``B = 1``.  Per-cell
policy parameters are ``[B, 1]`` tensors that broadcast against the
``[B, A]`` observation fields.

Semantics are pinned to the NumPy engine, which stays the oracle
(``tests/test_torch_sim_engine.py`` holds the raw ledger to it at 1e-6
over the scenario zoo).  The representation is the reference twin's:

* **Prefix-sum age buffers.**  Queues are stored as running prefix sums
  along the age axis, oldest first (``S[..., j]`` totals the ``j+1``
  oldest buckets; the last column is the queue total).  Serving ``c``
  oldest-first is ``S' = max(S - c, 0)``, the late mass served is one
  gather at the lateness prefix, aging is a column shift and dropping
  the oldest bucket subtracts its prefix.
* **Cumulative-counter pipeline rings.**  Each tier's provisioning
  pipeline is a ring of clipped cumulative grant counters: slot
  ``t mod L`` holds the running total granted through tick ``t``, so a
  cohort matures when its slot comes round again.  Cancelling ``c``
  launches newest-first clips the curve from the top
  (``ring = min(ring, G - c)``), a numeric no-op on cancel-free ticks,
  so it runs every tick.  This is the reference's eager form; its lazy
  sliding-window-min rings are the same integers and are left for later
  tuning.
* **Everything runs every tick.**  Every tier provisions, serves and
  accounts on every tick; an idle tier adds exact zeros, and per-tick
  liveness flags rebuild the summary's key set.
* **Host-precomputed inputs.**  The monitor statistics
  (:func:`~repro_torch.core.load_monitor.pool_stats_trajectory`), the
  harvest signal and the spot reclaim uniforms
  (:func:`~repro_torch.core.sim.fleet.harvest_level_trajectory`,
  :func:`~repro_torch.core.sim.fleet.spot_reclaim_uniforms`) are made
  on the host, bit-identical to the streams the NumPy tiers draw, and
  moved to the device once, before the tick loop.

The tick loop never waits on the device: every branch is on host-known
Python values (the tick index, the ring slot ``t mod L``, the static
reclaim probability), the binomial walk runs all
:data:`~repro_torch.core.sim.fleet.BINOMIAL_KMAX` steps instead of
exiting early, and on a CUDA device the loop runs under
``torch.cuda.set_sync_debug_mode("error")``, so a sync raises.

Every tensor is float64, int64 or the rings' int32 by explicit dtype;
torch's promotion differs from NumPy's (an integer tensor divided by
anything, or an integer or boolean tensor times a Python float, gives
float32), so integer fields are cast to float64 before such operations
and float scalars ride in as 0-d float64 tensors.  The global default
dtype is never changed.

With a process group of n > 1 ranks up (``distributed.device_mesh``),
:func:`run_grid` splits its cells across the ranks, as the reference's
sharded runner splits them across a mesh's devices: rank r runs its B/n
contiguous cells on its own device, and the ranks exchange the assembled
cells once at the end (cells never communicate, so the sharded and
unsharded grids give the same cells, bit for bit).

Left out against the reference: its XLA-only runner flavours
(``make_runner``'s legacy/unroll/donation options, the runner trace
counters and their telemetry gauge).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hardware import PRICING, FleetPricing
from repro_torch.core.load_monitor import LoadMonitor, pool_stats_trajectory
from repro_torch.core.rl.obs import (
    decode_tables,
    pool_features_torch,
    procurement_targets_torch,
    variant_targets_torch,
)
from repro_torch.core.rl.policy import (
    _fallback_params,
    load_policy_checkpoint,
    policy_logits_torch,
)
from repro_torch.core.schedulers import (
    accuracy_floor_move_torch,
    infaas_variant_move_torch,
    swap_aware_target_torch,
)
from repro_torch.core.sim.engine import ServingSim
from repro_torch.core.sim.fleet import (
    BINOMIAL_KMAX,
    harvest_level_trajectory,
    spot_reclaim_uniforms,
)
from repro_torch.core.sim.types import ArchLoad
from repro_torch.distributed.sharding import device_mesh

__all__ = [
    "SimState",
    "TORCH_POLICIES",
    "binomial_from_uniform_torch",
    "build_sim_inputs",
    "run_scenario",
    "run_grid",
]

F64 = torch.float64
I64 = torch.int64


# ---------------------------------------------------------------------------
# State.
# ---------------------------------------------------------------------------
class SimState(NamedTuple):
    """All engine / tier / queue / monitor state for one tick, flat,
    each tensor with the leading cell axis ``B``.

    ``*_buf`` are ``[B, A, W]`` oldest-first queue prefix sums.  Each
    tier pipeline is a cumulative-counter ring: ``*_ring [B, A, L]``
    holds the clipped cumulative granted count by launch slot,
    ``*_cum [B, A]`` the current cumulative total and ``*_mat [B, A]``
    the cumulative matured total.
    """

    qs_buf: Any          # [B, A, Ws] strict queue prefix mass (f64)
    qr_buf: Any          # [B, A, Wr] relaxed queue prefix mass (f64)
    res_active: Any      # [B, A]     reserved instances (i64)
    res_ring: Any        # [B, A, Lr] cumulative grants by launch slot (i32)
    res_cum: Any         # [B, A]     cumulative granted (i32)
    res_mat: Any         # [B, A]     cumulative matured (i32)
    spot_active: Any
    spot_ring: Any
    spot_cum: Any
    spot_mat: Any
    harv_active: Any
    harv_ring: Any
    harv_cum: Any
    harv_mat: Any
    rem_active: Any
    rem_ring: Any
    rem_cum: Any
    rem_mat: Any
    burst_last_used: Any  # [B, A] last tick the burst pool saw each arch
    last_util: Any        # [B, A] previous tick's utilization (policy obs)
    last_viol: Any        # [B, A] previous tick's violation delta
    prev_rate: Any        # [B, A] previous tick's arrivals (RL trend feature)
    ewma: Any = None      # [B, A] in-loop EWMA (None when fed as an input)
    # model-variant swap slot (None on catalog-free runs): the NumPy
    # SwapPipeline's (current, pending, ready_at) triple; at most one
    # swap per arch is in flight, so every op is O(A)
    var_cur: Any = None       # [B, A] active variant index (i64)
    var_pending: Any = None   # [B, A] in-flight swap target, -1 = none
    var_ready: Any = None     # [B, A] tick the in-flight swap matures
    var_last_move: Any = None  # [B, A] variant-policy cooldown state


# ---------------------------------------------------------------------------
# Primitive ops (twins of the NumPy engine's steps).
# ---------------------------------------------------------------------------
def binomial_from_uniform_torch(n, p: float, u):
    """Tensor twin of :func:`repro_torch.core.sim.fleet.binomial_from_uniform`.

    The same inverse-CDF walk, with the same association of every
    product and sum, run for all :data:`BINOMIAL_KMAX` steps at once
    instead of exiting early: the ``u >= cdf`` indicator is monotone in
    the walk, so the steps the NumPy loop skips add nothing to the
    count.  The pmf chain ``pmf_j = pmf_{j-1} * r_j * (p/q)`` is one
    cumulative product over the interleaved factors, the CDF one
    cumulative sum.  ``p`` is a host float (the tier's static reclaim
    probability), so its degenerate cases branch on the host."""
    if p <= 0.0:
        return torch.zeros_like(n)
    if p >= 1.0:
        return n.clone()
    nf = n.to(F64)
    q = 1.0 - p
    j = torch.arange(1, BINOMIAL_KMAX + 1, dtype=F64, device=n.device)
    r = (nf[..., None] - (j - 1.0)) / j                   # [..., K]
    pq = torch.full_like(r, p / q)
    pmf0 = torch.pow(q, nf)
    chain = torch.stack((r, pq), dim=-1).flatten(-2)       # r1, pq, r2, pq..
    chain = torch.cat((pmf0[..., None], chain), dim=-1)
    pmf = torch.cumprod(chain, dim=-1)[..., ::2]           # pmf_0 .. pmf_K
    # the NumPy walk clamps each term at 0; a negative factor only
    # follows the exact zero at j = n + 1, so this clamp is the same
    cdf = torch.cumsum(torch.clamp(pmf, min=0.0), dim=-1)
    k = (u[..., None] >= cdf).sum(dim=-1).to(n.dtype)
    return torch.minimum(k, n)


def _age_queue(S):
    """One tick of queue aging: a left shift of the prefix columns (the
    oldest bucket is empty by construction, the total is preserved)."""
    return torch.cat((S[..., 1:], S[..., -1:]), dim=-1)


def _late_mass(S, late):
    """Mass in the ``n_late[a]`` oldest buckets of a prefix queue.
    ``late`` is ``(idx [B, A, 1], has [A])`` from :func:`_late_index`."""
    idx, has = late
    picked = torch.gather(S, -1, idx)[..., 0]
    return torch.where(has, picked, 0.0)


def _serve(S, capacity, late):
    """Oldest-first serve from a prefix queue; returns ``(S, served,
    late)``."""
    served = torch.minimum(S[..., -1], capacity)
    late_served = torch.minimum(_late_mass(S, late), capacity)
    S = torch.clamp(S - capacity[..., None], min=0.0)
    return S, served, late_served


class _Pipe(NamedTuple):
    """A tier's cumulative-counter pipeline ring (module docstring)."""

    ring: Any   # [B, A, L] clipped cumulative grants by launch slot (i32)
    cum: Any    # [B, A]    cumulative granted, post-cancel (i32)
    mat: Any    # [B, A]    cumulative matured (i32)


def _pipe_cancel_begin(p: _Pipe, counts, slot: int):
    """Cancel up to ``counts`` in-flight launches at the start of a tick,
    in the NumPy engine's order.

    ``ProvisionPipeline.cancel_newest`` walks the launch ticks
    ``t, t-1, ..., t-L+1``; before this tick's pop, buffer column
    ``t mod L`` still holds the cohort launched at ``t - L``, the one
    maturing now, so the NumPy walk cancels that cohort first and then
    the others newest-first.  In cumulative form: taking ``c1`` from the
    maturing (oldest) cohort lowers every stored total of a launch at or
    after ``t - L`` (every slot, once ``t >= L``, the only case where
    that cohort is nonzero) and ``cum`` by ``c1``; the rest is the usual
    clip from the top.  The reference twin's ``_pipe_cancel`` clips from
    the top only, which differs from the NumPy engine on ticks where a
    cohort matures while a reclaim or an eviction cancels."""
    v = p.ring[..., slot]
    cancel = torch.minimum(counts, p.cum - p.mat).to(p.cum.dtype)
    c1 = torch.minimum(cancel, v - p.mat)                # the maturing cohort
    cum = p.cum - cancel
    ring = torch.minimum(p.ring - c1[..., None], cum[..., None])
    return _Pipe(ring, cum, p.mat)


def _tier_set_target(active, p: _Pipe, target, slot: int):
    """One tier tick on a pipeline ring: admit the cohort maturing at
    this tick's slot, then grow or shrink toward ``target`` (cancel
    in-flight newest-first before releasing active).  ``slot`` is the
    host int ``t mod L``."""
    v = p.ring[..., slot]
    ready = (v - p.mat).to(active.dtype)
    active = active + ready
    pending = (p.cum - v).to(active.dtype)
    in_flight = active + pending
    grow = torch.clamp(target - in_flight, min=0)
    shrink = in_flight - target
    cancel = torch.where(shrink > 0, torch.minimum(pending, shrink), 0)
    cum = p.cum + grow.to(p.cum.dtype) - cancel.to(p.cum.dtype)
    # a new ring: ``v`` stays a view of the old one, never written again
    ring = torch.minimum(p.ring, cum[..., None])
    ring[..., slot] = cum
    active = torch.where(
        shrink > 0, torch.minimum(active, torch.clamp(target, min=0)), active
    )
    return active, _Pipe(ring, cum, v)


def _spot_begin(active, p: _Pipe, u, p_reclaim: float, slot: int):
    """``SpotTier.begin_tick``: i.i.d. reclaims on active instances and
    in-flight launches (cancelled in :func:`_pipe_cancel_begin`'s order),
    from this tick's precomputed uniform pair ``u [B, 2, A]``; both draws
    walk the CDF in one call."""
    drawn = binomial_from_uniform_torch(
        torch.stack((active, (p.cum - p.mat).to(active.dtype)), dim=1),
        p_reclaim, u)
    reclaimed, lost = drawn[:, 0], drawn[:, 1]
    p = _pipe_cancel_begin(p, lost, slot)
    return active - reclaimed, p, drawn.sum((1, 2))


def _harvest_begin(active, p: _Pipe, ceiling, slot: int):
    """``HarvestVMTier.begin_tick``: evict active above the granted
    ceiling (``[B, 1]``, correlated across the pool), cancel in-flight
    overflow (:func:`_pipe_cancel_begin`)."""
    evicted = torch.clamp(active - ceiling, min=0)
    active = active - evicted
    over = torch.clamp(active + (p.cum - p.mat) - ceiling, min=0)
    p = _pipe_cancel_begin(p, over, slot)
    return active, p, evicted.sum(-1)


def _offload(S, mask, last_used, t: int, slo_s, st):
    """``BurstTier.offload`` of one class's drained queues: drain the
    masked archs, zero sub-epsilon residue in the offload counts (the
    queue rows are emptied regardless), score first-invocation cold
    starts, bill per request."""
    counts = S[..., -1] * mask
    counts = torch.where(counts <= 1e-9, 0.0, counts)
    S = S * (~mask)[..., None]
    cold = (t - last_used) > st["idle_timeout"]
    lat_first = st["spinup"] + st["lat_b1"] + cold * st["cold_start"]
    lat_warm = st["spinup"] + st["lat_b1"]
    first = torch.clamp(counts, max=1.0)
    viol = first * (lat_first > slo_s) + (counts - first) * (lat_warm > slo_s)
    cost_arch = st["burst_cpr"] * counts
    last_used = torch.where(counts > 0, float(t), last_used)
    return S, counts, viol, cost_arch, last_used


# ---------------------------------------------------------------------------
# Policies: twins of the vectorized schedulers.  Each maps
# ``(params, obs, xs) -> (action dict, extras dict)``; obs is a dict of
# [B, A] tensors (the PoolObs), params a dict of per-cell [B, 1] tensors
# and the action dict carries ``target / offload / spot / harvest /
# remote`` int64 tensors.
# ---------------------------------------------------------------------------
_OFFLOAD_SLACK_AWARE = 2


def _scale_target(throughput, demand, headroom=1.0):
    return torch.clamp(torch.ceil(demand * headroom / throughput), min=1).to(
        I64)


def _pol_reactive(params, obs, xs):
    tgt = _scale_target(obs["throughput"], obs["ewma_rate"])
    z = torch.zeros_like(tgt)
    return dict(target=tgt, offload=z, spot=z, harvest=z, remote=z), {}


def _pol_paragon(params, obs, xs):
    bursty = obs["peak_to_median"] >= params["bursty_threshold"]
    headroom = torch.where(bursty, torch.ones_like(obs["ewma_rate"]),
                           params["flat_cushion"])
    demand = obs["ewma_rate"] + obs["queue_len"] / params["drain_horizon_s"]
    tgt = _scale_target(obs["throughput"], demand, headroom)
    z = torch.zeros_like(tgt)
    off = torch.full_like(tgt, _OFFLOAD_SLACK_AWARE)
    return dict(target=tgt, offload=off, spot=z, harvest=z, remote=z), {}


def _pol_portfolio(params, obs, xs):
    thr = obs["throughput"]
    demand = obs["ewma_rate"] + obs["queue_len"] / params["drain_horizon_s"]
    floor = _scale_target(thr, demand, params["strict_share"])
    remote = (
        params["remote_frac"] * (1 - params["strict_share"])
        * obs["ewma_rate"] / thr
    ).to(I64)
    residual = torch.clamp(demand - (floor + remote) * thr, min=0.0)
    h_frac = torch.minimum(
        torch.clamp(obs["harvest_level"] - params["harvest_margin"], min=0.0),
        params["harvest_max_frac"],
    )
    h_want = torch.ceil(residual * h_frac * params["harvest_buffer"] / thr)
    harvest = torch.minimum(h_want, obs["harvest_ceiling"].to(F64)).to(I64)
    spot_resid = torch.clamp(residual - harvest * thr, min=0.0)
    spot = torch.ceil(spot_resid * params["spot_buffer"] / thr).to(I64)
    off = torch.full_like(floor, _OFFLOAD_SLACK_AWARE)
    return dict(
        target=floor, offload=off, spot=spot, harvest=harvest, remote=remote
    ), {}


def _features(params, obs):
    return pool_features_torch(
        obs, obs["prev_rate"],
        rate_scale=params["rate_scale"], fleet_scale=params["fleet_scale"],
    )


def _net_forward(net, feats):
    """The PPO net's forward pass: :func:`policy_logits_torch`'s
    expression for the policy head, the value head beside it on the same
    torso."""
    w1 = net["torso1"]["w"]
    h = torch.tanh(feats.to(w1.dtype) @ w1 + net["torso1"]["b"])
    h = torch.tanh(h @ net["torso2"]["w"] + net["torso2"]["b"])
    logits = h @ net["pi"]["w"] + net["pi"]["b"]
    value = (h @ net["v"]["w"] + net["v"]["b"])[..., 0]
    return logits, value


def _rl_action(obs, actions):
    target, offload, spot, vmove = procurement_targets_torch(
        actions, obs["decode_tables"],
        ewma_rate=obs["ewma_rate"],
        queue_strict=obs["queue_strict"],
        queue_relaxed=obs["queue_relaxed"],
        throughput=obs["throughput"],
        n_spot=obs["n_spot"],
        n_spot_pending=obs["n_spot_pending"],
    )
    z = torch.zeros_like(target)
    # the variant head, decoded like the host path (procurement_action);
    # on catalog-free runs the tick never reads the "variant" entry
    variant = variant_targets_torch(
        obs["active_variant"], obs["n_variants"], vmove
    )
    return dict(target=target, offload=offload, spot=spot, harvest=z,
                remote=z, variant=variant)


def _pol_rl_greedy(params, obs, xs):
    """``RLPoolPolicy(greedy=True)``: argmax over the checkpoint net's
    logits (ties go to the first index, as NumPy's argmax)."""
    logits = policy_logits_torch(params["net"], _features(params, obs))
    return _rl_action(obs, torch.argmax(logits, dim=-1)), {}


def sample_categorical(logits, u):
    """Inverse-CDF draw: the first category whose cumulative softmax
    probability exceeds ``u`` (``[..., N]`` logits, ``[...]`` uniforms)."""
    cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    k = (u[..., None] >= cdf).sum(dim=-1)
    return torch.clamp(k, max=logits.shape[-1] - 1)


def _pol_rl_sample(params, obs, xs):
    """Stochastic PPO policy with rollout extras: actions drawn by
    :func:`sample_categorical` from per-tick uniforms (an explicitly
    seeded torch stream; the reference draws from JAX's key chain, which
    torch cannot reproduce), and the log-probability, value and feature
    matrix a rollout collector keeps."""
    feats = _features(params, obs)
    logits, value = _net_forward(params["net"], feats)
    actions = sample_categorical(logits, xs["u_act"])
    logp = torch.gather(
        torch.log_softmax(logits, dim=-1), -1, actions[..., None]
    )[..., 0]
    extras = {"obs": feats, "action": actions, "logp": logp, "value": value}
    return _rl_action(obs, actions), extras


def _pol_infaas_variant(params, obs, xs):
    """Twin of ``VectorInfaasVariantPolicy``: Paragon offload, swap-aware
    sizing and the INFaaS up/down move, through the shared ``*_torch``
    expressions of ``core/schedulers.py``; the per-arch cooldown state
    rides in the loop state (``SimState.var_last_move``)."""
    tgt = swap_aware_target_torch(
        obs, bursty_threshold=params["bursty_threshold"],
        flat_cushion=params["flat_cushion"],
        drain_horizon_s=params["drain_horizon_s"],
    )
    variant, last_move = infaas_variant_move_torch(
        obs, obs["tick"], obs["variant_last_move"],
        up_util=params["up_util"], down_util=params["down_util"],
        post_swap_util=params["post_swap_util"],
        queue_pressure_s=params["queue_pressure_s"],
        cooldown_s=params["cooldown_s"],
    )
    z = torch.zeros_like(tgt)
    off = torch.full_like(tgt, _OFFLOAD_SLACK_AWARE)
    return dict(target=tgt, offload=off, spot=z, harvest=z, remote=z,
                variant=variant, variant_last_move=last_move), {}


def _pol_accuracy_floor(params, obs, xs):
    """Twin of ``VectorAccuracyFloorPolicy``: swap-aware sizing and a
    move to the cheapest floor-satisfying variant."""
    tgt = swap_aware_target_torch(
        obs, bursty_threshold=params["bursty_threshold"],
        flat_cushion=params["flat_cushion"],
        drain_horizon_s=params["drain_horizon_s"],
    )
    z = torch.zeros_like(tgt)
    off = torch.full_like(tgt, _OFFLOAD_SLACK_AWARE)
    return dict(target=tgt, offload=off, spot=z, harvest=z, remote=z,
                variant=accuracy_floor_move_torch(obs)), {}


class TorchPolicy(NamedTuple):
    apply: Callable            # (params, obs, xs) -> (actions, extras)
    needs_stats: bool          # True: policy reads peak_to_median
    needs_uniforms: bool       # True: per-tick action uniforms enter
    default_params: Callable   # () -> params dict


def _rl_default_params() -> dict:
    params, meta = load_policy_checkpoint()
    if params is None:
        params = _fallback_params(0)
    return {
        "net": params,
        "rate_scale": float(meta.get("rate_scale", 100.0)),
        "fleet_scale": float(meta.get("fleet_scale", 10.0)),
    }


#: twins of the vectorized schedulers, by registry name
TORCH_POLICIES: Dict[str, TorchPolicy] = {
    "reactive": TorchPolicy(_pol_reactive, False, False, lambda: {}),
    "paragon": TorchPolicy(
        _pol_paragon, True, False,
        lambda: dict(bursty_threshold=1.5, flat_cushion=1.1,
                     drain_horizon_s=5.0),
    ),
    "portfolio": TorchPolicy(
        _pol_portfolio, False, False,
        lambda: dict(drain_horizon_s=5.0, strict_share=0.25, remote_frac=0.3,
                     harvest_margin=0.15, harvest_max_frac=0.8,
                     harvest_buffer=1.1, spot_buffer=1.25),
    ),
    "rl_pool": TorchPolicy(_pol_rl_greedy, True, False, _rl_default_params),
    "rl_sample": TorchPolicy(_pol_rl_sample, True, True, _rl_default_params),
    "infaas_variant": TorchPolicy(
        _pol_infaas_variant, True, False,
        lambda: dict(bursty_threshold=1.5, flat_cushion=1.1,
                     drain_horizon_s=5.0, up_util=0.55, down_util=0.9,
                     post_swap_util=0.75, queue_pressure_s=2.0,
                     cooldown_s=120),
    ),
    "accuracy_floor": TorchPolicy(
        _pol_accuracy_floor, True, False,
        lambda: dict(bursty_threshold=1.5, flat_cushion=1.1,
                     drain_horizon_s=5.0),
    ),
}


# ---------------------------------------------------------------------------
# The tick function.
# ---------------------------------------------------------------------------
_EWMA_ALPHA = float(LoadMonitor.ewma_alpha)


def _pipe_of(state: SimState, pre: str) -> _Pipe:
    return _Pipe(getattr(state, pre + "_ring"), getattr(state, pre + "_cum"),
                 getattr(state, pre + "_mat"))


def _gather_v(table, idx):
    """Row-wise gather from a padded ``[A, V]`` catalog table at
    ``[B, A]`` indices."""
    B = idx.shape[0]
    return torch.gather(table.expand(B, *table.shape), -1, idx[..., None])[
        ..., 0]


def _tick(state: SimState, t: int, xs: dict, st: dict, policy_apply,
          variants: bool):
    """One engine tick: ``(state, inputs) -> (state, metrics)``.

    Mirrors ``ServingSim.observe_pool`` + ``_step`` operation for
    operation, as the reference twin's ``_tick`` does.  ``t`` is the
    host tick index.  With a catalog (``variants``) the tick follows
    the NumPy ordering: the observation gathers at the pre-pop active
    variant, due swaps land before serving, new requests enter the
    depth-1 slot after the pop, and serving, burst billing, accuracy
    and chip accounting gather at the post-pop variant."""
    rate = xs["rate"]
    if state.ewma is not None:
        # the first observe seeds the EWMA with the raw rates
        ewma = rate if t == 0 else (
            _EWMA_ALPHA * rate + (1.0 - _EWMA_ALPHA) * state.ewma)
    else:
        ewma = xs["ewma"]

    # ---- admit: age the queues, new arrivals into the newest bucket
    # (only the total prefix) ------------------------------------------
    qs_buf = _age_queue(state.qs_buf)
    qr_buf = _age_queue(state.qr_buf)
    n_strict = rate * st["strict_frac"]
    n_relaxed = rate - n_strict
    qs_buf[..., -1] += n_strict
    qr_buf[..., -1] += n_relaxed
    qs_tot = qs_buf[..., -1]
    qr_tot = qr_buf[..., -1]

    # ---- variant observation (pre-pop) --------------------------------
    if variants:
        v_cur = state.var_cur
        v_pend = state.var_pending
        smult_cur = _gather_v(st["var_smult"], v_cur)
        v_up = torch.minimum(v_cur + 1, st["var_n"] - 1)
        v_dn = torch.clamp(v_cur - 1, min=0)
        vobs = {
            "throughput": st["thr"] * smult_cur,
            "active_variant": v_cur,
            "n_variants": st["var_n"],
            "accuracy": _gather_v(st["var_acc"], v_cur),
            "accuracy_floor": st["acc_floor"],
            "variant_lo": st["var_lo"],
            "variant_cheapest": st["var_cheapest"],
            "variant_in_flight": v_pend >= 0,
            "variant_up_ratio": _gather_v(st["var_smult"], v_up) / smult_cur,
            "variant_down_ratio": _gather_v(st["var_smult"], v_dn) / smult_cur,
            "variant_pending_ratio": torch.where(
                v_pend >= 0,
                _gather_v(st["var_smult"], torch.clamp(v_pend, min=0))
                / smult_cur,
                1.0,
            ),
            "variant_last_move": state.var_last_move,
        }
    else:
        vobs = {
            "throughput": st["thr"],
            "active_variant": st["zeros_i"],
            "n_variants": st["ones_i"],
            "accuracy": st["cur_acc"],
            "accuracy_floor": st["acc_floor"],
            "variant_lo": st["zeros_i"],
            "variant_cheapest": st["zeros_i"],
            "variant_in_flight": st["false_b"],
            "variant_up_ratio": st["ones_f"],
            "variant_down_ratio": st["ones_f"],
            "variant_pending_ratio": st["ones_f"],
            "variant_last_move": st["neg_i"],
        }

    # ---- observe (pre-provision state, like observe_pool) -------------
    bshape = rate.shape
    obs = {
        "rate": rate,
        "ewma_rate": ewma,
        "peak_to_median": xs["p2m"] if "p2m" in xs else st["ones_f"],
        "queue_len": qs_tot + qr_tot,
        "queue_strict": qs_tot,
        "queue_relaxed": qr_tot,
        "n_active": state.res_active,
        "n_pending": (state.res_cum - state.res_mat).to(I64),
        "n_spot": state.spot_active,
        "n_spot_pending": (state.spot_cum - state.spot_mat).to(I64),
        "n_harvest": state.harv_active,
        "n_harvest_pending": (state.harv_cum - state.harv_mat).to(I64),
        "n_remote": state.rem_active,
        "n_remote_pending": (state.rem_cum - state.rem_mat).to(I64),
        "utilization": state.last_util,
        "last_violations": state.last_viol,
        "harvest_level": xs["h_lev_obs"].expand(bshape),
        "harvest_ceiling": xs["h_ceil_obs"].expand(bshape),
        "spot_reclaim_risk": st["risk"],
        "tick": t,
        "prev_rate": state.prev_rate,
        "decode_tables": st["decode_tables"],
        **vobs,
    }
    acts, extras = policy_apply(st["policy"], obs, xs)

    # ---- variant swaps: pop matured swaps before provisioning and
    # serving, then enqueue this tick's requests into the depth-1 slot -
    if variants:
        done = (v_pend >= 0) & (state.var_ready <= t)
        v_cur = torch.where(done, v_pend, v_cur)
        v_pend = torch.where(done, -1, v_pend)
        swaps = done.sum(-1)
        cur_acc = _gather_v(st["var_acc"], v_cur)
        thr = st["thr"] * _gather_v(st["var_smult"], v_cur)
        chips = st["chips"] * _gather_v(st["var_cmult"], v_cur)
        st_off = dict(
            st,
            lat_b1=st["lat_b1"] * _gather_v(st["var_lmult"], v_cur),
            burst_cpr=(chips / thr) * st["burst_chip_s"] + st["inv_fee"],
        )
        # re-targeting the current variant cancels the in-flight swap;
        # re-requesting the in-flight target leaves its clock alone;
        # anything else (re)starts the slot
        req = torch.minimum(acts.get("variant", st["neg_i"]), st["var_n"] - 1)
        cancel = (req >= 0) & (req == v_cur)
        v_pend = torch.where(cancel, -1, v_pend)
        start = (req >= 0) & (req != v_cur) & (req != v_pend)
        v_pend = torch.where(start, req, v_pend)
        v_ready = torch.where(start, t + st["swap_lat"], state.var_ready)
        v_last_move = acts.get("variant_last_move", state.var_last_move)
    else:
        thr = st["thr"]
        chips = st["chips"]
        cur_acc = st["cur_acc"]
        st_off = st

    # ---- provision (reserved, then aux in registration order); each
    # tier's ring slot for this tick is t mod L ------------------------
    res_active, res_pipe = _tier_set_target(
        state.res_active, _pipe_of(state, "res"), acts["target"],
        t % state.res_ring.shape[-1],
    )
    spot_active, spot_pipe, reclaimed = _spot_begin(
        state.spot_active, _pipe_of(state, "spot"), xs["spot_u"],
        st["p_reclaim"], t % state.spot_ring.shape[-1],
    )
    spot_active, spot_pipe = _tier_set_target(
        spot_active, spot_pipe, acts["spot"], t % state.spot_ring.shape[-1],
    )
    harv_active, harv_pipe, evicted = _harvest_begin(
        state.harv_active, _pipe_of(state, "harv"), xs["h_ceil"],
        t % state.harv_ring.shape[-1],
    )
    harv_active, harv_pipe = _tier_set_target(
        harv_active, harv_pipe, torch.minimum(acts["harvest"], xs["h_ceil"]),
        t % state.harv_ring.shape[-1],
    )
    rem_active, rem_pipe = _tier_set_target(
        state.rem_active, _pipe_of(state, "rem"), acts["remote"],
        t % state.rem_ring.shape[-1],
    )
    preempt = reclaimed + evicted

    # ---- serve: local capacity first (strict priority), then the
    # remote group against its egress-tightened lateness prefixes ------
    cap_local = (res_active + spot_active + harv_active) * thr
    qs_buf, served_s, late_s = _serve(qs_buf, cap_local, st["late_s"])
    rem_cap = rem_active * thr
    qs_buf, srs, lrs = _serve(qs_buf, rem_cap, st["rlate_s"])
    qr_buf, served_r, late_r = _serve(
        qr_buf, cap_local - served_s, st["late_r"]
    )
    qr_buf, srr, lrr = _serve(qr_buf, rem_cap - srs, st["rlate_r"])
    served_s, late_s = served_s + srs, late_s + lrs
    served_r, late_r = served_r + srr, late_r + lrr
    served = served_s + served_r
    cap_total = cap_local + rem_cap
    util = torch.where(
        cap_total > 0,
        served / torch.where(cap_total > 0, cap_total, 1.0),
        1.0,
    )
    viol_arch = late_s + late_r
    viol_strict = late_s.sum(-1)

    # ---- offload to burst (strict: any offload mode; relaxed: blind
    # only), sequential so the relaxed batch sees a warmed pool --------
    offload = acts["offload"]
    qs_buf, counts_s, bviol_s, bcost_s, last_used = _offload(
        qs_buf, offload >= 1, state.burst_last_used, t, st["slo_strict"],
        st_off,
    )
    qr_buf, counts_r, bviol_r, bcost_r, last_used = _offload(
        qr_buf, offload == 1, last_used, t, st["slo_relaxed"], st_off,
    )
    viol_arch = viol_arch + bviol_s + bviol_r
    viol_strict = viol_strict + bviol_s.sum(-1)

    # ---- drop the bucket that aged past the abandon window ------------
    dropped_s = qs_buf[..., 0]
    qs_buf = torch.clamp(qs_buf - dropped_s[..., None], min=0.0)
    dropped_r = qr_buf[..., 0]
    qr_buf = torch.clamp(qr_buf - dropped_r[..., None], min=0.0)
    dropped = dropped_s + dropped_r
    viol_arch = viol_arch + dropped
    viol_strict = viol_strict + dropped_s.sum(-1)

    # ---- delivered accuracy -------------------------------------------
    answered = served + counts_s + counts_r + dropped
    acc_w = answered * cur_acc
    acc_viol = answered * (cur_acc < st["acc_floor"] - 1e-12)

    # ---- account -------------------------------------------------------
    ch_res = res_active * chips
    ch_spot = spot_active * chips
    ch_harv = harv_active * chips
    ch_rem = rem_active * chips
    cost_arch = (
        bcost_s + bcost_r
        + ch_res * st["p_res"] + ch_spot * st["p_spot"]
        + ch_harv * st["p_harv"] + ch_rem * st["p_rem"]
    )
    chip_all = ch_res + ch_spot + ch_harv + ch_rem
    need = torch.ceil(rate / thr) * chips

    # summary key presence: a tier posts (even $0) only on live ticks
    harv_live = (
        harv_active.sum(-1) + (harv_pipe.cum - harv_pipe.mat).sum(-1)
    ) > 0
    rem_live = (
        rem_active.sum(-1) + (rem_pipe.cum - rem_pipe.mat).sum(-1)
    ) > 0

    var_kw, var_ys = {}, {}
    if variants:
        var_kw = dict(var_cur=v_cur, var_pending=v_pend, var_ready=v_ready,
                      var_last_move=v_last_move)
        # "swaps" is a flow; the rest are per-tick gauges at the NumPy
        # recorder's end_tick sampling points
        var_ys = {
            "swaps": swaps,
            "active_variant": v_cur,
            "swap_in_flight": v_pend >= 0,
            "acc_rate": cur_acc.expand(bshape),
        }
    new_state = SimState(
        qs_buf=qs_buf, qr_buf=qr_buf,
        res_active=res_active,
        res_ring=res_pipe.ring, res_cum=res_pipe.cum, res_mat=res_pipe.mat,
        spot_active=spot_active,
        spot_ring=spot_pipe.ring, spot_cum=spot_pipe.cum,
        spot_mat=spot_pipe.mat,
        harv_active=harv_active,
        harv_ring=harv_pipe.ring, harv_cum=harv_pipe.cum,
        harv_mat=harv_pipe.mat,
        rem_active=rem_active,
        rem_ring=rem_pipe.ring, rem_cum=rem_pipe.cum, rem_mat=rem_pipe.mat,
        burst_last_used=last_used, last_util=util, last_viol=viol_arch,
        prev_rate=rate,
        ewma=ewma if state.ewma is not None else None,
        **var_kw,
    )
    ys = {
        "served": served,
        "burst": counts_s + counts_r,
        "dropped": dropped,
        "viol": viol_arch,
        "viol_strict": viol_strict,
        "acc_w": acc_w,
        "acc_viol": acc_viol,
        "cost_arch": cost_arch,
        "cost_res": ch_res.sum(-1) * st["p_res"],
        "cost_spot": ch_spot.sum(-1) * st["p_spot"],
        "cost_harv": ch_harv.sum(-1) * st["p_harv"],
        "cost_rem": ch_rem.sum(-1) * st["p_rem"],
        "cost_burst": bcost_s.sum(-1) + bcost_r.sum(-1),
        "preempt": preempt,
        "chip": chip_all.sum(-1),
        "need": need.sum(-1),
        "over": torch.clamp(chip_all - need, min=0.0).sum(-1),
        "harv_live": harv_live,
        "rem_live": rem_live,
        # fleet / queue gauges for the per-tick trajectory
        "n_res": res_active,
        "n_spot": spot_active,
        "n_harv": harv_active,
        "n_rem": rem_active,
        "queue_strict": qs_buf[..., -1],
        "queue_relaxed": qr_buf[..., -1],
        **var_ys,
        **extras,
    }
    return new_state, ys


# ---------------------------------------------------------------------------
# Host-side input builder.
# ---------------------------------------------------------------------------
def _finalize_mask(q) -> np.ndarray:
    """Lateness mask for the end-of-trace sweep: the sweep runs one tick
    after the last shift, so every bucket is one tick older."""
    ages = np.arange(q.window - 1, -1, -1) + 1
    return ages[None, :] > q.slack[:, None]


def _n_late(mask: np.ndarray) -> np.ndarray:
    """An oldest-first lateness mask is age-contiguous from bucket 0, so
    its per-arch count describes it: the prefix queues' gather index."""
    n = mask.sum(axis=1).astype(np.int64)
    w = mask.shape[1]
    assert (mask == (np.arange(w)[None, :] < n[:, None])).all()
    return n


def build_sim_inputs(
    arrivals: np.ndarray,
    workload: List[ArchLoad],
    *,
    pricing: FleetPricing = PRICING,
    catalog=None,
    seed: int = 0,
    prewarm: bool = True,
    warm_start: bool = True,
    needs_stats: bool = True,
    needs_uniforms: bool = False,
    uniforms: Optional[np.ndarray] = None,
    stats: Optional[tuple] = None,
    _sim: Optional[ServingSim] = None,
):
    """Materialize ``(statics, state0, xs)`` for one cell as NumPy host
    arrays (:func:`run_grid` stacks cells and moves them to the device).

    Every derived quantity is read off a throwaway :class:`ServingSim`,
    so the two engines share one construction path; ``_sim`` lets a grid
    reuse one template sim (every sim-derived quantity is independent of
    arrivals and seed except the warm-start fleet, recomputed here), and
    ``stats`` injects precomputed ``(ewma, p2m)`` monitor trajectories.
    Policies that read no order statistic run the EWMA inside the tick
    loop (``state0.ewma`` seeds it) and get no ``[T, A]`` EWMA input.
    A policy that draws actions (``needs_uniforms``) reads ``[T, A]``
    float64 ``uniforms``; without them they are drawn from ``seed``."""
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.ndim != 2:
        raise ValueError(f"the batched engine needs an [A, T] arrival matrix, "
                         f"got shape {arrivals.shape}")
    A, T = arrivals.shape
    sim = _sim if _sim is not None else ServingSim(
        arrivals, workload, pricing=pricing, prewarm=prewarm,
        warm_start=warm_start, seed=seed, catalog=catalog,
    )
    variants = sim._variants_live

    ewma = p2m = None
    if needs_stats:
        if stats is not None:
            ewma, p2m = stats
        else:
            ewma, _, p2m = pool_stats_trajectory(arrivals)

    cap = pricing.harvest_cap_per_arch
    lev = harvest_level_trajectory(seed, T)
    h_lev_obs = np.concatenate([[1.0], lev[:-1]])   # level BEFORE the advance
    statics = {
        "strict_frac": sim.strict_frac.astype(np.float64),
        "thr": sim.eff_throughput,
        "chips": sim.eff_chips,
        "cur_acc": sim.cur_acc,
        "acc_floor": sim.acc_floor.astype(np.float64),
        # lateness as prefix lengths: how many of the oldest buckets
        # violate each arch's slack
        "late_s": _n_late(sim.q_strict._late_mask),
        "late_r": _n_late(sim.q_relaxed._late_mask),
        "rlate_s": _n_late(sim._remote_late_strict),
        "rlate_r": _n_late(sim._remote_late_relaxed),
        # finalize prefixes: buffer age + 1 (the sweep runs at tick T)
        "fin_s": _n_late(_finalize_mask(sim.q_strict)),
        "fin_r": _n_late(_finalize_mask(sim.q_relaxed)),
        "lat_b1": sim.burst.lat_b1,
        "cold_start": sim.burst.cold_start_s,
        "burst_cpr": sim.burst.cost_per_request,
        "spinup": float(pricing.burst_spinup_s),
        "idle_timeout": float(pricing.burst_idle_timeout_s),
        "slo_strict": sim.q_strict.slo_s,
        "slo_relaxed": sim.q_relaxed.slo_s,
        "p_res": sim.reserved.price_per_chip_s(),
        "p_spot": sim.spot.price_per_chip_s(),
        "p_harv": sim.harvest.price_per_chip_s(),
        "p_rem": sim.remote.price_per_chip_s(),
        "p_reclaim": float(sim.spot.reclaim_probability()),
        "risk": np.full(A, sim.spot.reclaim_probability()),
        "zeros_i": np.zeros(A, dtype=np.int64),
        "ones_i": np.ones(A, dtype=np.int64),
        "false_b": np.zeros(A, dtype=bool),
        "ones_f": np.ones(A, dtype=np.float64),
        # the hold sentinel for variant requests / cooldown clocks
        "neg_i": np.full(A, -(10 ** 9), dtype=np.int64),
    }
    if variants:
        # the loop gathers effective quantities per tick, so the serving
        # statics revert to BASE values and the padded catalog rides in
        statics.update(
            thr=sim.throughput,
            chips=sim.chips,
            lat_b1=sim.lat_b1,
            var_acc=sim.var_acc,
            var_smult=sim.var_smult,
            var_cmult=sim.var_cmult,
            var_lmult=sim.var_lmult,
            var_n=sim.var_n,
            var_lo=sim.var_lo,
            var_cheapest=sim.var_cheapest,
            swap_lat=np.int64(sim.swap.lat),
            burst_chip_s=float(pricing.burst_chip_s),
            inv_fee=float(pricing.burst_invocation_fee),
        )
    if warm_start:
        # the sim's own warm-start rule, recomputed so a reused _sim
        # still yields THIS cell's t=0 fleet
        res_active0 = np.maximum(
            1, np.ceil(arrivals[:, 0] / sim.eff_throughput)
        ).astype(np.int64)
    else:
        res_active0 = sim.reserved.active.copy()

    def ring(tier):
        return np.zeros((A, tier.pipeline.lat), dtype=np.int32)

    zi32 = np.zeros(A, dtype=np.int32)
    zi64 = np.zeros(A, dtype=np.int64)
    state0 = SimState(
        qs_buf=np.zeros((A, sim.q_strict.window), dtype=np.float64),
        qr_buf=np.zeros((A, sim.q_relaxed.window), dtype=np.float64),
        res_active=res_active0, res_ring=ring(sim.reserved),
        res_cum=zi32, res_mat=zi32,
        spot_active=zi64, spot_ring=ring(sim.spot),
        spot_cum=zi32, spot_mat=zi32,
        harv_active=zi64, harv_ring=ring(sim.harvest),
        harv_cum=zi32, harv_mat=zi32,
        rem_active=zi64, rem_ring=ring(sim.remote),
        rem_cum=zi32, rem_mat=zi32,
        burst_last_used=sim.burst.last_used.copy(),
        last_util=np.zeros(A, dtype=np.float64),
        last_viol=np.zeros(A, dtype=np.float64),
        prev_rate=arrivals[:, 0].copy(),         # trend feature = 0 at t=0
        # the t=0 value is recomputed in the loop; this seeds the slot
        ewma=None if needs_stats else arrivals[:, 0].copy(),
        **(
            dict(
                var_cur=sim.swap.current.astype(np.int64),
                var_pending=np.full(A, -1, dtype=np.int64),
                var_ready=np.zeros(A, dtype=np.int64),
                var_last_move=np.full(A, -(10 ** 9), dtype=np.int64),
            )
            if variants else {}
        ),
    )
    xs = {
        "rate": np.ascontiguousarray(arrivals.T),
        "spot_u": spot_reclaim_uniforms(seed, T, A),
        "h_ceil": (lev * cap).astype(np.int64)[:, None],
        "h_lev_obs": h_lev_obs[:, None],
        "h_ceil_obs": (h_lev_obs * cap).astype(np.int64)[:, None],
    }
    if needs_stats:
        xs["ewma"] = ewma
        xs["p2m"] = p2m
    if needs_uniforms and uniforms is not None:
        xs["u_act"] = np.asarray(uniforms, dtype=np.float64)
        if xs["u_act"].shape != (T, A):
            raise ValueError(f"action uniforms of shape {xs['u_act'].shape}, "
                             f"need {(T, A)}")
    elif needs_uniforms:
        gen = torch.Generator().manual_seed(int(seed))
        xs["u_act"] = torch.rand((T, A), generator=gen, dtype=F64).numpy()
    return statics, state0, xs


def _late_index(n_late: np.ndarray, window: int, B: int, device):
    """``(idx [B, A, 1], has [A])`` for :func:`_late_mass`."""
    idx = np.clip(n_late - 1, 0, window - 1)
    idx = torch.as_tensor(idx, device=device)[None, :, None]
    return (idx.expand(B, len(n_late), 1).contiguous(),
            torch.as_tensor(n_late > 0, device=device))


def _statics_to_device(statics: dict, state0: SimState, B: int, device):
    """The per-run constants as tensors: arrays keep their dtype, Python
    and NumPy float scalars become 0-d float64 tensors (a Python float
    against an integer or boolean tensor would give float32)."""
    st = {}
    for k, v in statics.items():
        if k.startswith(("late_", "rlate_", "fin_")):
            continue
        if k == "p_reclaim":
            st[k] = float(v)                 # branches on the host
        elif isinstance(v, np.ndarray):
            st[k] = torch.tensor(v, device=device)
        elif isinstance(v, (int, np.integer)):
            st[k] = torch.tensor(int(v), dtype=I64, device=device)
        else:
            st[k] = torch.tensor(float(v), dtype=F64, device=device)
    ws, wr = state0.qs_buf.shape[-1], state0.qr_buf.shape[-1]
    for k, w in (("late_s", ws), ("rlate_s", ws), ("fin_s", ws),
                 ("late_r", wr), ("rlate_r", wr), ("fin_r", wr)):
        st[k] = _late_index(statics[k], w, B, device)
    st["decode_tables"] = decode_tables(device)
    return st


def _params_to_device(params_batch: List[dict], device) -> dict:
    """Stack per-cell policy parameters: a scalar becomes ``[B, 1]``
    (broadcasts over archs), a bias ``[O]`` becomes ``[B, 1, O]`` and a
    weight ``[I, O]`` stays ``[B, I, O]``.  Leaves are NumPy values or
    torch tensors (a live net is detached and cast where it lies, with no
    trip through the host); floats become float64."""
    first = params_batch[0]
    out = {}
    for k in first:
        if isinstance(first[k], dict):
            out[k] = _params_to_device([p[k] for p in params_batch], device)
            continue
        if isinstance(first[k], torch.Tensor):
            arr = torch.stack([p[k].detach() for p in params_batch])
        else:
            arr = torch.as_tensor(np.stack([np.asarray(p[k])
                                            for p in params_batch]))
        if arr.is_floating_point():
            arr = arr.to(F64)
        if arr.ndim <= 2:
            arr = arr[:, None] if arr.ndim == 1 else arr[:, None, :]
        out[k] = arr.to(device)
    return out


# ---------------------------------------------------------------------------
# The tick loop.
# ---------------------------------------------------------------------------
#: metric keys summed over ticks (the per-tick gauges, fleet sizes and
#: queue depths, appear only in the trajectory); the liveness flags fold
#: with "or"
_SUM_KEYS = (
    "served", "burst", "dropped", "viol", "viol_strict", "acc_w",
    "acc_viol", "cost_arch", "cost_res", "cost_spot", "cost_harv",
    "cost_rem", "cost_burst", "preempt", "chip", "need", "over", "swaps",
)
_LIVE_KEYS = ("harv_live", "rem_live")


class _SyncGuard:
    """``torch.cuda.set_sync_debug_mode("error")`` for the tick loop on
    a CUDA device (a host sync raises), restored on exit."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.on:
            self.prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(self.prev)


def run_ticks(policy_apply, statics: dict, state0: SimState, xs: dict, *,
              variants: bool, stack: bool = False, ticks=None):
    """Run the tick loop on device tensors.  Returns ``{"final",
    "expired_s", "expired_r", "totals"}`` and, with ``stack``, ``"ys"``:
    every per-tick output stacked ``[T, B, ...]``.  ``ticks`` limits the
    run to the first ticks (a profiling window)."""
    T = xs["rate"].shape[0] if ticks is None else ticks
    state, totals, series = state0, {}, []
    with _SyncGuard(xs["rate"].device), torch.inference_mode():
        for t in range(T):
            state, ys = _tick(state, t, {k: v[t] for k, v in xs.items()},
                              statics, policy_apply, variants)
            if stack:
                series.append(ys)
            for k in _SUM_KEYS + _LIVE_KEYS:
                if k not in ys:
                    continue
                if k not in totals:
                    totals[k] = ys[k].clone()
                elif k in _LIVE_KEYS:
                    totals[k] = totals[k] | ys[k]
                else:
                    totals[k] = totals[k] + ys[k]
    out = {
        "final": state,
        "expired_s": _late_mass(state.qs_buf, statics["fin_s"]),
        "expired_r": _late_mass(state.qr_buf, statics["fin_r"]),
        "totals": totals,
    }
    if stack:
        out["ys"] = {k: torch.stack([y[k] for y in series])
                     for k in series[0]}
    return out


def prepare_grid(arrivals_batch, workload, policy="portfolio",
                 params_batch=None, seeds=None, *, pricing=PRICING,
                 catalog=None, prewarm=True, warm_start=True,
                 uniforms=None, device="cuda", cells=None):
    """Build and move to ``device`` everything :func:`run_ticks` needs
    for a grid: ``(statics, state0, xs, variants)``, state ``[B, ...]``
    and per-tick inputs ``[T, B, ...]``.  ``uniforms`` (``[B, T, A]``
    float64) are the action draws of a sampling policy; without them
    each cell draws its own from its seed.  ``cells`` (a slice) builds
    only those cells, each exactly as the whole grid builds it."""
    arrivals_batch = np.asarray(arrivals_batch, dtype=np.float64)
    B, A, T = arrivals_batch.shape
    pol = TORCH_POLICIES[policy]
    seeds = list(seeds) if seeds is not None else [0] * B
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for {B} cells")
    if uniforms is not None and not pol.needs_uniforms:
        raise ValueError(f"policy {policy!r} draws no actions from uniforms")
    # one template sim serves the whole grid (cells share the workload);
    # the per-cell monitor streams run as ONE batched recurrence over
    # the stacked [B*A, T] matrix (rows are independent)
    sim = ServingSim(
        arrivals_batch[0], workload, pricing=pricing, prewarm=prewarm,
        warm_start=warm_start, seed=seeds[0], catalog=catalog,
    )
    variants = sim._variants_live
    rows = range(B)[cells or slice(None)]
    if pol.needs_stats:
        ew, _, p2 = pool_stats_trajectory(arrivals_batch[rows.start:rows.stop].reshape(-1, T))
        stats = [(ew[:, j * A:(j + 1) * A], p2[:, j * A:(j + 1) * A])
                 for j in range(len(rows))]
    else:
        stats = [None] * len(rows)
    cells = [
        build_sim_inputs(
            arrivals_batch[i], workload, pricing=pricing, seed=seeds[i],
            prewarm=prewarm, warm_start=warm_start,
            needs_stats=pol.needs_stats, needs_uniforms=pol.needs_uniforms,
            uniforms=None if uniforms is None else uniforms[i],
            stats=stats[j], _sim=sim,
        )
        for j, i in enumerate(rows)
    ]
    B = len(rows)
    state0 = SimState(*(
        None if leaves[0] is None
        else torch.as_tensor(np.stack(leaves), device=device)
        for leaves in zip(*(c[1] for c in cells))
    ))
    xs = {k: torch.as_tensor(np.stack([c[2][k] for c in cells], axis=1),
                             device=device)
          for k in cells[0][2]}
    statics = _statics_to_device(cells[0][0], cells[0][1], B, device)
    if params_batch is None:
        params_batch = [pol.default_params() for _ in range(B)]
    else:
        params_batch = list(params_batch)[rows.start:rows.stop]
    statics["policy"] = _params_to_device(params_batch, device)
    return statics, state0, xs, variants


# ---------------------------------------------------------------------------
# Result assembly (mirrors SimResult.summary / per_arch_counts).
# ---------------------------------------------------------------------------
def _assemble(out: dict, arrivals: np.ndarray) -> dict:
    """One cell's host outputs as ``summary`` (shaped as
    ``SimResult.summary()``), ``per_arch`` (as ``per_arch_counts()``),
    ``ledger`` (the unrounded totals under ``SimResult``'s field names,
    harvest and remote cost as ``cost_harvest`` / ``cost_remote``) and
    ``raw`` (the loop's own outputs)."""
    tot = out["totals"]
    exp_s, exp_r = out["expired_s"], out["expired_r"]
    expired = exp_s + exp_r
    served_vm = float(tot["served"].sum() + tot["dropped"].sum())
    served_burst = float(tot["burst"].sum())
    ledger = {
        "cost_reserved": float(tot["cost_res"]),
        "cost_spot": float(tot["cost_spot"]),
        "cost_burst": float(tot["cost_burst"]),
        "cost_harvest": float(tot["cost_harv"]),
        "cost_remote": float(tot["cost_rem"]),
        "violations": float(tot["viol"].sum() + expired.sum()),
        "violations_strict": float(tot["viol_strict"] + exp_s.sum()),
        "served_vm": served_vm,
        "served_burst": served_burst,
        "preemptions": float(tot["preempt"]),
        "chip_seconds": float(tot["chip"]),
        "chip_seconds_needed": float(tot["need"]),
        "chip_seconds_over": float(tot["over"]),
        "accuracy_weighted": float(tot["acc_w"].sum()),
        "accuracy_served": served_vm + served_burst,
        "acc_violations": float(tot["acc_viol"].sum()),
    }
    total_requests = float(arrivals.sum())
    answered = ledger["accuracy_served"]
    cost_res, cost_spot = ledger["cost_reserved"], ledger["cost_spot"]
    cost_burst = ledger["cost_burst"]
    cost_harv, cost_rem = ledger["cost_harvest"], ledger["cost_remote"]

    summary = {
        "cost_total": round(
            cost_res + cost_spot + cost_burst + cost_harv + cost_rem, 4
        ),
        "cost_reserved": round(cost_res, 4),
        "cost_spot": round(cost_spot, 4),
        "cost_burst": round(cost_burst, 4),
    }
    # tier keys appear iff the tier was ever live
    if bool(tot["harv_live"]):
        summary["cost_harvest"] = round(cost_harv, 4)
    if bool(tot["rem_live"]):
        summary["cost_remote"] = round(cost_rem, 4)
    summary.update({
        "preemptions": int(tot["preempt"]),
        "violation_rate": round(
            ledger["violations"] / max(total_requests, 1e-9), 5),
        "violations_strict": round(ledger["violations_strict"], 1),
        "served_vm": round(served_vm, 1),
        "served_burst": round(served_burst, 1),
        "overprovision_ratio": round(
            ledger["chip_seconds_over"]
            / max(ledger["chip_seconds_needed"], 1e-9), 4),
        "chip_seconds": round(ledger["chip_seconds"], 1),
    })
    if answered > 0:
        summary["mean_accuracy"] = round(
            ledger["accuracy_weighted"] / max(answered, 1e-9), 5)
        summary["acc_violation_rate"] = round(
            ledger["acc_violations"] / max(answered, 1e-9), 5
        )
        summary["variant_swaps"] = (
            int(tot["swaps"]) if "swaps" in tot else 0
        )

    final: SimState = out["final"]
    per_arch = {
        "arrived": arrivals.sum(axis=1),
        "served_vm": tot["served"],
        "served_burst": tot["burst"],
        "dropped": tot["dropped"],
        "expired_end": expired,
        "violations": tot["viol"] + expired,
        "queued": (final.qs_buf[:, -1] - exp_s) + (final.qr_buf[:, -1] - exp_r),
        "acc_weight": tot["acc_w"],
        "acc_violations": tot["acc_viol"],
    }
    return {"summary": summary, "per_arch": per_arch, "ledger": ledger,
            "raw": out}


def _to_host(out: dict) -> dict:
    """Every output tensor as a NumPy array (one copy each, after the
    loop)."""
    def host(x):
        return None if x is None else x.cpu().numpy()

    res = {
        "final": SimState(*(host(x) for x in out["final"])),
        "expired_s": host(out["expired_s"]),
        "expired_r": host(out["expired_r"]),
        "totals": {k: host(v) for k, v in out["totals"].items()},
    }
    if "ys" in out:
        res["ys"] = {k: host(v) for k, v in out["ys"].items()}
    return res


def _cell(out: dict, i: int) -> dict:
    """Cell ``i`` of a grid's host outputs."""
    cell = {
        "final": SimState(*(None if x is None else x[i]
                            for x in out["final"])),
        "expired_s": out["expired_s"][i],
        "expired_r": out["expired_r"][i],
        "totals": {k: v[i] for k, v in out["totals"].items()},
    }
    if "ys" in out:
        cell["ys"] = {k: v[:, i] for k, v in out["ys"].items()}
    return cell


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------
def run_grid(
    arrivals_batch: np.ndarray,              # [B, A, T]
    workload: List[ArchLoad],
    policy: str = "portfolio",
    params_batch: Optional[List[dict]] = None,
    seeds: Optional[List[int]] = None,
    *,
    pricing: FleetPricing = PRICING,
    catalog=None,
    prewarm: bool = True,
    warm_start: bool = True,
    record_trajectory: bool = False,
    device="cuda",
    sharded: Optional[bool] = None,
) -> List[dict]:
    """A whole (scenario x seed x policy-params) grid in one tick loop
    over a leading cell axis: cell ``i`` runs ``arrivals_batch[i]`` under
    ``params_batch[i]`` with spot/harvest realizations from
    ``seeds[i]``.  Returns one :func:`run_scenario`-shaped dict per
    cell.  Runs on the card unless ``device`` says otherwise.

    With a process group of n > 1 ranks up, the cells split across the
    ranks: rank r runs cells [r·B/n, (r+1)·B/n) on ``device`` (its own),
    and every rank returns all B cells (``all_gather_object``).
    ``sharded=None`` splits when n divides B, ``True`` requires it and
    raises otherwise, ``False`` runs every cell on every rank.  Cells never
    communicate, so the split and unsplit grids give the same cells."""
    arrivals_batch = np.asarray(arrivals_batch, dtype=np.float64)
    B = arrivals_batch.shape[0]
    mesh = device_mesh()
    if sharded is None:
        sharded = mesh is not None and B % mesh.size() == 0
    if sharded and mesh is None:
        raise ValueError("sharded run_grid needs a process group of more than one rank")
    n, r = (mesh.size(), mesh.get_local_rank()) if sharded else (1, 0)
    if B % n:
        raise ValueError(f"sharded run_grid needs a cell count ({B}) that the rank "
                         f"count ({n}) divides")
    rows = range(B)[r * B // n:(r + 1) * B // n]
    statics, state0, xs, variants = prepare_grid(
        arrivals_batch, workload, policy, params_batch, seeds,
        pricing=pricing, catalog=catalog, prewarm=prewarm,
        warm_start=warm_start, device=device,
        cells=slice(rows.start, rows.stop),
    )
    out = _to_host(run_ticks(TORCH_POLICIES[policy].apply, statics, state0,
                             xs, variants=variants, stack=record_trajectory))
    results = []
    for j, i in enumerate(rows):
        cell = _cell(out, j)
        trajectory = cell.pop("ys", None)
        result = _assemble(cell, arrivals_batch[i])
        if trajectory is not None:
            result["trajectory"] = trajectory
        results.append(result)
    if sharded:
        parts = [None] * n
        dist.all_gather_object(parts, results, group=mesh.get_group())
        results = [cell for part in parts for cell in part]
    return results


def run_scenario(
    arrivals: np.ndarray,
    workload: List[ArchLoad],
    policy: str = "portfolio",
    params: Optional[dict] = None,
    *,
    pricing: FleetPricing = PRICING,
    catalog=None,
    seed: int = 0,
    prewarm: bool = True,
    warm_start: bool = True,
    record_trajectory: bool = False,
    device="cuda",
) -> dict:
    """One scenario: :func:`run_grid` with one cell.  Returns
    ``{"summary", "per_arch", "ledger", "raw"}`` with the summary shaped
    exactly like ``SimResult.summary()`` from the NumPy engine and the
    unrounded ledger under ``SimResult``'s field names.

    ``catalog`` switches on the model-variant axis.
    ``record_trajectory=True`` adds a ``"trajectory"`` entry: the
    per-tick ``[T, ...]`` series of every output (flows, per-tier cost
    and fleet gauges, queue totals and, on catalog runs, the variant
    gauges ``active_variant`` / ``swap_in_flight`` / ``acc_rate``)."""
    return run_grid(
        np.asarray(arrivals, dtype=np.float64)[None], workload, policy,
        None if params is None else [params], [seed], pricing=pricing,
        catalog=catalog, prewarm=prewarm, warm_start=warm_start,
        record_trajectory=record_trajectory, device=device,
    )[0]
