"""Observation features and the factored action space of the pool
controller (paper §V, Figure 10).

One place defines how a :class:`~repro_torch.core.sim.types.PoolObs` becomes
the ``[A, OBS_DIM]`` feature matrix and how a per-arch discrete action
decodes into a procurement decision, so the training environment
(:mod:`repro_torch.core.rl.env`) and the deployable scheduler
(:mod:`repro_torch.core.rl.policy`) can never drift apart.

The action space is *factored per arch*: each row of the pool picks one
of ``N_ACTIONS = len(HEADROOMS) x len(OFFLOADS) x len(VARIANT_MOVES) x
len(SPOT_MOVES)`` joint (headroom, offload-mode, variant-move,
spot-move) decisions, and the policy torso is applied row-wise — a
single parameter set controls a pool of any size A, which is what lets
one trained controller generalize across pool compositions.  The
variant head is the model-heterogeneity half of the paper's joint
decision space: ``down`` / ``hold`` / ``up`` steps along the arch's
accuracy-ordered variant set.  The spot head is the
resource-heterogeneity half (§VI): ``grow`` / ``hold`` / ``shrink``
steps the arch's preemptible spot fleet, whose capacity then *offsets*
the reserved sizing rule — the controller can shift base load onto
discounted slices instead of only resizing the on-demand fleet.  Both
heads are hold-first, so the ``N_PROCURE`` legacy actions ``0 .. 11``
(and the pre-spot actions ``0 .. 35``) decode exactly as the earlier
spaces did.

Everything here defaults to NumPy (the scheduler registered in
``VECTOR_SCHEDULERS`` runs inside the engine's hot tick loop and must
not pay a torch dispatch per field), but the feature build and the
action decode also come in ``*_torch`` forms, the same expressions on torch
tensors (which have no ``astype``), which the batched engine
(``sim/torch_engine.py``) runs on ``[B, A]`` tensors.
``tests/test_torch_sim_engine.py`` holds each torch form to its NumPy
form.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sim import PoolAction, PoolObs

#: reserved-fleet headroom over smoothed demand (bounded action -> stable
#: credit assignment despite the provisioning lag)
HEADROOMS = (0.85, 1.0, 1.15, 1.4)
#: offload modes, index-aligned with ``repro_torch.core.sim.OFFLOAD_MODES``
OFFLOADS = ("none", "blind", "slack_aware")
#: the variant head: hold-first so actions < N_PROCURE are the legacy space
VARIANT_MOVES = ("hold", "down", "up")
#: the spot head: hold-first so actions < N_PROCURE * len(VARIANT_MOVES)
#: are the pre-spot space (hold keeps the current spot fleet, which is 0
#: until the controller ever grows it — identical to the legacy decode)
SPOT_MOVES = ("hold", "grow", "shrink")
N_PROCURE = len(HEADROOMS) * len(OFFLOADS)
N_VARIANT_SPACE = N_PROCURE * len(VARIANT_MOVES)
N_ACTIONS = N_VARIANT_SPACE * len(SPOT_MOVES)
OBS_DIM = 16

#: queued backlog is assumed drainable over this horizon when sizing the
#: reserved fleet (same knob the Paragon scheduler uses)
BACKLOG_DRAIN_S = 5.0
#: feature scaling for the (tiny) per-tick spot reclaim probability
RISK_SCALE = 600.0

_HEADROOM_ARR = np.asarray(HEADROOMS, dtype=np.float64)
#: VARIANT_MOVES index -> signed step along the variant set
_VMOVE_DELTA = np.array([0, -1, 1], dtype=np.int64)
#: SPOT_MOVES index -> signed per-tick step of the spot fleet
_SMOVE_DELTA = np.array([0, 1, -1], dtype=np.int64)


def pool_features(obs: PoolObs, prev_rate: np.ndarray, *,
                  rate_scale: float, fleet_scale: float) -> np.ndarray:
    """``[A, OBS_DIM]`` float32 feature matrix for one tick.

    Row ``a`` holds arch ``a``'s normalized load / fleet / feedback
    state plus the variant axis (the active variant's position in the
    arch's ordered set, the accuracy headroom over the stream's floor)
    and the spot-tier state the spot head steers by (held / in-flight
    spot instances, reclaim risk, harvest availability).  ``prev_rate``
    is the caller-held previous-tick rate used for the trend feature.
    """
    rs, fs = rate_scale, fleet_scale
    f = np.empty((len(obs.keys), OBS_DIM), dtype=np.float32)
    f[:, 0] = obs.rate / rs
    f[:, 1] = obs.ewma_rate / rs
    f[:, 2] = np.minimum(obs.peak_to_median, 5.0) / 5.0
    f[:, 3] = obs.queue_strict / rs
    f[:, 4] = obs.queue_relaxed / rs
    f[:, 5] = obs.n_active / fs
    f[:, 6] = obs.n_pending / fs
    f[:, 7] = np.minimum(obs.utilization, 2.0) / 2.0
    f[:, 8] = (obs.rate - prev_rate) / rs
    f[:, 9] = obs.last_violations / rs
    f[:, 10] = obs.active_variant / np.maximum(obs.n_variants - 1, 1)
    f[:, 11] = np.clip(obs.accuracy - obs.accuracy_floor, 0.0, 1.0)
    f[:, 12] = obs.n_spot / fs
    f[:, 13] = obs.n_spot_pending / fs
    f[:, 14] = np.minimum(obs.spot_reclaim_risk * RISK_SCALE, 1.0)
    f[:, 15] = obs.harvest_level
    return f


def pool_features_torch(o, prev_rate, *, rate_scale, fleet_scale):
    """:func:`pool_features` on a dict of torch tensors of any leading
    shape (``o`` maps :class:`PoolObs` field names to ``[..., A]``
    tensors; ``[..., A, OBS_DIM]`` float32 out, columns and scaling as
    :func:`pool_features`).  The
    scales may be Python floats or tensors that broadcast against the
    fields (per-cell ``[B, 1]`` in the batched engine)."""
    rs, fs = rate_scale, fleet_scale

    def f(k):
        # NumPy divides integer fields in float64; torch would give float32
        return o[k].to(torch.float64)

    cols = [
        f("rate") / rs,
        f("ewma_rate") / rs,
        torch.clamp(f("peak_to_median"), max=5.0) / 5.0,
        f("queue_strict") / rs,
        f("queue_relaxed") / rs,
        f("n_active") / fs,
        f("n_pending") / fs,
        torch.clamp(f("utilization"), max=2.0) / 2.0,
        (f("rate") - prev_rate) / rs,
        f("last_violations") / rs,
        f("active_variant") / torch.clamp(f("n_variants") - 1, min=1),
        torch.clamp(f("accuracy") - f("accuracy_floor"), 0.0, 1.0),
        f("n_spot") / fs,
        f("n_spot_pending") / fs,
        torch.clamp(f("spot_reclaim_risk") * RISK_SCALE, max=1.0),
        f("harvest_level"),
    ]
    shape = torch.broadcast_shapes(*(c.shape for c in cols))
    return torch.stack([c.expand(shape) for c in cols], dim=-1).to(
        torch.float32)


def decode_actions_arrays(actions) -> tuple:
    """Core of :func:`decode_actions` (``actions`` already an int64
    array)."""
    smove = _SMOVE_DELTA[actions // N_VARIANT_SPACE]
    rest = actions % N_VARIANT_SPACE
    proc = rest % N_PROCURE
    vmove = _VMOVE_DELTA[rest // N_PROCURE]
    headroom = _HEADROOM_ARR[proc // len(OFFLOADS)]
    return headroom, proc % len(OFFLOADS), vmove, smove


def decode_actions_torch(actions, tables) -> tuple:
    """:func:`decode_actions_arrays` on an int64 tensor; ``tables`` are
    :func:`decode_tables` on the actions' device."""
    smove_t, vmove_t, headroom_t = tables
    smove = smove_t[actions // N_VARIANT_SPACE]
    rest = actions % N_VARIANT_SPACE
    proc = rest % N_PROCURE
    vmove = vmove_t[rest // N_PROCURE]
    headroom = headroom_t[proc // len(OFFLOADS)]
    return headroom, proc % len(OFFLOADS), vmove, smove


def decode_tables(device) -> tuple:
    """The decode's lookup tables as tensors on ``device`` (made once,
    outside any tick loop)."""
    return (torch.as_tensor(_SMOVE_DELTA, device=device),
            torch.as_tensor(_VMOVE_DELTA, device=device),
            torch.as_tensor(_HEADROOM_ARR, device=device))


def decode_actions(actions: np.ndarray) -> tuple:
    """Split per-arch discrete actions into ``(headroom[A], offload[A],
    vmove[A], smove[A])``.

    ``offload`` comes back as the engine's integer codes (``OFFLOADS``
    is index-aligned with ``OFFLOAD_MODES``); ``vmove`` is the signed
    variant step and ``smove`` the signed spot-fleet step, both in
    ``{-1, 0, +1}``.
    """
    return decode_actions_arrays(np.asarray(actions, dtype=np.int64))


def variant_targets_arrays(active_variant, n_variants, vmove):
    """Core of :func:`variant_targets`: signed steps
    clipped to the arch's variant range, hold (-1) where the step lands
    on the active variant — the expression the in-scan RL decode
    (``sim/torch_engine.py``) traces so the variant head acts identically
    in rollout collection and deployment."""
    tgt = np.clip(active_variant + vmove, 0, n_variants - 1)
    return np.where(tgt == active_variant, -1, tgt).astype(np.int64)


def variant_targets_torch(active_variant, n_variants, vmove):
    """:func:`variant_targets_arrays` on int64 tensors."""
    tgt = torch.minimum(torch.clamp(active_variant + vmove, min=0),
                        n_variants - 1)
    return torch.where(tgt == active_variant, -1, tgt).to(torch.int64)


def variant_targets(obs: PoolObs, vmove: np.ndarray) -> np.ndarray:
    """Signed variant steps -> engine ``variant_target`` codes.

    Steps are clipped to the arch's variant range; a step that lands on
    the active variant (hold, or a clipped edge move) becomes the
    engine's hold code (-1).
    """
    return variant_targets_arrays(obs.active_variant, obs.n_variants, vmove)


def spot_targets(obs: PoolObs, smove: np.ndarray) -> np.ndarray:
    """Signed spot steps -> engine ``spot_target`` instance counts.

    ``hold`` MAINTAINS the observed in-flight spot fleet (active +
    provisioning): instances reclaimed since the observation are
    re-launched toward the same size, so hold means "auto-heal at this
    level" and ``shrink`` is the only way the fleet decays — while a
    fleet that was never grown stays at 0, which is what keeps the
    legacy (pre-spot) action decode unchanged.  ``grow`` / ``shrink``
    step the level by one instance per tick (60 instances/min against a
    120 s provisioning pipeline), clipped at 0.
    """
    keep = obs.n_spot + obs.n_spot_pending
    return np.maximum(keep + smove, 0).astype(np.int64)


def procurement_targets_arrays(actions, *, ewma_rate, queue_strict,
                               queue_relaxed, throughput, n_spot,
                               n_spot_pending) -> tuple:
    """Procurement decode: factored actions -> the
    ``(target, offload, spot, vmove)`` arrays behind
    :func:`procurement_action` (the variant step comes back raw — variant
    clipping needs the catalog fields the caller holds)."""
    headroom, offload, vmove, smove = decode_actions_arrays(actions)
    spot = np.maximum(n_spot + n_spot_pending + smove, 0).astype(np.int64)
    backlog = queue_strict + queue_relaxed
    demand = ewma_rate + backlog / BACKLOG_DRAIN_S
    residual = headroom * demand - spot * throughput
    target = np.maximum(1, np.ceil(residual / throughput)).astype(np.int64)
    return target, offload, spot, vmove


def procurement_targets_torch(actions, tables, *, ewma_rate, queue_strict,
                              queue_relaxed, throughput, n_spot,
                              n_spot_pending) -> tuple:
    """:func:`procurement_targets_arrays` on torch tensors."""
    headroom, offload, vmove, smove = decode_actions_torch(actions, tables)
    spot = torch.clamp(n_spot + n_spot_pending + smove, min=0).to(torch.int64)
    backlog = queue_strict + queue_relaxed
    demand = ewma_rate + backlog / BACKLOG_DRAIN_S
    residual = headroom * demand - spot * throughput
    target = torch.clamp(torch.ceil(residual / throughput), min=1).to(
        torch.int64)
    return target, offload, spot, vmove


def procurement_action(obs: PoolObs, actions: np.ndarray) -> PoolAction:
    """Decode factored actions into the engine's :class:`PoolAction`.

    The reserved target is ``ceil(headroom x demand / throughput)`` with
    demand = smoothed rate + queued backlog drained over
    ``BACKLOG_DRAIN_S`` — the same sizing rule the legacy single-arch
    env applied per arch — *minus the capacity of the targeted spot
    fleet*: spot instances substitute for reserved ones rather than
    stack on top, which is what makes the spot head a cost lever (at
    zero spot the rule is exactly the legacy one).  ``throughput`` is
    the ACTIVE variant's, so fleet sizing and variant choice stay
    coupled.
    """
    target, offload, spot, vmove = procurement_targets_arrays(
        np.asarray(actions, dtype=np.int64),
        ewma_rate=obs.ewma_rate, queue_strict=obs.queue_strict,
        queue_relaxed=obs.queue_relaxed, throughput=obs.throughput,
        n_spot=obs.n_spot, n_spot_pending=obs.n_spot_pending,
    )
    return PoolAction(target=target, offload=offload,
                      spot_target=spot,
                      variant_target=variant_targets(obs, vmove))
