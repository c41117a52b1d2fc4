"""The port's batched torch tick engine against the NumPy engine.

``repro_torch.core.sim.torch_engine`` is the twin of the reference's
``core/sim/jax_engine.py``.  The reference twin does not import under
this JAX, so the oracle is the one it was itself held to: the NumPy
``ServingSim`` (here the reference package's), driven by the vector
schedulers.  The contract is the reference's (``tests/test_jax_engine.py``):
raw (unrounded) ledger totals at 1e-6 relative, per-arch flows at 1e-6
and equal summary key sets.  Everything runs on the CPU in float64.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.rl.obs import (
    decode_actions_arrays,
    pool_features,
    pool_features_arrays,
    procurement_action,
    procurement_targets_arrays,
    variant_targets_arrays,
)
from repro.core.rl.policy import RLPoolPolicy, policy_logits
from repro.core.schedulers import (
    VECTOR_SCHEDULERS,
    accuracy_floor_move_arrays,
    infaas_variant_move_arrays,
    swap_aware_target_arrays,
)
from repro.core.sim import PoolAction, ServingSim, VariantCatalog
from repro.core.sim import uniform_pool_workload
from repro.core.sim.fleet import BINOMIAL_KMAX, binomial_from_uniform
from repro.core.sim.types import ArchLoad
from repro.core.workloads import SCENARIO_ZOO
from repro_torch.core import sim as tsim
from repro_torch.core.rl import obs as tobs
from repro_torch.core.rl import policy as tpolicy
from repro_torch.core import schedulers as tsched
from repro_torch.core.sim import torch_engine as te

ARCHS = ["llama3-8b", "minicpm-2b", "qwen1.5-0.5b"]
ZOO = sorted(SCENARIO_ZOO)
DEV = "cpu"

_LEDGER_KEYS = (
    "cost_reserved", "cost_spot", "cost_burst", "cost_harvest",
    "cost_remote", "violations", "violations_strict", "served_vm",
    "served_burst", "preemptions", "chip_seconds", "chip_seconds_needed",
    "chip_seconds_over", "accuracy_weighted", "accuracy_served",
    "acc_violations",
)


def _workload(A):
    return [ArchLoad(ARCHS[i % len(ARCHS)], 1.0 / A, 0.25, name=f"m@{i}")
            for i in range(A)]


def _vworkload(pool_workload=uniform_pool_workload, floor=0.55):
    pool = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b"]
    return [dataclasses.replace(w, min_accuracy=floor)
            for w in pool_workload(pool, strict_frac=0.25)]


def _port_workload(wl):
    """The port's own ArchLoad objects for a reference workload."""
    return [tsim.ArchLoad(**dataclasses.asdict(w)) for w in wl]


@pytest.fixture(scope="module")
def vcat():
    """(reference catalog, port catalog) for the variant workload."""
    return (VariantCatalog.for_workload(_vworkload()),
            tsim.VariantCatalog.for_workload(
                _vworkload(tsim.uniform_pool_workload)))


def _numpy_run(arrivals, workload, policy, seed=0, catalog=None):
    sim = ServingSim(arrivals, workload, seed=seed, catalog=catalog)
    pol = (RLPoolPolicy(greedy=True) if policy == "rl_pool"
           else VECTOR_SCHEDULERS[policy]())
    while not sim.done:
        sim.apply_pool(pol(sim.tick, sim.observe_pool()))
    return sim


def _raw_ledger_np(res):
    return {
        "cost_reserved": res.cost_reserved,
        "cost_spot": res.cost_spot,
        "cost_burst": res.cost_burst,
        "cost_harvest": res.cost_other.get("harvest", 0.0),
        "cost_remote": res.cost_other.get("remote", 0.0),
        "violations": res.violations,
        "violations_strict": res.violations_strict,
        "served_vm": res.served_vm,
        "served_burst": res.served_burst,
        "preemptions": float(res.preemptions),
        "chip_seconds": res.chip_seconds,
        "chip_seconds_needed": res.chip_seconds_needed,
        "chip_seconds_over": res.chip_seconds_over,
        "accuracy_weighted": res.accuracy_weighted,
        "accuracy_served": res.accuracy_served,
        "acc_violations": res.acc_violations,
    }


def _assert_ledger(sim, out, what):
    raw_np, raw_t = _raw_ledger_np(sim.res), out["ledger"]
    for k in _LEDGER_KEYS:
        assert raw_t[k] == pytest.approx(raw_np[k], rel=1e-6, abs=1e-6), (
            f"{what}: raw ledger key {k!r} drifted "
            f"(np={raw_np[k]!r} torch={raw_t[k]!r})"
        )
    assert set(out["summary"]) == set(sim.res.summary()), what
    if "variant_swaps" in out["summary"]:
        assert out["summary"]["variant_swaps"] == (
            sim.res.summary()["variant_swaps"]), what


def _assert_equivalent(arrivals, workload, policy, seed=0, catalog=None):
    cat_ref, cat_port = catalog if catalog is not None else (None, None)
    sim = _numpy_run(arrivals, workload, policy, seed=seed, catalog=cat_ref)
    out = te.run_scenario(arrivals, _port_workload(workload), policy,
                          seed=seed, catalog=cat_port, device=DEV)
    _assert_ledger(sim, out, policy)
    counts = sim.per_arch_counts()
    per = out["per_arch"]
    for k in ("served_vm", "served_burst", "dropped", "violations",
              "acc_weight", "acc_violations"):
        np.testing.assert_allclose(per[k], counts[k], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{policy}: per-arch {k}")
    return out


# ---------------------------------------------------------------------------
# The zoo x policies x seeds, without and with a variant catalog.
# ---------------------------------------------------------------------------
POLICIES = ["reactive", "paragon", "portfolio", "rl_pool", "infaas_variant",
            "accuracy_floor"]


@pytest.mark.parametrize("scenario", ZOO)
@pytest.mark.parametrize("policy", POLICIES)
def test_zoo_policy_matches_numpy_engine(scenario, policy):
    A, T = 4, 240
    i = ZOO.index(scenario)
    for seed in (i, 50 + i):
        arr = SCENARIO_ZOO[scenario].build(A, duration_s=T, seed=20 + seed)
        _assert_equivalent(arr, _workload(A), policy, seed=seed)


@pytest.mark.parametrize("scenario", ZOO)
@pytest.mark.parametrize("policy", ["infaas_variant", "accuracy_floor",
                                    "rl_pool"])
def test_zoo_variant_catalog_matches_numpy_engine(scenario, policy, vcat):
    wl = _vworkload()
    i = ZOO.index(scenario)
    arr = SCENARIO_ZOO[scenario].build(len(wl), duration_s=300,
                                       mean_rps=300.0, seed=40 + i)
    _assert_equivalent(arr, wl, policy, seed=i, catalog=vcat)


def test_variant_catalog_runs_swap(vcat):
    wl = _vworkload()
    arr = SCENARIO_ZOO["diurnal_phases"].build(len(wl), duration_s=400,
                                               mean_rps=400.0, seed=3)
    for policy in ("infaas_variant", "accuracy_floor"):
        out = _assert_equivalent(arr, wl, policy, seed=0, catalog=vcat)
        assert out["summary"]["variant_swaps"] > 0, policy


def test_fleet_scale_a256():
    A, T = 256, 120
    arr = SCENARIO_ZOO["shared_berkeley"].build(A, duration_s=T,
                                                mean_rps=400.0, seed=9)
    _assert_equivalent(arr, _workload(A), "portfolio", seed=9)


def test_variant_policies_degrade_catalog_free():
    A = 4
    wl = _port_workload(_workload(A))
    arr = SCENARIO_ZOO["mmpp_bursts"].build(A, duration_s=300, seed=2)
    p = te.run_scenario(arr, wl, "paragon", seed=0, device=DEV)["summary"]
    for policy in ("infaas_variant", "accuracy_floor"):
        assert te.run_scenario(arr, wl, policy, seed=0,
                               device=DEV)["summary"] == p


# ---------------------------------------------------------------------------
# Per-arch flow conservation.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("catalog", [False, True])
def test_flow_conservation_per_arch(catalog, vcat):
    if catalog:
        wl = _port_workload(_vworkload())
        arr = SCENARIO_ZOO["flash_anti"].build(len(wl), duration_s=500,
                                               mean_rps=350.0, seed=5)
        out = te.run_scenario(arr, wl, "infaas_variant", catalog=vcat[1],
                              device=DEV)
    else:
        A = 6
        arr = SCENARIO_ZOO["flash_anti"].build(A, duration_s=600)
        out = te.run_scenario(arr, _port_workload(_workload(A)), "portfolio",
                              device=DEV)
    per = out["per_arch"]
    answered = per["served_vm"] + per["served_burst"] + per["dropped"]
    np.testing.assert_allclose(
        per["arrived"], answered + per["expired_end"] + per["queued"],
        rtol=1e-9, atol=1e-6,
    )
    assert (per["acc_weight"] >= -1e-9).all()
    assert (per["acc_weight"] <= answered + 1e-6).all()
    assert (per["acc_violations"] <= answered + 1e-6).all()


# ---------------------------------------------------------------------------
# Scripted swap edge cases (tests/test_jax_engine.py:381-470).
# ---------------------------------------------------------------------------
def _scripted_pair(script, spot=0, harvest=0):
    """Matching (NumPy policy, torch apply) for a reactive-sized fleet
    with a tick-scripted variant request stream."""

    def np_policy(tick, obs):
        tgt = np.maximum(1, np.ceil(obs.ewma_rate / obs.throughput)).astype(
            np.int64)
        A = len(obs.keys)
        act = PoolAction(target=tgt)
        act.variant_target = script(tick, A)
        if spot:
            act.spot_target = np.full(A, spot, dtype=np.int64)
        if harvest:
            act.harvest_target = np.full(A, harvest, dtype=np.int64)
        return act

    def torch_apply(params, obs, xs):
        tgt = torch.clamp(torch.ceil(obs["ewma_rate"] / obs["throughput"]),
                          min=1).to(torch.int64)
        z = torch.zeros_like(tgt)
        B, A = tgt.shape
        variant = torch.as_tensor(script(obs["tick"], A)).expand(B, A)
        return dict(target=tgt, offload=z,
                    spot=torch.full_like(tgt, spot) if spot else z,
                    harvest=torch.full_like(tgt, harvest) if harvest else z,
                    remote=z, variant=variant), {}

    return np_policy, torch_apply


def _scripted_parity(arr, wl, vcat, np_policy, torch_apply, seed=0):
    sim = ServingSim(arr, wl, seed=seed, catalog=vcat[0])
    while not sim.done:
        sim.apply_pool(np_policy(sim.tick, sim.observe_pool()))
    statics, state0, xs, variants = te.prepare_grid(
        arr[None], _port_workload(wl), "paragon", seeds=[seed],
        catalog=vcat[1], device=DEV,
    )
    assert variants
    out = te._cell(te._to_host(te.run_ticks(
        torch_apply, statics, state0, xs, variants=True)), 0)
    res = te._assemble(out, np.asarray(arr, dtype=np.float64))
    _assert_ledger(sim, res, "scripted")
    return sim, res


def test_swap_retarget_to_current_cancels(vcat):
    wl = _vworkload()
    arr = SCENARIO_ZOO["shared_berkeley"].build(len(wl), duration_s=300,
                                                mean_rps=200.0, seed=7)
    base = vcat[0].as_arrays(wl)["base_idx"].astype(np.int64)

    def script(t, A):
        # t=5: request variant 0; t=10 (inside the 60 s swap latency):
        # re-target the current variant -> cancel; t=100: request 0
        # again -> completes at tick 160
        zero = np.zeros(A, dtype=np.int64)
        if t == 10:
            return base.copy()
        return zero if t in (5, 100) else zero - 1

    sim, res = _scripted_parity(arr, wl, vcat, *_scripted_pair(script))
    assert res["summary"]["variant_swaps"] == int((base != 0).sum())
    assert not sim.swap.in_flight.any()


def test_swap_lands_on_final_tick(vcat):
    wl = _vworkload()
    T = 200
    arr = SCENARIO_ZOO["flash_correlated"].build(len(wl), duration_s=T,
                                                 mean_rps=250.0, seed=13)
    va = vcat[0].as_arrays(wl)
    base = va["base_idx"].astype(np.int64)
    top = (va["n_variants"] - 1).astype(np.int64)
    land = T - 1 - 60    # ready_at == T-1: pops on the final tick

    def script(t, A):
        zero = np.zeros(A, dtype=np.int64)
        if t == land:
            return zero
        return top.copy() if t == T - 1 else zero - 1

    sim, res = _scripted_parity(arr, wl, vcat, *_scripted_pair(script))
    assert res["summary"]["variant_swaps"] == int((base != 0).sum())
    assert sim.swap.in_flight.any()


def test_swap_request_on_reclaim_tick(vcat):
    wl = _vworkload()
    arr = SCENARIO_ZOO["mmpp_bursts"].build(len(wl), duration_s=400,
                                            mean_rps=300.0, seed=17)

    def script(t, A):
        return np.full(A, 0 if (t % 7) < 3 else -1, dtype=np.int64)

    sim, res = _scripted_parity(
        arr, wl, vcat, *_scripted_pair(script, spot=3, harvest=2))
    assert sim.res.preemptions > 0, "no reclaim landed — edge not exercised"
    assert res["summary"]["variant_swaps"] > 0


# ---------------------------------------------------------------------------
# The grid and the trajectory.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["portfolio", "rl_pool"])
def test_grid_cell_matches_run_scenario(policy):
    A, T = 4, 200
    wl = _port_workload(_workload(A))
    names = ("shared_berkeley", "mmpp_bursts", "flash_correlated")
    arrs = np.stack([SCENARIO_ZOO[n].build(A, duration_s=T, seed=30 + i)
                     for i, n in enumerate(names)])
    seeds = [5, 6, 7]
    cells = te.run_grid(arrs, wl, policy, seeds=seeds, device=DEV)
    for i in range(len(names)):
        single = te.run_scenario(arrs[i], wl, policy, seed=seeds[i],
                                 device=DEV)
        assert cells[i]["summary"] == single["summary"], f"cell {i}"
        for k, v in single["raw"]["totals"].items():
            np.testing.assert_array_equal(cells[i]["raw"]["totals"][k], v,
                                          err_msg=f"cell {i} {k}")


def test_grid_per_cell_params():
    """Per-cell policy parameters are [B, 1] tensors: a grid over two
    parameter sets equals two single runs."""
    A, T = 4, 200
    wl = _port_workload(_workload(A))
    arr = SCENARIO_ZOO["diurnal_phases"].build(A, duration_s=T, seed=4)
    base = te.TORCH_POLICIES["portfolio"].default_params()
    other = dict(base, strict_share=1.0, drain_horizon_s=0.1)
    cells = te.run_grid(np.stack([arr, arr]), wl, "portfolio",
                        params_batch=[base, other], seeds=[1, 1], device=DEV)
    for cell, params in zip(cells, (base, other)):
        assert cell["summary"] == te.run_scenario(
            arr, wl, "portfolio", params, seed=1, device=DEV)["summary"]
    assert cells[0]["summary"] != cells[1]["summary"]


def test_trajectory_matches_sum_mode():
    wl = _port_workload(uniform_pool_workload(
        ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b"],
        strict_frac=0.25))
    arr = SCENARIO_ZOO["mmpp_bursts"].build(4, duration_s=200, mean_rps=120.0)
    base = te.run_scenario(arr, wl, "portfolio", device=DEV)
    traj = te.run_scenario(arr, wl, "portfolio", record_trajectory=True,
                           device=DEV)
    assert set(base["summary"]) == set(traj["summary"])
    for k, v in base["summary"].items():
        np.testing.assert_allclose(traj["summary"][k], v, rtol=1e-6,
                                   err_msg=k)
    series = traj["trajectory"]
    for k in ("served", "viol", "cost_arch", "n_res", "queue_strict",
              "queue_relaxed"):
        assert series[k].shape[0] == 200, k
    assert np.asarray(series["n_res"]).sum() > 0
    for k in ("served", "burst", "dropped", "viol", "cost_arch"):
        np.testing.assert_allclose(series[k].sum(axis=0),
                                   base["raw"]["totals"][k], rtol=1e-12,
                                   err_msg=k)


def test_trajectory_variant_gauges(vcat):
    wl = _vworkload()
    arr = SCENARIO_ZOO["trending_hotswap"].build(4, duration_s=300,
                                                 mean_rps=300.0)
    pw = _port_workload(wl)
    base = te.run_scenario(arr, pw, "infaas_variant", catalog=vcat[1],
                           device=DEV)
    traj = te.run_scenario(arr, pw, "infaas_variant", catalog=vcat[1],
                           record_trajectory=True, device=DEV)
    assert set(base["summary"]) == set(traj["summary"])
    for k, v in base["summary"].items():
        np.testing.assert_allclose(traj["summary"][k], v, rtol=1e-6,
                                   err_msg=k)
    series = traj["trajectory"]
    for k in ("active_variant", "swap_in_flight", "acc_rate"):
        assert np.asarray(series[k]).shape == (300, 4), k
    assert int(np.asarray(series["swaps"]).sum()) == base["summary"][
        "variant_swaps"]
    assert base["summary"]["variant_swaps"] > 0
    # while a swap is in flight the delivered accuracy is the OLD variant's
    acc = np.asarray(series["acc_rate"])
    active = np.asarray(series["active_variant"])
    changed = np.diff(active, axis=0) != 0
    assert (np.diff(acc, axis=0)[~changed] == 0).all()


# ---------------------------------------------------------------------------
# The building blocks.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [0.0, 1e-4, 1.0 - np.exp(-1.0 / 1800), 0.01,
                               0.05, 0.3, 1.0])
def test_binomial_torch_matches_numpy(p):
    rng = np.random.default_rng(0)
    n = rng.integers(0, BINOMIAL_KMAX + 10, size=400)
    n[:8] = [0, 1, 2, 3, 500, 5000, 64, 65]
    u = rng.random(400)
    u[:4] = [0.0, 0.999999, 0.5, 1e-300]
    want = binomial_from_uniform(n, p, u)
    for dtype in (torch.int64, torch.int32):
        got = te.binomial_from_uniform_torch(
            torch.as_tensor(n, dtype=dtype), float(p), torch.as_tensor(u))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"p={p}")


@pytest.mark.parametrize("lat", [1, 7, 60])
def test_begin_tick_cancel_follows_the_numpy_pipeline(lat):
    """A reclaim or an eviction cancels in-flight launches at the start of
    a tick, before the pop: the NumPy ``ProvisionPipeline.cancel_newest``
    then takes the cohort maturing this tick first (its buffer column is
    the newest launch tick's), the others newest-first.  The ring form
    follows it launch for launch, and a plain clip from the top (the
    reference twin's ``_pipe_cancel``) would not."""
    from repro.core.sim.fleet import ProvisionPipeline

    rng = np.random.default_rng(lat)
    A, T = 6, 5 * lat + 20
    pipe = ProvisionPipeline(A, lat)
    p = te._Pipe(torch.zeros((1, A, lat), dtype=torch.int32),
                 torch.zeros((1, A), dtype=torch.int32),
                 torch.zeros((1, A), dtype=torch.int32))
    maturing_cancelled = top_clip_differs = 0
    for t in range(T):
        slot = t % lat
        counts = rng.integers(0, 3, A)
        maturing = pipe.buf[:, slot].copy()
        pipe.cancel_newest(t, counts)
        maturing_cancelled += int((pipe.buf[:, slot] < maturing).sum())
        c = torch.as_tensor(counts)[None]
        clipped = torch.minimum(p.ring, (p.cum - torch.minimum(c, p.cum - p.mat))[..., None])
        p = te._pipe_cancel_begin(p, c, slot)
        np.testing.assert_array_equal((p.cum - p.mat)[0].numpy(), pipe.total)
        ready = pipe.pop_ready(t)
        v = p.ring[..., slot]
        np.testing.assert_array_equal((v - p.mat)[0].numpy(), ready, err_msg=str(t))
        top_clip_differs += int((clipped[..., slot] != v).sum())
        grow = rng.integers(0, 4, A)
        pipe.launch(t, grow)
        cum = p.cum + torch.as_tensor(grow, dtype=torch.int32)[None]
        ring = p.ring.clone()
        ring[..., slot] = cum
        p = te._Pipe(ring, cum, v.clone())
    assert maturing_cancelled > 0, "no cancel reached a maturing cohort"
    # with one slot every in-flight launch is maturing, and the orders agree
    assert (top_clip_differs > 0) == (lat > 1)


def _obs_dict(obs, A):
    return {f: np.broadcast_to(np.asarray(getattr(obs, f)), (A,)).copy()
            for f in ("rate", "ewma_rate", "peak_to_median", "queue_strict",
                      "queue_relaxed", "queue_len", "n_active", "n_pending",
                      "utilization", "last_violations", "active_variant",
                      "n_variants", "accuracy", "accuracy_floor", "n_spot",
                      "n_spot_pending", "spot_reclaim_risk", "harvest_level",
                      "throughput", "variant_lo", "variant_cheapest",
                      "variant_in_flight", "variant_up_ratio",
                      "variant_down_ratio", "variant_pending_ratio")}


@pytest.fixture(scope="module")
def observed(vcat):
    """Observation dicts from a catalog run, at several ticks, with the
    in-flight, pressure and slack cases all present."""
    wl = _vworkload()
    arr = SCENARIO_ZOO["trending_hotswap"].build(len(wl), duration_s=400,
                                                 mean_rps=300.0, seed=2)
    sim = ServingSim(arr, wl, catalog=vcat[0])
    pol = VECTOR_SCHEDULERS["infaas_variant"]()
    out = []
    while not sim.done:
        obs = sim.observe_pool()
        if sim.tick % 37 == 0:
            # the engine reuses its observation buffers: keep a copy
            out.append((sim.tick, _obs_dict(obs, len(wl)),
                        copy.deepcopy(obs)))
        sim.apply_pool(pol(sim.tick, obs))
    return out


def _t(o):
    return {k: torch.as_tensor(v) for k, v in o.items()}


def test_pool_features_torch_matches_numpy(observed):
    for tick, o, obs in observed:
        prev = o["rate"] * 0.9
        want = pool_features(obs, prev, rate_scale=100.0, fleet_scale=10.0)
        np.testing.assert_array_equal(
            pool_features_arrays(o, prev, rate_scale=100.0, fleet_scale=10.0),
            want)
        got = tobs.pool_features_torch(_t(o), torch.as_tensor(prev),
                                       rate_scale=100.0, fleet_scale=10.0)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(tick))


def test_action_decode_torch_matches_numpy(observed):
    rng = np.random.default_rng(3)
    tables = tobs.decode_tables("cpu")
    for tick, o, _ in observed:
        acts = rng.integers(0, tobs.N_ACTIONS, size=len(o["rate"]))
        for w, g in zip(decode_actions_arrays(acts),
                        tobs.decode_actions_torch(torch.as_tensor(acts),
                                                  tables)):
            np.testing.assert_array_equal(g.numpy(), w)
        kw = {k: o[k] for k in ("queue_strict", "queue_relaxed", "throughput",
                                "n_spot", "n_spot_pending")}
        want = procurement_targets_arrays(acts, ewma_rate=o["ewma_rate"],
                                          **kw)
        got = tobs.procurement_targets_torch(
            torch.as_tensor(acts), tables,
            ewma_rate=torch.as_tensor(o["ewma_rate"]), **_t(kw))
        for w, g in zip(want, got):
            assert g.dtype == torch.as_tensor(w).dtype
            np.testing.assert_array_equal(g.numpy(), w)
        vmove = want[3]
        np.testing.assert_array_equal(
            tobs.variant_targets_torch(
                torch.as_tensor(o["active_variant"]),
                torch.as_tensor(o["n_variants"]),
                torch.as_tensor(vmove)).numpy(),
            variant_targets_arrays(o["active_variant"], o["n_variants"],
                                   vmove))


def test_variant_moves_torch_match_numpy(observed):
    moved = 0
    last = np.full(4, -(10 ** 9), dtype=np.int64)
    for tick, o, _ in observed:
        kw = dict(bursty_threshold=1.5, flat_cushion=1.1, drain_horizon_s=5.0)
        np.testing.assert_array_equal(
            tsched.swap_aware_target_torch(_t(o), **kw).numpy(),
            swap_aware_target_arrays(o, **kw))
        mv = dict(up_util=0.55, down_util=0.9, post_swap_util=0.75,
                  queue_pressure_s=2.0, cooldown_s=120)
        want_t, want_last = infaas_variant_move_arrays(o, tick, last, **mv)
        got_t, got_last = tsched.infaas_variant_move_torch(
            _t(o), tick, torch.as_tensor(last), **mv)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
        np.testing.assert_array_equal(got_last.numpy(), want_last)
        moved += int((want_t >= 0).sum())
        last = want_last
        np.testing.assert_array_equal(
            tsched.accuracy_floor_move_torch(_t(o)).numpy(),
            accuracy_floor_move_arrays(o))
    assert moved > 0


def test_policy_logits_torch_matches_numpy(observed):
    pol = RLPoolPolicy(greedy=True)
    net = {k: {n: torch.as_tensor(v) for n, v in layer.items()}
           for k, layer in pol.params.items()}
    for tick, o, obs in observed:
        feats = pool_features(obs, o["rate"], rate_scale=pol.rate_scale,
                              fleet_scale=pol.fleet_scale)
        want = policy_logits(pol.params, feats)
        got = tpolicy.policy_logits_torch(net, torch.as_tensor(feats))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


# ---------------------------------------------------------------------------
# rl_sample: logits equal policy_logits, inverse-CDF draws on uniforms.
# ---------------------------------------------------------------------------
def test_rl_sample_logits_and_inverse_cdf_draw(observed):
    params = te.TORCH_POLICIES["rl_sample"].default_params()
    pb = te._params_to_device([params], "cpu")
    ref = RLPoolPolicy(greedy=True)
    for tick, o, obs in observed:
        A = len(o["rate"])
        od = {k: torch.as_tensor(v)[None] for k, v in o.items()}
        od["prev_rate"] = od["rate"]
        od["decode_tables"] = tobs.decode_tables("cpu")
        u = np.linspace(0.0, 0.999, A)
        acts, extras = te._pol_rl_sample(pb, od, {"u_act": torch.as_tensor(
            u)[None]})
        feats = pool_features(obs, o["rate"], rate_scale=ref.rate_scale,
                              fleet_scale=ref.fleet_scale)
        np.testing.assert_array_equal(extras["obs"][0].numpy(), feats)
        logits = policy_logits(ref.params, feats)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.minimum((u[:, None] >= np.cumsum(p, -1)).sum(-1),
                          logits.shape[-1] - 1)
        np.testing.assert_array_equal(extras["action"][0].numpy(), want)
        lp = logits - logits.max(-1, keepdims=True)
        lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
        np.testing.assert_allclose(extras["logp"][0].numpy(),
                                   lp[np.arange(A), want], rtol=1e-12,
                                   atol=1e-12)
        # the actions decode exactly as the host path decodes them
        host = procurement_action(obs, want)
        np.testing.assert_array_equal(acts["target"][0].numpy(), host.target)
        np.testing.assert_array_equal(acts["spot"][0].numpy(),
                                      host.spot_target)
        np.testing.assert_array_equal(acts["variant"][0].numpy(),
                                      host.variant_target)


def test_rl_sample_run_is_seeded():
    A, T = 4, 120
    wl = _port_workload(_workload(A))
    arr = SCENARIO_ZOO["diurnal_phases"].build(A, duration_s=T)
    a = te.run_scenario(arr, wl, "rl_sample", seed=3, record_trajectory=True,
                        device=DEV)
    b = te.run_scenario(arr, wl, "rl_sample", seed=3, record_trajectory=True,
                        device=DEV)
    c = te.run_scenario(arr, wl, "rl_sample", seed=4, record_trajectory=True,
                        device=DEV)
    tr = a["trajectory"]
    assert tr["obs"].shape == (T, A, tobs.OBS_DIM)
    for k in ("action", "logp", "value"):
        assert tr[k].shape == (T, A), k
    np.testing.assert_array_equal(tr["action"], b["trajectory"]["action"])
    assert (tr["action"] != c["trajectory"]["action"]).any()
    assert (tr["logp"] <= 1e-9).all()
    assert len(np.unique(tr["action"])) > 1


def test_rl_sample_draws_from_passed_uniforms():
    """``uniforms=`` replaces the seed's own draw: passing that draw gives
    the same run, all-zero uniforms take the first action everywhere, and
    each cell reads its own ``[T, A]`` block."""
    A, T = 4, 80
    wl = _port_workload(_workload(A))
    arr = SCENARIO_ZOO["mmpp_bursts"].build(A, duration_s=T)
    policy = te.TORCH_POLICIES["rl_sample"]

    def actions(uniforms, seeds=(3, 3)):
        statics, state0, xs, variants = te.prepare_grid(
            np.stack([arr, arr]), wl, "rl_sample", seeds=list(seeds),
            uniforms=uniforms, device=DEV)
        out = te.run_ticks(policy.apply, statics, state0, xs,
                           variants=variants, stack=True)
        return out["ys"]["action"].numpy()          # [T, B, A]

    own = torch.rand((T, A), generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64).numpy()
    np.testing.assert_array_equal(actions(None), actions(np.stack([own, own])))
    mixed = actions(np.stack([np.zeros((T, A)), own]))
    assert (mixed[:, 0] == 0).all()
    np.testing.assert_array_equal(mixed[:, 1], actions(None)[:, 1])
    assert (actions(None, seeds=(3, 4))[:, 1] != mixed[:, 1]).any()
    with pytest.raises(ValueError, match="uniforms"):
        actions(np.zeros((2, T, A + 1)))
    with pytest.raises(ValueError, match="draws no actions"):
        te.prepare_grid(arr[None], wl, "portfolio", uniforms=np.zeros((1, T, A)),
                        device=DEV)
