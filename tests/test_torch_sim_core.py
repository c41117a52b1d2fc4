"""The port's NumPy control plane against the reference, bit for bit.

``repro_torch.core`` keeps its own copies of the reference's NumPy sim
core, workloads, profiles, schedulers and RL environment.  Both sides are
NumPy, so every output here is compared exactly: arrays with
``np.array_equal``, floats with ``==``.  The cases are those of
``tests/test_sim_engine.py``, ``test_simulator.py``, ``test_tiers.py``,
``test_workloads.py``, ``test_profiles_selection.py``, ``test_system.py``
and ``test_variants.py``, run through both packages at small A and T.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import math

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
POOL4 = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b"]
# tests/test_system.py's pool
POOL6 = POOL4 + ["whisper-small", "recurrentgemma-9b"]


def _m(pkg, name):
    """``pkg.core.<name>`` of one package."""
    return importlib.import_module(f"{pkg}.core.{name}")


def _both(fn):
    """``fn(m)`` for each package, ``m(name)`` resolving its modules."""
    return [fn(lambda name, pkg=pkg: _m(pkg, name)) for pkg in PKGS]


def _assert_same(a, b, path="out"):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        if a.dtype.kind in "fc":
            assert np.array_equal(a, b, equal_nan=True), path
        else:
            assert np.array_equal(a, b), path
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert type(a).__name__ == type(b).__name__, path
        assert a == b, f"{path}: {a!r} != {b!r}"


def _same(fn):
    ref, port = _both(fn)
    _assert_same(ref, port)
    return ref


# ---------------------------------------------------------------------------
# Traces, workloads, profiles.
# ---------------------------------------------------------------------------
def _zoo_names():
    from repro.core.workloads import SCENARIO_ZOO
    return sorted(SCENARIO_ZOO)


def _generators():
    from repro.core.workloads import GENERATORS
    return sorted(k for k in GENERATORS if k != "replay")


@pytest.mark.parametrize("scenario", _zoo_names())
def test_zoo_arrivals_and_specs_equal(scenario):
    def run(m):
        sc = m("workloads").SCENARIO_ZOO[scenario]
        sc2 = m("workloads").Scenario.from_json(sc.to_json())
        return (sc.to_dict(), sc.build(6, duration_s=300),
                sc.build(5, seed=11, duration_s=200, mean_rps=80.0),
                sc2.build(6, duration_s=300))
    _same(run)


@pytest.mark.parametrize("kind", _generators())
def test_generators_equal(kind):
    _same(lambda m: m("workloads").GENERATORS[kind](5, 400, 120.0, 3))


def test_replay_and_pool_trace_equal(tmp_path):
    arr = _m("repro", "workloads").SCENARIO_ZOO["mmpp_bursts"].build(
        3, duration_s=120)

    def run(m):
        w = m("workloads")
        path = w.save_replay(str(tmp_path / w.__name__), arr)
        trace = m("traces").get_trace("wiki", 200, mean_rps=50.0)
        return (w.GENERATORS["replay"](3, 120, 0.0, 0, path=path),
                w.GENERATORS["replay"](3, 100, 40.0, 0, path=path,
                                       renormalize=True),
                w.from_pool_trace(trace, [0.5, 0.3, 0.2]))
    _same(run)


def _trace_names():
    from repro.core.traces import TRACES
    return sorted(TRACES)


@pytest.mark.parametrize("name", _trace_names())
def test_traces_equal(name):
    def run(m):
        tr = m("traces")
        t = tr.get_trace(name, 900, mean_rps=75.0, seed=4)
        return t, tr.peak_to_median(t), tr.TRACES[name](300, 20.0, 1)
    _same(run)
    _same(lambda m: m("traces").trace_stats(600, seed=2))


def test_profiles_and_model_pool_equal():
    from repro.configs import list_architectures

    def run(m):
        prof = m("profiles")
        out = {"pool": prof.model_pool(),
               "iso_lat": prof.iso_latency_set(0.5),
               "iso_acc": prof.iso_accuracy_set(0.6)}
        for arch in list_architectures():
            p = prof.get_profile(arch)
            big = prof.ModelProfile(p.cfg, p.chips * 2)
            out[arch] = dict(
                chips=p.chips, min_chips=p.min_chips,
                weight=p.weight_bytes, active=p.active_bytes,
                kv=p.kv_bytes_per_token(), state=p.state_bytes(4096),
                prefill=p.prefill_latency(512, 4),
                decode=[p.decode_step_latency(b) for b in (1, 8, 16)],
                request=p.request_latency(prof.STANDARD, 2),
                conc=p.max_concurrency(), thr=p.throughput(),
                res=p.reserved_cost_per_hour(), burst=p.burst_cost_per_request(),
                cold=p.cold_start_s(),
                big=[big.decode_step_latency(8), big.prefill_latency(512)],
            )
        return out
    _same(run)


def test_model_selection_equal():
    def run(m):
        ms = m("model_selection")
        out = []
        for acc, lat in ((0.0, 10.0), (0.5, 1.0), (0.6, 0.5), (0.7, 2.0)):
            c = ms.Constraint(min_accuracy=acc, max_latency_s=lat)
            out.append(ms.feasible_set(c))
            out.append((ms.select_naive(c), ms.select_paragon(c)))
        with pytest.raises(ms.NoFeasibleModel):
            ms.select_paragon(ms.Constraint(min_accuracy=0.99,
                                            max_latency_s=0.01))
        # tests/test_system.py's workload-2 stream (Fig 9c)
        rng = np.random.default_rng(0)
        cons = [ms.Constraint(float(rng.uniform(0.3, 0.85)),
                              float(rng.uniform(0.3, 2.0)))
                for _ in range(200)]
        for how in ("naive", "paragon"):
            out.append(ms.selection_cost(cons, how))
            out.append(ms.selection_workload(cons, how))
        return out
    _same(run)


def test_hardware_and_core_surface_equal():
    def run(m):
        hw = m("hardware")
        return dataclasses.asdict(hw.PRICING), dataclasses.asdict(hw.V5E)
    _same(run)
    ref, port = (importlib.import_module(f"{p}.core") for p in PKGS)
    assert sorted(n for n in dir(ref) if not n.startswith("_")) == sorted(
        n for n in dir(port) if not n.startswith("_"))


# ---------------------------------------------------------------------------
# The engine: vector schedulers over the zoo, with and without a catalog.
# ---------------------------------------------------------------------------
def _vector_names():
    from repro.core.schedulers import VECTOR_SCHEDULERS
    return sorted(VECTOR_SCHEDULERS)


def _catalog(m, wl):
    return m("sim").VariantCatalog.for_workload(wl)


def _vwl(m, floor=0.55):
    return [dataclasses.replace(w, min_accuracy=floor)
            for w in m("sim").uniform_pool_workload(POOL4, strict_frac=0.25)]


def _run_pool(m, scenario, policy, *, ticks=200, catalog=False, seed=0,
              telemetry=False, mean_rps=150.0):
    wl = _vwl(m) if catalog else m("sim").uniform_pool_workload(
        POOL4, strict_frac=0.25)
    arr = m("workloads").SCENARIO_ZOO[scenario].build(
        len(wl), duration_s=ticks, mean_rps=mean_rps, seed=seed)
    tel = m("sim").Telemetry() if telemetry else None
    sim = m("sim").ServingSim(arr, wl, seed=seed,
                              catalog=_catalog(m, wl) if catalog else None,
                              telemetry=tel)
    pol = m("schedulers").VECTOR_SCHEDULERS[policy]()
    acts = []
    while not sim.done:
        obs = sim.observe_pool()
        act = pol(sim.tick, obs)
        acts.append(copy.deepcopy(act))
        sim.apply_pool(act)
    out = {"res": sim.res, "summary": sim.res.summary(),
           "per_arch": sim.per_arch_counts(), "actions": acts}
    if telemetry:
        out["events"] = tel.events_as_dicts()
        out["recorder"] = tel.recorder.as_dict()
        out["prom"] = tel.prometheus_text(sim.res)
        rec = m("sim.telemetry").reconcile_events(tel.events, len(wl), ticks)
        out["reconciled"] = dict(rec)
        out["incidents"] = m("sim.telemetry").detect_incidents(tel.recorder)
    return out


@pytest.mark.parametrize("policy", _vector_names())
def test_vector_schedulers_over_the_zoo(policy):
    for i, scenario in enumerate(_zoo_names()):
        _same(lambda m: _run_pool(m, scenario, policy, ticks=150, seed=i))


@pytest.mark.parametrize("policy", ["infaas_variant", "accuracy_floor",
                                    "rl_pool", "paragon", "portfolio"])
def test_vector_schedulers_with_a_catalog(policy):
    for i, scenario in enumerate(("trending_hotswap", "diurnal_phases",
                                  "flash_anti")):
        _same(lambda m: _run_pool(m, scenario, policy, ticks=200, seed=i,
                                  catalog=True, mean_rps=300.0))


@pytest.mark.parametrize("catalog", [False, True])
def test_telemetry_event_log(catalog):
    _same(lambda m: _run_pool(m, "flash_correlated", "portfolio",
                              ticks=200, catalog=catalog, telemetry=True))


# ---------------------------------------------------------------------------
# The dict path, the seed loop and the 1-D trace path.
# ---------------------------------------------------------------------------
def _dict_names():
    from repro.core.schedulers import SCHEDULERS
    return sorted(SCHEDULERS)


@pytest.mark.parametrize("policy", _dict_names())
def test_dict_schedulers_and_reference_sim(policy):
    def run(m):
        sim = m("sim")
        trace = m("traces").get_trace("berkeley", 300, mean_rps=120)
        wl = sim.uniform_pool_workload(POOL4, strict_frac=0.25)
        sched = m("schedulers").SCHEDULERS
        premium = dataclasses.replace(m("hardware").PRICING, burst_premium=8.0)
        out = {
            "simulate": sim.simulate(trace, wl, sched[policy](),
                                     record_timeline=True),
            "reference": sim.simulate_reference(trace, wl, sched[policy]()),
            "system": sim.simulate(
                m("traces").get_trace("wiki", 300, mean_rps=300),
                sim.uniform_pool_workload(POOL6, strict_frac=0.25),
                sched[policy](), pricing=premium),
        }
        # the stepwise interface: observe / apply with marginal metrics
        s = sim.ServingSim(trace[:120], wl)
        pol, steps = sched[policy](), []
        while not s.done:
            obs = s.observe()
            steps.append((obs, s.apply(pol(s.tick, obs))))
        out["steps"] = steps
        return out
    _same(run)


@pytest.mark.parametrize("policy", ["reactive", "paragon", "portfolio",
                                    "spot_paragon", "infaas_variant"])
def test_dict_vector_parity_and_replicated_pool(policy):
    def run(m):
        sim = m("sim")
        wl = sim.replicate_pool(POOL4, 3, strict_frac=0.4)
        trace = m("traces").get_trace("twitter", 200, mean_rps=90)
        return (sim.simulate(trace, wl, m("schedulers").SCHEDULERS[policy]()),
                sim.simulate(trace, wl,
                             m("schedulers").VECTOR_SCHEDULERS[policy]()))
    _same(run)


def test_premium_pricing_and_spot_determinism():
    def run(m):
        sim = m("sim")
        pricing = dataclasses.replace(m("hardware").PRICING,
                                      burst_premium=8.0, spot_discount=0.5)
        trace = m("traces").get_trace("twitter", 300, mean_rps=80)
        wl = sim.uniform_pool_workload(POOL4, strict_frac=0.5)
        sched = m("schedulers").SCHEDULERS
        return [sim.simulate(trace, wl, sched[p](), pricing=pricing,
                             prewarm=False, warm_start=False)
                for p in ("mixed", "spot_paragon", "exascale")]
    _same(run)


# ---------------------------------------------------------------------------
# The load monitor.
# ---------------------------------------------------------------------------
def test_pool_load_monitor_equal():
    arr = _m("repro", "workloads").SCENARIO_ZOO["flash_correlated"].build(
        5, duration_s=400)

    def run(m):
        lm = m("load_monitor")
        mon = lm.PoolLoadMonitor(5, window_s=60)
        scalar = lm.LoadMonitor()
        stats = []
        for t in range(arr.shape[1]):
            mon.observe(arr[:, t])
            scalar.observe(float(arr[0, t]))
            stats.append((mon.stats(), mon.bursty(),
                          scalar.rate, scalar.peak, scalar.median,
                          scalar.peak_to_median, scalar.bursty()))
        return stats, lm.pool_stats_trajectory(arr)
    _same(run)


# ---------------------------------------------------------------------------
# The RL side: features, the deployed policy, the environment.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("greedy", [True, False])
def test_rl_pool_policy_on_the_checkpoint(greedy):
    def run(m):
        pol = m("rl.policy").RLPoolPolicy(greedy=greedy, seed=5)
        assert pol.trained        # artifacts/rl/pool_policy.json is there
        wl = _vwl(m)
        arr = m("workloads").SCENARIO_ZOO["trending_hotswap"].build(
            len(wl), duration_s=200, mean_rps=300.0, seed=3)
        sim = m("sim").ServingSim(arr, wl, catalog=_catalog(m, wl))
        out = []
        while not sim.done:
            obs = sim.observe_pool()
            feats = m("rl.obs").pool_features(obs, obs.rate * 0.9,
                                              rate_scale=100.0,
                                              fleet_scale=10.0)
            act = pol(sim.tick, obs)
            out.append((feats, pol.logits(feats), copy.deepcopy(act)))
            sim.apply_pool(act)
        return out, sim.res
    _same(run)


def test_pool_env_reset_and_step():
    def run(m):
        rl = m("rl")
        wl = _vwl(m)
        scenarios = [m("workloads").SCENARIO_ZOO[n]
                     for n in ("mmpp_bursts", "diurnal_phases")]
        cfg = rl.EnvConfig(duration_s=80, mean_rps=200.0, accuracy_bonus=0.01)
        env = rl.PoolServingEnv(wl, cfg, scenarios=scenarios,
                                scenario_seed=2, catalog=_catalog(m, wl))
        rng = np.random.default_rng(0)
        out = []
        for _ in range(2):
            obs, done = env.reset(), False
            out.append((obs, env.last_scenario.name))
            while not done:
                obs, rew, done, metrics = env.step(
                    rng.integers(0, rl.N_ACTIONS, size=len(wl)))
                out.append((obs, rew, done, metrics))
            out.append(env.episode_result())
        single = rl.ServingEnv(rl.EnvConfig(duration_s=60),
                               m("traces").get_trace("berkeley", 60))
        obs, done = single.reset(), False
        out.append(obs)
        while not done:
            obs, rew, done, metrics = single.step(int(rng.integers(12)))
            out.append((obs, rew, done))
        out.append(single.episode_result())
        return out
    _same(run)


def test_procurement_decode_equal():
    def run(m):
        obs_mod = m("rl.obs")
        acts = np.arange(obs_mod.N_ACTIONS)
        return obs_mod.decode_actions(acts), obs_mod.N_ACTIONS, obs_mod.OBS_DIM
    _same(run)
