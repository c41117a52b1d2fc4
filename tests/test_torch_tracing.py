"""The port's spans and counters (``repro_torch.tracing``) on the reduced
phi3.5-moe engine, on the CPU: nothing recorded without a profiler; under
one, the span tree of the served path, its counts held to counts taken
independently (the slots from a host mirror of each slot's position, the
MoE drops from ``_route`` and the capacity), the stamps bracketing the
profiler's own ranges, and no host sync inside the model."""
import collections
import json
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request

ARCH = "phi3.5-moe-42b-a6.6b"
SLOTS, CACHE = 4, 64


@pytest.fixture(scope="module")
def phi():
    cfg = get_config(ARCH).reduced()
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                                   device="cpu")
    return cfg, params


@pytest.fixture(autouse=True)
def fresh_records():
    tracing.clear()
    yield
    tracing.clear()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _requests(cfg, n=3, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(rid=100 + i, prompt=rng.integers(0, cfg.vocab_size, 9 + 3 * i).astype(np.int32),
                    max_new_tokens=2 + i) for i in range(n)]


def _serve(phi, reqs, window=0, cache_len=CACHE):
    cfg, params = phi
    engine = Engine(cfg, params, EngineConfig(slots=SLOTS, cache_len=cache_len, window=window,
                                              device="cpu"))
    batcher = ContinuousBatcher(engine)
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_idle()
    return engine, batcher


def test_a_run_without_a_profiler_records_nothing(phi):
    assert not tracing.enabled()
    _, batcher = _serve(phi, _requests(phi[0]))
    assert batcher.stats.finished == 3
    assert tracing.records() == []


def test_the_span_tree_of_the_served_path(phi):
    cfg = phi[0]
    reqs = _requests(cfg)
    with _profile():
        assert tracing.enabled()
        _, batcher = _serve(phi, reqs)
    assert not tracing.enabled()
    recs = tracing.records()
    by_id = {r["id"]: r for r in recs}

    def parent(r):
        return by_id[r["parent"]]["name"] if r["parent"] is not None else None

    want = {"batcher.run_step": {None}, "engine.insert": {"batcher.run_step"},
            "engine.step": {"batcher.run_step"}, "engine.step.launch": {"engine.step"},
            "engine.step.wait": {"engine.step"}, "engine.step.retire": {"engine.step"},
            "engine.insert.cache": {"engine.insert"}, "engine.insert.prefill": {"engine.insert"},
            "engine.insert.first_token": {"engine.insert"},
            "engine.insert.scatter": {"engine.insert"},
            "attention.prefill": {"engine.insert.prefill"},
            "attention.decode": {"engine.step.launch"},
            "moe_layer": {"engine.insert.prefill", "engine.step.launch"},
            "moe_layer.route": {"moe_layer"}, "moe_layer.experts": {"moe_layer"},
            "moe_layer.combine": {"moe_layer"}}
    seen = collections.defaultdict(set)
    for r in recs:
        seen[r["name"]].add(parent(r))
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    assert dict(seen) == want
    names = collections.Counter(r["name"] for r in recs)
    steps = batcher.stats.decode_steps
    n_steps = names["engine.step"]
    assert names["batcher.run_step"] == steps and names["engine.insert"] == len(reqs)
    assert names["attention.prefill"] == cfg.num_layers * len(reqs)
    assert names["attention.decode"] == cfg.num_layers * n_steps
    assert names["moe_layer"] == cfg.num_layers * (len(reqs) + n_steps)
    assert not any(n.startswith(("moe.", "servebench.")) for n in names)
    inserts = [r for r in recs if r["name"] == "engine.insert"]
    assert sorted(r["rid"] for r in inserts) == [q.rid for q in reqs]
    for r in inserts:
        kids = [k for k in recs if k["parent"] == r["id"]]
        assert all(k["rid"] == r["rid"] for k in kids)
        req = next(q for q in reqs if q.rid == r["rid"])
        assert r["counts"]["prompt_tokens"] == len(req.prompt)
    caches = [r["counts"]["cache_bytes"] for r in recs if r["name"] == "engine.insert.cache"]
    one = model_lib.init_cache(cfg, 1, CACHE, dtype=torch.float32, device="cpu")
    leaves = [one["t"]] + [t for sub in one["blocks"].values() for leaf in sub.values()
                           for t in leaf.values()]
    assert caches == [sum(t.numel() * t.element_size() for t in leaves)] * len(reqs)
    assert sum(r["counts"].get("admitted", 0) for r in recs if r["name"] == "batcher.run_step") == \
        batcher.stats.admitted == len(reqs)
    assert sum(r["counts"]["finished"] for r in recs if r["name"] == "engine.step.retire") == \
        len(reqs)


@pytest.mark.parametrize("window,cache_len", [(0, CACHE), (12, CACHE), (0, 16)])
def test_slot_counts_equal_a_host_mirror(phi, window, cache_len):
    """``slots``, ``live`` and ``valid_kv`` of each step against a mirror
    of each slot's position kept beside the engine, as the benchmark's
    harness keeps one (capped at the ring or the window)."""
    cfg, params = phi
    engine = Engine(cfg, params, EngineConfig(slots=SLOTS, cache_len=cache_len, window=window,
                                              device="cpu"))
    mirror = np.zeros(SLOTS, np.int64)
    want = []
    step = engine.step

    def mirrored_step():
        live = [i for i, r in enumerate(engine.slot_req) if r is not None]
        if live:
            cap = min(cache_len, window) if window else cache_len
            want.append((SLOTS, len(live), int(np.minimum(mirror[live] + 1, cap).sum())))
            mirror[live] += 1
        return step()

    insert = engine.insert

    def mirrored_insert(req, slot=None):
        s = insert(req, slot)
        mirror[s] = len(req.prompt)
        return s

    engine.step, engine.insert = mirrored_step, mirrored_insert
    batcher = ContinuousBatcher(engine)
    for r in _requests(cfg, n=6, seed=2):
        batcher.submit(r)
    with _profile():
        batcher.run_until_idle()
    got = [(r["counts"]["slots"], r["counts"]["live"], r["counts"]["valid_kv"])
           for r in tracing.records() if r["name"] == "engine.step"]
    assert got == want and len(got) > 3
    assert any(live < SLOTS for _, live, _ in got)


def _direct_drops(topi: torch.Tensor, c: int, live: np.ndarray):
    """(assigned, dropped) of the live tokens' assignments: each expert
    keeps its first ``c`` assignments in token order."""
    flat = topi.reshape(-1).numpy()
    k = topi.shape[1]
    seen = collections.Counter()
    assigned = dropped = 0
    for j, e in enumerate(flat):
        rank = seen[e]
        seen[e] += 1
        if live[j // k]:
            assigned += 1
            dropped += rank >= c
    return assigned, dropped


def test_moe_drops_count_the_live_tokens_only(phi, monkeypatch):
    """At a planted capacity of 2 rows an expert, with free slots in every
    step, the route spans' counts equal a count from ``_route``'s choices."""
    cfg, params = phi
    c = 2
    monkeypatch.setattr(moe, "_capacity", lambda cfg, tokens: c)
    calls = []
    route = moe._route

    def watched(cfg, router_w, xf):
        gates, topi, aux = route(cfg, router_w, xf)
        calls.append(topi.clone())
        return gates, topi, aux

    monkeypatch.setattr(moe, "_route", watched)
    engine = Engine(cfg, params, EngineConfig(slots=SLOTS, cache_len=CACHE, device="cpu"))
    lives = []
    step = engine.step

    def noted_step():
        lives.append(np.array([r is not None for r in engine.slot_req]))
        return step()

    engine.step = noted_step
    reqs = _requests(cfg, n=2, seed=3)
    with _profile():
        for r in reqs:
            engine.insert(r)
        while engine.live:
            engine.step()
    recs = tracing.records()
    by_id = {r["id"]: r for r in recs}
    routes = [r for r in recs if r["name"] == "moe_layer.route"]
    assert len(routes) == len(calls) == cfg.num_layers * (len(reqs) + len(lives))
    want = []
    for i, topi in enumerate(calls):
        layer_call = i // cfg.num_layers
        if layer_call < len(reqs):
            live = np.ones(topi.shape[0], bool)
        else:
            live = lives[layer_call - len(reqs)]
        want.append(_direct_drops(topi, c, live))
    got = [(r["counts"]["assigned"], r["counts"]["dropped"]) for r in routes]
    assert got == want
    k = cfg.num_experts_per_tok
    in_steps = [g for g, r in zip(got, routes)
                if by_id[by_id[by_id[r["parent"]]["parent"]]["parent"]]["name"] == "engine.step"]
    # the free slots' rows, routed too, are never counted
    assert in_steps and all(a < k * SLOTS for a, _ in in_steps)
    assert all(a == k * 2 for a, _ in in_steps[:cfg.num_layers])
    assert sum(d for _, d in got) > 0


def test_the_stamps_bracket_the_profilers_ranges(phi):
    cfg = phi[0]
    with _profile() as prof:
        _serve(phi, _requests(cfg))
    recs = tracing.records()
    names = {r["name"] for r in recs}
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in names:
            ranges[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in names:
        mine = sorted((r["start_ns"], r["end_ns"]) for r in recs if r["name"] == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (a, b), (pa, pb) in zip(mine, theirs):
            assert a <= pa <= pb <= b, (name, pa - a, b - pb)


class _Syncs(TorchDispatchMode):
    """Counts the ops that hand a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_traced_prefill_and_decode_read_nothing_back(phi):
    """With the tracer on (and its counts made), the model's prefill and
    decode step hand no value to the host: the counts stay on the device."""
    cfg, params = phi
    engine = Engine(cfg, params, EngineConfig(slots=SLOTS, cache_len=CACHE, device="cpu"))
    tokens = torch.arange(11)[None, :]
    with _profile(), _Syncs() as syncs:
        model_lib.prefill(cfg, params, tokens, engine._init_cache(1))
        with tracing.span("engine.step") as sp:
            sp.live_rows = torch.tensor([True, False, True, False])
            model_lib.decode_step(cfg, params, torch.zeros(SLOTS, dtype=torch.long), engine.cache)
    assert syncs.n == 0
    routes = [r for r in tracing.records() if r["name"] == "moe_layer.route"]
    assert len(routes) == 2 * cfg.num_layers and all("dropped" in r["counts"] for r in routes)
    assert [r["counts"]["assigned"] for r in routes[cfg.num_layers:]] == \
        [2 * cfg.num_experts_per_tok] * cfg.num_layers


def test_count_outside_a_span_and_clear():
    with _profile():
        tracing.count("orphan", 3)               # no open span: dropped
        with tracing.span("outer", rid=7):
            tracing.count("n", 1)
            with tracing.span("inner"):
                tracing.count("n", torch.tensor(2))
                tracing.count("n", torch.tensor(3))
                assert tracing.live_rows() is None
    outer, inner = tracing.records()
    assert outer["counts"] == {"n": 1} and inner["counts"] == {"n": 5}
    assert inner["parent"] == outer["id"] and inner["rid"] == outer["rid"] == 7
    tracing.clear()
    assert tracing.records() == []
    with tracing.span("off") as sp:
        assert sp is None
    tracing.count("n", 1)
    assert tracing.records() == []


def test_summary_takes_the_children_out_of_self_time():
    recs = [{"id": 0, "parent": None, "name": "a", "start_ns": 0, "end_ns": 10_000_000,
             "counts": {"n": 2}},
            {"id": 1, "parent": 0, "name": "b", "start_ns": 1_000_000, "end_ns": 4_000_000,
             "counts": {}},
            {"id": 2, "parent": 0, "name": "b", "start_ns": 5_000_000, "end_ns": 6_000_000,
             "counts": {"n": 3}}]
    s = tracing.summary(recs)
    assert s["a"] == {"n": 1, "total_ms": 10.0, "self_ms": 6.0, "counts": {"n": 2}}
    assert s["b"] == {"n": 2, "total_ms": 4.0, "self_ms": 4.0, "counts": {"n": 3}}


def test_serve_writes_a_chrome_trace_with_the_spans(tmp_path, monkeypatch, capsys):
    path = tmp_path / "serve.json"
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced", "--device", "cpu",
                                      "--requests", "3", "--max-new", "2", "--trace", str(path)])
    serve.main()
    out = capsys.readouterr().out
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"engine.insert.prefill", "engine.step.launch", "attention.decode",
            "moe_layer.route"} <= names
    lines = {ln.split()[1]: ln for ln in out.splitlines() if ln.startswith("[trace] ")}
    assert "admitted=3" in lines["batcher.run_step"] and "live=" in lines["engine.step"]
    assert "assigned=" in lines["moe_layer.route"]
    assert tracing.records() == []
