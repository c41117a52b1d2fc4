"""The readers of the program's spans (``servebench/spans.py`` and its
files in ``metrics/``): a traced tiny run under a real CPU profiler, so
that the program's tracer is on, read from its records; the device-idle split on planted device records and
spans, which a CPU run has none of; and nothing read from a tree without
the tracer."""
from types import SimpleNamespace

import pytest
import torch

from servebench import harness, profiling, spans, spec, tiny
from servebench import run as run_mod

SPAN_METRICS = ("step_launch_ms.rag", "step_wait_ms.rag", "insert_cache_ms.rag",
                "live_slot_pct.rag", "moe_prefill_drop_pct.rag", "moe_decode_drop_pct.rag")


def _cpu_profile():
    """``profiling.start`` without the device sleeps of its pad."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def test_a_traced_tiny_run_reads_the_program_spans(tmp_path, monkeypatch):
    """The metric files read the run as the harness's readers do (the
    tiny cell's ``metrics/`` is a copy of this one)."""
    from repro_torch import tracing
    monkeypatch.setattr(profiling, "start", _cpu_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    seen = {}
    original = harness.Tracer.__init__

    def keep(self, prog):
        original(self, prog)
        seen["tracer"] = self
    monkeypatch.setattr(harness.Tracer, "__init__", keep)
    tracing.clear()
    try:
        res = tiny.run(tmp_path, seed=2**31 + 5, seconds=1.0, trace=1)
        tracer = seen["tracer"]
        st, prog = tracer.used, tracer.prog
        assert st is not None and res["correct"], res["checks"]
        cell = spec.load_cell("tiny.mix", tmp_path, tmp_path / "servebench")
        view = run_mod.RunView(cell, prog, 0.0, tracer)
        m = {name: spec.load_reader(name, cell.bench_dir)(view)
             for name in SPAN_METRICS + ("idle_in_launch_pct.rag",)}
        assert all(m[name] is not None for name in SPAN_METRICS), m
        assert m["idle_in_launch_pct.rag"] is None          # no device records on the CPU
        assert m["step_launch_ms.rag"] > 0 and m["step_wait_ms.rag"] > 0
        assert m["insert_cache_ms.rag"] > 0
        # the harness's own records of the stretch's steps: live slots a step
        steps = prog.rec.steps[st.n_steps:st.end_steps]
        assert steps
        assert m["live_slot_pct.rag"] == pytest.approx(
            100.0 * sum(s[2] for s in steps) / (prog.slots * len(steps)))
        assert 0.0 <= m["moe_prefill_drop_pct.rag"] <= 100.0
        assert 0.0 <= m["moe_decode_drop_pct.rag"] <= 100.0
        # the stretch's spans are the steps and inserts the harness timed in it
        s0, s1, dev = spans.stretch_of(st.prof)
        assert dev == []
        recs = [r for r in tracing.records() if s0 <= r["start_ns"] and r["end_ns"] <= s1]
        assert sum(r["name"] == "engine.step" for r in recs) == len(steps)
        assert sum(r["name"] == "engine.insert" for r in recs) == st.end_inserts - st.n_inserts
    finally:
        tracing.clear()


class _Event:
    def __init__(self, start_ns, duration_ns, name="k", device=True):
        self.a, self.d, self.n, self.dev = start_ns, duration_ns, name, device

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return not self.dev

    def name(self):
        return self.n

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.d


def _span(i, name, a, b, parent=None):
    return {"id": i, "parent": parent, "name": name, "rid": None, "start_ns": a, "end_ns": b,
            "counts": {}}


PLANTED = [_span(0, "engine.step", 100, 900), _span(1, "engine.step.launch", 110, 500, 0),
           _span(2, "attention.decode", 120, 200, 1), _span(3, "moe_layer", 210, 480, 1),
           _span(4, "engine.step.wait", 500, 880, 0), _span(5, "moe_layer", 880, 895, 0)]
# device busy (the first clipped to the stretch [0, 1000)); the gaps start at
# 50 (no span: 80 ns), 150 (attention.decode in the launch: 150), 600 (the
# wait: 100), 885 (a moe_layer outside any enqueue span: 5), 950 (none: 50)
DEVICE = [(-50, 100), (130, 20), (300, 300), (700, 185), (890, 60)]


def _run(monkeypatch, records):
    monkeypatch.setattr(spans, "_program_records", lambda: records)
    events = [_Event(0, 1000, profiling.STRETCH, device=False)] + [_Event(a, d)
                                                                   for a, d in DEVICE]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return SimpleNamespace(stretch=SimpleNamespace(prof=prof))


def test_idle_in_launch_on_planted_records(monkeypatch):
    run = _run(monkeypatch, PLANTED)
    assert spans.idle_by_span(PLANTED, spans.stretch_of(run.stretch.prof)[2], 0, 1000) == \
        pytest.approx({None: 130e-9, 2: 150e-9, 4: 100e-9, 5: 5e-9})
    assert spans.idle_in_launch_pct(run) == pytest.approx(100.0 * 150 / 385)
    assert spans.step_launch_ms(run) == pytest.approx(390e-6)
    assert spans.step_wait_ms(run) == pytest.approx(380e-6)


def test_nothing_is_read_from_a_tree_without_the_tracer(monkeypatch):
    for records in (None, []):
        run = _run(monkeypatch, records)
        for read in (spans.step_launch_ms, spans.step_wait_ms, spans.insert_cache_ms,
                     spans.idle_in_launch_pct, spans.live_slot_pct, spans.moe_prefill_drop_pct,
                     spans.moe_decode_drop_pct):
            assert read(run) is None
    assert spans.step_launch_ms(SimpleNamespace(stretch=None)) is None
