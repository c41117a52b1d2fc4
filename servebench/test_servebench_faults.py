"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a served cell can have (``servebench/faults.py``), and
the float8 control reads wider gaps than the served program.  The
harness's look for a card is skipped; the rest of a run is driven on the
CPU at ``reduced()`` in f32, held to the tiny cell's limits
(``tiny.LIMITS``)."""
import pytest

from servebench import faults, harness, judge, spec, tiny
from servebench.traffic import Traffic


def test_a_sound_run_is_correct(tmp_path):
    res = tiny.run(tmp_path, loop="backlog")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("arch", [tiny.PHI, tiny.QWEN])
def test_a_broken_step_is_not_correct(tmp_path, fault, arch):
    with faults.planted(fault):
        res = tiny.run(tmp_path, arch=arch, loop="backlog")
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for name, c in res["checks"].items()
               if name in ("max_gap", "mean_gap"))


def test_an_unanswered_request_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.serving import Engine
    # the engine admits nothing: every request due waits past the drain
    monkeypatch.setattr(Engine, "free_slots", lambda self: [])
    monkeypatch.setattr(harness, "DRAIN_LIMIT_S", 0.5)      # of step-clock time
    res = tiny.run(tmp_path, seconds=0.5)
    assert not res["correct"] and res["checks"]["unanswered"]["value"] > 0


def test_the_float8_control_reads_wider_gaps(tmp_path):
    root, bd = tiny.make(tmp_path, dtype="bfloat16", loop="backlog")
    cell = spec.load_cell("tiny.mix", root, bd)
    prog = harness.Program(cell, 2**32 + 9, device="cpu")
    traffic = Traffic(cell.traffic, 2**32 + 9, cell.config["vocab_size"])
    with tiny.step_clock():
        harness.serve(prog, traffic, 1.0)
    prog.free()
    v = judge.judge(cell, prog, 2**32 + 9, control=True)
    for name in ("max_gap", "mean_gap"):
        assert v["control"][name] > 0
        assert v["control"][name] >= 3 * v["readings"][name]
