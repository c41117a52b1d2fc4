"""The traced run's control flow on the CPU, the profiler replaced by a
stand-in: the stretch follows the window, one that misses records is taken
again, and every per-layer metric of the cell is read from it."""
import torch

from servebench import harness, profiling, spec, tiny


def test_the_stretch_follows_the_window_and_a_miss_is_taken_again(tmp_path, monkeypatch):
    class Stand:
        def __exit__(self, *exc):
            return None

    readings = iter([{"missed": "1 of 900 traced launches without a record"},
                     {"missed": "", "window_s": 1.0, "busy_s": 0.6,
                      "by_kernel_s": {"fa_wgmma_kernel": 0.1}, "flash_s": 0.1, "decode_s": 0.05,
                      "moe_s": {"moe.layer": 0.2}, "idle_gaps_s": {"servebench.step": 0.4}}])
    taken = []
    monkeypatch.setattr(profiling, "start", lambda: taken.append(harness.clock()) or Stand())
    monkeypatch.setattr(profiling, "reduce", lambda prof, flash, decode: next(readings))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    seen = {}
    original = harness.Tracer.__init__

    def keep(self, prog):
        original(self, prog)
        seen["tracer"] = self
    monkeypatch.setattr(harness.Tracer, "__init__", keep)
    res = tiny.run(tmp_path, seed=5, seconds=1.0, trace=1)
    cell = spec.load_cell("tiny.mix", tmp_path, tmp_path / "servebench")
    tracer = seen["tracer"]
    assert tracer.tries == 2 and len(taken) == 2
    assert taken[0] >= tracer.prog.rec.window[1]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert res["device"]["busy_s"] == 0.6 and res["device"]["window_s"] == 1.0
    assert res["metrics"]["device_idle_share.rag"]["value"] == 40.0
    assert res["breakdown"]["idle_gaps"] == [["servebench.step", 0.4]]
    assert res["correct"], res["checks"]
