"""A cell at ``reduced()`` size for the CPU tests, registered from files in
a temporary folder only: a configuration, a mix, a cell file and the
``metrics/`` readers, with a ``BENCHMARK.json`` whose one workload names
them, as a later change adds a cell."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

from servebench import spec

PHI = "phi3.5-moe-42b-a6.6b"
QWEN = "qwen2-72b"
# a tiny cell's limits: its f32 program reads 0 against the f32 reference
# (the CPU runs the same arithmetic); the float8 control reads a mean gap
# of 0.005-0.04 and a widest gap of 0.13-1.3 at these sizes, and a step
# that leaves its state unchanged 0.06-0.19 and 0.73-1.37
LIMITS = {"mean_gap": 0.002, "max_gap": 0.05}


def config_dict(arch=PHI, dtype="float32"):
    """A configuration file's dict of ``arch`` at ``reduced()``."""
    from repro_torch.configs import get_config
    r = get_config(arch).reduced()
    return {"name": "tiny", "arch": arch + "-smoke", "reference": "decoder",
            "num_layers": r.num_layers, "d_model": r.d_model, "num_heads": r.num_heads,
            "num_kv_heads": r.num_kv_heads, "head_dim": r.resolved_head_dim, "d_ff": r.d_ff,
            "expert_d_ff": r.expert_d_ff, "vocab_size": r.vocab_size, "num_experts": r.num_experts,
            "num_experts_per_tok": r.num_experts_per_tok,
            "moe_capacity_factor": r.moe_capacity_factor, "qkv_bias": r.qkv_bias,
            "rope_theta": r.rope_theta, "norm": r.norm, "mlp": r.mlp,
            "tie_embeddings": r.tie_embeddings, "dtype": dtype}


def make(tmp, arch=PHI, loop="open", dtype="float32", rate=20.0, limit=None, extra_metric=None):
    """(root, bench_dir) of a one-cell benchmark ``tiny.mix`` under ``tmp``;
    ``limit`` ({number: limit}) defaults to ``LIMITS``."""
    tmp = Path(tmp)
    bd = tmp / "servebench"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(spec.HERE / "metrics", bd / "metrics")
    for d in ("configs", "traffic", "cells"):
        (bd / d).mkdir(parents=True)
    cfg = config_dict(arch, dtype)
    (bd / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = {"loop": loop, "rate_per_s": rate, "block": 8,
           "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 48},
           "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16}}
    (bd / "traffic" / "mix.json").write_text(json.dumps(mix))
    cell = {"slots": 4, "cache_len": 128, "sample_requests": 6,
            "limits": LIMITS if limit is None else limit}
    (bd / "cells" / "tiny.mix.json").write_text(json.dumps(cell))
    bench = spec.load_benchmark()
    bench["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                         "file": "servebench/configs/tiny.json", "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": "tiny.mix", "config": "tiny", "traffic": "mix", "chips": 1,
                           "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    if extra_metric is not None:
        name, source = extra_metric
        (bd / "metrics" / f"{name}.py").write_text(source)
        bench["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, bd


@contextlib.contextmanager
def step_clock(tick: float = 0.002):
    """The harness's time advanced by ``tick`` s at each reading (and by
    each sleep), so that a window holds the same scheduler steps however
    loaded the CPU is."""
    from servebench import harness
    now = [0.0]

    def clock():
        now[0] += tick
        return now[0]

    def sleep(seconds):
        now[0] += max(0.0, seconds)

    saved = harness.clock, harness.sleep
    harness.clock, harness.sleep = clock, sleep
    try:
        yield
    finally:
        harness.clock, harness.sleep = saved


@contextlib.contextmanager
def short_trace():
    """A traced stretch of a few steps, as fits the tiny cell."""
    from servebench import harness
    saved = (harness.TRACE_MIN_STEPS, harness.TRACE_MIN_PREFILLS, harness.TRACE_MAX_S,
             harness.TRACE_TRIES)
    harness.TRACE_MIN_STEPS, harness.TRACE_MIN_PREFILLS, harness.TRACE_MAX_S, \
        harness.TRACE_TRIES = 3, 1, 1.0, 2
    try:
        yield
    finally:
        harness.TRACE_MIN_STEPS, harness.TRACE_MIN_PREFILLS, harness.TRACE_MAX_S, \
            harness.TRACE_TRIES = saved


def run(tmp, seed=2**31 + 11, seconds=1.5, trace=0, **kw):
    """Make the tiny cell under ``tmp`` and run it once on the CPU, on the
    step clock."""
    from servebench import run as run_mod
    root, bd = make(tmp, **kw)
    cell = spec.load_cell("tiny.mix", root, bd)
    with step_clock(), short_trace():
        return run_mod.run_cell(cell, seed, seconds, trace, device="cpu", t_start=0.0,
                                log=io.StringIO())
