#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the weights and the traffic from the seed, warms up the cell's
shapes (set-up), serves the window, then judges what the window served
against the plain reference and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a traced run.  Exits non-zero without a result where no CUDA card
(or fewer than the cell asks for) is present, where the files it needs
are missing, or where ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` has been loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from servebench import _cli  # noqa: E402

_cli.set_path()

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """Top-level names of loaded modules (``sys.modules`` by default) that
    the run must not load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


class RunView:
    """What a metric's reader sees of one run."""

    def __init__(self, cell, prog, t_start, tracer=None):
        self.cell, self.cfg, self.rec = cell, cell.config, prog.rec
        self.slots, self.cache_len, self.t_start = prog.slots, prog.cache_len, t_start
        self.trace = tracer.reduced if tracer is not None else None
        self.stretch = tracer.used if tracer is not None else None


def run_cell(cell, seed, seconds, trace, *, device="cuda", chips=1, t_start=None,
             log=sys.stderr):
    """Serve ``cell`` once and return the result's dict (the printed line)."""
    import contextlib

    import numpy as np
    import torch
    from servebench import harness, judge, readers, spec
    from servebench.profiling import moe_ranges
    from servebench.traffic import Traffic

    prog = harness.Program(cell, seed, device=device, trace=bool(trace))
    traffic = Traffic(cell.traffic, seed, cell.config["vocab_size"])
    tracer = harness.Tracer(prog) if trace else None
    with moe_ranges() if trace else contextlib.nullcontext():
        prog.warm_up([traffic.prompt_lengths.min(), traffic.prompt_lengths.max()])
        harness.serve(prog, traffic, seconds, tracer=tracer)
    if tracer is not None and tracer.used is None:
        raise RuntimeError("every traced stretch missed kernel records")
    if device != "cpu":
        torch.cuda.synchronize()
    dev = harness.device_info(device, chips)
    dev["memory_peak_bytes"] = harness.peak_bytes(device)
    view = RunView(cell, prog, T_START if t_start is None else t_start, tracer)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.load_reader(m["name"], cell.bench_dir)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    w0, w1 = prog.rec.window
    live = [st[2] for st in prog.rec.steps if w0 <= st[0] <= w1]
    print(f"[samples] requests due in the window {len(readers.ttft_samples(view))}, "
          f"inter-token gaps {len(readers.itl_samples(view))}, "
          f"steps {len(prog.rec.steps)}, inserts {len(prog.rec.inserts)}, live slots a step "
          f"mean {np.mean(live) if live else 0:.2f} max {max(live, default=0)}, "
          f"generator late by at most {1e3 * prog.rec.late_s:.3f} ms, longest loop pause "
          f"{1e3 * prog.rec.pause[0]:.3f} ms at {prog.rec.pause[1]:.3f} s from the window's "
          f"opening", file=log)
    prog.free()
    t_judge = time.perf_counter()
    verdict = judge.judge(cell, prog, seed)
    print(f"[judge] {len(verdict['per_request_max_gap'])} requests, {verdict['tokens_compared']} "
          f"tokens in {time.perf_counter() - t_judge:.2f} s; readings "
          + json.dumps(verdict["readings"]) + "; widest gap a request "
          + " ".join(f"{g:.4g}" for g in verdict["per_request_max_gap"]), file=log)
    result = {"correct": verdict["correct"],
              "attempted": len(prog.requests), "failed": verdict["checks"]["unanswered"]["value"],
              "metrics": metrics, "device": dev}
    if trace:
        red = tracer.reduced
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        top = sorted(red["by_kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(red["idle_gaps_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from servebench import spec
    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    _cli.card_or_exit(chips)
    result = run_cell(cell, args.seed, args.seconds, args.trace, chips=chips)
    bad = forbidden_modules()      # in the process that prints, after the window
    if bad:
        print(f"servebench: loaded once the window closed: {bad}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
