#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, on the card.

    python3 servebench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 14

For each seed, in one process: the seed's weights, a window of ``--seconds``
at the cell's own load, then the widest reference gap of the served
tokens (the number ``run.py`` compares) and the control's: the plain
reference in float8 (``reference.<name>``'s ``precision="fp8"``) at the
same positions, its first choice judged by the same gap.  The limit lies
between the largest program reading and the smallest control reading
(PERF.md gives both).  ``--fault`` serves with one of ``faults.py``'s faults planted.  Prints one
JSON line a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from servebench import _cli  # noqa: E402

_cli.set_path()
from servebench import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=14.0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="serve with this fault planted under the timed path")
    args = ap.parse_args(argv)
    import torch
    from servebench import harness, judge, spec
    from servebench.traffic import Traffic
    cell = spec.load_cell(args.workload)
    _cli.card_or_exit(int(cell.entry["chips"]))
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        prog = harness.Program(cell, seed)
        traffic = Traffic(cell.traffic, seed, cell.config["vocab_size"])
        prog.warm_up([traffic.prompt_lengths.min(), traffic.prompt_lengths.max()])
        if args.fault:
            with faults.planted(args.fault):
                harness.serve(prog, traffic, args.seconds)
        else:
            harness.serve(prog, traffic, args.seconds)
        torch.cuda.synchronize()
        prog.free()
        t1 = time.perf_counter()
        verdict = judge.judge(cell, prog, seed, control=not args.no_control)
        print(json.dumps({"seed": seed, "program": verdict["readings"],
                          "control": verdict.get("control"),
                          "tokens_compared": verdict["tokens_compared"],
                          "correct": verdict["correct"], "serve_s": t1 - t0,
                          "judge_s": time.perf_counter() - t1,
                          "per_request_max_gap": verdict["per_request_max_gap"]}), flush=True)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
