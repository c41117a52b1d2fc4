#!/usr/bin/env python3
"""The knee of an open-loop cell, by a sweep of arrival rates on the card.

    python3 servebench/sweep.py --workload phi-moe.rag --seed <n> --seconds 30 --rates 4,5,6,7,8

One process, one set of weights; each rate, from the lowest, serves a
window of its own from a fresh cache, after the mix's lead-in at that
rate, and the sweep stops after two rates in a row that are not steady.
A rate is steady where the requests due in the window's last third wait
(due time to the start of their insert) no longer on average than those
due in its first third, within 10% and 5 ms of slack for the host clock;
the knee is the highest rate below the first that is not.
Prints one JSON line a rate and the knee.  Run it on several seeds: the
knee moves with the seed's bursts and with the host.
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
SLACK_RATIO, SLACK_S = 1.10, 0.005


def thirds(rec, seconds):
    """Mean wait of the requests due in the first and in the last third."""
    start = {rid: t0 for rid, t0, _, _ in rec.inserts}
    w0 = rec.window[0]
    first, last = [], []
    for rid, due in rec.due.items():
        if rid not in start or not w0 <= due < w0 + seconds:
            continue
        part = (due - w0) / seconds
        if part < 1 / 3:
            first.append(start[rid] - due)
        elif part >= 2 / 3:
            last.append(start[rid] - due)
    mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")  # noqa: E731
    return mean(first), mean(last)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from servebench import harness, readers, spec
    from servebench.run import RunView
    from servebench.traffic import Traffic
    cell = spec.load_cell(args.workload)
    _cli.card_or_exit(int(cell.entry["chips"]))
    prog = harness.Program(cell, args.seed)
    traffic = Traffic(cell.traffic, args.seed, cell.config["vocab_size"])
    prog.warm_up([traffic.prompt_lengths.min(), traffic.prompt_lengths.max()])
    knee, unsteady, below = None, 0, True
    for rate in sorted(float(r) for r in args.rates.split(",")):
        if unsteady == 2:
            break
        prog.reset()
        rec = harness.serve(prog, traffic, args.seconds, rate=rate)
        view = RunView(cell, prog, T_START)
        first, last = thirds(rec, args.seconds)
        steady = last <= SLACK_RATIO * first + SLACK_S
        unsteady = 0 if steady else unsteady + 1
        below = below and steady
        if below:
            knee = rate
        print(json.dumps({"rate_per_s": rate, "wait_first_third_ms": 1e3 * first,
                          "wait_last_third_ms": 1e3 * last, "steady": steady,
                          "due": len(readers.ttft_samples(view)),
                          "ttft_p95_ms": readers.ttft_p95_ms(view),
                          "itl_p95_ms": readers.itl_p95_ms(view),
                          "output_tokens_per_s": readers.output_tokens_per_s(view),
                          "decode_step_ms": readers.decode_step_ms(view),
                          "queue_wait_p95_ms": readers.queue_wait_p95_ms(view),
                          "late_ms": 1e3 * rec.late_s, "longest_pause_ms": 1e3 * rec.pause[0]}),
              flush=True)
    print(json.dumps({"knee_per_s": knee, "rate_at_0.8_knee": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
