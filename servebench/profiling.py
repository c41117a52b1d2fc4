"""The traced stretch: ``torch.profiler`` over a bounded run of the
window's scheduler steps, and its reduction to device time.

A stretch opens with PAD_LAUNCHES device sleeps, on which the profiler's
lost prefix of kernel records falls (a profile loses the records of up to
~31 of its first launches, never of a later one), then a
``servebench.stretch`` range around the steps it traces.  Its kernel
records are held to the port's launch counters and every kernel launch
traced inside the range to a device record of the same correlation id: a
stretch that misses one is taken again, so that a traced number never
silently loses records.  Host activity is named by ``record_function``
ranges that the harness puts around the port's calls from outside
(``servebench.*``, and ``moe.*`` around ``models/moe.py``'s functions).
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List

import torch

from servebench.stats import gaps_between, union_length

PAD_LAUNCHES = 256
PAD_CYCLES = 200_000
STRETCH = "servebench.stretch"
FLASH_KERNEL = "fa_wgmma_kernel"
DECODE_KERNEL = "da_cluster_kernel"
MOE_RANGES = {"moe.layer": "moe_sort_local", "moe.route": "_route", "moe.experts": "_expert_ffn"}


def in_range(label, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def moe_ranges():
    """``models/moe.py``'s functions inside profiler ranges: the module
    looks them up at each call, so replacing the attribute is enough."""
    from repro_torch.models import moe as moe_lib
    originals = {name: getattr(moe_lib, name) for name in MOE_RANGES.values()}
    for label, name in MOE_RANGES.items():
        setattr(moe_lib, name, in_range(label, originals[name]))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(moe_lib, name, fn)


def start():
    """A running profiler whose lost prefix of records has fallen on the
    pad; the caller opens the ``servebench.stretch`` range next."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()
    return prof


def _spans(events, names) -> Dict[str, Dict[int, List]]:
    cpu = torch.autograd.DeviceType.CPU
    out: Dict[str, Dict[int, List]] = {}
    for e in events:
        if e.device_type() == cpu and e.is_user_annotation() and names(e.name()):
            out.setdefault(e.name(), {}).setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for per_thread in out.values():
        for sp in per_thread.values():
            sp.sort()
    return out


def _inside(spans_of_thread, t) -> bool:
    i = bisect.bisect_right(spans_of_thread, (t, float("inf"))) - 1
    return i >= 0 and t <= spans_of_thread[i][1]


def reduce(prof, flash_launches: int, decode_launches: int) -> Dict:
    """Device time of the stretch: busy and window seconds, time by kernel,
    the flash and decode kernels' records and time, the device time of the
    kernels launched inside each ``moe.*`` range, the idle gaps by the
    innermost host range open at their start, and ``missed`` (records
    that fall short of the counters or of the traced launches)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    marks = [e for e in events if e.device_type() == cpu and e.is_user_annotation()
             and e.name() == STRETCH]
    if len(marks) != 1:
        return {"missed": f"{len(marks)} stretch ranges"}
    s0 = marks[0].start_ns()
    s1 = s0 + marks[0].duration_ns()
    main = marks[0].start_thread_id()
    dev, by_corr, by_name = [], {}, {}
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        by_corr[e.correlation_id()] = by_corr.get(e.correlation_id(), 0) + (b - a)
        if b <= s0 or a >= s1:
            continue
        dev.append((max(a, s0), min(b, s1)))
        by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
    counts = {k: sum(1 for e in events if e.device_type() == cuda and not e.is_user_annotation()
                     and k in e.name() and s0 <= e.start_ns() < s1)
              for k in (FLASH_KERNEL, DECODE_KERNEL)}
    launches = [e for e in events if e.device_type() == cpu and "LaunchKernel" in e.name()
                and s0 <= e.start_ns() <= s1]
    unrecorded = sum(1 for e in launches if e.correlation_id() not in by_corr)
    missed = []
    if counts[FLASH_KERNEL] != flash_launches:
        missed.append(f"{counts[FLASH_KERNEL]} flash records for {flash_launches} launches")
    if counts[DECODE_KERNEL] != decode_launches:
        missed.append(f"{counts[DECODE_KERNEL]} decode records for {decode_launches} launches")
    if unrecorded:
        missed.append(f"{unrecorded} of {len(launches)} traced launches without a record")
    spans = _spans(events, lambda n: n.startswith("moe.") or n.startswith("servebench."))
    moe_ns = {label: 0 for label in MOE_RANGES}
    for e in events:
        if e.device_type() != cpu or not e.name().startswith("cu") or e.correlation_id() not in by_corr:
            continue
        if not s0 <= e.start_ns() <= s1:
            continue
        for label in MOE_RANGES:
            if _inside(spans.get(label, {}).get(e.start_thread_id(), []), e.start_ns()):
                moe_ns[label] += by_corr[e.correlation_id()]
    gaps: Dict[str, float] = {}
    for a, b in gaps_between(dev, s0, s1):
        open_ranges = [(sp[0], name) for name, per_thread in spans.items() if name != STRETCH
                       for sp in per_thread.get(main, []) if sp[0] <= a <= sp[1]]
        name = max(open_ranges)[1] if open_ranges else "harness between calls"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    return {
        "missed": "; ".join(missed),
        "window_s": (s1 - s0) / 1e9,
        "busy_s": union_length(dev) / 1e9,
        "by_kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "flash_records": counts[FLASH_KERNEL], "decode_records": counts[DECODE_KERNEL],
        "flash_s": sum(v for k, v in by_name.items() if FLASH_KERNEL in k) / 1e9,
        "decode_s": sum(v for k, v in by_name.items() if DECODE_KERNEL in k) / 1e9,
        "moe_s": {k: v / 1e9 for k, v in moe_ns.items()},
        "idle_gaps_s": gaps,
    }
