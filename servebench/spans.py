"""Per-layer metrics read from the program's own spans and counters
(``repro_torch.tracing``) in the traced stretch.

The program records its spans while a profiler collects, stamped with
``time.time_ns()``, the clock of the profiler's host ranges.  A reader keeps
the spans that lie inside the used stretch's ``servebench.stretch`` range
and takes that range, and the device records, from the stretch's profiler
(``run.stretch.prof``).  Where the program records no spans (a tree
without the tracer) or the run has no traced stretch, a reader returns
None and the harness leaves the metric out.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from servebench.profiling import STRETCH
from servebench.stats import gaps_between

# spans whose host time is the enqueue of work on the card
ENQUEUE = ("engine.step.launch", "engine.insert.cache", "engine.insert.prefill",
           "engine.insert.scatter")
# spans inside the model, counted as enqueue where an ENQUEUE span holds them
MODEL_PREFIXES = ("attention.", "moe_layer")


def _program_records() -> Optional[List[Dict]]:
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def _events(prof):
    profiler = getattr(prof, "profiler", None)
    results = getattr(profiler, "kineto_results", None)
    return results.events() if results is not None else []


def stretch_of(prof) -> Optional[Tuple[int, int, List[Tuple[int, int]]]]:
    """(start ns, end ns, device intervals clipped to it) of the profile's
    one ``servebench.stretch`` range, as ``profiling.reduce`` takes them;
    None where the profile holds no such range."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = _events(prof)
    marks = [e for e in events if e.device_type() == cpu and e.is_user_annotation()
             and e.name() == STRETCH]
    if len(marks) != 1:
        return None
    s0 = marks[0].start_ns()
    s1 = s0 + marks[0].duration_ns()
    dev = []
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if a < s1 and b > s0:
            dev.append((max(a, s0), min(b, s1)))
    return s0, s1, dev


def traced(run):
    """(spans inside the stretch, by id, device intervals, (s0, s1)) of the
    run, worked out once; None where there is nothing to read."""
    if "_program_spans" not in run.__dict__:
        run._program_spans = _traced(run)
    return run._program_spans


def _traced(run):
    if run.stretch is None:
        return None
    recs = _program_records()
    st = stretch_of(run.stretch.prof)
    if not recs or st is None:
        return None
    s0, s1, dev = st
    spans = [r for r in recs if s0 <= r["start_ns"] and r["end_ns"] <= s1]
    if not spans:
        return None
    return spans, {r["id"]: r for r in recs}, dev, (s0, s1)


def _named(run, name):
    t = traced(run)
    return [] if t is None else [r for r in t[0] if r["name"] == name]


def _mean_ms(run, name) -> Optional[float]:
    spans = _named(run, name)
    return 1e-6 * sum(r["end_ns"] - r["start_ns"] for r in spans) / len(spans) if spans else None


def step_launch_ms(run) -> Optional[float]:
    """Mean ``engine.step.launch``: the token upload and the enqueue of a
    decode step."""
    return _mean_ms(run, "engine.step.launch")


def step_wait_ms(run) -> Optional[float]:
    """Mean ``engine.step.wait``: the host waiting on the step's argmax."""
    return _mean_ms(run, "engine.step.wait")


def insert_cache_ms(run) -> Optional[float]:
    """Mean ``engine.insert.cache``: the fresh one-sequence cache."""
    return _mean_ms(run, "engine.insert.cache")


def live_slot_pct(run) -> Optional[float]:
    """Live slots over decoded slots, summed over the stretch's steps."""
    steps = _named(run, "engine.step")
    slots = sum(r["counts"].get("slots", 0) for r in steps)
    return 100.0 * sum(r["counts"].get("live", 0) for r in steps) / slots if slots else None


def _under(rec, by_id, name) -> bool:
    p = rec["parent"]
    while p is not None:
        if by_id[p]["name"] == name:
            return True
        p = by_id[p]["parent"]
    return False


def _drop_pct(run, phase) -> Optional[float]:
    t = traced(run)
    if t is None:
        return None
    routes = [r for r in t[0] if r["name"] == "moe_layer.route" and _under(r, t[1], phase)]
    assigned = sum(r["counts"].get("assigned", 0) for r in routes)
    dropped = sum(r["counts"].get("dropped", 0) for r in routes)
    return 100.0 * dropped / assigned if assigned else None


def moe_prefill_drop_pct(run) -> Optional[float]:
    """Dropped over assigned MoE assignments of the prompts' tokens."""
    return _drop_pct(run, "engine.insert")


def moe_decode_drop_pct(run) -> Optional[float]:
    """The same over the live slots' tokens of the decode steps."""
    return _drop_pct(run, "engine.step")


def _is_enqueue(rec, by_id) -> bool:
    if rec["name"] in ENQUEUE:
        return True
    if not rec["name"].startswith(MODEL_PREFIXES):
        return False
    return any(_under(rec, by_id, name) for name in ENQUEUE)


def idle_by_span(spans: List[Dict], dev: List[Tuple[int, int]], s0: int,
                 s1: int) -> Dict[Optional[int], float]:
    """Device-idle seconds of [s0, s1) (the gaps between ``dev``) by the id
    of the innermost span open at each gap's start (None: no span open).
    The spans nest, as those of the one thread that serves do."""
    order = sorted(spans, key=lambda r: (r["start_ns"], -r["end_ns"]))
    out: Dict[Optional[int], float] = {}
    stack: List[Dict] = []
    i = 0
    for a, b in gaps_between(dev, s0, s1):
        while i < len(order) and order[i]["start_ns"] <= a:
            while stack and stack[-1]["end_ns"] < order[i]["start_ns"]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1]["end_ns"] < a:
            stack.pop()
        key = stack[-1]["id"] if stack else None
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return out


def idle_in_launch_pct(run) -> Optional[float]:
    """The share of the stretch's device-idle time that starts while the
    host's innermost open span is an enqueue span (``ENQUEUE``, or an
    attention or MoE span inside one)."""
    t = traced(run)
    if t is None or not t[2]:
        return None
    spans, by_id, dev, (s0, s1) = t
    idle = idle_by_span(spans, dev, s0, s1)
    total = sum(idle.values())
    if not total:
        return 0.0
    return 100.0 * sum(v for k, v in idle.items()
                       if k is not None and _is_enqueue(by_id[k], by_id)) / total
