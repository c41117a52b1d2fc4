"""Spans and counters inside the served path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` profile collects in this
process (PyTorch's own ``torch.autograd.profiler._is_profiler_enabled``
flag): there is no switch of its own.  Off, ``span`` returns one shared
no-op context and ``count`` returns at once, so a span site costs one flag
read.

On, ``span(name, rid=None)`` enters ``torch.profiler.record_function(name)``,
so the span is on the profiler's timeline and the kernels launched inside
it can be credited to it, and keeps a record in memory: its name, start
and end from ``time.time_ns()`` (the clock the profiler stamps its host
ranges with; the two stamps bracket the profiler's range), its parent, the
request id ``rid`` (inherited from the parent where not given) and its
counts.  ``count(name, n)`` adds ``n`` to the innermost open span's counts;
``n`` is an int or a 0-d device tensor, which is added up on the device
and turned into a number only when ``records()`` is read, so that nothing
on the hot path waits on the card.  A span may carry ``live_rows``, a
device mask over the rows of the batch it runs (``Engine.step``'s live
slots), which code under it reads with ``live_rows()``.

The records stay in memory until ``clear()``; exporting them is the
caller's job (``launch/serve.py --trace``, the benchmark's readers).
Span names never start with ``moe.`` or ``servebench.``: the benchmark
names its own profiler ranges so.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_RECORDS: List["Span"] = []
_LOCAL = threading.local()


def enabled() -> bool:
    """Whether a profiler collects in this process."""
    return _profiler._is_profiler_enabled


def _stack() -> List["Span"]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """One open or closed span; ``span`` makes it."""

    __slots__ = ("name", "rid", "parent", "start_ns", "end_ns", "counts", "live_rows", "_range")

    def __init__(self, name: str, rid: Optional[int] = None):
        self.name, self.rid, self.parent = name, rid, None
        self.start_ns = self.end_ns = 0
        self.counts: Dict[str, object] = {}
        self.live_rows: Optional[torch.Tensor] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.rid is None and self.parent is not None:
            self.rid = self.parent.rid
        self.start_ns = time.time_ns()
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        _RECORDS.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self._range.__exit__(*exc)
        self._range = self.live_rows = None
        self.end_ns = time.time_ns()
        return False


def span(name: str, rid: Optional[int] = None):
    """A context that records the span ``name`` while tracing is on."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, rid)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d device tensor) to the innermost open
    span's count ``name``; nothing where tracing is off or no span is open."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if not stack:
        return
    counts = stack[-1].counts
    counts[name] = counts[name] + n if name in counts else n


def live_rows() -> Optional[torch.Tensor]:
    """The innermost open span's ``live_rows`` mask, looking outwards; None
    where no open span carries one (every row is live)."""
    for sp in reversed(_stack()):
        if sp.live_rows is not None:
            return sp.live_rows
    return None


def records() -> List[Dict]:
    """Every closed span in the order they opened: ``id`` (its index),
    ``parent`` (the parent's id or None), ``name``, ``rid``,
    ``start_ns``/``end_ns`` (``time.time_ns()``) and ``counts``
    (numbers: device counts are read here)."""
    spans = [sp for sp in _RECORDS if sp.end_ns]
    ids = {id(sp): i for i, sp in enumerate(spans)}
    for sp in spans:
        sp.counts = {k: int(v) for k, v in sp.counts.items()}
    return [{"id": i, "parent": ids.get(id(sp.parent)), "name": sp.name, "rid": sp.rid,
             "start_ns": sp.start_ns, "end_ns": sp.end_ns, "counts": dict(sp.counts)}
            for i, sp in enumerate(spans)]


def summary(recs: List[Dict]) -> Dict[str, Dict]:
    """By span name: ``n``, ``total_ms``, ``self_ms`` (less the time of its
    child spans) and each count's total, of ``records()``."""
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r["parent"] is not None:
            child_ns[r["parent"]] = child_ns.get(r["parent"], 0) + r["end_ns"] - r["start_ns"]
    out: Dict[str, Dict] = {}
    for r in recs:
        s = out.setdefault(r["name"], {"n": 0, "total_ms": 0.0, "self_ms": 0.0, "counts": {}})
        ns = r["end_ns"] - r["start_ns"]
        s["n"] += 1
        s["total_ms"] += ns / 1e6
        s["self_ms"] += (ns - child_ns.get(r["id"], 0)) / 1e6
        for k, v in r["counts"].items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return out


def clear() -> None:
    """Forget every record (open spans stay open, unrecorded)."""
    _RECORDS.clear()
