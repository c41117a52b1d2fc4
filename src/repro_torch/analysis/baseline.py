"""The checked-in baseline of deliberate exceptions.

One line per accepted finding::

    <pass_id>:<relpath>:<slug>    # why this exception is deliberate

The key matches :attr:`Finding.key` (stable across unrelated edits —
slugs name the violated contract, not a line number).  Every entry
MUST carry a justification comment: a baseline line without one is
itself an error, so exceptions cannot silently accrete.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.base import Finding

#: default baseline location, relative to the repo root
DEFAULT_BASELINE = "analysis_baseline_torch.txt"


@dataclass(frozen=True)
class BaselineEntry:
    key: str
    justification: str
    line: int


class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> Dict[str, BaselineEntry]:
    """Parse the baseline file; raises :class:`BaselineError` on an
    entry without a justification comment."""
    entries: Dict[str, BaselineEntry] = {}
    if not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, why = line.partition("#")
            key = key.strip()
            why = why.strip()
            if not sep or not why:
                raise BaselineError(
                    f"{path}:{lineno}: baseline entry {key!r} has no "
                    "justification comment (append `# why this is "
                    "deliberate`)")
            if key.count(":") < 2:
                raise BaselineError(
                    f"{path}:{lineno}: malformed key {key!r} "
                    "(want <pass_id>:<relpath>:<slug>)")
            if key in entries:
                raise BaselineError(
                    f"{path}:{lineno}: duplicate baseline entry {key!r}")
            entries[key] = BaselineEntry(key, why, lineno)
    return entries


def apply_baseline(
    findings: Sequence[Finding], entries: Dict[str, BaselineEntry],
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split findings into (new, baselined) and report stale entries
    (baseline lines matching no current finding — candidates for
    deletion)."""
    new: List[Finding] = []
    baselined: List[Finding] = []
    seen = set()
    for f in findings:
        if f.key in entries:
            baselined.append(f)
            seen.add(f.key)
        else:
            new.append(f)
    stale = [e for k, e in entries.items() if k not in seen]
    return new, baselined, stale
