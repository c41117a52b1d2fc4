"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
given in ``configs``, and a traffic mix, ``traffic/<mix>.json``; the
cell's own settings (engine slots, cache length, the correctness sample
and its limit) are ``cells/<cell>.json``.  A metric's
reader is ``metrics/<metric>.py``, which defines ``read(run)``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    entry: Dict          # the ``workloads`` entry
    config: Dict         # configs/<config>.json
    traffic: Dict        # traffic/<mix>.json
    setup: Dict          # cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    setup = json.loads((bench_dir / "cells" / f"{name}.json").read_text())
    return Cell(name, entry, config, traffic, setup,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)], bench_dir)


def load_reader(metric: str, bench_dir: Path = HERE) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("servebench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
