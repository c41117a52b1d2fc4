"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names: every name and unit of the allowed characters, every cell's files
present, every per-layer metric a reader of its own whose ``moves`` names
an end-to-end metric that each of its cells reports; and a cell, a mix and
a metric added from new files alone."""
import json
import re

import pytest

from servebench import spec, tiny

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["servebench"] and BENCH["command"][1].startswith("servebench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = spec.load_cell(cell)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in c.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
    for key in ("slots", "cache_len", "sample_requests", "limits"):
        assert key in c.setup
    assert c.traffic["loop"] in ("open", "backlog")
    assert set(c.setup["limits"]) <= {"max_gap", "mean_gap"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_ports(name):
    from servebench.harness import program_config
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
    program_config(cfg)          # raises where the port's numbers differ from the file's


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_cell_mix_and_metric_from_new_files_only(tmp_path):
    """A later change adds these as files and a ``workloads`` entry."""
    source = ('"""first_token_ms: the first request\'s time to first token."""\n'
              "def read(run):\n"
              "    rid = min(run.rec.due)\n"
              "    return 1e3 * (run.rec.tokens[rid][0] - run.rec.due[rid])\n")
    res = tiny.run(tmp_path, extra_metric=("first_token_ms", source))
    assert res["correct"], res["checks"]
    assert res["metrics"]["first_token_ms"]["value"] > 0
    assert list(res)[-1] == "checks"
