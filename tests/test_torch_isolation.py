"""The port stands alone: it imports neither JAX, the JAX package nor
``ml_dtypes`` (which comes with JAX), keeps
its own copy of the configs, runs on the card by default, and builds its
kernels with nvcc or raises."""
import ast
import dataclasses
import os
import stat
from pathlib import Path

import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_architectures as jax_architectures
from repro_torch.configs import get_config, list_architectures
from repro_torch.kernels import _build
from repro_torch.serving import EngineConfig

REPO = Path(__file__).resolve().parents[1]
# the chip scripts and the card's tests run where JAX is not installed
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "chip_kernel_ab.py", REPO / "chip_decode_sweep.py",
    REPO / "chip_profile_repeat.py", REPO / "chip_scan_phases.py",
    REPO / "tests" / "test_torch_cuda.py"]
BANNED_ROOTS = ("jax", "jaxlib", "repro", "ml_dtypes")
BANNED_CALLS = {"torch.manual_seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                "torch.seed", "torch.random.manual_seed"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def test_port_files_found():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "src/repro_torch/serving/engine.py",
            "src/repro_torch/kernels/flash_attention.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree) if root in BANNED_ROOTS]
    assert not bad, f"{path}: imports {bad}"
    seeds = [n.lineno for n in ast.walk(tree)
             if isinstance(n, ast.Call) and _dotted(n.func) in BANNED_CALLS]
    assert not seeds, f"{path}: global torch RNG seeded at lines {seeds}"


def test_engine_runs_on_the_card_by_default():
    assert EngineConfig().device == "cuda"


def test_configs_are_copies_of_the_jax_configs():
    assert list_architectures() == jax_architectures()
    for name in list_architectures():
        for port, ref in ((get_config(name), jax_config(name)),
                          (get_config(name).reduced(), jax_config(name).reduced())):
            assert type(port).__module__.startswith("repro_torch.")
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
            assert port.param_counts() == ref.param_counts()


def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    for name in _build.KERNEL_SOURCES:
        text = (_build.CSRC / f"{name}.cu").read_text()
        tpu = REPO / "src" / "repro" / "kernels" / f"{name}.py"
        assert f"src/repro/kernels/{name}.py" in text
        assert "pl.pallas_call" in tpu.read_text()
        assert "bound" in text


# ---------------------------------------------------------------------------
# The build: keyed by the sources, and no fallback when nvcc fails.
# ---------------------------------------------------------------------------
def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_build_target_is_keyed_by_the_sources(sandbox):
    first = _build._target("k")
    (sandbox / "common.cuh").write_text("// header\n")
    second = _build._target("k")
    (sandbox / "k.cu").write_text("// kernel, changed\n")
    assert len({first, second, _build._target("k")}) == 3
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_build_uses_cuda_home_and_writes_the_library(sandbox, tmp_path, monkeypatch):
    # the fake nvcc writes its -o argument, as nvcc would
    home = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; echo built > "$2"')
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert _build.nvcc_path() == str(home / "bin" / "nvcc")
    path = _build.build_all(("k",))["k"]
    assert path.read_text() == "built\n"
    assert _build.build_all(("k",))["k"] == path          # built once


def test_build_failure_raises_with_the_compiler_output(sandbox, tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic"; exit 2')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build_all(("k",))
    assert not any(p.suffix == ".so" for p in _build.BUILD_DIR.iterdir())


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
