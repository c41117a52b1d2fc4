"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, in the repository's ``build/``
directory, under a name keyed by a hash of the sources and the flags: a
library already built from the same sources is loaded as it is.  All
sources are compiled at once, one ``nvcc`` process each.  Nothing here
runs at import time; the first kernel launch of a process builds, and a
missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("flash_attention", "decode_attention", "rwkv6_scan")

_loaded: Dict[str, ctypes.CDLL] = {}

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else from ``PATH``, else the toolkit's
    usual home ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every named source not yet built, all in parallel; return
    the shared-library path of each.  Raises if any compile fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, t in todo.items():
        tmp = t.with_name(f"{t.stem}.{os.getpid()}.tmp.so")
        log = open(t.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (exit {rc}):\n{todo[n].with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported for the library now built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(name: str, symbol: str, argtypes):
    """C function ``symbol`` of the library built from ``csrc/<name>.cu``
    (built and loaded on first use), returning a ``cudaError_t`` as int."""
    if name not in _loaded:
        path = build_all((name,))[name]
        _loaded[name] = ctypes.CDLL(str(path))
    fn = getattr(_loaded[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_operand(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of
    ``dtype`` on ``device``: what the kernels' 4-wide loads assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and an input requires a gradient: the
    kernel's output would carry no autograd history, and every gradient
    upstream of it would be silently lost.  ``ops``' autograd Functions call
    the wrappers inside their forward, where grad mode is off."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} kernel has no backward: call it through kernels.ops, or under no_grad")


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with cudaError_t {err}")
