#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases, each raising on a failed check (the script then exits non-zero and
never prints its last line):

1. build the three hand-written CUDA kernel libraries from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` each, in parallel; print
   each kernel instantiation's registers and spill bytes (``ptxas -v``),
   the attention libraries' hd-256 ones among them, and count the
   tensor-core instructions (``HMMA``) in each library's SASS
   (``cuobjdump -sass``); the bf16 flash kernel and the bf16 RWKV-6
   prefill must have some;
2. hold each kernel against its plain PyTorch version on the card, in f32
   and bf16: the attention kernels at the shapes of ``tests/test_kernels.py``,
   at the main path's shapes, at phi3.5-moe's and llama3-8b's GQA shapes
   (32 q heads over 8 kv heads, hd 128), at recurrentgemma-9b's (16 q
   heads over 1 kv head, hd 256: flash at S = 512 and at S = 2112 under its
   2048-token window, decode over the 8-slot, 2048-slot ring with the main
   path's prefix masks and with a wrapped ring whose window excludes the
   oldest slots) and at whisper-small's (12 heads of 64, non-causal flash
   at B = 8 over 1500 keys with Sq = 1500, 4 and 1, decode over a 448-slot
   cache); the RWKV-6 scan at ``RWKV_CASES``
   (with and without a state, ragged T), under strong
   decay (also in bf16 at T = 100), at T = 1 with a state, at T = 2048, with
   the state updated in place at T = 45 and T = 1, and at rwkv6-1.6b's
   prefill and decode shapes; the attention kernels' edge cases (rows that
   see no key, S = 1000 in bf16, a window with a q_offset, decode masks that
   leave whole tiles and whole splits empty in the middle of the cache),
   and the bf16 flash kernel within one bf16 step of the f32 attention of
   its inputs, as the TPU kernel rounds, at outputs of |o| up to ~27 and at
   whisper-small's three flash shapes, and the bf16 decode kernel the same
   at outputs of |o| up to ~24 (hd 64 at 16:4 heads, hd 256 at 16:1).
   Time kernel, plain version, one PyTorch call for the same function where
   there is one (SDPA, a yardstick the port never calls) and the card's
   bound, at the main path's shapes (and the attention kernels also at
   phi3.5-moe's, llama3-8b's, recurrentgemma-9b's and whisper-small's
   (its encoder and its cross-attention of a decode step in the flash row),
   under those names in each attention row), and print them on one ``{"kernels": ...}``
   line; for the scan also the device time of each of its kernels, and a
   copy of the decode state as the floor of its decode step;
3. serve qwen1.5-0.5b at full width and depth in bf16 through
   ``ContinuousBatcher`` (16 requests, 8 slots, cache 2048, 32 new tokens
   each), with the kernels' launch counters proving every prefill and
   decode attention call went through them; profile 8 decode steps (device
   time against the step's host time) and one 512-token prefill (device
   time, flash attention's share); then hold f32 logits of one prompt
   (prefill + 8 decode steps) on the card against the same port code on
   the CPU;
3b. the same for rwkv6-1.6b at full width and depth in bf16 (same traffic),
   every WKV recurrence of every layer through the scan kernels; profile 8
   decode steps and one 512-token prefill (the scan's device time and
   share); then its f32 check at full width and 4 layers;
3c. the same for phi3.5-moe-42b-a6.6b at full width and 16 of its 32
   layers in bf16 (same traffic; 42.1 GB of weights: all 32 layers, 83.7
   GB, do not fit one 80 GB card), every attention call through the two
   attention kernels and every MoE layer through the port's sort-based
   capacity dispatch (PyTorch ops and cuBLAS batched products); check that
   the MoE layer never waits on the host (sync debug mode "error"); profile
   8 decode steps and one 512-token prefill (the expert products', the
   routing's and the dispatch and combine's device time, from profiler
   ranges, and the attention kernels' share); then its f32 check at full
   width and 2 layers, which also holds the experts chosen on the card to
   those chosen on the CPU;
3d. the same for recurrentgemma-9b at full width and all 38 layers in bf16
   (same traffic; 26 RG-LRU blocks, whose log-depth scan is PyTorch ops, and
   12 local-attention blocks, every one of whose calls goes through the two
   attention kernels at hd 256, 16 q heads over 1 kv head); profile 8 decode
   steps and one 512-token prefill (the attention kernels' share); then its
   f32 check at full width and 5 layers, one (RG-LRU, RG-LRU, local
   attention) pattern and the (RG-LRU, RG-LRU) tail, on a 2112-token prompt
   that wraps the 2048-slot ring in prefill and under the window;
3e. whisper-small at full width and depth in bf16 (12 encoder and 12
   decoder layers), served at the model's entry points as the JAX package
   serves it (its engine takes no audio): 2 batches of 8 requests, each
   1500 frames of the seeded audio stub and a 4-token prompt, prefilled
   together (``prefill(enc_inputs=)``, which stores the cross-attention K/V)
   and decoded 32 greedy steps in a 448-slot cache; the launch counters
   prove that every encoder, self- and cross-attention call went through
   the flash kernel (cross-attention at Sq = 1 in each step) and every
   decode self-attention call through the decode kernel; profile one batch
   prefill and 8 decode steps (the flash kernel's time split into encoder,
   self and cross by pairing its kernels, in start order, with the kinds of
   the calls: ``flash_split``), print the floors of both from the
   shapes, then the f32 check at full depth on one request;
4. the control plane: the batched float64 tick engine
   (``core/sim/torch_engine.py``) at the JAX package's benchmark shapes
   (``benchmarks/sim_throughput.py``): ``run_scenario`` over a fleet of
   1024 archs and 3600 ticks under ``portfolio`` and ``rl_pool``, and
   ``run_grid`` over 64 cells (4 scenarios x 16 seeds) of 16 archs under
   ``portfolio``; every fleet run and 8 sampled grid cells held to the
   port's NumPy engine (raw ledger and per-arch flows at 1e-6, equal
   summary keys), and each sampled cell of the grid run again over its
   first 600 ticks equal to ``run_scenario`` of that cell over them;
   the tick loop runs under ``torch.cuda.set_sync_debug_mode("error")``
   (a sync raises; the phase first shows the guard catching one); prints
   ticks/s, arch- and cell-ticks/s beside the NumPy engine's on the same
   runs, the device's busy share and kernels a tick over 100 profiled
   ticks, peak memory and the largest relative ledger error;
5. print the device line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sim as core_sim  # noqa: E402
from repro_torch.core.rl.policy import RLPoolPolicy  # noqa: E402
from repro_torch.core.schedulers import VECTOR_SCHEDULERS  # noqa: E402
from repro_torch.core.sim import torch_engine  # noqa: E402
from repro_torch.core.workloads import SCENARIO_ZOO  # noqa: E402
from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RWKV  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.rwkv import F32_LEAVES  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request  # noqa: E402

# tolerances of tests/test_kernels.py
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# f32 logits, card (kernels, cuBLAS without TF32) vs CPU (plain versions):
# the same f32 arithmetic summed in another order; relative rounding of
# ~1e-6 per product through 24 residual layers stays near 1e-5 on logits
# of size ~1-10, so 1e-3 leaves two orders of margin and still catches a
# kernel that drops or misweights a single key (errors of order 1e-1).
LOGIT_TOL = 1e-3
# H100 SXM datasheet peaks: dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# b, sq, sk, nq, nkv, hd, causal, window  (tests/test_kernels.py FA_CASES)
FA_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 128, 128, 8, 8, 64, True, 16),
    (2, 48, 48, 4, 1, 32, True, 0),
    (1, 64, 64, 2, 2, 16, False, 0),
    (1, 96, 96, 6, 3, 64, True, 32),
]
# b, s, nq, nkv, hd  (tests/test_kernels.py DA_CASES)
DA_CASES = [
    (2, 64, 4, 2, 32),
    (1, 100, 8, 1, 64),
    (3, 48, 2, 2, 16),
    (1, 256, 16, 4, 64),
]

# b, t, h, hd, with_state  (tests/test_kernels.py RWKV_CASES, then one decode step)
RWKV_CASES = [
    (2, 64, 2, 32, False),
    (1, 50, 4, 64, True),
    (2, 33, 1, 16, True),
    (1, 128, 2, 64, True),
    (8, 1, 4, 64, True),
]
# tolerances of tests/test_kernels.py for the scan: its chunked form sums
# decays as log-space prefixes where the plain version multiplies them
RWKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

ARCH = "qwen1.5-0.5b"
RWKV_ARCH = "rwkv6-1.6b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# phi3.5-moe on one card: 1,300,307,968 parameters a layer (attention
# 41.9 M, 16 experts 1258.3 M, router, norms) and two 131.3 M embedding
# tables; 32 layers are 83.7 GB in bf16, more than the card's 80 GB, so
# the slice runs 16 (42.1 GB), and its f32 check 2 (11.5 GB, on the card
# and again on the host)
MOE_LAYERS, MOE_F32_LAYERS, MOE_F32_PROMPT = 16, 2, 64
MOE_DEPTH_CUT = ("16 of 32 layers at full width: 32 layers are 83.7 GB of bf16 weights, "
                 "more than one 80 GB card holds")
RG_ARCH = "recurrentgemma-9b"
# its f32 check: one (RG-LRU, RG-LRU, local attention) pattern and the tail,
# on a prompt longer than the 2048-token window and ring
RG_F32_LAYERS, RG_F32_PROMPT = 5, 2112
# a decode mask over a ring that has wrapped, under a window shorter than
# the ring (positions written per sequence, ring slots, window)
RING_POSITIONS, RING_WINDOW = [2100, 4095, 3000, 2047, 100, 5000, 2048, 10], 1536
WHISPER_ARCH = "whisper-small"
WHISPER_FRAMES = frontends.WHISPER_FRAMES
# whisper-small's traffic: WHISPER_BATCHES batches of SLOTS requests, each
# with 1500 frames of the seeded audio stub and a 4-token decoder prompt
# (the start-of-transcript prefix: start, language, task, no timestamps),
# NEW_TOKENS greedy tokens after the prefill's, in a cache of 448 slots (the
# decoder's context)
WHISPER_BATCHES, WHISPER_PROMPT, WHISPER_CACHE = 2, 4, 448
KERNELS = {"flash_attention": fa, "decode_attention": da, "rwkv6_scan": rk}
N_REQUESTS, SLOTS, CACHE_LEN, NEW_TOKENS = 16, 8, 2048, 32
PROMPT_MIN, PROMPT_MAX = 64, 512
F32_DECODE_STEPS = 8
# the f32 check of the RWKV path: full width, 4 of its 24 layers (the CPU
# runs the same model with the plain versions), and a prompt of two whole
# 32-token chunks and a ragged tail
RWKV_F32_LAYERS, RWKV_F32_PROMPT = 4, 77
# rwkv6-1.6b's main-path scan shapes: prefill (B=1, a ragged T) and decode (8 slots)
RWKV_PREFILL, RWKV_DECODE = (1, 500, 32, 64, True), (SLOTS, 1, 32, 64, True)
# 64 chunks carried through the prefill's scratch; the state updated in place
# over two chunks and a ragged tail, and in one decode step
RWKV_LONG, RWKV_IN_PLACE = (1, 2048, 4, 64, True), ((2, 45, 4, 64, True), (8, 1, 4, 64, True))
# each slice's own kernels in a profile, by name: flash attention's and
# decode attention's, and every kernel of the rwkv6_scan library, all of
# which live in its namespace rwkv6
PROFILED = {
    ARCH: {"prefill": ("flash_attention", ("fa_mma_kernel", "fa_kernel")),
           "decode": ("decode_attention", ("da_split_kernel", "da_combine_kernel"))},
    RWKV_ARCH: {"prefill": ("rwkv6_scan", ("rwkv6::",)), "decode": ("rwkv6_scan", ("rwkv6::",))},
    MOE_ARCH: {"prefill": ("flash_attention", ("fa_mma_kernel", "fa_kernel")),
               "decode": ("decode_attention", ("da_split_kernel", "da_combine_kernel"))},
    RG_ARCH: {"prefill": ("flash_attention", ("fa_mma_wide_kernel", "fa_kernel")),
              "decode": ("decode_attention", ("da_split_kernel", "da_combine_kernel"))},
}
# the MoE layer's parts, each run inside a profiler range of this name:
# the whole layer, its routing (router product, top-k, softmax, aux) and
# the expert products (three batched cuBLAS products and the SwiGLU);
# dispatch and combine are the layer's time less the other two
MOE_RANGES = {"layer": "moe_sort_local", "route": "_route", "experts": "_expert_ffn"}


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    if not err < tol:
        raise AssertionError(f"{name}: max abs err {err} >= {tol}")


class L2Flush:
    """Writes a buffer larger than the 50 MB L2 so each timed call starts
    cold, as a layer's call does on the main path."""

    def __init__(self, device):
        self.buf = torch.empty(64 * 2**20, dtype=torch.int32, device=device)

    def __call__(self):
        self.buf.zero_()


# ~0.1 ms of device work queued after each flush, so that the host has
# enqueued the start event, the call and the end event before the device
# reaches them: the events then time the device, not the host's dispatch
HOST_AHEAD_CYCLES = 200_000


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median device time of ``fn`` from CUDA events, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 1: build.
# ---------------------------------------------------------------------------
def hmma_count(path) -> int:
    """Tensor-core (HMMA) instructions in a built library's SASS, read with
    the ``cuobjdump`` of the toolkit that built it."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def ptxas_report(log: str):
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from ``ptxas -v``'s lines: "Compiling entry function '<k>'", then
    "Function properties for <k>" with its spill bytes, then "Used N
    registers"."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def kernel_names(mangled):
    """{mangled: "name<template args>"} by ``c++filt`` (the mangled name where
    it is missing), without the return type, namespaces and parameters."""
    filt = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True, text=True,
                          timeout=60)
    lines = filt.stdout.splitlines() if filt.returncode == 0 else []
    if len(lines) != len(mangled):
        return {n: n for n in mangled}
    short = lambda d: d.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    return {n: short(d) for n, d in zip(mangled, lines)}


def phase_build() -> str:
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.1f} s: " + ", ".join(f"{n} -> {p.name}" for n, p in paths.items()))
    for name in paths:
        report = ptxas_report(_build.build_log(name))
        readable = kernel_names(list(report))
        for k, (regs, st, ld) in report.items():
            print(f"[build] {name}: {readable[k]}: {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads")
        wide = {readable[k]: v for k, v in report.items() if "Li256E" in k}
        if name in ("flash_attention", "decode_attention"):
            if not wide:
                raise AssertionError(f"the {name} library has no hd-256 instantiation")
            print(f"[build] {name} hd 256: " + json.dumps(
                {k: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
                 for k, (r, st, ld) in wide.items()}))
    for name in paths:
        n = hmma_count(paths[name])
        print(f"[build] {name}: {n} HMMA instructions in its SASS")
        if name in ("flash_attention", "rwkv6_scan") and n == 0:
            raise AssertionError(f"the {name} library has no tensor-core instruction")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(gpu)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return gpu


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------
def check_flash(gen, b, sq, sk, nq, nkv, hd, causal, window, dtype, q_offset=0):
    q = randn(gen, (b, sq, nq, hd), dtype)
    k = randn(gen, (b, sk, nkv, hd), dtype)
    v = randn(gen, (b, sk, nkv, hd), dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if out.shape != exp.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention: {out.shape} {out.dtype} vs {exp.shape} {dtype}")
    err = max_err(out, exp)
    check(f"flash_attention {(b, sq, sk, nq, nkv, hd, causal, window, q_offset)} {dtype}",
          err, TOL[dtype])
    return err, (q, k, v)


def prefix_valid(lengths, s, device):
    lengths = torch.as_tensor(lengths, device=device)
    return torch.arange(s, device=device)[None, :] < lengths[:, None]


def check_decode(gen, b, s, nq, nkv, hd, dtype, valid=None):
    q = randn(gen, (b, nq, hd), dtype)
    k = randn(gen, (b, s, nkv, hd), dtype)
    v = randn(gen, (b, s, nkv, hd), dtype)
    if valid is None:
        valid = torch.rand((b, s), generator=gen, device=gen.device) < 0.7
        valid[:, 0] = True                       # at least one visible slot
    out = da.decode_attention(q, k, v, valid)
    exp = ref.decode_attention_reference(q, k, v, valid)
    # a sequence with no valid slot gives 0 (the plain version, like the
    # JAX oracle, spreads the softmax uniformly over masked slots instead)
    empty = ~valid.any(dim=1)
    exp = torch.where(empty[:, None, None], torch.zeros_like(exp), exp)
    err = max_err(out, exp)
    check(f"decode_attention {(b, s, nq, nkv, hd)} {dtype}", err, TOL[dtype])
    return err, (q, k, v, valid)


def check_attention_edges(gen, dtype) -> int:
    """The attention kernels' edge cases; returns the number of checks."""
    dev = gen.device
    # flash: a ragged 1000-token prompt (GQA, hd 128 and 64), a window with a
    # q_offset, and rows whose window lies past Sk, which give 0
    check_flash(gen, 1, 1000, 1000, 8, 2, 128, True, 0, dtype)
    check_flash(gen, 2, 1000, 1000, 4, 4, 64, False, 0, dtype)
    check_flash(gen, 1, 300, 337, 4, 4, 64, True, 48, dtype, q_offset=37)
    # the same over a grid of 1024 CTAs (several waves on the card)
    check_flash(gen, 4, 1000, 1037, 16, 4, 64, True, 48, dtype, q_offset=37)
    q, k, v = (randn(gen, (1, n, 4, 64), dtype) for n in (100, 64, 64))
    out = fa.flash_attention(q, k, v, causal=True, window=8, q_offset=50)
    seen = 64 + 8 - 1 - 50                       # rows [0, seen) see a key
    if bool(out[:, seen:].any()):
        raise AssertionError(f"flash_attention {dtype}: a row that sees no key is not 0")
    exp = ref.mha_reference(q, k, v, causal=True, window=8, q_offset=50)
    check(f"flash_attention window past Sk {dtype}", max_err(out[:, :seen], exp[:, :seen]),
          TOL[dtype])
    # recurrentgemma-9b's local attention (hd 256, 16 q heads over 1 kv
    # head): a prompt longer than its 2048-token window, so the window bites
    check_flash(gen, 1, RG_F32_PROMPT, RG_F32_PROMPT, 16, 1, 256, True, 2048, dtype)
    # and its decode over a 2048-slot ring that has wrapped, under a window
    # that excludes the oldest slots
    check_decode(gen, SLOTS, CACHE_LEN, 16, 1, 256, dtype,
                 ring_valid(RING_POSITIONS, CACHE_LEN, RING_WINDOW, dev))
    # decode: whole 64-slot tiles and whole splits empty in the middle of a
    # 2048-slot cache, a sequence valid only at its last slot, one with none
    valid = torch.zeros((4, 2048), dtype=torch.bool, device=dev)
    valid[0, :70] = True
    valid[0, -100:] = True
    valid[1, ::97] = True
    valid[2, -1] = True
    _, (q, k, v, valid) = check_decode(gen, 4, 2048, 8, 2, 64, dtype, valid)
    if da.split_plan(4, 2, 2048, torch.cuda.get_device_properties(dev).multi_processor_count)[0] < 3:
        raise AssertionError("decode_attention edge case: expected the cache split in 3 or more")
    out = da.decode_attention(q, k, v, valid)
    if bool(out[3].any()):
        raise AssertionError("decode_attention: a sequence with no valid slot is not 0")
    check("decode_attention single valid slot in the last split",
          max_err(out[2], v[2, -1].repeat_interleave(4, dim=0)), TOL[dtype])
    return 8


def check_one_step(name, qkv, causal) -> float:
    """The bf16 flash kernel on ``qkv`` held to the f32 attention o32 of the
    same bf16 inputs within one bf16 step of o32 (at least 2e-2,
    ``ref.bf16_step``), what the TPU kernel meets by rounding its f32 result
    once; returns the largest error in steps."""
    q, k, v = qkv
    steps = float(ref.bf16_steps_from_f32(fa.flash_attention(q, k, v, causal=causal),
                                          q, k, v, causal=causal).max())
    if not steps <= 1.0:
        raise AssertionError(f"flash_attention bf16 {name}: {steps} bf16 steps from the f32 "
                             "attention of its inputs")
    return steps


def check_flash_rounding(dev):
    """bf16 outputs of |o| up to ~27 made from a few keys (the inputs of
    tests/test_torch_cuda.py::test_flash_bf16_rounding_margin_at_large_outputs,
    ``ref.large_output_inputs``) within one bf16 step of the f32 attention;
    returns the largest error in steps per hd."""
    return {f"hd {hd}": check_one_step(f"hd {hd}", ref.large_output_inputs(hd, dev), True)
            for hd in (64, 256)}


def check_decode_rounding(dev):
    """bf16 decode outputs of |o| up to ~24 made from a few slots, 16 q heads
    over 4 kv heads at hd 64 and over 1 at hd 256 (the inputs of
    tests/test_torch_cuda.py::test_decode_bf16_rounding_margin_at_large_outputs,
    ``ref.large_output_decode_inputs`` at its default seed and the 64 of
    ``ref.DECODE_ROUNDING_SEEDS``), within one bf16 step of the f32
    attention of the same inputs, as the TPU kernel rounds; returns
    ``ref.decode_rounding_sweep`` per hd."""
    out = {}
    for hd in (64, 256):
        out[f"hd {hd}"] = sweep = ref.decode_rounding_sweep(da.decode_attention, hd, dev)
        if not sweep["max_err_in_steps"] <= 1.0:
            raise AssertionError(f"decode_attention bf16 hd {hd}: {sweep} (bf16 steps from "
                                 "the f32 attention of its inputs)")
    return out


def ring_valid(positions, ring, window, device):
    """The decode mask of a ring of ``ring`` slots after each sequence wrote
    positions 0..t (slot = pos % ring, the latest write wins) under a window
    of ``window`` positions, as ``attention.attention_decode`` builds it."""
    t = torch.tensor(positions, device=device)[:, None]
    slot = torch.arange(ring, device=device)[None, :]
    sp = slot + ring * torch.div(t - slot, ring, rounding_mode="floor")
    sp = torch.where(sp >= 0, sp, torch.full_like(sp, -1))
    return (sp >= 0) & (sp <= t) & (sp > t - window)


def timings(kernel, plain, library, flops, nbytes, flush):
    b_ms, b_by = bound(flops, nbytes)
    t = {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if library is not None:
        t["library_ms"] = time_ms(library, flush)
        t["vs_library"] = t["ms"] / t["library_ms"]
    return t


def time_flash(err, qkv, flush, causal=True):
    q, k, v = qkv
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gqa = {"enable_gqa": True} if nq != nkv else {}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # visible (q, k) pairs: causal from position 0 (Sq = Sk), or all of them
    pairs = b * nq * (sq * (sq + 1) // 2 if causal else sq * sk)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()   # q, k, v in; o out
    t = timings(
        lambda: fa.flash_attention(q, k, v, causal=causal),
        lambda: ref.mha_reference(q, k, v, causal=causal),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa),
        4 * hd * pairs, nbytes, flush,
    )
    kind = "causal" if causal else "non-causal"
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:91",
            "shape": f"prefill B={b} Sq={sq} Sk={sk} nq={nq} nkv={nkv} hd={hd} {kind} {q.dtype}",
            "max_abs_err": err, **t}


def time_decode(err, qkvm, flush):
    q, k, v, valid = qkvm
    b, nq, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    n_valid = int(valid.sum())
    es = q.element_size()
    gqa = {"enable_gqa": True} if nq != nkv else {}
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[:, None, None, :]
    # only valid slots' K/V rows need to move: the kernel reads the byte mask
    nbytes = 2 * q.numel() * es + valid.numel() + 2 * n_valid * nkv * hd * es
    t = timings(
        lambda: da.decode_attention(q, k, v, valid),
        lambda: ref.decode_attention_reference(q, k, v, valid),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa),
        4 * hd * nq * n_valid, nbytes, flush,
    )
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:71",
            "shape": f"decode B={b} S={s} valid={n_valid} nq={nq} nkv={nkv} hd={hd} {q.dtype}",
            "max_abs_err": err, **t}


def phase_kernels(seed, prompt_lengths):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_CASES:
            check_flash(gen, *case, dtype)
            n += 1
        # chunked prefill: q at an absolute offset against the full causal result
        q = randn(gen, (1, 64, 4, 32), dtype)
        k = randn(gen, (1, 64, 4, 32), dtype)
        v = randn(gen, (1, 64, 4, 32), dtype)
        out = fa.flash_attention(q[:, 32:].contiguous(), k, v, causal=True, q_offset=32)
        check(f"flash_attention q_offset {dtype}",
              max_err(out, ref.mha_reference(q, k, v, causal=True)[:, 32:]), TOL[dtype])
        for case in DA_CASES:
            check_decode(gen, *case, dtype)
        # one sequence with no valid slot, one with a single one
        valid = torch.rand((3, 100), generator=gen, device=dev) < 0.7
        valid[1] = False
        valid[2] = False
        valid[2, 5] = True
        _, (q, k, v, valid) = check_decode(gen, 3, 100, 8, 2, 64, dtype, valid)
        out = da.decode_attention(q, k, v, valid)
        if bool(out[1].any()):
            raise AssertionError("decode_attention: a sequence with no valid slot is not 0")
        check("decode_attention single valid slot",
              max_err(out[2], v[2, 5].repeat_interleave(4, dim=0)), TOL[dtype])
        n += 2 + len(DA_CASES) + 1 + check_attention_edges(gen, dtype)
    print("[kernels] flash_attention bf16 at |o| up to ~27, largest error in bf16 steps of the "
          "f32 attention: " + json.dumps(check_flash_rounding(dev)))
    print("[kernels] decode_attention bf16 at |o| up to ~24, largest error in bf16 steps of "
          "the f32 attention: " + json.dumps(check_decode_rounding(dev)))
    torch.cuda.synchronize()
    print(f"[kernels] {n + 2} test-shape checks passed in f32 and bf16")

    flush = L2Flush(dev)
    # decode at the main path's shapes: each slot valid up to prompt + new tokens
    lengths = [min(CACHE_LEN, p + NEW_TOKENS) for p in prompt_lengths[:SLOTS]]
    valid = prefix_valid(lengths, CACHE_LEN, dev)
    # flash (b, s, nq, nkv, hd) and decode (b, s, nq, nkv, hd, valid) at the
    # main path's shapes (qwen1.5-0.5b), phi3.5-moe's (GQA 32 q heads over 8
    # kv heads, hd 128, the same traffic), llama3-8b's (a random mask) and
    # recurrentgemma-9b's (MQA 16 q heads over 1 kv head, hd 256, the same
    # traffic: its 2048-token window does not bite at S = 512, and its ring
    # of 2048 slots is the main path's cache)
    shapes = {"main": ((1, PROMPT_MAX, 16, 16, 64), (SLOTS, CACHE_LEN, 16, 16, 64, valid)),
              MOE_ARCH: ((1, PROMPT_MAX, 32, 8, 128), (SLOTS, CACHE_LEN, 32, 8, 128, valid)),
              "llama3_8b": ((1, 2048, 32, 8, 128), (8, 4096, 32, 8, 128, None)),
              "recurrentgemma_9b": ((1, PROMPT_MAX, 16, 1, 256),
                                    (SLOTS, CACHE_LEN, 16, 1, 256, valid))}
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        main[dtype] = {}
        for name, (f, d) in shapes.items():
            err_f, qkv = check_flash(gen, f[0], f[1], f[1], *f[2:], True, 0, dtype)
            err_d, qkvm = check_decode(gen, *d[:5], dtype, d[5])
            main[dtype][name] = (err_f, qkv, err_d, qkvm)
        print(f"[kernels] main-path, {MOE_ARCH}, llama3-8b and {RG_ARCH} shapes {dtype}: "
              "max abs err "
              + json.dumps({name: {"flash": r[0], "decode": r[2]}
                            for name, r in main[dtype].items()}))
    # whisper-small (12 q over 12 kv heads of 64, non-causal flash): the
    # encoder over 1500 frames, the cross-attention of a batch prefill's
    # 4-token prompts and of one decode step (Sq = 1) over those frames, and
    # decode self-attention over its 448-token context, valid up to the
    # prompt and the new tokens
    whisper = {}
    wvalid = prefix_valid([WHISPER_PROMPT + NEW_TOKENS] * SLOTS, WHISPER_CACHE, dev)
    for dtype in (torch.float32, torch.bfloat16):
        whisper[dtype] = {name: check_flash(gen, SLOTS, sq, WHISPER_FRAMES, 12, 12, 64, False, 0,
                                            dtype)
                          for name, sq in (("encoder", WHISPER_FRAMES),
                                           ("cross_prefill", WHISPER_PROMPT), ("cross_decode", 1))}
        whisper[dtype]["decode"] = check_decode(gen, SLOTS, WHISPER_CACHE, 12, 12, 64, dtype, wvalid)
        print(f"[kernels] {WHISPER_ARCH} shapes {dtype}: max abs err "
              + json.dumps({name: r[0] for name, r in whisper[dtype].items()}))
    # the plain version's 2e-2 is ~0.6 of a typical |o| over 1500 keys, so
    # the bf16 outputs are also held within one bf16 step of the f32 attention
    print(f"[kernels] {WHISPER_ARCH} flash bf16, largest error in bf16 steps of the f32 "
          "attention: " + json.dumps(
              {name: check_one_step(name, whisper[torch.bfloat16][name][1], False)
               for name in ("encoder", "cross_prefill", "cross_decode")}))
    rows = []
    for name, (err_f, qkv, err_d, qkvm) in main[torch.bfloat16].items():   # the paths run bf16
        pair = [time_flash(err_f, qkv, flush), time_decode(err_d, qkvm, flush)]
        if name == "main":
            rows = pair
        else:
            rows[0][name], rows[1][name] = pair
    bf = whisper[torch.bfloat16]
    rows[0]["whisper_small"] = time_flash(*bf["encoder"], flush, causal=False)
    rows[0]["whisper_small"]["cross_decode"] = time_flash(*bf["cross_decode"], flush, causal=False)
    rows[1]["whisper_small"] = time_decode(*bf["decode"], flush)
    del main, whisper, bf, flush
    torch.cuda.empty_cache()
    return rows


def rwkv_inputs(gen, b, t, h, hd, with_state, dtype, scale=1.0, strong=False):
    """The distribution of tests/test_kernels.py: r, k ~ 0.5 N, v ~ N, w in
    (0.45, 0.95) (strong: exp(-exp(U(-2, 4))), down to 1e-24), u ~ 0.3 N and
    the state ~ 0.2 N in f32; ``scale`` multiplies r, k and v."""
    dev = gen.device
    sh = (b, t, h, hd)
    r, k = (0.5 * scale * randn(gen, sh, torch.float32) for _ in range(2))
    v = scale * randn(gen, sh, torch.float32)
    if strong:
        w = torch.exp(-torch.exp(torch.rand(sh, generator=gen, device=dev) * 6 - 2))
    else:
        w = torch.sigmoid(randn(gen, sh, torch.float32) * 2 - 1) * 0.5 + 0.45
    u = 0.3 * randn(gen, (h, hd), torch.float32)
    s0 = 0.2 * randn(gen, (b, h, hd, hd), torch.float32) if with_state else None
    return [x.to(dtype) for x in (r, k, v, w)] + [u, s0]


def check_rwkv(gen, case, dtype, **kw):
    """Kernel against the plain version: out and final state within
    RWKV_TOL, and finite."""
    args = rwkv_inputs(gen, *case, dtype, **kw)
    out, s_t = rk.rwkv6_scan(*args)
    exp_o, exp_s = ref.rwkv6_reference(*args)
    if out.shape != exp_o.shape or out.dtype != dtype or s_t.dtype != torch.float32:
        raise AssertionError(f"rwkv6_scan {case}: {out.shape} {out.dtype} {s_t.dtype}")
    if not (bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())):
        raise AssertionError(f"rwkv6_scan {case} {dtype} {kw}: non-finite output")
    err = max(max_err(out, exp_o), max_err(s_t, exp_s))
    check(f"rwkv6_scan {case} {dtype} {kw}", err, RWKV_TOL[dtype])
    return err, args, float(exp_o.float().abs().max())


def check_rwkv_in_place(gen, case, dtype):
    """``final_state=state``: the kernels overwrite the state they read; out
    and state equal those of a separate final state and are within RWKV_TOL
    of the plain version."""
    r, k, v, w, u, s0 = args = rwkv_inputs(gen, *case, dtype)
    out_sep, s_sep = rk.rwkv6_scan(*args)
    state = s0.clone()
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, state, final_state=state)
    if s_t is not state or not (torch.equal(out, out_sep) and torch.equal(state, s_sep)):
        raise AssertionError(f"rwkv6_scan {case} {dtype}: in place differs from a separate state")
    exp_o, exp_s = ref.rwkv6_reference(*args)
    err = max(max_err(out, exp_o), max_err(state, exp_s))
    check(f"rwkv6_scan in place {case} {dtype}", err, RWKV_TOL[dtype])
    return err


def kernel_breakdown(fn, flush, iters=20):
    """Device time per call of each kernel ``fn`` launches, in microseconds,
    from ``torch.profiler`` over ``iters`` calls timed as ``time_ms`` times
    them.  Kernels that overlap (programmatic dependent launch) each count
    their whole span, waits included."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            fn()
        torch.cuda.synchronize()
    return {k.split("(")[0].replace("void ", ""): us / iters for k, us in device_times(prof).items()
            if "rwkv6::" in k}


def time_rwkv(err, args, flush):
    r, k, v, w, u, s0 = args
    b, t, h, hd = r.shape
    es = r.element_size()
    # r, k, v, w in and o out once; the state read once and written once
    nbytes = 5 * r.numel() * es + 2 * b * h * hd * hd * 4
    t_ = timings(lambda: rk.rwkv6_scan(*args), lambda: ref.rwkv6_reference(*args), None,
                 4 * hd * hd * b * t * h, nbytes, flush)
    return {"shape": f"B={b} T={t} H={h} hd={hd} state in and out {r.dtype}",
            "max_abs_err": err, **t_,
            "kernels_us": kernel_breakdown(lambda: rk.rwkv6_scan(*args), flush)}


def phase_rwkv_kernel(seed):
    """The scan kernel against its plain version, then its times at
    rwkv6-1.6b's prefill and decode shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, main, edges = 0, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in RWKV_CASES:
            check_rwkv(gen, case, dtype)
            n += 1
        check_rwkv(gen, (1, 64, 1, 16, False), dtype, strong=True)
        # main-path shapes and T = 2048; r, k, v halved so |o| stays below 8,
        # where bf16's step (0.0625 from 8 on) would exceed the tolerance by
        # rounding alone
        main[dtype] = {name: check_rwkv(gen, case, dtype, scale=0.5)
                       for name, case in (("prefill", RWKV_PREFILL), ("decode", RWKV_DECODE))}
        edges[f"T=2048 {dtype}"] = check_rwkv(gen, RWKV_LONG, dtype, scale=0.5)[0]
        for case in RWKV_IN_PLACE:
            edges[f"in place T={case[1]} {dtype}"] = check_rwkv_in_place(gen, case, dtype)
        n += 4 + len(RWKV_IN_PLACE)
        print(f"[kernels] rwkv6_scan main-path shapes {dtype}: " + json.dumps(
            {name: {"max_abs_err": e, "max_abs_out": m} for name, (e, _, m) in main[dtype].items()}))
    edges["strong decay T=100 bf16"] = check_rwkv(
        gen, (1, 100, 4, 64, True), torch.bfloat16, strong=True)[0]
    n += 1
    print("[kernels] rwkv6_scan long T, strong decay, in place: max abs err " + json.dumps(edges))
    torch.cuda.synchronize()
    print(f"[kernels] rwkv6_scan: {n} checks passed in f32 and bf16")
    flush = L2Flush(dev)
    bf = main[torch.bfloat16]         # the main path runs bf16
    row = {"name": "rwkv6_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
           "replaces": "src/repro/kernels/rwkv6_scan.py:93",
           **time_rwkv(*bf["prefill"][:2], flush),
           "library_why": "no single PyTorch call computes the WKV recurrence"}
    row["decode"] = time_rwkv(*bf["decode"][:2], flush)
    # the floor of a decode step under this timing: a copy of its state (the
    # flush leaves the L2 dirty, so every line brought in is also written back)
    s0 = bf["decode"][1][5]
    copy = torch.empty_like(s0)
    row["decode"]["state_copy_ms"] = time_ms(lambda: copy.copy_(s0), flush)
    row["checks_max_abs_err"] = edges
    del main, bf, flush
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 3: the slices.
# ---------------------------------------------------------------------------
def launch_counts():
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected_launches(cfg, prefills, decode_steps):
    """What each kernel must have launched for ``prefills`` prefills and
    ``decode_steps`` decode steps: every attention layer (global or local)
    runs flash attention in prefill and flash decode per step, every RWKV-6
    layer the scan in both; RG-LRU layers launch none of them.  Whisper's
    encoder layers run flash attention in each prefill, and its decoder
    layers' cross-attention runs it in each prefill and each step."""
    kinds = cfg.layer_kinds()
    n_attn = sum(k in (ATTN, LOCAL_ATTN) for k in kinds)
    n_rwkv = kinds.count(RWKV)
    flash = n_attn * prefills
    if cfg.is_encoder_decoder:
        flash += (cfg.encoder_layers + cfg.num_layers) * prefills + cfg.num_layers * decode_steps
    return {"flash_attention": flash, "decode_attention": n_attn * decode_steps,
            "rwkv6_scan": n_rwkv * (prefills + decode_steps)}


def phase_slice(cfg, seed, prompts, gpu, f32):
    """Serve ``prompts`` with ``cfg`` at full width in bf16, then run its f32
    check ``f32(seed, prompt)``, which holds its f32 logits on the card to
    the CPU's."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arch = cfg.name
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    engine = Engine(cfg, params, EngineConfig(
        slots=SLOTS, cache_len=CACHE_LEN, max_new_tokens=NEW_TOKENS,
        dtype=torch.bfloat16, device="cuda"))
    batcher = ContinuousBatcher(engine)
    spent = {"insert": [], "step": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return run

    engine.insert = timed("insert", engine.insert)
    engine.step = timed("step", engine.step)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    bad = [r.rid for r in reqs if not r.finished or len(r.output) != 1 + NEW_TOKENS]
    if bad:
        raise AssertionError(f"{arch}: requests not finished with 1 + {NEW_TOKENS} tokens: {bad}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError(f"{arch}: a token outside the vocabulary")
    expected = expected_launches(cfg, N_REQUESTS, engine.steps)
    if launches != expected or not any(launches.values()):
        raise AssertionError(f"{arch}: kernel launches {launches} != {expected} "
                             f"({cfg.num_layers} layers, {N_REQUESTS} prefills, "
                             f"{engine.steps} decode steps)")
    n_tokens = sum(len(r.output) for r in reqs)
    result = {
        "model": arch, "dtype": "bfloat16", "layers": cfg.num_layers, "d_model": cfg.d_model,
        "requests": N_REQUESTS, "slots": SLOTS, "cache_len": CACHE_LEN, "new_tokens": NEW_TOKENS,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "decode_steps": engine.steps, "batch_stats": stats.summary(),
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "prefill_ms_mean": 1e3 * float(np.mean(spent["insert"])),
        "prefill_ms_per_prompt_token": 1e3 * sum(spent["insert"]) / sum(len(p) for p in prompts),
        "decode_ms_per_step_median": 1e3 * float(np.median(spent["step"])),
        "peak_mem_gib": peak / 2**30,
        "launches": launches,
        "gpu": gpu,
    }
    moe = bool(cfg.num_experts)
    if moe:
        result["layers_full"] = get_config(arch).num_layers
        result["depth_cut"] = MOE_DEPTH_CUT
        result["moe_sync_free"] = check_moe_sync_free(cfg, params["layers"][0]["moe"])
    print(f"[slice] {arch}: served {N_REQUESTS} requests with {1 + NEW_TOKENS} tokens each "
          f"over {engine.steps} decode steps; kernel launches {json.dumps(launches)} = "
          f"{json.dumps(expected_launches(cfg, 1, 1))} per (prefill, decode step) x "
          f"({N_REQUESTS} prefills, {engine.steps} decode steps)")
    with moe_ranges() if moe else contextlib.nullcontext():
        prof = profile_decode(engine, prompts, PROFILED[arch]["decode"])
        prof["device_busy_share_of_median_step"] = (
            prof["device_ms_per_step"] / result["decode_ms_per_step_median"])
        result["decode_profile"] = prof
        result["prefill_profile"] = profile_prefill(engine, prompts[0], PROFILED[arch]["prefill"])
    # the timing wrappers refer back to the engine: collect the cycle, so
    # that the next slice's peak memory does not count this one's weights
    del engine, batcher, params
    gc.collect()
    torch.cuda.empty_cache()
    result["f32_check"] = f32(seed, prompts[0])
    result["phase_s"] = time.perf_counter() - t_phase
    return result


@contextlib.contextmanager
def wrapped(module, name, wrapper):
    """``module.<name>`` replaced by ``wrapper(original)`` inside the block:
    the port's code looks its helpers up in the module at each call."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def in_range(label):
    """A wrapper that runs the function inside the profiler range ``label``."""
    def wrapper(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run
    return wrapper


@contextlib.contextmanager
def moe_ranges():
    """Every MOE_RANGES function of the MoE module inside its profiler range."""
    with contextlib.ExitStack() as stack:
        for label, name in MOE_RANGES.items():
            stack.enter_context(wrapped(moe_lib, name, in_range(f"moe.{label}")))
        yield


def check_moe_sync_free(cfg, p):
    """The MoE layer at the served decode (all slots) and prefill (512
    tokens) shapes under the sync debug mode "error": any op of it that
    waits on the card raises."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(SLOTS, 1, cfg.d_model), (1, PROMPT_MAX, cfg.d_model)]
    xs = [randn(gen, shape, torch.bfloat16) for shape in shapes]
    for x in xs:                                 # warm-up
        moe_lib.moe_sort_local(cfg, p, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [moe_lib.moe_sort_local(cfg, p, x)[0] for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(bool(torch.isfinite(y.float()).all()) for y in ys):
        raise AssertionError("the MoE layer gave non-finite values")
    return {"shapes": [list(sh) for sh in shapes], "sync_debug_mode": "error"}


def f32_check(cfg, seed, prompt, fill=None, enc_inputs=None):
    """The same port code in f32 with the kernels on the card and the plain
    versions on the CPU, on one prompt plus F32_DECODE_STEPS decode steps;
    ``fill(params, gen)`` may first change the weights on the card, and
    ``enc_inputs`` (1, frames, d) on the CPU are whisper's audio.  An MoE
    model's experts chosen must also be the same on both sides."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p_gpu = model_lib.init_params(cfg, gen, dtype=torch.float32, device=dev)
    if fill is not None:
        fill(p_gpu, gen)
    p_cpu = _tree_to(p_gpu, "cpu")
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    before = launch_counts()
    card_routes, cpu_routes = [], []
    with wrapped(moe_lib, "_route", record_routes(card_routes)):
        gpu_logits, tokens = _teacher_forced(cfg, p_gpu, prompt, None, dev, enc_inputs)
    ran = {name: n - before[name] for name, n in launch_counts().items()}
    if ran != expected_launches(cfg, 1, F32_DECODE_STEPS):
        raise AssertionError(f"the f32 run on the card did not go through the kernels: {ran}")
    with wrapped(moe_lib, "_route", record_routes(cpu_routes)):
        cpu_logits, _ = _teacher_forced(cfg, p_cpu, prompt, tokens, torch.device("cpu"),
                                        enc_inputs)
    checked = compare_routes(cfg, card_routes, cpu_routes) if cfg.num_experts else {}
    errs = []
    for step, (g, c) in enumerate(zip(gpu_logits, cpu_logits)):
        if g.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"f32 step {step}: bad logits {tuple(g.shape)}")
        errs.append(max_err(g.cpu(), c))
    check(f"{cfg.name} f32 logits card vs CPU", max(errs), LOGIT_TOL)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "prompt_tokens": len(prompt),
            "decode_steps": F32_DECODE_STEPS, "max_abs_err_per_step": errs, "tol": LOGIT_TOL,
            **checked}


def f32_check_rwkv(seed, prompt):
    """The RWKV path's f32 check at full width and RWKV_F32_LAYERS layers,
    on a RWKV_F32_PROMPT-token prompt (prefill in chunks of 32, 32 and 13,
    then one-token launches), with the zero-initialised leaves ``mu``,
    ``cm_mu``, ``w0`` and ``u`` filled with noise of scale 0.3 so that the
    token shift and the bonus are exercised.  Tolerance LOGIT_TOL, as for
    attention: the same f32 arithmetic in another order (the chunked scan
    sums log-decays where the plain version multiplies decays, ~1e-6
    relative), through 4 residual layers to logits of size ~1."""
    def fill(params, gen):
        for layer in params["layers"]:
            for name in F32_LEAVES:
                leaf = layer["rwkv"][name]
                leaf.copy_(0.3 * randn(gen, leaf.shape, torch.float32))

    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=RWKV_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, RWKV_F32_PROMPT), fill)


def f32_check_moe(seed, prompt):
    """phi3.5-moe's f32 check at full width and MOE_F32_LAYERS layers on a
    MOE_F32_PROMPT-token prompt (capacity 16 in prefill, 8 in each one-token
    step, so nothing drops).  Card and CPU sum the router product in other
    orders, so a token whose k-th and (k+1)-th logits nearly tie could
    choose another expert and then differ by O(1): the experts chosen in
    every layer and call are recorded on both sides and must be equal, which
    is checked before the logits."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, MOE_F32_PROMPT))


def f32_check_rg(seed, prompt):
    """recurrentgemma-9b's f32 check at full width and RG_F32_LAYERS layers
    (the pattern once and the tail) on a RG_F32_PROMPT-token prompt: longer
    than the 2048-token window, so flash attention's window masks keys and
    the prefill wraps the 2048-slot ring; the decode steps then write over
    its oldest slots.  Tolerance LOGIT_TOL, as for attention: the RG-LRU's
    log-depth scan is the same PyTorch ops on both sides."""
    cfg = dataclasses.replace(get_config(RG_ARCH), num_layers=RG_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, RG_F32_PROMPT))


# ---------------------------------------------------------------------------
# Phase 3e: whisper-small, served at the model's entry points.
# ---------------------------------------------------------------------------
def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def whisper_floors(cfg, params, batch, valid_slots):
    """The least device time of a decode step and of a batch prefill, from
    the shapes.  A step reads every decoder weight but the cross-attention's
    K/V projections (their output is cached), the final norm and the
    unembedding, all layers' cross-attention K/V and the self-attention
    cache's valid rows (the token embedding gathers 8 rows): bytes bound
    it.  A prefill multiplies every frame through the encoder's products and
    each decoder layer's cross K/V projections, runs the encoder's attention
    over all frame pairs, and the prompt through the decoder and the last
    row through the unembedding: operations bound it."""
    es = params["embed"].element_size()
    hd, nq, nkv, L = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    xkv = lambda p: _numel({k: v for k, v in p["xattn"].items() if k in ("wk", "wv", "bk", "bv")})
    dec = sum(_numel(p) - xkv(p) for p in params["layers"])
    head = _numel(params["lm_head"]) + _numel(params["final_norm"])
    kv_row = 2 * nkv * hd                                  # K and V of one position
    step_bytes = es * (dec + head + L * batch * kv_row * (WHISPER_FRAMES + valid_slots))
    enc_w = sum(_numel(p["attn"]) + _numel(p["mlp"]) for p in params["encoder"]["blocks"])
    frames = batch * WHISPER_FRAMES
    prefill_ops = (2 * frames * (enc_w + sum(xkv(p) for p in params["layers"]))
                   + cfg.encoder_layers * 4 * hd * batch * nq * WHISPER_FRAMES ** 2
                   + 2 * batch * WHISPER_PROMPT * dec + 2 * batch * _numel(params["lm_head"]))
    return {"decode_step_bytes": step_bytes, "decode_step_floor_ms": 1e3 * step_bytes / PEAK_BYTES,
            "prefill_operations": prefill_ops,
            "prefill_floor_ms": 1e3 * prefill_ops / PEAK_BF16_FLOPS}


def whisper_generate(cfg, params, frames, prompt, steps, spent):
    """Greedy tokens of one batch at the model's entry points: ``init_cache``,
    ``prefill(enc_inputs=frames)`` and ``steps`` decode steps, each timed on
    the host clock between syncs into ``spent``; returns (B, 1 + steps)
    tokens on the host."""
    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spent[name].append(time.perf_counter() - t0)
        return out

    def prefill():
        cache = model_lib.init_cache(cfg, prompt.shape[0], WHISPER_CACHE,
                                     dtype=params["embed"].dtype, device=prompt.device)
        return model_lib.prefill(cfg, params, prompt, cache, enc_inputs=frames)

    logits, cache = timed("prefill", prefill)
    out = [torch.argmax(logits, dim=-1)]
    for _ in range(steps):
        logits, cache = timed("step", lambda: model_lib.decode_step(cfg, params, out[-1], cache))
        out.append(torch.argmax(logits, dim=-1))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return torch.stack(out, dim=1).cpu()


FLASH_KERNELS = ("fa_mma_kernel", "fa_kernel")


def flash_by_kind(kinds):
    """A wrapper of the flash kernel's entry that appends what each call
    attends to ``kinds``: ``self`` (causal, the decoder's prompt),
    ``encoder`` (non-causal, Sq = Sk, the frames) or ``cross`` (non-causal,
    decoder rows over the frames)."""
    def wrapper(flash):
        def run(q, k, v, *, causal=True, **kw):
            kinds.append("self" if causal else ("encoder" if q.shape[1] == k.shape[1] else "cross"))
            return flash(q, k, v, causal=causal, **kw)
        return run
    return wrapper


def flash_split(prof, kinds, per, suffix):
    """Device ms (per ``per`` calls of the profiled work) of the flash
    kernel by what it attended: each call launches one kernel, and the
    stream runs them in call order, so the profile's flash kernels sorted
    by start time pair with ``kinds``.  (A profiler range around each call
    would show no device time: a launch through ctypes is no ATen op that
    the profiler links a kernel to.)"""
    launched = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and any(p in e.name for p in FLASH_KERNELS)),
                      key=lambda e: e.time_range.start)
    if len(launched) != len(kinds):
        raise AssertionError(f"{len(launched)} flash kernels in the profile, {len(kinds)} calls")
    out = {f"flash_{kind}{suffix}": 0.0 for kind in ("encoder", "self", "cross")}
    for kind, e in zip(kinds, launched):
        out[f"flash_{kind}{suffix}"] += e.time_range.elapsed_us() / per / 1e3
    return out


def profile_whisper(cfg, params, frames, prompt, steps=8):
    """Device time of one batch prefill and of ``steps`` decode steps after
    it, from ``torch.profiler``: busy share of the host-clock window, the
    flash kernel's time split into encoder, self and cross
    (``flash_split``), the decode kernel's (the decoder's self-attention),
    and the kernels that take the most."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cache = model_lib.init_cache(cfg, prompt.shape[0], WHISPER_CACHE,
                                 dtype=params["embed"].dtype, device=prompt.device)
    result, kinds = {}, []
    with wrapped(fa, "flash_attention", flash_by_kind(kinds)):
        for name, per in (("prefill", 1), ("decode", steps)):
            kinds.clear()
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "prefill":
                    logits, cache = model_lib.prefill(cfg, params, prompt, cache,
                                                      enc_inputs=frames)
                    tok = torch.argmax(logits, dim=-1)
                else:
                    for _ in range(steps):
                        logits, cache = model_lib.decode_step(cfg, params, tok, cache)
                        tok = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            by_kernel = device_times(prof)
            busy = sum(by_kernel.values())
            flash = kernel_time(by_kernel, FLASH_KERNELS)
            dec = kernel_time(by_kernel, ("da_split_kernel", "da_combine_kernel")) if per > 1 else 0
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            suffix = "_ms" if per == 1 else "_ms_per_step"
            r = {"profiled_wall" + suffix: wall_us / per / 1e3, "device" + suffix: busy / per / 1e3,
                 "device_busy_share_profiled": busy / wall_us,
                 "flash_attention" + suffix: flash / per / 1e3,
                 "flash_attention_share_of_device": flash / busy,
                 **flash_split(prof, kinds, per, suffix),
                 "top_kernels" + suffix: {k[:80]: us / per / 1e3 for k, us in top}}
            if per > 1:
                r.update({"steps": steps, "decode_attention" + suffix: dec / per / 1e3,
                          "decode_attention_share_of_device": dec / busy})
            result[name] = r
    return result


def phase_whisper(seed, gpu):
    """whisper-small at full width and depth in bf16 through ``init_cache``,
    ``prefill(enc_inputs=)`` and ``decode_step``, batched, as the JAX
    package serves it (its engine's requests carry no audio): every
    encoder, self- and cross-attention call through the flash kernel and
    every decode self-attention call through the decode kernel, by the
    launch counters; then the profile and the f32 check at full depth."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed)
    batches = [
        (torch.from_numpy(frontends.audio_frames(cfg, SLOTS, seed=seed + i)).to(dev, torch.bfloat16),
         torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(SLOTS, WHISPER_PROMPT)),
                         dtype=torch.long, device=dev))
        for i in range(WHISPER_BATCHES)]
    spent = {"prefill": [], "step": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    tokens = [whisper_generate(cfg, params, frames, prompt, NEW_TOKENS, spent)
              for frames, prompt in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WHISPER_BATCHES * NEW_TOKENS
    if any(t.shape != (SLOTS, 1 + NEW_TOKENS) for t in tokens):
        raise AssertionError(f"{cfg.name}: tokens of shapes {[tuple(t.shape) for t in tokens]}")
    if not all(bool(((t >= 0) & (t < cfg.vocab_size)).all()) for t in tokens):
        raise AssertionError(f"{cfg.name}: a token outside the vocabulary")
    expected = expected_launches(cfg, WHISPER_BATCHES, steps)
    if launches != expected:
        raise AssertionError(f"{cfg.name}: kernel launches {launches} != {expected} "
                             f"({cfg.encoder_layers} + {cfg.num_layers} layers, "
                             f"{WHISPER_BATCHES} batch prefills, {steps} decode steps)")
    print(f"[slice] {cfg.name}: served {WHISPER_BATCHES * SLOTS} requests of {WHISPER_FRAMES} "
          f"frames and {WHISPER_PROMPT} prompt tokens with {1 + NEW_TOKENS} tokens each over "
          f"{steps} decode steps; kernel launches {json.dumps(launches)} = "
          f"{json.dumps(expected_launches(cfg, 1, 0))} per batch prefill + "
          f"{json.dumps(expected_launches(cfg, 0, 1))} per decode step")
    n_tokens = sum(t.numel() for t in tokens)
    result = {
        "model": cfg.name, "dtype": "bfloat16", "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
        "params": model_lib.param_count(cfg), "requests": WHISPER_BATCHES * SLOTS,
        "batches": WHISPER_BATCHES, "slots": SLOTS, "frames": WHISPER_FRAMES,
        "prompt_tokens": WHISPER_PROMPT, "cache_len": WHISPER_CACHE, "new_tokens": NEW_TOKENS,
        "decode_steps": steps, "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "prefill_ms_mean": 1e3 * float(np.mean(spent["prefill"])),
        "decode_ms_per_step_median": 1e3 * float(np.median(spent["step"])),
        "peak_mem_gib": peak / 2**30, "launches": launches, "gpu": gpu,
        "floors": whisper_floors(cfg, params, SLOTS, WHISPER_PROMPT + NEW_TOKENS),
    }
    prof = profile_whisper(cfg, params, *batches[0])
    prof["decode"]["device_busy_share_of_median_step"] = (
        prof["decode"]["device_ms_per_step"] / result["decode_ms_per_step_median"])
    result["decode_profile"], result["prefill_profile"] = prof["decode"], prof["prefill"]
    prompt = batches[0][1][0].cpu().numpy()          # the first request's, and its audio:
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    result["f32_check"] = f32_check(
        cfg, seed, prompt, enc_inputs=torch.from_numpy(frontends.audio_frames(cfg, 1, seed=seed)))
    result["phase_s"] = time.perf_counter() - t_phase
    return result



# ---------------------------------------------------------------------------
# Phase 4: the control plane, the batched tick engine on the card.
# ---------------------------------------------------------------------------
# the JAX package's own benchmark shapes (benchmarks/sim_throughput.py):
# a fleet of FLEET_ARCHS archs over SCAN_TICKS ticks of the shared_berkeley
# scenario, and a grid of GRID_CELLS cells (the four GRID_SCENARIOS x 16
# seeds) of GRID_ARCHS archs over the same number of ticks
SERVING_POOL = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b", "whisper-small",
                "llava-next-mistral-7b", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b"]
FLEET_ARCHS, SCAN_TICKS, STRICT_FRAC = 1024, 3600, 0.25
GRID_CELLS, GRID_ARCHS, GRID_MEAN_RPS = 64, 16, 400.0
GRID_SCENARIOS = ("shared_berkeley", "diurnal_phases", "mmpp_bursts", "flash_correlated")
# grid cells held to the NumPy engine and to run_scenario: all four scenarios
GRID_SAMPLE = (0, 9, 18, 27, 36, 45, 54, 63)
# the grid = run_scenario check runs the grid again over the first
# SAME_TICKS ticks of every cell and each sampled cell alone over them
SAME_TICKS = 600
PROFILE_TICKS = 100
# the contract of tests/test_torch_sim_engine.py (and the reference's
# tests/test_jax_engine.py): raw ledger totals and per-arch flows
SIM_RTOL = SIM_ATOL = 1e-6
PER_ARCH_FLOWS = ("served_vm", "served_burst", "dropped", "violations", "acc_weight",
                  "acc_violations")


def numpy_run(arrivals, wl, policy, seed):
    """The port's NumPy engine (the oracle) driven by the vector scheduler."""
    sim = core_sim.ServingSim(arrivals, wl, seed=seed)
    pol = RLPoolPolicy(greedy=True) if policy == "rl_pool" else VECTOR_SCHEDULERS[policy]()
    while not sim.done:
        sim.apply_pool(pol(sim.tick, sim.observe_pool()))
    return sim


def raw_ledger(res):
    """A ``SimResult``'s unrounded ledger, as the torch engine's
    ``_assemble`` names it (``out["ledger"]``)."""
    return {"cost_reserved": res.cost_reserved, "cost_spot": res.cost_spot,
            "cost_burst": res.cost_burst, "cost_harvest": res.cost_other.get("harvest", 0.0),
            "cost_remote": res.cost_other.get("remote", 0.0), "violations": res.violations,
            "violations_strict": res.violations_strict, "served_vm": res.served_vm,
            "served_burst": res.served_burst, "preemptions": float(res.preemptions),
            "chip_seconds": res.chip_seconds, "chip_seconds_needed": res.chip_seconds_needed,
            "chip_seconds_over": res.chip_seconds_over,
            "accuracy_weighted": res.accuracy_weighted,
            "accuracy_served": res.accuracy_served, "acc_violations": res.acc_violations}


def hold_to_numpy(name, out, sim) -> float:
    """Raise unless the torch engine's raw ledger and per-arch flows are
    within SIM_RTOL / SIM_ATOL of the NumPy engine's and their summaries
    have the same keys; returns the largest relative ledger error."""
    want, got = raw_ledger(sim.res), out["ledger"]
    worst = 0.0
    for k, w in want.items():
        if not abs(got[k] - w) <= SIM_ATOL + SIM_RTOL * abs(w):
            raise AssertionError(f"control plane {name}: ledger {k} {got[k]!r} on the card, "
                                 f"{w!r} from the NumPy engine")
        worst = max(worst, abs(got[k] - w) / max(abs(w), 1e-300))
    counts = sim.per_arch_counts()
    for k in PER_ARCH_FLOWS:
        if not np.allclose(out["per_arch"][k], counts[k], rtol=SIM_RTOL, atol=SIM_ATOL):
            i = int(np.argmax(np.abs(out["per_arch"][k] - counts[k])))
            raise AssertionError(f"control plane {name}: per-arch {k} of arch {i}: "
                                 f"{out['per_arch'][k][i]!r} on the card, {counts[k][i]!r}")
    if set(out["summary"]) != set(sim.res.summary()):
        raise AssertionError(f"control plane {name}: summary keys {sorted(out['summary'])} "
                             f"!= {sorted(sim.res.summary())}")
    return worst


def timed_ticks(policy, inputs, ticks=None):
    """One tick loop on the card, host clock from a sync to the end of a
    sync; returns (wall seconds, device outputs)."""
    statics, state0, xs, variants = inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch_engine.run_ticks(torch_engine.TORCH_POLICIES[policy].apply, statics, state0, xs,
                                 variants=variants, ticks=ticks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_ticks(policy, inputs):
    """Device busy share of PROFILE_TICKS ticks from ``torch.profiler``, the
    kernels launched a tick and the kernels that take the most time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = timed_ticks(policy, inputs, ticks=PROFILE_TICKS)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    by_kernel = {e.key: e.self_device_time_total for e in device}
    launches = sum(e.count for e in device)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"ticks": PROFILE_TICKS, "profiled_wall_ms_per_tick": 1e3 * wall / PROFILE_TICKS,
            "device_ms_per_tick": busy / PROFILE_TICKS / 1e3,
            "device_busy_share": busy / (1e6 * wall),
            "device_kernels_per_tick": launches / PROFILE_TICKS,
            "top_kernels_ms_per_tick": {k[:60]: us / PROFILE_TICKS / 1e3 for k, us in top}}


def busy_share(row):
    """The profiled device time a tick over the unprofiled run's wall time a
    tick: the device's busy share of the timed run."""
    row["device_busy_share_of_timed_run"] = (
        row["profile"]["device_ms_per_tick"] / (1e3 * row["wall_s"] / row["ticks"]))


def check_sync_guard(dev):
    """The tick loop's guard is live: a host sync inside it raises."""
    x = torch.ones(1, device=dev)
    try:
        with torch_engine._SyncGuard(dev):
            x.item()
    except RuntimeError:
        return True
    raise AssertionError("torch.cuda.set_sync_debug_mode('error') did not catch a sync")


def phase_control_plane(seed):
    """The control plane on the card: run_scenario over a fleet of 1024 archs
    under portfolio and rl_pool, run_grid over 64 cells of 16 archs under
    portfolio, every run held to the port's NumPy engine."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    result = {"sync_guard_catches_a_sync": check_sync_guard(dev)}
    wl = core_sim.replicate_pool(SERVING_POOL, FLEET_ARCHS, strict_frac=STRICT_FRAC)
    arr = SCENARIO_ZOO["shared_berkeley"].build(FLEET_ARCHS, duration_s=SCAN_TICKS)
    worst = 0.0
    for policy in ("portfolio", "rl_pool"):
        t0 = time.perf_counter()
        inputs = torch_engine.prepare_grid(arr[None], wl, policy, seeds=[seed], device=dev)
        build_s = time.perf_counter() - t0
        timed_ticks(policy, inputs, ticks=20)                 # warm-up, not timed
        wall, out = timed_ticks(policy, inputs)
        res = torch_engine._assemble(torch_engine._cell(torch_engine._to_host(out), 0), arr)
        t0 = time.perf_counter()
        sim = numpy_run(arr, wl, policy, seed)
        numpy_s = time.perf_counter() - t0
        err = hold_to_numpy(f"{policy} A={FLEET_ARCHS}", res, sim)
        worst = max(worst, err)
        result[f"fleet_{policy}"] = {
            "archs": FLEET_ARCHS, "ticks": SCAN_TICKS, "build_inputs_s": build_s,
            "wall_s": wall, "ticks_per_s": SCAN_TICKS / wall,
            "arch_ticks_per_s": FLEET_ARCHS * SCAN_TICKS / wall,
            "numpy_engine_s": numpy_s, "max_rel_ledger_err": err,
            "profile": profile_ticks(policy, inputs),
        }
        busy_share(result[f"fleet_{policy}"])
        del inputs, out
        print(f"[control] {policy} A={FLEET_ARCHS} T={SCAN_TICKS}: "
              + json.dumps(result[f"fleet_{policy}"]))

    gwl = core_sim.replicate_pool(SERVING_POOL, GRID_ARCHS, strict_frac=STRICT_FRAC)
    arrs = np.stack([
        SCENARIO_ZOO[GRID_SCENARIOS[i % len(GRID_SCENARIOS)]].build(
            GRID_ARCHS, duration_s=SCAN_TICKS, mean_rps=GRID_MEAN_RPS,
            seed=100 + i // len(GRID_SCENARIOS))
        for i in range(GRID_CELLS)])
    seeds = [seed + i // len(GRID_SCENARIOS) for i in range(GRID_CELLS)]
    t0 = time.perf_counter()
    inputs = torch_engine.prepare_grid(arrs, gwl, "portfolio", seeds=seeds, device=dev)
    build_s = time.perf_counter() - t0
    timed_ticks("portfolio", inputs, ticks=20)
    wall, out = timed_ticks("portfolio", inputs)
    host = torch_engine._to_host(out)
    cells, numpy_s = {}, 0.0
    for i in GRID_SAMPLE:
        cell = torch_engine._assemble(torch_engine._cell(host, i), arrs[i])
        t0 = time.perf_counter()
        sim = numpy_run(arrs[i], gwl, "portfolio", seeds[i])
        numpy_s += time.perf_counter() - t0
        err = hold_to_numpy(f"grid cell {i}", cell, sim)
        worst = max(worst, err)
        cells[i] = {"max_rel_ledger_err": err}
    short = arrs[:, :, :SAME_TICKS]
    grid = torch_engine.run_grid(short, gwl, "portfolio", seeds=seeds, device=dev)
    for i in GRID_SAMPLE:
        single = torch_engine.run_scenario(short[i], gwl, "portfolio", seed=seeds[i], device=dev)
        if single["summary"] != grid[i]["summary"]:
            raise AssertionError(f"control plane grid cell {i}: summary {grid[i]['summary']} "
                                 f"!= run_scenario's {single['summary']}")
        gap = max(abs(grid[i]["ledger"][k] - v) / max(abs(v), 1e-300)
                  for k, v in single["ledger"].items())
        if gap > 1e-12:
            raise AssertionError(f"control plane grid cell {i}: raw ledger {gap} from "
                                 "run_scenario's")
        cells[i]["vs_run_scenario"] = gap
    result["grid_portfolio"] = {
        "cells": GRID_CELLS, "archs": GRID_ARCHS, "ticks": SCAN_TICKS,
        "build_inputs_s": build_s, "wall_s": wall,
        "cell_ticks_per_s": GRID_CELLS * SCAN_TICKS / wall,
        "ticks_per_s": SCAN_TICKS / wall,
        "numpy_engine_s": numpy_s,
        "numpy_cell_ticks_per_s": len(GRID_SAMPLE) * SCAN_TICKS / numpy_s,
        "vs_run_scenario_ticks": SAME_TICKS, "sampled_cells": cells,
        "profile": profile_ticks("portfolio", inputs),
    }
    busy_share(result["grid_portfolio"])
    print(f"[control] grid {GRID_CELLS} cells x A={GRID_ARCHS}: "
          + json.dumps(result["grid_portfolio"]))
    result["max_rel_ledger_err"] = worst
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["phase_s"] = time.perf_counter() - t_phase
    return result


def record_routes(into):
    """A wrapper of ``_route`` that appends each call's expert indices to ``into``."""
    def wrapper(route):
        def run(cfg, router_w, xf):
            gates, topi, aux = route(cfg, router_w, xf)
            into.append(topi.cpu())
            return gates, topi, aux
        return run
    return wrapper


def compare_routes(cfg, card, cpu):
    """Raise if any call chose other experts on the card than on the CPU;
    calls run layer by layer for the prefill, then for each decode step."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} routing calls on the card, {len(cpu)} on the CPU")
    flips = {f"call {i} (step {i // cfg.num_layers}, layer {i % cfg.num_layers})":
             int((a != b).any(dim=-1).sum()) for i, (a, b) in enumerate(zip(card, cpu))
             if not torch.equal(a, b)}
    if flips:
        raise AssertionError(f"{cfg.name}: experts chosen differ between card and CPU "
                             f"(tokens with another choice): {flips}")
    return {"routing_calls": len(card), "tokens_routed": int(sum(a.shape[0] for a in card)),
            "experts_equal": True}


def kernel_time(by_kernel, patterns) -> float:
    """Device time of the kernels whose names hold one of ``patterns``;
    raises if the profile has device time but none of those kernels."""
    own = sum(us for k, us in by_kernel.items() if any(p in k for p in patterns))
    if own == 0 and any(by_kernel.values()):
        raise AssertionError(f"no kernel named like {patterns} in the profile")
    return own


def profile_decode(engine, prompts, kernel, steps=8):
    """Device time of ``steps`` decode steps with all slots live, from
    ``torch.profiler``: busy share of the host-clock window, the time of
    ``kernel`` = (label, name patterns) and the kernels that take the most
    device time.  Runs after the served run; its launches are not counted
    against the main path."""
    for i, p in enumerate(prompts[:SLOTS]):
        engine.insert(Request(rid=1000 + i, prompt=p, max_new_tokens=steps + 1))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = device_times(prof)
    busy = sum(by_kernel.values())
    own = kernel_time(by_kernel, kernel[1])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "steps": steps, "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy / steps / 1e3,
        "device_busy_share_profiled": busy / wall_us,
        f"{kernel[0]}_ms_per_step": own / steps / 1e3, f"{kernel[0]}_share_of_device": own / busy,
        "top_kernels_ms_per_step": {k[:80]: us / steps / 1e3 for k, us in top},
        **moe_breakdown(prof, busy, steps, "_ms_per_step"),
    }


def device_times(prof):
    """Device time by kernel name: device-side events only (kernels, copies,
    memsets); a CPU op's entry repeats the device time of what it launched,
    and a profiler range's device-side mirror spans other kernels."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation}


def moe_breakdown(prof, busy, per, suffix):
    """Device time (ms per ``per`` calls of the profiled work) and share of
    the busy time of the MoE layer's parts, from the MOE_RANGES profiler
    ranges: the device time of the kernels launched inside each; empty when
    no range was recorded, and raises when ranges hold no device time."""
    ranges = {label: 0.0 for label in MOE_RANGES}
    seen = False
    for e in prof.events():
        label = e.name[len("moe."):]
        if (e.name.startswith("moe.") and label in ranges
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges[label] += e.device_time_total
            seen = True
    if not seen:
        return {}
    if (busy and not (ranges["layer"] and ranges["experts"])) or ranges["layer"] > busy:
        raise AssertionError(f"the MoE profiler ranges hold no device time, or more than "
                             f"the {busy} us of the profile: {ranges}")
    parts = {"moe_layers": ranges["layer"], "moe_experts": ranges["experts"],
             "moe_route": ranges["route"],
             "moe_dispatch_combine": ranges["layer"] - ranges["experts"] - ranges["route"]}
    out = {f"{name}{suffix}": us / per / 1e3 for name, us in parts.items()}
    out.update({f"{name}_share_of_device": us / busy for name, us in parts.items()})
    return out


def profile_prefill(engine, prompt, kernel, length=PROMPT_MAX):
    """Device time of one ``length``-token prefill, the engine's own call
    (batch 1, a fresh one-sequence cache), after one unprofiled warm-up:
    busy share of its host-clock window, the time and share of device time
    of ``kernel`` = (label, name patterns) and the kernels that take the
    most."""
    tokens = torch.as_tensor(np.resize(prompt, length), dtype=torch.long,
                             device=engine.device)[None, :]

    def run():
        return model_lib.prefill(engine.cfg, engine.params, tokens, engine._init_cache(1),
                                 window=engine.ecfg.window)

    run()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = device_times(prof)
    busy = sum(by_kernel.values())
    own = kernel_time(by_kernel, kernel[1])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "prompt_tokens": length, "profiled_wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
        "device_busy_share_profiled": busy / wall_us,
        f"{kernel[0]}_ms": own / 1e3, f"{kernel[0]}_share_of_device": own / busy,
        "top_kernels_ms": {k[:80]: us / 1e3 for k, us in top},
        **moe_breakdown(prof, busy, 1, "_ms"),
    }


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _teacher_forced(cfg, params, prompt, tokens, device, enc_inputs=None):
    """Prefill plus F32_DECODE_STEPS decode steps of batch 1; feeds ``tokens``
    when given, else the greedy ones, which it returns."""
    cache = model_lib.init_cache(cfg, 1, len(prompt) + F32_DECODE_STEPS,
                                 dtype=torch.float32, device=device)
    enc = enc_inputs.to(device) if enc_inputs is not None else None
    logits, cache = model_lib.prefill(cfg, params, prompt[None].to(device), cache,
                                      enc_inputs=enc)
    out, fed = [logits], []
    for i in range(F32_DECODE_STEPS):
        tok = tokens[i] if tokens is not None else int(torch.argmax(logits[0]))
        fed.append(tok)
        logits, cache = model_lib.decode_step(
            cfg, params, torch.tensor([tok], dtype=torch.long, device=device), cache)
        out.append(logits)
    return out, fed


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = phase_build()
    rng = np.random.default_rng(args.seed)
    vocab = get_config(ARCH).vocab_size
    prompts = [
        rng.integers(0, vocab, size=int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1))).astype(np.int32)
        for _ in range(N_REQUESTS)
    ]
    # the same traffic for rwkv6-1.6b: the prompt lengths above, its own vocabulary
    rwkv_vocab = get_config(RWKV_ARCH).vocab_size
    rwkv_prompts = [rng.integers(0, rwkv_vocab, size=len(p)).astype(np.int32) for p in prompts]
    moe_vocab = get_config(MOE_ARCH).vocab_size
    moe_prompts = [rng.integers(0, moe_vocab, size=len(p)).astype(np.int32) for p in prompts]
    rg_vocab = get_config(RG_ARCH).vocab_size
    rg_prompts = [rng.integers(0, rg_vocab, size=len(p)).astype(np.int32) for p in prompts]
    rows = phase_kernels(args.seed, [len(p) for p in prompts])
    rows.append(phase_rwkv_kernel(args.seed))
    qwen = get_config(ARCH)
    moe = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    # one slice at a time: each phase frees its weights before the next
    slices = [phase_slice(qwen, args.seed, prompts, gpu,
                          lambda seed, prompt: f32_check(qwen, seed, prompt)),
              phase_slice(get_config(RWKV_ARCH), args.seed, rwkv_prompts, gpu, f32_check_rwkv),
              phase_slice(moe, args.seed, moe_prompts, gpu, f32_check_moe),
              phase_slice(get_config(RG_ARCH), args.seed, rg_prompts, gpu, f32_check_rg),
              phase_whisper(args.seed, gpu)]
    for row in rows:
        row["launches"] = sum(res["launches"][row["name"]] for res in slices)
    control = phase_control_plane(args.seed)
    for res in slices:
        print(json.dumps({"slice": res}))
    print(json.dumps({"control_plane": control}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
