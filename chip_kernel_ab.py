#!/usr/bin/env python3
"""Time the kernels of one source tree on one NVIDIA GPU, at the shapes
``chip_smoke.py`` times them, to compare two trees in one run.

  python3 chip_kernel_ab.py --src SRC_DIR [--label NAME] [--iters N]

``SRC_DIR`` is the ``src`` directory of a checkout (this one, or a parent
commit unpacked with ``git archive``); its ``repro_torch`` is imported and
its kernels are built into that checkout's ``build/``.  The measurement is
this checkout's ``chip_smoke.py``'s, imported over SRC_DIR's package: its
``time_ms`` (median of CUDA events around single calls, the L2 flushed and
device sleep queued before each), its wrappers' host time, and phase 6a's
training configuration, timed steps and profile reader.  Run the trees in
turns (A, B, B, A) in one command on one card, so that both see the same
card and host.  Prints one JSON line: ms per kernel and shape (flash in
bf16 at the served shapes and at recurrentgemma-9b's S = 2048, and in f32
at the training shape, at the served prefill shapes of hd 64, 128, 112
and 256 and at recurrentgemma-9b's S = 2112 under its 2048-token window
and B = 8), the RWKV-6 scan at rwkv6-1.6b's prefill and decode shapes in
bf16, its training forward and prefill in f32 and at T = 2048 (``SCAN``), the flash
and decode wrappers' host microseconds a call at the main path's shape,
the bf16 flash kernel's rounding at large outputs (``rounding_margin``) and
the bf16 decode kernel's over ``ref.DECODE_ROUNDING_SEEDS``
(``decode_rounding``, hd 64, 112 and 256), and qwen1.5-0.5b's f32
training step through the tree's kernels as phase 6a measures it
(``train_step``: the end-to-end number the f32 flash forward should move),
and under ``"digests"`` a hash of each timed call's output bytes, on inputs
made from seed 0 in the same order for every tree: a kernel that two trees
compute alike gives the same digest.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

# chip_smoke.py's shapes: (B, Sq, Sk, nq, nkv, hd, causal) for flash (from
# position 0) and (B, cache slots, nq, nkv, hd, valid lengths) for decode
# over prefix masks (8 slots, each valid up to its prompt + 32 tokens;
# whisper's up to its 4-token prompt + 32; llama3-8b's whole 2048-slot cache)
FLASH = {"qwen1.5-0.5b": (1, 512, 512, 16, 16, 64, True),
         "phi3.5-moe": (1, 512, 512, 32, 8, 128, True),
         "kimi-k2": (1, 512, 512, 64, 8, 112, True),
         "llama3-8b": (1, 2048, 2048, 32, 8, 128, True),
         "recurrentgemma-9b": (1, 512, 512, 16, 1, 256, True),
         "recurrentgemma-9b S=2048": (1, 2048, 2048, 16, 1, 256, True),
         "whisper-small encoder": (8, 1500, 1500, 12, 12, 64, False),
         "whisper-small cross decode": (8, 1, 1500, 12, 12, 64, False)}
# the f32 flash forward (B, Sq, Sk, nq, nkv, hd, causal, window): every
# training step's (qwen1.5-0.5b, B=8, S=512), the served prefill shapes at
# hd 64, 128, 112 and 256, and recurrentgemma-9b's at a prompt its
# 2048-token window cuts (phase 3d's f32 check) and at batch 8
FLASH_F32 = {"train qwen1.5-0.5b": (8, 512, 512, 16, 16, 64, True, 0),
             "qwen1.5-0.5b": (1, 512, 512, 16, 16, 64, True, 0),
             "phi3.5-moe": (1, 512, 512, 32, 8, 128, True, 0),
             "kimi-k2": (1, 512, 512, 64, 8, 112, True, 0),
             "recurrentgemma-9b": (1, 512, 512, 16, 1, 256, True, 0),
             "recurrentgemma-9b S=2112 W=2048": (1, 2112, 2112, 16, 1, 256, True, 2048),
             "recurrentgemma-9b B=8": (8, 512, 512, 16, 1, 256, True, 0)}
SERVED = [96, 544, 300, 65, 64, 1, 2048, 411]
DECODE = {"qwen1.5-0.5b": (8, 2048, 16, 16, 64, SERVED),
          "phi3.5-moe": (8, 2048, 32, 8, 128, SERVED),
          "kimi-k2": (8, 2048, 64, 8, 112, SERVED),
          "recurrentgemma-9b": (8, 2048, 16, 1, 256, SERVED),
          "whisper-small": (8, 448, 12, 12, 64, [36] * 8),
          "llama3-8b full cache": (8, 2048, 32, 8, 128, [2048] * 8)}
# the RWKV-6 scan (name, (B, T, H, hd, with_state), dtype): rwkv6-1.6b's
# served prefill and decode step in bf16, then (after them, so that the
# inputs of every row before stay those of older runs) its training forward
# and served prefill in f32, and T = 2048 in bf16
SCAN = [("prefill", (1, 500, 32, 64, True), torch.bfloat16),
        ("decode", (8, 1, 32, 64, True), torch.bfloat16),
        ("f32 train", (4, 128, 32, 64, False), torch.float32),
        ("f32 prefill", (1, 500, 32, 64, True), torch.float32),
        ("T=2048", (1, 2048, 4, 64, True), torch.bfloat16)]


def own_ref():
    """This checkout's ``kernels/ref.py`` (torch and numpy only), loaded by
    path: the probe's inputs and bound come from here, so that a tree from
    before them is probed the same way."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "src", "repro_torch", "kernels", "ref.py")
    spec = importlib.util.spec_from_file_location("chip_kernel_ab_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rounding_margin(fa, dev):
    """On ``ref.large_output_inputs`` (the inputs of tests/test_torch_cuda.py's
    test_flash_bf16_rounding_margin_at_large_outputs), per hd: the largest
    |o - o32| against the f32 attention o32 of the same inputs, the largest
    in bf16 steps of o32 (``ref.bf16_step``), and how many outputs lie more
    than one step away."""
    probe, out = own_ref(), {}
    for hd in (64, 112, 128, 256):
        q, k, v = probe.large_output_inputs(hd, dev)
        o = fa.flash_attention(q, k, v, causal=True)
        o32 = probe.mha_reference(q.float(), k.float(), v.float(), causal=True)
        steps = probe.bf16_steps_from_f32(o, q, k, v, causal=True)
        out[f"hd {hd}"] = {"max_abs_err_vs_f32": float((o.float() - o32).abs().max()),
                           "max_err_in_steps": float(steps.max()),
                           "outputs_over_one_step": int((steps > 1).sum())}
    return out


def load_smoke(src):
    """This checkout's ``chip_smoke.py`` over SRC's ``repro_torch``: SRC's
    package is imported first, so that the script's own ``src`` (which it
    puts first on the path) never shadows it."""
    sys.path.insert(0, os.path.abspath(src))
    import repro_torch  # noqa: F401
    import chip_smoke
    return chip_smoke


def train_step(smoke, dev, steps=6) -> dict:
    """qwen1.5-0.5b's f32 training step as ``chip_smoke.py`` phase 6a
    measures it (its configuration, B=8, S=512, AdamW lr 3e-4, wsd, remat;
    ``timed_steps``; ``read_profile``) through this tree's kernels, after
    one step of ``train_loop.train`` in place of phase 6a's 20: the host ms
    of each further step between syncs, their median after the first, and
    of one profiled step the device ms of all its kernels and of the flash
    forwards (``FLASH_KERNELS``)."""
    from repro_torch.training import train_loop

    cfg = smoke.get_config(smoke.ARCH)
    tcfg = smoke.train_config(smoke.TRAIN_STEPS)
    data = smoke.SyntheticLM(cfg.vocab_size, smoke.TRAIN_SEQ, smoke.TRAIN_BATCH, seed=0)
    params, opt, _ = train_loop.train(cfg, tcfg, iter(data), 1, seed=0, device="cuda")
    step = train_loop.make_train_step(cfg, tcfg)
    batches = [train_loop.batch_to(next(data), dev) for _ in range(steps)]
    state, times = smoke.timed_steps(step, (params, opt), batches)
    del params, opt
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(*state, batches[-1])
        torch.cuda.synchronize()
    by_kernel = smoke.read_profile(prof, ())[0]
    return {"step_ms": float(np.median(times[1:])), "step_ms_each": times,
            "device_ms": sum(by_kernel.values()) / 1e3,
            "flash_forward_device_ms": smoke.kernel_time(by_kernel, smoke.FLASH_KERNELS) / 1e3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: no CUDA device")
    smoke = load_smoke(args.src)
    da, fa = smoke.da, smoke.fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    flush = smoke.L2Flush(dev)
    time_ms = lambda fn: smoke.time_ms(fn, flush, iters=args.iters)
    host_us = lambda fn: smoke.host_us_per_call(fn, calls=200)
    out = {"label": args.label, "src": args.src, "gpu": torch.cuda.get_device_name(0),
           "digests": {}}

    def timed(key, fn):
        """fn's time under ``key``, and a digest of its output's bytes: two
        trees whose kernels compute the same bits give the same digest."""
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        out["digests"][key] = hashlib.sha256(
            b"".join(r.contiguous().view(torch.uint8).cpu().numpy().tobytes() for r in res)
        ).hexdigest()[:16]
        out[key] = time_ms(fn)
    for name, (b, sq, sk, nq, nkv, hd, causal) in FLASH.items():
        if hd not in fa.SUPPORTED_HEAD_DIMS:
            out[f"flash {name}"] = None          # a tree from before this head dim
            continue
        q, k, v = rand(b, sq, nq, hd), rand(b, sk, nkv, hd), rand(b, sk, nkv, hd)
        timed(f"flash {name}", lambda: fa.flash_attention(q, k, v, causal=causal))
        if name == "qwen1.5-0.5b":
            out["flash host us per call"] = host_us(
                lambda: fa.flash_attention(q, k, v, causal=causal))
    for name, (b, sq, sk, nq, nkv, hd, causal, window) in FLASH_F32.items():
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                   for s, n in ((sq, nq), (sk, nkv), (sk, nkv)))
        timed(f"flash f32 {name}",
              lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
    for name, (b, s, nq, nkv, hd, lengths) in DECODE.items():
        if hd not in da.SUPPORTED_HEAD_DIMS:
            out[f"decode {name}"] = None
            continue
        valid = (torch.arange(s, device=dev)[None, :]
                 < torch.tensor(lengths, device=dev)[:, None])
        q, k, v = rand(b, nq, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
        timed(f"decode {name}", lambda: da.decode_attention(q, k, v, valid))
        if name == "qwen1.5-0.5b":
            out["decode host us per call"] = host_us(lambda: da.decode_attention(q, k, v, valid))
    for name, case, dtype in SCAN:
        scan_args = smoke.rwkv_inputs(gen, *case, dtype, scale=0.5)
        timed(f"scan {name}", lambda: smoke.rk.rwkv6_scan(*scan_args))
    out["rounding"] = rounding_margin(fa, dev)
    probe = own_ref()
    out["decode_rounding"] = {f"hd {hd}": probe.decode_rounding_sweep(da.decode_attention, hd, dev)
                              for hd in (64, 112, 256)}
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py trains
    out["train_step"] = train_step(smoke, dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
