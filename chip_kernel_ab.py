#!/usr/bin/env python3
"""Time the two attention kernels of one source tree on one NVIDIA GPU, at
the shapes ``chip_smoke.py`` times them, to compare two trees in one run.

  python3 chip_kernel_ab.py --src SRC_DIR [--label NAME] [--iters N]

``SRC_DIR`` is the ``src`` directory of a checkout (this one, or a parent
commit unpacked with ``git archive``); its ``repro_torch`` is imported and
its kernels are built into that checkout's ``build/``.  Timing is
``chip_smoke.py``'s: median of CUDA events around single calls, the L2
flushed and ~0.1 ms of device sleep queued before each.  Run the trees in
turns (A, B, B, A) in one command on one card, so that both see the same
card and host.  Prints one JSON line: ms per kernel and shape, the flash
and decode wrappers' host microseconds a call at the main path's shape,
the bf16 flash kernel's rounding at large outputs (``rounding_margin``) and
the bf16 decode kernel's over ``ref.DECODE_ROUNDING_SEEDS``
(``decode_rounding``, hd 64, 112 and 256).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

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
         "whisper-small encoder": (8, 1500, 1500, 12, 12, 64, False),
         "whisper-small cross decode": (8, 1, 1500, 12, 12, 64, False)}
SERVED = [96, 544, 300, 65, 64, 1, 2048, 411]
DECODE = {"qwen1.5-0.5b": (8, 2048, 16, 16, 64, SERVED),
          "phi3.5-moe": (8, 2048, 32, 8, 128, SERVED),
          "kimi-k2": (8, 2048, 64, 8, 112, SERVED),
          "recurrentgemma-9b": (8, 2048, 16, 1, 256, SERVED),
          "whisper-small": (8, 448, 12, 12, 64, [36] * 8),
          "llama3-8b full cache": (8, 2048, 32, 8, 128, [2048] * 8)}
HOST_AHEAD_CYCLES = 200_000


def time_ms(fn, flush, iters, warmup=3) -> float:
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


def host_us(fn, calls=200) -> float:
    """Host microseconds of one call (the wrapper, its launch), the card left
    to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    flush = flush_buf.zero_
    out = {"label": args.label, "src": args.src, "gpu": torch.cuda.get_device_name(0)}
    for name, (b, sq, sk, nq, nkv, hd, causal) in FLASH.items():
        if hd not in fa.SUPPORTED_HEAD_DIMS:
            out[f"flash {name}"] = None          # a tree from before this head dim
            continue
        q, k, v = rand(b, sq, nq, hd), rand(b, sk, nkv, hd), rand(b, sk, nkv, hd)
        out[f"flash {name}"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                                       flush, args.iters)
        if name == "qwen1.5-0.5b":
            out["flash host us per call"] = host_us(
                lambda: fa.flash_attention(q, k, v, causal=causal))
    for name, (b, s, nq, nkv, hd, lengths) in DECODE.items():
        if hd not in da.SUPPORTED_HEAD_DIMS:
            out[f"decode {name}"] = None
            continue
        valid = (torch.arange(s, device=dev)[None, :]
                 < torch.tensor(lengths, device=dev)[:, None])
        q, k, v = rand(b, nq, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
        out[f"decode {name}"] = time_ms(lambda: da.decode_attention(q, k, v, valid), flush,
                                        args.iters)
        if name == "qwen1.5-0.5b":
            out["decode host us per call"] = host_us(lambda: da.decode_attention(q, k, v, valid))
    out["rounding"] = rounding_margin(fa, dev)
    probe = own_ref()
    out["decode_rounding"] = {f"hd {hd}": probe.decode_rounding_sweep(da.decode_attention, hd, dev)
                              for hd in (64, 112, 256)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
