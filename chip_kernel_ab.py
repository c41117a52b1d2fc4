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
card and host.  Prints one JSON line: ms per kernel and shape.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

# chip_smoke.py's shapes: (B, S, nq, nkv, hd) for flash (causal, from
# position 0) and (B, cache slots, nq, nkv, hd) for decode over the main
# path's prefix masks (8 slots, each valid up to its prompt + 32 tokens)
FLASH = {"qwen1.5-0.5b": (1, 512, 16, 16, 64), "phi3.5-moe": (1, 512, 32, 8, 128),
         "llama3-8b": (1, 2048, 32, 8, 128), "recurrentgemma-9b": (1, 512, 16, 1, 256)}
DECODE = {"qwen1.5-0.5b": (8, 2048, 16, 16, 64), "phi3.5-moe": (8, 2048, 32, 8, 128),
          "recurrentgemma-9b": (8, 2048, 16, 1, 256)}
PREFIX = [96, 544, 300, 65, 64, 1, 2048, 411]
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
    for name, (b, s, nq, nkv, hd) in FLASH.items():
        if hd not in fa.SUPPORTED_HEAD_DIMS:
            out[f"flash {name}"] = None          # a tree from before this head dim
            continue
        q, k, v = rand(b, s, nq, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
        out[f"flash {name}"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), flush,
                                       args.iters)
    valid = torch.arange(2048, device=dev)[None, :] < torch.tensor(PREFIX, device=dev)[:, None]
    for name, (b, s, nq, nkv, hd) in DECODE.items():
        if hd not in da.SUPPORTED_HEAD_DIMS:
            out[f"decode {name}"] = None
            continue
        q, k, v = rand(b, nq, hd), rand(b, s, nkv, hd), rand(b, s, nkv, hd)
        out[f"decode {name}"] = time_ms(lambda: da.decode_attention(q, k, v, valid), flush,
                                        args.iters)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
