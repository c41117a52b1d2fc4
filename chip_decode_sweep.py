#!/usr/bin/env python3
"""Where a decode-attention call's time goes on one NVIDIA GPU, at
``chip_smoke.py``'s served decode shapes (bf16, prefix masks of the main
path's lengths; llama3-8b's 4096-slot cache under chip_smoke's random mask,
and its whole 2048-slot cache):

- the kernel of this checkout at each cluster size C, the wrapper's
  ``cluster_plan`` set aside (``"C=n"``), and at the size the wrapper picks
  (``"plan"``, ``"plan_ms"``);
- the same call on a cache with no valid slot (``"all_masked_ms"``): no
  tile is copied, so what is left is the launch, the mask read, the merge
  and the output;
- the timing floor (``"floor_ms"``): a one-element add on the card, timed
  the same way.

  python3 chip_decode_sweep.py [--iters N]

Timing is chip_smoke.py's: median of CUDA events around single calls, the
L2 flushed and ~0.1 ms of device sleep queued before each.  Prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

import chip_smoke as cs
from repro_torch.kernels import decode_attention as da

SWEEP = (1, 2, 3, 4, 5, 6, 8, 16)
LENGTHS = [96, 544, 300, 65, 64, 1, 2048, 411]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_decode_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = cs.L2Flush(dev)
    one = torch.zeros(1, device=dev)
    out = {"gpu": torch.cuda.get_device_name(0),
           "floor_ms": cs.time_ms(lambda: one.add_(1), flush, args.iters)}
    shapes = dict(cs.DECODE_SHAPES)
    shapes["llama3_8b full 2048"] = (8, 2048, 32, 8, 128)
    plan = da.cluster_plan
    for name, (b, s, nq, nkv, hd) in shapes.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd)))
        if name == "llama3_8b":
            valid = torch.rand((b, s), generator=gen, device=dev) < 0.7
        else:
            valid = cs.prefix_valid([min(n, s) for n in LENGTHS] if "full" not in name else [s] * b,
                                    s, dev)
        if name == cs.WHISPER_ARCH:
            valid = cs.prefix_valid([cs.WHISPER_PROMPT + cs.NEW_TOKENS] * b, s, dev)
        call = lambda mask=valid: da.decode_attention(q, k, v, mask)   # noqa: E731
        row = {}
        try:
            for c in SWEEP:
                if c <= -(-s // da.TILE):
                    da.cluster_plan = lambda *_, c=c, **__: c
                    row[f"C={c}"] = cs.time_ms(call, flush, args.iters)
        finally:
            da.cluster_plan = plan
        row["plan"] = da.clusters_for(b, s, nq, nkv, hd, q.dtype, dev)
        row["plan_ms"] = cs.time_ms(call, flush, args.iters)
        row["all_masked_ms"] = cs.time_ms(lambda: call(torch.zeros_like(valid)), flush,
                                          args.iters)
        out[name] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main()
