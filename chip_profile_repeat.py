#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s served prefill profiles on one NVIDIA GPU and
count what each profiler reader misses.

  python3 chip_profile_repeat.py [--runs N] [--seed N]

Builds the kernels as ``chip_smoke.py`` phase 1 does, then runs its slice of
qwen1.5-0.5b (phase 3: 24 layers, 24 flash launches a prefill) and of
kimi-k2-1t-a32b at full width and one layer (phase 3f: one flash launch a
prefill), each through ``chip_smoke.phase_slice`` (the served run, the
decode profile, the prefill profile, the f32 check), with its
``chip_smoke.profile_prefill`` call made ``--runs`` times (default 40) in
this one process.  Each call profiles its 512-token prefill and records the
flash launches by the launch counter, the flash kernel's records and device
µs by ``key_averages`` and by the raw kineto events, and whether the logits
equal the unprofiled warm-up's.  Prints one JSON line a slice with the
profiles taken, the misses of each reader and every profile's readings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

import chip_smoke as smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile_repeat: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = smoke.phase_build()
    traffic = smoke.served_prompts(args.seed)
    qwen = smoke.get_config(smoke.ARCH)
    kimi = dataclasses.replace(smoke.get_config(smoke.KIMI_ARCH), num_layers=smoke.KIMI_LAYERS)

    def repeated(profile_prefill):
        def run(*call_args, **kwargs):
            return [profile_prefill(*call_args, **kwargs) for _ in range(args.runs)]
        return run

    for cfg, f32 in ((qwen, lambda seed, prompt: smoke.f32_check(qwen, seed, prompt)),
                     (kimi, smoke.f32_check_kimi)):
        with smoke.wrapped(smoke, "profile_prefill", repeated):
            calls = smoke.phase_slice(cfg, args.seed, traffic[cfg.name], gpu, f32)["prefill_profile"]
        print(json.dumps({
            "model": cfg.name, "gpu": gpu, "calls": len(calls),
            "profiles": sum(c["profiles_taken"] for c in calls),
            "misses": {reader: sum(c["profile_misses"][reader] for c in calls)
                       for reader in ("key_averages", "raw", "launches")},
            "pad_unrecorded": sum(r["pad_unrecorded"] for c in calls for r in c["profiles"]),
            "unrecorded_launches": sum(len(r["unrecorded"]) for c in calls for r in c["profiles"]),
            "flash_attention_ms": [c["flash_attention_ms"] for c in calls],
            "readings": [r for c in calls for r in c["profiles"]]}))


if __name__ == "__main__":
    main()
