"""Where the RWKV-6 scan kernel's time goes on the card, phase by phase.

Builds ``csrc/rwkv6_scan.cu`` a second time with its ``RWKV6_STAMP`` hook
defined: each CTA's thread 0 records ``clock64`` at every phase boundary of
the T > 1 kernel (set-up, the first copies, the chunk terms and their
parts, pass 1's products, the composite's publication, the carry's first
cluster barrier, its transfer, its second barrier, the carry-in, pass 2)
and ``%globaltimer`` at its start and end, with its SM.  Then runs the main-path shapes once each and
prints, as one JSON line a shape, the median over the CTAs of each phase's
cycles, the CTAs' spans (start, end, duration in microseconds on the global
timer) summarised, and the kernel's CUDA-event time beside it.  The stamped
build is not the library: its times include the stamps' own cost (a few
instructions of thread 0 a phase).

    python3 chip_scan_phases.py          # on a machine with the card
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402

MAX_CTAS = 8192
STAMPS = 24
# each phase by the stamp at its end (csrc/rwkv6_scan.cu's RWKV6_STAMP)
PHASES = {1: "first copies", 2: "chunk terms", 3: "pass-1 products and A",
          4: "composite published", 5: "carry barrier 1", 6: "carry transfer",
          7: "carry barrier 2", 8: "carry-in read", 10: "pass-2 copies and terms",
          11: "pass-2 products and store", 12: "exit"}
# the chunk terms, split: every level's rows of A, r 2^P and the decayed k;
# A's 496 dot products and the bonus; A's tile parts
SPLIT = {"level rows, r 2^P, decayed k": (1, 13), "(3) and A's dot products": (13, 15),
         "A's parts and (1)": (15, 3)}
SOURCE = f"""
__device__ long long g_clock[{MAX_CTAS}][{STAMPS}];
__device__ unsigned long long g_span[{MAX_CTAS}][2];
__device__ int g_sm[{MAX_CTAS}];
__device__ __forceinline__ int stamp_cta() {{
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}}
__device__ __forceinline__ unsigned long long global_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define RWKV6_STAMP(k)                                                        \\
  do {{                                                                       \\
    if (threadIdx.x == 0 && stamp_cta() < {MAX_CTAS}) {{                      \\
      g_clock[stamp_cta()][(k)] = clock64();                                  \\
      if ((k) == 0) {{                                                        \\
        g_span[stamp_cta()][0] = global_ns();                                 \\
        int sm;                                                               \\
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                       \\
        g_sm[stamp_cta()] = sm;                                               \\
      }}                                                                      \\
      if ((k) == 12) g_span[stamp_cta()][1] = global_ns();                    \\
    }}                                                                        \\
  }} while (0)
#include "rwkv6_scan.cu"
extern "C" int stamps_clear() {{
  static long long zc[{MAX_CTAS}][{STAMPS}];
  return (int)cudaMemcpyToSymbol(g_clock, zc, sizeof(zc));
}}
extern "C" int stamps_read(long long* clk, unsigned long long* span, int* sm) {{
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clock, sizeof(g_clock));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(span, g_span, sizeof(g_span));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));
  return (int)e;
}}
"""

# (name, shape, dtype, ranks: None for the plan's); the served prefill also
# at 9 ranks (the most that fit one wave, runs of 2 chunks as at the plan's
# 8) and at 16 of one chunk in two waves, and the training forward at 4
# ranks of one chunk in three: plans the wrapper does not take
SHAPES = [("served prefill bf16", (1, 500, 32, 64), torch.bfloat16, None),
          ("training forward f32", (4, 128, 32, 64), torch.float32, None),
          ("served prefill f32", (1, 500, 32, 64), torch.float32, None),
          ("T=2048 bf16", (1, 2048, 4, 64), torch.bfloat16, None),
          ("served prefill bf16, 9 ranks", (1, 500, 32, 64), torch.bfloat16, 9),
          ("served prefill bf16, 16 ranks", (1, 500, 32, 64), torch.bfloat16, 16),
          ("training forward f32, 4 ranks", (4, 128, 32, 64), torch.float32, 4),
          ("served prefill bf16, no state", (1, 500, 32, 64), torch.bfloat16, None)]


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "rwkv6_scan_stamped.so"
    src = _build.BUILD_DIR / "rwkv6_scan_stamped.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(SOURCE)
    cmd = [_build.nvcc_path(), *[f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")],
           "-I", str(_build.CSRC), "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.rwkv6_forward.argtypes = rk._ARGTYPES
    lib.stamps_read.argtypes = [ctypes.c_void_p] * 3
    lib.rwkv6_max_active_clusters.argtypes = rk._CLUSTER_ARGTYPES
    return lib


def at_once(lib, dtype, hd, dev):
    """``rwkv6_scan.max_active_clusters`` asked of the stamped library, as
    ``cluster_plan`` takes it: the main one is never loaded here, since the
    two would share the host code's function-local statics (GNU unique
    symbols), and with them the record of which kernel's cluster attributes
    were set."""
    def count(ranks, one_chunk):
        n = ctypes.c_int(0)
        err = lib.rwkv6_max_active_clusters(_build.DTYPE_CODES[dtype], hd, ranks, int(one_chunk),
                                            dev.index or 0, ctypes.byref(n))
        if err:
            raise RuntimeError(f"rwkv6_max_active_clusters failed with cudaError_t {err}")
        return n.value
    return count


def inputs(b, t, h, hd, dtype, dev, seed=0, state=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    sh = (b, t, h, hd)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v = rn(*sh) * 0.5, rn(*sh) * 0.5, rn(*sh)
    w = torch.sigmoid(rn(*sh) * 2 - 1) * 0.5 + 0.45
    return [x.to(dtype) for x in (r, k, v, w)] + [rn(h, hd) * 0.3,
                                                  rn(b, h, hd, hd) * 0.2 if state else None]


def run(lib, args, ranks, dev):
    r, k, v, w, u, s0 = args
    b, t, h, hd = r.shape
    out = torch.empty_like(r)
    st = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    err = lib.rwkv6_forward(*(x.data_ptr() if x is not None else None
                              for x in (r, k, v, w, u, s0, st, out)),
                            _build.DTYPE_CODES[r.dtype], b, t, h, hd, ranks, dev.index or 0,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"stamped rwkv6_forward failed with cudaError_t {err}")
    return out, st


def event_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(1_000_000)
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ts.append(ev[0].elapsed_time(ev[1]))
    return sorted(ts)[len(ts) // 2]


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_scan_phases.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    lib = build()
    for name, (b, t, h, hd), dtype, forced in SHAPES:
        args = inputs(b, t, h, hd, dtype, dev, state="no state" not in name)
        count = at_once(lib, dtype, hd, dev)
        ranks = forced or rk.cluster_plan(b, t, h, hd, dtype, count).ranks
        clusters_at_once = count(ranks, ranks == -(-t // rk.CHUNK))
        n = b * h * ranks
        ms = event_ms(lambda: run(lib, args, ranks, dev))
        lib.stamps_clear()
        torch.cuda.synchronize()
        run(lib, args, ranks, dev)
        torch.cuda.synchronize()
        clk = (ctypes.c_longlong * (MAX_CTAS * STAMPS))()
        span = (ctypes.c_ulonglong * (MAX_CTAS * 2))()
        sm = (ctypes.c_int * MAX_CTAS)()
        if lib.stamps_read(clk, span, sm):
            raise RuntimeError("stamps_read failed")
        phases = {}
        for p, phase in PHASES.items():  # each stamp against the last one the CTA wrote
            d = []
            for c in range(n):
                row = clk[c * STAMPS:(c + 1) * STAMPS]
                prev = [row[i] for i in range(p) if row[i]]
                if row[p] and prev:
                    d.append(row[p] - prev[-1])
            if d:
                phases[phase] = median(d)
        # pass 1's chunk terms where they include the outputs' (one chunk a
        # rank): stamps 13, 14, 15 inside them
        split = {}
        for key, (lo, hi) in SPLIT.items():
            d = [clk[c * STAMPS + hi] - clk[c * STAMPS + lo] for c in range(n)
                 if clk[c * STAMPS + hi] and clk[c * STAMPS + lo]]
            if d and ranks == -(-t // rk.CHUNK):
                split[key] = median(d)
        starts = [span[2 * c] for c in range(n)]
        ends = [span[2 * c + 1] for c in range(n)]
        t0 = min(starts)
        dur = [(e - s) / 1e3 for s, e in zip(starts, ends)]
        print(json.dumps({
            "shape": name, "B_T_H_hd": [b, t, h, hd], "ranks": ranks, "ctas": n,
            "clusters_at_once": clusters_at_once, "waves": -(-b * h // clusters_at_once),
            "event_ms": ms, "phase_cycles_median": phases, "chunk_terms_cycles_median": split,
            "cta_us": {"median": median(dur), "max": max(dur)},
            "start_us": {"median": median([(s - t0) / 1e3 for s in starts]),
                         "max": (max(starts) - t0) / 1e3},
            "span_us": (max(ends) - t0) / 1e3, "sms_used": len(set(sm[c] for c in range(n))),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
