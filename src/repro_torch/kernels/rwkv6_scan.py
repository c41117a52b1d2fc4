"""RWKV-6 WKV recurrence on the card: wrapper of ``csrc/rwkv6_scan.cu``.

The CUDA kernels replace the TPU kernel ``repro/kernels/rwkv6_scan.py``
(see the note at the top of the source): a streaming kernel for one token,
and for more, in f32 and bf16, one kernel launched once over a
thread-block cluster per sequence (``cluster_plan``), which carries the
state from rank to rank in distributed shared memory: no scratch in device
memory.  This wrapper checks its operands, allocates the output and the
final state unless it is given one, picks the cluster's ranks, launches on
the current stream and counts one launch per call.  It takes CUDA tensors
only; ``ops.rwkv6`` sends CPU tensors to the plain version in ``ref.py``
(``ref.rwkv6_cluster_reference`` is the plain version of the T > 1
kernel's schedule and arithmetic), and differentiates CUDA ones through an
autograd Function around this wrapper, which itself refuses an input that
requires a gradient under grad mode.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
#: tokens per chunk of the kernels
CHUNK = ref.RWKV_CHUNK
#: ranks of a cluster at most: 16 is a non-portable cluster size, which the
#: card may refuse; ``max_ranks`` falls back to the portable 8 only then
R_MAX = ref.RWKV_R_MAX
R_PORTABLE = 8

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (r, k, v, w, u, s0, sT, out) pointers, dtype code, shape and rank ints,
# device, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int, ctypes.c_void_p]
_CLUSTER_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]

_at_once = {}


class ClusterPlan(NamedTuple):
    """The T > 1 kernel's grid: one cluster of ``ranks`` CTAs per (b, h),
    rank q taking chunks ``runs[q] = (first, count)`` of the ``chunks``
    32-token chunks."""
    ranks: int
    chunks: int
    runs: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int, int]


def cluster_plan(b: int, t: int, h: int, hd: int, dtype: torch.dtype,
                 r_max: int = R_MAX) -> ClusterPlan:
    """``ranks = min(ceil(t / 32), r_max)``, each rank a contiguous run of
    chunks, the first ``chunks % ranks`` one longer
    (``ref.rwkv6_rank_runs``); grid ``(ranks, h, b)``.  Shapes only: the
    same for f32 and bf16 and every head dim the kernel takes."""
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {dtype} not supported")
    if not 1 <= r_max <= R_MAX:
        raise ValueError(f"r_max must be in [1, {R_MAX}], got {r_max}")
    nc = -(-t // CHUNK)
    ranks = min(nc, r_max)
    return ClusterPlan(ranks, nc, tuple(ref.rwkv6_rank_runs(nc, ranks)), (ranks, h, b))


def rwkv6_scan(
    r: torch.Tensor,                 # (B, T, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,                 # decay in (0, 1)
    u: torch.Tensor,                 # (H, hd) f32
    state: Optional[torch.Tensor] = None,        # (B, H, hd, hd) f32; None = zeros
    *,
    final_state: Optional[torch.Tensor] = None,  # (B, H, hd, hd) f32, written in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, T, H, hd) in r's dtype, state after the last token, f32).

    ``final_state``, when given, receives the final state and is returned;
    it may be ``state`` itself, which is then updated in place (whatever
    reads an element of the state does so before any element is written:
    a thread of the one-token kernel its own elements, the cluster's rank 0
    before the barrier after which its last rank writes)."""
    global launches
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan kernel takes CUDA tensors, got {dev}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(
            f"r, k, v, w must share one (B, T, H, hd) shape, got "
            f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, hd = r.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if r.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {r.dtype} not supported")
    if b == 0 or t == 0 or h == 0:
        raise ValueError(f"empty input: {b=} {t=} {h=}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be ({h}, {hd}), got {tuple(u.shape)}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        _build.check_operand(name, x, dev, r.dtype)
    _build.check_operand("u", u, dev, torch.float32)
    for name, x in (("state", state), ("final_state", final_state)):
        if x is not None:
            if tuple(x.shape) != (b, h, hd, hd):
                raise ValueError(f"{name} must be ({b}, {h}, {hd}, {hd}), got {tuple(x.shape)}")
            _build.check_operand(name, x, dev, torch.float32)
    _build.refuse_grad("rwkv6_scan", r, k, v, w, u, state)
    out = torch.empty_like(r)
    if final_state is None:
        final_state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    ranks = 1 if t == 1 else cluster_plan(b, t, h, hd, r.dtype,
                                          max_ranks(r.dtype, hd, dev)).ranks
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.function("rwkv6_scan", "rwkv6_forward", _ARGTYPES)(
        *(x.data_ptr() if x is not None else None
          for x in (r, k, v, w, u, state, final_state, out)),
        _build.DTYPE_CODES[r.dtype], b, t, h, hd, ranks, dev.index, stream,
    )
    _build.raise_on_error("rwkv6_scan", err)
    launches += 1
    return out, final_state


def max_active_clusters(dtype: torch.dtype, hd: int, ranks: int, device: torch.device,
                        one_chunk: bool = True) -> int:
    """How many clusters of ``ranks`` CTAs the card holds at once for the
    T > 1 kernel of (dtype, hd) (``cudaOccupancyMaxActiveClusters`` at its
    shared memory and registers): the instantiation for one chunk a rank, or
    with ``one_chunk=False`` the one for several; 0 means a call with that
    many ranks raises.  Asked of the card once per argument set, then
    remembered."""
    key = (dtype, hd, ranks, one_chunk, device.index or 0)
    if key not in _at_once:
        n = ctypes.c_int(0)
        err = _build.function("rwkv6_scan", "rwkv6_max_active_clusters", _CLUSTER_ARGTYPES)(
            _build.DTYPE_CODES[dtype], hd, ranks, int(one_chunk), key[-1], ctypes.byref(n))
        _build.raise_on_error("rwkv6_scan", err)
        _at_once[key] = n.value
    return _at_once[key]


def max_ranks(dtype: torch.dtype, hd: int, device: torch.device) -> int:
    """R_MAX (16) where the card holds a cluster of 16 of both (dtype, hd)
    kernels' CTAs, else R_PORTABLE (8); a plan whose cluster the card then
    cannot hold raises in the launch.  Asked once per (dtype, hd)."""
    fits = min(max_active_clusters(dtype, hd, R_MAX, device, one) for one in (True, False))
    return R_MAX if fits >= 1 else R_PORTABLE
