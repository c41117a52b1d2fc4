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
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
#: tokens per chunk of the kernels
CHUNK = ref.RWKV_CHUNK
#: ranks of a cluster at most: 16 is a non-portable cluster size, which a
#: card may refuse (its count of such clusters at once is then 0)
R_MAX = ref.RWKV_R_MAX

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (r, k, v, w, u, s0, sT, out) pointers, dtype code, shape and rank ints,
# device, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_int, ctypes.c_void_p]
_CLUSTER_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]

_at_once = {}
_plans = {}


class ClusterPlan(NamedTuple):
    """The T > 1 kernel's grid: one cluster of ``ranks`` CTAs per (b, h),
    rank q taking chunks ``runs[q] = (first, count)`` of the ``chunks``
    32-token chunks, in ``waves`` waves of clusters (``at_once`` of them
    on the card at a time)."""
    ranks: int
    chunks: int
    runs: Tuple[Tuple[int, int], ...]
    grid: Tuple[int, int, int]
    at_once: int
    waves: int


def cluster_plan(b: int, t: int, h: int, hd: int, dtype: torch.dtype,
                 at_once: Callable[[int, bool], int]) -> ClusterPlan:
    """The ranks R of each of the b h clusters, R <= min(chunks, R_MAX):
    among the R whose clusters all fit on the card at once (one wave), the
    fewest chunks a rank (the longest run, the cluster's critical path) and
    then the fewest ranks (the same path over fewer CTAs carries less); where
    no R fits one wave, the fewest waves x chunks a rank, then the fewest
    ranks.  ``at_once(R, one_chunk)`` is how many clusters of R CTAs the
    card holds at once for the instantiation a plan of R ranks runs (one
    chunk a rank where R is the chunks; ``max_active_clusters``), 0 where it
    holds none, which no plan takes.  Rank q takes a contiguous run of
    chunks, the first ``chunks % R`` one longer (``ref.rwkv6_rank_runs``);
    grid ``(R, h, b)``."""
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {dtype} not supported")
    nc = -(-t // CHUNK)
    clusters = b * h
    fits = {r: n for r in range(1, min(nc, R_MAX) + 1) if (n := at_once(r, r == nc)) >= 1}
    if not fits:
        raise ValueError(f"the card holds no cluster of 1 to {min(nc, R_MAX)} CTAs")
    waves = {r: -(-clusters // n) for r, n in fits.items()}
    one_wave = [r for r in fits if waves[r] == 1]
    if one_wave:
        ranks = min(one_wave, key=lambda r: (-(-nc // r), r))
    else:
        ranks = min(fits, key=lambda r: (waves[r] * -(-nc // r), r))
    return ClusterPlan(ranks, nc, tuple(ref.rwkv6_rank_runs(nc, ranks)), (ranks, h, b),
                       fits[ranks], waves[ranks])


def plan_on(b: int, t: int, h: int, hd: int, dtype: torch.dtype,
            device: torch.device) -> ClusterPlan:
    """``cluster_plan`` with the card's own counts of clusters at once
    (``max_active_clusters``); one per chunk count and shape, then
    remembered."""
    key = (b, -(-t // CHUNK), h, hd, dtype, device.index or 0)
    if key not in _plans:
        _plans[key] = cluster_plan(
            b, t, h, hd, dtype, lambda r, one: max_active_clusters(dtype, hd, r, device, one))
    return _plans[key]


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
    it may be ``state`` itself, which is then updated in place (a thread
    reads an element of the state before it writes that element, and no
    other thread reads it after: in the one-token kernel its own elements,
    in the cluster kernel the elements of the carry its rank owns, rank 0
    of one chunk a rank reading the state for its outputs before the first
    cluster barrier, after which the owners write)."""
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
    ranks = 1 if t == 1 else plan_on(b, t, h, hd, r.dtype, dev).ranks
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
