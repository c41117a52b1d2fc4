"""Flash-decode on the card: wrapper of ``csrc/decode_attention.cu``.

The CUDA kernel replaces the TPU kernel ``repro/kernels/decode_attention.py``
(see the note at the top of the source).  This wrapper checks its operands,
allocates the output and the split partials, launches on the current
stream and counts launches: one per call, whether the call runs one CUDA
kernel or the split kernel and its combine.  Any GQA group size is taken:
the kernel cuts a group whose outputs one warp cannot hold (more than 1024
heads x hd on the SIMT path) into chunks of heads, one CTA each.  It takes CUDA tensors only;
``ops.decode_attention`` sends CPU tensors to the plain version in
``ref.py`` (``ref.decode_attention_split_reference`` is the plain version
of the split and combine).  Decoding takes no gradient: the wrapper refuses
an input that requires one under grad mode.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
MIN_SPLIT_SLOTS = 64     # a split owns at least one 64-slot tile
CTAS_PER_SM = 2          # what the split count aims at

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (q, k, v, valid, out, partials) pointers, dtype code and shape and split
# ints, scale, device, stream
_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)

_sm_counts = {}


def split_plan(b: int, nkv: int, s: int, sm_count: int) -> Tuple[int, int]:
    """``(splits, chunk)``: how the kernel cuts each sequence's S cache slots.

    Split ``i`` owns slots ``[i * chunk, (i + 1) * chunk)``, the last one up
    to ``s`` (``ref.split_ranges``); every range holds at least ``MIN_SPLIT_SLOTS`` slots (or all
    ``s`` when there is one split).  The count aims at ``CTAS_PER_SM`` CTAs
    of (split, kv head, sequence) per SM and is 1 once ``b * nkv`` alone
    reaches that.  It depends on shapes only, never on ``valid``, so
    choosing it costs no host sync."""
    want = -(-CTAS_PER_SM * sm_count // (b * nkv))
    k = min(want, s // MIN_SPLIT_SLOTS)
    if k <= 1:
        return 1, s
    chunk = MIN_SPLIT_SLOTS * -(-s // (MIN_SPLIT_SLOTS * k))   # whole tiles, <= k ranges
    splits = -(-s // chunk)
    if s - (splits - 1) * chunk < MIN_SPLIT_SLOTS:               # the last one joins its neighbour
        splits -= 1
    return (splits, chunk) if splits > 1 else (1, s)


def _sm_count(device: torch.device) -> int:
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device.index]


def decode_attention(
    q: torch.Tensor,                 # (B, nq, hd) — one token per sequence
    k_cache: torch.Tensor,           # (B, S, nkv, hd)
    v_cache: torch.Tensor,           # (B, S, nkv, hd)
    valid: torch.Tensor,             # (B, S) bool
) -> torch.Tensor:
    """Attention of each sequence's token over its valid slots, (B, nq, hd)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}"
        )
    b, nq, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or nq % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if tuple(valid.shape) != (b, s) or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be a ({b}, {s}) bool tensor, got {valid.dtype} {tuple(valid.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported")
    if b == 0 or s == 0:
        raise ValueError(f"empty input: {b=} {s=}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand(name, t, q.device, q.dtype)
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("valid must be contiguous and on q's device")
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    out = torch.empty_like(q)
    splits, chunk = split_plan(b, nkv, s, _sm_count(q.device))
    # per (sequence, q head, split): max and sum, then the hd accumulators
    part = (torch.empty(b * nq * splits * (hd + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.function("decode_attention", "da_forward", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, s, nq, nkv, hd, splits, chunk,
        hd ** -0.5, q.device.index, stream,
    )
    _build.raise_on_error("decode_attention", err)
    launches += 1
    return out
