"""Flash-decode on the card: wrapper of ``csrc/decode_attention.cu``.

The CUDA kernel replaces the TPU kernel ``repro/kernels/decode_attention.py``
(see the note at the top of the source).  This wrapper checks its operands,
allocates the output, launches on the current stream and counts launches.
It takes CUDA tensors only; ``ops.decode_attention`` sends CPU tensors to
the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP_ELEMS = 1024   # (nq / nkv) * hd: one CTA's p v outputs over 256 threads x 4

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (q, k, v, valid, out) pointers, dtype code and shape ints, scale, device, stream
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


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
    if (nq // nkv) * hd > MAX_GROUP_ELEMS:
        raise ValueError(f"group of {nq // nkv} heads x {hd} exceeds {MAX_GROUP_ELEMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported")
    if b == 0 or s == 0:
        raise ValueError(f"empty input: {b=} {s=}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _build.check_operand(name, t, q.device, q.dtype)
    if valid.device != q.device or not valid.is_contiguous():
        raise ValueError("valid must be contiguous and on q's device")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.function("decode_attention", "da_forward", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, s, nq, nkv, hd,
        hd ** -0.5, q.device.index, stream,
    )
    _build.raise_on_error("decode_attention", err)
    launches += 1
    return out
