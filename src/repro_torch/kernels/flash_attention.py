"""FlashAttention prefill on the card: wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces the TPU kernel ``repro/kernels/flash_attention.py``
(see the note at the top of the source).  This wrapper checks its operands,
allocates the output, launches on the current stream and counts launches.
It takes CUDA tensors only; ``ops.flash_attention`` sends CPU tensors to
the plain version in ``ref.py``, and differentiates CUDA ones through an
autograd Function around this wrapper, which itself refuses an input that
requires a gradient under grad mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 256)

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (q, k, v, out) pointers, dtype code and shape ints, scale, device, stream
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# (a, d_ss, d_rs) pointers, device, stream
_PROBE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def flash_attention(
    q: torch.Tensor,                 # (B, Sq, nq, hd)
    k: torch.Tensor,                 # (B, Sk, nkv, hd)
    v: torch.Tensor,                 # (B, Sk, nkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention of every query row, (B, Sq, nq, hd), in q's dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or nq % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported, only {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported")
    if min(b, sq, sk) == 0 or window < 0 or q_offset < 0:
        raise ValueError(
            f"empty input or negative window/offset: {b=} {sq=} {sk=} {window=} {q_offset=}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, q.device, q.dtype)
    _build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.function("flash_attention", "fa_forward", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, sq, sk, nq, nkv, hd,
        int(causal), int(window), int(q_offset), hd ** -0.5, q.device.index, stream,
    )
    _build.raise_on_error("flash_attention", err)
    launches += 1
    return out


def tf32_probe(a: torch.Tensor):
    """The f32 kernel's one-tile probe of the tensor cores: ``a`` A (64, 8)
    f32 on the card times the 8 x 8 identity by wgmma .tf32, A once from
    shared memory and once from registers in the A fragment's layout.
    Returns (d_ss, d_rs), each (64, 8): the values the tensor cores read
    from ``a``.  Not counted as a launch of the kernel."""
    if a.device.type != "cuda" or a.dtype != torch.float32 or tuple(a.shape) != (64, 8):
        raise ValueError(f"tf32_probe takes a (64, 8) f32 CUDA tensor, got {a.shape} {a.dtype}")
    a = a.contiguous()
    d_ss, d_rs = torch.empty_like(a), torch.empty_like(a)
    err = _build.function("flash_attention", "fa_tf32_probe", _PROBE_ARGTYPES)(
        a.data_ptr(), d_ss.data_ptr(), d_rs.data_ptr(), a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.raise_on_error("flash_attention tf32 probe", err)
    return d_ss, d_rs
