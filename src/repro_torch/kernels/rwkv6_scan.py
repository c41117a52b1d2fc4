"""RWKV-6 WKV recurrence on the card: wrapper of ``csrc/rwkv6_scan.cu``.

The CUDA kernels replace the TPU kernel ``repro/kernels/rwkv6_scan.py``
(see the note at the top of the source): a streaming kernel for one token,
and for more, a chunk-parallel prefill on the tensor cores in bf16 or the
SIMT kernel in f32.  This wrapper checks its operands, allocates the output,
the final state unless it is given one, and the bf16 prefill's scratch,
launches on the current stream and counts one launch per call, however many
kernels the call runs.  It takes CUDA tensors only; ``ops.rwkv6`` sends CPU
tensors to the plain version in ``ref.py``, and differentiates CUDA ones
through an autograd Function around this wrapper, which itself refuses an
input that requires a gradient under grad mode.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
#: tokens per chunk of the kernels
CHUNK = 32

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0

# (r, k, v, w, u, s0, sT, out, dstate, decay) pointers, dtype code and shape
# ints, device, stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_int, ctypes.c_void_p]


def scratch_shapes(dtype: torch.dtype, b: int, t: int, h: int, hd: int):
    """Shapes of the f32 scratch a launch needs: for a bf16 prefill of more
    than one chunk, each chunk's state increment (which the carry overwrites
    with the chunk's carry-in state) and its decay; none otherwise."""
    nc = -(-t // CHUNK)
    if dtype != torch.bfloat16 or nc == 1:
        return None
    return (b, h, nc, hd, hd), (b, h, nc, hd)


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
    thread writes an element of the state has read it first, and the
    prefill's output kernel reads copies of it in scratch)."""
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
    shapes = scratch_shapes(r.dtype, b, t, h, hd)
    dstate, decay = ([torch.empty(sh, dtype=torch.float32, device=dev) for sh in shapes]
                     if shapes else (None, None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.function("rwkv6_scan", "rwkv6_forward", _ARGTYPES)(
        *(x.data_ptr() if x is not None else None
          for x in (r, k, v, w, u, state, final_state, out, dstate, decay)),
        _build.DTYPE_CODES[r.dtype], b, t, h, hd, dev.index, stream,
    )
    _build.raise_on_error("rwkv6_scan", err)
    launches += 1
    return out, final_state
