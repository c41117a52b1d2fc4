"""Dispatch of the kernels' hot spots by the device the tensors lie on.

  * a CPU tensor goes to the plain version in ``ref.py``;
  * a CUDA tensor launches the hand-written kernel, which raises on what it
    cannot take: there is no fallback to the plain version.

The RG-LRU recurrence has no kernel: the JAX package runs it as an XLA
associative scan for every ``impl``, and ``rglru`` here is the same
log-depth scan in PyTorch ops on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rwkv


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-sequence attention (B,Sq,nq,hd)x(B,Sk,nkv,hd)->(B,Sq,nq,hd)."""
    if _device_type(q) == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if (
        causal and window > 0 and q.shape[1] == k.shape[1]
        and q.shape[1] > 2 * window and q_offset == 0
    ):
        # a sliding window pays for itself only computed block-locally:
        # O(S*2W) logits instead of the masked O(S^2)
        return ref.local_attention_blocked(q, k, v, window=window, q_offset=q_offset)
    return ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid):
    """Single-token decode attention (B,nq,hd) vs (B,S,nkv,hd)."""
    if _device_type(q) == "cuda":
        return _da.decode_attention(q, k_cache, v_cache, valid)
    return ref.decode_attention_reference(q, k_cache, v_cache, valid)


def rwkv6(r, k, v, w, u, state=None, *, final_state=None):
    """RWKV-6 WKV recurrence (B,T,H,hd) -> (out, final state f32).

    ``final_state``, when given, receives the final state (it may be
    ``state`` itself: the decode cache is updated in place)."""
    if _device_type(r) == "cuda":
        return _rwkv.rwkv6_scan(r, k, v, w, u, state, final_state=final_state)
    out, s = ref.rwkv6_reference(r, k, v, w, u, state)
    if final_state is None:
        return out, s
    return out, final_state.copy_(s)


def rglru(x, a, h0=None):
    """RG-LRU ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t`` over (B, T, D)
    -> (h in x's dtype, final state (B, D) f32)."""
    return _rglru_assoc(x, a, h0)


def _rglru_assoc(x, a, h0=None):
    """The recurrence as an inclusive scan of the pairs (a_t, b_t) under
    ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``, in f32: ceil(log2 T)
    elementwise steps, each combining every pair with the one ``off``
    steps before it (Hillis-Steele).  ``h0`` is folded into step 0's
    additive term, as the JAX package folds it."""
    a32 = a.float()
    b = torch.sqrt(torch.clamp(1.0 - a32 * a32, min=0.0)) * x.float()
    if h0 is not None:
        b[:, 0] += a32[:, 0] * h0.float()
    t, off = x.shape[1], 1
    while off < t:
        b = torch.cat([b[:, :off], a32[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        if 2 * off < t:      # the last step needs no products of a
            a32 = torch.cat([a32[:, :off], a32[:, :-off] * a32[:, off:]], dim=1)
        off *= 2
    return b.to(x.dtype), b[:, -1]
