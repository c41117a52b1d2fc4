"""Dispatch of the kernels' hot spots by the device the tensors lie on.

  * a CPU tensor goes to the plain version in ``ref.py``;
  * a CUDA tensor launches the hand-written kernel, which raises on what it
    cannot take: there is no fallback to the plain version.
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
