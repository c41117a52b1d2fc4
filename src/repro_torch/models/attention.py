"""Attention blocks: full/causal, sliding-window, GQA, with KV cache decode.

Cache contract (per attention layer):
  ``k``/``v``      : (B, S_cache, n_kv, head_dim)
  ``slot_pos``     : (B, S_cache) int32 — absolute position held in each slot,
                     -1 when empty.  Full caches write slot = pos; windowed
                     caches write slot = pos % window (ring buffer).  RoPE is
                     applied at WRITE time, so ring overwrites are safe.
The per-sequence decode position ``t`` (B,) lives at the cache-tree top level
and is shared by all layers — per-sequence so continuous batching can decode
ragged batches in lockstep.

Unlike the JAX package, whose arrays are immutable, the port writes the
cache in place (``copy_``/``index_put_``): a layer's cache entries are views
of the model's layer-stacked cache tensors, so no per-step copy of the
cache is made.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import boxed_normal, boxed_zeros


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32,
                   device="cuda") -> dict:
    """Projections wq, wk, wv (d, heads, hd) and wo (nq, hd, d), biases with
    ``qkv_bias``; whisper's cross-attention uses the same shapes."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = d ** -0.5
    p = {
        "wq": boxed_normal(gen, (d, nq, hd), ("embed", "heads", None), s, dtype, device),
        "wk": boxed_normal(gen, (d, nkv, hd), ("embed", "kv_heads", None), s, dtype, device),
        "wv": boxed_normal(gen, (d, nkv, hd), ("embed", "kv_heads", None), s, dtype, device),
        "wo": boxed_normal(gen, (nq, hd, d), ("heads", None, "embed"), (nq * hd) ** -0.5, dtype,
                           device),
    }
    if cfg.qkv_bias:
        p["bq"] = boxed_zeros((nq, hd), ("heads", None), dtype, device)
        p["bk"] = boxed_zeros((nkv, hd), ("kv_heads", None), dtype, device)
        p["bv"] = boxed_zeros((nkv, hd), ("kv_heads", None), dtype, device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, n, h) -> contiguous (B, S, n, h)."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _project_qkv(cfg: ModelConfig, p: dict, x_q, x_kv):
    q = _proj(x_q, p["wq"])
    k = _proj(x_kv, p["wk"])
    v = _proj(x_kv, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(..., nq, hd) x (nq, hd, d) -> (..., d)."""
    nq, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], nq * hd) @ wo.reshape(nq * hd, d)


def init_layer_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, nkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, nkv, hd), dtype=dtype, device=device),
        "slot_pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def attention_full(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # (B, S, d)
    positions: torch.Tensor,       # (S,)
    *,
    window: int = 0,
    causal: bool = True,
    cache: Optional[dict] = None,  # if given, prefill: populate and return it
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence attention (training / prefill)."""
    q, k, v = _project_qkv(cfg, p, x, x)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    y = _out_proj(out, p["wo"])
    if cache is not None:
        cache = _write_prefill_cache(cache, k, v, positions, window)
    return y, cache


def _write_prefill_cache(cache, k, v, positions, window):
    """Write a prefilled sequence into the (possibly ring) cache, in place."""
    cache_len = cache["k"].shape[1]
    b, s = k.shape[0], k.shape[1]
    if window and cache_len < s:
        # ring cache shorter than the sequence: only the tail survives
        pos_tail = positions[-cache_len:]
        order = torch.argsort(pos_tail % cache_len)
        cache["k"].copy_(k[:, -cache_len:][:, order])
        cache["v"].copy_(v[:, -cache_len:][:, order])
        cache["slot_pos"].copy_(pos_tail[order].to(torch.int32)[None, :].expand(b, cache_len))
        return cache
    # full cache (or ring larger than seq): slot = pos (% cache_len)
    slots = positions % cache_len
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]
    return cache


def attention_decode(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # (B, 1, d)
    t: torch.Tensor,               # (B,) int32 — per-sequence absolute position
    cache: dict,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, dict]:
    """One-token decode against the cache; returns (out (B,1,d), the cache)."""
    b = x.shape[0]
    t = t.to(torch.int32).expand(b)
    q, k, v = _project_qkv(cfg, p, x, x)
    q = apply_rope(q, t[:, None], cfg.rope_theta)
    k = apply_rope(k, t[:, None], cfg.rope_theta)

    cache_len = cache["k"].shape[1]
    slot = (t % cache_len).long()                     # (B,)
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["slot_pos"][bidx, slot] = t
    sp = cache["slot_pos"]

    valid = (sp >= 0) & (sp <= t[:, None])            # (B, S_cache)
    if window:
        valid &= sp > (t[:, None] - window)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)  # (B,nq,hd)
    y = _out_proj(out, p["wo"])[:, None, :]
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder). KV computed once from the encoder output.
# ---------------------------------------------------------------------------
def cross_attention_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """(B, S_enc, d) -> k, v (B, S_enc, nkv, hd)."""
    k = _proj(enc_out, p["wk"])
    v = _proj(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(B, Sq, d) decoder rows against the encoder's k, v -> (B, Sq, d):
    non-causal flash attention, in prefill and at Sq = 1 in each decode
    step alike, as the JAX package runs it."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    out = ops.flash_attention(q, k, v, causal=False)
    return _out_proj(out, p["wo"])
