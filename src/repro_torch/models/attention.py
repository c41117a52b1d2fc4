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
cache is made.  A DTensor cache (a partitioned step) is written the same
way on each rank's local shard (``write_slots``, ``_write_prefill_cache``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import flatten, local_call, shard, unflatten_last
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
    return unflatten_last(x @ flatten(w, 1), n, h)


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
    return flatten(out, -2) @ flatten(wo, 0)


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
    q = shard(q, "batch", "seq_act", "heads", None)
    k = shard(k, "batch", "seq_act", "kv_heads", None)
    v = shard(v, "batch", "seq_act", "kv_heads", None)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = shard(out, "batch", "seq_act", "heads", None)
    y = _out_proj(out, p["wo"])
    if cache is not None:
        cache = _write_prefill_cache(cache, k, v, positions, window)
    return y, cache


def _write_prefill_cache(cache, k, v, positions, window):
    """Write a prefilled sequence into the (possibly ring) cache, in place.

    A DTensor cache (a partitioned prefill) is written by ``local_map`` on
    its own placements, each rank its batch and KV heads: DTensor has no
    sharding rule for the in-place ``index_put_`` of the slots on some
    torch releases (2.11).  Its sequence must not be split (the prefill
    rules leave ``kv_seq`` whole); K and V are redistributed to the cache's
    placements, the positions replicated (no collective where K and V are
    split as the cache is)."""
    if isinstance(cache["k"], DTensor):
        mesh, c_pl = cache["k"].device_mesh, tuple(cache["k"].placements)
        if any(isinstance(p, Shard) and p.dim == 1 for p in c_pl):
            raise ValueError(f"a prefill cache split along its sequence: {c_pl}")
        sp_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in c_pl)

        def local(ck, cv, csp, k_, v_, pos):
            _write_prefill_cache({"k": ck, "v": cv, "slot_pos": csp}, k_, v_, pos, window)

        local_call(local, mesh, (c_pl, c_pl, sp_pl, c_pl, c_pl, (Replicate(),) * mesh.ndim),
                   None, cache["k"], cache["v"], cache["slot_pos"], k, v, positions)
        return cache
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
    write_slots(cache["k"], slot, k[:, 0].to(cache["k"].dtype))
    write_slots(cache["v"], slot, v[:, 0].to(cache["v"].dtype))
    write_slots(cache["slot_pos"], slot, t)
    cache["k"] = shard(cache["k"], "batch", "kv_seq", "kv_heads", None)
    cache["v"] = shard(cache["v"], "batch", "kv_seq", "kv_heads", None)
    sp = cache["slot_pos"]

    valid = (sp >= 0) & (sp <= t[:, None])            # (B, S_cache)
    if window:
        valid &= sp > (t[:, None] - window)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)  # (B,nq,hd)
    y = _out_proj(out, p["wo"])[:, None, :]
    return y, cache


def write_slots(cache: torch.Tensor, slot: torch.Tensor, value: torch.Tensor) -> None:
    """``cache[b, slot[b]] = value[b]`` for every sequence b, in place.

    On a DTensor cache (a partitioned decode step) DTensor has no rule for
    an in-place ``index_put_`` on a cache sharded along the written dims
    (batch, ``kv_seq``, ``kv_heads``), so the write goes through
    ``local_map`` on the cache's own placements: ``slot`` and ``value``
    are redistributed to match it (``slot`` replicated or split with the
    batch, ``value`` split as the cache's batch and trailing dims), and
    each rank writes the slots that fall in its part of the sequence and
    drops the rest (read, select, write: no host sync, no collective)."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = value
        return
    mesh, c_pl = cache.device_mesh, tuple(cache.placements)
    slot_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                    for p in c_pl)
    v_pl = tuple(Shard(p.dim - 1 if p.dim > 1 else 0)
                 if isinstance(p, Shard) and p.dim != 1 else Replicate() for p in c_pl)
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, c_pl)
    first = offset[1]

    def local(c, sl, val):
        loc = sl.long() - first
        keep = (loc >= 0) & (loc < c.shape[1])
        b = torch.arange(c.shape[0], device=c.device)
        loc = loc.clamp(0, c.shape[1] - 1)
        keep = keep.view(-1, *([1] * (val.dim() - 1)))
        c[b, loc] = torch.where(keep, val.to(c.dtype), c[b, loc])

    local_call(local, mesh, (c_pl, slot_pl, v_pl), None, cache, slot, value)


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
