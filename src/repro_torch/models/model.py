"""Composable language model: attention decoders (dense or MoE), RWKV-6,
the Griffin hybrid (RG-LRU and local-attention blocks) and the whisper
encoder-decoder.

The config's ``block_pattern`` repeats over the layers, followed by any
``tail_blocks``; the layers run in that order in a Python loop over
``params["layers"]``.  The decode cache keeps the JAX package's layout (one
tensor per pattern position, stacked over the pattern's repetitions, and
the tail's blocks unstacked) so the serving engine's slot scatter is the
same.  Whisper adds an encoder stack (``params["encoder"]``) over frame
embeddings, and each decoder block a cross-attention to the encoder's
output between its self-attention and its MLP; ``prefill(enc_inputs=)``
stores every layer's cross-attention K/V under ``cache["cross"]``, stacked
over the layers like ``cache["blocks"]["dec"]``.

Entry points
------------
``init_params``  — build the parameter tree from a ``torch.Generator``
                   (``init_params_boxed`` with each leaf's logical axes).
``param_axes``   — logical-axes tree matching ``init_params`` (per-layer
                   dicts: no leading ``"layers"`` axis, unlike the JAX
                   package's stacked blocks).
``abstract_params`` — the parameter tree on the ``meta`` device: shapes and
                   dtypes, nothing allocated or drawn.
``param_count``  — exact parameter count from the shapes (no allocation).
``forward``      — full-sequence logits.
``loss_fn``      — masked next-token cross-entropy plus the weighted aux loss.
``init_cache``   — decode cache for a (batch, cache_len).
``prefill``      — populate the cache from a prompt, return last logits.
``decode_step``  — one token for every sequence in the batch.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RGLRU, RWKV, ModelConfig
from repro_torch.distributed.sharding import axis_rules, current_rules, partitioned, shard
from repro_torch.models import attention as attn_lib
from repro_torch.models import griffin, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.params import axes_of, values_of


def _pattern_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """(n_repeats, pattern, tail) with n_repeats * len(pattern) + len(tail)
    == num_layers."""
    pat, tail = cfg.block_pattern, cfg.tail_blocks
    n_rep = (cfg.num_layers - len(tail)) // len(pat)
    if n_rep * len(pat) + len(tail) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: layers do not tile the block pattern and its tail")
    return n_rep, pat, tail


def block_key(cfg: ModelConfig, i: int, kind: str) -> str:
    """The name of pattern position ``i`` in the cache and in the JAX
    package's parameters: ``p{i}_{kind}``, and ``dec`` for whisper's
    decoder blocks."""
    return "dec" if cfg.is_encoder_decoder else f"p{i}_{kind}"


# ---------------------------------------------------------------------------
# Init and counting.
# ---------------------------------------------------------------------------
def _layer_kinds(cfg: ModelConfig) -> List[str]:
    n_rep, pat, tail = _pattern_layout(cfg)
    return list(pat) * n_rep + list(tail)


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype, device,
                cross: bool = False) -> dict:
    """One block's Boxed parameters; ``cross`` adds whisper's decoder
    cross-attention (``norm_x``, ``xattn``)."""
    if kind == RWKV:     # no MLP: the channel mix is part of the block's params
        return {
            "norm1": layers.init_norm(cfg, dtype, device),
            "rwkv": rwkv_lib.init_rwkv(gen, cfg, dtype=dtype, device=device),
            "norm2": layers.init_norm(cfg, dtype, device),
        }
    if kind == RGLRU:
        return {
            "norm1": layers.init_norm(cfg, dtype, device),
            "rglru": griffin.init_rglru(gen, cfg, dtype=dtype, device=device),
            "norm2": layers.init_norm(cfg, dtype, device),
            "mlp": layers.init_mlp(gen, cfg, dtype=dtype, device=device),
        }
    p = {
        "norm1": layers.init_norm(cfg, dtype, device),
        "attn": attn_lib.init_attention(gen, cfg, dtype=dtype, device=device),
        "norm2": layers.init_norm(cfg, dtype, device),
    }
    if cross:
        p["norm_x"] = layers.init_norm(cfg, dtype, device)
        p["xattn"] = attn_lib.init_attention(gen, cfg, dtype=dtype, device=device)
    if cfg.num_experts:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg, dtype=dtype, device=device)
    return p


def init_params_boxed(cfg: ModelConfig, gen: Optional[torch.Generator], *, dtype=torch.float32,
                      device="cuda") -> Dict[str, Any]:
    """``init_params``' tree with every leaf a ``Boxed(value, axes)``; on the
    meta device ``gen`` may be None (nothing is drawn)."""
    enc_dec = cfg.is_encoder_decoder
    p: Dict[str, Any] = {
        "embed": layers.init_embed(gen, cfg, dtype, device),
        "final_norm": layers.init_norm(cfg, dtype, device),
        "layers": [_init_block(gen, cfg, kind, dtype, device, cross=enc_dec)
                   for kind in _layer_kinds(cfg)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.init_embed(gen, cfg, dtype, device)
    if enc_dec:
        p["encoder"] = {
            "blocks": [_init_block(gen, cfg, ATTN, dtype, device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": layers.init_norm(cfg, dtype, device),
        }
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, *, dtype=torch.float32,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's scales, drawn from ``gen``.
    Whisper's encoder blocks are ``encoder/blocks``, a list like ``layers``."""
    return values_of(init_params_boxed(cfg, gen, dtype=dtype, device=device))


@functools.lru_cache(maxsize=64)
def _param_axes_cached(cfg: ModelConfig, dtype: torch.dtype):
    return axes_of(init_params_boxed(cfg, None, dtype=dtype, device="meta"))


def param_axes(cfg: ModelConfig, dtype=torch.float32):
    """The logical axes of each leaf of ``init_params(cfg)``, a tree of the
    same structure with a tuple at each leaf (built on the meta device)."""
    return _param_axes_cached(cfg, dtype)


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    """``init_params(cfg)``'s tree on the meta device: shapes and dtypes,
    no allocation (dry-run, cost model)."""
    return values_of(init_params_boxed(cfg, None, dtype=dtype, device="meta"))


def param_count(cfg: ModelConfig) -> int:
    """Exact count of ``init_params``' elements, from shapes alone."""
    d, hd, ff, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    norm = d * (2 if cfg.norm == "layernorm" else 1)
    attn = 2 * d * nq * hd + 2 * d * nkv * hd
    if cfg.qkv_bias:
        attn += nq * hd + 2 * nkv * hd
    dense = (3 if cfg.mlp == "swiglu" else 2) * d * ff
    mlp = moe_lib.param_count(cfg) if cfg.num_experts else dense
    embeds = v * d * (1 if cfg.tie_embeddings else 2)
    block = {RWKV: rwkv_lib.param_count(cfg), RGLRU: griffin.param_count(cfg) + dense}
    total = embeds + norm + sum(2 * norm + block.get(kind, attn + mlp)
                                for kind in _layer_kinds(cfg))
    if cfg.is_encoder_decoder:    # decoder cross-attention; the encoder and its final norm
        total += cfg.num_layers * (norm + attn) + cfg.encoder_layers * (2 * norm + attn + dense)
        total += norm
    return total


# ---------------------------------------------------------------------------
# Embedding in/out.
# ---------------------------------------------------------------------------
def _embed_in(cfg: ModelConfig, params, inputs: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings, or precomputed ones (B, S, d) as they are (VLM);
    whisper's decoder scales its token embeddings by sqrt(d) (rounded to the
    model dtype, as the JAX package rounds it) and adds absolute positions
    (``positions`` (S,) or (B, 1))."""
    if inputs.dim() == 3:          # precomputed embeddings (VLM / audio enc)
        return inputs.to(params["embed"].dtype)
    x = layers.embed_tokens(params["embed"], inputs)
    if cfg.is_encoder_decoder:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        x = x + _abs_pos(positions, cfg.d_model).to(x.dtype)
    return x


def _abs_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Absolute sinusoidal positions (..., d_model) in f32 as [sin, cos]
    halves (``layers.sinusoidal_positions`` interleaves them instead)."""
    pos = positions.float()[..., None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=positions.device)
                    * (-math.log(10_000.0) / d_model))
    ang = pos * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    # d^-0.5 keeps init logit variance O(1) (embed tables are unit-scale)
    return (x @ w.T) * (cfg.d_model ** -0.5)


# ---------------------------------------------------------------------------
# Full sequence: forward and prefill.
# ---------------------------------------------------------------------------
def _layer_caches(cfg: ModelConfig, cache) -> List[dict]:
    """Per-layer views of the cache, in the order the layers run:
    ``{"attn": {k, v, slot_pos}}``, ``{"rwkv": {shift_tm, shift_cm, wkv}}``
    or ``{"rglru": {conv, h}}``; the pattern's stacked, then the tail's.
    Once whisper's prefill has stored it, each decoder layer's view also
    holds ``{"cross": {k, v}}``."""
    n_rep, pat, tail = _pattern_layout(cfg)
    trees = [cache["blocks"][block_key(cfg, i, kind)] for i, kind in enumerate(pat)]
    if "cross" in cache:    # stacked over all layers: one pattern position only
        assert len(pat) == 1 and not tail, (pat, tail)
        trees[0] = {**trees[0], "cross": cache["cross"]}
    out = []
    for r in range(n_rep):
        for stacked in trees:
            out.append({sub: {name: t[r] for name, t in leaves.items()}
                        for sub, leaves in stacked.items()})
    return out + [cache["tail"][f"t{j}_{kind}"] for j, kind in enumerate(tail)]


def _rwkv_block(cfg, p, x, cache):
    """RWKV-6 block on (B, T, d), prefill and decode alike; a cache's
    shift and wkv leaves are updated in place (the kernel writes the wkv
    state into the cache itself)."""
    st = cache["rwkv"] if cache is not None else {}
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, shift_tm, _ = rwkv_lib.time_mix(
        cfg, p["rwkv"], h, st.get("shift_tm"), st.get("wkv"), wkv_out=st.get("wkv"))
    x = x + y
    h2 = layers.apply_norm(cfg, p["norm2"], x)
    y2, shift_cm = rwkv_lib.channel_mix(cfg, p["rwkv"], h2, st.get("shift_cm"))
    if st:
        st["shift_tm"].copy_(shift_tm)
        st["shift_cm"].copy_(shift_cm)
    return x + y2


def _rglru_block(cfg, p, x, cache):
    """Griffin recurrent block on (B, T, d), prefill and decode alike; a
    cache's conv and h leaves are updated in place."""
    st = cache["rglru"] if cache is not None else None
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, new = griffin.rglru_block(cfg, p["rglru"], h, st)
    if st is not None:
        st["conv"].copy_(new["conv"])
        st["h"].copy_(new["h"])
    x = x + y
    h2 = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.apply_mlp(cfg, p["mlp"], h2)


def _window(cfg: ModelConfig, kind: str, window: int) -> int:
    """A local-attention block's own window; ``window`` is the global
    blocks' sliding-window mode."""
    return cfg.local_window if kind == LOCAL_ATTN else window


def _ffn(cfg, p, x, moe_path="local"):
    """The block's feed-forward: (y, aux loss), the MoE layer by
    ``moe_path`` where the block has one, else the MLP with aux 0."""
    if "moe" in p:
        return moe_lib.moe_apply(cfg, p["moe"], x, path=moe_path)
    return layers.apply_mlp(cfg, p["mlp"], x), 0.0


def _cross_block(cfg, p, x, enc_out, cache):
    """Whisper's decoder cross-attention with its norm (residual added by
    the caller): against the cache's K/V where prefill stored them, else
    against K/V projected from ``enc_out``."""
    hx = layers.apply_norm(cfg, p["norm_x"], x)
    if cache is not None and "cross" in cache:
        k, v = cache["cross"]["k"], cache["cross"]["v"]
    else:
        k, v = attn_lib.cross_attention_kv(cfg, p["xattn"], enc_out)
    return attn_lib.cross_attention(cfg, p["xattn"], hx, k, v)


# the products whose outputs remat="dots" keeps: JAX's
# dots_with_no_batch_dims_saveable saves dot_generals without batch
# dimensions, which PyTorch runs as mm / addmm (a (B, S, d) @ (d, n) product
# is one mm over the flattened rows); batched products (bmm) are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _maybe_checkpoint(fn, remat):
    """remat: False | True/'full' (recompute everything in the backward) |
    'dots' (save the matmul outputs, recompute the rest).  Only memory and
    recompute differ, never values: the backward's recompute runs under the
    axis rules of the forward (which pick the MoE path's partition and, on a
    ``DeviceMesh``, the placements ``shard`` gives), wherever the backward
    is called."""
    if not remat:
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, list(_DOTS_SAVED))
    rules = current_rules()

    def under_rules(*args):
        with axis_rules(rules), partitioned(rules):
            return fn(*args)

    return functools.partial(torch_checkpoint.checkpoint, under_rules, use_reentrant=False, **kw)


def _block_full(cfg, kind, p, x, positions, cache, window, enc_out, moe_path):
    """One layer over a full sequence -> (x, its aux loss)."""
    if kind == RWKV:
        return shard(_rwkv_block(cfg, p, x, cache), "batch", "seq_act", None), 0.0
    if kind == RGLRU:
        return shard(_rglru_block(cfg, p, x, cache), "batch", "seq_act", None), 0.0
    h = layers.apply_norm(cfg, p["norm1"], x)
    y, _ = attn_lib.attention_full(
        cfg, p["attn"], h, positions, window=_window(cfg, kind, window),
        cache=cache["attn"] if cache is not None else None,
    )
    x = x + y
    if "xattn" in p:
        x = x + _cross_block(cfg, p, x, enc_out, cache)
    h2 = layers.apply_norm(cfg, p["norm2"], x)
    y2, a = _ffn(cfg, p, h2, moe_path)
    return shard(x + y2, "batch", "seq_act", None), a


def _run_blocks_full(cfg, params, x, positions, caches, *, window, enc_out=None,
                     moe_path="local", remat=False):
    """The layers over a full sequence -> (x, the sum of their aux losses).
    Whisper's decoder blocks attend to ``enc_out`` (or to the K/V a cache
    holds) after their self-attention.  ``remat`` checkpoints each layer
    (the JAX package each repetition of the block pattern) and applies only
    without caches, whose in-place writes a recompute would repeat."""
    block = _block_full if caches is not None else _maybe_checkpoint(_block_full, remat)
    aux = 0.0
    for i, (kind, p) in enumerate(zip(_layer_kinds(cfg), params["layers"])):
        cache = caches[i] if caches is not None else None
        x, a = block(cfg, kind, p, x, positions, cache, window, enc_out, moe_path)
        aux = aux + a
    return x, aux


def _encoder_output(cfg: ModelConfig, params, enc_inputs: Optional[torch.Tensor], remat=False):
    """Whisper's encoder output (B, S_enc, d), None for a decoder-only model."""
    if not cfg.is_encoder_decoder:
        return None
    if enc_inputs is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass enc_inputs (B, frames, d)")
    return _encode(cfg, params, enc_inputs, remat)


@partitioned()
def forward(cfg: ModelConfig, params, inputs: torch.Tensor, *,
            enc_inputs: Optional[torch.Tensor] = None, window: int = 0,
            moe_path: str = "local", remat=False):
    """Full-sequence forward -> (logits (B, S, vocab), the layers' summed
    aux loss: 0.0 without MoE layers).  Whisper takes its frame embeddings
    (B, S_enc, d) as ``enc_inputs``.  ``moe_path`` picks the MoE layers'
    path (``moe.moe_apply``) and ``remat`` checkpoints each layer
    (``_maybe_checkpoint``)."""
    positions = torch.arange(inputs.shape[1], device=inputs.device)
    x = shard(_embed_in(cfg, params, inputs, positions), "batch", "seq_act", None)
    x, aux = _run_blocks_full(cfg, params, x, positions, None, window=window,
                              enc_out=_encoder_output(cfg, params, enc_inputs, remat),
                              moe_path=moe_path, remat=remat)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), aux


@partitioned()
def loss_fn(cfg: ModelConfig, params, batch: dict, *, window: int = 0,
            moe_path: str = "local", remat=True, aux_weight: float = 0.01):
    """Next-token cross-entropy over f32 logits, averaged over the labels
    >= 0 (a negative label is masked), plus ``aux_weight`` times the MoE
    layers' aux loss.  ``batch``: ``inputs`` (B, S) tokens or (B, S, d)
    embeddings, ``labels`` (B, S), whisper's ``enc_inputs`` (B, S_enc, d).

    Returns (loss, {"ce": the cross-entropy, "aux": the aux loss}), all
    0-d f32 tensors."""
    logits, aux = forward(cfg, params, batch["inputs"], enc_inputs=batch.get("enc_inputs"),
                          window=window, moe_path=moe_path, remat=remat)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _encode(cfg: ModelConfig, params, enc_inputs: torch.Tensor, remat=False) -> torch.Tensor:
    """Whisper's encoder: absolute positions, then pre-norm blocks of
    non-causal self-attention over all frames and an MLP, then its final
    norm; ``remat`` checkpoints each block."""
    enc = params["encoder"]
    x = enc_inputs.to(params["embed"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x = x + _abs_pos(positions, cfg.d_model).to(x.dtype)

    def block(p, x):
        h = layers.apply_norm(cfg, p["norm1"], x)
        y, _ = attn_lib.attention_full(cfg, p["attn"], h, positions, causal=False)
        x = x + y
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        return x + layers.apply_mlp(cfg, p["mlp"], h2)

    block = _maybe_checkpoint(block, remat)
    for p in enc["blocks"]:
        x = block(p, x)
    return layers.apply_norm(cfg, enc["final_norm"], x)


def _all_cross_kv(cfg: ModelConfig, params, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every decoder layer's cross-attention K/V, each (L, B, S_enc, nkv, hd)."""
    kvs = [attn_lib.cross_attention_kv(cfg, p["xattn"], enc_out) for p in params["layers"]]
    return {"k": torch.stack([k for k, _ in kvs]), "v": torch.stack([v for _, v in kvs])}


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 window: int, dtype, device) -> dict:
    """One layer's cache: attention KV (a window makes it a ring of at most
    ``window`` slots; a local-attention block's own window always does),
    RWKV state or RG-LRU state."""
    if kind == RWKV:
        return {"rwkv": rwkv_lib.init_rwkv_state(cfg, batch, dtype, device)}
    if kind == RGLRU:
        return {"rglru": griffin.init_rglru_state(cfg, batch, dtype, device)}
    w = _window(cfg, kind, window)
    clen = min(w, cache_len) if w else cache_len
    return {"attn": attn_lib.init_layer_cache(cfg, batch, clen, dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, window: int = 0,
               dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Decode cache. ``window`` > 0 = sliding-window mode for global-attn.
    Whisper's decoder layers are ``blocks/dec``; its cross-attention K/V
    come with ``prefill``."""
    n_rep, pat, tail = _pattern_layout(cfg)

    def stacked(kind):
        one = _layer_cache(cfg, kind, batch, cache_len, window, dtype, device)
        return {sub: {name: t.expand(n_rep, *t.shape).clone() for name, t in leaves.items()}
                for sub, leaves in one.items()}

    return {
        "t": torch.zeros((batch,), dtype=torch.int32, device=device),
        "blocks": {block_key(cfg, i, kind): stacked(kind) for i, kind in enumerate(pat)},
        "tail": {f"t{j}_{kind}": _layer_cache(cfg, kind, batch, cache_len, window, dtype, device)
                 for j, kind in enumerate(tail)},
    }


@partitioned()
def prefill(cfg: ModelConfig, params, inputs: torch.Tensor, cache, *,
            enc_inputs: Optional[torch.Tensor] = None, window: int = 0,
            moe_path: str = "local"):
    """Run the prompt through the model, populating ``cache`` in place;
    whisper encodes ``enc_inputs`` and stores every decoder layer's
    cross-attention K/V under ``cache["cross"]``; ``moe_path`` picks the
    MoE layers' path (``moe.moe_apply``).

    Returns (last-token logits (B, vocab), the cache)."""
    s = inputs.shape[1]
    positions = torch.arange(s, device=inputs.device)
    x = shard(_embed_in(cfg, params, inputs, positions), "batch", "seq_act", None)
    enc_out = _encoder_output(cfg, params, enc_inputs)
    if enc_out is not None:
        cache["cross"] = _all_cross_kv(cfg, params, enc_out)
    x, _ = _run_blocks_full(cfg, params, x, positions, _layer_caches(cfg, cache), window=window,
                            moe_path=moe_path)
    cache["t"] = torch.full((inputs.shape[0],), s, dtype=torch.int32, device=inputs.device)
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:, :])
    return _unembed(cfg, params, x)[:, 0], cache


@partitioned()
def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, *, window: int = 0):
    """One decode step for every sequence. Returns (logits (B, vocab), the cache)."""
    t = cache["t"]
    x = shard(_embed_in(cfg, params, tokens[:, None], t[:, None]), "batch", "seq_act", None)
    for kind, p, c in zip(_layer_kinds(cfg), params["layers"], _layer_caches(cfg, cache)):
        if kind == RWKV:
            x = _rwkv_block(cfg, p, x, c)
            continue
        if kind == RGLRU:
            x = _rglru_block(cfg, p, x, c)
            continue
        h = layers.apply_norm(cfg, p["norm1"], x)
        y, _ = attn_lib.attention_decode(cfg, p["attn"], h, t, c["attn"],
                                         window=_window(cfg, kind, window))
        x = x + y
        if "xattn" in p:
            x = x + _cross_block(cfg, p, x, None, c)
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        x = x + _ffn(cfg, p, h2)[0]
    cache["t"] = t + 1
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], cache
