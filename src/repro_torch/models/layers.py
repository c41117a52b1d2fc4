"""Shared layers: norms, MLPs, embeddings, rotary and sinusoidal positions."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import local_call, shard
from repro_torch.models.params import boxed_normal, boxed_ones, boxed_zeros


# ---------------------------------------------------------------------------
# Norms (always computed in f32, eps 1e-6, then cast back).
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, dtype, device) -> dict:
    p = {"scale": boxed_ones((cfg.d_model,), ("embed",), dtype, device)}
    if cfg.norm == "layernorm":
        p["bias"] = boxed_zeros((cfg.d_model,), ("embed",), dtype, device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP: SwiGLU (wi_gate, wi_up, wo) or GELU (wi, wo).
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None, *,
             dtype=torch.float32, device="cuda") -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    if cfg.mlp == "swiglu":
        return {
            "wi_gate": boxed_normal(gen, (d, ff), ("embed", "ff"), s_in, dtype, device),
            "wi_up": boxed_normal(gen, (d, ff), ("embed", "ff"), s_in, dtype, device),
            "wo": boxed_normal(gen, (ff, d), ("ff", "embed"), s_out, dtype, device),
        }
    return {
        "wi": boxed_normal(gen, (d, ff), ("embed", "ff"), s_in, dtype, device),
        "wo": boxed_normal(gen, (ff, d), ("ff", "embed"), s_out, dtype, device),
    }


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu's default
    if h.dim() == 3:
        h = shard(h, "batch", None, "ff")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embeddings.
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    return boxed_normal(gen, (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), 1.0, dtype, device)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``; a DTensor table takes
    ``_vocab_parallel_lookup``."""
    if isinstance(embed, DTensor):
        return _vocab_parallel_lookup(embed, tokens)
    return embed[tokens]


class _SumOverRanks(torch.autograd.Function):
    """The sum of every rank's part over ``groups``; its backward hands each
    rank the whole (replicated) gradient, the derivative of a sum."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_lookup(embed: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup on a DTensor table, by hand: DTensor's own (``embedding``
    on a table split by vocabulary gives a masked partial sum) does not
    carry its gradient back on every torch release this runs on (2.11
    cannot redistribute the gradient's plain partial sum to the masked
    one), so each rank looks up the tokens in its rows, zeros the rest and
    the parts are summed over the vocabulary's mesh dims (an all-reduce of
    the embeddings, the vocab-parallel embedding).  The table's other
    splits (FSDP's ``embed`` over ``data`` in training) are gathered first;
    its gradient is split by vocabulary, and a partial sum over the mesh
    dims that split the tokens' batch."""
    mesh = embed.device_mesh
    rep = Replicate()
    tokens = tokens if isinstance(tokens, DTensor) else DTensor.from_local(
        tokens, mesh, [rep] * mesh.ndim)
    tok_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else rep for p in tokens.placements)
    vocab_dims = [m for m, p in enumerate(embed.placements)
                  if isinstance(p, Shard) and p.dim == 0 and tok_pl[m] == rep]
    table_pl = tuple(Shard(0) if m in vocab_dims else rep for m in range(mesh.ndim))
    grad_pl = tuple(Shard(0) if m in vocab_dims else Partial() if tok_pl[m] != rep else rep
                    for m in range(mesh.ndim))
    out_pl = tuple(Shard(0) if p != rep else rep for p in tok_pl)
    _, offset = compute_local_shape_and_global_offset(embed.shape, mesh, table_pl)
    groups = [mesh.get_group(m) for m in vocab_dims]

    def local(tok, table):
        idx = tok.long() - offset[0]
        mine = (idx >= 0) & (idx < table.shape[0])
        rows = table[idx.clamp(0, table.shape[0] - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return _SumOverRanks.apply(rows, groups) if groups else rows

    return local_call(local, mesh, (tok_pl, table_pl), out_pl, tokens, embed,
                      in_grad_placements=(tok_pl, grad_pl))


# ---------------------------------------------------------------------------
# Rotary position embedding, split-half form (not interleaved).
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)          # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    if theta <= 0.0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs    # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Absolute sinusoidal positions.
# ---------------------------------------------------------------------------
def sinusoidal_positions(seq_len: int, d_model: int, device="cuda") -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (seq, d_model) in f32, sin
    and cos interleaved (even columns sin, odd columns cos).  The model adds
    ``model._abs_pos`` instead, which concatenates [sin, cos]; both forms are
    the JAX package's and both are kept."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10_000.0) / d_model))
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
