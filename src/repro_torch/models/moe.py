"""Mixture-of-Experts layer: the twin of the JAX package's ``models/moe.py``.

Routing: router logits in f32 -> top-k -> softmax over the k selected
logits (Mixtral convention); the aux output is the Switch load-balance loss
E · Σ_e f_e·p_e.  Two execution paths compute the same semantics:

1. ``moe_dense_oracle`` — every expert over every token, weighted by its
   gate.  Exact, small shapes only; the tests' oracle.
2. ``moe_sort_local``   — sort-based capacity dispatch: assignments sorted
   by expert (stable, so earlier tokens keep their place), at most
   ``capacity`` per expert, the rest dropped; every expert runs over its
   (capacity, d) rows of one (E, C, d) buffer.

The reference's third path, ``moe_ep_a2a``, exchanges tokens between the
devices of a mesh; with no mesh it is ``moe_sort_local``, which is all one
card runs (``moe_apply(path="ep_a2a")``).

No step of the sort path waits on the card: the per-expert counts are a
fixed-length ``scatter_add_`` (not ``bincount``), dropped assignments land
in a spare buffer row that is sliced off, and no shape depends on the data.
The combine is a gather back into token order and a sum over the k slots,
so it does not depend on the order of atomics.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import ModelConfig
from repro_torch.models.params import boxed_normal

# leaves kept in f32 whatever the model's dtype (the JAX package's router)
F32_LEAVES = ("router",)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Router (d, E) in f32 and the experts' SwiGLU weights, at the JAX
    package's scales, drawn from ``gen``; Boxed leaves (``params.values_of``
    gives the tensors)."""
    d, e = cfg.d_model, cfg.num_experts
    e_ff = cfg.expert_d_ff or cfg.d_ff
    s_in, s_out = d ** -0.5, e_ff ** -0.5
    return {
        "router": boxed_normal(gen, (d, e), ("embed", None), s_in, torch.float32, device),
        "wi_gate": boxed_normal(gen, (e, d, e_ff), ("experts", "embed", "ff"), s_in, dtype, device),
        "wi_up": boxed_normal(gen, (e, d, e_ff), ("experts", "embed", "ff"), s_in, dtype, device),
        "wo": boxed_normal(gen, (e, e_ff, d), ("experts", "ff", "embed"), s_out, dtype, device),
    }


def param_count(cfg: ModelConfig) -> int:
    """Elements of ``init_moe``'s tree."""
    d, e = cfg.d_model, cfg.num_experts
    return d * e + 3 * e * d * (cfg.expert_d_ff or cfg.d_ff)


def _route(cfg: ModelConfig, router_w: torch.Tensor, xf: torch.Tensor):
    """xf (T, d) -> (gates (T, k) f32, expert indices (T, k), aux loss).

    ``torch.topk`` promises no order among equal logits, where
    ``jax.lax.top_k`` takes the lower index first; with continuous inputs
    the f32 logits do not tie."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    logits = xf.float() @ router_w.float()                    # (T, E)
    topv, topi = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(topv, dim=-1)
    # Switch-style load balance: E * sum_e (top-1 share_e * mean prob_e),
    # 1 when perfectly balanced; the share is a fixed-length count
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.zeros(e, device=xf.device).scatter_add_(
        0, topi[:, 0], torch.ones(topi.shape[0], device=xf.device))
    aux = e * torch.sum(top1 / topi.shape[0] * probs.mean(dim=0))
    return gates, topi, aux


def _expert_ffn(cfg: ModelConfig, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d): every expert's SwiGLU over its rows, in
    the buffer's dtype."""
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    return torch.bmm(h, p["wo"])


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows per expert for ``tokens`` tokens: capacity factor × the mean
    load, plus one, rounded up to a multiple of 8."""
    c = int(tokens * cfg.num_experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)


def moe_dense_oracle(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Every expert over every token, weighted by its gate (0 where it was
    not chosen); no capacity.  For the tests."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, topi, aux = _route(cfg, p["router"], xf)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        pe = {name: p[name][e][None] for name in ("wi_gate", "wi_up", "wo")}
        out_e = _expert_ffn(cfg, pe, xf[None])[0]                        # (T, d)
        w_e = torch.where(topi == e, gates, torch.zeros_like(gates)).sum(dim=-1)
        y = y + w_e[:, None] * out_e.float()
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_sort_local(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   capacity: Optional[int] = None):
    """Sort-based capacity dispatch of x (B, S, d) -> (y (B, S, d), aux).

    All B·S tokens share one capacity, as in the reference: at decode the
    engine routes every slot together."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.num_experts_per_tok, cfg.num_experts
    c = capacity or _capacity(cfg, t)
    dev = x.device

    xf = x.reshape(t, d)
    gates, topi, aux = _route(cfg, p["router"], xf)
    flat_e = topi.reshape(t * k)
    flat_tok = torch.arange(t * k, device=dev) // k
    # stable: within an expert, assignments keep token order, so the
    # tokens past capacity are the same ones the reference drops
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_tok[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - offsets[se]                 # rank within expert
    keep = pos < c
    # row of the (E·C + 1, d) buffer: the last row takes every dropped
    # assignment and is sliced off
    row = torch.where(keep, se * c + pos, torch.full_like(se, e * c))
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, row, xf[st])
    out = _expert_ffn(cfg, p, buf[: e * c].view(e, c, d)).reshape(e * c, d)

    # back to token order: assignment j of the flat (T·k) order sits at
    # row_tok[j]; dropped ones contribute 0
    row_tok = torch.empty_like(row).scatter_(0, order, row)
    keep_tok = row_tok < e * c
    rows = out.index_select(0, row_tok.clamp(max=e * c - 1))
    rows = torch.where(keep_tok[:, None], rows, torch.zeros_like(rows))
    y = (gates[..., None] * rows.view(t, k, d).float()).sum(dim=1)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, path: str = "local"):
    """The MoE layer by ``path``: "dense" (the oracle), "local" (the sort
    path) or "ep_a2a" (expert parallelism; on one device the sort path)."""
    if path == "dense":
        return moe_dense_oracle(cfg, p, x)
    if path in ("local", "ep_a2a"):
        return moe_sort_local(cfg, p, x)
    raise ValueError(f"unknown MoE path {path!r}")
