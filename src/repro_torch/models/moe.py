"""Mixture-of-Experts layer: the twin of the JAX package's ``models/moe.py``.

Routing: router logits in f32 -> top-k -> softmax over the k selected
logits (Mixtral convention); the aux output is the Switch load-balance loss
E · Σ_e f_e·p_e.  Three execution paths compute the same semantics:

1. ``moe_dense_oracle`` — every expert over every token, weighted by its
   gate.  Exact, small shapes only; the tests' oracle.
2. ``moe_sort_local``   — sort-based capacity dispatch: assignments sorted
   by expert (stable, so earlier tokens keep their place), at most
   ``capacity`` per expert, the rest dropped; every expert runs over its
   (capacity, d) rows of one (E, C, d) buffer.
3. ``moe_ep_a2a``       — expert parallelism over the ``experts`` axis of
   a ``DeviceMesh`` (the reference's ``shard_map``): each rank routes its
   own slice of the tokens with a per-shard capacity, sends each expert's
   rows to the rank that owns it and gets them back with two
   ``all_to_all_single`` calls, and every rank returns the global ``y``.
   Without such a mesh it is ``moe_sort_local``.

On DTensors (a partitioned step, ``distributed/sharding.py``): the sort
path's routing, dispatch and combine run on every rank's whole copy of
their inputs (DTensor has no rule for their top-k, sort, scatters and
gathers), the buffer and the experts' output split by ``shard`` over the
``experts`` axis between them, so the experts' products run on each rank's
own experts; ``moe_ep_a2a`` takes x and the experts' weights apart at the
reference's ``shard_map`` specs (``_ep_dtensor``).

No step of the sort path waits on the card: the per-expert counts are a
fixed-length ``scatter_add_`` (not ``bincount``), dropped assignments land
in a spare buffer row that is sliced off, and no shape depends on the data.
The combine is a gather back into token order and a sum over the k slots,
so it does not depend on the order of atomics.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.registry import ModelConfig
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (axis_group, current_rules, local_call, mesh_shape,
                                              shard)
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


def _dispatch(cfg: ModelConfig, xf: torch.Tensor, topi: torch.Tensor, c: int):
    """The (E, C, d) buffer of xf's (T, d) rows by expert, at most ``c``
    rows an expert, and ``row_tok`` (T·k,): the buffer row of each
    assignment in token order, E·C where it was dropped."""
    t, d = xf.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    dev = xf.device
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
    buf = torch.zeros((e * c + 1, d), dtype=xf.dtype, device=dev)
    buf.index_copy_(0, row, xf[st])
    # back to token order: assignment j of the flat (T·k) order sits at
    # row_tok[j]
    row_tok = torch.empty_like(row).scatter_(0, order, row)
    return buf[: e * c].view(e, c, d), row_tok


def _combine(out: torch.Tensor, gates: torch.Tensor, row_tok: torch.Tensor) -> torch.Tensor:
    """The experts' (E, C, d) rows back in token order, weighted by their
    gates (T, k) and summed over the k slots: y (T, d) in f32; dropped
    assignments contribute 0."""
    e, c, d = out.shape
    t, k = gates.shape
    keep_tok = row_tok < e * c
    rows = out.reshape(e * c, d).index_select(0, row_tok.clamp(max=e * c - 1))
    rows = torch.where(keep_tok[:, None], rows, torch.zeros_like(rows))
    return (gates[..., None] * rows.view(t, k, d).float()).sum(dim=1)


def moe_sort_local(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   capacity: Optional[int] = None):
    """Sort-based capacity dispatch of x (B, S, d) -> (y (B, S, d), aux).

    All B·S tokens share one capacity, as in the reference: at decode the
    engine routes every slot together."""
    b, s, d = x.shape
    t = b * s
    c = capacity or _capacity(cfg, t)
    xf = x.reshape(t, d)

    def route_dispatch(router, xf):
        gates, topi, aux = _route(cfg, router, xf)
        return (gates, aux, *_dispatch(cfg, xf, topi, c))

    if isinstance(x, DTensor):
        # no DTensor rule for the routing's top-k, sort and scatters or the
        # combine's gather: they run on every rank's whole copy of their
        # inputs (an all-gather of the tokens, and of the experts' rows)
        mesh = x.device_mesh
        rep = (Replicate(),) * mesh.ndim
        gates, aux, buf, row_tok = local_call(route_dispatch, mesh, (rep, rep),
                                              (rep,) * 4, p["router"], xf)
    else:
        gates, aux, buf, row_tok = route_dispatch(p["router"], xf)
    buf = shard(buf, "experts", None, None)
    out = shard(_expert_ffn(cfg, p, buf), "experts", None, None)
    if isinstance(x, DTensor):
        y = local_call(_combine, mesh, (rep,) * 3, rep, out, gates, row_tok)
    else:
        y = _combine(out, gates, row_tok)
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert parallelism.  Every rank holds the same global inputs and computes
# the same global loss, as JAX's global view does, so each collective's
# backward is chosen to give every rank the whole gradient once:
#   * ``_Replicated`` marks a tensor every rank holds whole; its backward
#     sums the ranks' (partial, zero-padded) gradients over the mesh, which
#     is ``shard_map``'s transpose of an input: concatenation along the axes
#     that split it and a sum along the axes that replicate it.
#   * ``_GatherY`` and ``_MeanAux`` give every rank the global output; every
#     rank then holds the whole cotangent, so their backwards take this
#     rank's part of it with no exchange (a backward that reduced would count
#     it once per rank), scaled by 1/size of each mesh axis the output is not
#     split along, as ``shard_map`` scales an output's cotangent.
#   * ``_AllToAll`` with equal splits is its own adjoint.
# Every rank runs the same graph, so the collectives of the backward meet in
# the same order on every rank.
# ---------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of dim 0 in equal parts over ``group`` (the
    reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``_AllToAll`` of ``x`` over ``group`` (a module function, which a
    profiler can wrap in a range of its own)."""
    return _AllToAll.apply(x, group)


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank holds whole; its backward sums
    the gradient over every axis group of the mesh."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class _GatherY(torch.autograd.Function):
    """This rank's (B_loc, S_loc, d) block gathered into the global
    (B, S, d): along the sequence over the EP group, then along the batch
    over each batch axis's group, the minor axis first."""

    @staticmethod
    def forward(ctx, y, ep_group, batch_groups, index, scale):
        ctx.shape, ctx.index, ctx.scale = y.shape, index, scale
        y = y.contiguous()
        for dim, group in [(1, ep_group)] + [(0, g) for g in reversed(batch_groups)]:
            parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, y, group=group)
            y = torch.cat(parts, dim=dim)
        return y

    @staticmethod
    def backward(ctx, g):
        (bi, si), (b, s, _) = ctx.index, ctx.shape
        return g[bi * b:(bi + 1) * b, si * s:(si + 1) * s] * ctx.scale, None, None, None, None


class _MeanAux(torch.autograd.Function):
    """The per-shard aux averaged over the EP group, then over each batch
    axis's group (the reference's ``pmean``s)."""

    @staticmethod
    def forward(ctx, aux, groups, scale):
        ctx.scale = scale
        aux = aux.detach().clone()
        for group in groups:
            dist.all_reduce(aux, group=group)
            aux = aux / dist.get_world_size(group)
        return aux

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def moe_ep_a2a(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Expert-parallel MoE of x (B, S, d) -> (y (B, S, d), aux), the twin of
    the reference's ``shard_map`` body.  Needs axis rules whose ``experts``
    axis is an axis of a ``DeviceMesh``, ``num_experts`` and S divisible by
    its size n_ep; otherwise the sort path.  Each rank takes the block of x
    its mesh coordinates give it (the batch split over the rules' batch
    axes, the sequence over the EP axis), routes it with the capacity of
    its own B_loc·S_loc tokens, runs the experts it owns (e_loc =
    num_experts / n_ep of them, a contiguous slice) over the rows every rank
    of its EP group sent it, and returns the global y and the aux averaged
    over the shards.  Differentiable: every rank gets the whole gradient.
    On DTensors (a partitioned step) the boundary is the reference's
    ``shard_map``'s: ``_ep_dtensor``."""
    rules = current_rules()
    if rules is None:
        return moe_sort_local(cfg, p, x)
    ep_axis = rules.mesh_axes("experts")
    if ep_axis is None:
        return moe_sort_local(cfg, p, x)
    if isinstance(ep_axis, tuple):
        ep_axis = ep_axis[0]
    mesh = rules.mesh
    if not isinstance(mesh, DeviceMesh):             # a record: no ranks to run on
        return moe_sort_local(cfg, p, x)
    shape = mesh_shape(mesh)
    sizes = shape.shape
    n_ep = sizes[ep_axis]
    if cfg.num_experts % n_ep or x.shape[1] % n_ep:
        return moe_sort_local(cfg, p, x)

    batch_axes = rules.mesh_axes("batch") or ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    batch_axes = tuple(a for a in batch_axes if a in shape.axis_names)
    b, s, d = x.shape
    n_b = math.prod(sizes[a] for a in batch_axes)
    if b % n_b:
        raise ValueError(f"batch {b} does not split over the mesh axes {batch_axes} ({n_b})")
    ep_group = axis_group(mesh, ep_axis)
    batch_groups = [axis_group(mesh, a) for a in batch_axes]
    if isinstance(x, DTensor):
        return _ep_dtensor(cfg, p, x, mesh, ep_axis, batch_axes, ep_group, batch_groups)
    coord = dict(zip(shape.axis_names, mesh.get_coordinate()))
    bi = 0
    for a in batch_axes:                             # major to minor, as P((a0, a1))
        bi = bi * sizes[a] + coord[a]
    si = coord[ep_axis]
    b_loc, s_loc = b // n_b, s // n_ep
    e_loc = cfg.num_experts // n_ep
    all_groups = [axis_group(mesh, a) for a in shape.axis_names]
    unsplit_y = math.prod(n for a, n in sizes.items() if a != ep_axis and a not in batch_axes)

    def whole(t):
        return _Replicated.apply(t, all_groups)

    xs = whole(x)[bi * b_loc:(bi + 1) * b_loc, si * s_loc:(si + 1) * s_loc]
    p_loc = {name: whole(p[name])[si * e_loc:(si + 1) * e_loc]
             for name in ("wi_gate", "wi_up", "wo")}
    y, aux = _ep_local(cfg, xs, whole(p["router"]), p_loc, ep_group, n_ep)
    y = _GatherY.apply(y, ep_group, batch_groups, (bi, si), 1.0 / unsplit_y)
    aux = _MeanAux.apply(aux, [ep_group] + batch_groups, 1.0 / math.prod(sizes.values()))
    return y, aux


def _ep_local(cfg: ModelConfig, xs: torch.Tensor, router: torch.Tensor, p_loc: dict,
              ep_group, n_ep: int):
    """One rank's EP body: its (B_loc, S_loc, d) block routed with the
    capacity of its own tokens, each expert's rows sent to the rank that owns
    it, its own experts ``p_loc`` run over the rows every rank of its EP
    group sent, the rows sent back and combined -> (y block, local aux)."""
    b_loc, s_loc, d = xs.shape
    e = cfg.num_experts
    e_loc = e // n_ep
    t_loc = b_loc * s_loc
    c = _capacity(cfg, t_loc)
    xf = xs.reshape(t_loc, d)
    gates, topi, aux = _route(cfg, router, xf)
    # the buffer by destination shard: (E, C, d) == (n_ep·e_loc, C, d); after
    # the exchange dim 0 is the source shard
    buf, row_tok = _dispatch(cfg, xf, topi, c)
    recv = _all_to_all(buf, ep_group)
    recv = recv.view(n_ep, e_loc, c, d).transpose(0, 1).reshape(e_loc, n_ep * c, d)
    out = _expert_ffn(cfg, p_loc, recv)                                 # (e_loc, n_src·C, d)
    out = out.view(e_loc, n_ep, c, d).transpose(0, 1).reshape(e, c, d)
    back = _all_to_all(out, ep_group)
    y = _combine(back, gates, row_tok).reshape(b_loc, s_loc, d).to(xs.dtype)
    return y, aux


def _ep_dtensor(cfg: ModelConfig, p: dict, x: DTensor, mesh: DeviceMesh, ep_axis: str,
                batch_axes, ep_group, batch_groups):
    """``moe_ep_a2a`` on DTensors: the reference's ``shard_map`` boundary.
    x is redistributed to its block spec ``P(batch axes, ep axis)`` and
    the experts' weights to ``P(ep axis)``, the router replicated; the body
    runs on the local tensors (``_ep_local``); y comes back as a DTensor of
    x's block spec and aux replicated.  The gradient placements of the
    local inputs say how the ranks' gradients add up: over the axes that
    split the tokens (EP and batch) they are partial sums, and over the
    axes that split nothing every rank holds the same one."""
    names = tuple(mesh.mesh_dim_names)
    split = {ep_axis, *batch_axes}

    def placements(**by_axis):
        return [by_axis.get(a, Partial() if a in split else Replicate()) for a in names]

    x_pl = [Shard(1) if a == ep_axis else Shard(0) if a in batch_axes else Replicate()
            for a in names]
    w_pl = [Shard(0) if a == ep_axis else Replicate() for a in names]
    xs = x.redistribute(mesh, x_pl).to_local(grad_placements=x_pl)
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=placements())
    p_loc = {name: p[name].redistribute(mesh, w_pl).to_local(
        grad_placements=placements(**{ep_axis: Shard(0)})) for name in ("wi_gate", "wi_up", "wo")}
    y, aux = _ep_local(cfg, xs, router, p_loc, ep_group, mesh.size(names.index(ep_axis)))
    n_split = math.prod(mesh.size(names.index(a)) for a in split)
    aux = _MeanAux.apply(aux, [ep_group] + batch_groups, 1.0 / n_split)
    return (DTensor.from_local(y, mesh, x_pl, shape=x.shape, stride=x.stride()),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim))


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, path: str = "local"):
    """The MoE layer by ``path``: "dense" (the oracle), "local" (the sort
    path) or "ep_a2a" (expert parallelism, ``moe_ep_a2a``)."""
    if path == "dense":
        return moe_dense_oracle(cfg, p, x)
    if path == "ep_a2a":
        return moe_ep_a2a(cfg, p, x)
    if path == "local":
        return moe_sort_local(cfg, p, x)
    raise ValueError(f"unknown MoE path {path!r}")
