"""AdamW with global-norm clipping, written out as the JAX package writes it.

Parameter trees are the port's nested dicts and lists of tensors; the
optimizer state is ``{"step": int32 0-d, "m": tree, "v": tree}`` as in the
JAX package.  Each elementwise step of the reference's update is one
``torch._foreach_*`` call over all leaves (a handful of kernels for the
whole tree instead of ~14 a leaf), in float32 and in the reference's order
of operations, so a step rounds as the reference's does.  A gradient leaf
that is None (a parameter the loss does not reach, e.g. llava's token
embedding) counts as zeros: its moments decay and weight decay still
applies, as in the JAX package, whose gradient holds zeros there.

DTensor leaves (a partitioned train step): each gradient is redistributed
to its parameter's placements first, so ``m`` and ``v`` take them, ``step``
is replicated, and ``global_norm``'s sums of squares are partial sums that
DTensor adds across the shards before the square root.

``state_dtype=torch.bfloat16`` halves optimizer memory (m, v in bf16) — used
by the 1T-parameter Kimi-K2 training config of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict/list tree in its own order (None is a
    leaf)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _rebuild(like, it: Iterator):
    if isinstance(like, dict):
        return {k: _rebuild(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def adamw_init(params, opt_cfg: OptimizerConfig):
    """Zero moments shaped (and, for DTensor parameters, placed) as the
    parameters, and ``step`` 0 (replicated on a DTensor's mesh)."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros_like(p, dtype=opt_cfg.state_dtype)
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    if isinstance(leaves[0], DTensor):
        mesh = leaves[0].device_mesh
        step = DTensor.from_local(torch.zeros((), dtype=torch.int32,
                                              device=leaves[0].to_local().device),
                                  mesh, [Replicate()] * mesh.ndim)
    return {
        "step": step,
        "m": tree_unflatten(params, [zeros(p) for p in leaves]),
        "v": tree_unflatten(params, [zeros(p) for p in leaves]),
    }


def _f32(leaves) -> List[torch.Tensor]:
    return [x.float() for x in leaves]


def _like(g, p):
    """A DTensor gradient on its parameter's placements (a partial sum is
    reduced, a replicated one sliced), so that each moment takes its
    parameter's placements; a plain gradient as it is."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of each leaf's sum of squares, in f32; None leaves
    count 0.  (Not ``_foreach_norm`` or ``vector_norm``: on the CPU they sum
    f32 squares with errors of 1e-5 relative at 1M elements.)"""
    leaves = [g for g in tree_leaves(tree) if g is not None]
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(g.float())) for g in leaves])))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    opt_state,
    opt_cfg: OptimizerConfig,
    lr: Optional[torch.Tensor] = None,
) -> Tuple[Any, Any, dict]:
    """One AdamW step. Returns (new_params, new_opt_state, metrics); the
    inputs are left as they were.  ``grad_norm`` is the norm before the
    clip."""
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradient leaves for {len(flat_p)} parameters")
    dev = flat_p[0].device
    step = opt_state["step"] + 1
    lr = torch.as_tensor(opt_cfg.lr if lr is None else lr, dtype=torch.float32, device=dev)

    g32 = [torch.zeros_like(p, dtype=torch.float32) if g is None else _like(g, p).float()
           for p, g in zip(flat_p, flat_g)]
    gnorm = global_norm(g32)
    clip = torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    b1, b2 = opt_cfg.b1, opt_cfg.b2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    g32 = torch._foreach_mul(g32, clip)
    # m32 = b1 * m + (1 - b1) * g32
    m32 = torch._foreach_mul(_f32(tree_leaves(opt_state["m"])), b1)
    torch._foreach_add_(m32, torch._foreach_mul(g32, 1 - b1))
    # v32 = b2 * v + (1 - b2) * g32²  (g32 is not needed after this)
    torch._foreach_mul_(g32, g32)
    torch._foreach_mul_(g32, 1 - b2)
    v32 = torch._foreach_mul(_f32(tree_leaves(opt_state["v"])), b2)
    torch._foreach_add_(v32, g32)
    del g32
    # delta = (m32 / c1) / (sqrt(v32 / c2) + eps)
    denom = torch._foreach_div(v32, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt_cfg.eps)
    delta = torch._foreach_div(m32, c1)
    torch._foreach_div_(delta, denom)
    del denom
    # new_p = p32 - lr * (delta + wd * p32)
    p32 = _f32(flat_p)
    torch._foreach_add_(delta, torch._foreach_mul(p32, opt_cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    new_p = torch._foreach_sub(p32, delta)
    del delta

    cast = lambda xs, dtypes: [x.to(d) for x, d in zip(xs, dtypes)]
    sd = opt_cfg.state_dtype
    new_params = tree_unflatten(params, cast(new_p, [p.dtype for p in flat_p]))
    new_m = tree_unflatten(params, cast(m32, [sd] * len(m32)))
    new_v = tree_unflatten(params, cast(v32, [sd] * len(v32)))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"step": step, "m": new_m, "v": new_v}, metrics
