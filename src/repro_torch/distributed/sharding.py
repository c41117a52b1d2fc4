"""Logical-axis sharding.

Model code names tensor dimensions with *logical* axes ("batch", "heads",
"ff", ...).  A mesh-specific :class:`AxisRules` maps logical axes to mesh
axes, as the JAX package's does (``repro/distributed/sharding.py``), so the
rules and the partition specs they give can be computed and compared for
any mesh.  ``logical_to_spec`` gives the entries of the reference's
``PartitionSpec`` as a plain tuple, and ``placements_of`` the DTensor
placements of such a spec on a ``DeviceMesh``: ``Shard(d)`` on each mesh
dimension that tensor dimension ``d`` names, ``Replicate()`` on the rest.

A mesh is one of two things.  With a ``torch.distributed`` process group
up, it is a real ``DeviceMesh`` over the group's ranks (:func:`device_mesh`,
``launch/mesh.py:make_test_mesh``, ``make_production_mesh`` over a group of
256 or 512 ranks).  Then a step partitions: ``launch/specs.py:build_step``
places its arguments as DTensors by their specs (the reference's
``in_shardings``), every op of the step runs on DTensors under
``partitioned`` (plain tensors made inside the step count as replicated),
and ``shard`` is the reference's ``with_sharding_constraint``: a
``redistribute`` to the spec's placements.  A plain tensor under a
``DeviceMesh`` stays whole on every rank, as before DTensors came in.
Without a group a mesh is a record of axis names and sizes
(:class:`MeshShape`, no devices) that the rules and the dry-run's FLOP
count read, and ``shard`` returns its tensor unchanged.

Ops of the step that DTensor has no sharding rule for (or, on torch 2.11,
one that fails), the route each takes and the collective the route adds
(ROADMAP.md, Queue 1 item 13c, lists them too):

  * the kernels' wrappers (``ops.flash_attention``, ``decode_attention``,
    ``rwkv6``): ``local_call`` (``local_map``) with batch and heads
    ``Shard``; anything else is redistributed to ``Replicate`` first, an
    all-gather: the decode cache's ``kv_seq`` (the reference's split-K),
    the sequence, partial sums.  Under GQA with the query heads sharded
    and the KV heads not, each rank takes the KV heads its query heads use
    (``ops.kv_heads_of``; no collective, their gradient a partial sum);
  * the cache writes, ``index_put_`` in place on a sharded cache: decode's
    slots (``attention.write_slots``: each rank writes the slots it holds
    and drops the rest) and prefill's (``attention._write_prefill_cache``),
    ``local_call`` on the cache's own placements (no collective);
  * the token embedding (``layers.embed_tokens``): DTensor's
    vocabulary-split ``embedding`` gives a masked partial sum whose
    gradient torch 2.11 cannot redistribute, so each rank looks up its own
    rows and the parts are summed, an all-reduce of the embeddings;
  * the sort path's routing, dispatch and combine (top-k, sort, scatters,
    gathers; ``moe.moe_sort_local``): ``local_call`` on every rank's whole
    copy, an all-gather of the tokens and of the experts' rows;
  * ``moe_ep_a2a``'s hand partition (the reference's ``shard_map``):
    ``to_local`` of x at its block spec and of the experts at theirs,
    ``DTensor.from_local`` of y (no collective beyond its all-to-alls and
    the aux's mean);
  * a head or block dim unflattened from columns split over more ranks
    than it has heads (``unflatten``, and ``flatten``'s gradient): the
    split gathered first, an all-gather.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor.placement_types import _StridedShard

MeshAxes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


@dataclass(frozen=True)
class MeshShape:
    """A device mesh's axis names and sizes, without devices."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"axis names {self.names} and sizes {self.sizes} differ in length")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.names, self.sizes))


def mesh_shape(mesh: Union[MeshShape, DeviceMesh]) -> MeshShape:
    """The axis names and sizes of a mesh record or of a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names),
                     tuple(mesh.size(i) for i in range(mesh.ndim)))


def group_backend_device() -> str:
    """The device type of the default process group's tensors: ``cuda``
    under NCCL, ``cpu`` under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def device_mesh(axis: str = "grid", devices=None) -> Union[None, MeshShape, DeviceMesh]:
    """A 1-D ``DeviceMesh`` named ``axis`` over the ranks of the default
    process group, or ``None`` without a group or with one rank (callers
    take their unsharded path).  ``axis`` names the mesh axis data-parallel
    batch dimensions shard over.  Given ``devices``, the mesh is a record
    of their count (no group runs over them), ``None`` for one or none."""
    if devices is not None:
        n = len(list(devices))
        return None if n <= 1 else MeshShape((axis,), (n,))
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return None
    return init_device_mesh(group_backend_device(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that differ only along mesh axis
    ``axis`` (this rank's among them)."""
    return mesh.get_group(axis)


@dataclass
class AxisRules:
    mesh: Union[MeshShape, DeviceMesh]
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[AxisRules] = None) -> Tuple[MeshAxes, ...]:
    """The partition spec of a tuple of logical axis names under ``rules``:
    one entry a dimension (a mesh axis, a tuple of them, or None), trailing
    Nones dropped.  A mesh axis already consumed by an earlier dimension is
    dropped (a mesh axis may shard at most one dimension of a tensor)."""
    rules = rules or current_rules()
    if rules is None:
        return ()
    names = mesh_shape(rules.mesh).axis_names
    used = set()
    parts = []
    for ax in axes:
        m = rules.mesh_axes(ax)
        if m is None:
            parts.append(None)
            continue
        m_tuple = (m,) if isinstance(m, str) else tuple(m)
        m_tuple = tuple(a for a in m_tuple if a not in used and a in names)
        if not m_tuple:
            parts.append(None)
            continue
        used.update(m_tuple)
        parts.append(m_tuple[0] if len(m_tuple) == 1 else m_tuple)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_of(spec: Sequence[MeshAxes], mesh: DeviceMesh) -> tuple:
    """The DTensor placements, one a mesh dimension, of a partition spec
    (``logical_to_spec``'s tuple) on ``mesh``: ``Shard(d)`` on the mesh
    dimension of each axis tensor dimension ``d`` names, ``Replicate()``
    elsewhere.  A dimension that names a tuple of mesh axes is split over
    them major to minor, as a ``PartitionSpec`` splits it.  DTensor splits a
    dimension that several mesh dimensions shard in mesh order, so a tuple
    in mesh order takes ``Shard(d)`` on each; two axes in the other order
    take ``_StridedShard`` on the mesh-earlier one, which makes the later
    mesh dimension the major split (the local slices a ``PartitionSpec``
    gives, ``tests/test_torch_sharded_step.py``); more than two out of
    order are refused.  A mesh dimension of one rank replicates: a split
    into one part is the whole tensor, and DTensor refuses views that fold a
    size-1 dimension it holds as sharded (a batch of one flattened into its
    tokens)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * mesh.ndim
    for d, m in enumerate(spec):
        if m is None:
            continue
        axes = (m,) if isinstance(m, str) else tuple(m)
        dims = [names.index(a) for a in axes if mesh.size(names.index(a)) > 1]
        if dims == sorted(dims):
            for i in dims:
                out[i] = Shard(d)
        elif len(dims) == 2:
            major, minor = dims
            out[major] = Shard(d)
            out[minor] = _StridedShard(d, split_factor=mesh.size(major))
        else:
            raise NotImplementedError(f"dimension {d} split over {axes} out of mesh order")
    return tuple(out)


@contextlib.contextmanager
def partitioned(rules: Optional[AxisRules] = None):
    """Where the current rules' mesh is a ``DeviceMesh``, every plain tensor
    an op meets beside a DTensor counts as replicated (positions, masks and
    constants the model makes inside a step); elsewhere nothing changes.
    Unlike ``torch.distributed.tensor.experimental.implicit_replication``,
    which clears the switch on leaving, this restores what it found, so the
    contexts nest (a train step's backward runs after its ``loss_fn``'s
    context has closed)."""
    rules = rules or current_rules()
    if rules is None or not isinstance(rules.mesh, DeviceMesh):
        yield
        return
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous.  A local
    gradient leaves ``local_map`` as the local tensor of a DTensor whose
    global strides DTensor takes as contiguous; a transposed one (an
    ``einsum``'s backward gives them) would then fail the next ``view``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, mesh: DeviceMesh, in_placements, out_placements, *args,
               in_grad_placements=None):
    """``fn`` on every rank's local tensors: ``local_map`` with each DTensor
    argument redistributed to its entry of ``in_placements`` (None for a
    non-tensor), each output a DTensor of its entry of ``out_placements``
    (a tuple of entries for several outputs, one entry for one output,
    None for none).  A plain tensor argument counts as replicated.  The
    local inputs' gradients come back contiguous (``_ContiguousGrad``), as
    DTensors of ``in_grad_placements`` (by default their input
    placements: ``Partial()`` where ranks that hold the same input compute
    different parts of its gradient)."""
    rep = (Replicate(),) * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep) if isinstance(a, torch.Tensor)
            and not isinstance(a, DTensor) else a for a in args]

    def local(*ts):
        return fn(*[_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad
                    else t for t in ts])

    if isinstance(out_placements, tuple) and out_placements and not isinstance(
            out_placements[0], Placement):
        out = tuple(list(p) for p in out_placements)
    else:
        out = None if out_placements is None else list(out_placements)
    grad = None if in_grad_placements is None else tuple(in_grad_placements)
    return local_map(local, out_placements=out, in_placements=tuple(in_placements),
                     in_grad_placements=grad, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def unflatten(x: torch.Tensor, dim: int, *sizes: int) -> torch.Tensor:
    """``x``'s dimension ``dim`` split into ``sizes`` (heads and head dims,
    or blocks).  DTensor refuses to unflatten a dimension whose split does
    not divide the first new size (llama's 8 KV heads after a projection
    whose 8 x 128 columns came out split over 16 ranks); the mesh dims that
    split it are gathered first (an all-gather)."""
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        split = [m for m, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
        if sizes[0] % math.prod(x.device_mesh.size(m) for m in split):
            pl = [Replicate() if m in split else p for m, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


def unflatten_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``unflatten`` of the last dimension."""
    return unflatten(x, -1, *sizes)


class _Flatten(torch.autograd.Function):
    """Dimensions ``dim .. dim + n - 1`` of a DTensor folded into one; the
    backward unflattens the gradient with ``unflatten``, where autograd's
    own view would meet DTensor's refusal."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + n:])

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, *ctx.sizes), None, None


def flatten(x: torch.Tensor, dim: int, n: int = 2) -> torch.Tensor:
    """Dimensions ``dim .. dim + n - 1`` of ``x`` folded into one (a
    reshape; on a DTensor ``_Flatten``, whose gradient unflattens safely)."""
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        return _Flatten.apply(x, dim, n)
    return x.reshape(*x.shape[:dim], -1, *x.shape[dim + n:])


def spec_for_axes(axes: Sequence[Optional[str]], rules: Optional[AxisRules] = None):
    """(mesh, placements) for a logical-axes tuple on a ``DeviceMesh`` (the
    reference's ``NamedSharding``); (mesh record, partition spec) on a
    ``MeshShape``; None without rules."""
    rules = rules or current_rules()
    if rules is None:
        return None
    spec = logical_to_spec(axes, rules)
    if isinstance(rules.mesh, DeviceMesh):
        return rules.mesh, placements_of(spec, rules.mesh)
    return rules.mesh, spec


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint``: under rules whose mesh
    is a ``DeviceMesh``, a DTensor ``x`` redistributed to the placements of
    its logical axes; under a ``MeshShape`` record or without rules, ``x``
    itself.  A plain tensor under a ``DeviceMesh`` is every rank's whole
    copy of a replicated value (the global view in which
    ``moe_ep_a2a``'s hand partition runs on plain tensors) and stays as it
    is: a step partitions where its arguments are DTensors
    (``launch/specs.py:place``).  Under rules the logical axes must name
    every dimension, as the JAX package asserts."""
    rules = current_rules()
    if rules is None:
        return x
    assert x.dim() == len(axes), (tuple(x.shape), axes)
    if not isinstance(rules.mesh, DeviceMesh) or not isinstance(x, DTensor):
        return x
    mesh, placements = spec_for_axes(axes, rules)
    if tuple(x.placements) == placements:
        return x
    y = x.redistribute(mesh, placements)
    local = y.to_local()
    if local.is_contiguous():
        return y
    # an uneven split is padded for the exchange and sliced after it, which
    # can leave the local tensor strided where DTensor takes it as
    # contiguous (a later view of it would fail)
    return DTensor.from_local(local.contiguous(), mesh, placements, shape=y.shape,
                              stride=y.stride())
