"""Logical-axis sharding.

Model code names tensor dimensions with *logical* axes ("batch", "heads",
"ff", ...).  A mesh-specific :class:`AxisRules` maps logical axes to mesh
axes, as the JAX package's does (``repro/distributed/sharding.py``), so the
rules and the partition specs they give can be computed and compared for
any mesh.  ``logical_to_spec`` gives the entries of the reference's
``PartitionSpec`` as a plain tuple.

A mesh is one of two things.  With a ``torch.distributed`` process group
up, it is a real ``DeviceMesh`` over the group's ranks (:func:`device_mesh`,
``launch/mesh.py:make_test_mesh``), and the paths that partition work by
hand run on it: expert-parallel MoE (``models/moe.py:moe_ep_a2a``, two
all-to-alls over the ``experts`` axis) and the tick engine's sharded grid
(``core/sim/torch_engine.py:run_grid``).  Without a group it is a record
of axis names and sizes (:class:`MeshShape`, no devices) that the rules and
the dry-run read.  Either way ``shard`` returns its tensor unchanged: the
reference's GSPMD constraint has no counterpart here.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

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


def spec_for_axes(axes: Sequence[Optional[str]], rules: Optional[AxisRules] = None):
    """(mesh record, partition spec) for a logical-axes tuple, or None
    without rules."""
    rules = rules or current_rules()
    if rules is None:
        return None
    return rules.mesh, logical_to_spec(axes, rules)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` itself: nothing here partitions a tensor by a constraint.
    Under rules the logical axes must still name every dimension, as the
    JAX package asserts."""
    if current_rules() is not None:
        assert x.dim() == len(axes), (tuple(x.shape), axes)
    return x
