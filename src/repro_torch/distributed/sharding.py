"""Logical-axis sharding, on one card.

Model code names tensor dimensions with *logical* axes ("batch", "heads",
"ff", ...).  A mesh-specific :class:`AxisRules` maps logical axes to mesh
axes, as the JAX package's does (``repro/distributed/sharding.py``), so the
rules and the partition specs they give can be computed and compared for
any mesh.  On one card nothing is partitioned: the mesh is a record of axis
names and sizes (:class:`MeshShape`, no devices), ``logical_to_spec`` gives
the entries of the reference's ``PartitionSpec`` as a plain tuple, and
``shard`` returns its tensor unchanged.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

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


def device_mesh(axis: str = "grid", devices=None) -> Optional[MeshShape]:
    """A 1-D mesh record over the local cards (or ``devices``), or ``None``
    with one card or none (callers take their unsharded path).  ``axis``
    names the mesh axis data-parallel batch dimensions shard over."""
    n = torch.cuda.device_count() if devices is None else len(list(devices))
    if n <= 1:
        return None
    return MeshShape((axis,), (n,))


@dataclass
class AxisRules:
    mesh: MeshShape
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
    used = set()
    parts = []
    for ax in axes:
        m = rules.mesh_axes(ax)
        if m is None:
            parts.append(None)
            continue
        m_tuple = (m,) if isinstance(m, str) else tuple(m)
        m_tuple = tuple(a for a in m_tuple if a not in used and a in rules.mesh.axis_names)
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
    """``x`` itself: one card partitions nothing.  Under rules the logical
    axes must still name every dimension, as the JAX package asserts."""
    if current_rules() is not None:
        assert x.dim() == len(axes), (tuple(x.shape), axes)
    return x
