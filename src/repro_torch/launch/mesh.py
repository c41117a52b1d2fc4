"""Production meshes and logical-axis rules.

The JAX package's target fleet is TPU v5e: a single pod of 16 x 16 = 256
chips (``data`` x ``model``), or two pods, 512 chips (``pod`` x ``data`` x
``model``).  The production meshes here are records of those shapes
(``distributed.MeshShape``), never devices: ``make_rules`` computes, from
the config and the mesh's sizes alone, the same logical-axis rules the JAX
package computes for them.  ``make_test_mesh`` builds a real
``DeviceMesh`` over the ranks of a process group when one is up, as
``jax.make_mesh`` builds one over the local devices, and ``make_rules``
gives the same rules for it as for the record of its shape.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import (AxisRules, MeshShape, group_backend_device,
                                              mesh_shape)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The record of the single-pod (16, 16) or two-pod (2, 16, 16) mesh."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False) -> Union[MeshShape, DeviceMesh]:
    """The production mesh: a ``DeviceMesh`` over the default process group
    where it has the mesh's 256 or 512 ranks, else the record of the
    shape (``production_shape``)."""
    rec = production_shape(multi_pod=multi_pod)
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == math.prod(rec.sizes)):
        return init_device_mesh(group_backend_device(), rec.sizes, mesh_dim_names=rec.names)
    return rec


def make_test_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes=("data", "model")) -> Union[MeshShape, DeviceMesh]:
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default process
    group (whose size must be the shape's product), on ``cuda`` under NCCL
    and ``cpu`` under gloo; without a group, the record of that shape."""
    if not (dist.is_available() and dist.is_initialized()):
        return MeshShape(tuple(axes), tuple(shape))
    return init_device_mesh(group_backend_device(), tuple(shape), mesh_dim_names=tuple(axes))


def make_rules(
    cfg: ModelConfig,
    mesh,
    mode: str,                    # train | prefill | decode
    *,
    batch_size: int,
    cache_len: int = 0,
) -> AxisRules:
    """Logical-axis -> mesh-axis mapping for one (arch, shape, mesh).

    Divisibility-checked: an axis maps to ``model`` only when every tensor
    dimension carrying that logical axis divides the mesh axis size;
    otherwise it stays replicated (e.g. minicpm's 36 heads and whisper's
    51865 vocab don't divide 16).
    """
    mesh_sizes = mesh_shape(mesh)
    names = mesh_sizes.axis_names
    sizes = mesh_sizes.shape
    n_model = sizes["model"]
    data_axes = tuple(a for a in names if a != "model")
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]

    def fits_model(*dims: int) -> bool:
        return all(d > 0 and d % n_model == 0 for d in dims)

    rules = {}
    # --- activations ------------------------------------------------------
    rules["batch"] = data_axes if batch_size % n_data == 0 else None
    rules["seq_act"] = None
    # --- weights ----------------------------------------------------------
    ff_dims = [cfg.d_ff]
    if cfg.num_experts:
        ff_dims.append(cfg.expert_d_ff or cfg.d_ff)
    if "rglru" in str(cfg.block_pattern):
        ff_dims.append(cfg.rglru_width or cfg.d_model)
    rules["ff"] = "model" if fits_model(*ff_dims) else None
    rules["heads"] = "model" if fits_model(cfg.num_heads) else None
    rules["kv_heads"] = "model" if fits_model(cfg.num_kv_heads) else None
    rules["heads_flat"] = "model" if fits_model(cfg.d_model) else None
    rules["vocab"] = "model" if fits_model(cfg.vocab_size) else None
    rules["experts"] = "model" if fits_model(cfg.num_experts) else None
    rules["rwkv_heads"] = (
        "model"
        if cfg.rwkv_head_dim and fits_model(cfg.d_model // cfg.rwkv_head_dim)
        else None
    )
    rules["layers"] = None
    rules["embed_out"] = None
    if mode == "train":
        # FSDP-style second weight axis: the d_model (embed) dim over all
        # data-like axes (pod + data on the two-pod mesh), so that the pod
        # axis does not replicate optimizer state
        if cfg.d_model % n_data == 0:
            rules["embed"] = data_axes
        elif cfg.d_model % sizes[data_axes[-1]] == 0:
            rules["embed"] = (data_axes[-1],)
        else:
            rules["embed"] = None
        rules["kv_seq"] = None
    else:
        rules["embed"] = None
        if mode == "decode" and cache_len and cache_len % n_model == 0:
            # flash-decode split-K: the KV cache's sequence over the model
            # axis (splits the reads of the decode hot loop)
            rules["kv_seq"] = "model"
        else:
            rules["kv_seq"] = None
    return AxisRules(mesh=mesh, rules=rules)
