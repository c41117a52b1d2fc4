"""Meta-tensor input specs and partition-spec trees for every
(architecture x input-shape x mesh) combination.

Everything here is built on the ``meta`` device: shapes and dtypes, no
storage, so the 72 B and 1 T parameter sets are never allocated.  The JAX
package's twin (``repro/launch/specs.py``) returns ``ShapeDtypeStruct``s and
``NamedSharding``s for ``jax.jit``.  The step builders here return the
port's own step function, its arguments and their partition specs as plain
tuples (``distributed.logical_to_spec``).  On a mesh record the arguments
are meta tensors, which ``launch/dryrun.py`` counts and ``chip_smoke.py``
materialises on the card.  On a ``DeviceMesh`` they are meta DTensors
placed by those specs (``place``, the counterpart of the reference's
``in_shardings``): each rank holds its local shard's shape, and the step
run on them partitions (``distributed/sharding.py``).  ``place`` puts a
tree of real tensors on the mesh the same way.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import InputShape, ModelConfig
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import AxisRules, logical_to_spec, placements_of
from repro_torch.launch.mesh import make_rules
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step

META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def decode_window(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding window used for global-attn layers at this shape (0 = full)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return cfg.long_context_window
    return 0


def batch_spec(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Training / forward batch as meta tensors: token ids int32, as the
    JAX package's (a vision model's inputs are embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        inputs = meta((b, s, cfg.d_model), dtype)
    else:
        inputs = meta((b, s), torch.int32)
    out = {"inputs": inputs, "labels": meta((b, s), torch.int32)}
    if cfg.is_encoder_decoder:
        out["enc_inputs"] = meta((b, cfg.encoder_seq, cfg.d_model), dtype)
    return out


def batch_axes(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Tuple]:
    return {k: ("batch", "seq_act") if v.dim() == 2 else ("batch", "seq_act", None)
            for k, v in batch.items()}


def cache_spec(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16):
    """Decode/prefill cache for this shape as meta tensors; whisper's
    includes the cross-attention K/V (L, B, encoder frames, nkv, hd) that
    its prefill stores."""
    b = shape.global_batch
    cache = model_lib.init_cache(cfg, b, shape.seq_len, window=decode_window(cfg, shape),
                                 dtype=dtype, device=META)
    if cfg.is_encoder_decoder:
        kv = (cfg.num_layers, b, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = {"k": meta(kv, dtype), "v": meta(kv, dtype)}
    return cache


_LEAF_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "slot_pos": ("layers", "batch", "kv_seq"),
    "wkv": ("layers", "batch", "rwkv_heads", None, None),
    "shift_tm": ("layers", "batch", None),
    "shift_cm": ("layers", "batch", None),
    "conv": ("layers", "batch", None, "ff"),
    "h": ("layers", "batch", "ff"),
    "t": ("batch",),
}


def cache_axes(cache_tree, _keys=()) -> Any:
    """Logical axes tree for a cache (matched by leaf dict key)."""
    if isinstance(cache_tree, dict):
        return {k: cache_axes(v, _keys + (k,)) for k, v in cache_tree.items()}
    ndim = cache_tree.dim()
    if "cross" in _keys:
        # whisper's cross-attention K/V: the encoder's frames stay unsharded
        axes = ("layers", "batch", None, "kv_heads", None)
    else:
        axes = _LEAF_AXES.get(_keys[-1] if _keys else None)
    if axes is None:
        axes = (None,) * ndim
    # tail (unstacked) cache entries and the per-batch 't' have no layer dim
    if len(axes) == ndim + 1 and axes[0] == "layers":
        axes = axes[1:]
    assert len(axes) == ndim, (_keys, tuple(cache_tree.shape), axes)
    return tuple(axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def shardings_of(axes_tree, rules: AxisRules):
    """The partition spec (a tuple, ``logical_to_spec``) of every leaf of a
    logical-axes tree, in a tree of the same structure."""
    if _is_axes(axes_tree):
        return logical_to_spec(axes_tree, rules)
    if isinstance(axes_tree, dict):
        return {k: shardings_of(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [shardings_of(v, rules) for v in axes_tree]
    raise TypeError(f"not a logical-axes tree leaf: {axes_tree!r}")


def place(tree, spec_tree, mesh: DeviceMesh):
    """A tree of tensors as DTensors on ``mesh``, each leaf placed by its
    partition spec in ``spec_tree`` (``placements_of``).  A meta leaf
    becomes a meta DTensor whose local tensor has the shard's shape; a leaf
    on a device is split from rank 0's copy (every rank holds the same
    tensor, made from the same seed); a DTensor leaf is redistributed (a
    prefilled cache placed for decode).  Raises ``ValueError`` where a
    leaf's mesh axes do not divide its dimension, as the reference's
    ``NamedSharding(mesh, P(*spec)).shard_shape`` does: DTensor would split
    it unevenly."""
    if isinstance(tree, dict):
        return {k: place(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh) for v, s in zip(tree, spec_tree))
    if tree is None:
        return tree
    names = tuple(mesh.mesh_dim_names)
    for d, m in enumerate(spec_tree):
        axes = () if m is None else (m,) if isinstance(m, str) else tuple(m)
        parts = math.prod(mesh.size(names.index(a)) for a in axes)
        if tree.shape[d] % parts:
            raise ValueError(
                f"partition spec {tuple(spec_tree)} splits dimension {d} of a "
                f"{tuple(tree.shape)} tensor into {parts} parts over mesh axes {axes}, "
                f"which do not divide it")
    placements = placements_of(spec_tree, mesh)
    if isinstance(tree, DTensor):
        return tree if tree.placements == placements else tree.redistribute(mesh, placements)
    return distribute_tensor(tree, mesh, placements)


def _placed(args, specs, mesh):
    """``args`` placed by ``specs`` on a ``DeviceMesh``; as they are on a
    record."""
    if not isinstance(mesh, DeviceMesh):
        return args
    return tuple(place(a, s, mesh) for a, s in zip(args, specs))


# ---------------------------------------------------------------------------
# Step builders for the dry-run (and the launchers).
# ---------------------------------------------------------------------------
def build_train(cfg: ModelConfig, shape: InputShape, rules: AxisRules,
                *, moe_path: str = "local", param_dtype=torch.bfloat16,
                opt_state_dtype=None, remat=True):
    """(step_fn, arg_specs, partition specs) for a full train step:
    ``train_loop.make_train_step``'s step over (params, opt_state, batch)."""
    # 1T-class models get bf16 optimizer states by default (memory budget)
    if opt_state_dtype is None:
        opt_state_dtype = torch.bfloat16 if cfg.params_total > 200_000_000_000 else torch.float32
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(state_dtype=opt_state_dtype),
        moe_path=moe_path,
        window=decode_window(cfg, shape),
        remat=remat,
    )
    step = make_train_step(cfg, tcfg)
    params = model_lib.abstract_params(cfg, param_dtype)
    opt = adamw_init(params, tcfg.optimizer)
    batch = batch_spec(cfg, shape, param_dtype)
    p_shard = shardings_of(model_lib.param_axes(cfg, param_dtype), rules)
    opt_shard = {"step": (), "m": p_shard, "v": p_shard}
    b_shard = shardings_of(batch_axes(cfg, batch), rules)
    specs = (p_shard, opt_shard, b_shard)
    return step, _placed((params, opt, batch), specs, rules.mesh), specs


def build_prefill(cfg: ModelConfig, shape: InputShape, rules: AxisRules,
                  *, moe_path: str = "local", param_dtype=torch.bfloat16,
                  window_override: Optional[int] = None):
    """(step_fn, arg_specs, partition specs) of ``model.prefill`` over
    (params, inputs, cache[, enc_inputs])."""
    window = decode_window(cfg, shape) if window_override is None else window_override

    def step(params, inputs, cache, enc_inputs=None):
        return model_lib.prefill(cfg, params, inputs, cache, enc_inputs=enc_inputs,
                                 window=window, moe_path=moe_path)

    params = model_lib.abstract_params(cfg, param_dtype)
    batch = batch_spec(cfg, shape, param_dtype)
    cache = cache_spec(cfg, shape, param_dtype)
    p_shard = shardings_of(model_lib.param_axes(cfg, param_dtype), rules)
    b_ax = batch_axes(cfg, batch)
    args = [params, batch["inputs"], cache]
    specs = [p_shard, logical_to_spec(b_ax["inputs"], rules),
             shardings_of(cache_axes(cache), rules)]
    if cfg.is_encoder_decoder:
        args.append(batch["enc_inputs"])
        specs.append(logical_to_spec(b_ax["enc_inputs"], rules))
    return step, _placed(tuple(args), tuple(specs), rules.mesh), tuple(specs)


def build_decode(cfg: ModelConfig, shape: InputShape, rules: AxisRules,
                 *, param_dtype=torch.bfloat16):
    """(step_fn, arg_specs, partition specs) of ``model.decode_step`` over
    (params, tokens, cache)."""
    window = decode_window(cfg, shape)

    def step(params, tokens, cache):
        return model_lib.decode_step(cfg, params, tokens, cache, window=window)

    params = model_lib.abstract_params(cfg, param_dtype)
    cache = cache_spec(cfg, shape, param_dtype)
    tokens = meta((shape.global_batch,), torch.int32)
    specs = (shardings_of(model_lib.param_axes(cfg, param_dtype), rules),
             logical_to_spec(("batch",), rules), shardings_of(cache_axes(cache), rules))
    return step, _placed((params, tokens, cache), specs, rules.mesh), specs


def build_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               moe_path: Optional[str] = None, param_dtype=torch.bfloat16,
               window_override: Optional[int] = None, remat=True):
    """Dispatch on the shape kind.  Returns (step, args, partition specs,
    rules, donate); on a ``DeviceMesh`` the arguments are meta DTensors
    placed by the specs (``place``). ``donate`` is the JAX package's donate_argnums (the
    state-carrying arguments: the cache for serving, params and optimizer
    state for training); the port's prefill and decode steps write the
    cache in place, and its train step returns new params and state."""
    mode = {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]
    cache_len = 0
    if mode == "decode":
        w = decode_window(cfg, shape) if window_override is None else window_override
        cache_len = min(w, shape.seq_len) if w else shape.seq_len
    rules = make_rules(cfg, mesh, mode, batch_size=shape.global_batch, cache_len=cache_len)
    if moe_path is None:
        # the JAX package's default, expert-parallel all-to-all; on one card
        # "ep_a2a" is the sort path (models/moe.py:moe_apply)
        moe_path = "ep_a2a" if cfg.num_experts else "local"
    if mode == "train":
        s, a, sh = build_train(cfg, shape, rules, moe_path=moe_path,
                               param_dtype=param_dtype, remat=remat)
        donate = (0, 1)          # params + optimizer state
    elif mode == "prefill":
        s, a, sh = build_prefill(cfg, shape, rules, moe_path=moe_path,
                                 param_dtype=param_dtype, window_override=window_override)
        donate = (2,)            # the cache being populated
    else:
        s, a, sh = build_decode(cfg, shape, rules, param_dtype=param_dtype)
        donate = (2,)            # the decode cache
    return s, a, sh, rules, donate
