"""Parameter trees: plain nested dicts of tensors, with logical-axis
annotations.

Blocks are a list in layer order (``params["layers"]``), not stacked along
a layer axis as the JAX package stacks them for ``lax.scan``: PyTorch runs
the layers in a Python loop.  ``params_from_jax`` converts a JAX parameter
tree so both packages can run on the same weights; JAX's threefry draws
cannot be reproduced with a ``torch.Generator``.

The init functions build ``{name: Boxed(value, axes)}`` trees, as the JAX
package's do: ``values_of`` gives the tensors, ``axes_of`` the logical axes
of each leaf (what ``launch/specs.py`` turns into partition specs).  Built
on the ``meta`` device, a tree allocates nothing and draws nothing, so
kimi-k2's 1 T parameters can be described without memory.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import ModelConfig


def normal(gen: Optional[torch.Generator], shape: Sequence[int], scale: float, dtype,
           device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn on the generator's device, in f32, then
    cast; on the meta device an empty tensor, with nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(device=device, dtype=dtype)   # in place: one f32 copy at a time


@dataclasses.dataclass
class Boxed:
    """A parameter and the logical axis of each of its dimensions."""
    value: Any
    axes: Tuple[Optional[str], ...]


def is_boxed(x) -> bool:
    return isinstance(x, Boxed)


def boxed_normal(gen: Optional[torch.Generator], shape, axes, scale: float, dtype,
                 device) -> Boxed:
    assert len(shape) == len(axes), (shape, axes)
    return Boxed(normal(gen, shape, scale, dtype, device), tuple(axes))


def boxed_zeros(shape, axes, dtype, device) -> Boxed:
    assert len(shape) == len(axes), (shape, axes)
    return Boxed(torch.zeros(tuple(shape), dtype=dtype, device=device), tuple(axes))


def boxed_ones(shape, axes, dtype, device) -> Boxed:
    assert len(shape) == len(axes), (shape, axes)
    return Boxed(torch.ones(tuple(shape), dtype=dtype, device=device), tuple(axes))


def boxed_value(value, axes) -> Boxed:
    return Boxed(value, tuple(axes))


def _map_boxed(fn: Callable[[Boxed], Any], tree):
    """``fn`` on every Boxed leaf of nested dicts and lists."""
    if is_boxed(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_boxed(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_boxed(fn, v) for v in tree]
    raise TypeError(f"not a Boxed tree leaf: {type(tree).__name__}")


def values_of(tree):
    return _map_boxed(lambda b: b.value, tree)


def axes_of(tree):
    return _map_boxed(lambda b: b.axes, tree)


def unbox(tree):
    """Split a Boxed tree into (values, axes) trees of identical structure."""
    return values_of(tree), axes_of(tree)


def _leaf(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):      # e.g. a restored checkpoint's leaf
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: no numpy->torch bridge
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(tree, fn, name=""):
    """``fn(leaf, name)`` on every leaf of a nested dict, ``name`` its key."""
    if isinstance(tree, dict):
        return {k: _convert(v, fn, k) for k, v in tree.items()}
    return fn(tree, name)


def from_jax_layout(cfg: ModelConfig, tree: Dict[str, Any], leaf: Callable[[Any, str], Any],
                    stacked: Callable[[Any, str, int], Any]) -> Dict[str, Any]:
    """A tree of the JAX package's parameter layout in the port's.

    JAX stacks each block kind of the repeating pattern along axis 0
    (``blocks/p{i}_{kind}``, one entry per repetition; whisper's decoder
    blocks ``blocks/dec``) and keeps the tail's blocks unstacked
    (``tail/t{j}_{kind}``); the port lists the blocks in the order the model
    runs them, the tail last.  Whisper's encoder blocks (``encoder/blocks``,
    stacked) become the list ``encoder/blocks`` beside ``encoder/final_norm``.
    ``leaf(x, name)`` converts an unstacked leaf and ``stacked(x, name, r)``
    repetition ``r`` of a stacked one (``name`` is the leaf's key)."""
    from repro_torch.models.model import block_key   # model imports this module

    unstack = lambda t, r: _convert(t, lambda a, name: stacked(a, name, r))
    tail = cfg.tail_blocks
    layers = []
    for r in range((cfg.num_layers - len(tail)) // len(cfg.block_pattern)):
        for i, kind in enumerate(cfg.block_pattern):
            layers.append(unstack(tree["blocks"][block_key(cfg, i, kind)], r))
    layers += [_convert(tree["tail"][f"t{j}_{kind}"], leaf) for j, kind in enumerate(tail)]
    out = {
        "embed": leaf(tree["embed"], "embed"),
        "final_norm": _convert(tree["final_norm"], leaf),
        "layers": layers,
    }
    if "lm_head" in tree:
        out["lm_head"] = leaf(tree["lm_head"], "lm_head")
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": [unstack(enc["blocks"], r) for r in range(cfg.encoder_layers)],
            "final_norm": _convert(enc["final_norm"], leaf),
        }
    return out


def params_from_jax(
    cfg: ModelConfig,
    tree: Dict[str, Any],
    *,
    dtype: Optional[torch.dtype] = None,
    device="cpu",
) -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``) or of tensors (the JAX package's
    parameter checkpoint as ``checkpoint.restore_checkpoint`` rebuilds it,
    bf16 leaves included, with no ``ml_dtypes``), unstacked by
    ``from_jax_layout``.  ``dtype`` None keeps each leaf's own; the leaves
    the JAX package keeps in f32 (RWKV's ``mu``, ``cm_mu``, ``w0``, ``u``,
    the MoE router and the RG-LRU's Lambda ``lam``) stay f32.
    """
    # moe, rwkv and griffin import this module
    from repro_torch.models import griffin, moe, rwkv

    f32 = rwkv.F32_LEAVES + moe.F32_LEAVES + griffin.F32_LEAVES
    to_t = lambda a, name: _leaf(a, None if name in f32 else dtype, device)
    return from_jax_layout(cfg, tree, to_t, lambda a, name, r: to_t(a[r], name))
