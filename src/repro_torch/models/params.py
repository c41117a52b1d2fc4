"""Parameter trees: plain nested dicts of tensors.

Blocks are a list in layer order (``params["layers"]``), not stacked along
a layer axis as the JAX package stacks them for ``lax.scan``: PyTorch runs
the layers in a Python loop.  ``params_from_jax`` converts a JAX parameter
tree so both packages can run on the same weights; JAX's threefry draws
cannot be reproduced with a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import ModelConfig


def normal(gen: torch.Generator, shape: Sequence[int], scale: float, dtype, device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn on the generator's device, in f32, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(device=device, dtype=dtype)


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
    bf16 leaves included, with no ``ml_dtypes``).

    JAX stacks each block kind of the repeating pattern along axis 0
    (``blocks/p{i}_{kind}``, one entry per repetition; whisper's decoder
    blocks ``blocks/dec``) and keeps the tail's blocks unstacked
    (``tail/t{j}_{kind}``); the port lists the blocks in the order the model
    runs them, the tail last.  Whisper's encoder blocks (``encoder/blocks``,
    stacked) become the list ``encoder/blocks`` beside ``encoder/final_norm``.
    ``dtype`` None keeps each leaf's own; the leaves the JAX package keeps
    in f32 (RWKV's ``mu``, ``cm_mu``, ``w0``, ``u``, the MoE router and the
    RG-LRU's Lambda ``lam``) stay f32.
    """
    # model, moe, rwkv and griffin import this module
    from repro_torch.models import griffin, moe, rwkv
    from repro_torch.models.model import block_key

    f32 = rwkv.F32_LEAVES + moe.F32_LEAVES + griffin.F32_LEAVES
    to_t = lambda a, name="": _leaf(a, None if name in f32 else dtype, device)
    unstack = lambda stacked, r: _convert(stacked, lambda a, name: to_t(a[r], name))
    tail = cfg.tail_blocks
    layers = []
    for r in range((cfg.num_layers - len(tail)) // len(cfg.block_pattern)):
        for i, kind in enumerate(cfg.block_pattern):
            layers.append(unstack(tree["blocks"][block_key(cfg, i, kind)], r))
    layers += [_convert(tree["tail"][f"t{j}_{kind}"], to_t) for j, kind in enumerate(tail)]
    out = {
        "embed": to_t(tree["embed"]),
        "final_norm": _convert(tree["final_norm"], to_t),
        "layers": layers,
    }
    if "lm_head" in tree:
        out["lm_head"] = to_t(tree["lm_head"])
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": [unstack(enc["blocks"], r) for r in range(cfg.encoder_layers)],
            "final_norm": _convert(enc["final_norm"], to_t),
        }
    return out
