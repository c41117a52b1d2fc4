"""NumPy-based checkpointing: trees -> flat key/value .npz + metadata.

The JAX package's layout: one ``{name}_{step:08d}.npz`` whose keys are the
path of each leaf, ``k:<dict key>`` and ``i:<list index>`` joined by
``__/__``, beside a ``.json`` holding the step.  Atomic (write to a temp
file, then rename), step-indexed, restartable.  A tree is the port's nested
dicts and lists of tensors (or NumPy arrays and Python scalars).  bfloat16
has no NumPy type without ``ml_dtypes``: its leaves are stored as their raw
``uint16`` bits and viewed back through torch, so a checkpoint either
package writes restores in the other, bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_SEP = "__/__"


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list tree, a path being the key
    strings from the root down."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (f"k:{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"i:{i}",))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _structure(tree) -> str:
    """The tree's shape with its leaves elided, for the sidecar."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(v)}" for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def save_checkpoint(directory: str, step: int, tree: Any, *, name: str = "state") -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {_SEP.join(path): _to_numpy(leaf) for path, leaf in _paths(tree)}
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    meta = os.path.join(directory, f"{name}_{step:08d}.json")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:      # a file object: np.savez adds no suffix
            np.savez(f, **flat)
        with open(meta + ".tmp", "w") as f:
            json.dump({"step": step, "treedef": _structure(tree)}, f)
        os.replace(tmp, path)
        os.replace(meta + ".tmp", meta)
    finally:
        for leftover in (tmp, meta + ".tmp"):
            if os.path.exists(leftover):
                os.remove(leftover)
    return path


def _from_numpy(arr: np.ndarray, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A stored array as a tensor: ``uint16`` bits become bfloat16 where
    ``dtype`` is bfloat16, or is None (no template: the port stores no
    genuine uint16 leaf)."""
    if arr.dtype == np.uint16 and dtype in (None, torch.bfloat16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def restore_checkpoint(directory: str, step: int, like: Any = None, *, name: str = "state",
                       device="cpu") -> Any:
    """Restore into the structure of ``like`` (each leaf a tensor giving the
    shape, dtype and device of the restored one).  With ``like`` None, the
    tree is rebuilt from the stored keys (dicts from ``k:``, lists from
    ``i:``) as tensors on ``device``, bf16 leaves recovered from their bits:
    the form ``models.params.params_from_jax`` takes, for a checkpoint of
    the JAX package's parameters."""
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    with np.load(path) as data:
        if like is None:
            return _unflatten_keys({k: _from_numpy(data[k], None, device) for k in data.files})
        flat = [(_SEP.join(p), leaf) for p, leaf in _paths(like)]
        leaves = {}
        for key, leaf in flat:
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: stored shape {arr.shape}, template {tuple(leaf.shape)}")
            leaves[key] = _from_numpy(arr, leaf.dtype, leaf.device)
    return _fill(like, leaves)


def _fill(like, leaves, prefix=()):
    if isinstance(like, dict):
        return {k: _fill(v, leaves, prefix + (f"k:{k}",)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, leaves, prefix + (f"i:{i}",)) for i, v in enumerate(like))
    return leaves[_SEP.join(prefix)]


def _unflatten_keys(flat: dict) -> Any:
    """Nested dicts and lists from ``k:``/``i:`` key paths."""
    root: dict = {}
    for key, leaf in flat.items():
        node, parts = root, key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        kinds = {part[:2] for part in node}
        if kinds == {"i:"}:
            return [build(node[f"i:{i}"]) for i in range(len(node))]
        if kinds != {"k:"}:
            raise ValueError(f"keys {sorted(node)} are neither all k: nor all i:")
        return {part[2:]: build(v) for part, v in node.items()}

    return build(root)


def latest_step(directory: str, *, name: str = "state") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"{re.escape(name)}_(\d+)\.npz$")
    steps = [int(m.group(1)) for f in os.listdir(directory) if (m := pat.match(f))]
    return max(steps) if steps else None
