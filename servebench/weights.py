"""The served weights, made by the benchmark from ``--seed`` on the device.

One ``torch.Generator`` on the device fills one flat buffer per dtype in a
few large calls (chunks of at most 2**30 elements); each leaf is a view of
it, scaled in place: projections by fan_in ** -0.5 (activations stay of
order one through the layers), embeddings and the output head unit scale,
norm scales 1 + 0.1 z and biases 0.1 z, so that a path that drops either
shows.  The tree has the layout the port's model code takes
(``layers[i]["attn"]["wq"]`` ...); the plain reference reads the same
tensors.  The router is f32, as the configuration serves it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
CHUNK = 1 << 30
ALIGN = 128          # elements: every leaf starts on a 256-byte boundary in bf16


def _leaves(cfg: Dict) -> List[Tuple[tuple, tuple, str, str, float]]:
    """(path, shape, dtype name, kind, scale) of every leaf; kind is
    "weight" (scaled z), "norm" (1 + scale z) or "bias" (scale z)."""
    d, v, hd = cfg["d_model"], cfg["vocab_size"], cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]
    nq, nkv, dt = cfg["num_heads"], cfg["num_kv_heads"], cfg["dtype"]
    out = [(("embed",), (v, d), dt, "weight", 1.0),
           (("final_norm", "scale"), (d,), dt, "norm", 0.1)]
    for i in range(cfg["num_layers"]):
        L = ("layers", i)
        out += [(L + ("norm1", "scale"), (d,), dt, "norm", 0.1),
                (L + ("attn", "wq"), (d, nq, hd), dt, "weight", d ** -0.5),
                (L + ("attn", "wk"), (d, nkv, hd), dt, "weight", d ** -0.5),
                (L + ("attn", "wv"), (d, nkv, hd), dt, "weight", d ** -0.5),
                (L + ("attn", "wo"), (nq, hd, d), dt, "weight", (nq * hd) ** -0.5)]
        if cfg.get("qkv_bias"):
            out += [(L + ("attn", "bq"), (nq, hd), dt, "bias", 0.1),
                    (L + ("attn", "bk"), (nkv, hd), dt, "bias", 0.1),
                    (L + ("attn", "bv"), (nkv, hd), dt, "bias", 0.1)]
        out.append((L + ("norm2", "scale"), (d,), dt, "norm", 0.1))
        if cfg.get("num_experts"):
            e, ff = cfg["num_experts"], cfg.get("expert_d_ff") or cfg["d_ff"]
            out += [(L + ("moe", "router"), (d, e), "float32", "weight", d ** -0.5),
                    (L + ("moe", "wi_gate"), (e, d, ff), dt, "weight", d ** -0.5),
                    (L + ("moe", "wi_up"), (e, d, ff), dt, "weight", d ** -0.5),
                    (L + ("moe", "wo"), (e, ff, d), dt, "weight", ff ** -0.5)]
        else:
            ff = cfg["d_ff"]
            out += [(L + ("mlp", "wi_gate"), (d, ff), dt, "weight", d ** -0.5),
                    (L + ("mlp", "wi_up"), (d, ff), dt, "weight", d ** -0.5),
                    (L + ("mlp", "wo"), (ff, d), dt, "weight", ff ** -0.5)]
    if not cfg.get("tie_embeddings"):
        out.append((("lm_head",), (v, d), dt, "weight", 1.0))
    return out


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def param_count(cfg: Dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _, _ in _leaves(cfg))


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The weight tree of ``cfg`` drawn from ``seed`` on ``device``."""
    leaves = _leaves(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    offsets, sizes = [], {}
    for _, shape, dt, _, _ in leaves:
        n = math.prod(shape)
        start = sizes.get(dt, 0)
        offsets.append(start)
        sizes[dt] = start + -(-n // ALIGN) * ALIGN
    flats = {}
    for dt in sorted(sizes):
        flat = torch.empty(sizes[dt], dtype=DTYPES[dt], device=device)
        for lo in range(0, sizes[dt], CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        flats[dt] = flat
    tree: Dict = {}
    for (path, shape, dt, kind, scale), start in zip(leaves, offsets):
        leaf = flats[dt][start:start + math.prod(shape)].view(shape)
        leaf.mul_(scale)
        if kind == "norm":
            leaf.add_(1.0)
        _put(tree, path, leaf)
    return tree
