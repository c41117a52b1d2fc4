"""Dry-run on one card: the FLOPs and bytes of every (architecture x input
shape) step, from meta tensors.

The JAX package's dry-run (``repro/launch/dryrun.py``) lowers each step
with production shardings for a 512-device TPU mesh, compiles it and
records XLA's memory and cost analyses and every collective's bytes from
the optimized HLO.  One card has no mesh to lower for and no HLO, so this
twin records no collectives and no HLO.  It builds the same step
(``launch/specs.py:build_step``: train, prefill or decode, the port's own
``make_train_step``, ``prefill`` and ``decode_step``) on meta tensors, runs
it there (no storage, no values: kimi-k2's 1 T parameters cost nothing) and
records:

  * ``flops``: the step's product FLOPs, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    convolutions and attention-like ops, 2 per multiply-add; XLA's
    ``cost_analysis`` also counts elementwise work, so the two counters
    differ by design);
  * ``flops_analytic`` and its parts: the same products counted from the
    config and the shapes alone (``analytic_flops``), which ``flops`` must
    equal within ``ANALYTIC_RTOL`` (at ``reduced()`` the tests also hold
    ``flops`` to the dot FLOPs of the JAX package's lowered step);
  * ``flops_ideal``: 2 x active parameters x tokens plus attention's
    visible pairs (4 hd a pair and query head), x 3 for a train step: the
    work of a path that multiplies no masked pair, no padding and no
    capacity slack;
  * the bytes of the parameters, the optimizer state (train), the cache
    (prefill, decode) and the batch, ``params_total`` and ``params_active``,
    and the logical-axis rules under the JAX package's single-pod mesh.

What the meta step multiplies.  ``kernels/ops.py`` sends meta tensors to
the plain versions.  Attention multiplies every (query, key) pair of its
Sq x Sk grid, masked or not, as the jnp attention the JAX package's dry-run
lowers does, except a sliding-window layer on a prompt longer than twice
its window (blocks of W queries against 2W keys).  A decode step scores
every cache slot.  The MoE sort path runs every expert over its capacity's
rows (``moe._capacity``).  The WKV recurrence takes its chunk-parallel
plain form (``ref.rwkv6_chunk_parallel_reference``): 32-token chunks (a
decode step's one token padded to one), whose Python loop runs over chunks,
not tokens, so rwkv6-1.6b at 32 k tokens is 1,024 steps, not 32,768.  A
train step keeps the JAX package's default of remat on, so it holds one
recomputed forward of the layers besides the backward's two products for
each forward one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config, list_architectures
from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RGLRU, RWKV, InputShape, ModelConfig
from repro_torch.distributed.sharding import axis_rules
from repro_torch.kernels.ref import RWKV_CHUNK, RWKV_SUB
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_step, decode_window
from repro_torch.models import moe as moe_lib
from repro_torch.models.griffin import NUM_BLOCKS
from repro_torch.models.rwkv import DECAY_LORA_RANK
from repro_torch.training.optimizer import tree_leaves

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")
#: ``flops`` against ``flops_analytic``: both count the same products, each
#: multiply-add as 2, in integers well below 2^53 once summed in floats;
#: the margin is for float rounding of sums near 1e19, not for missing terms
ANALYTIC_RTOL = 1e-9


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if t is not None)


def _attn_pairs(cfg: ModelConfig, kind: str, b: int, sq: int, sk: int, window: int) -> int:
    """(query, key) pairs the plain attention of one full-sequence layer
    multiplies: the whole Sq x Sk grid, or blocks of W queries against 2W
    keys where ``ops.flash_attention`` takes the blocked local form."""
    w = cfg.local_window if kind == LOCAL_ATTN else window
    if w > 0 and sq == sk and sq > 2 * w:
        return b * -(-sq // w) * w * 2 * w
    return b * sq * sk


def _visible_pairs(cfg: ModelConfig, kind: str, b: int, s: int, window: int) -> int:
    """Causal pairs a query at position i sees, i < S, under the layer's window."""
    w = cfg.local_window if kind == LOCAL_ATTN else window
    if not w or w >= s:
        return b * s * (s + 1) // 2
    return b * (w * (w + 1) // 2 + (s - w) * w)


def analytic_flops(cfg: ModelConfig, shape: InputShape, remat=True) -> Dict[str, int]:
    """The step's product FLOPs from the config and shapes (2 a multiply-add):
    the parts ``projections`` (every weight product a token passes
    through, the MoE experts over their capacity's rows), ``attention``
    (4 hd a multiplied pair and query head), ``wkv`` (the chunk-parallel
    form's four products a chunk and head), ``unembed`` (the tokens the step
    unembeds), ``total``, and ``ideal`` (2 x active parameters x tokens +
    visible pairs, the form a kernel path that skips masked pairs would
    approach)."""
    b, s, mode = shape.global_batch, shape.seq_len, shape.kind
    window = decode_window(cfg, shape)
    d, hd, nq, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    ff, v = cfg.d_ff, cfg.vocab_size
    full = mode in ("train", "prefill")
    t = b * s if full else b                     # tokens through the layers
    mlp = (3 if cfg.mlp == "swiglu" else 2) * d * ff
    qkvo = d * hd * (2 * nq + 2 * nkv)
    parts = {"projections": 0, "attention": 0, "wkv": 0, "unembed": 0}
    visible = 0
    # the dense MLPs' output products: remat's recompute stops before them
    # (below), since no backward saves their output
    mlp_out = 0
    # forward products a train step's backward does not differentiate
    not_differentiated = 0
    if cfg.is_encoder_decoder and full:           # the encoder over the frames, and each
        f = b * cfg.encoder_seq                   # decoder layer's cross K/V of them
        parts["projections"] += 2 * f * (cfg.encoder_layers * (qkvo + mlp)
                                         + cfg.num_layers * 2 * d * nkv * hd)
        mlp_out += cfg.encoder_layers * 2 * f * d * ff
        parts["attention"] += cfg.encoder_layers * 4 * hd * nq * b * cfg.encoder_seq ** 2
        visible += cfg.encoder_layers * b * cfg.encoder_seq ** 2
    for kind in cfg.layer_kinds():
        if kind in (ATTN, LOCAL_ATTN):
            parts["projections"] += 2 * t * qkvo
            if cfg.num_experts:
                rows = cfg.num_experts * moe_lib._capacity(cfg, t)
                e_ff = cfg.expert_d_ff or ff
                parts["projections"] += 2 * t * d * cfg.num_experts + 2 * rows * 3 * d * e_ff
            else:
                parts["projections"] += 2 * t * mlp
                mlp_out += 2 * t * d * ff
            if full:
                pairs = _attn_pairs(cfg, kind, b, s, s, window)
                visible += _visible_pairs(cfg, kind, b, s, window)
            else:
                w = cfg.local_window if kind == LOCAL_ATTN else window
                pairs = b * (min(w, s) if w else s)
                visible += pairs
            parts["attention"] += 4 * hd * nq * pairs
            if cfg.is_encoder_decoder:            # cross-attention: q and o, the frames
                parts["projections"] += 2 * t * 2 * d * nq * hd
                cross = b * (s if full else 1) * cfg.encoder_seq
                parts["attention"] += 4 * hd * nq * cross
                visible += cross
        elif kind == RWKV:
            r = DECAY_LORA_RANK
            parts["projections"] += 2 * t * (6 * d * d + 2 * d * r + 2 * d * ff)
            h, k = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            per_seq = -(-(s if full else 1) // RWKV_CHUNK)
            chunks = b * h * per_seq
            c, e = RWKV_CHUNK, RWKV_SUB
            parts["wkv"] += chunks * (2 * e * e * k + 2 * c * c * k + 4 * c * k * k)
            if per_seq == 1:
                # one chunk: its carry-in is the zero state, which takes no
                # gradient, and its state increment only makes the final
                # state, which no loss reads
                not_differentiated += chunks * 3 * c * k * k
        elif kind == RGLRU:
            w = cfg.rglru_width or d
            parts["projections"] += 2 * t * (3 * d * w + 2 * w * (w // NUM_BLOCKS)) + 2 * t * mlp
            mlp_out += 2 * t * d * ff
        else:
            raise ValueError(kind)
    parts["unembed"] = 2 * d * v * t if mode == "train" else 2 * d * v * b
    fwd = sum(parts.values())
    tokens = t
    ideal = 2 * cfg.params_active * tokens + 4 * hd * nq * visible
    if mode == "train":
        # the backward multiplies twice for each forward product; under remat
        # each layer's forward runs again in the backward, up to the last
        # tensor its backward saved (torch.utils.checkpoint's non-reentrant
        # recompute stops there): all but a dense MLP's output product
        recompute = {k: n if remat and k != "unembed" else 0 for k, n in parts.items()}
        recompute["projections"] -= mlp_out if remat else 0
        parts = {k: 3 * n + recompute[k] for k, n in parts.items()}
        parts["wkv"] -= 2 * not_differentiated
        ideal *= 3
    return {**parts, "total": sum(parts.values()), "ideal": ideal}


def record(cfg: ModelConfig, shape: InputShape) -> dict:
    """Build ``cfg``'s step at ``shape`` on meta tensors, count it and
    return the record; raises where the step fails or its count leaves the
    analytic one."""
    mesh = make_production_mesh()
    t0 = time.perf_counter()
    step, args, _, rules, _ = build_step(cfg, shape, mesh)
    counter = FlopCounterMode(display=False)
    with axis_rules(rules), counter:
        step(*args)
    flops = counter.get_total_flops()
    analytic = analytic_flops(cfg, shape)
    nbytes = {"params": _nbytes(args[0])}
    if shape.kind == "train":
        nbytes["opt_state"] = _nbytes(args[1])
        nbytes["batch"] = _nbytes(args[2])
    else:
        nbytes["cache"] = _nbytes(args[2])
        nbytes["batch"] = _nbytes([args[1], *args[3:]])
    rec = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
        "layers": cfg.num_layers, "device": "meta",
        "flops": flops,
        "flops_by_op": {str(op): n for op, n in counter.get_flop_counts()["Global"].items()},
        "flops_analytic": analytic["total"],
        "flops_analytic_parts": {k: n for k, n in analytic.items() if k not in ("total", "ideal")},
        "flops_vs_analytic": flops / analytic["total"],
        "flops_ideal": analytic["ideal"],
        "bytes": nbytes,
        "params_total": cfg.params_total,
        "params_active": cfg.params_active,
        "mesh_rules": {"mesh": mesh.shape,
                       "rules": {k: list(x) if isinstance(x, tuple) else x
                                 for k, x in rules.rules.items()}},
        "seconds": time.perf_counter() - t0,
    }
    if not abs(rec["flops_vs_analytic"] - 1.0) <= ANALYTIC_RTOL:
        raise AssertionError(f"{cfg.name} {shape.name}: counted {flops} product FLOPs, "
                             f"analytic {analytic['total']}")
    return rec


def run_one(arch: str, shape_name: str, *, out_dir: str = ARTIFACT_DIR) -> dict:
    """``record`` of ``arch`` at ``shape_name``, written to
    ``<out_dir>/<arch>__<shape>.json``; ``ok`` False with the error where
    the step fails."""
    t0 = time.perf_counter()
    try:
        rec = {**record(get_config(arch), INPUT_SHAPES[shape_name]), "ok": True}
        print(f"[dryrun] OK   {arch} {shape_name}: flops {rec['flops']:.4e} (ideal "
              f"{rec['flops_ideal']:.4e}), params {rec['bytes']['params'] / 1e9:.2f} GB, "
              f"{rec['seconds']:.1f} s", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, don't stop --all
        rec = {"arch": arch, "shape": shape_name, "ok": False,
               "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-2000:],
               "seconds": time.perf_counter() - t0}
        print(f"[dryrun] FAIL {arch} {shape_name}: {rec['error'][:200]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x input shape)")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args()
    if args.all:
        recs = [run_one(a, s, out_dir=args.out) for a in list_architectures() for s in INPUT_SHAPES]
        raise SystemExit(0 if all(r["ok"] for r in recs) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) required")
    rec = run_one(args.arch, args.shape, out_dir=args.out)
    if rec["ok"]:
        print(json.dumps({k: rec[k] for k in ("flops", "flops_analytic", "flops_ideal", "bytes")},
                         indent=1))
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
