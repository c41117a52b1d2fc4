"""Dry-run: the FLOPs and bytes of every (architecture x input shape) step,
from meta tensors, and the collectives and per-device bytes of its
partition over the production mesh.

The JAX package's dry-run (``repro/launch/dryrun.py``) lowers each step
with production shardings for the TPU mesh, compiles it and records XLA's
memory and cost analyses and every collective's bytes from the optimized
HLO.  This twin has no HLO.  It builds the same step
(``launch/specs.py:build_step``: train, prefill or decode, the port's own
``make_train_step``, ``prefill`` and ``decode_step``) twice on meta tensors
(no storage, no values: kimi-k2's 1 T parameters cost nothing) and runs
it:

  * on the record of the single-pod mesh, plain meta tensors, counting
    ``flops`` and the whole bytes (``record``);
  * on the production ``DeviceMesh`` over a fake process group of 256
    ranks (512 with ``--multi-pod``; ``torch.testing``'s ``FakeStore``,
    backend ``"fake"``: collectives return at once and move nothing),
    arguments as meta DTensors placed by the specs, the step partitioned as
    on real ranks (``distributed/sharding.py``), counting what rank 0's
    part moves and holds (``partition_record``).

It records:

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
    and the logical-axis rules under the JAX package's single-pod mesh;
  * ``collectives``: the reference's keys (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``, ``count``,
    ``total``): each collective the partitioned step issues, seen by a
    ``TorchDispatchMode`` (``CollectiveCounter``: the ``_c10d_functional``
    ops DTensor's redistributions issue, the ``c10d`` ops of the paths that
    partition by hand), its result's bytes times the reference's ring
    factor for its group size (``ring_factor``); ``collective_ops`` counts
    them by op;
  * ``per_device``: the bytes of rank 0's local shards of the parameters,
    the optimizer state, the cache and the batch, and their ``total``: the
    arguments' part of the reference's ``memory_analysis``.

The collectives are not held to XLA's: GSPMD picks its own.  XLA-only
parts get no twin: ``_compile_metrics``, ``_probe_cfg`` and
``_extrapolate`` exist because XLA counts a scan body once.

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
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config, list_architectures
from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RGLRU, RWKV, InputShape, ModelConfig
from repro_torch.distributed.sharding import axis_rules
from repro_torch.kernels.ref import RWKV_CHUNK, RWKV_SUB
from repro_torch.launch.mesh import make_production_mesh, production_shape
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
    mesh = production_shape()
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


# ---------------------------------------------------------------------------
# The partition: collectives and per-device bytes over a fake process group.
# ---------------------------------------------------------------------------
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
#: the ops a step's collectives reach the dispatcher as, by the reference's
#: HLO names: the functional ones of DTensor's redistributions and the
#: in-place ``c10d`` ones of ``torch.distributed``'s calls (moe_ep_a2a)
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
#: the in-place c10d ops' output argument (their result)
_C10D_OUT = {"c10d.alltoall_base_": 0, "c10d.alltoall_": 0, "c10d.allgather_": 0,
             "c10d._allgather_base_": 0, "c10d.reduce_scatter_": 0,
             "c10d._reduce_scatter_base_": 0, "c10d.allreduce_": 0, "c10d.send": 0,
             "c10d.recv_": 0}


def ring_factor(kind: str, group: int) -> float:
    """Bytes moved a byte of a collective's result under the reference's
    ring factors (``repro/launch/dryrun.py:collective_bytes``): all-gather
    and all-to-all (S-1)/S, all-reduce 2 (S-1)/S, reduce-scatter S-1,
    collective-permute 1; 0 for a group of one."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group
    if kind == "reduce-scatter":
        return float(group - 1)
    if kind == "collective-permute":
        return 1.0
    return (group - 1) / group


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    """The group size of a collective op's arguments: a process group
    (``c10d``), a group name, or the functional ops' ``group_size``."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:          # another script object (a reduce op)
                continue
    names = [a for a in args if isinstance(a, str)]      # the group name comes last
    if names:
        return dist.distributed_c10d._resolve_process_group(names[-1]).size()
    raise ValueError("no process group among a collective's arguments")


class CollectiveCounter(TorchDispatchMode):
    """Every collective op dispatched under it: ``collectives()`` sums each
    kind's result bytes times ``ring_factor`` (the reference's
    ``collective_bytes``), ``ops`` counts them by op."""

    def __init__(self):
        super().__init__()
        self.moved = {c: 0 for c in COLLECTIVES}
        self.count = 0
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor dispatch with this mode still on the stack, so that
            # the collectives of the redistributions it decides inside its
            # dispatch come through here too (as CommDebugMode does)
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = f"{func.namespace}.{func._opname}"
        kind = _KIND.get(name)
        if kind is not None:
            result = args[_C10D_OUT[name]] if name in _C10D_OUT else out
            self.record(kind, _tensor_bytes(result), _group_size(args))
            self.ops[name] = self.ops.get(name, 0) + 1
        return out

    def record(self, kind: str, nbytes: int, group: int) -> None:
        self.moved[kind] += int(nbytes * ring_factor(kind, group))
        self.count += 1

    def collectives(self) -> Dict[str, int]:
        out = dict(self.moved, count=self.count)
        out["total"] = sum(self.moved.values())
        return out


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size() for t in tree_leaves(tree) if t is not None)


def fake_group(world: int):
    """Bring up a fake process group of ``world`` ranks (this process is
    rank 0) unless one of that size is up; returns whether it did (then the
    caller destroys it)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up, "
                               f"the mesh needs {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def partition_record(cfg: ModelConfig, shape: InputShape, *, multi_pod: bool = False) -> dict:
    """Build ``cfg``'s step at ``shape`` on the production ``DeviceMesh``
    over a fake process group (brought up here and destroyed before
    returning, unless one of the mesh's size is already up), run it on meta
    DTensors and return ``collectives``, ``collective_ops`` and
    ``per_device``."""
    world = math.prod(production_shape(multi_pod=multi_pod).sizes)
    own = fake_group(world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        step, args, _, rules, _ = build_step(cfg, shape, mesh)
        # the arguments as placed, before the step (prefill adds to its cache)
        per_device = {"params": _local_bytes(args[0])}
        if shape.kind == "train":
            per_device["opt_state"] = _local_bytes(args[1])
            per_device["batch"] = _local_bytes(args[2])
        else:
            per_device["cache"] = _local_bytes(args[2])
            per_device["batch"] = _local_bytes([args[1], *args[3:]])
        per_device["total"] = sum(per_device.values())
        counter = CollectiveCounter()
        with axis_rules(rules), counter:
            step(*args)
        return {"collectives": counter.collectives(), "collective_ops": counter.ops,
                "per_device": per_device,
                "partition_mesh": {"names": list(mesh.mesh_dim_names),
                                   "sizes": list(mesh.mesh.shape)}}
    finally:
        if own:
            dist.destroy_process_group()


def run_one(arch: str, shape_name: str, *, out_dir: str = ARTIFACT_DIR,
            multi_pod: bool = False) -> dict:
    """``record`` of ``arch`` at ``shape_name`` and its ``partition_record``
    on the single-pod (``multi_pod``: two-pod) mesh, written to
    ``<out_dir>/<arch>__<shape>.json`` (``__pod2`` added for the two-pod
    mesh); ``ok`` False with the error where a step fails."""
    t0 = time.perf_counter()
    try:
        cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
        rec = record(cfg, shape)
        t1 = time.perf_counter()
        rec.update(partition_record(cfg, shape, multi_pod=multi_pod))
        rec["partition_seconds"] = time.perf_counter() - t1
        rec["ok"] = True
        print(f"[dryrun] OK   {arch} {shape_name}: flops {rec['flops']:.4e} (ideal "
              f"{rec['flops_ideal']:.4e}), params {rec['bytes']['params'] / 1e9:.2f} GB, "
              f"collectives {rec['collectives']['total'] / 1e9:.4f} GB in "
              f"{rec['collectives']['count']}, per device {rec['per_device']['total'] / 1e9:.4f} "
              f"GB, {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, don't stop --all
        rec = {"arch": arch, "shape": shape_name, "ok": False,
               "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-2000:],
               "seconds": time.perf_counter() - t0}
        print(f"[dryrun] FAIL {arch} {shape_name}: {rec['error'][:200]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    pod = "__pod2" if multi_pod else ""
    with open(os.path.join(out_dir, f"{arch}__{shape_name}{pod}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="every (arch x input shape)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="partition over the two-pod (2, 16, 16) mesh, 512 fake ranks")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args()
    kw = dict(out_dir=args.out, multi_pod=args.multi_pod)
    if args.all:
        recs = [run_one(a, s, **kw) for a in list_architectures() for s in INPUT_SHAPES]
        raise SystemExit(0 if all(r["ok"] for r in recs) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) required")
    rec = run_one(args.arch, args.shape, **kw)
    if rec["ok"]:
        keys = ("flops", "flops_analytic", "flops_ideal", "bytes", "collectives", "per_device")
        print(json.dumps({k: rec[k] for k in keys if k in rec}, indent=1))
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
