"""The dry-run's partition (``launch/dryrun.py:partition_record``): the
collectives a step's partition over the production mesh issues and the
bytes each device holds, counted over a fake process group (``"fake"``
backend: collectives return at once and move nothing) on meta DTensors.

Held: the ring factors to the reference's ``collective_bytes`` on one-line
HLO strings, for its five collectives at group sizes 1, 2, 4, 16 and 256;
hand-built collectives of known shapes, counted with their bytes; each
``per_device`` entry to the whole bytes of each leaf divided as
``make_rules`` shards it (the three combinations ``chip_smoke.py``'s phase 7
prints, cut to one repetition of the block pattern); ``run_one`` on the
(16, 16) and (2, 16, 16) meshes with the reference's keys; a failed step
recorded, not raised; the group gone afterwards.  The counts are not held
to XLA's: GSPMD picks its own collectives.
"""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.launch.dryrun import collective_bytes
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_rules, production_shape
from repro_torch.training.optimizer import tree_leaves

KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
        "count", "total"}
GROUPS = (1, 2, 4, 16, 256)
PHASE7 = [("qwen1.5-0.5b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"),
          ("whisper-small", "prefill_32k")]


def _cut(cfg):
    """One repetition of the block pattern and the tail, one encoder layer."""
    kw = {"num_layers": len(cfg.block_pattern) + len(cfg.tail_blocks)}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 1
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(autouse=True)
def no_group_left():
    """No test of this file leaves a process group up for the next file."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", dryrun.COLLECTIVES)
def test_ring_factors_equal_the_references(kind, group):
    """The reference reads a collective's result type and group from the
    optimized HLO; the port's factor on the same result bytes is its."""
    line = (f"%c = f32[64,128]{{1,0}} {kind}(f32[64,128]{{1,0}} %p), "
            f"replica_groups=[{256 // group},{group}]<=[256]")
    want = collective_bytes(line)
    assert want["count"] == 1
    assert want[kind] == int(64 * 128 * 4 * dryrun.ring_factor(kind, group))


def test_hand_built_collectives_are_counted_with_their_bytes():
    """On the (16, 16) mesh over 256 fake ranks: DTensor-style functional
    collectives and ``torch.distributed``'s in-place ones, each kind at a
    known shape and group."""
    own = dryrun.fake_group(256)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        model_g, data_g = mesh.get_group("model"), mesh.get_group("data")
        x = torch.empty(32, 64, device="meta")                     # 8192 B
        counter = dryrun.CollectiveCounter()
        with counter:
            funcol.all_reduce(x, "sum", model_g)                  # 2 * 15/16 * 8192
            funcol.all_gather_tensor(x, 0, data_g)                # 15/16 * 16 * 8192
            funcol.reduce_scatter_tensor(x, "sum", 0, model_g)     # 15 * 8192 / 16
            funcol.all_to_all_single(x, None, None, model_g)       # 15/16 * 8192
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=data_g)           # 15/16 * 8192
            dist.all_reduce(out, group=dist.group.WORLD)           # 2 * 255/256 * 8192
            dist.all_gather([torch.empty_like(x) for _ in range(16)], x, group=model_g)
        got = counter.collectives()
    finally:
        if own:
            dist.destroy_process_group()
    b = 8192
    assert got == {
        "all-gather": int(15 / 16 * 16 * b) * 2,
        "all-reduce": int(2 * 15 / 16 * b) + int(2 * 255 / 256 * b),
        "reduce-scatter": int(15 * b / 16),
        "all-to-all": 2 * int(15 / 16 * b),
        "collective-permute": 0, "count": 7,
        "total": int(15 * b) * 2 + int(2 * 15 / 16 * b) + int(2 * 255 / 256 * b)
        + int(15 * b / 16) + 2 * int(15 / 16 * b)}
    assert sum(counter.ops.values()) == 7


def _divided(tree, spec_tree, sizes) -> int:
    """Rank 0's bytes of a tree whose leaves are split as their specs say:
    each sharded dimension ceil-divided by the product of its mesh axes."""
    leaves = tree_leaves(tree)
    spec_leaves = []

    def flat(s):
        if isinstance(s, dict):
            for v in s.values():
                flat(v)
        elif isinstance(s, list):
            for v in s:
                flat(v)
        else:
            spec_leaves.append(s)

    flat(spec_tree)
    assert len(leaves) == len(spec_leaves)
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        shape = list(t.shape)
        for d, axes in enumerate(spec):
            if axes is not None:
                n = math.prod(sizes[a] for a in ((axes,) if isinstance(axes, str) else axes))
                shape[d] = -(-shape[d] // n)
        total += math.prod(shape) * t.element_size()
    return total


@pytest.mark.parametrize("arch,shape_name", PHASE7)
def test_per_device_bytes_are_the_whole_divided_as_the_rules_shard(arch, shape_name):
    cfg, shape = _cut(get_config(arch)), INPUT_SHAPES[shape_name]
    rec = dryrun.partition_record(cfg, shape)
    _, args, arg_specs, rules, _ = specs.build_step(cfg, shape, production_shape())
    sizes = production_shape().shape
    want = {"params": _divided(args[0], arg_specs[0], sizes)}
    if shape.kind == "train":
        want["opt_state"] = _divided(args[1], arg_specs[1], sizes)
        want["batch"] = _divided(args[2], arg_specs[2], sizes)
    else:
        want["cache"] = _divided(args[2], arg_specs[2], sizes)
        want["batch"] = _divided([args[1], *args[3:]], [arg_specs[1], *arg_specs[3:]], sizes)
    want["total"] = sum(want.values())
    assert rec["per_device"] == want
    # and each is the whole divided: params at least 1/16 of the whole
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(args[0]))
    assert whole / 256 <= rec["per_device"]["params"] < whole
    assert rec["collectives"]["count"] > 0 and set(rec["collectives"]) == KEYS


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_run_one_records_collectives_with_the_reference_keys(tmp_path, monkeypatch, multi_pod):
    """qwen1.5-0.5b's decode at one layer on the 256- and 512-rank meshes:
    the reference's keys, ``total`` their sum, every counted op a
    collective, and the two-pod mesh's record beside the one-pod one."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: _cut(get_config(a)))
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", out_dir=str(tmp_path),
                         multi_pod=multi_pod)
    assert rec["ok"], rec.get("error")
    coll = rec["collectives"]
    assert set(coll) == KEYS and coll["count"] == sum(rec["collective_ops"].values()) > 0
    assert coll["total"] == sum(coll[k] for k in dryrun.COLLECTIVES)
    assert rec["partition_mesh"]["sizes"] == ([2, 16, 16] if multi_pod else [16, 16])
    name = "qwen1.5-0.5b__decode_32k" + ("__pod2" if multi_pod else "")
    assert json.loads((tmp_path / f"{name}.json").read_text())["per_device"] == rec["per_device"]


def test_a_failed_partitioned_step_is_recorded_not_raised(tmp_path, monkeypatch):
    """The flop count passes; the partitioned step raises: ``ok`` False with
    the error, written, and the fake group destroyed."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: _cut(get_config(a)))
    real = dryrun.build_step

    def broken(cfg, shape, mesh, **kw):
        if not isinstance(mesh, type(production_shape())):
            raise RuntimeError("no partition")
        return real(cfg, shape, mesh, **kw)

    monkeypatch.setattr(dryrun, "build_step", broken)
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", out_dir=str(tmp_path))
    assert not rec["ok"] and "no partition" in rec["error"]
    assert json.loads((tmp_path / "qwen1.5-0.5b__decode_32k.json").read_text())["ok"] is False


def test_the_rules_of_the_partition_are_the_records():
    """The partition's mesh gets the record's rules (the dry-run's
    ``mesh_rules``)."""
    cfg = get_config("kimi-k2-1t-a32b")
    own = dryrun.fake_group(256)
    try:
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh()
        assert not isinstance(mesh, type(production_shape()))
        for mode in ("train", "prefill", "decode"):
            assert (make_rules(cfg, mesh, mode, batch_size=256, cache_len=32768).rules
                    == make_rules(cfg, production_shape(), mode, batch_size=256,
                                  cache_len=32768).rules)
    finally:
        if own:
            dist.destroy_process_group()
