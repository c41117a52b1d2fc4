"""The partitioned step: ``launch/specs.py:build_step`` on a real
``DeviceMesh``, its arguments DTensors placed by ``shardings_of`` (the
reference's ``in_shardings``), ``shard`` a ``redistribute``, the kernels
behind ``local_map`` (``distributed/sharding.py``, ``kernels/ops.py``).

The runs (``tests/torch_dist_workers.py``, jobs ``step`` and ``jax_step``):
four gloo ranks meeting through a ``FileStore`` run qwen1.5-0.5b and
phi3.5-moe (EP, its capacity factor raised so that no expert drops a token)
at ``reduced()`` on (2, 2) and (1, 4) meshes: ``loss_fn``'s loss and every
gradient leaf, one ``make_train_step`` step, a prefill and two decode
steps, on DTensors and again unsharded (every rank's whole plain tensors
under the same rules: for phi the MoE layers' EP by hand, whose aux is the
mean of its shards' load-balance losses, the reference's ``pmean``); the
reference runs its own jitted with its specs' ``in_shardings`` on four
forced host devices (axes ``Auto``).  Held: every rank's whole tensors
against the unsharded step at 1e-5 of each leaf's largest magnitude; against the reference at the
tolerances of the port's unsharded parity tests (``test_torch_training.py``
1e-5 of each leaf's largest magnitude for the train step,
``test_torch_model.py`` 1e-4 absolute for logits).  phi on (1, 4) shards
its 4 query heads and not its 2 KV heads: the GQA case the kernels' wrappers
route (``ops.kv_heads_of``).

In this process, over a fake process group of 256 ranks: every leaf's local
shard shape of ``build_step``'s arguments at ``reduced()`` on (2, 2), (1, 4)
and the (16, 16) production mesh against the reference's
``NamedSharding(...).shard_shape`` of the same spec.
"""
from __future__ import annotations

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

import repro.configs as jconfigs
import repro_torch.configs as configs
import torch_dist_workers as workers
from repro.models import model as jmodel
from repro_torch.configs import INPUT_SHAPES, list_architectures
from repro_torch.distributed import placements_of
from repro_torch.distributed.sharding import MeshShape
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models.params import params_from_jax
from repro_torch.training.optimizer import tree_leaves

TOL = 1e-5           # against the unsharded step, of each leaf's largest magnitude
REF_LOGIT_TOL = 1e-4  # the port's unsharded logits parity (test_torch_model.py)
CASES = workers.step_cases()
IDS = [f"{a}-{m[0]}x{m[1]}" + ("" if c == workers.STEP_CAPACITY else "-own_capacity")
       for a, m, c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run; the output directory."""
    out = str(tmp_path_factory.mktemp("step"))
    for arch in workers.STEP_ARCHS:
        jp = jmodel.init_params(workers.step_config(arch, jconfigs), jax.random.key(0))
        torch.save(params_from_jax(workers.step_config(arch, configs),
                                   jax.tree.map(np.asarray, jp)),
                   os.path.join(out, f"{arch}.params.pt"))
    procs = [workers.start(["jax_step", out], out, "jax_step.log", JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_count=4")]
    procs += workers.start_ranks("step", 4, out)
    workers.finish(procs, out)
    return out


def _rank(runs, arch, mesh, rank, capacity=workers.STEP_CAPACITY):
    return torch.load(os.path.join(runs, f"{workers.step_tag(arch, mesh, capacity)}.rank{rank}.pt"))


def _close(name, got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(float(np.max(np.abs(want))), 1e-30), (name, err)


@pytest.mark.parametrize("arch,mesh,capacity", CASES, ids=IDS)
def test_sharded_loss_and_gradients_equal_the_unsharded(runs, arch, mesh, capacity):
    for rank in range(4):
        res = _rank(runs, arch, mesh, rank, capacity)
        got, want = res["sharded"], res["plain"]
        _close("loss", got["loss"], want["loss"])
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(f"rank {rank} grad {i}", g, w)


@pytest.mark.parametrize("arch,mesh,capacity", CASES, ids=IDS)
def test_sharded_train_step_equals_the_unsharded(runs, arch, mesh, capacity):
    for rank in range(4):
        res = _rank(runs, arch, mesh, rank, capacity)
        got, want = res["sharded"], res["plain"]
        _close("step loss", got["step_loss"], want["step_loss"])
        for key in ("new_params", "m", "v"):
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                _close(f"rank {rank} {key} {i}", g, w)


@pytest.mark.parametrize("arch,mesh,capacity", CASES, ids=IDS)
def test_sharded_prefill_and_decode_logits_equal_the_unsharded(runs, arch, mesh, capacity):
    for rank in range(4):
        res = _rank(runs, arch, mesh, rank, capacity)
        got, want = res["sharded"], res["plain"]
        assert len(got["logits"]) == 1 + workers.STEP_DECODES
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            _close(f"rank {rank} logits {i}", g, w)


@pytest.mark.parametrize("arch", workers.STEP_ARCHS)
def test_the_unsharded_steps_agree_across_ranks_and_meshes(runs, arch):
    """The plain steps are every rank's whole computation: the same on every
    rank, and for qwen (no EP) the same on both meshes."""
    first = _rank(runs, arch, workers.STEP_MESHES[0], 0)["plain"]
    for mesh in workers.STEP_MESHES:
        for rank in range(4):
            res = _rank(runs, arch, mesh, rank)["plain"]
            if arch == workers.PHI and mesh != workers.STEP_MESHES[0]:
                continue                     # EP's per-shard aux depends on the mesh
            _close("loss", res["loss"], first["loss"], tol=0)
            for g, w in zip(res["logits"], first["logits"]):
                _close("logits", g, w, tol=TOL)


@pytest.mark.parametrize("arch,mesh,capacity", CASES, ids=IDS)
def test_sharded_step_matches_the_reference_jitted_step(runs, arch, mesh, capacity):
    """Against the reference's steps jitted with ``in_shardings`` on four
    forced host devices: the train step's loss, first moments (the clipped
    gradients times 1 - b1) and new parameters at 1e-5 of each leaf's
    largest magnitude, the logits at 1e-4.  phi also at its config's own
    capacity factor on (1, 4), where EP's shards drop tokens."""
    with open(os.path.join(runs, f"{workers.step_tag(arch, mesh, capacity)}.jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    cfg = workers.step_config(arch, configs, capacity)
    for rank in range(4):
        got = _rank(runs, arch, mesh, rank, capacity)["sharded"]
        _close("step loss", got["step_loss"], ref["step_loss"])
        for key in ("m", "new_params"):
            want = tree_leaves(params_from_jax(cfg, jax.tree.map(
                lambda a: np.asarray(a, np.float32), ref[key])))
            for i, (g, w) in enumerate(zip(got[key], want)):
                _close(f"rank {rank} {key} {i}", g, w)
        for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            err = float(np.max(np.abs(g.numpy() - w)))
            assert err < REF_LOGIT_TOL, (rank, i, err)


@pytest.mark.parametrize("arch,mesh,capacity", CASES, ids=IDS)
def test_the_step_partitions(runs, arch, mesh, capacity):
    """Most parameters sharded (heads and ff over ``model``; on (2, 2) FSDP's
    ``embed`` over ``data`` too), and the decode cache's ``kv_seq`` over
    ``model`` (the split-K spec).  A mesh axis of one rank replicates."""
    got = _rank(runs, arch, mesh, 0, capacity)["sharded"]
    sharded = [p for p in got["param_placements"] if "Shard" in p]
    assert 2 * len(sharded) > len(got["param_placements"])
    if mesh == (2, 2):
        assert any(p.count("Shard") == 2 for p in sharded)
    # the stacked cache (layers, B, S, kv heads, hd): batch over data, S over model
    batch = "Shard(dim=1)" if mesh[0] > 1 else "Replicate()"
    assert got["cache_placements"] == f"({batch}, Shard(dim=2))"


def test_phi_at_its_own_capacity_factor_drops_tokens(runs):
    """At the config's own capacity factor (1.25) the EP shards on
    ``DROPS_MESH`` drop tokens that STEP_CAPACITY keeps: the reference's
    prefill logits move between the two factors on the same tokens (and
    the port's equal the reference's at each factor, above)."""
    cfg = workers.step_config(workers.PHI, configs, None)
    assert cfg.moe_capacity_factor == 1.25 < workers.STEP_CAPACITY
    tag = workers.step_tag(workers.PHI, workers.DROPS_MESH, None)
    with open(os.path.join(runs, f"{tag}.jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    assert float(np.max(np.abs(ref["logits"][0] - ref["prefill_logits_kept"]))) > 1e-2
    got = _rank(runs, workers.PHI, workers.DROPS_MESH, 0, None)["sharded"]["logits"][0]
    assert float(np.max(np.abs(got.numpy() - ref["prefill_logits_kept"]))) > 1e-2


def test_a_dimension_over_two_mesh_axes_splits_as_a_partition_spec(runs):
    """``placements_of`` splits a dimension over ("data", "model") with data
    major, as ``P(("data", "model"))`` does, and over ("model", "data") with
    model major (``_StridedShard``), on every rank of a (2, 2) gloo mesh."""
    for rank in range(4):
        with open(os.path.join(runs, f"orders.rank{rank}.json")) as f:
            got = json.load(f)
        d, m = got["coordinate"]
        assert got["data+model"] == list(range(16))[(d * 2 + m) * 4:(d * 2 + m + 1) * 4]
        assert got["model+data"] == list(range(16))[(m * 2 + d) * 4:(m * 2 + d + 1) * 4]


# ---------------------------------------------------------------------------
# The GQA mapping of the kernels' wrappers (no process group).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nq,nkv,n", [(32, 8, 16), (64, 8, 16), (4, 2, 4), (8, 2, 4), (12, 4, 6),
                                      (16, 16, 4), (16, 4, 2), (24, 8, 3)])
def test_kv_heads_of_pairs_each_query_head_with_its_kv_head(nq, nkv, n):
    """Every rank's query heads meet the KV heads they use under GQA (query
    head h uses KV head h // (nq / nkv)) in the local call's own GQA order:
    phi3.5-moe's 32:8 and qwen2-72b's and kimi-k2's 64:8 over 16 ranks take
    one KV head a rank (rank r: head 2r // 4 at 32:8)."""
    group, q_loc = nq // nkv, nq // n
    for r in range(n):
        sel = ops.kv_heads_of(r * q_loc, q_loc, nq, nkv)
        kv = list(range(*sel)) if isinstance(sel, tuple) else sel
        local_group = q_loc // len(kv)
        for i in range(q_loc):
            assert kv[i // local_group] == (r * q_loc + i) // group, (r, i, sel)
    if (nq, nkv, n) == (32, 8, 16):
        assert [ops.kv_heads_of(2 * r, 2, 32, 8) for r in range(4)] == [(0, 1), (0, 1),
                                                                         (1, 2), (1, 2)]


# ---------------------------------------------------------------------------
# Over a fake process group of 256 ranks (this process is rank 0).
# ---------------------------------------------------------------------------
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "16x16": (16, 16)}


@pytest.fixture(scope="module")
def fake_group():
    """A fake process group of 256 ranks, destroyed after this module's
    tests, so that no other file's tests meet a group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    yield
    dist.destroy_process_group()


def _device_mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    n = shape[0] * shape[1]
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))


def _spec_leaves(tree):
    """The partition specs (tuples) of a spec tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_architectures())
def test_local_shard_shapes_equal_the_reference(fake_group, arch, shape, mesh):
    """Every leaf of ``build_step``'s arguments (params, optimizer state and
    batch, or params, inputs and cache) at ``reduced()``: rank 0's local
    shard shape equals the reference's ``NamedSharding(mesh,
    P(*spec)).shard_shape`` of the leaf's spec, and every argument is a
    DTensor on the mesh.  Where the reference refuses a leaf's spec (a mesh
    axis that does not divide the dimension: reduced() cuts recurrentgemma's
    local window to 8 slots, which the decode rules split over 16), ``place``
    refuses that leaf and ``build_step`` the step, each with ``ValueError``."""
    cfg, dm = configs.get_config(arch).reduced(), _device_mesh(MESHES[mesh])
    _, leaves_of, specs_of, _, _ = specs.build_step(cfg, INPUT_SHAPES[shape],
                                                    MeshShape(("data", "model"), MESHES[mesh]))
    am = AbstractMesh(MESHES[mesh], ("data", "model"))
    spec_list = [x for a in specs_of for x in _spec_leaves(a)]
    wants = []
    for t, spec in zip(tree_leaves(list(leaves_of)), spec_list):
        try:
            wants.append(NamedSharding(am, PartitionSpec(*spec)).shard_shape(tuple(t.shape)))
        except ValueError:
            wants.append(None)
            with pytest.raises(ValueError, match="do not divide"):
                specs.place(t, spec, dm)
    if None in wants:
        with pytest.raises(ValueError, match="do not divide"):
            specs.build_step(cfg, INPUT_SHAPES[shape], dm)
        return
    _, args, arg_specs, _, _ = specs.build_step(cfg, INPUT_SHAPES[shape], dm)
    leaves = tree_leaves(list(args))
    assert [x for a in arg_specs for x in _spec_leaves(a)] == spec_list
    assert len(leaves) == len(spec_list) == len(wants)
    for t, spec, want in zip(leaves, spec_list, wants):
        assert isinstance(t, torch.distributed.tensor.DTensor) and t.device_mesh is dm
        assert tuple(t.placements) == placements_of(spec, dm)
        assert tuple(t.to_local().shape) == tuple(want), (spec, tuple(t.shape))


@pytest.mark.parametrize("nq,nkv", [(8, 2), (8, 8), (4, 1)])
def test_flash_under_gqa_with_heads_sharded_gives_this_ranks_heads(fake_group, nq, nkv):
    """On (1, 4), rank 0 holds query heads 0 .. nq/4 - 1 and, where 4 does
    not divide nkv, all the KV heads: its local output equals those heads of
    the unsharded attention.  Without ``kv_heads_of`` the local call would
    see nq/4 query heads against nkv KV heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = _device_mesh((1, 4))
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 8, h, 16)), dtype=torch.float32)
               for h in (nq, nkv, nkv))
    want = ops.flash_attention(q, k, v)
    kv_pl = [Replicate(), Shard(2)] if nkv % 4 == 0 else [Replicate(), Replicate()]
    kv_loc = (lambda t: t[:, :, :nkv // 4]) if nkv % 4 == 0 else (lambda t: t)
    got = ops.flash_attention(
        DTensor.from_local(q[:, :, :nq // 4], dm, [Replicate(), Shard(2)]),
        DTensor.from_local(kv_loc(k), dm, kv_pl), DTensor.from_local(kv_loc(v), dm, kv_pl))
    assert tuple(got.placements) == (Replicate(), Shard(2))
    torch.testing.assert_close(got.to_local(), want[:, :, :nq // 4], rtol=0, atol=1e-6)
