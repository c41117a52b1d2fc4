"""Expert-parallel MoE on real meshes: ``repro_torch.models.moe.moe_ep_a2a``
at 1, 2 and 4 gloo ranks against the JAX package's ``moe_ep_a2a``
(``shard_map``, two ``all_to_all``s, a ``pmean`` of aux) on as many forced
host devices.

Every case runs in processes of its own (``tests/torch_dist_workers.py``):
the port's ranks of a world size share one gloo group that meets through a
``FileStore`` (no port), and the reference runs in one process with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, each case on a mesh
of its first devices with ``Auto`` axes, jitted.  Inputs come from seeds
with numpy.  Held at 1e-5 of each leaf's largest magnitude in f32: y, aux
and the gradients of the router, the experts' three weights and x for
``sum(y²) + 0.01·aux``, on every rank (each returns the global view).  At
the dropping shape (capacity 8 a shard against 24 for the batch) EP and
the sort path differ by O(1), so a port that kept the sort path fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.configs import get_config as jax_config
from repro.configs.registry import ModelConfig as JaxModelConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.distributed import AxisRules, MeshShape, axis_rules, device_mesh
from repro_torch.models import moe
from repro_torch.models.params import params_from_jax
from repro_torch.training.optimizer import tree_leaves


def leaf_names(tree, prefix=""):
    """Dotted paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


TOL = 1e-5
LEAVES = ("y", "aux", "grad_router", "grad_wi_gate", "grad_wi_up", "grad_wo", "grad_x")
DROPPING = ("n1", "n2", "n4", "d2m2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both packages; the output directory."""
    out = str(tmp_path_factory.mktemp("ep"))
    jcfg = jax_config(workers.PHI).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    torch.save(params_from_jax(get_config(workers.PHI).reduced(), jax.tree.map(np.asarray, jp)),
               os.path.join(out, "phi_params.pt"))
    procs = [workers.start(["jax_ep", out], out, "jax_ep.log", JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_count=4")]
    for world in (1, 2, 4):
        procs += workers.start_ranks("ep", world, out)
    workers.finish(procs, out)
    return out


def _close(name, got, want):
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(float(np.max(np.abs(want))), 1e-30), (name, err)


@pytest.mark.parametrize("case", list(workers.EP_CASES))
def test_ep_matches_the_reference_on_every_rank(runs, case):
    shape = workers.EP_CASES[case][0]
    want = np.load(os.path.join(runs, f"{case}.jax.npz"))
    for rank in range(workers.world_of(shape)):
        got = np.load(os.path.join(runs, f"{case}.rank{rank}.npz"))
        for leaf in LEAVES:
            assert got[leaf].shape == want[leaf].shape, (case, rank, leaf)
            _close(f"{case} rank {rank} {leaf}", got[leaf], want[leaf])


@pytest.mark.parametrize("case", list(workers.EP_CASES))
def test_per_shard_capacity_departs_from_the_sort_path_only_where_shards_drop(runs, case):
    """Where a shard's capacity drops tokens that the whole batch's would
    keep, EP's y is O(1) away from the sort path's (the reference's own);
    with no drops, and on every fallback, it is the sort path's y."""
    ref = np.load(os.path.join(runs, f"{case}.jax.npz"))
    got = np.load(os.path.join(runs, f"{case}.rank0.npz"))
    gap = float(np.max(np.abs(ref["y"] - ref["y_sort"])))
    if case in DROPPING and case != "n1":
        assert gap > 1.0, gap
        assert float(np.max(np.abs(got["y"] - ref["y_sort"]))) > 1.0
    else:
        # one shard: its capacity is the batch's
        _close(case, got["y"], ref["y_sort"])


def _phi(runs):
    with open(os.path.join(runs, "phi.jax.pkl"), "rb") as f:
        want = pickle.load(f)
    got = [torch.load(os.path.join(runs, f"phi.rank{rank}.pt"))
           for rank in range(workers.world_of(workers.PHI_MESH))]
    return want, got


def test_phi_forward_through_ep_at_two_ranks_matches_the_reference(runs):
    """phi3.5-moe at ``reduced()`` through ``forward(moe_path="ep_a2a")`` on a
    (1, 2) mesh, logits and the layers' aux, against JAX's forward under the
    same mesh and rules; the sort path's logits are O(1) away."""
    want, got = _phi(runs)
    assert float(np.max(np.abs(want["logits"] - want["logits_sort"]))) > 0.1
    for res in got:
        _close("logits", res["logits"].numpy(), want["logits"])
        _close("aux", res["aux"].numpy(), want["aux"])


def test_phi_loss_gradients_through_ep_at_two_ranks_match_the_reference(runs):
    """``loss_fn(moe_path="ep_a2a")``, as ``TrainConfig(moe_path="ep_a2a")``
    trains, under remat with the backward called outside the rules (each
    layer's recompute re-enters them) and without remat: the loss and every
    gradient leaf against JAX's jitted gradient under the same mesh."""
    want, got = _phi(runs)
    tcfg = get_config(workers.PHI).reduced()
    ref = tree_leaves(params_from_jax(tcfg, want["grads"]))
    names = leaf_names(params_from_jax(tcfg, want["grads"]))
    for res in got:
        for key in ("loss", "loss_plain"):
            _close(key, res[key].numpy(), want["loss"])
        for key in ("grads", "grads_plain"):
            leaves = tree_leaves(res[key])
            assert len(leaves) == len(ref)
            for name, g, r in zip(names, leaves, ref):
                _close(f"{key} {name}", g.numpy(), r.numpy())


def test_make_test_mesh_under_a_group_is_a_device_mesh_with_the_records_rules(runs):
    for rank in range(4):
        with open(os.path.join(runs, f"mesh.rank{rank}.json")) as f:
            got = json.load(f)
        assert got == {"rules_equal": {"train": True, "prefill": True, "decode": True},
                       "shape": [2, 2], "names": ["data", "model"], "device_type": "cpu"}


# ---------------------------------------------------------------------------
# Without a process group (this process).
# ---------------------------------------------------------------------------
def _small(name="n4"):
    _, _, e, cf, _ = workers.EP_CASES[name]
    inputs = workers.ep_inputs(name)
    p = {k: v for k, v in inputs.items() if k != "x"}
    return workers.ep_config(e, cf), p, inputs["x"]


def test_ep_without_rules_is_the_sort_path_as_in_the_reference():
    cfg, p, x = _small()
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    y_j, aux_j = jmoe.moe_ep_a2a(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    y, aux = moe.moe_ep_a2a(cfg, tp, torch.tensor(x))
    _close("y", y.numpy(), np.asarray(y_j))
    _close("aux", aux.numpy(), np.asarray(aux_j))
    y_sort, _ = moe.moe_sort_local(cfg, tp, torch.tensor(x))
    assert torch.equal(y, y_sort)


def test_ep_on_a_mesh_record_is_the_sort_path():
    """A record has no ranks to run on: the dry-run's meshes take the sort
    path, whatever their ``experts`` axis."""
    cfg, p, x = _small()
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rules = AxisRules(MeshShape(("data", "model"), (1, 4)), dict(workers.RULES["ep"]))
    with axis_rules(rules):
        y, aux = moe.moe_ep_a2a(cfg, tp, torch.tensor(x))
    y_sort, aux_sort = moe.moe_sort_local(cfg, tp, torch.tensor(x))
    assert torch.equal(y, y_sort) and torch.equal(aux, aux_sort)
    assert device_mesh() is None


def test_moe_apply_sends_ep_a2a_to_moe_ep_a2a(monkeypatch):
    cfg, p, x = _small()
    monkeypatch.setattr(moe, "moe_ep_a2a", lambda *args: "ep")
    assert moe.moe_apply(cfg, p, x, path="ep_a2a") == "ep"
    with pytest.raises(ValueError):
        moe.moe_apply(cfg, p, x, path="a2a")
