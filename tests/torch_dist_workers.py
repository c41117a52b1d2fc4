"""Processes for the port's multi-rank CPU tests (``tests/test_torch_ep.py``,
``tests/test_torch_sharded_grid.py``); pytest does not collect this file.

  python tests/torch_dist_workers.py ep   <rank> <world> <store> <out dir>
  python tests/torch_dist_workers.py grid <rank> <world> <store> <out dir>
  python tests/torch_dist_workers.py jax_ep <out dir>

``ep`` and ``grid`` are one rank of a gloo process group of ``world``
ranks that meet through a ``FileStore`` at ``<store>`` (no port, so that
several groups can run at once): ``ep`` runs every EP case of that world
size through the port's ``moe_ep_a2a`` (and phi3.5-moe's ``forward`` at 2
ranks), ``grid`` runs ``torch_engine.run_grid`` sharded and not.  Each rank
writes what it returned to ``<out dir>``.  ``jax_ep`` is the reference: the
JAX package's ``moe_ep_a2a`` on as many host devices as a case's mesh has
(run with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  The
``ep`` and ``jax_ep`` jobs import nothing of the other package; the inputs
of both are made here from seeds with numpy.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np

# name -> (mesh shape (data, model), rules, experts, capacity factor, x shape)
RULES = {"ep": {"experts": "model", "batch": ("data",)}, "no_experts": {"batch": ("data",)}}
EP_CASES = {
    # capacity 8 a shard against 24 for the whole batch: the shards drop tokens
    "n1": ((1, 1), "ep", 8, 0.25, (1, 256)),
    "n2": ((1, 2), "ep", 8, 0.25, (1, 256)),
    "n4": ((1, 4), "ep", 8, 0.25, (1, 256)),
    "d2m2": ((2, 2), "ep", 8, 0.25, (2, 256)),
    "no_drops": ((1, 4), "ep", 8, 8.0, (2, 16)),
    # the fallbacks to the sort path on a real mesh
    "fallback_no_experts_axis": ((1, 4), "no_experts", 8, 0.25, (1, 256)),
    "fallback_experts_not_divisible": ((1, 4), "ep", 6, 0.25, (1, 256)),
    "fallback_seq_not_divisible": ((1, 4), "ep", 8, 0.25, (2, 18)),
}
D, FF, K = 32, 64, 2
# the EP cases' layer, in both packages' ModelConfig
EP_CONFIG = dict(name="moe-ep-test", family="moe", num_layers=1, d_model=D, num_heads=4,
                 num_kv_heads=4, d_ff=FF, vocab_size=64, num_experts_per_tok=K)
AUX_WEIGHT = 0.01
PHI = "phi3.5-moe-42b-a6.6b"
PHI_MESH, PHI_TOKENS = (1, 2), (2, 32)
GRID_ARCHS = ["llama3-8b", "minicpm-2b", "qwen1.5-0.5b"]
GRID_A, GRID_T = 3, 120


def world_of(shape) -> int:
    return math.prod(shape)


def ep_inputs(name: str) -> dict:
    """The case's router, experts' weights and x (f32), from its own seed."""
    _, _, e, _, (b, s) = EP_CASES[name]
    rng = np.random.default_rng(sorted(EP_CASES).index(name))
    f32 = np.float32
    return {
        "router": (rng.standard_normal((D, e)) * D ** -0.5).astype(f32),
        "wi_gate": (rng.standard_normal((e, D, FF)) * D ** -0.5).astype(f32),
        "wi_up": (rng.standard_normal((e, D, FF)) * D ** -0.5).astype(f32),
        "wo": (rng.standard_normal((e, FF, D)) * FF ** -0.5).astype(f32),
        "x": rng.standard_normal((b, s, D)).astype(f32),
    }


def phi_batch(vocab: int):
    """phi's tokens (B, S) and their next-token labels (the last one masked)."""
    tokens = np.random.default_rng(7).integers(0, vocab, size=PHI_TOKENS).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full_like(tokens[:, :1], -1)], axis=1)
    return tokens, labels


def grid_inputs():
    """(arrival matrices [B, A, T], seeds) of the grid runs: four zoo scenarios."""
    from repro_torch.core.workloads import SCENARIO_ZOO

    names = ("shared_berkeley", "mmpp_bursts", "diurnal_phases", "flash_correlated")
    arrs = np.stack([SCENARIO_ZOO[n].build(GRID_A, duration_s=GRID_T, seed=30 + i)
                     for i, n in enumerate(names)])
    return arrs, [5, 6, 7, 8]


# ---------------------------------------------------------------------------
# Launching (from the tests).
# ---------------------------------------------------------------------------
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TIMEOUT_S = 240


def start(args, out: str, log: str, **env):
    """This file run with ``args`` in a process of its own, ``src`` first on
    its path, its output in ``<out>/<log>``."""
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = SRC + os.pathsep + full.get("PYTHONPATH", "")
    with open(os.path.join(out, log), "w") as f:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), *map(str, args)],
                                env=full, stdout=f, stderr=subprocess.STDOUT)


def start_ranks(job: str, world: int, out: str):
    """The ``world`` ranks of ``job``, meeting through a store in ``out``."""
    store = os.path.join(out, f"store.{job}.{world}")
    return [start([job, r, world, store, out], out, f"{job}.{world}.rank{r}.log")
            for r in range(world)]


def finish(procs, out: str) -> None:
    """Wait for every process (killing all of them past TIMEOUT_S) and
    raise, with the end of its log, for one that failed."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [p for p in procs if p.returncode != 0]
    if failed:
        logs = [open(os.path.join(out, f.name)).read()[-3000:]
                for f in os.scandir(out) if f.name.endswith(".log")]
        raise AssertionError(f"{len(failed)} process(es) failed:\n" + "\n".join(logs))


# ---------------------------------------------------------------------------
# The port's ranks.
# ---------------------------------------------------------------------------
def _init(rank: int, world: int, store: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def ep_config(e: int, cf: float):
    from repro_torch.configs.registry import ModelConfig

    return ModelConfig(**EP_CONFIG, num_experts=e, moe_capacity_factor=cf)


def run_ep(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import AxisRules, MeshShape, axis_rules, mesh_shape
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import model, moe
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten

    _init(rank, world, store)
    for name, (shape, rules, e, cf, _) in EP_CASES.items():
        if world_of(shape) != world:
            continue
        cfg = ep_config(e, cf)
        inputs = {k: torch.tensor(v, requires_grad=True) for k, v in ep_inputs(name).items()}
        mesh = make_test_mesh(shape)
        with axis_rules(AxisRules(mesh, dict(RULES[rules]))):
            p = {k: v for k, v in inputs.items() if k != "x"}
            y, aux = moe.moe_ep_a2a(cfg, p, inputs["x"])
        loss = (y ** 2).sum() + AUX_WEIGHT * aux
        loss.backward()
        np.savez(os.path.join(out, f"{name}.rank{rank}.npz"), y=y.detach().numpy(),
                 aux=aux.detach().numpy(),
                 **{f"grad_{k}": v.grad.numpy() for k, v in inputs.items()})
    if world == world_of(PHI_MESH):
        cfg = get_config(PHI).reduced()
        params = torch.load(os.path.join(out, "phi_params.pt"))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        tokens, labels = (torch.tensor(a).long() for a in phi_batch(cfg.vocab_size))
        batch = {"inputs": tokens, "labels": labels}
        with axis_rules(AxisRules(make_test_mesh(PHI_MESH), dict(RULES["ep"]))):
            with torch.no_grad():
                logits, aux = model.forward(cfg, params, tokens, moe_path="ep_a2a")
            loss, _ = model.loss_fn(cfg, params, batch, moe_path="ep_a2a", remat=True)
            loss_plain, _ = model.loss_fn(cfg, params, batch, moe_path="ep_a2a", remat=False)
            grads_plain = torch.autograd.grad(loss_plain, leaves)
        # outside the rules: the recompute of each layer re-enters its forward's
        grads = torch.autograd.grad(loss, leaves)
        torch.save({"logits": logits, "aux": aux, "loss": loss.detach(),
                    "loss_plain": loss_plain.detach(),
                    "grads": tree_unflatten(params, list(grads)),
                    "grads_plain": tree_unflatten(params, list(grads_plain))},
                   os.path.join(out, f"phi.rank{rank}.pt"))
    if world == 4:
        # the rules of a DeviceMesh are those of the record of its shape
        cfg = get_config(PHI)
        mesh = make_test_mesh((2, 2))
        same = {mode: make_rules(cfg, mesh, mode, batch_size=8, cache_len=64).rules
                == make_rules(cfg, MeshShape(("data", "model"), (2, 2)), mode,
                              batch_size=8, cache_len=64).rules
                for mode in ("train", "prefill", "decode")}
        with open(os.path.join(out, f"mesh.rank{rank}.json"), "w") as f:
            json.dump({"rules_equal": same, "shape": list(mesh_shape(mesh).sizes),
                       "names": list(mesh_shape(mesh).names),
                       "device_type": mesh.device_type}, f)
    dist.barrier()
    dist.destroy_process_group()


def grid_workload():
    from repro_torch.core.sim.types import ArchLoad

    return [ArchLoad(GRID_ARCHS[i % 3], 1.0 / GRID_A, 0.25, name=f"m@{i}")
            for i in range(GRID_A)]


def run_grid(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.core.sim import torch_engine as te
    from repro_torch.distributed import device_mesh

    _init(rank, world, store)
    arrs, seeds = grid_inputs()
    wl = grid_workload()
    mesh = device_mesh()
    res = {"mesh": (mesh.mesh_dim_names, mesh.size(), mesh.device_type)}
    ran, prepare = [], te.prepare_grid

    def recorded(*args, cells=None, **kwargs):          # the cells this rank builds
        ran.append((cells.start, cells.stop))
        return prepare(*args, cells=cells, **kwargs)

    te.prepare_grid = recorded
    # two and four cells sharded, not, and by the rule; three cells on two
    # ranks: the rule runs them all here, and sharded=True refuses them
    for n_cells, mode in [(2, True), (2, False), (2, None), (4, True), (4, False), (4, None),
                          (3, None), (3, True)]:
        ran.clear()
        try:
            cells = te.run_grid(arrs[:n_cells], wl, "portfolio", seeds=seeds[:n_cells],
                                sharded=mode, device="cpu")
        except ValueError as err:
            cells = f"ValueError: {err}"
        res[(n_cells, mode)] = {"cells": cells, "ran": list(ran)}
    with open(os.path.join(out, f"grid.rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference.
# ---------------------------------------------------------------------------
def run_jax_ep(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.configs.registry import ModelConfig
    from repro.distributed.sharding import AxisRules, axis_rules
    from repro.models import model, moe

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:world_of(shape)])

    for name, (shape, rules, e, cf, _) in EP_CASES.items():
        cfg = ModelConfig(**EP_CONFIG, num_experts=e, moe_capacity_factor=cf)
        inputs = {k: jnp.asarray(v) for k, v in ep_inputs(name).items()}

        def loss(inp, fn):
            y, aux = fn(cfg, {k: v for k, v in inp.items() if k != "x"}, inp["x"])
            return jnp.sum(y ** 2) + AUX_WEIGHT * aux, (y, aux)

        mesh = mesh_of(shape)
        # jitted, as the JAX package trains: eager, the sort path's sharding
        # constraint refuses experts that do not divide the mesh axis
        with mesh, axis_rules(AxisRules(mesh, dict(RULES[rules]))):
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                lambda i: loss(i, moe.moe_ep_a2a), has_aux=True))(inputs)
        (_, (y_sort, _)), _ = jax.jit(jax.value_and_grad(
            lambda i: loss(i, moe.moe_sort_local), has_aux=True))(inputs)
        np.savez(os.path.join(out, f"{name}.jax.npz"), y=np.asarray(y), aux=np.asarray(aux),
                 y_sort=np.asarray(y_sort),
                 **{f"grad_{k}": np.asarray(v) for k, v in g.items()})
    cfg = get_config(PHI).reduced()
    params = model.init_params(cfg, jax.random.key(0))
    tokens, labels = (jnp.asarray(a) for a in phi_batch(cfg.vocab_size))
    batch = {"inputs": tokens, "labels": labels}
    mesh = mesh_of(PHI_MESH)
    with mesh, axis_rules(AxisRules(mesh, dict(RULES["ep"]))):
        logits, aux = jax.jit(lambda p, t: model.forward(cfg, p, t, moe_path="ep_a2a"))(
            params, tokens)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss_fn(cfg, p, batch, moe_path="ep_a2a"), has_aux=True))(params)
    logits_sort, _ = jax.jit(lambda p, t: model.forward(cfg, p, t))(params, tokens)
    with open(os.path.join(out, "phi.jax.pkl"), "wb") as f:
        pickle.dump({"logits": np.asarray(logits), "aux": np.asarray(aux),
                     "logits_sort": np.asarray(logits_sort), "loss": np.asarray(loss),
                     "grads": jax.tree.map(np.asarray, grads)}, f)


if __name__ == "__main__":
    job = sys.argv[1]
    if job == "jax_ep":
        run_jax_ep(sys.argv[2])
    else:
        rank, world, store, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
        {"ep": run_ep, "grid": run_grid}[job](rank, world, store, out)
