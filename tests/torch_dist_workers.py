"""Processes for the port's multi-rank CPU tests (``tests/test_torch_ep.py``,
``tests/test_torch_sharded_grid.py``, ``tests/test_torch_sharded_step.py``);
pytest does not collect this file.

  python tests/torch_dist_workers.py ep   <rank> <world> <store> <out dir>
  python tests/torch_dist_workers.py grid <rank> <world> <store> <out dir>
  python tests/torch_dist_workers.py step <rank> <world> <store> <out dir>
  python tests/torch_dist_workers.py jax_ep <out dir>
  python tests/torch_dist_workers.py jax_step <out dir>

``ep`` and ``grid`` are one rank of a gloo process group of ``world``
ranks that meet through a ``FileStore`` at ``<store>`` (no port, so that
several groups can run at once): ``ep`` runs every EP case of that world
size through the port's ``moe_ep_a2a`` (and phi3.5-moe's ``forward`` at 2
ranks), ``grid`` runs ``torch_engine.run_grid`` sharded and not.  Each rank
writes what it returned to ``<out dir>``.  ``step`` runs the partitioned
steps of ``STEP_ARCHS`` at ``reduced()`` on every mesh of ``STEP_MESHES``:
``launch/specs.py:build_step``'s train step and ``loss_fn``'s gradients on
DTensor arguments placed by its specs, and a prefill with two decode steps
under the prefill and decode rules, then the same steps on every rank's
whole plain tensors under the same rules (the unsharded step; for phi the
MoE layers' EP by hand, as ``moe_ep_a2a`` runs on plain tensors); every
rank writes the whole tensors of both.
``jax_ep`` and ``jax_step`` are the reference: the JAX package's
``moe_ep_a2a``, and its steps jitted with the ``in_shardings`` of its own
specs, on as many host devices as a case's mesh has (run with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, axes ``Auto``).  A
port's job and a reference's import nothing of the other package; the
inputs of both are made here from seeds with numpy, the parameters by the
test (``<arch>.params.pt`` from the reference's ``init_params``).
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
# the partitioned steps: archs, meshes (data, model), batch and prompt
# lengths (the cache twice the prompt), decode steps.  phi's capacity
# factor is raised so that no expert drops a token, neither in an EP shard
# nor over the whole batch:
# the EP capacity is per shard by design (tests/test_torch_ep.py holds the
# dropping shapes), and here the sharded step must equal the unsharded one
STEP_ARCHS = ("qwen1.5-0.5b", PHI)
STEP_MESHES = ((2, 2), (1, 4))
STEP_B, STEP_S, STEP_DECODES = 4, 16, 2
STEP_CAPACITY = 8.0
# phi's steps also at its config's own capacity factor (1.25), on one mesh,
# over DROPS_S tokens a sequence whose first DROPS_RUN are one id: at the
# first layer those positions are the same vector (attention over equal
# values gives that value), so they choose the same experts, and an EP
# shard's DROPS_S tokens overflow its capacity of 24 rows an expert
# (1.25 x 2 x 32 / 4, plus one, up to a multiple of 8); the reference's
# jitted step drops them per shard as well.  (At STEP_S a shard's 16
# tokens never overflow its floor of 16 rows, whatever the routing.)
DROPS_MESH, DROPS_S, DROPS_RUN = (1, 4), 32, 24
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


def step_inputs(vocab: int, capacity=STEP_CAPACITY) -> dict:
    """The steps' tokens (B, S), labels (two masked) and decode tokens; at
    the config's own capacity factor S is DROPS_S, its first DROPS_RUN
    tokens one id."""
    rng = np.random.default_rng(11)
    s = step_seq(capacity)
    tokens = rng.integers(0, vocab, size=(STEP_B, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(STEP_B, s)).astype(np.int32)
    labels[0, :2] = -1
    decode = rng.integers(0, vocab, size=(STEP_DECODES, STEP_B)).astype(np.int32)
    if capacity != STEP_CAPACITY:
        tokens[:, :DROPS_RUN] = tokens[0, 0]
    return {"tokens": tokens, "labels": labels, "decode": decode}


def step_seq(capacity=STEP_CAPACITY) -> int:
    """The steps' sequence length: STEP_S, DROPS_S at the config's own
    capacity factor; the cache holds twice as many slots."""
    return STEP_S if capacity == STEP_CAPACITY else DROPS_S


def step_cases():
    """(arch, mesh, capacity factor) of every run of the step job: the
    factor ``STEP_CAPACITY``, or None for the config's own."""
    return ([(arch, shape, STEP_CAPACITY) for shape in STEP_MESHES for arch in STEP_ARCHS]
            + [(PHI, DROPS_MESH, None)])


def step_tag(arch: str, shape, capacity=STEP_CAPACITY) -> str:
    tag = f"{arch}.{shape[0]}x{shape[1]}"
    return tag if capacity == STEP_CAPACITY else f"{tag}.own_capacity"


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


def step_config(arch: str, package, capacity=STEP_CAPACITY):
    """``arch`` at ``reduced()`` from ``package``'s registry, MoE at the
    capacity factor ``capacity`` (None: the config's own)."""
    import dataclasses

    cfg = package.get_config(arch).reduced()
    if cfg.num_experts and capacity is not None:
        return dataclasses.replace(cfg, moe_capacity_factor=capacity)
    return cfg


def run_step(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from torch.distributed.tensor import distribute_tensor

    import repro_torch.configs as configs
    from repro_torch.configs.registry import InputShape
    from repro_torch.distributed import (axis_rules, logical_to_spec, partitioned,
                                         placements_of)
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.launch.specs import build_step, cache_axes, place, shardings_of
    from repro_torch.models import model
    from repro_torch.training.optimizer import (OptimizerConfig, adamw_init, tree_leaves,
                                                tree_unflatten)

    _init(rank, world, store)
    # a dimension split over two mesh axes, in mesh order and in the other
    mesh = make_test_mesh((2, 2))
    orders = {}
    for spec in ((("data", "model"),), (("model", "data"),)):
        t = distribute_tensor(torch.arange(16), mesh, placements_of(spec, mesh))
        orders["+".join(spec[0])] = t.to_local().tolist()
    orders["coordinate"] = list(mesh.get_coordinate())
    with open(os.path.join(out, f"orders.rank{rank}.json"), "w") as f:
        json.dump(orders, f)

    def steps(cfg, mesh, params, data, placed: bool):
        """The train step, loss_fn's gradients, a prefill and two decode
        steps under the rules of ``mesh``: on DTensors placed by the specs
        (``placed``), or on every rank's whole plain tensors."""
        put = (lambda tree, spec: place(tree, spec, mesh)) if placed else (lambda tree, _: tree)
        full = (lambda t: t.full_tensor().detach()) if placed else (lambda t: t.detach())
        batch = {"inputs": data["tokens"], "labels": data["labels"]}
        res = {}
        s = data["tokens"].shape[1]
        train = InputShape("train_reduced", s, STEP_B, "train")
        step, _, specs, rules, _ = build_step(cfg, train, mesh, param_dtype=torch.float32)
        p, b = put(params, specs[0]), put(batch, specs[2])
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        moe_path = "ep_a2a" if cfg.num_experts else "local"
        with axis_rules(rules), partitioned(rules):
            loss, _ = model.loss_fn(cfg, tree_unflatten(p, leaves), b, moe_path=moe_path)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            new_p, new_o, metrics = step(p, adamw_init(p, OptimizerConfig()), b)
        res["loss"], res["grads"] = full(loss), [full(g) for g in grads]
        res["step_loss"] = full(metrics["loss"])
        for key, tree in (("new_params", new_p), ("m", new_o["m"]), ("v", new_o["v"])):
            res[key] = [full(t) for t in tree_leaves(tree)]
        if placed:
            res["param_placements"] = [str(t.placements) for t in tree_leaves(p)]
        # a prefill under the prefill rules, two decode steps under the decode rules
        pre_rules = make_rules(cfg, mesh, "prefill", batch_size=STEP_B)
        dec_rules = make_rules(cfg, mesh, "decode", batch_size=STEP_B, cache_len=2 * s)
        cache = model.init_cache(cfg, STEP_B, 2 * s, device="cpu")
        axes = cache_axes(cache)
        with torch.no_grad():
            with axis_rules(pre_rules):
                p = put(params, shardings_of(model.param_axes(cfg), pre_rules))
                c = put(cache, shardings_of(axes, pre_rules))
                tok = put(data["tokens"], logical_to_spec(("batch", "seq_act"), pre_rules))
                logits, c = model.prefill(cfg, p, tok, c, moe_path=moe_path)
                res["logits"] = [full(logits)]
            with axis_rules(dec_rules):
                c = put(c, shardings_of(axes, dec_rules))
                if placed:
                    res["cache_placements"] = str(c["blocks"]["p0_attn"]["attn"]["k"].placements)
                for tokens in data["decode"]:
                    tok = put(tokens, logical_to_spec(("batch",), dec_rules))
                    logits, c = model.decode_step(cfg, p, tok, c)
                    res["logits"].append(full(logits))
        return res

    meshes = {}
    for arch, shape, capacity in step_cases():
        mesh = meshes.setdefault(shape, make_test_mesh(shape))
        cfg = step_config(arch, configs, capacity)
        params = torch.load(os.path.join(out, f"{arch}.params.pt"))
        data = {k: torch.tensor(v).long()
                for k, v in step_inputs(cfg.vocab_size, capacity).items()}
        res = {"sharded": steps(cfg, mesh, params, data, placed=True),
               "plain": steps(cfg, mesh, params, data, placed=False)}
        torch.save(res, os.path.join(out, f"{step_tag(arch, shape, capacity)}.rank{rank}.pt"))
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


def run_jax_step(out: str) -> None:
    """The reference's partitioned steps, jitted with its own specs'
    ``in_shardings``: the train step of ``launch/specs.py:build_step``, a
    prefill and two decode steps; written as numpy trees."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    import repro.configs as configs
    from repro.configs.registry import InputShape
    from repro.distributed.sharding import axis_rules
    from repro.launch import specs
    from repro.launch.mesh import make_rules
    from repro.models import model
    from repro.training.optimizer import OptimizerConfig, adamw_init

    for arch, shape, capacity in step_cases():
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:world_of(shape)])
        cfg = step_config(arch, configs, capacity)
        params = model.init_params(cfg, jax.random.key(0))
        data = {k: jnp.asarray(v) for k, v in step_inputs(cfg.vocab_size, capacity).items()}
        s = step_seq(capacity)
        batch = {"inputs": data["tokens"], "labels": data["labels"]}
        res = {}
        train = InputShape("train_reduced", s, STEP_B, "train")
        step, _, shardings, rules, _ = specs.build_step(cfg, train, mesh,
                                                        param_dtype=jnp.float32)
        with mesh, axis_rules(rules):
            new_p, new_o, metrics = jax.jit(step, in_shardings=shardings)(
                params, adamw_init(params, OptimizerConfig()), batch)
        res["step_loss"] = np.asarray(metrics["loss"])
        res["new_params"], res["m"], res["v"] = (jax.tree.map(np.asarray, t)
                                                 for t in (new_p, new_o["m"], new_o["v"]))
        pre_rules = make_rules(cfg, mesh, "prefill", batch_size=STEP_B)
        dec_rules = make_rules(cfg, mesh, "decode", batch_size=STEP_B, cache_len=2 * s)
        cache = model.init_cache(cfg, STEP_B, 2 * s)
        axes = specs.cache_axes(cache)
        p_axes = model.param_axes(cfg)
        moe_path = "ep_a2a" if cfg.num_experts else "local"
        with mesh, axis_rules(pre_rules):
            shard_in = (specs.shardings_of(p_axes, pre_rules),
                        specs.shardings_of({"t": ("batch", "seq_act")}, pre_rules)["t"],
                        specs.shardings_of(axes, pre_rules))
            logits, cache = jax.jit(
                lambda p, t, c: model.prefill(cfg, p, t, c, moe_path=moe_path),
                in_shardings=shard_in)(params, data["tokens"], cache)
            if capacity != STEP_CAPACITY:            # the same prefill, nothing dropped
                kept = step_config(arch, configs)
                res["prefill_logits_kept"] = np.asarray(jax.jit(
                    lambda p, t, c: model.prefill(kept, p, t, c, moe_path=moe_path)[0],
                    in_shardings=shard_in)(params, data["tokens"],
                                           model.init_cache(kept, STEP_B, 2 * s)))
        res["logits"] = [np.asarray(logits)]
        with mesh, axis_rules(dec_rules):
            shard_in = (specs.shardings_of(p_axes, dec_rules),
                        specs.shardings_of({"t": ("batch",)}, dec_rules)["t"],
                        specs.shardings_of(axes, dec_rules))
            dec = jax.jit(lambda p, t, c: model.decode_step(cfg, p, t, c),
                          in_shardings=shard_in)
            for tokens in data["decode"]:
                logits, cache = dec(params, tokens, jax.device_put(cache, shard_in[2]))
                res["logits"].append(np.asarray(logits))
        with open(os.path.join(out, f"{step_tag(arch, shape, capacity)}.jax.pkl"), "wb") as f:
            pickle.dump(res, f)


if __name__ == "__main__":
    job = sys.argv[1]
    if job in ("jax_ep", "jax_step"):
        {"jax_ep": run_jax_ep, "jax_step": run_jax_step}[job](sys.argv[2])
    else:
        rank, world, store, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
        {"ep": run_ep, "grid": run_grid, "step": run_step}[job](rank, world, store, out)
