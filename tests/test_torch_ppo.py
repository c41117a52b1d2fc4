"""The port's PPO controller (``repro_torch.core.rl.ppo``) against the
reference's ``repro.core.rl.ppo``.

The reference module does not import under this JAX: it reaches
``core/sim/jax_engine.py``, which imports ``jax.experimental.enable_x64``
(gone; ``jax.enable_x64`` is its new name).  The ``ref`` fixture loads it
once with that name aliased for the length of the import, then removes
the alias and the two half-registered modules again, so every other test
file sees the JAX package exactly as before (``test_reference_loader_leaks_nothing``).
What the loaded module computes without x64 (the net, GAE, rewards, the
loss, the update) is the oracle; its collectors run JAX's key chain
inside the JAX engine and are not.

Tolerances: the forward 1e-6 (float32, the same products); GAE and
rewards bit for bit (NumPy copies); the loss, its aux values and its
gradients 1e-5 relative to each leaf's largest value; updates 2e-5
absolute on parameters and Adam's moments.  The collectors are held to
the port's NumPy env: equal features and replayed actions, rewards,
log-probabilities and values within 1e-6.  Everything runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.rl import ppo
from repro_torch.core.rl import (
    EnvConfig,
    N_ACTIONS,
    OBS_DIM,
    PoolServingEnv,
    RLPoolPolicy,
    ServingEnv,
    save_policy_params,
)
from repro_torch.core.rl.policy import load_policy_checkpoint, policy_logits
from repro_torch.core.sim import (
    VariantCatalog,
    simulate,
    uniform_pool_workload,
)
from repro_torch.core.sim import torch_engine as te
from repro_torch.core.traces import get_trace
from repro_torch.core.workloads import get_scenario

DEV = "cpu"
POOL = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b"]


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.core.rl.ppo``, loaded with the
    ``enable_x64`` alias for the import only, then unregistered."""
    jax.experimental.enable_x64 = jax.enable_x64
    try:
        return importlib.import_module("repro.core.rl.ppo")
    finally:
        del jax.experimental.enable_x64
        import repro.core.rl
        import repro.core.sim

        for name in ("repro.core.rl.ppo", "repro.core.sim.jax_engine"):
            sys.modules.pop(name, None)
        for pkg, attr in ((repro.core.sim, "jax_engine"),
                          (repro.core.rl, "ppo")):
            if attr in vars(pkg):
                delattr(pkg, attr)


def test_reference_loader_leaks_nothing(ref):
    assert ref.__name__ == "repro.core.rl.ppo"
    assert not hasattr(jax.experimental, "enable_x64")
    assert "repro.core.sim.jax_engine" not in sys.modules
    with pytest.raises(ImportError):
        from repro.core.rl import train_ppo_pool  # noqa: F401


def _ref_params(ref, seed, hidden=64):
    return jax.tree.map(np.asarray,
                        ref.init_net(jax.random.key(seed),
                                     ref.PPOConfig(hidden=hidden)))


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(np.max(np.abs(np.asarray(b))), 1e-30))


# ---------------------------------------------------------------------------
# The net.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(ref, seed):
    tree = _ref_params(ref, seed)
    params = ppo.params_from_jax(tree)
    rng = np.random.default_rng(seed)
    for rows in (8, 257):                       # [A, F] and [N, F]
        obs = rng.standard_normal((rows, OBS_DIM)).astype(np.float32)
        want_l, want_v = ref.policy_logits_value(tree, jnp.asarray(obs))
        got_l, got_v = ppo.policy_logits_value(params, torch.as_tensor(obs))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-6, atol=1e-6)
    back = ppo.params_to_numpy(params)
    for name, layer in tree.items():
        for k, v in layer.items():
            assert back[name][k].dtype == np.float32
            np.testing.assert_array_equal(back[name][k], v)


def test_init_net_shapes_and_scales(ref):
    """The shapes of ``tests/test_rl.py::test_net_shapes``, the reference's
    leaf shapes, and its scales (``scale / sqrt(fan_in)``, zero biases)."""
    cfg = ppo.PPOConfig(hidden=16)
    params = ppo.init_net(torch.Generator().manual_seed(0), cfg)
    logits, value = ppo.policy_logits_value(params, torch.zeros((OBS_DIM,)))
    assert logits.shape == (N_ACTIONS,) and value.shape == ()
    logits_b, value_b = ppo.policy_logits_value(params,
                                                torch.zeros((5, OBS_DIM)))
    assert logits_b.shape == (5, N_ACTIONS) and value_b.shape == (5,)

    tree = _ref_params(ref, 0, hidden=64)
    big = ppo.init_net(torch.Generator().manual_seed(0), ppo.PPOConfig())
    for name, scale in (("torso1", 1.0), ("torso2", 1.0), ("pi", 0.01),
                        ("v", 1.0)):
        w, b = big[name]["w"], big[name]["b"]
        assert w.dtype == b.dtype == torch.float32
        assert tuple(w.shape) == tree[name]["w"].shape
        assert tuple(b.shape) == tree[name]["b"].shape
        assert not b.any()
        want = scale / np.sqrt(w.shape[0])
        assert float(w.std()) == pytest.approx(want, rel=0.25), name
    again = ppo.init_net(torch.Generator().manual_seed(0), ppo.PPOConfig())
    other = ppo.init_net(torch.Generator().manual_seed(1), ppo.PPOConfig())
    assert torch.equal(again["torso1"]["w"], big["torso1"]["w"])
    assert not torch.equal(other["torso1"]["w"], big["torso1"]["w"])


def test_forward_matches_numpy_policy_on_the_checkpoint():
    """The deployed controller's NumPy forward (``policy_logits``) on the
    committed checkpoint, in float64 on both sides."""
    tree, _ = load_policy_checkpoint()
    assert tree is not None
    params = {n: {k: torch.as_tensor(v) for k, v in layer.items()}
              for n, layer in tree.items()}
    obs = np.random.default_rng(0).random((64, OBS_DIM))
    got, _ = ppo.policy_logits_value(params, torch.as_tensor(obs))
    np.testing.assert_allclose(got.numpy(), policy_logits(tree, obs),
                               rtol=1e-10, atol=1e-10)


def test_stepwise_and_batched_samplers_agree():
    """The step-wise sampler on the engine's logits and uniforms draws the
    engine's actions: one inverse-CDF rule, against a NumPy inverse CDF."""
    rng = np.random.default_rng(4)
    logits = torch.as_tensor(rng.standard_normal((64, N_ACTIONS)) * 2.0)
    u = rng.random(64)
    got = te.sample_categorical(logits, torch.as_tensor(u)).numpy()
    p = np.exp(logits.numpy() - logits.numpy().max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.minimum((u[:, None] >= np.cumsum(p, -1)).sum(-1), N_ACTIONS - 1)
    np.testing.assert_array_equal(got, want)
    # pool_policy_action is that draw on its own forward pass
    params = ppo.init_net(torch.Generator().manual_seed(2), ppo.PPOConfig())
    params["pi"]["w"] = params["pi"]["w"] * 300.0      # peaked, not uniform
    obs = rng.standard_normal((64, OBS_DIM)).astype(np.float32)
    a, logp, v = ppo.pool_policy_action(params, obs, u)
    lg, val = ppo.policy_logits_value(params, torch.as_tensor(obs))
    np.testing.assert_array_equal(
        a, te.sample_categorical(lg, torch.as_tensor(u)).numpy())
    lp = torch.log_softmax(lg, -1).numpy()
    np.testing.assert_array_equal(logp, lp[np.arange(64), a])
    np.testing.assert_array_equal(v, val.detach().numpy())
    # a generator draws the same uniforms the caller could draw itself
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    b, _, _ = ppo.pool_policy_action(params, obs, g1)
    u2 = torch.rand(64, generator=g2, dtype=torch.float64).numpy()
    np.testing.assert_array_equal(b, ppo.pool_policy_action(params, obs,
                                                            u2)[0])
    with pytest.raises(ValueError, match="uniforms"):
        ppo.pool_policy_action(params, obs, u[:5])


# ---------------------------------------------------------------------------
# GAE and rewards.
# ---------------------------------------------------------------------------
def test_gae_pool_matches_reference_bit_for_bit(ref):
    rng = np.random.default_rng(1)
    T, A = 50, 6
    rewards = rng.standard_normal((T, A)).astype(np.float32)
    values = rng.standard_normal((T, A)).astype(np.float32)
    dones = np.zeros(T, np.float32)
    dones[[19, T - 1]] = 1.0                     # an interior boundary
    last_v = rng.standard_normal(A).astype(np.float32)
    for gamma, lam in ((0.97, 0.95), (1.0, 1.0)):
        got = ppo.compute_gae_pool(rewards, values, dones, last_v, gamma, lam)
        want = ref.compute_gae_pool(rewards, values, dones, last_v, gamma,
                                    lam)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    got = ppo.compute_gae(rewards[:, 0], values[:, 0], dones, 0.5, 0.9, 0.8)
    want = ref.compute_gae(rewards[:, 0], values[:, 0], dones, 0.5, 0.9, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_gae_simple_case():
    rewards = np.array([1.0, 1.0, 1.0], np.float32)
    values = np.zeros(3, np.float32)
    dones = np.zeros(3, np.float32)
    adv, ret = ppo.compute_gae(rewards, values, dones, last_value=0.0,
                               gamma=1.0, lam=1.0)
    # undiscounted full-lambda GAE == reward-to-go
    assert np.allclose(ret, [3.0, 2.0, 1.0])


def test_gae_done_boundary():
    rewards = np.array([1.0, 1.0], np.float32)
    values = np.zeros(2, np.float32)
    dones = np.array([1.0, 0.0], np.float32)    # episode ends after step 0
    adv, ret = ppo.compute_gae(rewards, values, dones, last_value=5.0,
                               gamma=0.9, lam=1.0)
    assert ret[0] == pytest.approx(1.0)          # no bootstrap across done
    assert ret[1] == pytest.approx(1.0 + 0.9 * 5.0)


def _vworkload():
    wl = uniform_pool_workload(POOL, strict_frac=0.25)
    return [dataclasses.replace(w, min_accuracy=0.5) for w in wl]


@pytest.fixture(scope="module")
def vcatalog():
    return VariantCatalog.for_workload(_vworkload())


def test_rewards_from_ys_match_reference_bit_for_bit(ref, vcatalog):
    """On one trajectory of the port's engine (rl_sample, a catalog, an
    accuracy bonus), in the single-cell and the stacked layout."""
    wl = _vworkload()
    arr = get_scenario("flash_anti").build(len(wl), duration_s=90,
                                           mean_rps=60)
    out = te.run_scenario(arr, wl, "rl_sample", catalog=vcatalog, seed=2,
                          record_trajectory=True, device=DEV)
    ys = out["trajectory"]
    raw = out["raw"]
    expired = raw["expired_s"] + raw["expired_r"]
    cfg = EnvConfig(mean_rps=60, accuracy_bonus=0.001)
    got = ppo._rewards_from_ys(cfg, ys, expired)
    want = ref._rewards_from_ys(cfg, ys, expired)
    assert got.shape == (90, len(wl))
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[-1]) > 0).all()
    stacked = {k: np.stack([ys[k], ys[k][::-1]]) for k in ys}
    both = np.stack([expired, 2 * expired])
    np.testing.assert_array_equal(ppo._rewards_from_ys(cfg, stacked, both),
                                  ref._rewards_from_ys(cfg, stacked, both))


# ---------------------------------------------------------------------------
# The update.
# ---------------------------------------------------------------------------
def _batch(ref, tree, n, seed):
    """An f32 minibatch whose old log-probabilities sit around the net's
    own, so that both sides of the clip are taken."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, OBS_DIM)).astype(np.float32)
    actions = rng.integers(0, N_ACTIONS, n).astype(np.int32)
    logits, _ = ref.policy_logits_value(tree, jnp.asarray(obs))
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(n), actions]
    return {
        "obs": obs,
        "actions": actions,
        "logp_old": (logp + 0.3 * rng.standard_normal(n)).astype(np.float32),
        "adv": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
    }


def _port_batch(b):
    return {k: torch.as_tensor(v.astype(np.int64) if k == "actions" else v)
            for k, v in b.items()}


def _tree_close(got, want, atol, what):
    for name, layer in want.items():
        for k, w in layer.items():
            g = got[name][k]
            g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
            err = np.abs(g - np.asarray(w))
            assert err.max() <= atol, (
                f"{what} {name}.{k}: {err.max()} at element "
                f"{np.unravel_index(err.argmax(), err.shape)}")


def test_loss_aux_and_grads_match_reference(ref):
    tree = _ref_params(ref, 3)
    b = _batch(ref, tree, 96, 0)
    cfg = ppo.PPOConfig(entropy_coef=0.05)
    args = (cfg.clip_eps, cfg.entropy_coef, cfg.value_coef)
    (want, want_aux), want_g = jax.value_and_grad(ref._loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, b), *args)
    params = {n: {k: torch.tensor(v, requires_grad=True)
                  for k, v in layer.items()} for n, layer in tree.items()}
    got, got_aux = ppo._loss(params, _port_batch(b), *args)
    got.backward()
    lp = np.asarray(jax.nn.log_softmax(ref.policy_logits_value(
        tree, b["obs"])[0]))[np.arange(96), b["actions"]]
    ratio = np.exp(lp - b["logp_old"])
    assert (ratio > 1 + cfg.clip_eps).any() and (ratio < 1 - cfg.clip_eps).any()
    assert _rel(got.item(), want) <= 1e-5
    assert set(got_aux) == set(want_aux) == {"pi_loss", "v_loss", "entropy",
                                             "approx_kl"}
    for k in want_aux:
        assert _rel(got_aux[k].item(), want_aux[k]) <= 1e-5, k
    for name, layer in want_g.items():
        for k, g in layer.items():
            assert _rel(params[name][k].grad.numpy(), g) <= 1e-5, (name, k)


@pytest.mark.parametrize("steps", [1, 8])
def test_ppo_update_matches_reference(ref, steps):
    """Chained updates on successive minibatches: parameters and Adam's
    ``(step, m, v)``, 2e-5 absolute."""
    tree = _ref_params(ref, 5)
    rcfg, cfg = ref.PPOConfig(), ppo.PPOConfig()
    rp = jax.tree.map(jnp.asarray, tree)
    rstate = (jnp.zeros((), jnp.int32), jax.tree.map(jnp.zeros_like, rp),
              jax.tree.map(jnp.zeros_like, rp))
    params = ppo.params_from_jax(tree)
    state = ppo.init_opt_state(params)
    for i in range(steps):
        b = _batch(ref, tree, 120, 10 + i)
        rp, rstate, rloss, raux = ref.ppo_update(
            rp, rstate, jax.tree.map(jnp.asarray, b), rcfg)
        params, state, loss, aux = ppo.ppo_update(
            params, state, _port_batch(b), cfg)
        assert _rel(loss.item(), rloss) <= 1e-5
        for k in raux:
            assert abs(aux[k].item() - float(raux[k])) <= 1e-5, k
    _tree_close(params, jax.tree.map(np.asarray, rp), 2e-5, "params")
    assert int(state[0]) == int(rstate[0]) == steps
    _tree_close(state[1], jax.tree.map(np.asarray, rstate[1]), 2e-5, "m")
    _tree_close(state[2], jax.tree.map(np.asarray, rstate[2]), 2e-5, "v")


def _ref_update_phase(ref, params, opt_state, buf, cfg, it):
    """The reference's loop body (``train_ppo_pool``, GAE through the
    minibatch updates) built from its own functions."""
    T, W = buf["rewards"].shape
    adv, rets = ref.compute_gae_pool(
        buf["rewards"], buf["values"], buf["dones"],
        np.asarray(buf["last_value"], np.float32), cfg.gamma, cfg.gae_lambda)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    flat = {
        "obs": buf["obs"].reshape(T * W, OBS_DIM),
        "actions": buf["actions"].reshape(T * W),
        "logp_old": buf["logp"].reshape(T * W),
        "adv": adv.reshape(T * W),
        "returns": rets.reshape(T * W),
    }
    idx = np.arange(T * W)
    rng = np.random.default_rng(cfg.seed + it)
    stats = []
    for _ in range(cfg.epochs):
        rng.shuffle(idx)
        for mb in np.array_split(idx, cfg.minibatches):
            batch = {k: jnp.asarray(v[mb]) for k, v in flat.items()}
            params, opt_state, loss, aux = ref.ppo_update(params, opt_state,
                                                          batch, cfg)
            stats.append(jnp.stack([loss, aux["pi_loss"], aux["v_loss"],
                                    aux["entropy"], aux["approx_kl"]]))
    return params, opt_state, np.asarray(jnp.stack(stats)).mean(axis=0)


def test_update_phase_matches_reference_loop_body(ref):
    T, W, it = 40, 6, 2
    rcfg = ref.PPOConfig(hidden=32, seed=5, entropy_coef=0.01)
    cfg = ppo.PPOConfig(hidden=32, seed=5, entropy_coef=0.01)
    tree = _ref_params(ref, 7, hidden=32)
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((T, W, OBS_DIM)).astype(np.float32)
    actions = rng.integers(0, N_ACTIONS, (T, W)).astype(np.int32)
    logits, values = ref.policy_logits_value(tree, jnp.asarray(obs))
    logp = np.asarray(jax.nn.log_softmax(logits))
    logp = np.take_along_axis(logp, actions[..., None], -1)[..., 0]
    dones = np.zeros(T, np.float32)
    dones[-1] = 1.0
    buf = {"obs": obs, "actions": actions, "logp": logp.astype(np.float32),
           "values": np.asarray(values, np.float32),
           "rewards": rng.standard_normal((T, W)).astype(np.float32),
           "dones": dones, "last_value": np.zeros(W, np.float32)}
    rp = jax.tree.map(jnp.asarray, tree)
    rstate = (jnp.zeros((), jnp.int32), jax.tree.map(jnp.zeros_like, rp),
              jax.tree.map(jnp.zeros_like, rp))
    rp, rstate, rmeans = _ref_update_phase(ref, rp, rstate, buf, rcfg, it)
    params = ppo.params_from_jax(tree)
    params, state, loss, aux, means = ppo.update_phase(
        params, ppo.init_opt_state(params), buf, cfg, it, device=DEV)
    assert int(state[0]) == int(rstate[0]) == cfg.epochs * cfg.minibatches
    _tree_close(params, jax.tree.map(np.asarray, rp), 2e-5, "params")
    np.testing.assert_allclose(means, rmeans, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The collectors, held to the NumPy env.
# ---------------------------------------------------------------------------
def _env(catalog=None, scenarios=("flash_anti",), mean_rps=60, duration=60,
         seed=4):
    wl = _vworkload() if catalog is not None else uniform_pool_workload(
        POOL, strict_frac=0.25)
    cfg = EnvConfig(mean_rps=mean_rps, duration_s=duration,
                    accuracy_bonus=0.001 if catalog is not None else 0.0)
    return PoolServingEnv(wl, cfg, scenarios=[get_scenario(s)
                                              for s in scenarios],
                          catalog=catalog, scenario_seed=seed)


def _live_net(seed=0):
    """A net whose policy head is peaked enough to leave the uniform
    policy, handed to the collector as tensors that need a gradient."""
    params = ppo.init_net(torch.Generator().manual_seed(seed),
                          ppo.PPOConfig(hidden=16))
    params["pi"]["w"] = params["pi"]["w"] * 100.0
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    return params


@pytest.mark.parametrize("with_catalog", [False, True])
def test_collector_replays_through_the_numpy_env(with_catalog, vcatalog):
    catalog = vcatalog if with_catalog else None
    env, replay = _env(catalog), _env(catalog)
    params = _live_net()
    buf = ppo.collect_rollouts_torch(env, params,
                                     torch.Generator().manual_seed(7),
                                     device=DEV)
    T, A = buf["actions"].shape
    assert (T, A) == (60, len(POOL)) and env._episode == 1
    assert buf["dones"][-1] == 1.0 and buf["dones"][:-1].sum() == 0
    assert len(np.unique(buf["actions"])) > 10
    obs = replay.reset()                   # the same draw, the same sim seed
    for t in range(T):
        np.testing.assert_array_equal(buf["obs"][t], obs, err_msg=f"tick {t}")
        obs, r, done, _ = replay.step(buf["actions"][t])
        np.testing.assert_allclose(buf["rewards"][t], r, rtol=1e-6,
                                   atol=1e-6, err_msg=f"tick {t}")
        assert done == (t == T - 1)
    # logp and values: a float64 NumPy forward of the same net
    p64 = {n: {k: v.detach().double().numpy() for k, v in layer.items()}
           for n, layer in params.items()}
    x = buf["obs"].astype(np.float64)
    h = np.tanh(x @ p64["torso1"]["w"] + p64["torso1"]["b"])
    h = np.tanh(h @ p64["torso2"]["w"] + p64["torso2"]["b"])
    logits = h @ p64["pi"]["w"] + p64["pi"]["b"]
    values = (h @ p64["v"]["w"] + p64["v"]["b"])[..., 0]
    lp = logits - logits.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    lp = np.take_along_axis(lp, buf["actions"][..., None].astype(np.int64),
                            -1)[..., 0]
    np.testing.assert_allclose(buf["logp"], lp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(buf["values"], values, rtol=1e-6, atol=1e-6)
    # the live net went into the engine as it is: detached, in float64
    direct = te._params_to_device([{"net": params}], DEV)["net"]
    host = te._params_to_device([{"net": ppo.params_to_numpy(params)}],
                                DEV)["net"]
    for n in host:
        for k in host[n]:
            assert direct[n][k].dtype == torch.float64
            assert not direct[n][k].requires_grad
            assert torch.equal(direct[n][k], host[n][k])


def test_zoo_block_equals_a_single_cell_collection():
    scs = ("mmpp_bursts", "flash_anti", "diurnal_phases")
    env = _env(scenarios=scs, duration=50)
    params = _live_net(1)
    S, A, T = len(scs), len(POOL), 50
    u = np.random.default_rng(5).random((S, T, A))
    zoo = ppo.collect_rollouts_torch_zoo(env, params, u, device=DEV)
    ep = env._episode
    assert ep == 1 and zoo["n_cells"] == S
    assert zoo["actions"].shape == (T, S * A)
    for i, sc in enumerate(env.scenarios):
        arr = sc.build(A, seed=sc.seed + ep, duration_s=50, mean_rps=60)
        one = ppo.collect_rollouts_torch(env, params, u[i], arrivals=arr,
                                         seed=ep * S + i, device=DEV)
        for k in ("obs", "actions", "logp", "values", "rewards"):
            np.testing.assert_array_equal(zoo[k][:, i * A:(i + 1) * A],
                                          one[k], err_msg=f"cell {i} {k}")
    assert env._episode == ep               # explicit arrivals draw nothing


def test_action_uniforms_come_from_the_training_seed():
    """Two training seeds draw different actions on the same sim seeds;
    the same seed draws the same."""
    def run(seed):
        env = _env(duration=40)
        st = ppo.train_ppo_pool(env, ppo.PPOConfig(iterations=1, hidden=16,
                                                   seed=seed),
                                torch_rollouts=True, device=DEV)
        return st.history[0]["rollout_reward"], st.final_params

    (r0, p0), (r0b, p0b), (r1, _) = run(0), run(0), run(1)
    assert r0 == r0b
    _tree_close(p0b, p0, 0.0, "same seed")
    assert r1 != r0


# ---------------------------------------------------------------------------
# Twins of the reference's PPO tests (which cannot run under this JAX).
# ---------------------------------------------------------------------------
def test_ppo_short_training_improves():
    """``tests/test_rl.py::test_ppo_short_training_improves``."""
    trace = get_trace("twitter", 300, mean_rps=40)
    env = ServingEnv(EnvConfig(arch="qwen1.5-0.5b", mean_rps=40), trace)
    cfg = ppo.PPOConfig(iterations=8, rollout_len=300, hidden=32, seed=1)
    state = ppo.train_ppo(env, cfg, device=DEV)
    assert len(state.history) == 8
    assert np.isfinite(state.best_reward)
    first = state.history[0]["rollout_reward"]
    assert state.best_reward >= first
    res = ppo.evaluate_policy(ServingEnv(env.cfg, env.base_trace),
                              state.params, seed=3, device=DEV)
    assert res.total_requests > 0
    assert res.violation_rate < 0.5


@pytest.mark.parametrize("batched", [False, True], ids=["stepwise", "zoo"])
def test_ppo_pool_smoke_three_iterations(batched):
    """``tests/test_rl_pool.py::test_ppo_pool_smoke_three_iterations``,
    step-wise and with ``torch_rollouts`` + ``full_zoo``."""
    wl = uniform_pool_workload(POOL[:2], strict_frac=0.25)
    cfg = EnvConfig(mean_rps=30, duration_s=80)
    env = PoolServingEnv(wl, cfg, scenarios=[get_scenario("mmpp_bursts")],
                         scenario_seed=2)
    state = ppo.train_ppo_pool(
        env, ppo.PPOConfig(iterations=3, rollout_len=80, hidden=16, seed=1),
        torch_rollouts=batched, full_zoo=batched, device=DEV)
    assert len(state.history) == 3
    assert np.isfinite(state.best_reward)
    assert state.best_reward >= state.history[0]["rollout_reward"]
    for tree in (state.params, state.final_params):
        assert all(v.dtype == np.float32 and isinstance(v, np.ndarray)
                   for layer in tree.values() for v in layer.values())
    res = ppo.evaluate_pool_policy(env, state.params, seed=3, device=DEV)
    assert res.total_requests > 0
    assert res.violation_rate < 0.5


def test_full_zoo_needs_torch_rollouts():
    env = _env(duration=20)
    with pytest.raises(ValueError, match="full_zoo"):
        ppo.train_ppo_pool(env, ppo.PPOConfig(iterations=1), full_zoo=True,
                           device=DEV)


def test_policy_checkpoint_roundtrip(tmp_path):
    """``tests/test_rl_pool.py::test_policy_checkpoint_roundtrip``: saved +
    reloaded params drive identical greedy decisions."""
    wl = uniform_pool_workload(POOL[:2], strict_frac=0.25)
    cfg = EnvConfig(mean_rps=30, duration_s=60)
    env = PoolServingEnv(wl, cfg, scenarios=[get_scenario("mmpp_bursts")])
    state = ppo.train_ppo_pool(env, ppo.PPOConfig(iterations=1,
                                                  rollout_len=60, hidden=16),
                               device=DEV)
    path = str(tmp_path / "ckpt.json")
    save_policy_params(state.params, path, meta={"test": True})
    arrivals = get_scenario("mmpp_bursts").build(2, duration_s=90,
                                                 mean_rps=30)
    a = simulate(arrivals, wl,
                 RLPoolPolicy(params=state.params, greedy=True)).summary()
    loaded = RLPoolPolicy(checkpoint=path, greedy=True)
    assert loaded.trained
    b = simulate(arrivals, wl, loaded).summary()
    assert a == b


def test_ppo_trains_variant_head_and_checkpoint_roundtrips(vcatalog,
                                                           tmp_path):
    """``tests/test_variants.py::test_ppo_trains_variant_head_and_checkpoint_roundtrips``."""
    wl = _vworkload()
    cfg = EnvConfig(mean_rps=40, duration_s=60, accuracy_bonus=0.001)
    env = PoolServingEnv(wl, cfg, scenarios=[get_scenario("flash_anti")],
                         catalog=vcatalog, scenario_seed=4)
    state = ppo.train_ppo_pool(env, ppo.PPOConfig(iterations=2,
                                                  rollout_len=60, hidden=16,
                                                  seed=2), device=DEV)
    assert len(state.history) == 2
    assert np.isfinite(state.best_reward)
    path = str(tmp_path / "variant_ckpt.json")
    save_policy_params(state.params, path)
    arr = get_scenario("flash_anti").build(len(POOL), duration_s=90,
                                           mean_rps=40)
    a = simulate(arr, wl, RLPoolPolicy(params=state.params, greedy=True),
                 catalog=vcatalog).summary()
    b = simulate(arr, wl, RLPoolPolicy(checkpoint=path, greedy=True),
                 catalog=vcatalog).summary()
    assert a == b


def test_ppo_training_log(tmp_path):
    """``tests/test_telemetry.py::test_ppo_training_log``."""
    wl = uniform_pool_workload(POOL[:2], strict_frac=0.25)
    env = PoolServingEnv(wl, EnvConfig(mean_rps=30, duration_s=60),
                         scenarios=[get_scenario("mmpp_bursts")])
    path = str(tmp_path / "curve.jsonl")
    state = ppo.train_ppo_pool(
        env, ppo.PPOConfig(iterations=2, rollout_len=60, hidden=16),
        log_path=path, device=DEV)
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == 2 == len(state.history)
    for row in rows:
        assert {"iter", "rollout_reward", "loss_mean", "pi_loss", "v_loss",
                "entropy_mean", "approx_kl"} <= set(row)
        assert np.isfinite([row["loss_mean"], row["entropy_mean"],
                            row["approx_kl"]]).all()
    assert rows == state.history            # the stream IS the history
    assert set(rows[0]) == {"iter", "rollout_reward", "mean_episode_reward",
                            "loss", "entropy", "loss_mean", "pi_loss",
                            "v_loss", "entropy_mean", "approx_kl"}


def test_package_exports_the_reference_ppo_names(ref):
    import repro_torch.core.rl as rl

    names = ("PPOConfig", "PPOState", "evaluate_policy",
             "evaluate_pool_policy", "policy_action", "pool_policy_action",
             "train_ppo", "train_ppo_pool")
    assert rl._PPO_EXPORTS == names
    for name in names:
        assert getattr(rl, name) is getattr(ppo, name)
        assert hasattr(ref, name)
    assert dataclasses.asdict(ppo.PPOConfig()) == dataclasses.asdict(
        ref.PPOConfig())
