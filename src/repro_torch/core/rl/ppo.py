"""Proximal Policy Optimization in PyTorch (paper §V), pool-wide.

The port's twin of ``src/repro/core/rl/ppo.py``.  The paper sketches a
PPO controller with the clipped surrogate
L(theta) = E_t[min(r_t A_t, clip(r_t, 1-eps, 1+eps) A_t)] over scheduling
decisions; this module implements the full loop over the *whole serving
pool*:

* a shared MLP torso with policy+value heads, applied **per arch row**
  (the factored action space of :mod:`repro_torch.core.rl.obs`): the
  same parameters control any pool size, and one forward pass over the
  ``[A, OBS_DIM]`` observation matrix prices every arch's action;
* batched rollouts: buffers are ``[T, A, ...]`` arrays, filled either by
  the NumPy :class:`~repro_torch.core.rl.env.PoolServingEnv` one tick at
  a time, or in one tick loop of the float64 torch engine
  (:mod:`repro_torch.core.sim.torch_engine`, policy ``rl_sample``) on
  the card;
* GAE(lambda) over ``[T, A]`` reward/value arrays with *per-arch credit
  assignment* (NumPy, as in the reference);
* minibatched clipped updates over the flattened ``[T*A, OBS_DIM]``
  batch, entropy bonus included: autograd of :func:`_loss`, then the
  reference's global-norm clip and Adam, written out by hand.

Actions are drawn by inverse CDF (:func:`torch_engine.sample_categorical`)
from float64 uniforms, which come from an explicit ``torch.Generator``
seeded with ``PPOConfig.seed``: the step-wise and the batched collectors
share that one sampling rule.  JAX's key chain cannot be reproduced in
torch, so the port's draws are its own.

The net trains in float32 on ``device`` (the card unless the caller asks
for the CPU).  The engine's rollouts run the same net in float64, as the
reference's do under x64, so ``logp_old`` and the update's first
``logp`` differ by float32 rounding.  :class:`PPOState` hands back NumPy
float32 parameter trees, which ``save_policy_params`` and
:class:`~repro_torch.core.rl.policy.RLPoolPolicy` read.

The single-arch ``train_ppo`` entry point is a thin shim: a legacy
:class:`~repro_torch.core.rl.env.ServingEnv` is the A=1 view of the pool
path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.rl.env import (
    N_ACTIONS,
    OBS_DIM,
    PoolServingEnv,
    ServingEnv,
)
from repro_torch.core.sim import torch_engine
from repro_torch.core.sim.telemetry import JsonlWriter

F32, F64 = torch.float32, torch.float64


@dataclass(frozen=True)
class PPOConfig:
    hidden: int = 64
    lr: float = 5e-4
    gamma: float = 0.97
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    epochs: int = 4
    minibatches: int = 8
    rollout_len: int = 1200        # cover a full episode -> every update
                                   # sees flash-crowd segments
    iterations: int = 60
    max_grad_norm: float = 0.5
    seed: int = 0


# ---------------------------------------------------------------------------
# Networks.  The torso maps one arch's feature row to logits/value; torch
# broadcasting applies it to [A, F] (a pool tick) and [N, F] (an update
# minibatch) alike.
# ---------------------------------------------------------------------------
def init_net(generator: torch.Generator, cfg: PPOConfig) -> dict:
    """The net's float32 parameters, drawn from ``generator`` on its
    device at the reference's scales: ``w = scale * N(0, 1) / sqrt(in)``,
    ``b = 0``, scale 0.01 for the policy head and 1 elsewhere."""
    h, dev = cfg.hidden, generator.device

    def lin(i, o, scale):
        w = torch.randn((i, o), generator=generator, dtype=F32, device=dev)
        return {"w": scale * w / float(np.sqrt(i)),
                "b": torch.zeros((o,), dtype=F32, device=dev)}

    return {
        "torso1": lin(OBS_DIM, h, 1.0),
        "torso2": lin(h, h, 1.0),
        "pi": lin(h, N_ACTIONS, 0.01),
        "v": lin(h, 1, 1.0),
    }


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The port's float32 tensors on ``device``, copied from a tree in the
    reference's layout: its ``init_net`` output through ``np.asarray``, a
    :class:`PPOState`'s parameters, a checkpoint's, or tensors."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=device, dtype=F32, copy=True)
        return torch.as_tensor(np.array(v, dtype=np.float32), device=device)

    return {name: {k: leaf(v) for k, v in layer.items()}
            for name, layer in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """The way back: NumPy float32 arrays on the host."""
    return {name: {k: v.detach().cpu().numpy() for k, v in layer.items()}
            for name, layer in params.items()}


def policy_logits_value(params, obs):
    """``(logits [..., N_ACTIONS], value [...])`` for ``[..., OBS_DIM]``
    features: the forward pass the engine's ``rl_sample`` runs."""
    return torch_engine._net_forward(params, obs)


def _uniforms(u, shape) -> np.ndarray:
    """Float64 action uniforms of ``shape`` on the host: drawn from a
    ``torch.Generator``, or given."""
    if isinstance(u, torch.Generator):
        u = torch.rand(shape, generator=u, dtype=F64, device=u.device).cpu()
    u = np.asarray(u, dtype=np.float64)
    if u.shape != tuple(shape):
        raise ValueError(f"action uniforms of shape {u.shape}, need {shape}")
    return u


def pool_policy_action(params, obs: np.ndarray, u) -> Tuple[np.ndarray, ...]:
    """Sample per-arch actions for one pool tick: obs ``[A, F]`` ->
    ``(actions, logp, values)``, each ``[A]``, drawn by the engine's
    inverse CDF from ``u`` (``[A]`` uniforms or a ``torch.Generator``)."""
    w = params["torso1"]["w"]
    obs = torch.as_tensor(np.asarray(obs), device=w.device)
    logits, values = policy_logits_value(params, obs)
    u = torch.as_tensor(_uniforms(u, obs.shape[:1]), device=w.device)
    actions = torch_engine.sample_categorical(logits, u)
    logp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                        actions[:, None])[:, 0]
    return (actions.cpu().numpy(), logp.detach().cpu().numpy(),
            values.detach().cpu().numpy())


def policy_action(params, obs: np.ndarray, u) -> Tuple[int, float, float]:
    """Single-arch convenience form (seed interface); ``u`` is one
    uniform (shape ``[1]``) or a ``torch.Generator``."""
    a, logp, v = pool_policy_action(params, np.asarray(obs)[None, :], u)
    return int(a[0]), float(logp[0]), float(v[0])


# ---------------------------------------------------------------------------
# GAE (NumPy, as in the reference).
# ---------------------------------------------------------------------------
def compute_gae_pool(rewards, values, dones, last_value, gamma, lam):
    """GAE over ``[T, A]`` per-arch reward/value streams.

    ``dones[t]`` is the shared episode boundary (the whole pool resets
    together); advantages are otherwise accumulated independently per
    arch, which is the credit-assignment half of the factored action
    space.
    """
    T, A = rewards.shape
    adv = np.zeros((T, A), dtype=np.float32)
    lastgaelam = np.zeros(A, dtype=np.float32)
    for t in reversed(range(T)):
        nonterminal = 1.0 - float(dones[t])
        next_v = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    returns = adv + values
    return adv, returns


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """Single-stream GAE (seed interface): the A=1 column of the pool form."""
    adv, ret = compute_gae_pool(
        np.asarray(rewards, np.float32)[:, None],
        np.asarray(values, np.float32)[:, None],
        dones,
        np.float32(last_value),
        gamma,
        lam,
    )
    return adv[:, 0], ret[:, 0]


# ---------------------------------------------------------------------------
# Batched rollout collection: one whole episode in one tick loop of the
# torch engine instead of T host round-trips through env.step.
# ---------------------------------------------------------------------------
def _rewards_from_ys(cfg, ys, expired) -> np.ndarray:
    """Per-tick ``[..., T, A]`` rewards rebuilt from the engine's per-arch
    attribution, with the end-of-trace expired sweep booked on the last
    tick exactly as ``env.step`` does."""
    viol = np.array(ys["viol"], dtype=np.float64)    # owned: last tick edited
    viol[..., -1, :] += expired
    return -cfg.reward_scale * (
        ys["cost_arch"]
        + cfg.violation_penalty * viol
        - cfg.accuracy_bonus * ys["acc_w"]
    )


#: the engine's per-tick outputs a collector keeps
_YS_KEYS = ("obs", "action", "logp", "value", "viol", "cost_arch", "acc_w")


def _engine_rollouts(env: PoolServingEnv, params, arrs, seeds, uniforms,
                     device):
    """Run ``arrs`` (``[B, A, T]``) as the cells of one ``rl_sample``
    tick loop with the live net; returns the kept outputs ``[B, T, A,
    ...]`` and the end-of-trace expired mass ``[B, A]`` on the host."""
    cfg = env.cfg
    policy = {"net": params, "rate_scale": cfg.rate_scale,
              "fleet_scale": cfg.fleet_scale}
    statics, state0, xs, variants = torch_engine.prepare_grid(
        arrs, env.workload, "rl_sample", [policy] * len(arrs), seeds,
        pricing=cfg.pricing, catalog=env.catalog, uniforms=uniforms,
        device=device,
    )
    out = torch_engine.run_ticks(
        torch_engine.TORCH_POLICIES["rl_sample"].apply, statics, state0, xs,
        variants=variants, stack=True,
    )
    ys = {k: np.swapaxes(out["ys"][k].cpu().numpy(), 0, 1) for k in _YS_KEYS}
    return ys, (out["expired_s"] + out["expired_r"]).cpu().numpy()


def collect_rollouts_torch(env: PoolServingEnv, params, uniforms, *,
                           arrivals=None, seed: int = 0,
                           device="cuda") -> dict:
    """Collect one full-episode ``[T, A]`` rollout in one tick loop.

    Drives the batched torch engine with the stochastic ``rl_sample``
    policy: the net's forward pass (float64), the inverse-CDF draw from
    ``uniforms`` (``[T, A]`` float64, or a ``torch.Generator`` to draw
    them from) and the procurement decode all run in the loop on
    ``device``, and the per-tick extras come back as the buffers the
    host rollout loop fills (features, sampled actions, log-probs,
    values), plus rewards rebuilt from the engine's per-arch
    cost/violation/accuracy attribution under the env's
    :class:`~repro_torch.core.rl.env.EnvConfig` weights.  The env's
    variant catalog rides into the loop, so the variant head executes.

    Arrival precedence matches ``env.reset``: an explicit ``arrivals``
    matrix (with sim ``seed``), else a fresh draw from the env's scenario
    pool (sim seed = the env's episode counter), else the fixed matrix
    the env was built with.  Episodes are done-terminated only at the
    trace end, so ``dones`` is a one-hot tail and ``last_value`` is
    irrelevant to GAE (returned as zeros).
    """
    cfg = env.cfg
    if arrivals is not None:
        tr = arrivals
    elif env.scenarios:
        tr = env._sample_arrivals()
        seed = env._episode          # the per-episode sim seed env.reset uses
    else:
        tr = env.base_arrivals
    tr = np.asarray(tr, dtype=np.float64)
    A, T = tr.shape
    u = _uniforms(uniforms, (T, A))
    ys, expired = _engine_rollouts(env, params, tr[None], [seed], u[None],
                                   device)
    ys = {k: v[0] for k, v in ys.items()}
    rewards = _rewards_from_ys(cfg, ys, expired[0])
    dones = np.zeros(T, dtype=np.float32)
    dones[-1] = 1.0
    return {
        "obs": np.asarray(ys["obs"], dtype=np.float32),
        "actions": np.asarray(ys["action"], dtype=np.int32),
        "logp": np.asarray(ys["logp"], dtype=np.float32),
        "values": np.asarray(ys["value"], dtype=np.float32),
        "rewards": rewards.astype(np.float32),
        "dones": dones,
        "last_value": np.zeros(A, dtype=np.float32),
    }


def collect_rollouts_torch_zoo(env: PoolServingEnv, params, uniforms, *,
                               device="cuda") -> dict:
    """Collect ``[S, T, A]`` rollouts over the env's WHOLE scenario pool
    in one tick loop: the full-zoo form of :func:`collect_rollouts_torch`.

    Every scenario in ``env.scenarios`` becomes a cell of the batched
    engine: per-cell arrival realizations, sim seeds (``ep * S + i``,
    distinct across cells and iterations) and uniforms (``[S, T, A]``,
    or a ``torch.Generator``) are all distinct, the net's parameters are
    shared across cells, and the per-cell monitor streams run as one
    batched recurrence.

    The returned buffers merge the cell axis into the arch axis,
    ``[T, S*A, ...]``, so GAE and the PPO update treat the zoo batch
    exactly like a wider pool: ``dones`` is the shared one-hot tail,
    per-column advantage streams never mix cells, and the flattened
    update batch has ``T*S*A`` rows.
    """
    cfg = env.cfg
    if not env.scenarios:
        raise ValueError("full-zoo collection needs a scenario pool")
    S, A = len(env.scenarios), env.n_archs
    env._episode += 1              # one zoo sweep advances the episode clock
    ep = env._episode
    arrs = np.stack([
        np.asarray(
            sc.build(A, seed=sc.seed + ep, duration_s=cfg.duration_s,
                     mean_rps=cfg.mean_rps),
            dtype=np.float64,
        )
        for sc in env.scenarios
    ])                             # [S, A, T]
    T = arrs.shape[2]
    u = _uniforms(uniforms, (S, T, A))
    ys, expired = _engine_rollouts(env, params, arrs,
                                   [ep * S + i for i in range(S)], u, device)
    rewards = _rewards_from_ys(cfg, ys, expired)

    def merge(x, dtype):           # [S, T, A, ...] -> [T, S*A, ...]
        x = np.asarray(x)
        return np.swapaxes(x, 0, 1).reshape(
            (T, S * A) + x.shape[3:]
        ).astype(dtype)

    dones = np.zeros(T, dtype=np.float32)
    dones[-1] = 1.0
    return {
        "obs": merge(ys["obs"], np.float32),
        "actions": merge(ys["action"], np.int32),
        "logp": merge(ys["logp"], np.float32),
        "values": merge(ys["value"], np.float32),
        "rewards": merge(rewards, np.float32),
        "dones": dones,
        "last_value": np.zeros(S * A, dtype=np.float32),
        "n_cells": S,
    }


# ---------------------------------------------------------------------------
# Update.
# ---------------------------------------------------------------------------
def _loss(params, batch, clip_eps, entropy_coef, value_coef):
    logits, values = policy_logits_value(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, 1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["adv"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
    v_loss = torch.mean((values - batch["returns"]) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    # the standard sampled KL(old || new) estimator over the batch: the
    # health signal telemetry tracks per iteration (a spike means the
    # clipped surrogate stopped trusting the rollout distribution)
    approx_kl = torch.mean(batch["logp_old"] - logp)
    total = pi_loss + value_coef * v_loss - entropy_coef * entropy
    return total, {"pi_loss": pi_loss, "v_loss": v_loss, "entropy": entropy,
                   "approx_kl": approx_kl}


def init_opt_state(params: dict) -> tuple:
    """Adam's ``(step, m, v)``: an int32 step count and zero moments."""
    def zeros():
        return {n: {k: torch.zeros_like(v) for k, v in layer.items()}
                for n, layer in params.items()}

    step = torch.zeros((), dtype=torch.int32,
                       device=params["torso1"]["w"].device)
    return step, zeros(), zeros()


def ppo_update(params, opt_state, batch, cfg: PPOConfig):
    """One minibatch step: the gradient of :func:`_loss`, the global-norm
    clip ``min(1, max_norm / (|g| + 1e-8))``, then Adam (b1 0.9, b2
    0.999, eps 1e-8) with bias correction, as the reference writes them
    out.  Functional: returns new tensors and never waits on the
    device."""
    names = [(n, k) for n, layer in params.items() for k in layer]
    live = {n: {k: v.detach().requires_grad_(True) for k, v in layer.items()}
            for n, layer in params.items()}
    loss, aux = _loss(live, batch, cfg.clip_eps, cfg.entropy_coef,
                      cfg.value_coef)
    grads = torch.autograd.grad(loss, [live[n][k] for n, k in names])
    gnorm = torch.sqrt(sum(torch.sum(g ** 2) for g in grads))
    scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-8), max=1.0)

    step, m, v = opt_state
    step = step + 1
    b1, b2, eps = 0.9, 0.999, 1e-8
    new_p, new_m, new_v = ({n: {} for n in params} for _ in range(3))
    for (n, k), g in zip(names, grads):
        g = g * scale
        m_ = b1 * m[n][k] + (1 - b1) * g
        v_ = b2 * v[n][k] + (1 - b2) * g * g
        mhat = m_ / (1 - b1 ** step)
        vhat = v_ / (1 - b2 ** step)
        new_p[n][k] = params[n][k] - cfg.lr * mhat / (torch.sqrt(vhat) + eps)
        new_m[n][k], new_v[n][k] = m_, v_
    return (new_p, (step, new_m, new_v), loss.detach(),
            {k: a.detach() for k, a in aux.items()})


def update_phase(params, opt_state, buf: dict, cfg: PPOConfig, it: int, *,
                 device="cuda"):
    """One iteration's update on a rollout buffer (``obs``, ``actions``,
    ``logp``, ``values``, ``rewards``, ``dones``, ``last_value``): GAE,
    advantage normalisation, then ``cfg.epochs`` passes of
    ``cfg.minibatches`` clipped updates over the flattened ``[T*W]``
    batch, shuffled by ``np.random.default_rng(cfg.seed + it)`` and split
    by ``np.array_split``, as the reference's loop body.  The batch and
    every permutation move to ``device`` once; the only wait on the
    device is for the iteration's loss means.  Returns ``(params,
    opt_state, loss, aux, means)``: the last minibatch's loss and aux,
    and the means of (loss, pi_loss, v_loss, entropy, approx_kl)."""
    obs_buf, rew_buf = buf["obs"], buf["rewards"]
    adv, rets = compute_gae_pool(
        rew_buf, buf["values"], buf["dones"],
        np.asarray(buf["last_value"], np.float32),
        cfg.gamma, cfg.gae_lambda,
    )
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)

    # flatten [T, W] -> [T*W] and update on shuffled minibatches
    # (W = A, or S*A when a full-zoo batch merged the cell axis)
    T, W = rew_buf.shape
    flat = {
        "obs": obs_buf.reshape(T * W, OBS_DIM),
        "actions": buf["actions"].reshape(T * W).astype(np.int64),
        "logp_old": buf["logp"].reshape(T * W),
        "adv": adv.reshape(T * W),
        "returns": rets.reshape(T * W),
    }
    flat = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in flat.items()}
    idx = np.arange(T * W)
    rng = np.random.default_rng(cfg.seed + it)
    perms = []
    for _ in range(cfg.epochs):
        rng.shuffle(idx)
        perms.append(idx.copy())
    perms = torch.as_tensor(np.stack(perms), device=device)
    bounds = np.cumsum([0] + [len(mb) for mb in
                              np.array_split(idx, cfg.minibatches)])
    mb_stats = []
    for e in range(cfg.epochs):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            mb = perms[e, lo:hi]
            batch = {k: v[mb] for k, v in flat.items()}
            params, opt_state, loss, aux = ppo_update(params, opt_state,
                                                      batch, cfg)
            mb_stats.append(torch.stack([
                loss, aux["pi_loss"], aux["v_loss"], aux["entropy"],
                aux["approx_kl"],
            ]))
    means = torch.stack(mb_stats).cpu().numpy().mean(axis=0)
    return params, opt_state, loss, aux, means


@dataclass
class PPOState:
    params: dict                 # best-seen policy (by rollout reward)
    final_params: dict           # last-iteration policy
    opt_state: tuple
    history: List[dict]
    best_reward: float = float("-inf")


def train_ppo_pool(
    env: Union[PoolServingEnv, ServingEnv],
    cfg: PPOConfig = PPOConfig(),
    *,
    verbose: bool = False,
    torch_rollouts: bool = False,
    full_zoo: bool = False,
    log_path: Optional[str] = None,
    device="cuda",
) -> PPOState:
    """Train the pool controller with batched ``[T, A]`` rollouts on
    ``device``.

    The step-wise path drives ``env.step`` (NumPy) with one forward pass
    a tick.  ``torch_rollouts=True`` swaps it for
    :func:`collect_rollouts_torch`: each iteration collects exactly one
    full episode in one tick loop of the torch engine on ``device``
    (``cfg.rollout_len`` is superseded by the episode length on that
    path); the update is the same.

    ``full_zoo=True`` (requires ``torch_rollouts`` and a scenario pool)
    swaps the per-iteration scenario *sample* for the whole pool:
    :func:`collect_rollouts_torch_zoo` runs every scenario as a cell of
    one tick loop and each update trains on the merged ``[T, S*A]``
    batch.

    Each iteration's action uniforms come from one ``torch.Generator``
    seeded with ``cfg.seed`` (which also draws the initial net), not from
    the sim seed.  ``log_path`` streams the per-iteration training curve
    (the fields ``history`` keeps) to a JSONL file as it trains.
    """
    if isinstance(env, ServingEnv):
        env = env.pool
    if full_zoo and not (torch_rollouts and env.scenarios):
        raise ValueError("full_zoo needs torch_rollouts=True and a scenario "
                         "pool")
    A = env.n_archs
    gen = torch.Generator().manual_seed(cfg.seed)
    params = params_from_jax(init_net(gen, cfg), device=device)
    opt_state = init_opt_state(params)

    obs = env.reset()
    history: List[dict] = []
    ep_reward, ep_rewards = 0.0, []
    best_reward, best_params = float("-inf"), params
    log = JsonlWriter(log_path) if log_path else None

    for it in range(cfg.iterations):
        if torch_rollouts:
            buf = (collect_rollouts_torch_zoo(env, params, gen, device=device)
                   if full_zoo
                   else collect_rollouts_torch(env, params, gen,
                                               device=device))
            ep_rewards.append(float(buf["rewards"].sum()))
        else:
            T = cfg.rollout_len
            u = _uniforms(gen, (T, A))
            buf = {
                "obs": np.zeros((T, A, OBS_DIM), np.float32),
                "actions": np.zeros((T, A), np.int32),
                "logp": np.zeros((T, A), np.float32),
                "values": np.zeros((T, A), np.float32),
                "rewards": np.zeros((T, A), np.float32),
                "dones": np.zeros((T,), np.float32),
            }
            for t in range(T):
                a, logp, v = pool_policy_action(params, obs, u[t])
                buf["obs"][t], buf["actions"][t] = obs, a
                buf["logp"][t], buf["values"][t] = logp, v
                obs, r_arch, done, _ = env.step(a)
                buf["rewards"][t], buf["dones"][t] = r_arch, float(done)
                ep_reward += float(r_arch.sum())
                if done:
                    ep_rewards.append(ep_reward)
                    ep_reward = 0.0
                    obs = env.reset()
            _, last_v = policy_logits_value(
                params, torch.as_tensor(obs, device=device))
            buf["last_value"] = last_v.detach().cpu().numpy()
        params, opt_state, loss, aux, it_mean = update_phase(
            params, opt_state, buf, cfg, it, device=device)

        roll_r = float(buf["rewards"].sum())
        if roll_r > best_reward:
            # PPO can catastrophically forget a good procurement policy on a
            # later unlucky rollout; keep the best-seen snapshot (updates
            # make new tensors, so this one is never written again)
            best_reward = roll_r
            best_params = params

        mean_ep = float(np.mean(ep_rewards[-5:])) if ep_rewards else float("nan")
        history.append(
            {
                "iter": it,
                "rollout_reward": roll_r,
                "mean_episode_reward": mean_ep,
                # last-minibatch values (seed-era fields), plus the
                # iteration means the telemetry curve tracks
                "loss": float(loss),
                "entropy": float(aux["entropy"]),
                "loss_mean": float(it_mean[0]),
                "pi_loss": float(it_mean[1]),
                "v_loss": float(it_mean[2]),
                "entropy_mean": float(it_mean[3]),
                "approx_kl": float(it_mean[4]),
            }
        )
        if log is not None:
            log.write(history[-1])
        if verbose and it % 5 == 0:
            print(
                f"[ppo] it={it:3d} rollout_r={roll_r:9.4f} "
                f"ep_r={mean_ep:9.3f} H={history[-1]['entropy']:.3f}",
                flush=True,
            )
    if log is not None:
        log.close()
    step, m, v = opt_state
    return PPOState(
        params=params_to_numpy(best_params),
        final_params=params_to_numpy(params),
        opt_state=(int(step), params_to_numpy(m), params_to_numpy(v)),
        history=history,
        best_reward=best_reward,
    )


def train_ppo(env: ServingEnv, cfg: PPOConfig = PPOConfig(), *,
              verbose: bool = False, device="cuda") -> PPOState:
    """Seed entry point: single-arch training is the A=1 pool path."""
    return train_ppo_pool(env, cfg, verbose=verbose, device=device)


def evaluate_pool_policy(env: PoolServingEnv, params, *,
                         arrivals=None, greedy: bool = False, seed: int = 1,
                         device="cuda"):
    """Run one full pool episode; return the SimResult.

    Stochastic evaluation (the default) is the trained object: the policy
    hedges between procurement modes tick-by-tick, and argmax-collapsing
    it discards the offload behaviour it actually learned.  Draws come
    from a ``torch.Generator`` seeded with ``seed``."""
    params = params_from_jax(params, device=device)
    gen = torch.Generator().manual_seed(seed)
    obs = env.reset(arrivals)
    done = False
    while not done:
        if greedy:
            logits, _ = policy_logits_value(
                params, torch.as_tensor(obs, device=device))
            a = logits.argmax(dim=-1).cpu().numpy()
        else:
            a, _, _ = pool_policy_action(params, obs, gen)
        obs, _, done, _ = env.step(a)
    return env.episode_result()


def evaluate_policy(env: ServingEnv, params, *, greedy: bool = False,
                    seed: int = 1, device="cuda"):
    """Single-arch evaluation (seed interface)."""
    return evaluate_pool_policy(env.pool, params, greedy=greedy, seed=seed,
                                device=device)
