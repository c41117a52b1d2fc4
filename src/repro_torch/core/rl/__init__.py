"""The control subsystem: the serving simulator as an RL problem.

  obs     — [A, OBS_DIM] feature construction + the factored per-arch
            action space (NumPy-only, shared by env and deployed policy)
  env     — PoolServingEnv (pool-wide, SoA, per-arch reward
            decomposition) and the single-arch ServingEnv wrapper
  ppo     — batched pool PPO in PyTorch ([T, A] rollouts from the env or
            the torch tick engine, GAE over [T, A], minibatch updates
            over the flattened batch)
  policy  — RLPoolPolicy: the trained controller as a ``vectorized``
            scheduler (registered in ``VECTOR_SCHEDULERS["rl_pool"]``)

The training half (``ppo``) stands on the torch tick engine, which
imports ``obs`` and ``policy`` from this package; its exports are loaded
lazily so that importing the package, which the classical schedulers do
to register ``rl_pool``, neither cycles back into the engine nor loads
torch's training path.
"""
from repro_torch.core.rl.env import (  # noqa: F401
    EnvConfig,
    PoolServingEnv,
    ServingEnv,
)
from repro_torch.core.rl.obs import (  # noqa: F401
    HEADROOMS,
    N_ACTIONS,
    N_PROCURE,
    OBS_DIM,
    OFFLOADS,
    SPOT_MOVES,
    VARIANT_MOVES,
    decode_actions,
    pool_features,
    procurement_action,
    spot_targets,
    variant_targets,
)
from repro_torch.core.rl.policy import (  # noqa: F401
    DEFAULT_CHECKPOINT,
    RLPoolPolicy,
    load_policy_params,
    save_policy_params,
)


#: lazily resolved from :mod:`repro_torch.core.rl.ppo` (stands on the engine)
_PPO_EXPORTS = (
    "PPOConfig",
    "PPOState",
    "evaluate_policy",
    "evaluate_pool_policy",
    "policy_action",
    "pool_policy_action",
    "train_ppo",
    "train_ppo_pool",
)


def __getattr__(name: str):
    if name in _PPO_EXPORTS:
        from repro_torch.core.rl import ppo

        return getattr(ppo, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_PPO_EXPORTS))
