"""The control subsystem: the serving simulator as an RL problem.

  obs     — [A, OBS_DIM] feature construction + the factored per-arch
            action space (NumPy-only, shared by env and deployed policy)
  env     — PoolServingEnv (pool-wide, SoA, per-arch reward
            decomposition) and the single-arch ServingEnv wrapper
  policy  — RLPoolPolicy: the trained controller as a ``vectorized``
            scheduler (registered in ``VECTOR_SCHEDULERS["rl_pool"]``)

The training half (``ppo``) is not ported yet, so this package exports
only the NumPy environment, features and deployed policy.
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

