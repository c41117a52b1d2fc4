"""The trained pool controller as a deployable vectorized scheduler.

:class:`RLPoolPolicy` speaks the engine's structure-of-arrays policy
interface (``vectorized = True``: ``PoolObs -> PoolAction``), so the PPO
controller lines up head-to-head with the six classical schedulers in
``VECTOR_SCHEDULERS`` — same benchmarks, same scenario zoo, same tick
loop.  Inference is NumPy-only (a two-layer tanh torso per arch row); the
batched torch engine runs the same net through :func:`policy_logits_torch`.

Checkpoints are plain JSON (``save_policy_params`` /
``load_policy_params``): ``benchmarks/rl_vs_schemes.py`` trains the
controller and writes :data:`DEFAULT_CHECKPOINT`, which a bare
``RLPoolPolicy()`` — the form the benchmark grids instantiate — loads
by default.  Without a checkpoint the policy falls back to a seeded
random initialization: still a valid (if untrained) controller, so
grids never crash on a fresh clone.
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rl.obs import (
    N_ACTIONS,
    OBS_DIM,
    pool_features,
    procurement_action,
)
from repro_torch.core.sim import PoolAction, PoolObs

#: where the RL benchmark publishes the trained pool controller
DEFAULT_CHECKPOINT = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "..",
    "artifacts", "rl", "pool_policy.json",
)

_LAYERS = ("torso1", "torso2", "pi", "v")


def policy_logits(params: dict, feats):
    """Two-layer tanh torso + action head.

    The single definition of the controller's forward pass:
    :class:`RLPoolPolicy` runs it eagerly in NumPy; the batched torch
    engine runs :func:`policy_logits_torch`, its torch form.
    """
    h = np.tanh(feats @ params["torso1"]["w"] + params["torso1"]["b"])
    h = np.tanh(h @ params["torso2"]["w"] + params["torso2"]["b"])
    return h @ params["pi"]["w"] + params["pi"]["b"]


def policy_logits_torch(params: dict, feats):
    """:func:`policy_logits` on torch tensors.  NumPy promotes the
    float32 features against the float64 checkpoint weights, so the
    torch form casts them to the weights' dtype first (torch's matmul
    does not promote).  Weights may carry a leading cell axis
    (``w [B, I, O]`` against ``feats [B, A, I]``, ``b [B, 1, O]``)."""
    w1 = params["torso1"]["w"]
    h = torch.tanh(feats.to(w1.dtype) @ w1 + params["torso1"]["b"])
    h = torch.tanh(h @ params["torso2"]["w"] + params["torso2"]["b"])
    return h @ params["pi"]["w"] + params["pi"]["b"]


def params_to_jsonable(params: dict) -> dict:
    """NumPy param tree -> plain nested lists (for JSON)."""
    return {
        name: {k: np.asarray(v).tolist() for k, v in layer.items()}
        for name, layer in params.items()
    }


def save_policy_params(params: dict, path: str = DEFAULT_CHECKPOINT, *,
                       meta: Optional[dict] = None,
                       rate_scale: float = 100.0,
                       fleet_scale: float = 10.0) -> str:
    """Persist params + the feature-normalization constants the policy
    was trained with (a controller deployed with mismatched observation
    scales silently degrades)."""
    meta = dict(meta or {})
    meta.setdefault("rate_scale", rate_scale)
    meta.setdefault("fleet_scale", fleet_scale)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"params": params_to_jsonable(params), "meta": meta}, f)
    return path


def load_policy_checkpoint(
    path: str = DEFAULT_CHECKPOINT,
) -> Tuple[Optional[dict], dict]:
    """Load ``(params, meta)`` — params as float64 arrays, None when absent."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None, {}
    with open(path) as f:
        payload = json.load(f)
    params = {
        name: {k: np.asarray(v, dtype=np.float64) for k, v in layer.items()}
        for name, layer in payload["params"].items()
    }
    return params, payload.get("meta", {})


def load_policy_params(path: str = DEFAULT_CHECKPOINT) -> Optional[dict]:
    """Params-only form of :func:`load_policy_checkpoint`."""
    return load_policy_checkpoint(path)[0]


def _fallback_params(seed: int = 0) -> dict:
    """Seeded random init matching the PPO net's shapes/scales."""
    rng = np.random.default_rng(seed)
    h = 64

    def lin(i, o, scale):
        return {
            "w": scale * rng.standard_normal((i, o)) / np.sqrt(i),
            "b": np.zeros(o),
        }

    return {
        "torso1": lin(OBS_DIM, h, 1.0),
        "torso2": lin(h, h, 1.0),
        "pi": lin(h, N_ACTIONS, 0.01),
        "v": lin(h, 1, 1.0),
    }


@dataclass
class RLPoolPolicy:
    """PPO pool controller behind the vectorized scheduler interface.

    ``params`` may be passed directly (fresh from ``train_ppo_pool``);
    otherwise the default checkpoint is loaded, falling back to a seeded
    random net.  Action selection is stochastic by default — that is
    the trained object (the policy hedges between procurement modes
    tick-by-tick) — but seeded, so every run of a benchmark cell is
    reproducible; ``greedy=True`` argmax-collapses it.
    """

    vectorized = True

    params: Optional[dict] = None
    checkpoint: str = DEFAULT_CHECKPOINT
    greedy: bool = False
    seed: int = 0
    trained: bool = field(default=False, init=False)
    _rng: np.random.Generator = field(default=None, init=False, repr=False)
    _prev_rate: Optional[np.ndarray] = field(default=None, init=False, repr=False)

    # feature normalization — must match the training env's EnvConfig
    rate_scale: float = 100.0
    fleet_scale: float = 10.0

    def __post_init__(self):
        if self.params is None:
            self.params, meta = load_policy_checkpoint(self.checkpoint)
            if self.params is not None and (
                self.params["torso1"]["w"].shape[0] != OBS_DIM
                or self.params["pi"]["w"].shape[1] != N_ACTIONS
            ):
                # a checkpoint trained under an older obs/action space
                # (e.g. pre-variant-head) cannot drive this policy
                warnings.warn(
                    f"RLPoolPolicy: checkpoint at {self.checkpoint!r} is "
                    f"STALE (obs {self.params['torso1']['w'].shape[0]} vs "
                    f"{OBS_DIM}, actions {self.params['pi']['w'].shape[1]} "
                    f"vs {N_ACTIONS}); falling back to seeded random "
                    "(UNTRAINED) weights — re-run `python -m benchmarks.run "
                    "--only rl` to retrain",
                    stacklevel=2,
                )
                self.params = None
            elif self.params is None:
                warnings.warn(
                    f"RLPoolPolicy: no checkpoint at {self.checkpoint!r}; "
                    "falling back to seeded random (UNTRAINED) weights — "
                    "run `python -m benchmarks.run --only rl` to train and "
                    "publish one",
                    stacklevel=2,
                )
            self.trained = self.params is not None
            if self.params is None:
                self.params = _fallback_params(self.seed)
            else:
                # deploy with the normalization the checkpoint trained under
                self.rate_scale = float(meta.get("rate_scale", self.rate_scale))
                self.fleet_scale = float(
                    meta.get("fleet_scale", self.fleet_scale)
                )
        else:
            self.params = {
                name: {k: np.asarray(v, dtype=np.float64)
                       for k, v in layer.items()}
                for name, layer in self.params.items()
            }
            self.trained = True
        assert set(self.params) == set(_LAYERS), sorted(self.params)
        self._rng = np.random.default_rng(self.seed)

    # -- inference ---------------------------------------------------------
    def logits(self, feats: np.ndarray) -> np.ndarray:
        return policy_logits(self.params, feats)

    def _select(self, logits: np.ndarray) -> np.ndarray:
        if self.greedy:
            return logits.argmax(axis=-1)
        # Gumbel-max: one vectorized categorical draw per arch row
        g = self._rng.gumbel(size=logits.shape)
        return (logits + g).argmax(axis=-1)

    def __call__(self, tick: int, obs: PoolObs) -> PoolAction:
        if tick == 0:
            # episode boundary: a reused policy instance must behave like a
            # fresh one (reproducible runs, trend feature restarts at 0)
            self._rng = np.random.default_rng(self.seed)
            self._prev_rate = None
        if self._prev_rate is None or len(self._prev_rate) != len(obs.keys):
            self._prev_rate = obs.rate.copy()       # trend feature = 0
        feats = pool_features(
            obs, self._prev_rate,
            rate_scale=self.rate_scale, fleet_scale=self.fleet_scale,
        )
        self._prev_rate = obs.rate.copy()
        return procurement_action(obs, self._select(self.logits(feats)))
