"""The serving simulator as an RL environment (paper §V, Figure 10).

The agent observes the system state o_i, takes action a_i (a joint
procurement decision: fleet headroom x offload mode), reaches actual
state f_{i+1}, and receives a transition reward blending the paper's
reward policies: cost, response latency (violations), and utilization.

:class:`PoolServingEnv` is the pool-wide form the paper's end state
needs — one controller managing the *whole* heterogeneous pool:

* observations are structure-of-arrays ``[A, OBS_DIM]`` built straight
  from the engine's :class:`~repro_torch.core.sim.PoolObs` (no per-arch dict
  construction anywhere on the rollout path);
* the action is factored per arch — every row picks one of
  ``N_ACTIONS`` (headroom x offload) decisions, so a policy whose
  parameters are applied row-wise controls any pool size;
* the reward is *decomposed per arch* from the engine's per-arch cost
  attribution and violation counts: ``step`` returns an ``[A]`` reward
  vector whose sum is the scalar pool reward, giving PPO per-arch
  credit assignment;
* episodes are driven by ``[A, T]`` arrival matrices — a fixed matrix,
  or a pool of :class:`~repro_torch.core.workloads.Scenario` specs sampled
  per episode (fresh seeded realization each reset) so the controller
  trains across heterogeneous load shapes instead of memorizing one
  trace.

:class:`ServingEnv` is kept as a thin single-arch compatibility wrapper
(A=1, scalar reward, flat observation) — the seed-era interface the
existing tests and examples drive.

Action space per arch (discrete, 4 headrooms x 3 offload modes x 3
variant moves x 3 spot moves = 108):
  headroom in {0.85, 1.0, 1.15, 1.4} — reserved target is
      ceil(headroom x demand / per-instance-throughput), where demand
      includes the queued backlog and the targeted spot fleet's
      capacity offsets it.  Bounded action -> stable credit assignment
      despite the 120 s provisioning lag (the paper's "adjusts its
      policy as long as it is within the desired policy target range").
  offload in {none, blind, slack_aware}
  variant move in {hold, down, up} along the accuracy-ordered set
  spot move in {hold, grow, shrink} — steps the preemptible spot fleet
      (§VI resource heterogeneity); hold-first, so legacy action
      indices decode unchanged
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import PRICING, FleetPricing
from repro_torch.core.rl.obs import (  # noqa: F401  (re-exported seed surface)
    HEADROOMS,
    N_ACTIONS,
    N_PROCURE,
    OBS_DIM,
    OFFLOADS,
    SPOT_MOVES,
    VARIANT_MOVES,
    pool_features,
    procurement_action,
)
from repro_torch.core.sim import ArchLoad, ServingSim, VariantCatalog
from repro_torch.core.workloads import Scenario


@dataclass(frozen=True)
class EnvConfig:
    arch: str = "llama3-8b"
    strict_frac: float = 0.25
    mean_rps: float = 60.0
    duration_s: int = 1200
    violation_penalty: float = 0.005      # $ equivalent per violated request
    accuracy_bonus: float = 0.0           # $ credit per answered request x
                                          # delivered accuracy — what makes
                                          # the variant head trade accuracy
                                          # against cost (0 = cost/SLO only)
    reward_scale: float = 100.0           # keep per-tick rewards O(0.1)
    pricing: FleetPricing = PRICING
    rate_scale: float = 100.0             # normalization constants
    fleet_scale: float = 10.0


class PoolServingEnv:
    """Pool-wide gym-like wrapper over :class:`ServingSim`.

    Three workload sources, in precedence order per ``reset``:

    * an explicit ``arrivals`` matrix passed to ``reset`` (eval runs);
    * ``scenarios`` — a pool of :class:`~repro_torch.core.workloads.Scenario`
      specs; each ``reset()`` samples one and builds a fresh seeded
      ``[A, T]`` realization (sampling driven by ``scenario_seed`` and
      an episode counter: deterministic overall, different every
      episode);
    * the fixed ``arrivals`` the env was constructed with.

    ``step`` takes an ``[A]`` integer action vector and returns
    ``(obs [A, OBS_DIM], reward_arch [A], done, metrics)``; the scalar
    pool reward is ``reward_arch.sum()``.
    """

    def __init__(self, workload: Sequence[ArchLoad], cfg: EnvConfig = EnvConfig(),
                 arrivals: Optional[np.ndarray] = None, *,
                 scenarios: Optional[Sequence[Scenario]] = None,
                 scenario_seed: int = 0,
                 catalog: Optional[VariantCatalog] = None,
                 telemetry=None):
        assert arrivals is not None or scenarios, (
            "PoolServingEnv needs a fixed arrival matrix or a scenario pool"
        )
        self.workload: List[ArchLoad] = list(workload)
        self.n_archs = len(self.workload)
        self.cfg = cfg
        self.catalog = catalog         # opens the variant head's state space
        self.telemetry = telemetry     # rebound to the fresh sim each reset
        self.base_arrivals = arrivals
        self.scenarios = tuple(scenarios) if scenarios else ()
        self._scenario_rng = np.random.default_rng(scenario_seed)
        self._episode = 0
        self.last_scenario: Optional[Scenario] = None
        self.sim: Optional[ServingSim] = None
        self._prev_rate = np.zeros(self.n_archs)
        self._pobs = None

    # ------------------------------------------------------------------
    def _sample_arrivals(self) -> np.ndarray:
        """One episode's arrivals: ``[A, T]`` from a sampled scenario."""
        sc = self.scenarios[self._scenario_rng.integers(len(self.scenarios))]
        self.last_scenario = sc
        self._episode += 1
        return sc.build(
            self.n_archs,
            seed=sc.seed + self._episode,
            duration_s=self.cfg.duration_s,
            mean_rps=self.cfg.mean_rps,
        )

    def reset(self, arrivals: Optional[np.ndarray] = None) -> np.ndarray:
        if arrivals is not None:
            tr = arrivals
        elif self.scenarios:
            tr = self._sample_arrivals()
        else:
            tr = self.base_arrivals
        # per-episode sim seed: tier-internal draws (spot reclaims, the
        # harvest signal) are a pure function of (seed, tick), so a
        # fixed seed would replay the *same* stochastic realization
        # every episode and the policy would overfit to it; scenario
        # training advances the seed with the episode counter (fixed-
        # arrival envs keep seed 0 — eval stays reproducible)
        self.sim = ServingSim(tr, self.workload, pricing=self.cfg.pricing,
                              catalog=self.catalog, seed=self._episode,
                              telemetry=self.telemetry)
        return self._observe(first=True)

    def _observe(self, first: bool = False) -> np.ndarray:
        self._pobs = self.sim.observe_pool()
        if first:
            self._prev_rate = self._pobs.rate.copy()   # trend feature = 0
        feats = pool_features(
            self._pobs, self._prev_rate,
            rate_scale=self.cfg.rate_scale, fleet_scale=self.cfg.fleet_scale,
        )
        self._prev_rate = self._pobs.rate.copy()
        return feats

    # ------------------------------------------------------------------
    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, bool, dict]:
        """Apply per-arch factored actions; rewards decomposed per arch."""
        assert self.sim is not None, "call reset() first"
        metrics = self.sim.apply_pool(procurement_action(self._pobs, actions))
        reward_arch = -self.cfg.reward_scale * (
            metrics["cost_arch"]
            + self.cfg.violation_penalty * metrics["violations_arch"]
            - self.cfg.accuracy_bonus * metrics["accuracy_arch"]
        )
        done = self.sim.done
        obs = (
            np.zeros((self.n_archs, OBS_DIM), dtype=np.float32)
            if done else self._observe()
        )
        return obs, reward_arch, done, metrics

    # ------------------------------------------------------------------
    def episode_result(self):
        return self.sim.res


class ServingEnv:
    """Single-arch compatibility wrapper: the seed-era interface.

    A thin A=1 view over :class:`PoolServingEnv` — flat ``[OBS_DIM]``
    observations, one integer action, scalar reward — preserved so
    stepwise drivers (``train_ppo``, the examples, the seed tests) keep
    working and so the pool refactor stays regression-pinned to the
    pre-refactor episode results.
    """

    def __init__(self, cfg: EnvConfig, trace: Optional[np.ndarray] = None, *,
                 scenarios: Optional[Sequence[Scenario]] = None,
                 scenario_seed: int = 0,
                 catalog: Optional[VariantCatalog] = None,
                 telemetry=None):
        assert trace is not None or scenarios, (
            "ServingEnv needs a fixed trace or a scenario pool"
        )
        self.cfg = cfg
        self.base_trace = trace
        self.pool = PoolServingEnv(
            [ArchLoad(cfg.arch, 1.0, cfg.strict_frac)],
            cfg,
            arrivals=trace,
            scenarios=scenarios,
            scenario_seed=scenario_seed,
            catalog=catalog,
            telemetry=telemetry,
        )

    @property
    def sim(self) -> Optional[ServingSim]:
        return self.pool.sim

    @property
    def scenarios(self):
        return self.pool.scenarios

    @property
    def last_scenario(self) -> Optional[Scenario]:
        return self.pool.last_scenario

    def reset(self, trace: Optional[np.ndarray] = None) -> np.ndarray:
        return self.pool.reset(trace)[0]

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        obs, reward_arch, done, metrics = self.pool.step(
            np.array([action], dtype=np.int64)
        )
        return obs[0], float(reward_arch.sum()), done, metrics

    def episode_result(self):
        return self.pool.episode_result()
