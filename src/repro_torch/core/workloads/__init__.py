"""Workload scenario subsystem: heterogeneous per-arch arrival matrices.

The engine's shared-trace path drives every arch with ``share x pool
trace`` — perfectly correlated load.  This package produces, composes,
and replays ``[A, T]`` *arrival matrices* instead, one row per arch, so
scenarios the paper cares about (per-app load diversity, Observation 4's
peak-to-median spread) become first-class:

  generators — seeded matrix generators: ``from_pool_trace`` (the exact
               shared-trace adapter), per-arch ``diurnal`` phase/amplitude
               jitter, ``flash_crowd`` (correlated / anti / solo),
               ``mmpp`` Pareto bursts, ``hotswap`` trending-model shifts
  scenario   — the declarative :class:`Scenario` spec (seeded, dict/JSON
               serializable) and the named :data:`SCENARIO_ZOO` presets

A matrix feeds straight into the engine —
``simulate(scenario.build(len(wl)), wl, policy)`` — which switches to a
streaming per-arch load monitor
(:class:`repro_torch.core.load_monitor.PoolLoadMonitor`) so every arch's
EWMA / window-peak / peak-to-median statistics reflect its own stream.
"""
from repro_torch.core.workloads.generators import (  # noqa: F401
    GENERATORS,
    diurnal,
    flash_crowd,
    from_pool_trace,
    hotswap,
    mmpp,
    pool_trace,
    replay,
    save_replay,
)
from repro_torch.core.workloads.scenario import (  # noqa: F401
    SCENARIO_ZOO,
    Scenario,
    get_scenario,
)
