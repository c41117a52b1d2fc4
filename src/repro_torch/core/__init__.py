"""The paper's contribution: a self-managed ML inference serving system.

Layers:
  hardware         — TPU v5e machine model + fleet pricing (VM/serverless analog)
  profiles         — derived offline-profiling table (latency/accuracy/cost)
  traces           — statistical twins of the four request-arrival traces
  load_monitor     — windowed peak-to-median estimation (Observation 4)
  sim              — trace-driven serving simulation package: vectorized
                     queues, resource tiers (reserved/spot/burst), ledger,
                     and the tick engine (simulator.py is a compat shim)
  workloads        — heterogeneous per-arch arrival matrices: scenario
                     generators (diurnal / flash crowds / MMPP / hotswap)
                     and the declarative seeded Scenario spec
  schedulers       — reactive / util_aware / exascale / mixed / paragon
  model_selection  — naive vs paragon (least-cost under constraints)
  rl               — PPO controller (§V, implemented beyond the paper)
"""
from repro_torch.core.hardware import PRICING, V5E, ChipSpec, FleetPricing  # noqa: F401
from repro_torch.core.load_monitor import LoadMonitor, PoolLoadMonitor  # noqa: F401
from repro_torch.core.model_selection import (  # noqa: F401
    Constraint,
    select_naive,
    select_paragon,
    selection_cost,
)
from repro_torch.core.profiles import (  # noqa: F401
    ModelProfile,
    RequestClass,
    get_profile,
    iso_accuracy_set,
    iso_latency_set,
    model_pool,
)
from repro_torch.core.schedulers import SCHEDULERS, get_scheduler  # noqa: F401
from repro_torch.core.sim import (  # noqa: F401
    Action,
    ArchLoad,
    ArchObs,
    PoolAction,
    PoolObs,
    SimResult,
    Variant,
    VariantCatalog,
    replicate_pool,
    simulate,
    uniform_pool_workload,
)
from repro_torch.core.traces import TRACES, get_trace, peak_to_median, trace_stats  # noqa: F401
from repro_torch.core.workloads import (  # noqa: F401
    SCENARIO_ZOO,
    Scenario,
    from_pool_trace,
    get_scenario,
)
