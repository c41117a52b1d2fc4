"""Composable serving-simulation package (paper §II-C / §IV methodology).

Subsystems, each its own module, composed by the engine's tick pipeline
``admit -> provision -> serve -> offload -> drop -> account``:

  types       — workload description, latency classes, policy interfaces
                (per-arch dicts and pool-wide structure-of-arrays)
  queues      — age-bucketed class queues, vectorized over the pool
  fleet       — resource tiers: reserved / spot / burst behind one
                interface (a new tier type is one subclass)
  accounting  — the cost / violation / over-provision ledger
  engine      — :class:`ServingSim` (the tick loop) and ``simulate``
  telemetry   — per-tick recorder, structured event log (ledger-
                reconcilable), burn-rate monitors, exporters
  reference   — the seed per-arch loop, kept as the golden oracle

``repro_torch.core.simulator`` re-exports this surface, so seed-era imports
keep working unchanged.
"""
from repro_torch.core.sim.accounting import (  # noqa: F401
    SUMMARY_KEY_DOCS,
    Ledger,
    SimResult,
)
from repro_torch.core.sim.engine import ArchView, ServingSim, simulate  # noqa: F401
from repro_torch.core.sim.fleet import (  # noqa: F401
    BurstTier,
    HarvestVMTier,
    MultiRegionReservedTier,
    ProvisionPipeline,
    ResourceTier,
    SpotTier,
    SwapPipeline,
)
from repro_torch.core.sim.queues import BucketQueue, QueueArray  # noqa: F401
from repro_torch.core.sim.reference import ReferenceSim, simulate_reference  # noqa: F401
from repro_torch.core.sim.telemetry import (  # noqa: F401
    EVENT_TYPES,
    Incident,
    MonitorConfig,
    Telemetry,
    TimeSeriesRecorder,
    detect_incidents,
    incidents_table,
    reconcile_events,
)
from repro_torch.core.sim.types import (  # noqa: F401
    CLASSES,
    OFFLOAD_BLIND,
    OFFLOAD_MODES,
    OFFLOAD_NONE,
    OFFLOAD_SLACK_AWARE,
    RELAXED,
    STRICT,
    Action,
    ArchLoad,
    ArchObs,
    Policy,
    PoolAction,
    PoolObs,
    TelemetryEvent,
    Variant,
    VariantCatalog,
    VectorPolicy,
    filter_pool_candidates,
    replicate_pool,
    shares,
    uniform_pool_workload,
)
