"""Compatibility shim — the simulator now lives in :mod:`repro_torch.core.sim`.

The seed's monolithic ``ServingSim`` was decomposed into composable
subsystems (queues / fleet tiers / accounting / engine); this module
re-exports the public surface so seed-era imports keep working:

    from repro_torch.core.simulator import ServingSim, simulate, Action, ArchObs

New code should import from :mod:`repro_torch.core.sim` directly.
"""
from repro_torch.core.sim import (  # noqa: F401
    Action,
    ArchLoad,
    ArchObs,
    BucketQueue,
    Policy,
    PoolAction,
    PoolObs,
    RELAXED,
    STRICT,
    ServingSim,
    SimResult,
    simulate,
    uniform_pool_workload,
)

# seed-era private name for the scalar queue, kept so old imports of
# ``repro_torch.core.simulator._Queue`` keep resolving
_Queue = BucketQueue
