"""Built-in lint passes.

Importing this package registers every pass with
:data:`repro_torch.analysis.base.PASS_REGISTRY`; add new passes by dropping a
module here and importing it below (registration order is run order).
"""
from repro_torch.analysis.passes import (  # noqa: F401  (import = registration)
    registry_parity,
    jit_hygiene,
    determinism,
    telemetry_guard,
    soa_aliasing,
)

__all__ = [
    "registry_parity",
    "jit_hygiene",
    "determinism",
    "telemetry_guard",
    "soa_aliasing",
]
