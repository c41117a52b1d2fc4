"""repro_torch.analysis — the invariant linter for the port's tree.

The twin of ``repro.analysis``: the same AST-based analyzer and the same
five passes (registry twinning, jit-scope hygiene, seeded determinism,
telemetry guarding and PoolObs aliasing discipline), reading the port's
names.  What it reads differently:

* registry-parity twins ``TORCH_POLICIES`` (the torch tick engine's
  in-tick registry) in place of ``JAX_POLICIES``;
* jit-hygiene also roots at every ``TorchPolicy(...)`` apply function
  (the per-tick policy path) and counts ``.cpu()`` / ``.numpy()`` as
  host syncs;
* determinism also bans torch's global generator (seeding it, or
  ``torch.rand``-style draws without ``generator=``).

Run it as::

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch

against the baseline ``analysis_baseline_torch.txt``.
docs/STATIC_ANALYSIS.md describes the passes and the baseline policy.
"""
from repro_torch.analysis.base import (
    AnalysisContext,
    Finding,
    LintPass,
    Module,
    PASS_REGISTRY,
    register_pass,
    run_passes,
)
from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    BaselineEntry,
    BaselineError,
    apply_baseline,
    load_baseline,
)
import repro_torch.analysis.passes  # noqa: F401  (import = pass registration)

__all__ = [
    "AnalysisContext",
    "Finding",
    "LintPass",
    "Module",
    "PASS_REGISTRY",
    "register_pass",
    "run_passes",
    "DEFAULT_BASELINE",
    "BaselineEntry",
    "BaselineError",
    "apply_baseline",
    "load_baseline",
]
