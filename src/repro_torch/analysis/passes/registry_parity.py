"""registry-parity: the three scheduler/policy registries stay twinned.

The sim core keeps THREE registries of procurement policies that must
stay in lockstep (ROADMAP "Architecture" sections; the runtime parity
tests fuzz the pairs to 1e-6, this pass catches a missing twin before
any simulation runs):

* ``SCHEDULERS`` — legacy per-arch dict policies (the semantic spec);
* ``VECTOR_SCHEDULERS`` — structure-of-arrays twins the engine's hot
  loop and every benchmark grid dispatch;
* ``TORCH_POLICIES`` — in-tick twins the torch tick engine applies on
  the card (the port's counterpart of the reference's ``JAX_POLICIES``).

Contracts enforced statically:

1. every ``VECTOR_SCHEDULERS`` name has a dict-form ``SCHEDULERS`` twin
   (the dict form is the oracle the parity tests compare against);
2. every ``TORCH_POLICIES`` name has a ``VECTOR_SCHEDULERS`` twin (the
   in-tick twin is pinned to the host vector form by the engine's
   differential tests);
3. every policy name a test parametrizes over
   (``@pytest.mark.parametrize(..., ["reactive", ...])``) still exists
   in some registry — a renamed/removed policy must take its test
   parametrizations with it, otherwise the parity coverage silently
   shrinks to the surviving names.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.astutil import assigned_names
from repro_torch.analysis.base import AnalysisContext, Finding, register_pass

REGISTRY_NAMES = ("SCHEDULERS", "VECTOR_SCHEDULERS", "TORCH_POLICIES")

#: parametrize argument names that carry policy/scheduler names
_POLICY_ARGNAMES = ("policy", "scheduler", "policy_name", "scheme")


def _collect_registries(ctx: AnalysisContext):
    """``registry -> {name: (relpath, lineno)}`` over the analyzed tree."""
    out: Dict[str, Dict[str, tuple]] = {r: {} for r in REGISTRY_NAMES}
    for mod in ctx.modules:
        for reg in REGISTRY_NAMES:
            for name, nodes in assigned_names(mod.tree, reg).items():
                out[reg].setdefault(name, (mod.relpath, nodes[0].lineno))
    return out


def _parametrized_policy_names(ctx: AnalysisContext) -> List[tuple]:
    """(name, relpath, lineno) for every string a policy-parametrized
    test enumerates."""
    out: List[tuple] = []
    for mod in ctx.test_modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "parametrize"
                    and node.args):
                continue
            argnames = node.args[0]
            if not (isinstance(argnames, ast.Constant)
                    and isinstance(argnames.value, str)
                    and argnames.value in _POLICY_ARGNAMES):
                continue
            if len(node.args) < 2:
                continue
            values = node.args[1]
            if isinstance(values, (ast.List, ast.Tuple)):
                for e in values.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        out.append((e.value, mod.relpath, e.lineno))
            # computed parametrizations (sorted(set(A) & set(B))) are
            # evaluated at collection time and cannot go stale — skip
    return out


@register_pass(
    "registry-parity",
    "every VECTOR_SCHEDULERS name has a SCHEDULERS dict twin, every "
    "TORCH_POLICIES name has a vector twin, and test parametrizations "
    "only name registered policies",
)
def run(ctx: AnalysisContext) -> List[Finding]:
    regs = _collect_registries(ctx)
    findings: List[Finding] = []
    sched, vec, torchp = (regs[r] for r in REGISTRY_NAMES)
    if not (sched or vec or torchp):
        return findings          # tree doesn't define the registries

    for name, (path, line) in sorted(vec.items()):
        if sched and name not in sched:
            findings.append(Finding(
                pass_id="registry-parity", path=path, line=line,
                slug=f"vector-{name}-missing-dict-twin",
                message=(f"VECTOR_SCHEDULERS[{name!r}] has no dict-form "
                         f"SCHEDULERS twin — the dict form is the oracle "
                         f"the dict/vector parity test compares against"),
                hint=(f"add SCHEDULERS[{name!r}] (or baseline this if the "
                      "policy is natively vectorized)"),
            ))
    for name, (path, line) in sorted(torchp.items()):
        if vec and name not in vec:
            findings.append(Finding(
                pass_id="registry-parity", path=path, line=line,
                slug=f"torch-{name}-missing-vector-twin",
                message=(f"TORCH_POLICIES[{name!r}] has no VECTOR_SCHEDULERS "
                         f"twin — the in-scan policy is pinned to its host "
                         f"vector form by the differential fuzz"),
                hint=(f"register a vectorized twin as "
                      f"VECTOR_SCHEDULERS[{name!r}] (or baseline a "
                      "deliberate scan-only deployment mode)"),
            ))

    known: Set[str] = set(sched) | set(vec) | set(torchp)
    if known:
        for name, path, line in _parametrized_policy_names(ctx):
            if name not in known:
                findings.append(Finding(
                    pass_id="registry-parity", path=path, line=line,
                    slug=f"test-param-{name}-unregistered",
                    message=(f"test parametrizes policy {name!r} which is "
                             f"in none of {', '.join(REGISTRY_NAMES)} — "
                             "stale parity coverage"),
                    hint="rename/remove the parametrization entry",
                ))
    return findings
