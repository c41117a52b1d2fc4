"""soa-aliasing: PoolObs field arrays must be copied before outliving
the tick.

``ServingSim.observe_pool()`` returns a :class:`PoolObs` whose field
arrays *alias engine-owned scratch buffers* — valid only until the next
``observe_pool()`` call (PR 9 made this explicit; the zero-copy view is
what keeps per-tick RL observation free).  A caller that stows a field
array on ``self`` without ``.copy()`` sees the buffer mutate under it
one tick later — the classic action-delta-is-always-zero bug.

Flagged shape::

    self._prev_rate = obs.rate          # aliases the scratch buffer

Compliant shapes (never flagged)::

    self._prev_rate = obs.rate.copy()   # materialized snapshot
    self._pobs = self.sim.observe_pool()  # whole-obs handle, refreshed
    rate = obs.rate                     # local, dies within the tick

Field names come from the ``PoolObs`` class definition in the analyzed
tree; obs receivers are recognized as variables assigned from an
``observe_pool()`` call in the same function, or names/attributes
containing ``obs`` (the repo-wide naming convention for observation
handles).  The pass is silent when no ``PoolObs`` class is in scope.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.astutil import dotted_name, enclosing_function
from repro_torch.analysis.base import AnalysisContext, Finding, register_pass


def _poolobs_fields(ctx: AnalysisContext) -> Set[str]:
    fields: Set[str] = set()
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == "PoolObs":
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        fields.add(stmt.target.id)
                    elif isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                fields.add(t.id)
    fields.discard("copy")
    return fields


def _obs_locals(fn: Optional[ast.AST]) -> Set[str]:
    """Names bound from an ``observe_pool()`` call within ``fn``."""
    if fn is None:
        return set()
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            d = dotted_name(node.value.func)
            if d is not None and d.split(".")[-1] == "observe_pool":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
                    elif isinstance(tgt, ast.Attribute):
                        out.add(tgt.attr)
    return out


def _is_obs_receiver(base: ast.AST, obs_locals: Set[str]) -> bool:
    d = dotted_name(base)
    if d is None:
        return False
    leaf = d.split(".")[-1]
    if leaf in obs_locals:
        return True
    return "obs" in leaf.lower()


@register_pass(
    "soa-aliasing",
    "PoolObs field arrays stored on self across ticks must be .copy()ed "
    "(observe_pool() returns views of engine-owned scratch buffers)",
)
def run(ctx: AnalysisContext) -> List[Finding]:
    fields = _poolobs_fields(ctx)
    if not fields:
        return []
    findings: List[Finding] = []
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if not (isinstance(value, ast.Attribute)
                    and value.attr in fields):
                continue
            attr_targets = [t for t in node.targets
                            if isinstance(t, ast.Attribute)]
            if not attr_targets:
                continue      # locals die within the tick — fine
            fn = enclosing_function(mod, node)
            if not _is_obs_receiver(value.value, _obs_locals(fn)):
                continue
            for tgt in attr_targets:
                where = fn.name if fn is not None else "<module>"
                findings.append(Finding(
                    pass_id="soa-aliasing", path=mod.relpath,
                    line=node.lineno,
                    slug=f"{where}-{tgt.attr}-aliases-{value.attr}",
                    message=(f"{dotted_name(tgt) or tgt.attr} stores "
                             f"PoolObs.{value.attr} without .copy() — the "
                             "array aliases an engine-owned scratch buffer "
                             "and mutates at the next observe_pool()"),
                    hint=f"store `...{value.attr}.copy()` (PoolObs fields "
                         "are views, valid only until the next tick)",
                ))
    return findings
