"""telemetry-guard: the zero-cost-when-absent observability contract.

PR 7's telemetry subsystem is only zero-cost because every emission
site in the engine and the tiers is gated on ``<telemetry> is not
None`` (the disabled path is pinned bit-identical to the pre-telemetry
engine by goldens and a throughput ratchet).  Three contracts, all
mechanical:

1. **guarded emission sites** — every call on a telemetry receiver
   (``tel`` / ``telemetry`` / ``*.telemetry``) to an emitting method
   (``on_*`` / ``emit*`` / ``counter`` / ``end_tick`` / ``bind``) must
   sit under an ``is not None`` check of that same receiver (directly,
   via an ``and``-conjunct, on the non-None side of an if/else, or
   behind an early ``if <recv> is None: return``).  The module that
   *defines* ``class Telemetry`` is exempt (its internals gate on
   ``events_on`` / ``record_on`` instead).
2. **event-type vocabulary** — every ``EV_*`` constant and every string
   literal passed as an etype to ``emit`` / ``emit_flow`` /
   ``on_reclaim`` must be a key of ``EVENT_TYPES`` (docs/TELEMETRY.md
   is generated from it; the reconciliation scatter dispatches on it).
3. **summary-key docs** — every key ``SimResult.summary()`` can produce
   must appear in ``SUMMARY_KEY_DOCS`` (dynamic ``f"cost_{t}"`` keys
   match a ``cost_<tier>``-style documented placeholder).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    const_str,
    dict_str_keys,
    dotted_name,
    enclosing_function,
    module_str_constants,
)
from repro_torch.analysis.base import AnalysisContext, Finding, Module, register_pass

_EMIT_METHODS = ("emit", "emit_flow", "counter", "end_tick", "bind")
#: emit/emit_flow/on_reclaim positional index of the etype argument
_ETYPE_ARG = {"emit": 1, "emit_flow": 1, "on_reclaim": 1}


def _telemetry_receiver(call: ast.Call) -> Optional[Tuple[str, str]]:
    """``(receiver_text, method)`` when the call emits telemetry."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    method = func.attr
    if not (method.startswith("on_") or method in _EMIT_METHODS):
        return None
    recv = dotted_name(func.value)
    if recv is None:
        return None
    if recv in ("tel", "telemetry") or recv.endswith(".telemetry"):
        return recv, method
    return None


def _test_guards(test: ast.AST, recv: str, *, non_none: bool) -> bool:
    """Does ``test`` establish ``recv is (not) None``?"""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_test_guards(v, recv, non_none=non_none)
                   for v in test.values)
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None):
        want = ast.IsNot if non_none else ast.Is
        if isinstance(test.ops[0], want):
            return dotted_name(test.left) == recv
    return False


def _in_subtree(roots: List[ast.stmt], node: ast.AST) -> bool:
    return any(node is n for r in roots for n in ast.walk(r))


def _is_guarded(mod: Module, call: ast.Call, recv: str) -> bool:
    # (a) an ancestor `if` guards the receiver on the side we're on
    for anc in mod.ancestors(call):
        if isinstance(anc, ast.If):
            if (_in_subtree(anc.body, call)
                    and _test_guards(anc.test, recv, non_none=True)):
                return True
            if (_in_subtree(anc.orelse, call)
                    and _test_guards(anc.test, recv, non_none=False)):
                return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = anc
            break
    else:
        return False
    # (b) an earlier top-level `if recv is None: return` in the function
    for stmt in fn.body:
        if _in_subtree([stmt], call):
            break
        if (isinstance(stmt, ast.If)
                and _test_guards(stmt.test, recv, non_none=False)
                and stmt.body
                and isinstance(stmt.body[-1], (ast.Return, ast.Raise,
                                               ast.Continue))):
            return True
    return False


def _defines_class(mod: Module, name: str) -> bool:
    return any(isinstance(n, ast.ClassDef) and n.name == name
               for n in ast.walk(mod.tree))


# ---------------------------------------------------------------------------
# Event vocabulary helpers.
# ---------------------------------------------------------------------------
def _event_types(ctx: AnalysisContext):
    """(module, {etype: line}, {const_name: value}) for the module
    defining EVENT_TYPES, or (None, {}, {})."""
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "EVENT_TYPES"
                    and isinstance(node.value, ast.Dict)):
                consts = module_str_constants(mod.tree)
                keys = dict(
                    (k, ln)
                    for k, ln in dict_str_keys(node.value, resolve=consts))
                return mod, keys, consts
    return None, {}, {}


def _summary_keys(fn: ast.AST) -> List[Tuple[str, int, bool]]:
    """``(key, line, is_dynamic)`` for every key ``summary()`` produces."""
    out: List[Tuple[str, int, bool]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is None:
                    continue
                s = const_str(k)
                if s is not None:
                    out.append((s, k.lineno, False))
                elif isinstance(k, ast.JoinedStr):
                    prefix = ""
                    for part in k.values:
                        if isinstance(part, ast.Constant):
                            prefix += str(part.value)
                        else:
                            break
                    out.append((prefix, k.lineno, True))
        elif (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)):
            s = const_str(node.targets[0].slice)
            if s is not None:
                out.append((s, node.lineno, False))
    return out


@register_pass(
    "telemetry-guard",
    "every telemetry emission is `is not None`-guarded, every etype is "
    "in EVENT_TYPES, every summary() key is in SUMMARY_KEY_DOCS",
)
def run(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []

    # -- 1. guarded emission sites --------------------------------------
    for mod in ctx.modules:
        if _defines_class(mod, "Telemetry"):
            continue             # the hook's own internals are exempt
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            rm = _telemetry_receiver(node)
            if rm is None:
                continue
            recv, method = rm
            if not _is_guarded(mod, node, recv):
                fn = enclosing_function(mod, node)
                where = fn.name if fn is not None else "<module>"
                findings.append(Finding(
                    pass_id="telemetry-guard", path=mod.relpath,
                    line=node.lineno,
                    slug=f"unguarded-{where}-{method}",
                    message=(f"telemetry emission {recv}.{method}(...) is "
                             f"not behind an `if {recv} is not None` guard "
                             "— breaks the zero-cost-when-disabled "
                             "contract (and crashes telemetry-less runs)"),
                    hint=f"wrap in `if {recv} is not None:`",
                ))

    # -- 2. event-type vocabulary ---------------------------------------
    ev_mod, event_types, consts = _event_types(ctx)
    if ev_mod is not None:
        # every EV_* constant in the defining module must be a key
        for name, value in sorted(consts.items()):
            if name.startswith("EV_") and value not in event_types:
                findings.append(Finding(
                    pass_id="telemetry-guard", path=ev_mod.relpath,
                    line=1, slug=f"etype-const-{name}-undocumented",
                    message=(f"{name} = {value!r} is not a key of "
                             "EVENT_TYPES — the event would dodge the "
                             "docs and the reconciliation vocabulary"),
                    hint=f"add {value!r} to EVENT_TYPES with a one-line "
                         "magnitude-semantics doc",
                ))
        for mod in ctx.modules:
            local_consts = module_str_constants(mod.tree)
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                idx = _ETYPE_ARG.get(node.func.attr)
                if idx is None or len(node.args) <= idx:
                    continue
                arg = node.args[idx]
                etype = const_str(arg)
                if etype is None and isinstance(arg, ast.Name):
                    etype = local_consts.get(arg.id, consts.get(arg.id))
                if etype is not None and etype not in event_types:
                    findings.append(Finding(
                        pass_id="telemetry-guard", path=mod.relpath,
                        line=node.lineno,
                        slug=f"etype-{etype}-unknown",
                        message=(f"emitted event type {etype!r} is not in "
                                 "EVENT_TYPES"),
                        hint="add it to EVENT_TYPES (and the "
                             "reconciliation scatter) or fix the typo",
                    ))

    # -- 3. summary keys are documented ---------------------------------
    for mod in ctx.modules:
        docs: Optional[Set[str]] = None
        docs_node = None
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "SUMMARY_KEY_DOCS"
                    and isinstance(node.value, ast.Dict)):
                docs = {k for k, _ in dict_str_keys(node.value)}
                docs_node = node
        if docs is None:
            continue
        placeholder_prefixes = [d.split("<", 1)[0] for d in docs if "<" in d]
        for node in ast.walk(mod.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == "summary"):
                for key, line, dynamic in _summary_keys(node):
                    if dynamic:
                        ok = any(key.startswith(p) or p.startswith(key)
                                 for p in placeholder_prefixes)
                    else:
                        ok = key in docs
                    if not ok:
                        findings.append(Finding(
                            pass_id="telemetry-guard", path=mod.relpath,
                            line=line, slug=f"summary-key-{key}-undocumented",
                            message=(f"summary() produces key "
                                     f"{key + ('…' if dynamic else '')!r} "
                                     "absent from SUMMARY_KEY_DOCS"),
                            hint=("document it in SUMMARY_KEY_DOCS at line "
                                  f"{docs_node.lineno} (docs/TELEMETRY.md "
                                  "is generated against it)"),
                        ))
    return findings
