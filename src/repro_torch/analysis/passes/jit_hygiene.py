"""jit-hygiene: no host syncs or Python control flow in traced scopes.

The torch tick engine applies one ``TorchPolicy`` per tick to tensors
that live on the card, batched across the grid; a single host sync
(`.item()`, `.cpu()`, `float(...)`, `np.*` on a device tensor) inside
that path stalls the tick for a device→host round trip, and a Python
`if` on a tensor is such a sync too (and, under ``torch.compile`` or a
JAX trace, a graph break or a ``TracerBoolConversionError``).  The
reference's JAX roots stay, so the same code is held to the same rules
in either package.

Scope discovery is a name-level call graph seeded from jit roots:

* functions decorated ``@jax.jit`` / ``@partial(jax.jit, ...)``;
* function names passed to ``jax.jit`` / ``vmap`` / ``pmap`` /
  ``lax.scan`` / ``lax.cond`` / ``lax.switch`` / ``lax.while_loop`` /
  ``lax.fori_loop`` / ``lax.associative_scan``;
* the apply function of every ``TorchPolicy(...)`` registration (the
  per-tick policy path of the torch tick engine).

Reachability resolves *bare-name* calls and by-reference args only, and
only against the calling module's own defs plus its explicit
``from X import name`` imports — method calls (``st.add_arrivals(...)``)
are not followed (a name-level graph following attribute tails pulls in
every same-named method in the repo; the runtime differential fuzz
covers those edges instead).

Within a reachable function, *traced* names are the parameters without
defaults (minus ``static_argnames`` / ``self``) plus anything assigned
from them; parameters with defaults (``xp=np``, ``variants=False``) are
trace-time constants by repo convention.  ``.shape`` / ``.ndim`` /
``.dtype`` / ``.size`` reads and ``is (not)`` comparisons are static
and never flagged.

A third family: *unhashable static args* — a dict/list/set (literal or
comprehension) passed in a ``static_argnames`` position recompiles on
every call at best and raises ``TypeError: unhashable`` at first use.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import dotted_name, names_in, string_elts
from repro_torch.analysis.base import AnalysisContext, Finding, Module, register_pass

#: jax combinators whose function-valued args enter traced scope
_TRACING_TAILS = {
    "jit", "vmap", "pmap", "scan", "associative_scan",
    "cond", "switch", "while_loop", "fori_loop", "checkpoint", "remat",
}
#: attribute reads that are static at trace time
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "aval"}
#: builtins that force a concrete value (host sync) on a traced array
_SYNC_BUILTINS = {"float", "int", "bool", "len"}
#: methods that force a device→host copy (``cpu`` / ``numpy`` are
#: torch's spellings)
_SYNC_METHODS = {"item", "tolist", "__array__", "cpu", "numpy"}

_UNHASHABLE = (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
               ast.SetComp)


def _is_jax_combinator(func: ast.AST) -> Optional[str]:
    d = dotted_name(func)
    if d is None:
        return None
    tail = d.split(".")[-1]
    if tail not in _TRACING_TAILS:
        return None
    head = d.split(".")[0]
    if head in ("jax", "lax") or ".lax." in d or d == tail == "jit":
        return tail
    return None


def _static_argnames(call: ast.Call) -> Set[str]:
    out: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            if isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, str):
                out.add(kw.value.value)
            out.update(s for s, _ in string_elts(kw.value))
    return out


class _Root:
    __slots__ = ("name", "statics")

    def __init__(self, name: str, statics: Set[str]):
        self.name = name
        self.statics = statics


def _collect_roots(mod: Module) -> List[_Root]:
    roots: List[_Root] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dotted_name(dec)
                if d is not None and d.split(".")[-1] == "jit" and (
                        d in ("jit", "jax.jit") or d.endswith(".jit")):
                    roots.append(_Root(node.name, set()))
                elif (isinstance(dec, ast.Call)
                        and dotted_name(dec.func) in ("partial",
                                                      "functools.partial")
                        and dec.args
                        and _is_jax_combinator(dec.args[0]) == "jit"):
                    roots.append(_Root(node.name, _static_argnames(dec)))
        elif isinstance(node, ast.Call):
            tail = _is_jax_combinator(node.func)
            if tail is not None:
                statics = _static_argnames(node) if tail == "jit" else set()
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        roots.append(_Root(arg.id, statics))
            elif (dotted_name(node.func) or "").split(".")[-1] == "TorchPolicy":
                if node.args and isinstance(node.args[0], ast.Name):
                    roots.append(_Root(node.args[0].id, set()))
    return roots


def _module_dotted(mod: Module) -> Tuple[str, ...]:
    """Package path of the module, e.g. ``('repro_torch', 'core', 'sim')``
    for ``src/repro_torch/core/sim/torch_engine.py``."""
    rel = mod.relpath.replace("\\", "/")
    parts = [p for p in rel.split("/") if p]
    if parts and parts[0] in ("src", "lib"):
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        return tuple(parts[:-1])       # package itself
    return tuple(parts[:-1])           # enclosing package


def _import_map(mod: Module) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """local name -> (source module path parts, original name) for every
    ``from X import y [as z]`` in the module."""
    pkg = _module_dotted(mod)
    out: Dict[str, Tuple[Tuple[str, ...], str]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 \
                else pkg
        else:
            base = ()
        target = base + tuple((node.module or "").split("."))
        target = tuple(p for p in target if p)
        for a in node.names:
            if a.name != "*":
                out[a.asname or a.name] = (target, a.name)
    return out


class _Index:
    """Per-module function defs + module lookup by dotted path."""

    def __init__(self, ctx: AnalysisContext):
        self.defs: Dict[str, Dict[str, List[ast.AST]]] = {}
        self.by_dotted: Dict[Tuple[str, ...], Module] = {}
        self.imports: Dict[str, Dict[str, Tuple[Tuple[str, ...], str]]] = {}
        for mod in ctx.modules:
            local: Dict[str, List[ast.AST]] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local.setdefault(node.name, []).append(node)
            self.defs[mod.relpath] = local
            self.imports[mod.relpath] = _import_map(mod)
            rel = mod.relpath.replace("\\", "/")
            parts = [p for p in rel.split("/") if p]
            if parts and parts[0] in ("src", "lib"):
                parts = parts[1:]
            if parts and parts[-1].endswith(".py"):
                parts[-1] = parts[-1][:-3]
            if parts and parts[-1] == "__init__":
                parts = parts[:-1]
            self.by_dotted[tuple(parts)] = mod

    def resolve(self, mod: Module, name: str):
        """(module, [fndefs]) the bare name refers to, or None."""
        local = self.defs[mod.relpath].get(name)
        if local:
            return mod, local
        imp = self.imports[mod.relpath].get(name)
        if imp is not None:
            target_mod = self.by_dotted.get(imp[0])
            if target_mod is not None:
                defs = self.defs[target_mod.relpath].get(imp[1])
                if defs:
                    return target_mod, defs
        return None


def _called_names(fn: ast.AST) -> Set[str]:
    """Bare names called or passed by reference inside ``fn`` — method
    calls are deliberately NOT followed (see module docstring)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                out.add(node.func.id)
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
            for kw in node.keywords:
                if isinstance(kw.value, ast.Name):
                    out.add(kw.value.id)
    return out


def _reachable(ctx: AnalysisContext):
    """jit-reachable ``(relpath, lineno) -> (module, fndef, statics)``."""
    idx = _Index(ctx)
    pending: List[Tuple[Module, _Root]] = []
    for mod in ctx.modules:
        for root in _collect_roots(mod):
            pending.append((mod, root))
    seen: Dict[Tuple[str, int], Tuple[Module, ast.AST, Set[str]]] = {}
    while pending:
        from_mod, root = pending.pop()
        resolved = idx.resolve(from_mod, root.name)
        if resolved is None:
            continue
        def_mod, fns = resolved
        for fn in fns:
            key = (def_mod.relpath, fn.lineno)
            if key in seen:
                seen[key][2].update(root.statics)
                continue
            seen[key] = (def_mod, fn, set(root.statics))
            for callee in _called_names(fn):
                if callee != root.name:
                    pending.append((def_mod, _Root(callee, set())))
    return seen


#: annotations marking a parameter as a trace-time constant — a Python
#: bool/str can never be a traced array (weak-typed flags are annotated
#: as arrays in this repo)
_STATIC_ANNOTATIONS = {"bool", "str"}


def _annotated_static(param: ast.arg) -> bool:
    ann = param.annotation
    if isinstance(ann, ast.Name):
        return ann.id in _STATIC_ANNOTATIONS
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in _STATIC_ANNOTATIONS
    return False


def _traced_names(fn: ast.AST, statics: Set[str]) -> Set[str]:
    a = fn.args
    positional = list(a.posonlyargs) + list(a.args)
    n_defaults = len(a.defaults)
    required = positional[:len(positional) - n_defaults]
    traced = ({p.arg for p in required if not _annotated_static(p)}
              - statics - {"self", "cls"})
    # forward-propagate through assignments until fixpoint
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _refs_traced(node.value,
                                                            traced):
                for tgt in node.targets:
                    for name in names_in(tgt):
                        if name not in traced:
                            traced.add(name)
                            changed = True
    return traced


def _refs_traced(node: ast.AST, traced: Set[str]) -> bool:
    """Does the expression read a traced *value* (static .shape/.dtype
    reads don't count)?"""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in traced
    if isinstance(node, ast.Call):
        d = dotted_name(node.func)
        if d is not None and d.split(".")[-1] in ("len", "isinstance"):
            return False
    return any(_refs_traced(c, traced) for c in ast.iter_child_nodes(node))


def _static_compare(test: ast.AST) -> bool:
    """`x is None` / `xp is np` style checks are trace-time static."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.Call):
        d = dotted_name(test.func)
        return d is not None and d.split(".")[-1] in ("isinstance",
                                                      "callable",
                                                      "hasattr")
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _static_compare(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_static_compare(v) for v in test.values)
    return False


def _check_function(mod: Module, fn: ast.AST, statics: Set[str],
                    findings: List[Finding]) -> None:
    traced = _traced_names(fn, statics)
    if not traced:
        return

    def emit(node, slug, message, hint):
        findings.append(Finding(
            pass_id="jit-hygiene", path=mod.relpath, line=node.lineno,
            slug=f"{fn.name}-{slug}", message=message, hint=hint,
        ))

    for node in ast.walk(fn):
        # don't descend into nested defs twice — they're analyzed as
        # their own reachable functions with their own param sets
        if isinstance(node, ast.Call):
            func = node.func
            d = dotted_name(func)
            if (isinstance(func, ast.Attribute)
                    and func.attr in _SYNC_METHODS
                    and _refs_traced(func.value, traced)):
                emit(node, f"host-sync-{func.attr}",
                     f"`.{func.attr}()` on a traced array forces a "
                     "device→host sync inside the jitted scope",
                     "keep the value on-device (torch / jnp ops) or move the "
                     "read outside the jitted scope")
            elif (d in _SYNC_BUILTINS and d != "len" and node.args
                    and _refs_traced(node.args[0], traced)):
                emit(node, f"host-sync-{d}",
                     f"`{d}(...)` on a traced value concretizes it — "
                     "host sync / TracerConversionError inside jit",
                     f"use tensor casts (`.to(dtype)` / `.astype`) instead "
                     f"of `{d}()`")
            elif (d is not None
                    and d.split(".")[0] in ("np", "numpy", "onp")
                    and len(d.split(".")) > 1
                    and any(_refs_traced(a, traced) for a in node.args)):
                emit(node, f"np-on-traced-{d.split('.')[-1]}",
                     f"`{d}(...)` applies host NumPy to a traced array — "
                     "silent device→host copy (and breaks grad/vmap)",
                     "use the torch / jnp / xp backend equivalent")
        elif isinstance(node, (ast.If, ast.While)):
            if (_refs_traced(node.test, traced)
                    and not _static_compare(node.test)):
                kw = "while" if isinstance(node, ast.While) else "if"
                emit(node, f"python-{kw}-on-traced",
                     f"Python `{kw}` on a traced array — "
                     "TracerBoolConversionError at trace time",
                     "restructure with torch.where / jnp.where / lax.cond")
        elif isinstance(node, ast.IfExp):
            if (_refs_traced(node.test, traced)
                    and not _static_compare(node.test)):
                emit(node, "python-ifexp-on-traced",
                     "conditional expression on a traced array — "
                     "TracerBoolConversionError at trace time",
                     "use torch.where(cond, a, b) / jnp.where(cond, a, b)")
        elif isinstance(node, ast.Assert):
            if _refs_traced(node.test, traced):
                emit(node, "assert-on-traced",
                     "assert on a traced array inside jit",
                     "use checkify or move the check outside the "
                     "jitted scope")


def _check_unhashable_statics(ctx: AnalysisContext,
                              findings: List[Finding]) -> None:
    # map jitted function name -> (static names, static positions)
    jitted: Dict[str, Tuple[Set[str], Dict[str, int]]] = {}
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                statics: Set[str] = set()
                for dec in node.decorator_list:
                    if (isinstance(dec, ast.Call)
                            and dotted_name(dec.func) in (
                                "partial", "functools.partial")
                            and dec.args
                            and _is_jax_combinator(dec.args[0]) == "jit"):
                        statics |= _static_argnames(dec)
                if statics:
                    pos = {p.arg: i for i, p in enumerate(node.args.args)}
                    jitted[node.name] = (statics, pos)
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in jitted):
                continue
            statics, pos = jitted[node.func.id]
            bad: List[Tuple[str, ast.AST]] = []
            for kw in node.keywords:
                if kw.arg in statics and isinstance(kw.value, _UNHASHABLE):
                    bad.append((kw.arg, kw.value))
            for name in statics:
                i = pos.get(name)
                if (i is not None and i < len(node.args)
                        and isinstance(node.args[i], _UNHASHABLE)):
                    bad.append((name, node.args[i]))
            for name, val in bad:
                findings.append(Finding(
                    pass_id="jit-hygiene", path=mod.relpath,
                    line=val.lineno,
                    slug=f"unhashable-static-{node.func.id}-{name}",
                    message=(f"unhashable {type(val).__name__.lower()} "
                             f"passed for static arg {name!r} of jitted "
                             f"{node.func.id}() — TypeError at the jit "
                             "cache lookup"),
                    hint="pass a hashable (tuple / frozen dataclass) or "
                         "drop it from static_argnames",
                ))


@register_pass(
    "jit-hygiene",
    "no host syncs (.item()/float()/np.* on traced), Python branches on "
    "traced arrays, or unhashable static args in jit/scan/vmap-reachable "
    "scopes",
)
def run(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for _key, (mod, fn, statics) in sorted(_reachable(ctx).items()):
        _check_function(mod, fn, statics, findings)
    _check_unhashable_statics(ctx, findings)
    return findings
