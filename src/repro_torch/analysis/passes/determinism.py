"""determinism: no global-state or wall-clock randomness in src/.

Resume/replay, the differential tests against the NumPy oracle, and the
torch tick engine's ``(seed, tick)`` lockstep with it all require every
random draw in the port to flow from an explicit seeded generator.
Three families of escape hatch are banned:

1. **module-singleton randomness** — ``np.random.seed`` /
   ``np.random.rand`` / ``np.random.normal`` / ... mutate or read the
   hidden global ``RandomState``; any library call can perturb the
   stream.  ``np.random.default_rng(seed)`` / ``Generator`` /
   ``SeedSequence`` / bit generators are the sanctioned forms.  Torch's
   global generator is the same hazard: ``torch.manual_seed`` /
   ``torch.cuda.manual_seed(_all)`` / ... seed it, and ``torch.rand`` /
   ``torch.randn`` / ... draw from it unless given ``generator=``.  A
   ``torch.Generator`` seeded through its own ``manual_seed`` is the
   sanctioned form; the rule matches full dotted paths from ``torch``,
   so a method on a generator object never matches.
2. **the stdlib ``random`` module** — same global-state problem, plus
   it seeds from the OS by default.
3. **wall-clock seeds** — ``time.time()`` / ``datetime.now()`` (and
   friends) flowing into anything seed-named makes runs unrepeatable
   by construction.  Wall-clock *timing* (``perf_counter`` for a
   duration) is fine and not flagged.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.astutil import dotted_name, enclosing_function
from repro_torch.analysis.base import AnalysisContext, Finding, register_pass

#: np.random attributes that do NOT touch the global RandomState
_NP_RANDOM_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64", "RandomState",
}

#: wall-clock sources that must never feed a seed
_CLOCK_CALLS = {
    "time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}


#: calls that seed torch's global generator
_TORCH_SEED_CALLS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}

#: torch draws that read the global generator unless given ``generator=``
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
}


def _flags_torch_random(call: ast.Call, call_target: str) -> bool:
    if call_target in _TORCH_SEED_CALLS:
        return True
    parts = call_target.split(".")
    if len(parts) != 2 or parts[0] != "torch" or parts[1] not in _TORCH_DRAWS:
        return False
    gen = next((kw.value for kw in call.keywords if kw.arg == "generator"),
               None)
    return gen is None or (isinstance(gen, ast.Constant)
                           and gen.value is None)


def _flags_np_random(call_target: str) -> bool:
    parts = call_target.split(".")
    if len(parts) >= 3 and parts[-3] == "np" and parts[-2] == "random":
        return parts[-1] not in _NP_RANDOM_OK
    if len(parts) >= 3 and parts[-3] == "numpy" and parts[-2] == "random":
        return parts[-1] not in _NP_RANDOM_OK
    return False


def _stdlib_random_alias(mod_tree: ast.AST) -> set:
    """Names under which the stdlib ``random`` module is visible here."""
    out = set()
    for node in ast.walk(mod_tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random":
                    out.add(a.asname or "random")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random" and node.level == 0:
                for a in node.names:
                    out.add(a.asname or a.name)
    return out


def _seed_context(mod, node: ast.AST) -> bool:
    """Is ``node`` (a clock call) flowing into something seed-named?
    Matches ``seed=<...clock...>`` kwargs and ``*seed* = <...clock...>``
    assignments anywhere up the ancestor chain."""
    prev = node
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Call):
            for kw in anc.keywords:
                if kw.arg and "seed" in kw.arg.lower() and _contains(kw.value, prev):
                    return True
        if isinstance(anc, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (anc.targets if isinstance(anc, ast.Assign)
                       else [anc.target])
            for t in targets:
                name = t.id if isinstance(t, ast.Name) else getattr(t, "attr", "")
                if name and "seed" in name.lower():
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
        prev = anc
    return False


def _contains(tree: ast.AST, node: ast.AST) -> bool:
    return any(n is node for n in ast.walk(tree))


@register_pass(
    "determinism",
    "ban global-state np.random.* / torch's global generator / stdlib "
    "random / wall-clock seeds (resume, replay and the engine's "
    "(seed, tick) lockstep depend on explicit seeded generators)",
)
def run(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        random_aliases = _stdlib_random_alias(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Call, ast.Attribute)):
                continue
            target = dotted_name(node.func if isinstance(node, ast.Call)
                                 else node)
            if target is None:
                continue
            fn = enclosing_function(mod, node)
            where = f"{fn.name}-" if fn is not None else ""
            if isinstance(node, ast.Call) and _flags_np_random(target):
                findings.append(Finding(
                    pass_id="determinism", path=mod.relpath, line=node.lineno,
                    slug=f"{where}np-random-{target.split('.')[-1]}",
                    message=(f"{target}() draws from NumPy's global "
                             "RandomState — unseedable from the engine's "
                             "(seed, tick) streams"),
                    hint="thread an np.random.default_rng(seed) Generator "
                         "through instead",
                ))
            elif (isinstance(node, ast.Call)
                  and _flags_torch_random(node, target)):
                findings.append(Finding(
                    pass_id="determinism", path=mod.relpath, line=node.lineno,
                    slug=f"{where}torch-random-{target.split('.')[-1]}",
                    message=(f"{target}() seeds or draws from torch's global "
                             "generator — unseedable from the engine's "
                             "(seed, tick) streams"),
                    hint="thread a torch.Generator(device).manual_seed(seed) "
                         "through as generator= instead",
                ))
            elif (isinstance(node, ast.Call)
                  and target.split(".")[0] in random_aliases
                  and "." in target):
                findings.append(Finding(
                    pass_id="determinism", path=mod.relpath, line=node.lineno,
                    slug=f"{where}stdlib-random-{target.split('.')[-1]}",
                    message=(f"{target}() uses the stdlib random module's "
                             "global state"),
                    hint="use a seeded np.random.default_rng Generator",
                ))
            elif (isinstance(node, ast.Call) and target in _CLOCK_CALLS
                  and _seed_context(mod, node)):
                findings.append(Finding(
                    pass_id="determinism", path=mod.relpath, line=node.lineno,
                    slug=f"{where}clock-seed",
                    message=(f"{target}() feeds a seed — runs become "
                             "unrepeatable by construction"),
                    hint="take the seed as a parameter (callers own "
                         "entropy policy)",
                ))
    # `from random import X` makes bare calls like shuffle() global-state
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.ImportFrom) and node.module == "random"
                    and node.level == 0):
                findings.append(Finding(
                    pass_id="determinism", path=mod.relpath, line=node.lineno,
                    slug="from-random-import",
                    message="`from random import ...` pulls global-state "
                            "randomness into scope",
                    hint="use a seeded np.random.default_rng Generator",
                ))
    return findings
