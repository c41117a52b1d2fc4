"""Core of the invariant linter: findings, passes, the pass registry,
and the analysis context passes share.

The framework is deliberately small: a pass is a callable over an
:class:`AnalysisContext` (every parsed module under the analyzed roots,
plus the repo's ``tests/`` tree for cross-checks) returning
:class:`Finding` records.  Findings carry a *stable key* — independent
of line numbers — so the checked-in baseline file survives unrelated
edits to the flagged file.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence


@dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``key`` identifies the finding independently of line numbers (used
    for baseline matching): ``<pass_id>:<relpath>:<slug>`` where the
    slug names the violated contract at the site (a symbol, registry
    name, or call signature) — re-ordering unrelated code must not
    invalidate a baseline entry.
    """

    pass_id: str
    path: str            # repo-relative path
    line: int
    message: str
    hint: str = ""       # one-line fix suggestion
    slug: str = ""       # stable site identifier within (pass, file)
    col: int = 0

    @property
    def key(self) -> str:
        return f"{self.pass_id}:{self.path}:{self.slug or self.line}"

    def format_text(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: [{self.pass_id}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def format_github(self) -> str:
        # GitHub workflow-command annotation (shows inline on the PR diff)
        msg = self.message.replace("%", "%25").replace("\n", "%0A")
        if self.hint:
            msg += f" (hint: {self.hint})"
        return (f"::error file={self.path},line={self.line},"
                f"col={self.col},"
                f"title=repro_torch.analysis {self.pass_id}::{msg}")


@dataclass
class Module:
    """One parsed source file."""

    path: str            # absolute
    relpath: str         # repo-relative (what findings report)
    source: str
    tree: ast.AST

    _parents: Optional[Dict[ast.AST, ast.AST]] = field(default=None, repr=False)

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        """child node -> parent node map, built lazily once per module."""
        if self._parents is None:
            p: Dict[ast.AST, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        par = self.parents
        cur = par.get(node)
        while cur is not None:
            yield cur
            cur = par.get(cur)


class AnalysisContext:
    """Parsed view of the analyzed tree.

    ``modules`` covers the requested roots (typically ``src/``);
    ``test_modules`` covers the repo's ``tests/`` directory when one
    exists next to the analysis root (passes use it for cross-checks —
    e.g. registry-parity against the parity-test parametrizations) and
    is NOT itself linted.
    """

    def __init__(self, roots: Sequence[str], repo_root: Optional[str] = None):
        self.repo_root = os.path.abspath(repo_root or os.getcwd())
        self.roots = [os.path.abspath(r) for r in roots]
        self.modules: List[Module] = []
        self.test_modules: List[Module] = []
        self.parse_errors: List[Finding] = []
        for root in self.roots:
            for path in _py_files(root):
                m = self._parse(path)
                if m is not None:
                    self.modules.append(m)
        tests_dir = os.path.join(self.repo_root, "tests")
        if os.path.isdir(tests_dir):
            analyzed = {m.path for m in self.modules}
            for path in _py_files(tests_dir):
                if path in analyzed:
                    continue
                m = self._parse(path)
                if m is not None:
                    self.test_modules.append(m)

    def _parse(self, path: str) -> Optional[Module]:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(path, self.repo_root)
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.parse_errors.append(Finding(
                pass_id="parse", path=rel, line=e.lineno or 0,
                message=f"syntax error: {e.msg}", slug="syntax-error",
            ))
            return None
        return Module(path=path, relpath=rel, source=source, tree=tree)

    def find_modules(self, suffix: str) -> List[Module]:
        """Modules whose repo-relative path ends with ``suffix``."""
        suffix = suffix.replace("\\", "/")
        return [m for m in self.modules
                if m.relpath.replace("\\", "/").endswith(suffix)]


def _py_files(root: str) -> List[str]:
    if os.path.isfile(root):
        return [root] if root.endswith(".py") else []
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git", ".ruff_cache")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


# ---------------------------------------------------------------------------
# Pass registry.
# ---------------------------------------------------------------------------
PassFn = Callable[[AnalysisContext], List[Finding]]


@dataclass(frozen=True)
class LintPass:
    id: str
    description: str
    run: PassFn


#: pass id -> LintPass, in registration order (the CLI runs them in order)
PASS_REGISTRY: Dict[str, LintPass] = {}


def register_pass(pass_id: str, description: str):
    """Decorator registering a pass function under ``pass_id``."""

    def deco(fn: PassFn) -> PassFn:
        if pass_id in PASS_REGISTRY:
            raise ValueError(f"duplicate pass id {pass_id!r}")
        PASS_REGISTRY[pass_id] = LintPass(pass_id, description, fn)
        return fn

    return deco


def run_passes(ctx: AnalysisContext,
               select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the selected (default: all) registered passes over ``ctx``."""
    ids = list(select) if select else list(PASS_REGISTRY)
    unknown = [i for i in ids if i not in PASS_REGISTRY]
    if unknown:
        raise KeyError(f"unknown pass id(s): {', '.join(unknown)}; "
                       f"known: {', '.join(PASS_REGISTRY)}")
    findings: List[Finding] = list(ctx.parse_errors)
    for pid in ids:
        findings.extend(PASS_REGISTRY[pid].run(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id, f.slug))
    return findings
