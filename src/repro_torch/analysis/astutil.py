"""Shared AST helpers for the lint passes."""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name / nested Attribute chain, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def string_elts(node: ast.AST) -> List[Tuple[str, int]]:
    """String literals (with line numbers) in a list/tuple/set literal."""
    out: List[Tuple[str, int]] = []
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        for e in node.elts:
            s = const_str(e)
            if s is not None:
                out.append((s, e.lineno))
    return out


def dict_str_keys(node: ast.Dict,
                  resolve: Optional[Dict[str, str]] = None
                  ) -> List[Tuple[str, int]]:
    """String keys of a dict literal; ``resolve`` maps Name keys (e.g.
    ``EV_ARRIVAL``) to their constant values."""
    out: List[Tuple[str, int]] = []
    for k in node.keys:
        if k is None:          # **expansion
            continue
        s = const_str(k)
        if s is None and resolve is not None and isinstance(k, ast.Name):
            s = resolve.get(k.id)
        if s is not None:
            out.append((s, k.lineno))
    return out


def module_str_constants(tree: ast.AST) -> Dict[str, str]:
    """``NAME = "literal"`` assignments at any level of the module."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            val = const_str(node.value)
            if isinstance(tgt, ast.Name) and val is not None:
                out[tgt.id] = val
    return out


def names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def assigned_names(tree: ast.AST, target: str) -> Dict[str, List[ast.AST]]:
    """Collect registry-style names bound to ``target``.

    Returns ``{name: [node, ...]}`` for both forms the codebase uses::

        TARGET = { "name": ..., ... }        # dict-literal keys
        TARGET["name"] = ...                 # later registration
    """
    out: Dict[str, List[ast.AST]] = {}

    def add(name: str, node: ast.AST) -> None:
        out.setdefault(name, []).append(node)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]    # NAME: Dict[...] = {...}
        else:
            continue
        for tgt in targets:
            if (isinstance(tgt, ast.Name) and tgt.id == target
                    and isinstance(node.value, ast.Dict)):
                for k in node.value.keys:
                    s = const_str(k) if k is not None else None
                    if s is not None:
                        add(s, k)      # key node → precise lineno
            elif (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == target):
                s = const_str(tgt.slice)
                if s is not None:
                    add(s, node)
    return out


def func_defs(tree: ast.AST) -> List[ast.AST]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def call_names(fn: ast.AST) -> Set[str]:
    """Bare names called (directly or as ``mod.name``-style tails) inside
    a function body — the edges of the name-level call graph."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d is not None:
                out.add(d)
                out.add(d.split(".")[-1])
            # functions passed by reference (lax.scan(f, ...), vmap(f))
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
    return out


def literal_default(node: Optional[ast.AST]) -> bool:
    """True when a default value is a static Python literal (bool / int /
    float / str / None) — the convention for trace-time-constant
    keyword parameters in jitted scopes."""
    return isinstance(node, ast.Constant)


def is_name_ref(node: ast.AST, names: Set[str]) -> bool:
    """Does ``node``'s expression tree reference any of ``names``?"""
    return bool(names_in(node) & names)


def enclosing_function(mod, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def iter_calls(tree: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node
