"""CLI entry point: ``python -m repro_torch.analysis [paths...]``.

Exit status is 0 iff every finding is covered by the baseline file
(``analysis_baseline_torch.txt`` at the repo root by default).  Stale
baseline entries — lines matching no current finding — are warned
about but do not fail the run, so a fix can land before its baseline
line is deleted.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis.base import AnalysisContext, PASS_REGISTRY, run_passes
from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    BaselineError,
    apply_baseline,
    load_baseline,
)

#: the port's own tree: over all of ``src`` the reference package's
#: registries would shadow the port's (registry-parity keeps the first
#: definition of each name it meets)
DEFAULT_PATH = "src/repro_torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant linter for the sim core "
                    "(registry parity, jit hygiene, determinism, "
                    "telemetry guards, PoolObs aliasing).",
    )
    p.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                   help=f"files/directories to analyze (default: "
                        f"{DEFAULT_PATH})")
    p.add_argument("--format", choices=("text", "github"), default="text",
                   help="text (default) or GitHub workflow-command "
                        "annotations for CI")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline file (default: <repo>/{DEFAULT_BASELINE}; "
                        "'none' disables baselining)")
    p.add_argument("--select", action="append", default=None,
                   metavar="PASS", help="run only these pass ids "
                   "(repeatable)")
    p.add_argument("--repo-root", default=None,
                   help="repo root for relative paths and the tests/ "
                        "cross-check tree (default: cwd)")
    p.add_argument("--list", action="store_true", dest="list_passes",
                   help="list registered passes and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_passes:
        width = max(len(p) for p in PASS_REGISTRY)
        for lp in PASS_REGISTRY.values():
            print(f"{lp.id:<{width}}  {lp.description}")
        return 0

    repo_root = os.path.abspath(args.repo_root or os.getcwd())
    paths = args.paths or [DEFAULT_PATH]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"error: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    ctx = AnalysisContext(paths, repo_root=repo_root)
    try:
        findings = run_passes(ctx, select=args.select)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    if args.baseline == "none":
        entries = {}
        baseline_path = None
    else:
        baseline_path = args.baseline or os.path.join(repo_root,
                                                      DEFAULT_BASELINE)
        try:
            entries = load_baseline(baseline_path)
        except BaselineError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    new, baselined, stale = apply_baseline(findings, entries)

    for f in new:
        print(f.format_github() if args.format == "github"
              else f.format_text())
    for e in stale:
        print(f"warning: stale baseline entry "
              f"{baseline_path}:{e.line}: {e.key} "
              f"(matches no current finding — delete it)",
              file=sys.stderr)

    n_mod = len(ctx.modules)
    n_pass = len(args.select) if args.select else len(PASS_REGISTRY)
    summary = (f"{n_mod} modules, {n_pass} passes: "
               f"{len(new)} finding(s)")
    if baselined:
        summary += f", {len(baselined)} baselined"
    if stale:
        summary += f", {len(stale)} stale baseline entr"
        summary += "y" if len(stale) == 1 else "ies"
    print(summary, file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
