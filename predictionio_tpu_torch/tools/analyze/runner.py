"""``pio lint`` for the port: run every pass over the shared walk, apply
the baseline, render text or JSON (the torch form of
``predictionio_tpu/tools/analyze/runner.py``).

Exit codes: 0 clean (suppressed findings are fine), 1 active findings
(incl. stale baseline entries), 2 internal error (a pass crashed or a
file failed to parse — coverage loss is an error, not a clean run).

The suppression-baseline contract lives in :mod:`findings`; the runner
adds ``--update-baseline`` (accept the CURRENT findings as debt, with
reasons to be edited in the JSON) and ``--list`` (the pass/rule table
README's section on the port's lint mirrors). ``pio lint`` is
``python -m predictionio_tpu_torch.tools.cli lint``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
from typing import List, Optional, Sequence

from predictionio_tpu_torch.tools.analyze.findings import (
    BASELINE_REL, Baseline, Finding, stale_findings,
)
from predictionio_tpu_torch.tools.analyze.walker import discover, repo_root


@dataclasses.dataclass
class LintResult:
    active: List[Finding]
    suppressed: List[Finding]
    stale: List[str]
    modules_analyzed: int
    passes_run: List[str]
    internal_errors: List[str]

    @property
    def exit_code(self) -> int:
        if self.internal_errors:
            return 2
        return 1 if self.active else 0

    def as_dict(self) -> dict:
        return {
            "exit": self.exit_code,
            "modulesAnalyzed": self.modules_analyzed,
            "passes": self.passes_run,
            "findings": [f.as_dict() for f in self.active],
            "suppressed": [f.as_dict() for f in self.suppressed],
            "staleBaselineKeys": list(self.stale),
            "internalErrors": list(self.internal_errors),
            "counts": {
                "findings": len(self.active),
                "suppressed": len(self.suppressed),
                "stale": len(self.stale),
            },
        }

    def render_text(self) -> str:
        lines: List[str] = []
        for f in self.active:
            lines.append(f.render())
        if self.internal_errors:
            for e in self.internal_errors:
                lines.append(f"INTERNAL ERROR: {e}")
        lines.append(
            f"pio lint: {len(self.active)} finding(s), "
            f"{len(self.suppressed)} suppressed by baseline, "
            f"{len(self.stale)} stale baseline entr(ies), "
            f"{self.modules_analyzed} modules analyzed")
        return "\n".join(lines)


def run_lint(root: Optional[str] = None,
             baseline_path: Optional[str] = None) -> LintResult:
    """Walk, run every pass, apply the baseline. Never raises: a
    crashing pass lands in ``internal_errors`` (exit 2)."""
    from predictionio_tpu_torch.tools.analyze.passes import all_passes

    root = root or repo_root()
    baseline_path = baseline_path or os.path.join(root, BASELINE_REL)
    internal: List[str] = []
    try:
        modules = discover(root)
    except Exception as e:       # a broken walk is an internal error
        return LintResult([], [], [], 0, [], [
            f"walker: {type(e).__name__}: {e}"])
    findings: List[Finding] = []
    for mod in modules:
        if mod.parse_error:
            internal.append(f"{mod.rel}: parse error: {mod.parse_error}")
    passes_run: List[str] = []
    for p in all_passes():
        try:
            findings.extend(p.run(modules))
            passes_run.append(p.name)
        except Exception as e:
            internal.append(
                f"pass {p.name}: {type(e).__name__}: {e} "
                f"({traceback.format_exc(limit=2).splitlines()[-1]})")
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    baseline = Baseline.load(baseline_path)
    active, suppressed, stale = baseline.apply(findings)
    rel_baseline = os.path.relpath(baseline_path, root)
    active.extend(stale_findings(stale, rel_baseline))
    return LintResult(active=active, suppressed=suppressed, stale=stale,
                      modules_analyzed=len(modules),
                      passes_run=passes_run, internal_errors=internal)


def _render_pass_table() -> str:
    from predictionio_tpu_torch.tools.analyze.passes import all_passes
    lines = []
    for p in all_passes():
        lines.append(f"{p.name:18} {', '.join(p.rules)}")
        lines.append(f"{'':18}   {p.doc}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pio lint",
        description="static analysis of the PyTorch port: timing, host "
                    "syncs and gathers, lock order, declarations and "
                    "the debug surface")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result on stdout")
    parser.add_argument("--root", default="",
                        help="repo root (default: autodetected)")
    parser.add_argument("--baseline", default="",
                        help=f"suppression baseline (default "
                             f"{BASELINE_REL})")
    parser.add_argument("--update-baseline", action="store_true",
                        help="accept the current findings as the new "
                             "baseline (edit the reasons afterwards)")
    parser.add_argument("--list", action="store_true",
                        help="list passes and rules, run nothing")
    args = parser.parse_args(argv)
    if args.list:
        print(_render_pass_table())
        return 0
    try:
        result = run_lint(root=args.root or None,
                          baseline_path=args.baseline or None)
    except Exception:            # belt and braces: 2, never a traceback-0
        traceback.print_exc()
        return 2
    if args.update_baseline:
        root = args.root or repo_root()
        path = args.baseline or os.path.join(root, BASELINE_REL)
        baseline = Baseline.load(path)
        accepted = [f for f in result.active
                    if f.rule != "baseline-stale"]
        baseline.write(path, findings=accepted + result.suppressed)
        print(f"baseline updated: {path} "
              f"({len(accepted)} new, {len(result.suppressed)} kept)")
        return 0
    if args.json:
        print(json.dumps(result.as_dict(), indent=2))
    else:
        print(result.render_text())
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
