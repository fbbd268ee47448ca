"""Finding records + the port's checked-in suppression baseline (the
torch form of ``predictionio_tpu/tools/analyze/findings.py``).

A finding's ``key`` is its identity for suppression purposes: rule id,
file, and a pass-chosen *stable detail token* (a function name, an env
var, a lock pair) — NOT the line number, which drifts with every edit
above it. The baseline maps keys to an accepted-reason string. It is the
port's own, a JSON file inside the package
(``predictionio_tpu_torch/tools/analyze/lint_baseline.json``): the port
runs from a checkout, as its ``csrc/`` does. The contract that keeps
debt from compounding:

- a finding whose key is in the baseline is *suppressed* (counted,
  reported under ``--json``, never failing);
- a NEW finding — any key not in the baseline — fails the lint;
- a baseline entry that no longer matches any finding is itself a
  ``baseline-stale`` finding, so the file shrinks monotonically and
  can't accrete dead exemptions that later hide a regression at the
  same key.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

#: default baseline location, relative to the repo root
BASELINE_REL = os.path.join("predictionio_tpu_torch", "tools", "analyze",
                            "lint_baseline.json")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""
    rule: str       # e.g. "timing-wall-clock"
    path: str       # repo-relative file
    line: int
    message: str
    hint: str = ""  # how to fix (or legitimately suppress) it
    detail: str = ""  # stable token for the baseline key; "" -> line

    @property
    def key(self) -> str:
        tail = self.detail if self.detail else f"L{self.line}"
        return f"{self.rule}::{self.path}::{tail}"

    def as_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "key": self.key}

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class Baseline:
    """The accepted-findings ledger."""

    def __init__(self, entries: Optional[Dict[str, str]] = None,
                 path: Optional[str] = None):
        self.entries = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        entries = {str(e["key"]): str(e.get("reason", ""))
                   for e in raw.get("entries", [])}
        return cls(entries=entries, path=path)

    def apply(self, findings: Iterable[Finding]) -> Tuple[
            List[Finding], List[Finding], List[str]]:
        """Partition into (active, suppressed, stale-baseline-keys)."""
        active: List[Finding] = []
        suppressed: List[Finding] = []
        matched = set()
        for f in findings:
            if f.key in self.entries:
                suppressed.append(f)
                matched.add(f.key)
            else:
                active.append(f)
        stale = sorted(k for k in self.entries if k not in matched)
        return active, suppressed, stale

    def write(self, path: Optional[str] = None,
              findings: Iterable[Finding] = (),
              default_reason: str = "accepted pre-existing finding"
              ) -> str:
        """Persist the given findings as the new baseline (sorted,
        stable — diffs review cleanly). Reasons of keys already present
        are preserved."""
        path = path or self.path
        assert path, "baseline path required"
        entries = []
        for f in sorted(findings, key=lambda f: f.key):
            entries.append({
                "key": f.key,
                "reason": self.entries.get(f.key, default_reason),
                # advisory context for the human diffing the baseline;
                # NOT part of the match (lines drift)
                "site": f"{f.path}:{f.line}",
            })
        payload = {
            "comment": (
                "Accepted pio-lint findings. Every entry here is debt "
                "with a reason; new findings must be fixed or "
                "explicitly added (pio lint --update-baseline), and "
                "entries that stop matching fail the lint as "
                "baseline-stale until removed."),
            "version": 1,
            "entries": entries,
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=False)
            f.write("\n")
        return path


def stale_findings(stale_keys: Iterable[str],
                   baseline_path: str) -> List[Finding]:
    """Stale baseline entries rendered as findings against the baseline
    file itself."""
    rel = baseline_path.replace(os.sep, "/")
    return [Finding(
        rule="baseline-stale", path=rel, line=1,
        message=f"baseline entry no longer matches any finding: {key}",
        hint="delete the entry (the debt it excused is gone) — a stale "
             "key would silently re-suppress a future regression",
        detail=key) for key in stale_keys]
