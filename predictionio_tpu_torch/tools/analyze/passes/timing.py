"""Timing honesty, port-wide (the torch form of
``predictionio_tpu/tools/analyze/passes/timing.py``).

- ``timing-wall-clock``: no ``time.time()`` anywhere — durations come
  from ``time.perf_counter()`` (monotonic; a wall-clock delta can go
  NEGATIVE mid-measurement under NTP steps), wall-clock timestamps from
  timezone-aware ``datetime``.
- ``timing-block-until-ready``: no ``block_until_ready`` anywhere. It is
  the reference's JAX timing idiom and means nothing to a torch tensor:
  pasted into the port it either fails or, on an object that happens to
  have it, stops a clock before the card has finished. The port's timed
  regions end in CUDA events or a real host copy. A legitimate
  non-timing use opts OUT in its own source (``# pio-lint: allow=...``
  with the justification in the comment).
"""

from __future__ import annotations

import ast
from typing import List, Sequence

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import (
    Module, from_import_aliases, import_aliases,
)

_WALL = "timing-wall-clock"
_BLOCK = "timing-block-until-ready"


def _wall_clock_findings(mod: Module) -> List[Finding]:
    assert mod.tree is not None
    module_aliases = import_aliases(mod, "time")
    func_aliases = from_import_aliases(mod, "time", "time")
    if not module_aliases and not func_aliases:
        return []
    out = []
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit = ((isinstance(fn, ast.Attribute) and fn.attr == "time"
                and isinstance(fn.value, ast.Name)
                and fn.value.id in module_aliases)
               or (isinstance(fn, ast.Name) and fn.id in func_aliases))
        if hit and not mod.line_allows(node.lineno, _WALL):
            out.append(Finding(
                rule=_WALL, path=mod.rel, line=node.lineno,
                message="time.time() in timing-sensitive code",
                hint="use time.perf_counter() for durations (monotonic) "
                     "or timezone-aware datetime for wall-clock "
                     "timestamps"))
    return out


def _block_findings(mod: Module) -> List[Finding]:
    assert mod.tree is not None
    if mod.module_allows(_BLOCK):
        return []
    out = []
    for node in mod.nodes:
        name = None
        if (isinstance(node, ast.Attribute)
                and node.attr == "block_until_ready"):
            name = node.attr
        elif (isinstance(node, ast.Name)
                and node.id == "block_until_ready"):
            name = node.id
        if name and not mod.line_allows(node.lineno, _BLOCK):
            out.append(Finding(
                rule=_BLOCK, path=mod.rel, line=node.lineno,
                message="block_until_ready is a JAX timing idiom — on a "
                        "torch tensor it fails, and any clock stopped "
                        "behind it need not wait for the card",
                hint="end the timed region in CUDA events "
                     "(torch.cuda.Event.elapsed_time after a "
                     "synchronize) or a real host copy (.cpu()); for a "
                     "genuine non-timing use, suppress with "
                     "'# pio-lint: allow=timing-block-until-ready' and "
                     "say why"))
    return out


def run(modules: Sequence[Module]) -> List[Finding]:
    out: List[Finding] = []
    for mod in modules:
        if mod.tree is None:
            continue
        if "time" in mod.source:
            out.extend(_wall_clock_findings(mod))
        if "block_until_ready" in mod.source:
            out.extend(_block_findings(mod))
    return out


PASS = Pass(
    name="timing",
    rules=(_WALL, _BLOCK),
    doc="time.time() banned; no JAX block_until_ready pasted into the "
        "port's timed regions",
    run=run)
