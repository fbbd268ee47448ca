"""Debug-surface unity (the torch form of
``predictionio_tpu/tools/analyze/passes/debug_surface.py``).

Every ``/debug/*`` endpoint must ride the SHARED
``telemetry.handle_route`` so the port's daemons can never drift apart.
Two rules:

- ``debug-path-unshared``: any ``/debug/...`` string constant anywhere
  in the port must be one of ``telemetry.DEBUG_PATHS`` (read statically
  from the port's common/telemetry.py AST — no import, so ``pio lint``
  stays torch-free). Query-bearing forms (``/debug/slow.json?limit=3``)
  of a shared path stay legal.
- ``daemon-no-handle-route``: each daemon route handler must call
  ``telemetry.handle_route``. The six daemon modules are a structural
  fact of the architecture (query, event, storage, router, dashboard,
  admin), not an opt-in coverage list — a seventh daemon would be caught
  by rule one the moment it referenced a debug path privately.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import Module, dotted_name

_UNSHARED = "debug-path-unshared"
_NO_ROUTE = "daemon-no-handle-route"

_TELEMETRY_REL = "predictionio_tpu_torch/common/telemetry.py"

#: the daemons' route handlers (architectural constant)
DAEMON_MODULES = (
    "predictionio_tpu_torch/workflow/create_server.py",   # query
    "predictionio_tpu_torch/data/api/service.py",         # event
    "predictionio_tpu_torch/data/storage/remote.py",      # storage (RPC)
    "predictionio_tpu_torch/workflow/router.py",          # fleet (router)
    "predictionio_tpu_torch/tools/dashboard.py",          # eval dashboard
    "predictionio_tpu_torch/tools/admin.py",              # admin
)


def shared_debug_paths(modules: Sequence[Module]) -> Optional[Set[str]]:
    """``DEBUG_PATHS`` parsed from common/telemetry.py, or None when the
    assignment cannot be found (then the rule abstains rather than
    flagging everything)."""
    for mod in modules:
        if mod.rel != _TELEMETRY_REL or mod.tree is None:
            continue
        for node in mod.nodes:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "DEBUG_PATHS":
                    value = node.value
                    if isinstance(value, (ast.Tuple, ast.List)):
                        return {e.value for e in value.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, str)}
    return None


def run(modules: Sequence[Module]) -> List[Finding]:
    shared = shared_debug_paths(modules)
    out: List[Finding] = []
    if shared is not None:
        for mod in modules:
            if mod.tree is None or "/debug/" not in mod.source:
                continue
            if mod.module_allows(_UNSHARED):
                continue
            for node in mod.nodes:
                # the bare "/debug/" prefix (this pass's own probe
                # string) is not an endpoint — only named paths count
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value.startswith("/debug/")
                        and node.value != "/debug/"):
                    continue
                const = node.value
                if any(const == p or const.startswith(p + "?")
                       for p in shared):
                    continue
                if mod.line_allows(node.lineno, _UNSHARED):
                    continue
                out.append(Finding(
                    rule=_UNSHARED, path=mod.rel, line=node.lineno,
                    message=f"debug endpoint {const!r} is not served by "
                            "telemetry.DEBUG_PATHS — wired into one "
                            "daemon privately, it drifts off the others",
                    hint="register the path in common/telemetry.py "
                         "handle_route (DEBUG_PATHS) so every daemon "
                         "serves it",
                    detail=const))
    by_rel = {m.rel: m for m in modules}
    for rel in DAEMON_MODULES:
        mod = by_rel.get(rel)
        if mod is None or mod.tree is None or mod.module_allows(_NO_ROUTE):
            continue
        calls = [n for n in mod.nodes
                 if isinstance(n, ast.Call)
                 and dotted_name(n.func) == "telemetry.handle_route"]
        if not calls:
            out.append(Finding(
                rule=_NO_ROUTE, path=mod.rel, line=1,
                message="daemon route handler never calls "
                        "telemetry.handle_route — its /metrics, "
                        "/traces.json and /debug/* surface has drifted "
                        "off",
                hint="route unmatched paths through "
                     "telemetry.handle_route before answering 404",
                detail=rel))
    return out


PASS = Pass(
    name="debug-surface",
    rules=(_UNSHARED, _NO_ROUTE),
    doc="every /debug/* path rides the shared telemetry.handle_route; "
        "all six daemons serve the same surface",
    run=run)
