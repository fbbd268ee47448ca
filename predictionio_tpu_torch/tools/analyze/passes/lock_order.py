"""Static lock-ordering over the port's threaded subsystems (the torch
form of ``predictionio_tpu/tools/analyze/passes/lock_order.py``).

The serving stack holds locks from several modules on one call path
(batcher condition → telemetry family locks → waterfall ring; WAL lock →
chunk cache), and a deadlock needs only two paths that nest the same two
locks in opposite orders. This pass builds the static lock-acquisition
graph — every syntactic ``with <lock>:`` nesting and every
``<lock>.acquire()`` region — across the port and fails on any lock pair
acquired in both orders anywhere.

Lock identity is structural, not object-based: ``self._lock`` inside
``class Family`` in ``common/telemetry.py`` is the node
``<package>/common/telemetry.py:Family._lock``; a module-global
``_install_lock`` is ``<package>/common/slo.py:_install_lock``.
Distinct instances of one class share a node — which over-approximates
(two Family instances never deadlock each other through one ``with``)
but that is the safe direction for a static pass, and per-instance
nesting of one class's lock is rare enough to pragma when intentional.

What a ``with``-expression counts as a lock: its last attribute/name
segment contains ``lock``, ``cond``, or ``mutex`` (the repo's naming
convention for every ``threading.Lock/RLock/Condition``). Cross-
function holds (lock held while CALLING into another module) are
invisible statically — that is exactly the half the runtime checker
(:mod:`..runtime`, which ``chip_smoke.py``'s tooling phase wraps
around a live deploy's locks) covers.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import Module, dotted_name

_RULE = "lock-order-inversion"

_LOCKISH = ("lock", "cond", "mutex")


def _lock_id(node: ast.AST, mod: Module,
             cls: Optional[str]) -> Optional[str]:
    """Structural lock identity for a with-item / acquire target."""
    dn = dotted_name(node)
    if dn is None:
        return None
    last = dn.split(".")[-1].lower()
    if not any(t in last for t in _LOCKISH):
        return None
    if dn.startswith("self."):
        owner = cls or "<module>"
        return f"{mod.rel}:{owner}.{dn[len('self.'):]}"
    return f"{mod.rel}:{dn}"


def _edges_in_function(fn: ast.AST, mod: Module,
                       cls: Optional[str]) -> Set[Tuple[str, str]]:
    """(outer, inner) pairs from syntactic nesting inside one function."""
    edges: Set[Tuple[str, str]] = set()

    def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
        acquired: List[str] = []
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                # `with lock:` or `with lock.acquire_timeout(...)`-style
                target = expr.func if isinstance(expr, ast.Call) else expr
                if (isinstance(target, ast.Attribute)
                        and target.attr in ("acquire",)):
                    target = target.value
                lid = _lock_id(target, mod, cls)
                if lid is not None:
                    for h in held:
                        if h != lid:
                            edges.add((h, lid))
                    acquired.append(lid)
        for child in ast.iter_child_nodes(node):
            visit(child, held + tuple(acquired))

    visit(fn, ())
    return edges


def build_graph(modules: Sequence[Module]) -> Dict[
        Tuple[str, str], List[str]]:
    """(outer, inner) -> [site, ...] over every function in the repo."""
    graph: Dict[Tuple[str, str], List[str]] = {}
    for mod in modules:
        if mod.tree is None or mod.module_allows(_RULE):
            continue

        def collect(scope: ast.AST, cls: Optional[str]) -> None:
            for node in ast.iter_child_nodes(scope):
                if isinstance(node, ast.ClassDef):
                    collect(node, node.name)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    if not mod.line_allows(node.lineno, _RULE):
                        for edge in _edges_in_function(node, mod, cls):
                            graph.setdefault(edge, []).append(
                                f"{mod.rel}:{node.lineno}:{node.name}")
                    collect(node, cls)

        collect(mod.tree, None)
    return graph


def inversions(graph: Dict[Tuple[str, str], List[str]]
               ) -> List[Tuple[str, str]]:
    """Lock pairs acquired in both orders, canonically sorted."""
    out = []
    for a, b in graph:
        if a < b and (b, a) in graph:
            out.append((a, b))
    return sorted(out)


def run(modules: Sequence[Module]) -> List[Finding]:
    graph = build_graph(modules)
    out: List[Finding] = []
    for a, b in inversions(graph):
        fwd = ", ".join(sorted(graph[(a, b)])[:3])
        rev = ", ".join(sorted(graph[(b, a)])[:3])
        site = sorted(graph[(a, b)])[0]
        path, line = site.rsplit(":", 2)[0], int(site.rsplit(":", 2)[1])
        out.append(Finding(
            rule=_RULE, path=path, line=line,
            message=f"inconsistent lock order: {a} -> {b} (at {fwd}) "
                    f"but {b} -> {a} (at {rev}) — two threads on these "
                    "paths can deadlock",
            hint="pick ONE acquisition order for the pair and restructure "
                 "the minority path (release before re-acquiring, or "
                 "snapshot under the first lock and work lock-free)",
            detail=f"{a}<->{b}"))
    return out


PASS = Pass(
    name="lock-order",
    rules=(_RULE,),
    doc="static lock-acquisition graph must be free of pairwise order "
        "inversions (deadlock shapes); runtime half in analyze/runtime.py",
    run=run)
