"""Cross-checks between the port's code, its declaration registry, and
README (the torch form of
``predictionio_tpu/tools/analyze/passes/declarations.py``).

``predictionio_tpu_torch/common/declarations.py`` is the port's single
source of truth for its operational surface: every ``PIO_*`` env var the
code reads and every ``pio_*`` metric family it exports. This pass
closes the triangle in all directions:

- ``env-undeclared`` / ``metric-undeclared``: a read/registration in
  code with no declaration — a typo'd env name silently reads its
  default forever; an undeclared metric is invisible to operators.
- ``env-dead`` / ``metric-ghost``: a declaration whose name appears
  nowhere in the code — documentation for a knob that does nothing.
- ``env-undocumented`` / ``metric-undocumented``: a declaration missing
  from README.md — a knob operators cannot discover.
- ``journal-undeclared``: a ``journal.emit(category=...)`` call site
  whose category is not declared in ``JOURNAL_CATEGORIES`` — a typo'd
  category produces a timeline no operator's filter ever finds.

The registry is READ, not imported: its three dicts are parsed from the
module's AST (the analyzed tree's copy when the tree holds one, else the
package's own file), so the lint needs nothing but the stdlib. A
registry whose dicts are not literal is an internal error, never an
empty registry.

Detection is AST-shaped, not grep-shaped: an env READ is a call on an
environ-like object (``os.environ.get/pop/setdefault``, ``os.getenv``,
``self._env.get``), a subscript of one, or any ``*env*``-named helper
(``_env_float("PIO_X", ...)``) whose first argument's literal prefix
starts with ``PIO_``; a metric REGISTRATION is a
``.counter/.gauge/.histogram("pio_...")`` call. Dynamically-composed
names match declared PREFIX families (``PIO_STORAGE_SOURCES_*``).
Dead/ghost checks fall back to a raw source-text search so names built
dynamically (``f"{prefix}_RETRIES"``) or emitted by scrape-time
collectors don't read as dead.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import (
    Module, dotted_name, literal_prefix, repo_root,
)

_ENV_UNDECLARED = "env-undeclared"
_ENV_DEAD = "env-dead"
_ENV_UNDOC = "env-undocumented"
_MET_UNDECLARED = "metric-undeclared"
_MET_GHOST = "metric-ghost"
_MET_UNDOC = "metric-undocumented"
_JOURNAL_UNDECLARED = "journal-undeclared"

_DECL_REL = "predictionio_tpu_torch/common/declarations.py"

#: the registry's dicts, each name -> one-line meaning
REGISTRY_DICTS = ("ENV_VARS", "METRICS", "JOURNAL_CATEGORIES")


def _is_environ_owner(node: ast.AST) -> bool:
    dn = dotted_name(node)
    if dn is None:
        return False
    last = dn.split(".")[-1]
    return "environ" in last or last == "_env" or last.endswith("env")


def env_reads(mod: Module) -> List[Tuple[str, int, bool]]:
    """(name-or-literal-prefix, line, is_full_literal) for every PIO_*
    env access. ``is_full_literal`` distinguishes a complete constant
    name (typo-checkable exactly) from the leading literal of a
    dynamically-composed one (prefix-matched only)."""
    assert mod.tree is not None
    out: List[Tuple[str, int, bool]] = []

    def note(arg: ast.AST, line: int) -> None:
        lit = literal_prefix(arg)
        if lit and lit.startswith("PIO_"):
            out.append((lit, line, isinstance(arg, ast.Constant)))

    for node in mod.nodes:
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in ("get", "pop", "setdefault")
                    and _is_environ_owner(fn.value) and node.args):
                note(node.args[0], node.lineno)
            elif dotted_name(fn) == "os.getenv" and node.args:
                note(node.args[0], node.lineno)
            elif (isinstance(fn, ast.Name) and "env" in fn.id.lower()
                    and node.args):
                note(node.args[0], node.lineno)
        elif isinstance(node, ast.Subscript):
            if _is_environ_owner(node.value):
                note(node.slice, node.lineno)
    return out


def metric_registrations(mod: Module) -> List[Tuple[str, int]]:
    assert mod.tree is not None
    out: List[Tuple[str, int]] = []
    for node in mod.nodes:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram")
                and node.args):
            lit = literal_prefix(node.args[0])
            if lit and lit.startswith("pio_"):
                out.append((lit, node.lineno))
    return out


def journal_emits(mod: Module) -> List[Tuple[Optional[str], int]]:
    """(category-literal-or-None, line) for every ``journal.emit(...)``
    call: the category is the first positional argument or the
    ``category=`` keyword. None means dynamically composed — the rule
    abstains (same posture as dynamic env names)."""
    assert mod.tree is not None
    out: List[Tuple[Optional[str], int]] = []
    for node in mod.nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"):
            continue
        owner = dotted_name(node.func.value) or ""
        if owner.split(".")[-1] != "journal":
            continue
        arg: Optional[ast.AST] = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "category":
                arg = kw.value
        if arg is None:
            continue
        cat = (arg.value if isinstance(arg, ast.Constant)
               and isinstance(arg.value, str) else None)
        out.append((cat, node.lineno))
    return out


def read_registry(tree: ast.AST) -> Dict[str, Dict[str, str]]:
    """The registry's three dicts, read from its module's AST. Raises
    ValueError when one is missing or not a literal dict of string keys
    (a spread or a computed key would hide names from the lint)."""
    out: Dict[str, Dict[str, str]] = {}
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        if not (isinstance(target, ast.Name)
                and target.id in REGISTRY_DICTS):
            continue
        if not isinstance(value, ast.Dict):
            raise ValueError(f"{target.id} is not a dict literal")
        entries: Dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                raise ValueError(f"{target.id} has a key that is not a "
                                 "string literal")
            entries[k.value] = (v.value if isinstance(v, ast.Constant)
                                and isinstance(v.value, str) else "")
        out[target.id] = entries
    missing = [name for name in REGISTRY_DICTS if name not in out]
    if missing:
        raise ValueError(f"no {', '.join(missing)} in the registry")
    return out


def _registry(modules: Sequence[Module]) -> Tuple[
        Dict[str, Dict[str, str]], str]:
    """(the registry's dicts, the root of the tree it was read from):
    the analyzed tree's copy when it holds one, else the package's."""
    for mod in modules:
        if mod.rel == _DECL_REL:
            if mod.tree is None:
                raise ValueError(f"{_DECL_REL} does not parse")
            root = mod.path[: len(mod.path) - len(mod.rel)]
            return read_registry(mod.tree), root or repo_root()
    root = repo_root()
    with open(os.path.join(root, _DECL_REL), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=_DECL_REL)
    return read_registry(tree), root


def _readme_text(root: str) -> str:
    path = os.path.join(root, "README.md")
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def run(modules: Sequence[Module],
        readme_text: Optional[str] = None) -> List[Finding]:
    registry, root = _registry(modules)
    env = registry["ENV_VARS"]
    exact = {k: v for k, v in env.items() if not k.endswith("*")}
    prefixes = {k[:-1]: v for k, v in env.items() if k.endswith("*")}
    metrics = registry["METRICS"]
    categories = registry["JOURNAL_CATEGORIES"]
    readme = readme_text if readme_text is not None else _readme_text(root)
    out: List[Finding] = []

    def env_declared(name: str, full: bool) -> bool:
        if name in exact:
            return True
        if any(name.startswith(p) for p in prefixes):
            return True
        if full:
            return False
        # a dynamic read's literal prefix may be shorter than a declared
        # exact name (f"PIO_SLO_{which}") — any declared name or prefix
        # family extending it counts
        return (any(p.startswith(name) for p in prefixes)
                or any(e.startswith(name) for e in exact))

    for mod in modules:
        if mod.tree is None or mod.rel == _DECL_REL:
            continue
        if "PIO_" in mod.source:
            for name, line, full in env_reads(mod):
                if (not env_declared(name, full)
                        and not mod.line_allows(line, _ENV_UNDECLARED)):
                    out.append(Finding(
                        rule=_ENV_UNDECLARED, path=mod.rel, line=line,
                        message=f"env var {name} is read but not "
                                "declared in common/declarations.py",
                        hint="declare it in declarations.ENV_VARS with "
                             "a one-line meaning and document it in "
                             "README (or fix the typo — an undeclared "
                             "read silently uses its default forever)",
                        detail=name))
        if "pio_" in mod.source:
            for name, line in metric_registrations(mod):
                if (name not in metrics
                        and not mod.line_allows(line, _MET_UNDECLARED)):
                    out.append(Finding(
                        rule=_MET_UNDECLARED, path=mod.rel, line=line,
                        message=f"metric {name} is registered but not "
                                "declared in common/declarations.py",
                        hint="declare it in declarations.METRICS and "
                             "document it in README",
                        detail=name))
        if "journal" in mod.source:
            for cat, line in journal_emits(mod):
                if (cat is not None and cat not in categories
                        and not mod.line_allows(line,
                                                _JOURNAL_UNDECLARED)):
                    out.append(Finding(
                        rule=_JOURNAL_UNDECLARED, path=mod.rel,
                        line=line,
                        message=f"journal category {cat!r} is emitted "
                                "but not declared in "
                                "declarations.JOURNAL_CATEGORIES",
                        hint="declare the category with a one-line "
                             "meaning (or fix the typo — an "
                             "undeclared category is a timeline no "
                             "operator filter finds)",
                        detail=cat))

    # dead / ghost / undocumented are properties of the registry
    # itself: only judged when the analyzed tree CONTAINS the registry
    # module (a --root pointed at a scratch tree must not inherit the
    # package's declarations as instant dead findings)
    if not any(m.rel == _DECL_REL for m in modules):
        return out

    # dead / ghost: a declared name that appears nowhere else in code.
    # Raw text search (not AST) so dynamically-composed env names and
    # collector-emitted exposition lines count as alive.
    sources = [m.source for m in modules if m.rel != _DECL_REL]
    decl_line = _decl_lines(next(m.source for m in modules
                                 if m.rel == _DECL_REL))
    for name in exact:
        if not any(name in src for src in sources):
            out.append(Finding(
                rule=_ENV_DEAD, path=_DECL_REL,
                line=decl_line.get(name, 1),
                message=f"declared env var {name} is read nowhere in "
                        "the code",
                hint="delete the declaration (and its README row) — a "
                     "dead knob misleads operators",
                detail=name))
    for name in metrics:
        if not any(name in src for src in sources):
            out.append(Finding(
                rule=_MET_GHOST, path=_DECL_REL,
                line=decl_line.get(name, 1),
                message=f"declared metric {name} is emitted nowhere in "
                        "the code",
                hint="delete the declaration (and its README row) — a "
                     "ghost metric sends operators hunting for series "
                     "that never exist",
                detail=name))

    # undocumented: declared but absent from README
    for name in list(exact) + [p + "*" for p in prefixes]:
        probe = name[:-1] if name.endswith("*") else name
        if probe not in readme:
            out.append(Finding(
                rule=_ENV_UNDOC, path=_DECL_REL,
                line=decl_line.get(name, 1),
                message=f"env var {name} is not documented in README.md",
                hint="add it to the README configuration reference table",
                detail=name))
    for name in metrics:
        if name not in readme:
            out.append(Finding(
                rule=_MET_UNDOC, path=_DECL_REL,
                line=decl_line.get(name, 1),
                message=f"metric {name} is not documented in README.md",
                hint="add it to a README metrics table",
                detail=name))
    return out


def _decl_lines(decl_source: str) -> Dict[str, int]:
    """Declaration name -> line in declarations.py (for finding sites)."""
    out: Dict[str, int] = {}
    for i, text in enumerate(decl_source.splitlines(), start=1):
        s = text.strip()
        if s.startswith('"PIO_') or s.startswith('"pio_'):
            out.setdefault(s.split('"')[1], i)
    return out


PASS = Pass(
    name="declarations",
    rules=(_ENV_UNDECLARED, _ENV_DEAD, _ENV_UNDOC,
           _MET_UNDECLARED, _MET_GHOST, _MET_UNDOC,
           _JOURNAL_UNDECLARED),
    doc="every PIO_* env read, pio_* metric, and journal.emit category "
        "is declared in the port's common/declarations.py and "
        "documented in README",
    run=run)
