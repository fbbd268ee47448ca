"""Shared module walker: every analyzed file, parsed once (the torch form
of ``predictionio_tpu/tools/analyze/walker.py``).

Coverage is the port's whole tree of record — the
``predictionio_tpu_torch`` package and ``chip_smoke.py``, the script that
drives it on the card — so a new module is analyzed the moment it
exists. ``tests/`` stays out: tests seed defects on purpose and assert
on lint internals. Passes receive the same parsed :class:`Module` list;
nothing re-reads the filesystem.

Opt-outs are per-line or per-module pragmas in the source itself
(:meth:`Module.line_allows` / :meth:`Module.module_allows`), so an
exemption lives next to the code it exempts and travels with it through
refactors.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import (
    Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple,
)

#: the package analyzed, and the top-level files analyzed beside it
PACKAGE = "predictionio_tpu_torch"
_EXTRA_FILES = ("chip_smoke.py",)

_PRAGMA = "pio-lint:"


def repo_root() -> str:
    """The directory holding ``predictionio_tpu_torch/`` (and
    ``chip_smoke.py``)."""
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.dirname(pkg)


@dataclasses.dataclass
class Module:
    """One analyzed source file: path, text and its parsed AST."""
    path: str                 # absolute
    rel: str                  # repo-relative, "/"-separated
    source: str
    tree: Optional[ast.AST]   # None when the file does not parse
    parse_error: Optional[str] = None

    _lines: Optional[List[str]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _pragmas: Optional[Dict[int, Set[str]]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _module_pragmas: Optional[Set[str]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _nodes: Optional[List[ast.AST]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree (``ast.walk`` order), walked once and
        shared by the passes."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree)) if self.tree else []
        return self._nodes

    @property
    def lines(self) -> List[str]:
        if self._lines is None:
            self._lines = self.source.splitlines()
        return self._lines

    # -------------------------------------------------------- pragmas
    def _scan_pragmas(self) -> None:
        per_line: Dict[int, Set[str]] = {}
        module_wide: Set[str] = set()
        for i, text in enumerate(self.lines, start=1):
            if _PRAGMA not in text:
                continue
            tail = text.split(_PRAGMA, 1)[1]
            for clause in tail.replace(";", " ").split():
                if clause.startswith("allow="):
                    per_line.setdefault(i, set()).update(
                        clause[len("allow="):].split(","))
                elif clause.startswith("module-allow="):
                    module_wide.update(
                        clause[len("module-allow="):].split(","))
        self._pragmas = per_line
        self._module_pragmas = module_wide

    def line_allows(self, line: int, rule: str) -> bool:
        """Is ``rule`` suppressed at ``line``? The pragma may sit on the
        flagged line itself or on the line directly above it (for lines
        too long to carry a trailing comment)."""
        if self._pragmas is None:
            self._scan_pragmas()
        assert self._pragmas is not None
        for at in (line, line - 1):
            if rule in self._pragmas.get(at, ()):
                return True
        return False

    def module_allows(self, rule: str) -> bool:
        if self._module_pragmas is None:
            self._scan_pragmas()
        assert self._module_pragmas is not None
        return rule in self._module_pragmas


def _iter_paths(root: str) -> Iterator[str]:
    pkg = os.path.join(root, PACKAGE)
    for base, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(base, f)
    for extra in _EXTRA_FILES:
        p = os.path.join(root, extra)
        if os.path.isfile(p):
            yield p


def discover(root: Optional[str] = None) -> List[Module]:
    """Every analyzed module, parsed. A file that fails to parse still
    appears (``tree=None`` + ``parse_error``) so the runner can turn it
    into a finding instead of silently shrinking coverage."""
    root = root or repo_root()
    out: List[Module] = []
    for path in _iter_paths(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree: Optional[ast.AST] = ast.parse(source, filename=path)
            err = None
        except SyntaxError as e:
            tree, err = None, f"{e.msg} (line {e.lineno})"
        out.append(Module(path=path, rel=rel, source=source, tree=tree,
                          parse_error=err))
    return out


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _walk(tree: "ast.AST | Module") -> Iterable[ast.AST]:
    """A module's cached node list, or a fresh walk of a bare tree."""
    return tree.nodes if isinstance(tree, Module) else ast.walk(tree)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: "ast.AST | Module", module: str) -> Set[str]:
    """Local names bound to ``module`` (``import time as t`` -> {"t"})."""
    out: Set[str] = set()
    for node in _walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name)
    return out


def from_import_aliases(tree: "ast.AST | Module", module: str,
                        name: str) -> Set[str]:
    """Local names bound to ``module.name`` via ``from module import``."""
    out: Set[str] = set()
    for node in _walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                if a.name == name:
                    out.add(a.asname or a.name)
    return out


def module_alias_map(tree: "ast.AST | Module") -> Dict[str, str]:
    """Local name -> dotted module it is bound to, for both spellings
    (``import a.b.c as x`` and ``from a.b import c [as x]``)."""
    out: Dict[str, str] = {}
    for node in _walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def literal_prefix(node: ast.AST) -> Optional[str]:
    """Best-effort leading literal of a string expression: a constant,
    an f-string's leading text, or a ``"lit" + x`` concatenation —
    enough to match dynamically-built env names against declared
    prefixes."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return literal_prefix(node.left)
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"):
        return literal_prefix(node.func.value)
    return None


# ---------------------------------------------------------------------------
# the warm-up registry (serving/aot.register_entry), resolved statically
# ---------------------------------------------------------------------------

#: the registry's registration function, the counterpart of the
#: reference's ``register_jit``
REGISTER = "register_entry"


def registration_calls(mod: Module) -> List[ast.Call]:
    """Every ``register_entry(name, fn, ...)`` call of a module (bare or
    through a module alias), with at least the two positional args."""
    if mod.tree is None or REGISTER not in mod.source:
        return []
    out: List[ast.Call] = []
    for node in mod.nodes:
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        dn = dotted_name(node.func)
        if dn and (dn == REGISTER or dn.endswith("." + REGISTER)):
            out.append(node)
    return out


def module_name(mod: Module) -> str:
    """The dotted module name of a repo-relative path."""
    name = mod.rel[:-3].replace("/", ".") if mod.rel.endswith(".py") \
        else mod.rel
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def registered_entry_defs(modules: Sequence[Module]) -> List[
        Tuple[Module, ast.FunctionDef]]:
    """Every function def registered through ``register_entry``, resolved
    across modules: ``register_entry("n", f)`` binds a def of the
    calling module, ``register_entry("n", topk.topk_for_user)`` follows
    the ``topk`` import back to ``ops/topk.py``. The warm-up replays
    these bodies and a CUDA graph of the serve would capture them, so
    the jit-purity pass holds them to its rules."""
    by_name = {module_name(m): m for m in modules}
    out: List[Tuple[Module, ast.FunctionDef]] = []
    seen: Set[Tuple[str, int]] = set()

    def add(mod: Module, fn: ast.FunctionDef) -> None:
        key = (mod.rel, fn.lineno)
        if key not in seen:
            seen.add(key)
            out.append((mod, fn))

    for m in modules:
        calls = registration_calls(m)
        if not calls:
            continue
        aliases = module_alias_map(m)
        local_defs = {n.name: n for n in m.nodes
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        for node in calls:
            target = node.args[1]
            if isinstance(target, ast.Name) and target.id in local_defs:
                add(m, local_defs[target.id])
            elif (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)):
                target_mod = by_name.get(aliases.get(target.value.id, ""))
                if target_mod is None or target_mod.tree is None:
                    continue
                for n in target_mod.tree.body:
                    if (isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                            and n.name == target.attr):
                        add(target_mod, n)
                        break
    return out
