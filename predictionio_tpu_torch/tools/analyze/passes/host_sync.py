"""Host-transfer hygiene on the port's device paths (the torch form of
``predictionio_tpu/tools/analyze/passes/host_sync.py``).

Two rule families, both dataflow-lite so they stay precise enough to run
port-wide without an opt-in module list:

- ``hostsync-implicit``: an implicit device→host sync — ``float()`` /
  ``int()`` / ``bool()`` / ``np.asarray()`` / ``.item()`` /
  ``.tolist()`` / ``print()`` applied to a value that provably came
  from a torch computation (a ``torch.``-rooted expression, or a local
  assigned from one in the enclosing function). On a CUDA tensor each of
  these blocks the calling thread until the card has caught up,
  invisibly to every timer and trace span. The sanctioned transfer is an
  explicit ``.cpu()`` / ``.to("cpu")`` at the END of the region, which
  this rule exempts as the reference exempts ``jax.device_get``.
  Calls that return host objects (``torch.cuda.*``, ``torch.device``,
  ``torch.distributed.*``, ``torch.finfo``, ...) are not tensors and are
  exempt too. The reference's jit-body half has no torch meaning (the
  port traces nothing) and is not here.
- ``gather-clip``: ``torch.index_select`` / ``torch.gather`` /
  ``torch.take`` and the ``Tensor.index_select`` / ``Tensor.gather``
  methods whose index is not provably bounded. On the card an
  out-of-range index is a device-side assert that kills the CUDA context
  (every later call in the process fails), and on the CPU it raises. An
  index is accepted when it is built from a bounding op (``clamp`` /
  ``where`` / ``arange`` / ``argsort`` / ``topk`` / ...) in the
  enclosing function stack, possibly through a slice or a dtype cast;
  when an ``assert`` or an ``if ...: raise`` in the stack compares it (a
  checked range); or when it is a parameter of a function whose
  docstring states the in-bounds contract. Anything else needs the bound
  — or a ``# pio-lint: allow=gather-clip`` pragma carrying the
  justification.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import (
    Module, dotted_name, module_alias_map,
)

_IMPLICIT = "hostsync-implicit"
_GATHER = "gather-clip"

#: index expressions built through these ops are bounded by construction
_SAFE_INDEX_CALLS = frozenset({
    "clamp", "clamp_", "clip", "clip_", "minimum", "maximum", "where",
    "remainder", "arange", "argsort", "sort", "topk", "argmax", "argmin",
    "searchsorted", "bucketize", "nonzero", "repeat_interleave",
    "randint", "randperm", "integers",
})

#: calls that keep an index's values (a bounded index stays bounded)
_VALUE_PRESERVING = frozenset({
    "long", "int", "to", "contiguous", "view", "reshape", "flatten",
    "expand", "expand_as", "unsqueeze", "squeeze", "clone",
})

#: a docstring mentioning any of these states the caller-side bounds
#: contract for a parameter-indexed gather
_POLICY_WORDS = ("clip", "clamp", "in-bounds", "in bounds",
                 "out-of-bounds", "out of bounds", "oob")

#: torch namespaces and calls that return HOST objects (devices, counts,
#: dtype info, process-group facts) — not tensors, so converting or
#: printing them is not a sync
_NON_TENSOR_API = frozenset({
    "cuda", "distributed", "backends", "version", "__version__",
    "device", "finfo", "iinfo", "Size", "dtype", "is_tensor", "numel",
    "get_num_threads", "get_default_dtype", "is_grad_enabled",
    "initial_seed", "profiler",
})

#: the gather entry points: torch function -> index position
_TORCH_GATHERS = {"index_select": 2, "gather": 2, "take": 1}
#: the Tensor methods -> index position
_METHOD_GATHERS = {"index_select": 1, "gather": 1}


def _torch_roots(mod: Module) -> Set[str]:
    """Local names that address torch namespaces holding tensor ops
    (``torch`` and its aliases, ``torch.nn.functional as F``)."""
    assert mod.tree is not None
    roots: Set[str] = set()
    for local, target in module_alias_map(mod).items():
        parts = target.split(".")
        if parts[0] == "torch" and not any(p in _NON_TENSOR_API
                                           for p in parts[1:]):
            roots.add(local)
    return roots


def _is_host_transfer(call: ast.Call) -> bool:
    """``x.cpu()`` / ``x.to("cpu")`` / ``x.to(device="cpu")``: the
    explicit copy to the host."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "cpu":
        return True
    if fn.attr != "to":
        return False
    args = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _shape_ish(node: ast.AST) -> bool:
    """Shape and size expressions are host ints, whatever tensor they
    read: converting them is not a sync."""
    if isinstance(node, ast.Subscript):
        return _shape_ish(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim", "dtype", "device",
                             "is_cuda")
    if isinstance(node, ast.Call):
        fn = node.func
        return ((isinstance(fn, ast.Name) and fn.id == "len")
                or (isinstance(fn, ast.Attribute)
                    and fn.attr in ("size", "numel", "dim",
                                    "element_size", "nelement")))
    if isinstance(node, ast.BinOp):
        return _shape_ish(node.left) and _shape_ish(node.right)
    return False


def _device_rooted(node: ast.AST, roots: Set[str],
                   dev_names: Set[str] = frozenset()) -> bool:
    """Is this expression a torch computation: rooted at a torch call or
    at a local assigned from one (``dev_names``)? A ``.cpu()`` chain is
    the sanctioned transfer; shapes and host introspection are host
    objects — all excepted."""
    if _shape_ish(node):
        return False
    if isinstance(node, ast.Name):
        return node.id in dev_names
    if isinstance(node, ast.Call):
        if _is_host_transfer(node):
            return False
        dn = dotted_name(node.func)
        if dn:
            parts = dn.split(".")
            if parts[0] in roots:
                return not any(part in _NON_TENSOR_API
                               for part in parts[1:])
        return _device_rooted(node.func, roots, dev_names)
    if isinstance(node, (ast.Attribute, ast.Subscript)):
        return _device_rooted(node.value, roots, dev_names)
    if isinstance(node, ast.BinOp):
        return (_device_rooted(node.left, roots, dev_names)
                or _device_rooted(node.right, roots, dev_names))
    if isinstance(node, ast.UnaryOp):
        return _device_rooted(node.operand, roots, dev_names)
    return False


def _assigned_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_assigned_names(elt))
        return out
    return []


def _device_locals(fn: ast.AST, roots: Set[str]) -> Set[str]:
    """Names assigned inside ``fn`` from torch-rooted expressions, or
    from expressions over such names (to a fixed point)."""
    assigns = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            names = [n for t in node.targets for n in _assigned_names(t)]
            assigns.append((names, node.value))
        elif (isinstance(node, (ast.AugAssign, ast.AnnAssign))
                and node.value is not None):
            assigns.append((_assigned_names(node.target), node.value))
    out: Set[str] = set()
    while True:
        grown = {n for names, value in assigns
                 if _device_rooted(value, roots, out) for n in names}
        if grown <= out:
            return out
        out |= grown


def _sync_kind(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """(description, suspect-argument) when ``call`` is one of the
    implicit-sync shapes, else None."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool"):
        if len(call.args) == 1:
            return f"{fn.id}()", call.args[0]
    dn = dotted_name(fn)
    if dn in ("np.asarray", "np.array", "numpy.asarray", "numpy.array"):
        if call.args:
            return dn, call.args[0]
    if isinstance(fn, ast.Name) and fn.id == "print" and call.args:
        return "print()", call.args[0]
    if (isinstance(fn, ast.Attribute) and fn.attr in ("item", "tolist")
            and not call.args):
        return f".{fn.attr}()", fn.value
    return None


def _implicit_findings(mod: Module) -> List[Finding]:
    assert mod.tree is not None
    roots = _torch_roots(mod)
    out: List[Finding] = []
    seen: Set[int] = set()

    def scan(scope: ast.AST, dev_names: Set[str]) -> None:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            kind = _sync_kind(node)
            if kind is None:
                continue
            desc, arg = kind
            if not _device_rooted(arg, roots, dev_names):
                continue
            seen.add(id(node))
            out.append(Finding(
                rule=_IMPLICIT, path=mod.rel, line=node.lineno,
                message=f"{desc} on a torch value forces an implicit "
                        "device->host sync when the tensor lives on the "
                        "card",
                hint="end the region in an explicit .cpu() (the "
                     "sanctioned transfer) or keep the value on the "
                     "device; for a tensor that always lives on the "
                     "host, say so with '# pio-lint: "
                     "allow=hostsync-implicit'"))

    if not roots:
        return out
    for node in mod.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(node, _device_locals(node, roots))
    # module level: only TOP-LEVEL statements with TOP-LEVEL provenance —
    # walking the whole tree with module-wide dev-locals would let one
    # function's torch local poison a same-named parameter elsewhere
    top = [stmt for stmt in mod.tree.body
           if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.ClassDef))]
    top_dev = _device_locals(ast.Module(body=top, type_ignores=[]), roots)
    for stmt in top:
        scan(stmt, top_dev)
    return [f for f in out if not mod.line_allows(f.line, _IMPLICIT)]


# ---------------------------------------------------------------------------
# gather-clip
# ---------------------------------------------------------------------------

def _contains_safe_call(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            dn = dotted_name(sub.func)
            if dn is None and isinstance(sub.func, ast.Attribute):
                dn = sub.func.attr        # a method on a call's result
            if dn and dn.split(".")[-1] in _SAFE_INDEX_CALLS:
                return True
    return False


def _index_base(idx: ast.AST) -> ast.AST:
    """Strip slices and value-preserving calls: ``ix[lo:hi].long()`` is
    bounded exactly when ``ix`` is."""
    while True:
        if isinstance(idx, ast.Subscript):
            idx = idx.value
        elif (isinstance(idx, ast.Call)
                and isinstance(idx.func, ast.Attribute)
                and idx.func.attr in _VALUE_PRESERVING):
            idx = idx.func.value
        else:
            return idx


def _assigned_names_any(targets: Sequence[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for t in targets:
        out.update(_assigned_names(t))
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _range_checked(name: str, stack: Sequence[ast.AST]) -> bool:
    """An ``assert`` or an ``if ...: raise`` in the stack whose test
    compares ``name`` — the caller's range is checked before the
    gather."""
    for scope in stack:
        for node in ast.walk(scope):
            if isinstance(node, ast.Assert):
                test = node.test
            elif (isinstance(node, ast.If) and node.body
                    and isinstance(node.body[0], ast.Raise)):
                test = node.test
            else:
                continue
            if any(isinstance(c, ast.Compare) and name in _names_in(c)
                   for c in ast.walk(test)):
                return True
    return False


def _index_is_safe(idx: ast.AST, stack: Sequence[ast.AST],
                   _seen: Optional[Set[str]] = None) -> bool:
    """Bounded by construction? ``stack`` is the enclosing def chain
    (innermost last), used to resolve local assignments (through
    aliases such as ``ix = user_ixs.long()``), range checks and
    parameter contracts."""
    if isinstance(idx, ast.Constant):
        return True
    if _contains_safe_call(idx):
        return True
    base = _index_base(idx)
    if not isinstance(base, ast.Name):
        return False
    name = base.id
    seen = (_seen or set()) | {name}
    for scope in stack:
        for node in ast.walk(scope):
            if not (isinstance(node, ast.Assign)
                    and name in _assigned_names_any(node.targets)):
                continue
            if _contains_safe_call(node.value):
                return True
            alias = _index_base(node.value)
            if (isinstance(alias, ast.Name) and alias.id not in seen
                    and _index_is_safe(alias, stack, seen)):
                return True
    if _range_checked(name, stack):
        return True
    # a parameter whose function documents the bounds contract
    for scope in reversed(stack):
        if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in (scope.args.args
                                  + scope.args.kwonlyargs
                                  + scope.args.posonlyargs)}
        if name in params:
            doc = (ast.get_docstring(scope) or "").lower()
            return any(w in doc for w in _POLICY_WORDS)
    return False


def _gather_index(call: ast.Call, roots: Set[str],
                  modules: Set[str]) -> Optional[ast.AST]:
    """The index operand when ``call`` is a gather, else None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    for kw in call.keywords:
        if kw.arg == "index":
            index_kw = kw.value
            break
    else:
        index_kw = None
    owner = dotted_name(fn.value)
    head = owner.split(".", 1)[0] if owner else None
    if head in roots and fn.attr in _TORCH_GATHERS:
        at = _TORCH_GATHERS[fn.attr]
    elif head in modules:
        return None           # asyncio.gather(...) and its kind
    elif fn.attr in _METHOD_GATHERS:
        at = _METHOD_GATHERS[fn.attr]
    else:
        return None
    if len(call.args) > at:
        return call.args[at]
    return index_kw


def _gather_findings(mod: Module) -> List[Finding]:
    assert mod.tree is not None
    aliases = module_alias_map(mod)
    roots = _torch_roots(mod)
    modules = set(aliases) - roots
    out: List[Finding] = []

    def visit(node: ast.AST, stack: List[ast.AST]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack = stack + [node]
        if isinstance(node, ast.Call):
            idx = _gather_index(node, roots, modules)
            if (idx is not None and not _index_is_safe(idx, stack)
                    and not mod.line_allows(node.lineno, _GATHER)):
                out.append(Finding(
                    rule=_GATHER, path=mod.rel, line=node.lineno,
                    message="gather with an index that is not provably "
                            "bounded — out of range on the card it is a "
                            "device-side assert that kills the CUDA "
                            "context",
                    hint="bound the index (clamp / where) before the "
                         "gather only where that leaves the result "
                         "unchanged, check its range, state the caller "
                         "contract in the enclosing docstring, or "
                         "suppress with '# pio-lint: allow=gather-clip' "
                         "and say why the index is in bounds"))
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    visit(mod.tree, [mod.tree])
    return out


def run(modules: Sequence[Module]) -> List[Finding]:
    out: List[Finding] = []
    for mod in modules:
        if mod.tree is None:
            continue
        if not mod.module_allows(_IMPLICIT):
            out.extend(_implicit_findings(mod))
        if not mod.module_allows(_GATHER) and any(
                s in mod.source for s in ("index_select(", "gather(",
                                          "take(")):
            out.extend(_gather_findings(mod))
    return out


PASS = Pass(
    name="host-sync",
    rules=(_IMPLICIT, _GATHER),
    doc="no implicit device->host syncs on torch values; gathers bound "
        "their indices (a bad one is a device assert on the card)",
    run=run)
