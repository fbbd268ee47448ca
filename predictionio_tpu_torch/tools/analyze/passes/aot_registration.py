"""Warm-up registration coverage (the torch form of
``predictionio_tpu/tools/analyze/passes/aot_registration.py``).

Every device entry point on the serving path must be registered with the
warm-up (``serving/aot.register_entry``, the counterpart of the
reference's ``register_jit``). The reference's cliff is a lazy XLA
compile on the first request; the port's is a kernel library built by
``nvcc`` and loaded into the process on the first query that launches
it, after ``/readyz`` said ready. A registered entry is one the warm-up
runs, or whose note says why nothing needs warming.

A *device entry*, in torch terms, is a public def that launches a hand
kernel: directly, through a handle from ``ops/_kernels.load``, or
through a private launcher of its own module (a ``_``-prefixed def that
reaches such a handle, as ``topk_fused._launch`` and ``_launch_merge``
and ``solve._launch`` do). A public def that reaches a kernel only
through another module's public entry is not one: that entry is held
where it is defined.

The serving scope is the reference's, structural: the whole ``serving/``
package, every module that calls ``register_entry``, and every module
that a registration resolves into (``register_entry("n", topk.f)``
brings ``ops/topk.py`` in). A registered function name covers the def of
that name; a genuinely non-serving launcher in the scope takes a
``# pio-lint: allow=aot-unregistered-jit`` pragma with its reason. The
runtime half (each deploy kind's warm-up calls every registered serving
entry its queries call) is ``tests/test_torch_lint.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import (
    Module, dotted_name, from_import_aliases, module_alias_map,
    registration_calls,
)

_RULE = "aot-unregistered-jit"

_SERVING_PKG = "predictionio_tpu_torch/serving/"
_KERNELS = "predictionio_tpu_torch.ops._kernels"


def registered_fn_names(modules: Sequence[Module]) -> Set[str]:
    """Final attribute or name of the second arg of every
    ``register_entry`` call (``topk.topk_for_user`` -> ``topk_for_user``)."""
    out: Set[str] = set()
    for mod in modules:
        for node in registration_calls(mod):
            target = node.args[1]
            if isinstance(target, ast.Name):
                out.add(target.id)
            elif isinstance(target, ast.Attribute):
                out.add(target.attr)
    return out


def serving_scope(modules: Sequence[Module]) -> List[Module]:
    """Modules held to the registration rule (see module docstring)."""
    referenced: Set[str] = set()
    for mod in modules:
        calls = registration_calls(mod)
        if not calls:
            continue
        aliases = module_alias_map(mod)
        for node in calls:
            target = node.args[1]
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)):
                modname = aliases.get(target.value.id, "")
                if modname:
                    referenced.add(modname.replace(".", "/") + ".py")
    return [mod for mod in modules if mod.tree is not None and (
        mod.rel.startswith(_SERVING_PKG) or registration_calls(mod)
        or mod.rel in referenced)]


def _loads(mod: Module) -> Set[str]:
    """The dotted call names that hand out a kernel library's handle."""
    names = {"_kernels.load", f"{_KERNELS}.load"}
    names |= from_import_aliases(mod, _KERNELS, "load")
    for alias, target in module_alias_map(mod).items():
        if target == _KERNELS:
            names.add(f"{alias}.load")
    return names


def device_entries(mod: Module) -> List[ast.FunctionDef]:
    """The module's public defs that launch a hand kernel (see the
    module docstring), in source order."""
    loads = _loads(mod)
    defs = [n for n in mod.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    calls: Dict[int, Set[str]] = {
        id(fn): {dn for c in ast.walk(fn) if isinstance(c, ast.Call)
                 for dn in [dotted_name(c.func)] if dn}
        for fn in defs}
    launchers: Set[str] = set()
    grew = True
    while grew:
        grew = False
        for fn in defs:
            if (fn.name.startswith("_") and fn.name not in launchers
                    and calls[id(fn)] & (loads | launchers)):
                launchers.add(fn.name)
                grew = True
    out = [fn for fn in defs if not fn.name.startswith("_")
           and calls[id(fn)] & (loads | launchers)]
    return sorted(out, key=lambda fn: fn.lineno)


def run(modules: Sequence[Module]) -> List[Finding]:
    registered = registered_fn_names(modules)
    out: List[Finding] = []
    for mod in serving_scope(modules):
        if mod.module_allows(_RULE):
            continue
        for fn in device_entries(mod):
            if fn.name in registered or mod.line_allows(fn.lineno, _RULE):
                continue
            out.append(Finding(
                rule=_RULE, path=mod.rel, line=fn.lineno,
                message=f"def '{fn.name}' on the serving path launches a "
                        "hand kernel but is not registered with the "
                        "warm-up: its first launch after /readyz would "
                        "build and load the kernel library on a query's "
                        "path",
                hint="register it via serving/aot.register_entry and warm "
                     "it in the deploy's programs before /readyz; for a "
                     "genuinely non-serving launcher in a serving module, "
                     "suppress with '# pio-lint: "
                     "allow=aot-unregistered-jit' and say why",
                detail=fn.name))
    return out


PASS = Pass(
    name="aot-registration",
    rules=(_RULE,),
    doc="every def on the serving path that launches a hand kernel is "
        "registered with the warm-up (no kernel build or load after "
        "/readyz)",
    run=run)
