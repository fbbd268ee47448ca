"""Purity of the registered device entry points (the torch form of
``predictionio_tpu/tools/analyze/passes/jit_purity.py``).

The reference bans clocks, host RNG, I/O and global mutation inside
jit-traced bodies, where they run once at trace time and are frozen
into the program. The port traces nothing, but the bodies registered
with the warm-up (``serving/aot.register_entry``, resolved across
modules) play the same part:

- the warm-up replays them before ``/readyz`` for every shape a query
  or a tick gives them, and a later CUDA graph of the serve would
  capture exactly these bodies, replaying the launches without running
  the Python again;
- a clock, a host RNG draw, an environment read or I/O inside one makes
  a query's path or answer depend on when it ran (and under a graph,
  on when it was captured);
- deploy-time configuration is resolved once, in ``prepare_serving``
  and the layouts it builds (``QuantizedServing.build`` resolves the
  fused tile and mode), as the reference resolves its tile as a traced
  constant (``ops/topk_pallas.py:51``).

Launch counters (``global launches``) live in the private launchers
(``topk_fused._launch``, ``_launch_merge``, ``solve._launch``), never in
a registered body.

Rules (the reference's ids, so reports and baselines read alike):

- ``jit-wall-clock``: any ``time.*`` call;
- ``jit-nondeterminism``: ``random.*`` / ``np.random.*`` draws, and
  torch's generator-drawing functions (``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``,
  their ``_like`` forms, the in-place ``uniform_`` / ``normal_`` /
  ``random_`` / ``bernoulli_`` / ``exponential_``) without an explicit
  ``generator=``, which draw from the process-global generator; one
  with an explicit generator is the seeded alternative and is not
  flagged;
- ``jit-io``: ``open()`` / ``print()`` / ``input()`` / ``logging`` calls
  and ``os.environ`` / ``os.getenv`` reads;
- ``jit-global-mutation``: ``global`` / ``nonlocal`` declarations.
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Set, Tuple

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.passes import Pass
from predictionio_tpu_torch.tools.analyze.walker import (
    Module, dotted_name, registered_entry_defs,
)

_WALL = "jit-wall-clock"
_RAND = "jit-nondeterminism"
_IO = "jit-io"
_GLOBAL = "jit-global-mutation"

_IO_NAMES = frozenset({"open", "print", "input"})
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like"})
_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_"})


def _seeded(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _rule_for_call(call: ast.Call) -> Tuple[str, str]:
    """(rule, description) for an impure call, or ("", "")."""
    dn = dotted_name(call.func)
    if dn:
        head = dn.split(".", 1)[0]
        if head == "time":
            return _WALL, f"{dn}()"
        if dn.startswith("np.random.") or dn.startswith("numpy.random."):
            return _RAND, f"{dn}()"
        if head == "random":
            return _RAND, f"{dn}()"
        if (dn.startswith("torch.") and dn.split(".")[-1] in _TORCH_DRAWS
                and dn.count(".") == 1 and not _seeded(call)):
            return _RAND, f"{dn}()"
        if dn.startswith("os.environ") or dn == "os.getenv":
            return _IO, f"{dn}()"
        if head in ("logging", "logger", "log"):
            return _IO, f"{dn}()"
        if dn in _IO_NAMES:
            return _IO, f"{dn}()"
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _INPLACE_DRAWS and not _seeded(call)):
        return _RAND, f".{call.func.attr}()"
    return "", ""


_CONSEQUENCE = {
    _WALL: "makes the query's path depend on when it ran (and a "
           "captured graph would replay the capture's value)",
    _RAND: "draws from the process-global generator, so the answer "
           "depends on every draw before it (pass an explicit "
           "generator instead)",
    _IO: "runs on every query and is not replayed by a captured graph "
         "(resolve configuration in prepare_serving)",
}


def _body_findings(mod: Module, name: str,
                   fn: ast.FunctionDef) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            if not mod.line_allows(node.lineno, _GLOBAL):
                kw = ("global" if isinstance(node, ast.Global)
                      else "nonlocal")
                out.append(Finding(
                    rule=_GLOBAL, path=mod.rel, line=node.lineno,
                    message=f"{kw} mutation inside registered entry "
                            f"'{name}' is state a warm-up replay or a "
                            "captured graph does not repeat",
                    hint="return the value and let the caller store "
                         "it, or move the state update into a private "
                         "launcher outside the registered body",
                    detail=f"{name}:{kw}"))
            continue
        if (isinstance(node, ast.Subscript)
                and dotted_name(node.value) == "os.environ"
                and not mod.line_allows(node.lineno, _IO)):
            out.append(Finding(
                rule=_IO, path=mod.rel, line=node.lineno,
                message=f"os.environ[...] inside registered entry "
                        f"'{name}' {_CONSEQUENCE[_IO]}",
                hint="hoist the read out of the registered body; pass "
                     "the value in as an argument"))
            continue
        if not isinstance(node, ast.Call):
            continue
        rule, desc = _rule_for_call(node)
        if not rule or mod.line_allows(node.lineno, rule):
            continue
        out.append(Finding(
            rule=rule, path=mod.rel, line=node.lineno,
            message=f"{desc} inside registered entry '{name}' "
                    f"{_CONSEQUENCE[rule]}",
            hint="hoist the call out of the registered body; pass the "
                 "value in as an argument if the entry needs it"))
    return out


def run(modules: Sequence[Module]) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for mod, fn in registered_entry_defs(modules):
        if (mod.rel, fn.lineno) in seen:
            continue
        seen.add((mod.rel, fn.lineno))
        out.extend(_body_findings(mod, fn.name, fn))
    return out


PASS = Pass(
    name="jit-purity",
    rules=(_WALL, _RAND, _IO, _GLOBAL),
    doc="no clocks, host RNG, env reads, I/O or global mutation inside "
        "the device entries registered with the warm-up (it replays "
        "them; a CUDA graph would capture them)",
    run=run)
