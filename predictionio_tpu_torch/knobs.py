"""The reference's environment variables, as the port treats each one.

The names are the port's registry's (``common/declarations.py``'s
``ENV_VARS``) less the port's own (``declarations.PORT_ONLY``:
``PIO_TORCH_DEVICE`` and ``PIO_TORCH_KERNEL_DIR``), so the table cannot
drift from what the ``declarations`` lint pass holds the code to. Each
name is one of three kinds:

- ``READ``: the port reads it, with the reference's meaning (the
  registry's one-liner);
- ``INERT``: it tunes something the port has no use for (a TPU layout,
  the XLA compile cache) or tunes a feature that another row refuses, so
  setting it changes nothing a user of the port could see;
- ``UNPORTED``: it turns on a feature the port lacks. :func:`refuse_unported`
  raises ``ValueError`` at the entry points (the CLI's ``train``,
  ``eval``, ``deploy``, ``eventserver``, ``import``, ``export``,
  ``dashboard``, ``adminserver``, ``storageserver`` and ``foldin``,
  ``run_train``, ``run_evaluation`` and ``QueryAPI``) when such a variable is set to a value that turns the
  feature on, naming the variable, the feature and the ROADMAP item that
  brings it. Unset, ``0``
  and ``off`` stay accepted. A row's refusal goes when its slice lands.

Only the INERT and UNPORTED rows are spelled out here. Of the 118 rows,
108 are read, 10 inert and none refused: the last refusal
(``PIO_SERVE_DEVICE_MS``) went when the host-vs-device serving probe
landed. The refusal machinery stays for any later row.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from predictionio_tpu_torch.common import declarations

READ = "read"
INERT = "inert"
UNPORTED = "unported"

TRAIN, EVAL, DEPLOY = "train", "eval", "deploy"
EVENTSERVER, IMPORT, EXPORT = "eventserver", "import", "export"
DASHBOARD, ADMINSERVER, FOLDIN = "dashboard", "adminserver", "foldin"
STORAGESERVER = "storageserver"
#: the verbs that serve HTTP (``pio router`` too, which refuses nothing)
DAEMONS = (DEPLOY, EVENTSERVER, DASHBOARD, ADMINSERVER, STORAGESERVER)
ALL_VERBS = (TRAIN, EVAL, DEPLOY, EVENTSERVER, IMPORT, EXPORT, DASHBOARD,
             ADMINSERVER, STORAGESERVER, FOLDIN)


@dataclass(frozen=True)
class Knob:
    kind: str
    #: READ / INERT: what the port does with it; UNPORTED: the feature
    what: str
    #: UNPORTED: the entry points that refuse it
    verbs: Tuple[str, ...] = ()
    #: UNPORTED: the ROADMAP item that brings the feature
    roadmap: str = ""
    #: UNPORTED: values besides unset, 0 and off that leave the feature off
    also_off: Tuple[str, ...] = ()


def _read(what: str) -> Knob:
    return Knob(READ, what)


def _inert(what: str) -> Knob:
    return Knob(INERT, what)


def _unported(what: str, roadmap: str, verbs=(DEPLOY,),
              also_off: Tuple[str, ...] = ()) -> Knob:
    return Knob(UNPORTED, what, tuple(verbs), roadmap, also_off)


_GRAM = ("TPU layout tuning of the hybrid Gram; the port runs one Gram for "
         "every PIO_ALS_KERNEL")

#: the names the port does not simply read; every other name of the
#: registry is READ, with the registry's one-liner as its meaning
_NOT_READ: Dict[str, Knob] = {
    "PIO_DISABLE_NATIVE": _inert(
        "the reference's native counting sort; the port sorts with torch"),
    "PIO_ALS_SOLVER": _inert(
        "settled: kernel A runs on the card for either value"),
    "PIO_ALS_HOT_K": _inert(_GRAM),
    "PIO_ALS_DENSE_MIN_COUNT": _inert(_GRAM),
    "PIO_ALS_XPAD": _inert(_GRAM),
    "PIO_AOT_KS": _inert(
        "the warm-up's k set; k selects no kernel instantiation, so the "
        "warm-up runs one k"),
    "PIO_AOT_PRUNE": _inert(
        "the warm-up's bucket pruning; a bucket changes only a launch's "
        "grid, so every bucket is warmed"),
    "PIO_AOT_THREADS": _inert(
        "the reference's prebuild pool; the warm-up's launches run in "
        "order on one stream"),
    "PIO_COMPILE_CACHE_DIR": _inert(
        "the XLA compile cache; the port's kernels build once into "
        "PIO_TORCH_KERNEL_DIR"),
    "PIO_COMPILE_CACHE_MIN_S": _inert("the XLA compile cache"),
}

KNOBS: Dict[str, Knob] = {
    name: _NOT_READ.get(name) or _read(what)
    for name, what in declarations.ENV_VARS.items()
    if name not in declarations.PORT_ONLY}

_OFF = ("", "0", "off")


def _is_off(knob: Knob, raw: str) -> bool:
    """Does ``raw`` leave an UNPORTED knob's feature off?"""
    v = raw.strip().lower()
    if v in _OFF or v in knob.also_off:
        return True
    try:
        return float(v) == 0.0
    except ValueError:
        return False


def refuse_unported(verb: str,
                    environ: Optional[Mapping[str, str]] = None) -> None:
    """Raise ValueError when a variable set in ``environ`` (the process
    environment by default) asks ``verb`` for a feature the port lacks."""
    env = os.environ if environ is None else environ
    for name, knob in KNOBS.items():
        if knob.kind != UNPORTED or verb not in knob.verbs:
            continue
        raw = env.get(name)
        if raw is None or _is_off(knob, raw):
            continue
        accepted = " / ".join(["unset", "0", "off", *knob.also_off])
        raise ValueError(
            f"{name}={raw} asks for {knob.what}, which the PyTorch port "
            f"does not have yet; ROADMAP {knob.roadmap} brings it. "
            f"Accepted here: {accepted}")
