"""Engine factory resolution and engine.json reading (port of
``predictionio_tpu/workflow/workflow_utils.py``).

An engine instance or engine.json written for the JAX package names its
factory under ``predictionio_tpu.`` (the JAX package's own engine.json
and every instance its ``pio train`` stores do). Importing that would
import jax, so the port resolves such a path to its
``predictionio_tpu_torch.`` counterpart, and raises, naming the missing
counterpart, when the port has none. Any other path (an engine template's
own module) is imported as it is.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from typing import Any, Dict, Optional

from predictionio_tpu_torch.controller.engine import Engine

_JAX_PKG = "predictionio_tpu"
_PORT_PKG = "predictionio_tpu_torch"


def _split(path: str):
    if ":" in path:
        return path.split(":", 1)
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(
            f"cannot resolve {path!r}: expected 'module:attr' or "
            "'module.attr'")
    return module_name, attr


def port_path(path: str) -> str:
    """``path`` with a ``predictionio_tpu`` module mapped to the port's
    counterpart; any other path unchanged."""
    module_name, attr = _split(path)
    if module_name == _JAX_PKG or module_name.startswith(_JAX_PKG + "."):
        return f"{_PORT_PKG}{module_name[len(_JAX_PKG):]}:{attr}"
    return path


def load_object(path: str, base_dir: Optional[str] = None) -> Any:
    """Resolve "module.sub:attr" (or "module.sub.attr") to an object,
    mapping the JAX package to the port (:func:`port_path`); ``base_dir``
    (the engine directory) goes first on sys.path."""
    if base_dir and base_dir not in sys.path:
        sys.path.insert(0, os.path.abspath(base_dir))
    resolved = port_path(path)
    module_name, attr = _split(resolved)
    ported = resolved != path
    try:
        obj = importlib.import_module(module_name)
        for part in attr.split("."):
            obj = getattr(obj, part)
    except (ModuleNotFoundError, AttributeError) as e:
        missing = getattr(e, "name", None)
        if ported and (isinstance(e, AttributeError)
                       or (missing and module_name.startswith(missing))):
            raise ValueError(
                f"{path!r} names the JAX package; the PyTorch port has no "
                f"counterpart {resolved!r} yet") from None
        raise
    return obj


def get_engine(engine_factory: str, base_dir: Optional[str] = None) -> Engine:
    """An Engine, or a factory returning one, named by ``engine_factory``."""
    obj = load_object(engine_factory, base_dir)
    if isinstance(obj, Engine):
        return obj
    if callable(obj):
        engine = obj()
        if isinstance(engine, Engine):
            return engine
    raise TypeError(
        f"{engine_factory!r} is neither an Engine nor a factory returning one")


def read_engine_variant(engine_dir: str,
                        variant: str = "engine.json") -> Dict[str, Any]:
    """Load + minimally validate an engine variant file."""
    path = variant if os.path.isabs(variant) else os.path.join(engine_dir,
                                                               variant)
    with open(path) as f:
        variant_json = json.load(f)
    for key in ("id", "engineFactory"):
        if key not in variant_json:
            raise ValueError(f"{path}: missing required field {key!r}")
    return variant_json
