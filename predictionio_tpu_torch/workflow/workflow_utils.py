"""Engine factory resolution (port of the deploy half of
``predictionio_tpu/workflow/workflow_utils.py``)."""

from __future__ import annotations

import importlib
import os
import sys
from typing import Any, Optional

from predictionio_tpu_torch.controller.engine import Engine


def load_object(path: str, base_dir: Optional[str] = None) -> Any:
    """Resolve "module.sub:attr" (or "module.sub.attr") to an object;
    ``base_dir`` (the engine directory) goes first on sys.path."""
    if base_dir and base_dir not in sys.path:
        sys.path.insert(0, os.path.abspath(base_dir))
    if ":" in path:
        module_name, attr = path.split(":", 1)
    else:
        module_name, _, attr = path.rpartition(".")
        if not module_name:
            raise ValueError(
                f"cannot resolve {path!r}: expected 'module:attr' or "
                "'module.attr'")
    obj = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
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
