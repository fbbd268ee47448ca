"""Storage registry of the port (the memory backend of
``predictionio_tpu/data/storage/__init__.py``).

``PIO_STORAGE_SOURCES_<NAME>_TYPE=memory`` plus
``PIO_STORAGE_REPOSITORIES_{METADATA,MODELDATA}_SOURCE=<NAME>`` select
it, as in the JAX package; with no configuration the port uses one
memory source. SQLite arrives with the training slice.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from predictionio_tpu_torch.data.storage import memory
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance, EngineInstances, Model, Models,
)

__all__ = [
    "EngineInstance", "EngineInstances", "Model", "Models", "Storage",
    "get_storage",
]

MetaData = "METADATA"
ModelData = "MODELDATA"


class Storage:
    """The metadata and model repositories. Usually the module singleton
    (:func:`get_storage`); instantiable for tests. Each repository's
    source must be of type ``memory``, the one backend ported so far."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        env = dict(env if env is not None else os.environ)
        prefix = "PIO_STORAGE_SOURCES_"
        sources = {k[len(prefix):-len("_TYPE")]: v.lower()
                   for k, v in env.items()
                   if k.startswith(prefix) and k.endswith("_TYPE")}
        for repo in (MetaData, ModelData):
            src = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            kind = "memory" if src is None else sources.get(src)
            if kind is None:
                raise RuntimeError(f"Undefined storage source: {src}")
            if kind != "memory":
                raise RuntimeError(
                    f"storage backend {kind!r} is not ported yet; the port "
                    "provides 'memory'")
        self._instances = memory.MemoryEngineInstances()
        self._models = memory.MemoryModels()

    def get_meta_data_engine_instances(self) -> EngineInstances:
        return self._instances

    def get_model_data_models(self) -> Models:
        return self._models


_storage: Optional[Storage] = None
_storage_lock = threading.Lock()


def get_storage() -> Storage:
    global _storage
    with _storage_lock:
        if _storage is None:
            _storage = Storage()
        return _storage
