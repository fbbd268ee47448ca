"""In-memory storage backend (port of the engine-instance and model
DAOs of ``predictionio_tpu/data/storage/memory.py``)."""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Dict, List, Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model


class MemoryEngineInstances(base.EngineInstances):
    def __init__(self, client=None, config=None, namespace: str = ""):
        self._by_id: Dict[str, EngineInstance] = {}
        self._lock = threading.RLock()

    def insert(self, i: EngineInstance) -> str:
        instance_id = i.id or uuid.uuid4().hex
        with self._lock:
            self._by_id[instance_id] = dataclasses.replace(i, id=instance_id)
        return instance_id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._by_id.get(instance_id)

    def get_all(self) -> List[EngineInstance]:
        return list(self._by_id.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = [
            i for i in self._by_id.values()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        rows.sort(key=lambda i: i.start_time, reverse=True)
        return rows

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: EngineInstance) -> None:
        with self._lock:
            self._by_id[i.id] = i

    def delete(self, instance_id: str) -> None:
        with self._lock:
            self._by_id.pop(instance_id, None)


class MemoryModels(base.Models):
    def __init__(self, client=None, config=None, namespace: str = ""):
        self._by_id: Dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, m: Model) -> None:
        with self._lock:
            self._by_id[m.id] = m

    def get(self, model_id: str) -> Optional[Model]:
        return self._by_id.get(model_id)

    def delete(self, model_id: str) -> None:
        with self._lock:
            self._by_id.pop(model_id, None)
