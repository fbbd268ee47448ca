"""In-memory storage backend (port of the events, apps, engine-instance
and model DAOs of ``predictionio_tpu/data/storage/memory.py``; the
fold-in cursor methods wait for the fold-in slice)."""

from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    App, EngineInstance, Model, event_matches,
)

_ChannelKey = Tuple[int, Optional[int]]


class MemoryEvents(base.Events):
    def __init__(self, client=None, config=None, namespace: str = ""):
        self._store: Dict[_ChannelKey, Dict[str, Event]] = {}
        self._lock = threading.RLock()

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            self._store.setdefault((app_id, channel_id), {})
        return True

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        with self._lock:
            table = self._store.setdefault((app_id, channel_id), {})
            table[event_id] = event.with_event_id(event_id)
        return event_id

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            events = list(self._store.get((app_id, channel_id), {}).values())
        events = [
            e for e in events
            if event_matches(
                e, start_time, until_time, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id)
        ]
        events.sort(key=lambda e: e.event_time, reverse=reversed_)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)


class MemoryApps(base.Apps):
    def __init__(self, client=None, config=None, namespace: str = ""):
        self._by_id: Dict[int, App] = {}
        self._lock = threading.RLock()

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            if any(a.name == app.name for a in self._by_id.values()):
                return None
            app_id = app.id
            if app_id == 0:
                app_id = max(self._by_id.keys(), default=0) + 1
            if app_id in self._by_id:
                return None
            self._by_id[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self._by_id.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._by_id.values() if a.name == name), None)


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


class StorageClient:
    """Backend entry point the registry finds by naming convention."""

    def __init__(self, config):
        self.config = config
        self.client = None
