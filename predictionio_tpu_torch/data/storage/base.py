"""Storage records and DAO interfaces (port of
``predictionio_tpu/data/storage/base.py``): events, apps, the
engine-instance ledger and model blobs.

An ``App`` names the event stream a DataSource reads; ``Events`` stores
and queries it; an ``EngineInstance`` row names a train run and its
params; a ``Model`` row holds that run's serialized model blob. Access
keys, channels, evaluation instances and property aggregation wait for
the slices that use them.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event


@dataclass(frozen=True)
class App:
    """An app record (Apps.scala:32-35)."""
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class EngineInstance:
    """A train-run ledger row (EngineInstances.scala:46-68)."""
    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    runtime_conf: Dict[str, str] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass(frozen=True)
class Model:
    """A serialized model blob keyed by EngineInstance id."""
    id: str
    models: bytes


class EngineInstances(abc.ABC):
    """EngineInstances DAO (EngineInstances.scala:69-110)."""

    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class Models(abc.ABC):
    """Model blob DAO (Models.scala:45-60)."""

    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...


class Events(abc.ABC):
    """Event CRUD + query for one storage backend (LEvents.scala:40-513,
    synchronous)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize the backing store for (app, channel). Idempotent."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event; returns its generated event ID."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Default per-event loop (LEvents.scala:106-112)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
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
        """Query events, eventTime-ascending (descending when reversed_);
        limit None or -1 means all; filters are conjunctive. Pass
        ``target_entity_type=NONE_FILTER`` for "no target entity"."""


#: the reference's Some(None) target-entity filter: "only events with NO
#: target entity" (LEvents.scala:176-181)
NONE_FILTER = "__none__"


def match_target_filter(value: Optional[str], filt) -> bool:
    """None = no filter, NONE_FILTER = must be absent, str = must equal."""
    if filt is None:
        return True
    if filt == NONE_FILTER:
        return value is None
    return value == filt


def _utc(t):
    """Naive bounds are taken as UTC (EventValidation.defaultTimeZone)."""
    return t.replace(tzinfo=_dt.timezone.utc) if t.tzinfo is None else t


def event_matches(
    e: Event,
    start_time=None, until_time=None, entity_type=None, entity_id=None,
    event_names=None, target_entity_type=None, target_entity_id=None,
) -> bool:
    """The conjunctive filter every backend implements
    (LEvents.scala:162-207)."""
    if start_time is not None and e.event_time < _utc(start_time):
        return False
    if until_time is not None and e.event_time >= _utc(until_time):
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if not match_target_filter(e.target_entity_type, target_entity_type):
        return False
    return match_target_filter(e.target_entity_id, target_entity_id)


class Apps(abc.ABC):
    """Apps DAO (Apps.scala:43-72)."""

    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; generates an ID when app.id == 0; returns the ID, or
        None when the name or ID is taken."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

