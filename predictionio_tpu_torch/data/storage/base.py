"""Storage records and DAO interfaces (port of
``predictionio_tpu/data/storage/base.py``): events, apps, access
keys, channels, the engine-instance ledger and model blobs.

An ``App`` names the event stream a DataSource reads; an ``AccessKey``
lets a client write to it (all events, or a listed few); a ``Channel``
is a named stream of its own within the app; ``Events`` stores and
queries them; an ``EngineInstance`` row names a train run and its
params; a ``Model`` row holds that run's serialized model blob; an
``EvaluationInstance`` row names a ``pio eval`` run and holds its
results. ``Events.aggregate_properties`` folds an entity type's
``$set``/``$unset``/``$delete`` events into current properties.
"""

from __future__ import annotations

import abc
import datetime as _dt
import random
import re
import string
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.data.aggregate import (
    EVENT_NAMES, aggregate_properties, aggregate_properties_single,
)
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event


@dataclass(frozen=True)
class App:
    """An app record (Apps.scala:32-35)."""
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    """An access key (AccessKeys.scala:35-38); empty events = all allowed."""
    key: str
    appid: int
    events: Sequence[str] = ()


@dataclass(frozen=True)
class Channel:
    """A named event channel within an app (Channels.scala:32-37)."""
    id: int
    name: str
    appid: int

    NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(Channel.NAME_RE.match(s))

    def __post_init__(self):
        if not Channel.is_valid_name(self.name):
            raise ValueError(
                f"Invalid channel name: {self.name}. Must consist of 1 to 16 "
                "alphanumeric and '-' characters."
            )


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
class EvaluationInstance:
    """An eval-run ledger row (EvaluationInstances.scala:42-56)."""
    id: str = ""
    status: str = ""
    start_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc))
    end_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc))
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    runtime_conf: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


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


class EvaluationInstances(abc.ABC):
    """EvaluationInstances DAO (EvaluationInstances.scala:58-90)."""

    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> None: ...

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
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Remove all data for (app, channel)."""

    @abc.abstractmethod
    def close(self) -> None:
        """Release client connections."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event; returns its generated event ID."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Default per-event loop (LEvents.scala:106-112)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        """Get one event by ID."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        """Delete one event by ID; returns whether it existed."""

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

    # -- aggregation (LEvents.scala:215-302) --------------------------------
    def aggregate_properties(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "",
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Every entity of ``entity_type`` with its current properties;
        with ``required``, only entities holding all of those keys."""
        if not entity_type:
            raise ValueError("entity_type is required for aggregate_properties")
        events = self.find(
            app_id=app_id, channel_id=channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type,
            event_names=list(EVENT_NAMES),
        )
        result = aggregate_properties(events)
        if required:
            req = list(required)
            result = {
                k: v for k, v in result.items() if all(r in v for r in req)
            }
        return result

    def aggregate_properties_of_entity(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        entity_type: str = "",
        entity_id: str = "",
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Optional[PropertyMap]:
        """One entity's current properties, or None."""
        if not entity_type or not entity_id:
            raise ValueError(
                "entity_type and entity_id are required for "
                "aggregate_properties_of_entity")
        events = self.find(
            app_id=app_id, channel_id=channel_id,
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=list(EVENT_NAMES),
        )
        return aggregate_properties_single(events)


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

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    """AccessKeys DAO (AccessKeys.scala:45-75)."""

    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert; generates a key when k.key is empty; returns the key,
        or None when it is taken."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    @staticmethod
    def generate_key() -> str:
        """64-char URL-safe random key (AccessKeys.scala insert default)."""
        alphabet = string.ascii_letters + string.digits
        return "".join(random.SystemRandom().choice(alphabet)
                       for _ in range(64))


class Channels(abc.ABC):
    """Channels DAO (Channels.scala:63-90)."""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]:
        """Insert; generates an ID when channel.id == 0; returns the ID."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...

