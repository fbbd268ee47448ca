"""The Event value type and validation rules (the port's copy of
``predictionio_tpu/data/event.py``).

Behavioral parity with the reference's Event/EventValidation
(data/src/main/scala/org/apache/predictionio/data/storage/Event.scala:42-167):
reserved `$`-prefixed and `pio_`-prefixed names, the special events
`$set/$unset/$delete`, target-entity pairing rules, and the `pio_pr`
built-in entity type.
"""

from __future__ import annotations

import datetime as _dt
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

from predictionio_tpu_torch.data.datamap import DataMap

UTC = _dt.timezone.utc


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def utcnow_ms() -> _dt.datetime:
    """Now, pre-truncated to the millisecond precision Events carry —
    the shared batch timestamp the ingest path passes to
    :meth:`Event.from_dict` (truncating here makes the per-event
    ``__post_init__`` truncation a no-op)."""
    t = _dt.datetime.now(tz=UTC)
    return t.replace(microsecond=(t.microsecond // 1000) * 1000)


def _truncate_ms(t: _dt.datetime) -> _dt.datetime:
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    us = t.microsecond
    # already ms-precision (e.g. a shared batch timestamp): no rebuild —
    # datetime.replace allocates, and the ingest path truncates twice
    # per event
    return t if us % 1000 == 0 else t.replace(microsecond=us - us % 1000)


def tree_has_non_finite(obj) -> bool:
    """True if any float in a JSON-ready tree is NaN/Inf — shared by the
    ingest gate (below) and the serving gate (workflow/create_server.py):
    both sides of the strict-JSON transport reject the same values."""
    import math
    if isinstance(obj, float):
        return not math.isfinite(obj)
    if isinstance(obj, dict):
        return any(tree_has_non_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(tree_has_non_finite(v) for v in obj)
    return False


def parse_event_time(value: Optional[str],
                     default: Optional[_dt.datetime] = None) -> _dt.datetime:
    """Parse an ISO-8601 timestamp; naive times are taken as UTC.
    ``default`` replaces the per-call ``utcnow()`` for absent values —
    the batch ingest path stamps every event of one request with a
    single shared arrival time instead of 2 clock reads per event."""
    if value is None:
        return default if default is not None else utcnow()
    s = value.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    t = _dt.datetime.fromisoformat(s)
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t


#: memo for format_event_time — event times are ms-truncated, so the
#: ingest hot path formats the SAME instant dozens of times per batch
#: (every event of a request defaults to "now"); equal datetimes hash
#: equally across timezones, so the cached string is always the right
#: one. Bounded by a wholesale clear (bulk exports format unbounded
#: distinct historical times).
_FMT_CACHE: Dict[_dt.datetime, str] = {}


def format_event_time(t: _dt.datetime) -> str:
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    s = _FMT_CACHE.get(t)
    if s is None:
        s = (t.astimezone(UTC).isoformat(timespec="milliseconds")
             .replace("+00:00", "Z"))
        if len(_FMT_CACHE) >= 4096:
            _FMT_CACHE.clear()
        _FMT_CACHE[t] = s
    return s


@dataclass(frozen=True)
class Event:
    """A single event in the Event Store (Event.scala:42-53)."""

    event: str
    entity_type: str
    entity_id: str
    event_id: Optional[str] = None
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=utcnow)
    tags: Tuple[str, ...] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=utcnow)

    def __post_init__(self):
        # Times are millisecond precision (joda DateTime parity); list tags
        # are coerced to tuples so Events stay hashable.
        object.__setattr__(self, "event_time", _truncate_ms(self.event_time))
        object.__setattr__(self, "creation_time", _truncate_ms(self.creation_time))
        if not isinstance(self.tags, tuple):
            object.__setattr__(self, "tags", tuple(self.tags))

    def with_event_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    # -- JSON wire format (EventJson4sSupport.scala field names) ------------
    def to_dict(self, with_event_id: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if with_event_id and self.event_id is not None:
            d["eventId"] = self.event_id
        d["event"] = self.event
        d["entityType"] = self.entity_type
        d["entityId"] = self.entity_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        d["properties"] = self.properties.to_dict()
        d["eventTime"] = format_event_time(self.event_time)
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        d["creationTime"] = format_event_time(self.creation_time)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], validate: bool = True,
                  now: Optional[_dt.datetime] = None) -> "Event":
        """Parse the API wire format; raises ValueError on malformed input.

        Storage backends reconstructing already-persisted rows pass
        validate=False so one bad historical row cannot poison reads.
        ``now`` supplies the default event/creation time for items that
        omit them — the batch ingest path passes one shared (already
        ms-truncated) arrival timestamp per request instead of reading
        the clock twice per event.
        """
        if not isinstance(d, dict):
            raise ValueError("event JSON must be an object")
        try:
            name = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise ValueError(f"field {e.args[0]} is required") from None
        for f in ("event", "entityType", "entityId"):
            if not isinstance(d[f], str):
                raise ValueError(f"field {f} must be a string")
        props = d.get("properties") or {}
        if not isinstance(props, dict):
            raise ValueError("field properties must be an object")
        if validate and tree_has_non_finite(props):
            # python's json.loads accepts bare NaN/Infinity tokens, but the
            # read side emits STRICT JSON (data/api/http.py) — accepting a
            # non-finite property here would make every later read or
            # export of that event a permanent 500
            raise ValueError(
                "properties must not contain NaN or Infinity values")
        tags = d.get("tags") or ()
        if not isinstance(tags, (list, tuple)):
            raise ValueError("field tags must be an array")
        # direct construction: reproduces __init__ + __post_init__ exactly
        # (ms truncation, UTC coercion, tags tuple) without the generated
        # dataclass __init__'s per-field plumbing — the wire parse is the
        # ingest hot path and this is its dominant term (measured)
        get = d.get
        ev = object.__new__(cls)
        st = object.__setattr__
        st(ev, "event", name)
        st(ev, "entity_type", entity_type)
        st(ev, "entity_id", entity_id)
        st(ev, "event_id", get("eventId"))
        st(ev, "target_entity_type", get("targetEntityType"))
        st(ev, "target_entity_id", get("targetEntityId"))
        st(ev, "properties", DataMap(props))
        st(ev, "event_time",
           _truncate_ms(parse_event_time(get("eventTime"), now)))
        st(ev, "tags", tuple(str(t) for t in tags) if tags else ())
        st(ev, "pr_id", get("prId"))
        st(ev, "creation_time",
           _truncate_ms(parse_event_time(get("creationTime"), now)))
        if validate:
            EventValidation.validate(ev)
        return ev

    @classmethod
    def from_json(cls, s: str, validate: bool = True) -> "Event":
        return cls.from_dict(json.loads(s), validate=validate)


class EventValidation:
    """Validation rules for events (Event.scala:68-167)."""

    default_time_zone = UTC
    special_events = {"$set", "$unset", "$delete"}
    builtin_entity_types = {"pio_pr"}
    builtin_properties: set = set()

    @staticmethod
    def is_reserved_prefix(name: str) -> bool:
        return name.startswith("$") or name.startswith("pio_")

    @classmethod
    def is_special_event(cls, name: str) -> bool:
        return name in cls.special_events

    @classmethod
    def is_builtin_entity_type(cls, name: str) -> bool:
        return name in cls.builtin_entity_types

    @classmethod
    def validate(cls, e: Event) -> None:
        # Plain conditionals, not a req(cond, msg) helper: the helper
        # shape evaluates every message f-string on every call, which
        # is measurable at ingest rates — messages here are built only
        # on the failing path. Same rules, same strings.
        if not e.event:
            raise ValueError("event must not be empty.")
        if not e.entity_type:
            raise ValueError("entityType must not be empty string.")
        if not e.entity_id:
            raise ValueError("entityId must not be empty string.")
        if e.target_entity_type == "":
            raise ValueError("targetEntityType must not be empty string")
        if e.target_entity_id == "":
            raise ValueError("targetEntityId must not be empty string.")
        if (e.target_entity_type is None) != (e.target_entity_id is None):
            raise ValueError(
                "targetEntityType and targetEntityId must be specified "
                "together.")
        if e.event == "$unset" and e.properties.is_empty:
            raise ValueError("properties cannot be empty for $unset event")
        if cls.is_reserved_prefix(e.event):
            if not cls.is_special_event(e.event):
                raise ValueError(
                    f"{e.event} is not a supported reserved event name.")
            if (e.target_entity_type is not None
                    or e.target_entity_id is not None):
                raise ValueError(
                    f"Reserved event {e.event} cannot have targetEntity")
        if (cls.is_reserved_prefix(e.entity_type)
                and not cls.is_builtin_entity_type(e.entity_type)):
            raise ValueError(
                f"The entityType {e.entity_type} is not allowed. "
                "'pio_' is a reserved name prefix.")
        if (e.target_entity_type is not None
                and cls.is_reserved_prefix(e.target_entity_type)
                and not cls.is_builtin_entity_type(e.target_entity_type)):
            raise ValueError(
                f"The targetEntityType {e.target_entity_type} is not "
                "allowed. 'pio_' is a reserved name prefix.")
        for k in e.properties.key_set():
            if cls.is_reserved_prefix(k) and k not in cls.builtin_properties:
                raise ValueError(
                    f"The property {k} is not allowed. 'pio_' is a "
                    "reserved name prefix.")
