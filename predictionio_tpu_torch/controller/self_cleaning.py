"""SelfCleaningDataSource: sliding-window event cleanup (port of
``predictionio_tpu/controller/self_cleaning.py``).

Reference: core/.../core/SelfCleaningDataSource.scala:42-326 — a DataSource
mixin that (a) windows events to a duration (keeping $set/$unset), (b)
compacts each entity's $set/$unset history into one $set, (c) removes
duplicate events, and can write the cleaned stream back to the event store
(wipe = insert cleaned diff + delete superseded rows).

The reference's local-path compressLProperties groups by entityType ONLY
(SelfCleaningDataSource.scala:119-126), collapsing distinct entities of
a type into one event — its P path (:107-117) groups by (entityType,
entityId). This module, like the JAX package's, uses the (entityType,
entityId) grouping on the one path it has.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import Iterable, List, Optional, Tuple

from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event, utcnow


@dataclasses.dataclass(frozen=True)
class EventWindow:
    """EventWindow (SelfCleaningDataSource.scala:322-326)."""
    duration: Optional[str] = None       # e.g. "3 days", "12 hours"
    remove_duplicates: bool = False
    compress_properties: bool = False


_DURATION_UNITS = {
    "ms": 0.001, "millisecond": 0.001, "milliseconds": 0.001,
    "s": 1, "sec": 1, "second": 1, "seconds": 1,
    "m": 60, "min": 60, "minute": 60, "minutes": 60,
    "h": 3600, "hour": 3600, "hours": 3600,
    "d": 86400, "day": 86400, "days": 86400,
}


def parse_duration(s: str) -> _dt.timedelta:
    """Scala-Duration-style strings: "<n> <unit>" ("3 days", "12h")."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]+)\s*", s)
    if not m or m.group(2).lower() not in _DURATION_UNITS:
        raise ValueError(f"cannot parse duration {s!r}")
    return _dt.timedelta(
        seconds=float(m.group(1)) * _DURATION_UNITS[m.group(2).lower()])


def _is_set_event(e: Event) -> bool:
    return e.event in ("$set", "$unset")


def _compress(events: List[Event]) -> Event:
    """Fold one entity's time-ordered $set/$unset chain into ONE $set event
    holding the surviving fields (SelfCleaningDataSource.compress,
    :301-320 — but always emitting $set: seeding from events[0] verbatim
    would mislabel a chain that starts with $unset and corrupt the
    aggregate on replay)."""
    fields: dict = {}
    for e in events:
        if e.event == "$unset":
            fields = {k: v for k, v in fields.items()
                      if k not in e.properties.fields}
        else:
            fields.update(e.properties.fields)
    return dataclasses.replace(
        events[0], event="$set", properties=DataMap(fields),
        event_time=events[-1].event_time)


class SelfCleaningDataSource:
    """Mixin for DataSources; subclass sets `app_name` and `event_window`
    (the reference's abstract appName/eventWindow members)."""

    app_name: str = ""
    event_window: Optional[EventWindow] = None

    # ---------------------------------------------------------------- query
    def get_cleaned_events(self, events: Iterable[Event],
                           now: Optional[_dt.datetime] = None) -> List[Event]:
        """Window filter: keep events newer than `duration` plus all
        $set/$unset (getCleanedPEvents/getCleanedLEvents, :76-105)."""
        events = list(events)
        if self.event_window is None or self.event_window.duration is None:
            return events
        cutoff = (now or utcnow()) - parse_duration(self.event_window.duration)
        return [e for e in events
                if e.event_time > cutoff or _is_set_event(e)]

    def compress_properties(self, events: Iterable[Event]) -> List[Event]:
        """One compacted $set per (entityType, entityId)
        (compressPProperties, :107-117)."""
        groups: dict = {}
        rest = []
        for e in events:
            if _is_set_event(e):
                groups.setdefault((e.entity_type, e.entity_id), []).append(e)
            else:
                rest.append(e)
        compressed = [
            _compress(sorted(ls, key=lambda e: e.event_time))
            for ls in groups.values()]
        return compressed + rest

    def remove_duplicates(self, events: Iterable[Event]) -> List[Event]:
        """Keep the first (eventTime-ascending) of each set of events that
        are identical modulo eventId/eventTime/creationTime
        (removePDuplicates, :128-143)."""
        seen = {}
        for e in sorted(events, key=lambda e: e.event_time):
            key = (e.event, e.entity_type, e.entity_id,
                   e.target_entity_type, e.target_entity_id,
                   e.properties, e.tags, e.pr_id)
            if key not in seen:
                seen[key] = e
        return list(seen.values())

    def clean_events(self, storage=None,
                     now: Optional[_dt.datetime] = None,
                     events: Optional[List[Event]] = None) -> List[Event]:
        """Window + optional compress + optional dedupe over the app's
        events (cleanPEvents/cleanLEvents, :231-246, :283-299). Pass
        `events` to clean an already-fetched snapshot."""
        if events is None:
            events = list(store.find(self.app_name, storage=storage))
        events = self.get_cleaned_events(events, now=now)
        ew = self.event_window
        if ew is not None:
            if ew.compress_properties:
                events = self.compress_properties(events)
            if ew.remove_duplicates:
                events = self.remove_duplicates(events)
        return events

    # ---------------------------------------------------------------- write
    def clean_persisted_events(self, storage=None,
                               now: Optional[_dt.datetime] = None) -> None:
        """Apply the cleanup to the event store: insert the cleaned diff,
        delete superseded rows (cleanPersistedPEvents + wipe, :160-226)."""
        if self.event_window is None:
            return
        from predictionio_tpu_torch.data.storage import get_storage
        storage = storage or get_storage()
        # one snapshot feeds both sides of the diff: a second read could
        # race concurrent writes and delete rows it never considered
        original = list(store.find(self.app_name, storage=storage))
        result = self.clean_events(storage=storage, now=now,
                                   events=list(original))

        def key(e: Event) -> Tuple:
            return (e.event, e.entity_type, e.entity_id,
                    e.target_entity_type, e.target_entity_id,
                    e.properties, e.event_time)

        # multiset accounting so exact duplicates beyond the kept copy are
        # removed and compacted rows replace their sources
        from collections import Counter
        budget = Counter(key(e) for e in result)
        original_count = Counter(key(e) for e in original)
        new_events = []
        for e in result:
            k = key(e)
            if original_count[k] > 0:
                original_count[k] -= 1
            else:
                new_events.append(e)
        to_remove = []
        for e in sorted(original, key=lambda e: e.event_time):
            k = key(e)
            if budget[k] > 0:
                budget[k] -= 1
            elif e.event_id:
                to_remove.append(e.event_id)

        app_id, channel_id = store._resolve_app(self.app_name, None, storage)
        events_dao = storage.get_events()
        for e in new_events:
            events_dao.insert(
                dataclasses.replace(e, event_id=None), app_id, channel_id)
        for event_id in to_remove:
            events_dao.delete(event_id, app_id, channel_id)
