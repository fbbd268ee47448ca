"""`$set` / `$unset` / `$delete` property aggregation (port of
``predictionio_tpu/data/aggregate.py``; host Python, copied).

Behavioral parity with the reference's LEventAggregator
(LEventAggregator.scala:32-148) and PEventAggregator.scala:30-212:

- events are folded in eventTime order;
- `$set` merges properties (right-biased) into the current map, creating it
  if absent;
- `$unset` removes the listed keys; on an absent map it stays absent
  (it does NOT resurrect an empty map);
- `$delete` drops the map entirely;
- other event names are ignored;
- first/lastUpdated track the event times of all special events seen,
  including `$delete`s, so a later `$set` after a `$delete` keeps the
  original firstUpdated.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterable, Optional, Tuple

from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import Event

#: Event names that control aggregation (LEventAggregator.scala:91)
EVENT_NAMES = ["$set", "$unset", "$delete"]

_Prop = Tuple[Optional[DataMap], Optional[_dt.datetime], Optional[_dt.datetime]]


def _fold(prop: _Prop, e: Event) -> _Prop:
    dm, first, last = prop
    if e.event == "$set":
        dm = e.properties if dm is None else dm.union(e.properties)
    elif e.event == "$unset":
        dm = None if dm is None else dm.remove(e.properties.key_set())
    elif e.event == "$delete":
        dm = None
    else:
        return prop
    t = e.event_time
    first = t if first is None else min(first, t)
    last = t if last is None else max(last, t)
    return (dm, first, last)


def aggregate_properties_single(events: Iterable[Event]
                                ) -> Optional[PropertyMap]:
    """Fold one entity's events into its current PropertyMap, or None
    (LEventAggregator.aggregatePropertiesSingle, :70-88)."""
    prop: _Prop = (None, None, None)
    for e in sorted(events, key=lambda ev: ev.event_time):
        prop = _fold(prop, e)
    dm, first, last = prop
    if dm is None:
        return None
    return PropertyMap(dm.fields, first_updated=first, last_updated=last)


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Group by entityId then fold; entities whose map ends absent are
    dropped (LEventAggregator.aggregateProperties, :42-60)."""
    by_entity: Dict[str, list] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
