"""Batch views: cached columnar snapshots of an app's events (port of
``predictionio_tpu/data/view.py``).

Parity for the reference's deprecated-but-shipped view layer
(data/src/main/scala/org/apache/predictionio/data/view/):

- :class:`EventSeq` + :class:`LBatchView` — in-memory event sequence with
  predicate filters and ordered per-entity folds (LBatchView.scala:115-185).
- :func:`create` — the ``DataView.create`` analogue (DataView.scala:40-113):
  run a conversion function over an app's events, cache the result as a
  **columnar .npz snapshot** keyed by (name, app, time window, version), and
  return it as a dict of numpy column arrays. The reference caches a Spark
  DataFrame as parquet; here it is a struct-of-arrays snapshot, each
  column of which ``torch.from_numpy(col).to(device)`` moves to the card
  in one copy, with no row pivoting.

The reference deprecates these in favor of L/PEventStore; we keep the same
guidance (prefer `data.store.find_columnar` for training ingestion) but the
cached-snapshot path is genuinely useful for repeated eval sweeps, so
`create` is first-class here rather than vestigial.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import logging
import os
import tempfile
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, TypeVar)

import numpy as np

from predictionio_tpu_torch.data.aggregate import aggregate_properties as _agg
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, EventValidation
from predictionio_tpu_torch.data.storage import Storage, get_storage

T = TypeVar("T")


class EventSeq:
    """A filterable, foldable sequence of events (LBatchView.scala:115-143)."""

    def __init__(self, events: Iterable[Event]):
        self.events: List[Event] = list(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def filter(
        self,
        event: Optional[str] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> "EventSeq":
        """Conjunctive predicate filter (ViewPredicates, LBatchView.scala:31-75).

        `start_time` is exclusive and `until_time` exclusive-upper, matching
        the reference's getStartTimePredicate (strictly-after:
        ``!(isBefore || isEqual)``, LBatchView.scala:39-41) and
        getUntilTimePredicate (strictly-before). NOTE this deliberately
        differs from the storage-level `find` (inclusive start) — the
        reference has the same asymmetry between its DB query and this
        deprecated in-memory filter, and we preserve it for parity.
        """
        out = self.events
        if event is not None:
            out = [e for e in out if e.event == event]
        if start_time is not None:
            out = [e for e in out if e.event_time > start_time]
        if until_time is not None:
            out = [e for e in out if e.event_time < until_time]
        if entity_type is not None:
            out = [e for e in out if e.entity_type == entity_type]
        if predicate is not None:
            out = [e for e in out if predicate(e)]
        return EventSeq(out)

    def aggregate_by_entity_ordered(
            self, init: T, op: Callable[[T, Event], T]) -> Dict[str, T]:
        """Group by entityId, fold each group in eventTime order
        (LBatchView.scala:134-140)."""
        groups: Dict[str, List[Event]] = {}
        for e in self.events:
            groups.setdefault(e.entity_id, []).append(e)
        out: Dict[str, T] = {}
        for eid, evs in groups.items():
            acc = init
            for e in sorted(evs, key=lambda ev: ev.event_time):
                acc = op(acc, e)
            out[eid] = acc
        return out


class LBatchView:
    """Lazy batch view over one app's events (LBatchView.scala:146-185)."""

    def __init__(self, app_id: int,
                 start_time: Optional[_dt.datetime] = None,
                 until_time: Optional[_dt.datetime] = None,
                 storage: Optional[Storage] = None):
        self.app_id = app_id
        self.start_time = start_time
        self.until_time = until_time
        self._storage = storage
        self._events: Optional[EventSeq] = None

    @property
    def events(self) -> EventSeq:
        if self._events is None:
            storage = self._storage or get_storage()
            self._events = EventSeq(storage.get_events().find(
                app_id=self.app_id, start_time=self.start_time,
                until_time=self.until_time))
        return self._events

    def aggregate_properties(
        self,
        entity_type: str,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Dict[str, PropertyMap]:
        """$set/$unset/$delete fold per entity (LBatchView.scala:169-184);
        the fold itself is data/aggregate.py (LEventAggregator parity)."""
        seq = self.events.filter(entity_type=entity_type,
                                 start_time=start_time,
                                 until_time=until_time,
                                 predicate=lambda e:
                                 EventValidation.is_special_event(e.event))
        return _agg(seq.events)


# ---------------------------------------------------------------------------
# DataView.create: cached columnar snapshot (DataView.scala:40-113)
# ---------------------------------------------------------------------------

_COLUMN_KINDS = (str, int, float, bool, np.integer, np.floating, np.bool_)


def _columnar(rows: Sequence[Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Rows of homogeneous dicts → struct-of-arrays. Strings become numpy
    unicode arrays; ints/floats/bools native dtypes. Non-scalar values are
    rejected up front: an object-dtype column would save (pickled) but then
    fail every allow_pickle=False load, poisoning the cache entry."""
    if not rows:
        return {}
    cols: Dict[str, list] = {k: [] for k in rows[0].keys()}
    is_str: Dict[str, bool] = {}
    for row in rows:
        if row.keys() != cols.keys():
            raise ValueError(
                f"conversion function returned inconsistent keys: "
                f"{sorted(row.keys())} vs {sorted(cols.keys())}")
        for k, v in row.items():
            if not isinstance(v, _COLUMN_KINDS):
                raise ValueError(
                    f"conversion function returned non-scalar column "
                    f"{k!r}={v!r} ({type(v).__name__}); columns must be "
                    f"str/int/float/bool")
            # a mixed str/number column would be silently *string-coerced*
            # by np.asarray (not object dtype) — reject it explicitly
            if is_str.setdefault(k, isinstance(v, str)) != isinstance(v, str):
                raise ValueError(
                    f"column {k!r} mixes strings and numbers "
                    f"(got {v!r} after a "
                    f"{'string' if is_str[k] else 'numeric'} value)")
            cols[k].append(v)
    out = {k: np.asarray(v) for k, v in cols.items()}
    # backstop for anything that still coerced to object dtype (e.g. a
    # Python int beyond int64) — an object column would pickle on save
    # but fail every allow_pickle=False load
    bad = [k for k, a in out.items() if a.dtype == object]
    if bad:
        raise ValueError(
            f"columns {bad} did not coerce to a numeric/string dtype "
            f"(e.g. out-of-int64-range integers)")
    return out


def _snapshot_path(base_dir: str, name: str, app_name: str,
                   channel_name: Optional[str],
                   begin: _dt.datetime, end: _dt.datetime,
                   version: str) -> str:
    h = hashlib.sha256(
        "\x00".join([name, app_name, channel_name or "",
                     begin.isoformat(), end.isoformat(), version]).encode()
    ).hexdigest()[:16]
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in f"{name}-{app_name}")
    return os.path.join(base_dir, f"{safe}-{h}.npz")


def create(
    app_name: str,
    conversion_function: Callable[[Event], Optional[Mapping[str, Any]]],
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    name: str = "view",
    version: str = "",
    base_dir: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> Dict[str, np.ndarray]:
    """Events → cached columnar snapshot (DataView.scala:40-113 parity).

    `conversion_function` maps each Event to a flat dict of scalar columns
    (or None to drop it). The columnar result is cached as an .npz under
    ``base_dir`` (default ``$PIO_FS_BASEDIR/view``) keyed by the time window
    and `version` — bump `version` when the conversion function changes,
    exactly the reference's contract. A cache hit never touches the event
    store.

    CACHING REQUIRES AN EXPLICIT `until_time`: with the default None the
    window's end is fixed at "now" (reference behavior, DataView.scala:78-81),
    which lands in the cache key — every call gets a fresh key, re-reads the
    store, and writes a snapshot nothing will ever read back.
    """
    from predictionio_tpu_torch.data import store as _store

    begin = start_time if start_time is not None else \
        _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    end = until_time if until_time is not None else \
        _dt.datetime.now(_dt.timezone.utc)  # fix "now", like the reference

    if base_dir is None:
        base_dir = os.path.join(
            os.environ.get("PIO_FS_BASEDIR",
                           os.path.join(tempfile.gettempdir(), "pio")),
            "view")
    os.makedirs(base_dir, exist_ok=True)
    path = _snapshot_path(base_dir, name, app_name, channel_name,
                          begin, end, version)

    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    rows: List[Mapping[str, Any]] = []
    for e in _store.find(app_name, channel_name=channel_name,
                         start_time=start_time, until_time=end,
                         storage=storage):
        row = conversion_function(e)
        if row is not None:
            rows.append(row)
    cols = _columnar(rows)

    if until_time is None:
        # "now" landed in the cache key: the entry is unreachable by
        # construction, so writing it would only accumulate orphaned .npz
        # files under base_dir (see docstring)
        logging.getLogger("predictionio_tpu_torch.data.view").warning(
            "view.create(name=%r) called without until_time: the snapshot "
            "cache is keyed on a fixed 'now' and can never be hit again, "
            "so no snapshot is written. Pass an explicit until_time to "
            "enable caching.", name)
        return cols

    # unique temp name: concurrent misses on the same key each write their
    # own file and the replace is last-writer-wins on identical content
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=base_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **cols)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
