"""Event store access for engines (port of the in-core training read of
``predictionio_tpu/data/store.py``).

- :func:`find_columnar` — one pass from the event store to **columnar
  numpy buffers** with vocab-encoded ids (the training read), through
  the backend's columnar ``read_columns`` when it has one (SQLite) and
  per event otherwise (memory), assigning vocab ids exactly as the
  reference does on the same backend;
- :func:`columnar_from_stream` — the same encode over a columnar chunk
  stream (the synthetic generator's), in-core;
- :func:`write` — bulk event insert.

The reference's device staging (``ops/staging.py``) and streamed
out-of-core read (``PIO_TRAIN_STREAM``) wait for a later slice:
:func:`check_train_stream` refuses ``PIO_TRAIN_STREAM=on`` rather than
train in-core behind the caller's back.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, get_storage


class StoreError(RuntimeError):
    pass


def _resolve_app(app_name: str, channel_name: Optional[str],
                 storage: Optional[Storage]) -> Tuple[int, Optional[int]]:
    """appName -> (appId, channelId). Channels wait for the event-server
    slice, so a named channel is refused."""
    storage = storage or get_storage()
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StoreError(
            f"Invalid app name {app_name}. Please use valid appName in your "
            "engine configuration.")
    if channel_name is not None:
        raise StoreError(
            f"channel {channel_name!r}: event channels are not ported yet; "
            "the port reads an app's default channel")
    return app.id, None


def check_train_stream() -> None:
    """The port reads in-core. ``PIO_TRAIN_STREAM`` ``auto`` and ``off``
    mean that here (the reference's ``auto`` streams only where device
    staging exists); ``on`` is refused."""
    if os.environ.get("PIO_TRAIN_STREAM", "").lower() == "on":
        raise ValueError(
            "PIO_TRAIN_STREAM=on asks for the streamed (out-of-core) "
            "training read, which the PyTorch port does not have yet; "
            "unset it or set it to auto/off to train in-core")


@dataclass
class ColumnarEvents:
    """Events in structure-of-arrays layout, vocab-encoded.
    ``entity_idx``/``target_idx`` are dense int32 via the BiMaps (-1 = no
    target); ``rating`` is the chosen numeric property (NaN where
    absent); ``event_name_idx`` indexes ``event_names``."""
    entity_ids: BiMap
    target_ids: BiMap
    event_names: List[str]
    entity_idx: np.ndarray       # (n,) int32
    target_idx: np.ndarray       # (n,) int32
    event_name_idx: np.ndarray   # (n,) int32
    rating: np.ndarray           # (n,) float32
    event_time_ms: np.ndarray    # (n,) int64

    @property
    def n(self) -> int:
        return int(self.entity_idx.shape[0])


def _columnar_from_codes(cols: Dict[str, object],
                         event_names: Optional[Sequence[str]],
                         entity_vocab: Optional[BiMap],
                         target_vocab: Optional[BiMap],
                         presence: Optional[Dict[str, np.ndarray]] = None,
                         ) -> ColumnarEvents:
    """Vectorized dict-code -> dense-vocab encode. A grown vocab assigns
    ids in dictionary-code order; a fixed vocab drops events whose
    (non-null) entity it does not hold. ``presence`` carries pool-presence
    masks the chunked read accumulated already."""
    pool: List[str] = cols["pool"]  # type: ignore[assignment]
    ecode = np.asarray(cols["entity_code"])
    tcode = np.asarray(cols["target_code"])
    ncode = np.asarray(cols["event_code"])
    rating = np.asarray(cols["rating"])
    tms = np.asarray(cols["time_ms"])

    def dense(codes, vocab, present):
        valid = codes >= 0  # -1 = event has no such entity (targets)
        if vocab is None:
            if present is None:
                present = np.bincount(
                    codes[valid], minlength=len(pool)).astype(bool)
            used = np.nonzero(present)[0]
            lut = np.full(len(pool), -1, np.int32)
            lut[used] = np.arange(used.size, dtype=np.int32)
            out_vocab = BiMap({pool[int(c)]: int(lut[c])
                               for c in used.tolist()})
            idx = np.where(valid, lut[np.maximum(codes, 0)],
                           -1).astype(np.int32)
            return idx, out_vocab, np.ones(codes.shape[0], dtype=bool)
        lut = np.full(len(pool), -1, np.int32)
        str2code = {s: c for c, s in enumerate(pool)}
        for s, i in vocab.to_dict().items():
            c = str2code.get(s)
            if c is not None:
                lut[c] = i
        idx = np.where(valid, lut[np.maximum(codes, 0)], -1).astype(np.int32)
        keep = ~(valid & (idx < 0))
        return idx, vocab, keep

    presence = presence or {}
    e_idx, e_vocab, e_keep = dense(ecode, entity_vocab,
                                   presence.get("entity"))
    t_idx, t_vocab, t_keep = dense(tcode, target_vocab,
                                   presence.get("target"))
    keep = e_keep & t_keep
    if not keep.all():
        e_idx, t_idx, ncode = e_idx[keep], t_idx[keep], ncode[keep]
        rating, tms = rating[keep], tms[keep]

    if event_names:
        name_order = list(event_names)
    else:
        name_order = [pool[int(c)] for c in np.unique(ncode).tolist()]
    name_lut = np.full(len(pool) + 1, -1, np.int32)
    for i, n in enumerate(name_order):
        try:
            name_lut[pool.index(n)] = i
        except ValueError:
            pass
    return ColumnarEvents(
        entity_ids=e_vocab, target_ids=t_vocab, event_names=name_order,
        entity_idx=e_idx, target_idx=t_idx,
        event_name_idx=name_lut[ncode].astype(np.int32),
        rating=rating.astype(np.float32), event_time_ms=tms.astype(np.int64),
    )


def columnar_from_stream(
    pool: List[str],
    chunks,
    event_names: Optional[Sequence[str]] = None,
    entity_vocab: Optional[BiMap] = None,
    target_vocab: Optional[BiMap] = None,
    timings: Optional[Dict[str, float]] = None,
) -> ColumnarEvents:
    """Consume a columnar chunk stream (dicts of entity_code /
    target_code / event_code / rating / time_ms against ``pool``) into
    vocab-encoded columns, in-core: vocab presence accumulates per chunk
    and the chunks are concatenated. ``timings`` receives read_io (time
    waiting on the stream) and read_encode."""
    parts = []
    e_present = (np.zeros(len(pool), dtype=bool)
                 if entity_vocab is None else None)
    t_present = (np.zeros(len(pool), dtype=bool)
                 if target_vocab is None else None)
    io_s = 0.0
    t_mark = _time.perf_counter()
    for ch in chunks:
        io_s += _time.perf_counter() - t_mark
        if e_present is not None:
            ec = ch["entity_code"]
            e_present[ec[ec >= 0]] = True
        if t_present is not None:
            tc = ch["target_code"]
            t_present[tc[tc >= 0]] = True
        parts.append(ch)
        t_mark = _time.perf_counter()
    t1 = _time.perf_counter()

    presence = {}
    if e_present is not None:
        presence["entity"] = e_present
    if t_present is not None:
        presence["target"] = t_present

    def cat(key, dtype):
        xs = [p[key] for p in parts]
        return np.concatenate(xs) if xs else np.empty(0, dtype=dtype)

    cols = {
        "pool": pool,
        "entity_code": cat("entity_code", np.int32),
        "target_code": cat("target_code", np.int32),
        "event_code": cat("event_code", np.int32),
        "rating": cat("rating", np.float32),
        "time_ms": cat("time_ms", np.int64),
    }
    out = _columnar_from_codes(cols, event_names, entity_vocab, target_vocab,
                               presence=presence)
    if timings is not None:
        timings["read_io"] = io_s
        timings["read_encode"] = _time.perf_counter() - t1
    return out


def find_columnar(
    app_name: str,
    channel_name: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    entity_type: Optional[str] = None,
    target_entity_type: Optional[str] = None,
    rating_property: str = "rating",
    entity_vocab: Optional[BiMap] = None,
    target_vocab: Optional[BiMap] = None,
    storage: Optional[Storage] = None,
    timings: Optional[Dict[str, float]] = None,
) -> ColumnarEvents:
    """Single-pass events -> columnar buffers + vocabs (the reference's
    BiMap.stringInt job plus the template's RDD chains). Pass pre-built
    vocabs to encode consistently with an earlier read. ``timings``
    receives {"read_io", "read_encode"} on the columnar path."""
    storage = storage or get_storage()
    events_dao = storage.get_events()
    app_id, channel_id = _resolve_app(app_name, channel_name, storage)
    if hasattr(events_dao, "read_columns"):
        t0 = _time.perf_counter()
        cols = events_dao.read_columns(
            app_id, channel_id, event_names=event_names,
            entity_type=entity_type, target_entity_type=target_entity_type,
            rating_property=rating_property)
        t1 = _time.perf_counter()
        out = _columnar_from_codes(cols, event_names, entity_vocab,
                                   target_vocab)
        if timings is not None:
            timings["read_io"] = t1 - t0
            timings["read_encode"] = _time.perf_counter() - t1
        return out
    events = events_dao.find(
        app_id=app_id, channel_id=channel_id, event_names=event_names,
        entity_type=entity_type, target_entity_type=target_entity_type)
    ename_index: Dict[str, int] = (
        {n: i for i, n in enumerate(event_names)} if event_names else {})
    e_fwd = dict(entity_vocab.to_dict()) if entity_vocab else {}
    t_fwd = dict(target_vocab.to_dict()) if target_vocab else {}
    grow_e, grow_t = entity_vocab is None, target_vocab is None

    ent, tgt, enm, rat, tms = [], [], [], [], []
    for e in events:
        # accept or drop an event before touching either vocab, so a
        # dropped event leaves no orphan vocab entry
        eid, tid = e.entity_id, e.target_entity_id
        if eid not in e_fwd and not grow_e:
            continue
        if tid is not None and tid not in t_fwd and not grow_t:
            continue
        if eid not in e_fwd:
            e_fwd[eid] = len(e_fwd)
        if tid is not None:
            if tid not in t_fwd:
                t_fwd[tid] = len(t_fwd)
            tgt.append(t_fwd[tid])
        else:
            tgt.append(-1)
        ent.append(e_fwd[eid])
        if e.event not in ename_index:
            ename_index[e.event] = len(ename_index)
        enm.append(ename_index[e.event])
        r = e.properties.get_opt(rating_property)
        try:
            rat.append(float(r) if r is not None else np.nan)
        except (TypeError, ValueError):
            rat.append(np.nan)
        tms.append(int(e.event_time.timestamp() * 1000))

    names_sorted = [n for n, _ in sorted(ename_index.items(),
                                         key=lambda kv: kv[1])]
    return ColumnarEvents(
        entity_ids=entity_vocab or BiMap(e_fwd),
        target_ids=target_vocab or BiMap(t_fwd),
        event_names=names_sorted,
        entity_idx=np.asarray(ent, dtype=np.int32),
        target_idx=np.asarray(tgt, dtype=np.int32),
        event_name_idx=np.asarray(enm, dtype=np.int32),
        rating=np.asarray(rat, dtype=np.float32),
        event_time_ms=np.asarray(tms, dtype=np.int64),
    )


def write(events: Sequence[Event], app_id: int,
          channel_id: Optional[int] = None,
          storage: Optional[Storage] = None) -> List[str]:
    """PEvents.write equivalent (PEvents.scala:172-185)."""
    storage = storage or get_storage()
    return storage.get_events().insert_batch(events, app_id, channel_id)
