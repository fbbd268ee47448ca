"""Event store access for engines (port of the in-core training read and
the engine lookups of ``predictionio_tpu/data/store.py``).

- :func:`find`, :func:`find_by_entity`, :func:`find_target_ids` — Event
  reads by app name (PEventStore.find, LEventStore.findByEntity), the
  templates' training reads and their live serve-time lookups;
- :func:`aggregate_properties`, :func:`extract_entity_map` — entities'
  current ``$set`` properties (PEventStore.aggregateProperties);
- :func:`find_columnar` — one pass from the event store to **columnar
  numpy buffers** with vocab-encoded ids (the training read): through
  the backend's chunk stream when it has one (eventlog:
  ``read_columns_streamed``, chunks decoding on a thread pool while the
  encode consumes them), its columnar ``read_columns`` otherwise
  (SQLite, and a ``remote`` source over one binary reply), and per event
  last (memory, or a remote source whose server's store has no columnar
  read), assigning vocab ids exactly as
  the reference does on the same backend;
- :func:`columnar_from_stream` — the encode over a columnar chunk stream
  (the eventlog's, the synthetic generator's), with two retention modes:
  in-core (host chunks kept and concatenated, byte-identical to the read
  that does not stream) or streamed (``PIO_TRAIN_STREAM``: each host
  chunk is dropped once it is copied to the device, so host memory stays
  O(chunk), and the encoded columns exist only as the device mirrors of
  ``ops/staging.py``);
- :func:`write` — bulk event insert.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import logging
import os
import time as _time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.data.bimap import BiMap, EntityMap
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.ops import staging

logger = logging.getLogger(__name__)


class StoreError(RuntimeError):
    pass


def _resolve_app(app_name: str, channel_name: Optional[str],
                 storage: Optional[Storage]) -> Tuple[int, Optional[int]]:
    """appName (+channel) -> (appId, channelId), mirroring Common.scala."""
    storage = storage or get_storage()
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StoreError(
            f"Invalid app name {app_name}. Please use valid appName in your "
            "engine configuration.")
    channel_id: Optional[int] = None
    if channel_name is not None:
        channels = storage.get_meta_data_channels().get_by_appid(app.id)
        match = next((c for c in channels if c.name == channel_name), None)
        if match is None:
            raise StoreError(
                f"Invalid channel name {channel_name} for app {app_name}.")
        channel_id = match.id
    return app.id, channel_id


def find(
    app_name: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
    limit: Optional[int] = None,
    storage: Optional[Storage] = None,
) -> Iterator[Event]:
    """Read events by app name (PEventStore.find, PEventStore.scala:59-97)."""
    storage = storage or get_storage()
    app_id, channel_id = _resolve_app(app_name, channel_name, storage)
    return storage.get_events().find(
        app_id=app_id, channel_id=channel_id,
        start_time=start_time, until_time=until_time,
        entity_type=entity_type, entity_id=entity_id,
        event_names=event_names,
        target_entity_type=target_entity_type,
        target_entity_id=target_entity_id,
        limit=limit,
    )


def find_target_ids(
    app_name: str,
    entity_type: str,
    entity_id: str,
    channel_name: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> List[str]:
    """Target entity ids of one entity's matching events, the serve-time
    seen-items lookup. A backend with a columnar ``find_target_ids``
    answers it directly; the others through :func:`find_by_entity`."""
    storage = storage or get_storage()
    events_dao = storage.get_events()
    if hasattr(events_dao, "find_target_ids"):
        app_id, channel_id = _resolve_app(app_name, channel_name, storage)
        return events_dao.find_target_ids(
            app_id, channel_id, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type)
    return [e.target_entity_id for e in find_by_entity(
        app_name, entity_type, entity_id, channel_name=channel_name,
        event_names=event_names, target_entity_type=target_entity_type,
        storage=storage) if e.target_entity_id is not None]


def find_by_entity(
    app_name: str,
    entity_type: str,
    entity_id: str,
    channel_name: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    limit: Optional[int] = None,
    latest: bool = True,
    storage: Optional[Storage] = None,
) -> List[Event]:
    """One entity's events, newest first unless ``latest`` is False
    (LEventStore.findByEntity, LEventStore.scala:61-115)."""
    storage = storage or get_storage()
    app_id, channel_id = _resolve_app(app_name, channel_name, storage)
    return list(storage.get_events().find(
        app_id=app_id, channel_id=channel_id,
        start_time=start_time, until_time=until_time,
        entity_type=entity_type, entity_id=entity_id,
        event_names=event_names,
        target_entity_type=target_entity_type,
        target_entity_id=target_entity_id,
        limit=limit, reversed_=latest,
    ))


def aggregate_properties(
    app_name: str,
    entity_type: str,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    required: Optional[Sequence[str]] = None,
    storage: Optional[Storage] = None,
) -> Dict[str, PropertyMap]:
    """PEventStore.aggregateProperties (PEventStore.scala:99-120)."""
    storage = storage or get_storage()
    app_id, channel_id = _resolve_app(app_name, channel_name, storage)
    return storage.get_events().aggregate_properties(
        app_id=app_id, channel_id=channel_id, entity_type=entity_type,
        start_time=start_time, until_time=until_time, required=required,
    )


def extract_entity_map(
    app_name: str,
    entity_type: str,
    extract,
    channel_name: Optional[str] = None,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    required: Optional[Sequence[str]] = None,
    storage: Optional[Storage] = None,
) -> EntityMap:
    """An entity type's aggregated properties, each turned into an object
    by ``extract(property_map)`` (PEvents.extractEntityMap,
    PEvents.scala:134-165). A failing extraction names its entity."""
    props = aggregate_properties(
        app_name, entity_type, channel_name=channel_name,
        start_time=start_time, until_time=until_time, required=required,
        storage=storage)
    id_to_data = {}
    for eid, dm in props.items():
        try:
            id_to_data[eid] = extract(dm)
        except Exception as e:
            raise StoreError(
                f"Failed to extract entity from DataMap of entityId "
                f"{eid!r}: {e}") from e
    return EntityMap(id_to_data)


@dataclass
class ColumnarEvents:
    """Events in structure-of-arrays layout, vocab-encoded.
    ``entity_idx``/``target_idx`` are dense int32 via the BiMaps (-1 = no
    target); ``rating`` is the chosen numeric property (NaN where
    absent); ``event_name_idx`` indexes ``event_names``.

    Under the streamed read (``columnar_from_stream(stream=True)``) the
    host arrays are None: the encoded columns exist only as the device
    mirrors ``staged`` (ops/staging.StagedColumns). ``stream_digest`` is
    a blake2b over the raw chunk columns of a chunked read, the content
    fingerprint the layout cache keys on."""
    entity_ids: BiMap
    target_ids: BiMap
    event_names: List[str]
    entity_idx: Optional[np.ndarray]       # (n,) int32; None when streamed
    target_idx: Optional[np.ndarray]       # (n,) int32
    event_name_idx: Optional[np.ndarray]   # (n,) int32
    rating: Optional[np.ndarray]           # (n,) float32
    event_time_ms: Optional[np.ndarray]    # (n,) int64
    #: device mirrors of the encoded arrays, value-identical to them
    staged: Optional[staging.StagedColumns] = None
    stream_digest: Optional[bytes] = None

    @property
    def n(self) -> int:
        if self.entity_idx is not None:
            return int(self.entity_idx.shape[0])
        return self.staged.n if self.staged is not None else 0


def _columnar_from_codes(cols: Dict[str, object],
                         event_names: Optional[Sequence[str]],
                         entity_vocab: Optional[BiMap],
                         target_vocab: Optional[BiMap],
                         presence: Optional[Dict[str, np.ndarray]] = None,
                         luts_out: Optional[Dict[str, object]] = None,
                         ) -> ColumnarEvents:
    """Vectorized dict-code -> dense-vocab encode. A grown vocab assigns
    ids in dictionary-code order; a fixed vocab drops events whose
    (non-null) entity it does not hold. ``presence`` carries pool-presence
    masks the chunked read accumulated already; ``luts_out`` receives the
    dense LUTs and whether every row was kept, which the device staging
    needs to replay the same remap."""
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
            return idx, out_vocab, np.ones(codes.shape[0], dtype=bool), lut
        lut = np.full(len(pool), -1, np.int32)
        str2code = {s: c for c, s in enumerate(pool)}
        for s, i in vocab.to_dict().items():
            c = str2code.get(s)
            if c is not None:
                lut[c] = i
        idx = np.where(valid, lut[np.maximum(codes, 0)], -1).astype(np.int32)
        keep = ~(valid & (idx < 0))
        return idx, vocab, keep, lut

    presence = presence or {}
    e_idx, e_vocab, e_keep, e_lut = dense(ecode, entity_vocab,
                                          presence.get("entity"))
    t_idx, t_vocab, t_keep, t_lut = dense(tcode, target_vocab,
                                          presence.get("target"))
    keep = e_keep & t_keep
    kept_all = bool(keep.all())
    if not kept_all:
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
    if luts_out is not None:
        luts_out.update(e_lut=e_lut, t_lut=t_lut, name_lut=name_lut,
                        kept_all=kept_all)
    return ColumnarEvents(
        entity_ids=e_vocab, target_ids=t_vocab, event_names=name_order,
        entity_idx=e_idx, target_idx=t_idx,
        event_name_idx=name_lut[ncode].astype(np.int32),
        rating=rating.astype(np.float32), event_time_ms=tms.astype(np.int64),
    )


def _overlap_enabled() -> bool:
    """``PIO_READ_OVERLAP=0`` turns the streamed decode-and-encode
    pipeline off (the read then runs read -> encode in sequence)."""
    return os.environ.get("PIO_READ_OVERLAP", "1") != "0"


def train_stream_mode() -> str:
    """``PIO_TRAIN_STREAM``, the out-of-core training knob:

    - ``auto`` (default): stream when the event source exposes a chunk
      stream and device staging is available (``PIO_READ_STAGE`` not 0);
      the warm-layout-cache veto lives in the template layer
      (als_algorithm.stream_wanted);
    - ``on``: force the streamed path (still requires staging: without
      it there is nowhere for the columns to live);
    - ``off``: the in-core path (host arrays kept, same read, encode and
      layout code).
    """
    mode = os.environ.get("PIO_TRAIN_STREAM", "auto").lower()
    return mode if mode in ("auto", "on", "off") else "auto"


def resolve_train_stream(chunk_src=None) -> bool:
    """Resolve :func:`train_stream_mode` against a chunk source (an
    events DAO with ``read_columns_streamed``, a synthetic ChunkSource,
    or None = capability only): does the training read run the
    O(chunk)-host streamed pipeline?"""
    mode = train_stream_mode()
    if mode == "off":
        return False
    if not staging.staging_available():
        if mode == "on":
            logger.warning(
                "PIO_TRAIN_STREAM=on but device staging is off "
                "(PIO_READ_STAGE=0); training in-core")
        return False
    if chunk_src is not None and not (
            hasattr(chunk_src, "read_columns_streamed")
            or hasattr(chunk_src, "chunks")):
        return False
    return True


#: the raw chunk columns the stream digest covers, in order
_DIGEST_KEYS = ("entity_code", "target_code", "event_code", "rating",
                "time_ms")


def columnar_from_stream(
    pool: List[str],
    chunks,
    event_names: Optional[Sequence[str]] = None,
    entity_vocab: Optional[BiMap] = None,
    target_vocab: Optional[BiMap] = None,
    stage: bool = True,
    stream: bool = False,
    timings: Optional[Dict[str, float]] = None,
    device: device_mod.DeviceLike = None,
) -> ColumnarEvents:
    """Consume a columnar chunk stream (dicts of entity_code /
    target_code / event_code / rating / time_ms against ``pool``) into
    vocab-encoded columns. Vocab presence accumulates per chunk and, with
    staging on (``stage`` or ``stream``, grown vocabs, ``PIO_READ_STAGE``
    not 0), each chunk is copied to ``device`` as it arrives. Two
    retention modes:

    - ``stream=False``: host chunks are kept and concatenated, the
      columns byte-identical to the read that does not stream; with
      staging, ``staged`` mirrors them on the device;
    - ``stream=True``: each host chunk is dropped once staged, so host
      memory stays O(chunk) + O(vocab); the host arrays are None and the
      encoded columns exist only as ``staged`` (value-identical to what
      the in-core read builds). Needs grown vocabs and staging, and reads
      in-core without them (a fixed vocab can drop rows, which needs the
      host columns).

    With grown vocabs, ``stream_digest`` is a blake2b over the raw chunk
    columns in both modes, so streamed and in-core trains of one store
    share layout-cache entries. ``timings`` receives read_io (time
    waiting on the stream) and read_encode."""
    grow_both = entity_vocab is None and target_vocab is None
    stager = (staging.ColumnStager(device)
              if (stage or stream) and grow_both
              and staging.staging_available() else None)
    stream = stream and stager is not None
    digest = hashlib.blake2b(digest_size=16) if grow_both else None
    parts = []
    name_codes: set = set()
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
        if stager is not None:
            stager.add(ch)
        if digest is not None:
            for key in _DIGEST_KEYS:
                digest.update(np.ascontiguousarray(ch[key]).view(np.uint8))
        if stream:
            # the host chunk dies here: the digest and the event-name
            # census are all of it that outlives the loop
            if event_names is None:
                name_codes.update(np.unique(ch["event_code"]).tolist())
        else:
            parts.append(ch)
        t_mark = _time.perf_counter()
    t1 = _time.perf_counter()

    presence = {}
    if e_present is not None:
        presence["entity"] = e_present
    if t_present is not None:
        presence["target"] = t_present

    luts: Dict[str, object] = {}
    if stream:
        out = _stream_vocabs(pool, presence, sorted(name_codes),
                             event_names, luts_out=luts)
    else:
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
        out = _columnar_from_codes(cols, event_names, entity_vocab,
                                   target_vocab, presence=presence,
                                   luts_out=luts)
    if digest is not None:
        out.stream_digest = digest.digest()
    if stager is not None and luts.get("kept_all"):
        out.staged = stager.finalize(luts["e_lut"], luts["t_lut"],
                                     luts["name_lut"])
    if timings is not None:
        timings["read_io"] = io_s
        timings["read_encode"] = _time.perf_counter() - t1
    return out


def _stream_vocabs(pool: List[str], presence: Dict[str, np.ndarray],
                   name_codes: Sequence[int],
                   event_names: Optional[Sequence[str]],
                   luts_out: Dict[str, object]) -> ColumnarEvents:
    """Vocabs and dense LUTs from the presence bitmaps alone (the streamed
    read's encode: no row arrays exist on the host). The id assignment,
    dictionary-code order over present codes, is
    ``_columnar_from_codes.dense``'s grow branch, so streamed and in-core
    reads of one store build identical BiMaps and the device remap
    reproduces the host encode value for value."""
    def dense(present):
        used = np.nonzero(present)[0]
        lut = np.full(len(pool), -1, np.int32)
        lut[used] = np.arange(used.size, dtype=np.int32)
        vocab = BiMap({pool[int(c)]: int(lut[c]) for c in used.tolist()})
        return vocab, lut

    e_vocab, e_lut = dense(presence["entity"])
    t_vocab, t_lut = dense(presence["target"])
    if event_names:
        name_order = list(event_names)
    else:
        name_order = [pool[int(c)] for c in name_codes]
    name_lut = np.full(len(pool) + 1, -1, np.int32)
    for i, n in enumerate(name_order):
        try:
            name_lut[pool.index(n)] = i
        except ValueError:
            pass
    luts_out.update(e_lut=e_lut, t_lut=t_lut, name_lut=name_lut,
                    kept_all=True)
    return ColumnarEvents(
        entity_ids=e_vocab, target_ids=t_vocab, event_names=name_order,
        entity_idx=None, target_idx=None, event_name_idx=None,
        rating=None, event_time_ms=None)


def _find_columnar_streamed(events_dao, app_id, channel_id, event_names,
                            entity_type, target_entity_type, rating_property,
                            entity_vocab, target_vocab, stage, timings,
                            stream=False, device=None):
    """The overlapped bulk read: the encode consumes per-chunk column
    arrays as the decode workers finish them (retention modes: see
    :func:`columnar_from_stream`)."""
    pool, chunks = events_dao.read_columns_streamed(
        app_id, channel_id, event_names=event_names,
        entity_type=entity_type, target_entity_type=target_entity_type,
        rating_property=rating_property)
    return columnar_from_stream(
        pool, chunks, event_names=event_names, entity_vocab=entity_vocab,
        target_vocab=target_vocab, stage=stage, stream=stream,
        timings=timings, device=device)


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
    stage: bool = False,
    stream: bool = False,
    device: device_mod.DeviceLike = None,
) -> ColumnarEvents:
    """Single-pass events -> columnar buffers + vocabs (the reference's
    BiMap.stringInt job plus the template's RDD chains). Pass pre-built
    vocabs to encode consistently with an earlier read. ``timings``
    receives {"read_io", "read_encode"} on the columnar paths.

    A backend with a chunk stream (eventlog) is read through it while
    ``PIO_READ_OVERLAP`` is not 0: ``stage=True`` also copies each chunk
    to ``device`` while later chunks decode (``ColumnarEvents.staged``),
    and ``stream=True`` keeps host memory O(chunk) (see
    :func:`columnar_from_stream`). Both engage only with grown vocabs and
    ``PIO_READ_STAGE`` not 0; the columns of ``stream=False`` are
    byte-identical to the read that does not stream."""
    storage = storage or get_storage()
    events_dao = storage.get_events()
    app_id, channel_id = _resolve_app(app_name, channel_name, storage)
    if hasattr(events_dao, "read_columns_streamed") and _overlap_enabled():
        return _find_columnar_streamed(
            events_dao, app_id, channel_id, event_names, entity_type,
            target_entity_type, rating_property, entity_vocab, target_vocab,
            stage, timings, stream=stream, device=device)
    if hasattr(events_dao, "read_columns"):
        t0 = _time.perf_counter()
        try:
            cols = events_dao.read_columns(
                app_id, channel_id, event_names=event_names,
                entity_type=entity_type,
                target_entity_type=target_entity_type,
                rating_property=rating_property)
        except NotImplementedError:
            # a remote source whose backing store has no columnar read
            # says so this way: the per-event path below reads it
            cols = None
        if cols is not None:
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
