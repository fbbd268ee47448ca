"""Columnar append-only event log (port of
``predictionio_tpu/data/storage/eventlog.py``; the on-disk format is the
reference's, so a directory either package writes reads in the other).

The reference's scalable event store is HBase, designed around its read
pattern: time-range scans deserializing one Event object per row
(storage/hbase/.../HBEventsUtil.scala:84-131, HBPEvents.scala:63-88). The
training read here is different: bulk-load EVERYTHING for an (app,
channel) into columnar host buffers and copy them straight to the
device. This backend is an LSM-style log designed for that path:

- inserts append to a **write-ahead log** (``wal_<seq>.jsonl``, one JSON
  line per event, written before the insert is acknowledged) and to an
  in-memory buffer; at ``_FLUSH_AT`` events the buffer compacts into an
  immutable **columnar chunk** (``chunk_<seq>.npz``). The WAL is named
  after the chunk seq its rows will become, which makes flush and replay
  idempotent: the existence of ``chunk_<s>.npz`` supersedes
  ``wal_<s>.jsonl`` everywhere, so a crash between chunk publication and
  WAL removal neither duplicates rows on restart nor shows a concurrent
  reader the same rows twice. Chunk columns: int32 dictionary codes for
  every string field, int64 epoch-millis times, one float64 column (+ a
  was-int flag column) per numeric scalar property, and a packed JSON
  side-channel for everything else (non-numeric properties, tags, prId);
- the string dictionary is per-(app, channel), append-only
  (``dict.jsonl``); codes are stable across chunks so bulk reads
  concatenate with ZERO decoding or remapping — `read_columns` returns
  code arrays + the pool;
- event IDs are ``<shard-token>-<chunk_seq>-<row>`` — O(1) lookup, zero
  bytes stored; deletes are tombstones (``tombstones.json``).

Concurrency: ONE writer process per (app, channel) — the Event Server —
like the reference's region-server ownership. Readers are safe in any
process at any time: every read refreshes the dictionary and WAL tails by
file offset (chunks are immutable once written), so a deployed engine
server sees the ingesting server's events, including unflushed ones.
Within one event-server process, appends are RLock-serialized and any
number of HTTP connections share the writer. Concurrent appends
GROUP-COMMIT: inserts enlisting within one bounded window
(``PIO_WAL_GROUP_MS``, default 2 ms; 0 = per-append writes) share a
single WAL write+flush (+fsync per ``PIO_WAL_FSYNC``), and an insert only
returns — i.e. the HTTP 201 is only released — after its group's commit
lands, so "acknowledged" still implies "durable". Horizontal scale-out
shards by CHANNEL: each (app, channel) is an independent directory +
WAL + dictionary. A process must never open a WAL it does not own;
there is no file lock enforcing this (a deployment contract, as with the
reference's region assignment).

The generic `find` surface (full LEvents filter parity) is implemented with
vectorized chunk filters and materializes Event objects only for matching
rows, so the contract suite runs unmodified while the training path never
touches a Python object per event.
"""

from __future__ import annotations

import atexit
import datetime as _dt
import json
import logging
import os
import shutil
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    Events, event_matches,
)

logger = logging.getLogger(__name__)

_FLUSH_AT = 1 << 16  # buffered events per (app, channel) before compaction
_MAX_EXACT_INT = 1 << 53  # beyond float64 exactness -> JSON side-channel

#: a WAL group commit whose write+flush takes at least this long is a
#: STALL — journaled so ingest-latency spikes have a storage-side
#: timeline (fsync contention, a saturated disk) to join against
_WAL_STALL_S = 0.1


def _wal_group_ms() -> float:
    """Group-commit coalescing window (ms). Appends from concurrent
    inserts that land within one window share a single WAL write+flush
    (+fsync per :func:`_wal_fsync_mode`); the 201 ack is released only
    after that group commit lands. 0 disables grouping and restores the
    exact per-append legacy path."""
    raw = os.environ.get("PIO_WAL_GROUP_MS", "")
    try:
        v = float(raw) if raw else 2.0
    except ValueError:
        v = 2.0
    return max(0.0, v)


def _wal_fsync_mode() -> str:
    """WAL durability knob (``PIO_WAL_FSYNC``):

    - ``group`` (default): one ``os.fsync`` per group commit — every
      acknowledged event survives power loss, amortized over the group;
    - ``always``: fsync every append immediately, no coalescing wait —
      the strongest (and slowest) setting;
    - ``off``: never fsync; appends only reach the OS page cache.
      Survives a process crash, NOT a host power loss.
    """
    mode = os.environ.get("PIO_WAL_FSYNC", "group").lower()
    return mode if mode in ("group", "always", "off") else "group"


#: unconditional (legacy-tier) group-commit counters, mutated only under
#: the events lock; the registry histograms below mirror them when
#: PIO_TELEMETRY=1
WAL_GROUP_STATS: Dict[str, float] = {
    "commits": 0, "events": 0, "flush_s": 0.0, "max_events": 0}

#: chunks whose columns could not be memory-mapped and were loaded whole
#: instead, by reason (``compressed``, ``fortran``, ``object``,
#: ``local_header``, ``header:<exception>``); mirrored by the
#: ``pio_eventlog_chunk_map_fallbacks_total{reason}`` counter when
#: PIO_TELEMETRY=1, with one journal event per chunk
CHUNK_MAP_FALLBACKS: Dict[str, int] = {}
_CHUNK_MAP_LOCK = threading.Lock()


def chunk_map_fallbacks() -> int:
    """Chunks loaded whole since the process started (all reasons)."""
    with _CHUNK_MAP_LOCK:
        return sum(CHUNK_MAP_FALLBACKS.values())


def _count_chunk_map_fallback(path: str, reason: str) -> None:
    with _CHUNK_MAP_LOCK:
        CHUNK_MAP_FALLBACKS[reason] = CHUNK_MAP_FALLBACKS.get(reason, 0) + 1
    logger.warning("eventlog: chunk %s loaded whole (%s)", path, reason)
    journal.emit(
        "eventlog", f"chunk columns loaded whole, not mapped ({reason})",
        level=journal.WARN, path=path, reason=reason)
    from predictionio_tpu_torch.common import telemetry
    if telemetry.on():
        telemetry.registry().counter(
            "pio_eventlog_chunk_map_fallbacks_total",
            "eventlog chunks loaded whole instead of memory-mapped",
            labelnames=("reason",)).labels(reason=reason).inc()


def _wal_line(e: Event) -> str:
    """One WAL record: the event's wire dict as one compact JSON line
    (compact separators — the bytes are replay input, not a human
    surface, and the encode is on the ingest hot path)."""
    return json.dumps(e.to_dict(with_event_id=False),
                      separators=(",", ":")) + "\n"


class _WalGroup:
    """One open commit group: the WAL lines of every insert that enlisted
    since the previous commit, plus the gate their acks wait on. The
    first enlisted thread to claim leadership performs the single
    write+flush(+fsync) for everyone; a chunk compaction that supersedes
    the group (the rows are durable in the chunk) finishes it without
    writing a byte."""

    __slots__ = ("seq", "lines", "members", "event", "error", "done",
                 "_lead")

    def __init__(self, seq: int):
        self.seq = seq
        self.lines: List[str] = []
        self.members = 0
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.done = False
        self._lead = threading.Lock()

    def claim_leader(self) -> bool:
        return self._lead.acquire(blocking=False)

    def finish(self, error: Optional[BaseException]) -> None:
        self.error = error
        self.done = True
        self.event.set()


def _read_thread_count(explicit: Optional[int] = None) -> int:
    """Decode-worker count for bulk columnar reads.

    Priority: explicit argument >
    ``PIO_READ_THREADS`` env > min(8, cores). 1 disables the pool and
    decodes chunks serially in the calling thread — exactly the
    pre-parallel behavior."""
    if explicit is None:
        raw = os.environ.get("PIO_READ_THREADS", "")
        try:
            explicit = int(raw) if raw else 0
        except ValueError:
            explicit = 0
    if explicit and explicit > 0:
        return explicit
    try:
        cores = len(os.sched_getaffinity(0))   # cgroup-aware
    except AttributeError:   # pragma: no cover - non-linux
        cores = os.cpu_count() or 1
    return max(1, min(8, cores))


class StorageClient:
    """Directory holder (config PATH, default $PIO_FS_BASEDIR/eventlog)."""

    def __init__(self, config):
        path = config.properties.get("PATH")
        if not path:
            basedir = os.path.expanduser(
                os.environ.get("PIO_FS_BASEDIR", "~/.pio_store"))
            path = os.path.join(basedir, "eventlog")
        self.path = path
        os.makedirs(path, exist_ok=True)


def _millis(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return int(t.timestamp() * 1000)


def _from_millis(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)


def _is_exact_number(v) -> bool:
    if isinstance(v, bool):
        return False
    if isinstance(v, int):
        return abs(v) <= _MAX_EXACT_INT
    return isinstance(v, float)


class _Shard:
    """State for one (app_id, channel_id): dict, WAL/buffer, chunk files."""

    def __init__(self, root: str):
        self.root = root
        self.chunk_dir = os.path.join(root, "chunks")
        os.makedirs(self.chunk_dir, exist_ok=True)
        self.dict_path = os.path.join(root, "dict.jsonl")
        self.tomb_path = os.path.join(root, "tombstones.json")
        self.pool: List[str] = []
        self.codes: Dict[str, int] = {}
        self.dict_offset = 0
        self.refresh_dict()
        self.tombstones = set()
        if os.path.exists(self.tomb_path):
            with open(self.tomb_path, encoding="utf-8") as f:
                self.tombstones = set(json.load(f))
        # per-shard token baked into event IDs so an ID from one (app,
        # channel) never resolves in another (reference rowkeys embed a
        # UUID, HBEventsUtil.scala:84-131)
        token_path = os.path.join(root, "shard_id")
        if os.path.exists(token_path):
            with open(token_path, encoding="utf-8") as f:
                self.token = f.read().strip()
        else:
            import uuid

            self.token = uuid.uuid4().hex[:8]
            with open(token_path, "w", encoding="utf-8") as f:
                f.write(self.token)
        from collections import OrderedDict
        self.col_cache: "OrderedDict[int, Dict[str, np.ndarray]]" = (
            OrderedDict())
        self.col_sizes: Dict[int, int] = {}
        self.col_cache_bytes = 0
        seqs = self.chunk_seqs()
        self.next_seq = max(seqs) + 1 if seqs else 0
        # an older layout used a single truncated wal.jsonl; adopt it as
        # the WAL for the current seq so no acknowledged event is dropped
        legacy = os.path.join(root, "wal.jsonl")
        if os.path.exists(legacy) and not os.path.exists(
                self.wal_path_for(self.next_seq)):
            os.replace(legacy, self.wal_path_for(self.next_seq))
        self.buffer: List[Event] = []
        self.wal_offset = 0
        self.dirty = False  # True only after a LOCAL write (writer role)
        self.wal_group: Optional[_WalGroup] = None  # open commit group
        self.idx_cache: Dict[int, object] = {}
        self.refresh_wal()

    def wal_path_for(self, seq: int) -> str:
        return os.path.join(self.root, f"wal_{seq}.jsonl")

    # -- append-only file tailing (cross-process read-your-writes) ---------
    def refresh_dict(self) -> None:
        """Byte-exact dictionary tail: consume only newline-terminated
        entries, so a torn (partially written) last line — a crash mid-
        append, or a concurrent writer observed mid-write — is simply
        left pending instead of raising JSONDecodeError on every refresh.
        The strings in a torn tail were never referenced by any
        acknowledged event (insert appends the dictionary BEFORE the
        WAL), so nothing acknowledged is lost. A COMPLETE line that fails
        to parse is real corruption of positional state (dropping it
        would shift every later code) and stays a hard error, now with a
        diagnosable message."""
        if not os.path.exists(self.dict_path):
            return
        size = os.path.getsize(self.dict_path)
        if size == self.dict_offset:
            return
        start = self.dict_offset
        with open(self.dict_path, "rb") as f:
            f.seek(start)
            data = f.read()
        end = data.rfind(b"\n")
        if end < 0:
            return  # torn/in-progress tail only: retry on a later refresh
        offset = start
        for line in data[: end + 1].split(b"\n")[:-1]:
            try:
                s = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise ValueError(
                    f"eventlog dictionary corrupted at {self.dict_path} "
                    f"offset {offset}: {e}") from None
            self.codes[s] = len(self.pool)
            self.pool.append(s)
            offset += len(line) + 1
        self.dict_offset = start + end + 1
        if size > self.dict_offset:
            logger.warning(
                "eventlog: torn dictionary tail at %s (%d bytes past the "
                "last complete entry) — the interrupted append was never "
                "acknowledged; it will be dropped on the next write",
                self.dict_path, size - self.dict_offset)

    def refresh_wal(self) -> None:
        """Sync the buffer view with the writer's per-seq WAL.

        The buffer mirrors ``wal_<next_seq>.jsonl``. If a chunk exists for
        a seq, the chunk supersedes that seq's WAL (flushed rows live in
        exactly one place), so after tailing we re-check for a concurrent
        compaction and advance until stable — a reader can never observe
        the same rows both as chunk rows and as its buffer."""
        while True:
            seqs = self.chunk_seqs()
            next_seq = max(seqs) + 1 if seqs else 0
            if next_seq != self.next_seq:
                # our buffered rows were compacted into chunks (or the
                # shard was reset externally): rebuild from the new WAL
                self.buffer = []
                self.wal_offset = 0
                self.next_seq = next_seq
            path = self.wal_path_for(self.next_seq)
            size = os.path.getsize(path) if os.path.exists(path) else 0
            if size < self.wal_offset:
                self.buffer = []
                self.wal_offset = 0
            if size > self.wal_offset:
                self._tail_wal(path)
            if not os.path.exists(self.chunk_path(self.next_seq)):
                return

    def _tail_wal(self, path: str) -> None:
        """Byte-exact tail: consume only newline-terminated records, so a
        record observed mid-write is retried on the next refresh instead of
        being mis-parsed. A complete line that fails to parse is real
        corruption of an acknowledged event — warn, never silently drop."""
        try:
            with open(path, "rb") as f:
                f.seek(self.wal_offset)
                data = f.read()
        except FileNotFoundError:
            # concurrent writer compacted + GC'd this WAL between our
            # getsize and open; the chunk-exists re-check in refresh_wal
            # picks the rows up from the chunk
            return
        end = data.rfind(b"\n")
        if end < 0:
            return
        consumed = data[: end + 1]
        lines = consumed.split(b"\n")[:-1]
        offset = self.wal_offset
        for k, line in enumerate(lines):
            try:
                self.buffer.append(Event.from_dict(
                    json.loads(line.decode("utf-8")), validate=False))
            except (ValueError, KeyError, TypeError,
                    UnicodeDecodeError) as e:
                if k == len(lines) - 1 and end + 1 == len(data):
                    # the FINAL record of the file: a torn buffered write
                    # (multi-line append cut mid-stream can still end in
                    # \n). The insert was never acknowledged — dropping
                    # exactly this line is the crash-recovery contract.
                    logger.warning(
                        "eventlog: dropping torn WAL tail record at %s "
                        "offset %d (%s) — the interrupted write was never "
                        "acknowledged", path, offset, e)
                    journal.emit(
                        "wal", "dropped torn WAL tail record (crash "
                        "mid-append; the write was never acknowledged)",
                        level=journal.WARN,
                        path=path, offset=int(offset))
                else:
                    logger.warning(
                        "eventlog: skipping corrupt WAL record at %s "
                        "offset %d (%s) — an acknowledged event may be "
                        "lost", path, offset, e)
            offset += len(line) + 1
        self.wal_offset += len(consumed)

    def _repair_torn_tail(self, path: str, consumed: int,
                          label: str) -> None:
        """Writer-only crash recovery: drop a torn (unterminated or
        unparseable) tail left by a previous crash BEFORE appending, so
        the next record starts on a clean line boundary instead of
        concatenating with the partial bytes — which would corrupt the
        first acknowledged write after restart. ``consumed`` is the byte
        offset of the last complete, parsed record; everything past it
        was never acknowledged."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size > consumed:
            logger.warning(
                "eventlog: truncating torn %s tail at %s (%d unacknowledged "
                "bytes past the last complete record)",
                label, path, size - consumed)
            with open(path, "r+b") as f:
                f.truncate(consumed)
            journal.emit(
                "wal", f"repaired torn {label} tail (truncated "
                "unacknowledged bytes left by a crash)",
                level=journal.WARN,
                path=path, label=label,
                droppedBytes=int(size - consumed))

    def append_wal(self, events: Sequence[Event],
                   fsync: bool = False) -> None:
        self.append_wal_lines([_wal_line(e) for e in events], fsync=fsync)

    def append_wal_lines(self, lines: Sequence[str],
                         fsync: bool = False) -> None:
        """One write+flush for a batch of pre-encoded WAL records — the
        group-commit write primitive (and the legacy per-append path with
        a single caller's lines). ``fsync`` forces the bytes to stable
        storage before returning; without it they reach the OS page
        cache only (process-crash-safe, not power-loss-safe)."""
        path = self.wal_path_for(self.next_seq)
        if os.path.exists(path):
            self._repair_torn_tail(path, self.wal_offset, "WAL")
        with open(path, "a", encoding="utf-8") as f:
            f.write("".join(lines))
            f.flush()
            if fsync:
                os.fsync(f.fileno())
            self.wal_offset = f.tell()

    def drop_stale_wals(self) -> None:
        """Writer-side GC of WALs already superseded by chunks."""
        for fn in os.listdir(self.root):
            if fn.startswith("wal_") and fn.endswith(".jsonl"):
                try:
                    seq = int(fn[len("wal_"):-len(".jsonl")])
                except ValueError:
                    continue
                if seq < self.next_seq:
                    try:
                        os.remove(os.path.join(self.root, fn))
                    except FileNotFoundError:
                        pass

    def add_strings(self, strings: Sequence[str]) -> None:
        new = []
        seen = set()
        for s in strings:
            if s not in self.codes and s not in seen:
                new.append(s)
                seen.add(s)
        if not new:
            return
        if os.path.exists(self.dict_path):
            self._repair_torn_tail(self.dict_path, self.dict_offset,
                                   "dictionary")
        with open(self.dict_path, "a", encoding="utf-8") as f:
            for s in new:
                self.codes[s] = len(self.pool)
                self.pool.append(s)
                f.write(json.dumps(s) + "\n")
            f.flush()
            self.dict_offset = f.tell()

    def save_tombstones(self) -> None:
        with open(self.tomb_path, "w", encoding="utf-8") as f:
            json.dump(sorted(self.tombstones), f)

    def chunk_path(self, seq: int) -> str:
        return os.path.join(self.chunk_dir, f"chunk_{seq}.npz")

    def index_path(self, seq: int) -> str:
        return os.path.join(self.chunk_dir, f"chunk_{seq}.idx.npz")

    def chunk_seqs(self) -> List[int]:
        return sorted(
            int(fn[len("chunk_"):-len(".npz")])
            for fn in os.listdir(self.chunk_dir)
            if fn.startswith("chunk_") and fn.endswith(".npz")
            and not fn.endswith(".idx.npz"))

    def chunk_index(self, seq: int) -> Optional[Dict[str, np.ndarray]]:
        """Memoized sidecar index for an immutable chunk; None for chunks
        written before indexing existed (reads fall back to a full scan)."""
        got = self.idx_cache.get(seq)
        if got is not None:
            return got if got is not False else None
        path = self.index_path(seq)
        if not os.path.exists(path):
            self.idx_cache[seq] = False
            return None
        with np.load(path, allow_pickle=False) as data:
            idx = {k: data[k] for k in data.files}
        self.idx_cache[seq] = idx
        return idx

    def chunk_data(self, seq: int) -> Dict[str, np.ndarray]:
        """LRU-cached column views of an (immutable) chunk.

        A serving point read touches every chunk its entity appears in;
        re-opening the .npz and re-reading whole columns per query cost
        over a second p50 at 20M events in the reference's measurements.
        Chunks are savez'd UNCOMPRESSED, so every column can be
        np.memmap'd at its member offset instead: a postings-driven read
        of 3 rows pages in a few 4 KB pages, not 3 MB of columns, and the
        OS page cache is the natural hot set. The LRU keeps the (cheap)
        mapping dicts plus any lazily-loaded string blobs; chunks are
        immutable so coherence is trivial. Falls back to a full load for
        compressed/legacy files. Budget: PIO_EVENTLOG_CACHE_MB (counts
        only materialized bytes; maps are address space, not RAM).
        """
        cols = self.col_cache.get(seq)
        if cols is not None:
            self.col_cache.move_to_end(seq)
            return cols
        path = self.chunk_path(seq)
        cols = _mmap_npz_columns(path)
        if cols is None:  # counted with its reason: materialize fully
            with np.load(path, allow_pickle=False) as data:
                cols = {k: data[k] for k in data.files}
        # materialize the extras offsets eagerly: every later point read
        # needs them, and computing here keeps cache accounting symmetric
        # (the per-entry size below is exactly what eviction releases)
        lens = np.asarray(cols["extra_len"])
        cols["__extra_offsets__"] = (
            np.concatenate([[0], np.cumsum(lens[:-1], dtype=np.int64)])
            if lens.size else np.zeros(1, np.int64))
        nbytes = sum(int(v.nbytes) for v in cols.values()
                     if not isinstance(v, np.memmap))
        self.col_cache[seq] = cols
        self.col_sizes[seq] = nbytes
        self.col_cache_bytes += nbytes
        budget = int(float(os.environ.get(
            "PIO_EVENTLOG_CACHE_MB", "256")) * 1e6)
        while self.col_cache_bytes > budget and len(self.col_cache) > 1:
            old_seq, _old = self.col_cache.popitem(last=False)
            self.col_cache_bytes -= self.col_sizes.pop(old_seq, 0)
        return cols


def _mmap_npz_columns(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Map every STORED (uncompressed) member of an .npz as a read-only
    np.memmap at its data offset. Returns None if any member is
    compressed, Fortran-ordered or object-typed, or its headers don't
    parse; each such chunk is counted with its reason
    (``CHUNK_MAP_FALLBACKS``). The npy headers are read with numpy's
    public readers, chosen by the member's format version."""
    import struct
    import zipfile

    fmt = np.lib.format
    cols: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                _count_chunk_map_fallback(path, "compressed")
                return None
            # local file header: sig(4) ver(2) flg(2) cmp(2) time(4)
            # crc(4) csize(4) usize(4) fnlen(2) extralen(2)
            f.seek(info.header_offset)
            lh = f.read(30)
            if lh[:4] != b"PK\x03\x04":
                _count_chunk_map_fallback(path, "local_header")
                return None
            fnlen, extralen = struct.unpack("<HH", lh[26:30])
            data_off = info.header_offset + 30 + fnlen + extralen
            # .npy member header: 1.0 has a 2-byte length, 2.0 and 3.0
            # a 4-byte one (3.0 only widens the header's text encoding
            # to utf-8, which the dict of a numeric column never needs)
            f.seek(data_off)
            try:
                version = fmt.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = fmt.read_array_header_1_0(f)
                else:
                    shape, fortran, dtype = fmt.read_array_header_2_0(f)
            except (ValueError, OSError) as e:
                _count_chunk_map_fallback(
                    path, f"header:{type(e).__name__}")
                return None
            if fortran:
                _count_chunk_map_fallback(path, "fortran")
                return None
            if dtype.hasobject:
                _count_chunk_map_fallback(path, "object")
                return None
            arr_off = f.tell()
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if int(np.prod(shape, dtype=np.int64)) == 0:
                cols[name] = np.empty(shape, dtype=dtype)
            else:
                cols[name] = np.memmap(path, mode="r", dtype=dtype,
                                       shape=shape, offset=arr_off)
    return cols


def _extra_offsets(data) -> np.ndarray:
    """Start offset of each row's slice in the extra_blob string.

    The cumsum over a multi-million-row chunk costs ~22 ms on a memmapped
    column (measured — it dominated serving p50 at 20M events), so cached
    chunk dicts memoize it under a dunder key riding the same LRU entry;
    NpzFile handles (bulk paths) just compute it.
    """
    if isinstance(data, dict):
        got = data.get("__extra_offsets__")
        if got is not None:
            return got
    lengths = np.asarray(data["extra_len"])
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1], dtype=np.int64)]) \
        if lengths.size else np.zeros(1, np.int64)
    if isinstance(data, dict):
        data["__extra_offsets__"] = offsets
    return offsets


def _build_chunk_index(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Postings for point reads: per-chunk CSR of entity_id code -> row
    indices (and the same for target_id), plus the chunk's event-time
    bounds. The analogue of the reference's entity-hash rowkey
    prefix that makes HBase point scans bounded (HBEventsUtil.scala:84-131):
    here the chunk is the region, the postings bound the rows touched."""
    tms = out["time_ms"]
    n = int(tms.shape[0])

    def csr(col):
        order = np.argsort(col, kind="stable").astype(np.int32)
        sc = col[order]
        codes, starts = np.unique(sc, return_index=True)
        return (codes.astype(np.int32),
                np.append(starts, n).astype(np.int64), order)

    ec, eo, er = csr(out["entity_id"])
    tc, to_, tr = csr(out["target_id"])
    return {
        "ent_codes": ec, "ent_offsets": eo, "ent_rows": er,
        "tgt_codes": tc, "tgt_offsets": to_, "tgt_rows": tr,
        "tmin": np.int64(tms.min() if n else 0),
        "tmax": np.int64(tms.max() if n else 0),
    }


def _postings(idx: Dict[str, np.ndarray], kind: str, code: int) -> np.ndarray:
    codes = idx[kind + "_codes"]
    j = int(np.searchsorted(codes, code))
    if j >= codes.shape[0] or codes[j] != code:
        return np.empty(0, np.int32)
    off = idx[kind + "_offsets"]
    return idx[kind + "_rows"][off[j]: off[j + 1]]


def _pack_extras(extras: List[str]) -> Tuple[str, np.ndarray]:
    lengths = np.asarray([len(x) for x in extras], dtype=np.int32)
    return "".join(extras), lengths


def _write_index(sh: _Shard, seq: int, out: Dict[str, np.ndarray]) -> None:
    path = sh.index_path(seq)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **_build_chunk_index(out))
    os.replace(path + ".tmp", path)


class EventlogEvents(Events):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.client = client
        self._shards: Dict[Tuple[int, Optional[int]], _Shard] = {}
        self._lock = threading.RLock()
        #: concurrent insert_batch count — the group-commit leader only
        #: pays the coalescing window when someone is actually there to
        #: coalesce with, so sequential callers keep legacy latency
        self._ingest_inflight = 0
        self._inflight_lock = threading.Lock()
        atexit.register(self.close)

    # -- shard management ----------------------------------------------------
    def _root(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"app_{app_id}" + (f"_{channel_id}" if channel_id else "")
        return os.path.join(self.client.path, name)

    def _shard(self, app_id: int, channel_id: Optional[int]) -> _Shard:
        key = (app_id, channel_id)
        with self._lock:
            sh = self._shards.get(key)
            if sh is None:
                sh = _Shard(self._root(app_id, channel_id))
                self._shards[key] = sh
            return sh

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._shard(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        key = (app_id, channel_id)
        with self._lock:
            self._shards.pop(key, None)
            root = self._root(app_id, channel_id)
            if os.path.isdir(root):
                shutil.rmtree(root)
                return True
            return False

    def close(self) -> None:
        with self._lock:
            for sh in self._shards.values():
                self._flush_shard(sh)

    # -- write path ----------------------------------------------------------
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        sh = self._shard(app_id, channel_id)
        with self._inflight_lock:
            self._ingest_inflight += 1
        try:
            return self._insert_batch_inner(sh, events)
        finally:
            with self._inflight_lock:
                self._ingest_inflight -= 1

    def _insert_batch_inner(self, sh: _Shard,
                            events: Sequence[Event]) -> List[str]:
        group_ms = _wal_group_ms()
        fsync_mode = _wal_fsync_mode()
        # WAL lines encode before the lock: json round-trips are the
        # CPU-heavy half of an append and need no shard state
        wal_lines = [_wal_line(e) for e in events]
        group: Optional[_WalGroup] = None
        with self._lock:
            # make every string durable in the dictionary up front (one
            # append), so buffered events are encodable by any reader
            strings: List[str] = []
            add = strings.append
            for e in events:
                add(e.event)
                add(e.entity_type)
                add(e.entity_id)
                if e.target_entity_type is not None:
                    add(e.target_entity_type)
                if e.target_entity_id is not None:
                    add(e.target_entity_id)
            sh.add_strings(strings)
            sh.dirty = True
            ids: List[str] = []
            pending_lines: List[str] = []
            id_prefix = f"{sh.token}-{sh.next_seq}-"
            for j, e in enumerate(events):
                ids.append(id_prefix + str(len(sh.buffer)))
                sh.buffer.append(e)
                pending_lines.append(wal_lines[j])
                if len(sh.buffer) >= _FLUSH_AT:
                    # the chunk itself makes these durable; pending WAL
                    # lines for them are no longer needed (this also
                    # finishes any open group as superseded)
                    self._flush_shard(sh)
                    pending_lines = []
                    id_prefix = f"{sh.token}-{sh.next_seq}-"
                    # the rest of the batch is local writes too: without
                    # this, a batch crossing a second chunk boundary
                    # would skip that flush and drop the WAL lines of
                    # every event after it (the reference's fault; the
                    # events then live only in the buffer)
                    sh.dirty = True
            if not pending_lines:
                return ids
            if group_ms <= 0.0:
                # legacy per-append path, byte-for-byte (plus the
                # explicit fsync=always opt-in)
                sh.append_wal_lines(pending_lines,
                                    fsync=fsync_mode == "always")
                return ids
            group = sh.wal_group
            if group is None or group.done:
                group = sh.wal_group = _WalGroup(sh.next_seq)
            group.lines.extend(pending_lines)
            group.members += 1
        # ---- outside the lock: the group-commit protocol ----
        # The first enlisted thread to claim leadership commits the
        # whole group; everyone else just waits for the gate. The 201
        # ack (our return) is released only after the commit lands —
        # that is the durability contract group commit must not weaken.
        if group.claim_leader():
            if fsync_mode != "always":
                with self._inflight_lock:
                    crowded = self._ingest_inflight > 1
                if crowded:
                    # bounded coalescing window: let concurrent inserts
                    # enlist so one write+flush covers all of them
                    time.sleep(group_ms / 1e3)
            with self._lock:
                self._commit_wal_group(sh, group, fsync_mode)
        if not group.event.wait(timeout=60.0):
            raise RuntimeError(
                "WAL group commit timed out; the acknowledgement "
                "cannot be released without durability")
        if group.error is not None:
            raise group.error
        return ids

    def _commit_wal_group(self, sh: _Shard, group: _WalGroup,
                          fsync_mode: str) -> None:
        """Write one group's lines in a single append (caller holds the
        lock). A group whose seq was superseded by a published chunk is
        already durable — finish it without touching the WAL."""
        if group.done:
            return
        if sh.wal_group is group:
            sh.wal_group = None
        try:
            if group.seq >= sh.next_seq:
                t0 = time.perf_counter()
                sh.append_wal_lines(group.lines,
                                    fsync=fsync_mode != "off")
                dt = time.perf_counter() - t0
                WAL_GROUP_STATS["commits"] += 1
                WAL_GROUP_STATS["events"] += len(group.lines)
                WAL_GROUP_STATS["flush_s"] += dt
                if len(group.lines) > WAL_GROUP_STATS["max_events"]:
                    WAL_GROUP_STATS["max_events"] = len(group.lines)
                if dt >= _WAL_STALL_S:
                    # every waiter of this group (and its acks) ate
                    # this latency — that's an ingest-p99 event, worth
                    # a timeline entry
                    journal.emit(
                        "wal", "WAL group commit stall: write+flush "
                        f"took {dt * 1e3:.0f} ms for "
                        f"{len(group.lines)} event(s)",
                        level=journal.WARN,
                        flushMs=round(dt * 1e3, 1),
                        events=len(group.lines))
                from predictionio_tpu_torch.common import telemetry
                if telemetry.on():
                    reg = telemetry.registry()
                    reg.histogram(
                        "pio_wal_group_commit_seconds",
                        "WAL group-commit write+flush latency").labels(
                    ).observe(dt)
                    reg.histogram(
                        "pio_wal_group_commit_events",
                        "events per WAL group commit",
                        buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                 1024, 4096)).labels(
                    ).observe(len(group.lines))
        except BaseException as e:
            group.finish(e)
            raise
        group.finish(None)

    def flush(self, app_id: int, channel_id: Optional[int] = None) -> None:
        with self._lock:
            self._flush_shard(self._shard(app_id, channel_id))

    def _flush_shard(self, sh: _Shard) -> None:
        """Compact the buffer into an immutable chunk. Writer-only: a pure
        reader's buffer is a WAL tail owned by another process — compacting
        it here would duplicate the writer's own eventual compaction."""
        if not sh.buffer or not sh.dirty:
            return
        n = len(sh.buffer)
        cols = {
            "event": np.empty(n, np.int32),
            "entity_type": np.empty(n, np.int32),
            "entity_id": np.empty(n, np.int32),
            "target_type": np.full(n, -1, np.int32),
            "target_id": np.full(n, -1, np.int32),
            "time_ms": np.empty(n, np.int64),
            "creation_ms": np.empty(n, np.int64),
        }
        numeric: Dict[str, np.ndarray] = {}
        was_int: Dict[str, np.ndarray] = {}
        extras: List[str] = []

        def code(s: str) -> int:
            c = sh.codes.get(s)
            if c is None:  # only reachable for recovered torn WALs
                sh.add_strings([s])
                c = sh.codes[s]
            return c

        for j, e in enumerate(sh.buffer):
            cols["event"][j] = code(e.event)
            cols["entity_type"][j] = code(e.entity_type)
            cols["entity_id"][j] = code(e.entity_id)
            if e.target_entity_type is not None:
                cols["target_type"][j] = code(e.target_entity_type)
            if e.target_entity_id is not None:
                cols["target_id"][j] = code(e.target_entity_id)
            cols["time_ms"][j] = _millis(e.event_time)
            cols["creation_ms"][j] = _millis(e.creation_time)
            extra: Dict[str, object] = {}
            props = e.properties.to_dict() if e.properties else {}
            rest = {}
            for k, v in props.items():
                if _is_exact_number(v):
                    col = numeric.get(k)
                    if col is None:
                        col = numeric[k] = np.full(n, np.nan, np.float64)
                        was_int[k] = np.zeros(n, np.uint8)
                    col[j] = v
                    was_int[k][j] = isinstance(v, int)
                else:
                    rest[k] = v
            if rest:
                extra["p"] = rest
            if e.tags:
                extra["t"] = list(e.tags)
            if e.pr_id is not None:
                extra["prid"] = e.pr_id
            extras.append(json.dumps(extra) if extra else "")
        blob, lengths = _pack_extras(extras)
        out = dict(cols)
        for k, v in numeric.items():
            out["nc_" + k] = v
            out["ni_" + k] = was_int[k]
        out["extra_blob"] = np.asarray(blob)
        out["extra_len"] = lengths
        path = sh.chunk_path(sh.next_seq)
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **out)
        _write_index(sh, sh.next_seq, out)
        # publication order is the crash-safety contract: once the chunk is
        # visible its rows are durable and its WAL is superseded (readers
        # and replay both resolve chunk-over-WAL), so removing the WAL
        # after — even after a crash in between — never duplicates rows.
        # The index lands before the chunk so a visible chunk always has
        # its sidecar (an orphan index from a crash here is harmless).
        os.replace(path + ".tmp", path)
        sh.buffer = []
        sh.wal_offset = 0
        sh.next_seq += 1
        sh.dirty = False
        # an open commit group is superseded by the chunk we just
        # published: its rows are durable, so its waiters ack without a
        # WAL write (replay resolves chunk-over-WAL either way)
        group, sh.wal_group = sh.wal_group, None
        if group is not None and not group.done:
            group.finish(None)
        sh.drop_stale_wals()

    def append_encoded(
        self,
        app_id: int,
        channel_id: Optional[int],
        pool: Sequence[str],
        event: np.ndarray,
        entity_type: np.ndarray,
        entity_id: np.ndarray,
        time_ms: np.ndarray,
        target_type: Optional[np.ndarray] = None,
        target_id: Optional[np.ndarray] = None,
        numeric: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        """Bulk columnar append: code arrays must index `pool`, which must
        extend the shard dictionary (i.e. come from a prior read_columns or
        a fresh shard). The bulk twin of insert_batch for import pipelines
        (reference PEvents.write, PEvents.scala:172-185)."""
        sh = self._shard(app_id, channel_id)
        with self._lock:
            sh.dirty = True
            self._flush_shard(sh)
            pool = list(pool)
            if pool[: len(sh.pool)] != sh.pool:
                raise ValueError(
                    "append_encoded pool is not an extension of the shard "
                    "dictionary")
            sh.add_strings(pool[len(sh.pool):])
            n = len(event)
            out = {
                "event": np.asarray(event, np.int32),
                "entity_type": np.asarray(entity_type, np.int32),
                "entity_id": np.asarray(entity_id, np.int32),
                "target_type": (np.asarray(target_type, np.int32)
                                if target_type is not None
                                else np.full(n, -1, np.int32)),
                "target_id": (np.asarray(target_id, np.int32)
                              if target_id is not None
                              else np.full(n, -1, np.int32)),
                "time_ms": np.asarray(time_ms, np.int64),
                "creation_ms": np.asarray(time_ms, np.int64),
                "extra_blob": np.asarray(""),
                "extra_len": np.zeros(n, np.int32),
            }
            for k, v in (numeric or {}).items():
                out["nc_" + k] = np.asarray(v, np.float64)
                out["ni_" + k] = np.zeros(n, np.uint8)
            path = sh.chunk_path(sh.next_seq)
            with open(path + ".tmp", "wb") as f:
                np.savez(f, **out)
            _write_index(sh, sh.next_seq, out)
            os.replace(path + ".tmp", path)
            sh.next_seq += 1
            sh.dirty = False
            sh.drop_stale_wals()

    # -- point reads ---------------------------------------------------------
    def _materialize(self, sh: _Shard, seq: int, data, row: int,
                     offsets: Optional[np.ndarray] = None) -> Event:
        pool = sh.pool
        tt = int(data["target_type"][row])
        ti = int(data["target_id"][row])
        lengths = data["extra_len"]
        if lengths[row]:
            if offsets is None:
                offsets = _extra_offsets(data)
            blob = str(data["extra_blob"])
            raw = blob[offsets[row]: offsets[row] + lengths[row]]
            extra = json.loads(raw) if raw else {}
        else:
            extra = {}
        props = dict(extra.get("p", {}))
        # data is an open NpzFile (bulk paths) or a cached column dict
        names = data.files if hasattr(data, "files") else data.keys()
        for name in names:
            if name.startswith("nc_"):
                v = float(data[name][row])
                if not np.isnan(v):
                    flag_col = "ni_" + name[3:]
                    is_int = (flag_col in names
                              and bool(data[flag_col][row]))
                    props[name[3:]] = int(v) if is_int else v
        return Event(
            event=pool[int(data["event"][row])],
            entity_type=pool[int(data["entity_type"][row])],
            entity_id=pool[int(data["entity_id"][row])],
            event_id=f"{sh.token}-{seq}-{row}",
            target_entity_type=pool[tt] if tt >= 0 else None,
            target_entity_id=pool[ti] if ti >= 0 else None,
            properties=DataMap(props),
            event_time=_from_millis(int(data["time_ms"][row])),
            tags=tuple(extra.get("t", ())),
            pr_id=extra.get("prid"),
            creation_time=_from_millis(int(data["creation_ms"][row])),
        )

    def find_target_ids(self, app_id: int,
                        channel_id: Optional[int] = None,
                        entity_type: Optional[str] = None,
                        entity_id: Optional[str] = None,
                        event_names: Optional[Sequence[str]] = None,
                        target_entity_type: Optional[str] = None,
                        ) -> List[str]:
        """Serving fast path: decoded target ids of matching events, NO
        Event materialization (the e-commerce seen/similar lookups only
        need the item ids — ECommAlgorithm.scala:148-176 reads just
        targetEntityId too). Postings bound the rows, one fancy-index per
        column bounds the reads; ~5x faster than find()+materialize at
        20M events."""
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            pool = sh.pool
            out: List[str] = []
            for row, e in enumerate(sh.buffer):   # unflushed tail
                eid = f"{sh.token}-{sh.next_seq}-{row}"
                if eid in sh.tombstones:
                    continue
                if event_matches(e, entity_type=entity_type,
                                 entity_id=entity_id,
                                 event_names=event_names,
                                 target_entity_type=target_entity_type) \
                        and e.target_entity_id is not None:
                    out.append(e.target_entity_id)
            ent_code = (sh.codes.get(entity_id, -2)
                        if entity_id is not None else None)
            if ent_code == -2:
                # the shard dictionary never coded this id, so no FLUSHED
                # event can reference it — skip every chunk probe (a point
                # read of an absent entity is O(buffer), not O(chunks))
                return out
            ev_codes = None
            if event_names is not None:
                ev_codes = [sh.codes[nm] for nm in event_names
                            if nm in sh.codes]
            for seq in sh.chunk_seqs():
                idx = sh.chunk_index(seq)
                rows = None
                if idx is not None and ent_code is not None:
                    rows = np.sort(_postings(idx, "ent", ent_code))
                    if rows.shape[0] == 0:
                        continue
                data = sh.chunk_data(seq)

                def c(name):
                    return (np.asarray(data[name]) if rows is None
                            else np.asarray(data[name][rows]))

                sub = np.ones((data["event"].shape[0] if rows is None
                               else rows.shape[0]), dtype=bool)
                if ev_codes is not None:
                    sub &= np.isin(c("event"), ev_codes)
                if entity_type is not None:
                    sub &= c("entity_type") == sh.codes.get(entity_type, -2)
                if entity_id is not None and rows is None:
                    sub &= c("entity_id") == ent_code
                if target_entity_type is not None:
                    sub &= c("target_type") == sh.codes.get(
                        target_entity_type, -2)
                tgt = c("target_id")[sub]
                if sh.tombstones:
                    final = (np.nonzero(sub)[0] if rows is None
                             else rows[sub])
                    keep = [k for k, r in enumerate(final.tolist())
                            if f"{sh.token}-{seq}-{r}" not in sh.tombstones]
                    tgt = tgt[keep]
                out.extend(pool[code] for code in tgt.tolist() if code >= 0)
            return out

    def _materialize_batch(self, sh: _Shard, seq: int, data,
                           rows: np.ndarray,
                           offsets: np.ndarray) -> List[Event]:
        """Vectorized _materialize for one chunk's matching rows.

        One fancy-index per column instead of per-row scalar reads:
        memmap scalar access costs ~3 µs each, which at ~10 columns per
        row dominated serving p50 (measured). The blob string is only
        rendered when some row actually has extras."""
        pool = sh.pool
        rows = np.asarray(rows)
        col = {k: np.asarray(data[k][rows]).tolist()
               for k in ("event", "entity_type", "entity_id", "target_type",
                         "target_id", "time_ms", "creation_ms")}
        lens = np.asarray(data["extra_len"][rows]).tolist()
        offs = np.asarray(offsets[rows]).tolist()
        names = data.files if hasattr(data, "files") else data.keys()
        ncs = []
        for name in names:
            if name.startswith("nc_"):
                flag = "ni_" + name[3:]
                ncs.append((name[3:], np.asarray(data[name][rows]),
                            np.asarray(data[flag][rows])
                            if flag in names else None))
        blob = None
        out: List[Event] = []
        for k in range(rows.shape[0]):
            if lens[k]:
                if blob is None:
                    blob = str(data["extra_blob"])
                raw = blob[offs[k]: offs[k] + lens[k]]
                extra = json.loads(raw) if raw else {}
            else:
                extra = {}
            props = dict(extra.get("p", {}))
            for nm, vals, flags in ncs:
                v = float(vals[k])
                if not np.isnan(v):
                    props[nm] = int(v) if (
                        flags is not None and bool(flags[k])) else v
            tt, ti = col["target_type"][k], col["target_id"][k]
            out.append(Event(
                event=pool[col["event"][k]],
                entity_type=pool[col["entity_type"][k]],
                entity_id=pool[col["entity_id"][k]],
                event_id=f"{sh.token}-{seq}-{int(rows[k])}",
                target_entity_type=pool[tt] if tt >= 0 else None,
                target_entity_id=pool[ti] if ti >= 0 else None,
                properties=DataMap(props),
                event_time=_from_millis(col["time_ms"][k]),
                tags=tuple(extra.get("t", ())),
                pr_id=extra.get("prid"),
                creation_time=_from_millis(col["creation_ms"][k]),
            ))
        return out

    @staticmethod
    def _parse_id(sh: _Shard, event_id: str) -> Optional[Tuple[int, int]]:
        try:
            token, seq_s, row_s = event_id.split("-", 2)
            if token != sh.token:
                return None
            return int(seq_s), int(row_s)
        except ValueError:
            return None

    def _refresh(self, sh: _Shard) -> None:
        sh.refresh_dict()
        sh.refresh_wal()

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        sh = self._shard(app_id, channel_id)
        with self._lock:
            self._refresh(sh)
            if event_id in sh.tombstones:
                return None
            parsed = self._parse_id(sh, event_id)
            if parsed is None:
                return None
            seq, row = parsed
            if seq == sh.next_seq and row < len(sh.buffer):
                return sh.buffer[row].with_event_id(event_id)
            path = sh.chunk_path(seq)
            if not os.path.exists(path):
                return None
            data = sh.chunk_data(seq)
            if row >= data["event"].shape[0]:
                return None
            return self._materialize(sh, seq, data, row)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        sh = self._shard(app_id, channel_id)
        with self._lock:
            if self.get(event_id, app_id, channel_id) is None:
                return False
            sh.tombstones.add(event_id)
            sh.save_tombstones()
            return True

    # -- query ---------------------------------------------------------------
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
        from predictionio_tpu_torch.data.storage.base import NONE_FILTER
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            full_filter = dict(
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id)
            want = limit if (limit is not None and limit >= 0) else None
            start_ms = _millis(start_time) if start_time is not None else None
            until_ms = _millis(until_time) if until_time is not None else None
            # point-filter codes for the postings pre-filter (-2 = filter on
            # a string the dictionary has never seen -> matches nothing)
            ent_code = (sh.codes.get(entity_id, -2)
                        if entity_id is not None else None)
            if target_entity_id is None:
                tgt_code = None
            elif target_entity_id == NONE_FILTER:
                tgt_code = -1  # stored code for "no target entity"
            else:
                tgt_code = sh.codes.get(target_entity_id, -2)

            # unflushed rows first, so the early-exit bound accounts for them
            matches: List[Event] = []
            for row, e in enumerate(sh.buffer):
                eid = f"{sh.token}-{sh.next_seq}-{row}"
                if eid in sh.tombstones:
                    continue
                if event_matches(e, **full_filter):
                    matches.append(e.with_event_id(eid))

            # chunk visit order enables pruning: ascending by tmin (or
            # descending by tmax when reversed_); un-indexed legacy chunks
            # sort first so a later break never skips one. A point filter
            # on an id the shard dictionary NEVER coded (-2) cannot match
            # any flushed event — skip all chunk probes outright (the
            # absent-constraint lookup the e-commerce template issues per
            # query must be O(buffer), not O(chunks))
            if ent_code == -2 or tgt_code == -2:
                chunks = []
            else:
                chunks = [(seq, sh.chunk_index(seq))
                          for seq in sh.chunk_seqs()]
            if reversed_:
                chunks.sort(key=lambda si: (
                    -int(si[1]["tmax"]) if si[1] is not None else -(1 << 62)))
            else:
                chunks.sort(key=lambda si: (
                    int(si[1]["tmin"]) if si[1] is not None else -(1 << 62)))

            for seq, idx in chunks:
                if idx is not None:
                    tmin, tmax = int(idx["tmin"]), int(idx["tmax"])
                    # time-range pruning
                    if until_ms is not None and tmin >= until_ms:
                        continue
                    if start_ms is not None and tmax < start_ms:
                        continue
                    # limit pruning: once `want` events are collected, a
                    # chunk strictly beyond the k-th best timestamp (and,
                    # by the visit order, every later chunk) is irrelevant
                    if want is not None and len(matches) >= want:
                        matches.sort(key=lambda e: e.event_time,
                                     reverse=reversed_)
                        matches = matches[:max(want, 1)]
                        bound = _millis(matches[want - 1].event_time)
                        if not reversed_ and tmin > bound:
                            break
                        if reversed_ and tmax < bound:
                            break
                # postings pre-filter runs on the (memoized) index BEFORE
                # any chunk I/O: a chunk without this entity costs nothing
                rows = None
                if idx is not None and (ent_code is not None
                                        or tgt_code is not None):
                    if ent_code is not None:
                        rows = _postings(idx, "ent", ent_code)
                    if tgt_code is not None:
                        t_rows = _postings(idx, "tgt", tgt_code)
                        rows = (t_rows if rows is None else
                                np.intersect1d(rows, t_rows,
                                               assume_unique=True))
                    if rows.shape[0] == 0:
                        continue
                    rows = np.sort(rows)
                data = sh.chunk_data(seq)
                tms = data["time_ms"] if rows is None else \
                    data["time_ms"][rows]
                sub = np.ones(tms.shape[0], dtype=bool)
                if start_ms is not None:
                    sub &= tms >= start_ms
                if until_ms is not None:
                    sub &= tms < until_ms
                if event_names is not None:
                    codes = [sh.codes[nm] for nm in event_names
                             if nm in sh.codes]
                    col = data["event"] if rows is None else \
                        data["event"][rows]
                    sub &= np.isin(col, codes)
                if entity_type is not None:
                    c = sh.codes.get(entity_type, -2)
                    col = data["entity_type"] if rows is None else \
                        data["entity_type"][rows]
                    sub &= col == c
                if entity_id is not None and rows is None:
                    sub &= data["entity_id"] == sh.codes.get(
                        entity_id, -2)
                final_rows = (np.nonzero(sub)[0] if rows is None
                              else rows[sub])
                if final_rows.shape[0] == 0:
                    continue
                offsets = _extra_offsets(data)
                for e in self._materialize_batch(sh, seq, data, final_rows,
                                                 offsets):
                    # residual filters (target Some(None) semantics)
                    # via the shared reference matcher
                    if e.event_id in sh.tombstones:
                        continue
                    if event_matches(
                            e, target_entity_type=target_entity_type,
                            target_entity_id=target_entity_id):
                        matches.append(e)
            matches.sort(key=lambda e: e.event_time, reverse=reversed_)
            if want is not None:
                matches = matches[:want]
            return iter(matches)

    # -- bulk columnar read (the training read) ------------------------------
    def _decode_chunk_columns(
        self,
        sh: _Shard,
        seq: int,
        ev_codes: Optional[List[int]],
        et_code: Optional[int],
        tt_code: Optional[int],
        tomb_rows: Optional[List[int]],
        rating_property: str,
        min_row: int = 0,
        with_meta: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Decode + filter one immutable chunk into bulk-read columns.

        Runs WITHOUT the shard lock (chunk files never change after
        publication); safe to execute on any number of worker threads.
        String-typed ratings are coerced from the JSON side-channel exactly
        like the generic object path's float(); the extras offsets come
        from the chunk's cached column dict when the serving LRU already
        holds it (``__extra_offsets__`` is precomputed there) instead of
        re-running the cumsum over the whole chunk per read.

        ``min_row`` drops rows before that index (the incremental-read
        cursor, :meth:`read_columns_since`); ``with_meta`` additionally
        returns the ``creation_ms`` column (ack time — the fold-in
        freshness clock starts there) and the surviving ``row`` indices.
        Defaults preserve the bulk-read output byte for byte."""
        from predictionio_tpu_torch.common import telemetry
        t0 = None
        if telemetry.on():
            import time as _t
            t0 = _t.perf_counter()
        nc = "nc_" + rating_property
        with np.load(sh.chunk_path(seq), allow_pickle=False) as data:
            mask = np.ones(data["event"].shape[0], dtype=bool)
            if min_row > 0:
                mask[:min(min_row, mask.shape[0])] = False
            if ev_codes is not None:
                mask &= np.isin(data["event"], ev_codes)
            if et_code is not None:
                mask &= data["entity_type"] == et_code
            if tt_code is not None:
                mask &= data["target_type"] == tt_code
            if tomb_rows:
                mask[np.asarray(tomb_rows, dtype=np.int64)] = False
            if nc in data.files:
                r = data[nc][mask].astype(np.float32)
            else:
                r = np.full(int(mask.sum()), np.nan, np.float32)
            # string-typed ratings live in the JSON side-channel; decode
            # is bounded by how many rows are actually dirty
            dirty = np.isnan(r) & (data["extra_len"][mask] > 0)
            if dirty.any():
                cached = sh.col_cache.get(seq)   # peek only: no LRU reorder
                offsets = _extra_offsets(
                    cached if cached is not None
                    else {"extra_len": np.asarray(data["extra_len"])})
                lengths = data["extra_len"]
                blob = str(data["extra_blob"])
                rows = np.nonzero(mask)[0][dirty]
                for out_ix, row in zip(np.nonzero(dirty)[0], rows):
                    raw = blob[offsets[row]: offsets[row] + lengths[row]]
                    try:
                        v = json.loads(raw).get("p", {}).get(
                            rating_property)
                        if v is not None:
                            r[out_ix] = float(v)
                    except (ValueError, TypeError):
                        pass
            out = {
                "entity_code": data["entity_id"][mask],
                "target_code": data["target_id"][mask],
                "event_code": data["event"][mask],
                "rating": r,
                "time_ms": data["time_ms"][mask],
            }
            if with_meta:
                out["creation_ms"] = data["creation_ms"][mask]
                out["row"] = np.nonzero(mask)[0].astype(np.int64)
        if t0 is not None:
            import time as _t
            telemetry.registry().histogram(
                "pio_read_chunk_decode_seconds",
                "Per-chunk columnar decode (npz load + filter + string-"
                "rating side-channel) on the bulk-read pool").labels(
            ).observe(_t.perf_counter() - t0)
        return out

    @staticmethod
    def _encode_buffer_tail(
        buffer: List[Event],
        codes_get,
        token: str,
        next_seq: int,
        tombstones: set,
        event_names: Optional[Sequence[str]],
        entity_type: Optional[str],
        target_entity_type: Optional[str],
        rating_property: str,
        start_row: int = 0,
        with_meta: bool = False,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Encode the unflushed rows (ours or the writer's WAL tail) as one
        pseudo-chunk; None when nothing matches. ``start_row``/
        ``with_meta`` serve the incremental cursor read exactly like the
        chunk decoder's ``min_row`` (defaults keep the bulk path
        byte-identical)."""
        ent, tgt, evt, rat, tms = [], [], [], [], []
        cms: List[int] = []
        rows: List[int] = []
        for row, e in enumerate(buffer):
            if row < start_row:
                continue
            eid = f"{token}-{next_seq}-{row}"
            if eid in tombstones:
                continue
            if event_names is not None and e.event not in event_names:
                continue
            if entity_type is not None and e.entity_type != entity_type:
                continue
            if (target_entity_type is not None
                    and e.target_entity_type != target_entity_type):
                continue
            ent.append(codes_get(e.entity_id, -1))
            tgt.append(codes_get(e.target_entity_id, -1)
                       if e.target_entity_id is not None else -1)
            evt.append(codes_get(e.event, -1))
            tms.append(_millis(e.event_time))
            if with_meta:
                cms.append(_millis(e.creation_time))
                rows.append(row)
            v = e.properties.get_opt(rating_property)
            try:
                rat.append(float(v) if v is not None else np.nan)
            except (TypeError, ValueError):
                rat.append(np.nan)
        if not ent:
            return None
        out = {
            "entity_code": np.asarray(ent, np.int32),
            "target_code": np.asarray(tgt, np.int32),
            "event_code": np.asarray(evt, np.int32),
            "rating": np.asarray(rat, np.float32),
            "time_ms": np.asarray(tms, np.int64),
        }
        if with_meta:
            out["creation_ms"] = np.asarray(cms, np.int64)
            out["row"] = np.asarray(rows, np.int64)
        return out

    def read_columns_streamed(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        rating_property: str = "rating",
        read_threads: Optional[int] = None,
    ) -> Tuple[List[str], Iterator[Dict[str, np.ndarray]]]:
        """Bulk read as ``(pool, chunk iterator)`` — the streaming twin of
        :meth:`read_columns` that lets callers overlap downstream work
        (vocab encode, host-to-device staging) with chunk decode.

        Each yielded item is a dict of per-chunk column arrays
        (entity_code / target_code / event_code / rating / time_ms), in
        chunk-seq order, with the unflushed tail last — concatenating them
        reproduces :meth:`read_columns` byte for byte regardless of the
        worker count. Chunks decode on a thread pool (``read_threads``
        argument > ``PIO_READ_THREADS`` env > min(8, cores); 1 = serial
        in-line decode, today's exact behavior).

        Locking: the shard lock is held only for the dict/WAL refresh and
        a state snapshot (chunk list, buffer copy, tombstones, filter
        codes), so concurrent ingest into the same shard proceeds while a
        multi-second scan is in flight. Chunks are immutable once
        published, so decode needs no lock; the snapshot gives the read
        point-in-time semantics (rows inserted after the snapshot are not
        seen, never double-counted). Concurrent `remove()` of the whole
        shard during a read remains undefined (as for any reader).
        """
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            pool = list(sh.pool)
            seqs = sh.chunk_seqs()
            buffer = list(sh.buffer)
            next_seq = sh.next_seq
            token = sh.token
            tombstones = set(sh.tombstones)
            ev_codes = ([sh.codes[nm] for nm in event_names
                         if nm in sh.codes]
                        if event_names is not None else None)
            et_code = (sh.codes.get(entity_type, -2)
                       if entity_type is not None else None)
            tt_code = (sh.codes.get(target_entity_type, -2)
                       if target_entity_type is not None else None)
        # the dictionary is append-only, so the live .get resolves the
        # snapshot's strings to the same codes forever (no copy needed)
        codes_get = sh.codes.get
        tomb_by_seq: Dict[int, List[int]] = {}
        for t in tombstones:
            try:
                tok, seq_s, row_s = t.split("-", 2)
                if tok == token:
                    tomb_by_seq.setdefault(int(seq_s), []).append(int(row_s))
            except ValueError:
                continue

        def chunks() -> Iterator[Dict[str, np.ndarray]]:
            n_threads = _read_thread_count(read_threads)
            if n_threads > 1 and len(seqs) > 1:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(
                        max_workers=min(n_threads, len(seqs)),
                        thread_name_prefix="pio-read") as pool_:
                    # BOUNDED decode-ahead: at most ~2x the worker count
                    # of chunks may be decoded (or decoding) ahead of
                    # the consumer. Submitting every future up front —
                    # the pre-stream behavior — let a slow consumer
                    # accumulate O(dataset) of decoded columns in the
                    # completed futures; the sliding window caps
                    # buffered host chunks at O(threads * chunk), which
                    # is what makes the out-of-core train path's
                    # O(chunk) host claim hold through this layer.
                    # Seq order is preserved (popleft), so parity with
                    # the serial path is unchanged.
                    window = max(2 * min(n_threads, len(seqs)), 2)
                    pending: deque = deque()
                    it = iter(seqs)
                    for seq in it:
                        pending.append(pool_.submit(
                            self._decode_chunk_columns, sh, seq,
                            ev_codes, et_code, tt_code,
                            tomb_by_seq.get(seq), rating_property))
                        if len(pending) >= window:
                            break
                    while pending:
                        out = pending.popleft().result()
                        nxt = next(it, None)
                        if nxt is not None:
                            pending.append(pool_.submit(
                                self._decode_chunk_columns, sh, nxt,
                                ev_codes, et_code, tt_code,
                                tomb_by_seq.get(nxt), rating_property))
                        yield out
            else:
                for seq in seqs:
                    yield self._decode_chunk_columns(
                        sh, seq, ev_codes, et_code, tt_code,
                        tomb_by_seq.get(seq), rating_property)
            tail = self._encode_buffer_tail(
                buffer, codes_get, token, next_seq, tombstones,
                event_names, entity_type, target_entity_type,
                rating_property)
            if tail is not None:
                yield tail

        return pool, chunks()

    def read_columns(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        rating_property: str = "rating",
        read_threads: Optional[int] = None,
    ) -> Dict[str, object]:
        """Bulk load matching events as code arrays + the string pool.

        Returns dict with: pool (List[str]), entity_code, target_code,
        event_code (int32 arrays), rating (float32, NaN where the property
        is absent), time_ms (int64). No per-event Python objects for chunk
        rows — this is the `PEventStore.find` -> device path at full numpy
        bandwidth. Chunks decode in parallel (see
        :meth:`read_columns_streamed` for the threading/locking story);
        the result is byte-identical at any worker count, and
        ``PIO_READ_THREADS=1`` reproduces the serial path exactly.
        """
        pool, parts_iter = self.read_columns_streamed(
            app_id, channel_id, event_names=event_names,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            rating_property=rating_property, read_threads=read_threads)
        parts = list(parts_iter)

        def cat(key: str, dtype) -> np.ndarray:
            xs = [p[key] for p in parts]
            return np.concatenate(xs) if xs else np.empty(0, dtype=dtype)

        return {
            "pool": pool,
            "entity_code": cat("entity_code", np.int32),
            "target_code": cat("target_code", np.int32),
            "event_code": cat("event_code", np.int32),
            "rating": cat("rating", np.float32),
            "time_ms": cat("time_ms", np.int64),
        }

    # -- incremental cursor read (the realtime fold-in tail) -----------------
    #
    # A cursor is {"seq": s, "row": r}: every event at a log position
    # strictly before (s, r) — all rows of chunks with seq < s, plus the
    # first r rows of seq s — has been consumed. Positions are STABLE
    # across compaction: a buffer row's index IS its row in the chunk its
    # WAL becomes (insert ids are minted from the same numbering), so a
    # cursor taken against the buffer stays valid after the flush. New
    # events only ever append at/after the head, never before a cursor.
    # Crash safety rides the WAL contracts from the ingest path: a row a
    # reader can observe was acknowledged, acknowledged implies durable
    # (group commit releases the ack only after the WAL write lands), and
    # torn unacknowledged tails are dropped by the tailer — so a persisted
    # cursor replayed after a crash never skips an acknowledged event and
    # never sees a phantom one.

    def head_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> Dict[str, int]:
        """The cursor at the CURRENT end of the log: a reader that wants
        "only events from now on" (a fold-in worker starting against a
        freshly trained model) starts here."""
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            return {"seq": int(sh.next_seq), "row": len(sh.buffer)}

    def cursor_lag(self, app_id: int, channel_id: Optional[int] = None,
                   cursor: Optional[Dict[str, int]] = None) -> int:
        """Events at/after ``cursor`` that a :meth:`read_columns_since`
        would consume — the fold-in worker's lag gauge. O(chunks past
        the cursor); 0 for a cursor at the head."""
        cur_seq, cur_row = self._normalize_cursor(cursor)
        lag = 0
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            cur_seq = min(cur_seq, sh.next_seq)
            for seq in sh.chunk_seqs():
                if seq < cur_seq:
                    continue
                n = int(sh.chunk_data(seq)["event"].shape[0])
                lag += n - (min(cur_row, n) if seq == cur_seq else 0)
            tail_from = cur_row if cur_seq == sh.next_seq else 0
            lag += max(len(sh.buffer) - tail_from, 0)
        return lag

    @staticmethod
    def _normalize_cursor(cursor: Optional[Dict[str, int]]
                          ) -> Tuple[int, int]:
        if not cursor:
            return 0, 0
        return max(int(cursor.get("seq", 0)), 0), \
            max(int(cursor.get("row", 0)), 0)

    def read_columns_since(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        cursor: Optional[Dict[str, int]] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        rating_property: str = "rating",
    ) -> Tuple[Dict[str, int], Dict[str, object]]:
        """Incremental twin of :meth:`read_columns`: only events at/after
        ``cursor``, plus the advanced cursor. Returns
        ``(new_cursor, columns)`` where columns carry the bulk-read keys
        (pool / entity_code / target_code / event_code / rating /
        time_ms) plus ``creation_ms`` — the ingest ack time, which is
        where the fold-in freshness clock starts (wall-clock points
        recorded at ingest, not timed regions).

        The cursor advances over EVERY event in the log window — filters
        narrow the returned columns, never the consumed range — so a
        follower's cursor converges on the head regardless of what it
        filters for. A cursor pointing past the head (the shard was
        reset/removed externally) is clamped to the head; a cursor from
        before a compaction replays nothing twice (chunk-over-WAL
        resolution keeps each row in exactly one place). Serial decode
        by design: a tick's window is bounded by the tick interval, not
        the log size, so the bulk read's thread pool would be overhead
        here."""
        cur_seq, cur_row = self._normalize_cursor(cursor)
        with self._lock:
            sh = self._shard(app_id, channel_id)
            self._refresh(sh)
            pool = list(sh.pool)
            seqs = [s for s in sh.chunk_seqs() if s >= cur_seq]
            buffer = list(sh.buffer)
            next_seq = sh.next_seq
            token = sh.token
            tombstones = set(sh.tombstones)
            ev_codes = ([sh.codes[nm] for nm in event_names
                         if nm in sh.codes]
                        if event_names is not None else None)
            et_code = (sh.codes.get(entity_type, -2)
                       if entity_type is not None else None)
            tt_code = (sh.codes.get(target_entity_type, -2)
                       if target_entity_type is not None else None)
        if cur_seq > next_seq:
            # the shard was reset under this cursor: clamp to the live
            # head (the old positions no longer name anything)
            logger.warning(
                "eventlog: cursor seq %d is past the live head %d "
                "(shard reset?); clamping to the head", cur_seq, next_seq)
            cur_seq, cur_row = next_seq, len(buffer)
        codes_get = sh.codes.get
        tomb_by_seq: Dict[int, List[int]] = {}
        for t in tombstones:
            try:
                tok, seq_s, row_s = t.split("-", 2)
                if tok == token:
                    tomb_by_seq.setdefault(int(seq_s), []).append(int(row_s))
            except ValueError:
                continue
        parts: List[Dict[str, np.ndarray]] = []
        for seq in seqs:
            parts.append(self._decode_chunk_columns(
                sh, seq, ev_codes, et_code, tt_code,
                tomb_by_seq.get(seq), rating_property,
                min_row=cur_row if seq == cur_seq else 0,
                with_meta=True))
        tail_from = cur_row if cur_seq == next_seq else 0
        tail = self._encode_buffer_tail(
            buffer, codes_get, token, next_seq, tombstones,
            event_names, entity_type, target_entity_type, rating_property,
            start_row=tail_from, with_meta=True)
        if tail is not None:
            parts.append(tail)

        def cat(key: str, dtype) -> np.ndarray:
            xs = [p[key] for p in parts]
            return np.concatenate(xs) if xs else np.empty(0, dtype=dtype)

        new_cursor = {"seq": int(next_seq), "row": len(buffer)}
        return new_cursor, {
            "pool": pool,
            "entity_code": cat("entity_code", np.int32),
            "target_code": cat("target_code", np.int32),
            "event_code": cat("event_code", np.int32),
            "rating": cat("rating", np.float32),
            "time_ms": cat("time_ms", np.int64),
            "creation_ms": cat("creation_ms", np.int64),
        }
