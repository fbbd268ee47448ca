"""The port's eventlog store (``data/storage/eventlog.py``) against the
JAX package's.

Both packages' stores are fed the same seeded events: single inserts,
``insert_batch`` and ``append_encoded`` chunks, a delete, flushes across
a chunk boundary (the compaction threshold is cut to 64 events so a few
thousand events make many chunks), a WAL replay after a simulated crash
(a new process's store over the same directory) and a torn WAL tail.
Then ``find`` over the filters (the same events in the same order; event
ids agree up to each shard's random token), ``read_columns`` pools and
arrays byte for byte, ``read_columns_streamed`` concatenated against
``read_columns``, one decode thread against the pool, ``get`` /
``find_target_ids``, and the cursor methods. A directory one package
writes reads in the other, byte for byte.
"""

import datetime as dt
import os

import numpy as np
import pytest

from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import StorageClientConfig as JConfig
from predictionio_tpu.data.storage import eventlog as jeventlog
from predictionio_tpu.data.storage.base import NONE_FILTER
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import StorageClientConfig
from predictionio_tpu_torch.data.storage import eventlog

#: (eventlog module, Event, DataMap, StorageClientConfig) per package
REF = (jeventlog, JEvent, JDataMap, JConfig)
PORT = (eventlog, Event, DataMap, StorageClientConfig)
FLUSH_AT = 64
APP = 7
T0 = dt.datetime(2022, 3, 4, tzinfo=dt.timezone.utc)
COLS = ("entity_code", "target_code", "event_code", "rating", "time_ms")


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    for mod in (jeventlog, eventlog):
        monkeypatch.setattr(mod, "_FLUSH_AT", FLUSH_AT)
    for name in ("PIO_WAL_GROUP_MS", "PIO_WAL_FSYNC",
                 "PIO_EVENTLOG_CACHE_MB"):
        monkeypatch.delenv(name, raising=False)
    # two decode workers: the suite runs beside timing-sensitive tests
    monkeypatch.setenv("PIO_READ_THREADS", "2")


def _dao(pkg, path):
    mod, _event, _map, config = pkg
    cfg = config(properties={"PATH": str(path)})
    return mod.EventlogEvents(mod.StorageClient(cfg), cfg)


def _event_dicts(seed: int, n: int):
    """Seeded wire-shaped events: rates (float, int and string ratings),
    buys, views with tags and a prId, ``$set`` with no target, and
    non-numeric properties."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = ("rate", "rate", "buy", "view", "$set")[rng.integers(5)]
        t = T0 + dt.timedelta(seconds=int(rng.integers(0, 5000)))
        d = {"event": kind, "entity_type": "user",
             "entity_id": f"u{int(rng.integers(30))}",
             "event_time": t, "creation_time": t + dt.timedelta(seconds=k),
             "properties": {}}
        if kind != "$set":
            d["target_entity_type"] = "item"
            d["target_entity_id"] = f"i{int(rng.integers(40))}"
        if kind == "rate":
            r = rng.integers(3)
            d["properties"] = {"rating": (
                float(rng.integers(1, 11)) / 2, int(rng.integers(1, 6)),
                str(float(rng.integers(1, 6))))[r]}
        elif kind == "view":
            d["tags"] = ("web", f"t{int(rng.integers(3))}")
            d["pr_id"] = f"p{k}"
        elif kind == "$set":
            d["properties"] = {"plan": f"plan{int(rng.integers(3))}",
                               "score": int(rng.integers(100))}
        out.append(d)
    return out


def _events(pkg, dicts):
    _mod, event_cls, map_cls, _cfg = pkg
    return [event_cls(**{k: (map_cls(v) if k == "properties" else v)
                         for k, v in d.items()}) for d in dicts]


def _fill(pkg, path, seed: int, crash: bool = False):
    """One seeded history of writes; returns the DAO and the ids of the
    events written, in order."""
    dao = _dao(pkg, path)
    dao.init(APP)
    dicts = _event_dicts(seed, 700)
    ids = [dao.insert(e, APP) for e in _events(pkg, dicts[:10])]
    # batches of at most FLUSH_AT events cross at most one chunk
    # boundary each (a batch crossing two: test_batch_crossing_...)
    for lo, hi in ((10, 69), (69, 128), (128, 187), (187, 246), (246, 305),
                   (305, 364), (364, 400), (400, 459), (459, 518),
                   (518, 577), (577, 600)):
        if lo == 400:
            _append_encoded(dao, seed)
        ids += dao.insert_batch(_events(pkg, dicts[lo:hi]), APP)
    # a delete of a flushed event and of a buffered one
    assert dao.delete(ids[3], APP) and dao.delete(ids[-2], APP)
    assert not dao.delete(ids[3], APP)
    ids += dao.insert_batch(_events(pkg, dicts[600:650]), APP)
    ids += dao.insert_batch(_events(pkg, dicts[650:690]), APP)
    if crash:
        # a new process over the same directory: the buffered tail comes
        # back from the WAL, and the next write lands after it
        dao = _dao(pkg, path)
    ids += [dao.insert(e, APP) for e in _events(pkg, dicts[690:])]
    return dao, ids


def _append_encoded(dao, seed: int, n: int = 150):
    """One bulk columnar chunk of ``n`` rate events over a pool that
    extends the shard's dictionary."""
    rng = np.random.default_rng(seed + 100)
    pool = dao.read_columns(APP)["pool"]
    extra = ["rate", "user", "item", "$set"] + [f"u{i}" for i in range(30)] \
        + [f"i{i}" for i in range(40)] + ["w0", "w1"]
    pool = list(pool) + [s for s in extra if s not in pool]
    code = {s: c for c, s in enumerate(pool)}
    dao.append_encoded(
        APP, None, pool,
        event=np.full(n, code["rate"], np.int32),
        entity_type=np.full(n, code["user"], np.int32),
        entity_id=np.array([code[f"u{i}"] for i in rng.integers(30, size=n)],
                           np.int32),
        time_ms=np.int64(T0.timestamp() * 1000) + rng.integers(
            0, 5_000_000, size=n).astype(np.int64),
        target_type=np.full(n, code["item"], np.int32),
        target_id=np.array([code[f"i{i}"] for i in rng.integers(40, size=n)],
                           np.int32),
        numeric={"rating": rng.integers(1, 6, size=n).astype(np.float64)})


def _pos(event_id: str) -> str:
    """An event id without its shard's random token: '<seq>-<row>'."""
    return event_id.split("-", 1)[1]


def _key(e):
    return (_pos(e.event_id), e.event, e.entity_type, e.entity_id,
            e.target_entity_type, e.target_entity_id,
            tuple(sorted(e.properties.to_dict().items(), key=str)),
            e.event_time,
            tuple(e.tags), e.pr_id)


FILTERS = [
    {},
    {"entity_type": "user", "entity_id": "u3"},
    {"event_names": ["rate", "buy"]},
    {"event_names": ["view"], "limit": 5},
    {"target_entity_type": "item", "target_entity_id": "i7"},
    {"target_entity_type": NONE_FILTER},
    {"target_entity_id": NONE_FILTER},
    {"start_time": T0 + dt.timedelta(seconds=1000),
     "until_time": T0 + dt.timedelta(seconds=2500)},
    {"entity_id": "u5", "reversed_": True, "limit": 3},
    {"entity_id": "nobody"},
    {"limit": 0},
]


@pytest.fixture(params=[False, True], ids=["live", "replayed"])
def pair(request, tmp_path):
    """The same seeded history in a store of each package."""
    crash = request.param
    ref, ref_ids = _fill(REF, tmp_path / "jax", seed=11, crash=crash)
    port, ids = _fill(PORT, tmp_path / "port", seed=11, crash=crash)
    assert [_pos(i) for i in ids] == [_pos(i) for i in ref_ids]
    return ref, port, ref_ids, ids


@pytest.mark.parametrize("filt", range(len(FILTERS)))
def test_find_matches_the_reference(pair, filt):
    ref, port, _ref_ids, _ids = pair
    kw = FILTERS[filt]
    want = [_key(e) for e in ref.find(APP, **kw)]
    got = [_key(e) for e in port.find(APP, **kw)]
    assert got == want
    if not kw:
        assert len(got) == 700 + 150 - 2


def _same_columns(a, b):
    assert a["pool"] == b["pool"]
    for k in COLS:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", [
    {}, {"event_names": ["rate", "buy"], "entity_type": "user",
         "target_entity_type": "item"},
    {"event_names": ["nope"]}], ids=["all", "rate-buy", "none"])
def test_read_columns_match_the_reference(pair, monkeypatch, kw):
    ref, port, _ref_ids, _ids = pair
    want = ref.read_columns(APP, **kw)
    got = port.read_columns(APP, **kw)
    _same_columns(got, want)
    pool, chunks = port.read_columns_streamed(APP, **kw)
    parts = list(chunks)
    if not kw:
        assert len(parts) > 1       # many chunks and the buffered tail
    streamed = {"pool": pool, **{
        k: (np.concatenate([p[k] for p in parts]) if parts
            else got[k][:0]) for k in COLS}}
    _same_columns(streamed, got)
    monkeypatch.setenv("PIO_READ_THREADS", "1")
    _same_columns(port.read_columns(APP, **kw), got)
    _same_columns(port.read_columns(APP, read_threads=4, **kw), got)


def test_get_and_target_ids_match_the_reference(pair):
    ref, port, ref_ids, ids = pair
    for k in (0, 3, 57, 300, 598, len(ids) - 1):
        want, got = ref.get(ref_ids[k], APP), port.get(ids[k], APP)
        assert (got is None) == (want is None)
        if got is not None:
            assert _key(got) == _key(want)
    assert port.get(ref_ids[0], APP) is None       # another shard's token
    for user in ("u1", "u3", "nobody"):
        for names in (None, ["rate"], ["view", "buy"]):
            assert port.find_target_ids(APP, entity_type="user",
                                        entity_id=user,
                                        event_names=names) == \
                ref.find_target_ids(APP, entity_type="user",
                                    entity_id=user, event_names=names)


def test_cursors_match_the_reference(pair):
    ref, port, _ref_ids, _ids = pair
    head = port.head_cursor(APP)
    assert head == ref.head_cursor(APP)
    for cursor in (None, {"seq": 0, "row": 5}, {"seq": 3, "row": 70},
                   head, {"seq": head["seq"] + 4, "row": 0}):
        assert port.cursor_lag(APP, cursor=cursor) == \
            ref.cursor_lag(APP, cursor=cursor)
        for kw in ({}, {"event_names": ["rate"], "entity_type": "user"}):
            want_cur, want = ref.read_columns_since(APP, cursor=cursor,
                                                    **kw)
            got_cur, got = port.read_columns_since(APP, cursor=cursor,
                                                   **kw)
            assert got_cur == want_cur == head
            _same_columns(got, want)
            assert got["creation_ms"].tobytes() == \
                want["creation_ms"].tobytes()
    # 30 more events: the lag from the head is exactly them
    more = _event_dicts(5, 30)
    port.insert_batch(_events(PORT, more), APP)
    ref.insert_batch(_events(REF, more), APP)
    assert port.cursor_lag(APP, cursor=head) == 30
    new_cur, cols = port.read_columns_since(APP, cursor=head)
    assert cols["entity_code"].shape[0] == 30
    assert port.cursor_lag(APP, cursor=new_cur) == 0


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                         ids=["port-writes", "reference-writes"])
def test_directory_reads_in_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "store"
    w, ids = _fill(writer, path, seed=4)
    w.close()       # flush the buffered tail into a chunk
    r = _dao(reader, path)
    _same_columns(r.read_columns(APP), w.read_columns(APP))
    assert [_key(e) for e in r.find(APP)] == [_key(e) for e in w.find(APP)]
    assert _key(r.get(ids[-1], APP)) == _key(w.get(ids[-1], APP))
    assert r.head_cursor(APP) == w.head_cursor(APP)


@pytest.mark.parametrize("torn", [b'{"event": "rate", "entit',
                                  b'{not json at all}\n'],
                         ids=["unterminated", "unparseable"])
def test_torn_wal_tail_is_dropped_and_repaired(tmp_path, torn):
    """A crash mid-append leaves a torn last WAL record: both packages'
    readers drop it, and the next write truncates it before appending, so
    the first acknowledged event after the restart is intact."""
    state = []
    for pkg, name in ((REF, "jax"), (PORT, "port")):
        path = tmp_path / name
        dao, _ids = _fill(pkg, path, seed=9)
        sh = dao._shard(APP, None)
        wal = sh.wal_path_for(sh.next_seq)
        assert os.path.getsize(wal) > 0
        with open(wal, "ab") as f:
            f.write(torn)
        again = _dao(pkg, path)
        before = [_key(e) for e in again.find(APP)]
        new_id = again.insert(_events(pkg, [{
            "event": "rate", "entity_type": "user", "entity_id": "u99",
            "target_entity_type": "item", "target_entity_id": "i0",
            "event_time": T0, "creation_time": T0,
            "properties": {"rating": 3.0}}])[0], APP)
        third = _dao(pkg, path)
        after = [_key(e) for e in third.find(APP)]
        assert len(after) == len(before) + 1
        assert set(before) < set(after)
        assert _key(third.get(new_id, APP))[3] == "u99"
        with open(wal, "rb") as f:
            assert f.read().endswith(b"\n")
        state.append((before, after, third.read_columns(APP)))
    (jb, ja, jc), (pb, pa, pc) = state
    assert pb == jb and pa == ja
    _same_columns(pc, jc)


def test_group_commit_and_fsync_modes(tmp_path, monkeypatch):
    """Every WAL mode acknowledges durable events that a new reader sees,
    in both packages, with the same columns."""
    cols = []
    for mode, group in (("group", "2"), ("always", "2"), ("off", "0")):
        monkeypatch.setenv("PIO_WAL_FSYNC", mode)
        monkeypatch.setenv("PIO_WAL_GROUP_MS", group)
        for pkg, name in ((REF, "jax"), (PORT, "port")):
            path = tmp_path / f"{name}_{mode}"
            dao = _dao(pkg, path)
            dicts = _event_dicts(21, 40)
            for e in _events(pkg, dicts):
                dao.insert(e, APP)
            cols.append(_dao(pkg, path).read_columns(APP))
    for j in range(0, len(cols), 2):
        _same_columns(cols[j + 1], cols[j])
        assert cols[j + 1]["entity_code"].shape[0] == 40


def test_batch_crossing_two_chunk_boundaries_stays_durable(tmp_path):
    """One insert_batch of more than twice the compaction threshold: the
    port flushes at every boundary and writes the WAL lines of the tail,
    so every acknowledged event survives a crash (a new process over the
    directory). The JAX package's store skips the second flush and the
    tail's WAL write (ROADMAP queue 3), so after the crash its reader
    misses the tail. Before the crash both read the same columns."""
    dicts = _event_dicts(13, 3 * FLUSH_AT + 9)
    seen = []
    for pkg, name in ((REF, "jax"), (PORT, "port")):
        dao = _dao(pkg, tmp_path / name)
        dao.insert_batch(_events(pkg, dicts), APP)
        live = dao.read_columns(APP)
        after = _dao(pkg, tmp_path / name).read_columns(APP)
        seen.append((live, after))
    (ref_live, ref_after), (live, after) = seen
    _same_columns(live, ref_live)
    assert live["entity_code"].shape[0] == len(dicts)
    _same_columns(after, live)
    assert ref_after["entity_code"].shape[0] < len(dicts)
