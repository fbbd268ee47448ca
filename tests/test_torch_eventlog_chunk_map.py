"""The port eventlog's chunk map (``_mmap_npz_columns``): every column of
a chunk written by ``insert_batch`` or by ``append_encoded`` comes back
as an ``np.memmap`` at its member offset, read with numpy's public npy
header readers, with no chunk loaded whole; a chunk that really is
compressed is loaded whole, counted once with its reason and journaled,
and reads the same events. Reads are held against the reference's store
over the same directory."""

import datetime as dt
import types

import numpy as np
import pytest

from predictionio_tpu.data.storage import StorageClientConfig as JConfig
from predictionio_tpu.data.storage import eventlog as jeventlog
from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import StorageClientConfig
from predictionio_tpu_torch.data.storage import eventlog

APP = 3
FLUSH_AT = 64
T0 = dt.datetime(2022, 3, 4, tzinfo=dt.timezone.utc)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    for mod in (jeventlog, eventlog):
        monkeypatch.setattr(mod, "_FLUSH_AT", FLUSH_AT)
    monkeypatch.setattr(eventlog, "CHUNK_MAP_FALLBACKS", {})
    for name in ("PIO_WAL_GROUP_MS", "PIO_WAL_FSYNC",
                 "PIO_EVENTLOG_CACHE_MB"):
        monkeypatch.delenv(name, raising=False)


def _dao(path, mod=eventlog, config=StorageClientConfig):
    cfg = config(properties={"PATH": str(path)})
    return mod.EventlogEvents(mod.StorageClient(cfg), cfg)


def _fill(path):
    """Three insert_batch chunks and one append_encoded chunk."""
    dao = _dao(path)
    dao.init(APP)
    rng = np.random.default_rng(5)
    for lo in range(0, 3 * FLUSH_AT, FLUSH_AT // 2):
        dao.insert_batch([Event(
            event="rate", entity_type="user",
            entity_id=f"u{int(rng.integers(20))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(30))}",
            properties=DataMap({"rating": float(rng.integers(1, 6))}),
            event_time=T0 + dt.timedelta(seconds=lo + k))
            for k in range(FLUSH_AT // 2)], APP)
    pool = list(dao.read_columns(APP)["pool"])
    code = {s: c for c, s in enumerate(pool)}
    n = 100
    dao.append_encoded(
        APP, None, pool,
        event=np.full(n, code["rate"], np.int32),
        entity_type=np.full(n, code["user"], np.int32),
        entity_id=np.full(n, code["u1"], np.int32),
        time_ms=np.int64(T0.timestamp() * 1000) + np.arange(n,
                                                            dtype=np.int64),
        target_type=np.full(n, code["item"], np.int32),
        target_id=np.full(n, code["i2"], np.int32),
        numeric={"rating": np.full(n, 4.0)})
    dao.close()
    return _dao(path)


def _ids_and_ratings(dao, **filt):
    return sorted((e.event_id, e.properties.get("rating"))
                  for e in dao.find(APP, **filt))


@pytest.mark.parametrize("public_only", [False, True])
def test_every_chunk_maps_its_columns(tmp_path, monkeypatch, public_only):
    """Also where ``np.lib.format`` is a shim of public names only, as in
    numpy releases that moved the module's body to ``_format_impl``: the
    map reads no private name."""
    if public_only:
        fmt = np.lib.format
        monkeypatch.setattr(np.lib, "format", types.SimpleNamespace(**{
            name: getattr(fmt, name) for name in dir(fmt)
            if not name.startswith("_")}))
    dao = _fill(tmp_path / "el")
    shard = dao._shard(APP, None)
    seqs = shard.chunk_seqs()
    assert len(seqs) >= 4
    for seq in seqs:
        cols = shard.chunk_data(seq)
        mapped = [k for k, v in cols.items()
                  if not k.startswith("__") and v.size]
        assert mapped and all(isinstance(cols[k], np.memmap)
                              for k in mapped), seq
    assert eventlog.chunk_map_fallbacks() == 0
    assert eventlog.CHUNK_MAP_FALLBACKS == {}
    want = _dao(tmp_path / "el", jeventlog, JConfig)
    for filt in ({}, {"entity_type": "user", "entity_id": "u1"},
                 {"target_entity_type": "item", "target_entity_id": "i2"}):
        assert _ids_and_ratings(dao, **filt) == \
            _ids_and_ratings(want, **filt)


def test_a_compressed_chunk_is_counted_with_its_reason(tmp_path):
    dao = _fill(tmp_path / "el")
    shard = dao._shard(APP, None)
    seq = shard.chunk_seqs()[0]
    before = _ids_and_ratings(dao, entity_type="user", entity_id="u1")
    path = shard.chunk_path(seq)
    with np.load(path, allow_pickle=False) as data:
        cols = {k: data[k] for k in data.files}
    np.savez_compressed(path, **cols)
    shard.col_cache.clear()
    shard.col_sizes.clear()
    shard.col_cache_bytes = 0
    seq_at = journal.snapshot()["lastSeq"]
    got = shard.chunk_data(seq)
    assert not any(isinstance(v, np.memmap) for v in got.values())
    assert eventlog.CHUNK_MAP_FALLBACKS == {"compressed": 1}
    assert eventlog.chunk_map_fallbacks() == 1
    events = [e for e in journal.snapshot(since_seq=seq_at)["events"]
              if e["category"] == "eventlog"]
    assert len(events) == 1 and "compressed" in events[0]["message"]
    assert _ids_and_ratings(dao, entity_type="user", entity_id="u1") == \
        before
    for other in shard.chunk_seqs()[1:]:
        shard.chunk_data(other)
    assert eventlog.chunk_map_fallbacks() == 1
