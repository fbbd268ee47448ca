"""The cursor methods of the port's memory and SQLite event stores
(``head_cursor``, ``cursor_lag``, and SQLite's ``read_columns_since`` /
memory's ``read_events_since``) against the JAX package's, after the
same seeded inserts, deletes and further inserts."""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import Storage

MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
APP, OTHER, CHANNEL = 3, 4, 9
T0 = dt.datetime(2021, 6, 1, tzinfo=dt.timezone.utc)
COLS = ("entity_code", "target_code", "event_code", "rating", "time_ms",
        "creation_ms")


def _events(event_cls, map_cls, seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        name = ("rate", "buy", "view")[rng.integers(3)]
        props = {"rating": (float(rng.integers(1, 11)) / 2,
                            str(int(rng.integers(1, 6))))[rng.integers(2)]} \
            if name == "rate" else {}
        t = T0 + dt.timedelta(seconds=int(rng.integers(10_000)))
        out.append(event_cls(
            event=name, entity_type=("user", "admin")[int(k % 7 == 0)],
            entity_id=f"u{int(rng.integers(20))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(15))}",
            properties=map_cls(props), event_time=t,
            creation_time=t + dt.timedelta(seconds=k)))
    return out


def _history(storage, event_cls, map_cls):
    """Inserts on the app, another app and a channel, two deletes, and
    the cursors taken along the way."""
    ev = storage.get_events()
    for app, ch in ((APP, None), (OTHER, None), (APP, CHANNEL)):
        ev.init(app, ch)
    cursors = [ev.head_cursor(APP)]
    ids = ev.insert_batch(_events(event_cls, map_cls, 1, 40), APP)
    ev.insert_batch(_events(event_cls, map_cls, 2, 15), OTHER)
    cursors.append(ev.head_cursor(APP))
    ids += [ev.insert(e, APP) for e in _events(event_cls, map_cls, 3, 12)]
    ev.insert_batch(_events(event_cls, map_cls, 4, 9), APP, CHANNEL)
    assert ev.delete(ids[5], APP) and ev.delete(ids[45], APP)
    cursors.append(ev.head_cursor(APP))
    ids += ev.insert_batch(_events(event_cls, map_cls, 5, 7), APP)
    cursors.append(ev.head_cursor(APP))
    return ev, cursors


def _pair(kind, tmp_path):
    if kind == "memory":
        jst, st = JStorage(env=MEM), Storage(env=MEM)
    else:
        jst = JStorage(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
        st = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "port")})
    return _history(jst, JEvent, JDataMap), _history(st, Event, DataMap)


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_head_cursors_and_lags_match_the_reference(kind, tmp_path):
    (jev, jcursors), (ev, cursors) = _pair(kind, tmp_path)
    assert cursors == jcursors
    for app, ch in ((APP, None), (OTHER, None), (APP, CHANNEL)):
        assert ev.head_cursor(app, ch) == jev.head_cursor(app, ch)
        for cur in [None, *cursors]:
            assert ev.cursor_lag(app, ch, cursor=cur) == \
                jev.cursor_lag(app, ch, cursor=cur), (app, ch, cur)
    assert ev.cursor_lag(APP, cursor=cursors[-1]) == 0


def test_memory_reads_since_match_the_reference(tmp_path):
    (jev, _jcursors), (ev, cursors) = _pair("memory", tmp_path)
    for cur in [None, *cursors]:
        want_cur, want = jev.read_events_since(APP, cursor=cur)
        got_cur, got = ev.read_events_since(APP, cursor=cur)
        assert got_cur == want_cur == cursors[-1]
        assert [e.to_dict(with_event_id=False) for e in got] == \
            [e.to_dict(with_event_id=False) for e in want]


@pytest.mark.parametrize("kw", [
    {}, {"event_names": ["rate"], "entity_type": "user"},
    {"target_entity_type": "item", "rating_property": "rating"}],
    ids=["all", "rate-user", "item"])
def test_sqlite_reads_since_match_the_reference(tmp_path, kw):
    (jev, _jcursors), (ev, cursors) = _pair("sqlite", tmp_path)
    for cur in [None, *cursors, {"seq": 0, "row": 10 ** 6}]:
        want_cur, want = jev.read_columns_since(APP, cursor=cur, **kw)
        got_cur, got = ev.read_columns_since(APP, cursor=cur, **kw)
        assert got_cur == want_cur
        assert got["pool"] == want["pool"]
        for k in COLS:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (cur, k)
