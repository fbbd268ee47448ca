"""Batch views in the port against the JAX package, on the CPU: the JAX
package's ``tests/test_view.py`` cases, each through both packages on the
same events, compared **exactly** (the filtered events, the folds, the
aggregated properties, the snapshot's columns and dtypes, its file name
in the cache and the errors), and a snapshot one package wrote read back
by the other."""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.data import store as jstore
from predictionio_tpu.data import view as jview
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Channel as JChannel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu_torch.data import store, view
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Channel, Storage

MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
PKGS = {
    "port": (view, store, Storage, App, Channel, Event, DataMap),
    "jax": (jview, jstore, JStorage, JApp, JChannel, JEvent, JDataMap),
}


def t(minute):
    return dt.datetime(2021, 1, 1, 0, minute, tzinfo=dt.timezone.utc)


SPECS = [
    ("$set", "u1", {"plan": "free"}, 0, "user", {}),
    ("$set", "u1", {"plan": "pro", "age": 30}, 2, "user", {}),
    ("$unset", "u2", {"plan": None}, 3, "user", {}),
    ("$set", "u2", {"plan": "free"}, 1, "user", {}),
    ("$delete", "u3", {}, 5, "user", {}),
    ("$set", "u3", {"plan": "pro"}, 4, "user", {}),
    ("buy", "u1", {"price": 9.5}, 6, "user",
     dict(target_entity_type="item", target_entity_id="i1")),
    ("buy", "u2", {"price": 3.0}, 7, "user",
     dict(target_entity_type="item", target_entity_id="i2")),
    ("$set", "cart1", {"open": True}, 8, "cart", {}),
]


class World:
    """One package's memory store holding ``viewapp`` and the events."""

    def __init__(self, name):
        (self.view, self.store, storage_cls, app_cls, self.channel_cls,
         self.event_cls, self.map_cls) = PKGS[name]
        self.st = storage_cls(env=MEM)
        self.app = self.st.get_meta_data_apps().insert(
            app_cls(0, "viewapp", None))
        self.st.get_events().init(self.app)

    def ev(self, name, eid, props, minute, etype="user", **kw):
        return self.event_cls(event=name, entity_type=etype, entity_id=eid,
                              properties=self.map_cls(props),
                              event_time=t(minute), **kw)

    def seed(self, specs=SPECS, channel=None):
        self.store.write([self.ev(n, e, p, m, et, **kw)
                          for n, e, p, m, et, kw in specs], self.app,
                         channel, storage=self.st)


@pytest.fixture()
def worlds():
    out = [World("port"), World("jax")]
    for w in out:
        w.seed()
    return out


def _events(seq):
    return [(e.event, e.entity_type, e.entity_id, e.target_entity_id,
             e.properties.to_dict(), e.event_time) for e in seq]


def _props(d):
    return {k: v.to_dict() for k, v in d.items()}


class TestEventSeq:
    def test_filter_semantics(self, worlds):
        got = []
        for w in worlds:
            seq = w.view.LBatchView(w.app, storage=w.st).events
            assert len(seq) == 9
            win = seq.filter(start_time=t(6), until_time=t(8))
            assert [e.entity_id for e in win] == ["u2"]
            got.append([_events(x) for x in (
                seq.filter(event="buy"), win,
                seq.filter(entity_type="cart"),
                seq.filter(event="buy", predicate=lambda e:
                           e.properties.get("price") > 5),
                seq.filter(start_time=t(2)), seq.filter(until_time=t(2)))])
        assert got[0] == got[1]

    def test_aggregate_by_entity_ordered(self, worlds):
        got = []
        for w in worlds:
            seq = w.view.LBatchView(w.app, storage=w.st).events
            total = seq.filter(event="buy").aggregate_by_entity_ordered(
                0.0, lambda acc, e: acc + e.properties.get("price"))
            assert total == {"u1": 9.5, "u2": 3.0}
            got.append(seq.aggregate_by_entity_ordered(
                (), lambda acc, e: acc + (e.event,)))
        assert got[0] == got[1]

    def test_fold_respects_event_time_not_insert_order(self, worlds):
        got = []
        for w in worlds:
            props = w.view.LBatchView(w.app, storage=w.st
                                      ).aggregate_properties("user")
            assert props["u1"].get("plan") == "pro"
            assert not props["u2"].contains("plan") and "u3" not in props
            got.append(_props(props))
        assert got[0] == got[1]

    def test_window_scopes_view(self, worlds):
        got = []
        for w in worlds:
            lbv = w.view.LBatchView(w.app, until_time=t(2), storage=w.st)
            props = lbv.aggregate_properties("user")
            assert props["u1"].get("plan") == "free"
            got.append((_props(props), _props(lbv.aggregate_properties(
                "user", start_time=t(0), until_time=t(1)))))
        assert got[0] == got[1]


def conv(e):
    if e.event != "buy":
        return None
    return {"user": e.entity_id, "item": e.target_entity_id,
            "price": float(e.properties.get("price")), "n": 3,
            "ok": e.entity_id == "u1"}


class TestDataViewCreate:
    def test_columnar_snapshot(self, worlds, tmp_path):
        got = []
        for w in worlds:
            base = tmp_path / w.view.__name__
            cols = w.view.create("viewapp", conv, name="buys",
                                 base_dir=str(base), storage=w.st,
                                 start_time=t(0), until_time=t(30))
            assert list(cols["user"]) == ["u1", "u2"]
            got.append(({k: (v.dtype.str, v.tolist())
                         for k, v in cols.items()},
                        sorted(p.name for p in base.glob("*.npz"))))
        assert got[0] == got[1]
        assert got[0][0]["price"][0] == "<f8"
        assert len(got[0][1]) == 1          # the same snapshot file name

    def test_cache_hit_skips_store(self, worlds, tmp_path):
        got = []
        for w in worlds:
            base = str(tmp_path / w.view.__name__)
            win = dict(start_time=t(0), until_time=t(30), base_dir=base,
                       storage=w.st)
            first = w.view.create("viewapp", conv, name="buys", **win)
            w.seed([("buy", "u9", {"price": 1.0}, 9, "user",
                     dict(target_entity_type="item",
                          target_entity_id="i9"))])
            again = w.view.create("viewapp", conv, name="buys", **win)
            fresh = w.view.create("viewapp", conv, name="buys",
                                  version="v2", **win)
            got.append([list(x["user"]) for x in (first, again, fresh)])
        assert got[0] == got[1] == [["u1", "u2"], ["u1", "u2"],
                                    ["u1", "u2", "u9"]]

    def test_a_snapshot_written_by_one_package_is_read_by_the_other(
            self, worlds, tmp_path):
        port, jax_world = worlds
        win = dict(start_time=t(0), until_time=t(30),
                   base_dir=str(tmp_path))
        first = jax_world.view.create("viewapp", conv, name="buys",
                                      storage=jax_world.st, **win)
        # the port's store is empty of buys now: only the cache can answer
        port.st.get_events().remove(port.app)
        port.st.get_events().init(port.app)
        again = port.view.create("viewapp", conv, name="buys",
                                 storage=port.st, **win)
        assert {k: v.tolist() for k, v in again.items()} == \
            {k: v.tolist() for k, v in first.items()}

    def test_channel_gets_own_cache_key(self, worlds, tmp_path):
        got = []
        for w in worlds:
            cid = w.st.get_meta_data_channels().insert(
                w.channel_cls(0, "mobile", w.app))
            w.st.get_events().init(w.app, cid)
            w.seed([("buy", "m1", {"price": 2.0}, 1, "user",
                     dict(target_entity_type="item",
                          target_entity_id="i1"))], channel=cid)
            base = tmp_path / w.view.__name__
            win = dict(start_time=t(0), until_time=t(30),
                       base_dir=str(base), storage=w.st)
            default = w.view.create("viewapp", conv, name="buys", **win)
            mobile = w.view.create("viewapp", conv, name="buys",
                                   channel_name="mobile", **win)
            got.append((list(default["user"]), list(mobile["user"]),
                        sorted(p.name for p in base.glob("*.npz"))))
        assert got[0] == got[1]
        assert got[0][:2] == (["u1", "u2"], ["m1"])

    @pytest.mark.parametrize("bad,match", [
        (lambda e: None if e.event != "buy" else
         {"user": e.entity_id, "tags": ["a", "b"]}, "non-scalar"),
        (lambda e: None if e.event != "buy" else
         ({"user": e.entity_id} if e.entity_id == "u1" else {"other": 1}),
         "inconsistent"),
        (lambda e: None if e.event != "buy" else {"id": 2 ** 64}, "int64"),
        (lambda e: None if e.event != "buy" else
         {"x": "s" if e.entity_id == "u1" else 1.0}, "mixes"),
    ])
    def test_bad_rows_rejected_before_cache_write(self, worlds, tmp_path,
                                                  bad, match):
        msgs = []
        for w in worlds:
            base = tmp_path / w.view.__name__
            with pytest.raises(ValueError, match=match) as err:
                w.view.create("viewapp", bad, name="bad",
                              base_dir=str(base), storage=w.st,
                              until_time=t(30))
            assert not list(base.glob("*.npz"))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def test_no_until_time_writes_no_snapshot(self, worlds, tmp_path):
        for w in worlds:
            base = tmp_path / w.view.__name__
            cols = w.view.create("viewapp", conv, name="buys",
                                 base_dir=str(base), storage=w.st)
            assert list(cols["user"]) == ["u1", "u2"]
            assert not list(base.glob("*.npz"))

    def test_snapshot_paths_are_the_reference(self, tmp_path):
        for args in (("b", "viewapp", None, t(0), t(30), ""),
                     ("b/x y", "app-1", "mobile", t(1), t(2), "v9")):
            assert view._snapshot_path(str(tmp_path), *args) == \
                jview._snapshot_path(str(tmp_path), *args)
        rows = [{"a": 1, "b": "x", "c": 2.5, "d": True},
                {"a": 2, "b": "yy", "c": 0.0, "d": False}]
        got, want = view._columnar(rows), jview._columnar(rows)
        assert {k: (v.dtype, v.tolist()) for k, v in got.items()} == \
            {k: (v.dtype, v.tolist()) for k, v in want.items()}
        assert view._columnar([]) == jview._columnar([]) == {}
        assert np.asarray(got["a"]).dtype == np.int64
