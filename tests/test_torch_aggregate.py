"""The port's property aggregation and the store lookups the templates
read through, held exactly against the JAX package's: the
``$set``/``$unset``/``$delete`` fold on one seeded event list, and the
``Events`` DAO's ``aggregate_properties`` /
``aggregate_properties_of_entity`` and ``data/store.py``'s ``find``,
``find_target_ids``, ``find_by_entity``, ``aggregate_properties`` and
``extract_entity_map`` on the same events written into each package's
memory and SQLite stores."""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.data import aggregate as jaggregate
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu_torch.data import aggregate, store
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage

UTC = dt.timezone.utc
T0 = dt.datetime(2022, 3, 1, tzinfo=UTC)
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
APP = "AggApp"


def _event_dicts(seed=0, n=400):
    """Seeded `$set`/`$unset`/`$delete` streams over users, items and a
    constraint entity, interleaved with view/buy events; every event at
    its own second, written out of time order."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.choice(["$set", "$set", "$set", "$unset", "$delete",
                           "view", "buy"])
        etype = rng.choice(["user", "item", "constraint"])
        eid = (f"{etype[0]}{rng.integers(12)}" if etype != "constraint"
               else rng.choice(["unavailableItems", "weightedItems"]))
        d = {"event": str(kind), "entity_type": str(etype),
             "entity_id": str(eid),
             "event_time": T0 + dt.timedelta(seconds=int(k))}
        if kind == "$set":
            keys = rng.choice(["plan", "attr0", "categories", "items"],
                              size=rng.integers(1, 4), replace=False)
            d["properties"] = {
                str(key): ([f"c{rng.integers(3)}"] if key == "categories"
                           else [f"i{j}" for j in rng.integers(0, 12, 2)]
                           if key == "items" else float(rng.integers(5)))
                for key in keys}
        elif kind == "$unset":
            d["properties"] = {str(rng.choice(["plan", "attr0"])): None}
        elif kind in ("view", "buy"):
            d.update(entity_type="user", entity_id=f"u{rng.integers(12)}",
                     target_entity_type="item",
                     target_entity_id=f"i{rng.integers(12)}")
        out.append(d)
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _events(dicts, event_cls, map_cls):
    return [event_cls(**{k: (map_cls(v) if k == "properties" else v)
                         for k, v in d.items()}) for d in dicts]


def _key(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_dict(), e.event_time)


def _props(result):
    return {k: (v.to_dict(), v.first_updated, v.last_updated)
            for k, v in result.items()}


def _eventlog_env(root):
    """Events in an eventlog directory, metadata on SQLite (the
    reference's layout for the eventlog store)."""
    return {
        "PIO_STORAGE_SOURCES_L_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_L_PATH": str(root / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_E_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_E_PATH": str(root / "eventlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "L",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "E",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "L",
    }


@pytest.fixture(params=["memory", "sqlite", "eventlog"])
def stores(request, tmp_path):
    """The same events in a fresh store of each package."""
    if request.param == "memory":
        jst, st = JStorage(env=MEM), Storage(env=MEM)
    elif request.param == "eventlog":
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        jst = JStorage(env=_eventlog_env(tmp_path / "jax"))
        st = Storage(env=_eventlog_env(tmp_path / "port"))
    else:
        jst = JStorage(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
        st = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "port")})
    dicts = _event_dicts()
    for s, app_cls, event_cls, map_cls, write in (
            (jst, JApp, JEvent, JDataMap, jstore.write),
            (st, App, Event, DataMap, store.write)):
        app_id = s.get_meta_data_apps().insert(app_cls(0, APP, None))
        s.get_events().init(app_id)
        write(_events(dicts, event_cls, map_cls), app_id, storage=s)
    return jst, st


def test_fold_matches_the_reference():
    dicts = _event_dicts(seed=1)
    got = aggregate.aggregate_properties(_events(dicts, Event, DataMap))
    want = jaggregate.aggregate_properties(_events(dicts, JEvent, JDataMap))
    assert _props(got) == _props(want)
    assert got          # the stream leaves some entities standing
    one = [d for d in dicts if d["entity_id"] == "u3"]
    a = aggregate.aggregate_properties_single(_events(one, Event, DataMap))
    b = jaggregate.aggregate_properties_single(
        _events(one, JEvent, JDataMap))
    assert (a is None and b is None) or \
        _props({"u3": a}) == _props({"u3": b})


@pytest.mark.parametrize("entity_type,required", [
    ("user", None), ("item", None), ("constraint", None),
    ("user", ["plan"]), ("item", ["categories", "attr0"]),
])
def test_dao_aggregate_properties(stores, entity_type, required):
    jst, st = stores
    jid = jst.get_meta_data_apps().get_by_name(APP).id
    pid = st.get_meta_data_apps().get_by_name(APP).id
    want = jst.get_events().aggregate_properties(
        app_id=jid, entity_type=entity_type, required=required)
    got = st.get_events().aggregate_properties(
        app_id=pid, entity_type=entity_type, required=required)
    assert _props(got) == _props(want)
    for eid in ("u0", "u5", "i2", "i7"):
        etype = "user" if eid[0] == "u" else "item"
        w = jst.get_events().aggregate_properties_of_entity(
            app_id=jid, entity_type=etype, entity_id=eid)
        g = st.get_events().aggregate_properties_of_entity(
            app_id=pid, entity_type=etype, entity_id=eid)
        assert (g is None and w is None) or \
            _props({eid: g}) == _props({eid: w})
    with pytest.raises(ValueError, match="entity_type is required"):
        st.get_events().aggregate_properties(app_id=pid)


@pytest.mark.parametrize("kwargs", [
    {},
    {"entity_type": "user", "event_names": ["view", "buy"]},
    {"entity_type": "user", "target_entity_type": "item", "limit": 7},
    {"entity_id": "u4"},
    {"event_names": ["$set"], "start_time": T0 + dt.timedelta(seconds=100),
     "until_time": T0 + dt.timedelta(seconds=250)},
])
def test_find(stores, kwargs):
    jst, st = stores
    want = [_key(e) for e in jstore.find(APP, storage=jst, **kwargs)]
    got = [_key(e) for e in store.find(APP, storage=st, **kwargs)]
    assert got == want and got


@pytest.mark.parametrize("latest,limit", [(True, None), (True, 10),
                                          (False, 3)])
def test_find_by_entity_and_target_ids(stores, latest, limit):
    jst, st = stores
    for uid in ("u0", "u1", "u7", "nobody"):
        want = jstore.find_by_entity(
            APP, "user", uid, event_names=["view", "buy"],
            target_entity_type="item", limit=limit, latest=latest,
            storage=jst)
        got = store.find_by_entity(
            APP, "user", uid, event_names=["view", "buy"],
            target_entity_type="item", limit=limit, latest=latest,
            storage=st)
        assert [_key(e) for e in got] == [_key(e) for e in want]
        assert store.find_target_ids(
            APP, "user", uid, event_names=["view", "buy"],
            target_entity_type="item", storage=st) == \
            jstore.find_target_ids(
                APP, "user", uid, event_names=["view", "buy"],
                target_entity_type="item", storage=jst)
    (got,) = store.find_by_entity(APP, "constraint", "unavailableItems",
                                  event_names=["$set"], limit=1, storage=st)
    (want,) = jstore.find_by_entity(APP, "constraint", "unavailableItems",
                                    event_names=["$set"], limit=1,
                                    storage=jst)
    assert _key(got) == _key(want)


def test_store_aggregate_and_entity_map(stores):
    jst, st = stores
    for etype, req in (("user", None), ("item", ["attr0"])):
        assert _props(store.aggregate_properties(
            APP, etype, required=req, storage=st)) == _props(
            jstore.aggregate_properties(APP, etype, required=req,
                                        storage=jst))

    def extract(pm):
        return (pm.get_opt("plan"), tuple(pm.get_opt("categories") or ()))

    got = store.extract_entity_map(APP, "item", extract, storage=st)
    want = jstore.extract_entity_map(APP, "item", extract, storage=jst)
    assert got.id_to_data == want.id_to_data
    assert got.id_to_ix.to_dict() == want.id_to_ix.to_dict()

    def broken(pm):
        return float(pm.get("plan"))

    with pytest.raises(store.StoreError) as err:
        store.extract_entity_map(APP, "item", broken, storage=st)
    with pytest.raises(jstore.StoreError) as jerr:
        jstore.extract_entity_map(APP, "item", broken, storage=jst)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(store.StoreError, match="Invalid app name"):
        store.find("NoSuchApp", storage=st)


def test_sqlite_entity_reads_take_the_entity_index(tmp_path):
    """A per-entity read on SQLite searches the entity index (not a walk
    of the app in time order) and returns time ties in the order the
    JAX package's SQLite store returns them."""
    jst = JStorage(env={"PIO_FS_BASEDIR": str(tmp_path / "jax")})
    st = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "port")})
    t = [T0 + dt.timedelta(seconds=s) for s in (5, 5, 9, 5, 9, 1)]
    dicts = [{"event": "view", "entity_type": "user", "entity_id": "u1",
              "target_entity_type": "item", "target_entity_id": f"i{k}",
              "event_time": tk} for k, tk in enumerate(t)]
    dicts += [{"event": "view", "entity_type": "user", "entity_id": f"x{k}",
               "target_entity_type": "item", "target_entity_id": "i0",
               "event_time": T0 + dt.timedelta(seconds=k)}
              for k in range(50)]
    for s, app_cls, event_cls, map_cls, write in (
            (jst, JApp, JEvent, JDataMap, jstore.write),
            (st, App, Event, DataMap, store.write)):
        app_id = s.get_meta_data_apps().insert(app_cls(0, APP, None))
        s.get_events().init(app_id)
        for d in dicts:      # one row at a time: rowids in list order
            write(_events([d], event_cls, map_cls), app_id, storage=s)
    for latest in (True, False):
        for limit in (None, 2, 4):
            got = store.find_by_entity(APP, "user", "u1", latest=latest,
                                       limit=limit, storage=st)
            want = jstore.find_by_entity(APP, "user", "u1", latest=latest,
                                         limit=limit, storage=jst)
            assert [_key(e) for e in got] == [_key(e) for e in want]
    sqls = []
    conn = st.get_events()._c
    conn.set_trace_callback(sqls.append)
    try:
        store.find_by_entity(APP, "user", "u1", storage=st)
    finally:
        conn.set_trace_callback(None)
    (select,) = [q for q in sqls if q.startswith("SELECT doc")]
    plan = " ".join(str(r) for r in conn.execute(
        "EXPLAIN QUERY PLAN " + select).fetchall())
    assert "idx_events_entity" in plan, plan
