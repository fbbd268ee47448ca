"""SelfCleaningDataSource in the port against the JAX package, on the
CPU: the JAX package's ``tests/test_self_cleaning.py`` cases, then a
seeded stream, each through both packages on the same events. The
cleaned events, and the rows left in the store after a persisted clean,
are compared **exactly** (event, entity, target, properties, times),
with the reference's (entityType, entityId) grouping."""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.controller import self_cleaning as jsc
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu_torch.controller import self_cleaning as sc
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage

UTC = dt.timezone.utc
NOW = dt.datetime(2021, 6, 10, tzinfo=UTC)
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
PKGS = ((sc, store, Storage, App, Event, DataMap),
        (jsc, jstore, JStorage, JApp, JEvent, JDataMap))


def _key(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_dict(), e.event_time)


def _run(specs, window, persisted=False, twice=False):
    """Each package's cleaned events (or, persisted, the store's rows
    after the clean) for the same ``specs``: [port, jax]."""
    out = []
    for mod, st_mod, storage_cls, app_cls, event_cls, map_cls in PKGS:
        st = storage_cls(env=MEM)
        app_id = st.get_meta_data_apps().insert(app_cls(0, "CleanApp"))
        st.get_events().init(app_id)
        st_mod.write([event_cls(
            event=n, entity_type=et, entity_id=e,
            properties=map_cls(p or {}),
            event_time=dt.datetime(2021, 6, day, hour, tzinfo=UTC), **kw)
            for n, et, e, p, day, hour, kw in specs], app_id, storage=st)

        class DS(mod.SelfCleaningDataSource):
            app_name = "CleanApp"
            event_window = window and mod.EventWindow(**window)

        if persisted:
            for _ in range(2 if twice else 1):
                DS().clean_persisted_events(storage=st, now=NOW)
            got = st_mod.find("CleanApp", storage=st)
        else:
            got = DS().clean_events(storage=st, now=NOW)
        out.append(sorted(map(_key, got), key=repr))
    return out


def ev(name, entity, props=None, day=1, hour=0, etype="user", **kw):
    return (name, etype, entity, props, day, hour, kw)


def test_parse_duration():
    for s in ("3 days", "12h", "90 seconds", "1.5 hours", "250ms", " 2 m "):
        assert sc.parse_duration(s) == jsc.parse_duration(s)
    for bad in ("sideways", "3 fortnights", ""):
        with pytest.raises(ValueError):
            sc.parse_duration(bad)


def test_window_keeps_recent_and_set_events():
    specs = [ev("buy", "u1", day=1), ev("buy", "u1", day=9),
             ev("$set", "u1", {"a": 1}, day=1)]
    got, want = _run(specs, {"duration": "3 days"})
    assert got == want
    assert {(k[0], k[6].day) for k in got} == {("buy", 9), ("$set", 1)}
    got, want = _run(specs, None)
    assert got == want and len(got) == 3


def test_compress_properties_per_entity():
    specs = [ev("$set", "u1", {"a": 1, "b": 2}, day=1),
             ev("$unset", "u1", {"b": None}, day=2),
             ev("$set", "u1", {"c": 3}, day=3),
             ev("$set", "u2", {"x": 9}, day=2),
             ev("$set", "u1", {"z": 0}, day=2, etype="item"),
             ev("buy", "u1", day=4)]
    got, want = _run(specs, {"compress_properties": True})
    assert got == want
    sets = {(k[1], k[2]): k for k in got if k[0] == "$set"}
    assert sets[("user", "u1")][5] == {"a": 1, "c": 3}
    assert sets[("user", "u1")][6].day == 3
    assert sets[("item", "u1")][5] == {"z": 0}      # its own entity


def test_compress_chain_starting_with_unset():
    specs = [ev("$unset", "u1", {"b": None}, day=1),
             ev("$set", "u1", {"a": 1}, day=2)]
    got, want = _run(specs, {"compress_properties": True})
    assert got == want and [k[0] for k in got] == ["$set"]
    assert got[0][5] == {"a": 1}


def test_remove_duplicates_keeps_first():
    specs = [ev("buy", "u1", {"q": 1}, day=2),
             ev("buy", "u1", {"q": 1}, day=5),
             ev("buy", "u1", {"q": 2}, day=5)]
    got, want = _run(specs, {"remove_duplicates": True})
    assert got == want and len(got) == 2
    assert [k[6].day for k in got if k[5] == {"q": 1}] == [2]


def test_clean_persisted_events_rewrites_store():
    specs = [ev("$set", "u1", {"a": 1}, day=1),
             ev("$set", "u1", {"b": 2}, day=2),
             ev("buy", "u1", day=3), ev("buy", "u1", day=3)]
    window = {"compress_properties": True, "remove_duplicates": True}
    got, want = _run(specs, window, persisted=True)
    assert got == want
    assert [k[0] for k in got].count("$set") == 1
    assert [k[5] for k in got if k[0] == "$set"] == [{"a": 1, "b": 2}]
    again, jagain = _run(specs, window, persisted=True, twice=True)
    assert again == jagain == got                 # idempotent


@pytest.mark.parametrize("window", [
    {"duration": "4 days"},
    {"duration": "6 days", "compress_properties": True},
    {"remove_duplicates": True, "compress_properties": True},
    {"duration": "5 days", "remove_duplicates": True,
     "compress_properties": True},
])
def test_seeded_stream_cleans_as_the_reference(window):
    rng = np.random.default_rng(17)
    specs = []
    for _ in range(120):
        kind = rng.choice(["$set", "$unset", "view", "buy"])
        who = f"u{rng.integers(6)}"
        props = ({f"p{rng.integers(3)}": int(rng.integers(3))}
                 if kind != "view" else {})
        kw = ({} if kind.startswith("$") else
              {"target_entity_type": "item",
               "target_entity_id": f"i{rng.integers(4)}"})
        specs.append(ev(str(kind), who, props, day=int(rng.integers(1, 10)),
                        hour=int(rng.integers(3)),
                        etype=str(rng.choice(["user", "shop"])), **kw))
    got, want = _run(specs, window)
    assert got == want
    got, want = _run(specs, window, persisted=True)
    assert got == want
