"""The port's remote storage (``data/storage/remote.py``) against the
reference's, over the wire both ways, and its fault paths.

- Wire compatibility: one seeded sequence of raw RPCs sent to a port
  storage server and to a reference one, each over its own fresh backing
  of one kind (memory, SQLite, eventlog), gives byte-identical JSON
  replies and columnar bytes; each package's client drives the other's
  server through the DAOs to the same results as its own server gives;
  finds page through timestamp ties; model blobs of every byte value
  round-trip; a wrong key is a 401.
- The chaos cases of the reference's ``tests/test_chaos.py``, on the
  port: a server killed between reads, a reply lost mid-read_columns, a
  lost write reply surfaced without dedup and exactly once with it, the
  breaker opening, failing fast and recovering, the spent-deadline 504,
  the drain on SIGTERM, and the connection pool's bound.
- A small ``pio train`` through the port's storage server: factors
  bit-identical to the same train from the local store, and within the
  trained-factor tolerance (rtol 2e-3 / atol 2e-4) of the reference's
  train on the same events with injected initial factors.
- devicewatch's ``pio_breaker_open`` lines and ``breakers`` block equal
  to the reference's for the same breaker states.
"""

import base64
import datetime as dt
import http.client
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.common import devicewatch as ref_devicewatch
from predictionio_tpu.common import resilience as ref_resilience
from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu.data import storage as ref_storage
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.event import Event as RefEvent
from predictionio_tpu.data.storage import remote as ref_remote
from predictionio_tpu_torch.common import devicewatch, resilience, telemetry
from predictionio_tpu_torch.common.resilience import (
    CircuitBreaker, CircuitOpenError,
)
from predictionio_tpu_torch.data import storage as port_storage
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.data.storage import remote
from predictionio_tpu_torch.data.storage.remote import (
    StorageRPCAPI, serve_storage,
)

UTC = dt.timezone.utc
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("memory", "sqlite", "eventlog")
#: (client package, server package)
DIRECTIONS = (("port", "ref"), ("ref", "port"))
PKG = {"ref": (ref_storage, ref_remote, RefEvent, RefDataMap),
       "port": (port_storage, remote, Event, DataMap)}


@pytest.fixture(autouse=True)
def _clean():
    """No fault spec or breaker state leaks between tests."""
    for mod in (ref_resilience, resilience):
        mod.clear()
        mod.CircuitBreaker.reset_registry()
    yield
    for mod in (ref_resilience, resilience):
        mod.clear()
        mod.CircuitBreaker.reset_registry()


def _backing_env(kind: str, root) -> dict:
    if kind == "memory":
        return {"PIO_STORAGE_SOURCES_B_TYPE": "memory",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "B",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "B",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "B"}
    if kind == "sqlite":
        return {"PIO_STORAGE_SOURCES_S_TYPE": "sqlite",
                "PIO_STORAGE_SOURCES_S_PATH": str(root / "pio.sqlite"),
                "PIO_STORAGE_SOURCES_F_TYPE": "localfs",
                "PIO_STORAGE_SOURCES_F_PATH": str(root / "models"),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "F"}
    return {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(root / "el"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}


def _remote_env(port: int, **props) -> dict:
    env = {"PIO_STORAGE_SOURCES_R_TYPE": "remote",
           "PIO_STORAGE_SOURCES_R_URL": f"http://127.0.0.1:{port}",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R"}
    for k, v in props.items():
        env[f"PIO_STORAGE_SOURCES_R_{k}"] = str(v)
    return env


class _Server:
    """One package's storage server over a fresh backing, stopped on
    exit."""

    def __init__(self, pkg: str, kind: str, root, key=None):
        os.makedirs(root, exist_ok=True)
        if kind == "eventlog":
            # a fixed shard token: the eventlog bakes it into event ids
            for name in ("app_1", "app_1_1"):
                shard = os.path.join(root, "el", name)
                os.makedirs(shard, exist_ok=True)
                with open(os.path.join(shard, "shard_id"), "w") as f:
                    f.write("5eed" + name[-4:].replace("_", "0"))
        storage_mod, remote_mod = PKG[pkg][:2]
        self.backing = storage_mod.Storage(env=_backing_env(kind, root))
        self.server = remote_mod.serve_storage(
            self.backing, host="127.0.0.1", port=0, key=key)
        self.port = self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        ev = self.backing.get_events()
        if hasattr(ev, "close"):
            ev.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _event_dicts(seed: int, n: int = 40) -> list:
    """Seeded rate/buy events with explicit ids and creation times and
    many timestamp ties (three events a second)."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2024, 3, 1, tzinfo=UTC)
    out = []
    for k in range(n):
        buy = k % 7 == 0
        out.append({
            "eventId": f"e{k:04d}", "event": "buy" if buy else "rate",
            "entityType": "user", "entityId": f"u{int(rng.integers(6))}",
            "targetEntityType": "item",
            "targetEntityId": f"i{int(rng.integers(9))}",
            "properties": {} if buy else {
                "rating": float(rng.integers(1, 11)) / 2},
            "eventTime": (t0 + dt.timedelta(seconds=k // 3)).isoformat(),
            "creationTime": t0.isoformat()})
    return out


def _instance(rid: str, status: str = "COMPLETED") -> dict:
    t = dt.datetime(2024, 3, 2, tzinfo=UTC).isoformat()
    return {"id": rid, "status": status, "start_time": t, "end_time": t,
            "engine_id": "eng", "engine_version": "1",
            "engine_variant": "default", "engine_factory": "f:F",
            "batch": "", "env": {"A": "1"}, "runtime_conf": {},
            "data_source_params": "{}", "preparator_params": "{}",
            "algorithms_params": "[]", "serving_params": "{}"}


def _raw_ops(seed: int) -> list:
    """(method, target, body bytes) for one seeded operation sequence over
    every DAO, the binary routes and the error paths."""
    ev = _event_dicts(seed)

    def rpc(dao, method, **args):
        return ("POST", "/rpc", json.dumps(
            {"dao": dao, "method": method, "args": args}).encode())

    cols = json.dumps({"app_id": 1, "channel_id": None,
                       "event_names": ["rate", "buy"],
                       "entity_type": "user",
                       "target_entity_type": "item",
                       "rating_property": "rating"}).encode()
    blob = bytes(range(256)) * 9
    ops = [
        ("GET", "/", b""), ("GET", "/healthz", b""), ("GET", "/readyz", b""),
        rpc("apps", "insert", app={"id": 0, "name": "WireApp",
                                   "description": "wire"}),
        rpc("apps", "insert", app={"id": 0, "name": "Other",
                                   "description": None}),
        rpc("apps", "get_by_name", name="WireApp"),
        rpc("apps", "get", app_id=1), rpc("apps", "get", app_id=99),
        rpc("apps", "update", app={"id": 2, "name": "Other2",
                                   "description": "x"}),
        rpc("apps", "get_all"),
        rpc("access_keys", "insert", k={"key": "KEY1", "appid": 1,
                                        "events": ["rate"]}),
        rpc("access_keys", "get", key="KEY1"),
        rpc("access_keys", "get_by_appid", appid=1),
        rpc("channels", "insert", channel={"id": 0, "name": "web",
                                           "appid": 1}),
        rpc("channels", "get_by_appid", appid=1),
        rpc("events", "init", app_id=1, channel_id=None),
        rpc("events", "insert_batch", app_id=1, channel_id=None,
            events=ev[:25]),
        rpc("events", "insert_batch", app_id=1, channel_id=None,
            events=ev[25:]),
        rpc("events", "get", event_id="e0003", app_id=1, channel_id=None),
        rpc("events", "find", app_id=1, channel_id=None),
        rpc("events", "find", app_id=1, channel_id=None, entity_type="user",
            entity_id="u2", offset=1, limit=3),
        rpc("events", "find", app_id=1, channel_id=None,
            event_names=["buy"], reversed=True, limit=4),
        rpc("events", "find", app_id=1, channel_id=None,
            start_time=ev[9]["eventTime"], until_time=ev[20]["eventTime"],
            target_entity_type="item", target_entity_id="i3"),
        rpc("events", "delete", event_id="e0005", app_id=1,
            channel_id=None),
        rpc("events", "get", event_id="e0005", app_id=1, channel_id=None),
        ("POST", "/rpc/read_columns", cols),
        rpc("engine_instances", "insert", i=_instance("inst-a")),
        rpc("engine_instances", "insert", i=_instance("inst-b", "INIT")),
        rpc("engine_instances", "get", instance_id="inst-a"),
        rpc("engine_instances", "get_latest_completed", engine_id="eng",
            engine_version="1", engine_variant="default"),
        rpc("engine_instances", "get_completed", engine_id="eng",
            engine_version="1", engine_variant="default"),
        rpc("engine_instances", "update", i=_instance("inst-b")),
        rpc("engine_instances", "get_all"),
        rpc("engine_instances", "delete", instance_id="inst-a"),
        rpc("evaluation_instances", "insert", i={
            **{k: v for k, v in _instance("ev-1", "EVALCOMPLETED").items()
               if k in ("id", "status", "start_time", "end_time", "batch",
                        "env", "runtime_conf")},
            "evaluation_class": "E", "engine_params_generator_class": "G",
            "evaluator_results": "r", "evaluator_results_html": "<p/>",
            "evaluator_results_json": "{}"}),
        rpc("evaluation_instances", "get_completed"),
        rpc("models", "insert", id="m-json",
            models=base64.b64encode(blob[:100]).decode()),
        rpc("models", "get", model_id="m-json"),
        ("POST", "/rpc/model?id=m-raw", blob),
        ("GET", "/rpc/model?id=m-raw", b""),
        ("GET", "/rpc/model?id=missing", b""),
        rpc("models", "delete", model_id="m-raw"),
        rpc("nope", "get"), rpc("apps", "nope"),
        ("POST", "/rpc", b"not json"), ("GET", "/nowhere", b""),
    ]
    return ops


def _send(port: int, ops, headers=None) -> list:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    out = []
    try:
        for method, target, body in ops:
            conn.request(method, target, body=body, headers=headers or {})
            r = conn.getresponse()
            out.append((r.status, r.getheader("Content-Type"), r.read()))
    finally:
        conn.close()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_wire_replies_are_byte_identical(tmp_path, kind):
    ops = _raw_ops(seed=3)
    got = {}
    for pkg in ("ref", "port"):
        with _Server(pkg, kind, tmp_path / pkg) as s:
            got[pkg] = _send(s.port, ops)
    for k, (op, a, b) in enumerate(zip(ops, got["ref"], got["port"])):
        assert a == b, (k, op[:2], a, b)
    statuses = [s for s, _c, _b in got["port"]]
    assert statuses.count(200) >= len(ops) - 6
    # the columnar reply of the columnar backends is the binary route's
    k = [op[1] for op in ops].index("/rpc/read_columns")
    if kind != "memory":
        assert got["port"][k][2][:4] == b"PIOC"


def _dao_sequence(storage, pkg: str, seed: int) -> list:
    """One seeded sequence through a Storage's DAOs (a remote one in the
    tests), as JSON-able results."""
    storage_mod, _r, event_cls, _dm = PKG[pkg]
    apps = storage.get_meta_data_apps()
    ev = storage.get_events()
    models = storage.get_model_data_models()
    out = []
    app_id = apps.insert(storage_mod.App(0, "DaoApp", "d"))
    out.append(app_id)
    out.append(apps.get_by_name("DaoApp").__dict__)
    storage.get_meta_data_access_keys().insert(
        storage_mod.AccessKey("K", app_id, ("rate",)))
    out.append(storage.get_meta_data_access_keys().get("K").__dict__)
    ch = storage.get_meta_data_channels().insert(
        storage_mod.Channel(0, "web", app_id))
    out.append([c.__dict__ for c in
                storage.get_meta_data_channels().get_by_appid(app_id)])
    ev.init(app_id)
    ev.init(app_id, ch)
    evs = [event_cls.from_dict(d) for d in _event_dicts(seed)]
    ids = ev.insert_batch(evs, app_id)
    out.append(ids)
    out.append(ev.insert_batch(evs[:4], app_id, ch))
    out.append([e.to_dict() for e in ev.find(app_id)])
    out.append([e.to_dict() for e in ev.find(app_id, channel_id=ch)])
    out.append([e.to_dict() for e in ev.find(
        app_id, entity_id="u1", event_names=["rate"], limit=3)])
    out.append(ev.get(ids[7], app_id).to_dict())
    out.append(ev.delete(ids[7], app_id))
    out.append(ev.get(ids[7], app_id))
    try:
        cols = ev.read_columns(app_id, event_names=["rate", "buy"])
        out.append({k: (v.tobytes().hex() if hasattr(v, "tobytes") else v)
                    for k, v in cols.items()})
    except NotImplementedError as e:     # the memory store's answer
        out.append(str(e))
    inst = storage_mod.EngineInstance(
        id="i1", status="COMPLETED",
        start_time=dt.datetime(2024, 3, 2, tzinfo=UTC),
        end_time=dt.datetime(2024, 3, 2, tzinfo=UTC), engine_id="eng",
        engine_version="1", engine_variant="default",
        engine_factory="f:F")
    eis = storage.get_meta_data_engine_instances()
    out.append(eis.insert(inst))
    got = eis.get_latest_completed("eng", "1", "default")
    out.append({k: str(v) for k, v in got.__dict__.items()})
    blob = bytes(range(256)) * 4 + b"\x00\xff"
    models.insert(storage_mod.Model("m1", blob))
    out.append(models.get("m1").models == blob)
    models.delete("m1")
    out.append(models.get("m1"))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_each_client_drives_the_other_packages_server(tmp_path, kind,
                                                      client, server):
    """The cross-package client gets what the server's own client gets."""
    results = []
    for who in (server, client):
        with _Server(server, kind, tmp_path / who) as s:
            storage_mod = PKG[who][0]
            results.append(_dao_sequence(
                storage_mod.Storage(env=_remote_env(s.port)), who, 5))
    assert results[0] == results[1]


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_find_pages_through_timestamp_ties(tmp_path, monkeypatch, client,
                                           server):
    """Pages of 4 over events that share timestamps three at a time: the
    paged find returns every event once, in the backing store's order."""
    monkeypatch.setattr(PKG[client][1].RemoteEvents, "PAGE", 4)
    with _Server(server, "sqlite", tmp_path / "s") as s:
        storage_mod, _r, event_cls, _dm = PKG[server]
        app_id = s.backing.get_meta_data_apps().insert(
            storage_mod.App(0, "TieApp"))
        s.backing.get_events().init(app_id)
        s.backing.get_events().insert_batch(
            [event_cls.from_dict(d) for d in _event_dicts(8, n=31)], app_id)
        want = [e.event_id for e in s.backing.get_events().find(app_id)]
        rs = PKG[client][0].Storage(env=_remote_env(s.port))
        got = [e.event_id for e in rs.get_events().find(app_id)]
        limited = [e.event_id for e in rs.get_events().find(app_id,
                                                            limit=10)]
    assert got == want and len(set(got)) == 31
    assert limited == want[:10]


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_model_blobs_round_trip_and_key_auth(tmp_path, client, server):
    rng = np.random.default_rng(2)
    blob = bytes(range(256)) + rng.integers(0, 256, 1 << 20,
                                            dtype=np.uint8).tobytes()
    with _Server(server, "memory", tmp_path / "s", key="sekrit") as s:
        storage_mod, remote_mod = PKG[client][:2]
        good = storage_mod.Storage(env=_remote_env(s.port, KEY="sekrit"))
        good.get_model_data_models().insert(storage_mod.Model("b", blob))
        assert good.get_model_data_models().get("b").models == blob
        assert s.backing.get_model_data_models().get("b").models == blob
        bad = storage_mod.Storage(env=_remote_env(s.port, KEY="wrong"))
        with pytest.raises(RuntimeError, match="401"):
            bad.get_meta_data_apps().get_all()
        status, _c, body = _send(s.port, [("POST", "/rpc", b"{}")])[0]
        assert (status, json.loads(body)) == (
            401, {"message": "invalid storage key"})


# ---------------------------------------------------------------------------
# the chaos cases (reference tests/test_chaos.py), on the port
# ---------------------------------------------------------------------------

def _mk(eid="u1", iid="i1", rating=3.0, sec=0):
    return Event(event="rate", entity_type="user", entity_id=eid,
                 target_entity_type="item", target_entity_id=iid,
                 properties=DataMap({"rating": rating}),
                 event_time=dt.datetime(2021, 1, 1, tzinfo=UTC)
                 + dt.timedelta(seconds=sec))


def _filled(tmp_path, kind="eventlog", n=20):
    backing = Storage(env=_backing_env(kind, tmp_path))
    app_id = backing.get_meta_data_apps().insert(App(0, "chaos"))
    backing.get_events().init(app_id)
    if n:
        backing.get_events().insert_batch(
            [_mk(f"u{k}", f"i{k % 3}", sec=k) for k in range(n)], app_id)
    return backing, app_id


def test_server_killed_between_reads_recovers_by_reconnect(tmp_path):
    backing, app_id = _filled(tmp_path)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    port = server.server_address[1]
    ev = Storage(env=_remote_env(port)).get_events()
    before = ev.read_columns(app_id, event_names=["rate"])
    assert len(before["rating"]) == 20
    server.shutdown()
    server.server_close()                       # the kill
    server2 = serve_storage(backing, host="127.0.0.1", port=port)
    try:
        after = ev.read_columns(app_id, event_names=["rate"])
        for k in ("entity_code", "target_code", "rating", "time_ms"):
            assert after[k].tobytes() == before[k].tobytes()
        assert len(list(ev.find(app_id))) == 20
    finally:
        server2.shutdown()
        server2.server_close()


def test_reply_lost_mid_read_columns_is_retried(tmp_path):
    backing, app_id = _filled(tmp_path, n=10)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    try:
        rs = Storage(env=_remote_env(server.server_address[1], RETRIES=2,
                                     BACKOFF_MS=1))
        inj = resilience.install("drop_rx:1:1@read_columns")
        cols = rs.get_events().read_columns(app_id, event_names=["rate"])
        assert inj.fired.get("drop_rx") == 1
        direct = backing.get_events().read_columns(app_id,
                                                   event_names=["rate"])
        assert cols["entity_code"].tobytes() == \
            direct["entity_code"].tobytes()
    finally:
        server.shutdown()
        server.server_close()


def test_truncated_columnar_reply_is_detected(tmp_path):
    """A reply cut short, by the server (an injected ``truncate`` at the
    server boundary: the full length advertised, half the bytes sent, the
    connection dropped) or on the client's side, fails the columnar
    integrity check instead of decoding short arrays; healed, the same
    read returns every row."""
    backing, app_id = _filled(tmp_path, n=30)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    try:
        port = server.server_address[1]
        rs = Storage(env=_remote_env(port, RETRIES=2, BACKOFF_MS=1))
        for spec in ("truncate:1:0:1@server POST /rpc/read_columns",
                     "truncate:1@client POST /rpc/read_columns"):
            inj = resilience.install(spec)
            with pytest.raises(RuntimeError,
                               match="truncated columnar reply"):
                rs.get_events().read_columns(app_id)
            assert inj.fired.get("truncate") == 1
        resilience.clear()
        assert len(rs.get_events().read_columns(app_id)["rating"]) == 30
    finally:
        server.shutdown()
        server.server_close()


def test_write_reply_loss_surfaces_without_dedup(tmp_path):
    backing, app_id = _filled(tmp_path, "memory", n=0)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    try:
        rs = Storage(env=_remote_env(server.server_address[1], RETRIES=3,
                                     BACKOFF_MS=1))
        resilience.install("drop_rx:1:1@client POST /rpc")
        with pytest.raises((ConnectionError, OSError)):
            rs.get_events().insert(_mk(), app_id)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if list(backing.get_events().find(app_id)):
                break
            time.sleep(0.01)
        assert len(list(backing.get_events().find(app_id))) == 1
        time.sleep(0.05)          # a (wrong) resend would land by now
        assert len(list(backing.get_events().find(app_id))) == 1
    finally:
        server.shutdown()
        server.server_close()


def test_write_dedup_makes_the_insert_retry_exactly_once(tmp_path,
                                                        monkeypatch):
    """One lost write reply is retried and stored exactly once, and the
    retry is answered from the server's dedup cache (one replay counted).
    The lost reply raises right after the send, so the retry pauses at
    least the base backoff (500 ms, floored through ``backoff_s``'s
    Retry-After floor; full jitter alone draws from [0, base)): the
    original takes its dedup token on the server's threaded transport
    before the retry arrives, under any load."""
    backoff_s = resilience.RetryPolicy.backoff_s

    def floored(self, attempt, floor=0.0, rng=None):
        return backoff_s(self, attempt, max(floor, self.base_delay_s), rng)

    monkeypatch.setattr(resilience.RetryPolicy, "backoff_s", floored)
    telemetry.set_enabled(True)
    backing, app_id = _filled(tmp_path, "memory", n=0)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    try:
        replays = telemetry.registry().counter(
            "pio_rpc_dedup_replays_total",
            "Write retries answered from the server's dedup cache "
            "(exactly-once replays)").child()
        before = replays.value
        rs = Storage(env=_remote_env(server.server_address[1], RETRIES=3,
                                     BACKOFF_MS=500, WRITE_DEDUP=1))
        inj = resilience.install("drop_rx:1:1@client POST /rpc")
        ids = rs.get_events().insert_batch(
            [_mk("u1", "i1"), _mk("u2", "i2", sec=1)], app_id)
        assert inj.fired.get("drop_rx") == 1
        stored = list(backing.get_events().find(app_id))
        assert len(stored) == 2
        assert sorted(ids) == sorted(e.event_id for e in stored)
        assert replays.value == before + 1
    finally:
        telemetry.set_enabled(None)
        server.shutdown()
        server.server_close()


def test_breaker_opens_fails_fast_and_recovers(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BREAKER_ENABLED", "1")
    monkeypatch.setenv("PIO_BREAKER_MIN_CALLS", "4")
    monkeypatch.setenv("PIO_BREAKER_ERROR_RATE", "0.5")
    monkeypatch.setenv("PIO_BREAKER_OPEN_S", "0.3")
    backing, app_id = _filled(tmp_path, "memory", n=0)
    calls = {"n": 0}

    class Counting:
        def __init__(self, inner):
            self.inner = inner

        def handle(self, *a, **kw):
            calls["n"] += 1
            return self.inner.handle(*a, **kw)

    from predictionio_tpu_torch.data.api.http import serve_background
    server, port = serve_background(Counting(StorageRPCAPI(backing)),
                                    host="127.0.0.1")
    try:
        ev = Storage(env=_remote_env(port)).get_events()
        resilience.install("error:1:503@client")
        for _ in range(4):
            with pytest.raises(RuntimeError, match="503"):
                ev.get("nope", app_id)
        wire_before = calls["n"]
        with pytest.raises(CircuitOpenError):
            ev.get("nope", app_id)
        assert calls["n"] == wire_before            # nothing on the wire
        assert CircuitBreaker.for_endpoint(f"127.0.0.1:{port}").state in (
            "open", "half-open")
        resilience.clear()
        time.sleep(0.35)
        assert ev.get("nope", app_id) is None       # the probe closes it
        assert ev.get("nope", app_id) is None
        assert CircuitBreaker.for_endpoint(
            f"127.0.0.1:{port}").state == "closed"
    finally:
        server.shutdown()
        server.server_close()


def test_health_probes_and_the_spent_deadline(tmp_path):
    backing, _app = _filled(tmp_path, "memory", n=0)
    api = StorageRPCAPI(backing, key="sekrit")
    assert api.handle("GET", "/healthz")[0] == 200
    assert api.handle("GET", "/readyz") == (200, {"status": "ready",
                                                  "proto": 3})
    body = json.dumps({"dao": "apps", "method": "get_all",
                       "args": {}}).encode()
    status, _ = api.handle("POST", "/rpc", body=body, headers={
        "X-PIO-Storage-Key": "sekrit", "X-PIO-Deadline-Ms": "0"})
    assert status == 504
    status, _ = api.handle("POST", "/rpc", body=body, headers={
        "X-PIO-Storage-Key": "sekrit", "X-PIO-Deadline-Ms": "250"})
    assert status == 200
    api.draining = True
    assert api.handle("GET", "/readyz") == (503, {"status": "draining"})


def test_deadline_propagates_per_attempt(tmp_path):
    """With PIO_RPC_DEADLINE_MS set, each attempt carries the remaining
    budget; without it, no header rides the wire."""
    backing, app_id = _filled(tmp_path, "memory", n=0)
    seen = []

    class Recording:
        def __init__(self, inner):
            self.inner = inner

        def handle(self, method, path, query=None, body=b"",
                   headers=None):
            seen.append({k.lower(): v for k, v in (headers or {}).items()})
            return self.inner.handle(method, path, query, body, headers)

    from predictionio_tpu_torch.data.api.http import serve_background
    server, port = serve_background(Recording(StorageRPCAPI(backing)),
                                    host="127.0.0.1")
    try:
        Storage(env=_remote_env(port)).get_meta_data_apps().get_all()
        assert "x-pio-deadline-ms" not in seen[-1]
        Storage(env=_remote_env(port, DEADLINE_MS=5000)
                ).get_meta_data_apps().get_all()
        assert 0 < int(seen[-1]["x-pio-deadline-ms"]) <= 5000
    finally:
        server.shutdown()
        server.server_close()


_DRAIN_SCRIPT = textwrap.dedent('''
    import http.client, json, os, signal, sys, threading, time
    sys.modules["jax"] = None
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.tools import cli

    port, remote_env = int(sys.argv[1]), json.loads(sys.argv[2])
    out, errors = {}, []

    def client():
        try:
            t0 = time.time()
            while True:
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=10)
                    conn.request("GET", "/readyz")
                    r = conn.getresponse()
                    out["ready"] = [r.status, json.loads(r.read())]
                    break
                except OSError:
                    if time.time() - t0 > 30:
                        raise
                    time.sleep(0.05)
            rs = Storage(env=remote_env)
            app_id = rs.get_meta_data_apps().insert(App(0, "DrainApp"))
            rs.get_events().init(app_id)
            ids = rs.get_events().insert_batch([Event(
                event="rate", entity_type="user", entity_id=f"u{k}",
                target_entity_type="item", target_entity_id="i1")
                for k in range(7)], app_id)
            out["acked"] = len(ids)
            os.kill(os.getpid(), signal.SIGTERM)
            while True:
                conn.request("GET", "/readyz")
                r = conn.getresponse()
                got = [r.status, json.loads(r.read())]
                if got[0] == 503:
                    out["drain"] = got
                    break
                time.sleep(0.005)
        except BaseException as e:
            errors.append(repr(e))
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client)
    t.start()
    rc = cli.main(["storageserver", "--ip", "127.0.0.1", "--port",
                   str(port)])
    t.join(30)
    print("RESULT " + json.dumps({"rc": rc, "errors": errors, **out}))
''')


def test_storage_server_drains_on_sigterm(tmp_path):
    """``pio storageserver`` under SIGTERM: /readyz answers 503 on an open
    connection, the process exits 0, and every acknowledged write is in
    the eventlog when the store is opened again."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("PIO_")},
           **_backing_env("eventlog", tmp_path),
           "PIO_STORAGE_SOURCES_M_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_M_PATH": str(tmp_path / "meta.sqlite"),
           "PYTHONPATH": REPO, "PIO_TORCH_DEVICE": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _DRAIN_SCRIPT, str(port),
         json.dumps(_remote_env(port))],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("RESULT ")]
    res = json.loads(line[len("RESULT "):])
    assert res["errors"] == [] and res["rc"] == 0, (res, proc.stderr)
    assert res["ready"] == [200, {"status": "ready", "proto": 3}]
    assert res["drain"] == [503, {"status": "draining"}]
    assert "Storage server drained (event buffers flushed)." in proc.stdout
    local = Storage(env={k: v for k, v in env.items()
                         if k.startswith("PIO_STORAGE")})
    (app,) = local.get_meta_data_apps().get_all()
    assert len(list(local.get_events().find(app.id))) == res["acked"] == 7


def test_connection_pool_reuses_and_bounds_sockets(tmp_path):
    backing, app_id = _filled(tmp_path, "memory", n=0)
    server = serve_storage(backing, host="127.0.0.1", port=0)
    try:
        ev = Storage(env=_remote_env(server.server_address[1], POOL=2,
                                     RETRIES=2, BACKOFF_MS=1)).get_events()
        client = ev.c
        ev.insert(_mk("u1"), app_id)
        for _ in range(5):
            assert len(list(ev.find(app_id))) == 1
        t = threading.Thread(target=lambda: list(ev.find(app_id)))
        t.start()
        t.join(10)
        assert not t.is_alive() and client._pool.dials == 1

        def call():
            list(ev.find(app_id))
        threads = [threading.Thread(target=call) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
        assert len(client._pool._idle) <= 2
        dials = client._pool.dials
        resilience.install("drop:1:1@client")
        assert len(list(ev.find(app_id))) == 1
        assert client._pool.dials >= dials
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# a small pio train through the port's storage server
# ---------------------------------------------------------------------------

RANK, ITERS, LAM = 4, 5, 0.07


def _variant(factory):
    return {"id": "default", "engineFactory": factory,
            "datasource": {"params": {"appName": "TrainApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERS, "lambda": LAM,
                "seed": 3}}]}


def _fixed_seed_factors(seed, n_users, n_items, rank, **_kw):
    rng = np.random.default_rng(1234)
    U = np.abs(rng.normal(size=(n_users, rank))) / np.sqrt(rank)
    V = np.abs(rng.normal(size=(n_items, rank))) / np.sqrt(rank)
    return U.astype(np.float32), V.astype(np.float32)


def test_train_through_the_storage_server(tmp_path, monkeypatch):
    from predictionio_tpu.data import store as ref_store
    from predictionio_tpu.models.recommendation.engine import (
        RecommendationEngine as RefEngine,
    )
    from predictionio_tpu.ops import als as ref_als
    from predictionio_tpu.workflow import WorkflowContext as RefContext
    from predictionio_tpu.workflow import model_io as ref_model_io
    from predictionio_tpu.workflow import run_train as ref_run_train
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.models.recommendation.engine import (
        RecommendationEngine,
    )
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.workflow import model_io
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    monkeypatch.setattr(ref_als, "_seed_factors", _fixed_seed_factors)
    monkeypatch.setattr(als, "_seed_factors", _fixed_seed_factors)
    events = _event_dicts(seed=21, n=400)
    for d in events:             # more users and items than the wire test
        d["entityId"] = f"u{int(d['eventId'][1:]) % 37}"
        d["targetEntityId"] = f"i{int(d['eventId'][1:]) * 7 % 23}"

    def fill(storage, app_cls, event_cls, write):
        app_id = storage.get_meta_data_apps().insert(app_cls(0, "TrainApp"))
        storage.get_events().init(app_id)
        write([event_cls.from_dict(d) for d in events], app_id,
              storage=storage)

    def port_train(storage):
        variant = _variant("predictionio_tpu_torch.models.recommendation."
                           "engine:RecommendationEngine")
        engine = RecommendationEngine()
        iid = run_train(WorkflowContext(storage=storage, device="cpu"),
                        engine, engine.engine_params_from_json(variant),
                        engine_factory=variant["engineFactory"],
                        params_json=variant)
        (m,) = model_io.deserialize_models(
            storage.get_model_data_models().get(iid).models)
        return m

    local = Storage(env=_backing_env("eventlog", tmp_path / "local"))
    fill(local, App, Event, store.write)
    want = port_train(local)
    with _Server("port", "eventlog", tmp_path / "served") as s:
        fill(s.backing, App, Event, store.write)
        got = port_train(Storage(env=_remote_env(s.port)))
    assert got.user_vocab.to_dict() == want.user_vocab.to_dict()
    assert got.item_vocab.to_dict() == want.item_vocab.to_dict()
    assert got.user_factors.tobytes() == want.user_factors.tobytes()
    assert got.item_factors.tobytes() == want.item_factors.tobytes()

    jstorage = ref_storage.Storage(env=_backing_env("memory", tmp_path))
    fill(jstorage, ref_storage.App, RefEvent, ref_store.write)
    variant = _variant(
        "predictionio_tpu.models.recommendation.engine:RecommendationEngine")
    engine = RefEngine()
    jid = ref_run_train(RefContext(storage=jstorage), engine,
                        engine.engine_params_from_json(variant),
                        engine_factory=variant["engineFactory"],
                        params_json=variant)
    (jm,) = ref_model_io.deserialize_models(
        jstorage.get_model_data_models().get(jid).models)
    assert got.user_vocab.to_dict() == jm.user_vocab.to_dict()
    np.testing.assert_allclose(got.user_factors, np.asarray(jm.user_factors),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got.item_factors, np.asarray(jm.item_factors),
                               rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# devicewatch: the breaker gauge and block
# ---------------------------------------------------------------------------

def test_devicewatch_breaker_lines_and_block_are_the_reference(
        monkeypatch):
    monkeypatch.setenv("PIO_BREAKER_ENABLED", "1")
    monkeypatch.setenv("PIO_BREAKER_MIN_CALLS", "2")
    monkeypatch.setenv("PIO_BREAKER_OPEN_S", "60")
    got = []
    for res_mod, dw, tm in ((ref_resilience, ref_devicewatch, ref_telemetry),
                            (resilience, devicewatch, telemetry)):
        tm.set_enabled(True)
        try:
            assert dw._collector._breaker_lines() == []
            dead = res_mod.CircuitBreaker.for_endpoint('dead-"store":7072')
            for _ in range(3):
                dead.record(False)
            ok = res_mod.CircuitBreaker.for_endpoint("live:7072")
            for _ in range(5):
                ok.record(True)
            ok.record(False)
            got.append((dw._collector._breaker_lines(),
                        dw.debug_snapshot()["breakers"]))
        finally:
            tm.set_enabled(None)
    assert got[0] == got[1]
    lines, block = got[1]
    assert lines == ["# TYPE pio_breaker_open gauge",
                     'pio_breaker_open{endpoint="dead-\\"store\\":7072"} 1',
                     'pio_breaker_open{endpoint="live:7072"} 0']
    assert [b["state"] for b in block] == ["open", "closed"]


@pytest.mark.parametrize("spec", ["drop:0.5@server", "error:0.5:502@server",
                                  "truncate:0.5@server GET /rpc/model",
                                  "latency:0.3:1@server"])
def test_server_boundary_faults_are_the_reference(tmp_path, spec):
    """The same ``@server`` spec and seed on both packages' threaded
    transports: the same replies, aborted connections (no reply bytes)
    and torn bodies, request by request."""
    from predictionio_tpu.data.api import http as ref_http
    from predictionio_tpu_torch.data.api import http as port_http

    seen = []
    for pkg, res_mod, http_mod in (("ref", ref_resilience, ref_http),
                                   ("port", resilience, port_http)):
        storage_mod, remote_mod = PKG[pkg][:2]
        backing = storage_mod.Storage(env=_backing_env("memory", tmp_path))
        backing.get_model_data_models().insert(
            storage_mod.Model("m", bytes(range(256)) * 8))
        server, port = http_mod.serve_background(
            remote_mod.StorageRPCAPI(backing), "127.0.0.1")
        inj = res_mod.install(spec, seed=5)
        outcomes = []
        try:
            for k in range(16):
                target = "/rpc/model?id=m" if k % 2 else "/readyz"
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                try:
                    conn.request("GET", target)
                    r = conn.getresponse()
                    body = r.read(1 << 20)
                    outcomes.append((r.status, r.getheader("Content-Length"),
                                     body))
                except (http.client.HTTPException, ConnectionError) as e:
                    outcomes.append(type(e).__name__)
                finally:
                    conn.close()
        finally:
            res_mod.clear()
            server.shutdown()
            server.server_close()
        seen.append((outcomes, dict(inj.fired)))
    assert seen[0] == seen[1]
    assert sum(seen[1][1].values()) > 0          # the faults really fired


def test_find_columnar_through_a_remote_source(tmp_path):
    """The training read through a remote source: the columnar reply over
    a columnar store, and the per-event path over a store without one
    (the server's 400 turns into the fallback), both equal to the read
    of the backing store itself."""
    from predictionio_tpu_torch.data import store

    for kind in ("memory", "eventlog"):
        with _Server("port", kind, tmp_path / kind) as s:
            app_id = s.backing.get_meta_data_apps().insert(App(0, "ColApp"))
            s.backing.get_events().init(app_id)
            s.backing.get_events().insert_batch(
                [Event.from_dict(d) for d in _event_dicts(4, n=60)], app_id)
            kw = dict(event_names=["rate", "buy"], entity_type="user",
                      target_entity_type="item")
            want = store.find_columnar("ColApp", storage=s.backing, **kw)
            got = store.find_columnar(
                "ColApp", storage=Storage(env=_remote_env(s.port)), **kw)
        assert got.entity_ids.to_dict() == want.entity_ids.to_dict()
        assert got.target_ids.to_dict() == want.target_ids.to_dict()
        for f in ("entity_idx", "target_idx", "event_name_idx", "rating"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
