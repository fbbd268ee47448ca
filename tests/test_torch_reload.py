"""The port's engine server with the realtime fold-in, ``POST /reload`` and
the warm-up before ready (``workflow/create_server.py``,
``serving/aot.py``), on the CPU.

- With fold-in and the warm-up off, every endpoint answers the JAX
  package's bytes (its ``GET /`` key set plus the port's ``device``).
- An unseen user's events become a personalized answer after one
  hand-driven tick; ``GET /`` and ``/debug/device.json`` carry the
  fold-in and warm-up blocks.
- More unseen users than headroom: the worker falls back to the reload,
  the generation goes up by one, the pending users fold into the fresh
  headroom, and a fixed set of concurrent queries drops none.
- ``POST /reload`` under a burst of queries from joined threads: none
  dropped, each client's generations monotone; a failed reload keeps the
  previous generation. Only a query refused by a closed batcher is
  resubmitted; a flush's own error is raised.
- ``pio foldin`` folds into its local copy and exits 0.

No test sleeps or waits on a clock: the worker's thread is never started
(its ticks are driven by hand) and every thread is joined.
"""

import datetime as dt
import json
import threading

import pytest

from predictionio_tpu.data.api.http import dispatch_request as ref_dispatch
from predictionio_tpu.serving import aot as ref_aot
from predictionio_tpu_torch.common import devicewatch, journal, telemetry
from predictionio_tpu_torch.data.api.http import dispatch_request
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    App, EngineInstance, Model, Storage,
)
from predictionio_tpu_torch.realtime import foldin
from predictionio_tpu_torch.serving import BatcherClosed, MicroBatcher, aot
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import json_extractor, model_io

import torch_deploy_util as util
from torch_deploy_util import port_cli  # noqa: F401 (fixture)

APP = "ObsApp"          # the app name util.PARAMS' datasource names
T0 = dt.datetime(2024, 6, 1, tzinfo=dt.timezone.utc)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for name in ("PIO_FOLDIN", "PIO_AOT", "PIO_TORCH_DEVICE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    monkeypatch.setenv("PIO_FOLDIN_USER_BUCKETS", "1,8")
    monkeypatch.setenv("PIO_FOLDIN_MAX_EVENTS", "16")
    monkeypatch.setenv("PIO_FOLDIN_DRIFT_EVERY", "0")
    monkeypatch.setenv("PIO_FOLDIN_CURSOR_DIR", str(tmp_path / "cur"))
    # the worker's ticks are driven by hand: its thread never starts
    monkeypatch.setattr(foldin.FoldinWorker, "start", lambda self: None)
    yield
    devicewatch.note_foldin(None)
    devicewatch.note_aot(None)


def _store():
    """A port memory store holding the app and one COMPLETED instance of
    the dyadic model."""
    ts = Storage(env=util.MEM)
    app_id = ts.get_meta_data_apps().insert(App(0, APP, None))
    ts.get_events().init(app_id)
    iid = ts.get_meta_data_engine_instances().insert(util._instance(
        EngineInstance, "predictionio_tpu_torch.models.recommendation."
        "engine:RecommendationEngine"))
    ts.get_model_data_models().insert(Model(iid, util.dyadic_blob()))
    return ts, app_id


def _api(ts, **kw):
    cfg = dict(device="cpu", serve_quant="on", batching="on",
               batch_max_delay_ms=1.0, foldin="on", foldin_headroom=4,
               foldin_item_headroom=2)
    cfg.update(kw)
    return tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(**cfg))


def _rate(ts, app_id, users, n_items=5):
    evs = [Event(event="rate", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=f"i{(j + k) % 40}",
                 properties=DataMap({"rating": float(1 + (j + k) % 5)}),
                 event_time=T0 + dt.timedelta(minutes=10 * j + k))
           for j, u in enumerate(users) for k in range(n_items)]
    ts.get_events().insert_batch(evs, app_id)


def _post(api, user, num=4):
    return api.handle("POST", "/queries.json",
                      body=util.query(user, num))


def test_wire_parity_with_foldin_and_warm_up_off(monkeypatch):
    japi, tapi = util.deploy_both(util.dyadic_blob())
    try:
        for method, path, body in (
                ("POST", "/queries.json", util.query("u3", 4)),
                ("POST", "/queries.json", util.query("u0", 40)),
                ("POST", "/queries.json", util.query("nobody", 4)),
                ("POST", "/queries.json", b"{bad"),
                ("GET", "/readyz", b""), ("GET", "/healthz", b""),
                ("GET", "/debug/device.json", b""), ("GET", "/nope", b"")):
            want = ref_dispatch(japi, method, path, body, {})
            got = dispatch_request(tapi, method, path, body, {})
            assert (got.status, got.data, got.ctype) == (
                want.status, want.data, want.ctype), path
        jkeys = set(japi.handle("GET", "/")[1])
        tkeys = set(tapi.handle("GET", "/")[1])
        assert tkeys == jkeys | {"device"} == {
            "status", "engineInstance", "algorithms", "requestCount",
            "avgServingSec", "lastServingSec", "degradedCount", "draining",
            "serverStartTime", "generation", "device", "batching", "quant"}
        assert tapi._foldin_worker is None and tapi._aot_state is None
    finally:
        japi.close()
        tapi.close()


def test_unseen_user_folds_in_and_the_blocks_show():
    telemetry.set_enabled(True)
    ts, app_id = _store()
    api = _api(ts, aot="on")
    try:
        assert _post(api, "fresh0") == (200, {"itemScores": []})
        _rate(ts, app_id, ["fresh0"])
        out = api._foldin_worker.tick()
        assert out["appended"] == 1
        status, body = _post(api, "fresh0")
        assert status == 200 and len(body["itemScores"]) == 4
        st = api.handle("GET", "/")[1]
        assert st["foldin"]["usersFolded"] == 1
        assert st["foldin"]["capacity"] == {"rows": util.N_USERS + 4,
                                            "used": util.N_USERS + 1,
                                            "headroomLeft": 3}
        # the warm-up: a batched call per bucket, one inline call, and
        # kernel A's plain version at both fold-in buckets
        warm = st["aot"]
        assert warm["buckets"] == [1, 4, 16, 64]
        assert warm["programs"] == 4 + 1 + 2
        assert api.handle("GET", "/readyz")[1]["aotPrograms"] == 7
        device = json.loads(api.handle("GET", "/debug/device.json")[1])
        assert device["foldin"]["usersFolded"] == 1
        assert device["aot"]["programs"] == 7
        assert device["watchdog"]["servingWarmupDone"] is True
    finally:
        api.close()
        telemetry.set_enabled(None)


def test_warm_up_covers_every_configured_bucket(monkeypatch):
    """Every bucket the batcher can flush is warmed, capped at its max
    batch size, whatever flushes this process has seen; one k, clamped
    to the catalog; PIO_AOT overrides the mode."""
    assert aot.serve_buckets() == (1, 4, 16, 64)
    assert aot.serve_buckets(16) == (1, 4, 16)
    assert aot.serve_buckets(0) == (1, 4, 16, 64)
    assert aot.warm_k(40) == 10 and aot.warm_k(3) == 3
    for name, mode, want in (("", "auto", False), ("", "on", True),
                             ("1", "off", True), ("0", "on", False)):
        monkeypatch.setenv("PIO_AOT", name)
        assert aot.enabled(mode, "cpu") is want, (name, mode)
    # the reference's default k set is the one k warmed here
    monkeypatch.delenv("PIO_AOT_KS", raising=False)
    assert ref_aot.serving_ks(40) == (aot.warm_k(40),)


def _burst(api, users, reloads=0):
    """``len(users)`` client threads, each posting its user's query 12
    times and reading /readyz after each; the main thread posts
    ``reloads`` reloads meanwhile, joining each. Returns every status and
    each client's generations."""
    statuses, gens = [], {u: [] for u in users}
    lock = threading.Lock()
    start = threading.Barrier(len(users) + 1)

    def client(u):
        start.wait()
        for _ in range(12):
            status, _body = _post(api, u)
            gen = api.handle("GET", "/readyz")[1]["generation"]
            with lock:
                statuses.append(status)
                gens[u].append(gen)

    threads = [threading.Thread(target=client, args=(u,)) for u in users]
    for t in threads:
        t.start()
    start.wait()
    for _ in range(reloads):
        assert api.handle("POST", "/reload") == (
            200, {"message": "Reloading..."})
        api._reload_thread.join()
    for t in threads:
        t.join()
        assert not t.is_alive()
    return statuses, gens


def test_headroom_exhaustion_falls_back_to_reload():
    journal.clear()
    ts, app_id = _store()
    api = _api(ts)
    try:
        worker = api._foldin_worker
        horde = [f"horde{j}" for j in range(7)]
        _rate(ts, app_id, horde)
        assert api.generation == 1
        out = {}

        def tick():
            out.update(worker.tick())

        ticker = threading.Thread(target=tick)
        ticker.start()
        statuses, _gens = _burst(api, [f"u{j}" for j in range(6)])
        ticker.join()
        assert out["reloaded"] is True and out["deferred"] == 3
        assert out["appended"] == 4
        assert api.generation == 2 and worker.generation == 2
        # the reload re-padded with room for every known user (twice the
        # folded and pending count) and re-binds the worker; its next
        # tick re-folds all seven into the fresh headroom
        assert worker.state()["capacity"]["rows"] == util.N_USERS + 14
        again = worker.tick()
        assert again["appended"] == 7 and again["deferred"] == 0
        for u in horde:
            status, body = _post(api, u)
            assert status == 200 and body["itemScores"], u
        assert statuses == [200] * len(statuses)
        warns = [e for e in journal.snapshot(level="warn")["events"]
                 if e["category"] == "foldin"]
        assert any("headroom exhausted" in e["message"] for e in warns)
    finally:
        api.close()


def test_reload_under_a_burst_drops_nothing():
    ts, _app_id = _store()
    api = _api(ts, foldin="off")
    try:
        users = [f"u{j}" for j in range(8)]
        want = {u: _post(api, u) for u in users}
        statuses, gens = _burst(api, users, reloads=3)
        assert statuses == [200] * (8 * 12)
        for u, seq in gens.items():
            assert seq == sorted(seq) and seq[-1] <= 4, (u, seq)
        assert api.generation == 4
        # the same instance reloaded: the answers do not move
        assert {u: _post(api, u) for u in users} == want
    finally:
        api.close()


def test_only_a_closed_batcher_is_resubmitted():
    """A query that met a retired (closed) batcher answers from the
    current one; a flush's own RuntimeError on a batcher that is not the
    current one is raised as it came, never retried elsewhere."""
    ts, _app_id = _store()
    api = _api(ts, foldin="off")

    def boom(_items):
        raise RuntimeError("flush failed")

    retired = MicroBatcher(lambda items: items, name="retired")
    failing = MicroBatcher(boom, name="failing")
    try:
        query = json_extractor.extract_query(
            getattr(api.algorithms[0], "query_class", None),
            b'{"user": "u5", "num": 4}')
        want = api._batcher.submit(query)
        retired.close()
        with pytest.raises(BatcherClosed):
            retired.submit(query)
        assert api._submit(retired, query) == want
        with pytest.raises(RuntimeError, match="flush failed") as e:
            api._submit(failing, query)
        assert not isinstance(e.value, BatcherClosed)
    finally:
        failing.close()
        retired.close()
        api.close()


def test_failed_reload_keeps_the_generation(monkeypatch):
    journal.clear()
    ts, _app_id = _store()
    api = _api(ts, foldin="off")
    try:
        before = _post(api, "u5")

        def broken(_blob):
            raise ValueError("unreadable blob")

        monkeypatch.setattr(model_io, "deserialize_models", broken)
        api.handle("POST", "/reload")
        api._reload_thread.join()
        assert api.generation == 1
        assert _post(api, "u5") == before
        warns = journal.snapshot(category="lifecycle",
                                 level="warn")["events"]
        assert any("reload FAILED" in e["message"] for e in warns)
    finally:
        api.close()


def test_pio_foldin_runs_the_standalone_worker(monkeypatch, tmp_path,
                                               port_cli, capsys):
    """``pio foldin --max-ticks 1`` on a store holding an instance and a
    new user's events after the (persisted) cursor: one fold into the
    local copy, exit 0."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    for k in util.MEM:
        monkeypatch.delenv(k, raising=False)
    ts = Storage()
    app_id = ts.get_meta_data_apps().insert(App(0, APP, None))
    ts.get_events().init(app_id)
    iid = ts.get_meta_data_engine_instances().insert(util._instance(
        EngineInstance, "predictionio_tpu_torch.models.recommendation."
        "engine:RecommendationEngine"))
    ts.get_model_data_models().insert(Model(iid, util.dyadic_blob()))
    # the standalone namespace's cursor starts at the head: persist one
    # at the start of the log, so the new user's events are read
    store = foldin.CursorStore(app_id, None, "standalone")
    store.save(ts.get_events().head_cursor(app_id), [], [])
    _rate(ts, app_id, ["solo"])
    assert cli.main(["foldin", "--engine-dir", str(tmp_path),
                     "--max-ticks", "1", "--tick-ms", "1"]) == 0
    out = capsys.readouterr().out
    assert "tick 1: folded=0 appended=1" in out
    assert "1 user(s) folded" in out
    with open(store.path) as f:
        assert json.load(f)["folded"] == ["solo"]
