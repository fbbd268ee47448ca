"""Shared set-up for the port's observability tests: the same small ALS
model (dyadic-grid factors, so every product is exact) deployed in the
JAX package's QueryAPI and in the port's, each on its own in-memory
store, plus the other daemons of both packages."""

import datetime as dt
import json
import os

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import EngineInstance as JEngineInstance
from predictionio_tpu.data.storage import Model as JModel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage
from predictionio_tpu_torch.workflow import create_server as tserver

N_USERS, N_ITEMS, RANK = 24, 40, 4
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
PARAMS = {
    "datasource": json.dumps({"params": {"appName": "ObsApp"}}),
    "algorithms": json.dumps([{"name": "als", "params": {
        "rank": RANK, "numIterations": 2, "lambda": 0.01, "seed": 3}}]),
}
#: the variables that switch the port's observability on; the tests
#: clear them first so the process environment cannot leak in
KNOBS = ("PIO_TELEMETRY", "PIO_TRACE", "PIO_WATERFALL", "PIO_JOURNAL",
         "PIO_PROFILE_ENABLE", "PIO_PROFILE_DIR", "PIO_WATERFALL_SAMPLE",
         "PIO_SLOW_RING", "PIO_SERVE_WARMUP_FLUSHES")


#: every variable the port's ``pio`` verbs write into ``os.environ``
#: (tools/cli.py); a test that calls ``cli.main`` registers them first
CLI_ENV = ("PIO_TELEMETRY", "PIO_TRACE", "PIO_SYNTHETIC_EVENTS",
           "PIO_SYNTHETIC_SEED", "PIO_AUTO_RESUME", "PIO_WATERFALL",
           "PIO_PROFILE_DIR")


@pytest.fixture
def port_cli(monkeypatch):
    """Isolation for a test that calls the port's ``cli.main`` or reaches
    its ``get_storage()`` singleton: the verbs' environment writes are
    undone at teardown, and the singleton is dropped before and after,
    so neither a store nor a switch outlives the test. Use it through
    ``pytestmark = pytest.mark.usefixtures("port_cli")`` after importing
    it into the test module."""
    for name in CLI_ENV:
        # setenv registers the variable's prior state (absent included)
        # for restoration; a variable absent before is then removed
        monkeypatch.setenv(name, os.environ.get(name, ""))
        if not os.environ[name]:
            monkeypatch.delenv(name)
    storage_mod.reset_storage()
    yield
    storage_mod.reset_storage()


def dyadic_blob(seed: int = 11) -> bytes:
    """A serialized ALS model whose factors lie on a 1/8 grid."""
    rng = np.random.default_rng(seed)
    U = rng.integers(-8, 9, size=(N_USERS, RANK)).astype(np.float32) / 8
    V = rng.integers(-8, 9, size=(N_ITEMS, RANK)).astype(np.float32) / 8
    return jmodel_io.serialize_models([JALSModel(
        rank=RANK, user_factors=U, item_factors=V,
        user_vocab=JBiMap.string_int(f"u{i}" for i in range(N_USERS)),
        item_vocab=JBiMap.string_int(f"i{i}" for i in range(N_ITEMS)))])


def _instance(cls, factory):
    now = dt.datetime(2024, 5, 6, tzinfo=dt.timezone.utc)
    return cls(id="", status="COMPLETED", start_time=now, end_time=now,
               engine_id="default", engine_version="NOT_USED",
               engine_variant="default", engine_factory=factory,
               data_source_params=PARAMS["datasource"],
               algorithms_params=PARAMS["algorithms"])


def deploy_both(blob: bytes, batching: str = "on"):
    """(reference QueryAPI, port QueryAPI) serving ``blob`` quantized on
    the CPU through the plain int8 path; the caller closes both. Set
    PIO_SERVE_QUANT=on and PIO_SERVE_FUSED=off first."""
    js = JStorage(env=MEM)
    jid = js.get_meta_data_engine_instances().insert(_instance(
        JEngineInstance,
        "predictionio_tpu.models.recommendation.engine:"
        "RecommendationEngine"))
    js.get_model_data_models().insert(JModel(jid, blob))
    ts = Storage(env=MEM)
    tid = ts.get_meta_data_engine_instances().insert(_instance(
        EngineInstance,
        "predictionio_tpu_torch.models.recommendation.engine:"
        "RecommendationEngine"))
    ts.get_model_data_models().insert(Model(tid, blob))
    cfg = dict(batching=batching, batch_max_delay_ms=1.0)
    japi = jserver.QueryAPI(storage=js, config=jserver.ServerConfig(
        serve_quant="on", aot="off", **cfg))
    tapi = tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
        device="cpu", serve_quant="on", **cfg))
    return japi, tapi


def query(user: str, num: int) -> bytes:
    return json.dumps({"user": user, "num": num}).encode()


_SEVERITY = {"info": 0, "warn": 1, "red": 2}


class RecordedDaemon:
    """A daemon stand-in on 127.0.0.1 that answers recorded payloads, so
    both packages' operator tools (``pio doctor``, ``trace``, ``events``,
    ``monitor``, ``incident``) read the same bytes. ``routes`` maps a path
    (no query) to ``(status, content type, body bytes)``; ``events`` is a
    recorded journal (``journal.snapshot()["events"]``), filtered by
    ``since_seq`` / ``level`` / ``category`` / ``limit`` as the journal
    does; ``traces`` maps a trace id to its ``/traces.json`` entry.
    Stop it with :meth:`close`."""

    def __init__(self, routes=None, events=None, traces=None):
        import threading
        import urllib.parse
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        owner = self
        self.routes = dict(routes or {})
        self.events = list(events) if events is not None else None
        self.traces = dict(traces or {})

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                u = urllib.parse.urlsplit(self.path)
                q = dict(urllib.parse.parse_qsl(u.query))
                status, ctype, body = owner.answer(u.path, q)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def answer(self, path, q):
        js = "application/json; charset=UTF-8"
        if path == "/debug/events.json" and self.events is not None:
            since = int(q.get("since_seq", 0))
            floor = _SEVERITY.get(q.get("level") or "info", 0)
            out = [e for e in self.events if e["seq"] > since
                   and _SEVERITY.get(e["level"], 0) >= floor
                   and (not q.get("category")
                        or e["category"] == q["category"])]
            out = out[-max(1, int(q.get("limit", 256))):]
            last = max((e["seq"] for e in self.events), default=0)
            return 200, js, json.dumps({
                "enabled": True, "capacity": 1024, "lastSeq": last,
                "events": out}).encode()
        if path == "/traces.json" and self.traces:
            want = q.get("trace_id")
            traces = [t for tid, t in self.traces.items()
                      if want is None or tid == want]
            return 200, js, json.dumps({"traces": traces}).encode()
        if path in self.routes:
            return self.routes[path]
        return 404, js, b'{"message": "not found"}'

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def record_routes(base_url: str, paths) -> dict:
    """GET each path of a live daemon: ``{path without query: (status,
    content type, body)}`` for :class:`RecordedDaemon`."""
    import urllib.error
    import urllib.request

    out = {}
    for path in paths:
        try:
            with urllib.request.urlopen(base_url + path, timeout=10) as r:
                got = (r.status, r.headers.get("Content-Type"), r.read())
        except urllib.error.HTTPError as e:
            got = (e.code, e.headers.get("Content-Type"), e.read())
        out[path.split("?", 1)[0]] = got
    return out
