"""The port's metrics registry (``common/telemetry.py``) and telemetry
routes against the JAX package's.

The same seeded sequence of operations drives a fresh registry of each
package: the Prometheus 0.0.4 and the OpenMetrics expositions must be
byte-identical (float formatting, label escaping, family order, the
``_total`` renaming, exemplars only in OpenMetrics, collector lines).
Then the route table: ``handle_route`` itself, and the telemetry routes
of all four of the port's daemons (event server, engine server, admin,
dashboard) against the reference's, with the knobs off and on — the
same status, content type and body shape, ``/debug/history.json``
included. With the knobs on, the
answers to ``/queries.json`` and ``/events.json`` keep their bytes, and
a scrape of the event server never touches the card.
"""

import json
import re

import numpy as np
import pytest
import torch

from predictionio_tpu.common import journal as ref_journal
from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu.common import tracing as ref_tracing
from predictionio_tpu.common import waterfall as ref_waterfall
from predictionio_tpu.data.api import service as ref_service
from predictionio_tpu.data.api.http import dispatch_request as ref_dispatch
from predictionio_tpu.data.storage import Storage as RefStorage
from predictionio_tpu.tools.admin import AdminAPI as RefAdminAPI
from predictionio_tpu.tools.dashboard import DashboardAPI as RefDashboardAPI
from predictionio_tpu_torch.common import (
    journal, telemetry, tracing, waterfall,
)
from predictionio_tpu_torch.data.api import service
from predictionio_tpu_torch.data.api.http import dispatch_request
from predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from predictionio_tpu_torch.tools.admin import AdminAPI
from predictionio_tpu_torch.tools.dashboard import DashboardAPI

import torch_deploy_util as util

PAIRS = ((ref_telemetry, telemetry), (ref_tracing, tracing),
         (ref_waterfall, waterfall), (ref_journal, journal))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in util.KNOBS:
        monkeypatch.delenv(name, raising=False)
    for ref, port in PAIRS:
        for mod in (ref, port):
            mod.set_enabled(None)
    for mod in (ref_tracing, tracing, ref_waterfall, waterfall,
                ref_journal, journal):
        mod.clear()
    yield
    for ref, port in PAIRS:
        for mod in (ref, port):
            mod.set_enabled(None)


# ---------------------------------------------------------------------------
# the registry, byte for byte
# ---------------------------------------------------------------------------

LABEL_VALUES = ("a", 'quo"te', "back\\slash", "new\nline", "", "ünï")
VALUES = (0.0, 1.0, 0.1, 2.5, 1e-07, 1e20, -3.0, 123456789.0, 7e15)


def _ops(seed: int):
    """A seeded list of registry operations, applied alike to both."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        kind = ("counter", "gauge", "histogram")[rng.integers(3)]
        fam = int(rng.integers(4))
        label = LABEL_VALUES[rng.integers(len(LABEL_VALUES))]
        value = float(VALUES[rng.integers(len(VALUES))])
        exemplar = (f"t{int(rng.integers(1000)):03d}"
                    if rng.integers(2) else None)
        ops.append((kind, fam, label, value, exemplar))
    return ops


def _apply(mod, ops):
    reg = mod.MetricsRegistry()
    for kind, fam, label, value, exemplar in ops:
        # even families carry a label and a help text; odd ones neither;
        # counter family 1 lacks the _total suffix (OpenMetrics unknown)
        suffix = "_total" if kind == "counter" and fam != 1 else ""
        name = f"pio_test_{kind}_{fam}{suffix}"
        labels = ("who",) if fam % 2 == 0 else ()
        help_ = f"{kind} {fam} help" if fam % 2 == 0 else ""
        if kind == "histogram":
            family = reg.histogram(name, help_, labels,
                                   buckets=(0.1, 1.0, 2.5, 1e6))
        else:
            family = getattr(reg, kind)(name, help_, labels)
        child = family.labels(who=label) if labels else family.child()
        if kind == "counter":
            child.inc(abs(value))
        elif kind == "gauge":
            child.set(value) if exemplar else child.inc(value)
        else:
            child.observe(value, exemplar=exemplar)

    def collector():
        yield "# TYPE pio_collected_total counter"
        yield 'pio_collected_total{app_id="1"} 3'
        yield "# TYPE pio_collected_plain counter"
        yield "pio_collected_plain 2"
        yield "# TYPE pio_collected_gauge gauge"
        yield "pio_collected_gauge 0.5"

    reg.register_collector(collector)
    reg.register_collector(collector)      # deduped, like the reference
    return reg


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["classic", "openmetrics"])
@pytest.mark.parametrize("seed", range(5))
def test_exposition_byte_identical(seed, openmetrics):
    ops = _ops(seed)
    want = _apply(ref_telemetry, ops).exposition(openmetrics=openmetrics)
    got = _apply(telemetry, ops).exposition(openmetrics=openmetrics)
    assert got == want
    assert ("# {trace_id=" in got) == (openmetrics and any(
        op[0] == "histogram" and op[4] for op in ops))
    assert got.endswith("# EOF\n" if openmetrics else "\n")


@pytest.mark.parametrize("value", [0, 1, -1, 0.5, 1e15, 1e16, 2.0 ** 60,
                                   float("inf"), float("-inf"), 1 / 3])
def test_number_formatting(value):
    assert telemetry._fmt_number(value) == ref_telemetry._fmt_number(value)


def test_registry_dict_and_snapshots_match():
    stats = []
    for mod in (ref_telemetry, telemetry):
        reg = mod.MetricsRegistry()
        d = mod.RegistryDict(reg.counter("pio_layout_cache_total", "x",
                                         labelnames=("result",)),
                             "result", ("hits", "builds"))
        d["hits"] += 1
        d["builds"] += 3
        d["hits"] += 2
        h = reg.histogram("pio_h", buckets=(1.0, 2.0)).child()
        for v in (0.5, 1.5, 3.0, 1.0):
            h.observe(v)
        stats.append((d.items(), "hits" in d, list(d.keys()), h.snapshot(),
                      reg.exposition()))
    assert stats[0] == stats[1]


@pytest.mark.parametrize("name,labels", [
    ("1bad", ()), ("bad-name", ()), ("ok", ("le",)), ("ok", ("__x",)),
    ("ok", ("bad-label",)), ("", ())])
def test_invalid_names_refused_alike(name, labels):
    with pytest.raises(ValueError) as ref_err:
        ref_telemetry.validate_names(name, labels)
    with pytest.raises(ValueError) as err:
        telemetry.validate_names(name, labels)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("accept", [
    None, "", "text/plain", "application/openmetrics-text; version=1.0.0",
    "Application/OpenMetrics-Text;q=0.5,text/plain;q=0.1"])
def test_accept_negotiation(accept):
    assert telemetry.accepts_openmetrics(accept) == \
        ref_telemetry.accepts_openmetrics(accept)


# ---------------------------------------------------------------------------
# handle_route
# ---------------------------------------------------------------------------

#: (method, path, query) -> compare the bodies byte for byte (the rings
#: are empty on both sides) or, for the device page with telemetry on,
#: the key sets
ROUTES = [
    ("GET", "/traces.json", None),
    ("GET", "/traces.json", {"limit": "x"}),
    ("GET", "/traces.json", {"limit": "5000", "trace_id": "abc"}),
    ("GET", "/debug/slow.json", None),
    ("GET", "/debug/slow.json", {"limit": "bad"}),
    ("GET", "/debug/events.json", None),
    ("GET", "/debug/events.json", {"since_seq": "x"}),
    ("GET", "/debug/events.json", {"level": "loud"}),
    ("GET", "/debug/events.json", {"limit": "?"}),
    ("GET", "/debug/device.json", None),
    ("GET", "/debug/history.json", {"since_ms": "x"}),
    ("GET", "/debug/history.json", {"res": "medium"}),
    ("GET", "/debug/history.json", {"limit": "?"}),
    ("POST", "/metrics", None),
    ("GET", "/nope", None),
]


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("method,path,query", ROUTES)
def test_handle_route_matches_the_reference(method, path, query, on):
    for ref, port in PAIRS:
        ref.set_enabled(on)
        port.set_enabled(on)
    want = ref_telemetry.handle_route(method, path, query)
    got = telemetry.handle_route(method, path, query)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    assert (got[2:] or ({},))[0] == (want[2:] or ({},))[0]
    if path == "/debug/device.json" and on:
        ref_keys = set(json.loads(want[1]))
        assert set(json.loads(got[1])) == ref_keys
        assert json.loads(got[1])["watchdog"].keys() == \
            json.loads(want[1])["watchdog"].keys()
    else:
        assert json.dumps(got[1]) == json.dumps(want[1])


@pytest.mark.parametrize("accept", [None, "application/openmetrics-text"])
def test_metrics_route_content_types(accept):
    want = ref_telemetry.handle_route("GET", "/metrics", None, accept)
    got = telemetry.handle_route("GET", "/metrics", None, accept)
    assert got[0] == want[0] == 200
    assert got[2] == want[2]
    assert got[1].endswith("# EOF\n") == want[1].endswith("# EOF\n")


def test_history_route_is_not_ported():
    """The metrics history, once the one unported debug surface, now
    answers as the reference's: the same status and keys, and the same
    debug paths on every daemon."""
    want = ref_telemetry.handle_route("GET", "/debug/history.json")
    got = telemetry.handle_route("GET", "/debug/history.json")
    assert got[0] == want[0] == 200
    assert sorted(got[1]) == sorted(want[1])
    assert got[1]["retention"] == want[1]["retention"]
    assert "/debug/history.json" in telemetry.DEBUG_PATHS
    assert set(telemetry.DEBUG_PATHS) == set(ref_telemetry.DEBUG_PATHS)


# ---------------------------------------------------------------------------
# the four daemons' route tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def daemons():
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_SERVE_QUANT", "on")
    mp.setenv("PIO_SERVE_FUSED", "off")
    mp.delenv("PIO_TORCH_DEVICE", raising=False)
    for name in util.KNOBS:
        mp.delenv(name, raising=False)
    japi, tapi = util.deploy_both(util.dyadic_blob())
    rs, ts = RefStorage(env=util.MEM), Storage(env=util.MEM)
    pairs = {
        "event": (ref_service.EventAPI(storage=rs),
                  service.EventAPI(storage=ts)),
        "engine": (japi, tapi),
        "admin": (RefAdminAPI(storage=rs), AdminAPI(storage=ts)),
        "dashboard": (RefDashboardAPI(storage=rs), DashboardAPI(storage=ts)),
    }
    try:
        yield pairs
    finally:
        japi.close()
        tapi.close()
        mp.undo()


DAEMON_ROUTES = [
    ("GET", "/metrics"), ("GET", "/traces.json"),
    ("GET", "/debug/device.json"), ("GET", "/debug/slow.json"),
    ("GET", "/debug/events.json"), ("GET", "/debug/profile"),
    ("POST", "/debug/profile?ms=abc"), ("POST", "/debug/profile?ms=10"),
    ("DELETE", "/debug/profile"), ("GET", "/debug/history.json"),
]

_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$')


def _shape(data, ctype):
    if ctype.startswith("application/json"):
        body = json.loads(data)
        return sorted(body) if isinstance(body, dict) else type(body)
    return None


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("daemon", ["event", "engine", "admin",
                                    "dashboard"])
def test_daemon_telemetry_routes_match_the_reference(daemons, monkeypatch,
                                                      daemon, on):
    ref_api, api = daemons[daemon]
    monkeypatch.setenv("PIO_PROFILE_ENABLE", "0")   # no capture starts
    for ref, port in PAIRS:
        ref.set_enabled(on)
        port.set_enabled(on)
    for method, target in DAEMON_ROUTES:
        want = ref_dispatch(ref_api, method, target, b"", {})
        got = dispatch_request(api, method, target, b"", {})
        status, data, ctype = got.status, got.data, got.ctype
        assert (status, ctype) == (want.status, want.ctype), (daemon, target)
        if target == "/metrics":
            lines = data.decode().splitlines()
            assert all(_SAMPLE.match(x) for x in lines
                       if not x.startswith("#")), daemon
        elif target == "/debug/device.json" and not on:
            assert data == want.data == b'{\n  "telemetry": false\n}'
        else:
            assert _shape(data, ctype) == _shape(want.data, want.ctype), (
                daemon, target)


def test_queries_and_events_keep_their_bytes_with_the_knobs_on(
        daemons, monkeypatch):
    _ref_api, api = daemons["engine"]
    store = Storage(env=util.MEM)
    app_id = store.get_meta_data_apps().insert(App(0, "obs", None))
    store.get_events().init(app_id)
    store.get_meta_data_access_keys().insert(AccessKey("key", app_id, ()))
    ev_api = service.EventAPI(storage=store)
    bodies = [util.query(f"u{i}", n) for i, n in
              ((0, 3), (5, 10), (23, 1), (7, 40))] + [util.query("nobody",
                                                                  4)]
    event = json.dumps({"event": "rate", "entityType": "user",
                        "entityId": "u1", "eventId": "e1",
                        "eventTime": "2021-01-01T00:00:00.000Z",
                        "creationTime": "2021-01-01T00:00:00.000Z"}
                       ).encode()
    answers = []
    for on in (False, True):
        for mod in (telemetry, tracing, waterfall):
            mod.set_enabled(on)
        outs = [dispatch_request(api, "POST", "/queries.json", b, {})
                for b in bodies]
        outs.append(dispatch_request(ev_api, "POST",
                                     "/events.json?accessKey=key", event,
                                     {}))
        got = [(o.status, o.data, o.ctype) for o in outs]
        answers.append(got)
    assert answers[0] == answers[1]
    assert all(a[0] == 200 for a in answers[0][:-1])
    assert answers[0][-1][:2] == (201, b'{"eventId": "e1"}')
    status = dispatch_request(api, "GET", "/", b"", {})
    ref_status = dispatch_request(_ref_api, "GET", "/", b"", {})
    keys = json.loads(status.data)
    want = json.loads(ref_status.data)
    assert sorted(keys["batching"]) == sorted(want["batching"])
    assert keys["quant"] == want["quant"]


def test_event_server_scrape_never_touches_the_card(monkeypatch):
    """The collector reads the card only when a CUDA context exists: the
    event server's /metrics and /debug/device.json, telemetry on, call
    nothing of torch.cuda but is_initialized()."""
    def forbidden(*_a, **_k):
        raise AssertionError("a scrape touched torch.cuda")

    for name in ("memory_stats", "device_count", "mem_get_info",
                 "get_device_properties", "synchronize", "init",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    telemetry.set_enabled(True)
    api = service.EventAPI(storage=Storage(env=util.MEM))
    out = dispatch_request(api, "GET", "/metrics", b"", {})
    assert out.status == 200 and "pio_live_arrays 0" in out.data.decode()
    assert "pio_hbm_bytes_in_use" not in out.data.decode()
    out = dispatch_request(api, "GET", "/debug/device.json", b"", {})
    assert out.status == 200 and json.loads(out.data)["devices"] == []
    assert torch.cuda.is_initialized() is False
