"""The port's operator tools (``tools/doctor.py``, ``tools/monitor.py``,
``tools/incident.py``) against the reference's, and live on the CPU.

- Recorded payloads: ``/metrics``, ``/debug/history.json``,
  ``/debug/events.json``, ``/traces.json``, ``/debug/slow.json`` and the
  rest of a daemon's surface, recorded from port daemons driven by
  seeded operation sequences (or built from seeded sequences through the
  port's own recorder and journal), are served to both packages' tools:
  the rendered text and the exit codes are byte-identical.
- Live: ``pio doctor`` green, red on an open breaker (naming it) and
  unreachable, alone and over a fleet; ``pio monitor --once`` and
  ``--record`` / ``--replay``; ``pio incident`` on a clean window (exit 0)
  and with evidence (exit 1).
"""

import datetime as dt
import io
import json
import time

import numpy as np
import pytest

from predictionio_tpu.tools import doctor as ref_doctor
from predictionio_tpu.tools import incident as ref_incident
from predictionio_tpu.tools import monitor as ref_monitor
from predictionio_tpu_torch.common import (
    history, journal, resilience, slo, telemetry, tracing,
)
from predictionio_tpu_torch.data.api import EventAPI
from predictionio_tpu_torch.data.api.http import serve_background
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.tools import cli, doctor, incident, monitor

from torch_deploy_util import (  # noqa: F401
    RecordedDaemon, port_cli, record_routes,
)

pytestmark = pytest.mark.usefixtures("port_cli")

MEM = {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}
DOCTOR_PATHS = ("/healthz", "/readyz", "/", "/metrics",
                "/traces.json?limit=8", "/debug/device.json",
                "/debug/slow.json?limit=3", "/debug/history.json?limit=24")
DEAD = "http://127.0.0.1:9"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """A fresh metrics registry, journal, trace ring, recorder, SLO engine
    and breaker registry for every test (all of them are process-wide)."""
    monkeypatch.setattr(telemetry, "REGISTRY", telemetry.MetricsRegistry())
    for mod in (telemetry, tracing, journal, history):
        mod.set_enabled(None)
    tracing.clear()
    journal.clear()
    history.reset()
    resilience.clear()
    resilience.CircuitBreaker.reset_registry()
    yield
    for mod in (telemetry, tracing, journal, history):
        mod.set_enabled(None)
    tracing.clear()
    journal.clear()
    history.reset()
    slo.reset()
    resilience.CircuitBreaker.reset_registry()


def _now_ms() -> int:
    return int(dt.datetime.now(dt.timezone.utc).timestamp() * 1000)


def _ticked(step_at=None, ticks=9, seed=0, t_end_ms=None):
    """The process recorder with hand ticks of seeded serve traffic, the
    last ``ticks - step_at`` ticks 100x slower when ``step_at`` is set."""
    rng = np.random.default_rng(seed)
    history.reset()
    rec = history.install(history.HistoryConfig(), start=False)
    h = telemetry.registry().histogram(
        "pio_serve_seconds", "serve", labelnames=("mode",)
    ).labels(mode="batched")
    req = telemetry.registry().counter(
        "pio_http_requests_total", "HTTP requests served by daemon and "
        "status", labelnames=("service", "status"))
    t_end = _now_ms() if t_end_ms is None else t_end_ms
    t0 = t_end - (ticks + 1) * 5000
    rec.tick(wall_ms=t0)
    for i in range(ticks):
        slow = step_at is not None and i >= step_at
        for _ in range(int(rng.integers(15, 25))):
            h.observe(0.2 if slow else float(rng.uniform(0.001, 0.003)))
        req.labels(service="EventAPI", status="200").inc(
            int(rng.integers(10, 30)))
        if i % 3 == 2:
            req.labels(service="EventAPI", status="503").inc()
        rec.tick(wall_ms=t0 + (i + 1) * 5000)
    return rec


def _live_event_api():
    api = EventAPI(storage=Storage(env=MEM))
    server, port = serve_background(api, "127.0.0.1")
    return api, server, f"http://127.0.0.1:{port}"


def _stop(server):
    server.shutdown()
    server.server_close()


def _run_both(ref_fn, port_fn, *args, **kw):
    out = []
    for fn in (ref_fn, port_fn):
        buf = io.StringIO()
        rc = fn(*args, out=buf, **kw)
        out.append((rc, buf.getvalue()))
    return out


def _aged_events(seed: int, ages_s, now_s: float) -> list:
    """Seeded WARN/RED journal records at the given ages before now (ages
    chosen inside one rounding step of ``age_str``)."""
    rng = np.random.default_rng(seed)
    out = []
    for k, age in enumerate(ages_s):
        level = ("warn", "red")[int(rng.integers(2))]
        ev = {"seq": k + 1, "ts": now_s - age,
              "at": dt.datetime.fromtimestamp(
                  now_s - age, dt.timezone.utc).isoformat(),
              "level": level, "category": ("breaker", "wal", "retry")[k % 3],
              "message": f"seeded event {k}",
              "fields": {"endpoint": f"storage:{7000 + k}"}}
        if k % 2:
            ev["traceId"] = f"{seed:04x}{k:012x}"
        out.append(ev)
    return out


# ---------------------------------------------------------------------------
# recorded payloads: byte-identical text and exit codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["green", "breaker", "slo", "trend",
                                  "events"])
def test_recorded_doctor_verdicts_are_the_reference(monkeypatch, case):
    """One port daemon's surface per case, recorded after a seeded
    sequence, read by both packages' doctor."""
    telemetry.set_enabled(True)
    journal.set_enabled(True)
    history.set_enabled(True)
    if case == "breaker":
        monkeypatch.setenv("PIO_BREAKER_ENABLED", "1")
        monkeypatch.setenv("PIO_BREAKER_MIN_CALLS", "2")
        br = resilience.CircuitBreaker.for_endpoint("dead-storage:7072")
        for _ in range(3):
            br.record(False)
    api, server, url = _live_event_api()
    try:
        if case == "slo":
            # a baseline, then a burst of 5xx: the fast window burns
            slo.engine().record_snapshot()
            telemetry.registry().counter(
                "pio_http_requests_total",
                "HTTP requests served by daemon and status",
                labelnames=("service", "status")).labels(
                    service="EventAPI", status="503").inc(100)
        if case == "trend":
            _ticked(step_at=6, ticks=12, seed=3)
        for k in range(5):
            urllib_get(url + "/healthz")
        routes = record_routes(url, DOCTOR_PATHS)
    finally:
        _stop(server)
    now_s = time.time()
    events = ([] if case != "events" else
              _aged_events(4, [3.23 * 3600, 3.23 * 3600 - 4, 318.0],
                           now_s))
    stub = RecordedDaemon(routes=routes, events=events)
    try:
        ref, port = _run_both(ref_doctor.run_doctor, doctor.run_doctor,
                              stub.url, timeout=5.0)
        assert ref == port, (ref[1], port[1])
        # the stepped ring also burns the latency SLO: red
        want = {"green": 0, "breaker": 1, "slo": 1, "trend": 1,
                "events": 0}[case]
        assert port[0] == want, port[1]
        ref, port = _run_both(ref_doctor.run_doctor_fleet,
                              doctor.run_doctor_fleet, [stub.url, DEAD],
                              timeout=2.0)
        assert ref == port and port[0] == 2
    finally:
        stub.close()
    if case == "breaker":
        assert "dead-storage:7072" in port[1]
    if case == "trend":
        assert "serve p99 climbing" in port[1]


def urllib_get(url: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_recorded_doctor_unreachable_is_the_reference():
    ref, port = _run_both(ref_doctor.run_doctor, doctor.run_doctor, DEAD,
                          timeout=0.5)
    assert ref == port and port[0] == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_recorded_monitor_frames_are_the_reference(monkeypatch, tmp_path,
                                                   seed):
    """Two daemons' recorded fetches (one with an open breaker and burning
    SLO) and a dead one: the same frame live, recorded and replayed."""
    telemetry.set_enabled(True)
    history.set_enabled(True)
    monkeypatch.setenv("PIO_BREAKER_ENABLED", "1")
    monkeypatch.setenv("PIO_BREAKER_MIN_CALLS", "2")
    paths = ("/debug/history.json?limit=60", "/metrics", "/")
    recorded = []
    for k in range(2):
        telemetry.REGISTRY = telemetry.MetricsRegistry()
        resilience.CircuitBreaker.reset_registry()
        if k == 1:
            br = resilience.CircuitBreaker.for_endpoint("store:7072")
            for _ in range(3):
                br.record(False)
        api, server, url = _live_event_api()
        try:
            _ticked(step_at=None if k == 0 else 5, seed=seed + k)
            recorded.append(record_routes(url, paths))
        finally:
            _stop(server)
    stubs = [RecordedDaemon(routes=r) for r in recorded]
    for mod in (ref_monitor, monitor):
        monkeypatch.setattr(mod, "_now_ms", lambda: 1_700_000_000_000)
    try:
        targets = [s.url for s in stubs] + [DEAD]
        files = [tmp_path / "ref.jsonl", tmp_path / "port.jsonl"]
        live = []
        for mod, rec in zip((ref_monitor, monitor), files):
            buf = io.StringIO()
            rc = mod.run_monitor(targets, once=True, record=str(rec),
                                 timeout=0.5, out=buf)
            live.append((rc, buf.getvalue()))
        assert live[0] == live[1] and live[1][0] == 0
        assert files[0].read_text() == files[1].read_text()
        replays = _run_both(ref_monitor.run_monitor, monitor.run_monitor,
                            [], replay=str(files[1]))
        assert replays[0] == replays[1] and replays[1][0] == 0
        assert "breaker(s) OPEN" in live[1][1] and "DEAD" in live[1][1]
        dead = _run_both(ref_monitor.run_monitor, monitor.run_monitor,
                         [DEAD], once=True, timeout=0.5)
        assert dead[0] == dead[1] and dead[1][0] == 2
    finally:
        for s in stubs:
            s.close()


@pytest.mark.parametrize("evidence", [False, True])
def test_recorded_incident_timelines_are_the_reference(monkeypatch,
                                                       evidence):
    """Journal records, a history ring with (or without) a p99 step, slow
    exemplars and the traces they reference, on two recorded targets:
    the same timeline, skew correction and verdict."""
    now_ms = 1_700_000_600_000
    for mod in (ref_incident, incident):
        monkeypatch.setattr(mod, "_now_ms", lambda: now_ms)
    telemetry.set_enabled(True)
    history.set_enabled(True)
    routes = []
    for k in range(2):
        telemetry.REGISTRY = telemetry.MetricsRegistry()
        _ticked(step_at=6 if (evidence and k == 0) else None, ticks=12,
                seed=10 + k, t_end_ms=now_ms - 1000)
        body = json.dumps(history.snapshot()).encode()
        routes.append({"/debug/history.json": (
            200, "application/json; charset=UTF-8", body)})
    tid = "feed" * 4
    now_s = now_ms / 1e3
    events = [_aged_events(20, [120.0, 60.0, 3600.0], now_s), []]
    if not evidence:
        events[0] = [e for e in events[0] if e["level"] == "warn"
                     and "traceId" not in e] or []
        for e in events[0]:
            e["ts"] = now_s - 7200
    slow = {"requests": [
        {"at": dt.datetime.fromtimestamp(now_s - 30, dt.timezone.utc)
         .isoformat(), "totalMs": 48.5, "traceId": tid,
         "stages": {"admission": 2.0, "dispatch": 40.0, "merge": 1.0}}]}
    routes[1]["/debug/slow.json"] = (
        200, "application/json; charset=UTF-8", json.dumps(slow).encode())
    spans_a = [{"spanId": "a1", "parentId": None, "name": "server:/reload",
                "service": "QueryAPI", "startMs": now_ms - 30_000.0,
                "durationMs": 48.5}]
    spans_b = [{"spanId": "b1", "parentId": "a1", "name": "server:/rpc",
                "service": "StorageRPCAPI", "startMs": now_ms - 27_250.0,
                "durationMs": 40.0}]
    stubs = [RecordedDaemon(routes=routes[0], events=events[0],
                            traces={tid: {"traceId": tid, "spans": spans_a,
                                          "pinned": []}}),
             RecordedDaemon(routes=routes[1], events=events[1],
                            traces={tid: {"traceId": tid, "spans": spans_b,
                                          "pinned": ["slow"]}})]
    try:
        targets = [s.url for s in stubs]
        for window in ("10m", "90s", "2h"):
            ref, port = _run_both(ref_incident.run_incident,
                                  incident.run_incident, targets,
                                  window=window, timeout=2.0)
            assert ref == port, (ref[1], port[1])
        ref, port = _run_both(ref_incident.run_incident,
                              incident.run_incident, targets + [DEAD],
                              window="10m", trace_id=tid, timeout=0.5)
        assert ref == port
        assert port[0] == (1 if evidence else 0), port[1]
        ref, port = _run_both(ref_incident.run_incident,
                              incident.run_incident, [DEAD],
                              window="10m", timeout=0.5)
        assert ref == port and port[0] == 2
    finally:
        for s in stubs:
            s.close()


# ---------------------------------------------------------------------------
# live, on the CPU
# ---------------------------------------------------------------------------

def test_pio_doctor_green_red_and_unreachable(monkeypatch, capsys):
    telemetry.set_enabled(True)
    api, server, url = _live_event_api()
    try:
        assert cli.main(["doctor", url]) == 0
        assert "VERDICT: OK" in capsys.readouterr().out
        monkeypatch.setenv("PIO_BREAKER_ENABLED", "1")
        monkeypatch.setenv("PIO_BREAKER_MIN_CALLS", "2")
        br = resilience.CircuitBreaker.for_endpoint("dead-storage:7072")
        for _ in range(3):
            br.record(False)
        assert cli.main(["doctor", url]) == 1
        text = capsys.readouterr().out
        assert "VERDICT: RED" in text and "dead-storage:7072" in text
        assert cli.main(["doctor", "--targets", f"{url},{DEAD}",
                         "--timeout", "0.5"]) == 2
    finally:
        _stop(server)
    assert cli.main(["doctor", url, "--timeout", "0.5"]) == 2
    assert "unreachable" in capsys.readouterr().out


def test_pio_monitor_once_record_and_replay(tmp_path, capsys):
    telemetry.set_enabled(True)
    history.set_enabled(True)
    api, server, url = _live_event_api()
    rec_file = tmp_path / "fleet.jsonl"
    try:
        _ticked(seed=5)
        assert cli.main(["monitor", "--targets", url, "--once",
                         "--record", str(rec_file)]) == 0
        live = capsys.readouterr().out
    finally:
        _stop(server)
    assert url in live and "DEAD" not in live
    frames = [json.loads(ln) for ln in rec_file.read_text().splitlines()]
    assert len(frames) == 1 and frames[0]["targets"][0]["target"] == url
    assert cli.main(["monitor", "--replay", str(rec_file)]) == 0
    replayed = capsys.readouterr().out
    assert live.splitlines()[2] == replayed.splitlines()[2]
    assert cli.main(["monitor", "--targets", DEAD, "--once",
                     "--timeout", "0.5"]) == 2


def test_pio_incident_clean_then_with_evidence(capsys):
    telemetry.set_enabled(True)
    tracing.set_enabled(True)
    journal.set_enabled(True)
    history.set_enabled(True)
    api1, s1, url1 = _live_event_api()
    api2, s2, url2 = _live_event_api()
    targets = f"{url1},{url2}"
    try:
        _ticked(seed=7)
        journal.clear()
        assert cli.main(["incident", "--targets", targets]) == 0
        assert "VERDICT: clean window" in capsys.readouterr().out
        ctx = tracing.new_context()
        with tracing.activate(ctx):
            tracing.record_span("query.predict", tracing.current(), 0.048,
                                service="engine")
            journal.emit("breaker", "storage breaker OPEN", level="red")
        _ticked(step_at=6, seed=8)
        assert cli.main(["incident", "--targets", targets,
                         "--window", "10m"]) == 1
        text = capsys.readouterr().out
    finally:
        _stop(s1)
        _stop(s2)
    assert "RED" in text and "STEP" in text and "SPAN" in text
    assert "storage breaker OPEN" in text and ctx.trace_id in text
    assert cli.main(["incident", "--targets", DEAD, "--timeout",
                     "0.5"]) == 2
