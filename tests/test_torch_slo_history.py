"""The port's SLO engine (``common/slo.py``) and metrics flight recorder
(``common/history.py``) against the JAX package's.

With ``PIO_TELEMETRY=1``, every daemon of both packages (event server,
engine server, admin, dashboard) exposes the same metric family names on
``/metrics``, the ``pio_slo_*`` and ``pio_history_*`` families included,
and ``/debug/history.json`` answers 200 with series. Then a seeded
sequence of registry operations, with the recorder's ticks driven by hand
(``Recorder.tick(wall_ms=...)``; no sampler thread, no sleep) and the
SLO engine on a hand-driven clock, gives byte-identical
``/debug/history.json`` bodies and SLO expositions in both packages.
"""

import json
import re
import types

import numpy as np
import pytest

from predictionio_tpu.common import devicewatch as ref_devicewatch
from predictionio_tpu.common import history as ref_history
from predictionio_tpu.common import journal as ref_journal
from predictionio_tpu.common import slo as ref_slo
from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu.data.api import service as ref_service
from predictionio_tpu.data.api.http import dispatch_request as ref_dispatch
from predictionio_tpu.data.storage import Storage as RefStorage
from predictionio_tpu.tools.admin import AdminAPI as RefAdminAPI
from predictionio_tpu.tools.dashboard import DashboardAPI as RefDashboardAPI
from predictionio_tpu_torch.common import (
    devicewatch, history, journal, slo, telemetry,
)
from predictionio_tpu_torch.data.api import service
from predictionio_tpu_torch.data.api.http import dispatch_request
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.tools.admin import AdminAPI
from predictionio_tpu_torch.tools.dashboard import DashboardAPI

import torch_deploy_util as util

#: (reference module, port module) pairs of the process-wide state
PACKAGES = ((ref_telemetry, ref_history, ref_slo, ref_journal),
            (telemetry, history, slo, journal))
#: the device watches: a serving warmup that an earlier test armed (a
#: reference deploy's AOT prebuild marks it done) turns the reference's
#: first compile here into a post-warmup recompile family the port has no
#: counterpart of, so both start and end disarmed
WATCHDOGS = (ref_devicewatch, devicewatch)

#: families that count compile events: the reference's come from JAX's
#: XLA compiles, the port's from building the hand-written kernels with
#: nvcc, which never runs on the CPU (the card's smoke sees them)
COMPILE_FAMILIES = re.compile(r"^pio_xla_compile")


@pytest.fixture
def fresh(monkeypatch):
    """Fresh registries, no recorder or SLO engine, telemetry on."""
    for tel, hist, slo_mod, jour in PACKAGES:
        monkeypatch.setattr(tel, "REGISTRY", tel.MetricsRegistry())
        tel.set_enabled(True)
        hist.reset()
        slo_mod.reset()
        jour.clear()
    for watch in WATCHDOGS:
        watch.reset_watchdog()
    for name in util.KNOBS + ("PIO_HISTORY", "PIO_HISTORY_TICK_S",
                              "PIO_HISTORY_MAX_SERIES"):
        monkeypatch.delenv(name, raising=False)
    for name in ("PIO_SLO_AVAILABILITY", "PIO_SLO_LATENCY_MS",
                 "PIO_SLO_LATENCY_TARGET", "PIO_SLO_FAST_WINDOW_S",
                 "PIO_SLO_SLOW_WINDOW_S"):
        monkeypatch.delenv(name, raising=False)
    # an hour between sampler ticks: the tests tick by hand
    monkeypatch.setenv("PIO_HISTORY_TICK_S", "3600")
    yield
    for tel, hist, slo_mod, _jour in PACKAGES:
        tel.set_enabled(None)
        hist.reset()
        slo_mod.reset()
    for watch in WATCHDOGS:
        watch.reset_watchdog()


def _families(text: str) -> set:
    names = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            names.add(line.split()[2])
        elif line and not line.startswith("#"):
            names.add(re.split(r"[{ ]", line, maxsplit=1)[0])
    return {n for n in names if not COMPILE_FAMILIES.match(n)}


def test_daemons_expose_the_same_families(fresh, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    japi, tapi = util.deploy_both(util.dyadic_blob())
    try:
        rs, ts = RefStorage(env=util.MEM), Storage(env=util.MEM)
        pairs = {
            "event": (ref_service.EventAPI(storage=rs),
                      service.EventAPI(storage=ts)),
            "engine": (japi, tapi),
            "admin": (RefAdminAPI(storage=rs), AdminAPI(storage=ts)),
            "dashboard": (RefDashboardAPI(storage=rs),
                          DashboardAPI(storage=ts)),
        }
        body = util.query("u3", 4)
        want = ref_dispatch(japi, "POST", "/queries.json", body, {})
        got = dispatch_request(tapi, "POST", "/queries.json", body, {})
        assert got.status == want.status == 200
        for wall_ms in (1_000, 2_000):
            ref_history.recorder().tick(wall_ms=wall_ms)
            history.recorder().tick(wall_ms=wall_ms)
        for name, (ref_api, api) in pairs.items():
            want = ref_dispatch(ref_api, "GET", "/metrics", b"", {})
            got = dispatch_request(api, "GET", "/metrics", b"", {})
            ref_fams = _families(want.data.decode())
            fams = _families(got.data.decode())
            assert fams == ref_fams, (name, sorted(ref_fams ^ fams))
            for family in ("pio_slo_latency_threshold_ms", "pio_slo_target",
                           "pio_slo_error_budget_remaining",
                           "pio_slo_burn_rate", "pio_history_ticks_total",
                           "pio_history_series"):
                assert family in fams, (name, family)
            want = ref_dispatch(ref_api, "GET", "/debug/history.json", b"",
                                {})
            got = dispatch_request(api, "GET", "/debug/history.json", b"",
                                   {})
            assert (got.status, got.ctype) == (want.status, want.ctype)
            snap = json.loads(got.data)
            assert got.status == 200 and snap["enabled"] is True
            assert [s["t"] for s in snap["samples"]] == [1_000, 2_000]
            assert sorted(snap) == sorted(json.loads(want.data))
    finally:
        japi.close()
        tapi.close()


# ---------------------------------------------------------------------------
# a seeded sequence, byte for byte
# ---------------------------------------------------------------------------

STATUSES = ("200", "201", "400", "404", "500", "503")
LATENCIES = (0.001, 0.004, 0.012, 0.024, 0.03, 0.08, 0.3, 2.0)


def _ops(seed: int):
    """Per tick, a seeded batch of registry operations: HTTP responses by
    status, served-query latencies, a gauge, and a tick-to-tick clock."""
    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(30):
        ops = []
        for _ in range(int(rng.integers(0, 12))):
            kind = int(rng.integers(3))
            if kind == 0:
                ops.append(("http", ("event", "query")[rng.integers(2)],
                            STATUSES[rng.integers(len(STATUSES))]))
            elif kind == 1:
                ops.append(("serve", float(
                    LATENCIES[rng.integers(len(LATENCIES))])))
            else:
                ops.append(("gauge", float(rng.integers(0, 100))))
        ticks.append((ops, int(rng.integers(1, 400))))
    return ticks


class _Clock:
    """The SLO module's view of ``time``: a clock the test advances."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def _run(pkg, ticks, max_series, monkeypatch):
    tel, hist, slo_mod, _jour = pkg
    clock = _Clock()
    monkeypatch.setattr(slo_mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    slo_mod.install(slo_mod.SLOConfig(latency_ms=25.0,
                                      fast_window_s=300.0,
                                      slow_window_s=3600.0))
    rec = hist.install(hist.HistoryConfig(tick_s=5.0, fast_slots=16,
                                          slow_slots=4, slow_every=3,
                                          max_series=max_series),
                       start=False)
    reg = tel.registry()
    http = reg.counter("pio_http_requests_total", "requests",
                       labelnames=("service", "status"))
    serve = reg.histogram("pio_serve_seconds", "serve latency",
                          buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 1.0))
    depth = reg.gauge("pio_queue_depth", "queue depth")
    bodies, expositions = [], []
    wall = 1_700_000_000_000
    for ops, dt_s in ticks:
        for op in ops:
            if op[0] == "http":
                http.labels(service=op[1], status=op[2]).inc()
            elif op[0] == "serve":
                serve.child().observe(op[1])
            else:
                depth.child().set(op[1])
        clock.now += dt_s
        wall += dt_s * 1000
        rec.tick(wall_ms=wall)
        expositions.append(reg.exposition())
    for query in (None, {"res": "slow"}, {"series": "pio_serve_seconds"},
                  {"since_ms": str(wall - 20_000), "limit": "3"}):
        status, body = tel.handle_route("GET", "/debug/history.json",
                                        query)[:2]
        assert status == 200
        bodies.append(json.dumps(body, sort_keys=True))
    return bodies, expositions


@pytest.mark.parametrize("max_series", [512, 4], ids=["all", "capped"])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_history_and_slo_byte_identical(fresh, monkeypatch, seed,
                                               max_series):
    ticks = _ops(seed)
    want = _run(PACKAGES[0], ticks, max_series, monkeypatch)
    got = _run(PACKAGES[1], ticks, max_series, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    last = got[1][-1]
    assert 'pio_slo_burn_rate{slo="availability",window="fast"}' in last
    assert "pio_history_ticks_total 30" in last
    assert json.loads(got[0][0])["ticksTotal"] == 30


def test_history_off_answers_disabled(fresh, monkeypatch):
    """PIO_HISTORY=0: the endpoint answers ``enabled: false`` with no
    samples in both packages, and a tick records nothing."""
    monkeypatch.setenv("PIO_HISTORY", "0")
    bodies = []
    for tel, hist, _slo, _jour in PACKAGES:
        rec = hist.install(start=False)
        rec.tick(wall_ms=5)
        bodies.append(tel.handle_route("GET", "/debug/history.json")[1])
    assert bodies[0] == bodies[1]
    assert bodies[1]["enabled"] is False and bodies[1]["samples"] == []


def test_slo_engine_config_from_env(fresh, monkeypatch):
    """Explicit targets (a deploy's ServerConfig) win over the env, as in
    the reference; the env fills what they leave unset."""
    monkeypatch.setenv("PIO_SLO_LATENCY_MS", "40")
    monkeypatch.setenv("PIO_SLO_AVAILABILITY", "0.99")
    for _tel, _hist, slo_mod, _jour in PACKAGES:
        slo_mod.install()
    assert dataclass_tuple(slo.engine().config) == \
        dataclass_tuple(ref_slo.engine().config)
    cfgs = [slo_mod.SLOConfig.from_env(latency_ms=10.0)
            for _t, _h, slo_mod, _j in PACKAGES]
    assert dataclass_tuple(cfgs[0]) == dataclass_tuple(cfgs[1])
    assert cfgs[1].latency_ms == 10.0 and cfgs[1].availability == 0.99


def dataclass_tuple(cfg):
    return (cfg.availability, cfg.latency_ms, cfg.latency_target,
            cfg.fast_window_s, cfg.slow_window_s)
