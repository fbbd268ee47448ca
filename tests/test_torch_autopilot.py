"""The fleet autopilot (``workflow/autopilot.py``) in the port against the
JAX package's, on the CPU.

- The control loop: the same ``Signals`` sequences (a fake clock, a fake
  router control and a fake replica pool) through both packages'
  ``Autopilot.tick`` give the same actions, the same calls on the router
  and the pool, the same journal and the same ``summary()``: the
  degradation ladder (both burn windows, hysteresis inside the cooldown,
  a multi-rung unwind that restores the exact thresholds), quarantine and
  readmission, the scale band and the refill to the floor, hold-off under
  skew or a reload, the dry run, and one profile capture per episode.
- ``gather`` reads the same router status and metrics text into the same
  signals, window p99s and busy fraction included.
- On a port router: ``LocalRouterControl`` and ``HttpRouterControl`` set
  and restore the shed thresholds and quarantine a backend; ``GET /``
  has no ``autopilot`` block until a loop is attached, then the
  reference's keys; a dry run over a live two-replica fleet leaves the
  router's status byte-identical.
- ``SubprocessReplicaPool`` with a fake ``Popen``: the command's
  ``{port}``, the readiness wait, the kill of a replica that never got
  ready, ``stop`` and ``close``.

Ticks are driven by hand; every server binds port 0 and is stopped.
"""

import dataclasses
import json

import pytest

from predictionio_tpu.common import journal as jjournal
from predictionio_tpu.workflow import autopilot as jautopilot
from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.workflow import autopilot

import torch_fleet_util as fleet

SIDES = {"ref": (jautopilot, jjournal), "port": (autopilot, journal)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in [n for n in __import__("os").environ
                 if n.startswith("PIO_AUTOPILOT_")]:
        monkeypatch.delenv(name)
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    jjournal.clear()
    journal.clear()
    yield
    jjournal.clear()
    journal.clear()


def _cfg(mod, **kw):
    kw.setdefault("poll_ms", 100.0)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("util_low", 0.2)
    kw.setdefault("util_high", 0.85)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("outlier_x", 3.0)
    kw.setdefault("profile_ms", 500)
    return mod.AutopilotConfig(**kw)


def _fakes(mod):
    """A router stand-in recording every call, and a pool of made-up
    URLs."""

    class FakeControl(mod.RouterControl):
        def __init__(self):
            self.max_inflight = 64
            self.tenant_cap = 8
            self.calls = []

        def status(self):
            return {"router": True, "backends": []}

        def metrics_text(self):
            return ""

        def add_backend(self, url):
            self.calls.append(("add", url))

        def remove_backend(self, name):
            self.calls.append(("remove", name))

        def set_quarantine(self, name, value):
            self.calls.append(("quarantine", name, value))

        def shed_thresholds(self):
            return {"maxInflight": self.max_inflight,
                    "tenantMaxInflight": self.tenant_cap}

        def set_shed(self, max_inflight=None, tenant_max_inflight=None):
            prev = self.shed_thresholds()
            self.calls.append(("set_shed", max_inflight,
                               tenant_max_inflight))
            if max_inflight is not None:
                self.max_inflight = max_inflight
            if tenant_max_inflight is not None:
                self.tenant_cap = tenant_max_inflight
            return prev

        def backend_post(self, backend_url, path, timeout=5.0):
            self.calls.append(("post", backend_url, path))
            return 202

    class FakePool(mod.ReplicaPool):
        def __init__(self):
            self.calls = []
            self._n = 0

        def spawn(self):
            self._n += 1
            url = f"http://127.0.0.1:{9900 + self._n}"
            self.calls.append(("spawn", url))
            return url

        def stop(self, url):
            self.calls.append(("stop", url))
            return True

    return FakeControl, FakePool


ROT = ["a:1", "b:2"]
P99 = {"a:1": (0.001, 100.0), "b:2": (0.0012, 100.0), "c:3": (0.02, 100.0)}


def _s(now, burn=0.0, **kw):
    kw.setdefault("in_rotation", list(ROT))
    kw.setdefault("healthy", list(kw["in_rotation"]))
    kw.setdefault("urls", {n: f"http://{n}" for n in kw["in_rotation"]})
    kw.setdefault("burn_fast", burn)
    kw.setdefault("burn_slow", burn)
    return dict(now=now, **kw)


#: each scenario: (config overrides, with a pool, steps of Signals fields)
SCENARIOS = {
    "ladder_needs_both_windows": ({}, False, [
        dict(now=0.0, in_rotation=["a:1"], burn_fast=20.0,
             burn_slow=2.0)]),
    "ladder_flap_restores_exact_thresholds": ({}, False, [
        _s(0.0, 20.0), _s(2.0, 0.1), _s(4.0, 20.0), _s(11.0, 0.1)]),
    "ladder_multi_rung_unwinds_in_order": ({}, False, [
        _s(0.0, 20.0), _s(11.0, 20.0), _s(22.0, 0.1), _s(33.0, 0.1),
        _s(44.0, 0.1)]),
    "profile_once_per_episode": ({"cooldown_s": 1.0}, False, [
        _s(0.0, 20.0), _s(5.0, 20.0), _s(10.0, 0.1), _s(20.0, 20.0)]),
    "scale_band_spawns_and_drains": ({"cooldown_s": 1.0}, True, [
        _s(0.0, utilization=0.95), _s(2.0, utilization=0.02),
        _s(10.0, utilization=0.5), _s(12.0, utilization=0.99,
                                      in_rotation=["a:1", "b:2", "c:3",
                                                   "d:4"])]),
    "dead_replica_refills_to_min": ({"cooldown_s": 1.0,
                                     "min_replicas": 2}, True, [
        _s(0.0, in_rotation=["a:1"], unhealthy=["dead:9"])]),
    "no_pool_no_replica_control": ({"min_replicas": 3}, False, [
        _s(0.0, in_rotation=["a:1"], utilization=0.99)]),
    "quarantine_outlier_and_readmit": ({"cooldown_s": 5.0}, False, [
        _s(0.0, in_rotation=["a:1", "b:2", "c:3"], backend_p99=dict(P99)),
        _s(3.0, in_rotation=["a:1", "b:2"], healthy=["a:1", "b:2", "c:3"],
           quarantined=["c:3"]),
        _s(6.0, in_rotation=["a:1", "b:2"], healthy=["a:1", "b:2", "c:3"],
           quarantined=["c:3"])]),
    "quarantine_needs_three_peers": ({}, False, [
        _s(0.0, backend_p99=dict(P99))]),
    "quarantine_keeps_the_floor": ({"min_replicas": 3}, False, [
        _s(0.0, in_rotation=["a:1", "b:2", "c:3"], backend_p99=dict(P99))]),
    "quarantine_needs_samples_and_the_floor": ({}, False, [
        _s(0.0, in_rotation=["a:1", "b:2", "c:3"],
           backend_p99={k: (p, 3.0) for k, (p, _c) in P99.items()}),
        _s(20.0, in_rotation=["a:1", "b:2", "c:3"],
           backend_p99={"a:1": (0.0001, 50.0), "b:2": (0.0001, 50.0),
                        "c:3": (0.0015, 50.0)})]),
    "holdoff_under_skew_and_reload": ({"cooldown_s": 1.0,
                                       "min_replicas": 3}, True, [
        dict(now=0.0, generation_skew=True, in_rotation=["a:1"],
             healthy=["a:1"], burn_fast=20.0, burn_slow=20.0),
        dict(now=2.0, reload_active=True, in_rotation=["a:1"],
             healthy=["a:1"], burn_fast=20.0, burn_slow=20.0),
        dict(now=4.0, in_rotation=["a:1"], healthy=["a:1"],
             urls={"a:1": "http://a:1"}, burn_fast=20.0,
             burn_slow=20.0)]),
    "dry_run_touches_nothing": ({"dry_run": True, "cooldown_s": 1.0,
                                 "min_replicas": 3}, True, [
        _s(0.0, 20.0, in_rotation=["a:1"], backend_p99={
            "a:1": (0.02, 100.0), "b:2": (0.001, 100.0),
            "c:3": (0.001, 100.0)}),
        _s(0.5, 20.0, in_rotation=["a:1"])]),
}


def _summary(ap):
    s = ap.summary()
    if s["lastAction"] is not None:
        s["lastAction"] = {k: v for k, v in s["lastAction"].items()
                           if k not in ("at", "ageS")}
    return s


def _run_scenario(side, name):
    mod, jr = SIDES[side]
    jr.clear()
    cfg, with_pool, steps = SCENARIOS[name]
    FakeControl, FakePool = _fakes(mod)
    control = FakeControl()
    pool = FakePool() if with_pool else None
    ap = mod.Autopilot(control, config=_cfg(mod, **cfg), pool=pool)
    trace = []
    for step in steps:
        acted = ap.tick(mod.Signals(**step))
        trace.append(([{k: v for k, v in a.items() if k != "at"}
                       for a in acted], len(ap._rungs), ap._holdoff,
                      control.max_inflight, control.tenant_cap))
    events = [(e["level"], e["category"], e["message"], e["fields"])
              for e in jr.snapshot(category="autopilot")["events"]]
    return (trace, control.calls, pool.calls if pool else None, events,
            _summary(ap))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tick_acts_as_the_reference(name):
    want = _run_scenario("ref", name)
    got = _run_scenario("port", name)
    for part, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, part)


def test_the_ladder_restores_the_exact_thresholds():
    trace, calls, _pool, _ev, summary = _run_scenario(
        "port", "ladder_multi_rung_unwinds_in_order")
    assert [t[3:] for t in trace] == [(32, 4), (16, 2), (32, 4), (64, 8),
                                      (64, 8)]
    assert summary["ladderDepth"] == 0
    assert sum(c[0] == "set_shed" for c in calls) == 4


def test_dry_run_leaves_the_fake_fleet_untouched():
    trace, calls, pool, events, summary = _run_scenario(
        "port", "dry_run_touches_nothing")
    assert calls == [] and pool == []
    assert trace[0][0] and all(a["outcome"] == "dry_run"
                               for a in trace[0][0])
    assert summary["pendingDryRun"] == len(trace[0][0])
    assert all(e[2].startswith("DRY-RUN would") for e in events
               if e[3].get("dryRun"))


def test_config_reads_the_same_env(monkeypatch):
    values = {"POLL_MS": "250", "COOLDOWN_S": "3", "UTIL_LOW": "0.1",
              "UTIL_HIGH": "0.7", "MIN_REPLICAS": "2", "MAX_REPLICAS": "6",
              "OUTLIER_X": "4.5", "PROFILE_MS": "750"}
    for k, v in values.items():
        monkeypatch.setenv(f"PIO_AUTOPILOT_{k}", v)
    got = dataclasses.asdict(autopilot.AutopilotConfig().resolved())
    assert got == dataclasses.asdict(
        jautopilot.AutopilotConfig().resolved())
    assert got["max_replicas"] == 6 and got["outlier_x"] == 4.5


def _metrics(sums, buckets, burn):
    """A router's metrics text: per-backend histograms and the burn
    gauges."""
    lines = ["# TYPE pio_router_backend_seconds histogram"]
    for backend, counts in buckets.items():
        cum = 0
        for le, n in counts:
            cum += n
            lines.append(f'pio_router_backend_seconds_bucket{{backend='
                         f'"{backend}",le="{le}"}} {cum}')
        lines.append(f'pio_router_backend_seconds_sum{{backend='
                     f'"{backend}"}} {sums[backend]}')
        lines.append(f'pio_router_backend_seconds_count{{backend='
                     f'"{backend}"}} {cum}')
    for slo_name in ("availability", "latency"):
        for window, v in burn.items():
            lines.append(f'pio_slo_burn_rate{{slo="{slo_name}",window='
                         f'"{window}"}} {v}')
    return "\n".join(lines) + "\n"


def test_gather_reads_the_same_signals():
    status = {"router": True, "generationSkew": False,
              "reload": {"active": False}, "backends": [
                  {"url": "http://a:1", "inRotation": True,
                   "healthy": True},
                  {"url": "http://b:2", "inRotation": True,
                   "healthy": True},
                  {"url": "http://c:3", "inRotation": False,
                   "healthy": True, "quarantined": True},
                  {"url": "http://d:4", "inRotation": False,
                   "healthy": False}]}
    scrapes = [
        _metrics({"a:1": 0.5, "b:2": 0.6, "c:3": 2.0},
                 {"a:1": [("0.001", 30), ("0.005", 10), ("+Inf", 0)],
                  "b:2": [("0.001", 10), ("0.005", 30), ("+Inf", 0)],
                  "c:3": [("0.05", 20), ("0.1", 20), ("+Inf", 1)]},
                 {"fast": 3.5, "slow": 1.25}),
        _metrics({"a:1": 2.5, "b:2": 1.6, "c:3": 2.0},
                 {"a:1": [("0.001", 60), ("0.005", 30), ("+Inf", 2)],
                  "b:2": [("0.001", 20), ("0.005", 50), ("+Inf", 0)],
                  "c:3": [("0.05", 20), ("0.1", 20), ("+Inf", 1)]},
                 {"fast": 20.0, "slow": 15.5})]
    got = {}
    for side, (mod, _jr) in SIDES.items():
        class Scripted(mod.RouterControl):
            n = 0

            def status(self):
                return status

            def metrics_text(self):
                Scripted.n += 1
                return scrapes[Scripted.n - 1]

        ap = mod.Autopilot(Scripted(), config=_cfg(mod))
        got[side] = [dataclasses.asdict(ap.gather(now=t))
                     for t in (100.0, 102.0)]
    assert got["port"] == got["ref"]
    second = got["port"][1]
    assert second["quarantined"] == ["c:3"]
    assert second["unhealthy"] == ["d:4"]
    assert second["burn_fast"] == 20.0
    assert second["utilization"] == pytest.approx(0.75)
    assert second["backend_p99"]["a:1"] == (float("inf"), 52.0)


# ---------------------------------------------------------------------------
# on a port router
# ---------------------------------------------------------------------------

def _fleet(n=2):
    blob = fleet.tied_blob()
    store = fleet.store_with(blob)
    replicas = []
    for _ in range(n):
        api = fleet.query_api(store)
        server, port = fleet.serve(api)
        replicas.append((api, server, port))
    router, rserver, rport = fleet.router([p for _a, _s, p in replicas],
                                          max_inflight=64,
                                          tenant_max_inflight=8)
    fleet.wait_rotation(router, n)
    return replicas, (router, rserver, rport)


def _stop(replicas, front):
    router, rserver, _p = front
    fleet.stop(rserver)
    router.close()
    for api, server, _p in replicas:
        fleet.stop(server)
        api.close()


def test_router_controls_set_and_restore(monkeypatch):
    replicas, front = _fleet()
    router, _rs, rport = front
    try:
        name = router.backends[0].name
        for control in (autopilot.LocalRouterControl(router),
                        autopilot.HttpRouterControl(
                            f"http://127.0.0.1:{rport}")):
            assert control.shed_thresholds() == {
                "maxInflight": 64, "tenantMaxInflight": 8}
            prev = control.set_shed(max_inflight=32, tenant_max_inflight=4)
            assert prev == {"maxInflight": 64, "tenantMaxInflight": 8}
            assert control.set_shed(**{"max_inflight": 64,
                                       "tenant_max_inflight": 8}) == {
                "maxInflight": 32, "tenantMaxInflight": 4}
            control.set_quarantine(name, True)
            st = control.status()
            assert st["inRotation"] == 1
            assert [b.get("quarantined") for b in st["backends"]] == [
                True, None]
            control.set_quarantine(name, False)
            assert control.status()["inRotation"] == 2
            with pytest.raises(RuntimeError):
                control.set_quarantine("nope:1", True)
        text = autopilot.HttpRouterControl(
            f"http://127.0.0.1:{rport}").metrics_text()
        assert isinstance(text, str)
        with pytest.raises(ValueError):
            autopilot.HttpRouterControl("http://no-port")
    finally:
        _stop(replicas, front)


def test_router_status_has_no_autopilot_block_until_attached():
    replicas, front = _fleet(1)
    router = front[0]
    try:
        assert "autopilot" not in router.handle("GET", "/")[1]
        ap = autopilot.Autopilot(autopilot.LocalRouterControl(router),
                                 config=_cfg(autopilot))
        router.attach_autopilot(ap)
        block = router.handle("GET", "/")[1]["autopilot"]
        want = jautopilot.Autopilot(_fakes(jautopilot)[0](),
                                    config=_cfg(jautopilot)).summary()
        assert block == want
        assert block["mode"] == "live" and block["actionsTotal"] == 0
    finally:
        _stop(replicas, front)


def test_dry_run_over_a_live_fleet_is_byte_identical(monkeypatch):
    replicas, front = _fleet()
    router, _rs, rport = front
    _FakeControl, FakePool = _fakes(autopilot)
    pool = FakePool()
    try:
        for j in range(8):
            status, _body, _h = fleet.post(rport, fleet.util.query(
                f"u{j}", 3))
            assert status == 200
        ap = autopilot.Autopilot(
            autopilot.LocalRouterControl(router),
            config=_cfg(autopilot, dry_run=True, cooldown_s=0.01,
                        min_replicas=3), pool=pool)
        before = json.dumps(router.handle("GET", "/")[1], sort_keys=True)
        for now in (1.0, 2.0, 3.0):
            sig = ap.gather(now=now)
            sig.burn_fast = sig.burn_slow = 20.0   # a page, would-haves
            ap.tick(sig)
        after = json.dumps(router.handle("GET", "/")[1], sort_keys=True)
        assert after == before and pool.calls == []
        s = ap.summary()
        assert s["mode"] == "dry-run" and s["pendingDryRun"] >= 3
        would = {e["fields"]["action"]
                 for e in journal.snapshot(category="autopilot")["events"]
                 if e["fields"].get("dryRun")}
        assert {"scale_up", "shed_widen", "profile_capture"} <= would
    finally:
        _stop(replicas, front)


# ---------------------------------------------------------------------------
# the subprocess pool with a fake Popen
# ---------------------------------------------------------------------------

class _FakeProc:
    launched = []

    def __init__(self, argv, env=None, stdout=None, stderr=None):
        self.argv, self.env = argv, env
        self.events = []
        _FakeProc.launched.append(self)

    def terminate(self):
        self.events.append("terminate")

    def kill(self):
        self.events.append("kill")

    def wait(self, timeout=None):
        self.events.append("wait")
        return 0


def test_subprocess_pool_spawns_stops_and_closes(monkeypatch):
    _FakeProc.launched = []
    monkeypatch.setattr(autopilot.subprocess, "Popen", _FakeProc)
    ready = []
    monkeypatch.setattr(autopilot.SubprocessReplicaPool, "_ready",
                        staticmethod(lambda host, port, t: ready.pop(0)))
    pool = autopilot.SubprocessReplicaPool(
        "python -m predictionio_tpu_torch.tools.cli deploy --port {port} "
        "--ip 127.0.0.1", ready_timeout_s=3.0, env={"PIO_X": "1"})
    ready[:] = [True, False, True]
    a = pool.spawn()
    assert a.startswith("http://127.0.0.1:")
    port = a.rsplit(":", 1)[1]
    proc_a = _FakeProc.launched[0]
    assert proc_a.argv[proc_a.argv.index("--port") + 1] == port
    assert proc_a.argv[:3] == ["python", "-m",
                               "predictionio_tpu_torch.tools.cli"]
    assert proc_a.env == {"PIO_X": "1"}
    assert pool.spawn() is None                 # never got ready: killed
    assert _FakeProc.launched[1].events == ["kill"]
    b = pool.spawn()
    assert pool.stop(a) and proc_a.events == ["terminate", "wait"]
    assert not pool.stop(a)                     # only what it started
    pool.close()
    assert _FakeProc.launched[2].events == ["kill"] and b != a
