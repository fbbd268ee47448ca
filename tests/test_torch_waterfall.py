"""The port's latency waterfalls (``common/waterfall.py``) against the
JAX package's.

The same seeded stage timings (a scripted clock) give the same slow ring
on both (ids and timestamps normalized): the N slowest kept, eviction by
total, sampling every Nth request. Then a CPU deploy of both packages on
the same dyadic-grid factors with PIO_WATERFALL=1 and PIO_TRACE=1, in
the batched and the inline mode: every sampled request carries the same
stage names and details, the stages nest as in the reference (``pad``
and ``execute`` inside ``dispatch``, the top-level stages within the
total) and the spans chain server -> admission -> flush -> dispatch.
"""

import json

import numpy as np
import pytest

from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu.common import tracing as ref_tracing
from predictionio_tpu.common import waterfall as ref_waterfall
from predictionio_tpu_torch.common import telemetry, tracing, waterfall

import torch_deploy_util as util

MODULES = ((ref_waterfall, ref_tracing, ref_telemetry),
           (waterfall, tracing, telemetry))
TOP = ("admission", "supplement", "dispatch", "merge", "serialize")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in util.KNOBS:
        monkeypatch.delenv(name, raising=False)
    for mods in MODULES:
        for mod in mods:
            mod.set_enabled(None)
        mods[0].clear()
        mods[1].clear()
    yield
    for mods in MODULES:
        for mod in mods:
            mod.set_enabled(None)
        mods[0].clear()
        mods[1].clear()


class _Clock:
    """A scripted perf_counter: each call advances by the next step."""

    def __init__(self, steps):
        self.t = 100.0
        self.steps = iter(steps)

    def __call__(self):
        self.t += next(self.steps, 0.001)
        return self.t


def _normalize(snap):
    out = dict(snap)
    out["requests"] = [{k: v for k, v in r.items()
                        if k not in ("traceId", "at")}
                       for r in snap["requests"]]
    return out


@pytest.mark.parametrize("sample,ring", [("1", "4"), ("3", "32"),
                                         ("1", "1")])
@pytest.mark.parametrize("seed", range(3))
def test_slow_rings_match(monkeypatch, seed, sample, ring):
    monkeypatch.setenv("PIO_WATERFALL_SAMPLE", sample)
    monkeypatch.setenv("PIO_SLOW_RING", ring)
    rng = np.random.default_rng(seed)
    steps = [float(x) for x in rng.integers(1, 50, size=400) / 1000]
    snaps = []
    for wf, tr, _tel in MODULES:
        wf.set_enabled(True)
        monkeypatch.setattr(wf, "_sample_seq", __import__(
            "itertools").count(1))
        monkeypatch.setattr(wf.time, "perf_counter", _Clock(steps))
        for i in range(12):
            rec = wf.begin("batched" if i % 2 else "inline")
            with wf.activate((rec,)):
                for stage in ("supplement", "dispatch"):
                    with wf.stage(stage):
                        pass
                wf.note("bucket", i % 4)
            wf.observe_stage("admission", steps[i], (rec,))
            wf.end(rec)
        snaps.append(_normalize(wf.slow_snapshot(limit=64)))
    assert snaps[0] == snaps[1]
    assert len(snaps[1]["requests"]) == min(int(ring), 12 // int(sample))


def test_waterfall_off_is_a_passthrough():
    for wf, _tr, _tel in MODULES:
        assert wf.begin("batched") is None
        with wf.activate((None,)):
            with wf.stage("dispatch"):
                wf.note("quant", "int8")
        wf.end(None)
        assert wf.slow_snapshot()["requests"] == []
        assert wf.slow_snapshot()["enabled"] is False


@pytest.fixture(scope="module", params=["on", "off"],
                ids=["batched", "inline"])
def deployed(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_SERVE_QUANT", "on")
    mp.setenv("PIO_SERVE_FUSED", "off")
    mp.delenv("PIO_TORCH_DEVICE", raising=False)
    japi, tapi = util.deploy_both(util.dyadic_blob(), batching=request.param)
    try:
        yield request.param, japi, tapi
    finally:
        japi.close()
        tapi.close()
        mp.undo()


def _span_tree(spans):
    by_id = {s["spanId"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parentId"], "root"))
                  for s in spans)


def test_deploys_record_the_same_stages_and_spans(deployed, monkeypatch):
    from predictionio_tpu.data.api.http import dispatch_request as ref_dispatch
    from predictionio_tpu_torch.data.api.http import dispatch_request

    mode, japi, tapi = deployed
    monkeypatch.setenv("PIO_SLOW_RING", "64")
    for mods in MODULES:
        for mod in mods:
            mod.set_enabled(True)
    users = [(f"u{i}", n) for i, n in ((0, 3), (4, 10), (7, 1), (9, 40),
                                       (13, 5), (23, 2))]
    results = []
    for api, dispatch, (wf, tr, _tel) in ((japi, ref_dispatch, MODULES[0]),
                                          (tapi, dispatch_request,
                                           MODULES[1])):
        bodies = []
        for k, (u, n) in enumerate(users):
            hdr = {"X-PIO-Trace": f"t{k:03d}-0"}
            out = dispatch(api, "POST", "/queries.json",
                           util.query(u, n), hdr)
            bodies.append(out.data)
        recs = {r["traceId"]: r for r in wf.slow_snapshot(64)["requests"]}
        traces = {t["traceId"]: _span_tree(t["spans"])
                  for t in tr.snapshot(limit=64)["traces"]}
        per = []
        for k in range(len(users)):
            r = recs[f"t{k:03d}"]
            per.append((r["mode"], sorted(r["stages"]),
                        r.get("details"), traces[f"t{k:03d}"]))
            st = r["stages"]
            assert sum(st.get(s, 0.0) for s in TOP) <= r["totalMs"] + 0.005
            if "pad" in st:
                assert st["pad"] + st["execute"] <= st["dispatch"] + 0.002
        results.append((bodies, per))
    assert results[0][0] == results[1][0]          # the same answers
    assert results[0][1] == results[1][1]          # the same waterfalls
    stages = results[1][1][0][1]
    if mode == "on":
        assert stages == sorted(TOP + ("pad", "execute"))
        assert ("dispatch", "flush") in results[1][1][0][3]
        assert ("admission", "server:/queries.json") in results[1][1][0][3]
    else:
        assert stages == sorted(set(TOP) - {"admission"})


def test_stage_histograms_carry_exemplars(deployed):
    """pio_serve_stage_seconds lands on /metrics with trace-id exemplars
    only in the OpenMetrics exposition."""
    _mode, _japi, tapi = deployed
    for mod in MODULES[1]:
        mod.set_enabled(True)
    status, body = tapi.handle("POST", "/queries.json",
                               body=util.query("u3", 4))[:2]
    assert status == 200 and body["itemScores"]
    classic = telemetry.registry().exposition()
    om = telemetry.registry().exposition(openmetrics=True)
    assert 'pio_serve_stage_seconds_count{stage="serialize"}' in classic
    assert "# {trace_id=" in om and "# {trace_id=" not in classic
    assert json.loads(json.dumps(waterfall.slow_snapshot()))["enabled"]
