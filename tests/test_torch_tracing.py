"""The port's request tracing (``common/tracing.py``) against the JAX
package's: ``X-PIO-Trace`` header parsing and round trips, a server's
adoption and origination rules, span nesting on one thread and spans
recorded for another, the span ring's eviction and the tail ring's pins
— the same operations on both, the ``/traces.json`` payloads equal with
the random span ids and timestamps normalized."""

import itertools

import numpy as np
import pytest

from predictionio_tpu.common import tracing as ref_tracing
from predictionio_tpu_torch.common import tracing

MODULES = (ref_tracing, tracing)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("PIO_TRACE", "PIO_TRACE_TAIL_MS", "PIO_TRACE_TAIL_TRACES"):
        monkeypatch.delenv(name, raising=False)
    for mod in MODULES:
        mod.set_enabled(None)
        mod.clear()
    yield
    for mod in MODULES:
        mod.set_enabled(None)
        mod.clear()


HEADERS = ["abc-def", " abc-def ", "abc-def-ghi", "-abc", "abc-", "", None,
           "nodash", "0123456789abcdef-fedcba9876543210"]


@pytest.mark.parametrize("value", HEADERS)
def test_header_parsing_matches(value):
    want = ref_tracing.parse_header(value)
    got = tracing.parse_header(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert got.header_value() == want.header_value()
        # a round trip through the header gives the same context
        back = tracing.parse_header(got.header_value())
        assert (back.trace_id, back.span_id) == (got.trace_id, got.span_id)


@pytest.mark.parametrize("originate", [False, True])
@pytest.mark.parametrize("headers", [
    None, {}, {"X-PIO-Trace": "t1-s1"}, {"x-pio-trace": "t2-s2"},
    {"X-Pio-Trace": "broken"}, {"Content-Type": "application/json"}])
def test_server_context_adopts_and_originates_alike(headers, originate):
    out = []
    for mod in MODULES:
        mod.set_enabled(originate)
        ctx = mod.server_context(headers)
        out.append(None if ctx is None else (
            ctx.trace_id if headers and "-s" in str(headers) else "fresh",
            len(ctx.trace_id), len(ctx.span_id)))
    assert out[0] == out[1]
    adopted = headers and any(k.lower() == "x-pio-trace" and "-" in v
                              for k, v in headers.items())
    assert (out[1] is not None) == bool(adopted or originate)


def _normalize(snap):
    """Each trace as the sorted (name, parent's name, service) of its
    spans: the span order inside a trace follows wall-clock start times,
    which differ from run to run."""
    traces = []
    for t in snap["traces"]:
        names = {s["spanId"]: s["name"] for s in t["spans"]}
        entry = {"spans": sorted(
            (s["name"], names.get(s["parentId"], "root"), s["service"])
            for s in t["spans"])}
        if "pinned" in t:
            entry["pinned"] = t["pinned"]
        traces.append(entry)
    return {**{k: v for k, v in snap.items() if k != "traces"},
            "traces": traces}


def _drive(mod, seed: int):
    """A seeded mix of root traces, nested spans, cross-thread spans and
    pins; span ids come from a counter so both modules see the same."""
    rng = np.random.default_rng(seed)
    counter = itertools.count()
    mod._new_id = lambda: f"{next(counter):016x}"
    for t in range(int(rng.integers(3, 8))):
        ctx = mod.new_context()
        with mod.activate(ctx):
            with mod.span("server:/queries.json", service="QueryAPI"):
                for _ in range(int(rng.integers(0, 3))):
                    with mod.span("dispatch", service="query-server"):
                        with mod.span("storage"):
                            pass
                mod.record_span("admission", mod.current(),
                                float(rng.integers(1, 5)) / 1000,
                                service="query-batcher")
                if rng.integers(3) == 0:
                    mod.pin_current("degraded")
        if rng.integers(4) == 0:
            mod.pin_trace(ctx.trace_id, "error")
    mod.record_span("orphan", None, 0.1)     # no context: a no-op
    return mod.snapshot(limit=64)


@pytest.mark.parametrize("seed", range(4))
def test_span_rings_match(seed, monkeypatch):
    snaps = []
    for mod in MODULES:
        monkeypatch.setattr(mod, "_new_id", mod._new_id)
        snaps.append(_normalize(_drive(mod, seed)))
    assert snaps[0] == snaps[1]
    assert snaps[1]["spanCount"] > 0


def test_targeted_read_and_tail_pins_survive_eviction(monkeypatch):
    """A pinned trace keeps resolving after the main ring churns past it;
    a slow span pins its own trace."""
    monkeypatch.setenv("PIO_TRACE_TAIL_MS", "50")
    out = []
    for mod in MODULES:
        monkeypatch.setattr(mod, "_ring", mod._Ring(16))
        monkeypatch.setattr(mod, "_tail", mod._TailRing())
        pinned = mod.new_context("pinnedtrace")
        with mod.activate(pinned):
            with mod.span("server:/x"):
                mod.pin_current("error")
        slow = mod.new_context("slowtrace")
        mod.record_span("flush", slow, 0.2)
        for i in range(40):             # churn the 16-span main ring
            mod.record_span("noise", mod.new_context(f"n{i}"), 0.001)
        a = mod.snapshot(trace_id="pinnedtrace")
        b = mod.snapshot(trace_id="slowtrace")
        out.append((
            [t["pinned"] for t in a["traces"]],
            [[s["name"] for s in t["spans"]] for t in a["traces"]],
            [t["pinned"] for t in b["traces"]],
            a["spanCount"], a["tail"]["retained"], mod.tail_retained()))
    assert out[0] == out[1]
    assert out[1][0] == [["error"]] and out[1][2] == [["slow"]]
