"""The port's trainer spans (``ops/als.py``, ``common/tracing.py``): under
a ``torch.profiler`` session each half-step records an ``als.gram`` span
(side, chunks, entries with padding, padding) and an ``als.solve`` span
(side, rows) in the profiler ring, on ``time.time_ns``; outside one
nothing is recorded; the factors do not depend on the session; the ring
drops its oldest spans past its bound and counts them; and ``pio train
--profile`` leaves both ranges in its Chrome trace."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from predictionio_tpu_torch.common import tracing
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.tools import cli

from torch_deploy_util import port_cli  # noqa: F401 (fixture)

N_USERS, N_ITEMS, NNZ, CHUNK, ITERS = 120, 90, 3000, 1024, 3


@pytest.fixture(autouse=True)
def _clean():
    tracing.clear()
    yield
    tracing.clear()


def _data():
    rng = np.random.default_rng(5)
    u = rng.integers(0, N_USERS, NNZ)
    i = rng.integers(0, N_ITEMS, NNZ)
    r = rng.integers(1, 6, NNZ).astype(np.float32)
    r[::7] *= -1            # signed, for the implicit trainer
    return als.prepare_ratings(u, i, r, N_USERS, N_ITEMS, chunk=CHUNK)


def _train(implicit, data=None):
    fn = als.train_implicit if implicit else als.train_explicit
    return fn(data or _data(), rank=4, iterations=ITERS, chunk=CHUNK,
              seed=11, device="cpu")


def _profiled(implicit, data=None):
    with profile(activities=[ProfilerActivity.CPU]):
        return _train(implicit, data)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_each_half_step_records_a_gram_and_a_solve_span(implicit):
    t0 = time.time_ns()
    _profiled(implicit)
    spans, dropped = tracing.profiler_spans()
    assert dropped == 0
    nnz_pad = als.declared_nnz_pad(NNZ, CHUNK)
    assert [s.name for s in spans] == ["als.gram", "als.solve"] * 2 * ITERS
    assert [s.attrs["side"] for s in spans] == \
        ["users", "users", "items", "items"] * ITERS
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= time.time_ns()
        if s.name == "als.gram":
            assert s.attrs["entries"] == nnz_pad
            assert s.attrs["padding"] == nnz_pad - NNZ
            assert s.attrs["chunks"] == nnz_pad // CHUNK
        else:
            assert s.attrs["rows"] == (N_USERS if s.attrs["side"] == "users"
                                       else N_ITEMS)
    # spans of one thread, in order, none overlapping the next
    assert len({s.thread for s in spans}) == 1
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_outside_a_session_nothing_is_recorded_and_factors_agree(implicit):
    data = _data()
    U0, V0 = _train(implicit, data)
    assert tracing.profiler_spans() == ([], 0)
    U1, V1 = _profiled(implicit, data)
    assert len(tracing.profiler_spans()[0]) == 4 * ITERS
    assert torch.equal(U0, U1) and torch.equal(V0, V1)
    tracing.clear()
    _train(implicit, data)
    assert tracing.profiler_spans() == ([], 0)


def test_the_ring_drops_its_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_profiled", tracing._ProfiledRing(5))
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(8):
            with tracing.span(f"s{k}", k=k):
                pass
    spans, dropped = tracing.profiler_spans()
    assert [s.name for s in spans] == ["s3", "s4", "s5", "s6", "s7"]
    assert [s.attrs for s in spans] == [{"k": k} for k in range(3, 8)]
    assert dropped == 3
    tracing.clear()
    assert tracing.profiler_spans() == ([], 0)
    assert tracing.PROFILED_CAP >= 4096


def test_a_request_span_under_a_session_lands_in_both_rings():
    """The request ring keeps its span as without a session; the
    profiler ring gets its own record of the same block."""
    with tracing.activate(tracing.new_context("t1")):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("dispatch", service="q") as child:
                assert child is not None and child.trace_id == "t1"
                assert tracing.current() is child
        with tracing.span("after") as child:
            assert child is not None
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["traces"][0]["spans"]] == \
        ["dispatch", "after"]
    spans, _ = tracing.profiler_spans()
    assert [(s.name, s.attrs) for s in spans] == [("dispatch", {})]


def test_without_context_or_session_a_span_is_a_pass_through():
    with tracing.span("idle", side="users") as child:
        assert child is None
    assert tracing.profiler_spans() == ([], 0)
    assert tracing.snapshot()["spanCount"] == 0


@pytest.mark.usefixtures("port_cli")
def test_pio_train_profile_trace_holds_the_trainer_ranges(
        monkeypatch, tmp_path):
    """``pio train --profile DIR`` on the CPU: the Chrome trace holds one
    ``als.gram`` and one ``als.solve`` range per half-step."""
    from predictionio_tpu_torch.common import profiling

    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    shutil.copy(os.path.join(os.path.dirname(cli.__file__), "..", "models",
                             "recommendation", "engine.json"), engine_dir)
    iterations = json.loads((engine_dir / "engine.json").read_text())[
        "algorithms"][0]["params"]["numIterations"]
    for name in ("PIO_SYNTHETIC_EVENTS", "PIO_SYNTHETIC_SEED"):
        monkeypatch.setenv(name, "")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    profiling.reset()
    prof = tmp_path / "prof"
    assert cli.main(["train", "--engine-dir", str(engine_dir),
                     "--synthetic", "3000", "--profile", str(prof)]) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    assert names.count("als.gram") == 2 * iterations
    assert names.count("als.solve") == 2 * iterations


def test_the_profilers_range_lies_inside_the_span_on_one_clock():
    """The ``record_function`` range the session records for a span lies
    inside the span's own stamps: both are on the profiler's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("probe", n=1):
            torch.ones(1 << 12).sum()
    (span,), _ = tracing.profiler_spans()
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    start = event.start_ns()
    assert span.start_ns <= start <= start + event.duration_ns() <= \
        span.end_ns
