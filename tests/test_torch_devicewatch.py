"""The port's device watch (``common/devicewatch.py``): kernel-library
builds and loads counted under the reference's family names and
attributed to the innermost region, the post-warmup alarm on the
serving path (with its journal event), a serving signature first seen
after warmup recorded but not counted, the HBM gauges read from the
caching allocator only where a CUDA context exists, and
``/debug/device.json`` — ``{"telemetry": false}`` byte for byte with
the reference's when telemetry is off, the reference's keys when on."""

import json
import types

import pytest
import torch

from predictionio_tpu.common import devicewatch as ref_devicewatch
from predictionio_tpu.common import telemetry as ref_telemetry
from predictionio_tpu_torch.common import devicewatch, journal, telemetry
from predictionio_tpu_torch.ops import _kernels


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PIO_TELEMETRY", raising=False)
    monkeypatch.delenv("PIO_SERVE_WARMUP_FLUSHES", raising=False)
    for mod in (telemetry, ref_telemetry):
        mod.set_enabled(None)
    devicewatch.reset_watchdog()
    journal.clear()
    yield
    for mod in (telemetry, ref_telemetry):
        mod.set_enabled(None)
    devicewatch.reset_watchdog()
    journal.clear()


def _count(name, **labels):
    fam = telemetry.registry()._families.get(name)
    if fam is None:
        return 0.0
    key = tuple(str(labels[n]) for n in fam.labelnames)
    child = fam._children.get(key)
    return 0.0 if child is None else (
        child.count if hasattr(child, "count") else child.value)


def test_builds_and_loads_are_attributed_to_the_innermost_region():
    telemetry.set_enabled(True)
    before = _count("pio_xla_compiles_total", fn="als_train_explicit",
                    phase="train")
    outer = _count("pio_xla_compiles_total", fn="train:train", phase="train")
    alarms = devicewatch.post_warmup_recompiles()
    devicewatch.mark_serving_warmup_done()    # armed, but not serving
    with devicewatch.attribution("train:train", phase="train"):
        with devicewatch.attribution("als_train_explicit", phase="train"):
            devicewatch.note_build("solve_gj", 17.4)
            devicewatch.note_load("solve_gj", 0.002)
        devicewatch.note_load("topk_fused", 0.001)
    devicewatch.note_load("other", 0.001)            # outside any region
    assert _count("pio_xla_compiles_total", fn="als_train_explicit",
                  phase="train") == before + 2
    assert _count("pio_xla_compiles_total", fn="train:train",
                  phase="train") == outer + 1
    assert _count("pio_xla_compiles_total", fn="unattributed",
                  phase="other") >= 1
    assert devicewatch.post_warmup_recompiles() == alarms
    exposition = telemetry.registry().exposition()
    assert "pio_xla_compile_seconds_bucket" in exposition


def test_telemetry_off_counts_nothing():
    total = devicewatch.compiles_total()
    with devicewatch.serving_region("serve_flush", signature="bucket=1,n=1"):
        devicewatch.note_build("topk_fused", 4.0)
    assert devicewatch.compiles_total() == total
    assert devicewatch.debug_snapshot() == {"telemetry": False}


def test_post_warmup_build_on_the_serving_path_is_the_alarm(monkeypatch):
    telemetry.set_enabled(True)
    monkeypatch.setenv("PIO_SERVE_WARMUP_FLUSHES", "3")
    alarms = devicewatch.post_warmup_recompiles()
    for n in (1, 2, 3):                  # warmup: loads are expected here
        with devicewatch.serving_region("serve_flush",
                                        signature=f"bucket=4,n={n}"):
            if n == 1:
                devicewatch.note_load("topk_fused", 0.003)
        devicewatch.note_serving_flush()
    assert devicewatch.serving_warmup_done()
    assert devicewatch.post_warmup_recompiles() == alarms
    # a shape the warmup never saw: evidence, not a recompile
    with devicewatch.serving_region("serve_flush", signature="bucket=16,n=9"):
        pass
    assert devicewatch.post_warmup_recompiles() == alarms
    # a build after warmup stalls the flush: counted, logged, journaled
    with devicewatch.serving_region("serve_flush", signature="bucket=4,n=2"):
        devicewatch.note_build("topk_fused", 5.1)
    assert devicewatch.post_warmup_recompiles() == alarms + 1
    events = devicewatch.debug_snapshot()["watchdog"]["recentPostWarmup"]
    assert [(e["signature"], e["counted"]) for e in events] == [
        ("bucket=16,n=9", False), ("bucket=4,n=2", True)]
    assert events[1]["library"] == "build libtopk_fused"
    red = journal.snapshot(category="recompile", level="red")["events"]
    assert len(red) == 1 and red[0]["fields"]["fn"] == "serve_flush"


def test_kernel_loader_reports_builds_and_loads(monkeypatch):
    """ops/_kernels.py: a stale library is built, then loaded; each is
    one compile event with its duration."""
    telemetry.set_enabled(True)
    seen = []
    monkeypatch.setattr(devicewatch, "_on_compile",
                        lambda kind, lib, s: seen.append((kind, lib)))
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "_stale", lambda name: True)

    def fake_build(*names):
        for name in names:
            devicewatch.note_build(name, 1.0)
        return {name: 1.0 for name in names}

    monkeypatch.setattr(_kernels, "build", fake_build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: object())
    lib = _kernels.load("topk_fused")
    assert _kernels.load("topk_fused") is lib          # loaded once
    assert seen == [("build", "topk_fused"), ("load", "topk_fused")]


def _forbid_cuda(monkeypatch):
    def forbidden(*_a, **_k):
        raise AssertionError("touched torch.cuda without a context")

    for name in ("memory_stats", "device_count", "get_device_properties",
                 "mem_get_info", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, forbidden)


def test_no_cuda_context_no_device_lines(monkeypatch):
    telemetry.set_enabled(True)
    _forbid_cuda(monkeypatch)
    lines = devicewatch._collector.collect()
    assert not any(x.startswith("pio_hbm") for x in lines)
    assert "pio_live_arrays 0" in lines
    snap = devicewatch.debug_snapshot()
    assert snap["devices"] == [] and snap["liveArrays"] == {
        "count": 0, "bytes": 0}


def test_hbm_gauges_from_the_caching_allocator(monkeypatch):
    """With a context, the gauges come from memory_stats' allocated and
    active counters and the card's total memory."""
    telemetry.set_enabled(True)
    stats = {"allocated_bytes.all.current": 1 << 20,
             "allocated_bytes.all.peak": 3 << 20,
             "active.all.current": 7,
             "active_bytes.all.current": 900_000}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: types.SimpleNamespace(total_memory=80 << 30,
                                        name="NVIDIA H100 80GB HBM3"))
    lines = devicewatch._collector.collect()
    assert 'pio_hbm_bytes_in_use{device="0"} 1048576' in lines
    assert 'pio_hbm_bytes_limit{device="0"} 85899345920' in lines
    assert 'pio_hbm_peak_bytes_in_use{device="0"} 3145728' in lines
    assert "pio_live_arrays 7" in lines
    assert "pio_live_array_bytes 900000" in lines
    snap = devicewatch.debug_snapshot()
    assert snap["devices"][0]["kind"] == "NVIDIA H100 80GB HBM3"


def test_debug_page_matches_the_reference(monkeypatch):
    for on in (False, True):
        telemetry.set_enabled(on)
        ref_telemetry.set_enabled(on)
        got = devicewatch.debug_snapshot()
        want = ref_devicewatch.debug_snapshot()
        if not on:
            assert json.dumps(got, indent=2, sort_keys=True) == \
                json.dumps(want, indent=2, sort_keys=True)
        else:
            assert set(got) == set(want)
            assert set(got["watchdog"]) == set(want["watchdog"])
            assert set(got["compileCache"]) == set(want["compileCache"])
            assert set(got["hostMemory"]) == set(want["hostMemory"])
