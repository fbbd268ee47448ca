"""Device-level observability on the card (the torch form of
``predictionio_tpu/common/devicewatch.py``).

The reference watches the XLA boundary: it hooks JAX's compile events and
turns a re-trace on the serving path into an alarm. The port compiles
nothing per shape. Its one kind of compile is the build of a kernel
library (``ops/_kernels.py``: ``nvcc`` on ``csrc/<name>.cu`` when the
library is missing or older than its source, 4.5-6.9 s cold on the H100)
and the library's load (``ctypes.CDLL``) on its first use in a process.
This module counts those, under the reference's family names so that
tools read both packages alike:

    pio_xla_compiles_total{fn,phase}    every kernel-library build and
                                        every load, attributed to the
                                        innermost region on the thread
                                        that ran it
    pio_xla_compile_seconds             build and load durations (the
                                        host clock around nvcc and
                                        dlopen; no device work is timed)
    pio_xla_post_warmup_recompiles_total{fn}
                                        the alarm: a build or load inside
                                        a SERVING region after warmup,
                                        where a request waits behind it

Serving code wraps its device dispatch in :func:`serving_region`
(serving/batcher.py's flush, the inline query path); training wraps in
:func:`attribution` (the ops/als.py trainers, WorkflowContext.phase).
Warmup ends after ``PIO_SERVE_WARMUP_FLUSHES`` flushes (default 32) or
an explicit :func:`mark_serving_warmup_done`. A serving signature (the
flush's bucket and size) first seen after warmup is recorded in
``debug_snapshot()["watchdog"]["recentPostWarmup"]`` as evidence of a
shape the warmup never saw, but it is not counted as a recompile: torch
compiles nothing per shape, so a new shape costs no build.

Device gauges (a scrape-time collector in the telemetry registry):

    pio_hbm_bytes_in_use{device} / pio_hbm_peak_bytes_in_use{device}
                                the caching allocator's
                                ``allocated_bytes.all.current`` / ``.peak``
                                (``torch.cuda.memory_stats``)
    pio_hbm_bytes_limit{device} ``get_device_properties().total_memory``
    pio_live_arrays / pio_live_array_bytes
                                the allocator's live blocks and bytes
                                (``active.all.current``,
                                ``active_bytes.all.current``)
    pio_compile_cache_entries / pio_compile_cache_bytes
                                the kernel build directory
                                (``PIO_TORCH_KERNEL_DIR``)

The collector reads the card only when ``torch.cuda.is_initialized()``:
a scrape never creates a CUDA context, so the event server, admin and
dashboard daemons stay off the card and, like the reference on the CPU,
emit no HBM lines. ``GET /debug/device.json`` serves the same state for
people on every daemon.

Everything gates on :func:`telemetry.on` (``PIO_TELEMETRY=1``): with
telemetry off the build hook is a no-op, the collector emits nothing,
and ``/debug/device.json`` answers ``{"telemetry": false}``.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import logging
import os
import threading
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch

from predictionio_tpu_torch.common import telemetry

logger = logging.getLogger("predictionio_tpu_torch.devicewatch")

#: build and load durations: a dlopen of a few ms through a cold nvcc
#: build of many template instances
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                    120.0, 300.0, 600.0)

_tls = threading.local()
_lock = threading.Lock()
_serving_sigs: set = set()
_serving_flushes = 0
_warmup_done = False
#: bounded flight recorder of post-warmup serving events: counted
#: builds/loads and uncounted novel signatures (/debug/device.json)
_post_warmup_events: deque = deque(maxlen=32)
#: most recent quantized-serving state (ops/quant.py via note_quant)
_quant_state: Optional[Dict[str, Any]] = None
#: most recent warm-up summary (workflow/create_server.py via note_aot)
_aot_state: Optional[Dict[str, Any]] = None
#: most recent fold-in worker state (realtime/foldin.py via note_foldin)
_foldin_state: Optional[Dict[str, Any]] = None
#: most recent sharded-serving layout (parallel/serve_dist.py via
#: note_sharding); /debug/device.json and `pio doctor` read it
_sharding_state: Optional[Dict[str, Any]] = None


def _warmup_flush_count() -> int:
    raw = os.environ.get("PIO_SERVE_WARMUP_FLUSHES", "")
    try:
        return max(1, int(raw)) if raw else 32
    except ValueError:
        return 32


# ---------------------------------------------------------------------------
# attribution regions (thread-local; a build runs on the thread whose
# first kernel call needed it, so the active region names the culprit)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def attribution(fn: str, phase: str = "other") -> Iterator[None]:
    """Attribute any kernel build or load inside the block to ``fn``
    under ``phase`` (train/request/...). Nesting: innermost wins — a
    trainer inside a ctx.phase("train") region reports its own name.
    Two thread-local writes; safe to wrap hot paths unconditionally."""
    prev = (getattr(_tls, "fn", None), getattr(_tls, "phase", None))
    _tls.fn, _tls.phase = fn, phase
    try:
        yield
    finally:
        _tls.fn, _tls.phase = prev


@contextlib.contextmanager
def serving_region(fn: str = "serve", signature: str = "") -> Iterator[None]:
    """Attribution for the SERVING path: a build or load inside the block
    after warmup is the alarm (pio_xla_post_warmup_recompiles_total),
    recorded with ``signature`` — the caller's description of this
    dispatch (e.g. ``bucket=16,n=3``). A signature first seen after
    warmup is recorded as evidence, not counted."""
    prev = (getattr(_tls, "fn", None), getattr(_tls, "phase", None),
            getattr(_tls, "serving", False), getattr(_tls, "sig", ""))
    _tls.fn, _tls.phase, _tls.serving, _tls.sig = (
        fn, "serving", True, signature)
    if signature and telemetry.on():
        with _lock:
            novel = signature not in _serving_sigs
            if novel:
                _serving_sigs.add(signature)
            if novel and _warmup_done:
                _post_warmup_events.append({
                    "fn": fn, "signature": signature, "durationS": None,
                    "counted": False, "at": _now_iso()})
    try:
        yield
    finally:
        _tls.fn, _tls.phase, _tls.serving, _tls.sig = prev


def note_serving_flush() -> None:
    """One serving flush completed (the batcher calls this per batch);
    after PIO_SERVE_WARMUP_FLUSHES of them the watchdog arms itself."""
    global _serving_flushes, _warmup_done
    with _lock:
        _serving_flushes += 1
        if not _warmup_done and _serving_flushes >= _warmup_flush_count():
            _warmup_done = True


def mark_serving_warmup_done() -> None:
    """Arm the post-warmup alarm now (tests, or a deploy that warmed its
    kernels some other way)."""
    global _warmup_done
    with _lock:
        _warmup_done = True


def note_quant(summary: Optional[Dict[str, Any]]) -> None:
    """Record (or with None, clear) the deploy's quantized-serving
    state (mode, factor bytes fp32 -> int8, last recall-probe value,
    fell-back flag) for the debug surface."""
    global _quant_state
    with _lock:
        _quant_state = dict(summary) if summary is not None else None


def note_aot(summary: Optional[Dict[str, Any]]) -> None:
    """Record (or with None, clear) the deploy's warm-up summary for the
    debug surface."""
    global _aot_state
    with _lock:
        _aot_state = dict(summary) if summary is not None else None


def note_sharding(summary: Optional[Dict[str, Any]]) -> None:
    """Record (or with None, clear) the deploy's sharded-serving layout
    (shard count, merge strategy, per-shard bytes) for the debug
    surface."""
    global _sharding_state
    with _lock:
        _sharding_state = dict(summary) if summary is not None else None


def note_foldin(summary: Optional[Dict[str, Any]]) -> None:
    """Record (or with None, clear) the fold-in worker's state (cursor
    lag, last tick, freshness percentiles, drift verdicts) for the debug
    surface."""
    global _foldin_state
    with _lock:
        _foldin_state = dict(summary) if summary is not None else None


def serving_warmup_done() -> bool:
    with _lock:
        return _warmup_done


def reset_watchdog() -> None:
    """Forget warmup state, seen signatures and recorded events (tests;
    registry counters are left alone — assert on deltas)."""
    global _serving_flushes, _warmup_done
    with _lock:
        _serving_flushes = 0
        _warmup_done = False
        _serving_sigs.clear()
        _post_warmup_events.clear()


# ---------------------------------------------------------------------------
# recording (ops/_kernels.py calls note_build / note_load)
# ---------------------------------------------------------------------------

def _now_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat(timespec="seconds")


def _note_post_warmup(fn: str, signature: str, what: str,
                      duration_s: float) -> None:
    telemetry.registry().counter(
        "pio_xla_post_warmup_recompiles_total",
        "Kernel-library builds and loads on the serving path AFTER "
        "warmup — each one stalls the requests of its flush",
        labelnames=("fn",)).labels(fn=fn).inc()
    event = {"fn": fn, "signature": signature or "?", "library": what,
             "durationS": round(duration_s, 4), "counted": True,
             "at": _now_iso()}
    with _lock:
        _post_warmup_events.append(event)
    logger.warning(
        "post-warmup kernel %s on the serving path: fn=%s signature=%s "
        "duration=%.3fs", what, fn, signature or "?", duration_s)
    from predictionio_tpu_torch.common import journal
    journal.emit(
        "recompile",
        f"post-warmup kernel {what} on the serving path: {fn} "
        f"[{signature or '?'}]",
        level=journal.RED, fn=fn, signature=signature or "?",
        library=what, durationS=event["durationS"])


def _on_compile(kind: str, library: str, duration_s: float) -> None:
    """A kernel library was built or loaded on this thread. Must never
    raise — a broken metric must not fail the kernel call it watched."""
    if not telemetry.on():
        return
    try:
        fn = getattr(_tls, "fn", None) or "unattributed"
        phase = getattr(_tls, "phase", None) or "other"
        reg = telemetry.registry()
        reg.counter(
            "pio_xla_compiles_total",
            "Kernel-library builds (nvcc) and loads (dlopen) by "
            "attributed entry point and phase",
            labelnames=("fn", "phase")).labels(fn=fn, phase=phase).inc()
        reg.histogram(
            "pio_xla_compile_seconds",
            "Kernel-library build and load duration (host clock)",
            buckets=_COMPILE_BUCKETS).labels().observe(float(duration_s))
        if getattr(_tls, "serving", False) and serving_warmup_done():
            _note_post_warmup(fn, getattr(_tls, "sig", "") or "?",
                              f"{kind} lib{library}", float(duration_s))
    except Exception:
        logger.exception("devicewatch build hook failed")


def note_build(library: str, duration_s: float) -> None:
    """``nvcc`` built ``lib<library>.so`` in ``duration_s`` seconds."""
    _on_compile("build", library, duration_s)


def note_load(library: str, duration_s: float) -> None:
    """``lib<library>.so`` was loaded into the process."""
    _on_compile("load", library, duration_s)


# ---------------------------------------------------------------------------
# readback (tests and the debug surface)
# ---------------------------------------------------------------------------

def _family_sum(name: str) -> float:
    reg = telemetry.registry()
    with reg._lock:
        fam = reg._families.get(name)
    if fam is None:
        return 0.0
    return sum(s[2] for s in fam.samples() if s[0] == name)


def compiles_total() -> int:
    return int(_family_sum("pio_xla_compiles_total"))


def post_warmup_recompiles() -> int:
    return int(_family_sum("pio_xla_post_warmup_recompiles_total"))


# ---------------------------------------------------------------------------
# device gauges (scrape-time)
# ---------------------------------------------------------------------------

def compile_cache_dir() -> str:
    """The kernel build directory (ops/_kernels.py)."""
    from predictionio_tpu_torch.ops import _kernels
    return str(_kernels.build_dir())


def compile_cache_stats() -> Dict[str, int]:
    """{entries, bytes} of the kernel build directory."""
    d = compile_cache_dir()
    try:
        files = [os.path.join(d, f) for f in os.listdir(d)]
        return {"entries": len(files),
                "bytes": int(sum(os.path.getsize(f) for f in files
                                 if os.path.isfile(f)))}
    except OSError:
        return {"entries": 0, "bytes": 0}


def _device_stats() -> List[Dict[str, Any]]:
    """Per-card allocator numbers, or [] when this process has no CUDA
    context (reading them must never be what creates one)."""
    if not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            ms = torch.cuda.memory_stats(i)
            props = torch.cuda.get_device_properties(i)
            stats = {
                "bytes_in_use": int(ms.get("allocated_bytes.all.current",
                                           0)),
                "bytes_limit": int(props.total_memory),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0)),
                "active_blocks": int(ms.get("active.all.current", 0)),
                "active_bytes": int(ms.get("active_bytes.all.current", 0)),
            }
            kind = str(props.name)
        except Exception:       # a card that cannot answer: no stats
            stats, kind = None, "?"
        out.append({"id": i, "platform": "cuda", "kind": kind,
                    "memoryStats": stats})
    return out


_HBM_KEYS = (  # memoryStats key -> exported gauge
    ("bytes_in_use", "pio_hbm_bytes_in_use"),
    ("bytes_limit", "pio_hbm_bytes_limit"),
    ("peak_bytes_in_use", "pio_hbm_peak_bytes_in_use"),
)


def _live_array_stats(devices=None) -> Dict[str, int]:
    """Live tensors on the cards, as the caching allocator counts its
    active blocks (0 without a CUDA context)."""
    devices = _device_stats() if devices is None else devices
    stats = [d["memoryStats"] for d in devices if d["memoryStats"]]
    return {"count": sum(s["active_blocks"] for s in stats),
            "bytes": sum(s["active_bytes"] for s in stats)}


def host_memory_stats() -> Dict[str, Optional[int]]:
    """Host process memory from ``/proc``: resident set (VmRSS), its
    high-water mark (VmHWM) and the machine total (MemTotal); None values
    where ``/proc`` does not exist."""
    out: Dict[str, Optional[int]] = {
        "rssBytes": None, "peakRssBytes": None, "memTotalBytes": None}
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rssBytes"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["peakRssBytes"] = int(line.split()[1]) * 1024
    except OSError:
        return out
    try:
        with open("/proc/meminfo", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    out["memTotalBytes"] = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    return out


class _DeviceCollector:
    """Scrape-time exposition lines for the device gauges. Registered as
    a bound method (the registry holds it weakly); the module-level
    singleton keeps it alive for the process."""

    def collect(self) -> List[str]:
        if not telemetry.on():
            return []   # wire parity: telemetry off => no new series
        lines: List[str] = []
        devices = _device_stats()
        hbm = [d for d in devices if d["memoryStats"]]
        for key, gauge in _HBM_KEYS:
            if not hbm:
                break
            lines.append(f"# TYPE {gauge} gauge")
            for d in hbm:
                lines.append(f'{gauge}{{device="{d["id"]}"}} '
                             f'{d["memoryStats"][key]}')
        live = _live_array_stats(devices)
        lines.append("# TYPE pio_live_arrays gauge")
        lines.append(f"pio_live_arrays {live['count']}")
        lines.append("# TYPE pio_live_array_bytes gauge")
        lines.append(f"pio_live_array_bytes {live['bytes']}")
        host = host_memory_stats()
        if host["rssBytes"] is not None:
            lines.append("# TYPE pio_host_rss_bytes gauge")
            lines.append(f"pio_host_rss_bytes {host['rssBytes']}")
        if host["peakRssBytes"] is not None:
            lines.append("# TYPE pio_host_rss_peak_bytes gauge")
            lines.append(
                f"pio_host_rss_peak_bytes {host['peakRssBytes']}")
        cache = compile_cache_stats()
        lines.append("# TYPE pio_compile_cache_entries gauge")
        lines.append(f"pio_compile_cache_entries {cache['entries']}")
        lines.append("# TYPE pio_compile_cache_bytes gauge")
        lines.append(f"pio_compile_cache_bytes {cache['bytes']}")
        lines.extend(self._breaker_lines())
        return lines

    @staticmethod
    def _breaker_lines() -> List[str]:
        """pio_breaker_open{endpoint}: 1 while a shared circuit breaker
        is open, the live state `pio doctor` reads (the transitions
        counter cannot tell open from recovered). Absent by default: no
        PIO_BREAKER_ENABLED, no breakers, no lines."""
        from predictionio_tpu_torch.common.resilience import CircuitBreaker
        with CircuitBreaker._registry_lock:
            breakers = list(CircuitBreaker._registry.values())
        if not breakers:
            return []
        lines = ["# TYPE pio_breaker_open gauge"]
        for br in breakers:
            is_open = 1 if br.state == CircuitBreaker.OPEN else 0
            ep = telemetry._escape_label(br.endpoint or "?")
            lines.append(f'pio_breaker_open{{endpoint="{ep}"}} {is_open}')
        return lines


_collector = _DeviceCollector()


# ---------------------------------------------------------------------------
# install + /debug/device.json
# ---------------------------------------------------------------------------

def install() -> bool:
    """Register the device-gauge collector (idempotent; every daemon
    calls this from its constructor). The build hook needs no
    registration: ops/_kernels.py calls it. Returns True, as the
    reference does when its compile hooks are live."""
    # registration dedupes on the callable, so re-calling install()
    # after a registry reset (tests) re-attaches it
    telemetry.registry().register_collector(_collector.collect)
    return True


def debug_snapshot() -> Dict[str, Any]:
    """The ``GET /debug/device.json`` payload. With telemetry off the
    subsystem is dormant and the payload says only that. The
    ``aot`` block is the deploy's warm-up, ``sharding`` the sharded
    layout and ``foldin`` the fold-in worker's state (null while those
    are off). ``breakers`` lists the shared
    circuit breakers' stats (common/resilience.py)."""
    if not telemetry.on():
        return {"telemetry": False}
    from predictionio_tpu_torch.common.resilience import CircuitBreaker
    with _lock:
        watchdog = {
            "monitoringHooks": True,
            "servingWarmupDone": _warmup_done,
            "servingFlushes": _serving_flushes,
            "servingSignatures": sorted(_serving_sigs),
            "recentPostWarmup": list(_post_warmup_events),
        }
        quant_state = (dict(_quant_state)
                       if _quant_state is not None else None)
        aot_state = dict(_aot_state) if _aot_state is not None else None
        foldin_state = (dict(_foldin_state)
                        if _foldin_state is not None else None)
        sharding_state = (dict(_sharding_state)
                          if _sharding_state is not None else None)
    watchdog["compilesTotal"] = compiles_total()
    watchdog["postWarmupRecompiles"] = post_warmup_recompiles()
    with CircuitBreaker._registry_lock:
        breakers = [br.stats() for br in
                    CircuitBreaker._registry.values()]
    devices = _device_stats()
    return {
        "telemetry": True,
        "watchdog": watchdog,
        "aot": aot_state,
        "sharding": sharding_state,
        "quant": quant_state,
        "foldin": foldin_state,
        "devices": devices,
        "liveArrays": _live_array_stats(devices),
        "hostMemory": host_memory_stats(),
        "compileCache": {"dir": compile_cache_dir(),
                         **compile_cache_stats()},
        "breakers": breakers,
    }
