"""Request tracing: where did this query's 40 ms go? (port of
``predictionio_tpu/common/tracing.py``; host-only stdlib, so the port
keeps its own copy).

Dapper-style per-request traces (Sigelman et al., 2010) across the
daemons: a trace is born at the first server that sees a request (when
``PIO_TRACE=1``), rides thread-local context through the serving stack
(admission → flush → dispatch), and crosses process boundaries in an
``X-PIO-Trace: <trace_id>-<span_id>`` header. A server that RECEIVES the
header always adopts it (recording spans for an already-sampled request
costs nothing on the wire), but only ORIGINATES new traces when
``PIO_TRACE=1``, so the default wire behavior — no header, no spans — is
byte-identical to the pre-tracing code.

Spans land in a bounded process-wide ring buffer (``PIO_TRACE_BUFFER``,
default 512 spans — old spans fall off; this is a flight recorder, not a
TSDB) served by ``GET /traces.json`` on every daemon.

Tail-based retention (Canopy's insight, SOSP '17: keep the traces worth
debugging, not a uniform sample): a SECOND bounded ring pins whole
traces that (a) contain a span at or over ``PIO_TRACE_TAIL_MS``
(default 100 ms), (b) were flagged by an error/degraded response, or
(c) are referenced by an operational-journal event
(``common/journal.py``). Pinned traces survive main-ring churn —
``/debug/slow.json`` entries, /metrics exemplars, and journal records
keep resolving through ``/traces.json?trace_id=`` long after healthy
traffic evicted their spans. Capacity: ``PIO_TRACE_TAIL_TRACES`` whole
traces (default 64), oldest pin evicted first.

Clocking: span durations are ``time.perf_counter`` deltas; the absolute
timestamp is taken once per span from the wall clock for display only.
Any span that times work on the card must end in a real host transfer
(the ``.cpu()`` copy of a result): a CUDA launch returns before its
kernel runs.

Profiler spans: while a ``torch.profiler`` session runs in the process
(``pio train --profile``, ``POST /debug/profile``, the benchmark's
traced window), :func:`span` also opens a ``record_function`` range of
its name, so the span shows in the session's Chrome trace, and records
it (name, thread, start and end in ns, attrs) in a second bounded ring,
read with :func:`profiler_spans`. Those stamps come from
``time.time_ns``, the clock the profiler stamps device events with, so
a span can be laid over the card's kernels. Outside a session and a
request context a span reads the thread's context and the profiler's
flag, and records nothing.

Dependency-free stdlib; safe to import from any layer.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import os
import sys
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

#: the propagation header (title-case for emission; matching is
#: case-insensitive like every other header in data/api/http.py)
TRACE_HEADER = "X-PIO-Trace"


def enabled() -> bool:
    """May this process ORIGINATE traces? (Adoption of an incoming
    header is always on — it costs nothing when nobody sends one.)"""
    if _override is not None:
        return _override
    return os.environ.get("PIO_TRACE", "0") == "1"


_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force origination on/off regardless of env (None = back to env)."""
    global _override
    _override = value


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """The (trace, parent span) a unit of work belongs to."""
    trace_id: str
    span_id: str

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"


@dataclass(frozen=True)
class Span:
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    service: str
    start_ts: float      # wall-clock epoch seconds (display only)
    duration_s: float    # perf_counter delta (authoritative)


class _Ring:
    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=cap)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def add(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


def _buffer_cap() -> int:
    raw = os.environ.get("PIO_TRACE_BUFFER", "")
    try:
        return max(16, int(raw)) if raw else 512
    except ValueError:
        return 512


def _tail_ms() -> float:
    """Span duration at/over which a trace is pinned in the tail ring
    (``PIO_TRACE_TAIL_MS``, default 100 ms; 0 disables slow-pinning —
    error/journal pins still work)."""
    raw = os.environ.get("PIO_TRACE_TAIL_MS", "")
    try:
        return float(raw) if raw else 100.0
    except ValueError:
        return 100.0


def _tail_cap() -> int:
    raw = os.environ.get("PIO_TRACE_TAIL_TRACES", "")
    try:
        return max(4, int(raw)) if raw else 64
    except ValueError:
        return 64


class _TailRing:
    """Whole-trace retention: trace_id -> {reasons, spans} pinned until
    ``PIO_TRACE_TAIL_TRACES`` newer pins push it out. Pinning copies the
    trace's spans already in the main ring; spans recorded AFTER the pin
    are appended as they arrive (one dict lookup per span — the whole
    added cost on the span-record path)."""

    def __init__(self):
        self._lock = threading.Lock()
        #: trace_id -> {"reasons": [str], "spans": {span_id: Span}}
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def pin(self, trace_id: str, reason: str,
            existing: List[Span]) -> None:
        with self._lock:
            entry = self._traces.get(trace_id)
            if entry is None:
                entry = {"reasons": [], "spans": {}}
                self._traces[trace_id] = entry
            if reason not in entry["reasons"]:
                entry["reasons"].append(reason)
            for s in existing:
                if s.trace_id == trace_id:
                    entry["spans"][s.span_id] = s
            cap = _tail_cap()
            while len(self._traces) > cap:
                self._traces.popitem(last=False)   # oldest pin goes first

    def offer(self, span: Span) -> bool:
        """Append ``span`` if its trace is pinned; False otherwise."""
        with self._lock:
            entry = self._traces.get(span.trace_id)
            if entry is None:
                return False
            entry["spans"][span.span_id] = span
            return True

    def spans_for(self, trace_id: str) -> List[Span]:
        with self._lock:
            entry = self._traces.get(trace_id)
            return list(entry["spans"].values()) if entry else []

    def reasons_for(self, trace_id: str) -> List[str]:
        with self._lock:
            entry = self._traces.get(trace_id)
            return list(entry["reasons"]) if entry else []

    def retained(self) -> int:
        with self._lock:
            return len(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


@dataclass(frozen=True)
class ProfiledSpan:
    """A span recorded while a ``torch.profiler`` session ran."""
    name: str
    thread: int          # threading.get_ident() of the recording thread
    start_ns: int        # time.time_ns(), the profiler's clock
    end_ns: int
    attrs: Dict[str, Any]


class _ProfiledRing:
    """The profiler spans, oldest first; past ``cap`` the oldest falls
    off and is counted as dropped."""

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=cap)
        self._dropped = 0

    def add(self, span: ProfiledSpan) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(span)

    def read(self) -> Tuple[List[ProfiledSpan], int]:
        with self._lock:
            return list(self._buf), self._dropped

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0


#: profiler spans kept: a 10-iteration train records 40, the benchmark's
#: traced window at most a few hundred
PROFILED_CAP = 4096

_ring = _Ring(_buffer_cap())
_tail = _TailRing()
_profiled = _ProfiledRing(PROFILED_CAP)
_tls = threading.local()


def clear() -> None:
    """Drop every recorded span AND every tail-pinned trace, and the
    profiler spans with their drop count (tests)."""
    _ring.clear()
    _tail.clear()
    _profiled.clear()


def profiler_spans() -> Tuple[List[ProfiledSpan], int]:
    """The profiler spans the ring holds, oldest first, and how many it
    dropped (since the process started or the last :func:`clear`)."""
    return _profiled.read()


def pin_trace(trace_id: Optional[str], reason: str) -> None:
    """Retain ``trace_id``'s spans in the tail ring: its current main-
    ring spans are copied now and later spans accrue as recorded, so
    the id keeps resolving via ``/traces.json?trace_id=`` after churn.
    Callers: the journal (an event referenced the trace), the transport
    (a 5xx response), the query server (a degraded response), and the
    slow-span check below. None/empty ids are ignored."""
    if not trace_id:
        return
    _tail.pin(trace_id, reason, _ring.spans())


def pin_current(reason: str) -> None:
    """Pin the calling thread's active trace, if any."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        pin_trace(ctx.trace_id, reason)


def tail_retained() -> int:
    """Traces currently pinned in the tail ring."""
    return _tail.retained()


def _record(span: Span) -> None:
    """Every recorded span lands here: main ring always; tail ring when
    its trace is pinned; a span at/over the tail threshold pins its
    trace (the Canopy tail-sampling decision, made at span end when the
    latency is known)."""
    _ring.add(span)
    if not _tail.offer(span):
        threshold = _tail_ms()
        if threshold > 0 and span.duration_s * 1e3 >= threshold:
            _tail.pin(span.trace_id, "slow", _ring.spans())


# ---------------------------------------------------------------------------
# context plumbing
# ---------------------------------------------------------------------------

def current() -> Optional[TraceContext]:
    """This thread's active trace context, or None (the common case —
    one getattr, the whole cost of tracing-off)."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Install ``ctx`` as this thread's context for the block (None is
    allowed and simply clears it — callers never need to branch)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def new_context(trace_id: Optional[str] = None) -> TraceContext:
    return TraceContext(trace_id or _new_id(), _new_id())


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """``trace_id-span_id`` → context; malformed values are ignored (a
    bad header must never fail the request it rode in on)."""
    if not value:
        return None
    trace_id, _, span_id = value.strip().partition("-")
    if not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id)


def server_context(headers: Optional[Dict[str, str]]) -> \
        Optional[TraceContext]:
    """The context an incoming request should run under: the propagated
    header's (always adopted), else a fresh root when origination is on,
    else None."""
    if headers:
        for k, v in headers.items():
            if k.lower() == "x-pio-trace":
                ctx = parse_header(v)
                if ctx is not None:
                    return ctx
                break
    if enabled():
        return new_context()
    return None


# ---------------------------------------------------------------------------
# span recording
# ---------------------------------------------------------------------------

def _wall_now() -> float:
    # wall clock for display; durations always come from perf_counter
    return _dt.datetime.now(_dt.timezone.utc).timestamp()


def _profiler_running() -> bool:
    """Is a ``torch.profiler`` session running? The flag torch sets on a
    session's start, read through ``sys.modules`` so that this module
    never imports torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


@contextlib.contextmanager
def span(name: str, service: str = "", **attrs):
    """Record a child span of the active context around the block, and,
    while a ``torch.profiler`` session runs, a profiler span carrying
    ``attrs`` (module docstring).

    Neither -> pure pass-through; the block runs untouched. The child
    becomes the active context inside the block, so nested spans and
    outbound RPC headers chain correctly."""
    ctx = getattr(_tls, "ctx", None)
    profiled = _profiler_running()
    if ctx is None and not profiled:
        yield None
        return
    with contextlib.ExitStack() as stack:
        if profiled:
            stack.callback(_end_profiled, name, attrs, time.time_ns())
            from torch.profiler import record_function
            stack.enter_context(record_function(name))
        if ctx is None:
            yield None
            return
        child = TraceContext(ctx.trace_id, _new_id())
        prev = ctx
        _tls.ctx = child
        wall = _wall_now()
        t0 = time.perf_counter()
        try:
            yield child
        finally:
            dt = time.perf_counter() - t0
            _tls.ctx = prev
            _record(Span(
                trace_id=child.trace_id, span_id=child.span_id,
                parent_id=prev.span_id, name=name, service=service,
                start_ts=wall, duration_s=dt))


def _end_profiled(name: str, attrs: Dict[str, Any], start_ns: int) -> None:
    _profiled.add(ProfiledSpan(name, threading.get_ident(), start_ns,
                               time.time_ns(), attrs))


def record_span(name: str, ctx: Optional[TraceContext],
                duration_s: float, service: str = "") -> None:
    """Record a completed span with an explicit duration under ``ctx``
    (for work timed on another thread, e.g. the batcher's per-item
    admission wait). No-op when ctx is None."""
    if ctx is None:
        return
    _record(Span(
        trace_id=ctx.trace_id, span_id=_new_id(), parent_id=ctx.span_id,
        name=name, service=service,
        start_ts=_wall_now() - duration_s, duration_s=duration_s))


# ---------------------------------------------------------------------------
# /traces.json
# ---------------------------------------------------------------------------

def snapshot(limit: int = 64, trace_id: Optional[str] = None
             ) -> Dict[str, Any]:
    """Ring-buffer contents grouped by trace, newest trace first.

    ``limit`` caps how many traces are grouped and serialized (the ring
    itself stays bounded by PIO_TRACE_BUFFER); ``trace_id`` narrows the
    result to one trace — the cheap targeted read `pio doctor`,
    dashboards and `pio trace` fleet assembly use instead of dumping
    the whole buffer. A targeted read also consults the TAIL ring, so
    a pinned (slow/error/journal-referenced) trace resolves after the
    main ring churned past it; its pin reasons ride along as
    ``pinned``. ``spanCount`` always reports the main-ring total so a
    filtered read still shows how much is buffered."""
    limit = max(1, int(limit))
    spans = _ring.spans()
    by_trace: Dict[str, List[Span]] = {}
    order: List[str] = []

    def _add(s: Span) -> None:
        if s.trace_id not in by_trace:
            by_trace[s.trace_id] = []
            order.append(s.trace_id)
        by_trace[s.trace_id].append(s)

    seen_ids = set()
    for s in spans:
        if trace_id is not None and s.trace_id != trace_id:
            continue
        seen_ids.add(s.span_id)
        _add(s)
    pinned_reasons: List[str] = []
    if trace_id is not None:
        # tail-ring merge: spans the main ring already evicted
        for s in _tail.spans_for(trace_id):
            if s.span_id not in seen_ids:
                _add(s)
        pinned_reasons = _tail.reasons_for(trace_id)
    traces = []
    for tid in reversed(order[-limit:]):
        ss = sorted(by_trace[tid], key=lambda s: s.start_ts)
        entry = {
            "traceId": tid,
            "spans": [{
                "spanId": s.span_id,
                "parentId": s.parent_id,
                "name": s.name,
                "service": s.service,
                "startMs": round(s.start_ts * 1e3, 3),
                "durationMs": round(s.duration_s * 1e3, 3),
            } for s in ss],
        }
        if pinned_reasons and tid == trace_id:
            entry["pinned"] = pinned_reasons
        traces.append(entry)
    return {"originate": enabled(), "capacity": _ring.capacity,
            "spanCount": len(spans),
            "tail": {"capacity": _tail_cap(), "retained": _tail.retained(),
                     "thresholdMs": _tail_ms()},
            "traces": traces}
