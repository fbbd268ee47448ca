"""Per-request latency waterfalls: where did THIS request's 8 ms go?
(port of ``predictionio_tpu/common/waterfall.py``; host-only stdlib, so
the port keeps its own copy).

``pio_serve_seconds`` says the p99 moved; nothing else in the stack says
*which stage* moved it. This module decomposes every sampled
request's lifetime into explicit stages and keeps the evidence an
operator needs to go from "p99 is 8 ms" to "it's pad-to-bucket on
bucket=64" in one hop:

- **Stage histograms** — ``pio_serve_stage_seconds{stage}`` for each
  stage a request passes through. The serving stages, in request order:

      admission    enqueue -> batch formation (the batcher queue wait)
      supplement   serving.supplement over the flush
      dispatch     the whole predict_batch call (device path included)
      pad          pad-to-bucket index/buffer prep (a drill-down
                   INSIDE dispatch — stages may nest; sums of the
                   top-level stages approximate the total, drill-down
                   stages explain their parent)
      execute      the device dispatch ending in the host transfer of
                   the top-k result (inside dispatch; the ``.cpu()``
                   copy waits for the kernels, so the stage times them
                   and not their asynchronous launch)
      merge        per-query serve() over the flush results
      serialize    prediction -> JSON object on the request thread

- **Exemplars** — each stage-histogram bucket remembers the most recent
  trace id that landed in it, exposed on ``/metrics`` in OpenMetrics
  exemplar syntax (``... 42 # {trace_id="ab12"} 0.0034``) when the
  scraper negotiates ``Accept: application/openmetrics-text`` (classic
  0.0.4 scrapes stay exemplar-free — their parser would read the
  suffix as a timestamp), so an alerting threshold on a bucket leads
  straight to a concrete request.

- **Slow ring** — ``GET /debug/slow.json``: the N slowest sampled
  requests (``PIO_SLOW_RING``, default 32) with their full stage
  breakdown, trace id, and free-form details (e.g. the padding bucket
  that flush landed in).

Sampling: everything gates on ``PIO_WATERFALL=1`` (default OFF — wire
behavior, response bytes and ``/metrics`` series, stays byte-identical
to the pre-waterfall code, asserted by test). ``PIO_WATERFALL_SAMPLE=N``
samples every Nth request (default 1 = all).

Cross-thread plumbing mirrors tracing.py: the record is born on the
request thread, rides the batcher's ``_Pending`` onto the worker
thread, and flush-level stages record into every record of the batch
(they are batch-level costs — each rider paid them).

Dependency-free stdlib; safe to import from any layer.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import itertools
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.common import telemetry, tracing

#: stage latency buckets: tens of µs host stages through multi-second
#: dispatches
STAGE_BUCKETS: Tuple[float, ...] = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_override: Optional[bool] = None


def enabled() -> bool:
    """Is waterfall sampling on? ``PIO_WATERFALL=1`` turns it on;
    :func:`set_enabled` overrides for tests."""
    if _override is not None:
        return _override
    return os.environ.get("PIO_WATERFALL", "0") == "1"


def set_enabled(value: Optional[bool]) -> None:
    """Force sampling on/off regardless of env (None = back to env)."""
    global _override
    _override = value


def _sample_every() -> int:
    raw = os.environ.get("PIO_WATERFALL_SAMPLE", "")
    try:
        return max(1, int(raw)) if raw else 1
    except ValueError:
        return 1


def _ring_cap() -> int:
    raw = os.environ.get("PIO_SLOW_RING", "")
    try:
        return max(1, int(raw)) if raw else 32
    except ValueError:
        return 32


class RequestRecord:
    """One sampled request's stage breakdown. Stage adds are tiny and
    lock-free per record field (a record is written by at most one
    thread at a time: the request thread before submit and after the
    batch completes, the worker thread in between)."""

    __slots__ = ("trace_id", "mode", "stages", "details", "t0",
                 "started_at", "total_s")

    def __init__(self, mode: str, trace_id: str):
        self.trace_id = trace_id
        self.mode = mode
        self.stages: Dict[str, float] = {}
        self.details: Dict[str, Any] = {}
        self.t0 = time.perf_counter()
        # wall clock for display only; durations are perf_counter deltas
        self.started_at = _dt.datetime.now(
            _dt.timezone.utc).isoformat(timespec="milliseconds")
        self.total_s: float = 0.0

    def add(self, stage: str, duration_s: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + duration_s

    def note(self, key: str, value: Any) -> None:
        """Attach free-form detail (e.g. the padding bucket this flush
        landed in) to the slow-ring entry."""
        self.details[key] = value

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "traceId": self.trace_id,
            "mode": self.mode,
            "at": self.started_at,
            "totalMs": round(self.total_s * 1e3, 3),
            "stages": {k: round(v * 1e3, 3)
                       for k, v in self.stages.items()},
        }
        if self.details:
            out["details"] = dict(self.details)
        return out


# ---------------------------------------------------------------------------
# record lifecycle + thread-local activation
# ---------------------------------------------------------------------------

_tls = threading.local()
_sample_seq = itertools.count(1)


def begin(mode: str) -> Optional[RequestRecord]:
    """Start a record for this request, or None (sampling off / not this
    request's turn). Adopts the active trace id so the slow-ring entry,
    the /metrics exemplar, and /traces.json all name the same request;
    without tracing it mints its own id (still cross-referencable
    between slow.json and the exemplars)."""
    if not enabled():
        return None
    n = _sample_every()
    if n > 1 and next(_sample_seq) % n != 0:
        return None
    ctx = tracing.current()
    trace_id = ctx.trace_id if ctx is not None else uuid.uuid4().hex[:16]
    return RequestRecord(mode, trace_id)


@contextlib.contextmanager
def activate(records: Sequence[Optional[RequestRecord]]) -> Iterator[None]:
    """Install ``records`` as the calling thread's active set for the
    block — flush-level stages record into every record of the batch.
    Falsy/None entries are dropped; an empty set is a pure passthrough."""
    recs = tuple(r for r in records if r is not None)
    if not recs:
        yield
        return
    prev = getattr(_tls, "recs", ())
    _tls.recs = recs
    try:
        yield
    finally:
        _tls.recs = prev


def current() -> Optional[RequestRecord]:
    """The calling thread's primary active record (request threads have
    exactly one; the batcher captures it at submit like the trace)."""
    recs = getattr(_tls, "recs", ())
    return recs[0] if recs else None


def _stage_family():
    return telemetry.registry().histogram(
        "pio_serve_stage_seconds",
        "Per-request serve latency decomposed by stage (admission/"
        "supplement/dispatch/pad/execute/merge/serialize); bucket "
        "exemplars carry the most recent trace id",
        labelnames=("stage",), buckets=STAGE_BUCKETS)


def observe_stage(stage: str, duration_s: float,
                  records: Sequence[Optional[RequestRecord]] = ()) -> None:
    """Record a completed stage with an explicit duration into
    ``records`` (cross-thread work, e.g. the batcher's admission wait)
    and into the stage histogram with the first record's trace id as
    the bucket exemplar. No-op when no record is live."""
    recs = tuple(r for r in records if r is not None)
    if not recs:
        return
    for r in recs:
        r.add(stage, duration_s)
    _stage_family().labels(stage=stage).observe(
        duration_s, exemplar=recs[0].trace_id)


def note(key: str, value: Any) -> None:
    """Attach free-form detail to every active record (e.g. that a
    flush's execute took the int8 path). No-op when sampling is
    off — same one-getattr cost as stage()."""
    for r in getattr(_tls, "recs", ()):
        r.note(key, value)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time the block as stage ``name`` for every active record. With no
    active record (waterfall off, unsampled request) the block runs
    untouched — one getattr, the whole cost of sampling-off."""
    recs = getattr(_tls, "recs", ())
    if not recs:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        for r in recs:
            r.add(name, dt)
        _stage_family().labels(stage=name).observe(
            dt, exemplar=recs[0].trace_id)


# ---------------------------------------------------------------------------
# the slow ring (N slowest sampled requests)
# ---------------------------------------------------------------------------

class _SlowRing:
    """Bounded keep-the-slowest set. Insert is O(cap) over a small list
    and runs once per SAMPLED request, off the stage hot path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: List[RequestRecord] = []

    def add(self, rec: RequestRecord) -> None:
        cap = _ring_cap()
        with self._lock:
            # evict the fastest entries until there is room under the
            # cap — one eviction in steady state, several when
            # PIO_SLOW_RING shrank between requests (always dropping by
            # total_s, never by insertion order)
            while len(self._entries) >= cap:
                fastest = min(self._entries, key=lambda r: r.total_s)
                if (len(self._entries) == cap
                        and rec.total_s <= fastest.total_s):
                    return
                self._entries.remove(fastest)
            self._entries.append(rec)

    def snapshot(self, limit: int) -> List[Dict[str, Any]]:
        with self._lock:
            entries = sorted(self._entries, key=lambda r: -r.total_s)
        return [r.snapshot() for r in entries[:max(1, limit)]]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_ring = _SlowRing()


def end(rec: Optional[RequestRecord]) -> None:
    """Close the record (total = begin -> now) and offer it to the slow
    ring. None is allowed — callers never branch on sampling."""
    if rec is None:
        return
    rec.total_s = time.perf_counter() - rec.t0
    _ring.add(rec)


def clear() -> None:
    """Drop every slow-ring entry (tests)."""
    _ring.clear()


def slow_snapshot(limit: int = 32) -> Dict[str, Any]:
    """The ``GET /debug/slow.json`` payload: slowest first, each with
    its full stage breakdown and trace id (join against
    ``/traces.json?trace_id=`` and the /metrics exemplars)."""
    return {
        "enabled": enabled(),
        "capacity": _ring_cap(),
        "sampleEvery": _sample_every(),
        "requests": _ring.snapshot(limit),
    }
