"""Flight recorder: a bounded journal of structured operational events
(port of ``predictionio_tpu/common/journal.py``; host-only stdlib, so the
port keeps its own copy).

Gauges and span rings are the *state* half of observability, and state
has no memory: when a deploy lands, a drain begins, or a kernel library
is rebuilt on the serving path, the evidence is a gauge that has since
moved on. This module is the *history* half: every operationally
significant event lands here as a structured record —

    seq        process-monotonic sequence number (the pagination cursor)
    ts         wall-clock epoch seconds (display + cross-daemon merge)
    level      info | warn | red (red = page-worthy, the doctor's tiers)
    category   the subsystem (``lifecycle`` for deploys and drains,
               ``recompile`` for the serving-path build alarm)
    message    one operator-grade line
    fields     structured detail (endpoint, generation id, byte counts)
    traceId    the active trace, when one is live — emitting an event
               also PINS that trace in tracing's tail ring, so the
               timeline's trace ids keep resolving after ring churn

served as ``GET /debug/events.json?since_seq=&category=&level=`` on
every daemon via ``telemetry.handle_route``. ``since_seq`` makes the
read a cheap incremental tail (``pio events --follow`` polls it);
``level`` filters by MINIMUM severity (``level=warn`` returns warn+red).

Cost model: events are RARE by construction (deploys, drains, serving-
path builds — not requests), so ``emit`` can afford a lock + a deque
append unconditionally. The serving hot path never emits.
``PIO_JOURNAL=0`` disables recording outright — existing endpoints'
bytes are unchanged either way (the journal only ever ADDS a new
surface), asserted by test.

Each emit also increments ``pio_journal_events_total{category,level}``
(gated on ``PIO_TELEMETRY=1`` like every new metric site) so dashboards
can alert on event RATES while the journal itself holds the evidence.

Dependency-free stdlib; safe to import from any layer.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("predictionio_tpu_torch.journal")

#: severity levels, in escalation order (doctor tiers: red pages)
INFO, WARN, RED = "info", "warn", "red"
_SEVERITY = {INFO: 0, WARN: 1, RED: 2}

_override: Optional[bool] = None


def enabled() -> bool:
    """Is the journal recording? On by default — the flight recorder is
    most valuable precisely when nobody thought to opt in before the
    incident. ``PIO_JOURNAL=0`` disables it outright."""
    if _override is not None:
        return _override
    return os.environ.get("PIO_JOURNAL", "1") != "0"


def set_enabled(value: Optional[bool]) -> None:
    """Force recording on/off regardless of env (None = back to env)."""
    global _override
    _override = value


def _buffer_cap() -> int:
    raw = os.environ.get("PIO_JOURNAL_BUFFER", "")
    try:
        return max(16, int(raw)) if raw else 1024
    except ValueError:
        return 1024


def _wall_now() -> float:
    # wall clock for display and cross-daemon merge ordering; the
    # journal records points in time, not durations
    return _dt.datetime.now(_dt.timezone.utc).timestamp()


class _Journal:
    """The process-wide bounded event ring. seq is monotonic for the
    process lifetime — eviction drops old RECORDS, never renumbers —
    so ``since_seq`` cursors from any point in time stay valid."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=_buffer_cap())
        self._seq = 0

    def append(self, record: Dict[str, Any]) -> int:
        with self._lock:
            # honor a changed PIO_JOURNAL_BUFFER between tests/configs
            cap = _buffer_cap()
            if self._buf.maxlen != cap:
                self._buf = deque(self._buf, maxlen=cap)
            self._seq += 1
            record["seq"] = self._seq
            self._buf.append(record)
            return self._seq

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._seq + 1

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._buf.maxlen or 0

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seq = 0


_journal = _Journal()


def clear() -> None:
    """Drop every record and reset seq (tests)."""
    _journal.clear()


def events_total() -> int:
    """Events emitted since process start."""
    return _journal.next_seq - 1


def emit(category: str, message: str, level: str = INFO,
         **fields: Any) -> Optional[int]:
    """Record one operational event; returns its seq (None when the
    journal is off). The active trace context, if any, is captured and that trace is pinned
    in the tail ring so the journal's trace ids keep resolving.

    Never raises: a broken journal must not fail the operation it was
    recording (same contract as the devicewatch build hook)."""
    if not enabled():
        return None
    try:
        if level not in _SEVERITY:
            level = INFO
        from predictionio_tpu_torch.common import tracing
        ctx = tracing.current()
        trace_id = ctx.trace_id if ctx is not None else None
        record: Dict[str, Any] = {
            "ts": _wall_now(),
            "level": level,
            "category": str(category),
            "message": str(message),
        }
        if fields:
            record["fields"] = {k: v for k, v in fields.items()}
        if trace_id is not None:
            record["traceId"] = trace_id
        seq = _journal.append(record)
        if trace_id is not None:
            # the journal referenced this trace: keep it resolvable
            # after the main span ring churns past it
            tracing.pin_trace(trace_id, f"journal:{category}")
        from predictionio_tpu_torch.common import telemetry
        if telemetry.on():
            telemetry.registry().counter(
                "pio_journal_events_total",
                "Operational journal events by category and level "
                "(common/journal.py; the events ride "
                "/debug/events.json)",
                labelnames=("category", "level")).labels(
                    category=str(category), level=level).inc()
        return seq
    except Exception:
        logger.exception("journal emit failed (event dropped)")
        return None


def _fmt_at(ts: float) -> str:
    return _dt.datetime.fromtimestamp(
        ts, _dt.timezone.utc).isoformat(timespec="milliseconds")


def snapshot(since_seq: int = 0, category: Optional[str] = None,
             level: Optional[str] = None,
             limit: int = 256) -> Dict[str, Any]:
    """The ``GET /debug/events.json`` payload: records with
    ``seq > since_seq``, optionally narrowed to one category and/or a
    minimum severity, oldest first, at most ``limit`` NEWEST records
    (a capped read under churn must return the events closest to now).
    ``lastSeq`` is the cursor: a follower passes it back as
    ``since_seq`` and never sees a record twice."""
    limit = max(1, int(limit))
    min_sev = _SEVERITY.get(level or INFO, 0)
    out: List[Dict[str, Any]] = []
    for rec in _journal.snapshot():
        if rec["seq"] <= since_seq:
            continue
        if category and rec["category"] != category:
            continue
        if _SEVERITY.get(rec["level"], 0) < min_sev:
            continue
        item = {
            "seq": rec["seq"],
            "ts": rec["ts"],
            "at": _fmt_at(rec["ts"]),
            "level": rec["level"],
            "category": rec["category"],
            "message": rec["message"],
            "fields": dict(rec.get("fields") or {}),
        }
        if rec.get("traceId") is not None:
            item["traceId"] = rec["traceId"]
        out.append(item)
    out = out[-limit:]
    return {
        "enabled": enabled(),
        "capacity": _journal.capacity,
        "lastSeq": _journal.next_seq - 1,
        "events": out,
    }
