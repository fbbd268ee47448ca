"""Metrics flight recorder: bounded in-process time-series history
(port of ``predictionio_tpu/common/history.py``; host-only stdlib, so
the port keeps its own copy).

The observability stack records *events* (the journal), *traces*
(tracing/traceview) and *instants* (``GET /metrics`` scrapes) — but a
scrape's numbers vanish the moment it ends, so "what did p99 and QPS do
in the ten minutes before the breaker opened?" is unanswerable after
the fact. Monarch (VLDB 2020) and Canopy both land on the
same answer the journal already embodies: retain the derived signal
**in-process, bounded, near the source**, so the question can be asked
when the interesting-ness is known — at incident time.

One sampler thread per process (``install()`` is idempotent like
``slo.install``) snapshots every registry counter/gauge/histogram each
``PIO_HISTORY_TICK_S`` (default 5 s) into fixed rings at two tiers:

====== ========== ======= =========
tier   resolution slots   retention
====== ========== ======= =========
fast   tick (5 s) 720     ~1 hour
slow   12 ticks   1440    ~24 hours
====== ========== ======= =========

Counters are stored as **per-tick deltas** and histograms as **bucket
deltas** (gauges as last value), so rates, error ratios and windowed
p99-over-time are derivable from the rings alone — no scraper, no
external TSDB. ``GET /debug/history.json?series=&since_ms=&res=`` on
every daemon serves the rings (telemetry.handle_route); the reference's
`pio monitor` and `pio incident` are the consumers (not ported yet).

Cost model mirrors slo.py: the hot path pays NOTHING — sampling happens
on the recorder's own thread at scrape cadence against the same child
locks a /metrics scrape takes. ``PIO_HISTORY=0`` disables recording
outright — existing endpoints' bytes are unchanged (wire parity,
asserted by test) and the endpoint answers ``enabled: false``.

Bounds: the rings are per-process and fixed-size —
a restart loses history, and series beyond ``PIO_HISTORY_MAX_SERIES``
(default 512) are dropped, not grown.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import deque
from datetime import datetime, timezone
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.common import telemetry

#: fast tier: one slot per tick (5 s x 720 = 1 h)
FAST_SLOTS = 720
#: slow tier: one slot per SLOW_EVERY ticks (60 s x 1440 = 24 h)
SLOW_SLOTS = 1440
#: fast ticks folded into one slow slot (60 s / 5 s)
SLOW_EVERY = 12

_INF = float("inf")


def on() -> bool:
    """Is history recording enabled? Default ON like the journal — the
    flight recorder must already be running when the incident happens.
    ``PIO_HISTORY=0`` disables it outright."""
    if _override is not None:
        return _override
    return os.environ.get("PIO_HISTORY", "1") != "0"


_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force history on/off regardless of env (None = back to env)."""
    global _override
    _override = value


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


@dataclasses.dataclass
class HistoryConfig:
    """Ring geometry + sampler cadence (env-defaulted)."""
    tick_s: float = 5.0
    fast_slots: int = FAST_SLOTS
    slow_slots: int = SLOW_SLOTS
    slow_every: int = SLOW_EVERY
    max_series: int = 512

    @classmethod
    def from_env(cls) -> "HistoryConfig":
        return cls(
            tick_s=max(0.1, _env_float("PIO_HISTORY_TICK_S", 5.0)),
            max_series=max(1, _env_int("PIO_HISTORY_MAX_SERIES", 512)),
        )


# ---------------------------------------------------------------------------
# SLO snapshot ring (re-homed from slo.py — one snapshotter per process)
# ---------------------------------------------------------------------------

class SnapshotRing:
    """Bounded ``(t, good, total)`` snapshot ring + trailing-window
    differencing — the windowed-burn bookkeeping of ``slo.SLOEngine``,
    homed here so the history sampler (not each scrape path privately)
    is the process's snapshotter.
    """

    def __init__(self, maxlen: int = 4096):
        self._dq: Deque[Tuple[float, float, float]] = deque(maxlen=maxlen)

    def append(self, t: float, good: float, total: float) -> None:
        self._dq.append((t, good, total))

    def __len__(self) -> int:
        return len(self._dq)

    def __bool__(self) -> bool:
        return bool(self._dq)

    def __getitem__(self, i):
        return self._dq[i]

    def __iter__(self):
        return iter(self._dq)

    def __reversed__(self):
        return reversed(self._dq)

    def window_rate(self, now: float, good: float, total: float,
                    window_s: float) -> float:
        """Observed BAD fraction over the trailing window (0 when the
        window saw no traffic). A brand-new ring (no snapshot yet)
        claims NO burn rather than judging the process's whole lifetime
        as one window — the baseline forms at the first snapshot and
        real rates start at the second."""
        if not self._dq:
            return 0.0
        base: Optional[Tuple[float, float, float]] = None
        for t, g, n in reversed(self._dq):
            if now - t >= window_s:
                base = (t, g, n)
                break
        if base is None:
            # window extends past recorded history: difference against
            # the oldest snapshot (partial-window coverage)
            base = self._dq[0]
        d_total = total - base[2]
        if d_total <= 0:
            return 0.0
        d_bad = (total - good) - (base[2] - base[1])
        return max(0.0, d_bad / d_total)

    def prune(self, now: float, keep_window_s: float) -> None:
        """Drop entries older than the window, keeping one just outside
        it as the differencing base."""
        while (len(self._dq) > 2
               and now - self._dq[1][0] > keep_window_s):
            self._dq.popleft()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _flat_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    """Prometheus-shaped series key: ``name{k="v",...}`` (or bare name
    when unlabeled) — what ``?series=`` filters match family names
    against and what `pio monitor` parses back apart."""
    if not labels:
        return name
    lab = ",".join(f'{k}="{telemetry._escape_label(v)}"'
                   for k, v in labels)
    return f"{name}{{{lab}}}"


def series_family(key: str) -> str:
    """The family name of a flat series key (strip the label block)."""
    return key.split("{", 1)[0]


def _fmt_ub(ub: float) -> str:
    return "+Inf" if ub == _INF else telemetry._fmt_number(ub)


class Recorder:
    """Two-tier bounded time-series rings over the process registry.

    ``tick()`` is one sampler pass: read every family, difference
    counters/histograms against the previous pass, append one entry to
    the fast ring, and fold every ``slow_every`` fast entries into one
    slow slot. Tests drive ``tick(wall_ms=...)`` directly; production
    runs it on the `pio-history` thread ``install()`` starts."""

    def __init__(self, config: Optional[HistoryConfig] = None):
        self.config = config or HistoryConfig.from_env()
        self._lock = threading.Lock()
        self._fast: Deque[Dict[str, Any]] = deque(
            maxlen=self.config.fast_slots)
        self._slow: Deque[Dict[str, Any]] = deque(
            maxlen=self.config.slow_slots)
        self._pending: List[Dict[str, Any]] = []
        #: previous cumulative values for differencing
        self._prev_counter: Dict[str, float] = {}
        self._prev_hist: Dict[str, Tuple[Dict[float, float], float,
                                         float]] = {}
        #: family name -> kind, for downsampling + consumers
        self._kinds: Dict[str, str] = {}
        #: admitted series keys (bounded by max_series)
        self._tracked: set = set()
        self._ticks = 0
        self._dropped_total = 0

    # --------------------------------------------------------------- deltas
    def _counter_delta(self, key: str, value: float) -> float:
        """Per-tick counter delta. First sight baselines at 0 (the
        counter's past predates the ring); a value going BACKWARDS is a
        counter reset (a registry reset, a re-created family) and the
        delta restarts from the new value instead of going negative."""
        prev = self._prev_counter.get(key)
        self._prev_counter[key] = value
        if prev is None:
            return 0.0
        if value < prev:
            return float(value)
        return value - prev

    def _hist_delta(self, key: str,
                    snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Per-tick histogram delta: cumulative-bucket differences (so
        each tick's entry is itself a tiny cumulative histogram of just
        that tick's observations), plus sum/count deltas. None on the
        baseline tick; count going backwards is a reset (tolerated the
        same way as counters)."""
        prev = self._prev_hist.get(key)
        self._prev_hist[key] = (dict(snap["buckets"]), snap["sum"],
                                snap["count"])
        if prev is None:
            return None
        pb, ps, pc = prev
        if snap["count"] < pc:
            pb, ps, pc = {}, 0.0, 0.0
        buckets = {_fmt_ub(ub): cum - pb.get(ub, 0.0)
                   for ub, cum in snap["buckets"].items()}
        return {"buckets": buckets,
                "sum": snap["sum"] - ps,
                "count": snap["count"] - pc}

    def _admit(self, key: str) -> bool:
        if key in self._tracked:
            return True
        if len(self._tracked) >= self.config.max_series:
            self._dropped_total += 1
            return False
        self._tracked.add(key)
        return True

    # ----------------------------------------------------------------- tick
    def tick(self, wall_ms: Optional[int] = None) -> None:
        """One sampler pass over the registry. No-op while disabled (the
        rings keep what they had — a mid-incident toggle must not wipe
        the evidence)."""
        if not on():
            return
        if wall_ms is None:
            wall_ms = int(
                datetime.now(timezone.utc).timestamp() * 1000)
        series: Dict[str, Any] = {}
        reg = telemetry.registry()
        with reg._lock:
            families = list(reg._families.values())
        for fam in families:
            self._kinds[fam.name] = fam.kind
            if fam.kind == "histogram":
                with fam._lock:
                    items = list(fam._children.items())
                for label_key, child in items:
                    key = _flat_key(fam.name,
                                    tuple(zip(fam.labelnames, label_key)))
                    if not self._admit(key):
                        continue
                    entry = self._hist_delta(key, child.snapshot())
                    if entry is not None:
                        series[key] = entry
            else:
                for name, labels, value, *_ in fam.samples():
                    key = _flat_key(name, labels)
                    if not self._admit(key):
                        continue
                    if fam.kind == "counter":
                        series[key] = self._counter_delta(key, value)
                    else:
                        series[key] = float(value)
        entry = {"t": int(wall_ms), "series": series}
        with self._lock:
            self._fast.append(entry)
            self._pending.append(entry)
            self._ticks += 1
            if len(self._pending) >= self.config.slow_every:
                self._slow.append(self._merge(self._pending))
                self._pending = []
            n_tracked = len(self._tracked)
            dropped = self._dropped_total
        # keep the SLO engine's burn windows warm between scrapes: the
        # sampler is the process's one snapshotter (lazy import — slo
        # imports this module for SnapshotRing)
        from predictionio_tpu_torch.common import slo
        eng = slo.engine()
        if eng is not None:
            eng.record_snapshot()
        if telemetry.on():
            reg.counter(
                "pio_history_ticks_total",
                "Sampler passes the metrics flight recorder completed",
            ).child().inc()
            reg.gauge(
                "pio_history_series",
                "Series the flight recorder currently tracks (bounded "
                "by PIO_HISTORY_MAX_SERIES)",
            ).child().set(n_tracked)
            if dropped:
                fam = reg.counter(
                    "pio_history_dropped_series_total",
                    "Series refused by the PIO_HISTORY_MAX_SERIES cap "
                    "(bounded memory beats complete coverage)")
                child = fam.child()
                child.inc(dropped - child.value)

    def _merge(self, entries: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold fast entries into one slow slot: counter + histogram
        deltas sum (a 60 s delta is the sum of its 5 s deltas); gauges
        keep the last value (a gauge has no meaningful sum)."""
        out: Dict[str, Any] = {}
        for e in entries:
            for key, v in e["series"].items():
                if isinstance(v, dict):
                    agg = out.get(key)
                    if agg is None:
                        out[key] = {"buckets": dict(v["buckets"]),
                                    "sum": v["sum"],
                                    "count": v["count"]}
                    else:
                        for ub, c in v["buckets"].items():
                            agg["buckets"][ub] = (
                                agg["buckets"].get(ub, 0.0) + c)
                        agg["sum"] += v["sum"]
                        agg["count"] += v["count"]
                elif self._kinds.get(series_family(key)) == "counter":
                    out[key] = out.get(key, 0.0) + v
                else:
                    out[key] = v
        return {"t": entries[-1]["t"], "series": out}

    # ------------------------------------------------------------- snapshot
    def snapshot(self, series: Optional[str] = None, since_ms: int = 0,
                 res: str = "fast",
                 limit: Optional[int] = None) -> Dict[str, Any]:
        """The ring as JSON: ``series`` narrows to a comma-separated
        set of family names, ``since_ms`` is a wall-clock cursor
        (entries strictly after it), ``res`` picks the tier."""
        names = {s.strip() for s in (series or "").split(",")
                 if s.strip()}
        with self._lock:
            ring = list(self._slow if res == "slow" else self._fast)
            kinds = dict(self._kinds)
            n_tracked = len(self._tracked)
            ticks = self._ticks
            dropped = self._dropped_total
        samples = [e for e in ring if e["t"] > since_ms]
        if limit is not None and len(samples) > limit:
            samples = samples[-limit:]
        if names:
            samples = [
                {"t": e["t"],
                 "series": {k: v for k, v in e["series"].items()
                            if series_family(k) in names}}
                for e in samples]
            kinds = {k: v for k, v in kinds.items() if k in names}
        cfg = self.config
        return {
            "enabled": on(),
            "res": "slow" if res == "slow" else "fast",
            "tickS": cfg.tick_s,
            "retention": {
                "fast": {"tickS": cfg.tick_s, "slots": cfg.fast_slots},
                "slow": {"tickS": cfg.tick_s * cfg.slow_every,
                         "slots": cfg.slow_slots},
            },
            "seriesTotal": n_tracked,
            "ticksTotal": ticks,
            "droppedSeries": dropped,
            "kinds": kinds,
            "samples": samples,
        }

    def series_total(self) -> int:
        with self._lock:
            return len(self._tracked)


# ---------------------------------------------------------------------------
# derivation helpers (shared by doctor / monitor / incident)
# ---------------------------------------------------------------------------

def rate_points(samples: Iterable[Dict[str, Any]], family: str,
                tick_s: float,
                label_filter: Optional[Dict[str, str]] = None,
                ) -> List[Tuple[int, float]]:
    """Per-entry ``(t_ms, events/s)`` summed across a counter family's
    label sets; ``label_filter`` keeps only series whose key carries
    every ``k="v"`` pair."""
    out: List[Tuple[int, float]] = []
    for e in samples:
        total = 0.0
        seen = False
        for key, v in e.get("series", {}).items():
            if series_family(key) != family or isinstance(v, dict):
                continue
            if label_filter and not all(
                    f'{k}="{val}"' in key
                    for k, val in label_filter.items()):
                continue
            total += v
            seen = True
        if seen:
            out.append((e["t"], total / max(tick_s, 1e-9)))
    return out


def count_points(samples: Iterable[Dict[str, Any]], family: str,
                 tick_s: float) -> List[Tuple[int, float]]:
    """Per-entry ``(t_ms, observations/s)`` from a histogram family's
    count deltas, label sets merged — QPS straight off a latency
    histogram, no separate request counter needed."""
    out: List[Tuple[int, float]] = []
    for e in samples:
        total = 0.0
        seen = False
        for key, v in e.get("series", {}).items():
            if series_family(key) != family or not isinstance(v, dict):
                continue
            total += v["count"]
            seen = True
        if seen:
            out.append((e["t"], total / max(tick_s, 1e-9)))
    return out


def quantile_points(samples: Iterable[Dict[str, Any]], family: str,
                    q: float, group: int = 1,
                    ) -> List[Tuple[int, float]]:
    """Per-window ``(t_ms, quantile_seconds)`` from a histogram
    family's bucket deltas, label sets merged; ``group`` coalesces that
    many consecutive entries per point (steadier quantiles from thin
    per-tick counts). Windows with no observations are skipped."""
    acc: Dict[str, float] = {}
    count = 0.0
    n_in_group = 0
    t_last = 0
    out: List[Tuple[int, float]] = []
    for e in samples:
        for key, v in e.get("series", {}).items():
            if series_family(key) != family or not isinstance(v, dict):
                continue
            for ub, c in v["buckets"].items():
                acc[ub] = acc.get(ub, 0.0) + c
            count += v["count"]
        n_in_group += 1
        t_last = e["t"]
        if n_in_group >= group:
            if count > 0:
                out.append((t_last, bucket_quantile(acc, count, q)))
            acc, count, n_in_group = {}, 0.0, 0
    if n_in_group and count > 0:
        out.append((t_last, bucket_quantile(acc, count, q)))
    return out


def bucket_quantile(buckets: Dict[str, float], count: float,
                    q: float) -> float:
    """Prometheus-style histogram_quantile over cumulative bucket
    counts keyed by formatted upper bound (``+Inf`` included)."""
    def _ub(s: str) -> float:
        return _INF if s == "+Inf" else float(s)
    edges = sorted(((_ub(k), v) for k, v in buckets.items()),
                   key=lambda kv: kv[0])
    rank = q * count
    prev_edge, prev_cum = 0.0, 0.0
    for edge, cum in edges:
        if cum >= rank:
            if edge == _INF:
                return prev_edge
            span = cum - prev_cum
            if span <= 0:
                return edge
            return prev_edge + (edge - prev_edge) * (
                (rank - prev_cum) / span)
        prev_edge, prev_cum = edge, cum
    return prev_edge


# ---------------------------------------------------------------------------
# the process recorder + sampler thread
# ---------------------------------------------------------------------------

class _Sampler(threading.Thread):
    def __init__(self, rec: Recorder):
        super().__init__(name="pio-history", daemon=True)
        self._rec = rec
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.wait(self._rec.config.tick_s):
            try:
                self._rec.tick()
            except Exception:
                # the flight recorder must never take a daemon down
                pass


_recorder: Optional[Recorder] = None
_thread: Optional[_Sampler] = None
_install_lock = threading.Lock()


def install(config: Optional[HistoryConfig] = None,
            start: bool = True) -> Recorder:
    """Create (or reconfigure) the process recorder and, when history
    is enabled, make sure its sampler thread runs. Every daemon
    constructor calls this next to ``slo.install()``; idempotent —
    one recorder, one thread, however many daemons share the
    process."""
    global _recorder, _thread
    with _install_lock:
        if _recorder is None:
            _recorder = Recorder(config)
        elif config is not None:
            _recorder.config = config
        if start and on() and (_thread is None
                               or not _thread.is_alive()):
            _thread = _Sampler(_recorder)
            _thread.start()
    return _recorder


def recorder() -> Optional[Recorder]:
    return _recorder


def snapshot(series: Optional[str] = None, since_ms: int = 0,
             res: str = "fast",
             limit: Optional[int] = None) -> Dict[str, Any]:
    """The route-facing snapshot: honest ``enabled: false`` (and no
    samples) when recording is off or no recorder was ever installed —
    the endpoint itself always answers (like the journal's)."""
    rec = _recorder
    if rec is None or not on():
        cfg = rec.config if rec is not None else HistoryConfig.from_env()
        return {
            "enabled": False,
            "res": "slow" if res == "slow" else "fast",
            "tickS": cfg.tick_s,
            "retention": {
                "fast": {"tickS": cfg.tick_s, "slots": cfg.fast_slots},
                "slow": {"tickS": cfg.tick_s * cfg.slow_every,
                         "slots": cfg.slow_slots},
            },
            "seriesTotal": 0,
            "ticksTotal": 0,
            "droppedSeries": 0,
            "kinds": {},
            "samples": [],
        }
    return rec.snapshot(series=series, since_ms=since_ms, res=res,
                        limit=limit)


def reset() -> None:
    """Drop the recorder and stop its thread (tests)."""
    global _recorder, _thread
    with _install_lock:
        if _thread is not None:
            _thread.stop()
        _thread = None
        _recorder = None
