"""Process-wide metrics registry + Prometheus text exposition (port of
``predictionio_tpu/common/telemetry.py``; host-only stdlib, so the port
keeps its own copy).

Every daemon and hot path in this framework grew its own ad-hoc counters
(batcher stats in ``GET /``, ``LAYOUT_STATS``, ``degradedCount``, the
event server's hourly rotator); none of them were scrapable by standard
tooling. This module is the single home for all of them: a process-wide
registry of counters, gauges and fixed-bucket histograms with labels,
served as Prometheus text exposition (``GET /metrics``) by every daemon
next to ``/healthz``/``/readyz``.

Design rules, in the order they were traded off:

- **Lock-cheap on the hot path.** Each instrument child owns its own
  tiny lock; an increment is one short critical section over scalar
  updates, never a registry-wide lock (the registry lock is taken only
  when a family or labeled child is first created — the per-endpoint
  ``CircuitBreaker`` registry pattern from :mod:`resilience`).
- **Two tiers of recording.** Instruments that back an EXISTING JSON
  surface (batcher stats, ``degradedCount``, ``LAYOUT_STATS``, the
  event-server rotator) record unconditionally — they are the source of
  truth for byte-compatible legacy shapes. NEW instrumentation sites
  (per-request latency, chunk-decode timings, RPC retries, ...) gate on
  :func:`on` (``PIO_TELEMETRY=1``), so with telemetry off the added hot-
  path cost is one cached-dict env lookup and the wire behavior is
  byte-identical to the pre-telemetry code (asserted by test).
- **Timing honesty**: every timed region fed into a histogram here that
  covers work on the card must end in a real host transfer (the
  ``.cpu()`` copy of a result) somewhere downstream. CUDA launches return
  before the kernel runs, so a region closed before the copy times the
  launch, not the kernel.

Everything is dependency-free stdlib, safe to import from any layer.
"""

from __future__ import annotations

import json
import os
import re
import threading
import weakref
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

#: default latency buckets (seconds) — sub-ms serving through multi-second
#: train phases, mirroring prometheus_client's spread but wider at the top
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

_INF = float("inf")


def on() -> bool:
    """Is optional (new-site) telemetry recording enabled?

    ``PIO_TELEMETRY=1`` turns it on; :func:`set_enabled` overrides for
    tests. One dict lookup — cheap enough to call on every
    request without caching games."""
    if _override is not None:
        return _override
    return os.environ.get("PIO_TELEMETRY", "0") == "1"


_override: Optional[bool] = None


def set_enabled(value: Optional[bool]) -> None:
    """Force telemetry on/off regardless of env (None = back to env)."""
    global _override
    _override = value


# ---------------------------------------------------------------------------
# instruments (children — one per unique label combination)
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically-increasing scalar (floats allowed: accumulated
    seconds are counters too)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, name, labels):
        yield (name, labels, self.value)


class Gauge:
    """Scalar that can go up and down (queue depths, last-seen values)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _samples(self, name, labels):
        yield (name, labels, self.value)


class Histogram:
    """Fixed-bucket latency/size histogram.

    ``buckets`` are upper bounds (``+Inf`` is implicit). ``observe`` is a
    linear scan over a short tuple + two adds under the child lock —
    no allocation, no sorting, hot-path safe.

    Exemplars: ``observe(v, exemplar=trace_id)`` makes the landing
    bucket remember the most recent trace id (+ its value), exposed in
    OpenMetrics exemplar syntax on the ``_bucket`` line — the waterfall
    stage histograms use this so an alert on a bucket leads straight to
    a concrete request in ``/debug/slow.json`` / ``/traces.json``.
    Exemplars ride only the negotiated OpenMetrics exposition; the
    classic 0.0.4 format stays exemplar-free (its parser would read
    one as a timestamp)."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # +1 = the +Inf bucket
        self._sum = 0.0
        self._count = 0
        #: per-bucket (exemplar_id, observed_value) — most recent wins;
        #: stays None (no storage, no exposition) until one is recorded
        self._exemplars: Optional[list] = None

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        v = float(value)
        i = 0
        for b in self.buckets:        # outside the lock: read-only tuple
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (str(exemplar), v)

    def snapshot(self) -> Dict[str, Any]:
        """(cumulative bucket counts keyed by upper bound, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"buckets": dict(zip(list(self.buckets) + [_INF], cum)),
                "sum": s, "count": total}

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _samples(self, name, labels):
        # bucket samples carry a 4th element — the bucket's exemplar
        # (or None); consumers that unpack 3-tuples use `*_` or slices
        snap = self.snapshot()
        with self._lock:
            exemplars = (list(self._exemplars)
                         if self._exemplars is not None else None)
        for i, (ub, c) in enumerate(snap["buckets"].items()):
            le = "+Inf" if ub == _INF else _fmt_number(ub)
            ex = exemplars[i] if exemplars is not None else None
            yield (name + "_bucket", labels + (("le", le),), c, ex)
        yield (name + "_sum", labels, snap["sum"])
        yield (name + "_count", labels, snap["count"])


# ---------------------------------------------------------------------------
# families (one per metric name; children per label combination)
# ---------------------------------------------------------------------------

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

#: Prometheus data-model grammar (https://prometheus.io/docs/concepts/
#: data_model/): a name that violates it silently breaks every scraper
#: downstream, so registration — not scrape time — is where it fails.
_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
#: reserved by the exposition format itself (histogram/summary internals)
_RESERVED_LABELS = frozenset({"le", "quantile"})


def validate_names(name: str, labelnames: Sequence[str]) -> None:
    """Raise ValueError unless metric + label names are legal Prometheus
    identifiers. Called at registration so a typo'd name fails the
    import/construction that introduced it, not a 3am scrape."""
    if not _METRIC_NAME_RE.match(name or ""):
        raise ValueError(
            f"invalid metric name {name!r}: must match "
            "[a-zA-Z_:][a-zA-Z0-9_:]*")
    for ln in labelnames:
        if not _LABEL_NAME_RE.match(ln or ""):
            raise ValueError(
                f"metric {name}: invalid label name {ln!r}: must match "
                "[a-zA-Z_][a-zA-Z0-9_]*")
        if ln.startswith("__"):
            raise ValueError(
                f"metric {name}: label name {ln!r} is reserved "
                "(double-underscore prefix)")
        if ln in _RESERVED_LABELS:
            raise ValueError(
                f"metric {name}: label name {ln!r} is reserved by the "
                "exposition format")


class Family:
    """All children of one metric name, e.g. every labeled series of
    ``pio_rpc_retries_total``."""

    def __init__(self, name: str, help_: str, kind: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = labelnames
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self._buckets or DEFAULT_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **labelvalues: str):
        """The child for this label combination (created on first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)   # racy get: dict reads are safe
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def child(self):
        """The single unlabeled child (labelnames must be empty)."""
        if self.labelnames:
            raise ValueError(f"metric {self.name} requires labels "
                             f"{self.labelnames}")
        return self.labels()

    def samples(self) -> Iterable[Tuple[str, Tuple, float]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            labels = tuple(zip(self.labelnames, key))
            yield from child._samples(self.name, labels)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _openmetrics_meta_line(line: str) -> str:
    """Rewrite a collector-emitted ``# TYPE x_total counter`` line to
    OpenMetrics family naming (collectors emit classic 0.0.4 lines;
    their sample lines already carry the ``_total`` suffix and need no
    change)."""
    if line.startswith("# TYPE ") and line.endswith(" counter"):
        name = line[len("# TYPE "):-len(" counter")]
        if name.endswith("_total"):
            return f"# TYPE {name[:-len('_total')]} counter"
        return f"# TYPE {name} unknown"
    return line


def _fmt_number(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Process-wide instrument registry + Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}
        #: scrape-time collectors: callables yielding raw exposition lines
        #: (used by surfaces whose source of truth must stay windowed,
        #: e.g. the event server's hourly StatsBook). Held weakly when
        #: bound methods so throwaway daemons don't accumulate forever.
        self._collectors: List[Any] = []

    # ------------------------------------------------------------ factories
    def _family(self, name: str, help_: str, kind: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                validate_names(name, labelnames)
                fam = Family(name, help_, kind, tuple(labelnames),
                             buckets=buckets)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}"
                    f"{fam.labelnames}, not {kind}{tuple(labelnames)}")
            return fam

    def counter(self, name: str, help_: str = "",
                labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, help_, "counter", labelnames)

    def gauge(self, name: str, help_: str = "",
              labelnames: Sequence[str] = ()) -> Family:
        return self._family(name, help_, "gauge", labelnames)

    def histogram(self, name: str, help_: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._family(name, help_, "histogram", labelnames,
                            buckets=buckets)

    def register_collector(self, fn: Callable[[], Iterable[str]]) -> None:
        """Register a scrape-time line producer. Bound methods are held
        via weakref so a garbage-collected owner silently drops out.
        Registering the same callable twice is a no-op (daemons that
        share a process — tests, blue/green deploys — all call their
        subsystem's install() and must not duplicate series)."""
        ref: Any
        if hasattr(fn, "__self__"):
            ref = weakref.WeakMethod(fn)
        else:
            ref = fn
        with self._lock:
            for existing in self._collectors:
                if existing == ref or existing is fn:
                    return
            self._collectors.append(ref)

    # ----------------------------------------------------------- exposition
    def exposition(self, openmetrics: bool = False) -> str:
        """The registry as text exposition.

        Default is classic Prometheus text format 0.0.4 with NO exemplar
        suffixes: the 0.0.4 parser reads the token after a sample value
        as a timestamp, so one exemplar would fail the line (and with
        it the scrape). Exemplars are OpenMetrics-only syntax — pass
        ``openmetrics=True`` (negotiated from the scraper's ``Accept``
        header by :func:`handle_route`) to get them, plus the
        ``# EOF`` terminator and OpenMetrics counter-family naming
        (``# TYPE x counter`` with ``x_total`` samples)."""
        out: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
            collectors = list(self._collectors)
        for fam in families:
            meta_name, meta_kind = fam.name, fam.kind
            if openmetrics and fam.kind == "counter":
                # OpenMetrics: a counter family is named WITHOUT the
                # _total sample suffix; a counter that never had one is
                # exposed as `unknown` so strict parsers keep reading
                if fam.name.endswith("_total"):
                    meta_name = fam.name[:-len("_total")]
                else:
                    meta_kind = "unknown"
            if fam.help:
                out.append(f"# HELP {meta_name} {fam.help}")
            out.append(f"# TYPE {meta_name} {meta_kind}")
            for name, labels, value, *rest in fam.samples():
                if labels:
                    lab = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in labels)
                    line = f"{name}{{{lab}}} {_fmt_number(value)}"
                else:
                    line = f"{name} {_fmt_number(value)}"
                if openmetrics and rest and rest[0] is not None:
                    # exemplar: the bucket's most recent trace id +
                    # observed value (waterfall stage histograms)
                    ex_id, ex_v = rest[0]
                    line += (f' # {{trace_id="{_escape_label(ex_id)}"}} '
                             f"{_fmt_number(ex_v)}")
                out.append(line)
        dead = []
        for ref in collectors:
            fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
            if fn is None:
                dead.append(ref)
                continue
            try:
                lines = list(fn())
            except Exception:      # a broken collector must not kill scrapes
                continue
            if openmetrics:
                lines = [_openmetrics_meta_line(ln) for ln in lines]
            out.extend(lines)
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Drop every family and collector (tests)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()


#: the process-wide registry every instrumentation site shares
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


class RegistryDict:
    """dict-like view over one counter family's labeled children — lets a
    legacy module-level stats dict (``LAYOUT_STATS["hits"] += 1``) become
    registry-backed without changing a single call site."""

    def __init__(self, family: Family, labelname: str, keys: Sequence[str]):
        self._children = {k: family.labels(**{labelname: k}) for k in keys}

    def __getitem__(self, key: str) -> int:
        return int(self._children[key].value)

    def __setitem__(self, key: str, value: float) -> None:
        child = self._children[key]
        child.inc(value - child.value)

    def __contains__(self, key: str) -> bool:
        return key in self._children

    def keys(self):
        return self._children.keys()

    def items(self):
        return [(k, int(c.value)) for k, c in self._children.items()]


# ---------------------------------------------------------------------------
# shared daemon routes: GET /metrics and GET /traces.json
# ---------------------------------------------------------------------------

#: Prometheus text exposition content type (classic 0.0.4 — the default)
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: OpenMetrics content type, served only when the scraper's Accept
#: header asks for it — the format that carries the exemplar suffixes
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def accepts_openmetrics(accept: Optional[str]) -> bool:
    """Does this Accept header negotiate OpenMetrics? A plain substring
    check is enough: Prometheus lists ``application/openmetrics-text``
    with a q-value when (and only when) it can parse it; classic 0.0.4
    scrapers never send the token and must never receive exemplars
    (their parser reads the exemplar as a timestamp and fails the
    line)."""
    return "application/openmetrics-text" in (accept or "").lower()


#: /traces.json?limit= ceiling: a scraper typo (limit=1e9) must not ask
#: snapshot() to group more traces than the ring can even hold
_TRACES_LIMIT_DEFAULT = 64
_TRACES_LIMIT_MAX = 1024

#: every /debug/* surface this module serves for the daemons; all four
#: of the port's daemons answer each one
DEBUG_PATHS: Tuple[str, ...] = (
    "/debug/device.json", "/debug/slow.json", "/debug/profile",
    "/debug/events.json", "/debug/history.json")

#: /debug/history.json?limit= bounds: the slow ring holds 1440 slots,
#: so its ceiling is higher than the trace ring's
_HISTORY_LIMIT_DEFAULT = 720
_HISTORY_LIMIT_MAX = 1440


def handle_route(method: str, path: str,
                 query: Optional[Dict[str, str]] = None,
                 accept: Optional[str] = None):
    """Serve ``GET /metrics`` / ``GET /traces.json`` / the ``/debug/*``
    surfaces (``device.json``, ``slow.json``, ``profile``,
    ``events.json``, ``history.json``) for any daemon's route handler;
    returns None when the request is not a telemetry route (the handler
    continues with its own table).
    The read surfaces are unauthenticated by design, like ``/healthz``
    — the payload is operational counters, not data; the one write
    surface (``POST /debug/profile``) confines its effects to the
    operator-configured profile directory and can be disabled outright
    (see :mod:`profiling`).

    ``accept`` is the request's Accept header: a scraper negotiating
    ``application/openmetrics-text`` gets OpenMetrics exposition with
    exemplars; everyone else gets classic 0.0.4 without them.

    /traces.json accepts ``?limit=N`` (bounds-checked: clamped to
    [1, 1024], default 64) and ``?trace_id=<id>`` so `pio doctor` and
    dashboards can do cheap targeted reads instead of dumping the whole
    ring buffer."""
    if path == "/debug/profile":
        # the one non-GET telemetry route: POST starts a bounded
        # on-demand torch.profiler capture, GET lists artifacts
        from predictionio_tpu_torch.common import profiling
        return profiling.handle_route(method, query)
    if method != "GET":
        return None
    if path == "/metrics":
        om = accepts_openmetrics(accept)
        return 200, REGISTRY.exposition(openmetrics=om), {
            "Content-Type": (OPENMETRICS_CONTENT_TYPE if om
                             else EXPOSITION_CONTENT_TYPE)}
    if path == "/debug/events.json":
        # the operational journal (common/journal.py): an incremental
        # tail read — since_seq is the cursor, level is a MINIMUM
        # severity, category narrows to one subsystem
        from predictionio_tpu_torch.common import journal
        since_seq = 0
        category = None
        level = None
        limit = 256
        if query:
            raw = query.get("since_seq")
            if raw:
                try:
                    since_seq = int(raw)
                except ValueError:
                    return 400, {"message": "since_seq must be an "
                                 f"integer, got {raw!r}"}
            raw = query.get("limit")
            if raw:
                try:
                    limit = max(1, min(int(raw), _TRACES_LIMIT_MAX))
                except ValueError:
                    return 400, {"message": "limit must be an integer, "
                                 f"got {raw!r}"}
            level = query.get("level") or None
            if level is not None and level not in journal._SEVERITY:
                return 400, {"message": "level must be one of "
                             f"info/warn/red, got {level!r}"}
            category = query.get("category") or None
        return 200, journal.snapshot(since_seq=since_seq,
                                     category=category, level=level,
                                     limit=limit)
    if path == "/debug/history.json":
        # the metrics flight recorder (common/history.py): bounded
        # in-process time-series rings — series narrows to a comma-
        # separated family list, since_ms is a wall-clock cursor, res
        # picks the fast (per-tick) or slow (downsampled) tier
        from predictionio_tpu_torch.common import history
        series = None
        since_ms = 0
        res = "fast"
        limit = _HISTORY_LIMIT_DEFAULT
        if query:
            series = query.get("series") or None
            raw = query.get("since_ms")
            if raw:
                try:
                    since_ms = int(raw)
                except ValueError:
                    return 400, {"message": "since_ms must be an "
                                 f"integer, got {raw!r}"}
            raw = query.get("res")
            if raw:
                if raw not in ("fast", "slow"):
                    return 400, {"message": "res must be fast or slow, "
                                 f"got {raw!r}"}
                res = raw
            raw = query.get("limit")
            if raw:
                try:
                    limit = max(1, min(int(raw), _HISTORY_LIMIT_MAX))
                except ValueError:
                    return 400, {"message": "limit must be an integer, "
                                 f"got {raw!r}"}
        return 200, history.snapshot(series=series, since_ms=since_ms,
                                     res=res, limit=limit)
    if path == "/debug/slow.json":
        from predictionio_tpu_torch.common import waterfall
        limit = _TRACES_LIMIT_DEFAULT
        if query and query.get("limit"):
            try:
                limit = max(1, min(int(query["limit"]),
                                   _TRACES_LIMIT_MAX))
            except ValueError:
                return 400, {"message": "limit must be an integer, got "
                             f"{query['limit']!r}"}
        return 200, waterfall.slow_snapshot(limit=limit)
    if path == "/traces.json":
        from predictionio_tpu_torch.common import tracing
        limit = _TRACES_LIMIT_DEFAULT
        trace_id = None
        if query:
            raw = query.get("limit")
            if raw is not None and raw != "":
                try:
                    limit = int(raw)
                except ValueError:
                    return 400, {"message":
                                 f"limit must be an integer, got {raw!r}"}
                limit = max(1, min(limit, _TRACES_LIMIT_MAX))
            trace_id = query.get("trace_id") or None
        return 200, tracing.snapshot(limit=limit, trace_id=trace_id)
    if path == "/debug/device.json":
        # human-readable device state (HBM, live tensors, kernel builds,
        # post-warmup watchdog) — pretty-printed for curl eyes; the same
        # numbers ride /metrics for machines
        from predictionio_tpu_torch.common import devicewatch
        return 200, json.dumps(devicewatch.debug_snapshot(), indent=2,
                               sort_keys=True), {
            "Content-Type": "application/json; charset=UTF-8"}
    return None
