"""SLO engine: error budgets and burn rates, evaluated at scrape time
(port of ``predictionio_tpu/common/slo.py``; host-only stdlib, so the
port keeps its own copy).

The registry exports raw counters; nothing in them says "you are burning
this month's error budget 20x too fast". This module evaluates two
objectives over the registry (Google-SRE multiwindow burn-rate style,
SRE Workbook ch. 5) and exports the verdict as gauges every scrape:

- **availability** — fraction of HTTP responses that are not 5xx
  (``pio_http_requests_total{service,status}``), target
  ``PIO_SLO_AVAILABILITY`` (default 0.999).
- **latency** — fraction of served queries at or under
  ``PIO_SLO_LATENCY_MS`` (default 25 ms, snapped to a
  ``pio_serve_seconds`` bucket edge at or below it), target
  ``PIO_SLO_LATENCY_TARGET`` (default 0.99).

Exported series (scrape-time collector, same pattern as devicewatch's
device gauges; nothing is emitted until ``PIO_TELEMETRY=1`` — wire
parity):

    pio_slo_target{slo}                    the objective
    pio_slo_error_budget_remaining{slo}    1 = untouched, 0 = spent,
                                           negative = overspent
                                           (process-lifetime window)
    pio_slo_burn_rate{slo,window}          error rate / allowed error
                                           rate over the fast
                                           (PIO_SLO_FAST_WINDOW_S, 300)
                                           and slow
                                           (PIO_SLO_SLOW_WINDOW_S, 3600)
                                           windows; 1.0 = exactly on
                                           budget

Burn thresholds follow the SRE Workbook pages: fast-window burn >= 14.4
is the page (the reference's `pio doctor` goes RED), slow-window burn >= 6 is the
ticket (WARN). Windowed rates come from a bounded ring of snapshots
(:class:`history.SnapshotRing` — the metrics flight recorder owns the
bookkeeping and its sampler thread feeds the rings between scrapes, one
snapshotter per process): the engine records (monotonic time, good,
total) per objective and differences against the snapshot just outside
the window, so any scraper cadence works and an idle window burns 0.

Targets come from ``ServerConfig`` (``pio deploy --slo-availability /
--slo-latency-ms``) or the env; the engine is process-wide like the
registry it reads.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.common import history, telemetry

#: SRE Workbook multiwindow thresholds: page on fast burn, ticket on slow
FAST_BURN_RED = 14.4
SLOW_BURN_WARN = 6.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Objective targets + burn windows (env-defaulted; ServerConfig
    overrides ride through :func:`install`)."""
    availability: float = 0.999
    latency_ms: float = 25.0
    latency_target: float = 0.99
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0

    @classmethod
    def from_env(cls, availability: Optional[float] = None,
                 latency_ms: Optional[float] = None,
                 latency_target: Optional[float] = None) -> "SLOConfig":
        return cls(
            availability=(availability if availability is not None
                          else _env_float("PIO_SLO_AVAILABILITY", 0.999)),
            latency_ms=(latency_ms if latency_ms is not None
                        else _env_float("PIO_SLO_LATENCY_MS", 25.0)),
            latency_target=(latency_target if latency_target is not None
                            else _env_float("PIO_SLO_LATENCY_TARGET", 0.99)),
            fast_window_s=_env_float("PIO_SLO_FAST_WINDOW_S", 300.0),
            slow_window_s=_env_float("PIO_SLO_SLOW_WINDOW_S", 3600.0),
        )


# ---------------------------------------------------------------------------
# registry readers (cumulative good/total per objective)
# ---------------------------------------------------------------------------

def _availability_counts() -> Tuple[float, float]:
    """(good, total) across every daemon in this process: non-5xx
    responses over all responses."""
    reg = telemetry.registry()
    with reg._lock:
        fam = reg._families.get("pio_http_requests_total")
    if fam is None:
        return 0.0, 0.0
    good = total = 0.0
    for name, labels, value, *_ in fam.samples():
        if name != "pio_http_requests_total":
            continue
        status = dict(labels).get("status", "")
        total += value
        if not status.startswith("5"):
            good += value
    return good, total


def _latency_counts(threshold_s: float) -> Tuple[float, float]:
    """(good, total) from the pio_serve_seconds histogram: good = served
    at or under the largest bucket edge <= threshold (cumulative bucket
    counts sum safely across label sets)."""
    reg = telemetry.registry()
    with reg._lock:
        fam = reg._families.get("pio_serve_seconds")
    if fam is None or fam.kind != "histogram":
        return 0.0, 0.0
    with fam._lock:
        children = list(fam._children.values())
    good = total = 0.0
    for child in children:
        snap = child.snapshot()
        total += snap["count"]
        under = 0.0
        for ub, cum in snap["buckets"].items():
            if ub <= threshold_s:
                under = max(under, cum)
        good += under
    return good, total


def _latency_counts_by_tenant(
        threshold_s: float) -> Dict[str, Tuple[float, float]]:
    """Per-tenant (good, total) from the pio_serve_seconds histogram's
    ``tenant`` label. Empty when the family is absent or predates the
    tenant label (a fresh test registry) — callers emit nothing then."""
    reg = telemetry.registry()
    with reg._lock:
        fam = reg._families.get("pio_serve_seconds")
    if (fam is None or fam.kind != "histogram"
            or "tenant" not in fam.labelnames):
        return {}
    idx = fam.labelnames.index("tenant")
    with fam._lock:
        items = list(fam._children.items())
    out: Dict[str, Tuple[float, float]] = {}
    for key, child in items:
        tenant = key[idx]
        snap = child.snapshot()
        under = 0.0
        for ub, cum in snap["buckets"].items():
            if ub <= threshold_s:
                under = max(under, cum)
        good, total = out.get(tenant, (0.0, 0.0))
        out[tenant] = (good + under, total + snap["count"])
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class SLOEngine:
    """Evaluates the objectives against the registry; keeps a bounded
    snapshot history for the windowed burn rates."""

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig.from_env()
        self._lock = threading.Lock()
        #: per-objective snapshot ring of (monotonic_s, good, total) —
        #: the bookkeeping lives in history.SnapshotRing so the metrics
        #: flight recorder's sampler thread (one snapshotter per
        #: process) keeps these warm between scrapes via
        #: :meth:`record_snapshot`; the differencing math is unchanged
        self._history: Dict[str, history.SnapshotRing] = {
            "availability": history.SnapshotRing(maxlen=4096),
            "latency": history.SnapshotRing(maxlen=4096),
        }
        #: (slo, window) -> currently over its burn threshold; edge
        #: transitions (not levels) land in the operational journal
        self._hot: Dict[Tuple[str, str], bool] = {}

    # -------------------------------------------------------------- windows
    def record_snapshot(self, now: Optional[float] = None) -> None:
        """Append one (t, good, total) snapshot per objective WITHOUT
        evaluating burn or journaling — the history sampler's per-tick
        feed. Scrape-time :meth:`evaluate` gets real window bases even
        when nothing scraped for an hour."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        counts = {
            "availability": _availability_counts(),
            "latency": _latency_counts(cfg.latency_ms / 1e3),
        }
        with self._lock:
            for slo, (good, total) in counts.items():
                ring = self._history[slo]
                ring.append(now, good, total)
                ring.prune(now, cfg.slow_window_s)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate both objectives, append the snapshot, and return
        {slo: {target, good, total, budget_remaining,
        burn_fast, burn_slow}}."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        counts = {
            "availability": (_availability_counts(), cfg.availability),
            "latency": (_latency_counts(cfg.latency_ms / 1e3),
                        cfg.latency_target),
        }
        out: Dict[str, Any] = {}
        with self._lock:
            for slo, ((good, total), target) in counts.items():
                ring = self._history[slo]
                allowed = max(1.0 - target, 1e-9)
                bad_ratio = ((total - good) / total) if total > 0 else 0.0
                fast = ring.window_rate(now, good, total,
                                        cfg.fast_window_s) / allowed
                slow = ring.window_rate(now, good, total,
                                        cfg.slow_window_s) / allowed
                ring.append(now, good, total)
                # prune entries older than the slow window (plus one
                # kept just outside it as the differencing base)
                ring.prune(now, cfg.slow_window_s)
                out[slo] = {
                    "target": target,
                    "good": good,
                    "total": total,
                    "budget_remaining": 1.0 - bad_ratio / allowed,
                    "burn_fast": fast,
                    "burn_slow": slow,
                }
        self._note_crossings(out)
        return out

    def _note_crossings(self, verdict: Dict[str, Any]) -> None:
        """Journal burn-rate THRESHOLD CROSSINGS (SRE Workbook tiers:
        fast >= 14.4x pages -> red, slow >= 6x tickets -> warn) — edges
        only, so a sustained burn is one event, not one per scrape, and
        the recovery is recorded too. Runs outside the snapshot lock
        (the journal takes its own)."""
        from predictionio_tpu_torch.common import journal
        tiers = (("fast", FAST_BURN_RED, journal.RED),
                 ("slow", SLOW_BURN_WARN, journal.WARN))
        for slo, v in verdict.items():
            for window, threshold, level in tiers:
                burn = v["burn_" + window]
                hot = burn >= threshold
                key = (slo, window)
                was = self._hot.get(key, False)
                if hot == was:
                    continue
                self._hot[key] = hot
                if hot:
                    journal.emit(
                        "slo",
                        f"{slo} burn rate {burn:.1f}x over the {window} "
                        f"window (threshold {threshold:g}x)",
                        level=level, slo=slo, window=window,
                        burn=round(burn, 2), threshold=threshold)
                else:
                    journal.emit(
                        "slo",
                        f"{slo} {window}-window burn subsided "
                        f"({burn:.1f}x, below {threshold:g}x)",
                        level=journal.INFO, slo=slo, window=window,
                        burn=round(burn, 2), threshold=threshold)

    # ------------------------------------------------------------ collector
    def collect(self) -> Iterable[str]:
        """Scrape-time exposition lines (registered on the registry like
        devicewatch's device gauges). Emits nothing until telemetry is
        on — no new series by default, wire parity."""
        if not telemetry.on():
            return []
        verdict = self.evaluate()
        lines: List[str] = [
            "# TYPE pio_slo_target gauge",
            "# TYPE pio_slo_error_budget_remaining gauge",
            "# TYPE pio_slo_burn_rate gauge",
            f"pio_slo_latency_threshold_ms {self.config.latency_ms:g}",
        ]
        for slo, v in sorted(verdict.items()):
            lines.append(f'pio_slo_target{{slo="{slo}"}} {v["target"]:g}')
            lines.append(
                f'pio_slo_error_budget_remaining{{slo="{slo}"}} '
                f'{v["budget_remaining"]:.6g}')
            for window in ("fast", "slow"):
                lines.append(
                    f'pio_slo_burn_rate{{slo="{slo}",window="{window}"}} '
                    f'{v["burn_" + window]:.6g}')
        # Per-tenant latency budgets (multi-tenant deploys only: a
        # lone "default" tenant is the legacy path, whose scrape body
        # must not grow). Lifetime-window, stateless — the windowed
        # burn history stays per-objective, not per-tenant.
        by_tenant = _latency_counts_by_tenant(self.config.latency_ms / 1e3)
        if any(t != "default" for t in by_tenant):
            allowed = max(1.0 - self.config.latency_target, 1e-9)
            lines.append(
                "# TYPE pio_slo_tenant_latency_budget_remaining gauge")
            for tenant in sorted(by_tenant):
                good, total = by_tenant[tenant]
                bad_ratio = ((total - good) / total) if total > 0 else 0.0
                lines.append(
                    f'pio_slo_tenant_latency_budget_remaining'
                    f'{{tenant="{tenant}"}} '
                    f'{1.0 - bad_ratio / allowed:.6g}')
        return lines


_engine: Optional[SLOEngine] = None
_install_lock = threading.Lock()


def install(config: Optional[SLOConfig] = None) -> SLOEngine:
    """Create (or reconfigure) the process SLO engine and register its
    collector. Every daemon constructor calls this next to
    devicewatch.install(); an explicit config (the query server's
    ServerConfig targets) wins over a default env install — the query
    daemon is the one whose SLOs the operator configured."""
    global _engine
    with _install_lock:
        if _engine is None:
            _engine = SLOEngine(config)
        elif config is not None:
            _engine.config = config
    telemetry.registry().register_collector(_engine.collect)
    return _engine


def engine() -> Optional[SLOEngine]:
    return _engine


def reset() -> None:
    """Drop the engine (tests); the next install() starts fresh."""
    global _engine
    with _install_lock:
        _engine = None
