"""`pio incident` — assemble one ordered incident timeline for a fleet
(port of ``predictionio_tpu/tools/incident.py``; the same timeline for
the same fetches).

After a page, the evidence is scattered: the journal knows WHAT was
decided (breaker opened, autopilot acted), the metrics flight recorder
knows WHEN the signal moved (QPS collapsed at :41, p99 stepped at :43),
the waterfall ring holds the slowest exemplars, and the trace rings
hold the per-request truth — each behind a different endpoint on each
daemon. This command fuses all four into ONE timeline, oldest first:

    $ pio incident --targets http://q:8000,http://s:7070 --window 10m
    pio incident — 2 target(s), window 600 s
      12:03:41.120 [http://q:8000] STEP   qps fell 84.0 -> 3.2
      12:03:43.355 [http://s:7070] RED    breaker: storage breaker OPEN
      12:03:43.360 [http://q:8000] STEP   p99 rose 2.3 ms -> 48.1 ms
      12:03:44.010 [http://q:8000] SLOW   52.0 ms (mostly predict) trace=ab12...
      12:03:44.011 [http://q:8000] SPAN   query.predict 48.2 ms [engine]
    VERDICT: 2 change-point(s), 1 RED event(s)

Mechanics:

- journal events come through the same ``since_seq`` cursor reads
  `pio events` uses (common/traceview.fetch_events), WARN level up;
- metric change-points are robust step detection — rolling median +
  MAD (the standard outlier scale; Leys et al. 2013) over each
  target's QPS and p99 series derived from its history rings, so a
  step must beat ``k`` MADs AND a relative floor to register (a flat
  series with near-zero MAD must not page on jitter);
- slow exemplars are the waterfall ring's top entries in-window;
- traces referenced by any of the above (or ``--trace``) are fetched
  fleet-wide and skew-corrected (traceview's client/server pairing);
  the per-target skew offsets are then applied to that target's OTHER
  timeline entries too — the clocks in the merged timeline agree with
  the trace's, not each host's NTP mood.

Exit codes, doctor-style: 0 clean window (timeline may still show
info), 1 when the window holds a RED journal event or a metric
change-point, 2 when every target is unreachable.
"""

from __future__ import annotations

import json
import re
import urllib.request
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.common import history
from predictionio_tpu_torch.common.traceview import (
    correct_skew, fetch_events, fetch_trace,
)

#: MADs a point must move to count as a step (≈4 sigma for normal data)
_STEP_K = 4.0
#: ...and at least this fraction of the rolling median (MAD of a flat
#: series is ~0; without a floor every wiggle would page)
_STEP_REL_FLOOR = 0.25
#: trailing points the rolling baseline uses
_STEP_BASELINE = 5
#: traces fetched per incident (referenced ids beyond this are listed,
#: not assembled)
_MAX_TRACES = 3
#: spans rendered per assembled trace
_MAX_SPANS = 12

_WINDOW_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*(s|m|h)?$")


def parse_window(raw: str) -> float:
    """'10m' / '90s' / '1h' / '600' -> seconds."""
    m = _WINDOW_RE.match((raw or "").strip())
    if not m:
        raise ValueError(
            f"--window must look like 10m, 90s or 1h, got {raw!r}")
    n = float(m.group(1))
    return n * {"s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}[m.group(2)]


def _now_ms() -> int:
    return int(datetime.now(timezone.utc).timestamp() * 1000)


def _get_json(base: str, path: str, timeout: float) -> Dict[str, Any]:
    url = base.rstrip("/") + path
    with urllib.request.urlopen(url, timeout=timeout) as r:
        obj = json.loads(r.read().decode("utf-8", "replace"))
    return obj if isinstance(obj, dict) else {}


# ---------------------------------------------------------------------------
# robust step detection (rolling median + MAD)
# ---------------------------------------------------------------------------

def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def change_points(points: Sequence[Tuple[int, float]],
                  k: float = _STEP_K,
                  baseline: int = _STEP_BASELINE,
                  rel_floor: float = _STEP_REL_FLOOR,
                  ) -> List[Dict[str, Any]]:
    """Steps in a ``[(t_ms, value)]`` series: each point is judged
    against the median of the ``baseline`` points before it; it flags
    when it moves more than ``k`` MADs AND ``rel_floor`` of that
    median. Consecutive flagged points coalesce into one change-point
    (a step holds its new level — reporting it once is the point)."""
    out: List[Dict[str, Any]] = []
    in_step = False
    for i in range(baseline, len(points)):
        window = [v for _t, v in points[i - baseline:i]]
        med = _median(window)
        mad = _median([abs(v - med) for v in window])
        scale = max(1.4826 * mad, rel_floor * abs(med), 1e-9)
        t, v = points[i]
        if abs(v - med) > k * scale:
            if not in_step:
                out.append({"t": t, "from": med, "to": v,
                            "direction": "up" if v > med else "down"})
                in_step = True
        else:
            in_step = False
    return out


# ---------------------------------------------------------------------------
# per-target evidence collection
# ---------------------------------------------------------------------------

def _target_steps(base: str, since_ms: int, timeout: float,
                  ) -> List[Dict[str, Any]]:
    """QPS + p99 change-points from one target's history rings."""
    hist = _get_json(
        base, f"/debug/history.json?since_ms={since_ms}", timeout)
    samples = hist.get("samples") or []
    tick_s = float(hist.get("tickS") or 5.0)
    found: List[Dict[str, Any]] = []
    qps = history.count_points(samples, "pio_serve_seconds", tick_s)
    if not qps:
        qps = history.rate_points(
            samples, "pio_http_requests_total", tick_s)
    for cp in change_points(qps):
        found.append({
            "ts_ms": cp["t"], "target": base, "kind": "STEP",
            "detail": (f"qps {'rose' if cp['direction'] == 'up' else 'fell'}"
                       f" {cp['from']:.1f} -> {cp['to']:.1f}")})
    p99 = history.quantile_points(samples, "pio_serve_seconds", 0.99)
    if not p99:
        p99 = history.quantile_points(
            samples, "pio_http_request_seconds", 0.99)
    for cp in change_points(p99):
        found.append({
            "ts_ms": cp["t"], "target": base, "kind": "STEP",
            "detail": (f"p99 {'rose' if cp['direction'] == 'up' else 'fell'}"
                       f" {cp['from'] * 1e3:.1f} ms -> "
                       f"{cp['to'] * 1e3:.1f} ms")})
    return found


def _target_slow(base: str, since_ms: int, timeout: float,
                 ) -> List[Dict[str, Any]]:
    slow = _get_json(base, "/debug/slow.json?limit=5", timeout)
    found: List[Dict[str, Any]] = []
    for req in slow.get("requests") or []:
        at = req.get("at")      # waterfall stamps ISO-8601 wall clock
        try:
            ts_ms = datetime.fromisoformat(at).timestamp() * 1000.0
        except (TypeError, ValueError):
            continue
        if ts_ms < since_ms:
            continue
        stages = req.get("stages") or {}
        top = max(stages.items(), key=lambda kv: kv[1])[0] \
            if stages else "?"
        found.append({
            "ts_ms": int(ts_ms), "target": base, "kind": "SLOW",
            "traceId": req.get("traceId"),
            "detail": (f"{req.get('totalMs')} ms (mostly {top})"
                       + (f" trace={req['traceId']}"
                          if req.get("traceId") else ""))})
    return found


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def assemble(targets: Sequence[str], window_s: float = 600.0,
             trace_id: Optional[str] = None, timeout: float = 5.0,
             now_ms: Optional[int] = None) -> Dict[str, Any]:
    """Collect, fuse and skew-correct — the testable core behind
    ``run_incident``. Returns ``{"entries", "errors", "offsets",
    "reds", "steps", "trace_ids"}`` with entries ordered by corrected
    timestamp."""
    now = _now_ms() if now_ms is None else now_ms
    since_ms = now - int(window_s * 1000)
    entries: List[Dict[str, Any]] = []
    errors: Dict[str, str] = {}
    trace_ids: List[str] = [trace_id] if trace_id else []

    for base in targets:
        alive = False
        try:
            events = fetch_events(base, level="warn", timeout=timeout)
            alive = True
            for e in events:
                ts_ms = float(e.get("ts") or 0.0) * 1000.0
                if ts_ms < since_ms:
                    continue
                if e.get("traceId") and e["traceId"] not in trace_ids:
                    trace_ids.append(e["traceId"])
                entries.append({
                    "ts_ms": int(ts_ms), "target": base,
                    "kind": (e.get("level") or "?").upper(),
                    "traceId": e.get("traceId"),
                    "detail": (f"{e.get('category', '?')}: "
                               f"{e.get('message', '')}"
                               + (f" trace={e['traceId']}"
                                  if e.get("traceId") else ""))})
        except Exception as exc:
            errors[base] = f"{type(exc).__name__}: {exc}"
        for collect in (_target_steps, _target_slow):
            try:
                found = collect(base, since_ms, timeout)
                alive = True
            except Exception as exc:
                errors.setdefault(base, f"{type(exc).__name__}: {exc}")
                continue
            entries.extend(found)
        if alive:
            errors.pop(base, None)

    for e in entries:
        if e.get("traceId") and e["traceId"] not in trace_ids:
            trace_ids.append(e["traceId"])

    # trace assembly: spans join the timeline, and the per-target skew
    # offsets re-time every other entry from the same target
    offsets: Dict[str, float] = {}
    if len(errors) < len(targets):
        for tid in trace_ids[:_MAX_TRACES]:
            spans, _errs, _pinned = fetch_trace(
                targets, tid, timeout=timeout)
            if not spans:
                continue
            trace_offsets = correct_skew(spans)   # applied to startMs
            for t, off in trace_offsets.items():
                offsets.setdefault(t, off)
            spans = sorted(spans, key=lambda s: s["startMs"])
            for s in spans[:_MAX_SPANS]:
                entries.append({
                    "ts_ms": int(s["startMs"]), "target": s["target"],
                    "kind": "SPAN", "traceId": tid, "corrected": True,
                    "detail": (f"{s.get('name', '?')} "
                               f"{s.get('durationMs', 0):.1f} ms "
                               f"[{s.get('service') or '?'}] "
                               f"trace={tid}")})

    for e in entries:
        if not e.pop("corrected", False):   # spans are corrected already
            e["ts_ms"] = int(e["ts_ms"] + offsets.get(e["target"], 0.0))
    entries.sort(key=lambda e: e["ts_ms"])
    return {
        "entries": entries,
        "errors": errors,
        "offsets": offsets,
        "reds": sum(1 for e in entries if e["kind"] == "RED"),
        "steps": sum(1 for e in entries if e["kind"] == "STEP"),
        "trace_ids": trace_ids,
    }


def _fmt_ts(ts_ms: int) -> str:
    dt = datetime.fromtimestamp(ts_ms / 1000.0, tz=timezone.utc)
    return dt.strftime("%H:%M:%S.") + f"{dt.microsecond // 1000:03d}"


def render(result: Dict[str, Any], targets: Sequence[str],
           window_s: float) -> str:
    lines = [f"pio incident — {len(targets)} target(s), "
             f"window {window_s:g} s"]
    for e in result["entries"]:
        lines.append(f"  {_fmt_ts(e['ts_ms'])} [{e['target']}] "
                     f"{e['kind']:<5} {e['detail']}")
    if not result["entries"]:
        lines.append("  (no journal events, change-points or slow "
                     "exemplars in the window)")
    skewed = {t: o for t, o in result["offsets"].items()
              if abs(o) >= 0.5}
    if skewed:
        corr = ", ".join(f"{t}: {o:+.1f} ms"
                         for t, o in sorted(skewed.items()))
        lines.append(f"  (clock-skew corrected via trace pairing: {corr})")
    extra = result["trace_ids"][_MAX_TRACES:]
    if extra:
        lines.append(f"  (+{len(extra)} more referenced trace(s): "
                     + ", ".join(extra) + " — pio trace <id>)")
    for t, err in sorted(result["errors"].items()):
        lines.append(f"  (target {t} unreachable: {err})")
    reds, steps = result["reds"], result["steps"]
    if reds or steps:
        lines.append(f"VERDICT: {steps} change-point(s), "
                     f"{reds} RED event(s)")
    else:
        lines.append("VERDICT: clean window")
    return "\n".join(lines)


def run_incident(targets: Sequence[str], window: str = "10m",
                 trace_id: Optional[str] = None, timeout: float = 5.0,
                 out=None) -> int:
    """`pio incident --targets a,b [--window 10m] [--trace id]`.
    Exit 0 clean / 1 incident evidence found / 2 all unreachable."""
    window_s = parse_window(window)
    result = assemble(targets, window_s=window_s, trace_id=trace_id,
                      timeout=timeout)
    if len(result["errors"]) == len(targets):
        print("pio incident: every target unreachable:", file=out)
        for t, e in sorted(result["errors"].items()):
            print(f"  {t}: {e}", file=out)
        return 2
    print(render(result, targets, window_s), file=out)
    return 1 if (result["reds"] or result["steps"]) else 0
