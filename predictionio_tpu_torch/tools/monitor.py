"""`pio monitor` — one-screen auto-refreshing fleet view (port of
``predictionio_tpu/tools/monitor.py``; the same frames for the same
fetches).

`pio doctor` is the point-in-time verdict; this is the *motion*: one
row per target, re-rendered every few seconds from each daemon's
metrics flight recorder (`/debug/history.json`, common/history.py) and
live gauges (`/metrics`, `GET /`):

    $ pio monitor --targets http://q:8000,http://s:7070
    pio monitor — 2 target(s), refresh 5.0 s (frame 3; Ctrl-C to stop)
      target               qps    p99 ms   err%   burn f/s  state
      http://q:8000       84.0      2.31   0.00   0.0/0.0   ok
      http://s:7070       12.2      0.48   0.00   0.0/0.0   ok

Per row: QPS and p99 derive from the target's OWN rings (histogram
count/bucket deltas over the last fast-ring entries — no client-side
bookkeeping between frames), error rate from 5xx deltas of
``pio_http_requests_total``, burn from the live ``pio_slo_burn_rate``
gauges, and the state column folds in what doctor would flag: open
breakers, fold-in staleness, autopilot holdoff, partition coverage.

Three modes beyond the default refresh loop:

- ``--once``: one frame, exit (scripting; cron'd snapshots).
- ``--record FILE``: append each frame's raw fetches as one JSON line —
  the durable path out of the bounded per-process rings
  (KNOWN_ISSUES #20). A record survives the fleet restarting.
- ``--replay FILE``: re-render a recording frame by frame without
  touching the network (post-incident review on a laptop).

Exit 0 when any target answered (or a replay rendered), 2 when every
target was unreachable on the first frame. Stdlib-only (urllib), like
tools/doctor.py — must run where the daemons are, nothing installed.
"""

from __future__ import annotations

import json
import time
import urllib.request
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.common import history
from predictionio_tpu_torch.tools.doctor import parse_metrics

#: fast-ring entries per frame: enough for a steady p99 (6 ticks = 30 s
#: at the default cadence) without dragging old traffic into "now"
_WINDOW_ENTRIES = 6

#: burn thresholds mirrored from doctor (common/slo.py)
_FAST_BURN_RED = 14.4
_SLOW_BURN_WARN = 6.0


def _now_ms() -> int:
    return int(datetime.now(timezone.utc).timestamp() * 1000)


def _get(base: str, path: str, timeout: float) -> Tuple[Optional[int], str]:
    url = base.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8", "replace")
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


def fetch_target(base: str, timeout: float = 5.0) -> Dict[str, Any]:
    """One target's raw monitor inputs — the shape a --record frame
    stores, so replay re-renders through the same derivation path."""
    out: Dict[str, Any] = {"target": base}
    status, body = _get(
        base, f"/debug/history.json?limit={_WINDOW_ENTRIES}", timeout)
    if status is None:
        out["error"] = body
        return out
    try:
        out["history"] = json.loads(body)
    except ValueError:
        out["history"] = None
    _status, metrics_body = _get(base, "/metrics", timeout)
    out["metrics"] = metrics_body if _status == 200 else ""
    _status, root_body = _get(base, "/", timeout)
    try:
        root = json.loads(root_body) if _status == 200 else {}
        out["root"] = root if isinstance(root, dict) else {}
    except ValueError:
        out["root"] = {}
    return out


# ---------------------------------------------------------------------------
# derivation
# ---------------------------------------------------------------------------

def derive_row(fetched: Dict[str, Any]) -> Dict[str, Any]:
    """One fleet-view row from one target's raw fetches."""
    row: Dict[str, Any] = {"target": fetched.get("target", "?")}
    if fetched.get("error"):
        row["error"] = fetched["error"]
        return row
    hist = fetched.get("history") or {}
    samples = hist.get("samples") or []
    tick_s = float(hist.get("tickS") or 5.0)

    qps_pts = history.count_points(samples, "pio_serve_seconds", tick_s)
    if not qps_pts:      # no engine on this daemon: fall back to HTTP
        qps_pts = history.rate_points(
            samples, "pio_http_requests_total", tick_s)
    row["qps"] = (sum(v for _t, v in qps_pts) / len(qps_pts)
                  if qps_pts else None)

    p99_pts = history.quantile_points(
        samples, "pio_serve_seconds", 0.99, group=len(samples) or 1)
    if not p99_pts:
        p99_pts = history.quantile_points(
            samples, "pio_http_request_seconds", 0.99,
            group=len(samples) or 1)
    row["p99_ms"] = p99_pts[-1][1] * 1e3 if p99_pts else None

    # 5xx fraction over the window, from the status-labeled deltas
    total = err = 0.0
    for e in samples:
        for key, v in (e.get("series") or {}).items():
            if (history.series_family(key) != "pio_http_requests_total"
                    or isinstance(v, dict)):
                continue
            total += v
            if 'status="5' in key:
                err += v
    row["err_pct"] = (err / total * 100.0) if total > 0 else None
    row["history_on"] = bool(hist.get("enabled"))

    metrics = parse_metrics(fetched.get("metrics") or "")
    burns: Dict[str, float] = {}
    for labels, v in metrics.get("pio_slo_burn_rate", []):
        if 'window="fast"' in labels:
            burns["fast"] = max(burns.get("fast", 0.0), v)
        elif 'window="slow"' in labels:
            burns["slow"] = max(burns.get("slow", 0.0), v)
    row["burn_fast"] = burns.get("fast")
    row["burn_slow"] = burns.get("slow")
    row["breakers_open"] = sum(
        1 for _l, v in metrics.get("pio_breaker_open", []) if v >= 1)
    row["foldin_lag"] = max(
        (v for _l, v in metrics.get("pio_foldin_cursor_lag_events", [])),
        default=None)

    root = fetched.get("root") or {}
    flags: List[str] = []
    if row["breakers_open"]:
        flags.append(f"{row['breakers_open']} breaker(s) OPEN")
    if root.get("router"):
        backends = root.get("backends") or []
        in_rot = sum(1 for b in backends if b.get("inRotation"))
        flags.append(f"router {in_rot}/{len(backends)} in rotation")
        parts = root.get("partitions")
        if isinstance(parts, dict) and not parts.get("complete"):
            flags.append("partition COVERAGE GAP")
        if root.get("generationSkew"):
            flags.append("generation SKEW")
    ap = root.get("autopilot")
    if isinstance(ap, dict):
        mode = ap.get("mode", "?")
        flags.append(f"autopilot {mode}"
                     + (" HOLDOFF" if ap.get("holdoff") else ""))
    if row["foldin_lag"] is not None and row["foldin_lag"] > 0:
        flags.append(f"foldin lag {int(row['foldin_lag'])}")
    if not row["history_on"]:
        flags.append("history off")
    row["flags"] = flags
    return row


def _fmt(v: Optional[float], spec: str = ".2f") -> str:
    return "--" if v is None else format(v, spec)


def _state(row: Dict[str, Any]) -> str:
    if row.get("error"):
        return "DEAD"
    bf, bs = row.get("burn_fast"), row.get("burn_slow")
    if ((bf or 0) >= _FAST_BURN_RED and (bs or bf or 0) >= _FAST_BURN_RED) \
            or row.get("breakers_open"):
        return "RED"
    if (bs or 0) >= _SLOW_BURN_WARN or row.get("flags"):
        return "warn"
    return "ok"


def render_frame(rows: Sequence[Dict[str, Any]], frame: int,
                 interval_s: float, replay: bool = False) -> str:
    mode = "replay frame" if replay else "frame"
    lines = [f"pio monitor — {len(rows)} target(s), "
             f"refresh {interval_s:g} s ({mode} {frame})"]
    width = max([len(r["target"]) for r in rows] + [len("target")])
    lines.append(f"  {'target'.ljust(width)}  {'qps':>8}  {'p99 ms':>8}"
                 f"  {'err%':>6}  {'burn f/s':>9}  state")
    for r in rows:
        if r.get("error"):
            lines.append(f"  {r['target'].ljust(width)}  "
                         f"{'--':>8}  {'--':>8}  {'--':>6}  {'--':>9}  "
                         f"DEAD ({r['error']})")
            continue
        burn = (f"{_fmt(r.get('burn_fast'), '.1f')}"
                f"/{_fmt(r.get('burn_slow'), '.1f')}")
        state = _state(r)
        if r.get("flags"):
            state += "  [" + "; ".join(r["flags"]) + "]"
        lines.append(
            f"  {r['target'].ljust(width)}  {_fmt(r.get('qps'), '.1f'):>8}"
            f"  {_fmt(r.get('p99_ms')):>8}  "
            f"{_fmt(r.get('err_pct')):>6}  {burn:>9}  {state}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the loop (+ record / replay)
# ---------------------------------------------------------------------------

def run_monitor(targets: Sequence[str], once: bool = False,
                interval_s: float = 5.0, record: Optional[str] = None,
                replay: Optional[str] = None, timeout: float = 5.0,
                out=None, max_frames: Optional[int] = None) -> int:
    """The `pio monitor` loop. ``max_frames`` bounds the refresh loop
    (tests); ``--once`` is ``max_frames=1``. Exit 0 when any target
    answered (or a replay rendered a frame), 2 when every target was
    unreachable on the first frame / the recording is empty."""
    if replay:
        frames = 0
        with open(replay, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                frames += 1
                rows = [derive_row(f) for f in obj.get("targets") or []]
                print(render_frame(rows, frames, interval_s,
                                   replay=True), file=out)
                print("", file=out)
        if not frames:
            print(f"replay {replay}: no frames recorded", file=out)
            return 2
        return 0

    if once:
        max_frames = 1
    frame = 0
    rec_fh = open(record, "a", encoding="utf-8") if record else None
    try:
        while True:
            frame += 1
            fetched = [fetch_target(t, timeout=timeout) for t in targets]
            if rec_fh is not None:
                rec_fh.write(json.dumps(
                    {"t": _now_ms(), "targets": fetched}) + "\n")
                rec_fh.flush()
            rows = [derive_row(f) for f in fetched]
            print(render_frame(rows, frame, interval_s), file=out)
            if frame == 1 and all(f.get("error") for f in fetched):
                return 2
            if max_frames is not None and frame >= max_frames:
                return 0
            print("", file=out)
            time.sleep(interval_s)
    finally:
        if rec_fh is not None:
            rec_fh.close()
