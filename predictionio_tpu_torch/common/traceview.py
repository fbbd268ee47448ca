"""Fleet trace assembly + journal tailing: `pio trace` / `pio events`
(port of ``predictionio_tpu/common/traceview.py``; stdlib only, the same
rendered text for the same payloads).

``common/tracing.py`` records Dapper-style spans per PROCESS; the join
Dapper (Sigelman et al., 2010) calls out as the whole point — one
request's spans from every daemon it touched, assembled into a single
tree — happened in the reader's head until now. This module does the
join:

- :func:`fetch_trace` fans a trace id out to N daemons'
  ``/traces.json?trace_id=`` and collects every span (deduplicating by
  span id — daemons sharing a process share a ring);
- :func:`correct_skew` aligns each process's wall clock to the root's
  using client/server span pairs: a server span's parent is the
  client's RPC span, and absent a synchronized clock the best estimate
  centers the server span inside its parent (the classic
  half-round-trip correction), propagated BFS across processes;
- :func:`render_tree` draws the assembled tree as an ASCII waterfall —
  parent/child indentation plus a time-scaled bar per span.

``pio events`` is the journal counterpart: merge-tail N daemons'
``/debug/events.json`` by wall timestamp, with per-target ``since_seq``
cursors so ``--follow`` polls are incremental reads.

Stdlib-only (urllib), like tools/doctor.py — the CLI must run where the
daemons are, with nothing installed.
"""

from __future__ import annotations

import datetime as _dt
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: bar width of the waterfall column
_BAR_WIDTH = 32


def _get_json(url: str, timeout: float) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8", "replace"))


# ---------------------------------------------------------------------------
# fan-out + join
# ---------------------------------------------------------------------------

def fetch_trace(targets: Sequence[str], trace_id: str,
                timeout: float = 5.0
                ) -> Tuple[List[Dict[str, Any]], Dict[str, str],
                           List[str]]:
    """-> (spans, errors_by_target, pin_reasons). Each span dict is the
    wire shape (spanId/parentId/name/service/startMs/durationMs) plus
    ``target`` — the daemon that held it. Spans seen on several targets
    (daemons sharing one process share one ring) keep their first
    target. ``errors_by_target`` records unreachable/failed targets so
    a partial assembly says which half of the fleet is missing."""
    spans: List[Dict[str, Any]] = []
    seen: set = set()
    errors: Dict[str, str] = {}
    pinned: List[str] = []
    for target in targets:
        base = target.rstrip("/")
        url = f"{base}/traces.json?trace_id={trace_id}"
        try:
            obj = _get_json(url, timeout)
        except Exception as e:
            errors[target] = f"{type(e).__name__}: {e}"
            continue
        for trace in obj.get("traces") or []:
            if trace.get("traceId") != trace_id:
                continue
            for reason in trace.get("pinned") or []:
                if reason not in pinned:
                    pinned.append(reason)
            for s in trace.get("spans") or []:
                sid = s.get("spanId")
                if sid in seen:
                    continue
                seen.add(sid)
                spans.append({**s, "target": target})
    return spans, errors, pinned


def correct_skew(spans: List[Dict[str, Any]]) -> Dict[str, float]:
    """Per-target clock-skew correction, applied IN PLACE to startMs.

    Each cross-process parent/child span pair (child's parentId names a
    span held by another target) yields one skew estimate: without a
    shared clock, the best placement of a server span is centered
    inside its client parent — ``parent.start + (parent.dur -
    child.dur)/2`` — so the estimated offset for the child's process is
    that ideal start minus the observed one. Estimates per target pair
    are averaged, then propagated breadth-first from the root span's
    target (offset 0), so a 3-deep fleet (query -> storage -> ...)
    chains corrections. Returns {target: applied_offset_ms}."""
    by_id = {s["spanId"]: s for s in spans}
    targets = {s["target"] for s in spans}
    if len(targets) <= 1:
        return {t: 0.0 for t in targets}
    # per (parent_target, child_target): list of offset estimates where
    # offset = desired_child_start_in_parent_clock - observed_child_start
    edges: Dict[Tuple[str, str], List[float]] = {}
    for s in spans:
        parent = by_id.get(s.get("parentId") or "")
        if parent is None or parent["target"] == s["target"]:
            continue
        desired = (parent["startMs"]
                   + (parent["durationMs"] - s["durationMs"]) / 2.0)
        edges.setdefault((parent["target"], s["target"]), []).append(
            desired - s["startMs"])
    # root target: the process holding the root span (no parent in set)
    roots = [s for s in spans
             if not s.get("parentId") or s["parentId"] not in by_id]
    root_target = (min(roots, key=lambda s: s["startMs"])["target"]
                   if roots else sorted(targets)[0])
    offsets: Dict[str, float] = {root_target: 0.0}
    frontier = [root_target]
    while frontier:
        nxt: List[str] = []
        for src in frontier:
            for (a, b), estimates in edges.items():
                if a == src and b not in offsets:
                    offsets[b] = (offsets[a]
                                  + sum(estimates) / len(estimates))
                    nxt.append(b)
                elif b == src and a not in offsets:
                    offsets[a] = (offsets[b]
                                  - sum(estimates) / len(estimates))
                    nxt.append(a)
        frontier = nxt
    for t in targets:       # unreachable via any span pair: leave as-is
        offsets.setdefault(t, 0.0)
    for s in spans:
        s["startMs"] = s["startMs"] + offsets[s["target"]]
    return offsets


# ---------------------------------------------------------------------------
# tree rendering
# ---------------------------------------------------------------------------

def _children_index(spans: List[Dict[str, Any]]
                    ) -> Tuple[List[Dict[str, Any]],
                               Dict[str, List[Dict[str, Any]]]]:
    by_id = {s["spanId"]: s for s in spans}
    roots: List[Dict[str, Any]] = []
    children: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        pid = s.get("parentId")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    for lst in children.values():
        lst.sort(key=lambda s: s["startMs"])
    roots.sort(key=lambda s: s["startMs"])
    return roots, children


def _bar(start: float, dur: float, t0: float, total: float) -> str:
    if total <= 0:
        return "|" + "#" * _BAR_WIDTH + "|"
    lead = int(round((start - t0) / total * _BAR_WIDTH))
    lead = max(0, min(_BAR_WIDTH - 1, lead))
    width = int(round(dur / total * _BAR_WIDTH))
    width = max(1, min(_BAR_WIDTH - lead, width))
    return ("|" + " " * lead + "#" * width
            + " " * (_BAR_WIDTH - lead - width) + "|")


def render_tree(trace_id: str, spans: List[Dict[str, Any]],
                pinned: Optional[List[str]] = None) -> str:
    """The assembled trace as an ASCII waterfall tree: one line per
    span — duration, tree-indented name, service, and a bar placed on
    the trace's [first start, last end] window."""
    if not spans:
        return f"trace {trace_id}: no spans"
    roots, children = _children_index(spans)
    t0 = min(s["startMs"] for s in spans)
    t1 = max(s["startMs"] + s["durationMs"] for s in spans)
    total = t1 - t0
    services = sorted({s["service"] or "?" for s in spans})
    targets = sorted({s["target"] for s in spans})
    head = (f"trace {trace_id} — {len(spans)} span(s), "
            f"{len(services)} service(s) over {len(targets)} target(s), "
            f"{total:.2f} ms")
    if pinned:
        head += f" [pinned: {', '.join(pinned)}]"
    lines = [head]
    label_width = max(
        len(_label(s, depth)) for depth, s in _walk(roots, children, 0))
    svc_width = max(len(s["service"] or "?") for s in spans)
    for depth, s in _walk(roots, children, 0):
        label = _label(s, depth)
        svc = (s["service"] or "?").ljust(svc_width)
        lines.append(
            f"  {s['durationMs']:>9.2f} ms  {label.ljust(label_width)}"
            f"  [{svc}]  "
            f"{_bar(s['startMs'], s['durationMs'], t0, total)}")
    return "\n".join(lines)


def _label(s: Dict[str, Any], depth: int) -> str:
    prefix = "" if depth == 0 else "  " * (depth - 1) + "+- "
    return prefix + s["name"]


def _walk(roots, children, depth):
    for s in roots:
        yield depth, s
        yield from _walk(children.get(s["spanId"], []), children,
                         depth + 1)


def run_trace(trace_id: str, targets: Sequence[str],
              timeout: float = 5.0, out=None) -> int:
    """`pio trace <id> --targets a,b`: fetch, skew-correct, render.
    Exit 0 assembled / 1 trace not found anywhere / 2 every target
    unreachable."""
    spans, errors, pinned = fetch_trace(targets, trace_id,
                                        timeout=timeout)
    if errors and len(errors) == len(targets):
        print(f"trace {trace_id}: every target unreachable:", file=out)
        for t, e in errors.items():
            print(f"  {t}: {e}", file=out)
        return 2
    if not spans:
        print(f"trace {trace_id}: not found on {len(targets)} "
              "target(s) (evicted from every ring, never recorded, or "
              "tracing off — PIO_TRACE=1 / X-PIO-Trace originate it; "
              "slow/error/journal traces stay pinned via "
              "PIO_TRACE_TAIL_MS)", file=out)
        return 1
    offsets = correct_skew(spans)
    print(render_tree(trace_id, spans, pinned), file=out)
    skewed = {t: o for t, o in offsets.items() if abs(o) >= 0.5}
    if skewed:
        corr = ", ".join(f"{t}: {o:+.1f} ms"
                         for t, o in sorted(skewed.items()))
        print(f"  (clock-skew corrected: {corr})", file=out)
    for t, e in sorted(errors.items()):
        print(f"  (target {t} unreachable: {e})", file=out)
    return 0


# ---------------------------------------------------------------------------
# `pio events` — fleet journal merge-tail
# ---------------------------------------------------------------------------

def fetch_events(target: str, since_seq: int = 0,
                 category: Optional[str] = None,
                 level: Optional[str] = None,
                 timeout: float = 5.0,
                 limit: int = 512) -> List[Dict[str, Any]]:
    """One target's journal tail (seq > since_seq), each event annotated
    with its target. Raises on transport errors — the caller decides
    whether a dead daemon fails the read or just thins the merge."""
    base = target.rstrip("/")
    qs = f"since_seq={int(since_seq)}&limit={int(limit)}"
    if category:
        qs += f"&category={category}"
    if level:
        qs += f"&level={level}"
    obj = _get_json(f"{base}/debug/events.json?{qs}", timeout)
    return [{**e, "target": target} for e in obj.get("events") or []]


def _fmt_event(e: Dict[str, Any]) -> str:
    fields = e.get("fields") or {}
    detail = " ".join(f"{k}={v}" for k, v in fields.items())
    line = (f"{e.get('at', '?'):<29} {e.get('level', '?').upper():<4} "
            f"[{e.get('target', '?')}] "
            f"{e.get('category', '?')}: {e.get('message', '')}")
    if detail:
        line += f"  ({detail})"
    if e.get("traceId"):
        line += f"  trace={e['traceId']}"
    return line


def run_events(targets: Sequence[str], since_seq: int = 0,
               category: Optional[str] = None,
               level: Optional[str] = None,
               follow: bool = False, interval_s: float = 2.0,
               timeout: float = 5.0, out=None,
               max_polls: Optional[int] = None) -> int:
    """`pio events --targets a,b [--follow] [--since-seq N]`: merge the
    fleet's journals by wall timestamp, oldest first. ``--follow``
    re-polls with per-target seq cursors (each poll is an incremental
    ``since_seq`` read). Exit 0 when any target answered, 2 when every
    target was unreachable on the first poll. ``max_polls`` bounds the
    follow loop (tests)."""
    cursors: Dict[str, int] = {t: int(since_seq) for t in targets}
    polls = 0
    any_answered = False
    while True:
        polls += 1
        merged: List[Dict[str, Any]] = []
        errors: Dict[str, str] = {}
        for t in targets:
            try:
                events = fetch_events(
                    t, since_seq=cursors[t], category=category,
                    level=level, timeout=timeout)
            except Exception as e:
                errors[t] = f"{type(e).__name__}: {e}"
                continue
            any_answered = True
            if events:
                cursors[t] = max(e["seq"] for e in events)
            merged.extend(events)
        merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
        for e in merged:
            print(_fmt_event(e), file=out)
        if polls == 1 and not any_answered:
            for t, err in errors.items():
                print(f"  {t}: {err}", file=out)
            return 2
        if not follow or (max_polls is not None and polls >= max_polls):
            return 0
        time.sleep(interval_s)


def age_str(ts: float, now: Optional[float] = None) -> str:
    """Compact event age ('41s', '7m', '3h') for the doctor line."""
    if now is None:
        now = _dt.datetime.now(_dt.timezone.utc).timestamp()
    age = max(0.0, now - ts)
    if age < 60:
        return f"{age:.0f}s"
    if age < 3600:
        return f"{age / 60:.0f}m"
    return f"{age / 3600:.1f}h"
