"""Ingestion stats bookkeeping (the port's copy of
``predictionio_tpu/data/api/stats.py``).

Reference: data/.../api/Stats.scala:51-81 and StatsActor.scala:36-79 —
per-(appId, statusCode) and per-(appId, entityType/targetEntityType/event)
counters with an hourly cutoff: the actor keeps the current hour's Stats
plus the previous hour's, and /stats.json serves the previous full hour
when available.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import defaultdict
from typing import Any, Dict, Optional

from predictionio_tpu_torch.common import telemetry
from predictionio_tpu_torch.common.telemetry import _escape_label
from predictionio_tpu_torch.data.event import Event, format_event_time, utcnow


class Stats:
    """One accounting window (Stats.scala:51-81)."""

    def __init__(self, start_time: Optional[_dt.datetime] = None):
        self.start_time = start_time or utcnow()
        self.end_time: Optional[_dt.datetime] = None
        self.status_code_count: Dict[tuple, int] = defaultdict(int)
        self.ete_count: Dict[tuple, int] = defaultdict(int)

    def cutoff(self, end_time: _dt.datetime) -> None:
        self.end_time = end_time

    def update(self, app_id: int, status_code: int, event: Event) -> None:
        self.status_code_count[(app_id, status_code)] += 1
        key = (app_id, event.entity_type, event.target_entity_type, event.event)
        self.ete_count[key] += 1

    def get(self, app_id: int) -> Dict[str, Any]:
        """StatsSnapshot for one app, in the reference's KV JSON shape."""
        return {
            "startTime": format_event_time(self.start_time),
            "endTime": (format_event_time(self.end_time)
                        if self.end_time else None),
            "basic": [
                {"key": {"entityType": et, "targetEntityType": tet,
                         "event": ev}, "value": n}
                for (aid, et, tet, ev), n in sorted(self.ete_count.items())
                if aid == app_id],
            "statusCode": [
                {"key": code, "value": n}
                for (aid, code), n in sorted(self.status_code_count.items())
                if aid == app_id],
        }


def _hour_floor(t: _dt.datetime) -> _dt.datetime:
    return t.replace(minute=0, second=0, microsecond=0)


class StatsBook:
    """Hourly-rotating stats (StatsActor.scala:45-79), thread-safe.

    The book registers itself as a scrape-time collector with the
    process metrics registry (common/telemetry.py): ``GET /metrics``
    exposes the long-lived counters as ``pio_events_requests_total`` /
    ``pio_events_ingested_total`` while the hourly rotation stays here,
    so ``/stats.json`` keeps its shape. The registry holds the book
    weakly."""

    def __init__(self):
        self._lock = threading.Lock()
        self.longlive = Stats()
        self.hourly = Stats(_hour_floor(utcnow()))
        self.prev_hourly: Optional[Stats] = None
        telemetry.registry().register_collector(self.collect_metrics)

    def collect_metrics(self):
        """Prometheus exposition lines for the long-lived window."""
        with self._lock:
            status = dict(self.longlive.status_code_count)
            ete = dict(self.longlive.ete_count)
        if not status and not ete:
            return []     # idle books add no scrape noise
        out = ["# TYPE pio_events_requests_total counter"]
        for (app_id, code), n in sorted(status.items()):
            out.append(
                f'pio_events_requests_total{{app_id="{app_id}",'
                f'status="{code}"}} {n}')
        out.append("# TYPE pio_events_ingested_total counter")
        for (app_id, et, tet, ev), n in sorted(
                ete.items(), key=lambda kv: str(kv[0])):
            out.append(
                f'pio_events_ingested_total{{app_id="{app_id}",'
                f'entity_type="{_escape_label(et or "")}",'
                f'target_entity_type="{_escape_label(tet or "")}",'
                f'event="{_escape_label(ev or "")}"}} {n}')
        return out

    def bookkeeping(self, app_id: int, status_code: int, event: Event) -> None:
        with self._lock:
            now = utcnow()
            hour = _hour_floor(now)
            if hour > self.hourly.start_time:
                self.hourly.cutoff(hour)
                self.prev_hourly = self.hourly
                self.hourly = Stats(hour)
            self.longlive.update(app_id, status_code, event)
            self.hourly.update(app_id, status_code, event)

    def get(self, app_id: int) -> Dict[str, Any]:
        with self._lock:
            prev = self.prev_hourly.get(app_id) if self.prev_hourly else (
                Stats(_hour_floor(utcnow())).get(app_id))
            return {
                "comment": "This is a snapshot of last system startup time.",
                "startTime": format_event_time(self.longlive.start_time),
                "currentHour": self.hourly.get(app_id),
                "prevHour": prev,
                "longLive": self.longlive.get(app_id),
            }
