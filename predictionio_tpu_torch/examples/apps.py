"""Event-maintenance apps: cleanup (delete old events) and trim (copy a
window into a fresh app) (port of ``predictionio_tpu/examples/apps.py``,
over the port's storage).

Parity: examples/experimental/scala-cleanup-app (DataSource.scala — count,
delete everything before `cutoffTime`, recount) and
scala-parallel-trim-app (DataSource.scala — copy events in
[startTime, untilTime) from srcApp into an EMPTY dstApp). Both are
engines only in form: the "training" pass performs the maintenance and the
model/serving are vestigial, exactly as in the reference. Run them with
``pio train`` against the target app.
"""

from __future__ import annotations

import datetime as _dt
import logging
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.controller import (
    DataSource, FirstServing, IdentityPreparator, Params, SimpleEngine,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.data.storage import get_storage

logger = logging.getLogger("predictionio_tpu_torch.examples.apps")


@dataclass
class MaintenanceReport:
    """What the maintenance pass did (the reference only logs this)."""
    count_before: int
    affected: int
    count_after: int


@dataclass(frozen=True)
class CleanupDataSourceParams(Params):
    appId: int
    cutoffTime: _dt.datetime       # delete events strictly before this


class CleanupDataSource(DataSource):
    """Count → delete pre-cutoff events → recount
    (scala-cleanup-app DataSource.scala)."""

    params_class = CleanupDataSourceParams

    def __init__(self, params: CleanupDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> MaintenanceReport:
        storage = getattr(ctx, "storage", None) or get_storage()
        events = storage.get_events()
        app_id = self.dsp.appId
        count_before = sum(1 for _ in events.find(app_id=app_id))
        logger.info("Event count before cleanup: %d", count_before)
        to_remove = [e.event_id for e in events.find(
            app_id=app_id, until_time=self.dsp.cutoffTime) if e.event_id]
        for event_id in to_remove:
            events.delete(event_id, app_id)
        count_after = sum(1 for _ in events.find(app_id=app_id))
        logger.info("Event count after cleanup: %d", count_after)
        return MaintenanceReport(count_before, len(to_remove), count_after)


@dataclass(frozen=True)
class TrimDataSourceParams(Params):
    srcAppId: int
    dstAppId: int
    startTime: Optional[_dt.datetime] = None
    untilTime: Optional[_dt.datetime] = None


class TrimDataSource(DataSource):
    """Copy a time window of events src → empty dst
    (scala-parallel-trim-app DataSource.scala). Refuses a non-empty
    destination, like the reference."""

    params_class = TrimDataSourceParams

    def __init__(self, params: TrimDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> MaintenanceReport:
        storage = getattr(ctx, "storage", None) or get_storage()
        events = storage.get_events()
        if next(iter(events.find(app_id=self.dsp.dstAppId, limit=1)), None) \
                is not None:
            raise RuntimeError(
                f"DstApp {self.dsp.dstAppId} is not empty. Quitting.")
        copied = 0
        for e in events.find(app_id=self.dsp.srcAppId,
                             start_time=self.dsp.startTime,
                             until_time=self.dsp.untilTime):
            events.insert(e, self.dsp.dstAppId)
            copied += 1
        logger.info("Copied %d events to appId %d", copied, self.dsp.dstAppId)
        return MaintenanceReport(copied, copied, copied)


class NoOpAlgorithm(Algorithm):
    """The maintenance engines' Algorithm.scala: model is the report."""

    def __init__(self, params=None):
        pass

    def train(self, ctx, pd: MaintenanceReport) -> MaintenanceReport:
        return pd

    def predict(self, model: MaintenanceReport, query) -> MaintenanceReport:
        return model


def cleanup_engine() -> SimpleEngine:
    return SimpleEngine(CleanupDataSource, IdentityPreparator,
                        NoOpAlgorithm, FirstServing)


def trim_engine() -> SimpleEngine:
    return SimpleEngine(TrimDataSource, IdentityPreparator,
                        NoOpAlgorithm, FirstServing)
