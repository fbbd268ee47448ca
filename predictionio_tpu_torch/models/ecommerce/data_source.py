"""DataSource: $set users/items + rate events with timestamps (port of
``predictionio_tpu/models/ecommerce/data_source.py``; host Python,
copied).

Parity: scala-parallel-ecommercerecommendation/train-with-rate-event/src/
main/scala/DataSource.scala.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List

from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, Params, SanityCheck,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.models.ecommerce.engine import Item

logger = logging.getLogger("predictionio_tpu_torch.ecommerce")


@dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str


@dataclass(frozen=True)
class RateEvent:
    user: str
    item: str
    rating: float
    t: float


@dataclass
class TrainingData(SanityCheck):
    users: Dict[str, None]
    items: Dict[str, Item]
    rate_events: List[RateEvent]

    def sanity_check(self) -> None:
        if not self.users:
            raise ValueError("users in TrainingData cannot be empty.")
        if not self.items:
            raise ValueError("items in TrainingData cannot be empty.")
        if not self.rate_events:
            raise ValueError("rateEvents in TrainingData cannot be empty.")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        storage = getattr(ctx, "storage", None)
        users = {
            eid: None
            for eid in store.aggregate_properties(
                app_name=self.dsp.appName, entity_type="user",
                storage=storage)}
        items = {
            eid: Item(categories=(
                tuple(pm.get("categories"))
                if pm.get_opt("categories") is not None else None))
            for eid, pm in store.aggregate_properties(
                app_name=self.dsp.appName, entity_type="item",
                storage=storage).items()}
        rate_events = []
        for e in store.find(app_name=self.dsp.appName, entity_type="user",
                            event_names=["rate"],
                            target_entity_type="item", storage=storage):
            try:
                rate_events.append(RateEvent(
                    user=e.entity_id, item=e.target_entity_id,
                    rating=float(e.properties.get("rating")),
                    t=e.event_time.timestamp()))
            except Exception as exc:
                logger.error("Cannot convert %s to RateEvent: %s", e, exc)
                raise
        return TrainingData(users=users, items=items,
                            rate_events=rate_events)
