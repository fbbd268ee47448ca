"""DataSource: $set users/items + view + like/dislike events (port of
``predictionio_tpu/models/similarproduct/data_source.py``; host Python,
copied).

Parity: scala-parallel-similarproduct/multi/src/main/scala/DataSource.scala
— aggregated user/item entities (item carries optional `categories`), view
events (user -> item), like/dislike events with timestamps.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, Params, SanityCheck,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.models.similarproduct.engine import Item

logger = logging.getLogger("predictionio_tpu_torch.similarproduct")


@dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str


@dataclass(frozen=True)
class ViewEvent:
    user: str
    item: str
    t: float


@dataclass(frozen=True)
class LikeEvent:
    user: str
    item: str
    t: float
    like: bool


@dataclass
class TrainingData(SanityCheck):
    users: Dict[str, None]
    items: Dict[str, Item]
    view_events: List[ViewEvent]
    like_events: List[LikeEvent] = field(default_factory=list)

    def sanity_check(self) -> None:
        if not self.users:
            raise ValueError("users in TrainingData cannot be empty.")
        if not self.items:
            raise ValueError("items in TrainingData cannot be empty.")
        if not self.view_events and not self.like_events:
            raise ValueError(
                "view/like events in TrainingData cannot be empty.")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        storage = getattr(ctx, "storage", None)
        users = {
            entity_id: None
            for entity_id in store.aggregate_properties(
                app_name=self.dsp.appName, entity_type="user",
                storage=storage)}
        items = {
            entity_id: Item(categories=(
                tuple(pm.get("categories"))
                if pm.get_opt("categories") is not None else None))
            for entity_id, pm in store.aggregate_properties(
                app_name=self.dsp.appName, entity_type="item",
                storage=storage).items()}

        view_events = []
        for e in store.find(app_name=self.dsp.appName, entity_type="user",
                            event_names=["view"], storage=storage):
            if e.target_entity_id is None:
                logger.error("Cannot convert %s to ViewEvent.", e)
                raise ValueError(f"view event {e.event_id} has no target")
            view_events.append(ViewEvent(
                user=e.entity_id, item=e.target_entity_id,
                t=e.event_time.timestamp()))

        like_events = []
        for e in store.find(app_name=self.dsp.appName, entity_type="user",
                            event_names=["like", "dislike"],
                            storage=storage):
            if e.target_entity_id is None:
                logger.error("Cannot convert %s to LikeEvent.", e)
                raise ValueError(f"like event {e.event_id} has no target")
            like_events.append(LikeEvent(
                user=e.entity_id, item=e.target_entity_id,
                t=e.event_time.timestamp(), like=(e.event == "like")))

        return TrainingData(users=users, items=items,
                            view_events=view_events,
                            like_events=like_events)
