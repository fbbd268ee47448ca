"""DataSource: rate/buy events -> columnar ratings (port of the training
read of ``predictionio_tpu/models/recommendation/data_source.py``;
``read_eval`` waits for the evaluation slice).

Parity: recommendation-engine/src/main/scala/DataSource.scala (getRatings
:46-74, readTraining :76-80). The RDD map/filter chains become one
columnar pass (store.find_columnar) producing vocab-encoded numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from predictionio_tpu_torch.controller import DataSource as BaseDataSource
from predictionio_tpu_torch.controller import Params, SanityCheck
from predictionio_tpu_torch.data import store, synthetic
from predictionio_tpu_torch.data.bimap import BiMap

#: buy events carry no rating property; the template maps them to 4.0
#: (DataSource.scala:57-59)
BUY_RATING = 4.0


@dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str
    evalParams: Optional[dict] = None  # {"kFold": int, "queryNum": int}


@dataclass
class TrainingData(SanityCheck):
    """Columnar, vocab-encoded ratings (the RDD[Rating] analogue)."""
    user_idx: np.ndarray     # (n,) int32
    item_idx: np.ndarray     # (n,) int32
    rating: np.ndarray       # (n,) float32
    user_vocab: BiMap
    item_vocab: BiMap

    @property
    def n(self) -> int:
        return int(self.user_idx.shape[0])

    def sanity_check(self) -> None:
        if self.n == 0:
            raise ValueError(
                "ratings is empty — is your event store populated and "
                "appName correct?")


def training_data_from_columnar(col) -> TrainingData:
    """Columnar rate/buy events -> TrainingData: buy maps to BUY_RATING
    whatever its properties (DataSource.scala:57-59); a rate event with no
    numeric rating is an error (:62-68)."""
    rating = col.rating.copy()
    if "buy" in col.event_names:
        rating[col.event_name_idx == col.event_names.index("buy")] = \
            BUY_RATING
    if np.isnan(rating).any():
        bad = int(np.isnan(rating).sum())
        raise ValueError(
            f"{bad} rate event(s) have no numeric 'rating' property — "
            "cannot convert to Rating (DataSource.scala:62-68 behavior)")
    return TrainingData(
        user_idx=col.entity_idx, item_idx=col.target_idx, rating=rating,
        user_vocab=col.entity_ids, item_vocab=col.target_ids)


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        """The app's rate/buy events; ``pio train --synthetic N``
        (``PIO_SYNTHETIC_EVENTS``) replaces the event-store read with the
        seeded generator. ``read_io``/``read_encode`` land in the
        context's phase table."""
        timings: Dict[str, float] = {}
        syn = synthetic.env_config()
        if syn is not None:
            td = synthetic.training_data(
                syn.n_events, seed=syn.seed, n_users=syn.n_users,
                n_items=syn.n_items, chunk=syn.chunk, timings=timings)
        else:
            td = training_data_from_columnar(store.find_columnar(
                self.dsp.appName,
                entity_type="user",
                event_names=["rate", "buy"],
                target_entity_type="item",
                rating_property="rating",
                storage=ctx.storage,
                timings=timings))
        for k, v in timings.items():
            ctx.note_phase(k, v)
        return td
