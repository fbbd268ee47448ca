"""MovieLens extras: serving-side filtering + sliding-window evaluation
(port of ``predictionio_tpu/examples/movielens.py``).

Parity: examples/experimental/scala-local-movielens-filtering
(Filtering.scala — `TempFilter`, an LServing that drops items listed in a
file, e.g. temporarily-disabled inventory) and
scala-local-movielens-evaluation (Evaluation.scala / ItemRecEvaluation.scala
— `EventsSlidingEvalParams(firstTrainingUntilTime, evalDuration, evalCount)`
temporal backtesting splits).

Both compose with the supported recommendation template: TempFilterServing
replaces FirstServing in the engine factory; SlidingEvalDataSource replaces
the k-fold readEval with walk-forward windows (train on everything before T,
test on [T, T+duration), slide T forward) — the right split for
time-ordered interaction data, where random k-fold leaks the future.

The template's ``ALSAlgorithm`` does the device work: each train's
half-steps end in kernel A, and a quantized deploy answers through B1 +
B2; the filter runs after the top-``num`` cut, on the host.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import List, Set

import numpy as np

from predictionio_tpu_torch.controller import (
    EmptyEvaluationInfo, Engine, Params, Serving,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.models.recommendation.data_source import (
    DataSource as RecDataSource, DataSourceParams as RecDataSourceParams,
    TrainingData, training_data_from_columnar,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    ActualResult, PredictedResult, Query, Rating,
)
from predictionio_tpu_torch.models.recommendation.preparator import (
    Preparator,
)


@dataclass(frozen=True)
class TempFilterParams(Params):
    filepath: str


class TempFilterServing(Serving):
    """Drop disabled item ids listed one-per-line in `filepath`
    (Filtering.scala TempFilter). The file is re-read per request, exactly
    like the reference — edit it to change the filter without redeploying."""

    params_class = TempFilterParams

    def __init__(self, params: TempFilterParams):
        self.params = params

    def _disabled(self) -> Set[str]:
        with open(self.params.filepath) as f:
            return {line.strip() for line in f if line.strip()}

    def serve(self, query: Query,
              predictions: List[PredictedResult]) -> PredictedResult:
        disabled = self._disabled()
        first = predictions[0]
        return PredictedResult(itemScores=tuple(
            s for s in first.itemScores if s.item not in disabled))


def filtering_engine() -> Engine:
    """Engine.scala of movielens-filtering: recommendation stack with
    TempFilter serving."""
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm,
    )
    return Engine(RecDataSource, Preparator,
                  {"als": ALSAlgorithm}, TempFilterServing)


# ---------------------------------------------------------------------------
# Sliding-window (walk-forward) evaluation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SlidingEvalDataSourceParams(Params):
    """EventsSlidingEvalParams (Evaluation.scala CommonParams):
    first window trains on events before `firstTrainingUntilTime`, tests on
    the following `evalDurationSeconds`; then both slide forward,
    `evalCount` times total."""
    appName: str
    firstTrainingUntilTime: _dt.datetime
    evalDurationSeconds: float
    evalCount: int
    queryNum: int = 10


class SlidingEvalDataSource(RecDataSource):
    """Walk-forward eval splits over the recommendation template's event
    data. Training ratings are everything strictly before the window start;
    actuals are the window's ratings grouped by user, users in index
    order and each user's ratings in read order, as the JAX package
    groups them."""

    params_class = SlidingEvalDataSourceParams

    def __init__(self, params: SlidingEvalDataSourceParams):
        super().__init__(RecDataSourceParams(appName=params.appName))
        self.sep = params

    def read_eval(self, ctx):
        # one columnar read supplies ratings AND event times
        col = store.find_columnar(
            self.sep.appName, entity_type="user",
            event_names=["rate", "buy"], target_entity_type="item",
            rating_property="rating",
            storage=getattr(ctx, "storage", None))
        td = training_data_from_columnar(col)
        t_ms = col.event_time_ms
        dur_ms = self.sep.evalDurationSeconds * 1000.0
        t0 = self.sep.firstTrainingUntilTime.timestamp() * 1000.0
        inv_user = td.user_vocab.inverse()
        inv_item = td.item_vocab.inverse()

        sets = []
        for w in range(self.sep.evalCount):
            lo, hi = t0 + w * dur_ms, t0 + (w + 1) * dur_ms
            train = t_ms < lo
            test = (t_ms >= lo) & (t_ms < hi)
            if not train.any() or not test.any():
                continue    # an empty window trains/validates nothing
            train_td = TrainingData(
                user_idx=td.user_idx[train], item_idx=td.item_idx[train],
                rating=td.rating[train],
                user_vocab=td.user_vocab, item_vocab=td.item_vocab)
            # the window's rows grouped by user in one stable sort: the
            # same groups, in the same order, as a mask per user
            rows = np.flatnonzero(test)
            rows = rows[np.argsort(td.user_idx[rows], kind="stable")]
            users, starts = np.unique(td.user_idx[rows], return_index=True)
            qa = []
            for u, group in zip(users, np.split(rows, starts[1:])):
                ratings = tuple(
                    Rating(user=inv_user(int(u)),
                           item=inv_item(int(i)), rating=float(r))
                    for i, r in zip(td.item_idx[group], td.rating[group]))
                qa.append((Query(user=inv_user(int(u)),
                                 num=self.sep.queryNum),
                           ActualResult(ratings=ratings)))
            sets.append((train_td, EmptyEvaluationInfo(), qa))
        if not sets:
            raise ValueError(
                "sliding eval produced no non-empty windows — check "
                "firstTrainingUntilTime/evalDuration against the data")
        return sets


def sliding_eval_engine() -> Engine:
    """ItemRankEngine-with-sliding-eval role (Evaluation1..4)."""
    from predictionio_tpu_torch.controller import FirstServing
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm,
    )
    return Engine(SlidingEvalDataSource, Preparator,
                  {"als": ALSAlgorithm}, FirstServing)
