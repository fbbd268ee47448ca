"""Evaluation: Precision@K grid over the recommendation engine (port of
``predictionio_tpu/models/recommendation/evaluation.py``).

Parity: recommendation-engine/src/main/scala/Evaluation.scala
(PrecisionAtK :32-51, PositiveCount :53-60, RecommendationEvaluation
:62-75, EngineParamsList :90-106).
"""

from __future__ import annotations

from dataclasses import dataclass

from predictionio_tpu_torch.controller import (
    AverageMetric, EngineParams, EngineParamsGenerator, Evaluation,
    OptionAverageMetric,
)
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.data_source import (
    DataSourceParams,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)


@dataclass(frozen=True)
class PrecisionAtK(OptionAverageMetric):
    """tp@k / min(k, #positives); None when the user has no positive actuals
    (Evaluation.scala:32-51)."""
    k: int = 10
    ratingThreshold: float = 2.0

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError("k must be greater than 0")

    def __str__(self):
        return f"Precision@K (k={self.k}, threshold={self.ratingThreshold})"

    def calculate_qpa(self, q, p, a):
        positives = {r.item for r in a.ratings
                     if r.rating >= self.ratingThreshold}
        if not positives:
            return None
        tp = sum(1 for s in p.itemScores[: self.k] if s.item in positives)
        return tp / min(self.k, len(positives))


@dataclass(frozen=True)
class PositiveCount(AverageMetric):
    """Average number of positive actuals per query (Evaluation.scala:53-60)."""
    ratingThreshold: float = 2.0

    def __str__(self):
        return f"PositiveCount (threshold={self.ratingThreshold})"

    def calculate_qpa(self, q, p, a):
        return sum(1 for r in a.ratings if r.rating >= self.ratingThreshold)


class RecommendationEvaluation(Evaluation):
    def __init__(self):
        self.engine = RecommendationEngine()
        self.metrics = (
            PrecisionAtK(k=10, ratingThreshold=4.0),
            PositiveCount(ratingThreshold=4.0),
            PrecisionAtK(k=10, ratingThreshold=2.0),
            PositiveCount(ratingThreshold=2.0),
            PrecisionAtK(k=10, ratingThreshold=1.0),
            PositiveCount(ratingThreshold=1.0),
        )
        super().__init__()


class ComprehensiveRecommendationEvaluation(Evaluation):
    def __init__(self):
        self.engine = RecommendationEngine()
        thresholds = (0.0, 2.0, 4.0)
        ks = (1, 3, 10)
        self.metrics = (
            (PrecisionAtK(k=3, ratingThreshold=2.0),)
            + tuple(PositiveCount(ratingThreshold=r) for r in thresholds)
            + tuple(PrecisionAtK(k=k, ratingThreshold=r)
                    for r in thresholds for k in ks))
        super().__init__()


def engine_params_list(app_name: str = "INVALID_APP_NAME",
                       k_fold: int = 5, query_num: int = 10):
    """The reference's rank x iterations hyper-grid (Evaluation.scala:99-106)."""
    base_ds = DataSourceParams(
        appName=app_name, evalParams={"kFold": k_fold, "queryNum": query_num})
    return [
        EngineParams(
            data_source_params=base_ds,
            algorithm_params_list=(
                ("als", ALSAlgorithmParams(rank=rank, numIterations=iters,
                                           lambda_=0.01, seed=3)),))
        for rank in (5, 10, 20)
        for iters in (1, 5, 10)
    ]


class EngineParamsList(EngineParamsGenerator):
    def __init__(self, app_name: str = "INVALID_APP_NAME"):
        self.engine_params_list = engine_params_list(app_name)
