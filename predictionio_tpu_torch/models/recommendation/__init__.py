"""Recommendation template — explicit ALS: train, serve and evaluate."""

from predictionio_tpu_torch.models.recommendation.engine import (
    ActualResult, ItemScore, PredictedResult, Query, Rating,
    RecommendationEngine,
)
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams, ALSModel,
)
from predictionio_tpu_torch.models.recommendation.data_source import (
    DataSource, DataSourceEvalParams, DataSourceParams, TrainingData,
)

__all__ = [
    "ActualResult", "ItemScore", "PredictedResult", "Query", "Rating",
    "RecommendationEngine", "ALSAlgorithm", "ALSAlgorithmParams", "ALSModel",
    "DataSource", "DataSourceEvalParams", "DataSourceParams", "TrainingData",
]
