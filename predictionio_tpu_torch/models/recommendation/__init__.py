"""Recommendation template — explicit ALS, serving half."""

from predictionio_tpu_torch.models.recommendation.engine import (
    ItemScore, PredictedResult, Query, RecommendationEngine,
)
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams, ALSModel,
)

__all__ = [
    "ItemScore", "PredictedResult", "Query", "RecommendationEngine",
    "ALSAlgorithm", "ALSAlgorithmParams", "ALSModel",
]
