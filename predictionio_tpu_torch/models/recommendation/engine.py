"""Query/result types + engine factory (port of
``predictionio_tpu/models/recommendation/engine.py``). Field names are
camelCase so the serving JSON stays byte-compatible:
``{"user": ..., "num": ...}`` -> ``{"itemScores": [...]}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Query:
    user: str
    num: int


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    itemScores: Tuple[ItemScore, ...] = ()


def RecommendationEngine():
    """Engine factory (Engine.scala:41-48) with the serving classes; the
    DataSource and Preparator arrive with the training slice."""
    from predictionio_tpu_torch.controller import Engine, FirstServing
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm,
    )

    return Engine(
        data_source_class=None,
        preparator_class=None,
        algorithm_class_map={"als": ALSAlgorithm},
        serving_class=FirstServing,
    )
