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
    """Engine factory (Engine.scala:41-48)."""
    from predictionio_tpu_torch.controller import Engine, FirstServing
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm,
    )
    from predictionio_tpu_torch.models.recommendation.data_source import (
        DataSource,
    )
    from predictionio_tpu_torch.models.recommendation.preparator import (
        Preparator,
    )

    return Engine(
        data_source_class=DataSource,
        preparator_class=Preparator,
        algorithm_class_map={"als": ALSAlgorithm},
        serving_class=FirstServing,
    )
