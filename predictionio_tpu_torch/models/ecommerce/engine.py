"""Query/result types + engine factory (port of
``predictionio_tpu/models/ecommerce/engine.py``).

Parity: scala-parallel-ecommercerecommendation/train-with-rate-event/src/
main/scala/Engine.scala (Query user/num/categories/whiteList/blackList).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Query:
    user: str
    num: int
    categories: Optional[Tuple[str, ...]] = None
    whiteList: Optional[Tuple[str, ...]] = None
    blackList: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        for f in ("categories", "whiteList", "blackList"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    itemScores: Tuple[ItemScore, ...] = ()


@dataclass(frozen=True)
class Item:
    categories: Optional[Tuple[str, ...]] = None


def ECommerceEngine():
    """Engine factory (Engine.scala object ECommerceRecommendationEngine)."""
    from predictionio_tpu_torch.controller import (
        Engine, FirstServing, IdentityPreparator,
    )
    from predictionio_tpu_torch.models.ecommerce.als_algorithm import (
        ECommAlgorithm,
    )
    from predictionio_tpu_torch.models.ecommerce.data_source import DataSource

    return Engine(
        data_source_class=DataSource,
        preparator_class=IdentityPreparator,
        algorithm_class_map={"ecomm": ECommAlgorithm},
        serving_class=FirstServing,
    )
