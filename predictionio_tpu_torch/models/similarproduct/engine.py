"""Query/result types + engine factory (port of
``predictionio_tpu/models/similarproduct/engine.py``).

Parity: scala-parallel-similarproduct/multi/src/main/scala/Engine.scala
(Query with items/num/categories/whiteList/blackList :23-30, ItemScore,
PredictedResult) and DataSource.scala (User :145, Item :147).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Query:
    items: Tuple[str, ...]
    num: int
    categories: Optional[Tuple[str, ...]] = None
    whiteList: Optional[Tuple[str, ...]] = None
    blackList: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        for f in ("items", "categories", "whiteList", "blackList"):
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


def SimilarProductEngine():
    """Engine factory (Engine.scala object SimilarProductEngine: als +
    likealgo algorithm map)."""
    from predictionio_tpu_torch.controller import (
        Engine, FirstServing, IdentityPreparator,
    )
    from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
        ALSAlgorithm, LikeAlgorithm,
    )
    from predictionio_tpu_torch.models.similarproduct.data_source import (
        DataSource,
    )

    return Engine(
        data_source_class=DataSource,
        preparator_class=IdentityPreparator,
        algorithm_class_map={"als": ALSAlgorithm, "likealgo": LikeAlgorithm},
        serving_class=FirstServing,
    )
