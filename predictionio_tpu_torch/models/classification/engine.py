"""Query/result types + engine factory (port of
``predictionio_tpu/models/classification/engine.py``; Engine.scala of
scala-parallel-classification/add-algorithm: Query = features array,
PredictedResult = label)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Query:
    features: Tuple[float, ...]

    def __post_init__(self):
        if not isinstance(self.features, tuple):
            object.__setattr__(self, "features", tuple(self.features))


@dataclass(frozen=True)
class PredictedResult:
    label: float


def ClassificationEngine():
    """Engine factory: the add-algorithm tutorial's map carries both
    "naive" and "randomforest"."""
    from predictionio_tpu_torch.controller import (
        Engine, FirstServing, IdentityPreparator,
    )
    from predictionio_tpu_torch.models.classification.data_source import (
        DataSource,
    )
    from predictionio_tpu_torch.models.classification.nb_algorithm import (
        NaiveBayesAlgorithm,
    )
    from predictionio_tpu_torch.models.classification.random_forest import (
        RandomForestAlgorithm,
    )

    return Engine(
        data_source_class=DataSource,
        preparator_class=IdentityPreparator,
        algorithm_class_map={"naive": NaiveBayesAlgorithm,
                             "randomforest": RandomForestAlgorithm},
        serving_class=FirstServing,
    )
