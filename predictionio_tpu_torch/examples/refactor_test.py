"""Vanilla engine: the SDK-composition self-test (port of
``predictionio_tpu/examples/refactor_test.py``).

Parity: examples/experimental/scala-refactor-test (Engine/DataSource/
Algorithm/Serving/Evaluator). A synthetic datasource of 0..99, an algorithm
whose model is `sum(events) * mult`, and a 3-set evaluation of 20 queries
each — it exists to prove the DASE wiring (train, eval, metric reduction)
end-to-end with no storage or device dependencies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from predictionio_tpu_torch.controller import (
    DataSource, EmptyEvaluationInfo, Engine, FirstServing,
    IdentityPreparator, Params,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.controller.metric import AverageMetric


@dataclass(frozen=True)
class VanillaQuery:
    q: int


@dataclass
class VanillaPrediction:
    p: int


@dataclass
class VanillaTrainingData:
    events: List[int]


class VanillaDataSource(DataSource):
    def __init__(self, params=None):
        pass

    def read_training(self, ctx) -> VanillaTrainingData:
        return VanillaTrainingData(events=list(range(100)))

    def read_eval(self, ctx):
        return [(self.read_training(ctx), EmptyEvaluationInfo(),
                 [(VanillaQuery(q=i), None) for i in range(20)])
                for _ in range(3)]


@dataclass(frozen=True)
class VanillaAlgorithmParams(Params):
    mult: int = 1


class VanillaAlgorithm(Algorithm):
    params_class = VanillaAlgorithmParams

    def __init__(self, params: VanillaAlgorithmParams = None):
        self.ap = params or VanillaAlgorithmParams()

    def train(self, ctx, pd: VanillaTrainingData) -> int:
        return sum(pd.events) * self.ap.mult     # Algorithm.scala: mc

    def predict(self, model: int, query: VanillaQuery) -> VanillaPrediction:
        return VanillaPrediction(p=model + query.q)

    @property
    def query_class(self):
        return VanillaQuery


class VanillaMetric(AverageMetric):
    """Mean predicted value (VanillaEvaluator's evaluate-and-reduce role)."""

    def calculate_qpa(self, query, prediction, actual) -> float:
        return float(prediction.p)


def engine() -> Engine:
    """VanillaEngine factory (Engine.scala)."""
    return Engine(VanillaDataSource, IdentityPreparator,
                  {"algo": VanillaAlgorithm}, FirstServing)
