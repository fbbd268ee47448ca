"""Linear regression engine with k-fold evaluation (port of
``predictionio_tpu/examples/regression.py``).

Parity: examples/experimental/scala-parallel-regression/Run.scala (SGD
linear regression over an svmlight-ish text file, k-fold MSE eval,
LAverageServing over algorithm variants) and the local/java regression
variants. The reference calls MLlib's LinearRegressionWithSGD; here the
trainer is a loop of full-batch gradient steps on the context's device
(the card unless the caller asks for the CPU), two fp32 matmuls a step
with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    AverageServing, DataSource, EmptyEvaluationInfo, Engine,
    IdentityPreparator, Params,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.controller.metric import AverageMetric


@dataclass(frozen=True)
class RegressionDataSourceParams(Params):
    filepath: str
    k: int = 3
    seed: int = 9527


@dataclass
class LabeledPoints:
    """Columnar (features, label) — the RDD[LabeledPoint] analogue."""
    x: np.ndarray     # (n, d) float32
    y: np.ndarray     # (n,) float32


class RegressionDataSource(DataSource):
    """Text rows ``label f1 f2 ...`` → LabeledPoints + k-fold eval splits
    (Run.scala ParallelDataSource.read / MLUtils.kFold)."""

    params_class = RegressionDataSourceParams

    def __init__(self, params: RegressionDataSourceParams):
        self.dsp = params

    def _read(self) -> LabeledPoints:
        rows = np.loadtxt(self.dsp.filepath, dtype=np.float32, ndmin=2)
        return LabeledPoints(x=rows[:, 1:], y=rows[:, 0])

    def read_training(self, ctx) -> LabeledPoints:
        return self._read()

    def read_eval(self, ctx):
        data = self._read()
        n = data.y.shape[0]
        rng = np.random.default_rng(self.dsp.seed)
        fold = rng.integers(0, self.dsp.k, size=n)
        sets = []
        for f in range(self.dsp.k):
            tr, te = fold != f, fold == f
            td = LabeledPoints(x=data.x[tr], y=data.y[tr])
            qa = [(data.x[i], float(data.y[i])) for i in np.where(te)[0]]
            sets.append((td, EmptyEvaluationInfo(), qa))
        return sets


@dataclass(frozen=True)
class SGDAlgorithmParams(Params):
    numIterations: int = 200
    stepSize: float = 0.1


class SGDRegressionAlgorithm(Algorithm):
    """Full-batch gradient descent on the device
    (ParallelSGDAlgorithm, Run.scala). Model = (d+1,) weights with
    intercept last. Steps are normalized by n and feature scale so the
    reference's default stepSize values converge on typical data.
    """

    params_class = SGDAlgorithmParams

    def __init__(self, params: SGDAlgorithmParams = None):
        self.ap = params or SGDAlgorithmParams()

    def train(self, ctx, pd: LabeledPoints) -> np.ndarray:
        dev = device_mod.resolve(getattr(ctx, "device", None))
        x = torch.cat([
            torch.as_tensor(pd.x, dtype=torch.float32, device=dev),
            torch.ones((pd.x.shape[0], 1), dtype=torch.float32,
                       device=dev)], dim=1)
        y = torch.as_tensor(pd.y, dtype=torch.float32, device=dev)
        n = x.shape[0]
        step = torch.tensor(self.ap.stepSize / max(n, 1),
                            dtype=torch.float32, device=dev)
        w = torch.zeros((x.shape[1],), dtype=torch.float32, device=dev)
        for _ in range(self.ap.numIterations):
            grad = x.T @ (x @ w - y)      # (d+1,): two matmuls
            w = w - step * grad
        return w.cpu().numpy()

    def predict(self, model: np.ndarray, query) -> float:
        q = np.asarray(query, dtype=np.float32)
        return float(q @ model[:-1] + model[-1])


class MeanSquareError(AverageMetric):
    """MSE over (prediction, actual) pairs (Run.scala MeanSquareError);
    lower is better."""

    comparison_sign = -1

    def calculate_qpa(self, query, prediction, actual) -> float:
        return (float(prediction) - float(actual)) ** 2


def engine() -> Engine:
    """RegressionEngineFactory (Run.scala): SGD algorithm + mean serving."""
    return Engine(RegressionDataSource, IdentityPreparator,
                  {"SGD": SGDRegressionAlgorithm}, AverageServing)
