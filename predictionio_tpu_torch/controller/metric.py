"""Metric family for evaluation (port of
``predictionio_tpu/controller/metric.py``).

Reference: core/.../controller/Metric.scala:39-269. A metric consumes the
eval output [(EI, [(Q, P, A)])] and produces an ordered score. The
per-tuple scores are reduced with numpy on the host: the tuple count per
eval is query-scale, not ratings-scale.
"""

from __future__ import annotations

import abc
from typing import Generic, List, Sequence, Tuple, TypeVar

import numpy as np

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

EvalDataSet = Sequence[Tuple[EI, Sequence[Tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A], abc.ABC):
    """Base metric (Metric.scala:39-57); higher is better by default."""

    #: set to -1 to make lower scores better (Ordering reversal)
    comparison_sign: int = 1

    @abc.abstractmethod
    def calculate(self, eval_data_set: EvalDataSet) -> float: ...

    def compare(self, a: float, b: float) -> int:
        key_a, key_b = self.comparison_sign * a, self.comparison_sign * b
        return (key_a > key_b) - (key_a < key_b)

    def __str__(self) -> str:
        return type(self).__name__


class _QPAMetric(Metric[EI, Q, P, A]):
    """Shared scaffold: per-tuple score -> global reduction."""

    @abc.abstractmethod
    def calculate_qpa(self, q: Q, p: P, a: A): ...

    def _scores(self, eval_data_set: EvalDataSet) -> np.ndarray:
        vals: List[float] = []
        for _ei, qpa in eval_data_set:
            for q, p, a in qpa:
                s = self.calculate_qpa(q, p, a)
                if s is not None:
                    vals.append(float(s))
        return np.asarray(vals, dtype=np.float64)


class AverageMetric(_QPAMetric[EI, Q, P, A]):
    """Global mean of per-tuple scores (Metric.scala:99-122)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = self._scores(eval_data_set)
        return float(scores.mean()) if scores.size else float("nan")


class OptionAverageMetric(AverageMetric[EI, Q, P, A]):
    """Mean over non-None scores only (Metric.scala:124-149):
    ``calculate_qpa`` MAY return None."""


class StdevMetric(_QPAMetric[EI, Q, P, A]):
    """Population stdev of scores (Metric.scala:151-177)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        scores = self._scores(eval_data_set)
        return float(scores.std()) if scores.size else float("nan")


class OptionStdevMetric(StdevMetric[EI, Q, P, A]):
    """Stdev over non-None scores (Metric.scala:179-203)."""


class SumMetric(_QPAMetric[EI, Q, P, A]):
    """Sum of scores (Metric.scala:205-232)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return float(self._scores(eval_data_set).sum())


class ZeroMetric(Metric[EI, Q, P, A]):
    """Always 0, an evaluation-development placeholder
    (Metric.scala:234-250)."""

    def calculate(self, eval_data_set: EvalDataSet) -> float:
        return 0.0
