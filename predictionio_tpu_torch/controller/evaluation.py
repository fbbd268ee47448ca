"""Evaluation binding + MetricEvaluator (port of
``predictionio_tpu/controller/evaluation.py``).

Reference: core/.../controller/Evaluation.scala:34-125,
EngineParamsGenerator.scala:26-46, MetricEvaluator.scala:48-263.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.metric import Metric

logger = logging.getLogger("predictionio_tpu_torch.evaluation")


class EngineParamsGenerator:
    """Subclass and set `engine_params_list` (EngineParamsGenerator.scala:26-46)."""

    engine_params_list: Sequence[EngineParams] = ()


class Evaluation:
    """Binds an engine to metrics (Evaluation.scala:34-125).

    Subclass and set `engine` plus either `metric` (primary) or
    `metrics` (primary first, like engineMetrics at Evaluation.scala:91-104).
    """

    engine: Engine = None
    metric: Optional[Metric] = None
    metrics: Sequence[Metric] = ()

    def __init__(self):
        if self.metric is None and self.metrics:
            self.metric = self.metrics[0]
        if self.metric is not None and not self.metrics:
            self.metrics = (self.metric,)

    @property
    def evaluator(self) -> "MetricEvaluator":
        return MetricEvaluator(
            metric=self.metric,
            other_metrics=tuple(self.metrics[1:]),
        )


@dataclasses.dataclass
class MetricScores:
    """Per-variant result row (MetricEvaluator.scala:48-58)."""
    engine_params: EngineParams
    score: float
    other_scores: Tuple[float, ...] = ()

    def to_dict(self):
        return {
            "engineParams": _engine_params_to_dict(self.engine_params),
            "score": self.score,
            "otherScores": list(self.other_scores),
        }


@dataclasses.dataclass
class MetricEvaluatorResult:
    """Full evaluation result (MetricEvaluator.scala:60-107)."""
    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: Tuple[str, ...]
    engine_params_scores: List[MetricScores]

    def to_json(self) -> str:
        return json.dumps({
            "metricHeader": self.metric_header,
            "otherMetricHeaders": list(self.other_metric_headers),
            "bestIdx": self.best_idx,
            "bestScore": self.best_score.to_dict(),
            "engineParamsScores": [s.to_dict()
                                   for s in self.engine_params_scores],
        }, indent=2, default=str)

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score}</td>"
            f"<td><pre>{json.dumps(_engine_params_to_dict(s.engine_params), default=str)}</pre></td></tr>"
            for i, s in enumerate(self.engine_params_scores))
        return (
            f"<h3>Metric: {self.metric_header}</h3>"
            f"<p>Best variant: #{self.best_idx} "
            f"(score {self.best_score.score})</p>"
            f"<table border=1><tr><th>#</th><th>{self.metric_header}</th>"
            f"<th>Engine Params</th></tr>{rows}</table>")

    def __str__(self) -> str:
        return (f"MetricEvaluatorResult:\n"
                f"  # engine params evaluated: "
                f"{len(self.engine_params_scores)}\n"
                f"Optimal Engine Params:\n"
                f"  {json.dumps(_engine_params_to_dict(self.best_engine_params), default=str)}\n"
                f"Metrics:\n"
                f"  {self.metric_header}: {self.best_score.score}")


def _engine_params_to_dict(ep: EngineParams):
    def p2d(p):
        return dataclasses.asdict(p) if dataclasses.is_dataclass(p) else str(p)
    return {
        "dataSourceParams": p2d(ep.data_source_params),
        "preparatorParams": p2d(ep.preparator_params),
        "algorithmParamsList": [
            {"name": n, "params": p2d(p)} for n, p in ep.algorithm_params_list],
        "servingParams": p2d(ep.serving_params),
    }


class MetricEvaluator:
    """Scores each EngineParams variant with the primary metric, picks the
    best by the metric's ordering, optionally writes best.json
    (MetricEvaluator.scala:155-263)."""

    def __init__(self, metric: Metric,
                 other_metrics: Sequence[Metric] = (),
                 output_path: Optional[str] = None):
        self.metric = metric
        self.other_metrics = tuple(other_metrics)
        self.output_path = output_path

    def evaluate_base(
        self,
        ctx,
        evaluation: Evaluation,
        engine_eval_data_sets: Sequence[Tuple[EngineParams, Any]],
    ) -> MetricEvaluatorResult:
        scores: List[MetricScores] = []
        for ep, eval_data_set in engine_eval_data_sets:
            score = self.metric.calculate(eval_data_set)
            others = tuple(m.calculate(eval_data_set)
                           for m in self.other_metrics)
            logger.info("Iteration score: %s (others: %s)", score, others)
            scores.append(MetricScores(ep, score, others))

        def _order_key(kv):
            # NaN compares False against everything, which would let a
            # NaN-scoring variant 0 win by default; rank NaN below any
            # finite score instead.
            s = kv[1].score
            if s != s:
                return float("-inf")
            return self.metric.comparison_sign * s

        best_idx, best = max(enumerate(scores), key=_order_key)
        result = MetricEvaluatorResult(
            best_score=best,
            best_engine_params=best.engine_params,
            best_idx=best_idx,
            metric_header=str(self.metric),
            other_metric_headers=tuple(str(m) for m in self.other_metrics),
            engine_params_scores=scores,
        )
        if self.output_path:
            self.save_best_engine_json(result, self.output_path)
        return result

    def save_best_engine_json(self, result: MetricEvaluatorResult,
                              path: str) -> None:
        """best.json: the winning variant's params, re-loadable as an
        engine.json params subtree (MetricEvaluator.saveEngineJson:193-217)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        ep = result.best_engine_params

        def p2d(p):
            return dataclasses.asdict(p) if dataclasses.is_dataclass(p) else {}

        variant = {
            "datasource": {"params": p2d(ep.data_source_params)},
            "preparator": {"params": p2d(ep.preparator_params)},
            "algorithms": [
                {"name": n, "params": p2d(p)}
                for n, p in ep.algorithm_params_list],
            "serving": {"params": p2d(ep.serving_params)},
        }
        with open(path, "w") as f:
            json.dump(variant, f, indent=2, default=str)
        logger.info("Best engine params written to %s", path)
