"""DataSource: labeled points from aggregated $set user properties (port
of ``predictionio_tpu/models/classification/data_source.py``; host
Python, copied).

Parity: scala-parallel-classification/add-algorithm/src/main/scala/
DataSource.scala — aggregateProperties over entityType "user" with
required ["plan", "attr0", "attr1", "attr2"]; label = plan, features =
(attr0, attr1, attr2). The reference keyed by appId; appName is the
modern form (train-with-rate-event variants use appName too).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, EmptyEvaluationInfo, Params, SanityCheck,
)
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.e2.evaluation import split_data
from predictionio_tpu_torch.models.classification.engine import Query

logger = logging.getLogger("predictionio_tpu_torch.classification")

ATTRS = ("attr0", "attr1", "attr2")
LABEL = "plan"


@dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str
    evalK: Optional[int] = None


@dataclass(frozen=True)
class LabeledPoint:
    label: float
    features: Tuple[float, ...]


@dataclass
class TrainingData(SanityCheck):
    labeled_points: List[LabeledPoint]

    def sanity_check(self) -> None:
        if not self.labeled_points:
            raise ValueError(
                "No labeled points found. Check that user entities carry "
                f"$set properties {LABEL!r} and {ATTRS!r}.")

    def features_array(self) -> np.ndarray:
        return np.array([p.features for p in self.labeled_points],
                        dtype=np.float32)

    def labels_array(self) -> np.ndarray:
        return np.array([p.label for p in self.labeled_points],
                        dtype=np.float32)

    def encode_labels(self) -> Tuple[Tuple[float, ...], np.ndarray]:
        """Float labels (plan ids) → (sorted class tuple, int32 class
        indices) — the shared contract every classification algorithm's
        model uses to map predictions back to original labels."""
        labels = self.labels_array()
        classes = tuple(sorted(set(labels.tolist())))
        class_ix = {c: i for i, c in enumerate(classes)}
        y = np.array([class_ix[l] for l in labels], dtype=np.int32)
        return classes, y


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.dsp = params

    def _read_points(self, ctx) -> List[LabeledPoint]:
        props = store.aggregate_properties(
            app_name=self.dsp.appName,
            entity_type="user",
            required=[LABEL, *ATTRS],
            storage=getattr(ctx, "storage", None),
        )
        points = []
        for entity_id, pm in props.items():
            try:
                points.append(LabeledPoint(
                    label=float(pm.get(LABEL)),
                    features=tuple(float(pm.get(a)) for a in ATTRS)))
            except Exception as e:
                logger.error("Failed to get properties %s of %s: %s",
                             pm, entity_id, e)
                raise
        return points

    def read_training(self, ctx) -> TrainingData:
        return TrainingData(labeled_points=self._read_points(ctx))

    def read_eval(self, ctx):
        """k-fold via e2 split_data (parity with the evaluation variant of
        the template, which uses CrossValidation)."""
        if not self.dsp.evalK:
            raise ValueError("evalK must be set for evaluation")
        points = self._read_points(ctx)
        return split_data(
            eval_k=self.dsp.evalK,
            dataset=points,
            evaluator_info=EmptyEvaluationInfo(),
            training_data_creator=lambda pts: TrainingData(list(pts)),
            query_creator=lambda p: Query(features=p.features),
            actual_creator=lambda p: p.label,
        )
