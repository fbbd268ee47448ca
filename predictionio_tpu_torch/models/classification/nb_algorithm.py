"""NaiveBayesAlgorithm: multinomial NB on the card (port of
``predictionio_tpu/models/classification/nb_algorithm.py``;
NaiveBayesAlgorithm.scala:28-45).

MLlib's ``NaiveBayes.train(lambda)`` becomes ``ops.naive_bayes.train``
on the context's device (the card unless the caller asks for the CPU).
Labels are arbitrary floats (plan ids), encoded to class indices around
it. ``predict`` and ``batch_predict`` run ``log_joint`` on the model's
device: a trained model's, or, for a loaded blob, the deploy's
(``prepare_serving``) or the device policy's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Tuple

import numpy as np

from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.models.classification.data_source import (
    TrainingData,
)
from predictionio_tpu_torch.models.classification.engine import (
    PredictedResult, Query,
)
from predictionio_tpu_torch.ops import naive_bayes
from predictionio_tpu_torch.ops import quant as quant_mod


@dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    """engine.json key `lambda` (NaiveBayesAlgorithm.scala:30-32)."""
    lambda_: float = 1.0

    JSON_ALIASES = {"lambda": "lambda_"}


@dataclass
class ClassificationModel:
    nb: naive_bayes.NaiveBayesModel
    class_labels: Tuple[float, ...]   # class index -> original label


class NaiveBayesAlgorithm(Algorithm):
    params_class = NaiveBayesAlgorithmParams
    query_class = Query

    def __init__(self, params: NaiveBayesAlgorithmParams =
                 NaiveBayesAlgorithmParams()):
        self.ap = params

    def train(self, ctx, data: TrainingData) -> ClassificationModel:
        classes, y = data.encode_labels()
        model = naive_bayes.train(
            data.features_array(), y, lambda_=self.ap.lambda_,
            n_classes=len(classes), device=getattr(ctx, "device", None))
        return ClassificationModel(nb=model, class_labels=classes)

    def prepare_serving(self, model: ClassificationModel
                        ) -> ClassificationModel:
        """``pi`` and ``theta`` onto the deploy's device, once."""
        return ClassificationModel(
            nb=naive_bayes.on_device(model.nb, quant_mod.scoped_device()),
            class_labels=model.class_labels)

    def predict(self, model: ClassificationModel,
                query: Query) -> PredictedResult:
        x = np.asarray([query.features], dtype=np.float32)
        ix = int(naive_bayes.predict(model.nb, x)[0])
        return PredictedResult(label=model.class_labels[ix])

    def batch_predict(self, model: ClassificationModel,
                      queries: Iterable[Tuple[int, Query]]
                      ) -> List[Tuple[int, PredictedResult]]:
        queries = list(queries)
        if not queries:
            return []
        x = np.asarray([q.features for _qx, q in queries], dtype=np.float32)
        ixs = naive_bayes.predict(model.nb, x).cpu().numpy()
        return [(qx, PredictedResult(label=model.class_labels[int(ix)]))
                for (qx, _q), ix in zip(queries, ixs)]
