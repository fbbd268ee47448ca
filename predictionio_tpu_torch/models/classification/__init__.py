"""Classification template — Naive Bayes (and a random forest) over
aggregated ``$set`` user properties (port of
``predictionio_tpu/models/classification``)."""

from predictionio_tpu_torch.models.classification.engine import (
    ClassificationEngine, PredictedResult, Query,
)
from predictionio_tpu_torch.models.classification.data_source import (
    DataSource, DataSourceParams, TrainingData,
)
from predictionio_tpu_torch.models.classification.nb_algorithm import (
    NaiveBayesAlgorithm, NaiveBayesAlgorithmParams,
)

__all__ = [
    "ClassificationEngine", "PredictedResult", "Query",
    "DataSource", "DataSourceParams", "TrainingData",
    "NaiveBayesAlgorithm", "NaiveBayesAlgorithmParams",
]
