"""The DASE SDK of the port: the classes train, deploy and eval use."""

from predictionio_tpu_torch.controller.base import (
    Algorithm, DataSource, EmptyActualResult, EmptyEvaluationInfo,
    EmptyParams, Params, Preparator, SanityCheck, Serving,
)
from predictionio_tpu_torch.controller.engine import (
    Engine, EngineParams, SimpleEngine,
)
from predictionio_tpu_torch.controller.identity import (
    AverageServing, FirstServing, IdentityPreparator,
)
from predictionio_tpu_torch.controller.metric import (
    AverageMetric, Metric, OptionAverageMetric, OptionStdevMetric,
    StdevMetric, SumMetric, ZeroMetric,
)
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator, Evaluation, MetricEvaluator, MetricScores,
)
from predictionio_tpu_torch.controller.persistent_model import (
    LocalFileSystemPersistentModel, PersistentModel,
)
from predictionio_tpu_torch.controller.self_cleaning import (
    EventWindow, SelfCleaningDataSource,
)

__all__ = [
    "Algorithm", "DataSource", "EmptyActualResult", "EmptyEvaluationInfo",
    "EmptyParams", "Params", "Preparator", "SanityCheck", "Serving",
    "Engine", "EngineParams", "SimpleEngine",
    "AverageServing", "FirstServing", "IdentityPreparator",
    "AverageMetric", "Metric", "OptionAverageMetric", "OptionStdevMetric",
    "StdevMetric", "SumMetric", "ZeroMetric",
    "EngineParamsGenerator", "Evaluation", "MetricEvaluator", "MetricScores",
    "LocalFileSystemPersistentModel", "PersistentModel",
    "EventWindow", "SelfCleaningDataSource",
]
