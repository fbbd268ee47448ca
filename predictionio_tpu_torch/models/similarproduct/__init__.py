"""SimilarProduct engine template (implicit ALS item vectors + cosine
top-K; port of ``predictionio_tpu/models/similarproduct``).

Reference: examples/scala-parallel-similarproduct/multi/src/main/scala/ —
$set users/items + view events -> ALS.trainImplicit -> item-vector cosine
similarity against recent items, with category/whiteList/blackList filters;
LikeAlgorithm variant trains on like/dislike events (latest wins).
"""

from predictionio_tpu_torch.models.similarproduct.engine import (
    Item, ItemScore, PredictedResult, Query, SimilarProductEngine,
)
from predictionio_tpu_torch.models.similarproduct.data_source import (
    DataSource, DataSourceParams, TrainingData,
)
from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams, LikeAlgorithm,
)

__all__ = [
    "Item", "ItemScore", "PredictedResult", "Query", "SimilarProductEngine",
    "DataSource", "DataSourceParams", "TrainingData",
    "ALSAlgorithm", "ALSAlgorithmParams", "LikeAlgorithm",
]
