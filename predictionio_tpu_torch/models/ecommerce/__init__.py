"""E-commerce recommendation template (explicit ALS + live business
rules; port of ``predictionio_tpu/models/ecommerce``).

Reference: examples/scala-parallel-ecommercerecommendation/
train-with-rate-event/src/main/scala/ — rate events (latest value wins) ->
ALS.train; predict filters candidates with live event-store lookups:
seen-items (when unseenOnly), the latest `$set` on the
constraint/unavailableItems entity, plus category/whiteList/blackList;
unknown users fall back to recent-view item similarity.
"""

from predictionio_tpu_torch.models.ecommerce.engine import (
    ECommerceEngine, Item, ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.models.ecommerce.data_source import (
    DataSource, DataSourceParams, TrainingData,
)
from predictionio_tpu_torch.models.ecommerce.als_algorithm import (
    ECommAlgorithm, ECommAlgorithmParams,
)

__all__ = [
    "ECommerceEngine", "Item", "ItemScore", "PredictedResult", "Query",
    "DataSource", "DataSourceParams", "TrainingData",
    "ECommAlgorithm", "ECommAlgorithmParams",
]
