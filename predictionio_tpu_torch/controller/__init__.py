"""The DASE SDK of the port: the classes train and deploy use."""

from predictionio_tpu_torch.controller.base import (
    Algorithm, DataSource, EmptyParams, Params, Preparator, SanityCheck,
    Serving,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.identity import FirstServing

__all__ = [
    "Algorithm", "DataSource", "EmptyParams", "Params", "Preparator",
    "SanityCheck", "Serving", "Engine", "EngineParams", "FirstServing",
]
