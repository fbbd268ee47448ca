"""The DASE SDK of the port: the classes deploy uses."""

from predictionio_tpu_torch.controller.base import (
    Algorithm, EmptyParams, Params, Serving,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.identity import FirstServing

__all__ = [
    "Algorithm", "EmptyParams", "Params", "Serving", "Engine",
    "EngineParams", "FirstServing",
]
