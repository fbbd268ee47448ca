"""Preparator: identity wrap (port of
``predictionio_tpu/models/recommendation/preparator.py``; the template's
Preparator.scala wraps the ratings RDD into PreparedData)."""

from __future__ import annotations

from dataclasses import dataclass

from predictionio_tpu_torch.controller import Preparator as BasePreparator
from predictionio_tpu_torch.models.recommendation.data_source import (
    TrainingData,
)


@dataclass
class PreparedData:
    ratings: TrainingData


class Preparator(BasePreparator):
    def __init__(self, params=None):
        pass

    def prepare(self, ctx, training_data: TrainingData) -> PreparedData:
        return PreparedData(ratings=training_data)
