"""Stock components (port of ``predictionio_tpu/controller/identity.py``):
the identity preparator (IdentityPreparator.scala:34-93) and the
first and average servings (LFirstServing.scala:29-44,
LAverageServing.scala:29-44)."""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller.base import Preparator, Serving


class IdentityPreparator(Preparator):
    """PD = TD, unchanged."""

    def __init__(self, params=None):
        pass

    def prepare(self, ctx, training_data):
        return training_data


class FirstServing(Serving):
    """Serves the first algorithm's prediction."""

    def __init__(self, params=None):
        pass

    def serve(self, query, predictions: Sequence):
        return predictions[0]


class AverageServing(Serving):
    """Serves the numeric mean of all algorithms' predictions."""

    def __init__(self, params=None):
        pass

    def serve(self, query, predictions: Sequence):
        return sum(predictions) / len(predictions)
