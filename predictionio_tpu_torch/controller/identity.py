"""Stock serving component (port of ``predictionio_tpu/controller/identity.py``'s
FirstServing, LFirstServing.scala:29-44)."""

from __future__ import annotations

from typing import Sequence

from predictionio_tpu_torch.controller.base import Serving


class FirstServing(Serving):
    """Serves the first algorithm's prediction."""

    def __init__(self, params=None):
        pass

    def serve(self, query, predictions: Sequence):
        return predictions[0]
