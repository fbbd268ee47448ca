"""Base DASE component classes (port of the serving half of
``predictionio_tpu/controller/base.py``).

An engine is DataSource, Preparator, Algorithm(s) and Serving, each
instantiated from its typed Params. Deploy needs only Params, the
Algorithm's serving hooks and Serving; the training hooks arrive with
the training slice.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Generic, List, Optional, Sequence, TypeVar

PD = TypeVar("PD")   # prepared data
Q = TypeVar("Q")     # query
P = TypeVar("P")     # predicted result
M = TypeVar("M")     # model


class Params:
    """Marker base for typed parameter classes (dataclasses, built from
    engine.json with ``cls(**json_params)``)."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


def create_doer(cls, params: Optional[Params]):
    """Instantiate a DASE class with its Params — 1-arg ctor or 0-arg
    fallback — and record the params on the instance (``_pio_params``)."""
    if params is None or isinstance(params, EmptyParams):
        try:
            obj = cls()
        except TypeError:
            obj = cls(params if params is not None else EmptyParams())
    else:
        obj = cls(params)
    try:
        object.__setattr__(
            obj, "_pio_params", params if params is not None else EmptyParams())
    except AttributeError:
        pass
    return obj


class Algorithm(Generic[PD, M, Q, P], abc.ABC):
    """train/predict pair (BaseAlgorithm.scala:58-126)."""

    @abc.abstractmethod
    def train(self, ctx, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def predict_batch(self, model: M, queries: Sequence[Q]) -> List[P]:
        """Serving-path batched predict over one micro-batch, positional.
        Default maps predict; the server forms multi-query batches only
        for algorithms that override this (serving.protocol.batch_capable)."""
        return [self.predict(model, q) for q in queries]

    def prepare_serving(self, model: M) -> M:
        """Deploy-time hook: pick and build the serving layout."""
        return model

    @property
    def query_class(self):
        """Optional override: the Query dataclass for JSON extraction."""
        return None


class Serving(Generic[Q, P], abc.ABC):
    """Query supplement + prediction combination (BaseServing.scala)."""

    def supplement(self, query: Q) -> Q:
        return query

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[P]) -> P: ...
