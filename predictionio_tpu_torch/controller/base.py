"""Base DASE component classes (port of
``predictionio_tpu/controller/base.py``).

An engine is DataSource, Preparator, Algorithm(s) and Serving, each
instantiated from its typed Params. ``pio train`` reads through the
DataSource, prepares through the Preparator and trains each Algorithm;
``pio deploy`` uses the Algorithm's serving hooks and Serving; ``pio
eval`` reads k-fold sets through ``read_eval``, pre-builds each fold's
layout (``prepare_layout``) and scores each fold's queries with
``batch_predict``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Generic, Iterable, List, Optional, Sequence, Tuple, TypeVar

TD = TypeVar("TD")   # training data
PD = TypeVar("PD")   # prepared data
Q = TypeVar("Q")     # query
P = TypeVar("P")     # predicted result
A = TypeVar("A")     # actual result
EI = TypeVar("EI")   # evaluation info
M = TypeVar("M")     # model


class Params:
    """Marker base for typed parameter classes (dataclasses, built from
    engine.json with ``cls(**json_params)``)."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


@dataclasses.dataclass(frozen=True)
class EmptyEvaluationInfo:
    pass


@dataclasses.dataclass(frozen=True)
class EmptyActualResult:
    pass


class SanityCheck(abc.ABC):
    """Data classes that can validate themselves after read/prepare."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise if the data is unusable (empty, malformed)."""


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


class DataSource(Generic[TD, EI, Q, A], abc.ABC):
    """Reads training and evaluation data (BaseDataSource.scala:34-55)."""

    @abc.abstractmethod
    def read_training(self, ctx) -> TD: ...

    def read_eval(self, ctx) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
        """k-fold (TD, EI, [(Q, A)]) sets; engines that only train leave
        it unimplemented (PDataSource.scala:46-56)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; evaluation "
            "is unavailable for this engine")


class Preparator(Generic[TD, PD], abc.ABC):
    """Turns training data into prepared data (BasePreparator.scala)."""

    @abc.abstractmethod
    def prepare(self, ctx, training_data: TD) -> PD: ...


class Algorithm(Generic[PD, M, Q, P], abc.ABC):
    """train/predict pair (BaseAlgorithm.scala:58-126)."""

    @abc.abstractmethod
    def train(self, ctx, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> P: ...

    def batch_predict(self, model: M,
                      queries: Iterable[Tuple[int, Q]]) -> List[Tuple[int, P]]:
        """The evaluation's predict over indexed queries. Default maps
        predict (P2LAlgorithm.scala:69-71); override with a batched one."""
        return [(qx, self.predict(model, q)) for qx, q in queries]

    def prepare_layout(self, ctx, prepared_data: PD) -> None:
        """Build (and cache) the data-dependent layout that the
        hyperparameter variants of one fold share, before any of them
        trains (``workflow/fast_eval.py``). Default: nothing to build."""
        return None

    def bind_serving(self, ctx) -> None:
        """Called with the active context before predict/batch_predict is
        used, for algorithms that read the event store at predict time.
        Default: nothing to bind."""

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
