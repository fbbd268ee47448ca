"""Storage records and DAO interfaces the deploy path reads (port of the
metadata and model half of ``predictionio_tpu/data/storage/base.py``).

An ``EngineInstance`` row names a train run and its params; a ``Model``
row holds that run's serialized model blob. The event DAOs arrive with
the training slice.
"""

from __future__ import annotations

import abc
import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class EngineInstance:
    """A train-run ledger row (EngineInstances.scala:46-68)."""
    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    runtime_conf: Dict[str, str] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass(frozen=True)
class Model:
    """A serialized model blob keyed by EngineInstance id."""
    id: str
    models: bytes


class EngineInstances(abc.ABC):
    """EngineInstances DAO (EngineInstances.scala:69-110)."""

    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> None: ...


class Models(abc.ABC):
    """Model blob DAO (Models.scala:45-60)."""

    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> None: ...
