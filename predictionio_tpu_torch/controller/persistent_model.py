"""PersistentModel SPI: models that save themselves (port of
``predictionio_tpu/controller/persistent_model.py``).

Reference: core/.../controller/PersistentModel.scala:67-115 and
LocalFileSystemPersistentModel.scala:39-77. A model class that mixes in
:class:`PersistentModel` saves itself at ``pio train``; the model blob
then holds a :class:`PersistentModelManifest` naming the class, and
``pio deploy`` calls that class's ``load``. A manifest that names a class
of the JAX package loads the port's class of the same name
(``workflow/workflow_utils.py::port_path``).
"""

from __future__ import annotations

import abc
import os
import pickle
from dataclasses import dataclass


@dataclass(frozen=True)
class PersistentModelManifest:
    """Marker persisted instead of the model; names the loader class
    (workflow/PersistentModelManifest.scala)."""
    class_name: str
    module_name: str


class PersistentModel(abc.ABC):
    """Mix into a model class to self-manage persistence."""

    @abc.abstractmethod
    def save(self, instance_id: str, params, ctx) -> bool:
        """Persist; return False to fall back to default serialization."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params, ctx):
        """Restore the model saved under instance_id."""


def local_model_path(instance_id: str) -> str:
    base = os.path.expanduser(os.environ.get("PIO_FS_BASEDIR", "~/.pio_store"))
    return os.path.join(base, "models", f"pio_persistent_{instance_id}.pkl")


class LocalFileSystemPersistentModel(PersistentModel):
    """Pickle-to-local-file helper
    (LocalFileSystemPersistentModel.scala:39-77), the file under
    ``$PIO_FS_BASEDIR/models``. A model holding tensors
    should turn them to numpy in ``__getstate__``, so the file loads on
    any device."""

    def save(self, instance_id: str, params, ctx) -> bool:
        path = local_model_path(instance_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params, ctx):
        with open(local_model_path(instance_id), "rb") as f:
            return pickle.load(f)
