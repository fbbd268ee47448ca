"""Local-filesystem model-blob backend, one file per model id (the
port's copy of ``predictionio_tpu/data/storage/localfs.py``; the
reference's zero-configuration default for model blobs).

Parity with storage/localfs/.../LocalFSModels.scala:32-66.
"""

from __future__ import annotations

import os
from typing import Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Model


class StorageClient:
    def __init__(self, config):
        self.config = config
        path = config.properties.get("PATH", ".")
        self.client = os.path.abspath(os.path.expanduser(path))
        os.makedirs(self.client, exist_ok=True)


class LocalFSModels(base.Models):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self._dir = os.path.join(client.client, namespace) if namespace else client.client
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = model_id.replace("/", "_")
        return os.path.join(self._dir, f"pio_model_{safe}.bin")

    def insert(self, m: Model) -> None:
        tmp = self._path(m.id) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(m.models)
        os.replace(tmp, self._path(m.id))

    def get(self, model_id: str) -> Optional[Model]:
        try:
            with open(self._path(model_id), "rb") as f:
                return Model(model_id, f.read())
        except FileNotFoundError:
            return None

    def delete(self, model_id: str) -> None:
        try:
            os.remove(self._path(model_id))
        except FileNotFoundError:
            pass
