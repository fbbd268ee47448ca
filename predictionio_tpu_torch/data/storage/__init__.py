"""Storage registry — env-var-driven backend selection (port of
``predictionio_tpu/data/storage/__init__.py``).

- sources come from ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` plus any extra
  keys (``..._PATH``);
- repositories bind {METADATA, EVENTDATA, MODELDATA} to a source via
  ``PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE``;
- a source of type ``<type>`` is the module
  ``predictionio_tpu_torch.data.storage.<type>`` (memory, sqlite,
  localfs), whose DAO classes are named ``<Prefix><Entity>``;
- with no configuration, as in the reference, metadata and events live in
  one SQLite file ``$PIO_FS_BASEDIR/pio.sqlite`` and model blobs in
  ``$PIO_FS_BASEDIR/models`` (``PIO_FS_BASEDIR`` defaults to
  ``~/.pio_store``), so a store either package wrote reads in the other.
"""

from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from predictionio_tpu_torch.data.storage.base import (
    App, Apps, EngineInstance, EngineInstances, Events, Model, Models,
    NONE_FILTER,
)

__all__ = [
    "App", "Apps", "EngineInstance", "EngineInstances", "Events", "Model",
    "Models", "NONE_FILTER", "StorageClientConfig", "Storage",
    "get_storage",
]

MetaData = "METADATA"
EventData = "EVENTDATA"
ModelData = "MODELDATA"

_CLASS_PREFIX = {"sqlite": "Sqlite", "memory": "Memory", "localfs": "LocalFS"}


@dataclass
class StorageClientConfig:
    """A source's settings (Storage.scala:95-101): its env keys."""
    properties: Dict[str, str] = field(default_factory=dict)


class Storage:
    """A configured set of repositories. Usually the module singleton
    (:func:`get_storage`); instantiable for tests."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._env = dict(env if env is not None else os.environ)
        self._clients: Dict[str, Any] = {}
        self._objects: Dict[tuple, Any] = {}
        self._lock = threading.RLock()
        self._sources = self._parse_sources()
        self._repos = self._parse_repositories()

    def _parse_sources(self) -> Dict[str, Dict[str, str]]:
        sources: Dict[str, Dict[str, str]] = {}
        prefix = "PIO_STORAGE_SOURCES_"
        for k, v in self._env.items():
            if k.startswith(prefix) and k.endswith("_TYPE"):
                name = k[len(prefix):-len("_TYPE")]
                props = {"TYPE": v.lower()}
                keyprefix = f"{prefix}{name}_"
                for k2, v2 in self._env.items():
                    if k2.startswith(keyprefix) and k2 != k:
                        props[k2[len(keyprefix):]] = v2
                sources[name] = props
        if not sources:
            basedir = os.path.expanduser(
                self._env.get("PIO_FS_BASEDIR", "~/.pio_store"))
            sources["DEFAULT"] = {
                "TYPE": "sqlite",
                "PATH": os.path.join(basedir, "pio.sqlite"),
                "BASEDIR": basedir,
            }
            sources["LOCALFS"] = {
                "TYPE": "localfs",
                "PATH": os.path.join(basedir, "models"),
            }
        return sources

    def _parse_repositories(self) -> Dict[str, Optional[str]]:
        """Repository -> source name; None for a repository with neither
        a source nor a default, which raises when it is first used (a
        deploy-only configuration may leave EVENTDATA unset)."""
        repos: Dict[str, Optional[str]] = {}
        for repo in (MetaData, EventData, ModelData):
            src = self._env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src:
                repos[repo] = src
            elif "DEFAULT" in self._sources:
                repos[repo] = (
                    "LOCALFS" if repo == ModelData and "LOCALFS" in self._sources
                    else "DEFAULT")
            else:
                repos[repo] = None
        return repos

    def _client_for(self, source_name: str):
        with self._lock:
            if source_name in self._clients:
                return self._clients[source_name]
            props = self._sources.get(source_name)
            if props is None:
                raise RuntimeError(f"Undefined storage source: {source_name}")
            backend_type = props["TYPE"]
            if backend_type not in _CLASS_PREFIX:
                raise RuntimeError(
                    f"storage backend {backend_type!r} is not ported yet; "
                    f"the port provides {sorted(_CLASS_PREFIX)}")
            module = importlib.import_module(
                f"predictionio_tpu_torch.data.storage.{backend_type}")
            config = StorageClientConfig(properties=dict(props))
            client = module.StorageClient(config)
            self._clients[source_name] = (client, config, backend_type, module)
            return self._clients[source_name]

    def _get_data_object(self, repo: str, entity: str):
        key = (repo, entity)
        with self._lock:
            if key in self._objects:
                return self._objects[key]
            source = self._repos[repo]
            if source is None:
                raise RuntimeError(
                    f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE is not set and "
                    "no default source is available")
            client, config, backend_type, module = self._client_for(source)
            cls_name = _CLASS_PREFIX[backend_type] + entity
            cls = getattr(module, cls_name, None)
            if cls is None:
                raise RuntimeError(
                    f"Storage backend {backend_type!r} does not provide "
                    f"{cls_name} (required for repository {repo})")
            obj = cls(client, config, namespace="pio_" + repo.lower())
            self._objects[key] = obj
            return obj

    def get_meta_data_apps(self) -> Apps:
        return self._get_data_object(MetaData, "Apps")

    def get_meta_data_engine_instances(self) -> EngineInstances:
        return self._get_data_object(MetaData, "EngineInstances")

    def get_events(self) -> Events:
        return self._get_data_object(EventData, "Events")

    def get_model_data_models(self) -> Models:
        return self._get_data_object(ModelData, "Models")


_storage: Optional[Storage] = None
_storage_lock = threading.Lock()


def get_storage() -> Storage:
    global _storage
    with _storage_lock:
        if _storage is None:
            _storage = Storage()
        return _storage

