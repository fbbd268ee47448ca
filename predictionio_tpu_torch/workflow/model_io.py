"""Model (de)serialization for the Models store (port of
``predictionio_tpu/workflow/model_io.py``).

A blob is a pickle of the trained models with every array as numpy.
Loading one that ``pio train`` of the JAX package wrote would, with a
plain ``pickle.loads``, import ``predictionio_tpu`` — and jax with it.
:func:`deserialize_models` therefore unpickles with a restricted
``find_class``: the classes a Recommendation blob holds (ALSModel, BiMap)
map to the port's twins, which keep the same fields, numpy's array
reconstruction is allowed, and every other class is refused. The same
rule makes loading a blob from an untrusted store unable to run code.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.als_algorithm import ALSModel

#: (module, name) a blob may name -> the port's class or function
_PORT_CLASSES: Dict[Tuple[str, str], Any] = {}
for _mod in ("predictionio_tpu", "predictionio_tpu_torch"):
    _PORT_CLASSES[(f"{_mod}.models.recommendation.als_algorithm",
                   "ALSModel")] = ALSModel
    _PORT_CLASSES[(f"{_mod}.data.bimap", "BiMap")] = BiMap

#: numpy's own array / dtype reconstruction, under its 1.x and 2.x paths
_NUMPY_GLOBALS = frozenset(
    [("numpy", "dtype"), ("numpy", "ndarray")]
    + [(f"numpy.{core}.{mod}", name)
       for core in ("core", "_core")
       for mod, name in (("numeric", "_frombuffer"),
                         ("multiarray", "_reconstruct"),
                         ("multiarray", "scalar"))])


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = _PORT_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"model blob names {module}.{name}, which the port does not "
            "load (allowed: ALSModel, BiMap and numpy arrays)")


def _map_arrays(obj: Any, leaf_p: Callable[[Any], bool],
                fn: Callable[[Any], Any]) -> Any:
    if leaf_p(obj):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_arrays(getattr(obj, f.name), leaf_p, fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_arrays(v, leaf_p, fn) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_map_arrays(x, leaf_p, fn) for x in obj)
    if isinstance(obj, list):
        return [_map_arrays(x, leaf_p, fn) for x in obj]
    return obj


def to_host(obj: Any) -> Any:
    """torch.Tensor leaves -> numpy (a blocking copy off the device)."""
    return _map_arrays(obj, lambda x: isinstance(x, torch.Tensor),
                       lambda x: x.detach().cpu().numpy())


def serialize_models(models: List[Any]) -> bytes:
    """Pickle the models with every tensor as numpy; the JAX package's
    :func:`deserialize_models` reads the same layout."""
    return pickle.dumps(to_host(models), protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_models(blob: bytes) -> List[Any]:
    """Unpickle a blob written by either package, mapping its classes to
    the port's and refusing any class not listed above."""
    return _Unpickler(io.BytesIO(blob)).load()


def als_model_from_numpy(rank: int, user_factors: np.ndarray,
                         item_factors: np.ndarray,
                         user_vocab: Mapping[str, int],
                         item_vocab: Mapping[str, int]) -> ALSModel:
    """A port ALSModel from plain arrays and ``{id: row}`` vocabularies
    (the weights-across path that needs no blob at all)."""
    U = np.ascontiguousarray(user_factors, dtype=np.float32)
    V = np.ascontiguousarray(item_factors, dtype=np.float32)
    if U.shape != (len(user_vocab), rank) or V.shape != (len(item_vocab),
                                                          rank):
        raise ValueError(
            f"factor shapes {U.shape} / {V.shape} disagree with rank {rank} "
            f"and vocabularies of {len(user_vocab)} users / "
            f"{len(item_vocab)} items")
    return ALSModel(rank=int(rank), user_factors=U, item_factors=V,
                    user_vocab=BiMap(dict(user_vocab)),
                    item_vocab=BiMap(dict(item_vocab)))
