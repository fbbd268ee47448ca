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
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSModel, host_f32,
)

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


class NonFiniteModelError(ValueError):
    """A trained model array holds NaN/Inf: ``run_train`` refuses to mark
    such an instance COMPLETED, so deploy never serves it."""


def non_finite_report(obj: Any, limit: int = 8) -> List[str]:
    """Every float array of a host-side model tree that holds a
    non-finite value; empty when clean."""
    bad: List[str] = []

    def check(x):
        if len(bad) < limit:
            n_nan = int(np.isnan(x).sum())
            n_inf = int(np.isinf(x).sum())
            if n_nan or n_inf:
                bad.append(f"array shape={x.shape} dtype={x.dtype}: "
                           f"{n_nan} NaN, {n_inf} Inf")
        return x

    _map_arrays(obj, lambda x: isinstance(x, np.ndarray)
                and np.issubdtype(x.dtype, np.floating), check)
    return bad


def serialize_models(models: List[Any], check_finite: bool = False) -> bytes:
    """Pickle the models with every tensor as numpy; the JAX package's
    :func:`deserialize_models` reads the same layout. ``check_finite``
    refuses a model with NaN/Inf (``NonFiniteModelError``)."""
    host = to_host(models)
    if check_finite:
        bad = non_finite_report(host)
        if bad:
            raise NonFiniteModelError(
                "trained model contains non-finite values — refusing to "
                "persist it as COMPLETED (deploy would serve garbage "
                "scores): " + "; ".join(bad) + ". Set PIO_FINITE_CHECK=0 "
                "to persist it anyway.")
    return pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_models(blob: bytes) -> List[Any]:
    """Unpickle a blob written by either package, mapping its classes to
    the port's and refusing any class not listed above."""
    return _Unpickler(io.BytesIO(blob)).load()


def als_model_from_numpy(rank: int, user_factors, item_factors,
                         user_vocab: Mapping[str, int],
                         item_vocab: Mapping[str, int]) -> ALSModel:
    """A port ALSModel from factor arrays and ``{id: row}``
    vocabularies: the weights-across path that needs no blob. The factors
    may be numpy, torch tensors or the JAX package's trained arrays, or
    come from an iteration snapshot (:func:`factors_from_snapshot`)."""
    U = host_f32(user_factors)
    V = host_f32(item_factors)
    if U.shape != (len(user_vocab), rank) or V.shape != (len(item_vocab),
                                                          rank):
        raise ValueError(
            f"factor shapes {U.shape} / {V.shape} disagree with rank {rank} "
            f"and vocabularies of {len(user_vocab)} users / "
            f"{len(item_vocab)} items")
    return ALSModel(rank=int(rank), user_factors=U, item_factors=V,
                    user_vocab=BiMap(dict(user_vocab)),
                    item_vocab=BiMap(dict(item_vocab)))


def snapshot_arrays(user_factors, item_factors) -> Dict[str, np.ndarray]:
    """The ``{"U", "V"}`` arrays an iteration snapshot holds
    (``FactorCheckpointer.save`` of either package), from trained factors
    of either package."""
    return {"U": host_f32(user_factors), "V": host_f32(item_factors)}


def factors_from_snapshot(arrays: Mapping[str, Any]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(U, V) host float32 from a snapshot's arrays, as
    ``FactorCheckpointer.latest()`` of either package returns them."""
    missing = {"U", "V"} - set(arrays)
    if missing:
        raise ValueError(f"snapshot lacks {sorted(missing)}; an ALS "
                         "snapshot holds 'U' and 'V'")
    return host_f32(arrays["U"]), host_f32(arrays["V"])
