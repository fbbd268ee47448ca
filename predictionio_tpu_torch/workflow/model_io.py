"""Model (de)serialization for the Models store (port of
``predictionio_tpu/workflow/model_io.py``).

A blob is a pickle of the trained models with every array as numpy.
Loading one that ``pio train`` of the JAX package wrote would, with a
plain ``pickle.loads``, import ``predictionio_tpu`` — and jax with it.
:func:`deserialize_models` therefore unpickles with a restricted
``find_class``: the classes the templates' blobs hold (the
Recommendation, similar-product and e-commerce models, the
classification template's Naive Bayes and random-forest models, their
``Item`` records and BiMap; the example engines' and e2's models; a
self-saving model's manifest) map to the port's twins, which keep the
same fields, numpy's array reconstruction is allowed, and every other
class is refused. The same rule makes loading a blob from an untrusted
store unable to run code. So a blob that the JAX package trained loads
into the port; where a model holds factor arrays, the ``*_from_numpy``
constructors below carry them across without a blob.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import pickle
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.classification import (
    nb_algorithm, random_forest,
)
from predictionio_tpu_torch.models.ecommerce import (
    als_algorithm as ecomm_als, engine as ecomm_engine,
)
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSModel, host_f32,
)
from predictionio_tpu_torch.models.similarproduct import (
    als_algorithm as simprod_als, engine as simprod_engine,
)
from predictionio_tpu_torch.ops import naive_bayes

#: a blob's class, by module below the package, -> the port's class
_TEMPLATE_CLASSES = {
    ("models.recommendation.als_algorithm", "ALSModel"): ALSModel,
    ("data.bimap", "BiMap"): BiMap,
    ("models.classification.nb_algorithm", "ClassificationModel"):
        nb_algorithm.ClassificationModel,
    ("ops.naive_bayes", "NaiveBayesModel"): naive_bayes.NaiveBayesModel,
    ("models.classification.random_forest", "RandomForestModel"):
        random_forest.RandomForestModel,
    ("models.classification.random_forest", "_FlatTree"):
        random_forest._FlatTree,
    ("models.similarproduct.als_algorithm", "ALSModel"):
        simprod_als.ALSModel,
    ("models.similarproduct.engine", "Item"): simprod_engine.Item,
    ("models.ecommerce.als_algorithm", "ECommModel"): ecomm_als.ECommModel,
    ("models.ecommerce.engine", "Item"): ecomm_engine.Item,
}

#: the example engines', e2's and the manifest's classes, by module below
#: the package: the examples import the templates (and so this module's
#: imports), so these resolve at their first use in a blob
_LAZY_CLASSES = frozenset([
    ("controller.persistent_model", "PersistentModelManifest"),
    ("e2.engine", "CategoricalNaiveBayesModel"),
    ("e2.engine", "MarkovChainModel"),
    ("examples.apps", "MaintenanceReport"),
    ("examples.dimsum", "DIMSUMModel"),
    ("examples.friend_recommendation", "KeywordSimilarityModel"),
    ("examples.friend_recommendation", "SimRankModel"),
    ("examples.recommendation_variants", "CategoryALSModel"),
    ("examples.recommended_user", "RUModel"),
    ("examples.similarproduct_variants", "VItem"),
    ("examples.similarproduct_variants", "VModel"),
    ("examples.stock", "RegressionStrategyModel"),
])

_PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")

#: (module, name) a blob may name -> the port's class, under the module
#: paths of both packages
_PORT_CLASSES: Dict[Tuple[str, str], Any] = {
    (f"{pkg}.{mod}", name): cls
    for pkg in _PACKAGES
    for (mod, name), cls in _TEMPLATE_CLASSES.items()}


def _lazy_class(module: str, name: str):
    """The port's class for a lazily resolved (module, name) of either
    package, or None."""
    for pkg in _PACKAGES:
        sub = module[len(pkg) + 1:] if module.startswith(pkg + ".") else None
        if sub is not None and (sub, name) in _LAZY_CLASSES:
            return getattr(importlib.import_module(
                f"predictionio_tpu_torch.{sub}"), name)
    return None

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
        cls = _PORT_CLASSES.get((module, name)) or _lazy_class(module, name)
        if cls is not None:
            return cls
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"model blob names {module}.{name}, which the port does not "
            "load (allowed: the templates', examples' and e2's model "
            "classes, BiMap, the persistent-model manifest and numpy "
            "arrays)")


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


def _vocab(v) -> BiMap:
    return v if isinstance(v, BiMap) else BiMap(dict(v))


def category_als_model_from_numpy(rank: int, user_factors, item_factors,
                                  user_vocab, item_vocab, items):
    """The recommendation-cat example's model from factor arrays, the
    ``{id: row}`` vocabularies and ``{row: Item}``; the category masks
    are built as its ``train`` builds them."""
    from predictionio_tpu_torch.examples import recommendation_variants as rv
    item_vocab = _vocab(item_vocab)
    return rv.CategoryALSModel(
        rank=int(rank), user_factors=host_f32(user_factors),
        item_factors=host_f32(item_factors), user_vocab=_vocab(user_vocab),
        item_vocab=item_vocab, items=dict(items),
        category_masks=rv.build_category_masks(items, len(item_vocab)))


def similarproduct_variants_model_from_numpy(item_factors, item_vocab,
                                             items, trained):
    """The similar-product variants' model from the L2-normalized item
    factors, the vocabulary, ``{row: VItem}`` and the trained mask; the
    category masks and the year columns are built as its ``train``
    builds them."""
    from predictionio_tpu_torch.examples import similarproduct_variants as sv
    item_vocab = _vocab(item_vocab)
    n = len(item_vocab)
    years = np.zeros(n, dtype=np.int32)
    has_year = np.zeros(n, dtype=bool)
    for ix, item in items.items():
        if item.year is not None:
            years[ix] = item.year
            has_year[ix] = True
    return sv.VModel(item_factors=host_f32(item_factors),
                     item_vocab=item_vocab, items=dict(items),
                     trained=np.asarray(trained, dtype=bool),
                     category_masks=sv.build_category_masks(items, n),
                     years=years, has_year=has_year)


def recommended_user_model_from_numpy(user_vocab, followed_factors):
    """The recommended-user example's model from its followed-side
    factors and the ``{id: row}`` user vocabulary."""
    from predictionio_tpu_torch.examples import recommended_user as ru
    return ru.RUModel(user_vocab=_vocab(user_vocab),
                      followed_factors=host_f32(followed_factors))


def markov_chain_model_from_numpy(transition, n: int, device=None):
    """e2's MarkovChainModel from a numpy transition matrix, the matrix
    a tensor on ``device`` (the card unless the caller asks for the
    CPU)."""
    from predictionio_tpu_torch import device as device_mod
    from predictionio_tpu_torch.e2.engine import MarkovChainModel
    return MarkovChainModel(
        transition=torch.tensor(host_f32(transition),
                                device=device_mod.resolve(device)),
        n=int(n))
