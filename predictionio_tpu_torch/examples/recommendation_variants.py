"""Recommendation-engine variants: categories, EntityMap, custom datasource
(port of ``predictionio_tpu/examples/recommendation_variants.py``).

Parity targets (examples/experimental/):

- ``scala-parallel-recommendation-cat`` — implicit ALS over deduped view
  counts with category / white-list / black-list serving filters
  (ALSAlgorithm.scala there). `CategoryALSAlgorithm` below.
- ``scala-parallel-recommendation-entitymap`` — typed User/Item attribute
  extraction via extractEntityMap + rate/buy → Rating mapping
  (DataSource.scala there). `EntityMapDataSource` below, composed with the
  supported recommendation template's Preparator/ALSAlgorithm.
- ``scala-parallel-recommendation-custom-datasource`` — ratings from a
  ``user::item::rating`` text file instead of the event store, proving any
  DataSource slots into the engine. `FileDataSource` below.
- ``scala-parallel-recommendation-mongo-datasource`` — the same engine over
  a different storage backend; in this framework that is pure configuration
  (point ``PIO_STORAGE_SOURCES_*_TYPE`` at another backend — the env
  registry in data/storage/__init__.py), so no separate code exists.

Device work: `CategoryALSAlgorithm` lays its counts out and trains
implicit ALS on the context's device (the card unless the caller asks
for the CPU), each half-step ending in kernel A, and serves on the host
(one matvec, a masked top-k). The entity-map and file engines use the
template's ``ALSAlgorithm``: kernel A in training, B1 + B2 in a
quantized deploy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, Engine, FirstServing, IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.examples._serving import (
    build_category_masks, masked_topk_result, query_mask,
)
from predictionio_tpu_torch.models.recommendation.data_source import (
    TrainingData, training_data_from_columnar,
)
from predictionio_tpu_torch.models.recommendation.preparator import Preparator
from predictionio_tpu_torch.models.similarproduct.data_source import (
    DataSource as SPDataSource, TrainingData as SPTrainingData,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    Item, PredictedResult,
)
from predictionio_tpu_torch.ops import als


# ---------------------------------------------------------------------------
# recommendation-cat: implicit ALS + category filters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CatQuery:
    """Query.scala of the cat template: user + num + filters."""
    user: str
    num: int
    categories: Optional[Tuple[str, ...]] = None
    whiteList: Optional[Tuple[str, ...]] = None
    blackList: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        for f in ("categories", "whiteList", "blackList"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


@dataclass(frozen=True)
class CategoryALSParams(Params):
    rank: int = 10
    numIterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None


@dataclass
class CategoryALSModel:
    rank: int
    user_factors: np.ndarray     # (n_users, r)
    item_factors: np.ndarray     # (n_items, r)
    user_vocab: BiMap
    item_vocab: BiMap
    items: Dict[int, Item]       # item index -> Item (categories)
    category_masks: Dict[str, np.ndarray] = None


class CategoryALSAlgorithm(Algorithm):
    """Implicit ALS on view counts (cat ALSAlgorithm.scala: reduceByKey
    over (user, item) pairs then ALS.trainImplicit) with the serving-side
    category/white/black filters. Training runs the shared implicit
    kernel (ops/als.py) — counts are the confidence signal."""

    params_class = CategoryALSParams
    query_class = CatQuery

    def __init__(self, params: CategoryALSParams = None):
        self.ap = params or CategoryALSParams()

    def train(self, ctx, data: SPTrainingData) -> CategoryALSModel:
        user_vocab = BiMap.string_int(data.users.keys())
        item_vocab = BiMap.string_int(data.items.keys())
        counts: Dict[Tuple[int, int], float] = {}
        for ve in data.view_events:
            u, i = user_vocab.get(ve.user), item_vocab.get(ve.item)
            if u is None or i is None:
                continue      # reference logs and drops unknown ids
            counts[(u, i)] = counts.get((u, i), 0.0) + 1.0
        if not counts:
            raise ValueError(
                "mllibRatings cannot be empty. Please check if your events "
                "contain valid user and item ID.")
        keys = np.asarray(list(counts.keys()), dtype=np.int32)
        vals = np.asarray(list(counts.values()), dtype=np.float32)
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            prepared = als.prepare_ratings(
                keys[:, 0], keys[:, 1], vals,
                n_users=len(user_vocab), n_items=len(item_vocab),
                on_device=True, device=dev)
        U, V = als.train_implicit(
            prepared, rank=self.ap.rank, iterations=self.ap.numIterations,
            lambda_=self.ap.lambda_, alpha=self.ap.alpha, seed=int(seed),
            device=dev)
        items = {item_vocab(iid): item for iid, item in data.items.items()}
        # one copy of each side to the host: serving is host numpy
        return CategoryALSModel(
            rank=self.ap.rank, user_factors=U.cpu().numpy(),
            item_factors=V.cpu().numpy(), user_vocab=user_vocab,
            item_vocab=item_vocab, items=items,
            category_masks=build_category_masks(items, len(item_vocab)))

    def predict(self, model: CategoryALSModel,
                query: CatQuery) -> PredictedResult:
        u = model.user_vocab.get(query.user)
        if u is None:
            return PredictedResult(())    # unseen user
        scores = model.item_factors @ model.user_factors[u]
        mask = query_mask(model.item_vocab, len(model.item_vocab),
                          model.category_masks, query, exclude=set())
        return masked_topk_result(scores, mask, query.num, model.item_vocab)


def cat_engine() -> Engine:
    """recommendation-cat Engine.scala (reuses the similarproduct
    DataSource: $set users/items-with-categories + view events)."""
    return Engine(SPDataSource, IdentityPreparator,
                  {"als": CategoryALSAlgorithm}, FirstServing)


# ---------------------------------------------------------------------------
# recommendation-entitymap: typed attributes via extract_entity_map
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class User:
    """User.scala of the entitymap template (attr0/attr1/attr2)."""
    attr0: float
    attr1: int
    attr2: int


@dataclass(frozen=True)
class EMItem:
    """Item.scala (attrA/attrB/attrC)."""
    attrA: str
    attrB: int
    attrC: bool


@dataclass(frozen=True)
class EntityMapDataSourceParams(Params):
    appName: str


class EntityMapDataSource(BaseDataSource):
    """extractEntityMap for typed users/items + rate/buy → ratings
    (entitymap DataSource.scala): rate events carry a `rating` property,
    buy maps to 4.0. Produces the recommendation template's TrainingData so
    the supported Preparator/ALSAlgorithm plug in unchanged; the typed
    entity maps ride along for feature models."""

    params_class = EntityMapDataSourceParams

    def __init__(self, params: EntityMapDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        storage = getattr(ctx, "storage", None)
        users = store.extract_entity_map(
            self.dsp.appName, "user",
            lambda dm: User(attr0=dm.get_float("attr0"),
                            attr1=dm.get_int("attr1"),
                            attr2=dm.get_int("attr2")),
            required=["attr0", "attr1", "attr2"], storage=storage)
        items = store.extract_entity_map(
            self.dsp.appName, "item",
            lambda dm: EMItem(attrA=dm.get_str("attrA"),
                              attrB=dm.get_int("attrB"),
                              attrC=bool(dm.get("attrC"))),
            required=["attrA", "attrB", "attrC"], storage=storage)

        col = store.find_columnar(
            self.dsp.appName, entity_type="user",
            event_names=["rate", "buy"], target_entity_type="item",
            rating_property="rating", storage=storage)
        td = training_data_from_columnar(col)
        td.users = users    # EntityMaps ride along (TrainingData.scala there)
        td.items = items
        return td


def entitymap_engine() -> Engine:
    """entitymap Engine.scala: custom datasource + supported ALS stack."""
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm)
    return Engine(EntityMapDataSource, Preparator,
                  {"als": ALSAlgorithm}, FirstServing)


# ---------------------------------------------------------------------------
# recommendation-custom-datasource: ratings from a text file
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FileDataSourceParams(Params):
    filepath: str


class FileDataSource(BaseDataSource):
    """``user::item::rating`` lines → TrainingData
    (custom-datasource DataSource.scala)."""

    params_class = FileDataSourceParams

    def __init__(self, params: FileDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        users, items, ratings = [], [], []
        with open(self.dsp.filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                user, item, rate = line.split("::")
                users.append(user)
                items.append(item)
                ratings.append(float(rate))
        user_vocab = BiMap.string_int(users)
        item_vocab = BiMap.string_int(items)
        return TrainingData(
            user_idx=user_vocab.encode_array(users),
            item_idx=item_vocab.encode_array(items),
            rating=np.asarray(ratings, dtype=np.float32),
            user_vocab=user_vocab, item_vocab=item_vocab)


def file_engine() -> Engine:
    """custom-datasource Engine.scala: file reader + supported ALS stack."""
    from predictionio_tpu_torch.models.recommendation.als_algorithm import (
        ALSAlgorithm)
    return Engine(FileDataSource, Preparator,
                  {"als": ALSAlgorithm}, FirstServing)
