"""SimilarProduct tutorial variants, composed into one engine (port of
``predictionio_tpu/examples/similarproduct_variants.py``).

Parity targets (examples/scala-parallel-similarproduct/):

- ``filterbyyear`` — items carry a ``year`` property and the Query's
  `recommendFromYear` keeps only items with ``year > recommendFromYear``
  (ALSAlgorithm.scala:240-255 there).
- ``no-set-user`` — users are inferred from view events' entity ids, no
  ``$set user`` required (DataSource.scala:63-88 there); `requireSetUsers`
  toggles it.
- ``add-rateevent`` — explicit ALS on rate events, latest rating wins per
  (user, item) (ALSAlgorithm.scala:87-127 there); engaged when the app has
  rate events, else implicit ALS on views like the base template.
- ``add-and-return-item-properties`` — items carry ``title``/``date`` and
  results return them alongside the score (Engine.scala:31-40 /
  DataSource.scala:62-75 there).

Training lays the signal out and runs explicit or implicit ALS on the
context's device (the card unless the caller asks for the CPU), each
half-step ending in kernel A; the item factors then come to the host
once. Scoring is the base template's: cosine over item factors via one
host matvec, boolean candidate masks (category/white/black/year), host
top-K.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, Engine, FirstServing, IdentityPreparator,
    Params, SanityCheck,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
    build_category_masks, candidate_mask,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.topk import host_topk


@dataclass(frozen=True)
class VItem:
    """Item with the variants' optional properties."""
    categories: Optional[Tuple[str, ...]] = None
    year: Optional[int] = None
    title: Optional[str] = None
    date: Optional[str] = None


@dataclass(frozen=True)
class VQuery:
    items: Tuple[str, ...]
    num: int
    categories: Optional[Tuple[str, ...]] = None
    whiteList: Optional[Tuple[str, ...]] = None
    blackList: Optional[Tuple[str, ...]] = None
    recommendFromYear: Optional[int] = None     # filterbyyear

    def __post_init__(self):
        for f in ("items", "categories", "whiteList", "blackList"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


@dataclass(frozen=True)
class VItemScore:
    """ItemScore + returned item properties
    (add-and-return-item-properties Engine.scala:35-40)."""
    item: str
    score: float
    title: Optional[str] = None
    date: Optional[str] = None
    year: Optional[int] = None


@dataclass(frozen=True)
class VPredictedResult:
    itemScores: Tuple[VItemScore, ...] = ()


@dataclass(frozen=True)
class Interaction:
    user: str
    item: str
    t: float
    rating: Optional[float] = None   # None for plain views


@dataclass
class VTrainingData(SanityCheck):
    users: Dict[str, None]
    items: Dict[str, VItem]
    views: List[Interaction]
    rates: List[Interaction] = field(default_factory=list)

    def sanity_check(self) -> None:
        if not self.items:
            raise ValueError("items in TrainingData cannot be empty.")
        if not self.views and not self.rates:
            raise ValueError("view/rate events cannot be empty.")


@dataclass(frozen=True)
class VDataSourceParams(Params):
    appName: str
    requireSetUsers: bool = False     # no-set-user is the variant default


class VDataSource(BaseDataSource):
    params_class = VDataSourceParams

    def __init__(self, params: VDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> VTrainingData:
        storage = getattr(ctx, "storage", None)
        items = {}
        for eid, pm in store.aggregate_properties(
                self.dsp.appName, "item", storage=storage).items():
            items[eid] = VItem(
                categories=(tuple(pm.get("categories"))
                            if pm.get_opt("categories") is not None
                            else None),
                year=(int(pm.get("year"))
                      if pm.get_opt("year") is not None else None),
                title=pm.get_opt("title"),
                date=pm.get_opt("date"))

        views, rates = [], []
        for e in store.find(self.dsp.appName, entity_type="user",
                            event_names=["view", "rate"],
                            target_entity_type="item", storage=storage):
            if e.target_entity_id is None:
                raise ValueError(f"event {e.event_id} has no target")
            it = Interaction(user=e.entity_id, item=e.target_entity_id,
                             t=e.event_time.timestamp(),
                             rating=(e.properties.get_opt("rating")
                                     if e.event == "rate" else None))
            (rates if e.event == "rate" else views).append(it)

        if self.dsp.requireSetUsers:
            users = {eid: None for eid in store.aggregate_properties(
                self.dsp.appName, "user", storage=storage)}
        else:
            # no-set-user: the interaction log IS the user universe
            users = {it.user: None for it in (*views, *rates)}
        return VTrainingData(users=users, items=items, views=views,
                             rates=rates)


@dataclass(frozen=True)
class VALSParams(Params):
    rank: int = 10
    numIterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None

    JSON_ALIASES = {"lambda": "lambda_"}


@dataclass
class VModel:
    item_factors: np.ndarray      # (n_items, r), rows L2-normalized
    item_vocab: BiMap
    items: Dict[int, VItem]
    trained: np.ndarray           # (n_items,) bool
    category_masks: Dict[str, np.ndarray] = None
    years: np.ndarray = None      # (n_items,) int32 (valid where has_year)
    has_year: np.ndarray = None   # (n_items,) bool


class VALSAlgorithm(Algorithm):
    """Rate events (latest wins, explicit ALS) when present, else views
    (implicit ALS) — the add-rateevent switch on the base template."""

    params_class = VALSParams
    query_class = VQuery

    def __init__(self, params: VALSParams = None):
        self.ap = params or VALSParams()

    def train(self, ctx, data: VTrainingData) -> VModel:
        user_vocab = BiMap.string_int(data.users.keys())
        item_vocab = BiMap.string_int(data.items.keys())
        explicit = bool(data.rates)
        signal: Dict[Tuple[int, int], Tuple[float, float]] = {}
        source = data.rates if explicit else data.views
        for it in source:
            u, i = user_vocab.get(it.user), item_vocab.get(it.item)
            if u is None or i is None:
                continue
            if explicit:
                r = float(it.rating if it.rating is not None else 0.0)
                prev = signal.get((u, i))
                if prev is None or it.t > prev[1]:
                    signal[(u, i)] = (r, it.t)    # latest rating wins
            else:
                prev = signal.get((u, i), (0.0, 0.0))
                signal[(u, i)] = (prev[0] + 1.0, it.t)   # view counts sum
        if not signal:
            raise ValueError(
                "mllibRatings cannot be empty. Please check if your events "
                "contain valid user and item ID.")
        keys = np.asarray(list(signal.keys()), dtype=np.int32)
        vals = np.asarray([v[0] for v in signal.values()], dtype=np.float32)
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            prepared = als.prepare_ratings(
                keys[:, 0], keys[:, 1], vals,
                n_users=len(user_vocab), n_items=len(item_vocab),
                on_device=True, device=dev)
        train = als.train_explicit if explicit else als.train_implicit
        kw = {} if explicit else {"alpha": 1.0}
        _, V = train(prepared, rank=self.ap.rank,
                     iterations=self.ap.numIterations,
                     lambda_=self.ap.lambda_, seed=int(seed), device=dev,
                     **kw)
        V = V.cpu().numpy()
        norms = np.linalg.norm(V, axis=1)
        trained = np.zeros(len(item_vocab), dtype=bool)
        trained[np.unique(keys[:, 1])] = True
        V = V / np.where(norms > 0, norms, 1.0)[:, None]
        items = {item_vocab(iid): item for iid, item in data.items.items()}
        years = np.zeros(len(item_vocab), dtype=np.int32)
        has_year = np.zeros(len(item_vocab), dtype=bool)
        for ix, item in items.items():
            if item.year is not None:
                years[ix] = item.year
                has_year[ix] = True
        return VModel(item_factors=V, item_vocab=item_vocab, items=items,
                      trained=trained,
                      category_masks=build_category_masks(
                          items, len(item_vocab)),
                      years=years, has_year=has_year)

    def predict(self, model: VModel, query: VQuery) -> VPredictedResult:
        vocab = model.item_vocab
        # untrained anchors are dropped like the base template's
        # productFeatures.get (a cold anchor would contribute a zero —
        # or garbage — vector to the query sum)
        query_ix = sorted(
            {vocab.get(i) for i in query.items} - {None},
        )
        query_ix = [ix for ix in query_ix if model.trained[ix]]
        if not query_ix:
            return VPredictedResult(())
        qv = model.item_factors[np.asarray(query_ix)].sum(axis=0)
        scores = model.item_factors @ qv       # summed cosines

        white = ({ix for ix in (vocab.get(i) for i in query.whiteList)
                  if ix is not None}
                 if query.whiteList is not None else None)
        black = {ix for ix in (vocab.get(i) for i in (query.blackList or ()))
                 if ix is not None}
        mask = candidate_mask(
            len(vocab), model.trained, model.category_masks or {},
            query.categories, white, black, set(query_ix))
        if query.recommendFromYear is not None:
            # year > recommendFromYear (filterbyyear ALSAlgorithm.scala:248;
            # its Item.year is mandatory — here an item WITHOUT a year
            # fails any year-filtered query, tracked by a boolean so a
            # literal year=0 property is not mistaken for "no year")
            mask &= model.has_year & \
                (model.years > query.recommendFromYear)

        vals, idx = host_topk(np.where(mask & (scores > 0), scores,
                                       -np.inf), query.num)
        inv = vocab.inverse()
        out = []
        for v, ix in zip(vals, idx):
            if not np.isfinite(v):
                continue
            item = model.items.get(int(ix))
            out.append(VItemScore(
                item=inv(int(ix)), score=float(v),
                title=item.title if item else None,
                date=item.date if item else None,
                year=item.year if item else None))
        return VPredictedResult(itemScores=tuple(out))


def engine() -> Engine:
    return Engine(VDataSource, IdentityPreparator,
                  {"als": VALSAlgorithm}, FirstServing)
