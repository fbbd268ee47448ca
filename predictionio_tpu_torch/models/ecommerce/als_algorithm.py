"""ECommAlgorithm: explicit ALS on the card + live business-rule
filtering at serve time (port of
``predictionio_tpu/models/ecommerce/als_algorithm.py``).

Parity: scala-parallel-ecommercerecommendation/train-with-rate-event/src/
main/scala/ALSAlgorithm.scala — train :49-131 (rate events, latest value
per (user, item) wins, ALS.train); predict :133-260 (seen-events and
unavailable-items constraints read LIVE from the event store per query,
known users score by U[u] . V, unknown users by similarity to their
recent views).

Training lays the ratings out on the context's device (the card unless
the caller asks for the CPU) and runs ``ops.als.train_explicit``, whose
half-steps each end in kernel A; both factor sides then come to the host
once. Serving is host numpy, as in the reference: one masked matvec and
``ops.topk.host_masked_topk``, with the business-rule lookups read
through the store that ``bind_serving`` captured. A failed lookup serves
without its rule and flags the answer degraded
(:mod:`predictionio_tpu_torch.common.resilience`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import resilience
from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.ecommerce.data_source import TrainingData
from predictionio_tpu_torch.models.ecommerce.engine import (
    Item, ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
    build_category_masks, candidate_mask,
)
from predictionio_tpu_torch.ops import als, topk

logger = logging.getLogger("predictionio_tpu_torch.ecommerce")


@dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    """ALSAlgorithmParams (:33-41): appName (was appId), unseenOnly,
    seenEvents, similarEvents, rank, numIterations, lambda, seed."""
    appName: str
    unseenOnly: bool = False
    seenEvents: Tuple[str, ...] = ("buy", "view")
    similarEvents: Tuple[str, ...] = ("view",)
    rank: int = 10
    numIterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None
    #: weighted-items variant: live $set constraint/weightedItems boosts
    #: (weighted-items/ALSAlgorithm.scala:234-261). Off by default — the
    #: base reference template has a two-lookup hot path, and this adds an
    #: event-store point read (plus an O(n_items) weight vector when the
    #: constraint exists) per query. Opt in via engine.json.
    weightedItems: bool = False

    JSON_ALIASES = {"lambda": "lambda_"}

    def __post_init__(self):
        for f in ("seenEvents", "similarEvents"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


@dataclass
class ECommModel:
    """ALSModel (:43-67): both factor sides (host numpy) + vocabs + item
    metadata; trained masks play the role of Option[Array] feature
    rows."""
    rank: int
    user_features: "np.ndarray"     # (n_users, rank)
    product_features: "np.ndarray"  # (n_items, rank)
    user_vocab: BiMap
    item_vocab: BiMap
    items: Dict[int, Item]
    user_trained: "np.ndarray"      # (n_users,) bool
    item_trained: "np.ndarray"      # (n_items,) bool
    category_masks: Dict[str, "np.ndarray"] = None
    product_features_hat: "np.ndarray" = None   # L2-normalized rows


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams
    query_class = Query

    def __init__(self, params: ECommAlgorithmParams):
        self.ap = params

    # ------------------------------------------------------------- training
    def train(self, ctx, data: TrainingData) -> ECommModel:
        if not data.rate_events:
            raise ValueError("rateEvents in PreparedData cannot be empty.")
        if not data.users:
            raise ValueError("users in PreparedData cannot be empty.")
        if not data.items:
            raise ValueError("items in PreparedData cannot be empty.")
        user_vocab = BiMap.string_int(data.users.keys())
        item_vocab = BiMap.string_int(data.items.keys())
        # latest rating per (user, item) wins (:76-97)
        latest: Dict[Tuple[int, int], Tuple[float, float]] = {}
        for r in data.rate_events:
            u, i = user_vocab.get(r.user), item_vocab.get(r.item)
            if u is None:
                logger.info("Couldn't convert nonexistent user ID %s", r.user)
                continue
            if i is None:
                logger.info("Couldn't convert nonexistent item ID %s", r.item)
                continue
            cur = latest.get((u, i))
            if cur is None or r.t > cur[0]:
                latest[(u, i)] = (r.t, r.rating)
        if not latest:
            raise ValueError(
                "ratings cannot be empty. Please check if your events "
                "contain valid user and item ID.")
        u_idx = np.array([u for u, _ in latest], dtype=np.int32)
        i_idx = np.array([i for _, i in latest], dtype=np.int32)
        vals = np.array([v for _t, v in latest.values()], dtype=np.float32)
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            prepared = als.prepare_ratings(
                u_idx, i_idx, vals, n_users=len(user_vocab),
                n_items=len(item_vocab), on_device=True, device=dev)
        U, V = als.train_explicit(
            prepared, rank=self.ap.rank, iterations=self.ap.numIterations,
            lambda_=self.ap.lambda_, seed=int(seed), device=dev)
        user_trained = np.zeros(len(user_vocab), dtype=bool)
        user_trained[np.unique(u_idx)] = True
        item_trained = np.zeros(len(item_vocab), dtype=bool)
        item_trained[np.unique(i_idx)] = True
        items = {item_vocab(k): v for k, v in data.items.items()}
        V = V.cpu().numpy()
        V_hat = V / np.maximum(
            np.linalg.norm(V, axis=1, keepdims=True), 1e-12)
        return ECommModel(
            rank=self.ap.rank, user_features=U.cpu().numpy(),
            product_features=V,
            user_vocab=user_vocab, item_vocab=item_vocab, items=items,
            user_trained=user_trained, item_trained=item_trained,
            category_masks=build_category_masks(items, len(item_vocab)),
            product_features_hat=V_hat)

    # ---------------------------------------------------------- live lookups
    def bind_serving(self, ctx) -> None:
        """Capture the workflow's storage for serve-time lookups so deploy
        and eval read the same store training did, not the process-global
        singleton (Algorithm.bind_serving hook)."""
        self._serving_storage = getattr(ctx, "storage", None)

    @property
    def _storage(self):
        return getattr(self, "_serving_storage", None)

    def _seen_items(self, user: str) -> Set[str]:
        """Seen events for this user, queried live (:148-176) — via the
        columnar target-id fast path (no Event materialization)."""
        if not self.ap.unseenOnly:
            return set()
        try:
            return set(store.find_target_ids(
                app_name=self.ap.appName, entity_type="user",
                entity_id=user, event_names=list(self.ap.seenEvents),
                target_entity_type="item", storage=self._storage))
        except Exception as e:
            logger.error("Error when read seen events: %s", e)
            # fail soft: serve without the seen filter, flagged
            # `degraded: true` by the query server
            resilience.note_degraded(f"seen-events lookup failed: {e}")
            return set()

    def _unavailable_items(self) -> Set[str]:
        """Latest $set on constraint/unavailableItems (:178-200)."""
        try:
            events = store.find_by_entity(
                app_name=self.ap.appName, entity_type="constraint",
                entity_id="unavailableItems", event_names=["$set"],
                limit=1, latest=True, storage=self._storage)
        except Exception as e:
            logger.error("Error when read set unavailableItems event: %s", e)
            resilience.note_degraded(
                f"unavailableItems lookup failed: {e}")
            return set()
        if not events:
            return set()
        return set(events[0].properties.get_opt("items") or ())

    def _item_weights(self, model: "ECommModel") -> Optional[np.ndarray]:
        """Latest $set on constraint/weightedItems → per-item score
        multipliers, default 1.0 (the weighted-items template variant,
        weighted-items/ALSAlgorithm.scala:234-261: groups of
        {items: [...], weight: w} so business rules can boost or bury
        item groups without retraining)."""
        try:
            events = store.find_by_entity(
                app_name=self.ap.appName, entity_type="constraint",
                entity_id="weightedItems", event_names=["$set"],
                limit=1, latest=True, storage=self._storage)
        except Exception as e:
            logger.error("Error when reading set weightedItems event: %s", e)
            resilience.note_degraded(f"weightedItems lookup failed: {e}")
            return None
        if not events:
            return None
        groups = events[0].properties.get_opt("weights") or ()
        w: Optional[np.ndarray] = None
        for g in groups:
            try:
                items = g.get("items") or ()
                weight = float(g.get("weight", 1.0))
                if isinstance(items, str) or not hasattr(items, "__iter__"):
                    raise TypeError(f"items must be a list, got {items!r}")
                for item in items:
                    ix = model.item_vocab.get(item)
                    if ix is not None:
                        if w is None:
                            w = np.ones(len(model.item_vocab),
                                        dtype=np.float32)
                        w[ix] = weight
            except (AttributeError, TypeError, ValueError) as e:
                # a malformed group must not turn every query into a 500
                logger.error("Malformed WeightsGroup %r ignored: %s", g, e)
        return w

    # ------------------------------------------------------------- serving
    def _query_plan(self, model: ECommModel, query: Query):
        """Per-query business-rule prep shared by predict and
        predict_batch — the LIVE event-store lookups (seen events,
        unavailable items, recent views for unknown users) stay per query
        in both paths. Returns (query_vec, use_hat, mask) or None for the
        empty-result paths."""
        white = None
        if query.whiteList is not None:
            white = {model.item_vocab.get(x) for x in query.whiteList}
            white.discard(None)
        black_names = set(query.blackList or ())
        black_names |= self._seen_items(query.user)
        black_names |= self._unavailable_items()
        black = {model.item_vocab.get(x) for x in black_names}
        black.discard(None)

        user_ix = model.user_vocab.get(query.user)
        if user_ix is not None and model.user_trained[user_ix]:
            query_vec = np.asarray(model.user_features)[user_ix]
            use_hat = False
        else:
            logger.info("No userFeature found for user %s.", query.user)
            query_vec = self._recent_views_vector(model, query.user)
            if query_vec is None:
                return None
            use_hat = True
        mask = candidate_mask(
            n_items=len(model.item_vocab),
            trained=model.item_trained,
            category_masks=model.category_masks or {},
            categories=query.categories,
            white=white, black=black, exclude=set(),
        )
        if not mask.any():
            return None
        return query_vec, use_hat, mask

    def _rows_to_result(self, model: ECommModel, vals, idx) -> PredictedResult:
        inv = model.item_vocab.inverse()
        return PredictedResult(tuple(
            ItemScore(item=inv(int(ix)), score=float(s))
            for s, ix in zip(vals, idx) if s > 0 and np.isfinite(s)))

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        """Known users score U[u] . V; unknown users fall back to
        similarity with their recent views — both as one masked host
        top-K (:202-260)."""
        plan = self._query_plan(model, query)
        if plan is None:
            return PredictedResult(())
        query_vec, use_hat, mask = plan
        factors = model.product_features_hat if use_hat \
            else model.product_features
        k = min(query.num, mask.shape[0])
        weights = self._item_weights(model) if self.ap.weightedItems \
            else None
        vals, idx = topk.host_masked_topk(factors, query_vec, mask, k,
                                          weights=weights)
        return self._rows_to_result(model, vals, idx)

    def predict_batch(self, model: ECommModel,
                      queries) -> List[PredictedResult]:
        """Serving micro-batch: per-query business rules stay live (one
        event-store lookup chain per query, as in predict), but the
        scoring matvecs coalesce into one (B, rank) @ (rank, n_items)
        matmul per factor side (known users score against raw factors,
        unknown users against the normalized ones). weightedItems reads
        ONE constraint snapshot per batch rather than per query — within
        a flush every query sees the same weights, which is also the
        stronger consistency story."""
        queries = list(queries)
        out: List[Optional[PredictedResult]] = [None] * len(queries)
        weights = self._item_weights(model) if self.ap.weightedItems \
            else None
        groups: Dict[bool, list] = {False: [], True: []}
        for qx, query in enumerate(queries):
            plan = self._query_plan(model, query)
            if plan is None:
                out[qx] = PredictedResult(())
            else:
                query_vec, use_hat, mask = plan
                groups[use_hat].append((qx, query, query_vec, mask))
        for use_hat, group in groups.items():
            if not group:
                continue
            factors = model.product_features_hat if use_hat \
                else model.product_features
            rows = topk.host_masked_topk_batch(
                factors,
                np.stack([vec for _qx, _q, vec, _m in group]),
                [m for _qx, _q, _vec, m in group],
                [min(q.num, m.shape[0]) for _qx, q, _vec, m in group],
                weights=weights)
            for (qx, _q, _vec, _m), (vals, idx) in zip(group, rows):
                out[qx] = self._rows_to_result(model, vals, idx)
        return out

    def _recent_views_vector(self, model: ECommModel,
                             user: str) -> Optional[np.ndarray]:
        """New-user fallback query vector: sum of normalized vectors of the
        latest 10 similar-events items; against normalized factors this
        scores the sum of cosines (predictNewUser, :262-330)."""
        try:
            events = store.find_by_entity(
                app_name=self.ap.appName, entity_type="user", entity_id=user,
                event_names=list(self.ap.similarEvents),
                target_entity_type="item", limit=10, latest=True,
                storage=self._storage)
        except Exception as e:
            logger.error("Error when read recent events: %s", e)
            resilience.note_degraded(f"recent-events lookup failed: {e}")
            return None
        recent_ixs = {model.item_vocab.get(e.target_entity_id)
                      for e in events if e.target_entity_id is not None}
        recent_ixs.discard(None)
        recent_ixs = {ix for ix in recent_ixs if model.item_trained[ix]}
        if not recent_ixs:
            return None
        V_hat = np.asarray(model.product_features_hat)
        return np.sum(V_hat[sorted(recent_ixs)], axis=0)
