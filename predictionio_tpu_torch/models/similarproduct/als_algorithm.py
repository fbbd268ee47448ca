"""ALSAlgorithm: implicit ALS item vectors on the card, host cosine top-K
(port of ``predictionio_tpu/models/similarproduct/als_algorithm.py``).

Parity: scala-parallel-similarproduct/multi/src/main/scala/
ALSAlgorithm.scala (train :57-120, predict :122-160, cosine :214-231,
isCandidateItem :233+) and LikeAlgorithm.scala (like/dislike ratings,
latest event wins).

Training lays the ratings out on the context's device (the card unless
the caller asks for the CPU) and runs ``ops.als.train_implicit``, whose
half-steps each end in kernel A; the item factors then come to the host
once and are L2-normalized there. Serving is host numpy, as the
reference serves this template: with rows pre-normalized, the sum of
cosines against the query items is one matvec ``V_hat @ sum(q_hat)``,
then the candidate mask and ``ops.topk.host_masked_topk``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.similarproduct.data_source import (
    TrainingData,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    Item, ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.ops import als, topk

logger = logging.getLogger("predictionio_tpu_torch.similarproduct")


def topk_to_result(model, query_vec, mask: "np.ndarray",
                   num: int) -> PredictedResult:
    """Masked host top-K -> PredictedResult, dropping scores <= 0
    (the reference keeps only positive scores, ALSAlgorithm.scala:167)."""
    if not mask.any():
        return PredictedResult(())
    k = min(num, mask.shape[0])
    vals, idx = topk.host_masked_topk(model.product_features, query_vec,
                                      mask, k)
    inv = model.item_vocab.inverse()
    return PredictedResult(tuple(
        ItemScore(item=inv(int(ix)), score=float(s))
        for s, ix in zip(vals, idx) if s > 0 and np.isfinite(s)))


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None

    JSON_ALIASES = {"lambda": "lambda_"}


@dataclass
class ALSModel:
    """productFeatures + itemStringIntMap + items (ALSModel,
    ALSAlgorithm.scala:31-55). `trained_mask` excludes items with no
    interactions — the analogue of ids absent from MLlib's
    productFeatures RDD. `category_masks` indexes items by category so
    query-time filters are boolean vector ops, not per-item Python."""
    product_features: "np.ndarray"      # (n_items, rank)
    item_vocab: BiMap
    items: Dict[int, Item]              # int index -> Item
    trained_mask: "np.ndarray"          # (n_items,) bool
    category_masks: Dict[str, "np.ndarray"] = None

    def __str__(self) -> str:
        return (f"ALSModel(productFeatures: [{len(self.items)}], "
                f"itemStringIntMap: [{len(self.item_vocab)}])")


def build_category_masks(items: Dict[int, Item],
                         n_items: int) -> Dict[str, np.ndarray]:
    masks: Dict[str, np.ndarray] = {}
    for ix, item in items.items():
        for cat in item.categories or ():
            masks.setdefault(cat, np.zeros(n_items, dtype=bool))[ix] = True
    return masks


def candidate_mask(n_items: int,
                   trained: np.ndarray,
                   category_masks: Dict[str, np.ndarray],
                   categories,
                   white: Optional[set],
                   black: set,
                   exclude: set) -> np.ndarray:
    """isCandidateItem as one boolean vector (ALSAlgorithm.scala:233+),
    host numpy."""
    mask = np.array(trained, dtype=bool)
    if categories is not None:
        cat_mask = np.zeros(n_items, dtype=bool)
        for c in categories:
            m = category_masks.get(c)
            if m is not None:
                cat_mask |= np.asarray(m)
        mask &= cat_mask
    if white is not None:
        white_mask = np.zeros(n_items, dtype=bool)
        white_mask[sorted(white)] = True
        mask &= white_mask
    for ix in black | exclude:
        mask[ix] = False
    return mask


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    def __init__(self, params: ALSAlgorithmParams):
        self.ap = params

    # ------------------------------------------------------------- training
    def _ratings(self, data: TrainingData, user_vocab: BiMap,
                 item_vocab: BiMap):
        """view events -> (u, i, count) implicit ratings
        (ALSAlgorithm.scala:80-103: duplicate views aggregate by sum)."""
        if not data.view_events:
            raise ValueError(
                "viewEvents in PreparedData cannot be empty. Please check "
                "if DataSource generates TrainingData correctly.")
        counts: Dict[Tuple[int, int], float] = {}
        for v in data.view_events:
            u, i = user_vocab.get(v.user), item_vocab.get(v.item)
            if u is None:
                logger.info("Couldn't convert nonexistent user ID %s", v.user)
                continue
            if i is None:
                logger.info("Couldn't convert nonexistent item ID %s", v.item)
                continue
            counts[(u, i)] = counts.get((u, i), 0.0) + 1.0
        return counts

    def train(self, ctx, data: TrainingData) -> ALSModel:
        if not data.users:
            raise ValueError("users in PreparedData cannot be empty.")
        if not data.items:
            raise ValueError("items in PreparedData cannot be empty.")
        user_vocab = BiMap.string_int(data.users.keys())
        item_vocab = BiMap.string_int(data.items.keys())
        ratings = self._ratings(data, user_vocab, item_vocab)
        if not ratings:
            raise ValueError(
                "ratings cannot be empty. Please check if your events "
                "contain valid user and item ID.")
        u_idx = np.array([u for u, _ in ratings], dtype=np.int32)
        i_idx = np.array([i for _, i in ratings], dtype=np.int32)
        vals = np.array(list(ratings.values()), dtype=np.float32)
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            prepared = als.prepare_ratings(
                u_idx, i_idx, vals, n_users=len(user_vocab),
                n_items=len(item_vocab), on_device=True, device=dev)
        _U, V = als.train_implicit(
            prepared, rank=self.ap.rank, iterations=self.ap.numIterations,
            lambda_=self.ap.lambda_, alpha=1.0, seed=int(seed), device=dev)
        trained = np.zeros(len(item_vocab), dtype=bool)
        trained[np.unique(i_idx)] = True
        items = {item_vocab(k): v for k, v in data.items.items()}
        # one copy to the host, then pre-normalize: sum-of-cosines per
        # item is one matvec
        V = V.cpu().numpy()
        V_hat = V / np.maximum(
            np.linalg.norm(V, axis=1, keepdims=True), 1e-12)
        return ALSModel(product_features=V_hat, item_vocab=item_vocab,
                        items=items, trained_mask=trained,
                        category_masks=build_category_masks(
                            items, len(item_vocab)))

    # ------------------------------------------------------------ serving
    def _plan(self, model: ALSModel, query: Query):
        """Per-query host prep shared by predict and predict_batch: encode
        the query items, build the sum-of-normalized-vectors query vector
        and the candidate mask. None when no query item has a trained
        vector (the reference's empty-result path)."""
        query_ixs = {model.item_vocab.get(i) for i in query.items}
        query_ixs.discard(None)
        query_ixs = {ix for ix in query_ixs if model.trained_mask[ix]}
        if not query_ixs:
            logger.info("No productFeatures vector for query items %s.",
                        query.items)
            return None
        V_hat = np.asarray(model.product_features)
        q = np.sum(V_hat[sorted(query_ixs)], axis=0)
        mask = candidate_mask(
            n_items=len(model.item_vocab),
            trained=model.trained_mask,
            category_masks=model.category_masks or {},
            categories=query.categories,
            white=self._encode_set(model, query.whiteList),
            black=self._encode_set(model, query.blackList) or set(),
            exclude=query_ixs,
        )
        return q, mask

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        """Sum-of-cosines against the query items' vectors, filtered and
        top-K'd on the host (the reference's productFeatures scan,
        ALSAlgorithm.scala:122-212): with rows pre-normalized,
        sum_q cos(q, v) == V_hat @ sum(q_hat)."""
        plan = self._plan(model, query)
        if plan is None:
            return PredictedResult(())
        q, mask = plan
        return topk_to_result(model, q, mask, query.num)

    def predict_batch(self, model: ALSModel,
                      queries) -> List[PredictedResult]:
        """Serving micro-batch: the per-query matvec becomes ONE
        (B, rank) @ (rank, n_items) BLAS matmul over the stacked query
        vectors; masking/top-K/positive-score filtering stay per row,
        identical to predict()'s pipeline."""
        queries = list(queries)
        out: List[Optional[PredictedResult]] = [None] * len(queries)
        plans = []
        for qx, query in enumerate(queries):
            plan = self._plan(model, query)
            if plan is None or not plan[1].any():
                out[qx] = PredictedResult(())
            else:
                plans.append((qx, query, plan))
        if not plans:
            return out
        rows = topk.host_masked_topk_batch(
            model.product_features,
            np.stack([q for _qx, _query, (q, _m) in plans]),
            [m for _qx, _query, (_q, m) in plans],
            [min(query.num, m.shape[0])
             for _qx, query, (_q, m) in plans])
        inv = model.item_vocab.inverse()
        for (qx, _query, _plan), (vals, idx) in zip(plans, rows):
            out[qx] = PredictedResult(tuple(
                ItemScore(item=inv(int(ix)), score=float(s))
                for s, ix in zip(vals, idx) if s > 0 and np.isfinite(s)))
        return out

    @staticmethod
    def _encode_set(model: ALSModel, names) -> Optional[set]:
        if names is None:
            return None
        out = {model.item_vocab.get(n) for n in names}
        out.discard(None)
        return out


class LikeAlgorithm(ALSAlgorithm):
    """Trains on like/dislike events: per (user, item) the LATEST event
    wins; like -> 1, dislike -> -1 (LikeAlgorithm.scala:25-80)."""

    def _ratings(self, data: TrainingData, user_vocab: BiMap,
                 item_vocab: BiMap):
        if not data.like_events:
            raise ValueError(
                "likeEvents in PreparedData cannot be empty. Please check "
                "if DataSource generates TrainingData correctly.")
        latest: Dict[Tuple[int, int], Tuple[float, bool]] = {}
        for ev in data.like_events:
            u, i = user_vocab.get(ev.user), item_vocab.get(ev.item)
            if u is None or i is None:
                continue
            cur = latest.get((u, i))
            if cur is None or ev.t > cur[0]:
                latest[(u, i)] = (ev.t, ev.like)
        return {k: (1.0 if like else -1.0)
                for k, (_t, like) in latest.items()}
