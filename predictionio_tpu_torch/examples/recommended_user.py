"""Recommended-user engine: similar USERS from follow events (port of
``predictionio_tpu/examples/recommended_user.py``).

Parity: examples/scala-parallel-similarproduct/recommended-user
(DataSource.scala — `follow` user→user events; ALSAlgorithm.scala —
implicit ALS over (follower, followed) pairs; Engine.scala — Query of
seed users → top similar users by cosine over followed-user features,
query users excluded, white/black lists). Implicit ALS trains on the
context's device (the card unless the caller asks for the CPU), each
half-step ending in kernel A; the followed-side factors then come to
the host once, and the cosine scoring over the whole user set is one
host matvec against them, then a host top-k.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource as BaseDataSource, Engine, FirstServing, IdentityPreparator,
    Params,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.topk import host_topk


@dataclass(frozen=True)
class RUQuery:
    users: Tuple[str, ...]
    num: int
    whiteList: Optional[Tuple[str, ...]] = None
    blackList: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        for f in ("users", "whiteList", "blackList"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))


@dataclass(frozen=True)
class SimilarUserScore:
    user: str
    score: float


@dataclass(frozen=True)
class RUPredictedResult:
    similarUserScores: Tuple[SimilarUserScore, ...] = ()


@dataclass(frozen=True)
class FollowEvent:
    user: str
    followed_user: str


@dataclass
class RUTrainingData:
    users: Dict[str, None]
    follow_events: List[FollowEvent]


@dataclass(frozen=True)
class RUDataSourceParams(Params):
    appName: str


class RUDataSource(BaseDataSource):
    """$set users + follow user→user events (DataSource.scala there)."""

    params_class = RUDataSourceParams

    def __init__(self, params: RUDataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> RUTrainingData:
        storage = getattr(ctx, "storage", None)
        users = {eid: None for eid in store.aggregate_properties(
            self.dsp.appName, "user", storage=storage)}
        follows = []
        for e in store.find(self.dsp.appName, entity_type="user",
                            event_names=["follow"],
                            target_entity_type="user", storage=storage):
            if e.target_entity_id is None:
                raise ValueError(f"follow event {e.event_id} has no target")
            follows.append(FollowEvent(user=e.entity_id,
                                       followed_user=e.target_entity_id))
        return RUTrainingData(users=users, follow_events=follows)


@dataclass(frozen=True)
class RUALSParams(Params):
    rank: int = 10
    numIterations: int = 10
    lambda_: float = 0.01
    seed: Optional[int] = None


@dataclass
class RUModel:
    user_vocab: BiMap                 # user id -> index (both roles)
    followed_factors: np.ndarray      # (n_users, r) "similar user" features


class RUALSAlgorithm(Algorithm):
    """Implicit ALS over deduped (follower, followed) counts
    (ALSAlgorithm.scala there: count 1 per pair, trainImplicit). The
    followed-side factors are the similarity embedding."""

    params_class = RUALSParams
    query_class = RUQuery

    def __init__(self, params: RUALSParams = None):
        self.ap = params or RUALSParams()

    def train(self, ctx, data: RUTrainingData) -> RUModel:
        if not data.users:
            raise ValueError(
                "users in PreparedData cannot be empty. Please check if "
                "DataSource generates TrainingData correctly.")
        vocab = BiMap.string_int(data.users.keys())
        pairs: Dict[Tuple[int, int], float] = {}
        for fe in data.follow_events:
            u, v = vocab.get(fe.user), vocab.get(fe.followed_user)
            if u is None or v is None:
                continue
            pairs[(u, v)] = 1.0        # dedup: one follow per pair
        if not pairs:
            raise ValueError(
                "mllibRatings cannot be empty. Please check if your events "
                "contain valid user and followedUser ID.")
        keys = np.asarray(list(pairs.keys()), dtype=np.int32)
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        n = len(vocab)
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            prepared = als.prepare_ratings(
                keys[:, 0], keys[:, 1],
                np.ones(keys.shape[0], dtype=np.float32),
                n_users=n, n_items=n, on_device=True, device=dev)
        _, followed = als.train_implicit(
            prepared, rank=self.ap.rank, iterations=self.ap.numIterations,
            lambda_=self.ap.lambda_, alpha=1.0, seed=int(seed), device=dev)
        return RUModel(user_vocab=vocab,
                       followed_factors=followed.cpu().numpy())

    def predict(self, model: RUModel, query: RUQuery) -> RUPredictedResult:
        vocab = model.user_vocab
        seed_ix = [vocab.get(u) for u in query.users]
        seed_ix = [i for i in seed_ix if i is not None]
        if not seed_ix:
            return RUPredictedResult(())
        F = model.followed_factors
        norms = np.linalg.norm(F, axis=1)
        norms = np.where(norms > 0, norms, 1.0)
        Fn = F / norms[:, None]
        # aggregate cosine over the seed basket (reference sums per-seed
        # cosines)
        agg = Fn @ Fn[np.asarray(seed_ix)].sum(axis=0)

        eligible = np.ones(agg.shape[0], dtype=bool)
        eligible[np.asarray(seed_ix)] = False
        if query.whiteList is not None:
            white = np.zeros_like(eligible)
            for u in query.whiteList:
                ix = vocab.get(u)
                if ix is not None:
                    white[ix] = True
            eligible &= white
        if query.blackList is not None:
            for u in query.blackList:
                ix = vocab.get(u)
                if ix is not None:
                    eligible[ix] = False
        agg = np.where(eligible & (agg > 0), agg, -np.inf)
        vals, idx = host_topk(agg, query.num)
        inv = vocab.inverse()
        return RUPredictedResult(similarUserScores=tuple(
            SimilarUserScore(user=inv(int(i)), score=float(v))
            for v, i in zip(vals, idx) if np.isfinite(v)))


def engine() -> Engine:
    """RecommendedUserEngine (Engine.scala there)."""
    return Engine(RUDataSource, IdentityPreparator,
                  {"als": RUALSAlgorithm}, FirstServing)
