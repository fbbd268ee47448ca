"""Friend recommendation: keyword similarity + SimRank (port of
``predictionio_tpu/examples/friend_recommendation.py``).

Parity: examples/experimental/scala-local-friend-recommendation
(KeywordSimilarityAlgorithm, RandomAlgorithm, the KDD-Cup-2012 file
formats) and scala-parallel-friend-recommendation (SimRankAlgorithm /
DeltaSimRankRDD).

Keyword maps are scattered into dense rows of a (n, vocab) matrix so one
matmul scores any user against any/all items; SimRank's
delta-propagation over Spark RDDs becomes the matrix fixed point
``S' = c · Wᵀ S W`` (W = column-normalized adjacency, diagonal pinned to
1), each iteration two (n, n) fp32 matmuls (TF32 off) on the context's
device, the card unless the caller asks for the CPU, instead of an RDD
cartesian shuffle. The random baseline draws from an explicit numpy
generator seeded by (model, user, item), as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    DataSource, FirstServing, IdentityPreparator, Params, SimpleEngine,
)
from predictionio_tpu_torch.controller.base import Algorithm


@dataclass(frozen=True)
class FriendRecommendationDataSourceParams(Params):
    itemFilePath: str
    userKeywordFilePath: str
    userActionFilePath: str


@dataclass(frozen=True)
class FriendRecommendationQuery:
    user: int
    item: int


@dataclass
class FriendRecommendationPrediction:
    confidence: float
    acceptance: bool


@dataclass
class FriendRecommendationTrainingData:
    user_id_map: Dict[int, int]              # external -> internal
    item_id_map: Dict[int, int]
    user_keyword: List[Dict[int, float]]     # internal idx -> {kw: weight}
    item_keyword: List[Dict[int, float]]
    adj: List[List[int]]                     # internal src -> [dst, ...]


class FriendRecommendationDataSource(DataSource):
    """KDD-Cup file formats (FriendRecommendationDataSource.scala):

    - item file: ``id <cat> kw;kw;kw`` (keywords weight 1.0)
    - user keyword file: ``id kw:weight;kw:weight``
    - action file: ``src dst a b c`` (edge weight = a+b+c)
    """

    params_class = FriendRecommendationDataSourceParams

    def __init__(self, params: FriendRecommendationDataSourceParams):
        self.dsp = params

    @staticmethod
    def _read_items(path):
        id_map: Dict[int, int] = {}
        keyword: List[Dict[int, float]] = []
        with open(path) as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keyword)
                keyword.append({int(t): 1.0 for t in data[2].split(";")})
        return id_map, keyword

    @staticmethod
    def _read_users(path):
        id_map: Dict[int, int] = {}
        keyword: List[Dict[int, float]] = []
        with open(path) as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keyword)
                kw: Dict[int, float] = {}
                for tw in data[1].split(";"):
                    t, w = tw.split(":")
                    kw[int(t)] = float(w)
                keyword.append(kw)
        return id_map, keyword

    @staticmethod
    def _read_relationship(path, n_users, user_id_map):
        # action-count columns (data[2:5]) are parsed and dropped: the
        # reference carries their sum in the adjacency but every consumer
        # (SimRank included) walks the graph unweighted
        adj: List[List[int]] = [[] for _ in range(n_users)]
        with open(path) as f:
            for line in f:
                data = [int(x) for x in line.split()]
                if not data:
                    continue
                if data[0] in user_id_map and data[1] in user_id_map:
                    adj[user_id_map[data[0]]].append(user_id_map[data[1]])
        return adj

    def read_training(self, ctx) -> FriendRecommendationTrainingData:
        item_id_map, item_kw = self._read_items(self.dsp.itemFilePath)
        user_id_map, user_kw = self._read_users(self.dsp.userKeywordFilePath)
        adj = self._read_relationship(self.dsp.userActionFilePath,
                                      len(user_kw), user_id_map)
        return FriendRecommendationTrainingData(
            user_id_map=user_id_map, item_id_map=item_id_map,
            user_keyword=user_kw, item_keyword=item_kw, adj=adj)


def _dense_rows(maps: List[Dict[int, float]], vocab: Dict[int, int],
                dtype=np.float32) -> np.ndarray:
    """Scatter sparse keyword maps into dense (n, |vocab|) rows."""
    out = np.zeros((len(maps), len(vocab)), dtype=dtype)
    for r, kw in enumerate(maps):
        for t, w in kw.items():
            c = vocab.get(t)
            if c is not None:
                out[r, c] = w
    return out


@dataclass
class KeywordSimilarityModel:
    user_id_map: Dict[int, int]
    item_id_map: Dict[int, int]
    user_rows: np.ndarray        # (n_users, vocab)
    item_rows: np.ndarray        # (n_items, vocab)
    keyword_sim_weight: float
    keyword_sim_threshold: float


class KeywordSimilarityAlgorithm(Algorithm):
    """Sparse-dot keyword similarity (KeywordSimilarityAlgorithm.scala).

    The reference keeps HashMaps and folds one pair at a time; here both
    sides live as dense vocab rows so `predict` is one row dot and scoring
    a user against ALL items is one (1, vocab) x (vocab, n_items) matmul.
    """

    def __init__(self, params=None):
        pass

    def train(self, ctx,
              td: FriendRecommendationTrainingData) -> KeywordSimilarityModel:
        vocab: Dict[int, int] = {}
        for kw in (*td.user_keyword, *td.item_keyword):
            for t in kw:
                vocab.setdefault(t, len(vocab))
        return KeywordSimilarityModel(
            user_id_map=td.user_id_map, item_id_map=td.item_id_map,
            user_rows=_dense_rows(td.user_keyword, vocab),
            item_rows=_dense_rows(td.item_keyword, vocab),
            keyword_sim_weight=1.0, keyword_sim_threshold=1.0)

    def predict(self, model: KeywordSimilarityModel,
                query: FriendRecommendationQuery
                ) -> FriendRecommendationPrediction:
        if (query.user in model.user_id_map
                and query.item in model.item_id_map):
            u = model.user_rows[model.user_id_map[query.user]]
            i = model.item_rows[model.item_id_map[query.item]]
            confidence = float(u @ i)
        else:
            confidence = 0.0       # unseen => empty map (reference behavior)
        acceptance = (confidence * model.keyword_sim_weight
                      >= model.keyword_sim_threshold)
        return FriendRecommendationPrediction(confidence, acceptance)

    @property
    def query_class(self):
        return FriendRecommendationQuery


class RandomAlgorithm(Algorithm):
    """Seeded uniform confidence (RandomAlgorithm.scala): the sanity
    baseline any real algorithm must beat."""

    def __init__(self, params=None):
        pass

    def train(self, ctx, td: FriendRecommendationTrainingData) -> int:
        return len(td.user_id_map)    # model is just a seed salt

    def predict(self, model: int, query: FriendRecommendationQuery
                ) -> FriendRecommendationPrediction:
        rng = np.random.default_rng(
            (model, query.user, query.item))
        confidence = float(rng.random())
        return FriendRecommendationPrediction(confidence, confidence >= 0.5)

    @property
    def query_class(self):
        return FriendRecommendationQuery


@dataclass(frozen=True)
class SimRankAlgorithmParams(Params):
    numIterations: int = 5
    decay: float = 0.8


@dataclass
class SimRankModel:
    user_id_map: Dict[int, int]
    scores: np.ndarray           # (n, n) SimRank matrix


class SimRankAlgorithm(Algorithm):
    """Matrix-form SimRank on the user graph (SimRankAlgorithm.scala /
    DeltaSimRankRDD.compute). ``S_{k+1} = c · Wᵀ S_k W``, diagonal pinned
    to 1, W the column-normalized adjacency — two matmuls per iteration
    on the device in place of the reference's per-delta RDD cartesian
    products.
    """

    params_class = SimRankAlgorithmParams

    def __init__(self, params: SimRankAlgorithmParams = None):
        self.ap = params or SimRankAlgorithmParams()

    def train(self, ctx, td: FriendRecommendationTrainingData) -> SimRankModel:
        dev = device_mod.resolve(getattr(ctx, "device", None))
        n = len(td.user_id_map)
        a = np.zeros((n, n), dtype=np.float32)
        for src, edges in enumerate(td.adj):
            for dst in edges:
                a[src, dst] = 1.0
        indeg = a.sum(axis=0)
        w = torch.as_tensor(
            (a / np.where(indeg > 0, indeg, 1.0)[None, :]).astype(
                np.float32), device=dev)
        c = torch.tensor(self.ap.decay, dtype=torch.float32, device=dev)
        eye = torch.eye(n, dtype=torch.float32, device=dev)
        s = eye
        for _ in range(self.ap.numIterations):
            s = c * (w.T @ s @ w)
            # diagonal is identically 1 (a node is maximally similar to
            # itself)
            s = s * (1.0 - eye) + eye
        return SimRankModel(user_id_map=td.user_id_map,
                            scores=s.cpu().numpy())

    def predict(self, model: SimRankModel,
                query: FriendRecommendationQuery
                ) -> FriendRecommendationPrediction:
        u = model.user_id_map.get(query.user)
        v = model.user_id_map.get(query.item)   # item = candidate friend
        if u is None or v is None:
            return FriendRecommendationPrediction(0.0, False)
        s = float(model.scores[u, v])
        return FriendRecommendationPrediction(s, s > 0.0)

    @property
    def query_class(self):
        return FriendRecommendationQuery


def keyword_engine() -> SimpleEngine:
    """KeywordSimilarityEngineFactory.scala."""
    return SimpleEngine(FriendRecommendationDataSource, IdentityPreparator,
                        KeywordSimilarityAlgorithm, FirstServing)


def random_engine() -> SimpleEngine:
    """RandomEngineFactory.scala."""
    return SimpleEngine(FriendRecommendationDataSource, IdentityPreparator,
                        RandomAlgorithm, FirstServing)


def simrank_engine() -> SimpleEngine:
    """scala-parallel-friend-recommendation Engine.scala."""
    return SimpleEngine(FriendRecommendationDataSource, IdentityPreparator,
                        SimRankAlgorithm, FirstServing)
