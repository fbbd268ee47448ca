"""RandomForestAlgorithm: the classification template's second algorithm
(port of ``predictionio_tpu/models/classification/random_forest.py``;
host numpy under ``np.random.default_rng(seed)``, copied, so equal seeds
give equal forests in both packages).

Parity: scala-parallel-classification/add-algorithm/src/main/scala/
RandomForestAlgorithm.scala (MLlib `RandomForest.trainClassifier` with
numClasses/numTrees/featureSubsetStrategy/impurity/maxDepth/maxBins) —
the tutorial whose whole point is that a second algorithm slots into the
engine's algorithm map next to "naive".

Tree induction is branchy, not matrix work — the reference runs it on
Spark executors; here each tree builds on the host with the split search
fully vectorized (one (samples x thresholds) histogram pass per feature).
The fitted forest is flattened to arrays (feature, threshold, left/right,
leaf label) so batch prediction is iterative numpy gathers, not Python
tree walks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.models.classification.data_source import (
    TrainingData,
)
from predictionio_tpu_torch.models.classification.engine import (
    PredictedResult, Query,
)


@dataclass(frozen=True)
class RandomForestAlgorithmParams(Params):
    """RandomForestAlgorithm.scala:26-33 parameter surface."""
    numClasses: int = 2
    numTrees: int = 10
    featureSubsetStrategy: str = "auto"   # auto | all | sqrt | log2
    impurity: str = "gini"                # gini | entropy
    maxDepth: int = 5
    maxBins: int = 32
    seed: Optional[int] = None


@dataclass
class _FlatTree:
    feature: np.ndarray      # (nodes,) int32, -1 = leaf
    threshold: np.ndarray    # (nodes,) float32 (x <= t goes left)
    left: np.ndarray         # (nodes,) int32 child index
    right: np.ndarray
    label: np.ndarray        # (nodes,) int32 majority class at node


@dataclass
class RandomForestModel:
    trees: List[_FlatTree]
    class_labels: Tuple[float, ...]   # class index -> original label


def _impurity(counts: np.ndarray, kind: str) -> np.ndarray:
    """counts (..., n_classes) -> impurity (...)."""
    total = counts.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = counts / np.where(total > 0, total, 1)
        if kind == "entropy":
            logp = np.where(p > 0, np.log2(np.where(p > 0, p, 1)), 0.0)
            return -(p * logp).sum(axis=-1)
        return 1.0 - (p * p).sum(axis=-1)     # gini


def _n_features_per_split(strategy: str, d: int, n_trees: int) -> int:
    if strategy == "auto":
        # MLlib: all for a single tree, sqrt for a forest
        strategy = "all" if n_trees == 1 else "sqrt"
    if strategy == "all":
        return d
    if strategy == "sqrt":
        return max(1, int(np.sqrt(d)))
    if strategy == "log2":
        return max(1, int(np.log2(d)))
    raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")


def _best_split(x: np.ndarray, y: np.ndarray, feats: np.ndarray,
                n_classes: int, max_bins: int, kind: str):
    """Vectorized split search: per candidate feature, class histograms on
    both sides of every quantile threshold in one broadcast pass.
    Returns (feature, threshold, gain) or None."""
    n = y.shape[0]
    onehot = np.zeros((n, n_classes), dtype=np.float64)
    onehot[np.arange(n), y] = 1.0
    parent = _impurity(onehot.sum(axis=0), kind)
    best = None
    for f in feats:
        col = x[:, f]
        qs = np.unique(np.quantile(
            col, np.linspace(0, 1, min(max_bins, n) + 1)[1:-1]))
        if qs.size == 0:
            continue
        goes_left = col[:, None] <= qs[None, :]          # (n, t)
        left_counts = np.einsum("nt,nc->tc", goes_left, onehot)
        right_counts = onehot.sum(axis=0)[None, :] - left_counts
        nl = left_counts.sum(axis=1)
        nr = right_counts.sum(axis=1)
        valid = (nl > 0) & (nr > 0)
        if not valid.any():
            continue
        child = (nl * _impurity(left_counts, kind)
                 + nr * _impurity(right_counts, kind)) / n
        gain = np.where(valid, parent - child, -np.inf)
        t = int(np.argmax(gain))
        if gain[t] > 0 and (best is None or gain[t] > best[2]):
            best = (int(f), float(qs[t]), float(gain[t]))
    return best


def _build_tree(x: np.ndarray, y: np.ndarray, n_classes: int,
                ap: RandomForestAlgorithmParams,
                rng: np.random.Generator) -> _FlatTree:
    feature, threshold, left, right, label = [], [], [], [], []
    k = _n_features_per_split(ap.featureSubsetStrategy, x.shape[1],
                              ap.numTrees)

    def node(idx: np.ndarray, depth: int) -> int:
        me = len(feature)
        counts = np.bincount(y[idx], minlength=n_classes)
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        label.append(int(np.argmax(counts)))
        if depth >= ap.maxDepth or np.count_nonzero(counts) <= 1:
            return me
        feats = rng.choice(x.shape[1], size=k, replace=False)
        split = _best_split(x[idx], y[idx], feats, n_classes,
                            ap.maxBins, ap.impurity)
        if split is None:
            return me
        f, t, _gain = split
        go_left = x[idx, f] <= t
        if not go_left.any() or go_left.all():
            return me
        feature[me] = f
        threshold[me] = t
        left[me] = node(idx[go_left], depth + 1)
        right[me] = node(idx[~go_left], depth + 1)
        return me

    node(np.arange(x.shape[0]), 0)
    return _FlatTree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        label=np.asarray(label, dtype=np.int32))


def _tree_predict(tree: _FlatTree, x: np.ndarray) -> np.ndarray:
    """Batch evaluation by iterative gathers: all rows advance one level
    per step (depth-bounded, no per-row Python walk)."""
    node = np.zeros(x.shape[0], dtype=np.int32)
    while True:
        f = tree.feature[node]
        active = f >= 0
        if not active.any():
            return tree.label[node]
        fx = x[np.arange(x.shape[0]), np.where(active, f, 0)]
        go_left = fx <= tree.threshold[node]
        nxt = np.where(go_left, tree.left[node], tree.right[node])
        node = np.where(active, nxt, node)


class RandomForestAlgorithm(Algorithm):
    params_class = RandomForestAlgorithmParams
    query_class = Query

    def __init__(self, params: RandomForestAlgorithmParams =
                 RandomForestAlgorithmParams()):
        self.ap = params

    def train(self, ctx, data: TrainingData) -> RandomForestModel:
        x = data.features_array().astype(np.float64)
        classes, y = data.encode_labels()
        if len(classes) > self.ap.numClasses:
            raise ValueError(
                f"data has {len(classes)} classes but numClasses="
                f"{self.ap.numClasses}")
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        rng = np.random.default_rng(int(seed))
        trees = []
        for _ in range(self.ap.numTrees):
            boot = rng.integers(0, x.shape[0], size=x.shape[0])
            trees.append(_build_tree(x[boot], y[boot], len(classes),
                                     self.ap, rng))
        return RandomForestModel(trees=trees, class_labels=classes)

    def _vote(self, model: RandomForestModel, x: np.ndarray) -> np.ndarray:
        votes = np.stack([_tree_predict(t, x) for t in model.trees])
        n_classes = len(model.class_labels)
        counts = np.apply_along_axis(
            lambda v: np.bincount(v, minlength=n_classes), 0, votes)
        return counts.argmax(axis=0)

    def predict(self, model: RandomForestModel,
                query: Query) -> PredictedResult:
        x = np.asarray([query.features], dtype=np.float64)
        ix = int(self._vote(model, x)[0])
        return PredictedResult(label=model.class_labels[ix])

    def batch_predict(self, model: RandomForestModel, queries):
        """Eval path: one stacked _vote pass over all queries instead of
        numTrees tree evaluations per query."""
        queries = list(queries)
        if not queries:
            return []
        x = np.asarray([q.features for _qx, q in queries],
                       dtype=np.float64)
        votes = self._vote(model, x)
        return [(qx, PredictedResult(label=model.class_labels[int(v)]))
                for (qx, _q), v in zip(queries, votes)]
