"""e2 engine components: categorical NB, Markov chain, binary vectorizer
(port of ``predictionio_tpu/e2/engine.py``).

Reference: e2/.../engine/{CategoricalNaiveBayes.scala:24-173,
MarkovChain.scala:26-77, BinaryVectorizer.scala:27-66}. The RDD
combineByKey/groupByKey pipelines become vocab encoding and exact
bincounts on the host; the Markov chain's transition matrix is a tensor
on the device its ``train`` was given (the card unless the caller asks
for the CPU), and its ``predict`` is one matvec there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod


# ---------------------------------------------------------------------------
# Categorical Naive Bayes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """A string label + string-categorical features
    (CategoricalNaiveBayes.scala:149-173)."""
    label: str
    features: Tuple[str, ...]

    def __post_init__(self):
        if not isinstance(self.features, tuple):
            object.__setattr__(self, "features", tuple(self.features))


@dataclasses.dataclass
class CategoricalNaiveBayesModel:
    """priors: label -> log P(label); likelihoods: label -> per-feature
    {value -> log P(value | label)} (CategoricalNaiveBayesModel,
    CategoricalNaiveBayes.scala:86-147). Semantics parity: NO smoothing —
    unseen values use `default_likelihood` over that feature's seen
    log-likelihoods (default -inf)."""
    priors: Dict[str, float]
    likelihoods: Dict[str, List[Dict[str, float]]]

    @property
    def feature_count(self) -> int:
        return len(next(iter(self.likelihoods.values())))

    def log_score(
        self, point: LabeledPoint,
        default_likelihood: Callable[[Sequence[float]], float] =
            lambda ls: float("-inf"),
    ) -> Optional[float]:
        if point.label not in self.priors:
            return None
        return self._log_score(point.label, point.features,
                               default_likelihood)

    def _log_score(self, label, features, default_likelihood):
        ll = self.likelihoods[label]
        total = self.priors[label]
        for value, table in zip(features, ll):
            total += (table[value] if value in table
                      else default_likelihood(list(table.values())))
        return total

    def predict(self, features: Sequence[str]) -> str:
        scored = [
            (label, self._log_score(label, tuple(features),
                                    lambda ls: float("-inf")))
            for label in self.priors]
        return max(scored, key=lambda kv: kv[1])[0]


class CategoricalNaiveBayes:
    """Trainer (CategoricalNaiveBayes.train, :24-82).

    Count accumulation is an exact O(n) bincount over the flattened
    (label, value) key per feature position — O(C*V) memory, no dense
    one-hots (a 1M x 50k one-hot would be ~200 GB).
    """

    @staticmethod
    def train(points: Sequence[LabeledPoint]) -> CategoricalNaiveBayesModel:
        points = list(points)
        if not points:
            raise ValueError("no training points")
        n_features = len(points[0].features)
        labels = sorted({p.label for p in points})
        label_ix = {l: i for i, l in enumerate(labels)}
        y = np.array([label_ix[p.label] for p in points], dtype=np.int64)
        label_counts = np.bincount(y, minlength=len(labels))

        priors = {
            l: math.log(label_counts[i] / len(points))
            for l, i in label_ix.items()}

        likelihoods: Dict[str, List[Dict[str, float]]] = {
            l: [] for l in labels}
        for f in range(n_features):
            vocab = sorted({p.features[f] for p in points})
            v_ix = {v: i for i, v in enumerate(vocab)}
            x = np.array([v_ix[p.features[f]] for p in points],
                         dtype=np.int64)
            counts = np.bincount(
                y * len(vocab) + x,
                minlength=len(labels) * len(vocab),
            ).reshape(len(labels), len(vocab))
            for l, li in label_ix.items():
                likelihoods[l].append({
                    v: math.log(counts[li, vi] / label_counts[li])
                    for v, vi in v_ix.items() if counts[li, vi] > 0})
        return CategoricalNaiveBayesModel(priors=priors,
                                          likelihoods=likelihoods)


# ---------------------------------------------------------------------------
# Markov chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MarkovChainModel:
    """Row-normalized, top-N-truncated transition matrix held dense on
    the device (MarkovChainModel, MarkovChain.scala:57-77). A model
    loaded from a blob holds it as numpy until its first ``predict``."""
    transition: torch.Tensor  # (S, S) float32; zero outside each row's top-N
    n: int

    def predict(self, current_state: Sequence[float]) -> List[float]:
        """Next-state distribution: current @ T (the reference's row-by-row
        sparse multiply collapsed into one matvec)."""
        t = torch.as_tensor(self.transition)
        cur = torch.as_tensor(np.asarray(current_state, dtype=np.float32),
                              device=t.device)
        return list((cur @ t).cpu().numpy())


class MarkovChain:
    @staticmethod
    def train(rows: Sequence[int], cols: Sequence[int],
              counts: Sequence[float], n_states: int,
              top_n: int, device: device_mod.DeviceLike = None
              ) -> MarkovChainModel:
        """Tally of transitions (COO) -> model (MarkovChain.train, :26-55).
        Each row keeps only its top-N entries, each divided by the FULL row
        total (reference parity: rows truncated after normalization may sum
        to < 1). An entry ties the N-th largest of its row is kept, as the
        reference's threshold ``sort(t)[:, -N]`` keeps it; the tally is
        summed on the host, so repeated (row, col) pairs add in input
        order on every device."""
        dense = np.zeros((n_states, n_states), dtype=np.float32)
        np.add.at(dense, (np.asarray(rows, dtype=np.int64),
                          np.asarray(cols, dtype=np.int64)),
                  np.asarray(counts, dtype=np.float32))
        t = torch.as_tensor(dense, device=device_mod.resolve(device))
        totals = torch.sum(t, dim=1, keepdim=True)
        k = min(top_n, n_states)
        thresh = torch.sort(t, dim=1).values[:, -k][:, None]
        mask = (t >= thresh) & (t > 0)
        probs = torch.where(
            mask, t / torch.where(totals == 0, torch.ones_like(totals),
                                  totals), torch.zeros_like(t))
        return MarkovChainModel(transition=probs, n=top_n)


# ---------------------------------------------------------------------------
# Binary vectorizer
# ---------------------------------------------------------------------------

class BinaryVectorizer:
    """(property, value) one-hot encoder (BinaryVectorizer.scala:27-66)."""

    def __init__(self, property_map: Dict[Tuple[str, str], int]):
        self.property_map = dict(property_map)
        self.num_features = len(self.property_map)
        self.properties = [
            kv for kv, _ in sorted(self.property_map.items(),
                                   key=lambda e: e[1])]

    def __str__(self) -> str:
        pairs = ",".join(f"({k}, {v})" for k, v in self.properties)
        return f"BinaryVectorizer({self.num_features}): {pairs}"

    def to_binary(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        vec = np.zeros(self.num_features, dtype=np.float32)
        for pair in pairs:
            ix = self.property_map.get(tuple(pair))
            if ix is not None:
                vec[ix] = 1.0
        return vec

    def to_binary_batch(self, rows: Sequence[Sequence[Tuple[str, str]]]
                        ) -> np.ndarray:
        return np.stack([self.to_binary(r) for r in rows]) if rows else (
            np.zeros((0, self.num_features), dtype=np.float32))

    @classmethod
    def from_maps(cls, input_maps: Sequence[Dict[str, str]],
                  properties: Sequence[str]) -> "BinaryVectorizer":
        """Distinct (property, value) pairs restricted to `properties`
        (BinaryVectorizer.apply over RDD, :49-59)."""
        props = set(properties)
        seen = sorted({
            (k, v) for m in input_maps for k, v in m.items() if k in props})
        return cls({pair: i for i, pair in enumerate(seen)})

    @classmethod
    def from_pairs(cls, pairs: Sequence[Tuple[str, str]]
                   ) -> "BinaryVectorizer":
        return cls({tuple(p): i for i, p in enumerate(pairs)})
