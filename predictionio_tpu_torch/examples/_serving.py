"""Shared serving-side filter/top-k helpers for the example engines
(port of ``predictionio_tpu/examples/_serving.py``).

Thin composition over the similarproduct template's vectorized
`candidate_mask` / `build_category_masks` (als_algorithm.py — built so
query filters are boolean vector ops, not per-item Python) and the host
top-k of ``ops/topk.py``, as the reference serves these engines.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
    build_category_masks, candidate_mask,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    ItemScore, PredictedResult,
)
from predictionio_tpu_torch.ops.topk import host_topk

__all__ = ["build_category_masks", "query_mask", "masked_topk_result"]


def _encode_set(vocab: BiMap, ids) -> Set[int]:
    out = set()
    for i in ids or ():
        ix = vocab.get(i)
        if ix is not None:
            out.add(ix)
    return out


def query_mask(vocab: BiMap, n_items: int,
               category_masks: Optional[Dict[str, np.ndarray]],
               query, exclude: Set[int]) -> np.ndarray:
    """Candidate mask from a query carrying optional categories /
    whiteList / blackList (isCandidateItem role)."""
    white = (_encode_set(vocab, query.whiteList)
             if query.whiteList is not None else None)
    black = _encode_set(vocab, query.blackList)
    return candidate_mask(
        n_items, np.ones(n_items, dtype=bool), category_masks or {},
        query.categories, white, black, exclude)


def masked_topk_result(scores: np.ndarray, mask: np.ndarray, num: int,
                       vocab: BiMap,
                       positive_only: bool = False) -> PredictedResult:
    """Top-`num` eligible scores → PredictedResult (drops -inf/NaN, and
    non-positive scores when positive_only)."""
    if positive_only:
        mask = mask & (scores > 0)
    masked = np.where(mask, scores, -np.inf)
    vals, idx = host_topk(masked, num)
    inv = vocab.inverse()
    return PredictedResult(itemScores=tuple(
        ItemScore(item=inv(int(i)), score=float(v))
        for v, i in zip(vals, idx) if np.isfinite(v)))
