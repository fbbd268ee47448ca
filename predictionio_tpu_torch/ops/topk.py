"""Deterministic top-K scoring from factor matrices (port of
``predictionio_tpu/ops/topk.py``).

Order is descending score with equal scores broken by the LOWEST index,
on every device. ``torch.sort(-scores, stable=True)`` over the index
order realizes exactly the reference's two-key ``lax.sort`` over
(negated score, index): a stable sort keeps equal keys in index order.
The fp32 products stay ``torch.matmul`` at full precision (TF32 is off,
:mod:`predictionio_tpu_torch.device`), as the reference leaves them to
XLA at ``Precision.HIGHEST``.

:func:`topk_scores_batch`, the evaluation's scorer, takes its rows in
chunks whose fp32 score matrix stays under :data:`CHUNK_BYTES`: ML-20M's
whole (138,493 x 26,744) matrix is 14.8 GB, and the sort's buffers would
triple it. Each row is scored and ranked on its own, so chunking changes
no result.

The item-scoring templates (similar-product, e-commerce) serve on the
host, as the reference does: :func:`host_masked_topk` and
:func:`host_masked_topk_batch` are its numpy, copied (exact class).
:func:`cosine_topk` is the reference's device cosine scorer in torch
(tolerance class: the norms and the product round in another order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: the reference's masked-score sentinel, bit for bit
NEG_INF = -3.4e38

#: most bytes of fp32 scores that one chunk of topk_scores_batch holds
CHUNK_BYTES = 1 << 30


def stable_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis: descending score, ties by lowest index.
    Returns (values, int32 indices)."""
    neg, idx = torch.sort(-scores, dim=-1, stable=True)
    # -(-x) is a bitwise round trip for floats (two sign flips)
    return -neg[..., :k], idx[..., :k].to(torch.int32)


def _masked(scores: torch.Tensor, mask) -> torch.Tensor:
    return scores if mask is None else scores.masked_fill(~mask, NEG_INF)


def topk_scores(query_vec: torch.Tensor, item_factors: torch.Tensor,
                mask=None, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """``V @ q`` with ineligible items (``mask`` False) at NEG_INF, then
    the stable top-k. Returns (values, int32 indices)."""
    return stable_topk(_masked(item_factors @ query_vec, mask), k)


def topk_scores_batch(query_vecs: torch.Tensor, item_factors: torch.Tensor,
                      mask=None, k: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The evaluation's batched scorer: ``(b, r) @ (r, n_items)`` in fp32,
    ``mask`` ((b, n_items) or (n_items,), True = eligible) applied with
    NEG_INF, stable top-k; rows in chunks of at most :data:`CHUNK_BYTES`
    of scores. Returns (values (b, k), int32 indices (b, k))."""
    rows = max(1, CHUNK_BYTES // (4 * max(int(item_factors.shape[0]), 1)))
    vt = item_factors.T
    parts = [stable_topk(_masked(
        query_vecs[lo:lo + rows] @ vt,
        mask if mask is None or mask.dim() == 1 else mask[lo:lo + rows]), k)
        for lo in range(0, int(query_vecs.shape[0]), rows)]
    return (torch.cat([v for v, _i in parts]),
            torch.cat([i for _v, i in parts]))


def topk_for_user(user_factors: torch.Tensor, item_factors: torch.Tensor,
                  user_ix: int, k: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-query serve: row gather + matvec + stable top-k.
    ``user_ix`` must be in bounds (callers resolve it against the user
    vocabulary first)."""
    return stable_topk(item_factors @ user_factors[int(user_ix)], k)


def topk_for_users(user_factors: torch.Tensor, item_factors: torch.Tensor,
                   user_ixs: torch.Tensor, k: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched serve: B row gathers + one (b, r) x (r, n_items) matmul +
    stable top-k. Callers pad ``user_ixs`` to a serving bucket with an
    in-bounds index and drop the padding rows."""
    Q = user_factors.index_select(0, user_ixs.to(torch.int64))
    return stable_topk(Q @ item_factors.T, k)


def host_topk(scores, k: int):
    """numpy argpartition top-K on the host (copied from the reference,
    which is host numpy too). k <= 0 returns empty. Ties break by lowest
    index: entries strictly above the k-th value keep the partitioned
    path, the boundary ties are re-resolved from the full array."""
    k = min(k, scores.shape[-1])
    if k <= 0:
        return scores[:0], np.zeros((0,), dtype=np.int64)
    sel = np.argpartition(-scores, k - 1)[:k]
    kth = scores[sel].min()
    if np.isnan(kth):
        # a poisoned model: let the NaNs reach the serving layer's
        # non-finite gate instead of masking them with a tidy answer
        sel = sel[np.argsort(-scores[sel], kind="stable")]
        return scores[sel], sel
    strict = sel[scores[sel] > kth]
    strict = strict[np.lexsort((strict, -scores[strict]))]
    ties = np.flatnonzero(scores == kth)[:k - strict.size]
    idx = np.concatenate([strict, ties])
    return scores[idx], idx


def host_masked_topk(factors, query_vec, mask, k: int, weights=None):
    """Host serving for the item-scoring templates: one BLAS matvec,
    optional per-item score multipliers (the weighted-items rule), -inf
    outside the candidate mask, then :func:`host_topk`. Callers drop
    non-finite and non-positive entries when building results."""
    scores = np.asarray(factors) @ np.asarray(query_vec)
    if weights is not None:
        scores = scores * np.asarray(weights)
    scores = np.where(np.asarray(mask), scores, -np.inf)
    return host_topk(scores, k)


def host_masked_topk_batch(factors, query_vecs, masks, ks, weights=None):
    """Batched :func:`host_masked_topk`: ONE (b, r) x (r, n_items) BLAS
    matmul for a micro-batch, then each row's mask, weights and top-k at
    its own k. Returns a list of (vals, idx) rows."""
    scores = np.asarray(query_vecs) @ np.asarray(factors).T
    if weights is not None:
        scores = scores * np.asarray(weights)[None, :]
    return [host_topk(np.where(np.asarray(mask), row, -np.inf), k)
            for row, mask, k in zip(scores, masks, ks)]


def cosine_topk(query_vec: torch.Tensor, item_factors: torch.Tensor,
                mask=None, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine similarity of every item to ``query_vec`` (norms floored at
    1e-12), ineligible items at NEG_INF, stable top-k on the factors'
    device. Returns (values, int32 indices)."""
    qn = query_vec / torch.clamp(torch.linalg.vector_norm(query_vec),
                                 min=1e-12)
    norms = torch.linalg.vector_norm(item_factors, dim=1)
    scores = (item_factors @ qn) / torch.clamp(norms, min=1e-12)
    return stable_topk(_masked(scores, mask), k)
