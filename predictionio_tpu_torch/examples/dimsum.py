"""DIMSUM similar-product: all-pairs item cosine similarity (port of
``predictionio_tpu/examples/dimsum.py``).

Parity: examples/experimental/scala-parallel-similarproduct-dimsum
(DIMSUMAlgorithm.scala — RowMatrix.columnSimilarities(threshold) over the
user x item view matrix, symmetrized, served per query-item with
white/black/category filters). The sibling localmodel variant
(scala-parallel-similarproduct-localmodel) is ALS with the factor matrices
collected into one process — in this runtime every model is already local, so
`models/similarproduct`'s ALSAlgorithm covers it as-is.

DIMSUM's sampling exists because an exact all-pairs ``GᵀG`` is a shuffle
explosion on a cluster. On one device the exact Gram is the cheap
operation — a chunked ``(items, users) x (users, items)`` fp32 matmul
(TF32 off) on the context's device, the card unless the caller asks for
the CPU — so the exact cosine similarities are computed in user-chunks
and `threshold` applies as a post-mask (DIMSUM's guarantee, without the
sampling error). The normalization runs there too, elementwise, and the
similarities come to the host once. Reuses the similarproduct template's
DataSource/Query types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import (
    Engine, FirstServing, IdentityPreparator, Params,
)
from predictionio_tpu_torch.controller.base import Algorithm
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.examples._serving import (
    build_category_masks, masked_topk_result, query_mask,
)
from predictionio_tpu_torch.models.similarproduct.data_source import (
    DataSource, TrainingData,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    Item, PredictedResult, Query,
)


@dataclass(frozen=True)
class DIMSUMAlgorithmParams(Params):
    threshold: float = 0.0


@dataclass
class DIMSUMModel:
    similarities: np.ndarray     # (n_items, n_items) cosine, diag 0
    item_vocab: BiMap            # item id -> column index
    items: Dict[int, Item]       # column index -> Item (categories)
    category_masks: Dict[str, np.ndarray] = None


def _cosine_gram(rows: np.ndarray, threshold: float,
                 chunk: int = 4096,
                 device: device_mod.DeviceLike = None) -> np.ndarray:
    """Exact column cosine similarity of a (n_users, n_items) 0/1 matrix,
    accumulated over user-chunks on ``device`` (columnSimilarities
    parity, exact instead of sampled): ``g + b.T @ b`` per chunk, then
    ``g / n_j / n_i`` with ``n = sqrt(max(diag(g), 1e-12))``, the
    diagonal zeroed and entries below ``threshold`` zeroed."""
    dev = device_mod.resolve(device)
    n_users, n_items = rows.shape
    gram = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    for s in range(0, n_users, chunk):
        block = torch.as_tensor(rows[s:s + chunk], dtype=torch.float32,
                                device=dev)
        gram = gram + block.T @ block
    norms = torch.sqrt(torch.clamp(torch.diagonal(gram), min=1e-12))
    sim = gram / norms[None, :] / norms[:, None]
    del gram
    sim.fill_diagonal_(0.0)
    if threshold > 0.0:
        sim[sim < threshold] = 0.0
    return sim.cpu().numpy()


class DIMSUMAlgorithm(Algorithm):
    params_class = DIMSUMAlgorithmParams

    def __init__(self, params: DIMSUMAlgorithmParams = None):
        self.ap = params or DIMSUMAlgorithmParams()

    def train(self, ctx, data: TrainingData) -> DIMSUMModel:
        item_vocab = BiMap.string_int(data.items.keys())
        user_vocab = BiMap.string_int(data.users.keys())
        rows = np.zeros((len(user_vocab), len(item_vocab)), dtype=np.float32)
        for ve in data.view_events:
            u, i = user_vocab.get(ve.user), item_vocab.get(ve.item)
            if u is None or i is None:
                continue     # nonexistent ids are dropped (reference logs)
            rows[u, i] = 1.0     # dedup: repeated views count once
        sim = _cosine_gram(rows, self.ap.threshold,
                           device=getattr(ctx, "device", None))
        items = {item_vocab(iid): item for iid, item in data.items.items()}
        return DIMSUMModel(
            similarities=sim, item_vocab=item_vocab, items=items,
            category_masks=build_category_masks(items, len(item_vocab)))

    def predict(self, model: DIMSUMModel, query: Query) -> PredictedResult:
        vocab = model.item_vocab
        query_ix = {vocab.get(i) for i in query.items} - {None}
        if not query_ix:
            return PredictedResult(())
        # aggregate similarity over the query basket (reference sums the
        # per-item similarity lists)
        agg = model.similarities[np.asarray(sorted(query_ix))].sum(axis=0)
        mask = query_mask(vocab, agg.shape[0], model.category_masks,
                          query, exclude=query_ix)
        return masked_topk_result(agg, mask, query.num, vocab,
                                  positive_only=True)

    @property
    def query_class(self):
        return Query


def engine() -> Engine:
    """scala-parallel-similarproduct-dimsum Engine.scala."""
    return Engine(DataSource, IdentityPreparator,
                  {"dimsum": DIMSUMAlgorithm}, FirstServing)
