"""ALSAlgorithm, serving half (port of
``predictionio_tpu/models/recommendation/als_algorithm.py``).

A deployed model serves from the port's device: quantized (int8 factors
with per-row scales, top-k through the fused kernel) when the deploy's
serve-quant mode says so, else fp32 factors with a stable top-k. Unlike
the JAX package, a failed quantization or kernel fails the deploy; it
never falls back to fp32 behind the operator's back. The "auto" mode's
ranking-parity refusal stays: it is the documented gate, and it logs
why. Training arrives with the training slice.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.engine import (
    ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.ops import quant as quant_mod
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.serving.protocol import bucket_for

logger = logging.getLogger("predictionio_tpu_torch.recommendation")


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    """engine.json keys (rank, numIterations, lambda, seed,
    checkpointInterval); ``lambda`` maps to ``lambda_``."""
    rank: int = 10
    numIterations: int = 10
    lambda_: float = 0.01
    seed: Optional[int] = None
    checkpointInterval: Optional[int] = None

    JSON_ALIASES = {"lambda": "lambda_"}


@dataclass
class ALSModel:
    """Factor matrices + vocabularies, the same fields as the JAX
    package's ALSModel so its blobs load field for field
    (workflow/model_io.py). ``quant`` is serve-time state: the
    QuantizedServing layout when the deploy quantized; the factors then
    stay host numpy. ``sharding`` is never set by the port (sharded
    serving is a later slice); it exists because the blobs carry it."""
    rank: int
    user_factors: "np.ndarray | torch.Tensor"   # (n_users, rank)
    item_factors: "np.ndarray | torch.Tensor"   # (n_items, rank)
    user_vocab: BiMap
    item_vocab: BiMap
    sharding: Optional[object] = None
    quant: Optional[object] = None

    def __str__(self) -> str:
        return (f"ALSModel(rank={self.rank}, users={len(self.user_vocab)}, "
                f"items={len(self.item_vocab)})")


def _to_host(vals: torch.Tensor, idx: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray]:
    return vals.cpu().numpy(), idx.cpu().numpy()


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    def __init__(self, params: ALSAlgorithmParams):
        self.ap = params
        if isinstance(params.seed, dict):
            raise ValueError("seed must be an integer or null")

    def train(self, ctx, prepared):
        raise NotImplementedError(
            "ALS training is not ported yet (the training slice); train "
            "with the JAX package's `pio train` — its model blob deploys "
            "here through workflow.model_io")

    def prepare_serving(self, model: ALSModel) -> ALSModel:
        """Quantize and lay the factors out on the deploy's device when
        serve-quant resolves on (``quant.deploy_scope``); otherwise put
        the fp32 factors on the device."""
        dev = quant_mod.scoped_device()
        U = np.asarray(model.user_factors, dtype=np.float32)
        V = np.asarray(model.item_factors, dtype=np.float32)
        qf = None
        if quant_mod.serving_enabled():
            qf = quant_mod.QuantizedFactors.from_factors(U, V)
            parity = quant_mod.ranking_parity(U, V, qf)
            qf.recall = parity["recall"]
            qf.exact1 = parity["exact1"]
            if not quant_mod.accept_parity(parity):
                logger.warning(
                    "quantized serving refused by the ranking-parity probe "
                    "(recall@%d=%.4f < %.2f floor); serving fp32",
                    parity["k"], parity["recall"], quant_mod.recall_floor())
                qf = None
        if qf is not None:
            return ALSModel(
                rank=model.rank, user_factors=U, item_factors=V,
                user_vocab=model.user_vocab, item_vocab=model.item_vocab,
                quant=quant_mod.QuantizedServing.build(qf, device=dev))
        return ALSModel(
            rank=model.rank,
            user_factors=torch.from_numpy(U).to(dev),
            item_factors=torch.from_numpy(V).to(dev),
            user_vocab=model.user_vocab, item_vocab=model.item_vocab)

    @staticmethod
    def _results(model: ALSModel, vals, idx) -> PredictedResult:
        # an index past the item vocab never surfaces in a result (the
        # JAX package's fold-in headroom guard; a no-op without fold-in)
        n_real = len(model.item_vocab)
        inv = model.item_vocab.inverse()
        return PredictedResult(tuple(
            ItemScore(item=inv(int(i)), score=float(s))
            for s, i in zip(vals, idx) if int(i) < n_real))

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        user_ix = model.user_vocab.get(query.user)
        if user_ix is None:
            return PredictedResult(())   # unknown user -> empty result
        k = min(query.num, len(model.item_vocab))
        if k <= 0:
            return PredictedResult(())
        quant = model.quant
        if quant is not None:
            vals, idx = _to_host(*quant.topk_one(user_ix, k))
        else:
            vals, idx = _to_host(*topk.topk_for_user(
                model.user_factors, model.item_factors, user_ix, k=k))
        return self._results(model, vals, idx)

    def predict_batch(self, model: ALSModel,
                      queries) -> List[PredictedResult]:
        """One micro-batch: the known users' rows padded to a serving
        bucket (pad rows reuse index 0, in bounds) and ONE device top-k
        for the batch at the largest k asked; each query keeps its own
        num. Padding rows are dropped."""
        queries = list(queries)
        out: List[Optional[PredictedResult]] = [None] * len(queries)
        valid = []
        for qx, q in enumerate(queries):
            ix = model.user_vocab.get(q.user)
            if ix is None or min(q.num, len(model.item_vocab)) <= 0:
                out[qx] = PredictedResult(())
            else:
                valid.append((qx, q, ix))
        if not valid:
            return out
        k = min(max(q.num for _qx, q, _ix in valid), len(model.item_vocab))
        pix = np.zeros(bucket_for(len(valid)), dtype=np.int32)
        pix[:len(valid)] = [ix for _qx, _q, ix in valid]
        quant = model.quant
        if quant is not None:
            vals, idx = _to_host(*quant.topk(pix, k))
        else:
            ixs = torch.from_numpy(pix).to(model.user_factors.device)
            vals, idx = _to_host(*topk.topk_for_users(
                model.user_factors, model.item_factors, ixs, k=k))
        for r, (qx, q, _ix) in enumerate(valid):
            n = min(q.num, k)
            out[qx] = self._results(model, vals[r, :n], idx[r, :n])
        return out
