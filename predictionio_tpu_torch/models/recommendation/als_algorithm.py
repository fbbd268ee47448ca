"""ALSAlgorithm: explicit ALS train and serve (port of
``predictionio_tpu/models/recommendation/als_algorithm.py``).

Training lays the ratings out on the context's device (the card unless
the caller asks for the CPU) and runs ``ops.als.train_explicit``, whose
half-steps each end in kernel A. The layout is cached on the
TrainingData object, so a second train of the same data (another rank,
a resume) skips it; the reference's process-wide fingerprinted layout
cache, device staging and streamed read wait for a later slice.

A deployed model serves from the port's device: quantized (int8 factors
with per-row scales, top-k through the fused kernel) when the deploy's
serve-quant mode says so, else fp32 factors with a stable top-k. Unlike
the JAX package, a failed quantization or kernel fails the deploy; it
never falls back to fp32 behind the operator's back. The "auto" mode's
ranking-parity refusal stays: it is the documented gate, and it logs
why.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.engine import (
    ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops import quant as quant_mod
from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.serving.protocol import bucket_for
from predictionio_tpu_torch.workflow.checkpoint import FactorCheckpointer

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
    (workflow/model_io.py). A trained model holds torch tensors on the
    train device; a loaded one numpy. ``quant`` is serve-time state: the
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


def host_f32(x) -> np.ndarray:
    """An array-like (numpy, a torch tensor on any device, a JAX array)
    as contiguous host float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def _ensure_layout(td, device: torch.device) -> als.ALSData:
    """The sorted COO layout of one TrainingData on ``device``, cached on
    the TrainingData object (the layout is rank-independent)."""
    key = ("als_layout", str(device))
    cached = getattr(td, "_pio_layout_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    data = als.prepare_ratings(
        td.user_idx, td.item_idx, td.rating,
        n_users=len(td.user_vocab), n_items=len(td.item_vocab),
        on_device=True, device=device)
    td._pio_layout_cache = (key, data)
    return data


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    def __init__(self, params: ALSAlgorithmParams):
        self.ap = params
        if isinstance(params.seed, dict):
            raise ValueError("seed must be an integer or null")

    def train(self, ctx, prepared) -> ALSModel:
        """Explicit ALS on the context's device (``ctx.device``; the card
        unless the caller asked for the CPU), with the layout as its own
        ``layout`` phase. ``checkpointInterval`` snapshots factors into
        ``ctx.checkpoint_dir`` so an interrupted train resumes."""
        td = prepared.ratings
        if td.n == 0:
            raise ValueError(
                "No ratings found. Please check if DataSource generates "
                "TrainingData and Preparator generates PreparedData "
                "correctly.")
        # MLlib uses System.nanoTime when no seed is given
        seed = self.ap.seed if self.ap.seed is not None else (
            np.random.SeedSequence().entropy % (2 ** 31))
        dev = device_mod.resolve(getattr(ctx, "device", None))
        with ctx.phase("layout"):
            data = _ensure_layout(td, dev)
        checkpointer = None
        ckpt_dir = getattr(ctx, "checkpoint_dir", None)
        if self.ap.checkpointInterval and ckpt_dir:
            checkpointer = FactorCheckpointer(ckpt_dir)
        U, V = als.train_explicit(
            data, rank=self.ap.rank, iterations=self.ap.numIterations,
            lambda_=self.ap.lambda_, seed=int(seed),
            checkpoint_every=self.ap.checkpointInterval,
            checkpointer=checkpointer, device=dev)
        return ALSModel(
            rank=self.ap.rank, user_factors=U, item_factors=V,
            user_vocab=td.user_vocab, item_vocab=td.item_vocab)

    def prepare_serving(self, model: ALSModel) -> ALSModel:
        """Quantize and lay the factors out on the deploy's device when
        serve-quant resolves on (``quant.deploy_scope``); otherwise put
        the fp32 factors on the device."""
        dev = quant_mod.scoped_device()
        U = host_f32(model.user_factors)
        V = host_f32(model.item_factors)
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
            user_factors=torch.tensor(U, device=dev),
            item_factors=torch.tensor(V, device=dev),
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
