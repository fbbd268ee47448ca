"""ALSAlgorithm: explicit ALS train and serve (port of
``predictionio_tpu/models/recommendation/als_algorithm.py``).

Training lays the ratings out on the context's device (the card unless
the caller asks for the CPU) and runs ``ops.als.train_explicit``, whose
half-steps each end in kernel A. The layout has two cache tiers: a small
TrainingData's layout rides the object (another rank, a resume, the next
variant of an eval grid after ``prepare_layout``), and a large one
(more than ``PIO_ALS_BIG_LAYOUT_MIN`` ratings) takes the one process-wide
entry keyed by a blake2b content fingerprint, so a retrain over an
unchanged event store skips the layout (and the read's device staging).
A streamed read's staged COO is the layout's only input and is freed
once the layout is built.

Evaluation scores with ``batch_predict``: the known users' rows are
gathered on the factors' device (a trained model's, or the device policy's
for a loaded model's numpy factors) and ranked by one fp32
``topk.topk_scores_batch``.

Training over a mesh (``ctx.mesh``: ``pio train --devices`` or a
multi-process ``--coordinator`` job) runs ``parallel.als_dist``: the
layout is dealt over the mesh's slots (the sorted layout read back for
the LPT deal, or, for a streamed read, ``shard_staged_coo`` straight from
the staged COO), and each half-step runs kernel A once per slot.

A deployed model serves from the port's device: quantized (int8 factors
with per-row scales, top-k through the fused kernel) when the deploy's
serve-quant mode says so, else fp32 factors with a stable top-k; and
row-sharded (``parallel.serve_dist``: B1 once per slot, one B2) when the
deploy's shard-serving mode says so. Unlike the JAX package, a failed
quantization, sharded layout or kernel fails the deploy; it never falls
back to fp32 or to the replicated layout behind the operator's back. The
"auto" mode's ranking-parity refusal stays: it is the documented gate,
and it logs why.
"""

from __future__ import annotations

import hashlib
import logging
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import telemetry, waterfall
from predictionio_tpu_torch.controller import Algorithm, Params
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.engine import (
    ItemScore, PredictedResult, Query,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops import quant as quant_mod
from predictionio_tpu_torch.ops import staging, topk
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
    QuantizedServing layout when the deploy quantized; ``sharding`` the
    ``serve_dist.ShardedFactors`` layout (int8 or fp32) when the deploy
    sharded. With either, the factors stay host fp32 numpy (the fold-in
    worker's gather sources and the eval path's input); persisted blobs
    carry neither."""
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


def _tensor(x, device: device_mod.DeviceLike = None) -> torch.Tensor:
    """A trained model's factors as they are (a tensor on its device); a
    loaded model's numpy factors copied to ``device_mod.resolve(device)``:
    the card unless the caller or ``PIO_TORCH_DEVICE`` asks for the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, device=device_mod.resolve(device))


def host_f32(x) -> np.ndarray:
    """An array-like (numpy, a torch tensor on any device, a JAX array)
    as contiguous host float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


#: layout-reuse counts: hits = a train (or prepare_layout) served its
#: layout from either cache tier; builds = prepare_ratings ran.
#: Registry-backed: ``pio_layout_cache_total{result=...}`` on GET
#: /metrics, read and bumped like a dict.
LAYOUT_STATS = telemetry.RegistryDict(
    telemetry.registry().counter(
        "pio_layout_cache_total",
        "Device COO layout requests by outcome (hit = served from a "
        "cache tier, build = prepare_ratings ran)",
        labelnames=("result",)),
    "result", ("hits", "builds"))


#: one-entry process-wide layout cache for large trains:
#: [(meta, digest, ALSData)]. Keyed on a content fingerprint (a cheap
#: meta tuple, then a 128-bit blake2b digest), so a changed event store
#: never reuses a stale layout; the digest runs only when the meta
#: already matches, at most once per train.
_BIG_LAYOUT_CACHE: list = []


def _layout_cache_enabled() -> bool:
    """``PIO_ALS_LAYOUT_CACHE=0`` turns the process-wide tier off."""
    return os.environ.get("PIO_ALS_LAYOUT_CACHE", "1") != "0"


def _layout_meta(td, device: torch.device, slots: int = 0):
    # "raw" fingerprints hash the raw chunk columns (streamed AND in-core
    # reads of a chunked source, so the two share entries); "enc" hashes
    # the encoded host arrays (reads with no chunk stream). The kind keeps
    # the two digest keyspaces from ever comparing.
    kind = "raw" if getattr(td, "_stream_digest", None) else "enc"
    return (str(device), slots, kind, td.n, len(td.user_vocab),
            len(td.item_vocab))


def _layout_crc(td) -> bytes:
    digest = getattr(td, "_stream_digest", None)
    if digest:
        # the incremental digest of the raw chunk columns, taken during
        # the read in both retention modes; under the streamed read the
        # host COO never existed, so it is the only fingerprint there
        return digest
    h = hashlib.blake2b(digest_size=16)
    for a in (td.user_idx, td.item_idx, td.rating):
        h.update(np.ascontiguousarray(a).view(np.uint8))
    return h.digest()


def _big_layout_cached(td, device: torch.device, slots: int = 0):
    """-> (data or None, digest or None); the digest comes back when it
    was computed, so the store that follows a miss never hashes twice."""
    if not _layout_cache_enabled() or not _BIG_LAYOUT_CACHE:
        return None, None
    meta, crc, data = _BIG_LAYOUT_CACHE[0]
    if meta != _layout_meta(td, device, slots):
        return None, None
    got = _layout_crc(td)
    return (data, got) if got == crc else (None, got)


def _big_layout_store(td, device: torch.device, data, crc=None,
                      slots: int = 0) -> None:
    if _layout_cache_enabled():
        if crc is None:
            crc = _layout_crc(td)
        _BIG_LAYOUT_CACHE[:] = [(_layout_meta(td, device, slots), crc,
                                 data)]


def staging_wanted() -> bool:
    """Should the bulk read copy its COO chunks to the device while it
    decodes? Yes unless a process-wide layout entry exists that an
    unchanged event store would hit: a warm retrain skips the copy
    (``PIO_READ_STAGE=0`` turns staging off outright)."""
    if not staging.staging_available():
        return False
    return not (_layout_cache_enabled() and _BIG_LAYOUT_CACHE)


def stream_wanted() -> bool:
    """Should the training read stream (``PIO_TRAIN_STREAM``)? ``auto``
    streams wherever staging would engage and declines a warm retrain
    (a populated layout cache: the in-core read's fingerprint hits
    without any copy); ``on`` streams always (the digest-keyed cache
    still hits, after the copy); ``off`` never."""
    mode = store.train_stream_mode()
    if mode == "off" or not store.resolve_train_stream():
        return False
    return mode == "on" or staging_wanted()


def _ensure_layout(td, device: torch.device, mesh=None):
    """The sorted COO layout of one TrainingData on ``device``, through
    both cache tiers (the train's ``layout`` phase body, shared with
    ``prepare_layout``; the layout is rank-independent).

    A TrainingData of at most ``PIO_ALS_BIG_LAYOUT_MIN`` ratings (default
    2,000,000; an eval fold) caches its layout on the object. A larger
    one takes the one process-wide entry, keyed on its content
    fingerprint, so repeat trains over an unchanged event store skip the
    layout. The retained device memory (about 0.5 GB at 20M ratings) is
    bounded at one entry, evicted before a replacement is built;
    ``PIO_ALS_LAYOUT_CACHE=0`` retains nothing.

    With a ``mesh`` the in-core layout is the same one, which
    ``als_dist`` deals over the slots at train time; a streamed read's
    staged COO goes straight into the slots (``shard_staged_coo``), the
    ``PreshardedData`` being the cached layout. Either is keyed on the
    slot count too."""
    slots = mesh.size if mesh is not None else 0
    cacheable = td.n <= int(os.environ.get("PIO_ALS_BIG_LAYOUT_MIN",
                                           2_000_000))
    key = ("als_layout", str(device), slots)
    cached = getattr(td, "_pio_layout_cache", None) if cacheable else None
    big_crc = None
    if cached is not None and cached[0] == key:
        data = cached[1]
    else:
        data, big_crc = _big_layout_cached(td, device, slots)
    if data is not None:
        LAYOUT_STATS["hits"] += 1
        return data
    LAYOUT_STATS["builds"] += 1
    if not cacheable:
        # evict BEFORE building the replacement: the old layout held
        # across the rebuild would double the retained device memory
        _BIG_LAYOUT_CACHE.clear()
    staged = getattr(td, "_staged_coo", None)
    if td.streamed:
        # the device mirrors are the only copy of the COO
        u_in, i_in, r_in = staged
    elif staged is not None and int(staged[0].shape[0]) == td.n:
        # the read staged the encoded COO already (value-identical to
        # the host columns): the layout skips its own host-to-device copy
        u_in, i_in, r_in = staged
    else:
        u_in, i_in, r_in = td.user_idx, td.item_idx, td.rating
    if mesh is not None and td.streamed:
        from predictionio_tpu_torch.parallel import als_dist
        data = als_dist.shard_staged_coo(
            mesh, u_in, i_in, r_in, n_users=len(td.user_vocab),
            n_items=len(td.item_vocab))
    else:
        # sorted on the device; a mesh's LPT deal reads it back to the
        # host at train time
        data = als.prepare_ratings(
            u_in, i_in, r_in,
            n_users=len(td.user_vocab), n_items=len(td.item_vocab),
            on_device=True, device=device)
    del u_in, i_in, r_in
    # the staged mirrors are dead once the layout exists: free them (the
    # pinned host buffers after their copies land)
    td._staged_coo = None
    held = getattr(td, "_staged", None)
    if held is not None:
        held.release()
        td._staged = None
    if cacheable:
        td._pio_layout_cache = (key, data)
    else:
        _big_layout_store(td, device, data, crc=big_crc, slots=slots)
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
        mesh = getattr(ctx, "mesh", None)
        if mesh is not None:
            dev = mesh.local_device
        with ctx.phase("layout"):
            data = _ensure_layout(td, dev, mesh)
        checkpointer = None
        ckpt_dir = getattr(ctx, "checkpoint_dir", None)
        if self.ap.checkpointInterval and ckpt_dir:
            checkpointer = FactorCheckpointer(ckpt_dir)
        if mesh is not None:
            from predictionio_tpu_torch.parallel import als_dist
            U, V = als_dist.train_explicit_sharded(
                mesh, data, rank=self.ap.rank,
                iterations=self.ap.numIterations, lambda_=self.ap.lambda_,
                seed=int(seed), checkpoint_every=self.ap.checkpointInterval,
                checkpointer=checkpointer)
        else:
            U, V = als.train_explicit(
                data, rank=self.ap.rank, iterations=self.ap.numIterations,
                lambda_=self.ap.lambda_, seed=int(seed),
                checkpoint_every=self.ap.checkpointInterval,
                checkpointer=checkpointer, device=dev)
        return ALSModel(
            rank=self.ap.rank, user_factors=U, item_factors=V,
            user_vocab=td.user_vocab, item_vocab=td.item_vocab)

    def prepare_layout(self, ctx, prepared) -> None:
        """The eval grid's hoist (``workflow/fast_eval.py``): build this
        fold's layout before any variant trains. The layout is
        rank-independent, so every variant's train then hits the
        TrainingData-object cache."""
        td = prepared.ratings
        if td.n == 0:
            return
        dev = device_mod.resolve(getattr(ctx, "device", None))
        mesh = getattr(ctx, "mesh", None)
        if mesh is not None:
            dev = mesh.local_device
        with ctx.phase("layout"):
            _ensure_layout(td, dev, mesh)

    def prepare_serving(self, model: ALSModel) -> ALSModel:
        """Quantize when serve-quant resolves on (``quant.deploy_scope``),
        then lay the factors out row-sharded when shard-serving resolves
        on (``serve_dist.deploy_scope``), int8 or fp32; otherwise put the
        quantized layout or the fp32 factors on the deploy's device. A
        failed sharded layout raises: no replicated fallback."""
        from predictionio_tpu_torch.parallel import serve_dist

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
        if serve_dist.serving_enabled():
            return ALSModel(
                rank=model.rank, user_factors=U, item_factors=V,
                user_vocab=model.user_vocab, item_vocab=model.item_vocab,
                sharding=serve_dist.shard_factors(U, V, quant=qf,
                                                  device=dev))
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

    def aot_serving_programs(self, model: ALSModel, buckets):
        """The deploy's warm-up (``serving/aot.py``): one batched top-k
        per bucket, B1 + B2 on the card for a quantized model (B1 per
        shard and one B2 for a sharded one, whose inline query rides
        bucket 1), and the inline single-query path once, each on row 0
        (in bounds) and ending in the host copy, as a flush does."""
        from predictionio_tpu_torch.serving import aot

        k = aot.warm_k(len(model.item_vocab))
        sharding = model.sharding
        if sharding is not None:
            from predictionio_tpu_torch.parallel import serve_dist
            return serve_dist.sharded_program_specs(sharding, buckets, [k])
        out = []
        quant = model.quant
        for b in buckets:
            pix = np.zeros(b, dtype=np.int32)
            if quant is not None:
                def run(pix=pix):
                    return _to_host(*quant.topk(pix, k))
            else:
                def run(pix=pix):
                    U = model.user_factors
                    ixs = torch.from_numpy(pix).to(U.device)
                    return _to_host(*topk.topk_for_users(
                        U, model.item_factors, ixs, k=k))
            out.append(aot.Program("topk_for_users", run))
        if quant is not None:
            def one():
                return _to_host(*quant.topk_one(0, k))
        else:
            def one():
                return _to_host(*topk.topk_for_user(
                    model.user_factors, model.item_factors, 0, k=k))
        out.append(aot.Program("topk_for_user", one))
        return out

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
        if model.sharding is not None:
            # the inline query rides the sharded serve at b = 1
            vals, idx = _to_host(*model.sharding.topk([user_ix], k))
            vals, idx = vals[0], idx[0]
        elif quant is not None:
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
        num. Padding rows are dropped. Waterfall drill-down inside the
        server's ``dispatch`` stage: ``pad`` is the host-side bucket
        prep, ``execute`` the device call ending in the ``.cpu()`` copy
        of the (bucket, k) result, with the index copy to the card
        inside it."""
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
        with waterfall.stage("pad"):
            pix = np.zeros(bucket_for(len(valid)), dtype=np.int32)
            pix[:len(valid)] = [ix for _qx, _q, ix in valid]
        quant = model.quant
        if model.sharding is not None:
            # B1 once per slot into one B2 (int8), or the fp32 twin
            with waterfall.stage("execute"):
                vals, idx = _to_host(*model.sharding.topk(pix, k))
            waterfall.note("shards", model.sharding.n_shards)
        elif quant is not None:
            with waterfall.stage("execute"):
                vals, idx = _to_host(*quant.topk(pix, k))
            waterfall.note("quant", "int8")
        else:
            with waterfall.stage("execute"):
                ixs = torch.from_numpy(pix).to(model.user_factors.device)
                vals, idx = _to_host(*topk.topk_for_users(
                    model.user_factors, model.item_factors, ixs, k=k))
        for r, (qx, q, _ix) in enumerate(valid):
            n = min(q.num, k)
            out[qx] = self._results(model, vals[r, :n], idx[r, :n])
        return out

    def batch_predict(self, model: ALSModel,
                      queries: Iterable[Tuple[int, Query]],
                      device: device_mod.DeviceLike = None
                      ) -> List[Tuple[int, PredictedResult]]:
        """The eval path: the known users' rows gathered on the factors'
        device and one fp32 ``topk_scores_batch`` at the largest num
        asked (ALSAlgorithm.scala:113-148 did a cartesian join); each
        query keeps its own num. Unknown users and num <= 0 get empty
        results. Trained factors stay on their device; a loaded model's
        numpy factors go to ``device`` as the device policy resolves it
        (the card unless ``device="cpu"`` or ``PIO_TORCH_DEVICE=cpu``)."""
        queries = list(queries)
        known = [(qx, q, model.user_vocab.get(q.user)) for qx, q in queries]
        out: List[Tuple[int, PredictedResult]] = [
            (qx, PredictedResult(())) for qx, _q, ix in known if ix is None]
        valid = [(qx, q, ix) for qx, q, ix in known if ix is not None]
        if not valid:
            return out
        k = min(max(q.num for _qx, q, _ix in valid), len(model.item_vocab))
        if k <= 0:      # every query asked for num <= 0
            out.extend((qx, PredictedResult(())) for qx, _q, _ix in valid)
            return out
        U = _tensor(model.user_factors, device)
        V = _tensor(model.item_factors, U.device).to(U.device)
        ixs = torch.tensor([ix for _qx, _q, ix in valid], dtype=torch.int64,
                           device=U.device)
        vals, idx = _to_host(*topk.topk_scores_batch(
            U.index_select(0, ixs), V, k=k))
        for row, (qx, q, _ix) in enumerate(valid):
            n = max(min(q.num, k), 0)   # a negative num is empty
            out.append((qx, self._results(model, vals[row, :n],
                                          idx[row, :n])))
        return out
