"""DataSource: rate/buy events -> columnar ratings + k-fold eval splits
(port of ``predictionio_tpu/models/recommendation/data_source.py``).

Parity: recommendation-engine/src/main/scala/DataSource.scala (getRatings
:46-74, readTraining :76-80, readEval :82-107). The RDD map/filter chains
become one columnar pass (store.find_columnar) producing vocab-encoded
numpy arrays; the eval split is vectorized numpy with the reference's
folds, query order and rating order. The training read may stream
(``PIO_TRAIN_STREAM``): the encoded COO then lives only on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller import DataSource as BaseDataSource
from predictionio_tpu_torch.controller import (
    EmptyEvaluationInfo, Params, SanityCheck,
)
from predictionio_tpu_torch.data import store, synthetic
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.models.recommendation.engine import (
    ActualResult, Query, Rating,
)

#: buy events carry no rating property; the template maps them to 4.0
#: (DataSource.scala:57-59)
BUY_RATING = 4.0


@dataclass(frozen=True)
class DataSourceEvalParams(Params):
    kFold: int
    queryNum: int


@dataclass(frozen=True)
class DataSourceParams(Params):
    appName: str
    evalParams: Optional[dict] = None  # {"kFold": int, "queryNum": int}

    def eval_params(self) -> Optional[DataSourceEvalParams]:
        if self.evalParams is None:
            return None
        if isinstance(self.evalParams, DataSourceEvalParams):
            return self.evalParams
        return DataSourceEvalParams(**self.evalParams)


@dataclass
class TrainingData(SanityCheck):
    """Columnar, vocab-encoded ratings (the RDD[Rating] analogue).

    Under the streamed training read (``PIO_TRAIN_STREAM``) the host
    arrays are None: the encoded COO exists only as the device-resident
    ``_staged_coo`` triple (value-identical to what the host arrays would
    hold), so host memory stays O(chunk). ``_stream_digest`` fingerprints
    a chunked read's content for the layout cache, in both modes."""
    user_idx: Optional[np.ndarray]     # (n,) int32; None when streamed
    item_idx: Optional[np.ndarray]     # (n,) int32
    rating: Optional[np.ndarray]       # (n,) float32
    user_vocab: BiMap
    item_vocab: BiMap

    @property
    def n(self) -> int:
        if self.user_idx is not None:
            return int(self.user_idx.shape[0])
        # streamed: the count survives the layout consuming the staged
        # tensors
        return int(getattr(self, "_n", 0))

    @property
    def streamed(self) -> bool:
        return self.user_idx is None

    def sanity_check(self) -> None:
        if self.n == 0:
            raise ValueError(
                "ratings is empty — is your event store populated and "
                "appName correct?")


def _no_rating(bad: int) -> ValueError:
    return ValueError(
        f"{bad} rate event(s) have no numeric 'rating' property — "
        "cannot convert to Rating (DataSource.scala:62-68 behavior)")


def training_data_from_columnar(col) -> TrainingData:
    """Columnar rate/buy events -> TrainingData: buy maps to BUY_RATING
    whatever its properties (DataSource.scala:57-59); a rate event with no
    numeric rating is an error (:62-68).

    When the read staged device mirrors of the columns (``col.staged``,
    ops/staging.py), the same buy mapping runs on the device and the
    (user, item, rating) device COO rides the TrainingData as
    ``_staged_coo``, so the layout skips its own host-to-device copy. The
    host arrays stay the source of truth, except under the streamed read
    (``col.entity_idx is None``), where the device mirrors are the only
    copy: the buy mapping and the missing-rating check then run on the
    device (one scalar comes back for the check)."""
    buy_code = (col.event_names.index("buy")
                if "buy" in col.event_names else None)
    if col.entity_idx is None:
        td = TrainingData(user_idx=None, item_idx=None, rating=None,
                          user_vocab=col.entity_ids,
                          item_vocab=col.target_ids)
        td._n = 0
        if col.staged is None:
            # an empty stream staged nothing; the empty-ratings error
            # fires at sanity_check / train
            return td
        u_d, i_d, r_d = col.staged.training_view(buy_code, BUY_RATING)
        bad = int(torch.isnan(r_d).sum().item())
        if bad:
            raise _no_rating(bad)
        td._n = int(u_d.shape[0])
        td._staged_coo = (u_d, i_d, r_d)
        td._staged = col.staged
        td._stream_digest = col.stream_digest
        return td
    rating = col.rating.copy()
    if buy_code is not None:
        rating[col.event_name_idx == buy_code] = BUY_RATING
    if np.isnan(rating).any():
        raise _no_rating(int(np.isnan(rating).sum()))
    td = TrainingData(
        user_idx=col.entity_idx, item_idx=col.target_idx, rating=rating,
        user_vocab=col.entity_ids, item_vocab=col.target_ids)
    # the raw-chunk digest rides in-core reads too: streamed and in-core
    # trains of one store share layout-cache entries
    if col.stream_digest is not None:
        td._stream_digest = col.stream_digest
    if col.staged is not None and col.staged.n == td.n:
        td._staged_coo = col.staged.training_view(buy_code, BUY_RATING)
        td._staged = col.staged
    return td


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.dsp = params

    def read_training(self, ctx) -> TrainingData:
        """The app's rate/buy events; ``pio train --synthetic N``
        (``PIO_SYNTHETIC_EVENTS``) replaces the event-store read with the
        seeded generator. ``read_io``/``read_encode`` land in the
        context's phase table."""
        return self._get_ratings(ctx, synthetic_ok=True)

    def _get_ratings(self, ctx, synthetic_ok: bool) -> TrainingData:
        """``synthetic_ok`` marks the training read: only it may take the
        synthetic generator or stream (eval folds need the host rows)."""
        timings: Dict[str, float] = {}
        dev = getattr(ctx, "device", None)
        syn = synthetic.env_config() if synthetic_ok else None
        if syn is not None:
            td = synthetic.training_data(
                syn.n_events, seed=syn.seed, n_users=syn.n_users,
                n_items=syn.n_items, chunk=syn.chunk, timings=timings,
                device=dev)
        else:
            td = training_data_from_columnar(store.find_columnar(
                self.dsp.appName,
                entity_type="user",
                event_names=["rate", "buy"],
                target_entity_type="item",
                rating_property="rating",
                storage=ctx.storage,
                timings=timings,
                # copy the COO to the device during the decode, unless a
                # warm retrain's layout-cache hit makes the copy waste
                stage=als_algorithm.staging_wanted(),
                stream=synthetic_ok and als_algorithm.stream_wanted(),
                device=dev))
        for k, v in timings.items():
            ctx.note_phase(k, v)
        if synthetic_ok and ctx is not None:
            # the ledger row records the read path this train took
            ctx.train_stream = td.streamed
        return td

    def read_eval(self, ctx):
        """k-fold split by rating index % k (readEval,
        DataSource.scala:82-107). Per fold, the ratings of the other folds
        train, and the fold's own ratings, grouped by user in order of
        the user's first appearance, become (Query(user, queryNum),
        ActualResult(the user's ratings in read order)). Always reads the
        event store, as the reference does."""
        ep = self.dsp.eval_params()
        if ep is None:
            raise ValueError("Must specify evalParams")
        td = self._get_ratings(ctx, synthetic_ok=False)
        k = ep.kFold
        fold_of = np.arange(td.n) % k
        users = np.asarray(td.user_vocab.decode_array(
            np.arange(len(td.user_vocab))), dtype=object)
        items = np.asarray(td.item_vocab.decode_array(
            np.arange(len(td.item_vocab))), dtype=object)
        folds = []
        for fold in range(k):
            test = fold_of == fold
            train = TrainingData(
                user_idx=td.user_idx[~test], item_idx=td.item_idx[~test],
                rating=td.rating[~test], user_vocab=td.user_vocab,
                item_vocab=td.item_vocab)
            folds.append((train, EmptyEvaluationInfo(), _queries(
                td.user_idx[test], td.item_idx[test], td.rating[test],
                users, items, ep.queryNum)))
        return folds


def _queries(u: np.ndarray, i: np.ndarray, r: np.ndarray,
             users: np.ndarray, items: np.ndarray, num: int
             ) -> List[Tuple[Query, ActualResult]]:
    """Test ratings grouped by user: one (Query, ActualResult) per user in
    order of first appearance, each user's ratings in read order."""
    if u.size == 0:
        return []
    _uniq, first, inv = np.unique(u, return_index=True, return_inverse=True)
    group_of = np.empty_like(first)
    group_of[np.argsort(first, kind="stable")] = np.arange(first.size)
    key = group_of[inv.reshape(-1)]
    order = np.argsort(key, kind="stable")
    ratings = [Rating(a, b, c) for a, b, c in zip(
        users[u[order]].tolist(), items[i[order]].tolist(),
        r[order].tolist())]
    ends = np.cumsum(np.bincount(key, minlength=first.size)).tolist()
    starts = [0] + ends[:-1]
    group_users = users[u[np.sort(first)]].tolist()
    return [(Query(user=name, num=num), ActualResult(tuple(ratings[a:b])))
            for name, a, b in zip(group_users, starts, ends)]
