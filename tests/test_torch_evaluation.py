"""The evaluation slice (``pio eval`` for the Recommendation template) of
the PyTorch port against the JAX package, on the same seeded inputs.

Parity classes:
- exact: ``read_eval``'s folds, queries and actuals (memory and SQLite
  stores); the metric family on shared (Q, P, A) sets; the evaluator's
  JSON, HTML and best.json; ``topk_scores_batch`` and
  ``ALSAlgorithm.batch_predict`` (and the metrics on its answers) at
  ranks 10 and 20 on factors whose products every summation order
  rounds alike (values on a dyadic grid); the FastEval prefix counts;
  EvaluationInstance rows across packages.
- tolerance: ``topk_scores_batch`` and ``batch_predict`` on Gaussian and
  trained factors at ranks 10 and 20. XLA's CPU dot and torch's sgemm
  round alike at some shapes and not at others (at rank 10: equal at
  500 items, over half the scores an ulp apart at 400), so scores agree
  within 1e-6 relative and indices wherever the reference's neighbouring
  scores are further apart than that. ``run_evaluation`` end to end,
  whose trained factors differ in fp32 summation order: per-variant
  scores within 0.02 absolute.

Seeds are not replayed (``jax.random`` against ``torch.Generator``):
``_seed_factors`` is patched in both packages to return the same numpy
factors."""

import dataclasses
import datetime as dt
import json
import math

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import AverageMetric as JAverageMetric
from predictionio_tpu.controller import EngineParams as JEngineParams
from predictionio_tpu.controller import OptionAverageMetric as JOptionAverage
from predictionio_tpu.controller import OptionStdevMetric as JOptionStdev
from predictionio_tpu.controller import StdevMetric as JStdevMetric
from predictionio_tpu.controller import SumMetric as JSumMetric
from predictionio_tpu.controller import ZeroMetric as JZeroMetric
from predictionio_tpu.controller.evaluation import (
    MetricEvaluator as JMetricEvaluator,
)
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import (
    EvaluationInstance as JEvaluationInstance,
)
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation import engine as jeng
from predictionio_tpu.models.recommendation import evaluation as jeval
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithm as JALSAlgorithm,
)
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithmParams as JALSAlgorithmParams,
)
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.models.recommendation.data_source import (
    DataSource as JDataSource,
)
from predictionio_tpu.models.recommendation.data_source import (
    DataSourceParams as JDataSourceParams,
)
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu.workflow import WorkflowContext as JWorkflowContext
from predictionio_tpu.workflow import core_workflow as jcore_workflow
from predictionio_tpu.workflow.fake import FakeRun as JFakeRun
from predictionio_tpu.workflow.fast_eval import (
    FastEvalEngineWorkflow as JFastEval,
)
from predictionio_tpu_torch.controller import (
    AverageMetric, EngineParams, OptionAverageMetric, OptionStdevMetric,
    StdevMetric, SumMetric, ZeroMetric,
)
from predictionio_tpu_torch.controller.evaluation import MetricEvaluator
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    App, EvaluationInstance, Storage,
)
from predictionio_tpu_torch.models.recommendation import engine as teng
from predictionio_tpu_torch.models.recommendation import evaluation as teval
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.data_source import (
    DataSource, DataSourceParams,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops import topk as ttopk
from predictionio_tpu_torch.workflow import core_workflow, model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.fake import FakeRun
from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngineWorkflow

APP = "EvalApp"
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
T = torch.from_numpy


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _events(event_cls, datamap_cls, seed=5, n_users=30, n_items=20,
            n=500):
    """Rate events with half-star ratings and every ninth a buy (rating
    4.0), at distinct times."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for k in range(n):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        buy = k % 9 == 0
        out.append(event_cls(
            event="buy" if buy else "rate", entity_type="user",
            entity_id=f"u{u}", target_entity_type="item",
            target_entity_id=f"i{i}",
            properties=datamap_cls({} if buy else {
                "rating": float(rng.integers(1, 11)) / 2}),
            event_time=t0 + dt.timedelta(seconds=k)))
    return out


def _fill(storage, app_cls, event_cls, datamap_cls, write, **kw):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP))
    storage.get_events().init(app_id)
    write(_events(event_cls, datamap_cls, **kw), app_id, storage=storage)


def _stores(kind, tmp_path):
    """(JAX storage, port storage) holding the same events: two memory
    stores filled alike, or one SQLite file that both packages open."""
    if kind == "memory":
        jstorage, tstorage = JStorage(env=MEM), Storage(env=MEM)
        _fill(jstorage, JApp, JEvent, JDataMap, jstore.write)
        _fill(tstorage, App, Event, DataMap, store.write)
        return jstorage, tstorage
    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    jstorage = JStorage(env=env)
    _fill(jstorage, JApp, JEvent, JDataMap, jstore.write)
    return jstorage, Storage(env=env)


def _ratings(actual):
    return [(r.user, r.item, r.rating) for r in actual.ratings]


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
@pytest.mark.parametrize("k_fold", [2, 5])
def test_read_eval_equals_the_reference(kind, k_fold, tmp_path):
    jstorage, tstorage = _stores(kind, tmp_path)
    ev = {"kFold": k_fold, "queryNum": 7}
    jfolds = JDataSource(JDataSourceParams(APP, ev)).read_eval(
        JWorkflowContext(storage=jstorage))
    tfolds = DataSource(DataSourceParams(APP, ev)).read_eval(
        WorkflowContext(storage=tstorage, device="cpu"))
    assert len(tfolds) == len(jfolds) == k_fold
    for (jtd, jei, jqa), (ttd, tei, tqa) in zip(jfolds, tfolds):
        for f in ("user_idx", "item_idx", "rating"):
            np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))
        assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
        assert ttd.item_vocab.to_dict() == jtd.item_vocab.to_dict()
        assert type(tei).__name__ == type(jei).__name__ == \
            "EmptyEvaluationInfo"
        assert [(q.user, q.num) for q, _a in tqa] == \
            [(q.user, q.num) for q, _a in jqa]
        assert [_ratings(a) for _q, a in tqa] == \
            [_ratings(a) for _q, a in jqa]
        assert all(type(r.rating) is float for _q, a in tqa
                   for r in a.ratings)
    # every rating trains in k - 1 folds and is tested in the other one
    tested = [sum(len(a.ratings) for _q, a in qa) for _td, _ei, qa in tfolds]
    total = sum(tested)
    assert [td.n for td, _ei, _qa in tfolds] == [total - t for t in tested]


def test_read_eval_needs_eval_params():
    with pytest.raises(ValueError, match="evalParams"):
        DataSource(DataSourceParams(APP)).read_eval(
            WorkflowContext(storage=Storage(env=MEM), device="cpu"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _qpa_sets(eng, seed=2, n_folds=3, n_queries=25, n_items=30):
    """Seeded (EI, [(Q, P, A)]) folds in one package's types: predictions
    of 0 to 12 items, actuals of 0 to 8 half-star ratings."""
    rng = np.random.default_rng(seed)
    out = []
    for _fold in range(n_folds):
        qpa = []
        for qx in range(n_queries):
            user = f"u{qx}"
            pred = rng.choice(n_items, size=int(rng.integers(0, 13)),
                              replace=False)
            act = rng.choice(n_items, size=int(rng.integers(0, 9)),
                             replace=False)
            p = eng.PredictedResult(tuple(
                eng.ItemScore(f"i{i}", float(s)) for i, s in zip(
                    pred, np.sort(rng.random(pred.size))[::-1])))
            a = eng.ActualResult(tuple(
                eng.Rating(user, f"i{i}", float(rng.integers(0, 11)) / 2)
                for i in act))
            qpa.append((eng.Query(user, 10), p, a))
        out.append((None, qpa))
    return out


def _count_metric(base):
    """A metric of ``base`` scoring a query by its predicted item count,
    None when it predicted nothing."""
    class CountMetric(base):
        def calculate_qpa(self, q, p, a):
            return len(p.itemScores) or None
    return CountMetric()


_METRICS = {
    **{f"precision_k{k}_t{t}": (
        lambda m, k=k, t=t: m.PrecisionAtK(k=k, ratingThreshold=t))
        for k in (1, 3, 10) for t in (0.0, 2.0, 4.0)},
    **{f"positive_count_t{t}": (
        lambda m, t=t: m.PositiveCount(ratingThreshold=t))
        for t in (1.0, 4.0)},
}

_GENERIC = {
    "average": (JAverageMetric, AverageMetric),
    "option_average": (JOptionAverage, OptionAverageMetric),
    "stdev": (JStdevMetric, StdevMetric),
    "option_stdev": (JOptionStdev, OptionStdevMetric),
    "sum": (JSumMetric, SumMetric),
}


@pytest.mark.parametrize("name", sorted(_METRICS))
def test_recommendation_metrics_equal_the_reference(name):
    make = _METRICS[name]
    jm, tm = make(jeval), make(teval)
    got = tm.calculate(_qpa_sets(teng))
    want = jm.calculate(_qpa_sets(jeng))
    assert str(tm) == str(jm)
    assert got == want or (math.isnan(got) and math.isnan(want))


@pytest.mark.parametrize("name", sorted(_GENERIC))
def test_metric_family_equals_the_reference(name):
    jbase, tbase = _GENERIC[name]
    got = _count_metric(tbase).calculate(_qpa_sets(teng))
    want = _count_metric(jbase).calculate(_qpa_sets(jeng))
    assert got == want
    empty_t = _count_metric(tbase).calculate([])
    empty_j = _count_metric(jbase).calculate([])
    assert empty_t == empty_j or (math.isnan(empty_t)
                                  and math.isnan(empty_j))
    assert ZeroMetric().calculate(_qpa_sets(teng)) == \
        JZeroMetric().calculate(_qpa_sets(jeng)) == 0.0


def test_precision_at_k_refuses_k_0():
    with pytest.raises(ValueError):
        teval.PrecisionAtK(k=0)


def _variants(pkg_params, ds_cls, algo_cls):
    return [pkg_params(data_source_params=ds_cls(APP, {"kFold": 2,
                                                       "queryNum": 4}),
                       algorithm_params_list=(("als", algo_cls(
                           rank=r, numIterations=it, lambda_=0.01,
                           seed=3)),))
            for r, it in ((2, 1), (3, 2), (4, 1))]


def test_metric_evaluator_result_equals_the_reference(tmp_path):
    """Scores, NaN ranked last, JSON, HTML, str and best.json."""
    def run(m, params_cls, ds_cls, algo_cls, eng, out):
        sets = _qpa_sets(eng)
        no_positive = [(ei, [(q, p, eng.ActualResult(())) for q, p, _a in qpa])
                       for ei, qpa in sets]
        variants = _variants(params_cls, ds_cls, algo_cls)
        data = list(zip(variants, (no_positive, sets, sets[:1])))
        evaluator_cls = (MetricEvaluator if m is teval
                         else JMetricEvaluator)
        ev = evaluator_cls(m.PrecisionAtK(k=3), (m.PositiveCount(),),
                           output_path=str(out))
        return ev.evaluate_base(None, None, data)

    tres = run(teval, EngineParams, DataSourceParams, ALSAlgorithmParams,
               teng, tmp_path / "t" / "best.json")
    jres = run(jeval, JEngineParams, JDataSourceParams, JALSAlgorithmParams,
               jeng, tmp_path / "j" / "best.json")
    assert math.isnan(tres.engine_params_scores[0].score)
    assert tres.best_idx == jres.best_idx != 0
    assert tres.to_json() == jres.to_json()
    assert tres.to_html() == jres.to_html()
    assert str(tres) == str(jres)
    assert (tmp_path / "t" / "best.json").read_text() == \
        (tmp_path / "j" / "best.json").read_text()


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _assert_separated_indices_equal(scores, ti, ji, k, rtol):
    """Indices must agree at every rank whose score is separated from
    its neighbours by more than ``rtol`` (tests/test_torch_topk.py)."""
    s = np.sort(scores)[::-1][:k + 1]
    gaps = np.abs(np.diff(s)) > rtol * np.maximum(np.abs(s[1:]), 1.0)
    sep = np.ones(min(k, len(s)), bool)
    n = len(sep)
    if n > 1:
        sep[:-1] &= gaps[:n - 1]
        sep[1:] &= gaps[:n - 1]
    if len(gaps) >= n:
        sep[-1] &= gaps[n - 1]
    np.testing.assert_array_equal(ti[sep], ji[sep])


def _dyadic(x, step=1 / 128, bound=3.9):
    """``x`` on a grid of ``step`` within +-``bound``: a rank-20 product
    of such values is a multiple of 2^-14 below 2^9 in magnitude, so
    every partial sum is exact in fp32 and no summation order can change
    a score."""
    return (np.round(np.clip(x, -bound, bound) / step) * step).astype(
        np.float32)


def _scoring_inputs(rank, mask_kind, exact, b=9, n_items=400, seed=6):
    rng = np.random.default_rng(seed + rank)
    Q = rng.normal(size=(b, rank)).astype(np.float32)
    V = rng.normal(size=(n_items, rank)).astype(np.float32)
    if exact:
        Q, V = _dyadic(Q), _dyadic(V)
    V[[150, 151, 390]] = V[7]           # ties the index order resolves
    mask = None
    if mask_kind == "items":
        mask = rng.random(n_items) > 0.3
        mask[7] = mask[151] = True
    elif mask_kind == "rows":
        mask = rng.random((b, n_items)) > 0.5
    return Q, V, mask


def _both(Q, V, mask, k):
    jv, ji = (np.asarray(a) for a in jtopk.topk_scores_batch(
        Q, V, mask, k=k))
    tv, ti = ttopk.topk_scores_batch(
        T(Q), T(V), None if mask is None else T(mask), k=k)
    assert ti.dtype == torch.int32
    return jv, ji, tv.numpy(), ti.numpy()


@pytest.mark.parametrize("mask_kind", [None, "items", "rows"])
@pytest.mark.parametrize("rank,k", [(10, 1), (10, 10), (10, 37),
                                    (20, 10), (20, 400)])
def test_topk_scores_batch_exact_where_scores_are(mask_kind, rank, k):
    """Scores that every summation order rounds alike: the mask, the
    NEG_INF sentinel and the tie rule (descending score, lowest index)
    agree bit for bit, down to the whole catalog."""
    jv, ji, tv, ti = _both(*_scoring_inputs(rank, mask_kind, True), k)
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("mask_kind", [None, "items", "rows"])
@pytest.mark.parametrize("rank,n_items", [(10, 400), (10, 500), (20, 400)])
def test_topk_scores_batch_within_tolerance(mask_kind, rank, n_items):
    """Gaussian factors: XLA's CPU dot and torch's sgemm sum a row in
    orders that agree at some shapes (rank 10, 500 items) and not at
    others (rank 10, 400 items: over half the scores differ by an ulp),
    so scores agree within 1e-6 relative and indices wherever the
    reference's neighbouring scores are further apart than that."""
    k = 25
    Q, V, mask = _scoring_inputs(rank, mask_kind, False, n_items=n_items)
    jv, ji, tv, ti = _both(Q, V, mask, k)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    full = Q @ V.T
    if mask is not None:
        full = np.where(mask, full, np.float32(ttopk.NEG_INF))
    for row in range(Q.shape[0]):
        _assert_separated_indices_equal(full[row], ti[row], ji[row], k,
                                        1e-6)


@pytest.mark.parametrize("rows", [1, 2, 4, 9])
def test_topk_scores_batch_chunks_change_nothing(rows, monkeypatch):
    """Chunks of ``rows`` rows give the one-chunk answer exactly."""
    Q, V, mask = _scoring_inputs(10, "rows", True)
    whole = ttopk.topk_scores_batch(T(Q), T(V), T(mask), k=12)
    monkeypatch.setattr(ttopk, "CHUNK_BYTES", rows * 4 * V.shape[0])
    chunked = ttopk.topk_scores_batch(T(Q), T(V), T(mask), k=12)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("exact", [True, False])
def test_topk_scores_equals_the_reference(exact):
    Q, V, mask = _scoring_inputs(10, "items", exact)
    jv, ji = (np.asarray(a) for a in jtopk.topk_scores(
        Q[0], V, mask, k=15))
    tv, ti = (a.numpy() for a in ttopk.topk_scores(
        T(Q[0]), T(V), T(mask), k=15))
    if exact:
        np.testing.assert_array_equal(_bits(tv), _bits(jv))
        np.testing.assert_array_equal(ti, ji)
    # a matvec's summation order is the backend's (tests/test_torch_topk.py)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    _assert_separated_indices_equal(
        np.where(mask, V @ Q[0], np.float32(ttopk.NEG_INF)), ti, ji, 15,
        1e-6)


_ASKS = [("u3", 4), ("nobody", 5), ("u7", 0), ("u11", -2), ("u0", 10),
         ("u29", 40), ("u3", 1), ("u5", 25)]


def _batch_predict_both(rank, exact):
    """JAX-trained factors carried across (``exact``: put on the dyadic
    grid first) through both packages' batch_predict, with unknown
    users, num 0, a negative num and num past the catalog."""
    rng = np.random.default_rng(rank)
    n_users, n_items = 30, 25
    u = rng.integers(0, n_users, 400)
    i = rng.integers(0, n_items, 400)
    r = (rng.integers(1, 11, 400) / 2).astype(np.float32)
    data = jals.prepare_ratings(u, i, r, n_users=n_users, n_items=n_items)
    U, V = (np.asarray(a) for a in jals.train_explicit(
        data, rank=rank, iterations=3, lambda_=0.05, seed=3))
    if exact:
        U, V = _dyadic(U), _dyadic(V)
    users = {f"u{x}": x for x in range(n_users)}
    items = {f"i{x}": x for x in range(n_items)}
    tmodel = model_io.als_model_from_numpy(rank, U, V, users, items)
    jmodel = JALSModel(rank=rank, user_factors=U, item_factors=V,
                       user_vocab=JBiMap(users), item_vocab=JBiMap(items))
    params = dict(rank=rank, numIterations=3, lambda_=0.05, seed=3)
    tgot = dict(ALSAlgorithm(ALSAlgorithmParams(**params)).batch_predict(
        tmodel, [(qx, teng.Query(user, n))
                 for qx, (user, n) in enumerate(_ASKS)], device="cpu"))
    jgot = dict(JALSAlgorithm(JALSAlgorithmParams(**params)).batch_predict(
        jmodel, [(qx, jeng.Query(user, n))
                 for qx, (user, n) in enumerate(_ASKS)]))
    assert sorted(tgot) == sorted(jgot) == list(range(len(_ASKS)))
    for qx, (user, n) in enumerate(_ASKS):
        assert len(tgot[qx].itemScores) == len(jgot[qx].itemScores) == (
            0 if user == "nobody" else max(min(n, n_items), 0))
    return tgot, jgot, U, V, users, items


def _pairs(result):
    return [(s.item, s.score) for s in result.itemScores]


@pytest.mark.parametrize("rank", [10, 20])
def test_batch_predict_exact_on_factors_carried_across(rank):
    """Factors whose scores every order rounds alike: the same
    PredictedResults, and so the same metrics, bit for bit."""
    tgot, jgot, *_ = _batch_predict_both(rank, exact=True)
    for qx in tgot:
        assert _pairs(tgot[qx]) == _pairs(jgot[qx])
    sets = lambda eng, got: [(None, [  # noqa: E731
        (eng.Query(user, n), got[qx], eng.ActualResult(tuple(
            eng.Rating(user, f"i{x}", float(x % 5)) for x in range(0, 25, 2))))
        for qx, (user, n) in enumerate(_ASKS)])]
    for k, t in ((1, 0.0), (3, 2.0), (10, 4.0)):
        assert teval.PrecisionAtK(k=k, ratingThreshold=t).calculate(
            sets(teng, tgot)) == jeval.PrecisionAtK(
                k=k, ratingThreshold=t).calculate(sets(jeng, jgot))


@pytest.mark.parametrize("rank", [10, 20])
def test_batch_predict_within_tolerance_on_trained_factors(rank):
    tgot, jgot, U, V, users, items = _batch_predict_both(rank, exact=False)
    for qx, (user, _n) in enumerate(_ASKS):
        t, j = _pairs(tgot[qx]), _pairs(jgot[qx])
        np.testing.assert_allclose([s for _i, s in t], [s for _i, s in j],
                                   rtol=1e-6, atol=1e-6)
        if t:
            _assert_separated_indices_equal(
                V @ U[users[user]],
                np.asarray([items[x] for x, _s in t], np.int64),
                np.asarray([items[x] for x, _s in j], np.int64),
                len(t), 1e-6)


def test_batch_predict_with_no_known_user_or_no_num():
    m = model_io.als_model_from_numpy(
        2, np.ones((2, 2)), np.ones((3, 2)), {"a": 0, "b": 1},
        {"x": 0, "y": 1, "z": 2})
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=2))
    assert algo.batch_predict(m, []) == []
    got = algo.batch_predict(m, [(0, teng.Query("zz", 3)),
                                 (1, teng.Query("a", 0))])
    assert sorted(got) == [(0, teng.PredictedResult(())),
                           (1, teng.PredictedResult(()))]


@pytest.mark.parametrize("case", ["device_cpu", "env_cpu", "no_card",
                                  "trained_tensors"])
def test_batch_predict_follows_the_device_policy(monkeypatch, case):
    """A loaded model's numpy factors go to the resolved device: the CPU
    when the caller or PIO_TORCH_DEVICE asks for it (the same answer as
    scoring CPU tensors), the card otherwise, which raises without one.
    Trained factors keep their device."""
    rng = np.random.default_rng(5)
    U = _dyadic(rng.normal(size=(6, 4)))
    V = _dyadic(rng.normal(size=(9, 4)))
    users = {f"u{x}": x for x in range(6)}
    items = {f"i{x}": x for x in range(9)}
    asks = [(0, teng.Query("u1", 3)), (1, teng.Query("u4", 9))]
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=4))
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = model_io.als_model_from_numpy(4, U, V, users, items)
    assert isinstance(loaded.user_factors, np.ndarray)
    trained = dataclasses.replace(loaded, user_factors=torch.from_numpy(U),
                                  item_factors=torch.from_numpy(V))
    want = dict(algo.batch_predict(trained, asks))
    if case == "no_card":
        with pytest.raises(RuntimeError, match="is_available"):
            algo.batch_predict(loaded, asks)
        return
    if case == "device_cpu":
        got = algo.batch_predict(loaded, asks, device="cpu")
    elif case == "env_cpu":
        monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
        got = algo.batch_predict(loaded, asks)
    else:
        got = want
    assert dict(got) == want
    for qx, (user, n) in enumerate([("u1", 3), ("u4", 9)]):
        scores = V @ U[users[user]]
        assert [s.item for s in want[qx].itemScores] == [
            f"i{x}" for x in np.argsort(-scores, kind="stable")[:n]]


# ---------------------------------------------------------------------------
# the workflow
# ---------------------------------------------------------------------------

def _fixed_seed_factors(seed, n_users, n_items, rank, **_kw):
    rng = np.random.default_rng(1234 + rank)
    U = np.abs(rng.normal(size=(n_users, rank))) / np.sqrt(rank)
    V = np.abs(rng.normal(size=(n_items, rank))) / np.sqrt(rank)
    return U.astype(np.float32), V.astype(np.float32)


def _grid(m, params_cls, ds_cls, algo_cls, ranks=(2, 4), iters=(2, 5),
          k_fold=3):
    ds = ds_cls(appName=APP, evalParams={"kFold": k_fold, "queryNum": 6})
    return [params_cls(data_source_params=ds, algorithm_params_list=(
        ("als", algo_cls(rank=r, numIterations=it, lambda_=0.05, seed=3)),))
        for r in ranks for it in iters]


class _Recorded:
    """Mixin recording each workflow a run builds."""
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        type(self).made.append(self)


def _run_both(monkeypatch, tmp_path):
    monkeypatch.setattr(jals, "_seed_factors", _fixed_seed_factors)
    monkeypatch.setattr(als, "_seed_factors", _fixed_seed_factors)
    JRec = type("JRec", (_Recorded, JFastEval), {"made": []})
    TRec = type("TRec", (_Recorded, FastEvalEngineWorkflow), {"made": []})
    monkeypatch.setattr(jcore_workflow, "FastEvalEngineWorkflow", JRec)
    monkeypatch.setattr(core_workflow, "FastEvalEngineWorkflow", TRec)
    jstorage, tstorage = _stores("memory", tmp_path)
    jctx = JWorkflowContext(storage=jstorage)
    tctx = WorkflowContext(storage=tstorage, device="cpu")
    jres = jcore_workflow.run_evaluation(
        jctx, jeval.RecommendationEvaluation(),
        _grid(jeval, JEngineParams, JDataSourceParams, JALSAlgorithmParams),
        evaluation_class="RecommendationEvaluation",
        output_path=str(tmp_path / "j" / "best.json"))
    tres = core_workflow.run_evaluation(
        tctx, teval.RecommendationEvaluation(),
        _grid(teval, EngineParams, DataSourceParams, ALSAlgorithmParams),
        evaluation_class="RecommendationEvaluation",
        output_path=str(tmp_path / "t" / "best.json"))
    (jwf,), (twf,) = JRec.made, TRec.made
    return jres, tres, jwf, twf, jstorage, tstorage


def _keys(obj, prefix=""):
    if isinstance(obj, dict):
        return sorted(k for key, v in obj.items()
                      for k in [prefix + key] + _keys(v, prefix + key + "."))
    if isinstance(obj, list):
        return sorted(k for v in obj for k in _keys(v, prefix + "[]."))
    return []


def test_run_evaluation_end_to_end_against_the_reference(monkeypatch,
                                                          tmp_path):
    jres, tres, jwf, twf, jstorage, tstorage = _run_both(monkeypatch,
                                                         tmp_path)
    assert len(tres.engine_params_scores) == 4
    for t, j in zip(tres.engine_params_scores, jres.engine_params_scores):
        assert t.engine_params.algorithm_params_list[0][1].rank == \
            j.engine_params.algorithm_params_list[0][1].rank
        assert abs(t.score - j.score) <= 0.02
        for a, b in zip(t.other_scores, j.other_scores):
            assert abs(a - b) <= 0.02 * max(1.0, abs(b))
        assert 0.0 <= t.score <= 1.0
    assert tres.metric_header == jres.metric_header
    assert tres.other_metric_headers == jres.other_metric_headers
    assert _keys(json.loads(tres.to_json())) == \
        _keys(json.loads(jres.to_json()))
    tbest = json.loads((tmp_path / "t" / "best.json").read_text())
    jbest = json.loads((tmp_path / "j" / "best.json").read_text())
    assert _keys(tbest) == _keys(jbest)
    # best.json loads back as an engine variant
    ep = teng.RecommendationEngine().engine_params_from_json(tbest)
    assert ep.algorithm_params_list[0][1] == \
        tres.best_engine_params.algorithm_params_list[0][1]
    for storage in (tstorage, jstorage):
        (row,) = storage.get_meta_data_evaluation_instances().get_all()
        assert row.status == "EVALCOMPLETED"
        assert json.loads(row.evaluator_results_json)["metricHeader"] == \
            tres.metric_header
    # the prefix counts, then the fully cached re-evaluation
    want = {"read_eval": 1, "prepare": 1, "train": 4, "serve": 4,
            "layout_prefixes": 1}
    assert twf.counts == jwf.counts == want
    for ep_t, ep_j in zip(
            _grid(teval, EngineParams, DataSourceParams, ALSAlgorithmParams),
            _grid(jeval, JEngineParams, JDataSourceParams,
                  JALSAlgorithmParams)):
        assert twf.eval(ep_t) is twf.eval(ep_t)
        jwf.eval(ep_j)
    assert twf.counts == jwf.counts == want
    # the memoized path equals Engine.eval's unmemoized one
    ep = _grid(teval, EngineParams, DataSourceParams, ALSAlgorithmParams,
               ranks=(2,), iters=(2,))[0]
    plain = teng.RecommendationEngine().eval(twf.ctx, ep)
    cached = twf.eval(ep)
    assert [[(q, p, a) for q, p, a in qpa] for _ei, qpa in plain] == \
        [[(q, p, a) for q, p, a in qpa] for _ei, qpa in cached]


def test_each_fold_builds_one_layout_for_every_variant(monkeypatch):
    built = []
    real = als.prepare_ratings

    def counting(*a, **kw):
        built.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(als, "prepare_ratings", counting)
    storage = Storage(env=MEM)
    _fill(storage, App, Event, DataMap, store.write)
    wf = FastEvalEngineWorkflow(teng.RecommendationEngine(),
                                WorkflowContext(storage=storage,
                                                device="cpu"))
    grid = _grid(teval, EngineParams, DataSourceParams, ALSAlgorithmParams,
                 ranks=(2, 3), iters=(1,), k_fold=2)
    wf.prepare_shared_layouts(grid)
    assert len(built) == 2                 # one layout per fold
    for ep in grid:
        wf.eval(ep)
    assert len(built) == 2
    assert wf.counts == {"read_eval": 1, "prepare": 1, "train": 2,
                         "serve": 2, "layout_prefixes": 1}


def test_a_failed_evaluation_marks_its_row_error():
    storage = Storage(env=MEM)        # no app: the read fails
    ctx = WorkflowContext(storage=storage, device="cpu")
    with pytest.raises(store.StoreError, match="Invalid app name"):
        core_workflow.run_evaluation(
            ctx, teval.RecommendationEvaluation(),
            _grid(teval, EngineParams, DataSourceParams,
                  ALSAlgorithmParams)[:1])
    (row,) = storage.get_meta_data_evaluation_instances().get_all()
    assert row.status == "ERROR"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fake_run_leaves_only_the_ledger_row(pkg):
    seen = []
    if pkg == "port":
        base, storage = FakeRun, Storage(env=MEM)
        ctx = WorkflowContext(storage=storage, device="cpu")
        run = core_workflow.run_evaluation
    else:
        base, storage = JFakeRun, JStorage(env=MEM)
        ctx = JWorkflowContext(storage=storage)
        run = jcore_workflow.run_evaluation

    class Hello(base):
        def func(self, ctx):
            seen.append(ctx)

    hello = Hello()
    result = run(ctx, hello, hello.engine_params_list,
                 evaluation_class="Hello")
    assert seen == [ctx] and result.no_save and str(result) == \
        "FakeEvalResult()"
    (row,) = storage.get_meta_data_evaluation_instances().get_all()
    assert row.status == "EVALCOMPLETED"
    assert (row.evaluator_results, row.evaluator_results_html,
            row.evaluator_results_json) == ("", "", "")
    assert row.evaluation_class == "Hello"


_ROW = dict(
    id="", status="EVALCOMPLETED",
    start_time=dt.datetime(2024, 5, 1, 12, 0, 1, 250000,
                           tzinfo=dt.timezone.utc),
    end_time=dt.datetime(2024, 5, 1, 12, 3, tzinfo=dt.timezone.utc),
    evaluation_class="x.evaluation:RecommendationEvaluation",
    engine_params_generator_class="x.evaluation:EngineParamsList",
    batch="nightly", env={"A": "1"}, runtime_conf={"b": "2"},
    evaluator_results="text", evaluator_results_html="<h3>h</h3>",
    evaluator_results_json='{"bestIdx": 2}')


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_evaluation_instances_read_across_packages(writer, tmp_path):
    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    tdao = Storage(env=env).get_meta_data_evaluation_instances()
    jdao = JStorage(env=env).get_meta_data_evaluation_instances()
    w, r, w_cls = ((tdao, jdao, EvaluationInstance) if writer == "port"
                   else (jdao, tdao, JEvaluationInstance))
    iid = w.insert(w_cls(**_ROW))
    got = r.get(iid)
    assert dataclasses.asdict(got) == {**_ROW, "id": iid}
    assert [x.id for x in r.get_completed()] == [iid]
    w.update(dataclasses.replace(w.get(iid), status="ERROR"))
    assert r.get(iid).status == "ERROR" and r.get_completed() == []
    w.delete(iid)
    assert r.get(iid) is None and r.get_all() == []


def test_memory_evaluation_instances():
    dao = Storage(env=MEM).get_meta_data_evaluation_instances()
    old = dao.insert(EvaluationInstance(**{**_ROW, "start_time": dt.datetime(
        2023, 1, 1, tzinfo=dt.timezone.utc)}))
    new = dao.insert(EvaluationInstance(**_ROW))
    dao.insert(EvaluationInstance(**{**_ROW, "status": "INIT"}))
    assert [x.id for x in dao.get_completed()] == [new, old]
    dao.delete(old)
    assert len(dao.get_all()) == 2 and dao.get(old) is None
