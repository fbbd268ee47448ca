"""The classification, similar-product and e-commerce templates of the
port, on the CPU, in three parts:

1. the JAX package's ``tests/test_templates.py`` cases replayed through
   the port (train, predict, k-fold eval, the live business rules, the
   deploy), plus the degraded flag and ``bind_serving``;
2. serving on shared factors: both packages' models built from the same
   numpy ``U`` / ``V`` and the same store events answer ``predict`` and
   ``predict_batch`` with the same items and bit-equal scores (host
   numpy in both: exact class);
3. training: the rating arrays each template hands ``prepare_ratings``
   (``_ratings``, latest wins) are exact, and with the same ``u0`` /
   ``v0`` injected the trained factors agree to rtol 2e-3 / atol 2e-4
   (the ALS whole-train tolerance of ``tests/test_torch_als.py``).
"""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.controller import EngineParams as JEngineParams
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.e2.evaluation import split_data as jsplit_data
from predictionio_tpu.models import classification as jcls
from predictionio_tpu.models import ecommerce as jecom
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu.models.ecommerce.als_algorithm import (
    ECommModel as JECommModel,
)
from predictionio_tpu.models.similarproduct.als_algorithm import (
    ALSModel as JSimModel, build_category_masks as jbuild_category_masks,
)
from predictionio_tpu.ops import als as jals
from predictionio_tpu.workflow.context import (
    WorkflowContext as JWorkflowContext,
)
from predictionio_tpu_torch.common import resilience
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.e2.evaluation import split_data
from predictionio_tpu_torch.models import classification as cls
from predictionio_tpu_torch.models import ecommerce as ecom
from predictionio_tpu_torch.models import similarproduct as sim
from predictionio_tpu_torch.models.ecommerce.als_algorithm import ECommModel
from predictionio_tpu_torch.models.similarproduct.als_algorithm import (
    ALSModel as SimModel, build_category_masks,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.create_server import (
    QueryAPI, ServerConfig,
)

UTC = dt.timezone.utc
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")


# ---------------------------------------------------------------------------
# events, written alike into either package's store
# ---------------------------------------------------------------------------

def _set(entity_type, entity_id, props, minute=0, day=1):
    return dict(event="$set", entity_type=entity_type, entity_id=entity_id,
                properties=props,
                event_time=dt.datetime(2021, 1, day, 0, minute % 60,
                                       tzinfo=UTC))


def _ev(name, user, item, props=None, minute=0, hour=1):
    return dict(event=name, entity_type="user", entity_id=user,
                target_entity_type="item", target_entity_id=item,
                properties=props or {},
                event_time=dt.datetime(2021, 1, 1, hour, minute % 60,
                                       tzinfo=UTC))


def _as(specs, event_cls, map_cls):
    return [event_cls(**{**d, "properties": map_cls(d["properties"])})
            for d in specs]


def _app(storage, name, app_cls=App):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, name, None))
    storage.get_events().init(app_id)
    return app_id


def _write(storage, app_id, specs):
    store.write(_as(specs, Event, DataMap), app_id, storage=storage)


def _jwrite(storage, app_id, specs):
    jstore.write(_as(specs, JEvent, JDataMap), app_id, storage=storage)


@pytest.fixture()
def port_store(monkeypatch):
    """A fresh memory store, also the port's process-global one."""
    st = Storage(env=MEM)
    monkeypatch.setattr(storage_mod, "_storage", st)
    return st


def _cls_events():
    # multinomial NB separates by feature PROPORTIONS: plan 0 mass on
    # attr0, plan 1 mass on attr2
    out = []
    for n in range(20):
        plan = n % 2
        lo, hi = 0.0 + (n % 3), 8.0 + (n % 3)
        out.append(_set("user", f"u{n}", {
            "plan": float(plan), "attr0": hi if plan == 0 else lo,
            "attr1": 2.0, "attr2": lo if plan == 0 else hi}, minute=n))
    # a user missing attributes must be excluded by `required`
    out.append(_set("user", "incomplete", {"plan": 1.0}, minute=50))
    return out


def _sim_events():
    out = [_set("user", f"u{u}", {}, minute=u) for u in range(8)]
    out += [_set("item", f"i{i}", {"categories": ["even" if i % 2 == 0
                                                  else "odd"]},
                 minute=10 + i) for i in range(6)]
    m = 0
    for u in range(8):                   # co-views of matching parity
        for i in range(6):
            if (u % 2) == (i % 2):
                m += 1
                out.append(_ev("view", f"u{u}", f"i{i}", minute=m))
    m = 0
    for u in range(8):
        for i in range(6):
            m += 1
            name = "like" if (u % 2) == (i % 2) else "dislike"
            out.append(_ev(name, f"u{u}", f"i{i}", minute=m, hour=2))
    # u0 changed their mind about i1: like then dislike (latest wins)
    out.append(_ev("like", "u0", "i1", minute=58, hour=2))
    out.append(_ev("dislike", "u0", "i1", minute=59, hour=3))
    return out


def _ecom_events():
    out = [_set("user", f"u{u}", {}, minute=u) for u in range(8)]
    out += [_set("item", f"i{i}", {"categories": ["even" if i % 2 == 0
                                                  else "odd"]},
                 minute=10 + i) for i in range(6)]
    m = 0
    for u in range(8):
        for i in range(6):
            m += 1
            r = 5.0 if (u % 2) == (i % 2) else 1.0
            out.append(_ev("rate", f"u{u}", f"i{i}", {"rating": r},
                           minute=m))
    # u0 re-rated i1 (1.0 -> 5.0, later timestamp wins)
    out.append(_ev("rate", "u0", "i1", {"rating": 5.0}, minute=30, hour=2))
    return out


def _unavailable(items, day=2):
    return _set("constraint", "unavailableItems", {"items": items}, day=day)


def _weights(groups, day=2):
    return _set("constraint", "weightedItems", {"weights": groups}, day=day)


def _assert_batch_matches_sequential(seq, bat):
    """Batched host serving: same items in the same order; scores equal
    up to the last-bit difference of one gemm row against a gemv."""
    assert len(seq) == len(bat)
    for a, b in zip(seq, bat):
        assert [s.item for s in a.itemScores] == \
            [s.item for s in b.itemScores]
        np.testing.assert_allclose(
            [s.score for s in a.itemScores],
            [s.score for s in b.itemScores], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# 1. the reference's template cases, through the port
# ---------------------------------------------------------------------------

class TestClassification:
    @pytest.fixture()
    def ctx(self, port_store):
        _write(port_store, _app(port_store, "ClsApp"), _cls_events())
        return WorkflowContext(storage=port_store, device="cpu")

    def test_train_and_predict(self, ctx):
        engine = cls.ClassificationEngine()
        ep = EngineParams(
            data_source_params=cls.DataSourceParams(appName="ClsApp"),
            algorithm_params_list=(
                ("naive", cls.NaiveBayesAlgorithmParams(lambda_=1.0)),))
        ds, _prep, algos, _serv = engine._instantiate(ep)
        td = ds.read_training(ctx)
        assert len(td.labeled_points) == 20  # incomplete user excluded
        model = algos[0].train(ctx, td)
        p0 = algos[0].predict(model, cls.Query(features=(9.0, 2.0, 1.0)))
        p1 = algos[0].predict(model, cls.Query(features=(1.0, 2.0, 9.0)))
        assert p0.label == 0.0 and p1.label == 1.0

    def test_engine_json_and_eval(self, ctx):
        engine = cls.ClassificationEngine()
        ep = engine.engine_params_from_json({
            "datasource": {"params": {"appName": "ClsApp", "evalK": 3}},
            "algorithms": [{"name": "naive", "params": {"lambda": 0.5}}],
        })
        assert ep.algorithm_params_list[0][1].lambda_ == 0.5
        folds = engine.eval(ctx, ep)
        assert len(folds) == 3
        correct = total = 0
        for _ei, qpa in folds:
            for _q, p, a in qpa:
                total += 1
                correct += (p.label == a)
        assert total == 20 and correct / total >= 0.9

    def test_read_eval_splits_as_the_reference(self, ctx):
        """split_data is exact: the same points in the same folds, with
        the same queries and actuals, as the JAX package's read_eval."""
        jst = JStorage(env=MEM)
        _jwrite(jst, _app(jst, "ClsApp", JApp), _cls_events())
        folds = cls.DataSource(cls.DataSourceParams(
            appName="ClsApp", evalK=4)).read_eval(ctx)
        jfolds = jcls.DataSource(jcls.DataSourceParams(
            appName="ClsApp", evalK=4)).read_eval(
                JWorkflowContext(storage=jst))
        assert len(folds) == len(jfolds) == 4
        for (td, _ei, qa), (jtd, _jei, jqa) in zip(folds, jfolds):
            assert [dataclasses.astuple(p) for p in td.labeled_points] == \
                [dataclasses.astuple(p) for p in jtd.labeled_points]
            assert [(q.features, a) for q, a in qa] == \
                [(q.features, a) for q, a in jqa]
        assert sum(len(qa) for _td, _ei, qa in folds) == 20
        points = list(range(23))
        assert split_data(4, points, "ei", list, lambda p: -p,
                          lambda p: 2 * p) == \
            jsplit_data(4, points, "ei", list, lambda p: -p,
                        lambda p: 2 * p)


class TestSimilarProduct:
    @pytest.fixture()
    def ctx(self, port_store):
        _write(port_store, _app(port_store, "SimApp"), _sim_events())
        return WorkflowContext(storage=port_store, device="cpu")

    @staticmethod
    def _train(ctx, algo_name="als"):
        engine = sim.SimilarProductEngine()
        ep = EngineParams(
            data_source_params=sim.DataSourceParams(appName="SimApp"),
            algorithm_params_list=((algo_name, sim.ALSAlgorithmParams(
                rank=4, numIterations=10, lambda_=0.01, seed=3)),))
        ds, _p, algos, _s = engine._instantiate(ep)
        td = ds.read_training(ctx)
        return algos[0], algos[0].train(ctx, td), td

    def test_similar_items_match_parity(self, ctx):
        algo, model, td = self._train(ctx)
        assert len(td.view_events) == 24
        assert isinstance(model.product_features, np.ndarray)
        res = algo.predict(model, sim.Query(items=("i0",), num=2))
        assert len(res.itemScores) == 2
        assert {s.item for s in res.itemScores} <= {"i2", "i4"}
        scores = [s.score for s in res.itemScores]
        assert scores == sorted(scores, reverse=True)

    def test_filters(self, ctx):
        algo, model, _td = self._train(ctx)
        Q = sim.Query
        res = algo.predict(model, Q(items=("i0",), num=4,
                                    categories=("odd",)))
        assert all(s.item in {"i1", "i3", "i5"} for s in res.itemScores)
        res = algo.predict(model, Q(items=("i0",), num=4,
                                    whiteList=("i2",)))
        assert {s.item for s in res.itemScores} <= {"i2"}
        res = algo.predict(model, Q(items=("i0",), num=4,
                                    blackList=("i2",)))
        assert "i2" not in {s.item for s in res.itemScores}
        # query items themselves are never candidates
        res = algo.predict(model, Q(items=("i0", "i2", "i4"), num=6))
        assert not ({"i0", "i2", "i4"} & {s.item for s in res.itemScores})
        # unknown query item -> empty
        assert algo.predict(model, Q(items=("nope",), num=3)).itemScores \
            == ()

    def test_predict_batch_matches_sequential(self, ctx):
        algo, model, _td = self._train(ctx)
        Q = sim.Query
        queries = [
            Q(items=("i0",), num=2),
            Q(items=("i0",), num=4, categories=("odd",)),
            Q(items=("nope",), num=3),
            Q(items=("i0", "i2", "i4"), num=6),
            Q(items=("i1",), num=3, blackList=("i3",)),
            Q(items=("i0",), num=4, whiteList=("i2",)),
        ]
        seq = [algo.predict(model, q) for q in queries]
        bat = algo.predict_batch(model, queries)
        _assert_batch_matches_sequential(seq, bat)
        assert bat[2].itemScores == ()

    def test_like_algorithm_latest_wins(self, ctx):
        algo, _model, td = self._train(ctx, algo_name="likealgo")
        uv = BiMap.string_int(td.users.keys())
        iv = BiMap.string_int(td.items.keys())
        ratings = algo._ratings(td, uv, iv)
        assert ratings[(uv("u0"), iv("i1"))] == -1.0
        assert ratings[(uv("u0"), iv("i0"))] == 1.0


class TestECommerce:
    @pytest.fixture()
    def app(self, port_store):
        app_id = _app(port_store, "EcomApp")
        _write(port_store, app_id, _ecom_events())
        return app_id

    @staticmethod
    def _train(storage, **params):
        engine = ecom.ECommerceEngine()
        ap = ecom.ECommAlgorithmParams(
            appName="EcomApp", rank=4, numIterations=10, lambda_=0.05,
            seed=3, **params)
        ep = EngineParams(
            data_source_params=ecom.DataSourceParams(appName="EcomApp"),
            algorithm_params_list=(("ecomm", ap),))
        ctx = WorkflowContext(storage=storage, device="cpu")
        ds, _p, algos, _s = engine._instantiate(ep)
        algos[0].bind_serving(ctx)
        td = ds.read_training(ctx)
        return algos[0], algos[0].train(ctx, td), td

    def test_known_user_scoring(self, port_store, app):
        algo, model, _td = self._train(port_store)
        assert isinstance(model.user_features, np.ndarray)
        res = algo.predict(model, ecom.Query(user="u1", num=3))
        assert len(res.itemScores) == 3
        assert {s.item for s in res.itemScores} <= {"i1", "i3", "i5"}

    def test_unseen_only_filters_seen(self, port_store, app):
        algo, model, _td = self._train(port_store, unseenOnly=True,
                                       seenEvents=("rate",))
        # u1 rated everything -> nothing unseen remains
        assert algo.predict(model, ecom.Query(user="u1", num=6)
                            ).itemScores == ()

    def test_unavailable_items_constraint(self, port_store, app):
        algo, model, _td = self._train(port_store)
        _write(port_store, app, [_unavailable(["i1", "i3"])])
        res = algo.predict(model, ecom.Query(user="u1", num=6))
        assert not ({"i1", "i3"} & {s.item for s in res.itemScores})
        assert "i5" in {s.item for s in res.itemScores}

    def test_weighted_items_boost_scores(self, port_store, app):
        algo, model, _td = self._train(port_store, weightedItems=True)
        base = algo.predict(model, ecom.Query(user="u1", num=3))
        top = {s.item for s in base.itemScores}
        assert top <= {"i1", "i3", "i5"}
        _write(port_store, app, [_weights([
            {"items": ["i1", "i3", "i5"], "weight": 0.001},
            {"items": ["i0"], "weight": 100.0}])])
        res = algo.predict(model, ecom.Query(user="u1", num=3))
        assert res.itemScores[0].item == "i0"
        # latest $set wins: clearing the constraint restores the ranking
        _write(port_store, app, [_weights([], day=3)])
        res = algo.predict(model, ecom.Query(user="u1", num=3))
        assert {s.item for s in res.itemScores} == top

    def test_new_user_falls_back_to_recent_views(self, port_store, app):
        algo, model, _td = self._train(port_store)
        _write(port_store, app, [_ev("view", "newbie", "i0", minute=1,
                                     hour=5)])
        res = algo.predict(model, ecom.Query(user="newbie", num=3))
        assert len(res.itemScores) == 3
        assert {s.item for s in res.itemScores} <= {"i0", "i2", "i4"}

    def test_predict_batch_matches_sequential(self, port_store, app):
        algo, model, _td = self._train(port_store)
        _write(port_store, app, [
            _ev("view", "newbie", "i0", minute=1, hour=5),
            _unavailable(["i3"])])
        Q = ecom.Query
        queries = [Q(user="u1", num=3), Q(user="u2", num=4,
                                          categories=("even",)),
                   Q(user="newbie", num=3), Q(user="ghost", num=3),
                   Q(user="u0", num=6, blackList=("i5",))]
        seq = [algo.predict(model, q) for q in queries]
        bat = algo.predict_batch(model, queries)
        _assert_batch_matches_sequential(seq, bat)
        assert bat[3].itemScores == ()
        assert all("i3" not in {s.item for s in r.itemScores} for r in bat)
        assert algo.predict(model, Q(user="ghost", num=2)).itemScores == ()

    def test_full_train_deploy_roundtrip(self, port_store, app):
        engine = ecom.ECommerceEngine()
        params = {"appName": "EcomApp", "rank": 4, "numIterations": 5,
                  "seed": 3}
        ep = EngineParams(
            data_source_params=ecom.DataSourceParams(appName="EcomApp"),
            algorithm_params_list=(("ecomm", ecom.ECommAlgorithmParams(
                **params)),))
        iid = run_train(
            WorkflowContext(storage=port_store, device="cpu"), engine, ep,
            engine_factory="x",
            params_json={"datasource": {"params": {"appName": "EcomApp"}},
                         "algorithms": [{"name": "ecomm",
                                         "params": params}]})
        assert port_store.get_model_data_models().get(iid) is not None
        api = QueryAPI(ServerConfig(device="cpu"), storage=port_store,
                       engine=engine)
        status, body = api.handle("POST", "/queries.json", body=json.dumps(
            {"user": "u1", "num": 3, "categories": ["odd"]}).encode())
        assert status == 200, body
        assert {s["item"] for s in body["itemScores"]} <= {"i1", "i3", "i5"}
        assert "degraded" not in body
        _write(port_store, app, [_ev("view", "fresh", "i0", minute=2,
                                     hour=6)])
        status, body = api.handle("POST", "/queries.json", body=json.dumps(
            {"user": "fresh", "num": 2}).encode())
        assert status == 200 and len(body["itemScores"]) == 2
        assert api.handle("GET", "/")[1]["degradedCount"] == 0


@pytest.mark.parametrize("template", ["similarproduct", "ecommerce",
                                      "classification"])
def test_a_train_that_asks_for_the_card_without_one_raises(
        monkeypatch, port_store, template):
    """No CPU fallback: with no device asked for, the policy resolves to
    the card, and without one the train raises before it reads."""
    import torch
    monkeypatch.delenv("PIO_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if template == "classification":
        _write(port_store, _app(port_store, "ClsApp"), _cls_events())
        algo = cls.NaiveBayesAlgorithm()
        td = cls.DataSource(cls.DataSourceParams(appName="ClsApp")) \
            .read_training(WorkflowContext(storage=port_store,
                                           device="cpu"))
    else:
        pkg = sim if template == "similarproduct" else ecom
        _write(port_store, _app(port_store, "App"),
               _sim_events() if pkg is sim else _ecom_events())
        algo = (sim.ALSAlgorithm(sim.ALSAlgorithmParams(seed=3))
                if pkg is sim else ecom.ECommAlgorithm(
                    ecom.ECommAlgorithmParams(appName="App", seed=3)))
        td = pkg.DataSource(pkg.DataSourceParams(appName="App")) \
            .read_training(WorkflowContext(storage=port_store,
                                           device="cpu"))

    class NoDevice:              # a context that names no device
        storage = port_store

        @staticmethod
        def phase(name):
            import contextlib
            return contextlib.nullcontext()

    with pytest.raises(RuntimeError, match="cuda"):
        algo.train(NoDevice(), td)


def test_stock_components_match_the_reference():
    from predictionio_tpu.controller import (
        AverageServing as JAverageServing, FirstServing as JFirstServing,
        IdentityPreparator as JIdentityPreparator,
    )
    from predictionio_tpu_torch.controller import (
        AverageServing, FirstServing, IdentityPreparator,
    )
    td = object()
    assert IdentityPreparator().prepare(None, td) is td
    assert JIdentityPreparator().prepare(None, td) is td
    preds = [3.0, 0.5, 2.25]
    assert AverageServing().serve(None, preds) == \
        JAverageServing().serve(None, preds) == 1.9166666666666667
    assert FirstServing().serve(None, preds) == \
        JFirstServing().serve(None, preds) == 3.0


def test_malformed_weights_group_does_not_break_serving(monkeypatch):
    """A garbage weightedItems constraint degrades to unweighted serving,
    not a per-query error."""
    import unittest.mock as mock

    class FakeVocab:
        def get(self, k):
            return None

        def __len__(self):
            return 3

    class M:
        item_vocab = FakeVocab()

    algo = ecom.ECommAlgorithm(ecom.ECommAlgorithmParams(appName="nope"))
    ev = mock.Mock()
    ev.properties.get_opt.return_value = [
        {"items": 42, "weight": 2.0},          # non-iterable
        {"items": "i1", "weight": 2.0},        # string (char iteration)
        "not a dict",                          # wrong type entirely
        {"items": ["i1"], "weight": "heavy"},  # non-numeric weight
    ]
    monkeypatch.setattr(store, "find_by_entity", lambda *a, **k: [ev])
    assert algo._item_weights(M()) is None


def _deploy(storage, tmp_factory="x", **algo_params):
    """A trained e-commerce instance in ``storage``, deployed on the CPU."""
    engine = ecom.ECommerceEngine()
    params = {"appName": "EcomApp", "rank": 4, "numIterations": 3,
              "seed": 3, **algo_params}
    ep = EngineParams(
        data_source_params=ecom.DataSourceParams(appName="EcomApp"),
        algorithm_params_list=(("ecomm", ecom.ECommAlgorithmParams(
            **params)),))
    run_train(WorkflowContext(storage=storage, device="cpu"), engine, ep,
              engine_factory=tmp_factory,
              params_json={"datasource": {"params": {"appName": "EcomApp"}},
                           "algorithms": [{"name": "ecomm",
                                           "params": params}]})
    return engine


@pytest.mark.parametrize("batching", ["off", "on"])
def test_failed_lookup_answers_degraded(port_store, monkeypatch, batching):
    _write(port_store, _app(port_store, "EcomApp"), _ecom_events())
    engine = _deploy(port_store, unseenOnly=True)
    api = QueryAPI(ServerConfig(device="cpu", batching=batching),
                   storage=port_store, engine=engine)
    body = json.dumps({"user": "u1", "num": 3}).encode()
    status, clean = api.handle("POST", "/queries.json", body=body)
    assert status == 200 and "degraded" not in clean
    before = resilience.degraded_total()

    def down(*a, **k):
        raise RuntimeError("event store unreachable")

    monkeypatch.setattr(store, "find_target_ids", down)
    status, got = api.handle("POST", "/queries.json", body=body)
    assert status == 200 and got["degraded"] is True
    # served without the seen filter: u1 rated all six items
    assert len(got["itemScores"]) == 3
    assert api.handle("GET", "/")[1]["degradedCount"] == 1
    assert resilience.degraded_total() == before + 1
    monkeypatch.undo()
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    status, again = api.handle("POST", "/queries.json", body=body)
    assert status == 200 and again == clean
    api.close()


def test_deploy_reads_rules_from_its_own_store(monkeypatch):
    """bind_serving: the deployed engine reads its live rules from the
    store it was deployed from, not from the process-global one."""
    mine = Storage(env=MEM)
    app_id = _app(mine, "EcomApp")
    _write(mine, app_id, _ecom_events())
    engine = _deploy(mine)
    monkeypatch.setattr(storage_mod, "_storage", Storage(env=MEM))
    api = QueryAPI(ServerConfig(device="cpu", batching="off"),
                   storage=mine, engine=engine)
    _write(mine, app_id, [_unavailable(["i1", "i3"])])
    status, body = api.handle("POST", "/queries.json", body=json.dumps(
        {"user": "u1", "num": 6}).encode())
    assert status == 200 and "degraded" not in body, body
    assert {s["item"] for s in body["itemScores"]} & {"i1", "i3"} == set()
    assert "i5" in {s["item"] for s in body["itemScores"]}


# ---------------------------------------------------------------------------
# 2. serving on shared factors: bit-equal in both packages
# ---------------------------------------------------------------------------

N_USERS, N_ITEMS, RANK = 40, 90, 6


def _shared(seed=11):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    V[7] = V[3]                               # an exact score tie
    V_hat = V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-12)
    cats = {i: (f"c{i % 3}",) if i % 5 else None for i in range(N_ITEMS)}
    user_trained = rng.random(N_USERS) < 0.9
    item_trained = rng.random(N_ITEMS) < 0.95
    return U, V, V_hat, cats, user_trained, item_trained


def _sim_model(pkg_model, bimap, item_cls, build, shared):
    _U, _V, V_hat, cats, _ut, item_trained = shared
    vocab = bimap({f"i{i}": i for i in range(N_ITEMS)})
    items = {i: item_cls(categories=c) for i, c in cats.items()}
    return pkg_model(product_features=V_hat.copy(), item_vocab=vocab,
                     items=items, trained_mask=item_trained.copy(),
                     category_masks=build(items, N_ITEMS))


def _ecom_model(pkg_model, bimap, item_cls, build, shared):
    U, V, V_hat, cats, user_trained, item_trained = shared
    items = {i: item_cls(categories=c) for i, c in cats.items()}
    return pkg_model(
        rank=RANK, user_features=U.copy(), product_features=V.copy(),
        user_vocab=bimap({f"u{u}": u for u in range(N_USERS)}),
        item_vocab=bimap({f"i{i}": i for i in range(N_ITEMS)}),
        items=items, user_trained=user_trained.copy(),
        item_trained=item_trained.copy(),
        category_masks=build(items, N_ITEMS),
        product_features_hat=V_hat.copy())


def _same(a, b):
    """Same items and bit-equal scores."""
    assert [(s.item, s.score) for s in a.itemScores] == \
        [(s.item, s.score) for s in b.itemScores]


def _sim_queries(q_cls, rng):
    qs = [q_cls(items=("i3",), num=5), q_cls(items=("i1", "i2"), num=12),
          q_cls(items=("nope",), num=3),
          q_cls(items=("i4",), num=N_ITEMS + 5),
          q_cls(items=("i0",), num=0), q_cls(items=("i0",), num=-2)]
    for _ in range(12):
        items = tuple(f"i{i}" for i in rng.integers(0, N_ITEMS, 3))
        kw = {}
        if rng.random() < 0.5:
            kw["categories"] = (f"c{rng.integers(4)}",)
        if rng.random() < 0.3:
            kw["whiteList"] = tuple(f"i{i}" for i in
                                    rng.integers(0, N_ITEMS, 20))
        if rng.random() < 0.5:
            kw["blackList"] = tuple(f"i{i}" for i in
                                    rng.integers(0, N_ITEMS, 10))
        qs.append(q_cls(items=items, num=int(rng.integers(1, 15)), **kw))
    return qs


@pytest.mark.parametrize("algo_name", ["als", "likealgo"])
def test_similar_product_serving_is_exact_across_packages(algo_name):
    shared = _shared()
    model = _sim_model(SimModel, BiMap, sim.Item, build_category_masks,
                       shared)
    jmodel = _sim_model(JSimModel, JBiMap, jsim.Item,
                        jbuild_category_masks, shared)
    algo = sim.SimilarProductEngine().algorithm_class_map[algo_name](
        sim.ALSAlgorithmParams())
    jalgo = jsim.SimilarProductEngine().algorithm_class_map[algo_name](
        jsim.ALSAlgorithmParams())
    rng = np.random.default_rng(5)
    qs = _sim_queries(sim.Query, rng)
    jqs = _sim_queries(jsim.Query, np.random.default_rng(5))
    for q, jq in zip(qs, jqs):
        _same(algo.predict(model, q), jalgo.predict(jmodel, jq))
    for a, b in zip(algo.predict_batch(model, qs),
                    jalgo.predict_batch(jmodel, jqs)):
        _same(a, b)
    assert any(r.itemScores for r in algo.predict_batch(model, qs))


def _shop_events(rng):
    """Seen events, recent views of unknown users and both constraints."""
    out = []
    for k in range(120):
        name = ["view", "buy", "view"][k % 3]
        out.append(_ev(name, f"u{rng.integers(N_USERS)}",
                       f"i{rng.integers(N_ITEMS)}", minute=k % 60,
                       hour=1 + k // 60))
    for k, user in enumerate(("new1", "new2")):
        for j in range(14):
            out.append(_ev("view", user, f"i{rng.integers(N_ITEMS)}",
                           minute=j, hour=4 + k))
    out.append(_unavailable([f"i{i}" for i in rng.integers(0, N_ITEMS, 8)]))
    out.append(_weights([
        {"items": [f"i{i}" for i in range(0, N_ITEMS, 4)], "weight": 0.5},
        {"items": ["i11", "i12"], "weight": 30.0},
        {"items": ["i13"], "weight": 0.0},
        {"items": 5, "weight": 1.0}]))
    return out


def _ecom_queries(q_cls, rng):
    qs = [q_cls(user="u0", num=5), q_cls(user="new1", num=6),
          q_cls(user="new2", num=4, categories=("c1",)),
          q_cls(user="ghost", num=3), q_cls(user="u1", num=N_ITEMS + 1),
          q_cls(user="u2", num=0)]
    for _ in range(14):
        kw = {}
        if rng.random() < 0.4:
            kw["categories"] = (f"c{rng.integers(4)}",)
        if rng.random() < 0.3:
            kw["whiteList"] = tuple(f"i{i}" for i in
                                    rng.integers(0, N_ITEMS, 25))
        if rng.random() < 0.4:
            kw["blackList"] = tuple(f"i{i}" for i in
                                    rng.integers(0, N_ITEMS, 6))
        qs.append(q_cls(user=f"u{rng.integers(N_USERS)}",
                        num=int(rng.integers(1, 12)), **kw))
    return qs


@pytest.mark.parametrize("rules", [
    {}, {"unseenOnly": True}, {"weightedItems": True},
    {"unseenOnly": True, "weightedItems": True,
     "seenEvents": ("buy",)},
])
def test_ecommerce_serving_is_exact_across_packages(rules):
    shared = _shared(seed=12)
    specs = _shop_events(np.random.default_rng(3))
    st, jst = Storage(env=MEM), JStorage(env=MEM)
    _write(st, _app(st, "EcomApp"), specs)
    _jwrite(jst, _app(jst, "EcomApp", JApp), specs)
    model = _ecom_model(ECommModel, BiMap, ecom.Item, build_category_masks,
                        shared)
    jmodel = _ecom_model(JECommModel, JBiMap, jecom.Item,
                         jbuild_category_masks, shared)
    algo = ecom.ECommAlgorithm(ecom.ECommAlgorithmParams(
        appName="EcomApp", **rules))
    jalgo = jecom.ECommAlgorithm(jecom.ECommAlgorithmParams(
        appName="EcomApp", **rules))
    algo.bind_serving(WorkflowContext(storage=st, device="cpu"))
    jalgo.bind_serving(JWorkflowContext(storage=jst))
    qs = _ecom_queries(ecom.Query, np.random.default_rng(9))
    jqs = _ecom_queries(jecom.Query, np.random.default_rng(9))
    for q, jq in zip(qs, jqs):
        _same(algo.predict(model, q), jalgo.predict(jmodel, jq))
    for a, b in zip(algo.predict_batch(model, qs),
                    jalgo.predict_batch(jmodel, jqs)):
        _same(a, b)
    assert algo.predict(model, qs[1]).itemScores    # the recent-views path


# ---------------------------------------------------------------------------
# 3. training: exact rating arrays, trains within tolerance
# ---------------------------------------------------------------------------

CHUNK = 64


def _capture(monkeypatch, module, u0v0, seen, implicit):
    """Record the COO arrays a template hands ``prepare_ratings`` and run
    its train with a small chunk and the injected factors."""
    prep, train_fn = module.prepare_ratings, (
        module.train_implicit if implicit else module.train_explicit)

    def prepare(u, i, r, **kw):
        seen["coo"] = (np.asarray(u), np.asarray(i), np.asarray(r))
        seen["n"] = (kw["n_users"], kw["n_items"])
        return prep(u, i, r, **{**kw, "chunk": CHUNK})

    def train(data, **kw):
        u0, v0 = u0v0(*seen["n"], kw["rank"])
        out = train_fn(data, **{**kw, "chunk": CHUNK, "u0": u0, "v0": v0})
        seen["factors"] = [np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                           for x in out]
        return out

    monkeypatch.setattr(module, "prepare_ratings", prepare)
    monkeypatch.setattr(module, "train_implicit" if implicit
                        else "train_explicit", train)


def _u0v0(n_users, n_items, rank):
    rng = np.random.default_rng(31)
    return (np.abs(rng.normal(size=(n_users, rank))).astype(np.float32)
            / np.sqrt(rank),
            np.abs(rng.normal(size=(n_items, rank))).astype(np.float32)
            / np.sqrt(rank))


def _random_events(kind, seed=4, n=500):
    rng = np.random.default_rng(seed)
    out = [_set("user", f"u{u}", {}, minute=u) for u in range(25)]
    out += [_set("item", f"i{i}", {"categories": [f"c{i % 4}"]},
                 minute=i) for i in range(30)]
    for k in range(n):
        u, i = f"u{rng.integers(27)}", f"i{rng.integers(32)}"  # strays
        t = dict(minute=int(rng.integers(60)), hour=int(rng.integers(1, 20)))
        if kind == "rate":
            out.append(_ev("rate", u, i,
                           {"rating": float(rng.integers(1, 11)) / 2}, **t))
        else:
            out.append(_ev(str(rng.choice(["view", "like", "dislike"])), u,
                           i, **t))
    return out


@pytest.mark.parametrize("template,algo_name", [
    ("similarproduct", "als"), ("similarproduct", "likealgo"),
    ("ecommerce", "ecomm"),
])
def test_training_matches_the_reference(monkeypatch, template, algo_name):
    implicit = template == "similarproduct"
    specs = _random_events("view" if implicit else "rate")
    st, jst = Storage(env=MEM), JStorage(env=MEM)
    _write(st, _app(st, "TrainApp"), specs)
    _jwrite(jst, _app(jst, "TrainApp", JApp), specs)
    mine, ref = {}, {}
    _capture(monkeypatch, als, _u0v0, mine, implicit)
    _capture(monkeypatch, jals, _u0v0, ref, implicit)
    if implicit:
        pkgs = ((sim, {}, WorkflowContext(storage=st, device="cpu")),
                (jsim, {}, JWorkflowContext(storage=jst)))
    else:
        pkgs = ((ecom, {"appName": "TrainApp"},
                 WorkflowContext(storage=st, device="cpu")),
                (jecom, {"appName": "TrainApp"},
                 JWorkflowContext(storage=jst)))
    models = []
    for pkg, extra, ctx in pkgs:
        engine = (pkg.SimilarProductEngine() if implicit
                  else pkg.ECommerceEngine())
        aparams = (pkg.ALSAlgorithmParams if implicit
                   else pkg.ECommAlgorithmParams)(
            rank=3, numIterations=6, lambda_=0.05, seed=7, **extra)
        ep_cls = EngineParams if pkg in (sim, ecom) else JEngineParams
        ep = ep_cls(data_source_params=pkg.DataSourceParams(
            appName="TrainApp"), algorithm_params_list=((algo_name,
                                                         aparams),))
        ds, _p, algos, _s = engine._instantiate(ep)
        models.append(algos[0].train(ctx, ds.read_training(ctx)))
    for a, b in zip(mine["coo"], ref["coo"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert mine["n"] == ref["n"]
    for a, b in zip(mine["factors"], ref["factors"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
    model, jmodel = models
    assert model.item_vocab.to_dict() == jmodel.item_vocab.to_dict()
    if implicit:
        assert model.trained_mask.tobytes() == jmodel.trained_mask.tobytes()
        np.testing.assert_allclose(model.product_features,
                                   jmodel.product_features, rtol=2e-3,
                                   atol=2e-4)
    else:
        assert model.user_trained.tobytes() == jmodel.user_trained.tobytes()
        for f in ("user_features", "product_features",
                  "product_features_hat"):
            np.testing.assert_allclose(getattr(model, f),
                                       getattr(jmodel, f), rtol=2e-3,
                                       atol=2e-4)
    assert {k: dataclasses.asdict(v) for k, v in model.items.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmodel.items.items()}
