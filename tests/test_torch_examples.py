"""The example engines of the port against the JAX package's, on the CPU.

Every case of the JAX package's ``tests/test_examples.py`` runs here under
its own name, through both packages on the same inputs (files written
from a numpy seed, or the same events in each package's memory store),
and the two answers are compared:

- **exact** for what the host computes alike: parsed data, vocabularies,
  masks, counts, the maintenance reports, the serving filters, the
  indicators and the backtest's NAV walk, the keyword dot, the random
  baseline, the helloworld means (a sum of at most a few fp32 values per
  day, in the same order), and top-k indices and scores of a model
  carried across from the JAX package's blob (host numpy in both);
- **tolerance** where fp32 summation order differs: trained ALS factors
  with the same ``u0`` / ``v0`` injected into both packages'
  ``_seed_factors`` (rtol 2e-3 / atol 2e-4, the tolerance of
  ``tests/test_torch_als.py``), SimRank (atol 1e-6), DIMSUM's Gram
  (atol 1e-6; 0/1 rows, so the sums are integers and in practice exact),
  the SGD weights (rtol 1e-4 / atol 1e-5) and the batched least squares
  (rtol 1e-3 / atol 1e-5; two SVD implementations in fp32).

The port runs with ``PIO_TORCH_DEVICE=cpu`` and ``device="cpu"``; the JAX
package on the CPU.
"""

import dataclasses
import datetime as dt
import importlib
import pickle

import numpy as np
import pytest
import torch

UTC = dt.timezone.utc
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
ALS_RTOL, ALS_ATOL = 2e-3, 2e-4


class Pkg:
    """One package's modules, under the same names for both."""

    def __init__(self, root: str):
        self.root = root
        self.port = root == "predictionio_tpu_torch"
        m = self.mod
        self.controller = m("controller")
        self.store = m("data.store")
        self.DataMap = m("data.datamap").DataMap
        self.Event = m("data.event").Event
        self.storage_mod = m("data.storage")
        self.core = m("workflow.core_workflow")
        self.model_io = m("workflow.model_io")
        self.als = m("ops.als")
        self.EngineParams = self.controller.EngineParams

    def mod(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def ex(self, name: str):
        return self.mod(f"examples.{name}")

    def ctx(self, storage=None):
        wc = self.mod("workflow.context").WorkflowContext
        return (wc(storage=storage, device="cpu") if self.port
                else wc(storage=storage))

    def fresh(self):
        return self.storage_mod.Storage(env=MEM)

    def app(self, st, name: str) -> int:
        app_id = st.get_meta_data_apps().insert(
            self.storage_mod.App(0, name, None))
        st.get_events().init(app_id)
        return app_id

    def write(self, st, app_id: int, specs) -> None:
        self.store.write([self.Event(**{**d, "properties": self.DataMap(
            d.get("properties") or {})}) for d in specs], app_id, storage=st)


PORT, JAX = Pkg("predictionio_tpu_torch"), Pkg("predictionio_tpu")
BOTH = (PORT, JAX)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")


def _fixed_seed_factors(seed, n_users, n_items, rank, **_kw):
    rng = np.random.default_rng(31)
    return (np.abs(rng.normal(size=(n_users, rank))).astype(np.float32)
            / np.float32(np.sqrt(rank)),
            np.abs(rng.normal(size=(n_items, rank))).astype(np.float32)
            / np.float32(np.sqrt(rank)))


@pytest.fixture()
def same_init(monkeypatch):
    """The same u0 / v0 in both packages' ALS trainers (seeds are not
    replayed across the packages)."""
    for pkg in BOTH:
        monkeypatch.setattr(pkg.als, "_seed_factors", _fixed_seed_factors)


def _t(minutes=0, day=1, hour=0):
    return dt.datetime(2021, 1, day, hour, tzinfo=UTC) + dt.timedelta(
        minutes=minutes)


def _ev(name, etype, eid, props=None, target=None, ttype="item", t=None):
    return dict(event=name, entity_type=etype, entity_id=eid,
                target_entity_type=ttype if target is not None else None,
                target_entity_id=target, properties=props or {},
                event_time=t or _t())


def _stores(name: str, specs):
    """Both packages' memory stores, each with app ``name`` holding the
    same events: [(pkg, storage, app_id)]."""
    out = []
    for pkg in BOTH:
        st = pkg.fresh()
        app_id = pkg.app(st, name)
        pkg.write(st, app_id, specs)
        out.append((pkg, st, app_id))
    return out


def _carry(model):
    """A JAX-package model through its own blob into the port."""
    blob = JAX.model_io.serialize_models([model])
    (out,) = PORT.model_io.deserialize_models(blob)
    return out


def _as_dict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def _train(pkg, engine, ep, storage=None):
    return engine.train(pkg.ctx(storage), ep)


# ---------------------------------------------------------------------------
# helloworld
# ---------------------------------------------------------------------------

class TestHelloWorld:
    def test_train_and_predict(self, tmp_path):
        rng = np.random.default_rng(2)
        days = [f"d{k}" for k in range(7)]
        lines = [f"{days[int(rng.integers(7))]},{rng.normal(70, 8):.2f}"
                 for _ in range(60)] + ["Mon,75.5", "Tue,80.5", "Wed,69.5",
                                        "Mon,76.5"]
        csv = tmp_path / "data.csv"
        csv.write_text("\n".join(lines) + "\n")
        means = []
        for pkg in BOTH:
            hw = pkg.ex("helloworld")
            ep = pkg.EngineParams(
                data_source_params=hw.HelloWorldDataSourceParams(str(csv)),
                algorithm_params_list=(("", None),))
            (model,) = _train(pkg, hw.engine(), ep)
            algo = hw.HelloWorldAlgorithm()
            assert algo.predict(model, hw.HelloQuery("Mon")).temperature \
                == pytest.approx(76.0)
            means.append(model)
        assert means[0] == means[1]      # exact, day for day


# ---------------------------------------------------------------------------
# regression
# ---------------------------------------------------------------------------

def _lr_data(path, n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 3))
    y = x @ np.array([2.0, -1.0, 0.5]) + 0.25 + rng.normal(0, 0.01, n)
    np.savetxt(path, np.column_stack([y, x]), fmt="%.6f")


class TestRegression:
    def test_sgd_recovers_weights(self, tmp_path):
        f = tmp_path / "lr_data.txt"
        _lr_data(f)
        ws = []
        for pkg in BOTH:
            rg = pkg.ex("regression")
            ep = pkg.EngineParams(
                data_source_params=rg.RegressionDataSourceParams(str(f)),
                algorithm_params_list=(
                    ("SGD", rg.SGDAlgorithmParams(numIterations=400,
                                                  stepSize=0.5)),))
            (w,) = _train(pkg, rg.engine(), ep)
            np.testing.assert_allclose(w, [2.0, -1.0, 0.5, 0.25], atol=0.05)
            pred = rg.SGDRegressionAlgorithm(rg.SGDAlgorithmParams()).predict(
                w, np.array([1.0, 1.0, 1.0]))
            assert pred == pytest.approx(1.75, abs=0.1)
            ws.append(w)
        assert ws[0].dtype == ws[1].dtype == np.float32
        np.testing.assert_allclose(ws[0], ws[1], rtol=1e-4, atol=1e-5)

    def test_kfold_eval_grid(self, tmp_path):
        f = tmp_path / "lr_data.txt"
        _lr_data(f, n=120)
        results = []
        for pkg in BOTH:
            rg = pkg.ex("regression")

            class RegEval(pkg.controller.Evaluation):
                engine = rg.engine()
                metric = rg.MeanSquareError()

            grid = [pkg.EngineParams(
                data_source_params=rg.RegressionDataSourceParams(str(f),
                                                                 k=3),
                algorithm_params_list=(
                    ("SGD", rg.SGDAlgorithmParams(numIterations=300,
                                                  stepSize=s)),))
                for s in (0.05, 0.2, 0.5)]
            res = pkg.core.run_evaluation(pkg.ctx(pkg.fresh()), RegEval(),
                                          grid, evaluation_class="RegEval")
            scores = [s.score for s in res.engine_params_scores]
            assert len(scores) == 3
            assert res.best_score.score == min(scores) < 0.05
            results.append(scores)
        np.testing.assert_allclose(results[0], results[1], rtol=1e-4,
                                   atol=1e-7)

    def test_kfold_splits_are_the_reference(self, tmp_path):
        f = tmp_path / "lr_data.txt"
        _lr_data(f, n=50)
        sets = [pkg.ex("regression").RegressionDataSource(
            pkg.ex("regression").RegressionDataSourceParams(str(f), k=4)
        ).read_eval(None) for pkg in BOTH]
        for (td, _e, qa), (jtd, _je, jqa) in zip(*sets):
            assert td.x.tobytes() == jtd.x.tobytes()
            assert td.y.tobytes() == jtd.y.tobytes()
            assert [(q.tobytes(), a) for q, a in qa] == \
                [(q.tobytes(), a) for q, a in jqa]


# ---------------------------------------------------------------------------
# refactor_test
# ---------------------------------------------------------------------------

class TestRefactorTest:
    def test_train(self):
        for pkg in BOTH:
            rt = pkg.ex("refactor_test")
            ep = pkg.EngineParams(algorithm_params_list=(
                ("algo", rt.VanillaAlgorithmParams(mult=2)),))
            assert _train(pkg, rt.engine(), ep) == [sum(range(100)) * 2]

    def test_eval_three_sets(self):
        for pkg in BOTH:
            rt = pkg.ex("refactor_test")

            class VanillaEval(pkg.controller.Evaluation):
                engine = rt.engine()
                metric = rt.VanillaMetric()

            ep = pkg.EngineParams(algorithm_params_list=(
                ("algo", rt.VanillaAlgorithmParams(mult=1)),))
            res = pkg.core.run_evaluation(pkg.ctx(pkg.fresh()),
                                          VanillaEval(), [ep])
            assert res.best_score.score == pytest.approx(4959.5)


# ---------------------------------------------------------------------------
# friend recommendation
# ---------------------------------------------------------------------------

@pytest.fixture()
def friend_files(tmp_path):
    (tmp_path / "item.txt").write_text("10 1 1;2\n20 2 2;3\n")
    (tmp_path / "user.txt").write_text(
        "100 1:0.5;2:1.0\n200 3:2.0\n300 2:1.0\n")
    (tmp_path / "action.txt").write_text(
        "100 200 1 0 0\n200 300 0 1 0\n100 300 1 1 0\n")
    return tmp_path


def _friend_params(fr, d, stem=""):
    return fr.FriendRecommendationDataSourceParams(
        itemFilePath=str(d / f"{stem}item.txt"),
        userKeywordFilePath=str(d / f"{stem}user.txt"),
        userActionFilePath=str(d / f"{stem}action.txt"))


def _random_graph(d, n_users=60, n_items=12, n_edges=400, seed=5):
    rng = np.random.default_rng(seed)
    (d / "g_item.txt").write_text("".join(
        f"{1000 + i} 1 {';'.join(map(str, rng.choice(20, 3, False)))}\n"
        for i in range(n_items)))
    (d / "g_user.txt").write_text("".join(
        f"{u} " + ";".join(f"{k}:{rng.integers(1, 5) / 2}" for k in
                           rng.choice(20, 4, False)) + "\n"
        for u in range(n_users)))
    (d / "g_action.txt").write_text("".join(
        f"{rng.integers(n_users)} {rng.integers(n_users)} 1 0 0\n"
        for _ in range(n_edges)))


class TestFriendRecommendation:
    def test_keyword_similarity(self, friend_files):
        _random_graph(friend_files)
        for stem in ("", "g_"):
            got = []
            for pkg in BOTH:
                fr = pkg.ex("friend_recommendation")
                ep = pkg.EngineParams(
                    data_source_params=_friend_params(fr, friend_files,
                                                      stem),
                    algorithm_params_list=(("", None),))
                (model,) = _train(pkg, fr.keyword_engine(), ep)
                algo = fr.KeywordSimilarityAlgorithm()
                q = fr.FriendRecommendationQuery
                if not stem:
                    p = algo.predict(model, q(100, 10))
                    assert p.confidence == pytest.approx(1.5) and p.acceptance
                    p = algo.predict(model, q(200, 10))
                    assert p.confidence == 0.0 and not p.acceptance
                    assert algo.predict(model, q(999, 10)).confidence == 0.0
                users = sorted(model.user_id_map)[:20] + [999]
                items = sorted(model.item_id_map) + [7]
                got.append([_as_dict(algo.predict(model, q(u, i)))
                            for u in users for i in items])
                got.append((model.user_rows.tobytes(),
                            model.item_rows.tobytes()))
            assert got[0] == got[2] and got[1] == got[3]

    def test_simrank_against_dense_reference(self, friend_files):
        scores = []
        for pkg in BOTH:
            fr = pkg.ex("friend_recommendation")
            ep = pkg.EngineParams(
                data_source_params=_friend_params(fr, friend_files),
                algorithm_params_list=(
                    ("", fr.SimRankAlgorithmParams(numIterations=4,
                                                   decay=0.8)),))
            (model,) = _train(pkg, fr.simrank_engine(), ep)
            scores.append(model.scores)
            p = fr.SimRankAlgorithm().predict(
                model, fr.FriendRecommendationQuery(200, 300))
            assert p.confidence > 0 and p.acceptance
        # the textbook per-pair recurrence, in numpy
        a = np.zeros((3, 3))
        for s, d in [(0, 1), (1, 2), (0, 2)]:
            a[s, d] = 1.0
        s_ref = np.eye(3)
        for _ in range(4):
            new = np.eye(3)
            for x in range(3):
                for y in range(3):
                    in_x, in_y = np.where(a[:, x])[0], np.where(a[:, y])[0]
                    if x == y or not len(in_x) or not len(in_y):
                        continue
                    tot = sum(s_ref[i, j] for i in in_x for j in in_y)
                    new[x, y] = 0.8 * tot / (len(in_x) * len(in_y))
            s_ref = new
        np.testing.assert_allclose(scores[0], s_ref, atol=1e-5)
        assert scores[0].dtype == scores[1].dtype == np.float32
        np.testing.assert_allclose(scores[0], scores[1], atol=1e-6)

    def test_simrank_matches_the_reference_on_a_random_graph(
            self, friend_files):
        _random_graph(friend_files)
        scores = []
        for pkg in BOTH:
            fr = pkg.ex("friend_recommendation")
            ep = pkg.EngineParams(
                data_source_params=_friend_params(fr, friend_files, "g_"),
                algorithm_params_list=(
                    ("", fr.SimRankAlgorithmParams(numIterations=6,
                                                   decay=0.7)),))
            (model,) = _train(pkg, fr.simrank_engine(), ep)
            scores.append(model.scores)
        np.testing.assert_allclose(scores[0], scores[1], atol=1e-6)
        assert np.all(np.diag(scores[0]) == 1.0)

    def test_random_is_deterministic(self, friend_files):
        got = []
        for pkg in BOTH:
            fr = pkg.ex("friend_recommendation")
            ep = pkg.EngineParams(
                data_source_params=_friend_params(fr, friend_files),
                algorithm_params_list=(("", None),))
            (model,) = _train(pkg, fr.random_engine(), ep)
            algo = fr.RandomAlgorithm()
            q = fr.FriendRecommendationQuery(100, 10)
            assert algo.predict(model, q).confidence == \
                algo.predict(model, q).confidence
            got.append([_as_dict(algo.predict(
                model, fr.FriendRecommendationQuery(u, i)))
                for u in (100, 200, 300, 5) for i in (10, 20, 3)])
        assert got[0] == got[1]      # the same generator, the same draws


# ---------------------------------------------------------------------------
# DIMSUM
# ---------------------------------------------------------------------------

def _dimsum_specs():
    evs = [_ev("$set", "user", u) for u in ("u1", "u2", "u3")]
    evs += [_ev("$set", "item", i, {"categories": list(c)})
            for i, c in (("i1", "a"), ("i2", "ab"), ("i3", "b"))]
    views = [("u1", "i1"), ("u1", "i2"), ("u2", "i1"), ("u2", "i2"),
             ("u3", "i3"), ("u1", "i1")]
    evs += [_ev("view", "user", u, target=i, t=_t(n))
            for n, (u, i) in enumerate(views)]
    return evs


def _shop_specs(seed=3, n_users=40, n_items=30, n_views=400, rate=False):
    rng = np.random.default_rng(seed)
    evs = [_ev("$set", "user", f"u{u}") for u in range(n_users)]
    evs += [_ev("$set", "item", f"i{i}", {"categories": [f"c{i % 4}"]})
            for i in range(n_items)]
    for k in range(n_views):
        u, i = int(rng.integers(n_users + 2)), int(rng.integers(n_items + 2))
        if rate:
            evs.append(_ev("rate", "user", f"u{u}", {
                "rating": float(rng.integers(1, 11)) / 2}, f"i{i}",
                t=_t(k)))
        else:
            evs.append(_ev("view", "user", f"u{u}", target=f"i{i}",
                           t=_t(k)))
    return evs


def _dimsum_train(specs, threshold=0.0):
    out = []
    for pkg, st, _app in _stores("dimsumapp", specs):
        dm = pkg.ex("dimsum")
        dsp = pkg.mod("models.similarproduct.data_source").DataSourceParams
        ep = pkg.EngineParams(
            data_source_params=dsp(appName="dimsumapp"),
            algorithm_params_list=(
                ("dimsum", dm.DIMSUMAlgorithmParams(threshold=threshold)),))
        out.append((pkg, dm, _train(pkg, dm.engine(), ep, st)[0]))
    return out


class TestDIMSUM:
    def test_cosine_matches_numpy(self):
        (_p, _dm, model), (_jp, _jdm, jmodel) = _dimsum_train(_dimsum_specs())
        v1, v2, v3 = (model.item_vocab(i) for i in ("i1", "i2", "i3"))
        assert model.similarities[v1, v2] == pytest.approx(1.0, abs=1e-6)
        assert model.similarities[v1, v3] == 0.0
        assert model.similarities[v1, v1] == 0.0
        assert model.item_vocab.to_dict() == jmodel.item_vocab.to_dict()
        np.testing.assert_allclose(model.similarities, jmodel.similarities,
                                   atol=1e-6)

    def test_gram_matches_the_reference_on_random_views(self):
        (_p, _dm, model), (_jp, _jdm, jmodel) = _dimsum_train(
            _shop_specs(), threshold=0.2)
        assert model.similarities.dtype == np.float32
        np.testing.assert_allclose(model.similarities, jmodel.similarities,
                                   atol=1e-6)
        for name in model.category_masks:
            assert model.category_masks[name].tobytes() == \
                jmodel.category_masks[name].tobytes()

    def test_serving_filters(self):
        runs = _dimsum_train(_dimsum_specs())
        answers = []
        for pkg, dm, model in runs:
            Query = pkg.mod("models.similarproduct.engine").Query
            algo = dm.DIMSUMAlgorithm()
            r = algo.predict(model, Query(items=("i1",), num=5))
            assert [s.item for s in r.itemScores] == ["i2"]
            cases = [dict(categories=("b",)), dict(categories=("z",)),
                     dict(blackList=("i2",)), dict(whiteList=("i3",)), {}]
            answers.append([_as_dict(algo.predict(model, Query(
                items=items, num=5, **kw)))
                for items in (("i1",), ("i1", "i3"), ("nope",))
                for kw in cases])
        assert answers[0] == answers[1]

    def test_threshold_zeroes_small_sims(self):
        for _pkg, _dm, model in _dimsum_train(_dimsum_specs(),
                                              threshold=1.1):
            assert not model.similarities.any()


# ---------------------------------------------------------------------------
# recommendation variants
# ---------------------------------------------------------------------------

def _cat_specs():
    evs = [_ev("$set", "user", u) for u in ("u1", "u2", "u3")]
    evs += [_ev("$set", "item", i, {"categories": c})
            for i, c in (("i1", ["a"]), ("i2", ["b"]), ("i3", ["a", "b"]))]
    views = [("u1", "i1"), ("u1", "i1"), ("u1", "i3"), ("u2", "i1"),
             ("u2", "i3"), ("u2", "i3"), ("u3", "i2")]
    evs += [_ev("view", "user", u, target=i, t=_t(n))
            for n, (u, i) in enumerate(views)]
    return evs


def _cat_train(specs, rank=4, iters=8):
    out = []
    for pkg, st, _app in _stores("catapp", specs):
        rv = pkg.ex("recommendation_variants")
        dsp = pkg.mod("models.similarproduct.data_source").DataSourceParams
        ep = pkg.EngineParams(
            data_source_params=dsp(appName="catapp"),
            algorithm_params_list=(
                ("als", rv.CategoryALSParams(rank=rank, numIterations=iters,
                                             seed=7)),))
        out.append((rv, _train(pkg, rv.cat_engine(), ep, st)[0]))
    return out


def _em_specs():
    evs = [_ev("$set", "user", u, {"attr0": 1.5 + n, "attr1": n,
                                  "attr2": 10 + n})
           for n, u in enumerate(("u1", "u2"))]
    evs += [_ev("$set", "item", i, {"attrA": f"s{n}", "attrB": n,
                                   "attrC": bool(n)})
            for n, i in enumerate(("i1", "i2"))]
    pairs = [("u1", "i1", "rate", 5.0), ("u1", "i2", "buy", None),
             ("u2", "i2", "rate", 3.0)]
    evs += [_ev(e, "user", u, {"rating": r} if r is not None else {}, i,
                t=_t(n)) for n, (u, i, e, r) in enumerate(pairs)]
    return evs


class TestRecommendationVariants:
    def test_category_als(self, same_init):
        (rv, model), (jrv, jmodel) = _cat_train(_cat_specs())
        assert model.user_vocab.to_dict() == jmodel.user_vocab.to_dict()
        assert model.item_vocab.to_dict() == jmodel.item_vocab.to_dict()
        np.testing.assert_allclose(model.user_factors, jmodel.user_factors,
                                   rtol=ALS_RTOL, atol=ALS_ATOL)
        np.testing.assert_allclose(model.item_factors, jmodel.item_factors,
                                   rtol=ALS_RTOL, atol=ALS_ATOL)
        algo = rv.CategoryALSAlgorithm()
        assert len(algo.predict(model, rv.CatQuery("u1", 2)).itemScores) \
            == 2
        r = algo.predict(model, rv.CatQuery("u1", 3, categories=("a",)))
        assert all(s.item in ("i1", "i3") for s in r.itemScores)
        r = algo.predict(model, rv.CatQuery("u1", 3,
                                            blackList=("i1", "i3")))
        assert all(s.item == "i2" for s in r.itemScores)
        r = algo.predict(model, rv.CatQuery("u1", 3, whiteList=("i1",)))
        assert [s.item for s in r.itemScores] == ["i1"]
        assert algo.predict(model, rv.CatQuery("zz", 3)).itemScores == ()

    def test_category_als_serves_a_carried_model_exactly(self, same_init):
        (rv, _m), (jrv, jmodel) = _cat_train(_shop_specs(), rank=3, iters=4)
        carried = _carry(jmodel)
        assert type(carried) is rv.CategoryALSModel
        built = PORT.model_io.category_als_model_from_numpy(
            jmodel.rank, jmodel.user_factors, jmodel.item_factors,
            jmodel.user_vocab.to_dict(), jmodel.item_vocab.to_dict(),
            _carry(jmodel).items)
        algo, jalgo = rv.CategoryALSAlgorithm(), jrv.CategoryALSAlgorithm()
        for u in ("u0", "u3", "u17", "nobody"):
            for kw in ({}, {"categories": ("c1", "c2")},
                       {"whiteList": ("i1", "i2", "i9")},
                       {"blackList": ("i0", "i4")}):
                want = _as_dict(jalgo.predict(jmodel, jrv.CatQuery(u, 5,
                                                                   **kw)))
                for m in (carried, built):
                    assert _as_dict(algo.predict(m, rv.CatQuery(
                        u, 5, **kw))) == want

    def test_entitymap_datasource(self):
        tds = []
        for pkg, st, _app in _stores("emapp", _em_specs()):
            rv = pkg.ex("recommendation_variants")
            ds = rv.EntityMapDataSource(rv.EntityMapDataSourceParams("emapp"))
            td = ds.read_training(pkg.ctx(st))
            assert td.n == 3
            assert np.isclose(td.rating, 4.0).sum() == 1
            assert td.users.data("u1") == rv.User(attr0=1.5, attr1=0,
                                                  attr2=10)
            assert td.items.data("i2") == rv.EMItem(attrA="s1", attrB=1,
                                                    attrC=True)
            tds.append(td)
        td, jtd = tds
        for f in ("user_idx", "item_idx", "rating"):
            assert getattr(td, f).tobytes() == getattr(jtd, f).tobytes()
        assert td.user_vocab.to_dict() == jtd.user_vocab.to_dict()
        assert [dataclasses.asdict(td.users.data(u)) for u in ("u1", "u2")] \
            == [dataclasses.asdict(jtd.users.data(u)) for u in ("u1", "u2")]

    def test_entitymap_full_train(self, same_init):
        models = []
        for pkg, st, _app in _stores("emapp", _em_specs()):
            rv = pkg.ex("recommendation_variants")
            ap = pkg.mod("models.recommendation").ALSAlgorithmParams
            ep = pkg.EngineParams(
                data_source_params=rv.EntityMapDataSourceParams("emapp"),
                algorithm_params_list=(
                    ("als", ap(rank=2, numIterations=3, lambda_=0.1,
                               seed=1)),))
            (m,) = _train(pkg, rv.entitymap_engine(), ep, st)
            assert m.user_factors.shape[1] == 2
            models.append(m)
        for f in ("user_factors", "item_factors"):
            np.testing.assert_allclose(np.asarray(getattr(models[0], f)),
                                       np.asarray(getattr(models[1], f)),
                                       rtol=ALS_RTOL, atol=ALS_ATOL)

    def test_file_datasource(self, tmp_path, same_init):
        f = tmp_path / "ratings.txt"
        f.write_text("u1::i1::5.0\nu1::i2::1.0\nu2::i1::4.0\nu2::i2::2.0\n")
        models = []
        for pkg in BOTH:
            rv = pkg.ex("recommendation_variants")
            ap = pkg.mod("models.recommendation").ALSAlgorithmParams
            ep = pkg.EngineParams(
                data_source_params=rv.FileDataSourceParams(str(f)),
                algorithm_params_list=(
                    ("als", ap(rank=2, numIterations=5, lambda_=0.1,
                               seed=3)),))
            (m,) = _train(pkg, rv.file_engine(), ep, pkg.fresh())
            U, V = np.asarray(m.user_factors), np.asarray(m.item_factors)
            u = m.user_vocab("u1")
            assert V[m.item_vocab("i1")] @ U[u] > V[m.item_vocab("i2")] @ U[u]
            models.append((U, V))
        np.testing.assert_allclose(models[0][0], models[1][0],
                                   rtol=ALS_RTOL, atol=ALS_ATOL)
        np.testing.assert_allclose(models[0][1], models[1][1],
                                   rtol=ALS_RTOL, atol=ALS_ATOL)


# ---------------------------------------------------------------------------
# maintenance apps
# ---------------------------------------------------------------------------

def _seed_app(pkg, st, name, n=6):
    app_id = pkg.app(st, name)
    pkg.write(st, app_id, [_ev("e", "user", f"u{i}", {"i": i}, t=_t(day=1 + i))
                           for i in range(n)])
    return app_id


class TestMaintenanceApps:
    def test_cleanup_deletes_before_cutoff(self):
        got = []
        for pkg in BOTH:
            apps = pkg.ex("apps")
            st = pkg.fresh()
            app_id = _seed_app(pkg, st, "cleanapp")
            ep = pkg.EngineParams(
                data_source_params=apps.CleanupDataSourceParams(
                    appId=app_id, cutoffTime=_t(day=4)),
                algorithm_params_list=(("", None),))
            (report,) = _train(pkg, apps.cleanup_engine(), ep, st)
            left = sorted(e.entity_id for e in
                          st.get_events().find(app_id=app_id))
            got.append((dataclasses.asdict(report), left))
        assert got[0] == got[1] == ({"count_before": 6, "affected": 3,
                                     "count_after": 3}, ["u3", "u4", "u5"])

    def test_trim_copies_window_and_refuses_nonempty(self):
        got = []
        for pkg in BOTH:
            apps = pkg.ex("apps")
            st = pkg.fresh()
            src = _seed_app(pkg, st, "srcapp")
            dst = pkg.app(st, "dstapp")
            ep = pkg.EngineParams(
                data_source_params=apps.TrimDataSourceParams(
                    srcAppId=src, dstAppId=dst, startTime=_t(day=2),
                    untilTime=_t(day=5)),
                algorithm_params_list=(("", None),))
            engine = apps.trim_engine()
            (report,) = _train(pkg, engine, ep, st)
            copied = sorted((e.entity_id, e.properties.to_dict())
                            for e in st.get_events().find(app_id=dst))
            with pytest.raises(RuntimeError, match="not empty"):
                _train(pkg, engine, ep, st)
            got.append((report.affected, copied))
        assert got[0] == got[1]
        assert [c[0] for c in got[0][1]] == ["u1", "u2", "u3"]


# ---------------------------------------------------------------------------
# movielens
# ---------------------------------------------------------------------------

def _timed_specs(seed=5, days=30, users=4, items=6):
    rng = np.random.default_rng(seed)
    return [_ev("rate", "user", f"u{u}",
                {"rating": float(rng.integers(1, 6))},
                f"i{int(rng.integers(0, items))}", t=_t(day=1) +
                dt.timedelta(days=day))
            for day in range(days) for u in range(users)]


class TestMovieLens:
    def test_temp_filter_serving(self, tmp_path):
        f = tmp_path / "disabled.txt"
        for contents, want in (("i2\n", ["i1", "i3"]), ("", ["i1", "i2",
                                                              "i3"]),
                               ("  i3 \n\ni1\n", ["i2"])):
            f.write_text(contents)
            for pkg in BOTH:
                ml = pkg.ex("movielens")
                eng = pkg.mod("models.recommendation.engine")
                serving = ml.TempFilterServing(ml.TempFilterParams(str(f)))
                pred = eng.PredictedResult(itemScores=(
                    eng.ItemScore("i1", 3.0), eng.ItemScore("i2", 2.5),
                    eng.ItemScore("i3", 1.0)))
                out = serving.serve(eng.Query(user="u", num=3), [pred])
                assert [s.item for s in out.itemScores] == want

    def test_sliding_eval_windows(self):
        got = []
        for pkg, st, _app in _stores("mlapp", _timed_specs()):
            ml = pkg.ex("movielens")
            ds = ml.SlidingEvalDataSource(ml.SlidingEvalDataSourceParams(
                appName="mlapp", firstTrainingUntilTime=_t(day=21),
                evalDurationSeconds=5 * 86400.0, evalCount=2))
            sets = ds.read_eval(pkg.ctx(st))
            assert len(sets) == 2
            (td1, _e1, qa1), (td2, _e2, qa2) = sets
            assert (td1.n, td2.n) == (80, 100) and qa1 and qa2
            got.append([(td.user_idx.tobytes(), td.item_idx.tobytes(),
                         td.rating.tobytes(),
                         [(_as_dict(q), _as_dict(a)) for q, a in qa])
                        for td, _e, qa in sets])
        assert got[0] == got[1]

    def test_sliding_eval_groups_many_users_as_the_reference(self):
        specs = _timed_specs(seed=9, days=12, users=40, items=25)
        got = []
        for pkg, st, _app in _stores("mlapp", specs):
            ml = pkg.ex("movielens")
            ds = ml.SlidingEvalDataSource(ml.SlidingEvalDataSourceParams(
                appName="mlapp", firstTrainingUntilTime=_t(day=6),
                evalDurationSeconds=2 * 86400.0, evalCount=4, queryNum=3))
            got.append([[(_as_dict(q), _as_dict(a)) for q, a in qa]
                        for _td, _e, qa in ds.read_eval(pkg.ctx(st))])
        assert got[0] == got[1] and len(got[0]) == 4

    def test_filtering_engine_serves_the_carried_model_filtered(
            self, tmp_path, same_init):
        specs = _shop_specs(seed=6, rate=True)
        blobs = []
        for pkg, st, _app in _stores("mlapp", specs):
            ml = pkg.ex("movielens")
            variant = {
                "id": "ml", "engineFactory":
                    f"{pkg.root}.examples.movielens:filtering_engine",
                "datasource": {"params": {"appName": "mlapp"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": 3, "numIterations": 4, "lambda": 0.05,
                    "seed": 2}}],
                "serving": {"params": {"filepath": str(tmp_path / "off")}}}
            engine = ml.filtering_engine()
            ep = engine.engine_params_from_json(variant)
            iid = pkg.core.run_train(pkg.ctx(st), engine, ep,
                                     engine_factory=variant["engineFactory"],
                                     params_json=variant)
            blobs.append((st.get_model_data_models().get(iid).models, ep))
        (port_blob, port_ep), (jblob, _jep) = blobs
        (mine,) = PORT.model_io.deserialize_models(port_blob)
        (carried,) = PORT.model_io.deserialize_models(jblob)
        np.testing.assert_allclose(mine.user_factors, carried.user_factors,
                                   rtol=ALS_RTOL, atol=ALS_ATOL)
        # the deploy path of the port on the JAX-trained factors
        (tmp_path / "off").write_text("i3\ni7\n")
        ml = PORT.ex("movielens")
        _ds, _p, (algo,), serving = ml.filtering_engine()._instantiate(
            port_ep)
        model = algo.prepare_serving(carried)
        Query = PORT.mod("models.recommendation.engine").Query
        for u in ("u0", "u5", "u11"):
            full = algo.predict(model, Query(user=u, num=8))
            out = serving.serve(Query(user=u, num=8), [full])
            assert [s.item for s in out.itemScores] == [
                s.item for s in full.itemScores if s.item not in ("i3",
                                                                  "i7")]
            scores = carried.item_factors @ carried.user_factors[
                carried.user_vocab(u)]
            top = np.lexsort((np.arange(len(scores)), -scores))[:8]
            inv = carried.item_vocab.inverse()
            assert [s.item for s in full.itemScores] == [inv(int(i))
                                                         for i in top]


# ---------------------------------------------------------------------------
# stock
# ---------------------------------------------------------------------------

def _prices(path, days=300, seed=11):
    rng = np.random.default_rng(seed)
    trend = 100 * np.exp(np.cumsum(rng.normal(0.002, 0.01, days)))
    noise = 100 * np.exp(np.cumsum(rng.normal(0.0, 0.02, days)))
    flat = np.full(days, 50.0) + rng.normal(0, 0.01, days)
    lines = ["date,TREND,NOISE,FLAT"] + [
        f"d{d},{trend[d]:.4f},{noise[d]:.4f},{flat[d]:.4f}"
        for d in range(days)]
    path.write_text("\n".join(lines) + "\n")


class TestStock:
    def test_indicators(self):
        lp = np.log(np.linspace(100, 200, 50))
        mixed = np.cumsum(np.random.default_rng(3).normal(0, 0.02, 80))
        got = []
        for pkg in BOTH:
            st = pkg.ex("stock")
            sh = st.ShiftsIndicator(5).get_training(lp)
            np.testing.assert_allclose(sh[5:], lp[5:] - lp[:-5])
            rsi = st.RSIIndicator(14).get_training(lp)
            assert rsi[-1] == pytest.approx(100.0) and rsi[0] == 50.0
            assert st.RSIIndicator(14).get_training(
                lp[::-1].copy())[-1] == pytest.approx(0.0)
            got.append([ind.get_training(x).tobytes()
                        for ind in (st.ShiftsIndicator(3),
                                    st.RSIIndicator(7))
                        for x in (lp, mixed)])
        assert got[0] == got[1]

    def test_regression_strategy_and_backtest(self, tmp_path):
        f = tmp_path / "prices.csv"
        _prices(f)
        got = []
        for pkg in BOTH:
            st = pkg.ex("stock")
            dsp = st.StockDataSourceParams(filepath=str(f),
                                           trainUntilIdx=250,
                                           evalInterval=10, evalCount=3)
            ep = pkg.EngineParams(
                data_source_params=dsp,
                algorithm_params_list=(
                    ("", st.RegressionStrategyParams(shifts=(1, 5, 22))),))
            (model,) = _train(pkg, st.engine(), ep, pkg.fresh())
            assert model.coef.shape == (3, 5)
            algo = st.RegressionStrategyAlgorithm(
                st.RegressionStrategyParams(shifts=(1, 5, 22)))
            pred = algo.predict(model, st.QueryDate(idx=249))
            assert set(pred.data) == {"TREND", "NOISE", "FLAT"}
            assert pred.data["TREND"] > pred.data["FLAT"]

            class StockEval(pkg.controller.Evaluation):
                engine = st.engine()
                metric = st.BacktestingMetric(st.BacktestingParams(
                    enterThreshold=0.0005, exitThreshold=0.0,
                    maxPositions=2))

            ev = StockEval()
            pkg.core.run_evaluation(pkg.ctx(pkg.fresh()), ev, [ep],
                                    evaluation_class="StockEval")
            bt = ev.metric.last_result
            assert bt.days > 0 and len(bt.nav) == bt.days + 1
            assert all(np.isfinite(bt.nav)) and min(bt.nav) > 0
            got.append((model.coef, pred.data, bt))
        (coef, pred, bt), (jcoef, jpred, jbt) = got
        assert coef.dtype == jcoef.dtype == np.float32
        np.testing.assert_allclose(coef, jcoef, rtol=1e-3, atol=1e-5)
        assert pred.keys() == jpred.keys()
        np.testing.assert_allclose([pred[k] for k in sorted(pred)],
                                   [jpred[k] for k in sorted(jpred)],
                                   rtol=1e-3, atol=1e-6)
        assert bt.days == jbt.days

    def test_rank_deficient_ticker_solves_finite_as_the_reference(
            self, tmp_path):
        """A ticker delisted early (its log price pinned at 0 after, so
        every indicator column is 0 over the fit window) and a constant
        one give rank-deficient systems: the minimum-norm answer, finite,
        equal to the JAX package's within the stated tolerance."""
        days = 120
        rng = np.random.default_rng(8)
        live = 100 * np.exp(np.cumsum(rng.normal(0.001, 0.01, days)))
        dead = 50 * np.exp(np.cumsum(rng.normal(0.0, 0.02, days)))
        dead[10:] = np.nan                           # delisted at day 10
        const = np.full(days, 20.0)
        lines = ["date,LIVE,DEAD,CONST"] + [
            f"d{d},{live[d]:.4f},{dead[d]:.4f},{const[d]:.4f}"
            for d in range(days)]
        f = tmp_path / "prices.csv"
        f.write_text("\n".join(lines) + "\n")
        coefs = []
        for pkg in BOTH:
            st = pkg.ex("stock")
            data = st.StockDataSource(st.StockDataSourceParams(
                filepath=str(f), trainUntilIdx=100)).read_training(None)
            model = st.RegressionStrategyAlgorithm().train(None, data)
            assert np.all(np.isfinite(model.coef)), model.coef
            assert model.active_ticker.tolist() == [True, False, True]
            coefs.append(model.coef)
        np.testing.assert_allclose(coefs[0], coefs[1], rtol=1e-3, atol=1e-5)
        # the zero columns get zero weight: the minimum-norm answer
        assert np.all(coefs[0][1, :-1] == 0.0) and coefs[0][1, -1] == 0.0

    def test_lstsq_min_norm_is_numpy_pinv(self):
        from predictionio_tpu_torch.examples.stock import lstsq_min_norm
        rng = np.random.default_rng(4)
        a = rng.normal(size=(6, 40, 5)).astype(np.float32)
        a[1, :, 2] = 0.0                              # a zero column
        a[2, :, 4] = a[2, :, 0]                       # a repeated one
        b = rng.normal(size=(6, 40)).astype(np.float32)
        x = lstsq_min_norm(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        want = np.stack([np.linalg.pinv(a[k].astype(np.float64),
                                        rcond=40 * np.finfo(np.float32).eps)
                         @ b[k] for k in range(6)])
        np.testing.assert_allclose(x, want, rtol=1e-3, atol=1e-5)

    def test_rsi_bounded_on_mixed_series(self):
        lp = np.cumsum(np.random.default_rng(3).normal(0, 0.02, 500))
        out = []
        for pkg in BOTH:
            rsi = pkg.ex("stock").RSIIndicator(14).get_training(lp)
            assert np.all((rsi >= 0.0) & (rsi <= 100.0))
            assert rsi[50:].std() > 1.0
            out.append(rsi.tobytes())
        assert out[0] == out[1]

    def test_eval_predictions_use_query_day_history(self, tmp_path):
        f = tmp_path / "prices.csv"
        _prices(f)
        got = []
        for pkg in BOTH:
            st = pkg.ex("stock")
            ds = st.StockDataSource(st.StockDataSourceParams(
                filepath=str(f), trainUntilIdx=250, evalInterval=10,
                evalCount=1))
            (train, _e, qa), = ds.read_eval(None)
            algo = st.RegressionStrategyAlgorithm()
            model = algo.train(None, train)
            p0 = algo.predict(model, qa[0][0])
            p5 = algo.predict(model, qa[5][0])
            assert p0.data != p5.data
            got.append([p0.data[k] for k in sorted(p0.data)])
        np.testing.assert_allclose(got[0], got[1], rtol=1e-3, atol=1e-6)

    def test_backtest_survives_delisting(self):
        days = 30
        prices = np.full((days, 2), 100.0)
        prices[:, 1] = 50.0
        prices[20:, 1] = np.nan
        results = []
        for pkg in BOTH:
            st = pkg.ex("stock")
            frame = st.StockTrainingData(
                tickers=["LIVE", "DEAD"], prices=prices,
                active=np.isfinite(prices) & (prices > 0))
            metric = st.BacktestingMetric(st.BacktestingParams(
                enterThreshold=0.0, exitThreshold=-1.0, maxPositions=2))
            qa = [(st.QueryDate(idx=d),
                   st.StockPrediction(data={"LIVE": 0.01, "DEAD": 0.01}),
                   frame) for d in range(15, 28)]
            sharpe = metric.calculate([(None, qa)])
            bt = metric.last_result
            assert all(np.isfinite(bt.nav)) and np.isfinite(bt.ret)
            results.append((sharpe, bt.ret, bt.vol, bt.nav))
        assert results[0] == results[1]


# ---------------------------------------------------------------------------
# recommended user
# ---------------------------------------------------------------------------

def _ru_specs(extra=0, seed=1):
    evs = [_ev("$set", "user", f"u{k}") for k in range(5 + extra)]
    follows = [("u0", "u3"), ("u0", "u4"), ("u1", "u3"), ("u1", "u4"),
               ("u2", "u3"), ("u0", "u3")]
    rng = np.random.default_rng(seed)
    follows += [(f"u{rng.integers(5 + extra)}", f"u{rng.integers(5 + extra)}")
                for _ in range(6 * extra)]
    evs += [_ev("follow", "user", a, target=b, ttype="user", t=_t(n))
            for n, (a, b) in enumerate(follows)]
    return evs


class TestRecommendedUser:
    def test_similar_users(self, same_init):
        models = []
        for pkg, st, _app in _stores("ruapp", _ru_specs()):
            ru = pkg.ex("recommended_user")
            ep = pkg.EngineParams(
                data_source_params=ru.RUDataSourceParams("ruapp"),
                algorithm_params_list=(
                    ("als", ru.RUALSParams(rank=4, numIterations=10,
                                           seed=5)),))
            (model,) = _train(pkg, ru.engine(), ep, st)
            algo = ru.RUALSAlgorithm()
            r = algo.predict(model, ru.RUQuery(users=("u3",), num=2))
            assert r.similarUserScores[0].user == "u4"
            assert all(s.user != "u3" for s in r.similarUserScores)
            r = algo.predict(model, ru.RUQuery(users=("u3",), num=2,
                                               blackList=("u4",)))
            assert all(s.user != "u4" for s in r.similarUserScores)
            assert algo.predict(model, ru.RUQuery(users=("zz",), num=2)
                                ).similarUserScores == ()
            models.append(model)
        np.testing.assert_allclose(models[0].followed_factors,
                                   models[1].followed_factors,
                                   rtol=ALS_RTOL, atol=ALS_ATOL)

    def test_carried_model_answers_exactly(self, same_init):
        (_p, st, _a), (jpkg, jst, _ja) = _stores("ruapp", _ru_specs(20))
        jru = JAX.ex("recommended_user")
        ep = JAX.EngineParams(
            data_source_params=jru.RUDataSourceParams("ruapp"),
            algorithm_params_list=(("als", jru.RUALSParams(
                rank=3, numIterations=4, seed=5)),))
        (jmodel,) = _train(JAX, jru.engine(), ep, jst)
        ru = PORT.ex("recommended_user")
        built = PORT.model_io.recommended_user_model_from_numpy(
            jmodel.user_vocab.to_dict(), jmodel.followed_factors)
        for model in (_carry(jmodel), built):
            for users in (("u3",), ("u1", "u7"), ("u2", "u9", "nope")):
                for kw in ({}, {"whiteList": ("u4", "u5", "u8")},
                           {"blackList": ("u4",)}):
                    assert _as_dict(ru.RUALSAlgorithm().predict(
                        model, ru.RUQuery(users=users, num=4, **kw))) == \
                        _as_dict(jru.RUALSAlgorithm().predict(
                            jmodel, jru.RUQuery(users=users, num=4, **kw)))


# ---------------------------------------------------------------------------
# the engine.json front door
# ---------------------------------------------------------------------------

def test_example_engine_drives_through_engine_json(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (150, 3))
    y = x @ np.array([2.0, -1.0, 0.5]) + 0.25
    data = tmp_path / "lr_data.txt"
    np.savetxt(data, np.column_stack([y, x]), fmt="%.6f")
    variant = {
        "id": "default",
        "engineFactory": "predictionio_tpu.examples.regression:engine",
        "datasource": {"params": {"filepath": str(data), "k": 3}},
        "algorithms": [{"name": "SGD", "params": {"numIterations": 200,
                                                  "stepSize": 0.5}}],
    }
    weights = []
    for pkg in BOTH:
        wu = pkg.mod("workflow.workflow_utils")
        engine = wu.get_engine(variant["engineFactory"])
        assert type(engine).__module__.startswith(pkg.root + ".")
        ep = engine.engine_params_from_json(variant)
        assert ep.algorithm_params_list[0][1].stepSize == 0.5
        st = pkg.fresh()
        iid = pkg.core.run_train(pkg.ctx(st), engine, ep,
                                 engine_factory=variant["engineFactory"],
                                 params_json=variant)
        blob = st.get_model_data_models().get(iid).models
        (w,) = PORT.model_io.deserialize_models(blob)
        weights.append(w)
    np.testing.assert_allclose(weights[0], weights[1], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# similar-product variants
# ---------------------------------------------------------------------------

def _spv_specs():
    evs = [_ev("$set", "item", f"i{i}", {
        "categories": c, "year": y, "title": ti, "date": f"{y}-01-01"})
        for i, (c, y, ti) in enumerate([(["a"], 2001, "Alpha"),
                                        (["a"], 1995, "Beta"),
                                        (["b"], 2010, "Gamma")])]
    views = [("u1", "i0"), ("u1", "i1"), ("u2", "i0"), ("u2", "i1"),
             ("u3", "i2")]
    evs += [_ev("view", "user", u, target=i, t=_t(n))
            for n, (u, i) in enumerate(views)]
    return evs


def _spv_rates():
    t0 = _t(day=2)
    pairs = [("u1", "i0", 5.0, 0), ("u1", "i1", 5.0, 1),
             ("u2", "i0", 5.0, 2), ("u2", "i1", 5.0, 3),
             ("u3", "i2", 4.0, 4), ("u1", "i1", 1.0, 0)]
    return [_ev("rate", "user", u, {"rating": r}, i,
                t=t0 + dt.timedelta(minutes=m)) for u, i, r, m in pairs]


def _spv_yearless():
    t0 = _t(hour=12)
    return ([_ev("$set", "item", "i3", {"categories": ["a"],
                                        "title": "NoYear"}, t=t0)]
            + [_ev("view", "user", u, target="i3", t=t0)
               for u in ("u1", "u2")])


def _spv_train(specs, rank=4, iters=10):
    out = []
    for pkg, st, _app in _stores("spvapp", specs):
        sv = pkg.ex("similarproduct_variants")
        ep = pkg.EngineParams(
            data_source_params=sv.VDataSourceParams(appName="spvapp"),
            algorithm_params_list=(
                ("als", sv.VALSParams(rank=rank, numIterations=iters,
                                      seed=3)),))
        out.append((sv, _train(pkg, sv.engine(), ep, st)[0]))
    return out


class TestSimilarProductVariants:
    @staticmethod
    def _same(runs):
        (sv, m), (jsv, jm) = runs
        np.testing.assert_allclose(m.item_factors, jm.item_factors,
                                   rtol=ALS_RTOL, atol=ALS_ATOL)
        for f in ("trained", "years", "has_year"):
            assert getattr(m, f).tobytes() == getattr(jm, f).tobytes()
        assert m.item_vocab.to_dict() == jm.item_vocab.to_dict()

    def test_no_set_user_and_returned_properties(self, same_init):
        runs = _spv_train(_spv_specs())
        self._same(runs)
        for sv, model in runs:
            r = sv.VALSAlgorithm().predict(model, sv.VQuery(items=("i0",),
                                                            num=3))
            top = r.itemScores[0]
            assert (top.item, top.title, top.year, top.date) == (
                "i1", "Beta", 1995, "1995-01-01")

    def test_year_filter(self, same_init):
        for sv, model in _spv_train(_spv_specs()):
            algo = sv.VALSAlgorithm()
            r = algo.predict(model, sv.VQuery(items=("i0",), num=3,
                                              recommendFromYear=2000))
            assert all(s.item != "i1" for s in r.itemScores)
            r = algo.predict(model, sv.VQuery(items=("i0",), num=3,
                                              recommendFromYear=1990))
            assert any(s.item == "i1" for s in r.itemScores)

    def test_rate_events_switch_to_explicit_latest_wins(self, same_init):
        runs = _spv_train(_spv_specs() + _spv_rates())
        self._same(runs)
        for sv, model in runs:
            r = sv.VALSAlgorithm().predict(model, sv.VQuery(items=("i0",),
                                                            num=3))
            assert r.itemScores[0].item == "i1"

    def test_negative_year_floor_excludes_yearless_items(self, same_init):
        for sv, model in _spv_train(_spv_specs() + _spv_yearless()):
            algo = sv.VALSAlgorithm()
            r = algo.predict(model, sv.VQuery(items=("i0",), num=5))
            assert any(s.item == "i3" for s in r.itemScores)
            r = algo.predict(model, sv.VQuery(items=("i0",), num=5,
                                              recommendFromYear=-1))
            assert all(s.item != "i3" for s in r.itemScores)

    def test_carried_model_answers_exactly(self, same_init):
        specs = _shop_specs(seed=12) + _spv_yearless()
        (sv, _m), (jsv, jmodel) = _spv_train(specs, rank=3, iters=4)
        carried = _carry(jmodel)
        built = PORT.model_io.similarproduct_variants_model_from_numpy(
            jmodel.item_factors, jmodel.item_vocab.to_dict(), carried.items,
            jmodel.trained)
        for name in jmodel.category_masks:
            assert built.category_masks[name].tobytes() == \
                jmodel.category_masks[name].tobytes()
        for items in (("i0",), ("i3", "i5"), ("i1", "nope")):
            for kw in ({}, {"categories": ("c1",)}, {"blackList": ("i2",)},
                       {"recommendFromYear": 0}):
                want = _as_dict(jsv.VALSAlgorithm().predict(
                    jmodel, jsv.VQuery(items=items, num=6, **kw)))
                for model in (carried, built):
                    assert _as_dict(sv.VALSAlgorithm().predict(
                        model, sv.VQuery(items=items, num=6, **kw))) == want


def test_every_example_model_class_loads_from_a_blob():
    """The blob loader knows each example's and e2's model classes under
    both packages' module paths (and refuses others)."""
    jru = JAX.ex("recommended_user")
    jdm = JAX.ex("dimsum")
    jfr = JAX.ex("friend_recommendation")
    jst = JAX.ex("stock")
    japps = JAX.ex("apps")
    models = [
        jru.RUModel(user_vocab=JAX.mod("data.bimap").BiMap({"a": 0}),
                    followed_factors=np.ones((1, 2), np.float32)),
        jdm.DIMSUMModel(similarities=np.eye(2, dtype=np.float32),
                        item_vocab=JAX.mod("data.bimap").BiMap({"x": 0,
                                                                "y": 1}),
                        items={}, category_masks={}),
        jfr.SimRankModel(user_id_map={1: 0}, scores=np.eye(1)),
        jfr.KeywordSimilarityModel({1: 0}, {2: 0}, np.ones((1, 1)),
                                   np.ones((1, 1)), 1.0, 1.0),
        jst.RegressionStrategyModel(["T"], np.zeros((1, 3), np.float32),
                                    np.ones((5, 1)), np.ones(1, bool)),
        japps.MaintenanceReport(1, 2, 3),
    ]
    out = PORT.model_io.deserialize_models(
        JAX.model_io.serialize_models(models))
    for jm, m in zip(models, out):
        assert type(m).__module__.startswith("predictionio_tpu_torch.")
        assert type(m).__name__ == type(jm).__name__
    again = PORT.model_io.deserialize_models(
        PORT.model_io.serialize_models(out))
    assert [type(m) for m in again] == [type(m) for m in out]
    with pytest.raises(pickle.UnpicklingError):
        PORT.model_io.deserialize_models(pickle.dumps(
            [dt.timezone.utc]))
