"""The training slice as a whole: event store -> DataSource -> Preparator
-> explicit ALS -> model blob -> deploy, in the port against the JAX
package on the same events.

Seeds are not replayed (``jax.random`` against ``torch.Generator``):
``_seed_factors`` is patched in both packages to return the same numpy
factors. Trained factors are held to rtol 2e-3 / atol 2e-4 (fp32 Gram
sums in another order than XLA's); vocabularies and the columnar read
are exact. Top-k indices must agree wherever the reference's adjacent
score gaps exceed 1e-3."""

import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.data import store as jstore
from predictionio_tpu.data import synthetic as jsynthetic
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.engine import (
    RecommendationEngine as JRecommendationEngine,
)
from predictionio_tpu.ops import als as jals
from predictionio_tpu.workflow import WorkflowContext as JWorkflowContext
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu.workflow import run_train as jrun_train
from predictionio_tpu_torch.data import store, synthetic
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)
from predictionio_tpu_torch.ops import als, quant
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import create_server, model_io
from predictionio_tpu_torch.workflow.checkpoint import (
    FactorCheckpointer, run_checkpoint_dir,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")


RANK, ITERS, LAM = 4, 5, 0.07
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}


def _variant(factory, iterations=ITERS, **params):
    return {
        "id": "default",
        "engineFactory": factory,
        "datasource": {"params": {"appName": "TestApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": iterations, "lambda": LAM,
            "seed": 3, **params}}],
    }


def _events(event_cls, datamap_cls, seed=5, n_users=40, n_items=25,
            n=600):
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


def _fill(storage, app_cls, event_cls, datamap_cls, write):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "TestApp"))
    storage.get_events().init(app_id)
    write(_events(event_cls, datamap_cls), app_id, storage=storage)
    return app_id


def _fixed_seed_factors(seed, n_users, n_items, rank, **_kw):
    rng = np.random.default_rng(1234)
    U = np.abs(rng.normal(size=(n_users, rank))) / np.sqrt(rank)
    V = np.abs(rng.normal(size=(n_items, rank))) / np.sqrt(rank)
    return U.astype(np.float32), V.astype(np.float32)


def _train_both(monkeypatch, jstorage, tstorage):
    monkeypatch.setattr(jals, "_seed_factors", _fixed_seed_factors)
    monkeypatch.setattr(als, "_seed_factors", _fixed_seed_factors)
    jvariant = _variant(
        "predictionio_tpu.models.recommendation.engine:RecommendationEngine")
    jengine = JRecommendationEngine()
    jid = jrun_train(JWorkflowContext(storage=jstorage), jengine,
                     jengine.engine_params_from_json(jvariant),
                     engine_factory=jvariant["engineFactory"],
                     params_json=jvariant)
    tvariant = _variant("predictionio_tpu_torch.models.recommendation."
                        "engine:RecommendationEngine")
    tengine = RecommendationEngine()
    tid = run_train(WorkflowContext(storage=tstorage, device="cpu"),
                    tengine, tengine.engine_params_from_json(tvariant),
                    engine_factory=tvariant["engineFactory"],
                    params_json=tvariant)
    (jm,) = jmodel_io.deserialize_models(
        jstorage.get_model_data_models().get(jid).models)
    (tm,) = model_io.deserialize_models(
        tstorage.get_model_data_models().get(tid).models)
    return jm, tm, tid


def _assert_same_model(jm, tm):
    assert tm.rank == jm.rank == RANK
    assert tm.user_vocab.to_dict() == jm.user_vocab.to_dict()
    assert tm.item_vocab.to_dict() == jm.item_vocab.to_dict()
    np.testing.assert_allclose(tm.user_factors, np.asarray(jm.user_factors),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tm.item_factors, np.asarray(jm.item_factors),
                               rtol=2e-3, atol=2e-4)


def _query(api, user, num):
    status, payload = api.handle(
        "POST", "/queries.json",
        body=json.dumps({"user": user, "num": num}).encode())[:2]
    assert status == 200, payload
    return [s["item"] for s in payload["itemScores"]]


def _assert_topk_agrees(api, jm, users, num=5, gap=1e-3):
    U, V = np.asarray(jm.user_factors), np.asarray(jm.item_factors)
    inv = jm.item_vocab.inverse()
    for user in users:
        scores = V @ U[jm.user_vocab(user)]
        order = np.argsort(-scores, kind="stable")[:num + 1]
        got = _query(api, user, num)
        assert len(got) == num
        s = scores[order]
        for j in range(num):
            gaps = [s[j] - s[j + 1]] + ([s[j - 1] - s[j]] if j else [])
            if min(gaps) > gap:
                assert got[j] == inv(int(order[j])), (user, j)


def test_memory_store_trains_to_the_reference_and_serves(monkeypatch):
    jstorage, tstorage = JStorage(env=MEM), Storage(env=MEM)
    _fill(jstorage, JApp, JEvent, JDataMap, jstore.write)
    _fill(tstorage, App, Event, DataMap, store.write)
    jm, tm, tid = _train_both(monkeypatch, jstorage, tstorage)
    _assert_same_model(jm, tm)
    row = tstorage.get_meta_data_engine_instances().get(tid)
    assert row.status == "COMPLETED"
    assert {"phase_read_s", "phase_layout_s", "phase_train_s"} <= \
        set(row.runtime_conf)
    api = create_server.QueryAPI(
        create_server.ServerConfig(device="cpu", serve_quant="off",
                                   batching="off"), storage=tstorage)
    _assert_topk_agrees(api, jm, [f"u{u}" for u in range(0, 40, 3)])


def test_sqlite_store_of_the_jax_package_reads_and_trains_here(
        monkeypatch, tmp_path):
    """A SQLite store the JAX package filled: the port's columnar read
    equals the reference's, the port trains on it, and the port deploys
    the instance the JAX package trained there (its factory mapped)."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    env = {"PIO_FS_BASEDIR": str(tmp_path)}
    jstorage = JStorage(env=env)
    _fill(jstorage, JApp, JEvent, JDataMap, jstore.write)
    tstorage = Storage(env=env)
    kw = dict(entity_type="user", event_names=["rate", "buy"],
              target_entity_type="item")
    jcol = jstore.find_columnar("TestApp", storage=jstorage, **kw)
    tcol = store.find_columnar("TestApp", storage=tstorage, **kw)
    assert tcol.entity_ids.to_dict() == jcol.entity_ids.to_dict()
    assert tcol.target_ids.to_dict() == jcol.target_ids.to_dict()
    assert tcol.event_names == jcol.event_names
    for f in ("entity_idx", "target_idx", "event_name_idx", "rating",
              "event_time_ms"):
        np.testing.assert_array_equal(getattr(tcol, f), getattr(jcol, f))
    jm, tm, _tid = _train_both(monkeypatch, jstorage, tstorage)
    _assert_same_model(jm, tm)
    # deploy the JAX package's instance (the newest COMPLETED one is the
    # port's own; pin the JAX one)
    jrow = next(i for i in tstorage.get_meta_data_engine_instances()
                .get_all() if i.engine_factory.startswith(
                    "predictionio_tpu.models"))
    api = create_server.QueryAPI(
        create_server.ServerConfig(engine_instance_id=jrow.id, device="cpu",
                                   serve_quant="off", batching="off"),
        storage=tstorage)
    _assert_topk_agrees(api, jm, ["u1", "u7", "u30"])


def test_synthetic_training_data_equals_the_reference():
    jtd = jsynthetic.training_data(5000, seed=11, stream=False)
    ttd = synthetic.training_data(5000, seed=11, stream=False, device="cpu")
    assert ttd.user_vocab.to_dict() == jtd.user_vocab.to_dict()
    assert ttd.item_vocab.to_dict() == jtd.item_vocab.to_dict()
    for f in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(ttd, f), getattr(jtd, f))


def test_cli_trains_synthetic_then_deploys(monkeypatch, tmp_path):
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(_variant(
        "predictionio_tpu_torch.models.recommendation.engine:"
        "RecommendationEngine", iterations=3)))
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    # the CLI sets these; registering them here undoes them after the test
    monkeypatch.setenv("PIO_SYNTHETIC_EVENTS", "3000")
    monkeypatch.setenv("PIO_SYNTHETIC_SEED", "2")
    assert cli.main(["train", "--engine-dir", str(engine_dir),
                     "--synthetic", "3000", "--synthetic-seed", "2"]) == 0
    storage = Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "store")})
    (row,) = storage.get_meta_data_engine_instances().get_all()
    assert row.status == "COMPLETED"
    api = create_server.QueryAPI(create_server.ServerConfig(
        device="cpu", serve_quant="off"), storage=storage)
    try:
        assert len(_query(api, "u0", 4)) == 4
    finally:
        api.close()
    (tm,) = model_io.deserialize_models(
        storage.get_model_data_models().get(row.id).models)
    assert np.isfinite(tm.user_factors).all()


def test_auto_resume_from_a_crashed_run(monkeypatch, tmp_path):
    """A crashed (ERROR) run's snapshot at step 2 seeds the next run of
    the same variant, which lands on exactly the uninterrupted
    factors."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setattr(als, "_seed_factors", _fixed_seed_factors)
    storage = Storage(env=MEM)
    _fill(storage, App, Event, DataMap, store.write)
    engine = RecommendationEngine()
    variant = _variant("predictionio_tpu_torch.models.recommendation."
                       "engine:RecommendationEngine", checkpointInterval=2)
    params = engine.engine_params_from_json(variant)

    def train():
        iid = run_train(WorkflowContext(storage=storage, device="cpu"),
                        engine, params, params_json=variant)
        (m,) = model_io.deserialize_models(
            storage.get_model_data_models().get(iid).models)
        return iid, m

    _iid, want = train()
    # a crashed run: ERROR row + the snapshot it left at step 2
    td = engine._instantiate(params)[0].read_training(
        WorkflowContext(storage=storage, device="cpu"))
    data = als.prepare_ratings(td.user_idx, td.item_idx, td.rating,
                               len(td.user_vocab), len(td.item_vocab))
    U2, V2 = als.train_explicit(data, rank=RANK, iterations=2, lambda_=LAM,
                                device="cpu")
    instances = storage.get_meta_data_engine_instances()
    crashed = instances.get(_iid)
    crashed_id = instances.insert(type(crashed)(**{
        **crashed.__dict__, "id": "", "status": "ERROR",
        "start_time": dt.datetime.now(dt.timezone.utc)}))
    FactorCheckpointer(run_checkpoint_dir(crashed_id)).save(
        2, model_io.snapshot_arrays(U2, V2))
    _iid2, got = train()
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    np.testing.assert_array_equal(got.item_factors, want.item_factors)
    assert FactorCheckpointer(run_checkpoint_dir(crashed_id)).latest() \
        is None


def test_trained_model_keeps_tensors_until_persisted(monkeypatch):
    """ALSAlgorithm.train returns the factors as tensors on the train
    device; prepare_serving takes them as they are."""
    storage = Storage(env=MEM)
    _fill(storage, App, Event, DataMap, store.write)
    engine = RecommendationEngine()
    params = engine.engine_params_from_json(_variant(
        "predictionio_tpu_torch.models.recommendation.engine:"
        "RecommendationEngine", iterations=2))
    ctx = WorkflowContext(storage=storage, device="cpu")
    (model,) = engine.train(ctx, params)
    assert isinstance(model.user_factors, torch.Tensor)
    algo = engine._instantiate(params)[2][0]
    with quant.deploy_scope("off", device=torch.device("cpu")):
        served = algo.prepare_serving(model)
    assert torch.equal(served.user_factors, model.user_factors)
