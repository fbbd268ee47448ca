"""The streamed, staged training read (``data/store.py``,
``ops/staging.py``) and the eventlog-fed train (``models/recommendation``)
against the JAX package's, and against the port's own in-core read.

- Streamed against in-core ``find_columnar`` on one eventlog store: the
  columns byte-identical (the streamed read's device mirrors, on the CPU
  here, value-identical to the host columns), and ``stream_digest`` equal
  to the reference's on the same store.
- A train from the eventlog store, with the initial factors injected
  into both packages, lands on the reference's factors in the tolerance
  class, and the served top-k agrees wherever score gaps exceed it.
- In the port, streamed and in-core trains give bit-identical factors,
  and a second train over the unchanged store at
  ``PIO_ALS_BIG_LAYOUT_MIN=0`` counts one layout-cache hit, no build and
  no staged copy.
"""

import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.data import store as jstore
from predictionio_tpu.data import synthetic as jsynthetic
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation import (
    als_algorithm as jals_algorithm,
)
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
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)
from predictionio_tpu_torch.ops import als, staging
from predictionio_tpu_torch.workflow import create_server, model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

APP = "StreamApp"
RANK, ITERS, LAM = 4, 4, 0.07
N_SYNTH, N_USERS, N_ITEMS = 6000, 120, 60
COLS = ("entity_idx", "target_idx", "event_name_idx", "rating")
KW = dict(entity_type="user", event_names=["rate", "buy"],
          target_entity_type="item")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the trains here: the suite runs beside
    timing-sensitive tests in other workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env(root):
    return {
        "PIO_STORAGE_SOURCES_L_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_L_PATH": str(root / "meta.sqlite"),
        "PIO_STORAGE_SOURCES_E_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_E_PATH": str(root / "eventlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "L",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "E",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "L",
    }


def _fill(storage, synth_mod, app_cls, event_cls, map_cls):
    """Synthetic rates through append_encoded (six chunks), then buys and
    rates through insert_batch, the last of them left in the WAL buffer."""
    app_id = storage.get_meta_data_apps().insert(app_cls(0, APP, None))
    src = synth_mod.chunk_source(N_SYNTH, seed=4, n_users=N_USERS,
                                 n_items=N_ITEMS, chunk=1000)
    assert synth_mod.write_events(src, storage, app_id) == N_SYNTH
    rng = np.random.default_rng(8)
    t0 = dt.datetime(2024, 2, 1, tzinfo=dt.timezone.utc)
    evs = [event_cls(
        event="buy" if k % 3 == 0 else "rate", entity_type="user",
        entity_id=f"u{int(rng.integers(N_USERS + 20))}",
        target_entity_type="item",
        target_entity_id=f"i{int(rng.integers(N_ITEMS))}",
        properties=map_cls({} if k % 3 == 0 else {
            "rating": float(rng.integers(1, 11)) / 2}),
        event_time=t0 + dt.timedelta(seconds=k)) for k in range(300)]
    storage.get_events().insert_batch(evs, app_id)
    return app_id


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """The same events in an eventlog store of each package, and fresh
    layout caches on both sides."""
    monkeypatch.setattr(als_algorithm, "_BIG_LAYOUT_CACHE", [])
    monkeypatch.setattr(jals_algorithm, "_BIG_LAYOUT_CACHE", [])
    for name in ("PIO_TRAIN_STREAM", "PIO_READ_STAGE", "PIO_READ_OVERLAP",
                 "PIO_ALS_LAYOUT_CACHE", "PIO_ALS_BIG_LAYOUT_MIN",
                 "PIO_TORCH_DEVICE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PIO_READ_THREADS", "2")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jst = JStorage(env=_env(tmp_path / "jax"))
    st = Storage(env=_env(tmp_path / "port"))
    _fill(jst, jsynthetic, JApp, JEvent, JDataMap)
    _fill(st, synthetic, App, Event, DataMap)
    return jst, st


def test_streamed_read_equals_the_in_core_read(stores):
    jst, st = stores
    want = jstore.find_columnar(APP, storage=jst, **KW)
    plain = store.find_columnar(APP, storage=st, **KW)
    staged = store.find_columnar(APP, storage=st, stage=True,
                                 device="cpu", **KW)
    streamed = store.find_columnar(APP, storage=st, stream=True,
                                   device="cpu", **KW)
    assert plain.n == staged.n == streamed.n == N_SYNTH + 300
    for col in (plain, staged):
        assert col.entity_ids.to_dict() == want.entity_ids.to_dict()
        assert col.target_ids.to_dict() == want.target_ids.to_dict()
        assert col.event_names == want.event_names
        for f in COLS + ("event_time_ms",):
            assert getattr(col, f).tobytes() == getattr(want, f).tobytes()
    assert plain.staged is None
    assert streamed.entity_idx is None and streamed.rating is None
    assert streamed.entity_ids.to_dict() == want.entity_ids.to_dict()
    assert streamed.target_ids.to_dict() == want.target_ids.to_dict()
    assert streamed.event_names == want.event_names
    # the staged mirrors, in-core and streamed, hold the host columns
    for mirror in (staged.staged, streamed.staged):
        for f in COLS:
            got = getattr(mirror, f).numpy()
            assert got.dtype == getattr(plain, f).dtype
            assert got.tobytes() == getattr(plain, f).tobytes(), f
    # one content fingerprint for every mode, equal to the reference's
    assert want.stream_digest is not None
    assert plain.stream_digest == staged.stream_digest == \
        streamed.stream_digest == want.stream_digest


def test_read_knobs_keep_the_columns(stores, monkeypatch):
    """PIO_READ_OVERLAP=0 (the read that does not stream: read_columns,
    no digest), one decode thread, and PIO_READ_STAGE=0 (a streamed read
    asked for falls back in-core: nothing to stage to) give the same
    columns."""
    _jst, st = stores
    base = store.find_columnar(APP, storage=st, **KW)
    for name, value, digest in (("PIO_READ_OVERLAP", "0", None),
                                ("PIO_READ_THREADS", "1",
                                 base.stream_digest),
                                ("PIO_READ_STAGE", "0", base.stream_digest)):
        monkeypatch.setenv(name, value)
        got = store.find_columnar(APP, storage=st, stage=True, stream=True,
                                  device="cpu", **KW)
        if name == "PIO_READ_THREADS":
            assert got.entity_idx is None       # it streamed
            got = store.find_columnar(APP, storage=st, **KW)
        else:
            assert got.staged is None
        monkeypatch.delenv(name)
        for f in COLS:
            assert getattr(got, f).tobytes() == getattr(base, f).tobytes()
        assert got.stream_digest == digest


def test_synthetic_stream_digest_equals_the_reference():
    want = jsynthetic.training_data(5000, seed=3, stream=True)
    got = synthetic.training_data(5000, seed=3, stream=True, device="cpu")
    assert got.streamed and got.n == 5000
    assert got._stream_digest == want._stream_digest
    assert got.user_vocab.to_dict() == want.user_vocab.to_dict()
    host = synthetic.training_data(5000, seed=3, stream=False,
                                   device="cpu")
    u, i, r = got._staged_coo
    assert u.numpy().tobytes() == host.user_idx.tobytes()
    assert i.numpy().tobytes() == host.item_idx.tobytes()
    assert r.numpy().tobytes() == host.rating.tobytes()


def _fixed_seed_factors(seed, n_users, n_items, rank, **_kw):
    rng = np.random.default_rng(1234)
    U = np.abs(rng.normal(size=(n_users, rank))) / np.sqrt(rank)
    V = np.abs(rng.normal(size=(n_items, rank))) / np.sqrt(rank)
    return U.astype(np.float32), V.astype(np.float32)


def _variant(factory):
    return {
        "id": "default", "engineFactory": factory,
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERS, "lambda": LAM,
            "seed": 3}}],
    }


PORT_FACTORY = ("predictionio_tpu_torch.models.recommendation.engine:"
                "RecommendationEngine")


def _train(storage):
    """One port train from the store; returns its id, the model and the
    phase table."""
    variant = _variant(PORT_FACTORY)
    engine = RecommendationEngine()
    ctx = WorkflowContext(storage=storage, device="cpu")
    iid = run_train(ctx, engine, engine.engine_params_from_json(variant),
                    engine_factory=PORT_FACTORY, params_json=variant)
    (m,) = model_io.deserialize_models(
        storage.get_model_data_models().get(iid).models)
    return iid, m


def test_eventlog_train_matches_the_reference(stores, monkeypatch):
    jst, st = stores
    monkeypatch.setattr(jals, "_seed_factors", _fixed_seed_factors)
    monkeypatch.setattr(als, "_seed_factors", _fixed_seed_factors)
    jvariant = _variant("predictionio_tpu.models.recommendation.engine:"
                        "RecommendationEngine")
    jengine = JRecommendationEngine()
    jid = jrun_train(JWorkflowContext(storage=jst), jengine,
                     jengine.engine_params_from_json(jvariant),
                     engine_factory=jvariant["engineFactory"],
                     params_json=jvariant)
    (jm,) = jmodel_io.deserialize_models(
        jst.get_model_data_models().get(jid).models)
    tid, tm = _train(st)
    assert tm.user_vocab.to_dict() == jm.user_vocab.to_dict()
    assert tm.item_vocab.to_dict() == jm.item_vocab.to_dict()
    np.testing.assert_allclose(tm.user_factors, np.asarray(jm.user_factors),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tm.item_factors, np.asarray(jm.item_factors),
                               rtol=2e-3, atol=2e-4)
    row = st.get_meta_data_engine_instances().get(tid)
    assert {"phase_read_io_s", "phase_read_encode_s",
            "phase_layout_s"} <= set(row.runtime_conf)
    api = create_server.QueryAPI(
        create_server.ServerConfig(device="cpu", serve_quant="off",
                                   batching="off"), storage=st)
    try:
        U, V = np.asarray(jm.user_factors), np.asarray(jm.item_factors)
        inv = jm.item_vocab.inverse()
        for user in ("u0", "u7", "u33", "u101"):
            scores = V @ U[jm.user_vocab(user)]
            order = np.argsort(-scores, kind="stable")[:6]
            status, payload = api.handle(
                "POST", "/queries.json",
                body=b'{"user": "%s", "num": 5}' % user.encode())[:2]
            assert status == 200
            got = [s["item"] for s in payload["itemScores"]]
            s = scores[order]
            for j in range(5):
                gaps = [s[j] - s[j + 1]] + ([s[j - 1] - s[j]] if j else [])
                if min(gaps) > 1e-3:
                    assert got[j] == inv(int(order[j])), (user, j)
    finally:
        api.close()


def test_streamed_and_in_core_trains_are_bit_identical(stores, monkeypatch):
    _jst, st = stores
    copies = staging.copies
    monkeypatch.setenv("PIO_TRAIN_STREAM", "on")
    _iid, streamed = _train(st)
    assert staging.copies > copies          # the read staged its chunks
    als_algorithm._BIG_LAYOUT_CACHE.clear()
    monkeypatch.setenv("PIO_TRAIN_STREAM", "off")
    _iid, in_core = _train(st)
    for f in ("user_factors", "item_factors"):
        a, b = np.asarray(getattr(streamed, f)), np.asarray(
            getattr(in_core, f))
        assert a.tobytes() == b.tobytes(), f
    assert streamed.user_vocab.to_dict() == in_core.user_vocab.to_dict()


def test_warm_retrain_hits_the_layout_cache(stores, monkeypatch):
    _jst, st = stores
    monkeypatch.setenv("PIO_ALS_BIG_LAYOUT_MIN", "0")
    stats = als_algorithm.LAYOUT_STATS
    hits, builds = stats["hits"], stats["builds"]
    _iid, first = _train(st)          # auto: streams into an empty cache
    assert (stats["hits"] - hits, stats["builds"] - builds) == (0, 1)
    assert len(als_algorithm._BIG_LAYOUT_CACHE) == 1
    copies = staging.copies
    _iid, second = _train(st)         # auto: in-core, no staging
    assert (stats["hits"] - hits, stats["builds"] - builds) == (1, 1)
    assert staging.copies == copies
    for f in ("user_factors", "item_factors"):
        assert np.asarray(getattr(first, f)).tobytes() == \
            np.asarray(getattr(second, f)).tobytes()


def test_prepare_ratings_takes_device_coo():
    """Tensors in (the staged mirrors) give the device layout their host
    twins give, and the host layout bit for bit."""
    rng = np.random.default_rng(2)
    u = rng.integers(0, 50, 3000).astype(np.int32)
    i = rng.integers(0, 30, 3000).astype(np.int32)
    r = rng.random(3000).astype(np.float32)
    host = als.prepare_ratings(u, i, r, 50, 30)
    for a in (als.prepare_ratings(u, i, r, 50, 30, on_device=True,
                                  device="cpu"), host):
        b = als.prepare_ratings(torch.from_numpy(u), torch.from_numpy(i),
                                torch.from_numpy(r), 50, 30,
                                on_device=True, device="cpu")
        for side in ("by_user", "by_item"):
            for f in ("self_idx", "other_idx", "rating", "counts"):
                x = np.asarray(getattr(getattr(a, side), f))
                y = np.asarray(getattr(getattr(b, side), f))
                assert x.tobytes() == y.tobytes(), (side, f)


def test_write_events_fills_a_sqlite_store_like_the_reference(tmp_path):
    """Without append_encoded (SQLite), write_events inserts the config's
    events in pieces of ``batch``; both packages' stores then read the
    same columns."""
    cols = []
    for synth_mod, storage_cls, app_cls, store_mod, name in (
            (jsynthetic, JStorage, JApp, jstore, "jax"),
            (synthetic, Storage, App, store, "port")):
        storage = storage_cls(env={"PIO_FS_BASEDIR": str(tmp_path / name)})
        app_id = storage.get_meta_data_apps().insert(app_cls(0, APP, None))
        src = synth_mod.chunk_source(2000, seed=6, n_users=50, n_items=40,
                                     chunk=700)
        assert synth_mod.write_events(src, storage, app_id, batch=300) == \
            2000
        cols.append(store_mod.find_columnar(APP, storage=storage, **KW))
    want, got = cols
    assert got.n == 2000
    assert got.entity_ids.to_dict() == want.entity_ids.to_dict()
    for f in COLS + ("event_time_ms",):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
