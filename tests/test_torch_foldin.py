"""The port's realtime fold-in (``predictionio_tpu_torch/realtime/foldin.py``)
and its quantized publication (``ops/quant.py``) against the JAX
package's, on the CPU.

- ``foldin_solve`` at the buckets 1 / 8 / 64 (256 slots a row) on seeded
  inputs: within rtol 1e-4 / atol 1e-5, the fp32 tolerance class (the
  Gram sums in another order than XLA's); on a dyadic grid, where every
  Gram entry is exact, the pad rows and the regularization floor to the
  bit.
- The quantized scatters, ``QuantizedServing.apply_*_rows``,
  ``scatter_user_rows`` and ``pad_capacity``: exact (int8 tables, scales
  and padded matrices bit-equal).
- One worker per package over the same store contents (memory, SQLite,
  eventlog), driven by hand (``tick()``, no thread, no sleep): ratings of
  unseen users, trained users and unseen items give the same vocabularies,
  rows within the tolerance, equal top-k answers wherever the score gaps
  exceed it, and equal cursor files; a worker of the port resumes the JAX
  package's cursor file without skipping or double-counting; the drift
  probe is clean on a true row and fails on a corrupted one, on the
  device fp32 layout and, in both packages, on the host layout that
  ``PIO_SERVE_DEVICE_MS=0`` chooses (the JAX package's own trick for
  writing a published row in place), users and items alike.
"""

import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithm as JALSAlgorithm,
)
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithmParams as JALSAlgorithmParams,
)
from predictionio_tpu.models.recommendation.engine import Query as JQuery
from predictionio_tpu.ops import quant as jquant
from predictionio_tpu.realtime import foldin as jfoldin
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.common import devicewatch, journal
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.engine import Query
from predictionio_tpu_torch.ops import quant
from predictionio_tpu_torch.realtime import foldin
from predictionio_tpu_torch.workflow import model_io

import torch_deploy_util as util

RTOL, ATOL = 1e-4, 1e-5
APP = "FoldApp"
LAM = 0.05


def _solve_inputs(rng, bucket, me, rank, n_users, dyadic):
    n_items = 50
    if dyadic:
        V = rng.integers(-8, 9, size=(n_items, rank)).astype(np.float32) / 8
    else:
        V = rng.normal(size=(n_items, rank)).astype(np.float32)
    nnz_pad = bucket * me
    item_rows = np.zeros((nnz_pad, rank), np.float32)
    self_idx = np.full((nnz_pad,), bucket, np.int32)
    rating = np.zeros((nnz_pad,), np.float32)
    counts = np.zeros((bucket,), np.int32)
    pos = 0
    for j in range(n_users):
        n = int(rng.integers(1, me + 1))
        counts[j] = n
        items = rng.integers(0, n_items, size=n)
        item_rows[pos:pos + n] = V[items]
        self_idx[pos:pos + n] = j
        rating[pos:pos + n] = rng.integers(1, 11, size=n) / 2
        pos += n
    return item_rows, self_idx, rating, counts


def _both_solves(inputs, bucket, lam):
    item_rows, self_idx, rating, counts = inputs
    nnz_pad = item_rows.shape[0]
    want = np.asarray(jfoldin.foldin_solve(
        item_rows, self_idx, rating, counts, np.float32(lam),
        n_self=bucket, chunk=nnz_pad))
    got = foldin.foldin_solve(
        torch.from_numpy(item_rows), torch.from_numpy(self_idx).long(),
        torch.from_numpy(rating), torch.from_numpy(counts), lam,
        n_self=bucket, chunk=nnz_pad).numpy()
    return want, got


@pytest.mark.parametrize("bucket,n_users", [(1, 1), (8, 5), (64, 64)])
def test_foldin_solve_matches_the_reference(bucket, n_users):
    rng = np.random.default_rng(bucket)
    want, got = _both_solves(
        _solve_inputs(rng, bucket, 256, 10, n_users, dyadic=False),
        bucket, LAM)
    assert got.shape == want.shape == (bucket, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_foldin_solve_pad_rows_and_floor_on_a_dyadic_grid():
    """Exact Gram sums: the pad rows solve to exact zeros (zero Gram, one
    rating's lambda as the floor), and so does a user whose ratings are
    all 0."""
    rng = np.random.default_rng(3)
    item_rows, self_idx, rating, counts = _solve_inputs(
        rng, 8, 16, 4, 3, dyadic=True)
    rating[self_idx == 2] = 0.0            # a rated-zero user
    want, got = _both_solves((item_rows, self_idx, rating, counts), 8, 0.5)
    assert not got[3:].any() and not want[3:].any()
    assert not got[2].any() and not want[2].any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# publication: exact
# ---------------------------------------------------------------------------

def _factors(rng, n, rank=6):
    return rng.normal(size=(n, rank)).astype(np.float32)


def test_quantized_scatters_and_apply_rows_are_exact(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED_TILE", "128")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    rng = np.random.default_rng(5)
    U, V = _factors(rng, 40), _factors(rng, 300)
    jqf = jquant.QuantizedFactors.from_factors(U, V)
    qf = quant.QuantizedFactors.from_factors(U, V)
    jqs = jquant.QuantizedServing.build(jqf)
    qs = quant.QuantizedServing.build(qf, device="cpu")
    ixs = np.asarray([3, 39, 0, 17], np.int32)
    rows = _factors(rng, 4)
    q_rows, scales = quant.quantize_rows(rows)
    jq, js = jquant.scatter_user_rows_quant(
        jqs.u_q, jqs.u_scale, ixs, q_rows, scales)
    tq, ts = quant.scatter_user_rows_quant(
        qs.u_q, qs.u_scale, torch.from_numpy(ixs), torch.from_numpy(q_rows),
        torch.from_numpy(scales))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    item_ixs = np.asarray([299, 0, 120], np.int32)
    item_rows = _factors(rng, 3)
    iq, iscales = quant.quantize_rows(item_rows)
    jv, jvs = jquant.scatter_item_cols_quant(
        jqs.vt_q, jqs.v_scale, item_ixs, iq, iscales)
    tv, tvs = quant.scatter_item_cols_quant(
        qs.vt_q, qs.v_scale, torch.from_numpy(item_ixs),
        torch.from_numpy(iq), torch.from_numpy(iscales))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    # apply_*_rows: the touched rows re-quantized, a NEW layout each time
    japplied = jqs.apply_user_rows(ixs, rows).apply_item_rows(item_ixs,
                                                              item_rows)
    applied = qs.apply_user_rows(ixs, rows).apply_item_rows(item_ixs,
                                                            item_rows)
    for f in ("u_q", "u_scale", "vt_q", "v_scale"):
        np.testing.assert_array_equal(getattr(applied, f).numpy(),
                                      np.asarray(getattr(japplied, f)), f)
    assert applied is not qs and qs.u_q[3].tolist() == qf.u_q[3].tolist()


def test_scatter_user_rows_and_pad_capacity_are_exact():
    rng = np.random.default_rng(6)
    U, rows = _factors(rng, 20), _factors(rng, 3)
    ixs = np.asarray([19, 2, 7], np.int32)
    want = np.asarray(jfoldin.scatter_user_rows(U, ixs, rows))
    got = foldin.scatter_user_rows(torch.from_numpy(U),
                                   torch.from_numpy(ixs),
                                   torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(U[ixs], rows)       # the input is untouched
    (jm,) = jmodel_io.deserialize_models(util.dyadic_blob())
    (tm,) = model_io.deserialize_models(util.dyadic_blob())
    algos = [JALSAlgorithm(JALSAlgorithmParams(lambda_=0.25))]
    jprep = jfoldin.pad_capacity([jm], 7, algos, item_headroom=5)
    prep = foldin.pad_capacity(
        [tm], 7, [ALSAlgorithm(ALSAlgorithmParams(lambda_=0.25))],
        item_headroom=5)
    for key in ("user_factors", "item_factors"):
        assert prep[key].shape == jprep[key].shape
        np.testing.assert_array_equal(prep[key], jprep[key])
    assert {k: v for k, v in prep.items() if not k.endswith("factors")} \
        == {k: v for k, v in jprep.items() if not k.endswith("factors")}
    assert tm.user_factors is prep["user_factors"]
    assert tm.item_factors is prep["item_factors"]


# ---------------------------------------------------------------------------
# one hand-driven worker per package over the same store contents
# ---------------------------------------------------------------------------

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)


def _events(cls, dm, batch: int):
    """Seeded rate events of one batch: unseen users, trained users and,
    in the first batch, two unseen items rated by trained users."""
    rng = np.random.default_rng(100 + batch)
    out = []

    def rate(u, i, r, k):
        out.append(cls(event="rate", entity_type="user", entity_id=u,
                       target_entity_type="item", target_entity_id=i,
                       properties=dm({"rating": float(r)}),
                       event_time=T0 + dt.timedelta(minutes=100 * batch
                                                    + k)))

    k = 0
    if batch == 0:
        for it in ("new_i0", "new_i1"):
            for u in rng.choice(util.N_USERS, size=5, replace=False):
                rate(f"u{u}", it, rng.integers(1, 11) / 2, k)
                k += 1
    names = ([f"new_u{batch}_{j}" for j in range(3)]
             + [f"u{u}" for u in rng.choice(util.N_USERS, size=2,
                                            replace=False)])
    for name in names:
        for i in rng.choice(util.N_ITEMS, size=6, replace=False):
            rate(name, f"i{i}", rng.integers(1, 11) / 2, k)
            k += 1
        if batch == 0:
            rate(name, "new_i0", 4.5, k)   # the new item, once folded
            k += 1
    return out


def _stores(kind, tmp_path):
    if kind == "memory":
        return JStorage(env=util.MEM), Storage(env=util.MEM)
    if kind == "sqlite":
        return (JStorage(env={"PIO_FS_BASEDIR": str(tmp_path / "jsql")}),
                Storage(env={"PIO_FS_BASEDIR": str(tmp_path / "tsql")}))

    def env(name):
        return {"PIO_STORAGE_SOURCES_M_TYPE": "memory",
                "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / name),
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}
    return JStorage(env=env("jel")), Storage(env=env("tel"))


class _Side:
    """One package's store, model and worker."""

    def __init__(self, port: bool, storage, cursor_dir, quantized=True,
                 written=()):
        """``written``: the event batches in the store before the worker
        starts."""
        self.port, self.storage = port, storage
        self.quantized = quantized
        app_cls = App if port else JApp
        app_id = storage.get_meta_data_apps().insert(app_cls(0, APP, None))
        storage.get_events().init(app_id)
        self.app_id = app_id
        self.cursor_dir = cursor_dir
        for batch in written:
            self.write(batch)
        self.worker = self.bind()

    def bind(self, worker=None):
        mod, io = (foldin, model_io) if self.port else (jfoldin, jmodel_io)
        if self.port:
            algo = ALSAlgorithm(ALSAlgorithmParams(lambda_=LAM))
        else:
            algo = JALSAlgorithm(JALSAlgorithmParams(lambda_=LAM))
        (model,) = io.deserialize_models(util.dyadic_blob())
        prep = mod.pad_capacity([model], 8, [algo], item_headroom=4)
        if self.port:
            with quant.deploy_scope("on" if self.quantized else "off",
                                    device="cpu"):
                model = algo.prepare_serving(model)
        else:
            model = algo.prepare_serving(model)
        if self.quantized:
            assert model.quant is not None and \
                model.user_factors is prep["user_factors"]
        cfg = mod.FoldinConfig(app_name=APP, lambda_=LAM)
        if worker is None:
            kw = {"device": "cpu"} if self.port else {}
            worker = mod.FoldinWorker(self.storage, cfg,
                                      cursor_directory=self.cursor_dir,
                                      **kw)
        worker.bind(model, generation=1, prep=prep)
        self.model, self.algo = model, algo
        return worker

    def write(self, batch: int):
        cls, dm = (Event, DataMap) if self.port else (JEvent, JDataMap)
        self.storage.get_events().insert_batch(_events(cls, dm, batch),
                                               self.app_id)

    def answer(self, user: str, num: int = 8):
        q = (Query if self.port else JQuery)(user=user, num=num)
        return [(s.item, s.score) for s in
                self.algo.predict(self.model, q).itemScores]

    def cursor_file(self) -> dict:
        with open(self.worker._store.path) as f:
            return json.load(f)


@pytest.fixture
def fold_env(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    monkeypatch.setenv("PIO_FOLDIN_USER_BUCKETS", "1,8")
    monkeypatch.setenv("PIO_FOLDIN_MAX_EVENTS", "16")
    monkeypatch.setenv("PIO_FOLDIN_DRIFT_EVERY", "0")
    yield
    devicewatch.note_foldin(None)


def _assert_sides_agree(ref: _Side, port: _Side):
    jm, tm = ref.model, port.model
    assert tm.user_vocab.to_dict() == jm.user_vocab.to_dict()
    assert tm.item_vocab.to_dict() == jm.item_vocab.to_dict()
    np.testing.assert_allclose(port.worker._user_factors,
                               ref.worker._user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.worker._item_factors,
                               ref.worker._item_factors,
                               rtol=RTOL, atol=ATOL)
    # the answers: equal wherever the scores of neighbours are further
    # apart than the rows' tolerance allows them to move
    for user in [u for u in jm.user_vocab.to_dict()
                 if u.startswith("new_")] + ["u1", "u7"]:
        want, got = ref.answer(user), port.answer(user)
        assert len(got) == len(want)
        scores = [s for _i, s in want]
        for j, ((wi, ws), (gi, gs)) in enumerate(zip(want, got)):
            assert abs(gs - ws) <= 1e-3 * max(1.0, abs(ws)), (user, j)
            gaps = [abs(scores[j] - scores[n]) for n in (j - 1, j + 1)
                    if 0 <= n < len(scores)]
            if min(gaps) > 1e-2:
                assert gi == wi, (user, j)


@pytest.mark.parametrize("kind", ["memory", "sqlite", "eventlog"])
def test_hand_driven_workers_agree_across_packages(kind, tmp_path,
                                                   fold_env):
    jstorage, tstorage = _stores(kind, tmp_path)
    ref = _Side(False, jstorage, str(tmp_path / "jcur"))
    port = _Side(True, tstorage, str(tmp_path / "tcur"))
    for side in (ref, port):
        side.write(0)
    jsum, tsum = ref.worker.tick(), port.worker.tick()
    assert tsum == jsum
    # three unseen users appended; the trained users who rated (the new
    # items' raters too) folded in place; the two unseen items appended
    assert tsum["appended"] == 3 and tsum["folded"] >= 2
    assert tsum["itemsAppended"] == 2
    assert port.cursor_file() == ref.cursor_file()
    _assert_sides_agree(ref, port)
    new_user = port.answer("new_u0_1")
    assert new_user and len(new_user) == 8        # personalized, not empty
    # a quiet tick consumes nothing and changes nothing
    assert port.worker.tick() == ref.worker.tick()
    assert port.cursor_file() == ref.cursor_file()
    # the published int8 rows are quantize_rows of the folded rows
    ix = port.model.user_vocab("new_u0_0")
    q, s = quant.quantize_rows(port.worker._user_factors[ix:ix + 1])
    np.testing.assert_array_equal(port.model.quant.u_q[ix].numpy(), q[0])
    assert port.model.quant.u_scale[ix].item() == s[0]
    # the second batch: three more unseen users and two trained ones
    for side in (ref, port):
        side.write(1)
    assert port.worker.tick() == ref.worker.tick()
    assert port.cursor_file() == ref.cursor_file()
    _assert_sides_agree(ref, port)
    assert port.worker.state()["usersFolded"] == \
        ref.worker.state()["usersFolded"] == len(
            {e.entity_id for b in (0, 1) for e in _events(Event, DataMap, b)})


def test_port_resumes_the_reference_cursor_file(tmp_path, fold_env):
    """A worker of the JAX package folds one batch and stops; a worker of
    the port starts from its cursor file on a freshly loaded model,
    re-folds every user the file names, and reads only the events after
    the cursor: nothing skipped, nothing counted twice."""
    jstorage, tstorage = _stores("sqlite", tmp_path)
    cur = str(tmp_path / "cur")
    ref = _Side(False, jstorage, cur)
    ref.write(0)
    ref.worker.tick()
    saved = ref.cursor_file()
    # the port's store holds the same events; its worker reads the file
    port = _Side(True, tstorage, cur, written=(0,))
    assert port.worker._cursor == saved["cursor"]
    assert set(port.worker._pending) == set(saved["folded"])
    for side in (ref, port):
        side.write(1)
    jsum, tsum = ref.worker.tick(), port.worker.tick()
    assert tsum["events"] == jsum["events"] == len(_events(Event, DataMap,
                                                           1))
    assert port.worker.state()["usersFolded"] == \
        ref.worker.state()["usersFolded"]
    assert port.model.user_vocab.to_dict().keys() == \
        ref.model.user_vocab.to_dict().keys()
    for user in ("new_u0_0", "new_u1_2", "u1"):
        if user not in ref.model.user_vocab.to_dict():
            continue
        jrow = ref.worker._user_factors[ref.model.user_vocab(user)]
        trow = port.worker._user_factors[port.model.user_vocab(user)]
        np.testing.assert_allclose(trow, jrow, rtol=RTOL, atol=ATOL)


def test_drift_probe_clean_then_red_on_a_corrupted_row(tmp_path, fold_env,
                                                       monkeypatch):
    """On the device-fp32 layout a published row IS the fresh half-step:
    recall 1.0; negated rows rank the catalog backwards and fail."""
    monkeypatch.setenv("PIO_SERVE_QUANT", "off")
    # the device layout whatever the probe measures
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", "1e9")
    journal.clear()
    port = _Side(True, Storage(env=util.MEM), str(tmp_path / "cur"),
                 quantized=False)
    port.write(0)
    port.worker.tick()
    port.worker._drift_probe()
    st = port.worker.state()
    assert st["drift"]["ok"] and st["drift"]["recall"] == 1.0
    # corrupt the published rows of the probe's users: negated factors
    # rank the catalog backwards
    m = port.model
    assert isinstance(m.user_factors, torch.Tensor) and m.quant is None
    ixs = torch.tensor([m.user_vocab(u) for u in port.worker._recent])
    m.user_factors = foldin.scatter_user_rows(
        m.user_factors, ixs, -m.user_factors[ixs])
    port.worker._drift_probe()
    st = port.worker.state()
    assert st["drift"]["ok"] is False and st["drift"]["recall"] < 0.99
    warns = [e for e in journal.snapshot(level="warn")["events"]
             if e["category"] == "foldin"]
    assert any("drift probe FAILED" in e["message"] for e in warns)


def _new_item_events(cls, dm):
    """Trained users of one parity rate an unseen item highly (the JAX
    package's ``_rate_new_item``): its row is solved against user rows
    the tick leaves as they were."""
    return [cls(event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id="idrift",
                properties=dm({"rating": 5.0}),
                event_time=T0 + dt.timedelta(days=30, minutes=u))
            for u in range(0, 8, 2)]


def _host_sides(tmp_path, monkeypatch, items_only=False):
    """One fp32 side per package on the host layout, batch 0 (or, with
    ``items_only``, one unseen item rated by trained users) folded."""
    monkeypatch.setenv("PIO_SERVE_QUANT", "off")
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", "0")
    jstorage, tstorage = _stores("memory", tmp_path)
    ref = _Side(False, jstorage, str(tmp_path / "jcur"), quantized=False)
    port = _Side(True, tstorage, str(tmp_path / "tcur"), quantized=False)
    for side in (ref, port):
        # the host layout serves the worker's own mirrors
        assert isinstance(side.model.user_factors, np.ndarray)
        assert side.model.user_factors is side.worker._user_factors
        if items_only:
            cls, dm = (Event, DataMap) if side.port else (JEvent, JDataMap)
            side.storage.get_events().insert_batch(
                _new_item_events(cls, dm), side.app_id)
        else:
            side.write(0)
    assert port.model.serve_probe["servePath"] == "host"
    tsum, jsum = port.worker.tick(), ref.worker.tick()
    assert tsum == jsum and tsum["itemsAppended"] >= 1
    _assert_sides_agree(ref, port)
    return ref, port


def test_drift_probe_on_the_host_layout(tmp_path, fold_env, monkeypatch):
    """The counterpart of the JAX package's
    ``test_drift_probe_clean_and_corrupted`` (``tests/test_foldin.py``):
    folded rows land in the host arrays in place; the probe is clean,
    then a row negated in place fails it, in both packages."""
    ref, port = _host_sides(tmp_path, monkeypatch)
    journal.clear()
    for side in (ref, port):
        side.worker._drift_probe()
        st = side.worker.state()
        assert st["drift"]["ok"] and st["drift"]["recall"] == 1.0
    for side in (ref, port):
        m = side.model
        for user in list(side.worker._recent):
            ix = m.user_vocab.get(user)
            m.user_factors[ix] = -m.user_factors[ix]
        side.worker._drift_probe()
    jst, tst = ref.worker.state(), port.worker.state()
    assert tst["drift"]["ok"] is jst["drift"]["ok"] is False
    assert tst["drift"]["recall"] < 0.99
    warns = [e for e in journal.snapshot(level="warn")["events"]
             if e["category"] == "foldin"]
    assert any("drift probe FAILED" in e["message"] for e in warns)


def test_item_drift_probe_on_the_host_layout(tmp_path, fold_env,
                                             monkeypatch):
    """The counterpart of ``test_item_drift_probe_clean_and_corrupted``:
    the folded items' rows sit in the host item array (which is the
    worker's mirror); clean, then negated in place, fails."""
    ref, port = _host_sides(tmp_path, monkeypatch, items_only=True)
    assert port.model.item_factors is port.worker._item_factors
    journal.clear()
    for side in (ref, port):
        side.worker._item_drift_probe()
        st = side.worker.state()
        assert st["itemDrift"]["ok"] and st["itemDrift"]["recall"] == 1.0
    for side in (ref, port):
        m = side.model
        for item in list(side.worker._recent_items):
            ix = int(m.item_vocab.get(item))
            m.item_factors[ix] = -m.item_factors[ix]
            side.worker._item_factors[ix] = np.array(m.item_factors[ix])
        side.worker._item_drift_probe()
    jst, tst = ref.worker.state(), port.worker.state()
    assert tst["itemDrift"]["ok"] is jst["itemDrift"]["ok"] is False
    warns = [e for e in journal.snapshot(level="warn")["events"]
             if e["category"] == "foldin"]
    assert any("ITEM drift" in e["message"] for e in warns)


def test_host_layout_answers_follow_the_fold(tmp_path, fold_env,
                                            monkeypatch):
    """A folded user's answer on the host layout is the host branch over
    the folded row, equal to the JAX package's wherever the gaps allow
    (``_assert_sides_agree``), and an unseen user gets a full answer."""
    ref, port = _host_sides(tmp_path, monkeypatch)
    got = port.answer("new_u0_1")
    assert len(got) == 8
    m = port.model
    ix = m.user_vocab("new_u0_1")
    scores = m.item_factors @ m.user_factors[ix]
    n_real = len(m.item_vocab)
    inv = m.item_vocab.inverse()
    want = [(inv(int(i)), float(scores[i]))
            for i in np.argsort(-scores, kind="stable") if i < n_real][:8]
    assert [s for _i, s in got] == [s for _i, s in want]
