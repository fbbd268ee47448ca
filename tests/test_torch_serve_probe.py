"""The host-vs-device serving probe (``PIO_SERVE_DEVICE_MS``) of the
port's ``ALSAlgorithm.prepare_serving`` against the JAX package's, on the
CPU, where the "device" is the CPU in both packages.

- The same seeded numpy factors take the host layout at ``0`` and the
  device layout at ``1e9`` in both packages, directly and through a
  deploy.
- On the host layout ``predict`` and ``predict_batch`` answer bit for bit
  what the JAX package's host branch answers (the same numpy gemm in the
  same process, ``host_topk``'s tie rule; the factors sit on a 1/4 grid,
  so ties are many).
- A host layout warms nothing; ``GET /`` adds only ``hostServing`` to the
  JAX package's key set (a device deploy keeps it), the ``lifecycle``
  event carries the serve path at ``warn``, ``POST /reload`` probes
  again, and a tenant's bytes are the JAX package's.
- A probe that raises fails the deploy.
"""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import EngineInstance as JEngineInstance
from predictionio_tpu.data.storage import Model as JModel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSAlgorithm as JALSAlgorithm, ALSAlgorithmParams as JALSAlgorithmParams,
    ALSModel as JALSModel,
)
from predictionio_tpu.models.recommendation.engine import Query as JQuery
from predictionio_tpu.serving import registry as jregistry
from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.engine import Query
from predictionio_tpu_torch.ops import quant
from predictionio_tpu_torch.serving import registry, aot
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import model_io

N_USERS, N_ITEMS, RANK = 300, 200, 6
MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}
ALGOS = json.dumps([{"name": "als", "params": {
    "rank": RANK, "numIterations": 2, "lambda": 0.01, "seed": 3}}])
HOST, DEVICE = "0", "1e9"
#: the JAX package's GET / keys of an fp32 replicated deploy, less the
#: port's ``device``
REF_KEYS = {"status", "engineInstance", "algorithms", "requestCount",
            "avgServingSec", "lastServingSec", "degradedCount", "draining",
            "serverStartTime", "generation", "batching"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("PIO_SERVE_QUANT", "PIO_SERVE_SHARD", "PIO_AOT",
                 "PIO_FOLDIN", "PIO_TORCH_DEVICE", "PIO_SERVE_DEVICE_MS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(journal, "_override", True)
    journal.clear()
    yield
    journal.clear()


def _factors(seed: int = 5):
    """Factors on a 1/4 grid in [-1, 1]: small integer-valued products,
    so many scores tie and the tie rule is exercised."""
    rng = np.random.default_rng(seed)
    U = rng.integers(-4, 5, size=(N_USERS, RANK)).astype(np.float32) / 4
    V = rng.integers(-4, 5, size=(N_ITEMS, RANK)).astype(np.float32) / 4
    return U, V


def _vocabs():
    return ([f"u{i}" for i in range(N_USERS)],
            [f"i{i}" for i in range(N_ITEMS)])


def _jax_model():
    U, V = _factors()
    users, items = _vocabs()
    return JALSModel(rank=RANK, user_factors=U, item_factors=V,
                     user_vocab=JBiMap.string_int(users),
                     item_vocab=JBiMap.string_int(items))


def _port_model():
    U, V = _factors()
    users, items = _vocabs()
    return model_io.als_model_from_numpy(
        RANK, U, V, {u: i for i, u in enumerate(users)},
        {it: i for i, it in enumerate(items)})


def _prepared(threshold, model=None):
    """(reference model, port model) after each package's
    prepare_serving at ``threshold``; ``model`` replaces the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_SERVE_DEVICE_MS", threshold)
        jm = JALSAlgorithm(JALSAlgorithmParams()).prepare_serving(
            _jax_model())
        with quant.deploy_scope("off", device="cpu"):
            tm = ALSAlgorithm(ALSAlgorithmParams()).prepare_serving(
                model if model is not None else _port_model())
    return jm, tm


@pytest.mark.parametrize("threshold", [HOST, DEVICE])
def test_the_layout_follows_the_threshold_in_both_packages(threshold):
    jm, tm = _prepared(threshold)
    host = threshold == HOST
    assert isinstance(jm.user_factors, np.ndarray) is host
    assert isinstance(tm.user_factors, np.ndarray) is host
    assert isinstance(tm.item_factors, np.ndarray) is host
    probe = tm.serve_probe
    assert probe["servePath"] == ("host" if host else "device")
    assert probe["thresholdMs"] == float(threshold)
    assert probe["probeMs"] >= 0.0 and probe["device"] == "cpu"
    assert tm.quant is None and tm.sharding is None
    np.testing.assert_array_equal(np.asarray(tm.user_factors),
                                  np.asarray(jm.user_factors))


def test_the_host_layout_keeps_the_given_arrays():
    """Contiguous fp32 factors stay the very arrays (the fold-in worker's
    host mirrors are the serving arrays); no factor copy is kept."""
    m = _port_model()
    U, V = m.user_factors, m.item_factors
    _jm, tm = _prepared(HOST, m)
    assert tm.user_factors is U and tm.item_factors is V


NUMS = (1, 3, 10, N_ITEMS, N_ITEMS + 7, 0, -2)


def test_host_predict_is_the_references_host_branch_bit_for_bit():
    jm, tm = _prepared(HOST)
    jalgo = JALSAlgorithm(JALSAlgorithmParams())
    talgo = ALSAlgorithm(ALSAlgorithmParams())
    rng = np.random.default_rng(8)
    users = [f"u{u}" for u in rng.choice(N_USERS, 40, replace=False)]
    for user in users + ["nobody"]:
        for num in NUMS:
            want = jalgo.predict(jm, JQuery(user=user, num=num))
            got = talgo.predict(tm, Query(user=user, num=num))
            assert [(s.item, s.score) for s in got.itemScores] == [
                (s.item, s.score) for s in want.itemScores], (user, num)
    assert any(len(talgo.predict(tm, Query(user=u, num=10)).itemScores)
               == 10 for u in users)


def test_host_predict_batch_is_the_references_host_branch_bit_for_bit():
    jm, tm = _prepared(HOST)
    jalgo = JALSAlgorithm(JALSAlgorithmParams())
    talgo = ALSAlgorithm(ALSAlgorithmParams())
    rng = np.random.default_rng(9)
    for size in (1, 4, 16, 33):
        picks = rng.integers(0, N_USERS, size)
        nums = [NUMS[i % len(NUMS)] for i in range(size)]
        qs = [(f"u{u}" if i % 7 else "nobody", n)
              for i, (u, n) in enumerate(zip(picks, nums))]
        want = jalgo.predict_batch(jm, [JQuery(user=u, num=n)
                                        for u, n in qs])
        got = talgo.predict_batch(tm, [Query(user=u, num=n) for u, n in qs])
        for w, g, q in zip(want, got, qs):
            assert [(s.item, s.score) for s in g.itemScores] == [
                (s.item, s.score) for s in w.itemScores], q
        # a batch row is the inline answer
        for g, (u, n) in zip(got, qs):
            one = talgo.predict(tm, Query(user=u, num=n))
            assert g.itemScores == one.itemScores


def test_a_host_layout_warms_nothing():
    jm, tm = _prepared(HOST)
    buckets = (1, 4, 16, 64)
    assert list(JALSAlgorithm(JALSAlgorithmParams()).aot_serving_programs(
        jm, buckets)) == []
    assert aot.algorithm_programs(ALSAlgorithm(ALSAlgorithmParams()), tm,
                                  buckets) == []
    _jm, dm = _prepared(DEVICE)
    programs = aot.algorithm_programs(ALSAlgorithm(ALSAlgorithmParams()),
                                      dm, buckets)
    assert [p.name for p in programs] == ["topk_for_users"] * 4 + [
        "topk_for_user"]


def _blob():
    return jmodel_io.serialize_models([_jax_model()])


def _instance(cls, factory):
    now = dt.datetime(2024, 5, 6, tzinfo=dt.timezone.utc)
    return cls(id="", status="COMPLETED", start_time=now, end_time=now,
               engine_id="default", engine_version="NOT_USED",
               engine_variant="default", engine_factory=factory,
               data_source_params=json.dumps({"params": {
                   "appName": "ProbeApp"}}),
               algorithms_params=ALGOS)


def _deploy_both(**cfg):
    """(reference QueryAPI, port QueryAPI, port store) serving the same
    blob in fp32 on the CPU; the caller closes both."""
    js = JStorage(env=MEM)
    jid = js.get_meta_data_engine_instances().insert(_instance(
        JEngineInstance, "predictionio_tpu.models.recommendation.engine:"
        "RecommendationEngine"))
    js.get_model_data_models().insert(JModel(jid, _blob()))
    ts = Storage(env=MEM)
    tid = ts.get_meta_data_engine_instances().insert(_instance(
        EngineInstance, "predictionio_tpu_torch.models.recommendation."
        "engine:RecommendationEngine"))
    ts.get_model_data_models().insert(Model(tid, _blob()))
    japi = jserver.QueryAPI(storage=js, config=jserver.ServerConfig(
        **{"aot": "off", **cfg}))
    tapi = tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
        device="cpu", **cfg))
    return japi, tapi, ts


def _lifecycle():
    return [e for e in journal.snapshot(category="lifecycle")["events"]
            if "live" in e["message"]]


@pytest.mark.parametrize("threshold", [HOST, DEVICE])
def test_a_deploy_shows_its_serve_path(monkeypatch, threshold):
    """GET / adds only ``hostServing`` for a host deploy; the load's
    lifecycle event carries the path, at warn on the host; the answers
    through both servers are the same bytes."""
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", threshold)
    host = threshold == HOST
    japi, tapi, _ts = _deploy_both(batching="on", batch_max_delay_ms=1.0)
    try:
        jkeys = set(japi.handle("GET", "/")[1])
        status = tapi.handle("GET", "/")[1]
        assert jkeys == REF_KEYS
        assert set(status) == jkeys | {"device"} | (
            {"hostServing"} if host else set())
        assert isinstance(japi.models[0].user_factors, np.ndarray) is host
        assert isinstance(tapi.models[0].user_factors, np.ndarray) is host
        if host:
            hs = status["hostServing"]
            assert set(hs) == {"probeMs", "thresholdMs", "device"}
            assert hs["thresholdMs"] == 0.0 and hs["device"] == "cpu"
            assert hs["probeMs"] > 0.0
        (event,) = _lifecycle()
        assert event["level"] == ("warn" if host else "info")
        f = event["fields"]
        assert f["servePath"] == ("host" if host else "device")
        assert f["thresholdMs"] == float(threshold) and f["probeMs"] >= 0.0
        assert ("served from the host" in event["message"]) is host
        for user, num in (("u3", 4), ("u0", 10), ("u299", N_ITEMS + 1),
                          ("nobody", 4), ("u7", 0)):
            body = json.dumps({"user": user, "num": num}).encode()
            want = japi.handle("POST", "/queries.json", body=body)
            got = tapi.handle("POST", "/queries.json", body=body)
            assert got[0] == want[0] == 200
            assert got[1] == want[1], (user, num)
    finally:
        japi.close()
        tapi.close()


def test_the_warm_up_is_empty_on_the_host(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", HOST)
    _japi, tapi, _ts = _deploy_both(batching="on", aot="on")
    _japi.close()
    try:
        status = tapi.handle("GET", "/")[1]
        assert status["aot"]["programs"] == 0
        assert "hostServing" in status
        body = json.dumps({"user": "u1", "num": 5}).encode()
        assert tapi.handle("POST", "/queries.json", body=body)[0] == 200
    finally:
        tapi.close()


def test_a_reload_probes_again(monkeypatch):
    """A host generation reloads onto the device when the threshold
    changes: the block goes, the new lifecycle event says device."""
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", HOST)
    japi, tapi, _ts = _deploy_both(batching="off")
    japi.close()
    try:
        assert "hostServing" in tapi.handle("GET", "/")[1]
        gen = tapi.generation
        monkeypatch.delenv("PIO_SERVE_DEVICE_MS")
        monkeypatch.setenv("PIO_SERVE_DEVICE_MS", DEVICE)
        tapi._reload()
        status = tapi.handle("GET", "/")[1]
        assert tapi.generation == gen + 1
        assert "hostServing" not in status
        assert not isinstance(tapi.models[0].user_factors, np.ndarray)
        first, second = _lifecycle()
        assert (first["level"], first["fields"]["servePath"]) == (
            "warn", "host")
        assert (second["level"], second["fields"]["servePath"]) == (
            "info", "device")
        assert second["fields"]["reload"] is True
    finally:
        tapi.close()


def test_a_host_tenant_counts_the_references_bytes(monkeypatch):
    """A host-served tenant places no factor bytes on the card: it counts
    its host arrays, as the JAX package counts them; its block and its
    tenant event show the host path."""
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", HOST)
    jm, tm = _prepared(HOST)
    assert registry.model_hbm_bytes([tm]) == jregistry.model_hbm_bytes(
        [jm]) == 4 * RANK * (N_USERS + N_ITEMS)
    ts = Storage(env=MEM)
    tid = ts.get_meta_data_engine_instances().insert(_instance(
        EngineInstance, "predictionio_tpu_torch.models.recommendation."
        "engine:RecommendationEngine"))
    ts.get_model_data_models().insert(Model(tid, _blob()))
    api = tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
        device="cpu", tenants=(registry.TenantSpec(
            name="t", engine_instance_id=tid),)))
    try:
        block = api.handle("GET", "/")[1]["tenants"]["t"]
        assert block["modelBytes"] == registry.model_hbm_bytes([tm])
        assert block["hostServing"]["thresholdMs"] == 0.0
        (event,) = [e for e in journal.snapshot(category="tenant")[
            "events"] if "live" in e["message"]]
        assert event["level"] == "warn"
        assert event["fields"]["servePath"] == "host"
    finally:
        api.close()


def test_a_probe_that_raises_fails_the_deploy(monkeypatch):
    """The JAX package turns a failed probe into an infinite time and a
    host layout; the port fails the deploy."""
    def boom(*_a, **_k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(als_algorithm.topk, "topk_for_user", boom)
    for threshold in (HOST, DEVICE):
        monkeypatch.setenv("PIO_SERVE_DEVICE_MS", threshold)
        with quant.deploy_scope("off", device="cpu"):
            with pytest.raises(RuntimeError, match="launch failed"):
                ALSAlgorithm(ALSAlgorithmParams()).prepare_serving(
                    _port_model())
        ts = Storage(env=MEM)
        tid = ts.get_meta_data_engine_instances().insert(_instance(
            EngineInstance, "predictionio_tpu_torch.models."
            "recommendation.engine:RecommendationEngine"))
        ts.get_model_data_models().insert(Model(tid, _blob()))
        with pytest.raises(RuntimeError, match="launch failed"):
            tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
                device="cpu"))


def test_a_threshold_that_is_not_a_number_fails_the_deploy(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", "fast")
    with quant.deploy_scope("off", device="cpu"):
        with pytest.raises(ValueError):
            ALSAlgorithm(ALSAlgorithmParams()).prepare_serving(
                _port_model())
    with pytest.raises(ValueError):
        JALSAlgorithm(JALSAlgorithmParams()).prepare_serving(_jax_model())


def test_quantized_and_sharded_layouts_run_no_probe(monkeypatch):
    """The probe applies to fp32 replicated serving only: at 0 a
    quantized layout stays on the device and shows no host block."""
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", HOST)
    with quant.deploy_scope("on", device="cpu"):
        tm = ALSAlgorithm(ALSAlgorithmParams()).prepare_serving(
            _port_model())
    assert tm.quant is not None and tm.serve_probe is None
