"""Multi-tenant deploys on the port (``serving/registry.py`` and
``pio deploy --engines``) against the reference: the ``--engines`` conf
parsed and refused alike, ``model_hbm_bytes`` equal to the reference's on
the same factors (and on a prepared int8 model, the bytes its device
tensors hold, never its host copy too), the registry's generations, soft
budget and hard cap alike, 401 / 429 admission on the wire, the soft
budget flagged, the hard cap refused before the refused tenant's layout
is placed, one tenant's saturation leaving the other serving, the
warm-up flat across tenants, and the single-engine wire unchanged."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.serving import registry as ref_registry
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage import AccessKey, App, Storage
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSModel,
)
from predictionio_tpu_torch.ops import quant
from predictionio_tpu_torch.serving import registry
from predictionio_tpu_torch.serving.registry import TenantSpec

import torch_fleet_util as fleet

PACKAGES = {"port": registry, "ref": ref_registry}
MIB = 1024 * 1024


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    for name in ("PIO_TENANT_RATE", "PIO_TENANT_BURST",
                 "PIO_TENANT_HBM_BUDGET_MB", "PIO_TENANT_HBM_HARD_CAP_MB",
                 "PIO_TELEMETRY"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def two_apps():
    """One port store with two apps, each with its access key and a
    COMPLETED instance of its own model (different answers)."""
    storage = Storage(env=fleet.util.MEM)
    ids = {}
    for name, seed in (("a", 1), ("b", 2)):
        app_id = storage.get_meta_data_apps().insert(
            App(0, f"Tenant{name.upper()}", None))
        storage.get_meta_data_access_keys().insert(
            AccessKey(f"key-{name}", app_id, ()))
        ids[name] = fleet.add_instance(
            storage, fleet.tied_blob(seed=seed), engine_id=f"eng-{name}",
            app=f"Tenant{name.upper()}")
    return storage, ids


def _specs(ids, **overrides):
    return tuple(TenantSpec(name=n, access_key=f"key-{n}",
                            engine_instance_id=iid, **overrides.get(n, {}))
                 for n, iid in ids.items())


def _deploy(storage, ids, **cfg):
    return fleet.query_api(storage, tenants=_specs(
        ids, **cfg.pop("overrides", {})), **cfg)


def _ask(api, user, key=None, num=3):
    r = api.handle("POST", "/queries.json",
                   query={"accessKey": key} if key else None,
                   body=fleet.util.query(user, num))
    return r[0], r[1], (r[2] if len(r) == 3 else {})


# --------------------------------------------------------------- the conf
GOOD_CONFS = [
    [{"name": "a"}, {"name": "b"}],
    {"tenants": [{"name": "a", "accessKey": "k", "batchMaxQueue": 8,
                  "hbmBudgetMb": 128, "rate": 10, "burst": 20}]},
    [{"name": " spaced ", "engineId": "e", "engineInstanceId": "i",
      "batching": "off", "batchMaxDelayMs": 0.5}],
]
BAD_CONFS = [
    [], {"tenants": {}}, ["x"], [{"name": "a", "hbmBudget": 1}],
    [{"name": ""}], [{"accessKey": "k"}], [{"name": "a"}, {"name": "a"}],
    [{"name": "a", "accessKey": "k"}, {"name": "b", "accessKey": "k"}],
]


@pytest.mark.parametrize("conf", GOOD_CONFS + BAD_CONFS)
def test_the_engines_conf_parses_as_the_reference(tmp_path, conf):
    path = tmp_path / "engines.json"
    path.write_text(json.dumps(conf))
    try:
        want = ref_registry.load_engines_conf(str(path))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            registry.load_engines_conf(str(path))
        assert str(got.value) == str(e)
        return
    got = registry.load_engines_conf(str(path))
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]


def test_a_conf_that_is_not_json_is_refused(tmp_path):
    path = tmp_path / "engines.json"
    path.write_text("{nope")
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="not valid JSON"):
            mod.load_engines_conf(str(path))


# --------------------------------------------------------- the byte count
def _factors(seed=3, n_users=50, n_items=70, rank=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_users, rank)).astype(np.float32),
            rng.standard_normal((n_items, rank)).astype(np.float32))


@pytest.mark.parametrize("kind", ["numpy", "device"])
def test_model_hbm_bytes_equals_the_reference_on_the_same_factors(kind):
    """Host factors in both packages, and factors on the device (torch
    tensors in the port, jax arrays in the reference)."""
    import jax.numpy as jnp

    U, V = _factors()
    uv, iv = ([f"u{i}" for i in range(len(U))],
              [f"i{i}" for i in range(len(V))])
    wrap = (lambda x: x) if kind == "numpy" else torch.from_numpy
    jwrap = (lambda x: x) if kind == "numpy" else jnp.asarray
    port = ALSModel(rank=U.shape[1], user_factors=wrap(U),
                    item_factors=wrap(V), user_vocab=BiMap.string_int(uv),
                    item_vocab=BiMap.string_int(iv))
    ref = JALSModel(rank=U.shape[1], user_factors=jwrap(U),
                    item_factors=jwrap(V), user_vocab=JBiMap.string_int(uv),
                    item_vocab=JBiMap.string_int(iv))
    got = registry.model_hbm_bytes([port, None])
    assert got == ref_registry.model_hbm_bytes([ref, None])
    assert got == (U.nbytes + V.nbytes)


def test_model_hbm_bytes_counts_arrays_once_as_the_reference():
    class M:
        def __init__(self):
            self.x = np.zeros((4, 4), dtype=np.float32)
            self.d = {"y": np.zeros(8, dtype=np.float64)}
            self.t = (np.zeros(2, dtype=np.int32),)
            self.alias = self.x
            self.s = "not-an-array"

    for mod in PACKAGES.values():
        assert mod.model_hbm_bytes([M()]) == 4 * 4 * 4 + 8 * 8 + 2 * 4


def test_an_int8_model_counts_its_device_layout_not_its_host_copy(
        monkeypatch):
    """The prepared int8 model keeps host fp32 factors (fold-in and eval
    read them) and its quantized layout on the device: the count is the
    layout's bytes alone, and equals the projection made before it was
    placed."""
    U, V = _factors()
    host = ALSModel(rank=U.shape[1], user_factors=U, item_factors=V,
                    user_vocab=BiMap.string_int(f"u{i}" for i in range(50)),
                    item_vocab=BiMap.string_int(f"i{i}" for i in range(70)))
    algo = als_algorithm.ALSAlgorithm(als_algorithm.ALSAlgorithmParams())
    monkeypatch.setenv("PIO_SERVE_QUANT_RECALL_MIN", "0")
    with quant.deploy_scope("on", device="cpu"):
        prepared = algo.prepare_serving(host)
    q = prepared.quant
    assert q is not None and isinstance(prepared.user_factors, np.ndarray)
    layout = sum(t.nbytes for t in (q.u_q, q.u_scale, q.vt_q, q.v_scale))
    assert registry.model_hbm_bytes([prepared]) == layout
    with quant.deploy_scope("on", device="cpu"):
        assert registry.projected_serving_bytes([host], int8=True) == layout
    with quant.deploy_scope("off", device="cpu"):
        assert registry.projected_serving_bytes(
            [host], int8=False) == U.nbytes + V.nbytes


@pytest.mark.parametrize("quant_mode", ["on", "off"])
def test_the_projection_of_a_sharded_layout_is_what_it_places(
        monkeypatch, quant_mode):
    """Under shard-serving the projection is ``serve_dist``'s count of
    the layout ``shard_factors`` builds, int8 or fp32, and equals the
    bytes the prepared model keeps."""
    from predictionio_tpu_torch.parallel import serve_dist

    U, V = _factors()
    host = ALSModel(rank=U.shape[1], user_factors=U, item_factors=V,
                    user_vocab=BiMap.string_int(f"u{i}" for i in range(50)),
                    item_vocab=BiMap.string_int(f"i{i}" for i in range(70)))
    algo = als_algorithm.ALSAlgorithm(als_algorithm.ALSAlgorithmParams())
    monkeypatch.setenv("PIO_SERVE_QUANT_RECALL_MIN", "0")
    with serve_dist.deploy_scope("on", device="cpu"), \
            quant.deploy_scope(quant_mode, device="cpu"):
        projected = registry.projected_serving_bytes(
            [host], int8=quant_mode == "on")
        prepared = algo.prepare_serving(host)
    assert prepared.sharding is not None
    assert (prepared.sharding.dtype == "int8") == (quant_mode == "on")
    assert registry.model_hbm_bytes([prepared]) == projected > 0


# ----------------------------------------------------------- the registry
class _Inst:
    def __init__(self, iid):
        self.id = iid


def _servable(mod, name, model_bytes=0, budget_mb=None):
    return mod.ServableModel(
        name=name, spec=mod.TenantSpec(name=name, hbm_budget_mb=budget_mb),
        instance=_Inst(f"i-{name}"), engine=None, engine_params=None,
        algorithms=[], models=[], serving=None, model_bytes=model_bytes)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_registry_generations_budget_and_cap_as_the_reference(pkg):
    mod = PACKAGES[pkg]
    reg = mod.ModelRegistry(hard_cap_mb=4)
    assert reg.install(_servable(mod, "a", 3 * MIB)) is None
    with pytest.raises(ValueError, match="hard HBM cap"):
        reg.install(_servable(mod, "b", 2 * MIB))
    assert reg.names() == ["a"] and reg.generations() == {"a": 1}
    prior = reg.install(_servable(mod, "a", 1 * MIB))
    assert prior.generation == 1 and reg.generations() == {"a": 2}
    fat = _servable(mod, "fat", 2 * MIB, budget_mb=1)
    reg.install(fat)
    assert fat.over_budget and reg.oversubscribed() == ["fat"]
    assert reg.get("fat").state()["overBudget"] is True
    assert reg.total_model_bytes() == 3 * MIB


# ------------------------------------------------------- the deploy, wire
def test_two_tenants_route_by_key_with_401_and_429(two_apps):
    storage, ids = two_apps
    api = _deploy(storage, ids, overrides={"a": {"rate": 1.0,
                                                 "burst": 1.0}})
    single = {n: fleet.query_api(fleet.store_with(fleet.tied_blob(seed=s)))
              for n, s in (("a", 1), ("b", 2))}
    try:
        for name in ("b", "a"):
            status, body, headers = _ask(api, "u2", key=f"key-{name}")
            assert status == 200 and headers == {"X-PIO-Tenant": name}
            assert body == single[name].handle(
                "POST", "/queries.json", body=fleet.util.query("u2", 3))[1]
        assert _ask(api, "u2")[:2] == (401, {"message": "Missing accessKey."})
        assert _ask(api, "u2", key="bogus")[0] == 401
        status, _, headers = _ask(api, "u2", key="key-a")   # a's burst spent
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert _ask(api, "u2", key="key-b")[0] == 200       # b untouched
        info = api.handle("GET", "/")[1]
        assert info["generations"] == {"a": 1, "b": 1}
        assert info["modelBytesTotal"] == sum(
            t["modelBytes"] for t in info["tenants"].values()) > 0
        ready = api.handle("GET", "/readyz")
        assert ready[0] == 200 and ready[1]["generations"] == {"a": 1, "b": 1}
    finally:
        api.close()
        for s in single.values():
            s.close()


def test_the_soft_budget_is_flagged_and_serves(two_apps):
    storage, ids = two_apps
    api = _deploy(storage, ids, overrides={"a": {"hbm_budget_mb": 1e-6}})
    try:
        info = api.handle("GET", "/")[1]
        assert info["oversubscribed"] == ["a"]
        assert info["tenants"]["a"]["overBudget"] is True
        assert _ask(api, "u1", key="key-a")[0] == 200
    finally:
        api.close()


def test_the_hard_cap_refuses_before_the_layout_is_placed(two_apps,
                                                          monkeypatch):
    """A cap that tenant a fits and a + b do not: the deploy fails naming
    the cap, and b's prepare_serving (its device placement) never ran."""
    storage, ids = two_apps
    placed = []
    real = als_algorithm.ALSAlgorithm.prepare_serving

    def counting(self, model):
        placed.append(len(model.item_vocab))
        return real(self, model)

    monkeypatch.setattr(als_algorithm.ALSAlgorithm, "prepare_serving",
                        counting)
    one = registry.projected_serving_bytes(
        [_host_model(fleet.tied_blob(seed=1))], int8=True)
    monkeypatch.setenv("PIO_TENANT_HBM_HARD_CAP_MB", str(1.5 * one / MIB))
    with pytest.raises(ValueError, match="hard HBM cap"):
        _deploy(storage, ids)
    assert placed == [40]          # a only


def _host_model(blob):
    from predictionio_tpu_torch.workflow import model_io
    return model_io.deserialize_models(blob)[0]


def test_one_tenants_saturation_leaves_the_other_serving(two_apps):
    storage, ids = two_apps
    api = _deploy(storage, ids, batch_max_size=1,
                  overrides={"a": {"batch_max_queue": 1}})
    batcher = api.registry.get("a").batcher
    entered, gate = threading.Event(), threading.Event()
    real = batcher._flush_fn

    def gated(items):
        entered.set()
        gate.wait(fleet.TIMEOUT_S)
        return real(items)

    batcher._flush_fn = gated
    threads = []
    try:
        threads.append(threading.Thread(
            target=_ask, args=(api, "u1", "key-a")))
        threads[0].start()
        assert entered.wait(fleet.TIMEOUT_S)   # a's worker is mid-flush
        threads.append(threading.Thread(
            target=_ask, args=(api, "u1", "key-a")))
        threads[1].start()                     # fills a's one-slot queue
        fleet.wait_for(lambda: batcher.depth() >= 1)
        status, body, headers = _ask(api, "u1", key="key-a")
        assert status == 503 and "saturated" in body["message"]
        assert int(headers["Retry-After"]) >= 1
        for _ in range(3):
            status, body, _ = _ask(api, "u1", key="key-b")
            assert status == 200 and body["itemScores"]
    finally:
        gate.set()
        for t in threads:
            t.join(fleet.TIMEOUT_S)
        api.close()


def test_the_warm_up_is_flat_across_tenants(two_apps):
    """Each tenant's warm-up runs the same programs as one deploy's, and
    the second tenant loads no kernel library that the first did not."""
    from predictionio_tpu_torch.ops import _kernels

    storage, ids = two_apps
    solo = _deploy(storage, {"a": ids["a"]}, aot="on")
    libs = set(_kernels._libs)
    try:
        programs = solo.registry.get("a").aot_state["programs"]
        assert programs > 0
    finally:
        solo.close()
    both = _deploy(storage, ids, aot="on")
    try:
        assert [both.registry.get(n).aot_state["programs"]
                for n in ("a", "b")] == [programs, programs]
        assert set(_kernels._libs) == libs
    finally:
        both.close()


def test_a_single_engine_deploy_keeps_its_wire(two_apps):
    """Without --engines: GET / and /readyz keep their key sets, answers
    are the 2-tuple without X-PIO-Tenant, and the registry tracks the
    model under the reserved default name."""
    storage, ids = two_apps
    api = fleet.query_api(storage, engine_instance_id=ids["a"])
    try:
        info = api.handle("GET", "/")[1]
        assert set(info) == {
            "status", "engineInstance", "algorithms", "requestCount",
            "avgServingSec", "lastServingSec", "degradedCount", "draining",
            "serverStartTime", "generation", "device", "batching", "quant"}
        ready = api.handle("GET", "/readyz")[1]
        assert "generations" not in ready and "partition" not in ready
        r = api.handle("POST", "/queries.json",
                       body=fleet.util.query("u1", 2))
        assert r[0] == 200 and len(r) == 2
        assert api.registry.names() == [registry.DEFAULT_TENANT]
    finally:
        api.close()
