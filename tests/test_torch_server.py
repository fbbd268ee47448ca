"""The slice as a whole: the same model blob deployed in the JAX
package's QueryAPI (quantized, fused kernel in Pallas interpret mode)
and in the PyTorch port's QueryAPI (quantized, on the CPU, where the
fused path is the kernel's plain version) answers the same
/queries.json bodies with byte-identical JSON — sequentially, in a
concurrent burst the micro-batcher coalesces, and through the port's
HTTP transport."""

import datetime as dt
import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.storage import EngineInstance as JEngineInstance
from predictionio_tpu.data.storage import Model as JModel
from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.ops import quant as jquant
from predictionio_tpu.parallel import serve_dist
from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.data.api.http import make_server
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage
from predictionio_tpu_torch.ops import topk_fused
from predictionio_tpu_torch.workflow import create_server as tserver

N_USERS, N_ITEMS, RANK = 300, 700, 10
PARAMS = {
    "datasource": json.dumps({"params": {"appName": "PortApp"}}),
    "algorithms": json.dumps([{"name": "als", "params": {
        "rank": RANK, "numIterations": 10, "lambda": 0.01, "seed": 3}}]),
}


@pytest.fixture(scope="module")
def blob():
    rng = np.random.default_rng(2024)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    V[600] = V[5]                   # a tie across tiles at the wire
    return jmodel_io.serialize_models([JALSModel(
        rank=RANK,
        user_factors=rng.normal(size=(N_USERS, RANK)).astype(np.float32),
        item_factors=V,
        user_vocab=JBiMap.string_int(f"u{i}" for i in range(N_USERS)),
        item_vocab=JBiMap.string_int(f"i{i}" for i in range(N_ITEMS)))])


def _instance(cls, factory):
    now = dt.datetime(2024, 5, 6, tzinfo=dt.timezone.utc)
    return cls(id="", status="COMPLETED", start_time=now, end_time=now,
               engine_id="default", engine_version="NOT_USED",
               engine_variant="default", engine_factory=factory,
               data_source_params=PARAMS["datasource"],
               algorithms_params=PARAMS["algorithms"])


@pytest.fixture(scope="module")
def servers(blob):
    mp = pytest.MonkeyPatch()
    mp.setenv("PIO_SERVE_QUANT", "on")
    mp.setenv("PIO_SERVE_FUSED", "on")
    # a 128-column tile keeps the interpreter's selection rounds cheap
    mp.setenv("PIO_SERVE_FUSED_TILE", "128")
    mp.delenv("PIO_TORCH_DEVICE", raising=False)
    js = JStorage(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
    })
    jid = js.get_meta_data_engine_instances().insert(_instance(
        JEngineInstance,
        "predictionio_tpu.models.recommendation.engine:"
        "RecommendationEngine"))
    js.get_model_data_models().insert(JModel(jid, blob))
    ts = Storage(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
    })
    tid = ts.get_meta_data_engine_instances().insert(_instance(
        EngineInstance,
        "predictionio_tpu_torch.models.recommendation.engine:"
        "RecommendationEngine"))
    ts.get_model_data_models().insert(Model(tid, blob))
    batching = dict(batch_max_delay_ms=20.0)
    japi = jserver.QueryAPI(storage=js, config=jserver.ServerConfig(
        serve_quant="on", aot="off", **batching))
    tapi = tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
        device="cpu", serve_quant="on", **batching))
    try:
        yield japi, tapi
    finally:
        japi.close()
        tapi.close()
        jquant.record_state(None)
        serve_dist.record_state(None)
        mp.undo()


def _body(user, num):
    return json.dumps({"user": user, "num": num}).encode()


def _answer(api, body):
    status, payload = api.handle("POST", "/queries.json", body=body)[:2]
    return status, json.dumps(payload, allow_nan=False)


QUERIES = [("u0", 4), ("u17", 10), ("u299", 1), ("nobody", 10), ("u5", 0),
           ("u6", -3), ("u42", N_ITEMS + 100), ("u42", N_ITEMS)]


def test_both_deploys_serve_quantized_through_the_fused_path(servers):
    japi, tapi = servers
    jq = japi.handle("GET", "/")[1]["quant"]
    tq = tapi.handle("GET", "/")[1]["quant"]
    assert jq["enabled"] and jq["fused"] and jq["interpret"]
    assert tq == jq           # same layout, tile, footprint and probe


@pytest.mark.parametrize("user,num", QUERIES)
def test_sequential_answers_byte_identical(servers, user, num):
    japi, tapi = servers
    j = _answer(japi, _body(user, num))
    t = _answer(tapi, _body(user, num))
    assert j[0] == t[0] == 200
    assert t[1] == j[1]
    got = json.loads(t[1])["itemScores"]
    if user == "nobody" or num <= 0:
        assert got == []
    else:
        assert len(got) == min(num, N_ITEMS)


def test_concurrent_burst_byte_identical_and_batched(servers):
    japi, tapi = servers
    rng = np.random.default_rng(5)
    users = [f"u{int(u)}" for u in rng.integers(0, N_USERS, size=40)]
    users[7] = "nobody"
    bodies = [_body(u, 10) for u in users]
    before = tapi.handle("GET", "/")[1]["batching"]["batchSizeHist"]

    def burst(api):
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            return list(pool.map(lambda b: _answer(api, b), bodies))

    j, t = burst(japi), burst(tapi)
    assert t == j
    after = tapi.handle("GET", "/")[1]["batching"]["batchSizeHist"]
    grew = {int(s) for s, n in after.items() if n > before.get(s, 0)}
    assert max(grew) > 1, after          # the burst coalesced


def test_port_http_transport_bytes_equal_the_jax_answer(servers):
    japi, tapi = servers
    server = make_server(tapi, "127.0.0.1", 0)
    worker = threading.Thread(target=server.serve_forever, daemon=True)
    worker.start()
    try:
        port = server.server_address[1]
        for user, num in QUERIES[:4]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/queries.json",
                data=_body(user, num), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
                wire = r.read()
            assert wire == _answer(japi, _body(user, num))[1].encode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/readyz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ready"
    finally:
        server.shutdown()
        server.server_close()
        worker.join(timeout=10)
    assert not worker.is_alive()


def test_cpu_deploy_launches_no_kernel(servers):
    _japi, tapi = servers
    topk_fused.reset_launches()
    assert _answer(tapi, _body("u1", 5))[0] == 200
    assert topk_fused.launches == 0


def test_bad_requests(servers):
    _japi, tapi = servers
    assert tapi.handle("POST", "/queries.json", body=b"{")[0] == 400
    assert tapi.handle("POST", "/queries.json",
                       body=b'{"user": "u1"}')[0] == 400
    assert tapi.handle("GET", "/nope")[0] == 404
