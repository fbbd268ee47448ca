"""Shared set-up for the port's fleet tests: in-memory port stores holding
ALS instances of dyadic-grid models (every int8 product exact, many score
ties), port query-server replicas on port 0 of either transport, and a
port router in front of them. Every helper's server is stopped by the
caller through :func:`stop`."""

import datetime as dt
import http.client
import json
import threading

import numpy as np

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.data.api import http as port_http
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage
from predictionio_tpu_torch.workflow.create_server import (
    QueryAPI, ServerConfig,
)
from predictionio_tpu_torch.workflow.router import RouterAPI, RouterConfig

import torch_deploy_util as util

FACTORY = ("predictionio_tpu_torch.models.recommendation.engine:"
           "RecommendationEngine")
TIMEOUT_S = 10.0


def tied_blob(seed: int = 11, n_users: int = 24, n_items: int = 40,
              rank: int = 4) -> bytes:
    """A serialized ALS model on a coarse dyadic grid: scores are exact
    in int8 and fp32 alike and tie often, across any item boundary."""
    rng = np.random.default_rng(seed)
    U = rng.integers(-2, 3, size=(n_users, rank)).astype(np.float32) / 2
    V = rng.integers(-2, 3, size=(n_items, rank)).astype(np.float32) / 2
    return jmodel_io.serialize_models([JALSModel(
        rank=rank, user_factors=U, item_factors=V,
        user_vocab=JBiMap.string_int(f"u{i}" for i in range(n_users)),
        item_vocab=JBiMap.string_int(f"i{i}" for i in range(n_items)))])


def add_instance(storage: Storage, blob: bytes, minute: int = 0,
                 engine_id: str = "default", app: str = "ObsApp") -> str:
    """A COMPLETED instance of ``blob``; a later ``minute`` is newer."""
    t = dt.datetime(2024, 5, 6, 0, minute, tzinfo=dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=t, end_time=t,
        engine_id=engine_id, engine_version="NOT_USED",
        engine_variant=engine_id, engine_factory=FACTORY,
        data_source_params=json.dumps({"params": {"appName": app}}),
        algorithms_params=util.PARAMS["algorithms"]))
    storage.get_model_data_models().insert(Model(iid, blob))
    return iid


def store_with(blob: bytes) -> Storage:
    storage = Storage(env=util.MEM)
    add_instance(storage, blob)
    return storage


def query_api(storage: Storage, **cfg) -> QueryAPI:
    """A port QueryAPI on the CPU, int8, batching on."""
    cfg.setdefault("batching", "on")
    cfg.setdefault("batch_max_delay_ms", 1.0)
    return QueryAPI(storage=storage, config=ServerConfig(
        device="cpu", serve_quant="on", **cfg))


def serve(api, transport: str = "threaded"):
    """``api`` on 127.0.0.1, port 0 -> (server, port)."""
    server = port_http.make_server(api, "127.0.0.1", 0, transport=transport)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def router(ports, **kw):
    """A port router over ``ports`` -> (RouterAPI, server, port)."""
    kw.setdefault("health_ms", 50.0)
    api = RouterAPI(RouterConfig(
        backends=tuple(f"http://127.0.0.1:{p}" for p in ports), **kw))
    server, port = serve(api)
    return api, server, port


def stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def post(port: int, body: bytes, path: str = "/queries.json",
         headers=None):
    """One POST -> (status, body bytes, lower-cased headers)."""
    conn = http_client(port)
    try:
        conn.request("POST", path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.read(), {k.lower(): v
                                          for k, v in resp.getheaders()}
    finally:
        conn.close()


def get(port: int, path: str):
    conn = http_client(port)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_client(port: int) -> http.client.HTTPConnection:
    return http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)


def wait_for(pred, timeout: float = TIMEOUT_S, every: float = 0.02):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(every)
    raise AssertionError("condition not reached in time")


def wait_rotation(router_api, n: int) -> None:
    wait_for(lambda: router_api.handle("GET", "/")[1]["inRotation"] == n)
