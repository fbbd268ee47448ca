"""The quickstart through the port alone, on the CPU: ``pio app new``, batch
POSTs to a live event server (stopped through its SIGTERM drain, with
``/readyz`` answering 503 meanwhile), ``pio train``, ``pio deploy``, the
query, ``pio undeploy`` — in a subprocess where jax and the JAX package
cannot be imported. And both packages' QueryAPI on one model blob answer
the quickstart's literal query alike."""

import datetime as dt
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

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
from predictionio_tpu_torch.data.storage import EngineInstance, Model, Storage
from predictionio_tpu_torch.workflow import create_server as tserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_QUICKSTART = textwrap.dedent("""
    import sys

    def blocked(name):
        return (name == "jax" or name.startswith(("jax.", "jaxlib"))
                or name == "predictionio_tpu"
                or name.startswith("predictionio_tpu."))

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import http.client, json, os, signal, socket, threading, time
    import urllib.request
    from predictionio_tpu_torch.tools import cli

    work = sys.argv[1]

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def call(conn, method, target, body=None):
        conn.request(method, target, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())

    def wait_ready(port, deadline=30.0):
        t0 = time.time()
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/readyz", timeout=2) as r:
                    return
            except OSError:
                if time.time() - t0 > deadline:
                    raise
                time.sleep(0.05)

    assert cli.main(["app", "new", "MyApp1", "--access-key", "qs"]) == 0
    es_port, errors, seen = free_port(), [], []

    def ingest():
        try:
            wait_ready(es_port)
            conn = http.client.HTTPConnection("127.0.0.1", es_port,
                                              timeout=10)
            batch = [{"event": "rate", "entityType": "user",
                      "entityId": f"u{u}", "targetEntityType": "item",
                      "targetEntityId": f"i{i}", "properties": {
                          "rating": 5.0 if (u % 2) == (i % 2) else 1.0}}
                     for u in range(8) for i in range(6)]
            status, out = call(conn, "POST",
                               "/batch/events.json?accessKey=qs",
                               json.dumps(batch).encode())
            assert status == 200, (status, out)
            assert [x["status"] for x in out] == [201] * 48, out
            assert call(conn, "GET", "/readyz") == (200, {"status": "ready"})
            os.kill(os.getpid(), signal.SIGTERM)
            t0 = time.time()
            while time.time() - t0 < 10:
                seen.append(call(conn, "GET", "/readyz"))
                if seen[-1][0] == 503:
                    break
                time.sleep(0.01)
            conn.close()
        except BaseException as e:
            errors.append(e)
            os.kill(os.getpid(), signal.SIGTERM)

    client = threading.Thread(target=ingest)
    client.start()
    assert cli.main(["eventserver", "--ip", "127.0.0.1", "--port",
                     str(es_port)]) == 0
    client.join()
    assert not errors, errors
    assert seen[-1] == (503, {"status": "draining"}), seen

    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as f:
        json.dump({
            "id": "default", "description": "Default settings",
            "engineFactory": "predictionio_tpu_torch.models."
                             "recommendation.engine:RecommendationEngine",
            "datasource": {"params": {"appName": "MyApp1"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": 5, "lambda": 0.05,
                "seed": 3}}]}, f)
    assert cli.main(["train", "--engine-dir", engine_dir]) == 0

    q_port, rcs = free_port(), []
    deploy = threading.Thread(target=lambda: rcs.append(cli.main([
        "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1",
        "--port", str(q_port)])))
    deploy.start()
    wait_ready(q_port)
    conn = http.client.HTTPConnection("127.0.0.1", q_port, timeout=30)
    status, body = call(conn, "POST", "/queries.json",
                        json.dumps({"user": "u1", "num": 4}).encode())
    conn.close()
    assert status == 200 and len(body["itemScores"]) == 4, body
    assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(q_port)]) == 0
    deploy.join(timeout=30)
    assert rcs == [0] and not deploy.is_alive()
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("ok")
""")


def test_quickstart_through_the_port_cli_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("PIO_")}
    env.update(PYTHONPATH=REPO, PIO_FS_BASEDIR=str(tmp_path / "store"),
               PIO_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _QUICKSTART, str(tmp_path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert "[INFO] Event Server is started at 127.0.0.1:" in proc.stdout
    assert "Training completed" in proc.stdout
    assert "Undeployed server at 127.0.0.1:" in proc.stdout


def _mem(cls):
    return cls(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"})


def _deploy(storage, instance_cls, model_cls, factory, blob):
    now = dt.datetime(2024, 5, 6, tzinfo=dt.timezone.utc)
    iid = storage.get_meta_data_engine_instances().insert(instance_cls(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="NOT_USED",
        engine_variant="default", engine_factory=factory,
        data_source_params=json.dumps({"params": {"appName": "MyApp1"}}),
        algorithms_params=json.dumps([{"name": "als", "params": {
            "rank": 4, "numIterations": 5, "lambda": 0.05, "seed": 3}}])))
    storage.get_model_data_models().insert(model_cls(iid, blob))


def test_quickstart_literal_query_answers_alike(monkeypatch):
    """``{"user":1,"num":4}`` as the quickstart writes it, and with the
    user as a string, through both packages' QueryAPI on one blob (served
    from int8 factors, whose scores both packages compute exactly)."""
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    rng = np.random.default_rng(7)
    blob = jmodel_io.serialize_models([JALSModel(
        rank=4,
        user_factors=rng.normal(size=(8, 4)).astype(np.float32),
        item_factors=rng.normal(size=(6, 4)).astype(np.float32),
        user_vocab=JBiMap.string_int(str(u) for u in range(8)),
        item_vocab=JBiMap.string_int(f"i{i}" for i in range(6)))])
    js, ts = _mem(JStorage), _mem(Storage)
    _deploy(js, JEngineInstance, JModel, "predictionio_tpu.models."
            "recommendation.engine:RecommendationEngine", blob)
    _deploy(ts, EngineInstance, Model, "predictionio_tpu_torch.models."
            "recommendation.engine:RecommendationEngine", blob)
    japi = jserver.QueryAPI(storage=js, config=jserver.ServerConfig(
        serve_quant="on", batching="off", aot="off"))
    tapi = tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(
        device="cpu", serve_quant="on", batching="off"))
    try:
        for body in (b'{"user":1,"num":4}', b'{"user":"1","num":4}'):
            want = japi.handle("POST", "/queries.json", body=body)[:2]
            got = tapi.handle("POST", "/queries.json", body=body)[:2]
            assert json.dumps(got) == json.dumps(want), body
        # the JAX package's Query takes the user as a string, so the
        # literal integer is a 400 in both; the string form answers 4
        assert got[0] == 200 and len(got[1]["itemScores"]) == 4
        assert tapi.handle("POST", "/queries.json",
                           body=b'{"user":1,"num":4}')[0] == 400
    finally:
        japi.close()
        tapi.close()
        jquant.record_state(None)
        serve_dist.record_state(None)
