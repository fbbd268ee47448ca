"""The port's engine server with row-sharded serving
(``PIO_SERVE_SHARD`` / ``ServerConfig.shard_serving``), in process on the
CPU, held against the same server with the replicated layout: the
deploy, fold-in (the sharded scatters) and ``POST /reload`` answer the
same bytes, ``GET /``, ``/metrics`` and ``/debug/device.json`` carry the
layout, ``pio doctor``'s sharding line reads it, and a failed sharded
layout fails the deploy (no replicated fallback). Also the train verb's
``--devices`` and ``--coordinator`` flags. The reference's own sharded
deploy tests are red on these trees, so the replicated path is the
yardstick. No thread is started but the ones joined here; the fold-in
worker is driven by hand."""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu_torch.common import devicewatch, telemetry
from predictionio_tpu_torch.data.api.http import dispatch_request
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import (
    App, EngineInstance, Model, Storage,
)
from predictionio_tpu_torch.parallel import serve_dist
from predictionio_tpu_torch.realtime import foldin
from predictionio_tpu_torch.tools import cli, doctor
from predictionio_tpu_torch.workflow import create_server as tserver

import torch_deploy_util as util
from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")

APP = "ObsApp"
T0 = dt.datetime(2024, 7, 1, tzinfo=dt.timezone.utc)
USERS = [f"u{i}" for i in range(util.N_USERS)] + ["nobody"]


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for name in ("PIO_FOLDIN", "PIO_AOT", "PIO_TORCH_DEVICE",
                 "PIO_SERVE_SHARD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PIO_SERVE_FUSED", "on")     # B1 + B2's plain form
    monkeypatch.setenv("PIO_SERVE_FUSED_TILE", "8")
    monkeypatch.setenv("PIO_FOLDIN_USER_BUCKETS", "1,8")
    monkeypatch.setenv("PIO_FOLDIN_MAX_EVENTS", "16")
    monkeypatch.setenv("PIO_FOLDIN_DRIFT_EVERY", "0")
    monkeypatch.setenv("PIO_FOLDIN_CURSOR_DIR", str(tmp_path / "cur"))
    monkeypatch.setattr(foldin.FoldinWorker, "start", lambda self: None)
    yield
    serve_dist.record_state(None)
    devicewatch.note_foldin(None)
    devicewatch.note_aot(None)
    devicewatch.note_quant(None)


def _store():
    ts = Storage(env=util.MEM)
    app_id = ts.get_meta_data_apps().insert(App(0, APP, None))
    ts.get_events().init(app_id)
    iid = ts.get_meta_data_engine_instances().insert(util._instance(
        EngineInstance, "predictionio_tpu_torch.models.recommendation."
        "engine:RecommendationEngine"))
    ts.get_model_data_models().insert(Model(iid, util.dyadic_blob()))
    return ts, app_id


def _api(ts, shard, **kw):
    cfg = dict(device="cpu", serve_quant="on", batching="on",
               batch_max_delay_ms=1.0, shard_serving=shard)
    cfg.update(kw)
    return tserver.QueryAPI(storage=ts, config=tserver.ServerConfig(**cfg))


def _answers(api, nums=(1, 4, 40)):
    return [api.handle("POST", "/queries.json", body=util.query(u, n))
            for u in USERS for n in nums]


def _rate(ts, app_id, users, n_items=5, minute0=0):
    evs = [Event(event="rate", entity_type="user", entity_id=u,
                 target_entity_type="item",
                 target_entity_id=f"i{(3 * j + k) % util.N_ITEMS}",
                 properties=DataMap({"rating": float(1 + (j + k) % 5)}),
                 event_time=T0 + dt.timedelta(minutes=minute0 + 10 * j + k))
           for j, u in enumerate(users) for k in range(n_items)]
    ts.get_events().insert_batch(evs, app_id)


@pytest.mark.parametrize("quant", ["on", "off"])
def test_sharded_deploy_answers_the_replicated_bytes(quant):
    telemetry.set_enabled(True)
    ts, _ = _store()
    rep = _api(ts, "off", serve_quant=quant)
    want = _answers(rep)
    assert "sharding" not in rep.handle("GET", "/")[1]
    rep.close()
    api = _api(ts, "on", serve_quant=quant)
    try:
        assert _answers(api) == want
        st = api.handle("GET", "/")[1]
        sh = st["sharding"]
        assert sh["enabled"] and sh["shards"] == 1
        assert sh["merge"] == "all_gather"
        assert sh["rowsPerShard"] == {"users": util.N_USERS,
                                      "items": util.N_ITEMS}
        assert (sh.get("dtype") == "int8") == (quant == "on")
        if quant == "on":
            assert st["quant"]["sharded"] and st["quant"]["shards"] == 1
        metrics = dispatch_request(api, "GET", "/metrics", b"", {}).data
        assert b"\npio_serve_shards 1\n" in metrics
        dev = json.loads(dispatch_request(api, "GET", "/debug/device.json",
                                          b"", {}).data)
        assert dev["sharding"]["shards"] == 1
        scraped = {"url": "in-process"}
        for key, path in (("healthz", "/healthz"), ("readyz", "/readyz"),
                          ("root", "/"), ("metrics", "/metrics"),
                          ("traces", "/traces.json"),
                          ("device", "/debug/device.json"),
                          ("slow", "/debug/slow.json"),
                          ("history", "/debug/history.json"),
                          ("events", "/debug/events.json")):
            got = dispatch_request(api, "GET", path, b"", {})
            scraped[key] = {"status": got.status, "body": got.data.decode()}
        line = {c: (s, d) for c, s, d in doctor.diagnose(scraped)}
        state, detail = line["sharding"]
        assert state == doctor.OK, detail
        assert detail.startswith("1 shard(s), all_gather merge")
    finally:
        api.close()
        telemetry.set_enabled(False)


def test_the_variable_wins_over_the_config(monkeypatch):
    ts, _ = _store()
    monkeypatch.setenv("PIO_SERVE_SHARD", "on")
    api = _api(ts, "off")
    try:
        assert api.models[0].sharding is not None
    finally:
        api.close()
    monkeypatch.setenv("PIO_SERVE_SHARD", "0")
    api = _api(ts, "on")
    try:
        assert api.models[0].sharding is None
        assert "sharding" not in api.handle("GET", "/")[1]
    finally:
        api.close()


def test_a_failed_sharded_layout_fails_the_deploy(monkeypatch):
    ts, _ = _store()

    def broken(*a, **kw):
        raise RuntimeError("no room for the shards")

    monkeypatch.setattr(serve_dist, "shard_factors", broken)
    with pytest.raises(RuntimeError, match="no room for the shards"):
        _api(ts, "on")


def test_auto_shards_on_a_multi_card_world_and_not_during_reload(
        monkeypatch):
    ts, _ = _store()
    api = _api(ts, "auto")
    try:
        assert api.models[0].sharding is None      # one device: replicated
    finally:
        api.close()
    monkeypatch.setattr(serve_dist, "_multi_device_platform", lambda: True)
    api = _api(ts, "auto")
    try:
        assert api.models[0].sharding is not None
        api.reload_async().join()
        assert api.generation == 2
        assert api.models[0].sharding is None      # the swap stays replicated
        assert "sharding" not in api.handle("GET", "/")[1]
    finally:
        api.close()


def test_foldin_and_reload_through_the_sharded_scatters():
    ts, app_id = _store()
    runs = {}
    for shard in ("off", "on"):
        ts, app_id = _store()
        api = _api(ts, shard, foldin="on", foldin_headroom=4,
                   foldin_item_headroom=2, aot="on")
        try:
            out = []
            _rate(ts, app_id, ["fresh0", "fresh1", "u3"])
            out.append(api._foldin_worker.tick()["appended"])
            out.append(_answers(api, nums=(4,)))
            out.append([api.handle("POST", "/queries.json",
                                   body=util.query(u, 6))
                        for u in ("fresh0", "fresh1", "u3")])
            # more unseen users than the headroom left: the reload
            # fallback, then the pending users fold into fresh headroom
            _rate(ts, app_id, [f"new{j}" for j in range(3)], minute0=500)
            api._foldin_worker.tick()
            if api._reload_thread is not None:
                api._reload_thread.join()
            api._foldin_worker.tick()
            out.append(api.generation)
            out.append([api.handle("POST", "/queries.json",
                                   body=util.query(f"new{j}", 5))
                        for j in range(3)])
            # an operator's POST /reload keeps the sharded layout ("on")
            api.reload_async().join()
            out.append(api.generation)
            api._foldin_worker.tick()
            out.append(_answers(api, nums=(3,)))
            out.append((api.models[0].sharding is not None,
                        api.handle("GET", "/")[1].get("sharding",
                                                      {}).get("shards")))
            runs[shard] = out
        finally:
            api.close()
    rep, sh = runs["off"], runs["on"]
    assert sh[-1] == (True, 1) and rep[-1] == (False, None)
    assert sh[:-1] == rep[:-1]
    assert sh[0] == 2 and sh[3] >= 2
    for status, body in sh[2] + sh[4]:
        assert status == 200 and body["itemScores"]


def test_train_devices_and_coordinator_flags(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    d = tmp_path / "engine"
    d.mkdir()
    (d / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory":
            "predictionio_tpu.models.recommendation.engine:"
            "RecommendationEngine",
        "datasource": {"params": {"appName": "SynthApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 2, "lambda": 0.01, "seed": 3}}]}))
    base = ["train", "--engine-dir", str(d), "--synthetic", "3000"]
    assert cli.main(base + ["--coordinator", "h:1"]) == 1
    assert "--num-processes >= 1" in capsys.readouterr().err
    assert cli.main(base + ["--coordinator", "h:1", "--num-processes",
                            "2", "--process-id", "2"]) == 1
    assert "--process-id must be in" in capsys.readouterr().err
    assert cli.main(base + ["--devices", "2"]) == 1
    assert "requested 2 devices but only 1 are visible" in \
        capsys.readouterr().err
    # the whole world's mesh: one process, one slot
    assert cli.main(base + ["--devices", "-1"]) == 0
    assert cli.main(base) == 0
    rows = sorted(Storage().get_meta_data_engine_instances().get_all(),
                  key=lambda r: r.start_time)
    assert [r.status for r in rows] == ["COMPLETED", "COMPLETED"]
    from predictionio_tpu_torch.workflow import model_io
    blobs = Storage().get_model_data_models()
    sharded, single = (model_io.deserialize_models(blobs.get(r.id).models)[0]
                       for r in rows)
    np.testing.assert_allclose(np.asarray(sharded.user_factors),
                               np.asarray(single.user_factors),
                               rtol=2e-3, atol=2e-4)


def test_deploy_passes_the_shard_serving_flag(monkeypatch, tmp_path):
    seen = {}

    class FakeAPI:
        def __init__(self, config):
            seen["config"] = config

    monkeypatch.setattr(tserver, "QueryAPI", FakeAPI)
    monkeypatch.setattr(tserver, "serve", lambda api, host, port: None)
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory": "x:y"}))
    assert cli.main(["deploy", "--engine-dir", str(tmp_path),
                     "--shard-serving", "on"]) == 0
    assert seen["config"].shard_serving == "on"
    assert cli.main(["deploy", "--engine-dir", str(tmp_path)]) == 0
    assert seen["config"].shard_serving == "auto"
