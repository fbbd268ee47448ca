"""The training cursor and the read path a train records, and the fold-in
rebase at that cursor after a reload, in the port against the JAX
package, on the same seeded events in a memory, a SQLite and an eventlog
store (on the CPU).

- ``run_train`` snapshots the app's event-store head before the training
  read and stores it JSON-encoded as ``runtime_conf["train_cursor"]``:
  the same string the reference stores, through a storage server too.
- ``runtime_conf["train_stream"]`` records the read path: ``on`` for a
  streamed train (an eventlog store under ``PIO_TRAIN_STREAM=on``),
  ``off`` for an in-core one, as the reference records it.
- A deploy with fold-in reloaded onto a newer instance rebases its worker
  at that instance's training cursor: a user whose events landed after
  the training read and before the reload is folded into the new
  generation on the next tick, in both packages.

The fold-in worker's thread never starts: its ticks are driven by hand.
"""

import datetime as dt
import json

import numpy as np
import pytest

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
from predictionio_tpu.realtime import foldin as jfoldin
from predictionio_tpu.workflow import WorkflowContext as JWorkflowContext
from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu.workflow import run_train as jrun_train
from predictionio_tpu_torch.common import devicewatch
from predictionio_tpu_torch.controller.engine import Engine
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import App, Storage
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)
from predictionio_tpu_torch.realtime import foldin
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

import torch_deploy_util as util

APP = "CursorApp"
KINDS = ("memory", "sqlite", "eventlog")
N_USERS, N_ITEMS, N_EVENTS = 30, 20, 240
T0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
PORT_FACTORY = ("predictionio_tpu_torch.models.recommendation.engine:"
                "RecommendationEngine")
JAX_FACTORY = ("predictionio_tpu.models.recommendation.engine:"
               "RecommendationEngine")


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for name in ("PIO_TRAIN_STREAM", "PIO_READ_STAGE", "PIO_READ_OVERLAP",
                 "PIO_ALS_LAYOUT_CACHE", "PIO_FOLDIN", "PIO_AOT",
                 "PIO_TORCH_DEVICE", "PIO_SYNTHETIC_EVENTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(als_algorithm, "_BIG_LAYOUT_CACHE", [])
    monkeypatch.setattr(jals_algorithm, "_BIG_LAYOUT_CACHE", [])
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    monkeypatch.setenv("PIO_FOLDIN_USER_BUCKETS", "1,8")
    monkeypatch.setenv("PIO_FOLDIN_MAX_EVENTS", "16")
    monkeypatch.setenv("PIO_FOLDIN_DRIFT_EVERY", "0")
    monkeypatch.setenv("PIO_FOLDIN_CURSOR_DIR", str(tmp_path / "cur"))
    # the workers' ticks are driven by hand: their threads never start
    monkeypatch.setattr(foldin.FoldinWorker, "start", lambda self: None)
    monkeypatch.setattr(jfoldin.FoldinWorker, "start", lambda self: None)
    yield
    devicewatch.note_foldin(None)
    devicewatch.note_aot(None)


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
    """One package's store, filled with the seeded events, and its
    train."""

    def __init__(self, port: bool, storage):
        self.port, self.storage = port, storage
        app_cls = App if port else JApp
        self.app_id = storage.get_meta_data_apps().insert(
            app_cls(0, APP, None))
        storage.get_events().init(self.app_id)
        rng = np.random.default_rng(17)
        self.rate([(f"u{int(rng.integers(N_USERS))}",
                    f"i{int(rng.integers(N_ITEMS))}",
                    float(rng.integers(1, 11)) / 2)
                   for _ in range(N_EVENTS)], minute=0)

    def rate(self, triples, minute: int):
        cls, dm = (Event, DataMap) if self.port else (JEvent, JDataMap)
        self.storage.get_events().insert_batch([cls(
            event="rate", entity_type="user", entity_id=u,
            target_entity_type="item", target_entity_id=i,
            properties=dm({"rating": r}),
            event_time=T0 + dt.timedelta(minutes=minute, seconds=k))
            for k, (u, i, r) in enumerate(triples)], self.app_id)

    def head(self):
        return self.storage.get_events().head_cursor(self.app_id, None)

    def train(self):
        """One train of rank 3, 2 iterations; the stored ledger row."""
        factory = PORT_FACTORY if self.port else JAX_FACTORY
        variant = {"id": "default", "engineFactory": factory,
                   "datasource": {"params": {"appName": APP}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 3, "numIterations": 2, "lambda": 0.05,
                       "seed": 3}}]}
        if self.port:
            engine = RecommendationEngine()
            ctx = WorkflowContext(storage=self.storage, device="cpu")
            iid = run_train(ctx, engine,
                            engine.engine_params_from_json(variant),
                            engine_factory=factory, params_json=variant)
        else:
            engine = JRecommendationEngine()
            iid = jrun_train(JWorkflowContext(storage=self.storage), engine,
                             engine.engine_params_from_json(variant),
                             engine_factory=factory, params_json=variant)
        self.engine = engine
        return self.storage.get_meta_data_engine_instances().get(iid)

    def deploy(self):
        """A quantized deploy of the latest instance with fold-in on."""
        if self.port:
            return tserver.QueryAPI(
                storage=self.storage, engine=self.engine,
                config=tserver.ServerConfig(
                    device="cpu", serve_quant="on", batching="off",
                    foldin="on", foldin_headroom=4,
                    foldin_item_headroom=2))
        return jserver.QueryAPI(
            storage=self.storage, engine=self.engine,
            config=jserver.ServerConfig(
                batching="off", foldin="on", foldin_headroom=4,
                foldin_item_headroom=2))


@pytest.mark.parametrize("kind", KINDS)
def test_train_records_the_references_cursor(kind, tmp_path):
    jstorage, tstorage = _stores(kind, tmp_path)
    ref, port = _Side(False, jstorage), _Side(True, tstorage)
    jrow, trow = ref.train(), port.train()
    cursor = trow.runtime_conf.get("train_cursor")
    assert cursor is not None
    assert cursor == jrow.runtime_conf["train_cursor"]
    # the head before the read: nothing was written since
    assert json.loads(cursor) == port.head()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["on", "off"])
def test_train_records_the_read_path_it_took(kind, mode, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("PIO_TRAIN_STREAM", mode)
    jstorage, tstorage = _stores(kind, tmp_path)
    jrow = _Side(False, jstorage).train()
    trow = _Side(True, tstorage).train()
    # only the eventlog store has a chunk stream to train from
    streamed = "on" if (kind, mode) == ("eventlog", "on") else "off"
    assert trow.runtime_conf["train_stream"] == streamed
    assert jrow.runtime_conf["train_stream"] == streamed


def test_the_cursor_is_the_head_before_the_read(tmp_path, monkeypatch):
    """Events that land while the train reads are past its cursor: the
    volume trigger counts them and the fold-in rebase replays them."""
    port = _Side(True, Storage(env=util.MEM))
    before = port.head()
    real = Engine.train

    def train_with_a_late_event(self, ctx, engine_params):
        port.rate([("late_reader", "i1", 4.0)], minute=30)
        return real(self, ctx, engine_params)

    monkeypatch.setattr(Engine, "train", train_with_a_late_event)
    row = port.train()
    assert json.loads(row.runtime_conf["train_cursor"]) == before
    assert port.storage.get_events().cursor_lag(
        port.app_id, None, before) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_reload_rebases_fold_in_at_the_training_cursor(kind, tmp_path):
    jstorage, tstorage = _stores(kind, tmp_path)
    late = [("late_u", f"i{j}", float(1 + j % 5)) for j in range(6)]
    got = {}
    for side in (_Side(False, jstorage), _Side(True, tstorage)):
        side.train()
        api = side.deploy()
        try:
            worker = api._foldin_worker
            assert worker is not None and api.generation == 1
            worker.tick()
            second = side.train()            # its cursor: the head now
            # after the training read and before the reload: the live
            # generation folds the user, the new one was trained without
            side.rate(late, minute=60)
            assert worker.tick()["appended"] == 1
            api._reload()
            assert api.generation == 2
            assert api.engine_instance.id == second.id
            out = worker.tick()
            status, body = api.handle(
                "POST", "/queries.json",
                body=json.dumps({"user": "late_u", "num": 4}).encode())[:2]
            got[side.port] = (out["appended"], status,
                              len(body["itemScores"]),
                              worker.state()["usersFolded"])
        finally:
            api.close()
    # the rebase replays the late events into the new generation
    assert got[True] == got[False] == (1, 200, 4, 1)


def test_the_cursor_crosses_a_storage_server_as_the_reference(tmp_path):
    """A train through a ``remote`` source (the cursor over RPC) records
    the string the reference records through its own storage server,
    over an eventlog store: the backing's head before the read."""
    from predictionio_tpu.data.storage import remote as jremote
    from predictionio_tpu_torch.data.storage import remote

    rows = []
    for port_side, mod, storage_cls in ((False, jremote, JStorage),
                                        (True, remote, Storage)):
        root = tmp_path / ("port" if port_side else "jax")
        backing = storage_cls(env={
            "PIO_STORAGE_SOURCES_M_TYPE": "memory",
            "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(root / "el"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"})
        server = mod.serve_storage(backing, host="127.0.0.1", port=0)
        try:
            client = storage_cls(env={
                "PIO_STORAGE_SOURCES_R_TYPE": "remote",
                "PIO_STORAGE_SOURCES_R_URL":
                    f"http://127.0.0.1:{server.server_address[1]}",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R"})
            side = _Side(port_side, client)
            row = side.train()
            app_id = backing.get_meta_data_apps().get_by_name(APP).id
            assert json.loads(row.runtime_conf["train_cursor"]) == \
                backing.get_events().head_cursor(app_id, None)
            rows.append(row.runtime_conf["train_cursor"])
        finally:
            server.shutdown()
            server.server_close()
            backing.get_events().close()
    assert rows[0] == rows[1]
