"""Self-persisting models in the port (PersistentModel.scala:67-115,
LocalFileSystemPersistentModel.scala:39-77, Engine.makeSerializableModels
:286-304, prepareDeploy :199-269), on the CPU: the JAX package's
``tests/test_persistent_model.py`` cases through the port's ``run_train``
and deploy, and the manifest read across the packages. Blobs, manifests
and answers are compared exactly."""

import dataclasses
import os
import pickle

import pytest

from predictionio_tpu.controller import persistent_model as jpm
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.controller import (
    Algorithm, DataSource, Engine, EngineParams, FirstServing,
    LocalFileSystemPersistentModel, Params, Preparator,
)
from predictionio_tpu_torch.controller.persistent_model import (
    PersistentModelManifest, local_model_path,
)
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.workflow import create_server, model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.core_workflow import run_train

MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}


@dataclasses.dataclass
class SelfSavingModel(LocalFileSystemPersistentModel):
    weights: tuple = (1.0, 2.0)


class _DS(DataSource):
    def read_training(self, ctx):
        return "td"


class _Prep(Preparator):
    def prepare(self, ctx, td):
        return td


@dataclasses.dataclass(frozen=True)
class _AlgoParams(Params):
    scale: float = 2.0


class _Algo(Algorithm):
    params_class = _AlgoParams

    def __init__(self, params: _AlgoParams = _AlgoParams()):
        self.params = params

    def train(self, ctx, pd):
        return SelfSavingModel(weights=(self.params.scale, 2.0))

    def predict(self, model, query):
        return {"w": list(model.weights)}


class _Declining(SelfSavingModel):
    """Declines its own save: the model then rides the blob."""

    def save(self, instance_id, params, ctx):
        return False


def _engine():
    return Engine(_DS, _Prep, {"algo": _Algo}, FirstServing)


@pytest.fixture()
def st(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    return Storage(env=MEM)


def _train(st, engine=None, scale=7.0):
    ctx = WorkflowContext(storage=st, device="cpu")
    ep = EngineParams(algorithm_params_list=(("algo",
                                              _AlgoParams(scale=scale)),))
    return run_train(ctx, engine or _engine(), ep,
                     engine_factory="test_torch_persistent_model:_engine",
                     params_json={"algorithms": [
                         {"name": "algo", "params": {"scale": scale}}]})


def test_persistent_model_train_deploy_roundtrip(st):
    iid = _train(st)
    blob = st.get_model_data_models().get(iid).models
    (stored,) = model_io.deserialize_models(blob)
    assert stored == PersistentModelManifest(
        class_name="SelfSavingModel",
        module_name=SelfSavingModel.__module__)
    assert os.path.exists(local_model_path(iid))
    api = create_server.QueryAPI(create_server.ServerConfig(
        device="cpu", batching="off"), storage=st, engine=_engine())
    status, body = api.handle("POST", "/queries.json", body=b"{}")
    assert status == 200 and body == {"w": [7.0, 2.0]}


def test_unimportable_persistent_model_fails_at_save(st):
    class LocalModel(LocalFileSystemPersistentModel):  # <locals> qualname
        pass

    class BadAlgo(_Algo):
        def train(self, ctx, pd):
            return LocalModel()

    with pytest.raises(ValueError, match="not importable"):
        _train(st, Engine(_DS, _Prep, {"algo": BadAlgo}, FirstServing))
    rows = st.get_meta_data_engine_instances().get_all()
    assert rows and all(r.status == "ERROR" for r in rows)
    assert not st.get_model_data_models().get(rows[0].id)


def test_a_model_that_declines_its_save_rides_the_blob(st):
    class DecliningAlgo(_Algo):
        def train(self, ctx, pd):
            return _Declining(weights=(3.0, 4.0))

    engine = Engine(_DS, _Prep, {"algo": DecliningAlgo}, FirstServing)
    iid = _train(st, engine)
    assert not os.path.exists(local_model_path(iid))
    raw = pickle.loads(st.get_model_data_models().get(iid).models)
    assert type(raw[0]) is _Declining and raw[0].weights == (3.0, 4.0)


def test_manifests_cross_the_packages(st, tmp_path):
    """A manifest the JAX package wrote loads as the port's, and one that
    names a class of the JAX package deploys through the port's twin of
    that class (``port_path``)."""
    jblob = jmodel_io.serialize_models([jpm.PersistentModelManifest(
        class_name="LocalFileSystemPersistentModel",
        module_name="predictionio_tpu.controller.persistent_model")])
    (manifest,) = model_io.deserialize_models(jblob)
    assert type(manifest) is PersistentModelManifest
    saved = SelfSavingModel(weights=(5.0, 6.0))
    assert saved.save("iid-x", None, None)
    (out,) = create_server.prepare_deploy(
        WorkflowContext(storage=st, device="cpu"), _engine(),
        EngineParams(algorithm_params_list=(("algo", _AlgoParams()),)),
        "iid-x", [manifest])
    assert out == saved
    # the JAX package's manifest class and the port's keep one layout
    assert [f.name for f in dataclasses.fields(PersistentModelManifest)] \
        == [f.name for f in dataclasses.fields(jpm.PersistentModelManifest)]


def test_prepare_deploy_retrains_a_missing_model(st):
    ep = EngineParams(algorithm_params_list=(("algo", _AlgoParams(9.0)),))
    (out,) = create_server.prepare_deploy(
        WorkflowContext(storage=st, device="cpu"), _engine(), ep, "iid-y",
        [None])
    assert out == SelfSavingModel(weights=(9.0, 2.0))
