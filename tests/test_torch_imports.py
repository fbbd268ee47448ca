"""The PyTorch port stands alone: no port module (the CLI included), and
not chip_smoke.py, imports jax or any module of the JAX package; an
engine instance stored under the JAX package's factory name deploys in
the port without importing it; and the device policy refuses the card
where there is none."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from predictionio_tpu_torch import device
from predictionio_tpu_torch.workflow import workflow_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

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
""")

_PROBE = _BLOCK + textwrap.dedent("""
    import predictionio_tpu_torch as pkg
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
        names.append(info.name)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print(len(names))
""")


def _run_blocked(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def test_port_imports_nothing_of_jax_or_the_jax_package():
    names = _run_blocked(_PROBE)
    # every module of both slices was walked, not an empty package
    assert int(names[-1]) >= 45


_DEPLOY_JAX_FACTORY = _BLOCK + textwrap.dedent("""
    import datetime as dt, json
    import numpy as np
    from predictionio_tpu_torch.data.storage import (
        EngineInstance, Model, Storage)
    from predictionio_tpu_torch.workflow import create_server, model_io

    rng = np.random.default_rng(0)
    m = model_io.als_model_from_numpy(
        3, rng.normal(size=(4, 3)), rng.normal(size=(6, 3)),
        {f"u{i}": i for i in range(4)}, {f"i{i}": i for i in range(6)})
    store = Storage(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"})
    now = dt.datetime.now(dt.timezone.utc)
    iid = store.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="NOT_USED",
        engine_variant="default",
        engine_factory=("predictionio_tpu.models.recommendation.engine:"
                        "RecommendationEngine"),
        data_source_params=json.dumps({"params": {"appName": "A"}}),
        algorithms_params=json.dumps([{"name": "als", "params": {
            "rank": 3}}])))
    store.get_model_data_models().insert(
        Model(iid, model_io.serialize_models([m])))
    api = create_server.QueryAPI(create_server.ServerConfig(
        device="cpu", serve_quant="off", batching="off"), storage=store)
    status, payload = api.handle("POST", "/queries.json",
                                 body=b'{"user": "u1", "num": 2}')
    assert status == 200 and len(payload["itemScores"]) == 2, payload
    assert type(api.engine).__module__.startswith("predictionio_tpu_torch")
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("ok")
""")


def test_instance_under_the_jax_factory_deploys_with_jax_blocked():
    assert _run_blocked(_DEPLOY_JAX_FACTORY)[-1] == "ok"


def test_factory_paths_map_to_the_port():
    assert workflow_utils.port_path(
        "predictionio_tpu.models.recommendation.engine:RecommendationEngine"
    ) == ("predictionio_tpu_torch.models.recommendation.engine:"
          "RecommendationEngine")
    assert workflow_utils.port_path("my_engine.engine:Factory") == \
        "my_engine.engine:Factory"
    engine = workflow_utils.get_engine(
        "predictionio_tpu.models.recommendation.engine.RecommendationEngine")
    assert type(engine).__module__ == \
        "predictionio_tpu_torch.controller.engine"


@pytest.mark.parametrize("path,missing", [
    ("predictionio_tpu.models.similarproduct.engine:SimilarProductEngine",
     "predictionio_tpu_torch.models.similarproduct.engine:"
     "SimilarProductEngine"),
    ("predictionio_tpu.models.recommendation.engine:NoSuchEngine",
     "predictionio_tpu_torch.models.recommendation.engine:NoSuchEngine"),
])
def test_factory_without_a_counterpart_is_named(path, missing):
    with pytest.raises(ValueError, match="no counterpart") as err:
        workflow_utils.get_engine(path)
    assert missing in str(err.value)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve()      # the default is the card


def test_cpu_is_asked_for_explicitly(monkeypatch):
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    assert device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    assert device.resolve() == torch.device("cpu")
    # an explicit argument wins over the environment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve("cuda")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
