"""The PyTorch port stands alone: no port module (the CLI included), and
not chip_smoke.py, imports jax or any module of the JAX package; an
engine instance stored under the JAX package's factory name deploys in
the port without importing it; ``pio eval`` runs through the port's CLI
with both blocked; and the device policy refuses the card where there is
none."""

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
    for name in names:
        print(name)
    print(len(names))
""")

#: the event server, the app and key lifecycle and import/export, with the
#: host-only modules they keep their own copies of
EVENT_SLICE = [
    "predictionio_tpu_torch.common.plugin_registry",
    "predictionio_tpu_torch.common.server_security",
    "predictionio_tpu_torch.data.api.http",
    "predictionio_tpu_torch.data.api.plugins",
    "predictionio_tpu_torch.data.api.service",
    "predictionio_tpu_torch.data.api.stats",
    "predictionio_tpu_torch.data.webhooks",
    "predictionio_tpu_torch.data.webhooks.examples",
    "predictionio_tpu_torch.data.webhooks.mailchimp",
    "predictionio_tpu_torch.data.webhooks.segmentio",
    "predictionio_tpu_torch.tools.admin",
    "predictionio_tpu_torch.tools.apps",
    "predictionio_tpu_torch.tools.dashboard",
    "predictionio_tpu_torch.tools.transfer",
]

#: the classification, similar-product and e-commerce templates, with the
#: store reads, NB, the k-fold splitter and the degraded flag they need
TEMPLATE_SLICE = [
    "predictionio_tpu_torch.common.resilience",
    "predictionio_tpu_torch.data.aggregate",
    "predictionio_tpu_torch.e2",
    "predictionio_tpu_torch.e2.evaluation",
    "predictionio_tpu_torch.models.classification",
    "predictionio_tpu_torch.models.classification.data_source",
    "predictionio_tpu_torch.models.classification.engine",
    "predictionio_tpu_torch.models.classification.nb_algorithm",
    "predictionio_tpu_torch.models.classification.random_forest",
    "predictionio_tpu_torch.models.ecommerce",
    "predictionio_tpu_torch.models.ecommerce.als_algorithm",
    "predictionio_tpu_torch.models.ecommerce.data_source",
    "predictionio_tpu_torch.models.ecommerce.engine",
    "predictionio_tpu_torch.models.similarproduct",
    "predictionio_tpu_torch.models.similarproduct.als_algorithm",
    "predictionio_tpu_torch.models.similarproduct.data_source",
    "predictionio_tpu_torch.models.similarproduct.engine",
    "predictionio_tpu_torch.ops.naive_bayes",
]


#: the observability slice: the metrics registry, traces, the journal,
#: latency waterfalls, the device watch, on-demand profiling and `pio
#: profile`
OBSERVABILITY_SLICE = [
    "predictionio_tpu_torch.common.devicewatch",
    "predictionio_tpu_torch.common.journal",
    "predictionio_tpu_torch.common.profiling",
    "predictionio_tpu_torch.common.telemetry",
    "predictionio_tpu_torch.common.tracing",
    "predictionio_tpu_torch.common.waterfall",
    "predictionio_tpu_torch.tools.profile",
]


#: the storage and read path at scale, with the SLO engine and the
#: metrics history every daemon installs
STORE_SLICE = [
    "predictionio_tpu_torch.common.history",
    "predictionio_tpu_torch.common.slo",
    "predictionio_tpu_torch.data.storage.eventlog",
    "predictionio_tpu_torch.ops.staging",
]


#: the realtime fold-in, hot reload and the warm-up before ready
FOLDIN_SLICE = [
    "predictionio_tpu_torch.realtime",
    "predictionio_tpu_torch.realtime.foldin",
    "predictionio_tpu_torch.serving.aot",
]


#: remote storage with retries, the circuit breaker and fault
#: injection, the object-store models and the operator tools
REMOTE_SLICE = [
    "predictionio_tpu_torch.common.resilience",
    "predictionio_tpu_torch.common.traceview",
    "predictionio_tpu_torch.data.storage.remote",
    "predictionio_tpu_torch.data.storage.s3",
    "predictionio_tpu_torch.tools.doctor",
    "predictionio_tpu_torch.tools.incident",
    "predictionio_tpu_torch.tools.monitor",
]


#: block-sharded training and row-sharded serving on torch.distributed
PARALLEL_SLICE = [
    "predictionio_tpu_torch.parallel",
    "predictionio_tpu_torch.parallel.als_dist",
    "predictionio_tpu_torch.parallel.mesh",
    "predictionio_tpu_torch.parallel.serve_dist",
]


#: continuous training and the fleet autopilot
CONTROL_SLICE = [
    "predictionio_tpu_torch.workflow.autopilot",
    "predictionio_tpu_torch.workflow.autotrain",
]


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
    # every module of the slices was walked, not an empty package
    assert int(names[-1]) == len(names) - 1 >= 110
    assert set(EVENT_SLICE) <= set(names[:-1])
    assert set(TEMPLATE_SLICE) <= set(names[:-1])
    assert set(OBSERVABILITY_SLICE) <= set(names[:-1])
    assert set(STORE_SLICE) <= set(names[:-1])
    assert set(FOLDIN_SLICE) <= set(names[:-1])
    assert set(REMOTE_SLICE) <= set(names[:-1])
    assert set(PARALLEL_SLICE) <= set(names[:-1])
    assert set(CONTROL_SLICE) <= set(names[:-1])


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


_EVAL_CLI = _BLOCK + textwrap.dedent("""
    import datetime as dt, json, os, sys
    import numpy as np
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.tools import cli

    work = sys.argv[1]
    storage = Storage()               # SQLite under PIO_FS_BASEDIR
    app_id = storage.get_meta_data_apps().insert(App(0, "EvalApp"))
    storage.get_events().init(app_id)
    rng = np.random.default_rng(0)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    store.write([Event(
        event="rate", entity_type="user", entity_id=f"u{rng.integers(20)}",
        target_entity_type="item", target_entity_id=f"i{rng.integers(15)}",
        properties=DataMap({"rating": float(rng.integers(1, 11)) / 2}),
        event_time=t0 + dt.timedelta(seconds=k)) for k in range(300)],
        app_id, storage=storage)
    with open(os.path.join(work, "grid.py"), "w") as f:
        f.write(
            "from predictionio_tpu_torch.controller import EngineParamsGenerator\\n"
            "from predictionio_tpu_torch.models.recommendation.evaluation "
            "import engine_params_list\\n"
            "class Grid(EngineParamsGenerator):\\n"
            "    def __init__(self):\\n"
            "        self.engine_params_list = [ep for ep in engine_params_list("
            "'EvalApp', k_fold=2, query_num=5)\\n"
            "            if ep.algorithm_params_list[0][1].numIterations == 1]\\n")
    best = os.path.join(work, "best.json")
    rc = cli.main(["eval", "predictionio_tpu.models.recommendation."
                   "evaluation:RecommendationEvaluation", "grid:Grid",
                   "--engine-dir", work, "--output-best-engine-params",
                   best])
    assert rc == 0, rc
    (row,) = Storage().get_meta_data_evaluation_instances().get_all()
    assert row.status == "EVALCOMPLETED", row.status
    assert "Precision@K" in json.loads(row.evaluator_results_json)[
        "metricHeader"]
    with open(best) as f:
        assert json.load(f)["algorithms"][0]["params"]["numIterations"] == 1
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("ok")
""")


def test_pio_eval_through_the_cli_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PIO_FS_BASEDIR=str(tmp_path / "store"),
               PIO_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _EVAL_CLI, str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert "MetricEvaluatorResult" in proc.stdout


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
    for template, factory in (
            ("classification", "ClassificationEngine"),
            ("similarproduct", "SimilarProductEngine"),
            ("ecommerce", "ECommerceEngine")):
        engine = workflow_utils.get_engine(
            f"predictionio_tpu.models.{template}.engine:{factory}")
        assert engine.data_source_class.__module__ == \
            f"predictionio_tpu_torch.models.{template}.data_source"


@pytest.mark.parametrize("path,missing", [
    ("predictionio_tpu.examples.dimsum:engine",
     "predictionio_tpu_torch.examples.dimsum:engine"),
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
