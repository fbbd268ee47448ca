"""The port's table of the reference's environment variables
(``predictionio_tpu_torch/knobs.py``) against the port's registry and the
reference's declarations, the refusal machinery for a variable that asks
for a feature the port lacks (at the CLI's verbs and at ``QueryAPI``
construction; no row is refused since the host-vs-device serving probe
landed, so a stand-in row drives it), and the variables that the port
reads."""

import re

import pytest

from predictionio_tpu.common.declarations import ENV_VARS
from predictionio_tpu_torch import knobs
from predictionio_tpu_torch.common import declarations
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.create_server import (
    QueryAPI, ServerConfig,
)
from torch_deploy_util import port_cli  # noqa: F401 (fixture)

#: every test starts and ends with the port's storage singleton dropped
#: and the CLI's environment writes registered for undoing
pytestmark = pytest.mark.usefixtures("port_cli")

MEM = {
    "PIO_STORAGE_SOURCES_M_TYPE": "memory",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
}

UNPORTED = sorted(name for name, k in knobs.KNOBS.items()
                  if k.kind == knobs.UNPORTED)

#: a stand-in unported row for the refusal machinery, which stays for any
#: later row, and values that turn its feature on, as an operator would
#: set them
STAND_IN = "PIO_STAND_IN_FEATURE"
REFUSED = {STAND_IN: ["3.0", "0.5"]}


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setitem(knobs.KNOBS, STAND_IN, knobs._unported(
        "a stand-in feature", "queue 9 item 9"))
    monkeypatch.delenv(STAND_IN, raising=False)
    return knobs.KNOBS[STAND_IN]


def _clear(monkeypatch):
    for name in UNPORTED:
        monkeypatch.delenv(name, raising=False)


def test_every_reference_variable_is_classified():
    # the table is the port's registry less its own names, and those are
    # the reference's
    assert set(knobs.KNOBS) == (set(declarations.ENV_VARS)
                                - declarations.PORT_ONLY)
    assert set(knobs.KNOBS) == set(ENV_VARS)
    for name, knob in knobs.KNOBS.items():
        assert knob.kind in (knobs.READ, knobs.INERT, knobs.UNPORTED), name
        assert knob.what, name
        if knob.kind == knobs.UNPORTED:
            assert knob.roadmap.startswith("queue "), name
            assert knob.verbs and set(knob.verbs) <= set(knobs.ALL_VERBS)
    # none is refused since the serving probe landed: 108 read, 10 inert
    assert UNPORTED == []
    kinds = [k.kind for k in knobs.KNOBS.values()]
    assert (kinds.count(knobs.READ), kinds.count(knobs.INERT),
            kinds.count(knobs.UNPORTED)) == (108, 10, 0)
    assert knobs.KNOBS["PIO_SERVE_DEVICE_MS"].kind == knobs.READ
    # settled: the solver variable stays unread
    assert knobs.KNOBS["PIO_ALS_SOLVER"].kind == knobs.INERT


@pytest.mark.parametrize("name,value", [
    (name, value) for name in sorted(REFUSED) for value in REFUSED[name]])
def test_unported_feature_is_refused_at_its_entry_points(
        monkeypatch, capsys, tmp_path, stand_in, name, value):
    _clear(monkeypatch)
    monkeypatch.setenv(name, value)
    knob = knobs.KNOBS[name]
    missing = str(tmp_path / "none")
    # an address no daemon can bind: a verb that failed to refuse errors
    # out at once instead of serving
    nowhere = ["--ip", "256.256.256.256"]
    argv = {knobs.TRAIN: ["train", "--engine-dir", missing],
            knobs.EVAL: ["eval", "x.Evaluation", "--engine-dir", missing],
            knobs.DEPLOY: ["deploy", "--engine-dir", missing],
            knobs.EVENTSERVER: ["eventserver", *nowhere],
            knobs.IMPORT: ["import", "--appid", "1", "--input", missing],
            knobs.EXPORT: ["export", "--appid", "1", "--output", missing],
            knobs.DASHBOARD: ["dashboard", *nowhere],
            knobs.ADMINSERVER: ["adminserver", *nowhere],
            knobs.STORAGESERVER: ["storageserver", *nowhere],
            knobs.FOLDIN: ["foldin", "--engine-dir", missing]}
    assert sorted(argv) == sorted(knobs.ALL_VERBS)
    for verb in knob.verbs:
        with pytest.raises(ValueError) as e:
            knobs.refuse_unported(verb)
        msg = str(e.value)
        assert f"{name}={value}" in msg and knob.what in msg
        assert f"ROADMAP {knob.roadmap}" in msg
        # the CLI refuses before it reads the (missing) engine directory,
        # input file or store, or binds a socket
        rc = cli.main(argv[verb])
        assert rc == 1
        assert f"{name}={value}" in capsys.readouterr().err
    if knobs.DEPLOY in knob.verbs:
        with pytest.raises(ValueError, match=re.escape(knob.roadmap)):
            QueryAPI(config=ServerConfig(device="cpu"),
                     storage=Storage(env=MEM))
    for verb in set(knobs.ALL_VERBS) - set(knob.verbs):
        knobs.refuse_unported(verb)


@pytest.mark.parametrize("name,value", [
    (STAND_IN, value) for value in (None, "0", "off", "OFF")])
def test_off_values_are_accepted(monkeypatch, stand_in, name, value):
    _clear(monkeypatch)
    if value is not None:
        monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)


def test_read_and_inert_variables_are_never_refused(monkeypatch):
    _clear(monkeypatch)
    env = {name: "1" for name, k in knobs.KNOBS.items()
           if k.kind != knobs.UNPORTED and not name.endswith("*")}
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb, env)


@pytest.mark.parametrize("value", ["0", "3.0", "0.5", "1e9"])
def test_serve_device_ms_is_read_as_the_reference_reads_it(monkeypatch,
                                                          value):
    """The row the serving probe turned from refused to read: refused at
    no verb, read as the JAX package reads it (a float threshold in ms;
    ``0`` is a threshold every probe exceeds, not "off"), and a deploy
    gets past the table to the instance lookup."""
    from predictionio_tpu_torch.models.recommendation import als_algorithm

    _clear(monkeypatch)
    monkeypatch.setenv("PIO_SERVE_DEVICE_MS", value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)       # never refused
    assert als_algorithm.serve_device_ms() == float(value)
    with pytest.raises(Exception) as e:
        QueryAPI(config=ServerConfig(device="cpu"), storage=Storage(env=MEM))
    assert "ROADMAP" not in str(e.value)


def test_accepted_deploy_reaches_the_instance_lookup(monkeypatch):
    """With every unported knob off, QueryAPI gets past the table and
    fails on the empty store instead."""
    _clear(monkeypatch)
    monkeypatch.setenv("PIO_SERVE_SHARD", "auto")
    monkeypatch.setenv("PIO_TRANSPORT", "async")
    with pytest.raises(Exception) as e:
        QueryAPI(config=ServerConfig(device="cpu"), storage=Storage(env=MEM))
    assert "ROADMAP" not in str(e.value)


def _router_config(port_side: bool):
    if port_side:
        from predictionio_tpu_torch.workflow.router import RouterConfig
    else:
        from predictionio_tpu.workflow.router import RouterConfig
    return RouterConfig(backends=("http://127.0.0.1:1",)).resolved()


def _fleet_reads(port_side: bool):
    """Each fleet row's reader in one package: the transport helpers,
    the router's resolved config, the tenants' admission limits, budget
    and cap."""
    if port_side:
        from predictionio_tpu_torch.data.api import http
        from predictionio_tpu_torch.serving import registry
    else:
        from predictionio_tpu.data.api import http
        from predictionio_tpu.serving import registry

    def limits():
        ctl = registry.AdmissionController(None, {})
        return ctl._limits_for("t")

    def budget():
        spec = registry.TenantSpec(name="t")
        return registry.ServableModel(
            name="t", spec=spec, instance=None, engine=None,
            engine_params=None, algorithms=[], models=[],
            serving=None).hbm_budget_mb

    def router(field):
        return lambda: getattr(_router_config(port_side), field)

    return {
        "PIO_TRANSPORT": lambda: http.transport_mode(),
        "PIO_TRANSPORT_WORKERS": http._executor_workers,
        "PIO_TRANSPORT_PIPELINE": http._pipeline_window,
        "PIO_ROUTER_HEALTH_MS": router("health_ms"),
        "PIO_ROUTER_DEADLINE_MS": router("deadline_ms"),
        "PIO_ROUTER_MAX_INFLIGHT": router("max_inflight"),
        "PIO_ROUTER_TENANT_MAX_INFLIGHT": router("tenant_max_inflight"),
        "PIO_ROUTER_CACHE": lambda: _router_config(port_side).cache_on,
        "PIO_ROUTER_CACHE_MB": router("cache_mb"),
        "PIO_ROUTER_CACHE_TTL_MS": router("cache_ttl_ms"),
        "PIO_TENANT_RATE": limits,
        "PIO_TENANT_BURST": limits,
        "PIO_TENANT_HBM_BUDGET_MB": budget,
        "PIO_TENANT_HBM_HARD_CAP_MB": lambda: registry.ModelRegistry(
        ).hard_cap_mb,
    }


#: the rows read since the async transport, the router, partitions and
#: tenants landed (they were refused or inert before), each with two
#: values an operator would set and what the port then does
FLEET_READS = {
    "PIO_TRANSPORT": [("async", "async"), ("threaded", "threaded")],
    "PIO_TRANSPORT_WORKERS": [("3", 3), ("0", None)],
    "PIO_TRANSPORT_PIPELINE": [("4", 4), ("junk", 16)],
    "PIO_ROUTER_HEALTH_MS": [("50", 50.0), ("-1", 500.0)],
    "PIO_ROUTER_DEADLINE_MS": [("750", 750.0), ("", 2000.0)],
    "PIO_ROUTER_MAX_INFLIGHT": [("8", 8), ("0", 256)],
    "PIO_ROUTER_TENANT_MAX_INFLIGHT": [("2", 2), ("x", 0)],
    "PIO_ROUTER_CACHE": [("on", True), ("off", False)],
    "PIO_ROUTER_CACHE_MB": [("4", 4), ("0", 16)],
    "PIO_ROUTER_CACHE_TTL_MS": [("100", 100.0), ("0", 5000.0)],
    "PIO_DEPLOY_PARTITION": [("1/4", None), ("0/2", None)],
    "PIO_TENANT_RATE": [("100", (100.0, 200.0)), ("2.5", (2.5, 5.0))],
    "PIO_TENANT_BURST": [("7", (0.0, 7.0)), ("0", (0.0, 1.0))],
    "PIO_TENANT_HBM_BUDGET_MB": [("512", 512.0), ("", None)],
    "PIO_TENANT_HBM_HARD_CAP_MB": [("4096", 4096.0), ("junk", None)],
}


@pytest.mark.parametrize("name,value,want", [
    (name, value, want) for name in sorted(FLEET_READS)
    for value, want in FLEET_READS[name]])
def test_fleet_variables_are_read_at_their_entry_points(
        monkeypatch, name, value, want):
    """Each row turned from refused or inert to read: never refused, and
    read by the port as the reference reads it."""
    from predictionio_tpu_torch.serving.registry import TenantSpec

    _clear(monkeypatch)
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)       # never refused
    if name == "PIO_DEPLOY_PARTITION":
        # the deploy reads it: a partition scope cannot host tenants
        with pytest.raises(ValueError, match="single-engine deploy"):
            QueryAPI(config=ServerConfig(device="cpu",
                                         tenants=(TenantSpec(name="a"),)),
                     storage=Storage(env=MEM))
        return
    if name == "PIO_TRANSPORT_WORKERS" and want is None:
        import os
        want = min(32, (os.cpu_count() or 1) * 4)
    got = _fleet_reads(True)[name]()
    assert got == want == _fleet_reads(False)[name]()
    if name == "PIO_TRANSPORT":
        # every daemon builds its server on the transport the row names
        from predictionio_tpu_torch.data.api import http
        server = http.make_server(object(), "127.0.0.1", 0)
        try:
            assert (type(server).__name__ == "AsyncHTTPServer") is (
                value == "async")
        finally:
            server.server_close()
            if value == "async":
                server._sock.close()


@pytest.mark.parametrize("verb", ["eventserver", "dashboard",
                                  "adminserver", "storageserver"])
def test_a_misspelt_transport_fails_the_daemon(monkeypatch, capsys, verb):
    """PIO_TRANSPORT is read where each daemon builds its server: a value
    that names no transport exits 1 before anything is served."""
    _clear(monkeypatch)
    monkeypatch.setenv("PIO_TRANSPORT", "asynch")
    assert cli.main([verb, "--ip", "127.0.0.1", "--port", "0"]) == 1
    assert "PIO_TRANSPORT must be 'threaded' or 'async'" in \
        capsys.readouterr().err


#: PIO_SERVE_SHARD since sharded serving landed: each value an operator
#: might set, and the mode it resolves to (None: refused as malformed)
SERVE_SHARD_READS = {"1": "on", "on": "on", "On": "on", "0": "off",
                     "off": "off", "OFF": "off", "auto": "auto",
                     "AUTO": "auto", "sometimes": None}


@pytest.mark.parametrize("value", sorted(SERVE_SHARD_READS))
def test_serve_shard_is_read_as_the_reference_reads_it(monkeypatch, value):
    from predictionio_tpu.parallel import serve_dist as jsd
    from predictionio_tpu_torch.parallel import serve_dist

    _clear(monkeypatch)
    assert knobs.KNOBS["PIO_SERVE_SHARD"].kind == knobs.READ
    monkeypatch.setenv("PIO_SERVE_SHARD", value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)       # never refused
    want = SERVE_SHARD_READS[value]
    if want is None:
        with pytest.raises(ValueError, match="auto/on/off"):
            jsd.configured_mode("off")
        with pytest.raises(ValueError, match="auto/on/off"):
            serve_dist.configured_mode("off")
        return
    # the variable wins over the deploy's config, in both packages
    for config in ("on", "off", "auto", None):
        assert serve_dist.configured_mode(config) == want
        assert jsd.configured_mode(config) == want
    with serve_dist.deploy_scope("off", device="cpu"):
        assert serve_dist.serving_enabled() is (want == "on")


#: the variables this port reads since the event server and the daemons'
#: security landed, each with a value that changes what a user sees
NOW_READ = {
    "PIO_BATCH_EVENTS_MAX": "2",
    "PIO_BATCH_BULK_INSERT": "0",
    "PIO_SERVER_KEY": "tok",
    "PIO_SSL_CERTFILE": "/nonexistent/cert.pem",
    "PIO_SSL_KEYFILE": "/nonexistent/key.pem",
}


@pytest.mark.parametrize("name", sorted(NOW_READ))
def test_event_server_and_daemon_variables_are_read(monkeypatch, name):
    from predictionio_tpu_torch.common import server_security
    from predictionio_tpu_torch.data.api import service

    _clear(monkeypatch)
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, NOW_READ[name])
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)       # never refused
    if name == "PIO_BATCH_EVENTS_MAX":
        assert service.batch_events_max() == 2
    elif name == "PIO_BATCH_BULK_INSERT":
        assert service.batch_bulk_insert() is False
    elif name == "PIO_SERVER_KEY":
        assert server_security.KeyAuth().key == "tok"
    else:
        # the certificate pair is loaded, so a missing file is an error
        monkeypatch.setenv("PIO_SSL_CERTFILE", NOW_READ["PIO_SSL_CERTFILE"])
        with pytest.raises(OSError):
            server_security.ssl_context_from_env()


#: the observability variables the port reads since its telemetry,
#: tracing, journal, waterfall, devicewatch and profiling modules
#: landed, each with a value that changes what the module does, and the
#: function that shows it
def _observability_reads():
    from predictionio_tpu_torch.common import (
        devicewatch, journal, profiling, telemetry, tracing, waterfall,
    )
    return {
        "PIO_TELEMETRY": ("1", telemetry.on, True),
        "PIO_TRACE": ("1", tracing.enabled, True),
        "PIO_TRACE_BUFFER": ("64", tracing._buffer_cap, 64),
        "PIO_TRACE_TAIL_MS": ("5", tracing._tail_ms, 5.0),
        "PIO_TRACE_TAIL_TRACES": ("8", tracing._tail_cap, 8),
        "PIO_JOURNAL": ("0", journal.enabled, False),
        "PIO_JOURNAL_BUFFER": ("32", journal._buffer_cap, 32),
        "PIO_WATERFALL": ("1", waterfall.enabled, True),
        "PIO_WATERFALL_SAMPLE": ("3", waterfall._sample_every, 3),
        "PIO_SLOW_RING": ("5", waterfall._ring_cap, 5),
        "PIO_PROFILE_DIR": ("/srv/prof", profiling.base_dir, "/srv/prof"),
        "PIO_PROFILE_MAX_MS": ("250", profiling.max_ms, 250),
        "PIO_PROFILE_ENABLE": ("0", profiling.post_enabled, False),
        "PIO_SERVE_WARMUP_FLUSHES": ("4", devicewatch._warmup_flush_count,
                                     4),
    }


OBSERVABILITY = sorted(_observability_reads())


@pytest.mark.parametrize("name", OBSERVABILITY)
def test_observability_variables_are_read(monkeypatch, name):
    """The five switches and their tuning knobs are read with the
    reference's meaning and refused nowhere, and neither is PIO_HISTORY
    (the metrics flight recorder) at any daemon."""
    from predictionio_tpu_torch.common import (
        journal, telemetry, tracing, waterfall,
    )
    _clear(monkeypatch)
    for mod in (telemetry, tracing, journal, waterfall):
        monkeypatch.setattr(mod, "_override", None)
    value, read, want = _observability_reads()[name]
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    assert read() == want
    monkeypatch.setenv("PIO_HISTORY", "1")
    for verb in knobs.DAEMONS:
        knobs.refuse_unported(verb)


#: the rows read since the metrics history, the SLO engine, the eventlog
#: store and the streamed training read landed, each with a value that
#: changes what the port does, and the function that shows it
def _store_and_history_reads():
    from predictionio_tpu_torch.common import history, slo
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.storage import eventlog
    from predictionio_tpu_torch.models.recommendation import als_algorithm
    from predictionio_tpu_torch.ops import staging

    def slo_cfg(field):
        return lambda: getattr(slo.SLOConfig.from_env(), field)

    return {
        "PIO_HISTORY": ("0", history.on, False),
        "PIO_HISTORY_TICK_S": (
            "2.5", lambda: history.HistoryConfig.from_env().tick_s, 2.5),
        "PIO_HISTORY_MAX_SERIES": (
            "7", lambda: history.HistoryConfig.from_env().max_series, 7),
        "PIO_SLO_AVAILABILITY": ("0.95", slo_cfg("availability"), 0.95),
        "PIO_SLO_LATENCY_MS": ("40", slo_cfg("latency_ms"), 40.0),
        "PIO_SLO_LATENCY_TARGET": ("0.9", slo_cfg("latency_target"), 0.9),
        "PIO_SLO_FAST_WINDOW_S": ("60", slo_cfg("fast_window_s"), 60.0),
        "PIO_SLO_SLOW_WINDOW_S": ("600", slo_cfg("slow_window_s"), 600.0),
        "PIO_TRAIN_STREAM": ("on", store.train_stream_mode, "on"),
        "PIO_READ_THREADS": ("3", eventlog._read_thread_count, 3),
        "PIO_READ_OVERLAP": ("0", store._overlap_enabled, False),
        "PIO_READ_STAGE": ("0", staging.staging_available, False),
        "PIO_WAL_GROUP_MS": ("0", eventlog._wal_group_ms, 0.0),
        "PIO_WAL_FSYNC": ("always", eventlog._wal_fsync_mode, "always"),
        "PIO_ALS_LAYOUT_CACHE": (
            "0", als_algorithm._layout_cache_enabled, False),
    }


STORE_AND_HISTORY = sorted(_store_and_history_reads())


@pytest.mark.parametrize("name", STORE_AND_HISTORY)
def test_store_and_history_variables_are_read(monkeypatch, name):
    """The rows that turned from refused or inert to read: refused by no
    verb, and read with the reference's meaning."""
    from predictionio_tpu_torch.common import history
    _clear(monkeypatch)
    monkeypatch.setattr(history, "_override", None)
    value, read, want = _store_and_history_reads()[name]
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    assert read() == want


def test_eventlog_cache_and_big_layout_min_are_read(monkeypatch, tmp_path):
    """PIO_EVENTLOG_CACHE_MB bounds the eventlog's chunk-column cache and
    PIO_ALS_BIG_LAYOUT_MIN moves a train's layout between the cache
    tiers."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import eventlog
    from predictionio_tpu_torch.models.recommendation import als_algorithm
    from predictionio_tpu_torch.models.recommendation.data_source import (
        TrainingData,
    )
    from predictionio_tpu_torch.data.bimap import BiMap

    for name in ("PIO_EVENTLOG_CACHE_MB", "PIO_ALS_BIG_LAYOUT_MIN"):
        assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv("PIO_EVENTLOG_CACHE_MB", "0")
    sh = eventlog._Shard(str(tmp_path / "shard"))
    for seq in range(3):
        path = sh.chunk_path(seq)
        with open(path, "wb") as f:
            np.savez(f, event=np.zeros(4, np.int32),
                     extra_len=np.zeros(4, np.int32),
                     extra_blob=np.asarray(""))
        sh.chunk_data(seq)
    # a zero budget keeps only the newest chunk's columns
    assert list(sh.col_cache) == [2]
    td = TrainingData(
        user_idx=np.array([0, 1, 1], np.int32),
        item_idx=np.array([1, 0, 1], np.int32),
        rating=np.array([1.0, 2.0, 3.0], np.float32),
        user_vocab=BiMap({"a": 0, "b": 1}), item_vocab=BiMap({"x": 0,
                                                              "y": 1}))
    monkeypatch.setattr(als_algorithm, "_BIG_LAYOUT_CACHE", [])
    monkeypatch.setenv("PIO_ALS_BIG_LAYOUT_MIN", "2")
    als_algorithm._ensure_layout(td, torch.device("cpu"))
    assert len(als_algorithm._BIG_LAYOUT_CACHE) == 1
    assert getattr(td, "_pio_layout_cache", None) is None


#: the rows read since the realtime fold-in and the warm-up before ready
#: landed (they were refused or inert before), each with a value that
#: changes what the port does, and the function that shows it
def _foldin_and_aot_reads():
    from predictionio_tpu_torch.realtime import foldin
    from predictionio_tpu_torch.serving import aot

    return {
        "PIO_FOLDIN": ("1", foldin.enabled, True),
        "PIO_FOLDIN_TICK_MS": ("40", foldin.default_tick_ms, 40.0),
        "PIO_FOLDIN_HEADROOM": ("12", foldin.default_headroom, 12),
        "PIO_FOLDIN_MAX_EVENTS": ("32", foldin.max_events_per_user, 32),
        "PIO_FOLDIN_USER_BUCKETS": ("4,1", foldin.user_buckets, (1, 4)),
        "PIO_FOLDIN_CURSOR_DIR": ("/srv/cur", foldin.cursor_dir,
                                  "/srv/cur"),
        "PIO_FOLDIN_DRIFT_EVERY": ("0", foldin.drift_every, 0),
        "PIO_FOLDIN_DRIFT_RECALL_MIN": ("0.5", foldin.drift_recall_floor,
                                        0.5),
        "PIO_FOLDIN_ITEM_HEADROOM": ("3", foldin.default_item_headroom, 3),
        "PIO_AOT": ("1", lambda: aot.enabled("off", "cpu"), True),
    }


FOLDIN_AND_AOT = sorted(_foldin_and_aot_reads())


@pytest.mark.parametrize("name", FOLDIN_AND_AOT)
def test_foldin_and_aot_variables_are_read(monkeypatch, name):
    """PIO_FOLDIN and PIO_AOT turned from refused to read with their
    slice, and their tuning rows from inert to read: refused by no verb,
    and read with the reference's meaning."""
    _clear(monkeypatch)
    value, read, want = _foldin_and_aot_reads()[name]
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    assert read() == want


@pytest.mark.parametrize("name,value", [("PIO_AOT_KS", "5,20"),
                                        ("PIO_AOT_PRUNE", "1")])
def test_aot_shape_knobs_are_inert(monkeypatch, name, value):
    """The warm-up runs every configured bucket at one k whatever the
    reference's k set and pruning knobs say: k selects no kernel
    instantiation and a bucket only a launch's grid."""
    from predictionio_tpu_torch.serving import aot

    _clear(monkeypatch)
    assert knobs.KNOBS[name].kind == knobs.INERT
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    assert aot.serve_buckets() == (1, 4, 16, 64)
    assert aot.warm_k(100) == aot.WARM_K == 10


def _storage_server_key():
    """The key ``pio storageserver`` serves with, its server stubbed out."""
    from predictionio_tpu_torch.data.api import http

    got = []
    real = http.serve_forever
    http.serve_forever = lambda api, **kw: got.append(api)
    try:
        assert cli.main(["storageserver", "--port", "0"]) == 0
    finally:
        http.serve_forever = real
    return got[0].key


def _remote_client(**props):
    from predictionio_tpu_torch.data.storage import StorageClientConfig
    from predictionio_tpu_torch.data.storage.remote import StorageClient
    return StorageClient(StorageClientConfig(properties={
        "URL": "http://127.0.0.1:1", **props}))


def _breaker(attr):
    from predictionio_tpu_torch.common.resilience import CircuitBreaker

    def read():
        CircuitBreaker.reset_registry()
        try:
            br = CircuitBreaker.for_endpoint("knob:1")
            return br if attr is None else getattr(br, attr)
        finally:
            CircuitBreaker.reset_registry()
    return read


def _policy(attr):
    from predictionio_tpu_torch.common.resilience import RetryPolicy
    return lambda: getattr(RetryPolicy.from_env(), attr)


def _fault_rolls():
    """PIO_FAULT_SEED seeds the injector's draws (PIO_FAULT_SPEC set; the
    injector is cached per spec value, so the spec is this test's own)."""
    from predictionio_tpu_torch.common import resilience
    resilience.clear()
    return [resilience.active()._rng.random() for _ in range(3)]


#: the rows that turned from inert or refused to read with the remote
#: storage client, its retry policy, the circuit breaker and fault
#: injection, each with a value that changes what the port does, the
#: variables it needs beside it, and the function that shows it
def _remote_reads():
    import random
    seeded = random.Random(11)
    return {
        "PIO_STORAGE_SERVER_KEY": ("s3kr1t", {}, _storage_server_key,
                                   "s3kr1t"),
        "PIO_RPC_RETRIES": ("4", {}, _policy("max_attempts"), 5),
        "PIO_RPC_BACKOFF_MS": ("30", {}, _policy("base_delay_s"), 0.03),
        "PIO_RPC_BACKOFF_MAX_MS": ("700", {}, _policy("max_delay_s"), 0.7),
        "PIO_RPC_DEADLINE_MS": ("2500", {}, _policy("total_deadline_s"),
                                2.5),
        "PIO_RPC_WRITE_DEDUP": ("1", {}, lambda: _remote_client().write_dedup,
                                True),
        "PIO_RPC_POOL": ("3", {}, lambda: _remote_client()._pool._size, 3),
        "PIO_BREAKER_ENABLED": ("1", {}, lambda: _breaker(None)() is not None,
                                True),
        "PIO_BREAKER_WINDOW_S": ("12", {"PIO_BREAKER_ENABLED": "1"},
                                 _breaker("window_s"), 12.0),
        "PIO_BREAKER_ERROR_RATE": ("0.2", {"PIO_BREAKER_ENABLED": "1"},
                                   _breaker("error_threshold"), 0.2),
        "PIO_BREAKER_MIN_CALLS": ("3", {"PIO_BREAKER_ENABLED": "1"},
                                  _breaker("min_calls"), 3),
        "PIO_BREAKER_OPEN_S": ("0.25", {"PIO_BREAKER_ENABLED": "1"},
                               _breaker("open_s"), 0.25),
        "PIO_FAULT_SEED": ("11", {"PIO_FAULT_SPEC": "drop:0.25@knob-seed"},
                           _fault_rolls,
                           [seeded.random() for _ in range(3)]),
    }


REMOTE_READS = sorted(_remote_reads())


@pytest.mark.parametrize("name", REMOTE_READS)
def test_remote_storage_and_resilience_variables_are_read(monkeypatch,
                                                          name):
    """The remote client's, the breaker's and the storage server's rows
    turned from inert to read with their slice: refused by no verb, and
    read with the reference's meaning."""
    from predictionio_tpu_torch.common import resilience
    _clear(monkeypatch)
    value, beside, read, want = _remote_reads()[name]
    assert knobs.KNOBS[name].kind == knobs.READ
    monkeypatch.setenv(name, value)
    for k, v in beside.items():
        monkeypatch.setenv(k, v)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    try:
        assert read() == want
    finally:
        resilience.clear()


def test_fault_spec_is_honoured_at_every_verb(monkeypatch):
    """PIO_FAULT_SPEC turned from refused to read: no verb refuses it, and
    the transport boundary injects what it asks for (here a pre-send drop
    of every storage RPC, which an unreachable read then surfaces)."""
    from predictionio_tpu_torch.common import resilience
    _clear(monkeypatch)
    assert knobs.KNOBS["PIO_FAULT_SPEC"].kind == knobs.READ
    monkeypatch.setenv("PIO_FAULT_SPEC", "drop:1@client")
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    resilience.clear()
    try:
        inj = resilience.active()
        assert inj is not None and inj.spec == "drop:1@client"
        with pytest.raises(resilience.InjectedFault):
            _remote_client().call("apps", "get_all")
        assert inj.fired == {"drop": 2}     # the try and its one retry
    finally:
        resilience.clear()


@pytest.mark.parametrize("kind,entity", [("remote", "Apps"),
                                         ("s3", "Models")])
def test_remote_and_s3_storage_types_are_no_longer_refused(kind, entity):
    env = {"PIO_STORAGE_SOURCES_X_TYPE": kind,
           "PIO_STORAGE_SOURCES_X_URL": "http://127.0.0.1:1",
           "PIO_STORAGE_SOURCES_X_ENDPOINT": "http://127.0.0.1:1",
           "PIO_STORAGE_SOURCES_X_BUCKET_NAME": "b",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "X",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "X"}
    store = Storage(env=env)
    dao = (store.get_meta_data_apps() if entity == "Apps"
           else store.get_model_data_models())
    assert type(dao).__name__ == {"remote": "Remote",
                                  "s3": "S3"}[kind] + entity


#: the rows read since autotrain and the autopilot landed (inert before,
#: "a daemon the port has no verb for"): a value an operator would set
#: and the config field it lands in
CONTROL_READS = {
    **{f"PIO_AUTOTRAIN_{k}": (v, f) for k, v, f in (
        ("POLL_MS", "250", "poll_ms"), ("COOLDOWN_S", "60", "cooldown_s"),
        ("MAX_STALENESS_S", "3600", "max_staleness_s"),
        ("VOLUME_EVENTS", "1000", "volume_events"),
        ("LAG_EVENTS", "700", "lag_events"),
        ("TOLERANCE", "0.05", "tolerance"),
        ("PARITY_MIN", "0.4", "parity_min"), ("PROBE", "128", "probe"),
        ("PUBLISH_TIMEOUT_S", "90", "publish_timeout_s"))},
    **{f"PIO_AUTOPILOT_{k}": (v, f) for k, v, f in (
        ("POLL_MS", "200", "poll_ms"), ("COOLDOWN_S", "5", "cooldown_s"),
        ("UTIL_LOW", "0.1", "util_low"), ("UTIL_HIGH", "0.9", "util_high"),
        ("MIN_REPLICAS", "2", "min_replicas"),
        ("MAX_REPLICAS", "8", "max_replicas"),
        ("OUTLIER_X", "2.5", "outlier_x"),
        ("PROFILE_MS", "1500", "profile_ms"))},
}


@pytest.mark.parametrize("name", sorted(CONTROL_READS))
def test_autotrain_and_autopilot_variables_are_read(monkeypatch, name):
    """The 17 rows turned from inert to read: refused by no verb, and
    resolved into the loop's config as the reference resolves them."""
    from predictionio_tpu.workflow import autopilot as jautopilot
    from predictionio_tpu.workflow import autotrain as jautotrain
    from predictionio_tpu_torch.workflow import autopilot, autotrain

    _clear(monkeypatch)
    assert knobs.KNOBS[name].kind == knobs.READ
    value, field = CONTROL_READS[name]
    monkeypatch.setenv(name, value)
    for verb in knobs.ALL_VERBS:
        knobs.refuse_unported(verb)
    mods = ((autotrain.AutotrainConfig, jautotrain.AutotrainConfig)
            if "AUTOTRAIN" in name else
            (autopilot.AutopilotConfig, jautopilot.AutopilotConfig))
    got, want = (getattr(cls().resolved(), field) for cls in mods)
    assert got == want == type(got)(value)
