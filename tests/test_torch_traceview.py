"""The port's ``common/traceview.py`` (``pio trace``, ``pio events``)
against the reference's.

- Seeded span trees over three processes with skewed clocks: the same
  skew offsets, corrected starts and rendered tree, exactly.
- Recorded ``/traces.json`` and ``/debug/events.json`` payloads served to
  both packages' ``run_trace`` and ``run_events``: the same text and
  exit codes, byte for byte (assembled, not found, unreachable; level,
  category and ``since_seq`` reads; ``--follow``).
- Live, on the CPU: ``pio trace`` assembles one tree from a port query
  server and a port storage server (a ``POST /reload`` whose model read
  crosses into the storage daemon), and ``pio events`` merges the two
  daemons' journals.
"""

import datetime as dt
import io
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.common import traceview as ref_traceview
from predictionio_tpu_torch.common import journal, telemetry, tracing
from predictionio_tpu_torch.common import traceview
from predictionio_tpu_torch.tools import cli

from torch_deploy_util import RecordedDaemon, port_cli  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cli")


@pytest.fixture(autouse=True)
def _clean():
    for mod in (telemetry, tracing, journal):
        mod.set_enabled(None)
    tracing.clear()
    journal.clear()
    yield
    for mod in (telemetry, tracing, journal):
        mod.set_enabled(None)
    tracing.clear()
    journal.clear()


def _span_tree(seed: int) -> list:
    """A seeded trace over targets A -> B -> C (a query server calling a
    storage server calling another), each process's clock skewed."""
    rng = np.random.default_rng(seed)
    skew = {"A": 0.0, "B": float(rng.uniform(-5e3, 5e3)),
            "C": float(rng.uniform(-5e3, 5e3))}
    spans, k = [], 0

    def add(parent, target, name, start, dur, service):
        nonlocal k
        k += 1
        sid = f"{seed:02d}{k:014x}"
        spans.append({"spanId": sid, "parentId": parent, "name": name,
                      "service": service,
                      "startMs": round(start + skew[target], 3),
                      "durationMs": round(dur, 3), "target": target})
        return sid

    root = add(None, "A", "server:/reload", 1000.0, 80.0, "QueryAPI")
    t = 1002.0
    for j in range(int(rng.integers(2, 5))):
        dur = float(rng.uniform(2, 15))
        rpc = add(root, "A", "storage", t, dur, "127.0.0.1:7072")
        srv = add(rpc, "B", "server:/rpc", t + 0.4, dur - 0.8,
                  "StorageRPCAPI")
        if j % 2:
            add(srv, "C", "server:/rpc/model", t + 1.0, dur - 2.0,
                "StorageRPCAPI")
        t += dur + float(rng.uniform(0.5, 3))
    add(root, "A", "admission", 1001.0, 0.5, "query-server")
    order = rng.permutation(len(spans))
    return [spans[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_skew_correction_and_tree_are_the_reference(seed):
    a, b = _span_tree(seed), _span_tree(seed)
    off_a = ref_traceview.correct_skew(a)
    off_b = traceview.correct_skew(b)
    assert off_a == off_b and a == b
    assert ref_traceview.render_tree("t" * 16, a, ["slow"]) == \
        traceview.render_tree("t" * 16, b, ["slow"])
    assert traceview.render_tree("t" * 16, []) == \
        ref_traceview.render_tree("t" * 16, [])


@pytest.mark.parametrize("age", [0.0, 0.4, 59.4, 61.0, 3599.0, 3601.0,
                                 86400.0 * 3, -5.0])
def test_age_str_is_the_reference(age):
    now = 1_700_000_000.0
    assert traceview.age_str(now - age, now) == \
        ref_traceview.age_str(now - age, now)


def _recorded_journal(seed: int, n: int = 12) -> list:
    """A journal filled from a seeded sequence through the port's own
    emitter, read back as its /debug/events.json records."""
    rng = np.random.default_rng(seed)
    clock = [1_700_000_000.0 + seed]

    def tick():
        clock[0] += float(rng.uniform(0.01, 2.0))
        return clock[0]
    wall_now = journal._wall_now
    journal._wall_now = tick
    try:
        journal.set_enabled(True)
        journal.clear()
        cats = ("breaker", "lifecycle", "retry", "wal", "foldin")
        for k in range(n):
            level = ("info", "warn", "red")[int(rng.integers(3))]
            fields = {"endpoint": f"h:{k}"} if k % 3 else {}
            ctx = (tracing.new_context(f"{seed:04x}{k:012x}")
                   if k % 4 == 0 else None)
            with tracing.activate(ctx):
                journal.emit(cats[k % 5], f"event {k}", level=level,
                             **fields)
        return journal.snapshot(limit=10_000)["events"]
    finally:
        journal._wall_now = wall_now
        journal.clear()


def _both(fn_name, *args, **kw):
    """(reference, port) -> (exit code, text) of one traceview entry."""
    out = []
    for mod in (ref_traceview, traceview):
        buf = io.StringIO()
        rc = getattr(mod, fn_name)(*args, out=buf, **kw)
        out.append((rc, buf.getvalue()))
    return out


def test_recorded_trace_reads_are_the_reference():
    spans = _span_tree(7)
    traces = {}
    for target in ("A", "B", "C"):
        traces[target] = {"traceId": "ab" * 8, "pinned": ["slow"],
                          "spans": [{k: v for k, v in s.items()
                                     if k != "target"}
                                    for s in spans if s["target"] == target]}
    daemons = {t: RecordedDaemon(traces={"ab" * 8: traces[t]})
               for t in traces}
    dead = "http://127.0.0.1:9"
    try:
        urls = [daemons[t].url for t in ("A", "B", "C")]
        for targets in (urls, urls[::-1], [urls[0], dead, urls[1]]):
            ref, port = _both("run_trace", "ab" * 8, targets, timeout=2.0)
            assert ref == port and port[0] == 0
        assert "clock-skew corrected" in port[1]
        assert "unreachable" in port[1]
        ref, port = _both("run_trace", "cd" * 8, urls, timeout=2.0)
        assert ref == port and port[0] == 1
        ref, port = _both("run_trace", "ab" * 8, [dead], timeout=0.5)
        assert ref == port and port[0] == 2
    finally:
        for d in daemons.values():
            d.close()


@pytest.mark.parametrize("read", [
    {}, {"level": "warn"}, {"level": "red"}, {"category": "breaker"},
    {"since_seq": 5}, {"since_seq": 5, "level": "warn"}])
def test_recorded_event_merges_are_the_reference(read):
    a = RecordedDaemon(events=_recorded_journal(1))
    b = RecordedDaemon(events=_recorded_journal(2))
    try:
        ref, port = _both("run_events", [a.url, b.url], timeout=2.0,
                          **read)
        assert ref == port and port[0] == 0
        ref, port = _both("run_events", [a.url, "http://127.0.0.1:9", b.url],
                          follow=True, interval_s=0.01, max_polls=2,
                          timeout=1.0, **read)
        assert ref == port and port[0] == 0
        ref, port = _both("run_events", ["http://127.0.0.1:9"],
                          timeout=0.5, **read)
        assert ref == port and port[0] == 2
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# live: a port query server and a port storage server
# ---------------------------------------------------------------------------

def _fleet(tmp_path):
    """A trained instance in a port storage server, deployed by a port
    query server that reads everything through a ``remote`` source.
    Returns (query api, query server, query url, rpc server, rpc url)."""
    from predictionio_tpu_torch.data.api.http import serve_background
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.storage import App, Storage
    from predictionio_tpu_torch.data.storage.remote import serve_storage
    from predictionio_tpu_torch.models.recommendation.engine import (
        RecommendationEngine,
    )
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.create_server import (
        QueryAPI, ServerConfig,
    )

    backing = Storage(env={
        "PIO_STORAGE_SOURCES_B_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "B",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "B",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "B"})
    app_id = backing.get_meta_data_apps().insert(App(0, "FleetApp"))
    backing.get_events().init(app_id)
    backing.get_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{i}",
              properties=DataMap({"rating": float(1 + (u + i) % 5)}),
              event_time=dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc))
        for u in range(6) for i in range(5)], app_id)
    variant = {"id": "default",
               "engineFactory": "predictionio_tpu_torch.models."
                                "recommendation.engine:RecommendationEngine",
               "datasource": {"params": {"appName": "FleetApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 3, "numIterations": 2, "lambda": 0.05,
                   "seed": 1}}]}
    engine = RecommendationEngine()
    run_train(WorkflowContext(storage=backing, device="cpu"), engine,
              engine.engine_params_from_json(variant),
              engine_factory=variant["engineFactory"], params_json=variant)
    rpc_server = serve_storage(backing, host="127.0.0.1", port=0)
    rpc_port = rpc_server.server_address[1]
    remote = Storage(env={
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_SOURCES_R_URL": f"http://127.0.0.1:{rpc_port}",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R"})
    api = QueryAPI(config=ServerConfig(device="cpu", batching="on",
                                       serve_quant="off"), storage=remote)
    server, port = serve_background(api, "127.0.0.1")
    return (api, server, f"http://127.0.0.1:{port}", rpc_server,
            f"http://127.0.0.1:{rpc_port}")


def _stop(api, server, rpc_server):
    server.shutdown()
    server.server_close()
    api.close()
    rpc_server.shutdown()
    rpc_server.server_close()


def test_pio_trace_assembles_one_tree_from_two_live_daemons(tmp_path):
    """A traced ``POST /reload`` re-reads the instance and its model
    through the storage server: its spans, read back over HTTP from both
    daemons, join into ONE tree holding both services."""
    api, server, query_url, rpc_server, rpc_url = _fleet(tmp_path)
    tracing.set_enabled(True)
    try:
        gen = api.generation
        req = urllib.request.Request(f"{query_url}/reload", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.status == 200
        api._reload_thread.join(30)
        assert api.generation == gen + 1
        trace_id = next(
            t["traceId"] for t in tracing.snapshot(limit=64)["traces"]
            if any(s["name"] == "server:/reload" for s in t["spans"]))
        spans, errors, _pinned = traceview.fetch_trace(
            [query_url, rpc_url], trace_id)
        assert not errors
        traceview.correct_skew(spans)
        roots, _children = traceview._children_index(spans)
        assert [r["name"] for r in roots] == ["server:/reload"]
        names = {s["name"] for s in spans}
        assert {"server:/reload", "storage", "server:/rpc",
                "server:/rpc/model"} <= names, sorted(names)
        assert {"StorageRPCAPI", "QueryAPI"} <= {s["service"]
                                                 for s in spans}
        buf = io.StringIO()
        assert traceview.run_trace(trace_id, [query_url, rpc_url],
                                   out=buf) == 0
        assert "server:/rpc/model" in buf.getvalue()
        assert cli.main(["trace", trace_id, "--targets",
                         f"{query_url},{rpc_url}"]) == 0
        assert cli.main(["trace", "0" * 16, "--targets", query_url]) == 1
    finally:
        _stop(api, server, rpc_server)


def test_pio_events_merges_the_two_daemons_journals(tmp_path, capsys):
    api, server, query_url, rpc_server, rpc_url = _fleet(tmp_path)
    try:
        journal.set_enabled(True)
        journal.clear()
        journal.emit("breaker", "opened for ep", level=journal.RED,
                     endpoint="ep")
        journal.emit("wal", "repaired torn tail", level=journal.WARN)
        targets = [query_url, rpc_url]
        buf = io.StringIO()
        assert traceview.run_events(targets, level="warn", out=buf) == 0
        lines = buf.getvalue().splitlines()
        # one process, one journal: each record once per daemon, oldest
        # first
        assert len(lines) == 4
        assert [ln.split("] ", 1)[1].split(":")[0] for ln in lines] == [
            "breaker", "breaker", "wal", "wal"]
        assert {query_url, rpc_url} == {
            ln.split("[", 1)[1].split("]")[0] for ln in lines}
        last = journal.snapshot()["lastSeq"]
        buf = io.StringIO()
        assert traceview.run_events(targets, since_seq=last, out=buf) == 0
        assert buf.getvalue() == ""
        journal.emit("lifecycle", "gen 2 live")
        buf = io.StringIO()
        assert traceview.run_events(targets, since_seq=last, follow=True,
                                    interval_s=0.01, out=buf,
                                    max_polls=2) == 0
        assert "gen 2 live" in buf.getvalue()
        capsys.readouterr()
        assert cli.main(["events", "--targets", ",".join(targets),
                         "--level", "red"]) == 0
        assert "opened for ep" in capsys.readouterr().out
        assert cli.main(["events", "--targets", "http://127.0.0.1:9",
                         "--timeout", "0.3"]) == 2
        assert cli.main(["trace", "a" * 16, "--targets", " "]) == 1
    finally:
        _stop(api, server, rpc_server)
