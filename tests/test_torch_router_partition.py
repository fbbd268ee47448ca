"""Partition-routed serving on the port: ``parse_partition``,
``partition_rows`` and ``merge_candidates`` against the reference's, a
partition replica's answers (with their global item indices) byte for
byte as the reference's partition replica answers on the int8 path, a
two- and a three-partition fleet behind the port's router answering
byte-identically to a full replica at every ``num`` (ties across the
partition boundary included), a gap in coverage answering 503, and
``--partition`` refused with ``--engines``. Every server binds port 0."""

import json

import numpy as np
import pytest

from predictionio_tpu.data.storage import Storage as JStorage
from predictionio_tpu.parallel import serve_dist as ref_dist
from predictionio_tpu.workflow import create_server as jserver
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.parallel import serve_dist
from predictionio_tpu_torch.serving.registry import TenantSpec
from predictionio_tpu_torch.workflow.create_server import (
    QueryAPI, ServerConfig,
)

import torch_deploy_util as util
import torch_fleet_util as fleet

N_ITEMS = 40


@pytest.fixture(autouse=True)
def _int8(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED", "on")
    for name in ("PIO_DEPLOY_PARTITION", "PIO_TRACE", "PIO_TELEMETRY",
                 "PIO_ROUTER_CACHE"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("spec", ["0/1", "0/2", "1/2", " 2/3 ", "3/4",
                                  "2/2", "-1/2", "1", "a/b", "0/0"])
def test_parse_partition_as_the_reference(spec):
    try:
        want = ref_dist.parse_partition(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            serve_dist.parse_partition(spec)
        return
    assert serve_dist.parse_partition(spec) == want


@pytest.mark.parametrize("n,count", [(40, 2), (40, 3), (26744, 2),
                                     (7, 4), (1, 3)])
def test_partition_rows_tile_the_catalog_as_the_reference(n, count):
    rows = [serve_dist.partition_rows(n, i, count) for i in range(count)]
    assert rows == [ref_dist.partition_rows(n, i, count)
                    for i in range(count)]
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    sizes = [hi - lo for lo, hi in rows]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("k", [1, 5, 17, 40])
def test_merge_candidates_as_the_reference(k):
    rng = np.random.default_rng(11)
    v = rng.integers(-4, 5, size=40).astype(np.float32) / 4   # many ties
    g = rng.permutation(40).astype(np.int32)
    got = serve_dist.merge_candidates(v, g, k)
    want = ref_dist.merge_candidates(v, g, k)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _ref_partition_api(blob, partition):
    js = JStorage(env=util.MEM)
    iid = js.get_meta_data_engine_instances().insert(util._instance(
        util.JEngineInstance,
        "predictionio_tpu.models.recommendation.engine:"
        "RecommendationEngine"))
    js.get_model_data_models().insert(util.JModel(iid, blob))
    return jserver.QueryAPI(storage=js, config=jserver.ServerConfig(
        serve_quant="on", aot="off", batching="on", batch_max_delay_ms=1.0,
        partition=partition))


@pytest.mark.parametrize("partition", ["0/2", "1/2", "2/3"])
def test_a_partition_replica_answers_as_the_reference(partition):
    """Its answer (the local top-k and the global indices block), its
    /readyz partition block and its GET / partition block."""
    blob = fleet.tied_blob()
    japi = _ref_partition_api(blob, partition)
    tapi = fleet.query_api(fleet.store_with(blob), partition=partition)
    try:
        for user, num in (("u1", 3), ("u5", 10), ("u7", 40)):
            body = fleet.util.query(user, num)
            want = japi.handle("POST", "/queries.json", body=body)
            got = tapi.handle("POST", "/queries.json", body=body)
            assert got[0] == want[0] == 200
            assert json.dumps(got[1]) == json.dumps(want[1])
        assert tapi.handle("GET", "/readyz")[1]["partition"] == \
            japi.handle("GET", "/readyz")[1]["partition"]
        assert tapi.handle("GET", "/")[1]["partition"] == \
            japi.handle("GET", "/")[1]["partition"]
    finally:
        japi.close()
        tapi.close()


@pytest.mark.parametrize("count", [2, 3])
def test_the_partition_fleet_answers_as_a_full_replica(count):
    """Users whose top-k holds exact ties that straddle the partition
    boundary, at num 3, 10 and the whole catalog: the router's merged
    bytes equal a full replica's, and each query runs one flush on
    every partition replica."""
    blob = fleet.tied_blob()
    storage = fleet.store_with(blob)
    full = fleet.query_api(storage)
    parts = [fleet.query_api(storage, partition=f"{i}/{count}")
             for i in range(count)]
    servers = [fleet.serve(p, "async") for p in parts]
    r, sr, pr = fleet.router([p for _, p in servers])
    try:
        fleet.wait_for(lambda: r.handle("GET", "/")[1].get(
            "partitions", {}).get("complete"))
        lo_hi = [p._partition_state for p in parts]
        assert [(s["lo"], s["hi"]) for s in lo_hi] == [
            serve_dist.partition_rows(N_ITEMS, i, count)
            for i in range(count)]
        crossing = 0
        for u in range(0, 24, 2):
            for num in (3, 10, N_ITEMS):
                body = fleet.util.query(f"u{u}", num)
                want = json.dumps(
                    full.handle("POST", "/queries.json", body=body)[1])
                status, got, _ = fleet.post(pr, body)
                assert status == 200
                assert got == want.encode(), (u, num)
                scores = json.loads(got)["itemScores"]
                ids = [int(e["item"][1:]) for e in scores]
                vals = [e["score"] for e in scores]
                for j in range(1, len(vals)):
                    if vals[j] == vals[j - 1] and any(
                            (ids[j - 1] < s["lo"]) != (ids[j] < s["lo"])
                            for s in lo_hi[1:]):
                        crossing += 1
        assert crossing > 0      # the data really ties across partitions
        flushes = [p._batcher.stats()["batches"] for p in parts]
        fleet.post(pr, fleet.util.query("u0", 5))
        assert [p._batcher.stats()["batches"] for p in parts] == \
            [f + 1 for f in flushes]
    finally:
        fleet.stop(sr, *(s for s, _ in servers))
        r.close()
        full.close()
        for p in parts:
            p.close()


def test_a_gap_in_coverage_answers_503_never_a_partial_merge():
    storage = fleet.store_with(fleet.tied_blob())
    parts = [fleet.query_api(storage, partition=f"{i}/2") for i in range(2)]
    servers = [fleet.serve(p) for p in parts]
    r, sr, pr = fleet.router([p for _, p in servers])
    try:
        fleet.wait_for(lambda: r.handle("GET", "/")[1].get(
            "partitions", {}).get("complete"))
        fleet.stop(servers[1][0])
        fleet.wait_rotation(r, 1)
        status, _, headers = fleet.post(pr, fleet.util.query("u1", 4))
        assert status == 503 and headers["retry-after"]
    finally:
        fleet.stop(sr, servers[0][0])
        r.close()
        for p in parts:
            p.close()


def test_the_partition_variable_scopes_a_deploy(monkeypatch):
    monkeypatch.setenv("PIO_DEPLOY_PARTITION", "1/2")
    api = fleet.query_api(fleet.store_with(fleet.tied_blob()))
    try:
        assert api.handle("GET", "/readyz")[1]["partition"] == {
            "index": 1, "count": 2, "lo": 20, "hi": 40, "rows": 20,
            "nItems": 40}
    finally:
        api.close()


def test_partition_is_refused_with_engines():
    with pytest.raises(ValueError, match="does not compose") as got:
        QueryAPI(storage=Storage(env=util.MEM), config=ServerConfig(
            device="cpu", partition="0/2", tenants=(TenantSpec("shop"),)))
    with pytest.raises(ValueError) as want:
        jserver.QueryAPI(storage=JStorage(env=util.MEM),
                         config=jserver.ServerConfig(
                             partition="0/2", tenants=("shop",)))
    assert str(got.value) == str(want.value)
