"""The port router's front-door response cache (``_ResponseCache``,
``PIO_ROUTER_CACHE*``) against the reference's: the same operations on
the LRU give the same answers and counts (hits, misses, TTL and budget
evictions, oversize bodies never stored, per-tenant invalidation), and
through a live router a hot key is answered without touching the port
replica, with the replica's own bytes, until the replica's ``/reload``
moves its generation and invalidates the entry. Every server binds
port 0."""

import json
import time

import pytest

from predictionio_tpu.workflow import router as ref_router
from predictionio_tpu_torch.common import journal
from predictionio_tpu_torch.workflow import router as port_router

import torch_fleet_util as fleet

PACKAGES = {"port": port_router, "ref": ref_router}


@pytest.fixture(autouse=True)
def _int8_plain(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    monkeypatch.delenv("PIO_ROUTER_CACHE", raising=False)


def _lru_script(mod):
    """A fixed run over one package's cache: what each step returned."""
    out = []
    cache = mod._ResponseCache(max_bytes=256, ttl_s=60.0)
    out.append(cache.get(("t", ("s", 1), b"q1")))
    out.append(cache.put(("t", ("s", 1), b"q1"), 200,
                         {"itemScores": []}, None))
    out.append(cache.get(("t", ("s", 1), b"q1")))
    out.append(cache.get(("t", ("s", 2), b"q1")))     # another generation
    out.append(sum(cache.put(("t", ("s", 1), b"q%d" % n), 200,
                             {"itemScores": [], "n": n}, None)
                   for n in range(2, 30)))
    out.append(cache.get(("t", ("s", 1), b"q1")))     # aged out
    st = cache.stats()
    out.append({k: v for k, v in st.items() if k != "hitRatio"})
    big = mod._ResponseCache(max_bytes=64, ttl_s=60.0)
    big.put(("t", ("s", 1), b"q"), 200, {"pad": "x" * 500}, None)
    out.append(big.stats()["entries"])
    return out


def test_the_lru_answers_as_the_reference():
    got, want = _lru_script(port_router), _lru_script(ref_router)
    assert got == want
    assert got[0] is None and got[2][0] == 200 and got[3] is None
    assert got[4] > 0 and got[5] is None and got[7] == 0
    assert got[6]["bytes"] <= 256 and got[6]["evictions"] == got[4]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ttl_expiry_counts_as_an_eviction(pkg):
    cache = PACKAGES[pkg]._ResponseCache(max_bytes=1 << 20, ttl_s=0.05)
    cache.put(("t", ("s", 1), b"q"), 200, {"a": 1}, None)
    assert cache.get(("t", ("s", 1), b"q")) is not None
    time.sleep(0.08)
    assert cache.get(("t", ("s", 1), b"q")) is None
    st = cache.stats()
    assert (st["entries"], st["evictions"], st["misses"], st["hits"]) == (
        0, 1, 1, 1)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_invalidating_a_tenant_drops_only_its_entries(pkg):
    cache = PACKAGES[pkg]._ResponseCache(max_bytes=1 << 20, ttl_s=60.0)
    cache.put(("shop", ("t", 1), b"a"), 200, {"s": 1}, None)
    cache.put(("shop", ("t", 1), b"b"), 200, {"s": 2}, None)
    cache.put(("news", ("t", 1), b"a"), 200, {"n": 1}, None)
    assert cache.invalidate_tenant("shop") == 2
    assert cache.get(("shop", ("t", 1), b"a")) is None
    assert cache.get(("news", ("t", 1), b"a")) is not None
    assert cache.stats()["evictions"] == 2


@pytest.mark.parametrize("value,on", [("on", True), ("off", False),
                                      ("1", True), ("", False)])
def test_the_cache_switch_reads_as_the_reference(monkeypatch, value, on):
    monkeypatch.setenv("PIO_ROUTER_CACHE", value)
    for mod in PACKAGES.values():
        cfg = mod.RouterConfig(backends=("http://127.0.0.1:1",)).resolved()
        assert cfg.cache_on is on


def test_a_hot_key_skips_the_replica_until_its_reload():
    """Through a live router over a port replica: the second and third
    identical queries are answered at the front door with the first
    answer's bytes and the replica's request count stands still; a
    reload of the replica (a new instance) moves its generation, the
    entry is invalidated and journaled, and the next answer is the new
    model's."""
    storage = fleet.store_with(fleet.tied_blob(seed=1))
    api = fleet.query_api(storage)
    server, port = fleet.serve(api)
    r, sr, pr = fleet.router([port], cache="on", cache_mb=1,
                             cache_ttl_ms=60_000.0)
    try:
        fleet.wait_rotation(r, 1)
        body = fleet.util.query("u3", 5)
        first = fleet.post(pr, body)
        assert first[0] == 200
        assert first[1] == json.dumps(
            api.handle("POST", "/queries.json", body=body)[1]).encode()
        served = api.request_count
        for _ in range(2):
            assert fleet.post(pr, body)[:2] == first[:2]
        assert api.request_count == served
        st = r.handle("GET", "/")[1]["cache"]
        assert st["enabled"] and st["entries"] == 1 and st["hits"] == 2
        # a non-200 is never stored
        assert fleet.post(pr, b"{bad")[0] == 400
        assert r.handle("GET", "/")[1]["cache"]["entries"] == 1

        seq = journal.snapshot()["lastSeq"]
        fleet.add_instance(storage, fleet.tied_blob(seed=2), minute=1)
        api.reload_async().join(fleet.TIMEOUT_S)
        fleet.wait_for(lambda: r.handle("GET", "/")[1]["cache"][
            "evictions"] >= 1)
        status, data, _ = fleet.post(pr, body)
        assert status == 200 and data != first[1]
        assert data == json.dumps(
            api.handle("POST", "/queries.json", body=body)[1]).encode()
        msgs = [e["message"] for e in journal.snapshot(since_seq=seq)
                ["events"] if e["category"] == "router"]
        assert any("response cache invalidated" in m for m in msgs), msgs
    finally:
        fleet.stop(sr, server)
        r.close()
        api.close()


def test_cache_off_adds_nothing_to_the_status():
    storage = fleet.store_with(fleet.tied_blob())
    api = fleet.query_api(storage)
    server, port = fleet.serve(api)
    r, sr, pr = fleet.router([port])
    try:
        fleet.wait_rotation(r, 1)
        body = fleet.util.query("u1", 3)
        assert fleet.post(pr, body)[0] == fleet.post(pr, body)[0] == 200
        assert api.request_count == 2
        assert "cache" not in r.handle("GET", "/")[1]
    finally:
        fleet.stop(sr, server)
        r.close()
        api.close()
