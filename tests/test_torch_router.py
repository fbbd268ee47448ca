"""The port's ``pio router`` (``predictionio_tpu_torch/workflow/
router.py``) over port query-server replicas on the CPU: its validation
against the reference's, health-driven membership with journal events, a
single failover when a replica dies, 503 shedding with Retry-After, 504
on a spent deadline, the coordinated ``/reload`` barrier held against
replicated deploys of each generation (zero drops, every client's
generations monotone), and trace propagation to the replica. Every
server binds port 0; no test starts a process."""

import json
import threading

import pytest

from predictionio_tpu.workflow import router as ref_router
from predictionio_tpu_torch.common import journal, tracing
from predictionio_tpu_torch.workflow import router as port_router

import torch_fleet_util as fleet


@pytest.fixture(autouse=True)
def _int8_plain(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    for name in ("PIO_TRACE", "PIO_TELEMETRY", "PIO_ROUTER_CACHE"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("url,want", [
    ("http://h:8000/", ("h", 8000)), ("h:8000", ("h", 8000)),
    ("https://sec.example:1", ValueError), ("no-port", ValueError),
    ("http://h:x", ValueError)])
def test_backend_urls_parse_as_the_reference_parses_them(url, want):
    for mod in (port_router, ref_router):
        if want is ValueError:
            with pytest.raises(ValueError):
                mod._parse_backend(url)
        else:
            assert mod._parse_backend(url) == want


@pytest.mark.parametrize("backends", [(), ("http://a:1", "http://a:1/")])
def test_an_empty_or_repeated_backend_list_is_refused(backends):
    for mod in (port_router, ref_router):
        with pytest.raises(ValueError):
            mod.RouterAPI(mod.RouterConfig(backends=backends))


def test_membership_ejects_and_readmits_with_journal_events():
    """A replica whose readiness fails leaves the rotation and comes back
    when it recovers; both moves are journal events of category
    ``router``."""
    class Gate:
        def __init__(self, api):
            self.api, self.open = api, True

        def handle(self, method, path, query=None, body=b"", headers=None):
            if path == "/readyz" and not self.open:
                return 503, {"status": "unready", "generation": 1}
            return self.api.handle(method, path, query, body, headers)

    storage = fleet.store_with(fleet.tied_blob())
    a, b = fleet.query_api(storage), fleet.query_api(storage)
    gate = Gate(b)
    sa, pa = fleet.serve(a)
    sb, pb = fleet.serve(gate)
    r, sr, pr = fleet.router([pa, pb])
    try:
        fleet.wait_rotation(r, 2)
        seq = journal.snapshot()["lastSeq"]
        gate.open = False
        fleet.wait_rotation(r, 1)
        gate.open = True
        fleet.wait_rotation(r, 2)
        msgs = [e["message"] for e in journal.snapshot(since_seq=seq)
                ["events"] if e["category"] == "router"]
        assert any("ejected from rotation" in m for m in msgs)
        assert any("re-admitted" in m for m in msgs)
        assert fleet.post(pr, fleet.util.query("u1", 3))[0] == 200
    finally:
        fleet.stop(sr, sa, sb)
        r.close()
        a.close()
        b.close()


def test_a_dead_replica_fails_over_once_and_drops_nothing():
    """One of two replicas dies between health polls: every query still
    answers 200, with the bytes of a direct query, and the router counts
    its failovers."""
    storage = fleet.store_with(fleet.tied_blob())
    a, b = fleet.query_api(storage), fleet.query_api(storage)
    sa, pa = fleet.serve(a, "async")
    sb, pb = fleet.serve(b, "async")
    r, sr, pr = fleet.router([pa, pb], health_ms=60_000.0)
    try:
        body = fleet.util.query("u2", 5)
        want = fleet.post(pa, body)[1]
        fleet.stop(sb)            # dead: the poller will not notice soon
        got = [fleet.post(pr, body) for _ in range(6)]
        assert [g[0] for g in got] == [200] * 6
        assert all(g[1] == want for g in got)
        st = r.handle("GET", "/")[1]
        assert st["failoverCount"] >= 1
        assert st["inRotation"] == 1
    finally:
        fleet.stop(sr, sa)
        r.close()
        a.close()
        b.close()


def test_no_backend_in_rotation_sheds_503_with_retry_after():
    storage = fleet.store_with(fleet.tied_blob())
    a = fleet.query_api(storage)
    sa, pa = fleet.serve(a)
    fleet.stop(sa)                # nothing listens there any more
    r = port_router.RouterAPI(port_router.RouterConfig(
        backends=(f"http://127.0.0.1:{pa}",), health_ms=50.0))
    try:
        status, payload = r.handle("GET", "/readyz")
        assert status == 503 and payload["backendsInRotation"] == 0
        out = r.handle("POST", "/queries.json",
                       body=fleet.util.query("u1", 1))
        assert out[0] == 503 and out[2]["Retry-After"]
        assert r.handle("GET", "/")[1]["shedCount"] >= 1
    finally:
        r.close()
        a.close()


def test_a_spent_deadline_answers_504_and_an_intact_one_200():
    storage = fleet.store_with(fleet.tied_blob())
    a = fleet.query_api(storage)
    sa, pa = fleet.serve(a)
    r, sr, pr = fleet.router([pa])
    try:
        fleet.wait_rotation(r, 1)
        body = fleet.util.query("u1", 3)
        assert fleet.post(pr, body, headers={"X-PIO-Deadline-Ms": "0"})[0] \
            == 504
        assert fleet.post(pr, body)[0] == 200
    finally:
        fleet.stop(sr, sa)
        r.close()
        a.close()


def test_reload_barrier_under_load_against_replicated_deploys():
    """``POST /reload`` through the router while four clients query: no
    query drops, every answer is byte-equal to a replicated deploy of
    generation 1's model or of generation 2's, and no client sees the
    old generation after the new one."""
    blob1, blob2 = fleet.tied_blob(seed=1), fleet.tied_blob(seed=2)
    storage = fleet.store_with(blob1)
    a, b = fleet.query_api(storage), fleet.query_api(storage)
    sa, pa = fleet.serve(a, "async")
    sb, pb = fleet.serve(b, "async")
    ref1, ref2 = (fleet.query_api(fleet.store_with(blob))
                  for blob in (blob1, blob2))
    r, sr, pr = fleet.router([pa, pb])
    users = [f"u{i}" for i in range(8)]
    want = {u: (ref1.handle("POST", "/queries.json",
                            body=fleet.util.query(u, 6))[1],
                ref2.handle("POST", "/queries.json",
                            body=fleet.util.query(u, 6))[1])
            for u in users}
    assert all(w1 != w2 for w1, w2 in want.values())
    stop_at = threading.Event()
    seen = {c: [] for c in range(4)}
    errors = []

    def client(c):
        n = 0
        while not stop_at.is_set() and n < 400:
            u = users[(c + n) % len(users)]
            status, data, _ = fleet.post(pr, fleet.util.query(u, 6))
            n += 1
            if status != 200:
                errors.append((status, data))
                continue
            got = json.loads(data)
            gen = (1 if got == want[u][0] else 2 if got == want[u][1]
                   else None)
            seen[c].append(gen)

    try:
        fleet.wait_rotation(r, 2)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        fleet.wait_for(lambda: all(len(v) > 5 for v in seen.values()))
        fleet.add_instance(storage, blob2, minute=1)
        assert fleet.post(pr, b"", path="/reload")[0] == 200
        fleet.wait_for(lambda: r.handle("GET", "/")[1]["reload"]
                       .get("active") is False
                       and r.handle("GET", "/")[1]["reload"].get("ok"))
        fleet.wait_for(lambda: all(2 in v[-3:] for v in seen.values()))
        stop_at.set()
        for t in threads:
            t.join(timeout=fleet.TIMEOUT_S)
            assert not t.is_alive()
        assert errors == []
        for gens in seen.values():
            assert None not in gens
            assert gens == sorted(gens)      # monotone per client
            assert gens[0] == 1 and gens[-1] == 2
        assert a.generation == b.generation == 2
    finally:
        stop_at.set()
        fleet.stop(sr, sa, sb)
        r.close()
        for api in (a, b, ref1, ref2):
            api.close()


def test_trace_header_reaches_the_replica():
    """An incoming ``X-PIO-Trace`` is propagated: the router's span and
    the replica's ``server:/queries.json`` span share its trace id."""
    storage = fleet.store_with(fleet.tied_blob())
    a = fleet.query_api(storage)
    sa, pa = fleet.serve(a)
    r, sr, pr = fleet.router([pa])
    tid = "feed000000000001"
    try:
        fleet.wait_rotation(r, 1)
        status, _, _ = fleet.post(
            pr, fleet.util.query("u1", 2),
            headers={tracing.TRACE_HEADER: f"{tid}-0000000000000001"})
        assert status == 200
        snap = tracing.snapshot(trace_id=tid)
        names = {s["name"] for t in snap["traces"] for s in t["spans"]}
        assert "server:/queries.json" in names
        services = {s.get("service") for t in snap["traces"]
                    for s in t["spans"]}
        assert {"RouterAPI", "QueryAPI"} <= services
    finally:
        fleet.stop(sr, sa)
        r.close()
        a.close()
