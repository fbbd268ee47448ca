"""The port's two HTTP transports (``predictionio_tpu_torch/data/api/
http.py``) against the reference's: the same handler served on the
threaded and the asyncio transport of each package answers with the same
bytes (only the ``Date`` header's value is masked), keep-alive and
pipelining up to ``PIO_TRANSPORT_PIPELINE`` hold, the strict-JSON 500
and the ``@server`` fault injections (abort, truncation) come out alike,
and the async drain finishes every admitted request. Every server binds
port 0; every socket read has its own timeout."""

import json
import re
import socket
import threading
import time

import pytest

from predictionio_tpu.common import resilience as ref_resilience
from predictionio_tpu.data.api import http as ref_http
from predictionio_tpu_torch.common import resilience
from predictionio_tpu_torch.data.api import http

import torch_deploy_util as util

TIMEOUT_S = 10.0
TRANSPORTS = ("threaded", "async")


@pytest.fixture(autouse=True)
def _no_fault_leak():
    resilience.clear()
    ref_resilience.clear()
    yield
    resilience.clear()
    ref_resilience.clear()


class ShapesAPI:
    """Every payload shape the shared dispatch path serializes."""

    def handle(self, method, path, query=None, body=b"", headers=None):
        if path == "/dict":
            return 200, {"m": method, "q": query, "n": len(body)}
        if path == "/text":
            return 200, "<html>hi</html>"
        if path == "/blob":
            return 200, b"\x00\x01PIOC"
        if path == "/retry":
            return 503, {"busy": True}, {"Retry-After": "7"}
        if path == "/ctype":
            return 200, "plain text", {"Content-Type": "text/plain",
                                       "X-Extra": "yes"}
        if path == "/boom":
            raise RuntimeError("handler exploded")
        if path == "/nan":
            return 200, {"score": float("nan")}
        return 404, {"message": "Not Found"}


def _req(method, target, body=b"", headers=()):
    head = [f"{method} {target} HTTP/1.1", "Host: parity"]
    head.extend(f"{k}: {v}" for k, v in headers)
    if body:
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _read_response(f) -> bytes:
    """One response off a socket file: the head, then the body by its
    Content-Length."""
    head = b""
    clen = 0
    while True:
        line = f.readline()
        assert line, f"connection closed before the head ended: {head!r}"
        head += line
        if line in (b"\r\n", b"\n"):
            break
        if line.lower().startswith(b"content-length:"):
            clen = int(line.split(b":", 1)[1])
    return head + (f.read(clen) if clen else b"")


def _raw(port, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT_S) as sock:
        sock.sendall(request)
        with sock.makefile("rb") as f:
            return _read_response(f)


def _raw_until_close(port, request: bytes) -> bytes:
    """Everything the server sends before it closes the connection."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT_S) as sock:
        sock.sendall(request)
        out = b""
        while True:
            try:
                got = sock.recv(1 << 16)
            except ConnectionResetError:
                break
            if not got:
                break
            out += got
        return out


_DATE = re.compile(rb"Date: [^\r\n]+")


def _mask(raw: bytes) -> bytes:
    return _DATE.sub(b"Date: X", raw)


@pytest.fixture(scope="module")
def four_servers():
    """ShapesAPI on both transports of both packages:
    {(package, transport): port}."""
    api = ShapesAPI()
    servers, ports = [], {}
    for pkg, mod in (("ref", ref_http), ("port", http)):
        for transport in TRANSPORTS:
            server, p = mod.serve_background(api, "127.0.0.1",
                                             transport=transport)
            servers.append(server)
            ports[(pkg, transport)] = p
    yield ports
    for server in servers:
        server.shutdown()
        server.server_close()


PROBES = {
    "dict": _req("GET", "/dict?a=1&b="),
    "dict-post": _req("POST", "/dict", b'{"x": 1}'),
    "text": _req("GET", "/text"),
    "blob": _req("GET", "/blob"),
    "retry-after": _req("GET", "/retry"),
    "handler-ctype": _req("GET", "/ctype"),
    "handler-raise": _req("GET", "/boom"),
    "strict-json-500": _req("GET", "/nan"),
    "404": _req("GET", "/nope"),
    "put": _req("PUT", "/dict"),
    "delete": _req("DELETE", "/dict"),
}


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_both_transports_answer_as_the_reference(four_servers, probe,
                                                 transport):
    """The port on ``transport`` answers every payload shape with the
    reference's bytes on the same transport, and both transports of the
    port answer alike."""
    request = PROBES[probe]
    got = _mask(_raw(four_servers[("port", transport)], request))
    want = _mask(_raw(four_servers[("ref", transport)], request))
    assert got == want
    other = "async" if transport == "threaded" else "threaded"
    assert got == _mask(_raw(four_servers[("port", other)], request))
    if probe == "strict-json-500":
        assert got.startswith(b"HTTP/1.1 500 ")
        assert got.endswith(
            b'{"message": "response contains non-finite numbers"}')


@pytest.mark.parametrize("path", ["/retry", "/nan", "/boom", "/blob"])
def test_the_outcome_is_the_references(path):
    """``dispatch_request`` returns the reference's RequestOutcome, field
    for field."""
    out = http.dispatch_request(ShapesAPI(), "GET", path, b"", {})
    ref = ref_http.dispatch_request(ShapesAPI(), "GET", path, b"", {})
    assert http.RequestOutcome.__slots__ == ref_http.RequestOutcome.__slots__
    for field in ref_http.RequestOutcome.__slots__:
        assert getattr(out, field) == getattr(ref, field), field


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_keep_alive_serves_many_requests_on_one_connection(four_servers,
                                                           transport):
    port = four_servers[("port", transport)]
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT_S) as sock, \
            sock.makefile("rb") as f:
        for j in range(5):
            sock.sendall(_req("GET", f"/dict?j={j}"))
            raw = _read_response(f)
            assert raw.startswith(b"HTTP/1.1 200 ")
            body = raw.split(b"\r\n\r\n", 1)[1]
            assert json.loads(body)["q"] == {"j": str(j)}


def test_pipelining_is_bounded_by_the_window_and_answers_in_order(
        monkeypatch):
    """PIO_TRANSPORT_PIPELINE=2: twelve requests written back to back on
    one connection run at most two at a time, and come back complete
    and in request order though the first is the slowest."""
    monkeypatch.setenv("PIO_TRANSPORT_PIPELINE", "2")
    lock = threading.Lock()
    state = {"now": 0, "max": 0}

    class Echo:
        def handle(self, method, path, query=None, body=b"", headers=None):
            with lock:
                state["now"] += 1
                state["max"] = max(state["max"], state["now"])
            n = int(query.get("n", "0"))
            time.sleep(0.05 if n == 0 else 0.01)
            with lock:
                state["now"] -= 1
            return 200, {"n": n}

    server, port = http.serve_background(Echo(), "127.0.0.1",
                                         transport="async")
    try:
        k = 12
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=TIMEOUT_S) as sock:
            sock.sendall(b"".join(_req("GET", f"/e?n={j}")
                                  for j in range(k)))
            with sock.makefile("rb") as f:
                got = [json.loads(_read_response(f).split(
                    b"\r\n\r\n", 1)[1])["n"] for _ in range(k)]
        assert got == list(range(k))
        assert state["max"] == 2
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("spec", ["drop:1@server GET /dict",
                                  "truncate:1@server GET /dict"])
def test_fault_injection_aborts_and_truncates_alike(spec):
    """``@server`` faults on either transport: an abort sends no byte,
    a truncation sends the full Content-Length and half the body, then
    closes; both exactly as the reference's transports do."""
    resilience.install(spec)
    ref_resilience.install(spec)
    api = ShapesAPI()
    got = {}
    for pkg, mod in (("ref", ref_http), ("port", http)):
        for transport in TRANSPORTS:
            server, port = mod.serve_background(api, "127.0.0.1",
                                                transport=transport)
            try:
                got[(pkg, transport)] = _mask(_raw_until_close(
                    port, _req("GET", "/dict")))
            finally:
                server.shutdown()
                server.server_close()
    assert len(set(got.values())) == 1, got
    raw = got[("port", "async")]
    if spec.startswith("drop"):
        assert raw == b""
    else:
        head, body = raw.split(b"\r\n\r\n", 1)
        clen = int(re.search(rb"Content-Length: (\d+)", head).group(1))
        assert 0 < len(body) < clen


def test_async_drain_finishes_every_admitted_request():
    """``shutdown`` while four slow requests are in flight: each gets its
    full 200 before the loop exits, an idle keep-alive connection does
    not hold the drain, and a connection made after it is refused."""
    started = threading.Barrier(5, timeout=TIMEOUT_S)

    class Slow:
        def handle(self, method, path, query=None, body=b"", headers=None):
            started.wait()
            time.sleep(0.3)
            return 200, {"done": query.get("i")}

    server, port = http.serve_background(Slow(), "127.0.0.1",
                                         transport="async")
    answers = {}

    def client(i):
        answers[i] = _raw(port, _req("GET", f"/s?i={i}"))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    # and an idle keep-alive connection, which must not hold the drain
    idle = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT_S)
    started.wait()              # every request is admitted and running
    t0 = time.perf_counter()
    server.shutdown()           # blocks until the drain is done
    assert time.perf_counter() - t0 < 5.0
    idle.close()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive()
    server.server_close()
    assert sorted(answers) == [0, 1, 2, 3]
    for i, raw in answers.items():
        assert raw.startswith(b"HTTP/1.1 200 ")
        assert raw.endswith(json.dumps({"done": str(i)}).encode())
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1.0)


def test_the_query_server_answers_alike_on_both_transports(monkeypatch):
    """A deployed model behind both transports of each package: the
    queries, the 400, /readyz and /healthz come out byte for byte as the
    reference's on the same transport."""
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    japi, tapi = util.deploy_both(util.dyadic_blob())
    servers = []
    try:
        ports = {}
        for name, api, mod in (("ref", japi, ref_http),
                               ("port", tapi, http)):
            for transport in TRANSPORTS:
                server, p = mod.serve_background(api, "127.0.0.1",
                                                 transport=transport)
                servers.append(server)
                ports[(name, transport)] = p
        probes = [_req("POST", "/queries.json", util.query(u, n))
                  for u, n in (("u3", 4), ("u0", 40), ("nobody", 4))]
        probes += [_req("POST", "/queries.json", b"{bad"),
                   _req("GET", "/healthz"), _req("GET", "/nope")]
        for request in probes:
            got = {key: _mask(_raw(p, request)) for key, p in ports.items()}
            assert len(set(got.values())) == 1, got
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        japi.close()
        tapi.close()
