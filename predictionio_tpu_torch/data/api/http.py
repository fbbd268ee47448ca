"""Threaded HTTP transport for pure route handlers (port of the threaded
half of ``predictionio_tpu/data/api/http.py``; the asyncio transport
waits for ROADMAP queue 1 item 4, and ``PIO_TRANSPORT=async`` is refused).

Any object with ``handle(method, path, query, body, headers) ->
(status, payload[, extra_headers])`` can be served. A dict or list
payload renders as strict JSON: a NaN or Infinity in it is a server bug,
answered 500. A ``str`` payload (the dashboard's pages) is served as
HTML unless the handler names its own ``Content-Type`` (``GET /metrics``
serves Prometheus text); a ``bytes`` payload (the storage server's
columnar reads and model blobs) as ``application/octet-stream``. TLS
engages when ``PIO_SSL_CERTFILE`` names a PEM certificate.

Server-boundary fault injection (``PIO_FAULT_SPEC``, scope ``@server``;
common/resilience.py) runs in the handler: latency before dispatch, an
aborted connection with no reply bytes, a synthetic 5xx, or a reply cut
short under its full ``Content-Length`` on a closed connection.

Request telemetry rides the transport, so every daemon gets it alike:
an incoming ``X-PIO-Trace`` header is always adopted and a fresh trace
originates only under ``PIO_TRACE=1``; each request runs in a
``server:<path>`` span and a devicewatch attribution region;
``PIO_TELEMETRY=1`` adds the request histogram and counter; a 5xx pins
its trace. With the knobs unset, the bytes on the wire are unchanged.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from predictionio_tpu_torch.common import (
    devicewatch, resilience, telemetry, tracing,
)
from predictionio_tpu_torch.common.server_security import maybe_wrap_ssl

logger = logging.getLogger("predictionio_tpu_torch.http")


def dispatch_request(api, method: str, target: str, body: bytes,
                     headers: Dict[str, str]
                     ) -> Tuple[int, bytes, str, Dict[str, str]]:
    """One request through the handler -> (status, body, content type,
    extra headers), with trace adoption, compile attribution and request
    telemetry around it."""
    parsed = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
    extra: Dict[str, str] = {}
    ctx = tracing.server_context(headers)
    service = type(api).__name__
    t0 = time.perf_counter() if telemetry.on() else None
    try:
        with devicewatch.attribution(f"server:{parsed.path}",
                                     phase="request"):
            with tracing.activate(ctx):
                with tracing.span(f"server:{parsed.path}",
                                  service=service):
                    response = api.handle(
                        method, parsed.path, query, body, headers)
        if len(response) == 3:
            status, payload, extra = response
        else:
            status, payload = response
    except Exception as e:  # a handler without its own guard
        logger.exception("handler failed: %s %s", method, parsed.path)
        status, payload = 500, {"message": str(e)}
    if status >= 500 and ctx is not None:
        # an errored traced request is a trace worth keeping
        tracing.pin_trace(ctx.trace_id, "error")
    if t0 is not None:
        reg = telemetry.registry()
        reg.histogram(
            "pio_http_request_seconds",
            "HTTP request handling latency by daemon and method",
            labelnames=("service", "method")).labels(
                service=service, method=method
        ).observe(time.perf_counter() - t0)
        reg.counter(
            "pio_http_requests_total",
            "HTTP requests served by daemon and status",
            labelnames=("service", "status")).labels(
                service=service, status=str(status)).inc()
    extra = dict(extra)
    if isinstance(payload, (bytes, bytearray)):   # binary (storage RPC)
        ctype = extra.pop("Content-Type", "application/octet-stream")
        return status, bytes(payload), ctype, extra
    if isinstance(payload, str):
        # pre-rendered text: HTML pages, or what the handler names
        # (GET /metrics serves Prometheus text exposition)
        ctype = extra.pop("Content-Type", "text/html; charset=UTF-8")
        return status, payload.encode("utf-8"), ctype, extra
    try:
        data = json.dumps(payload, allow_nan=False).encode("utf-8")
    except ValueError:
        status = 500
        data = json.dumps(
            {"message": "response contains non-finite numbers"}
        ).encode("utf-8")
    ctype = extra.pop("Content-Type", "application/json; charset=UTF-8")
    return status, data, ctype, extra


class _Handler(BaseHTTPRequestHandler):
    api = None  # set by make_server
    protocol_version = "HTTP/1.1"
    # without this, Nagle + delayed ACK add ~40 ms to small keep-alive
    # responses
    disable_nagle_algorithm = True

    def _dispatch(self, method: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        route = f"{method} {urllib.parse.urlsplit(self.path).path}"
        inj = resilience.active()
        if inj is not None:
            try:
                inj.before_send("server", route)
            except ConnectionError:
                # no response bytes at all: what a mid-request kill gives
                self.close_connection = True
                return
        status, data, ctype, extra = dispatch_request(
            self.api, method, self.path, body, dict(self.headers.items()))
        advertised, close = len(data), False
        if inj is not None:
            new_status, new_data = inj.on_response("server", route, status,
                                                   data)
            if new_status != status:      # a whole synthetic error reply
                status, data = new_status, new_data
                advertised = len(data)
                ctype = "application/json; charset=UTF-8"
            elif len(new_data) != len(data):
                # the full length advertised, fewer bytes sent and the
                # connection dropped: the client sees a torn reply
                data, close = new_data, True
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(advertised))
            for name, value in extra.items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        if close:
            self.close_connection = True

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def do_PUT(self):  # noqa: N802
        self._dispatch("PUT")

    def log_message(self, fmt, *args):
        logger.debug(fmt, *args)


def make_server(api, host: str = "localhost", port: int = 0
                ) -> ThreadingHTTPServer:
    """Build (without starting) a threaded HTTP server around ``api``;
    port 0 binds an ephemeral port (read ``server.server_address``). TLS
    engages when ``PIO_SSL_CERTFILE`` is set."""
    handler = type("BoundHandler", (_Handler,), {"api": api})
    # the default listen backlog of 5 resets bursts of concurrent connects
    server_cls = type("BoundServer", (ThreadingHTTPServer,),
                      {"request_queue_size": 128})
    server = server_cls((host, port), handler)
    server.daemon_threads = True
    if maybe_wrap_ssl(server) == "https":
        logger.info("TLS enabled (PIO_SSL_CERTFILE)")
    return server


def serve_background(api, host: str = "localhost", port: int = 0
                     ) -> Tuple[ThreadingHTTPServer, int]:
    """Start ``api`` on a daemon thread; returns (server, bound port)."""
    server = make_server(api, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def install_sigterm_handler(fn: Callable[[], None]) -> bool:
    """Route SIGTERM to ``fn`` on a fresh thread. Returns False outside
    the main thread, where Python refuses to install handlers."""
    def _handler(_signum, _frame):
        threading.Thread(target=fn, name="pio-drain", daemon=True).start()
    try:
        signal.signal(signal.SIGTERM, _handler)
        return True
    except ValueError:
        return False


def serve_forever(api, host: str = "localhost", port: int = 7070,
                  on_drain: Optional[Callable[[], None]] = None) -> None:
    """Run a daemon until SIGTERM or SIGINT, then shut down gracefully:
    mark the api draining (``/readyz`` answers 503, so load balancers stop
    routing here), stop accepting connections, wait for the open
    connections to finish, and run ``on_drain`` once before returning."""
    server = make_server(api, host, port)
    drained = threading.Event()

    def _drain():
        if drained.is_set():
            return
        drained.set()
        setattr(api, "draining", True)
        server.shutdown()

    install_sigterm_handler(_drain)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _drain()
        server.server_close()
        if on_drain is not None:
            on_drain()
