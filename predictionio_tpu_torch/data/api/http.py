"""HTTP transport for pure route handlers, threaded and async (port of
``predictionio_tpu/data/api/http.py``).

Any object with ``handle(method, path, query, body, headers) ->
(status, payload[, extra_headers])`` can be served. A dict or list
payload renders as strict JSON: a NaN or Infinity in it is a server bug,
answered 500. A ``str`` payload (the dashboard's pages) is served as
HTML unless the handler names its own ``Content-Type`` (``GET /metrics``
serves Prometheus text); a ``bytes`` payload (the storage server's
columnar reads and model blobs) as ``application/octet-stream``. TLS
engages when ``PIO_SSL_CERTFILE`` names a PEM certificate.

Two interchangeable transports sit under every daemon, chosen by
``PIO_TRANSPORT``:

- ``threaded`` (default): the stdlib ``ThreadingHTTPServer``, one OS
  thread per connection.
- ``async``: one asyncio event loop owns accept, parse and write, with
  HTTP/1.1 keep-alive and pipelining (up to ``PIO_TRANSPORT_PIPELINE``
  requests of one connection dispatched at once, answered in order).
  Handlers stay synchronous and run on a bounded executor
  (``PIO_TRANSPORT_WORKERS`` ``pio-http`` threads); device work stays on
  the query batcher's flush thread on either transport.

Both funnel every request through one :func:`dispatch_request`, so they
answer byte for byte alike (only the ``Date`` header's value differs):

- server-boundary fault injection (``PIO_FAULT_SPEC``, scope
  ``@server``; common/resilience.py): latency before dispatch, an
  aborted connection with no reply bytes, a synthetic 5xx, or a reply
  cut short under its full ``Content-Length`` on a closed connection;
- request telemetry: an incoming ``X-PIO-Trace`` header is always
  adopted and a fresh trace originates only under ``PIO_TRACE=1``; each
  request runs in a ``server:<path>`` span and a devicewatch attribution
  region; ``PIO_TELEMETRY=1`` adds the request histogram and counter; a
  5xx pins its trace. With the knobs unset, the wire bytes are
  unchanged.
"""

from __future__ import annotations

import asyncio
import contextlib
import email.utils
import http.server
import json
import logging
import os
import signal
import socket
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from predictionio_tpu_torch.common import (
    devicewatch, resilience, telemetry, tracing,
)
from predictionio_tpu_torch.common.server_security import (
    maybe_wrap_ssl, ssl_context_from_env,
)

logger = logging.getLogger("predictionio_tpu_torch.http")


def transport_mode(explicit: Optional[str] = None) -> str:
    """Resolve the transport: explicit argument > ``PIO_TRANSPORT`` env >
    ``threaded``. Unknown values raise — a typo'd transport silently
    falling back to threaded would invalidate every async bench claim."""
    mode = (explicit or os.environ.get("PIO_TRANSPORT", "threaded")).lower()
    if mode not in ("threaded", "async"):
        raise ValueError(
            f"PIO_TRANSPORT must be 'threaded' or 'async', got {mode!r}")
    return mode


def _executor_workers() -> int:
    raw = os.environ.get("PIO_TRANSPORT_WORKERS", "")
    try:
        v = int(raw) if raw else 0
    except ValueError:
        v = 0
    if v > 0:
        return v
    return min(32, (os.cpu_count() or 1) * 4)


def _pipeline_window() -> int:
    raw = os.environ.get("PIO_TRANSPORT_PIPELINE", "")
    try:
        v = int(raw) if raw else 0
    except ValueError:
        v = 0
    return v if v > 0 else 16


# ---------------------------------------------------------------------------
# the one dispatch path both transports share
# ---------------------------------------------------------------------------

class RequestOutcome:
    """Everything a transport needs to answer one request.

    ``advertised_len`` can exceed ``len(data)`` under injected
    truncation (PIO_FAULT_SPEC): the client must observe a genuinely
    torn response, so the transport sends the short body and drops the
    connection. ``abort`` means send NOTHING and sever (a mid-request
    kill)."""

    __slots__ = ("status", "data", "ctype", "extra_headers",
                 "advertised_len", "close", "abort")

    def __init__(self):
        self.status = 500
        self.data = b""
        self.ctype = "application/json; charset=UTF-8"
        self.extra_headers: Dict[str, str] = {}
        self.advertised_len = 0
        self.close = False
        self.abort = False


def dispatch_request(api, method: str, target: str, body: bytes,
                     headers: Dict[str, str]) -> RequestOutcome:
    """Run one request through the full server-side stack: fault
    injection, trace adoption, compile attribution, the handler itself,
    request telemetry, and strict-JSON serialization. Transport-agnostic
    — the threaded handler and the async loop both call exactly this,
    which is what makes their wire bytes identical."""
    out = RequestOutcome()
    parsed = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
    extra_headers: Dict[str, str] = {}
    # server-boundary fault injection (PIO_FAULT_SPEC, scope @server):
    # latency before dispatch, or an aborted connection — the client
    # sees exactly what a crashed/partitioned daemon produces
    inj = resilience.active()
    if inj is not None:
        try:
            inj.before_send("server", f"{method} {parsed.path}")
        except ConnectionError:
            out.abort = True   # no response bytes at all: a mid-request kill
            return out
    # request telemetry rides the transport so every daemon gets it
    # uniformly: an incoming X-PIO-Trace header is always adopted (the
    # upstream already sampled this request); fresh traces originate
    # only under PIO_TRACE=1, so default wire behavior is unchanged.
    ctx = tracing.server_context(headers)
    service = type(api).__name__
    t0 = time.perf_counter() if telemetry.on() else None
    try:
        # compile attribution lives in the transport (the Dapper
        # platform-layer lesson): an XLA compile triggered on ANY
        # daemon's request thread is attributed to its route without
        # per-handler wiring. The serving hot paths narrow this
        # further (batcher flush / inline predict regions).
        with devicewatch.attribution(f"server:{parsed.path}",
                                     phase="request"):
            with tracing.activate(ctx):
                with tracing.span(f"server:{parsed.path}",
                                  service=service):
                    response = api.handle(
                        method, parsed.path, query, body, headers)
        if len(response) == 3:
            status, payload, extra_headers = response
        else:
            status, payload = response
    except Exception as e:  # handler without its own guard
        logger.exception("handler failed: %s %s", method, parsed.path)
        status, payload = 500, {"message": str(e)}
    if status >= 500 and ctx is not None:
        # an errored traced request is exactly a trace worth keeping:
        # pin it in the tail ring so its id resolves after churn
        tracing.pin_trace(ctx.trace_id, "error")
    if t0 is not None:
        telemetry.registry().histogram(
            "pio_http_request_seconds",
            "HTTP request handling latency by daemon and method",
            labelnames=("service", "method")).labels(
                service=service, method=method
        ).observe(time.perf_counter() - t0)
        telemetry.registry().counter(
            "pio_http_requests_total",
            "HTTP requests served by daemon and status",
            labelnames=("service", "status")).labels(
                service=service, status=str(status)).inc()
    if isinstance(payload, (bytes, bytearray)):  # binary (storage RPC)
        data = bytes(payload)
        ctype = "application/octet-stream"
    elif isinstance(payload, str):  # pre-rendered HTML (dashboard pages)
        data = payload.encode("utf-8")
        ctype = "text/html; charset=UTF-8"
    else:
        try:
            # strict JSON: a bare NaN/Infinity token is not JSON and
            # breaks real clients; a payload carrying one is a server
            # bug (e.g. a poisoned model's scores), not data
            data = json.dumps(payload, allow_nan=False).encode("utf-8")
        except ValueError:
            status = 500
            data = json.dumps(
                {"message": "response contains non-finite numbers"}
            ).encode("utf-8")
        ctype = "application/json; charset=UTF-8"
    if extra_headers and "Content-Type" in extra_headers:
        # handler-chosen content type (GET /metrics serves Prometheus
        # text exposition, which is a str but not text/html)
        extra_headers = dict(extra_headers)
        ctype = extra_headers.pop("Content-Type")
    out.advertised_len = len(data)
    if inj is not None:
        new_status, new_data = inj.on_response(
            "server", f"{method} {parsed.path}", status, data)
        if new_status != status:
            # injected 5xx: a fully-formed synthetic error reply
            status, data = new_status, new_data
            out.advertised_len = len(data)
            ctype = "application/json; charset=UTF-8"
        elif len(new_data) != len(data):
            # injected truncation: advertise the ORIGINAL length but
            # send fewer bytes and drop the connection, so the client
            # observes a genuine torn response (IncompleteRead)
            data = new_data
            out.close = True
    out.status = status
    out.data = data
    out.ctype = ctype
    out.extra_headers = extra_headers or {}
    return out


# ---------------------------------------------------------------------------
# threaded transport (the bit-compatible fallback)
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    api = None  # set by make_server
    protocol_version = "HTTP/1.1"
    # serving-latency path: without this, Nagle + delayed-ACK adds ~40ms
    # per small keep-alive response (CreateServer.scala p50 parity target)
    disable_nagle_algorithm = True

    def _dispatch(self, method: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        out = dispatch_request(self.api, method, self.path, body,
                               dict(self.headers.items()))
        if out.abort:
            self.close_connection = True
            return   # no response bytes at all: a mid-request kill
        try:
            self.send_response(out.status)
            self.send_header("Content-Type", out.ctype)
            self.send_header("Content-Length", str(out.advertised_len))
            for name, value in out.extra_headers.items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(out.data)
        except (BrokenPipeError, ConnectionResetError):
            # the client gave up on this connection (timeout, retry on a
            # fresh one, or a mid-request kill); the work is done — losing
            # the response write is their failure mode, not ours
            self.close_connection = True
        if out.close:
            self.close_connection = True

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def do_PUT(self):  # noqa: N802
        self._dispatch("PUT")

    def log_message(self, fmt, *args):  # route logs through logging, quietly
        logger.debug(fmt, *args)


# ---------------------------------------------------------------------------
# async transport
# ---------------------------------------------------------------------------

#: methods the threaded handler implements (do_*); anything else answers
#: 501 on both transports
_METHODS = frozenset({"GET", "POST", "PUT", "DELETE"})

#: known-nonblocking GET routes served inline on the loop thread; every
#: other request runs on the bounded executor because handlers may block
#: (WAL group commit, device dispatch, storage RPC)
_INLINE_PATHS = frozenset({"/healthz"})

#: exact Server header of the threaded stack — wire-byte parity
_SERVER_SOFTWARE = (_Handler.server_version + " " + _Handler.sys_version)

_MAX_LINE = 65536
_MAX_HEADERS = 128


def _status_phrase(code: int) -> str:
    got = BaseHTTPRequestHandler.responses.get(code)
    return got[0] if got else ""


#: (perf_counter stamp, rendered Date value) — HTTP Date has 1 s
#: precision, so re-rendering it per response is pure waste on the
#: ingest path; refreshed every 0.4 s (staleness bounded well under the
#: format's own resolution)
_date_cache = (float("-inf"), "")


def _http_date() -> str:
    global _date_cache
    now = time.perf_counter()
    stamp, value = _date_cache
    if now - stamp > 0.4:
        value = email.utils.formatdate(usegmt=True)
        _date_cache = (now, value)
    return value


def _render_head(out: RequestOutcome) -> bytes:
    """The exact byte sequence BaseHTTPRequestHandler emits for this
    outcome: status line, Server, Date, Content-Type, Content-Length,
    extra headers, blank line."""
    lines = [
        f"HTTP/1.1 {out.status} {_status_phrase(out.status)}\r\n",
        f"Server: {_SERVER_SOFTWARE}\r\n",
        f"Date: {_http_date()}\r\n",
        f"Content-Type: {out.ctype}\r\n",
        f"Content-Length: {out.advertised_len}\r\n",
    ]
    lines.extend(f"{k}: {v}\r\n" for k, v in out.extra_headers.items())
    lines.append("\r\n")
    return "".join(lines).encode("latin-1", "strict")


def _dispatch_and_render(api, method, target, body, headers):
    """Executor-side unit of work for the async transport: run the
    handler AND assemble the response bytes off the loop thread, so the
    loop only writes. Returns (outcome, wire_bytes|None for abort)."""
    out = dispatch_request(api, method, target, body, headers)
    if out.abort:
        return out, None
    return out, _render_head(out) + out.data


def _error_outcome(code: int, message: Optional[str] = None,
                   ) -> RequestOutcome:
    """A transport-level error reply (malformed request line, oversized
    header, unsupported method) in the stdlib send_error shape."""
    out = RequestOutcome()
    phrase = _status_phrase(code)
    explain = (BaseHTTPRequestHandler.responses.get(code) or ("", ""))[1]
    import html as _html
    body = (http.server.DEFAULT_ERROR_MESSAGE % {
        "code": code,
        "message": _html.escape(message or phrase, quote=False),
        "explain": _html.escape(explain, quote=False),
    }).encode("utf-8", "replace")
    out.status = code
    out.data = body
    out.advertised_len = len(body)
    out.ctype = http.server.DEFAULT_ERROR_CONTENT_TYPE
    out.close = True
    return out


class _Conn:
    """Book-keeping for one live async connection (drain accounting)."""

    __slots__ = ("task", "reader_task", "admitted", "served")

    def __init__(self):
        self.task = None
        self.reader_task = None
        self.admitted = 0
        self.served = 0


class AsyncHTTPServer:
    """asyncio transport with the ThreadingHTTPServer lifecycle surface
    (``serve_forever`` / ``shutdown`` / ``server_close`` /
    ``server_address``) so every existing call site — the daemons'
    serve loops, the bench, the tests — runs unmodified on either
    transport.

    The listening socket binds in the constructor (callers read
    ``server_address`` before starting the loop thread); the event loop
    itself lives in whatever thread calls :meth:`serve_forever`.
    ``shutdown`` is the graceful drain: stop accepting, stop READING
    new requests off live connections, finish every already-admitted
    request (their WAL group commits land and their responses go out —
    zero acknowledged-event loss), then stop the loop."""

    #: how long shutdown waits for admitted in-flight requests before
    #: cancelling stragglers
    drain_grace_s = 30.0

    def __init__(self, api, host: str = "localhost", port: int = 0):
        self.api = api
        self._ssl = ssl_context_from_env()
        if self._ssl is not None:
            logger.info("TLS enabled (PIO_SSL_CERTFILE)")
        # socketserver's default listen backlog of 5 resets bursts of
        # concurrent connects (measured: 32 parallel ingest clients) —
        # same 128 backlog as the threaded transport
        self._sock = socket.create_server((host, port), backlog=128)
        self.server_address = self._sock.getsockname()
        self.daemon_threads = True   # lifecycle-surface parity (no-op)
        self._pipeline = _pipeline_window()
        self._executor = ThreadPoolExecutor(
            max_workers=_executor_workers(), thread_name_prefix="pio-http")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._conns: set = set()
        self._started = threading.Event()
        self._done = threading.Event()
        self._shutdown_requested = threading.Event()
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self):
        try:
            asyncio.run(self._main())
        finally:
            self._started.set()
            self._done.set()

    def shutdown(self):
        """Graceful drain; blocks until the loop exits (ThreadingHTTPServer
        contract). Safe to call before or without serve_forever."""
        self._shutdown_requested.set()
        # wait out the start race: serve_forever may be mid-startup on
        # its thread (a shutdown with no serve_forever at all times out
        # here and returns — nothing to stop)
        self._started.wait(5.0)
        loop, stop = self._loop, self._stop_event
        if loop is not None and stop is not None and loop.is_running():
            with contextlib.suppress(RuntimeError):
                loop.call_soon_threadsafe(stop.set)
        if self._started.is_set():
            self._done.wait(self.drain_grace_s + 10.0)

    def server_close(self):
        self._shutdown_requested.set()
        if not self._closed and not self._started.is_set():
            # loop never ran: nothing owns the socket but us
            self._closed = True
            with contextlib.suppress(OSError):
                self._sock.close()
        self._executor.shutdown(wait=False)

    # ------------------------------------------------------------ the loop
    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        if self._shutdown_requested.is_set():
            self._stop_event.set()
        server = await asyncio.start_server(
            self._client, sock=self._sock, ssl=self._ssl)
        self._closed = True   # the asyncio server owns the socket now
        self._started.set()
        await self._stop_event.wait()
        # stop accepting; the wait for the listener comes after the drain
        # below, since from Python 3.12.1 ``wait_closed`` also waits for
        # every open connection, an idle keep-alive one included
        server.close()
        # drain: stop reading new requests everywhere; idle connections
        # close now, busy ones finish every admitted request first. The
        # sweep repeats, since a connection accepted just before the
        # listener closed registers after the first pass
        deadline = self._loop.time() + self.drain_grace_s
        while self._conns and self._loop.time() < deadline:
            for conn in list(self._conns):
                if conn.reader_task is not None:
                    conn.reader_task.cancel()
                if conn.admitted == conn.served and conn.task is not None:
                    conn.task.cancel()
            await asyncio.sleep(0.005)
        for conn in list(self._conns):
            if conn.task is not None:
                conn.task.cancel()
        await asyncio.sleep(0)
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(server.wait_closed(), 1.0)
        self._executor.shutdown(wait=False)

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            with contextlib.suppress(OSError):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn()
        conn.task = asyncio.current_task()
        # per-connection pipeline: the read loop admits up to `window`
        # requests ahead of the write loop and dispatches each to the
        # executor immediately, so pipelined ingest batches on ONE
        # connection coalesce into one WAL group commit; responses are
        # written strictly in request order (HTTP/1.1 pipelining)
        queue: asyncio.Queue = asyncio.Queue()
        window = asyncio.Semaphore(self._pipeline)
        conn.reader_task = asyncio.create_task(
            self._read_loop(reader, queue, window, conn))
        self._conns.add(conn)
        try:
            while True:
                item = await queue.get()
                if item is None:
                    break
                fut, close_after = item
                try:
                    out, payload = await fut
                except Exception:
                    logger.exception(
                        "async dispatch failed")
                    break
                if out.abort:
                    break   # injected mid-request kill: sever, no bytes
                writer.write(payload)
                try:
                    await writer.drain()
                except (ConnectionError, OSError):
                    break   # client gave up; the work is done
                conn.served += 1
                window.release()
                if out.close or close_after:
                    break
        except asyncio.CancelledError:
            pass
        finally:
            # bookkeeping FIRST, and nothing awaited after it: an await
            # here can re-raise CancelledError (a BaseException — it
            # sails past suppress(Exception)) and would skip the
            # discard+close, leaving the drain waiting on a connection
            # that will never go away
            self._conns.discard(conn)
            if conn.reader_task is not None:
                conn.reader_task.cancel()
            with contextlib.suppress(BaseException):
                writer.close()

    async def _read_loop(self, reader, queue, window, conn):
        loop = asyncio.get_running_loop()
        try:
            while True:
                await window.acquire()
                req = await self._read_request(reader)
                if req is None:
                    queue.put_nowait(None)
                    return
                method, target, body, headers, close_after, err = req
                conn.admitted += 1
                if err is not None:
                    fut = loop.create_future()
                    fut.set_result((err, _render_head(err) + err.data))
                    queue.put_nowait((fut, True))
                    return
                if self._stop_event is not None \
                        and self._stop_event.is_set():
                    close_after = True   # draining: serve, then hang up
                if method == "GET" and \
                        target.partition("?")[0] in _INLINE_PATHS:
                    # known-nonblocking probe: skip the executor hop
                    fut = loop.create_future()
                    fut.set_result(_dispatch_and_render(
                        self.api, method, target, body, headers))
                else:
                    fut = loop.run_in_executor(
                        self._executor, _dispatch_and_render, self.api,
                        method, target, body, headers)
                queue.put_nowait((fut, close_after))
                if close_after:
                    return
        except asyncio.CancelledError:
            queue.put_nowait(None)
            raise
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                ValueError):
            queue.put_nowait(None)

    async def _read_request(self, reader):
        """Parse one request: (method, target, body, headers, close_after,
        err_outcome) — or None at EOF. ``err_outcome`` is a canned reply
        for transport-level protocol errors."""
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            return "GET", "/", b"", {}, True, _error_outcome(414)
        if not line:
            return None
        if len(line) > _MAX_LINE:
            return "GET", "/", b"", {}, True, _error_outcome(414)
        words = line.decode("latin-1").rstrip("\r\n").split()
        if len(words) != 3 or not words[2].startswith("HTTP/"):
            return "GET", "/", b"", {}, True, _error_outcome(
                400, f"Bad request syntax ({line.decode('latin-1', 'replace').rstrip()!r})")
        method, target, version = words
        close_after = version == "HTTP/1.0"
        headers: Dict[str, str] = {}
        length = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(h) > _MAX_LINE or len(headers) >= _MAX_HEADERS:
                return method, target, b"", {}, True, _error_outcome(431)
            text = h.decode("latin-1")
            key, sep, value = text.partition(":")
            if not sep:
                return method, target, b"", {}, True, _error_outcome(
                    400, "Bad header line")
            key, value = key.strip(), value.strip()
            headers[key] = value
            lk = key.lower()
            if lk == "content-length":
                try:
                    length = int(value)
                except ValueError:
                    return method, target, b"", {}, True, _error_outcome(
                        400, "Bad Content-Length")
            elif lk == "connection":
                v = value.lower()
                close_after = (v == "close" if version != "HTTP/1.0"
                               else v != "keep-alive")
        if method not in _METHODS:
            # the threaded handler only implements do_GET/POST/PUT/DELETE
            return method, target, b"", {}, True, _error_outcome(
                501, f"Unsupported method ({method!r})")
        body = await reader.readexactly(length) if length else b""
        return method, target, body, headers, close_after, None


# ---------------------------------------------------------------------------
# construction + daemon lifecycle (transport-agnostic)
# ---------------------------------------------------------------------------

def make_server(api, host: str = "localhost", port: int = 0,
                transport: Optional[str] = None):
    """Build (without starting) an HTTP server around `api` on the
    configured transport (``transport`` argument > ``PIO_TRANSPORT`` >
    threaded).

    port=0 binds an ephemeral port; read it from server.server_address.
    TLS engages when PIO_SSL_CERTFILE is configured
    (SSLConfiguration.scala role).
    Both transports expose the same lifecycle surface
    (serve_forever/shutdown/server_close/server_address)."""
    if transport_mode(transport) == "async":
        return AsyncHTTPServer(api, host, port)
    handler = type("BoundHandler", (_Handler,), {"api": api})
    # socketserver's default listen backlog of 5 resets bursts of
    # concurrent connects (measured: 32 parallel ingest clients)
    server_cls = type("BoundServer", (ThreadingHTTPServer,),
                      {"request_queue_size": 128})
    server = server_cls((host, port), handler)
    server.daemon_threads = True
    if maybe_wrap_ssl(server) == "https":
        logger.info("TLS enabled (PIO_SSL_CERTFILE)")
    return server


def serve_background(api, host: str = "localhost",
                     port: int = 0, transport: Optional[str] = None
                     ) -> Tuple[object, int]:
    """Start `api` on a daemon thread; returns (server, bound_port)."""
    server = make_server(api, host, port, transport=transport)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def install_sigterm_handler(fn: Callable[[], None]) -> bool:
    """Route SIGTERM to ``fn`` (run on a fresh thread so the signal
    frame never blocks). Returns False outside the main thread, where
    CPython refuses to install handlers — callers then rely on their
    explicit drain/stop paths instead."""
    def _handler(_signum, _frame):
        threading.Thread(target=fn, name="pio-drain", daemon=True).start()
    try:
        signal.signal(signal.SIGTERM, _handler)
        return True
    except ValueError:
        return False


def serve_forever(api, host: str = "localhost", port: int = 7070,
                  on_drain: Optional[Callable[[], None]] = None) -> None:
    """Run a daemon until SIGTERM/SIGINT, then shut down GRACEFULLY:
    mark the api draining (``/readyz`` flips to 503 so load balancers
    stop routing here), stop accepting connections, and run ``on_drain``
    exactly once (e.g. flush the eventlog WAL buffers) before returning.
    On the threaded transport, in-flight handler threads serialize on
    their backend locks, so a drain-time flush completes after the
    writes it races with; on the async transport, shutdown() itself
    waits for every admitted request (their WAL group commits included)
    before the loop exits — zero acknowledged-event loss either way."""
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
