"""Networked storage backend: HTTP storage server + `remote` client
(port of ``predictionio_tpu/data/storage/remote.py``; host-only, the same
wire format both ways, so either package's client reads the other's
server).

The reference's shared stores are networked databases — PostgreSQL
(storage/jdbc/.../JDBCLEvents.scala:43-100), Elasticsearch, HBase — so any
number of daemons and machines can read the same events/metadata/models.
This module provides that role natively: a **storage server** daemon
(`pio storageserver`, StorageRPCAPI below) exposes a full Storage — any
local backend combination: sqlite, eventlog, localfs — over HTTP, and the
`remote` backend type is the client implementing every DAO against
it, discovered through the same env-var registry as every other backend:

    PIO_STORAGE_SOURCES_PG_TYPE=remote
    PIO_STORAGE_SOURCES_PG_URL=http://stores.internal:7072
    PIO_STORAGE_SOURCES_PG_KEY=<shared secret>        # optional
    PIO_STORAGE_REPOSITORIES_METADATA_SOURCE=PG ...

Wire format: POST /rpc, JSON body {"dao", "method", "args"}; events use the
Event Server's public JSON encoding (EventJson4sSupport parity), model
blobs are base64, timestamps ISO-8601 UTC. Optional shared-key auth via
the X-PIO-Storage-Key header (common/.../KeyAuthentication.scala role).
"""

from __future__ import annotations

import base64
import datetime as _dt
import hmac
import http.client
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.common import resilience, telemetry, tracing
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey, AccessKeys, App, Apps, Channel, Channels, EngineInstance,
    EngineInstances, EvaluationInstance, EvaluationInstances, Events, Model,
    Models,
)

# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------

def _iso(t: Optional[_dt.datetime]) -> Optional[str]:
    if t is None:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t.isoformat()


def _from_iso(s: Optional[str]) -> Optional[_dt.datetime]:
    if not s:
        return None
    if s.endswith("Z"):  # wire eventTime format; fromisoformat needs +00:00
        s = s[:-1] + "+00:00"  # (pre-3.11 compatibility)
    return _dt.datetime.fromisoformat(s)


def _enc_engine_instance(i: EngineInstance) -> Dict[str, Any]:
    d = dict(i.__dict__)
    d["start_time"], d["end_time"] = _iso(i.start_time), _iso(i.end_time)
    d["env"], d["runtime_conf"] = dict(i.env), dict(i.runtime_conf)
    return d


def _dec_engine_instance(d: Dict[str, Any]) -> EngineInstance:
    d = dict(d)
    d["start_time"] = _from_iso(d["start_time"])
    d["end_time"] = _from_iso(d["end_time"])
    return EngineInstance(**d)


def _enc_evaluation_instance(i: EvaluationInstance) -> Dict[str, Any]:
    d = dict(i.__dict__)
    d["start_time"], d["end_time"] = _iso(i.start_time), _iso(i.end_time)
    d["env"], d["runtime_conf"] = dict(i.env), dict(i.runtime_conf)
    return d


def _dec_evaluation_instance(d: Dict[str, Any]) -> EvaluationInstance:
    d = dict(d)
    d["start_time"] = _from_iso(d["start_time"])
    d["end_time"] = _from_iso(d["end_time"])
    return EvaluationInstance(**d)


def _enc_event(e: Event) -> Dict[str, Any]:
    return e.to_dict(with_event_id=True)


def _dec_event(d: Dict[str, Any]) -> Event:
    return Event.from_dict(d, validate=False)


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class StorageRPCAPI:
    """Route handler exposing a Storage over /rpc (host with
    data.api.http.make_server, same pattern as every other daemon)."""

    #: retained replies for deduplicated writes (client retry of a
    #: committed insert must get the ORIGINAL ids back, not a second copy)
    DEDUP_KEEP = 4096

    def __init__(self, storage, key: Optional[str] = None):
        self.storage = storage
        self.key = key
        #: health/drain lifecycle: a draining server answers /readyz with
        #: 503 so load balancers stop routing to it while in-flight RPCs
        #: (and the final WAL flush) complete.
        self.draining = False
        from collections import OrderedDict
        self._dedup_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        # uniform device-observability surface (/metrics gauges +
        # /debug/device.json) on the storage daemon as well (idempotent)
        from predictionio_tpu_torch.common import devicewatch, history, slo
        devicewatch.install()
        # SLO burn-rate gauges (env-default targets; a query server in
        # the same process installs its configured targets over these)
        slo.install()
        # metrics flight recorder: /debug/history.json rings (one
        # sampler thread per process; idempotent)
        history.install()

    # -- per-DAO method tables, each entry: args-dict -> JSON-able ----------
    def _events(self, m: str, a: Dict[str, Any]):
        ev = self.storage.get_events()
        app, ch = a.get("app_id"), a.get("channel_id")
        if m == "init":
            return ev.init(app, ch)
        if m == "remove":
            return ev.remove(app, ch)
        if m == "insert_batch":
            return ev.insert_batch(
                [_dec_event(d) for d in a["events"]], app, ch)
        if m == "get":
            got = ev.get(a["event_id"], app, ch)
            return None if got is None else _enc_event(got)
        if m == "delete":
            return ev.delete(a["event_id"], app, ch)
        if m == "head_cursor":
            # incremental-tail twins (fold-in over a remote EVENTDATA
            # source): cursors are plain JSON dicts, lags plain ints —
            # only the bulk column read itself needs the binary route
            if not hasattr(ev, "head_cursor"):
                raise ValueError(
                    "backing event store has no cursor-tail support")
            return ev.head_cursor(app, ch)
        if m == "cursor_lag":
            if not hasattr(ev, "cursor_lag"):
                raise ValueError(
                    "backing event store has no cursor-tail support")
            return int(ev.cursor_lag(app, ch, a.get("cursor")))
        if m == "find":
            # offset+limit window: the remote client pages with this so one
            # reply never buffers an unbounded JSON array (verdict r3 #3)
            offset = int(a.get("offset") or 0)
            limit = a.get("limit")
            scan_limit = None if limit is None else offset + int(limit)
            events = ev.find(
                app_id=app, channel_id=ch,
                start_time=_from_iso(a.get("start_time")),
                until_time=_from_iso(a.get("until_time")),
                entity_type=a.get("entity_type"),
                entity_id=a.get("entity_id"),
                event_names=a.get("event_names"),
                target_entity_type=a.get("target_entity_type"),
                target_entity_id=a.get("target_entity_id"),
                limit=scan_limit,
                reversed_=a.get("reversed", False))
            if offset:
                import itertools
                events = itertools.islice(events, offset, None)
            return [_enc_event(e) for e in events]
        raise ValueError(f"unknown events method {m!r}")

    def _apps(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_meta_data_apps()
        if m == "insert":
            return dao.insert(App(**a["app"]))
        if m == "get":
            got = dao.get(a["app_id"])
            return got and dict(got.__dict__)
        if m == "get_by_name":
            got = dao.get_by_name(a["name"])
            return got and dict(got.__dict__)
        if m == "get_all":
            return [dict(x.__dict__) for x in dao.get_all()]
        if m == "update":
            return dao.update(App(**a["app"]))
        if m == "delete":
            return dao.delete(a["app_id"])
        raise ValueError(f"unknown apps method {m!r}")

    def _access_keys(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_meta_data_access_keys()
        if m == "insert":
            return dao.insert(AccessKey(**a["k"]))
        if m == "get":
            got = dao.get(a["key"])
            return got and {**got.__dict__, "events": list(got.events)}
        if m == "get_all":
            return [{**x.__dict__, "events": list(x.events)}
                    for x in dao.get_all()]
        if m == "get_by_appid":
            return [{**x.__dict__, "events": list(x.events)}
                    for x in dao.get_by_appid(a["appid"])]
        if m == "update":
            return dao.update(AccessKey(**a["k"]))
        if m == "delete":
            return dao.delete(a["key"])
        raise ValueError(f"unknown access_keys method {m!r}")

    def _channels(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_meta_data_channels()
        if m == "insert":
            return dao.insert(Channel(**a["channel"]))
        if m == "get":
            got = dao.get(a["channel_id"])
            return got and dict(got.__dict__)
        if m == "get_by_appid":
            return [dict(x.__dict__) for x in dao.get_by_appid(a["appid"])]
        if m == "delete":
            return dao.delete(a["channel_id"])
        raise ValueError(f"unknown channels method {m!r}")

    def _engine_instances(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_meta_data_engine_instances()
        if m == "insert":
            return dao.insert(_dec_engine_instance(a["i"]))
        if m == "get":
            got = dao.get(a["instance_id"])
            return got and _enc_engine_instance(got)
        if m == "get_all":
            return [_enc_engine_instance(x) for x in dao.get_all()]
        if m == "get_latest_completed":
            got = dao.get_latest_completed(
                a["engine_id"], a["engine_version"], a["engine_variant"])
            return got and _enc_engine_instance(got)
        if m == "get_completed":
            return [_enc_engine_instance(x) for x in dao.get_completed(
                a["engine_id"], a["engine_version"], a["engine_variant"])]
        if m == "update":
            return dao.update(_dec_engine_instance(a["i"]))
        if m == "delete":
            return dao.delete(a["instance_id"])
        raise ValueError(f"unknown engine_instances method {m!r}")

    def _evaluation_instances(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_meta_data_evaluation_instances()
        if m == "insert":
            return dao.insert(_dec_evaluation_instance(a["i"]))
        if m == "get":
            got = dao.get(a["instance_id"])
            return got and _enc_evaluation_instance(got)
        if m == "get_all":
            return [_enc_evaluation_instance(x) for x in dao.get_all()]
        if m == "get_completed":
            return [_enc_evaluation_instance(x) for x in dao.get_completed()]
        if m == "update":
            return dao.update(_dec_evaluation_instance(a["i"]))
        if m == "delete":
            return dao.delete(a["instance_id"])
        raise ValueError(f"unknown evaluation_instances method {m!r}")

    def _models(self, m: str, a: Dict[str, Any]):
        dao = self.storage.get_model_data_models()
        if m == "insert":
            return dao.insert(Model(
                id=a["id"], models=base64.b64decode(a["models"])))
        if m == "get":
            got = dao.get(a["model_id"])
            return got and {"id": got.id,
                            "models": base64.b64encode(got.models).decode()}
        if m == "delete":
            return dao.delete(a["model_id"])
        raise ValueError(f"unknown models method {m!r}")

    _DAOS = {
        "events": _events, "apps": _apps, "access_keys": _access_keys,
        "channels": _channels, "engine_instances": _engine_instances,
        "evaluation_instances": _evaluation_instances, "models": _models,
    }

    # -- binary routes ------------------------------------------------------
    #
    # Columnar wire format ("PIOC" v1): 8-byte prelude (magic + u32 header
    # length) + UTF-8 JSON header {"pool": [...], "cols": [[name, dtype,
    # length], ...]} + the raw little-endian array buffers concatenated in
    # header order. Chosen over .npz because zipfile costs ~0.35 s per 24 MB
    # (measured) while this is two memcpys; both ends are zero-parse.

    def _read_columns_raw(self, body: bytes) -> bytes:
        """Bulk columnar read with a BINARY wire format — the `pio train`-
        against-a-storage-server fast path (the role JDBCPEvents.scala:
        91-150 plays for a shared PostgreSQL store): ~12 bytes/event of raw
        arrays instead of ~200 bytes of per-event JSON."""
        import numpy as np

        a = json.loads(body.decode("utf-8"))
        ev = self.storage.get_events()
        if not hasattr(ev, "read_columns"):
            raise ValueError(
                "backing event store has no columnar bulk-read support")
        kw = {}
        if a.get("read_threads"):
            # client-requested decode parallelism (pio train
            # --read-threads against a storage server); only forwarded to
            # backends that understand it
            import inspect
            if "read_threads" in inspect.signature(
                    ev.read_columns).parameters:
                kw["read_threads"] = int(a["read_threads"])
        cols = ev.read_columns(
            a["app_id"], a.get("channel_id"),
            event_names=a.get("event_names"),
            entity_type=a.get("entity_type"),
            target_entity_type=a.get("target_entity_type"),
            rating_property=a.get("rating_property", "rating"), **kw)
        arrays = {
            "entity_code": np.ascontiguousarray(cols["entity_code"],
                                                dtype=np.int32),
            "target_code": np.ascontiguousarray(cols["target_code"],
                                                dtype=np.int32),
            "event_code": np.ascontiguousarray(cols["event_code"],
                                               dtype=np.int32),
            "rating": np.ascontiguousarray(cols["rating"], dtype=np.float32),
            "time_ms": np.ascontiguousarray(cols["time_ms"], dtype=np.int64),
        }
        header = json.dumps({
            "pool": cols["pool"],
            "cols": [[k, str(v.dtype), int(v.shape[0])]
                     for k, v in arrays.items()]}).encode("utf-8")
        import struct
        parts = [b"PIOC", struct.pack("<I", len(header)), header]
        parts.extend(memoryview(v) for v in arrays.values())
        return b"".join(parts)

    def _read_columns_since_raw(self, body: bytes) -> bytes:
        """Incremental cursor read over the binary "PIOC" wire — the
        remote twin of ``eventlog.read_columns_since`` (fold-in tails a
        remote EVENTDATA source through this). The advanced cursor rides
        the JSON header next to the column table; the ``creation_ms``
        column (the freshness clock's start) ships like every other
        array."""
        import numpy as np

        a = json.loads(body.decode("utf-8"))
        ev = self.storage.get_events()
        if not hasattr(ev, "read_columns_since"):
            raise ValueError(
                "backing event store has no cursor-tail support")
        cursor, cols = ev.read_columns_since(
            a["app_id"], a.get("channel_id"), a.get("cursor"),
            event_names=a.get("event_names"),
            entity_type=a.get("entity_type"),
            target_entity_type=a.get("target_entity_type"),
            rating_property=a.get("rating_property", "rating"))
        arrays = {
            "entity_code": np.ascontiguousarray(cols["entity_code"],
                                                dtype=np.int32),
            "target_code": np.ascontiguousarray(cols["target_code"],
                                                dtype=np.int32),
            "event_code": np.ascontiguousarray(cols["event_code"],
                                               dtype=np.int32),
            "rating": np.ascontiguousarray(cols["rating"], dtype=np.float32),
            "time_ms": np.ascontiguousarray(cols["time_ms"], dtype=np.int64),
            "creation_ms": np.ascontiguousarray(cols["creation_ms"],
                                                dtype=np.int64),
        }
        header = json.dumps({
            "pool": cols["pool"],
            "cursor": cursor,
            "cols": [[k, str(v.dtype), int(v.shape[0])]
                     for k, v in arrays.items()]}).encode("utf-8")
        import struct
        parts = [b"PIOC", struct.pack("<I", len(header)), header]
        parts.extend(memoryview(v) for v in arrays.values())
        return b"".join(parts)

    def _readyz(self):
        """Readiness: not draining AND the backing storage constructs its
        DAOs (a broken PATH / lost mount turns the probe red before load
        balancers keep routing into 500s)."""
        if self.draining:
            return 503, {"status": "draining"}
        try:
            self.storage.get_events()
            self.storage.get_meta_data_apps()
        except Exception as e:
            return 503, {"status": "unready",
                         "message": f"{type(e).__name__}: {e}"}
        return 200, {"status": "ready", "proto": 3}

    def handle(self, method: str, path: str,
               query: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               headers: Optional[Dict[str, str]] = None):
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        # health probes are unauthenticated (kubelet/LB style) and leak
        # nothing beyond liveness/readiness
        if method == "GET" and path == "/healthz":
            return 200, {"status": "ok"}
        if method == "GET" and path == "/readyz":
            return self._readyz()
        t = telemetry.handle_route(method, path, query,
                                   accept=headers.get("accept"))
        if t is not None:   # /metrics, /traces.json, /debug/device.json
            return t
        if self.key and not hmac.compare_digest(
                headers.get("x-pio-storage-key", "").encode(
                    "utf-8", "surrogateescape"),
                self.key.encode("utf-8", "surrogateescape")):
            return 401, {"message": "invalid storage key"}
        if method == "GET" and path == "/":
            # proto 2 = offset-paged find + binary read_columns/model
            # routes; proto 3 adds the cursor-tail surface
            # (head_cursor / cursor_lag / binary read_columns_since)
            return 200, {"status": "alive", "proto": 3}
        # client-propagated deadline (X-PIO-Deadline-Ms carries the budget
        # REMAINING at send time): a request whose budget is already spent
        # fast-fails instead of doing work nobody is waiting for
        deadline_raw = headers.get("x-pio-deadline-ms")
        if deadline_raw is not None:
            try:
                if float(deadline_raw) <= 0:
                    return 504, {"message": "deadline exceeded"}
            except ValueError:
                pass  # malformed header: serve rather than reject
        try:
            if path == "/rpc/read_columns" and method == "POST":
                return 200, self._read_columns_raw(body)
            if path == "/rpc/read_columns_since" and method == "POST":
                return 200, self._read_columns_since_raw(body)
            if path == "/rpc/model" and method == "POST":
                # raw binary model blob; no base64, no JSON envelope
                mid = (query or {}).get("id", "")
                if not mid:
                    return 400, {"message": "missing id"}
                self.storage.get_model_data_models().insert(
                    Model(id=mid, models=bytes(body)))
                return 200, {"result": True}
            if path == "/rpc/model" and method == "GET":
                mid = (query or {}).get("id", "")
                got = self.storage.get_model_data_models().get(mid)
                if got is None:
                    return 404, {"message": f"no model {mid!r}"}
                return 200, got.models
            if method != "POST" or path != "/rpc":
                return 404, {"message": f"unknown route {method} {path}"}
            req = json.loads(body.decode("utf-8"))
            dao_fn = self._DAOS.get(req.get("dao"))
            if dao_fn is None:
                return 400, {"message": f"unknown dao {req.get('dao')!r}"}
            # write dedup: a client retrying a possibly-committed write
            # sends the same one-shot token; replaying the stored reply
            # instead of the DAO call makes the retry exactly-once. The
            # token is reserved BEFORE execution so a retry racing the
            # original request waits for its outcome instead of running
            # the write a second time.
            dedup = req.get("dedup")
            done_event = None
            if dedup:
                with self._dedup_lock:
                    entry = self._dedup_cache.get(dedup)
                    if entry is None:
                        done_event = threading.Event()
                        self._dedup_cache[dedup] = ("inflight", done_event)
                if entry is not None:
                    kind, val = entry
                    if kind == "inflight":
                        val.wait(30)
                        with self._dedup_lock:
                            entry = self._dedup_cache.get(dedup)
                        kind, val = entry or ("failed", None)
                    if kind == "done":
                        return 200, {"result": val, "deduped": True}
                    # the original attempt failed server-side: executing
                    # the retry is the correct (normal) retry semantics
                    with self._dedup_lock:
                        done_event = threading.Event()
                        self._dedup_cache[dedup] = ("inflight", done_event)
            try:
                result = dao_fn(self, req.get("method", ""),
                                req.get("args") or {})
            except BaseException:
                if dedup:
                    with self._dedup_lock:
                        self._dedup_cache.pop(dedup, None)
                    done_event.set()
                raise
            if dedup:
                with self._dedup_lock:
                    self._dedup_cache[dedup] = ("done", result)
                    self._dedup_cache.move_to_end(dedup)
                    while len(self._dedup_cache) > self.DEDUP_KEEP:
                        self._dedup_cache.popitem(last=False)
                done_event.set()
            return 200, {"result": result}
        except (ValueError, KeyError, TypeError) as e:
            return 400, {"message": f"{type(e).__name__}: {e}"}
        except Exception as e:  # pragma: no cover - backend failure
            return 500, {"message": f"{type(e).__name__}: {e}"}


# --------------------------------------------------------------------------
# client
# --------------------------------------------------------------------------

def _rpc_retries():
    """Lazy family handle (created on first retry, not at import)."""
    return telemetry.registry().counter(
        "pio_rpc_retries_total",
        "Remote-client retries by kind (transport reconnects vs 5xx)",
        labelnames=("kind",))


class _ConnectionPool:
    """Bounded keep-alive pool of ``http.client`` connections shared by
    every thread of the client process.

    Replaces the old one-connection-per-thread ``threading.local``: a
    trainer with N read workers no longer parks N sockets forever, and
    short-lived threads reuse a warm connection instead of paying TCP
    (+TLS) setup per thread. ``acquire`` pops an idle connection or
    dials a new one (connection COUNT is unbounded under burst — the
    bound is on how many idle sockets are retained, so steady state
    holds at most ``size``); ``release(reusable=False)`` — after any
    transport error or a ``Connection: close`` reply — discards instead
    of re-pooling, which preserves the retry semantics exactly: a retry
    never reuses the socket that just failed."""

    def __init__(self, factory, size: int):
        self._factory = factory
        self._size = max(1, int(size))
        self._lock = threading.Lock()
        self._idle: List[Any] = []
        self.dials = 0   # connections created (reuse observability/tests)

    def acquire(self):
        with self._lock:
            if self._idle:
                return self._idle.pop()
            self.dials += 1
        return self._factory()

    def release(self, conn, reusable: bool = True) -> None:
        if reusable:
            with self._lock:
                if len(self._idle) < self._size:
                    self._idle.append(conn)
                    return
        try:
            conn.close()
        except Exception:
            pass

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass


class StorageClient:
    """props: URL (http://host:port or https://host:port)
    [+ KEY, TIMEOUT, CAFILE, VERIFY=false, POOL].

    Connections ride a bounded keep-alive pool (``POOL`` property /
    ``PIO_RPC_POOL``, default 8 idle sockets) shared by every thread of
    the process instead of one private connection per thread; failed
    sockets are discarded, never re-pooled, so the retry/dedup
    semantics below are unchanged.

    An https:// URL connects over TLS (the server side auto-enables TLS
    when PIO_SSL_CERTFILE is set — serve_storage inherits it via
    common.server_security.maybe_wrap_ssl). CAFILE pins a custom CA (e.g.
    the self-signed cert from conf/); VERIFY=false disables verification
    for lab setups.

    Resilience knobs (all default-off; with none set, the wire behavior —
    headers, payloads, retry pattern — is byte-identical to the
    pre-resilience client, i.e. one immediate reconnect retry for
    idempotent calls and none for writes):

    - RETRIES / PIO_RPC_RETRIES, BACKOFF_MS / PIO_RPC_BACKOFF_MS,
      BACKOFF_MAX_MS, DEADLINE_MS — the RetryPolicy. Setting ANY of them
      also enables 5xx (502/503/504) retry with the server's Retry-After
      honored as the backoff floor, and DEADLINE_MS propagates the
      remaining budget per attempt via the X-PIO-Deadline-Ms header.
    - WRITE_DEDUP / PIO_RPC_WRITE_DEDUP=1 — event insert_batch carries a
      one-shot dedup token the server stores replies under, making the
      write safely retryable (exactly-once across lost responses).
    - PIO_BREAKER_ENABLED=1 (+ PIO_BREAKER_*) — a per-endpoint circuit
      breaker shared by every client in the process; when open, calls
      fast-fail with CircuitOpenError instead of queueing on a dead
      endpoint.
    - PIO_FAULT_SPEC — transport-boundary fault injection (chaos tests
      and the bench robustness leg; common/resilience.py).
    """

    def __init__(self, config):
        url = config.properties.get("URL", "http://localhost:7072")
        scheme = "http"
        if "://" in url:
            scheme, url = url.split("://", 1)
        self.tls = scheme.lower() == "https"
        self.host, _, port = url.partition(":")
        self.port = int(port.rstrip("/") or 7072)
        self.key = config.properties.get("KEY")
        self.timeout = float(config.properties.get("TIMEOUT", "30"))
        self.cafile = config.properties.get("CAFILE")
        self.verify = (config.properties.get(
            "VERIFY", "true").lower() != "false")
        pool_raw = str(config.properties.get(
            "POOL", os.environ.get("PIO_RPC_POOL", "8")))
        try:
            pool_size = int(pool_raw)
        except ValueError:
            pool_size = 8
        self._pool = _ConnectionPool(self._new_conn, pool_size)
        self.policy = resilience.RetryPolicy.from_env(
            "PIO_RPC", properties=config.properties)
        dedup_raw = str(config.properties.get(
            "WRITE_DEDUP",
            os.environ.get("PIO_RPC_WRITE_DEDUP", "0"))).lower()
        self.write_dedup = dedup_raw in ("1", "true", "yes")
        self.breaker = resilience.CircuitBreaker.for_endpoint(
            f"{self.host}:{self.port}")

    def _new_conn(self):
        import http.client
        if self.tls:
            import ssl
            if self.verify:
                ctx = ssl.create_default_context(cafile=self.cafile)
            else:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout, context=ctx)
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout)

    #: methods safe to replay after a dropped keep-alive connection; writes
    #: are NEVER transparently retried (the server may already have applied
    #: them — a replayed insert_batch would double-store every event)
    #: UNLESS the call carries a dedup token the server replays replies
    #: under (write_dedup), which makes the retry exactly-once.
    _IDEMPOTENT = frozenset({
        "get", "get_by_name", "get_all", "get_by_appid",
        "get_latest_completed", "get_completed", "find", "init",
        # cursor-tail reads: pure point-in-time reads, safely replayed
        "head_cursor", "cursor_lag",
    })

    #: transport failures eligible for an idempotent retry; includes
    #: http.client.HTTPException for torn keep-alive responses
    #: (IncompleteRead / BadStatusLine after a server restart)
    _TRANSPORT_ERRORS = (ConnectionError, OSError, http.client.HTTPException)

    def _transact(self, method: str, path: str, body: bytes,
                  headers: Dict[str, str], idempotent: bool):
        """One RPC through the full resilience stack: breaker gate, fault
        injection, bounded idempotency-aware retries with full-jitter
        backoff, per-attempt deadline header, Retry-After-floored 5xx
        retry. Returns (status, payload_bytes, response_headers).

        Tracing: when the calling thread carries a trace context, the
        whole RPC (all attempts) records a ``storage`` span and each
        attempt propagates ``X-PIO-Trace`` so the storage server's spans
        join the same trace — the exact X-PIO-Deadline-Ms pattern. With
        no active context no header is added: wire bytes identical."""
        if tracing.current() is None:
            return self._attempts(method, path, body, headers, idempotent)
        with tracing.span("storage", service=f"{self.host}:{self.port}"):
            return self._attempts(method, path, body, headers, idempotent)

    def _attempts(self, method: str, path: str, body: bytes,
                  headers: Dict[str, str], idempotent: bool):
        route = f"{method} {path}"
        deadline = self.policy.deadline_from_now()
        attempt = 0
        while True:
            if self.breaker is not None:
                self.breaker.allow()   # CircuitOpenError: fast-fail, no retry
            inj = resilience.active()
            conn = None
            try:
                if inj is not None:
                    inj.before_send("client", route)
                hdrs = headers
                if deadline is not None:
                    remaining_ms = int((deadline - time.monotonic()) * 1e3)
                    hdrs = {**headers,
                            "X-PIO-Deadline-Ms": str(max(0, remaining_ms))}
                ctx = tracing.current()
                if ctx is not None:   # propagate the trace across the wire
                    hdrs = {**hdrs, tracing.TRACE_HEADER: ctx.header_value()}
                conn = self._pool.acquire()
                conn.request(method, path, body=body, headers=hdrs)
                if inj is not None:
                    inj.after_send("client", route)
                resp = conn.getresponse()
                chunks = []
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    chunks.append(chunk)
                status, payload = resp.status, b"".join(chunks)
                rheaders = {k.lower(): v for k, v in resp.getheaders()}
                # the response is fully drained: hand the keep-alive
                # socket back unless the server asked to close it
                self._pool.release(conn, reusable=not resp.will_close)
                conn = None
                if inj is not None:
                    status, payload = inj.on_response(
                        "client", route, status, payload)
            except self._TRANSPORT_ERRORS:
                # the connection state is unknown; drop it so the retry
                # (or the next call) dials fresh — a failed socket is
                # never returned to the pool
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
                    conn = None
                if self.breaker is not None:
                    self.breaker.record(False)
                if not (idempotent
                        and self.policy.may_retry(attempt, deadline)):
                    if attempt > 0:
                        # a RETRIED call giving up is journal history
                        # (first-try failures are the ordinary error
                        # path); sys.exc_info avoids rebinding the
                        # in-flight exception
                        import sys
                        resilience.note_retries_exhausted(
                            route, attempt + 1, sys.exc_info()[1])
                    raise
                if telemetry.on():
                    _rpc_retries().labels(kind="transport").inc()
                time.sleep(self.policy.backoff_s(attempt))
                attempt += 1
                continue
            if (status in (502, 503, 504) and idempotent
                    and self.policy.configured
                    and self.policy.may_retry(attempt, deadline)):
                if self.breaker is not None:
                    self.breaker.record(False)
                try:
                    floor = float(rheaders.get("retry-after") or 0.0)
                except ValueError:
                    floor = 0.0
                if telemetry.on():
                    _rpc_retries().labels(kind="status").inc()
                time.sleep(self.policy.backoff_s(attempt, floor=floor))
                attempt += 1
                continue
            if self.breaker is not None:
                # 4xx is a caller mistake, not endpoint health
                self.breaker.record(status < 500)
            return status, payload, rheaders

    def call(self, dao: str, method: str, **args) -> Any:
        envelope: Dict[str, Any] = {"dao": dao, "method": method,
                                    "args": args}
        idempotent = method in self._IDEMPOTENT
        if (self.write_dedup and dao == "events"
                and method == "insert_batch"):
            # one-shot token: the server replays the stored reply if this
            # exact write already committed, so the retry cannot double-
            # store events — which is what makes it safe to retry at all
            import uuid
            envelope["dedup"] = uuid.uuid4().hex
            idempotent = True
        payload = json.dumps(envelope).encode()
        headers = {"Content-Type": "application/json"}
        if self.key:
            headers["X-PIO-Storage-Key"] = self.key
        status, data, _rheaders = self._transact(
            "POST", "/rpc", payload, headers, idempotent)
        out = json.loads(data.decode("utf-8"))
        if status != 200:
            raise RuntimeError(
                f"storage server error {status}: "
                f"{out.get('message', '')}")
        if out.get("deduped") and telemetry.on():
            # the server replayed a stored reply for a retried write —
            # the exactly-once path actually fired
            telemetry.registry().counter(
                "pio_rpc_dedup_replays_total",
                "Write retries answered from the server's dedup cache "
                "(exactly-once replays)").child().inc()
        return out.get("result")

    def proto(self) -> int:
        """Server protocol version (cached). Servers predating the paged
        find / binary routes report no "proto" field -> 1."""
        if getattr(self, "_proto", None) is None:
            try:
                status, payload = self.request_raw("GET", "/",
                                                   idempotent=True)
            except Exception:
                return 1   # transient: do NOT pin; re-probe next call
            if status == 200:
                self._proto = int(json.loads(payload).get("proto", 1))
            else:
                self._proto = 1
        return self._proto

    def request_raw(self, method: str, path: str, body: bytes = b"",
                    idempotent: Optional[bool] = None):
        """Binary-route transport: returns (status, payload_bytes). The
        response is drained in 1 MiB chunks so a multi-hundred-MB model
        blob or columnar reply never doubles through a JSON/base64 layer.

        Retries happen ONLY for idempotent requests (default: GETs). A
        non-idempotent POST must never be resent blindly — a
        ConnectionError after the server committed but before the
        response arrived would otherwise double-apply it. POST callers
        whose routes ARE replay-safe (columnar reads, same-bytes model
        puts) opt in explicitly."""
        if idempotent is None:
            idempotent = method == "GET"
        headers = {"Content-Type": "application/octet-stream"}
        if self.key:
            headers["X-PIO-Storage-Key"] = self.key
        status, payload, _rheaders = self._transact(
            method, path, body, headers, idempotent)
        return status, payload

    def close(self) -> None:
        self._pool.close()


class RemoteEvents(Events):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def init(self, app_id, channel_id=None) -> bool:
        return bool(self.c.call("events", "init", app_id=app_id,
                                channel_id=channel_id))

    def remove(self, app_id, channel_id=None) -> bool:
        return bool(self.c.call("events", "remove", app_id=app_id,
                                channel_id=channel_id))

    def close(self) -> None:
        self.c.close()

    def insert(self, event, app_id, channel_id=None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events, app_id, channel_id=None) -> List[str]:
        return self.c.call(
            "events", "insert_batch", app_id=app_id, channel_id=channel_id,
            events=[_enc_event(e) for e in events])

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        d = self.c.call("events", "get", event_id=event_id, app_id=app_id,
                        channel_id=channel_id)
        return None if d is None else _dec_event(d)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        return bool(self.c.call("events", "delete", event_id=event_id,
                                app_id=app_id, channel_id=channel_id))

    #: page size for unbounded finds — each reply stays ~a few MB of JSON
    PAGE = 10_000

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_=False) -> Iterator[Event]:
        want = None if limit is None or limit < 0 else limit  # -1 == all

        if self.c.proto() < 2:
            # old server: its find ignores `offset`, so paging would
            # duplicate boundary rows — use the legacy one-shot call
            rows = self.c.call(
                "events", "find", app_id=app_id, channel_id=channel_id,
                start_time=_iso(start_time), until_time=_iso(until_time),
                entity_type=entity_type, entity_id=entity_id,
                event_names=list(event_names) if event_names else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, limit=limit,
                reversed=reversed_)
            return iter([_dec_event(d) for d in rows])

        def call_page(st_iso, offset, page):
            return self.c.call(
                "events", "find", app_id=app_id, channel_id=channel_id,
                start_time=st_iso, until_time=_iso(until_time),
                entity_type=entity_type, entity_id=entity_id,
                event_names=list(event_names) if event_names else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                offset=offset, limit=page, reversed=reversed_)

        def pages_forward():
            # Time-cursor paging: each page re-requests from the last seen
            # event_time (inclusive) with an offset that skips only the
            # already-yielded events AT that timestamp — the backends scan
            # in a stable order, so each page costs O(page + ties) server
            # work instead of the O(prefix) an offset-only scheme pays.
            # The cursor stays in the server's own wire encoding so the
            # tie comparison is exact string equality.
            got, cur_s, skip = 0, _iso(start_time), 0
            while True:
                page = self.PAGE if want is None else min(
                    self.PAGE, want - got)
                if page <= 0:
                    return
                rows = call_page(cur_s, skip, page)
                for d in rows:
                    yield _dec_event(d)
                got += len(rows)
                if len(rows) < page:
                    return
                last_t = rows[-1].get("eventTime")
                at_last = sum(1 for d in rows if d.get("eventTime") == last_t)
                skip = (skip + at_last) if cur_s == last_t else at_last
                cur_s = last_t

        def pages_reversed():
            # descending scans have no clean inclusive cursor; they are
            # dashboard-style (small/limited), so plain offset windows
            got = 0
            while True:
                page = self.PAGE if want is None else min(
                    self.PAGE, want - got)
                if page <= 0:
                    return
                rows = call_page(_iso(start_time), got, page)
                for d in rows:
                    yield _dec_event(d)
                got += len(rows)
                if len(rows) < page:
                    return

        return pages_reversed() if reversed_ else pages_forward()

    # -- incremental cursor tail (realtime fold-in over a remote source) ----

    def cursor_tail_supported(self) -> bool:
        """Does the server expose the cursor-tail surface (proto >= 3,
        i.e. head_cursor / cursor_lag / the binary read_columns_since
        route)? Feature-detected so `pio foldin` against an old storage
        server refuses cleanly instead of failing per tick."""
        return self.c.proto() >= 3

    def head_cursor(self, app_id, channel_id=None):
        return self.c.call("events", "head_cursor", app_id=app_id,
                           channel_id=channel_id)

    def cursor_lag(self, app_id, channel_id=None, cursor=None) -> int:
        return int(self.c.call("events", "cursor_lag", app_id=app_id,
                               channel_id=channel_id, cursor=cursor))

    def read_columns_since(self, app_id, channel_id=None, cursor=None,
                           event_names=None, entity_type=None,
                           target_entity_type=None,
                           rating_property: str = "rating"):
        """Incremental twin of :meth:`read_columns` over the binary
        "PIOC" route: ``(new_cursor, columns)`` with the bulk-read keys
        plus ``creation_ms``. A tick's window is bounded by the tick
        interval, so one reply stays small."""
        import struct

        import numpy as np

        if not self.cursor_tail_supported():
            raise NotImplementedError(
                "storage server predates the cursor-tail surface "
                "(proto < 3)")
        body = json.dumps({
            "app_id": app_id, "channel_id": channel_id, "cursor": cursor,
            "event_names": list(event_names) if event_names else None,
            "entity_type": entity_type,
            "target_entity_type": target_entity_type,
            "rating_property": rating_property}).encode()
        status, payload = self.c.request_raw(
            "POST", "/rpc/read_columns_since", body, idempotent=True)
        if (status == 400 and b"cursor-tail" in payload) or status == 404:
            raise NotImplementedError(
                "backing store has no cursor-tail support")
        if status != 200:
            raise RuntimeError(
                f"storage server error {status}: {payload[:200]!r}")
        if payload[:4] != b"PIOC":
            raise RuntimeError("malformed columnar reply (bad magic)")
        hlen = struct.unpack("<I", payload[4:8])[0]
        header = json.loads(payload[8:8 + hlen].decode("utf-8"))
        expected = 8 + hlen + sum(
            n * np.dtype(dtype).itemsize
            for _name, dtype, n in header["cols"])
        if len(payload) < expected:
            raise RuntimeError(
                f"truncated columnar reply ({len(payload)} of "
                f"{expected} bytes)")
        out = {"pool": header["pool"]}
        mv = memoryview(payload)
        off = 8 + hlen
        for name, dtype, n in header["cols"]:
            dt = np.dtype(dtype)
            out[name] = np.frombuffer(mv, dtype=dt, count=n, offset=off)
            off += n * dt.itemsize
        return header["cursor"], out

    def read_columns(self, app_id, channel_id=None, event_names=None,
                     entity_type=None, target_entity_type=None,
                     rating_property: str = "rating", read_threads=None):
        """Columnar bulk read over the binary "PIOC" route — the
        store-server twin of eventlog.read_columns, so store.find_columnar
        takes the vectorized path against a `remote` EVENTDATA source too.
        Arrays come back as zero-copy np.frombuffer views of the reply.
        `read_threads` is a decode-parallelism hint forwarded to the
        server's backing store (eventlog chunks decode on a thread pool
        server-side; the server's own PIO_READ_THREADS is the default)."""
        import struct

        import numpy as np

        body = json.dumps({
            "app_id": app_id, "channel_id": channel_id,
            "event_names": list(event_names) if event_names else None,
            "entity_type": entity_type,
            "target_entity_type": target_entity_type,
            "rating_property": rating_property,
            "read_threads": read_threads}).encode()
        status, payload = self.c.request_raw(
            "POST", "/rpc/read_columns", body, idempotent=True)
        if (status == 400 and b"columnar" in payload) or status == 404:
            # backing store has no bulk-read support (or the server predates
            # the route): let the caller (store.find_columnar) fall back to
            # the per-event path
            raise NotImplementedError("backing store is not columnar")
        if status != 200:
            raise RuntimeError(
                f"storage server error {status}: {payload[:200]!r}")
        if payload[:4] != b"PIOC":
            raise RuntimeError("malformed columnar reply (bad magic)")
        hlen = struct.unpack("<I", payload[4:8])[0]
        header = json.loads(payload[8:8 + hlen].decode("utf-8"))
        expected = 8 + hlen + sum(
            n * np.dtype(dtype).itemsize
            for _name, dtype, n in header["cols"])
        if len(payload) < expected:
            # torn mid-body (proxy reset, injected truncation): surface a
            # clear integrity error rather than frombuffer's size message
            raise RuntimeError(
                f"truncated columnar reply ({len(payload)} of "
                f"{expected} bytes)")
        out = {"pool": header["pool"]}
        mv = memoryview(payload)
        off = 8 + hlen
        for name, dtype, n in header["cols"]:
            dt = np.dtype(dtype)
            out[name] = np.frombuffer(mv, dtype=dt, count=n, offset=off)
            off += n * dt.itemsize
        return out


class RemoteApps(Apps):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def insert(self, app: App) -> Optional[int]:
        return self.c.call("apps", "insert", app=dict(app.__dict__))

    def get(self, app_id: int) -> Optional[App]:
        d = self.c.call("apps", "get", app_id=app_id)
        return App(**d) if d else None

    def get_by_name(self, name: str) -> Optional[App]:
        d = self.c.call("apps", "get_by_name", name=name)
        return App(**d) if d else None

    def get_all(self) -> List[App]:
        return [App(**d) for d in self.c.call("apps", "get_all")]

    def update(self, app: App) -> None:
        self.c.call("apps", "update", app=dict(app.__dict__))

    def delete(self, app_id: int) -> None:
        self.c.call("apps", "delete", app_id=app_id)


class RemoteAccessKeys(AccessKeys):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    @staticmethod
    def _dec(d):
        return AccessKey(key=d["key"], appid=d["appid"],
                         events=tuple(d.get("events") or ()))

    def insert(self, k: AccessKey) -> Optional[str]:
        return self.c.call("access_keys", "insert",
                           k={**k.__dict__, "events": list(k.events)})

    def get(self, key: str) -> Optional[AccessKey]:
        d = self.c.call("access_keys", "get", key=key)
        return self._dec(d) if d else None

    def get_all(self) -> List[AccessKey]:
        return [self._dec(d) for d in self.c.call("access_keys", "get_all")]

    def get_by_appid(self, appid: int) -> List[AccessKey]:
        return [self._dec(d) for d in
                self.c.call("access_keys", "get_by_appid", appid=appid)]

    def update(self, k: AccessKey) -> None:
        self.c.call("access_keys", "update",
                    k={**k.__dict__, "events": list(k.events)})

    def delete(self, key: str) -> None:
        self.c.call("access_keys", "delete", key=key)


class RemoteChannels(Channels):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def insert(self, channel: Channel) -> Optional[int]:
        return self.c.call("channels", "insert",
                           channel=dict(channel.__dict__))

    def get(self, channel_id: int) -> Optional[Channel]:
        d = self.c.call("channels", "get", channel_id=channel_id)
        return Channel(**d) if d else None

    def get_by_appid(self, appid: int) -> List[Channel]:
        return [Channel(**d) for d in
                self.c.call("channels", "get_by_appid", appid=appid)]

    def delete(self, channel_id: int) -> None:
        self.c.call("channels", "delete", channel_id=channel_id)


class RemoteEngineInstances(EngineInstances):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def insert(self, i: EngineInstance) -> str:
        return self.c.call("engine_instances", "insert",
                           i=_enc_engine_instance(i))

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        d = self.c.call("engine_instances", "get", instance_id=instance_id)
        return _dec_engine_instance(d) if d else None

    def get_all(self) -> List[EngineInstance]:
        return [_dec_engine_instance(d) for d in
                self.c.call("engine_instances", "get_all")]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        d = self.c.call(
            "engine_instances", "get_latest_completed", engine_id=engine_id,
            engine_version=engine_version, engine_variant=engine_variant)
        return _dec_engine_instance(d) if d else None

    def get_completed(self, engine_id, engine_version, engine_variant):
        return [_dec_engine_instance(d) for d in self.c.call(
            "engine_instances", "get_completed", engine_id=engine_id,
            engine_version=engine_version, engine_variant=engine_variant)]

    def update(self, i: EngineInstance) -> None:
        self.c.call("engine_instances", "update", i=_enc_engine_instance(i))

    def delete(self, instance_id: str) -> None:
        self.c.call("engine_instances", "delete", instance_id=instance_id)


class RemoteEvaluationInstances(EvaluationInstances):
    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def insert(self, i: EvaluationInstance) -> str:
        return self.c.call("evaluation_instances", "insert",
                           i=_enc_evaluation_instance(i))

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        d = self.c.call("evaluation_instances", "get",
                        instance_id=instance_id)
        return _dec_evaluation_instance(d) if d else None

    def get_all(self) -> List[EvaluationInstance]:
        return [_dec_evaluation_instance(d) for d in
                self.c.call("evaluation_instances", "get_all")]

    def get_completed(self) -> List[EvaluationInstance]:
        return [_dec_evaluation_instance(d) for d in
                self.c.call("evaluation_instances", "get_completed")]

    def update(self, i: EvaluationInstance) -> None:
        self.c.call("evaluation_instances", "update",
                    i=_enc_evaluation_instance(i))

    def delete(self, instance_id: str) -> None:
        self.c.call("evaluation_instances", "delete",
                    instance_id=instance_id)


class RemoteModels(Models):
    """Model blobs ride the raw binary routes (S3Models.scala:36-95 /
    HDFSModels.scala:31-66 role): no base64 4/3 inflation, no whole-blob
    JSON parse; replies stream in 1 MiB chunks."""

    def __init__(self, client: StorageClient, config, namespace: str = ""):
        self.c = client

    def insert(self, m: Model) -> None:
        if self.c.proto() < 2:   # old server: legacy base64 DAO call
            self.c.call("models", "insert", id=m.id,
                        models=base64.b64encode(m.models).decode())
            return
        import urllib.parse
        # replay-safe POST: same id + same bytes overwrite in place
        status, payload = self.c.request_raw(
            "POST", "/rpc/model?id=" + urllib.parse.quote(m.id), m.models,
            idempotent=True)
        if status != 200:
            raise RuntimeError(
                f"storage server error {status}: {payload[:200]!r}")

    def get(self, model_id: str) -> Optional[Model]:
        if self.c.proto() < 2:
            d = self.c.call("models", "get", model_id=model_id)
            if d is None:
                return None
            return Model(id=d["id"], models=base64.b64decode(d["models"]))
        import urllib.parse
        status, payload = self.c.request_raw(
            "GET", "/rpc/model?id=" + urllib.parse.quote(model_id),
            idempotent=True)
        if status == 404 and b"unknown route" not in payload:
            return None
        if status != 200:
            raise RuntimeError(
                f"storage server error {status}: {payload[:200]!r}")
        return Model(id=model_id, models=payload)

    def delete(self, model_id: str) -> None:
        self.c.call("models", "delete", model_id=model_id)


def serve_storage(storage, host: str = "localhost", port: int = 7072,
                  key: Optional[str] = None):
    """Start (and return) the threaded storage server daemon."""
    from predictionio_tpu_torch.data.api.http import make_server

    server = make_server(StorageRPCAPI(storage, key=key), host, port)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
