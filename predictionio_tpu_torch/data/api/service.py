"""The Event Server route logic as a pure handler (port of
``predictionio_tpu/data/api/service.py``).

Reference: data/.../api/EventServer.scala:147-592. Every route is a method
on `EventAPI`; `handle()` dispatches (method, path) exactly like the spray
route tree, returning (status_code, json_payload). Transport lives in
predictionio_tpu_torch/data/api/http.py.

The telemetry routes (``/metrics``, ``/traces.json``, ``/debug/*``) are
served by ``common/telemetry.handle_route`` as in the reference, and the
device collector, the SLO engine and the metrics history recorder are
installed; the collector reads no card in this host-only daemon. Every
route answers byte for byte as the reference does.

Route surface parity:
  GET    /                          -> {"status": "alive"}
  GET    /plugins.json              -> plugin inventory
  GET    /plugins/<type>/<name>/... -> plugin REST handoff
  GET    /events/<id>.json          -> event | 404
  DELETE /events/<id>.json          -> {"message": "Found"} | 404
  POST   /events.json               -> 201 {"eventId": id}
  GET    /events.json               -> filtered list (default limit 20)
  POST   /batch/events.json         -> per-item statuses, cap 50
                                       (PIO_BATCH_EVENTS_MAX overrides)
  GET    /stats.json                -> stats | 404 unless --stats
  POST   /webhooks/<name>.json      -> connector ingest
  GET    /webhooks/<name>.json      -> connector presence check
  POST   /webhooks/<name>.form      -> form connector ingest
  GET    /webhooks/<name>.form      -> form connector presence check
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import logging
import os
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.common import (
    devicewatch, history, slo, telemetry,
)
from predictionio_tpu_torch.data.api.plugins import (
    EventInfo, EventServerPluginContext,
)
from predictionio_tpu_torch.data.api.stats import StatsBook
from predictionio_tpu_torch.data.event import Event, parse_event_time, utcnow_ms
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.data.webhooks import (
    ConnectorException, default_form_connectors, default_json_connectors,
    to_event,
)

logger = logging.getLogger("predictionio_tpu_torch.api")

MAX_EVENTS_PER_BATCH_REQUEST = 50  # EventServer.scala:70 (default cap)

Response = Tuple[int, Any]


def batch_events_max() -> int:
    """Per-request item cap for POST /batch/events.json:
    ``PIO_BATCH_EVENTS_MAX`` overrides the reference's hardcoded 50
    (EventServer.scala:70); unset/invalid keeps the default. Read per
    request so operators can retune a live server via restart-free
    tooling that rewrites the environment of a new deploy."""
    raw = os.environ.get("PIO_BATCH_EVENTS_MAX", "")
    try:
        v = int(raw) if raw else 0
    except ValueError:
        v = 0
    return v if v > 0 else MAX_EVENTS_PER_BATCH_REQUEST


def batch_bulk_insert() -> bool:
    """Store a batch request's accepted items in one ``insert_batch``
    call (default) or one at a time (``PIO_BATCH_BULK_INSERT=0``). Bulk
    is the ingest hot path — one storage-lock round trip and one WAL
    group-commit wait per request; per-item keeps the pre-bulk behavior
    where a storage failure mid-batch isolates to that item (and is the
    configuration the bench's threaded baseline leg reproduces)."""
    return os.environ.get("PIO_BATCH_BULK_INSERT", "1") != "0"


@dataclasses.dataclass
class EventServerConfig:
    """EventServerConfig (EventServer.scala:645-650)."""
    ip: str = "localhost"
    port: int = 7070
    plugins: str = "plugins"
    stats: bool = False


@dataclasses.dataclass
class AuthData:
    """Authenticated request context (EventServer.scala:89)."""
    app_id: int
    channel_id: Optional[int]
    events: Sequence[str]


class _AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class EventAPI:
    """The pure route handler; one instance per daemon."""

    def __init__(self, storage: Optional[Storage] = None,
                 config: Optional[EventServerConfig] = None,
                 plugin_context: Optional[EventServerPluginContext] = None,
                 json_connectors: Optional[Dict[str, Any]] = None,
                 form_connectors: Optional[Dict[str, Any]] = None):
        self.storage = storage or get_storage()
        self.config = config or EventServerConfig()
        self.events = self.storage.get_events()
        self.access_keys = self.storage.get_meta_data_access_keys()
        self.channels = self.storage.get_meta_data_channels()
        self.plugin_context = plugin_context or EventServerPluginContext()
        self.stats = StatsBook()
        self.json_connectors = (default_json_connectors()
                                if json_connectors is None else json_connectors)
        self.form_connectors = (default_form_connectors()
                                if form_connectors is None else form_connectors)
        #: flipped by the graceful-shutdown path (http.serve_forever on
        #: SIGTERM) so /readyz steers load balancers away while in-flight
        #: ingests and the final WAL flush complete
        self.draining = False
        # device gauges on this daemon's /metrics and /debug/device.json
        # too (the scrape surface is uniform; idempotent)
        devicewatch.install()
        # SLO burn-rate gauges on /metrics (no-op until telemetry is on)
        slo.install()
        # metrics flight recorder: /debug/history.json rings (one
        # sampler thread per process)
        history.install()

    # ------------------------------------------------------------------ auth
    def _authenticate(self, query: Dict[str, str],
                      headers: Dict[str, str]) -> AuthData:
        """accessKey query param, else Basic auth username
        (EventServer.scala:92-130). Raises _AuthError on failure."""
        access_key = query.get("accessKey")
        channel = query.get("channel")
        if access_key is not None:
            k = self.access_keys.get(access_key)
            if k is None:
                raise _AuthError(401, "Invalid accessKey.")
            if channel is not None:
                channel_map = {
                    c.name: c.id for c in self.channels.get_by_appid(k.appid)}
                if channel not in channel_map:
                    raise _AuthError(401, f"Invalid channel '{channel}'.")
                return AuthData(k.appid, channel_map[channel], k.events)
            return AuthData(k.appid, None, k.events)
        # Basic auth: accessKey is the username (header path ignores the
        # channel param, matching EventServer.scala:115-127)
        auth = headers.get("authorization") or headers.get("Authorization")
        if auth:
            parts = auth.strip().split(None, 1)
            # auth-scheme is case-insensitive (RFC 7235 §2.1)
            if len(parts) == 2 and parts[0].lower() == "basic":
                try:
                    decoded = base64.b64decode(parts[1]).decode("utf-8")
                except (binascii.Error, UnicodeDecodeError):
                    raise _AuthError(401, "Invalid accessKey.") from None
                key = decoded.strip().split(":")[0]
                k = self.access_keys.get(key)
                if k is not None:
                    return AuthData(k.appid, None, k.events)
            raise _AuthError(401, "Invalid accessKey.")
        raise _AuthError(401, "Missing accessKey.")

    # ------------------------------------------------------------- dispatch
    def handle(self, method: str, path: str,
               query: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               headers: Optional[Dict[str, str]] = None) -> Response:
        method = method.upper()
        query = query or {}
        headers = headers or {}
        try:
            return self._route(method, path, query, body, headers)
        except _AuthError as e:
            return e.status, {"message": e.message}
        except Exception as e:  # Common.exceptionHandler parity
            logger.exception("request failed: %s %s", method, path)
            return 500, {"message": str(e)}

    def _route(self, method, path, query, body, headers) -> Response:
        path = path.rstrip("/") or "/"
        if path == "/" and method == "GET":
            return 200, {"status": "alive"}
        if path == "/healthz" and method == "GET":
            return 200, {"status": "ok"}
        t = telemetry.handle_route(
            method, path, query,
            accept=headers.get("accept") or headers.get("Accept"))
        if t is not None:   # /metrics, /traces.json, /debug/*
            return t
        if path == "/readyz" and method == "GET":
            if self.draining:
                return 503, {"status": "draining"}
            try:   # storage reachable = the DAOs answer a trivial probe
                self.access_keys.get("")
            except Exception as e:
                return 503, {"status": "unready",
                             "message": f"{type(e).__name__}: {e}"}
            return 200, {"status": "ready"}
        if path == "/plugins.json" and method == "GET":
            return 200, self.plugin_context.describe()
        if path.startswith("/plugins/") and method == "GET":
            return self._plugins_rest(path, query, headers)
        if path == "/events.json":
            auth = self._authenticate(query, headers)
            if method == "POST":
                return self._post_event(auth, body)
            if method == "GET":
                return self._get_events(auth, query)
            return 405, {"message": "method not allowed"}
        if path.startswith("/events/") and path.endswith(".json"):
            auth = self._authenticate(query, headers)
            event_id = urllib.parse.unquote(path[len("/events/"):-len(".json")])
            if method == "GET":
                return self._get_event(auth, event_id)
            if method == "DELETE":
                return self._delete_event(auth, event_id)
            return 405, {"message": "method not allowed"}
        if path == "/batch/events.json" and method == "POST":
            auth = self._authenticate(query, headers)
            return self._post_batch(auth, body)
        if path == "/stats.json" and method == "GET":
            auth = self._authenticate(query, headers)
            if not self.config.stats:
                return 404, {"message": "To see stats, launch Event Server "
                                        "with --stats argument."}
            return 200, self.stats.get(auth.app_id)
        if path.startswith("/webhooks/") and path.endswith(".json"):
            auth = self._authenticate(query, headers)
            name = path[len("/webhooks/"):-len(".json")]
            if method == "POST":
                return self._webhook_json_post(auth, name, body)
            if method == "GET":
                return self._webhook_check(self.json_connectors, name)
            return 405, {"message": "method not allowed"}
        if path.startswith("/webhooks/") and path.endswith(".form"):
            auth = self._authenticate(query, headers)
            name = path[len("/webhooks/"):-len(".form")]
            if method == "POST":
                return self._webhook_form_post(auth, name, body)
            if method == "GET":
                return self._webhook_check(self.form_connectors, name)
            return 405, {"message": "method not allowed"}
        return 404, {"message": "Not Found"}

    # ------------------------------------------------------------ handlers
    def _bookkeep(self, auth: AuthData, status: int, event: Event) -> None:
        if not self.config.stats and not self.plugin_context.input_sniffers:
            return   # per-event call on the batch hot path: nothing to do
        if self.config.stats:
            self.stats.bookkeeping(auth.app_id, status, event)
        for sniffer in self.plugin_context.input_sniffers.values():
            try:
                sniffer.process(
                    EventInfo(auth.app_id, auth.channel_id, event),
                    self.plugin_context)
            except Exception:
                logger.exception("input sniffer failed")

    def _insert_one(self, auth: AuthData, event: Event) -> str:
        for blocker in self.plugin_context.input_blockers.values():
            blocker.process(
                EventInfo(auth.app_id, auth.channel_id, event),
                self.plugin_context)
        return self.events.insert(event, auth.app_id, auth.channel_id)

    def _post_event(self, auth: AuthData, body: bytes) -> Response:
        try:
            event = Event.from_json(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        if auth.events and event.event not in auth.events:
            return 403, {"message": f"{event.event} events are not allowed"}
        event_id = self._insert_one(auth, event)
        self._bookkeep(auth, 201, event)
        return 201, {"eventId": event_id}

    def _get_event(self, auth: AuthData, event_id: str) -> Response:
        e = self.events.get(event_id, auth.app_id, auth.channel_id)
        if e is None:
            return 404, {"message": "Not Found"}
        return 200, e.to_dict()

    def _delete_event(self, auth: AuthData, event_id: str) -> Response:
        found = self.events.delete(event_id, auth.app_id, auth.channel_id)
        if found:
            return 200, {"message": "Found"}
        return 404, {"message": "Not Found"}

    def _get_events(self, auth: AuthData, query: Dict[str, str]) -> Response:
        """GET /events.json filters (EventServer.scala:303-375)."""
        try:
            reversed_ = _parse_bool(query.get("reversed"))
            limit = int(query["limit"]) if "limit" in query else 20
            if reversed_ and not (query.get("entityType")
                                  and query.get("entityId")):
                raise ValueError(
                    "the parameter reversed can only be used with both "
                    "entityType and entityId specified.")
            start_time = (parse_event_time(query["startTime"])
                          if "startTime" in query else None)
            until_time = (parse_event_time(query["untilTime"])
                          if "untilTime" in query else None)
            event_names = ([query["event"]] if "event" in query else None)
            results = list(self.events.find(
                app_id=auth.app_id,
                channel_id=auth.channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=query.get("entityType"),
                entity_id=query.get("entityId"),
                event_names=event_names,
                target_entity_type=query.get("targetEntityType"),
                target_entity_id=query.get("targetEntityId"),
                limit=None if limit == -1 else limit,
                reversed_=bool(reversed_),
            ))
        except ValueError as e:
            return 400, {"message": str(e)}
        if not results:
            return 404, {"message": "Not Found"}
        return 200, [e.to_dict() for e in results]

    def _post_batch(self, auth: AuthData, body: bytes) -> Response:
        """POST /batch/events.json (EventServer.scala:376-462): per-item
        statuses in original order; whole request is 200 unless oversized.

        Every item that survives validation/authorization/blockers is
        stored in ONE ``insert_batch`` call: a cap-50 request pays one
        storage-lock round trip and one WAL group-commit wait instead of
        50 (and against a `remote` event store, one RPC instead of 50) —
        this is the ingest front door's hot path. The trade: a storage
        failure now fails the whole accepted sub-batch with per-item
        500s rather than item-by-item, which for the supported backends
        is the realistic failure shape anyway (the WAL/RPC is down, not
        one row)."""
        try:
            items = json.loads(body.decode("utf-8"))
            if not isinstance(items, list):
                raise ValueError("batch body must be a JSON array")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        cap = batch_events_max()
        if len(items) > cap:
            return 400, {"message":
                         "Batch request must have less than or equal to "
                         f"{cap} events"}
        bulk = batch_bulk_insert()
        now = utcnow_ms()   # one shared arrival timestamp per request
        allowed = auth.events
        blockers = self.plugin_context.input_blockers
        results: List[Optional[Dict[str, Any]]] = [None] * len(items)
        accepted: List[Tuple[int, Event]] = []
        for j, item in enumerate(items):
            try:
                event = Event.from_dict(item, now=now)
            except ValueError as e:
                results[j] = {"status": 400, "message": str(e)}
                continue
            if allowed and event.event not in allowed:
                results[j] = {
                    "status": 403,
                    "message": f"{event.event} events are not allowed"}
                continue
            try:
                if blockers:
                    for blocker in blockers.values():
                        blocker.process(
                            EventInfo(auth.app_id, auth.channel_id, event),
                            self.plugin_context)
                if not bulk:
                    event_id = self.events.insert(
                        event, auth.app_id, auth.channel_id)
                    self._bookkeep(auth, 201, event)
                    results[j] = {"status": 201, "eventId": event_id}
                    continue
            except Exception as e:
                results[j] = {"status": 500, "message": str(e)}
                continue
            accepted.append((j, event))
        if accepted:
            try:
                ids = self.events.insert_batch(
                    [e for _, e in accepted], auth.app_id, auth.channel_id)
            except Exception as e:
                for j, _e in accepted:
                    results[j] = {"status": 500, "message": str(e)}
            else:
                for (j, event), event_id in zip(accepted, ids):
                    self._bookkeep(auth, 201, event)
                    results[j] = {"status": 201, "eventId": event_id}
        return 200, results

    # ------------------------------------------------------------ webhooks
    def _webhook_json_post(self, auth: AuthData, name: str,
                           body: bytes) -> Response:
        connector = self.json_connectors.get(name)
        if connector is None:
            return 404, {"message":
                         f"webhooks connection for {name} is not supported."}
        try:
            data = json.loads(body.decode("utf-8"))
            event = to_event(connector, data)
        except (ConnectorException, ValueError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        event_id = self._insert_one(auth, event)
        self._bookkeep(auth, 201, event)
        return 201, {"eventId": event_id}

    def _webhook_form_post(self, auth: AuthData, name: str,
                           body: bytes) -> Response:
        connector = self.form_connectors.get(name)
        if connector is None:
            return 404, {"message":
                         f"webhooks connection for {name} is not supported."}
        try:
            fields = dict(urllib.parse.parse_qsl(
                body.decode("utf-8"), keep_blank_values=True))
            event = to_event(connector, fields)
        except (ConnectorException, ValueError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        event_id = self._insert_one(auth, event)
        self._bookkeep(auth, 201, event)
        return 201, {"eventId": event_id}

    @staticmethod
    def _webhook_check(registry: Dict[str, Any], name: str) -> Response:
        if name in registry:
            return 200, {"message": "Ok"}
        return 404, {"message":
                     f"webhooks connection for {name} is not supported."}

    # ------------------------------------------------------------- plugins
    def _plugins_rest(self, path: str, query: Dict[str, str],
                      headers: Dict[str, str]) -> Response:
        from predictionio_tpu_torch.common.plugin_registry import (
            dispatch_plugin_rest,
        )
        auth = self._authenticate(query, headers)
        return dispatch_plugin_rest(
            self.plugin_context, path,
            lambda p, args: p.handle_rest(auth.app_id, auth.channel_id, args))


def _parse_bool(v: Optional[str]) -> bool:
    if v is None:
        return False
    if v.lower() in ("true", "1"):
        return True
    if v.lower() in ("false", "0"):
        return False
    raise ValueError(f"invalid boolean {v!r}")
