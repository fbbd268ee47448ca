"""`pio router`, the fault-tolerant front door of a query-server fleet
(port of ``predictionio_tpu/workflow/router.py``). The router touches no
tensor: its path to the card is the replicas it forwards to, each of
which answers through B1 + B2.

One process, however sharded or quantized, caps at one host; this
is the scale-out half. This daemon fans ``POST /queries.json``
out to N query-server replicas over keep-alive connections, and the
product is robustness, not routing cleverness — a fleet only earns its
second replica if the front door survives a replica dying mid-request:

- **Health-driven membership.** A poller thread reads each backend's
  ``/readyz`` (liveness + readiness + the model ``generation`` id) on a
  ``PIO_ROUTER_HEALTH_MS`` cadence; a failing backend is ejected from
  rotation and re-admitted when the probe recovers, with a journal
  event (category ``router``) on every transition. Each backend also
  carries its own always-on :class:`resilience.CircuitBreaker`, so a
  replica failing *requests* (not just probes) fast-fails out of
  rotation between polls.
- **Per-request failover.** ``POST /queries.json`` is a pure read, so a
  forward that fails in transport or times out on one replica is
  retried ONCE on another (``resilience.RetryPolicy`` bounds the
  schedule). The router's deadline budget (``PIO_ROUTER_DEADLINE_MS``,
  or a smaller incoming ``X-PIO-Deadline-Ms``) is propagated to the
  backend and spent across attempts: a spent budget answers 504 instead
  of retrying. No other route is ever failover-retried — a
  non-idempotent request replayed after a torn response could
  double-apply.
- **Load shedding.** Admission is bounded (``PIO_ROUTER_MAX_INFLIGHT``)
  and an empty rotation (every backend ejected, draining or
  breaker-open) answers the existing ``503 + Retry-After`` contract
  immediately — the router never queues unboundedly in front of a dead
  fleet.
- **Coordinated hot-swap barrier.** ``POST /reload`` drains each
  backend's reload one at a time behind the QueryAPI ``generation`` id:
  queries keep routing ONLY to backends still on the old generation
  while replicas flip one by one; when a single old replica remains the
  router cuts over atomically to the already-flipped set, then reloads
  the last one. A fleet therefore never serves two model generations
  to one client (per-client responses are generation-monotonic) and
  zero queries drop during the swap — each replica's own in-process
  hot-swap keeps its in-flight requests answered.

The router is itself a first-class daemon on the shared transport
(data/api/http.py — ``PIO_TRANSPORT=async`` gives it the keep-alive
event loop): ``/metrics``, ``/healthz``, ``/readyz``,
``/debug/events.json`` and the rest of ``telemetry.handle_route``, plus
trace adoption — an incoming ``X-PIO-Trace`` is propagated to the
chosen backend so ``pio trace`` assembles router→replica trees.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import http.client
import itertools
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.common import journal, resilience, telemetry, tracing

logger = logging.getLogger("predictionio_tpu_torch.router")

#: (status, payload) or (status, payload, extra_headers) — same handler
#: contract as every other daemon on the shared transport.
Response = Tuple[int, Any]

#: transport failures that trigger a failover retry (torn keep-alive
#: responses after a replica kill surface as HTTPException)
_TRANSPORT_ERRORS = (ConnectionError, OSError, http.client.HTTPException)


def _env_pos(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        v = float(raw) if raw else default
    except ValueError:
        v = default
    return v if v > 0 else default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        v = int(raw) if raw else default
    except ValueError:
        v = default
    return v if v > 0 else default


@dataclasses.dataclass
class RouterConfig:
    """`pio router` args. Every knob has an env twin so a config-managed
    fleet and an ad-hoc one read the same defaults."""
    backends: Tuple[str, ...] = ()
    ip: str = "localhost"
    port: int = 8100
    #: membership poll cadence (each backend's /readyz) in ms
    health_ms: float = 0.0
    #: per-query deadline budget in ms (an incoming X-PIO-Deadline-Ms
    #: smaller than this wins); spent budget = 504, never a retry
    deadline_ms: float = 0.0
    #: admission ceiling: concurrent in-flight forwards beyond this shed
    #: with 503 + Retry-After instead of queueing
    max_inflight: int = 0
    #: per-tenant admission ceiling (multi-tenant backends): concurrent
    #: in-flight forwards carrying one tenant's access key beyond this
    #: shed with a tenant-labeled 503 — one tenant's flood never fills
    #: the shared inflight pool. 0 (the default) disables the cap:
    #: single-tenant fleets keep the uncapped behavior byte for byte.
    tenant_max_inflight: int = 0
    #: front-door response cache: "on" answers repeat (tenant, query
    #: bytes, model generation) hits from a bounded LRU without touching
    #: a replica. The generation in the key makes hot-swap invalidation
    #: free — a /reload bumps the generation and every old entry is
    #: unreachable; under multi-tenancy the key uses the PER-TENANT
    #: generation, so one tenant's reload invalidates only its own
    #: entries. "off" (the default) keeps every response byte-identical
    #: to the uncached router. PIO_ROUTER_CACHE overrides.
    cache: str = ""
    #: response-cache byte budget in MB (LRU past it); PIO_ROUTER_CACHE_MB
    cache_mb: int = 0
    #: response-cache entry TTL in ms — bounds fold-in staleness
    #: (published fold-in rows do not bump the generation);
    #: PIO_ROUTER_CACHE_TTL_MS
    cache_ttl_ms: float = 0.0

    def resolved(self) -> "RouterConfig":
        return dataclasses.replace(
            self,
            health_ms=self.health_ms or _env_pos("PIO_ROUTER_HEALTH_MS", 500.0),
            deadline_ms=(self.deadline_ms
                         or _env_pos("PIO_ROUTER_DEADLINE_MS", 2000.0)),
            max_inflight=(self.max_inflight
                          or _env_int("PIO_ROUTER_MAX_INFLIGHT", 256)),
            tenant_max_inflight=(
                self.tenant_max_inflight
                or _env_int("PIO_ROUTER_TENANT_MAX_INFLIGHT", 0)),
            cache=self.cache or os.environ.get("PIO_ROUTER_CACHE", "off"),
            cache_mb=(self.cache_mb
                      or _env_int("PIO_ROUTER_CACHE_MB", 16)),
            cache_ttl_ms=(self.cache_ttl_ms
                          or _env_pos("PIO_ROUTER_CACHE_TTL_MS", 5000.0)))

    @property
    def cache_on(self) -> bool:
        return str(self.cache).strip().lower() in ("1", "on", "true", "yes")


def _parse_backend(url: str) -> Tuple[str, int]:
    u = url.strip()
    if "://" in u:
        scheme, u = u.split("://", 1)
        if scheme.lower() != "http":
            raise ValueError(
                f"router backends must be http:// URLs, got {url!r}")
    host, _, port = u.partition(":")
    if not host or not port.rstrip("/").isdigit():
        raise ValueError(
            f"router backend {url!r} must be host:port or http://host:port")
    return host, int(port.rstrip("/"))


class _ResponseCache:
    """Bounded-LRU front-door response cache.

    Keys are ``(tenant, generation-token, raw query bytes)`` — the
    generation token is the fleet's agreed model generation for that
    tenant at lookup time, so a hot-swap invalidates by CONSTRUCTION
    (old entries become unreachable) and a TTL bounds what generation
    keying cannot see (fold-in row publishes). Only
    200 responses are stored. Thread-safe; sizes are accounted in bytes
    (query bytes + compact-JSON response bytes) against ``max_bytes``,
    evicting least-recently-used past it."""

    def __init__(self, max_bytes: int, ttl_s: float):
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._entries: "collections.OrderedDict[Tuple[str, Any, bytes], Tuple[float, int, int, Any, Dict[str, str]]]" = (
            collections.OrderedDict())
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple[str, Any, bytes]) -> Optional[Response]:
        now = time.perf_counter()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            expires, size, status, obj, extra = entry
            if now >= expires:
                # expired entries count as evictions, not hits — the
                # TTL is doing its staleness-bounding job
                del self._entries[key]
                self._bytes -= size
                self.evictions += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return (status, obj, dict(extra)) if extra else (status, obj)

    def put(self, key: Tuple[str, Any, bytes], status: int, obj: Any,
            extra: Optional[Dict[str, str]] = None) -> int:
        """Store one response; returns how many entries were evicted."""
        try:
            size = len(key[2]) + len(
                json.dumps(obj, separators=(",", ":")).encode("utf-8"))
        except (TypeError, ValueError):
            return 0                      # unserializable — never cache
        if size > self.max_bytes:
            return 0
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (time.perf_counter() + self.ttl_s, size,
                                  status, obj, dict(extra or {}))
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _, (_, esize, _, _, _) = self._entries.popitem(last=False)
                self._bytes -= esize
                evicted += 1
            self.evictions += evicted
        return evicted

    def invalidate_tenant(self, tenant: str) -> int:
        """Drop every entry of one tenant (its generation moved — the
        entries are already unreachable; this reclaims their bytes
        immediately instead of waiting out the TTL)."""
        with self._lock:
            stale = [k for k in self._entries if k[0] == tenant]
            for k in stale:
                self._bytes -= self._entries.pop(k)[1]
            self.evictions += len(stale)
            return len(stale)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            looked = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "maxBytes": self.max_bytes,
                "ttlMs": round(self.ttl_s * 1e3, 1),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hitRatio": (self.hits / looked) if looked else 0.0,
            }


class _Backend:
    """One replica: membership state + keep-alive connections + breaker.

    ``healthy`` is the poller's verdict (readiness probe), ``admitted``
    the reload barrier's (a flipped-but-not-cut-over replica is healthy
    yet held out of rotation). A backend serves queries only when both
    hold AND its breaker admits the call.
    """

    #: idle keep-alive sockets retained per backend
    POOL = 4

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.host, self.port = _parse_backend(url)
        self.name = f"{self.host}:{self.port}"
        self.healthy = False
        self.admitted = True
        #: autopilot hold-out: a latency-outlier replica is quarantined
        #: (out of rotation) before its breaker trips, and re-admitted
        #: explicitly — unlike ``healthy`` the poller never flips this
        self.quarantined = False
        self.generation: Optional[int] = None
        #: per-tenant generation ids (multi-tenant backends report a
        #: dict on /readyz; None for a legacy single-engine replica)
        self.tenant_generations: Optional[Dict[str, int]] = None
        #: the item-shard range this replica owns (partition-routed
        #: deploys advertise {"index","count","lo","hi","rows","nItems"}
        #: on /readyz; None for a full-model replica)
        self.partition: Optional[Dict[str, Any]] = None
        self.draining = False
        #: always-on breaker (unlike the remote storage client's opt-in
        #: registry): a fleet front door without one queues on corpses.
        #: Tuned by the same PIO_BREAKER_* knobs operators already know.
        self.breaker = resilience.CircuitBreaker(
            self.name,
            window_s=_env_pos("PIO_BREAKER_WINDOW_S", 30.0),
            error_threshold=_env_pos("PIO_BREAKER_ERROR_RATE", 0.5),
            min_calls=_env_int("PIO_BREAKER_MIN_CALLS", 10),
            open_s=_env_pos("PIO_BREAKER_OPEN_S", 5.0))
        self._idle: List[http.client.HTTPConnection] = []
        self._idle_lock = threading.Lock()

    # ------------------------------------------------------------- transport
    def _acquire(self, timeout: float) -> http.client.HTTPConnection:
        with self._idle_lock:
            conn = self._idle.pop() if self._idle else None
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=timeout)
        elif conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _release(self, conn, reusable: bool) -> None:
        if reusable:
            with self._idle_lock:
                if len(self._idle) < self.POOL:
                    self._idle.append(conn)
                    return
        try:
            conn.close()
        except Exception:
            pass

    def request(self, method: str, path: str, body: bytes,
                headers: Dict[str, str], timeout: float
                ) -> Tuple[int, bytes, Dict[str, str]]:
        """One forwarded request over a pooled keep-alive connection.
        Raises the transport error on failure; a failed socket is never
        re-pooled (the failover retry dials fresh elsewhere)."""
        conn = self._acquire(timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            rheaders = {k.lower(): v for k, v in resp.getheaders()}
            self._release(conn, reusable=not resp.will_close)
            return resp.status, payload, rheaders
        except BaseException:
            try:
                conn.close()
            except Exception:
                pass
            raise

    def probe(self, timeout: float = 2.0
              ) -> Tuple[bool, bool, Optional[int],
                         Optional[Dict[str, int]],
                         Optional[Dict[str, Any]]]:
        """(healthy, draining, generation, tenant_generations,
        partition) from one /readyz read over a FRESH connection — a
        pooled keep-alive socket can outlive the listener it connected
        to, and membership must answer "can a new request reach this
        replica", not "does an old socket still drain". A 503 body
        still carries ``status``/``generation`` — a draining replica is
        distinguishable from a dead one. Multi-tenant replicas also
        report a per-tenant ``generations`` dict; partition-scoped
        replicas report the owned item-row range; a legacy replica's
        body has neither key and those elements stay None."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            status, payload = resp.status, resp.read()
        except _TRANSPORT_ERRORS:
            return False, False, None, None, None
        finally:
            try:
                conn.close()
            except Exception:
                pass
        gen: Optional[int] = None
        tenant_gens: Optional[Dict[str, int]] = None
        partition: Optional[Dict[str, Any]] = None
        draining = False
        try:
            obj = json.loads(payload)
            if isinstance(obj, dict):
                if obj.get("generation") is not None:
                    gen = int(obj["generation"])
                raw = obj.get("generations")
                if isinstance(raw, dict):
                    tenant_gens = {str(k): int(v)
                                   for k, v in raw.items()}
                rawp = obj.get("partition")
                if (isinstance(rawp, dict)
                        and rawp.get("index") is not None
                        and rawp.get("count") is not None):
                    partition = {
                        "index": int(rawp["index"]),
                        "count": int(rawp["count"]),
                        "lo": int(rawp.get("lo", 0)),
                        "hi": int(rawp.get("hi", 0)),
                        "rows": int(rawp.get("rows", 0)),
                        "nItems": int(rawp.get("nItems", 0)),
                    }
                draining = obj.get("status") == "draining"
        except (ValueError, TypeError):
            pass
        return status == 200, draining, gen, tenant_gens, partition

    def close(self) -> None:
        with self._idle_lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass

    def state(self) -> Dict[str, Any]:
        out = {
            "url": self.url,
            "healthy": self.healthy,
            "inRotation": (self.healthy and self.admitted
                           and not self.quarantined),
            "draining": self.draining,
            "generation": self.generation,
            "breaker": self.breaker.state,
        }
        if self.quarantined:
            # only while held out (wire parity: an untouched fleet's
            # payload keeps the legacy key set)
            out["quarantined"] = True
        if self.tenant_generations is not None:
            # only for multi-tenant replicas: a legacy fleet's status
            # payload keeps the legacy key set (wire parity)
            out["generations"] = dict(self.tenant_generations)
        if self.partition is not None:
            # only for partition-scoped replicas (same parity rule)
            out["partition"] = dict(self.partition)
        return out


class RouterAPI:
    """Pure route handler for the fleet front door (hosted by
    data/api/http.make_server like every other daemon)."""

    def __init__(self, config: RouterConfig):
        if not config.backends:
            raise ValueError("router needs at least one backend "
                             "(--backends url,...)")
        self.config = config.resolved()
        self.backends = [_Backend(u) for u in self.config.backends]
        if len({b.name for b in self.backends}) != len(self.backends):
            raise ValueError("router backends must be distinct host:port "
                             f"pairs, got {list(self.config.backends)}")
        self._lock = threading.Lock()
        self._rr = itertools.count()
        #: the failover schedule: exactly one retry, no backoff sleep —
        #: the replacement replica is immediately available or the
        #: request should surface, and the deadline (not a sleep curve)
        #: bounds the whole operation
        self._retry = resilience.RetryPolicy(max_attempts=2)
        #: admission ceilings as plain counters (not a Semaphore): the
        #: autopilot's degradation ladder adjusts them at runtime, and a
        #: Semaphore's capacity cannot shrink under load
        self._max_inflight = self.config.max_inflight
        self._tenant_cap = self.config.tenant_max_inflight
        self._inflight_count = 0
        self._stop_requested = threading.Event()
        self._draining = threading.Event()
        self._reload_lock = threading.Lock()
        self._reload_state: Dict[str, Any] = {"active": False}
        #: tenant-aware front door: access key -> tenant name, learned
        #: from backend X-PIO-Tenant response headers (the backend's
        #: AccessKeys-DAO resolution — the router never opens a storage
        #: connection of its own); and the per-tenant in-flight counts
        #: the tenant_max_inflight cap charges. Keys that have not
        #: answered yet are charged under the key itself, so the cap
        #: binds from the very first request.
        self._tenant_by_key: Dict[str, str] = {}
        self._tenant_inflight: Dict[str, int] = {}
        #: partition-routed mode: the current partition map — a snapshot
        #: {"count","generation","nItems","owners": {index: [backends]}}
        #: rebuilt after every membership change and swapped ATOMICALLY
        #: (one attribute assignment under the lock), so no query ever
        #: sees backends from two maps. None + _pmap_incomplete=False is
        #: a full-replica fleet (the full-replica path, byte for byte);
        #: None + True means partition replicas exist but coverage is
        #: incomplete or generations are mixed — queries answer 503,
        #: never a partial merge.
        self._pmap: Optional[Dict[str, Any]] = None
        self._pmap_incomplete = False
        #: concurrent scatter legs (lazy: full-replica fleets never pay
        #: for the pool)
        self._scatter_pool: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._m_partition_requests = None
        self._m_partition_width = None
        #: embedded autopilot (pio router --autopilot): set via
        #: attach_autopilot; the status payload grows an "autopilot"
        #: block only while one is attached (wire parity)
        self._autopilot: Optional[Any] = None
        #: embedded autotrain (pio router --autotrain): set via
        #: attach_autotrain; the status payload grows an "autotrain"
        #: block the doctor reads
        self._autotrain: Optional[Any] = None
        #: front-door response cache (None unless --cache/PIO_ROUTER_CACHE
        #: turns it on: the off path stays byte-identical to the uncached router)
        self._cache: Optional[_ResponseCache] = None
        self._m_cache_hits = self._m_cache_misses = None
        self._m_cache_evictions = self._m_cache_ratio = None
        #: last fleet-agreed generation per tenant ('-' = the scalar
        #: single-engine generation) — the poller's cache-invalidation
        #: sweep journals and reclaims on each bump
        self._cache_gens: Dict[str, Any] = {}
        self.start_time = time.perf_counter()
        self.request_count = 0
        self.shed_count = 0
        self.failover_count = 0
        # uniform daemon observability surface (idempotent)
        from predictionio_tpu_torch.common import devicewatch, history, slo
        devicewatch.install()
        slo.install()
        # metrics flight recorder (one sampler thread per process)
        history.install()
        reg = telemetry.registry()
        self._m_requests = reg.counter(
            "pio_router_requests_total",
            "Routed /queries.json requests by outcome (ok / failover_ok "
            "/ shed / deadline / error) and tenant ('-' when the query "
            "carries no access key)", labelnames=("outcome", "tenant"))
        self._m_failovers = reg.counter(
            "pio_router_failovers_total",
            "Forwards retried on another replica after a transport "
            "failure or timeout on the first").child()
        self._m_overhead = reg.histogram(
            "pio_router_overhead_seconds",
            "Router-added latency per request: handler time minus the "
            "backend call itself (selection + header assembly + "
            "serialization)",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.05, float("inf"))).child()
        self._m_backend_seconds = reg.histogram(
            "pio_router_backend_seconds",
            "Backend call time per forwarded attempt, labeled by the "
            "backend that served it — the per-replica latency signal "
            "the autopilot's outlier quarantine reads (the aggregate "
            "pio_router_overhead_seconds cannot name a slow replica)",
            labelnames=("backend",),
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 1.0, float("inf")))
        self._m_backend_up = reg.gauge(
            "pio_router_backend_up",
            "1 while this backend is in rotation (healthy + admitted by "
            "the reload barrier), 0 while ejected",
            labelnames=("backend",))
        if self.config.cache_on:
            self._cache = _ResponseCache(
                max_bytes=self.config.cache_mb * 1024 * 1024,
                ttl_s=self.config.cache_ttl_ms / 1e3)
            self._m_cache_hits = reg.counter(
                "pio_router_cache_hits_total",
                "Front-door response-cache hits: queries answered from "
                "the (tenant, query bytes, model generation) LRU without "
                "touching a replica").child()
            self._m_cache_misses = reg.counter(
                "pio_router_cache_misses_total",
                "Front-door response-cache misses (forwarded to a "
                "replica; 200 answers are stored on the way back)"
            ).child()
            self._m_cache_evictions = reg.counter(
                "pio_router_cache_evictions_total",
                "Response-cache entries dropped: LRU past the byte "
                "budget, TTL expiry, or a generation-bump invalidation "
                "sweep").child()
            self._m_cache_ratio = reg.gauge(
                "pio_router_cache_hit_ratio",
                "hits / (hits + misses) over this router's lifetime — "
                "the zipfian hot-key absorption the cache exists for"
            ).child()
        # first sweep runs synchronously so a router that starts against
        # a live fleet is ready the moment its own /readyz answers
        self._poll_once(timeout=min(2.0, self.config.health_ms / 1e3 * 4))
        self._poller = threading.Thread(
            target=self._poll_loop, name="pio-router-health", daemon=True)
        self._poller.start()

    # ----------------------------------------------------------- membership
    def _poll_once(self, timeout: float = 2.0) -> None:
        for b in self.backends:
            healthy, draining, gen, tenant_gens, partition = b.probe(
                timeout=timeout)
            with self._lock:
                was = b.healthy
                b.healthy = healthy
                b.draining = draining
                if gen is not None:
                    b.generation = gen
                if tenant_gens is not None:
                    b.tenant_generations = tenant_gens
                if healthy:
                    # a partition range is only trusted from a live 200
                    # probe; an ejected replica keeps its last-known
                    # range for the status page but the map rebuild
                    # ignores it anyway (healthy+admitted only)
                    b.partition = partition
            if healthy and not was:
                journal.emit(
                    "router", f"backend {b.name} re-admitted "
                    f"(readiness probe recovered, generation {gen})",
                    level=journal.INFO, backend=b.name,
                    generation=gen)
            elif was and not healthy:
                # drop the idle keep-alive pool: sockets to an ejected
                # replica are stale at best
                b.close()
                journal.emit(
                    "router", f"backend {b.name} ejected from rotation "
                    + ("(draining)" if draining
                       else "(readiness probe failed)"),
                    level=(journal.WARN if draining else journal.RED),
                    backend=b.name, draining=draining)
            self._m_backend_up.labels(backend=b.name).set(
                1.0 if (healthy and b.admitted and not b.quarantined)
                else 0.0)
        self._rebuild_pmap()
        self._cache_sweep()

    def _poll_loop(self) -> None:
        interval = self.config.health_ms / 1e3
        while not self._stop_requested.is_set():
            if self._stop_requested.wait(interval):
                return
            try:
                self._poll_once(timeout=max(interval * 4, 0.5))
            except Exception:
                logger.exception("health poll sweep failed")

    def note_backend_failure(self, b: _Backend) -> None:
        """A forwarded request failed in transport: eject immediately
        instead of waiting out the poll interval (the poller re-admits
        on the next successful probe)."""
        with self._lock:
            was = b.healthy
            b.healthy = False
        if was:
            journal.emit(
                "router", f"backend {b.name} ejected from rotation "
                "(forwarded request failed in transport)",
                level=journal.RED, backend=b.name)
            self._m_backend_up.labels(backend=b.name).set(0.0)
            self._rebuild_pmap()

    # -------------------------------------------------- fleet control plane
    def add_backend(self, url: str) -> _Backend:
        """Admit a new replica into the configured set (the autopilot's
        scale-up / replacement path). The newcomer is probed
        synchronously so an already-ready replica enters rotation on
        this call, not a poll interval later."""
        b = _Backend(url)
        with self._lock:
            if any(x.name == b.name for x in self.backends):
                raise ValueError(
                    f"backend {b.name} is already configured")
            self.backends.append(b)
        healthy, draining, gen, tenant_gens, partition = b.probe()
        with self._lock:
            b.healthy = healthy
            b.draining = draining
            if gen is not None:
                b.generation = gen
            if tenant_gens is not None:
                b.tenant_generations = tenant_gens
            if healthy:
                b.partition = partition
        self._m_backend_up.labels(backend=b.name).set(
            1.0 if healthy else 0.0)
        journal.emit(
            "router", f"backend {b.name} added to the fleet "
            + ("(in rotation)" if healthy else "(awaiting readiness)"),
            level=journal.INFO, backend=b.name, healthy=healthy)
        self._rebuild_pmap()
        return b

    def remove_backend(self, name: str) -> bool:
        """Retire one backend by name. Membership removal is immediate
        — in-flight forwards finish on their already-open sockets — so
        a scale-down that stops the PROCESS a grace period later never
        drops a query. Returns False for an unknown name."""
        with self._lock:
            found = next((b for b in self.backends if b.name == name),
                         None)
            if found is None:
                return False
            if len(self.backends) == 1:
                raise ValueError("cannot remove the last backend")
            found.admitted = False
            self.backends.remove(found)
        found.close()
        self._m_backend_up.labels(backend=found.name).set(0.0)
        journal.emit(
            "router", f"backend {found.name} removed from the fleet",
            level=journal.INFO, backend=found.name)
        self._rebuild_pmap()
        return True

    def set_quarantine(self, name: str, value: bool) -> bool:
        """Hold one backend out of rotation (or release it) without
        touching its health state — the autopilot's latency-outlier
        ejection. Returns False for an unknown name."""
        with self._lock:
            found = next((b for b in self.backends if b.name == name),
                         None)
            if found is None:
                return False
            changed = found.quarantined != value
            found.quarantined = value
        if changed:
            self._m_backend_up.labels(backend=found.name).set(
                1.0 if (found.healthy and found.admitted and not value)
                else 0.0)
            journal.emit(
                "router", f"backend {found.name} "
                + ("quarantined (held out of rotation)" if value
                   else "released from quarantine"),
                level=journal.WARN if value else journal.INFO,
                backend=found.name, quarantined=value)
            self._rebuild_pmap()
        return True

    def set_shed_thresholds(self, max_inflight: Optional[int] = None,
                            tenant_max_inflight: Optional[int] = None
                            ) -> Dict[str, int]:
        """Read (no args) or adjust the shed thresholds at runtime;
        returns the PREVIOUS values so the autopilot's degradation
        ladder can restore them exactly on recovery."""
        with self._lock:
            prev = {"maxInflight": self._max_inflight,
                    "tenantMaxInflight": self._tenant_cap}
            if max_inflight is not None:
                self._max_inflight = max(1, int(max_inflight))
            if tenant_max_inflight is not None:
                self._tenant_cap = max(0, int(tenant_max_inflight))
            cur = {"maxInflight": self._max_inflight,
                   "tenantMaxInflight": self._tenant_cap}
        if cur != prev:
            journal.emit(
                "router",
                f"shed thresholds changed: maxInflight "
                f"{prev['maxInflight']} -> {cur['maxInflight']}, "
                f"tenantMaxInflight {prev['tenantMaxInflight']} -> "
                f"{cur['tenantMaxInflight']}",
                level=journal.INFO, **cur)
        return prev

    def attach_autopilot(self, ap: Any) -> None:
        self._autopilot = ap

    def attach_autotrain(self, autotrain: Any) -> None:
        self._autotrain = autotrain

    # ------------------------------------------------------ partition map
    def _rebuild_pmap(self) -> None:
        """Recompute the partition map from current membership and swap
        it in atomically.

        A candidate map is one (count, generation) group of in-rotation
        partition replicas; it is SERVABLE only when indices 0..count-1
        are all covered AND every member reports the same scalar
        generation — the two halves of the "mixed maps never co-serve
        one query" contract (a re-partition or hot-swap becomes visible
        only once its whole new map is up). Among servable candidates
        the highest generation wins (the re-partition cutover). Queries
        racing this rebuild hold a reference to the OLD snapshot — maps
        are immutable once published."""
        with self._lock:
            part = [b for b in self.backends
                    if b.healthy and b.admitted and not b.quarantined
                    and b.partition]
            old = self._pmap
            if not part:
                had_parts = any(b.partition for b in self.backends)
                self._pmap = None
                # partition replicas configured but none in rotation is
                # a coverage gap, not a silent fall-back to full-model
                # round-robin (there may be no full replica to fall to)
                self._pmap_incomplete = had_parts
            else:
                groups: Dict[Tuple[int, Any], Dict[int, List[_Backend]]] = {}
                for b in part:
                    gkey = (b.partition["count"], b.generation)
                    groups.setdefault(gkey, {}).setdefault(
                        b.partition["index"], []).append(b)
                best = None
                for (count, gen), owners in groups.items():
                    if set(owners) != set(range(count)):
                        continue
                    if best is None or (gen or 0) > (best[1] or 0):
                        best = (count, gen, owners)
                if best is None:
                    self._pmap = None
                    self._pmap_incomplete = True
                else:
                    count, gen, owners = best
                    self._pmap = {
                        "count": count,
                        "generation": gen,
                        "nItems": next(iter(owners.values()))[0]
                        .partition["nItems"],
                        "owners": {i: list(bs) for i, bs in owners.items()},
                    }
                    self._pmap_incomplete = False
            new = self._pmap
            incomplete = self._pmap_incomplete
        if (new is None) != (old is None) or (
                new is not None and old is not None
                and (new["count"] != old["count"]
                     or new["generation"] != old["generation"])):
            if new is not None:
                self._partition_width_gauge().set(float(new["count"]))
                journal.emit(
                    "router",
                    f"partition map live: {new['count']} partition(s) "
                    f"over {sum(len(v) for v in new['owners'].values())} "
                    f"replica(s), generation {new['generation']}",
                    level=journal.INFO, partitions=new["count"],
                    generation=new["generation"])
            else:
                journal.emit(
                    "router",
                    "partition map LOST: coverage incomplete or "
                    "generations mixed — partition queries answer 503 "
                    "until a full map is back in rotation",
                    level=journal.RED if incomplete else journal.INFO)

    def _partition_metrics(self):
        if self._m_partition_requests is None:
            self._m_partition_requests = telemetry.registry().counter(
                "pio_router_partition_requests_total",
                "Partition-scattered /queries.json requests by outcome "
                "(merged / coverage_gap / error / deadline)",
                labelnames=("outcome",))
        return self._m_partition_requests

    def _partition_width_gauge(self):
        if self._m_partition_width is None:
            self._m_partition_width = telemetry.registry().gauge(
                "pio_router_partition_width",
                "Scatter width of the live partition map (how many "
                "owning partitions one query fans out to); 0 = no map"
            ).child()
        return self._m_partition_width

    # -------------------------------------------------------- cache plumbing
    def _generation_token(self, tenant: str) -> Optional[Any]:
        """The fleet-agreed model generation for ``tenant`` — the cache
        key's invalidation component. Multi-tenant backends vote with
        their per-tenant ``generations`` dict entry (a tenant's
        /reload must invalidate only ITS entries), legacy
        backends with the scalar. No vote or a split vote (mid-barrier
        skew) returns None — the cache stands aside rather than serve
        either generation's answer for the other."""
        votes = set()
        with self._lock:
            for b in self.backends:
                if not (b.healthy and b.admitted and not b.quarantined):
                    continue
                if b.tenant_generations is not None:
                    g = b.tenant_generations.get(tenant)
                    if g is not None:
                        votes.add(("t", g))
                elif b.generation is not None:
                    votes.add(("s", b.generation))
        if len(votes) != 1:
            return None
        return next(iter(votes))

    def _cache_sweep(self) -> None:
        """Reclaim cache entries whose tenant's fleet generation moved
        (they are unreachable already — generation is IN the key; this
        frees their bytes now and journals the invalidation)."""
        cache = self._cache
        if cache is None:
            return
        tenants: set = {"-"}
        with self._lock:
            for b in self.backends:
                tenants.update((b.tenant_generations or {}).keys())
        for t in sorted(tenants):
            token = self._generation_token(t)
            if token is None:
                continue
            last = self._cache_gens.get(t)
            self._cache_gens[t] = token
            if last is not None and last != token:
                dropped = cache.invalidate_tenant(t)
                self._cache_metrics_update()
                journal.emit(
                    "router",
                    f"response cache invalidated for tenant '{t}': "
                    f"generation {last[1]} -> {token[1]} "
                    f"({dropped} entries dropped)",
                    level=journal.INFO, tenant=t, dropped=dropped)

    def _cache_metrics_update(self) -> None:
        """Sync the prom counters to the cache's own op counts (one
        place, so TTL expiries inside get() and LRU evictions inside
        put() are never under-reported)."""
        cache = self._cache
        if cache is None or self._m_cache_hits is None:
            return
        stats = cache.stats()
        for metric, k in ((self._m_cache_hits, "hits"),
                          (self._m_cache_misses, "misses"),
                          (self._m_cache_evictions, "evictions")):
            delta = stats[k] - metric.value
            if delta > 0:
                metric.inc(delta)
        self._m_cache_ratio.set(stats["hitRatio"])

    def _eligible(self) -> List[_Backend]:
        with self._lock:
            return [b for b in self.backends
                    if b.healthy and b.admitted and not b.quarantined]

    def _pick(self, exclude: Optional[set] = None) -> Optional[_Backend]:
        """Round-robin over the rotation, skipping excluded backends and
        open breakers."""
        eligible = [b for b in self._eligible()
                    if not exclude or b.name not in exclude]
        if not eligible:
            return None
        start = next(self._rr)
        for k in range(len(eligible)):
            b = eligible[(start + k) % len(eligible)]
            try:
                b.breaker.allow()
            except resilience.CircuitOpenError:
                continue
            return b
        return None

    # ------------------------------------------------------------ dispatch
    def handle(self, method: str, path: str,
               query: Optional[Dict[str, str]] = None,
               body: bytes = b"",
               headers: Optional[Dict[str, str]] = None) -> Response:
        method = method.upper()
        path = (path or "/").rstrip("/") or "/"
        try:
            if path == "/" and method == "GET":
                return 200, self._status()
            if path == "/healthz" and method == "GET":
                return 200, {"status": "ok"}
            if path == "/readyz" and method == "GET":
                return self._readyz()
            t = telemetry.handle_route(
                method, path, query,
                accept=(headers or {}).get("accept")
                or (headers or {}).get("Accept"))
            if t is not None:
                return t
            if path == "/queries.json" and method == "POST":
                return self._queries(body, headers or {}, query or {})
            if path == "/reload" and method == "POST":
                return self._start_reload(query or {})
            if path == "/backends" and method == "POST":
                return self._backends_route(query or {})
            if path == "/quarantine" and method == "POST":
                return self._quarantine_route(query or {})
            if path == "/shed" and method == "POST":
                return self._shed_route(query or {})
            if path == "/stop" and method == "POST":
                self._stop_requested.set()
                return 200, {"message": "Shutting down."}
            return 404, {"message": "Not Found"}
        except Exception as e:
            logger.exception("router request failed: %s %s", method, path)
            return 500, {"message": str(e)}

    def _status(self) -> Dict[str, Any]:
        with self._lock:
            backends = [b.state() for b in self.backends]
        gens = {b["generation"] for b in backends
                if b["generation"] is not None}
        out = {
            "status": "alive",
            "router": True,
            "backends": backends,
            "inRotation": sum(1 for b in backends if b["inRotation"]),
            "generations": sorted(gens),
            "generationSkew": len(gens) > 1,
            "requestCount": self.request_count,
            "shedCount": self.shed_count,
            "failoverCount": self.failover_count,
            "reload": dict(self._reload_state),
            "draining": self._draining.is_set(),
        }
        # per-tenant skew over multi-tenant backends only: a legacy
        # fleet's payload keeps the legacy key set (wire parity).
        # tenantGenerations maps tenant -> sorted distinct generations
        # seen across the fleet; a list longer than 1 is skew for THAT
        # tenant (the doctor WARN names it).
        tenant_gens: Dict[str, set] = {}
        for b in backends:
            for name, g in (b.get("generations") or {}).items():
                tenant_gens.setdefault(name, set()).add(g)
        if tenant_gens:
            out["tenantGenerations"] = {
                n: sorted(v) for n, v in sorted(tenant_gens.items())}
            out["tenantGenerationSkew"] = sorted(
                n for n, v in tenant_gens.items() if len(v) > 1)
            # under multi-tenancy the scalar generation
            # legitimately differs per replica (it counts that PROCESS'S
            # loads) — fleet skew is a per-tenant question, so the
            # headline bool must follow the per-tenant verdict, not the
            # scalar set
            out["generationSkew"] = bool(out["tenantGenerationSkew"])
        with self._lock:
            pmap, incomplete = self._pmap, self._pmap_incomplete
        if pmap is not None or incomplete or any(
                b.get("partition") for b in backends):
            # partition-routed fleets only (full fleets keep the legacy
            # key set, wire parity asserted by test): the live
            # map's owned ranges — what `pio doctor` summarizes and
            # flags coverage gaps RED on
            owners: Dict[str, List[Dict[str, Any]]] = {}
            for b in backends:
                p = b.get("partition")
                if p and b["inRotation"]:
                    owners.setdefault(str(p["index"]), []).append({
                        "backend": b["url"], "lo": p["lo"], "hi": p["hi"]})
            out["partitions"] = {
                "complete": pmap is not None,
                "count": (pmap or {}).get("count"),
                "generation": (pmap or {}).get("generation"),
                "nItems": (pmap or {}).get("nItems"),
                "owners": {k: owners[k] for k in sorted(owners, key=int)},
            }
        cache = self._cache
        if cache is not None:
            # cache-enabled routers only (same parity rule): the stats
            # the doctor's hit-ratio WARN reads
            out["cache"] = {"enabled": True, **cache.stats()}
        if self._autopilot is not None:
            # embedded-autopilot routers only (same parity rule): the
            # block `pio doctor`'s autopilot line reads
            out["autopilot"] = self._autopilot.summary()
        if self._autotrain is not None:
            # embedded-autotrain routers only (same parity rule): the
            # block `pio doctor`'s autotrain line reads
            out["autotrain"] = self._autotrain.summary()
        return out

    # ------------------------------------------------------- admin routes
    def _backends_route(self, query: Dict[str, str]) -> Response:
        add, remove = query.get("add"), query.get("remove")
        if bool(add) == bool(remove):
            return 400, {"message": ("POST /backends needs exactly one "
                                     "of ?add=url or ?remove=name")}
        try:
            if add:
                b = self.add_backend(add)
                return 200, {"message": f"backend {b.name} added.",
                             "backend": b.state()}
            if not self.remove_backend(remove or ""):
                return 404, {"message": f"unknown backend {remove}"}
            return 200, {"message": f"backend {remove} removed."}
        except ValueError as e:
            return 400, {"message": str(e)}

    def _quarantine_route(self, query: Dict[str, str]) -> Response:
        name = query.get("backend", "")
        if not name:
            return 400, {"message":
                         "POST /quarantine needs ?backend=name"}
        clear = (query.get("clear") or "") in ("1", "true", "yes")
        if not self.set_quarantine(name, not clear):
            return 404, {"message": f"unknown backend {name}"}
        return 200, {"message": f"backend {name} "
                     + ("released from quarantine."
                        if clear else "quarantined.")}

    def _shed_route(self, query: Dict[str, str]) -> Response:
        try:
            mi = query.get("maxInflight")
            ti = query.get("tenantMaxInflight")
            prev = self.set_shed_thresholds(
                max_inflight=int(mi) if mi is not None else None,
                tenant_max_inflight=int(ti) if ti is not None else None)
        except ValueError:
            return 400, {"message": ("maxInflight/tenantMaxInflight "
                                     "must be integers")}
        with self._lock:
            cur = {"maxInflight": self._max_inflight,
                   "tenantMaxInflight": self._tenant_cap}
        return 200, {"previous": prev, "current": cur}

    def _readyz(self) -> Response:
        """Ready while at least one backend is in rotation — the router's
        own upstream (an external LB or DNS) steers elsewhere when the
        whole fleet is dark or this router drains."""
        if self._draining.is_set():
            return 503, {"status": "draining"}
        eligible = self._eligible()
        payload = {
            "status": "ready" if eligible else "unready",
            "backendsInRotation": len(eligible),
            "backendsTotal": len(self.backends),
        }
        return (200 if eligible else 503), payload

    # ----------------------------------------------------------- query path
    def _budget_s(self, headers: Dict[str, str]) -> float:
        """The request's deadline budget in seconds: the router default,
        or a smaller client-propagated X-PIO-Deadline-Ms."""
        budget = self.config.deadline_ms / 1e3
        raw = None
        for k, v in headers.items():
            if k.lower() == "x-pio-deadline-ms":
                raw = v
                break
        if raw is not None:
            try:
                client_ms = float(raw)
                if 0 <= client_ms / 1e3 < budget:
                    budget = client_ms / 1e3
            except ValueError:
                pass
        return budget

    def _tenant_label(self, key: Optional[str]) -> str:
        """The metric/shed label for a query's tenant: the learned name
        when a backend has answered for this key, the key itself before
        that, '-' for a key-less (legacy) query."""
        if not key:
            return "-"
        with self._lock:
            return self._tenant_by_key.get(key, key)

    def _queries(self, body: bytes, headers: Dict[str, str],
                 query: Optional[Dict[str, str]] = None) -> Response:
        t_start = time.perf_counter()
        if self._draining.is_set():
            return 503, {"message": "router is draining"}, \
                {"Retry-After": "1"}
        key = (query or {}).get("accessKey")
        tenant = self._tenant_label(key)
        cache = self._cache
        token = None
        if cache is not None:
            # front-door lookup BEFORE any admission charge: a hit
            # touches no replica and must not consume inflight permits.
            # token None = the fleet has no agreed generation for this
            # tenant (empty rotation or mid-barrier skew) — stand aside
            # rather than answer across a generation boundary.
            token = self._generation_token(tenant)
            if token is not None:
                hit = cache.get((tenant, token, bytes(body)))
                self._cache_metrics_update()
                if hit is not None:
                    with self._lock:
                        self.request_count += 1
                    if telemetry.on():
                        self._m_requests.labels(outcome="ok",
                                                tenant=tenant).inc()
                        self._m_overhead.observe(
                            max(time.perf_counter() - t_start, 0.0))
                    return hit
        with self._lock:
            cap = self._tenant_cap
        charged = False
        if key and cap > 0:
            # per-tenant shedding at the front door: one tenant's flood
            # sheds ITS queries before it can fill the shared pool
            with self._lock:
                count = self._tenant_inflight.get(tenant, 0)
                if count >= cap:
                    over = True
                else:
                    self._tenant_inflight[tenant] = count + 1
                    over = False
            if over:
                self._shed("tenant-inflight", tenant=tenant)
                return 503, {"message": (
                    f"tenant '{tenant}' is saturated at the router "
                    "(per-tenant admission control); retry later")}, \
                    {"Retry-After": "1"}
            charged = True
        try:
            with self._lock:
                if self._inflight_count >= self._max_inflight:
                    admitted = False
                else:
                    self._inflight_count += 1
                    admitted = True
            if not admitted:
                # admission control: the fleet is saturated end to end;
                # queueing here would only grow latency without bound
                self._shed("inflight", tenant=tenant)
                return 503, {"message": (
                    "router is saturated (admission control); "
                    "retry later")}, \
                    {"Retry-After": "1"}
            try:
                with self._lock:
                    pmap, pincomplete = self._pmap, self._pmap_incomplete
                if pmap is not None or pincomplete:
                    resp = self._scatter(pmap, body, headers, t_start)
                else:
                    resp = self._forward(body, headers, t_start, key=key)
                if cache is not None and resp[0] == 200:
                    # store under the POST-forward tenant label (the
                    # forward may have just learned key→name) and a
                    # freshly-agreed generation token
                    label = self._tenant_label(key)
                    store_token = self._generation_token(label)
                    if store_token is not None:
                        cache.put((label, store_token, bytes(body)),
                                  resp[0], resp[1],
                                  resp[2] if len(resp) > 2 else None)
                        self._cache_metrics_update()
                return resp
            finally:
                with self._lock:
                    self._inflight_count -= 1
        finally:
            if charged:
                with self._lock:
                    n = self._tenant_inflight.get(tenant, 1) - 1
                    if n <= 0:
                        self._tenant_inflight.pop(tenant, None)
                    else:
                        self._tenant_inflight[tenant] = n

    def _shed(self, reason: str, tenant: str = "-") -> None:
        with self._lock:
            self.shed_count += 1
        if telemetry.on():
            self._m_requests.labels(outcome="shed", tenant=tenant).inc()
        logger.warning("router shed a query (%s)", reason)

    def _forward(self, body: bytes, headers: Dict[str, str],
                 t_start: float, key: Optional[str] = None) -> Response:
        deadline = t_start + self._budget_s(headers)
        # tenant-aware routing: the query's access key rides the
        # forwarded URL so the backend's admission control resolves the
        # SAME key the client presented (key-less legacy queries keep
        # the bare path, byte for byte)
        fwd_path = "/queries.json"
        if key:
            fwd_path += "?" + urllib.parse.urlencode({"accessKey": key})
        tenant = self._tenant_label(key)
        fwd_headers = {"Content-Type": "application/json"}
        ctx = tracing.current()
        if ctx is not None:
            # the transport adopted (or originated) this request's trace;
            # propagating it is what lets `pio trace` assemble the
            # router->replica tree
            fwd_headers[tracing.TRACE_HEADER] = ctx.header_value()
        attempt = 0
        backend_s = 0.0
        exclude: set = set()
        failed_over = False
        while True:
            b = self._pick(exclude)
            if b is None:
                self._shed("no backend in rotation", tenant=tenant)
                return 503, {"message": (
                    "no healthy backend in rotation; retry later")}, \
                    {"Retry-After": "1"}
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if telemetry.on():
                    self._m_requests.labels(outcome="deadline",
                                            tenant=tenant).inc()
                return 504, {"message": "deadline exceeded"}
            # while a failover retry is still possible, reserve half the
            # remaining budget for it: a replica slower than half the
            # budget TIMES OUT here (a breaker-visible failure — this is
            # how injected latency on one replica shifts traffic) and
            # the retry still has room to succeed elsewhere. The last
            # attempt gets everything that is left.
            attempt_timeout = (
                remaining / 2
                if self._retry.may_retry(attempt, deadline,
                                         clock=time.perf_counter)
                and len(self._eligible()) > 1
                else remaining)
            hdrs = {**fwd_headers,
                    "X-PIO-Deadline-Ms": str(int(attempt_timeout * 1e3))}
            t0 = time.perf_counter()
            try:
                if ctx is not None:
                    with tracing.span("route", service=b.name):
                        status, payload, rheaders = b.request(
                            "POST", fwd_path, body, hdrs,
                            timeout=attempt_timeout)
                else:
                    status, payload, rheaders = b.request(
                        "POST", fwd_path, body, hdrs,
                        timeout=attempt_timeout)
            except _TRANSPORT_ERRORS as e:
                backend_s += time.perf_counter() - t0
                b.breaker.record(False)
                self.note_backend_failure(b)
                exclude.add(b.name)
                # /queries.json is a pure read: ONE failover retry on
                # another replica is safe; a second failure surfaces
                if self._retry.may_retry(attempt, deadline,
                                         clock=time.perf_counter):
                    attempt += 1
                    failed_over = True
                    with self._lock:
                        self.failover_count += 1
                    if telemetry.on():
                        self._m_failovers.inc()
                    continue
                if telemetry.on():
                    self._m_requests.labels(outcome="error",
                                            tenant=tenant).inc()
                return 502, {"message": (
                    f"backend {b.name} failed ({type(e).__name__}) and "
                    "the failover budget is spent")}
            dt = time.perf_counter() - t0
            backend_s += dt
            b.breaker.record(status < 500)
            if telemetry.on():
                # the per-replica latency signal the autopilot's outlier
                # quarantine compares across the fleet
                self._m_backend_seconds.labels(
                    backend=b.name).observe(dt)
            if status in (502, 503, 504) and self._retry.may_retry(
                    attempt, deadline, clock=time.perf_counter):
                # a draining/saturated replica said "not me" — that is
                # exactly the failover case; its Retry-After floor only
                # matters if the retry fails too
                attempt += 1
                failed_over = True
                exclude.add(b.name)
                with self._lock:
                    self.failover_count += 1
                if telemetry.on():
                    self._m_failovers.inc()
                continue
            return self._respond(status, payload, rheaders, failed_over,
                                 t_start, backend_s, key=key)

# --------------------------------------------------------- scatter/merge
    def _ensure_scatter_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._lock:
            if self._scatter_pool is None:
                self._scatter_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="pio-router-scatter")
            return self._scatter_pool

    def _scatter(self, pmap: Optional[Dict[str, Any]], body: bytes,
                 headers: Dict[str, str], t_start: float) -> Response:
        """Partition-routed dispatch: fan one query out to every owning
        partition concurrently under the shared deadline budget, then
        merge the per-partition top-k with serve_dist.merge_candidates —
        the host twin of the device all-gather merge, so the answer is
        bit-identical (values, indices, tie order) to one full-model
        replica's. An incomplete map NEVER partial-merges: missing
        coverage answers 503 outright."""
        metrics = self._partition_metrics()
        if pmap is None:
            self._shed("partition coverage gap")
            if telemetry.on():
                metrics.labels(outcome="coverage_gap").inc()
            return 503, {"message": (
                "partition coverage is incomplete (no servable map); "
                "retry later")}, {"Retry-After": "1"}
        deadline = t_start + self._budget_s(headers)
        self._partition_width_gauge().set(float(pmap["count"]))
        fwd_headers = {"Content-Type": "application/json"}
        ctx = tracing.current()
        if ctx is not None:
            fwd_headers[tracing.TRACE_HEADER] = ctx.header_value()

        def leg(replicas: List[_Backend]) -> Tuple[str, Any, Any]:
            """One partition's sub-request with intra-partition
            failover: walk that partition's replicas (rr-rotated,
            breaker-gated) until one answers; transport failures eject
            (note_backend_failure → the map rebuilds without them)."""
            start = next(self._rr)
            last_err = "all replicas breaker-open"
            for j in range(len(replicas)):
                b = replicas[(start + j) % len(replicas)]
                try:
                    b.breaker.allow()
                except resilience.CircuitOpenError:
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return "deadline", None, None
                hdrs = {**fwd_headers,
                        "X-PIO-Deadline-Ms": str(int(remaining * 1e3))}
                t0 = time.perf_counter()
                try:
                    with tracing.activate(ctx):
                        if ctx is not None:
                            with tracing.span("scatter", service=b.name):
                                status, payload, _rh = b.request(
                                    "POST", "/queries.json", body, hdrs,
                                    timeout=remaining)
                        else:
                            status, payload, _rh = b.request(
                                "POST", "/queries.json", body, hdrs,
                                timeout=remaining)
                except _TRANSPORT_ERRORS as e:
                    b.breaker.record(False)
                    self.note_backend_failure(b)
                    last_err = f"{b.name}: {type(e).__name__}"
                    continue
                b.breaker.record(status < 500)
                if telemetry.on():
                    self._m_backend_seconds.labels(
                        backend=b.name).observe(
                            time.perf_counter() - t0)
                if status in (502, 503, 504):
                    # per-partition failover: a draining/saturated
                    # replica said "not me" — try its partition peers
                    last_err = f"{b.name}: HTTP {status}"
                    continue
                return "ok", status, payload
            return "exhausted", last_err, None

        pool = self._ensure_scatter_pool()
        owners = [pmap["owners"][i] for i in range(pmap["count"])]
        t_fan = time.perf_counter()
        futures = [pool.submit(leg, replicas) for replicas in owners]
        results = []
        try:
            for f in futures:
                results.append(f.result(
                    timeout=max(deadline - time.perf_counter(), 0.001)))
        except concurrent.futures.TimeoutError:
            for f in futures:
                f.cancel()
            if telemetry.on():
                metrics.labels(outcome="deadline").inc()
                self._m_requests.labels(outcome="deadline",
                                        tenant="-").inc()
            return 504, {"message": "deadline exceeded"}
        backend_s = time.perf_counter() - t_fan

        def finish(outcome: str, resp: Response) -> Response:
            with self._lock:
                self.request_count += 1
            if telemetry.on():
                metrics.labels(outcome=outcome).inc()
                self._m_requests.labels(
                    outcome=("ok" if outcome == "merged"
                             else "deadline" if outcome == "deadline"
                             else "error"), tenant="-").inc()
                self._m_overhead.observe(
                    max(time.perf_counter() - t_start - backend_s, 0.0))
            return resp

        for verdict, a, payload in results:
            if verdict == "deadline":
                return finish("deadline",
                              (504, {"message": "deadline exceeded"}))
            if verdict == "exhausted":
                # a whole partition went dark mid-flight — that is a
                # coverage gap, and a gap never partial-merges
                self._shed(f"partition leg failed ({a})")
                return finish("coverage_gap", (
                    503, {"message": (
                        f"a partition became unavailable ({a}); "
                        "retry later")}, {"Retry-After": "1"}))
        parts = []
        for verdict, status, payload in results:
            try:
                obj = json.loads(payload) if payload else {}
            except ValueError:
                return finish("error", (502, {
                    "message": "backend returned a non-JSON reply"}))
            if status != 200:
                # every partition ran the same parse/validation on the
                # same body — propagate the first non-200 verbatim
                # (e.g. a 400 malformed query), exactly what one full
                # replica would have answered
                return finish("error" if status >= 500 else "merged",
                              (status, obj))
            parts.append(obj)
        return finish("merged", self._merge(pmap, body, parts))

    def _merge(self, pmap: Dict[str, Any], body: bytes,
               parts: List[Dict[str, Any]]) -> Response:
        """Reassemble the client-facing answer from per-partition 200s.

        Each sub-response carries its candidates' GLOBAL item indices
        (the replica's partition block); the two-key (value, lowest
        global index) sort over the concatenated candidates is the same
        rule the device all-gather merge applies, and the merged entry
        dicts are the replicas' own parsed entries — Python's exact
        float round-trip makes the re-serialized bytes identical to a
        full replica's."""
        from predictionio_tpu_torch.parallel.serve_dist import merge_candidates
        entries: List[Dict[str, Any]] = []
        values: List[float] = []
        gids: List[int] = []
        degraded = False
        n_items = None
        for obj in parts:
            block = obj.get("partition") if isinstance(obj, dict) else None
            scores = (obj or {}).get("itemScores")
            if (not isinstance(block, dict)
                    or not isinstance(scores, list)
                    or block.get("count") != pmap["count"]
                    or len(block.get("itemIndices") or []) != len(scores)):
                return 502, {"message": (
                    "a partition replica answered without a consistent "
                    "partition block (map raced a re-partition?); "
                    "retry later")}, {"Retry-After": "1"}
            if n_items is None:
                n_items = int(block["nItems"])
            elif n_items != int(block["nItems"]):
                return 502, {"message": (
                    "partition replicas disagree on the catalog size; "
                    "retry later")}, {"Retry-After": "1"}
            degraded = degraded or bool(obj.get("degraded"))
            for entry, gid in zip(scores, block["itemIndices"]):
                entries.append(entry)
                values.append(float(entry.get("score", 0.0)))
                gids.append(int(gid))
        try:
            num = int(json.loads(body).get("num", 0))
        except (ValueError, TypeError, AttributeError):
            num = 0
        k = max(0, min(num, int(n_items or 0)))
        if entries:
            _v, _g, order = merge_candidates(values, gids, k)
            merged = [entries[int(j)] for j in order]
        else:
            merged = []
        out: Dict[str, Any] = {"itemScores": merged}
        if degraded:
            out["degraded"] = True
        return 200, out

    def _respond(self, status: int, payload: bytes,
                 rheaders: Dict[str, str], failed_over: bool,
                 t_start: float, backend_s: float,
                 key: Optional[str] = None) -> Response:
        # learn key→tenant from the backend's resolution (X-PIO-Tenant
        # rides every successful multi-tenant answer) so per-tenant
        # labels and the inflight cap use real names from here on
        learned = rheaders.get("x-pio-tenant")
        if key and learned:
            with self._lock:
                self._tenant_by_key[key] = learned
        tenant = learned or self._tenant_label(key)
        try:
            obj = json.loads(payload) if payload else {}
        except ValueError:
            if telemetry.on():
                self._m_requests.labels(outcome="error",
                                        tenant=tenant).inc()
            return 502, {"message": "backend returned a non-JSON reply"}
        extra: Dict[str, str] = {}
        if rheaders.get("retry-after"):
            extra["Retry-After"] = rheaders["retry-after"]
        with self._lock:
            self.request_count += 1
        if telemetry.on():
            outcome = ("error" if status >= 500
                       else "failover_ok" if failed_over else "ok")
            self._m_requests.labels(outcome=outcome, tenant=tenant).inc()
            # added latency = our handler time minus the backend call —
            # both clocks end host-side in this pure-Python path
            self._m_overhead.observe(
                max(time.perf_counter() - t_start - backend_s, 0.0))
        if extra:
            return status, obj, extra
        return status, obj

    # --------------------------------------------------- hot-swap barrier
    def _start_reload(self, query: Dict[str, str]) -> Response:
        """Kick (or join, with ?wait=1) the coordinated reload barrier.
        One barrier at a time: a second POST while one runs answers 409
        (two interleaved barriers could split the fleet's generations)."""
        if not self._reload_lock.acquire(blocking=False):
            return 409, {"message": "a reload barrier is already running"}
        wait = (query.get("wait") or "") in ("1", "true", "yes")
        done = threading.Event()

        def run():
            try:
                self._reload_barrier()
            finally:
                self._reload_lock.release()
                done.set()

        threading.Thread(target=run, name="pio-router-reload",
                         daemon=True).start()
        if wait:
            done.wait(300.0)
            return 200, {"message": "Reload barrier finished.",
                         "reload": dict(self._reload_state)}
        return 200, {"message": "Reload barrier started."}

    def _await_flip(self, b: _Backend, old_gen: Optional[int],
                    timeout_s: float = 120.0) -> bool:
        """Poll one backend until its generation moves past ``old_gen``
        AND it is ready again."""
        deadline = time.perf_counter() + timeout_s
        old_tenant_gens = dict(b.tenant_generations or {})
        while time.perf_counter() < deadline:
            healthy, _draining, gen, tenant_gens, partition = b.probe()
            with self._lock:
                if gen is not None:
                    b.generation = gen
                if tenant_gens is not None:
                    b.tenant_generations = tenant_gens
                if healthy:
                    b.partition = partition
                b.healthy = healthy
            if healthy and gen is not None and (
                    old_gen is None or gen > old_gen):
                # a multi-tenant replica's /reload hot-swaps every
                # tenant; verify each advanced and journal the ones
                # that did not (the per-tenant skew the doctor WARNs on)
                if tenant_gens and old_tenant_gens:
                    stale = sorted(
                        n for n, g in old_tenant_gens.items()
                        if tenant_gens.get(n, g + 1) <= g)
                    if stale:
                        journal.emit(
                            "router",
                            f"backend {b.name} flipped but tenant(s) "
                            f"{stale} kept their old generation",
                            level=journal.WARN, backend=b.name,
                            tenants=stale)
                return True
            time.sleep(min(self.config.health_ms / 1e3, 0.2))
        return False

    def _set_admitted(self, backends: List[_Backend], value: bool) -> None:
        with self._lock:
            for b in backends:
                b.admitted = value
        for b in backends:
            self._m_backend_up.labels(backend=b.name).set(
                1.0 if (b.healthy and value and not b.quarantined)
                else 0.0)
        # admission changes re-shape the partition map (the barrier's
        # coordinated re-partition rides the same atomic map swap)
        self._rebuild_pmap()

    def _reload_barrier(self) -> None:
        """The coordinated hot-swap: reload replicas one at a time while
        queries route only to old-generation replicas, then cut over
        atomically. On a failed replica reload the barrier ABORTS and
        re-admits everything — the fleet then has mixed generations
        until the operator re-runs /reload (journaled RED; doctor WARNs
        on the skew)."""
        t0 = time.perf_counter()
        old = self._eligible()
        self._reload_state = {"active": True, "flipped": 0,
                              "total": len(old)}
        journal.emit(
            "router", f"reload barrier begin over {len(old)} backend(s)",
            level=journal.INFO, backends=[b.name for b in old])
        if not old:
            self._reload_state = {"active": False, "error":
                                  "no backend in rotation"}
            journal.emit("router", "reload barrier aborted: no backend "
                         "in rotation", level=journal.WARN)
            return

        def reload_one(b: _Backend) -> bool:
            old_gen = b.generation
            try:
                status, _p, _h = b.request("POST", "/reload", b"", {},
                                           timeout=10.0)
            except _TRANSPORT_ERRORS as e:
                journal.emit(
                    "router", f"reload of {b.name} failed in transport: "
                    f"{type(e).__name__}", level=journal.RED,
                    backend=b.name)
                return False
            if status != 200:
                journal.emit(
                    "router", f"reload of {b.name} answered {status}",
                    level=journal.RED, backend=b.name, status=status)
                return False
            return self._await_flip(b, old_gen)

        if len(old) == 1:
            # a single replica's in-process hot-swap is already atomic
            # and zero-downtime; pulling it from rotation would be the
            # only way to DROP queries here
            ok = reload_one(old[0])
            self._reload_state = {"active": False, "flipped": int(ok),
                                  "total": 1, "ok": ok}
            journal.emit(
                "router",
                "reload barrier complete (single backend, in-place "
                "hot-swap)" if ok else
                "reload barrier FAILED on the single backend",
                level=journal.INFO if ok else journal.RED,
                durationS=round(time.perf_counter() - t0, 3))
            return

        flipped: List[_Backend] = []
        for b in old[:-1]:
            # hold this replica out; traffic stays on old-generation
            # replicas (flipped ones wait un-admitted for the cutover)
            self._set_admitted([b], False)
            if not reload_one(b):
                # abort: re-admit everything (mixed generations beat a
                # shrinking fleet — the skew is visible and re-runnable)
                self._set_admitted(flipped + [b], True)
                self._reload_state = {"active": False,
                                      "flipped": len(flipped),
                                      "total": len(old), "ok": False,
                                      "error": f"reload of {b.name} failed"}
                journal.emit(
                    "router", "reload barrier ABORTED: fleet has mixed "
                    "generations until /reload is re-run",
                    level=journal.RED, failed=b.name)
                return
            flipped.append(b)
            self._reload_state["flipped"] = len(flipped)
        last = old[-1]
        # THE cutover: one lock-held flip admits every new-generation
        # replica and retires the lone old one — queries admitted before
        # this line answered from the old generation, after it from the
        # new; no interleaving
        with self._lock:
            for b in flipped:
                b.admitted = True
            last.admitted = False
        for b in flipped + [last]:
            self._m_backend_up.labels(backend=b.name).set(
                1.0 if (b.healthy and b.admitted and not b.quarantined)
                else 0.0)
        self._rebuild_pmap()
        journal.emit(
            "router", f"reload barrier cutover: {len(flipped)} backend(s) "
            f"now serving the new generation; reloading {last.name}",
            level=journal.INFO, flipped=[b.name for b in flipped])
        ok = reload_one(last)
        self._set_admitted([last], True)
        self._reload_state = {"active": False,
                              "flipped": len(flipped) + int(ok),
                              "total": len(old), "ok": ok}
        journal.emit(
            "router",
            f"reload barrier complete over {len(old)} backend(s)" if ok
            else f"reload barrier FAILED on the last backend {last.name}; "
            "it re-admits when its probe recovers",
            level=journal.INFO if ok else journal.RED,
            durationS=round(time.perf_counter() - t0, 3))

    # ------------------------------------------------------------ lifecycle
    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @draining.setter
    def draining(self, value: bool) -> None:
        if value:
            self.drain()

    def drain(self) -> None:
        """Stop admitting (readyz -> 503, queries -> 503 + Retry-After);
        in-flight forwards finish on the transport's own drain."""
        if self._draining.is_set():
            return
        self._draining.set()
        journal.emit("router", "router drain begin: stopped admitting "
                     "queries", level=journal.INFO)
        self._stop_requested.set()

    def close(self) -> None:
        self._stop_requested.set()
        pool, self._scatter_pool = self._scatter_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        for b in self.backends:
            b.close()


def serve(api: RouterAPI, host: str = "localhost",
          port: int = 8100) -> None:
    """Run the router until /stop or SIGTERM (graceful drain: readiness
    flips, in-flight forwards complete, then exit) on the shared
    transport."""
    from predictionio_tpu_torch.data.api.http import (
        install_sigterm_handler, make_server,
    )
    try:
        server = make_server(api, host, port)
    except BaseException:
        api.close()     # the health poller stops with the failed bind
        raise
    install_sigterm_handler(api.drain)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    logger.info("Router online at http://%s:%s over %d backend(s)",
                host, port, len(api.backends))
    try:
        while not api.stop_requested:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    server.shutdown()
    server.server_close()
    api.close()
