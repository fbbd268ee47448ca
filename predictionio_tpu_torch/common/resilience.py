"""Fault-tolerance primitives shared by every distributed edge (port of
``predictionio_tpu/common/resilience.py``; stdlib only, so the port keeps
its own copy, with the same decisions for the same seed).

The reference system leans on battle-tested networked stores (PostgreSQL/
HBase/Elasticsearch) whose client libraries carry decades of retry and
failover logic; our native `remote` client and HTTP daemons need the same
discipline built in. This module provides it as three small, composable
pieces plus a request-scoped degradation flag:

- :class:`RetryPolicy` — bounded attempts with exponential backoff and
  FULL jitter (the AWS-architecture result: full jitter empties a
  thundering herd fastest), a per-attempt pause cap, and a total
  deadline across attempts. The default policy reproduces the historical
  behavior exactly (one immediate reconnect retry, no sleep), so with no
  knobs set the wire behavior is byte-identical to the pre-resilience
  code. Retries must stay bounded and idempotency-aware — blind resends
  are how retry storms turn a blip into a metastable failure (Bronson
  et al., HotOS '21) — so the transport, not this class, decides WHAT
  is safe to retry.

- :class:`CircuitBreaker` — closed/open/half-open over a sliding
  error-rate window. When the error rate over the window crosses the
  threshold (with a minimum call volume so one failed call out of one
  doesn't trip it), the breaker opens and callers fast-fail with
  :class:`CircuitOpenError` instead of queueing on a dead endpoint;
  after ``open_s`` it half-opens and lets a bounded number of probes
  through, closing again on success.

- :class:`FaultInjector` — deterministic fault injection at the
  transport boundary, driven by ``PIO_FAULT_SPEC`` or the programmatic
  :func:`install`. Supported faults: connection drops (before send and
  after send / before response), added latency, synthetic 5xx, and
  truncated payloads. This is how the chaos suite and the bench
  robustness leg exercise every failure path without root privileges or
  packet filters.

- :func:`note_degraded` / :func:`pop_degraded` — a thread-local flag a
  serving-path side-channel lookup sets when it fails soft (answering
  from on-device factors instead of 500ing); the query server surfaces
  it as ``"degraded": true`` in the response.

Everything here is dependency-free stdlib and safe to import from any
layer.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("predictionio_tpu_torch.resilience")


def _note_breaker_transition(endpoint: str, to_state: str) -> None:
    """Mirror a breaker state change into the metrics registry (gated on
    PIO_TELEMETRY; local import keeps this module usable standalone) and
    the operational journal (always — an opened breaker is exactly the
    history the flight recorder exists for)."""
    from predictionio_tpu_torch.common import journal, telemetry
    journal.emit(
        "breaker",
        f"circuit breaker {to_state} for {endpoint or '?'}",
        level=(journal.RED if to_state == "open" else
               journal.WARN if to_state == "half-open" else journal.INFO),
        endpoint=endpoint or "?", to=to_state)
    if telemetry.on():
        telemetry.registry().counter(
            "pio_breaker_transitions_total",
            "Circuit-breaker state transitions by endpoint",
            labelnames=("endpoint", "to")).labels(
                endpoint=endpoint or "?", to=to_state).inc()


def note_retries_exhausted(where: str, attempts: int,
                           error: BaseException) -> None:
    """Journal a retry schedule giving up (the caller re-raises): the
    moment a transient blip became a caller-visible failure. Called by
    :meth:`RetryPolicy.call` and the remote client's transport loop."""
    from predictionio_tpu_torch.common import journal
    journal.emit(
        "retry",
        f"retries exhausted for {where or '?'} after {attempts} "
        f"attempt(s): {type(error).__name__}",
        level=journal.WARN,
        where=where or "?", attempts=int(attempts),
        error=f"{type(error).__name__}: {error}")


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry schedule: exponential backoff with full jitter.

    ``max_attempts`` counts the first try; ``base_delay_s`` scales the
    backoff (attempt k sleeps uniform(0, min(max_delay_s, base * 2^k)) —
    full jitter); ``total_deadline_s`` bounds the whole operation
    including sleeps (None = unbounded). ``configured`` records whether
    any knob was set explicitly — opt-in behaviors (5xx retry,
    Retry-After honoring) key off it so the zero-config wire behavior
    stays byte-identical to the legacy single-reconnect-retry code.
    """

    max_attempts: int = 2
    base_delay_s: float = 0.0
    max_delay_s: float = 5.0
    total_deadline_s: Optional[float] = None
    configured: bool = False

    #: env names honored by :meth:`from_env` under a prefix, e.g.
    #: PIO_RPC_RETRIES / PIO_RPC_BACKOFF_MS / PIO_RPC_BACKOFF_MAX_MS /
    #: PIO_RPC_DEADLINE_MS.
    @classmethod
    def from_env(cls, prefix: str = "PIO_RPC",
                 properties: Optional[Dict[str, str]] = None) -> "RetryPolicy":
        """Build a policy from env knobs (config `properties` win when
        both are present: RETRIES / BACKOFF_MS / BACKOFF_MAX_MS /
        DEADLINE_MS). With nothing set, the returned policy is the
        byte-identical legacy default."""
        props = properties or {}

        def knob(prop: str, env_suffix: str) -> Optional[float]:
            raw = props.get(prop)
            if raw not in (None, ""):
                try:
                    return float(raw)
                except (TypeError, ValueError):
                    logger.warning("ignoring non-numeric property %s=%r",
                                   prop, raw)
            return _env_float(f"{prefix}_{env_suffix}", None)

        retries = knob("RETRIES", "RETRIES")
        backoff_ms = knob("BACKOFF_MS", "BACKOFF_MS")
        backoff_max_ms = knob("BACKOFF_MAX_MS", "BACKOFF_MAX_MS")
        deadline_ms = knob("DEADLINE_MS", "DEADLINE_MS")
        configured = any(v is not None
                         for v in (retries, backoff_ms, backoff_max_ms,
                                   deadline_ms))
        return cls(
            max_attempts=1 + max(0, int(retries if retries is not None
                                        else 1)),
            base_delay_s=(backoff_ms or 0.0) / 1e3,
            max_delay_s=(backoff_max_ms / 1e3 if backoff_max_ms is not None
                         else 5.0),
            total_deadline_s=(deadline_ms / 1e3
                              if deadline_ms else None),
            configured=configured,
        )

    def may_retry(self, attempt: int,
                  deadline: Optional[float] = None,
                  clock: Callable[[], float] = time.monotonic) -> bool:
        """True when attempt+1 (0-based) is still inside the budget."""
        if attempt + 1 >= self.max_attempts:
            return False
        if deadline is not None and clock() >= deadline:
            return False
        return True

    def backoff_s(self, attempt: int, floor: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
        """Full-jitter pause before retry number ``attempt+1``; ``floor``
        is a server-provided hint (Retry-After) that wins when larger."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        jittered = (rng or random).uniform(0.0, cap) if cap > 0 else 0.0
        return max(jittered, floor)

    def deadline_from_now(
            self, clock: Callable[[], float] = time.monotonic,
    ) -> Optional[float]:
        if self.total_deadline_s is None:
            return None
        return clock() + self.total_deadline_s

    def call(self, fn: Callable[[], Any],
             retry_on: Tuple[type, ...] = (ConnectionError, OSError),
             sleep: Callable[[float], None] = time.sleep,
             clock: Callable[[], float] = time.monotonic) -> Any:
        """Generic executor for non-transport callers (no idempotency
        question): run ``fn`` under this schedule, re-raising the last
        error once attempts or the deadline run out."""
        deadline = self.deadline_from_now(clock)
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                if not self.may_retry(attempt, deadline, clock):
                    if attempt > 0:   # a retried operation gave up —
                        # journal it; a no-retry policy failing first
                        # try is the caller's ordinary error path
                        note_retries_exhausted(
                            getattr(fn, "__name__", "?") or "?",
                            attempt + 1, e)
                    raise
                sleep(self.backoff_s(attempt))
                attempt += 1


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitOpenError(ConnectionError):
    """Fast-fail: the endpoint's breaker is open (error rate over the
    sliding window crossed the threshold). Subclasses ConnectionError so
    callers that already map transport failures to degraded/503 paths
    handle it without new plumbing — but it is never retried (retrying a
    fast-fail would defeat the point)."""

    def __init__(self, endpoint: str, retry_in_s: float):
        super().__init__(
            f"circuit breaker open for {endpoint}; "
            f"next probe in ~{retry_in_s:.1f}s")
        self.endpoint = endpoint
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """Closed/open/half-open breaker over a sliding error-rate window.

    closed: all calls pass; outcomes are recorded into the window.
    open: calls fast-fail with CircuitOpenError until ``open_s`` passed.
    half-open: up to ``half_open_max`` concurrent probes pass; a probe
    success closes the breaker (window reset), a probe failure re-opens
    it for another ``open_s``.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, endpoint: str = "", *,
                 window_s: float = 30.0,
                 error_threshold: float = 0.5,
                 min_calls: int = 10,
                 open_s: float = 5.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.endpoint = endpoint
        self.window_s = float(window_s)
        self.error_threshold = float(error_threshold)
        self.min_calls = int(min_calls)
        self.open_s = float(open_s)
        self.half_open_max = int(half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._events: List[Tuple[float, bool]] = []  # (t, ok)
        self._opened_at = 0.0
        self._probes = 0
        self._opened_total = 0
        self._fast_fails = 0

    # ------------------------------------------------------------- internals
    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        i = 0
        for i, (t, _ok) in enumerate(self._events):
            if t >= cutoff:
                break
        else:
            i = len(self._events)
        if i:
            del self._events[:i]

    def _error_rate(self) -> Tuple[int, float]:
        n = len(self._events)
        if not n:
            return 0, 0.0
        errs = sum(1 for _t, ok in self._events if not ok)
        return n, errs / n

    # ------------------------------------------------------------------ API
    def allow(self) -> None:
        """Gate a call: no-op when closed; raises CircuitOpenError when
        open; admits a bounded probe when half-open."""
        with self._lock:
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at >= self.open_s:
                    self._state = self.HALF_OPEN
                    self._probes = 0
                    _note_breaker_transition(self.endpoint, self.HALF_OPEN)
                else:
                    self._fast_fails += 1
                    raise CircuitOpenError(
                        self.endpoint,
                        self.open_s - (now - self._opened_at))
            if self._state == self.HALF_OPEN:
                if self._probes >= self.half_open_max:
                    self._fast_fails += 1
                    raise CircuitOpenError(self.endpoint, self.open_s)
                self._probes += 1

    def record(self, ok: bool) -> None:
        """Record a call outcome and run the state transitions."""
        with self._lock:
            now = self._clock()
            if self._state == self.HALF_OPEN:
                if ok:  # probe succeeded: close and start fresh
                    self._state = self.CLOSED
                    self._events = []
                    _note_breaker_transition(self.endpoint, self.CLOSED)
                    logger.info("breaker %s: probe ok, closing",
                                self.endpoint or "?")
                else:   # probe failed: back to open for another open_s
                    self._state = self.OPEN
                    self._opened_at = now
                    _note_breaker_transition(self.endpoint, self.OPEN)
                    logger.warning("breaker %s: probe failed, re-opening",
                                   self.endpoint or "?")
                return
            self._events.append((now, ok))
            self._prune(now)
            if self._state == self.CLOSED:
                n, rate = self._error_rate()
                if n >= self.min_calls and rate >= self.error_threshold:
                    self._state = self.OPEN
                    self._opened_at = now
                    self._opened_total += 1
                    _note_breaker_transition(self.endpoint, self.OPEN)
                    logger.warning(
                        "breaker %s: OPEN (error rate %.0f%% over %d calls "
                        "in %.0fs window)", self.endpoint or "?",
                        rate * 100, n, self.window_s)

    @property
    def state(self) -> str:
        with self._lock:
            # surface the time-based open->half-open edge without a call
            if (self._state == self.OPEN
                    and self._clock() - self._opened_at >= self.open_s):
                return self.HALF_OPEN
            return self._state

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n, rate = self._error_rate()
            return {"endpoint": self.endpoint, "state": self._state,
                    "windowCalls": n, "windowErrorRate": round(rate, 4),
                    "opened": self._opened_total,
                    "fastFails": self._fast_fails}

    # ------------------------------------------------- per-endpoint registry
    _registry: Dict[str, "CircuitBreaker"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def for_endpoint(cls, endpoint: str) -> Optional["CircuitBreaker"]:
        """Shared breaker for an endpoint, or None when breakers are off
        (the default). Enable with PIO_BREAKER_ENABLED=1; tune via
        PIO_BREAKER_WINDOW_S / PIO_BREAKER_ERROR_RATE /
        PIO_BREAKER_MIN_CALLS / PIO_BREAKER_OPEN_S. All clients of one
        process share one breaker per endpoint, so a storm detected by
        one thread fast-fails them all."""
        if os.environ.get("PIO_BREAKER_ENABLED", "0") != "1":
            return None
        with cls._registry_lock:
            br = cls._registry.get(endpoint)
            if br is None:
                br = cls(
                    endpoint,
                    window_s=_env_float("PIO_BREAKER_WINDOW_S", 30.0),
                    error_threshold=_env_float(
                        "PIO_BREAKER_ERROR_RATE", 0.5),
                    min_calls=int(_env_float("PIO_BREAKER_MIN_CALLS", 10)),
                    open_s=_env_float("PIO_BREAKER_OPEN_S", 5.0),
                )
                cls._registry[endpoint] = br
            return br

    @classmethod
    def reset_registry(cls) -> None:
        """Drop all shared breakers (tests)."""
        with cls._registry_lock:
            cls._registry.clear()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

#: recognized fault kinds; spec grammar (comma separated):
#:   kind:probability[:arg][@scope]
#:   drop:0.01[:max_fires]     raise ConnectionError before the send
#:   drop_rx:0.01[:max_fires]  ConnectionError AFTER the send (the server
#:                             processed the request; the response is lost
#:                             — the unsafe-retry window)
#:   latency:0.05:100          add 100 ms before dispatch
#:   error:0.02:503            synthesize this 5xx status
#:   truncate:0.01             cut the payload in half mid-body
#: max_fires bounds how often a drop fires (0/absent = unlimited) — the
#: chaos suite uses `drop_rx:1:1` for "exactly one lost response, then
#: heal", the deterministic shape of a mid-request server kill.
#: scope is a substring matched against "<boundary> <route>", e.g.
#: "@client" / "@server" / "@read_columns"; no scope matches everywhere.
_FAULT_KINDS = ("drop", "drop_rx", "latency", "error", "truncate")


class FaultSpecError(ValueError):
    pass


@dataclass(frozen=True)
class _Fault:
    kind: str
    prob: float
    arg: float
    scope: str = ""

    def applies(self, where: str) -> bool:
        return not self.scope or self.scope in where


class InjectedFault(ConnectionError):
    """Marker for injector-raised connection drops (telemetry/tests)."""


class FaultInjector:
    """Deterministic transport-boundary fault injection.

    Construct from a spec string (see module docstring) with an optional
    seed; the shared RNG is lock-guarded so multi-threaded servers get a
    reproducible *stream*, not per-thread reproducibility. Use
    :func:`install` / :func:`clear` programmatically, or set
    ``PIO_FAULT_SPEC`` (+ ``PIO_FAULT_SEED``) in the environment.
    """

    def __init__(self, spec: str, seed: Optional[int] = None):
        self.spec = spec
        self.faults: List[_Fault] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            body, _, scope = part.partition("@")
            bits = body.split(":")
            if len(bits) < 2:
                raise FaultSpecError(
                    f"fault {part!r} must be kind:probability[:arg]")
            kind = bits[0].strip()
            if kind not in _FAULT_KINDS:
                raise FaultSpecError(
                    f"unknown fault kind {kind!r} (have {_FAULT_KINDS})")
            try:
                prob = float(bits[1])
                arg = float(bits[2]) if len(bits) > 2 else 0.0
            except ValueError as e:
                raise FaultSpecError(f"fault {part!r}: {e}") from None
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError(
                    f"fault {part!r}: probability must be in [0, 1]")
            self.faults.append(_Fault(kind, prob, arg, scope.strip()))
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.fired: Dict[str, int] = {}
        self._counts: Dict[int, int] = {}

    def _roll(self, i: int, f: _Fault) -> bool:
        with self._rng_lock:
            # drops honor an optional max-fires bound (arg)
            if (f.kind in ("drop", "drop_rx") and f.arg
                    and self._counts.get(i, 0) >= int(f.arg)):
                return False
            if f.prob >= 1.0:
                return True
            if f.prob <= 0.0:
                return False
            return self._rng.random() < f.prob

    def _fire(self, i: int, f: _Fault) -> None:
        with self._rng_lock:
            self.fired[f.kind] = self.fired.get(f.kind, 0) + 1
            self._counts[i] = self._counts.get(i, 0) + 1

    # -------------------------------------------------------- client hooks
    def before_send(self, boundary: str, route: str) -> None:
        """Latency + pre-send connection drops."""
        where = f"{boundary} {route}"
        for i, f in enumerate(self.faults):
            if not f.applies(where) or not self._roll(i, f):
                continue
            if f.kind == "latency":
                self._fire(i, f)
                time.sleep(f.arg / 1e3)
            elif f.kind == "drop":
                self._fire(i, f)
                raise InjectedFault(f"injected connection drop ({where})")

    def after_send(self, boundary: str, route: str) -> None:
        """The unsafe-retry window: the request reached the server but
        the response is lost."""
        where = f"{boundary} {route}"
        for i, f in enumerate(self.faults):
            if (f.kind == "drop_rx" and f.applies(where)
                    and self._roll(i, f)):
                self._fire(i, f)
                raise InjectedFault(
                    f"injected response loss after send ({where})")

    def on_response(self, boundary: str, route: str, status: int,
                    payload: bytes) -> Tuple[int, bytes]:
        """Synthetic 5xx and payload truncation."""
        where = f"{boundary} {route}"
        for i, f in enumerate(self.faults):
            if not f.applies(where) or not self._roll(i, f):
                continue
            if f.kind == "error":
                self._fire(i, f)
                status = int(f.arg) if f.arg else 503
                payload = (b'{"message": "injected fault: status %d"}'
                           % status)
            elif f.kind == "truncate" and payload:
                self._fire(i, f)
                payload = payload[: max(1, len(payload) // 2)]
        return status, payload


_installed: Optional[FaultInjector] = None
_env_cache: Tuple[str, Optional[FaultInjector]] = ("", None)
_install_lock = threading.Lock()


def install(spec: str, seed: Optional[int] = None) -> FaultInjector:
    """Programmatically install a process-wide fault injector (tests,
    bench). Returns it; undo with :func:`clear`."""
    global _installed
    inj = FaultInjector(spec, seed=seed)
    with _install_lock:
        _installed = inj
    return inj


def clear() -> None:
    global _installed
    with _install_lock:
        _installed = None


def active() -> Optional[FaultInjector]:
    """The installed injector, else one built from PIO_FAULT_SPEC, else
    None. The env path caches per spec value so the check is one dict
    lookup on the hot path — and None (no injection) costs one env read."""
    global _env_cache
    if _installed is not None:
        return _installed
    spec = os.environ.get("PIO_FAULT_SPEC", "")
    if not spec:
        return None
    with _install_lock:
        cached_spec, inj = _env_cache
        if cached_spec != spec:
            seed_raw = os.environ.get("PIO_FAULT_SEED", "")
            inj = FaultInjector(
                spec, seed=int(seed_raw) if seed_raw else None)
            _env_cache = (spec, inj)
        return inj


# ---------------------------------------------------------------------------
# request-scoped degradation flag
# ---------------------------------------------------------------------------

_tls = threading.local()
_degraded_total = 0
_degraded_lock = threading.Lock()


def reset_degraded() -> None:
    """Start a fresh request scope on this thread."""
    _tls.reasons = []


def note_degraded(reason: str) -> None:
    """Record a soft failure (side-channel lookup answered from a
    fallback). Cheap and always safe to call — outside a request scope
    it only bumps the process counter."""
    global _degraded_total
    reasons = getattr(_tls, "reasons", None)
    if reasons is not None:
        reasons.append(reason)
    with _degraded_lock:
        _degraded_total += 1
    logger.warning("degraded: %s", reason)
    # the degraded flip is journal history (and pins the active trace,
    # so the tainted request's spans stay resolvable)
    from predictionio_tpu_torch.common import journal
    journal.emit("degraded", f"degraded serving: {reason}",
                 level=journal.WARN, reason=reason)


def pop_degraded() -> Tuple[str, ...]:
    """Reasons recorded on this thread since reset_degraded(), clearing
    the scope."""
    reasons = tuple(getattr(_tls, "reasons", ()) or ())
    _tls.reasons = None
    return reasons


def degraded_total() -> int:
    with _degraded_lock:
        return _degraded_total
