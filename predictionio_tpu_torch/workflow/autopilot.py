"""``pio autopilot``: the SLO-driven control loop of a serving fleet (port
of ``predictionio_tpu/workflow/autopilot.py``).

It polls the router's ``GET /`` and ``/metrics`` (the SLO engine's burn
rates, the per-backend latency histogram ``pio_router_backend_seconds``)
and turns them into rate-limited, journaled, reversible actions:

- **Replicas**: a replica is spawned (``ReplicaPool.spawn``, then the
  router's ``add_backend``) when the fleet's busy fraction is over the
  band or the rotation is under its floor, and drained when it is under
  the band: removed from the router first, so in-flight queries finish,
  and stopped a grace period later. ``SubprocessReplicaPool`` starts
  ``pio deploy`` processes from a ``{port}`` command template; it only
  ever stops what it started.
- **Degradation ladder**: while both burn windows are at or over the page
  threshold (``slo.FAST_BURN_RED``), the router's shed thresholds are
  halved one rung at a time; when the fast window falls under it, the
  rungs unwind in order, each restoring the exact values it replaced.
- **Quarantine**: a replica whose window p99 is ``PIO_AUTOPILOT_OUTLIER_X``
  times the fleet's median is held out of rotation before its breaker
  trips, and readmitted once its probe answers and the cooldown passed.
- **Evidence**: one bounded ``POST /debug/profile`` on a replica per
  sustained-burn episode (the port's ``torch.profiler`` capture, which
  records that replica's B1 and B2 launches).

Every action class has its own cooldown (``PIO_AUTOPILOT_COOLDOWN_S``);
the loop never acts while the fleet shows generation skew or a reload
barrier runs, and a dry run journals would-have actions and touches
nothing.
"""


from __future__ import annotations

import dataclasses
import datetime as _dt
import http.client
import json
import logging
import os
import re
import shlex
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.common import journal, telemetry
from predictionio_tpu_torch.common.slo import FAST_BURN_RED

logger = logging.getLogger("predictionio_tpu_torch.autopilot")

#: action classes sharing one cooldown each — the rate-limit granularity
ACTION_CLASSES = ("scale", "shed", "quarantine", "profile")


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
class AutopilotConfig:
    """`pio autopilot` knobs; every one has a ``PIO_AUTOPILOT_*`` env
    twin so an embedded (``pio router --autopilot``) and a standalone
    loop read the same defaults."""
    #: journal would-have decisions without acting
    dry_run: bool = False
    #: control-loop cadence in ms
    poll_ms: float = 0.0
    #: per-action-class rate limit in seconds
    cooldown_s: float = 0.0
    #: busy-fraction floor below which a replica is drained
    util_low: float = 0.0
    #: busy-fraction ceiling above which a replica is spawned
    util_high: float = 0.0
    #: rotation floor the pool refills to (a killed replica's
    #: replacement path) and the scale-down floor
    min_replicas: int = 0
    #: rotation ceiling for utilization-driven spawns
    max_replicas: int = 0
    #: quarantine trigger: a backend's p99 over this multiple of the
    #: fleet median p99 is an outlier
    outlier_x: float = 0.0
    #: profile capture length per sustained-burn episode
    profile_ms: int = 0

    def resolved(self) -> "AutopilotConfig":
        return dataclasses.replace(
            self,
            poll_ms=self.poll_ms or _env_pos("PIO_AUTOPILOT_POLL_MS",
                                             1000.0),
            cooldown_s=(self.cooldown_s
                        or _env_pos("PIO_AUTOPILOT_COOLDOWN_S", 30.0)),
            util_low=self.util_low or _env_pos("PIO_AUTOPILOT_UTIL_LOW",
                                               0.2),
            util_high=(self.util_high
                       or _env_pos("PIO_AUTOPILOT_UTIL_HIGH", 0.85)),
            min_replicas=(self.min_replicas
                          or _env_int("PIO_AUTOPILOT_MIN_REPLICAS", 1)),
            max_replicas=(self.max_replicas
                          or _env_int("PIO_AUTOPILOT_MAX_REPLICAS", 4)),
            outlier_x=(self.outlier_x
                       or _env_pos("PIO_AUTOPILOT_OUTLIER_X", 3.0)),
            profile_ms=(self.profile_ms
                        or _env_int("PIO_AUTOPILOT_PROFILE_MS", 2000)))


# ---------------------------------------------------------------------------
# router control plane (local method calls or the admin HTTP routes)
# ---------------------------------------------------------------------------

class RouterControl:
    """What the autopilot needs from a router — reads (status, metrics)
    and the reversible actions. Two implementations: in-process method
    calls for the embedded mode, the admin HTTP routes for the
    standalone `pio autopilot --router url` daemon."""

    def status(self) -> Dict[str, Any]:
        raise NotImplementedError

    def metrics_text(self) -> str:
        raise NotImplementedError

    def add_backend(self, url: str) -> None:
        raise NotImplementedError

    def remove_backend(self, name: str) -> None:
        raise NotImplementedError

    def set_quarantine(self, name: str, value: bool) -> None:
        raise NotImplementedError

    def shed_thresholds(self) -> Dict[str, int]:
        raise NotImplementedError

    def set_shed(self, max_inflight: Optional[int] = None,
                 tenant_max_inflight: Optional[int] = None
                 ) -> Dict[str, int]:
        raise NotImplementedError

    def backend_post(self, backend_url: str, path: str,
                     timeout: float = 5.0) -> int:
        """POST straight to one backend (the profile-capture surface
        lives on replicas, not the router); returns the HTTP status."""
        host, _, port = backend_url.split("//", 1)[-1].partition(":")
        conn = http.client.HTTPConnection(host, int(port.rstrip("/")),
                                          timeout=timeout)
        try:
            conn.request("POST", path)
            return conn.getresponse().status
        finally:
            try:
                conn.close()
            except Exception:
                pass


class LocalRouterControl(RouterControl):
    """Embedded mode: the autopilot runs inside the router process."""

    def __init__(self, api: Any):
        self.api = api

    def status(self) -> Dict[str, Any]:
        return self.api.handle("GET", "/")[1]

    def metrics_text(self) -> str:
        return telemetry.registry().exposition()

    def add_backend(self, url: str) -> None:
        self.api.add_backend(url)

    def remove_backend(self, name: str) -> None:
        if not self.api.remove_backend(name):
            raise RuntimeError(f"unknown backend {name}")

    def set_quarantine(self, name: str, value: bool) -> None:
        if not self.api.set_quarantine(name, value):
            raise RuntimeError(f"unknown backend {name}")

    def shed_thresholds(self) -> Dict[str, int]:
        return self.api.set_shed_thresholds()

    def set_shed(self, max_inflight: Optional[int] = None,
                 tenant_max_inflight: Optional[int] = None
                 ) -> Dict[str, int]:
        return self.api.set_shed_thresholds(
            max_inflight=max_inflight,
            tenant_max_inflight=tenant_max_inflight)


class HttpRouterControl(RouterControl):
    """Standalone mode: `pio autopilot --router http://host:port` drives
    the router's admin routes over HTTP."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        u = base_url.rstrip("/")
        if "://" not in u:
            u = "http://" + u
        self.host, _, port = u.split("//", 1)[-1].partition(":")
        if not self.host or not port.isdigit():
            raise ValueError(
                f"--router must be http://host:port, got {base_url!r}")
        self.port = int(port)
        self.timeout = timeout

    def _request(self, method: str, path: str) -> Tuple[int, bytes]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def _json(self, method: str, path: str) -> Dict[str, Any]:
        status, payload = self._request(method, path)
        try:
            obj = json.loads(payload) if payload else {}
        except ValueError:
            obj = {}
        if status >= 400:
            raise RuntimeError(
                f"{method} {path} -> {status}: "
                f"{(obj or {}).get('message', '')}")
        return obj if isinstance(obj, dict) else {}

    def status(self) -> Dict[str, Any]:
        return self._json("GET", "/")

    def metrics_text(self) -> str:
        status, payload = self._request("GET", "/metrics")
        if status != 200:
            raise RuntimeError(f"GET /metrics -> {status}")
        return payload.decode("utf-8", "replace")

    def add_backend(self, url: str) -> None:
        self._json("POST", "/backends?"
                   + urllib.parse.urlencode({"add": url}))

    def remove_backend(self, name: str) -> None:
        self._json("POST", "/backends?"
                   + urllib.parse.urlencode({"remove": name}))

    def set_quarantine(self, name: str, value: bool) -> None:
        q = {"backend": name}
        if not value:
            q["clear"] = "1"
        self._json("POST", "/quarantine?" + urllib.parse.urlencode(q))

    def shed_thresholds(self) -> Dict[str, int]:
        return self._json("POST", "/shed").get("current", {})

    def set_shed(self, max_inflight: Optional[int] = None,
                 tenant_max_inflight: Optional[int] = None
                 ) -> Dict[str, int]:
        q: Dict[str, str] = {}
        if max_inflight is not None:
            q["maxInflight"] = str(max_inflight)
        if tenant_max_inflight is not None:
            q["tenantMaxInflight"] = str(tenant_max_inflight)
        path = "/shed" + ("?" + urllib.parse.urlencode(q) if q else "")
        return self._json("POST", path).get("previous", {})


# ---------------------------------------------------------------------------
# replica pool (the external-orchestrator hook point)
# ---------------------------------------------------------------------------

class ReplicaPool:
    """The replica-control hook contract. The autopilot only ever calls
    these three methods; an external orchestrator (a Kubernetes operator,
    say) implements them and plugs in via ``Autopilot(pool=...)``:

    - ``spawn() -> url | None`` — bring one replica up and return its
      base URL once its ``/readyz`` answers (None = the spawn failed;
      the autopilot journals and retries after the cooldown);
    - ``stop(url) -> bool`` — tear one replica down (called only after
      the router has already drained it from rotation);
    - ``close()`` — release everything at shutdown.

    Without a pool the autopilot still runs the ladder, quarantine and
    profile-capture loops — replica control is simply off."""

    def spawn(self) -> Optional[str]:
        raise NotImplementedError

    def stop(self, url: str) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SubprocessReplicaPool(ReplicaPool):
    """Local subprocess replicas from a ``{port}``-templated command —
    the only replica control the built-in autopilot performs: it never
    touches processes it did not spawn."""

    def __init__(self, command: str, ready_timeout_s: float = 240.0,
                 env: Optional[Dict[str, str]] = None):
        self.command = command
        self.ready_timeout_s = ready_timeout_s
        self.env = env
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    @staticmethod
    def _ready(host: str, port: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                conn = http.client.HTTPConnection(host, port, timeout=2.0)
                conn.request("GET", "/readyz")
                ok = conn.getresponse().status == 200
                conn.close()
                if ok:
                    return True
            except OSError:
                pass
            time.sleep(0.25)
        return False

    def spawn(self) -> Optional[str]:
        port = self._free_port()
        argv = [a.format(port=port) for a in shlex.split(self.command)]
        try:
            proc = subprocess.Popen(argv, env=self.env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
        except OSError as e:
            logger.warning("replica spawn failed: %s", e)
            return None
        url = f"http://127.0.0.1:{port}"
        if not self._ready("127.0.0.1", port, self.ready_timeout_s):
            proc.kill()
            return None
        with self._lock:
            self._procs[url] = proc
        return url

    def stop(self, url: str) -> bool:
        with self._lock:
            proc = self._procs.pop(url, None)
        if proc is None:
            return False
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            proc.kill()
        return True

    def close(self) -> None:
        with self._lock:
            procs, self._procs = dict(self._procs), {}
        for proc in procs.values():
            proc.kill()


# ---------------------------------------------------------------------------
# signals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Signals:
    """One tick's observed fleet state — gather() builds it from the
    router's surfaces; unit tests construct it directly so the state
    machine is drivable with a fake clock."""
    now: float
    #: backend names (host:port) currently in rotation
    in_rotation: List[str] = dataclasses.field(default_factory=list)
    #: configured backends whose probe is currently failing
    unhealthy: List[str] = dataclasses.field(default_factory=list)
    #: backends the autopilot is holding out of rotation
    quarantined: List[str] = dataclasses.field(default_factory=list)
    #: backends whose probe answers (quarantine re-admission gate)
    healthy: List[str] = dataclasses.field(default_factory=list)
    #: backend name -> base URL (pool stop / profile targets)
    urls: Dict[str, str] = dataclasses.field(default_factory=dict)
    generation_skew: bool = False
    reload_active: bool = False
    #: worst fast/slow-window burn across objectives (x budget rate)
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    #: fleet busy fraction over the last tick window (None = first tick)
    utilization: Optional[float] = None
    #: backend name -> (p99 seconds, sample count) over the last window
    backend_p99: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)


def _name_of(url: str) -> str:
    return url.split("//", 1)[-1].rstrip("/")


def _label(labels: str, key: str) -> Optional[str]:
    m = re.search(key + r'="([^"]+)"', labels)
    return m.group(1) if m else None


def _delta_p99(delta: Dict[float, float]) -> Optional[float]:
    """p99 (bucket upper bound) of one backend's cumulative-bucket
    DELTAS over the tick window."""
    pts = sorted(delta.items())
    if not pts or pts[-1][1] <= 0:
        return None
    target = 0.99 * pts[-1][1]
    for le, cum in pts:
        if cum >= target:
            return le
    return pts[-1][0]


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------

class Autopilot:
    """The SLO-driven control loop. ``gather()`` reads the fleet,
    ``tick()`` is the pure-ish state machine (testable with constructed
    :class:`Signals` and a fake clock), ``run()`` loops them."""

    #: per-backend p99 judgments need this many samples in the window
    MIN_P99_SAMPLES = 20
    #: absolute p99 floor (s) below which nothing is an outlier —
    #: microsecond jitter between idle replicas is not a signal
    P99_FLOOR_S = 0.002

    def __init__(self, control: RouterControl,
                 config: Optional[AutopilotConfig] = None,
                 pool: Optional[ReplicaPool] = None):
        self.control = control
        self.config = (config or AutopilotConfig()).resolved()
        self.pool = pool
        self._lock = threading.Lock()
        self._stop = threading.Event()
        #: action class -> monotonic time of its last (would-have) fire
        self._cooldowns: Dict[str, float] = {}
        #: degradation-ladder stack of the EXACT thresholds each widen
        #: rung replaced — recovery pops and restores them verbatim
        self._rungs: List[Dict[str, int]] = []
        self._holdoff = False
        self._episode_captured = False
        #: (mono, busy-seconds sum) of the previous scrape
        self._prev_busy: Optional[Tuple[float, float]] = None
        #: backend -> {le: cumulative count} of the previous scrape
        self._prev_buckets: Dict[str, Dict[float, float]] = {}
        #: (due_mono, url) replicas drained from rotation, awaiting stop
        self._pending_stops: List[Tuple[float, str]] = []
        self._last_action: Optional[Dict[str, Any]] = None
        self._actions_total = 0
        self._pending_dry = 0
        reg = telemetry.registry()
        self._m_actions = reg.counter(
            "pio_autopilot_actions_total",
            "Autopilot actions by action (scale_up / scale_down / "
            "shed_widen / shed_narrow / quarantine / readmit / "
            "profile_capture) and outcome (ok / failed / dry_run)",
            labelnames=("action", "outcome"))
        self._m_state = reg.gauge(
            "pio_autopilot_state",
            "Degradation-ladder depth (0 = normal thresholds, each "
            "rung halved them); -1 while the loop holds off under "
            "generation skew or a running reload barrier").child()
        self._m_age = reg.gauge(
            "pio_autopilot_last_action_age_seconds",
            "Seconds since the autopilot's most recent (or dry-run "
            "would-have) action; 0 until the first").child()

    # -------------------------------------------------------------- signals
    def gather(self, now: Optional[float] = None) -> Signals:
        now = time.monotonic() if now is None else now
        status = self.control.status()
        samples_text = self.control.metrics_text()
        from predictionio_tpu_torch.tools.doctor import parse_metrics
        samples = parse_metrics(samples_text)
        sig = Signals(now=now)
        sig.generation_skew = bool(status.get("generationSkew"))
        sig.reload_active = bool(
            (status.get("reload") or {}).get("active"))
        for b in status.get("backends") or []:
            name = _name_of(b.get("url", ""))
            sig.urls[name] = b.get("url", "")
            if b.get("quarantined"):
                sig.quarantined.append(name)
            if b.get("healthy"):
                sig.healthy.append(name)
            else:
                sig.unhealthy.append(name)
            if b.get("inRotation"):
                sig.in_rotation.append(name)
        for labels, v in samples.get("pio_slo_burn_rate", []):
            window = _label(labels, "window")
            if window == "fast":
                sig.burn_fast = max(sig.burn_fast, v)
            elif window == "slow":
                sig.burn_slow = max(sig.burn_slow, v)
        # per-backend latency p99 over THIS window (cumulative-bucket
        # deltas vs the previous scrape — lifetime quantiles would keep
        # judging a long-recovered replica by its bad hour)
        buckets: Dict[str, Dict[float, float]] = {}
        for labels, v in samples.get("pio_router_backend_seconds_bucket",
                                     []):
            backend = _label(labels, "backend")
            le_raw = _label(labels, "le")
            if backend is None or le_raw is None:
                continue
            le = float(le_raw.replace("+Inf", "inf"))
            buckets.setdefault(backend, {})[le] = v
        for name, cur in buckets.items():
            prev = self._prev_buckets.get(name, {})
            delta = {le: max(0.0, c - prev.get(le, 0.0))
                     for le, c in cur.items()}
            total = max(delta.values()) if delta else 0.0
            p99 = _delta_p99(delta)
            if p99 is not None:
                sig.backend_p99[name] = (p99, total)
        self._prev_buckets = buckets
        busy = sum(v for _l, v in
                   samples.get("pio_router_backend_seconds_sum", []))
        if self._prev_busy is not None and sig.in_rotation:
            t0, b0 = self._prev_busy
            dt = now - t0
            if dt > 0:
                sig.utilization = max(
                    0.0, (busy - b0) / (dt * len(sig.in_rotation)))
        self._prev_busy = (now, busy)
        return sig

    # ---------------------------------------------------------------- tick
    def _ready(self, cls: str, now: float) -> bool:
        last = self._cooldowns.get(cls)
        return last is None or (now - last) >= self.config.cooldown_s

    def _act(self, cls: str, action: str, message: str,
             evidence: Dict[str, Any], fn: Callable[[], Any],
             now: float, level: str = journal.INFO) -> Dict[str, Any]:
        """Run (or dry-run) one decided action: the cooldown charges at
        DECISION time either way (a dry-run must pace exactly like the
        live loop it rehearses), the journal entry carries the
        triggering evidence, and the counter records the outcome."""
        self._cooldowns[cls] = now
        outcome = "dry_run"
        if not self.config.dry_run:
            try:
                fn()
                outcome = "ok"
            except Exception as e:
                outcome = "failed"
                evidence = {**evidence,
                            "error": f"{type(e).__name__}: {e}"}
                level = journal.RED
        journal.emit("autopilot",
                     ("DRY-RUN would: " if outcome == "dry_run" else "")
                     + message,
                     level=level, action=action, outcome=outcome,
                     dryRun=self.config.dry_run, **evidence)
        self._m_actions.labels(action=action, outcome=outcome).inc()
        record = {
            "action": action, "outcome": outcome, "trigger": message,
            "mono": now,
            "at": _dt.datetime.now(_dt.timezone.utc).isoformat(
                timespec="seconds"),
        }
        with self._lock:
            self._actions_total += 1
            if outcome == "dry_run":
                self._pending_dry += 1
            self._last_action = record
        return dict(record)

    def tick(self, sig: Signals) -> List[Dict[str, Any]]:
        """One control decision pass over gathered signals; returns the
        actions taken (or would-have, in dry-run)."""
        cfg = self.config
        acted: List[Dict[str, Any]] = []
        self._process_stops(sig.now)
        holdoff = sig.generation_skew or sig.reload_active
        if holdoff != self._holdoff:
            self._holdoff = holdoff
            journal.emit(
                "autopilot",
                ("holding off: " + ("reload barrier running"
                                    if sig.reload_active
                                    else "fleet shows generation skew")
                 if holdoff else "hold-off cleared, resuming control"),
                level=journal.WARN if holdoff else journal.INFO,
                holdoff=holdoff)
        if holdoff:
            # acting while the fleet disagrees on generations (or while
            # the barrier is mid-cutover) could fight the barrier's own
            # membership choreography — observe, never steer
            self._m_state.set(-1.0)
            self._update_age(sig.now)
            return acted
        self._m_state.set(float(len(self._rungs)))

        # quarantine re-admission: probe recovered + cooldown passed
        for name in list(sig.quarantined):
            if name in sig.healthy and self._ready("quarantine", sig.now):
                acted.append(self._act(
                    "quarantine", "readmit",
                    f"re-admitting {name} from quarantine (readiness "
                    "probe recovered)",
                    {"backend": name}, lambda n=name:
                    self.control.set_quarantine(n, False),
                    sig.now))
                break

        # elastic replica control (only with a pool to act through)
        n = len(sig.in_rotation)
        if self.pool is not None and self._ready("scale", sig.now):
            if n < cfg.min_replicas:
                # a replica died (or never came up): refill the rotation
                acted.append(self._act(
                    "scale", "scale_up",
                    f"rotation at {n} of min {cfg.min_replicas}: "
                    "spawning a replacement replica"
                    + (f" (dead: {', '.join(sig.unhealthy)})"
                       if sig.unhealthy else ""),
                    {"inRotation": n, "minReplicas": cfg.min_replicas,
                     "unhealthy": list(sig.unhealthy)},
                    lambda: self._spawn_and_admit(sig),
                    sig.now, level=journal.WARN))
            elif sig.utilization is not None:
                if (sig.utilization > cfg.util_high
                        and n < cfg.max_replicas):
                    acted.append(self._act(
                        "scale", "scale_up",
                        f"fleet busy fraction {sig.utilization:.2f} over "
                        f"{cfg.util_high:g}: spawning replica "
                        f"{n + 1}/{cfg.max_replicas}",
                        {"utilization": round(sig.utilization, 3),
                         "inRotation": n},
                        lambda: self._spawn_and_admit(sig), sig.now))
                elif (sig.utilization < cfg.util_low
                        and n > cfg.min_replicas):
                    victim = sig.in_rotation[-1]
                    acted.append(self._act(
                        "scale", "scale_down",
                        f"fleet busy fraction {sig.utilization:.2f} "
                        f"under {cfg.util_low:g}: draining {victim} "
                        f"({n - 1} replica(s) remain)",
                        {"utilization": round(sig.utilization, 3),
                         "backend": victim, "inRotation": n},
                        lambda v=victim: self._drain_replica(v, sig),
                        sig.now))

        # degradation ladder: page condition = BOTH windows >= 14.4x
        page = (sig.burn_fast >= FAST_BURN_RED
                and sig.burn_slow >= FAST_BURN_RED)
        if page and self._ready("shed", sig.now):
            current = self.control.shed_thresholds()
            cur_max = int(current.get("maxInflight") or 0)
            cur_tenant = int(current.get("tenantMaxInflight") or 0)
            new_max = max(1, cur_max // 2)
            new_tenant = max(1, cur_tenant // 2) if cur_tenant else 0
            acted.append(self._act(
                "shed", "shed_widen",
                f"burn {sig.burn_fast:.1f}x/{sig.burn_slow:.1f}x over "
                f"the page threshold {FAST_BURN_RED:g}x: widening shed "
                f"(maxInflight {cur_max} -> {new_max})",
                {"burnFast": round(sig.burn_fast, 2),
                 "burnSlow": round(sig.burn_slow, 2),
                 "maxInflight": new_max,
                 "prevMaxInflight": cur_max},
                lambda: self._widen(current, new_max, new_tenant),
                sig.now, level=journal.WARN))
        elif (not page and sig.burn_fast < FAST_BURN_RED and self._rungs
                and self._ready("shed", sig.now)):
            restore = self._rungs[-1]
            acted.append(self._act(
                "shed", "shed_narrow",
                f"burn subsided ({sig.burn_fast:.1f}x fast): restoring "
                f"shed thresholds (maxInflight "
                f"{restore.get('maxInflight')})",
                {"burnFast": round(sig.burn_fast, 2),
                 "restore": dict(restore)},
                self._narrow, sig.now))

        # latency-outlier quarantine (before the breaker trips): needs
        # peers to compare against AND a rotation that survives the hold
        candidates = {n2: pv for n2, pv in sig.backend_p99.items()
                      if n2 in sig.in_rotation
                      and pv[1] >= self.MIN_P99_SAMPLES}
        if (len(candidates) >= 3
                and len(sig.in_rotation) - 1 >= cfg.min_replicas
                and self._ready("quarantine", sig.now)
                and not any(a["action"] == "readmit" for a in acted)):
            worst = max(candidates, key=lambda k: candidates[k][0])
            others = sorted(p for k, (p, _c) in candidates.items()
                            if k != worst)
            median = others[len(others) // 2]
            p99 = candidates[worst][0]
            if p99 > self.P99_FLOOR_S and p99 >= cfg.outlier_x * median:
                acted.append(self._act(
                    "quarantine", "quarantine",
                    f"{worst} p99 {p99 * 1e3:.1f} ms is "
                    f">= {cfg.outlier_x:g}x the fleet median "
                    f"{median * 1e3:.1f} ms: quarantining before its "
                    "breaker trips",
                    {"backend": worst, "p99Ms": round(p99 * 1e3, 2),
                     "fleetMedianMs": round(median * 1e3, 2)},
                    lambda w=worst: self.control.set_quarantine(w, True),
                    sig.now, level=journal.WARN))

        # one bounded profile capture per sustained-burn episode
        if page:
            if (not self._episode_captured and sig.in_rotation
                    and self._ready("profile", sig.now)):
                target = sig.urls.get(sig.in_rotation[0], "")
                if target:
                    acted.append(self._act(
                        "profile", "profile_capture",
                        f"sustained burn episode: capturing a "
                        f"{cfg.profile_ms} ms profile on {target}",
                        {"backend": target,
                         "burnFast": round(sig.burn_fast, 2),
                         "burnSlow": round(sig.burn_slow, 2),
                         "ms": cfg.profile_ms},
                        lambda t=target: self._capture(t), sig.now))
                    self._episode_captured = True
        elif sig.burn_fast < FAST_BURN_RED:
            self._episode_captured = False

        self._update_age(sig.now)
        return acted

    # ------------------------------------------------------- action bodies
    def _spawn_and_admit(self, sig: Signals) -> None:
        assert self.pool is not None
        url = self.pool.spawn()
        if url is None:
            raise RuntimeError("replica spawn failed (pool returned "
                               "no ready URL)")
        self.control.add_backend(url)
        # retire at most one corpse per spawn: a backend that is
        # neither probing healthy nor quarantined is dead weight in the
        # status page once its replacement serves
        for name in sig.unhealthy:
            if name not in sig.quarantined:
                try:
                    self.control.remove_backend(name)
                except Exception:
                    pass
                break

    def _drain_replica(self, name: str, sig: Signals) -> None:
        """Zero-drop scale-down: removing the backend first takes it
        out of rotation (the admitted hold-out — in-flight forwards
        finish on their open sockets), the process stop lands a grace
        period later."""
        url = sig.urls.get(name, "")
        self.control.remove_backend(name)
        if self.pool is not None and url:
            grace = max(1.0, 2 * self.config.poll_ms / 1e3)
            self._pending_stops.append((sig.now + grace, url))

    def _process_stops(self, now: float) -> None:
        due = [u for t, u in self._pending_stops if now >= t]
        if due:
            self._pending_stops = [(t, u) for t, u in self._pending_stops
                                   if now < t]
        for url in due:
            try:
                if self.pool is not None:
                    self.pool.stop(url)
            except Exception:
                logger.exception("deferred replica stop failed: %s", url)

    def _widen(self, current: Dict[str, int], new_max: int,
               new_tenant: int) -> None:
        prev = self.control.set_shed(
            max_inflight=new_max,
            tenant_max_inflight=new_tenant or None)
        self._rungs.append({
            "maxInflight": int(prev.get("maxInflight")
                               or current.get("maxInflight") or 0),
            "tenantMaxInflight": int(
                prev.get("tenantMaxInflight")
                if prev.get("tenantMaxInflight") is not None
                else current.get("tenantMaxInflight") or 0)})
        self._m_state.set(float(len(self._rungs)))

    def _narrow(self) -> None:
        restore = self._rungs.pop()
        self.control.set_shed(
            max_inflight=restore["maxInflight"],
            tenant_max_inflight=restore["tenantMaxInflight"])
        self._m_state.set(float(len(self._rungs)))

    def _capture(self, backend_url: str) -> None:
        status = self.control.backend_post(
            backend_url, f"/debug/profile?ms={self.config.profile_ms}")
        if status not in (202, 409):
            # 409 = a capture is already running — evidence exists
            raise RuntimeError(f"profile capture -> HTTP {status}")

    def _update_age(self, now: float) -> None:
        with self._lock:
            last = self._last_action
        self._m_age.set(max(0.0, now - last["mono"]) if last else 0.0)

    # ------------------------------------------------------------- surface
    def summary(self) -> Dict[str, Any]:
        """The status block `pio doctor` reads (embedded mode rides the
        router's GET / payload)."""
        with self._lock:
            last = dict(self._last_action) if self._last_action else None
            total, pending = self._actions_total, self._pending_dry
        if last is not None:
            last["ageS"] = round(
                max(0.0, time.monotonic() - last.pop("mono")), 1)
        now = time.monotonic()
        cooling = sorted(
            cls for cls, t in self._cooldowns.items()
            if now - t < self.config.cooldown_s)
        return {
            "mode": "dry-run" if self.config.dry_run else "live",
            "ladderDepth": len(self._rungs),
            "holdoff": self._holdoff,
            "cooldownS": self.config.cooldown_s,
            "cooling": cooling,
            "actionsTotal": total,
            "pendingDryRun": pending,
            "lastAction": last,
        }

    # ------------------------------------------------------------ lifecycle
    def run(self) -> None:
        """Loop gather -> tick until stop(); gather errors (a router
        restarting under the loop) are journaled once per streak."""
        interval = self.config.poll_ms / 1e3
        journal.emit(
            "autopilot",
            f"autopilot online ({'dry-run' if self.config.dry_run else 'live'}"
            f", poll {self.config.poll_ms:g} ms, cooldown "
            f"{self.config.cooldown_s:g} s"
            + (", replica pool attached" if self.pool else "")
            + ")",
            level=journal.INFO, dryRun=self.config.dry_run)
        failing = False
        while not self._stop.is_set():
            try:
                self.tick(self.gather())
                failing = False
            except Exception as e:
                if not failing:
                    journal.emit(
                        "autopilot",
                        f"signal gather failed ({type(e).__name__}: "
                        f"{e}); holding until the router answers",
                        level=journal.WARN)
                failing = True
                logger.debug("autopilot tick failed", exc_info=True)
            if self._stop.wait(interval):
                break

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        if self.pool is not None:
            self.pool.close()


def run_autopilot(router_url: str, dry_run: bool = False,
                  config: Optional[AutopilotConfig] = None,
                  replica_cmd: str = "") -> Autopilot:
    """CLI entry: standalone autopilot over the router's admin routes.
    Blocks until KeyboardInterrupt; returns the (stopped) autopilot."""
    cfg = dataclasses.replace(
        (config or AutopilotConfig()), dry_run=dry_run).resolved()
    pool: Optional[ReplicaPool] = None
    if replica_cmd:
        pythonpath = os.pathsep.join(
            p for p in (os.getcwd(), os.environ.get("PYTHONPATH", ""))
            if p)
        pool = SubprocessReplicaPool(
            replica_cmd,
            env={**os.environ, "PYTHONPATH": pythonpath})
    ap = Autopilot(HttpRouterControl(router_url), config=cfg, pool=pool)
    print(f"Autopilot {'DRY-RUN' if cfg.dry_run else 'live'} over "
          f"{router_url} (poll {cfg.poll_ms:g} ms, cooldown "
          f"{cfg.cooldown_s:g} s)", file=sys.stderr)
    try:
        ap.run()
    except KeyboardInterrupt:
        pass
    finally:
        ap.close()
    return ap
