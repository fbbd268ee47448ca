"""``pio autotrain``: continuous training, the loop that closes the batch
and speed layers (port of ``predictionio_tpu/workflow/autotrain.py``).

- **Triggers**: fold-in drift (the user or item probe's recall under the
  floor), the fold-in tail's cursor lag, the events past the live model's
  training cursor (``runtime_conf["train_cursor"]``), and the live model's
  age, tried in that order. Each trigger class has its own cooldown,
  charged when the decision is made; each decision is journaled under
  ``autotrain`` with its evidence, and a dry run journals the same
  decisions with a ``DRY-RUN would:`` prefix and starts nothing.
- **Retrain**: one ``run_train`` in flight at most, on a thread of the
  serving process (``ThreadTrainer``, on the deploy's device: Gram and
  kernel A run on the card's default stream beside the flushes) or as a
  ``pio train`` subprocess (``SubprocessTrainer``); a crashed attempt is
  restarted once (``run_train``'s auto-resume picks its snapshots up).
- **Validation** (host numpy, as in the reference): the candidate's RMSE
  on a deterministic probe of the app's events may exceed the live
  generation's by at most the tolerance, and its ranking must agree with
  the live model's (``ops.quant.ranking_agreement``, recall@k) above the
  floor. A rejected candidate's ledger row turns ``REJECTED``, so no
  resolve deploys it, and the live generation keeps serving.
- **Publish**: the in-place ``/reload`` at N = 1 (it rebuilds the int8
  layout and warms B1 + B2 up once a bucket) or the router's zero-drop
  ``/reload`` barrier; the server's reload rebases the fold-in worker at
  the candidate's training cursor.

The loop holds off while the fleet shows generation skew or a reload
barrier runs (retrain and validation go on; the publish waits).
"""


from __future__ import annotations

import dataclasses
import datetime as _dt
import http.client
import json
import logging
import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.common import journal, telemetry

logger = logging.getLogger("predictionio_tpu_torch.autotrain")

#: trigger classes sharing one cooldown each — the rate-limit
#: granularity (mirrors autopilot's ACTION_CLASSES)
TRIGGER_CLASSES = ("drift", "lag", "volume", "staleness")

#: control-loop phases the state gauge reports (holdoff = -1)
_PHASES = {"idle": 0, "retraining": 1, "validating": 2, "publishing": 3}


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
class AutotrainConfig:
    """`pio autotrain` knobs; every one has a ``PIO_AUTOTRAIN_*`` env
    twin so the embedded (``pio deploy --autotrain`` / ``pio router
    --autotrain``) and standalone loops read the same defaults."""
    #: journal would-have decisions without retraining
    dry_run: bool = False
    #: control-loop cadence in ms
    poll_ms: float = 0.0
    #: per-trigger-class rate limit in seconds
    cooldown_s: float = 0.0
    #: wall-clock trigger: retrain when the live model is older
    max_staleness_s: float = 0.0
    #: volume trigger: events accumulated past the live model's
    #: recorded training cursor
    volume_events: int = 0
    #: lag trigger: fold-in tail cursor lag (events the speed layer
    #: has not absorbed yet)
    lag_events: int = 0
    #: score gate: candidate probe RMSE may exceed the live model's by
    #: at most this fraction
    tolerance: float = 0.0
    #: parity gate: candidate-vs-live ranking recall@k floor
    parity_min: float = 0.0
    #: deterministic probe sample size (events for the score gate,
    #: users for the parity gate)
    probe: int = 0
    #: how long a publish may take before the cycle fails (the barrier
    #: itself has its own internal timeouts)
    publish_timeout_s: float = 0.0

    def resolved(self) -> "AutotrainConfig":
        return dataclasses.replace(
            self,
            poll_ms=self.poll_ms or _env_pos("PIO_AUTOTRAIN_POLL_MS",
                                             1000.0),
            cooldown_s=(self.cooldown_s
                        or _env_pos("PIO_AUTOTRAIN_COOLDOWN_S", 600.0)),
            max_staleness_s=(self.max_staleness_s
                             or _env_pos("PIO_AUTOTRAIN_MAX_STALENESS_S",
                                         86400.0)),
            volume_events=(self.volume_events
                           or _env_int("PIO_AUTOTRAIN_VOLUME_EVENTS",
                                       5000)),
            lag_events=(self.lag_events
                        or _env_int("PIO_AUTOTRAIN_LAG_EVENTS", 5000)),
            tolerance=(self.tolerance
                       or _env_pos("PIO_AUTOTRAIN_TOLERANCE", 0.02)),
            parity_min=(self.parity_min
                        or _env_pos("PIO_AUTOTRAIN_PARITY_MIN", 0.2)),
            probe=self.probe or _env_int("PIO_AUTOTRAIN_PROBE", 256),
            publish_timeout_s=(
                self.publish_timeout_s
                or _env_pos("PIO_AUTOTRAIN_PUBLISH_TIMEOUT_S", 300.0)))


# ---------------------------------------------------------------------------
# server control plane (the publish surface + status reads)
# ---------------------------------------------------------------------------

class ServerControl:
    """What autotrain needs from a serving front door: the status read
    (generation, skew, reload, fold-in lag/drift) and the publish
    action. Three implementations: the in-process deploy server, the
    in-process router, and the admin HTTP routes."""

    def status(self) -> Dict[str, Any]:
        raise NotImplementedError

    def publish(self) -> None:
        """Kick the reload. May return before the flip lands —
        :meth:`Autotrain._publish` polls :meth:`status` for the
        generation advance either way."""
        raise NotImplementedError


class LocalDeployControl(ServerControl):
    """Embedded ``pio deploy --autotrain``: N=1, publish is the
    in-place hot-swap (synchronous ``_reload`` — no fleet barrier to
    coordinate)."""

    def __init__(self, api: Any):
        self.api = api

    def status(self) -> Dict[str, Any]:
        return self.api.handle("GET", "/")[1]

    def publish(self) -> None:
        self.api._reload()


class LocalRouterControl(ServerControl):
    """Embedded ``pio router --autotrain``: publish joins the router's
    zero-drop reload barrier (``?wait=1``)."""

    def __init__(self, api: Any):
        self.api = api

    def status(self) -> Dict[str, Any]:
        return self.api.handle("GET", "/")[1]

    def publish(self) -> None:
        resp = self.api.handle("POST", "/reload", {"wait": "1"})
        if resp[0] >= 400:
            raise RuntimeError(
                f"reload barrier -> {resp[0]}: "
                f"{(resp[1] or {}).get('message', '')}")


class HttpServerControl(ServerControl):
    """Standalone ``pio autotrain --server url`` over a deploy server
    or router; the engine server answers /reload asynchronously and
    ignores the query flag — the generation poll covers both."""

    def __init__(self, base_url: str, timeout: float = 330.0):
        u = base_url.rstrip("/")
        if "://" not in u:
            u = "http://" + u
        self.host, _, port = u.split("//", 1)[-1].partition(":")
        if not self.host or not port.isdigit():
            raise ValueError(
                f"--server must be http://host:port, got {base_url!r}")
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

    def status(self) -> Dict[str, Any]:
        code, payload = self._request("GET", "/")
        if code != 200:
            raise RuntimeError(f"GET / -> {code}")
        obj = json.loads(payload) if payload else {}
        return obj if isinstance(obj, dict) else {}

    def publish(self) -> None:
        code, payload = self._request("POST", "/reload?wait=1")
        if code >= 400:
            raise RuntimeError(f"POST /reload -> {code}")


# ---------------------------------------------------------------------------
# managed retrain (thread for embedded, subprocess for standalone)
# ---------------------------------------------------------------------------

class Trainer:
    """The managed-retrain contract: ``start()`` launches one attempt
    (raises if one is already running — the concurrency guard's second
    line of defense), ``poll()`` answers None while running and a
    ``{"ok", "instanceId", "error"}`` dict once done."""

    def start(self) -> None:
        raise NotImplementedError

    def poll(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    @property
    def running(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ThreadTrainer(Trainer):
    """Embedded mode: ``run_train`` on a daemon thread in the serving
    process (the closure the CLI builds carries ctx/engine/params).
    Crash-resume is run_train's own iteration-snapshot auto-resume —
    a restarted attempt picks the snapshots up.

    torch's current CUDA device is per thread: ``device`` (the deploy's)
    is pinned to the card that is current where the trainer is built,
    and the retrain thread makes that card current before it trains."""

    def __init__(self, fn: Callable[[], str], device: Any = None):
        self.fn = fn
        self._cuda_index: Optional[int] = None
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[Dict[str, Any]] = None

    def start(self) -> None:
        if self.running:
            raise RuntimeError("a retrain is already in flight")
        self._result = None
        self._thread = threading.Thread(
            target=self._run, name="pio-autotrain-retrain", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self._cuda_index is not None:
                import torch
                torch.cuda.set_device(self._cuda_index)
            iid = self.fn()
            self._result = {"ok": True,
                            "instanceId": str(iid) if iid else None}
        except Exception as e:
            logger.warning("managed retrain failed", exc_info=True)
            self._result = {"ok": False, "instanceId": None,
                            "error": f"{type(e).__name__}: {e}"}

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def poll(self) -> Optional[Dict[str, Any]]:
        return None if self.running else self._result


class SubprocessTrainer(Trainer):
    """Standalone mode: a ``pio train`` command line per attempt.
    ``PIO_AUTO_RESUME`` stays at its default (on), so relaunching the
    same command after a crash resumes from the dead run's iteration
    snapshots."""

    def __init__(self, command: str,
                 env: Optional[Dict[str, str]] = None):
        self.command = command
        self.env = env
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        if self.running:
            raise RuntimeError("a retrain is already in flight")
        self._proc = subprocess.Popen(
            shlex.split(self.command),
            env={**os.environ, **(self.env or {})})

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def poll(self) -> Optional[Dict[str, Any]]:
        if self._proc is None:
            return None
        rc = self._proc.poll()
        if rc is None:
            return None
        return {"ok": rc == 0, "instanceId": None,
                "error": None if rc == 0 else f"train exited {rc}"}

    def close(self) -> None:
        if self.running:
            self._proc.kill()


# ---------------------------------------------------------------------------
# candidate validation (the serve gate)
# ---------------------------------------------------------------------------

def _factor_model(models: Optional[List[Any]]) -> Optional[Any]:
    """First model carrying the fold-in-shaped surface (factor
    matrices + vocabs) — the validatable kind."""
    for m in models or ():
        if all(getattr(m, a, None) is not None
               for a in ("user_factors", "item_factors",
                         "user_vocab", "item_vocab")):
            return m
    return None


def _load_models(storage: Any, instance_id: str) -> Optional[List[Any]]:
    from predictionio_tpu_torch.workflow import model_io
    blob = storage.get_model_data_models().get(instance_id)
    if blob is None:
        return None
    return model_io.deserialize_models(blob.models)


def _probe_triples(storage: Any, engine_params: Any,
                   sample: int) -> List[Tuple[str, str, float]]:
    """A deterministic (user, item, rating) probe set: the app's
    rating-shaped events sorted by (time, entities), evenly-spaced
    down to ``sample`` — both validation gates and the reject-path
    tests see the exact same triples every run. A store with a columnar
    read (eventlog, SQLite, remote) is read through it, without an Event
    object per row (the reference's ``find`` at 20M events is minutes of
    host work); the triples are the same."""
    from predictionio_tpu_torch.realtime import foldin as foldin_mod
    cfg = foldin_mod.config_for(engine_params)
    if cfg is None:
        return []
    app = storage.get_meta_data_apps().get_by_name(cfg.app_name)
    if app is None:
        return []
    try:
        events = storage.get_events()
    except Exception:
        return []
    if hasattr(events, "read_columns"):
        try:
            cols = events.read_columns(
                app.id, cfg.channel_id, event_names=list(cfg.event_names),
                entity_type=cfg.entity_type,
                target_entity_type=cfg.target_entity_type,
                rating_property=cfg.rating_property)
        except NotImplementedError:
            cols = None
        if cols is not None:
            return _column_triples(cols, cfg, sample)
    evs = list(events.find(
        app.id, channel_id=cfg.channel_id, entity_type=cfg.entity_type,
        event_names=list(cfg.event_names),
        target_entity_type=cfg.target_entity_type))
    evs.sort(key=lambda e: (e.event_time, str(e.entity_id),
                            str(e.target_entity_id)))
    triples: List[Tuple[str, str, float]] = []
    for e in evs:
        if e.entity_id is None or e.target_entity_id is None:
            continue
        if e.event == "buy":
            rv = cfg.buy_rating
        else:
            v = e.properties.get_opt(cfg.rating_property) \
                if e.properties else None
            try:
                rv = float(v)
            except (TypeError, ValueError):
                continue
        triples.append((str(e.entity_id), str(e.target_entity_id), rv))
    if len(triples) > sample:
        pick = np.unique(np.linspace(0, len(triples) - 1,
                                     sample).astype(np.int64))
        triples = [triples[i] for i in pick]
    return triples


def _column_triples(cols: Dict[str, Any], cfg: Any,
                    sample: int) -> List[Tuple[str, str, float]]:
    """:func:`_probe_triples` over a columnar read: rows without a target
    or a numeric rating dropped (a ``buy`` rates ``cfg.buy_rating``), the
    order of a stable sort on (time, entity id, target id) with the ids
    compared as strings, then the evenly spaced sample. Only the sampled
    positions are resolved: a stable sort on time, then each sampled
    position's run of equal times ordered by the ids (a full three-key
    sort of 20M rows is tens of seconds of host time)."""
    pool = cols["pool"]
    ent = np.asarray(cols["entity_code"], np.int64)
    tgt = np.asarray(cols["target_code"], np.int64)
    rating = np.asarray(cols["rating"], np.float32)
    if "buy" in pool:
        rating = np.where(
            np.asarray(cols["event_code"]) == pool.index("buy"),
            np.float32(cfg.buy_rating), rating)
    keep = np.flatnonzero((ent >= 0) & (tgt >= 0) & ~np.isnan(rating))
    if keep.size == 0:
        return []
    t_ms = np.asarray(cols["time_ms"], np.int64)[keep]
    by_time = keep[np.argsort(t_ms, kind="stable")]
    t_sorted = np.sort(t_ms, kind="stable")
    n = by_time.size
    picks = np.arange(n, dtype=np.int64) if n <= sample else np.unique(
        np.linspace(0, n - 1, sample).astype(np.int64))
    rank = np.empty(len(pool), np.int64)
    rank[sorted(range(len(pool)), key=pool.__getitem__)] = np.arange(
        len(pool))
    runs: Dict[int, np.ndarray] = {}
    rows = []
    for p in picks.tolist():
        lo = int(np.searchsorted(t_sorted, t_sorted[p], "left"))
        hi = int(np.searchsorted(t_sorted, t_sorted[p], "right"))
        if hi - lo == 1:
            rows.append(int(by_time[p]))
            continue
        run = runs.get(lo)
        if run is None:
            grp = by_time[lo:hi]
            run = grp[np.lexsort((rank[tgt[grp]], rank[ent[grp]]))]
            runs[lo] = run
        rows.append(int(run[p - lo]))
    return [(pool[ent[i]], pool[tgt[i]], float(rating[i])) for i in rows]


def _probe_rmse(model: Any,
                triples: List[Tuple[str, str, float]]
                ) -> Tuple[Optional[float], int]:
    """RMSE of the model's reconstruction over the probe triples it
    can score (both entities in vocab); (None, 0) when it can score
    none — the gate then skips rather than judging on nothing."""
    U = np.asarray(model.user_factors, np.float32)
    V = np.asarray(model.item_factors, np.float32)
    uix, iix, r = [], [], []
    for uid, iid, rv in triples:
        u = model.user_vocab.get(uid)
        i = model.item_vocab.get(iid)
        if u is None or i is None:
            continue
        uix.append(int(u))
        iix.append(int(i))
        r.append(rv)
    if not r:
        return None, 0
    pred = np.sum(U[uix] * V[iix], axis=1)
    err = pred - np.asarray(r, np.float32)
    return float(np.sqrt(np.mean(err * err))), len(r)


def _aligned_factors(live: Any, cand: Any
                     ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]]:
    """Gather both models' factor rows onto the COMMON vocabulary in
    the live model's (deterministic) order, so the parity probe's
    index spaces line up row for row."""
    cu, ci = cand.user_vocab, cand.item_vocab
    u_pairs = sorted(
        (int(a), int(b)) for key, a in live.user_vocab.to_dict().items()
        if (b := cu.get(key)) is not None)
    i_pairs = sorted(
        (int(a), int(b)) for key, a in live.item_vocab.to_dict().items()
        if (b := ci.get(key)) is not None)
    if not u_pairs or not i_pairs:
        return None
    la = np.asarray(live.user_factors, np.float32)
    lv = np.asarray(live.item_factors, np.float32)
    ca = np.asarray(cand.user_factors, np.float32)
    cv = np.asarray(cand.item_factors, np.float32)
    ua = la[[a for a, _ in u_pairs]]
    ub = ca[[b for _, b in u_pairs]]
    va = lv[[a for a, _ in i_pairs]]
    vb = cv[[b for _, b in i_pairs]]
    return ua, va, ub, vb


def validate_candidate(storage: Any, engine_params: Any,
                       live_id: Optional[str], candidate_id: str,
                       tolerance: float = 0.02, parity_min: float = 0.2,
                       sample: int = 256, k: int = 10) -> Dict[str, Any]:
    """The serve gate: score (probe RMSE within tolerance of the live
    generation's) AND ranking parity (candidate-vs-live recall@k over
    the common vocabulary). A gate that cannot run — no live blob, no
    probe events, a non-factor engine — is recorded as skipped, never
    silently passed as measured. Returns the verdict dict that lands
    in the journal evidence and ``summary()['lastCandidate']``."""
    out: Dict[str, Any] = {"candidateId": candidate_id,
                           "liveId": live_id, "ok": True,
                           "reasons": []}
    cand_models = _load_models(storage, candidate_id)
    if cand_models is None:
        out["ok"] = False
        out["reasons"].append("candidate has no model blob")
        return out
    cand = _factor_model(cand_models)
    live = _factor_model(_load_models(storage, live_id)
                         if live_id else None)
    if live is None or cand is None:
        # nothing to compare against (first generation, or a
        # non-factor engine): both gates skip — journaled as such
        out["score"] = {"skipped": "no comparable factor models"}
        out["parity"] = {"skipped": "no comparable factor models"}
        return out
    triples = _probe_triples(storage, engine_params, sample)
    if not triples:
        out["score"] = {"skipped": "no probe events"}
    else:
        live_rmse, n_live = _probe_rmse(live, triples)
        cand_rmse, n_cand = _probe_rmse(cand, triples)
        if live_rmse is None or cand_rmse is None:
            out["score"] = {"skipped": "probe covers neither vocab"}
        else:
            ok = cand_rmse <= live_rmse * (1.0 + tolerance) + 1e-9
            out["score"] = {"live": round(live_rmse, 6),
                            "candidate": round(cand_rmse, 6),
                            "tolerance": tolerance,
                            "probeTriples": min(n_live, n_cand),
                            "ok": ok}
            if not ok:
                out["ok"] = False
                out["reasons"].append(
                    f"probe RMSE {cand_rmse:.4f} worse than live "
                    f"{live_rmse:.4f} beyond the {tolerance:g} "
                    "tolerance")
    aligned = _aligned_factors(live, cand)
    if aligned is None:
        out["parity"] = {"skipped": "no common vocabulary"}
    else:
        from predictionio_tpu_torch.ops import quant as quant_mod
        parity = quant_mod.ranking_agreement(*aligned, k=k,
                                             sample=sample)
        parity["floor"] = parity_min
        parity["ok"] = parity["recall"] >= parity_min
        out["parity"] = parity
        if not parity["ok"]:
            out["ok"] = False
            out["reasons"].append(
                f"ranking parity recall@{parity['k']} "
                f"{parity['recall']:.3f} under the {parity_min:g} "
                "floor")
    return out


def mark_rejected(storage: Any, instance_id: str) -> None:
    """Flip a failed candidate's ledger row to REJECTED so no
    ``get_latest_completed`` resolve — a manual ``/reload`` included —
    ever deploys it."""
    from predictionio_tpu_torch.data.storage import EngineInstance
    instances = storage.get_meta_data_engine_instances()
    row = instances.get(instance_id)
    if row is None:
        return
    instances.update(EngineInstance(
        **{**row.__dict__, "status": "REJECTED"}))


# ---------------------------------------------------------------------------
# signals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Signals:
    """One tick's observed state — ``gather()`` builds it from the
    control surface + the ledger; unit tests construct it directly so
    the state machine is drivable with a fake clock."""
    now: float
    generation: int = 0
    generation_skew: bool = False
    reload_active: bool = False
    live_instance_id: Optional[str] = None
    #: seconds since the live model's training run finished
    staleness_s: Optional[float] = None
    #: events past the live model's recorded training cursor
    volume: Optional[int] = None
    #: fold-in tail cursor lag (events the speed layer has not read)
    cursor_lag: Optional[int] = None
    #: latest fold-in drift-probe recalls (None = no probe yet)
    drift: Optional[float] = None
    item_drift: Optional[float] = None


def _generation_of(status: Dict[str, Any]) -> int:
    if "generation" in status:
        return int(status.get("generation") or 0)
    gens = status.get("generations") or []
    return max((int(g) for g in gens), default=0)


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------

class Autotrain:
    """The continuous-training control loop. ``gather()`` reads the
    serving surface + ledger, ``tick()`` is the testable state machine
    (idle → retraining → validating → publishing → idle), ``run()``
    loops them."""

    def __init__(self, control: ServerControl, storage: Any,
                 engine_params: Any = None,
                 trainer: Optional[Trainer] = None,
                 config: Optional[AutotrainConfig] = None,
                 engine_id: str = "default",
                 engine_version: str = "NOT_USED",
                 engine_variant: str = "default"):
        self.control = control
        self.storage = storage
        self.engine_params = engine_params
        self.trainer = trainer
        self.config = (config or AutotrainConfig()).resolved()
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._phase = "idle"
        self._holdoff = False
        #: trigger class -> monotonic time of its last (would-have) fire
        self._cooldowns: Dict[str, float] = {}
        self._live_id: Optional[str] = None
        self._candidate_id: Optional[str] = None
        self._retry_used = False
        self._cycle_start: Optional[float] = None
        self._cycle_trigger: Optional[str] = None
        self._pre_generation = 0
        self._last_decision: Optional[Dict[str, Any]] = None
        self._last_candidate: Optional[Dict[str, Any]] = None
        self._last_cycle: Optional[Dict[str, Any]] = None
        self._last_signals: Optional[Signals] = None
        self._decisions_total = 0
        self._pending_dry = 0
        self._rejected_total = 0
        self._app_id: Optional[int] = None
        reg = telemetry.registry()
        self._m_decisions = reg.counter(
            "pio_autotrain_decisions_total",
            "Autotrain retrain decisions by trigger (drift / lag / "
            "volume / staleness) and outcome (ok / failed / dry_run)",
            labelnames=("trigger", "outcome"))
        self._m_candidates = reg.counter(
            "pio_autotrain_candidates_total",
            "Validated retrain candidates by verdict (accepted / "
            "rejected / failed)", labelnames=("verdict",))
        self._m_state = reg.gauge(
            "pio_autotrain_state",
            "Control-loop phase (0 idle, 1 retraining, 2 validating, "
            "3 publishing; -1 while holding off under generation skew "
            "or a running reload barrier)").child()
        self._m_age = reg.gauge(
            "pio_autotrain_last_decision_age_seconds",
            "Seconds since autotrain's most recent (or dry-run "
            "would-have) retrain decision; 0 until the first").child()

    # -------------------------------------------------------------- signals
    def _resolve_app_id(self) -> Optional[int]:
        if self._app_id is not None:
            return self._app_id
        from predictionio_tpu_torch.realtime import foldin as foldin_mod
        cfg = foldin_mod.config_for(self.engine_params) \
            if self.engine_params is not None else None
        if cfg is None:
            return None
        app = self.storage.get_meta_data_apps().get_by_name(cfg.app_name)
        if app is None:
            return None
        self._app_id = int(app.id)
        return self._app_id

    def gather(self, now: Optional[float] = None) -> Signals:
        now = time.monotonic() if now is None else now
        status = self.control.status()
        sig = Signals(now=now)
        sig.generation = _generation_of(status)
        sig.generation_skew = bool(status.get("generationSkew"))
        sig.reload_active = bool(
            (status.get("reload") or {}).get("active"))
        fold = status.get("foldin") or {}
        lag = fold.get("cursorLag")
        sig.cursor_lag = int(lag) if lag is not None else None
        for key, attr in (("drift", "drift"),
                          ("itemDrift", "item_drift")):
            block = fold.get(key) or {}
            if block.get("recall") is not None:
                setattr(sig, attr, float(block["recall"]))
        # the live generation's ledger row: staleness + volume triggers
        instances = self.storage.get_meta_data_engine_instances()
        iid = (status.get("engineInstance") or {}).get("id")
        row = instances.get(iid) if iid else \
            instances.get_latest_completed(
                self.engine_id, self.engine_version, self.engine_variant)
        if row is not None:
            sig.live_instance_id = row.id
            try:
                from predictionio_tpu_torch.data.event import utcnow
                sig.staleness_s = max(
                    0.0, (utcnow() - row.end_time).total_seconds())
            except (TypeError, AttributeError):
                sig.staleness_s = None
            raw = (row.runtime_conf or {}).get("train_cursor")
            app_id = self._resolve_app_id()
            if raw and app_id is not None:
                try:
                    cursor = json.loads(raw) if isinstance(raw, str) \
                        else raw
                    events = self.storage.get_events()
                    sig.volume = int(events.cursor_lag(
                        app_id, None, cursor))
                except Exception:
                    sig.volume = None
        with self._lock:
            self._live_id = sig.live_instance_id or self._live_id
            self._last_signals = sig
        return sig

    # ---------------------------------------------------------------- tick
    def _ready(self, cls: str, now: float) -> bool:
        last = self._cooldowns.get(cls)
        return last is None or (now - last) >= self.config.cooldown_s

    def _decide(self, cls: str, message: str,
                evidence: Dict[str, Any], fn: Callable[[], Any],
                now: float) -> Dict[str, Any]:
        """One retrain decision: cooldown charges at DECISION time
        (dry-run paces exactly like the live loop it rehearses), the
        journal entry carries the triggering evidence, the counter
        records the outcome."""
        self._cooldowns[cls] = now
        outcome, level = "dry_run", journal.INFO
        if not self.config.dry_run:
            try:
                fn()
                outcome = "ok"
            except Exception as e:
                outcome = "failed"
                evidence = {**evidence,
                            "error": f"{type(e).__name__}: {e}"}
                level = journal.RED
        journal.emit("autotrain",
                     ("DRY-RUN would: " if outcome == "dry_run" else "")
                     + message,
                     level=level, trigger=cls, outcome=outcome,
                     dryRun=self.config.dry_run, **evidence)
        self._m_decisions.labels(trigger=cls, outcome=outcome).inc()
        record = {
            "trigger": cls, "outcome": outcome, "message": message,
            "mono": now,
            "at": _dt.datetime.now(_dt.timezone.utc).isoformat(
                timespec="seconds"),
        }
        with self._lock:
            self._decisions_total += 1
            if outcome == "dry_run":
                self._pending_dry += 1
            self._last_decision = record
        return dict(record)

    def _start_retrain(self, cls: str, sig: Signals) -> None:
        if self.trainer is None:
            raise RuntimeError("no trainer configured (embedded loops "
                               "get one from the CLI; standalone needs "
                               "--train-cmd or an engine dir)")
        self.trainer.start()
        self._phase = "retraining"
        self._retry_used = False
        self._candidate_id = None
        self._cycle_start = sig.now
        self._cycle_trigger = cls
        self._pre_generation = sig.generation

    def _fail_cycle(self, message: str, evidence: Dict[str, Any]) -> None:
        journal.emit("autotrain", f"retrain cycle failed: {message}",
                     level=journal.RED,
                     trigger=self._cycle_trigger, **evidence)
        self._m_candidates.labels(verdict="failed").inc()
        self._phase = "idle"
        self._candidate_id = None

    def _resolve_candidate(self) -> Optional[str]:
        """Subprocess trains do not report the new instance id: the
        latest COMPLETED row that is not the live generation is the
        candidate (the one-in-flight guard makes this unambiguous)."""
        instances = self.storage.get_meta_data_engine_instances()
        row = instances.get_latest_completed(
            self.engine_id, self.engine_version, self.engine_variant)
        if row is None or row.id == self._live_id:
            return None
        return row.id

    def _poll_retrain(self, sig: Signals) -> None:
        res = self.trainer.poll() if self.trainer is not None else None
        if res is None:
            return
        if not res.get("ok"):
            if not self._retry_used:
                # one crash-resume: the relaunched run seeds itself
                # from the dead attempt's iteration snapshots
                self._retry_used = True
                journal.emit(
                    "autotrain",
                    "retrain crashed; restarting once (iteration-"
                    "snapshot auto-resume picks up where it died)",
                    level=journal.WARN, trigger=self._cycle_trigger,
                    error=res.get("error"))
                try:
                    self.trainer.start()
                except Exception as e:
                    self._fail_cycle(
                        "crash-resume restart failed",
                        {"error": f"{type(e).__name__}: {e}"})
                return
            self._fail_cycle("retrain failed twice",
                             {"error": res.get("error")})
            return
        cand = res.get("instanceId") or self._resolve_candidate()
        if not cand or cand == self._live_id:
            self._fail_cycle(
                "train finished but produced no new COMPLETED "
                "instance", {"liveInstanceId": self._live_id})
            return
        self._candidate_id = cand
        self._phase = "validating"

    def _validate(self, sig: Signals) -> None:
        cfg = self.config
        try:
            verdict = validate_candidate(
                self.storage, self.engine_params, self._live_id,
                self._candidate_id, tolerance=cfg.tolerance,
                parity_min=cfg.parity_min, sample=cfg.probe)
        except Exception as e:
            self._fail_cycle("candidate validation errored",
                             {"candidateId": self._candidate_id,
                              "error": f"{type(e).__name__}: {e}"})
            return
        with self._lock:
            self._last_candidate = verdict
        if verdict["ok"]:
            journal.emit(
                "autotrain",
                (f"candidate {verdict['candidateId']} validated "
                 "(score + ranking parity gates): publishing"),
                level=journal.INFO, **{
                    k: v for k, v in verdict.items() if k != "ok"})
            self._phase = "publishing"
            return
        # reject: ledger row flips so no resolve deploys it; the
        # prior generation keeps serving untouched
        try:
            mark_rejected(self.storage, self._candidate_id)
        except Exception:
            logger.exception("could not mark %s REJECTED",
                             self._candidate_id)
        self._m_candidates.labels(verdict="rejected").inc()
        with self._lock:
            self._rejected_total += 1
        journal.emit(
            "autotrain",
            (f"candidate {verdict['candidateId']} REJECTED "
             f"({'; '.join(verdict['reasons'])}); prior generation "
             "keeps serving"),
            level=journal.RED, **{
                k: v for k, v in verdict.items() if k != "ok"})
        self._phase = "idle"
        self._candidate_id = None

    def _publish(self, sig: Signals) -> None:
        cfg = self.config
        try:
            self.control.publish()
            deadline = time.monotonic() + cfg.publish_timeout_s
            gen = sig.generation
            while time.monotonic() < deadline:
                gen = _generation_of(self.control.status())
                if gen > self._pre_generation:
                    break
                self._stop.wait(0.05)
            if gen <= self._pre_generation:
                raise RuntimeError(
                    f"generation did not advance past "
                    f"{self._pre_generation} within "
                    f"{cfg.publish_timeout_s:g}s")
        except Exception as e:
            self._fail_cycle(
                "publish failed (candidate stays COMPLETED — a later "
                "/reload picks the validated model up)",
                {"candidateId": self._candidate_id,
                 "error": f"{type(e).__name__}: {e}"})
            return
        cycle_s = (time.monotonic() - self._cycle_start
                   if self._cycle_start is not None else 0.0)
        self._m_candidates.labels(verdict="accepted").inc()
        record = {"trigger": self._cycle_trigger,
                  "candidateId": self._candidate_id,
                  "generation": gen, "cycleS": round(cycle_s, 3)}
        with self._lock:
            self._last_cycle = record
            self._live_id = self._candidate_id
        journal.emit(
            "autotrain",
            (f"candidate {self._candidate_id} published: generation "
             f"{gen} live (cycle {cycle_s:.1f}s from the "
             f"{self._cycle_trigger} trigger); fold-in rebases onto "
             "the new batch base"),
            level=journal.INFO, **record)
        self._phase = "idle"
        self._candidate_id = None

    def tick(self, sig: Signals) -> List[Dict[str, Any]]:
        """One control pass over gathered signals; returns the retrain
        decisions made (or would-have, in dry-run)."""
        cfg = self.config
        acted: List[Dict[str, Any]] = []
        holdoff = sig.generation_skew or sig.reload_active
        if holdoff != self._holdoff:
            self._holdoff = holdoff
            journal.emit(
                "autotrain",
                ("holding off: " + ("reload barrier running"
                                    if sig.reload_active
                                    else "fleet shows generation skew")
                 if holdoff else "hold-off cleared, resuming control"),
                level=journal.WARN if holdoff else journal.INFO,
                holdoff=holdoff)

        # drive an in-flight cycle forward (retrain/validate keep
        # making progress under holdoff — only the PUBLISH waits)
        if self._phase == "retraining":
            self._poll_retrain(sig)
        if self._phase == "validating":
            self._validate(sig)
        if self._phase == "publishing" and not holdoff:
            self._publish(sig)

        # trigger decisions: only from idle (one retrain in flight,
        # ever) and never while the fleet is mid-choreography
        if self._phase == "idle" and not holdoff:
            from predictionio_tpu_torch.realtime.foldin import (
                drift_recall_floor,
            )
            floor = drift_recall_floor()
            drifted = [
                (name, r) for name, r in (("user", sig.drift),
                                          ("item", sig.item_drift))
                if r is not None and r < floor]
            if drifted and self._ready("drift", sig.now):
                names = "+".join(n for n, _r in drifted)
                worst = min(r for _n, r in drifted)
                acted.append(self._decide(
                    "drift",
                    (f"start streamed retrain ({names} fold-in drift "
                     f"recall {worst:.3f} under the {floor:g} floor)"),
                    {"driftRecall": round(worst, 4), "floor": floor,
                     "sides": [n for n, _r in drifted]},
                    lambda: self._start_retrain("drift", sig), sig.now))
            elif (sig.cursor_lag is not None
                    and sig.cursor_lag >= cfg.lag_events
                    and self._ready("lag", sig.now)):
                acted.append(self._decide(
                    "lag",
                    (f"start streamed retrain (fold-in cursor lag "
                     f"{sig.cursor_lag} >= {cfg.lag_events} — the "
                     "speed layer is not keeping up)"),
                    {"cursorLag": sig.cursor_lag,
                     "threshold": cfg.lag_events},
                    lambda: self._start_retrain("lag", sig), sig.now))
            elif (sig.volume is not None
                    and sig.volume >= cfg.volume_events
                    and self._ready("volume", sig.now)):
                acted.append(self._decide(
                    "volume",
                    (f"start streamed retrain ({sig.volume} events "
                     f"past the live model's training cursor >= "
                     f"{cfg.volume_events})"),
                    {"volume": sig.volume,
                     "threshold": cfg.volume_events,
                     "liveInstanceId": sig.live_instance_id},
                    lambda: self._start_retrain("volume", sig),
                    sig.now))
            elif (sig.staleness_s is not None
                    and sig.staleness_s >= cfg.max_staleness_s
                    and self._ready("staleness", sig.now)):
                acted.append(self._decide(
                    "staleness",
                    (f"start streamed retrain (live model is "
                     f"{sig.staleness_s / 3600.0:.1f}h old, max "
                     f"staleness {cfg.max_staleness_s / 3600.0:g}h)"),
                    {"stalenessS": round(sig.staleness_s, 1),
                     "maxStalenessS": cfg.max_staleness_s,
                     "liveInstanceId": sig.live_instance_id},
                    lambda: self._start_retrain("staleness", sig),
                    sig.now))

        self._m_state.set(-1.0 if (holdoff and self._phase == "idle")
                          else float(_PHASES[self._phase]))
        with self._lock:
            last = self._last_decision
        self._m_age.set(max(0.0, sig.now - last["mono"]) if last
                        else 0.0)
        return acted

    # ------------------------------------------------------------- surface
    def summary(self) -> Dict[str, Any]:
        """The status block `pio doctor` reads (embedded mode rides
        GET / of the host daemon)."""
        cfg = self.config
        with self._lock:
            last = dict(self._last_decision) if self._last_decision \
                else None
            candidate = dict(self._last_candidate) \
                if self._last_candidate else None
            cycle = dict(self._last_cycle) if self._last_cycle else None
            sig = self._last_signals
            total, pending = self._decisions_total, self._pending_dry
            rejected = self._rejected_total
        if last is not None:
            last["ageS"] = round(
                max(0.0, time.monotonic() - last.pop("mono")), 1)
        now = time.monotonic()
        cooling = sorted(
            cls for cls, t in self._cooldowns.items()
            if now - t < cfg.cooldown_s)
        from predictionio_tpu_torch.realtime.foldin import drift_recall_floor
        return {
            "mode": "dry-run" if cfg.dry_run else "live",
            "phase": self._phase,
            "holdoff": self._holdoff,
            "retrainInFlight": self._phase in ("retraining",
                                               "validating",
                                               "publishing"),
            "cooldownS": cfg.cooldown_s,
            "cooling": cooling,
            "decisionsTotal": total,
            "pendingDryRun": pending,
            "candidatesRejected": rejected,
            "lastDecision": last,
            "lastCandidate": candidate,
            "lastCycle": cycle,
            "thresholds": {"maxStalenessS": cfg.max_staleness_s,
                           "volumeEvents": cfg.volume_events,
                           "lagEvents": cfg.lag_events,
                           "driftFloor": drift_recall_floor()},
            "signals": ({"stalenessS": (round(sig.staleness_s, 1)
                                        if sig.staleness_s is not None
                                        else None),
                         "volume": sig.volume,
                         "cursorLag": sig.cursor_lag,
                         "drift": sig.drift,
                         "itemDrift": sig.item_drift}
                        if sig is not None else None),
        }

    # ------------------------------------------------------------ lifecycle
    def run(self) -> None:
        """Loop gather -> tick until stop(); gather errors (the server
        restarting under the loop) are journaled once per streak."""
        interval = self.config.poll_ms / 1e3
        journal.emit(
            "autotrain",
            (f"autotrain online ("
             f"{'dry-run' if self.config.dry_run else 'live'}, poll "
             f"{self.config.poll_ms:g} ms, cooldown "
             f"{self.config.cooldown_s:g} s, max staleness "
             f"{self.config.max_staleness_s:g} s, volume "
             f"{self.config.volume_events} events)"),
            level=journal.INFO, dryRun=self.config.dry_run)
        failing = False
        while not self._stop.is_set():
            try:
                self.tick(self.gather())
                failing = False
            except Exception as e:
                if not failing:
                    journal.emit(
                        "autotrain",
                        f"signal gather failed ({type(e).__name__}: "
                        f"{e}); holding until the server answers",
                        level=journal.WARN)
                failing = True
                logger.debug("autotrain tick failed", exc_info=True)
            if self._stop.wait(interval):
                break

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        if self.trainer is not None:
            self.trainer.close()


def default_train_command(engine_dir: str, variant: str) -> str:
    """The retrain a standalone or router-embedded loop runs per cycle:
    the port's ``pio train`` over the engine directory and variant."""
    return (f"{shlex.quote(sys.executable)} -m "
            f"predictionio_tpu_torch.tools.cli train --engine-dir "
            f"{shlex.quote(engine_dir)} --variant {shlex.quote(variant)}")


def run_autotrain(server_url: str, engine_dir: str = ".",
                  variant: str = "engine.json", dry_run: bool = False,
                  train_cmd: str = "",
                  config: Optional[AutotrainConfig] = None) -> Autotrain:
    """CLI entry: standalone autotrain daemon over a running deploy
    server or router. Blocks until KeyboardInterrupt; returns the
    (stopped) loop."""
    from predictionio_tpu_torch.data.storage import get_storage
    from predictionio_tpu_torch.workflow.workflow_utils import (
        get_engine, read_engine_variant,
    )
    cfg = dataclasses.replace(
        (config or AutotrainConfig()), dry_run=dry_run).resolved()
    engine_dir = os.path.abspath(engine_dir)
    var = read_engine_variant(engine_dir, variant)
    engine = get_engine(var["engineFactory"], base_dir=engine_dir)
    engine_params = engine.engine_params_from_json(var)
    at = Autotrain(
        HttpServerControl(server_url), storage=get_storage(),
        engine_params=engine_params,
        trainer=SubprocessTrainer(
            train_cmd or default_train_command(engine_dir, variant)),
        config=cfg,
        engine_id=var.get("id", "default"),
        engine_variant=var.get("id", "default"))
    print(f"Autotrain {'DRY-RUN' if cfg.dry_run else 'live'} over "
          f"{server_url} (poll {cfg.poll_ms:g} ms, cooldown "
          f"{cfg.cooldown_s:g} s)", file=sys.stderr)
    try:
        at.run()
    except KeyboardInterrupt:
        pass
    finally:
        at.close()
    return at
