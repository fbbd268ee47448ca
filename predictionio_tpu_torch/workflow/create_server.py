"""The engine (deploy) server, single engine (port of
``predictionio_tpu/workflow/create_server.py``).

The server loads the latest COMPLETED EngineInstance's engine and model
blob, lays the model out on the deploy's device (``ServerConfig.device``,
else the device policy: the card) and answers:

  GET  /             -> status (engine instance, serving stats)
  GET  /readyz       -> readiness
  POST /queries.json -> supplement -> predict -> serve, micro-batched
  POST /reload       -> hot-swap to the latest COMPLETED instance
  POST /stop         -> shut the server down

Before its models are laid out, every algorithm is bound
(``bind_serving``) to a context that carries the server's storage, so an
engine that reads the event store at predict time (the e-commerce
template's live business rules) reads the store it was deployed from. A
side-channel lookup that fails answers without its rule and the response
carries ``"degraded": true``; ``GET /`` counts them in ``degradedCount``
(batch-granular on the batched path: a tainted flush flags every answer
in it, so the count is an upper bound on the queries affected).

Observability (``common/``): after the probes, ``telemetry.handle_route``
answers ``/metrics``, ``/traces.json``,
``/debug/{device,slow,events,history}.json`` and ``/debug/profile``, as on
every daemon; the SLO engine's burn-rate gauges ride ``/metrics``. A sampled
query (``PIO_WATERFALL=1``) records its stages: ``admission`` (the
batcher's queue wait), ``supplement``, ``dispatch`` (with ``pad`` and
``execute`` nested inside it by the algorithm), ``merge`` and
``serialize``; the flush runs in a ``dispatch`` span under the
request's trace. The deploy's load and drain are journal events.
``PIO_TELEMETRY=1`` adds ``pio_serve_seconds``. With every knob unset
the answers are byte-identical to a server without them.

Hot reload (``POST /reload``): the load runs again on a thread, lays the
new model out beside the old one, swaps it in under the lock and drains
the old batcher before it retires; each successful load bumps
``generation``. A query that raced the swap onto the retired batcher is
resubmitted to the new one, so none is dropped. A failed reload keeps
the previous generation serving and journals a WARN.

The warm-up (``serving/aot.py``, ``ServerConfig.aot``, ``PIO_AOT``): before
the deploy is ready, every bucket the batcher can flush has run once
through the serving kernels, and kernel A once per fold-in bucket, so no
kernel build, load or first launch lands behind a query or a tick.

Realtime fold-in (``realtime/foldin.py``, ``ServerConfig.foldin``,
``PIO_FOLDIN``): the load pads user and item headroom before the layout,
and one worker per server, re-bound to each generation, tails the event
store and publishes folded rows into the live model. When the headroom
runs out the worker calls ``/reload``'s load, which re-pads with room for
every folded row. A fold-in that cannot start journals a WARN and the
server serves without it. ``GET /`` carries ``aot`` and ``foldin`` blocks
only when those are live: with both off every endpoint is byte-identical
to a server without them.

Sharded serving (``parallel/serve_dist.py``, ``ServerConfig.shard_serving``,
``PIO_SERVE_SHARD``): the load's ``prepare_serving`` runs inside the
shard-serving scope (flagged on a reload, where "auto" stays replicated),
a sharded layout sets ``pio_serve_shards`` and the ``sharding`` block of
``GET /`` and ``/debug/device.json``, and a failed one fails the load.

Multi-tenancy, partitions, plugins and feedback of the JAX server arrive
in later slices.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import json
import logging
import math
import threading
import time
import urllib.request
from typing import Any, Dict, Optional, Tuple

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch import knobs
from predictionio_tpu_torch.common import (
    devicewatch, history, journal, resilience, slo, telemetry, tracing,
    waterfall,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.ops import quant as serve_quant
from predictionio_tpu_torch.parallel import serve_dist
from predictionio_tpu_torch.realtime import foldin as foldin_mod
from predictionio_tpu_torch.serving import (
    BatcherClosed, MicroBatcher, ServerSaturated, aot, batch_capable,
    protocol,
)
from predictionio_tpu_torch.workflow import json_extractor, model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.workflow_utils import get_engine

logger = logging.getLogger("predictionio_tpu_torch.server")

#: (status, payload) or (status, payload, extra_headers)
Response = Tuple[int, Any]


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=_dt.timezone.utc)


def _format_time(t: _dt.datetime) -> str:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return (t.astimezone(_dt.timezone.utc).isoformat(timespec="milliseconds")
            .replace("+00:00", "Z"))


#: per-process QueryAPI sequence: the ``server`` label of its metrics
_query_api_seq = itertools.count()


def _has_non_finite(obj) -> bool:
    if isinstance(obj, float):
        return not math.isfinite(obj)
    if isinstance(obj, dict):
        return any(_has_non_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_non_finite(v) for v in obj)
    return False


@dataclasses.dataclass
class ServerConfig:
    """CreateServer args (CreateServer.scala:77-103), the micro-batching
    knobs, and the serving layout choices the port has so far."""
    engine_instance_id: Optional[str] = None
    engine_id: str = "default"
    engine_version: str = "NOT_USED"
    engine_variant: str = "default"
    engine_dir: Optional[str] = None
    #: "cuda" or "cpu"; None = PIO_TORCH_DEVICE, else cuda (device.py)
    device: Optional[str] = None
    #: "auto" batches when an algorithm has a real predict_batch; "on"
    #: always; "off" answers one query per request inline
    batching: str = "auto"
    batch_max_size: int = 64
    batch_max_delay_ms: float = 2.0
    #: queue depth beyond which /queries.json answers 503 + Retry-After
    batch_max_queue: int = 256
    #: how long drain() waits for admitted batches to finish
    drain_grace_s: float = 30.0
    #: quantized serving (ops/quant.py): "on" int8, "off" fp32, "auto"
    #: int8 on the card when the ranking-parity probe passes;
    #: PIO_SERVE_QUANT overrides
    serve_quant: str = "auto"
    #: row-sharded serving (parallel/serve_dist.py): "on" shards over the
    #: job's devices, "off" never, "auto" on a multi-card world and not
    #: during a /reload; PIO_SERVE_SHARD overrides
    shard_serving: str = "auto"
    #: the warm-up before ready (serving/aot.py): "on" always, "off"
    #: never, "auto" on the card; PIO_AOT=0/1 overrides
    aot: str = "auto"
    #: realtime fold-in (realtime/foldin.py): "on" runs the worker in
    #: process; "off" keeps every endpoint byte-identical. PIO_FOLDIN
    #: overrides
    foldin: str = "off"
    #: fold-in tick in ms (0 = PIO_FOLDIN_TICK_MS or 250)
    foldin_tick_ms: float = 0.0
    #: user-row headroom padded for fold-in appends (0 =
    #: PIO_FOLDIN_HEADROOM or 1024)
    foldin_headroom: int = 0
    #: item-row headroom padded for unseen items (0 =
    #: PIO_FOLDIN_ITEM_HEADROOM or 1024)
    foldin_item_headroom: int = 0


def resolve_engine_instance(storage: Storage, config: ServerConfig):
    """Latest COMPLETED instance unless one is pinned."""
    instances = storage.get_meta_data_engine_instances()
    if config.engine_instance_id:
        instance = instances.get(config.engine_instance_id)
        if instance is None:
            raise ValueError(
                f"EngineInstance {config.engine_instance_id} not found")
        if instance.status != "COMPLETED":
            raise ValueError(
                f"EngineInstance {instance.id} is {instance.status}, not "
                "COMPLETED; cannot deploy")
        return instance
    instance = instances.get_latest_completed(
        config.engine_id, config.engine_version, config.engine_variant)
    if instance is None:
        raise ValueError(
            "No valid engine instance found for engine "
            f"{config.engine_id} {config.engine_version} "
            f"{config.engine_variant}. Try running `pio train` first.")
    return instance


def engine_params_from_instance(engine: Engine, instance) -> EngineParams:
    """Rebuild EngineParams from the ledger row's JSON snapshots."""
    def subtree(raw):
        obj = json.loads(raw or "{}")
        return obj if (not obj or "params" in obj) else {"params": obj}

    variant = {
        "datasource": subtree(instance.data_source_params),
        "preparator": subtree(instance.preparator_params),
        "serving": subtree(instance.serving_params),
    }
    algos = json.loads(instance.algorithms_params or "[]")
    if algos:
        variant["algorithms"] = algos
    return engine.engine_params_from_json(variant)


class QueryAPI:
    """Pure route handler for the engine server; the HTTP transport
    (data/api/http.py) calls :meth:`handle`."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 storage: Optional[Storage] = None,
                 engine: Optional[Engine] = None):
        knobs.refuse_unported(knobs.DEPLOY)
        self.config = config or ServerConfig()
        self.storage = storage or get_storage()
        self.device = device_mod.resolve(self.config.device)
        #: the context algorithms read the event store through at
        #: predict time (bind_serving)
        self.ctx = WorkflowContext(storage=self.storage, device=self.device)
        self._engine_override = engine
        self._lock = threading.Lock()
        self._stop_requested = threading.Event()
        self._draining = threading.Event()
        self._batcher: Optional[MicroBatcher] = None
        self._quant_state: Optional[Dict[str, Any]] = None
        self._shard_state: Optional[Dict[str, Any]] = None
        self._aot_state: Optional[Dict[str, Any]] = None
        #: the realtime fold-in worker: one per server, re-bound to each
        #: model generation by the load
        self._foldin_worker = None
        self._foldin_instance_id: Optional[str] = None
        #: the latest POST /reload's thread (close() joins it)
        self._reload_thread: Optional[threading.Thread] = None
        #: one load at a time: /reload and the fold-in fallback share it
        self._load_lock = threading.Lock()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.start_time = _utcnow()
        self.generation = 0
        #: wall-clock from load start to servable (blob read, quantize,
        #: device layout)
        self.time_to_ready_s: Optional[float] = None
        # device observability: kernel-build watchdog + HBM gauges on
        # this daemon's /metrics and /debug/device.json (idempotent)
        devicewatch.install()
        # SLO engine (targets from PIO_SLO_*): the query server's
        # install reconfigures one a sibling daemon in the process made
        slo.install(slo.SLOConfig.from_env())
        # metrics flight recorder: bounded time-series rings behind
        # /debug/history.json (one sampler thread per process)
        history.install()
        # degraded accounting and time to ready are registry-backed (one
        # source for GET / and GET /metrics), labeled per instance so a
        # fresh server starts at zero. Two degraded counts, because the
        # batched path's flag is batch-granular: a failed side-channel
        # lookup taints every answer of its flush, so the per-answer
        # count is an upper bound; pio_degraded_batches_total counts the
        # tainted flushes
        inst = {"server": f"query#{next(_query_api_seq)}"}
        reg = telemetry.registry()
        self._m_time_to_ready = reg.gauge(
            "pio_time_to_ready_seconds",
            "Deploy wall-clock until servable: model load + device "
            "placement",
            labelnames=("server",)).labels(**inst)
        self._m_degraded_queries = reg.counter(
            "pio_degraded_queries_upper_bound",
            "Responses flagged degraded; batch-granular taint makes this "
            "an UPPER BOUND on truly affected queries",
            labelnames=("server",)).labels(**inst)
        self._m_degraded_batches = reg.counter(
            "pio_degraded_batches_total",
            "Batched flushes tainted by a failed side-channel lookup "
            "(each taints up to batch_max_size responses)",
            labelnames=("server",)).labels(**inst)
        self._load_single()

    @property
    def degraded_count(self) -> int:
        """Responses flagged degraded (the ``GET /`` degradedCount; an
        upper bound on the queries affected when batching is on)."""
        return int(self._m_degraded_queries.value)

    # ------------------------------------------------------------- loading
    def _load_single(self) -> None:
        with self._load_lock:
            self._load_locked()

    def _load_locked(self) -> None:
        t_load = time.perf_counter()
        instance = resolve_engine_instance(self.storage, self.config)
        engine = self._engine_override or get_engine(
            instance.engine_factory, base_dir=self.config.engine_dir)
        engine_params = engine_params_from_instance(engine, instance)
        blob = self.storage.get_model_data_models().get(instance.id)
        if blob is None:
            raise ValueError(f"No model data for EngineInstance {instance.id}")
        models = model_io.deserialize_models(blob.models)
        _, _, algorithms, serving = engine._instantiate(engine_params)
        for a in algorithms:
            a.bind_serving(self.ctx)
        # fold-in headroom goes in BEFORE the layout, so every layout
        # holds the rows new users and items fold into; a reload re-pads
        # with the worker's hints, so the fallback always lands with room
        foldin_on = foldin_mod.enabled(self.config.foldin)
        foldin_prep = None
        if foldin_on:
            headroom = (self.config.foldin_headroom
                        or foldin_mod.default_headroom())
            item_headroom = (self.config.foldin_item_headroom
                             or foldin_mod.default_item_headroom())
            worker = self._foldin_worker
            if worker is not None:
                headroom = max(headroom, worker.headroom_hint())
                item_headroom = max(item_headroom,
                                    worker.item_headroom_hint())
            foldin_prep = foldin_mod.pad_capacity(
                models, headroom, algorithms, item_headroom=item_headroom)
        # the shard-serving and serve-quant scopes: prepare_serving
        # resolves the deploy's modes inside them. A reload is flagged so
        # sharding's "auto" stays replicated while the swap holds both
        # models ("on" stays sharded: the operator's explicit call)
        is_reload = getattr(self, "engine_instance", None) is not None
        with serve_dist.deploy_scope(self.config.shard_serving,
                                     reload=is_reload, device=self.device), \
                serve_quant.deploy_scope(self.config.serve_quant,
                                         device=self.device):
            models = [a.prepare_serving(m)
                      for a, m in zip(algorithms, models)]
            quant_requested = serve_quant.serving_enabled()
        shard_state = next(
            (m.sharding.summary() for m in models
             if getattr(m, "sharding", None) is not None), None)
        serve_dist.record_state(shard_state)
        quant_state = next(
            ({"enabled": True, **m.quant.summary()} for m in models
             if getattr(m, "quant", None) is not None), None)
        if quant_state is None:
            quant_state = next(
                ({"enabled": True, "sharded": True,
                  **m.sharding.quant_summary()} for m in models
                 if getattr(m, "sharding", None) is not None
                 and m.sharding.dtype == "int8"), None)
        if quant_state is None and quant_requested:
            quant_state = {"enabled": False, "fellBack": True}
        serve_quant.record_state(quant_state)
        aot_state = self._warm_up(algorithms, models, foldin_prep)
        batcher = self._make_batcher(algorithms, models, serving)
        with self._lock:
            self.engine_instance = instance
            self.engine = engine
            self.engine_params = engine_params
            self.algorithms = algorithms
            self.models = models
            self.serving = serving
            self._quant_state = quant_state
            self._shard_state = shard_state
            self._aot_state = aot_state
            old_batcher, self._batcher = self._batcher, batcher
        if old_batcher is not None:   # reload: drain in-flight, then retire
            old_batcher.close()
        self.time_to_ready_s = time.perf_counter() - t_load
        self._m_time_to_ready.set(self.time_to_ready_s)
        self.generation += 1
        logger.info("Engine instance %s deployed on %s (%d algorithm(s), "
                    "batching %s, warm-up %s) in %.2fs", instance.id,
                    self.device, len(algorithms),
                    "on" if batcher is not None else "off",
                    "on" if aot_state is not None else "off",
                    self.time_to_ready_s)
        journal.emit(
            "lifecycle",
            (f"model generation {self.generation} live "
             f"({'reload hot-swap' if is_reload else 'initial deploy'}: "
             f"instance {instance.id})"),
            level=journal.INFO,
            generation=self.generation, instanceId=instance.id,
            reload=bool(is_reload),
            timeToReadyS=round(self.time_to_ready_s, 3))
        if foldin_on and foldin_prep is not None:
            self._install_foldin(engine_params, models, foldin_prep)
        elif foldin_on:
            journal.emit(
                "foldin", "fold-in requested but no model is fold-in-"
                "shaped (user/item factor matrices + vocabs); worker "
                "not started", level=journal.WARN)

    def _warm_up(self, algorithms, models, foldin_prep
                 ) -> Optional[Dict[str, Any]]:
        """The warm-up before ready (serving/aot.py), or None when the
        deploy's mode leaves it off: every bucket's serving call and,
        with fold-in, kernel A at every fold-in bucket, run once."""
        if not aot.enabled(self.config.aot, self.device):
            devicewatch.note_aot(None)
            return None
        buckets = aot.serve_buckets(self.config.batch_max_size)
        programs = []
        for a, m in zip(algorithms, models):
            programs.extend(aot.algorithm_programs(a, m, buckets))
        if foldin_prep is not None:
            rank = int(foldin_prep["item_factors"].shape[1])
            programs.extend(foldin_mod.solve_programs(
                rank, self.device, foldin_prep["reg_scaling"]))
        state = {"enabled": True, "buckets": list(buckets),
                 **aot.prebuild(programs, self.device)}
        devicewatch.note_aot(state)
        return state

    def _install_foldin(self, engine_params, models, prep) -> None:
        """Create (first load) or re-bind (reload) the fold-in worker
        against the freshly swapped generation. An engine without an app
        name, a store without an incremental tail or a missing app
        journals a WARN and the server serves without fold-in."""
        worker = self._foldin_worker
        if worker is None:
            cfg = foldin_mod.config_for(
                engine_params, tick_ms=self.config.foldin_tick_ms,
                headroom=self.config.foldin_headroom or None,
                item_headroom=self.config.foldin_item_headroom or None)
            if cfg is None:
                journal.emit(
                    "foldin", "fold-in requested but the engine has no "
                    "datasource appName to tail; worker not started",
                    level=journal.WARN)
                return
            if prep.get("lambda_") is not None:
                cfg.lambda_ = prep["lambda_"]
            try:
                worker = foldin_mod.FoldinWorker(self.storage, cfg,
                                                 device=self.device)
            except ValueError as e:
                journal.emit(
                    "foldin", f"fold-in worker failed to start: {e}",
                    level=journal.WARN, error=str(e))
                return
            if not worker.supported:
                journal.emit(
                    "foldin", "fold-in requested but this event-store "
                    "backend exposes no incremental tail; worker not "
                    "started", level=journal.WARN)
                return
            self._foldin_worker = worker
        # a reload onto a NEW trained instance invalidates the folded
        # state (solved against the old batch base): rebase first
        inst = self.engine_instance
        if self._foldin_instance_id not in (None, inst.id):
            worker.rebase()
        self._foldin_instance_id = inst.id
        worker.bind(models[prep["index"]], generation=self.generation,
                    prep=prep, reload_cb=self._reload)
        worker.start()

    def _reload(self) -> None:
        """Load the latest COMPLETED instance again and swap it in; on a
        failure the previous generation keeps serving."""
        try:
            self._load_single()
        except Exception as e:
            logger.exception("reload failed; keeping previous engine")
            journal.emit(
                "lifecycle",
                f"reload FAILED; generation {self.generation} keeps "
                "serving",
                level=journal.WARN, generation=self.generation,
                error=f"{type(e).__name__}: {e}")

    def reload_async(self) -> threading.Thread:
        """``POST /reload``: the load on its own thread (returned, and
        joined by :meth:`close`). The thread runs under the request's
        trace context, so a ``remote`` source's reads join the
        ``/reload`` trace across the storage server."""
        ctx = tracing.current()

        def run():
            with tracing.activate(ctx):
                self._reload()

        t = threading.Thread(target=run, name="pio-reload", daemon=True)
        self._reload_thread = t
        t.start()
        return t

    def _make_batcher(self, algorithms, models, serving
                      ) -> Optional[MicroBatcher]:
        """The request micro-batcher for this load, or None. The flush
        closes over THIS load's algorithms, models and serving."""
        mode = (self.config.batching or "auto").lower()
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"ServerConfig.batching must be auto/on/off, got {mode!r}")
        if mode == "off":
            return None
        if mode == "auto" and not any(batch_capable(a) for a in algorithms):
            return None

        def flush(queries):
            # a failed side-channel lookup anywhere in the flush taints
            # every answer of it: predict_batch does not say which query
            resilience.reset_degraded()
            with waterfall.stage("supplement"):
                supplemented = [serving.supplement(q) for q in queries]
            # the batched dispatch ends in the .cpu() copy of the top-k;
            # the algorithm refines `dispatch` with nested pad/execute
            with tracing.span("dispatch", service="query-server"):
                with waterfall.stage("dispatch"):
                    per_algo = [protocol.predict_batch(a, m, supplemented)
                                for a, m in zip(algorithms, models)]
            with waterfall.stage("merge"):
                served = [serving.serve(q, [col[j] for col in per_algo])
                          for j, q in enumerate(queries)]
            degraded = bool(resilience.pop_degraded())
            if degraded:
                # ONE tainted flush, up to len(queries) flagged responses
                self._m_degraded_batches.inc()
            return [(p, degraded) for p in served]

        return MicroBatcher(
            flush,
            max_batch_size=self.config.batch_max_size,
            max_delay_ms=self.config.batch_max_delay_ms,
            max_queue=self.config.batch_max_queue)

    # ----------------------------------------------------------- lifecycle
    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Graceful shutdown: stop admitting queries, let the batcher
        finish every admitted batch, then request stop."""
        if self._draining.is_set():
            return
        self._draining.set()
        journal.emit("lifecycle", "drain begin: stopped admitting "
                     "queries; flushing admitted batches",
                     level=journal.INFO, generation=self.generation)
        t0 = time.perf_counter()
        worker = self._foldin_worker
        if worker is not None:
            # the speed layer stops BEFORE the batcher drains: no new
            # publication races the final flushes
            worker.stop()
        with self._lock:
            batcher = self._batcher
        if batcher is not None:
            batcher.close(timeout=(grace_s if grace_s is not None
                                   else self.config.drain_grace_s))
        self._stop_requested.set()
        journal.emit("lifecycle", "drain complete: every admitted "
                     "in-flight request answered",
                     level=journal.INFO, generation=self.generation,
                     drainS=round(time.perf_counter() - t0, 3))

    def close(self) -> None:
        """Stop the fold-in worker, finish a reload in flight and retire
        the batcher (server shutdown)."""
        worker = self._foldin_worker
        if worker is not None:
            worker.stop()
        t = self._reload_thread
        if t is not None and t is not threading.current_thread():
            t.join()
        with self._lock:
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.close()

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
            if t is not None:    # /metrics, /traces.json, /debug/*
                return t
            if path == "/queries.json" and method == "POST":
                return self._queries(body)
            if path == "/reload" and method == "POST":
                self.reload_async()
                return 200, {"message": "Reloading..."}
            if path == "/stop" and method == "POST":
                self._stop_requested.set()
                return 200, {"message": "Shutting down."}
            return 404, {"message": "Not Found"}
        except Exception as e:
            logger.exception("engine server request failed: %s %s",
                             method, path)
            return 500, {"message": str(e)}

    def _status(self) -> Dict[str, Any]:
        i = self.engine_instance
        out = {
            "status": "alive",
            "engineInstance": {
                "id": i.id,
                "engineFactory": i.engine_factory,
                "startTime": _format_time(i.start_time),
                "batch": i.batch,
            },
            "algorithms": [type(a).__name__ for a in self.algorithms],
            "requestCount": self.request_count,
            "avgServingSec": self.avg_serving_sec,
            "lastServingSec": self.last_serving_sec,
            "degradedCount": self.degraded_count,
            "draining": self._draining.is_set(),
            "serverStartTime": _format_time(self.start_time),
            "generation": self.generation,
            "device": device_mod.describe(self.device),
        }
        batcher = self._batcher
        out["batching"] = ({"enabled": True, **batcher.stats()}
                           if batcher is not None else {"enabled": False})
        if self._aot_state is not None:
            # only with the warm-up on: an "off" deploy keeps the key set
            out["aot"] = {**self._aot_state,
                          "timeToReadyS": (round(self.time_to_ready_s, 3)
                                           if self.time_to_ready_s
                                           is not None else None)}
        if self._shard_state is not None:
            # only when sharded serving is live: replicated deploys keep
            # the key set
            out["sharding"] = {"enabled": True, **self._shard_state}
        if self._quant_state is not None:
            out["quant"] = self._quant_state
        worker = self._foldin_worker
        if worker is not None:
            # only with the fold-in worker live (wire parity)
            out["foldin"] = worker.state()
        return out

    def _readyz(self) -> Response:
        """Ready: a model is deployed, the admission queue has room and
        the storage answers a point read. 503 while draining."""
        if self._draining.is_set():
            return 503, {"status": "draining",
                         "generation": self.generation}
        with self._lock:
            instance = getattr(self, "engine_instance", None)
            batcher = self._batcher
        checks: Dict[str, Any] = {"modelLoaded": instance is not None}
        ready = checks["modelLoaded"]
        aot_state = self._aot_state
        if aot_state is not None:
            # informational: the warm-up ran inside the load, so by the
            # time this route answers, the serving calls have run
            checks["aotPrograms"] = aot_state.get("programs", 0)
        if batcher is not None:
            depth = batcher.depth()
            checks["queueDepth"] = depth
            ready &= depth < self.config.batch_max_queue
        try:
            # one cheap metadata point-read, as the reference probes
            if instance is not None:
                self.storage.get_meta_data_engine_instances().get(
                    instance.id)
            checks["storage"] = "ok"
        except Exception as e:
            checks["storage"] = f"{type(e).__name__}: {e}"
            ready = False
        return (200 if ready else 503), {
            "status": "ready" if ready else "unready",
            "generation": self.generation, **checks}

    def _submit(self, batcher: MicroBatcher, query):
        """Submit to ``batcher``; when a reload retired it between the
        read and the submit, submit to its successor instead (the query
        then answers from the new generation). A flush's own error is
        raised as it came, never resubmitted; BatcherClosed is raised
        once the server drains or closes."""
        while True:
            try:
                return batcher.submit(query)
            except BatcherClosed:
                if self._draining.is_set():
                    raise
                with self._lock:
                    current = self._batcher
                if current is None or current is batcher:
                    raise
                batcher = current

    def _queries(self, body: bytes) -> Response:
        t0 = time.perf_counter()
        if self._draining.is_set():
            return 503, {"message": "server is draining"}, \
                {"Retry-After": "1"}
        with self._lock:
            algorithms, models, serving, batcher = (
                self.algorithms, self.models, self.serving, self._batcher)
            instance = self.engine_instance
        try:
            query = json_extractor.extract_query(
                getattr(algorithms[0], "query_class", None), body)
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"message": str(e)}
        # latency waterfall (PIO_WATERFALL=1): this request's stage
        # breakdown; rec is None when sampling is off and every waterfall
        # call below is a cheap no-op
        rec = waterfall.begin("batched" if batcher is not None
                              else "inline")
        if batcher is not None:
            try:
                with waterfall.activate((rec,)):
                    prediction, degraded = self._submit(batcher, query)
            except ServerSaturated as e:
                return 503, {"message": (
                    "serving queue is saturated (admission control); "
                    "retry later")}, {"Retry-After": str(e.retry_after_s)}
            except RuntimeError:
                # lost the race with drain()/close()
                return 503, {"message": "server is draining"}, \
                    {"Retry-After": "1"}
        else:
            resilience.reset_degraded()
            with devicewatch.serving_region("serve_inline",
                                            signature="inline"):
                with waterfall.activate((rec,)):
                    with waterfall.stage("supplement"):
                        supplemented = serving.supplement(query)
                    with waterfall.stage("dispatch"):
                        predictions = [a.predict(m, supplemented)
                                       for a, m in zip(algorithms, models)]
                    with waterfall.stage("merge"):
                        prediction = serving.serve(query, predictions)
            degraded = bool(resilience.pop_degraded())
            devicewatch.note_serving_flush()
        with waterfall.activate((rec,)):
            with waterfall.stage("serialize"):
                result = json_extractor.to_json_obj(prediction)
        if degraded:
            self._m_degraded_queries.inc()
            # a degraded answer is a trace worth keeping
            tracing.pin_current("degraded")
            if batcher is None:
                # inline path: a degraded query IS a degraded "batch" of 1
                self._m_degraded_batches.inc()
            if isinstance(result, dict):
                result = {**result, "degraded": True}
        if _has_non_finite(result):
            logger.error("prediction for instance %s contains non-finite "
                         "scores; refusing to serve it", instance.id)
            return 500, {"message":
                         "prediction contains non-finite scores (the "
                         "deployed model is numerically invalid); retrain "
                         "and redeploy"}
        dt = time.perf_counter() - t0
        waterfall.end(rec)   # close the breakdown; offer to /debug/slow.json
        if telemetry.on():
            # end-to-end serve latency (parse -> predict -> serialize);
            # the predict path ends in the .cpu() copy of its result
            telemetry.registry().histogram(
                "pio_serve_seconds",
                "POST /queries.json end-to-end serve latency",
                labelnames=("mode", "tenant")).labels(
                    mode="batched" if batcher is not None else "inline",
                    tenant="default").observe(dt)
        with self._lock:
            self.last_serving_sec = dt
            self.avg_serving_sec = (
                (self.avg_serving_sec * self.request_count) + dt
            ) / (self.request_count + 1)
            self.request_count += 1
        return 200, result


def undeploy(ip: str, port: int) -> bool:
    """POST /stop to a running engine server (commands/Engine.scala:240+)."""
    try:
        req = urllib.request.Request(
            f"http://{ip}:{port}/stop", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status == 200
    except Exception:
        return False


def serve(api: QueryAPI, host: str = "localhost", port: int = 8000,
          bind_retries: int = 3) -> None:
    """Run until /stop or SIGTERM. SIGTERM drains: new queries get 503,
    the batcher finishes every admitted batch, then the server exits."""
    from predictionio_tpu_torch.data.api.http import (
        install_sigterm_handler, make_server,
    )
    server = None
    for attempt in range(bind_retries):
        try:
            server = make_server(api, host, port)
            break
        except OSError:
            if attempt == bind_retries - 1:
                raise
            logger.warning("Bind failed; retrying in 1s...")
            time.sleep(1)
    install_sigterm_handler(api.drain)
    worker = threading.Thread(target=server.serve_forever, daemon=True)
    worker.start()
    logger.info("Engine server online at http://%s:%s", host, port)
    try:
        while not api.stop_requested:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    server.shutdown()
    server.server_close()
    worker.join()
    api.close()
