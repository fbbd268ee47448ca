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
  GET  /plugins.json -> plugin inventory
  GET  /plugins/<type>/<name>/... -> plugin REST handoff

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
to a server without them. A reload onto a newly trained instance rebases
the worker at that instance's training cursor
(``runtime_conf["train_cursor"]``), so the events that landed after its
training read fold on the next tick.

Continuous training (workflow/autotrain.py, ``pio deploy --autotrain``):
``attach_autotrain`` puts the loop's ``summary()`` under ``GET /`` as an
``autotrain`` block (absent until a loop is attached); its publish is the
in-place ``_reload``.

Sharded serving (``parallel/serve_dist.py``, ``ServerConfig.shard_serving``,
``PIO_SERVE_SHARD``): the load's ``prepare_serving`` runs inside the
shard-serving scope (flagged on a reload, where "auto" stays replicated),
a sharded layout sets ``pio_serve_shards`` and the ``sharding`` block of
``GET /`` and ``/debug/device.json``, and a failed one fails the load.

Partition-routed deploys (``ServerConfig.partition``,
``PIO_DEPLOY_PARTITION``, ``pio deploy --partition i/N``): the load slices
every factor model to the item rows ``partition_rows`` gives partition i
of N before anything is laid out, so B1 scores only the owned block.
``/readyz`` and ``GET /`` carry a ``partition`` block, and each answer
carries the candidates' global item indices (local row + ``lo``),
``count`` and ``nItems``, which ``pio router``'s merge reads
(workflow/router.py).

Multi-tenant deploys (``ServerConfig.tenants``, ``pio deploy --engines
conf.json``; serving/registry.py): one servable per tenant in a
``ModelRegistry``, each with its own batcher (one B1 + one B2 per flush),
admission by access key (401 unknown, 429 past ``rate``), the soft
memory budget flagged and the hard cap refused before the tenant's
layout is placed. The serve histogram, the SLO and the waterfall carry a
``tenant`` label. ``--partition`` is refused with ``--engines``.

Server plugins (workflow/server_plugins.py): output blockers rewrite each
answer in order; output sniffers then see every answered query, in order,
on one ``pio-sniffer`` thread off the serving path (their return value
and errors are ignored; ``close`` delivers what is queued). With
``ServerConfig.feedback`` each answered query is posted as a ``predict``
event to the event server.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import json
import logging
import math
import os
import queue
import random
import string
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch import knobs
from predictionio_tpu_torch.common import (
    devicewatch, history, journal, resilience, slo, telemetry, tracing,
    waterfall,
)
from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import format_event_time
from predictionio_tpu_torch.data.storage import Storage, get_storage
from predictionio_tpu_torch.ops import quant as serve_quant
from predictionio_tpu_torch.parallel import serve_dist
from predictionio_tpu_torch.realtime import foldin as foldin_mod
from predictionio_tpu_torch.serving import (
    BatcherClosed, MicroBatcher, ServerSaturated, aot, batch_capable,
    protocol,
)
from predictionio_tpu_torch.serving import registry as registry_mod
from predictionio_tpu_torch.serving.registry import (
    DEFAULT_TENANT, AdmissionError, ModelRegistry, ServableModel, TenantSpec,
)
from predictionio_tpu_torch.workflow import json_extractor, model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.server_plugins import (
    EngineServerPluginContext,
)
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
    #: post one ``predict`` event per answered query to the event server
    feedback: bool = False
    event_server_ip: str = "localhost"
    event_server_port: int = 7070
    #: the feedback events' access key (and the legacy servable's key)
    access_key: Optional[str] = None
    #: "i/N" serves only partition i of N of the item rows
    #: (parallel/serve_dist.py::partition_rows); "" the whole catalog.
    #: PIO_DEPLOY_PARTITION overrides an empty value
    partition: str = ""
    #: ``pio deploy --engines``: the tenants (serving/registry.py); empty
    #: is the single-engine server, byte-identical to one without it
    tenants: Tuple[TenantSpec, ...] = ()


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


def _train_cursor(instance) -> Optional[Any]:
    """The event-store cursor ``run_train`` took before the training read
    (``runtime_conf["train_cursor"]``, JSON-encoded). None for a row
    without one: the fold-in rebase then restarts at the tail's head."""
    raw = (getattr(instance, "runtime_conf", None) or {}).get("train_cursor")
    if not raw:
        return None
    try:
        return json.loads(raw) if isinstance(raw, str) else raw
    except ValueError:
        return None


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


def _layout_states(models, quant_requested: bool
                   ) -> Tuple[Optional[Dict[str, Any]],
                              Optional[Dict[str, Any]]]:
    """The ``sharding`` and ``quant`` blocks of a load's prepared models
    (None when that layout is off; a requested quantization the probe
    refused shows as fallen back), recorded for /debug/device.json."""
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
    return shard_state, quant_state


def _datasource_appname(engine_params) -> Optional[str]:
    """The appName of the variant's datasource params, if any."""
    dsp = getattr(engine_params, "data_source_params", None)
    app_name = getattr(dsp, "appName", None)
    return str(app_name) if app_name else None


def _partition_models(models: List[Any], index: int,
                      count: int) -> Tuple[List[Any], Dict[str, Any]]:
    """Slice every factor model (``item_factors`` and an ``item_vocab``
    BiMap) to the item rows partition ``index`` of ``count`` owns. The
    slice keeps order: global row ``g`` in [lo, hi) becomes local row
    ``g - lo``, so the replica's lowest-index tie order over those rows
    is the full model's, and the router's two-key merge reassembles the
    full answer exactly. The vocab is rebuilt over the owned rows."""
    state: Optional[Dict[str, Any]] = None
    out: List[Any] = []
    for m in models:
        fac = getattr(m, "item_factors", None)
        vocab = getattr(m, "item_vocab", None)
        if fac is None or vocab is None:
            out.append(m)
            continue
        n_items = len(vocab)
        lo, hi = serve_dist.partition_rows(n_items, index, count)
        inv = vocab.inverse()
        sliced_vocab = BiMap({inv(g): g - lo for g in range(lo, hi)})
        out.append(dataclasses.replace(
            m, item_factors=fac[lo:hi], item_vocab=sliced_vocab))
        state = {"index": index, "count": count, "lo": lo, "hi": hi,
                 "rows": hi - lo, "nItems": n_items}
    if state is None:
        raise ValueError(
            f"--partition {index}/{count} requested but no deployed model "
            "exposes item_factors + item_vocab to slice")
    return out, state


class QueryAPI:
    """Pure route handler for the engine server; the HTTP transport
    (data/api/http.py) calls :meth:`handle`."""

    def __init__(self, config: Optional[ServerConfig] = None,
                 storage: Optional[Storage] = None,
                 engine: Optional[Engine] = None,
                 plugin_context: Optional[EngineServerPluginContext] = None):
        knobs.refuse_unported(knobs.DEPLOY)
        self.config = config or ServerConfig()
        self.storage = storage or get_storage()
        self.plugin_context = plugin_context or EngineServerPluginContext()
        self._partition_spec = (self.config.partition
                                or os.environ.get("PIO_DEPLOY_PARTITION", ""))
        if self._partition_spec and self.config.tenants:
            raise ValueError(
                "--partition is a single-engine deploy scope; it does not "
                "compose with --engines multi-tenancy")
        #: partition-routed deploy: the owned item-row range advertised
        #: on /readyz and GET /; None for a full-model replica
        self._partition_state: Optional[Dict[str, Any]] = None
        #: every servable of the deploy (one under DEFAULT_TENANT for a
        #: single-engine deploy, one per tenant under --engines)
        self.registry = ModelRegistry()
        #: per-access-key admission (multi-tenant only)
        self._admission: Optional[registry_mod.AdmissionController] = None
        self._m_tenant_requests = None
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
        #: the embedded autotrain loop (``attach_autotrain``)
        self._autotrain = None
        #: the latest POST /reload's thread (close() joins it)
        self._reload_thread: Optional[threading.Thread] = None
        #: answered queries on their way to the output sniffers, and the
        #: thread that hands them over (started at the first)
        self._sniff_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._sniff_thread: Optional[threading.Thread] = None
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
        try:
            self._load()
        except BaseException:
            # a refused or failed first load retires what it started (a
            # tenant installed before the one that failed has a batcher)
            self.close()
            raise

    @property
    def degraded_count(self) -> int:
        """Responses flagged degraded (the ``GET /`` degradedCount; an
        upper bound on the queries affected when batching is on)."""
        return int(self._m_degraded_queries.value)

    # ------------------------------------------------------------- loading
    def _load(self) -> None:
        """Load (or hot-swap) every servable: the single engine, or one
        registry install per tenant under --engines."""
        with self._load_lock:
            if self.config.tenants:
                self._load_tenants()
            else:
                self._load_single()

    def _load_single(self) -> None:
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
        # the partition scope slices the owned item rows first, so the
        # fold-in padding, the layout, the warm-up and the batcher all
        # see only this replica's block of the catalog
        partition_state = None
        if self._partition_spec:
            p_index, p_count = serve_dist.parse_partition(
                self._partition_spec)
            models, partition_state = _partition_models(
                models, p_index, p_count)
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
        shard_state, quant_state = _layout_states(models, quant_requested)
        aot_state = self._warm_up(algorithms, models, foldin_prep)
        batcher = self._make_batcher(algorithms, models, serving)
        servable = ServableModel(
            name=DEFAULT_TENANT,
            spec=TenantSpec(name=DEFAULT_TENANT,
                            access_key=self.config.access_key),
            instance=instance, engine=engine, engine_params=engine_params,
            algorithms=list(algorithms), models=list(models),
            serving=serving, batcher=batcher, aot_state=aot_state,
            shard_state=shard_state, quant_state=quant_state,
            model_bytes=registry_mod.model_hbm_bytes(models))
        # the hard cap (PIO_TENANT_HBM_HARD_CAP_MB) binds a single-engine
        # deploy too; a refused reload keeps the previous generation
        try:
            self.registry.install(servable)
        except ValueError:
            if batcher is not None:
                batcher.close()
            raise
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
            self._partition_state = partition_state
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

    # -------------------------------------------------- multi-tenant loading
    def _tenant_config(self, spec: TenantSpec) -> ServerConfig:
        """One tenant's effective ServerConfig: the spec's engine pin and
        overrides over the deploy-wide values. Fold-in is off under
        multi-tenancy (the worker is a single-model speed layer)."""
        return dataclasses.replace(
            self.config,
            engine_instance_id=spec.engine_instance_id,
            engine_id=spec.engine_id,
            engine_version=spec.engine_version,
            engine_variant=spec.engine_variant,
            engine_dir=spec.engine_dir or self.config.engine_dir,
            access_key=spec.access_key,
            batching=spec.batching or self.config.batching,
            batch_max_size=(spec.batch_max_size
                            or self.config.batch_max_size),
            batch_max_delay_ms=(spec.batch_max_delay_ms
                                if spec.batch_max_delay_ms is not None
                                else self.config.batch_max_delay_ms),
            batch_max_queue=(spec.batch_max_queue
                             or self.config.batch_max_queue),
            foldin="off",
            tenants=())

    def _build_servable(self, spec: TenantSpec, *,
                        is_reload: bool) -> ServableModel:
        """One tenant's load: resolve, engine, models, the hard-cap check
        against the projected layout, prepare_serving, the warm-up and
        its own batcher. Kernel builds are process-wide (ops/_kernels.py,
        under its lock), so a second tenant's warm-up builds nothing."""
        cfg = self._tenant_config(spec)
        instance = resolve_engine_instance(self.storage, cfg)
        engine = self._engine_override or get_engine(
            instance.engine_factory, base_dir=cfg.engine_dir)
        engine_params = engine_params_from_instance(engine, instance)
        blob = self.storage.get_model_data_models().get(instance.id)
        if blob is None:
            raise ValueError(
                f"No model data for EngineInstance {instance.id}")
        models = model_io.deserialize_models(blob.models)
        _, _, algorithms, serving = engine._instantiate(engine_params)
        for a in algorithms:
            a.bind_serving(self.ctx)
        with serve_dist.deploy_scope(cfg.shard_serving, reload=is_reload,
                                     device=self.device), \
                serve_quant.deploy_scope(cfg.serve_quant,
                                         device=self.device):
            quant_requested = serve_quant.serving_enabled()
            # refuse past the hard cap BEFORE any tensor of this tenant
            # is placed on the device
            self.registry.reserve(
                spec.name, registry_mod.projected_serving_bytes(
                    models, int8=quant_requested))
            models = [a.prepare_serving(m)
                      for a, m in zip(algorithms, models)]
        shard_state, quant_state = _layout_states(models, quant_requested)
        aot_state = self._warm_up(algorithms, models, None)
        batcher = self._make_batcher(algorithms, models, serving, cfg=cfg,
                                     name=f"tenant-{spec.name}")
        return ServableModel(
            name=spec.name, spec=spec, instance=instance, engine=engine,
            engine_params=engine_params, algorithms=list(algorithms),
            models=list(models), serving=serving, batcher=batcher,
            aot_state=aot_state, shard_state=shard_state,
            quant_state=quant_state,
            model_bytes=registry_mod.model_hbm_bytes(models))

    def _load_tenants(self) -> None:
        t_load = time.perf_counter()
        is_reload = self.generation > 0
        for spec in self.config.tenants:
            servable = self._build_servable(spec, is_reload=is_reload)
            # install checks the placed bytes against the hard cap; on a
            # refused reload the tenant's previous generation keeps serving
            try:
                prior = self.registry.install(servable)
            except ValueError:
                if servable.batcher is not None:
                    servable.batcher.close()
                raise
            if prior is not None and prior.batcher is not None:
                prior.batcher.close()
            journal.emit(
                "tenant",
                (f"tenant '{spec.name}' generation "
                 f"{servable.generation} live (instance "
                 f"{servable.instance.id}, "
                 f"{servable.model_bytes / (1024 * 1024):.1f} MiB)"),
                level=journal.INFO, tenant=spec.name,
                generation=servable.generation,
                instanceId=servable.instance.id,
                modelBytes=servable.model_bytes)
        self._admission = self._build_admission()
        # the flat mirrors point at the first tenant, so the storage probe
        # and the plugins' REST handoff keep working; the multi-tenant
        # wire never reads them
        first = self.registry.get(self.config.tenants[0].name)
        with self._lock:
            self.engine_instance = first.instance
            self.engine = first.engine
            self.engine_params = first.engine_params
            self.algorithms = first.algorithms
            self.models = first.models
            self.serving = first.serving
        if self._m_tenant_requests is None:
            # registered lazily: a single-engine deploy's /metrics keeps
            # no tenant family
            self._m_tenant_requests = telemetry.registry().counter(
                "pio_tenant_requests_total",
                "Multi-tenant /queries.json requests by tenant and "
                "outcome (ok / saturated / rate_limited / denied / "
                "error)",
                labelnames=("tenant", "outcome"))
            telemetry.registry().register_collector(self.registry.collect)
        self.time_to_ready_s = time.perf_counter() - t_load
        self._m_time_to_ready.set(self.time_to_ready_s)
        self.generation += 1
        names = self.registry.names()
        logger.info("multi-tenant deploy: %d tenant(s) %s live on %s in "
                    "%.2fs", len(names), names, self.device,
                    self.time_to_ready_s)
        journal.emit(
            "lifecycle",
            (f"generation {self.generation} live (multi-tenant "
             f"{'reload hot-swap' if is_reload else 'initial deploy'}: "
             f"{len(names)} tenant(s))"),
            level=journal.INFO, generation=self.generation,
            tenants=names, reload=bool(is_reload),
            timeToReadyS=round(self.time_to_ready_s, 3))

    def _build_admission(self) -> registry_mod.AdmissionController:
        """The key -> app -> tenant map: each tenant's configured access
        key names an app (AccessKeys DAO) and every key of that app
        routes to that tenant; a spec without a key falls back to its
        datasource appName. Two tenants may not resolve to one app."""
        keys_dao = self.storage.get_meta_data_access_keys()
        apps_dao = self.storage.get_meta_data_apps()
        tenant_by_appid: Dict[int, str] = {}
        tenant_limits: Dict[str, Tuple[Optional[float],
                                       Optional[float]]] = {}
        for spec in self.config.tenants:
            tenant_limits[spec.name] = (spec.rate, spec.burst)
            appid = None
            if spec.access_key:
                row = keys_dao.get(spec.access_key)
                if row is not None:
                    appid = row.appid
            if appid is None:
                servable = self.registry.get(spec.name)
                app_name = _datasource_appname(
                    servable.engine_params if servable else None)
                if app_name:
                    app = apps_dao.get_by_name(app_name)
                    if app is not None:
                        appid = app.id
            if appid is None:
                journal.emit(
                    "tenant",
                    (f"tenant '{spec.name}' has no resolvable access "
                     "key or datasource appName; no key routes to it "
                     "until one is configured"),
                    level=journal.WARN, tenant=spec.name)
                continue
            if appid in tenant_by_appid:
                raise ValueError(
                    f"tenants '{tenant_by_appid[appid]}' and "
                    f"'{spec.name}' both resolve to app id {appid}; "
                    "per-key routing needs one app per tenant")
            tenant_by_appid[appid] = spec.name
        return registry_mod.AdmissionController(
            self.storage, tenant_by_appid, tenant_limits=tenant_limits)

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
        # state (solved against the old batch base): rebase first, at the
        # new instance's training cursor, so the events after its read
        # fold on the next tick
        inst = self.engine_instance
        if self._foldin_instance_id not in (None, inst.id):
            worker.rebase(cursor=_train_cursor(inst))
        self._foldin_instance_id = inst.id
        worker.bind(models[prep["index"]], generation=self.generation,
                    prep=prep, reload_cb=self._reload)
        worker.start()

    def _reload(self) -> None:
        """Load the latest COMPLETED instance again and swap it in; on a
        failure the previous generation keeps serving."""
        try:
            self._load()
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

    def _make_batcher(self, algorithms, models, serving,
                      cfg: Optional[ServerConfig] = None,
                      name: Optional[str] = None
                      ) -> Optional[MicroBatcher]:
        """The request micro-batcher for this load, or None. The flush
        closes over THIS load's algorithms, models and serving. A tenant
        passes its own ``cfg`` (its own queue capacity) and ``name``."""
        cfg = cfg or self.config
        mode = (cfg.batching or "auto").lower()
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

        kwargs: Dict[str, Any] = {}
        if name is not None:
            kwargs["name"] = name
        return MicroBatcher(
            flush,
            max_batch_size=cfg.batch_max_size,
            max_delay_ms=cfg.batch_max_delay_ms,
            max_queue=cfg.batch_max_queue, **kwargs)

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
        timeout = (grace_s if grace_s is not None
                   else self.config.drain_grace_s)
        for b in self._all_batchers(extra=batcher):
            b.close(timeout=timeout)
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
            sniff_thread, self._sniff_thread = self._sniff_thread, None
        for b in self._all_batchers(extra=batcher):
            b.close()
        if sniff_thread is not None:
            self._sniff_queue.put(None)
            sniff_thread.join(timeout=30)

    def _all_batchers(self, extra=None) -> List[MicroBatcher]:
        """Every live batcher, once each: the registry's per-tenant ones
        and the single-engine mirror (the default servable's)."""
        seen: Dict[int, Any] = {}
        for s in self.registry.servables():
            if s.batcher is not None:
                seen[id(s.batcher)] = s.batcher
        if extra is not None:
            seen[id(extra)] = extra
        return list(seen.values())

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
                return self._queries(body, query)
            if path == "/reload" and method == "POST":
                self.reload_async()
                return 200, {"message": "Reloading..."}
            if path == "/stop" and method == "POST":
                self._stop_requested.set()
                return 200, {"message": "Shutting down."}
            if path == "/plugins.json" and method == "GET":
                return 200, self.plugin_context.describe()
            if path.startswith("/plugins/") and method == "GET":
                return self._plugins_rest(path)
            return 404, {"message": "Not Found"}
        except Exception as e:
            logger.exception("engine server request failed: %s %s",
                             method, path)
            return 500, {"message": str(e)}

    @property
    def _multitenant(self) -> bool:
        return bool(self.config.tenants)

    def _status(self) -> Dict[str, Any]:
        if self._multitenant:
            return self._status_mt()
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
        if self._partition_state is not None:
            # only for --partition deploys: full replicas keep the key set
            out["partition"] = {"enabled": True, **self._partition_state}
        worker = self._foldin_worker
        if worker is not None:
            # only with the fold-in worker live (wire parity)
            out["foldin"] = worker.state()
        if self._autotrain is not None:
            # only with an autotrain loop attached (wire parity): the
            # block `pio doctor`'s autotrain line reads
            out["autotrain"] = self._autotrain.summary()
        return out

    def attach_autotrain(self, autotrain) -> None:
        """Embedded ``pio deploy --autotrain``: the loop's ``summary()``
        rides ``GET /``."""
        self._autotrain = autotrain

    def _status_mt(self) -> Dict[str, Any]:
        """The multi-tenant ``GET /``: per-tenant blocks and the
        generations the router's skew check reads; ``generation`` counts
        this process's loads."""
        servables = self.registry.servables()
        return {
            "status": "alive",
            "tenants": {s.name: s.state() for s in servables},
            "generations": {s.name: s.generation for s in servables},
            "generation": self.generation,
            "requestCount": self.request_count,
            "avgServingSec": self.avg_serving_sec,
            "lastServingSec": self.last_serving_sec,
            "degradedCount": self.degraded_count,
            "draining": self._draining.is_set(),
            "serverStartTime": _format_time(self.start_time),
            "modelBytesTotal": self.registry.total_model_bytes(),
            "hbmHardCapMb": self.registry.hard_cap_mb,
            "oversubscribed": self.registry.oversubscribed(),
            "device": device_mod.describe(self.device),
        }

    def _readyz(self) -> Response:
        """Ready: a model is deployed, the admission queue has room and
        the storage answers a point read. 503 while draining."""
        if self._multitenant:
            return self._readyz_mt()
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
        if self._partition_state is not None:
            # the owned range rides the probe, so the router's membership
            # poll learns the partition map with the generation
            checks["partition"] = dict(self._partition_state)
        return (200 if ready else 503), {
            "status": "ready" if ready else "unready",
            "generation": self.generation, **checks}

    def _readyz_mt(self) -> Response:
        """Multi-tenant readiness: every tenant is loaded, not every
        tenant's queue is full, and the storage answers."""
        gens = self.registry.generations()
        if self._draining.is_set():
            return 503, {"status": "draining",
                         "generation": self.generation,
                         "generations": gens}
        checks: Dict[str, Any] = {}
        servables = self.registry.servables()
        checks["modelLoaded"] = len(servables) == len(self.config.tenants)
        ready = checks["modelLoaded"]
        depths: Dict[str, int] = {}
        for s in servables:
            if s.batcher is None:
                continue
            depth = s.batcher.depth()
            depths[s.name] = depth
            cap = s.spec.batch_max_queue or self.config.batch_max_queue
            # one saturated tenant does not eject the replica for the
            # others; per-tenant shedding is the router's job
            if depth >= cap:
                checks.setdefault("saturatedTenants", []).append(s.name)
        if depths:
            checks["queueDepths"] = depths
        sat = checks.get("saturatedTenants")
        if sat and len(sat) == len(depths):
            ready = False
        try:
            instance = getattr(self, "engine_instance", None)
            if instance is not None:
                self.storage.get_meta_data_engine_instances().get(
                    instance.id)
            checks["storage"] = "ok"
        except Exception as e:
            checks["storage"] = f"{type(e).__name__}: {e}"
            ready = False
        return (200 if ready else 503), {
            "status": "ready" if ready else "unready",
            "generation": self.generation, "generations": gens, **checks}

    def _current_batcher(self, tenant: Optional[str]
                         ) -> Optional[MicroBatcher]:
        if tenant is not None:
            servable = self.registry.get(tenant)
            return servable.batcher if servable is not None else None
        with self._lock:
            return self._batcher

    def _submit(self, batcher: MicroBatcher, query,
                tenant: Optional[str] = None):
        """Submit to ``batcher``; when a reload retired it between the
        read and the submit, submit to its successor (the server's, or
        the tenant's) instead: the query then answers from the new
        generation. A flush's own error is raised as it came, never
        resubmitted; BatcherClosed is raised once the server drains or
        closes."""
        while True:
            try:
                return batcher.submit(query)
            except BatcherClosed:
                if self._draining.is_set():
                    raise
                current = self._current_batcher(tenant)
                if current is None or current is batcher:
                    raise
                batcher = current

    def _tenant_outcome(self, tenant: str, outcome: str) -> None:
        if self._m_tenant_requests is not None and telemetry.on():
            self._m_tenant_requests.labels(
                tenant=tenant, outcome=outcome).inc()

    def _queries(self, body: bytes,
                 url_query: Optional[Dict[str, str]] = None) -> Response:
        t0 = time.perf_counter()
        query_time = _utcnow()
        if self._draining.is_set():
            return 503, {"message": "server is draining"}, \
                {"Retry-After": "1"}
        tenant: Optional[str] = None
        if self._multitenant:
            # per-access-key admission (serving/registry.py): key -> app
            # -> tenant, then the key's token bucket; 401 for an unknown
            # key, 429 + Retry-After past the rate
            try:
                tenant = self._admission.admit(
                    (url_query or {}).get("accessKey"))
            except AdmissionError as e:
                self._tenant_outcome(
                    "-", "denied" if e.status == 401 else "rate_limited")
                if e.retry_after_s is not None:
                    return e.status, {"message": e.message}, \
                        {"Retry-After": str(e.retry_after_s)}
                return e.status, {"message": e.message}
            servable = self.registry.get(tenant)
            if servable is None:
                self._tenant_outcome(tenant, "error")
                return 503, {"message":
                             f"tenant '{tenant}' is not loaded"}, \
                    {"Retry-After": "1"}
            algorithms, models, serving, batcher = (
                servable.algorithms, servable.models, servable.serving,
                servable.batcher)
            instance = servable.instance
        else:
            with self._lock:
                algorithms, models, serving, batcher = (
                    self.algorithms, self.models, self.serving,
                    self._batcher)
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
        if rec is not None and tenant is not None:
            # the request's tenant rides its waterfall record
            rec.note("tenant", tenant)
        if batcher is not None:
            try:
                with waterfall.activate((rec,)):
                    prediction, degraded = self._submit(batcher, query,
                                                        tenant)
            except ServerSaturated as e:
                if tenant is not None:
                    self._tenant_outcome(tenant, "saturated")
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
        if self.config.feedback:
            result = self._feedback(instance, query, prediction, result,
                                    query_time)
        blockers = self.plugin_context.output_blockers
        sniffers = self.plugin_context.output_sniffers
        if blockers or sniffers:
            query_obj = json_extractor.to_json_obj(query)
            for blocker in blockers.values():
                result = blocker.process(instance, query_obj, result,
                                         self.plugin_context)
        if _has_non_finite(result):
            logger.error("prediction for instance %s contains non-finite "
                         "scores; refusing to serve it", instance.id)
            if tenant is not None:
                self._tenant_outcome(tenant, "error")
            return 500, {"message":
                         "prediction contains non-finite scores (the "
                         "deployed model is numerically invalid); retrain "
                         "and redeploy"}
        if (self._partition_state is not None and isinstance(result, dict)
                and isinstance(result.get("itemScores"), list)):
            # a partition replica's answer carries its candidates' GLOBAL
            # item indices (local row + lo), for the router's two-key
            # (score, lowest global index) merge
            ps = self._partition_state
            vocab = next(m.item_vocab for m in models
                         if getattr(m, "item_vocab", None) is not None)
            result = {**result, "partition": {
                **ps,
                "itemIndices": [vocab(e["item"]) + ps["lo"]
                                for e in result["itemScores"]],
            }}
        if sniffers:
            self._sniff(instance, query_obj, result)
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
                    tenant=tenant or DEFAULT_TENANT).observe(dt)
        with self._lock:
            self.last_serving_sec = dt
            self.avg_serving_sec = (
                (self.avg_serving_sec * self.request_count) + dt
            ) / (self.request_count + 1)
            self.request_count += 1
        if tenant is not None:
            self._tenant_outcome(tenant, "ok")
            # the router learns key -> tenant from this header
            return 200, result, {"X-PIO-Tenant": tenant}
        return 200, result

    def _sniff(self, instance, query_obj, result) -> None:
        """Queue an answered query for the output sniffers; they run on
        the ``pio-sniffer`` thread, so a slow sniffer holds no request."""
        with self._lock:
            if self._sniff_thread is None:
                self._sniff_thread = threading.Thread(
                    target=self._sniff_loop, args=(self._sniff_queue,),
                    name="pio-sniffer", daemon=True)
                self._sniff_thread.start()
            self._sniff_queue.put((instance, query_obj, result))

    def _sniff_loop(self, pending: "queue.SimpleQueue") -> None:
        while True:
            item = pending.get()
            if item is None:
                return
            instance, query_obj, result = item
            for sniffer in self.plugin_context.output_sniffers.values():
                try:
                    sniffer.process(instance, query_obj, result,
                                    self.plugin_context)
                except Exception:
                    logger.exception("output sniffer %s failed",
                                     sniffer.plugin_name)

    def _feedback(self, instance, query, prediction, result,
                  query_time) -> Dict[str, Any]:
        """Post the answered query as a ``predict`` event to the event
        server, on its own thread (CreateServer.scala:514-576)."""
        pr_id = getattr(prediction, "prId", "") or "".join(
            random.SystemRandom().choice(string.ascii_letters + string.digits)
            for _ in range(64))
        data = {
            "event": "predict",
            "eventTime": format_event_time(query_time),
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {
                "engineInstanceId": instance.id,
                "query": json_extractor.to_json_obj(query),
                "prediction": result,
            },
        }
        if getattr(query, "prId", None):
            data["prId"] = query.prId
        url = (f"http://{self.config.event_server_ip}:"
               f"{self.config.event_server_port}/events.json"
               f"?accessKey={self.config.access_key or ''}")

        def post():
            try:
                req = urllib.request.Request(
                    url, data=json.dumps(data).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=10) as r:
                    if r.status != 201:
                        logger.error("Feedback event failed. Status code: %s",
                                     r.status)
            except Exception as e:
                logger.error("Feedback event failed: %s", e)

        threading.Thread(target=post, name="pio-feedback",
                         daemon=True).start()
        if hasattr(prediction, "prId"):
            result = dict(result)
            result["prId"] = pr_id
        return result

    def _plugins_rest(self, path: str) -> Response:
        from predictionio_tpu_torch.common.plugin_registry import (
            dispatch_plugin_rest,
        )
        return dispatch_plugin_rest(
            self.plugin_context, path,
            lambda p, args: p.handle_rest(args))


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
