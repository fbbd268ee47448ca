"""The reference's environment variables, as the port treats each one.

Every name that ``predictionio_tpu/common/declarations.py::ENV_VARS``
declares has a row here (the port keeps its own table and imports nothing
of the JAX package), in one of three kinds:

- ``READ``: the port reads it, with the reference's meaning;
- ``INERT``: it tunes something the port has no use for (a TPU layout,
  the XLA compile cache) or tunes a feature that another row refuses, so
  setting it changes nothing a user of the port could see;
- ``UNPORTED``: it turns on a feature the port lacks. :func:`refuse_unported`
  raises ``ValueError`` at the entry points (the CLI's ``train``,
  ``eval``, ``deploy``, ``eventserver``, ``import``, ``export``,
  ``dashboard``, ``adminserver``, ``storageserver`` and ``foldin``,
  ``run_train``, ``run_evaluation`` and ``QueryAPI``) when such a variable is set to a value that turns the
  feature on, naming the variable, the feature and the ROADMAP item that
  brings it. Unset, ``0``
  and ``off`` stay accepted. A row's refusal goes when its slice lands.

Of the 118 rows, 107 are read, 10 inert and one refused
(``PIO_SERVE_DEVICE_MS``).

``PIO_TORCH_DEVICE`` and ``PIO_TORCH_KERNEL_DIR`` are the port's own and
have no row.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

READ = "read"
INERT = "inert"
UNPORTED = "unported"

TRAIN, EVAL, DEPLOY = "train", "eval", "deploy"
EVENTSERVER, IMPORT, EXPORT = "eventserver", "import", "export"
DASHBOARD, ADMINSERVER, FOLDIN = "dashboard", "adminserver", "foldin"
STORAGESERVER = "storageserver"
#: the verbs that serve HTTP (``pio router`` too, which refuses nothing)
DAEMONS = (DEPLOY, EVENTSERVER, DASHBOARD, ADMINSERVER, STORAGESERVER)
ALL_VERBS = (TRAIN, EVAL, DEPLOY, EVENTSERVER, IMPORT, EXPORT, DASHBOARD,
             ADMINSERVER, STORAGESERVER, FOLDIN)


@dataclass(frozen=True)
class Knob:
    kind: str
    #: READ / INERT: what the port does with it; UNPORTED: the feature
    what: str
    #: UNPORTED: the entry points that refuse it
    verbs: Tuple[str, ...] = ()
    #: UNPORTED: the ROADMAP item that brings the feature
    roadmap: str = ""
    #: UNPORTED: values besides unset, 0 and off that leave the feature off
    also_off: Tuple[str, ...] = ()


def _read(what: str) -> Knob:
    return Knob(READ, what)


def _inert(what: str) -> Knob:
    return Knob(INERT, what)


def _unported(what: str, roadmap: str, verbs=(DEPLOY,),
              also_off: Tuple[str, ...] = ()) -> Knob:
    return Knob(UNPORTED, what, tuple(verbs), roadmap, also_off)


_RPC = "the remote storage client's retry policy (common/resilience.py)"
_BREAKER = "the remote storage client's circuit breaker"
_TLS = "TLS on the HTTP daemons (common/server_security.py)"
_GRAM = ("TPU layout tuning of the hybrid Gram; the port runs one Gram for "
         "every PIO_ALS_KERNEL")
_Q5B = "queue 1 item 5b (the host-vs-device serving probe)"
_ROUTER = "pio router (workflow/router.py)"
_TENANTS = "multi-tenant deploys (serving/registry.py)"

KNOBS: Dict[str, Knob] = {
    # storage
    "PIO_FS_BASEDIR": _read("base directory of the zero-config stores"),
    "PIO_STORAGE_SOURCES_*": _read(
        "storage sources; an unported TYPE is refused by the storage layer"),
    "PIO_STORAGE_REPOSITORIES_*": _read("repository bindings"),
    "PIO_STORAGE_SERVER_KEY": _read(
        "the storage server's shared key (X-PIO-Storage-Key)"),
    "PIO_SERVER_KEY": _read(
        "the shared key of the dashboard and admin daemons"),
    "PIO_SSL_CERTFILE": _read(_TLS + ": the PEM certificate"),
    "PIO_SSL_KEYFILE": _read(_TLS + ": the PEM key"),
    "PIO_EVENTLOG_CACHE_MB": _read(
        "the eventlog store's chunk-column cache budget"),
    "PIO_WAL_GROUP_MS": _read("the eventlog WAL's group-commit window"),
    "PIO_WAL_FSYNC": _read("the eventlog WAL's fsync mode"),
    # transport and event server
    "PIO_TRANSPORT": _read(
        "the HTTP transport of every daemon and the router: threaded or "
        "async (data/api/http.py)"),
    "PIO_TRANSPORT_WORKERS": _read("the async transport's handler threads"),
    "PIO_TRANSPORT_PIPELINE": _read(
        "the async transport's pipelined requests per connection"),
    "PIO_BATCH_EVENTS_MAX": _read(
        "the event server's cap on items per batch request"),
    "PIO_BATCH_BULK_INSERT": _read(
        "the event server's batch store: one insert_batch, or per item"),
    # the training read
    "PIO_DISABLE_NATIVE": _inert(
        "the reference's native counting sort; the port sorts with torch"),
    "PIO_READ_THREADS": _read("the eventlog bulk read's decode workers"),
    "PIO_READ_OVERLAP": _read(
        "the streamed read (chunk decode overlapping the encode)"),
    "PIO_READ_STAGE": _read(
        "device staging of the read's chunks (ops/staging.py)"),
    "PIO_TRAIN_STREAM": _read(
        "the streamed (out-of-core) training read: auto / on / off"),
    "PIO_SYNTHETIC_EVENTS": _read("pio train --synthetic N"),
    "PIO_SYNTHETIC_SEED": _read("the synthetic generator's seed"),
    # ALS
    "PIO_ALS_KERNEL": _read("hybrid / csrb / scan, one Gram for all three"),
    "PIO_ALS_SOLVER": _inert(
        "settled: kernel A runs on the card for either value"),
    "PIO_ALS_HOT_K": _inert(_GRAM),
    "PIO_ALS_DENSE_MIN_COUNT": _inert(_GRAM),
    "PIO_ALS_XPAD": _inert(_GRAM),
    "PIO_ALS_LAYOUT_CACHE": _read(
        "the process-wide fingerprinted layout cache (0 disables it)"),
    "PIO_ALS_BIG_LAYOUT_MIN": _read(
        "the rating count above which a layout goes to the process-wide "
        "cache"),
    "PIO_NNZ_BUCKETING": _read("bucketed nnz padding"),
    "PIO_FINITE_CHECK": _read("the post-train non-finite check"),
    # serving
    "PIO_SERVE_BUCKETS": _read("the serving buckets"),
    "PIO_SERVE_DEVICE_MS": _unported(
        "the inline single-query device path and its host-vs-device "
        "latency probe", _Q5B),
    "PIO_SERVE_SHARD": _read(
        "row-sharded serving (parallel/serve_dist.py): auto / on / off"),
    "PIO_SERVE_QUANT": _read("quantized serving"),
    "PIO_SERVE_QUANT_RECALL_MIN": _read("the recall probe's floor"),
    "PIO_SERVE_FUSED": _read("the fused top-k kernel"),
    "PIO_SERVE_FUSED_TILE": _read("the fused top-k kernel's tile"),
    "PIO_SERVE_WARMUP_FLUSHES": _read(
        "the serving flushes before devicewatch's post-warmup alarm arms"),
    # fold-in
    "PIO_FOLDIN": _read("the realtime fold-in speed layer (0 / 1)"),
    "PIO_FOLDIN_TICK_MS": _read("the fold-in tick"),
    "PIO_FOLDIN_HEADROOM": _read("the user rows padded for fold-in"),
    "PIO_FOLDIN_MAX_EVENTS": _read("the fold-in history cap per row"),
    "PIO_FOLDIN_USER_BUCKETS": _read("the fold-in solve's buckets"),
    "PIO_FOLDIN_CURSOR_DIR": _read("where fold-in cursors persist"),
    "PIO_FOLDIN_DRIFT_EVERY": _read("ticks between drift probes"),
    "PIO_FOLDIN_DRIFT_RECALL_MIN": _read("the drift probes' floor"),
    "PIO_FOLDIN_ITEM_HEADROOM": _read("the item rows padded for fold-in"),
    # the warm-up before ready and the compile cache
    "PIO_AOT": _read("the warm-up before /readyz (0 / 1)"),
    "PIO_AOT_KS": _inert(
        "the warm-up's k set; k selects no kernel instantiation, so the "
        "warm-up runs one k"),
    "PIO_AOT_PRUNE": _inert(
        "the warm-up's bucket pruning; a bucket changes only a launch's "
        "grid, so every bucket is warmed"),
    "PIO_AOT_THREADS": _inert(
        "the reference's prebuild pool; the warm-up's launches run in "
        "order on one stream"),
    "PIO_COMPILE_CACHE_DIR": _inert(
        "the XLA compile cache; the port's kernels build once into "
        "PIO_TORCH_KERNEL_DIR"),
    "PIO_COMPILE_CACHE_MIN_S": _inert("the XLA compile cache"),
    # router and tenants
    "PIO_ROUTER_HEALTH_MS": _read(_ROUTER + ": the membership poll"),
    "PIO_ROUTER_DEADLINE_MS": _read(_ROUTER + ": the per-query deadline"),
    "PIO_ROUTER_MAX_INFLIGHT": _read(_ROUTER + ": the admission ceiling"),
    "PIO_ROUTER_TENANT_MAX_INFLIGHT": _read(
        _ROUTER + ": the per-tenant admission ceiling"),
    "PIO_ROUTER_CACHE": _read(_ROUTER + ": the response cache (on / off)"),
    "PIO_ROUTER_CACHE_MB": _read(_ROUTER + ": the response cache's budget"),
    "PIO_ROUTER_CACHE_TTL_MS": _read(
        _ROUTER + ": the response cache's entry lifetime"),
    "PIO_DEPLOY_PARTITION": _read(
        "the partition-routed deploy scope i/N (pio deploy --partition)"),
    "PIO_TENANT_RATE": _read(_TENANTS + ": the per-access-key rate"),
    "PIO_TENANT_BURST": _read(_TENANTS + ": the per-access-key burst"),
    "PIO_TENANT_HBM_BUDGET_MB": _read(
        _TENANTS + ": the per-tenant soft memory budget"),
    "PIO_TENANT_HBM_HARD_CAP_MB": _read(
        _TENANTS + ": the memory hard cap, checked before placement"),
    # remote storage resilience
    "PIO_RPC_RETRIES": _read(_RPC + ": retries after the first try"),
    "PIO_RPC_BACKOFF_MS": _read(_RPC + ": the full-jitter backoff's base"),
    "PIO_RPC_BACKOFF_MAX_MS": _read(_RPC + ": the backoff's cap"),
    "PIO_RPC_DEADLINE_MS": _read(
        _RPC + ": the deadline across attempts, propagated per attempt"),
    "PIO_RPC_WRITE_DEDUP": _read(
        "the remote client's exactly-once insert_batch retry"),
    "PIO_RPC_POOL": _read("the remote client's idle connections kept"),
    "PIO_BREAKER_ENABLED": _read(_BREAKER + " (0 / 1)"),
    "PIO_BREAKER_WINDOW_S": _read(_BREAKER + ": its error-rate window"),
    "PIO_BREAKER_ERROR_RATE": _read(_BREAKER + ": the rate that opens it"),
    "PIO_BREAKER_MIN_CALLS": _read(
        _BREAKER + ": the calls in the window before it may open"),
    "PIO_BREAKER_OPEN_S": _read(_BREAKER + ": how long it stays open"),
    "PIO_FAULT_SPEC": _read(
        "fault injection at the transport boundary (common/resilience.py)"),
    "PIO_FAULT_SEED": _read("seeds PIO_FAULT_SPEC's decisions"),
    "PIO_AUTO_RESUME": _read("auto-resume of a crashed pio train"),
    # observability
    "PIO_TELEMETRY": _read("hot-path metrics (common/telemetry.py)"),
    "PIO_TRACE": _read("originating per-request traces (common/tracing.py)"),
    "PIO_TRACE_BUFFER": _read("the span ring's capacity"),
    "PIO_TRACE_TAIL_MS": _read("the span duration that pins its trace"),
    "PIO_TRACE_TAIL_TRACES": _read("the tail ring's capacity in traces"),
    "PIO_JOURNAL": _read(
        "the operational-event journal (common/journal.py; on unless 0)"),
    "PIO_JOURNAL_BUFFER": _read("the journal's capacity"),
    "PIO_HISTORY": _read(
        "the metrics flight recorder (common/history.py; on unless 0)"),
    "PIO_HISTORY_TICK_S": _read("the flight recorder's sampling tick"),
    "PIO_HISTORY_MAX_SERIES": _read("the flight recorder's series cap"),
    "PIO_WATERFALL": _read(
        "per-request latency waterfalls (common/waterfall.py)"),
    "PIO_WATERFALL_SAMPLE": _read("the waterfalls' sampling interval"),
    "PIO_SLOW_RING": _read("the slow ring's capacity"),
    "PIO_PROFILE_DIR": _read("where POST /debug/profile captures land"),
    "PIO_PROFILE_MAX_MS": _read("the longest POST /debug/profile capture"),
    "PIO_PROFILE_ENABLE": _read(
        "POST /debug/profile (common/profiling.py; 0 answers 403)"),
    "PIO_SLO_AVAILABILITY": _read("the availability SLO (common/slo.py)"),
    "PIO_SLO_LATENCY_MS": _read("the latency SLO's threshold"),
    "PIO_SLO_LATENCY_TARGET": _read("the latency SLO's target"),
    "PIO_SLO_FAST_WINDOW_S": _read("the SLO burn rate's fast window"),
    "PIO_SLO_SLOW_WINDOW_S": _read("the SLO burn rate's slow window"),
    # autopilot and autotrain
    **{f"PIO_AUTOPILOT_{k}": _read(
        "the autopilot's AutopilotConfig.resolved() "
        "(workflow/autopilot.py: pio autopilot, router --autopilot)")
       for k in ("POLL_MS", "COOLDOWN_S", "UTIL_LOW", "UTIL_HIGH",
                 "MIN_REPLICAS", "MAX_REPLICAS", "OUTLIER_X", "PROFILE_MS")},
    **{f"PIO_AUTOTRAIN_{k}": _read(
        "autotrain's AutotrainConfig.resolved() (workflow/autotrain.py: "
        "pio autotrain, deploy --autotrain, router --autotrain)")
       for k in ("POLL_MS", "COOLDOWN_S", "MAX_STALENESS_S",
                 "VOLUME_EVENTS", "LAG_EVENTS", "TOLERANCE", "PARITY_MIN",
                 "PROBE", "PUBLISH_TIMEOUT_S")},
}

_OFF = ("", "0", "off")


def _is_off(knob: Knob, raw: str) -> bool:
    """Does ``raw`` leave an UNPORTED knob's feature off?"""
    v = raw.strip().lower()
    if v in _OFF or v in knob.also_off:
        return True
    try:
        return float(v) == 0.0
    except ValueError:
        return False


def refuse_unported(verb: str,
                    environ: Optional[Mapping[str, str]] = None) -> None:
    """Raise ValueError when a variable set in ``environ`` (the process
    environment by default) asks ``verb`` for a feature the port lacks."""
    env = os.environ if environ is None else environ
    for name, knob in KNOBS.items():
        if knob.kind != UNPORTED or verb not in knob.verbs:
            continue
        raw = env.get(name)
        if raw is None or _is_off(knob, raw):
            continue
        accepted = " / ".join(["unset", "0", "off", *knob.also_off])
        raise ValueError(
            f"{name}={raw} asks for {knob.what}, which the PyTorch port "
            f"does not have yet; ROADMAP {knob.roadmap} brings it. "
            f"Accepted here: {accepted}")
