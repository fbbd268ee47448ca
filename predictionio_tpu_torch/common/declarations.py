"""The port's declaration registry for operational knobs and metrics
(the torch form of ``predictionio_tpu/common/declarations.py``).

Every ``PIO_*`` environment variable the port reads and every ``pio_*``
metric family it exports is declared HERE, with a one-line meaning, and
documented in README.md. The port's ``declarations`` lint pass
(tools/analyze/passes/declarations.py) reads this module's AST, not the
module itself, and cross-checks all three directions:

- an env read / metric registration in code with no declaration here is
  a typo or an undocumented knob (``env-undeclared`` /
  ``metric-undeclared``);
- a declaration here whose name appears nowhere in the code is dead
  weight that misleads operators (``env-dead`` / ``metric-ghost``);
- a declaration missing from README.md is a knob operators can't
  discover (``env-undocumented`` / ``metric-undocumented``).

``JOURNAL_CATEGORIES`` is the same registry for the operational
journal (common/journal.py): every ``journal.emit(category=...)`` call
site must use a category declared there (``journal-undeclared``).

Names ending in ``*`` declare a PREFIX (config families whose full
names are user-composed, e.g. ``PIO_STORAGE_SOURCES_<NAME>_TYPE``).
Prefixes are exempt from the dead-declaration check — their concrete
spellings never appear verbatim in code.

The registry holds every name of the reference's, each one-liner in the
reference's words; where the port gives a name another meaning (a knob
it leaves inert or refuses, a family that counts a kernel build rather
than an XLA compile) the one-liner says so after "the port:". The names
in :data:`PORT_ONLY` are the port's own and have no reference
counterpart. ``knobs.py`` classifies ``ENV_VARS`` less those names.

The three dicts stay literal (string keys, string values): the lint
reads them without importing anything.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

#: every PIO_* environment variable -> one-line operator meaning.
ENV_VARS: Dict[str, str] = {
    # ------------------------------------------------------ storage core
    "PIO_FS_BASEDIR":
        "base directory for the zero-config stores (sqlite metadata, "
        "eventlog shards, model files, checkpoints); default ~/.pio_store",
    "PIO_STORAGE_SOURCES_*":
        "storage source config family: PIO_STORAGE_SOURCES_<NAME>_TYPE "
        "(memory|sqlite|eventlog|localfs|s3|remote) plus per-type "
        "extras (_PATH, _URL, _KEY, _RETRIES, _BACKOFF_MS, ...); the "
        "port: a TYPE it has not ported is refused by the storage layer",
    "PIO_STORAGE_REPOSITORIES_*":
        "repository bindings: PIO_STORAGE_REPOSITORIES_"
        "{METADATA,EVENTDATA,MODELDATA}_SOURCE -> a declared source name",
    "PIO_STORAGE_SERVER_KEY":
        "shared secret the storage server requires from remote clients "
        "(X-PIO-Storage-Key); unset = unauthenticated",
    "PIO_SERVER_KEY":
        "server key for the dashboard / admin daemons",
    "PIO_SSL_CERTFILE":
        "TLS certificate for the HTTP daemons; unset = plain HTTP",
    "PIO_SSL_KEYFILE":
        "TLS private key paired with PIO_SSL_CERTFILE",
    "PIO_EVENTLOG_CACHE_MB":
        "decoded-chunk cache budget for eventlog bulk reads (MB, "
        "default 256)",
    "PIO_WAL_GROUP_MS":
        "WAL group-commit coalescing window in ms — concurrent event "
        "inserts landing within it share one write+flush, acks release "
        "after the group lands (default 2; 0 = legacy per-append writes)",
    "PIO_WAL_FSYNC":
        "WAL durability: group (default, one fsync per group commit) | "
        "always (fsync every append, no coalescing wait) | off (no "
        "fsync — power-loss window, KNOWN_ISSUES #11)",
    # ----------------------------------------------------- HTTP transport
    "PIO_TRANSPORT":
        "daemon HTTP transport: threaded (default, stdlib thread-per-"
        "connection) | async (single event loop, keep-alive + HTTP/1.1 "
        "pipelining, handlers on a bounded executor); wire bytes "
        "identical in both modes",
    "PIO_TRANSPORT_WORKERS":
        "async transport: handler executor width (default "
        "min(32, 4x cores))",
    "PIO_TRANSPORT_PIPELINE":
        "async transport: max pipelined requests in flight per "
        "connection, responses stay in order (default 16)",
    "PIO_BATCH_EVENTS_MAX":
        "per-request item cap for POST /batch/events.json (default 50, "
        "EventServer.scala:70 parity)",
    "PIO_BATCH_BULK_INSERT":
        "store a batch request's accepted items in one insert_batch "
        "call (default 1 — one lock round trip + one group-commit wait "
        "per request); 0 = per-item inserts with per-item storage-error "
        "isolation (the pre-async-stack behavior)",
    "PIO_DISABLE_NATIVE":
        "any value disables the native counting-sort extension (falls "
        "back to numpy); the port: INERT, the host counting sort is not"
        " ported and the layout sorts on the card with torch.sort",
    # ------------------------------------------------------ read pipeline
    "PIO_READ_THREADS":
        "parallel chunk-decode workers for bulk event reads "
        "(default min(8, cores); 1 = exact serial behavior)",
    "PIO_READ_OVERLAP":
        "overlap chunk decode with vocab encode during training reads "
        "(default 1; 0 = sequential)",
    "PIO_READ_STAGE":
        "async per-chunk device_put staging during overlapped reads "
        "(default 1; 0 = stage nothing)",
    "PIO_TRAIN_STREAM":
        "out-of-core training read: auto (default — stream wherever "
        "staging engages) | on | off (the bit-compatible in-core path); "
        "streamed trains release host chunks as they stage, so peak "
        "host memory is O(chunk) not O(dataset), with bit-identical "
        "factors",
    "PIO_SYNTHETIC_EVENTS":
        "train on N deterministic synthetic zipfian ratings instead of "
        "the event store (`pio train --synthetic N`; seeded generator, "
        "no dataset download)",
    "PIO_SYNTHETIC_SEED":
        "seed for the synthetic rating generator (default 7)",
    # ------------------------------------------------------- ALS kernels
    "PIO_ALS_KERNEL":
        "ALS trainer kernel: hybrid (default) | csrb | scan; the port: "
        "one deterministic fp32 chunked Gram for all three",
    "PIO_ALS_SOLVER":
        "per-row solver: gj (default) | pallas (experimental TPU "
        "solve); the port: INERT, kernel A (csrc/solve_gj.cu) runs on "
        "the card for either value",
    "PIO_ALS_HOT_K":
        "hybrid kernel: number of hot items on the dense path (default "
        "4096); the port: INERT, a TPU layout of the Gram; the port "
        "runs one Gram for every PIO_ALS_KERNEL",
    "PIO_ALS_DENSE_MIN_COUNT":
        "hybrid kernel: minimum rating count for the dense-hot path "
        "(default 64); the port: INERT, a TPU layout of the Gram; the "
        "port runs one Gram for every PIO_ALS_KERNEL",
    "PIO_ALS_XPAD":
        "pad the expanded factor matrix to the lane width (default 1; 0"
        " = unpadded, debugging only); the port: INERT, a TPU layout of"
        " the Gram; the port runs one Gram for every PIO_ALS_KERNEL",
    "PIO_ALS_LAYOUT_CACHE":
        "retain prepared COO layouts keyed by content fingerprint "
        "(default 1; 0 = rebuild every train)",
    "PIO_ALS_BIG_LAYOUT_MIN":
        "nnz threshold above which layout prep reports progress and the "
        "layout cache is strongly preferred (default 2e6)",
    "PIO_NNZ_BUCKETING":
        "bucket padded nnz so close sizes share one compiled program "
        "(default 1; 0 = exact-size programs)",
    "PIO_FINITE_CHECK":
        "post-train non-finite factor check that fails the run instead "
        "of persisting NaN (default 1)",
    # ----------------------------------------------------------- serving
    "PIO_SERVE_BUCKETS":
        "comma-separated padding bucket sizes for batched serving "
        "(default 1,4,16,64)",
    "PIO_SERVE_DEVICE_MS":
        "estimated device-dispatch threshold (ms) below which the "
        "inline single-query device path is used (default 3.0)",
    "PIO_SERVE_SHARD":
        "row-sharded serving over the device mesh: 1/0 overrides "
        "`pio deploy --shard-serving auto`",
    "PIO_SERVE_QUANT":
        "quantized serving from int8 factor matrices with per-row fp32 "
        "scales: 1/0 overrides `pio deploy --serve-quant auto` (auto = "
        "accelerator backends only, gated by the deploy-time recall "
        "probe; off = the bit-compatible fp32 path)",
    "PIO_SERVE_QUANT_RECALL_MIN":
        "recall@k floor below which auto-mode quantized serving falls "
        "back to fp32 at deploy time (default 0.99 — the KNOWN_ISSUES "
        "#12 ranking-parity contract)",
    "PIO_SERVE_FUSED":
        "fused Pallas score->mask->top-k kernel for quantized serving: "
        "auto (default, TPU backends only) | 1/on (everywhere — "
        "interpreter mode off-TPU, slow but bit-equivalent) | 0/off "
        "(the XLA fallback kernel); the port: B1 + B2 "
        "(csrc/topk_fused.cu) on the card, their plain versions on the "
        "CPU",
    "PIO_SERVE_FUSED_TILE":
        "item-axis tile of the fused quantized top-k kernel "
        "(default 512 lanes)",
    "PIO_SERVE_WARMUP_FLUSHES":
        "flush count that ends the recompile watchdog's warmup when no "
        "explicit AOT-complete mark arrives (default 32)",
    # ---------------------------------------------------- realtime fold-in
    "PIO_FOLDIN":
        "realtime fold-in speed layer: 1/0 overrides `pio deploy "
        "--foldin off` (0 = off everywhere, every endpoint "
        "byte-identical to a non-fold-in server — the tier-1 default)",
    "PIO_FOLDIN_TICK_MS":
        "fold-in tick cadence in ms when started via the standalone "
        "runner default paths (ServerConfig/--foldin-tick-ms wins on "
        "deploys; default 250)",
    "PIO_FOLDIN_HEADROOM":
        "user-row capacity pre-padded at model load for fold-in "
        "appends (default 1024); exhaustion falls back to the /reload "
        "hot-swap with re-grown capacity",
    "PIO_FOLDIN_MAX_EVENTS":
        "per-user history cap for the fold-in solve (most-recent N "
        "rating events, default 256; also the per-user slot width of "
        "the padded solve batch — see KNOWN_ISSUES #13)",
    "PIO_FOLDIN_USER_BUCKETS":
        "comma-separated dirty-user batch padding buckets for the "
        "fold-in solve/publication programs (default 1,8,64)",
    "PIO_FOLDIN_CURSOR_DIR":
        "directory for the persistent fold-in cursor files (default "
        "$PIO_FS_BASEDIR/foldin)",
    "PIO_FOLDIN_DRIFT_EVERY":
        "ticks between fold-in drift probes — published rows vs a "
        "fresh half-step on the same events (default 64; 0 disables)",
    "PIO_FOLDIN_DRIFT_RECALL_MIN":
        "recall@10 floor below which the fold-in drift probe verdict "
        "is FAILED (journal WARN + doctor WARN; default 0.99)",
    "PIO_FOLDIN_ITEM_HEADROOM":
        "item-row capacity pre-padded at model load for fold-in of "
        "unseen ITEMS (default 1024); exhaustion falls back to the "
        "/reload hot-swap like the user side",
    # --------------------------------------------------------------- AOT
    "PIO_AOT":
        "ahead-of-time serving compilation: 1/0 overrides "
        "`pio deploy --aot auto` (0 restores the lazy pre-AOT deploy)",
    "PIO_AOT_KS":
        "comma-separated k values to enumerate serving programs for "
        "(default 10, clamped to the model); the port: INERT, k selects"
        " no kernel instantiation, so the warm-up runs one k",
    "PIO_AOT_PRUNE":
        "prune AOT buckets against the observed flush-size histogram "
        "(default 1; 0 = build every declared bucket); the port: INERT,"
        " a bucket changes only a launch's grid, so every bucket is "
        "warmed",
    "PIO_AOT_THREADS":
        "AOT prebuild thread-pool width (default 4); the port: INERT, "
        "the warm-up's launches run in order on one stream",
    "PIO_COMPILE_CACHE_DIR":
        "persistent XLA compile-cache directory; train exports its new "
        "entries as a deploy artifact, deploy pre-seeds from it; the "
        "port: INERT, there is no XLA compile cache; the kernels build "
        "once into PIO_TORCH_KERNEL_DIR",
    "PIO_COMPILE_CACHE_MIN_S":
        "minimum compile seconds before a program is persisted to the "
        "compile cache (default 0); the port: INERT, there is no XLA "
        "compile cache",
    # ------------------------------------------------------------ router
    "PIO_ROUTER_HEALTH_MS":
        "router membership poll cadence in ms — each backend's /readyz "
        "is probed this often for eject/re-admit and generation "
        "(default 500)",
    "PIO_ROUTER_DEADLINE_MS":
        "router per-query deadline budget in ms, propagated to the "
        "backend as X-PIO-Deadline-Ms and spent across the failover "
        "retry; a smaller incoming X-PIO-Deadline-Ms wins (default "
        "2000)",
    "PIO_ROUTER_MAX_INFLIGHT":
        "router admission ceiling: concurrent in-flight forwards beyond "
        "this answer 503 + Retry-After instead of queueing (default "
        "256)",
    "PIO_ROUTER_TENANT_MAX_INFLIGHT":
        "router per-tenant in-flight cap: concurrent forwards for one "
        "tenant (resolved from the query's accessKey) beyond this shed "
        "503 without charging the shared ceiling (default 0 = off)",
    "PIO_ROUTER_CACHE":
        "router front-door response cache on/off: repeat (tenant, query "
        "bytes, model generation) hits answer from a bounded LRU "
        "without touching a replica; generation keying makes /reload "
        "invalidation free, per tenant (default off)",
    "PIO_ROUTER_CACHE_MB":
        "router response-cache byte budget in MB — least-recently-used "
        "entries evict past it (default 16)",
    "PIO_ROUTER_CACHE_TTL_MS":
        "router response-cache entry TTL in ms; bounds the staleness "
        "generation keying cannot see, e.g. fold-in row publishes "
        "(KNOWN_ISSUES #17; default 5000)",
    "PIO_DEPLOY_PARTITION":
        "partition-routed deploy scope i/N for `pio deploy`: this "
        "replica loads only its contiguous item-row range "
        "(parallel/serve_dist.py partition_rows) and advertises it on "
        "/readyz for the router's scatter/merge (default: full model)",
    # ------------------------------------------------------ multi-tenant
    "PIO_TENANT_RATE":
        "default per-access-key admission rate in queries/s for "
        "multi-tenant deploys; a tenant's conf `rate` wins (default 0 "
        "= unlimited)",
    "PIO_TENANT_BURST":
        "default token-bucket burst for per-key admission; 0 derives "
        "2x the rate (default 0)",
    "PIO_TENANT_HBM_BUDGET_MB":
        "default per-tenant model-bytes soft budget in MiB; a tenant "
        "over it serves but is flagged oversubscribed (`pio doctor` "
        "WARN); a tenant's conf `hbmBudgetMb` wins (default 0 = "
        "unbudgeted)",
    "PIO_TENANT_HBM_HARD_CAP_MB":
        "process-wide model-bytes hard cap in MiB; a load that would "
        "push the registry total past it is refused and the prior "
        "generation keeps serving (default 0 = uncapped)",
    # -------------------------------------------------------- resilience
    "PIO_RPC_RETRIES":
        "remote-storage retry attempts for idempotent calls (default 3)",
    "PIO_RPC_BACKOFF_MS":
        "base backoff between remote-storage retries (full jitter)",
    "PIO_RPC_BACKOFF_MAX_MS":
        "backoff ceiling for remote-storage retries",
    "PIO_RPC_DEADLINE_MS":
        "total retry deadline per remote-storage call; propagated as "
        "X-PIO-Deadline-Ms",
    "PIO_RPC_WRITE_DEDUP":
        "1 arms exactly-once event-insert retries via one-shot write "
        "tokens (default 0)",
    "PIO_RPC_POOL":
        "idle keep-alive connections the remote-storage driver retains "
        "in its shared pool (default 8; failed sockets never re-pool)",
    "PIO_BREAKER_ENABLED":
        "1 arms the per-endpoint circuit breaker on remote storage "
        "clients (default 0)",
    "PIO_BREAKER_WINDOW_S":
        "sliding error-rate window for the circuit breaker "
        "(default 30)",
    "PIO_BREAKER_ERROR_RATE":
        "error-rate threshold that opens the breaker (default 0.5)",
    "PIO_BREAKER_MIN_CALLS":
        "minimum calls in the window before the breaker may open "
        "(default 10)",
    "PIO_BREAKER_OPEN_S":
        "seconds an open breaker waits before one half-open probe "
        "(default 5)",
    "PIO_FAULT_SPEC":
        "fault-injection spec (drop/latency/error/truncate clauses with "
        "scopes and rates) for chaos runs",
    "PIO_FAULT_SEED":
        "deterministic seed for PIO_FAULT_SPEC firing decisions",
    "PIO_AUTO_RESUME":
        "auto-resume `pio train` from a crashed run's iteration "
        "checkpoints (default 1)",
    # ----------------------------------------------------- observability
    "PIO_TELEMETRY":
        "1 records optional hot-path metrics (GET /metrics serves the "
        "registry either way)",
    "PIO_TRACE":
        "1 originates a Dapper-style trace per incoming request "
        "(propagated X-PIO-Trace headers are always honored)",
    "PIO_TRACE_BUFFER":
        "trace ring-buffer capacity in spans (default 512)",
    "PIO_TRACE_TAIL_MS":
        "tail-based trace retention: a span at/over this many ms pins "
        "its whole trace in the tail ring, surviving main-ring churn "
        "(default 100; 0 disables slow-pinning — error/journal pins "
        "stay)",
    "PIO_TRACE_TAIL_TRACES":
        "tail-ring capacity in whole pinned traces (default 64, oldest "
        "pin evicted first)",
    "PIO_JOURNAL":
        "0 disables the operational-event journal (flight recorder; "
        "default on — /debug/events.json then answers enabled:false "
        "with no events)",
    "PIO_JOURNAL_BUFFER":
        "journal ring capacity in events (default 1024; seq numbers "
        "stay monotonic across eviction)",
    "PIO_HISTORY":
        "0 disables the metrics flight recorder (bounded in-process "
        "time-series rings; default on — /debug/history.json then "
        "answers enabled:false with no samples)",
    "PIO_HISTORY_TICK_S":
        "history sampler cadence in seconds (default 5; floor 0.1) — "
        "also the fast ring's resolution",
    "PIO_HISTORY_MAX_SERIES":
        "series the history rings will track before dropping new ones "
        "(default 512; drops are counted, memory stays bounded)",
    "PIO_WATERFALL":
        "1 samples per-request latency waterfalls into "
        "pio_serve_stage_seconds + /debug/slow.json (default 0)",
    "PIO_WATERFALL_SAMPLE":
        "sample every Nth request when waterfalls are on (default 1)",
    "PIO_SLOW_RING":
        "capacity of the keep-the-N-slowest /debug/slow.json ring "
        "(default 32)",
    "PIO_PROFILE_DIR":
        "directory where POST /debug/profile captures land (artifact "
        "paths are confined under it)",
    "PIO_PROFILE_MAX_MS":
        "hard ceiling on on-demand profile capture length "
        "(default 10000)",
    "PIO_PROFILE_ENABLE":
        "0 disables the POST /debug/profile surface outright (403); "
        "GET listing stays",
    "PIO_SLO_AVAILABILITY":
        "availability SLO target (default 0.999)",
    "PIO_SLO_LATENCY_MS":
        "latency SLO threshold in ms (default 25, snapped to a "
        "histogram bucket edge)",
    "PIO_SLO_LATENCY_TARGET":
        "fraction of serves that must meet PIO_SLO_LATENCY_MS "
        "(default 0.99)",
    "PIO_SLO_FAST_WINDOW_S":
        "fast burn-rate window (default 300)",
    "PIO_SLO_SLOW_WINDOW_S":
        "slow burn-rate window (default 3600)",
    # ----------------------------------------------------------- autopilot
    "PIO_AUTOPILOT_POLL_MS":
        "autopilot control-loop cadence in ms (default 1000)",
    "PIO_AUTOPILOT_COOLDOWN_S":
        "per-action-class rate limit: one scale / shed / quarantine / "
        "profile action per class per this many seconds (default 30)",
    "PIO_AUTOPILOT_UTIL_LOW":
        "fleet busy-fraction floor below which the autopilot drains a "
        "replica (default 0.2)",
    "PIO_AUTOPILOT_UTIL_HIGH":
        "fleet busy-fraction ceiling above which the autopilot spawns "
        "a replica (default 0.85)",
    "PIO_AUTOPILOT_MIN_REPLICAS":
        "rotation floor the autopilot refills to after a replica dies, "
        "and the scale-down floor (default 1)",
    "PIO_AUTOPILOT_MAX_REPLICAS":
        "rotation ceiling for utilization-driven spawns (default 4)",
    "PIO_AUTOPILOT_OUTLIER_X":
        "quarantine trigger: a backend whose query-latency p99 exceeds "
        "this multiple of the fleet median is held out (default 3)",
    "PIO_AUTOPILOT_PROFILE_MS":
        "length of the one profile capture the autopilot triggers per "
        "sustained-burn episode (default 2000)",
    # ----------------------------------------------------------- autotrain
    "PIO_AUTOTRAIN_POLL_MS":
        "autotrain control-loop cadence in ms (default 1000)",
    "PIO_AUTOTRAIN_COOLDOWN_S":
        "per-trigger-class rate limit: one retrain decision per class "
        "(drift / lag / volume / staleness) per this many seconds "
        "(default 600)",
    "PIO_AUTOTRAIN_MAX_STALENESS_S":
        "wall-clock trigger: retrain when the live model's training "
        "run finished longer ago than this (default 86400)",
    "PIO_AUTOTRAIN_VOLUME_EVENTS":
        "volume trigger: retrain once this many events accumulate "
        "past the live model's recorded training cursor (default 5000)",
    "PIO_AUTOTRAIN_LAG_EVENTS":
        "lag trigger: retrain when the fold-in tail's cursor lag "
        "reaches this many events (default 5000)",
    "PIO_AUTOTRAIN_TOLERANCE":
        "score gate: a candidate's probe RMSE may exceed the live "
        "generation's by at most this fraction (default 0.02)",
    "PIO_AUTOTRAIN_PARITY_MIN":
        "parity gate: candidate-vs-live ranking recall@10 floor over "
        "the common vocabulary (default 0.2)",
    "PIO_AUTOTRAIN_PROBE":
        "deterministic validation probe size — events for the score "
        "gate, sampled users for the parity gate (default 256)",
    "PIO_AUTOTRAIN_PUBLISH_TIMEOUT_S":
        "how long a publish may take to advance the served generation "
        "before the cycle fails (default 300)",
    # ------------------------------------------------- the port's own
    "PIO_TORCH_DEVICE":
        "the port's device when an entry point is given none: cuda "
        "(default; raises without a card) | cpu (each kernel's plain "
        "PyTorch version)",
    "PIO_TORCH_KERNEL_DIR":
        "where the port builds and loads its CUDA kernel libraries "
        "(default predictionio_tpu_torch/_build/ in the checkout)",
}

#: every pio_* metric family / collector-emitted series -> one-liner.
METRICS: Dict[str, str] = {
    # ------------------------------------------------------- micro-batcher
    "pio_batcher_batches_total": "flushed batches",
    "pio_batcher_queries_total": "queries admitted into batches",
    "pio_batcher_rejected_total":
        "queries rejected by admission control (503)",
    "pio_batcher_queue_wait_seconds_total": "summed per-query queue wait",
    "pio_batcher_flush_seconds": "flush (device dispatch) latency per batch",
    "pio_batcher_queue_depth": "current admission queue depth",
    "pio_batcher_batch_size": "batches by exact flush size",
    "pio_batcher_bucket": "batches by padding-bucket occupancy",
    # ------------------------------------------------------------- serving
    "pio_serve_seconds":
        "per-request serve latency by mode and tenant ('default' on a "
        "single-tenant deploy)",
    "pio_serve_stage_seconds":
        "per-stage waterfall latency (admission/supplement/dispatch/pad/"
        "execute/merge/serialize) with trace-id exemplars",
    "pio_serve_shards": "live shard count of the sharded serving path",
    "pio_serve_quant_mode":
        "1 while the deployed factors serve quantized (int8 + scales)",
    "pio_serve_factor_bytes":
        "deployed factor-matrix bytes by dtype (live footprint vs its "
        "fp32 equivalent)",
    "pio_serve_quant_recall":
        "deploy-time ranking-parity probe of the quantized path vs fp32 "
        "(recall@k / exact-match@1)",
    # ---------------------------------------------------- realtime fold-in
    "pio_foldin_freshness_seconds":
        "event ack to servable factor (the speed-layer latency the "
        "whole fold-in subsystem exists to bound)",
    "pio_foldin_cursor_lag_events":
        "events between the fold-in cursor and the event-log head "
        "after the latest tick",
    "pio_foldin_last_tick_seconds":
        "wall-clock of the most recent fold-in tick (read + solve + "
        "publish)",
    "pio_foldin_users_total":
        "fold-in user outcomes: folded / appended (new user into "
        "headroom) / pending (deferred to the next tick or reload)",
    "pio_foldin_ticks_total": "fold-in ticks by outcome (ok/empty/error)",
    "pio_foldin_drift_recall":
        "latest drift-probe recall@10: published fold-in rows vs a "
        "fresh half-step on the same events (KNOWN_ISSUES #13)",
    "pio_foldin_item_drift_recall":
        "latest ITEM-side drift-probe recall@10: published folded item "
        "columns vs a fresh transposed half-step on the same events",
    "pio_foldin_items_total":
        "fold-in item outcomes: folded / appended (new item into item "
        "headroom + vocab growth) / pending (deferred to the next "
        "tick or reload)",
    "pio_degraded_batches_total":
        "flushes tainted by a failed side-channel lookup",
    "pio_degraded_queries_upper_bound":
        "responses flagged degraded (upper bound; batch-granular)",
    "pio_time_to_ready_seconds": "deploy start to /readyz ready",
    # ----------------------------------------------------------------- AOT
    "pio_aot_programs_total": "AOT program builds by status",
    "pio_aot_prebuild_seconds": "AOT prebuild wall time",
    # ------------------------------------------------------------ training
    "pio_train_phase_seconds": "train phase durations (read/layout/...)",
    "pio_layout_cache_total": "layout-cache hits/misses/skips",
    "pio_read_chunk_decode_seconds": "eventlog chunk decode latency",
    "pio_staging_chunks_total": "async device-staging chunks enqueued",
    "pio_staging_rows_total": "async device-staging rows enqueued",
    "pio_staging_finalize_enqueue_seconds":
        "staging finalize ENQUEUE time (async stream deliberately "
        "unsynced; the layout phase owns the barrier)",
    # -------------------------------------------------------------- router
    "pio_router_requests_total":
        "routed /queries.json requests by outcome (ok / failover_ok / "
        "shed / deadline / error) and tenant ('-' for key-less "
        "queries)",
    "pio_router_failovers_total":
        "forwards retried on another replica after a transport failure "
        "or timeout on the first",
    "pio_router_overhead_seconds":
        "router-added latency per request (handler time minus the "
        "backend call — the <= 1 ms front-door budget)",
    "pio_router_backend_up":
        "1 while a backend is in rotation (healthy + admitted by the "
        "reload barrier), 0 while ejected",
    "pio_router_cache_hits_total":
        "front-door response-cache hits: queries answered from the "
        "(tenant, query bytes, model generation) LRU without touching "
        "a replica",
    "pio_router_cache_misses_total":
        "front-door response-cache misses (forwarded to a replica; 200 "
        "answers are stored on the way back)",
    "pio_router_cache_evictions_total":
        "response-cache entries dropped: LRU past the byte budget, TTL "
        "expiry, or a generation-bump invalidation sweep",
    "pio_router_cache_hit_ratio":
        "hits / (hits + misses) over the router's lifetime — the "
        "zipfian hot-key absorption the cache exists for",
    "pio_router_partition_requests_total":
        "partition-scattered /queries.json requests by outcome (merged "
        "/ coverage_gap / error / deadline)",
    "pio_router_partition_width":
        "scatter width of the live partition map (how many owning "
        "partitions one query fans out to); 0 = no map",
    "pio_router_backend_seconds":
        "backend call time per forwarded attempt, labeled by backend — "
        "the per-replica latency signal the autopilot's outlier "
        "quarantine reads",
    # ----------------------------------------------------------- autopilot
    "pio_autopilot_actions_total":
        "autopilot actions by action (scale_up / scale_down / "
        "shed_widen / shed_narrow / quarantine / readmit / "
        "profile_capture) and outcome (ok / failed / dry_run)",
    "pio_autopilot_state":
        "degradation-ladder depth (0 = normal thresholds); -1 while "
        "the loop holds off under generation skew or a reload barrier",
    "pio_autopilot_last_action_age_seconds":
        "seconds since the autopilot's most recent (or dry-run "
        "would-have) action; 0 until the first",
    # ----------------------------------------------------------- autotrain
    "pio_autotrain_decisions_total":
        "autotrain retrain decisions by trigger (drift / lag / volume "
        "/ staleness) and outcome (ok / failed / dry_run)",
    "pio_autotrain_candidates_total":
        "validated retrain candidates by verdict (accepted / rejected "
        "/ failed)",
    "pio_autotrain_state":
        "control-loop phase (0 idle, 1 retraining, 2 validating, 3 "
        "publishing); -1 while holding off under generation skew or a "
        "reload barrier",
    "pio_autotrain_last_decision_age_seconds":
        "seconds since autotrain's most recent (or dry-run would-have) "
        "retrain decision; 0 until the first",
    # ----------------------------------------------------------- transport
    "pio_http_requests_total": "HTTP requests by path/code",
    "pio_http_request_seconds": "HTTP request handling latency",
    "pio_events_requests_total": "event-server API requests (collector)",
    "pio_events_ingested_total": "events ingested (collector)",
    "pio_rpc_retries_total": "remote-storage retries by endpoint",
    "pio_wal_group_commit_seconds": "WAL group-commit write+flush latency",
    "pio_wal_group_commit_events": "events coalesced per WAL group commit",
    "pio_rpc_dedup_replays_total":
        "server-side dedup replays of retried writes",
    "pio_breaker_transitions_total": "circuit-breaker state transitions",
    "pio_breaker_open": "1 while a breaker is open (collector)",
    "pio_eventlog_chunk_map_fallbacks_total":
        "eventlog chunks whose columns were loaded whole instead of "
        "memory-mapped, by reason (the port's own; one eventlog "
        "journal event each)",
    # -------------------------------------------------------- device watch
    "pio_xla_compiles_total":
        "XLA compiles attributed to entry points; the port: kernel "
        "library builds and loads",
    "pio_xla_compile_seconds":
        "XLA compile durations; the port: nvcc build and dlopen "
        "durations",
    "pio_xla_post_warmup_recompiles_total":
        "the alarm: serving-path compiles after warmup; the port: a "
        "kernel build or load in a serving region after warmup",
    "pio_hbm_bytes_in_use": "device memory_stats bytes_in_use (collector)",
    "pio_hbm_bytes_limit": "device memory_stats bytes_limit (collector)",
    "pio_hbm_peak_bytes_in_use":
        "device memory_stats peak bytes (collector)",
    "pio_live_arrays":
        "live jax array count at scrape (collector); the port: the "
        "caching allocator's live blocks",
    "pio_live_array_bytes":
        "live jax array bytes at scrape (collector); the port: the "
        "caching allocator's live bytes",
    "pio_host_rss_bytes":
        "host process resident-set size from /proc/self/status "
        "(collector; absent off-Linux — the out-of-core O(chunk) "
        "claim's gauge)",
    "pio_host_rss_peak_bytes":
        "host process peak RSS (VmHWM) from /proc/self/status "
        "(collector; absent off-Linux)",
    "pio_compile_cache_entries":
        "persistent compile-cache entry count (collector); the port: "
        "files in PIO_TORCH_KERNEL_DIR",
    "pio_compile_cache_bytes":
        "persistent compile-cache size in bytes (collector); the port: "
        "bytes in PIO_TORCH_KERNEL_DIR",
    # ----------------------------------------------------- flight recorder
    "pio_journal_events_total":
        "operational journal events by category and level (the events "
        "themselves ride /debug/events.json)",
    "pio_history_ticks_total":
        "sampler passes the metrics flight recorder completed (the "
        "rings themselves ride /debug/history.json)",
    "pio_history_series":
        "series the flight recorder currently tracks (bounded by "
        "PIO_HISTORY_MAX_SERIES)",
    "pio_history_dropped_series_total":
        "series refused by the PIO_HISTORY_MAX_SERIES cap (bounded "
        "memory beats complete coverage)",
    # ---------------------------------------------------------------- SLO
    "pio_slo_target": "configured SLO objective (collector)",
    "pio_slo_error_budget_remaining":
        "error budget left, 1 = untouched (collector)",
    "pio_slo_burn_rate":
        "error rate / allowed rate over fast+slow windows (collector)",
    "pio_slo_tenant_latency_budget_remaining":
        "per-tenant lifetime latency error budget left (collector; "
        "multi-tenant deploys only)",
    # --------------------------------------------------- multi-tenant
    "pio_tenant_requests_total":
        "multi-tenant query outcomes by tenant (ok / saturated / "
        "rate_limited / denied / error; '-' before admission resolved "
        "a tenant)",
    "pio_tenant_generation":
        "per-tenant servable generation id (collector; multi-tenant "
        "deploys only)",
    "pio_tenant_queue_depth":
        "per-tenant batcher admission queue depth (collector)",
    "pio_tenant_model_bytes":
        "per-tenant loaded model bytes, host-side array estimate "
        "(collector)",
    "pio_tenant_hbm_budget_bytes":
        "per-tenant configured HBM soft budget (collector; only "
        "budgeted tenants)",
}


#: every journal category (common/journal.py ``emit(category=...)``) ->
#: one-line meaning. The ``declarations`` lint pass requires every emit
#: call site to use a category declared here — a typo'd category is a
#: timeline nobody's filter ever finds.
JOURNAL_CATEGORIES: Dict[str, str] = {
    "breaker":
        "circuit-breaker transitions: open (red) / half-open (warn) / "
        "closed (info), per endpoint (common/resilience.py)",
    "retry":
        "a retry schedule exhausted its attempts and surfaced the "
        "failure to the caller (resilience.RetryPolicy, remote driver)",
    "degraded":
        "a serving-path side-channel lookup failed soft; the response "
        "was served from fallbacks and flagged degraded",
    "wal":
        "event-log durability events: torn-tail repairs after a crash, "
        "group-commit stalls (data/storage/eventlog.py)",
    "lifecycle":
        "daemon lifecycle: model load + /reload hot-swap with a "
        "generation id, drain begin/end, failed reloads "
        "(workflow/create_server.py)",
    "quant":
        "quantized serving fell back to fp32: recall-probe refusal or "
        "a failed int8 layout (ops/quant.py)",
    "aot":
        "an AOT serving-program prebuild failed; that program compiles "
        "lazily on the latency path (serving/aot.py)",
    "recompile":
        "post-warmup XLA recompile on the serving path — the "
        "padding-bucket alarm (common/devicewatch.py)",
    "slo":
        "SLO burn-rate threshold crossings: fast-window page edges "
        "(red), slow-window ticket edges (warn), and recoveries "
        "(common/slo.py)",
    "foldin":
        "realtime fold-in lifecycle: worker bound to a generation, "
        "headroom-exhausted /reload fallback, failed ticks, drift-"
        "probe failures (realtime/foldin.py)",
    "router":
        "replica-fleet front door: backend ejection (red) / "
        "re-admission (info), reload-barrier begin/cutover/complete, "
        "barrier aborts leaving generation skew (red) "
        "(workflow/router.py)",
    "tenant":
        "multi-tenant registry events: tenant servable went live with "
        "a generation, over-budget install (warn), hard-cap refusal, "
        "access key unmapped to any tenant (warn) "
        "(serving/registry.py, workflow/create_server.py)",
    "autopilot":
        "SLO-driven control-loop decisions with their triggering "
        "evidence: scale up/down, shed widen/narrow (the degradation "
        "ladder), quarantine/readmit, profile captures, hold-offs "
        "under generation skew, and dry-run would-have actions "
        "(workflow/autopilot.py)",
    "autotrain":
        "continuous-training decisions with their triggering evidence "
        "(drift / cursor lag / event volume / staleness), retrain "
        "crash-resumes, candidate validation verdicts (rejections keep "
        "the prior generation serving), barrier publishes, hold-offs, "
        "and dry-run would-have decisions (workflow/autotrain.py)",
    # ------------------------------------------------- the port's own
    "eventlog":
        "an eventlog chunk's columns were loaded whole instead of "
        "memory-mapped, with the reason (data/storage/eventlog.py)",
}

#: the names above that are the port's own: the reference's registry
#: has no counterpart of them
PORT_ONLY: FrozenSet[str] = frozenset({
    "PIO_TORCH_DEVICE", "PIO_TORCH_KERNEL_DIR",
    "pio_eventlog_chunk_map_fallbacks_total", "eventlog",
})

