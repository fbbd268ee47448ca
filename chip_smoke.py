#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. device  — the card's name and power limit, as nvidia-smi gives them.
2. build   — the three kernel sources from ``predictionio_tpu_torch/csrc``
             with nvcc, one process per source, started together, with
             ptxas's report.
3. kernel B — its two launches against their plain PyTorch versions on
             the card, exact equality of values and indices: B1 (per-tile
             candidates) and B2 (the warp merge of the tiles' lists), at
             the serving shapes (ML-20M: 138,493 users x 26,744 items,
             rank 10, tile 512, b in 1/4/16/64, k in 1/10/100, 600 and
             the whole catalog), at tiles 128 and 100, with cloned
             items tied across tiles, and on catalogs of 1,254 to 7,940
             tiles (B2's wide form); the merged answer against the plain
             int8 path; then, per bucket, CUDA-event times of each call,
             each device body under torch.profiler, the plain versions
             and the library yardsticks, beside each kernel's bound; B2
             against the sort it replaced for k from 100 to the whole
             catalog, and the device time of a 16-row flush at k = 10
             and with one whole-catalog request in it.
4. kernel A — the batched Gauss-Jordan solve against its plain version,
             bit for bit: at every rank 1..32 on an odd batch (n = 257,
             so every template instance runs with a tail group), at the
             ALS shapes (n = 138,493 and 26,744 at rank 10), at n = 700
             for ranks 1, 16 and 32, on the reference's marginal rank-3
             batch, on its engineered indefinite batch (the pivot floor
             engages), and at n = 6,900, 26,744 and 138,493 (the eval's
             user and item half-steps and the ML-20M user half-step) for
             ranks 5, 10, 20 and 32; then, at every shape but the sweep,
             times of the kernel call, its device body, the plain version
             and ``torch.linalg.solve``, beside the bound.
4b. kernel G — the fused Gram (``csrc/gram_fused.cu``) against its plain
             version at the benchmark's two configurations (ML-20M at
             rank 20, Netflix at rank 32; ``pio_bench/data.py``'s ratings
             from the seed), users and items: every element of A and b
             within GRAM_TOL of the sum of its terms' magnitudes, A
             symmetric, a rerun bit for bit; then the call, its device
             body and the plain version, beside the bound of
             ``pio_bench/roofline/gram.py``. Then a fold-in tick's Gram
             at buckets 1 / 8 / 64 (rank 10, int64 rows, other_idx =
             arange), with the tick's plan and with none, held the same
             way, and the tick's Gram timed with its plan.
5. train   — ``pio train --synthetic 20000263`` through the port's CLI, in
             process, on SQLite under a temporary ``PIO_FS_BASEDIR``, at
             the engine.json's rank 10 and 10 iterations (the synthetic
             chunks stream to the card: PIO_TRAIN_STREAM's default auto),
             phase seconds, ms per iteration, RMSE before and after
             (finite, falling), kernel A's launches (2 per iteration),
             kernel G's (one a half-step plus its finishing pass on a
             side with a row of several pieces, exactly) and kernel G on
             the train's layout held to the plain Gram as in 4b, the
             device idle share over one profiled iteration, and a second
             train from the same seed, in-core (PIO_TRAIN_STREAM=off) with
             no cached layout, that must give bit-identical factors.
6. path    — the instance the train phase stored is deployed: ``QueryAPI``
             quantizes it on the card and ``serve()`` answers POST
             /queries.json on 127.0.0.1 (sequential and concurrent
             requests). Every answer must equal the plain int8 path on
             the same factors, B1 and B2 must each launch once per
             flush, and the profiled requests' device trace must hold no
             sort kernel.
6b. observe — the same instance deployed again with PIO_TELEMETRY,
             PIO_TRACE, PIO_WATERFALL and PIO_JOURNAL on, answering
             phase 6's sequential and concurrent queries (each carrying
             an X-PIO-Trace id): every answer byte-equal to phase 6's,
             B1 and B2 once per flush; /metrics' stage counts match the
             requests and flushes; /debug/slow.json holds every request
             with admission, supplement, dispatch (pad and execute
             inside it), merge and serialize summing to at most its
             total; /traces.json chains server -> admission -> flush ->
             dispatch under one trace id; /debug/device.json's HBM
             gauges are the card's and no kernel build ran after
             warmup; /debug/events.json holds the deploy, the journal
             its drain; /metrics carries the SLO engine's pio_slo_*
             families and the flight recorder's pio_history_*, and
             /debug/history.json counts 8 further queries in its
             served-latency series. Then POST /debug/profile?ms=1000 while 32
             sequential queries run: the Chrome trace must hold B1 and
             B2 once per flush, launched by one thread other than the
             client's. Then ``pio train --synthetic 200000 --telemetry
             --profile DIR`` in process: gj_solve exactly twice an
             iteration in the trace, telemetry_phases.json beside it.
             Prints each stage's p50 / p99, sequential and concurrent,
             the transport's share, and the latency with the knobs on
             beside phase 6's with them off.
7. quickstart — the port's CLI in process, on the SQLite store: ``pio
             app new`` with a fixed key, ``app channel-new`` and a
             rate-only ``accesskey new``; ``pio import`` of 250,000
             seeded rate events (6,900 users x 26,744 items, the ML-20M
             catalog) from a JSON-lines file; ``pio eventserver`` on
             127.0.0.1 (in the main thread, its client in another): a
             POST read back, 200 timed single POSTs, a batch of 50 for
             user "1", the 400 at 51, the rate-only key's 403, the
             channel kept apart, then SIGTERM and ``/readyz`` 503 while
             it drains; ``pio train`` from the store (kernel A twice an
             iteration, RMSE falling); ``pio deploy`` answering
             ``{"user": "1", "num": 4}`` with 4 itemScores equal to the
             plain int8 path, B1 and B2 once per flush; ``pio
             undeploy``.
7b. fleet  — the serving fleet on phase 5's model (and the quickstart's),
             every server on 127.0.0.1 port 0 in this process, every
             replica's or tenant's B1 and B2 counted from 0 after its
             deploy was ready and required once each a flush, no B1
             launched from a ``pio-http`` thread, one CUDA stream: (a)
             phase 6's 64 sequential and 64 concurrent queries against a
             deploy on the threaded and on the async transport, each
             answer phase 6's bytes, the client latency split into the
             server's total (``/debug/slow.json``) and the transport's
             rest; (b) ``pio router``'s ``RouterAPI`` over two full
             replicas: 256 queries from 8 clients byte-equal to a direct
             query of a replica, one replica shut down after a quarter of
             them (0 dropped, the failovers counted); then ``POST
             /reload`` through the router under 8 clients moving a fresh
             pair to a newer instance (phase 5's factors, items negated,
             8 rows cloned across the item midpoint): 0 dropped, every
             answer one generation's direct bytes, each client's
             generations monotone; (c) ``--partition 0/2`` and ``1/2`` of
             that instance behind the router: at num 10, 100 and the
             whole catalog the merged bytes equal a full replica's, with
             scores tied across the boundary, each partition's B1 ==
             plain at its own item count; (d) ``pio deploy --engines`` with the 20M
             model and the quickstart model: 401 for a missing and an
             unknown key, 429 past the quickstart tenant's rate, each
             tenant's bytes (``pio_tenant_model_bytes``) beside the
             card's allocation of its install, and a third tenant past
             ``PIO_TENANT_HBM_HARD_CAP_MB`` refused with
             ``torch.cuda.memory_allocated`` unchanged from the start of
             its load; (e) an output blocker's rewrite in every answer, a
             sniffer that sees every query, and ``--feedback`` storing
             one ``predict`` event per query through a port event server.
8. eval    — ``pio eval`` through the port's CLI, in process, on the
             quickstart's app: the reference's grid (ranks 5/10/20 x
             1/5/10 iterations, kFold 5) under RecommendationEvaluation
             from a one-file generator module in an engine directory.
             The EvaluationInstance row must be EVALCOMPLETED, best.json
             must load back, the FastEval counts must be 1/1/9/9/1,
             kernel A must launch exactly 480 times and equal its plain
             version bit for bit on one captured half-step at each of
             ranks 5, 10 and 20, every variant's Precision@K must be
             finite in [0, 1] with PositiveCount > 0, and the rank-20,
             10-iteration variant run again must give bit-identical
             scores. Then the wall split (read_eval, layouts,
             train and batch_predict per variant, metrics), one fold's
             rank-20 train + batch_predict under torch.profiler, and
             ``topk_scores_batch`` at the full ML-20M shape against
             ``torch.topk`` on the same chunks.
9. templates — the classification, similar-product and e-commerce
             templates through the port's CLI, in process, on the same
             SQLite store. ``pio app new`` of a shop app and a plans app,
             filled with ``store.write`` from ``--seed``: 6,900 users and
             the 26,744-item catalog in 10 categories (80% of a user's
             events in a home category), 200,000 views, 200,000 half-star
             rates, 20,000 buys, 20 visitors with views and no ``$set``,
             a ``constraint/unavailableItems`` of 100 items and a
             ``constraint/weightedItems`` with a weight-0 group; 100,000
             users with a plan of 4 and three attribute counts. Per
             template ``pio train`` from an engine.json naming the JAX
             package's factory (rank 10, 20 iterations for both ALS
             trains: kernel A exactly 40 times each, at n = 6,900 and
             26,744), ``pio deploy``, sequential queries, ``pio
             undeploy``: no kernel launches while serving, no answer
             degraded. Similar-product (implicit ALS): a profiled second
             train bit-identical to the stored one; one iteration on the
             card within rtol 2e-3 / atol 2e-4 of the CPU's, its two
             half-steps' kernel A == plain bit for bit, then timed; 50
             query items, at least half of the top-10 answers in the
             query item's category. E-commerce (explicit ALS,
             ``unseenOnly``, ``weightedItems``): a bit-identical profiled
             retrain; 45 users and 5 visitors get answers with no item
             they viewed or bought, no unavailable or weight-0 item, and
             the visitors non-empty ones. Classification (NaiveBayes on
             the card): ``pi`` and ``theta`` within 1e-5 relative of a
             CPU train, and 1,000 held-out points answered at least 90%
             right.
10. store  — the eventlog store through the port's CLI, in process (events
             in an eventlog directory, metadata on SQLite, models as files):
             ``pio app new``; ``synthetic.write_events`` fills 20,000,263
             ML-20M-shaped events from ``--seed`` (138,493 users x 26,744
             items) through ``append_encoded``; ``read_columns`` with one
             decode thread against the pool (byte-identical), and
             ``find_columnar`` streamed to the card against in-core (the
             same columns and digest), each timed; ``pio train`` under
             PIO_TRAIN_STREAM=on, then off (each building its layout),
             then unset (the warm train: one layout-cache hit, no staged
             copy), each under torch.profiler with kernel A 20 times, the
             three models bit-identical, their phases and the device's
             idle share printed beside phase 5's and the quickstart's;
             ``pio import`` of the quickstart's 250,000-event file into
             an eventlog app (events/s beside the SQLite import's) and
             ``pio train`` from it (kernel A 20 times, read_io beside
             SQLite's); ``head_cursor``, 1,000 events through the event
             server, ``cursor_lag`` 1,000 and ``read_columns_since``
             exactly those rows; ``pio deploy`` of the warm train's model,
             16 queries equal to the plain int8 path, B1 and B2 once per
             flush, ``pio undeploy``. Then fold-in on that model: kernel A
             against its plain version bit for bit at the fold-in buckets
             (n = 1 / 8 / 64, 256 slots a row), timed; a deploy with
             fold-in and without the warm-up, then one with it, each from
             unloaded kernel libraries (time to ready each; no build or
             load after ready); under a steady query stream, 64 unseen
             users (20 ratings each) and 8 trained users (5 more) posted
             through the event server, then 4 unseen items rated by 30 of
             the folded users: every tick's kernel A call == plain bit
             for bit, the published rows those outputs and their int8
             rows ``quantize_rows`` of them, every answer equal to the
             plain int8 path, B1 and B2 once per flush, no query dropped,
             freshness and tick times, one row's history read timed and
             profiled, and a fresh store's first read (every index
             sidecar loaded) and its second timed; numpy's version and
             the eventlog chunks loaded whole instead of mapped (none
             allowed) printed after the store phase and after this step;
             then a redeploy with PIO_FOLDIN_HEADROOM=8 and 16
             unseen users (the reload fallback: generation + 1, all
             folded, none dropped) and ``POST /reload`` under 256
             concurrent queries (generation + 1, none dropped). The
             fold-in step runs after phase 11, whose remote trains must
             read the 20M app as the warm train read it (fold-in posts
             events into it).
11. remote — ``pio storageserver`` (a process of its own, key auth,
             telemetry, traces and the journal on) serves phase 10's
             eventlog store, and this process points every repository at
             it through a ``remote`` source: ``read_columns`` of the 20M
             app through it, timed beside the local read; ``pio train``
             through it twice, the second with the columnar reply lost
             once (``PIO_FAULT_SPEC`` drop_rx, one retry): kernel A 20
             times each, one layout built from each read, both models
             bit-identical to phase 10's warm train; ``pio app new`` and
             ``pio import`` of the quickstart file's first 100,000 lines
             with a write reply lost and ``PIO_RPC_WRITE_DEDUP=1`` (the
             retry pauses at least 500 ms, so the lost write reaches the
             server first): one dedup replay, exactly 100,000 events
             stored, the same rows as the file; ``pio deploy`` of the
             first remote train (quantized, model blob through the remote
             source, the breaker on) under one client's query stream; the
             storage server SIGTERMed (its /readyz 503 on an open
             connection, the drain's flush, exit 0), ``POST /reload``
             twice (the first fails and opens the breaker, the second
             fails fast), ``pio_breaker_open`` 1 on /metrics, the breaker
             in /debug/device.json, ``pio doctor`` exit 1 naming it and
             ``pio doctor --targets`` exit 2; the storage server
             restarted on the same port, after open_s a traced ``POST
             /reload`` whose probe closes the breaker (generation + 1)
             and ``pio doctor`` exit 0; no query dropped, every answer
             equal to the plain int8 path, B1 and B2 once per flush;
             then ``pio incident`` (exit 1, the breaker's open before its
             half-open probe), ``pio events`` (both journals, oldest
             first: open, half-open, closed), ``pio trace`` of the
             reload (one tree over both daemons), ``pio monitor --once``
             (a row per daemon, QPS from the history rings) and ``pio
             undeploy``; the seconds of each step beside the card.
12. shard  — block-sharded training and row-sharded serving on the store
             phase's eventlog app (138,493 x 26,744 and the fold-in
             step's events), rank 10, 10 iterations: explicit ALS through
             ``als_dist.train_explicit_sharded`` over 4 shard slots of the
             card, kernel A exactly 80 times (once per slot per
             half-step), each call equal to its plain version at the
             slot's shape, a rerun from the seed bit-identical and the
             factors within the golden-train tolerance of a one-device
             train; ``serve_dist`` at 1, 2 and 4 slots, b = 1 and 64, k
             = 10, 100 and the whole catalog: B1 once per slot and B2
             once a call, answers equal to the replicated B1 + B2 and to
             the plain int8 path bit for bit, each call timed beside the
             replicated one; ``pio train --coordinator 127.0.0.1:PORT
             --num-processes 1 --process-id 0`` on NCCL, ``pio train
             --devices -1`` streamed and in-core (kernel A 20 each; the
             NCCL model equal to the in-core one-slot model bit for bit,
             the streamed one within the tolerance); ``pio deploy
             --shard-serving on --foldin on --telemetry`` under one
             client's query stream: 8 unseen users folded through the
             sharded scatter (their int8 rows == ``quantize_rows``), no
             query dropped, every checked answer equal to the plain int8
             path on the live sharded layout, B1 and B2 once per flush,
             ``/debug/device.json``'s sharding block and ``pio doctor``'s
             sharding line ok; ``POST /reload`` under 256 queries, none
             dropped, still sharded; ``pio undeploy``.
13. control — continuous training and the fleet autopilot on the store
             phase's eventlog app, after its fold-in step (rank 10, 10
             iterations, engine.json): (a) ``pio train`` of a control
             engine (the live generation), 2,000 rate events through the
             event server (40 unseen users among them), ``pio train`` of a
             second engine over the same store (the comparison), then a
             quantized deploy with fold-in under one client's query
             stream, and the loop ``pio deploy --autotrain`` embeds
             attached to it (volume threshold 1,000): it must decide
             ``volume``, retrain on its own thread (kernel A 20 times on
             that thread, each == plain bit for bit), pass both gates and
             publish through the in-place swap (generation + 1); the
             candidate equal to the comparison train bit for bit at the
             same training cursor; 8 unseen users' events posted after
             the retrain's read and before the publish, each served after
             the rebase at the candidate's cursor and equal to the plain
             int8 path; B1 = B2 = the flushes of both generations, plus
             one each a bucket in the publish's warm-up; 0 dropped; the
             cycle's split, the query p50 / p99 before and during the
             retrain, and ``memory_allocated`` before, during and after
             the swap (after: back to one model's worth); (b) a
             staleness-triggered cycle retraining at lambda 1,000: the
             score gate refuses it, its row reads REJECTED, the
             generation stays and 24 answers keep their bytes; (c) the
             autopilot over ``pio router`` of two in-process replicas of
             the published model: a scale-up through
             SubprocessReplicaPool (a ``pio deploy`` child on the card,
             quantized, its answers the replicas' bytes, its time to
             ready), the child (its query route 150 ms slower under
             PIO_FAULT_SPEC) quarantined as a latency outlier and
             readmitted, then drained under a light stream with 0
             dropped; one ladder rung under a burn of a tight
             PIO_SLO_LATENCY_MS, the exact thresholds restored once it
             stops, exactly one profile capture whose trace holds B1 and
             B2 and no sort; a dry run that journals a would-have
             scale-up and leaves the router's status byte-identical.
14. examples — the rest of the engine API, after phase 13 on the same
             stores: (a) an engine.json naming
             ``predictionio_tpu.examples.movielens:filtering_engine`` on
             the store phase's 20M eventlog app (rank 10, 10 iterations):
             ``pio build`` validates it, ``pio train`` runs kernel A 20
             times, each equal to its plain version bit for bit, and a
             quantized ``pio deploy`` with a ``TempFilterServing`` file of
             disabled items (the top 3 of 16 users' plain int8 answers)
             answers 64 sequential and 64 concurrent queries, each the
             plain int8 path's top 10 on the live layout less the disabled
             items; the file is rewritten (4th-6th items of 16 other
             users) and 64 more answers follow it with no redeploy; B1 =
             B2 = flushes, no sort kernel in a profile of 8 queries; ``pio
             undeploy``; (b) on the templates phase's shop app, ``pio
             train`` and ``pio deploy`` of
             ``recommendation_variants:cat_engine`` and
             ``similarproduct_variants:engine`` (kernel A 20 times each,
             each == plain; 8 answers each equal to the stored model's
             predict) and ``pio eval`` of
             ``movielens:sliding_eval_engine``, one variant at rank 10
             over 3 windows cut from the app's rate / buy span (the first
             at 70%; kernel A 60 times, each == plain); (c) helloworld,
             regression's SGD, SimRank on a 2,000-user graph, DIMSUM on
             the whole shop catalog (its 2,000-item slice also on the
             CPU), e2's MarkovChain and stock (a delisted and a constant
             ticker) on the card, each against the same code on the CPU
             within its stated tolerance; (d) ``pio template``, ``pio
             run``, ``pio unregister`` and ``pio upgrade`` (exit 1) and
             ``pio shell`` on a piped stdin printing the card's name.
15. tooling — ``pio lint --list`` names the reference's seven passes;
             ``python -m predictionio_tpu_torch.tools.cli lint --json``
             in a process of its own on this tree: exit 0, every ``.py``
             file of the port and this script analyzed, the seven passes,
             no finding, with its seconds; then phase 5's model (138,493
             x 26,744, rank 10) deployed quantized with telemetry on: 16
             sequential queries, then the batcher's condition, the
             metrics registry's lock and every family's and child's lock
             wrapped in the port's runtime ``LockOrderMonitor``, 8
             clients x 50 queries and 8 profiled ones: no lock-order
             inversion (and some nesting seen), B1 = B2 = flushes, no
             sort kernel in the profile, every answer equal to the plain
             int8 path.
16. serve path — the host-vs-device probe (``PIO_SERVE_DEVICE_MS``) on
             the store phase's warm-train instance (138,493 x 26,744,
             rank 10, its 20M eventlog app), fp32 (``PIO_SERVE_QUANT=off``),
             last: (a) the threshold unset: the probe's ms, the device
             path (no ``hostServing`` in ``GET /``, the ``lifecycle`` load
             event says ``device``), 64 sequential and 64 concurrent
             queries each byte-equal to ``topk.topk_for_users`` in fp32 on
             the card for the same row at a flush's bucket; (b) at ``0``
             with fold-in on: the host path (``hostServing``, the event at
             ``warn``), ``memory_allocated`` within 1 MB of its value
             before the deploy, the same queries' indices equal to (a)'s
             wherever the ranking's gaps exceed the tolerance and scores
             within rtol 1e-5 / atol 1e-6, and 32 profiled queries with no
             CUDA kernel but a marker's; (c) 8 unseen and 8 trained users'
             events into (b)'s deploy under a query stream: every kernel A
             call of the ticks equal to its plain version bit for bit, the
             folded rows in the host arrays bit-equal to the solves'
             rows, the users' answers the host branch's, 0 dropped; then
             ``POST /reload`` with the variable unset: the device path
             again, ``hostServing`` gone.

The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Without a card the
script prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime as _dt
import gc
import http.client
import io
import json
import math
import os
import shutil
import signal
import socket
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import predictionio_tpu_torch
from predictionio_tpu_torch.common import (
    devicewatch, history, journal, resilience, slo, telemetry, tracing,
)
from predictionio_tpu_torch.controller.evaluation import MetricEvaluator
from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.data import store as store_mod
from predictionio_tpu_torch.data import synthetic
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models.classification.engine import (
    ClassificationEngine,
)
from predictionio_tpu_torch.models.ecommerce.engine import ECommerceEngine
from predictionio_tpu_torch.models.recommendation import evaluation
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithm, ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.data_source import (
    DataSource, DataSourceParams,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    RecommendationEngine,
)
from predictionio_tpu_torch.models.similarproduct.engine import (
    SimilarProductEngine,
)
from predictionio_tpu_torch.models.recommendation import als_algorithm
from predictionio_tpu_torch.ops import (
    _kernels, als, gram_fused, naive_bayes, quant, solve, staging, topk,
    topk_fused,
)
from predictionio_tpu_torch.realtime import foldin
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools.analyze.runtime import LockOrderMonitor
from predictionio_tpu_torch.workflow import (
    core_workflow, create_server, model_io,
)
from predictionio_tpu_torch.workflow.context import WorkflowContext

N_USERS, N_ITEMS, RANK = 138_493, 26_744, 10     # ML-20M shape, rank 10
N_RATINGS = 20_000_263                          # ML-20M's rating count
TILE = 512
BUCKETS = (1, 4, 16, 64)
# the eval phase: ML-20M's catalog, users and ratings cut (PERF.md §4)
#: the quickstart app the eval and the store phase read: 250,000 rate
#: events, cut from 1,000,000 (most of its time is the SQLite import)
#: to keep the whole smoke well inside its time limit
EVAL_USERS, EVAL_RATINGS = 6_900, 250_000
EVAL_APP, EVAL_K_FOLD, EVAL_QUERY_NUM = "SmokeEval", 5, 10
EVAL_RANKS, EVAL_ITERS = (5, 10, 20), (1, 5, 10)
# the quickstart, whose app the eval then reads
QS_KEY, QS_RATE_KEY, QS_CHANNEL = "smoke-key", "smoke-rate-only", "mobile"
QS_POSTS, QS_CHANNEL_BATCHES, QS_QUERIES = 200, 20, 20
GRID_MODULE = f'''"""The reference's Recommendation grid, pointed at one app."""
from predictionio_tpu_torch.controller import EngineParamsGenerator
from predictionio_tpu_torch.models.recommendation.evaluation import (
    engine_params_list,
)


class SmokeGrid(EngineParamsGenerator):
    def __init__(self):
        self.engine_params_list = engine_params_list(
            app_name={EVAL_APP!r}, k_fold={EVAL_K_FOLD},
            query_num={EVAL_QUERY_NUM})
'''
# the templates phase: the shop app both ALS templates read (6,900 users
# x the 26,744-item catalog, 10 categories, 80% of a user's events in
# their home category) and the classification app (100,000 users, 4
# plans, three attributes whose proportions depend on the plan)
TPL_APP, NB_APP = "SmokeShop", "SmokePlans"
TPL_USERS, TPL_CATEGORIES, TPL_HOME_SHARE = 6_900, 10, 0.8
TPL_VIEWS, TPL_RATES, TPL_BUYS = 200_000, 200_000, 20_000
TPL_VISITORS, TPL_VISITOR_VIEWS = 20, 5       # views, no $set
TPL_UNAVAILABLE, TPL_ZERO_WEIGHT = 100, 50
TPL_RANK, TPL_ITERS, TPL_QUERIES = 10, 20, 50  # the templates' defaults
NB_USERS, NB_HELD_OUT, NB_CLASSES = 100_000, 1_000, 4
NB_RATES = np.array([[16, 3, 3], [3, 16, 3], [3, 3, 16], [8, 8, 8]],
                    dtype=np.float64)
#: NB's pi / theta on the card against the CPU: relative
NB_RTOL = 1e-5
#: one implicit iteration on the card against the CPU (the whole-train
#: tolerance of tests/test_torch_als.py)
ITER_RTOL, ITER_ATOL = 2e-3, 2e-4
ENGINE_JSON = os.path.join(os.path.dirname(predictionio_tpu_torch.__file__),
                           "models", "recommendation", "engine.json")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12
FP32_UNFUSED_OPS_S = 33.5e12    # one unfused multiply or add per lane-cycle


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _clones():
    """Item 5 and its clones in later tiles (1, the middle, the last)."""
    return (5, 700, N_ITEMS // 2, N_ITEMS - 1)


def _model(seed: int):
    """The ML-20M-shape ALS model: Gaussian factors from ``seed``, with
    item 5 cloned into three later tiles (exact score ties across
    tiles)."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N_USERS, RANK), dtype=np.float32)
    V = rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)
    for clone in _clones()[1:]:
        V[clone] = V[5]
    return U, V


def _time_ms(fn, reps: int = 200, warm: int = 20) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _device_profile(fn, attempts: int = 3):
    """Run ``fn`` under torch.profiler; returns ({name: (self device us,
    count)}, wall s) over the kernels and copies. The CPU-side ``aten::``
    rows, which repeat the time of the kernels they launch in this
    thread, are left out. A session that records no device time at all
    (the profiler drops a whole session now and then) is run again, up
    to ``attempts`` times; the dict is empty when every one was empty."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us and not e.key.startswith("aten::"):
                per[e.key] = (float(us), int(e.count))
        if per:
            break
        print(f"profile: session {attempt + 1} recorded no device time",
              flush=True)
    return per, wall


def _topk_fused_bound_ms(b: int, r: int, n_pad: int, tile: int,
                         k_local: int) -> tuple:
    """Least time for the candidates function (B1) at this shape: each
    input read once and each output written once, against the integer
    dot, the rescale and one compare per score (what selecting a tile's
    top k needs, whatever algorithm the kernel uses) at their peak
    rates."""
    n_tiles = n_pad // tile
    bytes_moved = (b * 4 + b * r + b * 4           # ixs, gathered rows, su
                   + r * n_pad + n_pad * 4         # vt tile slices, sv
                   + b * n_tiles * k_local * 8)    # candidates out
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = (2 * b * n_pad * r / INT8_OPS_S        # int8 multiply-adds
             + (2 * b * n_pad                      # rescale
                + b * n_pad) / FP32_OPS_S)         # selection compares
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _merge_bound_ms(b: int, width: int, k: int) -> tuple:
    """Least time for the merge (B2): the (b, width) candidates read once
    and the (b, k) answer written once; its compares (one per answer
    entry and list) are far below the fp32 peak's time for these bytes."""
    return (b * width * 8 + b * k * 8) / HBM_BYTES_S * 1e3, "bytes"


def _same(a_vals, a_idx, b_vals, b_idx) -> bool:
    return (a_vals.shape == b_vals.shape
            and torch.equal(a_vals.view(torch.int32), b_vals.view(torch.int32))
            and torch.equal(a_idx, b_idx))


def _body_ms(per: dict, name: str):
    """Device time per launch of the kernel whose name holds ``name``."""
    body = [us / n for key, (us, n) in per.items() if name in key]
    return body[0] / 1e3 if body else None


def _device_ms(fn, n: int) -> float:
    """Device time (kernels and copies) per call of ``fn``, over ``n``
    calls under torch.profiler."""
    per, _wall = _device_profile(lambda: [fn() for _ in range(n)])
    if not per:
        raise AssertionError("the profiler recorded no device time")
    return sum(us for us, _n in per.values()) / n / 1e3


def _sort_kernels(per: dict) -> list:
    return [key for key in per if "sort" in key.lower()]


def _require_kernels(per: dict, where: str) -> None:
    """The trace must show B1 and B2, or it cannot show that no sort ran."""
    missing = [name for name in ("score_mask_topk", "merge_tile_lists")
               if not any(name in key for key in per)]
    if missing:
        raise AssertionError(f"{where}: the profiler recorded no "
                             f"{' / '.join(missing)} kernel")
    if _sort_kernels(per):
        raise AssertionError(f"{where} ran a sort on the card: "
                             f"{_sort_kernels(per)}")


def phase_kernel(qs, U, V, seed: int):
    """Kernel B1 (candidates) and B2 (merge) == their plain versions,
    exactly; the fused answer == the plain int8 path; then their times."""
    dev = qs.device
    rng = np.random.default_rng(seed + 1)
    checks = 0
    worst = worst_merge = 0.0

    def check(u_q, u_scale, vt, sv, ixs, k, tile, where, n_items=N_ITEMS):
        nonlocal checks, worst, worst_merge
        k_local = min(k, tile)
        kv, ki = topk_fused.score_mask_topk_candidates(
            u_q, u_scale, vt, sv, ixs, k_local=k_local, n_items=n_items,
            tile=tile)
        pv, pi = topk_fused.score_mask_topk_candidates_plain(
            u_q.index_select(0, ixs.long()),
            u_scale.index_select(0, ixs.long()), vt, sv, k_local=k_local,
            n_items=n_items, tile=tile)
        torch.cuda.synchronize()
        if not _same(kv, ki, pv, pi):
            bad = (kv.view(torch.int32) != pv.view(torch.int32)) | (ki != pi)
            raise AssertionError(
                f"B1 != plain at {where}: {int(bad.sum())} candidates "
                f"differ, first at {bad.nonzero()[:3].tolist()}")
        worst = max(worst, float((kv - pv).abs().max()))
        fv, fi = topk_fused.merge_candidates(kv, ki, k, k_local=k_local)
        mv, mi = topk_fused.merge_candidates_plain(kv, ki, k)
        torch.cuda.synchronize()
        if not _same(fv, fi, mv, mi):
            raise AssertionError(f"B2 != plain merge at {where}")
        worst_merge = max(worst_merge, float((fv - mv).abs().max()))
        # the merged answer against the plain int8 path (no tiles)
        xv, xi = quant.topk_for_users_quant(
            u_q, u_scale, vt, sv, ixs, k=k, n_items=n_items)
        if not _same(fv, fi, xv, xi):
            raise AssertionError(f"fused answer != plain int8 path at "
                                 f"{where}")
        checks += 1

    for b in BUCKETS:
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=b).astype(np.int32)).to(dev)
        for k in (1, 10, 100, TILE + 88, N_ITEMS):
            check(qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k, TILE,
                  f"b={b} k={k} tile={TILE}")
    # other tiles (PIO_SERVE_FUSED_TILE): 128, and 100, whose last lanes
    # hold no column and which takes B1's byte-load path
    for tile in (128, 100):
        n_pad = -(-N_ITEMS // tile) * tile
        vt = torch.zeros((RANK, n_pad), dtype=torch.int8, device=dev)
        vt[:, :N_ITEMS] = qs.vt_q[:, :N_ITEMS]
        sv = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
        sv[:N_ITEMS] = qs.v_scale[:N_ITEMS]
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=16).astype(np.int32)).to(dev)
        for k in (10, N_ITEMS):          # k_local 10, and k_local = tile
            check(qs.u_q, qs.u_scale, vt, sv, ixs, k, tile,
                  f"b=16 k={k} tile={tile}")
    # catalogs of more than 1,024 tiles (B2's wide form): the item columns
    # repeated, so every item ties with its copies in other tiles and
    # lanes; 7,940 tiles hold their heads in the global workspace
    wide = []
    for copies, tile in ((6, 128), (38, 512), (38, 128)):
        n_wide = copies * N_ITEMS
        n_pad = -(-n_wide // tile) * tile
        vt = torch.zeros((RANK, n_pad), dtype=torch.int8, device=dev)
        vt[:, :n_wide] = qs.vt_q[:, :N_ITEMS].repeat(1, copies)
        sv = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
        sv[:n_wide] = qs.v_scale[:N_ITEMS].repeat(copies)
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=16).astype(np.int32)).to(dev)
        for k in (10, TILE + 88):
            check(qs.u_q, qs.u_scale, vt, sv, ixs, k, tile,
                  f"b=16 k={k} tile={tile} n_items={n_wide}", n_items=n_wide)
        kv, ki = topk_fused.score_mask_topk_candidates(
            qs.u_q, qs.u_scale, vt, sv, ixs, k_local=10, n_items=n_wide,
            tile=tile)
        per, _wall = _device_profile(lambda: [
            topk_fused.merge_candidates(kv, ki, 10, k_local=10)
            for _ in range(10)])
        wide.append({"b": 16, "k": 10, "n_items": n_wide, "tile": tile,
                     "n_tiles": n_pad // tile,
                     "merge_body_ms": _body_ms(per, "merge_tile_lists"),
                     "merge_plain_ms": _time_ms(
                         lambda: topk_fused.merge_candidates_plain(
                             kv, ki, 10), reps=20, warm=2)})
        print(f"kernel: B2 wide, {n_pad // tile} tiles of {tile} "
              f"({n_wide} items), b=16 k=10: device body "
              f"{wide[-1]['merge_body_ms']} ms, plain "
              f"{wide[-1]['merge_plain_ms']:.4f} ms", flush=True)
    # the clones of item 5 (tiles 0, 1, 26, 52) tie: index order
    ixs = torch.arange(64, dtype=torch.int32, device=dev)
    _v, fi = topk_fused.topk_for_users_quant_fused(
        qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k=N_ITEMS,
        n_items=N_ITEMS, tile=TILE)
    for row in fi.cpu().numpy():
        pos = [int(np.flatnonzero(row == c)[0])
               for c in _clones()]
        if pos != list(range(pos[0], pos[0] + 4)):
            raise AssertionError(f"cross-tile tie out of order: {pos}")
    print(f"kernel: B1 == plain candidates, B2 == plain merge and the "
          f"fused answer == plain int8 path at {checks} (b, k, tile) "
          f"shapes, and the cross-tile tie; max |diff| B1 {worst}, B2 "
          f"{worst_merge}", flush=True)

    # times at every serving bucket, k = 10 (PIO_AOT_KS default)
    Ud = torch.from_numpy(quant.dequantize_rows(*quant.quantize_rows(U))
                          ).to(dev)
    Vd = torch.from_numpy(quant.dequantize_rows(*quant.quantize_rows(V))
                          ).to(dev)
    rows = []
    n_pad = qs.vt_q.shape[1]
    args = (qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale)
    for b in BUCKETS:
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=b).astype(np.int32)).to(dev)
        ixl = ixs.long()
        kv, ki = topk_fused.score_mask_topk_candidates(
            *args, ixs, k_local=10, n_items=N_ITEMS, tile=TILE)
        ms = _time_ms(lambda: topk_fused.score_mask_topk_candidates(
            *args, ixs, k_local=10, n_items=N_ITEMS, tile=TILE))
        plain_ms = _time_ms(
            lambda: topk_fused.score_mask_topk_candidates_plain(
                qs.u_q.index_select(0, ixl), qs.u_scale.index_select(0, ixl),
                qs.vt_q, qs.v_scale, k_local=10, n_items=N_ITEMS,
                tile=TILE), reps=50, warm=5)
        merge_ms = _time_ms(lambda: topk_fused.merge_candidates(
            kv, ki, 10, k_local=10))
        merge_plain_ms = _time_ms(
            lambda: topk_fused.merge_candidates_plain(kv, ki, 10))
        merge_library_ms = _time_ms(lambda: torch.topk(kv, 10))
        wrapper_ms = _time_ms(lambda: topk_fused.topk_for_users_quant_fused(
            *args, ixs, k=10, n_items=N_ITEMS, tile=TILE))
        library_ms = _time_ms(
            lambda: torch.topk(Ud.index_select(0, ixl) @ Vd.T, 10))
        bound_ms, bound_by = _topk_fused_bound_ms(b, RANK, n_pad, TILE, 10)
        merge_bound_ms, merge_bound_by = _merge_bound_ms(
            b, kv.shape[1], 10)
        # the kernels' bodies alone, without the wrapper's host time
        per, _wall = _device_profile(lambda: [
            topk_fused.topk_for_users_quant_fused(
                *args, ixs, k=10, n_items=N_ITEMS, tile=TILE)
            for _ in range(50)])
        _require_kernels(per, "the fused path")
        body_ms = _body_ms(per, "score_mask_topk")
        merge_body_ms = _body_ms(per, "merge_tile_lists")
        # B1 with one selection round: the loads and dot products alone
        per1, _wall = _device_profile(lambda: [
            topk_fused.score_mask_topk_candidates(
                *args, ixs, k_local=1, n_items=N_ITEMS, tile=TILE)
            for _ in range(50)])
        body_k1_ms = _body_ms(per1, "score_mask_topk")
        rows.append({"b": b, "k": 10, "ms": ms, "body_ms": body_ms,
                     "body_k_local_1_ms": body_k1_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "merge_ms": merge_ms, "merge_body_ms": merge_body_ms,
                     "merge_plain_ms": merge_plain_ms,
                     "merge_library_ms": merge_library_ms,
                     "merge_bound_ms": merge_bound_ms,
                     "merge_bound_by": merge_bound_by,
                     "wrapper_ms": wrapper_ms})

        def fmt(x):
            return f"{x:.4f} ms" if x is not None else "not measured"

        print(f"kernel: B1 b={b} k=10 call {ms:.4f} ms (device body "
              f"{fmt(body_ms)}; {fmt(body_k1_ms)} at k_local 1), plain {plain_ms:.4f} ms, fp32 "
              f"matmul+topk {library_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}); B2 call "
              f"{merge_ms:.4f} ms (device body {fmt(merge_body_ms)}), "
              f"plain {merge_plain_ms:.4f} ms, torch.topk of the "
              f"candidates {merge_library_ms:.4f} ms, bound "
              f"{merge_bound_ms * 1e3:.3f} us ({merge_bound_by}); B1 + B2 "
              f"{wrapper_ms:.4f} ms", flush=True)
    # B2 against the sort it replaced, over k (k_local = min(k, tile)):
    # one serial round per answer entry, so B2 loses past some k
    large = []
    for b in (1, 64):
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=b).astype(np.int32)).to(dev)
        for k in (100, 300, TILE + 88, 1000, 3000, N_ITEMS):
            k_local = min(k, TILE)
            kv, ki = topk_fused.score_mask_topk_candidates(
                *args, ixs, k_local=k_local, n_items=N_ITEMS, tile=TILE)
            merge_ms = _time_ms(lambda: topk_fused.merge_candidates(
                kv, ki, k, k_local=k_local), reps=10, warm=2)
            # B2's body and the sort path's device time, in one session
            per, _wall = _device_profile(lambda: [
                (topk_fused.merge_candidates(kv, ki, k, k_local=k_local),
                 topk_fused.merge_candidates_plain(kv, ki, k))
                for _ in range(3)])
            body = _body_ms(per, "merge_tile_lists")
            plain_body = sum(us for key, (us, _n) in per.items()
                             if "merge_tile_lists" not in key) / 3 / 1e3
            plain = _time_ms(lambda: topk_fused.merge_candidates_plain(
                kv, ki, k), reps=10, warm=2)
            bound, _by = _merge_bound_ms(b, kv.shape[1], k)
            large.append({"b": b, "k": k, "k_local": k_local,
                          "merge_ms": merge_ms, "merge_body_ms": body,
                          "merge_plain_ms": plain,
                          "merge_plain_device_ms": plain_body,
                          "merge_bound_ms": bound})
            print(f"kernel: B2 b={b} k={k} (k_local {k_local}) call "
                  f"{merge_ms:.4f} ms (device body "
                  f"{body if body is None else f'{body:.4f}'} ms), plain "
                  f"{plain:.4f} ms (device {plain_body:.4f} ms), bound "
                  f"{bound * 1e3:.3f} us (bytes)", flush=True)
    # a flush of 16 rows runs at the largest num asked: the device time of
    # B1 + B2 (and of B1 + the sort it replaced) when every request asks
    # k = 10, and when one of them asks for the whole catalog
    ixs = torch.from_numpy(
        rng.integers(0, N_USERS, size=16).astype(np.int32)).to(dev)

    def old_path(k):
        k_local = min(k, TILE)
        return topk_fused.merge_candidates_plain(
            *topk_fused.score_mask_topk_candidates(
                *args, ixs, k_local=k_local, n_items=N_ITEMS, tile=TILE), k)

    mixed = {}
    for k in (10, N_ITEMS):
        mixed[f"k{k}_device_ms"] = _device_ms(
            lambda: topk_fused.topk_for_users_quant_fused(
                *args, ixs, k=k, n_items=N_ITEMS, tile=TILE), 3)
        mixed[f"k{k}_sort_path_device_ms"] = _device_ms(
            lambda: old_path(k), 3)
    print(f"kernel: a flush of 16 rows, device ms per flush: B1 + B2 "
          f"{mixed['k10_device_ms']:.4f} at k=10, "
          f"{mixed[f'k{N_ITEMS}_device_ms']:.4f} with one k={N_ITEMS} "
          f"request; B1 + sort {mixed['k10_sort_path_device_ms']:.4f} / "
          f"{mixed[f'k{N_ITEMS}_sort_path_device_ms']:.4f}", flush=True)
    return rows, large, wide, mixed, worst, worst_merge


def _solve_systems(n: int, r: int, seed: int, inner=None):
    """(A, b, reg): A = F F^T, F of width ``inner`` (r + 2: well posed;
    3 < r: the reference's marginal rank-3 batch,
    tests/test_als.py TestPallasSolver.systems)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, r, inner or r + 2)).astype(np.float32)
    A = np.matmul(F, F.transpose(0, 2, 1))
    b = rng.normal(size=(n, r)).astype(np.float32)
    reg = rng.uniform(0.05, 0.5, n).astype(np.float32)
    return A, b, reg


def _indefinite_systems():
    """tests/test_als.py::test_solve_factors_clamps_indefinite_rows: an
    SPD batch with three rows pushed indefinite far beyond the ridge."""
    rng = np.random.default_rng(0)
    r, n = 6, 64
    M = rng.normal(0, 1, (n, r, r)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", M, M)
    for row in (3, 17, 40):
        v = rng.normal(0, 1, r).astype(np.float32)
        A[row] -= 3.0 * np.linalg.norm(A[row]) * np.outer(v, v) \
            / np.dot(v, v)
    b = rng.normal(0, 1, (n, r)).astype(np.float32)
    return A.astype(np.float32), b, np.full(n, 0.05, np.float32)


def _solve_bound_ms(n: int, r: int) -> tuple:
    """Least time for n solves: A, b and reg read once and x written
    once, against the fp32 operations the elimination needs (per pivot
    k: r - k divisions, and a multiply and a subtract for each of the
    r - k live columns of the r - 1 other rows; r adds of reg). The
    bit-identity contract with the eager plain version forbids FMAs, so
    each unfused multiply or subtract is one issue of the fp32 pipe, at
    FP32_UNFUSED_OPS_S (the 67e12 peak counts an FMA as two operations).
    Bytes bind at every shape phase 4 times."""
    bytes_moved = n * (r * r * 4 + r * 4 + 4 + r * 4)
    ops = n * (sum((r - k) * (1 + 2 * (r - 1)) for k in range(r)) + r)
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = ops / FP32_UNFUSED_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bitwise_same(x, p):
    """x and p equal bit for bit (NaN payloads aside)."""
    return (x.view(torch.int32) == p.view(torch.int32)) | (
        torch.isnan(x) & torch.isnan(p))


#: phase 4's timed (n, r) beyond users / items: the eval's user (6,900)
#: and item (26,744) half-steps and the ML-20M user half-step (138,493),
#: at the grid's ranks and the kernel's top rank
SOLVE_SIZES = (6_900, 26_744, N_USERS)
SOLVE_RANKS = (5, 10, 20, 32)
#: the exactness sweep's batch: odd, so every layout has a tail group
SOLVE_SWEEP_N = 257


def phase_solve(seed: int, dev: torch.device):
    """solve_gj kernel == plain version, bit for bit, at every rank 1..32
    and at every timed shape; then the timed shapes' numbers."""
    sweep_worst = 0.0
    for r in range(1, solve.MAX_RANK + 1):
        A, b, reg = (torch.from_numpy(x).to(dev) for x in _solve_systems(
            SOLVE_SWEEP_N, r, seed + 100 + r))
        x = solve.solve_factors(A, b, reg)
        p = solve.solve_gj_plain(A, b, reg)
        torch.cuda.synchronize()
        same = _bitwise_same(x, p)
        if not bool(same.all()):
            raise AssertionError(
                f"solve_gj kernel != plain at n={SOLVE_SWEEP_N}, r={r}: "
                f"{int((~same).sum())} values differ, first at "
                f"{(~same).nonzero()[:3].tolist()}")
        sweep_worst = max(sweep_worst, float((x - p).abs().max()))
    print(f"kernel: solve_gj == plain bit for bit at every rank 1.."
          f"{solve.MAX_RANK} (n={SOLVE_SWEEP_N}; max |diff| {sweep_worst})",
          flush=True)
    shapes = [("users", (N_USERS, RANK, seed + 10)),
              ("items", (N_ITEMS, RANK, seed + 11)),
              ("r1", (700, 1, seed + 12)),
              ("r16", (700, 16, seed + 13)),
              ("r32", (700, 32, seed + 14)),
              ("marginal rank-3", (700, 10, 0, 3)),
              ("indefinite", None)]
    for i, (n, r) in enumerate((n, r) for n in SOLVE_SIZES
                               for r in SOLVE_RANKS):
        if (n, r) not in ((N_USERS, RANK), (N_ITEMS, RANK)):
            shapes.append((f"n{n} r{r}", (n, r, seed + 20 + i)))
    rows = []
    worst = sweep_worst
    for name, args in shapes:
        host = _indefinite_systems() if args is None else \
            _solve_systems(*args)
        A, b, reg = (torch.from_numpy(x).to(dev) for x in host)
        del host
        n, r = b.shape
        x = solve.solve_factors(A, b, reg)
        p = solve.solve_gj_plain(A, b, reg)
        torch.cuda.synchronize()
        same = _bitwise_same(x, p)
        if not bool(same.all()):
            raise AssertionError(
                f"solve_gj kernel != plain at {name} (n={n}, r={r}): "
                f"{int((~same).sum())} values differ, first at "
                f"{(~same).nonzero()[:3].tolist()}")
        diff = float((x - p).abs().max()) if n else 0.0
        worst = max(worst, diff)
        if not bool(torch.isfinite(x).all().cpu()):
            raise AssertionError(f"solve_gj gave non-finite x at {name}")
        if name == "indefinite" and float(x.abs().max()) >= \
                float(b.abs().max()) * (2 / 0.05) * r:
            raise AssertionError("the pivot floor did not bound the "
                                 "indefinite batch")
        del x, p
        rows.append({**_solve_row(name, A, b, reg), "max_abs_err": diff})
        row = rows[-1]
        body_s = (f"{row['body_ms']:.4f} ms" if row["body_ms"] is not None
                  else "not measured")
        print(f"kernel: solve_gj {name} n={n} r={r} == plain (max |diff| "
              f"{diff}); call {row['ms']:.4f} ms (device body {body_s}), "
              f"plain {row['plain_ms']:.4f} ms, torch.linalg.solve "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
        del A, b, reg
        torch.cuda.empty_cache()
    return rows, worst


#: phase 4b's configurations: the benchmark's two (pio_bench/configs)
GRAM_CELLS = ("ml20m-als-r20", "netflix-als-r32")
#: kernel G against the plain Gram: each element of A and b within this
#: share of the sum of its terms' magnitudes (the two sum the same fp32
#: products in other orders; tests/test_torch_gram_fused_card.py)
GRAM_TOL = 2.0 ** -14
GRAM_CHUNK = 1 << 18


def _gram_gap(got, want, mag) -> float:
    """The largest |got - want| over the sum of the terms' magnitudes."""
    return float(((got - want).abs() / mag.clamp(min=1e-30)).max())


def _same_bits(*pairs) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs)


def _gram_check(where: str, other, self_idx, other_idx, ca, cb,
                n_self: int, pieces, chunks=None) -> float:
    """Kernel G over ``pieces`` (None: the plan built on the device)
    against the plain Gram on the same inputs: within GRAM_TOL of the sum
    of the terms' magnitudes, a rerun bit for bit, A symmetric. Returns
    the largest gap."""
    args = (self_idx, other_idx)
    G, Gb = als.gram_rhs(other, *args, ca, cb, n_self, GRAM_CHUNK, pieces)
    G2, Gb2 = als.gram_rhs(other, *args, ca, cb, n_self, GRAM_CHUNK,
                           pieces)
    P, Pb = als.gram_rhs_plain(other, *args, ca, cb, n_self, GRAM_CHUNK,
                               chunks)
    M, Mb = als.gram_rhs_plain(other.abs(), *args, ca.abs(), cb.abs(),
                               n_self, GRAM_CHUNK, chunks)
    torch.cuda.synchronize()
    gap = max(_gram_gap(G, P, M), _gram_gap(Gb, Pb, Mb))
    same = _same_bits((G, G2), (Gb, Gb2))
    symmetric = torch.equal(G, G.transpose(1, 2))
    del G, Gb, G2, Gb2, P, Pb, M, Mb
    if gap > GRAM_TOL or not same or not symmetric:
        raise AssertionError(
            f"gram_fused at {where}: largest gap to the plain Gram {gap} "
            f"(limit {GRAM_TOL}), rerun bit for bit {same}, A symmetric "
            f"{symmetric}")
    return gap


def phase_gram(seed: int, dev: torch.device):
    """Kernel G (``ops/gram_fused.py``) against the plain Gram at the
    benchmark's two configurations, both sides, on the seed's ratings:
    within GRAM_TOL and a rerun bit for bit; then the call, its device
    body and the plain version, beside ``pio_bench/roofline/gram.py``'s
    bound."""
    from pio_bench import data as bench_data
    from pio_bench.roofline import gram as gram_bound

    peaks = {"fp32_flops_s": FP32_OPS_S, "hbm_bytes_s": HBM_BYTES_S}
    rows = []
    for name in GRAM_CELLS:
        with open(os.path.join(_REPO, "pio_bench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        rank = int(cfg["rank"])
        (u, i, rt), (U, V) = bench_data.inputs(cfg, seed + 2 ** 31, dev)
        data = als.prepare_ratings(u, i, rt, int(cfg["n_users"]),
                                   int(cfg["n_items"]), on_device=True,
                                   device=dev)
        del u, i, rt
        for side_name, side, other in (("users", data.by_user, V),
                                       ("items", data.by_item, U)):
            s = als._device_side(side, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pieces = gram_fused.plan(s.self_idx, s.n_self)
            plan_s = time.perf_counter() - t0
            present = (s.self_idx < s.n_self).to(torch.float32)
            args = (other, s.self_idx, s.other_idx, present, s.rating,
                    s.n_self, GRAM_CHUNK)
            chunks = als.gram_plan(s.self_idx, GRAM_CHUNK)

            def call():
                return als.gram_rhs(*args, pieces)

            def plain():
                return als.gram_rhs_plain(*args, chunks)

            gap = _gram_check(f"{name} {side_name}", other, s.self_idx,
                              s.other_idx, present, s.rating, s.n_self,
                              pieces, chunks)
            per, _wall = _device_profile(lambda: [call() for _ in range(5)])
            body = [us for key, (us, _n) in per.items() if "gram_" in key]
            n = int(data.nnz)
            n_other = int(other.shape[0])
            row = {"cell": name, "side": side_name, "n": n,
                   "n_self": s.n_self, "n_other": n_other, "r": rank,
                   "pieces": pieces.pieces, "multi_rows": pieces.multi,
                   "launches": gram_fused.launches_per_gram(pieces),
                   "plan_s": plan_s, "max_gap": gap,
                   "ms": _time_ms(call, reps=20, warm=3),
                   "body_ms": sum(body) / 5 / 1e3 if body else None,
                   "plain_ms": _time_ms(plain, reps=3, warm=1),
                   "bound_ms": gram_bound.least_s(n, s.n_self, n_other,
                                                  rank, peaks) * 1e3,
                   "bound_by": gram_bound.bound_by(n, s.n_self, n_other,
                                                   rank, peaks)}
            rows.append(row)
            body_s = (f"{row['body_ms']:.4f} ms" if row["body_ms"]
                      is not None else "not measured")
            print(f"kernel: gram_fused {name} {side_name} ({n} ratings, "
                  f"{s.n_self} rows, r={rank}, {row['pieces']} pieces, "
                  f"{row['multi_rows']} rows of several) == plain within "
                  f"{gap:.3g} of the magnitudes (limit {GRAM_TOL:.3g}), a "
                  f"rerun bit for bit, A symmetric; call {row['ms']:.4f} "
                  f"ms (device body {body_s}), plain {row['plain_ms']:.4f} "
                  f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}); "
                  f"plan {plan_s:.3f} s", flush=True)
            del s, present, args, chunks, pieces
            torch.cuda.empty_cache()
        del data, U, V
        torch.cuda.empty_cache()
    rows += _gram_foldin_rows(seed, dev)
    return rows


def _gram_foldin_rows(seed: int, dev: torch.device):
    """Kernel G as a fold-in tick runs it (``foldin.foldin_solve``): int64
    rows, ``other_idx = arange``, rank 10, at each bucket, with the tick's
    plan and with none, against the plain Gram; the tick's Gram timed
    with its plan built on the device, beside the plain version."""
    rng = np.random.default_rng(seed + 11)
    V = rng.normal(size=(N_ITEMS, FOLD_RANK)).astype(np.float32)
    rows = []
    for bucket in (1, 8, 64):
        t, s, o, present, rating, _counts = _fold_inputs(V, bucket, seed,
                                                         dev)
        nnz = int(s.shape[0])
        where = f"fold-in bucket {bucket}"
        gap = max(_gram_check(where + " (the tick's plan)", t, s, o,
                              present, rating, bucket,
                              foldin.tick_gram_plan(s, bucket)),
                  _gram_check(where + " (no plan)", t, s, o, present,
                              rating, bucket, None))

        def tick():
            return als.gram_rhs(t, s, o, present, rating, bucket, nnz,
                                foldin.tick_gram_plan(s, bucket))

        row = {"cell": "foldin", "side": f"bucket {bucket}", "n": nnz,
               "n_self": bucket, "r": FOLD_RANK,
               "launches": gram_fused.launches_per_gram(
                   foldin.tick_gram_plan(s, bucket)),
               "max_gap": gap, "ms": _time_ms(tick, reps=50, warm=5),
               "plain_ms": _time_ms(
                   lambda: als.gram_rhs_plain(t, s, o, present, rating,
                                              bucket, nnz), reps=20,
                   warm=3)}
        rows.append(row)
        print(f"kernel: gram_fused fold-in bucket {bucket} ({nnz} slots, "
              f"r={FOLD_RANK}, int64 rows) == plain within {gap:.3g} of the "
              f"magnitudes with the tick's plan and with none, a rerun bit "
              f"for bit, A symmetric; {row['launches']} launch a Gram; the "
              f"tick's Gram with its plan {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms", flush=True)
    return rows


def _rmse_and_iterations(td, model, params: dict, dev: torch.device,
                         profile: bool = True):
    """The RMSE of the seed factors and of the trained ``model`` on the
    ratings ``td`` (which must be encoded with the model's vocabularies),
    ms per ALS iteration from the trained factors, and one iteration under
    torch.profiler (skipped when ``profile`` is False)."""
    n_users, n_items = len(model.user_vocab), len(model.item_vocab)
    rank = params["rank"]
    data = als.prepare_ratings(td.user_idx, td.item_idx, td.rating,
                               n_users, n_items, on_device=True, device=dev)
    bu = data.by_user
    mask = (bu.self_idx < n_users).to(torch.float32)
    U0, V0 = als._seed_factors(params["seed"], n_users, n_items, rank,
                               device=dev)
    Ut = torch.from_numpy(model.user_factors).to(dev)
    Vt = torch.from_numpy(model.item_factors).to(dev)
    rmse0 = float(als.rmse(U0, V0, bu.self_idx, bu.other_idx, bu.rating,
                           mask))
    rmse1 = float(als.rmse(Ut, Vt, bu.self_idx, bu.other_idx, bu.rating,
                           mask))
    if not (np.isfinite(rmse1) and rmse1 < rmse0):
        raise AssertionError(f"RMSE {rmse0} -> {rmse1}: not finite and "
                             "falling")
    als.train_explicit(data, rank=rank, iterations=1, u0=Ut, v0=Vt,
                       lambda_=params["lambda"], device=dev)  # chunk plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    als.train_explicit(data, rank=rank, iterations=3, u0=Ut, v0=Vt,
                       lambda_=params["lambda"], device=dev)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / 3 * 1e3
    per, pwall = ({}, 0.0) if not profile else _device_profile(
        lambda: als.train_explicit(data, rank=rank, iterations=1, u0=Ut,
                                   v0=Vt, lambda_=params["lambda"],
                                   device=dev))
    return rmse0, rmse1, ms_iter, per, pwall


def _gram_train_layout(td, model, dev: torch.device):
    """Kernel G on the train's layout (ratings ``td``, encoded with the
    model's vocabularies) and the trained factors, both sides, against
    the plain Gram (:func:`_gram_check`); returns the largest gap and the
    kernel G launches one iteration of the train makes."""
    data = als.prepare_ratings(td.user_idx, td.item_idx, td.rating,
                               len(model.user_vocab), len(model.item_vocab),
                               on_device=True, device=dev)
    U = torch.from_numpy(model.user_factors).to(dev)
    V = torch.from_numpy(model.item_factors).to(dev)
    gap, per_iter = 0.0, 0
    for name, side, other in (("users", data.by_user, V),
                              ("items", data.by_item, U)):
        s = als._device_side(side, dev)
        pieces = gram_fused.plan(s.self_idx, s.n_self)
        per_iter += gram_fused.launches_per_gram(pieces)
        gap = max(gap, _gram_check(
            f"the train's layout, {name} (r={other.shape[1]})", other,
            s.self_idx, s.other_idx, (s.self_idx < s.n_self).float(),
            s.rating, s.n_self, pieces,
            als.gram_plan(s.self_idx, GRAM_CHUNK)))
        del s, pieces
    del data, U, V
    torch.cuda.empty_cache()
    return gap, per_iter


def phase_train(work: str, seed: int, dev: torch.device):
    """``pio train --synthetic 20000263`` through the port's CLI, twice
    from one seed; returns the stored instance and the run's numbers."""
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    shutil.copy(ENGINE_JSON, engine_dir)
    with open(ENGINE_JSON) as f:
        params = json.load(f)["algorithms"][0]["params"]
    iters, rank = params["numIterations"], params["rank"]
    env = _store_env(work)
    argv = ["train", "--engine-dir", engine_dir, "--synthetic",
            str(N_RATINGS), "--synthetic-seed", str(seed)]

    solve.reset_launches()               # the train path starts here
    topk_fused.reset_launches()
    gram_fused.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = solve.launches            # the train path ends here
    gram_launches = gram_fused.launches
    if rc != 0:
        raise AssertionError(f"pio train exited {rc}")
    if launches != 2 * iters:
        raise AssertionError(f"solve_gj launched {launches} times in "
                             f"{iters} iterations (want {2 * iters})")
    store = storage_mod.Storage(env=env)
    instances = store.get_meta_data_engine_instances()
    (row,) = instances.get_all()
    if row.status != "COMPLETED":
        raise AssertionError(f"train left the instance {row.status}")
    (model,) = model_io.deserialize_models(
        store.get_model_data_models().get(row.id).models)
    phases = {k[len("phase_"):-len("_s")]: float(v)
              for k, v in row.runtime_conf.items()
              if k.startswith("phase_")}
    n_users, n_items = len(model.user_vocab), len(model.item_vocab)

    # the same seed again, in-core (PIO_TRAIN_STREAM=off) and with no
    # cached layout: the streamed train's model, bit for bit
    als_algorithm._BIG_LAYOUT_CACHE.clear()
    os.environ["PIO_TRAIN_STREAM"] = "off"
    try:
        if cli.main(argv) != 0:
            raise AssertionError("the second pio train failed")
    finally:
        os.environ.pop("PIO_TRAIN_STREAM", None)
    (row2,) = [r for r in instances.get_all() if r.id != row.id]
    (model2,) = model_io.deserialize_models(
        store.get_model_data_models().get(row2.id).models)
    for a, b in ((model.user_factors, model2.user_factors),
                 (model.item_factors, model2.item_factors)):
        if a.tobytes() != b.tobytes():
            raise AssertionError("two trains from one seed, streamed and "
                                 "in-core, differ")

    # RMSE, ms per iteration and idle share on the same synthetic data
    td = synthetic.training_data(N_RATINGS, seed=seed, stream=False,
                                 device=dev)
    gram_gap, gram_per_iter = _gram_train_layout(td, model, dev)
    # one kernel G a half-step, and its finishing pass on a side with a
    # row of several pieces
    if gram_launches != iters * gram_per_iter:
        raise AssertionError(f"gram_fused launched {gram_launches} times "
                             f"in {iters} iterations (want "
                             f"{iters * gram_per_iter})")
    rmse0, rmse1, ms_iter, per, pwall = _rmse_and_iterations(
        td, model, params, dev)
    busy_ms = sum(us for us, _n in per.values()) / 1e3
    idle = 1 - busy_ms / (pwall * 1e3) if per else None
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    out = {"ratings": td.n, "users": n_users, "items": n_items,
           "rank": rank, "iterations": iters, "wall_s": wall,
           "phases_s": phases, "ms_per_iteration": ms_iter,
           "rmse_before": rmse0, "rmse_after": rmse1,
           "solve_gj_launches": launches,
           "gram_fused_launches": gram_launches,
           "gram_fused_max_gap": gram_gap,
           "bit_identical_retrain": True,
           "profiled_iteration_ms": pwall * 1e3,
           "device_busy_ms": busy_ms if per else None,
           "idle_share": idle,
           "top_device": [[k[:60], us, cnt] for k, (us, cnt) in top]}
    print(f"train: {td.n} ratings, {n_users} users x {n_items} items, "
          f"rank {rank}, {iters} iterations; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; {ms_iter:.1f} ms per iteration; RMSE {rmse0:.4f} -> "
          f"{rmse1:.4f}; solve_gj launched {launches} times, gram_fused "
          f"{gram_launches} (== plain within {gram_gap:.3g} on this "
          "layout); the second "
          "train from the seed, in-core, is bit-identical", flush=True)
    idle_s = (f"{idle:.4f}" if idle is not None
              else "not measured (no device events recorded)")
    print(f"train: one profiled iteration, wall {pwall * 1e3:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {idle_s}; top "
          "device entries " + "; ".join(
              f"{k[:60]} {us / 1e3:.2f} ms x{cnt}"
              for k, (us, cnt) in top), flush=True)
    print("train: " + json.dumps(out), flush=True)
    users = list(model.user_vocab.to_dict())
    return store, row.id, users, out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, user: str, num: int, trace: str = ""):
    """POST /queries.json; returns (status, JSON, seconds, raw bytes).
    ``trace`` names the request's trace id (an ``X-PIO-Trace`` header the
    server adopts)."""
    body = json.dumps({"user": user, "num": num}).encode()
    headers = {"Content-Type": "application/json"}
    if trace:
        headers["X-PIO-Trace"] = f"{trace}-0"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=body, method="POST",
        headers=headers)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=60) as r:
        status, payload = r.status, r.read()
    return status, json.loads(payload), time.perf_counter() - t0, payload


def _pct(seconds) -> tuple:
    """p50 and p99 of a list of seconds, in ms."""
    ms = [x * 1e3 for x in seconds]
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def _wait_ready(port: int, alive, deadline_s: float = 120.0) -> float:
    """Poll GET /readyz until 200; returns the seconds it took."""
    t0 = time.perf_counter()
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except OSError:
            if not alive() or time.perf_counter() - t0 > deadline_s:
                raise
            time.sleep(0.05)


def _path_queries(users, seed: int):
    """The serving path's traffic: 64 sequential queries (nums 1 to
    1000), 64 concurrent ones and 32 profiled ones, from ``seed``."""
    rng = np.random.default_rng(seed + 2)
    nums = [1, 4, 10, 10, 100, 10, 600, 10, 10, 2, 10, 50, 10, 10, 1000, 10]
    seq = [(users[u], nums[i % len(nums)])
           for i, u in enumerate(rng.integers(0, len(users), size=64))]
    burst = [(users[u], 10) for u in rng.integers(0, len(users), size=64)]
    profiled = [(users[u], 10)
                for u in rng.integers(0, len(users), size=32)]
    return seq, burst, profiled


def phase_path(store, iid: str, users, seed: int):
    """The trained instance deployed, answering POST /queries.json on the
    card; returns the launches, the device split and the answers' bytes
    with the client latencies, which the observe phase is held to."""
    seq, burst, profiled = _path_queries(users, seed)

    t0 = time.perf_counter()
    api = create_server.QueryAPI(
        create_server.ServerConfig(serve_quant="on", engine_instance_id=iid),
        storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    _wait_ready(port, server.is_alive, deadline_s=300)
    ready_s = time.perf_counter() - t0
    # the deploy's warm-up launched B1 + B2 once per bucket before
    # ready; the serving path starts here
    topk_fused.reset_launches()
    solve.reset_launches()
    answers = {}
    seq_lat, burst_lat = [], []

    def sequential(queries, lat):
        for u, n in queries:
            status, payload, dt_s, raw = _post(port, u, n)
            answers.setdefault((u, n), []).append((status, payload, raw))
            lat.append(dt_s)

    try:
        sequential(seq, seq_lat)
        with ThreadPoolExecutor(max_workers=16) as pool:
            for (u, n), (status, payload, dt_s, raw) in zip(burst, pool.map(
                    lambda q: _post(port, q[0], q[1]), burst)):
                answers.setdefault((u, n), []).append((status, payload, raw))
                burst_lat.append(dt_s)
        unprofiled = api.handle("GET", "/")[1]["batching"]["batches"]
        # where a sequential request's time goes: device time under the
        # profiler (which slows the host, so no latency is read here)
        per, wall = _device_profile(lambda: sequential(profiled, []))
        stats = api.handle("GET", "/")[1]
    finally:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/stop", data=b"", method="POST"),
            timeout=30).close()
        server.join(timeout=60)
    launches = topk_fused.launches       # the serving path ends here
    merge_launches = topk_fused.merge_launches
    if solve.launches:
        raise AssertionError("the serving path launched solve_gj")
    if server.is_alive():
        raise AssertionError("the server did not stop")

    flushes = stats["batching"]["batches"]
    if stats["quant"] is None or not stats["quant"].get("fused"):
        raise AssertionError(f"deploy did not take the fused path: {stats}")
    if flushes == 0 or launches != flushes or merge_launches != flushes:
        raise AssertionError(
            f"B1 launched {launches} times and B2 {merge_launches} times "
            f"for {flushes} flushes (want one each per flush)")
    _require_kernels(per, "the serving path")

    # every answer against the plain int8 path on the same factors
    model = api.models[0]
    qs = model.quant
    n_items = len(model.item_vocab)
    inv = model.item_vocab.inverse()
    for (u, n), got in answers.items():
        k = min(n, n_items)
        vals, idx = quant.topk_for_users_quant(
            qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale,
            torch.tensor([model.user_vocab(u)], dtype=torch.int32,
                         device=qs.device), k=k, n_items=n_items)
        want = {"itemScores": [{"item": inv(int(i)), "score": float(s)}
                               for s, i in zip(vals[0].cpu().numpy(),
                                               idx[0].cpu().numpy())]}
        for status, payload, _raw in got:
            if status != 200 or payload != want:
                raise AssertionError(f"answer for {u} num={n} differs "
                                     "from the plain int8 path")
            if not all(np.isfinite(s["score"])
                       for s in payload["itemScores"]):
                raise AssertionError("non-finite score served")
    b = stats["batching"]
    print(f"path: {len(seq) + len(burst) + len(profiled)} requests "
          f"({len(seq)} sequential, {len(burst)} from 16 client threads, "
          f"{len(profiled)} profiled) in {flushes} flushes "
          f"({unprofiled} before the profiled ones) {b['batchSizeHist']}, "
          f"B1 launched {launches} times and B2 {merge_launches} times; "
          f"all answers equal the plain int8 path", flush=True)
    print(f"path: time to ready {ready_s:.3f} s (load + quantize + layout "
          f"{api.time_to_ready_s:.3f} s)", flush=True)
    print("path: latency sequential p50 %.3f ms p99 %.3f ms; concurrent "
          "p50 %.3f ms p99 %.3f ms; avg flush %.3f ms, avg queue wait "
          "%.3f ms" % (*_pct(seq_lat), *_pct(burst_lat), b["avgFlushMs"],
                       b["avgQueueWaitMs"]), flush=True)
    busy_us = sum(us for us, _n in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    split = {"requests": len(profiled), "wall_ms": wall * 1e3,
             "device_busy_us": busy_us,
             "idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
             "B1_us": sum(us for k, (us, _n) in per.items()
                          if "score_mask_topk" in k),
             "B2_us": sum(us for k, (us, _n) in per.items()
                          if "merge_tile_lists" in k),
             "top": [[k[:60], us, n] for k, (us, n) in top]}
    print(f"path: profiled {len(profiled)} sequential requests: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"(idle share {split['idle_share']:.4f}), B1 "
          f"{split['B1_us']:.1f} us, B2 {split['B2_us']:.1f} us, no "
          "sort kernel; top device entries " + "; ".join(
              f"{k[:60]} {us:.1f} us x{n}" for k, (us, n) in top),
          flush=True)
    raw = {q: got[0][2] for q, got in answers.items()}
    if any(r != raw[q] for q, got in answers.items() for _s, _p, r in got):
        raise AssertionError("one query answered with different bytes")
    served = {"raw": raw, "seq_lat": seq_lat, "burst_lat": burst_lat}
    return launches, merge_launches, split, served


#: the deploy's observability knobs in the observe phase; the slow ring
#: holds every request of the phase, and the watchdog arms after 8
#: flushes (the span ring keeps its 512 spans: it is sized at import)
OBSERVE_ENV = {"PIO_TELEMETRY": "1", "PIO_TRACE": "1", "PIO_WATERFALL": "1",
               "PIO_JOURNAL": "1", "PIO_SLOW_RING": "512",
               "PIO_SERVE_WARMUP_FLUSHES": "8"}
#: the waterfall's top-level stages (their sum is at most the total) and
#: the two that nest inside ``dispatch``
TOP_STAGES = ("admission", "supplement", "dispatch", "merge", "serialize")
NESTED_STAGES = ("pad", "execute")
OBSERVE_SYNTHETIC = 200_000
OBSERVE_TICK_S = 0.25           # the flight recorder's tick in the phase
HISTORY_QUERIES = 8             # serves the recorder's deltas must count


def _get(port: int, path: str, method: str = "GET"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=b"" if method == "POST" else None)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _samples(text: str, name: str) -> dict:
    """{label string: value} of one family's samples in an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _sp, value = line.rpartition(" ")
            out[key[len(name):]] = float(value)
    return out


def _trace_events(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _launch_tids(events, name: str) -> tuple:
    """(kernel events whose name holds ``name``, the thread ids of their
    runtime launches)."""
    kernels = [e for e in events
               if e.get("cat") == "kernel" and name in e.get("name", "")]
    corr = {e.get("args", {}).get("correlation") for e in kernels}
    tids = {e["tid"] for e in events if e.get("cat") == "cuda_runtime"
            and e.get("args", {}).get("correlation") in corr}
    return kernels, tids


def _live_profile(port: int, api, users, seed: int, dev: torch.device,
                  attempts: int = 3):
    """POST /debug/profile?ms=1000 while 32 sequential queries run, with
    a marker kernel launched from this thread halfway through; the
    capture must hold B1 and B2 once per flush of the window, launched
    by one thread, not this one. A capture that recorded no kernel at
    all (the profiler drops a session now and then) is taken again."""
    rng = np.random.default_rng(seed + 5)
    queries = [(users[u], 10) for u in rng.integers(0, len(users), size=32)]
    for attempt in range(attempts):
        before = api.handle("GET", "/")[1]["batching"]["batches"]
        status, _ct, body = _get(port, "/debug/profile?ms=1000", "POST")
        if status != 202:
            raise AssertionError(f"POST /debug/profile answered {status}")
        capture = json.loads(body)["capture"]
        t0 = time.perf_counter()
        time.sleep(0.05)        # let the profiler's first buffers arm
        for i, (u, n) in enumerate(queries):
            if i == len(queries) // 2:
                marker = torch.full((1,), 1.0, device=dev).add_(1.0)
            if _post(port, u, n)[0] != 200:
                raise AssertionError("a profiled query failed")
        sent_s = time.perf_counter() - t0
        flushes = api.handle("GET", "/")[1]["batching"]["batches"] - before
        float(marker.cpu()[0])
        done = None
        deadline = time.perf_counter() + 60
        while done is None and time.perf_counter() < deadline:
            time.sleep(0.1)
            listing = json.loads(_get(port, "/debug/profile")[2])
            done = next((c for c in listing["captures"]
                         if c["id"] == capture["id"]), None)
        if done is None or done["state"] != "done" or not done["bytes"]:
            raise AssertionError(f"the capture did not finish: {done}")
        events = _trace_events(os.path.join(done["dir"], "trace.json"))
        b1, b1_tids = _launch_tids(events, "score_mask_topk")
        b2, b2_tids = _launch_tids(events, "merge_tile_lists")
        if not b1 and not b2 and attempt + 1 < attempts:
            print(f"observe: capture {attempt + 1} recorded no kernel; "
                  "taking it again", flush=True)
            continue
        marks, mark_tids = _launch_tids(events, "elementwise")
        # every flush of the window, give or take the one at each edge
        # when the queries outlast the window
        inside = (abs(len(b1) - flushes) <= 1 if sent_s < 0.9
                  else 0 < len(b1) <= flushes + 1)
        problem = None
        if not inside or abs(len(b2) - len(b1)) > 1:
            problem = (f"the capture holds B1 {len(b1)} and B2 {len(b2)} "
                       f"times for {flushes} flushes sent in {sent_s:.3f} s")
        elif len(b1_tids | b2_tids) != 1 or not mark_tids \
                or mark_tids & b1_tids:
            problem = (f"B1/B2 launched from threads {b1_tids | b2_tids}, "
                       f"the marker from {mark_tids}: want one thread, not "
                       "this one")
        if problem:
            names = {}
            for e in events:
                if e.get("cat") == "kernel":
                    names[e["name"][:70]] = names.get(e["name"][:70], 0) + 1
            raise AssertionError(f"{problem}; kernels {names}")
        worker = api._batcher._worker
        return {"attempts": attempt + 1, "state": done["state"],
                "files": done["files"], "bytes": done["bytes"],
                "durationMs": done["durationMs"], "queries": len(queries),
                "flushes": flushes, "B1_kernels": len(b1),
                "B2_kernels": len(b2), "launch_tid": sorted(b1_tids)[0],
                "marker_tid": sorted(mark_tids)[0],
                "worker_native_id": worker.native_id,
                "worker_ident": worker.ident, "sent_s": sent_s,
                "B1_device_us": sum(e["dur"] for e in b1),
                "B2_device_us": sum(e["dur"] for e in b2)}
    raise AssertionError("every capture recorded no kernel")


def _profiled_train(work: str, seed: int, attempts: int = 3) -> dict:
    """``pio train --synthetic 200000 --telemetry --profile DIR`` in
    process, on a store of its own: the Chrome trace must hold gj_solve
    exactly twice an iteration, with telemetry_phases.json beside it. A
    trace with no kernel at all is a dropped session and is taken again."""
    from predictionio_tpu_torch.common import telemetry

    with open(ENGINE_JSON) as f:
        iters = json.load(f)["algorithms"][0]["params"]["numIterations"]
    engine_dir = os.path.join(work, "observe_engine")
    os.makedirs(engine_dir, exist_ok=True)
    shutil.copy(ENGINE_JSON, engine_dir)
    saved = os.environ.get("PIO_FS_BASEDIR")
    os.environ["PIO_FS_BASEDIR"] = os.path.join(work, "observe_store")
    try:
        for attempt in range(attempts):
            prof_dir = os.path.join(work, f"train_profile_{attempt}")
            solve.reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["train", "--engine-dir", engine_dir,
                           "--synthetic", str(OBSERVE_SYNTHETIC),
                           "--synthetic-seed", str(seed), "--telemetry",
                           "--profile", prof_dir])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"pio train --profile exited {rc}")
            events = _trace_events(os.path.join(prof_dir, "trace.json"))
            gj = [e for e in events if e.get("cat") == "kernel"
                  and "gj_solve" in e.get("name", "")]
            if gj or attempt + 1 == attempts:
                break
            print(f"observe: profiled train {attempt + 1} recorded no "
                  "kernel; training again", flush=True)
    finally:
        if saved is None:
            os.environ.pop("PIO_FS_BASEDIR", None)
        else:
            os.environ["PIO_FS_BASEDIR"] = saved
    if len(gj) != 2 * iters or solve.launches != 2 * iters:
        raise AssertionError(
            f"the train's trace holds gj_solve {len(gj)} times and "
            f"solve_gj launched {solve.launches} times in {iters} "
            f"iterations (want {2 * iters})")
    with open(os.path.join(prof_dir, "telemetry_phases.json")) as f:
        phases = json.load(f)["phaseSeconds"]
    with open(os.path.join(prof_dir, "capture.json")) as f:
        capture = json.load(f)
    if capture["state"] != "done" or "train" not in phases:
        raise AssertionError(f"capture {capture}, phases {phases}")
    exposition = telemetry.registry().exposition()
    if 'pio_train_phase_seconds_count{phase="train"}' not in exposition:
        raise AssertionError("pio_train_phase_seconds has no train phase")
    return {"ratings": OBSERVE_SYNTHETIC, "iterations": iters,
            "attempts": attempt + 1, "gj_solve_kernels": len(gj),
            "gj_solve_device_us": sum(e["dur"] for e in gj),
            "wall_s": wall, "phases_s": phases,
            "trace_bytes": os.path.getsize(
                os.path.join(prof_dir, "trace.json"))}


def _stage_split(records, lat: dict) -> dict:
    """p50 / p99 in ms of each stage over ``records`` (slow-ring
    entries), with the total and the transport's share (the client's
    latency minus the server's total, joined on the trace id)."""
    out = {}
    for stage in TOP_STAGES + NESTED_STAGES:
        p50, p99 = _pct([r["stages"][stage] / 1e3 for r in records])
        out[stage] = {"p50": p50, "p99": p99}
    out["total"] = dict(zip(("p50", "p99"), _pct(
        [r["totalMs"] / 1e3 for r in records])))
    out["transport"] = dict(zip(("p50", "p99"), _pct(
        [lat[r["traceId"]] - r["totalMs"] / 1e3 for r in records])))
    out["client"] = dict(zip(("p50", "p99"), _pct(
        [lat[r["traceId"]] for r in records])))
    return out


def _history_serves(port: int, users, deadline_s: float = 15.0) -> dict:
    """Serves the flight recorder must see: once two sampler ticks have
    passed since the traffic created ``pio_serve_seconds`` (so a tick
    holds its baseline), HISTORY_QUERIES more queries, then poll
    /debug/history.json until its served-latency deltas count them (the
    sampler runs on its own clock)."""
    def history_json():
        return json.loads(_get(
            port, "/debug/history.json?series=pio_serve_seconds")[2])

    t0 = time.perf_counter()
    start = history_json()["ticksTotal"]
    while history_json()["ticksTotal"] < start + 2:
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError("the flight recorder stopped ticking")
        time.sleep(0.05)
    for u in users[:HISTORY_QUERIES]:
        if _post(port, u, 10)[0] != 200:
            raise AssertionError("a history query failed")
    while True:
        hist = history_json()
        seen = sum(v["count"] for e in hist["samples"]
                   for k, v in e["series"].items()
                   if k.startswith("pio_serve_seconds"))
        if seen >= HISTORY_QUERIES:
            return hist
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"the history (/debug/history.json) "
                                 f"counted {seen} of {HISTORY_QUERIES} "
                                 "serves")
        time.sleep(0.05)


def _slo_history_check(metrics: str, hist: dict) -> dict:
    """The SLO families on /metrics, the recorder's, and served-latency
    series on /debug/history.json."""
    families = ("pio_slo_latency_threshold_ms", "pio_slo_target",
                "pio_slo_error_budget_remaining", "pio_slo_burn_rate",
                "pio_history_ticks_total", "pio_history_series")
    missing = [f for f in families if not _samples(metrics, f)]
    observed = sum(v["count"] for e in hist.get("samples", ())
                   for k, v in e["series"].items()
                   if k.startswith("pio_serve_seconds"))
    if missing or not hist.get("enabled") or not hist.get("samples") \
            or observed <= 0:
        raise AssertionError(f"SLO / history: missing {missing}, history "
                             f"enabled {hist.get('enabled')}, "
                             f"{len(hist.get('samples', ()))} samples, "
                             f"{observed} serves in them")
    return {"families": list(families),
            "budget_remaining": _samples(
                metrics, "pio_slo_error_budget_remaining"),
            "history_samples": len(hist["samples"]),
            "history_ticks": hist["ticksTotal"],
            "serves_in_history": observed}


def phase_observe(work: str, store, iid: str, users, seed: int,
                  served: dict, dev: torch.device) -> dict:
    """Phase 5's instance deployed again with PIO_TELEMETRY, PIO_TRACE,
    PIO_WATERFALL and PIO_JOURNAL on: phase 6's traffic must get phase
    6's bytes, B1 and B2 once per flush, and the telemetry routes must
    account for every request; then a live /debug/profile capture and a
    profiled train."""
    from predictionio_tpu_torch.common import (
        devicewatch, history, journal, profiling, tracing, waterfall,
    )

    seq, burst, _profiled = _path_queries(users, seed)
    # a fresh flight recorder whose sampler ticks every OBSERVE_TICK_S
    # while the phase runs, so /metrics and /debug/history.json have its
    # series to show
    history.reset()
    history.install(history.HistoryConfig(tick_s=OBSERVE_TICK_S))
    saved = {k: os.environ.get(k) for k in
             (*OBSERVE_ENV, "PIO_PROFILE_DIR", "PIO_SYNTHETIC_EVENTS",
              "PIO_SYNTHETIC_SEED")}
    os.environ.update(OBSERVE_ENV)
    os.environ["PIO_PROFILE_DIR"] = os.path.join(work, "profiles")
    for mod in (journal, tracing, waterfall):
        mod.clear()
    devicewatch.reset_watchdog()
    profiling.reset()
    t_phase = time.perf_counter()
    try:
        api = create_server.QueryAPI(
            create_server.ServerConfig(serve_quant="on",
                                       engine_instance_id=iid),
            storage=store)
        port = _free_port()
        server = threading.Thread(target=create_server.serve,
                                  args=(api, "127.0.0.1", port), daemon=True)
        server.start()
        _wait_ready(port, server.is_alive, deadline_s=300)
        topk_fused.reset_launches()      # the observed path starts here,
        solve.reset_launches()           # after the deploy's warm-up
        tracing.clear()          # the readiness polls' spans
        lat, answers = {}, {}

        def one(tag, q):
            status, _payload, dt_s, raw = _post(port, q[0], q[1], trace=tag)
            lat[tag] = dt_s
            answers.setdefault(q, []).append((status, raw))

        try:
            for i, q in enumerate(seq):
                one(f"seq{i:04d}", q)
            with ThreadPoolExecutor(max_workers=16) as pool:
                list(pool.map(lambda iq: one(f"con{iq[0]:04d}", iq[1]),
                              enumerate(burst)))
            # read before the profiled queries push these spans out
            traces = json.loads(_get(port, "/traces.json?limit=1024")[2])
            live = _live_profile(port, api, users, seed, dev)
            hist = _history_serves(port, users)
            metrics = _get(port, "/metrics")[2].decode()
            slow = json.loads(_get(port, "/debug/slow.json?limit=1024")[2])
            device = json.loads(_get(port, "/debug/device.json")[2])
            events = json.loads(_get(port, "/debug/events.json")[2])
            stats = api.handle("GET", "/")[1]
        finally:
            api.drain()
            server.join(timeout=60)
        launches = topk_fused.launches   # the observed path ends here
        merge_launches = topk_fused.merge_launches
        if server.is_alive():
            raise AssertionError("the server did not stop")
        if solve.launches:
            raise AssertionError("the serving path launched solve_gj")

        # the same bytes as phase 6, with the knobs off, for every query
        for q, got in answers.items():
            for status, raw in got:
                if status != 200 or raw != served["raw"][q]:
                    raise AssertionError(
                        f"{q} answered differently with the knobs on")
        flushes = stats["batching"]["batches"]
        requests = stats["requestCount"]
        if launches != flushes or merge_launches != flushes:
            raise AssertionError(
                f"B1 launched {launches} times and B2 {merge_launches} "
                f"times for {flushes} flushes")

        # /metrics: one stage observation per request (admission,
        # serialize) or per flush (the flush-level stages)
        counts = {k.split('"')[1]: v for k, v in _samples(
            metrics, "pio_serve_stage_seconds_count").items()}
        want = {**{s: requests for s in ("admission", "serialize")},
                **{s: flushes for s in ("supplement", "dispatch", "merge")
                   + NESTED_STAGES}}
        if counts != want:
            raise AssertionError(f"stage counts {counts}, want {want}")
        served_n = sum(_samples(metrics, "pio_serve_seconds_count").values())
        if served_n != requests:
            raise AssertionError(f"pio_serve_seconds counted {served_n} "
                                 f"of {requests} requests")

        # /debug/slow.json: every request, every stage, within its total
        recs = slow["requests"]
        if len(recs) != requests:
            raise AssertionError(f"slow ring holds {len(recs)} of "
                                 f"{requests} requests")
        for r in recs:
            st = r["stages"]
            if set(st) != set(TOP_STAGES + NESTED_STAGES):
                raise AssertionError(f"stages {sorted(st)}")
            if sum(st[s] for s in TOP_STAGES) > r["totalMs"] + 0.005 \
                    or st["pad"] + st["execute"] > st["dispatch"] + 0.002:
                raise AssertionError(f"stages exceed their total: {r}")
            if r.get("details", {}).get("quant") != "int8":
                raise AssertionError(f"no int8 note: {r}")

        # /traces.json: server -> admission -> flush -> dispatch, one
        # trace id across the request and worker threads
        by_id = {t["traceId"]: t["spans"] for t in traces["traces"]}
        chains = 0
        for tag in lat:
            spans = by_id.get(tag)
            if spans is None:
                raise AssertionError(f"trace {tag} missing")
            named = {s["name"]: s for s in spans}
            root = named.get("server:/queries.json")
            if root is None or named.get("admission", {}).get(
                    "parentId") != root["spanId"]:
                raise AssertionError(f"trace {tag}: {spans}")
            if "flush" in named:
                if named["flush"]["parentId"] != root["spanId"] or \
                        named["dispatch"]["parentId"] != \
                        named["flush"]["spanId"]:
                    raise AssertionError(f"trace {tag}: {spans}")
                chains += 1
        if chains < len(seq):
            raise AssertionError(f"{chains} traces hold a flush chain")

        # /debug/device.json: the card's allocator, no post-warmup build
        wd = device["watchdog"]
        (card,) = device["devices"]
        ms = card["memoryStats"]
        if not (ms and ms["bytes_in_use"] > 0 and ms["bytes_limit"]
                == torch.cuda.get_device_properties(0).total_memory
                and ms["peak_bytes_in_use"] >= ms["bytes_in_use"]):
            raise AssertionError(f"HBM gauges {card}")
        hbm = _samples(metrics, "pio_hbm_bytes_in_use")
        if not wd["servingWarmupDone"] or wd["postWarmupRecompiles"] \
                or not hbm or sum(_samples(
                    metrics, "pio_xla_post_warmup_recompiles_total"
                ).values()):
            raise AssertionError(f"watchdog {wd}, HBM lines {hbm}")

        # the SLO engine and the flight recorder on /metrics, and series
        # on /debug/history.json
        slo_history = _slo_history_check(metrics, hist)

        # /debug/events.json and the drain: the deploy's lifecycle
        live_ev = [e["message"] for e in events["events"]]
        drain_ev = [e["message"] for e in journal.snapshot()["events"]]
        if not any(iid in m for m in live_ev) or not any(
                m.startswith("drain complete") for m in drain_ev):
            raise AssertionError(f"journal {live_ev} / {drain_ev}")

        seq_recs = [r for r in recs if r["traceId"].startswith("seq")]
        con_recs = [r for r in recs if r["traceId"].startswith("con")]
        split = {"sequential": _stage_split(seq_recs, lat),
                 "concurrent": _stage_split(con_recs, lat)}
        on_seq = _pct([lat[f"seq{i:04d}"] for i in range(len(seq))])
        on_con = _pct([lat[f"con{i:04d}"] for i in range(len(burst))])
        off_seq = _pct(served["seq_lat"])
        off_con = _pct(served["burst_lat"])
        train = _profiled_train(work, seed)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        history.reset()
        history.install(history.HistoryConfig.from_env())
    phase_s = time.perf_counter() - t_phase
    for (mode, sp), n in zip(split.items(), (len(seq_recs),
                                             len(con_recs))):
        print(f"observe: split {mode} ({n} requests, ms p50/p99): "
              + "; ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
                          for k, v in sp.items()), flush=True)
    print("observe: latency sequential knobs on p50 %.3f p99 %.3f ms vs "
          "phase 6 knobs off p50 %.3f p99 %.3f ms; concurrent on %.3f / "
          "%.3f vs off %.3f / %.3f ms (reported, not claimed)"
          % (*on_seq, *off_seq, *on_con, *off_con), flush=True)
    print(f"observe: {requests} requests in {flushes} flushes, B1 and B2 "
          f"{launches} / {merge_launches} launches, answers byte-equal to "
          f"phase 6; stage counts {counts}; {chains} flush chains in "
          f"/traces.json; HBM in use {ms['bytes_in_use']} of "
          f"{ms['bytes_limit']} (peak {ms['peak_bytes_in_use']}), "
          f"post-warmup recompiles 0 after {wd['servingFlushes']} flushes",
          flush=True)
    print("observe: SLO and history " + json.dumps(slo_history), flush=True)
    print("observe: live profile " + json.dumps(live), flush=True)
    print("observe: profiled train " + json.dumps(train), flush=True)
    print(f"observe: phase {phase_s:.1f} s", flush=True)
    return {"requests": requests, "flushes": flushes, "launches": launches,
            "merge_launches": merge_launches, "stage_counts": counts,
            "split_ms": split,
            "latency_ms": {"knobs_on": {"sequential": on_seq,
                                        "concurrent": on_con},
                           "knobs_off": {"sequential": off_seq,
                                         "concurrent": off_con}},
            "hbm": ms, "post_warmup_recompiles": 0,
            "slo_history": slo_history,
            "live_profile": live, "profiled_train": train,
            "phase_s": phase_s}


def _store_env(work: str) -> dict:
    """The zero-configuration store (SQLite and model files under
    ``PIO_FS_BASEDIR``) that the CLI's verbs in this run share."""
    env = {"PIO_FS_BASEDIR": os.path.join(work, "store")}
    os.environ.update(env)
    return env


@contextlib.contextmanager
def _wrapped(*targets):
    """Replace ``obj.name`` by ``make(original)`` for each (obj, name,
    make) while the block runs."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _m in targets]
    try:
        for obj, name, make in targets:
            setattr(obj, name, make(getattr(obj, name)))
        yield
    finally:
        for obj, name, original in saved:
            setattr(obj, name, original)


def _write_import_file(path: str, seed: int, limit: int = 0) -> int:
    """EVAL_RATINGS synthetic rate events (zipf users and items, half-star
    ratings, from ``seed``) as the JSON lines ``pio import`` reads; with
    ``limit``, only that many first lines of the same file."""
    src = synthetic.chunk_source(EVAL_RATINGS, seed=seed, n_users=EVAL_USERS,
                                 n_items=N_ITEMS, chunk=50_000)
    n = 0
    with open(path, "w") as f:
        for chunk in src.chunks():
            users = (chunk["entity_code"] - 3).tolist()
            items = (chunk["target_code"] - 3 - EVAL_USERS).tolist()
            times = np.datetime_as_string(
                chunk["time_ms"].astype("datetime64[ms]"), unit="ms")
            rows = list(zip(users, items, chunk["rating"].tolist(),
                            times.tolist()))
            if limit:
                rows = rows[:limit - n]
            f.writelines(
                '{"event": "rate", "entityType": "user", "entityId": '
                f'"u{u}", "targetEntityType": "item", "targetEntityId": '
                f'"i{i}", "properties": {{"rating": {r!r}}}, "eventTime": '
                f'"{t}Z"}}\n' for u, i, r, t in rows)
            n += len(rows)
            if limit and n >= limit:
                return n
    return src.n_events


def _count_events(env: dict, app_id: int) -> int:
    """Rows of the app's default channel, read with sqlite3 itself from
    the store's file (the default channel is stored as -1)."""
    path = os.path.join(env["PIO_FS_BASEDIR"], "pio.sqlite")
    with contextlib.closing(sqlite3.connect(path)) as db:
        return db.execute("SELECT COUNT(*) FROM events WHERE app_id=? AND "
                          "channel_id=-1", (app_id,)).fetchone()[0]


class _Client:
    """One keep-alive HTTP/1.1 connection, as an SDK client holds one."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=60)

    def call(self, method: str, target: str, payload=None):
        body = None if payload is None else json.dumps(payload).encode()
        t0 = time.perf_counter()
        self.conn.request(method, target, body=body,
                          headers={"Content-Type": "application/json"})
        r = self.conn.getresponse()
        data = r.read()
        return r.status, json.loads(data), time.perf_counter() - t0

    def close(self):
        self.conn.close()


def _rate(user: str, item: str, rating: float) -> dict:
    return {"event": "rate", "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "properties": {"rating": rating}}


def _drive_event_server(port: int, out: dict) -> None:
    """The client side of the event-server step: every answer is checked
    as the reference gives it, then SIGTERM starts the drain and /readyz
    must answer 503 on the open connection before it closes."""
    _wait_ready(port, lambda: True)
    c = _Client(port)
    key = f"/events.json?accessKey={QS_KEY}"
    try:
        status, body, _t = c.call("POST", key, _rate("u0", "i0", 4.0))
        if status != 201 or "eventId" not in body:
            raise AssertionError(f"POST /events.json: {status} {body}")
        status, got, _t = c.call(
            "GET", f"/events/{body['eventId']}.json?accessKey={QS_KEY}")
        if status != 200 or got["eventId"] != body["eventId"] or \
                got["entityId"] != "u0":
            raise AssertionError(f"GET /events/<id>.json: {status} {got}")
        single = []
        for k in range(QS_POSTS):
            status, body, t = c.call("POST", key, _rate(
                f"u{k % EVAL_USERS}", f"i{(7 * k) % N_ITEMS}",
                float(k % 10 + 1) / 2))
            if status != 201:
                raise AssertionError(f"single POST {k}: {status} {body}")
            single.append(t)
        batch = [_rate("1", f"i{k}", float(k % 10 + 1) / 2)
                 for k in range(50)]
        status, results, t_batch = c.call(
            "POST", f"/batch/events.json?accessKey={QS_KEY}", batch)
        if status != 200 or [r["status"] for r in results] != [201] * 50:
            raise AssertionError(f"batch of 50: {status} {results}")
        status, body, _t = c.call(
            "POST", f"/batch/events.json?accessKey={QS_KEY}", batch + [
                _rate("1", "i50", 3.0)])
        if (status, body) != (400, {"message": "Batch request must have "
                                    "less than or equal to 50 events"}):
            raise AssertionError(f"batch of 51: {status} {body}")
        status, body, _t = c.call(
            "POST", f"/events.json?accessKey={QS_RATE_KEY}", {
                "event": "buy", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1"})
        if (status, body) != (403, {"message": "buy events are not "
                                    "allowed"}):
            raise AssertionError(f"rate-only key, buy: {status} {body}")
        # batches into the channel: ingest rate, apart from the app's data
        chan = (f"/batch/events.json?accessKey={QS_KEY}"
                f"&channel={QS_CHANNEL}")
        chan_times = []
        for b in range(QS_CHANNEL_BATCHES):
            status, results, t = c.call("POST", chan, [
                _rate(f"c{b}", f"i{k}", 4.0) for k in range(50)])
            if status != 200 or [r["status"] for r in results] != [201] * 50:
                raise AssertionError(f"channel batch {b}: {status}")
            chan_times.append(t)
        where = "&entityType=user&entityId=c0"
        status, body, _t = c.call("GET", key + where)
        if status != 404:
            raise AssertionError("a channel's event shows in the default "
                                 f"channel: {status} {body}")
        status, body, _t = c.call(
            "GET", key + where + f"&channel={QS_CHANNEL}&limit=-1")
        if status != 200 or len(body) != 50:
            raise AssertionError(f"channel read: {status} {len(body)}")
        status, body, _t = c.call("GET", "/readyz")
        if (status, body) != (200, {"status": "ready"}):
            raise AssertionError(f"/readyz before the drain: {status}")
        os.kill(os.getpid(), signal.SIGTERM)
        out["sigterm_sent"] = True
        t0 = time.perf_counter()
        while True:
            status, body, _t = c.call("GET", "/readyz")
            if (status, body) == (503, {"status": "draining"}):
                break
            if time.perf_counter() - t0 > 30:
                raise AssertionError("/readyz never answered 503 after "
                                     "SIGTERM")
            time.sleep(0.01)
        out.update(single_s=single, batch_s=t_batch, channel_s=chan_times,
                   drain_seen_s=time.perf_counter() - t0)
    finally:
        c.close()


def phase_quickstart(work: str, seed: int, dev: torch.device):
    """The quickstart through the port's CLI in process, on SQLite under
    the run's PIO_FS_BASEDIR: app, channel and keys; ``pio import`` of
    EVAL_RATINGS events; the event server on 127.0.0.1 (stopped through
    its SIGTERM drain); ``pio train`` from the store; ``pio deploy`` and
    the quickstart's query; ``pio undeploy``. Returns the kernels'
    launches on its train and deploy paths and the phase's numbers."""
    env = _store_env(work)
    # phase 5's `pio train --synthetic` set these for the process; this
    # train reads the store
    for name in ("PIO_SYNTHETIC_EVENTS", "PIO_SYNTHETIC_SEED"):
        os.environ.pop(name, None)
    t_phase = time.perf_counter()
    for argv in (["app", "new", EVAL_APP, "--access-key", QS_KEY],
                 ["app", "channel-new", EVAL_APP, QS_CHANNEL],
                 ["accesskey", "new", EVAL_APP, "--key", QS_RATE_KEY,
                  "--event", "rate"]):
        if cli.main(argv) != 0:
            raise AssertionError(f"pio {' '.join(argv)} failed")
    store = storage_mod.Storage(env=env)
    app_id = store.get_meta_data_apps().get_by_name(EVAL_APP).id

    path = os.path.join(work, "events.json")
    t0 = time.perf_counter()
    n_file = _write_import_file(path, seed)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = cli.main(["import", "--appid", str(app_id), "--input", path])
    import_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"pio import exited {rc}")
    os.remove(path)
    n_stored = _count_events(env, app_id)
    if n_stored != n_file:
        raise AssertionError(f"imported {n_stored} of {n_file} events")
    print(f"quickstart: pio import of {n_file} events in {import_s:.3f} s "
          f"({n_file / import_s:.0f} events/s); the file written in "
          f"{write_s:.3f} s", flush=True)

    # the event server runs in this (the main) thread, as `pio
    # eventserver` does, so its SIGTERM handler is live; the client runs
    # beside it
    port = _free_port()
    es_out, errors = {}, []

    def client():
        try:
            _drive_event_server(port, es_out)
        except BaseException as e:           # surfaced after the join
            errors.append(e)
            if not es_out.get("sigterm_sent"):
                os.kill(os.getpid(), signal.SIGTERM)

    previous = signal.getsignal(signal.SIGTERM)
    worker = threading.Thread(target=client, daemon=True)
    worker.start()
    try:
        rc = cli.main(["eventserver", "--ip", "127.0.0.1", "--port",
                       str(port)])
    finally:
        signal.signal(signal.SIGTERM, previous)
    worker.join(timeout=60)
    if errors:
        raise errors[0]
    if rc != 0 or worker.is_alive():
        raise AssertionError(f"pio eventserver exited {rc}")
    n_posted = 1 + QS_POSTS + 50
    n_default = _count_events(env, app_id)
    if n_default != n_file + n_posted:
        raise AssertionError(f"{n_default} events in the app, want "
                             f"{n_file} + {n_posted}")
    single_p50, single_p99 = _pct(es_out["single_s"])
    chan_eps = [50 / t for t in es_out["channel_s"]]
    print(f"quickstart: event server: POST 201 and read back; {QS_POSTS} "
          f"sequential single POSTs p50 {single_p50:.3f} ms p99 "
          f"{single_p99:.3f} ms; batch of 50 for user 1 in "
          f"{es_out['batch_s'] * 1e3:.3f} ms ({50 / es_out['batch_s']:.0f} "
          f"events/s), {QS_CHANNEL_BATCHES} batches of 50 into the channel "
          f"at a median {statistics.median(chan_eps):.0f} events/s; 51 -> "
          "400, rate-only key -> 403, the channel apart; /readyz 503 "
          f"{es_out['drain_seen_s'] * 1e3:.1f} ms after SIGTERM", flush=True)

    # pio train from the store at the template's engine.json
    engine_dir = os.path.join(work, "quickstart_engine")
    os.makedirs(engine_dir)
    with open(ENGINE_JSON) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["appName"] = EVAL_APP
    with open(os.path.join(engine_dir, "engine.json"), "w") as f:
        json.dump(variant, f)
    params = variant["algorithms"][0]["params"]
    instances = store.get_meta_data_engine_instances()
    before = {r.id for r in instances.get_all()}
    solve.reset_launches()               # the quickstart train starts here
    topk_fused.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--engine-dir", engine_dir])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = solve.launches      # the quickstart train ends here
    if rc != 0:
        raise AssertionError(f"pio train exited {rc}")
    if train_launches != 2 * params["numIterations"]:
        raise AssertionError(f"solve_gj launched {train_launches} times in "
                             f"{params['numIterations']} iterations")
    (row,) = [r for r in instances.get_all() if r.id not in before]
    if row.status != "COMPLETED":
        raise AssertionError(f"train left the instance {row.status}")
    (model,) = model_io.deserialize_models(
        store.get_model_data_models().get(row.id).models)
    phases = {k[len("phase_"):-len("_s")]: float(v)
              for k, v in row.runtime_conf.items()
              if k.startswith("phase_")}
    td = DataSource(DataSourceParams(appName=EVAL_APP)).read_training(
        WorkflowContext(storage=store))
    if td.n != n_default:
        raise AssertionError(f"the train's read holds {td.n} ratings, the "
                             f"app {n_default}")
    if (td.user_vocab.to_dict() != model.user_vocab.to_dict()
            or td.item_vocab.to_dict() != model.item_vocab.to_dict()):
        raise AssertionError("the store's read and the model disagree on "
                             "the vocabularies")
    rmse0, rmse1, ms_iter, _per, _w = _rmse_and_iterations(
        td, model, params, dev, profile=False)
    print(f"quickstart: pio train from the store: {td.n} ratings, "
          f"{len(model.user_vocab)} users x {len(model.item_vocab)} items, "
          f"rank {params['rank']}, {params['numIterations']} iterations in "
          f"{train_s:.3f} s; phases " + ", ".join(
              f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; {ms_iter:.2f} ms per iteration; RMSE {rmse0:.4f} -> "
          f"{rmse1:.4f}; solve_gj launched {train_launches} times",
          flush=True)

    # pio deploy of that instance, the quickstart's query, pio undeploy
    dep = _deploy_checked(engine_dir, row.id,
                          [("1", 4)] * (1 + QS_QUERIES))
    if len(dep["answers"][0]["itemScores"]) != 4:
        raise AssertionError(f"the quickstart query gave {dep['answers']}")
    ready_s, flushes = dep["ready_s"], dep["flushes"]
    launches, merge_launches = dep["B1_launches"], dep["B2_launches"]
    first_ms = dep["query_s"][0] * 1e3
    q_p50, q_p99 = _pct(dep["query_s"][1:])
    print(f"quickstart: pio deploy ready in {ready_s:.3f} s; "
          f"{{\"user\": \"1\", \"num\": 4}} -> 200 with 4 itemScores equal "
          f"to the plain int8 path, {1 + QS_QUERIES} times; first "
          f"{first_ms:.3f} ms, then p50 {q_p50:.3f} ms p99 {q_p99:.3f} ms; "
          f"B1 launched {launches} times and B2 {merge_launches} times for "
          f"{flushes} flushes; pio undeploy stopped it", flush=True)
    out = {"events_imported": n_file, "import_s": import_s,
           "import_events_per_s": n_file / import_s,
           "file_write_s": write_s, "events_posted": n_posted,
           "single_post_ms": {"p50": single_p50, "p99": single_p99,
                              "n": QS_POSTS},
           "batch_post_events_per_s": 50 / es_out["batch_s"],
           "channel_batch_events_per_s_median":
               statistics.median(chan_eps),
           "drain_503_after_s": es_out["drain_seen_s"],
           "train": {"ratings": td.n, "users": len(model.user_vocab),
                     "items": len(model.item_vocab), "wall_s": train_s,
                     "phases_s": phases, "ms_per_iteration": ms_iter,
                     "rmse_before": rmse0, "rmse_after": rmse1,
                     "solve_gj_launches": train_launches},
           "deploy": {"ready_s": ready_s, "first_query_ms": first_ms,
                      "query_ms": {"p50": q_p50, "p99": q_p99,
                                   "n": QS_QUERIES},
                      "flushes": flushes, "B1_launches": launches,
                      "B2_launches": merge_launches},
           "instance_id": row.id,
           "phase_s": time.perf_counter() - t_phase}
    print("quickstart: " + json.dumps(out), flush=True)
    return train_launches, launches, merge_launches, n_default, out


# ---------------------------------------------------------------------------
# phase 7b: the serving fleet: both transports, the router, a partition
# fleet, a multi-tenant deploy, plugins and feedback
# ---------------------------------------------------------------------------

#: the fleet's own engine id: its replicas deploy the latest COMPLETED
#: instance of it, so a POST /reload moves them to a newer one
FLEET_ENGINE = "smoke-fleet"
FLEET_CLIENTS = 8
FLEET_ROUTER_QUERIES = 256
#: the partition fleet's nums; the whole catalog is the third
FLEET_NUMS = (10, 100)
FLEET_PARTITION_USERS = 8
#: item rows of the reload's model cloned across the 0/2 | 1/2 boundary
#: (row lo + j is row lo - 1 - j), so every user's scores tie across it
FLEET_CLONES = 8
FLEET_APP, FLEET_KEY = "SmokeFleet20M", "smoke-fleet-key"
FLEET_CAP_APP, FLEET_CAP_KEY = "SmokeFleetCap", "smoke-fleet-cap-key"
FLEET_FEEDBACK_APP, FLEET_FEEDBACK_KEY = ("SmokeFleetFeedback",
                                          "smoke-fleet-feedback-key")
FLEET_QS_RATE = 4.0              # the quickstart tenant's queries per s
#: the membership poll of the routers over in-process replicas (the
#: kill, the reload barrier, the partitions, the autopilot): the
#: router's default (PIO_ROUTER_HEALTH_MS), so a probe times out after
#: 2 s. Replicas, router and clients share this interpreter, so a
#: replica's reload slows every probe; a 100 ms poll's 0.5 s timeout let
#: one probe of the replica serving alone in the reload barrier expire,
#: and the router ejected it and shed. The reload step prints each
#: replica's longest probe
FLEET_HEALTH_MS = 500.0
FLEET_ENV = {"PIO_TRACE": "1", "PIO_WATERFALL": "1", "PIO_SLOW_RING": "512"}
#: the tenants step reads pio_tenant_model_bytes off /metrics
FLEET_TENANT_ENV = {"PIO_TELEMETRY": "1"}


class _Launches:
    """B1 and B2 launches per serving layout, while the block runs: B1 is
    keyed by the item block it scores (``vt_q``'s address, one per
    replica or tenant), B2 by the B1 launched before it on the same
    thread. A reload's warm-up (the ``pio-reload`` thread) is counted
    apart from the flushes. Records the launching threads' names and CUDA
    streams over the whole block."""

    def __init__(self):
        self.lock = threading.Lock()
        self.by = collections.defaultdict(lambda: [0, 0])
        self.warm = collections.defaultdict(lambda: [0, 0])
        self.threads = collections.Counter()
        self.streams = set()
        self.local = threading.local()

    def clear(self):
        """Zero the counts; the threads and streams seen stay."""
        with self.lock:
            self.by.clear()
            self.warm.clear()

    def of(self, *layouts) -> tuple:
        """B1 and B2 launched by flushes on these layouts, summed."""
        with self.lock:
            got = [self.by.get(qs.vt_q.data_ptr(), (0, 0)) for qs in layouts]
        return tuple(sum(c[i] for c in got) for i in (0, 1))

    def warm_of(self, qs) -> tuple:
        """B1 and B2 launched by a reload's warm-up on this layout."""
        with self.lock:
            return tuple(self.warm.get(qs.vt_q.data_ptr(), (0, 0)))

    def wrap(self):
        def b1(orig):
            def run(u_q, u_scale, vt_q, *a, **kw):
                out = orig(u_q, u_scale, vt_q, *a, **kw)
                name = threading.current_thread().name
                table = self.warm if name == "pio-reload" else self.by
                self.local.key = (table, vt_q.data_ptr())
                with self.lock:
                    table[vt_q.data_ptr()][0] += 1
                    self.threads[name] += 1
                    self.streams.add(
                        torch.cuda.current_stream(vt_q.device).cuda_stream)
                return out
            return run

        def b2(orig):
            def run(*a, **kw):
                out = orig(*a, **kw)
                table, key = getattr(self.local, "key", (self.by, None))
                with self.lock:
                    table[key][1] += 1
                return out
            return run

        return _wrapped((topk_fused, "_launch", b1),
                        (topk_fused, "_launch_merge", b2))


def _fleet_serve(api, transport: str = "async"):
    """``api`` on 127.0.0.1, port 0, on ``transport``: (server, port)."""
    from predictionio_tpu_torch.data.api import http as http_mod
    server = http_mod.make_server(api, "127.0.0.1", 0, transport=transport)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    _wait_ready(port, lambda: True)
    return server, port


def _fleet_stop(*pairs) -> None:
    """Shut down each (server, api) pair: the server drains, then the
    api's batcher."""
    for server, api in pairs:
        server.shutdown()
        server.server_close()
        api.close()


def _fleet_api(store, **cfg):
    cfg.setdefault("serve_quant", "on")
    return create_server.QueryAPI(create_server.ServerConfig(**cfg),
                                  storage=store)


def _raw_post(port: int, body: bytes, path: str = "/queries.json",
              headers=None):
    """(status, raw bytes, seconds) of one POST; an HTTP error's status
    is returned, not raised."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def _qbody(user: str, num: int) -> bytes:
    return json.dumps({"user": user, "num": num}).encode()


def _router_warnings(since_seq: int) -> list:
    """The router's journal records above INFO after ``since_seq``
    (ejections, aborted barriers): what a failed fleet check prints."""
    return [e["message"] for e in journal.snapshot(
        since_seq=since_seq, category="router", limit=32)["events"]
        if e["level"] != journal.INFO]


def _batches(api_or_batcher) -> int:
    """The flushes a deploy's (or a tenant's) batcher has run."""
    stats = (api_or_batcher.handle("GET", "/")[1]["batching"]
             if hasattr(api_or_batcher, "handle")
             else api_or_batcher.stats())
    return stats["batches"]


def _require_flushes(name: str, api_or_batcher, counts: tuple,
                     since: int = 0) -> int:
    """The flushes since ``since``; raises unless B1 and B2 (``counts``,
    over the same window) launched once each a flush."""
    flushes = _batches(api_or_batcher) - since
    if flushes == 0 or counts != (flushes, flushes):
        raise AssertionError(f"{name}: B1 / B2 launched {counts} times for "
                             f"{flushes} flushes (want one each a flush)")
    return flushes


def phase_fleet(work: str, store, iid: str, users, seed: int, served: dict,
                qs_iid: str, dev: torch.device) -> dict:
    """The serving fleet on the card, every replica a port QueryAPI whose
    flushes run B1 + B2: (a) phase 6's traffic on the threaded and the
    async transport, (b) the router over two full replicas through a
    replica's shutdown and a ``/reload``, (c) a two-partition fleet behind
    the router, (d) a two-tenant ``pio deploy --engines`` with admission
    and the memory cap, (e) plugins and feedback."""
    from predictionio_tpu_torch.common import tracing, waterfall
    from predictionio_tpu_torch.data.storage import AccessKey, App, Model

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in
             (*FLEET_ENV, *FLEET_TENANT_ENV, "PIO_TENANT_HBM_HARD_CAP_MB")}
    os.environ.update(FLEET_ENV)
    launches = _Launches()
    out = {}
    try:
        with launches.wrap():
            out["transports"] = _fleet_transports(
                store, iid, users, seed, served, launches, tracing,
                waterfall)
            # the fleet's own instances: A (phase 5's model) now, B (the
            # reload's model) later
            instances = store.get_meta_data_engine_instances()
            models = store.get_model_data_models()
            row = instances.get(iid)
            blob = models.get(iid).models
            now = _dt.datetime.now(tz=_dt.timezone.utc)
            fleet_row = dataclasses.replace(
                row, id="", engine_id=FLEET_ENGINE,
                engine_variant=FLEET_ENGINE, start_time=now, end_time=now)
            inst_a = instances.insert(fleet_row)
            models.insert(Model(inst_a, blob))
            (m1,) = model_io.deserialize_models(blob)
            V2 = -als_algorithm.host_f32(m1.item_factors)
            n_items = len(m1.item_vocab)
            lo = n_items // 2             # partition 1/2's first row
            V2[lo:lo + FLEET_CLONES] = V2[lo - FLEET_CLONES:lo][::-1]
            blob_b = model_io.serialize_models([dataclasses.replace(
                m1, user_factors=als_algorithm.host_f32(m1.user_factors),
                item_factors=V2)])

            def insert_b():
                t = _dt.datetime.now(tz=_dt.timezone.utc)
                b = instances.insert(dataclasses.replace(
                    fleet_row, start_time=t, end_time=t))
                models.insert(Model(b, blob_b))
                return b

            out["router"], inst_b, direct = _fleet_router(
                store, users, seed, launches, insert_b)
            try:
                out["partition"] = _fleet_partition(
                    store, inst_b, users, seed, launches, direct, dev,
                    (*FLEET_NUMS, n_items))
            finally:
                _fleet_stop((direct["server"], direct["api"]))
            apps = store.get_meta_data_apps()
            keys = store.get_meta_data_access_keys()
            for app, key in ((FLEET_APP, FLEET_KEY),
                             (FLEET_CAP_APP, FLEET_CAP_KEY),
                             (FLEET_FEEDBACK_APP, FLEET_FEEDBACK_KEY)):
                app_id = apps.insert(App(0, app, None))
                keys.insert(AccessKey(key, app_id, ()))
            os.environ.update(FLEET_TENANT_ENV)
            out["tenants"] = _fleet_tenants(
                work, store, iid, qs_iid, inst_b, users, seed, launches,
                direct)
            out["plugins"] = _fleet_plugins(store, iid, users, seed,
                                            launches)
        threads = dict(launches.threads)
        if any(name.startswith("pio-http") for name in threads) \
                or len(launches.streams) != 1:
            raise AssertionError(
                f"B1 launched from threads {threads} on streams "
                f"{launches.streams}: device work left the batchers")
        out["launch_threads"] = threads
        out["launch_streams"] = len(launches.streams)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: B1 launched on threads {out['launch_threads']}, one "
          f"CUDA stream; phase {out['phase_s']:.1f} s", flush=True)
    print("fleet: " + json.dumps(out), flush=True)
    return out


def _fleet_launches(out: dict) -> dict:
    """B1 and B2 launches over the fleet's served windows (each counted
    from 0 after its deploys were ready), summed over its replicas and
    tenants."""
    rows = [{"B1": t["flushes"], "B2": t["flushes"]}
            for t in out["transports"].values()]
    rows += list(out["router"]["kill"]["launches"].values())
    rows += out["partition"]["launches"]
    rows += list(out["tenants"]["launches"].values())
    rows.append({"B1": out["plugins"]["flushes"],
                 "B2": out["plugins"]["flushes"]})
    return {k: sum(r[k] for r in rows) for k in ("B1", "B2")}


def _fleet_transports(store, iid, users, seed, served, launches, tracing,
                      waterfall) -> dict:
    """(a) phase 6's 64 sequential and 64 concurrent queries against one
    deploy on each transport: the same bytes as phase 6, B1 = B2 =
    flushes, and the client latency split into the server's total and the
    transport's rest (joined on each request's trace id)."""
    seq, burst, _profiled = _path_queries(users, seed)
    out, raws = {}, {}
    for transport in ("threaded", "async"):
        tracing.clear()
        waterfall.clear()
        api = _fleet_api(store, engine_instance_id=iid)
        server, port = _fleet_serve(api, transport)
        launches.clear()
        lat, got = {}, {}

        def one(tag, q):
            status, _p, dt_s, raw = _post(port, q[0], q[1], trace=tag)
            lat[tag] = dt_s
            got.setdefault(q, []).append((status, raw))

        try:
            for i, q in enumerate(seq):
                one(f"seq{i:04d}", q)
            with ThreadPoolExecutor(max_workers=16) as pool:
                list(pool.map(lambda iq: one(f"con{iq[0]:04d}", iq[1]),
                              enumerate(burst)))
            slow = json.loads(_get(port, "/debug/slow.json?limit=1024")[2])
            flushes = _require_flushes(f"{transport} transport", api,
                                       launches.of(api.models[0].quant))
        finally:
            _fleet_stop((server, api))
        for q, answers in got.items():
            for status, raw in answers:
                if status != 200 or raw != served["raw"][q]:
                    raise AssertionError(
                        f"{transport}: {q} answered differently from "
                        "phase 6")
        raws[transport] = {q: a[0][1] for q, a in got.items()}
        recs = slow["requests"]
        if len(recs) != len(seq) + len(burst):
            raise AssertionError(f"{transport}: slow ring holds "
                                 f"{len(recs)} requests")
        split = {}
        for mode, tag in (("sequential", "seq"), ("concurrent", "con")):
            mine = [r for r in recs if r["traceId"].startswith(tag)]
            split[mode] = {k: _stage_split(mine, lat)[k]
                           for k in ("client", "total", "transport")}
        out[transport] = {"flushes": flushes, "split_ms": split}
        print(f"fleet: {transport} transport: {len(lat)} queries in "
              f"{flushes} flushes, B1 = B2 = {flushes}, the bytes of phase "
              "6; ms p50/p99 " + "; ".join(
                  f"{mode} " + ", ".join(
                      f"{k} {v['p50']:.3f}/{v['p99']:.3f}"
                      for k, v in sp.items())
                  for mode, sp in split.items()), flush=True)
    if raws["threaded"] != raws["async"]:
        raise AssertionError("the transports answered with different bytes")
    return out


def _fleet_router(store, users, seed, launches, insert_b):
    """(b) the router over two full replicas of the fleet's instance A:
    256 queries from 8 clients byte-equal to a direct query of a replica,
    one replica shut down mid-stream; then over a fresh pair, ``POST
    /reload`` through the router while the clients query (instance B is
    the newer one): none dropped, every answer one generation's direct
    bytes, each client's generations monotone."""
    from predictionio_tpu_torch.workflow import router as router_mod

    rng = np.random.default_rng(seed + 41)
    distinct = [users[u] for u in rng.choice(len(users), size=64,
                                             replace=False)]
    stream = [distinct[j % 64] for j in range(FLEET_ROUTER_QUERIES)]
    a = _fleet_api(store, engine_id=FLEET_ENGINE,
                   engine_variant=FLEET_ENGINE)
    b = _fleet_api(store, engine_id=FLEET_ENGINE,
                   engine_variant=FLEET_ENGINE)
    sa, pa = _fleet_serve(a)
    sb, pb = _fleet_serve(b)
    gen1 = {u: _raw_post(pa, _qbody(u, 10))[1] for u in distinct}
    launches.clear()
    since_a = _batches(a)
    seq0 = journal.snapshot(limit=1)["lastSeq"]
    router = router_mod.RouterAPI(router_mod.RouterConfig(
        backends=(f"http://127.0.0.1:{pa}", f"http://127.0.0.1:{pb}"),
        health_ms=FLEET_HEALTH_MS))
    sr, pr = _fleet_serve(router, "threaded")
    done = collections.Counter()
    lock = threading.Lock()
    killed = threading.Event()
    results = {}

    def client(c, queries, on_step=None):
        res = []
        for j, u in enumerate(queries):
            status, raw, dt_s = _raw_post(pr, _qbody(u, 10))
            res.append((u, status, raw, dt_s))
            with lock:
                done["n"] += 1
            if on_step is not None:
                on_step()
        results[c] = res

    killer = threading.Thread(target=sb.shutdown, daemon=True)

    def maybe_kill():
        with lock:
            if done["n"] < FLEET_ROUTER_QUERIES // 4 or killed.is_set():
                return
            killed.set()
        killer.start()

    per = FLEET_ROUTER_QUERIES // FLEET_CLIENTS
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(
            c, stream[c * per:(c + 1) * per], maybe_kill))
            for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        status = router.handle("GET", "/")[1]
        counts = {"a": launches.of(a.models[0].quant),
                  "b": launches.of(b.models[0].quant)}
        flushes = {"a": _require_flushes("replica a", a, counts["a"],
                                         since_a),
                   "b": _require_flushes("replica b", b, counts["b"])}
    finally:
        _fleet_stop((sr, router))
        if killed.is_set():
            killer.join(timeout=60)
        else:
            sb.shutdown()
        sb.server_close()
        b.close()
    if not killed.is_set():
        raise AssertionError("router: replica b was never shut down")
    answers = [r for res in results.values() for r in res]
    bad = [(u, s) for u, s, raw, _t in answers
           if s != 200 or raw != gen1[u]]
    if len(answers) != FLEET_ROUTER_QUERIES or bad:
        raise AssertionError(f"router: {len(answers)} answers, "
                             f"{len(bad)} not the direct bytes: {bad[:3]}; "
                             f"router journal {_router_warnings(seq0)}")
    lat = [t for *_x, t in answers]
    kill = {"queries": len(answers), "dropped": 0, "wall_s": wall,
            "failovers": status["failoverCount"],
            "shed": status["shedCount"],
            "client_ms": dict(zip(("p50", "p99"), _pct(lat))),
            "launches": {k: {"B1": v[0], "B2": v[1], "flushes": flushes[k]}
                         for k, v in counts.items()}}
    print(f"fleet: router over 2 replicas: {len(answers)} queries from "
          f"{FLEET_CLIENTS} clients, replica b shut down after "
          f"{FLEET_ROUTER_QUERIES // 4}: 0 dropped, every answer the "
          f"direct bytes, {kill['failovers']} failovers, "
          f"{kill['shed']} shed; client p50/p99 "
          f"{kill['client_ms']['p50']:.3f}/{kill['client_ms']['p99']:.3f} "
          f"ms; B1/B2/flushes a {counts['a']}/{flushes['a']}, b "
          f"{counts['b']}/{flushes['b']}", flush=True)

    # the reload barrier under load, over a and a fresh replica c
    c_api = _fleet_api(store, engine_id=FLEET_ENGINE,
                       engine_variant=FLEET_ENGINE)
    sc, pc = _fleet_serve(c_api)
    launches.clear()
    # each replica's generation-1 layout and batcher, and that batcher's
    # flushes so far: the barrier's window spans both generations
    gen1_of = {k: (api.models[0].quant, api._batcher, _batches(api._batcher))
               for k, api in (("a", a), ("c", c_api))}
    seq0 = journal.snapshot(limit=1)["lastSeq"]
    # the longest readiness probe of each replica, the poller's and the
    # barrier's own: what FLEET_HEALTH_MS's timeout has to cover
    probe_s = {f"127.0.0.1:{p}": 0.0 for p in (pa, pc)}

    def timed_probe(orig):
        def probe(self, timeout=2.0):
            t = time.perf_counter()
            try:
                return orig(self, timeout)
            finally:
                with lock:
                    probe_s[self.name] = max(probe_s.get(self.name, 0.0),
                                             time.perf_counter() - t)
        return probe

    timing = _wrapped((router_mod._Backend, "probe", timed_probe))
    timing.__enter__()
    router = router_mod.RouterAPI(router_mod.RouterConfig(
        backends=(f"http://127.0.0.1:{pa}", f"http://127.0.0.1:{pc}"),
        health_ms=FLEET_HEALTH_MS))
    sr, pr = _fleet_serve(router, "threaded")
    stop_at = threading.Event()
    results = {}

    def streamer(c):
        res, j = [], 0
        while not stop_at.is_set() and j < 2000:
            u = distinct[(c * 8 + j) % 64]
            status, raw, _t = _raw_post(pr, _qbody(u, 10))
            res.append((u, status, raw))
            j += 1
        results[c] = res

    try:
        threads = [threading.Thread(target=streamer, args=(c,))
                   for c in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        inst_b = insert_b()
        t0 = time.perf_counter()
        status, raw, _t = _raw_post(pr, b"", path="/reload")
        if status != 200:
            raise AssertionError(f"router /reload answered {status} {raw}")
        deadline = time.perf_counter() + 120
        while True:
            st = router.handle("GET", "/")[1]["reload"]
            if st.get("active") is False and "ok" in st:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"reload barrier stuck: {st}")
            time.sleep(0.05)
        barrier_s = time.perf_counter() - t0
        if not st["ok"]:
            raise AssertionError(f"reload barrier failed: {st}")
        time.sleep(0.5)
        stop_at.set()
        for t in threads:
            t.join(timeout=120)
        gens = (a.generation, c_api.generation)
        counts, warm, flushes = {}, {}, {}
        for k, api in (("a", a), ("c", c_api)):
            q1, old, since = gen1_of[k]
            q2, new = api.models[0].quant, api._batcher
            if q2 is q1 or new is old:
                raise AssertionError(f"reload: replica {k} kept its "
                                     "generation-1 layout or batcher")
            counts[k] = launches.of(q1, q2)
            warm[k] = launches.warm_of(q2)
            # the retired batcher's flushes since the clear, then the
            # new one's: one B1 + one B2 each, on either layout
            flushes[k] = _batches(old) - since + _batches(new)
            if flushes[k] == 0 or counts[k] != (flushes[k], flushes[k]):
                raise AssertionError(
                    f"reload: replica {k}: B1 / B2 launched {counts[k]} "
                    f"times for {flushes[k]} flushes over both generations")
            aot_state = api._aot_state
            want_warm = len(aot_state["buckets"]) if aot_state else 0
            if warm[k] != (want_warm, want_warm):
                raise AssertionError(
                    f"reload: replica {k}'s warm-up launched B1 / B2 "
                    f"{warm[k]} times for {want_warm} buckets")
    finally:
        stop_at.set()
        _fleet_stop((sr, router))
        timing.__exit__(None, None, None)
    gen2 = {u: _raw_post(pa, _qbody(u, 10))[1] for u in distinct}
    n, per_client = 0, []
    for c, res in results.items():
        seen = []
        for u, status, raw in res:
            n += 1
            g = 1 if raw == gen1[u] else 2 if raw == gen2[u] else None
            if status != 200 or g is None:
                raise AssertionError(f"reload: client {c} got {status} "
                                     "with bytes of neither generation; "
                                     "router journal "
                                     f"{_router_warnings(seq0)}")
            seen.append(g)
        if seen != sorted(seen):
            raise AssertionError(f"reload: client {c} went back a "
                                 "generation")
        per_client.append((seen.count(1), seen.count(2)))
    if gens != (2, 2) or not all(c2 for _c1, c2 in per_client):
        raise AssertionError(f"reload: generations {gens}, per client "
                             f"{per_client}")
    reload_out = {"queries": n, "dropped": 0, "barrier_s": barrier_s,
                  "probe_max_s": {"a": probe_s[f"127.0.0.1:{pa}"],
                                  "c": probe_s[f"127.0.0.1:{pc}"]},
                  "per_client_gen1_gen2": per_client,
                  "generations": list(gens),
                  "launches": {k: {"B1": v[0], "B2": v[1],
                                   "flushes": flushes[k],
                                   "warm_up": list(warm[k])}
                               for k, v in counts.items()}}
    print(f"fleet: POST /reload through the router under {FLEET_CLIENTS} "
          f"clients: {n} queries, 0 dropped, every answer a generation's "
          f"direct bytes, each client's generations monotone "
          f"{per_client}; barrier {barrier_s:.3f} s, longest probe a "
          f"{reload_out['probe_max_s']['a']:.3f} s, c "
          f"{reload_out['probe_max_s']['c']:.3f} s; replicas now at "
          f"generation {gens}; B1/B2/flushes over both generations a "
          f"{counts['a']}/{flushes['a']}, c {counts['c']}/{flushes['c']}, "
          f"reload warm-up B1/B2 a {warm['a']}, c {warm['c']}", flush=True)
    _fleet_stop((sc, c_api))
    direct = {"port": pa, "server": sa, "api": a, "gen1": gen1}
    return {"kill": kill, "reload": reload_out}, inst_b, direct


def _fleet_partition(store, inst_b, users, seed, launches, direct, dev,
                     nums):
    """(c) partitions 0/2 and 1/2 of instance B behind the router: at
    ``nums`` (10, 100 and the whole catalog) the merged bytes equal a's
    (a full deploy of B since the reload), for users whose scores tie
    across the boundary; each partition's B1 once against its plain
    version at its own item count."""
    from predictionio_tpu_torch.workflow import router as router_mod

    parts = [_fleet_api(store, engine_instance_id=inst_b,
                        partition=f"{i}/2") for i in range(2)]
    served_parts = [_fleet_serve(p) for p in parts]
    router = router_mod.RouterAPI(router_mod.RouterConfig(
        backends=tuple(f"http://127.0.0.1:{p}" for _s, p in served_parts),
        health_ms=FLEET_HEALTH_MS))
    sr, pr = _fleet_serve(router, "threaded")
    rng = np.random.default_rng(seed + 43)
    who = [users[u] for u in rng.choice(len(users),
                                        size=FLEET_PARTITION_USERS,
                                        replace=False)]
    lo = parts[1]._partition_state["lo"]
    try:
        deadline = time.perf_counter() + 30
        while not router.handle("GET", "/")[1].get(
                "partitions", {}).get("complete"):
            if time.perf_counter() > deadline:
                raise AssertionError("partition map never completed")
            time.sleep(0.05)
        launches.clear()
        ties, n, lat = 0, 0, []
        for u in who:
            for num in nums:
                body = _qbody(u, num)
                want = _raw_post(direct["port"], body)[1]
                status, got, dt_s = _raw_post(pr, body)
                lat.append(dt_s)
                n += 1
                if status != 200 or got != want:
                    raise AssertionError(
                        f"partition fleet: {u} num={num} differs from the "
                        "full replica")
                if num == nums[-1]:
                    ids = {s["item"]: s["score"]
                           for s in json.loads(got)["itemScores"]}
                    inv = direct["api"].models[0].item_vocab
                    low = {ids[k] for k in ids if inv(k) < lo}
                    high = {ids[k] for k in ids if inv(k) >= lo}
                    ties += len(low & high)
        counts = [launches.of(p.models[0].quant) for p in parts]
        flushes = [_require_flushes(f"partition {i}/2", p, c)
                   for i, (p, c) in enumerate(zip(parts, counts))]
        # each partition's B1 against its plain version at its own
        # item count, outside the counted window
        b1 = []
        for p in parts:
            q = p.models[0].quant
            ixs = torch.tensor([p.models[0].user_vocab(u) for u in who],
                               dtype=torch.int32, device=dev)
            v, i = topk_fused.score_mask_topk_candidates(
                q.u_q, q.u_scale, q.vt_q, q.v_scale, ixs, k_local=10,
                n_items=q.n_items, tile=q.tile)
            pv, pi = topk_fused.score_mask_topk_candidates_plain(
                q.u_q[ixs.long()], q.u_scale[ixs.long()], q.vt_q,
                q.v_scale, k_local=10, n_items=q.n_items, tile=q.tile)
            if not (torch.equal(v, pv) and torch.equal(i, pi)):
                raise AssertionError("a partition's B1 != plain")
            b1.append(q.n_items)
    finally:
        _fleet_stop((sr, router), *[(s, p) for (s, _port), p
                                    in zip(served_parts, parts)])
    if ties == 0:
        raise AssertionError("no score tied across the partition boundary")
    out = {"queries": n, "users": len(who), "nums": list(nums),
           "ties_across_boundary": ties, "lo": lo,
           "client_ms": dict(zip(("p50", "p99"), _pct(lat))),
           "launches": [{"B1": c[0], "B2": c[1], "flushes": f}
                        for c, f in zip(counts, flushes)],
           "B1_vs_plain_items": b1}
    print(f"fleet: partitions 0/2 + 1/2 (items [0, {lo}) and [{lo}, "
          f"{nums[-1]})) behind the router: {n} queries at num "
          f"{list(nums)} byte-identical to the full replica, "
          f"{ties} score ties across the boundary in the whole-catalog "
          f"answers; B1/B2/flushes per partition {out['launches']}; each "
          f"partition's B1 == plain at {b1} items; client p50/p99 "
          f"{out['client_ms']['p50']:.3f}/{out['client_ms']['p99']:.3f} ms",
          flush=True)
    return out


def _fleet_tenants(work, store, iid, qs_iid, inst_b, users, seed, launches,
                   direct) -> dict:
    """(d) ``pio deploy --engines`` with the 20M model and the quickstart
    model: 401 for an unknown key, 429 past the quickstart tenant's rate,
    B1 = B2 = flushes per tenant, each tenant's bytes beside the card's
    allocation of its install; then the same two and a third tenant with
    the hard cap between them: refused before anything of it is placed."""
    from predictionio_tpu_torch.serving import registry as registry_mod

    conf = [{"name": "ml20m", "accessKey": FLEET_KEY,
             "engineInstanceId": iid},
            {"name": "quickstart", "accessKey": QS_KEY,
             "engineInstanceId": qs_iid, "rate": FLEET_QS_RATE,
             "burst": FLEET_QS_RATE}]
    path = os.path.join(work, "engines.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    mem = collections.defaultdict(dict)

    def build(orig):
        def run(api, spec, **kw):
            torch.cuda.synchronize()
            mem[spec.name]["entry"] = torch.cuda.memory_allocated()
            return orig(api, spec, **kw)
        return run

    def reserve(orig):
        def run(reg, name, nbytes):
            torch.cuda.synchronize()
            mem[name]["before"] = torch.cuda.memory_allocated()
            mem[name]["projected"] = int(nbytes)
            try:
                return orig(reg, name, nbytes)
            except ValueError:
                torch.cuda.synchronize()
                mem[name]["refused"] = torch.cuda.memory_allocated()
                raise
        return run

    def install(orig):
        def run(reg, servable):
            torch.cuda.synchronize()
            mem[servable.name]["after"] = torch.cuda.memory_allocated()
            mem[servable.name]["model_bytes"] = servable.model_bytes
            return orig(reg, servable)
        return run

    apis, rcs = [], []

    def capture(orig):
        def run(api, *a, **kw):
            apis.append(api)
            return orig(api, *a, **kw)
        return run

    port = _free_port()
    with _wrapped((registry_mod.ModelRegistry, "reserve", reserve),
                  (registry_mod.ModelRegistry, "install", install),
                  (create_server, "serve", capture)):
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engines", path, "--ip", "127.0.0.1", "--port",
            str(port), "--serve-quant", "on"])), daemon=True)
        deploy.start()
        _wait_ready(port, deploy.is_alive, deadline_s=300)
    (api,) = apis
    launches.clear()
    rng = np.random.default_rng(seed + 47)
    ml_users = [users[u] for u in rng.choice(len(users), size=32,
                                             replace=False)]
    try:
        unknown = _raw_post(port, _qbody(ml_users[0], 10),
                            path="/queries.json?accessKey=bogus")
        missing = _raw_post(port, _qbody(ml_users[0], 10))
        if unknown[0] != 401 or missing[0] != 401:
            raise AssertionError(f"admission: {unknown[0]} / {missing[0]}")
        ml = {}
        with ThreadPoolExecutor(max_workers=FLEET_CLIENTS) as pool:
            for u, r in zip(ml_users, pool.map(lambda u: _raw_post(
                    port, _qbody(u, 10),
                    path=f"/queries.json?accessKey={FLEET_KEY}"),
                    ml_users)):
                ml[u] = r
        qs_model = api.registry.get("quickstart").models[0]
        qs_user = next(iter(qs_model.user_vocab.to_dict()))
        qs = [_raw_post(port, _qbody(qs_user, 4),
                        path=f"/queries.json?accessKey={QS_KEY}")
              for _ in range(int(FLEET_QS_RATE) + 4)]
        tenants = {name: api.registry.get(name)
                   for name in ("ml20m", "quickstart")}
        counts = {n: launches.of(s.models[0].quant)
                  for n, s in tenants.items()}
        flushes = {n: _require_flushes(f"tenant {n}", s.batcher, counts[n])
                   for n, s in tenants.items()}
        status = api.handle("GET", "/")[1]
        metrics = _get(port, "/metrics")[2].decode()
    finally:
        if cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port)]) != 0:
            raise AssertionError("pio undeploy failed")
        deploy.join(timeout=60)
    if rcs != [0]:
        raise AssertionError(f"pio deploy --engines exited {rcs}")
    for u, (st, raw, _t) in ml.items():
        if st != 200 or raw != direct["gen1"].get(u, raw) or \
                json.loads(raw) != _served(tenants["ml20m"].models[0], u, 10):
            raise AssertionError(f"tenant ml20m: {u} answered {st}")
    ok = [r for r in qs if r[0] == 200]
    limited = [r for r in qs if r[0] == 429]
    want = _served(qs_model, qs_user, 4)
    if not ok or not limited or len(ok) + len(limited) != len(qs) or any(
            json.loads(raw) != want for _s, raw, _t in ok):
        raise AssertionError(f"tenant quickstart: {[r[0] for r in qs]}")
    tenant_bytes = {n: int(float(v)) for n, v in _samples(
        metrics, "pio_tenant_model_bytes").items()}
    installs = {n: {"model_bytes": mem[n]["model_bytes"],
                    "projected_bytes": mem[n]["projected"],
                    "memory_allocated_delta": mem[n]["after"]
                    - mem[n]["before"]} for n in tenants}
    if sorted(tenant_bytes.values()) != sorted(
            i["model_bytes"] for i in installs.values()):
        raise AssertionError(f"pio_tenant_model_bytes {tenant_bytes}")
    print(f"fleet: pio deploy --engines (ml20m, quickstart): unknown key "
          f"401, missing key 401; ml20m {len(ml)} queries from "
          f"{FLEET_CLIENTS} clients, the direct bytes; quickstart "
          f"{len(ok)} answered and {len(limited)} 429 past "
          f"{FLEET_QS_RATE:g}/s; B1/B2/flushes {counts} / {flushes}; "
          f"installs {installs}; pio_tenant_model_bytes {tenant_bytes}; "
          f"total {status['modelBytesTotal']}", flush=True)

    # a third tenant past the hard cap: refused before its placement
    conf3 = conf + [{"name": "capped", "accessKey": FLEET_CAP_KEY,
                     "engineInstanceId": inst_b}]
    placed = sum(i["model_bytes"] for i in installs.values())
    third = installs["ml20m"]["projected_bytes"]
    cap_mb = (placed + third // 2) / (1024 * 1024)
    os.environ["PIO_TENANT_HBM_HARD_CAP_MB"] = repr(cap_mb)
    specs = registry_mod.parse_tenant_specs(conf3)
    mem.clear()
    with _wrapped((registry_mod.ModelRegistry, "reserve", reserve),
                  (registry_mod.ModelRegistry, "install", install),
                  (create_server.QueryAPI, "_build_servable", build)):
        try:
            capped = create_server.QueryAPI(create_server.ServerConfig(
                serve_quant="on", tenants=specs), storage=store)
            capped.close()
            raise AssertionError("the third tenant was not refused")
        except ValueError as e:
            refusal = str(e)
    os.environ.pop("PIO_TENANT_HBM_HARD_CAP_MB", None)
    m3 = mem["capped"]
    if "hard HBM cap" not in refusal or "after" in m3 \
            or not m3["entry"] == m3["before"] == m3["refused"]:
        raise AssertionError(f"cap: {refusal} {dict(m3)}")
    cap = {"cap_mb": cap_mb, "refusal": refusal,
           "memory_allocated_at_its_load": m3["entry"],
           "memory_allocated_before": m3["before"],
           "memory_allocated_after_refusal": m3["refused"],
           "projected_bytes": m3["projected"]}
    print(f"fleet: a third tenant with the hard cap at {cap_mb:.3f} MiB: "
          f"refused ({refusal}); memory_allocated {m3['entry']} when its "
          f"load began, {m3['before']} at its check and {m3['refused']} "
          "after the refusal", flush=True)
    return {"admission": {"unknown": unknown[0], "missing": missing[0],
                          "quickstart_ok": len(ok),
                          "quickstart_429": len(limited)},
            "launches": {n: {"B1": c[0], "B2": c[1], "flushes": flushes[n]}
                         for n, c in counts.items()},
            "installs": installs, "tenant_model_bytes": tenant_bytes,
            "cap": cap}


def _fleet_plugins(store, iid, users, seed, launches) -> dict:
    """(e) an output blocker that keeps three items and marks the answer,
    a sniffer that records every query, and feedback to a port event
    server: one ``predict`` event per query in the feedback app."""
    from predictionio_tpu_torch.data.api import EventAPI
    from predictionio_tpu_torch.workflow import server_plugins

    class Top3(server_plugins.EngineServerPlugin):
        plugin_name = "top3"
        plugin_type = server_plugins.OUTPUT_BLOCKER

        def process(self, inst, query_obj, prediction, ctx):
            return {**prediction, "itemScores":
                    prediction["itemScores"][:3], "blocked": True}

    class Seen(server_plugins.EngineServerPlugin):
        plugin_name = "seen"
        plugin_type = server_plugins.OUTPUT_SNIFFER

        def __init__(self):
            self.users = []

        def process(self, inst, query_obj, prediction, ctx):
            self.users.append(query_obj["user"])

    seen = Seen()
    es = EventAPI(storage=store)
    es_server, es_port = _fleet_serve(es, "threaded")
    api = create_server.QueryAPI(
        create_server.ServerConfig(
            serve_quant="on", engine_instance_id=iid, feedback=True,
            event_server_ip="127.0.0.1", event_server_port=es_port,
            access_key=FLEET_FEEDBACK_KEY),
        storage=store, plugin_context=server_plugins.
        EngineServerPluginContext([Top3(), seen]))
    server, port = _fleet_serve(api)
    launches.clear()
    rng = np.random.default_rng(seed + 53)
    who = [users[u] for u in rng.choice(len(users), size=16,
                                        replace=False)]
    app_id = store.get_meta_data_apps().get_by_name(FLEET_FEEDBACK_APP).id
    try:
        answers = {u: _raw_post(port, _qbody(u, 10)) for u in who}
        flushes = _require_flushes("plugins deploy", api,
                                   launches.of(api.models[0].quant))
        model = api.models[0]
        deadline = time.perf_counter() + 30
        while True:
            events = list(store.get_events().find(
                app_id, event_names=["predict"]))
            if len(events) >= len(who) or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
    finally:
        _fleet_stop((server, api))
        es_server.shutdown()
        es_server.server_close()
    for u, (status, raw, _t) in answers.items():
        want = _served(model, u, 10)
        want = {**want, "itemScores": want["itemScores"][:3],
                "blocked": True}
        if status != 200 or json.loads(raw) != want:
            raise AssertionError(f"plugins: {u} answered {status} {raw}")
    if sorted(seen.users) != sorted(who):
        raise AssertionError(f"the sniffer saw {seen.users}")
    # feedback carries the answer as it was before the blockers ran
    by_user = {e.properties.get("query")["user"]: e for e in events}
    if len(events) != len(who) or set(by_user) != set(who) or any(
            e.properties.get("prediction") != _served(model, u, 10)
            for u, e in by_user.items()):
        raise AssertionError(f"feedback: {len(events)} predict events for "
                             f"{len(who)} queries")
    print(f"fleet: plugins: {len(who)} queries, each answer the blocker's "
          f"rewrite of the plain int8 path, the sniffer saw all "
          f"{len(seen.users)}; --feedback stored {len(events)} predict "
          f"events; B1 = B2 = {flushes} flushes", flush=True)
    return {"queries": len(who), "sniffed": len(seen.users),
            "feedback_events": len(events), "flushes": flushes}


def _solve_row(name: str, A, b, reg) -> dict:
    """Kernel A's call, body, plain and library times and bound on one
    captured eval half-step."""
    n, r = b.shape
    Ar = solve.with_reg(A, reg)
    per, _wall = _device_profile(lambda: [
        solve.solve_factors(A, b, reg) for _ in range(50)])
    body = [us / cnt for key, (us, cnt) in per.items() if "gj_" in key]
    bound_ms, bound_by = _solve_bound_ms(n, r)
    return {"shape": name, "n": n, "r": r,
            "ms": _time_ms(lambda: solve.solve_factors(A, b, reg)),
            "body_ms": body[0] / 1e3 if body else None,
            "plain_ms": _time_ms(lambda: solve.solve_gj_plain(A, b, reg),
                                 reps=50, warm=5),
            "library_ms": _time_ms(
                lambda: torch.linalg.solve(Ar, b[..., None]), reps=50,
                warm=5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _scorer_at_full_shape(seed: int, dev: torch.device) -> dict:
    """``topk_scores_batch`` at ML-20M's 138,493 x 26,744, rank 10, k = 10
    (Gaussian factors from ``seed``) against ``torch.topk`` on the same
    chunks: values bit for bit, indices wherever a row's top k + 1 holds
    no tie."""
    rng = np.random.default_rng(seed + 3)
    U = torch.from_numpy(rng.standard_normal((N_USERS, RANK),
                                             dtype=np.float32)).to(dev)
    V = torch.from_numpy(rng.standard_normal((N_ITEMS, RANK),
                                             dtype=np.float32)).to(dev)
    rows = topk.CHUNK_BYTES // (4 * N_ITEMS)

    def library(k):
        parts = [torch.topk(U[lo:lo + rows] @ V.T, k)
                 for lo in range(0, N_USERS, rows)]
        return (torch.cat([p.values for p in parts]),
                torch.cat([p.indices for p in parts]))

    vals, idx = topk.topk_scores_batch(U, V, k=10)
    lv, li = library(11)
    torch.cuda.synchronize()
    if not torch.equal(vals.view(torch.int32),
                       lv[:, :10].contiguous().view(torch.int32)):
        raise AssertionError("topk_scores_batch values != torch.topk's")
    tied = (lv[:, 1:] == lv[:, :-1]).any(dim=1)
    if not bool((idx.long() == li[:, :10])[~tied].all()):
        raise AssertionError("topk_scores_batch indices != torch.topk's on "
                             "rows with no tie")
    # the fp32 product's operations and one compare per score; the
    # factors read once and the (b, k) answer written once
    t_ops = (2 * N_USERS * N_ITEMS * RANK + N_USERS * N_ITEMS) / FP32_OPS_S
    t_bytes = ((N_USERS + N_ITEMS) * RANK * 4 + N_USERS * 10 * 8) \
        / HBM_BYTES_S
    out = {"b": N_USERS, "n_items": N_ITEMS, "r": RANK, "k": 10,
           "chunk_rows": rows, "tied_rows": int(tied.sum()),
           "ms": _time_ms(lambda: topk.topk_scores_batch(U, V, k=10),
                          reps=5, warm=1),
           "torch_topk_ms": _time_ms(lambda: library(10), reps=5, warm=1),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(f"eval: topk_scores_batch at {N_USERS} x {N_ITEMS}, rank {RANK}, "
          f"k=10, {rows} rows a chunk: {out['ms']:.2f} ms (torch.topk on "
          f"the same chunks {out['torch_topk_ms']:.2f} ms, bound "
          f"{out['bound_ms']:.3f} ms, {out['bound_by']}); values equal "
          f"torch.topk's bit for bit, indices on the "
          f"{N_USERS - out['tied_rows']} rows with no tie", flush=True)
    return out


def phase_eval(work: str, seed: int, dev: torch.device, n_events: int):
    """``pio eval`` of the reference's grid through the port's CLI on the
    card, on the app the quickstart phase filled (``n_events`` events in
    its default channel); returns kernel A's eval launches, its rows at
    ranks 5, 10 and 20, and the phase's numbers."""
    env = _store_env(work)
    t_phase = time.perf_counter()
    engine_dir = os.path.join(work, "eval_engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "smoke_grid.py"), "w") as f:
        f.write(GRID_MODULE)
    best = os.path.join(work, "best.json")

    workflows, captured = [], {}
    seconds = {}

    def note(key, t_start):
        torch.cuda.synchronize()
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t_start

    class Recorded(core_workflow.FastEvalEngineWorkflow):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            workflows.append(self)

    def timed(key_of):
        def make(fn):
            def run(self, *a, **kw):
                t_start = time.perf_counter()
                out = fn(self, *a, **kw)
                note(key_of(self), t_start)
                return out
            return run
        return make

    def capture(fn):
        def run(A, b, reg):
            x = fn(A, b, reg)
            r = A.shape[-1]
            if r not in captured:     # the first half-step at each rank
                captured[r] = tuple(t.clone() for t in (A, b, reg, x))
            return x
        return run

    def variant(algo):
        return algo.ap.rank, algo.ap.numIterations

    argv = ["eval", "predictionio_tpu_torch.models.recommendation."
            "evaluation:RecommendationEvaluation", "smoke_grid:SmokeGrid",
            "--engine-dir", engine_dir, "--output-best-engine-params", best]
    with _wrapped(
            (core_workflow, "FastEvalEngineWorkflow", lambda _c: Recorded),
            (als, "solve_factors", capture),
            (DataSource, "read_eval", timed(lambda _s: "read_eval")),
            (ALSAlgorithm, "prepare_layout", timed(lambda _s: "layouts")),
            (ALSAlgorithm, "train",
             timed(lambda a: ("train",) + variant(a))),
            (ALSAlgorithm, "batch_predict",
             timed(lambda a: ("batch_predict",) + variant(a))),
            (MetricEvaluator, "evaluate_base", timed(lambda _s: "metrics"))):
        solve.reset_launches()           # the eval path starts here
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = solve.launches        # the eval path ends here
    if rc != 0:
        raise AssertionError(f"pio eval exited {rc}")
    n_grid = len(EVAL_RANKS) * len(EVAL_ITERS)
    want_launches = 2 * sum(EVAL_ITERS) * len(EVAL_RANKS) * EVAL_K_FOLD
    if launches != want_launches:
        raise AssertionError(f"solve_gj launched {launches} times in the "
                             f"eval (want {want_launches})")
    (wf,) = workflows
    want_counts = {"read_eval": 1, "prepare": 1, "train": n_grid,
                   "serve": n_grid, "layout_prefixes": 1}
    if wf.counts != want_counts:
        raise AssertionError(f"FastEval counts {wf.counts}, want "
                             f"{want_counts}")
    (row,) = storage_mod.Storage(env=env) \
        .get_meta_data_evaluation_instances().get_all()
    if row.status != "EVALCOMPLETED":
        raise AssertionError(f"eval left its row {row.status}")
    result = json.loads(row.evaluator_results_json)
    if "Precision@K" not in result["metricHeader"]:
        raise AssertionError(f"unexpected metric {result['metricHeader']}")
    with open(best) as f:
        best_params = RecommendationEngine().engine_params_from_json(
            json.load(f))
    scores = result["engineParamsScores"]
    for s in scores:
        if not (math.isfinite(s["score"]) and 0.0 <= s["score"] <= 1.0):
            raise AssertionError(f"Precision@K {s['score']} not in [0, 1]")
        if not s["otherScores"][0] > 0:
            raise AssertionError("PositiveCount is not positive")
    # kernel A against its plain version on the captured half-steps
    solve_rows = []
    for r in EVAL_RANKS:
        A, b, reg, x = captured[r]
        p = solve.solve_gj_plain(A, b, reg)
        same = _bitwise_same(x, p)
        if not bool(same.all()):
            raise AssertionError(f"solve_gj != plain on the eval's rank-{r} "
                                 f"half-step: {int((~same).sum())} differ")
        solve_rows.append({**_solve_row(f"eval r{r}", A, b, reg),
                           "max_abs_err": float((x - p).abs().max())})
    # the rank-20, 10-iteration variant again, from a fresh workflow
    grid = evaluation.engine_params_list(EVAL_APP, EVAL_K_FOLD,
                                         EVAL_QUERY_NUM)
    ix = [(ep.algorithm_params_list[0][1].rank,
           ep.algorithm_params_list[0][1].numIterations)
          for ep in grid].index((20, 10))
    again = core_workflow.run_evaluation(
        WorkflowContext(), evaluation.RecommendationEvaluation(), [grid[ix]])
    first = scores[ix]
    rerun = again.engine_params_scores[0]
    if [first["score"], *first["otherScores"]] != \
            [rerun.score, *rerun.other_scores]:
        raise AssertionError("a second eval of rank 20 x 10 iterations "
                             "gave other scores")

    # one fold's rank-20 train + batch_predict under the profiler
    pd0 = next(iter(wf.preparator_cache.values()))[0]
    qa0 = next(iter(wf.data_source_cache.values()))[0][2]
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=20, numIterations=10,
                                           lambda_=0.01, seed=3))
    ctx = WorkflowContext()
    queries = list(enumerate(q for q, _a in qa0))
    per, pwall = _device_profile(lambda: algo.batch_predict(
        algo.train(ctx, pd0), queries))
    busy_ms = sum(us for us, _n in per.values()) / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    scorer = _scorer_at_full_shape(seed, dev)

    split = {"phase_s": time.perf_counter() - t_phase, "eval_wall_s": wall,
             "read_eval_s": seconds["read_eval"],
             "layouts_s": seconds["layouts"],
             "train_s_by_rank": {r: sum(v for k, v in seconds.items()
                                        if k[0] == "train" and k[1] == r)
                                 for r in EVAL_RANKS},
             "train_s": {f"r{k[1]}_i{k[2]}": v for k, v in seconds.items()
                         if k[0] == "train"},
             "batch_predict_s": {f"r{k[1]}_i{k[2]}": v
                                 for k, v in seconds.items()
                                 if k[0] == "batch_predict"},
             "metrics_s": seconds["metrics"]}
    out = {"ratings": n_events, "users": EVAL_USERS, "items": N_ITEMS,
           "k_fold": EVAL_K_FOLD, "variants": n_grid,
           "solve_gj_launches": launches, "counts": wf.counts,
           "best": {"rank": best_params.algorithm_params_list[0][1].rank,
                    "numIterations": best_params.algorithm_params_list[0][
                        1].numIterations, "score": result["bestScore"][
                            "score"]},
           "scores": [[s["engineParams"]["algorithmParamsList"][0][
               "params"]["rank"], s["engineParams"]["algorithmParamsList"][
                   0]["params"]["numIterations"], s["score"],
               s["otherScores"]] for s in scores],
           "split": split, "profiled_fold_r20": {
               "wall_ms": pwall * 1e3, "device_busy_ms": busy_ms,
               "idle_share": 1 - busy_ms / (pwall * 1e3) if per else None,
               "top": [[k[:60], us, n] for k, (us, n) in top]},
           "scorer_ml20m": scorer, "bit_identical_rerun": True}
    print(f"eval: the phase took {split['phase_s']:.1f} s with its checks; "
          f"the quickstart's app, {n_events} ratings ({EVAL_USERS} users "
          f"x {N_ITEMS} items and the event server's); pio eval of {n_grid} "
          f"variants x {EVAL_K_FOLD} folds in {wall:.1f} s: read_eval "
          f"{seconds['read_eval']:.2f} s, layouts {seconds['layouts']:.3f} "
          "s, train by rank " + ", ".join(
              f"r{r} {v:.3f} s" for r, v in
              split["train_s_by_rank"].items())
          + f", batch_predict {sum(split['batch_predict_s'].values()):.2f} "
          f"s, metrics {seconds['metrics']:.2f} s; counts {wf.counts}; "
          f"solve_gj launched {launches} times, == plain on ranks "
          f"{list(EVAL_RANKS)}; best {out['best']}; the rank-20 x 10 rerun "
          "is bit-identical", flush=True)
    for row_a in solve_rows:
        print(f"eval: solve_gj n={row_a['n']} r={row_a['r']}: call "
              f"{row_a['ms']:.4f} ms (device body {row_a['body_ms']} ms), "
              f"plain {row_a['plain_ms']:.4f} ms, torch.linalg.solve "
              f"{row_a['library_ms']:.4f} ms, bound "
              f"{row_a['bound_ms']:.5f} ms ({row_a['bound_by']})",
              flush=True)
    idle = out["profiled_fold_r20"]["idle_share"]
    print(f"eval: one fold's rank-20 train + batch_predict profiled: wall "
          f"{pwall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; top device "
          "entries " + "; ".join(f"{k[:60]} {us / 1e3:.2f} ms x{n}"
                                 for k, (us, n) in top), flush=True)
    print("eval: " + json.dumps(out), flush=True)
    return launches, solve_rows, out

# ---------------------------------------------------------------------------
# phase 9: the classification, similar-product and e-commerce templates
# ---------------------------------------------------------------------------

def _template_events(seed: int):
    """The shop app's events from ``seed``, in chunks of Events, and the
    truth the checks read: each item's category, each user's viewed and
    bought items, the unavailable and weight-0 items, the visitors (view
    events, no ``$set``) and the query items (drawn by popularity).

    Items fall in TPL_CATEGORIES categories; each user has a home
    category that takes TPL_HOME_SHARE of their events; within a
    category, item popularity falls as 1 / (rank + 50)."""
    rng = np.random.default_rng(seed + 11)
    item_cat = rng.integers(0, TPL_CATEGORIES, N_ITEMS)
    home = rng.integers(0, TPL_CATEGORIES, TPL_USERS)
    members = [rng.permutation(np.flatnonzero(item_cat == c))
               for c in range(TPL_CATEGORIES)]
    width = min(len(m) for m in members)
    by_cat = np.stack([m[:width] for m in members])    # (cats, width)
    pmf = 1.0 / (np.arange(width) + 50.0)
    pmf /= pmf.sum()

    def draw(users):
        own = rng.random(users.shape[0]) < TPL_HOME_SHARE
        cat = np.where(own, home[users % TPL_USERS],
                       rng.integers(0, TPL_CATEGORIES, users.shape[0]))
        return by_cat[cat, rng.choice(width, users.shape[0], p=pmf)], own

    n_visit = TPL_VISITORS * TPL_VISITOR_VIEWS
    view_u = rng.integers(0, TPL_USERS, TPL_VIEWS - n_visit)
    view_i, _own = draw(view_u)
    visit_u = np.repeat(np.arange(TPL_VISITORS), TPL_VISITOR_VIEWS)
    visit_i, _own = draw(visit_u)
    rate_u = rng.integers(0, TPL_USERS, TPL_RATES)
    rate_i, own = draw(rate_u)
    rating = np.clip(np.round((np.where(own, 4.0, 2.0) + rng.normal(
        0.0, 0.8, TPL_RATES)) * 2) / 2, 1.0, 5.0)
    buy_u = rng.integers(0, TPL_USERS, TPL_BUYS)
    buy_i, _own = draw(buy_u)
    popular = by_cat[:, :40].ravel()          # each category's top 40
    hidden = rng.choice(popular, TPL_UNAVAILABLE + 2 * TPL_ZERO_WEIGHT,
                        replace=False)
    unavailable = hidden[:TPL_UNAVAILABLE]
    zero = hidden[TPL_UNAVAILABLE:TPL_UNAVAILABLE + TPL_ZERO_WEIGHT]
    boost = hidden[TPL_UNAVAILABLE + TPL_ZERO_WEIGHT:]
    queries = rng.choice(view_i, 4 * TPL_QUERIES)
    queries = list(dict.fromkeys(queries.tolist()))[:TPL_QUERIES]

    t0 = _dt.datetime(2024, 1, 1, tzinfo=_dt.timezone.utc)
    clock = iter(range(10 ** 9))

    def event(name, etype, eid, props=None, target=None):
        return Event(event=name, entity_type=etype, entity_id=eid,
                     target_entity_type="item" if target else None,
                     target_entity_id=target,
                     properties=DataMap(props or {}),
                     event_time=t0 + _dt.timedelta(seconds=next(clock)))

    def chunks():
        yield [event("$set", "user", f"u{u}") for u in range(TPL_USERS)]
        yield [event("$set", "item", f"i{i}",
                     {"categories": [f"c{item_cat[i]}"]})
               for i in range(N_ITEMS)]
        for name, users, items in (("view", view_u, view_i),
                                   ("buy", buy_u, buy_i)):
            for lo in range(0, users.shape[0], 50_000):
                yield [event(name, "user", f"u{u}", target=f"i{i}")
                       for u, i in zip(users[lo:lo + 50_000].tolist(),
                                       items[lo:lo + 50_000].tolist())]
        for lo in range(0, TPL_RATES, 50_000):
            yield [event("rate", "user", f"u{u}", {"rating": r}, f"i{i}")
                   for u, i, r in zip(rate_u[lo:lo + 50_000].tolist(),
                                      rate_i[lo:lo + 50_000].tolist(),
                                      rating[lo:lo + 50_000].tolist())]
        yield [event("view", "user", f"v{u}", target=f"i{i}")
               for u, i in zip(visit_u.tolist(), visit_i.tolist())]
        yield [event("$set", "constraint", "unavailableItems",
                     {"items": [f"i{i}" for i in unavailable.tolist()]}),
               event("$set", "constraint", "weightedItems", {"weights": [
                   {"items": [f"i{i}" for i in zero.tolist()],
                    "weight": 0.0},
                   {"items": [f"i{i}" for i in boost.tolist()],
                    "weight": 1.5}]})]

    seen = [set() for _ in range(TPL_USERS)]
    for users, items in ((view_u, view_i), (buy_u, buy_i)):
        for u, i in zip(users.tolist(), items.tolist()):
            seen[u].add(f"i{i}")
    truth = {"item_cat": item_cat, "seen": seen,
             "unavailable": {f"i{i}" for i in unavailable.tolist()},
             "zero": {f"i{i}" for i in zero.tolist()},
             "queries": [f"i{i}" for i in queries],
             "n_events": (TPL_USERS + N_ITEMS + TPL_VIEWS + TPL_BUYS
                          + TPL_RATES + 2)}
    return chunks, truth


def _plan_points(seed: int):
    """NB_USERS + NB_HELD_OUT points: plan ids 1.0..4.0, three attribute
    counts whose proportions depend on the plan."""
    rng = np.random.default_rng(seed + 12)
    y = rng.integers(0, NB_CLASSES, NB_USERS + NB_HELD_OUT)
    x = rng.poisson(NB_RATES[y]).astype(np.float64)
    return y.astype(np.float64) + 1.0, x


def _write_templates_data(store, seed: int):
    """Both apps through ``pio app new``, their events through
    ``store.write``; returns the shop's truth, the held-out points and
    the write's numbers."""
    for app in (TPL_APP, NB_APP):
        if cli.main(["app", "new", app]) != 0:
            raise AssertionError(f"pio app new {app} failed")
    apps = store.get_meta_data_apps()
    shop_id, plans_id = (apps.get_by_name(a).id for a in (TPL_APP, NB_APP))
    chunks, truth = _template_events(seed)
    t0 = time.perf_counter()
    n_shop = 0
    for chunk in chunks():
        store_mod.write(chunk, shop_id, storage=store)
        n_shop += len(chunk)
    shop_s = time.perf_counter() - t0
    if n_shop != truth["n_events"]:
        raise AssertionError(f"wrote {n_shop} shop events, want "
                             f"{truth['n_events']}")
    labels, x = _plan_points(seed)
    t_clock = _dt.datetime(2024, 2, 1, tzinfo=_dt.timezone.utc)
    t0 = time.perf_counter()
    for lo in range(0, NB_USERS, 50_000):
        store_mod.write([Event(
            event="$set", entity_type="user", entity_id=f"p{k}",
            properties=DataMap({"plan": labels[k], "attr0": x[k, 0],
                                "attr1": x[k, 1], "attr2": x[k, 2]}),
            event_time=t_clock + _dt.timedelta(seconds=k))
            for k in range(lo, min(lo + 50_000, NB_USERS))],
            plans_id, storage=store)
    plans_s = time.perf_counter() - t0
    env = {"PIO_FS_BASEDIR": os.environ["PIO_FS_BASEDIR"]}
    for app_id, want in ((shop_id, n_shop), (plans_id, NB_USERS)):
        got = _count_events(env, app_id)
        if got != want:
            raise AssertionError(f"app {app_id} holds {got} events, want "
                                 f"{want}")
    held = (labels[NB_USERS:], x[NB_USERS:])
    out = {"shop_events": n_shop, "shop_write_s": shop_s,
           "shop_events_per_s": n_shop / shop_s, "plan_events": NB_USERS,
           "plans_write_s": plans_s, "plans_events_per_s": NB_USERS / plans_s}
    print(f"templates: store.write of {n_shop} shop events in {shop_s:.2f} "
          f"s ({n_shop / shop_s:.0f} events/s) and {NB_USERS} plan $sets "
          f"in {plans_s:.2f} s, counted with sqlite3", flush=True)
    return truth, held, out


def _template_train(work: str, store, name: str, variant: dict,
                    want_launches: int):
    """``pio train`` of one template from an engine.json in its own
    directory; kernel A must launch ``want_launches`` times. Returns the
    engine directory, the stored row, the model blob's models and the
    train's numbers."""
    engine_dir = os.path.join(work, f"{name}_engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as f:
        json.dump(variant, f)
    instances = store.get_meta_data_engine_instances()
    before = {r.id for r in instances.get_all()}
    solve.reset_launches()               # this template's train starts
    topk_fused.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--engine-dir", engine_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = solve.launches            # ... and ends here
    if rc != 0:
        raise AssertionError(f"pio train of {name} exited {rc}")
    if launches != want_launches or topk_fused.launches:
        raise AssertionError(
            f"{name}: solve_gj launched {launches} times (want "
            f"{want_launches}), topk_fused {topk_fused.launches}")
    (row,) = [r for r in instances.get_all() if r.id not in before]
    if row.status != "COMPLETED":
        raise AssertionError(f"{name}: train left the instance "
                             f"{row.status}")
    models = model_io.deserialize_models(
        store.get_model_data_models().get(row.id).models)
    phases = {k[len("phase_"):-len("_s")]: float(v)
              for k, v in row.runtime_conf.items()
              if k.startswith("phase_")}
    return engine_dir, row, models, {"wall_s": wall, "phases_s": phases,
                                     "solve_gj_launches": launches}


def _template_serve(engine_dir: str, iid: str, bodies):
    """``pio deploy`` of the instance in a thread, ``bodies`` POSTed in
    sequence on one connection, ``pio undeploy``. Nothing may launch a
    kernel: these templates score on the host, as the reference does."""
    apis = []

    class Recorded(create_server.QueryAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apis.append(self)

    port, rcs = _free_port(), []
    with _wrapped((create_server, "QueryAPI", lambda _c: Recorded)):
        solve.reset_launches()           # the template's deploy starts
        topk_fused.reset_launches()
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--engine-instance-id",
            iid, "--ip", "127.0.0.1", "--port", str(port)])), daemon=True)
        deploy.start()
        ready_s = _wait_ready(port, deploy.is_alive)
        c = _Client(port)
        try:
            answers = [c.call("POST", "/queries.json", b) for b in bodies]
        finally:
            c.close()
        (api,) = apis
        stats = api.handle("GET", "/")[1]
        if cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port)]) != 0:
            raise AssertionError("pio undeploy failed")
        deploy.join(timeout=60)
    if rcs != [0] or deploy.is_alive():
        raise AssertionError(f"pio deploy exited {rcs}")
    if solve.launches or topk_fused.launches or topk_fused.merge_launches:
        raise AssertionError("a template's serving path launched a kernel")
    bad = [(s, p) for s, p, _t in answers if s != 200 or p.get("degraded")]
    if bad:
        raise AssertionError(f"{len(bad)} answers failed or degraded: "
                             f"{bad[:3]}")
    p50, p99 = _pct([t for _s, _p, t in answers])
    return [p for _s, p, _t in answers], api, {
        "ready_s": ready_s, "query_ms": {"p50": p50, "p99": p99,
                                         "n": len(answers)},
        "degradedCount": stats["degradedCount"]}


def _gj_bodies(per: dict) -> dict:
    """Kernel A's mean device time per launch (over both half-steps'
    shapes) and its launch count in a profile."""
    rows = [(us, n) for key, (us, n) in per.items() if "gj_" in key]
    if not rows:
        raise AssertionError("the profiler recorded no solve_gj kernel")
    us, n = rows[0]
    return {"mean_body_ms": us / n / 1e3, "profiled_launches": n}


def _retrain_profiled(algo, ctx, td, stored, fields, name: str):
    """The template's train again from the same seed, under
    torch.profiler: its factors must equal the stored model's bit for
    bit; returns kernel A's bodies and the train's idle share."""
    trained = []
    per, wall = _device_profile(lambda: trained.append(algo.train(ctx, td)))
    for f in fields:
        if getattr(trained[-1], f).tobytes() != getattr(stored, f).tobytes():
            raise AssertionError(f"{name}: a second train from the seed "
                                 f"gave other {f}")
    busy_ms = sum(us for us, _n in per.values()) / 1e3
    return {**_gj_bodies(per), "profiled_train_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3)}


def _one_iteration_card_vs_cpu(coo, n_users: int, n_items: int,
                               params: dict, dev: torch.device):
    """One implicit iteration on the card (kernel A) and on the CPU (its
    plain version) from one seed; the card's two half-steps are captured
    and held against the plain sweep bit for bit, then timed."""
    captured = []

    def capture(fn):
        def run(A, b, reg):
            x = fn(A, b, reg)
            captured.append(tuple(t.clone() for t in (A, b, reg, x)))
            return x
        return run

    kw = dict(rank=params["rank"], iterations=1, lambda_=params["lambda"],
              alpha=1.0, seed=params["seed"])
    data = als.prepare_ratings(*coo, n_users=n_users, n_items=n_items,
                               on_device=True, device=dev)
    with _wrapped((als, "solve_factors", capture)):
        U, V = als.train_implicit(data, device=dev, **kw)
    torch.cuda.synchronize()
    host = als.prepare_ratings(*coo, n_users=n_users, n_items=n_items)
    CU, CV = als.train_implicit(host, device="cpu", **kw)
    errs = {}
    for side, got, want in (("U", U, CU), ("V", V, CV)):
        g, w = got.cpu().numpy(), want.numpy()
        diff = np.abs(g - w)
        errs[side] = {"max_abs_err": float(diff.max()),
                      "max_rel_err": float((diff / np.maximum(
                          np.abs(w), 1e-30)).max())}
        if not np.allclose(g, w, rtol=ITER_RTOL, atol=ITER_ATOL):
            raise AssertionError(
                f"one implicit iteration: card {side} != CPU {side} beyond "
                f"rtol {ITER_RTOL} / atol {ITER_ATOL}: {errs[side]}")
    rows = []
    for (A, b, reg, x), side in zip(captured, ("users", "items")):
        p = solve.solve_gj_plain(A, b, reg)
        same = _bitwise_same(x, p)
        if not bool(same.all()):
            raise AssertionError(f"solve_gj != plain on the implicit "
                                 f"{side} half-step: "
                                 f"{int((~same).sum())} differ")
        rows.append({**_solve_row(f"implicit {side}", A, b, reg),
                     "max_abs_err": float((x - p).abs().max())})
    return errs, rows


def _instantiate(engine, variant: dict):
    """The data source and the algorithm of an engine.json variant."""
    ds, _prep, (algo,), _serving = engine._instantiate(
        engine.engine_params_from_json(variant))
    return ds, algo


def _coo(algo, td):
    """The COO ratings a template's train hands ``prepare_ratings``."""
    user_vocab = BiMap.string_int(td.users.keys())
    item_vocab = BiMap.string_int(td.items.keys())
    ratings = algo._ratings(td, user_vocab, item_vocab)
    return ((np.array([u for u, _ in ratings], dtype=np.int32),
             np.array([i for _, i in ratings], dtype=np.int32),
             np.array(list(ratings.values()), dtype=np.float32)),
            len(user_vocab), len(item_vocab))


def _run_similarproduct(work, store, truth, dev):
    params = {"rank": TPL_RANK, "numIterations": TPL_ITERS,
              "lambda": 0.01, "seed": 3}
    variant = {"id": "smoke-similarproduct",
               "engineFactory": "predictionio_tpu.models.similarproduct."
                                "engine:SimilarProductEngine",
               "datasource": {"params": {"appName": TPL_APP}},
               "algorithms": [{"name": "als", "params": params}]}
    engine_dir, row, (model,), train = _template_train(
        work, store, "similarproduct", variant, 2 * TPL_ITERS)
    ctx = WorkflowContext(storage=store)
    ds, algo = _instantiate(SimilarProductEngine(), variant)
    td = ds.read_training(ctx)
    train.update(_retrain_profiled(algo, ctx, td, model,
                                   ("product_features",), "similarproduct"))
    coo, n_users, n_items = _coo(algo, td)
    errs, rows = _one_iteration_card_vs_cpu(coo, n_users, n_items, params,
                                            dev)
    bodies = [{"items": [q], "num": 10} for q in truth["queries"]]
    answers, _api, serve = _template_serve(engine_dir, row.id, bodies)
    same = total = 0
    for q, ans in zip(truth["queries"], answers):
        items = [s["item"] for s in ans["itemScores"]]
        if not items or len(items) > 10 or q in items:
            raise AssertionError(f"similar to {q}: {ans}")
        cat = truth["item_cat"][int(q[1:])]
        same += sum(truth["item_cat"][int(i[1:])] == cat for i in items)
        total += len(items)
    share = same / total
    if share < 0.5:
        raise AssertionError(f"similar-product: {share:.3f} of the answers "
                             "share the query item's category (want 0.5)")
    out = {"users": n_users, "items": n_items, "ratings": len(coo[0]),
           "train": train, "one_iteration_vs_cpu": errs,
           "same_category_share": share, "serve": serve}
    return out, rows


def _run_ecommerce(work, store, truth, dev):
    params = {"appName": TPL_APP, "unseenOnly": True,
              "seenEvents": ["buy", "view"], "similarEvents": ["view"],
              "rank": TPL_RANK, "numIterations": TPL_ITERS,
              "lambda": 0.01, "seed": 3, "weightedItems": True}
    variant = {"id": "smoke-ecommerce",
               "engineFactory": "predictionio_tpu.models.ecommerce.engine:"
                                "ECommerceEngine",
               "datasource": {"params": {"appName": TPL_APP}},
               "algorithms": [{"name": "ecomm", "params": params}]}
    engine_dir, row, (model,), train = _template_train(
        work, store, "ecommerce", variant, 2 * TPL_ITERS)
    ctx = WorkflowContext(storage=store)
    ds, algo = _instantiate(ECommerceEngine(), variant)
    td = ds.read_training(ctx)
    train.update(_retrain_profiled(
        algo, ctx, td, model, ("user_features", "product_features"),
        "ecommerce"))
    rng = np.random.default_rng(TPL_QUERIES)
    users = [f"u{u}" for u in rng.choice(TPL_USERS, TPL_QUERIES
                                         - TPL_VISITORS // 4, replace=False)]
    visitors = [f"v{v}" for v in range(TPL_VISITORS // 4)]
    answers, _api, serve = _template_serve(
        engine_dir, row.id, [{"user": u, "num": 10}
                             for u in users + visitors])
    hidden = truth["unavailable"] | truth["zero"]
    for user, ans in zip(users + visitors, answers):
        items = {s["item"] for s in ans["itemScores"]}
        if not items:
            raise AssertionError(f"e-commerce: {user} got no answer")
        if user[0] == "u" and items & truth["seen"][int(user[1:])]:
            raise AssertionError(f"e-commerce: {user} was offered items "
                                 "they viewed or bought")
        if items & hidden:
            raise AssertionError(f"e-commerce: {user} was offered "
                                 f"{sorted(items & hidden)}, unavailable "
                                 "or weighted 0")
    out = {"users": len(model.user_vocab), "items": len(model.item_vocab),
           "train": train, "serve": serve,
           "queries": {"known_users": len(users),
                       "visitors": len(visitors)}}
    return out


def _run_classification(work, store, held, dev):
    variant = {"id": "smoke-classification",
               "engineFactory": "predictionio_tpu.models.classification."
                                "engine:ClassificationEngine",
               "datasource": {"params": {"appName": NB_APP}},
               "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}]}
    engine_dir, row, (model,), train = _template_train(
        work, store, "classification", variant, 0)
    ds, _algo = _instantiate(ClassificationEngine(), variant)
    td = ds.read_training(WorkflowContext(storage=store))
    classes, y = td.encode_labels()
    ref = naive_bayes.train(td.features_array(), y, lambda_=1.0,
                            n_classes=len(classes), device="cpu")
    rel = {}
    for f in ("pi", "theta"):
        got, want = getattr(model.nb, f), getattr(ref, f).numpy()
        rel[f] = float((np.abs(got - want) / np.abs(want)).max())
        if rel[f] > NB_RTOL:
            raise AssertionError(f"NB {f} on the card vs the CPU: max "
                                 f"relative error {rel[f]} > {NB_RTOL}")
    labels, x = held
    answers, api, serve = _template_serve(
        engine_dir, row.id, [{"features": row_x.tolist()} for row_x in x])
    served_on = api.models[0].nb.pi.device.type
    if served_on != dev.type:
        raise AssertionError(f"NB served on {served_on}, not {dev.type}")
    acc = float(np.mean([a["label"] == lbl
                         for a, lbl in zip(answers, labels.tolist())]))
    if acc < 0.9:
        raise AssertionError(f"NB deploy accuracy {acc} < 0.9 on "
                             f"{len(labels)} held-out points")
    return {"points": len(td.labeled_points), "classes": len(classes),
            "train": train, "pi_theta_max_rel_err_vs_cpu": rel,
            "held_out_accuracy": acc, "serve": serve}


def phase_templates(work: str, seed: int, dev: torch.device):
    """The classification, similar-product and e-commerce templates
    through the port's CLI on the card, on apps filled from ``seed``;
    returns kernel A's launches in the two ALS trains, its rows on the
    implicit half-steps and the phase's numbers."""
    env = _store_env(work)
    t_phase = time.perf_counter()
    store = storage_mod.Storage(env=env)
    truth, held, write = _write_templates_data(store, seed)
    sim_out, rows = _run_similarproduct(work, store, truth, dev)
    ecom_out = _run_ecommerce(work, store, truth, dev)
    cls_out = _run_classification(work, store, held, dev)
    out = {"write": write, "similarproduct": sim_out,
           "ecommerce": ecom_out, "classification": cls_out,
           "phase_s": time.perf_counter() - t_phase}
    for name, o in (("similarproduct", sim_out), ("ecommerce", ecom_out),
                    ("classification", cls_out)):
        t, s = o["train"], o["serve"]
        body = (f"; kernel A {t['solve_gj_launches']} launches, mean "
                f"body {t['mean_body_ms']:.4f} ms, the profiled retrain "
                f"idle {t['idle_share']:.4f} and bit-identical"
                if "mean_body_ms" in t else "; no kernel A")
        print(f"templates: {name}: pio train {t['wall_s']:.2f} s (" + ", "
              .join(f"{k} {v:.3f} s" for k, v in t["phases_s"].items())
              + f"){body}; pio deploy ready in {s['ready_s']:.3f} s; "
              f"{s['query_ms']['n']} sequential queries p50 "
              f"{s['query_ms']['p50']:.3f} ms p99 "
              f"{s['query_ms']['p99']:.3f} ms; none degraded", flush=True)
    print(f"templates: similar-product: {sim_out['same_category_share']:.4f}"
          " of the top-10 answers share the query item's category (chance "
          f"{1 / TPL_CATEGORIES}); one implicit iteration on the card vs "
          f"the CPU: {sim_out['one_iteration_vs_cpu']}", flush=True)
    print(f"templates: e-commerce: {ecom_out['queries']} answered with no "
          "seen, unavailable or weight-0 item; classification: held-out "
          f"accuracy {cls_out['held_out_accuracy']:.4f}, pi / theta vs the "
          f"CPU max relative error {cls_out['pi_theta_max_rel_err_vs_cpu']}",
          flush=True)
    for row_a in rows:
        print(f"templates: solve_gj {row_a['shape']} n={row_a['n']} "
              f"r={row_a['r']}: == plain; call {row_a['ms']:.4f} ms (device "
              f"body {row_a['body_ms']} ms), plain {row_a['plain_ms']:.4f} "
              f"ms, torch.linalg.solve {row_a['library_ms']:.4f} ms, bound "
              f"{row_a['bound_ms']:.5f} ms ({row_a['bound_by']})",
              flush=True)
    print("templates: " + json.dumps(out), flush=True)
    return (sim_out["train"]["solve_gj_launches"],
            ecom_out["train"]["solve_gj_launches"], rows, out)


# the store phase: ML-20M's shape in an eventlog store (events in the
# eventlog directory, metadata on SQLite, models as files beside them)
STORE_APP, STORE_IMPORT_APP = "SmokeEventlog", "SmokeEventlogImport"
STORE_KEY = "smoke-eventlog-key"
STORE_CURSOR_BATCHES = 20                   # x 50 = 1,000 events
STORE_QUERIES = 16
STORE_KW = dict(entity_type="user", event_names=["rate", "buy"],
                target_entity_type="item")
#: the encoded columns of ColumnarEvents a read must reproduce
STORE_COLS = ("entity_idx", "target_idx", "event_name_idx", "rating")


def _eventlog_env(work: str) -> dict:
    root = os.path.join(work, "eventlog_store")
    return {
        "PIO_STORAGE_SOURCES_META_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_META_PATH": os.path.join(root, "meta.sqlite"),
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(root, "eventlog"),
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(root, "models"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }


def _engine_dir(work: str, name: str, app: str) -> str:
    """An engine directory holding the template's engine.json pointed at
    ``app``."""
    path = os.path.join(work, name)
    os.makedirs(path)
    with open(ENGINE_JSON) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["appName"] = app
    with open(os.path.join(path, "engine.json"), "w") as f:
        json.dump(variant, f)
    return path


def _store_train(engine_dir: str, store, iters: int, mode) -> dict:
    """One ``pio train`` from an eventlog app with PIO_TRAIN_STREAM set to
    ``mode`` (None: unset, the default auto), under torch.profiler: its
    phases, kernel A's launches, the staged copies and layout-cache
    outcomes it caused, and the device's idle share over the whole train;
    and the stored model."""
    if mode is None:
        os.environ.pop("PIO_TRAIN_STREAM", None)
    else:
        os.environ["PIO_TRAIN_STREAM"] = mode
    instances = store.get_meta_data_engine_instances()
    before = {r.id for r in instances.get_all()}
    stats = als_algorithm.LAYOUT_STATS
    hits, builds, copies = stats["hits"], stats["builds"], staging.copies
    rcs = []
    solve.reset_launches()               # this train's path starts here
    per, wall = _device_profile(
        lambda: rcs.append(cli.main(["train", "--engine-dir", engine_dir])),
        attempts=1)
    launches = solve.launches            # and ends here
    if rcs != [0]:
        raise AssertionError(f"pio train ({mode}) exited {rcs}")
    if launches != 2 * iters:
        raise AssertionError(f"solve_gj launched {launches} times in "
                             f"{iters} iterations (mode {mode})")
    (row,) = [r for r in instances.get_all() if r.id not in before]
    if row.status != "COMPLETED":
        raise AssertionError(f"train left the instance {row.status}")
    (model,) = model_io.deserialize_models(
        store.get_model_data_models().get(row.id).models)
    busy_ms = sum(us for us, _n in per.values()) / 1e3
    return {"mode": mode or "auto (unset)", "instance": row.id,
            "wall_s": wall,
            "phases_s": {k[len("phase_"):-len("_s")]: float(v)
                         for k, v in row.runtime_conf.items()
                         if k.startswith("phase_")},
            "solve_gj_launches": launches,
            "staged_chunks": staging.copies - copies,
            "layout_hits": stats["hits"] - hits,
            "layout_builds": stats["builds"] - builds,
            "device_busy_ms": busy_ms if per else None,
            "idle_share": 1 - busy_ms / (wall * 1e3) if per else None}, \
        model


def _same_factors(a, b) -> bool:
    return (a.user_factors.tobytes() == b.user_factors.tobytes()
            and a.item_factors.tobytes() == b.item_factors.tobytes())


def _cursor_check(store, app_id: int) -> dict:
    """head_cursor, then 1,000 events in batches of 50 through the event
    server over HTTP; cursor_lag must read 1,000 and read_columns_since
    must return exactly those rows, in order."""
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service

    ev = store.get_events()
    head = ev.head_cursor(app_id)
    server, port = http_mod.serve_background(
        service.EventAPI(storage=store), "127.0.0.1", 0)
    sent = []
    c = _Client(port)
    try:
        t0 = time.perf_counter()
        for b in range(STORE_CURSOR_BATCHES):
            batch = [_rate(f"cur{b}", f"i{(b * 50 + k) % N_ITEMS}",
                           float(k % 10 + 1) / 2) for k in range(50)]
            status, results, _t = c.call(
                "POST", f"/batch/events.json?accessKey={STORE_KEY}", batch)
            if status != 200 or [r["status"] for r in results] != [201] * 50:
                raise AssertionError(f"cursor batch {b}: {status}")
            sent += batch
        post_s = time.perf_counter() - t0
    finally:
        c.close()
        server.shutdown()
        server.server_close()
    lag = ev.cursor_lag(app_id, cursor=head)
    new_cursor, cols = ev.read_columns_since(app_id, cursor=head)
    pool = cols["pool"]
    got = [(pool[e], pool[t], float(r)) for e, t, r in zip(
        cols["entity_code"].tolist(), cols["target_code"].tolist(),
        cols["rating"].tolist())]
    want = [(x["entityId"], x["targetEntityId"], x["properties"]["rating"])
            for x in sent]
    if lag != len(sent) or got != want:
        raise AssertionError(f"cursor_lag {lag}, read_columns_since "
                             f"returned {len(got)} rows, want {len(sent)}")
    if ev.cursor_lag(app_id, cursor=new_cursor) != 0:
        raise AssertionError("the advanced cursor still lags")
    return {"head": head, "after": new_cursor, "lag": lag,
            "rows": len(got), "post_s": post_s}


def _deploy_checked(engine_dir: str, iid: str, queries) -> dict:
    """``pio deploy`` of ``iid`` in a thread, the ``(user, num)`` queries in
    order over one keep-alive connection, ``pio undeploy``. Every answer
    must equal the plain int8 path on the deployed layout, B1 and B2 must
    launch once per flush and kernel A never. Returns the seconds to
    ready, the answers, each query's seconds, the flushes and the
    launches."""
    apis = []

    class Recorded(create_server.QueryAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apis.append(self)

    port, rcs = _free_port(), []
    with _wrapped((create_server, "QueryAPI", lambda _c: Recorded)):
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--engine-instance-id",
            iid, "--ip", "127.0.0.1", "--port", str(port),
            "--serve-quant", "on"])), daemon=True)
        deploy.start()
        ready_s = _wait_ready(port, deploy.is_alive)
        topk_fused.reset_launches()      # the serving path starts here,
        solve.reset_launches()           # after the deploy's warm-up
        c = _Client(port)
        try:
            answers = [c.call("POST", "/queries.json",
                              {"user": u, "num": n}) for u, n in queries]
        finally:
            c.close()
        (api,) = apis
        stats = api.handle("GET", "/")[1]
        if cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port)]) != 0:
            raise AssertionError("pio undeploy failed")
        deploy.join(timeout=60)
    launches = topk_fused.launches       # the deploy path ends here
    merge_launches = topk_fused.merge_launches
    if rcs != [0] or deploy.is_alive():
        raise AssertionError(f"pio deploy exited {rcs}")
    if solve.launches:
        raise AssertionError("the serving path launched solve_gj")
    flushes = stats["batching"]["batches"]
    if stats["quant"] is None or not stats["quant"].get("fused"):
        raise AssertionError(f"deploy did not take the fused path: {stats}")
    if flushes == 0 or launches != flushes or merge_launches != flushes:
        raise AssertionError(
            f"B1 launched {launches} times and B2 {merge_launches} times "
            f"for {flushes} flushes (want one each per flush)")
    m = api.models[0]
    qs = m.quant
    inv = m.item_vocab.inverse()
    for (u, n), (status, payload, _t) in zip(queries, answers):
        vals, idx = quant.topk_for_users_quant(
            qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale,
            torch.tensor([m.user_vocab(u)], dtype=torch.int32,
                         device=qs.device), k=n, n_items=len(m.item_vocab))
        want = {"itemScores": [{"item": inv(int(i)), "score": float(v)}
                               for v, i in zip(vals[0].cpu().numpy(),
                                               idx[0].cpu().numpy())]}
        if status != 200 or payload != want:
            raise AssertionError(f"{u} answered {status} {payload}, the "
                                 f"plain int8 path {want}")
    return {"ready_s": ready_s, "answers": [a[1] for a in answers],
            "query_s": [a[2] for a in answers], "flushes": flushes,
            "B1_launches": launches, "B2_launches": merge_launches}


# ---------------------------------------------------------------------------
# phase 11: realtime fold-in, the headroom reload and a reload under burst
# ---------------------------------------------------------------------------

FOLD_KEY = "smoke-foldin-key"
FOLD_NEW_USERS, FOLD_RATINGS = 64, 20          # unseen users, ratings each
FOLD_RANK = 10                                 # the trained model's rank
FOLD_TRAINED_USERS, FOLD_TRAINED_RATINGS = 8, 5
FOLD_NEW_ITEMS, FOLD_ITEM_RATERS = 4, 30       # unseen items, their raters
FOLD_HEADROOM, FOLD_HEADROOM_USERS = 8, 16     # the exhausted deploy
FOLD_BURST = 256                               # queries around a /reload
FOLD_DEADLINE_S = 120.0


def _fold_inputs(V: np.ndarray, bucket: int, seed: int, dev):
    """A tick's Gram inputs at one fold-in bucket, as ``foldin_solve``
    gets them: a full bucket of users with FOLD_RATINGS ratings each on
    rows of ``V``, 256 slots a row (foldin.max_events_per_user), int64
    rows, ``other_idx = arange`` and presence weights; and the counts."""
    rng = np.random.default_rng(seed + bucket)
    me = foldin.max_events_per_user()
    nnz_pad = bucket * me
    item_rows = np.zeros((nnz_pad, V.shape[1]), np.float32)
    self_idx = np.full((nnz_pad,), bucket, np.int64)
    rating = np.zeros((nnz_pad,), np.float32)
    n = bucket * FOLD_RATINGS
    item_rows[:n] = V[rng.integers(0, V.shape[0], size=n)]
    self_idx[:n] = np.repeat(np.arange(bucket), FOLD_RATINGS)
    rating[:n] = rng.integers(1, 11, size=n) / 2
    counts = np.full((bucket,), FOLD_RATINGS, np.int32)
    rows, s, r, c = [torch.from_numpy(a).to(dev)
                     for a in (item_rows, self_idx, rating, counts)]
    return (rows, s, torch.arange(nnz_pad, device=dev),
            (s < bucket).to(torch.float32), r, c)


def _fold_systems(V: np.ndarray, bucket: int, seed: int, dev):
    """Kernel A's inputs at one fold-in bucket, as a tick builds them
    (:func:`_fold_inputs`, the Gram over the tick's plan)."""
    rows, s, o, present, rating, counts = _fold_inputs(V, bucket, seed, dev)
    A, b = als.gram_rhs(rows, s, o, present, rating, bucket, s.shape[0],
                        foldin.tick_gram_plan(s, bucket))
    return A.contiguous(), b.contiguous(), als._reg_vec(counts, bucket, 0.01,
                                                        "count")


def _foldin_plain(item_rows, self_idx, rating, counts, lambda_, n_self,
                  chunk, reg_scaling):
    """``foldin.foldin_solve`` with kernel A's plain version on the same
    device: the tick's Gram (kernel G over the tick's plan, first held to
    the plain Gram by :func:`_gram_check`), the floor and the sweep."""
    dev = item_rows.device
    present = (self_idx < n_self).to(torch.float32)
    other_idx = torch.arange(item_rows.shape[0], device=dev)
    plan = foldin.tick_gram_plan(self_idx, n_self)
    _gram_check(f"a tick of {n_self} rows", item_rows, self_idx, other_idx,
                present, rating, n_self, plan)
    A, b = als.gram_rhs(item_rows, self_idx, other_idx, present, rating,
                        n_self, chunk, plan)
    reg = als._reg_vec(counts, n_self, lambda_, reg_scaling)
    return solve.solve_gj_plain(A.contiguous(), b.contiguous(), reg)


class _Stream:
    """A steady query stream: one keep-alive client posting trained
    users' queries back to back until closed; every answer that is not
    a 200 (or a connection error) is a dropped query. ``answers`` keeps
    each (user, status, payload, seconds); :meth:`pause` holds the
    stream with no query in flight."""

    def __init__(self, port: int, users, seed: int):
        self.answers, self.errors = [], []
        self._stop = threading.Event()
        self._go = threading.Event()
        self._go.set()
        self._parked = threading.Event()
        rng = np.random.default_rng(seed)
        self._users = [users[u] for u in rng.integers(0, len(users),
                                                      size=1024)]
        self._port = port
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        c = _Client(self._port)
        try:
            i = 0
            while not self._stop.is_set():
                if not self._go.is_set():
                    self._parked.set()
                    self._go.wait()
                    self._parked.clear()
                    continue
                user = self._users[i % len(self._users)]
                status, body, t = c.call(
                    "POST", "/queries.json", {"user": user, "num": 10})
                self.answers.append((user, status, body, t))
                i += 1
        except Exception as e:     # a lost connection is a drop too
            self.errors.append(f"{type(e).__name__}: {e}")
        finally:
            c.close()

    def wait_for(self, n: int, deadline_s: float = 60.0) -> None:
        """Until ``n`` queries were answered (a stream that stopped on an
        error fails here)."""
        t0 = time.perf_counter()
        while len(self.answers) < n:
            if time.perf_counter() - t0 > deadline_s or self.errors:
                raise AssertionError(f"query stream: {len(self.answers)} "
                                     f"answers, errors {self.errors[:3]}")
            time.sleep(0.01)

    def pause(self) -> None:
        self._go.clear()
        if not self._parked.wait(timeout=60):
            raise AssertionError("the query stream did not pause")

    def resume(self) -> None:
        self._go.set()

    def close(self) -> dict:
        self._stop.set()
        self._go.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise AssertionError("the query stream did not stop")
        dropped = (sum(a[1] != 200 for a in self.answers)
                   + len(self.errors))
        return {"queries": len(self.answers), "dropped": dropped,
                "errors": self.errors[:3]}


def _post_events(port: int, events) -> None:
    c = _Client(port)
    try:
        for at in range(0, len(events), 50):
            batch = events[at:at + 50]
            status, results, _t = c.call(
                "POST", f"/batch/events.json?accessKey={FOLD_KEY}", batch)
            if status != 200 or [r["status"] for r in results] \
                    != [201] * len(batch):
                raise AssertionError(f"event batch at {at}: {status}")
    finally:
        c.close()


def _fold_deploy(store, iid: str, work: str, name: str, aot: str):
    """QueryAPI + serve() with fold-in on, its cursors in a fresh
    directory; returns (api, port, server thread)."""
    os.environ["PIO_FOLDIN_CURSOR_DIR"] = os.path.join(work, "cur_" + name)
    api = create_server.QueryAPI(create_server.ServerConfig(
        serve_quant="on", engine_instance_id=iid, aot=aot, foldin="on"),
        storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    _wait_ready(port, server.is_alive, deadline_s=300)
    if api._foldin_worker is None:
        raise AssertionError("the fold-in worker did not start (see the "
                             "journal's foldin WARN)")
    return api, port, server


def _undeploy(port: int, server) -> None:
    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/stop", data=b"", method="POST"),
        timeout=30).close()
    server.join(timeout=60)
    if server.is_alive():
        raise AssertionError("the fold-in deploy did not stop")


def _wait_worker(api, done, what: str) -> float:
    """Poll the worker's state until ``done(state)``; the seconds."""
    t0 = time.perf_counter()
    while not done(api._foldin_worker.state()):
        if time.perf_counter() - t0 > FOLD_DEADLINE_S:
            raise AssertionError(f"fold-in: {what} not reached in "
                                 f"{FOLD_DEADLINE_S} s: "
                                 f"{api._foldin_worker.state()}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _served(model, user: str, k: int):
    """The answer the server gives ``user`` at ``num`` k, from the plain
    int8 path on the live layout: the padded catalog ranked, hits past
    the item vocab dropped (predict_batch's semantics)."""
    qs = model.quant
    k = min(k, len(model.item_vocab))
    vals, idx = quant.topk_for_users_quant(
        qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale,
        torch.tensor([model.user_vocab(user)], dtype=torch.int32,
                     device=qs.device), k=k, n_items=qs.n_items)
    inv = model.item_vocab.inverse()
    n_real = len(model.item_vocab)
    return {"itemScores": [{"item": inv(int(i)), "score": float(v)}
                           for v, i in zip(vals[0].cpu().numpy(),
                                           idx[0].cpu().numpy())
                           if int(i) < n_real]}


def phase_foldin(work: str, store, iid: str, model, seed: int, dev) -> dict:
    """Fold-in on the eventlog app's ML-20M model: kernel A at the fold-in
    buckets against its plain version; time to ready without and with
    the warm-up; then, under a steady query stream, 64 unseen users, 8
    trained users and 4 unseen items through the event server into the
    live deploy; then the headroom-exhausted reload and a reload under a
    burst of queries."""
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service
    from predictionio_tpu_torch.tools import apps as app_cmds

    out = {"card": _smi()}
    t_phase = time.perf_counter()
    app_cmds.accesskey_new(STORE_APP, key=FOLD_KEY, storage=store)

    # 1. kernel A at the fold-in buckets, bit for bit, then timed
    V = model.item_factors
    rows = []
    for bucket in foldin.user_buckets():
        A, b, reg = _fold_systems(V, bucket, seed, dev)
        x = solve.solve_factors(A, b, reg)
        p = solve.solve_gj_plain(A, b, reg)
        torch.cuda.synchronize()
        if not bool(_bitwise_same(x, p).all()):
            raise AssertionError(f"kernel A != plain at fold-in bucket "
                                 f"{bucket}")
        rows.append({**_solve_row(f"foldin n={bucket}", A, b, reg),
                     "max_abs_err": float((x - p).abs().max())})
    out["kernel_a"] = rows

    # 2. time to ready, without the warm-up and with it, each from an
    # unloaded kernel library (loads and builds are counted from here)
    compiles = []
    note = (lambda kind: lambda orig: lambda name, s: (
        compiles.append((kind, name, time.perf_counter())), orig(name, s)))
    users = list(model.user_vocab.to_dict())
    with _wrapped((devicewatch, "note_build", note("build")),
                  (devicewatch, "note_load", note("load"))):
        ready = {}
        for aot in ("off", "on"):
            _kernels._libs.clear()
            topk_fused._lib = None
            topk_fused.reset_launches()
            solve.reset_launches()
            t0 = time.perf_counter()
            api, port, server = _fold_deploy(store, iid, work, aot, aot)
            ready[aot] = {"time_to_ready_s": api.time_to_ready_s,
                          "wall_to_ready_s": time.perf_counter() - t0,
                          "warmup_B1_launches": topk_fused.launches,
                          "warmup_B2_launches": topk_fused.merge_launches,
                          "warmup_A_launches": solve.launches}
            topk_fused.reset_launches()
            solve.reset_launches()
            if aot == "off":
                _undeploy(port, server)
        out["ready"] = ready
        t_ready = time.perf_counter()
        if api._aot_state is None:
            raise AssertionError("the deploy did not warm up")
        out["aot"] = api._aot_state
        main = _fold_traffic(api, port, store, users, model, seed)
        late = [c for c in compiles if c[2] > t_ready]
        if late:
            raise AssertionError(f"kernel library builds or loads after "
                                 f"ready: {late}")
        out.update(main)
        _undeploy(port, server)

    # 3. the headroom runs out: the /reload fallback, then a burst reload
    os.environ["PIO_FOLDIN_HEADROOM"] = str(FOLD_HEADROOM)
    try:
        api, port, server = _fold_deploy(store, iid, work, "headroom",
                                         "auto")
        out["headroom"] = _fold_headroom(api, port, store, users, seed)
        _undeploy(port, server)
    finally:
        os.environ.pop("PIO_FOLDIN_HEADROOM", None)
    os.environ.pop("PIO_FOLDIN_CURSOR_DIR", None)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _fold_traffic(api, port, store, users, model, seed) -> dict:
    """The main fold-in run on a live, warmed deploy."""
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service

    rng = np.random.default_rng(seed + 23)
    items = list(model.item_vocab.to_dict())
    new_users = [f"fold_u{j}" for j in range(FOLD_NEW_USERS)]
    trained = [users[u] for u in rng.choice(len(users),
                                            size=FOLD_TRAINED_USERS,
                                            replace=False)]
    new_items = [f"fold_i{j}" for j in range(FOLD_NEW_ITEMS)]
    # the unseen items' raters are the unseen users, once folded: an
    # item solve reads only raters the model knows (and a trained user's
    # whole history is the expensive read, timed below)
    raters = {it: [new_users[u] for u in rng.choice(
        FOLD_NEW_USERS, size=FOLD_ITEM_RATERS, replace=False)]
        for it in new_items}
    wave1 = []
    for u in new_users:
        for i in rng.choice(len(items), size=FOLD_RATINGS, replace=False):
            wave1.append(_rate(u, items[i], float(rng.integers(1, 11)) / 2))
    for u in trained:
        for i in rng.choice(len(items), size=FOLD_TRAINED_RATINGS,
                            replace=False):
            wave1.append(_rate(u, items[i], float(rng.integers(1, 11)) / 2))
    wave1 = [wave1[i] for i in rng.permutation(len(wave1))]
    wave2 = [_rate(u, it, 5.0) for it, who in raters.items() for u in who]
    events = wave1 + wave2

    # every tick: its time, kernel A's launches and their shapes
    ticks, shapes, solves, published, published_items = [], [], [], [], []

    def wrap_solve(orig):
        def f(item_rows, self_idx, rating, counts, lambda_, *, n_self,
              chunk, reg_scaling="count"):
            x = orig(item_rows, self_idx, rating, counts, lambda_,
                     n_self=n_self, chunk=chunk, reg_scaling=reg_scaling)
            shapes.append((n_self, chunk))
            solves.append((item_rows, self_idx, rating, counts, lambda_,
                           n_self, chunk, reg_scaling, x))
            return x
        return f

    def wrap_tick(orig):
        def tick(self):
            a0, s0 = solve.launches, len(shapes)
            t0 = time.perf_counter()
            res = orig(self)
            if res.get("events") or s0 != len(shapes):
                ticks.append({"ms": (time.perf_counter() - t0) * 1e3,
                              "events": res.get("events"),
                              "A_launches": solve.launches - a0,
                              "buckets": [n for n, _c in shapes[s0:]]})
            return res
        return tick

    def wrap_publish(into):
        def wrap(orig):
            def publish(self, model_, ixs, rows_):
                into.append((ixs.copy(), np.array(rows_, np.float32)))
                return orig(self, model_, ixs, rows_)
            return publish
        return wrap

    es, es_port = http_mod.serve_background(
        service.EventAPI(storage=store), "127.0.0.1", 0)
    with _wrapped((foldin, "foldin_solve", wrap_solve),
                  (foldin.FoldinWorker, "tick", wrap_tick),
                  (foldin.FoldinWorker, "_publish", wrap_publish(published)),
                  (foldin.FoldinWorker, "_publish_items",
                   wrap_publish(published_items))):
        stream = _Stream(port, users, seed + 24)
        try:
            t0 = time.perf_counter()
            _post_events(es_port, wave1)
            post_s = time.perf_counter() - t0
            converge_s = [_wait_worker(
                api, lambda st: (
                    st["usersFolded"] >= FOLD_NEW_USERS
                    + FOLD_TRAINED_USERS and st["cursorLag"] == 0
                    and not st["usersPending"]), "the users' folds")]
            _post_events(es_port, wave2)
            converge_s.append(_wait_worker(
                api, lambda st: (
                    st["itemsFolded"] >= FOLD_NEW_ITEMS
                    and st["cursorLag"] == 0 and not st["usersPending"]
                    and not st["itemsPending"]), "the items' folds"))
            # one more quiet tick: nothing left in flight
            time.sleep(2 * api._foldin_worker.config.tick_ms / 1e3)
        finally:
            stream_out = stream.close()
            es.shutdown()
            es.server_close()
        worker = api._foldin_worker
        m = api.models[0]
        state = worker.state()
        c = _Client(port)
        try:
            answers = {u: c.call("POST", "/queries.json",
                                 {"user": u, "num": 10})
                       for u in new_users + trained}
            item_answers = {
                it: c.call("POST", "/queries.json",
                           {"user": raters[it][0],
                            "num": len(m.item_vocab)})
                for it in new_items}
            stats = c.call("GET", "/")[1]
        finally:
            c.close()
    flushes = stats["batching"]["batches"]
    b1, b2 = topk_fused.launches, topk_fused.merge_launches
    if stream_out["dropped"]:
        raise AssertionError(f"fold-in dropped queries: {stream_out}")
    if flushes == 0 or b1 != flushes or b2 != flushes:
        raise AssertionError(f"B1 {b1} / B2 {b2} launches for {flushes} "
                             "flushes")
    # every kernel A call of the ticks == its plain version, bit for bit
    for args in solves:
        x = args[-1]
        p = _foldin_plain(*args[:-1])
        if not bool(_bitwise_same(x, p).all()):
            raise AssertionError(f"a tick's kernel A != plain at "
                                 f"n={args[5]}")
    outputs = {row.tobytes() for *_a, x in solves
               for row in x.cpu().numpy()}
    if any(r.tobytes() not in outputs
           for _ix, rs in published + published_items for r in rs):
        raise AssertionError("a published row is no solve's output")

    def last_rows(pubs):
        last = {}
        for ixs, rs in pubs:
            for ix, r in zip(ixs.tolist(), rs):
                last[ix] = r
        return last

    # the published rows: the mirrors and the int8 layout hold them, the
    # users as rows of u_q, the items as COLUMNS of the transposed vt_q
    last = last_rows(published)
    last_items = last_rows(published_items)
    want_items = {m.item_vocab(it) for it in new_items}
    if not want_items <= set(last_items):
        raise AssertionError(f"unseen item rows {sorted(want_items)} not "
                             f"all published: {sorted(last_items)}")
    for side, rows_, mirror, q_of, s_of in (
            ("user", last, worker._user_factors,
             lambda ix: m.quant.u_q[ix], lambda ix: m.quant.u_scale[ix]),
            ("item", last_items, worker._item_factors,
             lambda ix: m.quant.vt_q[:, ix], lambda ix: m.quant.v_scale[ix])):
        for ix, r in rows_.items():
            if mirror[ix].tobytes() != r.tobytes():
                raise AssertionError(f"{side} row {ix}: the mirror is not "
                                     "the last published row")
            q, sc = quant.quantize_rows(r[None])
            if (q_of(ix).cpu().numpy().tobytes() != q[0].tobytes()
                    or s_of(ix).item() != float(sc[0])):
                raise AssertionError(f"{side} row {ix}: int8 != "
                                     "quantize_rows")
    for u, (status, payload, _t) in answers.items():
        want = _served(m, u, 10)
        if status != 200 or payload != want:
            raise AssertionError(f"{u} answered {status} {payload}, the "
                                 f"plain int8 path {want}")
        if u in new_users and not payload["itemScores"]:
            raise AssertionError(f"unseen user {u} got a cold answer")
    distinct = len({json.dumps(answers[u][1]) for u in new_users})
    item_rank = {}
    for it, (status, payload, _t) in item_answers.items():
        names = [s["item"] for s in payload["itemScores"]]
        if status != 200 or it not in names:
            raise AssertionError(f"unseen item {it} is not served")
        item_rank[it] = names.index(it) + 1
    # where a tick's time goes: one row's history read from the store
    gather_ms = {}
    for kind, who in (("trained", trained[:3]), ("unseen", new_users[:3])):
        ms = []
        for u in who:
            t0 = time.perf_counter()
            worker._gather_ratings(u, m.item_vocab)
            ms.append((time.perf_counter() - t0) * 1e3)
        gather_ms[kind] = ms
    # the first read after a deploy: a fresh DAO loads every chunk's
    # index sidecar before its first answer, then reads warm
    fresh = storage_mod.Storage().get_events()
    events_dao, worker._events = worker._events, fresh
    try:
        first_read_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            worker._gather_ratings(trained[0], m.item_vocab)
            first_read_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        worker._events = events_dao
    # and where a trained user's read spends it (host Python, cProfile)
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.runcall(worker._gather_ratings, trained[-1], m.item_vocab)
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][3])[:8]
    gather_profile = [(f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}:{fn[2]}",
                       round(st[3] * 1e3, 1), st[1]) for fn, st in top]
    fresh = state.get("freshness") or {}
    tick_ms = [t["ms"] for t in ticks]
    return {
        "events": len(events), "post_s": post_s, "converge_s": converge_s,
        "stream": stream_out, "flushes": flushes, "B1_launches": b1,
        "B2_launches": b2, "A_launches": sum(t["A_launches"]
                                             for t in ticks),
        "A_solves_checked": len(solves), "ticks": ticks,
        "published_rows": {"users": len(last), "items": len(last_items)},
        "tick_ms": {"p50": float(np.percentile(tick_ms, 50)),
                    "max": float(max(tick_ms))} if tick_ms else None,
        "freshness_s": {"p50": fresh.get("p50S"), "p99": fresh.get("p99S"),
                        "observed": fresh.get("observed")},
        "gather_ms": gather_ms, "gather_profile": gather_profile,
        "first_read_after_deploy_ms": first_read_ms,
        "distinct_new_user_answers": distinct,
        "new_item_rank_for_a_rater": item_rank,
        "state": {k: state[k] for k in ("usersFolded", "itemsFolded",
                                        "capacity", "itemCapacity",
                                        "eventsSeen", "unknownItems",
                                        "unknownUsers")}}


def _fold_headroom(api, port, store, users, seed) -> dict:
    """FOLD_HEADROOM rows of headroom, FOLD_HEADROOM_USERS unseen users:
    the worker falls back to the reload (generation + 1) and folds every
    pending user into the re-grown headroom, with a query stream running;
    then POST /reload under a burst of concurrent queries."""
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service

    rng = np.random.default_rng(seed + 25)
    items = list(api.models[0].item_vocab.to_dict())
    horde = [f"horde_u{j}" for j in range(FOLD_HEADROOM_USERS)]
    events = [_rate(u, items[i], float(rng.integers(1, 11)) / 2)
              for u in horde
              for i in rng.choice(len(items), size=10, replace=False)]
    gen0 = api.generation
    cap0 = api._foldin_worker.state()["capacity"]["rows"]
    es, es_port = http_mod.serve_background(
        service.EventAPI(storage=store), "127.0.0.1", 0)
    stream = _Stream(port, users, seed + 26)
    try:
        _post_events(es_port, events)
        reload_s = _wait_worker(
            api, lambda st: st["generation"] == gen0 + 1
            and st["usersFolded"] >= FOLD_HEADROOM_USERS
            and not st["usersPending"], "the headroom reload")
    finally:
        stream_out = stream.close()
        es.shutdown()
        es.server_close()
    if stream_out["dropped"]:
        raise AssertionError(f"the headroom reload dropped queries: "
                             f"{stream_out}")
    c = _Client(port)
    try:
        for u in horde:
            status, payload, _t = c.call("POST", "/queries.json",
                                         {"user": u, "num": 10})
            if status != 200 or not payload["itemScores"]:
                raise AssertionError(f"{u} after the reload: {status} "
                                     f"{payload}")
    finally:
        c.close()
    cap1 = api._foldin_worker.state()["capacity"]["rows"]

    # POST /reload while FOLD_BURST queries run on 16 clients
    gen1 = api.generation
    burst = [users[u] for u in rng.integers(0, len(users), size=FOLD_BURST)]
    with ThreadPoolExecutor(max_workers=16) as pool:
        futures = [pool.submit(_post, port, u, 10) for u in burst]
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/reload", data=b"",
                method="POST"), timeout=30) as r:
            reload_status = r.status
        statuses = []
        for f in futures:
            try:
                statuses.append(f.result()[0])
            except OSError as e:       # urllib raises on a 503
                statuses.append(getattr(e, "code", repr(e)))
    api._reload_thread.join(timeout=120)
    if reload_status != 200 or api.generation != gen1 + 1:
        raise AssertionError(f"POST /reload: {reload_status}, generation "
                             f"{gen1} -> {api.generation}")
    if statuses != [200] * FOLD_BURST:
        raise AssertionError(f"the burst around /reload dropped "
                             f"{sum(s != 200 for s in statuses)} queries")
    return {"headroom": FOLD_HEADROOM, "users": FOLD_HEADROOM_USERS,
            "capacity_rows": [cap0, cap1], "generation": [gen0, gen1],
            "reload_s": reload_s, "stream": stream_out,
            "burst": {"queries": FOLD_BURST, "dropped": 0,
                      "generation": [gen1, api.generation]}}


def phase_store(work: str, seed: int, dev: torch.device, synth: dict,
                qs_out: dict):
    """The eventlog store on the card's path: the 20M fill and reads, the
    streamed / in-core / warm trains through kernel A, ``pio import`` and
    its train, the cursor check through the event server, and ``pio
    deploy`` through B1 + B2. ``synth`` and ``qs_out`` are phase 5's and
    the quickstart's numbers, printed beside this phase's. Returns the
    phase's numbers and the warm train's instance id and model, which
    phase 11 and the fold-in step (:func:`phase_store_foldin`) use."""
    env = _eventlog_env(work)
    saved = {k: os.environ.get(k) for k in
             (*env, "PIO_TRAIN_STREAM", "PIO_SYNTHETIC_EVENTS",
              "PIO_SYNTHETIC_SEED")}
    for name in ("PIO_SYNTHETIC_EVENTS", "PIO_SYNTHETIC_SEED"):
        os.environ.pop(name, None)
    os.environ.update(env)
    storage_mod.reset_storage()
    t_phase = time.perf_counter()
    try:
        out, ctx = _phase_store(work, seed, dev, synth, qs_out)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
    out["phase_s"] = time.perf_counter() - t_phase
    out["chunk_map"] = _chunk_map_state("store")
    print("store: " + json.dumps(out), flush=True)
    return out, ctx


def _chunk_map_state(where: str) -> dict:
    """numpy's version and the eventlog chunks this process loaded whole
    instead of mapping (by reason); any such chunk fails the run."""
    from predictionio_tpu_torch.data.storage import eventlog
    state = {"numpy": np.__version__,
             "fallbacks": eventlog.chunk_map_fallbacks(),
             "by_reason": dict(eventlog.CHUNK_MAP_FALLBACKS)}
    print(f"{where}: numpy {state['numpy']}, eventlog chunks loaded whole "
          f"instead of mapped: {state['fallbacks']} {state['by_reason']}",
          flush=True)
    if state["fallbacks"]:
        raise AssertionError(f"{where}: the eventlog chunk map fell back: "
                             f"{state['by_reason']}")
    return state


def _phase_store(work, seed, dev, synth, qs_out) -> dict:
    for argv in (["app", "new", STORE_APP],
                 ["app", "new", STORE_IMPORT_APP, "--access-key",
                  STORE_KEY]):
        if cli.main(argv) != 0:
            raise AssertionError(f"pio {' '.join(argv)} failed")
    store = storage_mod.get_storage()
    apps = store.get_meta_data_apps()
    app_id = apps.get_by_name(STORE_APP).id
    ev = store.get_events()

    # 1. fill and read
    src = synthetic.chunk_source(N_RATINGS, seed=seed, n_users=N_USERS,
                                 n_items=N_ITEMS)
    t0 = time.perf_counter()
    n = synthetic.write_events(src, store, app_id)
    fill_s = time.perf_counter() - t0
    read_s, reads = {}, {}
    for name, threads in (("serial", 1), ("pool", None)):
        t0 = time.perf_counter()
        reads[name] = ev.read_columns(app_id, read_threads=threads,
                                      **STORE_KW)
        read_s[name] = time.perf_counter() - t0
    serial, pool = reads.pop("serial"), reads.pop("pool")
    if serial["pool"] != pool["pool"] or any(
            serial[k].tobytes() != pool[k].tobytes() for k in (
                "entity_code", "target_code", "event_code", "rating",
                "time_ms")) or serial["entity_code"].shape[0] != n:
        raise AssertionError("read_columns: one thread and the pool differ")
    del serial, pool
    t0 = time.perf_counter()
    in_core = store_mod.find_columnar(STORE_APP, storage=store, **STORE_KW)
    in_core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    streamed = store_mod.find_columnar(STORE_APP, storage=store, stream=True,
                                       device=dev, **STORE_KW)
    torch.cuda.synchronize()
    streamed_s = time.perf_counter() - t0
    mirror = streamed.staged
    if (streamed.entity_idx is not None or mirror is None
            or streamed.stream_digest != in_core.stream_digest
            or streamed.entity_ids.to_dict() != in_core.entity_ids.to_dict()
            or streamed.target_ids.to_dict() != in_core.target_ids.to_dict()
            or any(getattr(mirror, f).cpu().numpy().tobytes()
                   != getattr(in_core, f).tobytes() for f in STORE_COLS)):
        raise AssertionError("the streamed read differs from the in-core "
                             "read")
    mirror.release()
    del streamed, mirror, in_core
    torch.cuda.empty_cache()
    print(f"store: fill of {n} events ({N_USERS} users x {N_ITEMS} items) "
          f"through append_encoded in {fill_s:.3f} s ({n / fill_s:.0f} "
          f"events/s); read_columns one thread "
          f"{read_s['serial']:.3f} s, pool {read_s['pool']:.3f} s, "
          "byte-identical; find_columnar in-core "
          f"{in_core_s:.3f} s, streamed to the card {streamed_s:.3f} s, "
          "the same columns and digest", flush=True)

    # 2. train: streamed, in-core, then warm, from one seed
    with open(ENGINE_JSON) as f:
        iters = json.load(f)["algorithms"][0]["params"]["numIterations"]
    engine_dir = _engine_dir(work, "eventlog_engine", STORE_APP)
    als_algorithm._BIG_LAYOUT_CACHE.clear()     # phase 5's layout
    on, on_model = _store_train(engine_dir, store, iters, "on")
    als_algorithm._BIG_LAYOUT_CACHE.clear()     # the off train builds too
    off, off_model = _store_train(engine_dir, store, iters, "off")
    warm, model = _store_train(engine_dir, store, iters, None)
    if not (on["staged_chunks"] > 0 and on["layout_builds"] == 1
            and off["layout_builds"] == 1):
        raise AssertionError(f"the on / off trains: {on} {off}")
    if (warm["layout_hits"], warm["layout_builds"],
            warm["staged_chunks"]) != (1, 0, 0):
        raise AssertionError(f"the warm train: {warm}")
    if not (_same_factors(on_model, off_model)
            and _same_factors(on_model, model)):
        raise AssertionError("streamed, in-core and warm trains differ")
    trains = [on, off, warm]
    for t in trains:
        idle = ("not measured (no device events recorded)"
                if t["idle_share"] is None else f"{t['idle_share']:.4f}")
        print(f"store: pio train PIO_TRAIN_STREAM={t['mode']}: wall "
              f"{t['wall_s']:.3f} s (under torch.profiler); phases "
              + ", ".join(f"{k} {v:.3f} s" for k, v in t["phases_s"].items())
              + f"; solve_gj {t['solve_gj_launches']} launches; "
              f"{t['staged_chunks']} chunks staged; layout cache "
              f"{t['layout_hits']} hit / {t['layout_builds']} build; device "
              f"idle share over the train {idle}", flush=True)
    print("store: beside phase 5's synthetic train phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in synth["phases_s"].items())
          + f" (idle share of one iteration {synth['idle_share']}) and the "
          "quickstart's SQLite train phases " + ", ".join(
              f"{k} {v:.3f} s"
              for k, v in qs_out["train"]["phases_s"].items()), flush=True)
    iid = warm["instance"]

    # 3. pio import into the eventlog, and a train from it
    import_id = store.get_meta_data_apps().get_by_name(STORE_IMPORT_APP).id
    path = os.path.join(work, "eventlog_import.json")
    n_file = _write_import_file(path, seed)
    t0 = time.perf_counter()
    rc = cli.main(["import", "--appid", str(import_id), "--input", path])
    import_s = time.perf_counter() - t0
    os.remove(path)
    if rc != 0:
        raise AssertionError(f"pio import exited {rc}")
    n_stored = ev.read_columns(import_id)["entity_code"].shape[0]
    if n_stored != n_file:
        raise AssertionError(f"imported {n_stored} of {n_file} events")
    import_dir = _engine_dir(work, "eventlog_import_engine",
                             STORE_IMPORT_APP)
    imported, _model = _store_train(import_dir, store, iters, None)
    qs_eps = qs_out["import_events_per_s"]
    print(f"store: pio import of {n_file} events into the eventlog in "
          f"{import_s:.3f} s ({n_file / import_s:.0f} events/s; the "
          f"quickstart's SQLite import {qs_eps:.0f} events/s); its train: "
          f"read_io {imported['phases_s'].get('read_io', 0):.3f} s (SQLite "
          f"{qs_out['train']['phases_s'].get('read_io', 0):.3f} s), "
          f"solve_gj {imported['solve_gj_launches']} launches", flush=True)

    # 4. cursors through the event server
    cursors = _cursor_check(store, import_id)
    print(f"store: head_cursor {cursors['head']}, {cursors['rows']} events "
          f"through the event server in {cursors['post_s']:.3f} s; "
          f"cursor_lag {cursors['lag']}; read_columns_since returned "
          f"exactly those rows; cursor now {cursors['after']}", flush=True)

    # 5. deploy the eventlog-trained model
    rng = np.random.default_rng(seed + 11)
    users = list(model.user_vocab.to_dict())
    dep = _deploy_checked(engine_dir, iid, [
        (users[u], 10) for u in rng.integers(0, len(users),
                                             size=STORE_QUERIES)])
    p50, p99 = _pct(dep["query_s"])
    deploy = {"ready_s": dep["ready_s"], "queries": STORE_QUERIES,
              "query_ms": {"p50": p50, "p99": p99},
              "flushes": dep["flushes"], "B1_launches": dep["B1_launches"],
              "B2_launches": dep["B2_launches"]}
    print(f"store: pio deploy ready in {deploy['ready_s']:.3f} s; "
          f"{deploy['queries']} queries equal to the plain int8 path, p50 "
          f"{deploy['query_ms']['p50']:.3f} ms p99 "
          f"{deploy['query_ms']['p99']:.3f} ms; B1 {deploy['B1_launches']} "
          f"and B2 {deploy['B2_launches']} launches for "
          f"{deploy['flushes']} flushes", flush=True)

    # the buffered tails into chunks: phase 11's storage server reads this
    # store from another process, and the fold-in step reopens it after
    ev.close()
    return {"events": n, "users": N_USERS, "items": N_ITEMS,
            "fill_s": fill_s, "fill_events_per_s": n / fill_s,
            "read_columns_s": read_s, "find_columnar_in_core_s": in_core_s,
            "find_columnar_streamed_s": streamed_s, "trains": trains,
            "import": {"events": n_file, "import_s": import_s,
                       "events_per_s": n_file / import_s,
                       "sqlite_events_per_s": qs_eps, "train": imported},
            "cursors": cursors, "deploy": deploy}, \
        {"iid": iid, "model": model}


def phase_store_foldin(work: str, seed: int, dev: torch.device,
                       ctx: dict) -> dict:
    """The store phase's last step, realtime fold-in on the warm train's
    model, the headroom reload and a reload under burst. It runs after
    phase 11, whose remote trains must read the 20M app as the warm train
    read it (fold-in posts events into that app)."""
    env = _eventlog_env(work)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    storage_mod.reset_storage()
    try:
        store = storage_mod.get_storage()
        fold = phase_foldin(work, store, ctx["iid"], ctx["model"], seed, dev)
        _print_foldin(fold)
        fold["chunk_map"] = _chunk_map_state("foldin")
        store.get_events().close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
    return fold


# ---------------------------------------------------------------------------
# phase 11: remote storage, the circuit breaker and the operator tools
# ---------------------------------------------------------------------------

REMOTE_KEY = "smoke-storage-key"
REMOTE_IMPORT_APP = "SmokeRemoteImport"
#: the first lines of the quickstart's import file (a cut: PERF.md §4)
REMOTE_IMPORT_EVENTS = 100_000
REMOTE_FAULT_SEED = "11"
#: the deduplicated import's retry pause: the dropped write must reach the
#: storage server, and take its dedup token, before the retry leaves the
#: client (else the retry runs fresh and the original replays into a
#: reply nobody reads). The full-jitter backoff draws from [0, base), so
#: the base alone is no floor: the pause is floored at the base too.
REMOTE_RETRY_FLOOR_MS = 500
#: the remote deploy's retries and breaker: one retry, a 2 s error window
#: (the load's successful reads age out of it before the kill), open after
#: 2 failed calls, a half-open probe after 5 s
REMOTE_DEPLOY_ENV = {"PIO_RPC_RETRIES": "1", "PIO_RPC_BACKOFF_MS": "20",
                     "PIO_BREAKER_ENABLED": "1",
                     "PIO_BREAKER_WINDOW_S": "2",
                     "PIO_BREAKER_MIN_CALLS": "2",
                     "PIO_BREAKER_OPEN_S": "5"}
#: the variables phase 11 sets in this process, restored after it
REMOTE_NAMES = ("PIO_TELEMETRY", "PIO_TRACE", "PIO_HISTORY_TICK_S",
                "PIO_FAULT_SPEC", "PIO_FAULT_SEED", "PIO_RPC_WRITE_DEDUP",
                "PIO_TRAIN_STREAM", *REMOTE_DEPLOY_ENV)
REMOTE_TRACE = "5e1fca11ab1e0011"        # the traced /reload's trace id
REMOTE_QUERIES_MIN = 200                 # stream queries before the kill
_REPO = os.path.dirname(os.path.abspath(__file__))
#: ``pio storageserver`` through the CLI's entry; after the drain returns,
#: the process waits for its stdin to close, so the drain's /readyz 503
#: can be read on a connection the smoke holds open
_STORAGE_SERVER = (
    "import sys\n"
    "from predictionio_tpu_torch.tools import cli\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(f'storageserver exited {rc}', flush=True)\n"
    "sys.stdin.read()\n"
    "sys.exit(rc)\n")


@contextlib.contextmanager
def _retry_floor(floor_s: float, pauses: list):
    """Every retry pause of the remote client at least ``floor_s``, each
    taken one appended to ``pauses`` (the Retry-After floor's path)."""
    backoff_s = resilience.RetryPolicy.backoff_s

    def floored(self, attempt, floor=0.0, rng=None):
        pause = backoff_s(self, attempt, max(floor, floor_s), rng)
        pauses.append(pause)
        return pause

    resilience.RetryPolicy.backoff_s = floored
    try:
        yield
    finally:
        resilience.RetryPolicy.backoff_s = backoff_s


def _remote_env(port: int) -> dict:
    """Every repository on one ``remote`` source: the storage server."""
    return {"PIO_STORAGE_SOURCES_RPC_TYPE": "remote",
            "PIO_STORAGE_SOURCES_RPC_URL": f"http://127.0.0.1:{port}",
            "PIO_STORAGE_SOURCES_RPC_KEY": REMOTE_KEY,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "RPC",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "RPC",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "RPC"}


class _StorageServer:
    """``pio storageserver`` over the store phase's eventlog store, in a
    process of its own (its own journal, trace ring and metrics, as on a
    storage host), with telemetry, traces and the journal on."""

    def __init__(self, work: str, port: int, name: str):
        self.port = port
        self.log_path = os.path.join(work, name + ".log")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PIO_")}
        env.update(_eventlog_env(work))
        env.update({"PIO_JOURNAL": "1", "PIO_HISTORY_TICK_S": "1",
                    "PYTHONPATH": os.pathsep.join(
                        p for p in (_REPO, env.get("PYTHONPATH")) if p)})
        self._log = open(self.log_path, "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _STORAGE_SERVER, "storageserver",
             "--ip", "127.0.0.1", "--port", str(port), "--key", REMOTE_KEY,
             "--telemetry", "--trace"],
            stdin=subprocess.PIPE, stdout=self._log,
            stderr=subprocess.STDOUT, env=env, cwd=_REPO)
        _wait_ready(port, lambda: self.proc.poll() is None, deadline_s=120)
        self.ready_s = time.perf_counter() - t0

    def output(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def drain(self) -> dict:
        """SIGTERM: /readyz must answer 503 on an open connection, the
        drain must flush the event buffers and the CLI must return 0."""
        c = _Client(self.port)
        try:
            status, body, _t = c.call("GET", "/readyz")
            if status != 200:
                raise AssertionError(f"storage /readyz before the drain: "
                                     f"{status} {body}")
            t0 = time.perf_counter()
            self.proc.send_signal(signal.SIGTERM)
            while True:
                status, body, _t = c.call("GET", "/readyz")
                if (status, body) == (503, {"status": "draining"}):
                    break
                if time.perf_counter() - t0 > 30:
                    raise AssertionError("storage /readyz never answered "
                                         "503 after SIGTERM")
                time.sleep(0.005)
            seen_s = time.perf_counter() - t0
            while "storageserver exited" not in self.output():
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("the storage server did not "
                                         "return from its drain")
                time.sleep(0.02)
            drained_s = time.perf_counter() - t0
        finally:
            c.close()
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=60)
        self._log.close()
        text = self.output()
        if rc != 0 or "storageserver exited 0" not in text or \
                "Storage server drained (event buffers flushed)." not in text:
            raise AssertionError(f"storage server drain: rc {rc}\n{text}")
        return {"readyz_503_after_s": seen_s, "drained_s": drained_s}

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        if not self._log.closed:
            self._log.close()


def _cli_out(argv) -> tuple:
    """``pio <argv>`` in process: (exit code, standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _reload(port: int, api, trace: str = "") -> float:
    """POST /reload (with ``trace`` as its X-PIO-Trace id), then wait for
    its load to end; the seconds."""
    headers = {"X-PIO-Trace": f"{trace}-{'0' * 15}1"} if trace else {}
    t0 = time.perf_counter()
    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/reload", data=b"", method="POST",
        headers=headers), timeout=30).close()
    api._reload_thread.join(timeout=120)
    if api._reload_thread.is_alive():
        raise AssertionError("the reload did not end")
    return time.perf_counter() - t0


def _counter(name: str, labels: str = "") -> float:
    """One sample of this process's metrics registry (0 when absent)."""
    return _samples(telemetry.registry().exposition(), name).get(labels, 0.0)


def _import_rows(path: str) -> collections.Counter:
    """The multiset of (user, item, rating, event ms) of an import file."""
    rows = collections.Counter()
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            t = _dt.datetime.fromisoformat(
                d["eventTime"].replace("Z", "+00:00"))
            rows[(d["entityId"], d["targetEntityId"],
                  d["properties"]["rating"], int(t.timestamp() * 1000))] += 1
    return rows


def phase_remote(work: str, seed: int, dev: torch.device, store_out: dict,
                 ctx: dict) -> dict:
    """Phase 11: the store phase's eventlog store behind ``pio
    storageserver`` and every verb of the path through a ``remote``
    source: two trains through kernel A (one with a reply lost), the
    exactly-once import, the deploy through B1 + B2, the storage server
    killed and restarted under a query stream, and the operator tools on
    both daemons. ``ctx`` holds the store phase's warm train."""
    saved = {k: os.environ.get(k)
             for k in (*REMOTE_NAMES, *_remote_env(0))}
    servers = []
    t_phase = time.perf_counter()
    try:
        out = _phase_remote(work, seed, store_out, ctx, servers)
    finally:
        for srv in servers:
            srv.kill()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
        resilience.CircuitBreaker.reset_registry()
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = _smi()
    _print_remote(out)
    return out


def _phase_remote(work, seed, store_out, ctx, servers) -> dict:
    port = _free_port()
    for k in REMOTE_NAMES:
        os.environ.pop(k, None)
    os.environ.update(_remote_env(port))
    os.environ.update({"PIO_TELEMETRY": "1", "PIO_HISTORY_TICK_S": "1"})
    # the query server's process starts its observability from zero, as a
    # fresh `pio deploy` process would: metrics, SLO windows, the flight
    # recorder, the journal, the trace ring and the breakers
    telemetry.registry().reset()
    slo.reset()
    history.reset()
    journal.clear()
    tracing.clear()
    resilience.clear()
    resilience.CircuitBreaker.reset_registry()

    # 1. the store served; the 20M read through it
    first = _StorageServer(work, port, "storageserver_1")
    servers.append(first)
    storage_mod.reset_storage()
    store = storage_mod.get_storage()
    app_id = store.get_meta_data_apps().get_by_name(STORE_APP).id
    t0 = time.perf_counter()
    cols = store.get_events().read_columns(app_id, **STORE_KW)
    read_s = time.perf_counter() - t0
    n_read = int(cols["entity_code"].shape[0])
    reply_mb = sum(v.nbytes for k, v in cols.items() if k != "pool") / 1e6
    del cols
    if n_read != store_out["events"]:
        raise AssertionError(f"the remote read returned {n_read} events, "
                             f"the store holds {store_out['events']}")

    # 2. train through it, then again with the columnar reply lost once
    with open(ENGINE_JSON) as f:
        iters = json.load(f)["algorithms"][0]["params"]["numIterations"]
    engine_dir = _engine_dir(work, "remote_engine", STORE_APP)
    warm = ctx["model"]
    als_algorithm._BIG_LAYOUT_CACHE.clear()      # the layout from this read
    clean, clean_model = _store_train(engine_dir, store, iters, None)
    retries0 = _counter("pio_rpc_retries_total", '{kind="transport"}')
    os.environ.update({
        "PIO_FAULT_SPEC": "drop_rx:1:1@client POST /rpc/read_columns",
        "PIO_FAULT_SEED": REMOTE_FAULT_SEED, "PIO_RPC_RETRIES": "2",
        "PIO_RPC_BACKOFF_MS": "50"})
    storage_mod.reset_storage()                  # a client with retries
    store = storage_mod.get_storage()
    inj = resilience.active()
    als_algorithm._BIG_LAYOUT_CACHE.clear()
    try:
        faulted, faulted_model = _store_train(engine_dir, store, iters, None)
    finally:
        for k in ("PIO_FAULT_SPEC", "PIO_FAULT_SEED", "PIO_RPC_RETRIES",
                  "PIO_RPC_BACKOFF_MS"):
            os.environ.pop(k, None)
    train_fired = dict(inj.fired)
    retried = _counter("pio_rpc_retries_total",
                       '{kind="transport"}') - retries0
    if train_fired != {"drop_rx": 1} or retried != 1:
        raise AssertionError(f"the faulted train: fired {train_fired}, "
                             f"{retried} transport retries (want 1)")
    for t in (clean, faulted):
        if (t["layout_builds"], t["staged_chunks"]) != (1, 0):
            raise AssertionError(f"the remote train: {t}")
    for m in (clean_model, faulted_model):
        if not (_same_factors(m, warm)
                and m.user_vocab.to_dict() == warm.user_vocab.to_dict()
                and m.item_vocab.to_dict() == warm.item_vocab.to_dict()):
            raise AssertionError("a remote train differs from the store "
                                 "phase's warm eventlog train")

    # 3. write through it exactly once
    storage_mod.reset_storage()
    if cli.main(["app", "new", REMOTE_IMPORT_APP]) != 0:
        raise AssertionError("pio app new through the remote source failed")
    store = storage_mod.get_storage()
    import_id = store.get_meta_data_apps().get_by_name(REMOTE_IMPORT_APP).id
    path = os.path.join(work, "remote_import.json")
    n_file = _write_import_file(path, seed, limit=REMOTE_IMPORT_EVENTS)
    want_rows = _import_rows(path)
    replays0 = _counter("pio_rpc_dedup_replays_total")
    os.environ.update({"PIO_RPC_WRITE_DEDUP": "1", "PIO_RPC_RETRIES": "2",
                       "PIO_RPC_BACKOFF_MS": str(REMOTE_RETRY_FLOOR_MS),
                       "PIO_FAULT_SPEC": "drop_rx:1:1@client POST /rpc",
                       "PIO_FAULT_SEED": REMOTE_FAULT_SEED})
    storage_mod.reset_storage()                  # a client with dedup
    inj = resilience.active()
    pauses = []
    try:
        with _retry_floor(REMOTE_RETRY_FLOOR_MS / 1e3, pauses):
            t0 = time.perf_counter()
            rc = cli.main(["import", "--appid", str(import_id), "--input",
                           path])
            import_s = time.perf_counter() - t0
    finally:
        for k in ("PIO_RPC_WRITE_DEDUP", "PIO_RPC_RETRIES",
                  "PIO_RPC_BACKOFF_MS", "PIO_FAULT_SPEC",
                  "PIO_FAULT_SEED"):
            os.environ.pop(k, None)
    os.remove(path)
    import_fired = dict(inj.fired)
    replayed = _counter("pio_rpc_dedup_replays_total") - replays0
    print(f"remote: the import's retry paused "
          f"{', '.join(f'{x:.3f}' for x in pauses)} s (PIO_RPC_BACKOFF_MS="
          f"{REMOTE_RETRY_FLOOR_MS}, floored at it)", flush=True)
    if rc != 0 or import_fired != {"drop_rx": 1} or replayed != 1:
        raise AssertionError(f"pio import: rc {rc}, fired {import_fired}, "
                             f"{replayed} dedup replays (want 1)")
    storage_mod.reset_storage()
    store = storage_mod.get_storage()
    got = list(store.get_events().find(import_id))
    got_rows = collections.Counter(
        (e.entity_id, e.target_entity_id, e.properties.get_opt("rating"),
         int(e.event_time.timestamp() * 1000)) for e in got)
    if len(got) != n_file or got_rows != want_rows:
        raise AssertionError(f"the import stored {len(got)} events for "
                             f"{n_file} lines (or other rows)")
    del got, got_rows, want_rows

    # 4. serve from it, under one client's query stream
    os.environ.update(REMOTE_DEPLOY_ENV)
    storage_mod.reset_storage()
    apis = []

    class Recorded(create_server.QueryAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apis.append(self)

    qport, rcs = _free_port(), []
    users = list(clean_model.user_vocab.to_dict())
    with _wrapped((create_server, "QueryAPI", lambda _c: Recorded)):
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--engine-instance-id",
            clean["instance"], "--ip", "127.0.0.1", "--port", str(qport),
            "--serve-quant", "on", "--aot", "off", "--telemetry"])),
            daemon=True)
        deploy.start()
        deploy_ready_s = _wait_ready(qport, deploy.is_alive)
    (api,) = apis
    breaker = resilience.CircuitBreaker.for_endpoint(f"127.0.0.1:{port}")
    loaded = api.models[0].quant
    topk_fused.reset_launches()          # the serving path starts here
    solve.reset_launches()
    t_ready = time.perf_counter()
    stream = _Stream(qport, users, seed + 13)
    qurl, surl = f"http://127.0.0.1:{qport}", f"http://127.0.0.1:{port}"
    try:
        stream.wait_for(REMOTE_QUERIES_MIN)
        # the load's successful reads leave the breaker's window
        window_s = float(REMOTE_DEPLOY_ENV["PIO_BREAKER_WINDOW_S"])
        time.sleep(max(0.0, window_s + 0.5
                       - (time.perf_counter() - t_ready)))
        old_batcher = api._batcher

        # 5. kill the store under traffic
        gen0 = api.generation
        t_kill = time.perf_counter()
        drain = first.drain()
        failed_s = [_reload(qport, api)]
        t_open = time.perf_counter()
        if breaker.state != "open":
            raise AssertionError(f"the breaker is {breaker.stats()} after "
                                 "the failed reload")
        fast_fails = breaker.stats()["fastFails"]
        failed_s.append(_reload(qport, api))
        if (breaker.stats()["fastFails"] != fast_fails + 1
                or api.generation != gen0):
            raise AssertionError(f"the second reload: {breaker.stats()}, "
                                 f"generation {api.generation}")
        reload_errors = [e["fields"]["error"]
                         for e in journal.snapshot()["events"]
                         if e["message"].startswith("reload FAILED")]
        if len(reload_errors) != 2 or \
                not reload_errors[1].startswith("CircuitOpenError"):
            raise AssertionError(f"reload failures: {reload_errors}")
        gauge = _samples(_get(qport, "/metrics")[2].decode(),
                         "pio_breaker_open")
        device_breakers = json.loads(_get(qport, "/debug/device.json")[2])[
            "breakers"]
        if gauge.get(f'{{endpoint="127.0.0.1:{port}"}}') != 1.0 or [
                (b["endpoint"], b["state"]) for b in device_breakers] != [
                    (f"127.0.0.1:{port}", "open")]:
            raise AssertionError(f"pio_breaker_open {gauge}, breakers "
                                 f"{device_breakers}")
        doctor_open = _cli_out(["doctor", qurl])
        if doctor_open[0] != 1 or f"127.0.0.1:{port}" not in doctor_open[1]:
            raise AssertionError(f"pio doctor, the breaker open: "
                                 f"{doctor_open}")
        fleet_dead = _cli_out(["doctor", "--targets", f"{qurl},{surl}",
                               "--timeout", "2"])
        if fleet_dead[0] != 2:
            raise AssertionError(f"pio doctor --targets, the storage "
                                 f"server down: {fleet_dead}")
        open_checks_s = time.perf_counter() - t_open

        # 6. recover: restart on the same port, the probe after open_s
        t_restart = time.perf_counter()
        second = _StorageServer(work, port, "storageserver_2")
        servers.append(second)
        open_s = float(REMOTE_DEPLOY_ENV["PIO_BREAKER_OPEN_S"])
        time.sleep(max(0.0, open_s + 0.2 - (time.perf_counter() - t_open)))
        ok_s = _reload(qport, api, trace=REMOTE_TRACE)
        t_closed = time.perf_counter()
        if api.generation != gen0 + 1 or breaker.state != "closed":
            raise AssertionError(f"the recovery reload: generation "
                                 f"{api.generation}, {breaker.stats()}")
        doctor_ok = _cli_out(["doctor", qurl])
        if doctor_ok[0] != 0:
            raise AssertionError(f"pio doctor after the recovery: "
                                 f"{doctor_ok}")
        stream.wait_for(len(stream.answers) + 50)
        stream.pause()
        flushes = (old_batcher.stats()["batches"]
                   + api.handle("GET", "/")[1]["batching"]["batches"])
        launches = topk_fused.launches   # the serving path ends here
        merge_launches = topk_fused.merge_launches

        # 7. the fleet read by the operator tools
        targets = f"{qurl},{surl}"
        incident_out = _cli_out(["incident", "--targets", targets,
                                 "--window", "10m"])
        events_out = _cli_out(["events", "--targets", targets])
        trace_out = _cli_out(["trace", REMOTE_TRACE, "--targets", targets])
        monitor_out = _cli_out(["monitor", "--once", "--targets", targets])
    finally:
        stream_out = stream.close()
        undeployed = cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                               str(qport)])
        deploy.join(timeout=60)
    if undeployed != 0 or rcs != [0] or deploy.is_alive():
        raise AssertionError(f"pio deploy exited {rcs}, undeploy "
                             f"{undeployed}")

    # what the stream saw: every query answered, as the plain int8 path
    if stream_out["dropped"]:
        raise AssertionError(f"queries dropped: {stream_out}")
    m = api.models[0]
    served = m.quant
    for name in ("u_q", "u_scale", "vt_q", "v_scale"):
        if not torch.equal(getattr(loaded, name), getattr(served, name)):
            raise AssertionError(f"the reloaded layout's {name} differs")
    inv = m.item_vocab.inverse()
    want = {}
    for u in {a[0] for a in stream.answers}:
        vals, idx = quant.topk_for_users_quant(
            served.u_q, served.u_scale, served.vt_q, served.v_scale,
            torch.tensor([m.user_vocab(u)], dtype=torch.int32,
                         device=served.device), k=10,
            n_items=len(m.item_vocab))
        want[u] = {"itemScores": [
            {"item": inv(int(i)), "score": float(v)}
            for v, i in zip(vals[0].cpu().numpy(), idx[0].cpu().numpy())]}
    bad = [(u, p) for u, _s, p, _t in stream.answers if p != want[u]]
    if bad:
        raise AssertionError(f"{len(bad)} answers differ from the plain "
                             f"int8 path, the first {bad[0]}")
    if flushes == 0 or launches != flushes or merge_launches != flushes:
        raise AssertionError(f"B1 {launches} and B2 {merge_launches} "
                             f"launches for {flushes} flushes")
    if solve.launches:
        raise AssertionError("the serving path launched solve_gj")

    # the operator tools' verdicts
    host = f"127.0.0.1:{port}"
    inc = incident_out[1]
    i_open = inc.find(f"breaker: circuit breaker open for {host}")
    i_half = inc.find(f"breaker: circuit breaker half-open for {host}")
    if incident_out[0] != 1 or not 0 <= i_open < i_half:
        raise AssertionError(f"pio incident: {incident_out}")
    ev_lines = [ln for ln in events_out[1].splitlines() if ln.strip()]
    ats = [ln.split()[0] for ln in ev_lines]
    walk = [ln.split("circuit breaker ", 1)[1].split(" for ")[0]
            for ln in ev_lines if "breaker: circuit breaker " in ln]
    if events_out[0] != 0 or ats != sorted(ats) or \
            walk != ["open", "half-open", "closed"]:
        raise AssertionError(f"pio events: {events_out}")
    per_target = {t: sum(1 for ln in ev_lines if f"[{t}]" in ln)
                  for t in (qurl, surl)}
    head = trace_out[1].splitlines()[0] if trace_out[1] else ""
    if trace_out[0] != 0 or "over 2 target(s)" not in head or not all(
            s in trace_out[1] for s in ("server:/reload", "storage",
                                        "server:/rpc/model")):
        raise AssertionError(f"pio trace: {trace_out}")
    rows = [ln for ln in monitor_out[1].splitlines()
            if ln.startswith("  http://")]
    if monitor_out[0] != 0 or len(rows) != 2 or rows[0].split()[1] == "--":
        raise AssertionError(f"pio monitor: {monitor_out}")
    final_drain = second.drain()
    q_p50, q_p99 = _pct([t for _u, _s, _p, t in stream.answers])
    return {
        "storage_server_ready_s": first.ready_s,
        "remote_read": {"events": n_read, "reply_mb": reply_mb,
                        "s": read_s,
                        "local_s": store_out["read_columns_s"]["pool"]},
        "trains": [clean, faulted],
        "faulted_train": {"fired": train_fired,
                          "transport_retries": int(retried)},
        "import": {"events": n_file, "import_s": import_s,
                   "events_per_s": n_file / import_s,
                   "local_eventlog_events_per_s":
                       store_out["import"]["events_per_s"],
                   "fired": import_fired, "dedup_replays": int(replayed),
                   "retry_pauses_s": pauses},
        "deploy": {"ready_s": deploy_ready_s,
                   "queries": len(stream.answers), "dropped": 0,
                   "query_ms": {"p50": q_p50, "p99": q_p99},
                   "flushes": flushes, "B1_launches": launches,
                   "B2_launches": merge_launches},
        "kill": {"drain": drain, "kill_to_open_s": t_open - t_kill,
                 "failed_reload_s": failed_s,
                 "open_checks_s": open_checks_s},
        "recover": {"storage_server_ready_s": second.ready_s,
                    "restart_to_closed_s": t_closed - t_restart,
                    "reload_s": ok_s,
                    "time_to_ready_s": api.time_to_ready_s,
                    "generation": [gen0, api.generation]},
        "tools": {"incident_rc": incident_out[0],
                  "events_per_target": per_target,
                  "trace_head": head, "monitor_rows": rows},
        "final_drain": final_drain,
    }


def _print_remote(out: dict) -> None:
    card = out["card"]
    r = out["remote_read"]
    print(f"remote: storage server ready in "
          f"{out['storage_server_ready_s']:.3f} s; read_columns of "
          f"{r['events']} events ({r['reply_mb']:.1f} MB of columns) "
          f"through it in {r['s']:.3f} s, the local eventlog read "
          f"{r['local_s']:.3f} s ({card})", flush=True)
    for t, name in zip(out["trains"], ("clean", "one reply lost")):
        print(f"remote: pio train ({name}) through the remote source: wall "
              f"{t['wall_s']:.3f} s (under torch.profiler); phases "
              + ", ".join(f"{k} {v:.3f} s" for k, v in t["phases_s"].items())
              + f"; solve_gj {t['solve_gj_launches']} launches; "
              "bit-identical to the store phase's warm train "
              f"({card})", flush=True)
    i = out["import"]
    print(f"remote: pio import of {i['events']} events with a reply lost "
          f"and deduplicated ({i['dedup_replays']} replay): "
          f"{i['import_s']:.3f} s ({i['events_per_s']:.0f} events/s; the "
          f"local eventlog import {i['local_eventlog_events_per_s']:.0f} "
          f"events/s), stored exactly once ({card})", flush=True)
    d, k, rc = out["deploy"], out["kill"], out["recover"]
    print(f"remote: pio deploy ready in {d['ready_s']:.3f} s; "
          f"{d['queries']} streamed queries equal to the plain int8 path, "
          f"{d['dropped']} dropped, p50 {d['query_ms']['p50']:.3f} ms p99 "
          f"{d['query_ms']['p99']:.3f} ms; B1 {d['B1_launches']} / B2 "
          f"{d['B2_launches']} launches for {d['flushes']} flushes "
          f"({card})", flush=True)
    print(f"remote: SIGTERM -> /readyz 503 in "
          f"{k['drain']['readyz_503_after_s'] * 1e3:.1f} ms, drained in "
          f"{k['drain']['drained_s']:.3f} s; kill to open breaker "
          f"{k['kill_to_open_s']:.3f} s; the failed reloads "
          f"{[round(x * 1e3, 1) for x in k['failed_reload_s']]} ms; "
          f"restart to closed breaker {rc['restart_to_closed_s']:.3f} s "
          f"(storage ready in {rc['storage_server_ready_s']:.3f} s, the "
          f"probe after open_s); the recovery reload {rc['reload_s']:.3f} s "
          f"(time to ready {rc['time_to_ready_s']:.3f} s), generation "
          f"{rc['generation'][0]} -> {rc['generation'][1]} ({card})",
          flush=True)
    t = out["tools"]
    print(f"remote: pio incident exit {t['incident_rc']}; pio events lines "
          f"per target {t['events_per_target']}; pio trace: "
          f"{t['trace_head']}; pio monitor rows {t['monitor_rows']}; "
          f"phase {out['phase_s']:.1f} s", flush=True)


def _print_foldin(fold: dict) -> None:
    for r in fold["kernel_a"]:
        print(f"foldin: kernel A at n = {r['n']}, r = {r['r']}: == plain "
              f"bit for bit; call {r['ms']:.4f} ms, body "
              f"{r['body_ms']} ms, plain {r['plain_ms']:.4f} ms, "
              f"torch.linalg.solve {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
    for aot, r in fold["ready"].items():
        print(f"foldin: time to ready with the warm-up {aot}: "
              f"{r['time_to_ready_s']:.3f} s (to /readyz "
              f"{r['wall_to_ready_s']:.3f} s); warm-up launches B1 "
              f"{r['warmup_B1_launches']}, B2 {r['warmup_B2_launches']}, "
              f"A {r['warmup_A_launches']}", flush=True)
    for i, t in enumerate(fold["ticks"]):
        print(f"foldin: tick {i}: {t['ms']:.1f} ms, {t['events']} events, "
              f"kernel A {t['A_launches']} launches at buckets "
              f"{t['buckets']}", flush=True)
    print(f"foldin: one row's history read from the eventlog "
          f"(FoldinWorker._gather_ratings), ms: trained users "
          f"{[round(x, 1) for x in fold['gather_ms']['trained']]}, unseen "
          f"users {[round(x, 1) for x in fold['gather_ms']['unseen']]}; "
          f"one trained user's read under cProfile (function, cumulative "
          f"ms, calls): {fold['gather_profile']}; a fresh DAO's first "
          f"read (every index sidecar loaded) and its second, ms: "
          f"{[round(x, 1) for x in fold['first_read_after_deploy_ms']]}",
          flush=True)
    print(f"foldin: {fold['events']} events posted (the users' "
          f"{fold['post_s']:.3f} s); the users' folds live "
          f"{fold['converge_s'][0]:.3f} s after their post, the items' "
          f"{fold['converge_s'][1]:.3f} s after theirs; freshness "
          f"(event ack to servable) p50 {fold['freshness_s']['p50']} s, p99 "
          f"{fold['freshness_s']['p99']} s over "
          f"{fold['freshness_s']['observed']} folds; tick p50 "
          f"{fold['tick_ms']['p50']:.1f} ms, max "
          f"{fold['tick_ms']['max']:.1f} ms; {fold['A_solves_checked']} "
          f"kernel A calls == plain bit for bit; B1 {fold['B1_launches']} / "
          f"B2 {fold['B2_launches']} launches for {fold['flushes']} "
          f"flushes; stream {fold['stream']['queries']} queries, "
          f"{fold['stream']['dropped']} dropped; "
          f"{fold['distinct_new_user_answers']} distinct answers for "
          f"{FOLD_NEW_USERS} unseen users; the unseen items' ranks for a "
          f"rater {fold['new_item_rank_for_a_rater']}; "
          f"state {fold['state']}", flush=True)
    h = fold["headroom"]
    print(f"foldin: headroom {h['headroom']}, {h['users']} unseen users: "
          f"generation {h['generation'][0]} -> {h['generation'][1]}, "
          f"capacity {h['capacity_rows'][0]} -> {h['capacity_rows'][1]} "
          f"rows, all folded {h['reload_s']:.3f} s after the posts, "
          f"stream {h['stream']['queries']} queries, "
          f"{h['stream']['dropped']} dropped; POST /reload under "
          f"{h['burst']['queries']} concurrent queries: generation "
          f"{h['burst']['generation'][0]} -> {h['burst']['generation'][1]}, "
          f"0 dropped; phase {fold['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 13: continuous training and the fleet autopilot
# ---------------------------------------------------------------------------

#: the deploy's engine (its instances are the live generation and the
#: candidates) and the comparison train's, both on the store phase's app
CONTROL_ENGINE = "smoke-control"
CONTROL_CLI_ENGINE = "smoke-control-cli"
#: the events that cross the volume trigger: trained users' rates and
#: unseen users' rates
CONTROL_TRAINED_USERS, CONTROL_TRAINED_RATINGS = 200, 8
CONTROL_NEW_USERS, CONTROL_NEW_RATINGS = 40, 10
#: unseen users whose events land after the retrain's read and before its
#: publish: the fold-in rebase at the candidate's cursor must serve them
CONTROL_LATE_USERS, CONTROL_LATE_RATINGS = 8, 6
#: queries of the stream before the loop is attached
CONTROL_BEFORE_QUERIES = 200
#: the rejected candidate's lambda: its factors shrink to nothing, which
#: wrecks the probe RMSE
CONTROL_REJECT_LAMBDA = 1000.0
CONTROL_DEADLINE_S = 180.0
#: one volume-triggered cycle: a small volume threshold, a short poll, a
#: cooldown past the phase, and the other triggers out of reach (the
#: fold-in drift probe off, so no drift recall can precede volume)
AUTOTRAIN_ENV = {
    "PIO_AUTOTRAIN_VOLUME_EVENTS": "1000", "PIO_AUTOTRAIN_POLL_MS": "100",
    "PIO_AUTOTRAIN_COOLDOWN_S": "3600",
    "PIO_AUTOTRAIN_MAX_STALENESS_S": "8640000",
    "PIO_AUTOTRAIN_LAG_EVENTS": "1000000000",
    "PIO_FOLDIN_DRIFT_EVERY": "0", "PIO_FOLDIN_TICK_MS": "100"}
#: the thread ThreadTrainer retrains on, and the loop's (the publish and
#: its warm-up run there)
RETRAIN_THREAD, LOOP_THREAD = "pio-autotrain-retrain", "pio-autotrain"
#: the autopilot step: telemetry on (the per-backend histogram and the
#: burn gauges), a loose latency objective except in the ladder step,
#: burn windows of 2 s and 6 s
PILOT_ENV = {"PIO_TELEMETRY": "1", "PIO_SLO_LATENCY_MS": "10000",
             "PIO_SLO_FAST_WINDOW_S": "2", "PIO_SLO_SLOW_WINDOW_S": "6"}
PILOT_TIGHT_SLO_MS = "0.05"
PILOT_CLIENTS = 8
#: the spawned replica's latency fault, on its query route only
PILOT_LATENCY_MS = 150
PILOT_DEADLINE_S = 30.0


def _device_bytes(dev) -> tuple:
    """``memory_allocated``, then the same once torch's cuBLAS workspaces
    are released: torch keeps one per thread that ran a matmul (tens of
    MB on Hopper) for the next thread to reuse, so a retrain thread
    leaves one behind that no model owns. (None, None) off the card."""
    if dev.type != "cuda":
        return None, None
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        torch.cuda.synchronize()
    return raw, torch.cuda.memory_allocated()


def _control_engine_dir(work: str, engine_id: str) -> str:
    """An engine directory of the template's engine.json, its id
    ``engine_id``, pointed at the store phase's app."""
    path = os.path.join(work, engine_id)
    os.makedirs(path)
    with open(ENGINE_JSON) as f:
        variant = json.load(f)
    variant["id"] = engine_id
    variant["datasource"]["params"]["appName"] = STORE_APP
    with open(os.path.join(path, "engine.json"), "w") as f:
        json.dump(variant, f)
    return path


def _control_train(engine_dir: str, store, engine_id: str):
    """``pio train`` of one engine directory: its ledger row, its model
    and kernel A's launches (nothing else runs on the card meanwhile)."""
    solve.reset_launches()
    if cli.main(["train", "--engine-dir", engine_dir]) != 0:
        raise AssertionError(f"pio train of {engine_id} failed")
    launches = solve.launches
    row = store.get_meta_data_engine_instances().get_latest_completed(
        engine_id, "NOT_USED", engine_id)
    (model,) = model_io.deserialize_models(
        store.get_model_data_models().get(row.id).models)
    return row, model, launches


class _ThreadLaunches:
    """Kernel A, B1 and B2 launches by the launching thread while the
    block runs; every kernel A launch on the retrain thread is checked
    against the plain solve on the same inputs, bit for bit."""

    def __init__(self):
        self.lock = threading.Lock()
        self.a = collections.Counter()
        self.b1 = collections.Counter()
        self.b2 = collections.Counter()
        self.a_mismatch = 0
        self.a_max_abs_err = 0.0

    def clear(self):
        with self.lock:
            self.a.clear()
            self.b1.clear()
            self.b2.clear()

    def wrap(self):
        def count(table):
            with self.lock:
                table[threading.current_thread().name] += 1

        def a(orig):
            def run(A, b, reg):
                x = orig(A, b, reg)
                count(self.a)
                if threading.current_thread().name == RETRAIN_THREAD:
                    p = solve.solve_gj_plain(A, b, reg)
                    same = bool(_bitwise_same(x, p).all())
                    err = float((x - p).abs().max()) if x.numel() else 0.0
                    with self.lock:
                        self.a_mismatch += 0 if same else 1
                        self.a_max_abs_err = max(self.a_max_abs_err, err)
                return x
            return run

        def b(table):
            def make(orig):
                def run(*args, **kw):
                    out = orig(*args, **kw)
                    count(table)
                    return out
                return run
            return make

        return _wrapped((solve, "_launch", a),
                        (topk_fused, "_launch", b(self.b1)),
                        (topk_fused, "_launch_merge", b(self.b2)))

    def split(self, table) -> dict:
        """{retrain, loop, other} of one table."""
        with self.lock:
            got = dict(table)
        return {"retrain": got.pop(RETRAIN_THREAD, 0),
                "loop": got.pop(LOOP_THREAD, 0),
                "other": sum(got.values())}


def phase_control(work: str, seed: int, dev: torch.device) -> dict:
    """Phase 13 on the store phase's eventlog app, after its fold-in
    step: (a) a volume-triggered autotrain cycle in a deploy with fold-in,
    (b) a candidate the score gate refuses, (c) the autopilot over a
    router of two replicas of the published model."""
    env = {**_eventlog_env(work), **AUTOTRAIN_ENV}
    names = (*env, *PILOT_ENV, "PIO_TRAIN_STREAM", "PIO_FOLDIN_CURSOR_DIR",
             "PIO_PROFILE_DIR")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.pop("PIO_TRAIN_STREAM", None)
    os.environ.update(env)
    storage_mod.reset_storage()
    t_phase = time.perf_counter()
    try:
        store = storage_mod.get_storage()
        out = {"card": _smi()}
        live_dir = _control_engine_dir(work, CONTROL_ENGINE)
        cli_dir = _control_engine_dir(work, CONTROL_CLI_ENGINE)
        out["autotrain"] = _control_autotrain(work, store, live_dir,
                                              cli_dir, seed, dev)
        _print_autotrain(out["autotrain"])
        out["autopilot"] = _control_autopilot(work, store, live_dir, seed,
                                              dev)
        _print_autopilot(out["autopilot"])
        store.get_events().close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        slo.install(slo.SLOConfig.from_env())
        storage_mod.reset_storage()
    out["phase_s"] = time.perf_counter() - t_phase
    print("control: " + json.dumps(out), flush=True)
    return out


def _trigger_events(model, seed: int) -> list:
    rng = np.random.default_rng(seed + 61)
    users = list(model.user_vocab.to_dict())
    items = list(model.item_vocab.to_dict())
    out = []
    for u in rng.choice(len(users), size=CONTROL_TRAINED_USERS,
                        replace=False):
        for i in rng.choice(len(items), size=CONTROL_TRAINED_RATINGS,
                            replace=False):
            out.append(_rate(users[u], items[i],
                             float(rng.integers(1, 11)) / 2))
    for j in range(CONTROL_NEW_USERS):
        for i in rng.choice(len(items), size=CONTROL_NEW_RATINGS,
                            replace=False):
            out.append(_rate(f"control_u{j}", items[i],
                             float(rng.integers(1, 11)) / 2))
    return [out[i] for i in rng.permutation(len(out))]


def _control_autotrain(work, store, live_dir, cli_dir, seed, dev) -> dict:
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service

    out = {}
    # the live generation, then the events that cross the volume trigger
    live_row, live_model, live_a = _control_train(live_dir, store,
                                                  CONTROL_ENGINE)
    es, es_port = http_mod.serve_background(
        service.EventAPI(storage=store), "127.0.0.1", 0)
    try:
        trigger = _trigger_events(live_model, seed)
        t0 = time.perf_counter()
        _post_events(es_port, trigger)
        out["trigger_events"] = len(trigger)
        out["trigger_post_s"] = time.perf_counter() - t0
        # the comparison: pio train of the same app, seed and store,
        # before the retrain reads it (no event lands in between)
        cli_row, cli_model, cli_a = _control_train(cli_dir, store,
                                                   CONTROL_CLI_ENGINE)
        out["cli_train"] = {"instance": cli_row.id, "A_launches": cli_a,
                            "cursor": cli_row.runtime_conf.get(
                                "train_cursor")}
        out["live_train"] = {"instance": live_row.id,
                             "A_launches": live_a,
                             "cursor": live_row.runtime_conf.get(
                                 "train_cursor")}
        cycle, reject = _control_cycle(work, store, live_dir, live_row,
                                       live_model, cli_row, cli_model,
                                       es_port, seed, dev)
    finally:
        es.shutdown()
        es.server_close()
    out.update(cycle)
    out["reject"] = reject
    return out


def _control_cycle(work, store, live_dir, live_row, live_model, cli_row,
                   cli_model, es_port, seed, dev):
    from predictionio_tpu_torch.models.recommendation.data_source import (
        DataSource,
    )
    from predictionio_tpu_torch.serving import registry as registry_mod
    from predictionio_tpu_torch.workflow import autotrain

    with open(os.path.join(live_dir, "engine.json")) as f:
        variant = json.load(f)
    items = list(live_model.item_vocab.to_dict())
    rng = np.random.default_rng(seed + 63)
    late_users = [f"late_u{j}" for j in range(CONTROL_LATE_USERS)]
    late = [_rate(u, items[i], float(rng.integers(1, 11)) / 2)
            for u in late_users
            for i in rng.choice(len(items), size=CONTROL_LATE_RATINGS,
                                replace=False)]
    marks = {}

    def late_hook(orig):
        # the late events land after the retrain's read returned: past
        # its training cursor and outside its model
        def read_training(self, ctx_):
            td = orig(self, ctx_)
            if (threading.current_thread().name == RETRAIN_THREAD
                    and "late_s" not in marks):
                marks["late_s"] = time.perf_counter()
                _post_events(es_port, late)
            return td
        return read_training

    def timed(key, with_memory=False):
        def make(orig):
            def run(*a, **kw):
                if with_memory and dev.type == "cuda":
                    torch.cuda.synchronize()
                    marks["mem_swap_start"] = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    marks.setdefault(key, []).append(
                        (t0, time.perf_counter()))
                    if with_memory and dev.type == "cuda":
                        torch.cuda.synchronize()
                        marks["mem_swap_peak"] = \
                            torch.cuda.max_memory_allocated()
            return run
        return make

    def retrain_window(orig):
        def run(self):
            marks.setdefault("retrain_at", []).append(len(stream.answers))
            t0 = time.perf_counter()
            try:
                return orig(self)
            finally:
                marks["retrain_at"].append(len(stream.answers))
                marks.setdefault("retrain", []).append(
                    (t0, time.perf_counter()))
        return run

    os.environ["PIO_FOLDIN_CURSOR_DIR"] = os.path.join(work, "cur_control")
    config = create_server.ServerConfig(
        serve_quant="on", foldin="on", engine_id=CONTROL_ENGINE,
        engine_variant=CONTROL_ENGINE)
    api = create_server.QueryAPI(config, storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    ready_s = _wait_ready(port, server.is_alive, deadline_s=300)
    if api.engine_instance.id != live_row.id or \
            api._foldin_worker is None:
        raise AssertionError("the control deploy did not serve the live "
                             "generation with fold-in")
    gen0 = api.generation
    users = list(live_model.user_vocab.to_dict())
    counts = _ThreadLaunches()
    stream = None
    try:
        with counts.wrap(), _wrapped(
                (DataSource, "read_training", late_hook),
                (autotrain, "validate_candidate", timed("validate")),
                (autotrain.LocalDeployControl, "publish",
                 timed("publish", with_memory=True)),
                (autotrain.ThreadTrainer, "_run", retrain_window)):
            stream = _Stream(port, users, seed + 64)
            stream.wait_for(CONTROL_BEFORE_QUERIES)
            stream.pause()
            mem_before = _device_bytes(dev)
            # the retired batcher's flush count, read through its counter:
            # holding the batcher would hold its generation's layout
            gen1_flushes = api._batcher._m_batches
            since1 = gen1_flushes.value
            counts.clear()
            n_before = len(stream.answers)
            layout0 = registry_mod.model_hbm_bytes(api.models)
            stream.resume()
            t_attach = time.perf_counter()
            at = cli._embedded_autotrain(api, config, variant, False)
            t0 = time.perf_counter()
            while at.summary()["lastCycle"] is None:
                s = at.summary()
                failed = [e for e in journal.snapshot(
                    category="autotrain", level="red")["events"]]
                if failed or (s["lastCandidate"]
                              and not s["lastCandidate"]["ok"]):
                    raise AssertionError(f"the autotrain cycle failed: "
                                         f"{failed[-1:]} {s}")
                if time.perf_counter() - t0 > CONTROL_DEADLINE_S:
                    raise AssertionError(f"no autotrain cycle in "
                                         f"{CONTROL_DEADLINE_S} s: {s}")
                time.sleep(0.05)
            cycle_s = time.perf_counter() - t_attach
            summary = at.summary()
            at.close()
            fold_s = _wait_worker(
                api, lambda st: st["generation"] == api.generation
                and st["usersFolded"] >= CONTROL_LATE_USERS
                and st["cursorLag"] == 0 and not st["usersPending"],
                "the late users' folds after the rebase")
            c = _Client(port)
            try:
                late_answers = [c.call("POST", "/queries.json",
                                       {"user": u, "num": 10})
                                for u in late_users]
            finally:
                c.close()
            stream.pause()
            mem_after = _device_bytes(dev)
            flushes = (int(gen1_flushes.value - since1),
                       api._batcher.stats()["batches"])
            b1, b2, a = (counts.split(counts.b1), counts.split(counts.b2),
                         counts.split(counts.a))
            retrain_a_mismatch = counts.a_mismatch
            retrain_a_err = counts.a_max_abs_err
            layout1 = registry_mod.model_hbm_bytes(api.models)
            stream.resume()
            reject = _control_reject(store, api, port, variant, users,
                                     late_users, counts, seed, dev)
            stream.pause()
            reject["memory_allocated"] = _device_bytes(dev)
            stream.resume()
        answers = list(stream.answers)
        stream_out = stream.close()
        stream = None
    finally:
        if stream is not None:
            stream.close()
        _undeploy(port, server)
    if stream_out["dropped"] or stream_out["errors"]:
        raise AssertionError(f"the autotrain deploy dropped queries: "
                             f"{stream_out}")

    # the cycle: a volume decision, one candidate through both gates,
    # published as generation + 1
    decisions = [e for e in journal.snapshot(category="autotrain")["events"]
                 if e["fields"].get("outcome") == "ok"
                 and e["fields"].get("trigger")]
    cand_id = summary["lastCycle"]["candidateId"]
    if (not decisions or decisions[0]["fields"]["trigger"] != "volume"
            or decisions[0]["fields"]["volume"] < 1000):
        raise AssertionError(f"the cycle was not volume-triggered: "
                             f"{decisions[:1]}")
    verdict = summary["lastCandidate"]
    if not verdict["ok"] or api.generation != gen0 + 1 \
            or api.engine_instance.id != cand_id:
        raise AssertionError(f"the candidate was not published: {summary}")
    if a["retrain"] != 20 or retrain_a_mismatch:
        raise AssertionError(f"the retrain launched kernel A "
                             f"{a['retrain']} times, {retrain_a_mismatch} "
                             "of them != plain (want 20, all equal)")
    warm = len(api._aot_state["buckets"]) if api._aot_state else 0
    if warm and a["loop"] != len(foldin.user_buckets()):
        raise AssertionError(f"the publish's warm-up launched kernel A "
                             f"{a['loop']} times (want one a fold-in "
                             "bucket)")
    if b1["retrain"] or b2["retrain"]:
        raise AssertionError("the retrain thread launched B1 or B2")
    if (b1["other"], b2["other"]) != (sum(flushes), sum(flushes)) or \
            (b1["loop"], b2["loop"]) != (warm, warm):
        raise AssertionError(
            f"B1 {b1} and B2 {b2} for flushes {flushes} of the two "
            f"generations and a warm-up of {warm} buckets (want one each a "
            "flush, one each a bucket in the publish's warm-up)")
    # bit-identical to the CLI train over the same store, seed and cursor
    cand_row = store.get_meta_data_engine_instances().get(cand_id)
    (cand,) = model_io.deserialize_models(
        store.get_model_data_models().get(cand_id).models)
    if cand_row.runtime_conf.get("train_cursor") != \
            cli_row.runtime_conf.get("train_cursor") or \
            not _same_factors(cand, cli_model) or \
            cand.user_vocab.to_dict() != cli_model.user_vocab.to_dict():
        raise AssertionError("the candidate differs from the CLI train at "
                             "the same cursor")
    # the rebase at the candidate's cursor replayed the late events
    rebased = [e for e in journal.snapshot(category="foldin")["events"]
               if "rebased" in e["message"]]
    if not rebased or not rebased[-1]["fields"].get("fromTraining"):
        raise AssertionError(f"fold-in was not rebased at the training "
                             f"cursor: {rebased[-1:]}")
    model = api.models[0]
    for u, (status, payload, _t) in zip(late_users, late_answers):
        want = _served(model, u, 10)
        if status != 200 or not payload["itemScores"] or payload != want:
            raise AssertionError(f"late user {u} after the rebase: "
                                 f"{status} {payload}, want {want}")
    # one model's worth after the swap: the retired generation freed
    # (compared without the retrain thread's cuBLAS workspace), and no
    # growth past it across the rejected cycle's retrain
    if mem_after[1] is not None and (
            mem_after[1] - mem_before[1] > max(0, layout1 - layout0)
            + (1 << 20)
            or reject["memory_allocated"][1] - mem_after[1] > 1 << 20):
        raise AssertionError(
            f"memory_allocated (raw, without cuBLAS workspaces) "
            f"{mem_before} before the swap, {mem_after} after, "
            f"{reject['memory_allocated']} after the rejected cycle "
            f"(layouts {layout0} -> {layout1} B): the retired generation "
            "was not freed")
    lo, hi = marks["retrain_at"][:2]
    before_ms = _pct([t for *_x, t in answers[:n_before]])
    during_ms = _pct([t for *_x, t in answers[lo:hi]]) if hi > lo \
        else (None, None)
    # the cycle's steps, then the rejected cycle's (index 1)
    span = lambda key, i=0: marks[key][i][1] - marks[key][i][0]
    rt = marks["retrain_at"]
    reject["validate_s"] = span("validate", 1)
    return {
        "deploy_ready_s": ready_s, "generation": [gen0, api.generation],
        "decision": {k: decisions[0]["fields"].get(k)
                     for k in ("trigger", "volume", "threshold")},
        "candidate": cand_id, "live": live_row.id,
        "cycle_s": cycle_s, "cycleS": summary["lastCycle"]["cycleS"],
        "retrain_s": span("retrain"), "validate_s": span("validate"),
        "publish_s": span("publish"),
        "verdict": verdict,
        "queries": {"before": n_before, "during_retrain": hi - lo,
                    "total": len(answers), "dropped": 0,
                    "before_ms": dict(zip(("p50", "p99"), before_ms)),
                    "during_retrain_ms": dict(zip(("p50", "p99"),
                                                  during_ms))},
        "memory_allocated": {"before": mem_before,
                             "swap_start": marks.get("mem_swap_start"),
                             "swap_peak": marks.get("mem_swap_peak"),
                             "after": mem_after,
                             "after_rejected_cycle":
                                 reject["memory_allocated"],
                             "layout_bytes": [layout0, layout1]},
        "late": {"users": CONTROL_LATE_USERS, "events": len(late),
                 "fold_s_after_cycle": fold_s,
                 "rebase": rebased[-1]["fields"]},
        "launches": {"A": a, "B1": b1, "B2": b2,
                     "flushes": list(flushes), "warmup_buckets": warm,
                     "A_max_abs_err": retrain_a_err},
        "bit_identical_to_cli_train": True,
        "cursor": cand_row.runtime_conf.get("train_cursor"),
        "retrain_window_answers": rt,
    }, reject


def _control_reject(store, api, port, variant, users, late_users, counts,
                    seed, dev) -> dict:
    """(b): a staleness-triggered cycle whose retrain's lambda wrecks the
    probe RMSE: the score gate refuses it, its row turns REJECTED, the
    generation stays and every answer keeps its bytes."""
    from predictionio_tpu_torch.workflow import autotrain
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(seed + 65)
    probe = [users[u] for u in rng.choice(len(users), size=16,
                                          replace=False)] + late_users
    before = {u: _raw_post(port, _qbody(u, 10))[1] for u in probe}
    gen, live = api.generation, api.engine_instance.id
    bad = json.loads(json.dumps(variant))
    bad["algorithms"][0]["params"]["lambda"] = CONTROL_REJECT_LAMBDA
    engine = api.engine

    def bad_retrain() -> str:
        return core_workflow.run_train(
            WorkflowContext(storage=store, device=api.device), engine,
            engine.engine_params_from_json(bad),
            engine_id=CONTROL_ENGINE, engine_variant=CONTROL_ENGINE,
            engine_factory=bad["engineFactory"], params_json=bad)

    trainer = autotrain.ThreadTrainer(bad_retrain, device=api.device)
    at = autotrain.Autotrain(
        autotrain.LocalDeployControl(api), storage=store,
        engine_params=api.engine_params, trainer=trainer,
        config=autotrain.AutotrainConfig(max_staleness_s=1.0),
        engine_id=CONTROL_ENGINE, engine_variant=CONTROL_ENGINE)
    counts.clear()
    t0 = time.perf_counter()
    sig = at.gather()
    while sig.staleness_s is not None and sig.staleness_s < 1.0:
        time.sleep(0.1)                 # the live model a second old
        sig = at.gather()
    acted = at.tick(sig)
    if [d["trigger"] for d in acted] != ["staleness"]:
        raise AssertionError(f"the forced cycle decided {acted}: {sig}")
    trainer._thread.join(timeout=CONTROL_DEADLINE_S)
    retrain_s = time.perf_counter() - t0
    at.tick(at.gather())
    s = at.summary()
    verdict = s["lastCandidate"]
    a = counts.split(counts.a)
    cand = verdict["candidateId"] if verdict else None
    row = store.get_meta_data_engine_instances().get(cand) if cand else None
    after = {u: _raw_post(port, _qbody(u, 10))[1] for u in probe}
    if (verdict is None or verdict["ok"] or row is None
            or row.status != "REJECTED" or s["candidatesRejected"] != 1):
        raise AssertionError(f"the wrecked candidate was not rejected: "
                             f"{s}")
    if api.generation != gen or api.engine_instance.id != live:
        raise AssertionError("the rejected cycle moved the generation")
    if after != before:
        raise AssertionError("answers changed across the rejected cycle")
    if a["retrain"] != 20 or counts.a_mismatch:
        raise AssertionError(f"the rejected retrain launched kernel A "
                             f"{a['retrain']} times")
    return {"candidate": cand, "status": row.status, "verdict": verdict,
            "retrain_s": retrain_s, "A_launches": a["retrain"],
            "answers_byte_identical": len(probe), "generation": gen}


class _PilotLoad:
    """``clients`` threads posting trained users' queries to one port,
    each ``pace_s`` apart; every answer that is not a 200 is a drop."""

    def __init__(self, port: int, users, seed: int, clients: int,
                 pace_s: float = 0.0):
        rng = np.random.default_rng(seed)
        self._users = [users[u] for u in rng.integers(0, len(users),
                                                      size=512)]
        self._port, self._pace = port, pace_s
        self._stop = threading.Event()
        self.statuses = collections.Counter()
        self.errors = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(c,),
                                          daemon=True)
                         for c in range(clients)]
        for t in self._threads:
            t.start()

    def _run(self, c: int):
        i = c
        while not self._stop.is_set():
            u = self._users[i % len(self._users)]
            i += 7
            try:
                status, _raw, _t = _raw_post(self._port, _qbody(u, 10))
            except OSError as e:
                with self._lock:
                    self.errors.append(f"{type(e).__name__}: {e}")
                continue
            with self._lock:
                self.statuses[status] += 1
            if self._pace:
                time.sleep(self._pace)

    def answered(self) -> int:
        with self._lock:
            return sum(self.statuses.values())

    def close(self) -> dict:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)
        out = {"queries": self.answered(),
               "statuses": {str(k): v for k, v in self.statuses.items()},
               "errors": self.errors[:3]}
        if set(self.statuses) - {200} or self.errors:
            raise AssertionError(f"the autopilot's traffic dropped "
                                 f"queries: {out}")
        return out


def _ticks_until(ap, want, what: str, every_s: float = 1.0) -> list:
    """gather + tick every ``every_s`` until an action of ``want`` was
    taken (ok); every action taken on the way."""
    taken = []
    t0 = time.perf_counter()
    while True:
        time.sleep(every_s)
        acted = ap.tick(ap.gather())
        taken += acted
        bad = [x for x in acted if x["outcome"] != "ok"]
        if bad:
            errors = [e["fields"].get("error") for e in journal.snapshot(
                category="autopilot", level="red")["events"]]
            raise AssertionError(f"autopilot {what}: {bad}: {errors[-2:]}")
        if any(x["action"] == want for x in acted):
            return taken
        if time.perf_counter() - t0 > PILOT_DEADLINE_S:
            raise AssertionError(f"autopilot: no {want} within "
                                 f"{PILOT_DEADLINE_S} s ({what}); took "
                                 f"{taken}")


def _pilot_config(autopilot, **kw):
    base = dict(poll_ms=500.0, cooldown_s=2.0, util_low=0.2,
                util_high=0.85, min_replicas=2, max_replicas=3,
                outlier_x=3.0, profile_ms=1000)
    base.update(kw)
    return autopilot.AutopilotConfig(**base)


def _control_autopilot(work, store, live_dir, seed, dev) -> dict:
    """(c) the autopilot over a router of two in-process replicas of the
    published model: a scale-up through SubprocessReplicaPool (a ``pio
    deploy`` child on the card), the child quarantined as a latency
    outlier and readmitted, then drained; one ladder rung under a burn
    with one profile capture; a dry run."""
    import shlex

    from predictionio_tpu_torch import device as device_mod
    from predictionio_tpu_torch.workflow import autopilot
    from predictionio_tpu_torch.workflow import router as router_mod

    os.environ.update(PILOT_ENV)
    prof_dir = os.path.join(work, "pilot_profiles")
    os.environ["PIO_PROFILE_DIR"] = prof_dir
    slo.install(slo.SLOConfig.from_env())
    out = {}
    launches = _Launches()
    a = _fleet_api(store, engine_id=CONTROL_ENGINE,
                   engine_variant=CONTROL_ENGINE)
    b = _fleet_api(store, engine_id=CONTROL_ENGINE,
                   engine_variant=CONTROL_ENGINE)
    sa, pa = _fleet_serve(a)
    sb, pb = _fleet_serve(b)
    users = list(a.models[0].user_vocab.to_dict())
    router = router_mod.RouterAPI(router_mod.RouterConfig(
        backends=(f"http://127.0.0.1:{pa}", f"http://127.0.0.1:{pb}"),
        health_ms=FLEET_HEALTH_MS))
    sr, pr = _fleet_serve(router, "threaded")
    pythonpath = os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p)
    replica_cmd = (f"{shlex.quote(sys.executable)} -m "
                   "predictionio_tpu_torch.tools.cli deploy --engine-dir "
                   f"{shlex.quote(live_dir)} --ip 127.0.0.1 --port {{port}} "
                   "--serve-quant on")
    pool = autopilot.SubprocessReplicaPool(replica_cmd, env={
        **os.environ, "PYTHONPATH": pythonpath,
        "PIO_FAULT_SPEC": (f"latency:1:{PILOT_LATENCY_MS}"
                           "@server POST /queries.json")})
    control = autopilot.LocalRouterControl(router)
    load = None
    try:
        with launches.wrap():
            launches.clear()
            since = {"a": _batches(a), "b": _batches(b)}
            # 1. scale up: eight clients keep both replicas busy
            ap = autopilot.Autopilot(control, config=_pilot_config(
                autopilot), pool=pool)
            router.attach_autopilot(ap)
            load = _PilotLoad(pr, users, seed + 71, PILOT_CLIENTS)
            ap.gather()
            t0 = time.perf_counter()
            taken = _ticks_until(ap, "scale_up", "scale-up")
            spawn_s = time.perf_counter() - t0
            (child_url,) = list(pool._procs)
            child_proc = pool._procs[child_url]
            child_name = child_url.split("//", 1)[1]
            cport = int(child_url.rsplit(":", 1)[1])
            child = json.loads(_get(cport, "/")[2])
            if child.get("device") != device_mod.describe(dev) or \
                    not (child.get("quant") or {}).get("enabled"):
                raise AssertionError(f"the spawned replica serves on "
                                     f"{child.get('device')} with quant "
                                     f"{child.get('quant')}")
            probe = [users[u] for u in np.random.default_rng(
                seed + 72).choice(len(users), size=16, replace=False)]
            for u in probe:
                want = _raw_post(pa, _qbody(u, 10))
                got = _raw_post(cport, _qbody(u, 10))
                if (got[0], got[1]) != (want[0], want[1]):
                    raise AssertionError(f"the spawned replica answers {u} "
                                         f"{got[1][:80]}, replica a "
                                         f"{want[1][:80]}")
            out["scale_up"] = {
                "actions": [x["action"] for x in taken],
                "spawn_s": spawn_s, "child": child_name,
                "child_time_to_ready_s": child.get("aot", {}).get(
                    "timeToReadyS"),
                "child_device": child["device"],
                "child_quant": child["quant"],
                "answers_byte_equal": len(probe)}
            # 2. the child (its query route 150 ms slower) is quarantined
            # as a latency outlier, then readmitted
            apq = autopilot.Autopilot(control, config=_pilot_config(
                autopilot, max_replicas=2))
            apq.gather()
            taken = _ticks_until(apq, "quarantine", "quarantine")
            q = next(x for x in journal.snapshot(
                category="autopilot")["events"]
                if x["fields"].get("action") == "quarantine"
                and x["fields"].get("outcome") == "ok")
            if q["fields"]["backend"] != child_name:
                raise AssertionError(f"quarantined {q['fields']}, not the "
                                     f"slow replica {child_name}")
            taken += _ticks_until(apq, "readmit", "readmission")
            st = router.handle("GET", "/")[1]
            if st["inRotation"] != 3:
                raise AssertionError(f"after readmission: {st}")
            out["quarantine"] = {"evidence": q["fields"],
                                 "actions": [x["action"] for x in taken]}
            heavy = load.close()
            load = None
            # 3. drain: one light client, the spawned replica retired
            load = _PilotLoad(pr, users, seed + 73, 1, pace_s=0.25)
            ap.gather()
            taken = _ticks_until(ap, "scale_down", "scale-down", 1.5)
            t0 = time.perf_counter()
            while child_proc.poll() is None:
                time.sleep(0.5)
                ap.tick(ap.gather())
                if time.perf_counter() - t0 > PILOT_DEADLINE_S:
                    raise AssertionError("the drained replica never "
                                         "stopped")
            light = load.close()
            load = None
            st = router.handle("GET", "/")[1]
            if child_name in {x["url"].split("//", 1)[1]
                              for x in st["backends"]} or pool._procs:
                raise AssertionError(f"the drained replica is still in "
                                     f"the fleet: {st}")
            out["scale_down"] = {"actions": [x["action"] for x in taken],
                                 "child_exit": child_proc.returncode,
                                 "heavy": heavy, "light": light}
            # 4. the ladder: a tight latency objective burns both windows
            out["ladder"] = _pilot_ladder(autopilot, control, router, a,
                                          pa, users, seed, pr)
            # 5. a dry run over the fleet: would-haves, nothing touched
            router.attach_autopilot(None)
            apd = autopilot.Autopilot(control, config=_pilot_config(
                autopilot, dry_run=True, min_replicas=3, cooldown_s=0.1),
                pool=pool)
            before = json.dumps(router.handle("GET", "/")[1],
                                sort_keys=True)
            apd.gather()
            time.sleep(0.3)
            acted = apd.tick(apd.gather())
            after = json.dumps(router.handle("GET", "/")[1],
                               sort_keys=True)
            if not acted or any(x["outcome"] != "dry_run" for x in acted) \
                    or after != before or pool._procs:
                raise AssertionError(f"the dry run acted: {acted}")
            out["dry_run"] = {"would": [x["action"] for x in acted],
                              "pendingDryRun": apd.summary()[
                                  "pendingDryRun"],
                              "byte_identical": True}
            counts = {"a": launches.of(a.models[0].quant),
                      "b": launches.of(b.models[0].quant)}
            out["launches"] = {
                name: {"B1": c[0], "B2": c[1],
                       "flushes": _require_flushes(
                           f"replica {name}", api, c, since[name])}
                for (name, c), api in zip(counts.items(), (a, b))}
    finally:
        if load is not None:
            load._stop.set()
        pool.close()
        _fleet_stop((sr, router), (sa, a), (sb, b))
    return out


def _pilot_ladder(autopilot, control, router, a, pa, users, seed, pr):
    """One rung under a sustained burn, exactly one profile capture on a
    replica, and the exact thresholds back once the burn stops. A capture
    that recorded no kernel at all (the profiler drops a session now and
    then) is taken in a second episode."""
    for attempt in range(2):
        # a cooldown past the episode's second tick: the capture's POST
        # waits for the replica's profiler to start
        apl = autopilot.Autopilot(control, config=_pilot_config(
            autopilot, max_replicas=2, cooldown_s=8.0))
        router.attach_autopilot(apl)
        prior = control.shed_thresholds()
        listing0 = {c["id"] for c in json.loads(
            _get(pa, "/debug/profile")[2])["captures"]}
        load = _PilotLoad(pr, users, seed + 74 + attempt, PILOT_CLIENTS)
        os.environ["PIO_SLO_LATENCY_MS"] = PILOT_TIGHT_SLO_MS
        slo.install(slo.SLOConfig.from_env())
        try:
            apl.gather()
            taken = _ticks_until(apl, "shed_widen", "the ladder")
            widened = control.shed_thresholds()
            time.sleep(0.8)
            more = apl.tick(apl.gather())        # inside the cooldown
            taken += more
            burn = apl.gather()
        finally:
            traffic = load.close()
            os.environ["PIO_SLO_LATENCY_MS"] = PILOT_ENV[
                "PIO_SLO_LATENCY_MS"]
            slo.install(slo.SLOConfig.from_env())
        captures = [x for x in taken if x["action"] == "profile_capture"]
        if len(captures) != 1 or any(x["action"] == "shed_widen"
                                     for x in more):
            raise AssertionError(f"one burn episode took {taken}")
        # the capture on replica a
        done, t0 = None, time.perf_counter()
        while done is None or done["state"] not in ("done", "failed"):
            time.sleep(0.2)
            new = [c for c in json.loads(
                _get(pa, "/debug/profile")[2])["captures"]
                if c["id"] not in listing0]
            if len(new) > 1:
                raise AssertionError(f"{len(new)} captures in one episode")
            done = new[0] if new else None
            if time.perf_counter() - t0 > PILOT_DEADLINE_S:
                raise AssertionError(f"the capture did not finish: {done}")
        events = _trace_events(os.path.join(done["dir"], "trace.json"))
        per = {}
        for e in events:
            if e.get("cat") == "kernel":
                us, n = per.get(e["name"], (0.0, 0))
                per[e["name"]] = (us + e.get("dur", 0.0), n + 1)
        # burn over: idle past the fast window and the shed cooldown
        time.sleep(2.5)
        narrowed = _ticks_until(apl, "shed_narrow", "the ladder's restore")
        restored = control.shed_thresholds()
        if restored != prior or apl.summary()["ladderDepth"] != 0:
            raise AssertionError(f"thresholds {prior} -> {widened} -> "
                                 f"{restored}")
        if not per and attempt == 0:
            print("control: the episode's capture recorded no kernel; "
                  "a second episode", flush=True)
            continue
        _require_kernels(per, "the autopilot's capture")
        router.attach_autopilot(None)
        return {"episodes": attempt + 1, "prior": prior,
                "widened": widened, "restored": restored,
                "burn": {"fast": burn.burn_fast, "slow": burn.burn_slow},
                "actions": [x["action"] for x in taken + narrowed],
                "capture": {"state": done["state"],
                            "durationMs": done.get("durationMs"),
                            "B1_kernels": sum(n for k, (_u, n) in
                                              per.items()
                                              if "score_mask_topk" in k),
                            "B2_kernels": sum(n for k, (_u, n) in
                                              per.items()
                                              if "merge_tile_lists" in k),
                            "sort_kernels": _sort_kernels(per)},
                "traffic": traffic}
    raise AssertionError("unreachable")


def _print_autotrain(o: dict) -> None:
    q = o["queries"]
    m = o["memory_allocated"]
    print(f"control: autotrain: {o['trigger_events']} events posted; "
          f"decision {o['decision']}; cycle {o['cycle_s']:.3f} s from the "
          f"attach (loop's cycleS {o['cycleS']}): retrain "
          f"{o['retrain_s']:.3f} s, validate {o['validate_s']:.3f} s, "
          f"publish {o['publish_s']:.3f} s; "
          f"generation {o['generation'][0]} -> {o['generation'][1]}; "
          f"candidate == the CLI train at cursor {o['cursor']}, bit for "
          f"bit; kernel A {o['launches']['A']} launches by thread (the "
          f"retrain's 20 == plain), B1 {o['launches']['B1']}, B2 "
          f"{o['launches']['B2']} for flushes {o['launches']['flushes']} "
          f"+ a warm-up of {o['launches']['warmup_buckets']} buckets; "
          f"query p50 / p99 before {q['before_ms']}, during the retrain "
          f"{q['during_retrain_ms']} ms; {q['total']} queries, 0 dropped; "
          f"memory_allocated before {m['before']}, swap start "
          f"{m['swap_start']}, swap peak {m['swap_peak']}, after "
          f"{m['after']} (layouts {m['layout_bytes']} B); "
          f"{o['late']['users']} late users folded after the rebase "
          f"{o['late']['fold_s_after_cycle']:.3f} s after the cycle; "
          f"verdict {json.dumps(o['verdict'])}", flush=True)
    r = o["reject"]
    print(f"control: rejected candidate {r['candidate']}: "
          f"{r['status']}, {'; '.join(r['verdict']['reasons'])}; "
          f"generation stays {r['generation']}, "
          f"{r['answers_byte_identical']} answers byte-identical", flush=True)


def _print_autopilot(o: dict) -> None:
    s, ld = o["scale_up"], o["ladder"]
    print(f"control: autopilot: scale-up spawned {s['child']} in "
          f"{s['spawn_s']:.3f} s (its time to ready "
          f"{s['child_time_to_ready_s']} s) on {s['child_device']}, "
          f"answers byte-equal to a replica's; quarantine "
          f"{o['quarantine']['evidence']}; scale-down "
          f"{o['scale_down']['actions']} (exit "
          f"{o['scale_down']['child_exit']}), 0 dropped; ladder "
          f"{ld['prior']} -> {ld['widened']} -> {ld['restored']} under "
          f"burn {ld['burn']}, one capture with B1 "
          f"{ld['capture']['B1_kernels']} / B2 "
          f"{ld['capture']['B2_kernels']} kernels, no sort; dry run "
          f"would {o['dry_run']['would']}, the fleet byte-identical; "
          f"launches {o['launches']}", flush=True)


# ---------------------------------------------------------------------------
# phase 14: the example engines, e2 and the console verbs
# ---------------------------------------------------------------------------

EX_ENGINE = "smoke-ml-filter"
EX_FACTORY = "predictionio_tpu.examples.movielens:filtering_engine"
#: (a) the queries of the filtering deploy: users, num, the users whose
#: top 3 the first disabled file holds and whose 4th-6th the second does
EX_USERS, EX_NUM, EX_DISABLE_FROM = 64, 10, 16
EX_CLIENTS = 16
EX_PROFILED = 8
#: (b) the shop app's trains and the sliding eval: 10 iterations each,
#: the first window's cut at 70% of the rate / buy span, the rest split
EX_ITERS = 10
EX_WINDOWS, EX_FIRST_CUT = 3, 0.7
EX_SHOP_QUERIES = 8
#: (c) the host-side examples' sizes on the card, each run again on the
#: CPU: a day-keyed CSV, SGD points, the SimRank graph, DIMSUM's CPU
#: slice of the shop catalog, the Markov tally, the stock frame
EX_HELLO_ROWS, EX_HELLO_DAYS = 20_000, 365
EX_SGD_ROWS, EX_SGD_ITERS = 20_000, 400
EX_SIMRANK_USERS, EX_SIMRANK_EDGES, EX_SIMRANK_ITERS = 2_000, 20_000, 5
EX_DIMSUM_CPU_ITEMS = 2_000
EX_MARKOV_STATES, EX_MARKOV_TALLY, EX_MARKOV_TOP = 2_000, 200_000, 10
EX_STOCK_TICKERS, EX_STOCK_DAYS = 50, 300
#: (c) the stated tolerances of the card against the CPU
EX_TOL = {"helloworld": (1e-6, 0.0), "regression": (1e-4, 1e-5),
          "simrank": (0.0, 1e-6), "dimsum": (0.0, 1e-6),
          "markov": (1e-6, 1e-7), "stock": (1e-3, 1e-5)}
EX_EVAL_MODULE = '''"""Walk-forward windows over the shop app, one variant."""
import datetime as dt

from predictionio_tpu_torch.controller import (
    EngineParams, EngineParamsGenerator, Evaluation,
)
from predictionio_tpu_torch.examples import movielens
from predictionio_tpu_torch.models.recommendation.als_algorithm import (
    ALSAlgorithmParams,
)
from predictionio_tpu_torch.models.recommendation.evaluation import (
    PositiveCount, PrecisionAtK,
)


class SlidingEvaluation(Evaluation):
    def __init__(self):
        self.engine = movielens.sliding_eval_engine()
        self.metrics = (PrecisionAtK(k=10, ratingThreshold=2.0),
                        PositiveCount(ratingThreshold=2.0))
        super().__init__()


class SlidingGrid(EngineParamsGenerator):
    def __init__(self):
        self.engine_params_list = [EngineParams(
            data_source_params=movielens.SlidingEvalDataSourceParams(
                appName={app!r},
                firstTrainingUntilTime=dt.datetime.fromtimestamp(
                    {first_s!r}, tz=dt.timezone.utc),
                evalDurationSeconds={duration_s!r}, evalCount={windows},
                queryNum=10),
            algorithm_params_list=(("als", ALSAlgorithmParams(
                rank={rank}, numIterations={iters}, lambda_=0.01,
                seed={seed})),))]
'''
EX_RUN_MODULE = '''"""A callable that `pio run` resolves in an engine dir."""


def main(*args):
    print("smoke-run", *args)
    return len(args)
'''


class _CheckedA:
    """Every kernel A launch while the block runs, held against the plain
    solve on the same inputs, bit for bit (the comparison's plain calls
    are not launches)."""

    def __init__(self):
        self.calls = 0
        self.mismatch = 0
        self.max_abs_err = 0.0

    def wrap(self):
        def make(orig):
            def run(A, b, reg):
                x = orig(A, b, reg)
                p = solve.solve_gj_plain(A, b, reg)
                self.calls += 1
                self.mismatch += 0 if bool(_bitwise_same(x, p).all()) else 1
                if x.numel():
                    self.max_abs_err = max(self.max_abs_err,
                                           float((x - p).abs().max()))
                return x
            return run
        return _wrapped((solve, "_launch", make))

    def require(self, launches: int, want: int, where: str) -> dict:
        if launches != want or self.calls != want or self.mismatch:
            raise AssertionError(
                f"{where}: kernel A launched {launches} times ({self.calls} "
                f"checked, want {want}), {self.mismatch} differ from plain")
        return {"A_launches": launches, "A_equal_plain": self.calls,
                "A_max_abs_err": self.max_abs_err}


def phase_examples(work: str, seed: int, dev: torch.device) -> dict:
    """Phase 14: (a) the MovieLens filtering engine at full width on the
    store phase's 20M eventlog app, (b) the shop app's example trains and
    the sliding eval, (c) the host-side examples on the card against the
    CPU, (d) the console verbs."""
    t_phase = time.perf_counter()
    out = {"card": _smi()}
    names = (*_eventlog_env(work), "PIO_TRAIN_STREAM")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.pop("PIO_TRAIN_STREAM", None)
    os.environ.update(_eventlog_env(work))
    storage_mod.reset_storage()
    try:
        t0 = time.perf_counter()
        out["filtering"] = _examples_filtering(work, seed, dev)
        out["filtering"]["step_s"] = time.perf_counter() - t0
    finally:
        storage_mod.get_storage().get_events().close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
    t0 = time.perf_counter()
    out["shop"] = _examples_shop(work, seed, dev)
    out["shop"]["step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["host"] = _examples_host(work, seed, dev, out["shop"].pop("td"))
    out["host"]["step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["verbs"] = _examples_verbs(work)
    out["verbs"]["step_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    _print_examples(out)
    print("examples: " + json.dumps(out), flush=True)
    return out


def _filtered(answer: dict, disabled) -> dict:
    return {"itemScores": [s for s in answer["itemScores"]
                           if s["item"] not in disabled]}


def _examples_filtering(work: str, seed: int, dev) -> dict:
    """(a) ``pio build``, ``pio train`` (kernel A 20 times, each == plain)
    and a quantized ``pio deploy`` of the filtering engine on the 20M
    app, its disabled file rewritten while it serves."""
    store = storage_mod.get_storage()
    engine_dir = os.path.join(work, "examples_filtering")
    os.makedirs(engine_dir)
    disabled_path = os.path.join(engine_dir, "disabled.txt")
    with open(disabled_path, "w"):
        pass
    with open(ENGINE_JSON) as f:
        variant = json.load(f)
    variant.update(id=EX_ENGINE, engineFactory=EX_FACTORY)
    variant["datasource"]["params"]["appName"] = STORE_APP
    variant["algorithms"][0]["params"]["numIterations"] = EX_ITERS
    variant["serving"] = {"params": {"filepath": disabled_path}}
    with open(os.path.join(engine_dir, "engine.json"), "w") as f:
        json.dump(variant, f)
    out = {}
    if cli.main(["build", "--engine-dir", engine_dir]) != 0:
        raise AssertionError("pio build of the filtering engine failed")
    checked = _CheckedA()
    solve.reset_launches()               # the filtering train starts here
    t0 = time.perf_counter()
    with checked.wrap():
        rc = cli.main(["train", "--engine-dir", engine_dir])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    launches = solve.launches            # ... and ends here
    if rc != 0:
        raise AssertionError(f"pio train of the filtering engine exited {rc}")
    out["train"] = checked.require(launches, 2 * EX_ITERS, "filtering train")
    row = store.get_meta_data_engine_instances().get_latest_completed(
        EX_ENGINE, "NOT_USED", EX_ENGINE)
    out["train"]["phases_s"] = {k[len("phase_"):-len("_s")]: float(v)
                                for k, v in row.runtime_conf.items()
                                if k.startswith("phase_")}
    out["deploy"] = _examples_deploy(engine_dir, row.id, disabled_path,
                                     seed)
    return out


def _examples_deploy(engine_dir: str, iid: str, disabled_path: str,
                     seed: int) -> dict:
    """``pio deploy --serve-quant on`` in a thread; 64 sequential and 64
    concurrent queries against the first disabled file, then the file
    rewritten and 64 more: every answer the plain int8 path's top-num on
    the live layout less the disabled items, B1 = B2 = flushes, no sort
    kernel in a profile of 8 queries; ``pio undeploy``."""
    apis = []

    class Recorded(create_server.QueryAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apis.append(self)

    port, rcs = _free_port(), []
    with _wrapped((create_server, "QueryAPI", lambda _c: Recorded)):
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--engine-instance-id",
            iid, "--ip", "127.0.0.1", "--port", str(port),
            "--serve-quant", "on"])), daemon=True)
        deploy.start()
        try:
            ready_s = _wait_ready(port, deploy.is_alive, deadline_s=300)
            (api,) = apis
            model = api.models[0]
            vocab = model.user_vocab.inverse()
            rng = np.random.default_rng(seed + 141)
            users = [vocab(int(u)) for u in rng.choice(
                len(model.user_vocab), EX_USERS, replace=False)]
            plain = {u: _served(model, u, EX_NUM) for u in users}
            first = sorted({s["item"] for u in users[:EX_DISABLE_FROM]
                            for s in plain[u]["itemScores"][:3]})
            second = sorted({s["item"]
                             for u in users[EX_DISABLE_FROM:
                                            2 * EX_DISABLE_FROM]
                             for s in plain[u]["itemScores"][3:6]})
            with open(disabled_path, "w") as f:
                f.write("\n".join(first) + "\n")
            topk_fused.reset_launches()  # the serving path starts here
            solve.reset_launches()
            lat = {"sequential": [], "concurrent": [], "rewritten": []}
            dropped = {"first": 0, "second": 0}

            def check(results, disabled, key, name):
                for u, (status, payload, dt_s, _raw) in zip(users, results):
                    if status != 200 or payload != _filtered(plain[u],
                                                             disabled):
                        raise AssertionError(
                            f"{name}: {u} answered {status} {payload}, the "
                            "plain int8 path less the disabled items "
                            f"{_filtered(plain[u], disabled)}")
                    dropped[key] += EX_NUM - len(payload["itemScores"])
                    lat[name].append(dt_s)

            check([_post(port, u, EX_NUM) for u in users], set(first),
                  "first", "sequential")
            with ThreadPoolExecutor(max_workers=EX_CLIENTS) as pool:
                check(list(pool.map(lambda u: _post(port, u, EX_NUM),
                                    users)), set(first), "first",
                      "concurrent")
            # the file changes under the live deploy: no redeploy
            with open(disabled_path, "w") as f:
                f.write("\n".join(second) + "\n")
            check([_post(port, u, EX_NUM) for u in users], set(second),
                  "second", "rewritten")
            per, _wall = _device_profile(lambda: [
                _post(port, u, EX_NUM) for u in users[:EX_PROFILED]])
            stats = api.handle("GET", "/")[1]
        finally:
            if cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                         str(port)]) != 0:
                raise AssertionError("pio undeploy failed")
            deploy.join(timeout=60)
    launches = topk_fused.launches       # the serving path ends here
    merge_launches = topk_fused.merge_launches
    if rcs != [0] or deploy.is_alive():
        raise AssertionError(f"pio deploy exited {rcs}")
    if solve.launches:
        raise AssertionError("the filtering deploy launched solve_gj")
    flushes = stats["batching"]["batches"]
    if stats["quant"] is None or not stats["quant"].get("fused"):
        raise AssertionError(f"deploy did not take the fused path: {stats}")
    if flushes == 0 or launches != flushes or merge_launches != flushes:
        raise AssertionError(
            f"B1 launched {launches} times and B2 {merge_launches} times "
            f"for {flushes} flushes (want one each per flush)")
    _require_kernels(per, "the filtering deploy")
    if not dropped["first"] or not dropped["second"]:
        raise AssertionError(f"the disabled files removed nothing: "
                             f"{dropped}")
    return {"ready_s": ready_s, "queries": 3 * EX_USERS + EX_PROFILED,
            "flushes": flushes, "B1_launches": launches,
            "B2_launches": merge_launches, "disabled": [len(first),
                                                        len(second)],
            "removed": dropped,
            "query_ms": {k: dict(zip(("p50", "p99"), _pct(v)))
                         for k, v in lat.items()},
            "sort_kernels": _sort_kernels(per)}


def _examples_shop(work: str, seed: int, dev) -> dict:
    """(b) ``pio train`` and ``pio deploy`` of the recommendation-cat and
    similar-product-variants engines on the templates phase's shop app,
    and ``pio eval`` of the sliding-window engine over 3 windows."""
    from predictionio_tpu_torch.examples import (
        recommendation_variants as rv, similarproduct_variants as sv,
    )
    from predictionio_tpu_torch.models.similarproduct import (
        data_source as sp_ds,
    )
    from predictionio_tpu_torch.workflow import json_extractor
    store = storage_mod.get_storage()
    out = {}
    cat = {"id": "smoke-cat", "engineFactory":
           "predictionio_tpu.examples.recommendation_variants:cat_engine",
           "datasource": {"params": {"appName": TPL_APP}},
           "algorithms": [{"name": "als", "params": {
               "rank": RANK, "numIterations": EX_ITERS, "lambda_": 0.01,
               "seed": seed}}]}
    spv = {"id": "smoke-spv", "engineFactory":
           "predictionio_tpu.examples.similarproduct_variants:engine",
           "datasource": {"params": {"appName": TPL_APP}},
           "algorithms": [{"name": "als", "params": {
               "rank": RANK, "numIterations": EX_ITERS, "lambda": 0.01,
               "seed": seed}}]}
    for name, variant in (("cat", cat), ("spv", spv)):
        checked = _CheckedA()
        with checked.wrap():
            engine_dir, row, (model,), numbers = _template_train(
                work, store, f"examples_{name}", variant, 2 * EX_ITERS)
        numbers.update(checked.require(numbers["solve_gj_launches"],
                                       2 * EX_ITERS, f"{name} train"))
        if name == "cat":
            vocab = model.user_vocab.inverse()
            bodies = [{"user": vocab(i), "num": 10}
                      for i in range(0, len(model.user_vocab),
                                     len(model.user_vocab)
                                     // EX_SHOP_QUERIES)][:EX_SHOP_QUERIES]
            want = [rv.CategoryALSAlgorithm().predict(
                model, rv.CatQuery(**b)) for b in bodies]
        else:
            trained = np.flatnonzero(model.trained)
            inv = model.item_vocab.inverse()
            bodies = [{"items": [inv(int(i))], "num": 10}
                      for i in trained[:: max(1, len(trained)
                                              // EX_SHOP_QUERIES)]
                      ][:EX_SHOP_QUERIES]
            want = [sv.VALSAlgorithm().predict(model, sv.VQuery(**b))
                    for b in bodies]
        answers, _api, serve = _template_serve(engine_dir, row.id, bodies)
        want = [json.loads(json_extractor.render(w)) for w in want]
        filled = sum(1 for a in answers if a[next(iter(a))])
        if answers != want or 2 * filled < len(answers):
            raise AssertionError(f"{name}: the deploy's answers differ from "
                                 "the stored model's predict, or most are "
                                 "empty")
        out[name] = {"train": numbers, "serve": serve}
    out["sliding_eval"] = _examples_sliding(work, store, seed)
    # the similar-product read once more, for DIMSUM on the card (c)
    ctx = WorkflowContext(storage=store, device=dev)
    out["td"] = sp_ds.DataSource(sp_ds.DataSourceParams(
        appName=TPL_APP)).read_training(ctx)
    return out


def _examples_sliding(work: str, store, seed: int) -> dict:
    """``pio eval`` of the sliding-window engine: one variant at rank 10,
    windows from the shop app's rate / buy span (the first cut at 70%,
    the rest split in three), kernel A 20 times a window, each == plain."""
    col = store_mod.find_columnar(
        TPL_APP, entity_type="user", event_names=["rate", "buy"],
        target_entity_type="item", storage=store)
    lo, hi = int(col.event_time_ms.min()), int(col.event_time_ms.max())
    first_s = (lo + EX_FIRST_CUT * (hi - lo)) / 1e3
    duration_s = (hi - lo) * (1 - EX_FIRST_CUT) / EX_WINDOWS / 1e3
    engine_dir = os.path.join(work, "examples_sliding")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "smoke_sliding.py"), "w") as f:
        f.write(EX_EVAL_MODULE.format(
            app=TPL_APP, first_s=first_s, duration_s=duration_s,
            windows=EX_WINDOWS, rank=RANK, iters=EX_ITERS, seed=seed))
    best = os.path.join(engine_dir, "best.json")
    checked = _CheckedA()
    solve.reset_launches()               # the eval's path starts here
    t0 = time.perf_counter()
    with checked.wrap():
        rc = cli.main(["eval", "smoke_sliding:SlidingEvaluation",
                       "smoke_sliding:SlidingGrid", "--engine-dir",
                       engine_dir, "--output-best-engine-params", best])
    wall = time.perf_counter() - t0
    launches = solve.launches            # ... and ends here
    if rc != 0:
        raise AssertionError(f"pio eval of the sliding engine exited {rc}")
    out = checked.require(launches, 2 * EX_ITERS * EX_WINDOWS,
                          "sliding eval")
    rows = store.get_meta_data_evaluation_instances().get_all()
    row = max(rows, key=lambda r: r.start_time)
    if row.status != "EVALCOMPLETED":
        raise AssertionError(f"the sliding eval left {row.status}")
    result = json.loads(row.evaluator_results_json)
    score = result.get("bestScore", {}).get("score")
    if score is None or not 0.0 <= score <= 1.0:
        raise AssertionError(f"sliding eval score {score}")
    with open(best) as f:
        json.load(f)
    out.update(wall_s=wall, precision_at_10=score, windows=EX_WINDOWS,
               first_cut_s=first_s, window_s=duration_s)
    return out


def _cpu_ctx():
    return WorkflowContext(device="cpu")


def _close_enough(name: str, got, want) -> float:
    rtol, atol = EX_TOL[name]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: card {got.shape} vs CPU "
                             f"{want.shape}, or non-finite")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: the card differs from the CPU by "
                             f"{err} (rtol {rtol}, atol {atol})")
    return err


def _examples_host(work: str, seed: int, dev, shop_td) -> dict:
    """(c) the host-side examples once on the card and once on the CPU,
    each within its stated tolerance (EX_TOL); no kernel A or B."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.e2 import MarkovChain
    from predictionio_tpu_torch.examples import (
        dimsum, friend_recommendation as fr, helloworld as hw,
        regression as rg, stock,
    )
    rng = np.random.default_rng(seed + 142)
    d = os.path.join(work, "examples_host")
    os.makedirs(d)
    out = {}
    ctx_card = WorkflowContext(device=dev)
    solve.reset_launches()
    topk_fused.reset_launches()

    def both(name, fn):
        t0 = time.perf_counter()
        card = fn(ctx_card)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        cpu = fn(_cpu_ctx())
        return card, cpu, t_card

    # helloworld
    path = os.path.join(d, "temps.csv")
    days = rng.integers(0, EX_HELLO_DAYS, EX_HELLO_ROWS)
    with open(path, "w") as f:
        f.writelines(f"day{k},{t:.2f}\n" for k, t in zip(
            days.tolist(), rng.normal(60, 15, EX_HELLO_ROWS).tolist()))
    ep = EngineParams(data_source_params=hw.HelloWorldDataSourceParams(path),
                      algorithm_params_list=(("", None),))
    card, cpu, t = both("helloworld",
                        lambda c: hw.engine().train(c, ep)[0])
    out["helloworld"] = {"days": len(card), "card_s": t,
                         "max_abs_err": _close_enough(
                             "helloworld", [card[k] for k in sorted(card)],
                             [cpu[k] for k in sorted(card)])}
    # regression's SGD
    path = os.path.join(d, "lr.txt")
    x = rng.normal(0, 1, (EX_SGD_ROWS, 3))
    np.savetxt(path, np.column_stack(
        [x @ np.array([2.0, -1.0, 0.5]) + 0.25, x]), fmt="%.6f")
    ep = EngineParams(
        data_source_params=rg.RegressionDataSourceParams(path),
        algorithm_params_list=(("SGD", rg.SGDAlgorithmParams(
            numIterations=EX_SGD_ITERS, stepSize=0.5)),))
    card, cpu, t = both("regression",
                        lambda c: rg.engine().train(c, ep)[0])
    out["regression"] = {"rows": EX_SGD_ROWS, "card_s": t, "weights":
                         card.tolist(), "max_abs_err": _close_enough(
                             "regression", card, cpu)}
    # SimRank on a 2,000-user graph
    n = EX_SIMRANK_USERS
    for stem, text in (
            ("item", "1 1 1;2\n"),
            ("user", "".join(f"{u} 1:1.0\n" for u in range(n))),
            ("action", "".join(f"{a} {b} 1 0 0\n" for a, b in zip(
                rng.integers(0, n, EX_SIMRANK_EDGES).tolist(),
                rng.integers(0, n, EX_SIMRANK_EDGES).tolist())))):
        with open(os.path.join(d, f"{stem}.txt"), "w") as f:
            f.write(text)
    ep = EngineParams(
        data_source_params=fr.FriendRecommendationDataSourceParams(
            itemFilePath=os.path.join(d, "item.txt"),
            userKeywordFilePath=os.path.join(d, "user.txt"),
            userActionFilePath=os.path.join(d, "action.txt")),
        algorithm_params_list=(("", fr.SimRankAlgorithmParams(
            numIterations=EX_SIMRANK_ITERS, decay=0.8)),))
    card, cpu, t = both("simrank",
                        lambda c: fr.simrank_engine().train(c, ep)[0])
    out["simrank"] = {"users": n, "edges": EX_SIMRANK_EDGES, "card_s": t,
                      "max_abs_err": _close_enough("simrank", card.scores,
                                                   cpu.scores)}
    # DIMSUM: the whole shop catalog on the card; a slice of it on both
    algo = dimsum.DIMSUMAlgorithm(dimsum.DIMSUMAlgorithmParams())
    t0 = time.perf_counter()
    full = algo.train(ctx_card, shop_td)
    t_full = time.perf_counter() - t0
    keep = set(sorted(shop_td.items)[:EX_DIMSUM_CPU_ITEMS])
    part = dataclasses.replace(
        shop_td, items={k: v for k, v in shop_td.items.items() if k in keep},
        view_events=[v for v in shop_td.view_events if v.item in keep])
    card, cpu, t = both("dimsum", lambda c: algo.train(c, part))
    inv = card.item_vocab.inverse()
    sub = [full.item_vocab(inv(k)) for k in range(len(card.item_vocab))]
    if not np.array_equal(full.similarities[np.ix_(sub, sub)],
                          card.similarities):
        raise AssertionError("dimsum: the catalog's slice differs from the "
                             "slice's own Gram")
    out["dimsum"] = {"items": len(full.item_vocab), "card_s": t_full,
                     "cpu_items": len(keep), "max_abs_err": _close_enough(
                         "dimsum", card.similarities, cpu.similarities)}
    del full
    # e2's Markov chain
    rows = rng.integers(0, EX_MARKOV_STATES, EX_MARKOV_TALLY)
    cols = rng.integers(0, EX_MARKOV_STATES, EX_MARKOV_TALLY)
    counts = rng.integers(1, 4, EX_MARKOV_TALLY).astype(np.float64)
    card, cpu, t = both("markov", lambda c: MarkovChain.train(
        rows, cols, counts, EX_MARKOV_STATES, EX_MARKOV_TOP,
        device=c.device))
    tc, tp = card.transition.cpu().numpy(), cpu.transition.numpy()
    if not np.array_equal(tc > 0, tp > 0):
        raise AssertionError("markov: the kept entries differ card vs CPU")
    state = rng.random(EX_MARKOV_STATES)
    out["markov"] = {"states": EX_MARKOV_STATES, "card_s": t,
                     "kept": int((tc > 0).sum()),
                     "max_abs_err": _close_enough("markov", tc, tp),
                     "predict_max_abs_err": _close_enough(
                         "markov", card.predict(state), cpu.predict(state))}
    # stock: one ticker delisted early, one constant (rank-deficient)
    path = os.path.join(d, "prices.csv")
    px = 100 * np.exp(np.cumsum(rng.normal(0.0005, 0.015, (
        EX_STOCK_DAYS, EX_STOCK_TICKERS)), axis=0))
    px[20:, 0] = np.nan
    px[:, 1] = 42.0
    with open(path, "w") as f:
        f.write("date," + ",".join(f"T{k}" for k in range(
            EX_STOCK_TICKERS)) + "\n")
        f.writelines(f"d{day}," + ",".join(f"{v:.4f}" for v in row) + "\n"
                     for day, row in enumerate(px))
    data = stock.StockDataSource(stock.StockDataSourceParams(
        filepath=path, trainUntilIdx=EX_STOCK_DAYS - 20)).read_training(None)
    card, cpu, t = both("stock", lambda c: stock.RegressionStrategyAlgorithm(
        ).train(c, data))
    if card.active_ticker[0] or not card.active_ticker[1]:
        raise AssertionError("stock: the delisted ticker counts as active "
                             "or the constant one as inactive")
    out["stock"] = {"tickers": EX_STOCK_TICKERS, "card_s": t,
                    "rank_deficient_coef": card.coef[:2].tolist(),
                    "max_abs_err": _close_enough("stock", card.coef,
                                                 cpu.coef)}
    if solve.launches or topk_fused.launches or topk_fused.merge_launches:
        raise AssertionError("a host-side example launched kernel A or B")
    return out


def _examples_verbs(work: str) -> dict:
    """(d) ``pio template``, ``pio run`` of a callable in an engine
    directory, ``pio unregister`` and ``pio upgrade`` (exit 1), and ``pio
    shell`` on a piped stdin naming the card."""
    d = os.path.join(work, "examples_verbs")
    os.makedirs(d)
    with open(os.path.join(d, "smoke_run.py"), "w") as f:
        f.write(EX_RUN_MODULE)
    out = {}
    for argv, want in ((["template"], 0), (["unregister"], 1),
                       (["upgrade"], 1),
                       (["run", "smoke_run:main", "a", "b", "c",
                         "--engine-dir", d], 3)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv)
        if rc != want:
            raise AssertionError(f"pio {argv[0]} exited {rc}, want {want}")
        out[argv[0]] = rc
    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("print(torch.cuda.get_device_name(0))\n")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["shell"])
    finally:
        sys.stdin = stdin
    if rc != 0 or buf.getvalue().strip() != torch.cuda.get_device_name(0):
        raise AssertionError(f"pio shell exited {rc} printing "
                             f"{buf.getvalue()!r}")
    out["shell"] = buf.getvalue().strip()
    return out


def _print_examples(o: dict) -> None:
    fl, tr, dep = o["filtering"], o["filtering"]["train"], \
        o["filtering"]["deploy"]
    print(f"examples: (a) movielens:filtering_engine on {STORE_APP}: pio "
          f"build ok; pio train {fl['train_s']:.2f} s, kernel A "
          f"{tr['A_launches']} launches, each == plain; pio deploy ready "
          f"in {dep['ready_s']:.3f} s, {dep['queries']} queries in "
          f"{dep['flushes']} flushes, B1 {dep['B1_launches']} B2 "
          f"{dep['B2_launches']}, no sort kernel; disabled {dep['disabled']}"
          f" items, removed {dep['removed']}; the rewritten file followed "
          f"with no redeploy; query ms {dep['query_ms']}", flush=True)
    for name in ("cat", "spv"):
        s = o["shop"][name]
        print(f"examples: (b) {name}: pio train {s['train']['wall_s']:.2f} s"
              f", kernel A {s['train']['A_launches']} each == plain; pio "
              f"deploy {s['serve']['ready_s']:.3f} s, "
              f"{s['serve']['query_ms']}", flush=True)
    se = o["shop"]["sliding_eval"]
    print(f"examples: (b) sliding eval: {se['windows']} windows, kernel A "
          f"{se['A_launches']} each == plain, Precision@10 "
          f"{se['precision_at_10']:.4f}, {se['wall_s']:.2f} s", flush=True)
    print("examples: (c) card vs CPU: " + "; ".join(
        f"{k} {v['max_abs_err']:.3g} (tol {EX_TOL[k]})"
        for k, v in o["host"].items() if isinstance(v, dict)), flush=True)
    print(f"examples: (d) verbs {o['verbs']}; phase 14 "
          f"{o['phase_s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 12: block-sharded training and row-sharded serving
# ---------------------------------------------------------------------------

#: the library train's shard slots on the card, and the serving meshes
SHARD_SLOTS = 4
SHARD_SERVE_SLOTS = (1, 2, 4)
SHARD_SERVE_B = (1, 64)
#: unseen users the sharded deploy folds in (20 ratings each)
SHARD_FOLD_USERS = 8
#: a sharded train against the single-device one: fp32 Gram sums cut at
#: other chunk boundaries drift apart over 10 iterations as much as a
#: single-device train at another chunk does (a CPU train of 1M ratings:
#: 0.0016 and 0.0013 max abs), so the yardstick is that drift, measured
#: in the run: the sharded factors within twice it of one device's, and
#: the training RMSE within SHARD_RMSE_RTOL
SHARD_DRIFT_X = 2.0
SHARD_RMSE_RTOL = 1e-5
#: the golden-train tolerance, reported beside (the share of entries
#: outside it)
SHARD_RTOL, SHARD_ATOL = 2e-3, 2e-4


def phase_shard(work: str, seed: int, dev: torch.device) -> dict:
    """Phase 12 on the store phase's eventlog app (ML-20M's 138,493 x
    26,744 and the fold-in step's events), rank 10, 10 iterations."""
    env = _eventlog_env(work)
    names = (*env, "PIO_TRAIN_STREAM", "PIO_FOLDIN_CURSOR_DIR",
             "PIO_TELEMETRY", "PIO_SERVE_SHARD")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.pop("PIO_SERVE_SHARD", None)
    os.environ.update(env)
    storage_mod.reset_storage()
    t_phase = time.perf_counter()
    try:
        out = _phase_shard(work, seed, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
    out["phase_s"] = time.perf_counter() - t_phase
    print("shard: " + json.dumps(out), flush=True)
    return out


def _engine_params():
    with open(ENGINE_JSON) as f:
        p = json.load(f)["algorithms"][0]["params"]
    return p["rank"], p["numIterations"], p["lambda"], p["seed"]


def _close(a: torch.Tensor, b: torch.Tensor, drift: float) -> dict:
    """``a`` against ``b``: the largest difference, within SHARD_DRIFT_X
    times ``drift`` (the largest difference a reordering of the same sums
    gives), and the share of entries outside the golden-train
    tolerance."""
    diff = (a - b).abs()
    return {"max_abs_diff": float(diff.max()), "drift": drift,
            "within": float(diff.max()) <= max(SHARD_DRIFT_X * drift, 1e-6),
            "outside_golden_tol": float(
                (diff > SHARD_ATOL + SHARD_RTOL * b.abs()).float().mean())}


def _rmse(U, V, td) -> float:
    n = td.n
    return float(als.rmse(U, V, td.user_idx, td.item_idx, td.rating,
                          np.ones(n, np.float32)))


def _phase_shard(work: str, seed: int, dev: torch.device) -> dict:
    from predictionio_tpu_torch.parallel import als_dist, serve_dist
    from predictionio_tpu_torch.parallel import mesh as mesh_mod

    store = storage_mod.get_storage()
    rank, iters, lam, train_seed = _engine_params()
    out = {"card": _smi(), "slots": SHARD_SLOTS}

    # 1. the library: explicit ALS over 4 slots of the card
    os.environ["PIO_TRAIN_STREAM"] = "off"
    t0 = time.perf_counter()
    td = DataSource(DataSourceParams(appName=STORE_APP)).read_training(
        WorkflowContext(storage=store, device=dev))
    read_s = time.perf_counter() - t0
    n_u, n_i = len(td.user_vocab), len(td.item_vocab)
    t0 = time.perf_counter()
    # the layout sorted on the card: the deal reads it back to the host
    data = als.prepare_ratings(td.user_idx, td.item_idx, td.rating, n_u, n_i,
                               on_device=True, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    mesh = mesh_mod.Mesh([dev] * SHARD_SLOTS)
    checked, dealt = [], []

    def against_plain(orig):
        def f(A, b, reg):
            x = orig(A, b, reg)
            p = solve.solve_gj_plain(A, b, reg)
            checked.append((int(A.shape[0]), bool(_bitwise_same(x, p).all()),
                            float((x - p).abs().max())))
            return x
        return f

    def timed_deal(orig):
        def f(*a, **kw):
            t = time.perf_counter()
            su, si = orig(*a, **kw)
            dealt.append((time.perf_counter() - t, su.nnz_per_dev.tolist(),
                          si.nnz_per_dev.tolist(), su.rows_dev, si.rows_dev))
            return su, si
        return f

    kw = dict(rank=rank, iterations=iters, lambda_=lam, seed=train_seed)
    solve.reset_launches()                 # the library train starts here
    with _wrapped((als, "solve_factors", against_plain)):
        U4, V4 = als_dist.train_explicit_sharded(mesh, data, **kw)
    torch.cuda.synchronize()
    a_launches = solve.launches            # and ends here
    if a_launches != SHARD_SLOTS * 2 * iters or len(checked) != a_launches:
        raise AssertionError(f"kernel A launched {a_launches} times over "
                             f"{SHARD_SLOTS} slots x {iters} iterations")
    if not all(same for _n, same, _e in checked):
        raise AssertionError(f"a slot's kernel A != plain: {checked}")
    t0 = time.perf_counter()
    with _wrapped((als_dist, "prepare_sharded", timed_deal)):
        U4b, V4b = als_dist.train_explicit_sharded(mesh, data, **kw)
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t0
    if not (torch.equal(U4, U4b) and torch.equal(V4, V4b)):
        raise AssertionError("two sharded trains from one seed differ")
    del U4b, V4b
    # one device at its own chunk, and at the sharded trainer's: the
    # drift that reordering the same sums gives
    t0 = time.perf_counter()
    U1, V1 = als.train_explicit(data, **kw, device=dev)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    U1c, V1c = als.train_explicit(data, **kw, chunk=1 << 16, device=dev)
    drift = {"users": float((U1c - U1).abs().max()),
             "items": float((V1c - V1).abs().max())}
    del U1c, V1c
    vs_single = {"users": _close(U4, U1, drift["users"]),
                 "items": _close(V4, V1, drift["items"])}
    rmse4, rmse1 = _rmse(U4, V4, td), _rmse(U1, V1, td)
    vs_single["rmse"] = {"slots": rmse4, "one_device": rmse1}
    if not (vs_single["users"]["within"] and vs_single["items"]["within"]
            and abs(rmse4 - rmse1) <= SHARD_RMSE_RTOL * rmse1):
        raise AssertionError(f"4-slot factors vs one device: {vs_single}")
    deal_s, nnz_u, nnz_i, rows_u, rows_i = dealt[0]
    out["library"] = {
        "ratings": int(data.nnz), "users": n_u, "items": n_i,
        "read_s": read_s, "layout_s": layout_s, "deal_s": deal_s,
        "train_s": lib_s, "single_device_train_s": single_s,
        "A_launches": a_launches,
        "A_shapes": sorted({n for n, _s, _e in checked}),
        "A_max_abs_err": max(e for _n, _s, e in checked),
        "rows_per_slot": {"users": rows_u, "items": rows_i},
        "nnz_per_slot": {"users": nnz_u, "items": nnz_i},
        "rerun_bit_identical": True, "vs_single_device": vs_single}
    print(f"shard: library train over {SHARD_SLOTS} slots of the card: "
          f"{data.nnz} ratings, {n_u} x {n_i}; read {read_s:.3f} s, "
          f"layout {layout_s:.3f} s, the LPT deal {deal_s:.3f} s, "
          f"train (deal included) {lib_s:.3f} s against one device's "
          f"{single_s:.3f} s; kernel A {a_launches} launches at n = "
          f"{out['library']['A_shapes']}, each == plain; rerun "
          f"bit-identical; vs one device {vs_single} ({_smi()})",
          flush=True)

    # 2. sharded serve at 1, 2 and 4 slots against the replicated B1 + B2
    # and the plain int8 path, bit for bit
    qf = quant.QuantizedFactors.from_factors(U4.cpu().numpy(),
                                             V4.cpu().numpy())
    del U1, V1
    rep = quant.QuantizedServing.build(qf, device=dev)
    rng = np.random.default_rng(seed + 41)
    serve_rows = []
    for n in SHARD_SERVE_SLOTS:
        sf = serve_dist.shard_factors(
            None, None, mesh=mesh_mod.Mesh([dev] * n, axis_name="shard"),
            quant=qf)
        for b in SHARD_SERVE_B:
            ixs = rng.integers(0, n_u, size=b).astype(np.int32)
            ixs_dev = torch.from_numpy(ixs).to(dev)
            for k in (10, 100, n_i):
                topk_fused.reset_launches()
                sv, si = sf.topk(ixs, k)
                torch.cuda.synchronize()
                b1, b2 = topk_fused.launches, topk_fused.merge_launches
                rv, ri = rep.topk(ixs, k)
                pv, pi = quant.topk_for_users_quant(
                    rep.u_q, rep.u_scale, rep.vt_q, rep.v_scale, ixs_dev,
                    k=k, n_items=n_i)
                if (b1, b2) != (n, 1):
                    raise AssertionError(f"{n} slot(s): B1 {b1} / B2 {b2} "
                                         "launches in one call")
                for v, i, what in ((rv, ri, "replicated B1 + B2"),
                                   (pv, pi, "the plain int8 path")):
                    if not (bool(_bitwise_same(sv, v).all())
                            and torch.equal(si, i)):
                        raise AssertionError(
                            f"{n} slot(s), b = {b}, k = {k}: the sharded "
                            f"answer != {what}")
            row = {"slots": n, "b": b, "ks": [10, 100, n_i],
                   "B1_per_call": n, "B2_per_call": 1,
                   "ms": _time_ms(lambda: sf.topk(ixs, 10), reps=100),
                   "replicated_ms": _time_ms(lambda: rep.topk(ixs, 10),
                                             reps=100)}
            serve_rows.append(row)
            print(f"shard: serve at {n} slot(s) of {sf.rows_dev_i} items, "
                  f"b = {b}: answers == replicated B1 + B2 == plain at k "
                  f"[10, 100, {n_i}]; B1 {n} + B2 1 launches a call; call "
                  f"{row['ms']:.4f} ms (replicated {row['replicated_ms']:.4f}"
                  f" ms, k = 10) ({_smi()})", flush=True)
        del sf
    out["serve"] = serve_rows
    del rep, qf, U4, V4, data, td
    serve_dist.record_state(None)
    torch.cuda.empty_cache()

    # 3. the CLI: a one-process NCCL job, then --devices -1 streamed and
    # in-core
    engine_dir = _engine_dir(work, "shard_engine", STORE_APP)
    coordinator = f"127.0.0.1:{_free_port()}"
    cli_trains, models = {}, {}
    for name, extra, mode in (
            ("coordinator", ["--coordinator", coordinator,
                             "--num-processes", "1", "--process-id", "0"],
             "off"),
            ("devices_streamed", ["--devices", "-1"], "on"),
            ("devices_in_core", ["--devices", "-1"], "off")):
        als_algorithm._BIG_LAYOUT_CACHE.clear()    # each builds its layout
        os.environ["PIO_TRAIN_STREAM"] = mode
        instances = store.get_meta_data_engine_instances()
        before = {r.id for r in instances.get_all()}
        solve.reset_launches()                     # this train starts here
        t0 = time.perf_counter()
        rc = cli.main(["train", "--engine-dir", engine_dir, *extra])
        wall = time.perf_counter() - t0
        launches = solve.launches                  # and ends here
        backend = None
        if name == "coordinator":
            backend = torch.distributed.get_backend()
            torch.distributed.destroy_process_group()
            mesh_mod.init_distributed._done = None
        if rc != 0 or launches != 2 * iters:
            raise AssertionError(f"pio train ({name}) exited {rc} with "
                                 f"{launches} kernel A launches")
        (row,) = [r for r in instances.get_all() if r.id not in before]
        (models[name],) = model_io.deserialize_models(
            store.get_model_data_models().get(row.id).models)
        cli_trains[name] = {
            "instance": row.id, "wall_s": wall, "A_launches": launches,
            "backend": backend, "stream": mode,
            "phases_s": {k[len("phase_"):-len("_s")]: float(v)
                         for k, v in row.runtime_conf.items()
                         if k.startswith("phase_")}}
    if cli_trains["coordinator"]["backend"] != (
            "nccl" if dev.type == "cuda" else "gloo"):
        raise AssertionError(f"the coordinator train ran on "
                             f"{cli_trains['coordinator']['backend']}")
    if not _same_factors(models["coordinator"], models["devices_in_core"]):
        raise AssertionError("the NCCL job's model != the one-slot mesh's")
    stream_vs = {
        side: _close(torch.from_numpy(getattr(models["devices_streamed"],
                                              side)),
                     torch.from_numpy(getattr(models["devices_in_core"],
                                              side)), drift[key])
        for side, key in (("user_factors", "users"),
                          ("item_factors", "items"))}
    if not all(v["within"] for v in stream_vs.values()):
        raise AssertionError(f"streamed vs in-core one-slot trains: "
                             f"{stream_vs}")
    out["cli"] = {"trains": cli_trains, "streamed_vs_in_core": stream_vs}
    for name, t in cli_trains.items():
        print(f"shard: pio train {name} (PIO_TRAIN_STREAM={t['stream']}"
              f"{', ' + t['backend'] if t['backend'] else ''}): wall "
              f"{t['wall_s']:.3f} s; phases " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in t["phases_s"].items())
              + f"; kernel A {t['A_launches']} launches", flush=True)
    print(f"shard: the NCCL job's model == the one-slot in-core model bit "
          f"for bit; streamed vs in-core {stream_vs}", flush=True)

    # 4. pio deploy --shard-serving on --foldin on under a query stream
    out["deploy"] = _shard_deploy(work, store, engine_dir,
                                  cli_trains["coordinator"]["instance"],
                                  models["coordinator"], seed)
    store.get_events().close()     # the folded users' events into chunks
    return out


def _served_sharded(model, user: str, k: int):
    """The answer the server gives ``user`` at ``num`` k, from the plain
    int8 path on the live sharded layout (its slots' item blocks side by
    side; hits past the item vocab dropped)."""
    sf = model.sharding
    k = min(k, len(model.item_vocab))
    vt = torch.cat([sf.item_shards[d][:, :sf.items_real(d)]
                    for d in range(sf.n_shards)], dim=1).contiguous()
    sv = torch.cat([sf.item_scales[d][:sf.items_real(d)]
                    for d in range(sf.n_shards)])
    vals, idx = quant.topk_for_users_quant(
        sf.user_rows, sf.user_scales, vt, sv,
        torch.tensor([model.user_vocab(user)], dtype=torch.int32,
                     device=sf.device), k=k, n_items=sf.n_items)
    inv = model.item_vocab.inverse()
    n_real = len(model.item_vocab)
    return {"itemScores": [{"item": inv(int(i)), "score": float(v)}
                           for v, i in zip(vals[0].cpu().numpy(),
                                           idx[0].cpu().numpy())
                           if int(i) < n_real]}


def _shard_deploy(work: str, store, engine_dir: str, iid: str, model,
                  seed: int) -> dict:
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service
    from predictionio_tpu_torch.tools import doctor

    apis = []

    class Recorded(create_server.QueryAPI):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            apis.append(self)

    os.environ["PIO_FOLDIN_CURSOR_DIR"] = os.path.join(work, "cur_shard")
    users = list(model.user_vocab.to_dict())
    items = list(model.item_vocab.to_dict())
    rng = np.random.default_rng(seed + 43)
    new_users = [f"shard_u{j}" for j in range(SHARD_FOLD_USERS)]
    events = [_rate(u, items[i], float(rng.integers(1, 11)) / 2)
              for u in new_users
              for i in rng.choice(len(items), size=FOLD_RATINGS,
                                  replace=False)]
    port, rcs = _free_port(), []
    with _wrapped((create_server, "QueryAPI", lambda _c: Recorded)):
        deploy = threading.Thread(target=lambda: rcs.append(cli.main([
            "deploy", "--engine-dir", engine_dir, "--engine-instance-id",
            iid, "--ip", "127.0.0.1", "--port", str(port), "--serve-quant",
            "on", "--shard-serving", "on", "--foldin", "on",
            "--foldin-tick-ms", "100", "--telemetry"])), daemon=True)
        t0 = time.perf_counter()
        deploy.start()
        ready_s = _wait_ready(port, deploy.is_alive, deadline_s=300)
        (api,) = apis
        m = api.models[0]
        if m.sharding is None or m.sharding.dtype != "int8" \
                or api._foldin_worker is None:
            raise AssertionError("the deploy is not sharded int8 with "
                                 "fold-in")
        topk_fused.reset_launches()          # the serving path starts here,
        solve.reset_launches()               # after the warm-up
        es, es_port = http_mod.serve_background(
            service.EventAPI(storage=store), "127.0.0.1", 0)
        stream = _Stream(port, users, seed + 44)
        try:
            stream.wait_for(50)
            _post_events(es_port, events)
            fold_s = _wait_worker(
                api, lambda st: st["usersFolded"] >= SHARD_FOLD_USERS
                and st["cursorLag"] == 0 and not st["usersPending"],
                "the sharded folds")
            stream.wait_for(len(stream.answers) + 50)
        finally:
            stream_out = stream.close()
            es.shutdown()
            es.server_close()
        b1, b2 = topk_fused.launches, topk_fused.merge_launches
        a_folds = solve.launches
        stats = api.handle("GET", "/")[1]   # the serving path ends here
        flushes = stats["batching"]["batches"]
        if stream_out["dropped"]:
            raise AssertionError(f"the sharded deploy dropped queries: "
                                 f"{stream_out}")
        if flushes == 0 or b1 != flushes or b2 != flushes:
            raise AssertionError(f"B1 {b1} / B2 {b2} launches for "
                                 f"{flushes} flushes")
        m = api.models[0]
        worker = api._foldin_worker
        c = _Client(port)
        try:
            for u in new_users:
                ix = m.user_vocab(u)
                q, s = quant.quantize_rows(worker._user_factors[ix][None])
                sf = m.sharding
                if (sf.user_rows[ix].cpu().numpy().tobytes() != q[0].tobytes()
                        or sf.user_scales[ix].item() != float(s[0])):
                    raise AssertionError(f"{u}: the sharded int8 row != "
                                         "quantize_rows of the folded row")
                status, payload, _t = c.call("POST", "/queries.json",
                                             {"user": u, "num": 10})
                if status != 200 or not payload["itemScores"] \
                        or payload != _served_sharded(m, u, 10):
                    raise AssertionError(f"{u} answered {status} {payload}")
            for u, _st, payload, _t in stream.answers[:64]:
                if payload != _served_sharded(m, u, 10):
                    raise AssertionError(f"{u} in the stream: {payload}")
            device = c.call("GET", "/debug/device.json")[1]
        finally:
            c.close()
        if (device.get("sharding") or {}).get("shards") != 1:
            raise AssertionError(f"the sharding block of /debug/device.json: "
                                 f"{device.get('sharding')}")
        rc, text = _cli_out(["doctor", f"http://127.0.0.1:{port}"])
        line = [ln for ln in text.splitlines()
                if ln.strip().startswith("sharding")]
        if len(line) != 1 or line[0].split()[1] != doctor.OK:
            raise AssertionError(f"pio doctor's sharding line: {text}")

        # POST /reload under FOLD_BURST queries on 16 clients
        gen0 = api.generation
        burst = [users[u] for u in rng.integers(0, len(users),
                                                size=FOLD_BURST)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            futures = [pool.submit(_post, port, u, 10) for u in burst]
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/reload", data=b"",
                    method="POST"), timeout=30) as r:
                reload_status = r.status
            statuses = []
            for f in futures:
                try:
                    statuses.append(f.result()[0])
                except OSError as e:
                    statuses.append(getattr(e, "code", repr(e)))
        api._reload_thread.join(timeout=120)
        reload_s = time.perf_counter() - t0
        if reload_status != 200 or api.generation != gen0 + 1 \
                or statuses != [200] * FOLD_BURST:
            raise AssertionError(
                f"POST /reload: {reload_status}, generation {gen0} -> "
                f"{api.generation}, {sum(s != 200 for s in statuses)} of "
                f"{FOLD_BURST} queries dropped")
        if api.models[0].sharding is None:
            raise AssertionError("the reload left the sharded layout")
        if cli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                     str(port)]) != 0:
            raise AssertionError("pio undeploy failed")
        deploy.join(timeout=60)
    if rcs != [0] or deploy.is_alive():
        raise AssertionError(f"pio deploy exited {rcs}")
    p50, p99 = _pct([a[3] for a in stream.answers])
    out = {"ready_s": ready_s, "stream": stream_out, "flushes": flushes,
           "B1_launches": b1, "B2_launches": b2, "A_fold_launches": a_folds,
           "folded_users": SHARD_FOLD_USERS, "fold_s": fold_s,
           "query_ms": {"p50": p50, "p99": p99},
           "sharding": device["sharding"], "doctor_sharding": line[0].strip(),
           "reload": {"s": reload_s, "burst": FOLD_BURST, "dropped": 0,
                      "generation": [gen0, api.generation]}}
    print(f"shard: pio deploy --shard-serving on --foldin on ready in "
          f"{ready_s:.3f} s; {stream_out['queries']} streamed queries, 0 "
          f"dropped, p50 {p50:.3f} ms p99 {p99:.3f} ms; B1 {b1} and B2 {b2} "
          f"launches for {flushes} flushes; {SHARD_FOLD_USERS} unseen users "
          f"folded through the sharded scatter in {fold_s:.3f} s (kernel A "
          f"{a_folds} launches); doctor: {line[0].strip()}; POST /reload "
          f"under {FOLD_BURST} queries in {reload_s:.3f} s, 0 dropped "
          f"({_smi()})", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the tooling
# ---------------------------------------------------------------------------

#: the passes ``pio lint`` runs over the port, in its report order (the
#: reference's seven)
TOOLING_PASSES = ["timing", "host-sync", "jit-purity", "lock-order",
                  "declarations", "aot-registration", "debug-surface"]
TOOLING_CLIENTS = 8
TOOLING_QUERIES = 50            # per client, under the lock monitor
TOOLING_WARM = 16               # sequential queries before the wrap
TOOLING_PROFILED = 8            # sequential queries under the profiler
TOOLING_NUMS = (1, 10, 10, 100)


def _port_py_files() -> int:
    n = 0
    for _base, dirs, files in os.walk(
            os.path.join(_REPO, "predictionio_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        n += sum(f.endswith(".py") for f in files)
    return n


def _tooling_list() -> list:
    """The pass names ``pio lint --list`` prints, in order."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["lint", "--list"])
    names = [line.split()[0] for line in buf.getvalue().splitlines()
             if line and not line[0].isspace()]
    if rc != 0 or names != TOOLING_PASSES:
        raise AssertionError(f"pio lint --list: exit {rc}, passes {names}")
    return names


def _tooling_lint() -> dict:
    """``pio lint --json`` on this tree, in a process of its own."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "lint",
         "--json"], cwd=_REPO, env=env, capture_output=True, text=True,
        timeout=600)
    lint_s = time.perf_counter() - t0
    try:
        got = json.loads(proc.stdout)
    except ValueError:
        raise AssertionError(f"pio lint --json exited {proc.returncode} "
                             f"with no JSON: {proc.stderr[-2000:]}")
    want_modules = _port_py_files() + 1          # and chip_smoke.py
    if (proc.returncode != 0 or got["exit"] != 0
            or got["modulesAnalyzed"] != want_modules
            or got["passes"] != TOOLING_PASSES
            or got["counts"]["findings"] != 0 or got["findings"]
            or got["internalErrors"]):
        raise AssertionError(
            f"pio lint --json: exit {proc.returncode}, "
            f"{got['modulesAnalyzed']} modules (want {want_modules}), "
            f"passes {got['passes']}, findings {got['findings'][:5]}, "
            f"internal errors {got['internalErrors']}")
    return {"seconds": lint_s, "modules": got["modulesAnalyzed"],
            "passes": got["passes"], "findings": 0,
            "suppressed": got["counts"]["suppressed"]}


def _wrap_serving_locks(api, monitor: LockOrderMonitor) -> list:
    """The serving stack's locks behind the monitor's proxies, in place:
    the batcher's condition, the metrics registry's lock and every
    family's and child's lock (one node per family, as the static pass
    keys a class's lock). Returns (owner, attribute, lock) for each, to
    put the real locks back."""
    reg = telemetry.REGISTRY
    owners = [(api._batcher, "_cond", "batcher._cond"),
              (reg, "_lock", "registry._lock")]
    for fam in list(reg._families.values()):
        owners.append((fam, "_lock", f"family[{fam.name}]._lock"))
        owners += [(child, "_lock", f"family[{fam.name}].child._lock")
                   for child in list(fam._children.values())]
    wrapped = []
    for owner, attr, name in owners:
        lock = getattr(owner, attr)
        setattr(owner, attr, monitor.wrap(lock, name))
        wrapped.append((owner, attr, lock))
    return wrapped


def phase_tooling(store, iid: str, users, seed: int) -> dict:
    """``pio lint`` clean on this tree, then phase 5's model deployed
    quantized with telemetry on and the serving locks behind the runtime
    lock-order monitor under concurrent clients: no inversion, B1 = B2 =
    flushes with no sort kernel, every answer the plain int8 path's."""
    t_phase = time.perf_counter()
    listed = _tooling_list()
    print(f"tooling: pio lint --list names {len(listed)} passes: "
          f"{', '.join(listed)}", flush=True)
    lint = _tooling_lint()
    print(f"tooling: pio lint --json in {lint['seconds']:.3f} s: "
          f"{lint['modules']} modules, passes {', '.join(lint['passes'])}, "
          f"0 findings, {lint['suppressed']} baselined", flush=True)

    rng = np.random.default_rng(seed + 15)
    picks = rng.integers(0, len(users), size=TOOLING_WARM
                         + TOOLING_PROFILED
                         + TOOLING_CLIENTS * TOOLING_QUERIES)
    queries = [(users[u], TOOLING_NUMS[i % len(TOOLING_NUMS)])
               for i, u in enumerate(picks)]
    warm = queries[:TOOLING_WARM]
    profiled = queries[TOOLING_WARM:TOOLING_WARM + TOOLING_PROFILED]
    load = queries[TOOLING_WARM + TOOLING_PROFILED:]
    answers = {}

    def sequential(qs):
        for u, n in qs:
            status, payload, _dt, _raw = _post(port, u, n)
            answers.setdefault((u, n), []).append((status, payload))

    def client(qs):
        return [(u, n, *_post(port, u, n)[:2]) for u, n in qs]

    monitor = LockOrderMonitor()
    wrapped = []
    telemetry.set_enabled(True)
    t0 = time.perf_counter()
    api = create_server.QueryAPI(
        create_server.ServerConfig(serve_quant="on", engine_instance_id=iid),
        storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    try:
        _wait_ready(port, server.is_alive, deadline_s=300)
        ready_s = time.perf_counter() - t0
        topk_fused.reset_launches()      # the serving path starts here
        solve.reset_launches()
        sequential(warm)                 # every family and child exists
        wrapped = _wrap_serving_locks(api, monitor)
        t_load = time.perf_counter()
        with ThreadPoolExecutor(max_workers=TOOLING_CLIENTS) as pool:
            for got in pool.map(client, [load[c::TOOLING_CLIENTS]
                                         for c in range(TOOLING_CLIENTS)]):
                for u, n, status, payload in got:
                    answers.setdefault((u, n), []).append((status, payload))
        load_s = time.perf_counter() - t_load
        per, _wall = _device_profile(lambda: sequential(profiled))
        stats = api.handle("GET", "/")[1]
    finally:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/stop", data=b"", method="POST"),
            timeout=30).close()
        server.join(timeout=60)
        for owner, attr, lock in wrapped:
            setattr(owner, attr, lock)
        telemetry.set_enabled(None)
    launches = topk_fused.launches       # the serving path ends here
    merge_launches = topk_fused.merge_launches
    if server.is_alive():
        raise AssertionError("the tooling deploy did not stop")
    if solve.launches:
        raise AssertionError("the tooling deploy launched solve_gj")
    inversions = monitor.inversions()
    edges = monitor.edges()
    if inversions:
        raise AssertionError(f"lock-order inversions under load: "
                             f"{inversions} (edges {edges})")
    if not edges:
        raise AssertionError("the monitor saw no lock nesting: the wrap "
                             "points are stale")
    flushes = stats["batching"]["batches"]
    if stats["quant"] is None or not stats["quant"].get("fused"):
        raise AssertionError(f"the tooling deploy is not fused: {stats}")
    if flushes == 0 or launches != flushes or merge_launches != flushes:
        raise AssertionError(
            f"B1 launched {launches} times and B2 {merge_launches} times "
            f"for {flushes} flushes (want one each per flush)")
    _require_kernels(per, "the tooling deploy")
    model = api.models[0]
    want_n = len(queries)
    if any(q not in answers for q in queries):
        raise AssertionError("a tooling query went unanswered")
    for (u, n), got in answers.items():
        want = _served(model, u, n)
        for status, payload in got:
            if status != 200 or payload != want:
                raise AssertionError(f"tooling: the answer for {u} num={n} "
                                     "differs from the plain int8 path")
    phase_s = time.perf_counter() - t_phase
    out = {"lint": lint, "ready_s": ready_s, "queries": want_n,
           "clients": TOOLING_CLIENTS, "load_s": load_s,
           "flushes": flushes, "B1_launches": launches,
           "B2_launches": merge_launches, "locks_wrapped": len(wrapped),
           "lock_edges": len(edges), "inversions": 0,
           "phase_s": phase_s}
    print(f"tooling: deploy ready in {ready_s:.3f} s; {want_n} queries "
          f"({TOOLING_CLIENTS} clients x {TOOLING_QUERIES} under the lock "
          f"monitor in {load_s:.3f} s, {TOOLING_WARM} before the wrap, "
          f"{TOOLING_PROFILED} profiled) in {flushes} flushes, B1 "
          f"{launches} / B2 {merge_launches} launches, no sort kernel; "
          f"{len(wrapped)} locks wrapped, {len(edges)} lock-order edges, no "
          f"inversion; every answer equals the plain int8 path; phase "
          f"{phase_s:.3f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the serve path (the host-vs-device probe)
# ---------------------------------------------------------------------------

SERVE_PATH_QUERIES = 64          # sequential, then as many concurrent
SERVE_PATH_CLIENTS = 16
SERVE_PATH_PROFILED = 32
SERVE_PATH_NUMS = (1, 4, 10, 10, 100, 10, 600, 10)
SERVE_PATH_NEW_USERS, SERVE_PATH_TRAINED = 8, 8
SERVE_PATH_RATINGS, SERVE_PATH_TRAINED_RATINGS = 20, 5
SERVE_PATH_MEM_SLACK = 1 << 20   # bytes memory_allocated may move
SERVE_PATH_RTOL, SERVE_PATH_ATOL = 1e-5, 1e-6


def phase_serve_path(work: str, seed: int, dev: torch.device,
                     iid: str) -> dict:
    """Phase 16 in the store phase's eventlog store (its warm-train
    instance ``iid`` and the 20M app it tails), fp32. The fold-in deploy
    pads no item rows (only users fold here), so its answers rank the
    same catalog as the deploy without fold-in."""
    env = _eventlog_env(work)
    names = (*env, "PIO_SERVE_QUANT", "PIO_SERVE_DEVICE_MS",
             "PIO_FOLDIN_CURSOR_DIR", "PIO_FOLDIN_ITEM_HEADROOM")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(env)
    os.environ["PIO_SERVE_QUANT"] = "off"
    os.environ["PIO_FOLDIN_ITEM_HEADROOM"] = "0"
    os.environ.pop("PIO_SERVE_DEVICE_MS", None)
    storage_mod.reset_storage()
    try:
        store = storage_mod.get_storage()
        out = _phase_serve_path(work, store, iid, seed, dev)
        store.get_events().close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_mod.reset_storage()
    return out


def _path_deploy(store, iid: str, work: str, name: str, foldin_mode: str):
    """An fp32 deploy of ``iid`` (QueryAPI + serve()); returns (api, port,
    server thread, seconds to ready)."""
    os.environ["PIO_FOLDIN_CURSOR_DIR"] = os.path.join(work, "cur_" + name)
    t0 = time.perf_counter()
    api = create_server.QueryAPI(create_server.ServerConfig(
        serve_quant="off", engine_instance_id=iid, foldin=foldin_mode),
        storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    _wait_ready(port, server.is_alive, deadline_s=300)
    return api, port, server, time.perf_counter() - t0


def _live_event() -> dict:
    """The newest ``lifecycle`` event of a model going live."""
    live = [e for e in journal.snapshot(category="lifecycle",
                                        limit=64)["events"]
            if " live (" in e["message"]]
    if not live:
        raise AssertionError("no lifecycle event of a model going live")
    return live[-1]


def _as_answer(model, vals, idx) -> dict:
    inv = model.item_vocab.inverse()
    n_real = len(model.item_vocab)
    return {"itemScores": [{"item": inv(int(i)), "score": float(v)}
                           for v, i in zip(vals, idx) if int(i) < n_real]}


def _fp32_answers(model, user: str, num: int) -> dict:
    """{bucket: the answer ``topk.topk_for_users`` gives ``user``'s row in
    fp32 on the card in a flush of that bucket} (the row first, padding
    rows at index 0, as predict_batch pads)."""
    U, V = model.user_factors, model.item_factors
    k = min(num, len(model.item_vocab))
    out = {}
    for b in BUCKETS:
        pix = torch.zeros(b, dtype=torch.int32, device=U.device)
        pix[0] = model.user_vocab(user)
        vals, idx = topk.topk_for_users(U, V, pix, k=k)
        out[b] = _as_answer(model, vals[0].cpu().numpy(),
                            idx[0].cpu().numpy())
    return out


def _host_answer(model, user: str, num: int) -> dict:
    """The host branch of predict_batch for a flush of one: one numpy
    gemm, ``host_topk``."""
    ix = np.asarray([model.user_vocab(user)], dtype=np.int32)
    scores = model.user_factors[ix] @ model.item_factors.T
    vals, idx = topk.host_topk(scores[0], min(num, len(model.item_vocab)))
    return _as_answer(model, vals, idx)


def _path_traffic(port: int, queries):
    """The sequential queries, then the same again from 16 clients;
    returns ([(query, payload)] sequential, [(query, payload)]
    concurrent, (p50, p99) ms of the sequential ones, client clock)."""
    seq, lat = [], []
    for u, n in queries:
        status, payload, dt_s, _raw = _post(port, u, n)
        if status != 200:
            raise AssertionError(f"serve path: {u} num={n} answered "
                                 f"{status}")
        seq.append(((u, n), payload))
        lat.append(dt_s)
    with ThreadPoolExecutor(max_workers=SERVE_PATH_CLIENTS) as pool:
        got = list(pool.map(lambda q: _post(port, q[0], q[1]), queries))
    if any(g[0] != 200 for g in got):
        raise AssertionError("serve path: a concurrent query failed")
    return seq, [(q, g[1]) for q, g in zip(queries, got)], _pct(lat)


def _within(model, user: str, a: dict, b: dict) -> tuple:
    """(max |score difference|, positions whose items may differ) of two
    answers for ``user``: the scores within rtol / atol, and the items
    equal wherever the gaps to the neighbours in the host ranking (the
    (k+1)-th included) exceed twice the tolerance."""
    sa = [s["score"] for s in a["itemScores"]]
    sb = [s["score"] for s in b["itemScores"]]
    if len(sa) != len(sb):
        raise AssertionError(f"{user}: {len(sa)} against {len(sb)} items")
    worst = 0.0
    for x, y in zip(sa, sb):
        if abs(x - y) > SERVE_PATH_ATOL + SERVE_PATH_RTOL * abs(x):
            raise AssertionError(f"{user}: scores {x} and {y} differ past "
                                 "rtol 1e-5 / atol 1e-6")
        worst = max(worst, abs(x - y))
    n_real = len(model.item_vocab)
    full = np.sort(model.item_factors[:n_real]
                   @ model.user_factors[model.user_vocab(user)])[::-1]
    loose = 0
    for j, (ia, ib) in enumerate(zip(a["itemScores"], b["itemScores"])):
        tol = 2 * (SERVE_PATH_ATOL + SERVE_PATH_RTOL * abs(float(full[j])))
        gaps = [abs(float(full[j]) - float(full[m])) for m in (j - 1, j + 1)
                if 0 <= m < len(full)]
        if min(gaps, default=np.inf) > tol:
            if ia["item"] != ib["item"]:
                raise AssertionError(f"{user}: position {j} holds "
                                     f"{ia['item']} and {ib['item']} past "
                                     "a clear gap")
        else:
            loose += 1
    return worst, loose


#: the marker's kernels (a fill and a multiply from this thread)
MARKER_KERNELS = ("FillFunctor", "MulFunctor")
#: the profiler's own entry (CUPTI's activity buffers), not device work
PROFILER_OWN = ("Activity Buffer Request",)


def _host_only_profile(fn, dev: torch.device, attempts: int = 10) -> dict:
    """``fn`` under torch.profiler between two marker kernels from this
    thread before it and the same two after it, so that a session whose
    device events the profiler dropped (on this machine a session now and
    then records none, PERF.md §6) cannot pass for an absent kernel: a
    session without all four markers is run again, up to ``attempts``
    times; in one that has them, every other device entry is a fault.
    Returns the trace's entries."""
    x = torch.empty(1 << 20, device=dev)

    def mark():
        x.fill_(1.0)
        x.mul_(2.0)

    def marked():
        mark()
        fn()
        mark()

    def is_marker(key):
        return any(m in key for m in MARKER_KERNELS)

    for attempt in range(attempts):
        per, wall = _device_profile(marked, attempts=1)
        if all(sum(n for k, (_us, n) in per.items() if m in k) == 2
               for m in MARKER_KERNELS):
            break
        print(f"profile: session {attempt + 1} recorded not the four "
              f"marker kernels: {per}", flush=True)
    else:
        raise AssertionError("the profiler recorded no marker kernel in "
                             f"{attempts} sessions")
    extra = {k: v for k, v in per.items()
             if not is_marker(k) and k not in PROFILER_OWN}
    if extra:
        raise AssertionError(f"the host path ran device work: {extra}")
    return {"entries": {k[:90]: n for k, (_us, n) in per.items()},
            "wall_s": wall, "sessions": attempt + 1}


def _host_profile_child(work: str, iid: str, queries) -> dict:
    """The host path's queries under torch.profiler in a process of its
    own: a deploy of ``iid`` at ``PIO_SERVE_DEVICE_MS=0`` (fold-in off)
    answering ``queries``, after one discarded session. In this long
    process a session now and then records no device event or only some
    of them (PERF.md §6); in a fresh one, after its first, every session
    has recorded them. Returns :func:`_host_only_profile`'s result."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p)}
    code = ("import json, sys, chip_smoke\n"
            "out = chip_smoke.host_profile_main(sys.argv[1], sys.argv[2], "
            "json.loads(sys.argv[3]))\n"
            "print(json.dumps(out), flush=True)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, work, iid, json.dumps(queries)],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the host-path profile exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def host_profile_main(work: str, iid: str, queries) -> dict:
    """The child of :func:`_host_profile_child` (its environment is the
    parent's: the eventlog store, fp32, ``PIO_SERVE_DEVICE_MS=0``)."""
    from predictionio_tpu_torch import device as device_mod
    dev = device_mod.resolve(None)
    storage_mod.reset_storage()
    store = storage_mod.get_storage()
    api, port, server, _ready = _path_deploy(store, iid, work, "profile",
                                             "off")
    try:
        status = api.handle("GET", "/")[1]
        if "hostServing" not in status:
            raise AssertionError("the profiled deploy is not on the host")
        # the discarded first session, which also loads the markers'
        # kernels (CUDA loads a kernel's module at its first launch)
        x = torch.empty(1 << 20, device=dev)
        _device_profile(lambda: (x.fill_(1.0), x.mul_(2.0)), attempts=1)
        return _host_only_profile(
            lambda: [_post(port, u, n) for u, n in queries], dev)
    finally:
        _undeploy(port, server)


def _phase_serve_path(work: str, store, iid: str, seed: int,
                      dev: torch.device) -> dict:
    from predictionio_tpu_torch.data.api import http as http_mod
    from predictionio_tpu_torch.data.api import service

    smi = _smi()
    out = {"card": smi}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 16)

    # (a) the threshold unset: the device path
    api, port, server, ready_a = _path_deploy(store, iid, work, "a", "off")
    try:
        model = api.models[0]
        probe = dict(model.serve_probe or {})
        status = api.handle("GET", "/")[1]
        event = _live_event()
        users = list(model.user_vocab.to_dict())
        picks = rng.integers(0, len(users), size=SERVE_PATH_QUERIES)
        queries = [(users[u], SERVE_PATH_NUMS[i % len(SERVE_PATH_NUMS)])
                   for i, u in enumerate(picks)]
        if (probe.get("servePath") != "device"
                or not isinstance(model.user_factors, torch.Tensor)
                or model.user_factors.device.type != dev.type
                or "hostServing" in status
                or event["fields"].get("servePath") != "device"
                or event["level"] != "info"):
            raise AssertionError(f"(a) not served from the card: probe "
                                 f"{probe}, GET / keys {sorted(status)}, "
                                 f"event {event}")
        seq_a, conc_a, lat_a = _path_traffic(port, queries)
        wants = {q: _fp32_answers(model, *q) for q in set(queries)}
        for q, payload in seq_a:
            if payload != wants[q][1]:
                raise AssertionError(f"(a) {q}: not topk_for_users' answer "
                                     "at bucket 1")
        at_one = 0
        for q, payload in conc_a:
            if payload not in wants[q].values():
                raise AssertionError(f"(a) {q}: no bucket of "
                                     "topk_for_users gives this answer")
            at_one += payload == wants[q][1]
    finally:
        _undeploy(port, server)
    out["a"] = {"probe_ms": probe["probeMs"], "threshold_ms":
                probe["thresholdMs"], "ready_s": ready_a,
                "queries": 2 * len(queries), "seq_p50_p99_ms": lat_a,
                "concurrent_equal_at_bucket_1": at_one}
    print(f"serve path (a): {smi}: PIO_SERVE_DEVICE_MS unset, the probe "
          f"{probe['probeMs']:.4f} ms <= {probe['thresholdMs']} ms: served "
          f"from the card (no hostServing; lifecycle event device); ready "
          f"{ready_a:.3f} s; {len(queries)} sequential + {len(queries)} "
          f"concurrent answers each byte-equal to fp32 topk_for_users on "
          f"the card ({at_one} concurrent ones at bucket 1); sequential "
          f"p50 / p99 {lat_a[0]:.3f} / {lat_a[1]:.3f} ms", flush=True)
    a_answers = dict(seq_a)
    del api, model, wants
    gc.collect()

    # (b) PIO_SERVE_DEVICE_MS=0 with fold-in on: the host path
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    os.environ["PIO_SERVE_DEVICE_MS"] = "0"
    solve.reset_launches()
    api, port, server, ready_b = _path_deploy(store, iid, work, "b", "on")
    try:
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        warm_a = solve.launches
        model = api.models[0]
        probe_b = dict(model.serve_probe or {})
        status = api.handle("GET", "/")[1]
        event = _live_event()
        hs = status.get("hostServing")
        if (probe_b.get("servePath") != "host" or hs is None
                or not isinstance(model.user_factors, np.ndarray)
                or hs["probeMs"] != round(probe_b["probeMs"], 3)
                or event["level"] != "warn"
                or event["fields"].get("servePath") != "host"):
            raise AssertionError(f"(b) not served from the host: probe "
                                 f"{probe_b}, hostServing {hs}, event "
                                 f"{event}")
        if abs(mem1 - mem0) > SERVE_PATH_MEM_SLACK:
            raise AssertionError(f"(b) memory_allocated {mem0} -> {mem1}: "
                                 "a factor copy stayed on the card")
        if api._foldin_worker is None:
            raise AssertionError("(b) the fold-in worker did not start")
        seq_b, conc_b, lat_b = _path_traffic(port, queries)
        worst, loose = 0.0, 0
        for (q, pb) in seq_b + conc_b:
            w, lo = _within(model, q[0], a_answers[q], pb)
            worst, loose = max(worst, w), loose + lo
        profiled = [(users[u], 10) for u in
                    rng.integers(0, len(users), size=SERVE_PATH_PROFILED)]
        trace = _host_profile_child(work, iid, profiled)
        out["b"] = {"probe_ms": probe_b["probeMs"], "ready_s": ready_b,
                    "memory_allocated": [mem0, mem1],
                    "warmup_A_launches": warm_a,
                    "max_abs_score_diff": worst, "seq_p50_p99_ms": lat_b,
                    "positions_within_tolerance": loose,
                    "profiled": len(profiled), "trace": trace}
        print(f"serve path (b): {smi}: PIO_SERVE_DEVICE_MS=0, the probe "
              f"{probe_b['probeMs']:.4f} ms > 0 ms: served from the host "
              f"(hostServing {hs}; lifecycle event warn); ready "
              f"{ready_b:.3f} s with the fold-in warm-up (kernel A "
              f"{warm_a} launches); memory_allocated {mem0} -> {mem1} B; "
              f"{2 * len(queries)} answers within rtol 1e-5 / atol 1e-6 of "
              f"(a)'s (max |diff| {worst:.3g}; {loose} positions inside "
              f"the tolerance), indices equal past it; sequential p50 / p99 "
              f"{lat_b[0]:.3f} / {lat_b[1]:.3f} ms; {len(profiled)} "
              f"profiled queries (the same deploy in a process of its own) "
              f"ran no CUDA kernel (trace: {trace['entries']}, session "
              f"{trace['sessions']})", flush=True)

        # (c) fold-in into the host arrays under a query stream
        worker = api._foldin_worker
        new_users = [f"path_u{j}" for j in range(SERVE_PATH_NEW_USERS)]
        trained = [users[u] for u in rng.choice(
            len(users), size=SERVE_PATH_TRAINED, replace=False)]
        items = list(model.item_vocab.to_dict())
        events = []
        for who, n in ((new_users, SERVE_PATH_RATINGS),
                       (trained, SERVE_PATH_TRAINED_RATINGS)):
            for u in who:
                for i in rng.choice(len(items), size=n, replace=False):
                    events.append(_rate(u, items[i],
                                        float(rng.integers(1, 11)) / 2))
        solves, published = [], []

        def wrap_solve(orig):
            def f(item_rows, self_idx, rating, counts, lambda_, *, n_self,
                  chunk, reg_scaling="count"):
                x = orig(item_rows, self_idx, rating, counts, lambda_,
                         n_self=n_self, chunk=chunk, reg_scaling=reg_scaling)
                solves.append((item_rows, self_idx, rating, counts, lambda_,
                               n_self, chunk, reg_scaling, x))
                return x
            return f

        def wrap_publish(orig):
            def publish(self, model_, ixs, rows_):
                published.append((ixs.copy(), np.array(rows_, np.float32)))
                return orig(self, model_, ixs, rows_)
            return publish

        es, es_port = http_mod.serve_background(
            service.EventAPI(storage=store), "127.0.0.1", 0)
        solve.reset_launches()
        t_fold = time.perf_counter()
        with _wrapped((foldin, "foldin_solve", wrap_solve),
                      (foldin.FoldinWorker, "_publish", wrap_publish)):
            stream = _Stream(port, users, seed + 161)
            try:
                _post_events(es_port, events)
                _wait_worker(api, lambda st: (
                    st["usersFolded"] >= len(new_users) + len(trained)
                    and st["cursorLag"] == 0 and not st["usersPending"]),
                    "the serve path's folds")
                time.sleep(2 * worker.config.tick_ms / 1e3)
            finally:
                stream_out = stream.close()
                es.shutdown()
                es.server_close()
        fold_s = time.perf_counter() - t_fold
        a_launches = solve.launches
        if stream_out["dropped"]:
            raise AssertionError(f"(c) dropped queries: {stream_out}")
        if not solves or a_launches != len(solves):
            raise AssertionError(f"(c) {len(solves)} fold-in solves, "
                                 f"{a_launches} kernel A launches")
        for args in solves:
            if not bool(_bitwise_same(args[-1],
                                      _foldin_plain(*args[:-1])).all()):
                raise AssertionError(f"(c) a tick's kernel A != plain at "
                                     f"n={args[5]}")
        outputs = {row.tobytes() for *_a, x in solves
                   for row in x.cpu().numpy()}
        last = {}
        for ixs, rs in published:
            for ix, r in zip(ixs.tolist(), rs):
                last[ix] = r
        want_ix = {model.user_vocab(u) for u in new_users + trained}
        if not want_ix <= set(last):
            raise AssertionError("(c) not every folded user was published")
        for ix, r in last.items():
            if r.tobytes() not in outputs:
                raise AssertionError("(c) a published row is no solve's "
                                     "output")
            if model.user_factors[ix].tobytes() != r.tobytes():
                raise AssertionError(f"(c) host row {ix} is not the folded "
                                     "row")
        for u in new_users + trained:
            status_u, payload, _dt, _raw = _post(port, u, 10)
            if status_u != 200 or payload != _host_answer(model, u, 10):
                raise AssertionError(f"(c) {u}: not the host branch's "
                                     "answer")
            if not payload["itemScores"]:
                raise AssertionError(f"(c) {u}: an empty answer")
        buckets = sorted({int(a[5]) for a in solves})

        # then /reload with the variable unset: the card again
        os.environ.pop("PIO_SERVE_DEVICE_MS", None)
        gen = api.generation
        t_reload = time.perf_counter()
        _get(port, "/reload", method="POST")
        while api.generation == gen:
            if time.perf_counter() - t_reload > FOLD_DEADLINE_S:
                raise AssertionError("(c) the reload did not land")
            time.sleep(0.05)
        reload_s = time.perf_counter() - t_reload
        status = api.handle("GET", "/")[1]
        event = _live_event()
        reloaded = api.models[0]
        if ("hostServing" in status
                or not isinstance(reloaded.user_factors, torch.Tensor)
                or reloaded.user_factors.device.type != dev.type
                or event["fields"].get("servePath") != "device"
                or not event["fields"].get("reload")):
            raise AssertionError(f"(c) the reload did not go back to the "
                                 f"card: {sorted(status)}, event {event}")
        for u in trained[:4]:
            if _post(port, u, 10)[0] != 200:
                raise AssertionError("(c) a query after the reload failed")
    finally:
        _undeploy(port, server)
    out["c"] = {"events": len(events), "users": len(want_ix),
                "A_launches": a_launches, "A_buckets": buckets,
                "stream_queries": stream_out["queries"], "dropped": 0,
                "fold_s": fold_s, "reload_s": reload_s,
                "reload_probe_ms": reloaded.serve_probe["probeMs"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serve path (c): {smi}: {len(events)} events of "
          f"{len(new_users)} unseen and {len(trained)} trained users folded "
          f"into the host arrays in {fold_s:.3f} s under "
          f"{stream_out['queries']} streamed queries, 0 dropped; kernel A "
          f"{a_launches} launches at n = {buckets}, each == plain bit for "
          f"bit; every folded host row bit-equal to its solve's row; the "
          f"users' answers the host branch's; POST /reload with the "
          f"variable unset back on the card in {reload_s:.3f} s (probe "
          f"{out['c']['reload_probe_ms']:.4f} ms), hostServing gone; "
          f"phase {out['phase_s']:.3f} s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA card", file=sys.stderr)
        return 2
    torch.manual_seed(args.seed)
    dev = torch.device("cuda")
    smi = _smi()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    secs = _kernels.build("topk_fused", "solve_gj", "gram_fused")
    for name, took in secs.items():
        print(f"build: {name} {took:.2f} s (nvcc, both started together)",
              flush=True)
        kernel = "?"
        for line in _kernels.build_logs[name].splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"build: {name} ptxas: {kernel}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)

    U, V = _model(args.seed)
    qf = quant.QuantizedFactors.from_factors(U, V)
    qs = quant.QuantizedServing.build(qf, device=dev)
    if qs.tile != TILE or qs.vt_q.shape[1] != 53 * TILE:
        raise AssertionError(f"unexpected layout: tile {qs.tile}, n_pad "
                             f"{qs.vt_q.shape[1]}")
    rows, large_k, wide, mixed, worst, worst_merge = phase_kernel(
        qs, U, V, args.seed)
    del qs, qf, U, V
    rows_a, worst_a = phase_solve(args.seed, dev)
    rows_g = phase_gram(args.seed, dev)
    work = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    try:
        store, iid, users, train = phase_train(work, args.seed, dev)
        launches, merge_launches, split, served = phase_path(
            store, iid, users, args.seed)
        observe = phase_observe(work, store, iid, users, args.seed,
                                served, dev)
        (qs_solve_launches, qs_launches, qs_merge_launches, n_app_events,
         qs_out) = phase_quickstart(work, args.seed, dev)
        fleet_out = phase_fleet(work, store, iid, users, args.seed, served,
                                qs_out["instance_id"], dev)
        eval_launches, eval_solve_rows, eval_out = phase_eval(
            work, args.seed, dev, n_app_events)
        (sim_launches, ecom_launches, tpl_solve_rows,
         tpl_out) = phase_templates(work, args.seed, dev)
        store_out, store_ctx = phase_store(work, args.seed, dev, train,
                                           qs_out)
        remote_out = phase_remote(work, args.seed, dev, store_out,
                                  store_ctx)
        store_out["foldin"] = phase_store_foldin(work, args.seed, dev,
                                                 store_ctx)
        control_out = phase_control(work, args.seed, dev)
        examples_out = phase_examples(work, args.seed, dev)
        store_iid = store_ctx["iid"]
        del store_ctx
        shard_out = phase_shard(work, args.seed, dev)
        tooling_out = phase_tooling(store, iid, users, args.seed)
        path_out = phase_serve_path(work, args.seed, dev, store_iid)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_row = rows[-1]           # the largest serving bucket, b = 64
    row_a = rows_a[0]             # the user half-step, n = 138,493
    print(json.dumps({"kernels": [{
        "name": "topk_fused",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topk_fused.cu",
        "replaces": "predictionio_tpu/ops/topk_pallas.py:94",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "body_ms": main_row["body_ms"],
        "merge_source": "predictionio_tpu_torch/csrc/topk_fused.cu",
        "merge_replaces": "predictionio_tpu/ops/topk_pallas.py:180",
        "merge_launches": merge_launches,
        "merge_max_abs_err": worst_merge,
        "merge_ms": main_row["merge_ms"],
        "merge_body_ms": main_row["merge_body_ms"],
        "merge_plain_ms": main_row["merge_plain_ms"],
        "merge_bound_ms": main_row["merge_bound_ms"],
        "merge_bound_by": main_row["merge_bound_by"],
        "merge_library_ms": main_row["merge_library_ms"],
        "quickstart_launches": qs_launches,
        "quickstart_merge_launches": qs_merge_launches,
        "store_launches": store_out["deploy"]["B1_launches"],
        "store_merge_launches": store_out["deploy"]["B2_launches"],
        "foldin_launches": store_out["foldin"]["B1_launches"],
        "foldin_merge_launches": store_out["foldin"]["B2_launches"],
        "remote_launches": remote_out["deploy"]["B1_launches"],
        "remote_merge_launches": remote_out["deploy"]["B2_launches"],
        "shard_launches": shard_out["deploy"]["B1_launches"],
        "shard_merge_launches": shard_out["deploy"]["B2_launches"],
        "tooling_launches": tooling_out["B1_launches"],
        "tooling_merge_launches": tooling_out["B2_launches"],
        "tooling": tooling_out,
        "examples_launches": examples_out["filtering"]["deploy"][
            "B1_launches"],
        "examples_merge_launches": examples_out["filtering"]["deploy"][
            "B2_launches"],
        "examples_deploy": examples_out["filtering"]["deploy"],
        "fleet_launches": _fleet_launches(fleet_out),
        "fleet": fleet_out,
        "autotrain_launches": {
            "cycle": {k: control_out["autotrain"]["launches"][k]
                      for k in ("B1", "B2", "flushes", "warmup_buckets")},
            "autopilot": control_out["autopilot"]["launches"]},
        "autotrain": {k: v for k, v in control_out["autotrain"].items()
                      if k != "launches"},
        "autopilot": control_out["autopilot"],
        "shard_serve": shard_out["serve"],
        "shape": {"b": main_row["b"], "r": RANK, "n_items": N_ITEMS,
                  "tile": TILE, "k": main_row["k"]},
        "by_bucket": rows,
        "merge_large_k": large_k,
        "merge_wide": wide,
        "mixed_flush": mixed,
        "serving_device_split": split,
        "observe": {k: v for k, v in observe.items()
                    if k != "profiled_train"},
        "card": smi,
    }, {
        "name": "solve_gj",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/solve_gj.cu",
        "replaces": "predictionio_tpu/ops/solve_pallas.py:38",
        "launches": train["solve_gj_launches"],
        "max_abs_err": worst_a,
        "ms": row_a["ms"],
        "plain_ms": row_a["plain_ms"],
        "bound_ms": row_a["bound_ms"],
        "bound_by": row_a["bound_by"],
        "library_ms": row_a["library_ms"],
        "shape": {"n": row_a["n"], "r": row_a["r"]},
        "by_shape": rows_a,
        "quickstart_launches": qs_solve_launches,
        "quickstart": qs_out,
        "eval_launches": eval_launches,
        "eval_by_rank": eval_solve_rows,
        "eval": eval_out,
        "similarproduct_launches": sim_launches,
        "ecommerce_launches": ecom_launches,
        "implicit_by_side": tpl_solve_rows,
        "templates": tpl_out,
        "store_launches": [t["solve_gj_launches"]
                           for t in store_out["trains"]],
        "store_import_launches":
            store_out["import"]["train"]["solve_gj_launches"],
        "foldin_launches": store_out["foldin"]["A_launches"],
        "foldin_by_bucket": store_out["foldin"]["kernel_a"],
        "remote_launches": [t["solve_gj_launches"]
                            for t in remote_out["trains"]],
        "autotrain_launches": {
            "live_train": control_out["autotrain"]["live_train"][
                "A_launches"],
            "cli_train": control_out["autotrain"]["cli_train"]["A_launches"],
            "retrain": control_out["autotrain"]["launches"]["A"],
            "retrain_max_abs_err": control_out["autotrain"]["launches"][
                "A_max_abs_err"],
            "rejected_retrain": control_out["autotrain"]["reject"][
                "A_launches"]},
        "shard_launches": shard_out["library"]["A_launches"],
        "shard_cli_launches": [t["A_launches"] for t in
                               shard_out["cli"]["trains"].values()],
        "shard": {k: v for k, v in shard_out.items() if k != "serve"},
        "serve_path_launches": path_out["c"]["A_launches"],
        "serve_path": path_out,
        "examples_launches": {
            "filtering_train": examples_out["filtering"]["train"][
                "A_launches"],
            "cat_train": examples_out["shop"]["cat"]["train"]["A_launches"],
            "similarproduct_variants_train": examples_out["shop"]["spv"][
                "train"]["A_launches"],
            "sliding_eval": examples_out["shop"]["sliding_eval"][
                "A_launches"]},
        "examples_max_abs_err": max(
            examples_out["filtering"]["train"]["A_max_abs_err"],
            examples_out["shop"]["cat"]["train"]["A_max_abs_err"],
            examples_out["shop"]["spv"]["train"]["A_max_abs_err"],
            examples_out["shop"]["sliding_eval"]["A_max_abs_err"]),
        "examples": {k: v for k, v in examples_out.items()
                     if k != "filtering"},
        "store": store_out,
        "remote": remote_out,
        "observe": observe["profiled_train"],
        "card": smi,
    }, {
        "name": "gram_fused",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/gram_fused.cu",
        "replaces": "predictionio_tpu_torch/ops/als.py::gram_rhs_plain "
                    "(no TPU kernel: the JAX package's Gram is XLA's)",
        "launches": train["gram_fused_launches"],
        "max_gap": max(row["max_gap"] for row in rows_g),
        "ms": rows_g[0]["ms"],
        "body_ms": rows_g[0]["body_ms"],
        "plain_ms": rows_g[0]["plain_ms"],
        "bound_ms": rows_g[0]["bound_ms"],
        "bound_by": rows_g[0]["bound_by"],
        "shape": {k: rows_g[0][k] for k in ("cell", "side", "n", "r")},
        "by_shape": rows_g,
        "card": smi,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
