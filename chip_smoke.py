#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. device  — the card's name and power limit, as nvidia-smi gives them.
2. build   — the port's kernel from ``predictionio_tpu_torch/csrc`` with
             nvcc, with ptxas's report.
3. kernel  — each kernel against its plain PyTorch version on the card,
             exact equality of values and indices, at the serving shapes
             (ML-20M: 138,493 users x 26,744 items, rank 10, tile 512,
             b in 1/4/16/64, k in 1/10/100 and one k above the tile) and
             with cloned items tied across tiles; then CUDA-event times
             of the kernel, its plain version and a library yardstick.
4. path    — a full-width ML-20M-shape deploy from ``--seed``: the model
             goes through model_io into storage, ``QueryAPI`` quantizes
             it on the card and ``serve()`` answers POST /queries.json
             on 127.0.0.1 (sequential and concurrent requests). Every
             answer must equal the plain int8 path on the same factors,
             and the kernel's launch count must cover every flush.

The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``. Without a card the
script prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from predictionio_tpu_torch.data import storage as storage_mod
from predictionio_tpu_torch.ops import _kernels, quant, topk_fused
from predictionio_tpu_torch.workflow import create_server, model_io

N_USERS, N_ITEMS, RANK = 138_493, 26_744, 10     # ML-20M shape, rank 10
TILE = 512
BUCKETS = (1, 4, 16, 64)

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12


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


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; returns ({kernel name: (device
    us, count)}, wall s). The dict is empty when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

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
        if us:
            per[e.key] = (float(us), int(e.count))
    return per, wall


def _topk_fused_bound_ms(b: int, r: int, n_pad: int, tile: int,
                         k_local: int) -> tuple:
    """Least time for the candidates function at this shape: each input
    read once and each output written once, against the integer dot,
    the rescale and one compare per score (what selecting a tile's top
    k needs, whatever algorithm the kernel uses) at their peak rates."""
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


def phase_kernel(qs, U, V, seed: int):
    """topk_fused kernel == plain version, exactly; then its times."""
    dev = qs.device
    rng = np.random.default_rng(seed + 1)
    checks = 0
    worst = 0.0
    for b in BUCKETS:
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=b).astype(np.int32)).to(dev)
        gathered = (qs.u_q.index_select(0, ixs.long()),
                    qs.u_scale.index_select(0, ixs.long()))
        for k in (1, 10, 100, TILE + 88):
            k_local = min(k, TILE)
            kv, ki = topk_fused.score_mask_topk_candidates(
                qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs,
                k_local=k_local, n_items=N_ITEMS, tile=TILE)
            pv, pi = topk_fused.score_mask_topk_candidates_plain(
                *gathered, qs.vt_q, qs.v_scale, k_local=k_local,
                n_items=N_ITEMS, tile=TILE)
            torch.cuda.synchronize()
            if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
                    and torch.equal(ki, pi)):
                bad = (kv.view(torch.int32) != pv.view(torch.int32)) | \
                    (ki != pi)
                raise AssertionError(
                    f"topk_fused kernel != plain at b={b} k={k}: "
                    f"{int(bad.sum())} candidates differ, first at "
                    f"{bad.nonzero()[:3].tolist()}")
            worst = max(worst, float((kv - pv).abs().max()))
            # the merged answer against the plain int8 path (no tiles)
            fv, fi = topk_fused.merge_candidates(kv, ki, k)
            xv, xi = quant.topk_for_users_quant(
                qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k=k,
                n_items=N_ITEMS)
            if not (torch.equal(fv.view(torch.int32), xv.view(torch.int32))
                    and torch.equal(fi, xi)):
                raise AssertionError(
                    f"fused answer != plain int8 path at b={b} k={k}")
            checks += 1
    # other tiles (PIO_SERVE_FUSED_TILE): 128, and 100, whose last lanes
    # hold no column
    for tile in (128, 100):
        n_pad = -(-N_ITEMS // tile) * tile
        vt = torch.zeros((RANK, n_pad), dtype=torch.int8, device=dev)
        vt[:, :N_ITEMS] = qs.vt_q[:, :N_ITEMS]
        sv = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
        sv[:N_ITEMS] = qs.v_scale[:N_ITEMS]
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=16).astype(np.int32)).to(dev)
        for k_local in (10, tile):
            kv, ki = topk_fused.score_mask_topk_candidates(
                qs.u_q, qs.u_scale, vt, sv, ixs, k_local=k_local,
                n_items=N_ITEMS, tile=tile)
            pv, pi = topk_fused.score_mask_topk_candidates_plain(
                qs.u_q.index_select(0, ixs.long()),
                qs.u_scale.index_select(0, ixs.long()), vt, sv,
                k_local=k_local, n_items=N_ITEMS, tile=tile)
            if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32))
                    and torch.equal(ki, pi)):
                raise AssertionError(f"topk_fused kernel != plain at tile "
                                     f"{tile} k_local={k_local}")
            checks += 1
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
    print(f"kernel: topk_fused == plain at {checks} (b, k) shapes and the "
          f"cross-tile tie; max |diff| {worst}", flush=True)

    # times at every serving bucket, k = 10 (PIO_AOT_KS default)
    Ud = torch.from_numpy(quant.dequantize_rows(*quant.quantize_rows(U))
                          ).to(dev)
    Vd = torch.from_numpy(quant.dequantize_rows(*quant.quantize_rows(V))
                          ).to(dev)
    rows = []
    n_pad = qs.vt_q.shape[1]
    for b in BUCKETS:
        ixs = torch.from_numpy(
            rng.integers(0, N_USERS, size=b).astype(np.int32)).to(dev)
        ixl = ixs.long()
        ms = _time_ms(lambda: topk_fused.score_mask_topk_candidates(
            qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k_local=10,
            n_items=N_ITEMS, tile=TILE))
        plain_ms = _time_ms(
            lambda: topk_fused.score_mask_topk_candidates_plain(
                qs.u_q.index_select(0, ixl), qs.u_scale.index_select(0, ixl),
                qs.vt_q, qs.v_scale, k_local=10, n_items=N_ITEMS,
                tile=TILE), reps=50, warm=5)
        wrapper_ms = _time_ms(lambda: topk_fused.topk_for_users_quant_fused(
            qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k=10,
            n_items=N_ITEMS, tile=TILE))
        library_ms = _time_ms(
            lambda: torch.topk(Ud.index_select(0, ixl) @ Vd.T, 10))
        bound_ms, bound_by = _topk_fused_bound_ms(b, RANK, n_pad, TILE, 10)
        # the kernel body alone, without the wrapper's host time
        per, _wall = _device_profile(lambda: [
            topk_fused.score_mask_topk_candidates(
                qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale, ixs, k_local=10,
                n_items=N_ITEMS, tile=TILE) for _ in range(50)])
        body = [us / n for key, (us, n) in per.items()
                if "score_mask_topk" in key]
        body_ms = body[0] / 1e3 if body else None
        rows.append({"b": b, "k": 10, "ms": ms, "plain_ms": plain_ms,
                     "wrapper_ms": wrapper_ms, "library_ms": library_ms,
                     "body_ms": body_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        body_s = (f"{body_ms:.4f} ms" if body_ms is not None
                  else "not measured")
        print(f"kernel: topk_fused b={b} k=10 call {ms:.4f} ms (device "
              f"body {body_s}), call + merge {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, fp32 matmul+topk {library_ms:.4f} ms, "
              f"bound {bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    return rows, worst


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, user: str, num: int):
    body = json.dumps({"user": user, "num": num}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=body, method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=60) as r:
        status, payload = r.status, r.read()
    return status, json.loads(payload), time.perf_counter() - t0


def phase_path(U, V, seed: int):
    """A full-width deploy answering POST /queries.json on the card."""

    model = model_io.als_model_from_numpy(
        RANK, U, V, {f"u{i}": i for i in range(N_USERS)},
        {f"i{i}": i for i in range(N_ITEMS)})
    store = storage_mod.Storage(env={})
    now = dt.datetime.now(dt.timezone.utc)
    iid = store.get_meta_data_engine_instances().insert(
        storage_mod.EngineInstance(
            id="", status="COMPLETED", start_time=now, end_time=now,
            engine_id="default", engine_version="NOT_USED",
            engine_variant="default",
            engine_factory="predictionio_tpu_torch.models.recommendation."
                           "engine:RecommendationEngine",
            algorithms_params=json.dumps([{"name": "als", "params": {
                "rank": RANK, "numIterations": 10, "lambda": 0.01,
                "seed": seed}}])))
    store.get_model_data_models().insert(
        storage_mod.Model(iid, model_io.serialize_models([model])))

    rng = np.random.default_rng(seed + 2)
    nums = [1, 4, 10, 10, 100, 10, 600, 10, 10, 2, 10, 50, 10, 10, 1000, 10]
    seq = [(int(u), nums[i % len(nums)])
           for i, u in enumerate(rng.integers(0, N_USERS, size=64))]
    burst = [(int(u), 10) for u in rng.integers(0, N_USERS, size=64)]
    profiled = [(int(u), 10) for u in rng.integers(0, N_USERS, size=32)]

    topk_fused.reset_launches()          # the main path starts here
    t0 = time.perf_counter()
    api = create_server.QueryAPI(
        create_server.ServerConfig(serve_quant="on"), storage=store)
    port = _free_port()
    server = threading.Thread(target=create_server.serve,
                              args=(api, "127.0.0.1", port), daemon=True)
    server.start()
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                if r.status == 200:
                    break
        except OSError:
            if not server.is_alive() or time.perf_counter() - t0 > 300:
                raise
            time.sleep(0.05)
    ready_s = time.perf_counter() - t0
    answers = {}
    seq_lat, burst_lat = [], []

    def sequential(queries, lat):
        for u, n in queries:
            status, payload, dt_s = _post(port, f"u{u}", n)
            answers.setdefault((u, n), []).append((status, payload))
            lat.append(dt_s)

    try:
        sequential(seq, seq_lat)
        with ThreadPoolExecutor(max_workers=16) as pool:
            for (u, n), (status, payload, dt_s) in zip(burst, pool.map(
                    lambda q: _post(port, f"u{q[0]}", q[1]), burst)):
                answers.setdefault((u, n), []).append((status, payload))
                burst_lat.append(dt_s)
        stats = api.handle("GET", "/")[1]
        # where a sequential request's time goes: device time under the
        # profiler (which slows the host, so no latency is read here)
        per, wall = _device_profile(lambda: sequential(profiled, []))
    finally:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/stop", data=b"", method="POST"),
            timeout=30).close()
        server.join(timeout=60)
    launches = topk_fused.launches       # the main path ends here
    if server.is_alive():
        raise AssertionError("the server did not stop")

    flushes = stats["batching"]["batches"]
    if stats["quant"] is None or not stats["quant"].get("fused"):
        raise AssertionError(f"deploy did not take the fused path: {stats}")
    if launches < flushes or launches == 0:
        raise AssertionError(
            f"topk_fused launched {launches} times for {flushes} flushes")

    # every answer against the plain int8 path on the same factors
    qs = api.models[0].quant
    for (u, n), got in answers.items():
        k = min(n, N_ITEMS)
        vals, idx = quant.topk_for_users_quant(
            qs.u_q, qs.u_scale, qs.vt_q, qs.v_scale,
            torch.tensor([u], dtype=torch.int32, device=qs.device), k=k,
            n_items=N_ITEMS)
        want = {"itemScores": [{"item": f"i{int(i)}", "score": float(s)}
                               for s, i in zip(vals[0].cpu().numpy(),
                                               idx[0].cpu().numpy())]}
        for status, payload in got:
            if status != 200 or payload != want:
                raise AssertionError(f"answer for u{u} num={n} differs "
                                     "from the plain int8 path")
            if not all(np.isfinite(s["score"])
                       for s in payload["itemScores"]):
                raise AssertionError("non-finite score served")
    def pct(lat):
        ms = [x * 1e3 for x in lat]
        return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))

    b = stats["batching"]
    print(f"path: {len(seq) + len(burst) + len(profiled)} requests "
          f"({len(seq)} sequential, {len(burst)} from 16 client threads, "
          f"{len(profiled)} profiled) in {flushes} flushes before the "
          f"profiled ones {b['batchSizeHist']}, topk_fused launched "
          f"{launches} times; all answers equal the plain int8 path",
          flush=True)
    print(f"path: time to ready {ready_s:.3f} s (load + quantize + layout "
          f"{api.time_to_ready_s:.3f} s)", flush=True)
    print("path: latency sequential p50 %.3f ms p99 %.3f ms; concurrent "
          "p50 %.3f ms p99 %.3f ms; avg flush %.3f ms, avg queue wait "
          "%.3f ms" % (*pct(seq_lat), *pct(burst_lat), b["avgFlushMs"],
                       b["avgQueueWaitMs"]), flush=True)
    busy_us = sum(us for us, _n in per.values())
    if per:
        top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
        print(f"path: profiled {len(profiled)} sequential requests: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"(idle share {1 - busy_us / 1e3 / (wall * 1e3):.4f}); top "
              "device entries " + "; ".join(
                  f"{k[:60]} {us:.1f} us x{n}" for k, (us, n) in top),
              flush=True)
    else:
        print("path: device time under the profiler: not measured (no "
              "device events recorded)", flush=True)
    return launches


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

    secs = _kernels.build("topk_fused")
    print(f"build: topk_fused {secs:.2f} s (nvcc)", flush=True)
    for line in _kernels.build_logs["topk_fused"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: topk_fused ptxas: {line.strip()}", flush=True)

    U, V = _model(args.seed)
    qf = quant.QuantizedFactors.from_factors(U, V)
    qs = quant.QuantizedServing.build(qf, device=dev)
    if qs.tile != TILE or qs.vt_q.shape[1] != 53 * TILE:
        raise AssertionError(f"unexpected layout: tile {qs.tile}, n_pad "
                             f"{qs.vt_q.shape[1]}")
    rows, worst = phase_kernel(qs, U, V, args.seed)
    del qs
    launches = phase_path(U, V, args.seed)

    main_row = rows[-1]           # the largest serving bucket, b = 64
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
        "shape": {"b": main_row["b"], "r": RANK, "n_items": N_ITEMS,
                  "tile": TILE, "k": main_row["k"]},
        "by_bucket": rows,
        "card": smi,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
