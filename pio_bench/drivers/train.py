"""Driver kind ``train``: whole explicit ALS-WR trains of the port, back
to back, on a layout built once in set-up.

Set-up makes the ratings and the initial factors on the device from the
seed (``data.py``), lays the ratings out with the port's
``prepare_ratings(..., on_device=True)`` and runs one warm train of
``warm_iterations`` through the same call as the window, which builds or
loads kernel A and the layout's chunk plans. The window then calls
``ops.als.train_explicit`` from the same start until ``--seconds`` has
passed, each call ending in a host copy of both factor matrices.

``correct``: the layouts against the reference's sort; then, with the
program's state freed, the last call's factors against the reference's
fp64 train from the same start (``factors``), its final item factors
against the reference's half-step from its own final user factors
(``half_step``), and the training RMSE (``rmse``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pio_bench import compare, data
from pio_bench import trace as tracing
from pio_bench.manifest import Cell, load_module, reader

_BENCH = Path(__file__).resolve().parent.parent


@dataclass
class LayerContext:
    """What a per-layer reader reads: the traced window's device
    operations, its length, the calls in it and the cell's data."""
    ops: List[tracing.Op]
    window_s: float
    busy_s: float
    calls: int
    config: dict
    peaks: Optional[dict]

    @property
    def iterations(self) -> int:
        return self.calls * int(self.config["iterations"])

    def kernels(self) -> List[tracing.Op]:
        return [op for op in self.ops if op.kind == "kernel"]


def reference_module(cfg: dict):
    return load_module(_BENCH / "reference" / f"{cfg['reference']}.py",
                       f"pio_bench_reference_{cfg['reference']}")


def peaks_for(device: torch.device) -> Optional[dict]:
    """The card's peaks from ``peaks.json``; None off a card. A card
    that the table does not name raises: its shares cannot be read."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    with open(_BENCH / "peaks.json") as f:
        table = json.load(f)
    if name not in table:
        raise RuntimeError(f"peaks.json has no entry for {name!r} (it has "
                           f"{sorted(table)}): no share of a peak can be "
                           "read")
    return table[name]


def build_layout(cfg: dict, coo, device: torch.device):
    from predictionio_tpu_torch.ops import als
    user, item, rating = coo
    return als.prepare_ratings(user, item, rating, int(cfg["n_users"]),
                               int(cfg["n_items"]), on_device=True,
                               device=device)


def program_call(cfg: dict, layout, u0, v0, device: torch.device
                 ) -> Callable[[int], Tuple[torch.Tensor, torch.Tensor]]:
    """The timed call: a train of ``iterations`` from (u0, v0), ending in
    a host copy of both factor matrices."""
    from predictionio_tpu_torch.ops import als

    def call(iterations: int):
        U, V = als.train_explicit(
            layout, rank=int(cfg["rank"]), iterations=iterations,
            lambda_=float(cfg["lambda"]), reg_scaling=cfg["reg_scaling"],
            u0=u0, v0=v0, device=device)
        return U.cpu(), V.cpu()

    return call


def layout_numbers(layout, sides) -> Dict[str, float]:
    """Mismatching entries of the program's two layouts against the
    reference's ``sides`` (by user, by item) of the same ratings."""
    bad = 0
    for side, mine in zip((layout.by_user, layout.by_item), sides):
        bad += compare.coo_mismatches(
            (side.self_idx, side.other_idx, side.rating, side.counts),
            (mine.self_idx, mine.other_idx, mine.rating, mine.counts),
            mine.n_self, mine.n_other)
    return {"layout": float(bad)}


def factor_numbers(cfg: dict, coo, u0, v0, U, V, ref, sides
                   ) -> Dict[str, float]:
    """The program's factors (U, V, on any device) against the
    reference's fp64 train from (u0, v0) and its half-step from U."""
    device = u0.device
    by_user, by_item = sides
    precision = "fp64"
    lam = float(cfg["lambda"])
    U = U.to(device)
    V = V.to(device)
    half = ref.half_step(U, by_item, lam, precision)
    half_step = compare.row_gap(V, half)
    del half
    Ur, Vr = ref.train(u0, v0, by_user, by_item, int(cfg["iterations"]),
                       lam, precision)
    factors = max(compare.row_gap(U, Ur), compare.row_gap(V, Vr))
    rmse = compare.relative_gap(ref.rmse(U, V, *coo), ref.rmse(Ur, Vr, *coo))
    return {"half_step": half_step, "factors": factors, "rmse": rmse}


def layer_metrics(cell: Cell, ctx: LayerContext) -> Dict[str, dict]:
    """Every per-layer metric the cell reports; one whose reader finds
    nothing to read raises, so the run prints no shorter result."""
    out = {}
    for name, unit in cell.per_layer.items():
        value = reader(cell, name).read(ctx)
        if value is None:
            raise RuntimeError(f"{cell.name} reports {name}, and its reader "
                               "found nothing to read in the traced window")
        out[name] = {"value": value, "unit": unit}
    return out


def load_kernels(device: torch.device) -> None:
    """Kernel A's library: built on a checkout's first run, loaded
    after (a set-up phase of its own)."""
    if device.type == "cuda":
        from predictionio_tpu_torch.ops import _kernels
        _kernels.load("solve_gj")


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, log=print,
        marks: Optional[List[Tuple[str, float]]] = None) -> dict:
    """One run of the cell; ``marks`` are the set-up phases the caller
    timed before it, as (name, end time) from ``t0``."""
    marks = list(marks or [])
    from predictionio_tpu_torch.ops import als  # noqa: F401 (the program)

    cfg, traffic = cell.config, cell.traffic
    ref = reference_module(cfg)
    marks.append(("program import", time.perf_counter()))
    load_kernels(device)
    marks.append(("kernel A build or load", time.perf_counter()))
    coo, (u0, v0) = data.inputs(cfg, seed, device)
    marks.append(("inputs", time.perf_counter()))
    layout = build_layout(cfg, coo, device)
    marks.append(("layout", time.perf_counter()))
    call = program_call(cfg, layout, u0, v0, device)
    call(int(traffic["warm_iterations"]))
    marks.append(("warm train", time.perf_counter()))
    session = None
    if trace:
        tracing.discard_first_session(device)
        session = tracing.Session()
        marks.append(("profiler", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    prev = t0
    phases = []
    for name, t in marks:
        phases.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"set-up {setup_s:.3f} s ({', '.join(phases)}): {cfg['n_ratings']} "
        f"ratings, {cfg['n_users']} x {cfg['n_items']}, rank {cfg['rank']}")

    iterations = int(cfg["iterations"])
    spans: List[Tuple[int, int]] = []
    if session is not None:
        session.start()
    w0 = time.perf_counter()
    while True:
        c0 = time.time_ns()
        U, V = call(iterations)
        spans.append((c0, time.time_ns()))
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if session is not None:
        session.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    n_calls = len(spans)
    log(f"window {window_s:.3f} s: {n_calls} trains of {iterations} "
        f"iterations")

    result = {"attempted": n_calls, "failed": 0,
              "memory_peak_bytes": peak}
    if trace:
        t = time.perf_counter()
        ops = session.ops()
        if not ops:
            raise RuntimeError("the traced window recorded no device "
                               "operation: no per-layer metric can be read")
        log(f"trace: {len(ops)} device operations, the first "
            f"{(ops[0].start_ns - session.start_ns) / 1e6:.3f} ms after "
            f"the window's start, the last ending "
            f"{(session.end_ns - ops[-1].end_ns) / 1e6:.3f} ms before its "
            f"end; read in {time.perf_counter() - t:.3f} s")
        busy = tracing.busy_seconds(ops, session.start_ns, session.end_ns)
        ctx = LayerContext(ops, window_s, busy, n_calls, cfg,
                           peaks_for(device))
        result["metrics"] = layer_metrics(cell, ctx)
        result["busy_s"] = busy
        result["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": tracing.top(tracing.device_op_totals(ops)),
            "idle_gaps": tracing.top(tracing.idle_gap_totals(
                ops, session.start_ns, session.end_ns, spans))}
        del ops, ctx, session
    else:
        rate = n_calls * int(cfg["n_ratings"]) * iterations / window_s
        values = {"train_ratings_per_s": rate, "setup_s": setup_s}
        result["metrics"] = {name: {"value": values[name], "unit": unit}
                             for name, unit in cell.end_to_end.items()}

    # correct: the layouts first (the program's own state), then, with
    # that state freed, the factors against the reference
    sides = ref.layouts(*coo, int(cfg["n_users"]), int(cfg["n_items"]))
    numbers = layout_numbers(layout, sides)
    del layout, call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers.update(factor_numbers(cfg, coo, u0, v0, U, V, ref, sides))
    result["correct"], result["checks"] = compare.judged(
        numbers, cell.limits["limits"])
    return result
