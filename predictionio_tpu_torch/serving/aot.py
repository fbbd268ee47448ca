"""The warm-up before ``/readyz`` (the torch form of
``predictionio_tpu/serving/aot.py``).

The reference compiles every (padding bucket, k) serving program ahead of
time, because XLA compiles per shape and the first query at a new shape
would wait for a compile. The port compiles nothing per shape. What a
first call costs on the card is the kernel library's build (``nvcc`` on
``csrc/<name>.cu`` when the library is missing or older than its source)
and its load into the process, and the first launch of each kernel. The
warm-up moves all of that off the request path: before ``/readyz`` says
ready, the deploy

- launches B1 + B2 once for every bucket the batcher can flush
  (``aot_serving_programs`` on the algorithm; a model served on the host
  contributes nothing; a row-sharded one launches B1 once per shard and
  one B2, ``parallel/serve_dist.py::sharded_program_specs``), and the
  inline path once;
- launches kernel A once for every fold-in bucket when fold-in is on
  (``realtime/foldin.py::solve_programs``);
- then marks the device watch's serving warmup done, so a kernel build
  or load on the serving path afterwards is the alarm
  (``pio_xla_post_warmup_recompiles_total``).

The bucket set is the batcher's, capped at its max batch size. Every
bucket is warmed: a bucket changes only the grid of the same B1 / B2
launch, so the reference's pruning by observed flush sizes
(``PIO_AOT_PRUNE``) has nothing to save here. One k is warmed
(``WARM_K``): B1's and B2's template instantiations are chosen by the
tile and the merge's list count, never by k, so one k loads every
instantiation a deploy launches (``PIO_AOT_KS`` is inert).

Mode: ``ServerConfig.aot`` "on" warms always, "off" never, "auto" on the
card only: on the CPU there is nothing to build (the kernels' plain
versions run there), so an "auto" deploy on the CPU is byte-identical to
one without the warm-up. ``PIO_AOT=0/1`` overrides. A failed warm-up
launch fails the deploy: nothing falls back to a lazy first call.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch, telemetry
from predictionio_tpu_torch.serving import protocol

logger = logging.getLogger("predictionio_tpu_torch.aot")


def enabled(mode: str = "auto", device: device_mod.DeviceLike = None
            ) -> bool:
    """Does this deploy warm up? ``PIO_AOT`` overrides the ServerConfig
    mode (0 = off, 1 = on); "auto" warms on the card only."""
    env = os.environ.get("PIO_AOT", "")
    if env == "0":
        return False
    if env == "1":
        return True
    m = (mode or "auto").lower()
    if m not in ("auto", "on", "off"):
        raise ValueError(f"aot mode must be auto/on/off, got {mode!r}")
    if m == "auto":
        return device_mod.resolve(device).type == "cuda"
    return m == "on"


#: the k of the warm-up's launches (the reference's default k set)
WARM_K = 10


def warm_k(n_items: int) -> int:
    """``WARM_K`` clamped to the catalog, as the query path clamps
    ``min(num, n_items)``."""
    return max(1, min(WARM_K, int(n_items)))


def serve_buckets(max_batch_size: Optional[int] = None) -> Tuple[int, ...]:
    """The configured buckets, capped at the batcher's max batch size; at
    least one bucket survives."""
    buckets = protocol.pad_buckets()
    if max_batch_size:
        capped = tuple(b for b in buckets if b <= int(max_batch_size))
        if capped:
            buckets = capped
    return buckets


# ---------------------------------------------------------------------------
# programs and the warm-up
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Program:
    """One device call the deploy will make: ``run`` makes it once on
    inputs of exactly the shapes a query or a tick gives it, ending in a
    host copy of its result."""
    name: str
    run: Callable[[], Any]


def algorithm_programs(algo: Any, model: Any,
                       buckets: Iterable[int]) -> List[Program]:
    """The algorithm's serving calls (its optional
    ``aot_serving_programs(model, buckets)`` hook); an algorithm without
    the hook, or that serves on the host, contributes nothing."""
    hook = getattr(algo, "aot_serving_programs", None)
    if hook is None:
        return []
    return list(hook(model, tuple(buckets)))


def prebuild(programs: Iterable[Program],
             device: device_mod.DeviceLike = None) -> Dict[str, Any]:
    """Run every program once, in order on the current stream, then
    synchronize the card and mark the serving warmup done. A failure
    raises: the deploy fails rather than leave a build or a first launch
    behind a query. Returns the summary ``GET /`` serves."""
    programs = list(programs)
    reg = telemetry.registry()
    m_programs = reg.counter(
        "pio_aot_programs_total",
        "Warmed-up device programs by outcome",
        labelnames=("status",))
    t0 = time.perf_counter()
    for p in programs:
        with devicewatch.attribution(p.name, phase="aot"):
            p.run()
        m_programs.labels(status="primed").inc()
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    reg.gauge(
        "pio_aot_prebuild_seconds",
        "Wall-clock of the most recent warm-up").labels().set(seconds)
    devicewatch.mark_serving_warmup_done()
    logger.info("warm-up: %d device program(s) in %.3fs", len(programs),
                seconds)
    return {"programs": len(programs), "prebuildS": round(seconds, 3)}
