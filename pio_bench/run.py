"""Run one cell of the port's benchmark once.

    python3 pio_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout with ``BENCHMARK.json``. The cell's driver
(``drivers/<kind>.py``) sets up, warms up, measures for ``--seconds``
and checks the timed path's output against the plain reference. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers are the last lines
of standard error. Without as many CUDA cards as the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.

The program's kernel build and compile caches, and the bytecode of what a
run imports, are pinned inside the checkout (``pio_bench/_build/``), so
only a checkout's first run builds them.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "pio_bench" / "_build"

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")


def pin_caches() -> None:
    """The program's build caches under ``BUILD``, and there too the
    bytecode of every module this process imports from here on (``torch``
    first): written on a checkout's first run, even where the environment
    says to write none, and read by every run after it, so that no run
    compiles torch's sources again."""
    sys.pycache_prefix = str(BUILD / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PIO_TORCH_KERNEL_DIR"] = str(BUILD / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def card(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not read ({exc})"
    return out.stdout.strip() or f"nvidia-smi exited {out.returncode}"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    pin_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from pio_bench import manifest

    cell = manifest.load_cell(ROOT, args.workload)
    marks = [("start", time.perf_counter())]
    import torch

    marks.append(("torch import", time.perf_counter()))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible: no result")
        return 2
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    marks.append(("card start", time.perf_counter()))
    out = manifest.driver(cell).run(cell, args.seed, args.seconds,
                                    bool(args.trace), device, _T0, log=log,
                                    marks=marks)
    log(f"card: {card()} ({torch.cuda.get_device_name(device)}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    loaded = forbidden_modules(sys.modules)
    if loaded:
        log(f"modules of JAX or the JAX package are loaded: {loaded}; "
            "no result")
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": dev}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} against limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
