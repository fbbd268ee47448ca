"""The readings each limit of a cell is set from, taken in one process.

    python3 pio_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--out readings.jsonl]

For every seed: the inputs and the program's layout as a run makes them,
one program train of the configuration's iterations, and the numbers a
run compares (the ``sound`` readings). For every control seed besides:
the control (the reference put in the program's place, in TF32: one
precision below the configuration's fp32) and each fault of
``faults.py`` planted in the program, each with the same numbers. One
JSON line per reading, on standard output and appended to ``--out``.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def read(cell, seeds, controls, device, emit) -> None:
    """Call ``emit(seed, kind, numbers, **timings)`` for every reading."""
    import torch

    from pio_bench import data, faults, manifest

    drv = manifest.driver(cell)
    cfg = cell.config
    ref = drv.reference_module(cfg)
    iterations = int(cfg["iterations"])

    def program(seed, coo, u0, v0, sides, kind="sound"):
        layout = drv.build_layout(cfg, coo, device)
        t = time.perf_counter()
        U, V = drv.program_call(cfg, layout, u0, v0, device)(iterations)
        train_s = time.perf_counter() - t
        numbers = drv.layout_numbers(layout, sides)
        del layout
        t = time.perf_counter()
        numbers.update(drv.factor_numbers(cfg, coo, u0, v0, U, V, ref,
                                          sides))
        emit(seed, kind, numbers, train_s=train_s,
             reference_s=time.perf_counter() - t)

    for seed in seeds:
        coo, (u0, v0) = data.inputs(cfg, seed, device)
        sides = ref.layouts(*coo, int(cfg["n_users"]), int(cfg["n_items"]))
        program(seed, coo, u0, v0, sides)
        if seed not in controls:
            continue
        t = time.perf_counter()
        Uc, Vc = ref.train(u0, v0, *sides, iterations, float(cfg["lambda"]),
                           "tf32")
        # the control lays the ratings out with the reference's own sort
        numbers = {"layout": 0.0}
        numbers.update(drv.factor_numbers(cfg, coo, u0, v0, Uc, Vc, ref,
                                          sides))
        emit(seed, "control_tf32", numbers,
             control_s=time.perf_counter() - t)
        del Uc, Vc
        for kind in faults.KINDS:
            with faults.planted(kind):
                program(seed, coo, u0, v0, sides, kind=f"fault_{kind}")
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from pio_bench import run as run_mod
    run_mod.pin_caches()
    import torch

    from pio_bench import manifest

    cell = manifest.load_cell(ROOT, args.workload)

    def emit(seed, kind, numbers, **extra):
        line = json.dumps({"workload": cell.name, "seed": seed,
                           "kind": kind, "numbers": numbers, **extra})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    read(cell, [int(s) for s in args.seeds.split(",")],
         {int(s) for s in args.control_seeds.split(",") if s},
         torch.device("cuda"), emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
