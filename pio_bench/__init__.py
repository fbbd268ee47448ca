"""The benchmark of the PyTorch/CUDA port (``predictionio_tpu_torch``).

``python3 pio_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line last. Everything a cell needs is found by
name, so a later cell, configuration or per-layer metric is new files
and new entries only:

- ``configs/<config>.json``: the configuration as it is run (sizes,
  hyper-parameters, the skew assumed, the reference that judges it);
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
  ``drivers/<kind>.py``;
- ``limits/<cell>.json``: each number the cell's ``correct`` compares,
  with its limit and the readings it was set from;
- ``layer_metrics/<metric>.py``: one reader per per-layer metric;
- ``roofline/<kernel>.py``: the operations and bytes one kernel's work
  needs, counted from the shapes.

Nothing here imports ``jax`` or the JAX package, and ``reference/``
imports nothing of the port either.
"""
