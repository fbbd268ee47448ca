"""Static analysis of the port: the reference's lint passes that have a
torch meaning (the torch form of ``predictionio_tpu/tools/analyze``).

- :mod:`walker` discovers and parses every analyzed module ONCE
  (``predictionio_tpu_torch/`` + ``chip_smoke.py``) — coverage is
  automatic for every future module, opt-OUT instead of opt-in.
- :mod:`findings` defines the finding record (rule id, file:line, fix
  hint, stable baseline key) and the port's checked-in suppression
  baseline (``lint_baseline.json`` beside this file).
- :mod:`passes` holds the pass registry: timing, host-sync, lock-order,
  declarations and debug-surface; each walks the shared module set and
  yields findings.
- :mod:`runner` runs the whole thing (``pio lint``, text or ``--json``;
  exit 0 clean / 1 findings / 2 internal error).
- :mod:`runtime` is the dynamic half of the lock-order pass: a lock
  proxy that records the REAL acquisition order of a live deploy.

Everything here is stdlib-only (ast + os + json): ``pio lint`` runs in a
checkout without importing torch or touching a device.
"""

from predictionio_tpu_torch.tools.analyze.findings import Baseline, Finding
from predictionio_tpu_torch.tools.analyze.runner import run_lint

__all__ = ["Baseline", "Finding", "run_lint"]
