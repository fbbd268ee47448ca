"""The pass registry (the torch form of
``predictionio_tpu/tools/analyze/passes/__init__.py``).

Each pass module defines ``PASS = Pass(name, rules, doc, run)`` where
``run(modules) -> list[Finding]`` walks the shared parsed module set
from :mod:`..walker`. Passes are pure functions of the source tree — no
torch import, no device, no network — so ``pio lint`` is safe to run
anywhere a checkout exists.

The reference's seven passes, in its order. ``jit-purity`` and
``aot-registration`` hold, in torch terms, the device entry points
registered with the warm-up (``serving/aot.register_entry``) rather than
jit-traced bodies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

from predictionio_tpu_torch.tools.analyze.findings import Finding
from predictionio_tpu_torch.tools.analyze.walker import Module


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    rules: Tuple[str, ...]
    doc: str            # one line for `pio lint --list` / README table
    run: Callable[[Sequence[Module]], List[Finding]]


def all_passes() -> List[Pass]:
    """Every registered pass, in the reference's report order."""
    from predictionio_tpu_torch.tools.analyze.passes import (
        aot_registration, debug_surface, declarations, host_sync,
        jit_purity, lock_order, timing,
    )
    return [m.PASS for m in (
        timing, host_sync, jit_purity, lock_order, declarations,
        aot_registration, debug_surface)]
