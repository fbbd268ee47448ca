"""WorkflowContext — the SparkContext analogue (port of
``predictionio_tpu/workflow/context.py``).

One context per run. It owns the WorkflowParams (batch label), the
Storage handle engines read events
through, the device the run trains on (``device.resolve``: the card
unless the caller asks for the CPU), and the per-phase wall-clock table
that ``run_train`` stores in the EngineInstance row. Single process: the
reference's mesh and multi-host fields have no counterpart yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.data.storage import Storage, get_storage


@dataclasses.dataclass
class WorkflowParams:
    """WorkflowParams.scala's batch label; its verbosity, sanity-check
    skip and stop-after flags have no caller in the port yet."""
    batch: str = ""


class WorkflowContext:
    def __init__(
        self,
        workflow_params: Optional[WorkflowParams] = None,
        storage: Optional[Storage] = None,
        device: device_mod.DeviceLike = None,
    ):
        self.workflow_params = workflow_params or WorkflowParams()
        self._storage = storage
        self.device = device_mod.resolve(device)
        #: iteration-checkpoint directory (set by run_train)
        self.checkpoint_dir: Optional[str] = None
        self.phase_seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate one named phase's wall-clock. On the card the clock
        stops after a synchronize, so a phase owns the device work it
        queued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.note_phase(name, time.perf_counter() - t0)

    def note_phase(self, name: str, seconds: float) -> None:
        """Accumulate an externally timed (sub-)phase, e.g. the read's
        read_io / read_encode split."""
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + seconds

    @property
    def storage(self) -> Storage:
        return self._storage if self._storage is not None else get_storage()
