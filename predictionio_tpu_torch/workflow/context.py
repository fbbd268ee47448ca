"""WorkflowContext — the SparkContext analogue (port of
``predictionio_tpu/workflow/context.py``).

One context per run. It owns the WorkflowParams (batch label), the
Storage handle engines read events
through, the device the run trains on (``device.resolve``: the card
unless the caller asks for the CPU), the mesh a sharded train runs over
(``parallel.mesh.Mesh``; None trains on one device), and the per-phase
wall-clock table that ``run_train`` stores in the EngineInstance row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch, telemetry
from predictionio_tpu_torch.data.storage import Storage, get_storage


@dataclasses.dataclass
class WorkflowParams:
    """WorkflowParams.scala's batch label, and ``profile_dir`` (``pio
    train --profile DIR``: a torch.profiler capture of the train); its
    verbosity, sanity-check skip and stop-after flags have no caller in
    the port yet."""
    batch: str = ""
    profile_dir: Optional[str] = None


class WorkflowContext:
    def __init__(
        self,
        workflow_params: Optional[WorkflowParams] = None,
        storage: Optional[Storage] = None,
        device: device_mod.DeviceLike = None,
        mesh=None,
    ):
        self.workflow_params = workflow_params or WorkflowParams()
        self._storage = storage
        self.device = (mesh.local_device if mesh is not None
                       else device_mod.resolve(device))
        #: the train's mesh (``pio train --devices`` / ``--coordinator``)
        self.mesh = mesh
        #: iteration-checkpoint directory (set by run_train)
        self.checkpoint_dir: Optional[str] = None
        #: did the training read stream (set by the data source's read;
        #: run_train records it as ``runtime_conf["train_stream"]``)
        self.train_stream = False
        self.phase_seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate one named phase's wall-clock. On the card the clock
        stops after a synchronize, so a phase owns the device work it
        queued. A kernel build or load inside the phase is attributed to
        it (``pio_xla_compiles_total{fn="train:<phase>"}``) unless a
        narrower region, a trainer's, claims it first."""
        t0 = time.perf_counter()
        try:
            with devicewatch.attribution(f"train:{name}", phase="train"):
                yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.note_phase(name, time.perf_counter() - t0)

    def note_phase(self, name: str, seconds: float) -> None:
        """Accumulate an externally timed (sub-)phase, e.g. the read's
        read_io / read_encode split, into the phase table and, under
        ``PIO_TELEMETRY=1``, ``pio_train_phase_seconds{phase}``."""
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + seconds
        if telemetry.on():
            telemetry.registry().histogram(
                "pio_train_phase_seconds",
                "Train/eval phase wall-clock (read/layout/train/persist "
                "+ read_io/read_encode sub-phases; on the card each ends "
                "after a synchronize)",
                labelnames=("phase",),
                buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
                         30.0, 60.0, 300.0)).labels(
                phase=name).observe(seconds)

    @property
    def storage(self) -> Storage:
        return self._storage if self._storage is not None else get_storage()
