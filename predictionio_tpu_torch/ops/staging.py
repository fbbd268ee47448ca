"""Read-to-device overlap: copy columnar event chunks to the device while
later chunks are still decoding (port of ``predictionio_tpu/ops/staging.py``
in torch terms).

The bulk train read (``eventlog.read_columns_streamed``, the synthetic
generator's ``chunks()``) yields per-chunk code arrays as decode workers
finish. :class:`ColumnStager` copies each chunk to the device the moment
it arrives: on the card, the chunk goes through pinned host memory and a
``non_blocking`` copy on a copy stream of its own, so the copy of chunk
*k* runs while chunk *k+1* is still decoding. ``finalize`` joins the copy
stream, then does the dense-vocab remap on the device (a LUT gather,
``where(code >= 0, lut[clamp(code, 0)], -1)``) and one concatenate,
producing device-resident mirrors of the host columns.

These are plain torch ops: the JAX package has no kernel here either.

Correctness contract: the staged tensors are **value-identical** to the
host columns ``store.find_columnar`` returns: the device remap runs the
same integer ops on the same inputs, and the float32 ratings pass
through untouched. ``ops/als.prepare_ratings`` accepts the staged tensors
directly, so layouts (and therefore models) are bit-identical to the
unstaged path. Staging engages only when both vocabularies grow (no rows
dropped); ``PIO_READ_STAGE=0`` turns it off.

Lifetime of the pinned buffers: a chunk's pinned host buffer stays
referenced by its :class:`StagedColumns` until :meth:`StagedColumns.release`
waits on the copy stream's last event (the layout phase calls it; it
synchronizes before it stops its clock anyway). Nothing here blocks the
host: the read's clock stops when decode ends.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import telemetry

#: chunks copied to a device by any ColumnStager in this process (the
#: smoke reads it to show that a warm retrain staged nothing)
copies = 0


def staging_available() -> bool:
    """Staging is on unless ``PIO_READ_STAGE=0``."""
    return os.environ.get("PIO_READ_STAGE", "1") != "0"


@dataclass
class StagedColumns:
    """Device-resident mirrors of ColumnarEvents' encoded arrays."""
    entity_idx: torch.Tensor       # (n,) int32, == ColumnarEvents.entity_idx
    target_idx: torch.Tensor       # (n,) int32
    event_name_idx: torch.Tensor   # (n,) int32
    rating: torch.Tensor           # (n,) float32
    #: pinned host buffers whose copies may still be in flight, and the
    #: copy stream's event after the last of them
    _hold: List[torch.Tensor] = field(default_factory=list, repr=False)
    _done: Optional[torch.cuda.Event] = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return int(self.entity_idx.shape[0])

    def release(self) -> None:
        """Wait for the last staged copy and drop the pinned buffers."""
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        self._hold.clear()

    def training_view(self, buy_pos: Optional[int], buy_rating: float):
        """(entity_idx, target_idx, rating') with the template's buy->rating
        mapping applied on the device (recommendation.data_source's
        ``training_data_from_columnar``)."""
        r = self.rating
        if buy_pos is not None:
            r = torch.where(self.event_name_idx == buy_pos,
                            torch.tensor(buy_rating, dtype=torch.float32,
                                         device=r.device), r)
        return self.entity_idx, self.target_idx, r


#: the staged chunk columns and their dtypes
_KEYS = (("entity_code", np.int32), ("target_code", np.int32),
         ("event_code", np.int32), ("rating", np.float32))


class ColumnStager:
    """Accumulates per-chunk raw code arrays on ``device`` during a
    streamed bulk read; :meth:`finalize` remaps and concatenates them
    into StagedColumns."""

    def __init__(self, device: device_mod.DeviceLike = None):
        self.device = device_mod.resolve(device)
        self._chunks: List[tuple] = []
        self._hold: List[torch.Tensor] = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def add(self, chunk: Dict[str, np.ndarray]) -> None:
        global copies
        host = [np.ascontiguousarray(chunk[k], dtype=dt) for k, dt in _KEYS]
        if self._stream is None:
            staged = tuple(torch.tensor(a) for a in host)
        else:
            # the device buffers belong to the current stream; the copy
            # stream waits for their allocation, and finalize makes the
            # current stream wait for the copies
            pinned = [torch.from_numpy(a).pin_memory() for a in host]
            staged = tuple(torch.empty_like(p, device=self.device)
                           for p in pinned)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for p, d in zip(pinned, staged):
                    d.copy_(p, non_blocking=True)
            self._hold += pinned
        self._chunks.append(staged)
        copies += 1
        if telemetry.on():
            reg = telemetry.registry()
            reg.counter(
                "pio_staging_chunks_total",
                "COO chunks staged to device during the overlapped read"
            ).labels().inc()
            reg.counter(
                "pio_staging_rows_total",
                "COO rows staged to device during the overlapped read"
            ).labels().inc(int(chunk["entity_code"].shape[0]))

    def finalize(self, e_lut: np.ndarray, t_lut: np.ndarray,
                 name_lut: np.ndarray) -> Optional[StagedColumns]:
        """Dense remap on the device with the host-built LUTs (the integer
        semantics of store._columnar_from_codes.dense); None when the read
        produced no rows."""
        if not self._chunks:
            return None
        t0 = time.perf_counter() if telemetry.on() else None
        done = None
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
            torch.cuda.current_stream(self.device).wait_event(done)

        def lut(a):
            return torch.tensor(np.asarray(a, np.int32), device=self.device)

        luts = (lut(e_lut), lut(t_lut), lut(name_lut))
        minus_one = torch.tensor(-1, dtype=torch.int32, device=self.device)
        cols: List[List[torch.Tensor]] = [[], [], [], []]
        # consume the chunk list front to back and drop each raw buffer as
        # its remap is queued: at most one chunk's raw codes coexist with
        # its remapped twin, so the device peak stays about 1x the COO.
        # The host indexes name_lut[-1] (its sentinel last slot, always
        # -1) for an uncoded event; the device spells the -1 out
        self._chunks.reverse()
        while self._chunks:
            *codes, r = self._chunks.pop()
            for out, c, table in zip(cols, codes, luts):
                out.append(torch.where(
                    c >= 0, table.index_select(0, c.clamp(min=0)),
                    minus_one))
            cols[3].append(r)
        staged = StagedColumns(
            *(c[0] if len(c) == 1 else torch.cat(c) for c in cols),
            _hold=self._hold, _done=done)
        self._hold = []
        if t0 is not None:
            # queueing time only: the copies and the remap are still in
            # flight, and land in the layout phase, which synchronizes
            telemetry.registry().histogram(
                "pio_staging_finalize_enqueue_seconds",
                "Device-side remap/concat ENQUEUE time (async; the real "
                "transfer cost lands in pio_train_phase_seconds{phase="
                "'layout'}, which ends in a synchronize)").labels(
            ).observe(time.perf_counter() - t0)
        return staged

