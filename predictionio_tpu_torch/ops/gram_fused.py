"""Kernel G: the ALS Gram and right-hand side in one hand-written pass on
the card (``csrc/gram_fused.cu``), and the plan of pieces it walks.

For every row s of one side, ``A_s = sum_n a_n v_n v_n^T`` and ``b_s =
sum_n b_n v_n`` over the row's entries, ``v_n`` the other side's factor
row ``other_idx[n]``. ``ops/als.py::gram_rhs`` launches it for a CUDA
tensor; its plain version (``als.gram_rhs_plain``) runs on the CPU.

The plan (:func:`plan`) cuts each row's run of a sorted ``self_idx`` into
pieces of at most :data:`PIECE` entries. A row with no entry is one
empty piece, so the kernel writes every row; padding entries
(``self_idx == n_self``) belong to no piece and are never read. The
schedule lists the pieces of the longest rows first. Each piece of a row
of several pieces has a slot in a scratch buffer; ``gram_finish`` sums a
row's slots in piece order. Every sum runs in an order fixed by the
plan, with no atomics, so two runs give the same bits.

A trainer builds its plan once per layout (``exact=True``: one host
sync, in set-up, for the piece count its span reports). A caller that
passes none gets one built on the device from host-known shapes alone:
its arrays are sized for the most pieces ``nnz`` entries over ``n_self``
rows can need, and the unused slots are skipped. A fold-in tick, whose
rows are capped below :data:`PIECE`, builds it so with ``max_row``: one
piece a row, no scratch and no finishing pass.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Tuple

import torch

from predictionio_tpu_torch.ops import _kernels

#: most entries one piece sums (the plain Gram's ``_PIECE`` too)
PIECE = 512

#: kernel launches since the last reset (the main path's proof that it
#: went through kernel G): one per Gram, plus one for the pass that sums
#: rows of several pieces where a plan has any; bumped only at a launch
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


@dataclass
class GramPieces:
    """Kernel G's work plan over one sorted ``self_idx``, on its device.

    The ``piece_*`` arrays are in row order (a row's pieces by start);
    ``schedule`` is the launch order, the pieces of the longest rows
    first. ``multi_*`` list the rows of several pieces with their first
    scratch slot and slot count. ``pieces``, ``entries`` and ``multi``
    are host integers where the plan was built exactly, else None (then
    unused slots carry ``piece_row`` -1 and ``multi_row`` -1)."""
    n_self: int
    nnz: int                     # entries of the layout, padding included
    piece_row: torch.Tensor      # (P,) int32
    piece_start: torch.Tensor    # (P,) int64
    piece_len: torch.Tensor      # (P,) int32
    piece_part: torch.Tensor     # (P,) int32, -1: the row is one piece
    schedule: torch.Tensor       # (P,) int32 piece ids
    multi_row: torch.Tensor      # (M,) int32
    multi_first: torch.Tensor    # (M,) int32
    multi_count: torch.Tensor    # (M,) int32
    n_parts: int                 # scratch slots (a bound where not exact)
    pieces: "int | None" = None
    entries: "int | None" = None
    multi: "int | None" = None

    @property
    def slots(self) -> int:
        return int(self.piece_row.shape[0])

    @property
    def finishes(self) -> bool:
        """Whether a Gram over this plan runs the pass that sums rows of
        several pieces (a second launch)."""
        return (self.slots > 0 and self.n_parts > 0
                and int(self.multi_row.shape[0]) > 0 and self.multi != 0)


def plan(self_idx: torch.Tensor, n_self: int, exact: bool = True,
         max_row: "int | None" = None) -> GramPieces:
    """The pieces of a nondecreasing ``self_idx`` (rows in [0, n_self],
    padding at ``n_self``), built with torch ops on its device.
    ``exact=False`` reads nothing back to the host; there a caller whose
    rows hold at most ``max_row`` <= :data:`PIECE` entries (a fold-in
    tick's history cap) gets one piece a row and no finishing pass."""
    s = self_idx.contiguous()
    dev = s.device
    nnz = int(s.shape[0])
    i32, i64 = torch.int32, torch.int64
    if n_self == 0:
        e32 = torch.empty((0,), dtype=i32, device=dev)
        return GramPieces(
            n_self=0, nnz=nnz, piece_row=e32, piece_start=e32.to(i64),
            piece_len=e32, piece_part=e32, schedule=e32, multi_row=e32,
            multi_first=e32, multi_count=e32, n_parts=0, pieces=0,
            entries=0, multi=0)
    bounds = torch.searchsorted(
        s, torch.arange(n_self + 1, device=dev, dtype=s.dtype))
    length = bounds[1:] - bounds[:-1]                       # (n_self,)
    if not exact and max_row is not None and max_row <= PIECE:
        # piece k is row k, the longest rows first: no scratch
        e32 = torch.empty((0,), dtype=i32, device=dev)
        return GramPieces(
            n_self=n_self, nnz=nnz,
            piece_row=torch.arange(n_self, dtype=i32, device=dev),
            piece_start=bounds[:-1].to(i64), piece_len=length.to(i32),
            piece_part=torch.full((n_self,), -1, dtype=i32, device=dev),
            schedule=torch.sort(length, descending=True,
                                stable=True).indices.to(i32),
            multi_row=e32, multi_first=e32, multi_count=e32, n_parts=0)
    per_row = torch.clamp((length + PIECE - 1) // PIECE, min=1)
    cum = torch.cumsum(per_row, 0)
    first = cum - per_row                  # a row's first piece id
    multi = per_row > 1
    in_parts = torch.where(multi, per_row, torch.zeros_like(per_row))
    part_cum = torch.cumsum(in_parts, 0)
    part_first = part_cum - in_parts
    if exact:
        n_pieces, n_parts, n_entries = (int(x) for x in torch.stack(
            [cum[-1], part_cum[-1], bounds[-1]]).cpu().numpy())
    else:
        # every row is at least one piece and only a row past PIECE
        # entries is more, ceil(l / PIECE) <= l / PIECE + 1 <= 2 l / PIECE
        # pieces: so sum max(1, ceil(l / PIECE)) <= n_self + nnz // PIECE,
        # and the rows of several pieces take at most 2 nnz / PIECE slots
        n_pieces = n_self + nnz // PIECE
        n_parts = 2 * nnz // PIECE if nnz > PIECE else 0
    k = torch.arange(n_pieces, device=dev, dtype=i64)
    row = torch.searchsorted(cum, k, right=True)
    valid = row < n_self
    rowc = torch.clamp(row, max=n_self - 1)
    j = k - first[rowc]
    start = bounds[rowc] + j * PIECE
    plen = torch.clamp(torch.clamp(bounds[rowc + 1] - start, max=PIECE),
                       min=0)
    none = torch.full_like(k, -1)
    piece_row = torch.where(valid, row, none)
    piece_part = torch.where(valid & multi[rowc], part_first[rowc] + j, none)
    # the schedule: rows by length, longest first (ties by row), each
    # row's pieces in order; slots past the last piece stay last
    order = torch.sort(length, descending=True, stable=True).indices
    per_o = per_row[order]
    cum_o = torch.cumsum(per_o, 0)
    pos = torch.searchsorted(cum_o, k, right=True)
    posc = torch.clamp(pos, max=n_self - 1)
    schedule = torch.where(
        pos < n_self, first[order[posc]] + k - (cum_o[posc] - per_o[posc]),
        k)
    rows = torch.arange(n_self, device=dev, dtype=i64)
    if exact:
        m = multi.nonzero().flatten()
        multi_row, multi_first, multi_count = rows[m], part_first[m], \
            per_row[m]
    else:
        multi_row = torch.where(multi, rows, torch.full_like(rows, -1))
        multi_first, multi_count = part_first, per_row
    return GramPieces(
        n_self=n_self, nnz=nnz, piece_row=piece_row.to(i32),
        piece_start=start.to(i64), piece_len=plen.to(i32),
        piece_part=piece_part.to(i32), schedule=schedule.to(i32),
        multi_row=multi_row.to(i32), multi_first=multi_first.to(i32),
        multi_count=multi_count.to(i32), n_parts=n_parts,
        pieces=n_pieces if exact else None,
        entries=n_entries if exact else None,
        multi=int(multi_row.shape[0]) if exact else None)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _kernels.load("gram_fused")
    fn = lib.pio_gram_pieces
    if fn.argtypes is None:
        c, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [c, c, i, c, c, c, c, c, i, i, c, c, c, c, c, i, c]
        fn.restype = i
        fin = lib.pio_gram_finish
        fin.argtypes = [c, c, c, c, i, c, c, i, c]
        fin.restype = i
    return lib


def _copy_bytes(V: torch.Tensor, r: int) -> int:
    """The widest cp.async copy (16, 8 or 4 bytes) that every factor row's
    start and length allow."""
    for width in (16, 8):
        if (r * 4) % width == 0 and V.data_ptr() % width == 0:
            return width
    return 4


def launch(other_factors: torch.Tensor, other_idx: torch.Tensor,
           coeff_a: torch.Tensor, coeff_b: torch.Tensor,
           pieces: GramPieces) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (n_self, r, r) and b (n_self, r), contiguous, by kernel G on the
    inputs' card. ``other_idx`` (int32 or int64) must hold in-bounds rows
    of ``other_factors`` at every entry a piece covers."""
    global launches
    V = other_factors
    dev = V.device
    n_other, r = V.shape
    nnz = int(other_idx.shape[0])
    for name, t, dtype, shape in (
            ("other_factors", V, torch.float32, (n_other, r)),
            ("coeff_a", coeff_a, torch.float32, (nnz,)),
            ("coeff_b", coeff_b, torch.float32, (nnz,))):
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected a {dtype} tensor of shape {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if other_idx.dtype not in (torch.int32, torch.int64) \
            or other_idx.device != dev:
        raise ValueError(f"other_idx: expected int32 or int64 on {dev}, got "
                         f"{other_idx.dtype} on {other_idx.device}")
    if pieces.piece_row.device != dev or pieces.nnz != nnz:
        raise ValueError(
            f"the plan covers {pieces.nnz} entries on "
            f"{pieces.piece_row.device}, the call {nnz} on {dev}")
    for name, t in (("other_factors", V), ("other_idx", other_idx),
                    ("coeff_a", coeff_a), ("coeff_b", coeff_b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_self = pieces.n_self
    A = torch.empty((n_self, r, r), dtype=torch.float32, device=dev)
    b = torch.empty((n_self, r), dtype=torch.float32, device=dev)
    if pieces.slots == 0:                 # no rows: nothing to write
        return A, b
    has_multi = pieces.finishes
    parts = torch.empty((pieces.n_parts if has_multi else 0, r * r + r),
                        dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pio_gram_pieces(
        V.data_ptr(), other_idx.data_ptr(),
        int(other_idx.dtype == torch.int64), coeff_a.data_ptr(),
        coeff_b.data_ptr(), A.data_ptr(), b.data_ptr(), parts.data_ptr(), r,
        _copy_bytes(V, r), pieces.schedule.data_ptr(),
        pieces.piece_row.data_ptr(), pieces.piece_start.data_ptr(),
        pieces.piece_len.data_ptr(), pieces.piece_part.data_ptr(),
        pieces.slots, stream)
    if err != 0:
        raise RuntimeError(f"gram_fused kernel launch failed: CUDA error "
                           f"{err}")
    n_launched = 1
    if has_multi:
        err = lib.pio_gram_finish(
            parts.data_ptr(), pieces.multi_row.data_ptr(),
            pieces.multi_first.data_ptr(), pieces.multi_count.data_ptr(),
            int(pieces.multi_row.shape[0]), A.data_ptr(), b.data_ptr(), r,
            stream)
        if err != 0:
            raise RuntimeError(f"gram_fused finish launch failed: CUDA "
                               f"error {err}")
        n_launched += 1
    with _count_lock:
        launches += n_launched
    return A, b


def launches_per_gram(pieces: GramPieces) -> int:
    """Kernel launches one Gram over ``pieces`` makes (:data:`launches`
    counts them)."""
    return 0 if pieces.slots == 0 else 1 + int(pieces.finishes)
