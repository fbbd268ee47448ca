"""Block-sharded ALS over a 1-D mesh of shard slots (port of
``predictionio_tpu/parallel/als_dist.py``).

Rows (users or items) are dealt to slots by the reference's
**capacity-constrained LPT deal** (:func:`_shard_side`): rows in
descending rating count go to the lightest slot that still has a free row
slot, at most ``ceil(n / n_slots)`` rows a slot. The padded factor
matrices stay within one row a slot of minimal, and each slot's rating
count stays close to ``nnz / n_slots`` under power-law data. The deal is
integer work and equals the reference's row for row.

A half-step is local to each slot: the slot runs the port's one Gram
(``ops.als.gram_rhs``) over its own rows against the whole of the other
side's factors, then kernel A (``ops.solve.solve_factors``) over its
``rows_dev`` systems. One gather per half-step re-replicates the side
just solved (``mesh.all_gather_blocks``: a concatenation between slots of
one process, a ``torch.distributed`` all_gather between ranks). So kernel
A runs once per slot per half-step.

Factors are seeded once, from one seed on every process, and scattered
into the padded address space, so a 1-slot and an n-slot run start from
identical factors; their results agree to fp32 summation order (the
tolerance class). Checkpoints share ``ops.als._run_segmented`` with the
single-device trainers: snapshots are canonical (n_users, rank) /
(n_items, rank) arrays, interchangeable between the two paths.

``kernel="hybrid"`` (the reference's ``_train_sharded_hybrid`` and
``HybridShard``: the Zipf head as dense MXU matmuls plus csrb tails) is a
TPU layout of the same per-row sums; under the settled "one Gram"
decision every ``PIO_ALS_KERNEL`` value runs the Gram above.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.common import devicewatch
from predictionio_tpu_torch.ops.als import (
    ALSData, COOSide, _half_step_explicit, _half_step_implicit,
    _kernel_flag, _run_segmented, _seed_factors, bucket_units, gram_plan,
)
from predictionio_tpu_torch.parallel.mesh import Mesh, all_gather_blocks

__all__ = [
    "ShardedSide", "PreshardedData", "shard_staged_coo", "prepare_sharded",
    "train_explicit_sharded", "train_implicit_sharded",
]


@dataclass
class ShardedSide:
    """One orientation of the ratings, laid out for ``n_dev`` slots.

    The flat arrays are ``(n_dev * nnz_dev,)``: slot d's entries are
    ``[d * nnz_dev, (d + 1) * nnz_dev)``. ``self_idx`` is slot-local
    (padding entries use ``rows_dev``, a dummy row); ``other_idx`` is in
    the opposite side's padded address space (``d * rows_dev + local``),
    so a half-step indexes the gathered factors directly. ``pos`` maps a
    global row to its padded address. A streamed layout
    (:func:`shard_staged_coo`) holds no flat arrays: ``local`` carries
    this process's slots' ``(self_idx, other_idx, rating, counts)``
    tensors on their device instead."""
    self_idx: Optional[np.ndarray]     # (n_dev * nnz_dev,) int32
    other_idx: Optional[np.ndarray]    # (n_dev * nnz_dev,) int32
    rating: Optional[np.ndarray]       # (n_dev * nnz_dev,) float32
    counts: Optional[np.ndarray]       # (n_dev * rows_dev,) int32
    pos: np.ndarray                    # (n_self,) global row -> address
    nnz_per_dev: np.ndarray            # (n_dev,) real ratings per slot
    rows_dev: int
    nnz_dev: int
    n_rows_pad: int
    local: Optional[Dict[int, Tuple[torch.Tensor, ...]]] = None


def _shard_side(side: COOSide, n_dev: int, chunk: int) -> ShardedSide:
    """The reference's deal, step for step (integer work: exact)."""
    row_counts = _host(side.counts)
    n_self = side.n_self
    rows_dev = max(-(-n_self // n_dev), 1)      # ceil
    n_rows_pad = rows_dev * n_dev

    # Capacity-constrained LPT deal: the Zipf head (n_dev * 64 hottest
    # rows) through a heap, the near-uniform tail serpentine-dealt in
    # vectorized full rounds over the slots ordered by load, and the
    # sub-round remainder through the heap again.
    order = np.argsort(-row_counts, kind="stable")
    loads = np.zeros(n_dev, dtype=np.int64)
    used = np.zeros(n_dev, dtype=np.int64)
    pos = np.empty(n_self, dtype=np.int32)

    def heap_deal(rows):
        heap = sorted((int(loads[d]), d) for d in range(n_dev)
                      if used[d] < rows_dev)
        for row in rows:
            while True:
                load, d = heapq.heappop(heap)
                if used[d] < rows_dev:
                    break
            pos[row] = d * rows_dev + used[d]
            used[d] += 1
            loads[d] = load + int(row_counts[row])
            if used[d] < rows_dev:
                heapq.heappush(heap, (int(loads[d]), d))

    head = min(n_self, n_dev * 64)
    heap_deal(order[:head])
    tail = order[head:]
    if tail.size:
        dev_order = np.argsort(loads, kind="stable")
        full_rounds = min(int(tail.size) // n_dev,
                          int((rows_dev - used).min()))
        bulk = full_rounds * n_dev
        if bulk:
            k = np.arange(bulk)
            rnd, sl = np.divmod(k, n_dev)
            seq = np.where(rnd % 2 == 0, sl, n_dev - 1 - sl)
            dseq = dev_order[seq]
            pos[tail[:bulk]] = (dseq * rows_dev + used[dseq] + rnd
                                ).astype(np.int32)
            np.add.at(loads, dseq, row_counts[tail[:bulk]].astype(np.int64))
            used += full_rounds
        heap_deal(tail[bulk:])

    # Regroup the (already self-sorted) real entries by padded address:
    # the address is slot-major, so one pack-sort groups by slot and
    # sorts by local row within each slot (gram_rhs's precondition).
    nnz_real = int(row_counts.sum())
    key = pos[_host(side.self_idx)[:nnz_real]]
    packed = (key.astype(np.int64) << 32) | np.arange(nnz_real,
                                                      dtype=np.int64)
    packed.sort()
    grouped_key = (packed >> 32).astype(np.int32)
    order2 = (packed & 0xFFFFFFFF).astype(np.int64)
    g_other = _host(side.other_idx)[:nnz_real][order2]
    g_rating = _host(side.rating)[:nnz_real][order2]

    bounds = np.searchsorted(
        grouped_key, np.arange(0, n_rows_pad + 1, rows_dev))
    nnz_per_dev = (bounds[1:] - bounds[:-1]).astype(np.int64)
    nnz_dev = int(max(nnz_per_dev.max(), 1))
    nnz_dev = bucket_units(-(-nnz_dev // chunk)) * chunk

    s = np.full((n_dev, nnz_dev), rows_dev, dtype=np.int32)  # pad: dummy
    o = np.zeros((n_dev, nnz_dev), dtype=np.int32)
    r = np.zeros((n_dev, nnz_dev), dtype=np.float32)
    counts = np.zeros(n_rows_pad, dtype=np.int32)
    counts[pos] = row_counts
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        m = hi - lo
        s[d, :m] = grouped_key[lo:hi] - d * rows_dev
        o[d, :m] = g_other[lo:hi]
        r[d, :m] = g_rating[lo:hi]
    return ShardedSide(
        self_idx=s.reshape(-1), other_idx=o.reshape(-1), rating=r.reshape(-1),
        counts=counts, pos=pos, nnz_per_dev=nnz_per_dev, rows_dev=rows_dev,
        nnz_dev=nnz_dev, n_rows_pad=n_rows_pad,
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


@dataclass
class PreshardedData:
    """The sharded COO assembled from the streamed read's staged device
    COO (:func:`shard_staged_coo`): both orientations live as per-slot
    device tensors, ``pos`` is the identity (a contiguous block deal),
    and no host copy of the ratings ever exists. The sharded trainers
    take it in place of :class:`~predictionio_tpu_torch.ops.als.ALSData`."""
    su: ShardedSide
    si: ShardedSide
    n_users: int
    n_items: int
    nnz: int


class _DeviceRouter:
    """Bounded routing of one side's entries to their slots: each slice
    of the staged COO splits by owning slot and moves to the slot's
    device as it is cut, so what transits at once is one slice."""

    def __init__(self, slots: List[int], devices):
        self._devices = devices
        self._parts: Dict[int, List[Tuple[torch.Tensor, ...]]] = {
            d: [] for d in slots}

    def add(self, dev_of: torch.Tensor, cols) -> None:
        for d, parts in self._parts.items():
            m = dev_of == d
            parts.append(tuple(c[m].to(self._devices[d]) for c in cols))

    def device_columns(self, d: int) -> Tuple[torch.Tensor, ...]:
        """Everything routed to slot ``d``, concatenated on its device."""
        parts = self._parts.pop(d)
        return tuple(torch.cat([p[k] for p in parts])
                     for k in range(len(parts[0])))


def _local_side_layout(s_local, other, rating, rows_dev: int, nnz_dev: int):
    """One slot's block: sort its (slot-local) rows stably, so within a
    row the entries keep arrival order as the in-core layout does; pad
    to the common width with the dummy row ``rows_dev``; count each
    row."""
    s, order = torch.sort(s_local, stable=True)
    extra = nnz_dev - int(s.shape[0])

    def pad(t, value):
        return torch.cat([t, t.new_full((extra,), value)])

    counts = torch.bincount(s_local.long(), minlength=rows_dev)[:rows_dev]
    return (pad(s, rows_dev), pad(other[order], 0), pad(rating[order], 0.0),
            counts.to(torch.int32))


def shard_staged_coo(mesh: Mesh, u_dev, i_dev, r_dev, n_users: int,
                     n_items: int, chunk: int = 1 << 16,
                     route_rows: int = 1 << 20) -> PreshardedData:
    """The sharded layout for the STREAMED train path: the staged COO is
    routed to the slots by contiguous row block (``row // rows_dev``, the
    degenerate LPT deal: the streamed read never holds the whole dataset
    on the host, which the deal needs), in slices of ``route_rows``, and
    each slot sorts and pads its block on its device. ``pos`` is the
    identity, so the factors need no permutation. Deterministic at any
    slot count (the slices keep the stream's order)."""
    nnz = int(u_dev.shape[0])
    n_dev = mesh.size
    slots = mesh.local_slots
    u_dev = torch.as_tensor(u_dev)
    i_dev = torch.as_tensor(i_dev)
    r_dev = torch.as_tensor(r_dev)

    def side(self_dev, other_dev, n_self):
        rows_dev = max(-(-n_self // n_dev), 1)
        dev_of_all = torch.clamp(self_dev.long() // rows_dev, max=n_dev - 1)
        per_dev = torch.bincount(dev_of_all, minlength=n_dev).cpu().numpy()
        nnz_dev = bucket_units(
            max(-(-int(max(per_dev.max(), 1)) // chunk), 1)) * chunk
        router = _DeviceRouter(slots, mesh.devices)
        for lo in range(0, nnz, route_rows):
            hi = min(nnz, lo + route_rows)
            dev_of = dev_of_all[lo:hi]
            local = (self_dev[lo:hi].long() - dev_of * rows_dev).to(
                torch.int32)
            router.add(dev_of, (local, other_dev[lo:hi].to(torch.int32),
                                r_dev[lo:hi].to(torch.float32)))
        local = {}
        for d in slots:
            s_c, o_c, r_c = router.device_columns(d)
            local[d] = _local_side_layout(s_c, o_c, r_c, rows_dev, nnz_dev)
        return ShardedSide(
            self_idx=None, other_idx=None, rating=None, counts=None,
            pos=np.arange(n_self, dtype=np.int32),
            nnz_per_dev=per_dev.astype(np.int64), rows_dev=rows_dev,
            nnz_dev=nnz_dev, n_rows_pad=rows_dev * n_dev, local=local)

    su = side(u_dev, i_dev, n_users)
    si = side(i_dev, u_dev, n_items)
    return PreshardedData(su=su, si=si, n_users=n_users, n_items=n_items,
                          nnz=nnz)


def prepare_sharded(data: ALSData, n_dev: int,
                    chunk: int = 1 << 16) -> Tuple[ShardedSide, ShardedSide]:
    """Shard both orientations and remap each side's other-side indices
    into the opposite side's padded address space. Padding entries carry
    other_idx 0, whose remap is a real address, but weight 0."""
    su = _shard_side(data.by_user, n_dev, chunk)
    si = _shard_side(data.by_item, n_dev, chunk)
    su.other_idx = si.pos[su.other_idx]
    si.other_idx = su.pos[si.other_idx]
    return su, si


def _slot_arrays(side: ShardedSide, d: int, device: torch.device):
    """Slot ``d``'s (self_idx, other_idx int64, rating, counts) on
    ``device``."""
    if side.local is not None:
        s, o, r, c = side.local[d]
        return (s.to(device), o.to(device, torch.int64),
                r.to(device, torch.float32), c.to(device))
    lo, hi = d * side.nnz_dev, (d + 1) * side.nnz_dev
    rlo, rhi = d * side.rows_dev, (d + 1) * side.rows_dev

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return (t(side.self_idx[lo:hi], torch.int32),
            t(side.other_idx[lo:hi], torch.int64),
            t(side.rating[lo:hi], torch.float32),
            t(side.counts[rlo:rhi], torch.int32))


def _pad_factors(F: torch.Tensor, pos: torch.Tensor,
                 n_rows_pad: int) -> torch.Tensor:
    out = torch.zeros((n_rows_pad, F.shape[1]), dtype=torch.float32,
                      device=F.device)
    return out.index_copy_(0, pos, F.to(torch.float32))


def _train_sharded(
    mesh: Mesh,
    data: "Union[ALSData, PreshardedData]",
    rank: int,
    iterations: int,
    lambda_: float,
    seed: int,
    chunk: int,
    reg_scaling: str,
    implicit: bool,
    alpha: float,
    u0,
    v0,
    checkpoint_every: Optional[int],
    checkpointer,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _kernel_flag(kernel)        # validated; every value runs one Gram
    if isinstance(data, PreshardedData):
        su, si = data.su, data.si
    else:
        su, si = prepare_sharded(data, mesh.size, chunk)
    dev = mesh.local_device
    slots = mesh.local_slots

    def slot_state(side: ShardedSide):
        out = {}
        for d in slots:
            s, o, r, c = _slot_arrays(side, d, dev)
            ch = max(min(chunk, int(s.shape[0])), 1)
            out[d] = (s, o, r, c, ch, gram_plan(s, ch))
        return out

    u_state, i_state = slot_state(su), slot_state(si)
    pos_u = torch.as_tensor(su.pos, dtype=torch.int64, device=dev)
    pos_i = torch.as_tensor(si.pos, dtype=torch.int64, device=dev)

    def half(other, side: ShardedSide, state):
        blocks = {}
        for d, (s, o, r, c, ch, plan) in state.items():
            if implicit:
                blocks[d] = _half_step_implicit(
                    other, s, o, r, c, side.rows_dev, lambda_, alpha, ch,
                    reg_scaling, plan)
            else:
                blocks[d] = _half_step_explicit(
                    other, s, o, r, c, side.rows_dev, lambda_, ch,
                    reg_scaling, plan)
        return all_gather_blocks(mesh, blocks)

    if u0 is None or v0 is None:
        u0, v0 = _seed_factors(int(seed), data.n_users, data.n_items, rank,
                               device=dev)

    def run(u, v, n_iters):
        U = _pad_factors(torch.as_tensor(u, device=dev), pos_u,
                         su.n_rows_pad)
        V = _pad_factors(torch.as_tensor(v, device=dev), pos_i,
                         si.n_rows_pad)
        with devicewatch.attribution(
                "als_train_implicit_sharded" if implicit
                else "als_train_explicit_sharded", phase="train"):
            for _ in range(n_iters):
                U = half(V, su, u_state)
                V = half(U, si, i_state)
        # every process holds the gathered factors: back to canonical
        # row order
        return U.index_select(0, pos_u), V.index_select(0, pos_i)

    return _run_segmented(run, _on(u0, dev), _on(v0, dev), iterations,
                          checkpoint_every, checkpointer, dev)


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def train_explicit_sharded(
    mesh: Mesh,
    data: "Union[ALSData, PreshardedData]",
    rank: int = 10,
    iterations: int = 10,
    lambda_: float = 0.01,
    seed: int = 3,
    chunk: int = 1 << 16,
    reg_scaling: str = "count",
    u0=None,
    v0=None,
    checkpoint_every: Optional[int] = None,
    checkpointer=None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ALS.train over ``mesh``'s slots, nnz-balanced blocks. Returns the
    canonical (n_users, rank) / (n_items, rank) factors on this
    process's device. Checkpoints as ``ops.als.train_explicit``."""
    return _train_sharded(
        mesh, data, rank, iterations, lambda_, seed, chunk, reg_scaling,
        implicit=False, alpha=0.0, u0=u0, v0=v0,
        checkpoint_every=checkpoint_every, checkpointer=checkpointer,
        kernel=kernel)


def train_implicit_sharded(
    mesh: Mesh,
    data: "Union[ALSData, PreshardedData]",
    rank: int = 10,
    iterations: int = 10,
    lambda_: float = 0.01,
    alpha: float = 1.0,
    seed: int = 3,
    chunk: int = 1 << 16,
    reg_scaling: str = "count",
    u0=None,
    v0=None,
    checkpoint_every: Optional[int] = None,
    checkpointer=None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ALS.trainImplicit (Hu-Koren-Volinsky) over the mesh; layout and
    checkpoints as :func:`train_explicit_sharded`."""
    return _train_sharded(
        mesh, data, rank, iterations, lambda_, seed, chunk, reg_scaling,
        implicit=True, alpha=alpha, u0=u0, v0=v0,
        checkpoint_every=checkpoint_every, checkpointer=checkpointer,
        kernel=kernel)
