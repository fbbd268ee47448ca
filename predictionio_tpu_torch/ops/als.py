"""Alternating Least Squares, explicit and implicit feedback (port of
``predictionio_tpu/ops/als.py``).

- Ratings are laid out as **sorted, padded COO** both ways
  (:func:`prepare_ratings`): by user and by item, each padded to a
  geometric bucket of ``chunk`` entries (:func:`bucket_units`), padding
  rows carrying ``self_idx == n_self`` and weight 0. The host layout
  (numpy's stable argsort) and the device layout (``torch.sort(stable=
  True)``) are bit-identical.
- One half-step solves, for every row u (symmetrically for items),
  ``(sum_i c_ui v_i v_i^T + reg_u I) x_u = sum_i b_ui v_i``: the per-row
  Gram and right-hand side come from :func:`gram_rhs`, the solves from
  :func:`~predictionio_tpu_torch.ops.solve.solve_factors` (kernel A on the
  card).
- Regularization is MLlib's ALS-WR: ``lambda * n_ratings(u)``
  (``reg_scaling="count"``), or constant.

The Gram. The reference offers three accumulators (``PIO_ALS_KERNEL``):
"scan" (chunked per-entry sorted segment sums), "csrb" (a row-aligned
mini-block layout with wide-row gathers) and "hybrid" (the Zipf head as
dense bf16 MXU matmuls plus a csrb tail). All three compute the same
per-row sums; csrb and hybrid are TPU memory layouts of them, and
``_split_hilo`` exists only to keep the MXU's bf16 passes accurate. The
port accepts the three names, refuses any other with the reference's
message, and runs one fp32 chunked Gram for all of them, so
``_split_hilo``, ``csrb_layout`` and the hybrid layout have no
counterpart.

Determinism. Float ``index_add_``/``scatter_add_`` use atomics on CUDA,
whose order changes from run to run. :func:`gram_rhs` instead reduces
each chunk's runs of equal rows with ``torch.segment_reduce`` (sums in a
fixed order, long runs in two levels of fixed-size pieces) and adds each
partial into the accumulator with no duplicate index, so two trains from
one seed, and a checkpoint resume, are bit-identical on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.common import devicewatch
from predictionio_tpu_torch.ops.solve import solve_factors

__all__ = [
    "COOSide", "ALSData", "group_coo", "prepare_ratings", "bucket_units",
    "declared_nnz_pad", "gram_rhs", "solve_factors", "init_factors",
    "train_explicit", "train_implicit", "rmse",
]

_EPS = 1e-8
_KERNELS = ("csrb", "scan", "hybrid")


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@dataclass
class COOSide:
    """Ratings sorted by one side ("self"), padded to a chunk multiple.
    Padding rows carry ``self_idx == n_self`` (a dummy row dropped after
    accumulation) and weight 0. Arrays are numpy (host layout) or torch
    tensors (device layout)."""
    self_idx: "np.ndarray | torch.Tensor"    # (nnz_pad,) int32, ascending
    other_idx: "np.ndarray | torch.Tensor"   # (nnz_pad,) int32
    rating: "np.ndarray | torch.Tensor"      # (nnz_pad,) float32, 0 in pad
    counts: "np.ndarray | torch.Tensor"      # (n_self,) int32
    n_self: int
    n_other: int


@dataclass
class ALSData:
    """Both orientations of the ratings. ``_cache`` holds the trainers'
    per-device tensors and chunk plans (built once per layout)."""
    by_user: COOSide
    by_item: COOSide
    n_users: int
    n_items: int
    nnz: int
    _cache: Dict[tuple, object] = field(default_factory=dict, repr=False,
                                        compare=False)


def group_coo(keys: np.ndarray, other: np.ndarray, vals: np.ndarray,
              n_keys: int):
    """Stable-sort the COO triple by key + per-key counts (numpy's
    stable argsort; the reference's native counting sort gives the same
    permutation)."""
    order = np.argsort(keys, kind="stable")
    s = keys[order]
    return (s, other[order], vals[order],
            np.bincount(s, minlength=n_keys).astype(np.int32))


def bucket_units(n: int, step: float = 1.25) -> int:
    """Round a unit count up to a geometric bucket boundary (~step
    ratio), so a growing event log trains on O(log) distinct shapes.
    ``PIO_NNZ_BUCKETING=0`` disables it (exact shapes)."""
    if n <= 1 or os.environ.get("PIO_NNZ_BUCKETING", "1") == "0":
        return max(n, 1)
    b = 1
    while b < n:
        b = max(b + 1, int(b * step))
    return b


def declared_nnz_pad(nnz: int, chunk: int = 1 << 18) -> int:
    """The COO pad :func:`prepare_ratings` applies to ``nnz`` ratings,
    computable from the count alone."""
    return bucket_units(max(-(-nnz // chunk), 1)) * chunk


def _pad_np(a: np.ndarray, n: int, value) -> np.ndarray:
    return np.pad(a, (0, n - a.shape[0]), constant_values=value)


def _pad_t(t: torch.Tensor, n: int, value) -> torch.Tensor:
    return torch.cat([t, t.new_full((n - t.shape[0],), value)])


def prepare_ratings(
    user_idx, item_idx, rating, n_users: int, n_items: int,
    chunk: int = 1 << 18, on_device: bool = False,
    device: device_mod.DeviceLike = None,
) -> ALSData:
    """Sort + pad the COO ratings both ways.

    ``on_device=False`` lays out on the host with numpy (arrays stay
    numpy); ``on_device=True`` ships the raw COO to ``device`` (the card
    unless the caller asks for the CPU) once and sorts there with
    ``torch.sort(stable=True)``. Both give the same layout bit for bit.
    With ``on_device``, the COO may already be torch tensors (the staged
    read's device mirrors): they move only if they lie elsewhere, and the
    layout is the one their host twins would give."""
    nnz = int(len(user_idx))
    nnz_pad = declared_nnz_pad(nnz, chunk)
    if on_device:
        dev = device_mod.resolve(device)

        def put(a, np_dtype, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype)
            return torch.as_tensor(np.asarray(a, np_dtype), device=dev)

        u = put(user_idx, np.int32, torch.int32)
        i = put(item_idx, np.int32, torch.int32)
        r = put(rating, np.float32, torch.float32)

        def side_dev(a, b, n_a, n_b) -> COOSide:
            s, order = torch.sort(a, stable=True)
            counts = torch.bincount(a.long(), minlength=n_a).to(torch.int32)
            return COOSide(
                self_idx=_pad_t(s, nnz_pad, n_a),
                other_idx=_pad_t(b[order], nnz_pad, 0),
                rating=_pad_t(r[order], nnz_pad, 0.0),
                counts=counts, n_self=n_a, n_other=n_b)

        return ALSData(by_user=side_dev(u, i, n_users, n_items),
                       by_item=side_dev(i, u, n_items, n_users),
                       n_users=n_users, n_items=n_items, nnz=nnz)

    user_idx = np.asarray(user_idx, dtype=np.int32)
    item_idx = np.asarray(item_idx, dtype=np.int32)
    rating = np.asarray(rating, dtype=np.float32)

    def side(a_idx, b_idx, n_a, n_b) -> COOSide:
        s, o, r, counts = group_coo(a_idx, b_idx, rating, n_a)
        return COOSide(self_idx=_pad_np(s, nnz_pad, n_a),
                       other_idx=_pad_np(o, nnz_pad, 0),
                       rating=_pad_np(r, nnz_pad, 0.0),
                       counts=counts, n_self=n_a, n_other=n_b)

    return ALSData(by_user=side(user_idx, item_idx, n_users, n_items),
                   by_item=side(item_idx, user_idx, n_items, n_users),
                   n_users=n_users, n_items=n_items, nnz=nnz)


# ---------------------------------------------------------------------------
# Gram + right-hand side
# ---------------------------------------------------------------------------

def _kernel_flag(kernel: Optional[str]) -> str:
    k = kernel or os.environ.get("PIO_ALS_KERNEL", "hybrid")
    if k not in _KERNELS:
        raise ValueError(
            f"unknown ALS kernel {k!r} (want 'csrb', 'hybrid' or 'scan')")
    return k


#: longest run one reduction thread sums; longer runs are split in pieces
_PIECE = 512


@dataclass
class GramChunk:
    """One chunk of a sorted layout, [start, stop): its distinct rows,
    the lengths of the pieces (runs of one row, cut at ``_PIECE``
    entries) and, when some run was cut, the number of pieces per row."""
    start: int
    stop: int
    rows: torch.Tensor
    piece_lengths: torch.Tensor
    pieces_per_row: Optional[torch.Tensor]


def gram_plan(self_idx: torch.Tensor, chunk: int) -> List[GramChunk]:
    """The runs of equal rows in each ``chunk`` of a sorted ``self_idx``.
    The layout never changes between iterations, so a trainer builds
    this once (one host sync per chunk) and every half-step reuses it.

    A popular item's run can fill a whole chunk; one reduction thread
    summing it serially would take milliseconds, so runs are cut into
    pieces of at most ``_PIECE`` entries, summed in two fixed-order
    levels."""
    plan = []
    nnz = int(self_idx.shape[0])
    for lo in range(0, max(nnz, 1), chunk):
        hi = min(lo + chunk, nnz)
        rows, lengths = torch.unique_consecutive(self_idx[lo:hi],
                                                 return_counts=True)
        ln = lengths.cpu().numpy()
        pieces = -(-ln // _PIECE)
        per_row = None
        if (pieces > 1).any():
            plen = np.full(int(pieces.sum()), _PIECE, np.int64)
            plen[np.cumsum(pieces) - 1] = ln - (pieces - 1) * _PIECE
            lengths = torch.as_tensor(plen, device=self_idx.device)
            per_row = torch.as_tensor(pieces, device=self_idx.device)
        plan.append(GramChunk(lo, hi, rows.long(), lengths, per_row))
    return plan


def gram_rhs(
    other_factors: torch.Tensor,   # (n_other, r)
    self_idx: torch.Tensor,        # (nnz_pad,) sorted, padded with n_self
    other_idx: torch.Tensor,       # (nnz_pad,)
    coeff_a: torch.Tensor,         # (nnz_pad,) per-entry Gram weight
    coeff_b: torch.Tensor,         # (nnz_pad,) per-entry RHS weight
    n_self: int,
    chunk: int,
    plan: Optional[List[GramChunk]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``A_s = sum_n a_n v_n v_n^T`` and ``b_s = sum_n b_n v_n`` per row.

    Chunked so at most (chunk, r*r + r) of flattened outer products
    exists at once, into an (n_self + 1, r*r + r) fp32 accumulator whose
    last row takes the padding. Each chunk's runs of equal rows are
    reduced by ``torch.segment_reduce`` in a fixed order and added to
    their rows with no duplicate index: deterministic on the card.

    PRECONDITION: ``self_idx`` is nondecreasing (as
    :func:`prepare_ratings` lays it out)."""
    if plan is None:
        plan = gram_plan(self_idx, chunk)
    r = other_factors.shape[1]
    AB = torch.zeros((n_self + 1, r * r + r), dtype=torch.float32,
                     device=other_factors.device)
    for ch in plan:
        lo, hi = ch.start, ch.stop
        v = other_factors.index_select(0, other_idx[lo:hi])
        # one outer product gives both: rows (a v_i) v_j, the reference's
        # order, then b v_j; flattened, (c, r*r + r) with the RHS last
        w = torch.cat([v * coeff_a[lo:hi, None], coeff_b[lo:hi, None]], 1)
        both = (w[:, :, None] * v[:, None, :]).view(hi - lo, r * r + r)
        part = torch.segment_reduce(both, "sum", lengths=ch.piece_lengths,
                                    axis=0, unsafe=True)
        if ch.pieces_per_row is not None:
            part = torch.segment_reduce(part, "sum",
                                        lengths=ch.pieces_per_row, axis=0,
                                        unsafe=True)
        AB.index_copy_(0, ch.rows, AB.index_select(0, ch.rows) + part)
    A = AB[:-1, :r * r].reshape(n_self, r, r)
    b = AB[:-1, r * r:]
    return A, b


def _reg_vec(counts: torch.Tensor, n_self: int, lambda_: float,
             reg_scaling: str) -> torch.Tensor:
    """MLlib ALS-WR regularization: ``lambda * n_ratings(row)`` or
    constant. A zero-count row gets one rating's worth of lambda, not the
    bare _EPS, which is below f32 resolution next to YtY and would make a
    cold row's unpivoted solve 0/0 (see the reference's docstring)."""
    if reg_scaling == "count":
        return lambda_ * torch.clamp(counts, min=1).to(torch.float32) + _EPS
    return torch.full((n_self,), lambda_ + _EPS, dtype=torch.float32,
                      device=counts.device)


def _solve(A: torch.Tensor, b: torch.Tensor, reg: torch.Tensor):
    return solve_factors(A.contiguous(), b.contiguous(), reg)


def _half_step_explicit(other, side_idx, side_other, side_rating, counts,
                        n_self, lambda_, chunk, reg_scaling, plan=None):
    # Presence weight: a genuine 0.0 rating is still an observation, so
    # presence is self_idx < n_self (padding rows use n_self).
    present = (side_idx < n_self).to(torch.float32)
    A, b = gram_rhs(other, side_idx, side_other, present, side_rating,
                    n_self, chunk, plan)
    return _solve(A, b, _reg_vec(counts, n_self, lambda_, reg_scaling))


def _half_step_implicit(other, side_idx, side_other, side_rating, counts,
                        n_self, lambda_, alpha, chunk, reg_scaling,
                        plan=None):
    """Hu-Koren-Volinsky: ``A_u = Y'Y + Y'(C_u - I)Y``, ``b_u = Y'C_u p_u``,
    confidence from |r| and preference p = 1 iff r > 0 (MLlib's
    trainImplicit for signed ratings)."""
    YtY = other.T @ other
    conf = alpha * torch.abs(side_rating)
    pref = (side_rating > 0).to(torch.float32)
    A_corr, b = gram_rhs(other, side_idx, side_other, conf,
                         (1.0 + conf) * pref, n_self, chunk, plan)
    return _solve(YtY[None] + A_corr, b,
                  _reg_vec(counts, n_self, lambda_, reg_scaling))


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def init_factors(generator: torch.Generator, n: int,
                 rank: int) -> torch.Tensor:
    """MLlib-style init: |normal| / sqrt(rank), drawn from ``generator``
    (on the CPU, so one seed gives the same factors on every device)."""
    g = torch.randn((n, rank), generator=generator, dtype=torch.float32)
    return torch.abs(g) / torch.sqrt(torch.tensor(rank, dtype=torch.float32))


def _seed_factors(seed: int, n_users: int, n_items: int, rank: int,
                  device: device_mod.DeviceLike = None):
    """Initial (U, V) from ``seed``, each side from its own stream, as the
    reference splits its key: the item init does not depend on the user
    count, so a retrain that adds users starts from the same item factors
    (the first half-step solves the users from them). ``jax.random``
    cannot be replayed in torch, so the draws differ from the reference's;
    parity tests inject ``u0``/``v0`` instead."""
    dev = device_mod.resolve(device)
    seed_u, seed_v = np.random.SeedSequence(int(seed)).generate_state(2)
    U = init_factors(torch.Generator(device="cpu").manual_seed(int(seed_u)),
                     n_users, rank)
    V = init_factors(torch.Generator(device="cpu").manual_seed(int(seed_v)),
                     n_items, rank)
    return U.to(dev), V.to(dev)


def _run_segmented(run, u0, v0, iterations: int,
                   checkpoint_every: Optional[int], checkpointer,
                   device: torch.device):
    """Restore + segmented execution shared by both trainers.
    ``run(u, v, n_iters)`` runs ``n_iters`` iterations. Snapshots are
    intermediate only: the final state persists via the model blob."""
    start = 0
    if checkpointer is not None:
        restored = checkpointer.latest()
        if restored is not None:
            start, arrays = restored
            expect_u, expect_v = tuple(u0.shape), tuple(v0.shape)
            got_u = tuple(np.shape(arrays["U"]))
            got_v = tuple(np.shape(arrays["V"]))
            # rank/entity-count drift must fail loudly
            if got_u != expect_u or got_v != expect_v:
                raise ValueError(
                    "incompatible checkpoint: snapshot factors are "
                    f"U{got_u} / V{got_v} but this run expects "
                    f"U{expect_u} / V{expect_v}; the engine params "
                    "(rank) or training data changed since the snapshot "
                    "was written — delete the checkpoint directory or "
                    "restore the original params to resume")
            u0 = _factors_on(arrays["U"], device)
            v0 = _factors_on(arrays["V"], device)
    if start >= iterations:
        return u0, v0
    if checkpoint_every is None or checkpointer is None:
        return run(u0, v0, iterations - start)
    U, V = u0, v0
    step = start
    while step < iterations:
        seg = min(checkpoint_every, iterations - step)
        U, V = run(U, V, seg)
        step += seg
        if step < iterations:
            checkpointer.save(step, {"U": U.cpu().numpy(),
                                     "V": V.cpu().numpy()})
    return U, V


def _factors_on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32)
                           if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=device).contiguous()


def _device_side(side: COOSide, device: torch.device) -> COOSide:
    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return COOSide(self_idx=t(side.self_idx, torch.int32),
                   other_idx=t(side.other_idx, torch.int64),
                   rating=t(side.rating, torch.float32),
                   counts=t(side.counts, torch.int32),
                   n_self=side.n_self, n_other=side.n_other)


def _prepared(data: ALSData, chunk: int, device: torch.device):
    """The layout's sides on ``device`` and their chunk plans, cached on
    ``data`` (a retrain over the same layout skips both)."""
    key = ("sides", str(device), chunk)
    got = data._cache.get(key)
    if got is None:
        data._cache.clear()     # one device copy at a time
        sides = [_device_side(s, device) for s in (data.by_user,
                                                   data.by_item)]
        got = [(s, gram_plan(s.self_idx, chunk)) for s in sides]
        data._cache[key] = got
    return got


def _train(data: ALSData, rank, iterations, lambda_, alpha, seed, chunk,
           reg_scaling, implicit, u0, v0, checkpoint_every, checkpointer,
           device):
    dev = device_mod.resolve(device)
    nnz_pad = int(data.by_user.self_idx.shape[0])
    chunk = max(min(chunk, nnz_pad), 1)
    (bu, pu), (bi, pi) = _prepared(data, chunk, dev)
    if u0 is None or v0 is None:
        u0, v0 = _seed_factors(int(seed), data.n_users, data.n_items, rank,
                               device=dev)
    u0, v0 = _factors_on(u0, dev), _factors_on(v0, dev)

    def half(other, side, plan):
        if implicit:
            return _half_step_implicit(
                other, side.self_idx, side.other_idx, side.rating,
                side.counts, side.n_self, lambda_, alpha, chunk,
                reg_scaling, plan)
        return _half_step_explicit(
            other, side.self_idx, side.other_idx, side.rating, side.counts,
            side.n_self, lambda_, chunk, reg_scaling, plan)

    def run(U, V, n_iters):
        # a kernel build or load in the trainer shows up as
        # pio_xla_compiles_total{fn="als_train_explicit"} (or _implicit)
        with devicewatch.attribution(
                "als_train_implicit" if implicit else "als_train_explicit",
                phase="train"):
            for _ in range(n_iters):
                U = half(V, bu, pu)
                V = half(U, bi, pi)
        return U, V

    return _run_segmented(run, u0, v0, iterations, checkpoint_every,
                          checkpointer, dev)


def train_explicit(
    data: ALSData,
    rank: int = 10,
    iterations: int = 10,
    lambda_: float = 0.01,
    seed: int = 3,
    chunk: int = 1 << 18,
    reg_scaling: str = "count",
    u0=None,
    v0=None,
    checkpoint_every: Optional[int] = None,
    checkpointer=None,
    kernel: Optional[str] = None,
    device: device_mod.DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ALS.train parity. Returns (user_factors (n_users, rank),
    item_factors (n_items, rank)) on ``device``. ``u0``/``v0`` replace
    the seeded start; with ``checkpoint_every`` and a ``checkpointer``
    (``workflow.checkpoint.FactorCheckpointer``) training runs in
    segments and snapshots between them, and resumes from the newest
    snapshot. ``kernel`` (or ``PIO_ALS_KERNEL``) is validated; every
    value runs the same Gram (module docstring)."""
    _kernel_flag(kernel)
    return _train(data, rank, iterations, lambda_, 0.0, seed, chunk,
                  reg_scaling, False, u0, v0, checkpoint_every,
                  checkpointer, device)


def train_implicit(
    data: ALSData,
    rank: int = 10,
    iterations: int = 10,
    lambda_: float = 0.01,
    alpha: float = 1.0,
    seed: int = 3,
    chunk: int = 1 << 18,
    reg_scaling: str = "count",
    u0=None,
    v0=None,
    checkpoint_every: Optional[int] = None,
    checkpointer=None,
    kernel: Optional[str] = None,
    device: device_mod.DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ALS.trainImplicit parity; ``rating`` carries the implicit
    preference weight. Checkpoints and ``kernel`` as in
    :func:`train_explicit`."""
    _kernel_flag(kernel)
    return _train(data, rank, iterations, lambda_, alpha, seed, chunk,
                  reg_scaling, True, u0, v0, checkpoint_every,
                  checkpointer, device)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def rmse(U: torch.Tensor, V: torch.Tensor, user_idx, item_idx, rating,
         mask, chunk: int = 1 << 18) -> torch.Tensor:
    """Root-mean-square error over observed (possibly padded) entries.
    Padding rows carry ``u == n_users``: indices are clamped into range
    (as the reference does) and the 0 mask removes them."""
    dev = U.device
    u = torch.as_tensor(user_idx, device=dev).long()
    i = torch.as_tensor(item_idx, device=dev).long()
    r = torch.as_tensor(rating, dtype=torch.float32, device=dev)
    m = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    se = torch.zeros((), dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, int(u.shape[0]), chunk):
        uc = torch.clamp(u[lo:lo + chunk], max=U.shape[0] - 1)
        ic = torch.clamp(i[lo:lo + chunk], max=V.shape[0] - 1)
        pred = torch.sum(U.index_select(0, uc) * V.index_select(0, ic),
                         dim=1)
        err = (pred - r[lo:lo + chunk]) * m[lo:lo + chunk]
        se = se + torch.sum(err * err)
        n = n + torch.sum(m[lo:lo + chunk])
    return torch.sqrt(se / torch.clamp(n, min=1.0))
