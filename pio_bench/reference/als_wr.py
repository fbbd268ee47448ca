"""Plain explicit ALS-WR, the yardstick the port's trainer is held to.

Zhou, Wilkinson, Schreiber and Pan (2008), "Large-scale Parallel
Collaborative Filtering for the Netflix Prize", as MLlib's ``ALS.train``
and PredictionIO's recommendation template run it: alternately, for
every user u with the item factors V fixed,

    (sum_{i in I(u)} v_i v_i^T + lambda n_u I) x_u = sum_{i in I(u)} r_ui v_i

and then every item with the user factors fixed; ``n_u`` counts u's
ratings (a repeated pair counts each time). A row with no rating has
``A = 0`` and ``b = 0`` and solves to 0; its ridge is taken as one
rating's (``lambda * max(n_u, 1)``) only so that the system is regular.

Written for plainness, not speed, and independent of the port: it
imports nothing of ``predictionio_tpu_torch``. Each half-step forms, for
a block of rows, the dense count matrix ``M`` and the dense rating-sum
matrix ``R`` (rows x the other side) and computes

    A = M @ (v_i v_i^T, upper triangle, one column per entry)
    b = R @ V

as two matrix products, then solves each row with ``torch.linalg.solve``.
``precision`` is ``"fp64"`` (the yardstick) or ``"tf32"``: fp32 with
the products' inputs in TF32, the precision one step below the
configuration's fp32 (the control). On a card ``"tf32"`` runs the
products on the tensor cores; on the CPU, which has no TF32, the inputs
are rounded to TF32's 10-bit mantissa first, which is what the tensor
cores do with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

PRECISIONS = ("fp64", "tf32")

#: bytes of one dense block (M and R each); blocks hold whole rows
BLOCK_BYTES = 1 << 31


@dataclass
class Side:
    """The ratings sorted by one side ("self"), stably."""
    self_idx: torch.Tensor      # (nnz,) int64, ascending
    other_idx: torch.Tensor     # (nnz,) int64
    rating: torch.Tensor        # (nnz,) float32
    counts: torch.Tensor        # (n_self,) int64
    starts: List[int]           # n_self + 1 offsets into the arrays
    n_self: int
    n_other: int


def sort_side(self_idx: torch.Tensor, other_idx: torch.Tensor,
              rating: torch.Tensor, n_self: int, n_other: int) -> Side:
    s, order = torch.sort(self_idx.long(), stable=True)
    counts = torch.bincount(s, minlength=n_self)
    starts = [0] + torch.cumsum(counts, 0).tolist()
    return Side(s, other_idx.long()[order], rating[order], counts, starts,
                n_self, n_other)


def layouts(user: torch.Tensor, item: torch.Tensor, rating: torch.Tensor,
            n_users: int, n_items: int) -> Tuple[Side, Side]:
    """(by user, by item)."""
    return (sort_side(user, item, rating, n_users, n_items),
            sort_side(item, user, rating, n_items, n_users))


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: want one of "
                         f"{PRECISIONS}")
    return torch.float64 if precision == "fp64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision != "tf32":
        return a @ b
    if a.is_cuda:
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
    return round_tf32(a) @ round_tf32(b)


def half_step(other: torch.Tensor, side: Side, lambda_: float,
              precision: str = "fp64") -> torch.Tensor:
    """Solve every row of ``side`` against the ``other`` factors; returns
    (n_self, rank) in the precision's dtype."""
    dtype = _dtype(precision)
    dev = other.device
    V = other.to(dtype)
    r = V.shape[1]
    iu, ju = torch.triu_indices(r, r, device=dev)
    W = V[:, iu] * V[:, ju]                     # (n_other, r (r + 1) / 2)
    eye = torch.eye(r, dtype=dtype, device=dev)
    out = torch.empty((side.n_self, r), dtype=dtype, device=dev)
    step = max(1, BLOCK_BYTES // (side.n_other * W.element_size()))
    for a in range(0, side.n_self, step):
        b = min(a + step, side.n_self)
        lo, hi = side.starts[a], side.starts[b]
        flat = (side.self_idx[lo:hi] - a) * side.n_other \
            + side.other_idx[lo:hi]
        M = torch.zeros((b - a) * side.n_other, dtype=dtype, device=dev)
        R = torch.zeros_like(M)
        M.index_add_(0, flat, torch.ones(hi - lo, dtype=dtype, device=dev))
        R.index_add_(0, flat, side.rating[lo:hi].to(dtype))
        M = M.view(b - a, side.n_other)
        R = R.view(b - a, side.n_other)
        tri = _mm(M, W, precision)
        A = torch.zeros((b - a, r, r), dtype=dtype, device=dev)
        A[:, iu, ju] = tri
        A[:, ju, iu] = tri
        del M, tri
        rhs = _mm(R, V, precision)
        del R
        reg = lambda_ * torch.clamp(side.counts[a:b], min=1).to(dtype)
        A += reg[:, None, None] * eye
        out[a:b] = torch.linalg.solve(A, rhs)
    return out


def train(u0: torch.Tensor, v0: torch.Tensor, by_user: Side, by_item: Side,
          iterations: int, lambda_: float, precision: str = "fp64"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iterations`` of (users from V, then items from U) from (u0, v0)."""
    U, V = u0, v0
    for _ in range(iterations):
        U = half_step(V, by_user, lambda_, precision)
        V = half_step(U, by_item, lambda_, precision)
    return U, V


def rmse(U: torch.Tensor, V: torch.Tensor, user: torch.Tensor,
         item: torch.Tensor, rating: torch.Tensor,
         chunk: int = 1 << 22) -> float:
    """Root-mean-square error of ``U V^T`` over the ratings, in fp64."""
    U = U.to(torch.float64)
    V = V.to(torch.float64)
    se = torch.zeros((), dtype=torch.float64, device=U.device)
    for lo in range(0, int(user.shape[0]), chunk):
        u = user[lo:lo + chunk].long()
        i = item[lo:lo + chunk].long()
        err = (U[u] * V[i]).sum(1) - rating[lo:lo + chunk].to(torch.float64)
        se += (err * err).sum()
    return float(torch.sqrt(se / max(int(user.shape[0]), 1)))
