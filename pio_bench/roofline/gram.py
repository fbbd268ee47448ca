"""The work one Gram half-step needs, counted from the shapes.

For every rating of a side the half-step adds ``v v^T`` of the other
side's factor row into its row's A, and ``r_ui v`` into its b. A is
symmetric, so what the inputs need is its upper triangle: r (r + 1) / 2
multiply-adds, and r more for b, each two operations (a fused multiply-
add counts two against the fp32 peak):

    operations = n_ratings * 2 * (r (r + 1) / 2 + r) = n_ratings * (r^2 + 3 r)

Bytes: each rating read once (its two indices and its value, 12 bytes),
the other side's factors read once, and A (r x r, the form kernel A
reads) and b written once per row of the side. Padding and whatever a
program reads twice are not counted, so a program that pads less, fuses
more or renames its kernels is read against the same work.
"""

from __future__ import annotations

#: one rating in the COO: two int32 indices and an fp32 value
ENTRY_BYTES = 12
FLOAT_BYTES = 4


def operations(n_ratings: int, rank: int) -> float:
    return float(n_ratings) * (rank * rank + 3 * rank)


def bytes_moved(n_ratings: int, n_self: int, n_other: int,
                rank: int) -> float:
    return float(n_ratings * ENTRY_BYTES
                 + n_other * rank * FLOAT_BYTES
                 + n_self * (rank * rank + rank) * FLOAT_BYTES)


def least_s(n_ratings: int, n_self: int, n_other: int, rank: int,
            peaks: dict) -> float:
    """The least time one half-step's Gram takes on a card with ``peaks``
    (``fp32_flops_s``, ``hbm_bytes_s``)."""
    return max(operations(n_ratings, rank) / peaks["fp32_flops_s"],
               bytes_moved(n_ratings, n_self, n_other, rank)
               / peaks["hbm_bytes_s"])


def bound_by(n_ratings: int, n_self: int, n_other: int, rank: int,
             peaks: dict) -> str:
    t_ops = operations(n_ratings, rank) / peaks["fp32_flops_s"]
    t_bytes = bytes_moved(n_ratings, n_self, n_other, rank) \
        / peaks["hbm_bytes_s"]
    return "operations" if t_ops >= t_bytes else "bytes"
