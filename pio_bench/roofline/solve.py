"""The work one batched solve (kernel A) needs, counted from the shapes.

A copy of the arithmetic of ``chip_smoke.py::_solve_bound_ms``: for n
systems of rank r, A, b and the ridge read once and x written once,

    bytes = n * (r^2 * 4 + r * 4 + 4 + r * 4)

against the operations of an unpivoted Gauss-Jordan elimination (per
pivot k: r - k divisions, and a multiply and a subtract for each of the
r - k live columns of the r - 1 other rows; r adds of the ridge):

    operations = n * (sum_k (r - k) (1 + 2 (r - 1)) + r)

held against the published fp32 peak (the smoke holds them against half
of it, since kernel A may not fuse; bytes bind at every rank up to 32 on
an H100 either way, so the share is the same).
"""

from __future__ import annotations

FLOAT_BYTES = 4

#: the name the port gives kernel A's device function (``csrc/solve_gj.cu``)
KERNEL = "gj_solve"


def operations(n: int, rank: int) -> float:
    r = rank
    return float(n) * (sum((r - k) * (1 + 2 * (r - 1)) for k in range(r))
                       + r)


def bytes_moved(n: int, rank: int) -> float:
    r = rank
    return float(n) * (r * r + r + 1 + r) * FLOAT_BYTES


def least_s(n: int, rank: int, peaks: dict) -> float:
    return max(operations(n, rank) / peaks["fp32_flops_s"],
               bytes_moved(n, rank) / peaks["hbm_bytes_s"])


def bound_by(n: int, rank: int, peaks: dict) -> str:
    t_ops = operations(n, rank) / peaks["fp32_flops_s"]
    return ("operations" if t_ops >= bytes_moved(n, rank)
            / peaks["hbm_bytes_s"] else "bytes")
