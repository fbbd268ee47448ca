"""The comparisons that decide ``correct``: each number, against its limit.

- :func:`coo_mismatches`: a layout of ratings sorted by one side, against
  the reference's, as multisets per row (the order inside a row is the
  program's to choose);
- :func:`row_gap`: the worst row of a factor matrix: the distance of the
  row from the reference's, over the reference row's norm or the median
  row norm, whichever is larger (rows that are all but zero do not
  blow the ratio up);
- :func:`relative_gap`: of one scalar.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _canonical(self_idx: torch.Tensor, other_idx: torch.Tensor,
               rating: torch.Tensor, n_self: int, n_other: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The real entries (self index in [0, n_self)) ordered by (self,
    other, rating)."""
    s = self_idx.long()
    keep = (s >= 0) & (s < n_self)
    s, o, r = s[keep], other_idx.long()[keep], rating[keep]
    by_rating = torch.sort(r, stable=True).indices
    s, o, r = s[by_rating], o[by_rating], r[by_rating]
    order = torch.sort(s * n_other + o, stable=True).indices
    return s[order], o[order], r[order]


def coo_mismatches(program: Tuple[torch.Tensor, ...], reference:
                   Tuple[torch.Tensor, ...], n_self: int, n_other: int
                   ) -> int:
    """Entries in which the program's (self, other, rating, counts)
    differ from the reference's; a difference in the number of real
    entries counts whole."""
    a = _canonical(*program[:3], n_self, n_other)
    b = _canonical(*reference[:3], n_self, n_other)
    if a[0].shape != b[0].shape:
        return abs(a[0].shape[0] - b[0].shape[0]) + max(a[0].shape[0],
                                                        b[0].shape[0])
    differ = (a[0] != b[0]) | (a[1] != b[1]) | (a[2] != b[2])
    counts_a = program[3].long().reshape(-1)
    counts_b = reference[3].long().reshape(-1)
    if counts_a.shape != counts_b.shape:
        return int(differ.sum()) + max(counts_a.numel(), counts_b.numel())
    return int(differ.sum()) + int((counts_a != counts_b).sum())


def row_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ||x_u - ref_u|| / max(||ref_u||, median ||ref||);
    NaN when x holds a NaN or differs in shape."""
    if tuple(x.shape) != tuple(ref.shape):
        return math.nan
    x = x.to(device=ref.device, dtype=torch.float64)
    ref = ref.to(torch.float64)
    den = torch.linalg.vector_norm(ref, dim=1)
    floor = torch.clamp(den.median(), min=torch.finfo(torch.float64).tiny)
    gap = torch.linalg.vector_norm(x - ref, dim=1) / torch.maximum(den,
                                                                  floor)
    if bool(torch.isnan(gap).any()):
        return math.nan
    return float(gap.max())


def relative_gap(value: float, ref: float) -> float:
    return abs(value - ref) / abs(ref) if ref else abs(value)


def judged(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is finite and at most its limit. A number without a limit, or a
    limit without a number, raises."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits "
                       f"{sorted(limits)}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in
              numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k]
             for k, v in numbers.items())
    return ok, checks
