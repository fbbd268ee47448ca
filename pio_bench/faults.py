"""Faults planted in the port's trainer, for the readings that set the
limits (``readings.py``) and for the CPU test that sees ``correct`` come
out false. Each is a context manager that patches
``predictionio_tpu_torch.ops.als`` and restores it on exit:

- ``unchanged``: a train that returns its starting factors;
- ``half_batch``: every Gram over half the ratings (every other entry of
  the layout), the rest weighted twice: the mean over the half kept;
- ``altered``: the train's answer altered where it is produced: user 0's
  factor row replaced by user 1's.

A fault in the exchange between chips has no place in a one-chip
cell.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

KINDS = ("unchanged", "half_batch", "altered")


@contextmanager
def planted(kind: str):
    from predictionio_tpu_torch.ops import als

    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: want one of {KINDS}")
    train, gram = als.train_explicit, als.gram_rhs

    def unchanged(data, **kw):
        return kw["u0"].clone(), kw["v0"].clone()

    def half_batch(other, self_idx, other_idx, coeff_a, coeff_b, *args,
                   **kw):
        keep = (torch.arange(coeff_a.shape[0], device=coeff_a.device)
                % 2 == 0).to(coeff_a.dtype) * 2
        return gram(other, self_idx, other_idx, coeff_a * keep,
                    coeff_b * keep, *args, **kw)

    def altered(data, **kw):
        U, V = train(data, **kw)
        U = U.clone()
        U[0] = U[1]
        return U, V

    try:
        if kind == "half_batch":
            als.gram_rhs = half_batch
        else:
            als.train_explicit = unchanged if kind == "unchanged" else altered
        yield
    finally:
        als.train_explicit, als.gram_rhs = train, gram
