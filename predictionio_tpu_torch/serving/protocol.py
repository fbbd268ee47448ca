"""Batched-predict protocol + padding-bucket policy (port of
``predictionio_tpu/serving/protocol.py``).

An algorithm opts into batched serving by overriding
``Algorithm.predict_batch``. Batch-capable device paths round the row
count up to a small fixed set of bucket sizes, so the set of shapes a
deploy runs stays bounded.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

#: default padding buckets; ``PIO_SERVE_BUCKETS`` ("1,8,64") overrides
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 4, 16, 64)


def pad_buckets(buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """Normalized, sorted bucket tuple (explicit arg > env > default)."""
    if buckets is None:
        env = os.environ.get("PIO_SERVE_BUCKETS")
        if env:
            buckets = [int(tok) for tok in env.split(",") if tok.strip()]
        else:
            buckets = DEFAULT_BUCKETS
    out = tuple(sorted({int(b) for b in buckets if int(b) >= 1}))
    if not out:
        raise ValueError(f"no usable padding buckets in {buckets!r}")
    return out


def bucket_for(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket >= n; past the largest bucket, n itself."""
    for b in pad_buckets(buckets):
        if n <= b:
            return b
    return n


def batch_capable(algo: Any) -> bool:
    """True when the algorithm overrides the base predict_batch."""
    from predictionio_tpu_torch.controller.base import Algorithm
    impl = getattr(type(algo), "predict_batch", None)
    return impl is not None and impl is not Algorithm.predict_batch


def predict_batch(algo: Any, model: Any, queries: Sequence[Any]) -> List[Any]:
    """Dispatch a batch through the algorithm's predict_batch."""
    impl = getattr(algo, "predict_batch", None)
    if impl is None:
        return [algo.predict(model, q) for q in queries]
    return list(impl(model, queries))
