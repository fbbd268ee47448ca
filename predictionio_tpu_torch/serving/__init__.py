"""Micro-batched query serving layer of the port: :mod:`batcher` (the
bounded queue with admission control) and :mod:`protocol` (batched
predict + padding buckets)."""

from predictionio_tpu_torch.serving.batcher import (  # noqa: F401
    BatcherClosed, MicroBatcher, ServerSaturated,
)
from predictionio_tpu_torch.serving.protocol import (  # noqa: F401
    DEFAULT_BUCKETS, batch_capable, bucket_for, pad_buckets, predict_batch,
)
