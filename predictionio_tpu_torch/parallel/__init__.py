"""Mesh and sharding: block-sharded ALS training and row-sharded serving
over ``torch.distributed`` (port of ``predictionio_tpu/parallel/``)."""

from predictionio_tpu_torch.parallel.mesh import (
    Mesh, get_mesh, init_distributed, is_multiprocess, local_device_count,
    pad_to_multiple,
)

__all__ = ["Mesh", "get_mesh", "init_distributed", "is_multiprocess",
           "local_device_count", "pad_to_multiple"]
