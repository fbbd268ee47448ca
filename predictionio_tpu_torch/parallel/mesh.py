"""Mesh helpers on ``torch.distributed`` (port of
``predictionio_tpu/parallel/mesh.py``).

The reference's unit of scale is a 1-D ``jax.sharding.Mesh`` over TPU
devices, with XLA inserting the collectives. The port's unit is a
:class:`Mesh` of **shard slots**:

- **One process drives one device.** A process (a rank of a
  ``torch.distributed`` job, or a lone process) owns one device: the
  card it was given, or the CPU. NCCL refuses two ranks on one GPU, so a
  machine with one H100 runs a world of one.
- **The world's mesh.** :func:`get_mesh` returns a mesh with one slot
  per rank, each slot on its rank's device. Collectives between slots
  are ``torch.distributed`` calls (NCCL on the card, gloo on the CPU).
  ``get_mesh(n)`` refuses ``n`` larger than the world's devices, as the
  reference does; a mesh over several ranks spans every rank.
- **A mesh built from a device list** (``Mesh([dev] * n)``) may repeat
  the process's device: ``n`` slots in this process, the counterpart of
  the reference tier-1's virtual CPU devices. Between slots on one
  device a collective is a concatenation. Only the library API takes
  such a mesh (``als_dist.train_explicit_sharded(mesh, ...)``,
  ``serve_dist.shard_factors(mesh=...)``).

The reference's ``shard_map_compat`` has no torch meaning: each slot's
work is an ordinary call on its block, and the collectives are explicit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import device as device_mod


def _dist():
    import torch.distributed as dist
    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the job (1 without ``torch.distributed``)."""
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank (0 without ``torch.distributed``)."""
    return _dist().get_rank() if _initialized() else 0


def _concrete(dev: torch.device) -> torch.device:
    """``cuda`` with its index filled in (tensors report ``cuda:N``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_device(device: device_mod.DeviceLike = None) -> torch.device:
    """The one device this process drives: the device policy's choice
    (the card unless the caller asks for the CPU). Under a NCCL job a
    rank takes the card ``rank % device_count`` of its host."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None and _initialized() \
            and _dist().get_backend() == "nccl":
        return torch.device("cuda", process_index()
                            % max(torch.cuda.device_count(), 1))
    return _concrete(dev)


def local_device_count() -> int:
    """Devices a mesh can span: one per rank of the job (a lone process
    drives one device)."""
    return world_size()


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int, *, init_method: Optional[str] = None,
                     device: device_mod.DeviceLike = None) -> None:
    """Join a multi-process job (the reference's ``jax.distributed``
    role): every process runs the same command with its own
    ``process_id``; ``torch.distributed.init_process_group`` wires them
    through ``tcp://{coordinator}`` (or ``init_method``, e.g. a
    ``file://`` rendezvous), with NCCL when the device policy says
    ``cuda`` and gloo on the CPU. Idempotent: a repeat call with the same
    topology is a no-op; another topology raises."""
    topo = (coordinator, int(num_processes), int(process_id))
    done = getattr(init_distributed, "_done", None)
    if done == topo and _initialized():
        return
    if _initialized():
        raise RuntimeError(
            f"torch.distributed is already initialized as {done}; cannot "
            f"join {topo}")
    dev = device_mod.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id)
                              % max(torch.cuda.device_count(), 1))
    _dist().init_process_group(
        backend=backend, init_method=init_method or f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id))
    init_distributed._done = topo


def is_multiprocess() -> bool:
    return world_size() > 1


class Mesh:
    """A 1-D mesh of shard slots: slot ``i`` lives on ``devices[i]``.

    A mesh built from a device list (``world=False``) belongs wholly to
    this process, and its slots share the process's one device. The
    world's mesh (``world=True``, made by :func:`get_mesh`) has one slot
    per rank of the ``torch.distributed`` job, slot i on rank i; only
    this rank's entry of ``devices`` is a device it can use."""

    def __init__(self, devices: Sequence[device_mod.DeviceLike],
                 axis_name: str = "block", *, world: bool = False):
        if not len(devices):
            raise ValueError("a mesh needs at least one slot")
        self.devices: Tuple[torch.device, ...] = tuple(
            _concrete(torch.device(d)) for d in devices)
        self.axis_names = (axis_name,)
        self.distributed = bool(world)
        if world:
            if not _initialized() or len(self.devices) != world_size():
                raise ValueError(
                    "the world's mesh has one slot per rank of an "
                    "initialized torch.distributed job")
            self._local = [process_index()]
        else:
            self._local = list(range(len(self.devices)))
            if len(set(self.devices)) > 1:
                raise ValueError(
                    "one process drives one device: this mesh's slots sit "
                    f"on {sorted(set(map(str, self.devices)))}; run one "
                    "process per card")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_slots(self) -> List[int]:
        """The slots this process computes."""
        return list(self._local)

    @property
    def local_device(self) -> torch.device:
        """The device of this process's slots."""
        return self.devices[self._local[0]]


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "block",
             device: device_mod.DeviceLike = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of the world's devices
    (default: all), one slot per rank. Refuses more devices than the
    world has; a mesh over several ranks must span every rank (each rank
    runs the same collectives)."""
    n_world = world_size()
    n = n_world if n_devices is None else int(n_devices)
    if n > n_world:
        raise ValueError(
            f"requested {n} devices but only {n_world} are visible")
    if n < 1:
        raise ValueError(f"requested {n} devices")
    dev = process_device(device)
    if n_world > 1 and n != n_world:
        raise ValueError(
            f"a mesh over {n} of the job's {n_world} ranks: a "
            "multi-process mesh spans every rank")
    if _initialized():
        # the world's mesh: collectives go through the process group,
        # even at a world of one
        devices = [dev if r == process_index() else torch.device(dev.type)
                   for r in range(n)]
        return Mesh(devices, axis_name, world=True)
    return Mesh([dev], axis_name)


# ---------------------------------------------------------------------------
# collectives over a mesh's slots
# ---------------------------------------------------------------------------

def all_gather_blocks(mesh: Mesh, blocks: Dict[int, torch.Tensor],
                      dim: int = 0) -> torch.Tensor:
    """The slots' blocks concatenated along ``dim`` in slot order, on
    this process's device (every process gets the whole). ``blocks``
    holds this process's slots; under a world mesh each rank's block has
    the same shape (the layouts pad every slot alike)."""
    dev = mesh.local_device
    if not mesh.distributed:
        return torch.cat([blocks[s].to(dev) for s in range(mesh.size)],
                         dim=dim)
    (mine,) = mesh.local_slots
    t = blocks[mine].contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    _dist().all_gather(parts, t)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes of a world mesh (in place); the
    identity for a local mesh, whose slots the caller already summed."""
    if mesh.distributed:
        _dist().all_reduce(t)
    return t


def pad_to_multiple(arr: np.ndarray, multiple: int, pad_value) -> np.ndarray:
    """Pad axis 0 up to a multiple."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple if n else multiple
    if target == n:
        return arr
    pad_width = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)

