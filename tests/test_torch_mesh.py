"""The port's mesh of shard slots (``predictionio_tpu_torch/parallel/
mesh.py``) against the JAX package's ``parallel/mesh.py``: one process
drives one device, a mesh built from a device list repeats it, the
world's mesh has one slot per rank, and ``get_mesh(n)`` refuses more
devices than the world has, with the reference's message."""

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.parallel import mesh


def test_lone_process_has_one_device_and_no_job():
    assert mesh.world_size() == 1 and mesh.process_index() == 0
    assert mesh.local_device_count() == 1
    assert not mesh.is_multiprocess()
    m = mesh.get_mesh(device="cpu")
    assert m.size == 1 and not m.distributed
    assert m.local_slots == [0] and m.local_device == torch.device("cpu")
    assert m.axis_names == ("block",)


def test_get_mesh_refuses_more_devices_than_the_world_has():
    n_ref = len(jmesh.jax.devices())
    with pytest.raises(ValueError) as want:
        jmesh.get_mesh(n_ref + 1)
    with pytest.raises(ValueError) as got:
        mesh.get_mesh(2, device="cpu")
    # the same message, with each world's count
    assert str(want.value) == (f"requested {n_ref + 1} devices but only "
                               f"{n_ref} are visible")
    assert str(got.value) == "requested 2 devices but only 1 are visible"


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_a_device_list_may_repeat_the_process_device(n):
    m = mesh.Mesh(["cpu"] * n, axis_name="shard")
    assert m.size == n and m.local_slots == list(range(n))
    assert m.axis_names == ("shard",) and not m.distributed
    blocks = {d: torch.full((2, 3), float(d)) for d in range(n)}
    out = mesh.all_gather_blocks(m, blocks)
    assert out.shape == (2 * n, 3)
    np.testing.assert_array_equal(out[::2, 0].numpy(), np.arange(n))
    wide = mesh.all_gather_blocks(m, blocks, dim=1)
    assert wide.shape == (2, 3 * n)
    t = torch.ones(4)
    assert mesh.all_reduce_sum(m, t) is t


def test_one_process_drives_one_device():
    with pytest.raises(ValueError, match="one process drives one device"):
        mesh.Mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one slot"):
        mesh.Mesh([])
    with pytest.raises(ValueError, match="initialized torch.distributed"):
        mesh.Mesh(["cpu"], world=True)


@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_pad_to_multiple_equals_the_reference(multiple):
    for n in (0, 1, 5, 8, 9):
        a = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
        np.testing.assert_array_equal(
            mesh.pad_to_multiple(a, multiple, -1),
            jmesh.pad_to_multiple(a, multiple, -1))


def test_a_world_of_one_joins_through_gloo_and_is_idempotent(tmp_path):
    """A one-process gloo job (a ``file://`` rendezvous): the world's
    mesh runs its gather through the process group, a repeat join is a
    no-op and another topology is refused."""
    init = f"file://{tmp_path / 'rdzv'}"
    try:
        mesh.init_distributed("local", 1, 0, init_method=init,
                              device="cpu")
        mesh.init_distributed("local", 1, 0, init_method=init,
                              device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        m = mesh.get_mesh(device="cpu")
        assert m.distributed and m.size == 1 and m.local_slots == [0]
        out = mesh.all_gather_blocks(m, {0: torch.arange(6.).reshape(2, 3)})
        np.testing.assert_array_equal(out.numpy(),
                                      np.arange(6.).reshape(2, 3))
        t = torch.tensor([1, 2], dtype=torch.int32)
        assert mesh.all_reduce_sum(m, t).tolist() == [1, 2]
        with pytest.raises(RuntimeError, match="already initialized"):
            mesh.init_distributed("other", 2, 1, init_method=init,
                                  device="cpu")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        mesh.init_distributed._done = None
    assert mesh.world_size() == 1
