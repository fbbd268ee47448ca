"""Weights across packages: a model blob the JAX package wrote loads
into the PyTorch port without importing jax, anything else is refused,
als_model_from_numpy builds the same model from plain arrays or trained
factors of either package, and iteration snapshots ({"U", "V"} npz)
written by either package resume training in the other."""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.models.recommendation.als_algorithm import (
    ALSModel as JALSModel,
)
from predictionio_tpu.ops import als as jals
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu.workflow.checkpoint import (
    FactorCheckpointer as JFactorCheckpointer,
)
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.als_algorithm import ALSModel
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.checkpoint import FactorCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_model(seed=0, n_users=30, n_items=70, rank=10):
    rng = np.random.default_rng(seed)
    return JALSModel(
        rank=rank,
        user_factors=rng.normal(size=(n_users, rank)).astype(np.float32),
        item_factors=rng.normal(size=(n_items, rank)).astype(np.float32),
        user_vocab=JBiMap.string_int(f"u{i}" for i in range(n_users)),
        item_vocab=JBiMap.string_int(f"i{i}" for i in range(n_items)))


def test_jax_blob_loads_into_port_model():
    jm = _jax_model()
    blob = jmodel_io.serialize_models([jm])
    (m,) = model_io.deserialize_models(blob)
    assert type(m) is ALSModel
    assert type(m.user_vocab) is BiMap and type(m.item_vocab) is BiMap
    assert m.rank == jm.rank
    assert m.user_factors.tobytes() == jm.user_factors.tobytes()
    assert m.item_factors.tobytes() == jm.item_factors.tobytes()
    assert m.user_factors.dtype == np.float32
    assert m.user_vocab.to_dict() == jm.user_vocab.to_dict()
    assert m.item_vocab.inverse().to_dict() == \
        jm.item_vocab.inverse().to_dict()
    assert m.sharding is None and m.quant is None


def test_jax_blob_loads_with_jax_blocked():
    """The loader resolves the blob's classes to the port's twins, so a
    process that cannot import jax or predictionio_tpu still loads it."""
    blob = jmodel_io.serialize_models([_jax_model(seed=1)])
    probe = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib",
                                          "predictionio_tpu"):
                    raise ImportError(name)
        sys.meta_path.insert(0, Block())
        from predictionio_tpu_torch.workflow import model_io
        (m,) = model_io.deserialize_models(sys.stdin.buffer.read())
        print(type(m).__module__, len(m.user_vocab), m.item_factors.shape)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", probe], input=blob,
                          capture_output=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().split() == [
        "predictionio_tpu_torch.models.recommendation.als_algorithm", "30",
        "(70,", "10)"]


class _Stranger:
    pass


@pytest.mark.parametrize("payload", [
    [_Stranger()],
    [os.system],
    [{"fn": print}],
])
def test_blob_naming_another_class_is_refused(payload):
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    with pytest.raises(pickle.UnpicklingError, match="does not load"):
        model_io.deserialize_models(blob)


def test_port_blob_roundtrips_and_loads_in_the_jax_package():
    rng = np.random.default_rng(3)
    U = rng.normal(size=(12, 4)).astype(np.float32)
    V = rng.normal(size=(9, 4)).astype(np.float32)
    uv = {f"user-{i}": i for i in range(12)}
    iv = {f"item-{i}": i for i in range(9)}
    m = model_io.als_model_from_numpy(4, U, V, uv, iv)
    blob = model_io.serialize_models([m])
    (back,) = model_io.deserialize_models(blob)
    assert back.rank == 4
    np.testing.assert_array_equal(back.user_factors, U)
    np.testing.assert_array_equal(back.item_factors, V)
    assert back.user_vocab == BiMap(uv) and back.item_vocab == BiMap(iv)
    # the JAX package's unrestricted loader reads the port's blob
    (jback,) = jmodel_io.deserialize_models(blob)
    np.testing.assert_array_equal(jback.item_factors, V)
    assert jback.item_vocab.to_dict() == iv


def test_als_model_from_numpy_equals_the_blob_path():
    jm = _jax_model(seed=4)
    (from_blob,) = model_io.deserialize_models(
        jmodel_io.serialize_models([jm]))
    direct = model_io.als_model_from_numpy(
        jm.rank, jm.user_factors, jm.item_factors,
        jm.user_vocab.to_dict(), jm.item_vocab.to_dict())
    assert direct.user_factors.tobytes() == from_blob.user_factors.tobytes()
    assert direct.item_factors.tobytes() == from_blob.item_factors.tobytes()
    assert direct.user_vocab == from_blob.user_vocab
    assert direct.item_vocab == from_blob.item_vocab


def test_als_model_from_numpy_checks_shapes():
    with pytest.raises(ValueError, match="disagree"):
        model_io.als_model_from_numpy(
            3, np.zeros((2, 3)), np.zeros((4, 2)), {"a": 0, "b": 1},
            {str(i): i for i in range(4)})


def _ratings(seed=2, n_users=25, n_items=14, rank=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((n_users, n_items)) < 0.5
    mask[np.arange(n_users), rng.integers(0, n_items, n_users)] = True
    mask[rng.integers(0, n_users, n_items), np.arange(n_items)] = True
    ui, ii = np.nonzero(mask)
    vals = rng.uniform(0.5, 5.0, ui.shape[0]).astype(np.float32)
    U0 = np.abs(rng.normal(size=(n_users, rank))).astype(np.float32)
    V0 = np.abs(rng.normal(size=(n_items, rank))).astype(np.float32)
    return (ui.astype(np.int32), ii.astype(np.int32), vals, n_users,
            n_items), U0, V0


def test_trained_factors_carry_across_both_ways():
    coo, U0, V0 = _ratings()
    kw = dict(rank=3, iterations=3, lambda_=0.05, u0=U0, v0=V0, chunk=64)
    JU, JV = jals.train_explicit(jals.prepare_ratings(*coo, chunk=64), **kw)
    uv = {f"u{i}": i for i in range(coo[3])}
    iv = {f"i{i}": i for i in range(coo[4])}
    m = model_io.als_model_from_numpy(3, JU, JV, uv, iv)
    assert m.user_factors.tobytes() == np.asarray(JU).tobytes()
    assert m.item_factors.tobytes() == np.asarray(JV).tobytes()
    TU, TV = als.train_explicit(als.prepare_ratings(*coo, chunk=64),
                                device="cpu", **kw)
    back = model_io.als_model_from_numpy(3, TU, TV, uv, iv)
    (jback,) = jmodel_io.deserialize_models(
        model_io.serialize_models([back]))
    assert np.asarray(jback.user_factors).tobytes() == \
        TU.numpy().tobytes()
    assert model_io.snapshot_arrays(TU, TV)["V"].tobytes() == \
        TV.numpy().tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_resume_in_the_other_package(tmp_path, writer):
    """A train of 5 iterations "crashes" after 3 in one package (snapshot
    at step 2); the other package resumes it to 5 and lands on its own
    uninterrupted result within the train tolerance (rtol 2e-3, atol
    2e-4)."""
    coo, U0, V0 = _ratings(seed=4)
    kw = dict(rank=3, lambda_=0.05, u0=U0, v0=V0, chunk=64)
    jdata = jals.prepare_ratings(*coo, chunk=64)
    tdata = als.prepare_ratings(*coo, chunk=64)
    d = str(tmp_path / "ck")
    if writer == "jax":
        jals.train_explicit(jdata, iterations=3, checkpoint_every=2,
                            checkpointer=JFactorCheckpointer(d), **kw)
        ckpt = FactorCheckpointer(d)
        step, arrays = ckpt.latest()
        U, V = als.train_explicit(tdata, iterations=5, checkpoint_every=2,
                                  checkpointer=ckpt, device="cpu", **kw)
        want_U, want_V = als.train_explicit(tdata, iterations=5,
                                            device="cpu", **kw)
        U, V, want_U, want_V = (x.numpy() for x in (U, V, want_U, want_V))
    else:
        als.train_explicit(tdata, iterations=3, checkpoint_every=2,
                           checkpointer=FactorCheckpointer(d), device="cpu",
                           **kw)
        ckpt = JFactorCheckpointer(d)
        step, arrays = ckpt.latest()
        U, V = jals.train_explicit(jdata, iterations=5, checkpoint_every=2,
                                   checkpointer=ckpt, **kw)
        want_U, want_V = jals.train_explicit(jdata, iterations=5, **kw)
    assert step == 2
    SU, SV = model_io.factors_from_snapshot(arrays)
    assert SU.shape == U0.shape and SV.dtype == np.float32
    np.testing.assert_allclose(np.asarray(U), np.asarray(want_U),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(V), np.asarray(want_V),
                               rtol=2e-3, atol=2e-4)


def test_snapshot_without_factors_is_refused():
    with pytest.raises(ValueError, match="'U' and 'V'"):
        model_io.factors_from_snapshot({"U": np.zeros((2, 2))})
