"""Weights across packages: a model blob the JAX package wrote loads
into the PyTorch port without importing jax, anything else is refused,
and als_model_from_numpy builds the same model from plain arrays."""

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
from predictionio_tpu.workflow import model_io as jmodel_io
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.als_algorithm import ALSModel
from predictionio_tpu_torch.workflow import model_io

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
