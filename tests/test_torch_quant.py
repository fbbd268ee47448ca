"""ops/quant.py of the PyTorch port against predictionio_tpu.ops.quant
on the same numpy inputs. The class is exact throughout: quantized
bytes, scales, top-k values (as bits) and indices, and the parity probe's
numbers must be identical."""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import quant as jquant
from predictionio_tpu_torch.ops import quant as tquant


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PIO_SERVE_QUANT", "PIO_SERVE_FUSED", "PIO_SERVE_FUSED_TILE",
                "PIO_SERVE_QUANT_RECALL_MIN", "PIO_TORCH_DEVICE"):
        monkeypatch.delenv(var, raising=False)


def _factors(n_users=33, n_items=1100, rank=10, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, rank)).astype(np.float32)
    V = rng.normal(size=(n_items, rank)).astype(np.float32)
    V[707] = V[3]
    V[13] = V[3]
    return U, V


def test_quantize_rows_byte_exact():
    U, _ = _factors()
    U[5] = 0.0                              # an all-zero row: scale 1.0
    U[6, 2] = 1e-30                         # a tiny amax
    tq, ts = tquant.quantize_rows(U)
    jq, js = jquant.quantize_rows(U)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq.tobytes() == jq.tobytes()
    assert ts.tobytes() == js.tobytes()
    np.testing.assert_array_equal(
        tquant.dequantize_rows(tq, ts).view(np.int32),
        jquant.dequantize_rows(jq, js).view(np.int32))


@pytest.mark.parametrize("k,sample", [(10, 256), (3, 7)])
def test_ranking_parity_values_equal(k, sample):
    U, V = _factors(seed=1)
    tqf = tquant.QuantizedFactors.from_factors(U, V)
    jqf = jquant.QuantizedFactors.from_factors(U, V)
    assert tquant.ranking_parity(U, V, tqf, k=k, sample=sample) == \
        jquant.ranking_parity(U, V, jqf, k=k, sample=sample)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("tile", ["256", "512"])
def test_serving_topk_and_topk_one_bit_identical(fused, tile, monkeypatch):
    """QuantizedServing.topk / topk_one, port (cpu) against the JAX
    package's, both fused ("1": JAX Pallas interpret, port plain
    version) and plain ("0"), bucket sizes down to 1."""
    monkeypatch.setenv("PIO_SERVE_FUSED", fused)
    monkeypatch.setenv("PIO_SERVE_FUSED_TILE", tile)
    U, V = _factors(seed=2)
    jqf = jquant.QuantizedFactors.from_factors(U, V)
    tqf = tquant.QuantizedFactors.from_factors(U, V)
    js = jquant.QuantizedServing.build(jqf)
    ts = tquant.QuantizedServing.build(tqf, device="cpu")
    assert ts.fused == js.fused == (fused == "1")
    assert ts.vt_q.shape == tuple(js.vt_q.shape)
    assert ts.vt_q.numpy().tobytes() == np.asarray(js.vt_q).tobytes()
    assert ts.v_scale.numpy().tobytes() == np.asarray(js.v_scale).tobytes()
    for ixs, k in ((np.arange(16, dtype=np.int32), 10),
                   (np.asarray([7], np.int32), 40),
                   (np.asarray([0, 32, 5, 5], np.int32), 1)):
        jv, ji = jax.device_get(js.topk(ixs, k))
        tv, ti = ts.topk(ixs, k)
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      jv.view(np.int32))
        np.testing.assert_array_equal(ti.numpy(), ji)
    for ix in (0, 7, 32):
        jv, ji = jax.device_get(js.topk_one(np.int32(ix), 10))
        tv, ti = ts.topk_one(ix, 10)
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      jv.view(np.int32))
        np.testing.assert_array_equal(ti.numpy(), ji)


def test_summary_matches_the_reference_keys(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_FUSED", "1")
    U, V = _factors()
    jqf = jquant.QuantizedFactors.from_factors(U, V)
    tqf = tquant.QuantizedFactors.from_factors(U, V)
    js = jquant.QuantizedServing.build(jqf).summary()
    ts = tquant.QuantizedServing.build(tqf, device="cpu").summary()
    # on the CPU the port's fused path is the kernel's plain version, as
    # the JAX package's is the interpret mode
    assert ts == js


def test_out_of_bounds_user_rows_are_refused():
    U, V = _factors()
    ts = tquant.QuantizedServing.build(
        tquant.QuantizedFactors.from_factors(U, V), device="cpu")
    with pytest.raises(IndexError):
        ts.topk(np.asarray([0, 33], np.int32), 5)
    with pytest.raises(IndexError):
        ts.topk_one(-1, 5)


def test_mode_resolution(monkeypatch):
    assert tquant.configured_mode() == "auto"
    with tquant.deploy_scope("on", device="cpu"):
        assert tquant.serving_enabled()
    with tquant.deploy_scope("off", device="cpu"):
        assert not tquant.serving_enabled()
    # "auto" quantizes on the card, not on the CPU
    with tquant.deploy_scope("auto", device="cpu"):
        assert not tquant.serving_enabled()
    monkeypatch.setattr(tquant, "scoped_device",
                        lambda: torch.device("cuda"))
    with tquant.deploy_scope("auto"):
        assert tquant.serving_enabled()
    monkeypatch.setenv("PIO_SERVE_QUANT", "0")     # env wins
    with tquant.deploy_scope("on", device="cpu"):
        assert tquant.configured_mode() == "off"
        assert not tquant.serving_enabled()
    monkeypatch.setenv("PIO_SERVE_QUANT", "1")
    with tquant.deploy_scope("off", device="cpu"):
        assert tquant.serving_enabled()
    monkeypatch.delenv("PIO_SERVE_QUANT")
    with pytest.raises(ValueError):
        with tquant.deploy_scope("sometimes"):
            pass
    for mode in ("auto", "on", "off", "1", "0"):
        with tquant.deploy_scope(mode), jquant.deploy_scope(mode):
            assert tquant.configured_mode() == jquant.configured_mode()


def test_accept_parity_matches_the_reference(monkeypatch):
    low = {"recall": 0.5, "k": 10}
    high = {"recall": 0.995, "k": 10}
    for mode in ("auto", "on"):
        for p in (low, high):
            assert tquant.accept_parity(p, mode) == \
                jquant.accept_parity(p, mode)
    monkeypatch.setenv("PIO_SERVE_QUANT_RECALL_MIN", "0.4")
    assert tquant.recall_floor() == jquant.recall_floor() == 0.4
    assert tquant.accept_parity(low, "auto")
