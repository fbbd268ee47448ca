"""Kernel A's plain version (``predictionio_tpu_torch/ops/solve.py``)
against the JAX package's ``solve_factors`` (the XLA Gauss-Jordan sweep)
and its Pallas kernel in interpret mode, on the same seeded systems.

Tolerances: a well-posed SPD batch agrees to rel 1e-5 (the plain sweep
is the reference's sweep; XLA on the CPU may contract or reorder);
the reference's deliberately marginal rank-3 batch is held to its own
test's tolerance (rtol 5e-2, atol 5e-3) plus the residual check. The
kernel itself is held to this plain version exactly on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops.solve_pallas import solve_factors_pallas
from predictionio_tpu_torch.ops import solve


def _spd(n, r, seed, inner=None):
    """(A, b, reg): A = F F^T with F (r, inner); inner < r is rank
    deficient, the reference's marginal batch."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, r, inner or r + 2)).astype(np.float32)
    A = np.einsum("nri,nsi->nrs", F, F).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    reg = rng.uniform(0.05, 0.5, n).astype(np.float32)
    return A, b, reg


def _port(A, b, reg):
    return solve.solve_factors(torch.from_numpy(A), torch.from_numpy(b),
                               torch.from_numpy(reg)).numpy()


def _xla(A, b, reg):
    return np.asarray(jals.solve_factors(jnp.asarray(A), jnp.asarray(b),
                                         jnp.asarray(reg)))


def _pallas(A, b, reg):
    return np.asarray(solve_factors_pallas(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(reg), interpret=True))


def _rel(x, ref):
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("r,n", [(1, 700), (10, 700), (32, 130)])
def test_plain_matches_reference_sweep_well_posed(monkeypatch, r, n):
    monkeypatch.setenv("PIO_ALS_SOLVER", "gj")
    A, b, reg = _spd(n, r, seed=r)
    x = _port(A, b, reg)
    assert x.shape == (n, r) and x.dtype == np.float32
    assert _rel(x, _xla(A, b, reg)) < 1e-5


@pytest.mark.parametrize("r", [1, 10])
def test_plain_matches_pallas_interpret_well_posed(r):
    # n = 700 is not a multiple of the Pallas kernel's 512-lane block
    A, b, reg = _spd(700, r, seed=10 + r)
    assert _rel(_port(A, b, reg), _pallas(A, b, reg)) < 1e-5


def test_marginal_rank3_batch_at_the_reference_tolerance(monkeypatch):
    """The batch of tests/test_als.py TestPallasSolver.systems: PSD of
    rank 3 < r plus a small ridge, deliberately marginal."""
    monkeypatch.setenv("PIO_ALS_SOLVER", "gj")
    A, b, reg = _spd(700, 10, seed=0, inner=3)
    x = _port(A, b, reg)
    r = A.shape[-1]
    Ar = A + reg[:, None, None] * np.eye(r, dtype=np.float32)[None]
    for ref in (_xla(A, b, reg), _pallas(A, b, reg)):
        np.testing.assert_allclose(x, ref, rtol=5e-2, atol=5e-3)
        resid = np.einsum("nrs,ns->nr", Ar, x) - b
        ref_resid = np.einsum("nrs,ns->nr", Ar, ref) - b
        assert np.abs(resid).max() < max(2 * np.abs(ref_resid).max(), 1e-3)


def _indefinite_batch():
    """tests/test_als.py::test_solve_factors_clamps_indefinite_rows."""
    rng = np.random.default_rng(0)
    r, n = 6, 64
    M = rng.normal(0, 1, (n, r, r)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", M, M)
    for row in (3, 17, 40):
        v = rng.normal(0, 1, r).astype(np.float32)
        A[row] -= 3.0 * np.linalg.norm(A[row]) * np.outer(v, v) \
            / np.dot(v, v)
    b = rng.normal(0, 1, (n, r)).astype(np.float32)
    reg = np.full(n, 0.05, np.float32)
    return A.astype(np.float32), b, reg


def test_floor_bounds_the_indefinite_batch(monkeypatch):
    monkeypatch.setenv("PIO_ALS_SOLVER", "gj")
    A, b, reg = _indefinite_batch()
    x = _port(A, b, reg)
    r, n = A.shape[-1], A.shape[0]
    assert np.isfinite(x).all()
    clean = np.setdiff1d(np.arange(n), [3, 17, 40])
    ref = np.linalg.solve(
        A[clean] + reg[clean, None, None] * np.eye(r),
        b[clean][..., None])[..., 0]
    np.testing.assert_allclose(x[clean], ref, rtol=2e-3, atol=2e-3)
    assert np.abs(x).max() < np.abs(b).max() * (2 / 0.05) * r
    # the floored rows follow the reference's sweep too
    np.testing.assert_allclose(x, _xla(A, b, reg), rtol=1e-4, atol=1e-5)


def test_rank_above_32_takes_linalg_solve(monkeypatch):
    monkeypatch.setenv("PIO_ALS_SOLVER", "gj")
    A, b, reg = _spd(40, 40, seed=3)
    assert _rel(_port(A, b, reg), _xla(A, b, reg)) < 1e-4


def test_plain_adds_reg_as_the_reference():
    A, b, reg = _spd(5, 4, seed=1)
    got = solve.with_reg(torch.from_numpy(A), torch.from_numpy(reg)).numpy()
    np.testing.assert_array_equal(
        got, A + reg[:, None, None] * np.eye(4, dtype=np.float32)[None])


def test_unsupported_device_raises():
    A = torch.zeros((2, 3, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        solve.solve_factors(A, torch.zeros((2, 3), device="meta"),
                            torch.zeros((2,), device="meta"))


def test_empty_batch():
    x = _port(np.zeros((0, 10, 10), np.float32), np.zeros((0, 10),
                                                           np.float32),
              np.zeros((0,), np.float32))
    assert x.shape == (0, 10)
