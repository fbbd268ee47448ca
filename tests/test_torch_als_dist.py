"""Block-sharded ALS of the port (``predictionio_tpu_torch/parallel/
als_dist.py``) against the JAX package's ``parallel/als_dist.py``, on
shard slots that share this process's CPU (the counterpart of the
reference tier-1's virtual devices).

Parity classes: the LPT deal and the sharded layout (``_shard_side``,
``prepare_sharded``) are integer work and exact. Trained factors are fp32
sums in another order than XLA's: held to rtol 2e-3 / atol 2e-4 (the
reference's golden-train tolerance) against the reference's
``train_explicit_sharded(get_mesh(n), ...)`` / ``train_implicit_sharded``
from shared ``u0``/``v0``. Two runs from one seed, and a resumed run, are
bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel import als_dist as jdist
from predictionio_tpu.parallel.mesh import get_mesh as jget_mesh
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel import als_dist
from predictionio_tpu_torch.parallel.mesh import Mesh
from predictionio_tpu_torch.workflow.checkpoint import FactorCheckpointer

RANK, LAM, ITERS, ALPHA = 4, 0.05, 4, 1.3
RTOL, ATOL = 2e-3, 2e-4


def _zipf(n_u=90, n_i=37, nnz=1500, seed=0):
    """Power-law users and items, so the deal's heap and serpentine
    rounds both run, and a few rows span chunk boundaries."""
    rng = np.random.default_rng(seed)
    user_w = rng.lognormal(0.0, 1.2, n_u)
    item_w = 1.0 / np.arange(1, n_i + 1) ** 0.8
    u = rng.choice(n_u, size=nnz, p=user_w / user_w.sum()).astype(np.int32)
    i = rng.choice(n_i, size=nnz, p=item_w / item_w.sum()).astype(np.int32)
    # every row rated at least once
    u = np.concatenate([u, np.arange(n_u, dtype=np.int32),
                        rng.integers(0, n_u, n_i).astype(np.int32)])
    i = np.concatenate([i, rng.integers(0, n_i, n_u).astype(np.int32),
                        np.arange(n_i, dtype=np.int32)])
    r = np.clip(rng.normal(3.5, 1.1, u.shape[0]), 0.5, 5.0
                ).astype(np.float32)
    return u, i, r, n_u, n_i


def _factors(n_u, n_i, seed=5):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(size=(n_u, RANK))).astype(np.float32) / 2,
            np.abs(rng.normal(size=(n_i, RANK))).astype(np.float32) / 2)


def _mesh(n):
    return Mesh(["cpu"] * n)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("chunk", [16, 64])
def test_lpt_deal_and_layout_equal_the_reference(n_dev, chunk):
    u, i, r, n_u, n_i = _zipf()
    ref = jals.prepare_ratings(u, i, r, n_u, n_i, chunk=chunk)
    got = als.prepare_ratings(u, i, r, n_u, n_i, chunk=chunk)
    for side in ("by_user", "by_item"):
        want = jdist._shard_side(getattr(ref, side), n_dev, chunk)
        have = als_dist._shard_side(getattr(got, side), n_dev, chunk)
        for f in ("self_idx", "other_idx", "rating", "counts", "pos",
                  "nnz_per_dev"):
            w, h = np.asarray(getattr(want, f)), getattr(have, f)
            assert h.dtype == w.dtype, (side, f)
            np.testing.assert_array_equal(h, w, err_msg=f"{side}.{f}")
        for f in ("rows_dev", "nnz_dev", "n_rows_pad"):
            assert getattr(have, f) == getattr(want, f), (side, f)
    # both sides, cross-remapped into the other side's address space
    jsu, jsi = jdist.prepare_sharded(ref, n_dev, chunk)
    su, si = als_dist.prepare_sharded(got, n_dev, chunk)
    np.testing.assert_array_equal(su.other_idx, jsu.other_idx)
    np.testing.assert_array_equal(si.other_idx, jsi.other_idx)


def test_deal_balances_skewed_rows_within_capacity():
    u, i, r, n_u, n_i = _zipf(n_u=400, n_i=60, nnz=8000, seed=3)
    side = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64).by_item
    sh = als_dist._shard_side(side, 4, 64)
    used = np.bincount(sh.pos // sh.rows_dev, minlength=4)
    assert used.max() <= sh.rows_dev
    assert len(set(sh.pos.tolist())) == n_i          # a permutation
    assert sh.nnz_per_dev.sum() == len(u)
    assert sh.nnz_per_dev.max() <= 1.15 * len(u) / 4


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_explicit_factors_match_the_reference(n_dev):
    u, i, r, n_u, n_i = _zipf(seed=1)
    u0, v0 = _factors(n_u, n_i)
    ref = jals.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    jU, jV = jdist.train_explicit_sharded(
        jget_mesh(n_dev), ref, rank=RANK, iterations=ITERS, lambda_=LAM,
        chunk=64, u0=jnp.asarray(u0), v0=jnp.asarray(v0))
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    U, V = als_dist.train_explicit_sharded(
        _mesh(n_dev), data, rank=RANK, iterations=ITERS, lambda_=LAM,
        chunk=64, u0=u0, v0=v0)
    assert U.shape == (n_u, RANK) and V.shape == (n_i, RANK)
    np.testing.assert_allclose(_np(U), np.asarray(jU), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(V), np.asarray(jV), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_implicit_factors_match_the_reference(n_dev):
    u, i, r, n_u, n_i = _zipf(seed=2)
    r = np.where(np.arange(len(r)) % 5 == 0, -r, r).astype(np.float32)
    u0, v0 = _factors(n_u, n_i, seed=6)
    ref = jals.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    jU, jV = jdist.train_implicit_sharded(
        jget_mesh(n_dev), ref, rank=RANK, iterations=ITERS, lambda_=LAM,
        alpha=ALPHA, chunk=64, u0=jnp.asarray(u0), v0=jnp.asarray(v0))
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    U, V = als_dist.train_implicit_sharded(
        _mesh(n_dev), data, rank=RANK, iterations=ITERS, lambda_=LAM,
        alpha=ALPHA, chunk=64, u0=u0, v0=v0)
    np.testing.assert_allclose(_np(U), np.asarray(jU), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(V), np.asarray(jV), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_matches_the_ports_single_device_train(n_dev):
    u, i, r, n_u, n_i = _zipf(seed=4)
    u0, v0 = _factors(n_u, n_i, seed=8)
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    U1, V1 = als.train_explicit(data, rank=RANK, iterations=ITERS,
                                lambda_=LAM, chunk=64, u0=u0, v0=v0,
                                device="cpu")
    U, V = als_dist.train_explicit_sharded(
        _mesh(n_dev), data, rank=RANK, iterations=ITERS, lambda_=LAM,
        chunk=64, u0=u0, v0=v0)
    np.testing.assert_allclose(_np(U), _np(U1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(V), _np(V1), rtol=RTOL, atol=ATOL)


def test_kernel_a_runs_once_per_slot_per_half_step(monkeypatch):
    calls = []
    real = als.solve_factors

    def counting(A, b, reg):
        calls.append(int(A.shape[0]))
        return real(A, b, reg)

    monkeypatch.setattr(als, "solve_factors", counting)
    u, i, r, n_u, n_i = _zipf(seed=5)
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    als_dist.train_explicit_sharded(_mesh(4), data, rank=RANK,
                                    iterations=3, lambda_=LAM, chunk=64,
                                    seed=2)
    assert len(calls) == 4 * 2 * 3
    # each call solves one slot's rows: users, then items, slot by slot
    assert calls[:8] == [-(-n_u // 4)] * 4 + [-(-n_i // 4)] * 4


def test_two_runs_from_one_seed_are_bit_identical():
    u, i, r, n_u, n_i = _zipf(seed=6)
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    a = als_dist.train_explicit_sharded(_mesh(3), data, rank=RANK,
                                        iterations=ITERS, seed=11, chunk=64)
    b = als_dist.train_explicit_sharded(_mesh(3), data, rank=RANK,
                                        iterations=ITERS, seed=11, chunk=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_resume_is_bit_equal_and_snapshots_are_canonical(tmp_path):
    u, i, r, n_u, n_i = _zipf(seed=7)
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    kw = dict(rank=RANK, iterations=6, lambda_=LAM, seed=4, chunk=64)
    U_full, V_full = als_dist.train_explicit_sharded(_mesh(4), data, **kw)
    ck = FactorCheckpointer(str(tmp_path / "ck"))
    U2, V2 = als_dist.train_explicit_sharded(
        _mesh(4), data, **kw, checkpoint_every=2, checkpointer=ck)
    assert torch.equal(U2, U_full) and torch.equal(V2, V_full)
    step, arrays = ck.latest()
    assert step == 4 and arrays["U"].shape == (n_u, RANK)
    # a run that resumes from the step-4 snapshot ends where the
    # uninterrupted one did
    U3, V3 = als_dist.train_explicit_sharded(
        _mesh(4), data, **kw, checkpoint_every=2, checkpointer=ck)
    assert torch.equal(U3, U_full) and torch.equal(V3, V_full)
    # the canonical snapshot resumes on another slot count, and on one
    # device
    U4, V4 = als_dist.train_explicit_sharded(
        _mesh(2), data, **kw, checkpoint_every=2, checkpointer=ck)
    U5, V5 = als.train_explicit(data, **kw, checkpoint_every=2,
                                checkpointer=ck, device="cpu")
    for U, V in ((U4, V4), (U5, V5)):
        np.testing.assert_allclose(_np(U), _np(U_full), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_np(V), _np(V_full), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_streamed_assembly_trains_like_the_reference(n_dev):
    u, i, r, n_u, n_i = _zipf(seed=9)
    u0, v0 = _factors(n_u, n_i, seed=3)
    pre = als_dist.shard_staged_coo(
        _mesh(n_dev), torch.from_numpy(u), torch.from_numpy(i),
        torch.from_numpy(r), n_users=n_u, n_items=n_i, chunk=64,
        route_rows=300)
    assert pre.nnz == len(u)
    np.testing.assert_array_equal(pre.su.pos, np.arange(n_u))
    jpre = jdist.shard_staged_coo(
        jget_mesh(n_dev), jnp.asarray(u), jnp.asarray(i), jnp.asarray(r),
        n_users=n_u, n_items=n_i, chunk=64, route_rows=300)
    for side, jside in ((pre.su, jpre.su), (pre.si, jpre.si)):
        assert (side.rows_dev, side.nnz_dev) == (jside.rows_dev,
                                                 jside.nnz_dev)
        np.testing.assert_array_equal(side.nnz_per_dev, jside.nnz_per_dev)
        flat = [torch.cat([side.local[d][k] for d in range(n_dev)])
                for k in range(4)]
        for k, f in enumerate(("self_idx", "other_idx", "rating",
                               "counts")):
            np.testing.assert_array_equal(
                _np(flat[k]), np.asarray(getattr(jside, f)), err_msg=f)
    jU, jV = jdist.train_explicit_sharded(
        jget_mesh(n_dev), jpre, rank=RANK, iterations=ITERS, lambda_=LAM,
        chunk=64, u0=jnp.asarray(u0), v0=jnp.asarray(v0))
    U, V = als_dist.train_explicit_sharded(
        _mesh(n_dev), pre, rank=RANK, iterations=ITERS, lambda_=LAM,
        chunk=64, u0=u0, v0=v0)
    np.testing.assert_allclose(_np(U), np.asarray(jU), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(V), np.asarray(jV), rtol=RTOL, atol=ATOL)


def test_unknown_kernel_is_refused_with_the_reference_message():
    u, i, r, n_u, n_i = _zipf(seed=10)
    data = als.prepare_ratings(u, i, r, n_u, n_i, chunk=64)
    with pytest.raises(ValueError, match="unknown ALS kernel"):
        als_dist.train_explicit_sharded(_mesh(2), data, rank=RANK,
                                        iterations=1, kernel="dense")
