"""The ALS layers of the port (``predictionio_tpu_torch/ops/als.py``)
against the JAX package's ``ops/als.py`` on the same seeded ratings.

Parity classes: layouts, counts, ``bucket_units`` and
``declared_nnz_pad`` are exact. Gram sums, half-steps and trained factors
are fp32 sums in another order than XLA's ``segment_sum``: they are held
to rtol 1e-4 / atol 1e-5 for one Gram or half-step and rtol 2e-3 / atol
2e-4 for a whole train (the reference's golden-train tolerance). Seeds
are not replayed: the trainers get the same ``u0``/``v0``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.workflow.checkpoint import FactorCheckpointer

N_U, N_I, RANK, LAM, ITERS, ALPHA = 30, 17, 4, 0.07, 5, 1.3
CHUNK = 32     # several chunks, rows spanning chunk boundaries


def _problem(seed=13, density=0.4, signed=False):
    rng = np.random.default_rng(seed)
    mask = rng.random((N_U, N_I)) < density
    mask[np.arange(N_U), rng.integers(0, N_I, N_U)] = True
    mask[rng.integers(0, N_U, N_I), np.arange(N_I)] = True
    ui, ii = np.nonzero(mask)
    perm = rng.permutation(ui.shape[0])      # unsorted input, as read
    vals = rng.uniform(0.5, 5.0, ui.shape[0]).astype(np.float32)
    if signed:
        vals *= rng.choice([-1.0, 1.0], ui.shape[0]).astype(np.float32)
    return ui[perm].astype(np.int32), ii[perm].astype(np.int32), vals


def _factors(seed=21):
    rng = np.random.default_rng(seed)
    U0 = (np.abs(rng.normal(size=(N_U, RANK))) / np.sqrt(RANK))
    V0 = (np.abs(rng.normal(size=(N_I, RANK))) / np.sqrt(RANK))
    return U0.astype(np.float32), V0.astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("bucketing", ["1", "0"])
def test_layout_is_bit_identical_to_the_reference(monkeypatch, bucketing):
    monkeypatch.setenv("PIO_NNZ_BUCKETING", bucketing)
    ui, ii, vals = _problem()
    ref = jals.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    host = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    dev = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK,
                              on_device=True, device="cpu")
    for got in (host, dev):
        assert (got.n_users, got.n_items, got.nnz) == \
            (ref.n_users, ref.n_items, ref.nnz)
        for side in ("by_user", "by_item"):
            r, g = getattr(ref, side), getattr(got, side)
            assert (g.n_self, g.n_other) == (r.n_self, r.n_other)
            for f in ("self_idx", "other_idx", "rating", "counts"):
                want, have = np.asarray(getattr(r, f)), _np(getattr(g, f))
                assert have.dtype == want.dtype, (side, f)
                np.testing.assert_array_equal(have, want)


def test_bucket_units_and_declared_pad_match():
    for n in list(range(0, 300)) + [10_000, 123_456, 20_000_263]:
        assert als.bucket_units(n) == jals.bucket_units(n)
        assert als.declared_nnz_pad(n) == jals.declared_nnz_pad(n)
        assert als.declared_nnz_pad(n, 64) == jals.declared_nnz_pad(n, 64)


def test_kernel_flag_takes_the_reference_names(monkeypatch):
    for k in ("hybrid", "csrb", "scan"):
        assert als._kernel_flag(k) == jals._kernel_flag(k)
    monkeypatch.setenv("PIO_ALS_KERNEL", "csrb")
    assert als._kernel_flag(None) == "csrb"
    with pytest.raises(ValueError) as port_err:
        als._kernel_flag("dense")
    with pytest.raises(ValueError) as ref_err:
        jals._kernel_flag("dense")
    assert str(port_err.value) == str(ref_err.value)


def test_reg_vec_matches():
    counts = np.array([0, 1, 2, 7, 100], np.int32)
    for scaling in ("count", "constant"):
        got = als._reg_vec(torch.from_numpy(counts), 5, LAM, scaling)
        want = jals._reg_vec(jnp.asarray(counts), 5, LAM, scaling)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gram_inputs():
    ui, ii, vals = _problem()
    data = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    side = data.by_user
    _U0, V0 = _factors()
    w = (side.self_idx < N_U).astype(np.float32)
    return side, V0, w


def test_gram_rhs_matches_and_is_deterministic():
    side, V0, w = _gram_inputs()
    args = (side.self_idx, side.other_idx, w, side.rating)
    A, b = als.gram_rhs(torch.from_numpy(V0),
                        *[torch.from_numpy(a) for a in args], N_U, CHUNK)
    JA, Jb = jals.gram_rhs(jnp.asarray(V0), *[jnp.asarray(a) for a in args],
                           N_U, CHUNK)
    np.testing.assert_allclose(A.numpy(), np.asarray(JA), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(Jb), rtol=1e-4,
                               atol=1e-5)
    A2, b2 = als.gram_rhs(torch.from_numpy(V0),
                          *[torch.from_numpy(a) for a in args], N_U, CHUNK)
    assert torch.equal(A, A2) and torch.equal(b, b2)


@pytest.mark.parametrize("implicit", [False, True])
def test_half_steps_match(implicit):
    side, V0, _w = _gram_inputs()
    t = [torch.from_numpy(np.asarray(a)) for a in (
        side.self_idx, side.other_idx, side.rating, side.counts)]
    j = [jnp.asarray(a) for a in (side.self_idx, side.other_idx,
                                  side.rating, side.counts)]
    if implicit:
        got = als._half_step_implicit(torch.from_numpy(V0), *t, N_U, LAM,
                                      ALPHA, CHUNK, "count")
        want = jals._half_step_implicit(jnp.asarray(V0), *j, N_U, LAM,
                                        ALPHA, CHUNK, "count")
    else:
        got = als._half_step_explicit(torch.from_numpy(V0), *t, N_U, LAM,
                                      CHUNK, "count")
        want = jals._half_step_explicit(jnp.asarray(V0), *j, N_U, LAM,
                                        CHUNK, "count")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["hybrid", "csrb", "scan"])
@pytest.mark.parametrize("implicit", [False, True])
def test_train_matches_reference_with_injected_factors(monkeypatch, kernel,
                                                       implicit):
    monkeypatch.setenv("PIO_ALS_KERNEL", kernel)
    ui, ii, vals = _problem(signed=implicit)
    U0, V0 = _factors()
    jdata = jals.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    data = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    common = dict(rank=RANK, iterations=ITERS, lambda_=LAM, u0=U0, v0=V0,
                  chunk=CHUNK)
    if implicit:
        JU, JV = jals.train_implicit(jdata, alpha=ALPHA, **common)
        U, V = als.train_implicit(data, alpha=ALPHA, device="cpu", **common)
    else:
        JU, JV = jals.train_explicit(jdata, **common)
        U, V = als.train_explicit(data, device="cpu", **common)
    assert U.device.type == "cpu" and U.dtype == torch.float32
    np.testing.assert_allclose(U.numpy(), np.asarray(JU), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(V.numpy(), np.asarray(JV), rtol=2e-3,
                               atol=2e-4)


def test_resume_mid_train_is_bit_equal_to_uninterrupted(tmp_path):
    """A run "crashed" after 3 of 5 iterations (snapshot at step 2)
    resumes to 5 and lands on exactly the uninterrupted factors."""
    ui, ii, vals = _problem()
    U0, V0 = _factors()
    data = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    common = dict(rank=RANK, lambda_=LAM, u0=U0, v0=V0, chunk=CHUNK,
                  device="cpu")
    want_U, want_V = als.train_explicit(data, iterations=ITERS, **common)
    ckpt = FactorCheckpointer(str(tmp_path / "ck"))
    als.train_explicit(data, iterations=3, checkpoint_every=2,
                       checkpointer=ckpt, **common)
    assert ckpt.latest()[0] == 2
    U, V = als.train_explicit(data, iterations=ITERS, checkpoint_every=2,
                              checkpointer=ckpt, **common)
    assert torch.equal(U, want_U) and torch.equal(V, want_V)


def test_incompatible_checkpoint_refused(tmp_path):
    ui, ii, vals = _problem()
    data = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    ckpt = FactorCheckpointer(str(tmp_path / "ck"))
    ckpt.save(1, {"U": np.zeros((N_U, RANK + 1), np.float32),
                  "V": np.zeros((N_I, RANK + 1), np.float32)})
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        als.train_explicit(data, rank=RANK, iterations=3,
                           checkpoint_every=1, checkpointer=ckpt,
                           device="cpu")


def test_seeded_factors_come_from_a_torch_generator():
    U, V = als._seed_factors(5, N_U, N_I, RANK, device="cpu")
    U2, V2 = als._seed_factors(5, N_U, N_I, RANK, device="cpu")
    assert torch.equal(U, U2) and torch.equal(V, V2)
    assert U.shape == (N_U, RANK) and V.shape == (N_I, RANK)
    assert (U >= 0).all() and not torch.equal(U, als._seed_factors(
        6, N_U, N_I, RANK, device="cpu")[0])


def test_the_item_init_does_not_depend_on_the_user_count():
    """The reference splits its key per side: a retrain with more users
    (continuous training) starts from the same item factors."""
    _U, V = als._seed_factors(5, N_U, N_I, RANK, device="cpu")
    U2, V2 = als._seed_factors(5, N_U + 17, N_I, RANK, device="cpu")
    assert torch.equal(V, V2) and U2.shape == (N_U + 17, RANK)


def test_rmse_matches_and_clamps_padding():
    ui, ii, vals = _problem()
    U0, V0 = _factors()
    data = als.prepare_ratings(ui, ii, vals, N_U, N_I, chunk=CHUNK)
    bu = data.by_user
    mask = (bu.self_idx < N_U).astype(np.float32)
    got = als.rmse(torch.from_numpy(U0), torch.from_numpy(V0), bu.self_idx,
                   bu.other_idx, bu.rating, mask, chunk=CHUNK)
    want = jals.rmse(jnp.asarray(U0), jnp.asarray(V0),
                     jnp.asarray(bu.self_idx), jnp.asarray(bu.other_idx),
                     jnp.asarray(bu.rating), jnp.asarray(mask), chunk=CHUNK)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gram_rhs_long_runs_in_pieces_match():
    """A row with more ratings than one reduction piece (row 0 here,
    1,500 entries, and the padding run) is summed in two levels."""
    rng = np.random.default_rng(0)
    n, chunk = 5000, 2048
    ui = np.concatenate([np.zeros(1500, np.int32),
                         rng.integers(0, 40, n - 1500).astype(np.int32)])
    ii = rng.integers(0, 30, n).astype(np.int32)
    vals = rng.uniform(0.5, 5, n).astype(np.float32)
    side = als.prepare_ratings(ui, ii, vals, 40, 30, chunk=chunk).by_user
    V = rng.normal(size=(30, 5)).astype(np.float32)
    w = (side.self_idx < 40).astype(np.float32)
    args = (side.self_idx, side.other_idx, w, side.rating)
    plan = als.gram_plan(torch.from_numpy(side.self_idx), chunk)
    assert plan[0].pieces_per_row is not None
    A, b = als.gram_rhs(torch.from_numpy(V),
                        *[torch.from_numpy(a) for a in args], 40, chunk,
                        plan)
    JA, Jb = jals.gram_rhs(jnp.asarray(V), *[jnp.asarray(a) for a in args],
                           40, chunk)
    np.testing.assert_allclose(A.numpy(), np.asarray(JA), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(Jb), rtol=1e-4,
                               atol=1e-4)
