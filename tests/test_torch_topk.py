"""ops/topk.py of the PyTorch port against predictionio_tpu.ops.topk on
the same numpy inputs.

Tolerances: at rank 10 the batched fp32 products and the stable sort
match the JAX package bit for bit (the class is exact); the inline
matvec is within 1e-6 relative (see its test). At rank 64 the summation
order of the two matmuls differs, so scores agree within 1e-5 relative
and indices agree wherever neighbouring scores are further apart than
that."""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.ops import topk as ttopk

T = torch.from_numpy


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _factors(n_users, n_items, rank, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32))


@pytest.mark.parametrize("k", [1, 5, 17, 40])
def test_stable_topk_exact_with_engineered_ties(k):
    rng = np.random.default_rng(k)
    scores = rng.integers(-5, 5, size=(6, 40)).astype(np.float32)
    scores[2] = 0.0          # a total tie: the answer is the index order
    scores[3, ::2] = -0.0    # signed zeros order as equal
    jv, ji = jtopk.stable_topk(scores, k)
    tv, ti = ttopk.stable_topk(T(scores), k)
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_topk_for_users_tie_cases_of_the_reference():
    """tests/test_topk.py's cases: ties break by LOWEST item index."""
    U = np.eye(2, dtype=np.float32)
    V = np.array([[0.0, 1.0], [2.0, 0.0], [0.0, 1.0],
                  [2.0, 0.0], [2.0, 0.0]], dtype=np.float32)
    ixs = np.array([0, 1], np.int32)
    tv, ti = ttopk.topk_for_users(T(U), T(V), T(ixs), k=4)
    jv, ji = jtopk.topk_for_users(U, V, ixs, k=4)
    np.testing.assert_array_equal(ti.numpy(), [[1, 3, 4, 0], [0, 2, 1, 3]])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    V1 = np.array([[3.0, 0], [1.0, 0], [3.0, 0]], dtype=np.float32)
    _tv, ti1 = ttopk.topk_for_user(T(U), T(V1), 0, k=3)
    np.testing.assert_array_equal(ti1.numpy(), [0, 2, 1])


@pytest.mark.parametrize("k", [1, 10, 120])
def test_topk_for_users_exact_at_rank_10(k):
    U, V = _factors(30, 500, 10, seed=3)
    V[400] = V[7]                     # a tie the index order resolves
    ixs = np.array([0, 3, 3, 29, 11], np.int32)
    jv, ji = jtopk.topk_for_users(U, V, ixs, k=k)
    tv, ti = ttopk.topk_for_users(T(U), T(V), T(ixs), k=k)
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 10, 120])
def test_topk_for_user_within_tolerance_of_the_reference(k):
    """A matvec's summation order is the backend's choice: XLA's CPU
    matvec and torch's differ from each other (and from their matmuls)
    by up to a few ulp at rank 10, so the inline fp32 path is in the
    tolerance class: scores within 1e-6 relative, indices equal wherever
    the scores are further apart than that. (The quantized paths, which
    the deploy serves, are exact: tests/test_torch_quant.py.)"""
    U, V = _factors(30, 500, 10, seed=3)
    for ix in (0, 3, 29, 11):
        jv, ji = (np.asarray(a) for a in jtopk.topk_for_user(
            U, V, np.int32(ix), k=k))
        tv, ti = (a.numpy() for a in ttopk.topk_for_user(
            T(U), T(V), ix, k=k))
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
        _assert_separated_indices_equal(U[ix] @ V.T, ti, ji, k, 1e-6)


def _assert_separated_indices_equal(scores, ti, ji, k, rtol):
    """Indices must agree at every rank whose score is separated from
    its neighbours by more than ``rtol``."""
    s = np.sort(scores)[::-1][:k + 1]
    gaps = np.abs(np.diff(s)) > rtol * np.maximum(np.abs(s[1:]), 1.0)
    sep = np.ones(min(k, len(s)), bool)
    n = len(sep)
    if n > 1:
        sep[:-1] &= gaps[:n - 1]
        sep[1:] &= gaps[:n - 1]
    if len(gaps) >= n:
        sep[-1] &= gaps[n - 1]
    np.testing.assert_array_equal(ti[sep], ji[sep])


def test_topk_for_users_within_tolerance_at_rank_64():
    U, V = _factors(20, 800, 64, seed=4)
    ixs = np.arange(20, dtype=np.int32)
    k = 25
    jv, ji = (np.asarray(a) for a in jtopk.topk_for_users(U, V, ixs, k=k))
    tv, ti = (a.numpy() for a in ttopk.topk_for_users(T(U), T(V), T(ixs),
                                                      k=k))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    full = U @ V.T
    for row in range(20):
        _assert_separated_indices_equal(full[row], ti[row], ji[row], k,
                                        1e-5)


@pytest.mark.parametrize("k", [-3, 0, 1, 4, 6, 50])
def test_host_topk_matches_reference(k):
    cases = [np.array([2.0, 1.0, 2.0, 2.0, 0.5, 1.0], dtype=np.float32),
             np.full(50, 7.0, dtype=np.float32),
             np.array([9.0, 3.0, 3.0, 8.0, 3.0], dtype=np.float32),
             np.random.default_rng(7).integers(-5, 5, 64).astype(np.float32)]
    for scores in cases:
        jv, ji = jtopk.host_topk(scores, k)
        tv, ti = ttopk.host_topk(scores, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(_bits(tv), _bits(jv))


def test_neg_inf_is_the_reference_constant():
    assert np.float32(ttopk.NEG_INF).view(np.int32) == \
        np.asarray(jtopk.NEG_INF).view(np.int32)


@pytest.mark.parametrize("weighted", [False, True])
def test_host_masked_topk_matches_reference(weighted):
    """The item-scoring templates' host serving: the same numpy in both
    packages, so values and indices are equal bit for bit."""
    _U, V = _factors(1, 300, 10, seed=7)
    V[40] = V[11]                        # an exact tie
    rng = np.random.default_rng(8)
    q = V[11] + rng.normal(size=10).astype(np.float32) * 0.1
    Q = rng.normal(size=(5, 10)).astype(np.float32)
    masks = [rng.random(300) < p for p in (1.0, 0.5, 0.1, 0.01, 0.0)]
    w = (rng.choice([0.0, 0.5, 1.0, 3.0], 300).astype(np.float32)
         if weighted else None)
    for mask in masks:
        for k in (1, 10, 300, 0):
            tv, ti = ttopk.host_masked_topk(V, q, mask, k, weights=w)
            jv, ji = jtopk.host_masked_topk(V, q, mask, k, weights=w)
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
            np.testing.assert_array_equal(ti, ji)
    ks = [3, 10, 50, 1, 7]
    got = ttopk.host_masked_topk_batch(V, Q, masks, ks, weights=w)
    want = jtopk.host_masked_topk_batch(V, Q, masks, ks, weights=w)
    assert len(got) == len(want) == 5
    for (tv, ti), (jv, ji) in zip(got, want):
        np.testing.assert_array_equal(_bits(tv), _bits(jv))
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("masked", [False, True])
def test_cosine_topk_within_tolerance_of_the_reference(masked):
    """Cosine scores: the norms and the product round in another order,
    so scores agree within 1e-5 relative and indices wherever the
    neighbouring scores are further apart than that."""
    _U, V = _factors(1, 500, 10, seed=9)
    V[3] *= 0.0                          # a zero row: the norm floor
    q = np.random.default_rng(10).normal(size=10).astype(np.float32)
    mask = (np.random.default_rng(11).random(500) < 0.6) if masked \
        else None
    k = 25
    tv, ti = ttopk.cosine_topk(T(q), T(V), None if mask is None
                               else T(mask), k=k)
    jv, ji = jtopk.cosine_topk(q, V, mask, k=k)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    jv = np.asarray(jv)
    gaps = np.abs(np.diff(jv))
    clear = np.concatenate([[gaps[0]], np.minimum(gaps[:-1], gaps[1:]),
                            [gaps[-1]]]) > 1e-5
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    assert ti.dtype == torch.int32
