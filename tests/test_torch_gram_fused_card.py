"""Kernel G (``ops/gram_fused.py``, ``csrc/gram_fused.cu``) on the card,
against the plain Gram (``ops/als.py::gram_rhs_plain``) on the same card.

Marked ``card``: each test skips without a CUDA card (the fixture
decides). This file imports no JAX, so the card's machine runs it alone:
``python -m pytest tests/test_torch_gram_fused_card.py -q -m card
--noconftest -p no:cacheprovider``.

Tolerance: the two Grams sum the same fp32 products in other orders (the
kernel fuses each multiply-add and sums a row's pieces of 512 entries in
groups, then the pieces; the plain Gram rounds each product and sums runs
of 512 with ``segment_reduce``, in two levels). So each element of A and
b is held within ``TOL`` = 2^-14 (512 units in the last place) of the
sum of its terms' magnitudes, ``sum_n |a_n v_i v_j|``: the bound two
blocked fp32 sums of up to 233,000 terms (the largest row here) keep
with room, about thirty times the largest gap seen on the H100 (1.9e-6),
and below what one entry of a row of up to 16,000 weighs. The kernel is
held to the same bits from run to run, and its A to exact symmetry.
"""

import numpy as np
import pytest
import torch

TOL = 2.0 ** -14
CHUNK = 1 << 18


@pytest.fixture()
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def _gap(got, want, mag) -> float:
    return float(((got - want).abs() / mag.clamp(min=1e-30)).max())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _check(other, self_idx, other_idx, ca, cb, n_self, pieces=None):
    """Kernel G against the plain Gram on the same inputs: the largest gap
    over the magnitudes, and the rerun's bits."""
    from predictionio_tpu_torch.ops import als
    A, b = als.gram_rhs(other, self_idx, other_idx, ca, cb, n_self, CHUNK,
                        pieces)
    A2, b2 = als.gram_rhs(other, self_idx, other_idx, ca, cb, n_self, CHUNK,
                          pieces)
    P, Pb = als.gram_rhs_plain(other, self_idx, other_idx, ca, cb, n_self,
                               CHUNK)
    M, Mb = als.gram_rhs_plain(other.abs(), self_idx, other_idx, ca.abs(),
                               cb.abs(), n_self, CHUNK)
    torch.cuda.synchronize()
    assert A.is_contiguous() and b.is_contiguous()
    assert torch.equal(_bits(A), _bits(A2)) and torch.equal(_bits(b),
                                                            _bits(b2))
    assert torch.equal(A, A.transpose(1, 2))
    gap = max(_gap(A, P, M), _gap(b, Pb, Mb))
    assert gap <= TOL, gap
    return gap


def _layout(n_users, n_items, n, seed, dev, heavy=0):
    """A Zipf-like layout on the card: item i drawn with weight 1 / (i +
    1)^0.8, user 0 with ``heavy`` extra ratings (a row of many pieces)."""
    from predictionio_tpu_torch.ops import als
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_items + 1) ** 0.8
    items = rng.choice(n_items, size=n, p=w / w.sum()).astype(np.int32)
    users = rng.integers(0, n_users, n).astype(np.int32)
    users[:heavy] = 0
    ratings = rng.integers(1, 11, n).astype(np.float32) / 2
    ratings[::9] *= -1                 # signed, for the implicit weights
    return als.prepare_ratings(users, items, ratings, n_users, n_items,
                               on_device=True, device=dev)


def _weights(side, n_self, implicit, alpha=1.3):
    present = (side.self_idx < n_self).to(torch.float32)
    if not implicit:
        return present, side.rating
    conf = alpha * torch.abs(side.rating)
    return conf, (1.0 + conf) * (side.rating > 0).to(torch.float32)


@pytest.mark.card
@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("rank", [5, 10, 20, 32, 64, 100])
def test_kernel_g_matches_plain_at_every_rank(cuda_card, rank, implicit):
    from predictionio_tpu_torch.ops import als, gram_fused
    data = _layout(3000, 1200, 400_000, rank, cuda_card, heavy=3000)
    g = torch.Generator(device="cpu").manual_seed(rank)
    for side, n_other in ((data.by_user, data.n_items),
                          (data.by_item, data.n_users)):
        s = als._device_side(side, cuda_card)
        other = torch.randn((n_other, rank), generator=g).to(cuda_card)
        ca, cb = _weights(s, s.n_self, implicit)
        pieces = gram_fused.plan(s.self_idx, s.n_self)
        assert pieces.multi > 0            # the finishing pass runs
        _check(other, s.self_idx, s.other_idx, ca, cb, s.n_self, pieces)
        # the same with int32 other_idx and with no plan passed
        _check(other, s.self_idx, s.other_idx.to(torch.int32), ca, cb,
               s.n_self)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ml20m-als-r20", "netflix-als-r32"])
def test_kernel_g_matches_plain_at_the_cells_shapes(cuda_card, cell):
    import json
    from pathlib import Path

    from pio_bench import data as bench_data
    from predictionio_tpu_torch.ops import als, gram_fused
    root = Path(__file__).resolve().parent.parent
    cfg = json.loads((root / "pio_bench" / "configs" / f"{cell}.json")
                     .read_text())
    (u, i, r), (U, V) = bench_data.inputs(cfg, 2 ** 31 + 5, cuda_card)
    data = als.prepare_ratings(u, i, r, cfg["n_users"], cfg["n_items"],
                               on_device=True, device=cuda_card)
    del u, i, r
    for side, other in ((data.by_user, V), (data.by_item, U)):
        s = als._device_side(side, cuda_card)
        pieces = gram_fused.plan(s.self_idx, s.n_self)
        assert pieces.entries == data.nnz
        ca, cb = _weights(s, s.n_self, False)
        _check(other, s.self_idx, s.other_idx, ca, cb, s.n_self, pieces)
        del s, pieces, ca, cb
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("capped", [True, False], ids=["tick", "no_plan"])
@pytest.mark.parametrize("bucket", [1, 8, 64])
def test_kernel_g_at_the_foldin_buckets(cuda_card, bucket, capped):
    """A tick's shapes: pre-gathered rows, ``other_idx = arange``, int64
    ``self_idx`` with 256 slots a row, and the on-device plan under the
    history cap as ``foldin_solve`` builds it (one launch a Gram), or no
    plan at all (a finishing pass where the bucket passes one piece); the
    warm-up's all-padding batch gives zeros."""
    from predictionio_tpu_torch.ops import gram_fused
    from predictionio_tpu_torch.realtime import foldin
    me = foldin.max_events_per_user()
    nnz = bucket * me
    rng = np.random.default_rng(bucket)
    per = rng.integers(0, me + 1, bucket)
    self_idx = np.full(nnz, bucket, np.int64)
    self_idx[:per.sum()] = np.repeat(np.arange(bucket), per)
    rows = torch.from_numpy(
        rng.normal(size=(nnz, 20)).astype(np.float32)).to(cuda_card)
    rating = torch.from_numpy(
        (rng.integers(1, 11, nnz) / 2).astype(np.float32)).to(cuda_card)
    s = torch.from_numpy(self_idx).to(cuda_card)
    rating = rating * (s < bucket)
    other_idx = torch.arange(nnz, device=cuda_card)
    present = (s < bucket).to(torch.float32)
    pieces = (gram_fused.plan(s, bucket, exact=False, max_row=me)
              if capped else None)
    gram_fused.reset_launches()
    _check(rows, s, other_idx, present, rating, bucket, pieces)
    assert gram_fused.launches == 2 * (
        1 if capped or nnz <= gram_fused.PIECE else 2)
    from predictionio_tpu_torch.ops import als
    pad = torch.full((nnz,), bucket, dtype=torch.int64, device=cuda_card)
    A, b = als.gram_rhs(rows, pad, other_idx, present * 0, rating * 0,
                        bucket, nnz)
    assert not A.any() and not b.any()


@pytest.mark.card
def test_two_trains_from_one_seed_are_bit_identical(cuda_card):
    """Ten iterations twice from one seed on a layout with rows of many
    pieces: the same bits; kernel G launched once a half-step, plus its
    finishing pass on a side whose plan has rows of several pieces."""
    from predictionio_tpu_torch.ops import als, gram_fused
    data = _layout(20_000, 4000, 2_000_000, 3, cuda_card, heavy=5000)
    runs = []
    for _ in range(2):
        gram_fused.reset_launches()
        U, V = als.train_explicit(data, rank=20, iterations=10, seed=4,
                                  device=cuda_card)
        torch.cuda.synchronize()
        runs.append((U.cpu(), V.cpu(), gram_fused.launches))
    (U1, V1, n1), (U2, V2, n2) = runs
    assert torch.equal(_bits(U1), _bits(U2))
    assert torch.equal(_bits(V1), _bits(V2))
    assert bool(torch.isfinite(U1).all()) and bool(torch.isfinite(V1).all())
    (_, pu, _), (_, pi, _) = als._prepared(data, 1 << 18, cuda_card)
    per_iter = (gram_fused.launches_per_gram(pu)
                + gram_fused.launches_per_gram(pi))
    assert per_iter == 4                   # both sides have long rows
    assert n1 == n2 == 10 * per_iter
