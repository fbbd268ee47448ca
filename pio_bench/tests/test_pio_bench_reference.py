"""The plain reference against a row-by-row solve, and the port against
the reference at a tiny size on the CPU (kernel A's plain version)."""

import numpy as np
import pytest
import torch

from pio_bench import compare, data
from pio_bench.reference import als_wr

from conftest import TINY

CFG = {"n_users": 60, "n_items": 45, "n_ratings": 900, "rank": 5,
       "iterations": 3, "lambda": 0.05,
       "user_ratings": {"min": 3, "max": 40}, "item_ratings": {"max": 40},
       "rating_scale": {"min": 0.5, "max": 5.0, "step": 0.5, "mean": 3.5,
                        "std": 1.1}}


def _inputs(cfg=CFG, seed=5):
    return data.inputs(cfg, seed, torch.device("cpu"))


def _row_by_row(other, self_idx, other_idx, rating, n_self, lam):
    """Each row's normal equations built and solved on its own, numpy
    float64."""
    other = other.numpy().astype(np.float64)
    r = other.shape[1]
    out = np.zeros((n_self, r))
    for u in range(n_self):
        sel = self_idx.numpy() == u
        vs = other[other_idx.numpy()[sel]]
        A = vs.T @ vs + lam * max(int(sel.sum()), 1) * np.eye(r)
        b = vs.T @ rating.numpy()[sel].astype(np.float64)
        out[u] = np.linalg.solve(A, b)
    return out


def test_half_step_equals_a_row_by_row_solve():
    (u, i, r), (u0, v0) = _inputs()
    by_user, _ = als_wr.layouts(u, i, r, CFG["n_users"], CFG["n_items"])
    got = als_wr.half_step(v0, by_user, CFG["lambda"], "fp64").numpy()
    want = _row_by_row(v0, u, i, r, CFG["n_users"], CFG["lambda"])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_small_blocks_give_the_same_half_step(monkeypatch):
    (u, i, r), (u0, v0) = _inputs()
    by_user, _ = als_wr.layouts(u, i, r, CFG["n_users"], CFG["n_items"])
    whole = als_wr.half_step(v0, by_user, CFG["lambda"], "fp64")
    monkeypatch.setattr(als_wr, "BLOCK_BYTES", 7 * CFG["n_items"] * 8)
    blocks = als_wr.half_step(v0, by_user, CFG["lambda"], "fp64")
    assert torch.equal(whole, blocks)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12, 0.0])
    y = als_wr.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0, 0.0]


def test_the_ratings_follow_the_configuration():
    (u, i, r), (u0, v0) = _inputs()
    assert u.dtype == i.dtype == torch.int32 and r.dtype == torch.float32
    assert u.shape == i.shape == r.shape == (CFG["n_ratings"],)
    assert int(u.min()) >= 0 and int(u.max()) < CFG["n_users"]
    assert int(i.min()) >= 0 and int(i.max()) < CFG["n_items"]
    assert set(torch.unique(r * 2).tolist()) <= set(range(1, 11))
    # every user's count is the profile's, in some order; no pair twice
    per_user = torch.bincount(u.long(), minlength=CFG["n_users"])
    profile = data.user_counts(CFG["n_users"], CFG["n_ratings"], 3, 40)
    assert torch.equal(torch.sort(per_user, descending=True).values,
                       profile)
    pairs = u.long() * CFG["n_items"] + i.long()
    assert torch.unique(pairs).numel() == pairs.numel()
    assert u0.shape == (CFG["n_users"], 5) and bool((u0 >= 0).all())
    (u2, i2, r2), (a, b) = _inputs(seed=5)
    assert torch.equal(u, u2) and torch.equal(i, i2) and torch.equal(r, r2)
    assert torch.equal(u0, a)
    (u3, i3, _), _ = _inputs(seed=6)
    assert not torch.equal(u, u3)
    # another seed deals the same counts to other users
    assert torch.equal(torch.sort(torch.bincount(
        u3.long(), minlength=CFG["n_users"]), descending=True).values,
        profile)


@pytest.mark.parametrize("n_users,n_ratings,least,most", [
    (138_493, 20_000_263, 20, 9_254),       # ML-20M
    (480_189, 100_480_507, 1, 17_653),      # Netflix
    (300, 6000, 5, 150)])
def test_user_counts_keep_the_published_marginals(n_users, n_ratings, least,
                                                  most):
    c = data.user_counts(n_users, n_ratings, least, most)
    assert c.shape == (n_users,) and c.dtype == torch.int64
    assert int(c.sum()) == n_ratings
    assert int(c[0]) == most and int(c.min()) >= least
    assert bool((c[:-1] >= c[1:]).all())
    # heavy-tailed: the median user rates well under the mean
    assert float(c.double().median()) < n_ratings / n_users


def test_user_counts_refuse_a_total_out_of_range():
    with pytest.raises(ValueError):
        data.user_counts(10, 1000, 1, 50)
    with pytest.raises(ValueError):
        data.user_counts(10, 5, 1, 50)


def test_the_most_rated_item_has_about_the_published_count():
    """The fitted skew gives the most popular item the published count,
    as drawn: within a few percent at a tenth of ML-20M's users."""
    cfg = {"n_users": 2000, "n_items": 1000, "n_ratings": 150_000,
           "user_ratings": {"min": 20, "max": 900},
           "item_ratings": {"max": 1200},
           "rating_scale": CFG["rating_scale"], "rank": 2}
    for seed in (1, 2):
        (u, i, _), _ = data.inputs(cfg, seed, torch.device("cpu"))
        top = int(torch.bincount(i.long(), minlength=1000).max())
        assert abs(top - 1200) < 0.05 * 1200, (seed, top)


def test_large_seeds_are_taken():
    g = data.generator(2 ** 31 + 17, torch.device("cpu"))
    g2 = data.generator(2 ** 64 + 2 ** 31 + 17, torch.device("cpu"))
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=g2))


def _port(cfg, seed, iterations):
    from predictionio_tpu_torch.ops import als
    coo, (u0, v0) = data.inputs(cfg, seed, torch.device("cpu"))
    layout = als.prepare_ratings(*coo, cfg["n_users"], cfg["n_items"],
                                 on_device=True, device="cpu")
    U, V = als.train_explicit(layout, rank=cfg["rank"],
                              iterations=iterations, lambda_=cfg["lambda"],
                              reg_scaling="count", u0=u0, v0=v0,
                              device="cpu")
    return coo, u0, v0, layout, U, V


def test_the_port_agrees_with_the_reference(tiny_cell):
    """The port's CPU path (the plain Gauss-Jordan sweep in place of
    kernel A) against the fp64 reference, by the numbers a run compares,
    and within the cell's limits."""
    from pio_bench.drivers import train

    cell = tiny_cell()
    cfg = cell.config
    coo, u0, v0, layout, U, V = _port(cfg, 9, TINY["iterations"])
    sides = als_wr.layouts(*coo, cfg["n_users"], cfg["n_items"])
    numbers = train.layout_numbers(layout, sides)
    numbers.update(train.factor_numbers(cfg, coo, u0, v0, U, V, als_wr,
                                        sides))
    assert numbers["layout"] == 0
    assert numbers["half_step"] < 1e-4
    assert numbers["factors"] < 1e-3
    assert numbers["rmse"] < 1e-5
    assert compare.judged(numbers, cell.limits["limits"])[0]


def test_the_control_fails_where_the_port_passes(tiny_cell):
    """The reference in TF32, put in the program's place, fails one of
    the limits at least, at every seed tried."""
    from pio_bench.drivers import train

    cell = tiny_cell()
    cfg = cell.config
    for seed in (1, 2, 3):
        coo, (u0, v0) = data.inputs(cfg, seed, torch.device("cpu"))
        sides = als_wr.layouts(*coo, cfg["n_users"], cfg["n_items"])
        Uc, Vc = als_wr.train(u0, v0, *sides, cfg["iterations"],
                              cfg["lambda"], "tf32")
        numbers = {"layout": 0.0}
        numbers.update(train.factor_numbers(cfg, coo, u0, v0, Uc, Vc, als_wr,
                                            sides))
        assert not compare.judged(numbers, cell.limits["limits"])[0], numbers


@pytest.mark.parametrize("mutate", ["order_inside_rows", "one_rating",
                                    "one_count", "dropped_entry"])
def test_layout_mismatches(mutate):
    (u, i, r), _ = _inputs()
    by_user, _ = als_wr.layouts(u, i, r, CFG["n_users"], CFG["n_items"])
    prog = [by_user.self_idx.clone(), by_user.other_idx.clone(),
            by_user.rating.clone(), by_user.counts.clone()]
    if mutate == "order_inside_rows":
        # rows keep their entries in another order: still the same layout
        lo, hi = by_user.starts[0], by_user.starts[1]
        prog[1][lo:hi] = prog[1][lo:hi].flip(0)
        prog[2][lo:hi] = prog[2][lo:hi].flip(0)
        want = 0
    elif mutate == "one_rating":
        prog[2][3] += 0.5
        want = 1
    elif mutate == "one_count":
        prog[3][2] += 1
        want = 1
    else:
        prog[0][7] = CFG["n_users"]      # a padding row now
        want = 2 * len(u)
    ref = (by_user.self_idx, by_user.other_idx, by_user.rating,
           by_user.counts)
    got = compare.coo_mismatches(tuple(prog), ref, CFG["n_users"],
                                 CFG["n_items"])
    assert (got == want) if want == 0 else (got >= 1)


def test_row_gap_and_relative_gap():
    ref = torch.tensor([[3.0, 4.0], [0.0, 0.0], [6.0, 8.0]])
    x = ref.clone()
    assert compare.row_gap(x, ref) == 0.0
    x[1] = torch.tensor([0.0, 1.0])        # a zero row: the median (5) floors
    assert compare.row_gap(x, ref) == pytest.approx(0.2)
    x[1] = float("nan")
    assert np.isnan(compare.row_gap(x, ref))
    assert np.isnan(compare.row_gap(x[:2], ref))
    assert compare.relative_gap(1.01, 1.0) == pytest.approx(0.01)


def test_judged():
    ok, checks = compare.judged({"a": 0.0, "b": 1e-5},
                                {"a": 0, "b": 1e-4})
    assert ok and checks == {"a": {"value": 0.0, "limit": 0},
                             "b": {"value": 1e-5, "limit": 1e-4}}
    assert not compare.judged({"a": 1.0}, {"a": 0})[0]
    assert not compare.judged({"a": float("nan")}, {"a": 1.0})[0]
    with pytest.raises(KeyError):
        compare.judged({"a": 0.0}, {"a": 0, "b": 1})
