"""The plain version of the port's fused int8 score->top-k kernel
(ops/topk_fused.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU, and against the JAX plain int8 path
(quant.topk_for_users_quant). The class is exact: values (as bits) and
indices must be identical. The CUDA kernel itself is held against this
plain version on the card by chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import quant as jquant
from predictionio_tpu.ops import topk_pallas
from predictionio_tpu_torch.ops import topk_fused

N_USERS, N_ITEMS, RANK = 40, 700, 10      # 700 is no multiple of a tile


def _inputs(tile):
    rng = np.random.default_rng(11)
    U = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    # cloned items quantize identically: ties across tiles (and within
    # one) that only the lowest-index rule orders
    for clone in (130, 300, 650, 699):
        V[clone] = V[3]
    qf = jquant.QuantizedFactors.from_factors(U, V)
    n_pad = -(-N_ITEMS // tile) * tile
    vt = np.zeros((RANK, n_pad), np.int8)
    vt[:, :N_ITEMS] = qf.v_q.T
    sv = np.zeros(n_pad, np.float32)
    sv[:N_ITEMS] = qf.v_scale
    return qf, vt, sv


def _port(qf, vt, sv, ixs, k, tile):
    v, i = topk_fused.topk_for_users_quant_fused(
        torch.from_numpy(qf.u_q), torch.from_numpy(qf.u_scale),
        torch.from_numpy(vt), torch.from_numpy(sv), torch.from_numpy(ixs),
        k=k, n_items=N_ITEMS, tile=tile)
    return v.numpy(), i.numpy()


# (tile, b, k): k below a tile, equal to it and above it (at tile 128,
# where the interpreter's unrolled selection rounds stay cheap); b in
# 1/4/16 at both tiles
CASES = [(128, 4, 10), (128, 1, 128), (128, 16, 200),
         (512, 16, 10), (512, 4, 37), (512, 1, 1)]


@pytest.mark.parametrize("tile,b,k", CASES)
def test_plain_version_matches_pallas_interpret_bit_for_bit(tile, b, k):
    qf, vt, sv = _inputs(tile)
    ixs = np.random.default_rng(b * k).integers(
        0, N_USERS, size=b).astype(np.int32)
    pv, pi = jax.device_get(topk_pallas.topk_for_users_quant_fused(
        qf.u_q, qf.u_scale, vt, sv, ixs, k=k, n_items=N_ITEMS, tile=tile,
        interpret=True))
    xv, xi = jax.device_get(jquant.topk_for_users_quant(
        qf.u_q, qf.u_scale, vt, sv, ixs, k=k, n_items=N_ITEMS))
    tv, ti = _port(qf, vt, sv, ixs, k, tile)
    np.testing.assert_array_equal(tv.view(np.int32), pv.view(np.int32))
    np.testing.assert_array_equal(ti, pi)
    np.testing.assert_array_equal(tv.view(np.int32), xv.view(np.int32))
    np.testing.assert_array_equal(ti, xi)


@pytest.mark.parametrize("tile", [128, 512])
def test_cross_tile_clones_rank_lowest_index_first(tile):
    """The whole catalog ranked: the clones of item 3 sit in different
    tiles and must come out in index order, exactly as the JAX plain
    int8 path orders them."""
    qf, vt, sv = _inputs(tile)
    ixs = np.arange(16, dtype=np.int32)
    tv, ti = _port(qf, vt, sv, ixs, N_ITEMS, tile)
    xv, xi = jax.device_get(jquant.topk_for_users_quant(
        qf.u_q, qf.u_scale, vt, sv, ixs, k=N_ITEMS, n_items=N_ITEMS))
    np.testing.assert_array_equal(tv.view(np.int32), xv.view(np.int32))
    np.testing.assert_array_equal(ti, xi)
    for row in ti:
        pos = [int(np.flatnonzero(row == c)[0])
               for c in (3, 130, 300, 650, 699)]
        assert pos == sorted(pos)
        assert pos[-1] - pos[0] == 4      # adjacent: equal scores


def test_candidates_match_pallas_candidates_past_the_catalog():
    """k_local above the real columns of the last tile: the kernel's
    rounds then repeat the tile's lowest masked index. The plain version
    reproduces those candidates too (what a merge for k > n_items sees)."""
    tile, k = 128, 760
    qf, vt, sv = _inputs(tile)
    ixs = np.array([5, 9], np.int32)
    pv, pi = jax.device_get(topk_pallas.topk_for_users_quant_fused(
        qf.u_q, qf.u_scale, vt, sv, ixs, k=k, n_items=N_ITEMS, tile=tile,
        interpret=True))
    tv, ti = _port(qf, vt, sv, ixs, k, tile)
    np.testing.assert_array_equal(tv.view(np.int32), pv.view(np.int32))
    np.testing.assert_array_equal(ti, pi)


def test_plain_path_on_cpu_counts_no_launch():
    qf, vt, sv = _inputs(128)
    topk_fused.reset_launches()
    _port(qf, vt, sv, np.array([1, 2], np.int32), 10, 128)
    assert topk_fused.launches == 0


def test_mode_and_tile_resolution(monkeypatch):
    monkeypatch.delenv("PIO_SERVE_FUSED", raising=False)
    monkeypatch.delenv("PIO_SERVE_FUSED_TILE", raising=False)
    assert topk_fused.fused_mode() == "auto" and topk_fused.fused_choice()
    assert topk_fused.serve_tile() == topk_pallas.serve_tile() == 512
    for raw, mode in (("1", "on"), ("on", "on"), ("0", "off"),
                      ("off", "off"), ("bogus", "auto")):
        monkeypatch.setenv("PIO_SERVE_FUSED", raw)
        assert topk_fused.fused_mode() == topk_pallas.fused_mode() == mode
        assert topk_fused.fused_choice() == (mode != "off")
    for raw in ("128", "0", "x"):
        monkeypatch.setenv("PIO_SERVE_FUSED_TILE", raw)
        assert topk_fused.serve_tile() == topk_pallas.serve_tile()
