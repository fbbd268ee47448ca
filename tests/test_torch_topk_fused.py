"""The plain version of the port's fused int8 score->top-k kernel
(ops/topk_fused.py) against the JAX package's Pallas kernel, run in
interpret mode on the CPU, and against the JAX plain int8 path
(quant.topk_for_users_quant). The class is exact: values (as bits) and
indices must be identical. The CUDA kernel itself is held against this
plain version on the card by chip_smoke.py."""

import functools

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


@functools.lru_cache(maxsize=None)
def _merge_inputs(tile, b, k_local):
    """The JAX kernel's own candidates, in interpret mode: the same
    pallas_call as ``topk_pallas.topk_for_users_quant_fused`` makes before
    its merge, cached per (tile, b, k_local) since each k above a tile
    shares them."""
    from jax.experimental import pallas as pl

    qf, vt, sv = _inputs(tile)
    ixs = np.random.default_rng(100 + b).integers(
        0, N_USERS, size=b).astype(np.int32)
    r, n_pad = vt.shape
    n_tiles = n_pad // tile
    call = pl.pallas_call(
        functools.partial(topk_pallas._score_mask_topk_kernel, k=k_local,
                          n_items=N_ITEMS, tile=tile),
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((b, r), lambda i: (0, 0)),
                  pl.BlockSpec((b, 1), lambda i: (0, 0)),
                  pl.BlockSpec((r, tile), lambda i: (0, i)),
                  pl.BlockSpec((1, tile), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((b, k_local), lambda i: (0, i)),
                   pl.BlockSpec((b, k_local), lambda i: (0, i))],
        out_shape=[
            jax.ShapeDtypeStruct((b, n_tiles * k_local), np.float32),
            jax.ShapeDtypeStruct((b, n_tiles * k_local), np.int32)],
        interpret=True)
    cv, ci = jax.device_get(jax.jit(call)(
        qf.u_q[ixs], qf.u_scale[ixs][:, None], vt, sv[None, :]))
    return qf, vt, sv, ixs, cv, ci


# (tile, b, k): k of 1, 10, above the tile (k_local = tile) and the whole
# catalog, at both tiles; the clones of item 3 tie across tiles in every
# case; k = 760 > N_ITEMS at tile 128 reaches the last tile's repeats of
# its lowest masked index (past the catalog)
MERGE_CASES = [(tile, b, k) for tile in (128, 512) for b in (1, 5)
               for k in (1, 10, tile + 88, N_ITEMS)] \
    + [(128, 1, 760), (128, 5, 760)]


@pytest.mark.parametrize("tile,b,k", MERGE_CASES)
def test_plain_merge_of_pallas_candidates_matches_jax_merge(tile, b, k):
    """merge_candidates_plain (the CPU side of kernel B2) fed the JAX
    kernel's candidates equals the JAX fused path's two-key lax.sort
    merge bit for bit, and so does the port's merge entry point on a CPU
    tensor."""
    k_local = min(k, tile)
    qf, vt, sv, ixs, cv, ci = _merge_inputs(tile, b, k_local)
    jv, ji = jax.device_get(topk_pallas.topk_for_users_quant_fused(
        qf.u_q, qf.u_scale, vt, sv, ixs, k=k, n_items=N_ITEMS, tile=tile,
        interpret=True))
    mv, mi = topk_fused.merge_candidates_plain(
        torch.tensor(cv), torch.tensor(ci), k)
    np.testing.assert_array_equal(mv.numpy().view(np.int32),
                                  jv.view(np.int32))
    np.testing.assert_array_equal(mi.numpy(), ji)
    ev, ei = topk_fused.merge_candidates(
        torch.tensor(cv), torch.tensor(ci), k, k_local=k_local)
    np.testing.assert_array_equal(ev.numpy().view(np.int32),
                                  jv.view(np.int32))
    np.testing.assert_array_equal(ei.numpy(), ji)
    if k > N_ITEMS:
        # past the catalog: the last tile's lowest masked index, repeated
        n_pad = vt.shape[1]
        assert np.all(jv[:, N_ITEMS:] == np.float32(-3.4e38))
        assert np.all(ji[:, N_ITEMS:] == n_pad - tile)


@pytest.mark.parametrize("tile,k", [(1, 10), (2, 600)])
def test_catalog_of_more_than_1024_tiles_matches_jax_plain_path(tile, k):
    """A catalog of 2,100 tiles or 1,050 (three copies of the items, so
    every item ties with two copies in far tiles): the port's fused path
    takes no tile limit and equals the JAX plain int8 path bit for bit."""
    qf, vt, sv = _inputs(128)
    n_items = 3 * N_ITEMS
    vt3 = np.tile(vt[:, :N_ITEMS], (1, 3))
    sv3 = np.tile(sv[:N_ITEMS], 3)
    ixs = np.array([0, 17, 39], np.int32)
    tv, ti = topk_fused.topk_for_users_quant_fused(
        torch.from_numpy(qf.u_q), torch.from_numpy(qf.u_scale),
        torch.from_numpy(vt3), torch.from_numpy(sv3), torch.from_numpy(ixs),
        k=k, n_items=n_items, tile=tile)
    xv, xi = jax.device_get(jquant.topk_for_users_quant(
        qf.u_q, qf.u_scale, vt3, sv3, ixs, k=k, n_items=n_items))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  xv.view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), xi)


def test_merge_on_cpu_runs_the_plain_merge_and_counts_no_launch():
    qf, vt, sv = _inputs(128)
    ixs = torch.tensor([1, 7, 7, 30], dtype=torch.int32)
    cv, ci = topk_fused.score_mask_topk_candidates(
        torch.from_numpy(qf.u_q), torch.from_numpy(qf.u_scale),
        torch.from_numpy(vt), torch.from_numpy(sv), ixs, k_local=10,
        n_items=N_ITEMS, tile=128)
    topk_fused.reset_launches()
    mv, mi = topk_fused.merge_candidates(cv, ci, 10, k_local=10)
    pv, pi = topk_fused.merge_candidates_plain(cv, ci, 10)
    assert topk_fused.launches == 0 and topk_fused.merge_launches == 0
    assert mv.shape == (4, 10) and mi.dtype == torch.int32
    assert torch.equal(mv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(mi, pi)
    with pytest.raises(ValueError, match="unsupported device"):
        topk_fused.merge_candidates(cv.to("meta"), ci.to("meta"), 10,
                                    k_local=10)


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
