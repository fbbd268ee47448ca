"""Row-sharded serving of the port (``predictionio_tpu_torch/parallel/
serve_dist.py``) against the JAX package's ``parallel/serve_dist.py``,
the port's replicated B1 + B2 path and dense numpy goldens, on shard
slots that share this process's CPU.

The class is exact throughout: the layout (rows per shard, padding,
global ids, summaries), ``merge_candidates``, ``partition_rows`` and
``parse_partition`` equal the reference's; the sharded quantized answers
(values as bits, indices, ties) equal the replicated quantized path and
the numpy golden at 1, 2, 3, 4 and 8 slots. The fp32 sharded path is
held on dyadic-grid factors, whose products every order rounds alike.
The reference's own sharded serve is not the yardstick (its tie tests are
red on these trees): the replicated path is."""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import quant as jquant
from predictionio_tpu.parallel import serve_dist as jsd
from predictionio_tpu.parallel.mesh import get_mesh as jget_mesh
from predictionio_tpu_torch.ops import quant, topk, topk_fused
from predictionio_tpu_torch.parallel import serve_dist
from predictionio_tpu_torch.parallel.mesh import Mesh

SLOTS = [1, 2, 3, 4, 8]
TILE = 16


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PIO_SERVE_QUANT", "PIO_SERVE_FUSED", "PIO_SERVE_SHARD",
                "PIO_TORCH_DEVICE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PIO_SERVE_FUSED_TILE", str(TILE))
    yield
    serve_dist.record_state(None)


def _factors(n_users=45, n_items=101, rank=6, seed=0, ties=True):
    """101 items: no slot count here divides it. Clones across shard
    boundaries make exact score ties whose lowest index must win."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, rank)).astype(np.float32)
    V = rng.normal(size=(n_items, rank)).astype(np.float32)
    if ties:
        for a, b in ((3, 50), (3, 99), (25, 26), (12, 51), (12, 76),
                     (0, n_items - 1)):
            V[b] = V[a]
    return U, V


def _golden(qf, ixs, k, n_items):
    s32 = qf.u_q[ixs].astype(np.int64) @ qf.v_q.astype(np.int64).T
    s = s32.astype(np.int32).astype(np.float32) * (
        qf.u_scale[ixs][:, None] * qf.v_scale[None, :])
    order = np.lexsort((np.broadcast_to(np.arange(n_items), s.shape), -s),
                       axis=1)[:, :k]
    return np.take_along_axis(s, order, 1), order


@pytest.mark.parametrize("n_dev", SLOTS)
@pytest.mark.parametrize("k", [1, 10, 33, 101])
def test_sharded_quant_answers_equal_replicated_and_golden(n_dev, k):
    U, V = _factors()
    qf = quant.QuantizedFactors.from_factors(U, V)
    rep = quant.QuantizedServing.build(qf, device="cpu")
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * n_dev),
                                  quant=qf)
    ixs = np.array([0, 44, 7, 7, 20, 3, 31, 12], dtype=np.int32)
    vals, idx = sf.topk(ixs, k)
    rv, ri = rep.topk(ixs, k)
    gv, gi = _golden(qf, ixs, k, V.shape[0])
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.numpy().tobytes() == rv.numpy().tobytes() == gv.tobytes()
    np.testing.assert_array_equal(idx.numpy(), ri.numpy())
    np.testing.assert_array_equal(idx.numpy(), gi)


@pytest.mark.parametrize("n_dev", SLOTS)
def test_ties_across_shard_boundaries_break_by_lowest_index(n_dev):
    # every item the same: the answer is 0..k-1 whatever the slots
    U, V = _factors(ties=False)
    V[:] = V[0]
    qf = quant.QuantizedFactors.from_factors(U, V)
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * n_dev),
                                  quant=qf)
    vals, idx = sf.topk(np.arange(5), 40)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.tile(np.arange(40), (5, 1)))
    assert (vals.numpy() == vals.numpy()[:, :1]).all()


@pytest.mark.parametrize("n_dev", SLOTS)
def test_fp32_sharded_answers_equal_replicated_on_a_dyadic_grid(n_dev):
    rng = np.random.default_rng(3)
    U = rng.integers(-8, 9, size=(30, 4)).astype(np.float32) / 8
    V = rng.integers(-8, 9, size=(53, 4)).astype(np.float32) / 8
    sf = serve_dist.shard_factors(U, V, mesh=Mesh(["cpu"] * n_dev))
    assert sf.dtype == "float32"
    ixs = np.arange(0, 30, 3)
    for k in (1, 7, 53):
        vals, idx = sf.topk(ixs, k)
        rv, ri = topk.topk_for_users(torch.from_numpy(U),
                                     torch.from_numpy(V),
                                     torch.from_numpy(ixs), k=k)
        assert vals.numpy().tobytes() == rv.numpy().tobytes()
        np.testing.assert_array_equal(idx.numpy(), ri.numpy())


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_layout_equals_the_reference(n_dev, dtype):
    U, V = _factors(n_users=21, n_items=29, ties=False)
    jqf = jquant.QuantizedFactors.from_factors(U, V)
    qf = quant.QuantizedFactors.from_factors(U, V)
    q_arg = (jqf, qf) if dtype == "int8" else (None, None)
    ref = jsd.shard_factors(U, V, mesh=jget_mesh(n_dev), quant=q_arg[0])
    got = serve_dist.shard_factors(U, V, mesh=Mesh(["cpu"] * n_dev),
                                   quant=q_arg[1])
    assert got.dtype == ref.dtype
    for f in ("n_users", "n_items", "rank", "rows_dev_u", "rows_dev_i",
              "n_shards", "user_capacity", "item_capacity"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.per_shard_bytes() == ref.per_shard_bytes()
    assert got.summary() == ref.summary()
    if dtype == "int8":
        assert got.quant_summary() == ref.quant_summary()
    # the users: one padded block, global id = address
    np.testing.assert_array_equal(got.user_rows.numpy(),
                                  np.asarray(ref.user_shards))
    for d in range(n_dev):
        np.testing.assert_array_equal(
            got.user_shard(d).numpy(),
            np.asarray(ref.user_shards)[d * ref.rows_dev_u:
                                        (d + 1) * ref.rows_dev_u])
    # the items: slot d holds global rows [d * rows_dev_i, ...), the int8
    # block transposed and padded to the tile with 0 scales
    ref_items = np.asarray(ref.item_shards)
    for d in range(n_dev):
        want = ref_items[d * ref.rows_dev_i:(d + 1) * ref.rows_dev_i]
        blk = got.item_shards[d].numpy()
        assert got.items_real(d) == max(0, min(ref.rows_dev_i,
                                               29 - d * ref.rows_dev_i))
        if dtype == "int8":
            assert blk.shape == (6, -(-ref.rows_dev_i // TILE) * TILE)
            np.testing.assert_array_equal(blk[:, :ref.rows_dev_i], want.T)
            assert not blk[:, ref.rows_dev_i:].any()
            sv = got.item_scales[d].numpy()
            np.testing.assert_array_equal(
                sv[:ref.rows_dev_i],
                np.asarray(ref.item_scales)[d * ref.rows_dev_i:
                                            (d + 1) * ref.rows_dev_i])
            assert not sv[ref.rows_dev_i:].any()
        else:
            np.testing.assert_array_equal(blk, want)


def test_b1_runs_once_per_slot_and_b2_once_per_call(monkeypatch):
    calls = {"b1": 0, "b2": 0}
    b1, b2 = (topk_fused.score_mask_topk_candidates,
              topk_fused.merge_candidates)

    def c1(*a, **kw):
        calls["b1"] += 1
        return b1(*a, **kw)

    def c2(*a, **kw):
        calls["b2"] += 1
        return b2(*a, **kw)

    monkeypatch.setattr(topk_fused, "score_mask_topk_candidates", c1)
    monkeypatch.setattr(topk_fused, "merge_candidates", c2)
    U, V = _factors()
    qf = quant.QuantizedFactors.from_factors(U, V)
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * 4),
                                  quant=qf)
    for b in (1, 4, 16):
        sf.topk(np.zeros(b, dtype=np.int32), 10)
    assert calls == {"b1": 12, "b2": 3}


def test_merge_candidates_equals_the_reference():
    rng = np.random.default_rng(9)
    for trial in range(20):
        n = int(rng.integers(1, 40))
        v = rng.integers(-3, 4, n).astype(np.float32) / 2   # many ties
        g = rng.permutation(1000)[:n].astype(np.int32)
        for k in (0, 1, 5, n, n + 3):
            want = jsd.merge_candidates(v, g, k)
            got = serve_dist.merge_candidates(v, g, k)
            for w, h in zip(want, got):
                np.testing.assert_array_equal(h, w)


def test_partition_rows_and_parse_partition_equal_the_reference():
    for n in (0, 1, 7, 100, 26744):
        for count in (1, 2, 3, 8):
            tiles = [serve_dist.partition_rows(n, i, count)
                     for i in range(count)]
            assert tiles == [jsd.partition_rows(n, i, count)
                             for i in range(count)]
            assert tiles[0][0] == 0 and tiles[-1][1] == n
    for spec in ("0/1", "2/4", " 1/3 "):
        assert serve_dist.parse_partition(spec) == jsd.parse_partition(spec)
    for bad in ("4/4", "-1/2", "1/0", "x", "1/2/3", ""):
        with pytest.raises(ValueError) as want:
            jsd.parse_partition(bad)
        with pytest.raises(ValueError) as got:
            serve_dist.parse_partition(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_dev", [1, 3])
def test_published_rows_match_the_replicated_publish(n_dev):
    U, V = _factors()
    qf = quant.QuantizedFactors.from_factors(U, V)
    rep = quant.QuantizedServing.build(qf, device="cpu")
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * n_dev),
                                  quant=qf)
    rng = np.random.default_rng(4)
    ixs = np.array([1, 30, 44])
    rows = rng.normal(size=(3, 6)).astype(np.float32)
    iix = np.array([0, 60, 100])
    irows = rng.normal(size=(3, 6)).astype(np.float32)
    rep = rep.apply_user_rows(ixs, rows).apply_item_rows(iix, irows)
    new = sf.apply_user_rows(ixs, rows).apply_item_rows(iix, irows)
    assert new is not sf and sf.user_rows is not new.user_rows
    q, s = quant.quantize_rows(rows)
    for j, ix in enumerate(ixs):
        np.testing.assert_array_equal(new.user_row(ix),
                                      q[j].astype(np.float32) * s[j])
    qi, si = quant.quantize_rows(irows)
    for j, ix in enumerate(iix):
        np.testing.assert_array_equal(new.item_row(ix),
                                      qi[j].astype(np.float32) * si[j])
    probe = np.arange(45)
    for k in (5, 101):
        a, b = new.topk(probe, k), rep.topk(probe, k)
        assert a[0].numpy().tobytes() == b[0].numpy().tobytes()
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    # the old layout still answers as before (the swap is the caller's)
    a = sf.topk(probe, 5)
    b = quant.QuantizedServing.build(qf, device="cpu").topk(probe, 5)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_fp32_publish_scatters_exact_rows():
    U, V = _factors(ties=False)
    sf = serve_dist.shard_factors(U, V, mesh=Mesh(["cpu"] * 2))
    rows = np.full((2, 6), 0.25, np.float32)
    new = sf.apply_user_rows([2, 40], rows).apply_item_rows([70], rows[:1])
    np.testing.assert_array_equal(new.user_row(40), rows[1])
    np.testing.assert_array_equal(new.item_row(70), rows[0])
    np.testing.assert_array_equal(new.user_row(3), U[3])


def test_modes_resolve_as_the_reference(monkeypatch):
    for env in ("", "on", "1", "off", "0", "auto", "AUTO", "On"):
        if env:
            monkeypatch.setenv("PIO_SERVE_SHARD", env)
        else:
            monkeypatch.delenv("PIO_SERVE_SHARD", raising=False)
        for mode in (None, "on", "off", "auto"):
            assert serve_dist.configured_mode(mode) == \
                jsd.configured_mode(mode)
    monkeypatch.delenv("PIO_SERVE_SHARD")
    with serve_dist.deploy_scope("on", device="cpu"):
        assert serve_dist.serving_enabled()
    with serve_dist.deploy_scope("off", device="cpu"):
        assert not serve_dist.serving_enabled()
    # auto: one device (the CPU here) serves replicated, and a reload
    # stays replicated even on a multi-card world
    with serve_dist.deploy_scope("auto", device="cpu"):
        assert not serve_dist.serving_enabled()
    monkeypatch.setattr(serve_dist, "_multi_device_platform", lambda: True)
    with serve_dist.deploy_scope("auto", device="cpu"):
        assert serve_dist.serving_enabled()
    with serve_dist.deploy_scope("auto", reload=True, device="cpu"):
        assert not serve_dist.serving_enabled()
    with serve_dist.deploy_scope("on", reload=True, device="cpu"):
        assert serve_dist.serving_enabled()
    with pytest.raises(ValueError, match="auto/on/off"):
        with serve_dist.deploy_scope("sometimes"):
            pass


def test_record_state_sets_the_gauge_and_the_device_block(monkeypatch):
    from predictionio_tpu_torch.common import devicewatch, telemetry

    monkeypatch.setenv("PIO_TELEMETRY", "1")
    U, V = _factors()
    sf = serve_dist.shard_factors(U, V, mesh=Mesh(["cpu"] * 3))
    gauge = telemetry.registry().gauge("pio_serve_shards", "")
    assert gauge.labels().value == 3.0
    assert devicewatch.debug_snapshot()["sharding"] == sf.summary()
    serve_dist.record_state(None)
    assert gauge.labels().value == 0.0
    assert devicewatch.debug_snapshot()["sharding"] is None


def test_out_of_bounds_user_is_refused():
    U, V = _factors()
    qf = quant.QuantizedFactors.from_factors(U, V)
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * 2),
                                  quant=qf)
    with pytest.raises(IndexError):
        sf.topk([sf.user_capacity], 3)


def test_warm_up_programs_cover_every_bucket():
    U, V = _factors()
    qf = quant.QuantizedFactors.from_factors(U, V)
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * 2),
                                  quant=qf)
    progs = serve_dist.sharded_program_specs(sf, (4, 16), [10])
    assert [p.name for p in progs] == ["topk_for_users_sharded_quant"] * 3
    shapes = [tuple(p.run()[1].shape) for p in progs]
    assert shapes == [(1, 10), (4, 10), (16, 10)]


@pytest.mark.parametrize("n_items,k", [(9, 9), (9, 4), (3, 3)])
def test_slots_with_no_real_rows_answer_like_replicated(n_items, k):
    # 8 slots of 2 (or 1) rows: the last slots hold padding only, users
    # and items alike
    U, V = _factors(n_users=5, n_items=n_items, ties=False)
    qf = quant.QuantizedFactors.from_factors(U, V)
    rep = quant.QuantizedServing.build(qf, device="cpu")
    sf = serve_dist.shard_factors(None, None, mesh=Mesh(["cpu"] * 8),
                                  quant=qf)
    assert [sf.items_real(d) for d in range(8)].count(0) >= 3
    ixs = np.arange(5)
    vals, idx = sf.topk(ixs, k)
    rv, ri = rep.topk(ixs, k)
    assert vals.numpy().tobytes() == rv.numpy().tobytes()
    np.testing.assert_array_equal(idx.numpy(), ri.numpy())
    assert idx.numpy().max() < n_items
