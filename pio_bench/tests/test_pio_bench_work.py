"""The work counts, the readers' arithmetic and the trace summary, at
small shapes where each can be counted by hand."""

import pytest

from pio_bench import manifest, trace
from pio_bench.drivers.train import LayerContext
from pio_bench.manifest import load_module
from pio_bench.roofline import gram, solve

from conftest import ROOT

PEAKS = {"fp32_flops_s": 67e12, "hbm_bytes_s": 3.35e12}


def _gram_ops_by_hand(n_ratings, r):
    # per rating: a multiply-add for each entry of A's upper triangle and
    # of b, two operations each
    per = 0
    for i in range(r):
        for j in range(i, r):
            per += 2
    per += 2 * r
    return n_ratings * per


@pytest.mark.parametrize("n,r", [(1, 1), (7, 3), (1000, 20), (5, 32)])
def test_gram_operations(n, r):
    assert gram.operations(n, r) == _gram_ops_by_hand(n, r)


def test_gram_bytes():
    # 10 ratings, 4 rows of this side, 6 of the other, rank 2
    assert gram.bytes_moved(10, 4, 6, 2) == 10 * 12 + 6 * 2 * 4 \
        + 4 * (4 + 2) * 4


def _gj_ops_by_hand(r):
    # unpivoted Gauss-Jordan on (A + reg I | b): r adds of the ridge;
    # per pivot k the pivot row's r - k live entries (its columns past k
    # and b) are divided, and each of the other r - 1 rows takes a
    # multiply and a subtract per live entry
    ops = r
    for k in range(r):
        live = r - k
        ops += live + (r - 1) * 2 * live
    return ops


@pytest.mark.parametrize("r", [1, 2, 5, 20, 32])
def test_solve_operations_and_bytes(r):
    assert solve.operations(3, r) == 3 * _gj_ops_by_hand(r)
    assert solve.bytes_moved(3, r) == 3 * 4 * (r * r + r + 1 + r)


def test_which_bound_binds_at_the_cells():
    # ML-20M r = 20: users narrowly by bytes, items by operations
    assert gram.bound_by(20_000_263, 138_493, 26_744, 20, PEAKS) == "bytes"
    assert gram.bound_by(20_000_263, 26_744, 138_493, 20,
                         PEAKS) == "operations"
    # Netflix r = 32: operations both ways
    assert gram.bound_by(100_480_507, 480_189, 17_770, 32,
                         PEAKS) == "operations"
    assert gram.bound_by(100_480_507, 17_770, 480_189, 32,
                         PEAKS) == "operations"
    for n in (138_493, 26_744, 480_189, 17_770):
        for r in (20, 32):
            assert solve.bound_by(n, r, PEAKS) == "bytes"
    # the smoke's bound at 138,493 x 20 (PERF.md: 0.07293 ms)
    assert solve.least_s(138_493, 20, PEAKS) * 1e3 == pytest.approx(
        0.07293, rel=1e-3)


CFG = {"n_users": 40, "n_items": 30, "n_ratings": 500, "rank": 4,
       "iterations": 2}


def _ctx(ops, window_s=1.0, calls=3, peaks=PEAKS):
    busy = trace.busy_seconds(ops)
    return LayerContext(ops, window_s, busy, calls, CFG, peaks)


def _reader(name):
    return load_module(ROOT / "pio_bench" / "layer_metrics" / f"{name}.py",
                       "reader_" + name.replace(".", "_"))


def _op(name, start_ms, end_ms, kind="kernel"):
    return trace.Op(name, kind, int(start_ms * 1e6), int(end_ms * 1e6))


OPS = [_op("gather", 0, 10), _op("outer", 5, 30),
       _op("void gj_solve<4, 1, 2>(...)", 40, 42),
       _op("Memcpy DtoH", 50, 60, "gpu_memcpy"),
       _op("void gj_solve<4, 1, 2>(...)", 100, 101), _op("add", 200, 300)]


def test_readers_arithmetic():
    ctx = _ctx(OPS)
    iters = 3 * 2
    assert _reader("launches_per_iter.train").read(ctx) == 5 / iters
    busy = (30 + 2 + 10 + 1 + 100) / 1e3
    assert ctx.busy_s == pytest.approx(busy)
    assert _reader("device_idle_share.train").read(ctx) == pytest.approx(
        100 * (1 - busy))
    gram_least = iters * (gram.least_s(500, 40, 30, 4, PEAKS)
                          + gram.least_s(500, 30, 40, 4, PEAKS))
    assert _reader("gram_roofline").read(ctx) == pytest.approx(
        100 * gram_least / ((10 + 25 + 100) / 1e3))
    solve_least = iters * (solve.least_s(40, 4, PEAKS)
                           + solve.least_s(30, 4, PEAKS))
    assert _reader("solve_roofline").read(ctx) == pytest.approx(
        100 * solve_least / 3e-3)
    ops = iters * (2 * gram.operations(500, 4) + solve.operations(40, 4)
                   + solve.operations(30, 4))
    assert _reader("train_mfu").read(ctx) == pytest.approx(
        100 * ops / (1.0 * 67e12))


@pytest.mark.parametrize("name", ["launches_per_iter.train", "gram_roofline",
                                  "solve_roofline", "device_idle_share.train",
                                  "train_mfu"])
def test_readers_return_nothing_without_anything_to_read(name):
    assert _reader(name).read(_ctx([])) is None


@pytest.mark.parametrize("name", ["gram_roofline", "solve_roofline",
                                  "train_mfu"])
def test_shares_need_the_cards_peaks(name):
    assert _reader(name).read(_ctx(OPS, peaks=None)) is None


def test_busy_union_and_idle_gaps():
    ops = [_op("a", 1, 3), _op("b", 2, 4), _op("c", 6, 7), _op("d", 9, 10)]
    assert trace.busy_intervals(ops) == [(1_000_000, 4_000_000),
                                         (6_000_000, 7_000_000),
                                         (9_000_000, 10_000_000)]
    assert trace.busy_seconds(ops, 0, 9_500_000) == pytest.approx(4.5e-3)
    # calls: [0, 7.5] ms and [8, 11] ms; window [0, 11) ms
    gaps = trace.idle_gap_totals(ops, 0, 11_000_000,
                                 [(0, 7_500_000), (8_000_000, 11_000_000)])
    assert gaps == pytest.approx({
        "inside a call, before a": 1e-3,
        "inside a call, before c": 2e-3,
        "between calls (host copy, loop, next call's start)": 2e-3,
        "inside a call, before the window's end": 1e-3})


def test_top_and_short_names():
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0],
                                                          ["c", 2.0]]
    assert len(trace.short("x" * 500)) == trace.NAME_CHARS


def test_a_metric_with_nothing_to_read_fails_the_run():
    """A per-layer metric that the cell reports and whose reader finds
    nothing raises, so no shorter result line is printed."""
    from pio_bench.drivers import train

    cell = manifest.load_cell(ROOT, "ml20m-als-r20.train")
    ctx = LayerContext(OPS, 1.0, trace.busy_seconds(OPS), 3, CFG, None)
    with pytest.raises(RuntimeError, match="gram_roofline"):
        train.layer_metrics(cell, ctx)
    got = train.layer_metrics(cell, _ctx(OPS))
    assert list(got) == list(cell.per_layer)


def test_a_card_without_peaks_fails(monkeypatch):
    import torch

    from pio_bench.drivers import train

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert train.peaks_for(torch.device("cuda", 0))["fp32_flops_s"] == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    with pytest.raises(RuntimeError, match="no entry"):
        train.peaks_for(torch.device("cuda", 0))
    assert train.peaks_for(torch.device("cpu")) is None
