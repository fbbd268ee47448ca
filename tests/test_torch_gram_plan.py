"""Kernel G's plan of pieces (``ops/gram_fused.py::plan``) and the Gram's
dispatch (``ops/als.py::gram_rhs``), on the CPU.

The kernel itself runs only on the card (``test_torch_gram_fused_card.py``);
here the plan is checked exactly: it covers every real entry once and no
padding entry, its pieces hold at most 512 entries in row order, its
schedule starts with the longest rows, and it is the same for int32 and
int64 rows and with or without the host sync. Walking the plan as the
kernel does (each piece summed, then a row's pieces in order) gives the
plain Gram's A and b within fp32 rounding of an fp64 walk. On the CPU,
``gram_rhs`` is the plain Gram, and the trainer's span attrs are the
chunked Gram's."""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import als, gram_fused

N_USERS, N_ITEMS, CHUNK = 60, 45, 1024


def _side(seed=0):
    """By-user layout: user 0 with 1,500 ratings (three pieces), user 7
    with 513 (two), users 1-6 with none, the rest short; padded."""
    rng = np.random.default_rng(seed)
    u = np.concatenate([np.zeros(1500, np.int32), np.full(513, 7, np.int32),
                        rng.integers(8, N_USERS, 3000).astype(np.int32)])
    i = rng.integers(0, N_ITEMS, u.shape[0]).astype(np.int32)
    r = rng.uniform(0.5, 5, u.shape[0]).astype(np.float32)
    return als.prepare_ratings(u, i, r, N_USERS, N_ITEMS,
                               chunk=CHUNK).by_user


def _pieces(p):
    """(piece id, row, start, length, part) of the plan's used slots."""
    return [(k, int(p.piece_row[k]), int(p.piece_start[k]),
             int(p.piece_len[k]), int(p.piece_part[k]))
            for k in range(p.slots) if int(p.piece_row[k]) >= 0]


def _plan(side, dtype=torch.int32, exact=True):
    return gram_fused.plan(torch.as_tensor(side.self_idx).to(dtype),
                           side.n_self, exact=exact)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "on_device"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_plan_covers_every_real_entry_once_and_no_padding(dtype, exact):
    side = _side()
    p = _plan(side, dtype, exact)
    seen = np.zeros(side.self_idx.shape[0], np.int64)
    for _k, row, start, length, _part in _pieces(p):
        seen[start:start + length] += 1
        assert (side.self_idx[start:start + length] == row).all()
    nnz = int(side.counts.sum())
    assert (seen[:nnz] == 1).all() and not seen[nnz:].any()
    assert (side.self_idx[nnz:] == side.n_self).all()   # what was skipped
    # every row is written: a row with no entry is one empty piece
    rows = [row for _k, row, _s, _l, _p in _pieces(p)]
    assert sorted(set(rows)) == list(range(N_USERS))
    assert rows.count(3) == 1 and side.counts[3] == 0


def test_pieces_are_at_most_512_entries_and_in_row_order():
    side = _side()
    got = _pieces(_plan(side))
    assert all(length <= gram_fused.PIECE for _k, _r, _s, length, _p in got)
    keys = [(row, start) for _k, row, start, _l, _p in got]
    assert keys == sorted(keys)
    assert [k for k, *_ in got] == list(range(len(got)))
    per_row = {}
    for _k, row, _s, _l, part in got:
        per_row.setdefault(row, []).append(part)
    # the rows of several pieces: 0 (1,500 entries) and 7 (513); their
    # pieces take consecutive scratch slots, the others none
    assert {row: len(v) for row, v in per_row.items() if len(v) > 1} == \
        {0: 3, 7: 2}
    assert per_row[0] == [0, 1, 2] and per_row[7] == [3, 4]
    assert all(v == [-1] for row, v in per_row.items() if row not in (0, 7))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "on_device"])
def test_schedule_starts_with_the_longest_rows(exact):
    side = _side()
    p = _plan(side, exact=exact)
    sched = p.schedule.tolist()
    assert sorted(sched) == list(range(p.slots))      # a permutation
    counts = side.counts.astype(np.int64)
    lengths = [counts[int(p.piece_row[k])] if int(p.piece_row[k]) >= 0
               else -1 for k in sched]
    assert all(a >= b for a, b in zip(lengths, lengths[1:]))
    assert [int(p.piece_row[k]) for k in sched[:5]] == [0, 0, 0, 7, 7]
    # ties keep row order; a row's pieces keep their order
    assert [int(p.piece_start[k]) for k in sched[:3]] == [0, 512, 1024]


def _fields(p):
    return [getattr(p, f).tolist() for f in (
        "piece_row", "piece_start", "piece_len", "piece_part", "schedule",
        "multi_row", "multi_first", "multi_count")]


def test_plan_is_the_same_for_int32_and_int64_rows():
    side = _side()
    for exact in (True, False):
        a, b = _plan(side, torch.int32, exact), _plan(side, torch.int64,
                                                      exact)
        assert _fields(a) == _fields(b)
        assert (a.n_parts, a.pieces, a.entries, a.multi) == \
            (b.n_parts, b.pieces, b.entries, b.multi)
    a = _plan(side, torch.int32, True)
    assert (a.pieces, a.entries, a.multi, a.n_parts) == \
        (N_USERS + 2 + 1, int(side.counts.sum()), 2, 5)


@pytest.mark.parametrize("bucket", [1, 8, 64])
def test_foldin_shape_plans_the_same_without_a_host_sync(bucket):
    """A fold-in tick's shape (256 slots a row, int64 rows, padding at
    the bucket) passes no plan: the on-device plan's used slots are the
    exact plan's, its unused slots come last and are skipped."""
    rng = np.random.default_rng(bucket)
    per = rng.integers(0, 257, bucket)
    s = np.full(bucket * 256, bucket, np.int64)
    s[:per.sum()] = np.repeat(np.arange(bucket), per)
    for dtype in (torch.int64, torch.int32):
        t = torch.from_numpy(s).to(dtype)
        exact = gram_fused.plan(t, bucket)
        dev = gram_fused.plan(t, bucket, exact=False)
        assert _pieces(dev) == _pieces(exact)
        assert dev.schedule.tolist()[:exact.slots] == \
            exact.schedule.tolist()
        assert dev.slots == bucket + s.shape[0] // gram_fused.PIECE
        assert exact.pieces == bucket and exact.multi == 0
        assert (dev.multi_row == -1).all()   # no row of several pieces
        assert dev.pieces is None and dev.entries is None
        assert gram_fused.launches_per_gram(exact) == 1


@pytest.mark.parametrize("bucket", [1, 8, 64])
def test_foldin_plan_under_the_history_cap_has_no_finishing_pass(bucket):
    """With the tick's history cap (``max_row`` 256, as ``foldin_solve``
    builds it) the on-device plan is one piece a row in the exact plan's
    order, with no scratch and one launch a Gram, whatever the bucket's
    entry count."""
    rng = np.random.default_rng(bucket)
    per = rng.integers(0, 257, bucket)
    s = np.full(bucket * 256, bucket, np.int64)
    s[:per.sum()] = np.repeat(np.arange(bucket), per)
    t = torch.from_numpy(s)
    exact = gram_fused.plan(t, bucket)
    capped = gram_fused.plan(t, bucket, exact=False, max_row=256)
    assert _pieces(capped) == _pieces(exact)
    assert capped.schedule.tolist() == exact.schedule.tolist()
    assert capped.slots == bucket and capped.n_parts == 0
    assert not capped.finishes
    assert gram_fused.launches_per_gram(capped) == 1


def test_all_padding_and_empty_sides():
    """The fold-in warm-up's batch (every slot padding) is one empty piece
    a row; a side of no rows has no piece."""
    t = torch.full((512,), 8, dtype=torch.int64)
    p = gram_fused.plan(t, 8)
    assert _pieces(p) == [(k, k, 0, 0, -1) for k in range(8)]
    assert (p.entries, p.multi, p.n_parts) == (0, 0, 0)
    e = gram_fused.plan(torch.zeros((0,), dtype=torch.int32), 0)
    assert e.slots == 0 and gram_fused.launches_per_gram(e) == 0


def _walk(p, V, other_idx, ca, cb):
    """What kernel G computes, in fp64: each piece's sums, then each row
    of several pieces as the sum of its slots in piece order."""
    r = V.shape[1]
    A = np.full((p.n_self, r, r), np.nan)
    b = np.full((p.n_self, r), np.nan)
    parts = {}
    for k in p.schedule.tolist():
        row = int(p.piece_row[k])
        if row < 0:
            continue
        st, ln = int(p.piece_start[k]), int(p.piece_len[k])
        v = V[other_idx[st:st + ln]]
        got = ((v * ca[st:st + ln, None]).T @ v, cb[st:st + ln] @ v)
        if int(p.piece_part[k]) < 0:
            A[row], b[row] = got
        else:
            parts[int(p.piece_part[k])] = got
    for row, first, count in zip(p.multi_row.tolist(),
                                 p.multi_first.tolist(),
                                 p.multi_count.tolist()):
        if row >= 0 and count > 1:
            A[row] = sum(parts[first + q][0] for q in range(count))
            b[row] = sum(parts[first + q][1] for q in range(count))
    return A, b


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_walking_the_plan_gives_the_plain_gram(implicit):
    side = _side(1)
    rng = np.random.default_rng(2)
    V = rng.normal(size=(N_ITEMS, 6))
    rating = side.rating.astype(np.float64)
    if implicit:
        ca = 1.3 * np.abs(rating)
        cb = (1.0 + ca) * (rating > 0)
    else:
        ca = (side.self_idx < N_USERS).astype(np.float64)
        cb = rating
    A, b = _walk(_plan(side), V, side.other_idx, ca, cb)
    P, Pb = als.gram_rhs_plain(
        torch.as_tensor(V, dtype=torch.float32),
        torch.as_tensor(side.self_idx), torch.as_tensor(side.other_idx),
        torch.as_tensor(ca, dtype=torch.float32),
        torch.as_tensor(cb, dtype=torch.float32), N_USERS, CHUNK)
    np.testing.assert_allclose(P.numpy(), A, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Pb.numpy(), b, rtol=1e-5, atol=1e-3)
    assert not np.abs(A[3]).any() and not np.abs(b[3]).any()


def test_gram_rhs_takes_the_plain_gram_off_the_card():
    side = _side()
    V = torch.from_numpy(
        np.random.default_rng(3).normal(size=(N_ITEMS, 5)).astype(
            np.float32))
    args = (V, torch.as_tensor(side.self_idx),
            torch.as_tensor(side.other_idx).long(),
            torch.as_tensor((side.self_idx < N_USERS).astype(np.float32)),
            torch.as_tensor(side.rating), N_USERS, CHUNK)
    gram_fused.reset_launches()
    plain = als.gram_rhs_plain(*args)
    for plan in (None, als.gram_plan(args[1], CHUNK), _plan(side)):
        A, b = als.gram_rhs(*args, plan)
        assert torch.equal(A, plain[0]) and torch.equal(b, plain[1])
    assert gram_fused.launches == 0


def test_a_launch_refuses_a_plan_of_another_layout():
    """The wrapper's checks run before any kernel is loaded."""
    side = _side()
    p = _plan(side)
    V = torch.zeros((N_ITEMS, 4))
    short = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="covers"):
        gram_fused.launch(V, short, torch.zeros(10), torch.zeros(10), p)
    n = side.self_idx.shape[0]
    with pytest.raises(ValueError, match="coeff_a"):
        gram_fused.launch(V, torch.zeros(n, dtype=torch.int64),
                          torch.zeros(n, dtype=torch.float64),
                          torch.zeros(n), p)


def test_cpu_trainer_span_attrs_are_the_chunked_grams():
    """On the CPU ``_prepared`` plans chunks and its spans say so: every
    chunk, padding included; a card plan's attrs are its pieces over the
    real entries, with no padding."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, N_USERS, 3000)
    i = rng.integers(0, N_ITEMS, 3000)
    r = rng.integers(1, 6, 3000).astype(np.float32)
    data = als.prepare_ratings(u, i, r, N_USERS, N_ITEMS, chunk=CHUNK)
    nnz_pad = als.declared_nnz_pad(3000, CHUNK)
    (_, pu, (gu, su)), (_, pi, (gi, si)) = als._prepared(
        data, CHUNK, torch.device("cpu"))
    for plan, gram, name in ((pu, gu, "users"), (pi, gi, "items")):
        assert isinstance(plan, list)
        assert gram == {"side": name, "chunks": nnz_pad // CHUNK,
                        "entries": nnz_pad, "padding": nnz_pad - 3000}
    assert su == {"side": "users", "rows": N_USERS}
    assert si == {"side": "items", "rows": N_ITEMS}
    pieces = gram_fused.plan(torch.as_tensor(data.by_user.self_idx),
                             N_USERS)
    gram, _ = als._span_tags("users", N_USERS, pieces, data.nnz)
    assert gram == {"side": "users", "chunks": pieces.pieces,
                    "entries": 3000, "padding": 0}
