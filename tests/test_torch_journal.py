"""The port's operational journal (``common/journal.py``) against the
JAX package's: the same emits on both give the same
``/debug/events.json`` payloads (timestamps normalized) — a monotonic
``seq`` that eviction never renumbers, the ``since_seq`` cursor, the
category and minimum-level filters and the newest-first cap — emits
pin their trace, ``PIO_JOURNAL=0`` records nothing, and ``emit`` never
raises. The port's engine server journals its load and its drain."""

import numpy as np
import pytest

from predictionio_tpu.common import journal as ref_journal
from predictionio_tpu.common import tracing as ref_tracing
from predictionio_tpu_torch.common import journal, tracing

import torch_deploy_util as util

PAIRS = ((ref_journal, ref_tracing), (journal, tracing))
CATEGORIES = ("lifecycle", "recompile", "breaker", "quant")
LEVELS = ("info", "warn", "red", "bogus")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("PIO_JOURNAL", "PIO_JOURNAL_BUFFER", "PIO_TRACE"):
        monkeypatch.delenv(name, raising=False)
    for jmod, tmod in PAIRS:
        jmod.set_enabled(None)
        jmod.clear()
        tmod.clear()
    yield
    for jmod, tmod in PAIRS:
        jmod.set_enabled(None)
        jmod.clear()
        tmod.clear()


def _normalized(snap):
    out = dict(snap)
    out["events"] = [{k: v for k, v in e.items() if k not in ("ts", "at")}
                     for e in snap["events"]]
    return out


def _emit_all(jmod, tmod, seed: int):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(int(rng.integers(20, 60))):
        cat = CATEGORIES[rng.integers(len(CATEGORIES))]
        level = LEVELS[rng.integers(len(LEVELS))]
        fields = {"n": i, "what": f"x{int(rng.integers(9))}"} \
            if rng.integers(2) else {}
        if rng.integers(4) == 0:
            with tmod.activate(tmod.TraceContext(f"trace{i}", "s")):
                seqs.append(jmod.emit(cat, f"event {i}", level=level,
                                      **fields))
        else:
            seqs.append(jmod.emit(cat, f"event {i}", level=level, **fields))
    return seqs


@pytest.mark.parametrize("buffer", ["16", "1024"])
@pytest.mark.parametrize("seed", range(3))
def test_journal_snapshots_match(monkeypatch, seed, buffer):
    monkeypatch.setenv("PIO_JOURNAL_BUFFER", buffer)
    got = []
    for jmod, tmod in PAIRS:
        seqs = _emit_all(jmod, tmod, seed)
        reads = [jmod.snapshot()]
        for since in (0, 3, seqs[len(seqs) // 2], seqs[-1], 10 ** 6):
            reads.append(jmod.snapshot(since_seq=since))
        for cat in CATEGORIES:
            reads.append(jmod.snapshot(category=cat, limit=5))
        for level in ("info", "warn", "red"):
            reads.append(jmod.snapshot(level=level))
        got.append((seqs, [_normalized(r) for r in reads],
                    jmod.events_total(),
                    tmod.snapshot(trace_id="trace3")["traces"] and True))
    assert got[0] == got[1]
    seqs, reads = got[1][0], got[1][1]
    assert seqs == list(range(1, len(seqs) + 1))
    # eviction drops records, never renumbers: the oldest kept is the
    # newest minus the capacity
    kept = [e["seq"] for e in reads[0]["events"]]
    assert kept[-1] == seqs[-1] and len(kept) == min(len(seqs),
                                                     int(buffer), 256)


def test_journal_off_records_nothing(monkeypatch):
    monkeypatch.setenv("PIO_JOURNAL", "0")
    for jmod, _tmod in PAIRS:
        assert jmod.emit("lifecycle", "x") is None
        assert jmod.snapshot()["events"] == []
        assert jmod.snapshot()["enabled"] is False


def test_emit_never_raises(monkeypatch):
    def broken(_record):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(journal._journal, "append", broken)
    assert journal.emit("lifecycle", "still answers") is None


def test_engine_server_journals_load_and_drain(monkeypatch):
    """The deploy's lifecycle in the port's journal, as in the reference:
    the model generation going live, then drain begin and complete.
    The serving path itself emits nothing."""
    monkeypatch.setenv("PIO_SERVE_QUANT", "on")
    monkeypatch.setenv("PIO_SERVE_FUSED", "off")
    japi, tapi = util.deploy_both(util.dyadic_blob())
    try:
        for api in (japi, tapi):
            for i in range(5):
                status = api.handle("POST", "/queries.json",
                                    body=util.query(f"u{i}", 3))[0]
                assert status == 200
            api.drain()
        messages = []
        for jmod, _t in PAIRS:
            events = jmod.snapshot(category="lifecycle")["events"]
            messages.append([e["message"].split(" (")[0].split(":")[0]
                             for e in events])
        assert messages[0] == messages[1] == [
            "model generation 1 live", "drain begin", "drain complete"]
        assert [e["fields"]["generation"] for e in journal.snapshot()[
            "events"]] == [1, 1, 1]
    finally:
        japi.close()
        tapi.close()
