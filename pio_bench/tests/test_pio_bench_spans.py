"""The readers of the program's spans (``spans.py``,
``layer_metrics/gram_padding_share.py``,
``layer_metrics/idle_in_gram_share.train.py``) on made-up windows, their
manifest entries against the rules of its form, and on the card the
clock the spans share with the device trace."""

import copy

import pytest

from pio_bench import manifest, spans, trace
from pio_bench.drivers.train import LayerContext
from pio_bench.manifest import load_module

from conftest import ROOT

CFG = {"n_users": 40, "n_items": 30, "n_ratings": 500, "rank": 4,
       "iterations": 2}

#: the entries a later ``benchmark`` change appends to ``per_layer``
ENTRIES = [
    {"name": "gram_padding_share", "unit": "%", "better": "lower",
     "source": "program_counter", "layer": "Gram",
     "moves": "train_ratings_per_s",
     "workloads": ["ml20m-als-r20.train", "netflix-als-r32.train"]},
    {"name": "idle_in_gram_share.train", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "Gram",
     "moves": "train_ratings_per_s",
     "workloads": ["ml20m-als-r20.train", "netflix-als-r32.train"]},
]


def _ms(t):
    return int(t * 1e6)


def _op(start_ms, end_ms):
    return trace.Op("k", "kernel", _ms(start_ms), _ms(end_ms))


def _span(name, start_ms, end_ms, **attrs):
    from predictionio_tpu_torch.common.tracing import ProfiledSpan
    return ProfiledSpan(name, 1, _ms(start_ms), _ms(end_ms), attrs)


def _gram(start_ms, end_ms, entries, padding, side="users"):
    return _span("als.gram", start_ms, end_ms, side=side, chunks=1,
                 entries=entries, padding=padding)


# busy: [0, 30] (two overlapping ops), [40, 42], [50, 60], [100, 101],
# [200, 300]
OPS = [_op(0, 10), _op(5, 30), _op(40, 42), _op(50, 60), _op(100, 101),
       _op(200, 300)]


def _ctx(ops=OPS, window_s=1.0):
    return LayerContext(ops, window_s, trace.busy_seconds(ops), 3, CFG, None)


def _reader(name):
    return load_module(ROOT / "pio_bench" / "layer_metrics" / f"{name}.py",
                       "reader_" + name.replace(".", "_"))


@pytest.fixture()
def recorded(monkeypatch):
    """Stand the program's ring in with the spans and drop count given."""
    from predictionio_tpu_torch.common import tracing

    def put(spans_, dropped=0):
        monkeypatch.setattr(tracing, "profiler_spans",
                            lambda: (list(spans_), dropped))
    return put


def test_idle_in_gram_is_the_gaps_inside_its_spans(recorded):
    # [2, 45]: busy 2..30 and 40..42 inside, idle 13 ms (30..40, 42..45,
    # a gap inside the span); [95, 150]: busy 100..101, idle 54 ms; the
    # gap 60..95 and the solve span's idle lie outside every Gram span
    recorded([_gram(2, 45, 1000, 100), _span("als.solve", 45, 50, rows=40),
              _gram(95, 150, 1000, 300, side="items"),
              _span("als.solve", 150, 210, rows=30)])
    got = _reader("idle_in_gram_share.train").read(_ctx())
    assert got == pytest.approx(100 * 0.067)
    assert got <= _reader("device_idle_share.train").read(_ctx())
    assert _reader("gram_padding_share").read(_ctx()) == pytest.approx(20.0)


def test_overlapping_gram_spans_count_their_idle_once(recorded):
    recorded([_gram(60, 90, 10, 1), _gram(70, 100, 10, 1, side="items")])
    # the union [60, 100] less the op [50, 60] (none inside) and
    # [100, 101] (none inside): 40 ms
    assert _reader("idle_in_gram_share.train").read(_ctx()) == \
        pytest.approx(4.0)


@pytest.mark.parametrize("name", ["gram_padding_share",
                                  "idle_in_gram_share.train"])
@pytest.mark.parametrize("case", ["no_spans", "only_solves", "dropped",
                                  "no_attrs"])
def test_readers_return_nothing_without_whole_spans(recorded, name, case):
    recorded(*{
        "no_spans": ([],),
        "only_solves": ([_span("als.solve", 0, 5, rows=4)],),
        "dropped": ([_gram(2, 45, 1000, 100)], 1),
        "no_attrs": ([_span("als.gram", 2, 45)],),
    }[case])
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("name", ["gram_padding_share",
                                  "idle_in_gram_share.train"])
def test_readers_return_nothing_on_a_program_without_the_ring(
        monkeypatch, name):
    from predictionio_tpu_torch.common import tracing
    monkeypatch.delattr(tracing, "profiler_spans")
    assert spans.gram_spans() is None
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("a,b,want", [
    ([], [(0, 5)], 0), ([(0, 10)], [(2, 3), (5, 20)], 6),
    ([(0, 4), (6, 10)], [(3, 7)], 2), ([(0, 10)], [(10, 20)], 0)])
def test_overlap_of_two_unions(a, b, want):
    assert spans.overlap_ns(a, b) == want == spans.overlap_ns(b, a)


def test_the_entries_meet_the_manifests_form():
    doc = copy.deepcopy(manifest.read_manifest(ROOT))
    layers = {m["layer"] for m in doc["per_layer"]}
    doc["per_layer"].extend(copy.deepcopy(ENTRIES))
    assert manifest.problems(doc, ROOT) == []
    assert {m["layer"] for m in ENTRIES} <= layers
    for m in ENTRIES:
        assert callable(_reader(m["name"]).read)


@pytest.mark.card
def test_a_span_holds_its_kernels_on_the_profilers_clock(cuda_card):
    """A span closed after ``torch.cuda.synchronize()`` contains the
    device interval of every kernel launched inside it, and a kernel
    launched after it starts after its end: the spans and the device
    trace share one clock."""
    import torch

    from predictionio_tpu_torch.common import tracing

    trace.discard_first_session(cuda_card)
    x = torch.randn(1 << 24, device=cuda_card)
    torch.cuda.synchronize(cuda_card)
    tracing.clear()
    session = trace.Session()
    session.start()
    with tracing.span("probe"):
        for _ in range(4):
            x = x * 1.5
        torch.cuda.synchronize(cuda_card)
    x.add_(1.0)
    torch.cuda.synchronize(cuda_card)
    session.stop()
    (probe,), dropped = tracing.profiler_spans()
    tracing.clear()
    kernels = [op for op in session.ops() if op.kind == "kernel"]
    assert dropped == 0 and len(kernels) == 5, kernels
    for op in kernels[:4]:
        assert probe.start_ns <= op.start_ns < op.end_ns <= probe.end_ns
    assert kernels[4].start_ns >= probe.end_ns
