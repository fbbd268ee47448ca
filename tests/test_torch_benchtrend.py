"""The port's bench-trajectory tracker (``predictionio_tpu_torch/tools/
benchtrend.py``) against the reference's: the same round files through
both packages give equal ``load_rounds``, ``render`` text, ``gate``
failures, ``trend_brief`` and ``main`` exit codes and output; the repo's
own ``BENCH_r0*.json`` rounds, read only, render the same table."""

import glob
import json
import os

import pytest

from predictionio_tpu.tools import benchtrend as ref
from predictionio_tpu_torch.tools import benchtrend as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WARM = {"compile_cache": {"before": {"entries": 100, "bytes": 1}}}
COLD = {"compile_cache": {"before": {"entries": 0, "bytes": 0}}}

#: each scenario: rounds as (n, value, detail, metric, wrapper), or a
#: string for a file that does not parse
SCENARIOS = {
    "wrapper_and_bare": [
        (1, 2.0, {}, "m_steady_s", True),
        (2, 1.5, {"serve_http_p99_ms": 1.8}, "m_steady_s", False)],
    "unparseable": [
        (1, 2.0, {}, "m_steady_s", True), "{not json",
        (3, 1.9, {}, "m_steady_s", True), '{"metric": "m", "value": "x"}'],
    "warm_and_cold_cache": [
        (1, 1.0, {"warmup_compile_s": 30.0, **WARM}, "m_steady_s", True),
        (2, 1.0, {"warmup_compile_s": 400.0, **COLD}, "m_steady_s", True),
        (3, 1.0, {"warmup_compile_s": 400.0, **WARM}, "m_steady_s", True)],
    "metric_rename": [
        (1, 1.0, {"steady_per_iter_ms": 80.0}, "m_wallclock_s", True),
        (2, 9.0, {"steady_per_iter_ms": 85.0}, "m_steady_s", True),
        (3, 8.5, {"steady_per_iter_ms": 84.0}, "m_steady_s", True)],
    "injected_regression": [
        (1, 10.0, {"serve_http_p99_ms": 2.0,
                   "serve_batched_qps_gain": 3.0}, "m_steady_s", True),
        (2, 8.0, {"serve_http_p99_ms": 1.8,
                  "serve_batched_qps_gain": 2.9}, "m_steady_s", True),
        (3, 22.5, {"serve_http_p99_ms": 5.0,
                   "serve_batched_qps_gain": 1.2}, "m_steady_s", True)],
    "absolute_ceilings": [
        (1, 1.0, {"time_to_ready_s": 3.0, **WARM}, "m_steady_s", True),
        (2, 1.0, {"time_to_ready_s": 14.0, "lint_findings_total": 2,
                  **WARM}, "m_steady_s", True)],
}


def _write(tmp_path, rounds):
    paths = []
    for k, rnd in enumerate(rounds, start=1):
        path = tmp_path / f"BENCH_r{k:02d}.json"
        if isinstance(rnd, str):
            path.write_text(rnd)
        else:
            n, value, detail, metric, wrapper = rnd
            body = {"metric": metric, "value": value, "unit": "s",
                    "detail": detail}
            path.write_text(json.dumps(
                {"n": n, "cmd": "python bench.py", "rc": 0, "tail": "...",
                 "parsed": body} if wrapper else body))
        paths.append(str(path))
    return paths


def _same_gate(got, want):
    """The gate's lines, the lint baseline named by each package."""
    assert [g.replace("predictionio_tpu_torch/tools/analyze/"
                      "lint_baseline.json", "conf/lint_baseline.json")
            for g in got] == want


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("threshold", [0.25, 0.10])
def test_rounds_render_and_gate_as_the_reference(tmp_path, name, threshold):
    paths = _write(tmp_path, SCENARIOS[name])
    got, want = port.load_rounds(paths), ref.load_rounds(paths)
    assert got == want
    rounds = got[0]
    assert port.render(rounds, threshold) == ref.render(rounds, threshold)
    _same_gate(port.gate(rounds, threshold), ref.gate(rounds, threshold))
    assert (port.trend_brief(rounds, threshold)
            == ref.trend_brief(rounds, threshold))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("strict", [False, True])
def test_main_exits_and_prints_as_the_reference(tmp_path, capsys,
                                                monkeypatch, name, strict):
    paths = _write(tmp_path, SCENARIOS[name])
    monkeypatch.delenv("BENCH_TREND_THRESHOLD", raising=False)
    monkeypatch.delenv("BENCH_STRICT_EXTRAS", raising=False)
    argv = (["--gate"] if strict else []) + paths
    rc_port = port.main(argv)
    out_port = capsys.readouterr()
    rc_ref = ref.main(argv)
    out_ref = capsys.readouterr()
    assert rc_port == rc_ref
    assert out_port.out == out_ref.out
    _same_gate(out_port.err.splitlines(), out_ref.err.splitlines())


def test_injected_regression_fails_the_gate(tmp_path, capsys):
    paths = _write(tmp_path, SCENARIOS["injected_regression"])
    assert port.main(["--gate", *paths]) == 1
    err = capsys.readouterr().err
    assert "BENCHTREND GATE FAILED" in err and "value" in err
    assert "serve_batched_qps_gain" in err


def test_gate_current_as_the_reference(tmp_path):
    paths = _write(tmp_path, SCENARIOS["injected_regression"][:2])
    current = {"metric": "m_steady_s", "value": 30.0,
               "detail": {"serve_http_p99_ms": 9.0}}
    got, want = port.gate_current(current, paths), ref.gate_current(
        current, paths)
    _same_gate(got[0], want[0])
    assert got[1] == want[1] and got[0]


def test_the_repo_rounds_render_as_the_reference():
    paths = sorted(glob.glob(os.path.join(REPO, "BENCH_r0*.json")))
    assert paths
    rounds = port.load_rounds(paths)
    assert rounds == ref.load_rounds(paths)
    assert port.render(rounds[0]) == ref.render(rounds[0])
    _same_gate(port.gate(rounds[0]), ref.gate(rounds[0]))


def test_metrics_and_threshold_are_the_reference():
    assert port.METRICS == ref.METRICS
    assert port.DEFAULT_THRESHOLD == ref.DEFAULT_THRESHOLD
    assert port.ABSOLUTE_GATES == ref.ABSOLUTE_GATES
    assert port.ABSOLUTE_GATES_ALWAYS == ref.ABSOLUTE_GATES_ALWAYS
