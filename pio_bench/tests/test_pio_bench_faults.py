"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with one fault of ``faults.py`` planted
in the port's trainer (the exchange between chips has no place in a
one-chip cell)."""

import pytest

from pio_bench import faults


def test_a_sound_run_is_correct(tiny_cell, run_cpu):
    out = run_cpu(tiny_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_ratings_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out["checks"]) == ["layout", "half_step", "factors", "rmse"]


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_fault_makes_the_run_not_correct(kind, tiny_cell, run_cpu):
    with faults.planted(kind):
        out = run_cpu(tiny_cell())
    assert not out["correct"], out["checks"]


def test_faults_restore_the_trainer():
    from predictionio_tpu_torch.ops import als
    before = (als.train_explicit, als.gram_rhs)
    for kind in faults.KINDS:
        with faults.planted(kind):
            assert (als.train_explicit, als.gram_rhs) != before
        assert (als.train_explicit, als.gram_rhs) == before


def test_a_traced_run_with_no_device_events_fails(tiny_cell, run_cpu,
                                                  monkeypatch):
    """A profiler session that records no card activity (as sessions in
    a long process have been seen to) fails the run: no zero, no null."""
    from pio_bench import trace

    class Empty:
        start_ns = end_ns = 0

        def start(self):
            pass

        def stop(self):
            pass

        def ops(self):
            return []

    monkeypatch.setattr(trace, "Session", Empty)
    monkeypatch.setattr(trace, "discard_first_session", lambda device: None)
    with pytest.raises(RuntimeError, match="no device operation"):
        run_cpu(tiny_cell(), trace=True)


def test_the_window_runs_whole_trains_until_its_seconds(tiny_cell, run_cpu):
    cell = tiny_cell()
    out = run_cpu(cell, seconds=4.0)
    work = out["attempted"] * cell.config["n_ratings"] \
        * cell.config["iterations"]
    window_s = work / out["metrics"]["train_ratings_per_s"]["value"]
    assert window_s >= 4.0
