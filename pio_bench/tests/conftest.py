"""Tests of the benchmark harness itself (``pio_bench/``).

Run with ``python -m pytest pio_bench/tests -q``. Most run on the CPU at
tiny sizes; those marked ``card`` need a CUDA card and skip without one
(the fixture decides, never an import). On the card:
``python -m pytest pio_bench/tests -q -m card``.
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a cell small enough for the CPU: the port pads every layout to one
#: chunk of 262,144 entries there, so a run takes a few seconds
TINY = {"n_users": 300, "n_items": 200, "n_ratings": 6000,
        "user_ratings": {"min": 5, "max": 150}, "item_ratings": {"max": 200},
        "iterations": 3}


#: the limits at TINY's sizes on the CPU, set like a cell's (PERF.md): the
#: largest sound reading over 12 seeds and the least reading of the TF32
#: control over 3, for ML-20M's and Netflix's configuration at TINY's
#: sizes: half_step 6.6e-5 / 8.8e-3, factors 2.6e-4 / 9.7e-3, rmse
#: 1.4e-6 / 2.8e-5. A cell's own limits hold at its own size only.
TINY_LIMITS = {"layout": 0, "half_step": 1e-3, "factors": 3e-3,
               "rmse": 1e-5}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture()
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda", 0)


def _tiny_cell(name="ml20m-als-r20.train", root=ROOT, **sizes):
    from pio_bench import manifest
    cell = manifest.load_cell(root, name)
    cell.config = dict(cell.config, **{**TINY, **sizes})
    cell.limits = dict(cell.limits, limits=dict(TINY_LIMITS))
    return cell


def _run_cpu(cell, seed=7, seconds=0.0, trace=False):
    import torch
    from pio_bench import manifest
    return manifest.driver(cell).run(cell, seed, seconds, trace,
                                     torch.device("cpu"),
                                     time.perf_counter(),
                                     log=lambda msg: None)


@pytest.fixture()
def tiny_cell():
    """A cell of the manifest at TINY's sizes (or the sizes given)."""
    return _tiny_cell


@pytest.fixture()
def run_cpu():
    """The rest of a run below the harness's look for a card, on the
    CPU: returns what the cell's ``drivers/<kind>.py`` run returns."""
    return _run_cpu
