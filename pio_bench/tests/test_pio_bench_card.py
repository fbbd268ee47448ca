"""On the card: the control fails where the program passes.

At each cell's own size and on three seeds: the program's train is
correct by the cell's limits, and the reference put in its place in TF32
(the control) is not. ``pio_bench/readings.py`` takes the same readings
on more seeds, with the faults (PERF.md gives them). Run with
``python -m pytest pio_bench/tests -q -m card`` on a machine with a card
(about three minutes).
"""

import pytest

from pio_bench import compare, data, manifest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell_name", ["ml20m-als-r20.train",
                                       "netflix-als-r32.train"])
def test_program_passes_and_the_control_fails(cuda_card, cell_name):
    cell = manifest.load_cell(ROOT, cell_name)
    drv = manifest.driver(cell)
    cfg = cell.config
    ref = drv.reference_module(cfg)
    limits = cell.limits["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        coo, (u0, v0) = data.inputs(cfg, seed, cuda_card)
        sides = ref.layouts(*coo, cfg["n_users"], cfg["n_items"])
        layout = drv.build_layout(cfg, coo, cuda_card)
        U, V = drv.program_call(cfg, layout, u0, v0, cuda_card)(
            cfg["iterations"])
        numbers = drv.layout_numbers(layout, sides)
        del layout
        numbers.update(drv.factor_numbers(cfg, coo, u0, v0, U, V, ref,
                                          sides))
        assert compare.judged(numbers, limits)[0], (seed, numbers)
        Uc, Vc = ref.train(u0, v0, *sides, cfg["iterations"], cfg["lambda"],
                           "tf32")
        control = {"layout": 0.0}
        control.update(drv.factor_numbers(cfg, coo, u0, v0, Uc, Vc, ref,
                                          sides))
        assert not compare.judged(control, limits)[0], (seed, control)
