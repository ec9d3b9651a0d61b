"""The control, on a card: the plain reference computed in TF32 (the
nearest precision below the configuration's float32), put in the program's
place, comes out not correct under each cell's limits. At the published
widths, on a smaller scene and batch than the cells'.

    python -m pytest benchmark/tests/test_benchmark_control.py   # on the card
"""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import small_cell
from benchmark.tools.readings import control_numbers


@pytest.mark.parametrize("name", ["vfnerf.train.office",
                                  "vfnerf.render.office",
                                  "vfnerf_dd.train.office"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(card, name, seed):
    cell = small_cell(name, narrow_nets=False, fine_count=100, pixels=240,
                      size=(48, 64))
    run = harness.Run(cell=cell, seed=seed, seconds=0.5, trace=False,
                      device=card, t_start=time.perf_counter(),
                      log=lambda s: None)
    driver = cell.kind.Driver(run)
    driver.setup()
    if cell.traffic["kind"] == "render":
        driver.window()
    driver.release()
    harness.free_device()
    assert harness.judge(driver.check(), cell.limits)
    assert not harness.judge(control_numbers(cell, driver), cell.limits)
