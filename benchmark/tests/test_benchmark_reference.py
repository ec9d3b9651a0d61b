"""The plain reference against the program's CPU path at a small size: the
checked training steps (loss, first gradient, change) and the rendered
chunks agree within each cell's limits."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import cpu_run, small_cell


@pytest.mark.parametrize("name", ["vfnerf.train.office",
                                  "vfnerf.render.office",
                                  "vfnerf_dd.train.office"])
def test_reference_agrees_with_the_program(name):
    cell = small_cell(name)
    result = harness.run_cell(cpu_run(cell))
    checks = result["checks"]
    assert set(checks) == set(cell.limits)
    for key, check in checks.items():
        assert check["value"] <= check["limit"], (key, check)
    assert result["correct"] is True
