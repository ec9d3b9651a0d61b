"""A run with the timed path broken underneath comes out not correct: the
training step that leaves its state unchanged, the step that leaves half
of its batch out and takes its means over the rest, and the render with
one ray's colour altered where it is produced."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import cpu_run, small_cell
from benchmark.tools.readings import planted


@pytest.mark.parametrize("name,fault", [
    ("vfnerf.train.office", "frozen"),
    ("vfnerf.train.office", "half_batch"),
    ("vfnerf_dd.train.office", "frozen"),
    ("vfnerf_dd.train.office", "half_batch"),
    ("vfnerf.render.office", "altered"),
])
def test_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with planted(fault):
        result = harness.run_cell(cpu_run(cell))
    assert result["correct"] is False
    failing = [k for k, c in result["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing


def test_no_fault_is_correct():
    with planted("none"):
        result = harness.run_cell(cpu_run(small_cell("vfnerf.train.office")))
    assert result["correct"] is True
