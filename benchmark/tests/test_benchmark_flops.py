"""The work counts, pinned to the hand counts in PERF.md."""

import pytest

from benchmark import flops, harness
from benchmark.harness import HERE, load_json


def conf(name):
    return load_json(HERE / "configs" / f"{name}.json")


def test_multiply_adds_a_point():
    # VF: 39·256 + 256·256·2 + 256·217 + 256·256·4 + 256·259.
    assert flops.vf_macs(conf("vf_nerf")) == 525_056
    # Colour: 289·256 + 256·256·3 + 256·3.
    assert flops.colour_macs(conf("vf_nerf")) == 271_360


@pytest.mark.parametrize("cell,unit,gflop", [
    ("vfnerf.train.office", "step", 1196.21763072),
    ("vfnerf.render.office", "chunk", 433.7434624),
    ("vfnerf_dd.train.office", "step", 1196.21763072 + 9 * 2 * 201_600 *
     525_056 / 1e9),
])
def test_work_of_a_unit(cell, unit, gflop):
    c = harness.find_cell(cell)
    work = c.hooks.work(c.conf, c.traffic)
    assert work["step"] / 1e9 == pytest.approx(gflop, rel=1e-12)


def test_train_step_parts():
    c = harness.find_cell("vfnerf.train.office")
    work = c.hooks.work(c.conf, c.traffic)
    rays = 1008
    assert flops.step_rays(c.traffic) == rays
    coarse = rays * 100 * 525_056
    graded = rays * 200 * (525_056 + 271_360) + 2 * 20_160 * 525_056
    assert work["mlp_forward"] == 2 * (coarse + graded)
    assert work["mlp_backward"] == 4 * graded
    assert work["step"] == work["mlp_forward"] + work["mlp_backward"]
