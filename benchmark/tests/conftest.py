"""Shared helpers of the benchmark's tests: the cells at a size a CPU test
run holds (the nets narrowed, a small scene), and the ``card`` fixture,
which skips a test that needs a CUDA card (decided inside the fixture)."""

import copy
import time

import pytest
import torch

from benchmark import harness


def narrow(conf: dict) -> dict:
    """The configuration with narrow nets and few samples (CPU tests)."""
    c = copy.deepcopy(conf)
    c["vector_field_network"]["dimensions"] = [64] * 8
    c["vector_field_network"]["feature_vector_dims"] = 32
    c["rendering"]["dimensions"] = [32] * 4
    c["rendering"]["feature_vector_dims"] = 32
    c["ray_sampler"].update(n_samples=16, n_importance=4, max_samples=8)
    return c


def small_cell(name: str, narrow_nets: bool = True, fine_count: int = 8,
               pixels: int = 64, size=(16, 24)) -> harness.Cell:
    """A cell of BENCHMARK.json cut to a test's size."""
    cell = harness.find_cell(name)
    if narrow_nets:
        cell.conf = narrow(cell.conf)
    t = dict(cell.traffic, fine_count=fine_count,
             scene=dict(cell.traffic["scene"], n_views=4,
                        image_size=list(size)))
    if t["kind"] == "train":
        t["pixels_per_batch"] = pixels
    else:
        t["chunk"] = size[0] * size[1] // 4
    cell.traffic = t
    return cell


def cpu_run(cell, seed: int = 2**31 + 7, trace: bool = False,
            seconds: float = 0.1) -> harness.Run:
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter(), log=lambda s: None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
