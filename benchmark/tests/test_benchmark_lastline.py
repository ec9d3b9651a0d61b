"""The shape of a run's result line, and the run's refusals: no card, and a
module of JAX or of the package the program was ported from."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.harness import ROOT
from benchmark.tests.conftest import cpu_run, small_cell


def test_result_keys_and_order():
    cell = small_cell("vfnerf.render.office")
    result = harness.run_cell(cpu_run(cell))
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"render_rays_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vfnerf.train.office", "--seed", str(2**33), "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_names_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "vf_nerf_tpu", "vf_nerf_tpu.models", "vf_nerf_torch",
             "vf_nerf_torch.ops", "jaxtyping", "flaxen", "vf_nerf_tpux"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "vf_nerf_tpu", "vf_nerf_tpu.models"])


def test_a_run_loads_no_jax():
    code = ("import sys; from benchmark import harness, program, trace; "
            "from benchmark.tests.conftest import cpu_run, small_cell; "
            "harness.run_cell(cpu_run(small_cell('vfnerf.train.office'))); "
            "print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_a_loaded_jax_fails_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.RunError, match="jax"):
        harness.run_cell(cpu_run(small_cell("vfnerf.render.office")))
