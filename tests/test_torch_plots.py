"""The port's vector-field plots against the JAX package's, on the CPU.

- ``_field_on_slice``, plain and smoothed, equals JAX's from the same
  weights: the grid points exactly, the field within rtol 1e-5 / atol 1e-6
  (``tests/test_torch_eval.py::test_get_vector_field_equals_jax``'s
  tolerance on the field; the smoothing is host numpy in both);
- each plot writes the files JAX's writes, under the same folders, as
  ``tests/test_tools.py::TestExtras::test_plots_smoke`` checks JAX's;
- ``evaluate`` dispatches the three plot methods as JAX's ``evaluate.py``
  does (plain and smoothed), writing those folders under the eval folder.
"""

import os

import numpy as np
import pytest

import __graft_entry__ as graft
from test_torch_render import port_config
from test_torch_train_step import tiny_variables
from vf_nerf_tpu.evaluation import plots as jplots
from vf_nerf_tpu.models.nerf import VectorFieldNerf as JVectorFieldNerf
from vf_nerf_torch.evaluation import plots
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils.weights import load_jax_variables

CENTROID = np.array([0.1, -0.2, 0.3])


@pytest.fixture(scope="module")
def models():
    jcfg = graft._tiny_config()
    _, variables = tiny_variables(jcfg, seed=4)
    jmodel = JVectorFieldNerf(jcfg)
    jmodel.state = jmodel.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    model = VectorFieldNerf(port_config(jcfg), device="cpu")
    load_jax_variables(model, variables)
    return jmodel, model


@pytest.mark.parametrize("smooth", [False, True])
def test_field_on_slice_equals_jax(models, smooth):
    jmodel, model = models
    jpts, jvf = jplots._field_on_slice(jmodel, 0.25, 1.2, CENTROID, 12,
                                      smooth)
    pts, vf = plots._field_on_slice(model, 0.25, 1.2, CENTROID, 12, smooth)
    np.testing.assert_array_equal(pts, jpts)
    assert vf.shape == (144, 3) and vf.dtype == np.float32
    np.testing.assert_allclose(vf, np.asarray(jvf), rtol=1e-5, atol=1e-6)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_plots_write_the_jax_files(models, tmp_path):
    jmodel, model = models
    for pkg, mod, root in ((jplots, jmodel, tmp_path / "jax"),
                           (plots, model, tmp_path / "port")):
        for smooth in (False, True):
            pkg.plot_2d_slices(mod, str(root), scale=1.0, centroid=CENTROID,
                               smooth=smooth, n=6, n_slices=2)
            pkg.plot_overall_scene(mod, str(root), scale=1.0,
                                   centroid=CENTROID, smooth=smooth, n=6)
            pkg.plot_3d_slices(mod, str(root), smooth=smooth, n=6,
                               n_slices=2)
    ours = _files(tmp_path / "port")
    assert ours == _files(tmp_path / "jax")
    assert "plots-overall/overall.png" in ours
    assert "plots-3d-slices-smoothed/slice-1.png" in ours
    assert len(ours) == 10
    for name in ours:
        with open(tmp_path / "port" / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_evaluate_dispatches_the_plot_methods(tmp_path, monkeypatch):
    """``evaluate``'s plot methods on a saved checkpoint: each writes its
    plain and smoothed folders (the quivers' grid cut to 4 × 4 here)."""
    from test_torch_runner import write_conf
    from vf_nerf_torch.config import parse_config
    from vf_nerf_torch.evaluation import evaluate as evaluate_mod
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner

    for name in ("plot_2d_slices", "plot_overall_scene", "plot_3d_slices"):
        original = getattr(plots, name)
        monkeypatch.setattr(plots, name,
                            lambda *a, _f=original, **k: _f(*a, n=4, **k))
    conf = write_conf(str(tmp_path))
    cfg = parse_config(scene="box", config_path=conf, expname="p",
                       timestamp="run", gpu="cpu", offline=True)
    cfg.num_epochs = 1
    VectorFieldNerfRunner(cfg).train()
    evals = str(tmp_path / "evals")
    for method in ("plot-2d-slices", "plot-overall-scene", "plot-3d-slices"):
        cfg = parse_config(scene="box", config_path=conf, expname="p",
                           timestamp="run", checkpoint="latest", gpu="cpu")
        folder = evaluate_mod.evaluate(cfg, method, 32, evals, 512, 0.05, 8)
    assert sorted(os.listdir(folder)) == [
        "plots-2d-slices", "plots-2d-slices-smoothed", "plots-3d-slices",
        "plots-3d-slices-smoothed", "plots-overall",
        "plots-overall-smoothed"]
    assert len(os.listdir(os.path.join(folder, "plots-2d-slices"))) == 5
    assert len(os.listdir(os.path.join(folder, "plots-3d-slices"))) == 8
