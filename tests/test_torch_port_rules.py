"""The port's rules: it imports neither ``jax`` nor ``vf_nerf_tpu``, its
entry points refuse to run without CUDA unless asked for the CPU, a CUDA
tensor never reaches a kernel's plain version, and the parts outside this
slice raise ``NotImplementedError``.

The import check runs in a subprocess, because this test process has
imported jax already (``tests/conftest.py``).
"""

import dataclasses
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vf_nerf_torch import kernels
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.models.nerf import VectorFieldNerf, resolve_device
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.ops import fused_mlp, ray_march

ROOT = Path(__file__).resolve().parents[1]
CONF = str(ROOT / "confs" / "vf_nerf.conf")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|vf_nerf_tpu|flax|optax)\b",
                       re.MULTILINE)

_RENDER_IN_CLEAN_PROCESS = f"""
import sys
import numpy as np
import vf_nerf_torch
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.models.nerf import VectorFieldNerf

cfg = parse_config(scene="s", config_path={CONF!r}).vf_nerf_config
cfg.vf_net_config.dimensions = [64, 64, 64]
cfg.vf_net_config.skip_connection_in = [2]
cfg.vf_net_config.feature_vector_dims = 16
cfg.rendering_net_config.dimensions = [32]
cfg.rendering_net_config.feature_vector_dims = 16
cfg.ray_sampler_config.n_samples = 20
cfg.ray_sampler_config.n_importance = 6
model = VectorFieldNerf(cfg, device="cpu")
n = 8
uv = np.random.RandomState(0).uniform(0, 40, (n, 2)).astype(np.float32)
pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
intr[:, 0, 0] = intr[:, 1, 1] = 30.0
out = model.render(pose, uv, intr, epoch=0)
assert out["rgb"].shape == (n, 3) and out["depth"].shape == (n, 1)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "vf_nerf_tpu"))
print("LOADED", loaded)
"""


def test_import_and_cpu_render_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", _RENDER_IN_CLEAN_PROCESS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "vf_nerf_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_default_device_is_cuda_and_never_the_cpu():
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VectorFieldNerf(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("change", [
    dict(rendering="nerf"), dict(train=True), dict(reuse_coarse=True),
    dict(compute_dir_derivatives=True), "n_fine_active"])
def test_unported_paths_raise(change):
    """Each unported option raises; static fine growth is ported, and with
    train-mode BatchNorm (which the JAX package refuses with it too) it
    raises."""
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    cfg.vf_net_config.dimensions = [48, 48]
    cfg.vf_net_config.skip_connection_in = [1]
    cfg.rendering_net_config.dimensions = [16]
    mods = VFNerfModules(cfg).eval()
    statics = RenderStatics.from_config(cfg, n_fine=4, train=False)
    kw = {}
    if change == "n_fine_active":
        kw["n_fine_active"] = 2
        statics = dataclasses.replace(statics, train=True)
    else:
        statics = dataclasses.replace(statics, **change)
    eye = torch.eye(4).expand(2, 4, 4)
    with pytest.raises(NotImplementedError):
        render_rays(mods, torch.zeros(2, 2), eye, eye, 0.0, 1.0,
                    torch.full((11,), 0.09), statics,
                    generator=torch.Generator(), **kw)


@pytest.mark.parametrize("section,field,value", [
    ("vf_net_config", "weight_norm", True),
    ("rendering_net_config", "weight_norm", True),
    ("device_config", "compute_dtype", "bfloat16")])
def test_unported_config_options_raise(section, field, value):
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError):
        VFNerfModules(cfg)


def test_train_mode_batch_norm_raises():
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    mods = VFNerfModules(cfg).train()
    with pytest.raises(NotImplementedError):
        mods.vf(torch.zeros(4, 3))


def _fake_cuda_args(wrapper, grad=False, mode=None):
    """Arguments for ``wrapper`` as fake CUDA tensors: they carry a CUDA
    device, shape and dtype but no storage, so they build on a machine
    without a card. ``grad``: they take a gradient (the training path);
    ``mode``: an active fake-tensor mode to build them in."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with mode or FakeTensorMode():
        def t(*shape, grad=grad):
            return torch.empty(shape, device="cuda", requires_grad=grad)
        if wrapper == "fused_mlp":
            return (fused_mlp.fused_mlp,
                    ([(t(39, 16), t(16)), (t(16, 3), t(3))], t(8, 39)), {})
        params = ray_march.DensityParams(t(), t(), t())
        kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0,
                  mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=-2.0,
                  normalize=True)
        return (ray_march.fused_ray_march,
                (t(4, 20, 3), t(4, 3, grad=False), t(4, 20, grad=False),
                 t(4, 20, 3), params, t(11, grad=False)),
                kw)


@pytest.mark.parametrize("wrapper", ["fused_mlp", "fused_ray_march"])
def test_cuda_tensors_never_take_the_plain_version(wrapper, monkeypatch,
                                                   tmp_path):
    """A CUDA tensor goes to the kernel library or raises: with no nvcc and
    no built library the wrapper raises, and its plain version is never
    called."""
    def fell_back(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fused_mlp, "mlp_reference", fell_back)
    monkeypatch.setattr(ray_march, "ray_march_reference", fell_back)
    monkeypatch.setattr(ray_march, "ray_march_backward_reference", fell_back)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    fn, args, kw = _fake_cuda_args(wrapper)
    kernels.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(*args, **kw)
    finally:
        kernels.load_library.cache_clear()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("wrapper", ["fused_mlp", "fused_ray_march"])
def test_cuda_tensors_with_a_gradient_take_the_autograd_functions(
        wrapper, monkeypatch):
    """With grad mode on and an input that takes a gradient, a CUDA call
    goes to ``FusedMLP`` / ``FusedRayMarch`` (whose forward and backward
    launch the kernels), never to the plain version. Only the routing is
    checked here: a CPU-only PyTorch cannot run autograd on CUDA tensors,
    so the Functions' ``apply`` is replaced by a marker."""
    class Routed(Exception):
        pass

    def routed(*args, **kwargs):
        raise Routed()

    def fell_back(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fused_mlp, "mlp_reference", fell_back)
    monkeypatch.setattr(ray_march, "ray_march_reference", fell_back)
    monkeypatch.setattr(fused_mlp.FusedMLP, "apply", routed)
    monkeypatch.setattr(ray_march.FusedRayMarch, "apply", routed)
    monkeypatch.setattr(ray_march, "march_scalars",
                        lambda *a, **k: torch.zeros(5))
    monkeypatch.setattr(ray_march, "load_library", lambda: _FakeLib())
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fn, args, kw = _fake_cuda_args(wrapper, grad=True, mode=mode)
        with pytest.raises(Routed):
            fn(*args, **kw)


class _FakeLib:
    """Answers the march wrapper's size queries."""

    class lib:
        vfn_ray_march_max_samples = staticmethod(lambda: 1024)
        vfn_ray_march_max_taps = staticmethod(lambda: 64)
