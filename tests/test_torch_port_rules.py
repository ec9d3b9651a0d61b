"""The port's rules: it imports neither ``jax`` nor ``vf_nerf_tpu`` (the
loaders, the JPEG codec, the joint stage, the plots, helpers and library
leftovers, and the port's tools
``tools/torch_*.py`` included, which import no JAX-side tool either) and
loads no library
from the root ``csrc/``, its entry points (the joint stage's too) refuse to
run without CUDA unless asked for the CPU, a CUDA tensor never reaches a
kernel's plain version, a failed host build raises instead of falling back
to numpy, and the paths the JAX package refuses raise.

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
from vf_nerf_torch.kernels import host
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
import vf_nerf_torch.evaluation.evaluate
import vf_nerf_torch.evaluation.mc.pipeline
import vf_nerf_torch.ops.projector
import vf_nerf_torch.train.joint_exp_runner
import vf_nerf_torch.utils.geometry
import vf_nerf_torch.datasets.helpers.colmap
import vf_nerf_torch.datasets.helpers.llff
import vf_nerf_torch.datasets.helpers.poses_utils
import vf_nerf_torch.evaluation.plots
import vf_nerf_torch.models.output
import vf_nerf_torch.ops.ndc
import vf_nerf_torch.utils.metrics
import vf_nerf_torch.utils.profiling
import vf_nerf_torch.utils.schedules
# The plots import matplotlib only when they draw (the card lacks it).
assert "matplotlib" not in sys.modules
sys.path.insert(0, "tools")
import torch_office_attribution, torch_office_cohort, torch_office_protocol
import torch_scannet_protocol
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import jpeg

# The loaders' JPEG path through the host library csrc/jpeg.cpp.
img = (np.arange(8 * 12 * 3) % 251).astype(np.uint8).reshape(8, 12, 3)
decoded = jpeg.decode_jpeg(jpeg.encode_jpeg(img))
assert decoded.shape == img.shape
assert np.array_equal(decoded, jpeg.decode_jpeg_numpy(jpeg.encode_jpeg(img)))
assert sorted(dataset_dict) == ["replica", "scannet", "synthetic",
                                "synthetic_office"]

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


def port_sources():
    """The port's Python files: the package, ``chip_smoke.py`` and the
    port's tools (``tools/torch_*.py``)."""
    files = sorted((ROOT / "vf_nerf_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("torch_*.py"))
    return files


def jax_side_tools():
    """The tools outside the port that import jax or the JAX package."""
    return sorted(path.stem for path in (ROOT / "tools").glob("*.py")
                  if not path.stem.startswith("torch_")
                  and FORBIDDEN.search(path.read_text()))


def test_no_source_imports_jax_or_the_jax_package():
    files = port_sources()
    assert len(files) > 15
    tools = jax_side_tools()
    assert {"office_protocol", "convergence_variance", "office_attribution",
            "scannet_protocol"} <= set(tools)
    jax_tools = re.compile(rf"^\s*(import|from)\s+({'|'.join(tools)})\b",
                           re.MULTILINE)
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
        hits = jax_tools.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
    assert {p.name for p in files} >= {"torch_office_protocol.py",
                                       "torch_office_attribution.py",
                                       "torch_scannet_protocol.py"}


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


def _entry_point_calls(tmp_path):
    """The training runner, the VF-init fit and the evaluation, each called
    as a user would without naming a device."""
    from vf_nerf_torch.config.parser import config_device
    from vf_nerf_torch.evaluation.evaluate import evaluate
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner
    from vf_nerf_torch.train.vf_init import default_vf_config, fit_vf_init

    def runner_config(gpu="auto"):
        cfg = parse_config(scene="s", config_path=CONF, gpu=gpu,
                           timestamp="t", offline=True)
        cfg.dataset_config.dataset_name = "synthetic"
        cfg.exps_folder = str(tmp_path / "exps")
        return cfg

    assert config_device(runner_config()) == "cuda"
    assert config_device(runner_config("cpu")) == "cpu"
    def joint_runner():
        from vf_nerf_torch.config.joint_parser import \
            parse_config as joint_config
        from vf_nerf_torch.train.joint_runner import JointOptimizationRunner
        cfg = joint_config(scene="s", vf_config_path=CONF,
                           joint_config_path=str(
                               ROOT / "confs" / "joint_optimization.conf"),
                           timestamp="t", offline=True)
        cfg.vf_config.dataset_config.dataset_name = "synthetic"
        cfg.vf_config.exps_folder = str(tmp_path / "exps")
        return JointOptimizationRunner(cfg)

    return {
        "joint": joint_runner,
        "runner": lambda: VectorFieldNerfRunner(runner_config()),
        "vf_init": lambda: fit_vf_init(default_vf_config(), "exterior_scene",
                                       [0, 0, 0], 1.0, 1.0, steps=1),
        "evaluate": lambda: evaluate(runner_config(), "metrics", 32,
                                     str(tmp_path / "evals"), 1024, 0.05, 8),
    }


@pytest.mark.parametrize("entry", ["runner", "vf_init", "evaluate",
                                   "joint"])
def test_train_and_eval_entry_points_default_to_cuda(entry, tmp_path):
    """Without ``device="cpu"`` or ``--gpu cpu`` the runner, the VF-init fit,
    the evaluation and the joint stage run on CUDA, and without a card they
    raise before writing anything."""
    call = _entry_point_calls(tmp_path)[entry]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is CUDA there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert not (tmp_path / "exps").exists()
    assert not (tmp_path / "evals").exists()


@pytest.mark.parametrize("change", [
    dict(reuse_coarse=True), "n_fine_active", "dropout"])
def test_unported_paths_raise(change):
    """Each path the JAX package refuses raises: ``reuse_coarse`` with
    static fine growth (JAX asserts it off there); static fine growth with
    train-mode BatchNorm; dropout in train mode (the JAX renderer passes no
    dropout rng, so the JAX package cannot train with it)."""
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    cfg.vf_net_config.dimensions = [48, 48]
    cfg.vf_net_config.skip_connection_in = [1]
    cfg.rendering_net_config.dimensions = [16]
    if change == "dropout":
        cfg.vf_net_config.dropout = True
        cfg.vf_net_config.dropout_probability = 0.2
    mods = VFNerfModules(cfg).eval()
    statics = RenderStatics.from_config(cfg, n_fine=4, train=False)
    kw = {}
    if change == "n_fine_active":
        kw["n_fine_active"] = 2
        statics = dataclasses.replace(statics, train=True)
    elif change == "dropout":
        statics = dataclasses.replace(statics, train=True)
    else:
        statics = dataclasses.replace(statics, **change)
        kw["n_fine_active"] = 2
    eye = torch.eye(4).expand(2, 4, 4)
    with pytest.raises(NotImplementedError):
        render_rays(mods, torch.zeros(2, 2), eye, eye, 0.0, 1.0,
                    torch.full((11,), 0.09), statics,
                    generator=torch.Generator(), **kw)


@pytest.mark.parametrize("section,field,value", [
    ("device_config", "compute_dtype", "bogus")])
def test_unported_config_options_raise(section, field, value):
    """A compute dtype the port does not take raises (bfloat16 and float16
    are ported)."""
    cfg = parse_config(scene="s", config_path=CONF).vf_nerf_config
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(ValueError, match="compute_dtype"):
        VFNerfModules(cfg)


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


# The root csrc's libraries by name, the root reached from a module
# (``parents[2] / "csrc"``) or a path joined onto "csrc".
ROOT_CSRC = re.compile(r"libmeshops\.so|librasterizer\.so|"
                       r"parents\[2\]\s*/\s*[\"']csrc|"
                       r"join\([^)]*[\"']csrc[\"']")


def test_no_source_loads_the_root_csrc_libraries():
    """The port builds its own host libraries from ``vf_nerf_torch/csrc``
    into ``build/host``; no module names the root ``csrc/`` or its ``.so``
    files, and the host build's sources and outputs lie where it says."""
    for path in port_sources():
        hits = ROOT_CSRC.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} names {hits}"
    assert host.CSRC == ROOT / "vf_nerf_torch" / "csrc"
    assert host.BUILD_ROOT == ROOT / "build" / "host"
    assert (host.CSRC / "meshops.cpp").exists()
    assert (host.CSRC / "rasterizer.cpp").exists()
    assert [p.suffix for p in kernels.sources()] == [".cu", ".cu"]


def _host_calls():
    """One call of each path that needs a host library."""
    import numpy as np
    from vf_nerf_torch.evaluation import renderer
    from vf_nerf_torch.evaluation.mc import contrastive

    gv = np.zeros((1, 8, 3))
    vv = np.array([[-1.0, 1, 1, 1, 1, 1, 1, 1]])
    tris = np.random.RandomState(0).rand(4, 3, 3)
    verts = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    from vf_nerf_torch.utils import jpeg
    data = jpeg.encode_jpeg(np.zeros((8, 8, 3), np.uint8))
    return {
        "decode_jpeg": lambda: jpeg.decode_jpeg(data),
        "emit_triangles": lambda: contrastive.emit_triangles(gv, vv),
        "dedup_mesh": lambda: contrastive.dedup_mesh(tris),
        "render_depth": lambda: renderer.render_depth(
            verts, faces, np.eye(4), np.eye(4), 4, 4),
    }


@pytest.mark.parametrize("call", ["emit_triangles", "dedup_mesh",
                                  "render_depth", "decode_jpeg"])
def test_a_failed_host_build_raises_and_never_falls_back(call, monkeypatch,
                                                         tmp_path):
    """Without g++ (and no library built for the source hash) each host
    path raises naming g++; the numpy versions are never called and nothing
    is written."""
    from vf_nerf_torch.evaluation import renderer
    from vf_nerf_torch.evaluation.mc import contrastive
    from vf_nerf_torch.utils import jpeg

    def fell_back(*args, **kwargs):
        raise AssertionError("a host path fell back to numpy")

    monkeypatch.setattr(contrastive, "emit_triangles_numpy", fell_back)
    monkeypatch.setattr(renderer, "_render_depth_numpy", fell_back)
    monkeypatch.setattr(jpeg, "decode_jpeg_numpy", fell_back)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setattr(host, "BUILD_ROOT", tmp_path / "build")
    host.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            _host_calls()[call]()
    finally:
        host.load_host_library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_a_failing_host_compile_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; no library is left."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'bad source' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(shutil, "which", lambda _: str(fake))
    monkeypatch.setattr(host, "BUILD_ROOT", tmp_path / "build")
    host.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="bad source"):
            host.meshops()
    finally:
        host.load_host_library.cache_clear()
    assert not list((tmp_path / "build").rglob("*.so"))
