"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and nvcc: without one it skips, decided
inside the ``cuda`` fixture. The file imports no jax, so on the card it runs
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

TF32 is off; tolerance rtol 1e-4 / atol 1e-5 on f32 outputs, whose sums the
kernels take in another order than cuBLAS and PyTorch's reductions.
"""

import copy

import numpy as np
import pytest
import torch

from vf_nerf_torch.config import schema
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           draw_uniforms, render_rays)
from vf_nerf_torch.ops.density import DensityParams
from vf_nerf_torch.ops.fused_mlp import fused_mlp, mlp_reference
from vf_nerf_torch.ops.ray_march import fused_ray_march, ray_march_reference

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mlp_weights(dims, skip_at, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(dims) - 1):
        in_d = dims[i] + (dims[0] if skip_at == i else 0)
        out.append((torch.from_numpy((rng.randn(in_d, dims[i + 1]) /
                                      np.sqrt(in_d)).astype(np.float32)),
                    torch.from_numpy((rng.randn(dims[i + 1]) * 0.1).astype(
                        np.float32))))
    return out


@pytest.mark.parametrize("dims,skip_at,act,n", [
    ([39, 64, 64, 64, 32], None, "none", 1),
    ([39, 64, 64, 64, 32], 2, "tanh", 1001),
    ([39, 64, 64, 64, 32], None, "sigmoid", 64),
    ([39, 256, 256, 256, 217, 256, 256, 256, 256, 259], 4, "tanh", 3001),
    ([289, 256, 256, 256, 256, 3], None, "sigmoid", 130),
    ([7, 5, 3], None, "tanh", 65),
    ([39, 380, 3], None, "none", 77),
])
def test_fused_mlp_kernel(cuda, dims, skip_at, act, n):
    weights = _mlp_weights(dims, skip_at, seed=n)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (n, dims[0])).astype(np.float32))
    ref = mlp_reference(weights, x, skip_at, act)
    before = fused_mlp.launches
    out = fused_mlp([(w.to(cuda), b.to(cuda)) for w, b in weights],
                    x.to(cuda), skip_at=skip_at, final_act=act)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), **TOL)


def test_fused_mlp_refuses_strided_and_wide(cuda):
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights([39, 64, 3], None, 0)]
    x = torch.zeros((8, 78), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp(weights, x)
    wide = [(w.to(cuda), b.to(cuda))
            for w, b in _mlp_weights([39, 512, 3], None, 0)]
    with pytest.raises(ValueError, match="widths up to"):
        fused_mlp(wide, torch.zeros((8, 39), device=cuda))


def _march_inputs(n_rays, n_samples, seed=0):
    rng = np.random.RandomState(seed)
    normals = rng.randn(n_rays, n_samples, 3).astype(np.float32)
    t = np.linspace(0, np.pi, n_samples, dtype=np.float32)
    normals[..., 0] += np.cos(3 * t)[None]
    dirs = rng.randn(n_rays, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 4.0, (n_rays, n_samples)),
                axis=1).astype(np.float32)
    rgb = rng.rand(n_rays, n_samples, 3).astype(np.float32)
    return [torch.from_numpy(a) for a in (normals, dirs, z, rgb)]


@pytest.mark.parametrize("n_rays,n_samples,th,annealed,white,normalize", [
    (1024, 100, -0.2, False, False, True),
    (1024, 130, -2.0, False, False, True),
    (70, 26, -0.2, False, False, True),
    (70, 200, -0.2, True, True, False),
    (5, 1, -2.0, False, False, True),
    (33, 15, -0.2, False, False, True),
    (9, 1024, -0.2, True, False, True),
])
def test_fused_ray_march_kernel(cuda, n_rays, n_samples, th, annealed, white,
                                normalize):
    inputs = _march_inputs(n_rays, n_samples)
    params = DensityParams(*(torch.tensor(v) for v in (0.5, 100.0, 0.7)))
    taps = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08, 0.04,
                         0.02, 0.01]) if annealed else torch.full((11,), 0.09)
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=th, normalize=normalize,
              white_background=white)
    ref = ray_march_reference(*inputs, params, taps, **kw)
    before = fused_ray_march.launches
    out = fused_ray_march(*(a.to(cuda) for a in inputs),
                          DensityParams(*(v.to(cuda) for v in params)),
                          taps.to(cuda), **kw)
    torch.cuda.synchronize()
    assert fused_ray_march.launches == before + 1
    for a, b, name in zip(out, ref, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), err_msg=name,
                                   **TOL)


def test_fused_ray_march_refuses_too_many_samples(cuda):
    inputs = [a.to(cuda) for a in _march_inputs(2, 1025)]
    params = DensityParams(*(torch.tensor(v, device=cuda)
                             for v in (0.5, 100.0, 0.7)))
    with pytest.raises(ValueError, match="samples"):
        fused_ray_march(*inputs, params, torch.full((11,), 0.09,
                                                    device=cuda),
                        beta_bounds=(1e-4, 1e9), scale_min=1.0,
                        mean_bounds=(0.6, 1.0), cutoff=-0.5,
                        dir_to_normal_th=-2.0, normalize=True)


def _tiny_config() -> schema.VFNerfConfig:
    return schema.VFNerfConfig(
        vf_net_config=schema.VFNetConfig(
            input_dims=3, output_dims=3, dimensions=[32, 32, 32],
            feature_vector_dims=16, embedder_multires=4, weight_norm=False,
            batch_norm=True, skip_connection_in=[2], xavier_init=False,
            init=""),
        rendering_net_config=schema.RenderingNetConfig(
            output_dims=3, dimensions=[32, 32], feature_vector_dims=16,
            weight_norm=False, batch_norm=True, mode="idr",
            embedder_multires=2, detach_normals=True),
        ray_sampler_config=schema.RaySamplerConfig(
            n_samples=20, n_importance=6, perturb=True, near=0.0, far=4.0,
            fine_range=0.3, max_samples=40),
        device_config=schema.DeviceConfig(),
        scheduler_config=schema.SchedulerConfig(),
        density_config=schema.DensityConfig(scale_min=1.0),
        cos_sim_weights=tuple([0.09] * 11), cos_sim_weights_anneal="hard",
        anneal_start=700, anneal_end=1400, rendering="volsdf",
        normalize_rendering=True, dir_to_normal_th=-2.0)


def test_render_rays_on_card_matches_cpu(cuda):
    """One render_rays on the card launches 3 MLP and 2 march kernels and
    equals the CPU plain path on the same weights and draws."""
    cfg = _tiny_config()
    mods = VFNerfModules(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in mods.vf.layers:
            (layer[0] if isinstance(layer, torch.nn.Sequential)
             else layer).weight.mul_(3.0)
    mods = mods.eval()
    statics = RenderStatics.from_config(cfg, n_fine=6, train=False)
    n = 64
    rng = np.random.RandomState(0)
    uv = torch.from_numpy(rng.uniform(0, 40, (n, 2)).astype(np.float32))
    eye = torch.eye(4).expand(n, 4, 4).contiguous()
    intr = eye.clone()
    intr[:, 0, 0] = intr[:, 1, 1] = 30.0
    intr[:, 0, 2], intr[:, 1, 2] = 20.0, 15.0
    draws = draw_uniforms(statics, n, torch.Generator().manual_seed(1),
                          "cpu")
    taps = torch.tensor(cfg.cos_sim_weights)
    ref = render_rays(mods, uv, eye, intr, 0.0, 4.0, taps, statics, **draws)
    gpu = copy.deepcopy(mods).to(cuda)
    counts = (fused_mlp.launches, fused_ray_march.launches)
    out = render_rays(gpu, uv.to(cuda), eye.to(cuda), intr.to(cuda), 0.0,
                      4.0, taps.to(cuda), statics,
                      **{k: v.to(cuda) for k, v in draws.items()})
    torch.cuda.synchronize()
    assert (fused_mlp.launches - counts[0],
            fused_ray_march.launches - counts[1]) == (3, 2)
    np.testing.assert_array_equal(out["argmax_coarse"].cpu().numpy(),
                                  ref["argmax_coarse"].numpy())
    for k in ("rgb", "depth", "weights", "z_vals", "normals"):
        np.testing.assert_allclose(out[k].cpu().numpy(), ref[k].numpy(),
                                   err_msg=k, rtol=1e-4, atol=1e-4)
