"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and nvcc: without one it skips, decided
inside the ``cuda`` fixture. The file imports no jax, so on the card it runs
without the repository's conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

TF32 is off; tolerance rtol 1e-4 / atol 1e-5 on f32 outputs, whose sums the
kernels take in another order than cuBLAS and PyTorch's reductions.
"""

import copy
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vf_nerf_torch.config import schema
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           draw_uniforms, render_rays)
from vf_nerf_torch.ops.density import DensityParams
from vf_nerf_torch.ops.fused_mlp import (_launch, acts_shape, blocks_of_128,
                                         fused_mlp, hidden_views,
                                         mlp_reference)
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
    ([295, 256, 259], None, "none", 77),
])
def test_fused_mlp_kernel(cuda, dims, skip_at, act, n):
    _check_fused_mlp(cuda, dims, skip_at, act, n)


VF_DIMS = [39, 256, 256, 256, 217, 256, 256, 256, 256, 259]
COLOUR_DIMS = [289, 256, 256, 256, 256, 3]


@pytest.mark.parametrize("n", [1, 127, 128, 129, 3001])
@pytest.mark.parametrize("net", ["vf", "colour"])
def test_fused_mlp_kernel_around_the_point_tile(cuda, net, n):
    """Point counts around the kernel's 128-point tile (3001 is a multiple
    of neither 64 nor 128), at the shipped VF widths (skip at layer 4) and
    with the 3-wide colour head."""
    if net == "vf":
        _check_fused_mlp(cuda, VF_DIMS, 4, "tanh", n)
    else:
        _check_fused_mlp(cuda, COLOUR_DIMS, None, "sigmoid", n)


def _check_fused_mlp(cuda, dims, skip_at, act, n):
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
    """Strided inputs are refused, and so are layer inputs wider than 296
    and hidden layers wider than 256; the skip layer's 295 inputs (a
    256-wide layer plus the 39-wide input) run."""
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights([39, 64, 3], None, 0)]
    x = torch.zeros((8, 78), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp(weights, x)
    for dims in ([39, 512, 3], [300, 64, 3], [39, 257, 3]):
        wide = [(w.to(cuda), b.to(cuda))
                for w, b in _mlp_weights(dims, None, 0)]
        with pytest.raises(ValueError, match="widths up to"):
            fused_mlp(wide, torch.zeros((8, dims[0]), device=cuda))
    _check_fused_mlp(cuda, [39, 256, 256, 3], 2, "tanh", 200)


def _kernels_per_call(fn):
    """CUDA kernels that one call of ``fn`` enqueues, by torch.profiler.
    A trace that recorded no CUDA event at all (the profiler now and then
    drops a lone short kernel's record) is taken again, up to 3 times; any
    other count is returned as it is."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        count = sum(e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if count:
            break
    return count


def test_each_wrapper_call_enqueues_one_kernel(cuda):
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights(VF_DIMS, 4, 0)]
    x = torch.rand((1000, 39), device=cuda)
    assert _kernels_per_call(
        lambda: fused_mlp(weights, x, skip_at=4, final_act="tanh")) == 1
    inputs = [a.to(cuda) for a in _march_inputs(64, 130)]
    params = DensityParams(*(torch.tensor(v, device=cuda)
                             for v in (0.5, 100.0, 0.7)))
    taps = torch.full((11,), 0.09, device=cuda)
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-2.0, normalize=True)
    for rgb in (inputs[3], None):
        assert _kernels_per_call(lambda: fused_ray_march(
            *inputs[:3], rgb, params, taps, **kw)) == 1


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


@pytest.mark.parametrize("raw,beta_bounds", [
    ((0.01, -80.0, 0.2), (0.3, 1e9)),    # beta and mean below, scale < 0
    ((5.0, 0.5, 1.7), (1e-4, 2.0)),      # beta and mean above, |scale| < 1
])
def test_fused_ray_march_clamps_raw_parameters(cuda, raw, beta_bounds):
    """The kernel's prologue clamps the raw density parameters as the plain
    version's get_beta / get_scale / get_mean do."""
    inputs = _march_inputs(64, 130, seed=2)
    kw = dict(beta_bounds=beta_bounds, scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-0.2, normalize=True)
    taps = torch.full((11,), 0.09)
    ref = ray_march_reference(*inputs, DensityParams(
        *(torch.tensor(v) for v in raw)), taps, **kw)
    out = fused_ray_march(*(a.to(cuda) for a in inputs), DensityParams(
        *(torch.tensor(v, device=cuda) for v in raw)), taps.to(cuda), **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(out, ref, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("n_samples", [100, 130])
def test_fused_ray_march_weights_only(cuda, n_samples):
    """With no rgb samples the kernel writes the weights alone, equal to
    the plain version's weights with zero rgb."""
    normals, dirs, z, rgb = _march_inputs(1024, n_samples, seed=4)
    params = DensityParams(*(torch.tensor(v) for v in (0.5, 100.0, 0.7)))
    taps = torch.full((11,), 1.0 / 11)
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-2.0, normalize=True)
    _, _, ref = ray_march_reference(normals, dirs, z, torch.zeros_like(rgb),
                                    params, taps, **kw)
    rgb_out, depth_out, weights = fused_ray_march(
        normals.to(cuda), dirs.to(cuda), z.to(cuda), None,
        DensityParams(*(v.to(cuda) for v in params)), taps.to(cuda), **kw)
    torch.cuda.synchronize()
    assert rgb_out is None and depth_out is None
    np.testing.assert_allclose(weights.cpu().numpy(), ref.numpy(), **TOL)


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


# ---- training: the MLP's save mode and gradient, the march's backward ----

def _max_rel(a, b):
    """max |a - b| / max |b|, on the CPU."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dims,skip_at,act,n", [
    (VF_DIMS, 4, "tanh", 3001),
    (COLOUR_DIMS, None, "sigmoid", 1001),
    ([39, 64, 64, 64, 32], 2, "none", 129),
])
def test_fused_mlp_save_mode_and_gradient(cuda, dims, skip_at, act, n):
    """With a gradient the kernel also saves the hidden activations: its
    output equals the no-save launch bit for bit, the saved activations
    equal the plain forward's, and FusedMLP's gradients (to x, each kernel
    and bias) equal autograd through mlp_reference on the card within
    1e-4·max|g| per tensor. A pre-activation within the kernel's rounding
    of 0 flips its ReLU against the plain chain's and changes that point's
    gradients, so the upstream gradient is zero on the (< 1 %) points whose
    ReLU masks differ."""
    weights = [(w.to(cuda).requires_grad_(True), b.to(cuda).requires_grad_(
        True)) for w, b in _mlp_weights(dims, skip_at, seed=n)]
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (n, dims[0])).astype(np.float32)).to(cuda).requires_grad_(True)
    flat = [t for wb in weights for t in wb]
    with torch.no_grad():
        plain_out = fused_mlp(weights, x, skip_at=skip_at, final_act=act)
    before = fused_mlp.launches
    out = fused_mlp(weights, x, skip_at=skip_at, final_act=act)
    assert fused_mlp.launches == before + 1
    assert out.grad_fn is not None and "FusedMLP" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), plain_out)
    acts = torch.cat(hidden_views(out.grad_fn.saved_tensors[1], weights), 1)
    hidden = _plain_hidden([(w.detach(), b.detach()) for w, b in weights],
                           x.detach(), skip_at)
    assert _max_rel(acts, hidden) < 1e-5
    same = ((acts > 0) == (hidden > 0)).all(1)
    assert float(same.float().mean()) >= 0.99
    dy = torch.from_numpy(np.random.RandomState(2).randn(
        n, dims[-1]).astype(np.float32)).to(cuda) * same[:, None]
    got = torch.autograd.grad(out, [x] + flat, dy)
    ref = torch.autograd.grad(mlp_reference(weights, x, skip_at, act),
                              [x] + flat, dy)
    for g, r in zip(got, ref):
        assert _max_rel(g, r) < 1e-4


@pytest.mark.parametrize("n", [129, 3001])
def test_fused_mlp_input_gradient_alone(cuda, n):
    """The joint stage's pose-only epochs ask FusedMLP for the VF net's
    input gradient alone (the weights take none): one save-mode launch,
    dx equal to autograd through mlp_reference within 1e-4·max|g|, and no
    weight gradient computed."""
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights(VF_DIMS, 4, seed=n)]
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (n, VF_DIMS[0])).astype(np.float32)).to(cuda).requires_grad_(
            True)
    before = fused_mlp.launches
    out = fused_mlp(weights, x, skip_at=4, final_act="tanh")
    assert fused_mlp.launches == before + 1
    assert "FusedMLP" in type(out.grad_fn).__name__
    acts = torch.cat(hidden_views(out.grad_fn.saved_tensors[1], weights), 1)
    same = ((acts > 0) == (_plain_hidden(weights, x.detach(), 4) > 0)).all(1)
    dy = torch.from_numpy(np.random.RandomState(4).randn(
        n, VF_DIMS[-1]).astype(np.float32)).to(cuda) * same[:, None]
    (got,) = torch.autograd.grad(out, [x], dy)
    (ref,) = torch.autograd.grad(mlp_reference(weights, x, 4, "tanh"), [x],
                                 dy)
    assert _max_rel(got, ref) < 1e-4


def _plain_hidden(weights, x, skip_at):
    """The plain forward's hidden outputs, side by side."""
    h, hidden = x, []
    for i, (w, b) in enumerate(weights[:-1]):
        if i == skip_at:
            h = torch.cat([h, x], 1) / 2 ** 0.5
        h = torch.relu(h @ w + b)
        hidden.append(h)
    return torch.cat(hidden, 1)


@pytest.mark.parametrize("schedule", ["all128", "all64", "mixed"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 100, 127, 129, 20480, 204800])
@pytest.mark.parametrize("net", ["vf", "colour"])
def test_fused_mlp_tile_schedules(cuda, net, n, schedule):
    """Every block a 128-point one, every block a 64-point split one (the
    outputs split between the consumer warpgroups), and the wrapper's mix of
    both, at point counts around both tiles (65, 100 and 127 end a 128-point
    block inside its second consumer's rows), at the training step's 20,480
    shell points (132 blocks of 128 and 56 of 64) and at the render's 204,800
    fine points: the no-save launch against the plain version, the
    save-mode output equal to it bit for bit, and the saved activations (one
    bulk copy per consumer and layer into the layer-major layout) equal to
    the plain forward's."""
    dims, skip_at, act = (VF_DIMS, 4, "tanh") if net == "vf" else \
        (COLOUR_DIMS, None, "sigmoid")
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights(dims, skip_at, seed=n)]
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (n, dims[0])).astype(np.float32)).to(cuda)
    ref = mlp_reference(weights, x, skip_at, act)
    blocks128 = {"all128": -(-n // 128), "all64": 0, "mixed": None}[schedule]
    out, none = _launch(weights, x, skip_at, act, save=False,
                        blocks128=blocks128)
    assert none is None
    saved_out, acts = _launch(weights, x, skip_at, act, save=True,
                              blocks128=blocks128)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert torch.equal(saved_out, out)
    assert acts.shape == acts_shape(weights, n)
    assert _max_rel(torch.cat(hidden_views(acts, weights), 1),
                    _plain_hidden(weights, x, skip_at)) < 1e-5


def test_fused_mlp_wrapper_mixes_the_tiles_on_this_card(cuda):
    """On an H100's 132 SMs the shell launch's 20,480 points take one round
    of 128-point blocks and the rest in split blocks, and the render's
    133,120 points stay all 128."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms != 132:
        pytest.skip(f"the choice is pinned for 132 SMs; this card has {sms}")
    assert [blocks_of_128(n, sms) for n in (20480, 102400, 133120, 204800)] \
        == [132, 792, 1040, 1584]


def _march_grad_case(cuda, n_rays, n_samples, n_valid, white, normalize,
                     params, beta_bounds=(1e-4, 1e9), weights_grad=False,
                     weights_only=False, seed=0):
    """ray_march_backward against autograd through ray_march_reference on
    the card; returns the max relative errors."""
    from vf_nerf_torch.ops.ray_march import (MarchStatics, ray_march_backward,
                                             ray_march_backward_reference)
    normals, dirs, z, rgb = (a.to(cuda) for a in
                             _march_inputs(n_rays, n_samples, seed))
    taps = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08, 0.04,
                         0.02, 0.01], device=cuda)
    st = MarchStatics(beta_bounds, 1.0, (0.6, 1.0), -0.5, -0.2, normalize,
                      white, n_valid)
    scalars = torch.tensor(params, device=cuda)
    rng = np.random.RandomState(seed + 1)
    g_rgb = None if weights_only else torch.from_numpy(
        rng.randn(n_rays, 3).astype(np.float32)).to(cuda)
    g_depth = None if weights_only else torch.from_numpy(
        rng.randn(n_rays).astype(np.float32)).to(cuda)
    g_w = torch.from_numpy(rng.randn(n_rays, n_samples).astype(
        np.float32)).to(cuda) if weights_grad or weights_only else None
    c = None if weights_only else rgb
    before = ray_march_backward.launches
    got = ray_march_backward(normals, dirs, z, c, scalars, taps, st, g_rgb,
                             g_depth, g_w)
    torch.cuda.synchronize()
    assert ray_march_backward.launches == before + 1
    ref = ray_march_backward_reference(normals, dirs, z, c, scalars, taps, st,
                                       g_rgb, g_depth, g_w)
    got = (got[0], got[1], got[2].sum(0))
    out = {}
    for name, a, b in zip(("normals", "rgb", "scalars"), got, ref):
        if b is None:
            assert a is None
            continue
        assert bool(torch.isfinite(a).all())
        out[name] = _max_rel(a, b)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4,
                                   atol=1e-5 * max(float(b.abs().max()), 1.0),
                                   err_msg=name)
    return out


@pytest.mark.parametrize("n_samples,n_valid,white,normalize", [
    (200, 130, False, True),
    (200, 200, False, True),
    (200, 130, True, True),
    (130, 60, False, False),
    (40, 3, False, True),
    (9, 9, True, True),
    (26, 26, False, True),
    (26, 20, True, True),
    (1024, 1024, False, True),
    (1024, 700, True, True),
    (1, 1, False, True),
])
def test_ray_march_backward_kernel(cuda, n_samples, n_valid, white,
                                   normalize):
    _march_grad_case(cuda, 64, n_samples, n_valid, white, normalize,
                     (0.5, 100.0, 0.7))


@pytest.mark.parametrize("params,beta_bounds", [
    ((0.3, 1.0, 0.6), (0.3, 1e9)),      # beta and mean at their clamps
    ((0.2, 50.0, 0.9), (1e-4, 1e9)),
])
def test_ray_march_backward_at_clamp_edges(cuda, params, beta_bounds):
    _march_grad_case(cuda, 64, 200, 130, False, True, params, beta_bounds,
                     weights_grad=True, seed=3)


def test_ray_march_backward_weights_only(cuda):
    _march_grad_case(cuda, 32, 100, 100, False, True, (0.5, 100.0, 0.7),
                     weights_only=True, seed=5)


def test_fused_ray_march_grad_path_launches_both_kernels(cuda):
    """A march with gradients runs one forward kernel, and its backward one
    backward kernel (one CUDA kernel per call, by the profiler); the
    gradients reach the raw density parameters through the clamps."""
    from vf_nerf_torch.ops.ray_march import ray_march_backward
    normals, dirs, z, rgb = (a.to(cuda) for a in _march_inputs(128, 200))
    normals.requires_grad_(True)
    rgb.requires_grad_(True)
    params = DensityParams(*(torch.tensor(v, device=cuda, requires_grad=True)
                             for v in (0.5, 100.0, 0.7)))
    taps = torch.full((11,), 1.0 / 11, device=cuda)
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-2.0, normalize=True,
              n_valid=130)
    counts = (fused_ray_march.launches, ray_march_backward.launches)
    out = fused_ray_march(normals, dirs, z, rgb, params, taps, **kw)
    loss = out[0].sum() + out[1].sum()
    got = torch.autograd.grad(loss, [normals, rgb, *params])
    torch.cuda.synchronize()
    assert (fused_ray_march.launches - counts[0],
            ray_march_backward.launches - counts[1]) == (1, 1)
    ref_out = ray_march_reference(normals, dirs, z, rgb, params, taps, **kw)
    ref = torch.autograd.grad(ref_out[0].sum() + ref_out[1].sum(),
                              [normals, rgb, *params])
    for g, r in zip(got, ref):
        assert _max_rel(g, r) < 1e-4
    from vf_nerf_torch.ops.ray_march import MarchStatics
    st = MarchStatics((1e-4, 1e9), 1.0, (0.6, 1.0), -0.5, -2.0, True, False,
                      130)
    g_rgb = torch.ones((128, 3), device=cuda)
    g_depth = torch.ones((128,), device=cuda)
    scalars = torch.tensor([0.5, 100.0, 0.7], device=cuda)
    assert _kernels_per_call(lambda: ray_march_backward(
        normals.detach(), dirs, z, rgb.detach(), scalars, taps, st, g_rgb,
        g_depth, None)) == 1


def test_train_step_on_card_matches_cpu(cuda):
    """The tiny config with static fine growth on the card: the loss and
    its gradients equal the CPU plain path's from the same weights and
    draws (loss rtol 1e-4, gradients 1e-3·max|g| per tensor: 3xTF32 MLP
    products, sums in another order), and each of two train steps launches
    5 fused MLPs, 2 marches and 1 march backward."""
    from vf_nerf_torch.models.nerf import make_optimizer, param_groups
    from vf_nerf_torch.ops.ray_march import ray_march_backward
    from vf_nerf_torch.parallel import train_step as ts
    cfg = _tiny_config()
    cfg.ray_sampler_config.max_samples = 16
    mods = VFNerfModules(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in mods.vf.layers:
            (layer[0] if isinstance(layer, torch.nn.Sequential)
             else layer).weight.mul_(2.5)
    mods = mods.eval()
    statics = RenderStatics.from_config(cfg, n_fine=16, train=False)
    n = 64
    sup = ts.SupervisionStatics.from_config(
        cfg, "exterior_synthetic", n, statics.n_coarse + statics.n_fine,
        0.15)
    weights = schema.VFLossWeights(rgb=2.0, depth=0.5, unit_norm=0.1,
                                   supervision=1.0, norm_smaller_than_one=0.1,
                                   directional_derivatives=0.0)
    loss_cfg = schema.VFLossConfig(norm_smaller_than_one_start=11000,
                                   depth_loss_clamp=0.5)
    rng = np.random.RandomState(0)
    eye = torch.eye(4).expand(n, 4, 4).contiguous()
    intr = eye.clone()
    intr[:, 0, 0] = intr[:, 1, 1] = 30.0
    intr[:, 0, 2], intr[:, 1, 2] = 20.0, 15.0
    batch = {"uv": torch.from_numpy(rng.uniform(0, 40, (n, 2)).astype(
        np.float32)), "pose": eye, "intrinsics": intr,
        "rgb": torch.from_numpy(rng.rand(n, 3).astype(np.float32)),
        "depth": torch.from_numpy(rng.uniform(1, 3, (n, 1)).astype(
            np.float32))}
    draws = ts.draw_step(statics, sup, n, torch.Generator().manual_seed(4),
                         "cpu")
    gpu = copy.deepcopy(mods).to(cuda)
    results = []
    for m, dev in ((mods, "cpu"), (gpu, cuda)):
        loss_fn = ts.make_loss_fn(m, statics, sup, weights, loss_cfg)
        total, _, _ = loss_fn(
            {k: v.to(dev) for k, v in batch.items()},
            {k: v.to(dev) for k, v in draws.items()}, 0,
            torch.tensor(cfg.cos_sim_weights, device=dev), 0.0, 4.0,
            torch.zeros(3, device=dev), 6,
            (n * (statics.n_coarse + 6)) // 10)
        grads = torch.autograd.grad(total, list(m.parameters()))
        results.append((float(total.detach()), grads))
    (cpu_loss, cpu_grads), (loss, grads) = results
    np.testing.assert_allclose(loss, cpu_loss, rtol=1e-4)
    for g, r in zip(grads, cpu_grads):
        assert _max_rel(g, r) <= 1e-3

    opt, _ = make_optimizer(cfg.scheduler_config, 100, duplicate_vf=True)
    opt.init(param_groups(gpu))
    step = ts.make_train_step(gpu, opt, statics, sup, weights, loss_cfg)
    gen = torch.Generator(device=cuda).manual_seed(4)
    for _ in range(2):
        before = (fused_mlp.launches, fused_ray_march.launches,
                  ray_march_backward.launches)
        sums = step(ts.zero_metric_sums(cuda),
                    {k: v.to(cuda) for k, v in batch.items()}, 0,
                    torch.tensor(cfg.cos_sim_weights, device=cuda), 0.0, 4.0,
                    torch.zeros(3, device=cuda), n_fine_active=6,
                    generator=gen)
        torch.cuda.synchronize()
        assert (fused_mlp.launches - before[0],
                fused_ray_march.launches - before[1],
                ray_march_backward.launches - before[2]) == (5, 2, 1)
        assert np.isfinite(float(sums["loss"]))
    assert opt.count == 2


# (conf changes, launches per step: fused MLP, march, march backward)
TRAIN_MODES = {
    "analytic_dd": (dict(dd=True), (0, 2, 1)),
    "numerical_dd": (dict(dd=True, numerical=True), (11, 2, 1)),
    "weight_norm": (dict(weight_norm=True), (5, 2, 1)),
    "nerf": (dict(rendering="nerf"), (5, 0, 0)),
}


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_train_modes_on_card_match_cpu(cuda, mode):
    """The unfolded training modes on 64 rays of the tiny config: the loss
    and every gradient on the card against the CPU plain path from the same
    weights and draws (loss rtol 1e-4 and gradients 1e-3·max|g|, as
    ``test_train_step_on_card_matches_cpu``; the numerical Jacobian
    multiplies each f32 rounding by 5e4, so there against float64 within
    twice the CPU float32 path's own distance; gradients that are zero in
    exact arithmetic, the biases before a train-mode BatchNorm, within
    1e-6 of the largest), the running statistics of a train-mode step, and
    each of two steps' launches."""
    from vf_nerf_torch.models.nerf import make_optimizer, param_groups
    from vf_nerf_torch.ops.ray_march import ray_march_backward
    from vf_nerf_torch.parallel import train_step as ts
    changes, expected = TRAIN_MODES[mode]
    dd = changes.get("dd", False)
    cfg = _tiny_config()
    cfg.numerical_jacobian = changes.get("numerical", False)
    cfg.rendering = changes.get("rendering", "volsdf")
    cfg.vf_net_config.weight_norm = changes.get("weight_norm", False)
    cfg.rendering_net_config.weight_norm = changes.get("weight_norm", False)
    mods = VFNerfModules(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in mods.vf.layers:
            dense = layer[0] if isinstance(layer, torch.nn.Sequential) \
                else layer
            (dense.weight_g if cfg.vf_net_config.weight_norm
             else dense.weight).mul_(2.5)
    mods.train(dd and not cfg.numerical_jacobian)
    n_fine = 6 if dd else 16
    statics = RenderStatics.from_config(cfg, n_fine=n_fine,
                                        train=mods.training,
                                        compute_dir_derivatives=dd)
    fine = {} if dd else {"n_fine_active": 6}
    n = 64
    sup = ts.SupervisionStatics.from_config(
        cfg, "exterior_synthetic", n, statics.n_coarse + statics.n_fine,
        0.15)
    weights = schema.VFLossWeights(rgb=2.0, depth=0.5, unit_norm=0.1,
                                   supervision=1.0, norm_smaller_than_one=0.1,
                                   directional_derivatives=0.1 if dd else 0)
    loss_cfg = schema.VFLossConfig(norm_smaller_than_one_start=11000,
                                   depth_loss_clamp=0.5,
                                   directional_derivatives_start=0)
    rng = np.random.RandomState(0)
    eye = torch.eye(4).expand(n, 4, 4).contiguous()
    intr = eye.clone()
    intr[:, 0, 0] = intr[:, 1, 1] = 30.0
    intr[:, 0, 2], intr[:, 1, 2] = 20.0, 15.0
    batch = {"uv": torch.from_numpy(rng.uniform(0, 40, (n, 2)).astype(
        np.float32)), "pose": eye, "intrinsics": intr,
        "rgb": torch.from_numpy(rng.rand(n, 3).astype(np.float32)),
        "depth": torch.from_numpy(rng.uniform(1, 3, (n, 1)).astype(
            np.float32))}
    draws = ts.draw_step(statics, sup, n, torch.Generator().manual_seed(4),
                         "cpu")
    gpu = copy.deepcopy(mods).to(cuda)
    results = []
    n_points = None if dd else (n * (statics.n_coarse + 6)) // 10
    for m, dev, dt in ((mods, "cpu", torch.float32), (gpu, cuda,
                                                      torch.float32),
                       (copy.deepcopy(mods).double(), "cpu",
                        torch.float64)):
        loss_fn = ts.make_loss_fn(m, statics, sup, weights, loss_cfg)
        total, _, out = loss_fn(
            {k: v.to(dev, dt) for k, v in batch.items()},
            {k: v.to(dev, dt) for k, v in draws.items()}, 0,
            torch.tensor(cfg.cos_sim_weights, device=dev, dtype=dt), 0.0,
            4.0, torch.zeros(3, device=dev, dtype=dt),
            fine.get("n_fine_active"), n_points)
        grads = torch.autograd.grad(total, list(m.parameters()))
        stats = [v for upd in out.get("batch_stats_updates", {}).values()
                 for v in upd.values()]
        results.append((float(total.detach()), grads, stats))
    (cpu_loss, cpu_grads, cpu_stats), (loss, grads, stats), \
        (f64_loss, f64_grads, _) = results
    numerical = dd and cfg.numerical_jacobian
    if numerical:
        assert abs(loss - f64_loss) <= 2 * abs(cpu_loss - f64_loss) or \
            abs(loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    else:
        np.testing.assert_allclose(loss, cpu_loss, rtol=1e-4)
    largest = max(float(g.abs().max()) for g in f64_grads)
    for g, c, r in zip(grads, cpu_grads, f64_grads):
        if float(r.abs().max()) <= 1e-12 * largest:
            assert float(g.abs().max()) <= 1e-6 * largest
        elif numerical:
            assert _max_rel(g, r.float()) <= max(1e-3, 2 * _max_rel(
                c, r.float()))
        else:
            assert _max_rel(g, c) <= 1e-3
    assert len(stats) == len(cpu_stats) == (10 if mods.training else 0)
    for a, b in zip(stats, cpu_stats):
        assert _max_rel(a, b) <= 1e-5

    opt, _ = make_optimizer(cfg.scheduler_config, 100, duplicate_vf=True)
    opt.init(param_groups(gpu))
    step = ts.make_train_step(gpu, opt, statics, sup, weights, loss_cfg)
    gen = torch.Generator(device=cuda).manual_seed(4)
    for _ in range(2):
        before = (fused_mlp.launches, fused_ray_march.launches,
                  ray_march_backward.launches)
        sums = step(ts.zero_metric_sums(cuda),
                    {k: v.to(cuda) for k, v in batch.items()}, 0,
                    torch.tensor(cfg.cos_sim_weights, device=cuda), 0.0, 4.0,
                    torch.zeros(3, device=cuda), generator=gen, **fine)
        torch.cuda.synchronize()
        assert (fused_mlp.launches - before[0],
                fused_ray_march.launches - before[1],
                ray_march_backward.launches - before[2]) == expected
        assert np.isfinite(float(sums["loss"]))
    assert opt.count == 2


# ------------------------------------------------------------ mesh stack

def _box_field(half=1.0):
    """The analytic box field (``tests/test_mesh_stack.py``) in torch."""
    def fn(p):
        dist = half - p.abs()
        inside = (dist > 0).all(-1)
        axis = dist.argmin(-1)
        rows = torch.arange(p.shape[0], device=p.device)
        sign = torch.sign(p[rows, axis])
        sign = torch.where(sign == 0, 1.0, sign)
        v_in = torch.zeros_like(p)
        v_in[rows, axis] = sign
        closest = p.clamp(-half, half)
        delta = closest - p
        v_out = delta / torch.clamp(torch.linalg.vector_norm(
            delta, dim=-1, keepdim=True), min=1e-8)
        v = torch.where(inside[:, None], v_in, v_out)
        udf = torch.where(dist.amin(-1) > 0, dist.amin(-1),
                          torch.linalg.vector_norm(p - closest, dim=-1))
        return v * torch.clamp(udf, min=1e-4)[:, None]
    return fn


def _near_identical(ours, ref, voxel):
    """The near-identity rule: vertex counts within 2 %, median
    nearest-neighbour distance < 1e-5, max < 2 voxels."""
    from scipy.spatial import cKDTree
    assert len(ours[0]) > 0 and len(ref[0]) > 0
    assert abs(len(ours[0]) - len(ref[0])) <= 0.02 * len(ref[0])
    d = cKDTree(ref[0]).query(ours[0], k=1)[0]
    assert np.median(d) < 1e-5 and d.max() < 2 * voxel


def test_grid_points_on_card_equal_cpu(cuda):
    """The grid points are float64 arithmetic rounded once: bit for bit."""
    from vf_nerf_torch.evaluation.mc.device_pipeline import grid_points
    off = torch.tensor([0.55, -0.55, 0.55])
    idx = torch.cat([torch.arange(100_000),
                     torch.arange(256 ** 3 - 100_000, 256 ** 3)])
    ref = grid_points(256, 1.1, off, idx)
    got = grid_points(256, 1.1, off.to(cuda), idx.to(cuda))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("smooth", [dict(), dict(smooth_before=True),
                                    dict(smooth_after=True)])
def test_mesh_extractor_on_card_matches_cpu(cuda, smooth):
    from vf_nerf_torch.evaluation.mc.device_pipeline import \
        DeviceMeshExtractor
    meshes = []
    for device in (cuda, "cpu"):
        extractor = DeviceMeshExtractor(_box_field(1.0), 48, device=device,
                                        chunk=30_000, **smooth)
        meshes.append(extractor.extract(1.5, np.zeros(3),
                                        np.zeros(3, np.float32)))
    _near_identical(meshes[0], meshes[1], 2 * 1.5 / 47)


def test_mesh_classification_with_ties_on_card_equals_cpu(cuda):
    """Constant cells, antipodal corners and axis vectors give exact ties;
    the card breaks them as the CPU does (first maximum)."""
    from vf_nerf_torch.evaluation.mc.device_pipeline import (
        cell_signed_values, normalize_grid)
    g = np.random.RandomState(5).randn(14, 14, 14, 3).astype(np.float32)
    g[2:6, 2:6, 2:6] = np.array([0.0, 2.0, 0.0], np.float32)
    g[7:9, 7:9, 7:9] = np.array([1.0, 0.0, 0.0], np.float32)
    g[8, 7:9, 7:9] = np.array([-1.0, 0.0, 0.0], np.float32)
    g[9:13, 1:5, 8:12] = np.eye(3, dtype=np.float32)[
        np.indices((4, 4, 4)).sum(0) % 3]
    cells = torch.from_numpy(np.argwhere(np.ones((13, 13, 13), bool)))
    vt, norms = normalize_grid(torch.from_numpy(g))
    ref = cell_signed_values(vt, norms, cells)
    got = cell_signed_values(vt.to(cuda), norms.to(cuda), cells.to(cuda))
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_fused_mlp_at_the_grid_chunk(cuda):
    """The shipped VF widths at the mesh grid's chunk (1 << 20 points, the
    (N, 259) output's index past 2^28) against the plain version on the
    card; the extractor's field call is one launch per chunk."""
    from vf_nerf_torch.evaluation.mc.device_pipeline import (GRID_CHUNK,
                                                             grid_points)
    from vf_nerf_torch.ops.embedding import positional_encoding
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights(VF_DIMS, 4, seed=7)]
    pts = grid_points(256, 1.1, torch.zeros(3, device=cuda),
                      torch.arange(GRID_CHUNK, device=cuda))
    x = positional_encoding(pts, 6).contiguous()
    before = fused_mlp.launches
    out = fused_mlp(weights, x, skip_at=4, final_act="tanh")
    ref = mlp_reference(weights, x, 4, "tanh")
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


# ---- data parallel: the eval render and the octant spread over two slots

def test_eval_spread_over_two_slots_of_the_card_is_bit_equal(cuda):
    """``enable_mesh_eval([cuda, cuda])``: a 64-ray render (perturb on) and
    a res-24 × 8 quadrant extraction split over two slots of the card, each
    on its own stream and thread, equal one slot bit for bit."""
    from vf_nerf_torch.evaluation.mc.device_pipeline import \
        DeviceMeshExtractor
    from vf_nerf_torch.evaluation.mc.pipeline import quadrant_translations
    from vf_nerf_torch.models.nerf import VectorFieldNerf

    def model(slots=None):
        m = VectorFieldNerf(_tiny_config(), seed=3, device=cuda)
        with torch.no_grad():
            for layer in m.modules.vf.layers:
                (layer[0] if isinstance(layer, torch.nn.Sequential)
                 else layer).weight.mul_(3.0)
        m.near, m.far = 0.0, 4.0
        if slots:
            m.enable_mesh_eval(slots)
        return m

    n = 64
    rng = np.random.RandomState(0)
    uv = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr = pose.copy()
    intr[:, 0, 0] = intr[:, 1, 1] = 30.0
    intr[:, 0, 2], intr[:, 1, 2] = 20.0, 15.0
    single, spread = model(), model([cuda, cuda])
    a = single.render(pose, uv, intr, epoch=0)
    b = spread.render(pose, uv, intr, epoch=0)
    for k in ("rgb", "depth", "weights", "z_vals", "normals"):
        assert torch.equal(a[k], b[k]), k
    extractor = DeviceMeshExtractor(spread.get_vector_field, 24,
                                    device=cuda)
    octants = list(quadrant_translations(8, 2.0))
    one = extractor.extract_many(octants, np.zeros(3, np.float32))
    two = extractor.extract_many(octants, np.zeros(3, np.float32),
                                 devices=spread.eval_devices)
    assert sum(len(f) for _, f in one) > 0
    for (v1, f1), (v2, f2) in zip(one, two, strict=True):
        assert np.array_equal(v1, v2) and np.array_equal(f1, f2)


def test_eval_spread_over_the_card_and_the_cpu_uses_a_synced_replica(cuda):
    """``enable_mesh_eval([cuda, cpu])``, the path of two distinct devices:
    the CPU slot holds a replica of the modules, which a weight change made
    afterwards reaches through the render's ``sync_replicas``. The card's
    rays and octants equal one device's bit for bit; the CPU's rays are
    held as ``test_render_rays_on_card_matches_cpu`` holds the plain path
    and its octants by the near-identity rule."""
    from vf_nerf_torch.evaluation.mc.device_pipeline import \
        DeviceMeshExtractor
    from vf_nerf_torch.evaluation.mc.pipeline import quadrant_translations
    from vf_nerf_torch.models.nerf import VectorFieldNerf

    def model(slots=None):
        m = VectorFieldNerf(_tiny_config(), seed=3, device=cuda)
        with torch.no_grad():
            for layer in m.modules.vf.layers:
                (layer[0] if isinstance(layer, torch.nn.Sequential)
                 else layer).weight.mul_(3.0)
        m.near, m.far = 0.0, 4.0
        if slots:
            m.enable_mesh_eval(slots)
        return m

    cpu = torch.device("cpu")
    slots = [torch.device("cuda", torch.cuda.current_device()), cpu]
    single, spread = model(), model(slots)
    assert list(spread._replicas) == [cpu]
    replica = spread._replicas[cpu]
    name = "vf.layers.0.0.weight"
    with torch.no_grad():
        for m in (single, spread):
            dict(m.modules.named_parameters())[name].mul_(1.001)
    assert not torch.equal(replica.state_dict()[name],
                           spread.modules.state_dict()[name].cpu())
    n = 64
    rng = np.random.RandomState(0)
    uv = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr = pose.copy()
    intr[:, 0, 0] = intr[:, 1, 1] = 30.0
    intr[:, 0, 2], intr[:, 1, 2] = 20.0, 15.0
    a = single.render(pose, uv, intr, epoch=0)
    b = spread.render(pose, uv, intr, epoch=0)
    for k, v in spread.modules.state_dict().items():
        assert torch.equal(v.cpu(), replica.state_dict()[k]), k
    half = n // 2
    np.testing.assert_array_equal(b["argmax_coarse"][half:].cpu().numpy(),
                                  a["argmax_coarse"][half:].cpu().numpy())
    for k in ("rgb", "depth", "weights", "z_vals", "normals"):
        assert torch.equal(a[k][:half], b[k][:half]), k
        np.testing.assert_allclose(b[k][half:].cpu().numpy(),
                                   a[k][half:].cpu().numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-4)
    res = 24
    extractor = DeviceMeshExtractor(spread.get_vector_field, res,
                                    device=cuda)
    octants = list(quadrant_translations(8, 2.0))
    one = extractor.extract_many(octants, np.zeros(3, np.float32))
    two = extractor.extract_many(octants, np.zeros(3, np.float32),
                                 devices=spread.eval_devices)
    for k, (_, sub_scale) in enumerate(octants):
        if k % 2 == 0:
            assert np.array_equal(one[k][0], two[k][0]) and \
                np.array_equal(one[k][1], two[k][1]), k
        elif len(one[k][0]) or len(two[k][0]):
            _near_identical(two[k], one[k], 2 * sub_scale / (res - 1))
    assert sum(len(f) for _, f in two[1::2]) > 0


def test_launch_counts_hold_under_threads(cuda):
    """The device slots launch from threads at once: 16 threads x 40 calls
    of the fused MLP with a 1 µs switch interval count 640 launches."""
    import sys
    import threading
    weights = [(w.to(cuda), b.to(cuda))
               for w, b in _mlp_weights([7, 5, 3], None, 0)]
    x = torch.randn(65, 7, device=cuda)
    start = fused_mlp.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            fused_mlp(weights, x, skip_at=None, final_act="tanh")
            for _ in range(40)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert fused_mlp.launches - start == 640


def test_span_lines_up_with_the_kernel_it_launches(cuda):
    """A ``profiling.span`` around a ``torch.cuda._sleep`` launch on an idle
    card, under the benchmark's CUDA-only ``torch.profiler`` window: the
    kernel starts after the span opens and within 1 ms of it, on the clock
    ``benchmark/spans.py`` rebuilds."""
    from benchmark import spans as bench_spans
    from benchmark.trace import profile
    from vf_nerf_torch.utils import profiling
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()

    def launch():
        with profiling.span("launch"):
            torch.cuda._sleep(1_000_000)
        return 1

    traced = profile(launch, "step", {})
    recorded = profiling.spans()
    (opened,) = [s[2] for s in recorded if s[0] == "launch"]
    base = bench_spans.trace_base_ns(traced, recorded)
    assert base is not None
    (kernel,) = traced.kernels
    after_us = kernel[2] - (opened - base) / 1e3
    assert 0.0 <= after_us <= 1e3, after_us


# -------------------------------------- no host-device sync once warmed up

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")
# The size of the benchmark's office views, and depth bounds of a room.
VIEW_HW = (240, 320)
NEAR_FAR = (0.5, 4.5)


def _without_syncs(fn):
    """``fn()`` under sync debug mode "error": a CUDA call that makes the
    host wait for the stream (a blocking copy, ``.item()``, a mask's
    ``nonzero``, a synchronize) raises. The mode is restored after."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return out


def _shipped_model(cuda, dd: bool):
    """The facade at the shipped conf's full widths: BatchNorm frozen and
    folded, or with ``dd`` the DD weight 0.1 and train-mode BatchNorm, as
    the runner sets them. Fine count 100."""
    from vf_nerf_torch.config import parse_config
    from vf_nerf_torch.models.nerf import VectorFieldNerf
    cfg = parse_config(scene="office", config_path=CONF)
    if dd:
        cfg.vf_loss_weights.directional_derivatives = 0.1
    model = VectorFieldNerf(cfg.vf_nerf_config, seed=0, device=cuda)
    with torch.no_grad():
        # The benchmark's gain on the seeded VF net: rays meet density.
        for layer in model.modules.vf.layers:
            (layer[0] if isinstance(layer, torch.nn.Sequential)
             else layer).weight.mul_(3.5)
    model.near, model.far = NEAR_FAR
    model.fine_n_samples = 100
    if dd:
        model.train()
    else:
        model.eval()
    return cfg, model


def _office_camera():
    """(pinhole intrinsics, a pose inside the scene), both (4, 4)."""
    h, w = VIEW_HW
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 0.8 * w
    intr[0, 2], intr[1, 2] = w / 2.0, h / 2.0
    pose = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    pose[:3, 3] = (0.1, -0.2, 0.3)
    return intr, pose


def _train_step_on_card(cuda, dd: bool, n: int = 1008):
    """(the facade, a call of the runner's step returning its metric
    sums): ``n`` rays of an office view, epoch 1500; frozen BatchNorm with
    static fine growth (100 live fine samples of the padded 100, 200 a
    ray), or the DD step."""
    from vf_nerf_torch.parallel import train_step as ts
    cfg, model = _shipped_model(cuda, dd)
    epoch = 1500
    rs = cfg.vf_nerf_config.ray_sampler_config
    statics = model.render_statics(
        n_fine=None if dd else rs.max_samples, compute_dir_derivatives=dd)
    sup = ts.SupervisionStatics.from_config(
        cfg.vf_nerf_config, "exterior_synthetic", n_rays=n,
        n_samples=statics.n_coarse + statics.n_fine,
        border_radius=cfg.dataset_config.border_radius)
    step = ts.make_train_step(model.modules, model.optimizer, statics, sup,
                              cfg.vf_loss_weights, cfg.vf_loss_config)
    rng = np.random.RandomState(3)
    intr, pose = _office_camera()
    h, w = VIEW_HW
    packed = ts.pack_batch({
        "uv": rng.uniform(0, (w, h), (n, 2)).astype(np.float32),
        "rgb": rng.rand(n, 3).astype(np.float32),
        "depth": rng.uniform(1.0, 4.0, (n, 1)).astype(np.float32),
        "intrinsics": np.broadcast_to(intr, (n, 4, 4)),
        "pose": np.broadcast_to(pose, (n, 4, 4))})
    fed = torch.from_numpy(packed).to(cuda)
    window = model.to_device(model.update_annealing(epoch))
    centroid = torch.zeros(3, device=cuda)
    fine = {} if dd else {"n_fine_active": model.fine_n_samples}
    sums = [ts.zero_metric_sums(cuda)]

    def one():
        sums[0] = step(sums[0], fed, epoch, window, *NEAR_FAR, centroid,
                       generator=model.generator, **fine)
        return sums[0]
    return model, one


@pytest.mark.parametrize("dd", [False, True], ids=["folded", "dd"])
def test_warm_train_step_enqueues_without_a_sync(cuda, dd):
    """After one warm-up call, a production train step of the shipped conf
    (the folded step at static fine growth, and the DD step) enqueues all
    its work without a host-blocking CUDA call, so that the host runs ahead
    of the card across steps; the step still trains."""
    model, one = _train_step_on_card(cuda, dd)
    one()
    before = model.optimizer.count
    sums = _without_syncs(one)
    assert model.optimizer.count == before + 1
    assert np.isfinite(float(sums["loss"]))


def test_warm_render_image_enqueues_without_a_sync(cuda):
    """After one warm-up view, ``render_image`` of a small view in 1024-ray
    chunks (the last one short), from host pixels as the eval and the
    benchmark pass them, enqueues every chunk without a host-blocking CUDA
    call; the render is the same as the warm-up's from the same draws."""
    _, model = _shipped_model(cuda, dd=False)
    intr, pose = _office_camera()
    v, u = np.meshgrid(np.arange(40, 88), np.arange(60, 112), indexing="ij")
    pixels = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    assert len(pixels) == 2496              # 2 whole chunks and a short one
    state = model.generator.get_state()
    ref = model.render_image(pixels, pose, intr, 1500, split_size=1024)
    model.generator.set_state(state)
    rgb, depth = _without_syncs(lambda: model.render_image(
        pixels, pose, intr, 1500, split_size=1024))
    assert rgb.shape == (2496, 3) and depth.shape == (2496, 1)
    assert torch.equal(rgb, ref[0]) and torch.equal(depth, ref[1])
    assert bool(torch.isfinite(rgb).all()) and float(rgb.mean()) > 0.0
