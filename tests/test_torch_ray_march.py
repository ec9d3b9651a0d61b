"""The port's fused ray march (``vf_nerf_torch/ops/ray_march.py``) on the
CPU (its plain version) against JAX ``fused_ray_march`` with the Pallas
kernel in interpret mode and against JAX ``ray_march_reference``, at
rtol 1e-4 / atol 1e-5 (as ``tests/test_pallas_kernels.py``). Inputs have
smooth structure so that sign flips (surface crossings) exist; the back-face
threshold runs at -0.2, where the branch fires, and at the shipped -2. Raw
density parameters beyond each clamp and the coarse pass's weights-only mode
(no rgb samples) are held to JAX too.

The CUDA kernel runs only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` check it there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vf_nerf_tpu.ops import ray_march as jmarch
from vf_nerf_tpu.ops.density import DensityParams as JParams
from vf_nerf_torch.ops.density import DensityParams
from vf_nerf_torch.ops.ray_march import (fused_ray_march, march_scalars,
                                         tap_coefficients)

TOL = dict(rtol=1e-4, atol=1e-5)
ANNEALED = [0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08, 0.04, 0.02, 0.01]


def _inputs(n_rays, n_samples, seed=0):
    rng = np.random.RandomState(seed)
    normals = rng.randn(n_rays, n_samples, 3).astype(np.float32)
    t = np.linspace(0, np.pi, n_samples, dtype=np.float32)
    normals[..., 0] += np.cos(3 * t)[None]
    dirs = rng.randn(n_rays, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 4.0, (n_rays, n_samples)),
                axis=1).astype(np.float32)
    rgb = rng.rand(n_rays, n_samples, 3).astype(np.float32)
    return normals, dirs, z, rgb


def _bounds(th, beta_bounds=(1e-4, 1e9)):
    return dict(beta_bounds=beta_bounds, scale_min=1.0,
                mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=th)


def _run_both(n_rays, n_samples, taps, params, th, normalize, white, seed=0,
              beta_bounds=(1e-4, 1e9), weights_only=False):
    """Ours, the Pallas kernel (interpret mode) and the XLA reference on the
    same inputs. ``weights_only``: ours gets no rgb samples, JAX zero rgb."""
    normals, dirs, z, rgb = _inputs(n_rays, n_samples, seed)
    kw = dict(normalize=normalize, white_background=white,
              **_bounds(th, beta_bounds))
    jp = JParams(*(jnp.float32(v) for v in params))
    j_rgb = np.zeros_like(rgb) if weights_only else rgb
    jargs = (jnp.asarray(normals), jnp.asarray(dirs), jnp.asarray(z),
             jnp.asarray(j_rgb), jp, jnp.asarray(taps, jnp.float32))
    pallas = jmarch.fused_ray_march(*jargs, block_rays=32, interpret=True,
                                    **kw)
    xla = jmarch.ray_march_reference(*jargs, **kw)
    ours = fused_ray_march(
        *(torch.from_numpy(a) for a in (normals, dirs, z)),
        None if weights_only else torch.from_numpy(rgb),
        DensityParams(*(torch.tensor(v) for v in params)),
        torch.tensor(taps, dtype=torch.float32), **kw)
    return ours, pallas, xla


@pytest.mark.parametrize("th", [-0.2, -2.0])
@pytest.mark.parametrize("n_samples", [26, 130, 200])
def test_matches_jax_pallas_kernel(n_samples, th):
    ours, pallas, xla = _run_both(70, n_samples, [0.09] * 11,
                                  (0.5, 100.0, 0.7), th, True, False)
    for a, b, c, name in zip(ours, pallas, xla, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name,
                                   **TOL)
    assert float(ours[2].sum(1).max()) > 0.5  # real surfaces were rendered


@pytest.mark.parametrize("th", [-0.2, -2.0])
def test_annealed_taps_and_white_background(th):
    ours, pallas, xla = _run_both(40, 64, ANNEALED, (0.3, 50.0, 0.8), th,
                                  False, True, seed=3)
    for a, b, c, name in zip(ours, pallas, xla, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("params,beta_bounds", [
    ((0.01, -80.0, 0.2), (0.3, 1e9)),    # beta and mean below, scale < 0
    ((5.0, 0.5, 1.7), (1e-4, 2.0)),      # beta and mean above, |scale| < 1
])
def test_raw_parameters_beyond_each_clamp(params, beta_bounds):
    """The raw density parameters are clamped as the JAX wrapper clamps them
    (the CUDA kernel does it in its prologue)."""
    ours, pallas, xla = _run_both(50, 130, [0.09] * 11, params, -0.2, True,
                                  False, seed=2, beta_bounds=beta_bounds)
    for a, b, c, name in zip(ours, pallas, xla, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("n_samples,taps", [(100, [1.0 / 11] * 11),
                                            (130, ANNEALED)])
def test_weights_only_coarse_mode(n_samples, taps):
    """No rgb samples: the weights alone, equal to JAX's with zero rgb; rgb
    and depth are None."""
    ours, pallas, xla = _run_both(60, n_samples, taps, (0.5, 100.0, 0.7),
                                  -2.0, True, False, seed=5,
                                  weights_only=True)
    assert ours[0] is None and ours[1] is None
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(pallas[2]), **TOL)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(xla[2]), **TOL)


def test_back_face_branch_fires_at_minus_0_2():
    """The two thresholds give different weights on these inputs, so the
    -0.2 cases above do exercise the suppression branch."""
    a, _, _ = _run_both(30, 64, [0.09] * 11, (0.5, 100.0, 0.7), -0.2, True,
                        False)
    b, _, _ = _run_both(30, 64, [0.09] * 11, (0.5, 100.0, 0.7), -2.0, True,
                        False)
    assert not torch.allclose(a[2], b[2])


def test_kernel_side_scalars_match_jax_prep():
    """The (5,) scalar pack and tap coefficients the kernel reads equal the
    JAX wrapper's host-side preparation (``ray_march.py:193-207``)."""
    taps = np.asarray(ANNEALED, np.float32)
    w = jnp.asarray(taps)
    middle = 5
    ref = jnp.abs(w).at[middle].set(w[middle]) / jnp.sum(jnp.abs(w))
    np.testing.assert_allclose(tap_coefficients(torch.from_numpy(taps)),
                               np.asarray(ref), rtol=1e-6)
    params = (2e-5, -0.3, 1.7)
    pack = march_scalars(DensityParams(*(torch.tensor(v) for v in params)),
                         device="cpu", **_bounds(-0.2))
    from vf_nerf_tpu.ops.density import (get_beta, get_mean, get_scale,
                                         laplace_cdf)
    jp = JParams(*(jnp.float32(v) for v in params))
    beta, scale = get_beta(jp, (1e-4, 1e9)), get_scale(jp, 1.0)
    mean = get_mean(jp, (0.6, 1.0))
    ref = [beta, scale, mean,
           laplace_cdf(jnp.float32(-0.5), beta, scale, mean), -0.2]
    np.testing.assert_allclose(pack.numpy(), np.asarray(ref, np.float32),
                               rtol=1e-6)


def test_wrapper_refuses_other_devices_and_bad_shapes():
    normals, dirs, z, rgb = (torch.from_numpy(a) for a in _inputs(4, 20))
    p = DensityParams(*(torch.tensor(v) for v in (0.5, 100.0, 0.7)))
    taps = torch.full((11,), 0.09)
    kw = dict(normalize=True, **_bounds(-2.0))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_ray_march(normals.to("meta"), dirs.to("meta"), z.to("meta"),
                        rgb.to("meta"), p, taps, **kw)
    with pytest.raises(ValueError, match="shapes"):
        fused_ray_march(normals[:, :-1], dirs, z, rgb, p, taps, **kw)


def _jax_chain(normals, dirs, z, rgb, params, taps, th, normalize, white,
               n_valid, beta_bounds=(1e-4, 1e9)):
    """The JAX package's plain fine-pass chain with ``n_valid``:
    ``get_density`` (window with the live interior, σ zero from
    n_valid - 1 on) → VolSDF weights → composite."""
    from vf_nerf_tpu.models import renderer as jrenderer
    from vf_nerf_tpu.ops import compositing as jcompositing
    statics = jrenderer.RenderStatics(
        n_coarse=0, n_fine=0, n_window=len(taps), perturb=False,
        rendering="volsdf", normalize_rendering=normalize,
        dir_to_normal_th=th, cutoff=-0.5, beta_bounds=beta_bounds,
        scale_min=1.0, mean_bounds=(0.6, 1.0), anneal_mode="anneal_fine",
        compute_dir_derivatives=False, numerical_jacobian=False,
        white_background=white, train=False)
    dirs_rep = jnp.repeat(dirs[:, None, :], z.shape[1], axis=1)
    sigma = jrenderer.get_density(normals, dirs_rep, params, taps, statics,
                                  fine=True, n_valid=n_valid)
    weights = jcompositing.volsdf_volume_rendering(z, sigma, normalize)
    rgb_map, depth = jcompositing.composite_rgb_depth(weights, rgb, z, white)
    return rgb_map, depth, weights


@pytest.mark.parametrize("n_samples,n_valid,th,white,normalize", [
    (32, 20, -0.2, False, True),
    (32, 32, -2.0, True, True),
    (32, 15, -0.2, False, False),
    (200, 130, -0.2, True, True),
    (26, 3, -2.0, False, True),
])
def test_n_valid_matches_jax_get_density(n_samples, n_valid, th, white,
                                         normalize):
    """The plain march with the live-sample mask against the JAX package's
    ``get_density`` with ``n_valid`` and its compositing."""
    normals, dirs, z, rgb = _inputs(40, n_samples, seed=n_samples + n_valid)
    params = (0.5, 100.0, 0.7)
    kw = dict(normalize=normalize, white_background=white, **_bounds(th))
    ours = fused_ray_march(
        *(torch.from_numpy(a) for a in (normals, dirs, z, rgb)),
        DensityParams(*(torch.tensor(v) for v in params)),
        torch.tensor(ANNEALED), n_valid=n_valid, **kw)
    ref = _jax_chain(*(jnp.asarray(a) for a in (normals, dirs, z, rgb)),
                     JParams(*(jnp.float32(v) for v in params)),
                     jnp.asarray(ANNEALED, jnp.float32), th, normalize,
                     white, jnp.asarray(n_valid, jnp.int32))
    for a, b, name in zip(ours, ref, ("rgb", "depth", "weights")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    if n_valid < n_samples:
        assert float(ours[2][:, n_valid:].abs().max()) == 0.0


@pytest.mark.parametrize("n_valid,white,params,beta_bounds", [
    (20, False, (0.5, 100.0, 0.7), (1e-4, 1e9)),
    (32, True, (0.5, 100.0, 0.7), (1e-4, 1e9)),
    (26, True, (0.2, -40.0, 1.3), (0.3, 1e9)),    # beta and mean clamped
])
def test_gradients_match_jax_grad(n_valid, white, params, beta_bounds):
    """Autograd through the plain march (the CUDA backward kernel's oracle)
    against ``jax.grad`` of the JAX chain, to the normals, the rgb samples
    and the raw density parameters, with annealed taps: max|Δ| ≤
    1e-4·max|g| + 1e-7 per input."""
    normals, dirs, z, rgb = _inputs(24, 32, seed=n_valid)
    rng = np.random.RandomState(n_valid + 1)
    a_rgb = rng.randn(24, 3).astype(np.float32)
    a_depth = rng.randn(24).astype(np.float32)

    def jax_loss(n, c, p):
        rgb_map, depth, _ = _jax_chain(
            n, jnp.asarray(dirs), jnp.asarray(z), c, p,
            jnp.asarray(ANNEALED, jnp.float32), -0.2, True, white,
            jnp.asarray(n_valid, jnp.int32), beta_bounds)
        return jnp.sum(rgb_map * a_rgb) + jnp.sum(depth * a_depth)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(normals), jnp.asarray(rgb),
        JParams(*(jnp.float32(v) for v in params)))
    n_t = torch.from_numpy(normals).requires_grad_(True)
    c_t = torch.from_numpy(rgb).requires_grad_(True)
    p_t = DensityParams(*(torch.tensor(v, requires_grad=True)
                          for v in params))
    out = fused_ray_march(n_t, torch.from_numpy(dirs), torch.from_numpy(z),
                          c_t, p_t, torch.tensor(ANNEALED), normalize=True,
                          white_background=white, n_valid=n_valid,
                          **_bounds(-0.2, beta_bounds))
    total = torch.sum(out[0] * torch.from_numpy(a_rgb)) + \
        torch.sum(out[1] * torch.from_numpy(a_depth))
    got = torch.autograd.grad(total, [n_t, c_t, *p_t])
    refs = [np.asarray(ref[0]), np.asarray(ref[1])] + \
        [np.asarray(getattr(ref[2], k)) for k in ("beta", "scale", "mean")]
    for g, r, name in zip(got, refs, ("normals", "rgb", "beta", "scale",
                                      "mean")):
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (name, err)
    assert float(np.abs(refs[0]).max()) > 1e-3   # the density carried some
