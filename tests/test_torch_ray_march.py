"""The port's fused ray march (``vf_nerf_torch/ops/ray_march.py``) on the
CPU (its plain version) against JAX ``fused_ray_march`` with the Pallas
kernel in interpret mode and against JAX ``ray_march_reference``, at
rtol 1e-4 / atol 1e-5 (as ``tests/test_pallas_kernels.py``). Inputs have
smooth structure so that sign flips (surface crossings) exist; the back-face
threshold runs at -0.2, where the branch fires, and at the shipped -2.

The CUDA kernel runs only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` check it there.
"""

import numpy as np
import pytest
import torch

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


def _bounds(th):
    return dict(beta_bounds=(1e-4, 1e9), scale_min=1.0,
                mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=th)


def _run_both(n_rays, n_samples, taps, params, th, normalize, white, seed=0):
    normals, dirs, z, rgb = _inputs(n_rays, n_samples, seed)
    kw = dict(normalize=normalize, white_background=white, **_bounds(th))
    jp = JParams(*(jnp.float32(v) for v in params))
    jargs = (jnp.asarray(normals), jnp.asarray(dirs), jnp.asarray(z),
             jnp.asarray(rgb), jp, jnp.asarray(taps, jnp.float32))
    pallas = jmarch.fused_ray_march(*jargs, block_rays=32, interpret=True,
                                    **kw)
    xla = jmarch.ray_march_reference(*jargs, **kw)
    ours = fused_ray_march(
        *(torch.from_numpy(a) for a in (normals, dirs, z, rgb)),
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
