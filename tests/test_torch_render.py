"""The port's eval render against the JAX package's, on the CPU.

- ``render_rays`` of ``vf_nerf_torch`` (the fused MLP and ray march take
  their plain versions on CPU tensors) against JAX ``render_rays``, with the
  weights carried across by ``load_jax_variables`` and JAX's own uniform
  draws passed in, on ``tests/test_renderer.py::tiny_config`` with perturb
  on and off, against both the default statics and the Pallas statics
  (interpret mode), and once at the shipped conf's full widths with 100 + 30
  samples. The VF kernels are scaled up from their init so that the random
  field flips along rays: both fine-sampler branches occur.
- The facade's ``render`` and ``render_image`` against the port's
  ``render_rays`` on the same draws, from a generator seeded alike.

The coarse argmax decides every ray's fine depths, so each case first
asserts that the argmax indices agree. Tolerance rtol 1e-4 / atol 1e-5.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_renderer import tiny_config
from vf_nerf_tpu.config.parser import parse_config as jparse
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.ops import compositing as jcompositing
from vf_nerf_tpu.ops import rays as jrays
from vf_nerf_tpu.ops import samplers as jsamplers
from vf_nerf_torch.config import schema
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.utils.weights import load_jax_variables

CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")
TOL = dict(rtol=1e-4, atol=1e-5)
KEYS = ("rgb", "depth", "weights", "z_vals", "normals", "sample_colors")


def port_config(jcfg) -> schema.VFNerfConfig:
    """The same configuration as the port's own dataclasses."""
    sub = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in (("vf_net_config", schema.VFNetConfig),
                      ("rendering_net_config", schema.RenderingNetConfig),
                      ("ray_sampler_config", schema.RaySamplerConfig),
                      ("device_config", schema.DeviceConfig),
                      ("scheduler_config", schema.SchedulerConfig),
                      ("density_config", schema.DensityConfig)):
        sub[name] = cls(**dataclasses.asdict(sub[name]))
    return schema.VFNerfConfig(**sub)


def jax_variables(jcfg, seed, gain):
    """JAX-initialized variables as numpy, the VF kernels scaled by
    ``gain`` so the random field flips along rays."""
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmods.init_variables(jax.random.PRNGKey(seed)))
    for scope in variables["params"]["vf"].values():
        scope["Dense_0"]["kernel"] = scope["Dense_0"]["kernel"] * gain
    return jmods, variables


def camera(n_rays, seed, size=640.0, focal=600.0):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(0, size, (n_rays, 2)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (n_rays, 1, 1))
    intr = np.tile(np.eye(4, dtype=np.float32), (n_rays, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = focal
    intr[:, 0, 2], intr[:, 1, 2] = size / 2, size * 0.375
    return uv, pose, intr


def jax_draws(key, n_rays, statics):
    """JAX's uniform draws, split exactly as ``render_rays`` and
    ``ops/samplers.py`` split the key."""
    k_coarse, k_fine = jax.random.split(key)
    k_strat, k_rand = jax.random.split(k_fine)
    draws = {
        "t_coarse": jax.random.uniform(k_coarse, (n_rays, statics.n_coarse),
                                       jnp.float32),
        "t_fine": jsamplers._column_uniform(k_strat, n_rays, statics.n_fine,
                                            jnp.float32),
        "u_extra": jsamplers._column_uniform(k_rand, n_rays, statics.n_fine,
                                             jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_coarse_argmax(jmods, variables, uv, pose, intr, near, far, window,
                      key, statics):
    """The coarse-weight argmax of JAX ``render_rays`` (its coarse pass)."""
    k_coarse, _ = jax.random.split(key)
    n_rays = uv.shape[0]
    directions, ray_dirs, cam_loc = \
        jrays.get_ray_directions_and_cam_location(uv, pose, intr)
    z = jsamplers.uniform_z_vals(k_coarse, n_rays, statics.n_coarse, near,
                                 far, perturb=statics.perturb)
    pts = jsamplers.points_from_z(cam_loc, directions, z)
    vf_w, _ = jmods.folded_weights(variables)
    normals = jmods.vf_apply_folded(vf_w, pts.reshape(-1, 3))[:, :3]
    normals = normals.reshape(n_rays, statics.n_coarse, 3)
    dirs = jnp.repeat(ray_dirs[:, None, :], statics.n_coarse, axis=1)
    sigma = jrenderer.get_density(normals, dirs,
                                  variables["params"]["density"], window,
                                  statics, fine=False)
    w = jcompositing.volsdf_volume_rendering(z, sigma,
                                             statics.normalize_rendering)
    return np.asarray(jnp.argmax(w, axis=-1))


def compare_render(jcfg, gain, n_rays, perturb, pallas, seed=0,
                   near=0.0, far=4.0, cam=None):
    jcfg = dataclasses.replace(jcfg, ray_sampler_config=dataclasses.replace(
        jcfg.ray_sampler_config, perturb=perturb))
    jmods, variables = jax_variables(jcfg, seed, gain)
    jstatics = jrenderer.RenderStatics.from_config(
        jcfg, n_fine=jcfg.ray_sampler_config.n_importance, train=False)
    if pallas:
        jstatics = dataclasses.replace(jstatics, pallas_mlp=True,
                                       pallas_march=True)
    uv, pose, intr = cam or camera(n_rays, seed + 1)
    window = jnp.asarray(jcfg.cos_sim_weights, jnp.float32)
    key = jax.random.PRNGKey(seed + 2)
    jargs = (jnp.asarray(uv), jnp.asarray(pose), jnp.asarray(intr),
             jnp.float32(near), jnp.float32(far))
    ref = jrenderer.render_rays(jmods, variables, *jargs, window, key,
                                jstatics)
    ref_argmax = jax_coarse_argmax(jmods, variables, *jargs, window, key,
                                   jstatics)

    cfg = port_config(jcfg)
    mods = VFNerfModules(cfg).eval()
    load_jax_variables(mods, variables)
    statics = RenderStatics.from_config(
        cfg, n_fine=cfg.ray_sampler_config.n_importance, train=False)
    ours = render_rays(mods, torch.from_numpy(uv), torch.from_numpy(pose),
                       torch.from_numpy(intr), near, far,
                       torch.tensor(cfg.cos_sim_weights), statics,
                       **jax_draws(key, n_rays, statics))

    np.testing.assert_array_equal(ours["argmax_coarse"].numpy(), ref_argmax)
    for k in KEYS:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    return ref_argmax


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("perturb", [True, False])
def test_render_rays_tiny_config(perturb, pallas):
    argmax = compare_render(tiny_config(), gain=3.0, n_rays=48,
                            perturb=perturb, pallas=pallas,
                            cam=camera(48, 1, size=40.0, focal=30.0))
    assert 0 < (argmax > 0).sum() < argmax.size  # both branches


def test_render_rays_shipped_widths():
    """The shipped conf's full widths and 100 + 30 samples on 8 rays, at
    the ``__graft_entry__.entry`` camera (near 0, far 4)."""
    jcfg = jparse(scene="s", config_path=CONF).vf_nerf_config
    argmax = compare_render(jcfg, gain=2.5, n_rays=8, perturb=True,
                            pallas=False)
    assert 0 < (argmax > 0).sum() < argmax.size  # both branches


@pytest.fixture(scope="module")
def facade():
    jcfg = tiny_config()
    _, variables = jax_variables(jcfg, 3, 3.0)
    model = VectorFieldNerf(port_config(jcfg), seed=5, device="cpu")
    load_jax_variables(model, variables)
    model.near, model.far = 0.0, 4.0
    return model


def test_facade_render_matches_render_rays(facade):
    uv, pose, intr = camera(24, 7, size=40.0, focal=30.0)
    facade.generator.manual_seed(5)
    out = facade.render(pose, uv, intr, epoch=0)
    statics = facade.render_statics()
    ref = render_rays(facade.modules, torch.from_numpy(uv),
                      torch.from_numpy(pose), torch.from_numpy(intr), 0.0,
                      4.0, torch.tensor(facade.window_weights), statics,
                      generator=torch.Generator().manual_seed(5))
    for k in KEYS:
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)


def test_facade_render_image_matches_chunks(facade):
    h, w = 5, 7
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pixels = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) * 5
    _, pose, intr = camera(1, 0, size=40.0, focal=30.0)
    facade.generator.manual_seed(9)
    rgb, depth = facade.render_image(pixels, pose[0], intr[0], epoch=0,
                                     split_size=16)
    assert rgb.shape == (h * w, 3) and depth.shape == (h * w, 1)
    gen = torch.Generator().manual_seed(9)
    statics = facade.render_statics()
    for start in range(0, h * w, 16):
        chunk = torch.from_numpy(pixels[start:start + 16])
        n = chunk.shape[0]
        ref = render_rays(facade.modules, chunk,
                          torch.from_numpy(pose[0]).expand(n, 4, 4),
                          torch.from_numpy(intr[0]).expand(n, 4, 4), 0.0,
                          4.0, torch.tensor(facade.window_weights), statics,
                          generator=gen)
        torch.testing.assert_close(rgb[start:start + n], ref["rgb"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(depth[start:start + n], ref["depth"],
                                   rtol=0, atol=0)
