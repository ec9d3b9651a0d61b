"""``reuse_coarse`` on the port's eval render against the JAX package's, on
the CPU.

The render with ``reuse_coarse`` (the coarse VF outputs reused in the fine
pass, only the extra depths evaluated) is held to JAX ``render_rays`` with
``reuse_coarse`` (``vf_nerf_tpu/models/renderer.py:400-460``) on
``tests/test_renderer.py::tiny_config``, the weights carried across by
``load_jax_variables`` and JAX's draws passed in, perturb on and off, with
fine samples and without; and to the port's own recompute render on the
same draws. Tolerances are ``tests/test_renderer.py:172-181``'s for the
JAX reuse render against its recompute render: rgb rtol 1e-4 / atol 1e-5,
depth rtol 1e-4 / atol 1e-4, z_vals rtol 1e-5 / atol 1e-6 (the weights,
normals and sample colours rtol 1e-4 / atol 1e-5).

Where the JAX package does not fold (weight norm, either directional
derivative, train-mode BatchNorm) it ignores ``reuse_coarse``, and so does
the port: the outputs are the recompute render's bit for bit. With static
fine growth it raises, as the JAX package asserts.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_renderer import tiny_config
from test_torch_render import (camera, jax_coarse_argmax_array, jax_draws,
                               port_config)
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_torch.models import renderer
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.utils.weights import load_jax_variables

TOLS = {"rgb": dict(rtol=1e-4, atol=1e-5),
        "depth": dict(rtol=1e-4, atol=1e-4),
        "z_vals": dict(rtol=1e-5, atol=1e-6),
        "weights": dict(rtol=1e-4, atol=1e-5),
        "normals": dict(rtol=1e-4, atol=1e-5),
        "sample_colors": dict(rtol=1e-4, atol=1e-5)}
N_RAYS = 48
CAM = camera(N_RAYS, 1, size=40.0, focal=30.0)


@functools.lru_cache(maxsize=None)
def jax_variables(seed, gain=3.0):
    """``test_torch_render.jax_variables`` of ``tiny_config``'s nets, with
    the initializer jitted (its values equal the eager ones) and made once
    for every case: the sample counts and perturb do not change the nets."""
    jmods = jrenderer.VFNerfModules(tiny_config())
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmods.init_variables)(jax.random.PRNGKey(seed)))
    for scope in variables["params"]["vf"].values():
        scope["Dense_0"]["kernel"] = scope["Dense_0"]["kernel"] * gain
    return variables


def setup(perturb, n_importance, seed=0):
    jcfg = tiny_config(n_importance=n_importance, perturb=perturb)
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jax_variables(seed)
    cfg = port_config(jcfg)
    mods = VFNerfModules(cfg).eval()
    load_jax_variables(mods, variables)
    return jcfg, jmods, variables, cfg, mods


def port_render(mods, cfg, statics, draws):
    uv, pose, intr = (torch.from_numpy(a) for a in CAM)
    return render_rays(mods, uv, pose, intr, 0.0, 4.0,
                       torch.tensor(cfg.cos_sim_weights), statics, **draws)


@pytest.mark.parametrize("n_importance", [6, 0])
@pytest.mark.parametrize("perturb", [True, False])
def test_reuse_render_matches_jax_and_the_recompute_render(perturb,
                                                           n_importance):
    jcfg, jmods, variables, cfg, mods = setup(perturb, n_importance)
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(jcfg, n_fine=n_importance,
                                            train=False),
        reuse_coarse=True)
    key = jax.random.PRNGKey(2)
    jargs = tuple(jnp.asarray(a) for a in CAM) + (jnp.float32(0.0),
                                                   jnp.float32(4.0))
    window = jnp.asarray(jcfg.cos_sim_weights, jnp.float32)
    ref = jax.jit(lambda v, *a: jrenderer.render_rays(jmods, v, *a,
                                                      jstatics))(
        variables, *jargs, window, key)
    ref_argmax = np.asarray(jax.jit(
        lambda v, *a: jax_coarse_argmax_array(jmods, v, *a, jstatics))(
            variables, *jargs, window, key))

    statics = RenderStatics.from_config(cfg, n_fine=n_importance,
                                        train=False)
    draws = jax_draws(key, N_RAYS, statics)
    reused = port_render(mods, cfg, dataclasses.replace(
        statics, reuse_coarse=True), draws)
    recomputed = port_render(mods, cfg, statics, draws)

    np.testing.assert_array_equal(reused["argmax_coarse"].numpy(),
                                  ref_argmax)
    if n_importance:
        assert 0 < (ref_argmax > 0).sum() < N_RAYS  # both branches
    assert reused["z_vals"].shape == (N_RAYS, 20 + n_importance)
    for k, tol in TOLS.items():
        np.testing.assert_allclose(reused[k].numpy(), np.asarray(ref[k]),
                                   err_msg=f"vs JAX: {k}", **tol)
        np.testing.assert_allclose(reused[k].numpy(),
                                   recomputed[k].numpy(),
                                   err_msg=f"vs recompute: {k}", **tol)


def test_ties_keep_the_coarse_row_first_as_jax_argsort():
    """A coarse and an extra depth that tie: the stable sort keeps the
    coarse sample's VF row first, as JAX's ``argsort`` and
    ``take_along_axis`` order them."""
    z_coarse = torch.tensor([[0.5, 1.0, 2.0, 3.0], [0.5, 1.0, 2.0, 3.0]])
    z_extra = torch.tensor([[1.0, 2.5], [0.25, 3.0]])
    vf_coarse = torch.arange(8.0).reshape(8, 1).expand(8, 5).contiguous()
    vf_extra = 100.0 + torch.arange(4.0).reshape(4, 1).expand(4, 5)
    statics = RenderStatics(
        n_coarse=4, n_fine=2, n_window=1, perturb=False, rendering="volsdf",
        normalize_rendering=True, dir_to_normal_th=-2.0, cutoff=-0.5,
        beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
        anneal_mode="hard", compute_dir_derivatives=False,
        white_background=False, train=False, reuse_coarse=True)

    def extras(*args):
        return z_extra

    def field(pts):
        return vf_extra

    original = renderer.samplers.range_fine_extra_z
    renderer.samplers.range_fine_extra_z = extras
    try:
        z_vals, vf_out = renderer._reuse_coarse(
            statics, vf_coarse, z_coarse, None, 0.3, 0.0, 4.0, None, None,
            torch.zeros(2, 3), torch.ones(2, 3), field)
    finally:
        renderer.samplers.range_fine_extra_z = original

    z_cat = jnp.concatenate([jnp.asarray(z_coarse.numpy()),
                             jnp.asarray(z_extra.numpy())], axis=-1)
    order = jnp.argsort(z_cat, axis=-1)
    vf_cat = jnp.concatenate(
        [jnp.asarray(vf_coarse.numpy()).reshape(2, 4, 5),
         jnp.asarray(vf_extra.numpy()).reshape(2, 2, 5)], axis=1)
    ref = jnp.take_along_axis(vf_cat, order[..., None], axis=1)
    np.testing.assert_array_equal(
        z_vals.numpy(), np.asarray(jnp.take_along_axis(z_cat, order, -1)))
    np.testing.assert_array_equal(vf_out.numpy(),
                                  np.asarray(ref).reshape(12, 5))
    assert vf_out[1, 0] == 1.0 and vf_out[2, 0] == 100.0   # the tie at 1.0


def _variant(cfg, kind):
    """(statics changes, config changes) of a path the JAX package does not
    fold."""
    if kind == "weight_norm":
        for net in (cfg.vf_net_config, cfg.rendering_net_config):
            net.weight_norm, net.batch_norm = True, False
        return {}
    if kind == "train":
        return dict(train=True)
    cfg.numerical_jacobian = kind == "numerical_dd"
    return dict(compute_dir_derivatives=True,
                numerical_jacobian=cfg.numerical_jacobian)


@pytest.mark.parametrize("kind", ["weight_norm", "analytic_dd",
                                  "numerical_dd", "train"])
def test_reuse_is_ignored_where_jax_does_not_fold(kind):
    cfg = port_config(tiny_config())
    change = _variant(cfg, kind)
    mods = VFNerfModules(cfg, generator=torch.Generator().manual_seed(0))
    mods.train(kind == "train")
    statics = dataclasses.replace(
        RenderStatics.from_config(cfg, n_fine=6, train=False), **change)
    assert not mods.reuses_coarse(dataclasses.replace(statics,
                                                      reuse_coarse=True))
    outs = [port_render(mods, cfg, dataclasses.replace(statics,
                                                       reuse_coarse=reuse),
                        dict(generator=torch.Generator().manual_seed(4)))
            for reuse in (False, True)]
    for k, v in outs[0].items():
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(outs[1][k], v, rtol=0, atol=0)


def test_jax_ignores_reuse_under_weight_norm_too():
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg,
        vf_net_config=dataclasses.replace(jcfg.vf_net_config,
                                          weight_norm=True, batch_norm=False),
        rendering_net_config=dataclasses.replace(
            jcfg.rendering_net_config, weight_norm=True, batch_norm=False))
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jmods.init_variables(jax.random.PRNGKey(0))
    jstatics = jrenderer.RenderStatics.from_config(jcfg, n_fine=6,
                                                   train=False)
    args = tuple(jnp.asarray(a) for a in CAM) + (
        jnp.float32(0.0), jnp.float32(4.0),
        jnp.asarray(jcfg.cos_sim_weights, jnp.float32),
        jax.random.PRNGKey(3))
    outs = [jax.jit(lambda v, *a, s=dataclasses.replace(
        jstatics, reuse_coarse=reuse): jrenderer.render_rays(jmods, v, *a, s))(
            variables, *args) for reuse in (False, True)]
    for k in ("rgb", "depth", "z_vals"):
        np.testing.assert_array_equal(np.asarray(outs[1][k]),
                                      np.asarray(outs[0][k]))


def test_reuse_with_static_fine_growth_raises():
    cfg = port_config(tiny_config())
    mods = VFNerfModules(cfg).eval()
    statics = dataclasses.replace(
        RenderStatics.from_config(cfg, n_fine=8, train=False),
        reuse_coarse=True)
    with pytest.raises(NotImplementedError, match="reuse_coarse"):
        port_render(mods, cfg, statics,
                    dict(generator=torch.Generator(), n_fine_active=4))


def test_facade_render_takes_reuse_coarse():
    """``VectorFieldNerf.render(..., reuse_coarse=True)`` is ``render_rays``
    with ``RenderStatics.reuse_coarse`` set, from the same draws, and its
    fine pass evaluates the VF net at the extra depths only; the facade's
    statics leave it off unless asked."""
    model = VectorFieldNerf(port_config(tiny_config(n_importance=6)),
                            seed=5, device="cpu")
    load_jax_variables(model, jax_variables(3))
    model.near, model.far = 0.0, 4.0
    assert not model.render_statics().reuse_coarse
    statics = model.render_statics(reuse_coarse=True)
    assert model.modules.reuses_coarse(statics)
    points = []
    vf_apply_folded = model.modules.vf_apply_folded
    model.modules.vf_apply_folded = lambda w, pts: (
        points.append(pts.shape[0]), vf_apply_folded(w, pts))[1]
    model.generator.manual_seed(5)
    uv, pose, intr = CAM
    out = model.render(pose, uv, intr, epoch=0, reuse_coarse=True)
    del model.modules.vf_apply_folded
    assert points == [N_RAYS * 20, N_RAYS * 6]
    ref = render_rays(model.modules, *(torch.from_numpy(a) for a in CAM),
                      0.0, 4.0, torch.tensor(model.window_weights), statics,
                      generator=torch.Generator().manual_seed(5))
    for k in ("rgb", "depth", "z_vals", "weights"):
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
