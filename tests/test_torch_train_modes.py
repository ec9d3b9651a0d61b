"""The port's unfolded modules against the JAX package's, on the CPU:
train-mode BatchNorm, the field's Jacobians and directional derivatives,
weight norm, NeRF compositing, and the unfolded render.

Nets are the tiny config of ``__graft_entry__._tiny_config`` (VF 2×32, skip
at layer 1, multires 4; colour 2×32) with the JAX package's own init, the
VF kernels gained by 2.5 and the BatchNorm statistics and affine
parameters randomized (``test_torch_train_step.tiny_variables``); the
Jacobian pins use a 4×64 VF net with the skip at layer 2 and multires 6 on
256 points. Inputs are made from a seed with numpy.

Tolerances, stated per test:
- BatchNorm outputs rtol 1e-4 / atol 1e-5 (``test_torch_render``'s); the
  running statistics rtol 1e-5 / atol 1e-7: flax takes the variance as
  E[x²] − E[x]², the port by ``torch.var_mean``, so their roundings differ.
- The analytic Jacobian within 1e-5·max|J| (measured 2.6e-7 and 5.3e-7);
  the numerical one, whose central difference over ε = 1e-5 multiplies
  each f32 rounding of the field by 1/(2ε) = 5e4, within half of JAX's
  own distance from its analytic Jacobian (measured 0.16 of it); the
  directional derivatives of identical inputs rtol 1e-5 / atol 1e-6.
- Weight norm: outputs and gradients rtol 1e-5 / atol 1e-6.
- Renders: rtol 1e-4 / atol 1e-5 on rgb, depth, weights and the samples,
  the analytic DD norms within 1e-4·max, the numerical ones within twice
  JAX's own numerical error (see the test), the running statistics as
  above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_torch_render import camera, jax_draws, port_config
from test_torch_train_step import tiny_variables
from vf_nerf_tpu.models import networks as jnetworks
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.ops import compositing as jcompositing
from vf_nerf_tpu.utils.torch_import import mlp_state_from_torch
from vf_nerf_torch.models import networks
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.ops import compositing
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.utils.weights import (export_jax_vf_variables,
                                         load_jax_variables,
                                         load_reference_state)

TOL = dict(rtol=1e-4, atol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-7)
WN_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().numpy()


def _nets(jcfg, seed=0):
    """(JAX modules, numpy variables, the port's modules with them)."""
    jmods, variables = tiny_variables(jcfg, seed)
    mods = VFNerfModules(port_config(jcfg))
    load_jax_variables(mods, variables)
    return jmods, variables, mods


def _stats(net):
    """The port net's running statistics as flax batch_stats."""
    return export_jax_vf_variables(net)[1]


def _assert_stats(ours, ref):
    assert set(ours) == set(ref)
    for layer in ref:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                ours[layer]["BatchNorm_0"][k],
                np.asarray(ref[layer]["BatchNorm_0"][k]),
                err_msg=f"{layer} {k}", **STATS_TOL)


# ----------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("net", ["vf", "render"])
def test_train_mode_batch_norm_matches_flax(net):
    """Two train-mode forwards on different batches, the first's running
    statistics kept: outputs and updated statistics as flax
    ``apply(train=True, mutable=["batch_stats"])`` threads them."""
    jcfg = graft._tiny_config()
    jmods, variables, mods = _nets(jcfg)
    rng = np.random.RandomState(1)
    feat = jcfg.vf_net_config.feature_vector_dims
    batch_stats = dict(variables["batch_stats"])
    target = getattr(mods, net)
    for n in (97, 83):
        before = {k: v.clone() for k, v in target.state_dict().items()}
        pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        if net == "vf":
            ref, ref_stats = jmods.vf_apply_mutable(
                {"params": variables["params"], "batch_stats": batch_stats},
                jnp.asarray(pts))
            ours, updates = mods.vf(torch.from_numpy(pts), True)
        else:
            args = [rng.randn(n, 3).astype(np.float32) for _ in range(2)]
            args.append(rng.randn(n, feat).astype(np.float32))
            ref, ref_stats = jmods.render_apply_mutable(
                {"params": variables["params"], "batch_stats": batch_stats},
                jnp.asarray(pts), *map(jnp.asarray, args))
            ours, updates = mods.render(
                torch.from_numpy(pts), *map(torch.from_numpy, args), True)
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **TOL)
        assert all(torch.equal(v, before[k])
                   for k, v in target.state_dict().items()), \
            "the forward wrote a buffer"
        target.apply_updates(updates)
        _assert_stats(_stats(target), ref_stats)
        batch_stats[net] = ref_stats
    counts = [v for k, v in target.state_dict().items()
              if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == 2 for c in counts)


def test_running_variance_is_biased():
    """flax updates the running variance with the biased batch variance;
    ``nn.BatchNorm1d``'s own update takes the unbiased one and misses it.
    On 40 points the two differ by 1/39 of the batch term."""
    jcfg = graft._tiny_config()
    jmods, variables, mods = _nets(jcfg)
    pts = np.random.RandomState(2).uniform(-1, 1, (40, 3)).astype(np.float32)
    _, ref_stats = jmods.vf_apply_mutable(variables, jnp.asarray(pts))
    ref_var = np.asarray(ref_stats["layer_0"]["BatchNorm_0"]["var"])
    lin, bn = mods.vf.layers[0]
    x = torch.nn.functional.linear(
        positional_encoding(torch.from_numpy(pts).double(),
                            jcfg.vf_net_config.embedder_multires),
        lin.weight.double(), lin.bias.double()).detach().numpy()
    old = bn.running_var.double().numpy()
    biased = 0.9 * old + 0.1 * x.var(0, ddof=0)
    unbiased = 0.9 * old + 0.1 * x.var(0, ddof=1)
    np.testing.assert_allclose(ref_var, biased, rtol=1e-5)
    _, updates = mods.vf(torch.from_numpy(pts), True)
    ours = _np(updates["layers.0.1.running_var"])
    np.testing.assert_allclose(ours, biased, rtol=1e-5)
    assert np.abs(ours - unbiased).max() > 10 * np.abs(ours - biased).max()
    torch_bn = torch.nn.BatchNorm1d(bn.num_features).double()
    torch_bn.load_state_dict(bn.state_dict())
    torch_bn.train()(torch.from_numpy(x))
    torch_var = torch_bn.running_var.numpy()
    np.testing.assert_allclose(torch_var, unbiased, rtol=1e-6)
    assert not np.allclose(torch_var, ref_var, rtol=1e-5)


# ----------------------------------------------------------- Jacobians


def _jacobian_nets():
    """A 4×64 VF net, skip at layer 2, multires 6."""
    jcfg = graft._tiny_config()
    jcfg = dataclasses.replace(jcfg, vf_net_config=dataclasses.replace(
        jcfg.vf_net_config, dimensions=[64] * 4, skip_connection_in=[2],
        embedder_multires=6))
    return _nets(jcfg, seed=3)


@pytest.fixture(scope="module")
def jacobians():
    """Both packages' Jacobians of the 4×64 net on 256 points, in eval and
    in train BatchNorm, and the port's reverse-mode rows (the
    reference's per-row ``autograd.grad``)."""
    jmods, variables, mods = _jacobian_nets()
    pts = np.random.RandomState(4).uniform(-1, 1, (256, 3)).astype(
        np.float32)
    out = {}
    for train in (False, True):
        def japply(p, train=train):
            return jmods.vf_apply(variables, p, train=train)

        def apply(p, train=train):
            return mods.vf_apply(p, train)

        p = torch.from_numpy(pts).requires_grad_(True)
        v = apply(p)[:, :3]
        rows = torch.stack([torch.autograd.grad(
            v[:, i], p, torch.ones_like(v[:, i]), retain_graph=True)[0]
            for i in range(3)], dim=1)
        out[train] = dict(
            jax=np.asarray(jnetworks.vf_jacobian(japply, jnp.asarray(pts))),
            ours=_np(networks.vf_jacobian(apply, torch.from_numpy(pts))),
            rows=_np(rows),
            jax_num=np.asarray(jnetworks.numerical_vf_jacobian(
                japply, jnp.asarray(pts))),
            ours_num=_np(networks.numerical_vf_jacobian(
                apply, torch.from_numpy(pts))))
    return out


@pytest.mark.parametrize("train", [False, True])
def test_vf_jacobian_matches_jax(jacobians, train):
    j = jacobians[train]
    scale = np.abs(j["jax"]).max()
    assert np.abs(j["ours"] - j["jax"]).max() <= 1e-5 * scale


@pytest.mark.parametrize("train", [False, True])
def test_numerical_vf_jacobian_matches_jax(jacobians, train):
    """Central differences over ε = 1e-5 multiply the f32 roundings of two
    forwards by 1/(2ε) = 5e4: JAX's numerical Jacobian is ~1e-2·max|J| from
    its analytic one (7.6e-3 in eval, 1.1e-2 in train BatchNorm). The
    port's must be within half that distance of JAX's (measured: 0.16 of
    it)."""
    j = jacobians[train]
    own_error = np.abs(j["jax_num"] - j["jax"]).max()
    assert np.abs(j["ours_num"] - j["jax_num"]).max() <= 0.5 * own_error
    assert own_error <= 2e-2 * np.abs(j["jax"]).max()


def test_train_mode_jacobian_is_jax_not_the_reference_rows(jacobians):
    """``ROADMAP.md`` §C: under train-mode BatchNorm the broadcast-tangent
    JVPs carry the batch statistics' terms, the reference's per-row
    reverse-mode rows other ones; the port copies JAX. In eval BatchNorm
    all three agree."""
    ev, tr = jacobians[False], jacobians[True]
    scale = np.abs(ev["rows"]).max()
    assert np.abs(ev["ours"] - ev["rows"]).max() <= 1e-5 * scale
    assert np.abs(ev["jax"] - ev["rows"]).max() <= 1e-5 * scale
    gap = np.abs(tr["ours"] - tr["rows"]).max()
    assert gap > 0.5 * np.abs(tr["rows"]).max(), gap
    assert np.abs(tr["ours"] - tr["jax"]).max() <= \
        1e-5 * np.abs(tr["jax"]).max()


def test_directional_derivatives_match_jax():
    rng = np.random.RandomState(5)
    normals = rng.randn(64, 3).astype(np.float32)
    normals[0, :2] = 0.0          # t1 = 0: the 1e-8 floor
    jac = rng.randn(64, 3, 3).astype(np.float32)
    ref = jnetworks.directional_derivatives(jnp.asarray(normals),
                                            jnp.asarray(jac))
    ours = networks.directional_derivatives(torch.from_numpy(normals),
                                            torch.from_numpy(jac))
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------- weight norm


def test_weight_norm_dense_matches_jax():
    """``WeightNormLinear``'s forward and the gradients of g, v and the
    bias against JAX ``WeightNormDense``."""
    rng = np.random.RandomState(6)
    fan_in, fan_out = 13, 7
    v = rng.randn(fan_in, fan_out).astype(np.float32)
    g = rng.uniform(0.5, 2.0, fan_out).astype(np.float32)
    b = rng.randn(fan_out).astype(np.float32)
    x = rng.randn(29, fan_in).astype(np.float32)
    dy = rng.randn(29, fan_out).astype(np.float32)
    dense = jnetworks.WeightNormDense(fan_out, fan_in)
    jparams = {"params": {"v": v, "g": g, "bias": b}}

    def jloss(params):
        return jnp.sum(dense.apply(params, jnp.asarray(x)) * dy)

    ref = dense.apply(jparams, jnp.asarray(x))
    jgrads = jax.grad(jloss)(jparams)["params"]
    layer = networks.WeightNormLinear(fan_in, fan_out, None)
    with torch.no_grad():
        layer.weight_v.copy_(torch.from_numpy(v.T))
        layer.weight_g.copy_(torch.from_numpy(g[:, None]))
        layer.bias.copy_(torch.from_numpy(b))
    out = torch.nn.functional.linear(torch.from_numpy(x), layer.weight,
                                     layer.bias)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **WN_TOL)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(_np(layer.weight_v.grad).T,
                               np.asarray(jgrads["v"]), **WN_TOL)
    np.testing.assert_allclose(_np(layer.weight_g.grad)[:, 0],
                               np.asarray(jgrads["g"]), **WN_TOL)
    np.testing.assert_allclose(_np(layer.bias.grad),
                               np.asarray(jgrads["bias"]), **WN_TOL)


def _weight_norm_config():
    jcfg = graft._tiny_config()
    return dataclasses.replace(
        jcfg,
        vf_net_config=dataclasses.replace(jcfg.vf_net_config,
                                          weight_norm=True),
        rendering_net_config=dataclasses.replace(jcfg.rendering_net_config,
                                                 weight_norm=True))


def test_weight_norm_nets_load_either_layout():
    """Weight-norm nets (no BatchNorm, as JAX builds them): a JAX state
    through ``load_jax_variables``, and a reference-layout state dict
    (``layers.{i}.weight_g`` (out, 1) / ``weight_v`` / ``bias``, written by
    torch's own ``weight_norm``) through ``load_reference_state``, which the
    JAX package reads the same way. The unfolded forward, the folded one
    and JAX's agree."""
    jcfg = _weight_norm_config()
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmods.init_variables(jax.random.PRNGKey(7)))
    assert not variables["batch_stats"]["vf"]
    mods = VFNerfModules(port_config(jcfg))
    assert "layers.0.weight_g" in mods.vf.state_dict()
    assert not any("running" in k for k in mods.vf.state_dict())
    load_jax_variables(mods, variables)
    pts = np.random.RandomState(8).uniform(-1, 1, (53, 3)).astype(
        np.float32)
    ref = jmods.vf_apply(variables, jnp.asarray(pts), train=False)
    ours = mods.vf_apply(torch.from_numpy(pts), False)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **TOL)
    folded = mods.vf_apply_folded(mods.vf.folded_weights(),
                                  torch.from_numpy(pts))
    np.testing.assert_allclose(_np(folded), np.asarray(ref), **TOL)

    # A reference-layout blob from torch's weight_norm Linears.
    torch.manual_seed(9)
    blob = {"epoch": 4, "density": dict(mods.density.state_dict())}
    for key, net in (("vf_net", mods.vf), ("rendering_net", mods.render)):
        ref_layers = torch.nn.ModuleList([
            torch.nn.utils.weight_norm(torch.nn.Linear(
                layer.weight_v.shape[1], layer.weight_v.shape[0]))
            for layer in net.layers])
        blob[key] = {f"module.layers.{k}": v for k, v in
                     ref_layers.state_dict().items()}
    fresh = VFNerfModules(port_config(jcfg))
    assert load_reference_state(fresh, blob) == 5
    n_vf = len(jcfg.vf_net_config.dimensions) + 1
    params, _ = mlp_state_from_torch(blob["vf_net"], n_vf, batch_norm=True,
                                     weight_norm=True)
    jvars = {"params": dict(variables["params"], vf=params),
             "batch_stats": variables["batch_stats"]}
    ref = jmods.vf_apply(jvars, jnp.asarray(pts), train=False)
    ours = fresh.vf_apply(torch.from_numpy(pts), False)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **TOL)
    for i, layer in enumerate(fresh.vf.layers):
        torch.testing.assert_close(layer.weight_g,
                                   blob["vf_net"][f"module.layers.{i}."
                                                  "weight_g"], rtol=0, atol=0)


# ----------------------------------------------------------- NeRF weights


@pytest.mark.parametrize("normalize", [False, True])
def test_nerf_volume_rendering_matches_jax(normalize):
    rng = np.random.RandomState(10)
    z = np.sort(rng.uniform(0.5, 4.0, (12, 24)), axis=1).astype(np.float32)
    density = rng.uniform(0, 30, (12, 24)).astype(np.float32)
    density[:, -1] = 0.0
    density[0] = 0.0                          # an empty ray
    ref = jcompositing.nerf_volume_rendering(jnp.asarray(z),
                                             jnp.asarray(density), normalize)
    ours = compositing.nerf_volume_rendering(torch.from_numpy(z),
                                             torch.from_numpy(density),
                                             normalize)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


# ----------------------------------------------------------- renders


def _render_pair(jcfg, train, dd, n_rays=24, seed=11):
    """JAX ``render_rays`` (unfolded: ``fast_eval`` off) and the port's,
    from the same weights and draws."""
    jmods, variables, mods = _nets(jcfg, seed)
    n_fine = jcfg.ray_sampler_config.n_importance
    jstatics = dataclasses.replace(jrenderer.RenderStatics.from_config(
        jcfg, n_fine=n_fine, train=train, compute_dir_derivatives=dd),
        fast_eval=False)
    uv, pose, intr = camera(n_rays, seed, size=40.0, focal=30.0)
    window = jnp.asarray(jcfg.cos_sim_weights, jnp.float32)
    key = jax.random.PRNGKey(seed)
    ref = jrenderer.render_rays(
        jmods, variables, jnp.asarray(uv), jnp.asarray(pose),
        jnp.asarray(intr), jnp.float32(0.0), jnp.float32(4.0), window, key,
        jstatics)
    statics = RenderStatics.from_config(port_config(jcfg), n_fine=n_fine,
                                        train=train,
                                        compute_dir_derivatives=dd)
    ours = render_rays(mods, torch.from_numpy(uv), torch.from_numpy(pose),
                       torch.from_numpy(intr), 0.0, 4.0,
                       torch.tensor(jcfg.cos_sim_weights), statics,
                       **jax_draws(key, n_rays, statics))
    return ref, ours, mods


def _assert_render(ref, ours):
    for k in ("rgb", "depth", "weights", "z_vals", "normals",
              "sample_colors"):
        np.testing.assert_allclose(_np(ours[k]), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    argmax = ours["argmax_coarse"].numpy()
    assert 0 < (argmax > 0).sum() < argmax.size   # both fine branches


@pytest.mark.parametrize("numerical", [False, True])
def test_unfolded_render_with_directional_derivatives_matches_jax(
        numerical):
    """``render_rays`` in the runner's DD modes: the analytic Jacobian with
    train-mode BatchNorm (the fine passes' running statistics returned;
    DD norms within 1e-4·max, measured 7.6e-7), and the numerical one with
    BatchNorm frozen (JAX's quirk; the port folds). The numerical norms
    carry each forward's f32 roundings × 5e4, and the port's (folded) and
    JAX's (unfolded) roundings differ, so they are held to JAX's analytic
    norms of the same frozen-BatchNorm render: within twice the distance
    of JAX's own numerical norms from them (measured 2.0e-2 of a 7.9 max
    for JAX, 2.2e-2 for the port)."""
    jcfg = dataclasses.replace(graft._tiny_config(),
                               numerical_jacobian=numerical)
    ref, ours, mods = _render_pair(jcfg, train=not numerical, dd=True)
    _assert_render(ref, ours)
    dd, jdd = _np(ours["dir_derivative_norms"]), \
        np.asarray(ref["dir_derivative_norms"])
    assert dd.shape == jdd.shape == (24 * 20 * 2,)
    if numerical:
        analytic, _, _ = _render_pair(
            dataclasses.replace(jcfg, numerical_jacobian=False),
            train=False, dd=True)
        exact = np.asarray(analytic["dir_derivative_norms"])
        own_error = np.abs(jdd - exact).max()
        assert own_error <= 1e-2 * np.abs(exact).max()
        assert np.abs(dd - exact).max() <= 2 * own_error
        assert "batch_stats_updates" not in ours
        return
    assert np.abs(dd - jdd).max() <= 1e-4 * np.abs(jdd).max()
    for net in ("vf", "render"):
        getattr(mods, net).apply_updates(ours["batch_stats_updates"][net])
        _assert_stats(_stats(getattr(mods, net)),
                      ref["batch_stats_updates"][net])


def test_nerf_render_matches_jax():
    jcfg = dataclasses.replace(graft._tiny_config(), rendering="nerf")
    ref, ours, _ = _render_pair(jcfg, train=False, dd=False)
    _assert_render(ref, ours)
