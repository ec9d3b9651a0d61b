"""``device_config.compute_dtype = "bfloat16"`` in the port against the JAX
package, on the CPU.

The JAX package's bf16 reaches its unfolded nets only (flax ``Dense`` and
``BatchNorm`` with ``dtype``); its folded path runs float32 whatever the
dtype, and its weight-norm layers take no dtype. JAX's results are taken
jitted with XLA's excess precision off (``rounded_jit``): each bf16 op
rounded, as the flax code reads and eager JAX runs it; with it on, XLA's
fusions skip roundings and the jitted result moves from eager JAX's as far
as bf16 is from float64. So:

- the VF net in bf16 (eval- and train-mode BatchNorm) and the render on
  each unfolded path (train-mode BatchNorm; ``fast_eval`` off, i.e.
  eval-mode BatchNorm unfolded) are held to JAX's bf16 results, with a
  tolerance stated from both packages' distance to float64 (the port's
  float64 path, which JAX's float32 path matches to 1e-4 in the parity
  tests): the port's bf16 result lies no farther from JAX's than the
  farther of the two lies from float64, and the port no farther from
  float64 than 2 × JAX does. On the net, where no sampling decision
  amplifies a rounding, the port's mean gap to JAX is also under half
  JAX's mean distance to float64: the port follows JAX's roundings, not
  merely bf16;
- weight norm under bf16 is float32 in both packages (rtol 1e-4 / atol
  1e-5);
- one train-mode step in bf16: the loss and gradients held as the render
  is, per tensor relative to its float64 maximum (the Linear biases before
  a train-mode BatchNorm, whose exact gradient is zero, left out), the
  port's worst distance from float64 over all tensors within 2 × JAX's;
- the folded render in bf16 is bit-equal to the float32 render in both
  packages, and the parameters stay float32 after a step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_renderer import make_batch, tiny_config
from test_torch_render import camera, jax_draws, port_config
from test_torch_train_step import (CONFIG, J_CONFIG, J_WEIGHTS, WEIGHTS,
                                   _leaf, jax_step_draws)
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.parallel import train_step as jtrain
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.parallel import train_step
from vf_nerf_torch.utils.weights import jax_param_paths, load_jax_variables

N_RAYS = 48
CAM = camera(N_RAYS, 1, size=40.0, focal=30.0)
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def configs(weight_norm=False):
    """(JAX f32 config, JAX bf16 config)."""
    jcfg = tiny_config()
    if weight_norm:
        jcfg = dataclasses.replace(
            jcfg,
            vf_net_config=dataclasses.replace(
                jcfg.vf_net_config, weight_norm=True, batch_norm=False),
            rendering_net_config=dataclasses.replace(
                jcfg.rendering_net_config, weight_norm=True,
                batch_norm=False))
    return jcfg, dataclasses.replace(jcfg, device_config=dataclasses.replace(
        jcfg.device_config, compute_dtype="bfloat16"))


def jax_setup(jcfg, seed=0, gain=5.0):
    """JAX variables (numpy), the VF kernels (or weight norm's g) × gain
    (at 5, ~80 % of the rays render a surface in both BatchNorm modes),
    BatchNorm statistics randomized so eval mode does real work."""
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmods.init_variables(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 1)
    for scope in variables["params"]["vf"].values():
        if "Dense_0" in scope:
            scope["Dense_0"]["kernel"] = scope["Dense_0"]["kernel"] * gain
        else:
            scope["WeightNormDense_0"]["g"] = \
                scope["WeightNormDense_0"]["g"] * gain
    for net in ("vf", "render"):
        for stats in variables["batch_stats"][net].values():
            bn = stats["BatchNorm_0"]
            bn["mean"] = rng.uniform(-0.1, 0.1, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.8, 1.2, bn["var"].shape).astype(
                np.float32)
    return variables


def rounded_jit(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off: every bf16
    op's result rounded to bf16, as the flax code reads and as eager JAX
    runs it (with it on, XLA's fusions skip roundings and move the result
    as far as bf16 itself does)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def port_modules(jcfg, variables, train=False, double=False):
    mods = VFNerfModules(port_config(jcfg))
    load_jax_variables(mods, variables)
    mods.train(train)
    return mods.double() if double else mods


def gaps(ours, jax_out, exact):
    """(max |port − JAX|, max |port − f64|, max |JAX − f64|)."""
    o, j, e = (np.asarray(a, np.float64) for a in (ours, jax_out, exact))
    return (float(np.abs(o - j).max()), float(np.abs(o - e).max()),
            float(np.abs(j - e).max()))


def assert_follows_jax(ours, jax_out, exact, what):
    """The gap to JAX within the larger distance to float64, the port's
    distance within 2 × JAX's."""
    gap, d_port, d_jax = gaps(ours, jax_out, exact)
    assert d_port > 0 and d_jax > 0, f"{what}: no bf16 rounding happened"
    assert gap <= max(d_port, d_jax), (what, gap, d_port, d_jax)
    assert d_port <= 2.0 * d_jax, (what, d_port, d_jax)


@pytest.mark.parametrize("train", [False, True])
def test_vf_net_follows_jax_bf16(train):
    jcfg, jcfg_bf = configs()
    variables = jax_setup(jcfg)
    pts = np.random.RandomState(0).uniform(-1, 1, (4000, 3)).astype(
        np.float32)
    jmods = jrenderer.VFNerfModules(jcfg_bf, compute_dtype="bfloat16")
    ref = np.asarray(rounded_jit(
        lambda v, p: jmods.vf_apply(v, p, train=train), variables,
        jnp.asarray(pts)))
    with torch.no_grad():
        out = port_modules(jcfg_bf, variables).vf_apply(
            torch.from_numpy(pts), train)
        exact = port_modules(jcfg, variables, double=True).vf_apply(
            torch.from_numpy(pts).double(), train)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert_follows_jax(out, ref, exact, f"vf net train={train}")
    mean_gap = float(np.abs(out.numpy() - ref).mean())
    mean_jax = float(np.abs(ref - exact.numpy()).mean())
    assert mean_gap <= 0.5 * mean_jax, (mean_gap, mean_jax)


def renders(jcfg, jcfg_bf, variables, train, fast_eval):
    """(port bf16, JAX bf16, port f64) renders of the same rays and
    draws."""
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(jcfg, n_fine=6, train=train),
        fast_eval=fast_eval)
    key = jax.random.PRNGKey(2)
    jargs = tuple(jnp.asarray(a) for a in CAM) + (jnp.float32(0.0),
                                                   jnp.float32(4.0))
    jmods = jrenderer.VFNerfModules(jcfg_bf, compute_dtype="bfloat16")
    ref = rounded_jit(lambda v, *a: jrenderer.render_rays(jmods, v, *a,
                                                          jstatics),
                      variables, *jargs,
                      jnp.asarray(jcfg.cos_sim_weights, jnp.float32), key)
    statics = dataclasses.replace(
        RenderStatics.from_config(port_config(jcfg), n_fine=6, train=train),
        fast_eval=fast_eval)
    draws = jax_draws(key, N_RAYS, statics)
    outs = []
    for mods, dtype in ((port_modules(jcfg_bf, variables, train),
                         torch.float32),
                        (port_modules(jcfg, variables, train, True),
                         torch.float64)):
        args = [torch.from_numpy(a).to(dtype) for a in CAM]
        outs.append(render_rays(
            mods, *args, 0.0, 4.0,
            torch.tensor(jcfg.cos_sim_weights).to(dtype), statics,
            **{k: v.to(dtype) for k, v in draws.items()}))
    return outs[0], {k: np.asarray(v) for k, v in ref.items()
                     if not isinstance(v, dict)}, outs[1]


@pytest.mark.parametrize("path", ["train_mode_bn", "fast_eval_off"])
def test_unfolded_bf16_render_follows_jax(path):
    jcfg, jcfg_bf = configs()
    variables = jax_setup(jcfg)
    ours, ref, exact = renders(jcfg, jcfg_bf, variables,
                               train=path == "train_mode_bn",
                               fast_eval=path == "train_mode_bn")
    assert ours["rgb"].dtype == ours["depth"].dtype == torch.float32
    # Rays whose fine depths all three share (a coarse argmax moved by a
    # rounding picks other depths; those rays are not comparable).
    same = (np.abs(ours["z_vals"].numpy() - ref["z_vals"]).max(1) <= 1e-6) \
        & (np.abs(exact["z_vals"].numpy() - ref["z_vals"]).max(1) <= 1e-5)
    assert same.mean() >= 0.9, same.mean()
    assert (ref["weights"][same].sum(1) > 0.5).mean() > 0.5   # surfaces
    for k in ("rgb", "depth"):
        assert_follows_jax(ours[k].numpy()[same], ref[k][same],
                           exact[k].numpy()[same], f"{path} {k}")


def test_weight_norm_is_float32_under_bf16_in_both_packages():
    jcfg, jcfg_bf = configs(weight_norm=True)
    variables = jax_setup(jcfg)
    ours, ref, _ = renders(jcfg, jcfg_bf, variables, train=False,
                           fast_eval=True)
    for k in ("rgb", "depth", "z_vals", "normals", "weights"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], err_msg=k,
                                   **F32_TOL)


def test_folded_render_is_bit_equal_to_float32_in_both_packages():
    jcfg, jcfg_bf = configs()
    variables = jax_setup(jcfg)
    jstatics = jrenderer.RenderStatics.from_config(jcfg, n_fine=6,
                                                   train=False)
    jargs = tuple(jnp.asarray(a) for a in CAM) + (
        jnp.float32(0.0), jnp.float32(4.0),
        jnp.asarray(jcfg.cos_sim_weights, jnp.float32),
        jax.random.PRNGKey(5), jstatics)
    j32, j16 = (jax.jit(functools.partial(
        jrenderer.render_rays, jrenderer.VFNerfModules(
            c, compute_dtype=c.device_config.compute_dtype)),
        static_argnums=(8,))(variables, *jargs) for c in (jcfg, jcfg_bf))
    statics = RenderStatics.from_config(port_config(jcfg), n_fine=6,
                                        train=False)
    p32, p16 = (render_rays(
        port_modules(c, variables), *[torch.from_numpy(a) for a in CAM],
        0.0, 4.0, torch.tensor(jcfg.cos_sim_weights), statics,
        generator=torch.Generator().manual_seed(1)) for c in (jcfg, jcfg_bf))
    for k in ("rgb", "depth", "z_vals", "normals", "weights"):
        np.testing.assert_array_equal(np.asarray(j16[k]), np.asarray(j32[k]))
        torch.testing.assert_close(p16[k], p32[k], rtol=0, atol=0)


def test_train_mode_step_in_bf16_follows_jax():
    """Loss and gradients of one train-mode step (BatchNorm on batch
    statistics, no directional derivative) in bf16, against JAX's bf16
    loss closure, each package's distance measured to the port's float64
    step; then the step itself keeps the parameters in float32."""
    jcfg, jcfg_bf = configs()
    variables = jax_setup(jcfg, gain=2.5)
    jmods = jrenderer.VFNerfModules(jcfg_bf, compute_dtype="bfloat16")
    jstatics = jrenderer.RenderStatics.from_config(jcfg, n_fine=6,
                                                   train=True)
    jsup = jtrain.SupervisionStatics.from_config(
        jcfg, "exterior_synthetic", n_rays=16,
        n_samples=jstatics.n_coarse + jstatics.n_fine, border_radius=0.15)
    ds, jbatch = make_batch(16)
    near, far = ds.get_bounds()
    draws, k_render, k_sup = jax_step_draws(jax.random.PRNGKey(3), 0, 16,
                                            jstatics, jsup)
    jloss = jtrain.make_loss_fn(jmods, jstatics, jsup, J_WEIGHTS, J_CONFIG)

    def f(params):
        return jloss(params, variables["batch_stats"], jbatch, k_render,
                     k_sup, jnp.asarray(0, jnp.int32),
                     jnp.asarray(jcfg.cos_sim_weights), jnp.float32(near),
                     jnp.float32(far), jnp.zeros(3))[0]

    j_loss, j_grads = rounded_jit(jax.value_and_grad(f),
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    statics = RenderStatics.from_config(port_config(jcfg), n_fine=6,
                                        train=True)
    sup = train_step.SupervisionStatics(**dataclasses.asdict(jsup))
    results = []
    for mods, dtype in ((port_modules(jcfg_bf, variables, True),
                         torch.float32),
                        (port_modules(jcfg, variables, True, True),
                         torch.float64)):
        loss_fn = train_step.make_loss_fn(mods, statics, sup, WEIGHTS,
                                          CONFIG)
        batch = {k: torch.from_numpy(np.array(v)).to(dtype)
                 for k, v in jbatch.items()}
        total, _, _ = loss_fn(
            batch, {k: v.to(dtype) for k, v in draws.items()}, 0,
            torch.tensor(jcfg.cos_sim_weights, dtype=dtype), float(near),
            float(np.float32(far)), torch.zeros(3, dtype=dtype))
        paths = jax_param_paths(mods)
        grads = torch.autograd.grad(total, [p for _, p, _ in paths])
        results.append((float(total), paths, grads))
    (loss, paths, grads), (loss64, _, grads64) = results

    d_loss = (abs(loss - float(j_loss)), abs(loss - loss64),
              abs(float(j_loss) - loss64))
    assert d_loss[0] <= max(d_loss[1], d_loss[2]), d_loss
    assert d_loss[1] <= 2.0 * d_loss[2], d_loss
    biases_before_bn = {path for path, _, _ in paths
                        if path[-1] == "bias" and "Dense_0" in path and
                        "BatchNorm_0" in variables["params"][path[0]][
                            path[1]]}
    worst = {}
    for (path, _, transpose), g, g64 in zip(paths, grads, grads64):
        if path in biases_before_bn:
            continue
        ref = np.asarray(_leaf(j_grads, path), np.float64)
        ref = ref.T if transpose else ref
        scale = float(g64.abs().max())
        rel = [float(np.abs(a - b).max()) / scale for a, b in (
            (g.double().numpy(), ref), (g.double().numpy(), g64.numpy()),
            (ref, g64.numpy()))]
        worst[path] = rel
        assert rel[0] <= max(rel[1], rel[2]), (path, rel)
    assert len(worst) > 10
    # Over all tensors, the port's worst distance from float64 within 2 ×
    # JAX's (one scalar's gradient sums every sample's roundings, so a
    # single tensor may land either side).
    assert max(r[1] for r in worst.values()) <= \
        2.0 * max(r[2] for r in worst.values()), worst

    model = VectorFieldNerf(port_config(jcfg_bf), device="cpu")
    model.train()
    step = train_step.make_train_step(model.modules, model.optimizer,
                                      statics, sup, WEIGHTS, CONFIG)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    step(train_step.zero_metric_sums("cpu"), batch, 0,
         torch.tensor(jcfg.cos_sim_weights), float(near),
         float(np.float32(far)), torch.zeros(3), draws=draws)
    assert all(p.dtype == torch.float32 for p in model.modules.parameters())
    assert all(b.dtype == torch.float32 for n, b in
               model.modules.named_buffers() if "running" in n)
    assert all(torch.isfinite(p).all() for p in model.modules.parameters())


def test_numerical_jacobian_vanishes_in_bf16_as_in_jax():
    """Under bf16 the numerical Jacobian's ±1e-5 steps vanish where the
    first Linear rounds its input to bf16 (resolution 2⁻⁸), so most
    differences are exactly 0 and the rest are one-ulp jumps over 2e-5, in
    both packages (ROADMAP.md §C, a JAX behaviour the port copies): the
    share of zero norms within 0.03 of JAX's and above one half, at least
    3/4 of the norms equal to JAX's, where in float32 almost none is 0."""
    zeros = {}
    for bf16 in (True, False):
        jcfg, jcfg_bf = configs()
        jcfg, jcfg_bf = (dataclasses.replace(c, numerical_jacobian=True)
                         for c in (jcfg, jcfg_bf))
        cfg = jcfg_bf if bf16 else jcfg
        variables = jax_setup(jcfg)
        jstatics = jrenderer.RenderStatics.from_config(
            jcfg, n_fine=6, train=False, compute_dir_derivatives=True)
        key = jax.random.PRNGKey(2)
        jmods = jrenderer.VFNerfModules(
            cfg, compute_dtype=cfg.device_config.compute_dtype)
        ref = rounded_jit(
            lambda v, *a: jrenderer.render_rays(jmods, v, *a, jstatics),
            variables, *(jnp.asarray(a) for a in CAM), jnp.float32(0.0),
            jnp.float32(4.0), jnp.asarray(jcfg.cos_sim_weights, jnp.float32),
            key)
        statics = RenderStatics.from_config(port_config(cfg), n_fine=6,
                                            train=False,
                                            compute_dir_derivatives=True)
        ours = render_rays(port_modules(cfg, variables),
                           *[torch.from_numpy(a) for a in CAM], 0.0, 4.0,
                           torch.tensor(jcfg.cos_sim_weights), statics,
                           **jax_draws(key, N_RAYS, statics))
        j = np.asarray(ref["dir_derivative_norms"])
        o = ours["dir_derivative_norms"].numpy()
        zeros[bf16] = ((j == 0).mean(), (o == 0).mean(), (j == o).mean())
    jax_zeros, port_zeros, equal = zeros[True]
    assert jax_zeros > 0.5 and abs(port_zeros - jax_zeros) <= 0.03, zeros
    assert equal >= 0.75, zeros
    assert zeros[False][0] < 0.05 and zeros[False][1] < 0.05, zeros
