"""The port's training step against the JAX package's, on the CPU.

The tiny config of ``__graft_entry__._tiny_config`` (2×32 nets, 16 rays,
16 coarse samples, 4 fine ones or 16 padded fine ones with 4 live, so
S = 20 or 32), the JAX package's own initial weights with the VF kernels
scaled by 2.5 (87.5 % of the rays render a surface, both fine-sampler
branches occur) and BatchNorm statistics and affine parameters randomized
so the fold does real work. For each case, two steps: at step k the JAX
``TrainState`` after k steps is carried into the port
(``load_jax_train_state``: weights, Adam moments, count), the port's loss
and gradients are held to JAX ``make_loss_fn`` under ``jax.value_and_grad``,
the port's optimizer fed JAX's gradients is held to JAX's optimizer, and the
port's whole ``make_train_step`` is held to JAX ``make_train_step``. JAX's
draws (``fold_in(base_key, step)``, split as the JAX step splits it) are
passed in.

The oracle is JAX with ``fast_eval=False``: the JAX folded path ignores
``rendering.detach_normals`` (``ROADMAP.md`` §C), which the port honours;
``test_detach_normals_deviation`` pins that.

Tolerances: loss parts rtol 1e-5; gradients max|Δ| ≤ 1e-4·max|g| + 1e-7
per leaf (f32 chains of another order, the fold against run-time
BatchNorm); the optimizer update from identical gradients rtol 1e-6 with
atol 1e-6·max|u| per leaf (the first moment cancels on some elements at the
second step); parameters after a whole step within 1 % of one learning-rate
step of JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_renderer import make_batch
from test_torch_render import jax_variables, port_config
from vf_nerf_tpu.config.schema import VFLossConfig as JLossConfig
from vf_nerf_tpu.config.schema import VFLossWeights as JLossWeights
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.models.nerf import TrainState
from vf_nerf_tpu.models.nerf import make_optimizer as jmake_optimizer
from vf_nerf_tpu.ops import samplers as jsamplers
from vf_nerf_tpu.parallel import train_step as jtrain
from vf_nerf_torch.config import schema
from vf_nerf_torch.models.nerf import (VectorFieldNerf, make_optimizer,
                                       param_groups)
from vf_nerf_torch.models.renderer import RenderStatics, render_rays
from vf_nerf_torch.parallel import train_step
from vf_nerf_torch.utils.weights import (jax_param_paths, load_jax_train_state,
                                         load_jax_variables)

N_RAYS = 16
GAIN = 2.5
DECAY_STEPS = 100
J_WEIGHTS = JLossWeights(rgb=2.0, depth=0.5, unit_norm=0.1, supervision=1.0,
                         norm_smaller_than_one=0.1,
                         directional_derivatives=0.0)
J_CONFIG = JLossConfig(norm_smaller_than_one_start=11000,
                       depth_loss_clamp=0.5, directional_derivatives_start=100)
WEIGHTS = schema.VFLossWeights(**dataclasses.asdict(J_WEIGHTS))
CONFIG = schema.VFLossConfig(**dataclasses.asdict(J_CONFIG))
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
CASES = [  # (duplicate_vf, static fine growth, init method)
    (True, True, "exterior_synthetic"),
    (False, True, "exterior_synthetic"),
    (True, False, "center"),
    (False, False, "exterior_synthetic"),
    (True, True, "center"),
]


def _leaf(tree, path):
    for key in path:
        tree = tree[key] if isinstance(tree, dict) else getattr(tree, key)
    return np.asarray(tree)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_variables(jcfg, seed=0):
    """JAX init, VF kernels ×2.5, BatchNorm statistics and affine
    parameters randomized."""
    jmods, variables = jax_variables(jcfg, seed, GAIN)
    rng = np.random.RandomState(seed + 11)
    for net in ("vf", "render"):
        for name, scope in variables["params"][net].items():
            if "BatchNorm_0" not in scope:
                continue
            bn = scope["BatchNorm_0"]
            bn["scale"] = rng.uniform(0.8, 1.2, bn["scale"].shape).astype(
                np.float32)
            bn["bias"] = rng.uniform(-0.1, 0.1, bn["bias"].shape).astype(
                np.float32)
            stats = variables["batch_stats"][net][name]["BatchNorm_0"]
            stats["mean"] = rng.uniform(-0.1, 0.1, stats["mean"].shape
                                        ).astype(np.float32)
            stats["var"] = rng.uniform(0.8, 1.2, stats["var"].shape).astype(
                np.float32)
    return jmods, variables


def jax_step_draws(base_key, step, n_rays, jstatics, jsup):
    """The draws of JAX step ``step``, as (port draws, k_render, k_sup)."""
    key = jax.random.fold_in(base_key, step)
    k_render, k_sup = jax.random.split(key)
    k_coarse, k_fine = jax.random.split(k_render)
    k_strat, k_rand = jax.random.split(k_fine)
    draws = {
        "t_coarse": jax.random.uniform(k_coarse, (n_rays, jstatics.n_coarse),
                                       jnp.float32),
        "t_fine": jsamplers._column_uniform(k_strat, n_rays, jstatics.n_fine,
                                            jnp.float32),
        "u_extra": jsamplers._column_uniform(k_rand, n_rays, jstatics.n_fine,
                                             jnp.float32),
    }
    k_border, k_center = jax.random.split(k_sup)
    for name, k in (("border", k_border), ("center", k_center)):
        k_phi, k_cos, k_u = jax.random.split(k, 3)
        n = jsup.n_points
        draws[name] = jnp.stack([
            jax.random.uniform(k_phi, (n,), jnp.float32, 0.0, 2.0 * jnp.pi),
            jax.random.uniform(k_cos, (n,), jnp.float32, -1.0, 1.0),
            jax.random.uniform(k_u, (n,), jnp.float32)], axis=1)
    return ({k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
            k_render, k_sup)


def _compare_grads(paths, ours, ref_tree):
    for (path, _, transpose), g in zip(paths, ours):
        ref = _leaf(ref_tree, path)
        ref = ref.T if transpose else ref
        err = float(np.abs(g.detach().numpy() - ref).max())
        tol = GRAD_TOL * float(np.abs(ref).max()) + 1e-7
        assert err <= tol, f"grad {path}: max |Δ| {err} > {tol}"


def port_update(model, paths, j_grads):
    """The port optimizer's update from the JAX gradient tree ``j_grads``:
    a step on zero parameters (at weight decay 0 the update does not read
    them)."""
    groups = param_groups(model.modules)
    where = {id(p): (k, i) for k, v in groups.items() for i, p in enumerate(v)}
    fed = {k: [None] * len(v) for k, v in groups.items()}
    update = {k: [torch.zeros_like(p) for p in v] for k, v in groups.items()}
    for path, p, transpose in paths:
        k, i = where[id(p)]
        ref = _leaf(j_grads, path)
        fed[k][i] = torch.from_numpy(np.array(ref.T if transpose else ref))
    model.optimizer.step(update, fed)
    return {path: update[where[id(p)][0]][where[id(p)][1]].numpy()
            for path, p, _ in paths}


def _run_case(duplicate_vf, static, init_method):
    """Two steps of both packages; returns what the tests assert on."""
    jcfg = graft._tiny_config()
    jmods, variables = tiny_variables(jcfg)
    jopt, _ = jmake_optimizer(jcfg.scheduler_config, decay_steps=DECAY_STEPS,
                              duplicate_vf=duplicate_vf)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    rs = jcfg.ray_sampler_config
    n_fine = rs.max_samples if static else rs.n_importance
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(jcfg, n_fine=n_fine,
                                            train=False), fast_eval=False)
    jsup = jtrain.SupervisionStatics.from_config(
        jcfg, init_method, n_rays=N_RAYS,
        n_samples=jstatics.n_coarse + jstatics.n_fine, border_radius=0.15)
    n_fine_active = rs.n_importance if static else None
    n_points_active = None if not static else max(
        (N_RAYS * (jstatics.n_coarse + n_fine_active)) // 10, 1)
    ds, jbatch = make_batch(N_RAYS)
    near, far = ds.get_bounds()
    window = jnp.asarray(jcfg.cos_sim_weights)
    base_key = jax.random.PRNGKey(3)
    fine_kw = {} if not static else {
        "n_fine_active": jnp.asarray(n_fine_active, jnp.int32)}
    jstep = jtrain.make_train_step(jmods, jopt, jstatics, jsup, J_WEIGHTS,
                                   J_CONFIG)
    jloss = jtrain.make_loss_fn(jmods, jstatics, jsup, J_WEIGHTS, J_CONFIG)
    # Jitted, as the step runs it: eager JAX takes ``b ** count`` by
    # repeated multiplication (0.999³ = 0.9970031, jitted 0.997003), and
    # 1 − 0.999ᵗ carries that ulp into the update at 1e-5.
    j_update = jax.jit(jopt.update)

    @jax.jit
    def jax_value_and_grad(state, k_render, k_sup):
        def f(p):
            return jloss(p, state.batch_stats, jbatch, k_render, k_sup,
                         jnp.asarray(0, jnp.int32), window, jnp.float32(near),
                         jnp.float32(far), jnp.zeros(3),
                         n_points_active=None if not static else
                         jnp.asarray(n_points_active, jnp.int32), **fine_kw)
        return jax.value_and_grad(f, has_aux=True)(state.params)

    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, device="cpu", decay_steps=DECAY_STEPS)
    model.optimizer, model.lr_schedule = make_optimizer(
        cfg.scheduler_config, DECAY_STEPS, duplicate_vf=duplicate_vf)
    model.optimizer.init(param_groups(model.modules))
    statics = RenderStatics.from_config(cfg, n_fine=n_fine, train=False)
    sup = train_step.SupervisionStatics(**dataclasses.asdict(jsup))
    loss_fn = train_step.make_loss_fn(model.modules, statics, sup, WEIGHTS,
                                      CONFIG)
    step_fn = train_step.make_train_step(model.modules, model.optimizer,
                                         statics, sup, WEIGHTS, CONFIG)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    taps = torch.tensor(jcfg.cos_sim_weights, dtype=torch.float32)
    port_args = (0, taps, float(near), float(np.float32(far)), torch.zeros(3))
    paths = jax_param_paths(model.modules)

    steps = []
    for k in range(2):
        draws, k_render, k_sup = jax_step_draws(base_key, k, N_RAYS, jstatics,
                                                jsup)
        load_jax_train_state(model, _host(state))
        (j_total, (j_parts, _)), j_grads = jax_value_and_grad(state, k_render,
                                                              k_sup)
        total, parts, out = loss_fn(batch, draws, *port_args, n_fine_active,
                                    n_points_active)
        grads = torch.autograd.grad(total, [p for _, p, _ in paths])

        # The port's optimizer fed JAX's gradients, as they are (the clip
        # acts) and scaled to a quarter of the clip norm (it does not).
        norm = np.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                           for x in jax.tree_util.tree_leaves(j_grads)))
        quiet = jax.tree_util.tree_map(
            lambda g: g * np.float32(0.125 * jcfg.scheduler_config.clip_norm
                                     / norm), j_grads)
        updates = {}
        for name, fed in (("clipped", j_grads), ("unclipped", quiet)):
            load_jax_train_state(model, _host(state))
            updates[name] = (port_update(model, paths, fed),
                             _host(j_update(fed, state.opt_state,
                                            state.params)[0]))

        load_jax_train_state(model, _host(state))
        sums = step_fn(train_step.zero_metric_sums("cpu"), batch,
                       *port_args, n_fine_active=n_fine_active, draws=draws)
        state, j_sums = jstep(state, jtrain.zero_metric_sums(), jbatch,
                              base_key, jnp.asarray(0, jnp.int32), window,
                              jnp.float32(near), jnp.float32(far),
                              jnp.zeros(3), **fine_kw)
        steps.append(dict(
            total=float(total.detach()),
            parts={k: float(v.detach()) for k, v in parts.items()},
            j_total=float(j_total),
            j_parts={k: float(v) for k, v in j_parts.items()},
            grads=grads, j_grads=_host(j_grads), updates=updates,
            params={path: p.detach().numpy().copy() for path, p, _ in paths},
            j_params=_host(state.params), count=model.optimizer.count,
            j_count=int(state.step),
            sums={k: float(v) for k, v in sums.items()},
            j_sums={k: float(v) for k, v in j_sums.items()},
            weights=out["weights"].detach(), argmax=out["argmax_coarse"],
            sample_mask=out.get("sample_mask")))
    return dict(paths=paths, steps=steps, lr=model.lr_schedule(0))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"dup{int(d)}-static{int(s)}-{m}" for d, s, m in CASES])
def case(request):
    return _run_case(*request.param)


def test_loss_parts_match_jax(case):
    for k, step in enumerate(case["steps"]):
        np.testing.assert_allclose(step["total"], step["j_total"],
                                   rtol=LOSS_RTOL, err_msg=f"step {k}")
        for name, value in step["parts"].items():
            np.testing.assert_allclose(value, step["j_parts"][name],
                                       rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=f"step {k} {name}")


def test_gradients_match_jax(case):
    for step in case["steps"]:
        _compare_grads(case["paths"], step["grads"], step["j_grads"])
        # Real surfaces were rendered, and both fine-sampler branches ran.
        assert float((step["weights"].sum(1) > 0.5).float().mean()) > 0.5
        assert 0 < int((step["argmax"] > 0).sum()) < N_RAYS


@pytest.mark.parametrize("clip,rtol", [("unclipped", 1e-6),
                                       ("clipped", 1e-5)])
def test_optimizer_update_matches_jax(case, clip, rtol):
    """From identical gradients, at Adam counts 1 and 2 (duplicate VF: 1, 2
    then 3, 4). With the clip acting, its coefficient comes from an f32 sum
    of squares over ~5,000 gradients that XLA and PyTorch take in another
    order (~√n·2⁻²⁴ ≈ 4e-6 apart), and where |g| is near Adam's eps the
    update carries that difference: rtol 1e-5 there."""
    for step in case["steps"]:
        ours, ref_tree = step["updates"][clip]
        for path, _, transpose in case["paths"]:
            ref = _leaf(ref_tree, path)
            ref = ref.T if transpose else ref
            np.testing.assert_allclose(
                ours[path], ref, rtol=rtol,
                atol=1e-6 * float(np.abs(ref).max()), err_msg=str(path))


def test_whole_step_matches_jax(case):
    for k, step in enumerate(case["steps"]):
        assert step["count"] == step["j_count"] == k + 1
        for name, value in step["sums"].items():
            np.testing.assert_allclose(value, step["j_sums"][name],
                                       rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=f"step {k} {name}")
        for path, _, transpose in case["paths"]:
            ref = _leaf(step["j_params"], path)
            np.testing.assert_allclose(step["params"][path],
                                       ref.T if transpose else ref, rtol=0,
                                       atol=1e-2 * case["lr"],
                                       err_msg=f"step {k} {path}")


def _mean_rgb_vf_grads(detach_normals):
    """d mean(rgb) / d VF params of the port, JAX unfolded and JAX
    folded, on 16 rays of the tiny config."""
    jcfg = graft._tiny_config()
    jcfg = dataclasses.replace(jcfg, rendering_net_config=dataclasses.replace(
        jcfg.rendering_net_config, detach_normals=detach_normals))
    jmods, variables = tiny_variables(jcfg, seed=1)
    _, jbatch = make_batch(N_RAYS)
    near, far = 0.0, 4.0
    window = jnp.asarray(jcfg.cos_sim_weights)
    key = jax.random.PRNGKey(5)
    jstatics = jrenderer.RenderStatics.from_config(
        jcfg, n_fine=jcfg.ray_sampler_config.n_importance, train=False)

    def jax_grad(fast):
        statics = dataclasses.replace(jstatics, fast_eval=fast)

        def f(vf):
            p = dict(variables["params"], vf=vf)
            out = jrenderer.render_rays(
                jmods, {"params": p, "batch_stats": variables["batch_stats"]},
                jbatch["uv"], jbatch["pose"], jbatch["intrinsics"],
                jnp.float32(near), jnp.float32(far), window, key, statics)
            return jnp.mean(out["rgb"])
        return _host(jax.jit(jax.grad(f))(variables["params"]["vf"]))

    cfg = port_config(jcfg)
    from vf_nerf_torch.models.renderer import VFNerfModules
    mods = VFNerfModules(cfg).eval()
    load_jax_variables(mods, variables)
    statics = RenderStatics.from_config(
        cfg, n_fine=cfg.ray_sampler_config.n_importance, train=False)
    from test_torch_render import jax_draws
    out = render_rays(mods, *(torch.from_numpy(np.array(jbatch[k]))
                              for k in ("uv", "pose", "intrinsics")),
                      near, far, torch.tensor(cfg.cos_sim_weights), statics,
                      grad=True, **jax_draws(key, N_RAYS, statics))
    paths = [(path[1:], p, t) for path, p, t in jax_param_paths(mods)
             if path[0] == "vf"]
    grads = torch.autograd.grad(out["rgb"].mean(), [p for _, p, _ in paths])
    return paths, grads, jax_grad(False), jax_grad(True)


@pytest.mark.parametrize("detach_normals", [True, False])
def test_detach_normals_deviation(detach_normals):
    """With ``detach_normals`` on (the shipped conf), the port's VF
    gradients of mean(rgb) equal JAX's unfolded path and differ from its
    folded path, which lets the colour's gradient into the normals; with it
    off they equal both."""
    paths, grads, unfolded, folded = _mean_rgb_vf_grads(detach_normals)
    _compare_grads(paths, grads, unfolded)
    gaps = []
    for (path, _, transpose), g in zip(paths, grads):
        ref = _leaf(folded, path)
        ref = ref.T if transpose else ref
        gaps.append(float(np.abs(g.numpy() - ref).max()) /
                    float(np.abs(ref).max()))
    if detach_normals:
        assert max(gaps) > 1e-2, gaps
    else:
        _compare_grads(paths, grads, folded)


def test_port_step_draws_from_its_generator():
    """The port alone: the facade's generator supplies a step's draws in
    ``draw_step``'s order, a packed batch unpacks as the dict, and ten
    steps on one batch lower the loss."""
    jcfg = graft._tiny_config()
    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, seed=3, device="cpu",
                            decay_steps=DECAY_STEPS)
    _, variables = tiny_variables(jcfg)
    load_jax_variables(model, variables)
    statics = model.render_statics(n_fine=cfg.ray_sampler_config.max_samples)
    sup = train_step.SupervisionStatics.from_config(
        cfg, "exterior_synthetic", N_RAYS,
        statics.n_coarse + statics.n_fine, 0.15)
    step = train_step.make_train_step(model.modules, model.optimizer,
                                      statics, sup, WEIGHTS, CONFIG)
    ds, jbatch = make_batch(N_RAYS)
    packed = train_step.pack_batch({k: np.asarray(v)
                                    for k, v in jbatch.items()})
    np.testing.assert_array_equal(
        packed, jtrain.pack_batch({k: np.asarray(v)
                                   for k, v in jbatch.items()}))
    unpacked = train_step.unpack_batch(torch.from_numpy(packed))
    for k, v in unpacked.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]))
    _, far = ds.get_bounds()
    args = (torch.tensor(cfg.cos_sim_weights), 0.0, float(far),
            torch.zeros(3))

    model.generator.manual_seed(7)
    first = step(train_step.zero_metric_sums("cpu"),
                 torch.from_numpy(packed), 0, *args, n_fine_active=4,
                 generator=model.generator)
    model.generator.manual_seed(7)
    replay = train_step.draw_step(statics, sup, N_RAYS, model.generator,
                                  "cpu")
    assert set(first) == set(train_step.METRIC_KEYS)
    assert replay["border"].shape == (sup.n_points, 3)
    losses = [float(first["loss"])]
    for _ in range(9):
        sums = step(train_step.zero_metric_sums("cpu"),
                    torch.from_numpy(packed), 0, *args, n_fine_active=4,
                    generator=model.generator)
        losses.append(float(sums["loss"]))
    assert model.step == 10
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
