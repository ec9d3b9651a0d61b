"""The port's training step in its unfolded modes against the JAX
package's, on the CPU.

The tiny config of ``__graft_entry__._tiny_config`` (2×32 nets, 16 rays, 16
coarse samples and 4 fine ones, or a fine axis padded to 16 with 4 live),
weights as in ``test_torch_train_step``, and per mode two steps: at step k
the JAX ``TrainState`` after k steps is carried into the port, the port's
loss and gradients are held to JAX ``make_loss_fn`` under
``jax.value_and_grad``, and the port's whole ``make_train_step`` to JAX
``make_train_step``, whose BatchNorm updates it keeps after the optimizer.
JAX's draws are passed in. Modes:

- ``analytic``: the directional-derivative (DD) weight 0.1 at its start
  epoch, train-mode BatchNorm (the runner's ``model.train()``), the
  forward-mode Jacobian; no static fine growth (the runner turns it off
  under DD);
- ``numerical``: the same with ``numerical_jacobian``, which keeps
  BatchNorm frozen;
- ``before_start``: the analytic mode one epoch before the DD start (the
  term is zero, BatchNorm still trains);
- ``weight_norm``: both nets under weight norm, DD off, static fine growth;
- ``nerf``: ``rendering = "nerf"``, DD off, static fine growth.

Tolerances: the loss and its parts rtol 1e-4; gradients max|Δ| ≤
1e-4·max|g| + 1e-7 per tensor (``test_torch_train_step``'s); the running
statistics after a step rtol 1e-5 / atol 1e-7 (flax's E[x²] − E[x]²
against ``torch.var_mean``); parameters after a whole step within 1 % of
one learning-rate step, except where a gradient is rounding noise in both
packages or, in the numerical mode, the central differences' (see
``_compared``). The numerical mode's central differences multiply
each f32 rounding by 5e4, and the port's folded nets round otherwise than
JAX's unfolded ones, so its loss, DD part and gradients are held to JAX's
analytic Jacobian on the same frozen-BatchNorm step, within twice the
distance of JAX's own numerical step from it (and never tighter than the
rules above).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_renderer import make_batch
from test_torch_render import port_config
from test_torch_train_step import (J_CONFIG, J_WEIGHTS, _host, _leaf,
                                   jax_step_draws, tiny_variables)
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.models.nerf import TrainState
from vf_nerf_tpu.models.nerf import make_optimizer as jmake_optimizer
from vf_nerf_tpu.parallel import train_step as jtrain
from vf_nerf_torch.config import schema
from vf_nerf_torch.models.nerf import (VectorFieldNerf, make_optimizer,
                                       param_groups)
from vf_nerf_torch.parallel import train_step
from vf_nerf_torch.utils.weights import (export_jax_vf_variables,
                                         jax_param_paths,
                                         load_jax_train_state)

N_RAYS = 16
GAIN = 2.5
DECAY_STEPS = 100
DD_START = 3
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4
STATS_TOL = dict(rtol=1e-5, atol=1e-7)
MODES = {
    "analytic": dict(dd=True, numerical=False, epoch=DD_START),
    "numerical": dict(dd=True, numerical=True, epoch=DD_START),
    "before_start": dict(dd=True, numerical=False, epoch=DD_START - 1),
    "weight_norm": dict(weight_norm=True, static=True),
    "nerf": dict(rendering="nerf", static=True),
}


def _mode_config(dd=False, numerical=False, weight_norm=False,
                 rendering="volsdf", **_):
    jcfg = graft._tiny_config()
    return dataclasses.replace(
        jcfg, numerical_jacobian=numerical, rendering=rendering,
        vf_net_config=dataclasses.replace(jcfg.vf_net_config,
                                          weight_norm=weight_norm),
        rendering_net_config=dataclasses.replace(
            jcfg.rendering_net_config, weight_norm=weight_norm))


def _variables(jcfg):
    """As ``tiny_variables``; under weight norm the VF gain scales ``g``
    (``v`` is normalized away)."""
    if not jcfg.vf_net_config.weight_norm:
        return tiny_variables(jcfg)
    jmods = jrenderer.VFNerfModules(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmods.init_variables(jax.random.PRNGKey(0)))
    for scope in variables["params"]["vf"].values():
        scope["WeightNormDense_0"]["g"] = scope["WeightNormDense_0"]["g"] \
            * GAIN
    return jmods, variables


def _losses(mode):
    weights = dataclasses.replace(
        J_WEIGHTS, directional_derivatives=0.1 if mode.get("dd") else 0.0)
    config = dataclasses.replace(J_CONFIG,
                                 directional_derivatives_start=DD_START)
    return (weights, config, schema.VFLossWeights(**dataclasses.asdict(
        weights)), schema.VFLossConfig(**dataclasses.asdict(config)))


def _run_mode(name):
    """Two steps of both packages in ``MODES[name]``."""
    mode = MODES[name]
    jcfg = _mode_config(**mode)
    jweights, jconfig, weights, config = _losses(mode)
    jmods, variables = _variables(jcfg)
    train = mode.get("dd", False) and not mode.get("numerical", False)
    static = mode.get("static", False)
    epoch = mode.get("epoch", 0)
    jopt, _ = jmake_optimizer(jcfg.scheduler_config, decay_steps=DECAY_STEPS,
                              duplicate_vf=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    rs = jcfg.ray_sampler_config
    n_fine = rs.max_samples if static else rs.n_importance
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(
            jcfg, n_fine=n_fine, train=train,
            compute_dir_derivatives=mode.get("dd", False)),
        fast_eval=False)
    jsup = jtrain.SupervisionStatics.from_config(
        jcfg, "exterior_synthetic", n_rays=N_RAYS,
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
    jstep = jtrain.make_train_step(jmods, jopt, jstatics, jsup, jweights,
                                   jconfig)

    def jax_value_and_grad(statics):
        jloss = jtrain.make_loss_fn(jmods, statics, jsup, jweights, jconfig)

        @jax.jit
        def run(state, k_render, k_sup):
            def f(p):
                return jloss(p, state.batch_stats, jbatch, k_render, k_sup,
                             jnp.asarray(epoch, jnp.int32), window,
                             jnp.float32(near), jnp.float32(far),
                             jnp.zeros(3),
                             n_points_active=None if not static else
                             jnp.asarray(n_points_active, jnp.int32),
                             **fine_kw)
            return jax.value_and_grad(f, has_aux=True)(state.params)
        return run

    j_grad = jax_value_and_grad(jstatics)
    # The numerical mode's yardstick: JAX's analytic Jacobian on the same
    # frozen-BatchNorm step.
    j_exact = jax_value_and_grad(dataclasses.replace(
        jstatics, numerical_jacobian=False)) if mode.get("numerical") \
        else None

    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, device="cpu", decay_steps=DECAY_STEPS)
    model.optimizer, model.lr_schedule = make_optimizer(
        cfg.scheduler_config, DECAY_STEPS, duplicate_vf=True)
    model.optimizer.init(param_groups(model.modules))
    if mode.get("dd"):
        model.train()
    assert model.modules.training == train
    statics = model.render_statics(n_fine=n_fine,
                                   compute_dir_derivatives=mode.get("dd",
                                                                    False))
    sup = train_step.SupervisionStatics(**dataclasses.asdict(jsup))
    loss_fn = train_step.make_loss_fn(model.modules, statics, sup, weights,
                                      config)
    step_fn = train_step.make_train_step(model.modules, model.optimizer,
                                         statics, sup, weights, config)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    taps = torch.tensor(jcfg.cos_sim_weights, dtype=torch.float32)
    port_args = (epoch, taps, float(near), float(np.float32(far)),
                 torch.zeros(3))
    paths = jax_param_paths(model.modules)

    steps = []
    for k in range(2):
        draws, k_render, k_sup = jax_step_draws(base_key, k, N_RAYS, jstatics,
                                                jsup)
        load_jax_train_state(model, _host(state))
        (j_total, (j_parts, j_updates)), j_grads = j_grad(state, k_render,
                                                         k_sup)
        exact = None
        if j_exact is not None:
            (e_total, (e_parts, _)), e_grads = j_exact(state, k_render,
                                                       k_sup)
            exact = dict(total=float(e_total), grads=_host(e_grads),
                         parts={k: float(v) for k, v in e_parts.items()})
        total, parts, out = loss_fn(batch, draws, *port_args, n_fine_active,
                                    n_points_active)
        grads = torch.autograd.grad(total, [p for _, p, _ in paths])
        load_jax_train_state(model, _host(state))
        step_fn(train_step.zero_metric_sums("cpu"), batch, *port_args,
                n_fine_active=n_fine_active, draws=draws)
        state, _ = jstep(state, jtrain.zero_metric_sums(), jbatch, base_key,
                         jnp.asarray(epoch, jnp.int32), window,
                         jnp.float32(near), jnp.float32(far), jnp.zeros(3),
                         **fine_kw)
        steps.append(dict(
            total=float(total.detach()),
            parts={k: float(v.detach()) for k, v in parts.items()},
            j_total=float(j_total),
            j_parts={k: float(v) for k, v in j_parts.items()},
            grads=[g.detach().numpy() for g in grads],
            j_grads=_host(j_grads), exact=exact,
            has_updates="batch_stats_updates" in out,
            j_has_updates=bool(j_updates),
            stats={net: export_jax_vf_variables(getattr(model.modules,
                                                        net))[1]
                   for net in ("vf", "render")},
            j_stats=_host(state.batch_stats),
            params={path: p.detach().numpy().copy() for path, p, _ in paths},
            j_params=_host(state.params),
            argmax=out["argmax_coarse"]))
    return dict(paths=paths, steps=steps, lr=model.lr_schedule(0),
                train=train, mode=mode)


@pytest.fixture(scope="module", params=list(MODES))
def case(request):
    return _run_mode(request.param)


def _ref(tree, path, transpose, like):
    ref = _leaf(tree, path)
    return (ref.T if transpose else ref).reshape(like.shape)


def _grad_gap(paths, grads, tree):
    """Per tensor: (max|Δ|, max|g| of the tree)."""
    out = []
    for (path, _, transpose), g in zip(paths, grads):
        ref = _ref(tree, path, transpose, g)
        out.append((float(np.abs(g - ref).max()), float(np.abs(ref).max())))
    return out


def test_loss_parts_match_jax(case):
    for k, step in enumerate(case["steps"]):
        exact = step["exact"]
        if exact is None:
            np.testing.assert_allclose(step["total"], step["j_total"],
                                       rtol=LOSS_RTOL, err_msg=f"step {k}")
            for name, value in step["parts"].items():
                np.testing.assert_allclose(value, step["j_parts"][name],
                                           rtol=LOSS_RTOL, atol=1e-12,
                                           err_msg=f"step {k} {name}")
            continue
        # Numerical: every part but the DD term as JAX's; the DD term and
        # the total as JAX's analytic step, within twice JAX's own gap.
        for name, value in step["parts"].items():
            ref, own = step["j_parts"][name], exact["parts"][name]
            if name == "directional_derivatives_loss":
                tol = max(LOSS_RTOL * abs(own), 2 * abs(ref - own))
                assert abs(value - own) <= tol, (name, value, own, ref)
            else:
                np.testing.assert_allclose(value, ref, rtol=LOSS_RTOL,
                                           atol=1e-12, err_msg=name)
        tol = max(LOSS_RTOL * abs(exact["total"]),
                  2 * abs(step["j_total"] - exact["total"]))
        assert abs(step["total"] - exact["total"]) <= tol


def test_dd_term_follows_the_start_epoch(case):
    for step in case["steps"]:
        dd = step["parts"]["directional_derivatives_loss"]
        if case["mode"].get("dd") and \
                case["mode"].get("epoch", 0) >= DD_START:
            assert dd > 0
        else:
            assert dd == step["j_parts"]["directional_derivatives_loss"] == 0


def test_gradients_match_jax(case):
    for step in case["steps"]:
        ours = _grad_gap(case["paths"], step["grads"], step["j_grads"])
        if step["exact"] is None:
            for (path, _, _), (gap, scale) in zip(case["paths"], ours):
                assert gap <= GRAD_TOL * scale + 1e-7, (path, gap, scale)
            continue
        port = _grad_gap(case["paths"], step["grads"],
                         step["exact"]["grads"])
        jax_own = _grad_gap(case["paths"],
                            [_ref(step["j_grads"], p, t, g) for (p, _, t), g
                             in zip(case["paths"], step["grads"])],
                            step["exact"]["grads"])
        for (path, _, _), (gap, scale), (own, _) in zip(case["paths"], port,
                                                        jax_own):
            assert gap <= max(GRAD_TOL * scale + 1e-7, 2 * own), \
                (path, gap, own, scale)
        argmax = step["argmax"]
        assert 0 < int((argmax > 0).sum()) < N_RAYS


def test_running_statistics_match_jax(case):
    """In train-mode BatchNorm both steps keep the fine passes' running
    statistics, after the optimizer; otherwise neither moves them."""
    for step in case["steps"]:
        assert step["has_updates"] == step["j_has_updates"] == case["train"]
        for net in ("vf", "render"):
            ours, ref = step["stats"][net], step["j_stats"][net]
            assert set(ours) == set(ref)
            for layer in ref:
                for k in ("mean", "var"):
                    np.testing.assert_allclose(
                        ours[layer]["BatchNorm_0"][k],
                        ref[layer]["BatchNorm_0"][k],
                        err_msg=f"{net} {layer} {k}", **STATS_TOL)


def _compared(case, step):
    """Per tensor, the elements whose update is held to JAX's: not those
    whose JAX gradient is at most 1e-6 of the step's largest (zero in
    exact arithmetic: the bias of a Linear before a train-mode BatchNorm,
    whose normalization takes the batch mean out; Adam's first steps scale
    their rounding noise to ±lr), which must be as small in the port; and
    in the numerical mode only those whose gradients agree to 1e-4
    relative (elsewhere the central differences' noise moves Adam's
    update; ``test_gradients_match_jax`` holds those gradients)."""
    largest = max(float(np.abs(_leaf(step["j_grads"], path)).max())
                  for path, _, _ in case["paths"])
    masks = []
    for (path, _, transpose), g in zip(case["paths"], step["grads"]):
        ref = _ref(step["j_grads"], path, transpose, g)
        noise = np.abs(ref) <= 1e-6 * largest
        assert np.abs(g[noise]).max(initial=0.0) <= 1e-6 * largest, path
        mask = ~noise
        if step["exact"] is not None:
            mask &= np.abs(g - ref) <= 1e-4 * np.abs(ref)
        masks.append(mask)
    return masks


def test_whole_step_matches_jax(case):
    """Parameters after a whole step within 1 % of one learning-rate step
    of JAX's, on the elements ``_compared`` keeps, at least half of all
    (measured: 0.88 to 0.98 of them, 0.63 to 0.67 in the numerical mode;
    dead ReLU units give exact zeros in every mode)."""
    for k, step in enumerate(case["steps"]):
        masks = _compared(case, step)
        kept = sum(int(m.sum()) for m in masks) / \
            sum(m.size for m in masks)
        assert kept >= 0.5, kept
        for (path, _, transpose), mask in zip(case["paths"], masks):
            ours = step["params"][path]
            ref = _ref(step["j_params"], path, transpose, ours)
            np.testing.assert_allclose(ours[mask], ref[mask], rtol=0,
                                       atol=1e-2 * case["lr"],
                                       err_msg=f"step {k} {path}")
