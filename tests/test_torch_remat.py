"""``device_config.train_remat`` and the debug hooks of the port, against
the JAX package, on the CPU.

- ``"none"``, ``"full"`` (``torch.utils.checkpoint``) and ``"dots"`` (a
  selective-checkpoint policy that keeps the products' outputs) give the
  same loss and the same gradients, within 1e-6·max|g| per tensor, on
  ``__graft_entry__._tiny_config`` with BatchNorm frozen (the folded
  production step) and in train mode with the analytic
  directional-derivative loss (its JVPs inside the checkpoint);
- under each mode one whole step of the port is held to JAX
  ``make_train_step(remat=mode)`` from the same state and draws, as
  ``tests/test_torch_train_step.py::test_whole_step_matches_jax`` holds
  the step: parameters within 1 % of one learning-rate step;
- an unknown mode raises JAX's ``ValueError``, from ``make_train_step`` and
  from the runner, which reads the knob where the JAX runner does;
- ``maybe_enable_nan_debugging`` and ``trace`` are tested as
  ``tests/test_tools.py::TestExtras::test_profiling_helpers`` tests JAX's,
  and the runner turns anomaly detection on under ``VFNERF_DEBUG_NANS``.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_renderer import make_batch
from test_torch_render import port_config
from test_torch_train_step import (CONFIG, DECAY_STEPS, J_CONFIG, J_WEIGHTS,
                                   WEIGHTS, _host, _leaf, jax_step_draws,
                                   tiny_variables)
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.models.nerf import TrainState
from vf_nerf_tpu.models.nerf import make_optimizer as jmake_optimizer
from vf_nerf_tpu.parallel import train_step as jtrain
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.models.nerf import (VectorFieldNerf, make_optimizer,
                                       param_groups)
from vf_nerf_torch.models.renderer import RenderStatics
from vf_nerf_torch.parallel import train_step
from vf_nerf_torch.utils import profiling
from vf_nerf_torch.utils.weights import jax_param_paths, load_jax_train_state

MODES = ("none", "full", "dots")
N_RAYS = 16
CONF = str(Path(__file__).resolve().parents[1] / "confs" / "vf_nerf.conf")


def port_case(dd):
    """(model, loss_fn args) of one step of the tiny config: BatchNorm
    frozen, or in train mode with the analytic DD loss."""
    jcfg = graft._tiny_config()
    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, device="cpu", decay_steps=DECAY_STEPS)
    _, variables = tiny_variables(jcfg)
    from vf_nerf_torch.utils.weights import load_jax_variables
    load_jax_variables(model, variables)
    if dd:
        model.train()
    statics = model.render_statics(compute_dir_derivatives=dd)
    sup = train_step.SupervisionStatics.from_config(
        cfg, "exterior_synthetic", N_RAYS,
        statics.n_coarse + statics.n_fine, 0.15)
    ds, jbatch = make_batch(N_RAYS)
    _, far = ds.get_bounds()
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    draws = train_step.draw_step(statics, sup, N_RAYS,
                                 torch.Generator().manual_seed(3), "cpu")
    config = dataclasses.replace(CONFIG, directional_derivatives_start=0)
    weights = dataclasses.replace(WEIGHTS, directional_derivatives=0.1) \
        if dd else WEIGHTS
    args = (batch, draws, 0, torch.tensor(cfg.cos_sim_weights), 0.0,
            float(far), torch.zeros(3))
    return model, statics, sup, weights, config, args


@pytest.mark.parametrize("dd", [False, True], ids=["frozen_bn", "dd_train"])
def test_modes_give_the_same_loss_and_gradients(dd):
    model, statics, sup, weights, config, args = port_case(dd)
    params = list(model.modules.parameters())
    results = {}
    for mode in MODES:
        loss_fn = train_step.remat_wrap(train_step.make_loss_fn(
            model.modules, statics, sup, weights, config), mode)
        total, parts, out = loss_fn(*args)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        results[mode] = (float(total), [torch.zeros_like(p) if g is None
                                        else g for p, g in zip(params,
                                                               grads)])
        if dd:
            assert "dir_derivative_norms" in out
    loss, grads = results["none"]
    for mode in ("full", "dots"):
        assert results[mode][0] == pytest.approx(loss, rel=1e-6, abs=0)
        for g, ref in zip(results[mode][1], grads):
            tol = 1e-6 * float(ref.abs().max())
            assert float((g - ref).abs().max()) <= tol, mode


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax_under_each_mode(mode):
    jcfg = graft._tiny_config()
    jmods, variables = tiny_variables(jcfg)
    jopt, _ = jmake_optimizer(jcfg.scheduler_config, decay_steps=DECAY_STEPS,
                              duplicate_vf=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    n_fine = jcfg.ray_sampler_config.n_importance
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(jcfg, n_fine=n_fine,
                                            train=False), fast_eval=False)
    jsup = jtrain.SupervisionStatics.from_config(
        jcfg, "exterior_synthetic", n_rays=N_RAYS,
        n_samples=jstatics.n_coarse + jstatics.n_fine, border_radius=0.15)
    ds, jbatch = make_batch(N_RAYS)
    near, far = ds.get_bounds()
    window = jnp.asarray(jcfg.cos_sim_weights)
    base_key = jax.random.PRNGKey(3)
    jstep = jtrain.make_train_step(jmods, jopt, jstatics, jsup, J_WEIGHTS,
                                   J_CONFIG, remat=mode)
    draws, _, _ = jax_step_draws(base_key, 0, N_RAYS, jstatics, jsup)

    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, device="cpu", decay_steps=DECAY_STEPS)
    model.optimizer, lr_schedule = make_optimizer(
        cfg.scheduler_config, DECAY_STEPS, duplicate_vf=True)
    model.optimizer.init(param_groups(model.modules))
    load_jax_train_state(model, _host(state))
    statics = RenderStatics.from_config(cfg, n_fine=n_fine, train=False)
    sup = train_step.SupervisionStatics(**dataclasses.asdict(jsup))
    step = train_step.make_train_step(model.modules, model.optimizer,
                                      statics, sup, WEIGHTS, CONFIG,
                                      remat=mode)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    sums = step(train_step.zero_metric_sums("cpu"), batch, 0,
                torch.tensor(cfg.cos_sim_weights), float(near),
                float(np.float32(far)), torch.zeros(3), draws=draws)
    state, j_sums = jstep(state, jtrain.zero_metric_sums(), jbatch, base_key,
                          jnp.asarray(0, jnp.int32), window,
                          jnp.float32(near), jnp.float32(far), jnp.zeros(3))
    np.testing.assert_allclose(float(sums["loss"]), float(j_sums["loss"]),
                               rtol=1e-5)
    for path, p, transpose in jax_param_paths(model.modules):
        ref = _leaf(_host(state.params), path)
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref.T if transpose else ref, rtol=0,
                                   atol=1e-2 * lr_schedule(0),
                                   err_msg=str(path))


def _jax_message():
    with pytest.raises(ValueError) as err:
        jtrain._remat_wrap(lambda p: 0.0, "bogus")
    return str(err.value)


def test_unknown_mode_raises_jax_error():
    model, statics, sup, weights, config, _ = port_case(False)
    with pytest.raises(ValueError) as err:
        train_step.make_train_step(model.modules, model.optimizer, statics,
                                   sup, weights, config, remat="bogus")
    assert str(err.value) == _jax_message()


def _runner(tmp_path, **device):
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner
    cfg = parse_config(scene="s", config_path=CONF, gpu="cpu",
                       timestamp="t", offline=True)
    cfg.dataset_config.dataset_name = "synthetic"
    cfg.exps_folder = str(tmp_path / "exps")
    net = cfg.vf_nerf_config
    net.vf_net_config.dimensions = [48, 48]
    net.vf_net_config.skip_connection_in = [1]
    net.rendering_net_config.dimensions = [16]
    for k, v in device.items():
        setattr(net.device_config, k, v)
    return VectorFieldNerfRunner(cfg)


def test_runner_reads_train_remat(tmp_path):
    runner = _runner(tmp_path, train_remat="bogus")
    with pytest.raises(ValueError) as err:
        runner._get_step()
    assert str(err.value) == _jax_message()
    runner = _runner(tmp_path, train_remat="dots")
    assert runner._remat() == "dots"
    assert callable(runner._get_step())


def test_nan_debugging_and_trace(tmp_path, monkeypatch):
    assert not torch.is_anomaly_enabled()
    monkeypatch.delenv("VFNERF_DEBUG_NANS", raising=False)
    assert profiling.maybe_enable_nan_debugging() is False
    assert not torch.is_anomaly_enabled()
    monkeypatch.setenv("VFNERF_DEBUG_NANS", "1")
    try:
        _runner(tmp_path)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)

    monkeypatch.delenv("VFNERF_PROFILE_DIR", raising=False)
    with profiling.trace(None):
        pass
    assert not list(tmp_path.glob("**/trace.json"))
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    monkeypatch.setenv("VFNERF_PROFILE_DIR", str(tmp_path / "env"))
    with profiling.trace():
        torch.ones(4).sum()
    assert (tmp_path / "env" / "trace.json").exists()
