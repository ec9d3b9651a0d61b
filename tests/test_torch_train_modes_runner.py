"""The port's runner with the directional-derivative loss against the JAX
package's runner, on the CPU.

``test_torch_runner``'s conf and box scene (8 views of 32×48, 64 rays per
step, 8 steps per epoch; a 3×64 VF net, a 2×32 colour net) with the
directional-derivative weight 0.1 from epoch 0, so both runners train
BatchNorm on batch statistics and turn static fine growth off; the fine
count grows by 5 every epoch, so the sample axis is 16 + 9 in epoch 0 and
16 + 14 in epoch 1. As in ``test_torch_runner``, each port epoch starts
from the JAX runner's state at that epoch's start (weights, Adam moments
and running statistics) with JAX's batches and draws.

Tolerances: the logged loss parts rtol 1e-4, the density scalars and the
learning rate rtol 1e-5 (``test_torch_runner``'s); after the last epoch's
8 steps the running variances rtol 1e-4 / atol 1e-6 of JAX's (each step's
update is held at rtol 1e-5 in ``test_torch_train_modes_step``), and the
running means within the walk of the Linear biases before the BatchNorms:
their gradient is rounding noise (the normalization takes the batch mean
out), which Adam turns into steps of up to 2·lr per step (two VF
sub-steps) that differ between the packages, and a running mean follows its
layer's bias with weight 1 − 0.9⁸ over 8 steps. A save and a resume
restore the statistics bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_runner import RUNNER_CONF, gain_vf, metric_lines, write_conf
from test_torch_train_step import jax_step_draws
from vf_nerf_tpu.config.parser import parse_config as jparse
from vf_nerf_tpu.train.runner import VectorFieldNerfRunner as JRunner
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.parallel.train_step import METRIC_KEYS
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.utils.weights import (export_jax_vf_variables,
                                         load_jax_train_state)

N_EPOCHS = 2
DD_CONF = (RUNNER_CONF
           .replace("directional_derivatives_start = 100",
                    "directional_derivatives_start = 0")
           .replace("directional_derivatives = 0.00",
                    "directional_derivatives = 0.1")
           .replace("increase_every = 2", "increase_every = 1")
           .replace("num_epochs = 3", f"num_epochs = {N_EPOCHS}")
           .replace("save_frequency = 2", "save_frequency = 1"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both runners trained with the DD loss from the same states."""
    root = str(tmp_path_factory.mktemp("dd_runner"))
    conf = write_conf(root, DD_CONF)
    jcfg = jparse(scene="box", config_path=conf, expname="j",
                  timestamp="run", offline=True)
    jrunner = JRunner(jcfg)
    assert jrunner.model.train_mode and not jrunner._static_fine()
    jrunner.model.state = gain_vf(jrunner.model.state)
    keys, starts, statics = [], {}, {}
    next_key = jrunner.model._next_key

    def recorded():
        keys.append(next_key())
        return keys[-1]

    jrunner.model._next_key = recorded
    j_train_epoch = jrunner.train_epoch

    def recorded_epoch(epoch, *args, **kwargs):
        starts[epoch] = jax.tree_util.tree_map(np.array, jrunner.model.state)
        statics[epoch] = jrunner._step_statics()
        return j_train_epoch(epoch, *args, **kwargs)

    jrunner.train_epoch = recorded_epoch
    n_rays = jrunner._batch_rays()
    jrunner.train()
    assert len(keys) == len(starts) == N_EPOCHS

    cfg = parse_config(scene="box", config_path=conf, expname="p",
                       timestamp="run", gpu="cpu", offline=True)
    runner = VectorFieldNerfRunner(cfg)
    assert runner.model.modules.training and not runner._static_fine()
    train_epoch = runner.train_epoch
    shapes = []

    def from_jax_start(epoch, *args, **kwargs):
        load_jax_train_state(runner.model, starts[epoch])
        port_statics, _ = runner._step_statics()
        shapes.append(port_statics.n_coarse + port_statics.n_fine)
        return train_epoch(epoch, *args, **kwargs)

    def draws(epoch, step):
        return jax_step_draws(keys[epoch], step, n_rays,
                              *statics[epoch])[0]

    runner.train_epoch = from_jax_start
    runner.train(draws=draws)
    return dict(root=root, conf=conf, jrunner=jrunner, runner=runner,
                cfg=cfg, shapes=shapes,
                j_shapes=[s.n_coarse + s.n_fine for s, _ in
                          (statics[e] for e in range(N_EPOCHS))])


def test_dd_epochs_match_jax(trained):
    """The logged epochs agree, the DD term is on, and the fine count grew
    every epoch (the sample axis changed: 25, then 30)."""
    assert trained["shapes"] == trained["j_shapes"] == [25, 30]
    ours = metric_lines(trained["runner"].run_dir)
    ref = metric_lines(trained["jrunner"].run_dir)
    assert len(ours) == len(ref) == N_EPOCHS
    for a, b in zip(ours, ref):
        assert a["directional_derivatives_loss"] > 0
        for key in METRIC_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                       atol=1e-10, err_msg=key)
        for key in ("beta", "scale", "mean", "learning_rate"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=key)


def test_running_statistics_follow_jax(trained):
    """After the last epoch the port's running statistics are JAX's (the
    means within the bias walk of the module docstring: measured 7.6e-5
    against 4.6e-3)."""
    runner, jrunner = trained["runner"], trained["jrunner"]
    steps = len(runner.dataset)
    lr = trained["cfg"].vf_nerf_config.scheduler_config.lr
    mean_atol = (1 - 0.9 ** steps) * 2 * lr * steps
    for net in ("vf", "render"):
        ours = export_jax_vf_variables(getattr(runner.model.modules, net))[1]
        ref = jax.tree_util.tree_map(np.asarray,
                                     jrunner.model.state.batch_stats[net])
        assert set(ours) == set(ref) and ours
        for layer in ref:
            ours_bn, ref_bn = ours[layer]["BatchNorm_0"], \
                ref[layer]["BatchNorm_0"]
            np.testing.assert_allclose(ours_bn["var"], ref_bn["var"],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{net} {layer} var")
            np.testing.assert_allclose(ours_bn["mean"], ref_bn["mean"],
                                       rtol=0, atol=mean_atol,
                                       err_msg=f"{net} {layer} mean")
            assert np.isfinite(ours_bn["mean"]).all()
            assert np.isfinite(ours_bn["var"]).all()
    counts = [int(v) for k, v in runner.model.modules.state_dict().items()
              if k.endswith("num_batches_tracked")]
    assert counts and set(counts) == {N_EPOCHS * len(runner.dataset)}


def test_save_and_resume_keep_running_statistics(trained, tmp_path):
    """``save`` / ``load`` and the runner's resume from ``latest`` restore
    every buffer bit for bit, and the resumed runner trains BatchNorm."""
    model = trained["runner"].model
    path = model.save(5, str(tmp_path))
    fresh = VectorFieldNerf(trained["cfg"].vf_nerf_config, seed=9,
                            device="cpu")
    fresh.load(path)
    for name, value in model.modules.named_buffers():
        assert torch.equal(dict(fresh.modules.named_buffers())[name],
                           value), name
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp="run", checkpoint="latest",
                       gpu="cpu", offline=True)
    resumed = VectorFieldNerfRunner(cfg)
    assert resumed.model.modules.training
    for (name, a), b in zip(model.modules.state_dict().items(),
                            resumed.model.modules.state_dict().values()):
        assert torch.equal(a, b), name


def _evaluate(conf, root, expname):
    """render-images then metrics of ``latest``; returns (the eval model,
    the mean PSNR)."""
    import json
    import os

    from vf_nerf_torch.evaluation import evaluate as evaluate_mod

    evals = os.path.join(root, "evals")
    for method in ("render-images", "metrics"):
        cfg = parse_config(scene="box", config_path=conf, expname=expname,
                           timestamp="run", checkpoint="latest", gpu="cpu")
        folder = evaluate_mod.evaluate(cfg, method, 32, evals, 512, 0.05, 8)
    with open(os.path.join(folder, "metrics.json")) as f:
        psnr = json.load(f)["mean_psnr"]
    model, _ = evaluate_mod.eval_model(cfg, device="cpu")
    return model, psnr


def _field_is_the_unfolded_net(model):
    """The mesh grid's ``get_vector_field`` (the fused MLP over folded
    weights) equals the unfolded eval-mode VF net."""
    assert not model.modules.training
    pts = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (500, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model.modules.vf_apply(pts, False)[:, :3]
    torch.testing.assert_close(model.get_vector_field(pts, chunk=128), ref,
                               rtol=1e-5, atol=1e-6)


def test_dd_checkpoint_evaluates(trained):
    """A checkpoint trained with the DD loss renders and scores with its
    running statistics folded, and its field grid is the eval-mode net."""
    model, psnr = _evaluate(trained["conf"], trained["root"], "p")
    assert np.isfinite(psnr)
    saved = trained["runner"].model.modules.state_dict()
    for name, value in model.modules.state_dict().items():
        if "running" in name:
            assert torch.equal(value, saved[name]), name
    _field_is_the_unfolded_net(model)


def test_weight_norm_run_trains_and_evaluates(tmp_path):
    """Both nets under weight norm (no BatchNorm): one runner epoch, then
    render-images, metrics and the field grid, all folding ``g·v/‖v‖``."""
    conf = write_conf(str(tmp_path), RUNNER_CONF
                      .replace("weight_norm = False", "weight_norm = True")
                      .replace("num_epochs = 3", "num_epochs = 1"))
    cfg = parse_config(scene="box", config_path=conf, expname="wn",
                       timestamp="run", gpu="cpu", offline=True)
    runner = VectorFieldNerfRunner(cfg)
    assert "layers.0.weight_g" in runner.model.modules.vf.state_dict()
    runner.train()
    assert np.isfinite(runner.final_loss)
    model, psnr = _evaluate(conf, str(tmp_path), "wn")
    assert np.isfinite(psnr)
    _field_is_the_unfolded_net(model)
