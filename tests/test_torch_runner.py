"""The port's training runner against the JAX package's, on the CPU.

A tiny conf on the synthetic box scene (8 views of 32×48, 64 rays per step,
8 steps per epoch, 3 epochs; a 3×64 VF net and a 2×32 colour net; 16 coarse samples and a fine axis
padded to 32 with 4 live samples at the start; static fine growth every 2
epochs, so at epochs 0 and 2; the window annealed into the fine pass from
epoch 1). ``detach_normals`` is off: the JAX runner's step takes the folded
path, which ignores it (``ROADMAP.md`` §C).

The JAX runner trains from its own init with the VF kernels gained by 2.5
and its state is recorded at the start of each epoch; the port's
``train()`` starts each epoch from that state (``load_jax_train_state``),
takes the same batches (one ``np.random.RandomState`` per runner, seeded
alike) and the same draws: JAX's per-step draws through
``train(draws=...)``, from the base key that the JAX runner takes for each
epoch (``model._next_key``, recorded) folded with the step count. The
logged epochs agree: loss parts rtol 1e-4, β / scale / mean and the
learning rate rtol 1e-5, the window taps exactly (measured: loss parts
within 6.3e-6 relative, the density scalars within 5.4e-7, the learning
rate within 6.8e-8). Each epoch starts from JAX's state because two f32
chains drift apart over many steps: run free for 24 steps, the epoch losses
differed by 3.8e-4 and 1.2e-2 relative in epochs 1 and 2 (``ROADMAP.md``
§C).

Then: the checkpoint layout and the ``metrics.jsonl`` keys are the JAX
runner's; save → load restores every tensor, the optimizer, the epoch and
the fine count exactly; resume sets ``start_epoch`` and the fine count as
the JAX runner does, its regrowth on top of the restored count included; a
missing checkpoint raises ``FileExistsError``; and the command lines print
their help without importing jax.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from test_torch_train_step import jax_step_draws
from vf_nerf_tpu.config.parser import parse_config as jparse
from vf_nerf_tpu.train.runner import VectorFieldNerfRunner as JRunner
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.config.parser import requested_devices
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.parallel.train_step import METRIC_KEYS
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.utils.weights import load_jax_train_state

ROOT = Path(__file__).resolve().parents[1]
GAIN = 2.5
N_EPOCHS = 3

RUNNER_CONF = """
density {
    params_init { beta = 0.5, scale = 100.0, mean = 0.7, }
    beta_bounds = [1e-4, 1e9],
    mean_bounds = [0.6, 1.0]
    scale_min = 1.0
    cutoff = -2.0
}
vector_field_network {
    input_dims = 3, output_dims = 3,
    dimensions = [64, 64, 64],
    feature_vector_dims = 16, embedder_multires = 4,
    weight_norm = False, batch_norm = True,
    skip_connection_in = [2], bias_init = 0.0,
    dropout = False, dropout_probability = 0.2, xavier_init = False,
}
rendering {
    output_dims = 3, dimensions = [32, 32], feature_vector_dims = 16,
    weight_norm = False, batch_norm = True, mode = "idr",
    embedder_multires = 2, detach_normals = False,
}
ray_sampler {
    n_samples = 16
    n_importance = 4
    rays_per_batch = 64
    perturb = True
    near = 0.0
    far = 1.0
    fine_range = 0.3
    increase_every = 2
    max_samples = 32
}
scheduler { lr = 5e-4, lr_decay_factor = 0.1, clip_norm = 0.5, weight_decay = 0.0 }
vf_nerf {
    dir_to_normal_th = -2
    rendering = "volsdf"
    cos_sim_weights = [0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09],
    cos_sim_weights_anneal = "anneal_fine",
    normalize_rendering = True,
    anneal_start = 0
    anneal_end = 4
    numerical_jacobian = False
    border_supervision = True
    center_supervision = True
}
loss {
    config {
        norm_smaller_than_one_start = 11000
        depth_loss_clamp = 0.5
        directional_derivatives_start = 100
    }
    weights {
        rgb = 2.0, depth = 0.5, unit_norm = 0.1, supervision = 1.0,
        norm_smaller_than_one = 0.1
        directional_derivatives = 0.00
    }
}
dataset {
    dataset_name = "synthetic"
    data_dir = "Synthetic"
    shuffle_views = True
    pixels_per_batch = 64
    random_img_sampling = False
    border_radius = 0.15
}
train {
    num_epochs = 3
    save_frequency = 2
    wandb_frequency = 1
    wandb_project = "vf_nerf"
    exps_folder = "EXPS"
}
device {
    static_fine_growth = True
    steps_per_dispatch = 1
}
"""


def write_conf(root, text=RUNNER_CONF):
    path = os.path.join(root, "runner.conf")
    with open(path, "w") as f:
        f.write(text.replace("EXPS", os.path.join(root, "exps")))
    return path


def metric_lines(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return [line for line in lines if line.get("_type") == "metrics"]


def gain_vf(state):
    params = jax.tree_util.tree_map(np.asarray, state.params)
    for scope in params["vf"].values():
        scope["Dense_0"]["kernel"] = scope["Dense_0"]["kernel"] * GAIN
    return state.replace(params=params)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both runners trained for 3 epochs from the same state and draws."""
    root = str(tmp_path_factory.mktemp("runner"))
    conf = write_conf(root)
    jcfg = jparse(scene="box", config_path=conf, expname="j",
                  timestamp="run", offline=True)
    jrunner = JRunner(jcfg)
    jrunner.model.state = gain_vf(jrunner.model.state)
    keys = []
    next_key = jrunner.model._next_key

    def recorded():
        keys.append(next_key())
        return keys[-1]

    jrunner.model._next_key = recorded
    starts = {}
    j_train_epoch = jrunner.train_epoch

    def recorded_epoch(epoch, *args, **kwargs):
        starts[epoch] = jax.tree_util.tree_map(np.array, jrunner.model.state)
        return j_train_epoch(epoch, *args, **kwargs)

    jrunner.train_epoch = recorded_epoch
    jstatics, jsup = jrunner._step_statics()
    n_rays = jrunner._batch_rays()
    jrunner.train()
    assert len(keys) == len(starts) == N_EPOCHS

    cfg = parse_config(scene="box", config_path=conf, expname="p",
                       timestamp="run", gpu="cpu", offline=True)
    runner = VectorFieldNerfRunner(cfg)
    assert runner.device.type == "cpu"
    train_epoch = runner.train_epoch

    def from_jax_start(epoch, *args, **kwargs):
        load_jax_train_state(runner.model, starts[epoch])
        return train_epoch(epoch, *args, **kwargs)

    def draws(epoch, step):
        return jax_step_draws(keys[epoch], step, n_rays, jstatics, jsup)[0]

    runner.train_epoch = from_jax_start
    runner.train(draws=draws)
    return dict(root=root, conf=conf, jrunner=jrunner, runner=runner,
                jcfg=jcfg, cfg=cfg)


def test_logged_epochs_match_jax(trained):
    ours = metric_lines(trained["runner"].run_dir)
    ref = metric_lines(trained["jrunner"].run_dir)
    assert len(ours) == len(ref) == N_EPOCHS
    for a, b in zip(ours, ref):
        assert a["step"] == b["step"]
        for key in METRIC_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                       atol=1e-10, err_msg=key)
        for key in ("beta", "scale", "mean", "learning_rate"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                       err_msg=key)
        for i in range(11):
            assert a[f"w_{i}"] == b[f"w_{i}"]
    # Annealing and growth both happened, and the loss moved.
    assert ours[0]["w_5"] != ours[2]["w_5"]
    assert trained["runner"].model.fine_n_samples == \
        trained["jrunner"].model.fine_n_samples == 14
    assert ours[0]["loss"] != ours[-1]["loss"]


def test_layout_and_log_keys_are_jax(trained):
    runner, jrunner = trained["runner"], trained["jrunner"]
    for rdir in (runner.run_dir, jrunner.run_dir):
        ckpts = sorted(os.listdir(os.path.join(rdir, "checkpoints",
                                               "vf_nerf")))
        assert ckpts == ["0.ckpt", "2.ckpt", "latest.ckpt"], ckpts
        for name in ("vf_nerf.conf", "metrics.jsonl", "convergence.json"):
            assert os.path.exists(os.path.join(rdir, name)), name
    keys = {k for line in metric_lines(runner.run_dir) for k in line} - \
        {"_time"}
    j_keys = {k for line in metric_lines(jrunner.run_dir) for k in line} - \
        {"_time"}
    assert keys == j_keys
    with open(os.path.join(runner.run_dir, "convergence.json")) as f:
        flag = json.load(f)
    with open(os.path.join(jrunner.run_dir, "convergence.json")) as f:
        assert set(json.load(f)) == set(flag)
    assert flag["final_loss"] == metric_lines(runner.run_dir)[-1]["loss"]


def test_save_load_restores_everything(trained, tmp_path):
    runner = trained["runner"]
    model = runner.model
    path = model.save(7, str(tmp_path))
    fresh = VectorFieldNerf(trained["cfg"].vf_nerf_config, seed=5,
                            device="cpu")
    assert fresh.load(path) == 8
    assert fresh.fine_n_samples == model.fine_n_samples
    assert fresh.step == model.step == N_EPOCHS * len(runner.dataset)
    for (name, a), b in zip(model.modules.state_dict().items(),
                            fresh.modules.state_dict().values()):
        assert torch.equal(a, b), name
    for key in ("mu", "nu"):
        for group, tensors in getattr(model.optimizer, key).items():
            for a, b in zip(tensors, getattr(fresh.optimizer, key)[group]):
                assert torch.equal(a, b), (key, group)


def test_facade_reads_back_weights_and_resets(trained, tmp_path):
    """``load_reference_pth`` reads the port's checkpoint (a reference
    ``.pth`` layout) with a fresh optimizer; ``reset_scheduler`` starts the
    optimizer and schedule afresh; the density scalars and the learning
    rate are the logged ones."""
    runner = trained["runner"]
    model = runner.model
    path = model.save(2, str(tmp_path))
    last = metric_lines(runner.run_dir)[-1]
    assert model.density_scalars() == pytest.approx(
        {k: last[k] for k in ("beta", "scale", "mean")}, rel=1e-7)
    assert model.current_lr() == last["learning_rate"]
    fresh = VectorFieldNerf(trained["cfg"].vf_nerf_config, seed=5,
                            device="cpu")
    assert fresh.load_reference_pth(path) == 3
    assert fresh.step == 0
    for a, b in zip(model.modules.state_dict().values(),
                    fresh.modules.state_dict().values()):
        assert torch.equal(a.float(), b.float())
    fresh.load(path)
    fresh.reset_scheduler(10)
    assert fresh.step == 0 and fresh.current_lr() == pytest.approx(5e-4)
    assert all(float(t.abs().max()) == 0 for tensors in
               fresh.optimizer.mu.values() for t in tensors)


@pytest.mark.parametrize("kind", ["pkl", "pth"])
def test_runner_loads_the_scene_vf_init(trained, tmp_path, monkeypatch,
                                        kind):
    """A scene's VF init: the ``.pkl`` of ``train/vf_init.py`` beside the
    named path, else a reference ``.pth`` of the VF net."""
    from vf_nerf_torch.datasets.synthetic import SyntheticBoxDataset
    from vf_nerf_torch.train.vf_init import save_vf_init

    source = trained["runner"].model.modules.vf
    init = tmp_path / "scene_init.pth"
    if kind == "pkl":
        save_vf_init(str(tmp_path / "scene_init.pkl"), source,
                     "exterior_scene", 2.0)
    else:
        torch.save({"module." + k: v for k, v in source.state_dict().items()},
                   init)
    monkeypatch.setattr(SyntheticBoxDataset, "get_vf_init_method",
                        lambda self: ("exterior_synthetic", str(init)))
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp=f"init_{kind}", gpu="cpu",
                       offline=True)
    loaded = VectorFieldNerfRunner(cfg).model.modules.vf
    for name, value in source.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(loaded.state_dict()[name], value), name


def test_resume_follows_jax(trained):
    """``load`` gives the saved epoch + 1, the runner adds 1 (so 2 + 2 =
    4), and the fine count grows by 5 per 2 epochs up to 4 on top of the
    restored 14 (so 24), as in the JAX runner."""
    jcfg = jparse(scene="box", config_path=trained["conf"], expname="j",
                  timestamp="run", checkpoint="latest", offline=True)
    jresumed = JRunner(jcfg)
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp="run", checkpoint="latest",
                       gpu="cpu", offline=True)
    resumed = VectorFieldNerfRunner(cfg)
    assert cfg.start_epoch == jcfg.start_epoch == 4
    assert resumed.model.fine_n_samples == \
        jresumed.model.fine_n_samples == 24
    model = trained["runner"].model
    for a, b in zip(model.modules.state_dict().values(),
                    resumed.model.modules.state_dict().values()):
        assert torch.equal(a, b)
    assert resumed.model.step == model.step


def test_missing_checkpoint_raises(trained):
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp="no_such_run",
                       checkpoint="latest", gpu="cpu", offline=True)
    with pytest.raises(FileExistsError):
        VectorFieldNerfRunner(cfg)


def test_unported_runner_options_raise(trained):
    """More than one device without a process group raises: one process
    trains on one device, and ``exp_runner`` spawns the ranks
    (``test_torch_parallel.py``; a directional-derivative weight trains
    since it was ported: ``test_torch_train_modes_runner.py``)."""
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp="x", gpu="cpu", offline=True)
    cfg.vf_nerf_config.device_config.num_devices = 2
    with pytest.raises(RuntimeError, match="process group"):
        VectorFieldNerfRunner(cfg)
    cfg.vf_nerf_config.device_config.num_devices = 0
    cfg.dataset_config.dataset_name = "replica"
    with pytest.raises(FileNotFoundError):      # no Replica files at data/
        VectorFieldNerfRunner(cfg)


def test_default_conf_builds_in_process_on_a_multi_card_host(trained,
                                                            monkeypatch):
    """``num_devices = 0`` (the shipped conf) on a host with two cards:
    the launch path reads it as every card, and a runner built in this
    process (no process group) trains on its one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = parse_config(scene="box", config_path=trained["conf"],
                       expname="p", timestamp="multi", gpu="cpu",
                       offline=True)
    cfg.vf_nerf_config.device_config.platform = ""      # a CUDA conf
    assert cfg.vf_nerf_config.device_config.num_devices == 0
    assert requested_devices(cfg) == 2
    runner = VectorFieldNerfRunner(cfg, device="cpu")
    assert (runner.rank, runner.world_size) == (0, 1)


_HELP_WITHOUT_JAX = """
import atexit, runpy, sys
atexit.register(lambda: print("LOADED", sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vf_nerf_tpu"))))
sys.argv = [{module!r}, "--help"]
runpy.run_module({module!r}, run_name="__main__")
"""


@pytest.mark.parametrize("module", ["vf_nerf_torch.train.exp_runner",
                                    "vf_nerf_torch.train.vf_init",
                                    "vf_nerf_torch.evaluation.evaluate"])
def test_command_lines_print_help_without_jax(module):
    proc = subprocess.run(
        [sys.executable, "-c", _HELP_WITHOUT_JAX.format(module=module)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout and "--gpu" in proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout
