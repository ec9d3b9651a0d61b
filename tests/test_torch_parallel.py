"""The port's data parallelism on the CPU: two gloo ranks against one
process and against the JAX package on two of the tests' virtual CPU
devices.

The ranks are two processes of ``tests/torch_parallel_worker.py`` joined
through a file store under the test's temporary directory (no TCP port),
spawned once for the module with every case:

- the training step of ``__graft_entry__._dryrun_variant``'s tiny config
  (16 rays, 8 per rank; the weights of ``test_torch_train_step``), in its
  production variant (frozen BatchNorm, folded nets) and with train-mode
  BatchNorm and the directional-derivative weight 0.01: the summed loss
  parts and gradients against one process and against JAX's loss and
  gradients on a 2-device ``make_mesh(2)``, at ``test_torch_train_step``'s
  tolerances (parts rtol 1e-5, gradients max|Δ| ≤ 1e-4·max|g| + 1e-7 per
  tensor; against JAX with train-mode BatchNorm, or within twice one
  process's distance from JAX's one device, since the f32 chains of the DD
  loss's Jacobian are ~4e-4·max|g| from float64 on the VF net); after a
  whole step the parameters within 1e-5 of one process's and the running
  statistics rtol 1e-5 (under train-mode BatchNorm the biases before it,
  zero in exact arithmetic, take ±lr Adam steps from rounding noise and
  are exempt, as in ``test_torch_train_modes_step``);
- static fine growth's shell mask at ``n_points_active`` (32 of 51 rows
  live; rank 1's rows 26-50 hold 6 of them by their global index);
- a batch whose depth mask splits 2 valid rays to 8 between the ranks: the
  ranks equal one process, and the mean over the ranks of each rank's own
  one-process loss does not;
- two epochs of ``VectorFieldNerfRunner`` (``test_torch_runner``'s conf),
  each from one process's checkpoint at its start with its draws: the
  logged epochs rtol 1e-5 and the parameters after each epoch within 1e-5,
  one set of checkpoints and one metrics line per epoch (rank 0's);
- two epochs of the joint stage from the JAX runner's state on 2 devices,
  which trims the 4,095 supervision points to 4,094 as the port does:
  logged losses rtol 1e-4, poses within 1e-4 (``test_torch_joint``'s).

And in one process: the eval render and ``extract_many`` over
``["cpu", "cpu"]`` bit-equal to one device; ``local_ray_slice`` and
``shard_rows``; ``initialize_multihost`` raising on an explicit cluster
that cannot come up and falling back with a log without one (in
subprocesses); ``exp_runner`` spawning two gloo ranks with ``--gpu cpu``.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from test_torch_joint import _gain, _write_confs
from test_torch_render import camera, jax_draws, port_config
from test_torch_runner import RUNNER_CONF, metric_lines
from test_torch_train_step import (J_CONFIG, J_WEIGHTS, _leaf,
                                   jax_step_draws, tiny_variables)
from torch_parallel_worker import run_steps
from vf_nerf_tpu.config.joint_parser import parse_config as jparse
from vf_nerf_tpu.datasets.synthetic import SyntheticBoxDataset
from vf_nerf_tpu.models import renderer as jrenderer
from vf_nerf_tpu.parallel import mesh as jmesh
from vf_nerf_tpu.parallel import train_step as jtrain
from vf_nerf_tpu.train import joint_runner as jjoint
from vf_nerf_torch.config import parse_config, schema
from vf_nerf_torch.evaluation.mc.device_pipeline import DeviceMeshExtractor
from vf_nerf_torch.evaluation.mc.pipeline import quadrant_translations
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.networks import dense_and_norm
from vf_nerf_torch.parallel import train_step
from vf_nerf_torch.parallel.mesh import make_mesh, shard_rows
from vf_nerf_torch.parallel.multihost import local_ray_slice
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.utils.weights import jax_param_paths, load_jax_variables

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
RANKS = 2
N_RAYS = 8 * RANKS
DECAY_STEPS = 100
GAIN = 2.5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# (BatchNorm in train mode with the DD loss, static fine growth, an uneven
# depth mask).
VARIANTS = {
    "production": (False, False, False),
    "bn_train": (True, False, False),
    "static_shell": (False, True, False),
    "uneven": (False, False, True),
}
N_INVALID = 6            # rays of rank 0's 8 with no depth


def spawn_ranks(inputs: Path, timeout: float = 600.0):
    """Run the worker on every rank of ``inputs``; their results."""
    store = inputs.parent / "store"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(inputs), str(rank), str(RANKS),
         str(store)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return [torch.load(f"{inputs}.{rank}", weights_only=False)
            for rank in range(RANKS)]


# ----------------------------------------------------------------- steps
def _step_case(jcfg, variables, bn_train, static, uneven):
    """One variant's inputs (numpy and port dataclasses), and JAX's loss
    parts and gradients on a 2-device mesh (production and BatchNorm-train
    variants)."""
    rs = jcfg.ray_sampler_config
    n_fine = rs.max_samples if static else rs.n_importance
    jstatics = dataclasses.replace(
        jrenderer.RenderStatics.from_config(
            jcfg, n_fine=n_fine, train=bn_train,
            compute_dir_derivatives=bn_train), fast_eval=False)
    jsup = jtrain.SupervisionStatics.from_config(
        jcfg, "exterior_synthetic", n_rays=N_RAYS,
        n_samples=jstatics.n_coarse + jstatics.n_fine, border_radius=0.15)
    jweights = dataclasses.replace(
        J_WEIGHTS, directional_derivatives=0.01 if bn_train else 0.0)
    jconfig = dataclasses.replace(
        J_CONFIG, directional_derivatives_start=0 if bn_train else 100,
        mask_invalid_depth=uneven)
    ds = SyntheticBoxDataset(n_images=2, image_size=(8, 12),
                             pixels_per_batch=N_RAYS)
    batch = {k: np.array(v) for k, v in
             next(ds.epoch_batches(np.random.RandomState(0))).items()}
    if uneven:
        batch["depth"][:N_INVALID] = 0.0
    near, far = ds.get_bounds()
    draws, k_render, k_sup = jax_step_draws(jax.random.PRNGKey(1), 0,
                                            N_RAYS, jstatics, jsup)
    cfg = port_config(jcfg)
    model = VectorFieldNerf(cfg, device="cpu", decay_steps=DECAY_STEPS)
    load_jax_variables(model, variables)
    case = dict(
        config=cfg, decay_steps=DECAY_STEPS, train=bn_train, dd=bn_train,
        n_fine=n_fine, n_fine_active=rs.n_importance if static else None,
        state=copy.deepcopy(model.modules.state_dict()),
        sup=dataclasses.asdict(jsup), batch=batch,
        draws={k: v.numpy() for k, v in draws.items()}, epoch=0,
        taps=np.asarray(jcfg.cos_sim_weights, np.float32),
        near=float(near), far=float(np.float32(far)),
        weights=schema.VFLossWeights(**dataclasses.asdict(jweights)),
        loss_config=schema.VFLossConfig(**dataclasses.asdict(jconfig)))
    if static or uneven:
        return case, None, model
    jmods = jrenderer.VFNerfModules(jcfg)
    jloss = jtrain.make_loss_fn(jmods, jstatics, jsup, jweights, jconfig)
    mesh = jmesh.make_mesh(RANKS)
    params = jmesh.replicate_state(mesh, variables["params"])
    stats = jmesh.replicate_state(mesh, variables["batch_stats"])
    sharded = jmesh.shard_batch(mesh, {k: jnp.asarray(v)
                                       for k, v in batch.items()})

    @jax.jit
    def value_and_grad(params, stats, batch):
        def f(p):
            return jloss(p, stats, batch, k_render, k_sup,
                         jnp.asarray(0, jnp.int32),
                         jnp.asarray(jcfg.cos_sim_weights),
                         jnp.float32(near), jnp.float32(far), jnp.zeros(3))
        return jax.value_and_grad(f, has_aux=True)(params)

    (total, (parts, _)), grads = value_and_grad(params, stats, sharded)
    ref = dict(loss=float(total), parts={k: float(v) for k, v in
                                         parts.items()},
               grads=jax.tree_util.tree_map(np.asarray, grads))
    if bn_train:
        _, one_device = value_and_grad(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in batch.items()})
        ref["one_device_grads"] = jax.tree_util.tree_map(np.asarray,
                                                         one_device)
    return case, ref, model


def _naive_loss(case):
    """The mean over the ranks of each rank's loss computed as one process
    computes it on its own rows (per-rank means)."""
    losses = []
    for rank in range(RANKS):
        part = dict(case)
        rows = local_ray_slice(N_RAYS, rank, RANKS)
        shell = shard_rows(case["sup"]["n_points"], rank, RANKS)
        part["batch"] = {k: v[rows] for k, v in case["batch"].items()}
        part["draws"] = {k: v[shell if k in train_step.SHELL_KEYS else rows]
                         for k, v in case["draws"].items()}
        part["sup"] = dict(case["sup"], n_points=shell.stop - shell.start)
        losses.append(run_steps({"p": part})["p"])
    return (float(np.mean([r["loss"] for r in losses])),
            float(np.mean([r["parts"]["depth_loss"] for r in losses])))


def _gain_vf(model):
    with torch.no_grad():
        for layer in model.modules.vf.layers:
            dense_and_norm(layer)[0].weight.mul_(GAIN)


def _plain(tree):
    """A JAX variables tree as nested dicts of numpy arrays (the density's
    ``DensityParams`` as a dict of its fields)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "beta"):
        return {k: np.asarray(getattr(tree, k))
                for k in ("beta", "scale", "mean")}
    return np.asarray(tree)


def _runner_conf(root: Path, ranks: int, epochs: int) -> str:
    text = RUNNER_CONF.replace("EXPS", str(root / f"exps{ranks}"))
    text = text.replace("num_epochs = 3", f"num_epochs = {epochs}")
    text = text.replace("static_fine_growth = True",
                        f"static_fine_growth = True\n    num_devices = "
                        f"{ranks}")
    path = root / f"runner{ranks}.conf"
    path.write_text(text)
    return str(path)


def _runner_reference(root: Path):
    """Two epochs of one process (VF kernels gained), with each epoch's
    starting checkpoint and every step's draws recorded."""
    cfg = parse_config(scene="box", config_path=_runner_conf(root, 1, 2),
                       expname="r", timestamp="one", gpu="cpu", offline=True)
    runner = VectorFieldNerfRunner(cfg)
    _gain_vf(runner.model)
    starts, draws, after = {}, {}, {}
    gen = torch.Generator().manual_seed(5)
    train_epoch = runner.train_epoch

    def recorded(epoch, draws=None):
        starts[epoch] = runner.model.save(epoch, str(root / "starts" /
                                                     str(epoch)))
        logged = train_epoch(epoch, draws=draws)
        after[epoch] = {k: v.numpy().copy() for k, v in
                        runner.model.modules.state_dict().items()}
        return logged

    def draw(epoch, step):
        statics, sup = runner._step_statics()
        d = train_step.draw_step(statics, sup, runner._batch_rays(), gen,
                                 "cpu")
        draws[(epoch, step)] = {k: None if v is None else v.numpy()
                                for k, v in d.items()}
        return d

    runner.train_epoch = recorded
    runner.train(draws=draw)
    return dict(run_dir=runner.run_dir, after=after), dict(
        conf=_runner_conf(root, RANKS, 2), starts=starts, draws=draws)


def _joint_reference(root: Path):
    """The JAX joint runner on 2 devices, its state at each epoch's start,
    its logs and draws (``test_torch_joint``'s recording)."""
    kw = _write_confs(root, detach_normals=False)
    jcfg = jparse(expname="j", timestamp="t", **kw)
    jcfg.vf_config.vf_nerf_config.device_config.num_devices = RANKS
    jrunner = jjoint.JointOptimizationRunner(jcfg)
    assert jrunner.n_devices == RANKS
    _gain(jrunner)
    starts = [(jax.device_get(jrunner.model.state.params),
               jax.device_get(jrunner.model.state.batch_stats),
               jrunner.pose_params.copy())]
    logs, poses = [], []
    j_log = jrunner.logger.log

    def record(values, step):
        logs.append(dict(values))
        poses.append(jrunner.pose_params.copy())
        starts.append((jax.device_get(jrunner.model.state.params),
                       jax.device_get(jrunner.model.state.batch_stats),
                       jrunner.pose_params.copy()))
        return j_log(values, step=step)

    jrunner.logger.log = record
    jrunner.train()
    key, subs = jax.random.PRNGKey(7), []
    for _ in range(2 * len(jrunner.dataset)):
        key, sub = jax.random.split(key)
        subs.append(sub)
    jstatics = jrunner.model.render_statics(train=False)
    n_rays = jrunner.dataset.total_pixels
    draws = [{k: v.numpy() for k, v in jax_draws(sub, n_rays,
                                                  jstatics).items()}
             for sub in subs]
    return dict(logs=logs, poses=poses), dict(
        kw=kw, draws=draws,
        starts=[(_plain(p), _plain(s), q) for p, s, q in starts[:2]])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one process and on two ranks."""
    root = tmp_path_factory.mktemp("parallel")
    jcfg = graft._tiny_config()
    _, variables = tiny_variables(jcfg)
    steps, refs, paths = {}, {}, None
    for name, flags in VARIANTS.items():
        steps[name], refs[name], model = _step_case(jcfg, variables, *flags)
        if paths is None:
            names = {id(p): n for n, p in model.modules.named_parameters()}
            paths = [(path, names[id(p)], transpose) for path, p, transpose
                     in jax_param_paths(model.modules)]
    one = run_steps(steps)
    runner_ref, runner_in = _runner_reference(root)
    joint_ref, joint_in = _joint_reference(root)
    inputs = root / "inputs.pt"
    torch.save(dict(steps=steps, runner=runner_in, joint=joint_in), inputs)
    outs = spawn_ranks(inputs)
    return dict(steps=steps, one=one, jax=refs, paths=paths, outs=outs,
                runner_ref=runner_ref, joint_ref=joint_ref)


def test_global_mesh_lists_every_rank(ranks):
    assert [out["mesh"] for out in ranks["outs"]] == [["cpu", "cpu"]] * 2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_ranks_equal_one_process(ranks, variant):
    one, two = ranks["one"][variant], ranks["outs"][0]["steps"][variant]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=LOSS_RTOL)
    for k, v in one["parts"].items():
        np.testing.assert_allclose(two["parts"][k], v, rtol=LOSS_RTOL,
                                   atol=1e-12, err_msg=k)
    for k, v in one["step_metrics"].items():
        np.testing.assert_allclose(two["step_metrics"][k], v,
                                   rtol=LOSS_RTOL, atol=1e-12, err_msg=k)
    for name, g in one["grads"].items():
        err = float(np.abs(two["grads"][name] - g).max())
        tol = GRAD_TOL * float(np.abs(g).max()) + 1e-7
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_ranks_stay_replicas_after_a_step(ranks, variant):
    """Both ranks hold the same state after the step, within 1e-5 of one
    process's (exempt under train-mode BatchNorm: the biases before it)."""
    one = ranks["one"][variant]["state"]
    first, second = (out["steps"][variant]["state"] for out in ranks["outs"])
    bn_train = VARIANTS[variant][0]
    exempt = set()
    if bn_train:
        exempt = {k.replace(".1.running_mean", ".0.bias")
                  for k in one if k.endswith(".1.running_mean")}
    for name, value in one.items():
        np.testing.assert_array_equal(first[name], second[name],
                                      err_msg=name)
        if name in exempt or name.endswith("num_batches_tracked"):
            continue
        if "running_" in name:
            np.testing.assert_allclose(first[name], value, rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        else:
            assert float(np.abs(first[name] - value).max()) < 1e-5, name
    if bn_train:
        moved = [k for k in one if k.endswith("running_mean") and
                 not np.array_equal(one[k], ranks["steps"][variant][
                     "state"][k].numpy())]
        assert moved, "train-mode BatchNorm kept no running statistics"


@pytest.mark.parametrize("variant", ["production", "bn_train"])
def test_two_ranks_equal_jax_on_two_devices(ranks, variant):
    two, ref = ranks["outs"][0]["steps"][variant], ranks["jax"][variant]
    np.testing.assert_allclose(two["loss"], ref["loss"], rtol=LOSS_RTOL)
    for k, v in ref["parts"].items():
        np.testing.assert_allclose(two["parts"][k], v, rtol=LOSS_RTOL,
                                   atol=1e-12, err_msg=k)
    if variant == "bn_train":
        assert two["parts"]["directional_derivatives_loss"] > 0
    one = ranks["one"][variant]["grads"]
    for path, name, transpose in ranks["paths"]:
        want = _leaf(ref["grads"], path)
        want = want.T if transpose else want
        got = two["grads"][name].reshape(want.shape)
        err = float(np.abs(got - want).max())
        tol = GRAD_TOL * float(np.abs(want).max()) + 1e-7
        if variant == "bn_train":
            # Train-mode BatchNorm under the DD loss: the port's f32 chain
            # is ~4e-4·max|g| from float64 on the VF net, and one process
            # already sits ~1.7e-4·max|g| from JAX's one device there;
            # sharding may not add to that distance.
            alone = _leaf(ref["one_device_grads"], path)
            alone = alone.T if transpose else alone
            gap = float(np.abs(one[name].reshape(want.shape) - alone).max())
            tol = max(tol, 2 * gap)
        assert err <= tol, (path, err, tol)


def test_uneven_depth_mask_is_a_global_mean(ranks):
    """The depth mask holds 2 valid rays on rank 0 and 8 on rank 1: the
    ranks' global count gives one process's loss, and per-rank means
    averaged over the ranks do not."""
    case = ranks["steps"]["uneven"]
    valid = case["batch"]["depth"][:, 0] > 0
    counts = [int(valid[local_ray_slice(N_RAYS, r, RANKS)].sum())
              for r in range(RANKS)]
    assert counts == [8 - N_INVALID, 8]
    one, two = ranks["one"]["uneven"], ranks["outs"][0]["steps"]["uneven"]
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(two["parts"]["depth_loss"],
                               one["parts"]["depth_loss"], rtol=LOSS_RTOL)
    naive, naive_depth = _naive_loss(case)
    assert abs(naive - one["loss"]) > 1e-3 * abs(one["loss"]), \
        (naive, one["loss"])
    depth = one["parts"]["depth_loss"]
    assert abs(naive_depth - depth) > 1e-2 * abs(depth), \
        (naive_depth, depth)


def test_shell_mask_reads_global_rows(ranks):
    """51 shell rows, 32 live: rank 1 holds rows 26-50, of which 26-31 are
    live by their global index (all 25 would be by a local one)."""
    case = ranks["steps"]["static_shell"]
    n_points = case["sup"]["n_points"]
    live = max((N_RAYS * (16 + case["n_fine_active"])) // 10, 1)
    assert (n_points, live) == (51, 32)
    rows = shard_rows(n_points, 1, RANKS)
    assert (rows.start, rows.stop) == (26, 51)
    one = ranks["one"]["static_shell"]["parts"]["supervision_loss"]
    two = ranks["outs"][0]["steps"]["static_shell"]["parts"][
        "supervision_loss"]
    np.testing.assert_allclose(two, one, rtol=LOSS_RTOL)


# ---------------------------------------------------------------- runners
def test_runner_epochs_on_two_ranks_equal_one_process(ranks):
    ref, out = ranks["runner_ref"], ranks["outs"][0]["runner"]
    ours, want = metric_lines(out["run_dir"]), metric_lines(ref["run_dir"])
    assert len(ours) == len(want) == 2
    for a, b in zip(ours, want):
        assert a["step"] == b["step"]
        for key in train_step.METRIC_KEYS:
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                       atol=1e-12, err_msg=key)
        for key in ("beta", "scale", "mean"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6,
                                       err_msg=key)
        assert a["learning_rate"] == b["learning_rate"]
    for epoch, state in ref["after"].items():
        for name, value in state.items():
            got = out["after"][epoch][name]
            assert float(np.abs(got - value).max()) < 1e-5, (epoch, name)
    assert out["checkpoints"] == ["0.ckpt", "1.ckpt", "latest.ckpt"]
    second = ranks["outs"][1]["runner"]
    for epoch, state in out["after"].items():
        for name, value in state.items():
            np.testing.assert_array_equal(second["after"][epoch][name],
                                          value, err_msg=name)


def test_joint_runner_on_two_ranks_equals_jax_on_two_devices(ranks):
    ref, out = ranks["joint_ref"], ranks["outs"][0]["joint"]
    assert len(out["logs"]) == len(ref["logs"]) == 2
    for ours, want in zip(out["logs"], ref["logs"]):
        keys = sorted(k for k in want if k != "rays_per_sec")
        assert keys == sorted(k for k in ours if k != "rays_per_sec")
        for k in keys:
            np.testing.assert_allclose(ours[k], want[k], rtol=1e-4,
                                       err_msg=k)
    for ours, want in zip(out["poses"], ref["poses"]):
        np.testing.assert_allclose(ours, want, atol=1e-4)
    assert "supervised_surface_loss" in out["logs"][1]
    np.testing.assert_array_equal(out["poses"][-1],
                                  ranks["outs"][1]["joint"]["poses"][-1])


# ------------------------------------------------------------ one process
def _eval_model(devices=None):
    cfg = port_config(graft._tiny_config())
    model = VectorFieldNerf(cfg, seed=7, device="cpu")
    _gain_vf(model)
    model.near, model.far = 0.0, 4.0
    if devices is not None:
        model.enable_mesh_eval(devices)
    return model


def test_sharded_eval_render_is_bit_equal():
    """``render`` of 64 rays and ``render_image`` in chunks of 16 with a
    13-ray tail (which stays on one device), perturb on, over two CPU
    slots: bit-equal to one device, draws included."""
    uv, pose, intr = camera(64, 0)
    single, spread = _eval_model(), _eval_model(["cpu", "cpu"])
    assert spread.eval_devices == [torch.device("cpu")] * 2
    a = single.render(pose, uv, intr, epoch=0)
    b = spread.render(pose, uv, intr, epoch=0)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    a = single.render_image(uv[:45], pose[0], intr[0], 0, split_size=16)
    b = spread.render_image(uv[:45], pose[0], intr[0], 0, split_size=16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(single.generator.get_state(),
                       spread.generator.get_state())


def test_octant_spread_is_bit_equal():
    model = _eval_model(["cpu", "cpu"])
    extractor = DeviceMeshExtractor(model.get_vector_field, 16,
                                    device="cpu")
    octants = list(quadrant_translations(8, 2.0))
    centroid = np.zeros(3, np.float32)
    one = extractor.extract_many(octants, centroid)
    spread = extractor.extract_many(octants, centroid,
                                    devices=model.eval_devices)
    assert sum(len(v) for v, _ in one) > 0
    for (v1, f1), (v2, f2) in zip(one, spread, strict=True):
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(f1, f2)


def test_mesh_and_slices_partition_exactly():
    n, nproc = 96, 4
    idx = np.arange(n)
    parts = [idx[local_ray_slice(n, p, nproc)] for p in range(nproc)]
    assert all(len(p) == n // nproc for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts), idx)
    parts = [idx[:51][shard_rows(51, p, nproc)] for p in range(nproc)]
    assert [len(p) for p in parts] == [13, 13, 13, 12]
    np.testing.assert_array_equal(np.concatenate(parts), idx[:51])
    assert make_mesh(1, ["cpu", "cpu"]) == [torch.device("cpu")]


_INIT = """
import logging, sys
logging.basicConfig(level=logging.WARNING)
from vf_nerf_torch.parallel.multihost import initialize_multihost
{call}
"""


def _run_init(call, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", _INIT.format(call=call)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)


def test_initialize_multihost_raises_on_an_explicit_bad_cluster(tmp_path):
    """Rank 1 of 2 with no rank 0: the request raises after its timeout,
    and never continues as one process."""
    proc = _run_init(
        f"initialize_multihost('file://{tmp_path}/store', 2, 1, "
        "backend='gloo', device='cpu', timeout_s=2)\nprint('JOINED')",
        tmp_path)
    assert proc.returncode != 0, proc.stdout
    assert "JOINED" not in proc.stdout
    assert "Error" in proc.stderr, proc.stderr[-2000:]


def test_initialize_multihost_falls_back_with_a_log(tmp_path):
    proc = _run_init("print('RESULT', initialize_multihost(device='cpu'))",
                     tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "RESULT False" in proc.stdout
    assert proc.stderr.count("no cluster in the environment") == 1, \
        proc.stderr


def _cli(tmp_path, *extra):
    return subprocess.run(
        [sys.executable, "-m", "vf_nerf_torch.train.exp_runner",
         "--scene", "box", "--config_path",
         _runner_conf(tmp_path, RANKS, 1), "--expname", "cli",
         "--timestamp", "t", "--gpu", "cpu", "--offline", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))


def test_exp_runner_trains_on_two_gloo_ranks(tmp_path):
    """``--gpu cpu`` with ``num_devices = 2``: two spawned ranks train one
    epoch; rank 0 alone writes the checkpoints and the metrics."""
    proc = _cli(tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run_dir = tmp_path / "exps2" / "cli_box" / "t"
    ckpts = sorted(os.listdir(run_dir / "checkpoints" / "vf_nerf"))
    assert ckpts == ["0.ckpt", "latest.ckpt"]
    lines = metric_lines(str(run_dir))
    assert len(lines) == 1 and np.isfinite(lines[0]["loss"])
    assert proc.stdout.count("Epoch 0: Loss") == 1
    with open(run_dir / "convergence.json") as f:
        assert json.load(f)["final_loss"] == lines[0]["loss"]


def test_exp_runner_fails_when_a_rank_fails(tmp_path):
    proc = _cli(tmp_path, "--checkpoint", "missing")
    assert proc.returncode != 0
    assert "does not exist" in proc.stderr
