"""The port's joint pose-and-field stage against the JAX package's, on the
CPU.

The scene is the JAX joint test's (``tests/test_joint_opt.py:226-260``): the
box exported in Replica format (3 views of 12×16, 96 rays per step), the
tiny conf of ``tests/test_e2e.py`` (a 3×32 VF net, a 2×32 colour net, 16
coarse + 4 fine samples) with the JAX runner's seeded weights, the VF
kernels gained by 2.5 so that the rays cross surfaces.

- ``matrix_to_pose7`` / ``pose7_to_matrix``, ``similarity_loss``,
  ``snap_to_bases``, ``utils/geometry.py`` and ``ops/projector.py`` against
  their JAX functions (rtol 1e-5; ``get_dominant_bases`` exactly, the same
  numpy and scipy code on the same PLY);
- the joint step and the supervised step against the JAX runner's step
  cores from the same weights, poses and draws: the JAX step with
  ``fast_eval=False`` (its folded path ignores ``detach_normals``,
  ``ROADMAP.md`` §C, and the tiny conf sets it), a stand-in optimizer that
  returns the gradients as its state. Loss rtol 1e-4; gradients of every
  field parameter and of the poses within 1e-4·max|g| + 1e-7 per tensor,
  the main step's tolerance (measured: loss equal to the last digit, field
  gradients 2.5e-6·max|g|, pose gradients 4.6e-6·max|g|);
- the facade's ``get_colors`` / ``get_weights_and_color`` against JAX's
  (perturb off; rtol 1e-4, atol 1e-5);
- the optimizer's grouping: in the pose-only epochs the poses move and the
  field stays bit-equal; under ``anchor_first_pose`` pose 0 stays bit-equal;
  the pose learning-rate decay equals optax's schedule, and the first
  update after the warm-up runs at its floor;
- the runner per epoch from the JAX runner's state at each epoch's start
  (as ``tests/test_torch_runner.py``), with JAX's draws: a pose-only epoch,
  then the boundary epoch with a self-supervised block; here
  ``detach_normals`` is off, since the JAX runner takes its folded path.
  Logged losses rtol 1e-4, the poses after each epoch within 1e-4 of
  JAX's (one pose step is ~1e-2);
- ``refined_poses`` after a save and a resume, and the command line's
  ``--help`` without jax.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_e2e import TINY_CONF
from test_torch_render import jax_draws
from test_torch_train_step import _leaf
from vf_nerf_torch.config.joint_parser import parse_config
from vf_nerf_torch.models.loss import similarity_loss
from vf_nerf_torch.models.renderer import param_groups
from vf_nerf_torch.ops import projector
from vf_nerf_torch.ops.rays import matrix_to_pose7, pose7_to_matrix
from vf_nerf_torch.train.joint_runner import (JointOptimizationRunner,
                                              PoseDecay, snap_to_bases)
from vf_nerf_torch.utils import geometry
from vf_nerf_torch.utils.weights import jax_param_paths, load_jax_variables
from vf_nerf_tpu.config.joint_parser import parse_config as jparse
from vf_nerf_tpu.datasets.synthetic import SyntheticBoxDataset, box_mesh
from vf_nerf_tpu.models.loss import similarity_loss as jsimilarity_loss
from vf_nerf_tpu.ops import projector as jprojector
from vf_nerf_tpu.ops import rays as jrays
from vf_nerf_tpu.train import joint_runner as jjoint
from vf_nerf_tpu.utils import geometry as jgeometry
from vf_nerf_tpu.utils.ply import save_ply

ROOT = Path(__file__).resolve().parents[1]
GAIN = 2.5
GRAD_TOL = 1e-4
JOINT_CONF = """
train {{
    initial_training_epochs = 0
    supervised_vf_epochs = 1
    joint_epochs = {epochs}
    supervise_every = {every}
    supervision_epochs = 1
    refinement_init_lr = 1e-3
    reset_scheduler = False
    pose_lr = 1e-2
    pose_only_epochs = {pose_only}
    pose_lr_decay = {decay}
    anchor_first_pose = {anchor}
}}
joint_optimization {{
    save_frequency = 1
    num_bases = 6
    decimation = 1.0
    self_supervise = True
}}
"""


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ pure functions
def _rotations(n, seed):
    from scipy.spatial.transform import Rotation
    rots = Rotation.random(n, random_state=seed).as_matrix()
    # Edge cases: identity, and half turns, where Shepperd's candidates
    # switch.
    rots[0] = np.eye(3)
    rots[1] = np.diag([1.0, -1.0, -1.0])
    rots[2] = np.diag([-1.0, 1.0, -1.0])
    rots[3] = np.diag([-1.0, -1.0, 1.0])
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = rots
    poses[:, :3, 3] = np.random.RandomState(seed).randn(n, 3)
    return poses.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pose7_conversions_match_jax(seed):
    poses = _rotations(32, seed)
    ours = matrix_to_pose7(_t(poses)).numpy()
    ref = np.asarray(jrays.matrix_to_pose7(jnp.asarray(poses)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pose7_to_matrix(_t(ref)).numpy(),
                               np.asarray(jrays.pose7_to_matrix(
                                   jnp.asarray(ref))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pose7_to_matrix(_t(ours)).numpy(), poses,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["gated", "none_gated"])
def test_similarity_loss_matches_jax(case):
    rng = np.random.RandomState(3)
    x1, x2 = rng.randn(64, 3), rng.randn(64, 3)
    v1, v2 = rng.randn(64, 3), rng.randn(64, 3)
    if case == "none_gated":
        v2 = v1.copy()                        # cosine 1: no pair counts
    args = [a.astype(np.float32) for a in (x1, x2, v1, v2)]
    ref, ref_g = jax.value_and_grad(
        lambda *a: jsimilarity_loss(*a), argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    ours = similarity_loss(*ts)
    grads = torch.autograd.grad(ours, ts)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    if case == "none_gated":
        assert float(ours) == 0.0
    for g, r in zip(grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-6)


def test_snap_to_bases_matches_jax():
    rng = np.random.RandomState(4)
    bases = rng.randn(6, 3).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    v = rng.randn(200, 3).astype(np.float32)
    v[0] = 0.0                                  # sign 0 → +1
    np.testing.assert_array_equal(
        snap_to_bases(_t(v), _t(bases)).numpy(),
        np.asarray(jjoint.snap_to_bases(jnp.asarray(v), jnp.asarray(bases))))


def test_geometry_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    cam = (rng.randn(16, 3) * 0.1).astype(np.float32)
    dirs = rng.randn(16, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(
        geometry.compute_sphere_intersections(_t(cam), _t(dirs)).numpy(),
        np.asarray(jgeometry.compute_sphere_intersections(
            jnp.asarray(cam), jnp.asarray(dirs))), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="BOUNDING SPHERE"):
        geometry.compute_sphere_intersections(_t(cam + 5.0), _t(dirs))
    pts, vecs = (rng.randn(20, 3).astype(np.float32) for _ in range(2))
    u, v = (rng.randn(3).astype(np.float32) for _ in range(2))
    for a, b in zip(geometry.project_to_plane(_t(pts), _t(vecs), _t(u),
                                              _t(v)),
                    jgeometry.project_to_plane(*map(jnp.asarray,
                                                    (pts, vecs, u, v)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # get_dominant_bases on the same PLY: a box, and a noisy sphere-ish
    # mesh, at two decimations.
    verts, faces = box_mesh(1.0)
    save_ply(str(tmp_path / "box.ply"), verts, faces)
    noisy = rng.randn(300, 3).astype(np.float32)
    save_ply(str(tmp_path / "noisy.ply"), noisy,
             rng.randint(0, 300, (500, 3)).astype(np.int32))
    for name, decimation in (("box", 1.0), ("noisy", 0.4)):
        path = str(tmp_path / f"{name}.ply")
        np.testing.assert_array_equal(
            geometry.get_dominant_bases(6, decimation, path),
            jgeometry.get_dominant_bases(6, decimation, path))


def test_projector_matches_jax():
    rng = np.random.RandomState(6)
    h, w, n_views = 10, 14, 3
    cams = np.zeros((n_views, 34), np.float32)
    for v in range(n_views):
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = k[1, 1] = 8.0
        k[0, 2], k[1, 2] = w / 2, h / 2
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.randn(3) * 0.2 - np.array([0, 0, 2.0])
        cams[v] = np.concatenate([[h, w], k.ravel(), pose.ravel()])
    xyz = (rng.randn(5, 4, 3) * 0.5).astype(np.float32)
    images = rng.rand(n_views, h, w, 3).astype(np.float32)
    feats = rng.rand(n_views, h, w, 2).astype(np.float32)
    query = cams[0] + 0.1
    pix = (rng.rand(7, 2) * 20 - 3).astype(np.float32)
    pairs = [
        (projector.inbound(_t(pix), h, w),
         jprojector.inbound(jnp.asarray(pix), h, w)),
        (projector.normalize_pixels(_t(pix), h, w),
         jprojector.normalize_pixels(jnp.asarray(pix), h, w)),
        (projector.bilinear_sample(_t(images[0]), _t(pix)),
         jprojector.bilinear_sample(jnp.asarray(images[0]),
                                    jnp.asarray(pix))),
        *zip(projector.compute_projections(_t(xyz), _t(cams)),
             jprojector.compute_projections(jnp.asarray(xyz),
                                            jnp.asarray(cams))),
        (projector.compute_angle(_t(xyz), _t(query), _t(cams)),
         jprojector.compute_angle(jnp.asarray(xyz), jnp.asarray(query),
                                  jnp.asarray(cams))),
        *zip(projector.project_and_sample(_t(xyz), _t(query), _t(images),
                                          _t(cams), _t(feats)),
             jprojector.project_and_sample(*map(jnp.asarray, (
                 xyz, query, images, cams, feats)))),
    ]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy().astype(np.float64),
                                   ref.astype(np.float64), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------- runners
def _write_confs(root, detach_normals=True, **joint):
    SyntheticBoxDataset(n_images=3, image_size=(12, 16),
                        pixels_per_batch=96).export_replica_format(
        str(root), scene="boxroom")
    conf = TINY_CONF.replace("EXPS_PLACEHOLDER", str(root / "exps"))
    if not detach_normals:
        conf = conf.replace("detach_normals = True", "detach_normals = False")
    (root / "tiny.conf").write_text(conf)
    values = dict(epochs=2, every=1, pose_only=1, decay=1.0, anchor="False")
    values.update(joint)
    (root / "joint.conf").write_text(JOINT_CONF.format(**values))
    return dict(scene="boxroom", vf_config_path=str(root / "tiny.conf"),
                joint_config_path=str(root / "joint.conf"),
                data_root_dir=str(root), offline=True)


def _gain(jrunner):
    params = jax.tree_util.tree_map(np.asarray, jrunner.model.state.params)
    for scope in params["vf"].values():
        scope["Dense_0"]["kernel"] = scope["Dense_0"]["kernel"] * GAIN
    jrunner.model.state = jrunner.model.state.replace(params=params)


def _pair(root, timestamp="t", **conf):
    """The JAX runner (VF gained) and the port's, on the JAX weights and
    poses."""
    kw = _write_confs(root, **conf)
    jcfg = jparse(expname="j", timestamp=timestamp, **kw)
    # One device, as the port: on the tests' 8 virtual CPU devices the JAX
    # runner would shard, and trim 4,095 supervision points to 4,088.
    jcfg.vf_config.vf_nerf_config.device_config.num_devices = 1
    jrunner = jjoint.JointOptimizationRunner(jcfg)
    _gain(jrunner)
    runner = JointOptimizationRunner(parse_config(
        expname="p", timestamp=timestamp, gpu="cpu", **kw))
    assert runner.device.type == "cpu"
    _load_jax(runner, jrunner.model.state.params,
              jrunner.model.state.batch_stats, jrunner.pose_params)
    return jrunner, runner


def _load_jax(runner, params, batch_stats, poses):
    load_jax_variables(runner.model.modules, {
        "params": jax.device_get(params),
        "batch_stats": jax.device_get(batch_stats)})
    runner.pose_params = np.asarray(poses)


def _grad_capture():
    """A stand-in optimizer whose state after ``update`` is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _compare_grads(runner, model_grads, pose_grad, ref):
    where = {id(p): (k, i) for k, v in param_groups(
        runner.model.modules).items() for i, p in enumerate(v)}
    paths = jax_param_paths(runner.model.modules)
    assert len(paths) == sum(len(v) for v in model_grads.values())
    pairs = [(model_grads[where[id(p)][0]][where[id(p)][1]],
              _leaf(ref["model"], path).T if transpose
              else _leaf(ref["model"], path), "/".join(path))
             for path, p, transpose in paths]
    pairs.append((pose_grad, np.asarray(ref["poses"]), "poses"))
    for ours, want, name in pairs:
        err = float(np.abs(ours.detach().numpy() - want).max())
        tol = GRAD_TOL * float(np.abs(want).max()) + 1e-7
        assert err <= tol, f"grad {name}: max |Δ| {err} > {tol}"


@pytest.fixture(scope="module")
def step_pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("joint_step"))


@pytest.mark.parametrize("seed", [5, 6])
def test_joint_step_matches_jax(seed, step_pair):
    jrunner, runner = step_pair
    jrunner.joint_tx = _grad_capture()
    jstatics = dataclasses.replace(jrunner.model.render_statics(train=False),
                                   fast_eval=False)
    core = jax.jit(jrunner._joint_step_core(jstatics))
    params = {"model": jrunner.model.state.params,
              "poses": jnp.asarray(jrunner.pose_params)}
    batch = next(jrunner.dataset.epoch_batches(np.random.RandomState(seed)))
    key = jax.random.PRNGKey(seed)
    near, far = jrunner.dataset.get_bounds()
    window = np.asarray(jrunner.model.window_weights)
    zeros = {k: jnp.zeros(()) for k in jrunner.JOINT_METRICS}
    _, ref_grads, ref = core(params, jrunner.joint_tx.init(params), zeros,
                             jrunner.model.state.batch_stats,
                             jrunner._feed_rays(batch), key,
                             jnp.float32(near), jnp.float32(far),
                             jnp.asarray(window))
    total, parts = runner.joint_loss(
        runner._feed(batch), jax_draws(key, len(batch["uv"]), jstatics),
        runner.model.render_statics(), float(np.float32(near)),
        float(np.float32(far)), _t(window))
    model_grads, pose_grad = runner._grads(total, with_model=True)
    np.testing.assert_allclose(float(total), float(ref["loss"]), rtol=1e-4)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(np.abs(np.asarray(ref_grads["poses"])).max()) > 0
    _compare_grads(runner, model_grads, pose_grad, ref_grads)


def test_supervised_step_matches_jax(step_pair):
    jrunner, runner = step_pair
    bases = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    bases[0] = [0.6, 0.8, 0.0]
    jrunner._bases = runner._bases = bases
    ref_arrays = jrunner._supervision_batch(np.random.RandomState(1))
    arrays = runner.supervision_batch(np.random.RandomState(1))
    for ours, want in zip(arrays, ref_arrays):
        np.testing.assert_array_equal(ours.numpy(), want)
    jrunner.joint_tx = _grad_capture()
    core = jax.jit(jrunner._supervised_step_core())
    params = {"model": jrunner.model.state.params,
              "poses": jnp.asarray(jrunner.pose_params)}
    zeros = {k: jnp.zeros(()) for k in jrunner.SUP_METRICS}
    _, ref_grads, ref = core(params, jrunner.joint_tx.init(params), zeros,
                             jrunner.model.state.batch_stats,
                             *map(jnp.asarray, ref_arrays))
    total, parts = runner.supervised_loss(*arrays)
    model_grads, pose_grad = runner._grads(total, with_model=True)
    np.testing.assert_allclose(float(total), float(ref["loss"]), rtol=1e-4)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=1e-4)
    _compare_grads(runner, model_grads, pose_grad, ref_grads)


def test_facade_colour_surfaces_match_jax(step_pair):
    jrunner, runner = step_pair
    jmodel, model = jrunner.model, runner.model
    jmodel.config.ray_sampler_config.perturb = False
    model.config.ray_sampler_config.perturb = False
    try:
        ds = runner.dataset
        uv = ds._uv_grid()[:24]
        pose = np.broadcast_to(ds.poses[1], (24, 4, 4)).copy()
        intr = np.broadcast_to(ds.intrinsics, (24, 4, 4)).copy()
        got = model.get_colors(pose, uv, intr, epoch=0)
        ref = jmodel.get_colors(pose, uv, intr, epoch=0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
        n_rays, n = 24, jmodel.render_statics().n_coarse
        z = np.tile(np.linspace(0.3, 3.0, n, dtype=np.float32), (n_rays, 1))
        points, dirs = np.asarray(ref[1]), np.asarray(ref[2])
        got = model.get_weights_and_color(points, dirs, z, epoch=0)
        ref = jmodel.get_weights_and_color(points, dirs, z, epoch=0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    finally:
        jmodel.config.ray_sampler_config.perturb = True
        model.config.ray_sampler_config.perturb = True


def _field(runner):
    return [p.detach().clone() for ps in param_groups(
        runner.model.modules).values() for p in ps]


def test_warm_up_freezes_the_field_and_the_anchor_holds(tmp_path):
    kw = _write_confs(tmp_path, epochs=3, every=2, pose_only=2,
                      anchor="True")
    runner = JointOptimizationRunner(parse_config(
        expname="p", timestamp="a", gpu="cpu", **kw))
    field, poses = _field(runner), runner.pose_params.copy()
    for epoch in range(2):
        runner.train_epoch(epoch)
        assert all(torch.equal(a, b) for a, b in zip(field, _field(runner)))
    moved = runner.pose_params
    assert np.array_equal(moved[0], poses[0])
    assert not np.allclose(moved[1:], poses[1:])
    runner.train_epoch(2)                        # unfrozen, supervised
    assert not all(torch.equal(a, b) for a, b in zip(field, _field(runner)))
    assert np.array_equal(runner.pose_params[0], poses[0])


def test_default_conf_builds_in_process_on_a_multi_card_host(
        tmp_path, monkeypatch):
    """``num_devices = 0`` on a host with two cards: a joint runner built
    in this process (no process group) runs on its one device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = parse_config(expname="p", timestamp="multi", gpu="cpu",
                       **_write_confs(tmp_path))
    cfg.vf_config.vf_nerf_config.device_config.platform = ""   # CUDA conf
    assert cfg.vf_config.vf_nerf_config.device_config.num_devices == 0
    runner = JointOptimizationRunner(cfg, device="cpu")
    assert (runner.rank, runner.world_size) == (0, 1)


def test_pose_lr_decay_follows_optax(tmp_path):
    steps = 6
    schedule = optax.exponential_decay(1e-2, transition_steps=steps,
                                       decay_rate=0.01, end_value=1e-4)
    ours = PoseDecay(1e-2, steps, 0.01)
    for count in range(steps + 3):
        np.testing.assert_allclose(ours(count), float(schedule(count)),
                                   rtol=1e-6)
    # The runners' pose optimizers from the same unit gradients: warm-up
    # updates decay from 1e-2, and the first update after it is the floor.
    jrunner, runner = _pair(tmp_path, epochs=4, every=5, pose_only=2,
                            decay=0.01)
    params = {"model": jrunner.model.state.params,
              "poses": jnp.ones((3, 7))}
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    for freeze in (True, False):
        tx = jrunner._make_joint_tx(freeze_model=freeze)
        update = jax.jit(tx.update)
        state = tx.init(params)
        runner._make_optimizers(freeze_model=freeze)
        for _ in range(2 * len(runner.dataset) if freeze else 1):
            ref, state = update(grads, state, params)
            runner.pose_params = np.zeros((3, 7))   # so the step is exact
            runner._apply(None if freeze else {
                k: [torch.ones_like(p) for p in v] for k, v in
                param_groups(runner.model.modules).items()},
                torch.ones_like(runner.poses))
            np.testing.assert_allclose(runner.pose_params,
                                       np.asarray(ref["poses"]), rtol=1e-5)
    assert abs(float(ref["poses"][0, 0])) == pytest.approx(1e-4, rel=1e-3)


def test_runner_epochs_match_jax_from_its_state(tmp_path):
    """Two epochs: a pose-only epoch, then the boundary epoch with a
    self-supervised block. Each port epoch starts from the JAX runner's
    state at that epoch's start."""
    jrunner, runner = _pair(tmp_path, detach_normals=False)
    starts = {0: (jax.device_get(jrunner.model.state.params),
                  jrunner.pose_params.copy())}
    logs = []
    j_log = jrunner.logger.log

    def record(values, step):
        logs.append(dict(values))
        starts[step + 1] = (jax.device_get(jrunner.model.state.params),
                            jrunner.pose_params.copy())
        return j_log(values, step=step)

    jrunner.logger.log = record
    jrunner.train()
    assert len(logs) == 2

    key, subs = jax.random.PRNGKey(7), []
    for _ in range(2 * len(jrunner.dataset)):
        key, sub = jax.random.split(key)
        subs.append(sub)
    jstatics = jrunner.model.render_statics(train=False)
    n_rays = jrunner.dataset.total_pixels

    def draws(epoch, step):
        return jax_draws(subs[step], n_rays, jstatics)

    batch_stats = jrunner.model.state.batch_stats
    for epoch in range(2):
        params, poses = starts[epoch]
        _load_jax(runner, params, batch_stats, poses)
        log = runner.train_epoch(epoch, draws)
        ref = logs[epoch]
        keys = [k for k in ref if k != "rays_per_sec"]
        assert sorted(keys) == sorted(k for k in log if k != "rays_per_sec")
        for k in keys:
            np.testing.assert_allclose(log[k], ref[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(runner.pose_params, starts[epoch + 1][1],
                                   atol=1e-4)
    assert "supervised_surface_loss" in logs[1]


def test_refined_poses_survive_a_save_and_a_resume(tmp_path):
    kw = _write_confs(tmp_path, epochs=1, every=5, pose_only=1)
    runner = JointOptimizationRunner(parse_config(
        expname="p", timestamp="s", gpu="cpu", **kw))
    start = runner.pose_params.copy()
    runner.train()
    refined = runner.refined_poses()
    assert refined.shape == (3, 4, 4)
    rtr = refined[:, :3, :3] @ refined[:, :3, :3].transpose(0, 2, 1)
    np.testing.assert_allclose(rtr, np.tile(np.eye(3), (3, 1, 1)), atol=1e-5)
    assert not np.allclose(runner.pose_params, start)
    assert os.path.exists(os.path.join(runner.ckpt_dir, "latest.ckpt"))
    resumed = JointOptimizationRunner(parse_config(
        expname="p", timestamp="s", checkpoint="latest", gpu="cpu", **kw))
    np.testing.assert_array_equal(resumed.refined_poses(), refined)
    for a, b in zip(_field(runner), _field(resumed)):
        assert torch.equal(a, b)


def test_cli_help_and_parse_without_jax(tmp_path):
    code = ("import runpy, sys; sys.argv = ['joint_exp_runner', '--help'];"
            "runpy.run_module('vf_nerf_torch.train.joint_exp_runner',"
            " run_name='__main__')")
    check = ("import atexit, sys; atexit.register(lambda: print('LOADED', "
             "sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'vf_nerf_tpu'))));")
    proc = subprocess.run([sys.executable, "-c", check + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--joint_config_path" in proc.stdout
    assert "LOADED []" in proc.stdout
    kw = _write_confs(tmp_path)
    cfg = parse_config(expname="p", gpu="cpu", **kw)
    jcfg = jparse(expname="p", gpu="cpu", **kw)
    assert dataclasses.asdict(cfg.train_config) == \
        dataclasses.asdict(jcfg.train_config)
    assert cfg.vf_config.num_epochs == 1
    assert cfg.vf_config.supervised_loss_weights.supervision == 10.0
