"""The port's joint pose-and-field stage against the benchmark's plain
reference (``benchmark/plain/joint.py``), on the CPU, at a small size: the
shipped joint configuration (``benchmark/configs/vf_nerf_joint.json``) with
narrow nets (``benchmark/tests/conftest.py::narrow``), the synthetic office
with 4 views of 16×24 and 64 rays a step (16 from each view), seeded random
weights with BatchNorm calibrated (``benchmark/program.py``), fine count 8,
and each view's pose perturbed as in the ``joint.refine.office`` cell
(1.5°, 0.02; ``benchmark/kinds/joint.py::perturbed_pose7``).

One supervised step, then one joint step, as a supervision block and the
epoch after it run them: ``supervised_step`` and ``joint_step``'s loss
(``supervised_loss`` / ``joint_loss``), gradients (``_grads``) and Adam
(``_apply``), each against the reference's chain from the same weights,
poses, points, batch, draws and bases. One case per quantity. Tolerances:

- a loss or a part of it, rtol 1e-5: the port folds BatchNorm into the
  Linear layers and the reference does not, so each float32 sum rounds
  differently (measured: within 3.4e-7);
- a gradient, per tensor max |Δ| ≤ 1e-4·max|g_ref| + 1e-7, the JAX joint
  test's tolerance (measured: within 4.1e-5·max|g_ref|);
- after Adam, the change of every coordinate within 1e-3·lr, plus two
  float32 ulps of the coordinate (a change is the difference of two
  float32 values), of the reference's where |g_ref| ≥ 1e-3·max|g_ref| of
  its tensor: Adam's first steps move a coordinate by about the learning
  rate whatever its gradient's size, so one whose gradient is rounding
  noise may move either way.

Also: a runner handed the scene its conf names equals the runner that
builds it, bit for bit, over one epoch with its supervision block.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.kinds.joint import (joint_config, named_leaves,
                                   perturbed_pose7)
from benchmark.plain import joint as ref
from benchmark.tests.conftest import narrow
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.models.renderer import param_groups
from vf_nerf_torch.train.joint_runner import JointOptimizationRunner

ROOT = Path(__file__).resolve().parents[1]
CONF = json.loads((ROOT / "benchmark" / "configs" /
                   "vf_nerf_joint.json").read_text())
SCENE = {"n_views": 4, "image_size": [16, 24], "pitch_range": 1.1}
RAYS, FINE, SEED = 64, 8, 20260
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-3
EPS32 = float(np.finfo(np.float32).eps)


def small_conf():
    return narrow(copy.deepcopy(CONF))


def small_joint_runner(tmp_path, conf=None, seed=SEED, dataset=True):
    """A joint runner on the small office with the benchmark's weights and
    perturbed poses; returns (runner, conf, weights, start poses)."""
    conf = conf or small_conf()
    cfg = joint_config(conf, str(tmp_path), "cpu")
    ds = program.office(SCENE, seed, RAYS, shuffle_views=True) \
        if dataset else None
    runner = JointOptimizationRunner(cfg, device="cpu", dataset=ds)
    runner.model.fine_n_samples = FINE
    scene = program.scene_arrays(runner.dataset, torch.device("cpu"))
    weights = program.make_weights(conf, seed + 1, "cpu", 3.5)
    program.calibrate_batch_norm(conf, weights, scene, seed + 2,
                                 n_points=4096)
    program.load_weights(runner.model.modules, weights)
    poses = perturbed_pose7(runner.dataset.poses, seed + 3, 1.5, 0.02)
    runner.pose_params = poses
    return runner, conf, weights, poses


def named_grads(runner, model_grads, pose_grad):
    """``_grads``' output by the benchmark's names."""
    where = {id(p): (k, i) for k, v in param_groups(
        runner.model.modules).items() for i, p in enumerate(v)}
    out = {n: model_grads[where[id(p)][0]][where[id(p)][1]]
           for n, p in named_leaves(runner) if n != "poses"}
    out["poses"] = pose_grad
    return out


def state(runner):
    return {n: p.detach().clone() for n, p in named_leaves(runner)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both sides' supervised step and joint step: their losses, gradients
    and the state after each step's Adam."""
    runner, conf, weights, poses = small_joint_runner(
        tmp_path_factory.mktemp("joint_ref"))
    runner._bases = runner.dominant_bases()
    arrays = runner.supervision_batch(np.random.RandomState(1))
    batch = runner._feed(next(runner.dataset.epoch_batches(
        np.random.RandomState(2))))
    gen = torch.Generator().manual_seed(3)
    n_c = conf["ray_sampler"]["n_samples"]
    draws = {k: torch.rand((RAYS, n), generator=gen) for k, n in
             (("t_coarse", n_c), ("t_fine", FINE), ("u_extra", FINE))}
    near, far = (float(np.float32(x)) for x in runner.dataset.get_bounds())
    prog = {}
    total, parts = runner.supervised_loss(*arrays)
    mg, pg = runner._grads(total, with_model=True)
    runner._apply(mg, pg)
    prog["sup"] = dict({k: float(v.detach()) for k, v in parts.items()},
                       loss=float(total.detach()),
                       grads=named_grads(runner, mg, pg), after=state(runner))
    total, parts = runner.joint_loss(
        batch, draws, runner.model.render_statics(), near, far,
        torch.as_tensor(runner.model.window_weights))
    mg, pg = runner._grads(total, with_model=True)
    runner._apply(mg, pg)
    prog["joint"] = dict({k: float(v.detach()) for k, v in parts.items()},
                         loss=float(total.detach()),
                         grads=named_grads(runner, mg, pg),
                         after=state(runner))

    model = ref.Model(conf)
    p = {k: v.clone() for k, v in weights.items()}
    p["poses"] = torch.as_tensor(poses)
    names = [n for n in ref.trainable(p) if n != "poses"]
    lr = conf["joint"]["train"]["refinement_init_lr"]
    field_adam, pose_adam = ref.Adam(lr, names), ref.Adam(lr, ["poses"])
    w = conf["supervised_loss_weights"]
    surface, snapped, off, off_gt = arrays
    s_gt, o_gt, n_off = ref.supervision_targets(
        model, p, surface, off, torch.as_tensor(runner._bases))
    assert torch.equal(s_gt, snapped) and n_off == 0
    torch.testing.assert_close(o_gt, off_gt, rtol=1e-6, atol=1e-7)
    want = {}
    for part in ("sup", "joint"):
        leaves = {n: p[n].detach().requires_grad_() for n in names +
                  ["poses"]}
        p.update(leaves)
        if part == "sup":
            total, parts = ref.supervised_loss(model, p, surface, s_gt, off,
                                               o_gt, w)
        else:
            total, parts, _ = ref.joint_loss(
                model, p, p["poses"], batch, near, far,
                (draws["t_coarse"], draws["t_fine"], draws["u_extra"]),
                FINE, w, conf["loss"]["config"]["depth_loss_clamp"])
        g = ref.gradients(total, leaves)
        field_adam.step(p, g)
        pose_adam.step(p, g if part == "joint" else
                       {"poses": torch.zeros_like(p["poses"])})
        want[part] = dict({k: float(v.detach()) for k, v in parts.items()},
                          loss=float(total.detach()), grads=g,
                          after={k: v.detach() for k, v in p.items()
                                 if k in g})
    before = dict(weights, poses=torch.as_tensor(poses))
    return prog, want, before, lr


QUANTITIES = [f"sup.{k}" for k in ("loss", "surface_loss",
                                   "non_surface_loss", "grads", "after")] + \
    [f"joint.{k}" for k in ("loss", "rgb_loss", "depth_loss",
                            "unit_norm_loss", "similarity_loss",
                            "pose_grad", "grads", "poses_after", "after")]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_step_matches_the_plain_reference(steps, quantity):
    prog, want, before, lr = steps
    part, what = quantity.split(".")
    got, ref_ = prog[part], want[part]
    if what.endswith("loss"):
        assert got[what] == pytest.approx(ref_[what], rel=LOSS_RTOL)
        return
    if what in ("grads", "pose_grad"):
        names = ["poses"] if what == "pose_grad" else \
            [n for n in ref_["grads"] if n != "poses"]
        for n in names:
            g_ref = ref_["grads"][n]
            err = float((got["grads"][n] - g_ref).abs().max())
            tol = GRAD_TOL * float(g_ref.abs().max()) + 1e-7
            assert err <= tol, f"{quantity} {n}: max |Δ| {err} > {tol}"
        if what == "pose_grad":
            assert float(ref_["grads"]["poses"].abs().max()) > 0
        return
    # The state after Adam: each coordinate's change, where its gradient
    # is well above rounding.
    names = ["poses"] if what == "poses_after" else \
        [n for n in ref_["after"] if n != "poses"]
    moved = 0
    for n in names:
        g_ref = ref_["grads"][n]
        sure = g_ref.abs() >= 1e-3 * g_ref.abs().max()
        start = prog["sup"]["after"][n] if part == "joint" else before[n]
        start_ref = want["sup"]["after"][n] if part == "joint" else before[n]
        d, d_ref = got["after"][n] - start, ref_["after"][n] - start_ref
        tol = STEP_TOL * lr + 2 * EPS32 * start.abs()
        over = ((d - d_ref).abs() - tol)[sure]
        err = float(over.max()) if sure.any() else 0.0
        assert err <= 0.0, f"{quantity} {n}: {err} over"
        moved += int((d_ref[sure] != 0).sum())
    assert moved > 0


def test_a_given_dataset_equals_the_conf_s_own(tmp_path):
    """The constructor's ``dataset``: the scene the conf names, built
    outside and handed in, gives the runner that builds it itself, bit for
    bit: poses, bounds, decay steps and one epoch with its block."""
    conf = small_conf()
    conf["dataset"]["pixels_per_batch"] = 96
    cfg = joint_config(conf, str(tmp_path / "a"), "cpu")
    runners = [JointOptimizationRunner(cfg, device="cpu")]
    cfg = joint_config(conf, str(tmp_path / "b"), "cpu")
    ds = dataset_dict[cfg.vf_config.dataset_config.dataset_name](
        cfg.vf_config.dataset_config)
    runners.append(JointOptimizationRunner(cfg, device="cpu", dataset=ds))
    a, b = runners
    assert b.dataset is ds
    assert np.array_equal(a.pose_params, b.pose_params)
    assert a.model.decay_steps == b.model.decay_steps == \
        cfg.train_config.joint_epochs * len(ds)
    assert (a.model.near, a.model.far) == (b.model.near, b.model.far)
    for r in runners:
        gen = torch.Generator().manual_seed(4)
        r.model.generator = gen
        r.train_epoch(0)
    assert np.array_equal(a.pose_params, b.pose_params)
    sa, sb = state(a), state(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("given_draws", [True, False],
                         ids=["given_draws", "generator_draws"])
def test_a_replayed_step_equals_the_eager_one(tmp_path, given_draws):
    """``StepGraph``'s plumbing, with ``EagerGraph`` standing in for the
    CUDA graph: two epochs (the first with its supervision block; its
    first step eager, its second captured, the rest replayed with their
    batch, draws, window and sums copied in and Adam's numbers read from
    0-d tensors) give the eager runner's poses, field, moments, counts,
    epoch means and last record, bit for bit."""
    from vf_nerf_torch.train.joint_runner import EagerGraph
    made = [small_joint_runner(tmp_path / name) for name in "ab"]
    runners = [m[0] for m in made]
    a, b = runners
    b.cuda_graphs, b.graph_factory = True, EagerGraph
    n_c = made[0][1]["ray_sampler"]["n_samples"]
    logs = []
    for r in runners:
        r.model.generator = torch.Generator().manual_seed(5)
        gen = torch.Generator().manual_seed(6)

        def draws(epoch, step):
            return {k: torch.rand((RAYS, n), generator=gen) for k, n in
                    (("t_coarse", n_c), ("t_fine", FINE),
                     ("u_extra", FINE))}
        logs.append([r.train_epoch(e, draws if given_draws else None)
                     for e in range(2)])
    assert b._step_graph is not None
    for log in logs:
        for epoch in log:
            epoch.pop("rays_per_sec")           # a wall-clock rate
    assert logs[0] == logs[1]
    sa, sb = state(a), state(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("model_opt", "pose_opt"):
        oa, ob = getattr(a, name), getattr(b, name)
        assert oa.count == ob.count == 2 * len(a.dataset) + \
            a.config.train_config.supervision_epochs
        for key in ("mu", "nu"):
            for k, v in getattr(oa, key).items():
                assert all(torch.equal(x, y) for x, y in
                           zip(v, getattr(ob, key)[k], strict=True))
    la, lb = a.last_step, b.last_step
    assert all(torch.equal(la["parts"][k], lb["parts"][k])
               for k in la["parts"])
    assert all(torch.equal(la["render"][k], lb["render"][k])
               for k in la["render"])
    assert all(torch.equal(p, q) and torch.equal(g, h) for (p, g), (q, h) in
               zip(la["grads"], lb["grads"], strict=True))
