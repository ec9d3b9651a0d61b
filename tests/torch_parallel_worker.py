"""One rank of ``test_torch_parallel.py``'s data-parallel runs, on the CPU.

Run as ``python tests/torch_parallel_worker.py INPUTS RANK WORLD STORE``:
joins a gloo group of WORLD ranks through the file store STORE, runs every
case of the pickled INPUTS (a ``torch.save`` dict written by the test) and
writes its results to ``INPUTS.<rank>``. The step cases also run in the
test's own process with no group (``run_steps``), which is the
one-process reference. Imports no jax.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vf_nerf_torch.config import parse_config  # noqa: E402
from vf_nerf_torch.config.joint_parser import \
    parse_config as parse_joint_config  # noqa: E402
from vf_nerf_torch.models.nerf import VectorFieldNerf  # noqa: E402
from vf_nerf_torch.parallel import train_step  # noqa: E402
from vf_nerf_torch.parallel.mesh import all_reduce_flat, world  # noqa: E402
from vf_nerf_torch.parallel.multihost import (global_mesh,  # noqa: E402
                                              initialize_multihost,
                                              local_ray_slice)
from vf_nerf_torch.utils.weights import load_jax_variables  # noqa: E402


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _summed(values):
    """0-d tensors summed over the ranks, as floats."""
    stacked = torch.stack([v.detach() for v in values])
    all_reduce_flat([stacked])
    return stacked.tolist()


def step_case(case):
    """The loss, its parts and gradients (summed over the ranks), then one
    whole step: the parameters and running statistics after it."""
    rank, size = world()
    model = VectorFieldNerf(case["config"], device="cpu",
                            decay_steps=case["decay_steps"])
    model.modules.load_state_dict(case["state"])
    if case["train"]:
        model.train()
    statics = model.render_statics(
        n_fine=case["n_fine"], compute_dir_derivatives=case["dd"])
    sup = train_step.SupervisionStatics(**case["sup"])
    n = len(case["batch"]["uv"])
    rows = local_ray_slice(n, rank, size)
    batch = {k: _t(v)[rows] for k, v in case["batch"].items()}
    draws = {k: _t(v) for k, v in case["draws"].items()}
    args = (case["epoch"], _t(case["taps"]), case["near"], case["far"],
            torch.zeros(3))
    loss_fn = train_step.make_loss_fn(model.modules, statics, sup,
                                      case["weights"], case["loss_config"])
    fine = case["n_fine_active"]
    n_points = None if fine is None else \
        max((n * (statics.n_coarse + fine)) // 10, 1)
    total, parts, _ = loss_fn(batch, train_step.shard_draws(
        draws, rows, sup.n_points), *args, fine, n_points)
    params = list(model.modules.parameters())
    grads = list(torch.autograd.grad(total, params, allow_unused=True))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    all_reduce_flat(grads)
    names = list(parts)
    summed = _summed([total] + [parts[k] for k in names])
    step = train_step.make_train_step(model.modules, model.optimizer,
                                      statics, sup, case["weights"],
                                      case["loss_config"])
    sums = step(train_step.zero_metric_sums("cpu"), batch, *args,
                n_fine_active=fine, draws=draws)
    metrics = dict(zip(train_step.METRIC_KEYS,
                       _summed([sums[k] for k in train_step.METRIC_KEYS])))
    return dict(loss=summed[0], parts=dict(zip(names, summed[1:])),
                grads={name: g.numpy().copy() for (name, _), g in
                       zip(model.modules.named_parameters(), grads)},
                step_metrics=metrics,
                state={k: v.numpy().copy()
                       for k, v in model.modules.state_dict().items()})


def run_steps(cases):
    return {name: step_case(case) for name, case in cases.items()}


def runner_case(case):
    """Each epoch of ``VectorFieldNerfRunner.train()`` from the reference's
    checkpoint at its start, with the reference's (global) draws; returns
    the state after each epoch and the run's metrics file (rank 0)."""
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner
    cfg = parse_config(scene="box", config_path=case["conf"], expname="r",
                       timestamp="ranks", gpu="cpu", offline=True)
    runner = VectorFieldNerfRunner(cfg)
    train_epoch, after = runner.train_epoch, {}

    def from_start(epoch, draws=None):
        runner.model.load(case["starts"][epoch])
        logged = train_epoch(epoch, draws=draws)
        after[epoch] = copy.deepcopy(runner.model.modules.state_dict())
        return logged

    def draws(epoch, step):
        return {k: _t(v) for k, v in case["draws"][(epoch, step)].items()}

    runner.train_epoch = from_start
    runner.train(draws=draws)
    return dict(run_dir=runner.run_dir,
                after={e: {k: v.numpy() for k, v in s.items()}
                       for e, s in after.items()},
                checkpoints=sorted(p.name for p in
                                   Path(runner.ckpt_dir).iterdir()))


def joint_case(case):
    """Each joint epoch from the JAX runner's state at its start, with its
    draws: the logs and the poses after each epoch."""
    from vf_nerf_torch.train.joint_runner import JointOptimizationRunner
    cfg = parse_joint_config(expname="p", timestamp="ranks", gpu="cpu",
                             **case["kw"])
    cfg.vf_config.vf_nerf_config.device_config.num_devices = 2
    runner = JointOptimizationRunner(cfg)
    logs, poses = [], []

    def draws(epoch, step):
        return {k: _t(v) for k, v in case["draws"][step].items()}

    for epoch, (params, batch_stats, start_poses) in \
            enumerate(case["starts"]):
        load_jax_variables(runner.model.modules,
                           {"params": params, "batch_stats": batch_stats})
        runner.pose_params = start_poses
        logs.append(runner.train_epoch(epoch, draws))
        poses.append(runner.pose_params.copy())
    return dict(logs=logs, poses=poses)


def main(inputs: str, rank: int, size: int, store: str) -> None:
    initialize_multihost(f"file://{store}", size, rank, backend="gloo",
                         device="cpu", timeout_s=300)
    try:
        case = torch.load(inputs, weights_only=False)
        out = {"mesh": [str(d) for d in global_mesh("cpu")],
               "steps": run_steps(case["steps"])}
        if "runner" in case:
            out["runner"] = runner_case(case["runner"])
        if "joint" in case:
            out["joint"] = joint_case(case["joint"])
        torch.save(out, f"{inputs}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
