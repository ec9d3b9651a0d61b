"""Evaluation entry point (port of
``vf_nerf_tpu/evaluation/evaluate.py:27-58, 107-112, 126-138``; reference
``evaluation/evaluate.py:14-159``).

Eval forces ``perturb=False`` and ``dir_to_normal_th=-0.2`` (reference
``:30-32``), grows the fine-sample count again from the checkpoint's epoch
on top of the restored count (``:37-41``), and writes under
``<eval_folder>/<expname>/<timestamp>_<checkpoint>/``. ``render-images`` and
``metrics`` are ported; the mesh and plot methods (and so ``all``) raise
``NotImplementedError`` until ``ROADMAP.md`` A.2. On CUDA unless the config
asks for the CPU (``--gpu cpu``) or ``device`` says so. Usage::

    python -m vf_nerf_torch.evaluation.evaluate --scene office0 \\
        --expname replica --timestamp T --checkpoint latest --method metrics
"""

from __future__ import annotations

import os
from typing import Tuple

from vf_nerf_torch.config.parser import (config_device, eval_argparser,
                                         parse_config)
from vf_nerf_torch.config.schema import VFRunnerConfig
from vf_nerf_torch.evaluation import methods
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import io as io_utils

PORTED = ("render-images", "metrics")
NOT_PORTED = ("marching-cubes-mesh", "quadrant-marching-cubes-mesh",
              "plot-2d-slices", "plot-overall-scene", "plot-3d-slices",
              "tsdf-mesh", "3d-metrics", "all")


def eval_model(config: VFRunnerConfig, device=None
               ) -> Tuple[VectorFieldNerf, int]:
    """The model of the run's ``config.checkpoint`` set up for eval, and the
    checkpoint's epoch: ``perturb`` off, the back-face threshold -0.2, the
    fine count grown again from the epoch, BatchNorm on running
    statistics."""
    path_to_model = os.path.join(config.exps_folder, config.expname,
                                 config.timestamp, "checkpoints", "vf_nerf",
                                 f"{config.checkpoint}.ckpt")
    config.vf_nerf_config.ray_sampler_config.perturb = False
    config.vf_nerf_config.dir_to_normal_th = -0.2

    device = config_device(config) if device is None else device
    model = VectorFieldNerf(config.vf_nerf_config, device=device)
    epoch = model.load(path_to_model)
    rs = config.vf_nerf_config.ray_sampler_config
    if rs.fine_sampling():
        model.fine_n_samples = min(
            model.fine_n_samples + 5 * (epoch // rs.increase_every),
            rs.max_samples)
        print(f"Fine sampler N_samples: {model.fine_n_samples}")
    model.eval()
    return model, epoch


def evaluate(config: VFRunnerConfig, method: str, resolution: int,
             eval_root_folder: str, chunk_size: int,
             distance_thresh: float, num_quadrants: int,
             device=None) -> str:
    """Run ``method`` on the run's ``config.checkpoint``; returns the eval
    folder. ``resolution``, ``distance_thresh`` and ``num_quadrants`` belong
    to the mesh methods."""
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"eval method {method!r} needs the mesh stack, which is not "
            f"ported yet (ROADMAP.md A.2); ported: {', '.join(PORTED)}")
    if method not in PORTED:
        raise ValueError(f"unknown eval method {method!r}")
    model, epoch = eval_model(config, device)
    eval_folder = os.path.join(eval_root_folder, config.expname,
                               f"{config.timestamp}_{config.checkpoint}")
    io_utils.mkdir_ifnotexists(eval_folder)
    print("Evaluating the model.")
    if method == "render-images":
        methods.render_images(model, eval_folder, config.dataset_config,
                              epoch, chunk_size)
    else:
        methods.metrics(model, eval_folder, config.dataset_config, epoch,
                        chunk_size)
    return eval_folder


def main() -> None:
    args = eval_argparser().parse_args()
    config = parse_config(scene=args.scene, config_path=args.config_path,
                          gpu=args.gpu, expname=args.expname,
                          timestamp=args.timestamp,
                          checkpoint=args.checkpoint,
                          data_root_dir=args.data_root_dir)
    evaluate(config, args.method, args.resolution, args.eval_folder,
             args.chunk_size, args.distance_thresh, args.num_quadrants)


if __name__ == "__main__":
    main()
