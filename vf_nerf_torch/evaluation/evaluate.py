"""Evaluation entry point (port of
``vf_nerf_tpu/evaluation/evaluate.py:27-58, 107-112, 126-138``; reference
``evaluation/evaluate.py:14-159``).

Eval forces ``perturb=False`` and ``dir_to_normal_th=-0.2`` (reference
``:30-32``), grows the fine-sample count again from the checkpoint's epoch
on top of the restored count (``:37-41``), and writes under
``<eval_folder>/<expname>/<timestamp>_<checkpoint>/``. Ported:
``render-images``, ``metrics``, ``marching-cubes-mesh`` and
``quadrant-marching-cubes-mesh`` (each in its plain and two smoothed
variants), ``tsdf-mesh`` and ``3d-metrics``. The plot methods, and so
``all``, raise ``NotImplementedError``: they need ``matplotlib``, which the
card's machine lacks (``ROADMAP.md`` A.7). On CUDA unless the config asks
for the CPU (``--gpu cpu``) or ``device`` says so. With more than one
local card the eval render and the quadrant MC's octants spread over all
of them (``VectorFieldNerf.enable_mesh_eval``). Usage::

    python -m vf_nerf_torch.evaluation.evaluate --scene office0 \\
        --expname replica --timestamp T --checkpoint latest --method metrics
    python -m vf_nerf_torch.evaluation.evaluate ... \\
        --method quadrant-marching-cubes-mesh --resolution 256 \\
        --num_quadrants 8
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from vf_nerf_torch.config.parser import (config_device, eval_argparser,
                                         parse_config)
from vf_nerf_torch.config.schema import VFRunnerConfig
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.evaluation import methods
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import io as io_utils

PORTED = ("marching-cubes-mesh", "quadrant-marching-cubes-mesh",
          "render-images", "metrics", "tsdf-mesh", "3d-metrics")
NOT_PORTED = ("plot-2d-slices", "plot-overall-scene", "plot-3d-slices", "all")
# Timestamps of external baselines' meshes, scored by metrics_3d_no_vf
# (JAX ``evaluate.py:126-138``).
BASELINES = ("monosdf", "neuralangelo", "neuris", "manhattan_sdf", "mono_sdf")
# The variants of both marching-cubes methods: (subfolder suffix,
# smooth_all, smooth_after).
MC_VARIANTS = (("", False, False), ("-smoothed", True, False),
               ("-smoothed-after", False, True))


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
    if model.device.type == "cuda" and torch.cuda.device_count() > 1:
        # Every local card renders and extracts (JAX evaluate.py:54-57).
        model.enable_mesh_eval()
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
            f"eval method {method!r} needs the plots, which need matplotlib "
            f"and are not ported yet (ROADMAP.md A.7); ported: "
            f"{', '.join(PORTED)}")
    if method not in PORTED:
        raise ValueError(f"unknown eval method {method!r}")
    model, epoch = eval_model(config, device)
    eval_folder = os.path.join(eval_root_folder, config.expname,
                               f"{config.timestamp}_{config.checkpoint}")
    io_utils.mkdir_ifnotexists(eval_folder)
    print("Evaluating the model.")
    dcfg = config.dataset_config
    if method in ("marching-cubes-mesh", "quadrant-marching-cubes-mesh"):
        dataset = dataset_dict[dcfg.dataset_name](dcfg)
        quadrant = method == "quadrant-marching-cubes-mesh"
        for suffix, smooth_all, smooth_after in MC_VARIANTS:
            kw = dict(scale=dataset.scale, max_batch=100000,
                      centroid=dataset.get_centroid(),
                      smooth_after=smooth_after, smooth_all=smooth_all)
            if quadrant:
                methods.quadrant_marching_cubes(
                    model, resolution,
                    os.path.join(eval_folder, "merged-mesh" + suffix),
                    config.checkpoint, num_quadrants=num_quadrants, **kw)
            else:
                methods.marching_cubes_mesh(
                    model, resolution, os.path.join(eval_folder,
                                                    "mesh" + suffix),
                    config.checkpoint, **kw)
    elif method == "render-images":
        methods.render_images(model, eval_folder, dcfg, epoch, chunk_size)
    elif method == "metrics":
        methods.metrics(model, eval_folder, dcfg, epoch, chunk_size)
    elif method == "tsdf-mesh":
        methods.tsdf_mesh(eval_folder, dcfg)
    elif config.timestamp in BASELINES:
        methods.metrics_3d_no_vf(eval_folder, config.checkpoint, dcfg,
                                 distance_thresh=distance_thresh)
    else:
        methods.metrics_3d(eval_folder, dcfg, distance_thresh=distance_thresh)
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
