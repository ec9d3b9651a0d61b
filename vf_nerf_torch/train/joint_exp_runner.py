"""The joint pose-and-field stage's command line (port of
``vf_nerf_tpu/train/joint_exp_runner.py``). Runs on CUDA unless given
``--gpu cpu``; without CUDA it raises.

Usage::

    python -m vf_nerf_torch.train.joint_exp_runner --scene office0 \\
        --expname replica --vf_config_path confs/vf_nerf.conf \\
        --joint_config_path confs/joint_optimization.conf \\
        [--timestamp T --checkpoint latest] [--gpu cpu]

Data parallel as ``exp_runner``: the VF conf's ``num_devices`` ranks are
spawned, or ``torchrun``'s joined.
"""

from __future__ import annotations

from vf_nerf_torch.config.joint_parser import argparser, parse_config
from vf_nerf_torch.config.joint_schema import JointOptimizationConfig
from vf_nerf_torch.config.parser import config_device, requested_devices
from vf_nerf_torch.parallel.multihost import launch
from vf_nerf_torch.train.joint_runner import JointOptimizationRunner


def train(config: JointOptimizationConfig) -> None:
    JointOptimizationRunner(config).train()


def main() -> None:
    args = argparser().parse_args()
    config = parse_config(scene=args.scene,
                          vf_config_path=args.vf_config_path,
                          joint_config_path=args.joint_config_path,
                          gpu=args.gpu, expname=args.expname,
                          timestamp=args.timestamp,
                          checkpoint=args.checkpoint,
                          data_root_dir=args.data_root_dir,
                          offline=args.offline)
    launch(train, (config,), config_device(config.vf_config),
           requested_devices(config.vf_config))


if __name__ == "__main__":
    main()
