"""Training entry point (port of ``vf_nerf_tpu/train/exp_runner.py``;
reference ``train/vf_nerf_exp_runner.py:10-21``): arguments → config →
runner → ``train()``, on CUDA unless ``--gpu cpu``. Usage::

    python -m vf_nerf_torch.train.exp_runner --scene office0 \\
        --expname replica --config_path confs/vf_nerf.conf \\
        [--timestamp T --checkpoint latest] [--gpu cpu]

Data parallel: when the conf's ``device { num_devices }`` asks for more
than one device (0: every local card) and no cluster is in the
environment, one process per device is spawned (NCCL on CUDA, gloo with
``--gpu cpu``, which runs that many ranks on the CPU); under ``torchrun``
each process joins the group from the environment. A rank that fails makes
the command exit non-zero.
"""

from __future__ import annotations

from vf_nerf_torch.config.parser import (argparser, config_device,
                                         parse_config, requested_devices)
from vf_nerf_torch.config.schema import VFRunnerConfig
from vf_nerf_torch.parallel.multihost import launch
from vf_nerf_torch.train.runner import VectorFieldNerfRunner


def train(config: VFRunnerConfig) -> None:
    VectorFieldNerfRunner(config).train()


def main() -> None:
    args = argparser().parse_args()
    config = parse_config(scene=args.scene, config_path=args.config_path,
                          gpu=args.gpu, expname=args.expname,
                          timestamp=args.timestamp,
                          checkpoint=args.checkpoint,
                          data_root_dir=args.data_root_dir,
                          offline=args.offline)
    launch(train, (config,), config_device(config),
           requested_devices(config))


if __name__ == "__main__":
    main()
