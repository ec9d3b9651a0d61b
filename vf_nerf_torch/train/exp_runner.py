"""Training entry point (port of ``vf_nerf_tpu/train/exp_runner.py``;
reference ``train/vf_nerf_exp_runner.py:10-21``): arguments → config →
runner → ``train()``, on CUDA unless ``--gpu cpu``. Usage::

    python -m vf_nerf_torch.train.exp_runner --scene office0 \\
        --expname replica --config_path confs/vf_nerf.conf \\
        [--timestamp T --checkpoint latest] [--gpu cpu]
"""

from __future__ import annotations

from vf_nerf_torch.config.parser import argparser, parse_config
from vf_nerf_torch.train.runner import VectorFieldNerfRunner


def main() -> None:
    args = argparser().parse_args()
    config = parse_config(scene=args.scene, config_path=args.config_path,
                          gpu=args.gpu, expname=args.expname,
                          timestamp=args.timestamp,
                          checkpoint=args.checkpoint,
                          data_root_dir=args.data_root_dir,
                          offline=args.offline)
    VectorFieldNerfRunner(config).train()


if __name__ == "__main__":
    main()
