"""The joint stage's command line and config parsing (port of
``vf_nerf_tpu/config/joint_parser.py``; reference
``config_parser/joint_opt_config_parser.py:13-65``): two HOCON files, the
VF runner's conf (``--vf_config_path``, whose ``supervised_loss_weights``
block the stage reads) and the joint conf (``--joint_config_path``);
``num_epochs`` becomes ``supervised_vf_epochs`` (``:63``). ``--gpu cpu``
runs on the CPU; any other value, the default included, on CUDA."""

from __future__ import annotations

import argparse

from vf_nerf_torch.config import hocon
from vf_nerf_torch.config.joint_schema import (JointOptimizationConfig,
                                               TrainConfig)
from vf_nerf_torch.config.parser import parse_config as parse_vf_config
from vf_nerf_torch.config.schema import VFSupervisedLossWeights


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SupervisedVFRunner")
    parser.add_argument("--scene", type=str, default="65", help="Scene name.")
    parser.add_argument("--vf_config_path", type=str,
                        default="./confs/vf_nerf.conf")
    parser.add_argument("--joint_config_path", type=str,
                        default="./confs/joint_optimization.conf")
    parser.add_argument("--gpu", type=str, default="auto",
                        help="'cpu' runs on the CPU; any other value runs "
                             "on CUDA.")
    parser.add_argument("--expname", type=str, default="dtu")
    parser.add_argument("--timestamp", type=str, default="")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--data_root_dir", type=str, default="data")
    parser.add_argument("--offline", action="store_true")
    return parser


def parse_config(scene: str,
                 vf_config_path: str = "confs/vf_nerf.conf",
                 joint_config_path: str = "confs/joint_optimization.conf",
                 gpu: str = "auto",
                 expname: str = "dtu",
                 timestamp: str = "",
                 checkpoint: str = "",
                 data_root_dir: str = "data",
                 offline: bool = False) -> JointOptimizationConfig:
    config_vf = parse_vf_config(scene, vf_config_path, gpu, expname,
                                timestamp, checkpoint, data_root_dir,
                                offline)
    vf_conf = hocon.parse_file(vf_config_path)
    config_vf.supervised_loss_weights = VFSupervisedLossWeights(
        **vf_conf["supervised_loss_weights"])

    joint_conf = hocon.parse_file(joint_config_path)
    train_config = TrainConfig(**joint_conf["train"])
    config = JointOptimizationConfig(config_vf, train_config,
                                     **joint_conf["joint_optimization"])
    config.vf_config.num_epochs = config.train_config.supervised_vf_epochs
    return config
