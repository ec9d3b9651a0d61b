"""The command lines and HOCON → config dataclasses (the port's copy of
``vf_nerf_tpu/config/parser.py``; reference
``config_parser/vf_nerf_config_parser.py:11-108``).

The flags are the JAX package's. ``--gpu cpu`` runs on the CPU; any other
value, the default ``auto`` included, runs on CUDA and fails without it.
"""

from __future__ import annotations

import argparse

from vf_nerf_torch.config import hocon
from vf_nerf_torch.config.schema import (DatasetConfig, DensityConfig,
                                         DeviceConfig, RaySamplerConfig,
                                         RenderingNetConfig, SchedulerConfig,
                                         VFLossConfig, VFLossWeights,
                                         VFNerfConfig, VFNetConfig,
                                         VFRunnerConfig,
                                         VFSupervisedLossWeights)


_GPU_HELP = "'cpu' runs on the CPU; any other value runs on CUDA."


def argparser() -> argparse.ArgumentParser:
    """Training CLI (reference ``vf_nerf_config_parser.py:11-22``)."""
    parser = argparse.ArgumentParser(description="VFNerfRunner")
    parser.add_argument("--scene", type=str, default="65", help="Scene name.")
    parser.add_argument("--config_path", type=str,
                        default="./confs/vf_nerf.conf",
                        help="config file path")
    parser.add_argument("--gpu", type=str, default="auto", help=_GPU_HELP)
    parser.add_argument("--expname", type=str, default="dtu",
                        help="Experiment name.")
    parser.add_argument("--timestamp", type=str, default="", help="Timestamp.")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Checkpoint name (e.g. 'latest').")
    parser.add_argument("--data_root_dir", type=str, default="data",
                        help="Data root directory.")
    parser.add_argument("--offline", action="store_true",
                        help="Disable metric upload; log JSONL only.")
    return parser


def eval_argparser() -> argparse.ArgumentParser:
    """Evaluation CLI (reference ``vf_nerf_config_parser.py:25-41``)."""
    parser = argparse.ArgumentParser(description="Evaluate")
    parser.add_argument("--scene", type=str, default="65", help="Scene name.")
    parser.add_argument("--config_path", type=str,
                        default="./confs/vf_nerf.conf",
                        help="config file path")
    parser.add_argument("--gpu", type=str, default="auto", help=_GPU_HELP)
    parser.add_argument("--resolution", type=int, default=256,
                        help="Resolution.")
    parser.add_argument("--method", type=str, default="render-images",
                        help="Method.")
    parser.add_argument("--expname", type=str, default="dtu",
                        help="Experiment name.")
    parser.add_argument("--data_root_dir", type=str, default="data",
                        help="Data root directory.")
    parser.add_argument("--timestamp", type=str, default="", help="Timestamp.")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Checkpoint name.")
    parser.add_argument("--eval_folder", type=str, default="evals_vf_nerf",
                        help="Evaluation folder.")
    parser.add_argument("--chunk_size", type=int, default=1024,
                        help="Rays per render chunk.")
    parser.add_argument("--distance_thresh", type=float, default=0.05,
                        help="Distance threshold for 3d metrics.")
    parser.add_argument("--num_quadrants", type=int, default=8,
                        help="Number of quadrants for marching cubes.")
    return parser


def config_device(config: VFRunnerConfig) -> str:
    """The device a parsed config asks for: ``"cpu"`` when its platform is
    ``cpu`` (``--gpu cpu``), else ``"cuda"``."""
    platform = config.vf_nerf_config.device_config.platform
    return "cpu" if platform == "cpu" else "cuda"


def requested_devices(config: VFRunnerConfig) -> int:
    """The ranks a config asks for: ``num_devices``, or with 0 every local
    device (the CUDA cards, or the one CPU with ``--gpu cpu``)."""
    n = config.vf_nerf_config.device_config.num_devices
    if n > 0:
        return n
    if config_device(config) == "cpu":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def parse_config(scene: str,
                 config_path: str = "confs/vf_nerf.conf",
                 gpu: str = "auto",
                 expname: str = "dtu",
                 timestamp: str = "",
                 checkpoint: str = "",
                 data_root_dir: str = "data",
                 offline: bool = False,
                 num_devices: int = 0) -> VFRunnerConfig:
    """Parse a HOCON config file into a ``VFRunnerConfig``, including the
    reference's ``expname = f"{expname}_{scene}"`` mangling (``:104``)."""
    conf = hocon.parse_file(config_path)

    density_config = DensityConfig(**conf["density"])
    vf_net_config = VFNetConfig(**conf["vector_field_network"])
    render_net_config = RenderingNetConfig(**conf["rendering"])
    ray_sampler_config = RaySamplerConfig(**conf["ray_sampler"])
    scheduler_config = SchedulerConfig(**conf["scheduler"])

    # Arguments win over a conf's [device] section for the two keys both set.
    device_conf = dict(conf.get("device", {}))
    conf_platform = device_conf.pop("platform", "")
    conf_num_devices = device_conf.pop("num_devices", 0)
    device_config = DeviceConfig(
        platform=conf_platform if gpu == "auto" else gpu,
        num_devices=num_devices if num_devices else conf_num_devices,
        **device_conf)

    vf_nerf_config = VFNerfConfig(vf_net_config, render_net_config,
                                  ray_sampler_config, device_config,
                                  scheduler_config, density_config,
                                  **conf["vf_nerf"])

    dataset_config = DatasetConfig(**conf["dataset"], scene=scene,
                                   data_root_dir=data_root_dir)

    loss_config = VFLossConfig(**conf["loss"]["config"])
    loss_weights = VFLossWeights(**conf["loss"]["weights"])

    supervised = None
    if "supervised_loss_weights" in conf:
        supervised = VFSupervisedLossWeights(**conf["supervised_loss_weights"])

    return VFRunnerConfig(dataset_config, vf_nerf_config, loss_weights,
                          loss_config, **conf["train"], timestamp=timestamp,
                          checkpoint=checkpoint, expname=f"{expname}_{scene}",
                          offline=offline, config_path=config_path,
                          supervised_loss_weights=supervised)
