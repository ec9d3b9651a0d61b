"""HOCON → config dataclasses (the port's copy of
``vf_nerf_tpu/config/parser.py::parse_config``; reference
``config_parser/vf_nerf_config_parser.py:44-108``)."""

from __future__ import annotations

from vf_nerf_torch.config import hocon
from vf_nerf_torch.config.schema import (DatasetConfig, DensityConfig,
                                         DeviceConfig, RaySamplerConfig,
                                         RenderingNetConfig, SchedulerConfig,
                                         VFLossConfig, VFLossWeights,
                                         VFNerfConfig, VFNetConfig,
                                         VFRunnerConfig,
                                         VFSupervisedLossWeights)


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
