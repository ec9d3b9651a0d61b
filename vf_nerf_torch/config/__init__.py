"""Config subsystem: HOCON parser + dataclasses (own copy; no import of the
JAX package)."""

from vf_nerf_torch.config.parser import parse_config
from vf_nerf_torch.config.schema import (DatasetConfig, DensityConfig,
                                         DeviceConfig, RaySamplerConfig,
                                         RenderingNetConfig, SchedulerConfig,
                                         VFLossConfig, VFLossWeights,
                                         VFNerfConfig, VFNetConfig,
                                         VFRunnerConfig,
                                         VFSupervisedLossWeights)
