"""Config dataclasses.

The port's own copy of the config contract of ``vf_nerf_tpu/config/schema.py``
(reference ``config_parser/vf_nerf_config.py:10-209``), so the same
``confs/*.conf`` HOCON files drive both packages. Field names and defaults are
kept 1:1; only the comments speak of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class DensityConfig:
    """Laplace density params (reference ``vf_nerf_config.py:10-24``)."""

    beta_bounds: List[float] = field(default_factory=lambda: [1e-4, 1e9])
    mean_bounds: List[float] = field(default_factory=lambda: [0.6, 1.0])
    scale_min: float = 0.1
    params_init: Dict[str, float] = field(
        default_factory=lambda: {"beta": 0.5, "mean": 0.7, "scale": 100.0})
    cutoff: float = -0.5


@dataclass
class VFNetConfig:
    """Vector-field MLP config (reference ``vf_nerf_config.py:27-44``)."""

    input_dims: int
    output_dims: int
    dimensions: List[int]
    feature_vector_dims: int = 0
    embedder_multires: int = 0
    weight_norm: bool = True
    batch_norm: bool = True
    skip_connection_in: Optional[List[int]] = None
    bias_init: float = 0.0
    dropout: bool = True
    dropout_probability: float = 0.0
    xavier_init: bool = True
    init: str = "center"

    def __post_init__(self) -> None:
        valid = self.init in ("center", "exterior", "") or "exterior" in self.init
        if not valid:
            raise ValueError("init must be one of [center, exterior, ''] "
                             "or contain 'exterior'")


@dataclass
class RenderingNetConfig:
    """Color MLP config (reference ``vf_nerf_config.py:47-59``)."""

    output_dims: int
    dimensions: List[int]
    feature_vector_dims: int = 0
    weight_norm: bool = False
    batch_norm: bool = True
    mode: str = "idr"
    embedder_multires: int = 0
    detach_normals: bool = False

    def __post_init__(self) -> None:
        if self.mode not in ("idr", "no_view_dir", "no_normals"):
            raise ValueError(f"Invalid rendering mode: {self.mode}")


@dataclass
class RaySamplerConfig:
    """Ray sampler config (reference ``vf_nerf_config.py:62-78``)."""

    n_samples: int = 64
    n_importance: int = 64
    rays_per_batch: int = 1024
    perturb: bool = True
    near: float = 0.0
    far: float = 1.0
    fine_range: float = 0.5
    increase_every: int = 100
    max_samples: int = 100

    def fine_sampling(self) -> bool:
        return self.n_importance > 0


@dataclass
class DeviceConfig:
    """Device section of a conf, with the JAX package's keys so every conf
    parses. The port reads ``platform`` ("cpu" picks the CPU, as
    ``--gpu cpu`` does), ``num_devices`` (data parallel),
    ``static_fine_growth``, ``compute_dtype`` ("float32", "bfloat16" or
    "float16": ``models/renderer.py::COMPUTE_DTYPES``) and ``train_remat``
    ("none", "full" or "dots"); ``steps_per_dispatch`` belongs to the JAX
    package's TPU dispatch."""

    platform: str = ""
    num_devices: int = 0
    steps_per_dispatch: int = 64
    static_fine_growth: bool = False
    compute_dtype: str = "float32"
    train_remat: str = "none"


@dataclass
class SchedulerConfig:
    """Optimizer/schedule config (reference ``vf_nerf_config.py:90-96``)."""

    lr: float = 1e-3
    lr_decay_factor: float = 0.5
    lr_decay_steps: int = 50000
    clip_norm: float = 0.5
    weight_decay: float = 0.0


@dataclass
class VFNerfConfig:
    """Model facade config (reference ``vf_nerf_config.py:99-132``)."""

    vf_net_config: VFNetConfig
    rendering_net_config: RenderingNetConfig
    ray_sampler_config: RaySamplerConfig
    device_config: DeviceConfig
    scheduler_config: SchedulerConfig
    density_config: DensityConfig

    cos_sim_weights: Tuple[float, ...]
    cos_sim_weights_anneal: str
    anneal_start: int
    anneal_end: int

    rendering: str
    normalize_rendering: bool
    dir_to_normal_th: float = -2.0
    numerical_jacobian: bool = False
    border_supervision: bool = True
    center_supervision: bool = True

    def __post_init__(self) -> None:
        if self.cos_sim_weights_anneal not in ("none", "hard", "soft",
                                               "anneal_fine"):
            raise ValueError(
                f"Invalid cos_sim_weights_anneal: {self.cos_sim_weights_anneal}")
        if self.rendering not in ("nerf", "volsdf"):
            raise ValueError(f"Invalid rendering: {self.rendering}")
        self.cos_sim_weights = tuple(float(w) for w in self.cos_sim_weights)


@dataclass
class VFLossWeights:
    """Loss term weights (reference ``vf_nerf_config.py:135-142``)."""

    rgb: float
    depth: float
    unit_norm: float
    supervision: float
    norm_smaller_than_one: float
    directional_derivatives: float


@dataclass
class VFLossConfig:
    """Loss gates/clamps (reference ``vf_nerf_config.py:145-149``)."""

    norm_smaller_than_one_start: int
    depth_loss_clamp: float
    directional_derivatives_start: int = 100
    mask_invalid_depth: bool = False


@dataclass
class VFSupervisedLossWeights:
    """Joint-optimization supervised loss weights (reference
    ``vf_nerf_config.py:152-162``)."""

    surface: float
    non_surface: float
    supervision: float
    rgb: float
    depth: float
    unit_norm: float
    similarity: float
    colors: float = 0.0
    directional_derivatives: float = 0.0


@dataclass
class DatasetConfig:
    """Dataset config (reference ``vf_nerf_config.py:165-182``)."""

    dataset_name: str
    data_dir: str
    shuffle_views: bool
    pixels_per_batch: int
    scene: str
    data_root_dir: str
    all_pixels: bool = False
    factor: int = 20
    white_bkgd: bool = False
    split: str = "train"
    precrop_epochs: int = -10
    precrop_frac: float = 0.5
    far_per_ray: bool = False
    random_img_sampling: bool = False
    border_radius: float = 0.3
    crop_edge: int = 10


@dataclass
class VFRunnerConfig:
    """Top-level runner config (reference ``vf_nerf_config.py:185-209``)."""

    dataset_config: DatasetConfig
    vf_nerf_config: VFNerfConfig
    vf_loss_weights: VFLossWeights
    vf_loss_config: VFLossConfig
    num_epochs: int
    save_frequency: int
    wandb_frequency: int
    timestamp: str = ""
    checkpoint: str = ""

    supervised_loss_weights: Optional[VFSupervisedLossWeights] = None

    exps_folder: str = "exps_vf_nerf"
    config_path: str = "confs/vf_nerf.conf"

    wandb_project: str = "vf_nerf"

    start_epoch: int = 0
    expname: str = ""

    offline: bool = False
    convergence_loss_threshold: float = 0.0


def asdict_config(cfg: Any) -> Any:
    """A config dataclass tree as plain dicts and lists (for the log)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: asdict_config(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [asdict_config(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: asdict_config(v) for k, v in cfg.items()}
    return cfg
