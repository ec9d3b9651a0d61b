"""The joint pose-and-field stage's config (port of
``vf_nerf_tpu/config/joint_schema.py``; reference
``config_parser/joint_opt_config.py:9-29``). The reference ships this
contract and no trainer; ``train/joint_runner.py`` is the JAX package's
design, ported."""

from __future__ import annotations

from dataclasses import dataclass

from vf_nerf_torch.config.schema import VFRunnerConfig


@dataclass
class TrainConfig:
    """The stage's schedule (reference ``joint_opt_config.py:9-18``) and the
    JAX package's pose-refinement extensions."""

    initial_training_epochs: int
    supervised_vf_epochs: int
    joint_epochs: int
    supervise_every: int
    supervision_epochs: int
    refinement_init_lr: float = 1e-4
    reset_scheduler: bool = False
    # The poses' Adam learning rate (0: refinement_init_lr).
    pose_lr: float = 0.0
    # The first joint epochs move the poses only, the field frozen.
    pose_only_epochs: int = 0
    # Final / initial pose lr over the pose-only epochs (exponential decay;
    # 1.0 keeps it constant); the later epochs run at the final value.
    pose_lr_decay: float = 1.0
    # Zero pose 0's gradient before Adam: the first camera fixes the gauge
    # (the global similarity that the photometric loss cannot observe).
    anchor_first_pose: bool = False


@dataclass
class JointOptimizationConfig:
    """Reference ``joint_opt_config.py:21-29``."""

    vf_config: VFRunnerConfig
    train_config: TrainConfig

    save_frequency: int
    num_bases: int
    decimation: float
    self_supervise: bool
