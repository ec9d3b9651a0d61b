"""Dataset output contract (port of ``vf_nerf_tpu/datasets/output.py``;
reference ``datasets/helpers/dataset_output.py:8-29``): one item is a whole
ray batch of rgb, uv, per-ray intrinsics and pose (repeated 4×4), depth and
far."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class DatasetOutput:
    rgb: np.ndarray          # (N, 3) in [0, 1]
    uv: np.ndarray           # (N, 2) pixel (x, y)
    intrinsics: np.ndarray   # (N, 4, 4)
    pose: np.ndarray         # (N, 4, 4) c2w
    depth: np.ndarray        # (N, 1)
    far: np.ndarray          # (N, 1) per-ray far, or size 0

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {"rgb": self.rgb, "uv": self.uv,
                "intrinsics": self.intrinsics, "pose": self.pose,
                "depth": self.depth, "far": self.far}
