"""NDC ray conversion (port of ``vf_nerf_tpu/ops/ndc.py``; reference
``utils/rendering.py:63-96``, unused by the active datasets; for
forward-facing LLFF captures). Shifts the origins to the near plane, then
applies NeRF's NDC projection."""

from __future__ import annotations

from typing import Tuple

import torch


def convert_to_ndc(origins: torch.Tensor, directions: torch.Tensor,
                   intrinsics: torch.Tensor, near: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays (N, 3) origins and directions → NDC space. The focal length
    and the image size come from row 0 of ``intrinsics`` (N, 4, 4), as the
    reference takes them: width = (cx + 0.5)·2, height = (cy + 0.5)·2."""
    focal = intrinsics[0, 0, 0]
    w = (intrinsics[0, 0, 2] + 0.5) * 2.0
    h = (intrinsics[0, 1, 2] + 0.5) * 2.0

    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions

    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]

    o0 = -1.0 / (w / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (w / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return (torch.stack([o0, o1, o2], dim=-1),
            torch.stack([d0, d1, d2], dim=-1))
