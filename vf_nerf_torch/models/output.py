"""The render output contract ``NerfOutput`` (port of
``vf_nerf_tpu/models/output.py``; reference ``models/nerf/output.py:8-70``).

``render_rays`` returns a dict; this dataclass is the facade-level wrapper
with the reference's field names (``VectorFieldNerf.render_output``). The
reference never fills the ``fine_*`` fields (``vector_field_nerf.py:280-283,
331-338``), so they stay None here too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class NerfOutput:
    points_coarse: Optional[torch.Tensor] = None
    points_fine: Optional[torch.Tensor] = None
    coarse_normals: Optional[torch.Tensor] = None
    coarse_rgb_values: Optional[torch.Tensor] = None
    coarse_depth_map: Optional[torch.Tensor] = None
    fine_normals: Optional[torch.Tensor] = None
    fine_rgb_values: Optional[torch.Tensor] = None
    fine_depth_map: Optional[torch.Tensor] = None
    z_vals: Optional[torch.Tensor] = None
    directional_derivtives: Optional[torch.Tensor] = None  # reference's typo
    ray_dirs: Optional[torch.Tensor] = None
    coarse_colors: Optional[torch.Tensor] = None

    def fine_active(self) -> bool:
        """True when the fine branch is filled (never, as in the
        reference)."""
        return self.fine_rgb_values is not None

    def get_normals(self) -> Optional[torch.Tensor]:
        return self.fine_normals if self.fine_active() else \
            self.coarse_normals

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if v is not None}

    @staticmethod
    def from_render_dict(out: Dict[str, torch.Tensor]) -> "NerfOutput":
        """Wrap ``render_rays``' dict. The "coarse" fields carry the final
        (fine-sampled) pass, the reference's naming
        (``vector_field_nerf.py:331-338``)."""
        return NerfOutput(
            points_coarse=out["points"],
            coarse_normals=out["normals"],
            coarse_rgb_values=out["rgb"],
            coarse_depth_map=out["depth"],
            z_vals=out["z_vals"],
            directional_derivtives=out.get("dir_derivative_norms"),
            coarse_colors=out["sample_colors"].reshape(-1, 3),
        )
