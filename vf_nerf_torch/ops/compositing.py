"""VolSDF weights and compositing (port of ``vf_nerf_tpu/ops/compositing.py``;
reference ``utils/rendering.py:122-168``). The last inter-sample distance is
1e10."""

from __future__ import annotations

from typing import Tuple

import torch

_LAST_DIST = 1e10


def _dists(z_vals: torch.Tensor) -> torch.Tensor:
    d = z_vals[:, 1:] - z_vals[:, :-1]
    last = torch.full((z_vals.shape[0], 1), _LAST_DIST, dtype=z_vals.dtype,
                      device=z_vals.device)
    return torch.cat([d, last], dim=-1)


def volsdf_volume_rendering(z_vals: torch.Tensor, density: torch.Tensor,
                            normalize: bool = True) -> torch.Tensor:
    """(R, S) alpha · transmittance weights from shifted free energy,
    optionally divided by (sum + 1e-5) per ray."""
    free_energy = _dists(z_vals) * density
    shifted = torch.cat([torch.zeros_like(free_energy[:, :1]),
                         free_energy[:, :-1]], dim=-1)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    weights = (1.0 - torch.exp(-free_energy)) * transmittance
    if normalize:
        weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-5)
    return weights


def composite_rgb_depth(weights: torch.Tensor, rgb: torch.Tensor,
                        z_vals: torch.Tensor, white_background: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sums → (rgb (R, 3), depth (R,))."""
    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    if white_background:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return rgb_map, torch.sum(weights * z_vals, dim=-1)
