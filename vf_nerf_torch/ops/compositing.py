"""Volume-rendering weights and compositing (port of
``vf_nerf_tpu/ops/compositing.py``; reference ``utils/rendering.py:98-168``).
Two weight modes: ``volsdf`` (transmittance from the cumulative sum of the
shifted free energy, the trained path) and ``nerf`` (the cumprod form; the
reference calls it with its arguments swapped, the JAX package and this
port take ``(z_vals, density)`` so that the mode works). The last
inter-sample distance is 1e10."""

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


def nerf_volume_rendering(z_vals: torch.Tensor, density: torch.Tensor,
                          normalize: bool = False) -> torch.Tensor:
    """(R, S) cumprod-form weights ``alpha · Π(1 − alpha + 1e-10)`` (the
    product includes the sample's own term, as the JAX package's),
    optionally divided by (sum + 1e-5) per ray."""
    alpha = 1.0 - torch.exp(-(_dists(z_vals) * density))
    weights = alpha * torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
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
