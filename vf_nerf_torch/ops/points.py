"""Supervision points and targets of the vector field (port of
``vf_nerf_tpu/ops/points.py:68-121``; reference
``models/helpers/functions.py:75-157`` and ``models/samplers/sampler.py``).

- ``sample_border_points``: points in a shell around the centroid whose
  target field points inward;
- ``sample_center_points``: points in a ball around the centroid whose
  target points outward;
- ``border_mask_and_gt`` / ``center_mask_and_gt``: the ray samples near the
  border (near the centroid) as a (mask, target) pair over the whole
  (R, S) sample grid, so the loss is a masked mean with static shapes.

The draws come in as arguments: ``draw`` is an (n, 3) tensor of
``[phi, cos_theta, u]`` with phi uniform in [0, 2π), cos_theta in
[-1, 1) and u in [0, 1); ``shell_draw`` makes one from a
``torch.Generator``, and the parity tests pass JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vf_nerf_torch.ops.rays import normalize


def shell_draw(n_samples: int, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    """(n, 3) ``[phi, cos_theta, u]`` from three uniforms per point."""
    u = torch.rand((n_samples, 3), generator=generator, device=device)
    return torch.stack([u[:, 0] * (2.0 * math.pi), u[:, 1] * 2.0 - 1.0,
                        u[:, 2]], dim=1)


def sphere_shell_sample(draw: torch.Tensor, r_max, r_min=0.0
                        ) -> torch.Tensor:
    """Uniform points in the shell ``r_min <= r <= r_max`` (cube-root
    radial density; reference ``SphereSampler.sample``,
    ``sampler.py:160-193``)."""
    phi, cos_theta, u = draw.unbind(1)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
    r = torch.pow(u, 1.0 / 3.0) * (r_max - r_min) + r_min
    return torch.stack([r * sin_theta * torch.cos(phi),
                        r * sin_theta * torch.sin(phi),
                        r * cos_theta], dim=1)


def sample_border_points(draw: torch.Tensor, r_min, r_max,
                         centroid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shell points near the scene border; the target points inward
    (reference ``functions.py:99-116``)."""
    points = sphere_shell_sample(draw, r_max=r_max, r_min=r_min) + centroid
    return points, normalize(centroid - points, dim=1)


def sample_center_points(draw: torch.Tensor, centroid: torch.Tensor, radius
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball points around the centroid; the target points outward
    (reference ``functions.py:118-133``)."""
    points = sphere_shell_sample(draw, r_max=radius, r_min=0.0) + centroid
    return points, normalize(points - centroid, dim=1)


def border_mask_and_gt(points: torch.Tensor, far, radius,
                       centroid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray samples farther than ``far/2 - radius`` from the centroid
    supervise the field to point inward (reference
    ``get_border_indices_and_gt``, ``functions.py:75-97``).

    :param points: (R, S, 3) ray sample positions.
    :return: (mask (R, S) bool, gt (R, S, 3) inward unit vectors).
    """
    distances = torch.linalg.vector_norm(points - centroid, dim=2)
    mask = distances > (far / 2.0 - radius)
    return mask, normalize(centroid - points, dim=2)


def center_mask_and_gt(points: torch.Tensor, centroid: torch.Tensor, radius
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray samples within ``radius`` of the centroid supervise the field to
    point outward (reference ``get_center_indices_and_gt``,
    ``functions.py:136-157``)."""
    distances = torch.linalg.vector_norm(points - centroid, dim=2)
    mask = distances < radius
    return mask, normalize(points - centroid, dim=2)
