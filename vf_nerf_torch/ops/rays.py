"""Camera model and ray generation (port of ``vf_nerf_tpu/ops/rays.py``;
reference ``utils/rendering.py:12-60`` and ``utils/pinhole_model.py:9-63``).

Poses are camera-to-world, (N, 4, 4) matrices or (N, 7)
``[qw, qx, qy, qz, tx, ty, tz]`` vectors. The camera-space depth of the pixel
plane is the sign of the FIRST ray's fy (``utils/rendering.py:42``).
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8  # torch F.normalize / F.cosine_similarity epsilon


def normalize(v: torch.Tensor, dim: int = -1,
              eps: float = _EPS) -> torch.Tensor:
    """Divide by ``max(||v||, eps)`` along ``dim``."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (N, 4) ``[w, x, y, z]`` → rotations (N, 3, 3)."""
    q = normalize(q, dim=1)
    w, x, y, z = q.unbind(1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (y * x - z * w), 2 * (x * z + w * y)],
        [2 * (y * x + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (z * x - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotations (N, 3, 3) → unit quaternions (N, 4) ``[w, x, y, z]``
    (port of ``vf_nerf_tpu/ops/rays.py``): Shepperd's method, the candidate
    built from the largest of the trace and the three diagonal
    combinations (the first on ties)."""
    m = rot
    t = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2

    s = root(1.0 + t)
    cand_w = torch.stack([0.25 * s, (m[:, 2, 1] - m[:, 1, 2]) / s,
                          (m[:, 0, 2] - m[:, 2, 0]) / s,
                          (m[:, 1, 0] - m[:, 0, 1]) / s], dim=1)
    s = root(1.0 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2])
    cand_x = torch.stack([(m[:, 2, 1] - m[:, 1, 2]) / s, 0.25 * s,
                          (m[:, 0, 1] + m[:, 1, 0]) / s,
                          (m[:, 0, 2] + m[:, 2, 0]) / s], dim=1)
    s = root(1.0 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2])
    cand_y = torch.stack([(m[:, 0, 2] - m[:, 2, 0]) / s,
                          (m[:, 0, 1] + m[:, 1, 0]) / s, 0.25 * s,
                          (m[:, 1, 2] + m[:, 2, 1]) / s], dim=1)
    s = root(1.0 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2])
    cand_z = torch.stack([(m[:, 1, 0] - m[:, 0, 1]) / s,
                          (m[:, 0, 2] + m[:, 2, 0]) / s,
                          (m[:, 1, 2] + m[:, 2, 1]) / s, 0.25 * s], dim=1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=1)
    scores = torch.stack([t, m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                          m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2],
                          m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]], dim=1)
    best = torch.argmax(scores, dim=1)       # the first maximum
    q = cands[torch.arange(rot.shape[0], device=rot.device), best]
    return normalize(q, dim=1)


def matrix_to_pose7(pose: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) camera-to-world → (N, 7) ``[qw, qx, qy, qz, tx, ty,
    tz]``."""
    return torch.cat([rot_to_quat(pose[:, :3, :3]), pose[:, :3, 3]], dim=1)


def pose7_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """(N, 7) quaternion + translation → (N, 4, 4) camera-to-world."""
    mat = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(
        pose.shape[0], 1, 1)
    mat[:, :3, :3] = quat_to_rot(pose[:, :4])
    mat[:, :3, 3] = pose[:, 4:]
    return mat


def pixel_to_camera(u: torch.Tensor, v: torch.Tensor, z: torch.Tensor,
                    intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixels → homogeneous camera coordinates with skew; z carries the
    depth sign while x/y use ``|z|``."""
    fx = intrinsics[:, 0, 0]
    fy = intrinsics[:, 1, 1]
    cx = intrinsics[:, 0, 2]
    cy = intrinsics[:, 1, 2]
    skew = intrinsics[:, 0, 1]
    abs_z = torch.abs(z)
    x = (u - cx + cy * skew / fy - skew * v / fy) / fx * abs_z
    y = (v - cy) / fy * abs_z
    return torch.stack([x, y, z, torch.ones_like(z)], dim=-1)


def get_ray_directions_and_cam_location(
        uv: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(directions (N, 3) unnormalized, ray_dirs (N, 3) unit, cam_loc (N, 3)).

    ``points_from_z`` marches along the unnormalized directions; the density
    uses the unit ones.
    """
    if pose.ndim == 2 and pose.shape[1] == 7:
        cam_loc = pose[:, 4:]
        mat = pose7_to_matrix(pose)
    else:
        cam_loc = pose[:, :3, 3]
        mat = pose
    z = torch.sign(intrinsics[0, 1, 1]) * torch.ones(
        uv.shape[0], dtype=uv.dtype, device=uv.device)
    pix_cam = pixel_to_camera(uv[:, 0], uv[:, 1], z, intrinsics)
    world = torch.einsum("nij,nj->ni", mat, pix_cam)[:, :3]
    directions = world - cam_loc
    return directions, normalize(directions), cam_loc
