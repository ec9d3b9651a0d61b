"""Camera pose utilities: averaging, recentering, spherical sampling (port
of ``vf_nerf_tpu/datasets/helpers/poses_utils.py``; reference
``datasets/helpers/poses_utils.py:77-113``). Host numpy.

Pose convention here: (N, 3, 4) or (N, 4, 4) camera-to-world with columns
[right, up, back | position] (the LLFF/NeRF convention used by these tools).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-12)


def view_matrix(forward: np.ndarray, up: np.ndarray,
                position: np.ndarray) -> np.ndarray:
    """(3, 4) camera-to-world from a look direction + up hint + position."""
    z = _normalize(forward)
    x = _normalize(np.cross(up, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, position], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera: averaged position, z, and y-hint of all poses."""
    center = poses[:, :3, 3].mean(axis=0)
    forward = _normalize(poses[:, :3, 2].sum(axis=0))
    up = poses[:, :3, 1].sum(axis=0)
    return view_matrix(forward, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly move all poses so their average pose is the identity."""
    avg = np.eye(4)
    avg[:3] = average_pose(poses)
    bottom = np.broadcast_to(np.array([0, 0, 0, 1.0]),
                             (len(poses), 1, 4))
    hom = np.concatenate([poses[:, :3], bottom], axis=1)
    out = np.linalg.inv(avg) @ hom
    return out[:, :3].astype(poses.dtype)


def sphere_poses(n_poses: int, radius: float,
                 center: np.ndarray = None,
                 min_elevation: float = 0.2,
                 max_elevation: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """Look-at-center poses on a sphere shell (reference
    ``poses_utils.py:77-113`` capability: novel-view pose sampling)."""
    center = np.zeros(3) if center is None else np.asarray(center)
    rng = np.random.RandomState(seed)
    poses = []
    for i in range(n_poses):
        azimuth = 2 * np.pi * i / n_poses
        elevation = rng.uniform(min_elevation, max_elevation)
        position = center + radius * np.array([
            np.cos(elevation) * np.cos(azimuth),
            np.cos(elevation) * np.sin(azimuth),
            np.sin(elevation)])
        forward = _normalize(position - center)  # camera backs away
        pose = np.eye(4, dtype=np.float32)
        pose[:3] = view_matrix(forward, np.array([0, 0, 1.0]), position)
        poses.append(pose)
    return np.stack(poses)


def spherify_poses(poses: np.ndarray
                   ) -> Tuple[np.ndarray, float]:
    """Transform poses so camera rays roughly intersect the origin and
    normalize the mean camera distance (LLFF 'spherify'). Returns the
    transformed (N, 3, 4) poses and the applied scale."""
    # Find the point minimizing distance to all camera optical axes.
    directions = poses[:, :3, 2]
    origins = poses[:, :3, 3]
    eye = np.eye(3)
    m = eye - directions[..., None] * directions[:, None, :]
    a = m.sum(axis=0)
    b = (m @ origins[..., None]).sum(axis=0)[:, 0]
    focus = np.linalg.solve(a, b)

    shifted = origins - focus
    scale = 1.0 / max(np.mean(np.linalg.norm(shifted, axis=1)), 1e-12)
    out = poses.copy().astype(np.float64)
    out[:, :3, 3] = shifted * scale
    return out[:, :3, :4].astype(np.float32), float(scale)
