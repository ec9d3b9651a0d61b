"""Geometry helpers (port of ``vf_nerf_tpu/utils/geometry.py``; reference
``utils/utils.py``): ray-sphere intersections (``:31-54``), the projection
onto a plane (``:188-214``) and the dominant directions of a mesh's normals
(``:216-233``), which the joint stage snaps its supervision targets to."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vf_nerf_torch.utils.ply import load_ply


def compute_sphere_intersections(cam_loc: torch.Tensor,
                                 ray_directions: torch.Tensor,
                                 radius: float = 1.0) -> torch.Tensor:
    """Near and far ray-sphere intersection depths (..., 2), clamped at 0.
    Raises on a ray that misses the sphere, as the reference checks."""
    ray_cam_dot = torch.sum(ray_directions * cam_loc, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 - (
        torch.sum(cam_loc ** 2, dim=-1, keepdim=True) - radius ** 2)
    if bool(torch.any(under_sqrt <= 0)):
        raise ValueError("BOUNDING SPHERE PROBLEM!")
    signs = torch.tensor([-1.0, 1.0], dtype=under_sqrt.dtype,
                         device=under_sqrt.device)
    roots = torch.sqrt(under_sqrt) * signs - ray_cam_dot
    return torch.clamp(roots, min=0.0)


def project_to_plane(points: torch.Tensor, vectors: torch.Tensor,
                     u_plane: torch.Tensor, v_plane: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (relative to the first) and vectors in the (u, v) plane
    basis: ((N, 2), (N, 2))."""
    u = u_plane / torch.linalg.vector_norm(u_plane)
    v = v_plane / torch.linalg.vector_norm(v_plane)
    rel = points - points[0]
    return (torch.stack([rel @ u, rel @ v], dim=1),
            torch.stack([vectors @ u, vectors @ v], dim=1))


def get_dominant_bases(num_bases: int, decimation: float,
                       path_to_mesh: str, seed: int = 0) -> np.ndarray:
    """The mesh's dominant directions (``num_bases``, 3): ``kmeans2`` (k-means++
    starts, ``seed``) of a random ``decimation`` share of its unit face
    normals (the reference decimates the mesh to that share and clusters
    with sklearn's KMeans)."""
    from scipy.cluster.vq import kmeans2

    verts, faces = load_ply(path_to_mesh)
    if len(faces) == 0:
        raise ValueError(f"mesh {path_to_mesh} has no faces")
    tri = verts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    ok = norms[:, 0] > 1e-12
    normals = normals[ok] / norms[ok]
    rng = np.random.RandomState(seed)
    keep = max(int(len(normals) * decimation), min(len(normals), num_bases))
    idx = rng.choice(len(normals), size=keep, replace=False)
    centers, _ = kmeans2(normals[idx].astype(np.float64), num_bases,
                         minit="++", seed=seed)
    return centers.astype(np.float32)
