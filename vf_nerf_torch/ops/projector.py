"""Multi-view reprojection, IBRNet's ``Projector`` (port of
``vf_nerf_tpu/ops/projector.py``; reference
``utils/pinhole_model.py:101-227``):
project 3D samples into source views, sample their colours and feature maps
bilinearly, and compute per-view ray-difference features. Not on any
training path of the reference; part of its public surface.

Camera rows are the reference's 34 floats: ``[height, width, K (16),
camera-to-world (16)]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def inbound(pixel_locations: torch.Tensor, h: float, w: float
            ) -> torch.Tensor:
    """Pixels inside the image."""
    x, y = pixel_locations[..., 0], pixel_locations[..., 1]
    return (x <= w - 1.0) & (x >= 0) & (y <= h - 1.0) & (y >= 0)


def normalize_pixels(pixel_locations: torch.Tensor, h: float, w: float
                     ) -> torch.Tensor:
    """Pixels → [-1, 1]."""
    resize = torch.tensor([w - 1.0, h - 1.0], dtype=pixel_locations.dtype,
                          device=pixel_locations.device)
    return 2.0 * pixel_locations / resize - 1.0


def bilinear_sample(image: torch.Tensor, pixel_locations: torch.Tensor
                    ) -> torch.Tensor:
    """(H, W, C) sampled at (..., 2) (x, y) pixels, clamped to the image
    (``grid_sample`` with aligned corners on pixel coordinates)."""
    h, w = image.shape[:2]
    x = torch.clamp(pixel_locations[..., 0], 0.0, w - 1.0)
    y = torch.clamp(pixel_locations[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (image[y0, x0] * (1 - fx) * (1 - fy) + image[y0, x1] * fx * (1 - fy)
            + image[y1, x0] * (1 - fx) * fy + image[y1, x1] * fx * fy)


def compute_projections(xyz: torch.Tensor, train_cameras: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (..., 3) into the (V, 34) views: (pixels (V, ..., 2), in front
    of the camera (V, ...))."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    intrinsics = train_cameras[:, 2:18].reshape(-1, 4, 4)
    poses = train_cameras[:, -16:].reshape(-1, 4, 4)
    xyz_h = torch.cat([flat, torch.ones_like(flat[:, :1])], dim=-1)
    proj = torch.einsum("vij,vjk,nk->vni", intrinsics,
                        torch.linalg.inv(poses), xyz_h)
    z = torch.clamp(proj[..., 2:3], min=1e-8)
    pixels = torch.clamp(proj[..., :2] / z, -1e6, 1e6)
    mask = proj[..., 2] > 0
    n_views = train_cameras.shape[0]
    return (pixels.reshape((n_views,) + shape + (2,)),
            mask.reshape((n_views,) + shape))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-6)


def compute_angle(xyz: torch.Tensor, query_camera: torch.Tensor,
                  train_cameras: torch.Tensor) -> torch.Tensor:
    """Per-view ray-difference features (V, ..., 4): the unit difference of
    the query-to-point and source-to-point directions, and their dot."""
    shape = xyz.shape[:-1]
    flat = xyz.reshape(-1, 3)
    train_pos = train_cameras[:, -16:].reshape(-1, 4, 4)[:, :3, 3]
    query_pos = query_camera[-16:].reshape(4, 4)[:3, 3]
    to_query = _unit(query_pos[None, None] - flat[None])
    to_train = _unit(train_pos[:, None] - flat[None])
    diff = to_query - to_train
    diff_norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    dot = torch.sum(to_query * to_train, dim=-1, keepdim=True)
    out = torch.cat([diff / torch.clamp(diff_norm, min=1e-6), dot], dim=-1)
    return out.reshape((train_cameras.shape[0],) + shape + (4,))


def project_and_sample(xyz: torch.Tensor, query_camera: torch.Tensor,
                       train_images: torch.Tensor, train_cameras: torch.Tensor,
                       feature_maps: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projector (reference ``Projector.compute``): for (R, S, 3)
    samples, views (V, H, W, 3) and feature maps (V, H, W, D), returns the
    sampled colours and features (R, S, V, 3 + D), the ray differences
    (R, S, V, 4) and the validity mask (R, S, V, 1)."""
    h, w = train_images.shape[1:3]
    pixels, in_front = compute_projections(xyz, train_cameras)
    n_views = train_cameras.shape[0]
    rgb = torch.stack([bilinear_sample(train_images[v], pixels[v])
                       for v in range(n_views)])
    feats = torch.stack([bilinear_sample(feature_maps[v], pixels[v])
                         for v in range(n_views)])
    rgb_feat = torch.cat([rgb, feats], dim=-1)
    ray_diff = compute_angle(xyz, query_camera, train_cameras)
    mask = (inbound(pixels, h, w) & in_front).to(xyz.dtype)
    return (torch.movedim(rgb_feat, 0, 2), torch.movedim(ray_diff, 0, 2),
            torch.movedim(mask, 0, 2)[..., None])
