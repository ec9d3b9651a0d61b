"""TSDF fusion of depth maps (port of ``vf_nerf_tpu/evaluation/mc/tsdf.py``),
on the host in numpy.

The reference used Open3D's ``ScalableTSDFVolume`` (voxel 4/512, truncation
0.04, depth truncation 10, ``methods.py:613-665``); this is the JAX
package's dense fusion with the same integration semantics:

- per view, every voxel centre projects into the camera; voxels in front of
  the camera, within the image, with valid depth ≤ depth_trunc integrate
  ``tsdf = min(1, (depth_px − z_voxel)/trunc)`` when ``sdf ≥ −trunc``,
  running-averaged with unit weights,
- the volume bounds come from the backprojected depth points (the scalable
  volume's effective extent),
- the mesh is the zero level set over observed voxels (weight > 0), by
  ``classic.marching_cubes``.

A voxel's value depends on its own projections only, so the volume is cut
into slabs of x-planes that fuse every view in worker threads; each voxel
sees the same arithmetic in the same view order as in the JAX package's
loop, so the volume and the mesh are equal bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from vf_nerf_torch.evaluation.mc.classic import map_in_threads, marching_cubes


def _backproject_bounds(depths: Sequence[np.ndarray],
                        poses: Sequence[np.ndarray],
                        intrinsics: Sequence[np.ndarray],
                        depth_trunc: float) -> Tuple[np.ndarray, np.ndarray]:
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for depth, pose, k in zip(depths, poses, intrinsics):
        h, w = depth.shape[:2]
        d = depth.reshape(h, w)
        valid = (d > 0) & (d <= depth_trunc)
        if not valid.any():
            continue
        ys, xs = np.nonzero(valid)
        z = d[ys, xs]
        x_cam = (xs - k[0, 2]) / k[0, 0] * z
        y_cam = (ys - k[1, 2]) / k[1, 1] * z
        pts = np.stack([x_cam, y_cam, z, np.ones_like(z)], axis=1)
        world = (pose @ pts.T).T[:, :3]
        mins = np.minimum(mins, world.min(axis=0))
        maxs = np.maximum(maxs, world.max(axis=0))
    return mins, maxs


def fuse_depth_maps(depths: Sequence[np.ndarray],
                    poses: Sequence[np.ndarray],
                    intrinsics: Sequence[np.ndarray],
                    voxel_size: float = 4.0 / 512.0,
                    sdf_trunc: float = 0.04,
                    depth_trunc: float = 10.0,
                    max_voxels: int = 450_000_000
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse depth maps → (vertices, faces) of the TSDF zero level set."""
    mins, maxs = _backproject_bounds(depths, poses, intrinsics, depth_trunc)
    if not np.isfinite(mins).all():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    mins -= 2 * sdf_trunc
    maxs += 2 * sdf_trunc

    dims = np.maximum(((maxs - mins) / voxel_size).astype(np.int64) + 2, 2)
    # Guard against absurd volumes (coarsen rather than OOM).
    while int(np.prod(dims)) > max_voxels:
        voxel_size *= 1.26
        dims = np.maximum(((maxs - mins) / voxel_size).astype(np.int64) + 2,
                          2)

    nx, ny, nz = (int(d) for d in dims)
    tsdf = np.zeros((nx, ny, nz), np.float32)
    weight = np.zeros((nx, ny, nz), np.float32)

    # Voxel centre world coordinates, built in multi-plane slabs of ~4M
    # voxels (bounded temporaries, amortized array overhead).
    planes_per_slab = max(1, (1 << 22) // max(ny * nz, 1))
    ys_idx, zs_idx = np.meshgrid(np.arange(ny, dtype=np.float32),
                                 np.arange(nz, dtype=np.float32),
                                 indexing="ij")
    wy_plane = (mins[1] + ys_idx * voxel_size).astype(np.float32)
    wz_plane = (mins[2] + zs_idx * voxel_size).astype(np.float32)
    views = []
    for depth, pose, k in zip(depths, poses, intrinsics):
        h, w = depth.shape[:2]
        world_to_cam = np.linalg.inv(pose).astype(np.float32)
        rot = world_to_cam[:3, :3]
        trans = world_to_cam[:3, 3]
        # cam = rot @ world + trans; the x-independent part per view.
        base = (rot[:, 1][:, None, None] * wy_plane[None] +
                rot[:, 2][:, None, None] * wz_plane[None] +
                trans[:, None, None])                      # (3, ny, nz)
        views.append((depth.reshape(h, w).astype(np.float32), rot, base,
                      (k[0, 0], k[1, 1], k[0, 2], k[1, 2])))

    def fuse_slab(ix0: int) -> None:
        ix1 = min(ix0 + planes_per_slab, nx)
        wx = (mins[0] + np.arange(ix0, ix1) *
              voxel_size).astype(np.float32)               # (P,)
        for d_img, rot, base, (fx, fy, cx, cy) in views:
            h, w = d_img.shape
            # (3, P, ny, nz)
            cam = base[:, None] + rot[:, 0][:, None, None, None] * \
                wx[None, :, None, None]
            z = cam[2]
            in_front = z > 1e-6
            inv_z = 1.0 / np.maximum(z, 1e-6)
            ui = np.round(cam[0] * inv_z * fx + cx).astype(np.int64)
            vi = np.round(cam[1] * inv_z * fy + cy).astype(np.int64)
            in_img = in_front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            d_px = d_img[np.clip(vi, 0, h - 1), np.clip(ui, 0, w - 1)]
            valid = in_img & (d_px > 0) & (d_px <= depth_trunc)
            sdf = d_px - z
            integrate = valid & (sdf >= -sdf_trunc)
            new_tsdf = np.minimum(1.0, sdf / sdf_trunc)
            w_old = weight[ix0:ix1]
            t_old = tsdf[ix0:ix1]
            w_new = w_old + integrate
            tsdf[ix0:ix1] = np.where(
                integrate, (t_old * w_old + new_tsdf) / np.maximum(w_new,
                                                                   1.0),
                t_old)
            weight[ix0:ix1] = w_new

    map_in_threads(fuse_slab, range(0, nx, planes_per_slab))
    return marching_cubes(tsdf, isovalue=0.0, origin=mins,
                          voxel_size=voxel_size, valid=weight > 0)
