"""Mesh depth rendering and the "refuse" pass (port of
``vf_nerf_tpu/evaluation/renderer.py``).

Reference: ``evaluation/utils/renderer.py:11-71`` (pyrender's EGL offscreen
renderer) and ``evaluation/methods.py:33-72`` (``refuse``: re-render the mesh
into every training view, fuse a TSDF again and extract it, which culls the
geometry no camera observed). Depth rendering is the z-buffer rasterizer of
``csrc/rasterizer.cpp``, built on the host at first use
(``kernels/host.py``); a failed build raises. ``_render_depth_numpy`` is
its plain numpy version, kept as the tests' oracle.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from vf_nerf_torch.evaluation.mc.tsdf import fuse_depth_maps
from vf_nerf_torch.kernels.host import rasterizer


def render_depth(vertices: np.ndarray,
                 faces: np.ndarray,
                 pose: np.ndarray,
                 intrinsics: np.ndarray,
                 height: int,
                 width: int,
                 near_clip: float = 1e-4) -> np.ndarray:
    """Render a z-depth map of the mesh from a camera (0 = no hit)."""
    world_to_cam = np.linalg.inv(pose)
    v_h = np.concatenate([vertices,
                          np.ones((len(vertices), 1), vertices.dtype)],
                         axis=1)
    cam = (v_h @ world_to_cam.T)[:, :3].astype(np.float32)
    fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
    cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])

    lib = rasterizer()
    depth = np.zeros((height, width), np.float32)
    cam_c = np.ascontiguousarray(cam, np.float32)
    faces_c = np.ascontiguousarray(faces, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.rasterize_depth(ptr(cam_c), len(cam_c), ptr(faces_c), len(faces_c),
                        fx, fy, cx, cy, height, width, near_clip, ptr(depth))
    return depth


def _render_depth_numpy(cam: np.ndarray, faces: np.ndarray,
                        fx: float, fy: float, cx: float, cy: float,
                        height: int, width: int,
                        near_clip: float) -> np.ndarray:
    """The plain numpy rasterizer (the oracle of ``render_depth``; no
    path of the port calls it): per-triangle bbox barycentric fill."""
    depth = np.full((height, width), np.inf, np.float32)
    tri = cam[faces]                                  # (F, 3, 3)
    z = tri[..., 2]
    ok = (z > near_clip).all(axis=1)
    tri = tri[ok]
    z = z[ok]
    xs = tri[..., 0] / z * fx + cx                    # (F, 3)
    ys = tri[..., 1] / z * fy + cy
    inv_z = 1.0 / z
    for f in range(len(tri)):
        x0 = max(int(np.floor(xs[f].min())), 0)
        x1 = min(int(np.ceil(xs[f].max())), width - 1)
        y0 = max(int(np.floor(ys[f].min())), 0)
        y1 = min(int(np.ceil(ys[f].max())), height - 1)
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = xs[f, 0], ys[f, 0]
        bx, by = xs[f, 1], ys[f, 1]
        cx_, cy_ = xs[f, 2], ys[f, 2]
        d = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_)
        if abs(d) < 1e-12:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        w0 = ((by - cy_) * (gx - cx_) + (cx_ - bx) * (gy - cy_)) / d
        w1 = ((cy_ - ay) * (gx - cx_) + (ax - cx_) * (gy - cy_)) / d
        w2 = 1.0 - w0 - w1
        mask = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
        zi = 1.0 / (w0 * inv_z[f, 0] + w1 * inv_z[f, 1] + w2 * inv_z[f, 2])
        patch = depth[y0:y1 + 1, x0:x1 + 1]
        update = mask & (zi < patch)
        patch[update] = zi[update]
    depth[~np.isfinite(depth)] = 0.0
    return depth


def refuse_mesh(vertices: np.ndarray, faces: np.ndarray, dataset,
                voxel_size: float = 4.0 / 512.0,
                sdf_trunc: float = 0.04,
                depth_trunc: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """Cull unseen geometry: render the mesh into every training view and
    re-fuse a TSDF (reference ``refuse``, ``methods.py:33-72``; the x-flip
    ``fix_pose`` dance is a pyrender-convention artifact with no counterpart
    here — our rasterizer uses the dataset's own pinhole convention)."""
    h, w = dataset.image_size
    depths, poses, intrinsics = [], [], []
    for i in range(len(dataset)):
        pose = dataset.poses[i]
        depth = render_depth(vertices, faces, pose, dataset.intrinsics, h, w)
        depths.append(depth)
        poses.append(pose)
        intrinsics.append(dataset.intrinsics)
    return fuse_depth_maps(depths, poses, intrinsics, voxel_size=voxel_size,
                           sdf_trunc=sdf_trunc, depth_trunc=depth_trunc)
