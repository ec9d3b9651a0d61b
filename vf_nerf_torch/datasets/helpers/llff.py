"""LLFF-format data loading (port of
``vf_nerf_tpu/datasets/helpers/llff.py``; reference
``datasets/helpers/load_llf.py``, which no active dataset uses):

- ``poses_bounds.npy``: (N, 17) rows = 3×5 pose matrix ([R | t | hwf]
  columns) + 2 depth bounds,
- image loading with optional downsampling (PIL resize replaces the
  reference's ImageMagick ``mogrify``),
- recentering and spherification via ``poses_utils``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from vf_nerf_torch.datasets.helpers.poses_utils import (recenter_poses,
                                                        spherify_poses)
from vf_nerf_torch.utils.io import glob_imgs


def load_poses_bounds(basedir: str
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (poses (N, 3, 4), hwf (N, 3), bounds (N, 2))."""
    raw = np.load(os.path.join(basedir, "poses_bounds.npy"))
    mats = raw[:, :15].reshape(-1, 3, 5)
    poses = mats[:, :, :4]
    hwf = mats[:, :, 4]
    bounds = raw[:, 15:]
    return poses, hwf, bounds


def load_llff_data(basedir: str,
                   factor: Optional[int] = None,
                   recenter: bool = True,
                   spherify: bool = False,
                   bound_scale: float = 0.75
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Load an LLFF capture.

    :return: (images (N, H, W, 3) float [0,1], poses (N, 3, 5) with hwf in
        the 5th column, bounds (N, 2), scale applied).
    """
    poses, hwf, bounds = load_poses_bounds(basedir)

    img_dir = os.path.join(basedir, "images")
    paths = sorted(glob_imgs(img_dir))
    if len(paths) != len(poses):
        raise ValueError(f"{len(paths)} images vs {len(poses)} poses")

    from PIL import Image
    images = []
    for p in paths:
        img = Image.open(p)
        if factor and factor > 1:
            img = img.resize((img.width // factor, img.height // factor),
                             Image.LANCZOS)
        images.append(np.asarray(img, np.float32) / 255.0)
    images = np.stack(images)
    if factor and factor > 1:
        hwf = hwf.copy()
        hwf[:, :2] = hwf[:, :2] // factor
        hwf[:, 2] = hwf[:, 2] / factor

    # Normalize scene scale by the near bound (LLFF convention).
    scale = 1.0 / (bounds.min() * bound_scale)
    poses = poses.copy()
    poses[:, :3, 3] *= scale
    bounds = bounds * scale

    if spherify:
        poses, extra_scale = spherify_poses(poses)
        bounds = bounds * extra_scale
        scale *= extra_scale
    elif recenter:
        poses = recenter_poses(poses)

    poses_hwf = np.concatenate([poses, hwf[:, :, None]], axis=2)
    return images, poses_hwf.astype(np.float32), \
        bounds.astype(np.float32), scale
