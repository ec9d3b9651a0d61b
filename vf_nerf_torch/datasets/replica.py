"""Replica loader (port of ``vf_nerf_tpu/datasets/replica.py:30-126``;
reference ``datasets/normal_datasets/replica_dataset.py:19-233``). Layout:

- ``<root>/<data_dir>/cam_params.json``: fx, fy, cx, cy and the depth PNG
  scale;
- ``<root>/<data_dir>/<scene>/results/frame*.jpg`` and ``depth*.png``, every
  ``factor``-th frame (default 20) unless ``random_img_sampling``;
- ``<root>/<data_dir>/<scene>/traj.txt``: one 4×4 camera-to-world per line;
- ``<root>/<data_dir>/<scene>_mesh.ply``: the GT mesh, for the centroid and
  the scale.

Bounds (0, 1.25 · max depth); VF init ``("exterior_<scene>",
<scene dir>/<scene>.pth)``. Colour frames are decoded by
``utils/jpeg.py`` (libjpeg's arithmetic, as the JAX package's ``imageio``),
depth PNGs read by ``utils/io.py``. ``sample_new_images`` draws its subset
from numpy's global generator, as the JAX loader does.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Tuple

import numpy as np

from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets.base import BaseDataset
from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils.meshes import mesh_bounds, mesh_centroid
from vf_nerf_torch.utils.ply import load_ply


class ReplicaDataset(BaseDataset):
    def __init__(self, config: DatasetConfig, train: bool = True) -> None:
        base_dir = os.path.join(config.data_root_dir, config.data_dir)
        with open(os.path.join(base_dir, "cam_params.json")) as f:
            camera = json.load(f)["camera"]
        self.data_dir = os.path.join(base_dir, str(config.scene))
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"Data directory {self.data_dir} "
                                    "does not exist.")

        self.png_depth_scale = float(camera["scale"])
        factor = config.factor if not config.random_img_sampling and train \
            else 1
        self.image_paths = np.asarray(sorted(
            glob.glob(f"{self.data_dir}/results/frame*.jpg"))[::factor])
        self.depth_paths = np.asarray(sorted(
            glob.glob(f"{self.data_dir}/results/depth*.png"))[::factor])

        super().__init__(n_images=len(self.image_paths),
                         shuffle_views=config.shuffle_views,
                         pixels_per_batch=config.pixels_per_batch,
                         all_pixels=config.all_pixels)
        self.config = config
        self.far_per_ray = config.far_per_ray

        first = io_utils.load_rgb(self.image_paths[0])
        self.image_size = first.shape[1:]  # (H, W)

        if not config.random_img_sampling:
            self.rgb_images, self.depth_images = self._load_images(
                self.image_paths, self.depth_paths)

        self._load_poses(factor)

        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1] = camera["fx"], camera["fy"]
        k[0, 2], k[1, 2] = camera["cx"], camera["cy"]
        self.intrinsics = k

        self.max_depth = 0.0
        for depth_path in self.depth_paths:
            d = io_utils.load_depth(depth_path) / self.png_depth_scale
            self.max_depth = max(self.max_depth, float(d.max()))

        verts, faces = load_ply(
            os.path.join(base_dir, f"{config.scene}_mesh.ply"))
        self.gt_mesh_centroid = mesh_centroid(verts, faces).astype(np.float32)
        self.scale = float(
            np.abs(mesh_bounds(verts) - self.gt_mesh_centroid).max() * 1.1)

    def _load_images(self, image_paths, depth_paths
                     ) -> Tuple[np.ndarray, np.ndarray]:
        rgbs, depths = [], []
        for img_path, depth_path in zip(image_paths, depth_paths):
            img = io_utils.load_rgb(img_path)          # (3, H, W) in [0, 1]
            depth = io_utils.load_depth(depth_path) / self.png_depth_scale
            rgbs.append(img.reshape(3, -1).T)
            depths.append(depth.reshape(-1, 1))
        return (np.asarray(rgbs, np.float32),
                np.asarray(depths, np.float32))

    def _load_poses(self, factor: int) -> None:
        with open(os.path.join(self.data_dir, "traj.txt")) as f:
            lines = f.readlines()
        poses = [np.asarray(list(map(float, lines[i].split())),
                            np.float32).reshape(4, 4)
                 for i in range(0, self.n_images * factor, factor)]
        self.all_poses = np.stack(poses)
        self.poses = self.all_poses.copy()

    def __len__(self) -> int:
        if self.config.random_img_sampling:
            return self.n_images // self.config.factor
        return self.n_images

    def sample_new_images(self) -> None:
        """A new random image subset each epoch (``random_img_sampling``,
        reference ``replica_dataset.py:105-119``)."""
        if not self.config.random_img_sampling:
            return
        idx = np.random.choice(self.n_images,
                               self.n_images // self.config.factor,
                               replace=False)
        self.rgb_images, self.depth_images = self._load_images(
            self.image_paths[idx], self.depth_paths[idx])
        self.poses = self.all_poses[idx].copy()

    def get_bounds(self) -> Tuple[float, float]:
        return 0.0, self.max_depth * 1.25

    def get_vf_init_method(self) -> Tuple[str, str]:
        return (f"exterior_{self.config.scene}",
                os.path.join(self.data_dir, f"{self.config.scene}.pth"))

    def get_centroid(self) -> np.ndarray:
        return self.gt_mesh_centroid
