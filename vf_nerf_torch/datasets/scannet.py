"""ScanNet loader (port of ``vf_nerf_tpu/datasets/scannet.py:28-129``;
reference ``datasets/normal_datasets/scannet_dataset.py:18-226``). Layout:

- ``<root>/<data_dir>/<scene>/color/*.jpg``, resized to the depth frames'
  size (``utils/io.py::resize_bilinear``, ``cv2.resize``'s bilinear);
- ``<root>/<data_dir>/<scene>/depth/*.png`` in mm, divided by 1000;
- ``crop_edge`` (default 10) trimmed from every side, the principal point
  shifted by it;
- ``pose/*.txt`` 4×4 camera-to-world, ``intrinsic/intrinsic_depth.txt``;
- ``<scene>_vh_clean.ply``, the GT mesh, for the centroid and the scale.

Every 40th frame is taken (``factor``, the reference's fixed subsample).
The image size is that of the first depth PNG.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets.base import BaseDataset
from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils.meshes import mesh_bounds, mesh_centroid
from vf_nerf_torch.utils.ply import load_ply
from vf_nerf_torch.utils.profiling import span


class ScanNetDataset(BaseDataset):
    def __init__(self, config: DatasetConfig, factor: int = 40,
                 train: bool = True) -> None:
        self.data_dir = os.path.join(config.data_root_dir, config.data_dir,
                                     str(config.scene))
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"Data directory {self.data_dir} "
                                    "does not exist.")
        factor = factor if train else 1

        self.image_paths = np.asarray(sorted(
            glob.glob(f"{self.data_dir}/color/*.jpg"))[::factor])
        self.depth_paths = np.asarray(sorted(
            glob.glob(f"{self.data_dir}/depth/*.png"))[::factor])

        super().__init__(n_images=len(self.image_paths),
                         shuffle_views=config.shuffle_views,
                         pixels_per_batch=config.pixels_per_batch,
                         all_pixels=config.all_pixels)
        self.config = config
        self.far_per_ray = config.far_per_ray

        h, w = io_utils.load_depth(self.depth_paths[0]).shape
        crop = config.crop_edge
        self.image_size = (h - 2 * crop, w - 2 * crop)

        self.rgb_images, self.depth_images = self._load_images(
            self.image_paths, self.depth_paths)

        self._load_poses(factor)

        with open(os.path.join(self.data_dir,
                               "intrinsic/intrinsic_depth.txt")) as f:
            vals = list(map(float, f.read().split()))
        k = np.asarray(vals, np.float32).reshape(4, 4)
        k[0, 2] -= crop
        k[1, 2] -= crop
        self.intrinsics = k

        self.max_depth = float(self.depth_images.max())

        verts, faces = load_ply(
            os.path.join(self.data_dir, f"{config.scene}_vh_clean.ply"))
        self.gt_mesh_centroid = mesh_centroid(verts, faces).astype(np.float32)
        self.scale = float(
            np.abs(mesh_bounds(verts) - self.gt_mesh_centroid).max() * 1.1)

    def _load_images(self, image_paths, depth_paths
                     ) -> Tuple[np.ndarray, np.ndarray]:
        crop = self.config.crop_edge
        rgbs, depths = [], []
        for img_path, depth_path in zip(image_paths, depth_paths):
            img = io_utils.read_image(img_path)[..., :3] / 255.0
            depth = io_utils.load_depth(depth_path) / 1e3
            img = io_utils.resize_bilinear(img, depth.shape[0],
                                           depth.shape[1])
            if crop > 0:
                img = img[crop:-crop, crop:-crop]
                depth = depth[crop:-crop, crop:-crop]
            rgbs.append(img.reshape(-1, 3))
            depths.append(depth.reshape(-1, 1))
        return (np.asarray(rgbs, np.float32),
                np.asarray(depths, np.float32))

    def _load_poses(self, factor: int) -> None:
        pose_paths = sorted(glob.glob(f"{self.data_dir}/pose/*.txt"))[::factor]
        poses = []
        for path in pose_paths:
            with open(path) as f:
                vals = list(map(float, f.read().split()))
            poses.append(np.asarray(vals, np.float32).reshape(4, 4))
        self.all_poses = np.stack(poses)
        self.poses = self.all_poses.copy()

    def __len__(self) -> int:
        if self.config.random_img_sampling:
            return self.n_images // self.config.factor
        return self.n_images

    def sample_new_images(self) -> None:
        if not self.config.random_img_sampling:
            return
        with span("train.sample_images"):
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
