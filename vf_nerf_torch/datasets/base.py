"""Base dataset: ray batches assembled on the host in numpy (port of
``vf_nerf_tpu/datasets/base.py``; reference
``datasets/normal_datasets/base_dataset.py:6-127``).

- ``pixels_per_batch`` is divided by ``n_images`` in shuffle-views mode, so
  one item is a mixed-view batch of ``n_images * (pixels_per_batch //
  n_images)`` rays;
- ``all_pixels`` switches items to whole-image ray grids (eval);
- ``white_bkgd`` is hard-set False (reference ``:37``);
- hooks: ``get_bounds`` / ``get_vf_init_method`` / ``sample_new_images`` /
  ``get_centroid``.

Images are stacked numpy arrays ``(n_images, n_pixels, C)``; a batch is one
vectorised gather, and an epoch is an iterator of numpy dicts that the
runner packs and copies to the device. Every random draw comes from the
``np.random.RandomState`` the caller passes, in the JAX package's order, so
a seed gives both packages the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from vf_nerf_torch.datasets.output import DatasetOutput


def pixel_grid(height: int, width: int) -> np.ndarray:
    """(H*W, 2) float32 (x, y) pixel coordinates in row-major order."""
    ys, xs = np.mgrid[0:height, 0:width]
    return np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)


def _sample_pixels(rng, n_pixels: int, k: int) -> np.ndarray:
    """``k`` distinct pixel indices, uniform without replacement: the
    distribution of the reference's ``randperm(n)[:k]``, drawn in O(k)."""
    if k >= n_pixels:
        return rng.permutation(n_pixels)[:k]
    gen = np.random.Generator(np.random.PCG64(rng.randint(0, 2**31 - 1)))
    return gen.choice(n_pixels, k, replace=False)


class BaseDataset:
    """In-memory ray dataset. Subclasses fill ``rgb_images`` (n, P, 3),
    ``depth_images`` (n, P, 1), ``poses`` (n, 4, 4), ``intrinsics`` (4, 4)
    and ``image_size`` (H, W)."""

    def __init__(self, n_images: int, shuffle_views: bool,
                 pixels_per_batch: int, all_pixels: bool = False) -> None:
        self.n_images = n_images
        self._shuffle_views = shuffle_views
        self._pixels_per_batch = pixels_per_batch
        if shuffle_views:
            self._pixels_per_batch = pixels_per_batch // max(n_images, 1)
        self.total_pixels = self.n_images * self._pixels_per_batch
        self.all_pixels = all_pixels
        self.white_bkgd = False
        self.scale = 3.5

        self.rgb_images: np.ndarray = np.zeros((0, 0, 3), np.float32)
        self.depth_images: np.ndarray = np.zeros((0, 0, 1), np.float32)
        self.poses: np.ndarray = np.zeros((0, 4, 4), np.float32)
        self.intrinsics: np.ndarray = np.eye(4, dtype=np.float32)
        self.image_size: Tuple[int, int] = (0, 0)
        self.far_per_ray: bool = False
        self._uv_cache: Tuple[Tuple[int, int], np.ndarray] = ((0, 0),
                                                              np.zeros(0))

    def _uv_grid(self) -> np.ndarray:
        """``pixel_grid(*image_size)``, built once per image size."""
        if self._uv_cache[0] != self.image_size:
            self._uv_cache = (self.image_size, pixel_grid(*self.image_size))
        return self._uv_cache[1]

    def __len__(self) -> int:
        return self.n_images

    @property
    def n_pixels(self) -> int:
        return self.image_size[0] * self.image_size[1]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.all_pixels:
            return self._whole_image_item(idx)
        if self._shuffle_views:
            return self._mixed_view_item(np.random)
        return self._single_view_item(idx, np.random)

    def _far(self, depth: np.ndarray) -> np.ndarray:
        return depth * 1.25 if self.far_per_ray else np.zeros((0,),
                                                              np.float32)

    def _whole_image_item(self, idx: int) -> Dict[str, np.ndarray]:
        n = self.n_pixels
        depth = self.depth_images[idx]
        return DatasetOutput(
            rgb=self.rgb_images[idx], uv=self._uv_grid(),
            intrinsics=np.broadcast_to(self.intrinsics, (n, 4, 4)).copy(),
            pose=np.broadcast_to(self.poses[idx], (n, 4, 4)).copy(),
            depth=depth, far=self._far(depth)).to_dict()

    def _mixed_view_item(self, rng) -> Dict[str, np.ndarray]:
        """``pixels_per_batch`` random pixels from every image, concatenated,
        as one gather; ``view_idx`` is each ray's source view."""
        n_img = len(self.rgb_images)
        ppb = self._pixels_per_batch
        idx = np.stack([_sample_pixels(rng, self.n_pixels, ppb)
                        for _ in range(n_img)])
        img_idx = np.repeat(np.arange(n_img), ppb)
        pix_idx = idx.reshape(-1)
        depth = self.depth_images[img_idx, pix_idx]
        out = DatasetOutput(
            rgb=self.rgb_images[img_idx, pix_idx],
            uv=self._uv_grid()[pix_idx],
            intrinsics=np.broadcast_to(self.intrinsics,
                                       (len(pix_idx), 4, 4)).copy(),
            pose=self.poses[img_idx],
            depth=depth, far=self._far(depth)).to_dict()
        out["view_idx"] = img_idx.astype(np.int32)
        return out

    def _single_view_item(self, idx: int, rng) -> Dict[str, np.ndarray]:
        ppb = self._pixels_per_batch
        pix_idx = _sample_pixels(rng, self.n_pixels, ppb)
        depth = self.depth_images[idx][pix_idx]
        return DatasetOutput(
            rgb=self.rgb_images[idx][pix_idx], uv=self._uv_grid()[pix_idx],
            intrinsics=np.broadcast_to(self.intrinsics, (ppb, 4, 4)).copy(),
            pose=np.broadcast_to(self.poses[idx], (ppb, 4, 4)).copy(),
            depth=depth, far=self._far(depth)).to_dict()

    def epoch_batches(self, rng: np.random.RandomState
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch: ``len(self)`` items in shuffled order (reference
        ``DataLoader(batch_size=1, shuffle=True)``)."""
        for idx in rng.permutation(len(self)):
            if self.all_pixels:
                yield self._whole_image_item(int(idx))
            elif self._shuffle_views:
                yield self._mixed_view_item(rng)
            else:
                yield self._single_view_item(int(idx), rng)

    def get_bounds(self) -> Tuple[float, float]:
        raise NotImplementedError

    def get_vf_init_method(self) -> Tuple[str, str]:
        """(supervision init method, VF-init weights path); by default the
        point-to-centre init with no file."""
        return "center", ""

    def sample_new_images(self) -> None:
        """Per-epoch image resampling hook (``random_img_sampling``)."""

    def get_centroid(self) -> np.ndarray:
        return np.zeros(3, np.float32)
