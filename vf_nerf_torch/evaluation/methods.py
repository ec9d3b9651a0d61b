"""Evaluation methods: image rendering and 2D metrics (port of
``vf_nerf_tpu/evaluation/methods.py:31-122``; reference
``evaluation/methods.py:473-610``). The artifact layout is the JAX
package's:

- ``<eval>/rendered_images/image-{i}.png``, ``depth-{i}.npy`` and
  ``depth-{i}.png`` (an 8-bit grey map, ``utils/io.py``);
- ``<eval>/metrics.json``: per-image PSNR and ``mean_psnr``.

Each view renders as a whole image through ``VectorFieldNerf.render_image``
(chunks of ``split_size`` rays, 3 fused-MLP and 2 ray-march launches per
chunk on the card). An image's host read and PNG encoding happen after the
next image is enqueued, so they overlap its rendering.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils import metrics as metric_utils


def render_images(model: VectorFieldNerf,
                  eval_path: str,
                  dataset_config: DatasetConfig,
                  epoch: int,
                  split_size: int = 1024) -> None:
    """Render every view of the dataset and save rgb and depth."""
    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    dataset.all_pixels = True
    model.near, model.far = dataset.get_bounds()
    path = os.path.join(eval_path, "rendered_images")
    io_utils.mkdir_ifnotexists(path)
    h, w = dataset.image_size

    def finish(i, batch, rgb, depth):
        rgb_img = np.zeros((h, w, 3), np.float32)
        depth_img = np.zeros((h, w, 1), np.float32)
        xs = batch["uv"][:, 0].astype(np.int64)
        ys = batch["uv"][:, 1].astype(np.int64)
        rgb_img[ys, xs] = rgb.cpu().numpy()
        depth_img[ys, xs] = depth.cpu().numpy()
        io_utils.save_rgb(os.path.join(path, f"image-{i}.png"), rgb_img)
        io_utils.save_depth(os.path.join(path, f"depth-{i}"),
                            depth_img[..., 0])

    prev = None
    for i in range(len(dataset)):
        batch = dataset[i]
        rgb, depth = model.render_image(
            batch["uv"], batch["pose"][0], batch["intrinsics"][0], epoch,
            dataset.white_bkgd, split_size)
        if prev is not None:
            finish(*prev)
        prev = (i, batch, rgb, depth)
    if prev is not None:
        finish(*prev)


def metrics(model: VectorFieldNerf,
            eval_path: str,
            dataset_config: DatasetConfig,
            epoch: int,
            split_size: int = 1024) -> Dict[str, float]:
    """Per-image and mean PSNR → ``metrics.json``; renders the images first
    if any is missing."""
    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    dataset.all_pixels = True
    images_path = os.path.join(eval_path, "rendered_images")
    num_images = len(dataset)
    needed = [os.path.join(images_path, f"{kind}-{i}.{ext}")
              for kind, ext in (("image", "png"), ("depth", "npy"))
              for i in range(num_images)]
    if not all(os.path.exists(p) for p in needed):
        print("Not all images and depth maps exist. Rendering.")
        render_images(model, eval_path, dataset_config, epoch, split_size)

    h, w = dataset.image_size
    psnrs = np.zeros(num_images)
    payload: Dict = {}
    for i in range(num_images):
        target = dataset.rgb_images[i].reshape(h, w, 3)
        predicted = io_utils.load_rgb(
            os.path.join(images_path, f"image-{i}.png"), transpose=False)
        psnrs[i] = metric_utils.get_psnr(predicted, target)
        payload[f"image-{i}"] = {"psnr": float(psnrs[i])}
    payload["mean_psnr"] = float(psnrs.mean())
    io_utils.write_json(os.path.join(eval_path, "metrics.json"), payload)
    return payload
