"""Model facade ``VectorFieldNerf``: the eval render surface (port of
``vf_nerf_tpu/models/nerf.py``; reference
``models/nerf/vector_field_nerf.py:23-526``).

The facade owns the modules, one ``torch.Generator`` on its device seeded
from ``seed`` for the render's uniform draws, the fine-sample count, the
(annealed) window weights and near/far. Its weights are initialized on the
CPU from ``seed``, so a seed gives the same weights on every device.
Training, checkpoints and the mesh surfaces are later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vf_nerf_torch.config.schema import VFNerfConfig
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.ops.annealing import annealed_window_weights


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises if CUDA is asked for and missing: the
    port never drops to the CPU unless the caller passes ``"cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "vf_nerf_torch on the CPU")
    return device


class VectorFieldNerf:
    """The VF-NeRF model for rendering."""

    def __init__(self, config: VFNerfConfig, seed: int = 42,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.config = config
        init = torch.Generator().manual_seed(seed)
        self.modules = VFNerfModules(config, generator=init).to(
            self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fine_n_samples = config.ray_sampler_config.n_importance
        self.window_weights = np.asarray(config.cos_sim_weights, np.float32)
        self.near = config.ray_sampler_config.near
        self.far = config.ray_sampler_config.far

    def eval(self) -> None:
        """BatchNorm on running statistics (the only mode ported)."""
        self.modules.eval()

    def update_annealing(self, epoch: int) -> np.ndarray:
        """Epoch-gated window-weight annealing; returns the active taps."""
        self.window_weights = annealed_window_weights(
            np.asarray(self.config.cos_sim_weights, np.float32),
            self.config.cos_sim_weights_anneal,
            self.config.anneal_start, self.config.anneal_end, epoch)
        return self.window_weights

    def render_statics(self, white_background: bool = False,
                       n_fine: Optional[int] = None) -> RenderStatics:
        return RenderStatics.from_config(
            self.config,
            n_fine=self.fine_n_samples if n_fine is None else n_fine,
            train=self.modules.training,
            white_background=white_background)

    def _tensor(self, x) -> torch.Tensor:
        """f32 on the facade's device. Host data goes through pinned memory
        with an asynchronous copy: a copy from pageable memory would wait
        for the stream and stall the previous render's queue."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.to(torch.float32)
        t = torch.as_tensor(np.asarray(x, np.float32))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def render(self, pose, pixels, intrinsics, epoch: int,
               white: bool = False) -> Dict[str, torch.Tensor]:
        """Anneal, then render the rays of ``pixels`` (R, 2) with per-ray
        ``pose`` (R, 4, 4) or (R, 7) and ``intrinsics`` (R, 4, 4); returns
        the dict of ``render_rays``."""
        self.update_annealing(epoch)
        return render_rays(
            self.modules, self._tensor(pixels), self._tensor(pose),
            self._tensor(intrinsics), self.near, self.far,
            self._tensor(self.window_weights),
            self.render_statics(white_background=white),
            generator=self.generator)

    def render_image(self, pixels, pose, intrinsics, epoch: int,
                     white: bool = False, split_size: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render all of an image's rays in chunks of ``split_size``, with
        one (4, 4) ``pose`` and ``intrinsics`` for the image. Each chunk
        draws from the facade's generator exactly as one ``render`` call of
        that chunk would. Returns rgb (N, 3) and depth (N, 1) on the
        facade's device."""
        self.update_annealing(epoch)
        statics = self.render_statics(white_background=white)
        uv = self._tensor(pixels)
        pose44 = self._tensor(pose).reshape(4, 4)
        intr44 = self._tensor(intrinsics).reshape(4, 4)
        weights = self._tensor(self.window_weights)
        rgbs, depths = [], []
        for chunk in torch.split(uv, split_size):
            n = chunk.shape[0]
            out = render_rays(self.modules, chunk, pose44.expand(n, 4, 4),
                              intr44.expand(n, 4, 4), self.near, self.far,
                              weights, statics, generator=self.generator)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
        return torch.cat(rgbs), torch.cat(depths)
