"""2D image metrics (port of ``vf_nerf_tpu/utils/metrics.py``; reference
``utils/utils.py:235-325``): PSNR, SSIM with a uniform window (C1 = 1e-4,
C2 = 9e-4) and depth L1 in centimetres, on host numpy arrays; LPIPS (VGG16)
on the caller's device.

LPIPS reads its pretrained weights from an ``.npz`` in the JAX package's
layout (``conv0_w`` .. ``conv12_w`` OIHW, ``conv0_b`` .. ``conv12_b``,
``lin0`` .. ``lin4``; ``tools/export_lpips_weights.py`` writes one in an
online environment): the argument, else ``$VF_NERF_LPIPS_WEIGHTS``, else
``~/.cache/vf_nerf_tpu/lpips_vgg.npz``, so one file feeds both packages.
``lpips_available()`` gates on it. The repository holds no trained weights.
The VGG16 forward is ``F.conv2d`` (padding 1) and ``F.max_pool2d``, where
the JAX package runs ``lax.conv_general_dilated`` and ``reduce_window``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def get_psnr(prediction: np.ndarray, target: np.ndarray) -> float:
    """-10·log10(MSE) over [0, 1] images."""
    mse = float(np.mean((np.asarray(prediction, np.float32) -
                         np.asarray(target, np.float32)) ** 2))
    if mse == 0:
        return float("inf")
    return -10.0 * float(np.log10(mse))


def _uniform_filter2d(img: np.ndarray, window: int) -> np.ndarray:
    """Same-size uniform box filter per channel of an (H, W, C) array with
    zero padding, as torch ``conv2d(padding=window // 2)`` with a normalized
    all-ones kernel."""
    from scipy.ndimage import uniform_filter
    pad = window // 2
    out = np.empty_like(img, dtype=np.float64)
    for c in range(img.shape[2]):
        padded = np.pad(img[..., c], pad, mode="constant")
        filtered = uniform_filter(padded, size=window, mode="constant")
        out[..., c] = filtered[pad:-pad, pad:-pad] if pad else filtered
    return out


def get_ssim(prediction: np.ndarray, target: np.ndarray,
             window_size: int = 11, c1: float = 1e-4,
             c2: float = 9e-4) -> float:
    """SSIM with a uniform window over (H, W, C) images."""
    p = np.asarray(prediction, np.float64)
    t = np.asarray(target, np.float64)
    mu1 = _uniform_filter2d(p, window_size)
    mu2 = _uniform_filter2d(t, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _uniform_filter2d(p * p, window_size) - mu1_sq
    sigma2_sq = _uniform_filter2d(t * t, window_size) - mu2_sq
    sigma12 = _uniform_filter2d(p * t, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def get_l1_cm(prediction: np.ndarray, target: np.ndarray) -> float:
    """Depth L1 in centimetres; inputs in metres."""
    return float(np.mean(np.abs(np.asarray(prediction) -
                                np.asarray(target))) * 100.0)


# --- LPIPS (VGG16) --------------------------------------------------------
_LPIPS_ENV = "VF_NERF_LPIPS_WEIGHTS"
_LPIPS_DEFAULT = Path.home() / ".cache" / "vf_nerf_tpu" / "lpips_vgg.npz"
# VGG16's convolutions per block; a 2x2 max pool between blocks, a tap
# after each block's last ReLU.
_VGG_BLOCKS = (2, 2, 3, 3, 3)
# The LPIPS scaling layer (net input in [-1, 1]).
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips_weights_path(weights_path: Optional[str] = None) -> Path:
    return Path(weights_path or os.environ.get(_LPIPS_ENV) or _LPIPS_DEFAULT)


def lpips_available(weights_path: Optional[str] = None) -> bool:
    """True iff an LPIPS weights npz is present (the argument, else
    ``$VF_NERF_LPIPS_WEIGHTS``, else the default path)."""
    return lpips_weights_path(weights_path).is_file()


def _lpips_taps(x: torch.Tensor, weights) -> list:
    """The five channel-unit-normalized VGG16 taps of a (1, 3, H, W) input
    in [-1, 1]."""
    shift = x.new_tensor(_LPIPS_SHIFT).view(1, 3, 1, 1)
    scale = x.new_tensor(_LPIPS_SCALE).view(1, 3, 1, 1)
    h = (x - shift) / scale
    taps, conv = [], 0
    for block, n_convs in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            h = F.relu(F.conv2d(h, weights[f"conv{conv}_w"],
                                weights[f"conv{conv}_b"], padding=1))
            conv += 1
        norm = torch.sqrt(torch.sum(h * h, dim=1, keepdim=True))
        taps.append(h / (norm + 1e-10))
        if block < len(_VGG_BLOCKS) - 1:
            h = F.max_pool2d(h, 2, 2)
    return taps


def get_lpips(prediction, target, net: str = "vgg",
              weights_path: Optional[str] = None, device=None) -> float:
    """LPIPS of two (H, W, 3) images in [0, 1] (reference
    ``utils.py:291-310``): VGG16 taps, channel-unit normalized, squared
    differences weighted per channel by ``lin{i}``, the spatial mean, the
    sum over taps. Runs on ``device``, else on the device of ``prediction``
    when it is a tensor, else on the CPU."""
    if net != "vgg":
        raise ValueError("only the vgg variant is implemented (reference "
                         "default)")
    path = lpips_weights_path(weights_path)
    if not path.is_file():
        raise RuntimeError(
            f"LPIPS weights not found at {path}; export them with "
            "tools/export_lpips_weights.py in an online environment and "
            f"point ${_LPIPS_ENV} at the npz.")
    if device is None:
        device = prediction.device if isinstance(prediction, torch.Tensor) \
            else "cpu"
    with np.load(path) as npz:
        weights = {k: torch.from_numpy(np.asarray(npz[k], np.float32)).to(
            device) for k in npz.files}

    def chw(img):
        img = torch.as_tensor(img, dtype=torch.float32).to(device)
        return (img.permute(2, 0, 1)[None] - 0.5) / 0.5

    with torch.no_grad():
        total = torch.zeros((), device=device)
        for i, (fp, ft) in enumerate(zip(_lpips_taps(chw(prediction),
                                                     weights),
                                         _lpips_taps(chw(target), weights))):
            lin = weights[f"lin{i}"].view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((fp - ft) ** 2 * lin,
                                                 dim=1))
    return float(total)
