"""2D image metrics (port of ``vf_nerf_tpu/utils/metrics.py:23-60,
145-148``; reference ``utils/utils.py:235-325``): PSNR, SSIM with a uniform
window (C1 = 1e-4, C2 = 9e-4) and depth L1 in centimetres, on host numpy
arrays. LPIPS needs pretrained VGG weights and is not ported yet."""

from __future__ import annotations

import numpy as np


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
