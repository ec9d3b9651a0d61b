"""3D Gaussian smoothing of vector-field grids (port of
``vf_nerf_tpu/evaluation/mc/smoothing.py``; reference
``evaluation/utils/guassian_smoothing.py:9-97``).

The reference applies a product Gaussian kernel as a depthwise conv3d with
replicate padding: k=3/σ=1 before the divergence, k=9/σ=2 before the corner
classification (``methods.py:213-221``). Its kernel is
``exp(-((x-μ)/(2σ))²)`` (variance 2σ², twice as wide as a standard
Gaussian); the quirk is kept. The product kernel is separable, so
``smooth_vf`` runs three 1-D passes on a tensor, axis 0, then 1, then 2,
each summing the taps in order as the JAX version does.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """The reference's per-axis kernel factor, self-normalized (a separable
    factorization of its normalized product kernel)."""
    x = np.arange(kernel_size, dtype=np.float32)
    mean = (kernel_size - 1) / 2.0
    k = np.exp(-(((x - mean) / (2.0 * sigma)) ** 2))
    return (k / k.sum()).astype(np.float32)


def _smooth_axis(grid: torch.Tensor, kernel: np.ndarray,
                 axis: int) -> torch.Tensor:
    """Replicate-padded 1-D correlation along ``axis`` of a (..., C) grid."""
    k = len(kernel)
    n = grid.shape[axis]
    # Replicate padding as a clamped gather of the planes.
    planes = torch.arange(-(k // 2), n + k // 2, device=grid.device)
    padded = grid.index_select(axis, planes.clamp(0, n - 1))
    out = torch.zeros_like(grid)
    for i in range(k):
        out = out + float(kernel[i]) * padded.narrow(axis, i, n)
    return out


def smooth_vf(vf: torch.Tensor, k: int = 3, sigma: float = 1.0
              ) -> torch.Tensor:
    """Smooth a (N, N, N, 3) vector-field grid (reference ``smooth_vf``) on
    its device."""
    kernel = gaussian_kernel_1d(k, sigma)
    out = vf
    for axis in range(3):
        out = _smooth_axis(out, kernel, axis)
    return out


def smooth_vf_np(vf: np.ndarray, k: int = 3, sigma: float = 1.0) -> np.ndarray:
    """Host numpy variant (scipy correlate1d with replicate padding, in
    float64)."""
    from scipy.ndimage import correlate1d
    kernel = gaussian_kernel_1d(k, sigma).astype(np.float64)
    out = vf.astype(np.float64)
    for axis in range(3):
        out = correlate1d(out, kernel, axis=axis, mode="nearest")
    return out.astype(np.float32)
