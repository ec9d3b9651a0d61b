"""Cosine similarity → density via a scaled, truncated Laplace CDF (port of
``vf_nerf_tpu/ops/density.py``; reference
``models/helpers/density_functions.py:111-204``).

The three learned scalars are clamped before use: beta to ``beta_bounds``,
scale to ``max(|scale|, scale_min)``, mean to ``mean_bounds``.
``laplace_density(x) = relu(cdf(x) - cdf(cutoff))``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn


class DensityParams(NamedTuple):
    """The learned density scalars as 0-d tensors."""

    beta: torch.Tensor
    scale: torch.Tensor
    mean: torch.Tensor


class LaplaceDensity(nn.Module):
    """Holds the learned scalars as parameters; its state dict has the
    reference's ``density`` keys (``beta``, ``scale``, ``mean``)."""

    def __init__(self, params_init: Dict[str, float]) -> None:
        super().__init__()
        for name in ("beta", "scale", "mean"):
            setattr(self, name, nn.Parameter(
                torch.tensor(float(params_init[name]), dtype=torch.float32)))

    def params(self) -> DensityParams:
        return DensityParams(self.beta, self.scale, self.mean)


def get_beta(params: DensityParams,
             beta_bounds: Tuple[float, float]) -> torch.Tensor:
    return torch.clamp(params.beta, beta_bounds[0], beta_bounds[1])


def get_scale(params: DensityParams, scale_min: float) -> torch.Tensor:
    return torch.clamp(torch.abs(params.scale), min=scale_min)


def get_mean(params: DensityParams,
             mean_bounds: Tuple[float, float]) -> torch.Tensor:
    return torch.clamp(params.mean, mean_bounds[0], mean_bounds[1])


def laplace_cdf(x: torch.Tensor, beta: torch.Tensor, scale: torch.Tensor,
                mean: torch.Tensor) -> torch.Tensor:
    """``scale * LaplaceCDF((x - mean) / beta)``; reference ``:153-167``."""
    centered = x - mean
    cdf = 0.5 + 0.5 * torch.sign(centered) * (
        1.0 - torch.exp(-torch.abs(centered) / beta))
    return scale * cdf


def laplace_density(x: torch.Tensor, params: DensityParams,
                    beta_bounds: Tuple[float, float], scale_min: float,
                    mean_bounds: Tuple[float, float],
                    cutoff: float = -0.5) -> torch.Tensor:
    """Truncated scaled Laplace-CDF density; reference ``:129-151``."""
    beta = get_beta(params, beta_bounds)
    scale = get_scale(params, scale_min)
    mean = get_mean(params, mean_bounds)
    shifted = laplace_cdf(x, beta, scale, mean) - laplace_cdf(
        x.new_full((), cutoff), beta, scale, mean)
    return torch.clamp(shifted, min=0.0)
