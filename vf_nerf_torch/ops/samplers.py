"""Depth (z) samplers along rays (port of ``vf_nerf_tpu/ops/samplers.py``;
reference ``models/samplers/ray_sampler.py``).

- ``uniform_z_vals``: stratified near→far linspace, the coarse pass
  (``UniformSampler``, ``:95-142``);
- ``range_fine_z_vals``: N stratified depths in ``±fine_range`` around the
  coarse-weight argmax plus N uniform-random depths over [near, far]; rays
  whose argmax is sample 0 take the random extras (``RangeFineSampler``,
  ``:240-301``).

JAX's threefry streams cannot be reproduced in torch, so every uniform draw
is an argument: ``t`` (the stratify jitter) and ``u_extra`` (the random
extras, drawn even with perturb off). Callers draw them from a
``torch.Generator``; parity tests pass JAX's draws.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


def points_from_z(cam_loc: torch.Tensor, ray_dirs: torch.Tensor,
                  z_vals: torch.Tensor) -> torch.Tensor:
    """points = cam + z · dir; ``ray_dirs`` (R, 3) unnormalized, z (R, S)
    → (R, S, 3)."""
    return cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]


def _stratify(z_vals: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Jitter each sample inside its mid-point interval
    (reference ``ray_sampler.py:132-140``); ``t`` has z's shape."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i * (1 / (n - 1))`` with the
    end point set exactly."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(n, dtype=dtype, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=dtype)
    t[-1] = 1.0
    return t


def _column(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-ray bound as an (R or 1, 1) tensor on ``like``'s
    device; a Python number becomes a fill, not a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device, like.dtype).reshape(-1, 1)
    return like.new_full((1, 1), float(v))


def uniform_z_vals(n_rays: int, n_samples: int, near: Scalar, far: Scalar,
                   perturb: bool = True, t: Optional[torch.Tensor] = None,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Stratified uniform depths (R, n_samples); ``t`` (R, n_samples) is the
    jitter draw, required when ``perturb``."""
    lin = _linspace01(n_samples, dtype, device)[None, :]
    near, far = (_column(v, lin) for v in (near, far))
    z_vals = (near * (1.0 - lin) + far * lin).expand(n_rays, n_samples)
    if perturb:
        z_vals = _stratify(z_vals, t)
    return z_vals


def range_fine_extra_z(coarse_z_vals: torch.Tensor,
                       coarse_weights: torch.Tensor,
                       n_fine: int, fine_range: float, near: Scalar,
                       far: Scalar, perturb: bool,
                       t_fine: Optional[torch.Tensor],
                       u_extra: torch.Tensor) -> torch.Tensor:
    """The per-ray new depths (R, n_fine), unsorted: a stratified window
    around the coarse argmax where the argmax is > 0, else the random
    extras ``u_extra * (far - near) + near``."""
    dtype = coarse_z_vals.dtype
    max_idx = torch.argmax(coarse_weights, dim=-1)           # first maximum
    max_z = torch.gather(coarse_z_vals, 1, max_idx[:, None])
    step = 2.0 * fine_range / torch.tensor(float(n_fine - 1), dtype=dtype)
    offsets = step * torch.arange(n_fine, dtype=dtype,
                                  device=coarse_z_vals.device)
    z_window = max_z - fine_range + offsets[None, :]
    if perturb:
        z_window = _stratify(z_window, t_fine)
    z_random = u_extra * (far - near) + near
    return torch.where((max_idx > 0)[:, None], z_window, z_random)


def range_fine_z_vals(coarse_z_vals: torch.Tensor,
                      coarse_weights: torch.Tensor,
                      n_fine: int, fine_range: float, near: Scalar,
                      far: Scalar, perturb: bool,
                      t_fine: Optional[torch.Tensor],
                      u_extra: torch.Tensor) -> torch.Tensor:
    """(R, S_coarse + n_fine) sorted depths: the coarse ones plus the
    extras of ``range_fine_extra_z``, in one sort."""
    z_extra = range_fine_extra_z(coarse_z_vals, coarse_weights, n_fine,
                                 fine_range, near, far, perturb, t_fine,
                                 u_extra)
    return torch.sort(torch.cat([coarse_z_vals, z_extra], dim=-1),
                      dim=-1).values
