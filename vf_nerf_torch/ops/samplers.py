"""Depth (z) samplers along rays (port of ``vf_nerf_tpu/ops/samplers.py``;
reference ``models/samplers/ray_sampler.py``).

- ``uniform_z_vals``: stratified near→far linspace, the coarse pass
  (``UniformSampler``, ``:95-142``);
- ``range_fine_z_vals``: N stratified depths in ``±fine_range`` around the
  coarse-weight argmax plus N uniform-random depths over [near, far]; rays
  whose argmax is sample 0 take the random extras (``RangeFineSampler``,
  ``:240-301``). With ``n_active`` (static fine growth) the fine axis keeps
  its padded width N and only its first ``n_active`` columns are live: the
  window's spacing uses the live count, the last live column is stratified
  as if the array ended there, and the pad columns sit at
  ``far + 2·fine_range + 1``, beyond any live depth, so they sort to the
  ray's tail;
- ``sample_pdf`` / ``pdf_z_vals``: classic NeRF inverse-CDF fine depths
  (``FineSampler``, ``:163-237``), which no shipped conf uses.

JAX's threefry streams cannot be reproduced in torch, so every uniform draw
is an argument: ``t`` (the stratify jitter), ``u_extra`` (the random
extras, drawn even with perturb off) and ``sample_pdf``'s ``u``. Callers draw them from a
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


def _stratify(z_vals: torch.Tensor, t: torch.Tensor,
              n_active: Optional[int] = None) -> torch.Tensor:
    """Jitter each sample inside its mid-point interval
    (reference ``ray_sampler.py:132-140``); ``t`` has z's shape. With
    ``n_active``, column ``n_active - 1`` takes its own depth as its upper
    bound, as the last column of a width-``n_active`` array would."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if n_active is not None:
        upper = upper.clone()
        upper[..., n_active - 1] = z_vals[..., n_active - 1]
    return lower + (upper - lower) * t


def _linspace01(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i * (1 / (n - 1))`` with the
    end point set exactly, by a fill on the device: an indexed write of a
    host scalar (``t[-1] = 1.0``) is a blocking copy that drains the
    stream once a render."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(n, dtype=dtype, device=device) * torch.tensor(
        1.0 / (n - 1), dtype=dtype)
    t[-1:].fill_(1.0)
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
                       u_extra: torch.Tensor,
                       n_active: Optional[int] = None) -> torch.Tensor:
    """The per-ray new depths (R, n_fine), unsorted: a stratified window
    around the coarse argmax where the argmax is > 0, else the random
    extras ``u_extra * (far - near) + near``. ``n_active`` (1 ..
    ``n_fine``): only the first ``n_active`` columns are live, the rest
    are pad depths (see the module docstring)."""
    dtype = coarse_z_vals.dtype
    max_idx = torch.argmax(coarse_weights, dim=-1)           # first maximum
    max_z = torch.gather(coarse_z_vals, 1, max_idx[:, None])
    spaces = n_fine - 1 if n_active is None else max(n_active - 1, 1)
    step = 2.0 * fine_range / torch.tensor(float(spaces), dtype=dtype)
    offsets = step * torch.arange(n_fine, dtype=dtype,
                                  device=coarse_z_vals.device)
    z_window = max_z - fine_range + offsets[None, :]
    if perturb:
        z_window = _stratify(z_window, t_fine, n_active)
    z_random = u_extra * (far - near) + near
    z_extra = torch.where((max_idx > 0)[:, None], z_window, z_random)
    if n_active is not None:
        pad_z = _column(far, z_extra) + 2.0 * fine_range + 1.0
        live = torch.arange(n_fine, device=z_extra.device) < n_active
        z_extra = torch.where(live[None, :], z_extra, pad_z)
    return z_extra


def range_fine_z_vals(coarse_z_vals: torch.Tensor,
                      coarse_weights: torch.Tensor,
                      n_fine: int, fine_range: float, near: Scalar,
                      far: Scalar, perturb: bool,
                      t_fine: Optional[torch.Tensor],
                      u_extra: torch.Tensor,
                      n_active: Optional[int] = None) -> torch.Tensor:
    """(R, S_coarse + n_fine) sorted depths: the coarse ones plus the
    extras of ``range_fine_extra_z``, in one sort (with ``n_active`` the
    pad depths take the last ``n_fine - n_active`` places)."""
    z_extra = range_fine_extra_z(coarse_z_vals, coarse_weights, n_fine,
                                 fine_range, near, far, perturb, t_fine,
                                 u_extra, n_active)
    return torch.sort(torch.cat([coarse_z_vals, z_extra], dim=-1),
                      dim=-1).values


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               deterministic: bool = False,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` depths per ray from the
    piecewise-constant pdf of ``weights`` over ``bins`` (reference
    ``FineSampler.sample_pdf``, ``ray_sampler.py:163-214``): ``u`` (R,
    n_samples) uniforms, or ``linspace(0, 1)`` when ``deterministic``. No
    gradient flows out, as in the JAX package."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if deterministic:
        u = _linspace01(n_samples, cdf.dtype, cdf.device).expand(
            cdf.shape[:-1] + (n_samples,))
    elif u is None:
        raise ValueError("sample_pdf needs its uniforms u unless "
                         "deterministic")
    u = u.to(cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return (bins_b + t * (bins_a - bins_b)).detach()


def pdf_z_vals(coarse_z_vals: torch.Tensor, coarse_weights: torch.Tensor,
               n_samples: int, deterministic: bool = False,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classic NeRF fine depths (reference ``FineSampler.get_z_vals``,
    ``ray_sampler.py:216-237``): ``sample_pdf`` over the coarse mid-points
    with the inner coarse weights, merged with the coarse depths, sorted."""
    mids = 0.5 * (coarse_z_vals[..., 1:] + coarse_z_vals[..., :-1])
    z_new = sample_pdf(mids, coarse_weights[..., 1:-1], n_samples,
                       deterministic, u)
    return torch.sort(torch.cat([coarse_z_vals, z_new], dim=-1),
                      dim=-1).values
