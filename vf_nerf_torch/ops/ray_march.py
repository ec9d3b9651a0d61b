"""Fused ray march: window cosine → Laplace density → back-face suppression →
VolSDF weights → composite, in one launch of the CUDA kernel
``csrc/ray_march.cu`` (port of ``vf_nerf_tpu/ops/ray_march.py``).

``ray_march_reference`` is the plain op chain the kernel fuses (the
renderer's ``get_density`` + ``ops/compositing``); the wrapper takes it for
CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vf_nerf_torch.kernels import load_library
from vf_nerf_torch.ops import compositing
from vf_nerf_torch.ops.density import (DensityParams, get_beta, get_mean,
                                       get_scale, laplace_cdf,
                                       laplace_density)
from vf_nerf_torch.ops.window import (cosine_similarity,
                                      window_cosine_similarity)

Outputs = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]


def ray_march_reference(normals, ray_dirs, z_vals, rgb_samples,
                        density_params: DensityParams, window_weights, *,
                        beta_bounds, scale_min, mean_bounds, cutoff,
                        dir_to_normal_th, normalize,
                        white_background=False) -> Outputs:
    """The plain chain: (rgb (R, 3), depth (R,), weights (R, S)); with
    ``rgb_samples`` None, the weights alone (rgb and depth are None)."""
    n_samples = z_vals.shape[1]
    dirs_rep = ray_dirs[:, None, :].expand(-1, n_samples, -1)
    cos = window_cosine_similarity(normals[:, :-1], normals[:, 1:],
                                   window_weights)
    cos_ray = cosine_similarity(normals[:, :-1], dirs_rep[:, :-1])
    sigma = laplace_density(-cos, density_params, beta_bounds, scale_min,
                            mean_bounds, cutoff=cutoff)
    sigma = torch.where((cos_ray < dir_to_normal_th) & (cos < 0.0),
                        torch.zeros_like(sigma), sigma)
    sigma = torch.cat([sigma, sigma.new_zeros((sigma.shape[0], 1))], dim=-1)
    weights = compositing.volsdf_volume_rendering(z_vals, sigma, normalize)
    if rgb_samples is None:
        return None, None, weights
    rgb, depth = compositing.composite_rgb_depth(
        weights, rgb_samples, z_vals, white_background=white_background)
    return rgb, depth, weights


def march_scalars(density_params: DensityParams, *, beta_bounds, scale_min,
                  mean_bounds, cutoff, dir_to_normal_th,
                  device) -> torch.Tensor:
    """(5,) f32 tensor [beta, scale, mean, cdf(cutoff), th]: the plain
    statement of the clamped density scalars the kernel computes in its
    prologue from the raw parameters (the tests hold it to the JAX
    wrapper's preparation)."""
    f32 = torch.float32
    beta = get_beta(density_params, beta_bounds).to(device, f32)
    scale = get_scale(density_params, scale_min).to(device, f32)
    mean = get_mean(density_params, mean_bounds).to(device, f32)
    cdf_cut = laplace_cdf(beta.new_full((), cutoff), beta, scale, mean)
    return torch.stack([beta, scale, mean, cdf_cut,
                        beta.new_full((), dir_to_normal_th)])


def tap_coefficients(window_weights: torch.Tensor) -> torch.Tensor:
    """Normalized taps: centre signed, neighbours ``|w|``, all ÷ Σ|w| (the
    plain statement of the kernel's prologue)."""
    w = window_weights.to(torch.float32)
    coefs = torch.abs(w)
    middle = (w.shape[0] - 1) // 2
    coefs[middle] = w[middle]
    return (coefs / torch.sum(torch.abs(w))).contiguous()


def fused_ray_march(normals: torch.Tensor, ray_dirs: torch.Tensor,
                    z_vals: torch.Tensor, rgb_samples: Optional[torch.Tensor],
                    density_params: DensityParams,
                    window_weights: torch.Tensor, *,
                    beta_bounds: Tuple[float, float], scale_min: float,
                    mean_bounds: Tuple[float, float], cutoff: float,
                    dir_to_normal_th: float, normalize: bool,
                    white_background: bool = False) -> Outputs:
    """Fused window-cos → density → VolSDF weights → composite.

    :param normals: (R, S, 3) field samples; ``ray_dirs`` (R, 3) unit dirs;
        ``z_vals`` (R, S); ``rgb_samples`` (R, S, 3), or None for the weights
        alone (the coarse pass); ``density_params`` the raw learned scalars;
        ``window_weights`` (W,) raw taps (whatever ``get_density`` would
        use).
    :return: (rgb (R, 3), depth (R,), weights (R, S)); rgb and depth are
        None when ``rgb_samples`` is.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch: the clamps and the tap normalisation run inside it) or
    raises. The kernel takes S up to ``vfn_ray_march_max_samples()`` (1024)
    and up to 64 taps.
    """
    bounds = dict(beta_bounds=beta_bounds, scale_min=scale_min,
                  mean_bounds=mean_bounds, cutoff=cutoff,
                  dir_to_normal_th=dir_to_normal_th)
    n_rays, n_samples = z_vals.shape
    rgb_ok = rgb_samples is None or \
        rgb_samples.shape == (n_rays, n_samples, 3)
    if normals.shape != (n_rays, n_samples, 3) or not rgb_ok or \
            ray_dirs.shape != (n_rays, 3) or window_weights.ndim != 1:
        raise ValueError(
            f"shapes do not agree: normals {tuple(normals.shape)}, dirs "
            f"{tuple(ray_dirs.shape)}, z {tuple(z_vals.shape)}, rgb "
            f"{None if rgb_samples is None else tuple(rgb_samples.shape)}, "
            f"taps {tuple(window_weights.shape)}")
    if normals.device.type == "cpu":
        return ray_march_reference(normals, ray_dirs, z_vals, rgb_samples,
                                   density_params, window_weights,
                                   normalize=normalize,
                                   white_background=white_background,
                                   **bounds)
    if normals.device.type != "cuda":
        raise ValueError(f"fused_ray_march takes CPU or CUDA tensors, not "
                         f"{normals.device}")
    device = normals.device
    fields = [normals, ray_dirs, z_vals] + \
        ([] if rgb_samples is None else [rgb_samples])
    for t in fields:
        if t.device != device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("fused_ray_march needs contiguous float32 "
                             f"tensors on one device; got {t.dtype} "
                             f"{t.device} contiguous={t.is_contiguous()}")
    lib = load_library()
    max_s = lib.lib.vfn_ray_march_max_samples()
    max_taps = lib.lib.vfn_ray_march_max_taps()
    n_taps = window_weights.shape[0]
    if not 1 <= n_samples <= max_s or not 1 <= n_taps <= max_taps:
        raise ValueError(f"fused_ray_march takes 1..{max_s} samples and "
                         f"1..{max_taps} taps; got {n_samples} samples, "
                         f"{n_taps} taps")
    # No-ops when the parameters and taps already live on the card in f32.
    params = [p.to(device, torch.float32) for p in density_params]
    if any(p.numel() != 1 for p in params):
        raise ValueError("density parameters must be single values")
    taps = window_weights.to(device, torch.float32).contiguous()
    weights = torch.empty((n_rays, n_samples), dtype=torch.float32,
                          device=device)
    rgb = depth = None
    if rgb_samples is not None:
        rgb = torch.empty((n_rays, 3), dtype=torch.float32, device=device)
        depth = torch.empty((n_rays,), dtype=torch.float32, device=device)
    if n_rays == 0:
        return rgb, depth, weights
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lib.vfn_ray_march(
            normals.data_ptr(), ray_dirs.data_ptr(), z_vals.data_ptr(),
            None if rgb_samples is None else rgb_samples.data_ptr(),
            *(p.data_ptr() for p in params), taps.data_ptr(), n_taps,
            beta_bounds[0], beta_bounds[1], scale_min, mean_bounds[0],
            mean_bounds[1], cutoff, dir_to_normal_th,
            None if rgb is None else rgb.data_ptr(),
            None if depth is None else depth.data_ptr(), weights.data_ptr(),
            n_rays, n_samples, int(normalize), int(white_background), stream)
    lib.check(code, "fused_ray_march launch")
    fused_ray_march.launches += 1
    return rgb, depth, weights


fused_ray_march.launches = 0
