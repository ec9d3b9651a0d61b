"""Fused ray march: window cosine → Laplace density → back-face suppression →
VolSDF weights → composite, in one launch of the CUDA kernel
``csrc/ray_march.cu`` (port of ``vf_nerf_tpu/ops/ray_march.py``), and its
backward, one launch of the reverse-scan kernel in the same file.

``ray_march_reference`` is the plain op chain the kernels fuse (the
renderer's ``get_density`` + ``ops/compositing``), and
``ray_march_backward_reference`` its gradient by autograd; the wrappers
take them for CPU tensors only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vf_nerf_torch.kernels import count_launch, load_library
from vf_nerf_torch.ops import compositing
from vf_nerf_torch.ops.density import (DensityParams, get_beta, get_mean,
                                       get_scale, laplace_cdf,
                                       laplace_density)
from vf_nerf_torch.ops.window import (cosine_similarity,
                                      window_cosine_similarity)

Outputs = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]


def sample_density(normals, ray_dirs, density_params: DensityParams,
                   window_weights, *, beta_bounds, scale_min, mean_bounds,
                   cutoff, dir_to_normal_th,
                   n_valid: Optional[int] = None) -> torch.Tensor:
    """(R, S) densities, the plain first half of the march (the JAX
    renderer's ``get_density``): the window cosine of neighbouring normals
    → Laplace density minus the CDF at the cutoff → the back-face cut; σ is
    zero from ``n_valid - 1`` on (a padded ray's live count) and on the last
    sample."""
    n_samples = normals.shape[1]
    dirs_rep = ray_dirs[:, None, :].expand(-1, n_samples, -1)
    cos = window_cosine_similarity(normals[:, :-1], normals[:, 1:],
                                   window_weights, n_valid=n_valid)
    cos_ray = cosine_similarity(normals[:, :-1], dirs_rep[:, :-1])
    sigma = laplace_density(-cos, density_params, beta_bounds, scale_min,
                            mean_bounds, cutoff=cutoff)
    sigma = torch.where((cos_ray < dir_to_normal_th) & (cos < 0.0),
                        torch.zeros_like(sigma), sigma)
    if n_valid is not None:
        live = torch.arange(sigma.shape[1], device=sigma.device) < n_valid - 1
        sigma = torch.where(live[None, :], sigma, torch.zeros_like(sigma))
    return torch.cat([sigma, sigma.new_zeros((sigma.shape[0], 1))], dim=-1)


def ray_march_reference(normals, ray_dirs, z_vals, rgb_samples,
                        density_params: DensityParams, window_weights, *,
                        beta_bounds, scale_min, mean_bounds, cutoff,
                        dir_to_normal_th, normalize,
                        white_background=False,
                        n_valid: Optional[int] = None) -> Outputs:
    """The plain chain: (rgb (R, 3), depth (R,), weights (R, S)); with
    ``rgb_samples`` None, the weights alone (rgb and depth are None).
    ``n_valid``: the live sample count (σ is zero from ``n_valid - 1`` on
    and the window ends as in an unpadded ray; ``sample_density``)."""
    sigma = sample_density(normals, ray_dirs, density_params, window_weights,
                           beta_bounds=beta_bounds, scale_min=scale_min,
                           mean_bounds=mean_bounds, cutoff=cutoff,
                           dir_to_normal_th=dir_to_normal_th, n_valid=n_valid)
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
    statement of the clamped density scalars the kernels compute in their
    prologue from the raw parameters (the tests hold it to the JAX
    wrapper's preparation). Differentiable: the training path passes its
    first three entries to the kernels and autograd carries the kernels'
    gradients through the clamps."""
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


class MarchStatics(NamedTuple):
    """The march's static arguments."""

    beta_bounds: Tuple[float, float]
    scale_min: float
    mean_bounds: Tuple[float, float]
    cutoff: float
    dir_to_normal_th: float
    normalize: bool
    white_background: bool
    n_valid: Optional[int]

    def bounds(self):
        return dict(beta_bounds=self.beta_bounds, scale_min=self.scale_min,
                    mean_bounds=self.mean_bounds, cutoff=self.cutoff,
                    dir_to_normal_th=self.dir_to_normal_th)

    def c_args(self):
        """Bounds, cutoff and threshold as the C entry points take them."""
        return (self.beta_bounds[0], self.beta_bounds[1], self.scale_min,
                self.mean_bounds[0], self.mean_bounds[1], self.cutoff,
                self.dir_to_normal_th)

    def reference_kwargs(self):
        return dict(self.bounds(), normalize=self.normalize,
                    white_background=self.white_background,
                    n_valid=self.n_valid)

    def live(self, n_samples: int) -> int:
        """The kernels' live count: ``n_samples`` masks nothing."""
        return n_samples if self.n_valid is None else self.n_valid


def _check_cuda(tensors, what: str) -> torch.device:
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous float32 tensors on "
                             f"one device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
    return device


def _scalar_ptrs(scalars):
    """Device pointers of beta, scale and mean: three 0-d tensors, or the
    three entries of one (3,) tensor."""
    if isinstance(scalars, torch.Tensor):
        base = scalars.data_ptr()
        return base, base + 4, base + 8
    return tuple(p.data_ptr() for p in scalars)


def _launch_forward(normals, ray_dirs, z_vals, rgb_samples, scalars, taps,
                    st: MarchStatics) -> Outputs:
    """One launch of the forward kernel. ``scalars``: beta, scale, mean on
    the card, raw or already clamped (the kernel clamps again, which
    changes nothing)."""
    lib = load_library()
    device = normals.device
    n_rays, n_samples = z_vals.shape
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
            *_scalar_ptrs(scalars), taps.data_ptr(), taps.shape[0],
            *st.c_args(), None if rgb is None else rgb.data_ptr(),
            None if depth is None else depth.data_ptr(), weights.data_ptr(),
            n_rays, n_samples, st.live(n_samples), int(st.normalize),
            int(st.white_background), stream)
    lib.check(code, "fused_ray_march launch")
    count_launch(fused_ray_march)
    return rgb, depth, weights


def ray_march_backward(normals, ray_dirs, z_vals, rgb_samples, scalars,
                       taps, st: MarchStatics, grad_rgb, grad_depth,
                       grad_weights):
    """One launch of the backward kernel on CUDA tensors.

    :param scalars: (3,) beta, scale, mean on the card (raw or clamped).
    :param grad_rgb, grad_depth: (R, 3), (R,) gradients of rgb and depth
        (None with ``rgb_samples`` None); ``grad_weights`` (R, S) or None.
    :return: (d normals (R, S, 3), d rgb samples (R, S, 3) or None,
        per-ray partials (R, 3) of the gradient to the CLAMPED beta, scale
        and mean, whose sum over the rays is that gradient).
    """
    lib = load_library()
    device = normals.device
    n_rays, n_samples = z_vals.shape
    d_normals = torch.empty_like(normals)
    d_rgb = None if rgb_samples is None else torch.empty_like(rgb_samples)
    partials = torch.empty((n_rays, 3), dtype=torch.float32, device=device)
    if n_rays == 0:
        return d_normals, d_rgb, partials
    tensors = [normals, ray_dirs, z_vals, taps] + \
        [t for t in (rgb_samples, grad_rgb, grad_depth, grad_weights)
         if t is not None]
    _check_cuda(tensors, "ray_march_backward")
    if rgb_samples is not None and (grad_rgb is None or grad_depth is None):
        raise ValueError("ray_march_backward needs the rgb and depth "
                         "gradients with rgb samples")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lib.vfn_ray_march_backward(
            normals.data_ptr(), ray_dirs.data_ptr(), z_vals.data_ptr(),
            None if rgb_samples is None else rgb_samples.data_ptr(),
            *_scalar_ptrs(scalars), taps.data_ptr(), taps.shape[0],
            *st.c_args(),
            None if grad_rgb is None else grad_rgb.data_ptr(),
            None if grad_depth is None else grad_depth.data_ptr(),
            None if grad_weights is None else grad_weights.data_ptr(),
            d_normals.data_ptr(), None if d_rgb is None else d_rgb.data_ptr(),
            partials.data_ptr(), n_rays, n_samples, st.live(n_samples),
            int(st.normalize), int(st.white_background), stream)
    lib.check(code, "ray_march_backward launch")
    count_launch(ray_march_backward)
    return d_normals, d_rgb, partials


ray_march_backward.launches = 0


def ray_march_backward_reference(normals, ray_dirs, z_vals, rgb_samples,
                                 scalars, taps, st: MarchStatics, grad_rgb,
                                 grad_depth, grad_weights):
    """The plain statement of ``ray_march_backward``: autograd through
    ``ray_march_reference`` at the clamped ``scalars`` (3,). Returns the
    scalars' gradient summed over the rays, (3,)."""
    with torch.enable_grad():
        n = normals.detach().requires_grad_(True)
        c = None if rgb_samples is None else \
            rgb_samples.detach().requires_grad_(True)
        s = scalars.detach().requires_grad_(True)
        params = DensityParams(s[0], s[1], s[2])
        rgb, depth, weights = ray_march_reference(
            n, ray_dirs, z_vals, c, params, taps, **st.reference_kwargs())
        outs, grads = [weights], [grad_weights]
        if c is not None:
            outs += [rgb, depth]
            grads += [grad_rgb, grad_depth]
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        inputs = [n, s] + ([] if c is None else [c])
        got = torch.autograd.grad([o for o, _ in pairs],
                                  inputs, [g for _, g in pairs],
                                  allow_unused=True)
    got = [torch.zeros_like(i) if g is None else g
           for i, g in zip(inputs, got)]
    return got[0], (None if c is None else got[2]), got[1]


class FusedRayMarch(torch.autograd.Function):
    """The march on CUDA tensors with a gradient: the forward kernel, then
    the backward kernel when a gradient is asked for. Inputs that take a
    gradient: ``normals``, ``rgb_samples`` and the clamped ``scalars`` (3,);
    z and the ray directions take none (the samplers stop it in JAX)."""

    @staticmethod
    def forward(ctx, normals, rgb_samples, scalars, ray_dirs, z_vals, taps,
                st):
        ctx.set_materialize_grads(False)
        ctx.st = st
        ctx.save_for_backward(normals, rgb_samples, scalars, ray_dirs,
                              z_vals, taps)
        return _launch_forward(normals, ray_dirs, z_vals, rgb_samples,
                               scalars, taps, st)

    @staticmethod
    def backward(ctx, grad_rgb, grad_depth, grad_weights):
        normals, rgb_samples, scalars, ray_dirs, z_vals, taps = \
            ctx.saved_tensors
        if rgb_samples is not None:
            n_rays = z_vals.shape[0]
            grad_rgb = normals.new_zeros((n_rays, 3)) if grad_rgb is None \
                else grad_rgb.contiguous()
            grad_depth = normals.new_zeros((n_rays,)) if grad_depth is None \
                else grad_depth.contiguous()
        if grad_weights is not None:
            grad_weights = grad_weights.contiguous()
        d_normals, d_rgb, partials = ray_march_backward(
            normals, ray_dirs, z_vals, rgb_samples, scalars, taps, ctx.st,
            grad_rgb, grad_depth, grad_weights)
        return d_normals, d_rgb, partials.sum(0), None, None, None, None


def fused_ray_march(normals: torch.Tensor, ray_dirs: torch.Tensor,
                    z_vals: torch.Tensor, rgb_samples: Optional[torch.Tensor],
                    density_params: DensityParams,
                    window_weights: torch.Tensor, *,
                    beta_bounds: Tuple[float, float], scale_min: float,
                    mean_bounds: Tuple[float, float], cutoff: float,
                    dir_to_normal_th: float, normalize: bool,
                    white_background: bool = False,
                    n_valid: Optional[int] = None) -> Outputs:
    """Fused window-cos → density → VolSDF weights → composite.

    :param normals: (R, S, 3) field samples; ``ray_dirs`` (R, 3) unit dirs;
        ``z_vals`` (R, S); ``rgb_samples`` (R, S, 3), or None for the weights
        alone (the coarse pass); ``density_params`` the raw learned scalars;
        ``window_weights`` (W,) raw taps (whatever ``get_density`` would
        use); ``n_valid`` the live sample count (1 .. S) of a padded ray,
        None for all.
    :return: (rgb (R, 3), depth (R,), weights (R, S)); rgb and depth are
        None when ``rgb_samples`` is.

    A CPU tensor takes the plain version (under autograd when a gradient is
    asked for); a CUDA tensor launches the kernel or raises. Without
    gradients a call is one launch: the clamps and the tap normalisation
    run inside it. When grad mode is on and the normals, the rgb samples or
    a density parameter take a gradient, the call goes through
    ``FusedRayMarch``: the clamps run as small PyTorch ops so that autograd
    can chain through them, the forward kernel runs, and the backward
    kernel runs in the backward pass. The kernels take S up to
    ``vfn_ray_march_max_samples()`` (1024) and up to 64 taps.
    """
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
    if n_valid is not None and not 1 <= n_valid <= n_samples:
        raise ValueError(f"n_valid must be in 1..{n_samples}; got {n_valid}")
    st = MarchStatics(tuple(beta_bounds), scale_min, tuple(mean_bounds),
                      cutoff, dir_to_normal_th, normalize, white_background,
                      None if n_valid is None else int(n_valid))
    if normals.device.type == "cpu":
        return ray_march_reference(normals, ray_dirs, z_vals, rgb_samples,
                                   density_params, window_weights,
                                   **st.reference_kwargs())
    if normals.device.type != "cuda":
        raise ValueError(f"fused_ray_march takes CPU or CUDA tensors, not "
                         f"{normals.device}")
    device = _check_cuda([normals, ray_dirs, z_vals] +
                         ([] if rgb_samples is None else [rgb_samples]),
                         "fused_ray_march")
    lib = load_library()
    max_s = lib.lib.vfn_ray_march_max_samples()
    max_taps = lib.lib.vfn_ray_march_max_taps()
    n_taps = window_weights.shape[0]
    if not 1 <= n_samples <= max_s or not 1 <= n_taps <= max_taps:
        raise ValueError(f"fused_ray_march takes 1..{max_s} samples and "
                         f"1..{max_taps} taps; got {n_samples} samples, "
                         f"{n_taps} taps")
    if any(p.numel() != 1 for p in density_params):
        raise ValueError("density parameters must be single values")
    # No-op when the taps already live on the card in f32.
    taps = window_weights.to(device, torch.float32).contiguous()
    grad = torch.is_grad_enabled() and (
        normals.requires_grad or
        (rgb_samples is not None and rgb_samples.requires_grad) or
        any(p.requires_grad for p in density_params))
    if not grad:
        params = [p.to(device, torch.float32) for p in density_params]
        return _launch_forward(normals, ray_dirs, z_vals, rgb_samples, params,
                               taps, st)
    scalars = march_scalars(density_params, device=device,
                            **st.bounds())[:3].contiguous()
    return FusedRayMarch.apply(normals, rgb_samples, scalars, ray_dirs,
                               z_vals, taps, st)


fused_ray_march.launches = 0
