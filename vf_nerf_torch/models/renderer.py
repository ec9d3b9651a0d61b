"""The render of a batch of rays (port of ``render_rays`` in
``vf_nerf_tpu/models/renderer.py``; reference ``VectorFieldNerf.render``,
``models/nerf/vector_field_nerf.py:216-338``).

ray gen → stratified coarse depths → VF net → coarse weights → argmax-range
fine depths → VF net on all samples → colour net → weights and composite.

Folded (``VFNerfModules.supports_folding``: BatchNorm on its running
statistics or absent, and no forward-mode Jacobian): the nets run as the
fused MLP over folded weights (BatchNorm, and weight norm's ``g·v/‖v‖``),
so a call on CUDA tensors launches 3 MLP kernels (6 more for a numerical
Jacobian). Unfolded (train-mode BatchNorm, or the analytic Jacobian): the
nets run as ``torch.matmul`` and a functional BatchNorm on each pass's own
batch statistics, as the JAX package runs them outside any kernel; the fine
VF and colour passes return the new running statistics
(``batch_stats_updates``), the coarse and Jacobian passes throw theirs
away. With ``rendering = "volsdf"`` the weights and the composite are the
fused ray march (2 launches, and its backward kernel for the gradient);
``"nerf"`` takes the plain density and ``nerf_volume_rendering``, as the
JAX package does (its march is volsdf-only).

The same function is the eval render and the training step's forward. With
``grad=True`` the fine pass builds the autograd graph to the nets'
parameters and the density scalars; the coarse pass only steers the fine
sampler and runs without gradients, as the JAX package stops them. This
port honours ``rendering.detach_normals`` on every path; the JAX
package's folded path does not (``ROADMAP.md`` §C), its unfolded path does.

``compute_dir_derivatives``: the field's Jacobian at the fine points,
analytic (``vf_jacobian``) or by central differences
(``numerical_jacobian``), and ``dir_derivative_norms``, the norms of its
products with two tangents of each normal.

Static fine growth: ``n_fine_active`` live fine samples out of the padded
``statics.n_fine``; the pad depths sort to the ray's tail, the weights
mask them (``n_valid``), and ``sample_mask`` marks the live samples for the
loss. Train-mode BatchNorm refuses it, as the JAX package does: the pad
points would enter the batch statistics.

Reference quirks kept: the density uses a uniform ``1/W`` window unless
``anneal_fine`` on the fine pass; back-facing samples are suppressed; the
last sample's σ is 0; the effective density cutoff is −0.5, not the conf's.

``reuse_coarse`` (eval; JAX ``renderer.py:400-460``): where the JAX
package folds (``VFNerfModules.jax_folds``: no train-mode BatchNorm, no
directional derivative of either kind, no weight norm, ``fast_eval``), the
coarse VF launch keeps all its outputs, the fine pass evaluates only the
extra depths of ``range_fine_extra_z``, and the two sets of rows are put
in the order of the stably sorted depths: 3 MLP launches (coarse VF over
R·n_coarse points, extra VF over R·n_fine, colour over R·(n_coarse +
n_fine)) and 2 marches. Elsewhere it is ignored, as the JAX package
ignores it; with static fine growth it raises, as the JAX package asserts.

``device_config.compute_dtype`` (``COMPUTE_DTYPES``) reaches the unfolded
nets only (``models/networks.py``), as in the JAX package, whose folded
path calls its MLP on float32 weights whatever the dtype: the folded
render and step run the same float32 kernels. Under a dtype other than
float32 the render folds on the JAX package's own condition, so weight
norm and the numerical Jacobian run unfolded, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from vf_nerf_torch.config.schema import VFNerfConfig
from vf_nerf_torch.models.networks import (RenderingMLP, Updates,
                                           VectorFieldMLP,
                                           directional_derivatives,
                                           numerical_vf_jacobian, vf_jacobian)
from vf_nerf_torch.ops import compositing, samplers
from vf_nerf_torch.ops.density import LaplaceDensity
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import Weights, fused_mlp
from vf_nerf_torch.ops.ray_march import fused_ray_march, sample_density
from vf_nerf_torch.ops.rays import get_ray_directions_and_cam_location
from vf_nerf_torch.utils.profiling import span


# ``device_config.compute_dtype`` names the port takes: those of the JAX
# package that torch has ("" and "float32" compute in float32).
COMPUTE_DTYPES = {"": None, "float32": None, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class RenderStatics:
    """The render's static configuration (the JAX package's fields that
    the port reads or refuses)."""

    n_coarse: int
    n_fine: int
    n_window: int
    perturb: bool
    rendering: str                 # "volsdf" or "nerf"
    normalize_rendering: bool
    dir_to_normal_th: float
    cutoff: float
    beta_bounds: Tuple[float, float]
    scale_min: float
    mean_bounds: Tuple[float, float]
    anneal_mode: str
    compute_dir_derivatives: bool
    white_background: bool
    train: bool
    reuse_coarse: bool = False
    numerical_jacobian: bool = False
    # Off: eval-mode BatchNorm runs unfolded as well (JAX ``fast_eval``).
    fast_eval: bool = True

    @staticmethod
    def from_config(cfg: VFNerfConfig, n_fine: int, train: bool,
                    white_background: bool = False,
                    compute_dir_derivatives: bool = False
                    ) -> "RenderStatics":
        rs = cfg.ray_sampler_config
        d = cfg.density_config
        # The reference never forwards the conf's cutoff to its density
        # function, so the effective truncation is the default -0.5, not
        # ``d.cutoff``.
        return RenderStatics(
            n_coarse=rs.n_samples,
            n_fine=min(n_fine, rs.max_samples) if n_fine > 0 else 0,
            n_window=len(cfg.cos_sim_weights),
            perturb=rs.perturb,
            rendering=cfg.rendering,
            normalize_rendering=cfg.normalize_rendering,
            dir_to_normal_th=cfg.dir_to_normal_th,
            cutoff=-0.5,
            beta_bounds=tuple(d.beta_bounds),
            scale_min=d.scale_min,
            mean_bounds=tuple(d.mean_bounds),
            anneal_mode=cfg.cos_sim_weights_anneal,
            compute_dir_derivatives=compute_dir_derivatives,
            white_background=white_background,
            train=train,
            numerical_jacobian=cfg.numerical_jacobian,
        )


class VFNerfModules(nn.Module):
    """The VF net, the colour net and the learned density scalars."""

    def __init__(self, cfg: VFNerfConfig,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        name = cfg.device_config.compute_dtype
        if name not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {name!r} is not one of "
                             f"{sorted(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.compute_dtype = COMPUTE_DTYPES[name]
        self.vf = VectorFieldMLP(cfg.vf_net_config, generator=generator,
                                 compute_dtype=self.compute_dtype)
        self.render = RenderingMLP(cfg.rendering_net_config,
                                   generator=generator,
                                   compute_dtype=self.compute_dtype)
        self.density = LaplaceDensity(cfg.density_config.params_init)

    def jax_folds(self, statics: RenderStatics) -> bool:
        """The JAX package's fold condition (``renderer.py:367-370``):
        ``fast_eval``, BatchNorm on its running statistics, no directional
        derivative, no weight norm."""
        weight_norm = self.cfg.vf_net_config.weight_norm or \
            self.cfg.rendering_net_config.weight_norm
        return statics.fast_eval and not statics.train and \
            not statics.compute_dir_derivatives and not weight_norm

    def supports_folding(self, statics: RenderStatics) -> bool:
        """Whether the render runs the fused MLP over folded weights. In
        float32: ``fast_eval``, BatchNorm on its running statistics (or
        absent) and no forward-mode Jacobian, a wider condition than the
        JAX package's: weight norm folds exactly here (the JAX package
        computes ``x @ (v·g/‖v‖) + b``), and so do the numerical
        Jacobian's passes. Under another compute dtype, ``jax_folds``."""
        if self.compute_dtype is not None:
            return self.jax_folds(statics)
        analytic = statics.compute_dir_derivatives and \
            not statics.numerical_jacobian
        return statics.fast_eval and not statics.train and not analytic

    def reuses_coarse(self, statics: RenderStatics) -> bool:
        """Whether the render reuses the coarse VF outputs: asked for, and
        where the JAX package folds."""
        return statics.reuse_coarse and self.jax_folds(statics)

    def folded_weights(self, detach: bool = True
                       ) -> Tuple[Weights, Weights]:
        """Eval-mode BatchNorm and weight norm folded into both nets'
        dense weights (``detach=False``: on the autograd graph)."""
        return (self.vf.folded_weights(detach),
                self.render.folded_weights(detach))

    def vf_apply_folded(self, vf_weights: Weights,
                        points: torch.Tensor) -> torch.Tensor:
        emb = positional_encoding(points,
                                  self.cfg.vf_net_config.embedder_multires)
        return fused_mlp(vf_weights, emb.contiguous(),
                         skip_at=self.vf.skip_at, final_act="tanh")

    def render_apply_folded(self, rn_weights: Weights, points, normals,
                            view_dirs, feats) -> torch.Tensor:
        x = self.render.inputs(points, normals, view_dirs, feats)
        return fused_mlp(rn_weights, x.contiguous(), skip_at=None,
                         final_act="sigmoid")

    def vf_apply(self, points: torch.Tensor, train: bool) -> torch.Tensor:
        """The unfolded VF net; in train mode on the batch's statistics,
        whose running update is thrown away (JAX ``vf_apply``; the nets'
        forward returns the update as well, JAX ``vf_apply_mutable``)."""
        return self.vf(points, train, keep_stats=False)[0]

    def render_apply(self, points, normals, view_dirs, feats,
                     train: bool) -> torch.Tensor:
        return self.render(points, normals, view_dirs, feats, train,
                           keep_stats=False)[0]

    @torch.no_grad()
    def apply_batch_stats(self, updates: Dict[str, Updates]) -> None:
        """Keep the running statistics of ``batch_stats_updates``."""
        for name, net in (("vf", self.vf), ("render", self.render)):
            if updates.get(name):
                net.apply_updates(updates[name])


def param_groups(modules: VFNerfModules) -> Dict[str, List[nn.Parameter]]:
    """The trainable tensors by the JAX params tree's top-level keys: the
    VF net (its Linear and BatchNorm parameters), the colour net, and the
    density scalars."""
    return {"vf": list(modules.vf.parameters()),
            "render": list(modules.render.parameters()),
            "density": list(modules.density.parameters())}


def draw_uniforms(statics: RenderStatics, n_rays: int,
                  generator: Optional[torch.Generator],
                  device) -> Dict[str, Optional[torch.Tensor]]:
    """The render's three uniform draws, in a fixed order: ``t_coarse``
    (R, n_coarse) and ``t_fine`` (R, n_fine) when perturb is on, then
    ``u_extra`` (R, n_fine) always (when there are fine samples)."""
    def rand(n):
        return torch.rand((n_rays, n), generator=generator, device=device)
    t_coarse = rand(statics.n_coarse) if statics.perturb else None
    has_fine = statics.n_fine > 0
    t_fine = rand(statics.n_fine) if statics.perturb and has_fine else None
    u_extra = rand(statics.n_fine) if has_fine else None
    return {"t_coarse": t_coarse, "t_fine": t_fine, "u_extra": u_extra}


def weights_and_composite(statics: RenderStatics, normals, ray_dirs,
                          z_vals, rgb_samples, density_params, taps,
                          n_valid: Optional[int] = None):
    """(rgb (R, 3), depth (R,), weights (R, S)) of ``normals`` (R, S, 3)
    along rays ``ray_dirs`` (R, 3) at depths ``z_vals``: for volsdf the
    fused ray march, for nerf the plain density and
    ``nerf_volume_rendering``. With ``rgb_samples`` None, the weights alone
    (rgb and depth are None)."""
    bounds = dict(beta_bounds=statics.beta_bounds,
                  scale_min=statics.scale_min,
                  mean_bounds=statics.mean_bounds, cutoff=statics.cutoff,
                  dir_to_normal_th=statics.dir_to_normal_th)
    if statics.rendering == "volsdf":
        return fused_ray_march(
            normals, ray_dirs, z_vals, rgb_samples, density_params, taps,
            normalize=statics.normalize_rendering,
            white_background=statics.white_background, n_valid=n_valid,
            **bounds)
    sigma = sample_density(normals, ray_dirs, density_params, taps,
                           n_valid=n_valid, **bounds)
    weights = compositing.nerf_volume_rendering(
        z_vals, sigma, statics.normalize_rendering)
    if rgb_samples is None:
        return None, None, weights
    rgb, depth = compositing.composite_rgb_depth(
        weights, rgb_samples, z_vals,
        white_background=statics.white_background)
    return rgb, depth, weights


def render_rays(modules: VFNerfModules,
                uv: torch.Tensor,
                pose: torch.Tensor,
                intrinsics: torch.Tensor,
                near, far,
                window_weights: torch.Tensor,
                statics: RenderStatics,
                generator: Optional[torch.Generator] = None,
                t_coarse: Optional[torch.Tensor] = None,
                t_fine: Optional[torch.Tensor] = None,
                u_extra: Optional[torch.Tensor] = None,
                n_fine_active: Optional[int] = None,
                grad: bool = False,
                folded: Optional[Tuple[Weights, Weights]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render a batch of rays on the device of ``uv``.

    :param uv: (R, 2) pixels; ``pose`` (R, 4, 4) or (R, 7); ``intrinsics``
        (R, 4, 4); ``near`` / ``far`` scalars; ``window_weights`` (W,).
    :param t_coarse, t_fine, u_extra: the uniform draws (see
        ``draw_uniforms``); when one that the statics need is None, all
        three are drawn from ``generator`` in ``draw_uniforms``' order and
        the missing ones taken from that draw.
    :param n_fine_active: static fine growth: the live fine count (1 ..
        ``statics.n_fine``, a Python int) of the padded fine axis.
    :param grad: build the autograd graph of the fine pass (training);
        off, the call runs under ``torch.no_grad()``.
    :param folded: the nets' folded weights (``modules.folded_weights``),
        when the caller has them already and the render folds; else they
        are folded here.
    :return: dict with rgb (R, 3), depth (R, 1), normals (R, S, 3), points
        (R, S, 3), z_vals (R, S), weights (R, S), sample_colors (R, S, 3),
        ``argmax_coarse`` (R,), the coarse-weight argmax that chose each
        ray's fine branch; with ``n_fine_active`` ``sample_mask`` (R, S),
        1.0 on live samples; in train-mode BatchNorm
        ``batch_stats_updates`` ({"vf": ..., "render": ...}, the fine
        passes' new running statistics); with ``compute_dir_derivatives``
        ``dir_derivative_norms`` (R·S·2,).
    """
    if n_fine_active is not None:
        if statics.train:
            raise NotImplementedError(
                "static fine growth with train-mode BatchNorm: the pad "
                "points would enter the batch statistics (the JAX package "
                "refuses it too)")
        if modules.reuses_coarse(statics):
            raise NotImplementedError(
                "static fine growth with reuse_coarse (the JAX package "
                "refuses it too): the reuse render takes a fixed fine count")
        n_fine_active = int(n_fine_active)
        if not 1 <= n_fine_active <= statics.n_fine:
            raise ValueError(f"n_fine_active must be in 1..{statics.n_fine} "
                             f"(the padded fine count); got {n_fine_active}")
    with torch.set_grad_enabled(grad):
        return _render(modules, uv, pose, intrinsics, near, far,
                       window_weights, statics, generator, t_coarse, t_fine,
                       u_extra, n_fine_active, folded)


def _render(modules, uv, pose, intrinsics, near, far, window_weights,
            statics, generator, t_coarse, t_fine, u_extra, n_fine_active,
            folded):
    device = uv.device
    n_rays = uv.shape[0]
    has_fine = statics.n_fine > 0
    missing = (statics.perturb and t_coarse is None) or \
        (statics.perturb and has_fine and t_fine is None) or \
        (has_fine and u_extra is None)
    if missing:
        if generator is None:
            raise ValueError("render_rays needs its uniform draws or a "
                             "torch.Generator to draw them from")
        drawn = draw_uniforms(statics, n_rays, generator, device)
        t_coarse = drawn["t_coarse"] if t_coarse is None else t_coarse
        t_fine = drawn["t_fine"] if t_fine is None else t_fine
        u_extra = drawn["u_extra"] if u_extra is None else u_extra

    density_params = modules.density.params()
    fold = modules.supports_folding(statics)
    if fold:
        if folded is None:
            with span("render.fold"):
                folded = modules.folded_weights(
                    detach=not torch.is_grad_enabled())
        vf_w, rn_w = folded
    directions, ray_dirs, cam_loc = get_ray_directions_and_cam_location(
        uv, pose, intrinsics)
    ray_dirs = ray_dirs.contiguous()
    window_weights = window_weights.to(device, torch.float32)
    n_taps = statics.n_window
    uniform = torch.full((n_taps,), 1.0 / n_taps, dtype=torch.float32,
                         device=device)
    fine_taps = window_weights if statics.anneal_mode == "anneal_fine" \
        else uniform

    def field(pts):
        """The VF net at ``pts`` (N, 3) → (N, 3 + F), updates thrown away."""
        if fold:
            return modules.vf_apply_folded(vf_w, pts)
        return modules.vf_apply(pts, statics.train)

    def weigh(normals, z, rgb, taps, n_valid=None):
        return weights_and_composite(statics, normals, ray_dirs, z, rgb,
                                     density_params, taps, n_valid)

    # ---- coarse pass: steers the fine sampler only, no gradients ----------
    # (reused, its VF outputs are the fine pass's too, on the graph).
    reuse = modules.reuses_coarse(statics)
    with span("render.coarse"):
        with torch.no_grad():
            z_coarse = samplers.uniform_z_vals(
                n_rays, statics.n_coarse, near, far, perturb=statics.perturb,
                t=t_coarse, device=device).contiguous()
            pts_coarse = samplers.points_from_z(cam_loc, directions,
                                                z_coarse)
        with torch.set_grad_enabled(reuse and torch.is_grad_enabled()):
            vf_coarse = field(pts_coarse.reshape(-1, 3))
        with torch.no_grad():
            normals_coarse = vf_coarse[:, :3].reshape(
                n_rays, statics.n_coarse, 3).contiguous()
            _, _, weights_coarse = weigh(normals_coarse, z_coarse, None,
                                         uniform)
            argmax_coarse = torch.argmax(weights_coarse, dim=-1)

    # ---- fine pass ---------------------------------------------------------
    fine_range = modules.cfg.ray_sampler_config.fine_range
    updates: Dict[str, Updates] = {}
    with span("render.sample"):
        if reuse:
            z_vals, vf_out = _reuse_coarse(
                statics, vf_coarse, z_coarse, weights_coarse, fine_range,
                near, far, t_fine, u_extra, cam_loc, directions, field)
        elif statics.n_fine > 0:
            z_vals = samplers.range_fine_z_vals(
                z_coarse, weights_coarse, statics.n_fine, fine_range, near,
                far, statics.perturb, t_fine, u_extra,
                n_active=n_fine_active)
        else:
            z_vals = z_coarse
        z_vals = z_vals.contiguous()
        n_samples = z_vals.shape[1]
        points = samplers.points_from_z(cam_loc, directions, z_vals)
    points_flat = points.reshape(-1, 3)
    feat_dim = modules.cfg.vf_net_config.feature_vector_dims
    with span("render.fine"):
        dirs_flat = ray_dirs[:, None, :].expand(
            -1, n_samples, -1).reshape(-1, 3)
        # Train-mode BatchNorm keeps the fine passes' running statistics.
        if not fold:
            vf_out, updates["vf"] = modules.vf(points_flat, statics.train)
        elif not reuse:
            vf_out = modules.vf_apply_folded(vf_w, points_flat)
        normals_flat = vf_out[:, :3]
        feats_flat = vf_out[:, 3:3 + feat_dim]
        if fold:
            rgb_flat = modules.render_apply_folded(
                rn_w, points_flat, normals_flat, dirs_flat, feats_flat)
        else:
            rgb_flat, updates["render"] = modules.render(
                points_flat, normals_flat, dirs_flat, feats_flat,
                statics.train)
    rgb_samples = rgb_flat.reshape(n_rays, n_samples, 3)
    normals = normals_flat.reshape(n_rays, n_samples, 3).contiguous()
    n_valid = None if n_fine_active is None \
        else statics.n_coarse + n_fine_active
    with span("render.march"):
        rgb, depth, weights = weigh(normals, z_vals, rgb_samples, fine_taps,
                                    n_valid=n_valid)
    out = {
        "rgb": rgb,
        "depth": depth[:, None],
        "normals": normals,
        "points": points,
        "z_vals": z_vals,
        "weights": weights,
        "sample_colors": rgb_samples,
        "argmax_coarse": argmax_coarse,
    }
    if n_valid is not None:
        live = torch.arange(n_samples, device=device) < n_valid
        out["sample_mask"] = live[None, :].to(torch.float32).expand(
            n_rays, n_samples)
    if any(updates.values()):
        out["batch_stats_updates"] = updates
    if statics.compute_dir_derivatives:
        jacobian = numerical_vf_jacobian if statics.numerical_jacobian \
            else vf_jacobian
        dd = directional_derivatives(normals_flat,
                                     jacobian(field, points_flat))
        out["dir_derivative_norms"] = torch.linalg.vector_norm(
            dd.reshape(-1, 3), dim=-1)
    return out


def _reuse_coarse(statics, vf_coarse, z_coarse, weights_coarse, fine_range,
                  near, far, t_fine, u_extra, cam_loc, directions, field):
    """The reuse render's fine pass: (z_vals (R, S), the VF outputs (R·S,
    C) in the order of ``z_vals``). Only the extra depths go through
    ``field``; each ray's coarse and extra depths are sorted stably (a tie
    keeps the coarse sample first, as ``jnp.argsort`` does), and each VF
    row is copied once, to its sorted place."""
    n_rays, n_coarse = z_coarse.shape
    if statics.n_fine == 0:
        return z_coarse, vf_coarse
    z_extra = samplers.range_fine_extra_z(
        z_coarse, weights_coarse, statics.n_fine, fine_range, near, far,
        statics.perturb, t_fine, u_extra)
    pts_extra = samplers.points_from_z(cam_loc, directions, z_extra)
    vf_extra = field(pts_extra.reshape(-1, 3))
    z_vals, order = torch.sort(torch.cat([z_coarse, z_extra], dim=-1),
                               dim=-1, stable=True)
    n_samples = z_vals.shape[1]
    # Each unsorted sample's row among the sorted ones.
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n_samples, device=order.device).expand(
            n_rays, n_samples))
    rank += torch.arange(n_rays, device=order.device)[:, None] * n_samples
    vf_out = vf_coarse.new_empty(n_rays * n_samples, vf_coarse.shape[1])
    vf_out.index_copy_(0, rank[:, :n_coarse].reshape(-1), vf_coarse)
    vf_out.index_copy_(0, rank[:, n_coarse:].reshape(-1), vf_extra)
    return z_vals, vf_out
