"""The render of a batch of rays with BatchNorm folded (port of
``render_rays`` in ``vf_nerf_tpu/models/renderer.py``; reference
``VectorFieldNerf.render``, ``models/nerf/vector_field_nerf.py:216-338``).

ray gen → stratified coarse depths → VF net (fused MLP) → fused ray march for
the coarse weights → argmax-range fine depths → VF net on all samples → colour
net (fused MLP) → fused ray march for the composite. On CUDA tensors the two
fused ops launch their kernels: 3 MLP launches and 2 march launches per call.

The same function is the eval render and the training step's forward. With
``grad=True`` the fine pass builds the autograd graph through the folded
weights to the Linear and BatchNorm parameters and the density scalars
(frozen BatchNorm, as the shipped conf trains: its directional-derivative
weight is 0); the coarse pass only steers the fine sampler and runs without
gradients, as the JAX package stops them. This port honours
``rendering.detach_normals`` on that path; the JAX package's folded path
does not (``ROADMAP.md`` §C), its unfolded path does.

Static fine growth: ``n_fine_active`` live fine samples out of the padded
``statics.n_fine``; the pad depths sort to the ray's tail, the march masks
them (``n_valid``), and ``sample_mask`` marks the live samples for the
loss.

Reference quirks kept: the density uses a uniform ``1/W`` window unless
``anneal_fine`` on the fine pass; back-facing samples are suppressed; the
last sample's σ is 0; the effective density cutoff is −0.5, not the conf's.

Not ported, raising ``NotImplementedError``: train-mode BatchNorm,
``rendering="nerf"``, ``reuse_coarse``, directional derivatives, bf16
compute, weight norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vf_nerf_torch.config.schema import VFNerfConfig
from vf_nerf_torch.models.networks import RenderingMLP, VectorFieldMLP
from vf_nerf_torch.ops import samplers
from vf_nerf_torch.ops.density import LaplaceDensity
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import Weights, fused_mlp
from vf_nerf_torch.ops.ray_march import fused_ray_march
from vf_nerf_torch.ops.rays import get_ray_directions_and_cam_location


@dataclasses.dataclass(frozen=True)
class RenderStatics:
    """The render's static configuration (the JAX package's fields that
    the folded eval render reads or refuses)."""

    n_coarse: int
    n_fine: int
    n_window: int
    perturb: bool
    rendering: str                 # "volsdf" ("nerf" is not ported)
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

    @staticmethod
    def from_config(cfg: VFNerfConfig, n_fine: int, train: bool,
                    white_background: bool = False) -> "RenderStatics":
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
            compute_dir_derivatives=False,
            white_background=white_background,
            train=train,
        )


class VFNerfModules(nn.Module):
    """The VF net, the colour net and the learned density scalars."""

    def __init__(self, cfg: VFNerfConfig,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.device_config.compute_dtype not in ("", "float32"):
            raise NotImplementedError(
                f"compute_dtype={cfg.device_config.compute_dtype!r} is not "
                "ported yet; the port computes in float32")
        self.cfg = cfg
        self.vf = VectorFieldMLP(cfg.vf_net_config, generator=generator)
        self.render = RenderingMLP(cfg.rendering_net_config,
                                   generator=generator)
        self.density = LaplaceDensity(cfg.density_config.params_init)

    def folded_weights(self, detach: bool = True
                       ) -> Tuple[Weights, Weights]:
        """Eval-mode BatchNorm folded into both nets' dense weights
        (``detach=False``: on the autograd graph)."""
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


def _check_statics(statics: RenderStatics) -> None:
    unported = {
        "train-mode BatchNorm (statics.train)": statics.train,
        f"rendering={statics.rendering!r}": statics.rendering != "volsdf",
        "reuse_coarse": statics.reuse_coarse,
        "directional derivatives": statics.compute_dir_derivatives,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported yet")


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
        when the caller has them already; else they are folded here.
    :return: dict with rgb (R, 3), depth (R, 1), normals (R, S, 3), points
        (R, S, 3), z_vals (R, S), weights (R, S), sample_colors (R, S, 3),
        ``argmax_coarse`` (R,), the coarse-weight argmax that chose each
        ray's fine branch, and with ``n_fine_active`` ``sample_mask`` (R, S),
        1.0 on live samples.
    """
    _check_statics(statics)
    if n_fine_active is not None:
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
    vf_w, rn_w = folded if folded is not None else \
        modules.folded_weights(detach=not torch.is_grad_enabled())
    directions, ray_dirs, cam_loc = get_ray_directions_and_cam_location(
        uv, pose, intrinsics)
    ray_dirs = ray_dirs.contiguous()
    window_weights = window_weights.to(device, torch.float32)
    n_taps = statics.n_window
    uniform = torch.full((n_taps,), 1.0 / n_taps, dtype=torch.float32,
                         device=device)
    fine_taps = window_weights if statics.anneal_mode == "anneal_fine" \
        else uniform
    march = dict(beta_bounds=statics.beta_bounds, scale_min=statics.scale_min,
                 mean_bounds=statics.mean_bounds, cutoff=statics.cutoff,
                 dir_to_normal_th=statics.dir_to_normal_th,
                 normalize=statics.normalize_rendering,
                 white_background=statics.white_background)

    # ---- coarse pass: steers the fine sampler only, no gradients ----------
    with torch.no_grad():
        z_coarse = samplers.uniform_z_vals(
            n_rays, statics.n_coarse, near, far, perturb=statics.perturb,
            t=t_coarse, device=device).contiguous()
        pts_coarse = samplers.points_from_z(cam_loc, directions, z_coarse)
        normals_coarse = modules.vf_apply_folded(
            vf_w, pts_coarse.reshape(-1, 3))[:, :3].reshape(
                n_rays, statics.n_coarse, 3).contiguous()
        _, _, weights_coarse = fused_ray_march(
            normals_coarse, ray_dirs, z_coarse, None, density_params,
            uniform, **march)
        argmax_coarse = torch.argmax(weights_coarse, dim=-1)

    # ---- fine pass ---------------------------------------------------------
    if statics.n_fine > 0:
        z_vals = samplers.range_fine_z_vals(
            z_coarse, weights_coarse, statics.n_fine,
            modules.cfg.ray_sampler_config.fine_range, near, far,
            statics.perturb, t_fine, u_extra, n_active=n_fine_active)
    else:
        z_vals = z_coarse
    z_vals = z_vals.contiguous()
    n_samples = z_vals.shape[1]
    points = samplers.points_from_z(cam_loc, directions, z_vals)
    points_flat = points.reshape(-1, 3)
    vf_out = modules.vf_apply_folded(vf_w, points_flat)
    feat_dim = modules.cfg.vf_net_config.feature_vector_dims
    normals_flat = vf_out[:, :3]
    dirs_flat = ray_dirs[:, None, :].expand(-1, n_samples, -1).reshape(-1, 3)
    rgb_samples = modules.render_apply_folded(
        rn_w, points_flat, normals_flat, dirs_flat,
        vf_out[:, 3:3 + feat_dim]).reshape(n_rays, n_samples, 3)
    normals = normals_flat.reshape(n_rays, n_samples, 3).contiguous()
    n_valid = None if n_fine_active is None \
        else statics.n_coarse + n_fine_active
    rgb, depth, weights = fused_ray_march(
        normals, ray_dirs, z_vals, rgb_samples, density_params, fine_taps,
        n_valid=n_valid, **march)
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
    return out
