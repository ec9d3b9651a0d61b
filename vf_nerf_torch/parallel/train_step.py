"""The training step (port of ``vf_nerf_tpu/parallel/train_step.py:40-330``;
reference trainer ``train/vector_field_nerf_train.py:161-260``).

One step: render a ray batch with gradients → the border and centre
supervision of the field (two more VF net evaluations on sampled points) →
``vf_loss`` → gradients → clip, Adam and the per-step learning rate
(``models/nerf.py``) → with train-mode BatchNorm, the fine passes' running
statistics kept after the optimizer (``{**stats, **updates}``, as the JAX
step).

Launches per step on CUDA tensors, volsdf: with BatchNorm frozen (the
shipped conf) or weight norm the nets fold, and the fused MLP runs 5
times (coarse VF without gradients, fine VF, colour net, shell VF, ball
VF), 11 with the numerical directional-derivative Jacobian (its six ±ε VF
passes); with train-mode BatchNorm (the analytic Jacobian) the nets run
unfolded and the fused MLP not at all. The ray march runs twice (coarse
weights, fine composite) and its backward once; ``rendering = "nerf"``
takes plain weights and no march. The shell and ball passes run as the
fine pass does (train-mode BatchNorm on their own batch, updates thrown
away). Before ``directional_derivatives_start`` the Jacobian is skipped:
its term is zero there, as the JAX step's ``where`` makes it.

Random draws: JAX's threefry streams cannot be reproduced, so every draw
is a tensor the caller may pass in (``draws``); otherwise ``draw_step``
draws them from a ``torch.Generator`` in a fixed order: the render's
``t_coarse``, ``t_fine``, ``u_extra`` (``draw_uniforms``), then the shell
points ``border`` and the ball points ``center``, (n_points, 3) each, both
always (``ops/points.py`` says what a row holds).

Data parallel (``parallel/mesh.py``): each rank passes its slice of the
global ray batch. The draws are the global step's: ``draw_step`` draws the
global tensors from the shared-seed generator in the order above, and each
rank takes its rays' rows of the render's draws and its contiguous share
of the shell and ball rows (``shard_draws``); static fine growth's shell
mask compares the global row index with the global live count. After the
backward every gradient is summed over the ranks in one flat all-reduce,
then the clip and Adam run alike on every rank. The metric sums stay this
rank's shares (the runner sums them over the ranks once per epoch).

``train_remat`` (``device_config``; JAX ``_remat_wrap``) recomputes the
loss closure's forward in the backward instead of keeping its saved
tensors: ``"full"`` under ``torch.utils.checkpoint`` (non-reentrant),
``"dots"`` under a selective-checkpoint policy that keeps the products'
outputs (``mm``, ``addmm``) and recomputes everything else, the fused
MLP's launch included, as JAX's ``dots_with_no_batch_dims_saveable`` keeps
``dot_general``'s outputs and recomputes its ``pallas_call``. The draws are
made before the closure, so a recompute sees the same ones; the gradients
are the same computation run twice. Any other mode raises ``ValueError``.

The JAX package's scan and span steps dispatch K of these steps at once on
the TPU; on the card a step is a sequence of launches, and the runner loops
them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from vf_nerf_torch.config.schema import (VFLossConfig, VFLossWeights,
                                         VFNerfConfig)
from vf_nerf_torch.models.loss import vf_loss
from vf_nerf_torch.models.nerf import Optimizer, param_groups
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           draw_uniforms, render_rays)
from vf_nerf_torch.ops import points as points_ops
from vf_nerf_torch.parallel.mesh import all_reduce_flat, shard_rows, world
from vf_nerf_torch.utils.profiling import span

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SupervisionStatics:
    """The supervision's static configuration (trainer ``:180-216``).
    ``n_points``: shell points per draw, the reference's
    ``(rays * samples) // 10`` at the padded sample count."""

    init_method: str          # "center" or "exterior*"
    border_supervision: bool
    center_supervision: bool
    border_radius: float
    n_points: int

    @staticmethod
    def from_config(cfg: VFNerfConfig, init_method: str, n_rays: int,
                    n_samples: int, border_radius: float
                    ) -> "SupervisionStatics":
        return SupervisionStatics(
            init_method=init_method,
            border_supervision=cfg.border_supervision,
            center_supervision=cfg.center_supervision,
            border_radius=border_radius,
            n_points=max((n_rays * n_samples) // 10, 1))


def draw_step(statics: RenderStatics, sup: SupervisionStatics, n_rays: int,
              generator: Optional[torch.Generator],
              device) -> Dict[str, Optional[torch.Tensor]]:
    """A step's draws for ``n_rays`` (global) rays, in the order of the
    module docstring."""
    draws = draw_uniforms(statics, n_rays, generator, device)
    draws["border"] = points_ops.shell_draw(sup.n_points, generator, device)
    draws["center"] = points_ops.shell_draw(sup.n_points, generator, device)
    return draws


SHELL_KEYS = ("border", "center")


def shard_draws(draws: Dict[str, Optional[torch.Tensor]], rays: slice,
                n_points: int) -> Dict[str, Optional[torch.Tensor]]:
    """This rank's rows of a global step's draws: ``rays`` of the render's,
    and its ``shard_rows`` of the ``n_points`` shell and ball rows. The
    identity at one rank."""
    rank, size = world()
    if size == 1:
        return draws
    shell = shard_rows(n_points, rank, size)
    return {k: None if v is None else v[shell if k in SHELL_KEYS else rays]
            for k, v in draws.items()}


def _supervision_terms(field: Callable[[torch.Tensor], torch.Tensor],
                       out: Tensors, draws: Dict[str, torch.Tensor], far,
                       centroid, sup: SupervisionStatics,
                       n_points_active: Optional[int] = None):
    """(prediction, target, mask or None) triples of the field's
    supervision (trainer ``:180-216``); ``field`` maps points (N, 3) to
    the VF net's outputs. With static fine growth the ray samples' masks
    are ANDed with ``sample_mask`` and the shell draw is masked down to its
    first ``n_points_active`` rows, the reference's count at the live
    sample count; without it the draw is the whole count, unmasked. Data
    parallel, ``draws`` holds this rank's shell rows and the mask reads
    their global indices."""
    radius = sup.border_radius
    sample_mask = out.get("sample_mask")

    def ray_mask(mask):
        return mask * sample_mask if sample_mask is not None else mask

    rank, size = world()
    first_row = shard_rows(sup.n_points, rank, size).start

    def shell_mask(pts):
        """The live rows of this rank's shell draw, by global row index."""
        if n_points_active is None:
            return None
        rows = first_row + torch.arange(pts.shape[0], device=centroid.device)
        return (rows < n_points_active).to(torch.float32)

    def vf_normals(pts):
        return field(pts)[:, :3]

    terms = []
    if sup.init_method == "center":
        # Ray samples near the border point inward (trainer :181-185)...
        mask, gt = points_ops.border_mask_and_gt(out["points"], far, radius,
                                                 centroid)
        terms.append((out["normals"], gt, ray_mask(mask)))
        # ...plus shell samples in [far/2 - r, far/2] (trainer :186-193).
        pts, gt_s = points_ops.sample_border_points(
            draws["border"], far / 2.0 - radius, far / 2.0, centroid)
        terms.append((vf_normals(pts), gt_s, shell_mask(pts)))
        return terms
    if sup.border_supervision:
        # Shell samples in [far - 5r, far] point inward (trainer :197-204).
        pts, gt_s = points_ops.sample_border_points(
            draws["border"], far - 5.0 * radius, far, centroid)
        terms.append((vf_normals(pts), gt_s, shell_mask(pts)))
    if sup.center_supervision:
        # Ray samples near the centroid point outward (trainer :205-209)...
        mask, gt = points_ops.center_mask_and_gt(out["points"], centroid,
                                                 radius)
        terms.append((out["normals"], gt, ray_mask(mask)))
        # ...plus ball samples around the centroid (trainer :210-216).
        pts, gt_s = points_ops.sample_center_points(draws["center"],
                                                    centroid, radius)
        terms.append((vf_normals(pts), gt_s, shell_mask(pts)))
    return terms


METRIC_KEYS = ("loss", "rgb_loss", "depth_loss", "unit_norm_loss",
               "supervision_loss", "norm_smaller_than_one_loss",
               "directional_derivatives_loss")

# Packed ray-batch layout: one (R, 38) f32 array per batch.
_PACK_SLICES = {
    "uv": (0, 2),
    "rgb": (2, 5),
    "depth": (5, 6),
    "intrinsics": (6, 22),
    "pose": (22, 38),
}
PACKED_WIDTH = 38


def pack_batch(batch: Dict[str, Any]) -> np.ndarray:
    """Pack a host ray batch into one (R, 38) float32 array."""
    n = len(batch["uv"])
    out = np.empty((n, PACKED_WIDTH), np.float32)
    for key, (lo, hi) in _PACK_SLICES.items():
        out[:, lo:hi] = np.asarray(batch[key]).reshape(n, hi - lo)
    return out


def unpack_batch(packed: torch.Tensor) -> Tensors:
    """Views of a packed (R, 38) tensor as the batch dict."""
    n = packed.shape[0]
    out = {}
    for key, (lo, hi) in _PACK_SLICES.items():
        arr = packed[:, lo:hi]
        if key in ("intrinsics", "pose"):
            arr = arr.reshape(n, 4, 4)
        out[key] = arr
    return out


def zero_metric_sums(device) -> Tensors:
    return {k: torch.zeros((), device=device) for k in METRIC_KEYS}


def make_loss_fn(modules: VFNerfModules, statics: RenderStatics,
                 sup: SupervisionStatics, loss_weights: VFLossWeights,
                 loss_config: VFLossConfig) -> Callable:
    """The loss the step differentiates: ``loss_fn(batch, draws, epoch,
    window_weights, near, far, centroid, n_fine_active=None,
    n_points_active=None)`` → (total, parts, render outputs); the outputs
    carry ``batch_stats_updates`` in train-mode BatchNorm."""
    fold = modules.supports_folding(statics)
    no_dd = dataclasses.replace(statics, compute_dir_derivatives=False)

    def loss_fn(batch, draws, epoch, window_weights, near, far, centroid,
                n_fine_active=None, n_points_active=None):
        folded = None
        if fold:
            with span("train.step.fold"):
                folded = modules.folded_weights(detach=False)
        dd_on = statics.compute_dir_derivatives and \
            epoch >= loss_config.directional_derivatives_start
        out = render_rays(modules, batch["uv"], batch["pose"],
                          batch["intrinsics"], near, far, window_weights,
                          statics if dd_on else no_dd,
                          t_coarse=draws.get("t_coarse"),
                          t_fine=draws.get("t_fine"),
                          u_extra=draws.get("u_extra"),
                          n_fine_active=n_fine_active, grad=True,
                          folded=folded)
        if fold:
            def field(pts):
                return modules.vf_apply_folded(folded[0], pts)
        else:
            def field(pts):
                return modules.vf_apply(pts, statics.train)
        terms = _supervision_terms(field, out, draws, far, centroid, sup,
                                   n_points_active)
        predictions = {"rgb": out["rgb"], "depth": out["depth"],
                       "normals": out["normals"].reshape(-1, 3)}
        if "sample_mask" in out:
            predictions["sample_mask"] = out["sample_mask"].reshape(-1)
        if "dir_derivative_norms" in out:
            predictions["dir_derivative_norms"] = out["dir_derivative_norms"]
        ground_truth = {"rgb": batch["rgb"], "depth": batch.get("depth")}
        total, parts = vf_loss(predictions, ground_truth, terms,
                               loss_weights, loss_config, epoch)
        return total, parts, out

    return loss_fn


REMAT_MODES = ("none", "full", "dots")


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of the products without a batch dimension;
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(loss_fn: Callable, remat: str) -> Callable:
    """``loss_fn`` with its backward rematerialized (module docstring)."""
    if remat == "none":
        return loss_fn
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown train_remat mode: {remat!r} "
                         "(expected 'none' | 'full' | 'dots')")
    kw = {} if remat == "full" else dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _dots_saveable))

    def wrapped(*args, **kwargs):
        return checkpoint(loss_fn, *args, use_reentrant=False, **kw,
                          **kwargs)
    return wrapped


def make_train_step(modules: VFNerfModules, optimizer: Optimizer,
                    statics: RenderStatics, sup: SupervisionStatics,
                    loss_weights: VFLossWeights,
                    loss_config: VFLossConfig,
                    remat: str = "none") -> Callable:
    """The step: ``step(metric_sums, batch, epoch, window_weights, near,
    far, centroid, n_fine_active=None, draws=None, generator=None)``
    updates the modules' parameters (and in train-mode BatchNorm their
    running statistics) and the optimizer in place and returns the metric
    sums plus this step's metrics (0-d tensors on the device; nothing is
    read back to the host).

    :param batch: dict of uv (R, 2), rgb (R, 3), depth (R, 1), pose
        (R, 4, 4), intrinsics (R, 4, 4), or a packed (R, 38) tensor; data
        parallel, this rank's ``local_ray_slice`` of the global batch.
    :param n_fine_active: static fine growth's live fine count (an int), or
        None when ``statics.n_fine`` is the fine count itself.
    :param draws: the global step's draws (``draw_step``); None draws them
        from ``generator``.
    :param remat: ``train_remat``: "none", "full" or "dots".
    """
    loss_fn = remat_wrap(make_loss_fn(modules, statics, sup, loss_weights,
                                      loss_config), remat)
    groups = param_groups(modules)

    def step(metric_sums, batch, epoch, window_weights, near, far, centroid,
             n_fine_active=None, draws=None, generator=None):
        with span("train.step"):
            return _step(metric_sums, batch, epoch, window_weights, near,
                         far, centroid, n_fine_active, draws, generator)

    def _step(metric_sums, batch, epoch, window_weights, near, far, centroid,
              n_fine_active, draws, generator):
        if not isinstance(batch, dict):
            batch = unpack_batch(batch)
        rank, size = world()
        n_local = batch["uv"].shape[0]
        n_rays = n_local * size
        with span("train.step.draw"):
            if draws is None:
                if generator is None:
                    raise ValueError("the train step needs its draws or a "
                                     "torch.Generator to draw them from")
                draws = draw_step(statics, sup, n_rays, generator,
                                  batch["uv"].device)
            draws = shard_draws(draws, slice(rank * n_local,
                                             (rank + 1) * n_local),
                                sup.n_points)
        n_points_active = None
        if n_fine_active is not None:
            n_points_active = max(
                (n_rays * (statics.n_coarse + int(n_fine_active))) // 10, 1)
        with span("train.step.forward"):
            total, parts, out = loss_fn(batch, draws, epoch, window_weights,
                                        near, far, centroid, n_fine_active,
                                        n_points_active)
        flat = [p for v in groups.values() for p in v]
        with span("train.step.backward"):
            got = torch.autograd.grad(total, flat, allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, got)]
            all_reduce_flat(got)
        got = iter(got)
        with span("train.step.optimizer"):
            optimizer.step(groups, {k: [next(got) for _ in v]
                                    for k, v in groups.items()})
            if "batch_stats_updates" in out:
                modules.apply_batch_stats(out["batch_stats_updates"])
        metrics = dict(parts, loss=total)
        return {k: metric_sums[k] + metrics[k].detach() for k in METRIC_KEYS}

    return step
