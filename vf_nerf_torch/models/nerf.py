"""Model facade ``VectorFieldNerf`` and its optimizer (port of
``vf_nerf_tpu/models/nerf.py``; reference
``models/nerf/vector_field_nerf.py:23-526``).

The facade owns the modules, the optimizer with its state and learning-rate
schedule, one ``torch.Generator`` on its device seeded from ``seed`` for the
render's and the training step's uniform draws, the fine-sample count, the
(annealed) window weights and near/far. Its weights are initialized on the
CPU from ``seed``, so a seed gives the same weights on every device.
Checkpoints, the runner and the mesh surfaces are later slices.

The optimizer (``make_optimizer``) is the JAX package's: clip by global
norm, Adam, and an exponential learning-rate decay per step. With fine
sampling on, the reference's optimizer sees the VF net's tensors twice
(``vector_field_nerf.py:127-137``), and ``duplicate_vf`` reproduces that:
the VF gradients count twice in the clip's norm and take the clip
coefficient squared, and Adam runs two sub-steps on them per step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vf_nerf_torch.config.schema import SchedulerConfig, VFNerfConfig
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           render_rays)
from vf_nerf_torch.ops.annealing import annealed_window_weights


Groups = Dict[str, List[torch.Tensor]]


def param_groups(modules: VFNerfModules) -> Dict[str, List[nn.Parameter]]:
    """The trainable tensors by the JAX params tree's top-level keys: the
    VF net (its Linear and BatchNorm parameters), the colour net, and the
    density scalars."""
    return {"vf": list(modules.vf.parameters()),
            "render": list(modules.render.parameters()),
            "density": list(modules.density.parameters())}


def _f32_pow(base: float, exponent: int) -> float:
    """``base ** exponent`` in float32, as the JAX optimizers take it."""
    return float(np.power(np.float32(base), np.float32(exponent)))


class ExponentialDecay:
    """``optax.exponential_decay(lr, transition_steps=1, decay_rate=gamma)``:
    ``lr · gamma^count`` in float32, ``lr`` at count 0."""

    def __init__(self, lr: float, gamma: float) -> None:
        self.lr, self.gamma = lr, gamma

    def __call__(self, count: int) -> float:
        if count <= 0:
            return float(np.float32(self.lr))
        return float(np.float32(self.lr) * np.float32(
            _f32_pow(self.gamma, count)))


class Optimizer:
    """Global-norm clip, Adam and a per-step learning rate over named
    groups of tensors, updated in place. State: ``mu`` and ``nu`` (per
    group, one tensor per parameter) and ``count`` (steps taken).

    ``duplicate_vf=False`` follows optax's ``clip_by_global_norm`` (no
    +1e-6: updates × max_norm / norm when the norm reaches max_norm), then
    ``add_decayed_weights`` when ``weight_decay`` > 0, ``scale_by_adam``
    (eps 1e-8) and ``scale_by_learning_rate``. ``duplicate_vf=True`` is the
    JAX package's ``_duplicate_vf_optimizer``: torch ``clip_grad_norm_``'s
    coefficient ``min(c / (norm + 1e-6), 1)`` with the ``"vf"`` group
    counted twice in the norm and scaled by the coefficient squared, and
    two Adam sub-steps (counts 2t − 1 and 2t) on the ``"vf"`` group.
    """

    def __init__(self, schedule: ExponentialDecay, clip_norm: float,
                 weight_decay: float = 0.0, duplicate_vf: bool = False,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.duplicate_vf = duplicate_vf
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu: Groups = {}
        self.nu: Groups = {}
        self.count = 0

    def init(self, params: Groups) -> "Optimizer":
        self.mu = {k: [torch.zeros_like(p) for p in v]
                   for k, v in params.items()}
        self.nu = {k: [torch.zeros_like(p) for p in v]
                   for k, v in params.items()}
        self.count = 0
        return self

    @torch.no_grad()
    def step(self, params: Groups, grads: Groups) -> None:
        """One update of ``params`` from ``grads`` (same groups, same
        order)."""
        lr = self.schedule(self.count)
        t = self.count + 1
        grads = self._clip(grads)
        if self.weight_decay > 0:
            grads = {k: [g + self.weight_decay * p
                         for g, p in zip(grads[k], params[k])]
                     for k in grads}
        for k in params:
            g = grads[k]
            if self.duplicate_vf and k == "vf":
                u1 = self._adam_sub(k, g, 2 * t - 1)
                u2 = self._adam_sub(k, g, 2 * t)
                update = torch._foreach_add(u1, u2)
            else:
                update = self._adam_sub(k, g, t)
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(params[k], update)
        self.count = t

    def _clip(self, grads: Groups) -> Groups:
        norms = {k: torch._foreach_norm(v) for k, v in grads.items() if v}
        total_sq = sum(torch.sum(torch.stack(n) ** 2) for n in norms.values())
        if not self.duplicate_vf:
            g_norm = torch.sqrt(total_sq)
            keep = g_norm < self.clip_norm
            return {k: [torch.where(keep, g, g / g_norm * self.clip_norm)
                        for g in v] for k, v in grads.items()}
        vf_sq = torch.sum(torch.stack(norms["vf"]) ** 2) \
            if "vf" in norms else 0.0
        total_norm = torch.sqrt(total_sq + vf_sq)
        coef = torch.clamp(self.clip_norm / (total_norm + 1e-6), max=1.0)
        return {k: torch._foreach_mul(v, coef ** 2 if k == "vf" else coef)
                for k, v in grads.items()}

    def _adam_sub(self, key: str, g: List[torch.Tensor],
                  step: int) -> List[torch.Tensor]:
        """Moments of group ``key`` updated in place; returns the unscaled
        update mhat / (sqrt(vhat) + eps) at Adam count ``step``."""
        b1, b2 = self.b1, self.b2
        mu, nu = self.mu[key], self.nu[key]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1.0 - b2))
        mhat = torch._foreach_div(mu, 1.0 - _f32_pow(b1, step))
        vhat = torch._foreach_div(nu, 1.0 - _f32_pow(b2, step))
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), self.eps)
        return torch._foreach_div(mhat, denom)


def make_optimizer(cfg: SchedulerConfig, decay_steps: Optional[int] = None,
                   duplicate_vf: bool = False
                   ) -> Tuple[Optimizer, ExponentialDecay]:
    """Adam + exponential per-step decay + global-norm clip (reference
    ``vector_field_nerf.py:63-67``, γ = decay_factor^(1/decay_steps), and
    ``vector_field_nerf_train.py:255-256``). Returns (optimizer, schedule);
    call ``optimizer.init(param_groups(modules))`` before its first step."""
    steps = decay_steps if decay_steps is not None else cfg.lr_decay_steps
    gamma = cfg.lr_decay_factor ** (1.0 / max(steps, 1))
    schedule = ExponentialDecay(cfg.lr, gamma)
    return Optimizer(schedule, cfg.clip_norm, cfg.weight_decay,
                     duplicate_vf=duplicate_vf), schedule


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises if CUDA is asked for and missing: the
    port never drops to the CPU unless the caller passes ``"cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "vf_nerf_torch on the CPU")
    return device


class VectorFieldNerf:
    """The VF-NeRF model: modules, optimizer, schedule and draws."""

    def __init__(self, config: VFNerfConfig, seed: int = 42,
                 device=None, decay_steps: Optional[int] = None) -> None:
        self.device = resolve_device(device)
        self.config = config
        init = torch.Generator().manual_seed(seed)
        self.modules = VFNerfModules(config, generator=init).to(
            self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.decay_steps = decay_steps
        # Fine sampling makes the reference's optimizer see the VF net twice.
        self.duplicate_vf = config.ray_sampler_config.n_importance > 0
        self.optimizer, self.lr_schedule = make_optimizer(
            config.scheduler_config, decay_steps,
            duplicate_vf=self.duplicate_vf)
        self.optimizer.init(param_groups(self.modules))
        self.fine_n_samples = config.ray_sampler_config.n_importance
        self.window_weights = np.asarray(config.cos_sim_weights, np.float32)
        self.near = config.ray_sampler_config.near
        self.far = config.ray_sampler_config.far

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    def eval(self) -> None:
        """BatchNorm on running statistics (the only mode ported; training
        runs with it frozen, as the shipped conf trains)."""
        self.modules.eval()

    def update_annealing(self, epoch: int) -> np.ndarray:
        """Epoch-gated window-weight annealing; returns the active taps."""
        self.window_weights = annealed_window_weights(
            np.asarray(self.config.cos_sim_weights, np.float32),
            self.config.cos_sim_weights_anneal,
            self.config.anneal_start, self.config.anneal_end, epoch)
        return self.window_weights

    def render_statics(self, white_background: bool = False,
                       n_fine: Optional[int] = None) -> RenderStatics:
        return RenderStatics.from_config(
            self.config,
            n_fine=self.fine_n_samples if n_fine is None else n_fine,
            train=self.modules.training,
            white_background=white_background)

    def _tensor(self, x) -> torch.Tensor:
        """f32 on the facade's device. Host data goes through pinned memory
        with an asynchronous copy: a copy from pageable memory would wait
        for the stream and stall the previous render's queue."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.to(torch.float32)
        t = torch.as_tensor(np.asarray(x, np.float32))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def render(self, pose, pixels, intrinsics, epoch: int,
               white: bool = False) -> Dict[str, torch.Tensor]:
        """Anneal, then render the rays of ``pixels`` (R, 2) with per-ray
        ``pose`` (R, 4, 4) or (R, 7) and ``intrinsics`` (R, 4, 4); returns
        the dict of ``render_rays``."""
        self.update_annealing(epoch)
        return render_rays(
            self.modules, self._tensor(pixels), self._tensor(pose),
            self._tensor(intrinsics), self.near, self.far,
            self._tensor(self.window_weights),
            self.render_statics(white_background=white),
            generator=self.generator)

    def render_image(self, pixels, pose, intrinsics, epoch: int,
                     white: bool = False, split_size: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render all of an image's rays in chunks of ``split_size``, with
        one (4, 4) ``pose`` and ``intrinsics`` for the image. Each chunk
        draws from the facade's generator exactly as one ``render`` call of
        that chunk would. Returns rgb (N, 3) and depth (N, 1) on the
        facade's device."""
        self.update_annealing(epoch)
        statics = self.render_statics(white_background=white)
        uv = self._tensor(pixels)
        pose44 = self._tensor(pose).reshape(4, 4)
        intr44 = self._tensor(intrinsics).reshape(4, 4)
        weights = self._tensor(self.window_weights)
        rgbs, depths = [], []
        for chunk in torch.split(uv, split_size):
            n = chunk.shape[0]
            out = render_rays(self.modules, chunk, pose44.expand(n, 4, 4),
                              intr44.expand(n, 4, 4), self.near, self.far,
                              weights, statics, generator=self.generator)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
        return torch.cat(rgbs), torch.cat(depths)
