"""Model facade ``VectorFieldNerf`` and its optimizer (port of
``vf_nerf_tpu/models/nerf.py``; reference
``models/nerf/vector_field_nerf.py:23-526``).

The facade owns the modules, the optimizer with its state and learning-rate
schedule, one ``torch.Generator`` on its device seeded from ``seed`` for the
render's and the training step's uniform draws, the fine-sample count, the
(annealed) window weights and near/far. Its weights are initialized on the
CPU from ``seed``, so a seed gives the same weights on every device.

Checkpoints (``save`` / ``load``) are ``torch.save`` blobs in the
reference's ``.pth`` layout (``vf_net``, ``rendering_net``, ``density``,
``epoch``) plus the optimizer's moments and count and the fine-sample count;
``load_reference_pth`` reads a reference checkpoint and ``load_vf_init`` the
VF-init ``.pkl`` that either package writes. ``get_colors`` and
``get_weights_and_color`` are the reference's support surface for the joint
stage.

BatchNorm's mode is the modules' ``training`` flag: ``eval()`` runs it on
the running statistics, ``train()`` on each pass's batch statistics —
unless ``numerical_jacobian`` is set, which keeps it frozen (the JAX
package's quirk, reference ``vector_field_nerf.py:139-150``). The running
statistics are buffers of the nets' state dicts, so checkpoints carry them.

The optimizer (``make_optimizer``) is the JAX package's: clip by global
norm, Adam, and an exponential learning-rate decay per step. With fine
sampling on, the reference's optimizer sees the VF net's tensors twice
(``vector_field_nerf.py:127-137``), and ``duplicate_vf`` reproduces that:
the VF gradients count twice in the clip's norm and take the clip
coefficient squared, and Adam runs two sub-steps on them per step.

``enable_mesh_eval(devices)`` spreads the eval render over several local
devices (JAX ``enable_mesh_eval``, ``vf_nerf_tpu/models/nerf.py:280-313``):
each chunk of rays whose count divides by the device count is split into
contiguous parts, one per device, each rendered by a replica of the modules
on its device (on its own thread, and on CUDA its own stream); the draws
are the whole chunk's, drawn from the facade's generator as one device
draws them and sliced, and the parts are gathered in order. Every render op
is per ray, so the result is bit-equal to one device; a chunk that does not
divide renders on the facade's device. ``get_vector_field`` runs on the
device of the points it is given, on that device's replica (the octant
spread of ``DeviceMeshExtractor.extract_many``).
"""

from __future__ import annotations

import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vf_nerf_torch.config.schema import SchedulerConfig, VFNerfConfig
from vf_nerf_torch.models.renderer import (RenderStatics, VFNerfModules,
                                           draw_uniforms, param_groups,
                                           render_rays,
                                           weights_and_composite)
from vf_nerf_torch.ops import samplers
from vf_nerf_torch.ops.annealing import annealed_window_weights
from vf_nerf_torch.ops.density import get_beta, get_mean, get_scale
from vf_nerf_torch.ops.rays import get_ray_directions_and_cam_location
from vf_nerf_torch.parallel.mesh import (indexed, make_mesh,
                                         on_stream_of, replicate)
from vf_nerf_torch.utils import checkpoint as ckpt_io
from vf_nerf_torch.utils.weights import (load_mlp_variables,
                                         load_reference_state)

Groups = Dict[str, List[torch.Tensor]]


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
    ``clip_norm=None`` clips nothing (``optax.adam`` with that schedule).
    """

    def __init__(self, schedule: ExponentialDecay, clip_norm: Optional[float],
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

    def state_dict(self) -> Dict[str, Any]:
        """The moments (group → tensors, live references) and the count."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy saved moments into this optimizer's tensors (same groups and
        shapes) and take the count."""
        for key in ("mu", "nu"):
            for group, tensors in getattr(self, key).items():
                for dst, src in zip(tensors, state[key][group], strict=True):
                    dst.copy_(src)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: Groups, grads: Groups) -> None:
        """One update of ``params`` from ``grads`` (same groups, same
        order)."""
        lr = self.schedule(self.count)
        t = self.count + 1
        if self.clip_norm is not None:
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
        # The eval render's devices (``enable_mesh_eval``) and the modules'
        # replicas on the devices other than the facade's.
        self.eval_devices: Optional[List[torch.device]] = None
        self._replicas: Dict[torch.device, VFNerfModules] = {}

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    def train(self) -> None:
        """BatchNorm on batch statistics, unless ``numerical_jacobian``
        keeps it frozen (JAX ``VectorFieldNerf.train``)."""
        self.modules.train(not self.config.numerical_jacobian)

    def eval(self) -> None:
        """BatchNorm on its running statistics."""
        self.modules.eval()

    def update_annealing(self, epoch: int) -> np.ndarray:
        """Epoch-gated window-weight annealing; returns the active taps."""
        self.window_weights = annealed_window_weights(
            np.asarray(self.config.cos_sim_weights, np.float32),
            self.config.cos_sim_weights_anneal,
            self.config.anneal_start, self.config.anneal_end, epoch)
        return self.window_weights

    def render_statics(self, train: Optional[bool] = None,
                       white_background: bool = False,
                       compute_dir_derivatives: bool = False,
                       n_fine: Optional[int] = None) -> RenderStatics:
        """The statics at the fine count (``n_fine`` or the current one) and
        BatchNorm mode (``train`` or the modules', as JAX
        ``render_statics``)."""
        return RenderStatics.from_config(
            self.config,
            n_fine=self.fine_n_samples if n_fine is None else n_fine,
            train=self.modules.training if train is None else train,
            white_background=white_background,
            compute_dir_derivatives=compute_dir_derivatives)

    def _nets(self, statics: RenderStatics):
        """(VF net, colour net) as callables of this BatchNorm mode: the
        fused MLP over folded weights, or the unfolded nets."""
        mods = self.modules
        if mods.supports_folding(statics):
            vf_w, rn_w = mods.folded_weights()
            return (lambda p: mods.vf_apply_folded(vf_w, p),
                    lambda *a: mods.render_apply_folded(rn_w, *a))
        return (lambda p: mods.vf_apply(p, statics.train),
                lambda *a: mods.render_apply(*a, statics.train))

    def to_device(self, x) -> torch.Tensor:
        """f32 on the facade's device. Host data goes through pinned memory
        with an asynchronous copy: a copy from pageable memory would wait
        for the stream and stall the previous render's queue."""
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.to(self.device, torch.float32)
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
        self.sync_replicas()
        return self._render_chunk(
            self.to_device(pixels), self.to_device(pose),
            self.to_device(intrinsics), self.to_device(self.window_weights),
            self.render_statics(white_background=white))

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
        uv = self.to_device(pixels)
        pose44 = self.to_device(pose).reshape(4, 4)
        intr44 = self.to_device(intrinsics).reshape(4, 4)
        weights = self.to_device(self.window_weights)
        self.sync_replicas()
        rgbs, depths = [], []
        for chunk in torch.split(uv, split_size):
            n = chunk.shape[0]
            out = self._render_chunk(chunk, pose44.expand(n, 4, 4),
                                     intr44.expand(n, 4, 4), weights, statics)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
        return torch.cat(rgbs), torch.cat(depths)

    # ---------------------------------------------------------- mesh eval
    def enable_mesh_eval(self, devices: Optional[Sequence] = None) -> None:
        """Spread the eval render (and the octant spread of the mesh
        methods) over ``devices`` (default: every local CUDA device), each
        with a replica of the modules; one device turns it off."""
        devs = make_mesh(0, devices)
        self.eval_devices = devs if len(devs) > 1 else None
        self._replicas = {d: r for d, r in zip(devs, replicate(self.modules,
                                                               devs))
                          if r is not self.modules}

    @torch.no_grad()
    def sync_replicas(self) -> None:
        """Copy the modules' current state into every replica."""
        state = self.modules.state_dict()
        for replica in self._replicas.values():
            replica.load_state_dict(state)

    def _modules_on(self, device: torch.device) -> VFNerfModules:
        if device == indexed(self.device):
            return self.modules
        if device not in self._replicas:
            raise ValueError(f"no replica of the modules on {device}; "
                             "enable_mesh_eval with it first")
        return self._replicas[device]

    def _render_chunk(self, uv, pose, intrinsics, weights,
                      statics: RenderStatics) -> Dict[str, torch.Tensor]:
        """``render_rays`` of one chunk on the facade's device, or split
        over the eval devices when its ray count divides by theirs."""
        devs = self.eval_devices
        n = uv.shape[0]
        if devs is None or n % len(devs):
            return render_rays(self.modules, uv, pose, intrinsics, self.near,
                               self.far, weights, statics,
                               generator=self.generator)
        draws = draw_uniforms(statics, n, self.generator, self.device)
        per = n // len(devs)
        home = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

        def part(i):
            dev, rows = devs[i], slice(i * per, (i + 1) * per)

            def run():
                def put(x):
                    return None if x is None else x[rows].to(dev)
                return render_rays(
                    self._modules_on(dev), put(uv), put(pose),
                    put(intrinsics), self.near, self.far, weights.to(dev),
                    statics, t_coarse=put(draws["t_coarse"]),
                    t_fine=put(draws["t_fine"]),
                    u_extra=put(draws["u_extra"]))
            return on_stream_of(dev, home, run)

        with ThreadPoolExecutor(len(devs)) as pool:
            parts = list(pool.map(part, range(len(devs))))
        out = {k: torch.cat([p[k].to(self.device) for p in parts])
               for k, v in parts[0].items() if isinstance(v, torch.Tensor)}
        # The parts' memory is reused on their streams only after the
        # gather has read it.
        for dev in set(devs) | {self.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out

    @torch.no_grad()
    def get_vector_field(self, points, chunk: int = 1 << 17
                         ) -> torch.Tensor:
        """The raw field (N, 3) at ``points`` (N, 3) through the BN-folded VF
        net, one fused-MLP launch per ``chunk`` points (reference
        ``get_vector_field``, ``vector_field_nerf.py:380-403``). A tensor on
        another eval device runs there, on its replica."""
        if isinstance(points, torch.Tensor) and points.device in \
                self._replicas:
            modules = self._replicas[points.device]
            pts = points.to(torch.float32).reshape(-1, 3)
        else:
            modules = self.modules
            pts = self.to_device(points).reshape(-1, 3)
        vf_w = modules.vf.folded_weights()
        return torch.cat([modules.vf_apply_folded(vf_w, part)[:, :3]
                          for part in torch.split(pts, chunk)])

    @torch.no_grad()
    def get_colors(self, pose, pixels, intrinsics, epoch: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample colours on the coarse sample grid (reference
        ``get_colors``, ``vector_field_nerf.py:341-378``): stratified depths
        (the jitter from the facade's generator when perturb is on), the VF
        net, the colour net. ``pose`` (R, 4, 4) or (R, 7) per ray. Returns
        (rgb (R·S, 3), points (R·S, 3), the ray directions repeated per
        sample (R·S, 3))."""
        self.update_annealing(epoch)
        statics = self.render_statics()
        uv = self.to_device(pixels)
        directions, ray_dirs, cam_loc = get_ray_directions_and_cam_location(
            uv, self.to_device(pose), self.to_device(intrinsics))
        n_rays, n = uv.shape[0], statics.n_coarse
        t = torch.rand((n_rays, n), generator=self.generator,
                       device=self.device) if statics.perturb else None
        z = samplers.uniform_z_vals(n_rays, n, self.near, self.far,
                                    perturb=statics.perturb, t=t,
                                    device=self.device)
        flat = samplers.points_from_z(cam_loc, directions, z).reshape(-1, 3)
        vf_net, colour_net = self._nets(statics)
        vf_out = vf_net(flat)
        feat_dim = self.config.vf_net_config.feature_vector_dims
        dirs_rep = ray_dirs[:, None, :].expand(-1, n, -1).reshape(-1, 3)
        rgb = colour_net(flat, vf_out[:, :3], dirs_rep,
                         vf_out[:, 3:3 + feat_dim])
        return rgb, flat, dirs_rep

    @torch.no_grad()
    def get_weights_and_color(self, points, repeated_ray_dirs, z_vals,
                              epoch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rendering weights (R, S) and per-sample colours (R·S, 3) at given
        points (R·S, 3) or (R, S, 3), with each ray's unit direction
        repeated per sample and depths z (R, S) (reference
        ``get_weights_and_color``, ``vector_field_nerf.py:405-440``): the
        VF net, the fine pass's density and weights (for volsdf the fused
        ray march, weights only; for nerf the plain density and
        ``nerf_volume_rendering``), the colour net."""
        self.update_annealing(epoch)
        statics = self.render_statics()
        z = self.to_device(z_vals)
        n_rays, n = z.shape
        flat = self.to_device(points).reshape(-1, 3)
        dirs = self.to_device(repeated_ray_dirs).reshape(-1, 3)
        vf_net, colour_net = self._nets(statics)
        vf_out = vf_net(flat)
        feat_dim = self.config.vf_net_config.feature_vector_dims
        normals = vf_out[:, :3].reshape(n_rays, n, 3).contiguous()
        n_taps = statics.n_window
        taps = self.to_device(self.window_weights) \
            if statics.anneal_mode == "anneal_fine" else \
            torch.full((n_taps,), 1.0 / n_taps, device=self.device)
        _, _, weights = weights_and_composite(
            statics, normals, dirs.reshape(n_rays, n, 3)[:, 0].contiguous(),
            z.contiguous(), None, self.modules.density.params(), taps)
        rgb = colour_net(flat, vf_out[:, :3], dirs, vf_out[:, 3:3 + feat_dim])
        return weights, rgb

    # ------------------------------------------------------------- logging
    @torch.no_grad()
    def density_scalar_tensors(self) -> Dict[str, torch.Tensor]:
        """The clamped density scalars β, scale and mean as 0-d tensors on
        the device (the runner reads them with the epoch's metric sums)."""
        d = self.modules.density.params()
        dc = self.config.density_config
        return {"beta": get_beta(d, tuple(dc.beta_bounds)),
                "scale": get_scale(d, dc.scale_min),
                "mean": get_mean(d, tuple(dc.mean_bounds))}

    def density_scalars(self) -> Dict[str, float]:
        """The clamped density scalars, in one read from the device."""
        scalars = self.density_scalar_tensors()
        values = torch.stack(list(scalars.values())).cpu().tolist()
        return dict(zip(scalars, values))

    def host_lr(self, step: int) -> float:
        """The learning rate at optimizer step ``step`` (float32, as JAX)."""
        return self.lr_schedule(step)

    def current_lr(self) -> float:
        return self.host_lr(self.step)

    def reset_scheduler(self, num_steps: Optional[int] = None) -> None:
        """A fresh optimizer and schedule over ``num_steps`` decay steps
        (reference ``reset_scheduler``, ``vector_field_nerf.py:115-125``)."""
        self.optimizer, self.lr_schedule = make_optimizer(
            self.config.scheduler_config, num_steps,
            duplicate_vf=self.duplicate_vf)
        self.optimizer.init(param_groups(self.modules))


    # ---------------------------------------------------------- checkpoint
    def _ckpt_state(self, epoch: int) -> Dict[str, Any]:
        return {"vf_net": self.modules.vf.state_dict(),
                "rendering_net": self.modules.render.state_dict(),
                "density": self.modules.density.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "epoch": epoch,
                "fine_n_samples": self.fine_n_samples}

    def save(self, epoch: int, path_dir: str) -> str:
        """Write ``{epoch}.ckpt`` and ``latest.ckpt`` in ``path_dir``
        (reference ``save``, ``vector_field_nerf.py:196-214``)."""
        return ckpt_io.save_checkpoint(path_dir, epoch,
                                       self._ckpt_state(epoch))

    def load(self, path: str) -> int:
        """Restore the modules, the optimizer and the fine-sample count from
        a ``save`` file; returns the saved epoch + 1 (reference ``load``,
        ``vector_field_nerf.py:162-194``)."""
        blob = ckpt_io.load_checkpoint(path, self.device)
        self.modules.vf.load_state_dict(blob["vf_net"])
        self.modules.render.load_state_dict(blob["rendering_net"])
        self.modules.density.load_state_dict(blob["density"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.fine_n_samples = int(blob["fine_n_samples"])
        return int(blob["epoch"]) + 1

    def load_reference_pth(self, path: str) -> int:
        """A reference checkpoint's network and density weights (the
        optimizer starts afresh); returns its epoch + 1."""
        epoch = load_reference_state(self.modules, path)
        self.optimizer.init(param_groups(self.modules))
        return epoch

    def load_vf_init(self, path: str) -> None:
        """VF-init weights from a ``.pkl`` of ``train/vf_init.py`` (either
        package writes the same layout) into the VF net only; the optimizer
        starts afresh, as in the JAX package (reference
        ``VectorFieldNetwork.load_init``, ``vector_field_network.py:109-138``).
        Unpickles the file: load only files this project wrote."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        load_mlp_variables(self.modules.vf, blob["params"],
                           blob.get("batch_stats") or {})
        self.optimizer.init(param_groups(self.modules))
