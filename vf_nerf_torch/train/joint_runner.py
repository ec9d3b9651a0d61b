"""The joint pose-and-field stage ``JointOptimizationRunner`` (port of
``vf_nerf_tpu/train/joint_runner.py:69-567``). The reference ships its config
contract and the facade's support surface but no trainer; the stage is the
JAX package's design:

- **pose refinement**: each training view's camera is a 7-d ``[quaternion |
  translation]`` parameter, initialised from the dataset by
  ``matrix_to_pose7``; rays render through the quaternion path, so the RGB
  and depth losses reach the poses (through the points into the VF net's
  input and into the colour net's, and through the view directions);
- **the optimizer**, Adam per group: the poses at ``pose_lr`` (0:
  ``refinement_init_lr``), the field at ``refinement_init_lr``. For the first
  ``pose_only_epochs`` epochs the field is frozen and the poses' learning rate
  decays exponentially to ``pose_lr · pose_lr_decay``; at the boundary both
  groups start with fresh moments, the poses at that floor.
  ``anchor_first_pose`` zeroes pose 0's gradient before Adam;
- **supervision blocks**: every ``supervise_every`` epochs after the warm-up
  (when ``supervised_loss_weights.supervision`` > 0), ``supervision_epochs``
  steps sharpen the field toward the scene's dominant directions: surface
  points backprojected from the sensor depth, their targets the field
  snapped to the nearest ``±`` basis, and points pulled toward the centroid
  supervised to point at their surface point. The bases come from the field
  at surface points (``kmeans2``, ``self_supervise``) or from a res-128
  marching-cubes mesh (``get_dominant_bases``). The targets snap against
  the field as it stood at the block's start;
- the joint loss: ``rgb``·L1 + ``depth``·clamped L1 (the VF conf's
  ``depth_loss_clamp``) + ``unit_norm`` + ``similarity``
  (``models/loss.py::similarity_loss`` on the two halves of each ray's
  samples), with the ``supervised_loss_weights``.

The step renders with BatchNorm folded and frozen, as the JAX stage's
``render_statics(train=False)``: on CUDA tensors one joint step launches the
fused MLP 3 times (the coarse VF without gradients; the fine VF and the colour
net in save mode, their backward returning the input gradient ``dx``), the
ray march twice and its backward once. The field's own gradients are not
taken in the pose-only epochs (the folded weights are constants there). A
supervised step launches the VF net twice in save mode. This port honours
``rendering.detach_normals`` (``ROADMAP.md`` §C: the JAX folded path ignores
it), so its oracle is the JAX step with ``fast_eval=False``.

Random draws: the render's uniforms come from the facade's generator unless
``train(draws=...)`` / ``train_epoch(epoch, draws=...)`` gets a callable
``(epoch, joint step) → {"t_coarse", "t_fine", "u_extra"}`` (the joint step
counts from 0 over the run). Batches, surface pixels and the off-surface
offsets come from the runner's ``np.random.RandomState(42)`` in the JAX
runner's order, so both packages draw the same ones.

Checkpoints are the facade's (``VectorFieldNerf.save``) with the poses
added under ``"poses"``; a resume (``checkpoint``) loads the model and, when
the file has them, the refined poses (the JAX stage reloads the model
only). The JAX package's scan dispatch is not ported: a step is a sequence
of launches on one card.

Data parallel (``ROADMAP.md`` A.6), as the JAX stage shards over its
devices: one process per device (``parallel/multihost.py``), every rank
with the same batches, draws and supervision points, each trimmed to a
multiple of the rank count (the JAX runner's ``_trim``: on 2 ranks the
4,095 supervision points of 3 views become 4,094) and sliced to the rank's
rows; the means, the similarity gate's largest miss and its count are the
global batch's (``models/loss.py``); the field's and the poses' gradients
are summed over the ranks in one all-reduce before Adam; the dominant
bases are rank 0's. Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vf_nerf_torch.config.joint_schema import JointOptimizationConfig
from vf_nerf_torch.config.parser import config_device
from vf_nerf_torch.config.schema import VFSupervisedLossWeights
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.models.loss import similarity_loss
from vf_nerf_torch.models.nerf import (ExponentialDecay, Optimizer,
                                       VectorFieldNerf, param_groups)
from vf_nerf_torch.models.renderer import draw_uniforms, render_rays
from vf_nerf_torch.ops.rays import matrix_to_pose7, pose7_to_matrix
from vf_nerf_torch.parallel.mesh import (all_reduce_flat, global_mean,
                                         trim_to_multiple)
from vf_nerf_torch.parallel.multihost import (broadcast_from_rank0,
                                              check_world, local_device,
                                              local_ray_slice)
from vf_nerf_torch.utils import checkpoint as ckpt_io
from vf_nerf_torch.utils.logging import MetricsLogger
from vf_nerf_torch.utils.prefetch import Prefetcher

Draws = Callable[[int, int], Dict[str, torch.Tensor]]
RAY_KEYS = ("uv", "rgb", "depth", "intrinsics", "view_idx")


def snap_to_bases(vectors: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """The nearest signed basis per vector: ``±b`` maximising |v·b|."""
    dots = vectors @ bases.t()
    best = torch.argmax(dots.abs(), dim=1)
    signs = torch.sign(dots[torch.arange(len(vectors),
                                         device=vectors.device), best])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return bases[best] * signs[:, None]


class PoseDecay:
    """``optax.exponential_decay(lr, steps, rate, end_value=lr · rate)`` in
    float32: ``lr · rate^(count / steps)``, held at its end value."""

    def __init__(self, lr: float, steps: int, rate: float) -> None:
        self.lr, self.steps, self.rate = lr, steps, rate

    def __call__(self, count: int) -> float:
        lr = np.float32(self.lr)
        if count <= 0:
            return float(lr)
        p = np.float32(count) / np.float32(self.steps)
        value = lr * np.power(np.float32(self.rate), p)
        return float(max(value, np.float32(self.lr * self.rate)))


class JointOptimizationRunner:
    JOINT_METRICS = ("loss", "rgb_loss", "depth_loss", "unit_norm_loss",
                     "similarity_loss")
    SUP_METRICS = ("loss", "surface_loss", "non_surface_loss")

    def __init__(self, config: JointOptimizationConfig, device=None) -> None:
        self.config = config
        vf_cfg = config.vf_config
        np.random.seed(42)
        self.rank, self.world_size = check_world(
            vf_cfg.vf_nerf_config.device_config.num_devices)
        if device is None:
            device = config_device(vf_cfg) if self.world_size == 1 \
                else local_device(config_device(vf_cfg))
        self.dataset = dataset_dict[vf_cfg.dataset_config.dataset_name](
            vf_cfg.dataset_config)
        tc = config.train_config
        self.model = VectorFieldNerf(
            vf_cfg.vf_nerf_config, seed=42, device=device,
            decay_steps=max(tc.joint_epochs * len(self.dataset), 1))
        self.device = self.model.device
        self.model.near, self.model.far = self.dataset.get_bounds()
        self.model.eval()

        self.run_dir = os.path.join(vf_cfg.exps_folder, vf_cfg.expname,
                                    vf_cfg.timestamp or "joint")
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints", "vf_nerf")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.poses = matrix_to_pose7(torch.from_numpy(
            np.asarray(self.dataset.poses, np.float32))).to(
                self.device).requires_grad_(True)
        if vf_cfg.checkpoint:
            path = os.path.join(self.ckpt_dir, f"{vf_cfg.checkpoint}.ckpt")
            if os.path.exists(path):
                self.model.load(path)
                blob = ckpt_io.load_checkpoint(path, self.device)
                if "poses" in blob:
                    self.pose_params = blob["poses"]
        self.weights: VFSupervisedLossWeights = vf_cfg.supervised_loss_weights

        self._model_lr = tc.refinement_init_lr
        self._pose_lr = tc.pose_lr if tc.pose_lr > 0 else \
            tc.refinement_init_lr
        self.model_opt: Optional[Optimizer] = None
        self.pose_opt: Optional[Optimizer] = None
        self._make_optimizers(freeze_model=tc.pose_only_epochs > 0)
        self.logger = MetricsLogger(self.run_dir, vf_cfg.wandb_project,
                                    vf_cfg.expname + "_joint",
                                    vf_cfg.timestamp or "joint",
                                    offline=vf_cfg.offline) \
            if self.rank == 0 else None
        self._bases: Optional[np.ndarray] = None
        self._rng = np.random.RandomState(42)
        self.joint_steps = 0

    # -------------------------------------------------------------- poses
    @property
    def pose_params(self) -> np.ndarray:
        """The (V, 7) poses on the host."""
        return self.poses.detach().cpu().numpy()

    @pose_params.setter
    def pose_params(self, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, np.float32))
        with torch.no_grad():
            self.poses.copy_(value)

    def refined_poses(self) -> np.ndarray:
        """(V, 4, 4) refined camera-to-world matrices."""
        with torch.no_grad():
            return pose7_to_matrix(self.poses).cpu().numpy()

    # ---------------------------------------------------------- optimizer
    def _make_optimizers(self, freeze_model: bool) -> None:
        """Adam per group with fresh moments (``_make_joint_tx`` of the JAX
        runner): the field at ``refinement_init_lr`` unless frozen (no
        optimizer), the poses at ``pose_lr``, decayed over the warm-up when
        ``pose_lr_decay`` ≠ 1 and held at the floor after it."""
        tc = self.config.train_config
        pose_lr = ExponentialDecay(self._pose_lr, 1.0)
        if tc.pose_lr_decay != 1.0 and tc.pose_only_epochs > 0:
            if freeze_model:
                steps = max(tc.pose_only_epochs * len(self.dataset), 1)
                pose_lr = PoseDecay(self._pose_lr, steps, tc.pose_lr_decay)
            else:
                pose_lr = ExponentialDecay(
                    self._pose_lr * tc.pose_lr_decay, 1.0)
        self.pose_opt = Optimizer(pose_lr, clip_norm=None).init(
            {"poses": [self.poses]})
        self.model_opt = None if freeze_model else Optimizer(
            ExponentialDecay(self._model_lr, 1.0), clip_norm=None).init(
                param_groups(self.model.modules))

    def _apply(self, model_grads: Optional[Dict[str, List[torch.Tensor]]],
               pose_grad: torch.Tensor) -> None:
        """One Adam step of each group (the field's unless frozen)."""
        if self.config.train_config.anchor_first_pose:
            pose_grad = pose_grad.clone()
            pose_grad[0] = 0.0
        if self.model_opt is not None:
            self.model_opt.step(param_groups(self.model.modules), model_grads)
        self.pose_opt.step({"poses": [self.poses]}, {"poses": [pose_grad]})

    def _grads(self, total: torch.Tensor, with_model: bool
               ) -> Tuple[Optional[Dict[str, List[torch.Tensor]]],
                          torch.Tensor]:
        """(the field's gradients by group or None, the poses' gradient);
        a tensor that the loss does not reach gets zeros."""
        groups = param_groups(self.model.modules) if with_model else {}
        flat = [p for ps in groups.values() for p in ps] + [self.poses]
        got = torch.autograd.grad(total, flat, allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, got)]
        all_reduce_flat(got)
        out, i = {}, 0
        for key, ps in groups.items():
            out[key] = got[i:i + len(ps)]
            i += len(ps)
        return (out if with_model else None), got[-1]

    # -------------------------------------------------------------- steps
    def joint_loss(self, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]], statics,
                   near: float, far: float, window: torch.Tensor,
                   freeze_model: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, parts) of the joint loss on one ray batch (this rank's
        slice; ``draws``: the global batch's, or None to draw them); the
        graph reaches the poses and, unless ``freeze_model``, the field."""
        modules = self.model.modules
        weights = self.weights
        folded = modules.folded_weights(detach=freeze_model)
        pose7 = self.poses[batch["view_idx"].long()]
        n_local = batch["uv"].shape[0]
        if self.world_size > 1:
            if not draws:
                draws = draw_uniforms(statics, n_local * self.world_size,
                                      self.model.generator, self.device)
            rows = slice(self.rank * n_local, (self.rank + 1) * n_local)
            draws = {k: None if v is None else v[rows]
                     for k, v in draws.items()}
        draws = draws or {}
        out = render_rays(modules, batch["uv"], pose7, batch["intrinsics"],
                          near, far, window, statics,
                          generator=self.model.generator,
                          t_coarse=draws.get("t_coarse"),
                          t_fine=draws.get("t_fine"),
                          u_extra=draws.get("u_extra"),
                          grad=True, folded=folded)
        clamp = self.config.vf_config.vf_loss_config.depth_loss_clamp
        rgb_loss = global_mean(torch.abs(out["rgb"] - batch["rgb"]))
        depth_err = torch.abs(out["depth"] - batch["depth"])
        depth_loss = global_mean(torch.clamp(depth_err, max=clamp))
        normals = out["normals"].reshape(-1, 3)
        unit_norm = global_mean(
            (torch.linalg.vector_norm(normals, dim=1) - 1.0) ** 2)
        pts, nrm = out["points"], out["normals"]
        half = pts.shape[1] // 2
        sim = similarity_loss(pts[:, :half].reshape(-1, 3),
                              pts[:, half:2 * half].reshape(-1, 3),
                              nrm[:, :half].reshape(-1, 3),
                              nrm[:, half:2 * half].reshape(-1, 3))
        total = (weights.rgb * rgb_loss + weights.depth * depth_loss +
                 weights.unit_norm * unit_norm + weights.similarity * sim)
        return total, {"rgb_loss": rgb_loss, "depth_loss": depth_loss,
                       "unit_norm_loss": unit_norm, "similarity_loss": sim}

    def joint_step(self, sums: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]], statics,
                   near: float, far: float, window: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """Loss, gradients and the update of one ray batch; returns the
        metric sums with this step's values added."""
        frozen = self.model_opt is None
        total, parts = self.joint_loss(batch, draws, statics, near, far,
                                       window, freeze_model=frozen)
        model_grads, pose_grad = self._grads(total, with_model=not frozen)
        self._apply(model_grads, pose_grad)
        parts["loss"] = total
        return {k: sums[k] + parts[k].detach() for k in self.JOINT_METRICS}

    def supervised_loss(self, surface: torch.Tensor, surface_gt: torch.Tensor,
                        off: torch.Tensor, off_gt: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, parts) of a supervision step: the field at the surface
        points against their snapped targets, and at the off-surface points
        against the directions to their surface points."""
        modules = self.model.modules
        vf_w = modules.vf.folded_weights(detach=False)
        v_surf = modules.vf_apply_folded(vf_w, surface)[:, :3]
        v_off = modules.vf_apply_folded(vf_w, off)[:, :3]
        surf = global_mean((v_surf - surface_gt) ** 2)
        off_loss = global_mean((v_off - off_gt) ** 2)
        w = self.weights
        total = w.supervision * (w.surface * surf +
                                 w.non_surface * off_loss)
        return total, {"surface_loss": surf, "non_surface_loss": off_loss}

    def supervised_step(self, sums: Dict[str, torch.Tensor],
                        arrays: Tuple[torch.Tensor, ...]
                        ) -> Dict[str, torch.Tensor]:
        total, parts = self.supervised_loss(*arrays)
        model_grads, pose_grad = self._grads(total, with_model=True)
        self._apply(model_grads, pose_grad)
        parts["loss"] = total
        return {k: sums[k] + parts[k].detach() for k in self.SUP_METRICS}

    # -------------------------------------------------------------- bases
    def dominant_bases(self) -> np.ndarray:
        """The scene's dominant directions (reference
        ``get_dominant_bases``): with ``self_supervise``, ``kmeans2`` of the
        unit field at 4,096 backprojected surface points; otherwise a
        res-128 marching-cubes mesh of the field, clustered by
        ``utils/geometry.py::get_dominant_bases``."""
        from scipy.cluster.vq import kmeans2
        if not self.config.self_supervise:
            from vf_nerf_torch.evaluation.methods import marching_cubes_mesh
            from vf_nerf_torch.utils.geometry import get_dominant_bases
            mesh_dir = os.path.join(self.run_dir, "joint-mesh")
            marching_cubes_mesh(self.model, 128, mesh_dir, "joint",
                                scale=self.dataset.scale, max_batch=100000,
                                centroid=self.dataset.get_centroid())
            return get_dominant_bases(
                self.config.num_bases, self.config.decimation,
                os.path.join(mesh_dir, "mesh-joint.ply"))
        pts = self._surface_points(4096)
        vf = self.model.get_vector_field(pts).cpu().numpy()
        vf = vf / np.maximum(np.linalg.norm(vf, axis=1, keepdims=True), 1e-8)
        centers, _ = kmeans2(vf.astype(np.float64), self.config.num_bases,
                             minit="++", seed=0)
        norms = np.maximum(np.linalg.norm(centers, axis=1, keepdims=True),
                           1e-8)
        return (centers / norms).astype(np.float32)

    def _surface_points(self, n: int,
                        rng: Optional[np.random.RandomState] = None
                        ) -> np.ndarray:
        """World points of random sensor-depth pixels, ``n // views`` per
        view, through the dataset's poses."""
        rng = rng or np.random.RandomState(0)
        h, w = self.dataset.image_size
        k = self.dataset.intrinsics
        pts = []
        per_view = max(n // len(self.dataset), 1)
        for i in range(len(self.dataset)):
            pix = rng.randint(0, h * w, per_view)
            d = self.dataset.depth_images[i][pix, 0]
            xs, ys = pix % w, pix // w
            x_cam = (xs - k[0, 2]) / k[0, 0] * d
            y_cam = (ys - k[1, 2]) / k[1, 1] * d
            cam = np.stack([x_cam, y_cam, d, np.ones_like(d)], axis=1)
            pts.append((self.dataset.poses[i] @ cam.T).T[:, :3])
        return np.concatenate(pts).astype(np.float32)

    def supervision_batch(self, rng: np.random.RandomState, n: int = 4096
                          ) -> Tuple[torch.Tensor, ...]:
        """(surface points, snapped targets, off-surface points, their
        targets) on the device, the targets snapped against the field as it
        stands; trimmed to a multiple of the rank count and sliced to this
        rank's rows."""
        surface = self._surface_points(n, rng)
        vf = self.model.get_vector_field(surface)
        vf_hat = vf / torch.clamp(torch.linalg.vector_norm(
            vf, dim=1, keepdim=True), min=1e-8)
        snapped = snap_to_bases(vf_hat, self.model.to_device(self._bases))
        t = rng.uniform(0.05, 0.5, (len(surface), 1)).astype(np.float32)
        centroid = self.dataset.get_centroid()
        off = surface + (centroid - surface) * t
        direction = surface - off
        off_gt = direction / np.maximum(
            np.linalg.norm(direction, axis=1, keepdims=True), 1e-8)
        n = trim_to_multiple(len(surface), self.world_size)
        rows = local_ray_slice(n, self.rank, self.world_size)
        return (self.model.to_device(surface[rows]), snapped[rows],
                self.model.to_device(off[rows]),
                self.model.to_device(off_gt[rows].astype(np.float32)))

    # -------------------------------------------------------------- train
    def _feed(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's slice of a host ray batch, trimmed to a multiple of
        the rank count, on the device (pinned, asynchronous on CUDA)."""
        n = trim_to_multiple(len(batch["uv"]), self.world_size)
        rows = local_ray_slice(n, self.rank, self.world_size)
        out = {}
        for k in RAY_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(
                batch[k][:n][rows],
                np.int64 if k == "view_idx" else np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def _zero_sums(self, keys) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), device=self.device) for k in keys}

    def train(self, draws: Optional[Draws] = None) -> Dict[str, float]:
        """Every joint epoch, a save every ``save_frequency`` epochs and at
        the end; returns the last epoch's log."""
        tc = self.config.train_config
        last: Dict[str, float] = {}
        for epoch in range(tc.joint_epochs):
            last = self.train_epoch(epoch, draws)
            if epoch % self.config.save_frequency == 0 and self.rank == 0:
                self.save(epoch)
        if self.rank == 0:
            self.save(tc.joint_epochs - 1)
        return last

    def train_epoch(self, epoch: int, draws: Optional[Draws] = None
                    ) -> Dict[str, float]:
        """One joint epoch: the warm-up boundary, a supervision block when
        due, one joint step per dataset item; logs and returns the epoch's
        means."""
        tc = self.config.train_config
        pose_only = min(max(tc.pose_only_epochs, 0), tc.joint_epochs)
        if epoch == pose_only and pose_only > 0:
            self._make_optimizers(freeze_model=False)
        statics = self.model.render_statics()
        log: Dict[str, float] = {}
        if (self.weights.supervision > 0 and tc.supervise_every > 0
                and epoch >= pose_only and epoch % tc.supervise_every == 0):
            self._bases = broadcast_from_rank0(
                self.dominant_bases() if self.rank == 0 else None)
            batches = [self.supervision_batch(self._rng)
                       for _ in range(tc.supervision_epochs)]
            sup = self._zero_sums(self.SUP_METRICS)
            for arrays in batches:
                sup = self.supervised_step(sup, arrays)
            n_sup = max(len(batches), 1)
            sup_values = torch.stack(list(sup.values()))
            all_reduce_flat([sup_values])
            log.update({f"supervised_{k}": v / n_sup
                        for k, v in zip(sup, sup_values.tolist())})

        window = self.model.to_device(self.model.window_weights)
        near = float(np.float32(self.model.near))
        far = float(np.float32(self.model.far))
        sums = self._zero_sums(self.JOINT_METRICS)
        count, n_rays = 0, 0
        t0 = time.perf_counter()
        for batch in Prefetcher(self.dataset.epoch_batches(self._rng),
                                self._feed, depth=2):
            step_draws = None if draws is None else draws(epoch,
                                                          self.joint_steps)
            sums = self.joint_step(sums, batch, step_draws, statics, near,
                                   far, window)
            n_rays = batch["uv"].shape[0] * self.world_size
            count += 1
            self.joint_steps += 1
        values = torch.stack(list(sums.values()))
        all_reduce_flat([values])
        values = values.tolist()                               # synchronizes
        elapsed = time.perf_counter() - t0
        log.update({k: v / max(count, 1) for k, v in zip(sums, values)})
        log["rays_per_sec"] = count * n_rays / max(elapsed, 1e-9)
        if self.logger is not None:
            self.logger.log(log, step=epoch)
        return log

    def save(self, epoch: int) -> str:
        """The model's checkpoint (``VectorFieldNerf.save``'s layout) with
        the poses."""
        state: Dict[str, Any] = self.model._ckpt_state(epoch)
        state["poses"] = self.poses.detach()
        return ckpt_io.save_checkpoint(self.ckpt_dir, epoch, state)
