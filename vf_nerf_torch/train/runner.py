"""Experiment runner ``VectorFieldNerfRunner`` (port of the per-step path of
``vf_nerf_tpu/train/runner.py:104-289, 308-431, 676-804``; reference
``train/vector_field_nerf_train.py:23-292``).

- Output layout ``<exps_folder>/<expname>/<timestamp>/{checkpoints/vf_nerf,
  vf_nerf.conf, metrics.jsonl, convergence.json}`` with a copy of the conf.
- Resume from ``--timestamp T --checkpoint latest``: the model, optimizer and
  fine-sample count from the file, then the JAX package's arithmetic:
  ``start_epoch = load() + 1`` (so the saved epoch + 2) and the fine count
  grown again by 5 per ``increase_every`` epochs up to ``start_epoch`` on top
  of the restored count (``ROADMAP.md`` §C).
- Each epoch: ``sample_new_images()``, the fine count +5 when ``epoch %
  increase_every == 0`` (up to ``max_samples``), window annealing, one step
  per dataset item, a save every ``save_frequency`` epochs and at the end.
- BatchNorm is frozen when the directional-derivative loss weight is 0, as
  the shipped conf trains; with a nonzero weight the model trains
  (``VectorFieldNerf.train``: batch statistics, unless
  ``numerical_jacobian`` keeps them frozen), every step computes the
  directional derivatives, and static fine growth is off, so each +5 of the
  fine count changes the sample axis. The running statistics are in the
  checkpoints.
- The learning rate decays over ``num_epochs * len(dataset)`` steps.
- Data parallel (``ROADMAP.md`` A.6): one process per device, NCCL on
  CUDA and gloo on the CPU (``exp_runner`` spawns the ranks, or
  ``torchrun`` starts them; the runner joins the group they set up).
  ``num_devices`` 0 means every local device (the CPU is one). Every rank
  builds the same global batch from the shared seed, trims it to a
  multiple of the rank count (the JAX runner's ``_batch_rays``), trains on
  its ``local_ray_slice`` and takes the global step's draws
  (``parallel/train_step.py``); the epoch's metric sums are summed over the
  ranks before its read. Rank 0 alone writes checkpoints, logs and the
  convergence flag; every rank loads the same checkpoint on resume.

On the card a step is a sequence of launches (the shipped conf: 5
fused-MLP, 2 ray-march and 1 ray-march-backward; ``train_step.py`` lists
the other modes'), so the JAX package's scan and span dispatch, which
amortise a TPU's dispatch latency, are not ported and ``steps_per_dispatch``
is not read. Batches are assembled, packed and copied to the device (from
pinned memory, without blocking) one step ahead in a worker thread. The
metric sums stay on the device; at each epoch's end they and the density
scalars are copied to pinned host memory behind an event, and that epoch is
logged after the next epoch's steps are enqueued, so the device never
waits for the host's read. ``rays_per_sec`` is the wall time between
consecutive epoch-end reads.

Random draws: each step draws from the facade's ``torch.Generator``, unless
``train_epoch(epoch, draws=...)`` gets a callable ``(epoch, step) → draws``
(``step`` is the optimizer's count before the step), which the parity tests
use to pass JAX's draws.
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vf_nerf_torch.config.parser import config_device
from vf_nerf_torch.config.schema import VFRunnerConfig, asdict_config
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.models.nerf import VectorFieldNerf, param_groups
from vf_nerf_torch.parallel.mesh import all_reduce_flat, trim_to_multiple
from vf_nerf_torch.parallel.multihost import (broadcast_from_rank0,
                                              check_world, local_device,
                                              local_ray_slice)
from vf_nerf_torch.parallel.train_step import (METRIC_KEYS,
                                               SupervisionStatics,
                                               make_train_step, pack_batch,
                                               zero_metric_sums)
from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils.logging import MetricsLogger
from vf_nerf_torch.utils.prefetch import Prefetcher
from vf_nerf_torch.utils.profiling import maybe_enable_nan_debugging, span
from vf_nerf_torch.utils.weights import load_reference_net

DENSITY_KEYS = ("beta", "scale", "mean")
Draws = Callable[[int, int], Dict[str, torch.Tensor]]


def run_seed() -> int:
    """The reference pins seed 42; ``VFNERF_SEED`` overrides it for
    run-to-run variance studies."""
    return int(os.environ.get("VFNERF_SEED", "42"))


def _assembled(batches):
    """``batches`` with each batch's assembly recorded as a span."""
    it = iter(batches)
    while True:
        with span("feed.assemble"):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


class VectorFieldNerfRunner:
    def __init__(self, config: VFRunnerConfig, device=None) -> None:
        self.config = config
        self.seed = run_seed()
        np.random.seed(self.seed)
        self.rank, self.world_size = check_world(
            config.vf_nerf_config.device_config.num_devices)
        if device is None:
            device = config_device(config) if self.world_size == 1 \
                else local_device(config_device(config))

        self.dataset = dataset_dict[config.dataset_config.dataset_name](
            config.dataset_config)
        decay_steps = config.num_epochs * len(self.dataset)
        config.vf_nerf_config.scheduler_config.lr_decay_steps = decay_steps
        self.model = VectorFieldNerf(config.vf_nerf_config, seed=self.seed,
                                     device=device, decay_steps=decay_steps)
        self.device = self.model.device
        self.model.near, self.model.far = self.dataset.get_bounds()

        self.init_method, init_path = self.dataset.get_vf_init_method()
        self._load_vf_init(init_path)

        self.create_output_folders()
        self.load_model()

        # The reference trains with BatchNorm frozen unless the
        # directional-derivative loss is on (trainer :140-141).
        self.train_dir_derivatives = \
            config.vf_loss_weights.directional_derivatives != 0.0
        if self.train_dir_derivatives:
            self.model.train()
        else:
            self.model.eval()

        self.logger = MetricsLogger(
            run_dir=self.run_dir, project=config.wandb_project,
            run_name=config.expname, run_id=config.timestamp,
            config=asdict_config(config), offline=config.offline) \
            if self.rank == 0 else None
        self._step_cache: Dict[Any, Callable] = {}
        self._epoch_rng = np.random.RandomState(self.seed)
        self._pending_log: Optional[Dict[str, Any]] = None
        # The host clock at the previous epoch-end read.
        self._last_read = time.perf_counter()
        self.final_loss: Optional[float] = None
        maybe_enable_nan_debugging()

    # ------------------------------------------------------------- folders
    def create_output_folders(self) -> None:
        """Reference ``create_output_folders`` (``:79-113``); the ranks
        share rank 0's timestamp."""
        cfg = self.config
        if cfg.timestamp == "":
            cfg.timestamp = broadcast_from_rank0(io_utils.get_timestamp())
        self.run_dir = os.path.join(cfg.exps_folder, cfg.expname,
                                    cfg.timestamp)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints", "vf_nerf")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        conf_copy = os.path.join(self.run_dir, "vf_nerf.conf")
        if self.rank == 0 and not os.path.exists(conf_copy) and \
                os.path.exists(cfg.config_path):
            shutil.copy2(cfg.config_path, conf_copy)

    # -------------------------------------------------------------- resume
    def load_model(self) -> None:
        """Reference ``load_model`` (``:115-134``), with the JAX package's
        resume arithmetic (module docstring)."""
        cfg = self.config
        if cfg.checkpoint == "":
            return
        path = os.path.join(self.ckpt_dir, f"{cfg.checkpoint}.ckpt")
        if not os.path.exists(path):
            raise FileExistsError(f"Checkpoint path: {path} does not exist.")
        cfg.start_epoch = self.model.load(path) + 1
        rs = cfg.vf_nerf_config.ray_sampler_config
        if rs.fine_sampling():
            self.model.fine_n_samples = min(
                self.model.fine_n_samples +
                5 * (cfg.start_epoch // rs.increase_every),
                rs.max_samples)
        self._say(f"Loaded model from {cfg.checkpoint}")

    def _load_vf_init(self, init_path: str) -> None:
        """VF-init weights: the ``.pkl`` beside ``init_path`` (written by
        ``train/vf_init.py`` of either package), else a reference ``.pth``
        state dict of the VF net, else the seeded init with a warning (the
        reference's own init files are LFS pointer stubs)."""
        pkl_path = os.path.splitext(init_path)[0] + ".pkl" if init_path \
            else ""
        if pkl_path and os.path.exists(pkl_path):
            self.model.load_vf_init(pkl_path)
        elif init_path and os.path.exists(init_path) and \
                os.path.getsize(init_path) > 1024:
            blob = torch.load(init_path, map_location="cpu", weights_only=True)
            load_reference_net(self.model.modules.vf,
                               blob.get("vf_net", blob), init_path)
            self.model.optimizer.init(param_groups(self.model.modules))
        else:
            self._say(f"WARNING: VF init weights not found at "
                      f"{init_path!r}; starting from the seeded init. Run "
                      "`python -m vf_nerf_torch.train.vf_init` to fit them.")

    def _say(self, what: str) -> None:
        """Print on rank 0."""
        if self.rank == 0:
            print(what)

    # ---------------------------------------------------------------- step
    def _static_fine(self) -> bool:
        """Static fine growth: the fine axis padded to ``max_samples`` with
        the live count passed to each step (``static_fine_growth``)."""
        rs = self.config.vf_nerf_config.ray_sampler_config
        return (self.config.vf_nerf_config.device_config.static_fine_growth
                and rs.fine_sampling() and not self.train_dir_derivatives)

    def _step_statics(self):
        """(RenderStatics, SupervisionStatics) of the current fine count, or
        of the padded count with static fine growth."""
        n_fine = self.config.vf_nerf_config.ray_sampler_config.max_samples \
            if self._static_fine() else None
        statics = self.model.render_statics(
            n_fine=n_fine, compute_dir_derivatives=self.train_dir_derivatives)
        sup = SupervisionStatics.from_config(
            self.config.vf_nerf_config, self.init_method,
            n_rays=self._batch_rays(),
            n_samples=statics.n_coarse + statics.n_fine,
            border_radius=self.config.dataset_config.border_radius)
        return statics, sup

    def _fine_active_arg(self) -> Dict[str, int]:
        """The live fine count with static fine growth, else nothing."""
        if not self._static_fine():
            return {}
        return {"n_fine_active": self.model.fine_n_samples}

    def _get_step(self) -> Callable:
        """One ``make_train_step`` per statics (and optimizer object)."""
        statics, sup = self._step_statics()
        key = (statics, sup, id(self.model.optimizer))
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.model.modules, self.model.optimizer, statics, sup,
                self.config.vf_loss_weights, self.config.vf_loss_config,
                remat=self._remat())
        return self._step_cache[key]

    def _remat(self) -> str:
        """The ``train_remat`` device knob ("none", "full" or "dots")."""
        return self.config.vf_nerf_config.device_config.train_remat

    def _batch_rays(self) -> int:
        """The global batch: the dataset's rays trimmed to a multiple of
        the rank count."""
        return trim_to_multiple(self.dataset.total_pixels, self.world_size)

    def _feed(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """This rank's slice of one packed (R, 38) global batch on the
        device."""
        n = self._batch_rays()
        with span("feed.pack"):
            packed = torch.from_numpy(pack_batch(
                {k: v[:n] for k, v in batch.items() if v.size > 0}))
            packed = packed[local_ray_slice(n, self.rank, self.world_size)]
        with span("feed.copy"):
            if self.device.type != "cuda":
                return packed.to(self.device)
            return packed.pin_memory().to(self.device, non_blocking=True)

    # --------------------------------------------------------------- train
    def train(self, draws: Optional[Draws] = None) -> None:
        """Reference ``train`` (``:136-159``)."""
        cfg = self.config
        rs = cfg.vf_nerf_config.ray_sampler_config
        try:
            for epoch in range(cfg.start_epoch, cfg.num_epochs):
                self.dataset.sample_new_images()
                if rs.fine_sampling() and epoch % rs.increase_every == 0:
                    self.model.fine_n_samples = min(
                        self.model.fine_n_samples + 5, rs.max_samples)
                logged = self.train_epoch(epoch, draws=draws)
                if epoch % cfg.save_frequency == 0:
                    self._save(epoch)
                if logged is not None:
                    self._say(f"Epoch {logged[0]}: Loss {logged[1]}")
        finally:
            # The last epoch's log, even after a failure.
            final = self._resolve_pending_log()
            if final is not None:
                self._say(f"Epoch {final[0]}: Loss {final[1]}")
        cfg.start_epoch = cfg.num_epochs + 1
        self._save(cfg.num_epochs - 1)
        if self.rank == 0:
            self._write_convergence_flag()

    def _save(self, epoch: int) -> None:
        """A checkpoint, written by rank 0."""
        if self.rank == 0:
            self.model.save(epoch, self.ckpt_dir)

    def train_epoch(self, epoch: int, draws: Optional[Draws] = None
                    ) -> Optional[Tuple[int, float]]:
        """One step per dataset item (reference ``train_epoch``,
        ``:161-292``). Logs the previous epoch and returns its (epoch, loss),
        or None; this epoch is logged by the next call or by ``train``."""
        with span("train.epoch_start"):
            window = self.model.update_annealing(epoch)
            # Through pinned memory: a copy from pageable memory would wait
            # for the previous epoch's steps.
            window_t = self.model.to_device(window)
            centroid = self.model.to_device(self.dataset.get_centroid())
            # As float32, as the JAX step takes them.
            near = float(np.float32(self.model.near))
            far = float(np.float32(self.model.far))
            step = self._get_step()
            fine = self._fine_active_arg()
            sums = zero_metric_sums(self.device)
            count = 0
            if self._pending_log is None:
                # The first epoch of a run is timed from its start.
                self._last_read = time.perf_counter()
            batches = Prefetcher(
                _assembled(self.dataset.epoch_batches(self._epoch_rng)),
                self._feed, depth=2, wait_span="train.feed_wait")
        for fed in batches:
            step_draws = None if draws is None else draws(epoch,
                                                          self.model.step)
            sums = step(sums, fed, epoch, window_t, near, far, centroid,
                        draws=step_draws, generator=self.model.generator,
                        **fine)
            count += 1

        with span("train.epoch_read"):
            # The epoch's numbers in one copy to pinned host memory, read
            # after the next epoch's steps are enqueued; the metric sums
            # summed over the ranks first.
            metrics = torch.stack([sums[k] for k in METRIC_KEYS])
            all_reduce_flat([metrics])
            density = self.model.density_scalar_tensors()
            values = torch.cat([metrics, torch.stack([density[k]
                                                      for k in DENSITY_KEYS])])
            host = torch.empty(values.shape, dtype=values.dtype,
                               pin_memory=self.device.type == "cuda")
            host.copy_(values, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            pending = {"epoch": epoch, "count": count, "window": window,
                       "host": host, "event": event,
                       "step": self.model.step}
            logged = self._log_pending()
        self._pending_log = pending
        return logged

    def _resolve_pending_log(self) -> Optional[Tuple[int, float]]:
        """Log the stashed epoch; returns its (epoch, loss) or None."""
        with span("train.epoch_read"):
            return self._log_pending()

    def _log_pending(self) -> Optional[Tuple[int, float]]:
        """``_resolve_pending_log`` inside a span already open."""
        pending, self._pending_log = self._pending_log, None
        if pending is None:
            return None
        if pending["event"] is not None:
            pending["event"].synchronize()
        values = pending["host"].tolist()
        count = max(pending["count"], 1)
        n_metrics = len(METRIC_KEYS)
        averages = {k: v / count
                    for k, v in zip(METRIC_KEYS, values[:n_metrics])}
        averages.update(zip(DENSITY_KEYS, values[n_metrics:]))
        averages["learning_rate"] = self.model.host_lr(pending["step"])
        averages.update({f"w_{i}": float(w)
                         for i, w in enumerate(pending["window"])})
        now = time.perf_counter()
        averages["rays_per_sec"] = (pending["count"] * self._batch_rays() /
                                    (now - self._last_read))
        self._last_read = now
        if self.logger is not None:
            self.logger.log(averages, step=pending["epoch"])
        self.final_loss = averages["loss"]
        return pending["epoch"], averages["loss"]

    def _write_convergence_flag(self) -> None:
        """``<run_dir>/convergence.json``: the final train loss against
        ``convergence_loss_threshold`` (0 disables it); a non-finite loss is
        flagged as diverged. NaN is written as null."""
        thr = self.config.convergence_loss_threshold
        loss = self.final_loss
        diverged = loss is not None and not math.isfinite(loss)
        flagged = bool(diverged or (thr and loss is not None
                                    and not loss <= thr))
        payload = {"final_loss": None if diverged else loss,
                   "diverged": diverged,
                   "threshold": thr if thr else None,
                   "flagged": flagged}
        if flagged:
            payload["recommendation"] = (
                ("final train loss is non-finite — the run diverged"
                 if diverged else
                 "final train loss exceeds the convergence threshold") +
                " — likely a bad seed; re-run with another VFNERF_SEED")
            print(f"WARNING: non-convergence gate: final loss {loss}, "
                  f"threshold {thr}; recommend re-seeding (VFNERF_SEED)",
                  flush=True)
        io_utils.write_json(os.path.join(self.run_dir, "convergence.json"),
                            payload)
