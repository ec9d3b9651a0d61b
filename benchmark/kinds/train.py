"""Training traffic: ``VectorFieldNerfRunner.train_epoch``, epoch after epoch,
as the runner runs it (a closed loop, one client).

Set-up builds one runner on the office scene with the benchmark's weights,
sets the fine count and runs the warm-up epochs through ``train_epoch``;
the first ``checked_steps`` steps of the first one are the steps the
reference follows (their batch, the generator state they drew from, each
loss, the optimizer's first moments after the first step and the
parameters after the last). The window is whole epochs after the warm-up,
closed by a synchronize with the last epoch's read resolved.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, trace
from benchmark.harness import Run, RunError, sub_seed


class Driver:
    def __init__(self, run: Run) -> None:
        self.run = run
        self.cell = run.cell
        self.conf = run.cell.conf
        self.traffic = run.cell.traffic
        self.attempted = 0
        self.failed = 0
        self.epoch = self.traffic["epoch"]

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from vf_nerf_torch.train.runner import VectorFieldNerfRunner
        run, t = self.run, self.traffic
        os.environ["VFNERF_SEED"] = str(sub_seed(run.seed, "runner"))
        self.logs = program.tmp_dir("train")
        cfg = program.program_config(self.conf, self.logs, run.device.type)
        runner = VectorFieldNerfRunner(cfg, device=run.device)
        ds = program.office(t["scene"], sub_seed(run.seed, "scene"),
                            t["pixels_per_batch"], shuffle_views=True)
        runner.dataset = ds
        runner.model.near, runner.model.far = ds.get_bounds()
        runner.model.fine_n_samples = t["fine_count"]
        self.scene = program.scene_arrays(ds, run.device)
        self.weights = program.make_weights(
            self.conf, sub_seed(run.seed, "weights"), run.device,
            t["vf_gain"])
        program.calibrate_batch_norm(self.conf, self.weights, self.scene,
                                     sub_seed(run.seed, "calibration"))
        program.load_weights(runner.model.modules, self.weights)
        self.runner = runner
        self.rays_per_step = runner._batch_rays()
        self.steps_per_epoch = len(ds)
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        self.captured = self._capture(t["checked_steps"])
        for _ in range(t["warmup_epochs"]):
            self._epoch()
        self._close()
        del runner._get_step         # back to the runner's own method

    def _capture(self, n: int) -> Dict[str, List]:
        """Wrap the runner's step so that its first ``n`` calls keep what
        the reference needs."""
        runner = self.runner
        own = runner._get_step
        got: Dict[str, List] = {"fed": [], "state": [], "loss": [],
                                "args": []}

        def get_step():
            step = own()

            def checked(sums, fed, epoch, window, near, far, centroid,
                        **kw):
                i = len(got["fed"])
                if i >= n:
                    return step(sums, fed, epoch, window, near, far,
                                centroid, **kw)
                got["fed"].append(fed.clone())
                got["state"].append(kw["generator"].get_state())
                got["args"].append((epoch, near, far))
                before = sums["loss"].clone()
                out = step(sums, fed, epoch, window, near, far, centroid,
                           **kw)
                got["loss"].append((before, out["loss"].clone()))
                opt = runner.model.optimizer
                if i == 0:
                    got["mu"] = {k: [m.clone() for m in v]
                                 for k, v in opt.mu.items()}
                if i == n - 1:
                    got["after"] = self._state()
                return out
            return checked

        runner._get_step = get_step
        return got

    def _state(self) -> Dict[str, torch.Tensor]:
        """The program's parameters and running statistics by name."""
        mods = self.runner.model.modules
        out = {}
        for net in ("vf", "render", "density"):
            for k, v in getattr(mods, net).state_dict().items():
                if not k.endswith("num_batches_tracked"):
                    out[f"{net}.{k}"] = v.detach().clone()
        return out

    def _epoch(self) -> int:
        self.runner.dataset.sample_new_images()
        self.runner.train_epoch(self.epoch)
        self.epoch += 1
        return self.steps_per_epoch

    def _close(self) -> None:
        self.runner._resolve_pending_log()
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    # ---------------------------------------------------------------- window
    def window(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < self.run.seconds:
            steps += self._epoch()
        self._close()
        seconds = time.perf_counter() - t0
        self.attempted = steps
        rate = steps * self.rays_per_step / seconds
        self.run.log(f"window: {steps} steps in {seconds!r} s, "
                     f"{rate!r} rays/s")
        return {"train_rays_per_s": rate}

    def traced(self) -> trace.Traced:
        """The traced sub-window: whole epochs until ``trace_seconds`` have
        passed."""
        def body():
            steps, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < self.traffic["trace_seconds"]:
                steps += self._epoch()
            self._close()
            return steps
        work = self.cell.hooks.work(self.conf, self.traffic)
        traced = trace.profile(body, "step", work)
        self.attempted = traced.units
        self.run.log(f"traced window: {traced.units} steps in "
                     f"{traced.window_s!r} s, "
                     f"{traced.units * self.rays_per_step / traced.window_s!r}"
                     f" rays/s, busy {traced.busy_s!r} s")
        return traced

    def memory_peak(self) -> int:
        if self.run.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.run.device)
        self.run.log(f"memory_peak_bytes {peak}")
        return peak

    def release(self) -> None:
        self.runner = None
        shutil.rmtree(self.logs, ignore_errors=True)

    # ----------------------------------------------------------------- check
    def program_readings(self) -> dict:
        """The checked steps as the program took them: each loss, the first
        gradient as the optimizer got it (its first moment over 1 − β1, over
        (1 − β1)(1 + β1) for a group that took two Adam sub-steps) and the
        parameters after the last checked step."""
        got = self.captured
        if len(got["loss"]) < self.traffic["checked_steps"]:
            raise RunError("fewer steps than the checked ones ran")
        losses = [float(a.double() - b.double()) for b, a in got["loss"]]
        twice = self.conf["ray_sampler"]["n_importance"] > 0
        names = program.weight_names(self.conf)
        trainable = [n for n in names if "running_" not in n]
        grads = {}
        flat = {k: iter(v) for k, v in got["mu"].items()}
        # The optimizer's groups hold the nets' parameters in module order.
        for n in trainable:
            group = n.split(".", 1)[0]
            div = 0.19 if (twice and group == "vf") else 0.1
            grads[n] = next(flat[group]) / div
        return {"losses": losses, "grads": grads, "after": got["after"]}

    def reference_readings(self, tf32: bool = False) -> dict:
        """The plain reference over the same first steps from the same
        weights."""
        ref = self.cell.hooks.reference
        conf, t, dev = self.conf, self.traffic, self.run.device
        model = ref.Model(conf)
        p = {k: v.clone() for k, v in self.weights.items()}
        names = ref.trainable(p)
        adam = ref.Adam(conf, conf["train"]["num_epochs"] *
                        t["scene"]["n_views"], names)
        rs = conf["ray_sampler"]
        padded = rs["max_samples"] if program.static_padding(conf) \
            else t["fine_count"]
        n_c = rs["n_samples"]
        bn = program.train_bn(conf)
        losses, first, off = [], None, 0
        with ref.precision(tf32):
            for fed, state, (epoch, _, _) in zip(self.captured["fed"],
                                                 self.captured["state"],
                                                 self.captured["args"]):
                batch, bad = program.rays_from_scene(fed, self.scene)
                off += bad
                r = fed.shape[0]
                gen = torch.Generator(device=dev)
                gen.set_state(state)
                draws = ref.replay_uniforms(gen, r, n_c, padded,
                                            rs["perturb"], dev)
                drawn = (r * (n_c + padded)) // 10
                live = (r * (n_c + t["fine_count"])) // 10
                shell = [tuple(x[:live] for x in ref.shell_draw(gen, drawn,
                                                                dev))
                         for _ in range(2)]
                leaves = {n: p[n].detach().requires_grad_() for n in names}
                stats = {} if bn else None
                total = ref.loss(model, {**p, **leaves}, batch,
                                 self.scene["near"], self.scene["far"],
                                 draws, shell, t["fine_count"], epoch,
                                 conf["dataset"]["border_radius"], bn, stats)
                g = torch.autograd.grad(total, [leaves[n] for n in names])
                clipped = adam.step(p, dict(zip(names, g)))
                if bn:
                    ref.keep_running_stats(p, stats)
                losses.append(float(total.detach()))
                if first is None:
                    first = clipped
                del leaves, total, g
        return {"losses": losses, "grads": first, "after": p,
                "batch_rows_off": off}

    def check(self) -> Dict[str, float]:
        prog = self.program_readings()
        ref = self.reference_readings()
        numbers = compare(prog, ref, self.weights, self.run.log)
        numbers["batch_rows_off"] = float(ref["batch_rows_off"])
        return numbers


def compare(prog: dict, ref: dict, start: Dict[str, torch.Tensor],
            log=None) -> Dict[str, float]:
    """The numbers compared:

    - ``loss_gap``: the first step's loss, relative gap;
    - ``grad_gap``: by the worst leaf, |‖g‖ − ‖g_ref‖| over the larger of
      ‖g_ref‖ and the median leaf's ‖g_ref‖, for the first step's clipped
      gradient;
    - ``change_gap``: the median leaf's gap of the change over the checked
      steps, |‖Δ‖ − ‖Δ_ref‖| over the larger of ‖Δ_ref‖ and the median
      ‖Δ_ref‖;
    - ``stats_gap``: the worst running statistic's change, relative (0 where
      neither side moved it, 1 where only the program did).

    The later steps' losses and the worst leaf's change are printed beside
    them, not compared: Adam's first steps move every weight by about the
    learning rate whatever its gradient's size, so a weight whose gradient
    is rounding noise moves either way, and from the second step on the
    two sides run from different weights. Leaves whose reference gradient
    is under a thousandth of the median leaf's are nought to rounding (a
    bias before a BatchNorm on batch statistics) and are left out.
    """
    losses = np.array(prog["losses"])
    ref_losses = np.array(ref["losses"])
    steps_gap = np.abs(losses - ref_losses) / np.abs(ref_losses)
    g_ref = {n: float(v.double().norm()) for n, v in ref["grads"].items()}
    median = float(np.median(list(g_ref.values())))
    kept = [n for n in g_ref if g_ref[n] >= 1e-3 * median]
    grad = {n: abs(float(prog["grads"][n].double().norm()) - g_ref[n]) /
            max(g_ref[n], median) for n in kept}

    def moved(after, n):
        return float((after[n].double() - start[n].double()).norm())

    d_ref = {n: moved(ref["after"], n) for n in kept}
    med_d = float(np.median(list(d_ref.values())))
    change = {n: abs(moved(prog["after"], n) - d_ref[n]) /
              max(d_ref[n], med_d) for n in kept}
    stats = {}
    for n in prog["after"]:
        if "running_" in n:
            dp, dr = moved(prog["after"], n), moved(ref["after"], n)
            stats[n] = abs(dp - dr) / dr if dr > 0 else float(dp > 0)
    if log is not None:
        worst = max(grad, key=grad.get)
        log(f"loss gap by step {steps_gap.tolist()}; worst gradient leaf "
            f"{worst} {grad[worst]!r}; worst leaf change "
            f"{max(change.values())!r}; leaves left out "
            f"{sorted(set(g_ref) - set(kept))}")
    return {"loss_gap": float(steps_gap[0]),
            "grad_gap": max(grad.values()),
            "change_gap": float(np.median(list(change.values()))),
            "stats_gap": max(stats.values(), default=0.0)}
