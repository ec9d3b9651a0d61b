"""Joint-stage traffic: ``JointOptimizationRunner.train_epoch``, joint epoch
after joint epoch from epoch 0, as ``train/joint_exp_runner.py`` runs the
stage (a closed loop, one client).

Set-up builds the runner on the office scene (the constructor's
``dataset``) in the state the main stage leaves at
``initial_training_epochs``: the benchmark's weights with BatchNorm
calibrated, the traffic's fine count, the window annealed. Each view's pose
is its ground truth perturbed from the seed by a rotation of exactly
``perturb_degrees`` about a uniform axis and a translation of norm
``perturb_translation``; the supervision block backprojects through the
ground truth, as the program does. The render's uniforms come from a
generator seeded by the run, through ``train_epoch(epoch, draws=...)``.
Warm-up: joint epoch 0 with its supervision block. Checked: the block's
supervised steps (their points and targets, the bases, the first step's
loss and gradients) and the epoch's first ``checked_steps`` joint steps
(their batch, draws and render outputs, the first step's loss and
gradients, the poses and the field after the last), read from the runner's
``last_step`` record: on the card the first step runs eagerly, the second
is captured as a CUDA graph and replayed, the third replayed, as every
timed step; the reference takes the program's discrete choices from them
(``plain/joint.py``). The window:
whole epochs from epoch 1, closed by a synchronize; the traced window:
``trace_epochs`` whole epochs, which hold one supervision block.
"""

from __future__ import annotations

import inspect
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import program, trace
from benchmark.harness import Run, RunError, sub_seed

UNIT = "joint_step"


def perturbed_pose7(poses: np.ndarray, seed: int, degrees: float,
                    translation: float) -> np.ndarray:
    """(V, 7) ``[qw, qx, qy, qz, t]`` of each (4, 4) camera-to-world pose
    composed with a rotation of ``degrees`` about an axis uniform on the
    sphere, and its centre moved by ``translation`` in a uniform
    direction."""
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(seed)
    out = np.asarray(poses, np.float64).copy()
    angle = np.deg2rad(degrees)
    for pose in out:
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        pose[:3, :3] = pose[:3, :3] @ (np.eye(3) + np.sin(angle) * k +
                                       (1.0 - np.cos(angle)) * (k @ k))
        move = rng.normal(size=3)
        pose[:3, 3] += move / np.linalg.norm(move) * translation
    xyzw = Rotation.from_matrix(out[:, :3, :3]).as_quat()
    return np.concatenate([xyzw[:, 3:], xyzw[:, :3], out[:, :3, 3]],
                          1).astype(np.float32)


def joint_config(conf: dict, exps_folder: str, device: str):
    """The program's joint-stage config: the VF runner's from the conf's
    sections (``program.program_config``), its ``supervised_loss_weights``,
    and the joint conf's ``train`` and ``joint_optimization`` sections, as
    ``config/joint_parser.py`` assembles them."""
    from vf_nerf_torch.config.joint_schema import (JointOptimizationConfig,
                                                   TrainConfig)
    from vf_nerf_torch.config.schema import VFSupervisedLossWeights
    vf_cfg = program.program_config(conf, exps_folder, device)
    vf_cfg.supervised_loss_weights = VFSupervisedLossWeights(
        **conf["supervised_loss_weights"])
    j = conf["joint"]
    cfg = JointOptimizationConfig(vf_cfg, TrainConfig(**j["train"]),
                                  **j["joint_optimization"])
    vf_cfg.num_epochs = cfg.train_config.supervised_vf_epochs
    return cfg


def named_leaves(runner) -> List[Tuple[str, torch.Tensor]]:
    """The stage's trainable tensors by the benchmark's names: the field's
    parameters (``vf.``, ``render.``, ``density.``) and ``poses``."""
    mods = runner.model.modules
    out = [(f"{net}.{k}", prm) for net in ("vf", "render", "density")
           for k, prm in getattr(mods, net).named_parameters()]
    return out + [("poses", runner.poses)]


class Driver:
    def __init__(self, run: Run) -> None:
        self.run = run
        self.cell = run.cell
        self.conf = run.cell.conf
        self.traffic = run.cell.traffic
        self.attempted = 0
        self.failed = 0
        self.epoch = 0

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from vf_nerf_torch.train.joint_runner import JointOptimizationRunner
        if "dataset" not in inspect.signature(
                JointOptimizationRunner).parameters:
            raise RunError("the program's JointOptimizationRunner takes no "
                           "dataset")
        run, t, conf = self.run, self.traffic, self.conf
        self.logs = program.tmp_dir("joint")
        cfg = joint_config(conf, self.logs, run.device.type)
        ds = program.office(t["scene"], sub_seed(run.seed, "scene"),
                            t["pixels_per_batch"], shuffle_views=True)
        runner = JointOptimizationRunner(cfg, device=run.device, dataset=ds)
        runner.model.fine_n_samples = t["fine_count"]
        runner.model.update_annealing(
            conf["joint"]["train"]["initial_training_epochs"])
        self.scene = program.scene_arrays(ds, run.device)
        self.scene["centroid"] = torch.as_tensor(
            np.asarray(ds.get_centroid(), np.float32)).to(run.device)
        self.weights = program.make_weights(
            conf, sub_seed(run.seed, "weights"), run.device, t["vf_gain"])
        program.calibrate_batch_norm(conf, self.weights, self.scene,
                                     sub_seed(run.seed, "calibration"))
        program.load_weights(runner.model.modules, self.weights)
        self.start_poses = perturbed_pose7(
            ds.poses, sub_seed(run.seed, "poses"), t["perturb_degrees"],
            t["perturb_translation"])
        runner.pose_params = self.start_poses
        self.runner = runner
        self.joint_epochs = cfg.train_config.joint_epochs
        self.steps_per_epoch = len(ds)
        self.rays_per_step = len(ds) * (t["pixels_per_batch"] // len(ds))
        gen = torch.Generator(device=run.device).manual_seed(
            sub_seed(run.seed, "draws"))
        n_c = conf["ray_sampler"]["n_samples"]

        def draws(epoch: int, step: int) -> Dict[str, torch.Tensor]:
            def rand(n):
                return torch.rand((self.rays_per_step, n), generator=gen,
                                  device=run.device)
            return {"t_coarse": rand(n_c), "t_fine": rand(t["fine_count"]),
                    "u_extra": rand(t["fine_count"])}
        self.draws = draws
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        self.captured = self._capture(t["checked_steps"])
        for _ in range(t["warmup_epochs"]):
            self._epoch()
        self._close()
        for name in ("joint_step", "supervised_step", "dominant_bases"):
            delattr(runner, name)        # back to the runner's own methods

    def _capture(self, n: int) -> dict:
        """Wrap the runner's steps so that the first supervision block and
        the first ``n`` joint steps keep what the reference needs, read
        from each step's ``last_step`` record as the step left it (its
        loss parts, its gradients, the joint steps' render outputs)."""
        runner = self.runner
        own_joint, own_sup = runner.joint_step, runner.supervised_step
        own_bases = runner.dominant_bases
        names = {id(prm): name for name, prm in named_leaves(runner)}
        got: dict = {"joint": [], "sup": [], "bases": None}

        def kept(rec: dict, grads: bool) -> None:
            """The step's loss parts (and gradients, by the benchmark's
            names) from the runner's record."""
            step = runner.last_step
            rec["loss"] = {k: float(v.double())
                           for k, v in step["parts"].items()}
            if grads:
                rec["grads"] = {names[id(prm)]: g.detach().clone()
                                for prm, g in step["grads"]}

        def dominant_bases():
            bases = own_bases()
            if got["bases"] is None:
                got["bases"] = np.array(bases)
            return bases

        def supervised_step(sums, arrays):
            if got["joint"]:             # the warm-up's block is over
                return own_sup(sums, arrays)
            rec = {"arrays": tuple(a.clone() for a in arrays)}
            out = own_sup(sums, arrays)
            kept(rec, grads=not got["sup"])
            got["sup"].append(rec)
            return out

        def joint_step(sums, batch, draws, statics, near, far, window):
            if len(got["joint"]) >= n:
                return own_joint(sums, batch, draws, statics, near, far,
                                 window)
            rec = {"batch": {k: v.clone() for k, v in batch.items()},
                   "draws": tuple(draws[k].clone() for k in
                                  ("t_coarse", "t_fine", "u_extra")),
                   "near": near, "far": far}
            out = own_joint(sums, batch, draws, statics, near, far, window)
            kept(rec, grads=not got["joint"])
            rec["render"] = {key: v.detach().clone() for key, v in
                             runner.last_step["render"].items()}
            got["joint"].append(rec)
            if len(got["joint"]) == n:
                got["after"] = self._state()
            return out

        runner.joint_step = joint_step
        runner.supervised_step = supervised_step
        runner.dominant_bases = dominant_bases
        return got

    def _state(self) -> Dict[str, torch.Tensor]:
        """The program's trainable tensors by name."""
        return {n: p.detach().clone() for n, p in named_leaves(self.runner)}

    def _epoch(self) -> int:
        self.runner.train_epoch(self.epoch % self.joint_epochs, self.draws)
        self.epoch += 1
        return self.steps_per_epoch

    def _close(self) -> None:
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
        self.run.log(f"window: {steps} joint steps in {seconds!r} s, "
                     f"{rate!r} rays/s")
        return {"train_rays_per_s": rate}

    def traced(self) -> trace.Traced:
        """The traced sub-window: ``trace_epochs`` whole epochs."""
        def body():
            steps = sum(self._epoch()
                        for _ in range(self.traffic["trace_epochs"]))
            self._close()
            return steps
        work = self.cell.hooks.work(self.conf, self.traffic)
        traced = trace.profile(body, UNIT, work)
        self.attempted = traced.units
        self.run.log(f"traced window: {traced.units} joint steps in "
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
        """The checked steps as the program took them: the first
        supervised step's and the first joint step's losses and gradients,
        and the state after the last checked joint step."""
        got = self.captured
        if len(got["joint"]) < self.traffic["checked_steps"] or \
                not got["sup"] or got["bases"] is None:
            raise RunError("fewer steps than the checked ones ran")
        return {"sup_loss": got["sup"][0]["loss"],
                "sup_grads": got["sup"][0]["grads"],
                "loss": got["joint"][0]["loss"],
                "grads": got["joint"][0]["grads"],
                "after": got["after"]}

    def program_choices(self) -> dict:
        """The program's discrete choices in the checked steps, read from
        its outputs: each supervision batch's targets, each joint step's
        fine windows (the coarse argmax) and similarity gate (the
        reference's rule on the program's fine points and fields)."""
        ref = self.cell.hooks.reference
        got = self.captured
        gates = []
        for rec in got["joint"]:
            out = rec["render"]
            miss, cos = ref.pair_terms(*ref.halves(out["points"],
                                                   out["normals"]))
            gates.append(ref.gate_of(miss, cos))
        return {"snap": [rec["arrays"][1] for rec in got["sup"]],
                "window": [rec["render"]["argmax_coarse"]
                           for rec in got["joint"]],
                "gate": gates}

    def reference_readings(self, tf32: bool = False,
                           theirs: Optional[dict] = None) -> dict:
        """The plain reference over the same block and joint steps from the
        same weights, poses, points, batches and draws, on ``theirs``
        discrete choices (``program_choices``' form) or its own. Returns the
        readings, the ``choices`` it took, ``choices_off``, the share (%)
        of ``theirs`` windows and targets that are no near maximum in its
        own arithmetic, and ``gate_off``, the share (%) of the gates' pairs
        on which ``theirs`` gate and its own gate on its own points disagree
        beyond rounding's reach (``plain/joint.py::gate_choice``)."""
        ref = self.cell.hooks.reference
        conf, t, dev = self.conf, self.traffic, self.run.device
        got = self.captured
        model = ref.Model(conf)
        p = {k: v.clone() for k, v in self.weights.items()}
        p["poses"] = torch.as_tensor(self.start_poses).to(dev)
        field = [n for n in ref.trainable(p) if n != "poses"]
        jt = conf["joint"]["train"]
        lr = jt["refinement_init_lr"]
        field_adam = ref.Adam(lr, field)
        pose_adam = ref.Adam(jt["pose_lr"] or lr, ["poses"])
        weights = conf["supervised_loss_weights"]
        clamp = conf["loss"]["config"]["depth_loss_clamp"]
        bases = torch.as_tensor(got["bases"]).to(dev)
        out: dict = {"batch_rows_off": 0,
                     "choices": {"snap": [], "window": [], "gate": []}}
        n_far, n_made = 0, 0
        gate_off, gate_pairs = 0, 0
        taken = out["choices"]

        def follow(kind, i):
            return theirs[kind][i] if theirs else None

        def step(total, with_poses):
            leaves = {n: p[n] for n in field + ["poses"]}
            g = ref.gradients(total, leaves)
            field_adam.step(p, g)
            # The poses' group steps on every update; a supervised step
            # gives it a zero gradient, which only advances its count.
            pose_adam.step(p, g if with_poses else
                           {"poses": torch.zeros_like(p["poses"])})
            return g

        def detached():
            for n in field + ["poses"]:
                p[n] = p[n].detach().requires_grad_()

        with ref.precision(tf32):
            # Both of the block's batches snap against the field at the
            # block's start.
            sup = []
            for i, rec in enumerate(got["sup"]):
                surface, _, off, _ = rec["arrays"]
                out["batch_rows_off"] += self.supervision_rows_off(surface,
                                                                   off)
                s_gt, o_gt, n_off = ref.supervision_targets(
                    model, p, surface, off, bases, follow("snap", i))
                n_far, n_made = n_far + n_off, n_made + len(surface)
                taken["snap"].append(s_gt)
                sup.append((surface, s_gt, off, o_gt))
            for i, arrays in enumerate(sup):
                detached()
                total, parts = ref.supervised_loss(model, p, *arrays,
                                                   weights)
                g = step(total, with_poses=False)
                if i == 0:
                    out["sup_loss"] = dict(
                        {k: float(v.detach()) for k, v in parts.items()},
                        loss=float(total.detach()))
                    out["sup_grads"] = {n: g[n] for n in field}
            for i, rec in enumerate(got["joint"]):
                batch, bad = self.rays_from_scene(rec["batch"])
                out["batch_rows_off"] += bad
                detached()
                total, parts, chosen = ref.joint_loss(
                    model, p, p["poses"], batch, rec["near"], rec["far"],
                    rec["draws"], t["fine_count"], weights, clamp,
                    {"window": follow("window", i), "gate": follow("gate", i)}
                    if theirs else None)
                n_far += chosen["off"]
                n_made += len(batch["uv"])
                gate_off += chosen["gate_off"]
                gate_pairs += chosen["gate_pairs"]
                taken["window"].append(chosen["window"])
                taken["gate"].append(chosen["gate"].detach())
                g = step(total, with_poses=True)
                if i == 0:
                    out["loss"] = dict({k: float(v.detach()) for k, v in
                                        parts.items()},
                                       loss=float(total.detach()))
                    out["grads"] = dict(g)
        out["after"] = {k: v.detach() for k, v in p.items()}
        out["choices_off"] = 100.0 * n_far / max(n_made, 1)
        out["gate_off"] = 100.0 * gate_off / max(gate_pairs, 1)
        return out

    def rays_from_scene(self, fed: Dict[str, torch.Tensor]):
        """The joint batch as the reference takes it: each row's view and
        pixel read from the program's batch, every value from the scene.
        Returns (batch, rows that disagree with the scene)."""
        s = self.scene
        h, w = s["size"]
        n = len(fed["uv"])
        view = fed["view_idx"].long()
        x, y = fed["uv"][:, 0].long(), fed["uv"][:, 1].long()
        bad = (view < 0) | (view >= len(s["poses"])) | (x < 0) | (x >= w) | \
            (y < 0) | (y >= h) | (fed["uv"] != fed["uv"].floor()).any(1)
        view = view.clamp(0, len(s["poses"]) - 1)
        pix = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        batch = {"uv": torch.stack([x, y], 1).to(torch.float32),
                 "view_idx": view,
                 "intrinsics": s["intrinsics"].expand(n, 4, 4),
                 "rgb": s["rgb"][view, pix], "depth": s["depth"][view, pix]}
        for k in ("intrinsics", "rgb", "depth"):
            bad |= (batch[k] != fed[k]).reshape(n, -1).any(1)
        return batch, int(bad.sum())

    def supervision_rows_off(self, surface: torch.Tensor,
                             off: torch.Tensor) -> int:
        """Rows of a supervision batch that disagree with the scene: a
        surface point that is not its view's sensor depth backprojected at
        a pixel (the points come ``len // views`` a view, in view order,
        through the ground-truth poses), or an off-surface point off the
        segment from its surface point a share in [0.05, 0.5] of the way to
        the scene's centroid."""
        s = self.scene
        h, w = s["size"]
        n, views = len(surface), len(s["poses"])
        view = (torch.arange(n, device=surface.device) //
                max(n // views, 1)).clamp(max=views - 1)
        pose = s["poses"][view].double()
        k = s["intrinsics"].double()
        rel = surface.double() - pose[:, :3, 3]
        cam = (pose[:, :3, :3].transpose(1, 2) @ rel[:, :, None])[:, :, 0]
        z = cam[:, 2]
        u = k[0, 0] * cam[:, 0] / z + k[0, 2]
        v = k[1, 1] * cam[:, 1] / z + k[1, 2]
        ui, vi = u.round(), v.round()
        pix = (vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)).long()
        depth = s["depth"][view, pix, 0].double()
        ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & \
            ((u - ui).abs() < 1e-2) & ((v - vi).abs() < 1e-2) & \
            ((depth - z).abs() <= 1e-4 * depth.abs().clamp(min=1.0))
        to_centre = s["centroid"].double() - surface.double()
        walk = off.double() - surface.double()
        share = (walk * to_centre).sum(1) / (to_centre * to_centre).sum(1)
        rest = (walk - share[:, None] * to_centre).norm(dim=1)
        ok &= (share >= 0.05 - 1e-5) & (share <= 0.5 + 1e-5) & \
            (rest <= 1e-5 * (surface.double().norm(dim=1) + 1.0))
        return int((~ok).sum())

    def check(self, notes: Optional[dict] = None) -> Dict[str, float]:
        """The compared numbers (``compare``'s, and the reference's counts
        of the batch rows and choices); ``notes`` takes ``compare``'s."""
        prog = self.program_readings()
        ref = self.reference_readings(theirs=self.program_choices())
        numbers = compare(prog, ref, self.weights, self.start_poses,
                          self.run.log, notes)
        numbers["batch_rows_off"] = float(ref["batch_rows_off"])
        numbers["choices_off"] = float(ref["choices_off"])
        numbers["gate_off"] = float(ref["gate_off"])
        return numbers


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
             ) -> Tuple[float, str]:
    """The worst key's ‖g − g_ref‖ over the larger of ‖g_ref‖ and the
    median ‖g_ref‖ of the keys the reference moves (a key whose reference
    is exactly 0, as a net the loss does not reach, is held to 0 against
    that median; a key the program's backward did not reach is 0)."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    median = float(np.median([x for x in norms.values() if x > 0] or [1.0]))
    gaps = {k: float((got.get(k, torch.zeros_like(want[k])).double() -
                      want[k].double()).norm()) / max(norms[k], median)
            for k in want}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def view_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per view (row) of a (V, 7) pose array: ‖g − g_ref‖ over the larger
    of ‖g_ref‖ and the median view's ‖g_ref‖."""
    got, want = got.double(), want.double().to(got.device)
    norms = want.norm(dim=1)
    return (got - want).norm(dim=1) / norms.clamp(min=float(norms.median()))


def compare(prog: dict, ref: dict, start: Dict[str, torch.Tensor],
            start_poses: np.ndarray, log=None,
            notes: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared:

    - ``loss_gap``, ``sup_loss_gap``: the first joint step's and the first
      supervised step's loss, the largest relative gap of its parts and
      its total (the parts' errors may cancel in the total);
    - ``pose_grad_gap``: the first joint step's pose gradient, the worst
      view's ‖g − g_ref‖ over the larger of its ‖g_ref‖ and the median
      view's;
    - ``grad_gap``, ``sup_grad_gap``: the first joint and supervised step's
      gradient of the field, by the worst leaf (``leaf_gap``);
    - ``pose_change_gap``: the same form for the poses' change from their
      start over the block and the checked joint steps, by the median
      view;
    - ``change_gap``: the median leaf's |‖Δ‖ − ‖Δ_ref‖| over the larger of
      ‖Δ_ref‖ and the median ‖Δ_ref‖, over the leaves the reference moved
      (as ``kinds/train.py::compare``).

    The worst view's change and the median view's gradient go into
    ``notes`` and the log, not into the comparison: Adam's first steps
    move each coordinate by about the learning rate whatever its
    gradient's size, so a coordinate whose gradient is rounding noise
    moves either way, and the reference in float32 puts the worst view's
    change as far from itself in float64 (up to 0.64) as the program does.
    """
    def rel(a, b):
        return abs(a - b) / abs(b) if b != 0 else float(a != b)

    pose_grad = view_gaps(prog["grads"]["poses"], ref["grads"]["poses"])
    field = [n for n in ref["grads"] if n != "poses"]
    grad, grad_worst = leaf_gap({n: prog["grads"][n] for n in field},
                                {n: ref["grads"][n] for n in field})
    sup_grad, sup_worst = leaf_gap(prog["sup_grads"], ref["sup_grads"])

    def moved(after, n):
        return after[n].double() - start[n].double().to(after[n].device)

    d_ref = {n: float(moved(ref["after"], n).norm()) for n in field}
    kept = [n for n in field if d_ref[n] > 0]
    med = float(np.median([d_ref[n] for n in kept]))
    change = {n: abs(float(moved(prog["after"], n).norm()) - d_ref[n]) /
              max(d_ref[n], med) for n in kept}
    p0 = torch.as_tensor(start_poses, dtype=torch.float64)
    pose_change = view_gaps(prog["after"]["poses"].double().cpu() - p0,
                            ref["after"]["poses"].double().cpu() - p0)
    if notes is not None:
        notes.update(pose_grad_median_view=float(pose_grad.median()),
                     pose_grad_worst_view=int(pose_grad.argmax()),
                     pose_change_worst=float(pose_change.max()),
                     pose_change_worst_view=int(pose_change.argmax()))
    if log is not None:
        parts = {k: rel(prog["loss"][k], ref["loss"][k])
                 for k in ref["loss"]}
        sup_parts = {k: rel(prog["sup_loss"][k], ref["sup_loss"][k])
                     for k in ref["sup_loss"]}
        log(f"joint loss gaps {parts}; supervised {sup_parts}; worst "
            f"gradient: view {int(pose_grad.argmax())} "
            f"{float(pose_grad.max())!r} (median view "
            f"{float(pose_grad.median())!r}), leaf {grad_worst} "
            f"(supervised {sup_worst}); worst leaf change "
            f"{max(change.values())!r}; worst view change "
            f"{float(pose_change.max())!r}")
    return {"loss_gap": max(rel(prog["loss"][k], ref["loss"][k])
                            for k in ref["loss"]),
            "pose_grad_gap": float(pose_grad.max()),
            "grad_gap": grad,
            "pose_change_gap": float(pose_change.median()),
            "change_gap": float(np.median(list(change.values()))),
            "sup_loss_gap": max(rel(prog["sup_loss"][k], ref["sup_loss"][k])
                                for k in ref["sup_loss"]),
            "sup_grad_gap": sup_grad}
