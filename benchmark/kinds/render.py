"""Eval-render traffic: ``VectorFieldNerf.render_image`` on whole views in
``chunk``-ray chunks, the views cycled in order, each view's rgb and depth
read to the host after the next view is enqueued (as the program's
``render_images`` reads them).

Set-up builds the facade with the benchmark's weights, in eval mode (the
folded nets), and renders the warm-up views. After the window a sample of
the window's chunks, drawn from the seed, is rendered again by the plain
reference from the same weights, pixels and generator state.
"""

from __future__ import annotations

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
        # (view, generator state, rgb, depth) of each view the window read.
        self.renders: List[tuple] = []
        self.n_views_done = 0

    def setup(self) -> None:
        from vf_nerf_torch.models.nerf import VectorFieldNerf
        run, t = self.run, self.traffic
        self.logs = program.tmp_dir("render")
        cfg = program.program_config(self.conf, self.logs, run.device.type)
        ds = program.office(t["scene"], sub_seed(run.seed, "scene"),
                            self.conf["dataset"]["pixels_per_batch"],
                            shuffle_views=False)
        model = VectorFieldNerf(cfg.vf_nerf_config,
                                seed=sub_seed(run.seed, "facade"),
                                device=run.device)
        model.near, model.far = ds.get_bounds()
        model.fine_n_samples = t["fine_count"]
        model.eval()
        self.scene = program.scene_arrays(ds, run.device)
        self.weights = program.make_weights(
            self.conf, sub_seed(run.seed, "weights"), run.device,
            t["vf_gain"])
        program.calibrate_batch_norm(self.conf, self.weights, self.scene,
                                     sub_seed(run.seed, "calibration"))
        program.load_weights(model.modules, self.weights)
        h, w = ds.image_size
        if (h * w) % t["chunk"]:
            raise RunError("a view's pixels must fill whole chunks")
        self.chunks_per_view = h * w // t["chunk"]
        self.uv = program.pixel_grid(h, w)
        self.poses = ds.poses
        self.intrinsics = ds.intrinsics
        self.model = model
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        self._views(t["warmup_views"], keep=False)

    def _views(self, n: int, keep: bool) -> int:
        """Render ``n`` whole views; returns the chunks rendered."""
        prev = None
        for _ in range(n):
            v = self.n_views_done % len(self.poses)
            state = self.model.generator.get_state()
            rgb, depth = self.model.render_image(
                self.uv, self.poses[v], self.intrinsics,
                self.traffic["epoch"], split_size=self.traffic["chunk"])
            if prev is not None:
                self._read(prev, keep)
            prev = (v, state, rgb, depth)
            self.n_views_done += 1
        if prev is not None:
            self._read(prev, keep)
        return n * self.chunks_per_view

    def _read(self, rendered, keep: bool) -> None:
        v, state, rgb, depth = rendered
        rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()
        if keep:
            self.renders.append((v, state, rgb, depth))

    def window(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        views = 0
        while time.perf_counter() - t0 < self.run.seconds:
            self._views(1, keep=True)
            views += 1
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        seconds = time.perf_counter() - t0
        self.attempted = views * self.chunks_per_view
        rate = views * len(self.uv) / seconds
        self.run.log(f"window: {views} views in {seconds!r} s, "
                     f"{rate!r} rays/s")
        return {"render_rays_per_s": rate}

    def traced(self) -> trace.Traced:
        n = self.traffic["trace_views"]
        work = self.cell.hooks.work(self.conf, self.traffic)
        traced = trace.profile(lambda: self._views(n, keep=True), "chunk",
                               work)
        self.attempted = traced.units
        self.run.log(f"traced window: {n} views in {traced.window_s!r} s, "
                     f"{n * len(self.uv) / traced.window_s!r} rays/s, "
                     f"busy {traced.busy_s!r} s")
        return traced

    def memory_peak(self) -> int:
        if self.run.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.run.device)
        self.run.log(f"memory_peak_bytes {peak}")
        return peak

    def release(self) -> None:
        self.model = None
        shutil.rmtree(self.logs, ignore_errors=True)

    # ----------------------------------------------------------------- check
    def sample(self) -> List[tuple]:
        """(render, chunk) pairs drawn from the seed among the window's."""
        pairs = [(i, c) for i in range(len(self.renders))
                 for c in range(self.chunks_per_view)]
        if not pairs:
            raise RunError("the window rendered no view")
        rng = np.random.RandomState(sub_seed(self.run.seed, "sample"))
        k = min(self.traffic["checked_chunks"], len(pairs))
        return [pairs[j] for j in sorted(rng.choice(len(pairs), k,
                                                    replace=False))]

    def reference_chunks(self, picks, tf32: bool = False):
        """(rgb, depth, coarse weights) of each picked chunk by the plain
        reference."""
        ref = self.cell.hooks.reference
        conf, t, dev = self.conf, self.traffic, self.run.device
        model = ref.Model(conf)
        n_c = conf["ray_sampler"]["n_samples"]
        chunk = t["chunk"]
        out = []
        with ref.precision(tf32), torch.no_grad():
            for i, c in picks:
                v, state, _, _ = self.renders[i]
                gen = torch.Generator(device=dev)
                gen.set_state(state)
                for _ in range(c + 1):
                    draws = ref.replay_uniforms(gen, chunk, n_c,
                                                t["fine_count"],
                                                conf["ray_sampler"]["perturb"],
                                                dev)
                rows = slice(c * chunk, (c + 1) * chunk)
                uv = torch.as_tensor(self.uv[rows]).to(dev)
                pose = self.scene["poses"][v].expand(chunk, 4, 4)
                intr = self.scene["intrinsics"].expand(chunk, 4, 4)
                r = ref.render(model, self.weights, uv, pose, intr,
                               self.scene["near"], self.scene["far"], draws,
                               t["fine_count"], False)
                out.append((r["rgb"], r["depth"], r["coarse_weights"]))
        return out

    def check(self) -> Dict[str, float]:
        picks = self.sample()
        ref = self.reference_chunks(picks)
        progs = [self.program_chunk(i, c) for i, c in picks]
        return compare(progs, ref, self.run.log)

    def program_chunk(self, i: int, c: int):
        _, _, rgb, depth = self.renders[i]
        chunk = self.traffic["chunk"]
        rows = slice(c * chunk, (c + 1) * chunk)
        dev = self.run.device
        return (torch.as_tensor(rgb[rows]).to(dev),
                torch.as_tensor(depth[rows, 0]).to(dev))


# Rays whose reference coarse weights have their two largest within this
# share of the largest: their fine window's place is a tie to rounding.
TIE = 1e-3


def compare(progs, refs, log=None) -> Dict[str, float]:
    """``rgb_gap`` and ``depth_gap``: the widest gap of a checked ray's rgb
    and depth from the reference's. A ray whose coarse weights tie to
    rounding in the reference (``TIE``) is left out: the fine sampler
    centres its window on the first largest weight, and a tie may fall
    either way."""
    rgb_gap, depth_gap, left, rays = 0.0, 0.0, 0, 0
    for (rgb, depth), (r_rgb, r_depth, w) in zip(progs, refs):
        top = torch.topk(w, 2, dim=-1).values
        keep = (top[:, 0] - top[:, 1]) >= TIE * top[:, 0]
        keep &= top[:, 0] > 0
        left += int((~keep).sum())
        rays += keep.numel()
        if keep.any():
            rgb_gap = max(rgb_gap, float((rgb - r_rgb).abs()[keep].max()))
            depth_gap = max(depth_gap,
                            float((depth - r_depth).abs()[keep].max()))
    if log is not None:
        log(f"rays left out as ties {left} of {rays}")
    return {"rgb_gap": rgb_gap, "depth_gap": depth_gap}
