#!/usr/bin/env python3
"""Drive vf_nerf_torch's eval render, training step, VF init, training
runner and image evaluation on one CUDA card, and check their kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and nvcc; it builds the kernels from ``vf_nerf_torch/csrc`` on first
use.

Phases, each printing one JSON line:

1. device: the card, its power limit, TF32 off;
2. build: the nvcc build of both kernels and its seconds, registers and
   spills from ``ptxas -v``, and the tensor-core instructions (``HMMA`` /
   ``HGMMA``) in each kernel's SASS (``cuobjdump -sass``): the fused MLP
   must have some;
3. fused_mlp: the kernel against its plain version (``mlp_reference``) on
   the card at the render's shapes: the VF net on 102,400 and 133,120
   points (39 -> 259, skip at layer 4, tanh) and the colour net on 133,120
   x 289 -> 3 (sigmoid); kernel, plain and cuBLAS-chain times, the 3xTF32
   tensor-core bound (``bound_ms``) and the f32-FMA one
   (``bound_f32_fma_ms``); the kernel must beat the cuBLAS chain, and one
   call must enqueue exactly one CUDA kernel (``torch.profiler``);
4. fused_ray_march: the kernel against ``ray_march_reference`` at
   (1024, 100) and (1024, 130), back-face threshold -0.2 and -2, annealed
   taps on a white background, raw density parameters beyond each clamp,
   and the coarse pass's weights-only mode (against the plain version with
   zero rgb); the kernel's device time per launch (``ms``, profiler), the
   wrapper's by CUDA events over back-to-back calls (``wrapper_ms``), the
   plain version's, and the byte bound; one call must enqueue exactly one
   CUDA kernel;
5. render: ``VectorFieldNerf.render`` of the shipped conf on the 1024 rays
   of ``__graft_entry__.entry`` (near 0, far 4): exactly 3 fused-MLP and 2
   ray-march launches, finite (1024, 3) / (1024, 1) outputs, agreement with
   the port's plain path on the CPU from the same weights and draws, and
   ms per render;
6. render_image on a small image through the facade;
7. profile: device time by kernel over 3 renders (``torch.profiler``), the
   full table in ``chiprun_out/profile_render.txt``;
8. train_kernels, at the training step's shapes: the fused MLP's
   activation-save mode (output identical to the no-save launch, saved
   activations equal to the plain forward's) and ``FusedMLP``'s gradients
   against autograd through ``mlp_reference`` (1e-4·max|g|, the upstream
   gradient zeroed on the points whose ReLU masks differ) for the fine VF
   net, the colour net and the shell and ball VF nets; per case the save
   mode's time beside the no-save launch's and the cuBLAS chain that keeps
   every hidden output (``library_ms``), each schedule's save-mode time
   (``ms_tile128``, ``ms_tile64``), the chosen schedule's blocks and rounds
   on the card's SMs, the saved bytes and their time at the HBM rate, the
   cuBLAS backward products' and the plain forward + backward's time; the
   four launches must beat the chains' total; the ray-march backward
   kernel against autograd through ``ray_march_reference`` at (1024, 200)
   with ``n_valid`` 130 and 200, a white background, a weights gradient and
   raw density parameters at their clamps, and at (1024, 26), (1024, 130)
   and (256, 1024) (rtol 1e-4, atol 1e-5·max(1, max|g|)), one CUDA kernel
   per call, its device time and byte bound per case, the plain version's
   time;
9. train_step: the shipped conf's training step through
   ``parallel/train_step.py::make_train_step`` (1024 rays, perturb on,
   static fine growth: 100 coarse + 100 padded fine samples, 30 live,
   exterior supervision, the duplicate-VF optimizer): exactly 5 fused-MLP,
   2 ray-march and 1 ray-march-backward launches per step; the loss and
   every gradient against the port's plain path on the CPU from the same
   weights and draws (loss rtol 1e-4 against float32; each gradient within
   1e-3·max|g| of the float64 plain path, or within the float32 plain
   path's own worst distance from float64 where that is larger: with the
   VF kernels gained by 3.5 no f32 chain meets 1e-3);
   20 steps on one batch with the loss falling; ms per step and rays/s
   after 3 warm-up steps, peak memory, and the device's busy share over 3
   steps (``torch.profiler``, table in ``chiprun_out/profile_train.txt``);
10. vf_init: ``fit_vf_init`` of the shipped VF net ("exterior_scene", the box
   scene's wall radius, extent 1.5x that) on 8,192 points per step for 800
   steps: ``FusedMLP`` at the first step's 8,192 points against the plain
   version as in phase 8, one fused-MLP launch per step (launch count, and
   3 and 13 kernels over 3 and 13 steps by ``torch.profiler``, whose
   difference gives the kernels and device ms per step and the busy share),
   the final loss below half the first's, and the ``.pkl`` loaded back by
   ``load_vf_init`` giving the fitted net's field bit for bit; ms per step;
11. runner: ``VectorFieldNerfRunner.train()`` of the shipped conf on the
   synthetic box scene (8 views of 32 x 48, 1024 rays per step) for 60
   epochs with a save every 20, from the phase-10 init: 5 / 2 / 1 launches
   per step, the loss of the last 5 epochs below the first 5's, the
   checkpoints, ``metrics.jsonl`` and ``convergence.json``, the fine count
   40; a resume from ``latest`` at epoch 61 with the fine count 45 and the
   state equal bit for bit; the run rate (every step after epoch 0 over the
   wall time from the end of epoch 0 to the final synchronize, saves
   included) against phase 9's bare step, the logged per-epoch rates, the
   device's busy share over one more epoch and peak memory;
12. eval: ``evaluate`` (render-images, then metrics) of the ``latest`` and
   ``0`` checkpoints: the images, depths and ``metrics.json``, 3 MLP and 2
   march launches per chunk, the trained mean PSNR above epoch 0's, and the
   eval's rays/s; then the 512-ray tail chunk of a view through
   ``render_image`` of the ``latest`` eval model (fine count 45, so 145
   samples) against the port's plain path on the CPU, as in phase 5. These
   three phases write under ``chiprun_out/smoke_run`` and delete the
   checkpoints at the end.

Then the ``{"kernels": [...]}`` line (``launches``: the runner's, with each
other path's as ``launches_<path>``), the card's ``nvidia-smi`` name and
power limit, and the last line ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero without that last line. Weights are the port's seeded
init with the VF kernels scaled by ``VF_GAIN``, so that the random field
flips along rays and both branches of the fine sampler occur.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vf_nerf_torch.config import parse_config
from vf_nerf_torch.datasets.synthetic import SyntheticBoxDataset
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.evaluation.evaluate import eval_model, evaluate
from vf_nerf_torch.kernels import load_library
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.renderer import draw_uniforms, render_rays
from vf_nerf_torch.ops.density import DensityParams
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import (_launch, _sm_count, acts_shape,
                                         blocks_of_128, fused_mlp,
                                         hidden_views, mlp_backward_reference,
                                         mlp_reference)
from vf_nerf_torch.ops.ray_march import (MarchStatics, fused_ray_march,
                                         ray_march_backward,
                                         ray_march_backward_reference,
                                         ray_march_reference)
from vf_nerf_torch.parallel import train_step as train
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.train.vf_init import (default_vf_config, fit_vf_init,
                                         save_vf_init)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
CONF = ROOT / "confs" / "vf_nerf.conf"
VF_GAIN = 3.5
N_RAYS = 1024
# Published H100 SXM peaks (NVIDIA data sheet): dense TF32 on the tensor
# cores, f32 outside them, and HBM3 bandwidth. The fused MLP's products are
# 3xTF32 (three TF32 products per f32 product), so its bound is 3 x FLOP
# over the TF32 peak.
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MLP_TOL = 1e-3      # max |kernel - plain| on tanh / sigmoid outputs in [-1, 1]
MARCH_TOL = dict(rtol=1e-4, atol=1e-5)
# The gained VF net amplifies f32 rounding (its f32 output is within ~5e-5
# of f64 on the CPU) and the density's slope reaches scale / (2 beta) = 100
# per unit cosine, so the render is held to looser bounds than one kernel.
RENDER_TOL = {"rgb": 2e-3, "depth": 2e-2}
MIN_ARGMAX_AGREEMENT = 0.99
# Training: the shipped conf's static fine growth pads the fine axis to
# max_samples (100) and 30 samples are live at the start of training.
N_FINE_ACTIVE = 30
# VF init, runner and eval phases: the shipped VF net fitted on 8,192 points
# per step, then the shipped conf trained on the synthetic box scene.
VF_INIT_STEPS = 800
VF_INIT_BATCH = 8192
RUNNER_EPOCHS = 60
RUN_DIR = OUT / "smoke_run"
# Gradients, as max |Δg| / max |g| per tensor: FusedMLP against autograd
# through mlp_reference on the card; the step against the CPU plain path in
# float64, within GRAD_TOL or the CPU float32 path's own worst distance from
# float64 over all tensors (with the VF kernels gained by 3.5 no f32 chain
# meets 1e-3: the CPU's misses float64 by ~3e-2 on its worst tensor).
MLP_GRAD_TOL = 1e-4
GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4

failures = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
               "cuobjdump")


def tensor_core_instructions(lib_path) -> dict:
    """HMMA (mma.sync) and HGMMA (wgmma) instructions in each kernel's SASS."""
    sass = subprocess.run([cuobjdump(), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
                    break
    return counts


def cuda_events(fn, calls: int = 1):
    """(the CUDA kernels' profiler events, wall seconds) of ``calls`` calls
    of ``fn`` ended by a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    # The calls sit well inside the trace window: a kernel record at its very
    # edge can be dropped.
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(0.01)
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA], seconds


def kernels_per_call(fn, calls: int = 1):
    """(CUDA kernels enqueued, device ms per call, kernel names) of
    ``calls`` calls of ``fn``, by ``torch.profiler``, after one warm-up."""
    fn()
    events, _ = cuda_events(fn, calls)
    count = sum(e.count for e in events)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    return count, device_ms, sorted(e.key[:60] for e in events)


def runner_config():
    return parse_config(scene="office0", config_path=str(CONF),
                        expname="graft")


def build_model(device) -> VectorFieldNerf:
    cfg = runner_config().vf_nerf_config
    model = VectorFieldNerf(cfg, seed=0, device=device)
    with torch.no_grad():
        for layer in model.modules.vf.layers:
            lin = layer[0] if isinstance(layer, torch.nn.Sequential) \
                else layer
            lin.weight.mul_(VF_GAIN)
    model.near, model.far = 0.0, 4.0
    return model


def addmm_chain(weights, x, skip_at, final_act, keep=None):
    """The cuBLAS yardstick: one addmm per layer with in-place ReLU. With a
    list as ``keep``, every hidden layer's output is kept in it, the work of
    the fused MLP's activation-save mode."""
    h = x
    for i, (w, b) in enumerate(weights):
        if i == skip_at:
            h = torch.cat([h, x], 1).div_(2.0 ** 0.5)
        h = torch.addmm(b, h, w)
        if i < len(weights) - 1:
            h.relu_()
            if keep is not None:
                keep.append(h)
    return torch.tanh(h) if final_act == "tanh" else torch.sigmoid(h)


def phase_mlp(model, dev):
    vf_w, rn_w = model.modules.folded_weights()
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bound_f32_fma_ms=0.0, max_abs_err=0.0)
    statics = model.render_statics()
    n_coarse = N_RAYS * statics.n_coarse
    n_all = N_RAYS * (statics.n_coarse + statics.n_fine)
    skip = model.modules.vf.skip_at
    cases = [("vf_coarse", vf_w, n_coarse, skip, "tanh"),
             ("vf_fine", vf_w, n_all, skip, "tanh"),
             ("colour", rn_w, n_all, None, "sigmoid")]
    flop_total = 0.0
    for name, weights, n, skip, act in cases:
        if act == "tanh":
            pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
            x = positional_encoding(
                pts, model.config.vf_net_config.embedder_multires)
        else:
            x = torch.rand((n, weights[0][0].shape[0]), generator=gen,
                           device=dev) * 2 - 1
        out = fused_mlp(weights, x, skip_at=skip, final_act=act)
        ref = mlp_reference(weights, x, skip, act)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        check(finite and err <= MLP_TOL,
              f"fused_mlp {name}: max abs err {err} > {MLP_TOL}")
        n_kernels, _, names = kernels_per_call(
            lambda: fused_mlp(weights, x, skip, act))
        check(n_kernels == 1,
              f"fused_mlp {name}: one call enqueued {n_kernels} kernels "
              f"{names}")
        macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
        flop = 2.0 * n * macs
        nbytes = 4.0 * (n * (x.shape[1] + weights[-1][0].shape[1]) +
                        sum(w.numel() + b.numel() for w, b in weights))
        byte_ms = nbytes / PEAK_BYTES * 1e3
        row = dict(
            case=name, points=n, in_dim=x.shape[1],
            out_dim=weights[-1][0].shape[1], macs_per_point=macs,
            max_abs_err=err, tol=MLP_TOL, kernels_per_call=n_kernels,
            ms=cuda_ms(lambda: fused_mlp(weights, x, skip, act)),
            plain_ms=cuda_ms(lambda: mlp_reference(weights, x, skip, act)),
            library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip, act)),
            bound_ms=max(3 * flop / PEAK_TF32_FLOPS * 1e3, byte_ms),
            bound_f32_fma_ms=max(flop / PEAK_F32_FLOPS * 1e3, byte_ms))
        row["tflops_f32_equivalent"] = flop / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        flop_total += flop
        for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_f32_fma_ms"):
            totals[k] += row[k]
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    check(totals["ms"] < totals["library_ms"],
          f"fused_mlp {totals['ms']} ms per render does not beat the cuBLAS "
          f"chain's {totals['library_ms']} ms")
    emit({"phase": "fused_mlp", "cases": rows,
          "ms_per_render": totals["ms"],
          "library_ms_per_render": totals["library_ms"],
          "bound_ms_per_render": totals["bound_ms"],
          "share_of_bound": totals["bound_ms"] / totals["ms"],
          "tflops_f32_equivalent": flop_total / totals["ms"] / 1e9})
    return totals


def march_inputs(n_rays, n_samples, seed, dev):
    rng = np.random.RandomState(seed)
    normals = rng.randn(n_rays, n_samples, 3).astype(np.float32)
    t = np.linspace(0, np.pi, n_samples, dtype=np.float32)
    normals[..., 0] += np.cos(3 * t)[None]
    dirs = rng.randn(n_rays, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.1, 4.0, (n_rays, n_samples)),
                axis=1).astype(np.float32)
    rgb = rng.rand(n_rays, n_samples, 3).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (normals, dirs, z, rgb)]


def phase_march(model, dev):
    def params_of(*values):
        return DensityParams(*(torch.tensor(v, device=dev) for v in values))

    params = params_of(0.5, 100.0, 0.7)
    # Raw values beyond each clamp: beta under its lower bound, a negative
    # scale, the mean under its lower bound.
    clamped = params_of(0.01, -80.0, 0.2)
    uniform = torch.full((11,), 1.0 / 11, device=dev)
    annealed = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08,
                             0.04, 0.02, 0.01], device=dev)
    statics = model.render_statics()
    s_coarse, s_all = statics.n_coarse, statics.n_coarse + statics.n_fine
    # (samples, threshold, taps, white background, params, beta bounds,
    #  weights only)
    shipped = (1e-4, 1e9)
    s_pad = statics.n_coarse + model.config.ray_sampler_config.max_samples
    n_valid = statics.n_coarse + N_FINE_ACTIVE
    cases = [(s_coarse, -0.2, uniform, False, params, shipped, False, None),
             (s_coarse, -2.0, uniform, False, params, shipped, True, None),
             (s_all, -0.2, uniform, False, params, shipped, False, None),
             (s_all, -2.0, uniform, False, params, shipped, False, None),
             (s_all, -0.2, annealed, True, params, shipped, False, None),
             (s_all, -0.2, uniform, False, clamped, (0.3, 1e9), False,
              None),
             (s_pad, -0.2, annealed, True, params, shipped, False, n_valid)]
    rows, timed, max_err = [], {}, 0.0
    for s, th, taps, white, prm, beta_bounds, weights_only, live in cases:
        normals, dirs, z, rgb = march_inputs(N_RAYS, s, s, dev)
        kw = dict(beta_bounds=beta_bounds, scale_min=1.0,
                  mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=th,
                  normalize=True, white_background=white, n_valid=live)
        rgb_in = None if weights_only else rgb
        out = fused_ray_march(normals, dirs, z, rgb_in, prm, taps, **kw)
        # The weights-only mode is held to the plain version with zero rgb.
        ref = ray_march_reference(normals, dirs, z,
                                  torch.zeros_like(rgb) if weights_only
                                  else rgb, prm, taps, **kw)
        torch.cuda.synchronize()
        check(not weights_only or (out[0] is None and out[1] is None),
              "weights-only march returned rgb or depth")
        errs = {}
        for name, a, b in zip(("rgb", "depth", "weights"), out, ref):
            if a is None:
                continue
            errs[name] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, **MARCH_TOL)),
                  f"fused_ray_march S={s} th={th} white={white} "
                  f"weights_only={weights_only} n_valid={live} {name}: max "
                  f"abs err {errs[name]}")
        max_err = max(max_err, *errs.values())
        n_kernels, device_ms, names = kernels_per_call(
            lambda: fused_ray_march(normals, dirs, z, rgb_in, prm, taps,
                                    **kw))
        check(n_kernels == 1,
              f"fused_ray_march S={s}: one call enqueued {n_kernels} "
              f"kernels {names}")
        row = dict(samples=s, n_valid=live, th=th, white=white,
                   weights_only=weights_only,
                   clamped=prm is clamped, max_abs_err=errs, tol=MARCH_TOL,
                   kernels_per_call=n_kernels,
                   surface_rays=float((out[2].sum(1) > 0.5).float().mean()))
        # The render's two launches: the coarse pass (weights only) and the
        # fine composite, at the shipped threshold.
        if th == -2.0:
            rgb_bytes = 0 if weights_only else N_RAYS * s * 3 + N_RAYS * 4
            nbytes = 4.0 * (N_RAYS * s * 4 + N_RAYS * 3 + 11 + 3 +
                            N_RAYS * s + rgb_bytes)
            _, device_ms, _ = kernels_per_call(
                lambda: fused_ray_march(normals, dirs, z, rgb_in, prm, taps,
                                        **kw), calls=20)
            row.update(
                ms=device_ms,
                wrapper_ms=cuda_ms(lambda: fused_ray_march(
                    normals, dirs, z, rgb_in, prm, taps, **kw), iters=50),
                plain_ms=cuda_ms(lambda: ray_march_reference(
                    normals, dirs, z, rgb_in, prm, taps, **kw), iters=20),
                bound_ms=nbytes / PEAK_BYTES * 1e3, bytes=nbytes)
            timed[s] = row
        rows.append(row)
    emit({"phase": "fused_ray_march", "cases": rows})
    return dict(ms=sum(r["ms"] for r in timed.values()),
                wrapper_ms=sum(r["wrapper_ms"] for r in timed.values()),
                plain_ms=sum(r["plain_ms"] for r in timed.values()),
                bound_ms=sum(r["bound_ms"] for r in timed.values()),
                max_abs_err=max_err)


def entry_inputs():
    """The 1024 rays of ``__graft_entry__.entry``."""
    rng = np.random.RandomState(0)
    uv = rng.uniform(0, 640, (N_RAYS, 2)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (N_RAYS, 1, 1))
    intr = np.tile(np.eye(4, dtype=np.float32), (N_RAYS, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = 600.0
    intr[:, 0, 2], intr[:, 1, 2] = 320.0, 240.0
    return uv, pose, intr


def hold_render(model, out, uv, pose, intr, statics, draw_state, what):
    """Hold the card's ``render_rays`` output ``out`` against the port's
    plain path on the CPU from the same weights, the draws replayed from the
    facade generator's ``draw_state``: the coarse argmax agrees on at least
    ``MIN_ARGMAX_AGREEMENT`` of the rays, and on those rgb and depth are
    within ``RENDER_TOL``. Returns (agreement, errors, the CPU output)."""
    replay = torch.Generator(device=model.device)
    replay.set_state(draw_state)
    draws = {k: None if v is None else v.cpu() for k, v in draw_uniforms(
        statics, uv.shape[0], replay, model.device).items()}
    cpu_modules = copy.deepcopy(model.modules).cpu()
    ref = render_rays(cpu_modules, uv.cpu(), pose.cpu(), intr.cpu(),
                      model.near, model.far,
                      torch.from_numpy(model.window_weights), statics,
                      **draws)
    agree = (out["argmax_coarse"].cpu() == ref["argmax_coarse"])
    share = float(agree.float().mean())
    check(share >= MIN_ARGMAX_AGREEMENT,
          f"{what}: coarse argmax agreement {share} < {MIN_ARGMAX_AGREEMENT}")
    errs = {k: float((out[k].cpu()[agree] - ref[k][agree]).abs().max())
            for k in RENDER_TOL}
    for k, tol in RENDER_TOL.items():
        check(errs[k] <= tol, f"{what} {k} vs CPU plain path: {errs[k]}")
    return share, errs, ref


def phase_render(model):
    uv, pose, intr = entry_inputs()
    statics = model.render_statics()
    draw_state = model.generator.get_state()
    fused_mlp.launches = 0
    fused_ray_march.launches = 0
    out = model.render(pose, uv, intr, epoch=0)
    torch.cuda.synchronize()
    launches = {"fused_mlp": fused_mlp.launches,
                "fused_ray_march": fused_ray_march.launches}
    check(launches == {"fused_mlp": 3, "fused_ray_march": 2},
          f"render launches {launches}, expected 3 MLP and 2 march")
    check(out["rgb"].shape == (N_RAYS, 3) and
          out["depth"].shape == (N_RAYS, 1), "render output shapes")
    check(bool(torch.isfinite(out["rgb"]).all() and
               torch.isfinite(out["depth"]).all()), "render outputs finite")

    share, errs, ref = hold_render(model, out, torch.from_numpy(uv),
                                   torch.from_numpy(pose),
                                   torch.from_numpy(intr), statics,
                                   draw_state, "render")

    def one_render():
        model.render(pose, uv, intr, epoch=0)

    for _ in range(3):
        one_render()
    torch.cuda.synchronize()
    n_iter = 20
    t0 = time.perf_counter()
    for _ in range(n_iter):
        one_render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_iter * 1e3
    emit({"phase": "render", "rays": N_RAYS, "launches": launches,
          "argmax_agreement": share,
          "window_branch_share": float(
              (ref["argmax_coarse"] > 0).float().mean()),
          "max_abs_err_vs_cpu_plain": errs, "tol": RENDER_TOL,
          "ms_per_render": ms, "rays_per_s": N_RAYS / ms * 1e3,
          "rgb_mean": float(out["rgb"].mean()),
          "depth_mean": float(out["depth"].mean())})
    return launches, ms


def phase_render_image(model):
    h, w = 48, 64
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pixels = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) * 10
    _, pose, intr = entry_inputs()
    fused_mlp.launches = 0
    fused_ray_march.launches = 0
    t0 = time.perf_counter()
    rgb, depth = model.render_image(pixels, pose[0], intr[0], epoch=0,
                                    split_size=1024)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    chunks = -(-h * w // 1024)
    check(rgb.shape == (h * w, 3) and depth.shape == (h * w, 1),
          "render_image shapes")
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all()),
          "render_image outputs finite")
    check(fused_mlp.launches == 3 * chunks and
          fused_ray_march.launches == 2 * chunks,
          "render_image launches per chunk")
    emit({"phase": "render_image", "pixels": h * w, "chunks": chunks,
          "seconds": seconds})


def phase_profile(model, render_ms):
    """torch.profiler over 3 renders: device time by kernel name, and the
    device's busy share of the unprofiled render time."""
    uv, pose, intr = entry_inputs()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    model.render(pose, uv, intr, epoch=0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            model.render(pose, uv, intr, epoch=0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_render.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    emit({"phase": "profile", "device_ms_per_render": device_ms,
          "render_ms": render_ms, "busy_share": device_ms / render_ms,
          "kernels_per_render": sum(e.count for e in kernels) / 3,
          "top": [{"name": e.key[:60], "calls_per_render": e.count / 3,
                   "device_ms_per_render":
                       e.self_device_time_total / 1e3 / 3}
                  for e in kernels[:12]]})


def max_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def hidden_forward(weights, x, skip_at):
    """The plain forward's hidden activations, layer after layer, side by
    side (unpadded)."""
    h, hidden = x, []
    for i, (w, b) in enumerate(weights[:-1]):
        if i == skip_at:
            h = torch.cat([h, x], 1) / 2.0 ** 0.5
        h = torch.relu(h @ w + b)
        hidden.append(h)
    return torch.cat(hidden, 1)


def hold_fused_mlp_training(name, weights, x, skip_at, act, gen) -> dict:
    """``FusedMLP`` (the save-mode launch) on ``x`` against the plain
    version: its output against the no-save launch bit for bit, its saved
    activations against the plain forward's, and its gradients against
    autograd through ``mlp_reference`` within ``MLP_GRAD_TOL``. Returns the
    errors and the case's tensors (``leaves``, ``x_leaf``, ``inputs``,
    ``acts``, the output ``y`` and the upstream gradient ``dy``)."""
    leaves = [(w.clone().requires_grad_(True),
               b.clone().requires_grad_(True)) for w, b in weights]
    flat = [t for wb in leaves for t in wb]
    x_leaf = x.clone().requires_grad_(act == "sigmoid")
    with torch.no_grad():
        plain_out = fused_mlp(weights, x, skip_at, act)
    out = fused_mlp(leaves, x_leaf, skip_at, act)
    saved = out.grad_fn.saved_tensors[1]
    acts = torch.cat(hidden_views(saved, weights), 1)
    torch.cuda.synchronize()
    check(torch.equal(out.detach(), plain_out),
          f"fused_mlp {name}: the save-mode output differs from the no-save "
          f"launch")
    hidden = hidden_forward(weights, x, skip_at)
    acts_err = max_rel(acts, hidden)
    check(acts_err <= 1e-5, f"fused_mlp {name}: saved activations "
          f"{acts_err} from the plain forward's")
    # A pre-activation within the kernel's rounding of 0 flips its ReLU
    # against the plain chain's and changes that point's gradients (weight
    # gradients are sums over points, so a few flipped points show at
    # ~1/sqrt(N)); the upstream gradient is zero on them.
    same = ((acts > 0) == (hidden > 0)).all(1)
    agree = float(same.float().mean())
    dy = torch.randn(out.shape, generator=gen, device=x.device) * same[:, None]
    inputs = flat + ([x_leaf] if x_leaf.requires_grad else [])
    got = torch.autograd.grad(out, inputs, dy)
    ref = torch.autograd.grad(mlp_reference(leaves, x_leaf, skip_at, act),
                              inputs, dy)
    err = max(max_rel(g, r) for g, r in zip(got, ref))
    check(err <= MLP_GRAD_TOL and agree >= 0.99,
          f"FusedMLP {name}: gradient error {err} (limit {MLP_GRAD_TOL}), "
          f"ReLU masks agree on {agree} of the points")
    return dict(max_rel_grad_err=err, relu_mask_agreement=agree,
                acts_max_rel_err=acts_err, leaves=leaves, x_leaf=x_leaf,
                inputs=inputs, acts=saved, y=plain_out, dy=dy)


def train_statics(model):
    """The training step's statics: static fine growth pads the fine axis
    to max_samples; exterior supervision at the (rays × samples) // 10
    shell count of the padded ray."""
    run = runner_config()
    statics = model.render_statics(
        n_fine=model.config.ray_sampler_config.max_samples)
    sup = train.SupervisionStatics.from_config(
        model.config, "exterior_synthetic", N_RAYS,
        statics.n_coarse + statics.n_fine, run.dataset_config.border_radius)
    return run, statics, sup


def phase_train_kernels(model, dev):
    """The training path's kernels at the step's shapes."""
    _, statics, sup = train_statics(model)
    n_all = N_RAYS * (statics.n_coarse + statics.n_fine)
    vf_w, rn_w = model.modules.folded_weights()
    skip = model.modules.vf.skip_at
    gen = torch.Generator(device=dev).manual_seed(2)
    sms = _sm_count(dev.index or 0)
    mlp_rows, totals = [], dict(ms=0.0, ms_no_save=0.0, backward_ms=0.0,
                                plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                                backward_bound_ms=0.0, max_abs_err=0.0)
    cases = [("vf_fine", vf_w, n_all, skip, "tanh"),
             ("colour", rn_w, n_all, None, "sigmoid"),
             ("vf_shell", vf_w, sup.n_points, skip, "tanh"),
             ("vf_ball", vf_w, sup.n_points, skip, "tanh")]
    for name, weights, n, skip_at, act in cases:
        if act == "tanh":
            pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
            x = positional_encoding(
                pts, model.config.vf_net_config.embedder_multires)
        else:
            x = torch.rand((n, weights[0][0].shape[0]), generator=gen,
                           device=dev) * 2 - 1
        x = x.contiguous()
        case = hold_fused_mlp_training(name, weights, x, skip_at, act, gen)
        leaves, x_leaf, inputs, acts, y, dy = (
            case[k] for k in ("leaves", "x_leaf", "inputs", "acts", "y", "dy"))
        # Times: the save-mode launch (and each schedule's, forced), the
        # no-save launch, the cuBLAS chain that keeps every hidden output,
        # the backward's cuBLAS products from the saved activations, and
        # the plain forward + backward by autograd.
        need_dx = act == "sigmoid"
        err = case["max_rel_grad_err"]
        blocks128 = blocks_of_128(n, sms)
        blocks64 = -(-max(0, n - 128 * blocks128) // 64)
        row = dict(
            case=name, points=n, max_rel_grad_err=err,
            relu_mask_agreement=case["relu_mask_agreement"],
            acts_max_rel_err=case["acts_max_rel_err"], sms=sms,
            blocks128=blocks128, blocks64=blocks64,
            rounds128=-(-blocks128 // sms), rounds64=-(-blocks64 // sms),
            rounds_all128=-(-(-(-n // 128)) // sms),
            ms=cuda_ms(lambda: fused_mlp(leaves, x_leaf, skip_at, act),
                       iters=5),
            **{f"ms_{label}": cuda_ms(lambda: _launch(
                weights, x, skip_at, act, save=True, blocks128=b), iters=5)
               for label, b in (("all128", -(-n // 128)), ("all64", 0))},
            ms_no_save=cuda_ms(lambda: fused_mlp(weights, x, skip_at, act),
                               iters=5),
            save_bytes=4.0 * np.prod(acts_shape(weights, n)),
            backward_ms=cuda_ms(lambda: mlp_backward_reference(
                weights, x, acts, y, dy, skip_at, act, need_dx=need_dx),
                iters=5),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(
                mlp_reference(leaves, x_leaf, skip_at, act), inputs, dy),
                iters=3),
            library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip_at, act,
                                                   keep=[]), iters=5))
        macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
        hidden_width = sum(w.shape[1] for w, _ in weights[:-1])
        out_dim = weights[-1][0].shape[1]
        fwd_bytes = 4.0 * (n * (x.shape[1] + out_dim + hidden_width) +
                           sum(w.numel() + b.numel() for w, b in weights))
        row["bound_ms"] = max(3 * 2.0 * n * macs / PEAK_TF32_FLOPS,
                              fwd_bytes / PEAK_BYTES) * 1e3
        # dW for every layer and dH for every layer but the first unless
        # dx is asked for: 2 products of N x in x out each, in f32.
        first = weights[0][0].numel()
        bwd_flop = 2.0 * n * (2 * macs - (0 if need_dx else first))
        bwd_bytes = 4.0 * (n * (x.shape[1] + out_dim * 2 + hidden_width +
                                (x.shape[1] if need_dx else 0)) +
                           2 * sum(w.numel() + b.numel() for w, b in weights))
        row["backward_bound_ms"] = max(bwd_flop / PEAK_F32_FLOPS,
                                       bwd_bytes / PEAK_BYTES) * 1e3
        row["backward_tflops"] = bwd_flop / row["backward_ms"] / 1e9
        row["save_byte_ms"] = row["save_bytes"] / PEAK_BYTES * 1e3
        row["save_overhead_ms"] = row["ms"] - row["ms_no_save"]
        # A 64-point split block's time over a 128-point block's, from the
        # all-64 and all-128 launches' rounds.
        row["split_block_cost"] = (row["ms_all64"] / -(-(-(-n // 64)) // sms)) \
            / (row["ms_all128"] / row["rounds_all128"])
        row["beats_library"] = row["ms"] <= row["library_ms"]
        mlp_rows.append(row)
        for k in ("ms", "ms_no_save", "backward_ms", "plain_ms",
                  "library_ms", "bound_ms", "backward_bound_ms"):
            totals[k] += row[k]
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        del case, acts, leaves, x_leaf, inputs, y, dy
        torch.cuda.empty_cache()
    check(totals["ms"] < totals["library_ms"],
          f"fused_mlp save mode {totals['ms']} ms per step does not beat the "
          f"cuBLAS chain's {totals['library_ms']} ms")

    # The ray march's backward: the step's shape first (timed), then the
    # other sample counts its paths give it.
    uniform = torch.full((11,), 1.0 / 11, device=dev)
    annealed = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08,
                             0.04, 0.02, 0.01], device=dev)
    s_pad = statics.n_coarse + statics.n_fine
    n_valid = statics.n_coarse + N_FINE_ACTIVE
    shipped = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0,
                   mean_bounds=(0.6, 1.0), cutoff=-0.5)
    # (rays, samples, n_valid, taps, white, weights gradient, clamped
    #  scalars, th)
    plain = (0.5, 100.0, 0.7)
    cases = [(N_RAYS, s_pad, n_valid, uniform, False, False, plain, -2.0),
             (N_RAYS, s_pad, s_pad, uniform, False, False, plain, -2.0),
             (N_RAYS, s_pad, n_valid, annealed, True, True, plain, -0.2),
             (N_RAYS, s_pad, n_valid, uniform, False, True, (0.3, 1.0, 0.6),
              -0.2),
             (N_RAYS, 26, 26, annealed, False, True, plain, -0.2),
             (N_RAYS, n_valid, n_valid, uniform, False, False, plain, -2.0),
             (256, 1024, 1024, annealed, True, True, plain, -0.2)]
    march_rows, timed = [], None
    for rays, s, live, taps, white, w_grad, scal, th in cases:
        normals, dirs, z, rgb = march_inputs(rays, s, 7, dev)
        bounds = dict(shipped, beta_bounds=(0.3, 1e9)) \
            if scal[0] == 0.3 else shipped
        st = MarchStatics(bounds["beta_bounds"], 1.0, (0.6, 1.0), -0.5, th,
                          True, white, live)
        scalars = torch.tensor(scal, device=dev)
        g_rgb = torch.randn((rays, 3), generator=gen, device=dev)
        g_depth = torch.randn((rays,), generator=gen, device=dev)
        g_w = torch.randn((rays, s), generator=gen, device=dev) \
            if w_grad else None
        args = (normals, dirs, z, rgb, scalars, taps, st, g_rgb, g_depth, g_w)
        got = ray_march_backward(*args)
        got = (got[0], got[1], got[2].sum(0))
        ref = ray_march_backward_reference(*args)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("normals", "rgb", "scalars"), got, ref):
            atol = 1e-5 * max(float(b.abs().max()), 1.0)
            errs[name] = float((a - b).abs().max())
            check(bool(torch.isfinite(a).all()) and
                  bool(torch.allclose(a, b, rtol=1e-4, atol=atol)),
                  f"ray_march_backward ({rays}, {s}) n_valid={live} "
                  f"white={white} weights_grad={w_grad} scalars={scal} "
                  f"{name}: max abs err {errs[name]} (atol {atol})")
        n_kernels, device_ms, names = kernels_per_call(
            lambda: ray_march_backward(*args), calls=20)
        check(n_kernels == 20, f"ray_march_backward: 20 calls enqueued "
              f"{n_kernels} kernels {names}")
        # Each input read once over the live samples (the padded ones from
        # n_valid on reach no output), each output written once over all.
        nbytes = 4.0 * (rays * live * (3 + 1 + 3 + (1 if w_grad else 0)) +
                        rays * 3 + rays * 4 + taps.numel() + 3 +
                        rays * s * 6 + rays * 3)
        row = dict(rays=rays, samples=s, n_valid=live, white=white,
                   weights_grad=w_grad, scalars=scal, th=th,
                   max_abs_err=errs, ms=device_ms, bytes=nbytes,
                   bound_ms=nbytes / PEAK_BYTES * 1e3)
        if timed is None:
            row.update(
                wrapper_ms=cuda_ms(lambda: ray_march_backward(*args),
                                   iters=50),
                plain_ms=cuda_ms(lambda: ray_march_backward_reference(*args),
                                 iters=10))
            timed = row
        march_rows.append(row)
    emit({"phase": "train_kernels", "mlp": mlp_rows, "mlp_totals": totals,
          "march_backward": march_rows})
    max_err = max(max(r["max_abs_err"].values()) for r in march_rows)
    return totals, dict(ms=timed["ms"], wrapper_ms=timed["wrapper_ms"],
                        plain_ms=timed["plain_ms"],
                        bound_ms=timed["bound_ms"], max_abs_err=max_err)


def train_batch(dev):
    """The entry rays with seeded colour and depth targets."""
    uv, pose, intr = entry_inputs()
    rng = np.random.RandomState(1)
    batch = {"uv": uv, "pose": pose, "intrinsics": intr,
             "rgb": rng.rand(N_RAYS, 3).astype(np.float32),
             "depth": rng.uniform(0.5, 3.5, (N_RAYS, 1)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def phase_train_step(model, dev):
    run, statics, sup = train_statics(model)
    weights, loss_cfg = run.vf_loss_weights, run.vf_loss_config
    batch = train_batch(dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    centroid = torch.zeros(3, device=dev)
    near, far = model.near, model.far
    n_points_active = (N_RAYS * (statics.n_coarse + N_FINE_ACTIVE)) // 10
    step = train.make_train_step(model.modules, model.optimizer, statics,
                                 sup, weights, loss_cfg)

    def one_step(draws=None):
        return step(train.zero_metric_sums(dev), batch, 0, taps, near, far,
                    centroid, n_fine_active=N_FINE_ACTIVE, draws=draws,
                    generator=model.generator)

    # One loss and its gradients against the port's plain path on the CPU,
    # in float32 and in float64.
    draws = train.draw_step(statics, sup, N_RAYS, model.generator, dev)
    results = []
    for mods, d, dt in ((model.modules, dev, torch.float32),
                        (copy.deepcopy(model.modules).cpu(), "cpu",
                         torch.float32),
                        (copy.deepcopy(model.modules).cpu().double(), "cpu",
                         torch.float64)):
        loss_fn = train.make_loss_fn(mods, statics, sup, weights, loss_cfg)
        total, parts, out = loss_fn(
            {k: v.to(d, dt) for k, v in batch.items()},
            {k: v.to(d, dt) for k, v in draws.items()}, 0, taps.to(d, dt),
            near, far, centroid.to(d, dt), N_FINE_ACTIVE, n_points_active)
        grads = torch.autograd.grad(total, list(mods.parameters()))
        results.append((float(total.detach()),
                        {k: float(v.detach()) for k, v in parts.items()},
                        [g.detach().cpu().double() for g in grads],
                        out["argmax_coarse"].cpu()))
        del mods, total, parts, out, grads
    (loss, parts, grads, argmax), (cpu_loss, cpu_parts, cpu_grads,
                                   cpu_argmax), (_, _, f64_grads, _) = results
    names = [n for n, _ in model.modules.named_parameters()]
    grad_rows = {n: dict(card_vs_f64=max_rel(g, r), cpu_vs_f64=max_rel(c, r),
                         card_vs_cpu=max_rel(g, c))
                 for n, g, c, r in zip(names, grads, cpu_grads, f64_grads)}
    f32_spread = max(r["cpu_vs_f64"] for r in grad_rows.values())
    over = {n: r for n, r in grad_rows.items()
            if r["card_vs_f64"] > max(GRAD_TOL, f32_spread)}
    worst = max(grad_rows, key=lambda n: grad_rows[n]["card_vs_f64"])
    argmax_share = float((argmax == cpu_argmax).float().mean())
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"train loss {loss} vs CPU plain path {cpu_loss}")
    check(not over, f"train gradients farther from float64 than allowed: "
          f"{over}")
    del results
    torch.cuda.empty_cache()

    # Launches of one step, from zero.
    fused_mlp.launches = 0
    fused_ray_march.launches = 0
    ray_march_backward.launches = 0
    sums = one_step()
    torch.cuda.synchronize()
    launches = {"fused_mlp": fused_mlp.launches,
                "fused_ray_march": fused_ray_march.launches,
                "ray_march_backward": ray_march_backward.launches}
    check(launches == {"fused_mlp": 5, "fused_ray_march": 2,
                       "ray_march_backward": 1},
          f"train step launches {launches}, expected 5 MLP, 2 march and 1 "
          f"march backward")
    check(np.isfinite(float(sums["loss"])), "train step loss finite")

    # 20 steps on the one batch: the loss falls.
    losses = [float(one_step()["loss"]) for _ in range(20)]
    check(bool(np.isfinite(losses).all()) and
          np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"the loss does not fall over 20 steps: {losses}")

    # Time: 3 warm-up steps, then 10 steps ended by a synchronize.
    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_iter = 10
    t0 = time.perf_counter()
    for _ in range(n_iter):
        one_step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_iter * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_train.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=50))
    emit({"phase": "train_step", "rays": N_RAYS,
          "samples": statics.n_coarse + statics.n_fine,
          "n_valid": statics.n_coarse + N_FINE_ACTIVE,
          "shell_points": sup.n_points, "launches": launches,
          "loss": loss, "cpu_loss": cpu_loss, "parts": parts,
          "cpu_parts": cpu_parts, "argmax_agreement": argmax_share,
          "worst_grad": worst, "worst_grad_errs": grad_rows[worst],
          "max_card_vs_f64": max(r["card_vs_f64"]
                                 for r in grad_rows.values()),
          "max_cpu_vs_f64": max(r["cpu_vs_f64"] for r in grad_rows.values()),
          "max_card_vs_cpu": max(r["card_vs_cpu"]
                                 for r in grad_rows.values()),
          "losses_20": losses, "ms_per_step": ms,
          "rays_per_s": N_RAYS / ms * 1e3, "peak_memory_gb": peak_gb,
          "device_ms_per_step": device_ms, "busy_share": device_ms / ms,
          "kernels_per_step": sum(e.count for e in kernels) / 3,
          "top": [{"name": e.key[:60], "calls_per_step": e.count / 3,
                   "device_ms_per_step": e.self_device_time_total / 1e3 / 3}
                  for e in kernels[:15]]})
    return launches, ms


def reset_launches() -> None:
    fused_mlp.launches = 0
    fused_ray_march.launches = 0
    ray_march_backward.launches = 0


def read_launches() -> dict:
    return {"fused_mlp": fused_mlp.launches,
            "fused_ray_march": fused_ray_march.launches,
            "ray_march_backward": ray_march_backward.launches}


def kernel_counts(fn) -> dict:
    """The port's kernels by name, all kernels and their device ms over one
    call of ``fn`` (``torch.profiler``), and the call's wall seconds."""
    events, seconds = cuda_events(fn)
    counts = {name: sum(e.count for e in events
                        if re.search(rf"\b{name}[<(]", e.key))
              for name in ("fused_mlp_kernel", "ray_march_kernel",
                           "ray_march_backward_kernel")}
    return dict(counts, device_ms=sum(e.self_device_time_total
                                      for e in events) / 1e3,
                kernels=sum(e.count for e in events), seconds=seconds)


def scene_runner_config(checkpoint: str = ""):
    """The shipped conf on the synthetic box scene (8 views of 32 x 48,
    1024 rays per step), ``RUNNER_EPOCHS`` epochs, a save every 20."""
    cfg = parse_config(scene="box", config_path=str(CONF), expname="smoke",
                       timestamp="run", checkpoint=checkpoint, offline=True)
    cfg.dataset_config.dataset_name = "synthetic"
    cfg.num_epochs = RUNNER_EPOCHS
    cfg.save_frequency = 20
    cfg.exps_folder = str(RUN_DIR / "exps")
    return cfg


def phase_vf_init(dev):
    """VF init of the shipped VF net for the box scene, as
    ``tools/tpu_smoke.py:77-83`` sizes it."""
    wall = SyntheticBoxDataset().max_depth * 1.25 / 2.0
    kw = dict(sample_extent=1.5 * wall, wall_radius=wall, batch=VF_INIT_BATCH,
              seed=0, device=dev)

    def fit(steps):
        return fit_vf_init(default_vf_config(), "exterior_scene",
                           np.zeros(3), steps=steps, log_every=0, **kw)

    # The first step's kernel inputs: the seeded net (0 steps) and the
    # points that fit_vf_init draws first from the generator of ``seed``.
    net, _ = fit(0)
    pts = 1.5 * wall * (torch.rand((VF_INIT_BATCH, 3), generator=torch.
                                   Generator(device=dev).manual_seed(0),
                                   device=dev) * 2 - 1)
    case = hold_fused_mlp_training(
        "vf_init", net.folded_weights(), positional_encoding(
            pts, default_vf_config().embedder_multires).contiguous(),
        net.skip_at, "tanh", torch.Generator(device=dev).manual_seed(4))
    grad_check = {k: case[k] for k in ("max_rel_grad_err",
                                       "relu_mask_agreement",
                                       "acts_max_rel_err")}
    del case, net
    # Kernels per step and the device's time per step, from the difference
    # of a 13-step and a 3-step fit (which removes the set-up's kernels).
    few, many = kernel_counts(lambda: fit(3)), kernel_counts(lambda: fit(13))
    check(few["fused_mlp_kernel"] == 3 and many["fused_mlp_kernel"] == 13,
          f"vf_init: 3 and 13 steps enqueued {few['fused_mlp_kernel']} and "
          f"{many['fused_mlp_kernel']} fused-MLP kernels")
    per_step = {k: (many[k] - few[k]) / 10 for k in ("device_ms", "kernels")}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net, losses = fit_vf_init(default_vf_config(), "exterior_scene",
                              np.zeros(3), steps=VF_INIT_STEPS, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    check(launches == {"fused_mlp": VF_INIT_STEPS, "fused_ray_march": 0,
                       "ray_march_backward": 0},
          f"vf_init launches {launches}, expected one fused MLP per step")
    losses = losses.cpu().numpy()
    check(bool(np.isfinite(losses).all()) and losses[-1] < 0.5 * losses[0],
          f"vf_init loss {losses[-1]} is not below half of the first step's "
          f"{losses[0]}")
    pkl = RUN_DIR / "vf_init.pkl"
    save_vf_init(str(pkl), net, "exterior_scene", wall)
    model = VectorFieldNerf(runner_config().vf_nerf_config, device=dev)
    model.load_vf_init(str(pkl))
    pts = (torch.rand((50_000, 3), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev) * 2 - 1) * 1.5 * wall
    with torch.no_grad():
        direct = fused_mlp(net.folded_weights(), positional_encoding(
            pts, default_vf_config().embedder_multires).contiguous(),
            skip_at=net.skip_at, final_act="tanh")[:, :3]
    loaded = model.get_vector_field(pts)
    check(torch.equal(loaded, direct),
          "the VF init loaded back through load_vf_init does not give the "
          "fitted net's field bit for bit")
    ms = seconds / VF_INIT_STEPS * 1e3
    emit({"phase": "vf_init", "steps": VF_INIT_STEPS,
          "points_per_step": VF_INIT_BATCH, "wall_radius": wall,
          "launches": launches, "first_step_fused_mlp": grad_check,
          "first_loss": float(losses[0]), "final_loss": float(losses[-1]),
          "seconds": seconds, "ms_per_step": ms,
          "device_ms_per_step": per_step["device_ms"],
          "kernels_per_step": per_step["kernels"],
          "busy_share": per_step["device_ms"] / ms})
    del model, net
    return pkl, launches, ms


def _state_equal(a: VectorFieldNerf, b: VectorFieldNerf) -> bool:
    same = all(torch.equal(x, y) for x, y in zip(
        a.modules.state_dict().values(), b.modules.state_dict().values()))
    for key in ("mu", "nu"):
        for group, tensors in getattr(a.optimizer, key).items():
            same &= all(torch.equal(x, y) for x, y in zip(
                tensors, getattr(b.optimizer, key)[group]))
    return same and a.step == b.step


def phase_runner(pkl, step_ms):
    """``VectorFieldNerfRunner.train()`` of the shipped conf on the box
    scene from the phase-10 VF init, then a resume from ``latest``."""
    cfg = scene_runner_config()
    runner = VectorFieldNerfRunner(cfg)
    runner.model.load_vf_init(str(pkl))
    steps = RUNNER_EPOCHS * len(runner.dataset)
    # The run rate's window opens when the first epoch (and the first step's
    # warm-up) has finished on the device.
    train_epoch, marks = runner.train_epoch, {}

    def marked_epoch(epoch, draws=None):
        logged = train_epoch(epoch, draws=draws)
        if epoch == 0:
            torch.cuda.synchronize()
            marks["after_epoch_0"] = time.perf_counter()
        return logged

    runner.train_epoch = marked_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    seconds = t_end - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == {"fused_mlp": 5 * steps, "fused_ray_march": 2 * steps,
                       "ray_march_backward": steps},
          f"runner launches {launches} over {steps} steps, expected 5 MLP, 2 "
          f"march and 1 march backward per step")
    with open(Path(runner.run_dir) / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    logged = [line for line in lines if line.get("_type") == "metrics"]
    losses = [line["loss"] for line in logged]
    check(len(logged) == RUNNER_EPOCHS,
          f"metrics.jsonl has {len(logged)} metric lines, expected "
          f"{RUNNER_EPOCHS}")
    check(bool(np.isfinite(losses).all()) and
          np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"runner: the mean loss of the last 5 epochs is not below the "
          f"first 5's: {losses}")
    ckpt_dir = Path(runner.ckpt_dir)
    names = ["0.ckpt", "20.ckpt", "40.ckpt",
             f"{RUNNER_EPOCHS - 1}.ckpt", "latest.ckpt"]
    missing = [n for n in names if not (ckpt_dir / n).exists()]
    missing += [n for n in ("metrics.jsonl", "convergence.json")
                if not (Path(runner.run_dir) / n).exists()]
    check(not missing, f"runner: missing {missing}")
    check(runner.model.fine_n_samples == 40,
          f"runner: fine count {runner.model.fine_n_samples}, expected 40 "
          f"(growth at epochs 0 and 50)")

    resumed_cfg = scene_runner_config("latest")
    resumed = VectorFieldNerfRunner(resumed_cfg)
    check(resumed_cfg.start_epoch == RUNNER_EPOCHS + 1,
          f"resume: start_epoch {resumed_cfg.start_epoch}, expected "
          f"{RUNNER_EPOCHS + 1}")
    check(resumed.model.fine_n_samples == 45,
          f"resume: fine count {resumed.model.fine_n_samples}, expected 45 "
          f"(40 + 5 * (61 // 50))")
    check(_state_equal(resumed.model, runner.model),
          "resume: the loaded parameters, Adam moments or count differ from "
          "the trained model's")

    # The device's busy share over one more epoch of the resumed runner,
    # ended by its epoch-end read.
    epoch = resumed_cfg.start_epoch
    busy = kernel_counts(lambda: (resumed.train_epoch(epoch),
                                  resumed._resolve_pending_log()))
    # The run rate: every step after the first epoch, saves, reads and the
    # final save included, over the wall time from the end of epoch 0 to the
    # final synchronize. The per-epoch logged rates are secondary.
    window_steps = steps - len(runner.dataset)
    window_s = t_end - marks["after_epoch_0"]
    run_rate = window_steps * runner.dataset.total_pixels / window_s
    rates = [line["rays_per_sec"] for line in logged[5:]]
    bare = N_RAYS / step_ms * 1e3
    emit({"phase": "runner", "epochs": RUNNER_EPOCHS, "steps": steps,
          "rays_per_step": runner.dataset.total_pixels, "launches": launches,
          "seconds": seconds, "ms_per_step": seconds / steps * 1e3,
          "first5_loss": float(np.mean(losses[:5])),
          "last5_loss": float(np.mean(losses[-5:])),
          "fine_n_samples": runner.model.fine_n_samples,
          "resume_start_epoch": resumed_cfg.start_epoch,
          "resume_fine_n_samples": resumed.model.fine_n_samples,
          "run_window_steps": window_steps, "run_window_s": window_s,
          "run_ms_per_step": window_s / window_steps * 1e3,
          "run_rays_per_s": run_rate,
          "bare_step_rays_per_s": bare, "run_over_bare": run_rate / bare,
          "logged_rays_per_s_median": float(np.median(rates)),
          "logged_rays_per_s_min": float(np.min(rates)),
          "epoch_busy_share": busy["device_ms"] / (busy["seconds"] * 1e3),
          "epoch_seconds": busy["seconds"],
          "epoch_kernels": busy["kernels"], "peak_memory_gb": peak_gb})
    shutil.copy(Path(runner.run_dir) / "metrics.jsonl",
                OUT / "smoke_runner_metrics.jsonl")
    del runner, resumed
    return launches


def phase_eval():
    """``evaluate`` of the trained run's ``latest`` and ``0`` checkpoints:
    render-images (timed, launches counted), then metrics."""
    evals = str(RUN_DIR / "evals")
    scene = SyntheticBoxDataset()
    n_views, (h, w) = len(scene), scene.image_size
    chunks = n_views * -(-h * w // N_RAYS)
    expected = {"fused_mlp": 3 * chunks, "fused_ray_march": 2 * chunks,
                "ray_march_backward": 0}
    rows = {}
    for checkpoint in ("latest", "0"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        folder = Path(evaluate(scene_runner_config(checkpoint),
                               "render-images", 256, evals, N_RAYS, 0.05, 8))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check(launches == expected,
              f"eval {checkpoint} launches {launches}, expected {expected}")
        evaluate(scene_runner_config(checkpoint), "metrics", 256, evals,
                 N_RAYS, 0.05, 8)
        with open(folder / "metrics.json") as f:
            scores = json.load(f)
        missing = [n for i in range(n_views)
                   for n in (f"image-{i}.png", f"depth-{i}.npy")
                   if not (folder / "rendered_images" / n).exists()]
        check(not missing and len(scores) == n_views + 1,
              f"eval {checkpoint}: missing {missing} or per-image scores")
        rows[checkpoint] = dict(mean_psnr=scores["mean_psnr"],
                                seconds=seconds, launches=launches,
                                rays_per_s=n_views * h * w / seconds)
    check(rows["latest"]["mean_psnr"] > rows["0"]["mean_psnr"],
          f"eval: the trained checkpoint's mean PSNR "
          f"{rows['latest']['mean_psnr']} is not above epoch 0's "
          f"{rows['0']['mean_psnr']}")
    emit({"phase": "eval", "views": n_views, "chunks": chunks,
          "checkpoints": rows, "tail_chunk": hold_eval_tail_chunk()})
    return rows["latest"]["launches"]


def hold_eval_tail_chunk() -> dict:
    """The last chunk of view 0 (1,536 pixels in chunks of 1,024: 512 rays)
    through ``render_image`` of the ``latest`` eval model (fine count 45),
    against the port's plain path on the CPU."""
    cfg = scene_runner_config("latest")
    model, epoch = eval_model(cfg)
    dataset = dataset_dict[cfg.dataset_config.dataset_name](
        cfg.dataset_config)
    dataset.all_pixels = True
    model.near, model.far = dataset.get_bounds()
    batch = dataset[0]
    uv = batch["uv"][len(batch["uv"]) // N_RAYS * N_RAYS:]
    n = len(uv)
    check(n == 512 and model.fine_n_samples == 45,
          f"eval tail chunk: {n} rays at fine count {model.fine_n_samples}, "
          f"expected 512 at 45")
    statics = model.render_statics(white_background=dataset.white_bkgd)
    draw_state = model.generator.get_state()
    reset_launches()
    rgb, depth = model.render_image(uv, batch["pose"][0],
                                    batch["intrinsics"][0], epoch,
                                    dataset.white_bkgd, N_RAYS)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"fused_mlp": 3, "fused_ray_march": 2,
                       "ray_march_backward": 0},
          f"eval tail chunk launches {launches}, expected 3 MLP and 2 march")
    # The same rays and draws through render_rays on the card, for the
    # coarse argmax that chose each ray's fine branch.
    replay = torch.Generator(device=model.device)
    replay.set_state(draw_state)
    uv_t = model.to_device(uv)
    pose = model.to_device(batch["pose"][0]).reshape(4, 4).expand(n, 4, 4)
    intr = model.to_device(batch["intrinsics"][0]).reshape(4, 4).expand(
        n, 4, 4)
    out = render_rays(model.modules, uv_t, pose, intr, model.near, model.far,
                      model.to_device(model.window_weights), statics,
                      generator=replay)
    check(torch.equal(out["rgb"], rgb) and torch.equal(out["depth"], depth),
          "eval tail chunk: render_image differs from render_rays on the "
          "same rays and draws")
    share, errs, _ = hold_render(model, out, uv_t, pose, intr, statics,
                                 draw_state, "eval tail chunk")
    return {"rays": n, "samples": statics.n_coarse + statics.n_fine,
            "launches": launches, "argmax_agreement": share,
            "max_abs_err_vs_cpu_plain": errs, "tol": RENDER_TOL}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})

    t0 = time.perf_counter()
    lib = load_library()
    seconds = time.perf_counter() - t0
    regs = [line.strip() for line in lib.build_log.splitlines()
            if "registers" in line or "spill" in line]
    tensor_core = tensor_core_instructions(lib.path)
    mlp_tc = sum(c["HMMA"] + c["HGMMA"] for name, c in tensor_core.items()
                 if "fused_mlp" in name)
    check(mlp_tc > 0, "the fused MLP kernel's SASS has no HMMA / HGMMA")
    emit({"phase": "build", "seconds": seconds,
          "library": str(lib.path.relative_to(ROOT)), "ptxas": regs,
          "tensor_core_sass": tensor_core})

    model = build_model(dev)
    mlp = phase_mlp(model, dev)
    march = phase_march(model, dev)
    launches, render_ms = phase_render(model)
    phase_render_image(model)
    phase_profile(model, render_ms)
    mlp_train, march_bwd = phase_train_kernels(model, dev)
    train_launches, step_ms = phase_train_step(model, dev)
    del model
    torch.cuda.empty_cache()
    if RUN_DIR.exists():
        shutil.rmtree(RUN_DIR)
    RUN_DIR.mkdir(parents=True)
    pkl, vf_launches, _ = phase_vf_init(dev)
    runner_launches = phase_runner(pkl, step_ms)
    eval_launches = phase_eval()
    # The checkpoints and the VF init (~10 MB each) stay out of chiprun_out.
    shutil.rmtree(RUN_DIR / "exps")
    pkl.unlink()
    paths = {"runner": runner_launches, "train_step": train_launches,
             "render": launches, "vf_init": vf_launches,
             "eval": eval_launches}

    def launch_counts(name):
        """``launches``: this slice's main path, ``VectorFieldNerfRunner.
        train()``; ``launches_<path>``: each other path's run."""
        return dict(launches=paths["runner"][name],
                    **{f"launches_{path}": counts.get(name, 0)
                       for path, counts in paths.items() if path != "runner"})

    # Times, bounds and errors are at the render's shapes for the forward
    # kernels; the training step's save-mode times are ``train_ms`` (the
    # cuBLAS chain that keeps every hidden output: ``train_library_ms``).
    kernels = [
        dict(name="fused_mlp", route="cuda",
             source="vf_nerf_torch/csrc/fused_mlp.cu",
             replaces="vf_nerf_tpu/ops/fused_mlp.py:149",
             **launch_counts("fused_mlp"), bound_by="operations",
             train_ms=mlp_train["ms"], train_bound_ms=mlp_train["bound_ms"],
             train_library_ms=mlp_train["library_ms"], **mlp),
        dict(name="fused_ray_march", route="cuda",
             source="vf_nerf_torch/csrc/ray_march.cu",
             replaces="vf_nerf_tpu/ops/ray_march.py:234",
             **launch_counts("fused_ray_march"), bound_by="bytes",
             library_ms=None, **march),
        dict(name="ray_march_backward", route="cuda",
             source="vf_nerf_torch/csrc/ray_march.cu",
             replaces="vf_nerf_tpu/ops/ray_march.py:234",
             **launch_counts("ray_march_backward"), bound_by="bytes",
             library_ms=None, **march_bwd),
    ]
    result = {"kernels": kernels}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(result, render_ms=render_ms, train_step_ms=step_ms,
             nvidia_smi=smi, failures=failures), indent=1))
    if failures:
        print(f"chip_smoke: {len(failures)} checks failed: {failures}",
              file=sys.stderr)
        return 1
    emit(result)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
