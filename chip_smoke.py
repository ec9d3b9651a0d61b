#!/usr/bin/env python3
"""Drive vf_nerf_torch's eval render and training step on one CUDA card and
check their kernels.

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
   net, the colour net and the shell and
   ball VF nets, with the save mode's time, the cuBLAS backward products'
   and the plain forward + backward's; the ray-march backward kernel
   against autograd through ``ray_march_reference`` at (1024, 200),
   ``n_valid`` 130 and 200, a white background, a weights gradient and raw
   density parameters at their clamps (rtol 1e-4, atol 1e-5·max(1,
   max|g|)), one CUDA kernel per call, its device time, the plain
   version's and the byte bound;
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
   steps (``torch.profiler``, table in ``chiprun_out/profile_train.txt``).

Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
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
from vf_nerf_torch.kernels import load_library
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.renderer import draw_uniforms, render_rays
from vf_nerf_torch.ops.density import DensityParams
from vf_nerf_torch.ops.embedding import positional_encoding
from vf_nerf_torch.ops.fused_mlp import (fused_mlp, mlp_backward_reference,
                                         mlp_reference)
from vf_nerf_torch.ops.ray_march import (MarchStatics, fused_ray_march,
                                         ray_march_backward,
                                         ray_march_backward_reference,
                                         ray_march_reference)
from vf_nerf_torch.parallel import train_step as train

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


def kernels_per_call(fn, calls: int = 1):
    """(CUDA kernels enqueued, device ms per call, kernel names) of
    ``calls`` calls of ``fn``, by ``torch.profiler``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # The calls sit well inside the trace window: a kernel record at its very
    # edge can be dropped.
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.01)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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


def addmm_chain(weights, x, skip_at, final_act):
    """The cuBLAS yardstick: one addmm per layer with in-place ReLU."""
    h = x
    for i, (w, b) in enumerate(weights):
        if i == skip_at:
            h = torch.cat([h, x], 1).div_(2.0 ** 0.5)
        h = torch.addmm(b, h, w)
        if i < len(weights) - 1:
            h.relu_()
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


def phase_render(model, dev):
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

    # The port's plain path on the CPU from the same weights and draws.
    replay = torch.Generator(device=dev)
    replay.set_state(draw_state)
    draws = {k: v.cpu() for k, v in
             draw_uniforms(statics, N_RAYS, replay, dev).items()}
    cpu_modules = copy.deepcopy(model.modules).cpu()
    ref = render_rays(cpu_modules, torch.from_numpy(uv),
                      torch.from_numpy(pose), torch.from_numpy(intr),
                      model.near, model.far,
                      torch.from_numpy(model.window_weights), statics,
                      **draws)
    agree = (out["argmax_coarse"].cpu() == ref["argmax_coarse"])
    share = float(agree.float().mean())
    check(share >= MIN_ARGMAX_AGREEMENT,
          f"coarse argmax agreement {share} < {MIN_ARGMAX_AGREEMENT}")
    errs = {k: float((out[k].cpu()[agree] - ref[k][agree]).abs().max())
            for k in RENDER_TOL}
    for k, tol in RENDER_TOL.items():
        check(errs[k] <= tol, f"render {k} vs CPU plain path: {errs[k]}")

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
    """The plain forward's hidden activations, layer after layer."""
    h, hidden = x, []
    for i, (w, b) in enumerate(weights[:-1]):
        if i == skip_at:
            h = torch.cat([h, x], 1) / 2.0 ** 0.5
        h = torch.relu(h @ w + b)
        hidden.append(h)
    return torch.cat(hidden, 1)


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
    mlp_rows, totals = [], dict(ms=0.0, ms_no_save=0.0, backward_ms=0.0,
                                plain_ms=0.0, bound_ms=0.0,
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
        leaves = [(w.clone().requires_grad_(True),
                   b.clone().requires_grad_(True)) for w, b in weights]
        flat = [t for wb in leaves for t in wb]
        x_leaf = x.clone().requires_grad_(act == "sigmoid")
        with torch.no_grad():
            plain_out = fused_mlp(weights, x, skip_at, act)
        out = fused_mlp(leaves, x_leaf, skip_at, act)
        acts = out.grad_fn.saved_tensors[1]
        torch.cuda.synchronize()
        check(torch.equal(out.detach(), plain_out),
              f"fused_mlp {name}: the save-mode output differs from the "
              f"no-save launch")
        hidden = hidden_forward(weights, x, skip_at)
        acts_err = max_rel(acts, hidden)
        check(acts_err <= 1e-5, f"fused_mlp {name}: saved activations "
              f"{acts_err} from the plain forward's")
        # A pre-activation within the kernel's rounding of 0 flips its ReLU
        # against the plain chain's and changes that point's gradients
        # (weight gradients are sums over points, so a few flipped points
        # show at ~1/sqrt(N)); the upstream gradient is zero on them.
        same = ((acts > 0) == (hidden > 0)).all(1)
        agree = float(same.float().mean())
        dy = torch.randn(out.shape, generator=gen, device=dev) * same[:, None]
        inputs = flat + ([x_leaf] if x_leaf.requires_grad else [])
        got = torch.autograd.grad(out, inputs, dy)
        ref = torch.autograd.grad(mlp_reference(leaves, x_leaf, skip_at, act),
                                  inputs, dy)
        err = max(max_rel(g, r) for g, r in zip(got, ref))
        check(err <= MLP_GRAD_TOL and agree >= 0.99,
              f"FusedMLP {name}: gradient error {err} (limit "
              f"{MLP_GRAD_TOL}), ReLU masks agree on {agree} of the points")
        del got, ref, out
        # Times: the save-mode launch, the no-save launch, the backward's
        # cuBLAS products from the saved activations, and the plain
        # forward + backward by autograd.
        need_dx = act == "sigmoid"
        y = plain_out
        row = dict(
            case=name, points=n, max_rel_grad_err=err,
            relu_mask_agreement=agree, acts_max_rel_err=acts_err,
            ms=cuda_ms(lambda: fused_mlp(leaves, x_leaf, skip_at, act),
                       iters=5),
            ms_no_save=cuda_ms(lambda: fused_mlp(weights, x, skip_at, act),
                               iters=5),
            backward_ms=cuda_ms(lambda: mlp_backward_reference(
                weights, x, acts, y, dy, skip_at, act, need_dx=need_dx),
                iters=5),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(
                mlp_reference(leaves, x_leaf, skip_at, act), inputs, dy),
                iters=3))
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
        mlp_rows.append(row)
        for k in ("ms", "ms_no_save", "backward_ms", "plain_ms", "bound_ms",
                  "backward_bound_ms"):
            totals[k] += row[k]
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        del acts, leaves, flat, x_leaf, inputs
        torch.cuda.empty_cache()

    # The ray march's backward.
    uniform = torch.full((11,), 1.0 / 11, device=dev)
    annealed = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08,
                             0.04, 0.02, 0.01], device=dev)
    s_pad = statics.n_coarse + statics.n_fine
    n_valid = statics.n_coarse + N_FINE_ACTIVE
    shipped = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0,
                   mean_bounds=(0.6, 1.0), cutoff=-0.5)
    # (n_valid, taps, white, weights gradient, clamped scalars, th)
    cases = [(n_valid, uniform, False, False, (0.5, 100.0, 0.7), -2.0),
             (s_pad, uniform, False, False, (0.5, 100.0, 0.7), -2.0),
             (n_valid, annealed, True, True, (0.5, 100.0, 0.7), -0.2),
             (n_valid, uniform, False, True, (0.3, 1.0, 0.6), -0.2)]
    march_rows, timed = [], None
    for live, taps, white, w_grad, scal, th in cases:
        normals, dirs, z, rgb = march_inputs(N_RAYS, s_pad, 7, dev)
        bounds = dict(shipped, beta_bounds=(0.3, 1e9)) \
            if scal[0] == 0.3 else shipped
        st = MarchStatics(bounds["beta_bounds"], 1.0, (0.6, 1.0), -0.5, th,
                          True, white, live)
        scalars = torch.tensor(scal, device=dev)
        g_rgb = torch.randn((N_RAYS, 3), generator=gen, device=dev)
        g_depth = torch.randn((N_RAYS,), generator=gen, device=dev)
        g_w = torch.randn((N_RAYS, s_pad), generator=gen, device=dev) \
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
                  f"ray_march_backward n_valid={live} white={white} "
                  f"weights_grad={w_grad} scalars={scal} {name}: max abs err "
                  f"{errs[name]} (atol {atol})")
        n_kernels, device_ms, names = kernels_per_call(
            lambda: ray_march_backward(*args), calls=20)
        check(n_kernels == 20, f"ray_march_backward: 20 calls enqueued "
              f"{n_kernels} kernels {names}")
        row = dict(n_valid=live, samples=s_pad, white=white,
                   weights_grad=w_grad, scalars=scal, th=th,
                   max_abs_err=errs, ms=device_ms)
        if timed is None:
            nbytes = 4.0 * (N_RAYS * s_pad * (3 + 1 + 3) + N_RAYS * 3 +
                            N_RAYS * 4 + 11 + 3 +
                            N_RAYS * s_pad * 6 + N_RAYS * 3)
            row.update(
                wrapper_ms=cuda_ms(lambda: ray_march_backward(*args),
                                   iters=50),
                plain_ms=cuda_ms(lambda: ray_march_backward_reference(*args),
                                 iters=10),
                bound_ms=nbytes / PEAK_BYTES * 1e3, bytes=nbytes)
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
    launches, render_ms = phase_render(model, dev)
    phase_render_image(model)
    phase_profile(model, render_ms)
    mlp_train, march_bwd = phase_train_kernels(model, dev)
    train_launches, step_ms = phase_train_step(model, dev)

    # ``launches``: the training step's (this slice's main path);
    # ``launches_render``: the eval render's. Times, bounds and errors are
    # at the render's shapes for the forward kernels (the training step's
    # save-mode times are ``train_ms`` and the phase lines).
    kernels = [
        dict(name="fused_mlp", route="cuda",
             source="vf_nerf_torch/csrc/fused_mlp.cu",
             replaces="vf_nerf_tpu/ops/fused_mlp.py:149",
             launches=train_launches["fused_mlp"],
             launches_render=launches["fused_mlp"], bound_by="operations",
             train_ms=mlp_train["ms"], train_bound_ms=mlp_train["bound_ms"],
             **mlp),
        dict(name="fused_ray_march", route="cuda",
             source="vf_nerf_torch/csrc/ray_march.cu",
             replaces="vf_nerf_tpu/ops/ray_march.py:234",
             launches=train_launches["fused_ray_march"],
             launches_render=launches["fused_ray_march"], bound_by="bytes",
             library_ms=None, **march),
        dict(name="ray_march_backward", route="cuda",
             source="vf_nerf_torch/csrc/ray_march.cu",
             replaces="vf_nerf_tpu/ops/ray_march.py:234",
             launches=train_launches["ray_march_backward"],
             launches_render=0, bound_by="bytes", library_ms=None,
             **march_bwd),
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
