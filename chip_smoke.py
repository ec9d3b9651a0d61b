#!/usr/bin/env python3
"""Drive vf_nerf_torch's eval render on one CUDA card and check its kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and nvcc; it builds the kernels from ``vf_nerf_torch/csrc`` on first
use.

Phases, each printing one JSON line:

1. device: the card, its power limit, TF32 off;
2. build: the nvcc build of both kernels and its seconds;
3. fused_mlp: the kernel against its plain version (``mlp_reference``) on
   the card at the render's shapes: the VF net on 102,400 and 133,120
   points (39 -> 259, skip at layer 4, tanh) and the colour net on 133,120
   x 289 -> 3 (sigmoid); kernel, plain and cuBLAS-chain times, FLOP bound;
4. fused_ray_march: the kernel against ``ray_march_reference`` at
   (1024, 100) and (1024, 130), back-face threshold -0.2 and -2, plus
   annealed taps on a white background; the kernel's time alone (``ms``),
   the wrapper's with its on-device scalar preparation (``wrapper_ms``),
   the plain version's, and the byte bound;
5. render: ``VectorFieldNerf.render`` of the shipped conf on the 1024 rays
   of ``__graft_entry__.entry`` (near 0, far 4): exactly 3 fused-MLP and 2
   ray-march launches, finite (1024, 3) / (1024, 1) outputs, agreement with
   the port's plain path on the CPU from the same weights and draws, and
   ms per render;
6. render_image on a small image through the facade;
7. profile: device time by kernel over 3 renders (``torch.profiler``), the
   full table in ``chiprun_out/profile_render.txt``.

Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` name and
power limit, and the last line ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero without that last line. Weights are the port's seeded
init with the VF kernels scaled by ``VF_GAIN``, so that the random field
flips along rays and both branches of the fine sampler occur.
"""

from __future__ import annotations

import copy
import json
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
from vf_nerf_torch.ops.fused_mlp import fused_mlp, mlp_reference
from vf_nerf_torch.ops.ray_march import (fused_ray_march, launch_ray_march,
                                         march_scalars, ray_march_reference,
                                         tap_coefficients)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
CONF = ROOT / "confs" / "vf_nerf.conf"
VF_GAIN = 3.5
N_RAYS = 1024
# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MLP_TOL = 1e-3      # max |kernel - plain| on tanh / sigmoid outputs in [-1, 1]
MARCH_TOL = dict(rtol=1e-4, atol=1e-5)
# The gained VF net amplifies f32 rounding (its f32 output is within ~5e-5
# of f64 on the CPU) and the density's slope reaches scale / (2 beta) = 100
# per unit cosine, so the render is held to looser bounds than one kernel.
RENDER_TOL = {"rgb": 2e-3, "depth": 2e-2}
MIN_ARGMAX_AGREEMENT = 0.99

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


def build_model(device) -> VectorFieldNerf:
    cfg = parse_config(scene="office0", config_path=str(CONF),
                       expname="graft").vf_nerf_config
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
    rows, totals = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                            bound_ms=0.0, max_abs_err=0.0)
    statics = model.render_statics()
    n_coarse = N_RAYS * statics.n_coarse
    n_all = N_RAYS * (statics.n_coarse + statics.n_fine)
    skip = model.modules.vf.skip_at
    cases = [("vf_coarse", vf_w, n_coarse, skip, "tanh"),
             ("vf_fine", vf_w, n_all, skip, "tanh"),
             ("colour", rn_w, n_all, None, "sigmoid")]
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
        macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
        flop = 2.0 * n * macs
        nbytes = 4.0 * (n * (x.shape[1] + weights[-1][0].shape[1]) +
                        sum(w.numel() + b.numel() for w, b in weights))
        bound = max(flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = dict(
            case=name, points=n, in_dim=x.shape[1],
            out_dim=weights[-1][0].shape[1], macs_per_point=macs,
            max_abs_err=err, tol=MLP_TOL,
            ms=cuda_ms(lambda: fused_mlp(weights, x, skip, act)),
            plain_ms=cuda_ms(lambda: mlp_reference(weights, x, skip, act)),
            library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip, act)),
            bound_ms=bound)
        row["tflops"] = flop / row["ms"] / 1e9
        rows.append(row)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            totals[k] += row[k]
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    emit({"phase": "fused_mlp", "cases": rows})
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
    params = DensityParams(*(torch.tensor(v, device=dev)
                             for v in (0.5, 100.0, 0.7)))
    uniform = torch.full((11,), 1.0 / 11, device=dev)
    annealed = torch.tensor([0.01, -0.02, 0.05, 0.1, 0.15, 0.4, 0.12, 0.08,
                             0.04, 0.02, 0.01], device=dev)
    statics = model.render_statics()
    s_coarse, s_all = statics.n_coarse, statics.n_coarse + statics.n_fine
    cases = [(s_coarse, -0.2, uniform, False),
             (s_coarse, -2.0, uniform, False),
             (s_all, -0.2, uniform, False), (s_all, -2.0, uniform, False),
             (s_all, -0.2, annealed, True)]
    rows, timed, max_err = [], {}, 0.0
    for s, th, taps, white in cases:
        normals, dirs, z, rgb = march_inputs(N_RAYS, s, s, dev)
        kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0,
                  mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=th,
                  normalize=True, white_background=white)
        out = fused_ray_march(normals, dirs, z, rgb, params, taps, **kw)
        ref = ray_march_reference(normals, dirs, z, rgb, params, taps, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("rgb", "depth", "weights"), out, ref):
            errs[name] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, **MARCH_TOL)),
                  f"fused_ray_march S={s} th={th} white={white} {name}: "
                  f"max abs err {errs[name]}")
        max_err = max(max_err, *errs.values())
        row = dict(samples=s, th=th, white=white, max_abs_err=errs,
                   tol=MARCH_TOL,
                   surface_rays=float((out[2].sum(1) > 0.5).float().mean()))
        if th == -2.0:  # the shipped threshold: time the render's shapes
            nbytes = 4.0 * (N_RAYS * s * 7 + N_RAYS * 3 + 11 + 5 +
                            N_RAYS * (s + 4))
            scalars = march_scalars(
                params, device=dev, beta_bounds=(1e-4, 1e9), scale_min=1.0,
                mean_bounds=(0.6, 1.0), cutoff=-0.5, dir_to_normal_th=th)
            coefs = tap_coefficients(taps)
            row.update(
                ms=cuda_ms(lambda: launch_ray_march(
                    normals, dirs, z, rgb, coefs, scalars, True, white),
                    iters=50),
                wrapper_ms=cuda_ms(lambda: fused_ray_march(
                    normals, dirs, z, rgb, params, taps, **kw), iters=50),
                plain_ms=cuda_ms(lambda: ray_march_reference(
                    normals, dirs, z, rgb, params, taps, **kw), iters=20),
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
    regs = [line.strip() for line in lib.build_log.splitlines()
            if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.path.relative_to(ROOT)), "ptxas": regs})

    model = build_model(dev)
    mlp = phase_mlp(model, dev)
    march = phase_march(model, dev)
    launches, render_ms = phase_render(model, dev)
    phase_render_image(model)
    phase_profile(model, render_ms)

    kernels = [
        dict(name="fused_mlp", route="cuda",
             source="vf_nerf_torch/csrc/fused_mlp.cu",
             replaces="vf_nerf_tpu/ops/fused_mlp.py:149",
             launches=launches["fused_mlp"], bound_by="operations", **mlp),
        dict(name="fused_ray_march", route="cuda",
             source="vf_nerf_torch/csrc/ray_march.cu",
             replaces="vf_nerf_tpu/ops/ray_march.py:234",
             launches=launches["fused_ray_march"], bound_by="bytes",
             library_ms=None, **march),
    ]
    result = {"kernels": kernels}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(result, render_ms=render_ms, nvidia_smi=smi,
             failures=failures), indent=1))
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
