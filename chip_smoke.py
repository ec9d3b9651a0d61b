#!/usr/bin/env python3
"""Drive vf_nerf_torch's eval render, training step, VF init, training
runner, image evaluation, mesh stack, Replica/ScanNet loaders, joint
pose-and-field stage, unfolded training modes, the office reconstruction
protocol and data parallelism on one CUDA card, and check their kernels.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc and g++; it builds the kernels and the host libraries from
``vf_nerf_torch/csrc`` on first use.

Phases, each printing one JSON line:

1. device: the card, its power limit, TF32 off;
2. build: the nvcc build of both kernels and its seconds, registers and
   spills from ``ptxas -v``, and the tensor-core instructions (``HMMA`` /
   ``HGMMA``) in each kernel's SASS (``cuobjdump -sass``): the fused MLP
   must have some, and ``ptxas`` must report no spill and no serialised
   ``wgmma`` in ``fused_mlp.cu``;
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
   the descent check: 20 steps on one batch from the un-gained seeded init
   and from two copies with every weight scaled by (1 ± 2^-23), at a
   quarter of the shipped learning rate, all three descending by a margin
   at least 5x the spread of their last-5 means; ms per step and rays/s
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
   synthetic box scene (8 views of 32 x 48, 1024 rays per step) for 240
   epochs (``RUNNER_EPOCHS``: the joint stage of phase 15 needs that field)
   with a save every 20, from the phase-10 init: 5 / 2 / 1 launches
   per step, the loss of the last 5 epochs below the first 5's, the
   checkpoints, ``metrics.jsonl`` and ``convergence.json``, the fine count
   55; a resume from ``latest`` at epoch 241 with the fine count 75 and the
   state equal bit for bit; the run rate (every step after epoch 0 over the
   wall time from the end of epoch 0 to the final synchronize, saves
   included) against phase 9's bare step, the logged per-epoch rates, the
   device's busy share over one more epoch and peak memory;
12. eval: ``evaluate`` (render-images, then metrics) of the ``latest`` and
   ``0`` checkpoints: the images, depths and ``metrics.json``, 3 MLP and 2
   march launches per chunk, the trained mean PSNR above epoch 0's, and the
   eval's rays/s; then the 512-ray tail chunk of a view through
   ``render_image`` of the ``latest`` eval model (fine count 75, so 175
   samples) against the port's plain path on the CPU, as in phase 5;
13. mesh: the box scene's GT mesh written with ``save_ply`` where
   ``_gt_mesh_path`` reads it; ``evaluate(..., "quadrant-marching-cubes-
   mesh", 256, num_quadrants=8)`` of ``latest`` (three variants: exactly
   3 x 8 x ceil(256^3 / GRID_CHUNK) fused-MLP launches and no ray march),
   plain MC of ``latest`` at res 256, the plain quadrant merge of ``0``,
   then ``tsdf-mesh`` and ``3d-metrics`` (1 M samples for ``latest``,
   ``EPOCH0_METRIC_SAMPLES`` for ``0``) of both and the quadrant merge's
   F-score (``metrics_3d_no_vf`` without ICP): every
   artifact and JSON key, non-empty meshes, both trained F-scores above
   epoch 0's; seconds per octant of the device stages and of the host
   tail, the host tail's share hidden behind the next octant, peak memory,
   cells and faces; the grid chunk through the kernel against
   ``mlp_reference`` (``MLP_TOL``) with its ms per 1 M points beside the
   3xTF32 bound and the cuBLAS chain; one res-64 octant of ``latest`` on
   the card against the CPU plain MLP (vertex counts within 2 %, median
   nearest-neighbour distance < 1e-5, max < 2 voxels);
14. loaders: the port's exporters write the office (24 views of 240 x 320,
   ``tools/office_protocol.py``'s defaults) in Replica's layout and the box
   in ScanNet's (``frame_stride`` 40); ``dataset_dict`` reads both back:
   depths (as the 16-bit PNGs hold them), poses and intrinsics exactly,
   the decoded colour at >= 40 dB PSNR against the source's uint8 frames,
   the centroid and scale as the mesh helpers give them; the seconds per
   frame of the JPEG encoder and of the decoder (``csrc/jpeg.cpp``) and the
   decoder's MB/s; then 5 epochs of the runner with the shipped conf on
   the Replica-format office (5 / 2 / 1 launches per step, the last
   epoch's loss below the first's);
15. joint: ``JointOptimizationRunner`` from phase 11's ``latest`` at the
   efficacy study's settings (``results/joint_efficacy_r5.json``,
   "anchored"): one step's wrapper launches and CUDA kernels, 3 fused MLP,
   2 ray march and 1 march backward, in the pose-only and the joint
   optimizer; the joint loss and every gradient (field and poses) of 128
   of the step's rays against the CPU plain path in float64 (within
   1e-2·max|g|: the card's ReLU flips move weight gradients by ~1e-3);
   ``FusedMLP`` with the VF net's ``dx`` (and the colour net's)
   at the step's fine points against autograd through ``mlp_reference``
   (``MLP_GRAD_TOL``, masks as in phase 8); the poses of views 1-7
   perturbed by 1.5 deg and 0.02 (seed 0), 100 pose-only and 50 joint
   epochs (3 / 2 / 1 launches per step), pose 0 unchanged and the mean
   rotation error at most half its start (the translation error printed
   beside JAX's 0.020 -> 0.030, not checked); ms per step of each phase,
   rays/s, the busy share over one more epoch; then two 2-epoch runs with
   a supervision block every epoch, self-supervised and with the bases
   from a res-128 marching-cubes mesh, all finite, their seconds;
16. train_modes: the unfolded training modes of the shipped conf at its
   widths, 1024 rays, perturb and supervision on, the directional-
   derivative (DD) weight 0.1 from epoch 0: analytic DD (train-mode
   BatchNorm, 100 + 30 samples unpadded: 0 fused-MLP, 2 march and 1 march-
   backward launches per step), numerical DD (frozen BatchNorm: 11 / 2 /
   1), weight norm and ``rendering = "nerf"`` (static growth, 200 padded
   samples with 30 live: 5 / 2 / 1 and 5 / 0 / 0): per mode the exact
   launches and CUDA kernels of one step; the loss, every gradient and the
   running-statistic updates of a 256-ray step against the CPU plain path
   in float32 and float64 (the loss as phase 9 holds it, or for the
   numerical Jacobian within twice the CPU float32 path's distance from
   float64; each gradient and statistic within max(1e-3, ``MODE_SPREAD``
   = 2 x the CPU float32 path's worst distance) of float64; gradients that
   are zero in exact arithmetic, the biases before a train-mode BatchNorm,
   within 1e-6 of the largest); ms per step,
   rays/s, peak memory, busy share over 3 steps. Then the march and its
   backward at (1024, 130 / 155 / 200) with ``n_valid`` None and
   ``FusedMLP`` under the weight-norm fold (204,800 points), the frozen
   fold (133,120) and at the joint step's 158,720 points, each against its
   plain version with its times and bound; then ``VectorFieldNerfRunner``
   with analytic DD on the box scene from phase 10's init for 10 epochs,
   the fine count +5 at epochs 0 and 5 (0 / 2 / 1 launches per step, the
   last 3 epochs' loss below the first 3's, the running statistics moved
   and finite, a resume from ``latest`` equal bit for bit).
17. protocol, run after phase 14: ``tools/torch_office_protocol.py``'s
   ``main`` in this process on the office at full-size frames (240 x 320),
   6 views, 10 epochs, clamp 3.0, quadrant MC (plain) at res 128 x 8 and
   3D metrics on 200,000 samples, then ``tools/torch_office_attribution.py``
   on its workdir: every key of ``results/office_r5.json``'s headline in
   ``office.json`` and finite, the group PSNRs, the last epoch's loss below
   the first's, a non-empty merged mesh with its F-score, the attribution's
   keys; the launches of each stage (VF init 800 / 0 / 0, 5 / 2 / 1 per
   training step, 3 / 2 / 0 per eval chunk, none in ``3d-metrics``, 8 x
   ceil(128^3 / GRID_CHUNK) = 16 grid launches and no march for the MC);
   one training step of the shipped conf at the fine count 100 (all 200
   padded samples live, the count of the full run from epoch 700) held as
   in phase 9 but within ``MODE_SPREAD`` x the CPU float32 path's distance,
   as phase 16 holds its steps (phase 9's 1 x is read, not held, here and
   on a copy with every weight x (1 + 2^-23)), and 1024 rays spread over a
   view of the trained office through ``render_image`` at 200 samples held
   as in phase 12; the march and its backward at (1024, 200) with their
   times; the phase's seconds and each stage's.
18. parallel: data parallelism on the one card. (a) Two gloo ranks
   sharing it (NCCL refuses two ranks on one GPU), spawned through
   ``parallel/multihost.py::spawn``, each on its half of phase 9's step
   (1024 rays, 512 per rank) and of phase 16's analytic DD step (256 rays,
   train-mode BatchNorm): exactly 5 / 2 / 1 (DD: 0 / 2 / 1) launches per
   rank; against one process on the card from the same weights and global
   draws, the loss within 1e-5 relative, the running statistics within
   1e-5 relative, both ranks' states equal. Phase 9's step: the summed
   gradients within 1e-4·max|g| per tensor and the parameters after the
   step within 1e-5. The DD step (``dd_step_hold``; its f32 chain lies
   ~2e-2 of max|g| from float64) against a control, one process from a
   one-ulp copy of the weights: the summed gradients within 2 x the
   control's distance from one process's; the parameters within 1e-5
   outside the elements whose float64 gradient is at most 2 x the f32
   distance, where Adam's first step turns rounding into ±lr (``ROADMAP.md``
   §C), and the control's step moves none by more outside them; the gap
   outside only the biases before a BatchNorm is reported for both (it
   misses 1e-5). ms per step of the pair and of one process, the gloo
   all-reduce of the flat gradient.
   (b) ``VectorFieldNerfRunner`` for 3 box epochs spawned as one NCCL rank
   (``exp_runner``'s launch path) against the runner in this process, and
   that run against a second one (the control): losses and ``latest``'s
   weights bit for bit. (c) The 1024-ray render and the res-128 x 8
   quadrant MC over ``[cuda:0, cuda:0]`` (``enable_mesh_eval``, each slot
   its own thread and stream) bit-equal to one slot; over ``[cuda:0,
   cpu]`` (a weight replica on the CPU, refreshed by ``sync_replicas``
   after a weight change) the card's rays and octants (res 48) bit-equal
   to one device, the CPU's held as phases 5 and 13 hold the plain path.
19. reuse_coarse: ``VectorFieldNerf.render`` with ``reuse_coarse`` on the
   1024 entry rays: exactly 3 fused-MLP and 2 ray-march launches (the
   coarse VF over 102,400 points keeping all 259 outputs, the extra depths'
   VF over 30,720, the colour net over 133,120), rgb and depth held to the
   port's plain CPU path (phase 5's limits) and to the recompute render on
   the card from the same draws; ms per render of both in alternating
   blocks; each launch against its plain version with its device ms,
   bound and cuBLAS chain; the reorder's ms.
20. options: (a) a data-parallel rank's launches at 512 of the step's 1024
   rays timed one at a time (phase 18's ranks share the card): the coarse
   VF, the fine VF and colour net in save mode, the shell VF, the march and
   its backward, each with its bound and cuBLAS chain; (b)
   ``compute_dtype = "bfloat16"``: the train-mode-BatchNorm step and the
   analytic DD step beside float32 (finite, parameters float32, ms and peak
   memory; the bf16 loss on 256 rays held as the CPU test holds the port
   to JAX, the limits from the CPU bf16 path alone: farther from float64
   than the card's float32 loss, within 2 × the CPU's distance from
   float64, and within that distance of the CPU's loss), the folded
   render in bf16 bit-equal to float32 with
   the same 3 + 2 launches; (c) the production step under ``train_remat``
   "none", "full" and "dots": gradients within 1e-6·max|g| of "none"'s,
   ms per step and peak memory of each; (d) LPIPS from a generated npz on
   the card against the CPU within 1e-5.
   Phases 10-20 write under ``build/smoke_run`` and delete it at the end.

``python3 chip_smoke.py --train-modes`` runs the build, phase 10 and phase
16 alone (``chiprun_out/train_modes.json``); ``--protocol`` the build and
phase 17 (``chiprun_out/protocol.json``); ``--parallel`` the build and
phase 18 (``chiprun_out/parallel.json``); ``--options`` the build and
phases 19 and 20 (``chiprun_out/options.json``).

``python3 chip_smoke.py --joint-scan [--epochs 60 120 240 480] [--scene
smoke|efficacy] [--resume-at N] [--seeds 0 1 ...]`` runs a study instead:
phase 10's VF init, the box scene trained through ``VectorFieldNerfRunner``
for the largest epoch count (with ``--resume-at``, N epochs and then a
resume from ``latest``) with a checkpoint after each listed count, and from
each, per perturbation seed, phase 15's efficacy run; one JSON line each
(the pose errors before and after, the loss and mean rotation error every
10 joint epochs). ``efficacy`` is the box of ``tools/joint_efficacy.py``
(6 views of 96 x 128).

Then the script's seconds, the ``{"kernels": [...]}`` line (``launches``:
the runner's, with each other path's as ``launches_<path>``, the loaders'
runner and the joint run among them; the fused MLP's
``mesh_*_per_1m_points`` at the grid chunk), the card's ``nvidia-smi`` name and
power limit, and the last line ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero without that last line. Weights are the port's seeded
init with the VF kernels scaled by ``VF_GAIN``, so that the random field
flips along rays and both branches of the fine sampler occur.
"""

from __future__ import annotations

import argparse
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
from vf_nerf_torch.config.joint_parser import \
    parse_config as parse_joint_config
from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets.synthetic import (SyntheticBoxDataset,
                                              SyntheticOfficeDataset)
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.evaluation import methods
from vf_nerf_torch.evaluation.evaluate import eval_model, evaluate
from vf_nerf_torch.evaluation.mc.device_pipeline import (GRID_CHUNK,
                                                         DeviceMeshExtractor,
                                                         grid_points)
from vf_nerf_torch.evaluation.mc.pipeline import quadrant_translations
from vf_nerf_torch.kernels import load_library
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.models.networks import WeightNormLinear, dense_and_norm
from vf_nerf_torch.models.renderer import (_reuse_coarse, draw_uniforms,
                                           render_rays)
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
from vf_nerf_torch.ops.rays import (get_ray_directions_and_cam_location,
                                    matrix_to_pose7)
from vf_nerf_torch.parallel import train_step as train
from vf_nerf_torch.train.joint_runner import JointOptimizationRunner
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.train.vf_init import (default_vf_config, fit_vf_init,
                                         save_vf_init)
from vf_nerf_torch.utils.jpeg import decode_jpeg, encode_jpeg
from vf_nerf_torch.utils.meshes import mesh_bounds, mesh_centroid
from vf_nerf_torch.utils.ply import load_ply, save_ply

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
# 240 epochs: the joint stage (phase 15) starts from this run's field, and
# from 60 or 120 main epochs its efficacy run diverged on the card (mean
# rotation error 25.8 and 21.6 deg from 1.5; ``--joint-scan``).
RUNNER_EPOCHS = 240
# Checkpoints, depth maps and meshes of phases 10-13 (deleted at the end);
# what is kept goes to OUT.
RUN_DIR = ROOT / "build" / "smoke_run"
# Mesh phase: quadrant MC at res 256 x 8 octants (the setting of
# results/office_r5.json), and one octant at res 64 held to the CPU.
MESH_RES = 256
HOLD_RES = 64
# The epoch-0 checkpoint's noisy meshes are scored on 200,000 surface
# samples, not 1 M: only its F-scores' gap to the trained ones is checked
# (0.12 / 0.13 against 0.65 / 0.81), and at 1 M their host scoring took
# 200 of the script's 566 s.
EPOCH0_METRIC_SAMPLES = 200_000
# Gradients, as max |Δg| / max |g| per tensor: FusedMLP against autograd
# through mlp_reference on the card; the step against the CPU plain path in
# float64, within GRAD_TOL or the CPU float32 path's own worst distance from
# float64 over all tensors (with the VF kernels gained by 3.5 no f32 chain
# meets 1e-3: the CPU's misses float64 by ~3e-2 on its worst tensor).
MLP_GRAD_TOL = 1e-4
GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4
# Descent: steps on one batch, the least descent margin over the spread
# that one float32 ulp of the weights gives, and the learning rate's scale.
# At the shipped 5e-4 every start tried on the H100 (the seeded init of
# seeds 0 and 1, gained or not, the VF init; the entry batch or a box-scene
# batch) spiked after ~10 steps, where Adam's normalized updates had turned
# the one-ulp difference into steps of ±lr: margin / spread 0.9 at best. At
# a quarter of it the three runs descend together (ratio ~2e5).
DESCENT_STEPS = 20
DESCENT_MARGIN = 5.0
DESCENT_LR_SCALE = 0.25

failures = []
T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(what: str) -> None:
    """A step of a long phase, with the script's seconds, on stderr."""
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s: {what}",
          file=sys.stderr, flush=True)


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


def fused_mlp_ptxas(build_log: str) -> list:
    """The lines ``ptxas`` printed for ``fused_mlp.cu`` in the build log
    (one ``== <source>`` section per source)."""
    sections = re.split(r"^== ", build_log, flags=re.M)
    return [line.strip() for sec in sections
            if sec.startswith("fused_mlp.cu") for line in sec.splitlines()[1:]
            if line.strip()]


def check_fused_mlp_build(lines: list) -> None:
    """Both instantiations of the fused MLP must keep every value in
    registers and every wgmma in flight: no spill, no "wgmma ... serialized"
    performance warning."""
    check(bool(lines), "the build log has no ptxas lines for fused_mlp.cu")
    spills = [ln for ln in lines
              if re.search(r"\b[1-9]\d* bytes spill (stores|loads)", ln)]
    check(not spills, f"fused_mlp.cu spills registers: {spills}")
    serial = [ln for ln in lines if "serialized" in ln]
    check(not serial, f"ptxas serialises fused_mlp.cu's wgmma: {serial}")


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


def gain_vf(model: VectorFieldNerf, gain: float) -> None:
    """Scale the VF net's kernels by ``gain`` (under weight norm, its
    ``g``)."""
    with torch.no_grad():
        for layer in model.modules.vf.layers:
            dense, _ = dense_and_norm(layer)
            if isinstance(dense, WeightNormLinear):
                dense.weight_g.mul_(gain)
            else:
                dense.weight.mul_(gain)


def build_model(device) -> VectorFieldNerf:
    cfg = runner_config().vf_nerf_config
    model = VectorFieldNerf(cfg, seed=0, device=device)
    gain_vf(model, VF_GAIN)
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


def mlp_inputs(model, weights, n, act, gen):
    """``n`` inputs of a net: the VF net's (tanh) positional encodings of
    points in [-1, 1]^3, the colour net's uniform in [-1, 1]."""
    dev = weights[0][0].device
    if act == "tanh":
        pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        return positional_encoding(
            pts, model.config.vf_net_config.embedder_multires).contiguous()
    return torch.rand((n, weights[0][0].shape[0]), generator=gen,
                      device=dev) * 2 - 1


def forward_case(name, weights, x, skip, act, count_kernels=True) -> dict:
    """The fused MLP's no-save launch on ``x`` against its plain version
    (``MLP_TOL``), its time beside the plain version's and the cuBLAS
    ``addmm`` chain's, and its 3xTF32 and f32-FMA bounds (each the larger
    of the FLOP and the byte time). With ``count_kernels`` one call must
    enqueue one CUDA kernel (``torch.profiler``, phase 3); without (phases
    19 and 20, late in the script, where the profiler keeps no record of
    these launches), the device time is ``queued_ms``'s."""
    n = x.shape[0]
    out = fused_mlp(weights, x, skip_at=skip, final_act=act)
    ref = mlp_reference(weights, x, skip, act)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    finite = bool(torch.isfinite(out).all())
    check(finite and err <= MLP_TOL,
          f"fused_mlp {name}: max abs err {err} > {MLP_TOL}")
    if count_kernels:
        n_kernels, device_ms, names = kernels_per_call(
            lambda: fused_mlp(weights, x, skip, act))
        check(n_kernels == 1,
              f"fused_mlp {name}: one call enqueued {n_kernels} kernels "
              f"{names}")
    else:
        n_kernels = None
        device_ms = queued_ms(lambda: fused_mlp(weights, x, skip, act),
                              calls=20)
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
    flop = 2.0 * n * macs
    nbytes = 4.0 * (n * (x.shape[1] + weights[-1][0].shape[1]) +
                    sum(w.numel() + b.numel() for w, b in weights))
    byte_ms = nbytes / PEAK_BYTES * 1e3
    row = dict(
        case=name, points=n, in_dim=x.shape[1],
        out_dim=weights[-1][0].shape[1], macs_per_point=macs, flop=flop,
        max_abs_err=err, tol=MLP_TOL, kernels_per_call=n_kernels,
        device_ms=device_ms,
        ms=cuda_ms(lambda: fused_mlp(weights, x, skip, act)),
        plain_ms=cuda_ms(lambda: mlp_reference(weights, x, skip, act)),
        library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip, act)),
        bound_ms=max(3 * flop / PEAK_TF32_FLOPS * 1e3, byte_ms),
        bound_f32_fma_ms=max(flop / PEAK_F32_FLOPS * 1e3, byte_ms))
    row["tflops_f32_equivalent"] = flop / row["ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


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
        x = mlp_inputs(model, weights, n, act, gen)
        row = forward_case(name, weights, x, skip, act)
        rows.append(row)
        flop_total += row["flop"]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_f32_fma_ms"):
            totals[k] += row[k]
        totals["max_abs_err"] = max(totals["max_abs_err"],
                                    row["max_abs_err"])
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


def hold_fused_mlp_training(name, weights, x, skip_at, act, gen,
                            need_dx=None) -> dict:
    """``FusedMLP`` (the save-mode launch) on ``x`` against the plain
    version: its output against the no-save launch bit for bit, its saved
    activations against the plain forward's, and its gradients against
    autograd through ``mlp_reference`` within ``MLP_GRAD_TOL``, the input's
    ``dx`` among them when ``need_dx`` (default: the colour net's). Returns
    the errors and the case's tensors (``leaves``, ``x_leaf``, ``inputs``,
    ``acts``, the output ``y`` and the upstream gradient ``dy``)."""
    leaves = [(w.clone().requires_grad_(True),
               b.clone().requires_grad_(True)) for w, b in weights]
    flat = [t for wb in leaves for t in wb]
    need_dx = act == "sigmoid" if need_dx is None else need_dx
    x_leaf = x.clone().requires_grad_(need_dx)
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
    dx_err = max_rel(got[-1], ref[-1]) if need_dx else None
    check(err <= MLP_GRAD_TOL and agree >= 0.99,
          f"FusedMLP {name}: gradient error {err} (limit {MLP_GRAD_TOL}), "
          f"ReLU masks agree on {agree} of the points")
    return dict(max_rel_grad_err=err, dx_max_rel_err=dx_err,
                relu_mask_agreement=agree,
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


def descent_runs(dev, batch, near: float = 0.0, far: float = 4.0,
                 seed: int = 0, gain: float = 1.0, pkl=None,
                 lr_scale: float = DESCENT_LR_SCALE,
                 steps: int = DESCENT_STEPS) -> dict:
    """``steps`` training steps of the shipped conf on ``batch`` from the
    seeded init of ``seed`` (its VF kernels × ``gain``, or the VF init
    ``pkl``) and from two copies with every weight scaled by (1 ± 2^-23),
    each with the draws of a fresh facade of ``seed`` and the learning rate
    × ``lr_scale``: each run's losses and margin (the mean of the first 5
    minus the last 5's), the spread of the three last-5 means, the least
    margin over it, and the first step whose losses differ."""
    runs = {}
    for name, factor in (("init", 1.0), ("plus_ulp", 1 + 2 ** -23),
                         ("minus_ulp", 1 - 2 ** -23)):
        model = VectorFieldNerf(runner_config().vf_nerf_config, seed=seed,
                                device=dev)
        if pkl is not None:
            model.load_vf_init(str(pkl))
        model.optimizer.schedule.lr *= lr_scale
        gain_vf(model, gain)
        with torch.no_grad():
            for p in model.modules.parameters():
                p.mul_(factor)
        run, statics, sup = train_statics(model)
        taps = torch.from_numpy(model.update_annealing(0)).to(dev)
        step = train.make_train_step(model.modules, model.optimizer, statics,
                                     sup, run.vf_loss_weights,
                                     run.vf_loss_config)
        losses = [float(step(train.zero_metric_sums(dev), batch, 0, taps,
                             near, far, torch.zeros(3, device=dev),
                             n_fine_active=N_FINE_ACTIVE,
                             generator=model.generator)["loss"])
                  for _ in range(steps)]
        runs[name] = dict(losses=losses, first5=float(np.mean(losses[:5])),
                          last5=float(np.mean(losses[-5:])))
        runs[name]["margin"] = runs[name]["first5"] - runs[name]["last5"]
        del model, step
    torch.cuda.empty_cache()
    last5 = [r["last5"] for r in runs.values()]
    spread = max(last5) - min(last5)
    margin = min(r["margin"] for r in runs.values())
    differ = next((i for i in range(steps)
                   if len({r["losses"][i] for r in runs.values()}) > 1), None)
    return dict(runs=runs, least_margin=margin, spread=spread,
                margin_over_spread=margin / spread if spread else None,
                first_differing_step=differ)


def descent_check(dev, batch) -> dict:
    """``descent_runs`` from the un-gained seeded init at the defaults:
    all three runs must descend, by a margin at least ``DESCENT_MARGIN``
    times their spread. The spread is what float32 drift alone moves the
    result by, so a kernel change that regroups a sum cannot flip the
    check."""
    result = descent_runs(dev, batch)
    finite = all(np.isfinite(r["losses"]).all()
                 for r in result["runs"].values())
    margin, spread = result["least_margin"], result["spread"]
    check(finite and margin > 0 and margin >= DESCENT_MARGIN * spread,
          f"descent over {DESCENT_STEPS} steps: margins "
          f"{[r['margin'] for r in result['runs'].values()]}, spread of the "
          f"last-5 means {spread} (need every margin > 0 and the least >= "
          f"{DESCENT_MARGIN} x the spread)")
    return result


def hold_train_step(model, dev, n_fine_active: int,
                    spread: float = 1.0) -> dict:
    """One loss of the shipped conf's training step with ``n_fine_active``
    live fine samples of the padded axis, and its gradients, on the card
    against the port's plain path on the CPU in float32 and float64 from the
    same weights and draws: the loss within ``TRAIN_LOSS_RTOL`` of the CPU
    float32 path, each gradient within max(``GRAD_TOL``, ``spread`` x the CPU
    float32 path's worst distance) of float64 (phase 9's rule at
    ``spread`` 1)."""
    run, statics, sup = train_statics(model)
    weights, loss_cfg = run.vf_loss_weights, run.vf_loss_config
    batch = train_batch(dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    centroid = torch.zeros(3, device=dev)
    near, far = model.near, model.far
    n_points_active = (N_RAYS * (statics.n_coarse + n_fine_active)) // 10
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
            near, far, centroid.to(d, dt), n_fine_active, n_points_active)
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
    limit = max(GRAD_TOL, spread * f32_spread)
    over = {n: r for n, r in grad_rows.items() if r["card_vs_f64"] > limit}
    worst = max(grad_rows, key=lambda n: grad_rows[n]["card_vs_f64"])
    what = f"train step at fine count {n_fine_active}"
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"{what}: loss {loss} vs CPU plain path {cpu_loss}")
    check(not over, f"{what}: gradients farther from float64 than allowed: "
          f"{over}")
    del results
    torch.cuda.empty_cache()
    return {"samples": statics.n_coarse + statics.n_fine,
            "n_valid": statics.n_coarse + n_fine_active,
            "loss": loss, "cpu_loss": cpu_loss, "parts": parts,
            "cpu_parts": cpu_parts,
            "argmax_agreement": float((argmax == cpu_argmax).float().mean()),
            "worst_grad": worst, "worst_grad_errs": grad_rows[worst],
            "max_card_vs_f64": max(r["card_vs_f64"]
                                   for r in grad_rows.values()),
            "max_cpu_vs_f64": f32_spread, "grad_limit": limit,
            "max_card_vs_cpu": max(r["card_vs_cpu"]
                                   for r in grad_rows.values())}


def phase_train_step(model, dev):
    run, statics, sup = train_statics(model)
    weights, loss_cfg = run.vf_loss_weights, run.vf_loss_config
    batch = train_batch(dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    centroid = torch.zeros(3, device=dev)
    near, far = model.near, model.far
    step = train.make_train_step(model.modules, model.optimizer, statics,
                                 sup, weights, loss_cfg)

    def one_step(draws=None):
        return step(train.zero_metric_sums(dev), batch, 0, taps, near, far,
                    centroid, n_fine_active=N_FINE_ACTIVE, draws=draws,
                    generator=model.generator)

    held = hold_train_step(model, dev, N_FINE_ACTIVE)

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

    descent = descent_check(dev, batch)

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
          "shell_points": sup.n_points, "launches": launches, **held,
          "descent": descent, "ms_per_step": ms,
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
    cfg.dataset_config.data_root_dir = str(RUN_DIR / "data")
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


def runner_fine_counts(cfg) -> tuple:
    """The fine count after ``RUNNER_EPOCHS`` epochs (+5 at every 50th
    epoch from 0, up to max_samples), after a resume from ``latest`` and in
    the eval model of ``latest`` (the JAX package's regrowth on top of the
    saved count: + 5 * (start epoch // 50), + 5 * (epoch // 50))."""
    rs = cfg.vf_nerf_config.ray_sampler_config
    end = min(rs.n_importance + 5 * len(range(0, RUNNER_EPOCHS,
                                              rs.increase_every)),
              rs.max_samples)
    return tuple(min(end + 5 * (e // rs.increase_every), rs.max_samples)
                 for e in (0, RUNNER_EPOCHS + 1, RUNNER_EPOCHS))


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
    fine_end, fine_resumed, _ = runner_fine_counts(cfg)
    check(runner.model.fine_n_samples == fine_end,
          f"runner: fine count {runner.model.fine_n_samples}, expected "
          f"{fine_end} (+5 at every 50th epoch from 0)")

    resumed_cfg = scene_runner_config("latest")
    resumed = VectorFieldNerfRunner(resumed_cfg)
    check(resumed_cfg.start_epoch == RUNNER_EPOCHS + 1,
          f"resume: start_epoch {resumed_cfg.start_epoch}, expected "
          f"{RUNNER_EPOCHS + 1}")
    check(resumed.model.fine_n_samples == fine_resumed,
          f"resume: fine count {resumed.model.fine_n_samples}, expected "
          f"{fine_resumed} (the saved count + 5 * (start epoch // 50))")
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
    through ``render_image`` of the ``latest`` eval model (the fine count of
    a resume, ``runner_fine_counts``), against the port's plain path on the
    CPU."""
    cfg = scene_runner_config("latest")
    model, epoch = eval_model(cfg)
    dataset = dataset_dict[cfg.dataset_config.dataset_name](
        cfg.dataset_config)
    dataset.all_pixels = True
    model.near, model.far = dataset.get_bounds()
    batch = dataset[0]
    uv = batch["uv"][len(batch["uv"]) // N_RAYS * N_RAYS:]
    n = len(uv)
    fine = runner_fine_counts(cfg)[2]
    check(n == 512 and model.fine_n_samples == fine,
          f"eval tail chunk: {n} rays at fine count {model.fine_n_samples}, "
          f"expected 512 at {fine}")
    return hold_eval_chunk(model, epoch, dataset, batch, uv,
                           "eval tail chunk")


def hold_eval_chunk(model, epoch, dataset, batch, uv, what) -> dict:
    """The rays ``uv`` of a view (``batch``) through ``render_image`` of an
    eval model: 3 MLP and 2 march launches, equal to ``render_rays`` on the
    same rays and draws, and held to the port's plain path on the CPU as in
    phase 5 (``hold_render``)."""
    n = len(uv)
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
          f"{what} launches {launches}, expected 3 MLP and 2 march")
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
          f"{what}: render_image differs from render_rays on the same rays "
          f"and draws")
    share, errs, _ = hold_render(model, out, uv_t, pose, intr, statics,
                                 draw_state, what)
    return {"rays": n, "samples": statics.n_coarse + statics.n_fine,
            "launches": launches, "argmax_agreement": share,
            "max_abs_err_vs_cpu_plain": errs, "tol": RENDER_TOL,
            "rgb_std": float(rgb.std()), "depth_std": float(depth.std())}


class OctantTimes:
    """Times each ``DeviceMeshExtractor.device_stages`` and ``host_tail``
    call while it is entered (the class's methods wrapped, then restored):
    (start, end) on the host clock, with the cells or faces of each."""

    def __enter__(self):
        self.device, self.host = [], []
        self._orig = (DeviceMeshExtractor.device_stages,
                      DeviceMeshExtractor.host_tail)
        stages, tail = self._orig

        def device_stages(extractor, *args, **kwargs):
            t0 = time.perf_counter()
            out = stages(extractor, *args, **kwargs)
            self.device.append((t0, time.perf_counter(), len(out[0])))
            return out

        def host_tail(extractor, *args, **kwargs):
            t0 = time.perf_counter()
            out = tail(extractor, *args, **kwargs)
            self.host.append((t0, time.perf_counter(), len(out[1])))
            return out

        DeviceMeshExtractor.device_stages = device_stages
        DeviceMeshExtractor.host_tail = host_tail
        return self

    def __exit__(self, *exc):
        DeviceMeshExtractor.device_stages, DeviceMeshExtractor.host_tail = \
            self._orig

    def summary(self, wall: float) -> dict:
        dev = sum(b - a for a, b, _ in self.device)
        host = sum(b - a for a, b, _ in self.host)
        # Host-tail seconds that ran while device stages did.
        hidden = sum(max(0.0, min(hb, db) - max(ha, da))
                     for ha, hb, _ in self.host for da, db, _ in self.device)
        n = max(len(self.device), 1)
        return dict(octants=len(self.device), wall_s=wall,
                    device_s_per_octant=dev / n, host_s_per_octant=host / n,
                    host_hidden_share=hidden / host if host else None,
                    cells=[c for _, _, c in self.device],
                    faces=[f for _, _, f in self.host])


def hold_grid_chunk(model) -> dict:
    """The fused MLP at the grid's chunk (``GRID_CHUNK`` points of the first
    res-256 octant) against ``mlp_reference`` on the card, with its time per
    1 M points beside the 3xTF32 bound, the plain version's and the cuBLAS
    ``addmm`` chain's at that shape."""
    dataset = SyntheticBoxDataset()
    translation, sub_scale = next(iter(quadrant_translations(8,
                                                             dataset.scale)))
    offset = torch.as_tensor(translation + dataset.get_centroid(),
                             device=model.device)
    pts = grid_points(MESH_RES, sub_scale, offset,
                      torch.arange(GRID_CHUNK, device=model.device))
    x = positional_encoding(
        pts, model.config.vf_net_config.embedder_multires).contiguous()
    weights = model.modules.vf.folded_weights()
    skip = model.modules.vf.skip_at
    out = fused_mlp(weights, x, skip_at=skip, final_act="tanh")
    ref = mlp_reference(weights, x, skip, "tanh")
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= MLP_TOL,
          f"fused_mlp at the grid chunk: max abs err {err} > {MLP_TOL}")
    n = x.shape[0]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
    flop = 2.0 * n * macs
    nbytes = 4.0 * (n * (x.shape[1] + weights[-1][0].shape[1]) +
                    sum(w.numel() + b.numel() for w, b in weights))
    per_m = 1e6 / n
    row = dict(points=n, max_abs_err=err, tol=MLP_TOL,
               ms=cuda_ms(lambda: fused_mlp(weights, x, skip, "tanh"),
                          iters=5),
               plain_ms=cuda_ms(lambda: mlp_reference(weights, x, skip,
                                                      "tanh"), iters=3),
               library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip,
                                                      "tanh"), iters=3),
               bound_ms=max(3 * flop / PEAK_TF32_FLOPS,
                            nbytes / PEAK_BYTES) * 1e3)
    row.update({f"{k}_per_1m_points": row[k] * per_m
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del out, ref, x, pts
    torch.cuda.empty_cache()
    return row


def hold_octant_on_cpu(cfg) -> dict:
    """The first octant at res 64 of ``cfg``'s checkpoint through
    ``DeviceMeshExtractor`` on the card against the same on the CPU with
    the port's plain MLP: vertex counts within 2 %, median
    nearest-neighbour distance < 1e-5, max < 2 voxels."""
    from scipy.spatial import cKDTree

    dataset = SyntheticBoxDataset()
    translation, sub_scale = next(iter(quadrant_translations(8,
                                                             dataset.scale)))
    meshes = {}
    for device in ("cuda", "cpu"):
        model, _ = eval_model(cfg, device=device)
        extractor = DeviceMeshExtractor(
            lambda pts: model.get_vector_field(pts, chunk=GRID_CHUNK),
            HOLD_RES, device=model.device)
        meshes[device] = extractor.extract(sub_scale,
                                           dataset.get_centroid(),
                                           translation)
        del model, extractor
    (v_card, f_card), (v_cpu, f_cpu) = meshes["cuda"], meshes["cpu"]
    voxel = 2 * sub_scale / (HOLD_RES - 1)
    ok = len(v_card) > 0 and len(v_cpu) > 0
    d = cKDTree(v_cpu).query(v_card, k=1)[0] if ok else np.zeros(1)
    row = dict(res=HOLD_RES, verts_card=len(v_card), verts_cpu=len(v_cpu),
               faces_card=len(f_card), faces_cpu=len(f_cpu),
               nn_median=float(np.median(d)), nn_max=float(d.max()),
               voxel=voxel)
    check(ok and abs(len(v_card) - len(v_cpu)) <= 0.02 * len(v_cpu) and
          row["nn_median"] < 1e-5 and row["nn_max"] < 2 * voxel,
          f"mesh octant on the card vs the CPU: {row}")
    return row


def mesh_fscore(eval_folder: Path, checkpoint: str, cfg) -> dict:
    """``metrics_3d_no_vf`` (no ICP) of the plain quadrant merge, copied to
    where that method reads a marching-cubes mesh."""
    folder = RUN_DIR / "evals" / "quadrant_scores" / checkpoint
    (folder / "mesh").mkdir(parents=True, exist_ok=True)
    shutil.copy(eval_folder / "merged-mesh" /
                f"merged-mesh-scaled-{checkpoint}.ply",
                folder / "mesh" / f"mesh-scaled-{checkpoint}.ply")
    return methods.metrics_3d_no_vf(str(folder), checkpoint,
                                    cfg.dataset_config, icp_align=False)


def phase_mesh() -> dict:
    """The mesh stack of the trained run: quadrant MC of ``latest`` (three
    variants, res 256 x 8 octants), plain MC of ``latest`` at res 256, the
    plain quadrant merge of ``0``; ``tsdf-mesh`` and ``3d-metrics`` of
    both; the grid chunk through the kernel against its plain version, and
    one octant on the card against the CPU."""
    t_phase = time.perf_counter()
    evals = str(RUN_DIR / "evals")
    latest, first = scene_runner_config("latest"), scene_runner_config("0")
    dataset = SyntheticBoxDataset()
    gt_path = Path(methods._gt_mesh_path(latest.dataset_config))
    gt_path.parent.mkdir(parents=True, exist_ok=True)
    save_ply(str(gt_path), *dataset.gt_mesh())
    chunks = -(-MESH_RES ** 3 // GRID_CHUNK)
    rows = {}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    progress("mesh: quadrant MC of latest")
    with OctantTimes() as times:
        t0 = time.perf_counter()
        folder = Path(evaluate(latest, "quadrant-marching-cubes-mesh",
                               MESH_RES, evals, N_RAYS, 0.05, 8))
        wall = time.perf_counter() - t0
    launches = read_launches()
    expected = {"fused_mlp": 3 * 8 * chunks, "fused_ray_march": 0,
                "ray_march_backward": 0}
    check(launches == expected,
          f"quadrant MC launches {launches}, expected {expected}")
    rows["quadrant_latest"] = dict(
        times.summary(wall), launches=launches,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    for sub in ("merged-mesh", "merged-mesh-smoothed",
                "merged-mesh-smoothed-after"):
        for name in ("merged-mesh-latest.ply", "merged-mesh-scaled-latest.ply"):
            path = folder / sub / name
            check(path.exists() and len(load_ply(str(path))[1]) > 0,
                  f"quadrant MC: {sub}/{name} missing or empty")

    progress("mesh: MC of latest")
    model, _ = eval_model(latest)
    reset_launches()
    with OctantTimes() as times:
        t0 = time.perf_counter()
        verts, faces = methods.marching_cubes_mesh(
            model, MESH_RES, str(folder / "mesh"), "latest",
            scale=dataset.scale, max_batch=100000,
            centroid=dataset.get_centroid())
        wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["fused_mlp"] == chunks and
          launches["fused_ray_march"] == 0,
          f"MC of latest: launches {launches}, expected {chunks} MLP")
    check(len(faces) > 0 and all(
        (folder / "mesh" / n).exists()
        for n in ("mesh-latest.ply", "mesh-scaled-latest.ply")),
        "MC of latest: empty mesh or missing files")
    rows["mc_latest"] = dict(times.summary(wall), launches=launches)
    progress("mesh: the grid chunk against mlp_reference")
    grid_chunk = hold_grid_chunk(model)
    del model

    progress("mesh: quadrant MC of 0")
    model, _ = eval_model(first)
    reset_launches()
    with OctantTimes() as times:
        t0 = time.perf_counter()
        methods.quadrant_marching_cubes(
            model, MESH_RES, str(RUN_DIR / "evals" / latest.expname /
                                 "run_0" / "merged-mesh"), "0",
            scale=dataset.scale, max_batch=100000,
            centroid=dataset.get_centroid(), num_quadrants=8)
        wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches["fused_mlp"] == 8 * chunks,
          f"quadrant MC of 0: launches {launches}")
    rows["quadrant_0"] = dict(times.summary(wall), launches=launches)
    del model
    torch.cuda.empty_cache()

    scores = {}
    for cfg in (latest, first):
        ckpt = cfg.checkpoint
        progress(f"mesh: tsdf-mesh, 3d-metrics and the MC F-score of {ckpt}")
        samples = None if cfg is latest else EPOCH0_METRIC_SAMPLES
        if samples:
            os.environ["VFNERF_3D_METRIC_SAMPLES"] = str(samples)
        t0 = time.perf_counter()
        evaluate(cfg, "tsdf-mesh", MESH_RES, evals, N_RAYS, 0.05, 8)
        t1 = time.perf_counter()
        ev = Path(evaluate(cfg, "3d-metrics", MESH_RES, evals, N_RAYS, 0.05,
                           8))
        t2 = time.perf_counter()
        with open(ev / "3d-metrics.json") as f:
            metrics3d = json.load(f)
        check(list(metrics3d) == ["tsdf", "refused_tsdf", "tsdf_smoothed",
                                  "refused_tsdf_smoothed"] and
              all("fscore" in v and "chamfer distance" in v
                  for v in metrics3d.values()),
              f"3d-metrics of {ckpt}: keys {metrics3d}")
        files = ("tsdf.ply", "tsdf-smoothed.ply", "refused-tsdf.ply",
                 "refused-tsdf-smoothed.ply")
        check(all((ev / "tsdf-mesh" / n).exists() for n in files),
              f"tsdf-mesh of {ckpt}: missing files")
        mc = mesh_fscore(ev, ckpt, cfg)
        t3 = time.perf_counter()
        os.environ.pop("VFNERF_3D_METRIC_SAMPLES", None)
        check(list(mc) == ["mc", "refused"] and
              "fscore" in mc["mc"] and "chamfer distance" in mc["mc"],
              f"metrics_3d_no_vf of {ckpt}: keys {mc}")
        scores[ckpt] = dict(
            tsdf={k: metrics3d["tsdf"].get(k) for k in
                  ("fscore", "precision", "recall")},
            tsdf_faces=len(load_ply(str(ev / "tsdf-mesh" / "tsdf.ply"))[1]),
            quadrant_mc={k: mc["mc"].get(k) for k in
                         ("fscore", "precision", "recall")},
            metric_samples=samples or 1_000_000,
            seconds=dict(tsdf_mesh=t1 - t0, metrics_3d=t2 - t1,
                         mc_fscore=t3 - t2))
    for kind in ("tsdf", "quadrant_mc"):
        trained, start = (scores[c][kind]["fscore"] for c in ("latest", "0"))
        check(trained is not None and start is not None and trained > start,
              f"{kind} F-score of latest {trained} is not above epoch 0's "
              f"{start}")

    progress("mesh: one octant on the card and the CPU")
    octant = hold_octant_on_cpu(latest)
    emit({"phase": "mesh", "res": MESH_RES, "grid_chunk": GRID_CHUNK,
          "runs": rows, "grid_chunk_kernel": grid_chunk,
          "octant_card_vs_cpu": octant, "scores": scores,
          "seconds": time.perf_counter() - t_phase})
    return rows["quadrant_latest"]["launches"], grid_chunk


# ---------------------------------------------------------------- loaders
OFFICE_VIEWS, OFFICE_SIZE, OFFICE_PITCH = 24, (240, 320), 1.1
LOADER_EPOCHS = 5
MIN_DECODE_PSNR = 40.0


def psnr_u8(decoded: np.ndarray, source: np.ndarray) -> float:
    """PSNR (dB) of uint8 ``decoded`` against uint8 ``source``."""
    mse = float(np.mean((decoded.astype(np.float64) - source) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def frame_u8(scene, i: int) -> np.ndarray:
    """A synthetic scene's frame as the exporters write it."""
    h, w = scene.image_size
    return (scene.rgb_images[i].reshape(h, w, 3) * 255).astype(np.uint8)


def hold_loaded_scene(name, scene, loaded, frames) -> dict:
    """A loaded scene against the synthetic ``scene`` it was exported from:
    depths (as the 16-bit PNG in mm holds them), poses and intrinsics
    exactly, the decoded colour at ``MIN_DECODE_PSNR`` or more against the
    source's uint8 frames, the centroid and the scale as the port's mesh
    helpers give them on the GT mesh."""
    written = np.stack([(scene.depth_images[i] * 1000.0).astype(np.uint16)
                        for i in range(scene.n_images)]).astype(
                            np.float32) / 1e3
    verts, faces = scene.gt_mesh()
    centroid = mesh_centroid(verts, faces).astype(np.float32)
    scale = float(np.abs(mesh_bounds(verts) - centroid).max() * 1.1)
    psnrs = [psnr_u8(np.rint(loaded.rgb_images[i] * 255.0).reshape(
        frames[i].shape), frames[i]) for i in range(scene.n_images)]
    exact = dict(
        views=len(loaded) == scene.n_images,
        depth=np.array_equal(loaded.depth_images, written),
        poses=np.array_equal(loaded.poses, scene.poses),
        intrinsics=np.array_equal(loaded.intrinsics, scene.intrinsics),
        centroid=np.array_equal(loaded.gt_mesh_centroid, centroid),
        scale=loaded.scale == scale)
    check(all(exact.values()), f"loaders {name}: not equal to the source: "
          f"{[k for k, ok in exact.items() if not ok]}")
    check(min(psnrs) >= MIN_DECODE_PSNR,
          f"loaders {name}: decoded colour at {min(psnrs)} dB PSNR against "
          f"the source (limit {MIN_DECODE_PSNR})")
    return dict(views=len(loaded), image_size=list(loaded.image_size),
                min_psnr_db=min(psnrs), mean_psnr_db=float(np.mean(psnrs)),
                bounds=list(loaded.get_bounds()), scale=loaded.scale)


def phase_loaders(pkl) -> dict:
    """The port's exporters and loaders on the card's machine: the office
    (24 views of 240 x 320, ``tools/office_protocol.py``'s defaults) in
    Replica's layout and the box in ScanNet's (``frame_stride`` 40), both
    read back through ``dataset_dict``; then ``LOADER_EPOCHS`` epochs of the
    runner with the shipped conf on the Replica-format office, from the
    phase-10 VF init."""
    progress("loaders: export and read back")
    data = RUN_DIR / "data"
    office = SyntheticOfficeDataset(n_images=OFFICE_VIEWS,
                                    image_size=OFFICE_SIZE,
                                    pixels_per_batch=1024,
                                    pitch_range=OFFICE_PITCH)
    box = SyntheticBoxDataset()
    t0 = time.perf_counter()
    office.export_replica_format(str(data), scene="office")
    box.export_scannet_format(str(data), scene="box", frame_stride=40)
    export_s = time.perf_counter() - t0
    frames = [frame_u8(office, i) for i in range(office.n_images)]
    t0 = time.perf_counter()
    blobs = [encode_jpeg(f, 98) for f in frames]
    encode_s = (time.perf_counter() - t0) / len(frames)
    decode_jpeg(blobs[0])                    # the library's build and load
    t0 = time.perf_counter()
    for blob in blobs:
        decode_jpeg(blob)
    decode_total = time.perf_counter() - t0
    h, w = OFFICE_SIZE

    def dataset_config(fmt, scene, **extra):
        return DatasetConfig(dataset_name=fmt, shuffle_views=True,
                             pixels_per_batch=1024, scene=scene,
                             data_root_dir=str(data),
                             data_dir="Replica" if fmt == "replica"
                             else "ScanNet", **extra)

    t0 = time.perf_counter()
    replica = dataset_dict["replica"](dataset_config("replica", "office",
                                                     factor=1))
    replica_s = time.perf_counter() - t0
    scannet = dataset_dict["scannet"](dataset_config("scannet", "box",
                                                     crop_edge=0))
    rows = {"replica_office": hold_loaded_scene("replica_office", office,
                                                replica, frames),
            "scannet_box": hold_loaded_scene(
                "scannet_box", box, scannet,
                [frame_u8(box, i) for i in range(box.n_images)])}
    del replica, scannet

    progress("loaders: the runner on the Replica-format office")
    shutil.copy(pkl, data / "Replica" / "office" / "office.pkl")
    cfg = parse_config(scene="office", config_path=str(CONF),
                       expname="smoke", timestamp="run", offline=True,
                       data_root_dir=str(data))
    cfg.dataset_config.dataset_name = "replica"
    cfg.dataset_config.factor = 1
    cfg.num_epochs = LOADER_EPOCHS
    cfg.save_frequency = 100
    cfg.exps_folder = str(RUN_DIR / "exps")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    runner = VectorFieldNerfRunner(cfg)
    build_s = time.perf_counter() - t0
    runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    steps = LOADER_EPOCHS * len(runner.dataset)
    check(launches == {"fused_mlp": 5 * steps, "fused_ray_march": 2 * steps,
                       "ray_march_backward": steps},
          f"loaders: runner launches {launches} over {steps} steps, expected "
          f"5 / 2 / 1 per step")
    with open(Path(runner.run_dir) / "metrics.jsonl") as f:
        losses = [line["loss"] for line in map(json.loads, f)
                  if line.get("_type") == "metrics"]
    check(len(losses) == LOADER_EPOCHS and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0],
          f"loaders: the office run's last epoch loss is not below its "
          f"first: {losses}")
    emit({"phase": "loaders", "export_seconds": export_s,
          "encode_s_per_frame": encode_s,
          "decode_s_per_frame": decode_total / len(blobs),
          "decode_mb_per_s": len(blobs) * h * w * 3 / 1e6 / decode_total,
          "decode_jpeg_mb_per_s": sum(map(len, blobs)) / 1e6 / decode_total,
          "jpeg_bytes_per_frame": float(np.mean([len(b) for b in blobs])),
          "replica_load_seconds": replica_s, **rows,
          "runner": dict(epochs=LOADER_EPOCHS, steps=steps,
                         views=len(runner.dataset),
                         rays_per_step=runner.dataset.total_pixels,
                         dataset_seconds=build_s, seconds=seconds,
                         launches=launches, losses=losses)})
    del runner
    return launches


# --------------------------------------------------------------- protocol
# tools/torch_office_protocol.py's main at a cut size: full-size frames, 6
# views, 10 epochs, quadrant MC (plain) at res 128, the cohort's clamp 3.0,
# 3D metrics on 200,000 samples. Then the step and an eval chunk at the
# fine count that the full run reaches from epoch 700 on.
PROTOCOL_VIEWS, PROTOCOL_EPOCHS, PROTOCOL_RES = 6, 10, 128
PROTOCOL_METRIC_SAMPLES = 200_000
# The step at this fine count (all 200 samples live) does not meet phase
# 9's rule (1 x the CPU float32 path's distance from float64): density.beta
# read 1.016 x (card 9.35e-3 of max|g| from float64, CPU float32 9.20e-3,
# card against CPU float32 3.5e-3; the loss within 2e-7 relative; NVIDIA
# H100 80GB HBM3, 700.00 W). It is held within MODE_SPREAD x instead, phase
# 16's looser rule, and phase 9's rule is read and reported, not held.
PROTOCOL_FINE = 100


class StageLaunches:
    """The launch counters' increase over each call of the protocol's
    stages while entered (the functions wrapped, then restored): VF init
    (``export_office``), ``VectorFieldNerfRunner.train``, each ``evaluate``
    method, ``run_quadrant_mc`` and the attribution's field probes."""

    def __init__(self, protocol, attribution):
        from vf_nerf_torch.evaluation import evaluate as evaluate_module
        self.targets = [(protocol, "export_office", lambda *a, **k: "export"),
                        (VectorFieldNerfRunner, "train",
                         lambda *a, **k: "train"),
                        (evaluate_module, "evaluate",
                         lambda config, method, *a, **k: method),
                        (protocol, "run_quadrant_mc",
                         lambda *a, **k: "quadrant-mc"),
                        (attribution, "field_crossings",
                         lambda *a, **k: "field-probes")]
        self.stages = {}

    def __enter__(self):
        self._orig = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.targets]
        for (obj, name, label), (_, _, fn) in zip(self.targets, self._orig):
            def wrapped(*args, _fn=fn, _label=label, **kwargs):
                before = read_launches()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                after = read_launches()
                row = self.stages.setdefault(_label(*args, **kwargs),
                                             dict.fromkeys(before, 0))
                for k in row:
                    row[k] += after[k] - before[k]
                return out
            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._orig:
            setattr(obj, name, fn)


def bad_leaves(obj, path="") -> list:
    """Paths of the non-finite numbers and None values in a JSON tree."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in bad_leaves(v,
                                                              f"{path}/{k}")]
    if isinstance(obj, list):
        return [p for i, v in enumerate(obj)
                for p in bad_leaves(v, f"{path}/{i}")]
    if obj is None or (isinstance(obj, float) and not np.isfinite(obj)):
        return [path]
    return []


def phase_protocol(dev) -> dict:
    """``tools/torch_office_protocol.py``'s ``main`` in this process at a
    cut size, and ``tools/torch_office_attribution.py``'s on its workdir:
    every key of ``results/office_r5.json``'s headline present and finite,
    the group PSNRs, the loss falling, a non-empty merged mesh with its
    F-score, the launches of each stage; then the training step at the fine
    count 100 (all 200 samples live) held as phase 16 holds its steps, with
    phase 9's rule read twice, a 1024-ray eval
    chunk of the trained office at 200 samples held as in phase 12, and
    the march and its backward at (1024, 200)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_office_attribution as attribution
    import torch_office_protocol as protocol

    workdir = RUN_DIR / "office_protocol"
    h, w = OFFICE_SIZE
    argv = ["--views", str(PROTOCOL_VIEWS), "--size", str(h), str(w),
            "--epochs", str(PROTOCOL_EPOCHS), "--resolution",
            str(PROTOCOL_RES), "--mc", "plain", "--depth-clamp", "3.0",
            "--workdir", str(workdir)]
    progress("protocol: tools/torch_office_protocol.py at a cut size")
    saved_env = os.environ.get("VFNERF_3D_METRIC_SAMPLES")
    os.environ["VFNERF_3D_METRIC_SAMPLES"] = str(PROTOCOL_METRIC_SAMPLES)
    t0 = time.perf_counter()
    try:
        with StageLaunches(protocol, attribution) as counted:
            torch.cuda.synchronize()
            reset_launches()
            summary = protocol.main(argv)
            torch.cuda.synchronize()
            launches = read_launches()
            seconds = time.perf_counter() - t0
            attr = attribution.main(["--workdir", str(workdir), "--views",
                                     str(PROTOCOL_VIEWS), "--size", str(h),
                                     str(w)])
    finally:
        if saved_env is None:
            os.environ.pop("VFNERF_3D_METRIC_SAMPLES")
        else:
            os.environ["VFNERF_3D_METRIC_SAMPLES"] = saved_env
    stages = counted.stages

    with open(ROOT / "results" / "office_r5.json") as f:
        headline = json.load(f)["headline"]
    missing = sorted(set(headline) - set(summary))
    missing += [f"metrics_3d/{k}" for k in headline["metrics_3d"]
                if k not in summary["metrics_3d"]]
    check(not missing, f"protocol: office.json lacks {missing}")
    bad = bad_leaves({k: summary[k] for k in headline if k in summary})
    check(not bad, f"protocol: office.json has non-finite values at {bad}")
    groups = summary["group_psnr"]
    check(len(groups) >= 5 and all(set(g) == {"psnr", "pixel_frac"}
                                   for g in groups.values()),
          f"protocol: group_psnr {groups}")
    losses = summary["epoch_losses"]
    check(len(losses) == PROTOCOL_EPOCHS and losses[-1] < losses[0],
          f"protocol: the last epoch's loss is not below the first's: "
          f"{losses}")
    mesh = summary["mc"]["metrics_3d_mc"].get("merged-mesh", {})
    check(mesh.get("n_vertices", 0) > 0 and "fscore" in mesh,
          f"protocol: merged mesh {mesh}")
    check(set(attr) >= {"recall_overall", "per_group", "mc_mesh",
                        "render_errors_per_group", "field_crossings"},
          f"protocol: attribution.json keys {sorted(attr)}")

    steps = PROTOCOL_EPOCHS * PROTOCOL_VIEWS
    chunks = PROTOCOL_VIEWS * -(-h * w // N_RAYS)
    octants = 8 * -(-PROTOCOL_RES ** 3 // GRID_CHUNK)
    expected = {
        "export": {"fused_mlp": VF_INIT_STEPS, "fused_ray_march": 0,
                   "ray_march_backward": 0},
        "train": {"fused_mlp": 5 * steps, "fused_ray_march": 2 * steps,
                  "ray_march_backward": steps},
        "metrics": {"fused_mlp": 3 * chunks, "fused_ray_march": 2 * chunks,
                    "ray_march_backward": 0},
        "3d-metrics": dict.fromkeys(launches, 0),
        "quadrant-mc": {"fused_mlp": octants, "fused_ray_march": 0,
                        "ray_march_backward": 0}}
    check({k: stages.get(k) for k in expected} == expected,
          f"protocol: launches by stage {stages}, expected {expected}")
    total = {k: sum(row[k] for name, row in expected.items())
             for k in launches}
    check(launches == total,
          f"protocol: launches {launches}, expected {total}")

    progress("protocol: the step and eval chunks at fine count 100")
    model = build_model(dev)
    draw_state = model.generator.get_state()
    step_hold = hold_train_step(model, dev, PROTOCOL_FINE, MODE_SPREAD)
    # Phase 9's own rule (1 x), read here and not held; again with the same
    # draws from a copy with every weight x (1 + 2^-23), which moves only
    # the roundings.
    model.generator.set_state(draw_state)
    with torch.no_grad():
        for p in model.modules.parameters():
            p.mul_(1 + 2 ** -23)
    ulp_hold = hold_train_step(model, dev, PROTOCOL_FINE, MODE_SPREAD)
    phase9_rule = {
        name: dict(card_over_cpu=held["max_card_vs_f64"] /
                   held["max_cpu_vs_f64"],
                   met=held["max_card_vs_f64"] <= max(
                       GRAD_TOL, held["max_cpu_vs_f64"]))
        for name, held in (("init", step_hold), ("plus_ulp", ulp_hold))}
    del model
    cfg = parse_config(scene="office", config_path=str(workdir / "run.conf"),
                       expname="office", timestamp="run", checkpoint="latest",
                       data_root_dir=str(workdir), offline=True)
    model, epoch = eval_model(cfg)
    model.fine_n_samples = cfg.vf_nerf_config.ray_sampler_config.max_samples
    dataset = dataset_dict[cfg.dataset_config.dataset_name](
        cfg.dataset_config)
    dataset.all_pixels = True
    model.near, model.far = dataset.get_bounds()
    batch = dataset[0]
    # 1024 pixels spread over view 0's rows.
    uv = batch["uv"][::len(batch["uv"]) // N_RAYS][:N_RAYS]
    chunk_hold = hold_eval_chunk(model, epoch, dataset, batch, uv,
                                 "protocol eval chunk at fine count 100")
    check(chunk_hold["samples"] == 200,
          f"protocol eval chunk: {chunk_hold['samples']} samples, not 200")
    del model
    march = march_case(200, dev, torch.Generator(device=dev).manual_seed(9))
    torch.cuda.empty_cache()
    emit({"phase": "protocol", "argv": argv,
          "metric_samples": PROTOCOL_METRIC_SAMPLES, "seconds": seconds,
          "launches": launches, "launches_by_stage": stages,
          "eval_wall_s": summary["eval_wall_s"],
          "train_wall_s": summary["train_wall_s"],
          "train_rays_per_sec": summary["train_rays_per_sec"],
          "peak_memory_gb": summary["peak_memory_gb"],
          "epoch_losses": losses, "mean_psnr": summary["mean_psnr"],
          "group_psnr": groups, "edge_breakdown": summary["edge_breakdown"],
          "fscore_tsdf": summary["metrics_3d"]["tsdf"]["fscore"],
          "mc_plain": mesh, "convergence": summary["convergence"],
          "attribution_recall": {k: attr[k] for k in (
              "recall_overall", "recall_observed", "recall_unobserved")},
          "field_crossings": {k: len(v) for k, v in
                              attr["field_crossings"].items()},
          "step_at_fine_100": step_hold, "step_at_fine_100_ulp": ulp_hold,
          "phase9_rule_at_fine_100": phase9_rule,
          "eval_chunk_at_200": chunk_hold,
          "march_at_200": march})
    return launches


# ------------------------------------------------------------------ joint
# The efficacy study's settings (results/joint_efficacy_r5.json,
# "anchored"): 100 pose-only + 50 joint epochs, pose lr 1e-2, joint lr 1e-3,
# view 0 anchored and left unperturbed, rgb and depth weights only, no
# supervision blocks.
JOINT_EPOCHS, JOINT_POSE_ONLY = 150, 100
JOINT_ROT_DEG, JOINT_TRANS = 1.5, 0.02
SUPERVISED_EPOCHS = 2
JOINT_HOLD_RAYS = 128       # rays of the joint step held to the CPU
# The joint gradients' limit against float64, per tensor, of max|g|. The
# card's 3xTF32 forward flips a few ReLUs whose pre-activation is within
# its rounding of 0 (phase 8), which moves a layer's weight-gradient sums by
# ~1e-3 (measured 1.4e-3 on the first VF layer over 128 rays, the CPU's
# float32 chain 1.1e-4); a dropped term of the chain misses by O(1).
JOINT_GRAD_TOL = 1e-2


def perturb_poses(poses, rot_deg, trans, seed=0, skip=()):
    """``tools/joint_efficacy.py::perturb_poses``: each (4, 4) pose turned
    by ``rot_deg`` about a random axis and moved by ``trans`` in a random
    direction; views in ``skip`` keep their pose but draw all the same."""
    rng = np.random.RandomState(seed)
    out = poses.copy()
    for i in range(len(out)):
        if i in skip:
            rng.normal(size=3)
            rng.normal(size=3)
            continue
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.deg2rad(rot_deg)
        k = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)
        out[i, :3, :3] = out[i, :3, :3] @ rot
        dt = rng.normal(size=3)
        out[i, :3, 3] += dt / np.linalg.norm(dt) * trans
    return out


def pose7_errors(pose7_a, pose7_b) -> dict:
    """``tools/joint_efficacy.py::pose7_errors``: per-view rotation (deg)
    and translation errors, mean and max."""
    qa = pose7_a[:, :4] / np.linalg.norm(pose7_a[:, :4], axis=1,
                                         keepdims=True)
    qb = pose7_b[:, :4] / np.linalg.norm(pose7_b[:, :4], axis=1,
                                         keepdims=True)
    dots = np.clip(np.abs((qa * qb).sum(axis=1)), 0.0, 1.0)
    rot_deg = np.rad2deg(2.0 * np.arccos(dots))
    trans = np.linalg.norm(pose7_a[:, 4:] - pose7_b[:, 4:], axis=1)
    return {"rot_deg_mean": float(rot_deg.mean()),
            "rot_deg_max": float(rot_deg.max()),
            "trans_mean": float(trans.mean()),
            "trans_max": float(trans.max())}


def joint_config(timestamp: str, epochs: int, pose_only: int,
                 supervise_every: int, self_supervise: bool = True,
                 source: str = "latest"):
    """The joint stage of the shipped confs on the box scene, resuming the
    runner phase's checkpoint ``source`` (copied into the joint run as its
    ``latest``)."""
    cfg = parse_joint_config(
        scene="box", vf_config_path=str(CONF),
        joint_config_path=str(ROOT / "confs" / "joint_optimization.conf"),
        expname="smoke", timestamp=timestamp, checkpoint="latest",
        offline=True)
    vf = cfg.vf_config
    vf.dataset_config.dataset_name = "synthetic"
    vf.exps_folder = str(RUN_DIR / "joint")
    weights = vf.supervised_loss_weights
    weights.rgb, weights.unit_norm, weights.similarity = 1.0, 0.0, 0.0
    tc = cfg.train_config
    tc.joint_epochs, tc.pose_only_epochs = epochs, pose_only
    tc.supervise_every = supervise_every
    tc.pose_lr, tc.refinement_init_lr = 1e-2, 1e-3
    tc.anchor_first_pose = True
    cfg.self_supervise = self_supervise
    cfg.save_frequency = 50
    ckpt_dir = Path(vf.exps_folder) / vf.expname / timestamp / "checkpoints" \
        / "vf_nerf"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    main = RUN_DIR / "exps" / vf.expname / "run" / "checkpoints" / "vf_nerf"
    shutil.copy(main / f"{source}.ckpt", ckpt_dir / "latest.ckpt")
    return cfg


def perturbed_pose7(dataset, seed: int = 0) -> tuple:
    """(GT pose7, perturbed pose7) of the dataset's views: views 1.. turned
    by ``JOINT_ROT_DEG`` and moved by ``JOINT_TRANS`` (``seed``), view 0,
    the anchor, left as it is."""
    gt7 = matrix_to_pose7(torch.from_numpy(dataset.poses)).numpy()
    perturbed = perturb_poses(dataset.poses, JOINT_ROT_DEG, JOINT_TRANS,
                              seed=seed, skip=(0,))
    return gt7, matrix_to_pose7(torch.from_numpy(perturbed)).numpy()


def joint_efficacy(timestamp: str, source: str = "latest",
                   trace_every: int = 0, seed: int = 0) -> tuple:
    """The efficacy run: ``JointOptimizationRunner.train()`` from checkpoint
    ``source`` with the poses perturbed by ``seed``. Returns (the runner, a
    dict with
    the launches, seconds, peak memory, the pose errors before and after
    over views 1.., the logged epochs and, every ``trace_every`` epochs,
    the mean rotation error)."""
    runner = JointOptimizationRunner(joint_config(
        timestamp, JOINT_EPOCHS, JOINT_POSE_ONLY, 0, source=source))
    gt7, start7 = perturbed_pose7(runner.dataset, seed)
    runner.pose_params = start7
    trace = []
    if trace_every:
        train_epoch = runner.train_epoch

        def traced(epoch, draws=None):
            log = train_epoch(epoch, draws)
            if epoch % trace_every == 0 or epoch == JOINT_EPOCHS - 1:
                trace.append([epoch, log["loss"], pose7_errors(
                    runner.pose_params[1:], gt7[1:])["rot_deg_mean"]])
            return log

        runner.train_epoch = traced
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    with open(Path(runner.run_dir) / "metrics.jsonl") as f:
        logged = [line for line in map(json.loads, f)
                  if line.get("_type") == "metrics"]
    return runner, dict(
        launches=launches, seconds=seconds,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        start7=start7, logged=logged, trace=trace,
        before=pose7_errors(start7[1:], gt7[1:]),
        after=pose7_errors(runner.pose_params[1:], gt7[1:]))


def joint_step_kernels(probe, batch, statics, near, far, window) -> dict:
    """One joint step of ``probe``: the wrappers' launch counts and the CUDA
    kernels that ``torch.profiler`` sees, which must agree (one kernel per
    wrapper call) and be 3 fused MLP, 2 ray march and 1 march backward."""
    sums = probe._zero_sums(probe.JOINT_METRICS)
    probe.joint_step(sums, batch, None, statics, near, far, window)
    reset_launches()
    counts = kernel_counts(lambda: probe.joint_step(
        sums, batch, None, statics, near, far, window))
    launches = read_launches()
    expected = {"fused_mlp": 3, "fused_ray_march": 2,
                "ray_march_backward": 1}
    seen = {"fused_mlp": counts["fused_mlp_kernel"],
            "fused_ray_march": counts["ray_march_kernel"],
            "ray_march_backward": counts["ray_march_backward_kernel"]}
    check(launches == expected and seen == expected,
          f"joint step: wrapper launches {launches}, CUDA kernels {seen}; "
          f"expected {expected}")
    return dict(launches=launches, cuda_kernels=seen,
                kernels=counts["kernels"], device_ms=counts["device_ms"])


def hold_joint_gradients(probe, batch, statics, near, far, window) -> dict:
    """The joint loss and every gradient (field and poses) of
    ``JOINT_HOLD_RAYS`` rays of a batch on the card against the port's
    plain path on the CPU in float64, from the same state and draws: each
    gradient within max(``JOINT_GRAD_TOL``, the CPU float32 path's worst
    distance from float64) of max|g|, the loss within rtol
    ``TRAIN_LOSS_RTOL`` of the CPU float32 path."""
    stride = max(len(batch["uv"]) // JOINT_HOLD_RAYS, 1)
    held = {k: v[::stride][:JOINT_HOLD_RAYS] for k, v in batch.items()}
    n_rays = len(held["uv"])
    draws = draw_uniforms(statics, n_rays, probe.model.generator,
                          probe.device)
    results = []
    for d, dt in ((probe.device, torch.float32), ("cpu", torch.float32),
                  ("cpu", torch.float64)):
        runner = copy.copy(probe)
        runner.model = copy.copy(probe.model)
        runner.model.modules = copy.deepcopy(probe.model.modules).to(d, dt)
        runner.poses = probe.poses.detach().to(d, dt).requires_grad_(True)
        fed = {k: v.to(d) if k == "view_idx" else v.to(d, dt)
               for k, v in held.items()}
        total, _ = runner.joint_loss(
            fed, {k: v.to(d, dt) for k, v in draws.items()}, statics, near,
            far, window.to(d, dt))
        groups, pose_grad = runner._grads(total, with_model=True)
        names = [f"{k}.{i}" for k, v in groups.items()
                 for i in range(len(v))] + ["poses"]
        grads = [g for v in groups.values() for g in v] + [pose_grad]
        results.append((float(total.detach()),
                        [g.detach().cpu().double() for g in grads]))
        del runner
    (loss, card), (cpu_loss, cpu), (_, f64) = results
    errs = {n: dict(card_vs_f64=max_rel(g, r), cpu_vs_f64=max_rel(c, r))
            for n, g, c, r in zip(names, card, cpu, f64)}
    f32_spread = max(r["cpu_vs_f64"] for r in errs.values())
    over = {n: r for n, r in errs.items()
            if r["card_vs_f64"] > max(JOINT_GRAD_TOL, f32_spread)}
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss),
          f"joint loss {loss} vs CPU plain path {cpu_loss}")
    check(not over, f"joint gradients farther from float64 than allowed: "
          f"{over}")
    worst = max(errs, key=lambda n: errs[n]["card_vs_f64"])
    return dict(rays=n_rays, loss=loss, cpu_loss=cpu_loss,
                poses=errs["poses"], worst=worst, worst_errs=errs[worst],
                max_cpu_vs_f64=f32_spread)


def phase_joint() -> dict:
    """``JointOptimizationRunner`` from the runner phase's trained box: the
    efficacy run (anchored, perturbed poses), its launches and kernels, the
    joint step's gradients against the CPU, ``FusedMLP``'s VF-net ``dx`` at
    the step's shapes, then two short supervised runs (self-supervised
    bases, and bases from MC at res 128)."""
    progress("joint: one step's kernels and gradients")
    probe = JointOptimizationRunner(joint_config(
        "probe", JOINT_EPOCHS, JOINT_POSE_ONLY, 0))
    dev = probe.device
    probe.pose_params = perturbed_pose7(probe.dataset)[1]
    batch = probe._feed(next(probe.dataset.epoch_batches(
        np.random.RandomState(0))))
    statics = probe.model.render_statics()
    window = probe.model.to_device(probe.model.window_weights)
    near, far = (float(np.float32(v)) for v in (probe.model.near,
                                                 probe.model.far))
    kernels = {"pose_only": joint_step_kernels(probe, batch, statics, near,
                                               far, window)}
    probe._make_optimizers(freeze_model=False)
    kernels["joint"] = joint_step_kernels(probe, batch, statics, near, far,
                                          window)
    held = hold_joint_gradients(probe, batch, statics, near, far, window)
    # FusedMLP with the VF net's dx (and the colour net's) at the step's
    # shapes: the points of this batch's fine samples.
    modules = probe.model.modules
    with torch.no_grad():
        out = render_rays(modules, batch["uv"],
                          probe.poses[batch["view_idx"]],
                          batch["intrinsics"], near, far, window, statics,
                          generator=probe.model.generator)
    pts = out["points"].reshape(-1, 3)
    n_samples = out["points"].shape[1]
    vf_w, rn_w = modules.folded_weights()
    gen = torch.Generator(device=dev).manual_seed(7)
    x_vf = positional_encoding(
        pts, modules.cfg.vf_net_config.embedder_multires).contiguous()
    vf_case = hold_fused_mlp_training("joint_vf_fine", vf_w, x_vf,
                                      modules.vf.skip_at, "tanh", gen,
                                      need_dx=True)
    with torch.no_grad():
        vf_out = fused_mlp(vf_w, x_vf, modules.vf.skip_at, "tanh")
        feat = modules.cfg.vf_net_config.feature_vector_dims
        _, ray_dirs, _ = get_ray_directions_and_cam_location(
            batch["uv"], probe.poses[batch["view_idx"]], batch["intrinsics"])
        dirs = ray_dirs[:, None, :].expand(-1, n_samples, -1).reshape(-1, 3)
        x_rn = modules.render.inputs(pts, vf_out[:, :3], dirs,
                                     vf_out[:, 3:3 + feat]).contiguous()
    rn_case = hold_fused_mlp_training("joint_colour", rn_w, x_rn, None,
                                      "sigmoid", gen)
    dx = {name: {k: case[k] for k in ("max_rel_grad_err", "dx_max_rel_err",
                                       "relu_mask_agreement")}
          for name, case in (("vf_fine", vf_case), ("colour", rn_case))}
    dx["points"] = pts.shape[0]
    check(vf_case["dx_max_rel_err"] is not None and
          vf_case["dx_max_rel_err"] <= MLP_GRAD_TOL,
          f"FusedMLP joint VF dx error {vf_case['dx_max_rel_err']}")
    del probe, vf_case, rn_case, out, x_vf, x_rn, vf_out
    torch.cuda.empty_cache()

    progress("joint: the efficacy run")
    runner, run = joint_efficacy("efficacy")
    launches, seconds, before, after, logged = (
        run[k] for k in ("launches", "seconds", "before", "after", "logged"))
    steps = JOINT_EPOCHS * len(runner.dataset)
    check(launches == {"fused_mlp": 3 * steps, "fused_ray_march": 2 * steps,
                       "ray_march_backward": steps},
          f"joint: launches {launches} over {steps} steps, expected 3 MLP, "
          f"2 march and 1 march backward per step")
    refined, start7 = runner.pose_params, run["start7"]
    check(np.array_equal(refined[0], start7[0]),
          "joint: the anchored pose 0 moved")
    check(after["rot_deg_mean"] <= 0.5 * before["rot_deg_mean"],
          f"joint: mean rotation error {after['rot_deg_mean']} deg is not at "
          f"most half its start {before['rot_deg_mean']}")
    check(len(logged) == JOINT_EPOCHS and
          all(np.isfinite(line["loss"]) for line in logged),
          "joint: the efficacy run's losses are missing or not finite")
    n_rays = runner.dataset.total_pixels
    ms = [n_rays / line["rays_per_sec"] * 1e3 for line in logged]
    # The device's busy share over one more joint epoch.
    busy = kernel_counts(lambda: runner.train_epoch(JOINT_EPOCHS))
    emit_row = dict(
        views=len(runner.dataset), rays_per_step=n_rays, steps=steps,
        samples_per_ray=n_samples, launches=launches,
        step_kernels=kernels, fused_mlp_training=dx,
        seconds=seconds, ms_per_step=seconds / steps * 1e3,
        rays_per_s=steps * n_rays / seconds,
        pose_only_ms_per_step_median=float(np.median(ms[1:JOINT_POSE_ONLY])),
        joint_ms_per_step_median=float(np.median(ms[JOINT_POSE_ONLY + 1:])),
        busy_share=busy["device_ms"] / (busy["seconds"] * 1e3),
        epoch_kernels=busy["kernels"], peak_memory_gb=run["peak_memory_gb"],
        first_loss=logged[0]["loss"], last_loss=logged[-1]["loss"],
        perturbation=dict(rot_deg=JOINT_ROT_DEG, trans=JOINT_TRANS, seed=0),
        pose_error_before=before, pose_error_after=after,
        jax_trans_mean_before_after=[0.020, 0.030])
    del runner
    torch.cuda.empty_cache()

    progress("joint: the supervised runs")
    # Short supervised runs: every epoch a block of the conf's
    # supervision_epochs steps, with the bases from the field at surface
    # points, then from a res-128 marching-cubes mesh.
    supervised = {}
    for self_supervise in (True, False):
        name = "self_supervised" if self_supervise else "mc_bases"
        runner = JointOptimizationRunner(joint_config(
            f"sup_{name}", SUPERVISED_EPOCHS, 0, 1, self_supervise))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        sup_seconds = time.perf_counter() - t0
        with open(Path(runner.run_dir) / "metrics.jsonl") as f:
            logs = [{k: v for k, v in line.items()
                     if isinstance(v, (int, float))}
                    for line in map(json.loads, f)
                    if line.get("_type") == "metrics"]
        finite = len(logs) == SUPERVISED_EPOCHS and all(
            np.isfinite(v) for line in logs for v in line.values()) and \
            all("supervised_loss" in line for line in logs) and \
            bool(np.isfinite(runner.pose_params).all())
        check(finite, f"joint {name}: a non-finite or missing value in "
              f"{logs}")
        supervised[name] = dict(seconds=sup_seconds, logs=logs)
        del runner
    emit({"phase": "joint", "field_epochs": RUNNER_EPOCHS, **emit_row,
          "gradients_vs_cpu": held, "supervised": supervised})
    return launches


# The joint scan's box scenes: chip_smoke's, and tools/joint_efficacy.py's.
SCAN_SCENES = {"smoke": dict(n_images=8, image_size=(32, 48)),
               "efficacy": dict(n_images=6, image_size=(96, 128))}


# ------------------------------------------------------------ train modes
# Phase 16: the unfolded training modes. The DD weight is the reference
# trainer's term at 0.1 from epoch 0; the card is held to the CPU on
# MODE_HOLD_RAYS rays of the step (the analytic step peaks at 30 GB on the
# card at 1024 rays in float32; the CPU's float64 path would need twice).
DD_WEIGHT = 0.1
MODE_HOLD_RAYS = 256
# At 256 rays of the gained field one sensitive point dominates every VF
# gradient's float32 error, and the card's chain (cuBLAS sums in another
# order; the fused MLP's 3xTF32 products, each rounded ~8x coarser than an
# f32 FMA's) lands on either side of the CPU float32 chain's distance from
# float64: 1.01, 1.05, 1.68 and 1.43 x it in the four modes (NVIDIA H100
# 80GB HBM3, 700.00 W). So the card is held within twice that distance.
MODE_SPREAD = 2.0
# (conf changes, launches per step: fused MLP, ray march, march backward).
# The DD modes run 100 + 30 samples unpadded (the runner turns static fine
# growth off under DD); the others keep it, 200 padded with 30 live.
TRAIN_MODES = {
    "analytic_dd": (dict(dd=True), (0, 2, 1)),
    "numerical_dd": (dict(dd=True, numerical=True), (11, 2, 1)),
    "weight_norm": (dict(weight_norm=True), (5, 2, 1)),
    "nerf": (dict(rendering="nerf"), (5, 0, 0)),
}
# The DD runner: 10 epochs of the box scene from phase 10's init, the fine
# count +5 at epochs 0 and 5 (130 -> 135 -> 140 samples).
MODES_RUNNER_EPOCHS = 10
MODES_INCREASE_EVERY = 5
# The joint step's points (1024 rays of 100 + 55 samples), for PERF.md's
# joint rows.
JOINT_POINTS = N_RAYS * 155


def with_mode(cfg, dd=False, numerical=False, weight_norm=False,
              rendering="volsdf"):
    """A runner config with a train mode's changes, in place."""
    if dd:
        cfg.vf_loss_weights.directional_derivatives = DD_WEIGHT
        cfg.vf_loss_config.directional_derivatives_start = 0
    vf_cfg = cfg.vf_nerf_config
    vf_cfg.numerical_jacobian = numerical
    vf_cfg.vf_net_config.weight_norm = weight_norm
    vf_cfg.rendering_net_config.weight_norm = weight_norm
    vf_cfg.rendering = rendering
    return cfg


def mode_supervision(run, statics, n_rays):
    return train.SupervisionStatics.from_config(
        run.vf_nerf_config, "exterior_synthetic", n_rays,
        statics.n_coarse + statics.n_fine, run.dataset_config.border_radius)


def hold_mode_step(model, run, statics, static, dev) -> dict:
    """One loss of ``MODE_HOLD_RAYS`` rays of the step, its gradients and
    (in train-mode BatchNorm) its running-statistic updates on the card,
    against the port's plain path on the CPU in float32 and float64 from
    the same weights and draws: the loss within ``TRAIN_LOSS_RTOL`` of the
    CPU float32 path's (numerical Jacobian: or within twice that path's
    distance from float64), each gradient and each updated statistic within
    max(``GRAD_TOL``, ``MODE_SPREAD`` x the CPU float32 path's worst
    distance) of float64, relative to its max (gradients that are zero in
    exact arithmetic: within 1e-6 of the largest)."""
    rays = MODE_HOLD_RAYS
    batch = {k: v[:rays] for k, v in train_batch(dev).items()}
    sup = mode_supervision(run, statics, rays)
    draws = train.draw_step(statics, sup, rays, model.generator, dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    fine = N_FINE_ACTIVE if static else None
    n_points = (rays * (statics.n_coarse + N_FINE_ACTIVE)) // 10 \
        if static else None
    results = []
    for mods, d, dt in ((model.modules, dev, torch.float32),
                        (copy.deepcopy(model.modules).cpu(), "cpu",
                         torch.float32),
                        (copy.deepcopy(model.modules).cpu().double(), "cpu",
                         torch.float64)):
        loss_fn = train.make_loss_fn(mods, statics, sup, run.vf_loss_weights,
                                     run.vf_loss_config)
        total, parts, out = loss_fn(
            {k: v.to(d, dt) for k, v in batch.items()},
            {k: v.to(d, dt) for k, v in draws.items()}, 0, taps.to(d, dt),
            model.near, model.far, torch.zeros(3, device=d, dtype=dt),
            fine, n_points)
        names = [n for n, _ in mods.named_parameters()]
        grads = torch.autograd.grad(total, list(mods.parameters()))
        stats = {f"{net}.{k}": v.detach().cpu().double() for net, upd in
                 out.get("batch_stats_updates", {}).items()
                 for k, v in upd.items()}
        results.append((float(total.detach()),
                        {k: float(v.detach()) for k, v in parts.items()},
                        dict(zip(names, (g.detach().cpu().double()
                                         for g in grads))), stats))
        del mods, total, parts, out, grads
    (loss, parts, card, card_stats), (cpu_loss, cpu_parts, cpu, cpu_stats), \
        (f64_loss, _, f64, f64_stats) = results
    # Under train-mode BatchNorm the bias of each Linear before it has a
    # zero gradient in exact arithmetic (the normalization takes the batch
    # mean out): float32 gives rounding noise there. Such tensors (float64
    # max below 1e-12 of the largest) are held to 1e-6 of the largest
    # gradient instead.
    largest = max(float(g.abs().max()) for g in f64.values())
    null = {n for n, g in f64.items() if float(g.abs().max()) <=
            1e-12 * largest}
    rows = {}
    for kind, a, b, r in (("grad", card, cpu, f64),
                          ("stat", card_stats, cpu_stats, f64_stats)):
        rows[kind] = {n: dict(card_vs_f64=max_rel(a[n], r[n]),
                              cpu_vs_f64=max_rel(b[n], r[n]))
                      for n in r if n not in null}
    out = dict(rays=rays, loss=loss, cpu_loss=cpu_loss, f64_loss=f64_loss,
               parts=parts, cpu_parts=cpu_parts, null_grads=sorted(null),
               null_grad_max=max((float(card[n].abs().max()) / largest
                                  for n in null), default=0.0))
    # The numerical Jacobian's float32 losses carry its central
    # differences' noise (5e4 x each rounding): there the card's loss may
    # instead be within twice the CPU float32 path's distance from float64.
    check(abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss) or
          (statics.numerical_jacobian and statics.compute_dir_derivatives and
           abs(loss - f64_loss) <= 2 * abs(cpu_loss - f64_loss)),
          f"train mode loss {loss} vs CPU plain path {cpu_loss} (float64 "
          f"{f64_loss})")
    check(out["null_grad_max"] <= 1e-6,
          f"train mode: gradients zero in exact arithmetic reach "
          f"{out['null_grad_max']} of the largest on the card")
    for kind, errs in rows.items():
        if not errs:
            continue
        spread = max(e["cpu_vs_f64"] for e in errs.values())
        limit = max(GRAD_TOL, MODE_SPREAD * spread)
        over = {n: e for n, e in errs.items() if e["card_vs_f64"] > limit}
        check(not over, f"train mode {kind}s farther from float64 than "
              f"{limit}: {over}")
        worst = max(errs, key=lambda n: errs[n]["card_vs_f64"])
        out[f"{kind}s"] = len(errs)
        out[f"worst_{kind}"] = worst
        out[f"worst_{kind}_errs"] = errs[worst]
        out[f"max_cpu_vs_f64_{kind}"] = spread
    return out


def mlp_case(name, weights, x, skip_at, act, gen) -> dict:
    """``FusedMLP`` at a train mode's shape held against the plain version
    (``hold_fused_mlp_training``), with the save-mode launch's time, the
    cuBLAS chain that keeps every hidden output (``library_ms``), the plain
    forward + backward, and the 3xTF32 bound."""
    case = hold_fused_mlp_training(name, weights, x, skip_at, act, gen,
                                   need_dx=False)
    leaves, x_leaf, inputs, dy = (case[k] for k in ("leaves", "x_leaf",
                                                    "inputs", "dy"))
    n = x.shape[0]
    macs = sum(w.shape[0] * w.shape[1] for w, _ in weights)
    hidden_width = sum(w.shape[1] for w, _ in weights[:-1])
    nbytes = 4.0 * (n * (x.shape[1] + weights[-1][0].shape[1] +
                         hidden_width) +
                    sum(w.numel() + b.numel() for w, b in weights))
    row = dict(case=name, points=n,
               max_rel_grad_err=case["max_rel_grad_err"],
               relu_mask_agreement=case["relu_mask_agreement"],
               ms=cuda_ms(lambda: fused_mlp(leaves, x_leaf, skip_at, act),
                          iters=5),
               library_ms=cuda_ms(lambda: addmm_chain(weights, x, skip_at,
                                                      act, keep=[]),
                                  iters=5),
               plain_ms=cuda_ms(lambda: torch.autograd.grad(
                   mlp_reference(leaves, x_leaf, skip_at, act), inputs, dy),
                   iters=3),
               bound_ms=max(3 * 2.0 * n * macs / PEAK_TF32_FLOPS,
                            nbytes / PEAK_BYTES) * 1e3)
    del case
    return row


def queued_ms(fn, calls: int = 50) -> float:
    """Device ms per call of ``fn`` over ``calls`` calls enqueued behind a
    spin kernel (``torch.cuda._sleep``), so that they run back to back on
    the device whatever the host's enqueue costs; timed with CUDA events.
    (``torch.profiler`` kept no record of these ~6 us kernels late in the
    script: 0 of 20 calls, or 13.)"""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def march_case(n_samples, dev, gen, n_rays: int = N_RAYS) -> dict:
    """The march forward (rgb and weights) and its backward at (``n_rays``,
    ``n_samples``), ``n_valid`` None, against their plain versions, with
    device times (``queued_ms``), plain times and byte bounds. (One CUDA
    kernel per wrapper call at these shapes: the modes' steps above count
    them.)"""
    normals, dirs, z, rgb = march_inputs(n_rays, n_samples, n_samples, dev)
    taps = torch.full((11,), 1.0 / 11, device=dev)
    prm = DensityParams(*(torch.tensor(v, device=dev)
                          for v in (0.5, 100.0, 0.7)))
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-2.0, normalize=True)
    out = fused_ray_march(normals, dirs, z, rgb, prm, taps, **kw)
    ref = ray_march_reference(normals, dirs, z, rgb, prm, taps, **kw)
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(all(bool(torch.allclose(a, b, **MARCH_TOL))
              for a, b in zip(out, ref)),
          f"fused_ray_march ({n_rays}, {n_samples}) n_valid None: max abs "
          f"err {fwd_err}")
    st = MarchStatics((1e-4, 1e9), 1.0, (0.6, 1.0), -0.5, -2.0, True, False,
                      None)
    args = (normals, dirs, z, rgb, torch.tensor((0.5, 100.0, 0.7),
                                                device=dev), taps, st,
            torch.randn((n_rays, 3), generator=gen, device=dev),
            torch.randn((n_rays,), generator=gen, device=dev), None)
    got = ray_march_backward(*args)
    got = (got[0], got[1], got[2].sum(0))
    want = ray_march_backward_reference(*args)
    bwd_err = 0.0
    for name, a, b in zip(("normals", "rgb", "scalars"), got, want):
        atol = 1e-5 * max(float(b.abs().max()), 1.0)
        bwd_err = max(bwd_err, float((a - b).abs().max()))
        check(bool(torch.allclose(a, b, rtol=1e-4, atol=atol)),
              f"ray_march_backward ({n_rays}, {n_samples}) n_valid None "
              f"{name}: max abs err {float((a - b).abs().max())}")
    fwd_ms = queued_ms(lambda: fused_ray_march(normals, dirs, z, rgb, prm,
                                               taps, **kw))
    bwd_ms = queued_ms(lambda: ray_march_backward(*args))
    s = n_samples
    fwd_bytes = 4.0 * (n_rays * s * 7 + n_rays * 3 + 11 + 3 + n_rays * s +
                       n_rays * 4)
    bwd_bytes = 4.0 * (n_rays * s * 7 + n_rays * 3 + n_rays * 4 + 11 + 3 +
                       n_rays * s * 6 + n_rays * 3)
    return dict(
        samples=s, forward_max_abs_err=fwd_err,
        backward_max_abs_err=bwd_err, forward_ms=fwd_ms,
        forward_plain_ms=cuda_ms(lambda: ray_march_reference(
            normals, dirs, z, rgb, prm, taps, **kw), iters=10),
        forward_bound_ms=fwd_bytes / PEAK_BYTES * 1e3, backward_ms=bwd_ms,
        backward_plain_ms=cuda_ms(lambda: ray_march_backward_reference(
            *args), iters=5),
        backward_bound_ms=bwd_bytes / PEAK_BYTES * 1e3)


def phase_train_modes_kernels(dev) -> dict:
    """Each kernel at the shapes the train modes give it: the march and its
    backward at 130, 155 and 200 samples with ``n_valid`` None (the DD
    runs' growing axis, from the first fine count to the last; 155 is also
    the joint step's), ``FusedMLP`` over a weight-norm fold at the static
    step's 204,800 points and over the frozen-BatchNorm fold at the
    numerical Jacobian's 133,120, and both nets at the joint step's
    158,720 points."""
    gen = torch.Generator(device=dev).manual_seed(6)
    march = [march_case(s, dev, gen) for s in (130, 155, 200)]
    mlp = []
    for label, changes, n in (("weight_norm", dict(weight_norm=True),
                               N_RAYS * 200),
                              ("numerical_dd", dict(dd=True, numerical=True),
                               N_RAYS * 130),
                              ("joint", {}, JOINT_POINTS)):
        cfg = with_mode(runner_config(), **changes).vf_nerf_config
        model = VectorFieldNerf(cfg, seed=0, device=dev)
        gain_vf(model, VF_GAIN)
        vf_w, rn_w = model.modules.folded_weights()
        pts = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        x = positional_encoding(pts, cfg.vf_net_config.embedder_multires)
        mlp.append(mlp_case(f"{label}_vf", vf_w, x.contiguous(),
                            model.modules.vf.skip_at, "tanh", gen))
        if label != "numerical_dd":
            x = torch.rand((n, rn_w[0][0].shape[0]), generator=gen,
                           device=dev) * 2 - 1
            mlp.append(mlp_case(f"{label}_colour", rn_w, x, None, "sigmoid",
                                gen))
        del model
        torch.cuda.empty_cache()
    return dict(march=march, mlp=mlp)


def phase_train_modes(pkl, dev) -> dict:
    """The unfolded training modes of the shipped conf at its widths: per
    mode the exact launches and CUDA kernels of one 1024-ray step, the loss,
    gradients and running statistics against the CPU, ms per step, rays/s,
    peak memory and the busy share; each kernel at the modes' shapes; then
    the DD runner on the box scene from phase 10's init."""
    modes = {}
    batch = train_batch(dev)
    for name, (changes, expected) in TRAIN_MODES.items():
        progress(f"train_modes: {name}")
        run = with_mode(runner_config(), **changes)
        model = VectorFieldNerf(run.vf_nerf_config, seed=0, device=dev)
        gain_vf(model, VF_GAIN)
        model.near, model.far = 0.0, 4.0
        dd = changes.get("dd", False)
        if dd:
            model.train()
        static = not dd
        statics = model.render_statics(
            compute_dir_derivatives=dd,
            n_fine=None if dd else run.vf_nerf_config.ray_sampler_config
            .max_samples)
        sup = mode_supervision(run, statics, N_RAYS)
        held = hold_mode_step(model, run, statics, static, dev)
        torch.cuda.empty_cache()
        step = train.make_train_step(model.modules, model.optimizer, statics,
                                     sup, run.vf_loss_weights,
                                     run.vf_loss_config)
        taps = torch.from_numpy(model.update_annealing(0)).to(dev)
        fine = {"n_fine_active": N_FINE_ACTIVE} if static else {}

        def one_step():
            return step(train.zero_metric_sums(dev), batch, 0, taps,
                        model.near, model.far, torch.zeros(3, device=dev),
                        generator=model.generator, **fine)

        one_step()
        reset_launches()
        counts = kernel_counts(one_step)
        launches = read_launches()
        want = dict(zip(("fused_mlp", "fused_ray_march",
                         "ray_march_backward"), expected))
        seen = {"fused_mlp": counts["fused_mlp_kernel"],
                "fused_ray_march": counts["ray_march_kernel"],
                "ray_march_backward": counts["ray_march_backward_kernel"]}
        check(launches == want and seen == want,
              f"train mode {name}: wrapper launches {launches}, CUDA "
              f"kernels {seen}; expected {want}")
        stats0 = {k: v.clone() for k, v in model.modules.named_buffers()}
        sums = one_step()
        moved = any(not torch.equal(v, stats0[k]) for k, v in
                    model.modules.named_buffers() if "running" in k)
        trains_bn = model.modules.training
        check(np.isfinite(float(sums["loss"])) and moved == trains_bn,
              f"train mode {name}: loss {float(sums['loss'])}, running "
              f"statistics moved: {moved} (expected {trains_bn})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_iter = 5
        t0 = time.perf_counter()
        for _ in range(n_iter):
            one_step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy = kernel_counts(lambda: [one_step() for _ in range(3)])
        modes[name] = dict(
            samples=statics.n_coarse + statics.n_fine,
            n_valid=statics.n_coarse + N_FINE_ACTIVE if static else None,
            shell_points=sup.n_points, launches=launches, cuda_kernels=seen,
            hold=held, ms_per_step=ms, rays_per_s=N_RAYS / ms * 1e3,
            peak_memory_gb=peak_gb,
            device_ms_per_step=busy["device_ms"] / 3,
            kernels_per_step=busy["kernels"] / 3,
            busy_share=busy["device_ms"] / (busy["seconds"] * 1e3))
        emit(dict(phase="train_modes", mode=name, **modes[name]))
        del model, step
        torch.cuda.empty_cache()

    progress("train_modes: kernels at the modes' shapes")
    kernels = phase_train_modes_kernels(dev)
    emit(dict(phase="train_modes", kernels=kernels))

    progress("train_modes: the DD runner")
    runner_launches, runner_row = modes_runner(pkl)
    emit(dict(phase="train_modes", runner=runner_row))
    return dict(launches=runner_launches, modes=modes, kernels=kernels,
                runner=runner_row)


def dd_runner_config(checkpoint: str = ""):
    cfg = with_mode(scene_runner_config(checkpoint), dd=True)
    cfg.expname = "smoke_dd"
    cfg.num_epochs = MODES_RUNNER_EPOCHS
    cfg.save_frequency = MODES_RUNNER_EPOCHS
    cfg.vf_nerf_config.ray_sampler_config.increase_every = \
        MODES_INCREASE_EVERY
    return cfg


def modes_runner(pkl) -> tuple:
    """``VectorFieldNerfRunner.train()`` with the DD loss (analytic, train
    BatchNorm) on the box scene from ``pkl``: its launches (0 / 2 / 1 per
    step), the last 3 epochs' mean loss below the first 3's, the running
    statistics moved and finite, the fine count grown twice, and a resume
    from ``latest`` equal bit for bit."""
    cfg = dd_runner_config()
    runner = VectorFieldNerfRunner(cfg)
    runner.model.load_vf_init(str(pkl))
    before = {k: v.clone() for k, v in runner.model.modules.named_buffers()
              if "running" in k}
    steps = MODES_RUNNER_EPOCHS * len(runner.dataset)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    runner.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    check(launches == {"fused_mlp": 0, "fused_ray_march": 2 * steps,
                       "ray_march_backward": steps},
          f"DD runner launches {launches} over {steps} steps, expected 0 "
          f"MLP, 2 march and 1 march backward per step")
    with open(Path(runner.run_dir) / "metrics.jsonl") as f:
        logged = [line for line in map(json.loads, f)
                  if line.get("_type") == "metrics"]
    losses = [line["loss"] for line in logged]
    dd_losses = [line["directional_derivatives_loss"] for line in logged]
    check(len(losses) == MODES_RUNNER_EPOCHS and
          bool(np.isfinite(losses).all()) and
          np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"DD runner: the last 3 epochs' mean loss is not below the first "
          f"3's: {losses}")
    buffers = dict(runner.model.modules.named_buffers())
    moved = {k: float((buffers[k] - v).abs().max())
             for k, v in before.items()}
    finite = all(bool(torch.isfinite(buffers[k]).all()) for k in before)
    check(finite and min(moved.values()) > 0,
          f"DD runner: running statistics finite {finite}, least move "
          f"{min(moved.values())}")
    rs = cfg.vf_nerf_config.ray_sampler_config
    fine_end = rs.n_importance + 5 * len(range(0, MODES_RUNNER_EPOCHS,
                                               MODES_INCREASE_EVERY))
    check(runner.model.fine_n_samples == fine_end,
          f"DD runner: fine count {runner.model.fine_n_samples}, expected "
          f"{fine_end}")
    resumed = VectorFieldNerfRunner(dd_runner_config("latest"))
    check(resumed.model.modules.training and
          _state_equal(resumed.model, runner.model),
          "DD runner: the resumed state differs from the trained one, or "
          "its BatchNorm is not in train mode")
    row = dict(epochs=MODES_RUNNER_EPOCHS, steps=steps, launches=launches,
               seconds=seconds, ms_per_step=seconds / steps * 1e3,
               losses=losses, dd_losses=dd_losses,
               fine_n_samples=runner.model.fine_n_samples,
               least_stat_move=min(moved.values()),
               greatest_stat_move=max(moved.values()))
    del runner, resumed
    torch.cuda.empty_cache()
    return launches, row


def joint_scan(argv) -> int:
    """``--joint-scan``: how much main-stage training the joint stage's
    efficacy run needs (module docstring, last paragraph). One JSON line per
    main-epoch count and perturbation seed."""
    parser = argparse.ArgumentParser(prog="chip_smoke.py --joint-scan")
    parser.add_argument("--epochs", type=int, nargs="+",
                        default=[60, 120, 240, 480])
    parser.add_argument("--scene", choices=sorted(SCAN_SCENES),
                        default="smoke")
    parser.add_argument("--resume-at", type=int, default=0)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke --joint-scan: no CUDA device; this script runs "
              "on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = SCAN_SCENES[args.scene]
    dataset_dict["synthetic"] = \
        lambda config: SyntheticBoxDataset(config, **scene)
    targets = sorted(set(args.epochs))
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    RUN_DIR.mkdir(parents=True)
    try:
        pkl, _, _ = phase_vf_init(torch.device("cuda"))
        t0 = time.perf_counter()
        if args.resume_at:
            cfg = scene_runner_config()
            cfg.num_epochs = args.resume_at
            first = VectorFieldNerfRunner(cfg)
            first.model.load_vf_init(str(pkl))
            first.train()
            del first
        cfg = scene_runner_config("latest" if args.resume_at else "")
        cfg.num_epochs = targets[-1]
        cfg.save_frequency = 10 ** 6
        runner = VectorFieldNerfRunner(cfg)
        if not args.resume_at:
            runner.model.load_vf_init(str(pkl))
        train_epoch = runner.train_epoch

        def saving_epoch(epoch, draws=None):
            logged = train_epoch(epoch, draws=draws)
            if epoch + 1 in targets:
                runner.model.save(epoch, runner.ckpt_dir)
            return logged

        runner.train_epoch = saving_epoch
        runner.train()
        torch.cuda.synchronize()
        main_seconds = time.perf_counter() - t0
        with open(Path(runner.run_dir) / "metrics.jsonl") as f:
            losses = {line["step"]: line["loss"]
                      for line in map(json.loads, f)
                      if line.get("_type") == "metrics"}
        del runner
        for n in targets:
            for seed in args.seeds:
                joint, run = joint_efficacy(
                    f"scan_{n}_{seed}", source=str(n - 1), trace_every=10,
                    seed=seed)
                print(json.dumps(dict(
                    scene=args.scene, **scene, resume_at=args.resume_at,
                    main_epochs=n, seed=seed, main_loss=losses.get(n - 1),
                    main_seconds=main_seconds, joint_seconds=run["seconds"],
                    pose_error_before=run["before"],
                    pose_error_after=run["after"],
                    trace_epoch_loss_rot=run["trace"],
                    nvidia_smi=nvidia_smi())), flush=True)
                del joint
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    return 0


# ----------------------------------------------------------------- phase 18
# Data parallel on the one card: two gloo ranks sharing it (NCCL refuses
# two ranks on one GPU), NCCL at world size 1 through the runner's launch
# path, and the eval render and quadrant MC over two device slots.
PARALLEL_RANKS = 2
PARALLEL_DD_RAYS = 256
PARALLEL_STEP_RTOL = 1e-5
PARALLEL_PARAM_TOL = 1e-5
PARALLEL_GRAD_TOL = 1e-4      # max |Δg| / max |g| per tensor, the step's
PARALLEL_TIMED_STEPS = 10
PARALLEL_RUNNER_EPOCHS = 3
PARALLEL_MESH_RES = 128
PARALLEL_MIXED_RES = 48
PARALLEL_DIR = RUN_DIR / "parallel"


def parallel_step_case(dd: bool, rays: int, dev) -> dict:
    """Phase 9's step (the shipped conf, VF gained, 100 + 100 padded fine
    samples with 30 live, ``rays`` of the entry rays) or, with ``dd``, phase
    16's analytic DD step (train-mode BatchNorm, 100 + 30 samples); the
    weights, batch and global draws as CPU tensors."""
    run = with_mode(runner_config(), dd=dd)
    model = VectorFieldNerf(run.vf_nerf_config, seed=0, device=dev)
    gain_vf(model, VF_GAIN)
    if dd:
        model.train()
    statics = model.render_statics(
        compute_dir_derivatives=dd,
        n_fine=None if dd else run.vf_nerf_config.ray_sampler_config
        .max_samples)
    sup = mode_supervision(run, statics, rays)
    draws = train.draw_step(statics, sup, rays, model.generator, dev)
    return dict(config=run.vf_nerf_config, train=dd, dd=dd,
                n_fine=statics.n_fine, rays=rays,
                fine=None if dd else N_FINE_ACTIVE,
                sup={f: getattr(sup, f) for f in
                     ("init_method", "border_supervision",
                      "center_supervision", "border_radius", "n_points")},
                weights=run.vf_loss_weights, loss_config=run.vf_loss_config,
                state={k: v.cpu() for k, v in
                       model.modules.state_dict().items()},
                batch={k: v[:rays].cpu() for k, v in
                       train_batch(dev).items()},
                draws={k: None if v is None else v.cpu()
                       for k, v in draws.items()},
                taps=torch.from_numpy(model.update_annealing(0)))


def parallel_step(case: dict, dev, timed: int = 0) -> dict:
    """One step of ``case`` on this process's rows (all of them without a
    process group): its launches, the loss and metrics summed over the
    ranks, the state after it; then ``timed`` more steps' ms per step."""
    from vf_nerf_torch.parallel.mesh import all_reduce_flat, world
    from vf_nerf_torch.parallel.multihost import local_ray_slice
    rank, size = world()
    model = VectorFieldNerf(case["config"], seed=0, device=dev)
    model.modules.load_state_dict(case["state"])
    if case["train"]:
        model.train()
    statics = model.render_statics(n_fine=case["n_fine"],
                                   compute_dir_derivatives=case["dd"])
    sup = train.SupervisionStatics(**case["sup"])
    rows = local_ray_slice(case["rays"], rank, size)
    batch = {k: v[rows].to(dev) for k, v in case["batch"].items()}
    draws = {k: None if v is None else v.to(dev)
             for k, v in case["draws"].items()}
    taps = case["taps"].to(dev)
    centroid = torch.zeros(3, device=dev)
    step = train.make_train_step(model.modules, model.optimizer, statics,
                                 sup, case["weights"], case["loss_config"])

    def one():
        return step(train.zero_metric_sums(dev), batch, 0, taps, 0.0, 4.0,
                    centroid, n_fine_active=case["fine"], draws=draws)

    # The step's gradients (summed over the ranks), as the step takes them.
    loss_fn = train.make_loss_fn(model.modules, statics, sup,
                                 case["weights"], case["loss_config"])
    fine = case["fine"]
    n_points = None if fine is None else \
        max((case["rays"] * (statics.n_coarse + fine)) // 10, 1)
    total, _, _ = loss_fn(batch, train.shard_draws(draws, rows,
                                                   sup.n_points),
                          0, taps, 0.0, 4.0, centroid, fine, n_points)
    names = [n for n, _ in model.modules.named_parameters()]
    grads = list(torch.autograd.grad(total, list(
        model.modules.parameters()), allow_unused=True))
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(model.modules.parameters(), grads)]
    all_reduce_flat(grads)
    grads = {n: g.cpu() for n, g in zip(names, grads)}
    del total
    torch.cuda.synchronize()
    reset_launches()
    sums = one()
    torch.cuda.synchronize()
    launches = read_launches()
    metrics = torch.stack([sums[k] for k in train.METRIC_KEYS])
    all_reduce_flat([metrics])
    out = dict(launches=launches, grads=grads,
               metrics=dict(zip(train.METRIC_KEYS, metrics.tolist())),
               state={k: v.cpu() for k, v in
                      model.modules.state_dict().items()})
    if timed:
        one()
        torch.cuda.synchronize()
        if size > 1:
            torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(timed):
            one()
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) / timed * 1e3
    return out


def parallel_rank(inputs: str) -> None:
    """One gloo rank of phase 18 (a), on the card that it shares: every
    case's step, then the gloo all-reduce of the step's flat gradient."""
    from vf_nerf_torch.parallel.mesh import world
    from vf_nerf_torch.parallel.multihost import local_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = local_device("cuda")
    rank, _ = world()
    cases = torch.load(inputs, weights_only=False)
    out = {name: parallel_step(case, dev, timed=PARALLEL_TIMED_STEPS
                               if name == "production" else 0)
           for name, case in cases.items()}
    n_params = sum(v.numel() for k, v in cases["production"][
        "state"].items() if "running" not in k and "num_batches" not in k)
    flat = torch.zeros(n_params, device=dev)
    for _ in range(3):
        torch.distributed.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        torch.distributed.all_reduce(flat)
    torch.cuda.synchronize()
    out["allreduce"] = dict(floats=n_params, backend=torch.distributed
                            .get_backend(),
                            ms=(time.perf_counter() - t0) / 20 * 1e3)
    torch.save(out, f"{inputs}.{rank}")


def state_gap(a: dict, b: dict) -> dict:
    """Per tensor of two state dicts, max |a - b| (parameters) or the
    relative gap (running statistics)."""
    gaps = {}
    for name, value in a.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = float((value.double() - b[name].double()).abs().max())
        if "running" in name:
            diff /= max(float(b[name].double().abs().max()), 1e-30)
        gaps[name] = diff
    return gaps


def float64_grads(case: dict) -> dict:
    """The gradients of ``case``'s loss in one process on the CPU in
    float64 (the plain path), from the same weights and draws."""
    model = VectorFieldNerf(case["config"], seed=0, device="cpu")
    model.modules.load_state_dict(case["state"])
    model.modules.double()
    if case["train"]:
        model.train()
    statics = model.render_statics(n_fine=case["n_fine"],
                                   compute_dir_derivatives=case["dd"])
    loss_fn = train.make_loss_fn(model.modules, statics,
                                 train.SupervisionStatics(**case["sup"]),
                                 case["weights"], case["loss_config"])
    f64 = torch.float64
    total, _, _ = loss_fn(
        {k: v.to(f64) for k, v in case["batch"].items()},
        {k: None if v is None else v.to(f64)
         for k, v in case["draws"].items()}, 0, case["taps"].to(f64),
        0.0, 4.0, torch.zeros(3, dtype=f64), case["fine"], None)
    names = [n for n, _ in model.modules.named_parameters()]
    grads = torch.autograd.grad(total, list(model.modules.parameters()),
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, model.modules.parameters(), grads)}


def noise_elements(g64: dict, g1: dict, g2: dict) -> dict:
    """Per tensor, the elements whose float64 gradient lies within
    ``MODE_SPREAD`` x the larger float32 computation's distance from it
    (max |g32 - g64| over the tensor): there the f32 gradients' sign is
    rounding, which Adam's first step turns into ±lr (``ROADMAP.md`` §C;
    the tensors zero in exact arithmetic, the biases before a train-mode
    BatchNorm, fall in whole)."""
    out = {}
    for n, ref in g64.items():
        noise = max(float((g1[n].double() - ref).abs().max()),
                    float((g2[n].double() - ref).abs().max()))
        out[n] = ref.abs() <= MODE_SPREAD * noise
    return out


def max_or_zero(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def masked_state_gap(a: dict, b: dict, masks: dict) -> dict:
    """Per parameter, max |a - b| over the elements not in ``masks``."""
    return {name: max_or_zero((a[name].double() - b[name].double())
                              .abs()[~mask])
            for name, mask in masks.items()}


def ulp_case(case: dict) -> dict:
    """``case`` with every parameter x (1 + 2^-23): one float32 ulp."""
    state = {k: v * (1 + 2 ** -23) if v.is_floating_point() and
             "running" not in k else v for k, v in case["state"].items()}
    return dict(case, state=state)


def dd_step_hold(case: dict, ref: dict, two: dict, dev) -> dict:
    """(a)'s DD step under train-mode BatchNorm. Its float32 chain lies
    ~2e-2 of max|g| from float64 (phase 16), and rounding alone moves it as
    far: a control, the one-process step from a one-ulp copy of the
    weights, measures that spread. The ranks' summed gradients are held to
    one process's within ``MODE_SPREAD`` x the control's distance from
    one process's. Adam's first step turns each gradient's sign into ±lr,
    so wherever rounding flips a sign the step differs by up to 2·lr
    (``ROADMAP.md`` §C). The parameters are held within
    ``PARALLEL_PARAM_TOL`` outside the noise elements
    (``noise_elements``), and the control's step moves no parameter by
    more than that outside them either. The gap outside only the biases
    before a BatchNorm (zero gradient in exact arithmetic) is reported,
    for the ranks and for the control."""
    g64 = float64_grads(case)
    largest = max(float(g.abs().max()) for g in g64.values())
    null = {n for n, g in g64.items() if float(g.abs().max()) <=
            1e-12 * largest}
    live = [n for n in g64 if n not in null]
    start = ulp_case(case)
    control = parallel_step(start, dev)

    def gaps(grads):
        return {n: max_rel(grads[n].double(), ref["grads"][n].double())
                for n in live}

    direct, spread = gaps(two["grads"]), gaps(control["grads"])
    limit = max(PARALLEL_GRAD_TOL, MODE_SPREAD * max(spread.values()))
    out = dict(null_grads=sorted(null),
               one_process_grad_vs_f64=max(
                   max_rel(ref["grads"][n].double(), g64[n]) for n in live),
               ranks_grad_vs_f64=max(
                   max_rel(two["grads"][n].double(), g64[n]) for n in live),
               control_grad_rel_gap=max(spread.values()),
               max_grad_rel_gap=max(direct.values()),
               worst_grad=max(direct, key=direct.get), grad_limit=limit)
    check(out["max_grad_rel_gap"] <= limit,
          f"parallel dd: the ranks' summed gradients differ from one "
          f"process's by {out['max_grad_rel_gap']} of max|g| "
          f"({out['worst_grad']}), over {MODE_SPREAD} x the one-ulp "
          f"control's {out['control_grad_rel_gap']}")
    noise = noise_elements(g64, ref["grads"], two["grads"])

    def step_gap(first, last):
        """Per parameter, |(last - first) - one process's step|."""
        return {n: ((last[n].double() - first[n].double()) -
                    (ref["state"][n].double() - case["state"][n].double()))
                .abs() for n in g64}

    ranks_gap = step_gap(case["state"], two["state"])
    control_gap = step_gap(start["state"], control["state"])

    def outside(gap, masks):
        return max(max_or_zero(g[~masks[n]]) for n, g in gap.items())

    bn_bias = {n: torch.full_like(g, n in null, dtype=torch.bool)
               for n, g in g64.items()}
    out.update(
        noise=noise,
        max_param_gap_outside_bn_biases=outside(ranks_gap, bn_bias),
        control_max_param_gap_outside_bn_biases=outside(control_gap,
                                                        bn_bias),
        moved_elements=sum(int(((g > PARALLEL_PARAM_TOL) & ~bn_bias[n])
                               .sum()) for n, g in ranks_gap.items()),
        control_moved_elements=sum(int(((g > PARALLEL_PARAM_TOL) &
                                        ~bn_bias[n]).sum())
                                   for n, g in control_gap.items()),
        control_max_param_gap_outside_noise=outside(control_gap, noise))
    check(out["control_max_param_gap_outside_noise"] < PARALLEL_PARAM_TOL,
          f"parallel dd: the one-ulp control's step moves a parameter by "
          f"{out['control_max_param_gap_outside_noise']} outside the noise "
          f"elements")
    return out


def parallel_ranks_phase(dev) -> dict:
    """(a): two gloo ranks sharing the card against one process."""
    from vf_nerf_torch.parallel import multihost
    cases = {"production": parallel_step_case(False, N_RAYS, dev),
             "dd_train_bn": parallel_step_case(True, PARALLEL_DD_RAYS, dev)}
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    inputs = PARALLEL_DIR / "steps.pt"
    torch.save(cases, inputs)
    one = {name: parallel_step(case, dev, timed=PARALLEL_TIMED_STEPS
                               if name == "production" else 0)
           for name, case in cases.items()}
    progress("parallel: two gloo ranks on the card")
    t0 = time.perf_counter()
    multihost.spawn(parallel_rank, PARALLEL_RANKS, "cuda", (str(inputs),),
                    backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{inputs}.{r}", weights_only=False)
             for r in range(PARALLEL_RANKS)]
    rows = {}
    for name, case in cases.items():
        want = {"fused_mlp": 0 if case["dd"] else 5, "fused_ray_march": 2,
                "ray_march_backward": 1}
        ref, two = one[name], ranks[0][name]
        row = dict(rays=case["rays"], rays_per_rank=case["rays"] //
                   PARALLEL_RANKS, one_process_launches=ref["launches"],
                   rank_launches=[r[name]["launches"] for r in ranks],
                   loss=two["metrics"]["loss"],
                   one_process_loss=ref["metrics"]["loss"])
        if case["train"]:
            row.update(dd_step_hold(case, ref, two, dev))
            noise = row.pop("noise")
        else:
            grad_gaps = {n: max_rel(two["grads"][n], g)
                         for n, g in ref["grads"].items()}
            row.update(max_grad_rel_gap=max(grad_gaps.values()),
                       worst_grad=max(grad_gaps, key=grad_gaps.get))
            check(row["max_grad_rel_gap"] <= PARALLEL_GRAD_TOL,
                  f"parallel {name}: the ranks' summed gradients differ "
                  f"from one process's by {row['max_grad_rel_gap']} of "
                  f"max|g| ({row['worst_grad']})")
            noise = {n: torch.zeros_like(g, dtype=torch.bool)
                     for n, g in ref["grads"].items()}
        row.update(noise_elements=int(sum(int(m.sum())
                                          for m in noise.values())),
                   elements=sum(m.numel() for m in noise.values()))
        check(ref["launches"] == want and
              all(r[name]["launches"] == want for r in ranks),
              f"parallel {name}: launches one process {ref['launches']}, "
              f"ranks {row['rank_launches']}; expected {want} each")
        rel = abs(row["loss"] - row["one_process_loss"]) / \
            abs(row["one_process_loss"])
        row["loss_rel_gap"] = rel
        check(rel <= PARALLEL_STEP_RTOL,
              f"parallel {name}: the ranks' loss {row['loss']} vs one "
              f"process {row['one_process_loss']}")
        replicas = state_gap(ranks[0][name]["state"],
                             ranks[1][name]["state"])
        weights = masked_state_gap(two["state"], ref["state"], noise)
        stats = {k: v for k, v in state_gap(two["state"],
                                            ref["state"]).items()
                 if "running" in k}
        row.update(max_param_gap=max(weights.values()),
                   worst_param=max(weights, key=weights.get),
                   max_running_stat_rel_gap=max(stats.values(),
                                                default=0.0),
                   replicas_equal=max(replicas.values()) == 0.0)
        check(row["max_param_gap"] < PARALLEL_PARAM_TOL,
              f"parallel {name}: parameters after the step differ from "
              f"one process's by {row['max_param_gap']} "
              f"({row['worst_param']})")
        check(row["max_running_stat_rel_gap"] <= PARALLEL_STEP_RTOL,
              f"parallel {name}: running statistics differ by "
              f"{row['max_running_stat_rel_gap']} relative")
        check(row["replicas_equal"], f"parallel {name}: the ranks' states "
              f"differ after the step")
        rows[name] = row
    rows["production"].update(
        ms_per_step_two_ranks=ranks[0]["production"]["ms_per_step"],
        ms_per_step_one_process=one["production"]["ms_per_step"])
    return dict(steps=rows, allreduce=ranks[0]["allreduce"],
                spawn_seconds=spawn_s,
                launches=ranks[0]["production"]["launches"])


def parallel_runner_config(timestamp: str):
    cfg = scene_runner_config()
    cfg.expname, cfg.timestamp = "parallel", timestamp
    cfg.num_epochs = PARALLEL_RUNNER_EPOCHS
    cfg.save_frequency = PARALLEL_RUNNER_EPOCHS
    cfg.exps_folder = str(PARALLEL_DIR / "exps")
    return cfg


def runner_outcome(cfg) -> tuple:
    """(logged losses, the modules of ``latest.ckpt``) of a finished run."""
    run_dir = Path(cfg.exps_folder) / cfg.expname / cfg.timestamp
    with open(run_dir / "metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f
                  if json.loads(line).get("_type") == "metrics"]
    blob = torch.load(run_dir / "checkpoints" / "vf_nerf" / "latest.ckpt",
                      map_location="cpu", weights_only=False)
    return losses, {f"{net}.{k}": v for net in ("vf_net", "rendering_net",
                                                 "density")
                    for k, v in blob[net].items()}


def parallel_nccl_phase() -> dict:
    """(b): the runner spawned as one NCCL rank (``exp_runner``'s launch
    path) against the runner in this process, twice (the control)."""
    from vf_nerf_torch.parallel import multihost
    from vf_nerf_torch.train.exp_runner import train as exp_train
    outcomes = {}
    for name in ("alone", "alone_again"):
        cfg = parallel_runner_config(name)
        VectorFieldNerfRunner(cfg).train()
        outcomes[name] = runner_outcome(cfg)
    cfg = parallel_runner_config("nccl")
    t0 = time.perf_counter()
    multihost.spawn(exp_train, 1, "cuda", (cfg,), backend="nccl")
    spawn_s = time.perf_counter() - t0
    outcomes["nccl"] = runner_outcome(cfg)

    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k])
                                    for k in a[1])

    control = equal(outcomes["alone"], outcomes["alone_again"])
    nccl = equal(outcomes["nccl"], outcomes["alone"])
    check(nccl, "parallel: the NCCL world-size-1 runner is not bit-equal "
          f"to the runner alone (control run equal: {control}); losses "
          f"{outcomes['nccl'][0]} vs {outcomes['alone'][0]}")
    return dict(epochs=PARALLEL_RUNNER_EPOCHS, losses=outcomes["nccl"][0],
                bit_equal=nccl, control_bit_equal=control,
                spawn_seconds=spawn_s)


def parallel_eval_phase(dev) -> dict:
    """(c): the 1024-ray render and the res-128 x 8 quadrant MC over
    ``[cuda:0, cuda:0]`` against one device."""
    uv, pose, intr = entry_inputs()
    slots = [dev, dev]
    single, spread = build_model(dev), build_model(dev)
    spread.enable_mesh_eval(slots)
    check(spread.eval_devices is not None and
          len(spread.eval_devices) == 2 and not spread._replicas,
          f"parallel: enable_mesh_eval kept {spread.eval_devices}")
    a = single.render(pose, uv, intr, epoch=0)
    b = spread.render(pose, uv, intr, epoch=0)
    render_equal = {k: bool(torch.equal(a[k], b[k])) for k in ("rgb",
                                                               "depth")}
    check(all(render_equal.values()), f"parallel: the render over two "
          f"slots is not bit-equal to one device: {render_equal}")
    octants = list(quadrant_translations(8, 1.0))
    centroid = np.zeros(3, np.float32)
    extractor = DeviceMeshExtractor(spread.get_vector_field,
                                    PARALLEL_MESH_RES, device=dev)
    times = {}
    meshes = {}
    for name, devices in (("one", None), ("two_slots", slots)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meshes[name] = extractor.extract_many(octants, centroid,
                                              devices=devices)
        times[name] = time.perf_counter() - t0
    mesh_equal = all(np.array_equal(v1, v2) and np.array_equal(f1, f2)
                     for (v1, f1), (v2, f2) in zip(meshes["one"],
                                                   meshes["two_slots"]))
    faces = sum(len(f) for _, f in meshes["one"])
    check(mesh_equal and faces > 0, f"parallel: the quadrant MC over two "
          f"slots is not bit-equal to one device ({faces} faces)")
    return dict(render_bit_equal=render_equal, mesh_bit_equal=mesh_equal,
                faces=faces, mesh_seconds=times,
                card_and_cpu=parallel_replica_case(dev))


def octant_near(ours, ref, voxel) -> bool:
    """``hold_octant_on_cpu``'s rule for one octant: vertex counts within
    2 %, median nearest-neighbour distance < 1e-5, max < 2 voxels (two
    empty octants agree)."""
    from scipy.spatial import cKDTree
    if len(ours[0]) == 0 or len(ref[0]) == 0:
        return len(ours[0]) == len(ref[0])
    d = cKDTree(ref[0]).query(ours[0], k=1)[0]
    return abs(len(ours[0]) - len(ref[0])) <= 0.02 * len(ref[0]) and \
        float(np.median(d)) < 1e-5 and float(d.max()) < 2 * voxel


def parallel_replica_case(dev) -> dict:
    """(c) over ``[cuda:0, cpu]``, the path of several devices: the CPU
    slot renders and extracts on a weight replica. A weight change made
    after ``enable_mesh_eval`` reaches the replica through the render's
    ``sync_replicas``; the card's half of the 1024-ray render and its
    octants (res ``PARALLEL_MIXED_RES``) are bit-equal to one device, the
    CPU's half held as ``hold_render`` holds the plain path and its
    octants as ``hold_octant_on_cpu`` does."""
    uv, pose, intr = entry_inputs()
    cpu = torch.device("cpu")
    slots = [torch.device("cuda", torch.cuda.current_device()), cpu]
    single, spread = build_model(dev), build_model(dev)
    spread.enable_mesh_eval(slots)
    replica = spread._replicas.get(cpu)
    check(replica is not None and list(spread._replicas) == [cpu],
          f"parallel: enable_mesh_eval over {slots} kept replicas on "
          f"{list(spread._replicas)}")
    name = "vf.layers.0.0.weight"
    with torch.no_grad():
        for m in (single, spread):
            dict(m.modules.named_parameters())[name].mul_(1.001)
    stale = not torch.equal(replica.state_dict()[name],
                            spread.modules.state_dict()[name].cpu())
    a = single.render(pose, uv, intr, epoch=0)
    b = spread.render(pose, uv, intr, epoch=0)
    synced = all(torch.equal(v.cpu(), replica.state_dict()[k]) for k, v in
                 spread.modules.state_dict().items())
    check(stale and synced, f"parallel: the CPU replica was stale before "
          f"the render: {stale}, synced after it: {synced}")
    half = N_RAYS // 2
    card_equal = all(torch.equal(a[k][:half], b[k][:half])
                     for k in ("rgb", "depth"))
    check(card_equal, "parallel: the card's rays of the render over "
          "[cuda:0, cpu] are not bit-equal to one device")
    agree = a["argmax_coarse"][half:].cpu() == b["argmax_coarse"][half:].cpu()
    share = float(agree.float().mean())
    errs = {k: float((b[k][half:].cpu()[agree] - a[k][half:].cpu()[agree])
                     .abs().max()) for k in RENDER_TOL}
    check(share >= MIN_ARGMAX_AGREEMENT and
          all(errs[k] <= tol for k, tol in RENDER_TOL.items()),
          f"parallel: the CPU's rays of the render over [cuda:0, cpu]: "
          f"argmax agreement {share}, errors {errs} (limits {RENDER_TOL})")
    octants = list(quadrant_translations(8, 1.0))
    centroid = np.zeros(3, np.float32)
    extractor = DeviceMeshExtractor(spread.get_vector_field,
                                    PARALLEL_MIXED_RES, device=dev)
    t0 = time.perf_counter()
    one = extractor.extract_many(octants, centroid)
    mixed = extractor.extract_many(octants, centroid, devices=slots)
    seconds = time.perf_counter() - t0
    card_octants = all(np.array_equal(one[k][0], mixed[k][0]) and
                       np.array_equal(one[k][1], mixed[k][1])
                       for k in range(0, len(octants), 2))
    cpu_octants = all(octant_near(mixed[k], one[k], 2 * sub_scale /
                                  (PARALLEL_MIXED_RES - 1))
                      for k, (_, sub_scale) in enumerate(octants) if k % 2)
    faces = sum(len(f) for _, f in one)
    check(card_octants and cpu_octants and faces > 0,
          f"parallel: the quadrant MC over [cuda:0, cpu]: card octants "
          f"bit-equal {card_octants}, CPU octants near {cpu_octants}, "
          f"{faces} faces")
    return dict(replica_synced=synced, render_card_bit_equal=card_equal,
                render_cpu_argmax_agreement=share, render_cpu_errors=errs,
                mesh_res=PARALLEL_MIXED_RES, mesh_card_bit_equal=card_octants,
                mesh_cpu_near=cpu_octants, faces=faces,
                mesh_seconds=seconds)


def phase_parallel(dev) -> dict:
    """Phase 18: data parallel on the one card."""
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    try:
        ranks = parallel_ranks_phase(dev)
        progress("parallel: NCCL at world size 1 through the runner")
        nccl = parallel_nccl_phase()
        progress("parallel: render and quadrant MC over two slots")
        spread = parallel_eval_phase(dev)
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    smi = nvidia_smi()
    row = dict(phase="parallel", card=smi, two_ranks=ranks,
               nccl_world_1=nccl, eval_spread=spread)
    emit(row)
    return row


# ------------------------------------------------- phases 19 and 20: options
# Phase 19's ms per render: blocks of renders of each kind, alternated.
REUSE_TIMING_BLOCKS = 3
REUSE_TIMING_RENDERS = 10
# Phase 20: the unfolded steps in bf16 beside float32 (train-mode BatchNorm
# without and with the analytic DD loss), and the remat modes.
BF16_MODES = {"train_bn": dict(), "analytic_dd": dict(dd=True)}
REMAT_GRAD_TOL = 1e-6
LPIPS_TOL = 1e-5


def march_forward_row(n_rays, n_samples, weights_only, dev) -> dict:
    """The march forward at (``n_rays``, ``n_samples``), threshold -0.2,
    against its plain version (``MARCH_TOL``; weights only: with zero rgb):
    device ms (``queued_ms``), plain ms, byte bound."""
    normals, dirs, z, rgb = march_inputs(n_rays, n_samples, n_samples, dev)
    rgb_in = None if weights_only else rgb
    prm = DensityParams(*(torch.tensor(v, device=dev)
                          for v in (0.5, 100.0, 0.7)))
    taps = torch.full((11,), 1.0 / 11, device=dev)
    kw = dict(beta_bounds=(1e-4, 1e9), scale_min=1.0, mean_bounds=(0.6, 1.0),
              cutoff=-0.5, dir_to_normal_th=-0.2, normalize=True)
    out = fused_ray_march(normals, dirs, z, rgb_in, prm, taps, **kw)
    ref = ray_march_reference(normals, dirs, z, torch.zeros_like(rgb)
                              if weights_only else rgb, prm, taps, **kw)
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)
            if a is not None]
    check(all(bool(torch.allclose(a, b, **MARCH_TOL))
              for a, b in zip(out, ref) if a is not None),
          f"fused_ray_march ({n_rays}, {n_samples}) weights_only="
          f"{weights_only}: max abs err {max(errs)}")
    rgb_bytes = 0 if weights_only else n_rays * n_samples * 3 + n_rays * 4
    nbytes = 4.0 * (n_rays * n_samples * 4 + n_rays * 3 + 11 + 3 +
                    n_rays * n_samples + rgb_bytes)
    return dict(rays=n_rays, samples=n_samples, weights_only=weights_only,
                max_abs_err=max(errs),
                ms=queued_ms(lambda: fused_ray_march(
                    normals, dirs, z, rgb_in, prm, taps, **kw)),
                plain_ms=cuda_ms(lambda: ray_march_reference(
                    normals, dirs, z, rgb, prm, taps, **kw), iters=10),
                bound_ms=nbytes / PEAK_BYTES * 1e3)


def reorder_ms(model, statics) -> float:
    """Device ms of the reuse render's fine pass without its VF launch
    (``renderer._reuse_coarse`` with the extra rows given): the extra
    depths, the stable sort of the (1024, 130) depths and the copies of the
    coarse and extra VF rows (259 floats) to their sorted places."""
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(9)
    n_coarse, n_fine = statics.n_coarse, statics.n_fine
    width = model.modules.vf.layers[-1].weight.shape[0]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    z_coarse = torch.sort(rand(N_RAYS, n_coarse) * 4.0, dim=1).values
    weights = rand(N_RAYS, n_coarse)
    vf_coarse, vf_extra = rand(N_RAYS * n_coarse, width), \
        rand(N_RAYS * n_fine, width)
    t_fine, u_extra = rand(N_RAYS, n_fine), rand(N_RAYS, n_fine)
    cam, dirs = rand(N_RAYS, 3), rand(N_RAYS, 3)
    fine_range = model.config.ray_sampler_config.fine_range
    return cuda_ms(lambda: _reuse_coarse(
        statics, vf_coarse, z_coarse, weights, fine_range, model.near,
        model.far, t_fine, u_extra, cam, dirs, lambda pts: vf_extra),
        iters=20)


def phase_reuse_coarse(dev) -> dict:
    """Phase 19: ``VectorFieldNerf.render`` with ``reuse_coarse`` on the
    1024 entry rays: 3 fused-MLP and 2 march launches, held to the port's
    plain path on the CPU (the reuse render there) and to the recompute
    render on the card from the same draws; ms per render of both, in
    alternating blocks; each launch of the reuse render (the coarse VF
    over 102,400 points keeping all 259 outputs, the extra depths' VF over
    30,720, the colour net over 133,120, the two marches) against its
    plain version, with device ms, bound and the cuBLAS chain; the
    reorder's ms alone. Device times are ``queued_ms``'s."""
    model = build_model(dev)
    uv, pose, intr = entry_inputs()
    statics = model.render_statics(reuse_coarse=True)
    draw_state = model.generator.get_state()
    reset_launches()
    out = model.render(pose, uv, intr, epoch=0, reuse_coarse=True)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == {"fused_mlp": 3, "fused_ray_march": 2,
                       "ray_march_backward": 0},
          f"reuse render launches {launches}, expected 3 MLP and 2 march")
    check(out["rgb"].shape == (N_RAYS, 3) and
          bool(torch.isfinite(out["rgb"]).all() and
               torch.isfinite(out["depth"]).all()),
          "reuse render outputs finite, (1024, 3)")
    share, errs, _ = hold_render(model, out, torch.from_numpy(uv),
                                 torch.from_numpy(pose),
                                 torch.from_numpy(intr), statics,
                                 draw_state, "reuse render")
    model.generator.set_state(draw_state)
    recomputed = model.render(pose, uv, intr, epoch=0)
    agree = out["argmax_coarse"] == recomputed["argmax_coarse"]
    vs_recompute = {k: float((out[k][agree] - recomputed[k][agree]).abs()
                             .max()) for k in RENDER_TOL}
    check(bool(agree.all()), "reuse and recompute renders: coarse argmax "
          "differs")
    for k, tol in RENDER_TOL.items():
        check(vs_recompute[k] <= tol,
              f"reuse render {k} vs the recompute render: {vs_recompute[k]}")

    times = {"reuse": [], "recompute": []}
    for reuse in (True, False):
        for _ in range(2):
            model.render(pose, uv, intr, epoch=0, reuse_coarse=reuse)
    for _ in range(REUSE_TIMING_BLOCKS):
        for reuse in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REUSE_TIMING_RENDERS):
                model.render(pose, uv, intr, epoch=0, reuse_coarse=reuse)
            torch.cuda.synchronize()
            times["reuse" if reuse else "recompute"].append(
                (time.perf_counter() - t0) / REUSE_TIMING_RENDERS * 1e3)

    gen = torch.Generator(device=dev).manual_seed(19)
    vf_w, rn_w = model.modules.folded_weights()
    skip = model.modules.vf.skip_at
    n_coarse, n_fine = N_RAYS * statics.n_coarse, N_RAYS * statics.n_fine
    mlp = [forward_case(name, w, mlp_inputs(model, w, n, act, gen), sk, act,
                        count_kernels=False)
           for name, w, n, sk, act in (
               ("coarse_vf", vf_w, n_coarse, skip, "tanh"),
               ("extra_vf", vf_w, n_fine, skip, "tanh"),
               ("colour", rn_w, n_coarse + n_fine, None, "sigmoid"))]
    march = [march_forward_row(N_RAYS, statics.n_coarse, True, dev),
             march_forward_row(N_RAYS, statics.n_coarse + statics.n_fine,
                               False, dev)]
    row = dict(phase="reuse_coarse", launches=launches,
               argmax_agreement=share, max_abs_err_vs_cpu_plain=errs,
               max_abs_err_vs_recompute=vs_recompute, tol=RENDER_TOL,
               ms_per_render=times, mlp=mlp, march=march,
               reorder_ms=reorder_ms(model, statics))
    emit(row)
    del model
    torch.cuda.empty_cache()
    return row


def dtype_model(dev, dtype, **mode):
    """(runner config, model) of the shipped conf with ``dtype`` compute
    and a train mode's changes, seed 0, the VF kernels gained."""
    run = with_mode(runner_config(), **mode)
    run.vf_nerf_config.device_config.compute_dtype = dtype
    model = VectorFieldNerf(run.vf_nerf_config, seed=0, device=dev)
    gain_vf(model, VF_GAIN)
    model.near, model.far = 0.0, 4.0
    return run, model


def bf16_loss_hold(run, model, f32_modules, statics) -> dict:
    """The bf16 loss of ``MODE_HOLD_RAYS`` rays on the card against the
    port's bf16 plain path on the CPU, as the CPU test holds the port to
    JAX (``assert_follows_jax``), with the limits taken from the CPU bf16
    path alone: a bf16 rounding shows on the card (its loss farther from
    float64 than the card's float32 loss from ``f32_modules``, the same
    weights), the card's distance from float64 within 2 × the CPU's, and
    the card within the CPU's distance of the CPU."""
    rays = MODE_HOLD_RAYS
    dev = model.device
    batch = {k: v[:rays] for k, v in train_batch(dev).items()}
    sup = mode_supervision(run, statics, rays)
    draws = train.draw_step(statics, sup, rays, model.generator, dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    losses = []
    for mods, d, dt in ((model.modules, dev, torch.float32),
                        (copy.deepcopy(model.modules).cpu(), "cpu",
                         torch.float32),
                        (f32_modules, dev, torch.float32),
                        (copy.deepcopy(f32_modules).cpu().double(), "cpu",
                         torch.float64)):
        loss_fn = train.make_loss_fn(mods, statics, sup, run.vf_loss_weights,
                                     run.vf_loss_config)
        total, _, _ = loss_fn(
            {k: v.to(d, dt) for k, v in batch.items()},
            {k: v.to(d, dt) for k, v in draws.items()}, 0, taps.to(d, dt),
            model.near, model.far, torch.zeros(3, device=d, dtype=dt))
        losses.append(float(total.detach()))
        del total
    card, cpu, card_f32, f64 = losses
    d_card, d_cpu, d_f32 = (abs(x - f64) for x in (card, cpu, card_f32))
    check(np.isfinite(card) and d_card > d_f32,
          f"bf16 loss on the card {card} no farther from float64 {f64} "
          f"than the card's float32 loss {card_f32}: no bf16 rounding")
    check(d_card <= 2.0 * d_cpu,
          f"bf16 loss on the card {card}: {d_card} from float64 {f64}, "
          f"more than 2 × the CPU bf16 path's {d_cpu}")
    check(abs(card - cpu) <= d_cpu,
          f"bf16 loss on the card {card} vs the CPU bf16 path {cpu}: more "
          f"than the CPU's distance {d_cpu} from float64 {f64}")
    return dict(rays=rays, card=card, cpu=cpu, card_f32=card_f32, f64=f64,
                gap=abs(card - cpu), card_vs_f64=d_card, cpu_vs_f64=d_cpu,
                f32_vs_f64=d_f32, limit=d_cpu)


def step_timing(step_fn, n_iter: int = 5) -> dict:
    """ms per step and peak memory over ``n_iter`` steps after one."""
    step_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        sums = step_fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_iter * 1e3
    return dict(ms_per_step=ms, peak_memory_gb=torch.cuda
                .max_memory_allocated() / 1e9, loss=float(sums["loss"]))


def bf16_phase(dev) -> dict:
    """Phase 20 (a): the train-mode-BatchNorm step and the analytic DD step
    in bf16 beside float32; the folded render in bf16 bit-equal to
    float32 with the same launches."""
    batch = train_batch(dev)
    rows = {}
    for name, mode in BF16_MODES.items():
        progress(f"compute_dtype: {name}")
        models = {dt: dtype_model(dev, dt, **mode)
                  for dt in ("float32", "bfloat16")}
        for _, model in models.values():
            model.train()
        # The float32 and float64 references: the float32 model before
        # its steps.
        f32_modules = copy.deepcopy(models["float32"][1].modules)
        row = {}
        for dt, (run, model) in models.items():
            statics = model.render_statics(
                compute_dir_derivatives=mode.get("dd", False))
            sup = mode_supervision(run, statics, N_RAYS)
            step = train.make_train_step(model.modules, model.optimizer,
                                         statics, sup, run.vf_loss_weights,
                                         run.vf_loss_config)
            taps = torch.from_numpy(model.update_annealing(0)).to(dev)

            def one_step():
                return step(train.zero_metric_sums(dev), batch, 0, taps,
                            model.near, model.far,
                            torch.zeros(3, device=dev),
                            generator=model.generator)

            if dt == "bfloat16":
                row["hold"] = bf16_loss_hold(run, model, f32_modules,
                                             statics)
            row[dt] = step_timing(one_step)
            check(np.isfinite(row[dt]["loss"]) and all(
                bool(torch.isfinite(p).all()) and p.dtype == torch.float32
                for p in model.modules.parameters()),
                f"{name} {dt}: loss {row[dt]['loss']} or a parameter not "
                "finite float32")
        rows[name] = row
        emit(dict(phase="compute_dtype", mode=name, **row))
        del models, f32_modules
        torch.cuda.empty_cache()

    uv, pose, intr = entry_inputs()
    renders = {}
    for dt in ("float32", "bfloat16"):
        _, model = dtype_model(dev, dt)
        model.generator.manual_seed(20)
        reset_launches()
        renders[dt] = (model.render(pose, uv, intr, epoch=0),
                       read_launches())
        torch.cuda.synchronize()
        del model
    (f32, f32_launches), (b16, b16_launches) = renders["float32"], \
        renders["bfloat16"]
    equal = all(torch.equal(f32[k], b16[k]) for k in
                ("rgb", "depth", "z_vals", "normals", "weights"))
    check(equal and f32_launches == b16_launches ==
          {"fused_mlp": 3, "fused_ray_march": 2, "ray_march_backward": 0},
          f"bf16 folded render: bit-equal {equal}, launches {b16_launches} "
          f"against float32's {f32_launches}")
    rows["folded_render"] = dict(bit_equal=equal, launches=b16_launches)
    return rows


def remat_phase(dev) -> dict:
    """Phase 20 (b): the production step under ``train_remat`` "none",
    "full" and "dots": the gradients of one loss within
    ``REMAT_GRAD_TOL``·max|g| of "none"'s per tensor, then ms per step and
    peak memory of each mode."""
    model = build_model(dev)
    run, statics, sup = train_statics(model)
    batch = train_batch(dev)
    taps = torch.from_numpy(model.update_annealing(0)).to(dev)
    near, far = model.near, model.far
    n_points = (N_RAYS * (statics.n_coarse + N_FINE_ACTIVE)) // 10
    draws = train.draw_step(statics, sup, N_RAYS, model.generator, dev)
    params = list(model.modules.parameters())
    grads, losses = {}, {}
    for mode in train.REMAT_MODES:
        loss_fn = train.remat_wrap(train.make_loss_fn(
            model.modules, statics, sup, run.vf_loss_weights,
            run.vf_loss_config), mode)
        total, _, _ = loss_fn(batch, draws, 0, taps, near, far,
                              torch.zeros(3, device=dev), N_FINE_ACTIVE,
                              n_points)
        grads[mode] = torch.autograd.grad(total, params, allow_unused=True)
        losses[mode] = float(total.detach())
    gaps = {}
    for mode in ("full", "dots"):
        gaps[mode] = max(
            float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for g, r in zip(grads[mode], grads["none"]) if r is not None)
        check(gaps[mode] <= REMAT_GRAD_TOL and
              losses[mode] == losses["none"],
              f"train_remat {mode}: gradients {gaps[mode]} of max|g| from "
              f"none's, loss {losses[mode]} vs {losses['none']}")
    del grads
    timing = {}
    for mode in train.REMAT_MODES:
        step = train.make_train_step(model.modules, model.optimizer, statics,
                                     sup, run.vf_loss_weights,
                                     run.vf_loss_config, remat=mode)
        timing[mode] = step_timing(lambda: step(
            train.zero_metric_sums(dev), batch, 0, taps, near, far,
            torch.zeros(3, device=dev), n_fine_active=N_FINE_ACTIVE,
            generator=model.generator))
    del model
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_gap_vs_none=gaps, tol=REMAT_GRAD_TOL,
                timing=timing)


def write_lpips_npz(path, widths=(16, 32, 64, 64, 64), seed=0) -> None:
    """An LPIPS weights npz with VGG16's 13-conv / 5-tap structure and
    narrow channel counts, random weights."""
    rng = np.random.RandomState(seed)
    arrays, in_c, i = {}, 3, 0
    for width, n_convs in zip(widths, (2, 2, 3, 3, 3)):
        for _ in range(n_convs):
            arrays[f"conv{i}_w"] = rng.randn(width, in_c, 3, 3).astype(
                np.float32) * 0.3
            arrays[f"conv{i}_b"] = rng.randn(width).astype(np.float32) * 0.1
            in_c, i = width, i + 1
    for j, width in enumerate(widths):
        arrays[f"lin{j}"] = np.abs(rng.randn(width)).astype(np.float32)
    np.savez(path, **arrays)


def lpips_phase(dev) -> dict:
    """Phase 20 (c): LPIPS of two 64 x 64 images on the card against the
    CPU, from a generated weights npz."""
    from vf_nerf_torch.utils.metrics import get_lpips
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    path = RUN_DIR / "lpips_tiny.npz"
    write_lpips_npz(path)
    rng = np.random.RandomState(20)
    a, b = (rng.rand(64, 64, 3).astype(np.float32) for _ in range(2))
    card = get_lpips(a, b, weights_path=str(path), device=dev)
    cpu = get_lpips(a, b, weights_path=str(path), device="cpu")
    same = get_lpips(a, a, weights_path=str(path), device=dev)
    check(abs(card - cpu) <= LPIPS_TOL and abs(same) <= 1e-6,
          f"LPIPS on the card {card} vs the CPU {cpu}; d(a, a) = {same}")
    return dict(card=card, cpu=cpu, gap=abs(card - cpu), tol=LPIPS_TOL,
                same_image=same)


def rank_launches_phase(dev) -> dict:
    """Each data-parallel rank's launches at 512 of the step's 1024 rays
    (phase 18's two ranks time-slice the card, so they are timed here one
    at a time): the coarse VF (51,200 points, no save), the fine VF and the
    colour net (102,400, save mode), the shell or ball VF (10,240, save
    mode), each against its plain version with the cuBLAS chain and the
    3xTF32 bound; the march forward at (512, 100) weights only and (512,
    200), and its backward at (512, 200)."""
    model = build_model(dev)
    _, statics, sup = train_statics(model)
    gen = torch.Generator(device=dev).manual_seed(18)
    vf_w, rn_w = model.modules.folded_weights()
    skip = model.modules.vf.skip_at
    half = N_RAYS // 2
    n_coarse = half * statics.n_coarse
    n_all = half * (statics.n_coarse + statics.n_fine)
    n_shell = sup.n_points // 2
    mlp = [forward_case("rank_coarse_vf", vf_w,
                        mlp_inputs(model, vf_w, n_coarse, "tanh", gen), skip,
                        "tanh", count_kernels=False)]
    for name, w, n, sk, act in (("rank_fine_vf", vf_w, n_all, skip, "tanh"),
                                ("rank_colour", rn_w, n_all, None,
                                 "sigmoid"),
                                ("rank_shell_vf", vf_w, n_shell, skip,
                                 "tanh")):
        mlp.append(mlp_case(name, w, mlp_inputs(model, w, n, act, gen), sk,
                            act, gen))
    march = [march_forward_row(half, statics.n_coarse, True, dev),
             march_case(statics.n_coarse + statics.n_fine, dev, gen,
                        n_rays=half)]
    del model
    torch.cuda.empty_cache()
    return dict(mlp=mlp, march=march)


def phase_options(dev) -> dict:
    """Phase 20: compute_dtype, train_remat, LPIPS, and the data-parallel
    rank's launches timed apart."""
    progress("options: the data-parallel rank's launches")
    ranks = rank_launches_phase(dev)
    emit(dict(phase="rank_launches", **ranks))
    dtype_rows = bf16_phase(dev)
    progress("options: train_remat")
    remat = remat_phase(dev)
    emit(dict(phase="train_remat", **remat))
    lpips = lpips_phase(dev)
    emit(dict(phase="lpips", **lpips))
    return dict(compute_dtype=dtype_rows, train_remat=remat, lpips=lpips,
                rank_launches=ranks)


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
          "tf32": False, "host_cpus": len(os.sched_getaffinity(0)),
          "torch_threads": torch.get_num_threads()})

    t0 = time.perf_counter()
    lib = load_library()
    seconds = time.perf_counter() - t0
    regs = [line.strip() for line in lib.build_log.splitlines()
            if "registers" in line or "spill" in line]
    tensor_core = tensor_core_instructions(lib.path)
    mlp_tc = sum(c["HMMA"] + c["HGMMA"] for name, c in tensor_core.items()
                 if "fused_mlp" in name)
    check(mlp_tc > 0, "the fused MLP kernel's SASS has no HMMA / HGMMA")
    mlp_ptxas = fused_mlp_ptxas(lib.build_log)
    check_fused_mlp_build(mlp_ptxas)
    emit({"phase": "build", "seconds": seconds,
          "library": str(lib.path.relative_to(ROOT)), "ptxas": regs,
          "fused_mlp_ptxas": [ln for ln in mlp_ptxas
                              if "Potential" in ln or "warning" in ln],
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
    try:
        pkl, vf_launches, _ = phase_vf_init(dev)
        runner_launches = phase_runner(pkl, step_ms)
        eval_launches = phase_eval()
        mesh_launches, grid_chunk = phase_mesh()
        loader_launches = phase_loaders(pkl)
        protocol_launches = phase_protocol(dev)
        joint_launches = phase_joint()
        modes = phase_train_modes(pkl, dev)
        parallel = phase_parallel(dev)
        progress("reuse_coarse")
        reuse = phase_reuse_coarse(dev)
        options = phase_options(dev)
    finally:
        # The checkpoints, the VF init, the depth maps and the meshes.
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    paths = {"runner": runner_launches, "train_step": train_launches,
             "render": launches, "vf_init": vf_launches,
             "eval": eval_launches, "mesh": mesh_launches,
             "loaders": loader_launches, "protocol": protocol_launches,
             "joint": joint_launches,
             "train_modes": modes["launches"],
             "parallel": parallel["two_ranks"]["launches"],
             "reuse_coarse": reuse["launches"]}

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
             train_library_ms=mlp_train["library_ms"],
             mesh_ms_per_1m_points=grid_chunk["ms_per_1m_points"],
             mesh_bound_ms_per_1m_points=grid_chunk["bound_ms_per_1m_points"],
             mesh_library_ms_per_1m_points=grid_chunk[
                 "library_ms_per_1m_points"], **mlp),
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
    seconds = time.perf_counter() - T_START
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(result, render_ms=render_ms, train_step_ms=step_ms,
             seconds=seconds, nvidia_smi=smi, parallel=parallel,
             reuse_coarse=reuse, options=options, failures=failures),
        indent=1))
    if failures:
        print(f"chip_smoke: {len(failures)} checks failed: {failures}",
              file=sys.stderr)
        return 1
    emit({"phase": "total", "seconds": seconds})
    emit(result)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def train_modes_only() -> int:
    """``--train-modes``: the kernels' build, phase 10's VF init and phase
    16 alone; the result in ``chiprun_out/train_modes.json``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi()})
    load_library()
    if RUN_DIR.exists():
        shutil.rmtree(RUN_DIR)
    RUN_DIR.mkdir(parents=True)
    try:
        pkl, _, _ = phase_vf_init(dev)
        result = phase_train_modes(pkl, dev)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "train_modes.json").write_text(json.dumps(
        dict(result, failures=failures), indent=1))
    print(f"chip_smoke: {len(failures)} checks failed: {failures}",
          file=sys.stderr)
    return 1 if failures else 0


def parallel_only() -> int:
    """``--parallel``: the kernels' build and phase 18 alone; the result in
    ``chiprun_out/parallel.json``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi()})
    load_library()
    RUN_DIR.mkdir(parents=True, exist_ok=True)
    try:
        result = phase_parallel(dev)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "parallel.json").write_text(json.dumps(
        dict(result, seconds=time.perf_counter() - T_START,
             failures=failures), indent=1))
    print(f"chip_smoke: {len(failures)} checks failed: {failures}",
          file=sys.stderr)
    return 1 if failures else 0


def options_only() -> int:
    """``--options``: the kernels' build and phases 19 and 20 alone; the
    result in ``chiprun_out/options.json``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    load_library()
    try:
        reuse = phase_reuse_coarse(dev)
        options = phase_options(dev)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "options.json").write_text(json.dumps(
        dict(reuse_coarse=reuse, options=options, nvidia_smi=smi,
             seconds=time.perf_counter() - T_START, failures=failures),
        indent=1))
    print(f"chip_smoke: {len(failures)} checks failed: {failures}",
          file=sys.stderr)
    return 1 if failures else 0


def protocol_only() -> int:
    """``--protocol``: the kernels' build and phase 17 alone; the result in
    ``chiprun_out/protocol.json``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi()})
    load_library()
    if RUN_DIR.exists():
        shutil.rmtree(RUN_DIR)
    RUN_DIR.mkdir(parents=True)
    try:
        launches = phase_protocol(dev)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "protocol.json").write_text(json.dumps(
        dict(launches=launches, seconds=time.perf_counter() - T_START,
             failures=failures), indent=1))
    print(f"chip_smoke: {len(failures)} checks failed: {failures}",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--joint-scan"]:
        sys.exit(joint_scan(sys.argv[2:]))
    only = {"--train-modes": train_modes_only, "--protocol": protocol_only,
            "--parallel": parallel_only, "--options": options_only}
    sys.exit(only.get(sys.argv[1] if sys.argv[1:] else "", main)())
