#!/usr/bin/env python3
"""Train and score the synthetic box scene with vf_nerf_torch for several
seeds: the quality side of an A/B between two checkouts of the port.

Run from the repository root on a CUDA card::

    python3 quality_ab.py [--root TREE] [--seeds 42 1 2] [--tag NAME]
        [--grads-out FILE | --grads-ref FILE] [--perturb]

``--root`` imports the ``vf_nerf_torch`` of another checkout (a parent
commit unpacked under ``build/``), so that one script drives both sides.
The VF init is fitted once (seed 0, 800 steps of 8,192 points); then, per
seed, as ``chip_smoke.py`` phases 10-12 run them: ``VectorFieldNerfRunner.
train()`` of the shipped conf for 60 epochs with ``VFNERF_SEED`` set to the
seed, and ``evaluate`` (render-images, then metrics) of the ``latest`` and
``0`` checkpoints. One JSON line per seed: the mean loss of the first and
last 5 epochs and both mean PSNRs. The first step's gradient of every
parameter is saved (``--grads-out``) or held against a saved one
(``--grads-ref``: max |g - g_ref| / max |g_ref| per tensor, and the worst
tensor). ``--perturb`` scales every parameter by 1 + 2^-23 once the VF init
is loaded: what one float32 ulp of the weights alone does to the result.
Runs are written under ``build/quality_ab`` of the checkout and deleted.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="checkout whose vf_nerf_torch is trained")
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2])
    parser.add_argument("--tag", default="")
    parser.add_argument("--grads-out", default="")
    parser.add_argument("--grads-ref", default="")
    parser.add_argument("--perturb", action="store_true")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("quality_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from vf_nerf_torch.config import parse_config
    from vf_nerf_torch.datasets.synthetic import SyntheticBoxDataset
    from vf_nerf_torch.evaluation.evaluate import evaluate
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner
    from vf_nerf_torch.train.vf_init import (default_vf_config, fit_vf_init,
                                             save_vf_init)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    run_dir = root / "build" / "quality_ab" / (args.tag or "run")
    if run_dir.exists():
        shutil.rmtree(run_dir)
    run_dir.mkdir(parents=True)

    def config(exps, checkpoint=""):
        cfg = parse_config(scene="box",
                           config_path=str(root / "confs" / "vf_nerf.conf"),
                           expname="quality", timestamp="run",
                           checkpoint=checkpoint, offline=True)
        cfg.dataset_config.dataset_name = "synthetic"
        cfg.num_epochs = 60
        cfg.save_frequency = 20
        cfg.exps_folder = str(exps)
        return cfg

    wall = SyntheticBoxDataset().max_depth * 1.25 / 2.0
    net, _ = fit_vf_init(default_vf_config(), "exterior_scene", np.zeros(3),
                         steps=800, log_every=0, sample_extent=1.5 * wall,
                         wall_radius=wall, batch=8192, seed=0, device=dev)
    pkl = run_dir / "vf_init.pkl"
    save_vf_init(str(pkl), net, "exterior_scene", wall)
    del net

    saved = {}
    ref = torch.load(args.grads_ref) if args.grads_ref else None
    for seed in args.seeds:
        os.environ["VFNERF_SEED"] = str(seed)
        exps = run_dir / f"seed{seed}"
        runner = VectorFieldNerfRunner(config(exps))
        runner.model.load_vf_init(str(pkl))
        if args.perturb:
            with torch.no_grad():
                for p in runner.model.modules.parameters():
                    p.mul_(1 + 2 ** -23)
        optimizer, first = runner.model.optimizer, {}
        step = optimizer.step

        def capture(groups, grads, step=step, first=first):
            if not first:
                first.update({f"{k}.{i}": g.detach().cpu().clone()
                              for k, v in grads.items()
                              for i, g in enumerate(v)})
            return step(groups, grads)

        optimizer.step = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(Path(runner.run_dir) / "metrics.jsonl") as f:
            losses = [line["loss"] for line in map(json.loads, f)
                      if line.get("_type") == "metrics"]
        del runner
        psnr = {}
        for checkpoint in ("latest", "0"):
            folder = Path(evaluate(config(exps, checkpoint), "render-images",
                                   256, str(exps / "evals"), 1024, 0.05, 8))
            evaluate(config(exps, checkpoint), "metrics", 256,
                     str(exps / "evals"), 1024, 0.05, 8)
            with open(folder / "metrics.json") as f:
                psnr[checkpoint] = json.load(f)["mean_psnr"]
        row = {"tag": args.tag, "seed": seed, "perturb": args.perturb,
               "first5_loss": float(np.mean(losses[:5])),
               "last5_loss": float(np.mean(losses[-5:])),
               "psnr_latest": psnr["latest"], "psnr_0": psnr["0"],
               "train_seconds": seconds}
        saved[seed] = first
        if ref is not None and seed in ref:
            errs = {k: float((g - ref[seed][k]).abs().max() /
                             ref[seed][k].abs().max().clamp_min(1e-30))
                    for k, g in first.items()}
            worst = max(errs, key=errs.get)
            row.update(grad_worst=worst, grad_worst_err=errs[worst],
                       grad_median_err=float(np.median(list(errs.values()))),
                       grad_tensors=len(errs))
        print(json.dumps(row), flush=True)
        shutil.rmtree(exps)
    if args.grads_out:
        torch.save(saved, args.grads_out)
    shutil.rmtree(run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
