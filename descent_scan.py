#!/usr/bin/env python3
"""Scan starts for ``chip_smoke.py``'s descent check on one CUDA card.

Run from the repository root: ``python3 descent_scan.py``. For each
candidate (starting weights, batch, learning-rate scale, steps) it runs
the shipped conf's training step on one batch from the weights and from
two copies with every weight scaled by (1 ± 2^-23), each with the draws
of a fresh facade of its seed, and prints one JSON line: each run's
descent margin (the mean loss of the first 5 steps minus the last 5's),
the spread of the three last-5 means, their ratio, the first step at
which the runs differ, and the unperturbed run's losses
(``chip_smoke.descent_runs``, which the check runs too). Candidates: the
seeded init of seeds 0 and 1, gained by ``chip_smoke.VF_GAIN`` or not, and
the VF init of ``chip_smoke`` phase 10; the entry rays with seeded targets
or a box-scene batch; the shipped learning rate or a fraction of it.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np
import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("descent_scan: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = cs.train_batch(torch.device("cuda"))
    cfg = cs.scene_runner_config()
    scene = cs.dataset_dict[cfg.dataset_config.dataset_name](
        cfg.dataset_config)
    first = next(scene.epoch_batches(np.random.RandomState(0)))
    box = {k: torch.from_numpy(np.ascontiguousarray(
        first[k][:cs.N_RAYS])).float().cuda()
        for k in ("uv", "pose", "intrinsics", "rgb", "depth")}
    near, far = scene.get_bounds()
    shutil.rmtree(cs.RUN_DIR, ignore_errors=True)
    cs.RUN_DIR.mkdir(parents=True)
    try:
        pkl, _, _ = cs.phase_vf_init(torch.device("cuda"))
        lr = dict(lr_scale=1.0)
        cases = [
            ("entry, seed 0", entry, 0.0, 4.0, lr),
            ("entry, seed 0, gained", entry, 0.0, 4.0,
             dict(lr, gain=cs.VF_GAIN)),
            ("entry, seed 1", entry, 0.0, 4.0, dict(lr, seed=1)),
            ("box, seed 0", box, near, far, lr),
            ("box, seed 1", box, near, far, dict(lr, seed=1)),
            ("box, seed 0, gained", box, near, far,
             dict(lr, gain=cs.VF_GAIN)),
            ("box, seed 0, 40 steps", box, near, far, dict(lr, steps=40)),
            ("box, VF init", box, near, far, dict(lr, pkl=pkl)),
            ("entry, VF init", entry, 0.0, 4.0, dict(lr, pkl=pkl)),
            ("box, VF init, seed 1", box, near, far,
             dict(lr, pkl=pkl, seed=1)),
            ("box, VF init, 40 steps", box, near, far,
             dict(lr, pkl=pkl, steps=40)),
            ("entry, seed 0, lr/4", entry, 0.0, 4.0, dict(lr_scale=0.25)),
            ("entry, seed 0, lr/10", entry, 0.0, 4.0, dict(lr_scale=0.1)),
            ("entry, seed 0, 10 steps", entry, 0.0, 4.0, dict(lr, steps=10)),
            ("box, seed 0, lr/4", box, near, far, dict(lr_scale=0.25)),
            ("box, seed 0, lr/10", box, near, far, dict(lr_scale=0.1)),
        ]
        for label, batch, lo, hi, kw in cases:
            result = cs.descent_runs(torch.device("cuda"), batch, lo, hi,
                                     **kw)
            cs.emit(dict(case=label, losses=result["runs"]["init"]["losses"],
                         margins={k: r["margin"]
                                  for k, r in result["runs"].items()},
                         **{k: result[k] for k in (
                             "spread", "margin_over_spread",
                             "first_differing_step")}))
    finally:
        shutil.rmtree(cs.RUN_DIR, ignore_errors=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
