"""The readings that the joint cell's correctness limits are set from
(``tools/readings.py`` drives the ``train`` and ``render`` kinds): for each
seed the program's numbers against the plain reference; for the control
seeds the reference computed in TF32 put in the program's place; for the
fault seeds the program with a fault planted underneath its entry points
(``half_batch``: the joint loss sees half of the step's rays and takes its
means over them; ``pose_grad_zeroed``: the poses' gradient is zeroed
before Adam).

    python3 -m benchmark.tools.readings_joint --workload joint.refine.office \
        --seeds 1 2 3 [--control 1 2 3] \
        [--fault half_batch --fault-seeds 1 2 3] \
        [--out readings.jsonl]

One JSON line per reading on standard output (and in ``--out``): the
compared numbers, and under ``*_notes`` the worst view's change, the
median view's gradient and the gate pairs on which the two gates
disagree with the largest distance of such a pair from its threshold.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import harness

FAULTS = ("none", "half_batch", "pose_grad_zeroed")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted underneath its entry points."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "none":
        yield
        return
    from vf_nerf_torch.train.joint_runner import JointOptimizationRunner as J
    name = "_joint_loss" if fault == "half_batch" else "_grads"
    own = getattr(J, name)

    def half_batch(self, batch, draws, *a, **k):
        n = len(batch["uv"]) // 2
        return own(self, {key: v[:n] for key, v in batch.items()},
                   draws and {key: None if v is None else v[:n]
                              for key, v in draws.items()}, *a, **k)

    def pose_grad_zeroed(self, total, with_model):
        model_grads, pose_grad = own(self, total, with_model)
        return model_grads, torch.zeros_like(pose_grad)

    setattr(J, name, half_batch if fault == "half_batch" else
            pose_grad_zeroed)
    try:
        yield
    finally:
        setattr(J, name, own)


@contextlib.contextmanager
def gate_margins(ref, into: list):
    """Record, for each gate held to the reference's own, the pairs on
    which the two disagree and the largest distance of such a pair from
    the nearer of its thresholds (``plain/joint.py::gate_choice``)."""
    own = ref.gate_choice

    def recorded(miss, cos, theirs):
        if theirs is not None and theirs.shape == miss.shape:
            differ = theirs != ref.gate_of(miss, cos)
            thr = 0.5 * miss.max()
            margin = torch.minimum((cos - 0.5).abs(),
                                   (miss - thr).abs() / thr)
            into.append((int(differ.sum()), float(margin[differ].max())
                         if bool(differ.any()) else 0.0))
        return own(miss, cos, theirs)
    ref.gate_choice = recorded
    try:
        yield
    finally:
        ref.gate_choice = own


def readings(cell, seed: int, device, control: bool,
             fault: str = "none") -> dict:
    from benchmark.kinds.joint import compare
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, t_start=time.perf_counter())
    driver = cell.kind.Driver(run)
    with planted(fault):
        driver.setup()
    driver.memory_peak()
    driver.release()
    harness.free_device()
    gates: list = []
    notes: dict = {}
    with gate_margins(cell.hooks.reference, gates):
        program = driver.check(notes)
    notes.update(gate_differ=[g[0] for g in gates],
                 gate_differ_margin=max((g[1] for g in gates), default=0.0))
    out = {"cell": cell.name, "seed": seed, "fault": fault,
           "program": program, "program_notes": notes}
    if control:
        low = driver.reference_readings(tf32=True)
        gates = []
        with gate_margins(cell.hooks.reference, gates):
            ref = driver.reference_readings(theirs=low["choices"])
        notes = {"gate_differ": [g[0] for g in gates],
                 "gate_differ_margin": max((g[1] for g in gates),
                                           default=0.0)}
        out["control"] = dict(compare(low, ref, driver.weights,
                                      driver.start_poses, run.log, notes),
                              choices_off=float(ref["choices_off"]),
                              gate_off=float(ref["gate_off"]))
        out["control_notes"] = notes
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default="none", choices=FAULTS)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    jobs = [(s, s in args.control, "none") for s in args.seeds]
    jobs += [(s, True, "none") for s in args.control if s not in args.seeds]
    jobs += [(s, False, args.fault) for s in args.fault_seeds]
    for seed, control, fault in jobs:
        t0 = time.perf_counter()
        line = readings(cell, seed, device, control, fault)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        harness.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
