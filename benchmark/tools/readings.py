"""The readings that the correctness limits are set from, for one cell, in
one process: for each seed the program's numbers against the plain
reference; for the control seeds the reference computed in TF32 put in the
program's place; for the fault seeds the program with a fault planted
underneath (``half_batch``: the step sees half of its rays and takes its
means over them; ``altered``: one ray's rgb moved by half its range where the
render produces it).

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1 2 3 \
        [--control 1 2 3] [--fault half_batch --fault-seeds 1 2 3] \
        [--seconds 3] [--out chiprun_out/readings.jsonl]

One JSON line per reading on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import harness


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted underneath its entry points."""
    if fault == "none":
        yield
        return
    if fault == "half_batch":
        from vf_nerf_torch.parallel import train_step as ts
        own = ts.unpack_batch
        ts.unpack_batch = lambda packed: own(packed[:packed.shape[0] // 2])
        try:
            yield
        finally:
            ts.unpack_batch = own
        return
    if fault == "altered":
        from vf_nerf_torch.models import nerf
        own = nerf.render_rays

        def altered(*a, **k):
            out = own(*a, **k)
            out["rgb"] = out["rgb"].clone()
            out["rgb"][0] = (out["rgb"][0] + 0.5) % 1.0
            return out
        nerf.render_rays = altered
        try:
            yield
        finally:
            nerf.render_rays = own
        return
    if fault == "frozen":
        from vf_nerf_torch.models import nerf
        own = nerf.Optimizer.step
        nerf.Optimizer.step = lambda self, params, grads: None
        try:
            yield
        finally:
            nerf.Optimizer.step = own
        return
    raise ValueError(f"unknown fault {fault!r}")


def readings(cell, seed: int, seconds: float, device, control: bool,
             fault: str = "none") -> dict:
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=device, t_start=time.perf_counter())
    driver = cell.kind.Driver(run)
    with planted(fault):
        driver.setup()
        if cell.traffic["kind"] == "render":
            driver.window()
    driver.memory_peak()
    driver.release()
    harness.free_device()
    out = {"cell": cell.name, "seed": seed, "fault": fault,
           "program": driver.check()}
    if control:
        out["control"] = control_numbers(cell, driver)
    if cell.traffic["kind"] == "render":
        out["rays"] = render_diagnostics(driver)
    return out


def control_numbers(cell, driver) -> dict:
    """The reference computed in TF32, judged as the program is."""
    if cell.traffic["kind"] == "train":
        from benchmark.kinds.train import compare
        ref = driver.reference_readings()
        low = driver.reference_readings(tf32=True)
        return compare(low, ref, driver.weights, driver.run.log)
    from benchmark.kinds.render import compare
    picks = driver.sample()
    ref = driver.reference_chunks(picks)
    low = driver.reference_chunks(picks, tf32=True)
    return compare([(r[0], r[1]) for r in low], ref, driver.run.log)


def render_diagnostics(driver) -> dict:
    """The worst rays' gaps beside the reference's coarse-weight margin
    (top two weights' relative gap): a tie to rounding moves the fine
    window."""
    picks = driver.sample()
    ref = driver.reference_chunks(picks)
    worst = []
    for (i, c), r in zip(picks, ref):
        rgb, depth = driver.program_chunk(i, c)
        gap = (rgb - r[0]).abs().amax(-1)
        top = torch.topk(r[2], 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]) / top[:, 0].clamp(min=1e-30)
        for j in torch.argsort(gap, descending=True)[:3].tolist():
            worst.append([float(gap[j]), float((depth[j] - r[1][j]).abs()),
                          float(margin[j]), int(torch.argmax(r[2][j]))])
    worst.sort(key=lambda w: -w[0])
    all_margins = []
    for r in ref:
        top = torch.topk(r[2], 2, dim=-1).values
        all_margins.append((top[:, 0] - top[:, 1]) / top[:, 0].clamp(
            min=1e-30))
    m = torch.cat(all_margins)
    return {"worst": worst[:10],
            "margin_below": {str(x): int((m < x).sum())
                             for x in (1e-6, 1e-5, 1e-4, 1e-3)},
            "rays": int(m.numel())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default="none")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
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
        line = readings(cell, seed, args.seconds, device, control, fault)
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
