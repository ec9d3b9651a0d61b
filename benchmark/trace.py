"""The traced window: ``torch.profiler`` with CUDA activity only (CPU
activity would slow the host and inflate the idle share), read from its
Chrome trace.

``busy_s`` is the union of the device's kernel, copy and set intervals
(overlapping work counted once), ``window_s`` the host's wall seconds from
the synchronize before the window to the one that ends it. A window with no
device record fails the run: no share is ever computed from nothing.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Tuple

from benchmark.harness import HERE, RunError, load_json

PEAKS = load_json(HERE / "peaks.json")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Traced:
    """What the per-layer readers see: the device records of the traced
    window, its wall seconds, the units of work it held (steps or chunks,
    under ``unit``) and the work one unit needs (``work``: FLOPs by part,
    from the configuration's counts)."""

    def __init__(self, records: List[Tuple[str, str, float, float]],
                 window_s: float, unit: str, units: int,
                 work: Dict[str, float]) -> None:
        self.records = records          # (category, name, start us, dur us)
        self.window_s = window_s
        self.unit = unit
        self.units = units
        self.work = work
        self.peaks = PEAKS
        self.kernels = [r for r in records if r[0] == "kernel"]
        self.intervals = merged([(r[2], r[2] + r[3]) for r in records])
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(r[3] for r in self.kernels if rx.search(r[1])) / 1e6

    def breakdown(self) -> dict:
        """The ten costliest kernels by name, and the ten longest idle gaps,
        each named by the kernel the device finished before it."""
        by_name: Dict[str, float] = {}
        for _, name, _, dur in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        ends = sorted((r[2] + r[3], r[1]) for r in self.records)
        gaps = []
        j = 0
        for (a0, a1), (b0, _) in zip(self.intervals, self.intervals[1:]):
            while j + 1 < len(ends) and ends[j + 1][0] <= a1:
                j += 1
            gaps.append((f"after {ends[j][1][:100]}", (b0 - a1) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile(fn: Callable[[], int], unit: str,
            work: Dict[str, float]) -> Traced:
    """Trace ``fn`` (which returns the units of work it ran) between two
    synchronizes."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    records = [(e["cat"], e.get("name", ""), float(e["ts"]), float(e["dur"]))
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not any(r[0] == "kernel" for r in records):
        raise RunError("the profiler returned no device records")
    return Traced(records, window_s, unit, units, work)
