"""The benchmark's general part: what it finds by name and how one run goes.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration as it is run (the conf's
  sections); ``configs/<config>.py``: its FLOP counts and its plain
  reference (``benchmark/plain/``);
- ``traffic/<traffic>.json``: the traffic mix; its ``kind`` names the
  driver ``kinds/<kind>.py`` that generates it;
- ``workloads/<cell>.json``: the cell's correctness limits and the
  readings they were set from;
- ``metrics/<metric>.py``: a reader with ``read(trace) -> float | None``.

A run: set-up (build the program, warm up every shape, the checked first
steps or chunks), the window, the comparison with the plain reference once
the program's state is freed, and the result as the last line of standard
output.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# The modules no run may hold: JAX and the package this program was ported
# from, compared by whole top-level names.
FORBIDDEN = ("jax", "jaxlib", "flax", "vf_nerf_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (the run exits non-zero)."""


def forbidden_modules(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise RunError(f"no file {path.relative_to(ROOT)}")
    name = "benchmark_file_" + path.relative_to(HERE).as_posix().replace(
        "/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    name: str
    config_name: str
    conf: dict
    hooks: ModuleType            # configs/<config>.py
    traffic_name: str
    traffic: dict
    kind: ModuleType             # kinds/<kind>.py
    limits: dict                 # workloads/<cell>.json ["limits"]
    end_to_end: List[dict]
    per_layer: List[dict]


def bench_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str, spec: Optional[dict] = None) -> Cell:
    spec = bench_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = configs[w["config"]]
    conf = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    cell_file = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(
        name=name, config_name=w["config"], conf=conf,
        hooks=load_module(HERE / "configs" / f"{w['config']}.py"),
        traffic_name=w["traffic"], traffic=traffic,
        kind=load_module(HERE / "kinds" / f"{traffic['kind']}.py"),
        limits=cell_file["limits"],
        end_to_end=[m for m in spec["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=per_layer_of(spec, name))


def per_layer_of(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def read_per_layer(metrics: List[dict], trace: Any) -> Dict[str, dict]:
    """Each per-layer metric's reader on the traced window; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ------------------------------------------------------------------ seeds
def sub_seed(seed: int, what: str) -> int:
    """A 31-bit seed for one use, from the run's seed (any whole number)."""
    import numpy as np
    words = [ord(c) for c in what]
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, *words])
    return int(state.generate_state(1)[0] & 0x7FFFFFFF)


# ------------------------------------------------------------- the checks
def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a missing or non-finite number
    fails)."""
    return all(k in numbers and math.isfinite(numbers[k]) and
               numbers[k] <= v for k, v in limits.items())


def print_checks(numbers: Dict[str, float], limits: Dict[str, float]) -> None:
    for k in limits:
        print(f"check {k}: {numbers.get(k)!r} limit {limits[k]!r}",
              file=sys.stderr, flush=True)


def free_device() -> None:
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- the run
@dataclasses.dataclass
class Run:
    """What a kind's driver needs: the cell, the seed, the window's
    seconds, the trace flag, the device and the process's start."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                 flush=True)


def device_record(device, peak: Optional[int]) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(run: Run) -> dict:
    """One run of one cell: the result object (the last line)."""
    cell = run.cell
    driver = cell.kind.Driver(run)
    driver.setup()
    setup_s = time.perf_counter() - run.t_start
    run.log(f"setup_s {setup_s!r}")
    result: Dict[str, Any] = {}
    if run.trace:
        traced = driver.traced()
        metrics = read_per_layer(cell.per_layer, traced)
        missing = [m["name"] for m in cell.per_layer
                   if m["name"] not in metrics]
        if missing:
            run.log(f"per-layer metrics with nothing to read: {missing}")
        result["breakdown"] = traced.breakdown()
        extra = {"busy_s": traced.busy_s, "window_s": traced.window_s}
    else:
        measured = driver.window()
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        extra = {}
    peak = driver.memory_peak()
    attempted = driver.attempted
    driver.release()
    free_device()
    numbers = driver.check()
    correct = judge(numbers, cell.limits)
    print_checks(numbers, cell.limits)
    failed = driver.failed
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or its package were loaded: {found}")
    device = dict(device_record(run.device, peak), **extra)
    result = dict({"correct": correct, "attempted": attempted,
                   "failed": failed, "metrics": metrics, "device": device},
                  **result)
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result
