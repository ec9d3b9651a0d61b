"""A configuration, a traffic mix, a cell and a per-layer metric are added
by files alone: a copy of the benchmark with new files (and new entries in
BENCHMARK.json) runs the new cell and reads the new metric, and no file
that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import ROOT

SCRIPT = r"""
import json, sys, time
import torch
from benchmark import harness, trace
from benchmark.tests.conftest import narrow
cell = harness.find_cell("dummy.train.tiny")
cell.conf = narrow(cell.conf)
run = harness.Run(cell=cell, seed=5, seconds=0.1, trace=False,
                  device=torch.device("cpu"), t_start=time.perf_counter(),
                  log=lambda s: None)
result = harness.run_cell(run)
fake = trace.Traced([("kernel", "k", 0.0, 1.0)], 1.0, "step", 7, {})
per_layer = harness.read_per_layer(cell.per_layer, fake)
print(json.dumps({"result": result, "per_layer": per_layer,
                  "file": harness.__file__}))
"""


def digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in base:
                continue
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_added_files_make_a_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "vf_nerf.json").read_text())
    conf["name"] = "dummy"
    (b / "configs" / "dummy.json").write_text(json.dumps(conf))
    (b / "configs" / "dummy.py").write_text(
        (b / "configs" / "vf_nerf.py").read_text())
    traffic = json.loads((b / "traffic" / "train.office.json").read_text())
    traffic.update(scene={"n_views": 4, "image_size": [16, 24],
                          "pitch_range": 1.1}, pixels_per_batch=64,
                   fine_count=8)
    (b / "traffic" / "train.tiny.json").write_text(json.dumps(traffic))
    (b / "workloads" / "dummy.train.tiny.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-2, "batch_rows_off": 0}}))
    (b / "metrics" / "steps_seen.train.py").write_text(
        "def read(t):\n    return float(t.units)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="dummy",
                                file="benchmark/configs/dummy.json"))
    spec["workloads"].append({"name": "dummy.train.tiny", "config": "dummy",
                              "traffic": "train.tiny", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("dummy.train.tiny")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "test", "moves": "train_rays_per_s",
                              "workloads": ["dummy.train.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=tmp_path, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["file"].startswith(str(tmp_path))
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert "steps_seen.train" in out["per_layer"]
    assert out["per_layer"]["steps_seen.train"]["value"] == 7.0
    after = digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
