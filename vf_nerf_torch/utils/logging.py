"""Experiment metric logging (port of ``vf_nerf_tpu/utils/logging.py``;
reference ``train/vector_field_nerf_train.py:71-77, 284-291``).

The sink is one JSONL file per run, ``<run_dir>/metrics.jsonl``: a config
line, then one line per logged step (all loss terms, the learned density
β/mean/scale, the learning rate, the window taps w_0..w_10 and rays/s). A
wandb run mirrors it when the package is importable and ``offline`` is
False.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """JSONL metrics sink with optional wandb mirroring."""

    def __init__(self, run_dir: str, project: str, run_name: str,
                 run_id: str, config: Optional[Dict[str, Any]] = None,
                 offline: bool = False) -> None:
        self.path = os.path.join(run_dir, "metrics.jsonl")
        os.makedirs(run_dir, exist_ok=True)
        self._step = 0
        self._wandb = None
        if not offline:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                try:
                    self._wandb = wandb.init(project=project, name=run_name,
                                             config=config, resume="allow",
                                             id=run_id)
                except Exception as exc:  # noqa: BLE001 the mirror is optional
                    print(f"MetricsLogger: no wandb mirror ({exc!r}); the "
                          f"JSONL file {self.path} is the record")
        if config is not None and not os.path.exists(self.path):
            self._write({"_type": "config", "config": config})

    def _write(self, payload: Dict[str, Any]) -> None:
        payload = dict(payload)
        payload.setdefault("_time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")

    def log(self, metrics: Dict[str, float],
            step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._write({"_type": "metrics", "step": step, **metrics})
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        self._step = step + 1
