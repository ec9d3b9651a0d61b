"""Tracing and debug hooks (port of ``vf_nerf_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` context over the CPU and, when
  there is one, the CUDA device, writing a Chrome trace
  (``trace.json``) into ``log_dir`` or ``$VFNERF_PROFILE_DIR``; with
  neither it does nothing;
- ``maybe_enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly``
  when ``$VFNERF_DEBUG_NANS`` is set (not "", "0" or "false"), so a
  backward that makes a NaN raises with the forward op's traceback (slow).
  The runner calls it where the JAX runner does.

The JAX package's ``StepTimer`` is not ported: the runner reads its own
rays/s at each epoch's end.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace written to ``log_dir/trace.json`` when a
    directory is given or configured; a no-op otherwise."""
    log_dir = log_dir or os.environ.get("VFNERF_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def maybe_enable_nan_debugging() -> bool:
    """Turn on autograd's anomaly detection when ``VFNERF_DEBUG_NANS`` is
    set; returns whether it did."""
    if os.environ.get("VFNERF_DEBUG_NANS", "") not in ("", "0", "false"):
        torch.autograd.set_detect_anomaly(True)
        return True
    return False
