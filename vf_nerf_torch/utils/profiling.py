"""Tracing and debug hooks (port of ``vf_nerf_tpu/utils/profiling.py``).

- ``span(name)``: a context manager that records a host span, ``(name,
  native thread id, start ns, end ns)`` on ``time.time_ns()``, while a
  ``torch.profiler`` session is active, and does nothing otherwise (one
  check of torch's process-wide flag, one shared no-op context). Kineto
  writes a Chrome trace's ``ts`` in µs after its ``baseTimeNanoseconds``,
  on the same unix clock, and converts the device's timestamps to it, so a
  span lines up with the kernels it launched. The spans go into a bounded
  buffer, cleared when a profiler session begins; ``spans()`` returns them;
- ``trace(log_dir)``: a ``torch.profiler`` context over the CPU and, when
  there is one, the CUDA device, writing a Chrome trace
  (``trace.json``) into ``log_dir`` or ``$VFNERF_PROFILE_DIR``, with the
  session's spans as ``ph: "X"`` events on their threads; with neither it
  does nothing;
- ``maybe_enable_nan_debugging()``: ``torch.autograd.set_detect_anomaly``
  when ``$VFNERF_DEBUG_NANS`` is set (not "", "0" or "false"), so a
  backward that makes a NaN raises with the forward op's traceback (slow).
  The runner calls it where the JAX runner does.

The spans of the program (a metric of ``benchmark/metrics`` reads each):

- main thread: ``train.epoch_start`` (``train_epoch`` up to its first
  step), ``train.feed_wait`` (blocked on the next batch),
  ``train.step`` with ``.draw``, ``.forward`` (``.fold`` inside),
  ``.backward`` (with the all-reduce) and ``.optimizer``,
  ``train.epoch_read`` (the epoch's sums copied out, the previous epoch
  read and logged), ``train.sample_images`` (a dataset's per-epoch
  resampling), ``render.chunk`` (an eval chunk) and, inside a render,
  ``render.fold``, ``render.coarse``, ``render.sample``, ``render.fine``,
  ``render.march``; the joint stage's ``joint.step`` with ``.forward``,
  ``.backward`` and ``.optimizer``, ``joint.supervise`` with ``.bases``,
  ``.batch`` and ``.step``, ``joint.epoch_read`` and ``joint.feed_wait``
  (``train/joint_runner.py``);
- the feed worker: ``feed.assemble`` (the dataset's next batch),
  ``feed.pack`` and ``feed.copy`` (pinned, to the device).

The JAX package's ``StepTimer`` is not ported: the runner reads its own
rays/s at each epoch's end.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

Span = Tuple[str, int, int, int]     # name, native thread id, start, end ns

# The newest spans of the current session; a deque's append and clear are
# atomic, so the feed worker and the main thread record without a lock.
MAX_SPANS = 1 << 18
_SPANS: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Recording":
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        _SPANS.append((self.name, threading.get_native_id(), self.start,
                       time.time_ns()))


def span(name: str):
    """Record ``name`` over the ``with`` block while a profiler session is
    active (every thread sees torch's flag, not only the one that started
    the session)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def spans() -> List[Span]:
    """The spans recorded since the current or last session began."""
    return list(_SPANS)


def _clear_at_session_start(start):
    def run_on_profiler_start():
        _SPANS.clear()
        start()
    run_on_profiler_start.__wrapped__ = start
    return run_on_profiler_start


# torch calls this hook as every profiler session begins.
if not hasattr(_autograd_profiler._run_on_profiler_start, "__wrapped__"):
    _autograd_profiler._run_on_profiler_start = _clear_at_session_start(
        _autograd_profiler._run_on_profiler_start)


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Write ``recorded`` into the Chrome trace at ``path`` as complete
    events on this process and their threads, on the trace's clock."""
    with open(path) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    pid = os.getpid()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
         "tid": tid, "ts": (start - base) / 1e3, "dur": (end - start) / 1e3}
        for name, tid, start, end in recorded)
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace written to ``log_dir/trace.json`` when a
    directory is given or configured, with the program's spans; a no-op
    otherwise."""
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
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans())


def maybe_enable_nan_debugging() -> bool:
    """Turn on autograd's anomaly detection when ``VFNERF_DEBUG_NANS`` is
    set; returns whether it did."""
    if os.environ.get("VFNERF_DEBUG_NANS", "") not in ("", "0", "false"):
        torch.autograd.set_detect_anomaly(True)
        return True
    return False
