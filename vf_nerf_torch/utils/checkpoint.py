"""Checkpoint files (port of ``vf_nerf_tpu/utils/checkpoint.py:33-60``;
reference ``models/nerf/vector_field_nerf.py:196-214``).

A save writes one blob as ``{epoch}.ckpt`` and as ``latest.ckpt`` under the
run's ``checkpoints/vf_nerf/``, each published atomically through a
``.tmp`` file and ``os.replace``, so a crash never leaves a torn
``latest``. The blob is ``torch.save`` of a dict of tensors, lists and
numbers, read back with ``torch.load(weights_only=True)``. The JAX
package's checkpoints are flax msgpack; this package does not read them.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict

import torch


def save_checkpoint(path_dir: str, epoch: int, state: Dict[str, Any]) -> str:
    """Write ``state`` to ``{epoch}.ckpt`` and ``latest.ckpt`` in
    ``path_dir``; returns the epoch file's path."""
    os.makedirs(path_dir, exist_ok=True)
    buffer = io.BytesIO()
    torch.save(state, buffer)
    payload = buffer.getvalue()
    epoch_path = os.path.join(path_dir, f"{epoch}.ckpt")
    for path in (epoch_path, os.path.join(path_dir, "latest.ckpt")):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    return epoch_path


def load_checkpoint(path: str, device) -> Dict[str, Any]:
    """The blob of ``save_checkpoint``, its tensors on ``device``."""
    return torch.load(path, map_location=device, weights_only=True)
