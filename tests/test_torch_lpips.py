"""The port's LPIPS against the JAX package's, on the CPU.

- The gate: ``lpips_available`` is false and ``get_lpips`` raises, naming
  the exporter, without a weights file (as
  ``tests/test_tools.py::TestLpips::test_gate_and_error_when_unavailable``);
  the argument, then ``$VF_NERF_LPIPS_WEIGHTS``, picks the file in both
  packages alike.
- ``get_lpips`` on generated npz weights of VGG16's 13-conv / 5-tap
  structure equals JAX's ``get_lpips`` on the same file: tiny channel
  counts and VGG16's own (64 .. 512), rtol 1e-5 (convolutions summed in
  another order); d(x, x) = 0 and symmetry as JAX's test checks.
"""

import numpy as np
import pytest
import torch

from vf_nerf_tpu.utils import metrics as jmetrics
from vf_nerf_torch.utils import metrics


def _write_tiny_lpips_npz(path, widths=(4, 4, 8, 8, 8), seed=0):
    """An LPIPS weights npz with the real 13-conv/5-tap structure but tiny
    channel counts (a copy of ``tests/test_tools.py``'s writer)."""
    rng = np.random.RandomState(seed)
    blocks = ((widths[0],) * 2, (widths[1],) * 2, (widths[2],) * 3,
              (widths[3],) * 3, (widths[4],) * 3)
    arrays, in_c, i = {}, 3, 0
    for block in blocks:
        for out_c in block:
            arrays[f"conv{i}_w"] = rng.randn(out_c, in_c, 3, 3).astype(
                np.float32) * 0.3
            arrays[f"conv{i}_b"] = rng.randn(out_c).astype(np.float32) * 0.1
            in_c = out_c
            i += 1
    for j, w in enumerate(widths):
        arrays[f"lin{j}"] = np.abs(rng.randn(w)).astype(np.float32)
    np.savez(path, **arrays)


def test_gate_and_error_when_unavailable(tmp_path, monkeypatch):
    missing = str(tmp_path / "nope.npz")
    monkeypatch.setenv("VF_NERF_LPIPS_WEIGHTS", missing)
    assert not metrics.lpips_available() and not jmetrics.lpips_available()
    assert metrics.lpips_weights_path() == jmetrics.lpips_weights_path()
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="export_lpips_weights"):
        metrics.get_lpips(img, img)
    with pytest.raises(ValueError, match="vgg"):
        metrics.get_lpips(img, img, net="alex")
    path = str(tmp_path / "w.npz")
    _write_tiny_lpips_npz(path)
    assert metrics.lpips_available(path)
    assert metrics.lpips_weights_path(path) == \
        jmetrics.lpips_weights_path(path)
    monkeypatch.delenv("VF_NERF_LPIPS_WEIGHTS")
    assert metrics.lpips_weights_path() == jmetrics.lpips_weights_path()


@pytest.mark.parametrize("widths,size", [((4, 4, 8, 8, 8), 32),
                                         ((64, 128, 256, 512, 512), 32)],
                         ids=["tiny", "vgg16_widths"])
def test_lpips_equals_jax(widths, size, tmp_path, monkeypatch):
    path = str(tmp_path / "lpips.npz")
    _write_tiny_lpips_npz(path, widths=widths, seed=7)
    monkeypatch.setenv("VF_NERF_LPIPS_WEIGHTS", path)
    rng = np.random.RandomState(3)
    a = rng.rand(size, size, 3).astype(np.float32)
    b = np.clip(a + rng.randn(size, size, 3).astype(np.float32) * 0.2, 0, 1)
    ours = metrics.get_lpips(a, b)
    theirs = jmetrics.get_lpips(a, b)
    assert ours > 1e-4
    assert ours == pytest.approx(theirs, rel=1e-5)
    assert metrics.get_lpips(a, a) == pytest.approx(0.0, abs=1e-6)
    assert metrics.get_lpips(b, a) == pytest.approx(ours, rel=1e-5)
    # Tensors run on their own device (the CPU here).
    assert metrics.get_lpips(torch.from_numpy(a), torch.from_numpy(b)) == \
        pytest.approx(ours, rel=1e-6)
