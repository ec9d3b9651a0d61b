"""Vector-field quiver plots (port of ``vf_nerf_tpu/evaluation/plots.py``;
reference ``evaluation/methods.py:325-471``).

- ``plot_2d_slices``: xy-plane quivers of the field at several z levels,
- ``plot_overall_scene``: one large xy quiver through the scene centre,
- ``plot_3d_slices``: small xy quivers on a stack of z slices.

Artifacts land in ``<eval>/plots*/...png``. The field comes from
``VectorFieldNerf.get_vector_field`` on the model's device and is drawn on
the host. ``matplotlib`` is imported only inside ``_quiver_png``, as the
JAX package does, so a machine without it (the card's) runs
``_field_on_slice`` and then raises the ``ImportError`` that names it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from vf_nerf_torch.evaluation.mc.smoothing import smooth_vf_np
from vf_nerf_torch.utils import io as io_utils


def _field_on_slice(model, z: float, scale: float, centroid: np.ndarray,
                    n: int, smooth: bool) -> tuple:
    """(points (n², 3), field (n², 3)) on the n × n xy grid over ±scale
    around ``centroid`` at height ``z`` above it; ``smooth``: the field
    smoothed as a (n, n, 1) grid (k 3, σ 1)."""
    xs = np.linspace(-scale, scale, n) + centroid[0]
    ys = np.linspace(-scale, scale, n) + centroid[1]
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.reshape(-1), gy.reshape(-1),
                    np.full(n * n, z + centroid[2])], axis=1)
    vf = model.get_vector_field(pts.astype(np.float32)).cpu().numpy()
    if smooth:
        vf = smooth_vf_np(vf.reshape(n, n, 1, 3), k=3,
                          sigma=1.0).reshape(-1, 3)
    return pts, vf


def _quiver_png(pts: np.ndarray, vf: np.ndarray, path: str,
                title: str, quiver_scale: float = 30.0) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    norms = np.linalg.norm(vf[:, :2], axis=1)
    ax.quiver(pts[:, 0], pts[:, 1], vf[:, 0], vf[:, 1], norms,
              cmap="viridis", scale=quiver_scale)
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_2d_slices(model, path: str, scale: float, centroid: np.ndarray,
                   smooth: bool = False, n: int = 40,
                   n_slices: int = 5) -> None:
    """xy quivers at ``n_slices`` z levels in ±0.8·scale."""
    out_dir = os.path.join(path, "plots-2d-slices" +
                           ("-smoothed" if smooth else ""))
    io_utils.mkdir_ifnotexists(out_dir)
    for i, z in enumerate(np.linspace(-scale * 0.8, scale * 0.8, n_slices)):
        pts, vf = _field_on_slice(model, float(z), scale, centroid, n,
                                  smooth)
        _quiver_png(pts, vf, os.path.join(out_dir, f"slice-{i}.png"),
                    title=f"z = {z + centroid[2]:.2f}")


def plot_overall_scene(model, path: str, scale: float, centroid: np.ndarray,
                       smooth: bool = False, n: int = 80) -> None:
    """One large xy quiver through the centre."""
    out_dir = os.path.join(path, "plots-overall" +
                           ("-smoothed" if smooth else ""))
    io_utils.mkdir_ifnotexists(out_dir)
    pts, vf = _field_on_slice(model, 0.0, scale, centroid, n, smooth)
    _quiver_png(pts, vf, os.path.join(out_dir, "overall.png"),
                title="overall scene (z = centre)")


def plot_3d_slices(model, path: str, smooth: bool = False, n: int = 20,
                   scale: float = 1.0,
                   centroid: Optional[np.ndarray] = None,
                   n_slices: int = 8) -> None:
    """Coarse quivers over ``n_slices`` z slices in ±0.9·scale."""
    centroid = np.zeros(3) if centroid is None else centroid
    out_dir = os.path.join(path, "plots-3d-slices" +
                           ("-smoothed" if smooth else ""))
    io_utils.mkdir_ifnotexists(out_dir)
    for i, z in enumerate(np.linspace(-scale * 0.9, scale * 0.9, n_slices)):
        pts, vf = _field_on_slice(model, float(z), scale, centroid, n,
                                  smooth)
        _quiver_png(pts, vf, os.path.join(out_dir, f"slice-{i}.png"),
                    title=f"z = {z + centroid[2]:.2f}", quiver_scale=20.0)
