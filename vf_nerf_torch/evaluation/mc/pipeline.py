"""VF mesh extraction on the host: grid eval → field ops → contrastive MC
(port of ``vf_nerf_tpu/evaluation/mc/pipeline.py``; reference
``evaluation/methods.py:139-322`` (``marching_cubes_mesh``) and ``:74-137``
(``quadrant_marching_cubes``)).

The evaluation methods run ``device_pipeline.DeviceMeshExtractor``; this
numpy pipeline is its host counterpart, and ``quadrant_translations`` gives
the octants of both. Reproduced semantics:

- sampling grid: ``res³`` points over ``[-scale, scale]³ + translation +
  centroid``, x slowest / z fastest, spacing ``2·scale/(res−1)``
  (``methods.py:190-208``),
- optional Gaussian pre-smooth (k=3, σ=1) before the divergence and
  post-smooth (k=9, σ=2) before norms/directions (``:213-221``),
- mesh vertices come from the canonical ``res+1``-node ``[-1, 1]`` grid and
  are then scaled by ``scale`` and shifted by ``translation + centroid``
  (``:289-322``) — including the reference's (res−1)/res scale quirk between
  sample and mesh space,
- quadrant mode: 8 / 35 / 64 sub-cube translations whose meshes concatenate
  (``:101-124``).
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np

from vf_nerf_torch.evaluation.mc import field_ops
from vf_nerf_torch.evaluation.mc.contrastive import contrastive_marching_cubes
from vf_nerf_torch.evaluation.mc.smoothing import smooth_vf_np


def sample_grid(resolution: int, scale: float, centroid: np.ndarray,
                translation: np.ndarray) -> np.ndarray:
    """(res³, 3) sample positions, x slowest (reference index math,
    ``methods.py:194-208``)."""
    idx = np.arange(resolution, dtype=np.float64)
    voxel_size = scale * 2.0 / (resolution - 1)
    coords = idx * voxel_size - scale
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return (pts + translation + centroid).astype(np.float32)


def evaluate_vf_grid(vf_fn: Callable[[np.ndarray], np.ndarray],
                     samples: np.ndarray, max_batch: int) -> np.ndarray:
    """Chunked field evaluation (reference ``get_set_predictions``,
    ``mc_utils.py:88-104``): ``vf_fn`` maps (n, 3) float32 points to (n, 3)
    values, ``max_batch`` points at a time."""
    n = samples.shape[0]
    out = np.empty((n, 3), np.float32)
    for head in range(0, n, max_batch):
        tail = min(head + max_batch, n)
        out[head:tail] = np.asarray(vf_fn(samples[head:tail]))
    return out


def extract_vf_mesh(vf_fn: Callable[[np.ndarray], np.ndarray],
                    resolution: int,
                    scale: float,
                    centroid: np.ndarray,
                    translation: np.ndarray,
                    max_batch: int = 100000,
                    smooth_before: bool = False,
                    smooth_after: bool = False,
                    world_coords: bool = True,
                    alternative: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Full single-cube extraction (reference ``marching_cubes_mesh``).

    :param world_coords: True → vertices scaled/translated to world space
        (the reference's ``mesh-scaled-*.ply``); False → canonical cube
        coordinates (its ``mesh-*.ply``).
    :param alternative: replace the side-assignment crossing flags with the
        pair-convergence test (reference ``alternative=True`` path,
        ``methods.py:229-245,268-270``; MeshUDF-style criterion).
    """
    res = resolution
    samples = sample_grid(res, scale, centroid, translation)
    prediction = evaluate_vf_grid(vf_fn, samples, max_batch)
    grid = prediction.reshape(res, res, res, 3)

    if smooth_before:
        grid = smooth_vf_np(grid, k=3, sigma=1.0)
    surface = field_ops.extract_divergence(grid)
    if smooth_after or smooth_before:
        grid = smooth_vf_np(grid, k=9, sigma=2.0)

    norms = np.linalg.norm(grid, axis=-1)
    vt = grid / np.maximum(norms[..., None], 1e-12)

    cells = np.argwhere(surface > 0.5)
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    choice = field_ops.unify_direction(surface, vt, cells)
    comb_values, pair_norms = field_ops.make_comb_format(choice, norms, cells)

    if alternative:
        vt_pairs = field_ops.pair_corner_values(vt, cells)
        pts_grid = samples.reshape(res, res, res, 3)
        point_pairs = field_ops.pair_corner_values(pts_grid, cells)
        comb_values = field_ops.easy_convergence_points(
            vt_pairs, point_pairs, step=2.0 / res)

    has_crossing = comb_values.sum(axis=1) > 0
    cells = cells[has_crossing]
    comb_values = comb_values[has_crossing]
    pair_norms = pair_norms[has_crossing]
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    verts, faces = contrastive_marching_cubes(comb_values, pair_norms, cells,
                                              resolution=res)
    if world_coords and len(verts):
        verts = verts * scale + (translation + centroid).astype(np.float32)
    return verts, faces


def quadrant_translations(num_quadrants: int, scale: float
                          ) -> Iterator[Tuple[np.ndarray, float]]:
    """(translation, sub-scale) pairs (reference ``quadrant_marching_cubes``,
    ``methods.py:101-124``): 8 octants, 64 sub-cubes, or 35 = 27 + 8."""
    assert num_quadrants in (8, 35, 64)

    def cartesian(values: np.ndarray) -> np.ndarray:
        a, b, c = np.meshgrid(values, values, values, indexing="ij")
        return np.stack([a, b, c], axis=-1).reshape(-1, 3)

    if num_quadrants == 35:
        s = scale / 3.0
        for t in cartesian(np.array([-2 * s, 0.0, 2 * s], np.float32)):
            yield t, s
    if num_quadrants in (8, 35):
        s = scale / 2.0
        values = np.array([-s, s], np.float32)
    else:
        s = scale / 4.0
        values = np.array([-3 * s, -s, 3 * s, s], np.float32)
    for t in cartesian(values):
        yield t, s
