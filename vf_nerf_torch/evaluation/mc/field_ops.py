"""Vector-field grid operations feeding contrastive marching cubes, in numpy
(port of ``vf_nerf_tpu/evaluation/mc/field_ops.py``; reference
``evaluation/utils/mc_utils.py``). Three stages:

- ``extract_divergence`` (``mc_utils.py:34-85``): per 2×2×2 cell, the flux of
  the normalized field through the cell corners — ``Σ_c d_c·|d_c|·A / V``
  with ``d_c = v(corner_c)·dir_c``, ``dir_c = normalize(corner offset − ½)``,
  A = √3/4, V = √2/3; cells with divergence ≤ −0.5 are surface cells.
- ``unify_direction`` (``:107-167``): per surface cell, gather the 8 corner
  vectors, find the most-opposed pair (max ``1 − v_a·v_b``), and assign every
  corner to whichever anchor is closer — a binary side label per corner.
- ``make_comb_format`` (``:170-223``): for the 28 corner pairs, flag pairs on
  different sides and carry the two corners' field norms (the pseudo-UDF).

The reference builds these out of conv3d scatter tricks on the full N³ grid;
here the corner gathers are shifted-slice views (zero fill past the top face,
matching conv3d's zero padding) and the pair logic is vectorized einsum over
the *surface cells only*, so memory stays proportional to the surface.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vf_nerf_torch.evaluation.mc.tables import (COMB_I, COMB_J,
                                              CORNER_OFFSETS)

FACE_AREA = np.sqrt(3.0) / 4.0
SHAPE_VOLUME = np.sqrt(2.0) / 3.0


def _normalize(v: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, eps)


def extract_divergence(vf: np.ndarray, threshold: float = -0.5) -> np.ndarray:
    """(N, N, N, 3) field → (N, N, N) binary surface-cell grid.

    Cell values live at ``[:-1, :-1, :-1]`` (the last slab has no cell),
    matching the reference's scatter (``mc_utils.py:79-84``).
    """
    n = vf.shape[0]
    vt = _normalize(vf.astype(np.float64))
    div = np.zeros((n - 1, n - 1, n - 1), np.float64)
    # The divergence filter uses its own z-fastest corner enumeration
    # (mc_utils.py:48-55); the sum over corners makes the order irrelevant
    # as long as offsets pair with their directions.
    for idx in range(8):
        off = np.array([(idx // 4) % 2, (idx // 2) % 2, idx % 2])
        direction = _normalize((2.0 * off - 1.0).astype(np.float64))
        corner = vt[off[0]:off[0] + n - 1,
                    off[1]:off[1] + n - 1,
                    off[2]:off[2] + n - 1]
        d = corner @ direction
        div += d * np.abs(d) * FACE_AREA
    div /= SHAPE_VOLUME

    surface = np.zeros((n, n, n), np.float32)
    surface[:-1, :-1, :-1] = (div <= threshold).astype(np.float32)
    return surface


def _gather_corners(grid: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """grid (N, N, N, ...) + cell indices (M, 3) → (M, 8, ...) corner values
    with zero fill past the top face (conv3d zero-padding semantics,
    ``mc_utils.py:123-128``)."""
    n = grid.shape[0]
    pad_width = [(0, 1)] * 3 + [(0, 0)] * (grid.ndim - 3)
    padded = np.pad(grid, pad_width)
    idx = cells[:, None, :] + CORNER_OFFSETS[None, :, :]  # (M, 8, 3)
    return padded[idx[..., 0], idx[..., 1], idx[..., 2]]


def unify_direction(surface: np.ndarray, vt: np.ndarray,
                    cells: np.ndarray) -> np.ndarray:
    """Per-cell corner side labels (reference ``unify_direction``).

    :param surface: unused beyond the caller's cell selection; kept for
        signature clarity.
    :param vt: (N, N, N, 3) normalized field.
    :param cells: (M, 3) surface cell indices.
    :return: (M, 8) side labels in {0, 1}.
    """
    corners = _gather_corners(vt, cells)  # (M, 8, 3)
    # Most-opposed pair: argmax of 1 - v_a·v_b over the full 8×8 matrix
    # (row-major flat argmax, matching mc_utils.py:130-139).
    dots = np.einsum("mac,mbc->mab", corners, corners)
    flat = (1.0 - dots).reshape(-1, 64)
    extreme = np.argmax(flat, axis=-1)
    first = extreme // 8
    second = extreme % 8
    m = np.arange(len(cells))
    v_first = corners[m, first]      # (M, 3)
    v_second = corners[m, second]
    d_first = np.linalg.norm(corners - v_first[:, None, :], axis=-1)
    d_second = np.linalg.norm(corners - v_second[:, None, :], axis=-1)
    return (d_second < d_first).astype(np.int8)  # argmin of (d1, d2) stack


def easy_convergence_points(vt_pairs: np.ndarray,
                            point_pairs: np.ndarray,
                            step: float) -> np.ndarray:
    """Pair-convergence test (reference ``get_easy_convergence_points``,
    ``mc_utils.py:8-31``; the ``alternative`` crossing criterion): a corner
    pair crosses the surface when its field vectors oppose (dot ≤ −0.1) AND
    walking each point one voxel step along its vector brings the pair
    closer.

    :param vt_pairs: (M, 28, 2, 3) field vectors at each pair's corners.
    :param point_pairs: (M, 28, 2, 3) corner positions.
    :param step: ``size / N`` voxel step.
    :return: (M, 28) float crossing flags.
    """
    v1, v2 = vt_pairs[:, :, 0], vt_pairs[:, :, 1]
    p1, p2 = point_pairs[:, :, 0], point_pairs[:, :, 1]
    converging = (np.sum(v1 * v2, axis=-1) <= -0.1)

    before = 2.0 * np.linalg.norm(p1 - p2, axis=-1)
    n1 = p1 + v1 * step
    n2 = p2 + v2 * step
    after = np.linalg.norm(n1 - p2, axis=-1) + np.linalg.norm(p1 - n2,
                                                              axis=-1)
    return (converging & (after <= before)).astype(np.float32)


def pair_corner_values(grid: np.ndarray,
                       cells: np.ndarray) -> np.ndarray:
    """grid (N, N, N, C) + cells (M, 3) → (M, 28, 2, C) values at the 28
    corner pairs (reference ``get_grid_comb_div``,
    ``marching_cubes_vt.py:370-419``; zero fill past the top face)."""
    corners = _gather_corners(grid, cells)  # (M, 8, C)
    return np.stack([corners[:, COMB_I], corners[:, COMB_J]], axis=2)


def make_comb_format(choice: np.ndarray, norms: np.ndarray,
                     cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(M, 8) side labels + (N,N,N) norms grid → (M, 28) crossing flags and
    (M, 28, 2) per-pair corner norms (reference ``make_comb_format``)."""
    corner_norms = _gather_corners(norms, cells)  # (M, 8)
    different = (choice[:, COMB_I] != choice[:, COMB_J]).astype(np.float32)
    pair_norms = np.stack([corner_norms[:, COMB_I],
                           corner_norms[:, COMB_J]], axis=-1)
    return different, pair_norms.astype(np.float32)
