"""Vectorized contrastive marching cubes (port of
``vf_nerf_tpu/evaluation/mc/contrastive.py``; reference
``evaluation/utils/marching_cubes_vt.py:62-315``).

Each surface cell's 8 corners are classified from its 28 pair-crossing
flags, a signed pseudo-SDF (±field norm) is formed, and classic table-based
marching cubes emits the triangles:

- anchor pair = the first argmax of the crossing flags; every other corner
  joins the anchor whose crossing value against it is smaller,
- signed values = side · corner norm; config id = bitmask(signed < iso),
- edge interpolation keeps ``vertex_interpolate``'s endpoint-swap rule (a
  static property of each edge on a monotonic grid) and its
  ``|v1 − v2| ≤ 1e-5`` degenerate-edge guard,
- vertices are deduplicated on their exact bits, in first-occurrence order.

Triangle emission and dedup run in the host library ``csrc/meshops.cpp``
(``kernels/host.py``); a failed build raises. ``emit_triangles_numpy`` is the
plain numpy emission, kept as the tests' oracle for the native loop.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from vf_nerf_torch.evaluation.mc.classic_tables import (
    CLASSIC_TRI_TABLE, use_classic_tri_table)
from vf_nerf_torch.evaluation.mc.tables import (COMB_I, COMB_J, CORNER_COMB,
                                                CORNER_LANE, CORNER_OFFSETS,
                                                EDGE_TABLE, EDGE_VERTEX,
                                                PAIR_TO_COMB, TRI_TABLE)
from vf_nerf_torch.kernels.host import meshops

# vertex_interpolate (marching_cubes_vt.py:9-15) swaps endpoints when
# any(p1 > p2); on a monotonic grid this is a static per-edge property.
_EDGE_SWAP = np.array([np.any(CORNER_OFFSETS[a] > CORNER_OFFSETS[b])
                       for a, b in EDGE_VERTEX])

_DEGENERATE_EPS = 1e-5

# int32 copies of the tables for the native emission.
_EDGE_TABLE_I32 = np.ascontiguousarray(EDGE_TABLE, np.int32)
_EDGE_VERTEX_I32 = np.ascontiguousarray(EDGE_VERTEX, np.int32)
_EDGE_SWAP_I32 = np.ascontiguousarray(_EDGE_SWAP, np.int32)


def combs_to_vert_values(comb_values: np.ndarray,
                         pair_norms: np.ndarray) -> np.ndarray:
    """(M, 28) crossing flags + (M, 28, 2) pair norms → (M, 8) signed values.

    Corners on the second anchor's side get +norm, the rest −norm; cells
    whose max crossing flag is ≤ 0.5 get all-zero values (no surface).
    """
    m = comb_values.shape[0]
    rows = np.arange(m)
    has_surface = comb_values.max(axis=1) > 0.5

    anchor_comb = np.argmax(comb_values, axis=1)
    a0 = COMB_I[anchor_comb]
    a1 = COMB_J[anchor_comb]

    verts = np.arange(8)
    # crossing value of each corner against each anchor
    c0 = comb_values[rows[:, None], PAIR_TO_COMB[verts[None, :], a0[:, None]]]
    c1 = comb_values[rows[:, None], PAIR_TO_COMB[verts[None, :], a1[:, None]]]
    side1 = c0 > c1                      # closer (less crossed) to anchor 1
    side1[rows, a0] = False
    side1[rows, a1] = True

    corner_norms = pair_norms[:, CORNER_COMB, CORNER_LANE]  # (M, 8)
    signed = np.where(side1, 1.0, -1.0) * corner_norms
    signed[~has_surface] = 0.0
    return signed


def active_tri_table() -> np.ndarray:
    """The generated triangle table, or the classic constant when
    ``VFNERF_CLASSIC_MC_TABLE`` is set (read at each call). Both share the
    edge table; only the fan orders differ."""
    return CLASSIC_TRI_TABLE if use_classic_tri_table() else TRI_TABLE


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data_as(ctypes.c_void_p)


def emit_triangles(grid_verts: np.ndarray,
                   vert_values: np.ndarray,
                   isovalue: float = 0.0) -> np.ndarray:
    """Classic table-based triangle emission in ``csrc/meshops.cpp``.

    :param grid_verts: (M, 8, 3) corner positions (reference corner order).
    :param vert_values: (M, 8) signed field values.
    :return: (T, 3, 3) float64 triangle vertex positions.
    """
    m = grid_verts.shape[0]
    if m == 0:
        return np.zeros((0, 3, 3), np.float64)
    lib = meshops()
    gv = np.ascontiguousarray(grid_verts, np.float64)
    vv = np.ascontiguousarray(vert_values, np.float64)
    tri_i32 = np.ascontiguousarray(active_tri_table(), np.int32)
    out = np.empty((5 * m, 3, 3), np.float64)
    n = lib.emit_mc_triangles(_ptr(gv), _ptr(vv), m, float(isovalue),
                              _ptr(_EDGE_TABLE_I32), _ptr(_EDGE_VERTEX_I32),
                              _ptr(_EDGE_SWAP_I32), _ptr(tri_i32), _ptr(out))
    return out[:n]


def emit_triangles_numpy(grid_verts: np.ndarray,
                         vert_values: np.ndarray,
                         isovalue: float = 0.0) -> np.ndarray:
    """The plain numpy emission (the oracle of ``emit_triangles``; no path
    of the port calls it)."""
    m = grid_verts.shape[0]
    if m == 0:
        return np.zeros((0, 3, 3), np.float64)
    inside = (vert_values < isovalue).astype(np.int64)
    config = (inside * (1 << np.arange(8))[None, :]).sum(axis=1)

    active = EDGE_TABLE[config] != 0
    if not np.any(active):
        return np.zeros((0, 3, 3), np.float64)
    grid_verts = grid_verts[active].astype(np.float64)
    vert_values = vert_values[active].astype(np.float64)
    config = config[active]

    # Interpolate all 12 edges per cell (unused ones are masked later).
    ev0, ev1 = EDGE_VERTEX[:, 0], EDGE_VERTEX[:, 1]
    p1 = grid_verts[:, ev0]            # (M', 12, 3)
    p2 = grid_verts[:, ev1]
    v1 = vert_values[:, ev0]           # (M', 12)
    v2 = vert_values[:, ev1]
    swap = _EDGE_SWAP[None, :]
    pa = np.where(swap[..., None], p2, p1)
    pb = np.where(swap[..., None], p1, p2)
    va = np.where(swap, v2, v1)
    vb = np.where(swap, v1, v2)
    denom = vb - va
    degenerate = np.abs(denom) <= _DEGENERATE_EPS
    t = np.where(degenerate, 0.0,
                 (isovalue - va) / np.where(degenerate, 1.0, denom))
    edge_cut = pa + t[..., None] * (pb - pa)   # (M', 12, 3)

    tri_edges = active_tri_table()[config][:, :15].reshape(-1, 5, 3)
    valid = tri_edges[:, :, 0] >= 0                          # (M', 5)
    safe = np.maximum(tri_edges, 0)
    rows = np.arange(edge_cut.shape[0])[:, None, None]
    tri_pts = edge_cut[rows, safe]                           # (M', 5, 3, 3)
    return tri_pts[valid]                                    # (T, 3, 3)


def dedup_mesh(triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 3, 3) triangle soup → (vertices (V, 3) float32, faces (T, 3)
    int32), deduplicated on the exact bits of each float64 corner in
    ``csrc/meshops.cpp`` (first-occurrence order)."""
    if len(triangles) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = np.ascontiguousarray(triangles.reshape(-1, 3), np.float64)
    n = len(flat)
    out_verts = np.empty((n, 3), np.float64)
    inverse = np.empty(n, np.int32)
    count = meshops().dedup_vertices(_ptr(flat), n, _ptr(out_verts),
                                     _ptr(inverse))
    faces = inverse.reshape(-1, 3)
    return out_verts[:count].astype(np.float32), faces


def contrastive_marching_cubes(comb_values: np.ndarray,
                               pair_norms: np.ndarray,
                               cells: np.ndarray,
                               resolution: int,
                               size: float = 2.0,
                               isovalue: float = 0.0
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Surface cells → deduplicated mesh in the canonical cube.

    Node positions follow the reference's canonical grid: ``res+1`` nodes
    spanning ``[-size/2, size/2]`` (``marching_cubes_vt.py:191-193``), which
    differs from the sampling grid's ``res`` nodes by a factor
    ``(res−1)/res``; callers reproduce the reference's scale and translate
    on top.
    """
    signed = combs_to_vert_values(comb_values, pair_norms)
    node = (cells[:, None, :] + CORNER_OFFSETS[None]).astype(np.float64)
    grid_verts = node / resolution * size - size / 2.0
    triangles = emit_triangles(grid_verts, signed, isovalue)
    return dedup_mesh(triangles)
