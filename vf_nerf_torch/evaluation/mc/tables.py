"""Marching-cubes lookup tables, generated from first principles (port of
``vf_nerf_tpu/evaluation/mc/tables.py``; the same tables, bit for bit).

The reference embeds the classic 256-case edge/triangle tables
(``evaluation/utils/marching_cubes_lookup.py``). Here both tables are
*derived* at import time:

- ``EDGE_TABLE[config]``: bit e set iff edge e joins corners with different
  inside/outside state — a pure function of the configuration.
- ``TRI_TABLE[config]``: triangulation built by tracing the isosurface
  polygon loops on the cube surface: on each cube face, cut edges are joined
  by segments separating inside from outside corners (the ambiguous
  two-diagonal face case is resolved by always keeping *inside* corners
  separated, applied uniformly so neighbouring cells agree and the surface is
  watertight); the segments form closed loops which are fan-triangulated.

Corner and edge conventions match the reference/classic layout so generated
meshes are directly comparable:

corners (reference ``marching_cubes_vt.py:25-36``, the cell-corner order used
by the whole VF-MC pipeline)::

    0:(0,0,0) 1:(0,1,0) 2:(1,1,0) 3:(1,0,0)
    4:(0,0,1) 5:(0,1,1) 6:(1,1,1) 7:(1,0,1)

edges (``EDGE_VERTEX``): 0-3 bottom ring (z=0), 4-7 top ring (z=1),
8-11 verticals.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# Corner offsets in (x, y, z) — reference ordering.
CORNER_OFFSETS = np.array([
    [0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0],
    [0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1],
], dtype=np.int64)

# Edge e joins corners EDGE_VERTEX[e] — classic layout.
EDGE_VERTEX = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],      # bottom ring
    [4, 5], [5, 6], [6, 7], [7, 4],      # top ring
    [0, 4], [1, 5], [2, 6], [3, 7],      # verticals
], dtype=np.int64)

# The 6 cube faces as corner quads in cyclic order.
_FACES = [
    (0, 1, 2, 3),   # z = 0
    (4, 5, 6, 7),   # z = 1
    (0, 1, 5, 4),   # x = 0
    (3, 2, 6, 7),   # x = 1
    (0, 3, 7, 4),   # y = 0
    (1, 2, 6, 5),   # y = 1
]

_EDGE_OF_PAIR: Dict[Tuple[int, int], int] = {}
for _e, (_a, _b) in enumerate(EDGE_VERTEX):
    _EDGE_OF_PAIR[(int(_a), int(_b))] = _e
    _EDGE_OF_PAIR[(int(_b), int(_a))] = _e


def _face_segments(config: int, face: Tuple[int, int, int, int]
                   ) -> List[Tuple[int, int]]:
    """Segments joining cut edges on one face, separating inside corners.

    ``config`` bit c set = corner c inside. Cyclic face corners c0..c3 give
    face edges (c0c1, c1c2, c2c3, c3c0). 0, 2 or 4 of them are cut. With 2
    cut edges the segment is unique. With 4 (the ambiguous case: two opposite
    corners inside), connect each inside corner's two adjacent cut edges —
    this keeps the two inside corners separated, uniformly for all faces.
    """
    inside = [(config >> c) & 1 for c in face]
    cut = [i for i in range(4) if inside[i] != inside[(i + 1) % 4]]
    edges = [_EDGE_OF_PAIR[(face[i], face[(i + 1) % 4])] for i in range(4)]
    if len(cut) == 0:
        return []
    if len(cut) == 2:
        return [(edges[cut[0]], edges[cut[1]])]
    # 4 cut edges: two inside corners diagonal. Pair around each inside
    # corner: corner i's adjacent face-edges are (i-1, i).
    segments = []
    for i in range(4):
        if inside[i]:
            segments.append((edges[(i - 1) % 4], edges[i]))
    return segments


def _loops_for_config(config: int) -> List[List[int]]:
    """Closed cut-edge loops of the isosurface for one configuration."""
    adjacency: Dict[int, List[int]] = {}
    for face in _FACES:
        for a, b in _face_segments(config, face):
            adjacency.setdefault(a, []).append(b)
            adjacency.setdefault(b, []).append(a)
    # Every cut edge lies on exactly 2 faces → exactly 2 neighbors.
    loops: List[List[int]] = []
    visited = set()
    for start in sorted(adjacency):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [n for n in adjacency[cur] if n != prev]
            # In rare symmetric cases both neighbors equal prev; guard:
            nxt_edge = nxt[0] if nxt else adjacency[cur][0]
            if nxt_edge == start:
                break
            loop.append(nxt_edge)
            visited.add(nxt_edge)
            prev, cur = cur, nxt_edge
        loops.append(loop)
    return loops


def _edge_midpoint(e: int) -> np.ndarray:
    a, b = EDGE_VERTEX[e]
    return (CORNER_OFFSETS[a] + CORNER_OFFSETS[b]) / 2.0


def _oriented(loop: List[int], config: int) -> List[int]:
    """Orient the loop so triangle normals point away from the inside
    region (the classic convention: normals toward lower field values when
    inside = value < iso)."""
    pts = np.array([_edge_midpoint(e) for e in loop])
    center = pts.mean(axis=0)
    if len(pts) < 3:
        return loop
    normal = np.zeros(3)
    for i in range(len(pts)):
        a = pts[i] - center
        b = pts[(i + 1) % len(pts)] - center
        normal += np.cross(a, b)
    # Mean inside-corner position vs mean outside-corner position.
    ins = [c for c in range(8) if (config >> c) & 1]
    outs = [c for c in range(8) if not (config >> c) & 1]
    if not ins or not outs:
        return loop
    direction = (CORNER_OFFSETS[outs].mean(axis=0) -
                 CORNER_OFFSETS[ins].mean(axis=0))
    if np.dot(normal, direction) < 0:
        return loop[::-1]
    return loop


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    edge_table = np.zeros(256, dtype=np.int64)
    max_tris = 5
    tri_table = -np.ones((256, 3 * max_tris + 1), dtype=np.int64)
    for config in range(256):
        inside = [(config >> c) & 1 for c in range(8)]
        mask = 0
        for e, (a, b) in enumerate(EDGE_VERTEX):
            if inside[a] != inside[b]:
                mask |= 1 << e
        edge_table[config] = mask
        tris: List[int] = []
        for loop in _loops_for_config(config):
            loop = _oriented(loop, config)
            for k in range(1, len(loop) - 1):
                tris.extend([loop[0], loop[k], loop[k + 1]])
        tri_table[config, :len(tris)] = tris
    return edge_table, tri_table


EDGE_TABLE, TRI_TABLE = _build_tables()

# Pair index helpers for the 28-comb format
# (reference marching_cubes_vt.py:38-45).
N_COMBS = 28
COMB_I = np.array([i for i in range(7) for _ in range(i + 1, 8)],
                  dtype=np.int64)
COMB_J = np.array([j for i in range(7) for j in range(i + 1, 8)],
                  dtype=np.int64)
PAIR_TO_COMB = np.zeros((8, 8), dtype=np.int64)
for _c, (_i, _j) in enumerate(zip(COMB_I, COMB_J)):
    PAIR_TO_COMB[_i, _j] = _c
    PAIR_TO_COMB[_j, _i] = _c

# Corner c's unsigned norm lives in comb slot CORNER_COMB[c] at lane
# CORNER_LANE[c] (reference ``idx_in_combs``, marching_cubes_vt.py:59).
CORNER_COMB = np.array([0, 0, 1, 2, 3, 4, 5, 6], dtype=np.int64)
CORNER_LANE = np.array([0, 1, 1, 1, 1, 1, 1, 1], dtype=np.int64)
