"""Classic scalar-field marching cubes (port of
``vf_nerf_tpu/evaluation/mc/classic.py``), on the host in numpy.

The TSDF mesher uses it (the reference took Open3D's extractor,
``methods.py:613-665``). It shares the tables, the native triangle emission
and the dedup with the contrastive variant. Candidate cells are found slab
by slab, the slabs in worker threads (numpy releases the interpreter lock in
its array loops); the cells are gathered in slab order, so the mesh is the
one a serial loop gives, bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, Tuple, TypeVar

import numpy as np

from vf_nerf_torch.evaluation.mc.contrastive import dedup_mesh, emit_triangles
from vf_nerf_torch.evaluation.mc.tables import CORNER_OFFSETS

T = TypeVar("T")


def map_in_threads(fn: Callable[[int], T], items: Sequence[int]) -> List[T]:
    """``[fn(i) for i in items]``, run on a thread per CPU this process may
    use; results in the order of ``items``."""
    workers = min(len(items), len(os.sched_getaffinity(0)))
    if workers <= 1:
        return [fn(i) for i in items]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def marching_cubes(values: np.ndarray,
                   isovalue: float = 0.0,
                   origin: np.ndarray = None,
                   voxel_size: float = 1.0,
                   valid: np.ndarray = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a dense scalar grid.

    :param values: (Nx, Ny, Nz) scalar field.
    :param isovalue: surface level.
    :param origin: world position of voxel (0,0,0); default zeros.
    :param voxel_size: world grid spacing.
    :param valid: optional (Nx, Ny, Nz) bool mask — cells are only meshed
        when all 8 corners are valid (TSDF: observed voxels).
    :return: (vertices (V, 3) world coords, faces (F, 3)).
    """
    nx, ny, nz = values.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Candidate cells slab by slab: the full (cells × 8 corners) stack
    # would take 8× the grid.
    inside_grid = values < isovalue
    planes_per_slab = max(1, (1 << 23) // max(ny * nz, 1))

    def slab(ix0: int):
        ix1 = min(ix0 + planes_per_slab, nx - 1)

        def corner_view(grid, off):
            return grid[ix0 + off[0]:ix1 + off[0],
                        off[1]:off[1] + ny - 1,
                        off[2]:off[2] + nz - 1]

        inside = np.stack([corner_view(inside_grid, off)
                           for off in CORNER_OFFSETS], axis=-1)
        any_cross = inside.any(axis=-1) & (~inside.all(axis=-1))
        if valid is not None:
            corner_ok = np.stack([corner_view(valid, off)
                                  for off in CORNER_OFFSETS], axis=-1)
            any_cross &= corner_ok.all(axis=-1)
        local = np.argwhere(any_cross)
        if len(local) == 0:
            return None
        local[:, 0] += ix0
        corner_vals = np.stack(
            [values[local[:, 0] + off[0], local[:, 1] + off[1],
                    local[:, 2] + off[2]] for off in CORNER_OFFSETS],
            axis=-1)
        return local, corner_vals

    blocks = [b for b in map_in_threads(slab, range(0, nx - 1,
                                                    planes_per_slab))
              if b is not None]
    if not blocks:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cells = np.concatenate([c for c, _ in blocks])
    vert_values = np.concatenate([v for _, v in blocks])

    node = (cells[:, None, :] + CORNER_OFFSETS[None]).astype(np.float64)
    grid_verts = node * voxel_size
    if origin is not None:
        grid_verts = grid_verts + np.asarray(origin, np.float64)

    triangles = emit_triangles(grid_verts, vert_values, isovalue)
    return dedup_mesh(triangles)
