"""VF mesh extraction with the field grid on the device (port of
``vf_nerf_tpu/evaluation/mc/device_pipeline.py``).

``DeviceMeshExtractor`` evaluates a ``(N, 3) → (N, 3)`` field function on
the res³ grid of a cube in chunks of ``chunk`` points; for a model that is
``VectorFieldNerf.get_vector_field``, one fused-MLP launch per chunk on the
card. The grid, its normalization, the Gaussian smoothing, the divergence
mask and the corner classification of the surface cells are tensors on the
extractor's device; only the surface cells' indices and their signed corner
values are read back. Triangle emission and dedup stay on the host
(``contrastive.py``, ``csrc/meshops.cpp``), and ``extract_many`` runs
octant k's host tail in a worker thread while octant k+1's grid is computed.
Given several devices, ``extract_many`` sends the octants round-robin over
them (a worker thread per device, on CUDA its own stream; the field runs on
the device of its points), at most two per device in flight, the oldest
drained first (``vf_nerf_tpu/evaluation/mc/device_pipeline.py:285-343``);
octants are independent cubes, so the meshes are bit-equal to one
device's.

Where the port has to match the JAX package exactly:

- grid points: ``voxel = scale·2·(1/(res−1))`` in float32 (XLA turns the
  division by a constant into a product with its reciprocal), then
  ``idx·voxel − scale`` rounded once (XLA fuses it into a multiply-add),
  then ``+ offset``, with int64 flat indices (res 512 has 134 M points);
  any other rounding feeds the MLP other inputs;
- the divergence sums the 8 corners in the JAX order, each as
  ``d·|d|·FACE_AREA`` with the constant rounded to float32, then
  ÷ ``SHAPE_VOLUME``; a cell whose divergence lies within ~1e-6 of the
  −0.5 threshold may still flip between any two float32 paths;
- the classification's argmaxes (the most-opposed corner pair over 64
  entries, the anchor pair over 28) take the FIRST maximum, as
  ``jnp.argmax`` does: both have exact ties (a constant cell makes every
  entry 0, ``dots`` is symmetric, and a symmetric field ties two pairs),
  and another tie rule swaps the anchors and flips the side assignment; so
  the corner dot products round as XLA's do (``_corner_dots``), or a tie
  that JAX sees breaks on rounding;
- cells are read back in row-major order (``torch.nonzero``, as
  ``np.argwhere``): their order decides the triangles' order before dedup.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vf_nerf_torch.evaluation.mc.contrastive import dedup_mesh, emit_triangles
from vf_nerf_torch.evaluation.mc.field_ops import FACE_AREA, SHAPE_VOLUME
from vf_nerf_torch.evaluation.mc.smoothing import smooth_vf
from vf_nerf_torch.evaluation.mc.tables import (COMB_I, COMB_J,
                                                CORNER_OFFSETS, PAIR_TO_COMB)
from vf_nerf_torch.parallel.mesh import on_stream_of

FieldFn = Callable[[torch.Tensor], torch.Tensor]
Mesh = Tuple[np.ndarray, np.ndarray]

# The JAX package's grid chunk. The fused MLP's output is (chunk, 259)
# float32 (1.1 GB at 1 << 20) of which the grid keeps the first 3 columns;
# the kernel takes an int point count and indexes with size_t, so any chunk
# below 2^31 points is in range.
GRID_CHUNK = 1 << 20
CELL_BUCKET = 1 << 18
# The divergence constants rounded to float32, as JAX's float32 arithmetic
# takes them.
_FACE_AREA = float(np.float32(FACE_AREA))
_SHAPE_VOLUME = float(np.float32(SHAPE_VOLUME))

_EMPTY: Mesh = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))


def grid_points(res: int, scale: float, offset: torch.Tensor,
                flat_idx: torch.Tensor) -> torch.Tensor:
    """Sample positions (n, 3) float32 of int64 flat grid indices (x
    slowest, the reference's order), on ``flat_idx``'s device.

    The arithmetic is what XLA makes of the JAX expression: the division
    by the constant ``res − 1`` becomes a product with its float32
    reciprocal, and ``idx·voxel − scale`` one fused multiply-add, rounded
    once to float32 (the product of an index below 2^24 and a float32
    voxel, and its difference with the float32 scale, are exact in
    float64, so one rounding of the float64 result is the fused one).
    Then ``+ offset`` in float32."""
    scale_t = torch.tensor(scale, dtype=torch.float32, device=flat_idx.device)
    voxel = scale_t * 2.0 * float(np.float32(1.0) / np.float32(res - 1))
    x = torch.div(flat_idx, res * res, rounding_mode="floor") % res
    y = torch.div(flat_idx, res, rounding_mode="floor") % res
    z = flat_idx % res
    idx = torch.stack([x, y, z], dim=-1).to(torch.float64)
    pts = (idx * voxel.double() - scale_t.double()).to(torch.float32)
    return pts + offset


def build_raw_field_grid(vf_apply: FieldFn, res: int, scale: float,
                         offset: torch.Tensor, chunk: int = GRID_CHUNK
                         ) -> torch.Tensor:
    """The raw field over the res³ grid → (res, res, res, 3) on
    ``offset``'s device, ``vf_apply`` called once per ``chunk`` points."""
    n = res ** 3
    grid = torch.empty((n, 3), dtype=torch.float32, device=offset.device)
    for start in range(0, n, chunk):
        idx = torch.arange(start, min(start + chunk, n), dtype=torch.int64,
                           device=offset.device)
        grid[start:start + len(idx)] = vf_apply(
            grid_points(res, scale, offset, idx))
    return grid.reshape(res, res, res, 3)


def normalize_grid(grid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unit field, norms); ``vector_norm`` rounds as ``jnp.linalg.norm``
    does on the CPU, where a plain sum of squares does not."""
    norms = torch.linalg.vector_norm(grid, dim=-1)
    vt = grid / torch.clamp(norms[..., None], min=1e-12)
    return vt, norms


def surface_mask(vt: torch.Tensor, threshold: float = -0.5) -> torch.Tensor:
    """Divergence surface-cell mask (res³ bool; cells at
    ``[:-1, :-1, :-1]``), ``field_ops.extract_divergence``'s math in
    float32 on ``vt``'s device."""
    n = vt.shape[0]
    div = torch.zeros((n - 1,) * 3, dtype=torch.float32, device=vt.device)
    for idx in range(8):
        off = ((idx // 4) % 2, (idx // 2) % 2, idx % 2)
        direction = np.array([2.0 * o - 1.0 for o in off], np.float32)
        direction /= np.linalg.norm(direction)
        corner = vt[off[0]:off[0] + n - 1,
                    off[1]:off[1] + n - 1,
                    off[2]:off[2] + n - 1]
        d = corner @ torch.from_numpy(direction).to(vt.device)
        div = div + d * torch.abs(d) * _FACE_AREA
    div = div / _SHAPE_VOLUME
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=vt.device)
    mask[:-1, :-1, :-1] = div <= threshold
    return mask


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s tie rule),
    stated here rather than left to a backend's reduction order."""
    size = x.shape[dim]
    top = x.amax(dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = size
    index = torch.arange(size, device=x.device).reshape(shape)
    return torch.where(x == top, index, size).amin(dim)


def _corner_dots(corners: torch.Tensor) -> torch.Tensor:
    """(M, 8, 3) → (M, 8, 8) dot products, rounded as XLA's CPU dot rounds
    them: ``fma(a2, b2, fma(a1, b1, a0·b0))`` in float32. Each fused step is
    taken in float64, where the product of two float32 values is exact, and
    rounded once to float32 (bar a double rounding in ~2^-29 of the steps).
    (a, b) and (b, a) round alike, so the symmetric ties stay exact, and the
    card computes what the CPU does."""
    a = corners[:, :, None, :].double()
    b = corners[:, None, :, :].double()
    acc = (a[..., 0] * b[..., 0]).float()
    for c in (1, 2):
        acc = (a[..., c] * b[..., c] + acc.double()).float()
    return acc


class _Tables:
    """The classification's index tables on one device."""

    def __init__(self, device: torch.device) -> None:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)
        self.corners = t(CORNER_OFFSETS)
        self.comb_i = t(COMB_I)
        self.comb_j = t(COMB_J)
        self.pair_to_comb = t(PAIR_TO_COMB)


def cell_signed_values(vt: torch.Tensor, norms: torch.Tensor,
                       cells: torch.Tensor, tables: _Tables = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unify_direction → make_comb_format → combs_to_vert_values for the
    (M, 3) int64 surface cells, on ``vt``'s device.

    The cells come from ``surface_mask``, whose cells lie at indices up to
    res − 2, so every corner is inside the grid: the JAX version's zero
    padding past the top face is never read and is not built.

    :return: (signed corner values (M, 8), any-crossing flags (M,)).
    """
    tb = tables if tables is not None else _Tables(vt.device)
    n = vt.shape[0]
    idx = cells[:, None, :] + tb.corners[None]               # (M, 8, 3)
    flat = (idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]
    corners = vt.reshape(-1, 3)[flat]                        # (M, 8, 3)
    corner_norms = norms.reshape(-1)[flat]                   # (M, 8)

    dots = _corner_dots(corners)
    extreme = first_argmax((1.0 - dots).reshape(-1, 64), dim=-1)
    first = torch.div(extreme, 8, rounding_mode="floor")
    second = extreme % 8
    m = torch.arange(cells.shape[0], device=vt.device)
    v_first = corners[m, first]
    v_second = corners[m, second]
    d_first = torch.linalg.vector_norm(corners - v_first[:, None], dim=-1)
    d_second = torch.linalg.vector_norm(corners - v_second[:, None], dim=-1)
    choice = d_second < d_first                              # (M, 8)

    comb_values = (choice[:, tb.comb_i] != choice[:, tb.comb_j]).to(
        torch.float32)                                       # (M, 28)
    has_crossing = comb_values.amax(dim=1) > 0.5

    anchor = first_argmax(comb_values, dim=1)
    a0 = tb.comb_i[anchor]
    a1 = tb.comb_j[anchor]
    verts = torch.arange(8, device=vt.device)
    c0 = comb_values[m[:, None], tb.pair_to_comb[verts[None, :], a0[:, None]]]
    c1 = comb_values[m[:, None], tb.pair_to_comb[verts[None, :], a1[:, None]]]
    side1 = c0 > c1
    side1[m, a0] = False
    side1[m, a1] = True

    signed = torch.where(side1, 1.0, -1.0) * corner_norms
    signed = torch.where(has_crossing[:, None], signed, 0.0)
    return signed, has_crossing


class DeviceMeshExtractor:
    """Contrastive MC of one field over cubes of ``resolution``³ samples,
    its device stages on ``device``.

    ``smooth_before`` smooths the raw grid with k=3 / σ=1 before the
    divergence mask; with either flag, the grid (already smoothed when
    ``smooth_before``) is then smoothed with k=9 / σ=2 before the
    classification, as the JAX extractor does."""

    def __init__(self, vf_apply: FieldFn, resolution: int, device=None,
                 chunk: int = GRID_CHUNK, cell_bucket: int = CELL_BUCKET,
                 smooth_before: bool = False,
                 smooth_after: bool = False) -> None:
        self.vf_apply = vf_apply
        self.resolution = resolution
        self.device = torch.device("cuda" if device is None else device)
        self.chunk = chunk
        self.cell_bucket = cell_bucket
        self.smooth_before = smooth_before
        self.smooth_after = smooth_after
        self._tables = {self.device: _Tables(self.device)}

    def field_grids(self, scale: float, offset: np.ndarray, device=None):
        """(vt, norms, mask) of one cube on ``device`` (default: the
        extractor's): the unit field and norms that the classification
        reads, and the divergence mask."""
        offset_t = torch.as_tensor(np.asarray(offset, np.float32),
                                   device=device or self.device)
        grid = build_raw_field_grid(self.vf_apply, self.resolution, scale,
                                    offset_t, self.chunk)
        if self.smooth_before:
            grid = smooth_vf(grid, k=3, sigma=1.0)
        vt, norms = normalize_grid(grid)
        mask = surface_mask(vt)
        if self.smooth_before or self.smooth_after:
            del vt, norms
            vt, norms = normalize_grid(smooth_vf(grid, k=9, sigma=2.0))
        return vt, norms, mask

    def device_stages(self, scale: float, offset: np.ndarray, device=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Field grid → mask → corner classification for one cube on
        ``device`` (default: the extractor's); the grids are freed on
        return.

        :return: (crossing cells (M, 3) int32, signed corner values (M, 8)
            float32), on the host.
        """
        device = torch.device(device) if device is not None else self.device
        if device not in self._tables:
            self._tables[device] = _Tables(device)
        with torch.no_grad():
            vt, norms, mask = self.field_grids(scale, offset, device)
            cells = torch.nonzero(mask)
            del mask
            signed, crossing = [], []
            for start in range(0, len(cells), self.cell_bucket):
                s, c = cell_signed_values(
                    vt, norms, cells[start:start + self.cell_bucket],
                    self._tables[device])
                signed.append(s)
                crossing.append(c)
            del vt, norms
            if not signed:
                return np.zeros((0, 3), np.int32), np.zeros((0, 8),
                                                            np.float32)
            crossing = torch.cat(crossing)
            return (cells[crossing].to(torch.int32).cpu().numpy(),
                    torch.cat(signed)[crossing].cpu().numpy())

    def host_tail(self, cells: np.ndarray, signed: np.ndarray,
                  scale: float, offset: np.ndarray, world_coords: bool
                  ) -> Mesh:
        """Triangle emission + dedup (``csrc/meshops.cpp``) and the world
        transform."""
        if len(cells) == 0:
            return _EMPTY
        node = (cells[:, None, :] + CORNER_OFFSETS[None]).astype(np.float64)
        grid_verts = node / self.resolution * 2.0 - 1.0
        triangles = emit_triangles(grid_verts, signed.astype(np.float64))
        verts, faces = dedup_mesh(triangles)
        if world_coords and len(verts):
            verts = verts * scale + np.asarray(offset, np.float32)
        return verts, faces

    def _extract_spread(self, octants, centroid, world_coords,
                        devices: List[torch.device]) -> List[Mesh]:
        """Octant k's device stages on ``devices[k % D]`` in that device
        slot's worker thread; at most ``2 D`` octants staged, the oldest
        drained first into the host tail."""
        for d in devices:
            if d not in self._tables:
                self._tables[d] = _Tables(d)
        homes = {d: torch.cuda.current_stream(d) if d.type == "cuda"
                 else None for d in devices}

        def stages(scale, offset, device):
            return on_stream_of(device, homes[device],
                                lambda: self.device_stages(scale, offset,
                                                           device))

        slots = [ThreadPoolExecutor(max_workers=1) for _ in devices]
        staged: deque = deque()
        results = []
        try:
            with ThreadPoolExecutor(max_workers=1) as host:
                def drain():
                    future, scale, offset = staged.popleft()
                    cells, signed = future.result()
                    results.append(host.submit(self.host_tail, cells,
                                               signed, scale, offset,
                                               world_coords))

                for k, (translation, sub_scale) in enumerate(octants):
                    if len(staged) >= 2 * len(devices):
                        drain()
                    slot = k % len(devices)
                    offset = np.asarray(translation) + np.asarray(centroid)
                    staged.append((slots[slot].submit(
                        stages, sub_scale, offset, devices[slot]),
                        sub_scale, offset))
                while staged:
                    drain()
                return [f.result() for f in results]
        finally:
            for pool in slots:
                pool.shutdown(wait=True)

    def extract(self, scale: float, centroid: np.ndarray,
                translation: np.ndarray, world_coords: bool = True) -> Mesh:
        offset = np.asarray(translation) + np.asarray(centroid)
        cells, signed = self.device_stages(scale, offset)
        return self.host_tail(cells, signed, scale, offset, world_coords)

    def extract_many(self, octants: Iterable[Tuple[np.ndarray, float]],
                     centroid: np.ndarray, world_coords: bool = True,
                     devices: Optional[Sequence] = None) -> List[Mesh]:
        """Every (translation, sub-scale) cube in turn, octant k's host
        tail in one worker thread while octant k+1's device stages run;
        with more than one of ``devices``, the octants round-robin over
        them (module docstring). Returns the meshes in octant order, equal
        to ``extract`` of each."""
        if devices is not None and len(devices) > 1:
            return self._extract_spread(list(octants), centroid,
                                        world_coords,
                                        [torch.device(d) for d in devices])
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = []
            for translation, sub_scale in octants:
                offset = np.asarray(translation) + np.asarray(centroid)
                cells, signed = self.device_stages(sub_scale, offset)
                futures.append(pool.submit(self.host_tail, cells, signed,
                                           sub_scale, offset, world_coords))
            return [f.result() for f in futures]

