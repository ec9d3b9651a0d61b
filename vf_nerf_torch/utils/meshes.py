"""Mesh utilities (port of ``vf_nerf_tpu/utils/meshes.py``; the reference
used trimesh).

- area-weighted centroid and bounds (trimesh semantics; the reference reads
  ``mesh.centroid`` / ``mesh.bounds`` of the GT scene mesh),
- mesh concatenation (the quadrant MC merge),
- uniform Laplacian smoothing (the reference's ``filter_laplacian``),
- surface point sampling (``np.random.RandomState(seed)``, so the samples
  equal the JAX package's bit for bit) and Chamfer distance by scipy
  ``cKDTree``,
- precision / recall / F-score at a distance threshold and a rigid ICP,
  in place of the external ``evaluate_3d_reconstruction`` package.

All of it is host numpy and scipy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def face_areas_and_centroids(vertices: np.ndarray, faces: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    tri = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(cross, axis=1)
    centroids = tri.mean(axis=1)
    return areas, centroids


def mesh_centroid(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted triangle-centroid mean (trimesh ``centroid`` semantics);
    falls back to the vertex mean for point clouds."""
    if len(faces) == 0:
        return vertices.mean(axis=0)
    areas, centroids = face_areas_and_centroids(vertices, faces)
    total = areas.sum()
    if total <= 0:
        return vertices.mean(axis=0)
    return (centroids * areas[:, None]).sum(axis=0) / total


def mesh_bounds(vertices: np.ndarray) -> np.ndarray:
    """(2, 3) [min; max] corner bounds (trimesh ``bounds``)."""
    return np.stack([vertices.min(axis=0), vertices.max(axis=0)])


def concatenate_meshes(meshes) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (vertices, faces) pairs with index offsetting."""
    all_v, all_f = [], []
    offset = 0
    for v, f in meshes:
        all_v.append(v)
        if len(f):
            all_f.append(f + offset)
        offset += len(v)
    v = np.concatenate(all_v) if all_v else np.zeros((0, 3), np.float32)
    f = np.concatenate(all_f) if all_f else np.zeros((0, 3), np.int32)
    return v, f


def vertex_adjacency(n_vertices: int, faces: np.ndarray):
    """CSR-style neighbor lists for Laplacian smoothing."""
    import scipy.sparse as sp
    if len(faces) == 0:
        return sp.csr_matrix((n_vertices, n_vertices))
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    data = np.ones(len(rows), np.float32)
    adj = sp.csr_matrix((data, (rows, cols)),
                        shape=(n_vertices, n_vertices))
    adj.data[:] = 1.0  # dedupe multi-edges
    return adj


def laplacian_smooth(vertices: np.ndarray, faces: np.ndarray,
                     iterations: int = 10, lamb: float = 0.5) -> np.ndarray:
    """Uniform-weight Laplacian smoothing (reference uses trimesh
    ``filter_laplacian`` with 10 iterations, ``methods.py:686-691``)."""
    adj = vertex_adjacency(len(vertices), faces)
    degree = np.asarray(adj.sum(axis=1)).reshape(-1)
    degree = np.maximum(degree, 1.0)
    v = vertices.astype(np.float64).copy()
    for _ in range(iterations):
        mean_neighbor = adj @ v / degree[:, None]
        v = v + lamb * (mean_neighbor - v)
    return v.astype(np.float32)


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface samples (for Chamfer / P-R-F)."""
    if len(faces) == 0:
        idx = np.random.RandomState(seed).randint(0, len(vertices), n)
        return vertices[idx]
    areas, _ = face_areas_and_centroids(vertices, faces)
    probs = areas / max(areas.sum(), 1e-12)
    rng = np.random.RandomState(seed)
    face_idx = rng.choice(len(faces), size=n, p=probs)
    tri = vertices[faces[face_idx]]
    u, v = rng.rand(n, 1), rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return (tri[:, 0] + u * (tri[:, 1] - tri[:, 0])
            + v * (tri[:, 2] - tri[:, 0])).astype(np.float32)


# KD queries split over the CPUs this process may use; each point's
# nearest neighbour is the same as in one thread.
_WORKERS = len(os.sched_getaffinity(0))


def _tree(points: np.ndarray) -> cKDTree:
    """cKDTree tuned for surface-sampled point sets: with the default
    ``compact_nodes=True``, queries against near-planar millions-of-points
    sets degrade pathologically (measured 197 s for 500k queries on a
    TSDF-surface tree; 3 s with these flags — identical exact results)."""
    return cKDTree(points, compact_nodes=False, balanced_tree=False)


def nn_distances(points_a: np.ndarray, points_b: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(a→b, b→a) nearest-neighbor distances — computed ONCE and shared by
    :func:`chamfer_distance` and :func:`precision_recall_fscore` (at the
    reference's 2.5M sample count the KD queries dominate 3d-metrics
    wall-clock; both metrics consume the same distances)."""
    return (_tree(points_b).query(points_a, k=1, workers=_WORKERS)[0],
            _tree(points_a).query(points_b, k=1, workers=_WORKERS)[0])


def chamfer_distance(pred_points: np.ndarray, gt_points: np.ndarray,
                     distances: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> dict:
    """Reference-definition Chamfer statistics (``utils/utils.py:345-367``):
    statistics of **squared** nearest-neighbor distances, with mean and
    median as the **sum** of the two directional statistics, and min/max
    taken over both directions. Returns the exact subdict the reference
    writes under ``"chamfer distance"`` in ``3d-metrics.json``
    (``evaluation/methods.py:732-736``): ``{mean, median, min, max}``."""
    d_pred_to_gt, d_gt_to_pred = distances if distances is not None else \
        nn_distances(pred_points, gt_points)
    sq_pg = np.square(d_pred_to_gt)   # "gen_to_gt" in the reference
    sq_gp = np.square(d_gt_to_pred)   # "gt_to_gen"
    return {"mean": float(sq_gp.mean() + sq_pg.mean()),
            "median": float(np.median(sq_gp) + np.median(sq_pg)),
            "min": float(min(sq_gp.min(), sq_pg.min())),
            "max": float(max(sq_gp.max(), sq_pg.max()))}


def icp_align(source_points: np.ndarray, target_points: np.ndarray,
              max_iterations: int = 50, tolerance: float = 1e-8,
              sample: int = 30000, seed: int = 0) -> np.ndarray:
    """Rigid point-to-point ICP: returns the 4×4 transform aligning
    ``source_points`` onto ``target_points``.

    In-repo replacement for the external ``evaluate_3d_reconstruction``
    evaluator's ``icp_align=True`` preprocessing (reference
    ``evaluation/methods.py:747-801`` scores external baseline meshes only
    after ICP-aligning the prediction to GT). Correspondences are
    nearest-neighbor on a subsample (KD queries dominate at metric-scale
    point counts); the update is the Kabsch/SVD rigid solve; iteration stops
    when the mean correspondence distance improves by < ``tolerance``."""
    rng = np.random.RandomState(seed)
    src = source_points[rng.choice(len(source_points),
                                   min(sample, len(source_points)),
                                   replace=False)].astype(np.float64)
    tgt = target_points[rng.choice(len(target_points),
                                   min(sample, len(target_points)),
                                   replace=False)].astype(np.float64)
    tgt_tree = _tree(tgt)
    transform = np.eye(4)
    prev_err = np.inf
    for _ in range(max_iterations):
        dist, idx = tgt_tree.query(src, k=1, workers=_WORKERS)
        err = float(dist.mean())
        if prev_err - err < tolerance:
            break
        prev_err = err
        matched = tgt[idx]
        mu_s, mu_t = src.mean(axis=0), matched.mean(axis=0)
        h = (src - mu_s).T @ (matched - mu_t)
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        trans = mu_t - rot @ mu_s
        src = src @ rot.T + trans
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = rot, trans
        transform = step @ transform
    return transform


def apply_transform(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a 4×4 rigid transform to an (N, 3) point set."""
    return (points.astype(np.float64) @ transform[:3, :3].T
            + transform[:3, 3]).astype(np.float32)


def precision_recall_fscore(pred_points: np.ndarray,
                            gt_points: np.ndarray,
                            threshold: float = 0.05,
                            distances: Optional[Tuple[np.ndarray,
                                                      np.ndarray]] = None
                            ) -> dict:
    """P/R/F-score at a distance threshold (in-repo replacement for the
    external ``evaluate_3d_reconstruction`` library,
    reference ``methods.py:722-730``)."""
    d_pred_to_gt, d_gt_to_pred = distances if distances is not None else \
        nn_distances(pred_points, gt_points)
    precision = float((d_pred_to_gt < threshold).mean())
    recall = float((d_gt_to_pred < threshold).mean())
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": fscore,
            "accuracy": float(d_pred_to_gt.mean()),
            "completeness": float(d_gt_to_pred.mean())}
