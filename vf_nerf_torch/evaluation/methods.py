"""Evaluation methods: image rendering, 2D metrics, marching-cubes meshes,
TSDF fusion and 3D metrics (port of ``vf_nerf_tpu/evaluation/methods.py``;
reference ``evaluation/methods.py``). The artifact layout and JSON keys are
the JAX package's:

- ``<eval>/rendered_images/image-{i}.png``, ``depth-{i}.npy`` and
  ``depth-{i}.png`` (an 8-bit grey map, ``utils/io.py``);
- ``<eval>/metrics.json``: per-image PSNR and ``mean_psnr``;
- ``<eval>/mesh*/mesh-{ckpt}.ply`` (canonical cube) and
  ``mesh-scaled-{ckpt}.ply`` (world) of the marching-cubes variants;
- ``<eval>/merged-mesh*/merged-mesh-scaled-{ckpt}.ply`` (world) and
  ``merged-mesh-{ckpt}.ply`` of the quadrant merges;
- ``<eval>/tsdf-mesh/tsdf.ply`` and its smoothed and refused variants;
- ``<eval>/3d-metrics.json``.

Each view renders as a whole image through ``VectorFieldNerf.render_image``
(chunks of ``split_size`` rays, 3 fused-MLP and 2 ray-march launches per
chunk on the card). An image's host read and PNG encoding happen after the
next image is enqueued, so they overlap its rendering. The marching-cubes
methods evaluate the VF field on the model's device through
``get_vector_field`` (one fused-MLP launch per ``GRID_CHUNK`` grid points,
no ray march); TSDF fusion, refuse and the 3D metrics run on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.evaluation.mc.device_pipeline import (GRID_CHUNK,
                                                         DeviceMeshExtractor)
from vf_nerf_torch.evaluation.mc.pipeline import quadrant_translations
from vf_nerf_torch.evaluation.mc.tsdf import fuse_depth_maps
from vf_nerf_torch.evaluation.renderer import refuse_mesh
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils import metrics as metric_utils
from vf_nerf_torch.utils.meshes import (apply_transform, chamfer_distance,
                                        concatenate_meshes, icp_align,
                                        laplacian_smooth, nn_distances,
                                        precision_recall_fscore,
                                        sample_surface)
from vf_nerf_torch.utils.ply import load_ply, save_ply


def render_images(model: VectorFieldNerf,
                  eval_path: str,
                  dataset_config: DatasetConfig,
                  epoch: int,
                  split_size: int = 1024) -> None:
    """Render every view of the dataset and save rgb and depth."""
    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    dataset.all_pixels = True
    model.near, model.far = dataset.get_bounds()
    path = os.path.join(eval_path, "rendered_images")
    io_utils.mkdir_ifnotexists(path)
    h, w = dataset.image_size

    def finish(i, batch, rgb, depth):
        rgb_img = np.zeros((h, w, 3), np.float32)
        depth_img = np.zeros((h, w, 1), np.float32)
        xs = batch["uv"][:, 0].astype(np.int64)
        ys = batch["uv"][:, 1].astype(np.int64)
        rgb_img[ys, xs] = rgb.cpu().numpy()
        depth_img[ys, xs] = depth.cpu().numpy()
        io_utils.save_rgb(os.path.join(path, f"image-{i}.png"), rgb_img)
        io_utils.save_depth(os.path.join(path, f"depth-{i}"),
                            depth_img[..., 0])

    prev = None
    for i in range(len(dataset)):
        batch = dataset[i]
        rgb, depth = model.render_image(
            batch["uv"], batch["pose"][0], batch["intrinsics"][0], epoch,
            dataset.white_bkgd, split_size)
        if prev is not None:
            finish(*prev)
        prev = (i, batch, rgb, depth)
    if prev is not None:
        finish(*prev)


def metrics(model: VectorFieldNerf,
            eval_path: str,
            dataset_config: DatasetConfig,
            epoch: int,
            split_size: int = 1024) -> Dict[str, float]:
    """Per-image and mean PSNR → ``metrics.json``; renders the images first
    if any is missing."""
    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    dataset.all_pixels = True
    images_path = os.path.join(eval_path, "rendered_images")
    num_images = len(dataset)
    needed = [os.path.join(images_path, f"{kind}-{i}.{ext}")
              for kind, ext in (("image", "png"), ("depth", "npy"))
              for i in range(num_images)]
    if not all(os.path.exists(p) for p in needed):
        print("Not all images and depth maps exist. Rendering.")
        render_images(model, eval_path, dataset_config, epoch, split_size)

    h, w = dataset.image_size
    psnrs = np.zeros(num_images)
    payload: Dict = {}
    for i in range(num_images):
        target = dataset.rgb_images[i].reshape(h, w, 3)
        predicted = io_utils.load_rgb(
            os.path.join(images_path, f"image-{i}.png"), transpose=False)
        psnrs[i] = metric_utils.get_psnr(predicted, target)
        payload[f"image-{i}"] = {"psnr": float(psnrs[i])}
    payload["mean_psnr"] = float(psnrs.mean())
    io_utils.write_json(os.path.join(eval_path, "metrics.json"), payload)
    return payload


def tsdf_mesh(eval_path: str, dataset_config: DatasetConfig) -> None:
    """Fuse the rendered depth maps into a TSDF mesh → ``tsdf-mesh/tsdf.ply``
    (reference ``methods.py:613-665``; in-repo fusion instead of Open3D:
    voxel 4/512, truncation 0.04, depth truncation 10)."""

    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    images_path = os.path.join(eval_path, "rendered_images")
    files = os.listdir(images_path)
    n_depth = len([f for f in files
                   if f.startswith("depth") and f.endswith(".npy")])

    depths = [np.load(os.path.join(images_path, f"depth-{i}.npy"))
              for i in range(n_depth)]
    poses = [dataset.poses[i] for i in range(n_depth)]
    intrinsics = [dataset.intrinsics for _ in range(n_depth)]

    verts, faces = fuse_depth_maps(depths, poses, intrinsics,
                                   voxel_size=4.0 / 512.0, sdf_trunc=0.04,
                                   depth_trunc=10.0)
    mesh_dir = os.path.join(eval_path, "tsdf-mesh")
    io_utils.mkdir_ifnotexists(mesh_dir)
    save_ply(os.path.join(mesh_dir, "tsdf.ply"), verts, faces)


def _metric_sample_count(num_points: Optional[int] = None) -> int:
    """Surface sample count for 3D metrics (reference ``metrics_3d`` /
    ``metrics_3d_no_vf`` default ``num_points=1000000``,
    ``methods.py:669,750``); VFNERF_3D_METRIC_SAMPLES overrides for quick
    runs/tests."""
    if "VFNERF_3D_METRIC_SAMPLES" in os.environ:
        return int(os.environ["VFNERF_3D_METRIC_SAMPLES"])
    return 1_000_000 if num_points is None else num_points


def _run_evaluation(pred_points: np.ndarray, gt_points: np.ndarray,
                    distance_thresh: float, icp: bool) -> Dict[str, float]:
    """In-repo replacement for the external ``evaluate_3d_reconstruction``
    evaluator (reference ``methods.py:722-730``): P/R/F at a distance
    threshold plus accuracy/completeness, with the evaluator's optional
    ICP pre-alignment of prediction → GT (``icp_align=True`` is essential
    for external baselines whose meshes are not in the GT frame)."""
    if icp:
        transform = icp_align(pred_points, gt_points)
        pred_points = apply_transform(pred_points, transform)
    return precision_recall_fscore(pred_points, gt_points, distance_thresh)


def metrics_3d(eval_path: str, dataset_config: DatasetConfig,
               num_points: Optional[int] = None,
               icp_align: bool = False,
               distance_thresh: float = 0.05) -> Dict[str, Dict]:
    """Chamfer + P/R/F-score on the four TSDF variants → ``3d-metrics.json``
    (reference ``methods.py:667-744``).

    Matches the reference variant set and artifact names exactly: ``tsdf``
    (raw fusion), ``tsdf_smoothed`` (10-iteration Laplacian, :686-691),
    ``refused_tsdf`` (refuse of the **raw** tsdf, :697-702) and
    ``refused_tsdf_smoothed`` (refuse of the smoothed mesh, :704-709) —
    each scored as ``{"chamfer distance": {mean, median, min, max},
    precision, recall, fscore, ...}`` (:732-741). Chamfer is computed on
    the un-aligned meshes (as upstream); ICP, when requested, only affects
    the P/R/F stage (the external evaluator's behavior)."""

    dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
    mesh_dir = os.path.join(eval_path, "tsdf-mesh")
    tsdf_path = os.path.join(mesh_dir, "tsdf.ply")
    if not os.path.exists(tsdf_path):
        print("TSDF mesh does not exist. Generating mesh.")
        tsdf_mesh(eval_path, dataset_config)
    verts, faces = load_ply(tsdf_path)

    # Laplacian-smoothed variant (reference :686-691); reuse if present.
    smooth_path = os.path.join(mesh_dir, "tsdf-smoothed.ply")
    if os.path.exists(smooth_path):
        sm_verts, sm_faces = load_ply(smooth_path)
    else:
        sm_verts, sm_faces = laplacian_smooth(verts, faces,
                                              iterations=10), faces
        save_ply(smooth_path, sm_verts, sm_faces)

    # "Refused" variants: re-render into training views + re-fuse (:33-72);
    # the reference refuses the RAW tsdf (:697-702) and the smoothed mesh
    # (:704-709) separately, caching each by filename.
    refused = {}
    for fname, (v, f) in (("refused-tsdf.ply", (verts, faces)),
                          ("refused-tsdf-smoothed.ply",
                           (sm_verts, sm_faces))):
        path = os.path.join(mesh_dir, fname)
        if os.path.exists(path):
            refused[fname] = load_ply(path)
        else:
            rv, rf = refuse_mesh(v, f, dataset)
            save_ply(path, rv, rf)
            refused[fname] = (rv, rf)

    gt_verts, gt_faces = load_ply(_gt_mesh_path(dataset_config))
    n_samples = _metric_sample_count(num_points)
    gt_points = sample_surface(gt_verts, gt_faces, n_samples, seed=0)

    # Reference key order (:732-736): tsdf, refused_tsdf, tsdf_smoothed,
    # refused_tsdf_smoothed.
    variants = {"tsdf": (verts, faces),
                "refused_tsdf": refused["refused-tsdf.ply"],
                "tsdf_smoothed": (sm_verts, sm_faces),
                "refused_tsdf_smoothed":
                    refused["refused-tsdf-smoothed.ply"]}
    results: Dict[str, Dict] = {}
    for name, (v, f) in variants.items():
        if len(v) == 0:
            results[name] = {"error": "empty mesh"}
            continue
        pred_points = sample_surface(v, f, n_samples, seed=0)
        dists = nn_distances(pred_points, gt_points)
        results[name] = {
            "chamfer distance": chamfer_distance(pred_points, gt_points,
                                                 distances=dists)}
        # ICP off (the metrics_3d default) shares the NN distances with the
        # chamfer stage; ICP on re-queries against the aligned prediction.
        results[name].update(
            _run_evaluation(pred_points, gt_points, distance_thresh,
                            icp=icp_align)
            if icp_align else
            _run_evaluation_shared(pred_points, gt_points, distance_thresh,
                                   dists))

    with open(os.path.join(eval_path, "3d-metrics.json"), "w") as f:
        json.dump(results, f, indent=4)
    return results


def _run_evaluation_shared(pred_points, gt_points, distance_thresh, dists):
    return precision_recall_fscore(pred_points, gt_points, distance_thresh,
                                   distances=dists)


def metrics_3d_no_vf(eval_path: str, checkpoint: str,
                     dataset_config: DatasetConfig,
                     num_points: Optional[int] = None,
                     icp_align: bool = True,
                     distance_thresh: float = 0.05) -> Dict[str, Dict]:
    """3D metrics for a baseline marching-cubes mesh (reference
    ``methods.py:747-801``): loads ``mesh/mesh-scaled-{checkpoint}.ply``,
    builds the refused variant (``mesh/refused-mesh-{checkpoint}.ply``),
    and scores both — ``{"mc": ..., "refused": ...}`` with the
    ``"chamfer distance"`` subdict plus ICP-aligned P/R/F
    (``icp_align=True`` by default, as upstream: external baseline meshes
    such as MonoSDF are not in the GT frame)."""

    mesh_path = os.path.join(eval_path, "mesh",
                             f"mesh-scaled-{checkpoint}.ply")
    if not os.path.exists(mesh_path):
        # QUIRK (reproduced): the reference raises FileExistsError — not
        # FileNotFoundError — for the missing mesh (``methods.py:765``).
        raise FileExistsError("Marching cubes mesh does not exist. "
                              "Please generate the mesh first.")
    verts, faces = load_ply(mesh_path)

    refused_path = os.path.join(eval_path, "mesh",
                                f"refused-mesh-{checkpoint}.ply")
    if os.path.exists(refused_path):
        rf_verts, rf_faces = load_ply(refused_path)
    else:
        dataset = dataset_dict[dataset_config.dataset_name](dataset_config)
        rf_verts, rf_faces = refuse_mesh(verts, faces, dataset)
        save_ply(refused_path, rf_verts, rf_faces)

    gt_verts, gt_faces = load_ply(_gt_mesh_path(dataset_config))
    n_samples = _metric_sample_count(num_points)
    gt_points = sample_surface(gt_verts, gt_faces, n_samples, seed=0)

    results: Dict[str, Dict] = {}
    for name, (v, f) in (("mc", (verts, faces)),
                         ("refused", (rf_verts, rf_faces))):
        if len(v) == 0:
            results[name] = {"error": "empty mesh"}
            continue
        pred_points = sample_surface(v, f, n_samples, seed=0)
        results[name] = {
            "chamfer distance": chamfer_distance(pred_points, gt_points)}
        results[name].update(
            _run_evaluation(pred_points, gt_points, distance_thresh,
                            icp=icp_align))

    with open(os.path.join(eval_path, "3d-metrics.json"), "w") as f:
        json.dump(results, f, indent=4)
    return results


def _gt_mesh_path(dataset_config: DatasetConfig) -> str:
    base = os.path.join(dataset_config.data_root_dir,
                        dataset_config.data_dir)
    if dataset_config.dataset_name == "replica":
        return os.path.join(base, f"{dataset_config.scene}_mesh.ply")
    return os.path.join(base, str(dataset_config.scene),
                        f"{dataset_config.scene}_vh_clean.ply")


# ---------------------------------------------------------------- MC meshes

def _extractor(model: VectorFieldNerf, resolution: int, smooth_all: bool,
               smooth_after: bool) -> DeviceMeshExtractor:
    """The model's VF field on its device, one fused-MLP launch per
    ``GRID_CHUNK`` grid points."""
    return DeviceMeshExtractor(
        lambda pts: model.get_vector_field(pts, chunk=GRID_CHUNK),
        resolution, device=model.device, smooth_before=smooth_all,
        smooth_after=smooth_after)


def marching_cubes_mesh(model: VectorFieldNerf, resolution: int,
                        mesh_path: str, checkpoint: str, scale: float,
                        max_batch: int, centroid: np.ndarray,
                        smooth_after: bool = False,
                        smooth_all: bool = False,
                        translation: Optional[np.ndarray] = None) -> tuple:
    """VF grid → contrastive marching cubes → ply (reference
    ``methods.py:139-322``). ``max_batch`` is the reference's host batch,
    kept in the signature; the grid goes in ``GRID_CHUNK`` chunks."""
    translation = (np.zeros(3, np.float32) if translation is None
                   else np.asarray(translation, np.float32))
    extractor = _extractor(model, resolution, smooth_all, smooth_after)
    verts, faces = extractor.extract(scale, np.asarray(centroid),
                                     translation, world_coords=False)
    io_utils.mkdir_ifnotexists(mesh_path)
    # The reference's pair (methods.py:289-322): mesh-<ckpt>.ply in
    # canonical cube coordinates, mesh-scaled-<ckpt>.ply in world
    # coordinates (× scale + translation + centroid).
    save_ply(os.path.join(mesh_path, f"mesh-{checkpoint}.ply"), verts, faces)
    world = verts * scale + (translation +
                             np.asarray(centroid, np.float32)) \
        if len(verts) else verts
    save_ply(os.path.join(mesh_path, f"mesh-scaled-{checkpoint}.ply"),
             world, faces)
    return world, faces


def quadrant_marching_cubes(model: VectorFieldNerf, resolution: int,
                            mesh_path: str, checkpoint: str, scale: float,
                            max_batch: int, centroid: np.ndarray,
                            num_quadrants: int = 8,
                            smooth_after: bool = False,
                            smooth_all: bool = False) -> tuple:
    """Per-octant MC + concatenation, the reference's memory workaround for
    high resolutions (``methods.py:74-137``: 8, 35 or 64 sub-cubes of
    ``resolution``³ samples each). One extractor serves every octant, and
    octant k's host tail overlaps octant k+1's field grid; with the
    model's eval devices (``enable_mesh_eval``) the octants spread over
    them."""
    centroid = np.asarray(centroid, np.float32)
    octants = list(quadrant_translations(num_quadrants, scale))
    extractor = _extractor(model, resolution, smooth_all, smooth_after)
    model.sync_replicas()
    meshes = [(v, f) for v, f in extractor.extract_many(
        octants, centroid, devices=model.eval_devices) if len(v)]
    verts, faces = concatenate_meshes(meshes) if meshes else \
        (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    io_utils.mkdir_ifnotexists(mesh_path)
    # The reference's pair (methods.py:126-137): merged-mesh-scaled-<ckpt>
    # in world coordinates, merged-mesh-<ckpt> divided by the full scale and
    # shifted by −centroid.
    save_ply(os.path.join(mesh_path,
                          f"merged-mesh-scaled-{checkpoint}.ply"),
             verts, faces)
    normalized = (verts / scale - centroid) if len(verts) else verts
    save_ply(os.path.join(mesh_path, f"merged-mesh-{checkpoint}.ply"),
             normalized, faces)
    return verts, faces
