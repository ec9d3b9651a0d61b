"""The port's 3D metrics and mesh eval methods against the JAX package's, on
the CPU.

- ``utils/meshes.py``: surface samples bit for bit (same
  ``RandomState`` draws), NN distances, Chamfer, P/R/F, ICP, the rigid
  transform and Laplacian smoothing equal JAX's (rtol 1e-6 stated, equal
  measured), centroid, bounds and concatenation.
- ``evaluate(..., device="cpu")`` on a seeded box-scene run: ``tsdf-mesh``
  and ``3d-metrics`` write the JAX package's files, and the TSDF mesh and
  ``3d-metrics.json`` equal what JAX's ``tsdf_mesh`` / ``metrics_3d`` give
  on the same depth maps (JSON at rtol 1e-6); ``metrics_3d_no_vf`` (a
  baseline timestamp) equals JAX's on the same mesh; both marching-cubes
  methods write the artifact tree of every variant.

The depth maps are the box scene's own depths scaled by 0.2, written in
place of a render: fused at the methods' fixed voxel of 4/512, a render of
an untrained field (depths up to the far bound, ~5) spans ~10⁹ voxels, too
many for a CPU test; the fused volume here is ~10⁷.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from vf_nerf_tpu.config.schema import DatasetConfig as JDatasetConfig
from vf_nerf_tpu.evaluation import methods as jmethods
from vf_nerf_tpu.utils import meshes as jmeshes
from vf_nerf_tpu.utils import ply as jply
from test_torch_runner import write_conf
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.datasets.synthetic import box_mesh
from vf_nerf_torch.evaluation import evaluate as evaluate_mod
from vf_nerf_torch.evaluation import methods
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.utils import meshes, ply

SAMPLES = "4000"


def _mesh(seed=0, n_verts=60, n_faces=90):
    rng = np.random.RandomState(seed)
    verts = rng.randn(n_verts, 3).astype(np.float32)
    faces = rng.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    return verts, faces


def _rigid(seed):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    t = np.eye(4)
    t[:3, :3] = q if seed else np.eye(3)
    t[:3, 3] = rng.uniform(-0.1, 0.1, 3)
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_mesh_utilities_equal_jax(seed):
    verts, faces = _mesh(seed)
    for n, s in ((500, 0), (1000, 7)):
        np.testing.assert_array_equal(
            meshes.sample_surface(verts, faces, n, seed=s),
            jmeshes.sample_surface(verts, faces, n, seed=s))
    np.testing.assert_array_equal(
        meshes.sample_surface(verts, np.zeros((0, 3), np.int32), 300, 2),
        jmeshes.sample_surface(verts, np.zeros((0, 3), np.int32), 300, 2))
    np.testing.assert_allclose(
        meshes.laplacian_smooth(verts, faces, iterations=10),
        jmeshes.laplacian_smooth(verts, faces, iterations=10),
        rtol=1e-6, atol=0)
    np.testing.assert_array_equal(meshes.mesh_centroid(verts, faces),
                                  jmeshes.mesh_centroid(verts, faces))
    np.testing.assert_array_equal(meshes.mesh_bounds(verts),
                                  jmeshes.mesh_bounds(verts))
    parts = [_mesh(seed + k, 10 + k, 7 + k) for k in range(3)]
    for a, b in zip(meshes.concatenate_meshes(parts),
                    jmeshes.concatenate_meshes(parts)):
        np.testing.assert_array_equal(a, b)

    pred = meshes.sample_surface(verts, faces, 3000, seed=1)
    gt = meshes.apply_transform(
        meshes.sample_surface(verts, faces, 2500, seed=2), _rigid(seed))
    for a, b in zip(meshes.nn_distances(pred, gt),
                    jmeshes.nn_distances(pred, gt)):
        np.testing.assert_array_equal(a, b)
    assert meshes.chamfer_distance(pred, gt) == \
        jmeshes.chamfer_distance(pred, gt)
    for thresh in (0.02, 0.1):
        assert meshes.precision_recall_fscore(pred, gt, thresh) == \
            jmeshes.precision_recall_fscore(pred, gt, thresh)
    transform = meshes.icp_align(pred, gt, sample=2000)
    np.testing.assert_allclose(transform,
                               jmeshes.icp_align(pred, gt, sample=2000),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(meshes.apply_transform(pred, transform),
                                  jmeshes.apply_transform(pred, transform))


@pytest.fixture(scope="module")
def box_run(tmp_path_factory):
    """A seeded checkpoint of the tiny conf on the box scene (run ``run``,
    and the same weights under the baseline timestamp ``monosdf``), the
    scene's GT mesh at its ``_gt_mesh_path``, and depth maps in both eval
    folders."""
    root = str(tmp_path_factory.mktemp("metrics3d"))
    conf = write_conf(root)

    def config(timestamp):
        return parse_config(scene="box", config_path=conf, expname="e",
                            timestamp=timestamp, checkpoint="latest",
                            gpu="cpu", data_root_dir=root)

    cfg = config("run")
    model = VectorFieldNerf(cfg.vf_nerf_config, device="cpu")
    for timestamp in ("run", "monosdf"):
        model.save(3, os.path.join(cfg.exps_folder, cfg.expname, timestamp,
                                   "checkpoints", "vf_nerf"))
    dataset = dataset_dict["synthetic"](cfg.dataset_config)
    gt_path = methods._gt_mesh_path(cfg.dataset_config)
    os.makedirs(os.path.dirname(gt_path))
    ply.save_ply(gt_path, *box_mesh(0.4))
    evals = os.path.join(root, "evals")
    h, w = dataset.image_size
    for timestamp in ("run", "monosdf"):
        images = os.path.join(evals, cfg.expname, f"{timestamp}_latest",
                              "rendered_images")
        os.makedirs(images)
        for i in range(len(dataset)):
            np.save(os.path.join(images, f"depth-{i}.npy"),
                    0.2 * dataset.depth_images[i].reshape(h, w))
    jcfg = JDatasetConfig(**dataclasses.asdict(cfg.dataset_config))
    return root, config, evals, jcfg


def _same_tree(a, b, rtol=1e-6):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k], rtol)
    else:
        assert a == pytest.approx(b, rel=rtol, abs=0)


def test_tsdf_mesh_and_3d_metrics_equal_jax(box_run, monkeypatch):
    root, config, evals, jcfg = box_run
    monkeypatch.setenv("VFNERF_3D_METRIC_SAMPLES", SAMPLES)
    folder = evaluate_mod.evaluate(config("run"), "tsdf-mesh", 32, evals,
                                   512, 0.05, 8, device="cpu")
    assert folder == os.path.join(evals, "e_box", "run_latest")
    evaluate_mod.evaluate(config("run"), "3d-metrics", 32, evals, 512, 0.05,
                          8, device="cpu")
    names = ("tsdf.ply", "tsdf-smoothed.ply", "refused-tsdf.ply",
             "refused-tsdf-smoothed.ply")
    assert sorted(os.listdir(os.path.join(folder, "tsdf-mesh"))) == \
        sorted(names)

    jfolder = os.path.join(root, "jax_eval")
    shutil.copytree(os.path.join(folder, "rendered_images"),
                    os.path.join(jfolder, "rendered_images"))
    jmethods.tsdf_mesh(jfolder, jcfg)
    theirs = jmethods.metrics_3d(jfolder, jcfg, distance_thresh=0.05)
    for name in names:
        ours_v, ours_f = ply.load_ply(os.path.join(folder, "tsdf-mesh", name))
        theirs_v, theirs_f = jply.load_ply(os.path.join(jfolder, "tsdf-mesh",
                                                        name))
        assert len(ours_f) > 100, name
        np.testing.assert_array_equal(ours_v, theirs_v)
        np.testing.assert_array_equal(ours_f, theirs_f)
    with open(os.path.join(folder, "3d-metrics.json")) as f:
        ours = json.load(f)
    assert list(ours) == ["tsdf", "refused_tsdf", "tsdf_smoothed",
                          "refused_tsdf_smoothed"]
    for entry in ours.values():
        assert list(entry) == ["chamfer distance", "precision", "recall",
                               "fscore", "accuracy", "completeness"]
    _same_tree(ours, json.loads(json.dumps(theirs)))


def test_metrics_3d_no_vf_equals_jax(box_run, monkeypatch):
    """A baseline timestamp scores ``mesh/mesh-scaled-<ckpt>.ply`` (here a
    box around the cameras), its refused variant and ICP, as JAX does."""
    root, config, evals, jcfg = box_run
    monkeypatch.setenv("VFNERF_3D_METRIC_SAMPLES", SAMPLES)
    folder = os.path.join(evals, "e_box", "monosdf_latest")
    os.makedirs(os.path.join(folder, "mesh"), exist_ok=True)
    verts, faces = box_mesh(0.45)
    ply.save_ply(os.path.join(folder, "mesh", "mesh-scaled-latest.ply"),
                 verts + np.float32(0.02), faces)
    jfolder = os.path.join(root, "jax_no_vf")
    shutil.copytree(os.path.join(folder, "mesh"),
                    os.path.join(jfolder, "mesh"))
    evaluate_mod.evaluate(config("monosdf"), "3d-metrics", 32, evals, 512,
                          0.1, 8, device="cpu")
    theirs = jmethods.metrics_3d_no_vf(jfolder, "latest", jcfg,
                                       distance_thresh=0.1)
    with open(os.path.join(folder, "3d-metrics.json")) as f:
        ours = json.load(f)
    assert list(ours) == ["mc", "refused"]
    assert ours["mc"]["fscore"] > 0.5
    _same_tree(ours, json.loads(json.dumps(theirs)))
    for name in ("refused-mesh-latest.ply",):
        for a, b in zip(ply.load_ply(os.path.join(folder, "mesh", name)),
                        jply.load_ply(os.path.join(jfolder, "mesh", name))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileExistsError):
        methods.metrics_3d_no_vf(os.path.join(root, "nowhere"), "latest",
                                 config("monosdf").dataset_config)


@pytest.mark.parametrize("method,prefix", [
    ("marching-cubes-mesh", "mesh"),
    ("quadrant-marching-cubes-mesh", "merged-mesh")])
def test_mc_methods_write_the_jax_tree(box_run, method, prefix):
    root, config, evals, _ = box_run
    folder = evaluate_mod.evaluate(config("run"), method, 16, evals, 512,
                                   0.05, 8, device="cpu")
    for suffix in ("", "-smoothed", "-smoothed-after"):
        files = sorted(os.listdir(os.path.join(folder, prefix + suffix)))
        assert files == sorted([f"{prefix}-latest.ply",
                                f"{prefix}-scaled-latest.ply"])
        v, f = ply.load_ply(os.path.join(folder, prefix + suffix,
                                         f"{prefix}-scaled-latest.ply"))
        assert v.shape[1] == 3 and f.shape[1] == 3 and np.isfinite(v).all()
