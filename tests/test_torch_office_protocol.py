"""The port's office protocol tools against the JAX package's, on the CPU.

``tools/torch_office_protocol.py``, ``tools/torch_office_attribution.py``
and ``tools/torch_scannet_protocol.py`` against ``tools/office_protocol.py``,
``tools/office_attribution.py``, ``tools/scannet_protocol.py`` and
``tools/convergence_variance.py`` on the same inputs: the rewritten confs
parse to equal configs in both packages; the depth corruption is equal; the
office's Replica trees are equal byte for byte (the VF-init ``.pkl`` in its
structure and keys); the PSNR breakdowns and the MC-mesh scores of one set
of rendered PNGs and one mesh agree within rtol 1e-6; the attribution's
observed mask and group indices are equal. Then cut runs of the port tools'
``main`` with ``--gpu cpu`` on a narrow conf (3 views of 24 x 32, 2 epochs,
MC res 16, 3D metrics on 3,000 samples, the TSDF volume capped at 2 M
voxels): ``office.json`` holds every key of
``results/office_r5.json["headline"]``, and the cohort record of that one
seed every key of ``results/office_r5.json``; and each tool raises without
CUDA unless given ``--gpu cpu``.
"""

import dataclasses
import filecmp
import functools
import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TOOLS = str(ROOT / "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import convergence_variance as jcv  # noqa: E402
import office_attribution as jattr  # noqa: E402
import office_protocol as jop  # noqa: E402
import scannet_protocol as jsp  # noqa: E402
import torch_office_attribution as tattr  # noqa: E402
import torch_office_cohort as tcohort  # noqa: E402
import torch_office_protocol as top  # noqa: E402
import torch_scannet_protocol as tsp  # noqa: E402

VIEWS, SIZE = 3, (24, 32)
# The shipped conf cut to narrow widths, few samples and small batches.
NARROW = [("dimensions = [256, 256, 256, 256, 256, 256, 256, 256]",
           "dimensions = [64, 64, 64]"),
          ("skip_connection_in = [4]", "skip_connection_in = [2]"),
          ("feature_vector_dims = 256", "feature_vector_dims = 16"),
          ("dimensions = [256, 256, 256, 256]", "dimensions = [16]"),
          ("n_samples = 100", "n_samples = 16"),
          ("n_importance = 30", "n_importance = 4"),
          ("max_samples = 100", "max_samples = 8"),
          ("increase_every = 50", "increase_every = 1"),
          ("pixels_per_batch = 1024", "pixels_per_batch = 256"),
          ("rays_per_batch = 1024", "rays_per_batch = 256")]


def _parse_both(conf_path, workdir, scene="office"):
    from vf_nerf_tpu.config.parser import parse_config as jparse
    from vf_nerf_torch.config import parse_config

    kw = dict(scene=scene, config_path=conf_path, expname="office",
              timestamp="run", data_root_dir=workdir, offline=True)
    return jparse(**kw), parse_config(**kw)


@pytest.mark.parametrize("clamp,mask", [(None, False), (3.0, False),
                                        (3.0, True), (None, True)])
def test_conf_rewrite_parses_alike(clamp, mask, tmp_path):
    """``write_conf`` (+ the clamp and mask patches) writes the same file in
    both tools, and both packages' parsers read it to equal configs."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir(), tdir.mkdir()
    jpath = jcv.write_conf(str(tdir), 2000)
    os.rename(jpath, jdir / "run.conf")
    jpath = str(jdir / "run.conf")
    tpath = top.write_conf(str(tdir), 2000)
    for path, mod in ((jpath, jop), (tpath, top)):
        if clamp is not None:
            mod.apply_depth_clamp(path, clamp)
        if mask:
            mod.apply_mask_invalid_depth(path)
    assert Path(jpath).read_text() == Path(tpath).read_text()
    ref, ours = _parse_both(tpath, str(tdir))
    for name in ("dataset_config", "vf_loss_weights", "vf_loss_config"):
        assert dataclasses.asdict(getattr(ours, name)) == \
            dataclasses.asdict(getattr(ref, name)), name
    for name in ("vf_net_config", "rendering_net_config",
                 "ray_sampler_config", "scheduler_config", "density_config"):
        assert dataclasses.asdict(getattr(ours.vf_nerf_config, name)) == \
            dataclasses.asdict(getattr(ref.vf_nerf_config, name)), name
    for name in ("num_epochs", "save_frequency", "exps_folder", "expname",
                 "convergence_loss_threshold"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.vf_nerf_config.device_config.static_fine_growth is True
    assert ours.num_epochs == 2000 and ours.save_frequency == 500
    assert ours.vf_loss_config.depth_loss_clamp == (clamp or 0.5)
    assert ours.vf_loss_config.mask_invalid_depth is mask
    assert ours.dataset_config.factor == 1


def test_the_clamp_patch_refuses_a_conf_without_its_anchor(tmp_path):
    path = tmp_path / "run.conf"
    path.write_text("loss { config { depth_loss_clamp = 0.7 } }\n")
    with pytest.raises(RuntimeError, match="refusing"):
        top.apply_depth_clamp(str(path), 3.0)


@pytest.mark.parametrize("scene_type,clamp", [("office", None),
                                              ("office", 3.0),
                                              ("box", None)])
def test_scannet_conf_parses_alike(scene_type, clamp, tmp_path):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir(), tdir.mkdir()
    jpath = jsp.write_scannet_conf(str(jdir), 2000, 10, scene_type, clamp)
    tpath = tsp.write_scannet_conf(str(tdir), 2000, 10, scene_type, clamp)
    assert Path(jpath).read_text().replace(str(jdir), str(tdir)) == \
        Path(tpath).read_text()
    ref, ours = _parse_both(tpath, str(tdir), scene="scene0000_00")
    assert dataclasses.asdict(ours.dataset_config) == \
        dataclasses.asdict(ref.dataset_config)
    assert ours.convergence_loss_threshold == ref.convergence_loss_threshold
    assert ours.vf_loss_config.depth_loss_clamp == \
        ref.vf_loss_config.depth_loss_clamp


@pytest.mark.parametrize("dropout,noise", [(0.0, 0.0), (0.15, 0.0),
                                           (0.0, 0.02), (0.1, 0.03)])
def test_corrupt_depth_is_equal(dropout, noise):
    depth = np.random.RandomState(5).uniform(0.2, 4.0, (4, 300, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(
        top.corrupt_depth(depth, dropout, noise, seed=11),
        jop.corrupt_depth(depth, dropout, noise, seed=11))


def _tree_layout(tree):
    if isinstance(tree, dict):
        return {k: _tree_layout(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def short_vf_init(module):
    """``module.fit_vf_init`` cut to 2 steps of 256 points while entered."""
    fit = module.fit_vf_init

    class Cut:
        def __enter__(self):
            module.fit_vf_init = lambda *a, **k: fit(
                *a, **dict(k, steps=2, batch=256))

        def __exit__(self, *exc):
            module.fit_vf_init = fit
    return Cut()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The office exported by both tools (3 views of 24 x 32, 10 % holes),
    each VF init cut to 2 steps."""
    import vf_nerf_torch.train.vf_init as tvf
    import vf_nerf_tpu.train.vf_init as jvf

    root = tmp_path_factory.mktemp("export")
    with short_vf_init(jvf):
        jds = jop.export_office(str(root / "jax"), VIEWS, SIZE, 1.1,
                                depth_dropout=0.1, extra_down_views=1)
    with short_vf_init(tvf):
        tds = top.export_office(str(root / "torch"), VIEWS, SIZE, 1.1,
                                depth_dropout=0.1, extra_down_views=1,
                                device="cpu")
    return root, jds, tds


def test_export_office_trees_are_equal(exported):
    root, jds, tds = exported
    jroot, troot = root / "jax" / "Replica", root / "torch" / "Replica"
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(troot) for p in troot.rglob("*")
                           if p.is_file())
    assert len(files) == 2 * (VIEWS + 1) + 4
    # The depth PNGs' bytes assume Python's zlib and cv2's deflate alike
    # (see test_torch_codecs.py::test_png16_bytes_are_cv2s).
    for rel in files:
        if rel.suffix == ".pkl":
            continue
        assert filecmp.cmp(jroot / rel, troot / rel, shallow=False), rel
    with open(jroot / "office" / "office.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(troot / "office" / "office.pkl", "rb") as f:
        ours = pickle.load(f)
    for key in ("params", "batch_stats"):
        assert _tree_layout(ours[key]) == _tree_layout(ref[key]), key
    assert set(ours) - set(ref) <= {"mode", "radius"}
    np.testing.assert_array_equal(tds.depth_images, jds.depth_images)


@pytest.fixture(scope="module")
def rendered(exported, tmp_path_factory):
    """Rendered PNGs (the GT frames with seeded noise) and a merged MC mesh
    (the GT mesh's vertices moved by seeded noise) in an eval layout."""
    from vf_nerf_torch.utils import io as io_utils
    from vf_nerf_torch.utils.ply import load_ply, save_ply

    root, _, tds = exported
    rng = np.random.RandomState(3)
    work = root / "torch"
    img_dir = tmp_path_factory.mktemp("imgs")
    h, w = tds.image_size
    for i in range(tds.n_images):
        img = tds.rgb_images[i].reshape(h, w, 3)
        io_utils.save_rgb(str(img_dir / f"image-{i}.png"),
                          np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1))
        np.save(img_dir / f"depth-{i}.npy", tds.depth_images[i].reshape(h, w)
                + rng.normal(0, 0.05, (h, w)).astype(np.float32))
    v, f = load_ply(str(work / "Replica" / "office_mesh.ply"))
    mesh_dir = work / "evals" / "merged-mesh"
    mesh_dir.mkdir(parents=True)
    save_ply(str(mesh_dir / "merged-mesh-scaled-latest.ply"),
             v + rng.normal(0, 0.01, v.shape).astype(np.float32), f)
    return img_dir, work


def _assert_close(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_close(a[k], b[k], f"{path}/{k}")
    elif b is None or isinstance(b, (bool, int)):
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=path)


def test_breakdowns_and_mc_scores_agree(exported, rendered):
    _, jds, tds = exported
    img_dir, work = rendered
    _assert_close(top.edge_breakdown_ds(tds, str(img_dir)),
                  jcv.edge_breakdown_ds(jds, str(img_dir)))
    ours = top.group_psnr_breakdown(tds, str(img_dir))
    assert len(ours) >= 4
    _assert_close(ours, jop.group_psnr_breakdown(jds, str(img_dir)))
    ours = top.score_mc_meshes(str(work / "evals"), str(work),
                               n_samples=20000)
    assert set(ours) == {"merged-mesh"}
    _assert_close(ours, jop.score_mc_meshes(str(work / "evals"), str(work),
                                            n_samples=20000))


def test_attribution_masks_and_groups_are_equal(exported, rendered):
    from vf_nerf_torch.utils.meshes import sample_surface
    from vf_nerf_torch.utils.ply import load_ply

    root, jds, tds = exported
    img_dir, _ = rendered
    v, f = load_ply(str(root / "torch" / "Replica" / "office_mesh.ply"))
    pts = sample_surface(v, f, 20000, 0)
    obs = tattr.observed_mask(pts, tds)
    np.testing.assert_array_equal(obs, jattr.observed_mask(pts, jds))
    assert 0.0 < obs.mean() < 1.0
    groups = tattr.group_attribution(pts, tds.rects)
    np.testing.assert_array_equal(groups,
                                  jattr.group_attribution(pts, jds.rects))
    assert len(np.unique(groups)) == len(top.GROUPS)
    out_dir = img_dir.parent / "attr_eval"
    out_dir.mkdir()
    (out_dir / "rendered_images").symlink_to(img_dir)
    _assert_close(tattr.per_group_render_errors(tds, str(out_dir)),
                  jattr.per_group_render_errors(jds, str(out_dir)))


@pytest.fixture
def narrow_conf(tmp_path, monkeypatch):
    """The tools write their run.conf from a narrow copy of the shipped
    conf, and fit a 2-step VF init."""
    import vf_nerf_torch.train.vf_init as tvf

    text = (ROOT / "confs" / "vf_nerf.conf").read_text()
    for old, new in NARROW:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "narrow.conf"
    path.write_text(text)
    monkeypatch.setattr(top, "CONF", str(path))
    fit = tvf.fit_vf_init
    monkeypatch.setattr(tvf, "fit_vf_init", lambda *a, **k: fit(
        *a, **dict(k, steps=2, batch=256)))


@pytest.fixture
def small_tsdf(monkeypatch):
    """The TSDF volume capped at 2 M voxels (the fusion coarsens its voxel
    to fit) and 3,000 metric samples, so a CPU run takes seconds."""
    from vf_nerf_torch.evaluation import methods, renderer
    from vf_nerf_torch.evaluation.mc import tsdf

    fuse = functools.partial(tsdf.fuse_depth_maps, max_voxels=2_000_000)
    monkeypatch.setattr(methods, "fuse_depth_maps", fuse)
    monkeypatch.setattr(renderer, "fuse_depth_maps", fuse)
    monkeypatch.setenv("VFNERF_3D_METRIC_SAMPLES", "3000")


def test_protocol_main_writes_the_headline_keys(narrow_conf, small_tsdf,
                                                 tmp_path):
    work = tmp_path / "office"
    summary = top.main(["--gpu", "cpu", "--views", str(VIEWS), "--size",
                        *map(str, SIZE), "--epochs", "2", "--resolution",
                        "16", "--mc", "trio", "--depth-clamp", "3.0",
                        "--workdir", str(work)])
    with open(ROOT / "results" / "office_r5.json") as f:
        headline = json.load(f)["headline"]
    with open(work / "office.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(summary))
    assert set(headline) <= set(written)
    assert set(written["metrics_3d"]) == set(headline["metrics_3d"])
    assert set(written["eval_wall_s"]) == set(headline["eval_wall_s"])
    assert set(written["mc"]["metrics_3d_mc"]) == \
        set(headline["mc"]["metrics_3d_mc"])
    assert written["device"] == "cpu" and written["depth_loss_clamp"] == 3.0
    assert len(written["per_image_psnr"]) == VIEWS
    assert len(written["epoch_losses"]) == 2
    assert np.isfinite(written["mean_psnr"])

    attribution = tattr.main(["--gpu", "cpu", "--workdir", str(work),
                              "--views", str(VIEWS), "--size",
                              *map(str, SIZE), "--samples", "3000"])
    with open(ROOT / "results" / "office_r5.json") as f:
        ref = json.load(f)["headline_attribution"]
    assert set(ref) - {"field_crossings_error"} <= set(attribution)
    assert set(attribution["field_crossings"]) == {
        "through_column", "through_thin_wall", "through_desk_horizontal",
        "through_desk_top"}

    # The cohort record from this one seed, as the card's runs leave it.
    logdir = tmp_path / "cohort"
    logdir.mkdir()
    shutil.copy(work / "office.json", logdir / "office_s42.json")
    shutil.copy(work / "attribution.json", logdir / "attribution_s42.json")
    runs = {"42": {"tree": "t42", "shared_card": ["metrics"]}}
    record = tcohort.build_record(str(logdir), 42, [42, 1], "tree", "parent",
                                  runs)
    with open(ROOT / "results" / "office_r5.json") as f:
        assert set(json.load(f)) <= set(record)
    assert record["seeds_not_run"] == [1] and record["devices"] == ["cpu"]
    assert record["cohort"]["42"]["run"] == runs["42"]
    assert record["source"]["assembled_on_tree"] == "tree"
    with pytest.raises(ValueError, match="no stage"):
        tcohort.build_record(str(logdir), 42, [42], "tree", "parent",
                             {"42": {"shared_card": ["render"]}})
    assert record["cohort_median"]["mean_psnr"] == summary["mean_psnr"]
    assert record["jax_cohort_quality"]["seeds"] == [1, 2, 3, 7, 42]



def test_cohort_carries_an_earlier_records_seeds(tmp_path):
    """Seeds with no files in the log directory keep their rows from an
    earlier record, whose headline stands in for the headline seed's files:
    from an empty directory the H100 record reassembles to itself, and a
    seed in neither is listed as not run."""
    with open(ROOT / "results" / "office_torch_h100.json") as f:
        earlier = json.load(f)
    seeds = sorted(int(s) for s in earlier["cohort"])
    record = tcohort.build_record(str(tmp_path), 42, [*seeds, 11],
                                  "tree", "parent", earlier=earlier)
    for key in ("cohort", "cohort_median", "cohort_range", "headline",
                "headline_attribution", "devices", "any_seed_flagged"):
        assert record[key] == earlier[key], key
    assert record["seeds_not_run"] == [11]
    assert record["source"]["carried_from_earlier_record"] == seeds


def test_scannet_main_runs_on_the_cpu(narrow_conf, small_tsdf, tmp_path):
    out = tsp.main(["--gpu", "cpu", "--views", str(VIEWS), "--size",
                    *map(str, SIZE), "--epochs", "2", "--crop", "2",
                    "--depth-clamp", "3.0", "--workdir",
                    str(tmp_path / "scannet")])
    with open(ROOT / "results" / "scannet_office_r5.json") as f:
        ref = json.load(f)
    assert set(ref) <= set(out)
    assert out["effective_image_size"] == [SIZE[0] - 4, SIZE[1] - 4]
    assert set(out["metrics_3d"]) == set(ref["metrics_3d"])
    assert np.isfinite(out["mean_psnr"])


@pytest.mark.parametrize("tool", ["protocol", "attribution", "scannet"])
def test_tools_raise_without_cuda_unless_asked_for_the_cpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is CUDA there")
    main = {"protocol": top.main, "attribution": tattr.main,
            "scannet": tsp.main}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
