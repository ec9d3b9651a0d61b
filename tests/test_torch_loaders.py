"""The port's Replica and ScanNet loaders and exporters against the JAX
package's, on the CPU.

The JAX exporters write the box (3 views of 12×16) and the office (4 views
of 48×64) in Replica's and in ScanNet's layouts (ScanNet with
``frame_stride`` 40, so the loader's every-40th subsample finds each view);
both packages' loaders read each. Images, depths, poses, intrinsics,
bounds, centroid, scale and ``image_size`` agree exactly: the port's JPEG
decoder equals the JAX package's ``imageio`` and ``cv2`` reads bit for bit
(``test_torch_codecs.py``). The port's exporters write the same JPEG bytes
as the JAX ones and files that the JAX loaders read into the same arrays as
the port's. ``sample_new_images`` takes the same subset under the same
``np.random.seed``; a ScanNet scene whose colour frames are larger than its
depth frames goes through the resize and ``crop_edge`` alike (the resize
within 1e-9 before the float32 cast, measured equal after it). The training
runner takes an epoch from the Replica-format box.
"""

import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest

from vf_nerf_torch.config import parse_config
from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.datasets.synthetic import (SyntheticBoxDataset,
                                              SyntheticOfficeDataset)
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.utils import jpeg
from vf_nerf_tpu.config.schema import DatasetConfig as JDatasetConfig
from vf_nerf_tpu.datasets import dataset_dict as jdataset_dict
from vf_nerf_tpu.datasets import synthetic as jsynthetic

ROOT = Path(__file__).resolve().parents[1]
SCENES = {  # name → (scene class pair, constructor kwargs)
    "box": ((jsynthetic.SyntheticBoxDataset, SyntheticBoxDataset),
            dict(n_images=3, image_size=(12, 16))),
    "office": ((jsynthetic.SyntheticOfficeDataset, SyntheticOfficeDataset),
               dict(n_images=4, image_size=(48, 64))),
}
ARRAYS = ("rgb_images", "depth_images", "poses", "intrinsics",
          "gt_mesh_centroid")


def _export(root, scene, fmt, port):
    ds = SCENES[scene][0][int(port)](**SCENES[scene][1])
    if fmt == "replica":
        ds.export_replica_format(str(root), scene=scene)
    else:
        ds.export_scannet_format(str(root), scene=scene, frame_stride=40)
    return ds


def _kwargs(root, scene, fmt, **extra):
    kw = dict(dataset_name=fmt, shuffle_views=True, pixels_per_batch=48,
              scene=scene, data_root_dir=str(root),
              data_dir="Replica" if fmt == "replica" else "ScanNet")
    kw.update(factor=1, crop_edge=0) if fmt == "replica" else \
        kw.update(crop_edge=0)
    kw.update(extra)
    return kw


def _load_both(root, scene, fmt, **extra):
    kw = _kwargs(root, scene, fmt, **extra)
    return (jdataset_dict[fmt](JDatasetConfig(**kw)),
            dataset_dict[fmt](DatasetConfig(**kw)))


def _assert_same(ref, ours):
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(ours, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tuple(ref.image_size) == tuple(ours.image_size)
    assert ref.get_bounds() == ours.get_bounds()
    assert ref.scale == ours.scale
    assert len(ref) == len(ours) and ref.total_pixels == ours.total_pixels
    (ref_method, ref_path), (method, path) = (ref.get_vf_init_method(),
                                              ours.get_vf_init_method())
    assert ref_method == method
    assert os.path.basename(ref_path) == os.path.basename(path)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each scene in each format, from each package's exporter."""
    out = {}
    for scene in SCENES:
        for fmt in ("replica", "scannet"):
            for port in (False, True):
                root = tmp_path_factory.mktemp(f"{scene}_{fmt}_{int(port)}")
                source = _export(root, scene, fmt, port)
                out[(scene, fmt, port)] = (root, source)
    return out


@pytest.mark.parametrize("fmt", ["replica", "scannet"])
@pytest.mark.parametrize("scene", ["box", "office"])
def test_both_loaders_read_the_jax_exporters_files(scene, fmt, written):
    root, source = written[(scene, fmt, False)]
    ref, ours = _load_both(root, scene, fmt)
    _assert_same(ref, ours)
    assert len(ours) == source.n_images
    np.testing.assert_array_equal(ours.poses, source.poses)
    np.testing.assert_array_equal(ours.intrinsics, source.intrinsics)
    # 16-bit depth: exact to the mm.
    np.testing.assert_allclose(ours.depth_images, source.depth_images,
                               atol=1e-3)


@pytest.mark.parametrize("fmt", ["replica", "scannet"])
@pytest.mark.parametrize("scene", ["box", "office"])
def test_the_ports_exporters_write_what_the_jax_loaders_read(scene, fmt,
                                                             written):
    """The port's files read by the JAX loaders equal the port's loaders'
    arrays, and equal the JAX exporters' files: the same JPEG bytes, the
    same text files, the same depth values."""
    root, _ = written[(scene, fmt, True)]
    ref, ours = _load_both(root, scene, fmt)
    _assert_same(ref, ours)
    jroot, _ = written[(scene, fmt, False)]
    _assert_same(ref, _load_both(jroot, scene, fmt)[1])
    sub = Path("Replica") / scene / "results" if fmt == "replica" else \
        Path("ScanNet") / scene / "color"
    jpgs = sorted((root / sub).glob("*.jpg"))
    assert jpgs
    for path in jpgs:
        assert filecmp.cmp(path, jroot / sub / path.name, shallow=False)
    if fmt == "replica":
        for name in ("cam_params.json", f"{scene}/traj.txt"):
            assert filecmp.cmp(root / "Replica" / name,
                               jroot / "Replica" / name, shallow=False)


def test_sample_new_images_draws_the_same_subset(written):
    root, _ = written[("office", "replica", False)]
    ref, ours = _load_both(root, "office", "replica",
                           random_img_sampling=True, factor=2)
    assert len(ref) == len(ours) == 2
    for seed in (0, 7):
        np.random.seed(seed)
        ref.sample_new_images()
        np.random.seed(seed)
        ours.sample_new_images()
        for name in ("rgb_images", "depth_images", "poses"):
            np.testing.assert_array_equal(getattr(ref, name),
                                          getattr(ours, name))
    assert ref.rgb_images.shape[0] == 2


def test_scannet_resize_and_crop_match(tmp_path):
    """Colour frames at 2.5× the depth frames' size: the resize to the depth
    size and a ``crop_edge`` of 2, in both packages."""
    source = SyntheticBoxDataset(n_images=2, image_size=(12, 16))
    source.export_scannet_format(str(tmp_path), scene="s", frame_stride=40)
    rng = np.random.RandomState(0)
    color = tmp_path / "ScanNet" / "s" / "color"
    for i in range(2):
        path = color / f"{40 * i:06d}.jpg"
        big = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
        path.write_bytes(jpeg.encode_jpeg(big, 98))
    ref, ours = _load_both(tmp_path, "s", "scannet", crop_edge=2)
    assert tuple(ours.image_size) == (8, 12)
    _assert_same(ref, ours)
    np.testing.assert_allclose(ours.intrinsics[:2, 2],
                               source.intrinsics[:2, 2] - 2)


def test_missing_files_raise(tmp_path):
    for fmt in ("replica", "scannet"):
        with pytest.raises(FileNotFoundError):
            dataset_dict[fmt](DatasetConfig(**_kwargs(tmp_path, "x", fmt)))


def test_runner_trains_an_epoch_on_a_replica_scene(tmp_path):
    """The training runner, CPU, on the port's Replica export of the box
    (the tiny conf of ``tests/test_torch_runner.py``): one epoch, a finite
    loss, the checkpoints written."""
    from test_torch_runner import RUNNER_CONF
    SyntheticBoxDataset(n_images=3, image_size=(12, 16)).export_replica_format(
        str(tmp_path), scene="boxroom")
    conf = RUNNER_CONF.replace("EXPS", str(tmp_path / "exps")).replace(
        'dataset_name = "synthetic"', 'dataset_name = "replica"').replace(
        'data_dir = "Synthetic"', 'data_dir = "Replica"\n    factor = 1'
    ).replace("num_epochs = 3", "num_epochs = 1")
    path = tmp_path / "replica.conf"
    path.write_text(conf)
    cfg = parse_config(scene="boxroom", config_path=str(path), expname="r",
                       timestamp="t", gpu="cpu", data_root_dir=str(tmp_path),
                       offline=True)
    runner = VectorFieldNerfRunner(cfg)
    assert runner.dataset.n_images == 3
    runner.train()
    with open(os.path.join(runner.run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    losses = [x["loss"] for x in lines if x.get("_type") == "metrics"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert os.path.exists(os.path.join(runner.ckpt_dir, "latest.ckpt"))
