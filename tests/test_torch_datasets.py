"""The port's synthetic scenes and batch assembly against the JAX package's,
on the CPU: every array equal, for two seeds, and the same batches from
``epoch_batches(np.random.RandomState(42))`` in the mixed-view, single-view
and whole-image modes."""

import numpy as np
import pytest

from vf_nerf_tpu.config.schema import DatasetConfig as JDatasetConfig
from vf_nerf_tpu.datasets import synthetic as jsynthetic
from vf_nerf_tpu.datasets.base import pixel_grid as jpixel_grid
from vf_nerf_torch.config.schema import DatasetConfig
from vf_nerf_torch.datasets import dataset_dict, synthetic
from vf_nerf_torch.datasets.base import pixel_grid

SCENES = [("box", synthetic.SyntheticBoxDataset,
           jsynthetic.SyntheticBoxDataset, {}),
          ("office", synthetic.SyntheticOfficeDataset,
           jsynthetic.SyntheticOfficeDataset,
           dict(n_images=6, extra_down_views=2))]
ARRAYS = ("rgb_images", "depth_images", "poses", "intrinsics")


def _assert_batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,cls,jcls,kw", SCENES,
                         ids=[s[0] for s in SCENES])
def test_scene_arrays_equal_jax(name, cls, jcls, kw, seed):
    ours, ref = cls(seed=seed, **kw), jcls(seed=seed, **kw)
    for key in ARRAYS:
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key),
                                      err_msg=key)
    assert ours.get_bounds() == ref.get_bounds()
    assert ours.get_vf_init_method() == ref.get_vf_init_method()
    np.testing.assert_array_equal(ours.get_centroid(), ref.get_centroid())
    assert ours.scale == ref.scale and ours.image_size == ref.image_size
    for a, b in zip(ours.gt_mesh(), ref.gt_mesh()):
        np.testing.assert_array_equal(a, b)
    pts = np.random.RandomState(seed).uniform(-2.5, 2.5, (400, 3))
    if name == "box":
        got = synthetic.analytic_vf(pts, ours.half_size)
        want = jsynthetic.analytic_vf(pts, ref.half_size)
    else:
        got, want = ours.analytic_vf(pts), ref.analytic_vf(pts)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["mixed", "single", "whole"])
@pytest.mark.parametrize("name,cls,jcls,kw", SCENES,
                         ids=[s[0] for s in SCENES])
def test_epoch_batches_equal_jax(name, cls, jcls, kw, mode):
    args = dict(pixels_per_batch=96, shuffle_views=mode == "mixed",
                all_pixels=mode == "whole", **kw)
    ours, ref = cls(**args), jcls(**args)
    assert ours.total_pixels == ref.total_pixels
    for epoch in range(2):
        _assert_batches_equal(
            ours.epoch_batches(np.random.RandomState(42 + epoch)),
            ref.epoch_batches(np.random.RandomState(42 + epoch)))
    if mode == "mixed":
        batch = next(ours.epoch_batches(np.random.RandomState(42)))
        assert "view_idx" in batch
        assert len(batch["uv"]) == ours.total_pixels


def test_registry_and_config_path():
    """The conf's ``dataset_name`` builds the same scene as the JAX
    registry; the Replica and ScanNet loaders, like the JAX ones, raise
    ``FileNotFoundError`` without their files (``test_torch_loaders.py``
    reads real-format scenes)."""
    kw = dict(dataset_name="synthetic", data_dir="Synthetic",
              shuffle_views=True, pixels_per_batch=64, scene="box",
              data_root_dir="data")
    ours = dataset_dict["synthetic"](DatasetConfig(**kw))
    ref = jsynthetic.SyntheticBoxDataset(JDatasetConfig(**kw))
    assert ours.total_pixels == ref.total_pixels == 64
    _assert_batches_equal(ours.epoch_batches(np.random.RandomState(42)),
                          ref.epoch_batches(np.random.RandomState(42)))
    np.testing.assert_array_equal(pixel_grid(5, 7), jpixel_grid(5, 7))
    for name in ("replica", "scannet"):
        with pytest.raises(FileNotFoundError):
            dataset_dict[name](DatasetConfig(**dict(kw, dataset_name=name)))
