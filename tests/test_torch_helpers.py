"""The port's COLMAP, LLFF and pose helpers against the JAX package's, on
generated files, as ``tests/test_tools.py:11-130`` tests JAX's: the same
readers' results, the same IDR cameras written (and the CLI's), the same
LLFF arrays (with and without downsampling, recentered and spherified), the
same poses. All host numpy in both packages, so equal bit for bit."""

import os
import struct
import sys

import numpy as np
import pytest

from vf_nerf_tpu.datasets.helpers import colmap as jcolmap
from vf_nerf_tpu.datasets.helpers import llff as jllff
from vf_nerf_tpu.datasets.helpers import poses_utils as jposes
from vf_nerf_torch.datasets.helpers import colmap, llff, poses_utils


def write_binary_model(model_dir):
    """cameras.bin with a PINHOLE and a SIMPLE_RADIAL camera, images.bin
    with three images (as ``tests/test_tools.py``'s writer, one camera and
    image more)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 640, 480))
        f.write(struct.pack("<4d", 500.0, 480.0, 320.0, 240.0))
        f.write(struct.pack("<iiQQ", 2, 2, 320, 240))
        f.write(struct.pack("<4d", 250.0, 160.0, 120.0, 0.01))
    with open(os.path.join(model_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 3))
        for i, cam, name in ((2, 1, b"b.jpg"), (1, 1, b"a.jpg"),
                             (3, 2, b"c.jpg")):
            f.write(struct.pack("<i", i))
            f.write(struct.pack("<4d", 0.9, 0.1 * i, -0.2, 0.3))
            f.write(struct.pack("<3d", 0.1 * i, 0.2, 0.3))
            f.write(struct.pack("<i", cam))
            f.write(name + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<2d q 2d q", 1.0, 2.0, -1, 3.0, 4.0, -1))
    return model_dir


def write_text_model(model_dir):
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        f.write("# comment\n1 SIMPLE_PINHOLE 640 480 500 320 240\n"
                "2 OPENCV 320 240 250 251 160 120 0.1 0.01 0 0\n")
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        f.write("# two lines per image\n")
        f.write("1 1 0 0 0 0.5 0.6 0.7 1 img.jpg\n1.0 2.0 -1\n")
        f.write("2 0.7 0.1 0.7 0.1 -0.5 0.2 0.1 2 b.jpg\n3.0 4.0 -1\n")
    return model_dir


def assert_models_equal(ours, theirs):
    (cams, imgs), (jcams, jimgs) = ours, theirs
    assert sorted(cams) == sorted(jcams) and sorted(imgs) == sorted(jimgs)
    for k, cam in cams.items():
        j = jcams[k]
        assert (cam.model, cam.width, cam.height) == (j.model, j.width,
                                                      j.height)
        np.testing.assert_array_equal(cam.params, j.params)
        np.testing.assert_array_equal(cam.intrinsic_matrix(),
                                      j.intrinsic_matrix())
    for k, img in imgs.items():
        j = jimgs[k]
        assert (img.name, img.camera_id) == (j.name, j.camera_id)
        np.testing.assert_array_equal(img.world_to_cam(), j.world_to_cam())


@pytest.mark.parametrize("writer", [write_binary_model, write_text_model])
def test_colmap_readers_and_idr_cameras_equal_jax(writer, tmp_path):
    model_dir = writer(str(tmp_path / "sparse"))
    assert_models_equal(colmap.read_model(model_dir),
                        jcolmap.read_model(model_dir))
    ours = colmap.colmap_to_idr_cameras(model_dir, str(tmp_path / "o.npz"))
    theirs = jcolmap.colmap_to_idr_cameras(model_dir,
                                           str(tmp_path / "j.npz"))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    with np.load(tmp_path / "o.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_colmap_cli_writes_the_cameras(tmp_path, monkeypatch, capsys):
    model_dir = write_binary_model(str(tmp_path / "sparse"))
    out = str(tmp_path / "cams.npz")
    monkeypatch.setattr(sys, "argv", ["colmap", "--model_dir", model_dir,
                                      "--out", out])
    colmap.main()
    assert "wrote 3 cameras" in capsys.readouterr().out
    ref = jcolmap.colmap_to_idr_cameras(model_dir, str(tmp_path / "j.npz"))
    with np.load(out) as got:
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v)


def write_llff(base, n=3, h=16, w=24):
    from PIL import Image
    os.makedirs(os.path.join(base, "images"))
    rng = np.random.RandomState(0)
    for i in range(n):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(base, "images",
                                               f"img{i}.png"))
    poses = np.tile(np.eye(4)[:3, :4], (n, 1, 1))
    from scipy.spatial.transform import Rotation
    poses[:, :3, :3] = Rotation.random(n, random_state=2).as_matrix()
    poses[:, :3, 3] = rng.randn(n, 3)
    hwf = np.tile(np.array([h, w, 50.0]), (n, 1))
    rows = np.concatenate([
        np.concatenate([poses, hwf[:, :, None]], axis=2).reshape(n, 15),
        np.tile([1.0, 5.0], (n, 1))], axis=1)
    np.save(os.path.join(base, "poses_bounds.npy"), rows)


@pytest.mark.parametrize("kw", [dict(), dict(factor=2),
                                dict(spherify=True),
                                dict(recenter=False, bound_scale=0.5)])
def test_llff_loader_equals_jax(kw, tmp_path):
    base = str(tmp_path)
    write_llff(base)
    ours = llff.load_llff_data(base, **kw)
    theirs = jllff.load_llff_data(base, **kw)
    assert ours[0].shape[0] == 3
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(llff.load_poses_bounds(base),
                    jllff.load_poses_bounds(base)):
        np.testing.assert_array_equal(a, b)


def test_pose_utilities_equal_jax():
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(0)
    poses = np.tile(np.eye(4)[:3], (5, 1, 1))
    poses[:, :3, :3] = Rotation.random(5, random_state=1).as_matrix()
    poses[:, :3, 3] = rng.randn(5, 3)
    for name in ("average_pose", "recenter_poses"):
        np.testing.assert_array_equal(getattr(poses_utils, name)(poses),
                                      getattr(jposes, name)(poses))
    np.testing.assert_array_equal(
        poses_utils.view_matrix(np.array([0.1, 0.2, 1.0]),
                                np.array([0.0, 1.0, 0.0]), np.ones(3)),
        jposes.view_matrix(np.array([0.1, 0.2, 1.0]),
                           np.array([0.0, 1.0, 0.0]), np.ones(3)))
    sphere = poses_utils.sphere_poses(8, radius=2.0, center=[0.1, 0, 0],
                                      seed=3)
    np.testing.assert_array_equal(
        sphere, jposes.sphere_poses(8, radius=2.0, center=[0.1, 0, 0],
                                    seed=3))
    out, scale = poses_utils.spherify_poses(sphere[:, :3, :4])
    j_out, j_scale = jposes.spherify_poses(sphere[:, :3, :4])
    np.testing.assert_array_equal(out, j_out)
    assert scale == j_scale
    np.testing.assert_allclose(np.linalg.norm(out[:, :3, 3], axis=1).mean(),
                               1.0, rtol=1e-4)
