"""The port's image evaluation against the JAX package's, on the CPU.

- ``get_psnr`` / ``get_ssim`` / ``get_l1_cm`` equal JAX's on seeded images.
- The port's PNG writer and reader round-trip exactly; they read what
  JAX's ``io.save_rgb`` (imageio) writes, and rows under each of the five
  PNG filters.
- ``evaluate(..., "render-images")`` then ``"metrics"`` on a tiny checkpoint
  of the port's runner write the JAX package's artifact tree, with the eval
  flags set as JAX sets them (perturb off, back-face threshold −0.2, the
  fine count grown again from the checkpoint's epoch), and the PSNRs in
  ``metrics.json`` are JAX's ``get_psnr`` on the written files; without
  ``matplotlib`` the plot methods and ``all`` raise its ``ImportError``.
- ``get_vector_field`` equals JAX's from the same weights (rtol 1e-5).
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from test_torch_render import port_config
from test_torch_runner import write_conf
from test_torch_train_step import tiny_variables
from vf_nerf_tpu.models.nerf import VectorFieldNerf as JVectorFieldNerf
from vf_nerf_tpu.utils import io as jio
from vf_nerf_tpu.utils import metrics as jmetrics
from vf_nerf_torch.config import parse_config
from vf_nerf_torch.datasets import dataset_dict
from vf_nerf_torch.evaluation import evaluate as evaluate_mod
from vf_nerf_torch.evaluation import methods
from vf_nerf_torch.models.nerf import VectorFieldNerf
from vf_nerf_torch.train.runner import VectorFieldNerfRunner
from vf_nerf_torch.utils import io, metrics
from vf_nerf_torch.utils.weights import load_jax_variables


def _images(seed, shape=(24, 31, 3)):
    rng = np.random.RandomState(seed)
    target = rng.rand(*shape).astype(np.float32)
    noisy = np.clip(target + 0.1 * rng.randn(*shape), 0, 1).astype(
        np.float32)
    return noisy, target


@pytest.mark.parametrize("seed", [0, 1])
def test_image_metrics_equal_jax(seed):
    pred, target = _images(seed)
    assert metrics.get_psnr(pred, target) == jmetrics.get_psnr(pred, target)
    assert metrics.get_ssim(pred, target) == jmetrics.get_ssim(pred, target)
    assert metrics.get_l1_cm(pred[..., 0], target[..., 0]) == \
        jmetrics.get_l1_cm(pred[..., 0], target[..., 0])
    assert metrics.get_psnr(target, target) == float("inf")


def _filtered_png(path, pixels, filters):
    """An 8-bit RGB PNG whose row ``y`` uses PNG filter ``filters[y]``."""
    h, w, c = pixels.shape
    rows = pixels.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        corner = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        kind = filters[y]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - corner
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, corner))
        raw.append(kind)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" +
                chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


def test_png_round_trip_and_jax_files(tmp_path):
    image, _ = _images(2, (17, 23, 3))
    ours = str(tmp_path / "ours.png")
    io.save_rgb(ours, image)
    expected = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(io.read_png(ours), expected)
    np.testing.assert_array_equal(io.load_rgb(ours, transpose=False),
                                  jio.load_rgb(ours, transpose=False))
    theirs = str(tmp_path / "jax.png")
    jio.save_rgb(theirs, image)
    np.testing.assert_array_equal(io.read_png(theirs), expected)
    np.testing.assert_array_equal(io.load_rgb(theirs),
                                  jio.load_rgb(theirs))
    filtered = str(tmp_path / "filtered.png")
    _filtered_png(filtered, expected, [y % 5 for y in range(17)])
    np.testing.assert_array_equal(io.read_png(filtered), expected)
    np.testing.assert_array_equal(io.read_png(filtered),
                                  jio.load_rgb(filtered, transpose=False)
                                  .__mul__(255).round().astype(np.uint8))
    depth = np.random.RandomState(3).uniform(0.5, 3.0, (9, 11))
    io.save_depth(str(tmp_path / "depth-0"), depth)
    np.testing.assert_array_equal(np.load(tmp_path / "depth-0.npy"),
                                  depth.astype(np.float32))
    grey = io.read_png(str(tmp_path / "depth-0.png"))[..., 0]
    np.testing.assert_array_equal(
        grey, (depth / depth.max() * 255).astype(np.float32).astype(
            np.uint8))


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A 2-epoch run of the port's runner on the tiny synthetic conf."""
    root = str(tmp_path_factory.mktemp("eval"))
    conf = write_conf(root)
    cfg = parse_config(scene="box", config_path=conf, expname="e",
                       timestamp="run", gpu="cpu", offline=True)
    cfg.num_epochs = 2
    VectorFieldNerfRunner(cfg).train()
    return root, conf


def test_evaluate_writes_the_jax_tree(trained_run, monkeypatch):
    root, conf = trained_run
    seen = {}
    render_images = methods.render_images

    def recording(model, *args, **kwargs):
        seen.update(fine=model.fine_n_samples,
                    perturb=model.config.ray_sampler_config.perturb,
                    th=model.config.dir_to_normal_th,
                    device=model.device.type)
        return render_images(model, *args, **kwargs)

    monkeypatch.setattr(methods, "render_images", recording)
    evals = os.path.join(root, "evals")
    for method in ("render-images", "metrics"):
        cfg = parse_config(scene="box", config_path=conf, expname="e",
                           timestamp="run", checkpoint="latest", gpu="cpu")
        folder = evaluate_mod.evaluate(cfg, method, 32, evals, 512, 0.05, 8)
    assert folder == os.path.join(evals, "e_box", "run_latest")
    # The checkpoint holds epoch 1 and the fine count after growth at epoch
    # 0 (4 + 5); eval grows it by 5 · (2 // 2) again.
    assert seen == dict(fine=14, perturb=False, th=-0.2, device="cpu")
    dataset = dataset_dict["synthetic"](cfg.dataset_config)
    n = len(dataset)
    files = sorted(os.listdir(os.path.join(folder, "rendered_images")))
    assert files == sorted([f"image-{i}.png" for i in range(n)] +
                           [f"depth-{i}.npy" for i in range(n)] +
                           [f"depth-{i}.png" for i in range(n)])
    with open(os.path.join(folder, "metrics.json")) as f:
        scores = json.load(f)
    assert set(scores) == {f"image-{i}" for i in range(n)} | {"mean_psnr"}
    h, w = dataset.image_size
    psnrs = []
    for i in range(n):
        image = jio.load_rgb(os.path.join(folder, "rendered_images",
                                          f"image-{i}.png"), transpose=False)
        psnrs.append(jmetrics.get_psnr(image,
                                       dataset.rgb_images[i].reshape(h, w,
                                                                     3)))
        assert scores[f"image-{i}"]["psnr"] == psnrs[-1]
        depth = np.load(os.path.join(folder, "rendered_images",
                                     f"depth-{i}.npy"))
        assert depth.shape == (h, w) and np.isfinite(depth).all()
    assert scores["mean_psnr"] == pytest.approx(float(np.mean(psnrs)),
                                                rel=1e-12)
    # Without matplotlib (the card's machine) the plot methods, and "all"
    # when it reaches them, raise its ImportError.
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for method in ("plot-2d-slices", "all"):
        with pytest.raises(ImportError, match="matplotlib"):
            evaluate_mod.evaluate(cfg, method, 32, evals, 512, 0.05, 8)


def test_get_vector_field_equals_jax():
    jcfg = graft._tiny_config()
    _, variables = tiny_variables(jcfg, seed=2)
    jmodel = JVectorFieldNerf(jcfg)
    jmodel.state = jmodel.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    model = VectorFieldNerf(port_config(jcfg), device="cpu")
    load_jax_variables(model, variables)
    pts = np.random.RandomState(5).uniform(-2, 2, (1000, 3)).astype(
        np.float32)
    ours = model.get_vector_field(pts, chunk=300)
    ref = np.asarray(jax.device_get(jmodel.get_vector_field(pts)))
    assert ours.shape == (1000, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
