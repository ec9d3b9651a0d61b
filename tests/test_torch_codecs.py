"""The port's image codecs against ``cv2`` (libjpeg-turbo, libpng), on the
CPU: 16-bit depth PNGs, the baseline JPEG decoder (the host library
``vf_nerf_torch/csrc/jpeg.cpp`` and its plain numpy version), the JPEG
encoder and the bilinear resize of the ScanNet loader.

Tolerances, measured:

- 16-bit PNGs: exact both ways;
- the decoder on the JPEGs the JAX exporters write (``cv2.imwrite`` at
  quality 98, 4:2:0) of the box and the office scenes: bit for bit, 0
  differing samples; on generated files (4:4:4 and 4:2:0, odd sizes,
  qualities 50 to 100, restart markers, grey): bit for bit; the C++ decoder
  equals the numpy one on every file;
- the encoder: byte for byte the file ``cv2.imwrite(..., quality 98)``
  writes, so ``cv2`` reads it with exactly the error of its own quality-98
  round trip (max |Δ| 1 to 20 levels on the test's smoothed-noise images,
  17 and 30 (mean 3.0 and 1.0) on the first box (12×16) and office
  (48×64) frames);
- ``resize_bilinear`` against ``cv2.resize``: within 1e-9 (measured
  2.7e-14 at ScanNet's 968×1296 → 480×640).
"""

import os

import cv2
import numpy as np
import pytest

from vf_nerf_torch.utils import io as io_utils
from vf_nerf_torch.utils import jpeg
from vf_nerf_tpu.datasets.synthetic import (SyntheticBoxDataset,
                                            SyntheticOfficeDataset)
from vf_nerf_tpu.utils import io as jio


def _rgb(img_bgr):
    return cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)


def _cv2_jpeg(rgb, quality=98, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              extra=()):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
                            *extra])
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    return _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def _smooth_noise(shape, seed):
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5) if min(shape[:2]) > 4 else img


@pytest.mark.parametrize("shape", [(5, 7), (48, 64), (480, 640)])
def test_png16_written_by_cv2_reads_exactly(shape, tmp_path):
    depth = np.random.RandomState(0).randint(0, 65536, shape).astype(
        np.uint16)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, depth)
    np.testing.assert_array_equal(io_utils.read_png(path)[..., 0], depth)
    got = io_utils.load_depth(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.load_depth(path))


@pytest.mark.parametrize("shape", [(5, 7), (48, 64)])
def test_png16_written_by_the_port_reads_back_in_cv2(shape, tmp_path):
    depth = np.random.RandomState(1).randint(0, 65536, shape).astype(
        np.uint16)
    path = str(tmp_path / "d.png")
    io_utils.write_png(path, depth)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  depth)
    with pytest.raises(FileNotFoundError):
        io_utils.load_depth(str(tmp_path / "missing.png"))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX exporters' Replica files of the box and the office."""
    root = tmp_path_factory.mktemp("codecs")
    SyntheticBoxDataset(n_images=2, image_size=(12, 16)).export_replica_format(
        str(root / "box"), scene="boxroom")
    SyntheticOfficeDataset(n_images=2, image_size=(48, 64)
                           ).export_replica_format(str(root / "office"),
                                                   scene="office")
    return {"box": root / "box" / "Replica" / "boxroom" / "results",
            "office": root / "office" / "Replica" / "office" / "results"}


@pytest.mark.parametrize("scene", ["box", "office"])
def test_decoder_equals_cv2_on_the_jax_exporters_frames(scene, exported):
    frames = sorted(exported[scene].glob("frame*.jpg"))
    assert len(frames) == 2
    for path in frames:
        ref = _rgb(cv2.imread(str(path)))
        data = path.read_bytes()
        got = jpeg.decode_jpeg(data)
        assert got.shape == ref.shape
        assert int(np.count_nonzero(got != ref)) == 0
        np.testing.assert_array_equal(jpeg.decode_jpeg_numpy(data), got)
        # ... and so the port's load_rgb equals the JAX package's (imageio).
        np.testing.assert_array_equal(io_utils.load_rgb(str(path)),
                                      jio.load_rgb(str(path)))


_FILES = [  # (shape, quality, sampling, restart interval)
    ((1, 1, 3), 98, "420", 0), ((2, 3, 3), 90, "420", 0),
    ((9, 17, 3), 100, "420", 0), ((31, 47, 3), 50, "420", 2),
    ((31, 47, 3), 98, "444", 0), ((40, 24, 3), 75, "444", 3),
    ((33, 47), 90, "grey", 0)]


@pytest.mark.parametrize("shape,quality,sampling,restart", _FILES)
def test_decoders_equal_cv2_and_each_other(shape, quality, sampling,
                                           restart):
    img = _smooth_noise(shape, sum(shape))
    if sampling == "grey":
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                             quality])
        data, ref = buf.tobytes(), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        ref = ref[..., None]
    else:
        factor = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                  "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]
        extra = (cv2.IMWRITE_JPEG_RST_INTERVAL, restart) if restart else ()
        data = _cv2_jpeg(img, quality, factor, extra)
        ref = _cv2_decode(data)
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(jpeg.decode_jpeg_numpy(data), got)


def test_unsupported_and_broken_jpegs_raise():
    img = _smooth_noise((24, 32, 3), 3)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    for decode in (jpeg.decode_jpeg, jpeg.decode_jpeg_numpy):
        with pytest.raises(NotImplementedError, match="progressive"):
            decode(buf.tobytes())
        with pytest.raises(jpeg.JpegError):
            decode(b"not a jpeg")
        with pytest.raises(jpeg.JpegError):
            decode(_cv2_jpeg(img)[:300])


@pytest.mark.parametrize("shape", [(12, 16), (1, 1), (7, 9), (17, 33),
                                   (40, 7), (65, 130)])
def test_encoder_writes_cv2s_quality_98_file(shape):
    """The encoder's file is byte for byte ``cv2``'s, so ``cv2`` reads it
    with exactly the error of ``cv2``'s own quality-98 round trip."""
    img = _smooth_noise(shape + (3,), shape[0] * 100 + shape[1])
    ours = jpeg.encode_jpeg(img, 98)
    assert ours == _cv2_jpeg(img, 98)
    decoded = _cv2_decode(ours)
    np.testing.assert_array_equal(decoded, jpeg.decode_jpeg(ours))
    err = np.abs(decoded.astype(int) - img).max()
    assert err == np.abs(_cv2_decode(_cv2_jpeg(img)).astype(int) - img).max()


def test_encoder_quality_tables_follow_libjpeg():
    luma, chroma = jpeg.quality_tables(98)
    assert luma[0] == 1 and chroma[-1] == 4          # (16·4+50)//100, 99·4
    luma50, _ = jpeg.quality_tables(50)
    np.testing.assert_array_equal(luma50, jpeg.STD_LUMA_QUANT)
    img = _smooth_noise((24, 40, 3), 8)
    for quality in (50, 90):
        assert jpeg.encode_jpeg(img, quality) == _cv2_jpeg(img, quality)


_RESIZES = [(968, 1296, 480, 640), (10, 12, 7, 5), (10, 12, 25, 31),
            (40, 30, 20, 15), (33, 17, 64, 9), (6, 8, 6, 8)]


@pytest.mark.parametrize("h,w,out_h,out_w", _RESIZES)
def test_resize_bilinear_equals_cv2(h, w, out_h, out_w):
    rng = np.random.RandomState(h + w)
    for img in (rng.rand(h, w), rng.rand(h, w, 3)):
        ref = cv2.resize(img, (out_w, out_h))
        got = io_utils.resize_bilinear(img, out_h, out_w)
        assert got.shape == ref.shape and got.dtype == np.float64
        assert np.abs(got - ref).max() <= 1e-9


def test_load_rgb_reads_png_and_jpeg(tmp_path):
    img = _smooth_noise((9, 11, 3), 4)
    io_utils.write_png(str(tmp_path / "a.png"), img)
    jpeg.write_jpeg(str(tmp_path / "a.jpg"), img)
    for name in ("a.png", "a.jpg"):
        path = str(tmp_path / name)
        got = io_utils.load_rgb(path)
        assert got.shape == (3, 9, 11) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jio.load_rgb(path))
    assert os.path.getsize(tmp_path / "a.jpg") > 0
