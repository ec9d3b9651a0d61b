"""Image, depth and JSON files (port of ``vf_nerf_tpu/utils/io.py:19-98``;
reference ``utils/utils.py:73-150``).

The JAX package reads and writes images through ``imageio`` and ``cv2`` and
plots depth with ``matplotlib``; none is a dependency of this package, so
PNG files are written and read here with ``zlib`` and ``struct``, and JPEG
files with ``utils/jpeg.py``:

- ``write_png`` writes 8-bit grey or RGB and 16-bit grey PNGs (every row
  filter type 0), the pixels ``imageio`` or ``cv2`` would write for the same
  array; ``read_png`` reads 8- and 16-bit grey, grey + alpha, RGB and RGBA
  PNGs with any of the five row filters (16-bit samples are big-endian and
  the filters work on bytes, 2 per sample);
- ``load_rgb`` reads PNG and JPEG frames as float32 RGB in [0, 1];
  ``load_depth`` reads a depth PNG's raw values as float32, as
  ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does;
- ``resize_bilinear`` is ``cv2.resize``'s ``INTER_LINEAR`` on a float64
  image (the ScanNet loader's colour-to-depth resize);
- ``save_depth`` writes ``<path>.npy`` and a ``<path>.png`` that is an 8-bit
  grey map of depth / max(depth), where the JAX package draws a plasma
  colour map with a colour bar (``ROADMAP.md`` §C).
"""

from __future__ import annotations

import datetime
import json
import os
import struct
import zlib
from typing import Any

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type → samples per pixel


def mkdir_ifnotexists(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)


def get_timestamp() -> str:
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")


def write_json(path: str, payload: Any) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, pixels: np.ndarray) -> None:
    """An (H, W) grey or (H, W, 3) RGB uint8 array as an 8-bit PNG, or an
    (H, W) uint16 array as a 16-bit grey PNG."""
    pixels = np.ascontiguousarray(pixels)
    grey16 = pixels.dtype == np.uint16 and pixels.ndim == 2
    rgb8 = pixels.dtype == np.uint8 and (
        pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3))
    if not (grey16 or rgb8):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8 or "
                         f"(H, W) uint16, not {pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    colour_type = 0 if pixels.ndim == 2 else 2
    rows = pixels.astype(">u2").view(np.uint8).reshape(h, -1) if grey16 \
        else pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 16 if grey16 else 8, colour_type,
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header) +
                _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) +
                _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one row's PNG filter (``bpp`` bytes per pixel)."""
    if kind == 0:
        return row
    if kind == 2:                                     # Up
        return (row.astype(np.uint16) + prev).astype(np.uint8)
    if kind == 1:                                     # Sub: running sum
        out = row.reshape(-1, bpp).astype(np.uint64).cumsum(axis=0)
        return (out % 256).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:                                 # Average
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
        elif kind == 4:                               # Paeth
            corner = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], corner)) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8- or 16-bit PNG as (H, W, C) uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour_type, _, _, interlace = header
    if depth not in (8, 16) or colour_type not in _CHANNELS or \
            interlace != 0:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, colour type {colour_type}, interlace "
            f"{interlace}; read_png takes 8- and 16-bit non-interlaced grey, "
            "grey + alpha, RGB and RGBA")
    channels = _CHANNELS[colour_type]
    bpp = channels * depth // 8          # the filters' bytes per pixel
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, channels)
    return out.reshape(h, w, channels)


def read_image(path: str) -> np.ndarray:
    """A PNG (``read_png``) or, by its ``.jpg``/``.jpeg`` name, a JPEG
    (``utils/jpeg.py::read_jpeg``) as (H, W, C) uint8 or uint16."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        from vf_nerf_torch.utils.jpeg import read_jpeg
        return read_jpeg(path)
    return read_png(path)


def load_rgb(path: str, transpose: bool = True) -> np.ndarray:
    """float32 RGB in [0, 1] of a PNG or JPEG frame (16-bit samples over
    65535), (3, H, W) when ``transpose``, else (H, W, 3)."""
    img = read_image(path)
    img = img.astype(np.float32) / (65535.0 if img.dtype == np.uint16
                                    else 255.0)
    if img.shape[2] < 3:
        img = np.repeat(img[..., :1], 3, axis=2)
    img = img[..., :3]
    if transpose:
        img = img.transpose(2, 0, 1)
    return img


def load_depth(path: str) -> np.ndarray:
    """A depth PNG's raw values as (H, W) float32 (callers divide by the
    dataset's depth scale); ``cv2.IMREAD_UNCHANGED`` semantics."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    return (img[..., 0] if img.shape[2] == 1 else img).astype(np.float32)


def resize_bilinear(image: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
    """``cv2.resize(image, (width, height))`` (``INTER_LINEAR``) of an
    (H, W) or (H, W, C) float64 image: half-pixel centres, the row pass then
    the column pass, in float64. Source columns are clamped to the border
    with their weight moved onto the clamped pixel; source rows are clamped
    and keep their weights, as OpenCV fetches them."""
    src = np.asarray(image, np.float64)
    h, w = src.shape[:2]
    if (h, w) == (height, width):
        return src.copy()
    extra = (1,) * (src.ndim - 2)

    pos = (np.arange(width) + 0.5) * (w / width) - 0.5
    x0 = np.floor(pos).astype(np.int64)
    fx = pos - x0
    fx[(x0 < 0) | (x0 >= w - 1)] = 0.0
    x0 = np.clip(x0, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    rows = src[:, x0] * (1.0 - fx).reshape((1, -1) + extra) + \
        src[:, x1] * fx.reshape((1, -1) + extra)

    pos = (np.arange(height) + 0.5) * (h / height) - 0.5
    y0 = np.floor(pos).astype(np.int64)
    fy = pos - y0
    return rows[np.clip(y0, 0, h - 1)] * (1.0 - fy).reshape((-1, 1) + extra) \
        + rows[np.clip(y0 + 1, 0, h - 1)] * fy.reshape((-1, 1) + extra)


def save_rgb(path: str, image: np.ndarray) -> None:
    write_png(path, (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))


def save_depth(path: str, depth: np.ndarray) -> None:
    """``<path>.npy`` (the depth as it is) and ``<path>.png`` (8-bit grey,
    depth / max(depth))."""
    depth = np.asarray(depth, np.float32)
    np.save(path, depth)
    top = float(depth.max()) if depth.size else 0.0
    grey = depth / top if top > 0 else np.zeros_like(depth)
    write_png(path + ".png",
              (np.clip(grey, 0.0, 1.0) * 255).astype(np.uint8))
