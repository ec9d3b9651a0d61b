"""Image, depth and JSON files (port of ``vf_nerf_tpu/utils/io.py:19-98``;
reference ``utils/utils.py:73-150``).

The JAX package writes images through ``imageio`` and plots depth with
``matplotlib``; neither is a dependency of this package, so PNG files are
written and read here with ``zlib`` and ``struct``:

- ``save_rgb`` writes an 8-bit RGB PNG (every row filter type 0), the pixels
  ``imageio`` would write for the same array;
- ``load_rgb`` reads 8-bit grey, grey + alpha, RGB and RGBA PNGs with any of
  the five row filters, so it reads what ``imageio`` (Pillow) writes;
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
    """An (H, W) grey or (H, W, 3) RGB uint8 array as an 8-bit PNG."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or \
            (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, not "
                         f"{pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    colour_type = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
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
    """An 8-bit, non-interlaced PNG as uint8 (H, W, C)."""
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
    if depth != 8 or colour_type not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, colour type {colour_type}, interlace "
            f"{interlace}; read_png takes 8-bit non-interlaced grey, grey + "
            "alpha, RGB and RGBA")
    channels = _CHANNELS[colour_type]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev,
                                      channels)
    return out.reshape(h, w, channels)


def load_rgb(path: str, transpose: bool = True) -> np.ndarray:
    """float32 RGB in [0, 1], (3, H, W) when ``transpose``, else
    (H, W, 3)."""
    img = read_png(path).astype(np.float32) / 255.0
    if img.shape[2] < 3:
        img = np.repeat(img[..., :1], 3, axis=2)
    img = img[..., :3]
    if transpose:
        img = img.transpose(2, 0, 1)
    return img


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
