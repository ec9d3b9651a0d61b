"""Baseline JPEG decoding and encoding for the dataset loaders and exporters.

The Replica and ScanNet colour frames are ``.jpg`` files, which the JAX
package reads through ``imageio`` and ``cv2`` (libjpeg-turbo) and writes
with ``cv2.imwrite(..., [IMWRITE_JPEG_QUALITY, 98])``. This package depends
on neither, so it carries its own codec, following libjpeg's arithmetic so
that a decode equals ``cv2.imread``'s:

- markers SOI, APPn/COM (skipped), DQT (8- and 16-bit tables), DHT, SOF0 and
  SOF1 (8-bit Huffman sequential), DRI and the RSTn restart markers, SOS
  (one interleaved scan, or one scan of a grey image), EOI. Progressive,
  lossless and arithmetic-coded files raise ``NotImplementedError``;
- sampling 4:4:4 and 4:2:0 (the chroma at half width and height);
- libjpeg's integer IDCT (``jidctint.c``, "islow"), its range-limit table,
  its fancy (triangle-filter) 4:2:0 chroma upsampling (``jdsample.c``
  ``h2v2_fancy_upsample``, the first and last chroma rows repeated) and its
  fixed-point YCbCr → RGB (``jdcolor.c``).

``decode_jpeg`` runs the entropy decoding, the IDCT, the upsampling and the
colour conversion in the host library ``vf_nerf_torch/csrc/jpeg.cpp``
(built with ``g++`` by ``kernels/host.py`` at first use; a failed build
raises). ``decode_jpeg_numpy`` is the same decoder in Python and numpy, the
tests' plain version of the library; its per-symbol Huffman loop makes it
~20× slower than the library on a 240×320 office frame.

``encode_jpeg`` writes a baseline JFIF file as libjpeg does by default:
the Annex K quantisation tables scaled by libjpeg's quality formula, the
Annex K Huffman tables, the fixed-point RGB → YCbCr of ``jccolor.c``, the
4:2:0 box downsampling with libjpeg's alternating bias (``jcsample.c``), the
integer forward DCT (``jfdctint.c``) and libjpeg's rounding quantiser. It is
vectorised in numpy, the Huffman bit packing included.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Tuple

import numpy as np

# Natural (row-major) index of the k-th coefficient in zigzag order.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# Annex K.1 quantisation tables, natural order.
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols).
STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
STD_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
STD_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])

# jidctint.c / jfdctint.c fixed-point constants (CONST_BITS = 13).
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172

# jdcolor.c / jccolor.c (SCALEBITS = 16).
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


class JpegError(ValueError):
    """A malformed or truncated JPEG file."""


# ============================================================== the decoder
def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by ``value & 1023``: the sample
    ``value + 128`` clamped to 0..255 for |value| < 512 (``jdmaster.c``
    ``prepare_range_limit_table``)."""
    table = np.zeros(1024, np.uint8)
    table[:128] = np.arange(128, 256)
    table[128:384] = 255
    table[896:] = np.arange(128)
    return table


_RANGE_LIMIT = _idct_range_limit()


def _idct_pass(d: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One 1-D pass of ``jpeg_idct_islow`` over the 8 inputs ``d``; the
    outputs are descaled by ``shift`` bits."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 + z3 * -F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = (d[0] + d[4]) << CONST_BITS
    tmp1 = (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """libjpeg's integer IDCT of dequantised (B, 8, 8) int64 coefficients
    (natural order) → (B, 8, 8) uint8 samples."""
    c = coefs.astype(np.int64)
    cols = _idct_pass([c[:, k, :] for k in range(8)],
                      CONST_BITS - PASS1_BITS)             # columns
    ws = np.stack(cols, axis=1)                           # (B, 8 rows, 8)
    rows = _idct_pass([ws[:, :, k] for k in range(8)],
                      CONST_BITS + PASS1_BITS + 3)         # rows
    out = np.stack(rows, axis=2)
    return _RANGE_LIMIT[out & 1023]


def upsample_h2v2_fancy(plane: np.ndarray, width: int, height: int
                        ) -> np.ndarray:
    """libjpeg's triangle-filter 2× upsampling of the (height, width)
    chroma samples (the first and last rows stand in for the rows beyond
    them; at most 2 columns wide, each sample repeated 2×2) →
    (2·height, 2·width) uint8."""
    p = plane[:height, :width].astype(np.int64)
    if width <= 2:      # libjpeg replicates (jdsample.c, jinit_upsampler)
        return np.repeat(np.repeat(p, 2, axis=0), 2, axis=1).astype(np.uint8)
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * height, 2 * width), np.int64)
    for v, near in ((0, above), (1, below)):
        col = p * 3 + near                        # column sums
        left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        even = (col * 3 + left + 8) >> 4
        odd = (col * 3 + right + 7) >> 4
        even[:, 0] = (col[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (col[:, -1] * 4 + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out.astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point YCbCr → RGB of uint8 planes → (H, W, 3)."""
    y = y.astype(np.int64)
    x_cb = cb.astype(np.int64) - 128
    x_cr = cr.astype(np.int64) - 128
    r = y + ((_fix(1.40200) * x_cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix(0.34414) * x_cb + ONE_HALF - _fix(0.71414) * x_cr)
             >> SCALEBITS)
    b = y + ((_fix(1.77200) * x_cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _huffman_lookup(counts: List[int], symbols: List[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(code length, symbol) for every 16-bit window of the stream whose
    leading bits are a code of this table; length 0 marks no code."""
    lengths = np.zeros(1 << 16, np.int64)
    values = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise JpegError("Huffman table has fewer symbols than codes")
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            if hi > 1 << 16:
                raise JpegError("bad Huffman table")
            lengths[lo:hi] = length
            values[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lengths, values


class _Frame:
    """What the markers before the scan say."""

    def __init__(self) -> None:
        self.height = self.width = 0
        self.components: List[Dict[str, int]] = []
        self.quant: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
        self.restart_interval = 0
        self.scan: List[Tuple[int, int, int]] = []   # (component, dc, ac)
        self.scan_data = b""


def _parse(data: bytes) -> _Frame:
    """Read the markers up to and including the scan's entropy-coded data
    (left with its byte stuffing and restart markers in place)."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG file (no SOI marker)")
    frame = _Frame()
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise JpegError(f"expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                  # EOI
            break
        if pos + 2 > n:
            raise JpegError("truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise JpegError("truncated marker segment")
        pos += length
        if marker in (0xC0, 0xC1):                          # SOF0 / SOF1
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(
                    f"JPEG sample precision {precision}; 8 bits only")
            frame.height, frame.width = h, w
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                frame.components.append(
                    {"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(
                f"JPEG SOF{marker - 0xC0} (progressive, lossless or "
                "arithmetic-coded) is not supported; baseline only")
        elif marker == 0xCC:
            raise NotImplementedError("arithmetic-coded JPEG is not "
                                      "supported")
        elif marker == 0xDB:                                # DQT
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                size = 64 * (pq + 1)
                raw = np.frombuffer(body[q + 1:q + 1 + size],
                                    ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = raw.astype(np.int64)
                frame.quant[tq] = table
                q += 1 + size
        elif marker == 0xC4:                                # DHT
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                counts = list(body[q + 1:q + 17])
                total = sum(counts)
                symbols = list(body[q + 17:q + 17 + total])
                frame.huff[(tc, th)] = (counts, symbols)
                q += 17 + total
        elif marker == 0xDD:                                # DRI
            (frame.restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:                                # SOS
            if not frame.components:
                raise JpegError("SOS before SOF")
            ns = body[0]
            ids = [c["id"] for c in frame.components]
            for i in range(ns):
                cid, tables = body[1 + 2 * i:3 + 2 * i]
                if cid not in ids:
                    raise JpegError(f"scan names unknown component {cid}")
                frame.scan.append((ids.index(cid), tables >> 4, tables & 15))
            if ns != len(frame.components):
                raise NotImplementedError(
                    "JPEG with one scan per component is not supported; "
                    "one interleaved scan only")
            end = pos
            while True:
                end = data.find(b"\xff", end)
                if end < 0 or end + 1 >= n:
                    end = n
                    break
                nxt = data[end + 1]
                if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    end += 1 if nxt == 0xFF else 2
                    continue
                break
            frame.scan_data = data[pos:end]
            return frame
    raise JpegError("no scan (SOS) in the file")


def _check_sampling(frame: _Frame) -> Tuple[int, int]:
    comps = frame.components
    if len(comps) not in (1, 3):
        raise NotImplementedError(f"{len(comps)} colour components; JPEG "
                                  "with 1 (grey) or 3 (YCbCr) only")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(comps) == 1:
        comps[0]["h"] = comps[0]["v"] = 1    # a grey scan is one block each
        return 1, 1
    chroma = [(c["h"], c["v"]) for c in comps[1:]]
    ok = (comps[0]["h"], comps[0]["v"]) in ((1, 1), (2, 2)) and \
        all(s == (1, 1) for s in chroma)
    if not ok:
        raise NotImplementedError(
            "JPEG sampling " + " ".join(f"{c['h']}x{c['v']}" for c in comps)
            + "; 4:4:4 and 4:2:0 only")
    return hmax, vmax


def _segments(scan_data: bytes) -> List[bytes]:
    """The entropy-coded data split at its restart markers, unstuffed."""
    out, cur, i, n = [], bytearray(), 0, len(scan_data)
    while i < n:
        b = scan_data[i]
        if b == 0xFF and i + 1 < n:
            nxt = scan_data[i + 1]
            if nxt == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:
                out.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
            if nxt == 0xFF:
                i += 1
                continue
        cur.append(b)
        i += 1
    out.append(bytes(cur))
    return out


def _decode_coefficients(frame: _Frame, hmax: int, vmax: int
                         ) -> List[np.ndarray]:
    """The Huffman decode: per component, the (blocks_y, blocks_x, 64)
    quantised coefficients in zigzag order."""
    comps = frame.components
    mcux = -(-frame.width // (8 * hmax))
    mcuy = -(-frame.height // (8 * vmax))
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64)
             for c in comps]
    tables = {}
    for key, (counts, symbols) in frame.huff.items():
        lengths, values = _huffman_lookup(counts, symbols)
        tables[key] = (lengths.tolist(), values.tolist())
    plan = []
    for ci, td, ta in frame.scan:
        if (0, td) not in tables or (1, ta) not in tables:
            raise JpegError("scan uses an undefined Huffman table")
        c = comps[ci]
        plan.append((ci, c["h"], c["v"], tables[(0, td)], tables[(1, ta)]))
    n_mcu = mcux * mcuy
    interval = frame.restart_interval or n_mcu
    segments = _segments(frame.scan_data)
    mcu = 0
    for seg in segments:
        if mcu >= n_mcu:
            break
        buf = seg + b"\x00" * 4
        bitpos = 0
        nbits = 8 * len(seg)
        pred = [0] * len(comps)

        def window(pos):
            byte = pos >> 3
            v = (buf[byte] << 16) | (buf[byte + 1] << 8) | buf[byte + 2]
            return (v >> (8 - (pos & 7))) & 0xFFFF

        for _ in range(min(interval, n_mcu - mcu)):
            my, mx = divmod(mcu, mcux)
            for ci, h, v, (dl, dv), (al, av) in plan:
                for by in range(v):
                    for bx in range(h):
                        block = coefs[ci][my * v + by, mx * h + bx]
                        w = window(bitpos)
                        length = dl[w]
                        if length == 0:
                            raise JpegError("bad Huffman code")
                        s = dv[w]
                        bitpos += length
                        diff = 0
                        if s:
                            bits = (window(bitpos) >> (16 - s)) \
                                if s <= 16 else 0
                            bitpos += s
                            diff = bits if bits >= 1 << (s - 1) \
                                else bits - (1 << s) + 1
                        pred[ci] += diff
                        block[0] = pred[ci]
                        k = 1
                        while k < 64:
                            w = window(bitpos)
                            length = al[w]
                            if length == 0:
                                raise JpegError("bad Huffman code")
                            rs = av[w]
                            bitpos += length
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break                   # EOB
                                k += 16
                                continue
                            k += r
                            bits = window(bitpos) >> (16 - s)
                            bitpos += s
                            if k < 64:
                                block[k] = bits if bits >= 1 << (s - 1) \
                                    else bits - (1 << s) + 1
                            k += 1
            mcu += 1
        if bitpos > nbits + 32:
            raise JpegError("entropy-coded data ends early")
    if mcu < n_mcu:
        raise JpegError("entropy-coded data ends early")
    return coefs


def _assemble(frame: _Frame, coefs: List[np.ndarray], hmax: int,
              vmax: int, idct) -> np.ndarray:
    """Dequantise, IDCT, upsample and convert: (H, W, C) uint8."""
    planes = []
    for c, blocks in zip(frame.components, coefs):
        if c["tq"] not in frame.quant:
            raise JpegError("component uses an undefined quantisation table")
        by, bx = blocks.shape[:2]
        natural = np.zeros((by * bx, 64), np.int64)
        natural[:, ZIGZAG] = blocks.reshape(-1, 64)
        natural *= frame.quant[c["tq"]][None, :]
        samples = idct(natural.reshape(-1, 8, 8))
        planes.append(samples.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
                      .reshape(by * 8, bx * 8))
    h, w = frame.height, frame.width
    if len(planes) == 1:
        return planes[0][:h, :w, None].copy()
    chroma = []
    for c, plane in zip(frame.components[1:], planes[1:]):
        if hmax == 2:
            cw, ch = -(-w // 2), -(-h // 2)
            plane = upsample_h2v2_fancy(plane, cw, ch)
        chroma.append(plane[:h, :w])
    return ycc_to_rgb(planes[0][:h, :w], chroma[0], chroma[1])


def decode_jpeg_numpy(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG in Python and numpy: (H, W, 3) RGB or
    (H, W, 1) grey uint8."""
    frame = _parse(bytes(data))
    hmax, vmax = _check_sampling(frame)
    coefs = _decode_coefficients(frame, hmax, vmax)
    return _assemble(frame, coefs, hmax, vmax, idct_islow)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG with the host library ``csrc/jpeg.cpp``:
    (H, W, 3) RGB or (H, W, 1) grey uint8, equal to
    ``decode_jpeg_numpy``."""
    from vf_nerf_torch.kernels.host import jpeg_library
    lib = jpeg_library()
    data = bytes(data)
    info = (ctypes.c_int32 * 3)()
    code = lib.vfn_jpeg_info(data, len(data), info)
    if code != 0:
        _raise(lib, code)
    h, w, c = info[0], info[1], info[2]
    out = np.empty((h, w, c), np.uint8)
    code = lib.vfn_jpeg_decode(data, len(data), out.ctypes.data, out.size)
    if code != 0:
        _raise(lib, code)
    return out


def _raise(lib, code: int) -> None:
    message = lib.vfn_jpeg_error(code).decode()
    if code == -2:
        raise NotImplementedError(message)
    raise JpegError(message)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file decoded by ``decode_jpeg``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


# ============================================================== the encoder
def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality``: the Annex K tables scaled by
    ``5000 / q`` below 50 and ``200 − 2q`` from 50, clamped to 1..255
    (baseline), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMA_QUANT, STD_CHROMA_QUANT))


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """``jccolor.c``'s fixed-point RGB → YCbCr of (H, W, 3) uint8 →
    (3, H, W) int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    offset = 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b +
         ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b +
          offset + ONE_HALF - 1) >> SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b +
          offset + ONE_HALF - 1) >> SCALEBITS
    return np.stack([y, cb, cr])


def _pad_plane(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """Edge replication to (height, width), as libjpeg pads its input."""
    h, w = plane.shape
    return np.pad(plane, ((0, height - h), (0, width - w)), mode="edge")


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """``jcsample.c`` ``h2v2_downsample``: 2×2 sums plus a bias of 1, 2, 1,
    2, ... along each output row, shifted right by 2."""
    s = (plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] +
         plane[1::2, 1::2])
    bias = np.tile(np.array([1, 2], np.int64), s.shape[1] // 2 + 1)
    return (s + bias[None, :s.shape[1]]) >> 2


def _fdct_pass(d: List[np.ndarray], even_shift: int, odd_shift: int,
               first: bool) -> List[np.ndarray]:
    """One 1-D pass of ``jpeg_fdct_islow``."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F0541
    out[2] = _descale(z1 + tmp13 * F0765, even_shift)
    out[6] = _descale(z1 + tmp12 * -F1847, even_shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5 = tmp4 * F0298, tmp5 * F2053
    tmp6, tmp7 = tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[1] = _descale(tmp7 + z1 + z4, odd_shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's integer forward DCT of (B, 8, 8) level-shifted samples →
    (B, 8, 8) coefficients scaled up by 8 (natural order)."""
    b = blocks.astype(np.int64)
    rows = _fdct_pass([b[:, :, k] for k in range(8)],
                      CONST_BITS - PASS1_BITS, CONST_BITS - PASS1_BITS, True)
    ws = np.stack(rows, axis=2)
    cols = _fdct_pass([ws[:, k, :] for k in range(8)],
                      CONST_BITS + PASS1_BITS, CONST_BITS + PASS1_BITS, False)
    return np.stack(cols, axis=1)


def quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """libjpeg's quantiser: |c| plus half the divisor, divided, sign kept
    (the divisor is the table entry × 8, the DCT's scale)."""
    q = (table.astype(np.int64) << 3).reshape(1, 8, 8)
    mag = (np.abs(coefs) + (q >> 1)) // q
    return np.where(coefs < 0, -mag, mag)


def _huffman_codes(counts: List[int], symbols: List[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a Huffman table."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = code
            lengths[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _magnitude(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, the appended bits) of signed coefficients."""
    mag = np.abs(values)
    size = np.zeros(values.shape, np.int64)
    nz = mag > 0
    size[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    bits = np.where(values < 0, values + (1 << size) - 1, values)
    return size, bits & ((1 << size) - 1)


def _block_symbols(zz: np.ndarray, dc_diff: np.ndarray, dc_tab, ac_tab):
    """The (code value, bit count) pairs of each block, in stream order:
    per block the DC category code and its bits, then for each nonzero AC
    coefficient the ZRL codes of its long runs, its run/size code and its
    bits, then EOB unless the last coefficient is nonzero. Returns
    (values, counts, block index) flat arrays."""
    n_blocks = zz.shape[0]
    vals, cnts, owner, order = [], [], [], []
    # DC: category code + bits.
    size, bits = _magnitude(dc_diff)
    dcode, dlen = dc_tab
    vals.append((dcode[size] << size) | bits)
    cnts.append(dlen[size] + size)
    owner.append(np.arange(n_blocks))
    order.append(np.zeros(n_blocks, np.int64))
    # AC: nonzero coefficients with their zero runs.
    acode, alen = ac_tab
    ac = zz[:, 1:]
    b_idx, k_idx = np.nonzero(ac)
    k_idx = k_idx + 1
    prev = np.zeros_like(k_idx)
    if len(k_idx):
        same = np.concatenate([[False], b_idx[1:] == b_idx[:-1]])
        prev[same] = k_idx[:-1][same[1:]]
    run = k_idx - prev - 1
    n_zrl = run // 16
    run = run % 16
    size, bits = _magnitude(ac[b_idx, k_idx - 1])
    sym = (run << 4) | size
    # ZRL codes (0xF0) before a coefficient: one entry of n·len bits each.
    zrl_code, zrl_len = acode[0xF0], alen[0xF0]
    has_zrl = n_zrl > 0
    if has_zrl.any():
        reps = n_zrl[has_zrl]
        zval = np.zeros(len(reps), np.int64)
        for r in range(1, int(reps.max()) + 1):   # at most 3 ZRLs
            zval = np.where(reps >= r, (zval << zrl_len) | zrl_code, zval)
        vals.append(zval)
        cnts.append(reps * zrl_len)
        owner.append(b_idx[has_zrl])
        order.append(2 * k_idx[has_zrl] - 1)
    vals.append((acode[sym] << size) | bits)
    cnts.append(alen[sym] + size)
    owner.append(b_idx)
    order.append(2 * k_idx)
    # EOB where the block's last coefficient is zero.
    eob = zz[:, 63] == 0
    vals.append(np.full(int(eob.sum()), acode[0x00], np.int64))
    cnts.append(np.full(int(eob.sum()), alen[0x00], np.int64))
    owner.append(np.nonzero(eob)[0])
    order.append(np.full(int(eob.sum()), 200, np.int64))
    vals, cnts = np.concatenate(vals), np.concatenate(cnts)
    owner, order = np.concatenate(owner), np.concatenate(order)
    sort = np.lexsort((order, owner))
    return vals[sort], cnts[sort], owner[sort]


def _pack_bits(values: np.ndarray, counts: np.ndarray) -> bytes:
    """Concatenate the low ``counts`` bits of each value (MSB first), pad
    the last byte with ones and stuff a zero byte after each 0xFF."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    starts = ends - counts
    bit_owner = np.repeat(np.arange(len(values)), counts)
    pos = np.arange(total) - starts[bit_owner]
    shift = counts[bit_owner] - 1 - pos
    bits = ((values[bit_owner] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    raw = np.packbits(bits)
    ff = np.nonzero(raw == 0xFF)[0]
    return np.insert(raw, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dummy_luma_blocks(blocks: np.ndarray, rows: int, cols: int) -> None:
    """libjpeg's dummy blocks (``jccoefct.c``), in place: the 2×2-block
    MCUs' blocks beyond the image's ``rows`` × ``cols`` blocks carry no AC
    and a copied DC, a right-edge block its left neighbour's and a
    bottom-row block that of the MCU's top-right block."""
    if cols < blocks.shape[1]:
        blocks[:, cols:] = 0
        blocks[:, cols:, 0] = blocks[:, cols - 1, 0][:, None]
    if rows < blocks.shape[0]:
        blocks[rows:] = 0
        blocks[rows:, :, 0] = np.repeat(blocks[rows - 1, 1::2, 0], 2)[None]


def encode_jpeg(rgb: np.ndarray, quality: int = 98) -> bytes:
    """A baseline JFIF file of (H, W, 3) RGB uint8, 4:2:0 sampled, in
    libjpeg's default arithmetic at ``quality``."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"image size {h}×{w} out of JPEG's range")
    q_luma, q_chroma = quality_tables(quality)
    ycc = rgb_to_ycc(rgb)
    mcux, mcuy = -(-w // 16), -(-h // 16)
    # libjpeg's edge handling: rows are repeated to the MCU height; luma
    # columns to whole blocks, chroma columns (before the downsampling) to
    # the MCU width; the downsampler takes rows in pairs and its output
    # rows are repeated to the MCU height.
    luma = _pad_plane(ycc[0], 16 * mcuy, 16 * mcux)
    chroma = [_pad_plane(downsample_h2v2(_pad_plane(
        p, 2 * (-(-h // 2)), 16 * mcux)), 8 * mcuy, 8 * mcux)
        for p in ycc[1:]]

    def blocks(plane, table):
        ph, pw = plane.shape
        b = (plane - 128).reshape(ph // 8, 8, pw // 8, 8).transpose(
            0, 2, 1, 3)
        return quantize(fdct_islow(b.reshape(-1, 8, 8)), table).reshape(
            ph // 8, pw // 8, 64)[..., ZIGZAG]

    y_blocks = blocks(luma, q_luma)                   # (2·mcuy, 2·mcux, 64)
    _dummy_luma_blocks(y_blocks, -(-h // 8), -(-w // 8))
    y_blocks = y_blocks.reshape(mcuy, 2, mcux, 2, 64).transpose(
        0, 2, 1, 3, 4)                                # MCU order
    zz = [y_blocks.reshape(-1, 64), blocks(chroma[0], q_chroma).reshape(
        -1, 64), blocks(chroma[1], q_chroma).reshape(-1, 64)]
    n_mcu = mcux * mcuy
    tabs = [(_huffman_codes(*STD_DC_LUMA), _huffman_codes(*STD_AC_LUMA)),
            (_huffman_codes(*STD_DC_CHROMA), _huffman_codes(*STD_AC_CHROMA))]
    # Stream order: per MCU, 4 luma blocks, then Cb, then Cr.
    per_comp = []
    for ci, z in enumerate(zz):
        dc = z[:, 0]
        diff = np.diff(np.concatenate([[0], dc]))
        v, c, owner = _block_symbols(z, diff, *tabs[min(ci, 1)])
        n_per = 4 if ci == 0 else 1
        mcu = owner // n_per
        slot = (owner % n_per) + (0 if ci == 0 else 3 + ci)
        per_comp.append((v, c, mcu, slot))
    v = np.concatenate([p[0] for p in per_comp])
    c = np.concatenate([p[1] for p in per_comp])
    mcu = np.concatenate([p[2] for p in per_comp])
    slot = np.concatenate([p[3] for p in per_comp])
    order = np.lexsort((np.arange(len(v)), slot, mcu))   # stable per block
    assert int(mcu.max()) + 1 == n_mcu
    scan = _pack_bits(v[order], c[order])

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in enumerate((q_luma, q_chroma)):
        out.append(_segment(0xDB, bytes([tq]) +
                            table[ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) +
                        bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (tc, th), (counts, symbols) in (
            ((0, 0), STD_DC_LUMA), ((1, 0), STD_AC_LUMA),
            ((0, 1), STD_DC_CHROMA), ((1, 1), STD_AC_CHROMA)):
        out.append(_segment(0xC4, bytes([(tc << 4) | th]) + bytes(counts) +
                            bytes(symbols)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                     0])))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 98) -> None:
    """``encode_jpeg`` of ``rgb`` written to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))
