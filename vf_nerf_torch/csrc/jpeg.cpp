// Baseline JPEG decoder for the dataset loaders (vf_nerf_torch/utils/jpeg.py).
//
// The same decoder as utils/jpeg.py::decode_jpeg_numpy, in C++ for speed:
// markers SOI, APPn/COM, DQT, DHT, SOF0/SOF1 (8-bit Huffman sequential),
// DRI and RSTn, one interleaved SOS (or the one scan of a grey image), EOI;
// 4:4:4 and 4:2:0 sampling; libjpeg's integer IDCT (jidctint.c "islow")
// with its range-limit table, its fancy 4:2:0 chroma upsampling (jdsample.c
// h2v2_fancy_upsample) and its fixed-point YCbCr -> RGB (jdcolor.c), so a
// decode equals libjpeg's (cv2.imread's) sample for sample.
//
// C interface, loaded with ctypes:
//   vfn_jpeg_info(data, size, info[3])  -> 0, info = {height, width, channels}
//   vfn_jpeg_decode(data, size, out, out_size) -> 0, out = (H, W, C) uint8
//   vfn_jpeg_error(code) -> the message of the calling thread's last error
// Codes: -1 malformed or truncated file, -2 a JPEG feature not supported
// (progressive, lossless, arithmetic coding, other sampling), -3 an output
// buffer of the wrong size.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Fail {
  int code;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  g_error = msg;
  throw Fail{code};
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  // Indexed by the next 16 bits of the stream: code length (0: no code)
  // and symbol.
  std::vector<uint8_t> length, symbol;
};

struct Component {
  int id, h, v, tq;
  int dc_table = 0, ac_table = 0;
  int blocks_x = 0, blocks_y = 0;
  std::vector<int16_t> coefs;  // (blocks_y, blocks_x, 64), zigzag order
};

struct Frame {
  int height = 0, width = 0;
  std::vector<Component> comps;
  int32_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman huff[2][4];
  int restart_interval = 0;
  std::vector<int> scan;  // component index per scan slot
  const uint8_t* scan_data = nullptr;
  int64_t scan_size = 0;
  int hmax = 1, vmax = 1;
};

void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* syms,
                   int n_syms) {
  t.length.assign(1 << 16, 0);
  t.symbol.assign(1 << 16, 0);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i) {
      if (k >= n_syms) fail(-1, "Huffman table has fewer symbols than codes");
      int64_t lo = int64_t(code) << (16 - len);
      int64_t hi = int64_t(code + 1) << (16 - len);
      if (hi > (1 << 16)) fail(-1, "bad Huffman table");
      for (int64_t w = lo; w < hi; ++w) {
        t.length[w] = uint8_t(len);
        t.symbol[w] = syms[k];
      }
      ++code;
      ++k;
    }
    code <<= 1;
  }
  t.defined = true;
}

uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

Frame parse(const uint8_t* data, int64_t n) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
    fail(-1, "not a JPEG file (no SOI marker)");
  Frame f;
  int64_t pos = 2;
  while (pos < n) {
    if (data[pos] != 0xFF) fail(-1, "expected a marker");
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) break;
    int marker = data[pos++];
    if (marker == 0xD9) break;
    if (pos + 2 > n) fail(-1, "truncated marker segment");
    int length = be16(data + pos);
    if (length < 2 || pos + length > n) fail(-1, "truncated marker segment");
    const uint8_t* body = data + pos + 2;
    int blen = length - 2;
    pos += length;
    if (marker == 0xC0 || marker == 0xC1) {
      if (blen < 6) fail(-1, "short SOF segment");
      if (body[0] != 8) fail(-2, "JPEG sample precision other than 8 bits");
      f.height = be16(body + 1);
      f.width = be16(body + 3);
      int nc = body[5];
      if (blen < 6 + 3 * nc) fail(-1, "short SOF segment");
      for (int i = 0; i < nc; ++i) {
        const uint8_t* c = body + 6 + 3 * i;
        Component comp;
        comp.id = c[0];
        comp.h = c[1] >> 4;
        comp.v = c[1] & 15;
        comp.tq = c[2] & 3;
        f.comps.push_back(comp);
      }
    } else if (marker == 0xCC) {
      fail(-2, "arithmetic-coded JPEG is not supported");
    } else if (marker >= 0xC2 && marker <= 0xCF && marker != 0xC4 &&
               marker != 0xC8) {
      fail(-2, "JPEG SOF" + std::to_string(marker - 0xC0) +
                   " (progressive, lossless or arithmetic-coded) is not "
                   "supported; baseline only");
    } else if (marker == 0xDB) {
      int q = 0;
      while (q < blen) {
        int pq = body[q] >> 4, tq = body[q] & 3;
        int size = 64 * (pq + 1);
        if (q + 1 + size > blen) fail(-1, "short DQT segment");
        for (int k = 0; k < 64; ++k) {
          int v = pq ? be16(body + q + 1 + 2 * k) : body[q + 1 + k];
          f.quant[tq][kZigzag[k]] = v;
        }
        f.quant_defined[tq] = true;
        q += 1 + size;
      }
    } else if (marker == 0xC4) {
      int q = 0;
      while (q < blen) {
        if (q + 17 > blen) fail(-1, "short DHT segment");
        int tc = body[q] >> 4, th = body[q] & 3;
        if (tc > 1) fail(-1, "bad DHT table class");
        int total = 0;
        for (int i = 0; i < 16; ++i) total += body[q + 1 + i];
        if (q + 17 + total > blen) fail(-1, "short DHT segment");
        build_huffman(f.huff[tc][th], body + q + 1, body + q + 17, total);
        q += 17 + total;
      }
    } else if (marker == 0xDD) {
      if (blen < 2) fail(-1, "short DRI segment");
      f.restart_interval = be16(body);
    } else if (marker == 0xDA) {
      if (f.comps.empty()) fail(-1, "SOS before SOF");
      int ns = body[0];
      if (blen < 1 + 2 * ns) fail(-1, "short SOS segment");
      for (int i = 0; i < ns; ++i) {
        int cid = body[1 + 2 * i], tables = body[2 + 2 * i];
        int ci = -1;
        for (size_t k = 0; k < f.comps.size(); ++k)
          if (f.comps[k].id == cid) ci = int(k);
        if (ci < 0) fail(-1, "scan names an unknown component");
        f.comps[ci].dc_table = (tables >> 4) & 3;
        f.comps[ci].ac_table = tables & 3;
        f.scan.push_back(ci);
      }
      if (ns != int(f.comps.size()))
        fail(-2, "JPEG with one scan per component is not supported; one "
                 "interleaved scan only");
      f.scan_data = data + pos;
      int64_t end = pos;
      while (end + 1 < n) {
        if (data[end] == 0xFF) {
          int nxt = data[end + 1];
          if (nxt == 0x00 || (nxt >= 0xD0 && nxt <= 0xD7)) {
            end += 2;
            continue;
          }
          if (nxt != 0xFF) break;
        }
        ++end;
      }
      if (end + 1 >= n) end = n;
      f.scan_size = end - pos;
      return f;
    }
  }
  fail(-1, "no scan (SOS) in the file");
}

void check_sampling(Frame& f) {
  size_t nc = f.comps.size();
  if (nc != 1 && nc != 3)
    fail(-2, "JPEG with " + std::to_string(nc) +
                 " colour components; 1 (grey) or 3 (YCbCr) only");
  if (f.height <= 0 || f.width <= 0) fail(-1, "bad image size");
  if (nc == 1) {
    f.comps[0].h = f.comps[0].v = 1;
    f.hmax = f.vmax = 1;
    return;
  }
  const Component& y = f.comps[0];
  bool ok = ((y.h == 1 && y.v == 1) || (y.h == 2 && y.v == 2));
  for (size_t i = 1; i < nc; ++i)
    ok = ok && f.comps[i].h == 1 && f.comps[i].v == 1;
  if (!ok) fail(-2, "JPEG sampling other than 4:4:4 and 4:2:0");
  f.hmax = y.h;
  f.vmax = y.v;
}

// The entropy-coded data, unstuffed, with the bytes at which each restart
// segment starts.
struct BitReader {
  const std::vector<uint8_t>* buf;
  int64_t bitpos = 0;
  uint32_t window() const {
    int64_t byte = bitpos >> 3;
    const uint8_t* p = buf->data() + byte;
    uint32_t v = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
    return (v >> (8 - (bitpos & 7))) & 0xFFFF;
  }
};

int extend(int bits, int s) {
  return bits >= (1 << (s - 1)) ? bits : bits - (1 << s) + 1;
}

void decode_scan(Frame& f) {
  int mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
  int mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  for (auto& c : f.comps) {
    c.blocks_x = mcux * c.h;
    c.blocks_y = mcuy * c.v;
    c.coefs.assign(size_t(c.blocks_x) * c.blocks_y * 64, 0);
    if (!f.huff[0][c.dc_table].defined || !f.huff[1][c.ac_table].defined)
      fail(-1, "scan uses an undefined Huffman table");
  }
  // Unstuff and split at the restart markers.
  std::vector<std::vector<uint8_t>> segments(1);
  const uint8_t* d = f.scan_data;
  for (int64_t i = 0; i < f.scan_size; ++i) {
    if (d[i] == 0xFF && i + 1 < f.scan_size) {
      int nxt = d[i + 1];
      if (nxt == 0x00) {
        segments.back().push_back(0xFF);
        ++i;
        continue;
      }
      if (nxt >= 0xD0 && nxt <= 0xD7) {
        segments.emplace_back();
        ++i;
        continue;
      }
      if (nxt == 0xFF) continue;
    }
    segments.back().push_back(d[i]);
  }
  int64_t n_mcu = int64_t(mcux) * mcuy;
  int64_t interval = f.restart_interval ? f.restart_interval : n_mcu;
  int64_t mcu = 0;
  for (auto& seg : segments) {
    if (mcu >= n_mcu) break;
    int64_t nbits = int64_t(seg.size()) * 8;
    seg.insert(seg.end(), 4, 0);
    BitReader br{&seg};
    int pred[3] = {0, 0, 0};
    int64_t todo = std::min(interval, n_mcu - mcu);
    for (int64_t m = 0; m < todo; ++m, ++mcu) {
      int my = int(mcu / mcux), mx = int(mcu % mcux);
      for (int ci : f.scan) {
        Component& c = f.comps[ci];
        const Huffman& dc = f.huff[0][c.dc_table];
        const Huffman& ac = f.huff[1][c.ac_table];
        for (int by = 0; by < c.v; ++by) {
          for (int bx = 0; bx < c.h; ++bx) {
            int16_t* block =
                c.coefs.data() +
                (size_t(my * c.v + by) * c.blocks_x + mx * c.h + bx) * 64;
            if (br.bitpos > nbits + 32)
              fail(-1, "entropy-coded data ends early");
            uint32_t w = br.window();
            int len = dc.length[w];
            if (len == 0) fail(-1, "bad Huffman code");
            int s = dc.symbol[w];
            br.bitpos += len;
            int diff = 0;
            if (s) {
              if (s > 16) fail(-1, "bad DC category");
              int bits = int(br.window() >> (16 - s));
              br.bitpos += s;
              diff = extend(bits, s);
            }
            pred[ci] += diff;
            block[0] = int16_t(pred[ci]);
            for (int k = 1; k < 64;) {
              w = br.window();
              len = ac.length[w];
              if (len == 0) fail(-1, "bad Huffman code");
              int rs = ac.symbol[w];
              br.bitpos += len;
              int r = rs >> 4;
              s = rs & 15;
              if (s == 0) {
                if (r != 15) break;  // EOB
                k += 16;
                continue;
              }
              k += r;
              int bits = int(br.window() >> (16 - s));
              br.bitpos += s;
              if (k < 64) block[k] = int16_t(extend(bits, s));
              ++k;
            }
          }
        }
      }
    }
    if (br.bitpos > nbits + 32) fail(-1, "entropy-coded data ends early");
  }
  if (mcu < n_mcu) fail(-1, "entropy-coded data ends early");
}

// jidctint.c constants, CONST_BITS = 13, PASS1_BITS = 2.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995,
                  F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// One 1-D islow pass over in[0..7] (stride `is`), out[0..7] (stride `os`).
inline void idct_1d(const int64_t* in, int is, int64_t* out, int os,
                    int shift) {
  int64_t z2 = in[2 * is], z3 = in[6 * is];
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 + z3 * -F1847;
  int64_t tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = (in[0] + in[4 * is]) * (int64_t(1) << kConstBits);
  int64_t tmp1 = (in[0] - in[4 * is]) * (int64_t(1) << kConstBits);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = in[7 * is], t1 = in[5 * is], t2 = in[3 * is], t3 = in[is];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  out[0] = descale(tmp10 + t3, shift);
  out[7 * os] = descale(tmp10 - t3, shift);
  out[os] = descale(tmp11 + t2, shift);
  out[6 * os] = descale(tmp11 - t2, shift);
  out[2 * os] = descale(tmp12 + t1, shift);
  out[5 * os] = descale(tmp12 - t1, shift);
  out[3 * os] = descale(tmp13 + t0, shift);
  out[4 * os] = descale(tmp13 - t0, shift);
}

uint8_t g_range[1024];

void init_range() {
  for (int i = 0; i < 1024; ++i) {
    uint8_t v = 0;
    if (i < 128) v = uint8_t(i + 128);
    else if (i < 384) v = 255;
    else if (i >= 896) v = uint8_t(i - 896);
    g_range[i] = v;
  }
}

// Dequantise and IDCT every block of a component into its sample plane.
std::vector<uint8_t> component_plane(const Frame& f, const Component& c) {
  if (!f.quant_defined[c.tq])
    fail(-1, "component uses an undefined quantisation table");
  const int32_t* q = f.quant[c.tq];
  int pw = c.blocks_x * 8, ph = c.blocks_y * 8;
  std::vector<uint8_t> plane(size_t(pw) * ph);
  int64_t nat[64], ws[64], out[64];
  for (int by = 0; by < c.blocks_y; ++by) {
    for (int bx = 0; bx < c.blocks_x; ++bx) {
      const int16_t* zz = c.coefs.data() + (size_t(by) * c.blocks_x + bx) * 64;
      for (int k = 0; k < 64; ++k) nat[kZigzag[k]] = int64_t(zz[k]) * q[kZigzag[k]];
      for (int col = 0; col < 8; ++col)
        idct_1d(nat + col, 8, ws + col, 8, kConstBits - kPass1Bits);
      for (int row = 0; row < 8; ++row)
        idct_1d(ws + 8 * row, 1, out + 8 * row, 1,
                kConstBits + kPass1Bits + 3);
      for (int row = 0; row < 8; ++row)
        for (int col = 0; col < 8; ++col)
          plane[size_t(by * 8 + row) * pw + bx * 8 + col] =
              g_range[out[8 * row + col] & 1023];
    }
  }
  return plane;
}

// jdsample.c h2v2_fancy_upsample of the (ch, cw) chroma samples of a plane
// with row pitch `pitch`, into (2 ch, 2 cw); h2v2_upsample (each sample
// repeated 2x2) when cw <= 2, as libjpeg chooses.
std::vector<uint8_t> upsample_h2v2(const std::vector<uint8_t>& plane,
                                   int pitch, int cw, int ch) {
  int ow = 2 * cw;
  std::vector<uint8_t> out(size_t(ow) * 2 * ch);
  std::vector<int> col(cw);
  for (int r = 0; r < ch; ++r) {
    const uint8_t* p0 = plane.data() + size_t(r) * pitch;
    for (int v = 0; v < 2; ++v) {
      int nr = v == 0 ? (r > 0 ? r - 1 : 0) : (r + 1 < ch ? r + 1 : ch - 1);
      const uint8_t* p1 = plane.data() + size_t(nr) * pitch;
      for (int j = 0; j < cw; ++j) col[j] = p0[j] * 3 + p1[j];
      uint8_t* o = out.data() + size_t(2 * r + v) * ow;
      if (cw <= 2) {  // libjpeg replicates instead (jinit_upsampler)
        for (int j = 0; j < 2 * cw; ++j) o[j] = p0[j / 2];
        continue;
      }
      o[0] = uint8_t((col[0] * 4 + 8) >> 4);
      o[1] = uint8_t((col[0] * 3 + col[1] + 7) >> 4);
      for (int j = 1; j < cw - 1; ++j) {
        o[2 * j] = uint8_t((col[j] * 3 + col[j - 1] + 8) >> 4);
        o[2 * j + 1] = uint8_t((col[j] * 3 + col[j + 1] + 7) >> 4);
      }
      o[2 * cw - 2] = uint8_t((col[cw - 1] * 3 + col[cw - 2] + 8) >> 4);
      o[2 * cw - 1] = uint8_t((col[cw - 1] * 4 + 7) >> 4);
    }
  }
  return out;
}

inline int64_t fix16(double x) { return int64_t(x * 65536.0 + 0.5); }

inline uint8_t clamp255(int64_t v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void decode(const uint8_t* data, int64_t n, uint8_t* out) {
  Frame f = parse(data, n);
  check_sampling(f);
  decode_scan(f);
  int h = f.height, w = f.width;
  std::vector<std::vector<uint8_t>> planes;
  for (const auto& c : f.comps) planes.push_back(component_plane(f, c));
  int ypitch = f.comps[0].blocks_x * 8;
  if (f.comps.size() == 1) {
    for (int r = 0; r < h; ++r)
      std::memcpy(out + size_t(r) * w, planes[0].data() + size_t(r) * ypitch,
                  size_t(w));
    return;
  }
  const uint8_t* cb = planes[1].data();
  const uint8_t* cr = planes[2].data();
  int cpitch = f.comps[1].blocks_x * 8;
  std::vector<uint8_t> up_cb, up_cr;
  if (f.hmax == 2) {
    int cw = (w + 1) / 2, ch = (h + 1) / 2;
    up_cb = upsample_h2v2(planes[1], cpitch, cw, ch);
    up_cr = upsample_h2v2(planes[2], cpitch, cw, ch);
    cb = up_cb.data();
    cr = up_cr.data();
    cpitch = 2 * cw;
  }
  const int64_t half = int64_t(1) << 15;
  const int64_t k_r = fix16(1.40200), k_b = fix16(1.77200);
  const int64_t k_gb = fix16(0.34414), k_gr = fix16(0.71414);
  for (int r = 0; r < h; ++r) {
    const uint8_t* yr = planes[0].data() + size_t(r) * ypitch;
    const uint8_t* br = cb + size_t(r) * cpitch;
    const uint8_t* rr = cr + size_t(r) * cpitch;
    uint8_t* o = out + size_t(r) * w * 3;
    for (int j = 0; j < w; ++j) {
      int64_t y = yr[j], xb = int64_t(br[j]) - 128, xr = int64_t(rr[j]) - 128;
      o[3 * j] = clamp255(y + ((k_r * xr + half) >> 16));
      o[3 * j + 1] = clamp255(y + ((-k_gb * xb + half - k_gr * xr) >> 16));
      o[3 * j + 2] = clamp255(y + ((k_b * xb + half) >> 16));
    }
  }
}

}  // namespace

extern "C" {

int vfn_jpeg_info(const uint8_t* data, int64_t n, int32_t* info) {
  try {
    Frame f = parse(data, n);
    check_sampling(f);
    info[0] = f.height;
    info[1] = f.width;
    info[2] = int32_t(f.comps.size());
    return 0;
  } catch (const Fail& e) {
    return e.code;
  }
}

int vfn_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                    int64_t out_size) {
  static bool ready = (init_range(), true);
  (void)ready;
  try {
    Frame f = parse(data, n);
    check_sampling(f);
    if (out_size != int64_t(f.height) * f.width * int64_t(f.comps.size()))
      fail(-3, "output buffer size does not match the image");
    decode(data, n, out);
    return 0;
  } catch (const Fail& e) {
    return e.code;
  }
}

const char* vfn_jpeg_error(int code) {
  (void)code;
  return g_error.c_str();
}

}  // extern "C"
