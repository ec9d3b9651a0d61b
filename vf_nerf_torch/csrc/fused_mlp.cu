// Fused MLP forward over BatchNorm-folded weights, for sm_90a.
//
// Replaces the TPU kernel vf_nerf_tpu/ops/fused_mlp.py::fused_mlp
// (kernel body _fused_mlp_kernel): every layer of the MLP for a tile of
// points in ONE launch, h = relu(h @ W + b), the skip layer taking
// concat([h, x]) / sqrt(2), the last layer without ReLU and ending in tanh or
// sigmoid. The activations never leave the chip.
//
// What bounds it on the H100: operations. The VF net costs 525,056 MACs per
// point and the colour net 271,360, against 39 + 259 (or 289 + 3) floats of
// input and output per point, so a render is ~320 GFLOP and ~0.44 GB. The
// products run on the tensor cores in TF32 with the 3xTF32 split, so the
// card's ceiling is a third of its 495 TFLOP/s TF32 rate.
//
// Numerics (3xTF32). Each operand x is split on chip into hi = tf32_rn(x)
// and lo = tf32_rn(x - hi); every product is a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi. The dropped a_lo*b_lo term and the rounding of lo are ~2^-21
// relative, so the products are of f32 grade; a single TF32 pass (2^-11) is
// not, once the VF net's 9 layers amplify it. The tensor cores add into
// their accumulator without rounding to nearest, so each k-tile's products
// (16 inputs, 6 MMAs) go into a partial sum that starts from zero, and the
// partial is added to the running f32 sum with an ordinary
// (round-to-nearest) add. Chaining all products of a layer into one
// accumulator instead lost several times the plain f32 chain's accuracy on
// the card, and failed the render's check against the CPU plain path.
//
// Design.
//   * A block of 256 threads, two warpgroups, owns 128 points; warpgroup w
//     owns points 64w .. 64w + 63. The activations live in ONE shared buffer
//     (128 x 300 f32, point-major, features contiguous; the pitch 300 = 12
//     mod 32 makes the fragment loads free of bank conflicts) for all layers,
//     updated in place: a layer's whole output (64 points x up to 256
//     outputs per warpgroup) is held in registers, then written back after a
//     barrier. So hidden widths are at most 256; inputs and the skip concat
//     at most 296.
//   * Products: wgmma.mma_async m64n128k8 TF32, A (the activations) from
//     registers, split into hi/lo as the fragments are loaded; B (the
//     weights) from shared memory, K-major. A layer's outputs go in halves of
//     128; the first half's sums wait in registers while the second runs.
//   * Weights stream from global memory (they sit in the 50 MB L2) in tiles
//     of 16 input rows x 128 outputs, in the folded (in, out) layout the
//     wrapper passes, through a ring of 4 raw shared stages filled by
//     cp.async (16-byte copies where the layer's width allows, 4-byte copies
//     otherwise) whose completion arrives on one mbarrier per stage, 4 tiles
//     ahead across layer boundaries. While the tensor cores run tile t, all
//     threads split tile t + 1 on chip into hi and lo copies, transposed to
//     the K-major core-matrix layout wgmma reads (double-buffered). Each tile
//     is read from L2 once per 128 points. Tiles are 16 inputs deep because
//     each tile costs a barrier, a wait for the tensor cores and a flush of
//     the partial sum; 8-deep tiles were slower on the card.
//   * Ragged K and N (39, 217, 259, 289, 3): weight rows and columns outside
//     (K, N) land as zeros and activation columns are zero-padded to a
//     multiple of 8; the point tail is masked, never padded in memory.
//   * Bias, ReLU and the final tanh / sigmoid are fused into the epilogues.
//     The last layer walks its chunks of 256 outputs last-first: earlier
//     chunks write from registers to the (points, N) output, and the final
//     one (outputs 0..255) goes through the then free activation buffer so
//     that the output rows are written with coalesced stores.
//   * The input tile lands by cp.async; the skip's x columns are loaded with
//     16 loads in flight per lane. Index loops run warps over rows and lanes
//     over columns, so they need no integer division.
//   * Activation-save mode (training, the kSave instantiation): each hidden
//     layer's post-ReLU output goes from the shared activation tile to
//     `acts` by the TMA's bulk asynchronous copy, issued by one thread after
//     the barrier that completes the layer's write-back (the writers first
//     fence the generic proxy against the async one). The tensor cores start
//     the next layer while the copy drains; the thread waits on
//     cp.async.bulk.wait_group.read only where the tile is next overwritten:
//     before the next write-back's barrier, and before the skip layer scales
//     the tile in place. `acts` is layer-major, (hidden layers, points,
//     kActLd), so that a block's rows of one layer are one contiguous run in
//     both places and the whole tile is ONE copy (the columns past the
//     layer's width carry whatever the tile held there and are never read);
//     per-row copies into a packed row layout would take 128 copy
//     instructions a layer where this takes one. The copies carry an L2
//     evict-first hint, so the ~2 GB a fine VF pass saves does not push the
//     weight tiles, which every block reads, out of the L2. The copy runs
//     from shared memory, never from the accumulator registers; the no-save
//     instantiation (eval) has no copy code at all. What bounds the save
//     mode now is the products, as in the no-save launch: the copies add
//     ~0.3 ms to the fine VF launch's ~5.4 ms on an NVIDIA H100 80GB HBM3
//     at 700 W (PERF.md section 6).
//   * Schedules. With 128 points per block (one block per SM at a time) a
//     grid whose last round is partial pays a whole round for it: the
//     step's shell and ball launches (160 blocks on 132 SMs: 2 rounds for
//     1.2 rounds of work), the fine VF and colour launches (1600 blocks:
//     12 rounds and 16 blocks), the render's coarse launch (800 blocks).
//     A 64-point split block (kSplit) splits each chunk's outputs between
//     the warpgroups (warpgroup w computes half w, both read the same 64
//     activation rows, each weight tile stage holds both halves), so it
//     does half the k-steps and takes ~0.6 of a 128-point block's time.
//     One launch mixes them: its first blocks128 blocks take 128 points,
//     the rest 64, so the partial last round runs as cheaper split blocks;
//     the wrapper picks blocks128 (ops/fused_mlp.py::blocks_of_128).
// Clusters with a TMA multicast of each weight tile are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;               // two warpgroups
constexpr int kChunkN = 256;                // outputs held per pass
constexpr int kHalfN = 128;                 // outputs per wgmma
constexpr int kTileK = 16;                  // weight rows per tile: 2 k-steps
constexpr int kStages = 4;                  // raw weight ring
constexpr int kActLd = 300;                 // activation pitch, 12 mod 32
constexpr int kMaxWidth = 296;              // widest input the pitch holds
constexpr int kRaw = kTileK * kHalfN;       // floats per raw half tile

// Points per block: 128 (each warpgroup 64 points, both output halves in
// turn), or 64 with the outputs split between the warpgroups.
template <bool kSplit>
__host__ __device__ constexpr int tile_p() { return kSplit ? 64 : 128; }

// Dynamic shared memory: the activation tile, the raw ring (both halves per
// stage when split) and the double-buffered hi / lo split tiles.
template <bool kSplit>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(tile_p<kSplit>() * kActLd +
                  (kSplit ? 2 : 1) * (kStages + 2 * 2) * kRaw) *
         sizeof(float);
}

struct MlpDesc {
  const float* w[kMaxLayers];  // (K, N) row-major: in x out
  const float* b[kMaxLayers];  // (N,)
  int k[kMaxLayers];
  int n[kMaxLayers];
  int n_layers;
  int skip_at;    // -1: no skip
  int final_act;  // 0 none, 1 tanh, 2 sigmoid
  float* acts;    // save mode: (n_layers - 1, points, kActLd) hidden outputs
};

__device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The stage's mbarrier completes its phase once every thread's copies landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// Bulk asynchronous copy (TMA, no tensor map) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) from shared to global memory, in this
// thread's current bulk group, marked first to leave the L2: the saved
// activations are read again only by the backward, while the weight tiles
// are read by every block.
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "{\n .reg .b64 pol;\n"
      " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      " cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, pol;\n}\n"
      :: "l"(__cvta_generic_to_global(dst)), "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk copies have read their shared source (it may be
// overwritten); a thread with none returns at once.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory, read next by the async proxy
// (wgmma, bulk copies).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a K-major, unswizzled B tile: core
// matrices of 8 rows (outputs) x 16 bytes (4 inputs), 128 bytes each; the
// next 4 inputs at +128 bytes (leading byte offset), the next 8 outputs at
// +512 bytes (stride byte offset: the 4 core matrices of a 16-input tile).
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32);
}

#define VFN_R8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 per warpgroup) = a * b (+ d unless scale_d is 0); a: this
// thread's m64k8 TF32 fragment, b: descriptor of the k8 x n128 tile.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %68, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %69, p, "
      "1, 1;\n}\n"
      : VFN_R8(0), VFN_R8(8), VFN_R8(16), VFN_R8(24), VFN_R8(32), VFN_R8(40),
        VFN_R8(48), VFN_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

#undef VFN_R8

// Keeps the compiler from moving uses of wgmma's registers across the wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// First output of a layer's last chunk of kChunkN outputs: chunks are
// walked last-first.
__device__ __forceinline__ int last_chunk(int n) {
  return (n - 1) / kChunkN * kChunkN;
}

// Halves of kHalfN outputs in the chunk starting at n0.
__device__ __forceinline__ int halves(int n, int n0) {
  return (min(n - n0, kChunkN) + kHalfN - 1) / kHalfN;
}

// Position of the weight tile the producer fills next: layer, first output
// of the chunk, half, first input row. Tiles go layer by layer, chunk by
// chunk, half by half (split: both halves in one tile), k-step by k-step:
// the order the consumer walks them.
template <bool kSplit>
struct Cursor {
  int layer, n0, half, k0;

  __device__ __forceinline__ void advance(const MlpDesc& d) {
    k0 += kTileK;
    if (k0 < d.k[layer]) return;
    k0 = 0;
    if (!kSplit && ++half < halves(d.n[layer], n0)) return;
    half = 0;
    n0 -= kChunkN;
    if (n0 < 0 && ++layer < d.n_layers) n0 = last_chunk(d.n[layer]);
  }
};

// Every thread copies its share of the tile at `c` into the raw stage
// (rows k, 128 output columns per half, zero outside (K, N); split: both
// halves, the second at raw + kRaw) and arrives on the stage's barrier when
// its copies land. Warp w copies rows w and w + 8.
template <bool kSplit>
__device__ __forceinline__ void issue_tile(const Cursor<kSplit>& c,
                                           const MlpDesc& d, float* raw,
                                           uint32_t bar, int warp, int lane) {
  const float* __restrict__ W = d.w[c.layer];
  const int K = d.k[c.layer], N = d.n[c.layer];
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
#pragma unroll
  for (int h = 0; h < (kSplit ? 2 : 1); ++h) {
    const int n0 = c.n0 + (kSplit ? h : c.half) * kHalfN;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int gk = c.k0 + warp + 8 * rr;
      const float* row = W + (size_t)gk * N + n0;
      float* dst = raw + h * kRaw + (warp + 8 * rr) * kHalfN;
      if (vec) {
        const int col = 4 * lane;
        const bool ok = gk < K && n0 + col < N;
        cp_async16(smem_u32(dst + col), ok ? row + col : W, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int col = lane; col < kHalfN; col += 32) {
          const bool ok = gk < K && n0 + col < N;
          cp_async4(smem_u32(dst + col), ok ? row + col : W, ok ? 4 : 0);
        }
      }
    }
  }
  cp_async_arrive(bar);
}

// Split the raw tile (rows k, columns n) into TF32 hi and lo copies in the
// K-major core-matrix layout of b_desc: thread (n, kc) moves inputs
// 4kc .. 4kc + 3 of output n as one 16-byte store per copy, for two kc.
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo, int tid) {
  const int n = tid % kHalfN;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int kc = tid / kHalfN + 2 * kk;
    float4 h, l;
    uint32_t a, b;
    split(raw[(4 * kc + 0) * kHalfN + n], a, b);
    h.x = __uint_as_float(a);
    l.x = __uint_as_float(b);
    split(raw[(4 * kc + 1) * kHalfN + n], a, b);
    h.y = __uint_as_float(a);
    l.y = __uint_as_float(b);
    split(raw[(4 * kc + 2) * kHalfN + n], a, b);
    h.z = __uint_as_float(a);
    l.z = __uint_as_float(b);
    split(raw[(4 * kc + 3) * kHalfN + n], a, b);
    h.w = __uint_as_float(a);
    l.w = __uint_as_float(b);
    const int at = ((n / 8) * 4 + kc) * 32 + (n % 8) * 4;
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
  fence_async_shared();  // read next by wgmma
}

// The skip's x columns: act[p][c0 + j] = x[p_base + p][j] * scale for the
// `span` columns j, zero for j >= in_dim and past the point tail. Warp w
// takes rows w, w + 8, ..., with all of a lane's loads in flight.
template <int kRowsPerWarp>
__device__ __forceinline__ void load_x_scaled(float* act,
                                              const float* __restrict__ x,
                                              int c0, int span, int in_dim,
                                              int p_base, int n_points,
                                              float scale, int warp,
                                              int lane) {
  for (int j = lane; j < span; j += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int gp = p_base + warp + 8 * r;
      v[r] = (j < in_dim && gp < n_points)
                 ? __ldg(x + (size_t)gp * in_dim + j) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      act[(warp + 8 * r) * kActLd + c0 + j] = v[r] * scale;
    }
  }
}

__device__ __forceinline__ float final_act(float v, int act) {
  if (act == 1) return tanhf(v);
  if (act == 2) return 1.f / (1.f + expf(-v));
  return v;
}

// A warpgroup's 64 x 128 half (outputs h0 .. h0 + 127 of the chunk) plus
// bias, through ReLU (hidden) or the final activation (last), into the
// activation buffer at column h0 + output.
__device__ __forceinline__ void half_to_act(const float (&v)[64], float* act,
                                            const float* __restrict__ B,
                                            int N, int n0, int h0, int row,
                                            int t, bool last, int fin) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = n0 + h0 + 8 * i + 2 * t;
    const float b0 = n < N ? __ldg(B + n) : 0.f;
    const float b1 = n + 1 < N ? __ldg(B + n + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = v[4 * i + 2 * h] + b0, v1 = v[4 * i + 2 * h + 1] + b1;
      if (last) {
        v0 = final_act(v0, fin);
        v1 = final_act(v1, fin);
      } else {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<float2*>(act + (row + 8 * h) * kActLd + h0 + 8 * i +
                                 2 * t) = make_float2(v0, v1);
    }
  }
}

// One block's kTileP points from p_base through every layer. kSave: also
// copy each hidden layer's output to d.acts (bulk copies); kSplit: 64
// points, the warpgroups splitting each chunk's outputs (see the head
// comment).
template <bool kSave, bool kSplit>
__device__ __forceinline__ void mlp_tile(const float* __restrict__ x,
                                         float* __restrict__ out,
                                         int n_points, int in_dim,
                                         const MlpDesc& d, int p_base) {
  constexpr int kTileP = tile_p<kSplit>();
  constexpr int kRowsPerWarp = kTileP / (kThreads / 32);
  constexpr int kHalves = kSplit ? 2 : 1;        // output halves per tile
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);   // kTileP x kActLd
  float* split_buf = act + kTileP * kActLd;       // 2 x kHalves x (hi, lo)
  float* raw = split_buf + 2 * kHalves * 2 * kRaw;  // kStages x kHalves
  __shared__ uint64_t full[kStages];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4;
  // Fragment row: warpgroup w owns points 64w.. (split: both own 0..63).
  const int row = (kSplit ? 0 : wg * 64) + (warp % 4) * 16 + g;
  // 1/sqrt(2) in f32: PyTorch's CUDA division by a scalar multiplies by
  // the reciprocal too (within 1 ulp of dividing).
  const float kRsqrt2 = 0.70710678118654752f;

  int n_tiles = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    for (int n0 = 0; n0 < d.n[l]; n0 += kChunkN) {
      n_tiles += (kSplit ? 1 : halves(d.n[l], n0)) *
                 (round_up(d.k[l], kTileK) / kTileK);
    }
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&full[s])), "r"(kThreads) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The first kStages weight tiles go in flight before the input loads.
  Cursor<kSplit> prod{0, last_chunk(d.n[0]), 0, 0};
  int issued = 0;
  for (; issued < kStages && issued < n_tiles; ++issued) {
    issue_tile(prod, d, raw + issued * kHalves * kRaw,
               smem_u32(&full[issued]), warp, lane);
    prod.advance(d);
  }

  // Input tile by cp.async, zero past the point tail and up to a multiple of
  // 8 features; warp w takes rows w, w + 8, ...
  {
    const int cols = round_up(in_dim, 8);
    for (int j = lane; j < cols; j += 32) {
#pragma unroll 4
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int p = warp + 8 * r, gp = p_base + p;
        const bool ok = j < in_dim && gp < n_points;
        cp_async4(smem_u32(act + p * kActLd + j),
                  ok ? x + (size_t)gp * in_dim + j : x, ok ? 4 : 0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  mbar_wait(smem_u32(&full[0]), 0);
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    float* sb = split_buf + h * 2 * kRaw;
    split_tile(raw + h * kRaw, sb, sb + kRaw, tid);
  }
  __syncthreads();

  float hold[64], acc[64], part[64];  // hold: unused when split
  int tile = 0;
  int width = in_dim;
  for (int layer = 0; layer < d.n_layers; ++layer) {
    if (layer == d.skip_at) {
      if (kSave) {
        // The previous layer's copies read the columns scaled here.
        bulk_wait_read();
        __syncthreads();
      }
      // concat([h, x]) / sqrt(2), in place.
      for (int p = warp; p < kTileP; p += 8) {
        for (int k = lane; k < width; k += 32) act[p * kActLd + k] *= kRsqrt2;
      }
      load_x_scaled<kRowsPerWarp>(act, x, width,
                                  round_up(width + in_dim, 8) - width, in_dim,
                                  p_base, n_points, kRsqrt2, warp, lane);
      width += in_dim;
      __syncthreads();
    }

    const int K = d.k[layer], N = d.n[layer];
    const float* __restrict__ B = d.b[layer];
    const bool last = layer == d.n_layers - 1;

    for (int n0 = last_chunk(N); n0 >= 0; n0 -= kChunkN) {
      const int nh = halves(N, n0);
      for (int half = 0; half < (kSplit ? 1 : nh); ++half) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int k0 = 0; k0 < K; k0 += kTileK, ++tile) {
          // This warpgroup's split tile: half wg when split.
          const float* sb = split_buf +
                            ((tile & 1) * kHalves + (kSplit ? wg : 0)) * 2 *
                                kRaw;
          const float* a = act + row * kActLd + k0 + t;
          // The tile's second k-step only where the layer has inputs there
          // (activation columns past round_up(K, 8) are not written).
          const bool two = k0 + 8 < K;
          uint32_t ah[4], al[4], ah2[4], al2[4];
          split(a[0], ah[0], al[0]);
          split(a[8 * kActLd], ah[1], al[1]);
          split(a[4], ah[2], al[2]);
          split(a[8 * kActLd + 4], ah[3], al[3]);
          if (two) {
            split(a[8], ah2[0], al2[0]);
            split(a[8 * kActLd + 8], ah2[1], al2[1]);
            split(a[12], ah2[2], al2[2]);
            split(a[8 * kActLd + 12], ah2[3], al2[3]);
          }
          // Inputs 8ks .. 8ks + 7 are core matrices 2ks, 2ks + 1 (+64 floats).
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          wgmma_tf32(part, al, b_desc(sb), 0);
          wgmma_tf32(part, ah, b_desc(sb + kRaw), 1);
          wgmma_tf32(part, ah, b_desc(sb), 1);
          if (two) {
            wgmma_tf32(part, al2, b_desc(sb + 64), 1);
            wgmma_tf32(part, ah2, b_desc(sb + kRaw + 64), 1);
            wgmma_tf32(part, ah2, b_desc(sb + 64), 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // The next tile is split while the tensor cores run this one.
          if (tile + 1 < n_tiles) {
            const int s = (tile + 1) % kStages;
            mbar_wait(smem_u32(&full[s]), ((tile + 1) / kStages) & 1);
#pragma unroll
            for (int h = 0; h < kHalves; ++h) {
              float* nb =
                  split_buf + (((tile + 1) & 1) * kHalves + h) * 2 * kRaw;
              split_tile(raw + (s * kHalves + h) * kRaw, nb, nb + kRaw, tid);
            }
          }
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
          // Every thread is done with the raw stage refilled next and with
          // the split tile the next k-step reads.
          __syncthreads();
          if (issued < n_tiles) {
            const int s = issued % kStages;
            issue_tile(prod, d, raw + s * kHalves * kRaw,
                       smem_u32(&full[s]), warp, lane);
            prod.advance(d);
            ++issued;
          }
        }
        if (!kSplit && half == 0 && nh == 2) {
#pragma unroll
          for (int i = 0; i < 64; ++i) hold[i] = acc[i];
        }
      }

      if (!last || n0 == 0) {
        // A hidden layer (N <= kChunkN), or the last layer's final chunk:
        // every warp is done reading this layer's input, so the output
        // replaces it, zero from N up to the half's end (weights and bias
        // there are zero). In save mode the previous layer's copies must
        // have read the tile first.
        if (kSave) bulk_wait_read();
        __syncthreads();
        if (kSplit) {
          half_to_act(acc, act, B, N, n0, wg * kHalfN, row, t, last,
                      d.final_act);
        } else if (nh == 2) {
          half_to_act(hold, act, B, N, n0, 0, row, t, last, d.final_act);
          half_to_act(acc, act, B, N, n0, kHalfN, row, t, last, d.final_act);
        } else {
          half_to_act(acc, act, B, N, n0, 0, row, t, last, d.final_act);
        }
        if (kSave && !last) fence_async_shared();  // read by the copies
        __syncthreads();
        if (last) {
          // Coalesced rows of the (points, N) output, outputs 0..nc-1.
          const int nc = min(N, kChunkN);
          for (int p = warp; p < kTileP && p_base + p < n_points; p += 8) {
            float* orow = out + (size_t)(p_base + p) * N;
            for (int n = lane; n < nc; n += 32) orow[n] = act[p * kActLd + n];
          }
        } else if (kSave && tid == 0) {
          // This hidden layer's rows of the block, as one copy.
          const int rows = min(kTileP, n_points - p_base);
          bulk_store(d.acts + ((size_t)layer * n_points + p_base) * kActLd,
                     smem_u32(act), rows * kActLd * (int)sizeof(float));
          bulk_commit();
        }
      } else {
        // An earlier chunk of the last layer: straight from registers.
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gp = p_base + row + (e >> 1) * 8;
            const int n = n0 + (kSplit ? wg * kHalfN : 0) + 8 * i + 2 * t +
                          (e & 1);
            const float v0 =
                !kSplit && nh == 2 ? hold[4 * i + e] : acc[4 * i + e];
            if (n < N && gp < n_points) {
              out[(size_t)gp * N + n] =
                  final_act(v0 + __ldg(B + n), d.final_act);
            }
            if (!kSplit && nh == 2 && n + kHalfN < N && gp < n_points) {
              out[(size_t)gp * N + n + kHalfN] =
                  final_act(acc[4 * i + e] + __ldg(B + n + kHalfN),
                            d.final_act);
            }
          }
        }
      }
    }
    width = N;
  }
  // Every copy has read the tile before the block's shared memory goes.
  if (kSave) bulk_wait_read();
}

// Blocks 0 .. blocks128 - 1 take 128 points each; the points after them
// go in 64-point split blocks, which the card starts last (the schedule).
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n_points, int in_dim, const __grid_constant__ MlpDesc d,
                 int blocks128) {
  const int b = blockIdx.x;
  if (b < blocks128) {
    mlp_tile<kSave, false>(x, out, n_points, in_dim, d, b * tile_p<false>());
  } else {
    mlp_tile<kSave, true>(x, out, n_points, in_dim, d,
                          blocks128 * tile_p<false>() +
                              (b - blocks128) * tile_p<true>());
  }
}

template <bool kSave>
cudaError_t launch(const float* x, float* out, int n_points, int in_dim,
                   const MlpDesc& d, int blocks128, cudaStream_t stream) {
  constexpr size_t kBytes = smem_bytes<false>() > smem_bytes<true>()
                                ? smem_bytes<false>() : smem_bytes<true>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBytes);
  if (err != cudaSuccess) return err;
  const int rest = max(0, n_points - blocks128 * tile_p<false>());
  const int blocks = blocks128 + (rest + tile_p<true>() - 1) / tile_p<true>();
  fused_mlp_kernel<kSave><<<blocks, kThreads, kBytes, stream>>>(
      x, out, n_points, in_dim, d, blocks128);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest layer input (and network input) the activation buffer holds.
int vfn_fused_mlp_max_width() { return kMaxWidth; }

// Widest hidden layer: a hidden layer's output is held in registers whole.
int vfn_fused_mlp_max_hidden() { return kChunkN; }

// Row pitch (floats) of the saved activations.
int vfn_fused_mlp_acts_pitch() { return kActLd; }

// Launch on `stream`. `weights` and `biases` are HOST arrays of device
// pointers, `k_dims` / `n_dims` host arrays of the layer widths. `acts`:
// null, or a 16-byte aligned device buffer of (n_layers - 1) x n_points x
// vfn_fused_mlp_acts_pitch() f32 that receives every hidden layer's output
// in the first columns of its rows (save mode). `blocks128`: how many
// 128-point blocks lead the grid (0 .. ceil(n_points / 128)); the points
// after them go in 64-point split blocks. Returns the CUDA error code of
// the configuration and the launch (0 on success).
int vfn_fused_mlp(const float* x, float* out, int n_points, int in_dim,
                  const float* const* weights, const float* const* biases,
                  const int* k_dims, const int* n_dims, int n_layers,
                  int skip_at, int final_act, float* acts, int blocks128,
                  void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || in_dim > kMaxWidth ||
      blocks128 < 0 ||
      blocks128 > (n_points + tile_p<false>() - 1) / tile_p<false>() ||
      (reinterpret_cast<uintptr_t>(acts) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  MlpDesc d;
  for (int i = 0; i < n_layers; ++i) {
    if (k_dims[i] > kMaxWidth || (i < n_layers - 1 && n_dims[i] > kChunkN)) {
      return (int)cudaErrorInvalidValue;
    }
    d.w[i] = weights[i];
    d.b[i] = biases[i];
    d.k[i] = k_dims[i];
    d.n[i] = n_dims[i];
  }
  d.n_layers = n_layers;
  d.skip_at = skip_at;
  d.final_act = final_act;
  d.acts = acts;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(acts != nullptr
                   ? launch<true>(x, out, n_points, in_dim, d, blocks128, s)
                   : launch<false>(x, out, n_points, in_dim, d, blocks128, s));
}

const char* vfn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
