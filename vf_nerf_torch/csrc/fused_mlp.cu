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
//   * A block of 512 threads, four warpgroups, owns 128 points: two producer
//     warpgroups that only prepare weight tiles, and two consumer
//     warpgroups that only multiply; consumer w owns points 64w .. 64w + 63.
//     setmaxnreg moves registers from the producers (kProducerRegs) to the
//     consumers (kConsumerRegs), whose partial, running and held sums take
//     192 a thread. The activations live in ONE shared buffer (128 x 300
//     f32, point-major, features contiguous; the pitch 300 = 12 mod 32 makes
//     the fragment loads free of bank conflicts) for all layers, updated in
//     place: a layer's whole output (64 points x up to 256 outputs per
//     consumer) is held in registers, then written back over the consumer's
//     own rows. So hidden widths are at most 256; inputs and the skip concat
//     at most 296.
//   * Products: wgmma.mma_async m64n128k8 TF32, A (the activations) from
//     registers, split into hi/lo as the fragments are loaded; B (the
//     weights) from shared memory, K-major. A layer's outputs go in halves of
//     128; the first half's sums wait in registers while the second runs.
//   * Weights stream from global memory (they sit in the 50 MB L2) in tiles
//     of 16 input rows x 128 outputs, in the folded (in, out) layout the
//     wrapper passes, in the order the consumers walk them and across layer
//     boundaries (Cursor). Producer thread (k2, nq) copies rows 2k2, 2k2 + 1
//     x columns 4nq .. 4nq+3 of a tile into a raw stage of its own by
//     cp.async (16-byte copies where the layer's width allows, 4-byte copies
//     otherwise), kRawStages - 1 tiles ahead, then splits what it copied
//     into TF32 hi and lo copies in the K-major core-matrix layout wgmma
//     reads, in a ring of kStages split stages. No producer thread reads
//     another's copies, so the producers need no barrier of their own. Two
//     producer warps share each SM sub-partition, so one's latency hides
//     behind the other's work. Each split stage has a full mbarrier (the
//     producers' 256 threads arrive after their stores and a proxy fence)
//     and an empty one (each consumer warp arrives once its products have
//     read the stage). Each tile is read from L2 once per 128 points.
//   * No barrier inside a layer: a consumer waits only for its stage, and
//     its write-back, the skip's rescale and x columns, the save-mode copy
//     and the final coalesced store touch only its own rows, behind a
//     128-thread named barrier. So the two consumers drift out of phase: one
//     flushes its partial sums and splits its next A fragments while the
//     other's products run. Tiles are 16 inputs deep because each costs a
//     stage wait, a wait for the tensor cores and a flush of the partial.
//   * Ragged K and N (39, 217, 259, 289, 3): weight rows and columns outside
//     (K, N) land as zeros and activation columns are zero-padded to a
//     multiple of 8; the point tail is masked, never padded in memory.
//   * Bias, ReLU and the final tanh / sigmoid are fused into the epilogues.
//     The last layer walks its chunks of 256 outputs last-first: earlier
//     chunks write from registers to the (points, N) output, and the final
//     one (outputs 0..255) goes through the consumer's then free rows of the
//     activation buffer so that the output rows are written with coalesced
//     stores.
//   * The input tile lands by cp.async; the skip's x columns are loaded with
//     16 loads in flight per lane. Index loops run warps over rows and lanes
//     over columns, so they need no integer division.
//   * Activation-save mode (training, the kSave instantiation): each hidden
//     layer's post-ReLU output goes from the consumer's rows of the shared
//     activation tile to `acts` by the TMA's bulk asynchronous copy, issued
//     by one thread of the consumer after the named barrier that completes
//     its write-back (the writers first fence the generic proxy against the
//     async one). The tensor cores start the next layer while the copy
//     drains; the thread waits on cp.async.bulk.wait_group.read only where
//     its rows are next overwritten: before the next write-back's barrier,
//     and before the skip layer scales them in place. `acts` is layer-major,
//     (hidden layers, points, kActLd), so that a consumer's 64 rows of one
//     layer are one contiguous run in both places and ONE copy (the columns
//     past the layer's width carry whatever the tile held there and are
//     never read). The copies carry an L2 evict-first hint, so the ~2 GB a
//     fine VF pass saves does not push the weight tiles, which every block
//     reads, out of the L2. The copy runs from shared memory, never from the
//     accumulator registers; the no-save instantiation (eval) has no copy
//     code at all.
//   * Schedules. With 128 points per block (one block per SM at a time) a
//     grid whose last round is partial pays a whole round for it: the
//     step's shell and ball launches (160 blocks on 132 SMs: 2 rounds for
//     1.2 rounds of work), the fine VF and colour launches (1600 blocks:
//     12 rounds and 16 blocks), the render's coarse launch (800 blocks).
//     A 64-point split block (kSplit) splits each chunk's outputs between
//     the consumers (consumer w computes half w, both read the same 64
//     activation rows, each split stage holds both halves), so it does half
//     the k-steps; its consumers share their rows, so they meet at a
//     256-thread named barrier at each write-back, never inside a layer.
//     One launch mixes them: its first blocks128 blocks take 128 points,
//     the rest 64, so the partial last round runs as cheaper split blocks;
//     the wrapper picks blocks128 (ops/fused_mlp.py::blocks_of_128).
// Clusters with a TMA multicast of each weight tile, and 16-byte copies of
// the ragged widths, are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                         // consumer warpgroups
constexpr int kProducers = 2;                         // producer warpgroups
constexpr int kThreads = (kConsumers + kProducers) * kWarpgroup;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 224;  // 256 x 32 + 256 x 224 = 512 x 128
constexpr int kChunkN = 256;                // outputs held per pass
constexpr int kHalfN = 128;                 // outputs per wgmma
constexpr int kTileK = 16;                  // weight rows per tile: 2 k-steps
constexpr int kStages = 3;                  // split (hi, lo) stages
constexpr int kRawStages = 3;               // raw copies per producer thread
constexpr int kActLd = 300;                 // activation pitch, 12 mod 32
constexpr int kMaxWidth = 296;              // widest input the pitch holds
constexpr int kRaw = kTileK * kHalfN;       // floats per raw half tile

// Points per block: 128 (each consumer 64 points, both output halves in
// turn), or 64 with the outputs split between the consumers.
template <bool kSplit>
__host__ __device__ constexpr int tile_p() { return kSplit ? 64 : 128; }

// Dynamic shared memory: the activation tile, the split stages (hi and lo
// of both halves when split) and the raw stages.
template <bool kSplit>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(tile_p<kSplit>() * kActLd +
                  (kSplit ? 2 : 1) * (kStages * 2 + kRawStages) * kRaw) *
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's cp.async groups but the newest n have landed.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
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

// Named barriers, with immediate ids (a register id makes ptxas reserve all
// 16): 1 and 2 for consumer 0's and 1's 128 threads, 3 for both consumers.
// Barrier 0 is __syncthreads'.
template <bool kSplit>
__device__ __forceinline__ void sync_rows(int consumer) {
  if (kSplit) {
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  } else if (consumer == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
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

// Weight tiles of one block, in the order the consumers walk them.
template <bool kSplit>
__device__ __forceinline__ int count_tiles(const MlpDesc& d) {
  int n_tiles = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    for (int n0 = 0; n0 < d.n[l]; n0 += kChunkN) {
      n_tiles += (kSplit ? 1 : halves(d.n[l], n0)) *
                 (round_up(d.k[l], kTileK) / kTileK);
    }
  }
  return n_tiles;
}

// Position of the weight tile the producer copies next: layer, first output
// of the chunk, half, first input row. Tiles go layer by layer, chunk by
// chunk, half by half (split: both halves in one tile), k-step by k-step:
// the order the consumers walk them.
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

// Producer thread (k2, nq) copies rows 2k2, 2k2 + 1, columns 4nq .. 4nq + 3
// of each half of the tile at `c` into the raw stage (zero outside (K, N);
// split: the second half at raw + kRaw).
template <bool kSplit>
__device__ __forceinline__ void copy_tile(const Cursor<kSplit>& c,
                                          const MlpDesc& d, float* raw,
                                          int k2, int nq) {
  const float* __restrict__ W = d.w[c.layer];
  const int K = d.k[c.layer], N = d.n[c.layer];
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
#pragma unroll
  for (int h = 0; h < (kSplit ? 2 : 1); ++h) {
    const int col = c.n0 + (kSplit ? h : c.half) * kHalfN + 4 * nq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gk = c.k0 + 2 * k2 + i;
      const float* row = W + (size_t)gk * N + col;
      const uint32_t dst =
          smem_u32(raw + h * kRaw + (2 * k2 + i) * kHalfN + 4 * nq);
      if (vec) {
        const bool ok = gk < K && col < N;
        cp_async16(dst, ok ? row : W, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = gk < K && col + j < N;
          cp_async4(dst + 4 * j, ok ? row + j : W, ok ? 4 : 0);
        }
      }
    }
  }
}

// Split what producer thread (k2, nq) copied of one half (rows 2k2, 2k2 + 1,
// columns 4nq .. 4nq + 3) into TF32 hi and lo copies in the K-major
// core-matrix layout of b_desc: inputs 4kc .. 4kc + 3 of output n are 16
// contiguous bytes, of which this thread stores the 8 of its two rows per
// copy. The thread takes its columns starting from `r` (see produce), so
// that neither its loads nor its stores conflict on a bank.
__device__ __forceinline__ void split_tile(const float* raw, float* hi,
                                           float* lo, int k2, int nq, int r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = 4 * nq + ((c + r) & 3);
    const float* src = raw + 2 * k2 * kHalfN + n;
    float2 h, l;
    uint32_t a, b;
    split(src[0], a, b);
    h.x = __uint_as_float(a);
    l.x = __uint_as_float(b);
    split(src[kHalfN], a, b);
    h.y = __uint_as_float(a);
    l.y = __uint_as_float(b);
    const int at = ((n / 8) * 4 + k2 / 2) * 32 + (n % 8) * 4 + 2 * (k2 & 1);
    *reinterpret_cast<float2*>(hi + at) = h;
    *reinterpret_cast<float2*>(lo + at) = l;
  }
}

// The producer warpgroups: every weight tile of the block, copied
// kRawStages - 1 tiles ahead, split into the stage the consumers released.
// Lane l of producer warp pw takes rows 2k2, 2k2 + 1 (k2 = 2 (pw / 2) +
// l % 2) and columns 4nq .. 4nq + 3 (nq = l / 2 % 8 + 8 (l / 16 + 2 (pw % 2)))
// of every tile, starting from column r = (l / 4 + 2 (l % 2) + l / 16) % 4
// of its four: the 16 lanes of a half warp store 8-byte pairs to 16
// different bank pairs, and the 32 lanes of a warp load from 32 different
// banks.
template <bool kSplit>
__device__ __forceinline__ void produce(const MlpDesc& d, float* stages,
                                        float* raw, uint64_t* full,
                                        uint64_t* empty, int ptid) {
  constexpr int kHalves = kSplit ? 2 : 1;
  const int pw = ptid / 32, l = ptid % 32;
  const int k2 = 2 * (pw >> 1) + (l & 1);
  const int nq = ((l >> 1) & 7) + 8 * ((l >> 4) + 2 * (pw & 1));
  const int r = (((l >> 2) & 3) + 2 * (l & 1) + (l >> 4)) & 3;
  const int n_tiles = count_tiles<kSplit>(d);
  Cursor<kSplit> c{0, last_chunk(d.n[0]), 0, 0};
#pragma unroll
  for (int t = 0; t < kRawStages - 1; ++t) {
    if (t < n_tiles) {
      copy_tile(c, d, raw + t * kHalves * kRaw, k2, nq);
      c.advance(d);
    }
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ahead = tile + kRawStages - 1;
    if (ahead < n_tiles) {
      copy_tile(c, d, raw + (ahead % kRawStages) * kHalves * kRaw, k2, nq);
      c.advance(d);
    }
    cp_async_commit();
    cp_async_wait<kRawStages - 1>();  // this thread's copies of `tile`
    const int s = tile % kStages;
    // The consumers released the stage's previous tile (the first round
    // passes at once).
    mbar_wait(smem_u32(&empty[s]), ((tile / kStages) & 1) ^ 1);
    const float* src = raw + (tile % kRawStages) * kHalves * kRaw;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float* dst = stages + (s * kHalves + h) * 2 * kRaw;
      split_tile(src + h * kRaw, dst, dst + kRaw, k2, nq, r);
    }
    fence_async_shared();  // read next by wgmma
    mbar_arrive(smem_u32(&full[s]));
  }
}

// The skip's x columns: act[p][c0 + j] = x[p_base + p][j] * scale for the
// `span` columns j of rows p = p0, p0 + kRowStep, ... (kRowsPerWarp of
// them), zero for j >= in_dim and past the point tail, with all of a lane's
// loads in flight.
template <int kRowsPerWarp, int kRowStep>
__device__ __forceinline__ void load_x_scaled(float* act,
                                              const float* __restrict__ x,
                                              int c0, int span, int in_dim,
                                              int p_base, int n_points,
                                              float scale, int p0, int lane) {
  for (int j = lane; j < span; j += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int gp = p_base + p0 + kRowStep * r;
      v[r] = (j < in_dim && gp < n_points)
                 ? __ldg(x + (size_t)gp * in_dim + j) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      act[(p0 + kRowStep * r) * kActLd + c0 + j] = v[r] * scale;
    }
  }
}

__device__ __forceinline__ float final_act(float v, int act) {
  if (act == 1) return tanhf(v);
  if (act == 2) return 1.f / (1.f + expf(-v));
  return v;
}

// A warpgroup's 64 x 128 half (outputs h0 .. h0 + 127 of the chunk) plus
// bias (`bias`: the chunk's, zero past N), through ReLU (hidden) or the
// final activation (last), into the activation buffer at column h0 + output.
__device__ __forceinline__ void half_to_act(const float (&v)[64], float* act,
                                            const float* bias, int h0,
                                            int row, int t, bool last,
                                            int fin) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 b = *reinterpret_cast<const float2*>(bias + h0 + 8 * i +
                                                      2 * t);
    const float b0 = b.x, b1 = b.y;
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

// Consumer warpgroup `w` of a block of kTileP points from p_base, through
// every layer. kSave: also copy each hidden layer's output to d.acts (bulk
// copies); kSplit: 64 points, the consumers splitting each chunk's outputs
// (see the head comment).
template <bool kSave, bool kSplit>
__device__ __forceinline__ void consume(const float* __restrict__ x,
                                        float* __restrict__ out,
                                        int n_points, int in_dim,
                                        const MlpDesc& d, int p_base,
                                        float* act, const float* stages,
                                        float* bias, uint64_t* full,
                                        uint64_t* empty, int w, int ctid) {
  constexpr int kHalves = kSplit ? 2 : 1;        // output halves per tile
  // The rows this consumer reads and writes: its own 64, or (split) the
  // block's 64, which both consumers share; its warps take rows
  // p0, p0 + kRowStep, ... of them.
  constexpr int kRowStep = kSplit ? 8 : 4;
  constexpr int kRowsPerWarp = 64 / kRowStep;
  const int lane = ctid % 32, cwarp = ctid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = kSplit ? 0 : 64 * w;
  const int p0 = row0 + (kSplit ? 4 * w : 0) + cwarp;
  const int row = row0 + cwarp * 16 + g;          // fragment row
  // The one thread that copies the rows in save mode.
  const bool copier = ctid == 0 && (!kSplit || w == 0);
  // 1/sqrt(2) in f32: PyTorch's CUDA division by a scalar multiplies by
  // the reciprocal too (within 1 ulp of dividing).
  const float kRsqrt2 = 0.70710678118654752f;

  // Input rows by cp.async, zero past the point tail and up to a multiple of
  // 8 features.
  {
    const int cols = round_up(in_dim, 8);
    for (int j = lane; j < cols; j += 32) {
#pragma unroll 4
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int p = p0 + kRowStep * r, gp = p_base + p;
        const bool ok = j < in_dim && gp < n_points;
        cp_async4(smem_u32(act + p * kActLd + j),
                  ok ? x + (size_t)gp * in_dim + j : x, ok ? 4 : 0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  sync_rows<kSplit>(w);

  float hold[64], acc[64], part[64];  // hold: unused when split
  int s = 0, phase = 0;  // the next tile's split stage and its parity
  int width = in_dim;
  for (int layer = 0; layer < d.n_layers; ++layer) {
    if (layer == d.skip_at) {
      if (kSave) {
        // The previous layer's copy reads the columns scaled here.
        if (copier) bulk_wait_read();
        sync_rows<kSplit>(w);
      }
      // concat([h, x]) / sqrt(2), in place.
      for (int p = p0; p < row0 + 64; p += kRowStep) {
        for (int k = lane; k < width; k += 32) act[p * kActLd + k] *= kRsqrt2;
      }
      load_x_scaled<kRowsPerWarp, kRowStep>(
          act, x, width, round_up(width + in_dim, 8) - width, in_dim, p_base,
          n_points, kRsqrt2, p0, lane);
      width += in_dim;
      sync_rows<kSplit>(w);
    }

    const int K = d.k[layer], N = d.n[layer];
    const float* __restrict__ B = d.b[layer];
    const bool last = layer == d.n_layers - 1;
    // Outputs 0 .. kChunkN - 1 of the bias (zero past N), read by the
    // write-back: in flight while the layer's products run. The previous
    // write-back's reads are behind the barrier that ended it.
#pragma unroll
    for (int j = 0; j < kChunkN / kWarpgroup; ++j) {
      const int n = ctid + j * kWarpgroup;
      cp_async4(smem_u32(bias + n), n < N ? B + n : B, n < N ? 4 : 0);
    }

    for (int n0 = last_chunk(N); n0 >= 0; n0 -= kChunkN) {
      const int nh = halves(N, n0);
      for (int half = 0; half < (kSplit ? 1 : nh); ++half) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int k0 = 0; k0 < K; k0 += kTileK) {
          // This consumer's split tile: half w when split.
          const float* sb =
              stages + (s * kHalves + (kSplit ? w : 0)) * 2 * kRaw;
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
          mbar_wait(smem_u32(&full[s]), phase);
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
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs(part);
          // This warp's products have read the stage.
          if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
        }
        if (!kSplit && half == 0 && nh == 2) {
#pragma unroll
          for (int i = 0; i < 64; ++i) hold[i] = acc[i];
        }
      }

      if (!last || n0 == 0) {
        // A hidden layer (N <= kChunkN), or the last layer's final chunk:
        // every warp sharing the rows is done reading this layer's input,
        // so the output replaces it, zero from N up to the half's end
        // (weights and bias there are zero). In save mode the previous
        // layer's copy must have read the rows first.
        if (kSave && copier) bulk_wait_read();
        asm volatile("cp.async.wait_all;\n" ::: "memory");  // the bias
        sync_rows<kSplit>(w);
        if (kSplit) {
          half_to_act(acc, act, bias, w * kHalfN, row, t, last, d.final_act);
        } else if (nh == 2) {
          half_to_act(hold, act, bias, 0, row, t, last, d.final_act);
          half_to_act(acc, act, bias, kHalfN, row, t, last, d.final_act);
        } else {
          half_to_act(acc, act, bias, 0, row, t, last, d.final_act);
        }
        if (kSave && !last) fence_async_shared();  // read by the copy
        sync_rows<kSplit>(w);
        if (last) {
          // Coalesced rows of the (points, N) output, outputs 0..nc-1.
          const int nc = min(N, kChunkN);
          for (int p = p0; p < row0 + 64 && p_base + p < n_points;
               p += kRowStep) {
            float* orow = out + (size_t)(p_base + p) * N;
            for (int n = lane; n < nc; n += 32) orow[n] = act[p * kActLd + n];
          }
        } else if (kSave && copier) {
          // This hidden layer's rows of the consumer, as one copy.
          const int rows = min(64, n_points - p_base - row0);
          if (rows > 0) {
            bulk_store(
                d.acts + ((size_t)layer * n_points + p_base + row0) * kActLd,
                smem_u32(act + row0 * kActLd),
                rows * kActLd * (int)sizeof(float));
            bulk_commit();
          }
        }
      } else {
        // An earlier chunk of the last layer: straight from registers.
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gp = p_base + row + (e >> 1) * 8;
            const int n = n0 + (kSplit ? w * kHalfN : 0) + 8 * i + 2 * t +
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
  // Every copy has read the rows before the block's shared memory goes.
  if (kSave && copier) bulk_wait_read();
}

// The shared memory of a block of tile_p<kSplit>() points.
template <bool kSplit>
struct Smem {
  float* act;     // tile_p x kActLd
  float* stages;  // kStages x halves x (hi, lo) x kRaw
  float* raw;     // kRawStages x halves x kRaw

  __device__ __forceinline__ explicit Smem(float* base)
      : act(base),
        stages(base + tile_p<kSplit>() * kActLd),
        raw(stages + kStages * (kSplit ? 2 : 1) * 2 * kRaw) {}
};

// Blocks 0 .. blocks128 - 1 take 128 points each; the points after them
// go in 64-point split blocks, which the card starts last (the schedule).
// Warpgroups 0 and 1 consume, 2 and 3 produce; the role branch is the
// outermost, so that each path keeps the register count its setmaxnreg set.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n_points, int in_dim, const __grid_constant__ MlpDesc d,
                 int blocks128) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  __shared__ uint64_t full[kStages], empty[kStages];
  // Each consumer's copy of the current layer's bias (kChunkN outputs).
  __shared__ __align__(16) float bias[kConsumers][kChunkN];
  const int tid = threadIdx.x, b = blockIdx.x;
  const bool split_block = b >= blocks128;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers * kWarpgroup);  // producer threads
      mbar_init(&empty[s], kConsumers * kWarpgroup / 32);  // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, read from lane 0 so that the compiler sees it uniform
  // over each warp: wgmma on a path it takes for divergent is serialised.
  const int wg = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0);
  if (wg >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int ptid = tid - kConsumers * kWarpgroup;
    if (!split_block) {
      const Smem<false> sm(base);
      produce<false>(d, sm.stages, sm.raw, full, empty, ptid);
    } else {
      const Smem<true> sm(base);
      produce<true>(d, sm.stages, sm.raw, full, empty, ptid);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int ctid = tid % kWarpgroup;
    if (!split_block) {
      const Smem<false> sm(base);
      consume<kSave, false>(x, out, n_points, in_dim, d,
                            b * tile_p<false>(), sm.act, sm.stages, bias[wg],
                            full, empty, wg, ctid);
    } else {
      const Smem<true> sm(base);
      consume<kSave, true>(x, out, n_points, in_dim, d,
                           blocks128 * tile_p<false>() +
                               (b - blocks128) * tile_p<true>(),
                           sm.act, sm.stages, bias[wg], full, empty, wg,
                           ctid);
    }
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
