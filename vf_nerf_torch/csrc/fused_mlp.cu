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
// input and output per point, so a render is ~320 GFLOP and ~0.3 GB: far
// above the f32 ridge point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).
//
// Design. The TPU kernel kept all weights in VMEM; the ~3.2 MB of f32 weights
// do not fit in 227 KB of shared memory, so here only the activation tile
// lives in shared memory and the weights stream from global memory (they sit
// in the 50 MB L2) layer by layer, through a double-buffered 16 x 128 tile.
//   * A block of 256 threads owns 64 points. Two ping-pong activation buffers
//     hold the tile TRANSPOSED (row k = feature, 64 points per row), so a
//     thread reads its 4 points of one feature as one float4.
//   * Each thread accumulates a 4-point x 8-output register tile with f32 FMA;
//     the 16 x 16 threads cover 64 points x 128 outputs per pass, and a layer
//     walks its outputs in passes of 128. A thread's 8 outputs are two runs
//     of 4 (columns 4*tx and 64 + 4*tx), so the 16 threads of a row read the
//     weight tile as consecutive float4s, free of bank conflicts.
//   * Ragged K and N (39, 217, 259, 289, 3) are handled by zero-filling the
//     weight tile and the activation rows up to the next multiple of 16; the
//     point tail is masked, never padded in memory.
//   * At the skip layer the embedded input is re-read from global memory into
//     the rows after h, and the whole row is divided by sqrt(2).
//   * Bias, ReLU and the final tanh / sigmoid are fused into the epilogue; the
//     last layer writes straight from registers to the (points, N) output.
// Tensor cores (TF32 / bf16 wgmma) and TMA are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;
constexpr int kTileP = 64;    // points per block
constexpr int kTileN = 128;   // outputs per pass
constexpr int kChunkK = 16;   // input rows per weight stage
constexpr int kTM = 4;        // points per thread
constexpr int kTN = 8;        // outputs per thread: two runs of 4
constexpr int kHalfN = kTileN / 2;
constexpr int kWStage = kChunkK * kTileN;

struct MlpDesc {
  const float* w[kMaxLayers];  // (K, N) row-major: in x out
  const float* b[kMaxLayers];  // (N,)
  int k[kMaxLayers];
  int n[kMaxLayers];
  int n_layers;
  int skip_at;    // -1: no skip
  int final_act;  // 0 none, 1 tanh, 2 sigmoid
  int rows;       // rows of each activation buffer, a multiple of kChunkK
};

__device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Stage i of the weight tile: thread-strided 16 x 128 block of W starting at
// (k0, n0), zero outside (K, N).
__device__ __forceinline__ void load_w_regs(float (&r)[kWStage / kThreads],
                                            const float* __restrict__ w,
                                            int K, int N, int k0, int n0,
                                            int tid) {
#pragma unroll
  for (int s = 0; s < kWStage / kThreads; ++s) {
    const int i = tid + s * kThreads;
    const int gk = k0 + i / kTileN;
    const int gn = n0 + i % kTileN;
    r[s] = (gk < K && gn < N) ? __ldg(w + (size_t)gk * N + gn) : 0.f;
  }
}

__device__ __forceinline__ void store_w_regs(
    const float (&r)[kWStage / kThreads], float* tile, int tid) {
#pragma unroll
  for (int s = 0; s < kWStage / kThreads; ++s) tile[tid + s * kThreads] = r[s];
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n_points, int in_dim, MlpDesc d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* src = smem;                             // rows x kTileP
  float* dst = smem + d.rows * kTileP;           // rows x kTileP
  float* wtile = smem + 2 * d.rows * kTileP;     // 2 x kChunkK x kTileN

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output group: 4*tx .. +3 and 64 + 4*tx .. +3
  const int ty = tid / 16;  // point group: points ty*4 .. ty*4+3
  const int p_base = blockIdx.x * kTileP;
  const float kSqrt2 = 1.41421356237309515f;

  // Input tile, transposed, zero rows up to the next multiple of kChunkK.
  {
    const int in_rows = round_up(in_dim, kChunkK);
    for (int i = tid; i < in_rows * kTileP; i += kThreads) {
      const int p = i / in_rows, k = i % in_rows;
      const int gp = p_base + p;
      src[k * kTileP + p] =
          (k < in_dim && gp < n_points) ? x[(size_t)gp * in_dim + k] : 0.f;
    }
  }
  __syncthreads();

  int width = in_dim;
  for (int layer = 0; layer < d.n_layers; ++layer) {
    if (layer == d.skip_at) {
      // concat([h, x]) / sqrt(2), in place in src.
      for (int i = tid; i < width * kTileP; i += kThreads) src[i] /= kSqrt2;
      const int span = round_up(width + in_dim, kChunkK) - width;
      for (int i = tid; i < span * kTileP; i += kThreads) {
        const int p = i / span, j = i % span;
        const int gp = p_base + p;
        src[(width + j) * kTileP + p] =
            (j < in_dim && gp < n_points)
                ? x[(size_t)gp * in_dim + j] / kSqrt2 : 0.f;
      }
      width += in_dim;
      __syncthreads();
    }

    const int K = d.k[layer], N = d.n[layer];
    const float* __restrict__ W = d.w[layer];
    const float* __restrict__ B = d.b[layer];
    const bool last = layer == d.n_layers - 1;
    const int k_chunks = round_up(K, kChunkK) / kChunkK;
    const int n_rows = round_up(N, kChunkK);

    for (int n0 = 0; n0 < N; n0 += kTileN) {
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

      float wreg[kWStage / kThreads];
      load_w_regs(wreg, W, K, N, 0, n0, tid);
      store_w_regs(wreg, wtile, tid);
      __syncthreads();

      for (int c = 0; c < k_chunks; ++c) {
        const bool more = c + 1 < k_chunks;
        if (more) load_w_regs(wreg, W, K, N, (c + 1) * kChunkK, n0, tid);
        const float* wt = wtile + (c & 1) * kWStage;
        const float* a_rows = src + c * kChunkK * kTileP + ty * kTM;
#pragma unroll
        for (int kk = 0; kk < kChunkK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(a_rows + kk * kTileP);
          const float4 w0 =
              *reinterpret_cast<const float4*>(wt + kk * kTileN + tx * 4);
          const float4 w1 = *reinterpret_cast<const float4*>(
              wt + kk * kTileN + kHalfN + tx * 4);
          const float av[kTM] = {a.x, a.y, a.z, a.w};
          const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
        if (more) store_w_regs(wreg, wtile + ((c + 1) & 1) * kWStage, tid);
        __syncthreads();
      }

      // Epilogue: bias, then ReLU into the next buffer (zero rows past N up
      // to n_rows), or the final activation straight to global memory.
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + (j < 4 ? 0 : kHalfN - 4) + tx * 4 + j;
        const float bias = n < N ? __ldg(B + n) : 0.f;
        if (!last) {
          if (n < n_rows) {
            float4 v;
            v.x = n < N ? fmaxf(acc[0][j] + bias, 0.f) : 0.f;
            v.y = n < N ? fmaxf(acc[1][j] + bias, 0.f) : 0.f;
            v.z = n < N ? fmaxf(acc[2][j] + bias, 0.f) : 0.f;
            v.w = n < N ? fmaxf(acc[3][j] + bias, 0.f) : 0.f;
            *reinterpret_cast<float4*>(dst + n * kTileP + ty * kTM) = v;
          }
        } else if (n < N) {
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int gp = p_base + ty * kTM + i;
            if (gp >= n_points) continue;
            float v = acc[i][j] + bias;
            if (d.final_act == 1) {
              v = tanhf(v);
            } else if (d.final_act == 2) {
              v = 1.f / (1.f + expf(-v));
            }
            out[(size_t)gp * N + n] = v;
          }
        }
      }
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
    width = N;
  }
}

}  // namespace

extern "C" {

// Largest activation width (in features) the kernel's shared memory holds.
int vfn_fused_mlp_max_width() {
  return ((232448 / 4 - 2 * kWStage) / (2 * kTileP)) / kChunkK * kChunkK;
}

// Launch on `stream`. `weights` and `biases` are HOST arrays of device
// pointers, `k_dims` / `n_dims` host arrays of the layer widths. Returns the
// CUDA error code of the configuration and the launch (0 on success).
int vfn_fused_mlp(const float* x, float* out, int n_points, int in_dim,
                  const float* const* weights, const float* const* biases,
                  const int* k_dims, const int* n_dims, int n_layers,
                  int skip_at, int final_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  MlpDesc d;
  int widest = in_dim;
  for (int i = 0; i < n_layers; ++i) {
    d.w[i] = weights[i];
    d.b[i] = biases[i];
    d.k[i] = k_dims[i];
    d.n[i] = n_dims[i];
    widest = widest > k_dims[i] ? widest : k_dims[i];
    widest = widest > n_dims[i] ? widest : n_dims[i];
  }
  d.n_layers = n_layers;
  d.skip_at = skip_at;
  d.final_act = final_act;
  d.rows = (widest + kChunkK - 1) / kChunkK * kChunkK;
  if (d.rows > vfn_fused_mlp_max_width()) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)d.rows * kTileP + 2 * kWStage) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_points + kTileP - 1) / kTileP;
  fused_mlp_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, n_points, in_dim, d);
  return (int)cudaGetLastError();
}

const char* vfn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
