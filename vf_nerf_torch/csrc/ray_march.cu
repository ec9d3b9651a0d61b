// Fused ray march for sm_90a: windowed cosine -> Laplace density ->
// back-face suppression -> VolSDF weights -> composite, one block per ray.
//
// Replaces the TPU kernel vf_nerf_tpu/ops/ray_march.py::fused_ray_march
// (kernel body _ray_march_kernel), with the same semantics:
//   * the density scalars are clamped as get_beta / get_scale / get_mean do
//     (beta to its bounds, scale to max(|scale|, scale_min), mean to its
//     bounds), and the window taps are normalised (centre signed, neighbours
//     |w|, all / sum|w|): both in the block's prologue, from the raw
//     parameters, so a call is one launch;
//   * consecutive cosine cs[j] = cos(n_j, n_{j+1}) for j < L = S - 1;
//   * on the interior [start, L - start), start = (W + 1) / 2 + 1, the
//     window cs[j] * c[mid] + sum_i cos(n_j, n_{j+1+i}) c[mid+i]
//     + cos(n_j, n_{j-i}) c[mid-i], i = 1 .. start-2; the edges keep the raw
//     cosine;
//   * sigma = max(scale * LaplaceCDF(-cos - mean; beta) - cdf(cutoff), 0),
//     zeroed where cos(n_j, d) < th and the windowed cos < 0; sigma_last = 0;
//   * free energy = (z_{j+1} - z_j) * sigma (last distance 1e10), exclusive
//     prefix sum -> transmittance, weight = (1 - exp(-fe)) * T, optionally
//     divided by (sum + 1e-5);
//   * rgb = sum w * c (+ 1 - sum w on a white background), depth = sum w * z;
//     with no rgb samples (the coarse pass) only the weights are written.
//
// What bounds it on the H100: bytes. It reads R*S*7 + R*3 floats and writes
// R*S + R*4; at R = 1024, S = 100 / 130 that is 3.3 / 4.3 MB, about 1 us at
// 3.35 TB/s. The work per ray is a short serial chain (stage, scan,
// composite), so what the card needs is many rays in flight at once.
//
// Design. A block of 128 threads owns one ray, so a 1024-ray call puts ~31
// warps on each SM in one wave. The block stages the ray's normals and depths
// in shared memory (with 16-byte loads over the aligned part of each row),
// so every window tap and neighbour depth is a shared-memory read and the
// field tensors are read from global memory once, in their unpadded
// (R, S, 3) layout. Threads take one sample each per chunk of 128; the
// transmittance is a block scan (warp shuffles, then the warps' totals) with
// the running sum carried between chunks. S is at most kMaxSamples (1024),
// 24 KB of shared memory.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;        // one block per ray
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSamples = 1024;
constexpr int kMaxTaps = 64;
constexpr float kEps = 1e-8f;        // torch F.cosine_similarity eps
constexpr unsigned kFull = 0xffffffffu;

struct MarchBounds {
  float beta_lo, beta_hi, scale_min, mean_lo, mean_hi, cutoff, th;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// dst[0:n] = src[0:n] by the whole block: scalar loads up to the first
// 16-byte boundary of src, float4 loads after it, scalar loads for the tail.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  const int head = min(
      n, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const int n4 = (n - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = __ldg(s4 + i);
    float* d = dst + head + 4 * i;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads) {
    dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
ray_march_kernel(const float* __restrict__ normals,   // (R, S, 3)
                 const float* __restrict__ dirs,      // (R, 3)
                 const float* __restrict__ z_vals,    // (R, S)
                 const float* __restrict__ rgb,       // (R, S, 3) or null
                 const float* __restrict__ raw_beta,  // 0-d
                 const float* __restrict__ raw_scale,
                 const float* __restrict__ raw_mean,
                 const float* __restrict__ window,    // (n_taps,) raw taps
                 int n_taps, MarchBounds bnd,
                 float* __restrict__ rgb_out,         // (R, 3) or null
                 float* __restrict__ depth_out,       // (R,) or null
                 float* __restrict__ w_out,           // (R, S)
                 int S, int normalize, int white_background) {
  extern __shared__ float smem[];
  __shared__ float coef[kMaxTaps];
  __shared__ float scal[4];                  // beta scale mean cdf(cutoff)
  __shared__ float part[5][kWarps];          // per-warp partial sums

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ray = blockIdx.x;
  float* nrm = smem;         // 3S normals
  float* nn = nrm + 3 * S;   // S clamped norms
  float* zs = nn + S;        // S depths
  float* ws = zs + S;        // S unnormalized weights

  if (warp == 0) {
    // Taps: centre signed, neighbours |w|, all / sum|w|.
    const float w0 = lane < n_taps ? window[lane] : 0.f;
    const float w1 = lane + 32 < n_taps ? window[lane + 32] : 0.f;
    const float total = warp_sum(fabsf(w0) + fabsf(w1));
    const int middle = (n_taps - 1) / 2;
    if (lane < n_taps) coef[lane] = (lane == middle ? w0 : fabsf(w0)) / total;
    if (lane + 32 < n_taps) {
      coef[lane + 32] = (lane + 32 == middle ? w1 : fabsf(w1)) / total;
    }
    if (lane == 0) {
      const float beta = fminf(fmaxf(*raw_beta, bnd.beta_lo), bnd.beta_hi);
      const float scale = fmaxf(fabsf(*raw_scale), bnd.scale_min);
      const float mean = fminf(fmaxf(*raw_mean, bnd.mean_lo), bnd.mean_hi);
      const float centered = bnd.cutoff - mean;
      const float sgn = centered > 0.f ? 1.f : (centered < 0.f ? -1.f : 0.f);
      scal[0] = beta;
      scal[1] = scale;
      scal[2] = mean;
      scal[3] = scale *
                (0.5f + 0.5f * sgn * (1.f - expf(-fabsf(centered) / beta)));
    }
  }
  stage(nrm, normals + (size_t)ray * S * 3, 3 * S);
  stage(zs, z_vals + (size_t)ray * S, S);
  __syncthreads();
  for (int j = tid; j < S; j += kThreads) {
    const float x = nrm[3 * j], y = nrm[3 * j + 1], z = nrm[3 * j + 2];
    nn[j] = fmaxf(sqrtf(x * x + y * y + z * z), kEps);
  }
  __syncthreads();

  const float beta = scal[0], scale = scal[1], mean = scal[2];
  const float cdf_cut = scal[3], th = bnd.th;
  const float dx = dirs[ray * 3], dy = dirs[ray * 3 + 1], dz = dirs[ray * 3 + 2];
  const float dnorm = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), kEps);

  const int L = S - 1;
  const int start = (n_taps + 1) / 2 + 1;
  const int middle = (n_taps - 1) / 2;
  const int hi = L - start;
  const bool windowed = hi > start;

  auto cos_pair = [&](int a, int b) {
    const float dot = nrm[3 * a] * nrm[3 * b] + nrm[3 * a + 1] * nrm[3 * b + 1] +
                      nrm[3 * a + 2] * nrm[3 * b + 2];
    return dot / (nn[a] * nn[b]);
  };

  float carry = 0.f;  // free energy of all samples before this chunk
  float wsum = 0.f;
  for (int base = 0; base < S; base += kThreads) {
    const int j = base + tid;
    float fe = 0.f;
    if (j < L) {
      float c = cos_pair(j, j + 1);
      if (windowed && j >= start && j < hi) {
        float acc = c * coef[middle];
        for (int i = 1; i < start - 1; ++i) {
          acc = acc + cos_pair(j, j + 1 + i) * coef[middle + i] +
                cos_pair(j, j - i) * coef[middle - i];
        }
        c = acc;
      }
      const float cos_ray =
          (nrm[3 * j] * dx + nrm[3 * j + 1] * dy + nrm[3 * j + 2] * dz) /
          (nn[j] * dnorm);
      const float centered = -c - mean;
      const float sgn = centered > 0.f ? 1.f : (centered < 0.f ? -1.f : 0.f);
      const float cdf =
          scale * (0.5f + 0.5f * sgn * (1.f - expf(-fabsf(centered) / beta)));
      float sigma = fmaxf(cdf - cdf_cut, 0.f);
      if (cos_ray < th && c < 0.f) sigma = 0.f;
      fe = (zs[j + 1] - zs[j]) * sigma;
    }
    // The last sample has sigma = 0, so its 1e10 distance adds no energy.
    // Block scan: inclusive within the warp, then the earlier warps' totals.
    float incl = fe;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) part[0][warp] = incl;
    __syncthreads();
    float before = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float v = part[0][w];
      if (w < warp) before += v;
      carry += v;
    }
    __syncthreads();  // part is written again below
    if (j < S) {
      const float w = (1.f - expf(-fe)) * expf(-(before + (incl - fe)));
      ws[j] = w;
      wsum += w;
    }
  }

  wsum = warp_sum(wsum);
  if (lane == 0) part[0][warp] = wsum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[0][w];
  const float denom = total + 1e-5f;
  __syncthreads();  // part is written again below

  const bool composite = rgb != nullptr;
  float r = 0.f, g = 0.f, b = 0.f, depth = 0.f, acc_w = 0.f;
  const float* cg = composite ? rgb + (size_t)ray * S * 3 : nullptr;
  for (int j = tid; j < S; j += kThreads) {
    float w = ws[j];
    if (normalize) w = w / denom;
    w_out[(size_t)ray * S + j] = w;
    if (composite) {
      r += w * cg[3 * j];
      g += w * cg[3 * j + 1];
      b += w * cg[3 * j + 2];
      depth += w * zs[j];
      acc_w += w;
    }
  }
  if (!composite) return;
  const float sums[5] = {warp_sum(r), warp_sum(g), warp_sum(b),
                         warp_sum(depth), warp_sum(acc_w)};
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < 5; ++v) part[v][warp] = sums[v];
  }
  __syncthreads();
  if (tid == 0) {
    float tot[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < 5; ++v)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot[v] += part[v][w];
    const float bg = white_background ? 1.f - tot[4] : 0.f;
    rgb_out[ray * 3] = tot[0] + bg;
    rgb_out[ray * 3 + 1] = tot[1] + bg;
    rgb_out[ray * 3 + 2] = tot[2] + bg;
    depth_out[ray] = tot[3];
  }
}

}  // namespace

extern "C" {

int vfn_ray_march_max_samples() { return kMaxSamples; }
int vfn_ray_march_max_taps() { return kMaxTaps; }

// Launch on `stream`; every pointer is a device pointer. `rgb` null is the
// weights-only mode (then `rgb_out` and `depth_out` are not written). The
// density parameters are the raw 0-d tensors; the bounds, cutoff and
// back-face threshold come by value. Returns the CUDA error code of the
// launch (0 on success).
int vfn_ray_march(const float* normals, const float* dirs, const float* z_vals,
                  const float* rgb, const float* raw_beta,
                  const float* raw_scale, const float* raw_mean,
                  const float* window, int n_taps, float beta_lo,
                  float beta_hi, float scale_min, float mean_lo,
                  float mean_hi, float cutoff, float th, float* rgb_out,
                  float* depth_out, float* w_out, int n_rays, int n_samples,
                  int normalize, int white_background, void* stream) {
  if (n_samples < 1 || n_samples > kMaxSamples || n_taps < 1 ||
      n_taps > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  const MarchBounds bnd{beta_lo, beta_hi, scale_min, mean_lo, mean_hi,
                        cutoff, th};
  const size_t smem = (size_t)6 * n_samples * sizeof(float);
  ray_march_kernel<<<n_rays, kThreads, smem, (cudaStream_t)stream>>>(
      normals, dirs, z_vals, rgb, raw_beta, raw_scale, raw_mean, window,
      n_taps, bnd, rgb_out, depth_out, w_out, n_samples, normalize,
      white_background);
  return (int)cudaGetLastError();
}

}  // extern "C"
