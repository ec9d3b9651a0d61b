// Fused ray march for sm_90a: windowed cosine -> Laplace density ->
// back-face suppression -> VolSDF weights -> composite, one warp per ray.
//
// Replaces the TPU kernel vf_nerf_tpu/ops/ray_march.py::fused_ray_march
// (kernel body _ray_march_kernel), with the same semantics:
//   * consecutive cosine cs[j] = cos(n_j, n_{j+1}) for j < L = S - 1;
//   * on the interior [start, L - start), start = (W + 1) / 2 + 1, the
//     window cs[j] * c[mid] + sum_i cos(n_j, n_{j+1+i}) c[mid+i]
//     + cos(n_j, n_{j-i}) c[mid-i], i = 1 .. start-2, with the coefficients
//     c precomputed by the caller (centre signed, neighbours |w|, / sum|w|);
//     the edges keep the raw cosine;
//   * sigma = max(scale * LaplaceCDF(-cos - mean; beta) - cdf(cutoff), 0),
//     zeroed where cos(n_j, d) < th and the windowed cos < 0; sigma_last = 0;
//   * free energy = (z_{j+1} - z_j) * sigma (last distance 1e10), exclusive
//     prefix sum -> transmittance, weight = (1 - exp(-fe)) * T, optionally
//     divided by (sum + 1e-5);
//   * rgb = sum w * c (+ 1 - sum w on a white background), depth = sum w * z.
//
// What bounds it on the H100: bytes. It reads R*S*7 + R*3 floats and writes
// R*S + R*4; at R = 1024, S = 100 / 130 that is 3.3 / 4.3 MB, about 1 us at
// 3.35 TB/s, so at the render's shapes the launch itself is a large share.
//
// Design. One warp owns one ray and stages its normals, depths, norms and
// weights in shared memory (6 * S floats), so every window tap and neighbour
// depth is a shared-memory read and the field tensors are read from global
// memory exactly once, in their unpadded (R, S, 3) layout. Lanes walk the
// samples in chunks of 32; the transmittance is a warp shuffle scan with the
// running sum carried between chunks. The clamped density scalars come
// through a device pointer, so the host never waits on the device.
// S is limited to kMaxSamples (1024) by the shared memory of 4 rays.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;            // rays per block
constexpr int kMaxSamples = 1024;
constexpr int kMaxTaps = 64;
constexpr float kEps = 1e-8f;        // torch F.cosine_similarity eps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
ray_march_kernel(const float* __restrict__ normals,   // (R, S, 3)
                 const float* __restrict__ dirs,      // (R, 3)
                 const float* __restrict__ z_vals,    // (R, S)
                 const float* __restrict__ rgb,       // (R, S, 3)
                 const float* __restrict__ coefs,     // (n_taps,)
                 int n_taps,
                 const float* __restrict__ scalars,   // beta scale mean cdf_cut th
                 float* __restrict__ rgb_out,         // (R, 3)
                 float* __restrict__ depth_out,       // (R,)
                 float* __restrict__ w_out,           // (R, S)
                 int n_rays, int S, int normalize, int white_background) {
  extern __shared__ float smem[];
  __shared__ float coef[kMaxTaps];
  for (int i = threadIdx.x; i < n_taps; i += blockDim.x) coef[i] = coefs[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;  // only warp-level syncs below

  float* nrm = smem + (size_t)warp * 6 * S;  // 3S normals
  float* nn = nrm + 3 * S;                   // S clamped norms
  float* zs = nn + S;                        // S depths
  float* ws = zs + S;                        // S unnormalized weights

  const float* ng = normals + (size_t)ray * S * 3;
  for (int i = lane; i < 3 * S; i += 32) nrm[i] = ng[i];
  for (int j = lane; j < S; j += 32) zs[j] = z_vals[(size_t)ray * S + j];
  __syncwarp();
  for (int j = lane; j < S; j += 32) {
    const float x = nrm[3 * j], y = nrm[3 * j + 1], z = nrm[3 * j + 2];
    nn[j] = fmaxf(sqrtf(x * x + y * y + z * z), kEps);
  }
  __syncwarp();

  const float beta = scalars[0], scale = scalars[1], mean = scalars[2];
  const float cdf_cut = scalars[3], th = scalars[4];
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
  for (int base = 0; base < S; base += 32) {
    const int j = base + lane;
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
    float incl = fe;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const float excl = carry + (incl - fe);
    carry += __shfl_sync(kFull, incl, 31);
    if (j < S) {
      const float w = (1.f - expf(-fe)) * expf(-excl);
      ws[j] = w;
      wsum += w;
    }
  }
  const float denom = warp_sum(wsum) + 1e-5f;

  float r = 0.f, g = 0.f, b = 0.f, depth = 0.f, acc_w = 0.f;
  const float* cg = rgb + (size_t)ray * S * 3;
  for (int j = lane; j < S; j += 32) {
    float w = ws[j];
    if (normalize) w = w / denom;
    w_out[(size_t)ray * S + j] = w;
    r += w * cg[3 * j];
    g += w * cg[3 * j + 1];
    b += w * cg[3 * j + 2];
    depth += w * zs[j];
    acc_w += w;
  }
  r = warp_sum(r);
  g = warp_sum(g);
  b = warp_sum(b);
  depth = warp_sum(depth);
  acc_w = warp_sum(acc_w);
  if (lane == 0) {
    if (white_background) {
      r += 1.f - acc_w;
      g += 1.f - acc_w;
      b += 1.f - acc_w;
    }
    rgb_out[ray * 3] = r;
    rgb_out[ray * 3 + 1] = g;
    rgb_out[ray * 3 + 2] = b;
    depth_out[ray] = depth;
  }
}

}  // namespace

extern "C" {

int vfn_ray_march_max_samples() { return kMaxSamples; }
int vfn_ray_march_max_taps() { return kMaxTaps; }

// Launch on `stream`; every pointer is a device pointer. Returns the CUDA
// error code of the configuration and the launch (0 on success).
int vfn_ray_march(const float* normals, const float* dirs, const float* z_vals,
                  const float* rgb, const float* coefs, int n_taps,
                  const float* scalars, float* rgb_out, float* depth_out,
                  float* w_out, int n_rays, int n_samples, int normalize,
                  int white_background, void* stream) {
  if (n_samples < 1 || n_samples > kMaxSamples || n_taps < 1 ||
      n_taps > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kWarps * 6 * n_samples * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ray_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((size_t)kWarps * 6 * kMaxSamples * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  ray_march_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      normals, dirs, z_vals, rgb, coefs, n_taps, scalars, rgb_out, depth_out,
      w_out, n_rays, n_samples, normalize, white_background);
  return (int)cudaGetLastError();
}

}  // extern "C"
