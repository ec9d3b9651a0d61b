// Fused ray march for sm_90a: windowed cosine -> Laplace density ->
// back-face suppression -> VolSDF weights -> composite, one block per ray,
// and its backward (a reverse scan), one block per ray too.
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
//   * n_valid (static fine growth; n_valid = S masks nothing): the samples
//     from n_valid on are padding. The interior ends at n_valid - 1 - start
//     at the latest, as in an unpadded ray of n_valid samples, and sigma is
//     zero from n_valid - 1 on (the live last sample's sigma_last = 0);
//     the JAX package states this in ops/window.py and get_density;
//   * free energy = (z_{j+1} - z_j) * sigma (last distance 1e10), exclusive
//     prefix sum -> transmittance, weight = (1 - exp(-fe)) * T, optionally
//     divided by (sum + 1e-5);
//   * rgb = sum w * c (+ 1 - sum w on a white background), depth = sum w * z;
//     with no rgb samples (the coarse pass) only the weights are written.
//
// What bounds it on the H100: bytes. The forward reads R*S*7 + R*3 floats
// and writes R*S + R*4; at R = 1024, S = 100 / 200 that is 3.3 / 6.6 MB,
// about 1-2 us at 3.35 TB/s. The backward reads R*S*7 + R*4 (+ R*S with a
// weights gradient) and writes R*S*6 + R*3. The work per ray is a short
// serial chain (stage, scan, composite), so what the card needs is many
// rays in flight at once.
//
// Design. A block of 128 threads owns one ray, so a 1024-ray call puts ~31
// warps on each SM in one wave. The block stages the ray's normals and depths
// in shared memory (with 16-byte loads over the aligned part of each row),
// so every window tap and neighbour depth is a shared-memory read and the
// field tensors are read from global memory once, in their unpadded
// (R, S, 3) layout. Threads take one sample each per chunk of 128; the
// transmittance is a block scan (warp shuffles, then the warps' totals) with
// the running sum carried between chunks. S is at most kMaxSamples (1024).
//
// The backward saves nothing between the passes but the outputs' inputs: it
// recomputes the ray's forward chain in shared memory (the same device code
// as the forward, so the same samples are live), then runs in reverse:
//   dw_j  = drgb . c_j + ddepth z_j + dweights_j (- sum drgb, white)
//   du_j  = (dw_j - sum_k dw_k w_k) / (sum u + 1e-5)     (normalised)
//   dfe_j = du_j T_j exp(-fe_j) - sum_{k>j} du_k u_k      (reverse block scan)
//   dsigma_j = (z_{j+1} - z_j) dfe_j where sigma is live, else 0
//   the Laplace CDF's derivative to the windowed cosine and to the clamped
//   beta, scale and mean (per-ray partials; the wrapper sums them and
//   autograd carries them through the clamps), the window's taps back to
//   the raw pair cosines, and each pair cosine back to its two normals:
//   every normal gathers from the pairs it belongs to (its own window and
//   its neighbours'), so no atomics are needed.

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

// What every sample of one ray shares.
struct Ray {
  const float* nrm;   // 3S staged normals
  const float* nn;    // S clamped norms
  const float* zs;    // S depths
  const float* coef;  // normalised taps
  float beta, scale, mean, cdf_cut, th;
  float dx, dy, dz, dnorm;
  int S, L, start, middle, hi;  // hi: end of the live windowed interior
  bool windowed;

  __device__ __forceinline__ bool in_window(int j) const {
    return windowed && j >= start && j < hi;
  }

  __device__ __forceinline__ float cos_pair(int a, int b) const {
    const float dot = nrm[3 * a] * nrm[3 * b] +
                      nrm[3 * a + 1] * nrm[3 * b + 1] +
                      nrm[3 * a + 2] * nrm[3 * b + 2];
    return dot / (nn[a] * nn[b]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
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

// Block prologue: warp 0 normalises the taps into coef and clamps the raw
// density scalars into scal = [beta, scale, mean, cdf(cutoff)]; the block
// stages the ray's normals and depths and the clamped norms. Ends with a
// block barrier.
__device__ __forceinline__ Ray load_ray(
    const float* __restrict__ normals, const float* __restrict__ dirs,
    const float* __restrict__ z_vals, const float* __restrict__ raw_beta,
    const float* __restrict__ raw_scale, const float* __restrict__ raw_mean,
    const float* __restrict__ window, int n_taps, const MarchBounds& bnd,
    int S, int n_valid, float* smem, float* coef, float* scal) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ray = blockIdx.x;
  float* nrm = smem;
  float* nn = nrm + 3 * S;
  float* zs = nn + S;
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
      scal[0] = beta;
      scal[1] = scale;
      scal[2] = mean;
      scal[3] = scale * (0.5f + 0.5f * sign_of(centered) *
                                    (1.f - expf(-fabsf(centered) / beta)));
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

  Ray r;
  r.nrm = nrm;
  r.nn = nn;
  r.zs = zs;
  r.coef = coef;
  r.beta = scal[0];
  r.scale = scal[1];
  r.mean = scal[2];
  r.cdf_cut = scal[3];
  r.th = bnd.th;
  r.dx = dirs[ray * 3];
  r.dy = dirs[ray * 3 + 1];
  r.dz = dirs[ray * 3 + 2];
  r.dnorm = fmaxf(sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz), kEps);
  r.S = S;
  r.L = S - 1;
  r.start = (n_taps + 1) / 2 + 1;
  r.middle = (n_taps - 1) / 2;
  r.windowed = r.L - r.start > r.start;
  r.hi = min(r.L - r.start, n_valid - 1 - r.start);
  return r;
}

// The forward chain over the ray: ws[j] = the unnormalised weight u_j.
// The backward also asks for wc[j] (the windowed cosine), live[j] (1 where
// sigma = cdf - cdf(cutoff) passes, else 0) and et[j] = T_j exp(-fe_j).
// Returns the block-wide sum of u. part: per-warp scratch.
__device__ __forceinline__ float march(const Ray& r, int n_valid, float* ws,
                                       float* wc, float* live, float* et,
                                       float (*part)[kWarps]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;  // free energy of all samples before this chunk
  float wsum = 0.f;
  for (int base = 0; base < r.S; base += kThreads) {
    const int j = base + tid;
    float fe = 0.f, c = 0.f, on = 0.f;
    if (j < r.L) {
      c = r.cos_pair(j, j + 1);
      if (r.in_window(j)) {
        float acc = c * r.coef[r.middle];
        for (int i = 1; i < r.start - 1; ++i) {
          acc = acc + r.cos_pair(j, j + 1 + i) * r.coef[r.middle + i] +
                r.cos_pair(j, j - i) * r.coef[r.middle - i];
        }
        c = acc;
      }
      const float* n = r.nrm + 3 * j;
      const float cos_ray = (n[0] * r.dx + n[1] * r.dy + n[2] * r.dz) /
                            (r.nn[j] * r.dnorm);
      const float centered = -c - r.mean;
      const float cdf =
          r.scale * (0.5f + 0.5f * sign_of(centered) *
                                (1.f - expf(-fabsf(centered) / r.beta)));
      const float shifted = cdf - r.cdf_cut;
      float sigma = fmaxf(shifted, 0.f);
      on = shifted >= 0.f ? 1.f : 0.f;
      if ((cos_ray < r.th && c < 0.f) || j >= n_valid - 1) {
        sigma = 0.f;
        on = 0.f;
      }
      fe = (r.zs[j + 1] - r.zs[j]) * sigma;
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
    if (j < r.S) {
      const float T = expf(-(before + (incl - fe)));
      const float decay = expf(-fe);
      const float w = (1.f - decay) * T;
      ws[j] = w;
      wsum += w;
      if (wc != nullptr) {
        wc[j] = c;
        live[j] = on;
        et[j] = T * decay;
      }
    }
  }
  wsum = warp_sum(wsum);
  if (lane == 0) part[0][warp] = wsum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[0][w];
  __syncthreads();  // part is written again by the caller
  return total;
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
                 int S, int n_valid, int normalize, int white_background) {
  extern __shared__ float smem[];
  __shared__ float coef[kMaxTaps];
  __shared__ float scal[4];                  // beta scale mean cdf(cutoff)
  __shared__ float part[5][kWarps];          // per-warp partial sums

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ray = blockIdx.x;
  const Ray r = load_ray(normals, dirs, z_vals, raw_beta, raw_scale, raw_mean,
                         window, n_taps, bnd, S, n_valid, smem, coef, scal);
  float* ws = smem + 5 * S;  // S unnormalized weights
  const float denom =
      march(r, n_valid, ws, nullptr, nullptr, nullptr, part) + 1e-5f;

  const bool composite = rgb != nullptr;
  float red = 0.f, green = 0.f, blue = 0.f, depth = 0.f, acc_w = 0.f;
  const float* cg = composite ? rgb + (size_t)ray * S * 3 : nullptr;
  for (int j = tid; j < S; j += kThreads) {
    float w = ws[j];
    if (normalize) w = w / denom;
    w_out[(size_t)ray * S + j] = w;
    if (composite) {
      red += w * cg[3 * j];
      green += w * cg[3 * j + 1];
      blue += w * cg[3 * j + 2];
      depth += w * r.zs[j];
      acc_w += w;
    }
  }
  if (!composite) return;
  const float sums[5] = {warp_sum(red), warp_sum(green), warp_sum(blue),
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

// Sum of v over the block, by every thread. part: per-warp scratch.
__device__ __forceinline__ float block_sum(float v, float (*part)[kWarps],
                                           int slot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) part[slot][warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[slot][w];
  return total;
}

// d/dx and d/dbeta, d/dscale, d/dmean of scale * LaplaceCDF(x - mean; beta)
// at the clamped scalars, as autograd takes them through the plain chain
// (sign and |.| have derivative 0 at 0).
struct CdfGrad {
  float dx, dbeta, dscale, dmean;
};

__device__ __forceinline__ CdfGrad cdf_grad(float x, float beta, float scale,
                                            float mean) {
  const float centered = x - mean;
  const float sgn = sign_of(centered);
  const float a = fabsf(centered);
  const float e = expf(-a / beta);
  CdfGrad g;
  g.dx = 0.5f * scale * sgn * sgn * e / beta;
  g.dmean = -g.dx;
  g.dbeta = -0.5f * scale * sgn * e * a / (beta * beta);
  g.dscale = 0.5f + 0.5f * sgn * (1.f - e);
  return g;
}

__global__ void __launch_bounds__(kThreads)
ray_march_backward_kernel(
    const float* __restrict__ normals, const float* __restrict__ dirs,
    const float* __restrict__ z_vals, const float* __restrict__ rgb,
    const float* __restrict__ raw_beta, const float* __restrict__ raw_scale,
    const float* __restrict__ raw_mean, const float* __restrict__ window,
    int n_taps, MarchBounds bnd,
    const float* __restrict__ g_rgb,      // (R, 3); null with rgb null
    const float* __restrict__ g_depth,    // (R,); null with rgb null
    const float* __restrict__ g_w,        // (R, S) or null
    float* __restrict__ d_normals,        // (R, S, 3)
    float* __restrict__ d_rgb,            // (R, S, 3); null with rgb null
    float* __restrict__ d_params,         // (R, 3): d beta, scale, mean
    int S, int n_valid, int normalize, int white_background) {
  extern __shared__ float smem[];
  __shared__ float coef[kMaxTaps];
  __shared__ float scal[4];
  __shared__ float part[5][kWarps];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ray = blockIdx.x;
  const Ray r = load_ray(normals, dirs, z_vals, raw_beta, raw_scale, raw_mean,
                         window, n_taps, bnd, S, n_valid, smem, coef, scal);
  float* us = smem + 5 * S;   // u_j
  float* wc = us + S;         // windowed cosine
  float* live = wc + S;       // 1 where sigma passes
  float* et = live + S;       // T_j exp(-fe_j)
  float* gs = et + S;         // dw_j, then d wc_j
  const float denom = march(r, n_valid, us, wc, live, et, part) + 1e-5f;

  // dw, d rgb samples, and sum_k dw_k w_k.
  const bool composite = rgb != nullptr;
  float gr = 0.f, gg = 0.f, gb = 0.f, gd = 0.f, gsum = 0.f;
  if (composite) {
    gr = g_rgb[ray * 3];
    gg = g_rgb[ray * 3 + 1];
    gb = g_rgb[ray * 3 + 2];
    gd = g_depth[ray];
    gsum = white_background ? gr + gg + gb : 0.f;
  }
  const float* cg = composite ? rgb + (size_t)ray * S * 3 : nullptr;
  float dot = 0.f;
  for (int j = tid; j < S; j += kThreads) {
    const float w = normalize ? us[j] / denom : us[j];
    float dw = g_w != nullptr ? g_w[(size_t)ray * S + j] : 0.f;
    if (composite) {
      dw += gr * cg[3 * j] + gg * cg[3 * j + 1] + gb * cg[3 * j + 2] +
            gd * r.zs[j] - gsum;
      float* dc = d_rgb + ((size_t)ray * S + j) * 3;
      dc[0] = w * gr;
      dc[1] = w * gg;
      dc[2] = w * gb;
    }
    gs[j] = dw;
    dot += dw * w;
  }
  const float dw_dot_w = normalize ? block_sum(dot, part, 0) : 0.f;
  __syncthreads();

  // Reverse pass over chunks, last first: du, the suffix sum of du * u,
  // dfe, dsigma, and d wc plus the scalar partials.
  float carry = 0.f;  // sum of du * u over all later chunks
  float pb = 0.f, ps = 0.f, pm = 0.f;
  const CdfGrad gc = cdf_grad(bnd.cutoff, r.beta, r.scale, r.mean);
  const int n_chunks = (S + kThreads - 1) / kThreads;
  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    const int j = chunk * kThreads + tid;
    float du = 0.f, v = 0.f;
    if (j < S) {
      du = normalize ? (gs[j] - dw_dot_w) / denom : gs[j];
      v = du * us[j];
    }
    // Inclusive suffix scan within the warp, then the later warps' totals.
    float incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(kFull, incl, off);
      if (lane + off < 32) incl += t;
    }
    if (lane == 0) part[0][warp] = incl;
    __syncthreads();
    float after = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float t = part[0][w];
      if (w > warp) after += t;
      carry += t;
    }
    __syncthreads();  // part is written again in the next chunk
    if (j < S) {
      float g_cos = 0.f;
      if (j < r.L && live[j] != 0.f) {
        const float dfe = du * et[j] - (after + (incl - v));
        const float dsigma = (r.zs[j + 1] - r.zs[j]) * dfe;
        const CdfGrad g = cdf_grad(-wc[j], r.beta, r.scale, r.mean);
        g_cos = -dsigma * g.dx;
        pb += dsigma * (g.dbeta - gc.dbeta);
        ps += dsigma * (g.dscale - gc.dscale);
        pm += dsigma * (g.dmean - gc.dmean);
      }
      gs[j] = g_cos;
    }
  }
  const float tb = block_sum(pb, part, 1);
  const float ts = block_sum(ps, part, 2);
  const float tm = block_sum(pm, part, 3);
  if (tid == 0) {
    d_params[ray * 3] = tb;
    d_params[ray * 3 + 1] = ts;
    d_params[ray * 3 + 2] = tm;
  }
  __syncthreads();  // gs complete

  // Each normal m gathers from the pair cosines it belongs to: with weight
  // w_p for partner p, d n_m = (sum_p w_p n_p / |n_p| - [|n_m| >= eps]
  // (sum_p w_p cos_p) n_m / |n_m|) / |n_m|, norms clamped at eps.
  const int mid = r.middle, reach = r.start - 1;
  for (int m = tid; m < S; m += kThreads) {
    float vx = 0.f, vy = 0.f, vz = 0.f, csum = 0.f;
    auto add = [&](int p, float w) {
      if (w == 0.f) return;
      const float c = r.cos_pair(m, p);
      const float inv = 1.f / r.nn[p];
      vx += w * r.nrm[3 * p] * inv;
      vy += w * r.nrm[3 * p + 1] * inv;
      vz += w * r.nrm[3 * p + 2] * inv;
      csum += w * c;
    };
    if (m < r.L) {  // pairs of m's own cosine
      const float g = gs[m];
      if (r.in_window(m)) {
        add(m + 1, g * r.coef[mid]);
        for (int i = 1; i < reach; ++i) {
          add(m + 1 + i, g * r.coef[mid + i]);
          add(m - i, g * r.coef[mid - i]);
        }
      } else {
        add(m + 1, g);
      }
    }
    if (m >= 1) {  // m as the partner of earlier and later samples
      const int j = m - 1;
      add(j, gs[j] * (r.in_window(j) ? r.coef[mid] : 1.f));
    }
    for (int i = 1; i < reach; ++i) {
      const int jf = m - 1 - i;  // its forward tap j + 1 + i reaches m
      if (jf >= 0 && r.in_window(jf)) add(jf, gs[jf] * r.coef[mid + i]);
      const int jb = m + i;      // its backward tap j - i reaches m
      if (jb < r.L && r.in_window(jb)) add(jb, gs[jb] * r.coef[mid - i]);
    }
    const float* n = r.nrm + 3 * m;
    const float inv = 1.f / r.nn[m];
    const float x = n[0], y = n[1], z = n[2];
    const float c = sqrtf(x * x + y * y + z * z) >= kEps ? csum : 0.f;
    float* dn = d_normals + ((size_t)ray * S + m) * 3;
    dn[0] = (vx - c * x * inv) * inv;
    dn[1] = (vy - c * y * inv) * inv;
    dn[2] = (vz - c * z * inv) * inv;
  }
}

bool bad_sizes(int n_samples, int n_taps, int n_valid) {
  return n_samples < 1 || n_samples > kMaxSamples || n_taps < 1 ||
         n_taps > kMaxTaps || n_valid < 1 || n_valid > n_samples;
}

}  // namespace

extern "C" {

int vfn_ray_march_max_samples() { return kMaxSamples; }
int vfn_ray_march_max_taps() { return kMaxTaps; }

// Launch on `stream`; every pointer is a device pointer. `rgb` null is the
// weights-only mode (then `rgb_out` and `depth_out` are not written). The
// density parameters are the raw 0-d tensors; the bounds, cutoff and
// back-face threshold come by value; `n_valid` is the live sample count
// (n_samples: none masked). Returns the CUDA error code of the launch (0 on
// success).
int vfn_ray_march(const float* normals, const float* dirs, const float* z_vals,
                  const float* rgb, const float* raw_beta,
                  const float* raw_scale, const float* raw_mean,
                  const float* window, int n_taps, float beta_lo,
                  float beta_hi, float scale_min, float mean_lo,
                  float mean_hi, float cutoff, float th, float* rgb_out,
                  float* depth_out, float* w_out, int n_rays, int n_samples,
                  int n_valid, int normalize, int white_background,
                  void* stream) {
  if (bad_sizes(n_samples, n_taps, n_valid)) {
    return (int)cudaErrorInvalidValue;
  }
  const MarchBounds bnd{beta_lo, beta_hi, scale_min, mean_lo, mean_hi,
                        cutoff, th};
  const size_t smem = (size_t)6 * n_samples * sizeof(float);
  ray_march_kernel<<<n_rays, kThreads, smem, (cudaStream_t)stream>>>(
      normals, dirs, z_vals, rgb, raw_beta, raw_scale, raw_mean, window,
      n_taps, bnd, rgb_out, depth_out, w_out, n_samples, n_valid, normalize,
      white_background);
  return (int)cudaGetLastError();
}

// The backward of vfn_ray_march on the same inputs, from the gradients of
// its outputs: `g_rgb` (R, 3) and `g_depth` (R,) (null with `rgb` null),
// `g_w` (R, S) or null for none. Writes d normals (R, S, 3), d rgb samples
// (R, S, 3) (not with `rgb` null) and per-ray partials (R, 3) of the
// gradient to the CLAMPED beta, scale and mean. Returns the CUDA error code
// of the launch.
int vfn_ray_march_backward(
    const float* normals, const float* dirs, const float* z_vals,
    const float* rgb, const float* raw_beta, const float* raw_scale,
    const float* raw_mean, const float* window, int n_taps, float beta_lo,
    float beta_hi, float scale_min, float mean_lo, float mean_hi,
    float cutoff, float th, const float* g_rgb, const float* g_depth,
    const float* g_w, float* d_normals, float* d_rgb, float* d_params,
    int n_rays, int n_samples, int n_valid, int normalize,
    int white_background, void* stream) {
  if (bad_sizes(n_samples, n_taps, n_valid) ||
      (rgb != nullptr && (g_rgb == nullptr || g_depth == nullptr ||
                          d_rgb == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const MarchBounds bnd{beta_lo, beta_hi, scale_min, mean_lo, mean_hi,
                        cutoff, th};
  const size_t smem = (size_t)10 * n_samples * sizeof(float);
  ray_march_backward_kernel<<<n_rays, kThreads, smem,
                              (cudaStream_t)stream>>>(
      normals, dirs, z_vals, rgb, raw_beta, raw_scale, raw_mean, window,
      n_taps, bnd, g_rgb, g_depth, g_w, d_normals, d_rgb, d_params,
      n_samples, n_valid, normalize, white_background);
  return (int)cudaGetLastError();
}

}  // extern "C"
