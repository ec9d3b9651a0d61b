// Fused ray march for sm_90a: windowed cosine -> Laplace density ->
// back-face suppression -> VolSDF weights -> composite, one block per ray,
// and its backward (a reverse scan), two warps per ray.
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
// about 1-2 us at 3.35 TB/s. The backward reads R*V*7 + R*7 (+ R*V with a
// weights gradient), V = n_valid, and writes R*S*6 + R*3. The work per ray
// is a short serial chain (stage, scan, composite), so what the card needs
// is many rays in flight at once.
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
// recomputes the ray's forward chain (the forward's per-sample device code,
// sample_energy, on unit normals), then runs in reverse:
//   dw_j  = drgb . c_j + ddepth z_j + dweights_j (- sum drgb, white)
//   du_j  = (dw_j - sum_k dw_k w_k) / (sum u + 1e-5)     (normalised)
//   dfe_j = du_j T_j exp(-fe_j) - sum_{k>j} du_k u_k      (reverse scan)
//   dsigma_j = (z_{j+1} - z_j) dfe_j where sigma is live, else 0
//   the Laplace CDF's derivative to the windowed cosine and to the clamped
//   beta, scale and mean (per-ray partials; the wrapper sums them and
//   autograd carries them through the clamps), the window's taps back to
//   the raw pair cosines, and each pair cosine back to its two normals:
//   every normal gathers from the pairs it belongs to (its own window and
//   its neighbours'), so no atomics are needed.
// What bounds the backward: latency, not bytes. The chain per ray is a row
// of dependent passes, so the design keeps each pass short and off the
// block barrier: a group of two warps owns a ray (two rays per 128-thread
// block) and orders its passes by its own 64-thread named barrier; the ray
// lives in the group's own strip of shared memory, staged in one round
// trip (normals made unit once, so that each cosine is a dot product); the
// per-sample passes run strided over the group, the two scans walk
// thread-contiguous runs joined by shuffle scans, the sums share one
// barrier each (the three partials one together), the shipped 11-tap
// window is a compile-time instance whose tap loops unroll, and the gather
// sums each partner's weights first, so each pair cosine is computed once,
// without branches. Only the first n_valid samples are staged and run (the
// padded ones reach no output); their gradients are written as zeros. What
// holds it now: the 1024 rays run as one wave in lockstep, so the loads,
// the passes and the stores do not overlap across rays (PERF.md section 6).

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

// What every sample of one ray shares. kUnit: nrm holds unit normals (each
// staged normal over its clamped norm), so a cosine is a dot product and
// nn is not read (the backward); else raw normals and their clamped norms
// (the forward).
template <bool kUnit>
struct RayT {
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
    return kUnit ? dot : dot / (nn[a] * nn[b]);
  }

  // cos(n_j, ray direction).
  __device__ __forceinline__ float cos_dir(int j) const {
    const float* n = nrm + 3 * j;
    const float dot = n[0] * dx + n[1] * dy + n[2] * dz;
    return kUnit ? dot / dnorm : dot / (nn[j] * dnorm);
  }
};

using Ray = RayT<false>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// dst[i] = src[i] for i = first, first + step, ... < n, as float4 loads:
// scalar loads up to the first 16-byte boundary of src, float4 loads after
// it (kBatch of them in flight per thread), scalar loads for the tail.
template <int kBatch = 1>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n, int first, int step) {
  const int head = min(
      n, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
  for (int i = first; i < head; i += step) dst[i] = src[i];
  const int n4 = (n - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i0 = first; i0 < n4; i0 += kBatch * step) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * step < n4) v[b] = __ldg(s4 + i0 + b * step);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i0 + b * step < n4) {
        float* d = dst + head + 4 * (i0 + b * step);
        d[0] = v[b].x;
        d[1] = v[b].y;
        d[2] = v[b].z;
        d[3] = v[b].w;
      }
    }
  }
  for (int i = head + 4 * n4 + first; i < n; i += step) dst[i] = src[i];
}

// Raw taps lane and lane + 32 (0 past n_taps).
__device__ __forceinline__ float2 load_taps(const float* __restrict__ window,
                                            int n_taps, int lane) {
  return make_float2(lane < n_taps ? window[lane] : 0.f,
                     lane + 32 < n_taps ? window[lane + 32] : 0.f);
}

// By one warp, from its lanes' raw taps w0 = window[lane], w1 =
// window[lane + 32]: the taps normalised into coef (centre signed,
// neighbours |w|, all / sum|w|).
__device__ __forceinline__ void normalise_taps(float w0, float w1, int n_taps,
                                               float* coef, int lane) {
  const float total = warp_sum(fabsf(w0) + fabsf(w1));
  const int middle = (n_taps - 1) / 2;
  if (lane < n_taps) coef[lane] = (lane == middle ? w0 : fabsf(w0)) / total;
  if (lane + 32 < n_taps) {
    coef[lane + 32] = (lane + 32 == middle ? w1 : fabsf(w1)) / total;
  }
}

// scal = [beta, scale, mean, cdf(cutoff)] from the raw density scalars.
__device__ __forceinline__ void clamp_scalars(float raw_beta, float raw_scale,
                                              float raw_mean,
                                              const MarchBounds& bnd,
                                              float* scal) {
  const float beta = fminf(fmaxf(raw_beta, bnd.beta_lo), bnd.beta_hi);
  const float scale = fmaxf(fabsf(raw_scale), bnd.scale_min);
  const float mean = fminf(fmaxf(raw_mean, bnd.mean_lo), bnd.mean_hi);
  const float centered = bnd.cutoff - mean;
  scal[0] = beta;
  scal[1] = scale;
  scal[2] = mean;
  scal[3] = scale * (0.5f + 0.5f * sign_of(centered) *
                                (1.f - expf(-fabsf(centered) / beta)));
}

// The ray's shared view, once its normals, norms, depths and taps are
// staged and its scalars clamped; (dx, dy, dz) its direction.
template <bool kUnit = false>
__device__ __forceinline__ RayT<kUnit> make_ray(
    const float* nrm, const float* nn, const float* zs, const float* coef,
    const float* scal, const MarchBounds& bnd, float dx, float dy, float dz,
    int S, int n_taps, int n_valid) {
  RayT<kUnit> r;
  r.nrm = nrm;
  r.nn = nn;
  r.zs = zs;
  r.coef = coef;
  r.beta = scal[0];
  r.scale = scal[1];
  r.mean = scal[2];
  r.cdf_cut = scal[3];
  r.th = bnd.th;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.dnorm = fmaxf(sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz), kEps);
  r.S = S;
  r.L = S - 1;
  r.start = (n_taps + 1) / 2 + 1;
  r.middle = (n_taps - 1) / 2;
  r.windowed = r.L - r.start > r.start;
  r.hi = min(r.L - r.start, n_valid - 1 - r.start);
  return r;
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
    const float2 w = load_taps(window, n_taps, lane);
    normalise_taps(w.x, w.y, n_taps, coef, lane);
    if (lane == 0) {
      clamp_scalars(*raw_beta, *raw_scale, *raw_mean, bnd, scal);
    }
  }
  stage(nrm, normals + (size_t)ray * S * 3, 3 * S, tid, kThreads);
  stage(zs, z_vals + (size_t)ray * S, S, tid, kThreads);
  __syncthreads();
  for (int j = tid; j < S; j += kThreads) {
    const float x = nrm[3 * j], y = nrm[3 * j + 1], z = nrm[3 * j + 2];
    nn[j] = fmaxf(sqrtf(x * x + y * y + z * z), kEps);
  }
  __syncthreads();
  return make_ray(nrm, nn, zs, coef, scal, bnd, dirs[ray * 3],
                  dirs[ray * 3 + 1], dirs[ray * 3 + 2], S, n_taps, n_valid);
}

// The free energy (z_{j+1} - z_j) sigma_j of a sample j < L, with c the
// windowed cosine and on = 1 where sigma = cdf - cdf(cutoff) passes its
// clamp at 0 and is neither cut as a back face nor past n_valid - 1.
// kTaps: the window's tap count when fixed at compile time (0: r's).
template <int kTaps = 0, bool kUnit>
__device__ __forceinline__ float sample_energy(const RayT<kUnit>& r, int j,
                                               int n_valid, float& c,
                                               float& on) {
  c = r.cos_pair(j, j + 1);
  if (r.in_window(j)) {
    float acc = c * r.coef[r.middle];
    const int reach = kTaps ? (kTaps + 1) / 2 : r.start - 1;
#pragma unroll (kTaps ? 32 : 1)
    for (int i = 1; i < reach; ++i) {
      acc = acc + r.cos_pair(j, j + 1 + i) * r.coef[r.middle + i] +
            r.cos_pair(j, j - i) * r.coef[r.middle - i];
    }
    c = acc;
  }
  const float cos_ray = r.cos_dir(j);
  const float centered = -c - r.mean;
  const float cdf = r.scale * (0.5f + 0.5f * sign_of(centered) *
                                          (1.f - expf(-fabsf(centered) /
                                                      r.beta)));
  const float shifted = cdf - r.cdf_cut;
  float sigma = fmaxf(shifted, 0.f);
  on = shifted >= 0.f ? 1.f : 0.f;
  if ((cos_ray < r.th && c < 0.f) || j >= n_valid - 1) {
    sigma = 0.f;
    on = 0.f;
  }
  return (r.zs[j + 1] - r.zs[j]) * sigma;
}

// The forward chain over the ray: ws[j] = the unnormalised weight u_j.
// Returns the block-wide sum of u. part: per-warp scratch.
__device__ __forceinline__ float march(const Ray& r, int n_valid, float* ws,
                                       float (*part)[kWarps]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;  // free energy of all samples before this chunk
  float wsum = 0.f;
  for (int base = 0; base < r.S; base += kThreads) {
    const int j = base + tid;
    float fe = 0.f, c = 0.f, on = 0.f;
    if (j < r.L) fe = sample_energy(r, j, n_valid, c, on);
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
  const float denom = march(r, n_valid, ws, part) + 1e-5f;

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

// Sum of v over the lanes before this one.
__device__ __forceinline__ float lanes_before(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  const float t = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? 0.f : t;
}

// Sum of v over the lanes after this one.
__device__ __forceinline__ float lanes_after(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += t;
  }
  const float t = __shfl_down_sync(kFull, v, 1);
  return lane == 31 ? 0.f : t;
}

// Backward: threads per ray (a group of kGroupWarps warps), rays per block,
// the padded index of sample j in the scratch arrays that threads walk in
// contiguous runs (one slot of padding per 32 samples keeps a run's loads
// free of bank conflicts), and the floats of one ray's strip: normals 3S,
// signed inverse norms S, depths S, rgb samples 3S, weight gradients S,
// taps, 4 padded arrays, and the exchange slots of the group's sums and
// scans.
constexpr int kGroupWarps = 2;
constexpr int kGroup = 32 * kGroupWarps;
constexpr int kRaysPerBlock = kThreads / kGroup;
static_assert(kGroupWarps == 1 || kRaysPerBlock <= 2, "barrier ids 1 and 2");
constexpr int kSlots = 8;
constexpr float kDead = 1e30f;  // windowed cosine of a sample with sigma 0

__host__ __device__ __forceinline__ int pad32(int j) { return j + (j >> 5); }

__host__ __device__ __forceinline__ int strip_floats(int S) {
  return (9 * S + kMaxTaps + 4 * (pad32(S) + 1) + kSlots * kGroupWarps + 3) /
         4 * 4;
}

// The threads of one ray's group: a named barrier of kGroup threads, and
// sums and scans across them through the strip's exchange slots (each
// call its own slot, so that no second barrier is needed).
struct Group {
  int t, lane, warp, bar;  // thread and warp in the group, barrier id
  float* xch;              // kSlots x kGroupWarps

  // Immediate barrier ids (a register id costs ptxas all 16 barriers).
  __device__ __forceinline__ void sync() const {
    if (kGroupWarps == 1) {
      __syncwarp();
    } else if (bar == 1) {
      asm volatile("bar.sync 1, %0;\n" :: "n"(kGroup) : "memory");
    } else {
      asm volatile("bar.sync 2, %0;\n" :: "n"(kGroup) : "memory");
    }
  }

  // The warps' totals of v in slot `slot`, after a barrier.
  __device__ __forceinline__ void share(float v, int slot) const {
    v = warp_sum(v);
    if (lane == 0) xch[slot * kGroupWarps + warp] = v;
    sync();
  }

  __device__ __forceinline__ float sum(float v, int slot) const {
    float one[1] = {v};
    sums(one, slot);
    return one[0];
  }

  // v[k] = its sum over the group, for each k, in slots slot .. slot + K - 1
  // and one barrier.
  template <int K>
  __device__ __forceinline__ void sums(float (&v)[K], int slot) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = warp_sum(v[k]);
      if (lane == 0) xch[(slot + k) * kGroupWarps + warp] = s;
    }
    sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0.f;
#pragma unroll
      for (int w = 0; w < kGroupWarps; ++w) {
        v[k] += xch[(slot + k) * kGroupWarps + w];
      }
    }
  }

  // Sum of v over the group's threads before this one.
  __device__ __forceinline__ float before(float v, int slot) const {
    float b = lanes_before(v, lane);
    share(v, slot);
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      if (w < warp) b += xch[slot * kGroupWarps + w];
    }
    return b;
  }

  // Sum of v over the group's threads after this one.
  __device__ __forceinline__ float after(float v, int slot) const {
    float a = lanes_after(v, lane);
    share(v, slot);
#pragma unroll
    for (int w = 0; w < kGroupWarps; ++w) {
      if (w > warp) a += xch[slot * kGroupWarps + w];
    }
    return a;
  }
};

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

// A group of kGroup threads per ray (kRaysPerBlock rays per block), and no
// block barrier: the group stages its ray, recomputes the forward chain and
// runs the reverse chain through its own strip of shared memory, ordered by
// its own named barrier. Strided passes (sample j = t + kGroup i) do the
// per-sample work; the two scans walk thread-contiguous runs of
// ceil(S / kGroup) samples, joined by a scan of the runs' totals (shuffles,
// then the warps' totals). kTaps: the window's tap count when fixed at
// compile time (the shipped 11), which unrolls the tap loops; 0: any.
template <int kTaps>
__global__ void __launch_bounds__(kThreads, 4)
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
    int n_rays, int S, int n_valid, int normalize, int white_background) {
  extern __shared__ float smem[];
  const int g_index = threadIdx.x / kGroup;
  const int ray = blockIdx.x * kRaysPerBlock + g_index;
  if (ray >= n_rays) return;  // the whole group
  // Only the live samples reach an output: the padded ones (from n_valid on)
  // have sigma and weight 0, lie outside every live window and pair, and get
  // zero gradients. So the group runs the ray's first V = n_valid samples as
  // a ray of V samples (the same interior, energies and pairs) and writes
  // zeros past them; S stays the rows' stride.
  const int V = n_valid;
  const int Q = pad32(V) + 1;
  float* nrm = smem + g_index * strip_floats(V);
  float* inv = nrm + 3 * V;     // 1 / clamped norm, negative where |n| < eps
  float* zs = inv + V;
  float* cs = zs + V;           // rgb samples
  float* gws = cs + 3 * V;      // weight gradients
  float* coef = gws + V;
  float* et = coef + kMaxTaps;  // free energy fe_j, then T_j exp(-fe_j)
  float* us = et + Q;           // u_j
  float* gs = us + Q;           // dw_j, dfe_j, then the windowed d wc_j
  float* wc = gs + Q;           // windowed cosine (kDead where sigma is 0),
                                // then the raw (edge) d wc_j
  const Group grp{static_cast<int>(threadIdx.x % kGroup),
                  static_cast<int>(threadIdx.x % 32),
                  static_cast<int>((threadIdx.x % kGroup) / 32), 1 + g_index,
                  wc + Q};
  const int t = grp.t;

  // Prologue: taps, clamped scalars, and the ray's rows of every input in
  // one round trip: normals (made unit below), depths, rgb samples and
  // weight gradients. The unit normals make each cosine a dot product;
  // their rounding differs from the forward kernel's dot / (|a| |b|) by an
  // ulp.
  const bool composite = rgb != nullptr;
  // The small reads go first, so that their round trips overlap the rows'.
  const float2 taps = load_taps(window, n_taps, grp.lane);
  const float rb = *raw_beta, rs = *raw_scale, rmean = *raw_mean;
  const float dx = dirs[ray * 3], dy = dirs[ray * 3 + 1],
              dz = dirs[ray * 3 + 2];
  stage<4>(nrm, normals + (size_t)ray * S * 3, 3 * V, t, kGroup);
  stage<4>(zs, z_vals + (size_t)ray * S, V, t, kGroup);
  if (composite) stage<4>(cs, rgb + (size_t)ray * S * 3, 3 * V, t, kGroup);
  if (g_w != nullptr) stage<4>(gws, g_w + (size_t)ray * S, V, t, kGroup);
  if (grp.warp == 0) normalise_taps(taps.x, taps.y, n_taps, coef, grp.lane);
  float scal[4];
  clamp_scalars(rb, rs, rmean, bnd, scal);
  grp.sync();
  for (int j = t; j < V; j += kGroup) {
    float* n = nrm + 3 * j;
    const float x = n[0], y = n[1], z = n[2];
    const float len = sqrtf(x * x + y * y + z * z);
    const float r = 1.f / fmaxf(len, kEps);
    n[0] = x * r;
    n[1] = y * r;
    n[2] = z * r;
    inv[j] = len >= kEps ? r : -r;
  }
  grp.sync();
  const RayT<true> r = make_ray<true>(nrm, nullptr, zs, coef, scal, bnd, dx,
                                      dy, dz, V, n_taps, n_valid);

  // Forward: free energy and windowed cosine per sample.
  for (int j = t; j < V; j += kGroup) {
    float fe = 0.f, c = 0.f, on = 0.f;
    if (j < r.L) fe = sample_energy<kTaps>(r, j, n_valid, c, on);
    et[pad32(j)] = fe;
    wc[pad32(j)] = on != 0.f ? c : kDead;
  }
  grp.sync();
  // Transmittance: an exclusive scan over this thread's run, after the
  // earlier runs' energy. u_j = (1 - exp(-fe_j)) T_j. The runs are cut from
  // the whole ray and end at V: the padded samples' terms are exact zeros,
  // so every sum is grouped, and rounded, as over all S samples.
  const int run = (S + kGroup - 1) / kGroup;
  const int j0 = min(V, t * run), j1 = min(V, j0 + run);
  float energy = 0.f;
  for (int j = j0; j < j1; ++j) energy += et[pad32(j)];
  float before = grp.before(energy, 0);
  float usum = 0.f;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const int q = pad32(j);
    const float fe = et[q];
    const float T = expf(-before);
    const float decay = expf(-fe);
    const float u = (1.f - decay) * T;
    us[q] = u;
    et[q] = T * decay;
    usum += u;
    before += fe;
  }
  const float inv_denom = 1.f / (grp.sum(usum, 1) + 1e-5f);

  // dw, d rgb samples, and sum_k dw_k w_k.
  float gr = 0.f, gg = 0.f, gb = 0.f, gd = 0.f, gsum = 0.f;
  if (composite) {
    gr = g_rgb[ray * 3];
    gg = g_rgb[ray * 3 + 1];
    gb = g_rgb[ray * 3 + 2];
    gd = g_depth[ray];
    gsum = white_background ? gr + gg + gb : 0.f;
  }
  float dot = 0.f;
  for (int j = t; j < V; j += kGroup) {
    const int q = pad32(j);
    const float w = normalize ? us[q] * inv_denom : us[q];
    float dw = g_w != nullptr ? gws[j] : 0.f;
    if (composite) {
      dw += gr * cs[3 * j] + gg * cs[3 * j + 1] + gb * cs[3 * j + 2] +
            gd * zs[j] - gsum;
      float* dc = d_rgb + ((size_t)ray * S + j) * 3;
      dc[0] = w * gr;
      dc[1] = w * gg;
      dc[2] = w * gb;
    }
    gs[q] = dw;
    dot += dw * w;
  }
  // The sum's barrier also orders the gs writes before the runs read them.
  const float dot_total = grp.sum(dot, 2);
  const float dw_dot_w = normalize ? dot_total : 0.f;

  // Reverse: du_j = (dw_j - sum dw w) / denom (normalised), and
  // dfe_j = du_j T_j exp(-fe_j) - sum_{k > j} du_k u_k, a suffix scan over
  // this thread's run (last first) after the later runs' sums.
  float tail = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int q = pad32(j);
    const float du = normalize ? (gs[q] - dw_dot_w) * inv_denom : gs[q];
    tail += du * us[q];
  }
  float after = grp.after(tail, 3);
  for (int j = j1 - 1; j >= j0; --j) {
    const int q = pad32(j);
    const float du = normalize ? (gs[q] - dw_dot_w) * inv_denom : gs[q];
    gs[q] = du * et[q] - after;
    after += du * us[q];
  }
  grp.sync();

  // dsigma, d wc and the scalar partials where sigma is live; d wc goes to
  // gs where the sample's cosine is windowed, else to wc.
  float pb = 0.f, ps = 0.f, pm = 0.f;
  const CdfGrad gc = cdf_grad(bnd.cutoff, r.beta, r.scale, r.mean);
  for (int j = t; j < V; j += kGroup) {
    const int q = pad32(j);
    float g_cos = 0.f;
    if (j < r.L && wc[q] != kDead) {
      const float dsigma = (zs[j + 1] - zs[j]) * gs[q];
      const CdfGrad g = cdf_grad(-wc[q], r.beta, r.scale, r.mean);
      g_cos = -dsigma * g.dx;
      pb += dsigma * (g.dbeta - gc.dbeta);
      ps += dsigma * (g.dscale - gc.dscale);
      pm += dsigma * (g.dmean - gc.dmean);
    }
    const bool win = r.in_window(j);
    gs[q] = win ? g_cos : 0.f;
    wc[q] = win ? 0.f : g_cos;
  }
  float partials[3] = {pb, ps, pm};
  grp.sums(partials, 4);  // orders the gs / wc writes too
  pb = partials[0];
  ps = partials[1];
  pm = partials[2];
  if (t == 0) {
    d_params[ray * 3] = pb;
    d_params[ray * 3 + 1] = ps;
    d_params[ray * 3 + 2] = pm;
  }

  // Each normal m gathers from the pair cosines it belongs to: with weight
  // w_p for partner p and unit normals u, d n_m = (sum_p w_p u_p -
  // [|n_m| >= eps] (sum_p w_p u_m . u_p) u_m) / |n_m|, norms clamped at
  // eps. A pair (a, a + d) takes a's forward tap d - 1 (d = 1: a's own
  // cosine: the window's centre, or the raw edge cosine) and a + d's
  // backward tap d; the partner's weights are summed first, so each pair
  // cosine is computed once.
  const int mid = r.middle;
  const int reach = kTaps ? (kTaps + 1) / 2 : r.start - 1;
  for (int m = t; m < V; m += kGroup) {
    const int qm = pad32(m);
    const float ux = nrm[3 * m], uy = nrm[3 * m + 1], uz = nrm[3 * m + 2];
    const float gw_m = gs[qm], gr_m = wc[qm];
    float vx = 0.f, vy = 0.f, vz = 0.f, csum = 0.f;
    // Branch-free (a partner past either end takes weight 0 at a clamped
    // index), so that the unrolled partners' loads go out together.
    auto add = [&](int p, float w) {
      const float px = nrm[3 * p], py = nrm[3 * p + 1], pz = nrm[3 * p + 2];
      vx += w * px;
      vy += w * py;
      vz += w * pz;
      csum += w * (ux * px + uy * py + uz * pz);
    };
#pragma unroll
    for (int d = 1; d <= reach; ++d) {
      const float fwd = r.coef[mid + d - 1];
      const float bwd = d < reach ? r.coef[mid - d] : 0.f;
      const int pu = min(m + d, V - 1), pl = max(m - d, 0);
      const int qu = pad32(pu), ql = pad32(pl);
      add(pu, m + d < V ? gw_m * fwd + (d == 1 ? gr_m : 0.f) + gs[qu] * bwd
                        : 0.f);
      add(pl, m - d >= 0 ? gs[ql] * fwd + (d == 1 ? wc[ql] : 0.f) + gw_m * bwd
                         : 0.f);
    }
    const float im = inv[m];
    const float c = im > 0.f ? csum : 0.f;
    const float a = fabsf(im);
    float* dn = d_normals + ((size_t)ray * S + m) * 3;
    dn[0] = (vx - c * ux) * a;
    dn[1] = (vy - c * uy) * a;
    dn[2] = (vz - c * uz) * a;
  }
  for (int i = t; i < 3 * (S - V); i += kGroup) {
    d_normals[((size_t)ray * S + V) * 3 + i] = 0.f;
    if (composite) d_rgb[((size_t)ray * S + V) * 3 + i] = 0.f;
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
  const size_t smem =
      (size_t)kRaysPerBlock * strip_floats(n_valid) * sizeof(float);
  auto kernel = n_taps == 11 ? ray_march_backward_kernel<11>
                             : ray_march_backward_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      normals, dirs, z_vals, rgb, raw_beta, raw_scale, raw_mean, window,
      n_taps, bnd, g_rgb, g_depth, g_w, d_normals, d_rgb, d_params, n_rays,
      n_samples, n_valid, normalize, white_background);
  return (int)cudaGetLastError();
}

}  // extern "C"
