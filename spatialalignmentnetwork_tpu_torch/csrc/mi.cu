// Parzen-window MI loss, forward and closed-form backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/mi.py: the forward `_forward` /
// `_mi_kernel` (pallas_call at :106) and the backward `_backward` /
// `_mi_bwd_kernel` (pallas_call at :246). The TPU kernels walk one
// sample's pixels in sequence (padded with 1e6 to a multiple of 2048);
// here each sample's M pixels are split over many blocks of 2048 (50
// blocks a sample at 320 x 320), masked past M, and a second launch
// reduces the blocks' partials in a fixed order (no float atomics).
//
// MI as the reference's loss (miloss.py:26-57): per sample, Gaussian
// responses p_b(v) = exp(-(v - c_b)^2 / (2 sigma^2)) / (sqrt(2 pi) sigma)
// at bins <= 64 centres c_b = b ((max - min) / (bins - 1)) + min (the
// Pallas kernel's form); marginal sums s_b = sum_px p_b and the joint
// Gram G_ab = sum_px p_a(I) p_b(J); loss = mean over the batch of
// -(H_I + H_J - H_IJ). f32 throughout: the Gram is f32 FFMA (the JAX
// kernel pins Precision.HIGHEST), expf and logf without fast math.
//
// mi_fwd: a block stages 64 pixels at a time, writes their [64 px, 64
// bins] responses to shared memory (zero for bins past `bins` and pixels
// past M), and each of its 256 threads accumulates a 4 x 4 tile of the
// 64 x 64 Gram in registers; 128 threads also accumulate the marginals.
// Each sum is taken over 64 pixels, then added to the block's total.
// Launch 2 (one block a sample) sums the partials in order, writes the
// statistics [2 bins + bins^2] (kept by the autograd Function for the
// backward, so it does not recompute them as the Pallas backward does)
// and runs the entropy epilogue (:232-244); launch 3 takes the batch mean.
//
// mi_bwd: launch 1 (one block a sample) computes from the saved
// statistics the entropy weights -w/m [bins] of each marginal and the
// joint coefficients EQ [bins, bins] (:333-349). Launch 2 streams the
// pixels, one thread a pixel: dL/dp_I = -w_I/m + (EQ p_J)/norm2d and
// dL/dp_J = -w_J/m + (EQ^T p_I)/norm2d, then dv = sum_b dL/dp_b p_b
// (c_b - v) / sigma^2, subtracting before the sum over bins (:357-384):
// sum_b A_b c_b - v sum_b A_b would cancel, amplified by 1/sigma^2 = 4096.
// EQ and EQ^T sit in shared memory, read as broadcast float4s.
//
// Bound on the H100 SXM: f32 operations. At the path's shape (I and J [4,
// 1, 320, 320], 409,600 pixel pairs, 64 bins) the forward's Gram alone is
// 2 * 64 * 64 flops a pixel, 3.36 GFLOP: about 50 us at 67 TFLOP/s
// (reading 3.3 MB takes under 1 us). The backward's two 64 x 64
// matrix-vector products a pixel are 6.7 GFLOP: about 100 us. Moving the
// Gram and the products to the tensor cores (3xTF32 on wgmma) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;        // padded bin count
constexpr int kStats = 2 * kBins + kBins * kBins;  // s_i, s_j, joint
constexpr int kChunk = 2048;     // pixels a forward block
constexpr int kSub = 64;         // pixels staged at a time
constexpr int kFwdThreads = 256;  // 16 x 16 threads, 4 x 4 Gram entries each
constexpr int kEpiThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kBwdPixels = 256;  // pixels a backward block

struct Parzen {
  int bins;
  float minv, step, inv_two_sigma2, norm1d;
};

// c_b = b * step + min, rounded as the Pallas kernel's f32 iota arithmetic
// (no fused multiply-add)
__device__ __forceinline__ float center(int b, const Parzen& p) {
  return __fadd_rn(__fmul_rn((float)b, p.step), p.minv);
}

__device__ __forceinline__ float response(float v, float c, const Parzen& p) {
  const float d = v - c;
  return expf(-(d * d) * p.inv_two_sigma2) / p.norm1d;
}

// Sum of `v` over a 1-D block, in a fixed order, returned to every
// thread. scratch: kThreads / 32 + 1 floats.
template <int kThreads>
__device__ float block_sum_all(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) t += scratch[k];
    scratch[kThreads / 32] = t;
  }
  __syncthreads();
  const float t = scratch[kThreads / 32];
  __syncthreads();  // scratch is free again
  return t;
}

// grid (chunks, N); partial[(n * chunks + chunk) * kStats + e]: the
// chunk's marginal sums (e < 2 kBins) and joint Gram (row-major after).
__global__ void __launch_bounds__(kFwdThreads)
    mi_fwd_partial_kernel(const float* __restrict__ I,
                          const float* __restrict__ J,
                          float* __restrict__ partial, int64_t m, Parzen p) {
  __shared__ __align__(16) float pi[kSub][kBins];
  __shared__ __align__(16) float pj[kSub][kBins];
  __shared__ float vi[kSub];
  __shared__ float vj[kSub];
  __shared__ float cs[kBins];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int64_t n = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * kChunk;
  const float* In = I + n * m;
  const float* Jn = J + n * m;
  if (tid < kBins) cs[tid] = center(tid, p);
  float g[4][4] = {};
  float marg = 0.0f;
  for (int s0 = 0; s0 < kChunk && start + s0 < m; s0 += kSub) {
    if (tid < kSub) {
      const int64_t px = start + s0 + tid;
      vi[tid] = px < m ? In[px] : 0.0f;
    } else if (tid < 2 * kSub) {
      const int64_t px = start + s0 + tid - kSub;
      vj[tid - kSub] = px < m ? Jn[px] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < kSub * kBins; e += kFwdThreads) {
      const int k = e / kBins;
      const int b = e - k * kBins;
      const bool valid = start + s0 + k < m && b < p.bins;
      pi[k][b] = valid ? response(vi[k], cs[b], p) : 0.0f;
      pj[k][b] = valid ? response(vj[k], cs[b], p) : 0.0f;
    }
    __syncthreads();
    // two-level sums (64 pixels, then the chunk's running total): one
    // chain of 2048 near-equal terms (a zero background) would lose
    // ~1e-4 of the sum
    float gs[4][4] = {};
#pragma unroll 8
    for (int k = 0; k < kSub; ++k) {
      const float4 a4 = reinterpret_cast<const float4*>(pi[k])[ty];
      const float4 b4 = reinterpret_cast<const float4*>(pj[k])[tx];
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) gs[r][c] += a[r] * b[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) g[r][c] += gs[r][c];
    float ms = 0.0f;
    if (tid < kBins) {
      for (int k = 0; k < kSub; ++k) ms += pi[k][tid];
    } else if (tid < 2 * kBins) {
      for (int k = 0; k < kSub; ++k) ms += pj[k][tid - kBins];
    }
    marg += ms;
    __syncthreads();  // pi, pj, vi, vj are staged again
  }
  float* out = partial + (n * gridDim.x + blockIdx.x) * (int64_t)kStats;
  if (tid < 2 * kBins) out[tid] = marg;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[2 * kBins + (ty * 4 + r) * kBins + tx * 4 + c] = g[r][c];
}

// -sum_b pn_b log(pn_b + 1e-10), pn = (s / m) / (sum(s / m) + 1e-10).
__device__ float marginal_entropy(const float* s, int bins, float m,
                                  float* scratch) {
  const int tid = threadIdx.x;
  const float u = tid < bins ? s[tid] / m : 0.0f;
  const float T = block_sum_all<kEpiThreads>(u, scratch) + 1e-10f;
  const float pn = u / T;
  return -block_sum_all<kEpiThreads>(tid < bins ? pn * logf(pn + 1e-10f) : 0.0f,
                                     scratch);
}

// grid N: the sample's statistics (partials summed in chunk order), packed
// as [s_i (bins), s_j (bins), joint (bins x bins)], and per[n] = -MI.
__global__ void __launch_bounds__(kEpiThreads)
    mi_fwd_epilogue_kernel(const float* __restrict__ partial, int chunks,
                           float* __restrict__ stats, float* __restrict__ per,
                           float m, int bins, float norm2d) {
  __shared__ float tot[kStats];
  __shared__ float scratch[kEpiThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const float* src = partial + n * chunks * (int64_t)kStats;
  for (int e = tid; e < kStats; e += kEpiThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) acc += src[(int64_t)c * kStats + e];
    tot[e] = acc;
  }
  __syncthreads();
  const int n_stats = 2 * bins + bins * bins;
  float* st = stats + n * n_stats;
  for (int e = tid; e < n_stats; e += kEpiThreads) {
    int from;
    if (e < bins) {
      from = e;
    } else if (e < 2 * bins) {
      from = kBins + e - bins;
    } else {
      const int a = (e - 2 * bins) / bins;
      from = 2 * kBins + a * kBins + (e - 2 * bins - a * bins);
    }
    st[e] = tot[from];
  }
  const float ent_i = marginal_entropy(tot, bins, m, scratch);
  const float ent_j = marginal_entropy(tot + kBins, bins, m, scratch);
  const float* joint = tot + 2 * kBins;
  float gsum = 0.0f;
  for (int e = tid; e < bins * bins; e += kEpiThreads)
    gsum += joint[(e / bins) * kBins + e % bins] / norm2d;
  const float S = block_sum_all<kEpiThreads>(gsum, scratch) + 1e-10f;
  float h = 0.0f;
  for (int e = tid; e < bins * bins; e += kEpiThreads) {
    const float q = (joint[(e / bins) * kBins + e % bins] / norm2d) / S;
    h += q * logf(q + 1e-10f);
  }
  const float ent_joint = -block_sum_all<kEpiThreads>(h, scratch);
  if (tid == 0) per[n] = -(ent_i + ent_j - ent_joint);
}

// One thread: loss = the mean of per[0..n), summed in order.
__global__ void mi_mean_kernel(const float* __restrict__ per, int64_t n,
                               float* __restrict__ loss) {
  if (threadIdx.x != 0) return;
  float t = 0.0f;
  for (int64_t k = 0; k < n; ++k) t += per[k];
  *loss = t / (float)n;
}

// d(ent)/d(s_b) = w_b / m for the marginal pn = (s / m) / T (:333-339);
// returns w for bin threadIdx.x (0 past `bins`).
__device__ float marginal_weight(const float* s, int bins, float m,
                                 float* scratch) {
  const int tid = threadIdx.x;
  const float u = tid < bins ? s[tid] / m : 0.0f;
  const float T = block_sum_all<kEpiThreads>(u, scratch) + 1e-10f;
  const float pn = u / T;
  const float lc = logf(pn + 1e-10f) + pn / (pn + 1e-10f);
  const float L = block_sum_all<kEpiThreads>(tid < bins ? lc * pn : 0.0f, scratch);
  return tid < bins ? -(lc - L) / T : 0.0f;
}

// grid N: coef[n] = [-w_I / m (kBins), -w_J / m (kBins), EQ (kBins x
// kBins)], zero past `bins`, from the statistics packed as the forward
// writes them.
__global__ void __launch_bounds__(kEpiThreads)
    mi_bwd_coef_kernel(const float* __restrict__ stats,
                       float* __restrict__ coef, float m, int bins,
                       float norm2d) {
  __shared__ float scratch[kEpiThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const float* st = stats + n * (2 * bins + bins * bins);
  float* co = coef + n * (int64_t)kStats;
  const float w_i = marginal_weight(st, bins, m, scratch);
  const float w_j = marginal_weight(st + bins, bins, m, scratch);
  if (tid < kBins) {
    co[tid] = -w_i / m;
    co[kBins + tid] = -w_j / m;
  }
  const float* joint = st + 2 * bins;
  float gsum = 0.0f;
  for (int e = tid; e < bins * bins; e += kEpiThreads) gsum += joint[e] / norm2d;
  const float Sg = block_sum_all<kEpiThreads>(gsum, scratch) + 1e-10f;
  float lsum = 0.0f;
  for (int e = tid; e < bins * bins; e += kEpiThreads) {
    const float q = (joint[e] / norm2d) / Sg;
    lsum += (logf(q + 1e-10f) + q / (q + 1e-10f)) * q;
  }
  const float L = block_sum_all<kEpiThreads>(lsum, scratch);
  for (int e = tid; e < kBins * kBins; e += kEpiThreads) {
    const int a = e / kBins;
    const int b = e - a * kBins;
    float eq = 0.0f;
    if (a < bins && b < bins) {
      const float q = (joint[a * bins + b] / norm2d) / Sg;
      const float lq = logf(q + 1e-10f) + q / (q + 1e-10f);
      eq = -(lq - L) / Sg;
    }
    co[2 * kBins + e] = eq;
  }
}

// dL/dv at one pixel for the image whose value there is v (before the
// upstream scale): q_b are the other image's responses there, e[a][b] the
// joint coefficients as this image's bin a meets the other's bin b, w the
// entropy weights -w/m.
__device__ __forceinline__ float pixel_grad(float v, float other,
                                            const float (*e)[kBins],
                                            const float* w, const Parzen& p,
                                            float norm2d, float inv_sigma2) {
  float q[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b)
    q[b] = b < p.bins ? response(other, center(b, p), p) : 0.0f;
  float acc = 0.0f;
  for (int a = 0; a < p.bins; ++a) {
    const float4* row = reinterpret_cast<const float4*>(e[a]);
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;  // four chains
#pragma unroll
    for (int k = 0; k < kBins / 4; ++k) {
      const float4 r = row[k];
      d0 += r.x * q[4 * k];
      d1 += r.y * q[4 * k + 1];
      d2 += r.z * q[4 * k + 2];
      d3 += r.w * q[4 * k + 3];
    }
    const float dldp = w[a] + ((d0 + d1) + (d2 + d3)) / norm2d;
    const float c = center(a, p);
    acc += (dldp * response(v, c, p)) * (c - v);  // subtract, then reduce
  }
  return acc * inv_sigma2;
}

// grid (ceil(M / kBwdPixels), N): dI, dJ of kBwdPixels pixels a block.
__global__ void __launch_bounds__(kBwdThreads)
    mi_bwd_pixel_kernel(const float* __restrict__ I,
                        const float* __restrict__ J,
                        const float* __restrict__ coef,
                        const float* __restrict__ gout, float* __restrict__ dI,
                        float* __restrict__ dJ, int64_t n_samples, int64_t m,
                        Parzen p, float norm2d, float inv_sigma2) {
  __shared__ __align__(16) float eq[kBins][kBins];   // EQ[a][b]
  __shared__ __align__(16) float eqt[kBins][kBins];  // EQ[b][a]
  __shared__ float wi[kBins];
  __shared__ float wj[kBins];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.y;
  const float* co = coef + n * (int64_t)kStats;
  for (int e = tid; e < kBins * kBins; e += kBwdThreads) {
    const int a = e / kBins;
    const int b = e - a * kBins;
    eq[a][b] = co[2 * kBins + e];
    eqt[a][b] = co[2 * kBins + b * kBins + a];
  }
  if (tid < kBins) {
    wi[tid] = co[tid];
    wj[tid] = co[kBins + tid];
  }
  __syncthreads();
  const float s = *gout / (float)n_samples;  // the batch mean
  const int64_t start = (int64_t)blockIdx.x * kBwdPixels;
  for (int k = tid; k < kBwdPixels && start + k < m; k += kBwdThreads) {
    const int64_t o = n * m + start + k;
    const float vi = I[o];
    const float vj = J[o];
    dI[o] = s * pixel_grad(vi, vj, eq, wi, p, norm2d, inv_sigma2);
    dJ[o] = s * pixel_grad(vj, vi, eqt, wj, p, norm2d, inv_sigma2);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. I, J: [n, m] f32, contiguous;
// 2 <= bins <= 64. The Parzen floats: minv, step = (maxv - minv) /
// (bins - 1), inv_two_sigma2 = 1 / (2 sigma^2), norm1d = sqrt(2 pi)
// sigma, norm2d = 2 pi sigma^2, inv_sigma2 = 1 / sigma^2. Each launches
// on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a bin count it does not take); none
// synchronises or allocates. The forward takes all but inv_sigma2.

// partial: [n * ceil(m / 2048) * 4224] scratch; stats: [n, 2 bins +
// bins^2]; per: [n] scratch; loss: one f32, the batch mean of -MI.
extern "C" int san_mi_fwd(const void* I, const void* J, void* partial,
                          void* stats, void* per, void* loss, int64_t n,
                          int64_t m, int bins, float minv, float step,
                          float inv_two_sigma2, float norm1d, float norm2d,
                          void* stream) {
  if (bins < 2 || bins > kBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Parzen p{bins, minv, step, inv_two_sigma2, norm1d};
  const int chunks = (int)((m + kChunk - 1) / kChunk);
  mi_fwd_partial_kernel<<<dim3(chunks, (unsigned)n), kFwdThreads, 0, s>>>(
      (const float*)I, (const float*)J, (float*)partial, m, p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mi_fwd_epilogue_kernel<<<(unsigned)n, kEpiThreads, 0, s>>>(
      (const float*)partial, chunks, (float*)stats, (float*)per, (float)m,
      bins, norm2d);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mi_mean_kernel<<<1, 32, 0, s>>>((const float*)per, n, (float*)loss);
  return (int)cudaGetLastError();
}

// stats: the forward's; coef: [n * 4224] scratch; gout: the upstream
// gradient of the loss (one f32 on the device); dI, dJ: [n, m].
extern "C" int san_mi_bwd(const void* I, const void* J, const void* stats,
                          void* coef, const void* gout, void* dI, void* dJ,
                          int64_t n, int64_t m, int bins, float minv,
                          float step, float inv_two_sigma2, float norm1d,
                          float norm2d, float inv_sigma2, void* stream) {
  if (bins < 2 || bins > kBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Parzen p{bins, minv, step, inv_two_sigma2, norm1d};
  mi_bwd_coef_kernel<<<(unsigned)n, kEpiThreads, 0, s>>>(
      (const float*)stats, (float*)coef, (float)m, bins, norm2d);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((m + kBwdPixels - 1) / kBwdPixels), (unsigned)n);
  mi_bwd_pixel_kernel<<<grid, kBwdThreads, 0, s>>>(
      (const float*)I, (const float*)J, (const float*)coef,
      (const float*)gout, (float*)dI, (float*)dJ, n, m, p, norm2d,
      inv_sigma2);
  return (int)cudaGetLastError();
}
