// Parzen-window MI loss, forward and closed-form backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/mi.py: the forward `_forward` /
// `_mi_kernel` (pallas_call at :106) and the backward `_backward` /
// `_mi_bwd_kernel` (pallas_call at :246). The TPU kernels walk one
// sample's pixels in sequence (padded with 1e6 to a multiple of 2048);
// here each sample's M pixels are cut into tiles of 64, masked past M, and
// a grid that fills the card once takes them in turn, each block looping
// over its tiles.
//
// MI as the reference's loss (miloss.py:26-57): per sample, Gaussian
// responses p_b(v) = exp(-(v - c_b)^2 / (2 sigma^2)) / (sqrt(2 pi) sigma)
// at bins <= 64 centres c_b = b ((max - min) / (bins - 1)) + min (the
// Pallas kernel's form); marginal sums s_b = sum_px p_b and the joint
// Gram G_ab = sum_px p_a(I) p_b(J); loss = mean over the batch of
// -(H_I + H_J - H_IJ). f32 throughout, expf and logf without fast math;
// the products (the JAX kernel pins Precision.HIGHEST) on the tensor
// cores as 3xTF32: each operand split into hi = tf32(v) and lo = tf32(v -
// hi), rounded to nearest with ties away from zero as cvt.rna.tf32.f32
// rounds, and each product taken as lo.hi + hi.lo + hi.hi, in that order,
// on mma.sync.m16n8k8. Emulated (tests/test_torch_port_losses.py), TF32
// alone misses the statistics' bar by 1.5-3.5x and, fed those statistics,
// the backward's near the top bin by 6.5x; 3xTF32 meets both.
//
// mi_fwd: launch 1 (blocks a sample from kernels/mi.py's fwd_blocks: two
// blocks an SM, split over the samples, at most one a tile) loops over
// tiles of 64 pixels. A tile's responses p_I and p_J are computed once
// each (128 expf a pixel pair at 64 bins), masked by a product past
// `bins` and past M, into [bin][pixel] rows of 68 words; a thread takes
// two bins of 8 pixels of both images and keeps their marginal sums in
// registers (8 pixels, then the block's running sum, then the 8 lanes of
// a bin pair: the f32 responses, not hi + lo). The joint Gram G = P_I
// P_J^T (M = 64 bins of I, N = 64 bins of J, K = 64 pixels) is 32 tiles of
// 16 x 8, 4 a warp: A = P_I and B = P_J (stored n-major, as `.col` takes
// it) both by ldmatrix.x4 on the rows (lane 4g + t gets word t of row g),
// split into hi and lo as they load; the three products of a K step each
// over the warp's 4 tiles before the next, into a fresh f32 sum a tile of
// 64 pixels, added by a round-to-nearest FADD to the block's sum (the
// mma's own sums do not round to nearest). Each block writes one partial
// [2 x 64 marginals, 64 x 64 Gram]. Launch 2 sums each entry of the
// statistics over the partials in block order, an entry a thread across
// 17 blocks a sample, and writes the statistics [2 bins + bins^2] (kept by
// the autograd Function for the backward, so it does not recompute them
// as the Pallas backward does); launch 3 (one block a sample) runs the
// entropy epilogue (:232-244); launch 4 takes the batch mean in order. No
// float atomics anywhere: the bits repeat run to run.
//
// mi_bwd: launch 1 (one block of 1024 threads a sample) computes from
// the saved statistics the entropy weights -w/m [bins] of each marginal
// and the joint coefficients EQ [bins, bins] (:333-349), each coefficient
// once, and writes EQ and EQ^T already split for 3xTF32, row by row.
// Launch 2 takes dL/dp_I = -w_I/m + (EQ p_J)/norm2d and dL/dp_J = -w_J/m +
// (EQ^T p_I)/norm2d, then dv = sum_b dL/dp_b p_b (c_b - v) / sigma^2,
// subtracting before the sum over bins (:357-384): sum_b A_b c_b - v
// sum_b A_b would cancel, amplified by 1/sigma^2 = 4096. A block copies
// the sample's 64 KB of split coefficients into shared memory once
// (cp.async), then loops over tiles of 64 pixels, two blocks an SM. A
// tile's responses p_I and p_J are computed once each into [pixel][bin]
// rows. The two products D_I = EQ P_J and D_J = EQ^T P_I (M = 64 bins, K
// = 64 bins, N = pixels) run on mma.sync.m16n8k8 as 3xTF32 into one f32
// sum (24 mma a 16 x 8 tile over K = 64). A fragments by ldmatrix.x4 on
// the split EQ rows, B fragments by ldmatrix.x4 on the response rows (the
// same mapping gives B (k = t, n = g)), split into hi and lo as they load:
// a warp uses each B word once, across its 4 m-tiles and 3 products. Rows
// are 68 words, so the 8 rows of an ldmatrix fall in 8 bank groups. The
// epilogue stays in registers: a thread forms the terms of its 8 bins (C
// rows g, g + 8 of each m-tile) for 2 pixels of each n-tile, from the f32
// responses (not hi + lo), sums them in a fixed order, and a butterfly
// over the 8 g-lanes finishes the sum over bins; no atomics, no sum split
// over blocks, so the bits repeat run to run.
//
// What set their time on an NVIDIA H100 80GB HBM3 at 700 W (variants
// timed with `mi_phases()`): not the mma but the responses. The IEEE
// divide of each response by norm1d took its slow path for the 0 and
// subnormal Gaussians that most of a pixel's bins give, and its branch,
// like a select around the response and the unrolled loop's exit tests,
// kept the compiler from interleaving responses; the divide is now a
// product and an fma correction, the same bits. The forward's time
// before this design was one block's serial walk over 2048 pixels, with
// 16 blocks in all at 80 x 80; its grid now fills the card at every
// plane, and its epilogue holds a thread's joint entries in registers
// (its loads issued together) over 1024 threads. Splitting the forward's
// responses into hi and lo rows as they are written, in place of as the
// fragments load, doubles the shared memory and the ldmatrix and gained
// nothing, so the split's issue is not what holds the Gram launch at 5x
// its bound; a fresh sum each K step of 8 pixels cost 10% and took the
// statistics further from float64.
//
// Bound on the H100 SXM, at the path's shape (I and J [4, 1, 320, 320],
// 409,600 pixel pairs, 64 bins), the larger of the tensor cores' and the
// FP32 pipe's times (the two issue side by side; reading 3.3 MB takes
// under 1 us). The forward's Gram is 2 * 64 * 64 flops a pixel pair, 3.36
// GFLOP: 20 us as 3xTF32 (three TF32 products at 495 TFLOP/s); its
// responses and marginals (12 flops a bin a pixel pair) take 5 us at 67
// TFLOP/s on the FP32 pipe: bound 20 us, and 55 us with all of it on FFMA.
// The backward's two 64 x 64 matrix-vector products a pixel are 6.7
// GFLOP: 41 us as 3xTF32. Its responses, each computed once (5 flops a
// bin, both images), and the per-bin terms (6 a bin, both images), 22
// flops a bin a pixel pair, take 9 us: bound 41 us, and 109 us with all
// of it on FFMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBins = 64;        // padded bin count
constexpr int kStats = 2 * kBins + kBins * kBins;  // s_i, s_j, joint
constexpr int kFwdThreads = 256;  // 8 warps: 4 Gram tiles of 16 x 8 each
constexpr int kFwdTile = 64;     // pixels a forward tile
// forward blocks an SM: kernels/mi.py's FWD_BLOCKS_PER_SM, which sizes
// the grid and the partials' scratch
constexpr int kFwdBlocks = 2;
constexpr int kRedThreads = 256;  // an entry of the statistics a thread
constexpr int kEpiThreads = 1024;  // 4 joint entries a thread
constexpr int kCoefThreads = 1024;  // 4 coefficients a thread
constexpr int kBwdThreads = 256;  // 8 warps: 4 for dI, 4 for dJ
constexpr int kBwdTile = 64;     // pixels a backward tile
constexpr int kBwdBlocks = 2;    // backward blocks an SM
constexpr int kRow = kBins + 4;  // words a staged row: 8 rows span 8 bank groups
// a sample's backward coefficients: -w_I / m, -w_J / m, then EQ and EQ^T,
// each as its TF32 hi and lo parts
constexpr int kCoef = 2 * kBins + 4 * kBins * kBins;

struct Parzen {
  int bins;
  float minv, step, inv_two_sigma2, norm1d;
};

// c_b = b * step + min, rounded as the Pallas kernel's f32 iota arithmetic
// (no fused multiply-add)
__device__ __forceinline__ float center(int b, const Parzen& p) {
  return __fadd_rn(__fmul_rn((float)b, p.step), p.minv);
}

// x / d (x >= 0) as C++ divides it, to the bit, without the IEEE divide's
// slow path (tens of instructions, a warp's lanes in turn), which it takes
// for a dividend of 0: 1 is divided in its place. As asm, since the
// compiler would otherwise divide x itself and select after.
__device__ __forceinline__ float div_nonneg(float x, float d) {
  float q;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(x == 0.0f ? 1.0f : x), "f"(d));
  return x == 0.0f ? 0.0f : q;
}

// The Gaussian response exp(-(v - c)^2 / (2 sigma^2)) / norm1d, its
// quotient taken without a divide: q0 = e r, r = RN(1 / norm1d), and one
// fma correction give RN(e / norm1d), the IEEE divide's quotient to the
// bit (Markstein's theorem), for e of 2^-100 or more; a smaller e, where
// the correction's remainder could underflow, keeps q0, within one of its
// ulps. The IEEE divide ends in a branch to its slow path (taken for the
// 0 and subnormal e that most of a pixel's 64 bins give), and the branch
// keeps the compiler from interleaving responses.
__device__ __forceinline__ float response_fma(float v, float c, const Parzen& p,
                                              float inv_norm1d) {
  const float d = v - c;
  const float e = expf(-(d * d) * p.inv_two_sigma2);
  const float q0 = __fmul_rn(e, inv_norm1d);
  const float q = fmaf(fmaf(-p.norm1d, q0, e), inv_norm1d, q0);
  return e < 0x1p-100f ? q0 : q;
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

// d(ent)/d(s_b) = w_b / m for the marginal pn = (s / m) / T (:333-339);
// returns w for bin threadIdx.x (0 past `bins`).
template <int kThreads>
__device__ float marginal_weight(const float* s, int bins, float m,
                                 float* scratch) {
  const int tid = threadIdx.x;
  const float u = tid < bins ? s[tid] / m : 0.0f;
  const float T = block_sum_all<kThreads>(u, scratch) + 1e-10f;
  const float pn = u / T;
  const float lc = logf(pn + 1e-10f) + pn / (pn + 1e-10f);
  const float L = block_sum_all<kThreads>(tid < bins ? lc * pn : 0.0f, scratch);
  return tid < bins ? -(lc - L) / T : 0.0f;
}

// ------------------------------------------------- 3xTF32 on mma.sync
// Copies of conv.cu's helpers (this file builds alone, and the build
// cache hashes one source).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, through L2 only.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a b on m16n8k8 TF32 tiles with f32 sums; not volatile, so the
// compiler may issue the next K step's ldmatrix ahead of it (the order of
// the mma on one c stays). Fragments (PTX ISA):
// lane = 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// B (k = t, n = g), (k = t + 4, n = g), and C (g, 2 t), (g, 2 t + 1),
// (g + 8, 2 t), (g + 8, 2 t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 word v rounded to TF32 as cvt.rna.tf32.f32 rounds it (finite v):
// 10 mantissa bits, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) { return (v + 0x1000u) & 0xffffe000u; }

// The 3xTF32 split of v: hi = tf32(v), lo = tf32(v - hi); v - hi is exact.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi))));
}

// ------------------------------------------------------------- forward

// grid (blocks, N): block x of sample n takes the pixel tiles x, x +
// blocks, ... of kFwdTile pixels each and writes one partial,
// partial[(n * blocks + x) * kStats + e]: its marginal sums (e < 2 kBins)
// and joint Gram (row-major after). A tile's responses p_I and p_J are
// computed once each (128 expf a pixel pair at 64 bins) into [bin][pixel]
// rows; the Gram G = P_I P_J^T (M = 64 bins of I, N = 64 bins of J, K =
// 64 pixels) runs on mma.sync.m16n8k8 as 3xTF32, each warp 4 of its 32
// tiles of 16 x 8.
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
    mi_fwd_gram_kernel(const float* __restrict__ I, const float* __restrict__ J,
                       float* __restrict__ partial, int64_t m, Parzen p) {
  static_assert(kFwdThreads == 256 && kFwdTile == 64 && kBins == 64,
                "the response and Gram maps below: 8 warps of 8 bins, 4 tiles");
  __shared__ __align__(16) float ps[2][kBins][kRow];  // p_I, p_J: [bin][pixel]
  __shared__ float vs[2][kFwdTile];                   // v_I, v_J
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t n = blockIdx.y;
  const int64_t tiles = (m + kFwdTile - 1) / kFwdTile;
  // thread tid < 2 kFwdTile loads pixel tid % kFwdTile of image tid / kFwdTile
  const float* src = (tid < kFwdTile ? I : J) + n * m;
  auto value = [&](int64_t tile) {
    const int64_t px = tile * kFwdTile + tid % kFwdTile;
    return tid < 2 * kFwdTile && tile < tiles && px < m ? src[px] : 0.0f;
  };
  float v_next = value(blockIdx.x);

  // a thread's responses: bins b0 and b0 + 1 of pixels k0 + 8 s, both
  // images; a warp's 32 stores of one (image, bin, s) fall in 32 banks.
  // Their marginal sums are kept in registers: 8 pixels a tile, then the
  // block's running sum, then the 8 lanes of a bin pair
  const int b0 = 8 * warp + 2 * (lane >> 3);
  const int k0 = lane & 7;
  const float c_resp[2] = {center(b0, p), center(b0 + 1, p)};
  const float bin_ok[2] = {b0 < p.bins ? 1.0f : 0.0f, b0 + 1 < p.bins ? 1.0f : 0.0f};
  const float inv_norm1d = 1.0f / p.norm1d;
  float marg[2][2] = {};

  // the warp's Gram tiles: rows 16 mt + (0..15) (bins of I), columns 8 (nt0
  // + j) + (0..7) (bins of J). ldmatrix rows: A, bins 16 mt + (lane & 15)
  // of p_I at k (lane >> 4) 4; B (two n-tiles), bins 8 (nt0 + j + (lane >>
  // 4)) + (lane & 7) of p_J at k ((lane >> 3) & 1) 4: lane 4 g + t gets A
  // (g, t) and B (k = t, n = g), the fragments of mma_tf32
  const int mt = warp >> 1;
  const int nt0 = 4 * (warp & 1);
  const uint32_t a_base =
      smem_addr(&ps[0][0][0]) + ((16 * mt + (lane & 15)) * kRow + (lane >> 4) * 4) * 4;
  const uint32_t b_base = smem_addr(&ps[1][0][0]) +
      ((8 * (nt0 + (lane >> 4)) + (lane & 7)) * kRow + ((lane >> 3) & 1) * 4) * 4;
  float run[4][4] = {};  // the block's Gram tiles

  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers are done
    if (tid < 2 * kFwdTile) vs[tid / kFwdTile][tid % kFwdTile] = v_next;
    __syncthreads();
    v_next = value(tile + gridDim.x);  // in flight through this tile
    // each response once, zero past `bins` and past m. No branch between
    // the unrolled responses, so that the compiler interleaves them: the
    // mask is a product and the trip count a constant
    const int64_t px0 = tile * kFwdTile;
    const int left = (int)(m - px0 < kFwdTile ? m - px0 : kFwdTile);
#pragma unroll
    for (int img = 0; img < 2; ++img) {
      float ts[2] = {0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kFwdTile / 8; ++s) {
        const int k = k0 + 8 * s;
        const float v = vs[img][k];
        const float px_ok = k < left ? 1.0f : 0.0f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float r = response_fma(v, c_resp[c], p, inv_norm1d) * (bin_ok[c] * px_ok);
          ps[img][b0 + c][k] = r;
          ts[c] += r;
        }
      }
      marg[img][0] += ts[0];
      marg[img][1] += ts[1];
    }
    __syncthreads();

    // the tile's Gram: K = 64 pixels in 8 steps, each product as lo.hi +
    // hi.lo + hi.hi into a fresh f32 sum, each of the three over the
    // warp's 4 tiles before the next (three in a row on one tile wait on
    // each other); fragments split into hi and lo as they load
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kFwdTile / 8; ++kk) {
      uint32_t r[4], ah[4], al[4], bh[4][2], bl[4][2];
      ldsm_x4(r, a_base + kk * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(r[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        ldsm_x4(r, b_base + (uint32_t)(8 * j * kRow + 8 * kk) * 4);
        split_tf32(r[0], bh[j][0], bl[j][0]);
        split_tf32(r[1], bh[j][1], bl[j][1]);
        split_tf32(r[2], bh[j + 1][0], bl[j + 1][0]);
        split_tf32(r[3], bh[j + 1][1], bl[j + 1][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
    }
    // a round-to-nearest add into the block's sum (the mma's own sums do
    // not round to nearest)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[j][i] = __fadd_rn(run[j][i], acc[j][i]);
  }

  float* out = partial + (n * gridDim.x + blockIdx.x) * (int64_t)kStats;
  // the marginals: a butterfly over the 8 lanes k0 of each bin pair
#pragma unroll
  for (int img = 0; img < 2; ++img) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = marg[img][c];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (k0 == 0) out[img * kBins + b0 + c] = v;
    }
  }
  // the Gram: lane 4 g + t holds C (g, 2 t), (g, 2 t + 1), (g + 8, 2 t),
  // (g + 8, 2 t + 1) of each tile
  const int g = lane >> 2;
  const int t = lane & 3;
  float* gram = out + 2 * kBins;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = 16 * mt + g;
    const int b = 8 * (nt0 + j) + 2 * t;
    *reinterpret_cast<float2*>(gram + a * kBins + b) = make_float2(run[j][0], run[j][1]);
    *reinterpret_cast<float2*>(gram + (a + 8) * kBins + b) = make_float2(run[j][2], run[j][3]);
  }
}

// grid (ceil(kStats / kRedThreads), N): entry e of sample n summed over
// its `blocks` partials in block order (no float atomics, so the bits
// repeat run to run), written where it goes in the statistics, packed as
// [s_i (bins), s_j (bins), joint (bins x bins)]; entries past `bins` are
// not read.
__global__ void __launch_bounds__(kRedThreads)
    mi_fwd_reduce_kernel(const float* __restrict__ partial, int blocks,
                         float* __restrict__ stats, int bins) {
  const int e = blockIdx.x * kRedThreads + threadIdx.x;
  if (e >= kStats) return;
  int to;  // e's place in the packed statistics
  if (e < 2 * kBins) {
    const int b = e % kBins;
    to = b < bins ? (e / kBins) * bins + b : -1;
  } else {
    const int a = (e - 2 * kBins) / kBins;
    const int b = (e - 2 * kBins) % kBins;
    to = a < bins && b < bins ? 2 * bins + a * bins + b : -1;
  }
  if (to < 0) return;
  const int64_t n = blockIdx.y;
  const float* src = partial + n * blocks * (int64_t)kStats + e;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < blocks; ++c) acc += src[(int64_t)c * kStats];
  stats[n * (2 * bins + bins * bins) + to] = acc;
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

// grid N: per[n] = -MI of sample n from its statistics (the entropy
// epilogue of ops/pallas/mi.py:232-244). A thread's joint entries, tid +
// kEpiThreads i, are loaded together and kept in registers.
__global__ void __launch_bounds__(kEpiThreads)
    mi_fwd_entropy_kernel(const float* __restrict__ stats, float* __restrict__ per,
                          float m, int bins, float norm2d) {
  constexpr int kPer = kBins * kBins / kEpiThreads;
  __shared__ float scratch[kEpiThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const float* st = stats + n * (2 * bins + bins * bins);
  const float* joint = st + 2 * bins;
  float q[kPer];  // the joint over norm2d, then over its sum; 0 past bins^2
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kEpiThreads * i;
    q[i] = e < bins * bins ? joint[e] : 0.0f;
  }
  const float ent_i = marginal_entropy(st, bins, m, scratch);
  const float ent_j = marginal_entropy(st + bins, bins, m, scratch);
  float gsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    q[i] = div_nonneg(q[i], norm2d);
    gsum += q[i];
  }
  const float S = block_sum_all<kEpiThreads>(gsum, scratch) + 1e-10f;
  float h = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float qs = div_nonneg(q[i], S);
    h += qs * logf(qs + 1e-10f);  // 0 for the entries past bins^2
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

// ------------------------------------------------------------ backward

// grid N: coef[n] = [-w_I / m (kBins), -w_J / m (kBins), EQ hi, EQ lo,
// EQ^T hi, EQ^T lo (kBins x kBins each, row-major)], zero past `bins`,
// from the statistics packed as the forward writes them. EQ^T[b][a] =
// EQ[a][b]; hi and lo are the 3xTF32 split of each coefficient.
__global__ void __launch_bounds__(kCoefThreads)
    mi_bwd_coef_kernel(const float* __restrict__ stats,
                       float* __restrict__ coef, float m, int bins,
                       float norm2d) {
  __shared__ float scratch[kCoefThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const float* st = stats + n * (2 * bins + bins * bins);
  float* co = coef + n * (int64_t)kCoef;
  const float w_i = marginal_weight<kCoefThreads>(st, bins, m, scratch);
  const float w_j = marginal_weight<kCoefThreads>(st + bins, bins, m, scratch);
  if (tid < kBins) {
    co[tid] = -w_i / m;
    co[kBins + tid] = -w_j / m;
  }
  // a thread's entries e = tid + kCoefThreads i of the padded 64 x 64,
  // each computed once and kept in registers through the three passes;
  // the padding adds exact zeros to the sums and is written as 0
  constexpr int kMat = kBins * kBins;
  constexpr int kPer = kMat / kCoefThreads;
  const float* joint = st + 2 * bins;
  float G[kPer];
  float gsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int a = (tid + kCoefThreads * i) / kBins;
    const int b = (tid + kCoefThreads * i) % kBins;
    G[i] = a < bins && b < bins ? div_nonneg(joint[a * bins + b], norm2d) : 0.0f;
    gsum += G[i];
  }
  const float Sg = block_sum_all<kCoefThreads>(gsum, scratch) + 1e-10f;
  float lsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float q = div_nonneg(G[i], Sg);
    G[i] = logf(q + 1e-10f) + div_nonneg(q, q + 1e-10f);  // lq
    lsum += G[i] * q;
  }
  const float L = block_sum_all<kCoefThreads>(lsum, scratch);
  uint32_t* eq = reinterpret_cast<uint32_t*>(co + 2 * kBins);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + kCoefThreads * i;
    const int a = e / kBins;
    const int b = e % kBins;
    const float v = a < bins && b < bins ? -(G[i] - L) / Sg : 0.0f;
    uint32_t hi, lo;
    split_tf32(__float_as_uint(v), hi, lo);
    eq[e] = hi;
    eq[kMat + e] = lo;
    eq[2 * kMat + b * kBins + a] = hi;
    eq[3 * kMat + b * kBins + a] = lo;
  }
}

// Dynamic shared memory of the pixel kernel, in floats: the four
// coefficient matrices and the two images' responses as rows of kRow, and
// the two images' values.
constexpr int kBwdSmem = 4 * kBins * kRow + 2 * kBwdTile * kRow + 2 * kBwdTile;

// grid (blocks, N): block x of sample n takes the pixel tiles x, x +
// blocks, ... of kBwdTile pixels each. Half the warps compute D_I = EQ P_J
// (then dI), half D_J = EQ^T P_I (then dJ), each all 64 bins of kNT
// n-tiles (8 pixels) of the tile on the tensor cores, and reduce them over
// the bins in registers.
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks)
    mi_bwd_pixel_kernel(const float* __restrict__ I,
                        const float* __restrict__ J,
                        const float* __restrict__ coef,
                        const float* __restrict__ gout, float* __restrict__ dI,
                        float* __restrict__ dJ, int64_t n_samples, int64_t m,
                        Parzen p, float inv_norm2d, float inv_sigma2) {
  constexpr int kWarps = kBwdThreads / 64;  // warps a product
  constexpr int kNT = kBwdTile / (8 * kWarps);  // n-tiles a warp
  static_assert(kNT % 2 == 0 && kNT <= 4, "ldmatrix takes n-tiles in pairs; one store a warp");
  static_assert(2 * kBwdTile <= kBwdThreads && kBwdThreads % kBins == 0, "a value a thread");
  extern __shared__ __align__(16) float smem[];
  float* eqs = smem;                        // [4][kBins][kRow]: EQ hi, lo; EQ^T hi, lo
  float* ps = eqs + 4 * kBins * kRow;       // [2][kBwdTile][kRow]: p_I, p_J by pixel
  float* vs = ps + 2 * kBwdTile * kRow;     // [2][kBwdTile]: v_I, v_J
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t n = blockIdx.y;
  const float* co = coef + n * (int64_t)kCoef;

  // the coefficients, once a block: rows of 64 words into rows of kRow
  for (int i = tid; i < kBins * kBins; i += kBwdThreads)
    cp_async16(smem_addr(eqs + (i >> 4) * kRow + 4 * (i & 15)), co + 2 * kBins + 4 * i);
  const float s = *gout / (float)n_samples;  // the batch mean
  const int64_t tiles = (m + kBwdTile - 1) / kBwdTile;
  // thread tid < 2 kBwdTile loads pixel tid % kBwdTile of image tid / kBwdTile
  const float* src = (tid < kBwdTile ? I : J) + n * m;
  auto value = [&](int64_t tile) {
    const int64_t px = tile * kBwdTile + tid % kBwdTile;
    return tid < 2 * kBwdTile && tile < tiles && px < m ? src[px] : 0.0f;
  };
  float v_next = value(blockIdx.x);
  cp_async_wait_all();

  const int prod = warp / kWarps;  // 0: D_I = EQ P_J; 1: D_J = EQ^T P_I
  const int nt0 = (warp % kWarps) * kNT;
  const float* a_hi = eqs + 2 * prod * kBins * kRow;
  const float* a_lo = a_hi + kBins * kRow;
  const float* p_b = ps + (1 - prod) * kBwdTile * kRow;  // B: the other image's
  const float* p_own = ps + prod * kBwdTile * kRow;
  const float* v_own = vs + prod * kBwdTile;
  // the weights -w/m and centres of the thread's 8 epilogue bins, a = 16 mt
  // + 8 r + g, and the centre of its response bin
  float w_a[4][2], c_a[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      w_a[mt][r] = co[prod * kBins + 16 * mt + 8 * r + g];
      c_a[mt][r] = center(16 * mt + 8 * r + g, p);
    }
  }
  const int b_resp = tid % kBins;
  const float c_resp = center(b_resp, p);
  const float inv_norm1d = 1.0f / p.norm1d;
  float* out = (prod ? dJ : dI) + n * m;
  // ldmatrix rows: A, bins 16 mt + (lane & 15) at k (lane >> 4) 4; B (two
  // n-tiles), pixels 8 (nt0 + j + (lane >> 4)) + (lane & 7) at k
  // ((lane >> 3) & 1) 4
  const uint32_t a_off = ((lane & 15) * kRow + (lane >> 4) * 4) * 4;
  const uint32_t b_off = ((8 * (nt0 + (lane >> 4)) + (lane & 7)) * kRow + ((lane >> 3) & 1) * 4) * 4;

  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();  // the last tile's readers are done (and the staging landed)
    if (tid < 2 * kBwdTile) vs[tid] = v_next;
    __syncthreads();
    v_next = value(tile + gridDim.x);  // in flight through this tile
    // each response once: [image][pixel][bin], zero past `bins` and past
    // m. No branch between the unrolled responses, so that the compiler
    // interleaves them: the mask is a product (a select becomes a branch
    // around the response) and the trip count a constant (no exit test)
    const int64_t px0 = tile * kBwdTile;
    const int left = (int)(m - px0 < kBwdTile ? m - px0 : kBwdTile);
    constexpr int kRowStep = kBwdThreads / kBins;
#pragma unroll 8
    for (int i = 0; i < 2 * kBwdTile / kRowStep; ++i) {
      const int row = tid / kBins + kRowStep * i;  // image * kBwdTile + pixel
      const float r = response_fma(vs[row], c_resp, p, inv_norm1d);
      const bool valid = b_resp < p.bins && row % kBwdTile < left;
      ps[row * kRow + b_resp] = r * (valid ? 1.0f : 0.0f);
    }
    __syncthreads();

    // D[a][px] for a in the warp's 4 m-tiles and px in its kNT n-tiles:
    // K = 64 bins in 8 steps, each product as lo.hi + hi.lo + hi.hi into
    // one f32 sum. Each of the three over all 4 kNT tiles before the next:
    // the mma asm keeps its order, and the three of one tile depend on
    // each other
    float acc[4][kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBins / 8; ++kk) {
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, smem_addr(p_b) + b_off + (uint32_t)(8 * j * kRow + 8 * kk) * 4);
        split_tf32(r[0], bh[j][0], bl[j][0]);
        split_tf32(r[1], bh[j][1], bl[j][1]);
        split_tf32(r[2], bh[j + 1][0], bl[j + 1][0]);
        split_tf32(r[3], bh[j + 1][1], bl[j + 1][1]);
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t at = (uint32_t)(16 * mt * kRow + 8 * kk) * 4 + a_off;
        ldsm_x4(ah[mt], smem_addr(a_hi) + at);
        ldsm_x4(al[mt], smem_addr(a_lo) + at);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc[mt][j], al[mt], bh[j][0], bh[j][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc[mt][j], ah[mt], bl[j][0], bl[j][1]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(acc[mt][j], ah[mt], bh[j][0], bh[j][1]);
    }

    // dv = s / sigma^2 sum_a dL/dp_a p_a(v) (c_a - v): a thread sums its
    // 8 bins (rows g, g + 8 of each m-tile) of pixels 2 t, 2 t + 1 of each
    // n-tile, subtracting before the sum, then the 8 g-lanes are reduced
    // by a butterfly (every lane ends with the same bits); lane g keeps
    // the sum of n-tile g / 2, pixel 2 t + g % 2, for one store a warp
    float keep = 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 8 * (nt0 + j) + 2 * t + c;
        const float v = v_own[k];
        float sum = 0.0f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float dldp = w_a[mt][r] + acc[mt][j][2 * r + c] * inv_norm2d;
            sum += (dldp * p_own[k * kRow + 16 * mt + 8 * r + g]) * (c_a[mt][r] - v);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (g == 2 * j + c) keep = sum;
      }
    }
    if (g < 2 * kNT) {
      const int64_t px = px0 + 8 * (nt0 + g / 2) + 2 * t + g % 2;
      if (px < m) out[px] = s * (keep * inv_sigma2);
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. I, J: [n, m] f32, contiguous;
// 2 <= bins <= 64. The Parzen floats: minv, step = (maxv - minv) /
// (bins - 1), inv_two_sigma2 = 1 / (2 sigma^2), norm1d = sqrt(2 pi)
// sigma, norm2d = 2 pi sigma^2, inv_sigma2 = 1 / sigma^2. Each launches
// on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a bin or block count it does not take); none
// synchronises or allocates. The forward takes all but inv_sigma2.

// blocks (>= 1): the forward's blocks a sample, which kernels/mi.py's
// fwd_blocks sizes to fill the card; partial: [n * blocks * 4224] scratch;
// stats: [n, 2 bins + bins^2]; per: [n] scratch; loss: one f32, the batch
// mean of -MI.
extern "C" int san_mi_fwd(const void* I, const void* J, void* partial,
                          void* stats, void* per, void* loss, int64_t n,
                          int64_t m, int bins, int blocks, float minv,
                          float step, float inv_two_sigma2, float norm1d,
                          float norm2d, void* stream) {
  if (bins < 2 || bins > kBins || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Parzen p{bins, minv, step, inv_two_sigma2, norm1d};
  mi_fwd_gram_kernel<<<dim3((unsigned)blocks, (unsigned)n), kFwdThreads, 0, s>>>(
      (const float*)I, (const float*)J, (float*)partial, m, p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mi_fwd_reduce_kernel<<<dim3((kStats + kRedThreads - 1) / kRedThreads, (unsigned)n),
                         kRedThreads, 0, s>>>((const float*)partial, blocks,
                                              (float*)stats, bins);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mi_fwd_entropy_kernel<<<(unsigned)n, kEpiThreads, 0, s>>>(
      (const float*)stats, (float*)per, (float)m, bins, norm2d);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  mi_mean_kernel<<<1, 32, 0, s>>>((const float*)per, n, (float*)loss);
  return (int)cudaGetLastError();
}

// stats: the forward's; coef: [n * 16512] scratch; gout: the upstream
// gradient of the loss (one f32 on the device); dI, dJ: [n, m].
extern "C" int san_mi_bwd(const void* I, const void* J, const void* stats,
                          void* coef, const void* gout, void* dI, void* dJ,
                          int64_t n, int64_t m, int bins, float minv,
                          float step, float inv_two_sigma2, float norm1d,
                          float norm2d, float inv_sigma2, void* stream) {
  if (bins < 2 || bins > kBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Parzen p{bins, minv, step, inv_two_sigma2, norm1d};
  mi_bwd_coef_kernel<<<(unsigned)n, kCoefThreads, 0, s>>>(
      (const float*)stats, (float*)coef, (float)m, bins, norm2d);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // kBwdBlocks blocks an SM (__launch_bounds__) fill the card once, each
  // looping over its tiles, so that a block stages the coefficients once;
  // the SM count and the shared-memory opt-in are taken once a device
  constexpr int kSmemBytes = kBwdSmem * (int)sizeof(float);
  constexpr int kDevices = 64;
  static std::atomic<int> sms_of[kDevices];  // 0 until taken
  int dev = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    rc = (int)cudaFuncSetAttribute(mi_bwd_pixel_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != 0) return rc;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const int64_t tiles = (m + kBwdTile - 1) / kBwdTile;
  const int64_t fill = ((int64_t)kBwdBlocks * sms + n - 1) / n;
  const dim3 grid((unsigned)(tiles < fill ? tiles : (fill > 0 ? fill : 1)), (unsigned)n);
  mi_bwd_pixel_kernel<<<grid, kBwdThreads, kSmemBytes, s>>>(
      (const float*)I, (const float*)J, (const float*)coef,
      (const float*)gout, (float*)dI, (float*)dJ, n, m, p, 1.0f / norm2d,
      inv_sigma2);
  return (int)cudaGetLastError();
}
