// What the window losses' kernels (lncc.cu, ssim.cu) share: cp.async
// staging, odd row strides, the fused backwards' tile, and the forwards'
// tile with its fixed-order block and plane sums.
//
// Each of those sources is built alone into its own library, so these
// definitions live in an unnamed namespace, one copy a library.
// kernels/__init__.py::build hashes every header of csrc/ with the source,
// so that an edit here rebuilds both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int odd(int n) { return n | 1; }
constexpr int max2(int a, int b) { return a > b ? a : b; }

// 4 bytes from global to shared memory, zero-filled where `in` is false
// (src-size 0: nothing is read), so zero padding needs no branch on the
// loaded value; `src` is a mapped address either way.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The fused backwards' tile: kTile x kTile output pixels a block of
// kBwdThreads threads; the last pass gives each thread kSegOut rows of one
// column.
constexpr int kTile = 32;
constexpr int kBwdThreads = 512;
constexpr int kSegOut = kTile * kTile / kBwdThreads;

// The fused backwards' grid: (column tiles, row tiles, planes).
inline dim3 tiles(int rows, int cols, int64_t planes) {
  return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, (unsigned)planes);
}

// The forwards' tile: TH x kFwdCols outputs of one plane (TH one of 32,
// 16 and 8, picked by kernels/__init__.py::fwd_rows: the shorter tiles
// only where the planes are too few and small for 32), whose W x W
// windows start at staged pixel (i, j) for output (i, j). A block stages
// SR x SC pixels by cp.async (zero outside the plane), sums W of them
// along each row (row pass), then W
// row sums down each column (column pass), each sum in order d = 0..W-1.
// Each pass gives a thread kFwdSeg neighbouring outputs, so that a staged
// value is loaded once for all of them and the W terms are added from
// registers; the column pass gives one column segment a thread. Row
// strides are odd, so the 32 lanes of a warp on 32 rows hit 32 banks.
constexpr int kFwdCols = 32;
constexpr int kFwdSeg = 4;

template <int W, int TH>
struct Fwd {
  static_assert(TH % kFwdSeg == 0 && kFwdCols % kFwdSeg == 0, "whole segments");
  static constexpr int SR = TH + W - 1;        // staged rows
  static constexpr int SC = kFwdCols + W - 1;  // staged columns
  static constexpr int XS = odd(SC);           // row stride of the staged x, y
  static constexpr int HS = odd(kFwdCols);     // row stride of the row sums
  static constexpr int kSegs = kFwdCols / kFwdSeg;  // segments a row
  static constexpr int kThreads = TH * kSegs;       // one column segment each
  static constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0, "whole warps");
};

// The shared memory of a forward block.
template <int W, int TH>
struct FwdSmem {
  using G = Fwd<W, TH>;
  float xs[G::SR * G::XS];
  float ys[G::SR * G::XS];
  float hs[5 * G::SR * G::HS];  // row sums of x, y, xx, yy, xy
  float red[32];                // block_sum's warp sums
};

// The five window sums of x, y, x^2, y^2 and xy at this thread's kFwdSeg
// outputs: column threadIdx.x % kFwdCols, rows (threadIdx.x / kFwdCols)
// kFwdSeg + t, of the tile whose window (0, 0) starts at pixel (R0, C0)
// of the h x w planes x and y. Pixels outside the plane are 0.
template <int W, int TH>
__device__ __forceinline__ void fwd_window_sums(const float* __restrict__ x,
                                                const float* __restrict__ y, int h,
                                                int w, int R0, int C0,
                                                FwdSmem<W, TH>& sm,
                                                float (&s)[5][kFwdSeg]) {
  using G = Fwd<W, TH>;
  const int lane = threadIdx.x & 31;
  // a warp a staged row, all copies in flight behind one barrier
  for (int r = threadIdx.x >> 5; r < G::SR; r += G::kWarps) {
    const int gr = R0 + r;
    const bool row_in = gr >= 0 && gr < h;
    for (int c = lane; c < G::SC; c += 32) {
      const int gc = C0 + c;
      const bool in = row_in && gc >= 0 && gc < w;
      const int64_t o = in ? (int64_t)gr * w + gc : 0;
      cp_async4(sm.xs + r * G::XS + c, x + o, in);
      cp_async4(sm.ys + r * G::XS + c, y + o, in);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // row pass: item (r, segment) takes the row sums at kFwdSeg columns
  for (int k = threadIdx.x; k < G::SR * G::kSegs; k += G::kThreads) {
    const int r = k % G::SR, j0 = (k / G::SR) * kFwdSeg;
    float a[kFwdSeg + W - 1], b[kFwdSeg + W - 1];
#pragma unroll
    for (int t = 0; t < kFwdSeg + W - 1; ++t) {
      a[t] = sm.xs[r * G::XS + j0 + t];
      b[t] = sm.ys[r * G::XS + j0 + t];
    }
#pragma unroll
    for (int t = 0; t < kFwdSeg; ++t) {
      float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
      for (int d = 0; d < W; ++d) {
        const float u = a[t + d];
        const float v = b[t + d];
        sx += u;
        sy += v;
        sxx += u * u;
        syy += v * v;
        sxy += u * v;
      }
      const int o = r * G::HS + j0 + t;
      sm.hs[o] = sx;
      sm.hs[G::SR * G::HS + o] = sy;
      sm.hs[2 * G::SR * G::HS + o] = sxx;
      sm.hs[3 * G::SR * G::HS + o] = syy;
      sm.hs[4 * G::SR * G::HS + o] = sxy;
    }
  }
  __syncthreads();

  // column pass: this thread's column segment, from registers
  const int j = threadIdx.x % kFwdCols, i0 = (threadIdx.x / kFwdCols) * kFwdSeg;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    float v[kFwdSeg + W - 1];
#pragma unroll
    for (int t = 0; t < kFwdSeg + W - 1; ++t) v[t] = sm.hs[(q * G::SR + i0 + t) * G::HS + j];
#pragma unroll
    for (int t = 0; t < kFwdSeg; ++t) {
      float acc = v[t];
#pragma unroll
      for (int d = 1; d < W; ++d) acc += v[t + d];
      s[q][t] = acc;
    }
  }
}

// Sum of v over the block (whole warps) in a fixed order: a shuffle tree
// in each warp, then one over the warps' sums. The result is in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The planes' sums, inside the tile launch: after every block has written
// its tiles' partials (partial[plane * tiles + tile]), a grid-wide barrier
// (the launch is cooperative: every block is resident), then block b sums
// planes b, b + gridDim.x, ..., each in tile order through L2, and writes
// sums[plane]. The order does not depend on which block took which tile,
// so the bits are the same run to run and on any card; no float atomics
// and no state beyond the call.
__device__ __forceinline__ void plane_sums(const float* __restrict__ partial,
                                           float* __restrict__ sums, int64_t planes,
                                           int tiles, float* red) {
  cooperative_groups::this_grid().sync();
  for (int64_t p = blockIdx.x; p < planes; p += gridDim.x) {
    const float* q = partial + p * tiles;
    float v = 0.0f;
    for (int k = threadIdx.x; k < tiles; k += blockDim.x) v += __ldcg(q + k);
    v = block_sum(v, red);
    if (threadIdx.x == 0) sums[p] = v;
    __syncthreads();  // red is reused by the next plane
  }
}

// Launch the forward `kernel` of `threads` threads cooperatively, one
// block a tile up to as many as the card holds of it at once (found once
// a kernel and device: the current device, which the caller sets to the
// tensors' card); each block walks the tiles t = blockIdx.x, + gridDim.x,
// ... of `work`.
template <auto kernel>
int launch_cooperative(int threads, int64_t work, void** args, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::atomic<int> resident[kDevices];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int fit = resident[dev].load(std::memory_order_relaxed);
  if (fit == 0) {
    int per_sm = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (rc != 0) return rc;
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != 0) return rc;
    fit = per_sm * sms;
    if (fit == 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev].store(fit, std::memory_order_relaxed);
  }
  const unsigned blocks = (unsigned)(work < fit ? work : fit);
  rc = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads),
                                        args, 0, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace
