// SSIM loss, forward and closed-form backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/ssim.py: the forward `_forward` /
// `_ssim_sum_kernel` (pallas_call at :81) and the backward `_backward` /
// `_ssim_bwd_kernel` (pallas_call at :204). The TPU kernels hold one whole
// (sample, channel) plane in VMEM per program; a GPU block has at most
// 227 KB of shared memory and 132 SMs to fill, so here a plane is cut into
// tiles with a 6-pixel halo, many blocks per plane.
//
// SSIM as the reference's loss (ssimloss.py:11-40): 7 x 7 uniform window,
// VALID windows, k1 0.01, k2 0.03, data range 1, covariance normalised by
// 49/48, loss = 1 - mean(S). f32 throughout.
//
// ssim_fwd: one cooperative launch. Each block takes TH x 32 tiles of
// windows (TH 32, 16 or 8, the shorter tiles only where the planes are too
// few and small for 32), stages X and Y over each plus 6 by cp.async,
// takes the five window sums separably (7 along rows, then 7 along
// columns, each in order, as the Pallas kernel does; window.cuh), forms
// the SSIM map in registers and sums it over the block in a fixed order
// into the tile's partial. After a grid-wide barrier, blocks sum the
// planes' partials in tile order, so the loss is the same on every run
// (no float atomics).
//
// ssim_bwd: with G_q = dS/du_q per valid window (masked to the valid
// windows, as at ops/pallas/ssim.py:172-182),
//   dX = -scale (box(G_ux) + 2 X box(G_uvv) + Y box(G_uxy)),
//   dY = -scale (box(G_uy) + 2 Y box(G_uvv) + X box(G_uxy)),
// box() the transposed 7 x 7 window sum and scale = g / (N C valid 49).
// One launch: as the Pallas kernel keeps the G maps in VMEM, a block keeps
// them in shared memory for its tile. A 32 x 32 pixel tile is covered by
// 38 x 38 windows, whose statistics need 44 x 44 pixels, staged by
// cp.async with zero fill outside the plane, all copies in flight behind
// one barrier. The sums keep the forward's order (rows, then columns,
// each in order); no atomics, so the bits are the same run to run. 512
// threads and 58 KB of shared memory a block: two blocks an SM.
//
// Bound on the H100 SXM: memory. At the train shape (X and Y [4, 1, 320,
// 320]) the forward must read 3.3 MB: about 0.98 us at 3.35 TB/s (about 100
// f32 operations a pixel are under 1 us at 67 TFLOP/s). The backward must
// read 3.3 MB and write 3.3 MB: about 1.96 us. What holds both is
// instruction issue and latency, as in lncc.cu: for the fused backward
// in-order sums over a tile grown by its halo (1.41 windows and 1.89
// staged pixels an output) and the G maps' five IEEE divides a window
// (without the G arithmetic it takes about 12% less time; PERF.md); for
// the forward the wait on its staging and on the grid-wide barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "window.cuh"

namespace {

constexpr int kWin = 7;
constexpr float kInv = 1.0f / 49.0f;
constexpr float kCovNorm = 49.0f / 48.0f;
constexpr float kC1 = 0.0001f;  // (k1 * data_range)^2
constexpr float kC2 = 0.0009f;  // (k2 * data_range)^2

// The five window means of one window.
struct Stats {
  float ux, uy, uxx, uyy, uxy;
};

struct Terms {
  float A1, A2, B1, B2;
};

__device__ __forceinline__ Terms ssim_terms(const Stats& u) {
  const float vx = kCovNorm * (u.uxx - u.ux * u.ux);
  const float vy = kCovNorm * (u.uyy - u.uy * u.uy);
  const float vxy = kCovNorm * (u.uxy - u.ux * u.uy);
  return {2.0f * u.ux * u.uy + kC1, 2.0f * vxy + kC2,
          u.ux * u.ux + u.uy * u.uy + kC1, vx + vy + kC2};
}

// One cooperative launch over the valid windows, each block walking tiles
// t (plane t / tiles, tile t % tiles, row-major over tiles_x column tiles)
// of TH x kFwdCols windows (window.cuh): the five window sums of the
// tile's windows and S of each, summed over the block into partial[t];
// then the planes' sums (plane_sums). sums[plane] = sum of S over the
// plane's valid windows.
template <int TH>
__global__ void __launch_bounds__(Fwd<kWin, TH>::kThreads)
    ssim_fwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    float* __restrict__ partial, float* __restrict__ sums,
                    int64_t planes, int h, int w, int tiles_x, int tiles) {
  __shared__ FwdSmem<kWin, TH> sm;
  const int hv = h - kWin + 1;
  const int wv = w - kWin + 1;
  const int j = threadIdx.x % kFwdCols, i0 = (threadIdx.x / kFwdCols) * kFwdSeg;
  for (int64_t t = blockIdx.x; t < planes * tiles; t += gridDim.x) {
    const int64_t plane = t / tiles;
    const int tile = (int)(t - plane * tiles);
    const int r0 = (tile / tiles_x) * TH;
    const int c0 = (tile % tiles_x) * kFwdCols;
    float s[5][kFwdSeg];
    fwd_window_sums<kWin, TH>(X + plane * h * w, Y + plane * h * w, h, w, r0, c0, sm, s);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kFwdSeg; ++k) {
      if (r0 + i0 + k >= hv || c0 + j >= wv) continue;
      const Stats u{s[0][k] * kInv, s[1][k] * kInv, s[2][k] * kInv, s[3][k] * kInv,
                    s[4][k] * kInv};
      const Terms tm = ssim_terms(u);
      acc += (tm.A1 * tm.A2) / (tm.B1 * tm.B2);
    }
    acc = block_sum(acc, sm.red);
    if (threadIdx.x == 0) partial[t] = acc;
  }
  plane_sums(partial, sums, planes, tiles, sm.red);
}

// Launch ssim_fwd_kernel<TH> over the (h - 6) x (w - 6) windows a plane.
template <int TH>
int launch_fwd(const void* X, const void* Y, void* partial, void* sums, int64_t planes,
               int h, int w, cudaStream_t s) {
  int tiles_x = (w - kWin + 1 + kFwdCols - 1) / kFwdCols;
  int tiles = tiles_x * ((h - kWin + 1 + TH - 1) / TH);
  void* args[] = {&X, &Y, &partial, &sums, &planes, &h, &w, &tiles_x, &tiles};
  return launch_cooperative<ssim_fwd_kernel<TH>>(Fwd<kWin, TH>::kThreads, planes * tiles,
                                                args, s);
}

// The fused backward's tile: the windows whose top-left corners are in
// [r0 - 6, r0 + kTile) cover the kTile x kTile pixel tile at (r0, c0), C =
// 38 a side; their statistics need S = 44 pixels a side. Each of the four
// separable passes gives a thread kSeg outputs in a row along its sum
// (rows) or down it (columns), so that a staged value is loaded once for
// kSeg outputs and the 7 terms of a sum are added in order from registers.
// Row strides are odd, so that the 32 lanes of a warp, on 32 rows of one
// column, hit 32 banks. The row sums share their space with the box
// pass's row sums, the staged X and Y with the G maps.
constexpr int kSeg = 4;

struct Bwd {
  static constexpr int S = kTile + 2 * (kWin - 1);  // staged pixels a side
  static constexpr int C = kTile + kWin - 1;        // windows a side
  static constexpr int kSegsC = (C + kSeg - 1) / kSeg;
  static constexpr int XS = odd(max2(S, kSegsC * kSeg + kWin - 1));
  static constexpr int HR = max2(S, kSegsC * kSeg + kWin - 1);
  static constexpr int CS = odd(C);
  static constexpr int BS = odd(kTile);
  static constexpr int kFirst = max2(2 * S * XS, 4 * C * CS);   // X, Y; then G
  static constexpr int kSecond = max2(5 * HR * CS, 4 * C * BS);  // row sums
  static constexpr int kBytes = (kFirst + kSecond) * (int)sizeof(float);
};

// grid (tiles_x, tiles_y, N*C) over the pixels, one kTile x kTile tile a
// block: stages X and Y with the 6-pixel halo both ways, takes the
// statistics of the 38 x 38 windows that cover the tile (rows, then
// columns, each in order, as the forward), forms the four G maps in shared
// memory (0 for a window outside the valid windows [0, h-6) x [0, w-6),
// as ops/pallas/ssim.py:172-182), box-scatters them separably and writes
// dX, dY. Nothing leaves the block but dX and dY.
__global__ void __launch_bounds__(kBwdThreads)
    ssim_bwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    const float* __restrict__ gout, float scale,
                    float* __restrict__ dX, float* __restrict__ dY, int h,
                    int w) {
  using G = Bwd;
  constexpr int W = kWin;
  extern __shared__ float smem[];
  float* xs = smem;  // [S][XS], pixel (r0 - 6 + r, c0 - 6 + c)
  float* ys = xs + G::S * G::XS;
  float* gs = smem;  // [4][C][CS] after the row pass, the window whose
                     // top-left corner is (r0 - 6 + i, c0 - 6 + j)
  float* hs = smem + G::kFirst;  // [5][HR][CS] row sums, then [4][C][BS]
  const int64_t base = (int64_t)blockIdx.z * h * w;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int hv = h - W + 1;
  const int wv = w - W + 1;
  const int tid = threadIdx.x;
  const float sg = -scale * *gout;

  // all copies in flight at once, behind one barrier; zero outside the plane
  for (int k = tid; k < G::S * G::S; k += kBwdThreads) {
    const int r = k / G::S, c = k % G::S;
    const int gr = r0 - (W - 1) + r, gc = c0 - (W - 1) + c;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
    const int64_t o = base + (in ? (int64_t)gr * w + gc : 0);
    cp_async4(xs + r * G::XS + c, X + o, in);
    cp_async4(ys + r * G::XS + c, Y + o, in);
  }
  cp_async_wait_all();
  __syncthreads();

  // row sums: thread (r, segment) takes the sums at kSeg window columns
  for (int k = tid; k < G::S * G::kSegsC; k += kBwdThreads) {
    const int r = k % G::S, j0 = (k / G::S) * kSeg;
    float a[kSeg + W - 1], b[kSeg + W - 1];
#pragma unroll
    for (int t = 0; t < kSeg + W - 1; ++t) {
      a[t] = xs[r * G::XS + j0 + t];
      b[t] = ys[r * G::XS + j0 + t];
    }
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      if (j0 + t >= G::C) break;
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
      const int o = r * G::CS + j0 + t;
      hs[o] = sx;
      hs[G::HR * G::CS + o] = sy;
      hs[2 * G::HR * G::CS + o] = sxx;
      hs[3 * G::HR * G::CS + o] = syy;
      hs[4 * G::HR * G::CS + o] = sxy;
    }
  }
  __syncthreads();  // the staged X and Y are dead: the G maps take their space

  // column sums and G maps: thread (j, segment) takes kSeg windows
  for (int k = tid; k < G::C * G::kSegsC; k += kBwdThreads) {
    const int j = k % G::C, i0 = (k / G::C) * kSeg;
    float m[5][kSeg];  // the window means
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float v[kSeg + W - 1];
#pragma unroll
      for (int t = 0; t < kSeg + W - 1; ++t) v[t] = hs[(q * G::HR + i0 + t) * G::CS + j];
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float acc = v[t];
#pragma unroll
        for (int d = 1; d < W; ++d) acc += v[t + d];
        m[q][t] = acc * kInv;
      }
    }
    const int wc = c0 - (W - 1) + j;
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const int i = i0 + t;
      if (i >= G::C) break;
      const int wr = r0 - (W - 1) + i;
      float g_ux = 0.0f, g_uy = 0.0f, g_uxy = 0.0f, g_uvv = 0.0f;
      if (wr >= 0 && wr < hv && wc >= 0 && wc < wv) {
        const Stats u{m[0][t], m[1][t], m[2][t], m[3][t], m[4][t]};
        const Terms tm = ssim_terms(u);
        const float D = tm.B1 * tm.B2;
        const float S = (tm.A1 * tm.A2) / D;
        const float sA1 = tm.A2 / D;
        const float sA2 = tm.A1 / D;
        const float sB1 = -S / tm.B1;
        const float sB2 = -S / tm.B2;
        g_ux = sA1 * (2.0f * u.uy) + sA2 * (-2.0f * kCovNorm * u.uy) +
               sB1 * (2.0f * u.ux) + sB2 * (-2.0f * kCovNorm * u.ux);
        g_uy = sA1 * (2.0f * u.ux) + sA2 * (-2.0f * kCovNorm * u.ux) +
               sB1 * (2.0f * u.uy) + sB2 * (-2.0f * kCovNorm * u.uy);
        g_uxy = sA2 * (2.0f * kCovNorm);  // dS/duxy
        g_uvv = sB2 * kCovNorm;           // dS/duxx == dS/duyy
      }
      const int o = i * G::CS + j;
      gs[o] = g_ux;
      gs[G::C * G::CS + o] = g_uy;
      gs[2 * G::C * G::CS + o] = g_uxy;
      gs[3 * G::C * G::CS + o] = g_uvv;
    }
  }
  __syncthreads();

  // box rows: thread (i, segment) takes kSeg of the tile's columns
  float* bs = hs;
  for (int k = tid; k < G::C * (kTile / kSeg); k += kBwdThreads) {
    const int i = k % G::C, j0 = (k / G::C) * kSeg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[kSeg + W - 1];
#pragma unroll
      for (int t = 0; t < kSeg + W - 1; ++t) v[t] = gs[(q * G::C + i) * G::CS + j0 + t];
#pragma unroll
      for (int t = 0; t < kSeg; ++t) {
        float acc = v[t];
#pragma unroll
        for (int d = 1; d < W; ++d) acc += v[t + d];
        bs[(q * G::C + i) * G::BS + j0 + t] = acc;
      }
    }
  }
  __syncthreads();

  // box columns and dX, dY: thread (j, segment) takes kSegOut of the tile's
  // rows, a warp a segment, so each store is 32 neighbours
  const int j = tid % kTile, i0 = (tid / kTile) * kSegOut;
  int64_t o[kSegOut];
  float x[kSegOut], y[kSegOut];  // loaded before the sums, to hide their latency
#pragma unroll
  for (int t = 0; t < kSegOut; ++t) {
    const bool in = r0 + i0 + t < h && c0 + j < w;
    o[t] = base + (in ? (int64_t)(r0 + i0 + t) * w + (c0 + j) : 0);
    x[t] = X[o[t]];
    y[t] = Y[o[t]];
  }
  float b[4][kSegOut];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[kSegOut + W - 1];
#pragma unroll
    for (int t = 0; t < kSegOut + W - 1; ++t) v[t] = bs[(q * G::C + i0 + t) * G::BS + j];
#pragma unroll
    for (int t = 0; t < kSegOut; ++t) {
      float acc = v[t];
#pragma unroll
      for (int d = 1; d < W; ++d) acc += v[t + d];
      b[q][t] = acc;
    }
  }
  if (c0 + j >= w) return;
#pragma unroll
  for (int t = 0; t < kSegOut; ++t) {
    if (r0 + i0 + t >= h) break;
    dX[o[t]] = sg * (b[0][t] + 2.0f * x[t] * b[3][t] + y[t] * b[2][t]);
    dY[o[t]] = sg * (b[1][t] + 2.0f * y[t] * b[3][t] + x[t] * b[2][t]);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. X, Y: [planes, h, w] f32,
// contiguous, h and w >= 7. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronises or allocates.

// partial: [planes * tiles] scratch, tiles = ceil((h-6)/rows) *
// ceil((w-6)/32), rows (8, 16 or 32) the tile's rows of windows
// (kernels/__init__.py::fwd_rows sizes both); sums: [planes], the
// per-plane sums of the SSIM map. One cooperative launch of the forward
// for the tile.
extern "C" int san_ssim_fwd(const void* X, const void* Y, void* partial, void* sums,
                            int64_t planes, int h, int w, int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 32: return launch_fwd<32>(X, Y, partial, sums, planes, h, w, s);
    case 16: return launch_fwd<16>(X, Y, partial, sums, planes, h, w, s);
    case 8: return launch_fwd<8>(X, Y, partial, sums, planes, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// gout: the upstream gradient of the loss (one f32 on the device); scale =
// 1 / (N C valid 49); dX, dY: [planes, h, w]. One launch of the fused
// kernel, with its dynamic shared memory (Bwd::kBytes, 58 KB) opted
// into once a device: the current device, which the caller sets to the
// tensors' card.
extern "C" int san_ssim_bwd(const void* X, const void* Y, const void* gout,
                            float scale, void* dX, void* dY, int64_t planes,
                            int h, int w, void* stream) {
  constexpr int kDevices = 64;
  static std::atomic<bool> opted[kDevices];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev].load(std::memory_order_relaxed)) {
    rc = (int)cudaFuncSetAttribute(ssim_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Bwd::kBytes);
    if (rc != 0) return rc;
    opted[dev].store(true, std::memory_order_relaxed);
  }
  ssim_bwd_kernel<<<tiles(h, w, planes), kBwdThreads, Bwd::kBytes,
                    (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, (const float*)gout, scale, (float*)dX,
      (float*)dY, h, w);
  return (int)cudaGetLastError();
}
