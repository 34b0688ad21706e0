// SSIM loss, forward and closed-form backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/ssim.py: the forward `_forward` /
// `_ssim_sum_kernel` (pallas_call at :81) and the backward `_backward` /
// `_ssim_bwd_kernel` (pallas_call at :204). The TPU kernels hold one whole
// (sample, channel) plane in VMEM per program; a GPU block has at most
// 227 KB of shared memory and 132 SMs to fill, so here a plane is cut into
// 32 x 32 tiles with a 6-pixel halo, many blocks per plane.
//
// SSIM as the reference's loss (ssimloss.py:11-40): 7 x 7 uniform window,
// VALID windows, k1 0.01, k2 0.03, data range 1, covariance normalised by
// 49/48, loss = 1 - mean(S). f32 throughout.
//
// ssim_fwd: each block stages its X and Y tile (38 x 38) in shared memory,
// takes the five window sums separably (7 along rows, then 7 along
// columns, each in order, as the Pallas kernel does), forms the SSIM map
// in registers and reduces it to one partial per block in a fixed order.
// A second launch sums each plane's partials in a fixed order, so the loss
// is the same on every run (no float atomics).
//
// ssim_bwd: with G_q = dS/du_q per valid window (masked to the valid
// windows, as at ops/pallas/ssim.py:172-182),
//   dX = -scale (box(G_ux) + 2 X box(G_uvv) + Y box(G_uxy)),
//   dY = -scale (box(G_uy) + 2 Y box(G_uvv) + X box(G_uxy)),
// box() the transposed 7 x 7 window sum and scale = g / (N C valid 49).
// The simple form: a first launch writes the four G maps
// [4, N*C, H-6, W-6] to device memory; a second stages 38 x 38 tiles of
// them (zero outside the valid windows) and box-scatters them separably.
// Fusing the two, so the G maps never leave the chip, is later work.
//
// Bound on the H100 SXM: memory. At the train shape (X and Y [4, 1, 320,
// 320]) the forward must read 3.3 MB: about 0.98 us at 3.35 TB/s (about 100
// f32 operations a pixel are under 1 us at 67 TFLOP/s). The fused backward
// would read 3.3 MB and write 3.3 MB: about 1.96 us. This two-launch form
// also writes and reads the G maps (6.3 MB each way at that shape).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 7;
constexpr int kTile = 32;                  // outputs per tile side
constexpr int kHalo = kTile + kWin - 1;    // 38 staged rows/columns
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr float kInv = 1.0f / 49.0f;
constexpr float kCovNorm = 49.0f / 48.0f;
constexpr float kC1 = 0.0001f;  // (k1 * data_range)^2
constexpr float kC2 = 0.0009f;  // (k2 * data_range)^2

// The five window means of the window whose top-left corner is at row i,
// column j of the horizontal sums `hs` [5][kHalo][kTile].
struct Stats {
  float ux, uy, uxx, uyy, uxy;
};

__device__ __forceinline__ Stats column_sums(float (*hs)[kHalo][kTile],
                                             int i, int j) {
  float s[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    float acc = hs[q][i][j];
#pragma unroll
    for (int d = 1; d < kWin; ++d) acc += hs[q][i + d][j];
    s[q] = acc * kInv;
  }
  return {s[0], s[1], s[2], s[3], s[4]};
}

// Stage the X/Y tile whose top-left pixel is (r0, c0) (zero beyond the
// plane) and take the horizontal 7-sums of x, y, x^2, y^2 and xy.
__device__ void stage_and_row_sums(const float* x, const float* y, int h,
                                   int w, int r0, int c0,
                                   float (*xs)[kHalo], float (*ys)[kHalo],
                                   float (*hs)[kHalo][kTile]) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < kHalo * kHalo; k += kThreads) {
    const int r = k / kHalo;
    const int c = k - r * kHalo;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const bool in = gr < h && gc < w;
    xs[r][c] = in ? x[(int64_t)gr * w + gc] : 0.0f;
    ys[r][c] = in ? y[(int64_t)gr * w + gc] : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < kHalo * kTile; k += kThreads) {
    const int r = k / kTile;
    const int j = k - r * kTile;
    float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int d = 0; d < kWin; ++d) {
      const float a = xs[r][j + d];
      const float b = ys[r][j + d];
      sx += a;
      sy += b;
      sxx += a * a;
      syy += b * b;
      sxy += a * b;
    }
    hs[0][r][j] = sx;
    hs[1][r][j] = sy;
    hs[2][r][j] = sxx;
    hs[3][r][j] = syy;
    hs[4][r][j] = sxy;
  }
  __syncthreads();
}

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

// Sum of `v` over the block, in a fixed order; the result is in thread 0.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warps = (blockDim.x * blockDim.y + 31) / 32;
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (tid == 0)
    for (int k = 0; k < warps; ++k) total += scratch[k];
  return total;
}

// grid (tiles_x, tiles_y, N*C); partial[plane * tiles + tile] = sum of S
// over the tile's valid windows.
__global__ void __launch_bounds__(kThreads)
    ssim_fwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    float* __restrict__ partial, int h, int w) {
  __shared__ float xs[kHalo][kHalo];
  __shared__ float ys[kHalo][kHalo];
  __shared__ float hs[5][kHalo][kTile];
  __shared__ float scratch[kThreads / 32];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int hv = h - kWin + 1;
  const int wv = w - kWin + 1;
  stage_and_row_sums(X + plane * h * w, Y + plane * h * w, h, w, r0, c0, xs,
                     ys, hs);
  float acc = 0.0f;
  const int j = threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kThreadsY) {
    if (r0 + i >= hv || c0 + j >= wv) continue;
    const Terms t = ssim_terms(column_sums(hs, i, j));
    acc += (t.A1 * t.A2) / (t.B1 * t.B2);
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[plane * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
            blockIdx.x] = total;
}

// One block per plane: sums[plane] = the plane's partials, in a fixed order.
__global__ void ssim_plane_sum_kernel(const float* __restrict__ partial,
                                      float* __restrict__ sums, int n_tiles) {
  __shared__ float scratch[kThreads / 32];
  const float* p = partial + (int64_t)blockIdx.x * n_tiles;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < n_tiles; k += blockDim.x) acc += p[k];
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// grid (tiles_x, tiles_y, N*C) over the valid windows; writes
// coef[q][plane][hv][wv] for q = ux, uy, uxy, uvv.
__global__ void __launch_bounds__(kThreads)
    ssim_bwd_coef_kernel(const float* __restrict__ X,
                         const float* __restrict__ Y,
                         float* __restrict__ coef, int h, int w,
                         int64_t planes) {
  __shared__ float xs[kHalo][kHalo];
  __shared__ float ys[kHalo][kHalo];
  __shared__ float hs[5][kHalo][kTile];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int hv = h - kWin + 1;
  const int wv = w - kWin + 1;
  stage_and_row_sums(X + plane * h * w, Y + plane * h * w, h, w, r0, c0, xs,
                     ys, hs);
  const int64_t map = planes * hv * wv;
  const int j = threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kThreadsY) {
    if (r0 + i >= hv || c0 + j >= wv) continue;
    const Stats u = column_sums(hs, i, j);
    const Terms t = ssim_terms(u);
    const float D = t.B1 * t.B2;
    const float S = (t.A1 * t.A2) / D;
    const float sA1 = t.A2 / D;
    const float sA2 = t.A1 / D;
    const float sB1 = -S / t.B1;
    const float sB2 = -S / t.B2;
    const float g_ux = sA1 * (2.0f * u.uy) + sA2 * (-2.0f * kCovNorm * u.uy) +
                       sB1 * (2.0f * u.ux) + sB2 * (-2.0f * kCovNorm * u.ux);
    const float g_uy = sA1 * (2.0f * u.ux) + sA2 * (-2.0f * kCovNorm * u.ux) +
                       sB1 * (2.0f * u.uy) + sB2 * (-2.0f * kCovNorm * u.uy);
    const int64_t o = plane * hv * wv + (int64_t)(r0 + i) * wv + (c0 + j);
    coef[o] = g_ux;
    coef[map + o] = g_uy;
    coef[2 * map + o] = sA2 * (2.0f * kCovNorm);  // dS/duxy
    coef[3 * map + o] = sB2 * kCovNorm;           // dS/duxx == dS/duyy
  }
}

// grid (tiles_x, tiles_y, N*C) over the pixels; box-scatters the G maps of
// the windows covering each pixel and forms dX, dY.
__global__ void __launch_bounds__(kThreads)
    ssim_bwd_scatter_kernel(const float* __restrict__ X,
                            const float* __restrict__ Y,
                            const float* __restrict__ coef,
                            const float* __restrict__ gout, float scale,
                            float* __restrict__ dX, float* __restrict__ dY,
                            int h, int w, int64_t planes) {
  __shared__ float gs[4][kHalo][kHalo];
  __shared__ float hs[4][kHalo][kTile];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int hv = h - kWin + 1;
  const int wv = w - kWin + 1;
  const int64_t map = planes * hv * wv;
  const float* cp = coef + plane * hv * wv;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // windows (r0 - 6 + r, c0 - 6 + c) cover the tile's pixels
  for (int k = tid; k < kHalo * kHalo; k += kThreads) {
    const int r = k / kHalo;
    const int c = k - r * kHalo;
    const int wr = r0 - (kWin - 1) + r;
    const int wc = c0 - (kWin - 1) + c;
    const bool in = wr >= 0 && wr < hv && wc >= 0 && wc < wv;
    const int64_t o = (int64_t)wr * wv + wc;
#pragma unroll
    for (int q = 0; q < 4; ++q) gs[q][r][c] = in ? cp[q * map + o] : 0.0f;
  }
  __syncthreads();
  for (int k = tid; k < kHalo * kTile; k += kThreads) {
    const int r = k / kTile;
    const int j = k - r * kTile;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = gs[q][r][j];
#pragma unroll
      for (int d = 1; d < kWin; ++d) acc += gs[q][r][j + d];
      hs[q][r][j] = acc;
    }
  }
  __syncthreads();
  const float s = -scale * *gout;
  const int j = threadIdx.x;
  const int64_t base = plane * h * w;
  for (int i = threadIdx.y; i < kTile; i += kThreadsY) {
    if (r0 + i >= h || c0 + j >= w) continue;
    float b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = hs[q][i][j];
#pragma unroll
      for (int d = 1; d < kWin; ++d) acc += hs[q][i + d][j];
      b[q] = acc;
    }
    const int64_t o = base + (int64_t)(r0 + i) * w + (c0 + j);
    const float x = X[o];
    const float y = Y[o];
    dX[o] = s * (b[0] + 2.0f * x * b[3] + y * b[2]);
    dY[o] = s * (b[1] + 2.0f * y * b[3] + x * b[2]);
  }
}

inline dim3 tiles(int rows, int cols, int64_t planes) {
  return dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile,
              (unsigned)planes);
}

}  // namespace

// Plain C entry points, loaded with ctypes. X, Y: [planes, h, w] f32,
// contiguous, h and w >= 7. Each launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronises or allocates.

// partial: [planes * tiles] scratch, tiles = ceil((h-6)/32) * ceil((w-6)/32);
// sums: [planes], the per-plane sums of the SSIM map.
extern "C" int san_ssim_fwd(const void* X, const void* Y, void* partial,
                            void* sums, int64_t planes, int h, int w,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = tiles(h - kWin + 1, w - kWin + 1, planes);
  ssim_fwd_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0, s>>>(
      (const float*)X, (const float*)Y, (float*)partial, h, w);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssim_plane_sum_kernel<<<(unsigned)planes, kThreads, 0, s>>>(
      (const float*)partial, (float*)sums, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// coef: [4 * planes * (h-6) * (w-6)] scratch; gout: the upstream gradient
// of the loss (one f32 on the device); scale = 1 / (N C valid 49);
// dX, dY: [planes, h, w].
extern "C" int san_ssim_bwd(const void* X, const void* Y, void* coef,
                            const void* gout, float scale, void* dX, void* dY,
                            int64_t planes, int h, int w, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(kThreadsX, kThreadsY);
  ssim_bwd_coef_kernel<<<tiles(h - kWin + 1, w - kWin + 1, planes), block, 0,
                         s>>>((const float*)X, (const float*)Y, (float*)coef,
                              h, w, planes);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  ssim_bwd_scatter_kernel<<<tiles(h, w, planes), block, 0, s>>>(
      (const float*)X, (const float*)Y, (const float*)coef,
      (const float*)gout, scale, (float*)dX, (float*)dY, h, w, planes);
  return (int)cudaGetLastError();
}
