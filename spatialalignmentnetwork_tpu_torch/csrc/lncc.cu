// LNCC loss, forward and closed-form backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/lncc.py: the forward `_forward` /
// `_lncc_sum_kernel` (pallas_call at :57) and the backward `_backward` /
// `_lncc_bwd_kernel` (pallas_call at :117). The TPU kernels hold one whole
// (sample, channel) plane in VMEM per program, which here would be only
// N*C blocks for 132 SMs; so a plane is cut into 32 x 32 tiles with a
// win/2 halo (zero outside the plane: SAME padding), many blocks a plane.
//
// LNCC as the reference's loss (lnccloss.py:7-34): win x win windows (odd
// win up to kMaxWin; the reference uses 9), zero-padded SAME, cc =
// cross^2 / (I_var J_var + 1e-5), loss = -sum(cc) / (N C H W). f32
// throughout.
//
// lncc_fwd: each block stages its I and J tile in shared memory, takes the
// five window sums separably (along rows, then along columns, each in
// order, as the Pallas kernel does), forms cc in registers with the
// forward's expanded formula (cross = IJ - u_J I_s - u_I J_s + u_I u_J ws)
// and reduces it to one partial per block in a fixed order. A second
// launch sums each plane's partials in a fixed order, so the loss is the
// same on every run (no float atomics).
//
// lncc_bwd: the closed form of `_lncc_bwd_kernel` (:80-110), with its
// cross = IJ - I_s J_s / ws. Per centre, the coefficient maps
//   G_Is = d(cc)/d(I_s), G_Js, Pv_I = d(cc)/d(I_var), Pv_J, Pc = d(cc)/d(cross);
// then, since the SAME window is self-adjoint,
//   dI = -g/(NCHW) (box(G_Is) + 2 I box(Pv_I) + J box(Pc)),
//   dJ = -g/(NCHW) (box(G_Js) + 2 J box(Pv_J) + I box(Pc)).
// The simple form: a first launch writes the five maps [5, N*C, H, W] to
// device memory; a second stages tiles of them one map at a time (zero
// outside the plane) and box-sums them separably. g is read on the device
// (no host sync). Fusing the two launches (a halo of 2 (win/2)) is later
// work.
//
// Bound on the H100 SXM: memory. At the path's shape (I and J [4, 1, 320,
// 320]) the forward must read 3.3 MB: about 0.98 us at 3.35 TB/s (about
// 106 f32 operations a pixel are 0.65 us at 67 TFLOP/s). The backward
// must read 3.3 MB and write 3.3 MB: about 1.96 us (about 200 operations
// a pixel, 1.2 us). This two-launch form also writes and reads the five
// maps (8.2 MB each way at that shape).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 15;
constexpr int kTile = 32;                     // outputs per tile side
constexpr int kMaxHalo = kTile + kMaxWin - 1;  // staged rows/columns
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRows = kTile / kThreadsY;  // output rows per thread
constexpr float kEps = 1e-5f;

// Stage the tile of `x` whose first output pixel is (r0, c0), with a
// win/2 halo and zeros outside the plane, into xs[halo][halo].
__device__ void stage(const float* x, int h, int w, int r0, int c0, int win,
                      float (*xs)[kMaxHalo]) {
  const int pad = win / 2;
  const int halo = kTile + win - 1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < halo * halo; k += kThreads) {
    const int r = k / halo;
    const int c = k - r * halo;
    const int gr = r0 - pad + r;
    const int gc = c0 - pad + c;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
    xs[r][c] = in ? x[(int64_t)gr * w + gc] : 0.0f;
  }
}

// The five SAME window sums I_s, J_s, I2_s, J2_s, IJ_s at the tile's
// output (r0 + i, c0 + j) for i = threadIdx.y + kThreadsY * k: stage I and
// J, take the row sums of the five products, then the column sums.
struct Sums {
  float I, J, I2, J2, IJ;
};

__device__ void window_sums(const float* x, const float* y, int h, int w,
                            int r0, int c0, int win, float (*xs)[kMaxHalo],
                            float (*ys)[kMaxHalo],
                            float (*hs)[kMaxHalo][kTile], Sums* out) {
  stage(x, h, w, r0, c0, win, xs);
  stage(y, h, w, r0, c0, win, ys);
  __syncthreads();
  const int halo = kTile + win - 1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int k = tid; k < halo * kTile; k += kThreads) {
    const int r = k / kTile;
    const int j = k - r * kTile;
    float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
    for (int d = 0; d < win; ++d) {
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
  const int j = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = threadIdx.y + kThreadsY * k;
    float s[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float acc = hs[q][i][j];
      for (int d = 1; d < win; ++d) acc += hs[q][i + d][j];
      s[q] = acc;
    }
    out[k] = {s[0], s[1], s[2], s[3], s[4]};
  }
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

// grid (tiles_x, tiles_y, N*C); partial[plane * tiles + tile] = sum of cc
// over the tile's pixels.
__global__ void __launch_bounds__(kThreads)
    lncc_fwd_kernel(const float* __restrict__ I, const float* __restrict__ J,
                    float* __restrict__ partial, int h, int w, int win) {
  __shared__ float xs[kMaxHalo][kMaxHalo];
  __shared__ float ys[kMaxHalo][kMaxHalo];
  __shared__ float hs[5][kMaxHalo][kTile];
  __shared__ float scratch[kThreads / 32];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  Sums s[kRows];
  window_sums(I + plane * h * w, J + plane * h * w, h, w, r0, c0, win, xs, ys,
              hs, s);
  const float ws = (float)(win * win);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = threadIdx.y + kThreadsY * k;
    if (r0 + i >= h || c0 + threadIdx.x >= w) continue;
    const float u_I = s[k].I / ws;
    const float u_J = s[k].J / ws;
    const float cross = s[k].IJ - u_J * s[k].I - u_I * s[k].J + u_I * u_J * ws;
    const float I_var = s[k].I2 - 2.0f * u_I * s[k].I + u_I * u_I * ws;
    const float J_var = s[k].J2 - 2.0f * u_J * s[k].J + u_J * u_J * ws;
    acc += cross * cross / (I_var * J_var + kEps);
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partial[plane * gridDim.x * gridDim.y + blockIdx.y * gridDim.x +
            blockIdx.x] = total;
}

// One block per plane: sums[plane] = the plane's partials, in a fixed order.
__global__ void lncc_plane_sum_kernel(const float* __restrict__ partial,
                                      float* __restrict__ sums, int n_tiles) {
  __shared__ float scratch[kThreads / 32];
  const float* p = partial + (int64_t)blockIdx.x * n_tiles;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < n_tiles; k += blockDim.x) acc += p[k];
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// grid (tiles_x, tiles_y, N*C); writes coef[q][plane][h][w] for q = G_Is,
// G_Js, Pv_I, Pv_J, Pc.
__global__ void __launch_bounds__(kThreads)
    lncc_bwd_coef_kernel(const float* __restrict__ I,
                         const float* __restrict__ J,
                         float* __restrict__ coef, int h, int w, int win,
                         int64_t planes) {
  __shared__ float xs[kMaxHalo][kMaxHalo];
  __shared__ float ys[kMaxHalo][kMaxHalo];
  __shared__ float hs[5][kMaxHalo][kTile];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  Sums s[kRows];
  window_sums(I + plane * h * w, J + plane * h * w, h, w, r0, c0, win, xs, ys,
              hs, s);
  const float ws = (float)(win * win);
  const int64_t map = planes * h * w;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = threadIdx.y + kThreadsY * k;
    if (r0 + i >= h || c0 + threadIdx.x >= w) continue;
    const float cross = s[k].IJ - s[k].I * s[k].J / ws;
    const float I_var = s[k].I2 - s[k].I * s[k].I / ws;
    const float J_var = s[k].J2 - s[k].J * s[k].J / ws;
    const float D = I_var * J_var + kEps;
    const float Pc = 2.0f * cross / D;
    const float cc_over_D = (cross * cross) / (D * D);
    const float Pv_I = -cc_over_D * J_var;
    const float Pv_J = -cc_over_D * I_var;
    const int64_t o = plane * h * w + (int64_t)(r0 + i) * w + (c0 + threadIdx.x);
    coef[o] = Pc * (-s[k].J / ws) + Pv_I * (-2.0f * s[k].I / ws);
    coef[map + o] = Pc * (-s[k].I / ws) + Pv_J * (-2.0f * s[k].J / ws);
    coef[2 * map + o] = Pv_I;
    coef[3 * map + o] = Pv_J;
    coef[4 * map + o] = Pc;
  }
}

// grid (tiles_x, tiles_y, N*C); box-sums the five maps around each pixel,
// one map at a time, and forms dI, dJ.
__global__ void __launch_bounds__(kThreads)
    lncc_bwd_scatter_kernel(const float* __restrict__ I,
                            const float* __restrict__ J,
                            const float* __restrict__ coef,
                            const float* __restrict__ gout, float scale,
                            float* __restrict__ dI, float* __restrict__ dJ,
                            int h, int w, int win, int64_t planes) {
  __shared__ float gs[kMaxHalo][kMaxHalo];
  __shared__ float hs[kMaxHalo][kTile];
  const int64_t plane = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int64_t map = planes * h * w;
  const int halo = kTile + win - 1;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int j = threadIdx.x;
  float b[5][kRows];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    stage(coef + q * map + plane * h * w, h, w, r0, c0, win, gs);
    __syncthreads();
    for (int k = tid; k < halo * kTile; k += kThreads) {
      const int r = k / kTile;
      const int jj = k - r * kTile;
      float acc = gs[r][jj];
      for (int d = 1; d < win; ++d) acc += gs[r][jj + d];
      hs[r][jj] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = threadIdx.y + kThreadsY * k;
      float acc = hs[i][j];
      for (int d = 1; d < win; ++d) acc += hs[i + d][j];
      b[q][k] = acc;
    }
    __syncthreads();  // gs and hs are staged again for the next map
  }
  const float s = -scale * *gout;
  const int64_t base = plane * h * w;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = threadIdx.y + kThreadsY * k;
    if (r0 + i >= h || c0 + j >= w) continue;
    const int64_t o = base + (int64_t)(r0 + i) * w + (c0 + j);
    const float x = I[o];
    const float y = J[o];
    dI[o] = s * (b[0][k] + 2.0f * x * b[2][k] + y * b[4][k]);
    dJ[o] = s * (b[1][k] + 2.0f * y * b[3][k] + x * b[4][k]);
  }
}

inline dim3 tiles(int h, int w, int64_t planes) {
  return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
              (unsigned)planes);
}

inline bool valid_win(int win) { return win >= 1 && win <= kMaxWin && win % 2 == 1; }

}  // namespace

// Plain C entry points, loaded with ctypes. I, J: [planes, h, w] f32,
// contiguous; win odd, 1 <= win <= 15. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// window it does not take); none synchronises or allocates.

// partial: [planes * tiles] scratch, tiles = ceil(h/32) * ceil(w/32);
// sums: [planes], the per-plane sums of the cc map.
extern "C" int san_lncc_fwd(const void* I, const void* J, void* partial,
                            void* sums, int64_t planes, int h, int w, int win,
                            void* stream) {
  if (!valid_win(win)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = tiles(h, w, planes);
  lncc_fwd_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0, s>>>(
      (const float*)I, (const float*)J, (float*)partial, h, w, win);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lncc_plane_sum_kernel<<<(unsigned)planes, kThreads, 0, s>>>(
      (const float*)partial, (float*)sums, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// coef: [5 * planes * h * w] scratch; gout: the upstream gradient of the
// loss (one f32 on the device); scale = 1 / (N C H W); dI, dJ: [planes, h, w].
extern "C" int san_lncc_bwd(const void* I, const void* J, void* coef,
                            const void* gout, float scale, void* dI, void* dJ,
                            int64_t planes, int h, int w, int win,
                            void* stream) {
  if (!valid_win(win)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid = tiles(h, w, planes);
  lncc_bwd_coef_kernel<<<grid, block, 0, s>>>(
      (const float*)I, (const float*)J, (float*)coef, h, w, win, planes);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  lncc_bwd_scatter_kernel<<<grid, block, 0, s>>>(
      (const float*)I, (const float*)J, (const float*)coef,
      (const float*)gout, scale, (float*)dI, (float*)dJ, h, w, win, planes);
  return (int)cudaGetLastError();
}
