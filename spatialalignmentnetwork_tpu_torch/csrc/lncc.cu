// LNCC loss, forward and closed-form backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/lncc.py: the forward `_forward` /
// `_lncc_sum_kernel` (pallas_call at :57) and the backward `_backward` /
// `_lncc_bwd_kernel` (pallas_call at :117). The TPU kernels hold one whole
// (sample, channel) plane in VMEM per program, which here would be only
// N*C blocks for 132 SMs; so a plane is cut into tiles with a win/2 halo
// (zero outside the plane: SAME padding), many blocks a plane.
//
// LNCC as the reference's loss (lnccloss.py:7-34): win x win windows (odd
// win up to kMaxWin; the reference uses 9), zero-padded SAME, cc =
// cross^2 / (I_var J_var + 1e-5), loss = -sum(cc) / (N C H W). f32
// throughout.
//
// lncc_fwd: one cooperative launch. Each block takes TH x 32 output tiles
// (TH 32, 16 or 8, the shorter tiles only where the planes are too few
// and small for 32), stages I and J over each plus win/2 a side by
// cp.async, takes the five window sums separably (rows, then columns,
// each in order, as the Pallas kernel does; window.cuh), forms cc in
// registers with the forward's expanded formula (cross = IJ - u_J I_s -
// u_I J_s + u_I u_J ws) and sums it over the block in a fixed order into
// the tile's partial. After a grid-wide barrier, blocks sum the planes'
// partials in tile order, so the loss is the same on every run (no float
// atomics). The window and the tile's rows are template arguments, so
// every sum unrolls and shared memory is sized for the window in use.
//
// lncc_bwd: the closed form of `_lncc_bwd_kernel` (:80-110), with its
// cross = IJ - I_s J_s / ws. Per centre, the coefficient maps
//   G_Is = d(cc)/d(I_s), G_Js, Pv_I = d(cc)/d(I_var), Pv_J, Pc = d(cc)/d(cross);
// then, since the SAME window is self-adjoint,
//   dI = -g/(NCHW) (box(G_Is) + 2 I box(Pv_I) + J box(Pc)),
//   dJ = -g/(NCHW) (box(G_Js) + 2 J box(Pv_J) + I box(Pc)).
// One launch: as the Pallas kernel keeps the maps in VMEM, a block keeps
// them in shared memory for its tile. A 32 x 32 output tile needs the maps
// at its pixels plus win/2 a side (40 x 40 at win 9), and those need I
// and J plus 2 (win/2) a side (48 x 48), staged by cp.async with zero fill
// outside the plane, all copies in flight behind one barrier. The window
// sums and the box sums are separable, rows then columns, each in order,
// with the forward's rounding (no running sums: I_var and J_var cancel).
// The window is a template argument, so that every sum unrolls. g is read
// on the device (no host sync); no atomics, so the bits are the same run
// to run. 512 threads and 70 KB of shared memory a block at win 9 (two
// blocks an SM), 100 KB at win 15.
//
// Bound on the H100 SXM: memory. At the path's shape (I and J [4, 1, 320,
// 320]) the forward must read 3.3 MB: about 0.98 us at 3.35 TB/s (about
// 106 f32 operations a pixel are 0.65 us at 67 TFLOP/s). The backward
// must read 3.3 MB and write 3.3 MB: about 1.96 us (about 200 operations
// a pixel, 1.2 us). What holds both is instruction issue and latency, not
// memory: the in-order sums over a tile grown by its halo (for the fused
// backward 1.56 centres and 2.25 staged pixels an output at win 9, for
// the forward 1.25 row sums and 1.56 staged pixels at 32 rows), the IEEE
// divides, and for the forward the wait on its staging and on the
// grid-wide barrier before the planes' sums. The backward without its
// coefficient arithmetic takes about 15% less time; without its global
// loads, 3% less (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "window.cuh"

namespace {

constexpr int kMaxWin = 15;
constexpr float kEps = 1e-5f;

// One cooperative launch, each block walking tiles t (plane t / tiles,
// tile t % tiles, row-major over tiles_x column tiles) of TH x kFwdCols
// outputs (window.cuh): the five SAME window sums at the tile's outputs,
// their cc in the forward's expanded formula, summed over the block into
// partial[t]; then the planes' sums (plane_sums). sums[plane] = sum of cc
// over the plane.
template <int W, int TH>
__global__ void __launch_bounds__(Fwd<W, TH>::kThreads)
    lncc_fwd_kernel(const float* __restrict__ I, const float* __restrict__ J,
                    float* __restrict__ partial, float* __restrict__ sums,
                    int64_t planes, int h, int w, int tiles_x, int tiles) {
  constexpr int P = W / 2;
  __shared__ FwdSmem<W, TH> sm;
  const int j = threadIdx.x % kFwdCols, i0 = (threadIdx.x / kFwdCols) * kFwdSeg;
  const float ws = (float)(W * W);
  for (int64_t t = blockIdx.x; t < planes * tiles; t += gridDim.x) {
    const int64_t plane = t / tiles;
    const int tile = (int)(t - plane * tiles);
    const int r0 = (tile / tiles_x) * TH;
    const int c0 = (tile % tiles_x) * kFwdCols;
    float s[5][kFwdSeg];
    fwd_window_sums<W, TH>(I + plane * h * w, J + plane * h * w, h, w, r0 - P, c0 - P,
                           sm, s);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kFwdSeg; ++k) {
      if (r0 + i0 + k >= h || c0 + j >= w) continue;
      const float Is = s[0][k], Js = s[1][k], I2 = s[2][k], J2 = s[3][k], IJ = s[4][k];
      const float u_I = Is / ws;
      const float u_J = Js / ws;
      const float cross = IJ - u_J * Is - u_I * Js + u_I * u_J * ws;
      const float I_var = I2 - 2.0f * u_I * Is + u_I * u_I * ws;
      const float J_var = J2 - 2.0f * u_J * Js + u_J * u_J * ws;
      acc += cross * cross / (I_var * J_var + kEps);
    }
    acc = block_sum(acc, sm.red);
    if (threadIdx.x == 0) partial[t] = acc;
  }
  plane_sums(partial, sums, planes, tiles, sm.red);
}

// Launch lncc_fwd_kernel<W, TH> over rows x cols outputs a plane.
template <int W, int TH>
int launch_fwd(const void* I, const void* J, void* partial, void* sums, int64_t planes,
               int h, int w, cudaStream_t s) {
  int tiles_x = (w + kFwdCols - 1) / kFwdCols;
  int tiles = tiles_x * ((h + TH - 1) / TH);
  void* args[] = {&I, &J, &partial, &sums, &planes, &h, &w, &tiles_x, &tiles};
  return launch_cooperative<lncc_fwd_kernel<W, TH>>(Fwd<W, TH>::kThreads, planes * tiles,
                                                   args, s);
}

template <int W>
int launch_fwd_rows(const void* I, const void* J, void* partial, void* sums,
                    int64_t planes, int h, int w, int rows, cudaStream_t s) {
  switch (rows) {
    case 32: return launch_fwd<W, 32>(I, J, partial, sums, planes, h, w, s);
    case 16: return launch_fwd<W, 16>(I, J, partial, sums, planes, h, w, s);
    case 8: return launch_fwd<W, 8>(I, J, partial, sums, planes, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fused backward's tile at window W: a kTile x kTile output tile, the
// window sums and coefficients at its centres plus W/2 a side (C a side),
// I and J staged at those plus W/2 more (S a side). Each of the four
// separable passes gives a thread kSeg outputs in a row along its sum
// (rows) or down it (columns), so that a staged value is loaded once for
// kSeg outputs and the W terms of a sum are added in order from
// registers. Row strides are odd, so that the 32 lanes of a warp, on 32
// rows of one column, hit 32 banks. The row sums share their space with
// the box pass's row sums, the staged I and J with the coefficient maps.
template <int W>
struct Bwd {
  static constexpr int S = kTile + 2 * (W - 1);  // staged pixels a side
  static constexpr int C = kTile + W - 1;        // centres a side
  static constexpr int kSeg = W <= 9 ? 4 : 2;    // outputs a thread a pass
  static constexpr int kSegsC = (C + kSeg - 1) / kSeg;  // segments of C
  // staged rows: the row pass reads up to kSegsC kSeg + W - 1 columns
  static constexpr int XS = odd(max2(S, kSegsC * kSeg + W - 1));
  // row sums: S rows, padded for the column pass's last segment
  static constexpr int HR = max2(S, kSegsC * kSeg + W - 1);
  static constexpr int CS = odd(C);      // row stride of the row sums and the maps
  static constexpr int BS = odd(kTile);  // row stride of the box row sums
  static constexpr int kFirst = max2(2 * S * XS, 5 * C * CS);   // I, J; then maps
  static constexpr int kSecond = max2(5 * HR * CS, 5 * C * BS);  // row sums
  static constexpr int kBytes = (kFirst + kSecond) * (int)sizeof(float);
};

// grid (tiles_x, tiles_y, N*C), one kTile x kTile output tile a block:
// stages I and J with a 2 (W/2) halo, takes the five window sums at the
// tile's centres plus W/2 a side (rows, then columns, each in order, as
// window_sums), forms the five coefficient maps (0 at centres outside the
// plane) in shared memory, box-sums them the same way over the tile and
// writes dI, dJ. Nothing leaves the block but dI and dJ.
template <int W>
__global__ void __launch_bounds__(kBwdThreads)
    lncc_bwd_kernel(const float* __restrict__ I, const float* __restrict__ J,
                    const float* __restrict__ gout, float scale,
                    float* __restrict__ dI, float* __restrict__ dJ, int h, int w) {
  using G = Bwd<W>;
  constexpr int P = W / 2;
  constexpr int kSeg = G::kSeg;
  extern __shared__ float smem[];
  float* xs = smem;             // [S][XS], pixel (r0 - 2P + r, c0 - 2P + c)
  float* ys = xs + G::S * G::XS;
  float* cs = smem;             // [5][C][CS] after the row pass, centre
                                // (r0 - P + i, c0 - P + j)
  float* hs = smem + G::kFirst;  // [5][HR][CS] row sums, then [5][C][BS]
  const int64_t base = (int64_t)blockIdx.z * h * w;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float sg = -scale * *gout;

  // all copies in flight at once, behind one barrier; zero outside the plane
  for (int k = tid; k < G::S * G::S; k += kBwdThreads) {
    const int r = k / G::S, c = k % G::S;
    const int gr = r0 - 2 * P + r, gc = c0 - 2 * P + c;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
    const int64_t o = base + (in ? (int64_t)gr * w + gc : 0);
    cp_async4(xs + r * G::XS + c, I + o, in);
    cp_async4(ys + r * G::XS + c, J + o, in);
  }
  cp_async_wait_all();
  __syncthreads();

  // row sums: thread (r, segment) takes the sums at kSeg centre columns
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
  __syncthreads();  // the staged I and J are dead: the maps take their space

  // column sums and coefficients: thread (j, segment) takes kSeg centres
  const float ws = (float)(W * W);
  for (int k = tid; k < G::C * G::kSegsC; k += kBwdThreads) {
    const int j = k % G::C, i0 = (k / G::C) * kSeg;
    float s[5][kSeg];
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
        s[q][t] = acc;
      }
    }
    const int gc = c0 - P + j;
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const int i = i0 + t;
      if (i >= G::C) break;
      const int gr = r0 - P + i;
      float g_is = 0.0f, g_js = 0.0f, pv_i = 0.0f, pv_j = 0.0f, pc = 0.0f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
        const float cross = s[4][t] - s[0][t] * s[1][t] / ws;
        const float I_var = s[2][t] - s[0][t] * s[0][t] / ws;
        const float J_var = s[3][t] - s[1][t] * s[1][t] / ws;
        const float D = I_var * J_var + kEps;
        pc = 2.0f * cross / D;
        const float cc_over_D = (cross * cross) / (D * D);
        pv_i = -cc_over_D * J_var;
        pv_j = -cc_over_D * I_var;
        g_is = pc * (-s[1][t] / ws) + pv_i * (-2.0f * s[0][t] / ws);
        g_js = pc * (-s[0][t] / ws) + pv_j * (-2.0f * s[1][t] / ws);
      }
      const int o = i * G::CS + j;
      cs[o] = g_is;
      cs[G::C * G::CS + o] = g_js;
      cs[2 * G::C * G::CS + o] = pv_i;
      cs[3 * G::C * G::CS + o] = pv_j;
      cs[4 * G::C * G::CS + o] = pc;
    }
  }
  __syncthreads();

  // box rows: thread (i, segment) takes kSeg of the tile's columns
  float* bs = hs;
  for (int k = tid; k < G::C * (kTile / kSeg); k += kBwdThreads) {
    const int i = k % G::C, j0 = (k / G::C) * kSeg;
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      float v[kSeg + W - 1];
#pragma unroll
      for (int t = 0; t < kSeg + W - 1; ++t) v[t] = cs[(q * G::C + i) * G::CS + j0 + t];
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

  // box columns and dI, dJ: thread (j, segment) takes kSegOut of the tile's
  // rows, a warp a segment, so each store is 32 neighbours
  const int j = tid % kTile, i0 = (tid / kTile) * kSegOut;
  int64_t o[kSegOut];
  float x[kSegOut], y[kSegOut];  // loaded before the sums, to hide their latency
#pragma unroll
  for (int t = 0; t < kSegOut; ++t) {
    const bool in = r0 + i0 + t < h && c0 + j < w;
    o[t] = base + (in ? (int64_t)(r0 + i0 + t) * w + (c0 + j) : 0);
    x[t] = I[o[t]];
    y[t] = J[o[t]];
  }
  float b[5][kSegOut];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
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
    dI[o[t]] = sg * (b[0][t] + 2.0f * x[t] * b[2][t] + y[t] * b[4][t]);
    dJ[o[t]] = sg * (b[1][t] + 2.0f * y[t] * b[3][t] + x[t] * b[4][t]);
  }
}

// Launch lncc_bwd_kernel<W>, its dynamic shared memory (Bwd<W>::kBytes,
// 70 KB at win 9) opted into once a device: the
// current device, which the caller sets to the tensors' card.
template <int W>
int launch_bwd(const void* I, const void* J, const void* gout, float scale,
               void* dI, void* dJ, int64_t planes, int h, int w, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::atomic<bool> opted[kDevices];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev].load(std::memory_order_relaxed)) {
    rc = (int)cudaFuncSetAttribute(lncc_bwd_kernel<W>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Bwd<W>::kBytes);
    if (rc != 0) return rc;
    opted[dev].store(true, std::memory_order_relaxed);
  }
  lncc_bwd_kernel<W><<<tiles(h, w, planes), kBwdThreads, Bwd<W>::kBytes, s>>>(
      (const float*)I, (const float*)J, (const float*)gout, scale, (float*)dI,
      (float*)dJ, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. I, J: [planes, h, w] f32,
// contiguous; win odd, 1 <= win <= 15. Each launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// window it does not take); none synchronises or allocates.

// partial: [planes * tiles] scratch, tiles = ceil(h/rows) * ceil(w/32),
// rows (8, 16 or 32) the tile's output rows (kernels/__init__.py::fwd_rows
// sizes both); sums: [planes], the per-plane sums of the cc map. One
// cooperative launch of the forward for the window and tile.
extern "C" int san_lncc_fwd(const void* I, const void* J, void* partial, void* sums,
                            int64_t planes, int h, int w, int win, int rows,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (win) {
    case 1: return launch_fwd_rows<1>(I, J, partial, sums, planes, h, w, rows, s);
    case 3: return launch_fwd_rows<3>(I, J, partial, sums, planes, h, w, rows, s);
    case 5: return launch_fwd_rows<5>(I, J, partial, sums, planes, h, w, rows, s);
    case 7: return launch_fwd_rows<7>(I, J, partial, sums, planes, h, w, rows, s);
    case 9: return launch_fwd_rows<9>(I, J, partial, sums, planes, h, w, rows, s);
    case 11: return launch_fwd_rows<11>(I, J, partial, sums, planes, h, w, rows, s);
    case 13: return launch_fwd_rows<13>(I, J, partial, sums, planes, h, w, rows, s);
    case 15: return launch_fwd_rows<15>(I, J, partial, sums, planes, h, w, rows, s);
    static_assert(kMaxWin == 15, "a case for every window");
    default: return (int)cudaErrorInvalidValue;
  }
}

// gout: the upstream gradient of the loss (one f32 on the device); scale =
// 1 / (N C H W); dI, dJ: [planes, h, w]. One launch of the fused kernel
// for the window.
extern "C" int san_lncc_bwd(const void* I, const void* J, const void* gout,
                            float scale, void* dI, void* dJ, int64_t planes,
                            int h, int w, int win, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (win) {
    case 1: return launch_bwd<1>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 3: return launch_bwd<3>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 5: return launch_bwd<5>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 7: return launch_bwd<7>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 9: return launch_bwd<9>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 11: return launch_bwd<11>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 13: return launch_bwd<13>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    case 15: return launch_bwd<15>(I, J, gout, scale, dI, dJ, planes, h, w, s);
    static_assert(kMaxWin == 15, "a case for every window");
    default: return (int)cudaErrorInvalidValue;
  }
}
