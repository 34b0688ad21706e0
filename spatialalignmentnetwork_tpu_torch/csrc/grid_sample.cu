// Bilinear grid sample, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// spatialalignmentnetwork_tpu/ops/pallas/grid_sample.py: the forward
// `_forward` / `_kernel` (pallas_call at :222) and the two halves of the
// custom VJP's backward `_bwd`, `_kernel_dimg` (:294, call :438) and
// `_kernel_dgrid` (:352, call :451). Those kernels rewrote the 4-tap
// gather and its transpose as one-hot MXU contractions because the TPU has
// no fast vector gather or scatter; the GPU gathers natively and scatters
// with atomics, so these are the direct 4-tap forms of
// ops/grid_sample.py:115-167 and their derivatives.
//
// Semantics: align_corners=False; padding zeros / border / reflection
// (reflect about [-0.5, size-0.5], then clamp into [0, size-1]); the
// coordinate math is f32 whatever the image type. Forward: image f32 or
// bf16, grid f32 [N, Ho, Wo, 2] (x first), output in the image type,
// accumulation in f32. Backward: f32 only.
//
// Every f32 operation of the coordinate and weight math uses the
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...), which nvcc never
// contracts into FMAs: a contracted ((g + 1) * W - 1) differs from the
// separately rounded plain version by up to one ulp of the pixel
// coordinate (3e-5 at 320), which is a visible error in the output. The
// backward kernels compute the coordinates with the same code as the
// forward, so floor() picks the same taps: at a sample within an ulp of an
// integer coordinate the floor-form derivative is one-sided, and an ulp of
// difference would take the other neighbour difference.
//
// Forward design: four output pixels a thread, consecutive in the flat
// (n, ho, wo) order, so a thread reads 32 bytes of grid (two 16-byte loads
// where Ho Wo is a multiple of 4 and the pointers are aligned; else one
// 8-byte load a pixel, which takes any Wo and a tail) and puts 16 tap
// loads of each channel in flight together before it sums any; the four
// outputs go out in one 16-byte (f32) or 8-byte (bf16) store. Tap offsets
// are 32-bit: the wrapper refuses tensors of 2^31 elements. Each pixel
// keeps the one-pixel sequence of rounded operations (unnormalize, pad,
// taps, weights, then the taps summed in order), so the results are those
// of a thread a pixel, bit for bit. Gather-only, so the result is
// deterministic.

// d_grid (`grid_sample_bwd_dgrid`): the forward's layout, four output
// pixels a thread (two 16-byte grid loads, one 16-byte upstream-gradient
// load a channel and two 16-byte d_grid stores where Ho Wo % 4 == 0 and
// the pointers are 16-byte aligned; else a pixel at a time and a masked
// tail), all 16 tap loads of a channel in flight before any sum, 32-bit
// offsets. Per pixel and channel d_ix = g [(1-wy)(I(y0,x0+1) - I(y0,x0)) +
// wy (I(y0+1,x0+1) - I(y0+1,x0))], d_iy likewise, summed over C in order
// in the thread, so the result is deterministic and each pixel keeps the
// sequence of rounded operations of a thread a pixel, bit for bit. A tap
// outside the image reads 0, as the Pallas iota-tent does (also in
// border/reflection mode, where only an exact upper-edge coordinate has
// such a tap). The chain through the padding transform follows JAX's
// autodiff of `_apply_padding`: the clamp gives half the gradient at an
// exact bound (jnp.clip is max then min, and JAX splits a max/min tie
// evenly), abs'(0) = +1. Then d_grid = d_coord * size / 2.
//
// d_img (`grid_sample_bwd_dimg`): the same bits on every run, by
// fixed-point sums. For each (n, c) plane, 2^k is set from the plane's
// largest finite |g| M (`kernels/grid_sample.py::fixed_point_exponent`):
// k = 59 - ceil(log2(Ho Wo)) - e with M = m 2^e, m in [0.5, 1), so that
// Ho Wo M 2^k < 2^59. A contribution g w (w <= 1 the tap's weight, 0 for a
// tap outside the image) becomes the int64 8 round(g w 2^k) (the double
// product g w 2^k is exact; round half to even); an output pixel adds to
// a source pixel at most once, so no plane's sum leaves (-2^62 - 2^33,
// 2^62 + 2^33). Integer sums do not depend on their order, so shared
// atomics, global atomics and any pre-combining give the same bits. The
// low three bits of each word, which the multiples of 8 never touch, flag
// the non-finite contributions by atomicOr: +inf (a tap of weight > 0
// times +inf), -inf, and NaN (a NaN g, or an infinite g times a weight of
// 0, as the plain version's f32 product gives). A word becomes d_img =
// f32(double(sum / 8) 2^-k), or NaN where the NaN flag or both infinities
// are set, else the infinity flagged. Against the exact sum the error is
// at most (contributions) 2^-(k+1) plus one f32 rounding: about 2^-40 of M
// at 320^2 for a pixel of four contributions.
//
// One cooperative launch (`launch_cooperative`, csrc/window.cuh) of
// kDimgThreads-thread blocks, each walking 32 x 32 output tiles of one
// image, in three phases with a grid-wide barrier between them: (0) zero
// the int64 words [N, C, H, W] (scratch from the wrapper) and write each
// tile's largest finite |g| a channel; (1) a tile's taps (four pixels a
// thread), their bounding box, and a channel at a time k from the plane's
// tile maxima and the contributions: where the box fits a shared window of
// kDimgWindow words (the counterpart of the Pallas band's `fits`), into it
// by native 32-bit shared atomics on three 21-bit chunks of each int64
// contribution (a 64-bit shared atomicAdd is a compare-and-swap loop),
// then one global 64-bit atomicAdd (and atomicOr for flags) a nonzero
// word; else straight into the global words;
// (2) convert every word to d_img, which the kernel writes whole.
//
// Bound on the H100 SXM: memory, for all three. At the serving shape (batch
// 8, 1 x 320 x 320, f32) the forward reads 3.3 MB of image and 6.6 MB of
// grid and writes 3.3 MB: about 13.1 MB, or about 3.9 us at 3.35 TB/s,
// against about 0.02 GFLOP of arithmetic; a thread a pixel reached 1 TB/s
// there, held back by the latency of one 8-byte grid load and then four
// dependent gathers a thread, which the four-pixel threads overlap. At the
// train shape (batch 4) the d_grid kernel moves 9.8 MB (image, grid and
// upstream gradient read, d_grid written: 2.9 us) and d_img 6.6 MB (grid
// and upstream gradient read, d_img written: 2.0 us; its 3.3 MB of int64
// words are the design's, not the work's, and stay in the 50 MB L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "window.cuh"

namespace {

enum PaddingMode { kZeros = 0, kBorder = 1, kReflection = 2 };

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ((g + 1) * size - 1) / 2, each step rounded on its own.
__device__ __forceinline__ float unnormalize(float g, int size) {
  float t = __fmul_rn(__fadd_rn(g, 1.0f), (float)size);
  return __fdiv_rn(__fsub_rn(t, 1.0f), 2.0f);
}

// Reflect about the pixel-edge bounds [-0.5, size - 0.5], before the
// clamp. The parity of the number of flips is read from fmod(t, 2 * size),
// which is exact, as in the plain version. *slope is d(result)/dx: the
// sign of (x + 0.5) (+1 at 0, as JAX's abs') times -1 on an odd flip.
__device__ __forceinline__ float reflect_unclamped(float x, int size,
                                                  float* slope) {
  const float low = -0.5f;
  const float span = (float)size;
  const float d = __fsub_rn(x, low);
  const float t = fabsf(d);
  const float m = fmodf(t, __fmul_rn(2.0f, span));  // exact; t >= 0
  const bool even = m < span;
  *slope = (d >= 0.0f) == even ? 1.0f : -1.0f;
  return even ? __fadd_rn(m, low)
              : __fadd_rn(__fsub_rn(span, __fsub_rn(m, span)), low);
}

__device__ __forceinline__ float pad_coord(float x, int size, int mode) {
  float slope;
  if (mode == kReflection)
    return clampf(reflect_unclamped(x, size, &slope), 0.0f, (float)size - 1.0f);
  if (mode == kBorder) return clampf(x, 0.0f, (float)size - 1.0f);
  return x;
}

// d/dx min(max(x, lo), hi) as JAX differentiates jnp.clip: a max or min
// tie splits the gradient evenly, so an exact bound gives 0.5.
__device__ __forceinline__ float clamp_slope(float x, float lo, float hi) {
  const float d_max = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float a = fmaxf(x, lo);
  const float d_min = a < hi ? 1.0f : (a == hi ? 0.5f : 0.0f);
  return d_max * d_min;
}

// d pad_coord(x) / dx, a power of two times -1, 0 or 1 (so chaining it is
// exact).
__device__ __forceinline__ float pad_coord_slope(float x, int size, int mode) {
  const float hi = (float)size - 1.0f;
  if (mode == kReflection) {
    float slope;
    const float r = reflect_unclamped(x, size, &slope);
    return slope * clamp_slope(r, 0.0f, hi);
  }
  if (mode == kBorder) return clamp_slope(x, 0.0f, hi);
  return 1.0f;
}

// The four taps of a sample at padded pixel coordinates (ix, iy), in the
// order (0,0), (1,0), (0,1), (1,1): the bilinear weights, whether each tap
// lies inside the image, and its plane offset (clamped into the image, so
// an outside tap's address stays valid; a plane has under 2^31 pixels).
struct Taps {
  float wx, wy;  // fractional parts
  float weight[4];
  bool inside[4];
  int offset[4];
  int row[2], col[2];  // clamped y0, y0 + 1 and x0, x0 + 1
};

__device__ __forceinline__ Taps make_taps(float ix, float iy, int h, int w) {
  Taps t;
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  t.wx = __fsub_rn(ix, x0);
  t.wy = __fsub_rn(iy, y0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = k & 1;
    const int dy = k >> 1;
    const float xc = __fadd_rn(x0, (float)dx);
    const float yc = __fadd_rn(y0, (float)dy);
    t.weight[k] = __fmul_rn(dx ? t.wx : __fsub_rn(1.0f, t.wx),
                            dy ? t.wy : __fsub_rn(1.0f, t.wy));
    t.inside[k] = xc >= 0.0f && xc <= (float)(w - 1) && yc >= 0.0f &&
                  yc <= (float)(h - 1);
    const int xi = (int)clampf(xc, 0.0f, (float)(w - 1));
    const int yi = (int)clampf(yc, 0.0f, (float)(h - 1));
    t.offset[k] = yi * w + xi;
    t.row[dy] = yi;
    t.col[dx] = xi;
  }
  return t;
}

constexpr int kPx = 4;  // output pixels a thread, in every kernel here

// Four consecutive outputs in one store (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[kPx]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kPx]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// The grid at pixels p0 .. p0 + 3: two 16-byte loads (kVec: p0 % 4 == 0,
// all four pixels live, the grid 16-byte aligned), else one 8-byte load a
// pixel below `pixels` and 0 past it.
template <bool kVec>
__device__ __forceinline__ void load_grid4(const float2* __restrict__ grid, int p0,
                                           int pixels, float2 (&g)[kPx]) {
  if constexpr (kVec) {
    const float4 a = reinterpret_cast<const float4*>(grid)[p0 / 2];
    const float4 b = reinterpret_cast<const float4*>(grid)[p0 / 2 + 1];
    g[0] = make_float2(a.x, a.y);
    g[1] = make_float2(a.z, a.w);
    g[2] = make_float2(b.x, b.y);
    g[3] = make_float2(b.z, b.w);
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      g[k] = p0 + k < pixels ? grid[p0 + k] : make_float2(0.0f, 0.0f);
  }
}

// Pixels p0 .. p0 + 3 of the flat (n, ho, wo) order. kVec: all four lie in
// one image (Ho Wo % 4 == 0), the grid is 16-byte and the output 4-element
// aligned, so the grid comes in two 16-byte loads and the outputs go out
// in one store; else a pixel at a time, and a pixel past the end reads
// and writes nothing (its tap weights are 0).
template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
    grid_sample_fwd_kernel(const T* __restrict__ img, const float2* __restrict__ grid,
                           T* __restrict__ out, int pixels, int c, int h, int w,
                           int plane_out, int mode) {
  const int p0 = (int)(blockIdx.x * blockDim.x + threadIdx.x) * kPx;
  if (p0 >= pixels) return;
  const int plane_in = h * w;
  float2 g[kPx];
  load_grid4<kVec>(grid, p0, pixels, g);
  // per pixel: the four taps' weights (0 for a tap that zeros padding
  // drops; border/reflection coordinates are already inside) and offsets
  // from the first channel of its image, and its first output
  float tw[kPx][4];
  int toff[kPx][4], dst[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const float ix = pad_coord(unnormalize(g[k].x, w), w, mode);
    const float iy = pad_coord(unnormalize(g[k].y, h), h, mode);
    const Taps taps = make_taps(ix, iy, h, w);
    const int p = p0 + k;
    const bool live = kVec || p < pixels;
    const int b = live ? p / plane_out : 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      tw[k][t] = !live || (mode == kZeros && !taps.inside[t]) ? 0.0f : taps.weight[t];
      toff[k][t] = b * c * plane_in + taps.offset[t];
    }
    dst[k] = live ? b * c * plane_out + (p - b * plane_out) : 0;
  }
  for (int ch = 0; ch < c; ++ch) {
    const T* src = img + ch * plane_in;
    T* o = out + ch * plane_out;
    float v[kPx][4];
#pragma unroll
    for (int k = 0; k < kPx; ++k)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[k][t] = tw[k][t] == 0.0f ? 0.0f : load_as_float(src + toff[k][t]);
    float acc[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      acc[k] = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k][t], tw[k][t]));
    }
    if constexpr (kVec) {
      store4(o + dst[0], acc);
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (p0 + k < pixels) store_from_float(o + dst[k], acc[k]);
    }
  }
}

template <typename T>
int launch_fwd(const void* img, const void* grid, void* out, int n, int c, int h,
               int w, int ho, int wo, int mode, cudaStream_t s) {
  const int pixels = n * ho * wo;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pixels + threads * kPx - 1) / (threads * kPx));
  const bool vec = (ho * wo) % kPx == 0 && (uintptr_t)grid % 16 == 0 &&
                   (uintptr_t)out % (kPx * sizeof(T)) == 0;
  if (vec)
    grid_sample_fwd_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)img, (const float2*)grid, (T*)out, pixels, c, h, w, ho * wo, mode);
  else
    grid_sample_fwd_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)img, (const float2*)grid, (T*)out, pixels, c, h, w, ho * wo, mode);
  return (int)cudaGetLastError();
}

constexpr int kDgridThreads = 128;  // 128: faster than 256 at 320^2 on an H100 (PERF.md)

// d_grid at pixels p0 .. p0 + 3 of the flat (n, ho, wo) order, channels
// summed in order. kVec as the forward's, with gout and dgrid 16-byte
// aligned too: one 16-byte g load a channel and two 16-byte stores.
template <bool kVec>
__global__ void __launch_bounds__(kDgridThreads)
    grid_sample_bwd_dgrid_kernel(const float* __restrict__ img,
                                 const float2* __restrict__ grid,
                                 const float* __restrict__ gout,
                                 float2* __restrict__ dgrid, int pixels, int c, int h,
                                 int w, int plane_out, int mode) {
  const int p0 = (int)(blockIdx.x * blockDim.x + threadIdx.x) * kPx;
  if (p0 >= pixels) return;
  const int plane_in = h * w;
  float2 g[kPx];
  load_grid4<kVec>(grid, p0, pixels, g);
  // per pixel: fractional parts, the taps' offsets from the first channel
  // of its image (-1 for a tap outside the image or a pixel past the
  // end), its first upstream gradient, and the chain factors
  float wx[kPx], wy[kPx], sx[kPx], sy[kPx];
  int toff[kPx][4], gidx[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const float ux = unnormalize(g[k].x, w);
    const float uy = unnormalize(g[k].y, h);
    const Taps taps = make_taps(pad_coord(ux, w, mode), pad_coord(uy, h, mode), h, w);
    const int p = p0 + k;
    const bool live = kVec || p < pixels;
    const int b = live ? p / plane_out : 0;
    wx[k] = taps.wx;
    wy[k] = taps.wy;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      toff[k][t] = live && taps.inside[t] ? b * c * plane_in + taps.offset[t] : -1;
    gidx[k] = live ? b * c * plane_out + (p - b * plane_out) : -1;
    // the padding transform's and the unnormalization's factors, both exact
    sx[k] = pad_coord_slope(ux, w, mode) * (0.5f * (float)w);
    sy[k] = pad_coord_slope(uy, h, mode) * (0.5f * (float)h);
  }
  float dix[kPx], diy[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) dix[k] = diy[k] = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float* src = img + ch * plane_in;
    const float* go = gout + ch * plane_out;
    float v[kPx][4], gv[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k)
#pragma unroll
      for (int t = 0; t < 4; ++t) v[k][t] = toff[k][t] >= 0 ? src[toff[k][t]] : 0.0f;
    if constexpr (kVec) {
      const float4 q = *reinterpret_cast<const float4*>(go + gidx[0]);
      gv[0] = q.x;
      gv[1] = q.y;
      gv[2] = q.z;
      gv[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k) gv[k] = gidx[k] >= 0 ? go[gidx[k]] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const float one_wx = __fsub_rn(1.0f, wx[k]);
      const float one_wy = __fsub_rn(1.0f, wy[k]);
      const float ddx = __fadd_rn(__fmul_rn(one_wy, __fsub_rn(v[k][1], v[k][0])),
                                  __fmul_rn(wy[k], __fsub_rn(v[k][3], v[k][2])));
      const float ddy = __fadd_rn(__fmul_rn(one_wx, __fsub_rn(v[k][2], v[k][0])),
                                  __fmul_rn(wx[k], __fsub_rn(v[k][3], v[k][1])));
      dix[k] = __fadd_rn(dix[k], __fmul_rn(gv[k], ddx));
      diy[k] = __fadd_rn(diy[k], __fmul_rn(gv[k], ddy));
    }
  }
  float2 d[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) d[k] = make_float2(__fmul_rn(dix[k], sx[k]), __fmul_rn(diy[k], sy[k]));
  if constexpr (kVec) {
    float4* out = reinterpret_cast<float4*>(dgrid + p0);
    out[0] = make_float4(d[0].x, d[0].y, d[1].x, d[1].y);
    out[1] = make_float4(d[2].x, d[2].y, d[3].x, d[3].y);
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      if (p0 + k < pixels) dgrid[p0 + k] = d[k];
  }
}

// ------------------------------------------------------------------ d_img
// A d_img tile is kDimgTile x kDimgTile output pixels of one image; a
// thread takes four neighbours along a row (kernels/grid_sample.py's
// DIMG_TILE sizes the scratch from it).
constexpr int kDimgTile = 32;
constexpr int kDimgThreads = kDimgTile * kDimgTile / kPx;
constexpr int kDimgRowThreads = kDimgTile / kPx;
constexpr int kDimgWarps = kDimgThreads / 32;
constexpr int kHeadroomBits = 59;  // Ho Wo max|g| 2^k < 2^59
constexpr long long kPosInf = 1, kNegInf = 2, kNaN = 4;  // a word's low bits

// A tile's shared window: up to kDimgWindow source pixels of its taps' box,
// each word held as three 32-bit sums of 21-bit chunks of the int64
// contributions (c = c2 2^42 + c1 2^21 + c0, c0 and c1 unsigned, c2
// signed), so that every add is a native 32-bit shared atomic, where a
// 64-bit one is a compare-and-swap loop. A tile has kDimgTile^2 = 2^10
// output pixels and each adds to a word at most once, so c0 and c1 sum
// below 2^31 and c2 (|c| < 2^62: |c2| <= 2^20) within +-2^30. The flags
// are ORed into s0's low bits, which its multiples of 8 never touch.
constexpr int kDimgWindow = 3072;  // 36 KB
constexpr int kChunkBits = 21;
constexpr unsigned kChunkMask = (1u << kChunkBits) - 1;
struct Window {
  unsigned s0[kDimgWindow], s1[kDimgWindow];
  int s2[kDimgWindow];
};

__device__ __forceinline__ void window_add(Window& win, int i, long long c) {
  const unsigned long long u = (unsigned long long)c;
  atomicAdd(&win.s0[i], (unsigned)(u & kChunkMask));
  atomicAdd(&win.s1[i], (unsigned)((u >> kChunkBits) & kChunkMask));
  atomicAdd(&win.s2[i], (int)(c >> (2 * kChunkBits)));
}

// Word i of the window as its int64 sum (flags in the low bits), and the
// word zeroed for the next tile.
__device__ __forceinline__ unsigned long long window_take(Window& win, int i) {
  const unsigned long long v = (unsigned long long)win.s0[i] +
                               ((unsigned long long)win.s1[i] << kChunkBits) +
                               ((unsigned long long)(long long)win.s2[i] << (2 * kChunkBits));
  win.s0[i] = win.s1[i] = 0;
  win.s2[i] = 0;
  return v;
}

struct Dimg {
  const float2* grid;  // [N, Ho, Wo]
  const float* gout;   // [N, C, Ho, Wo]
  float* dimg;         // [N, C, H, W]
  long long* words;    // [N, C, H, W], then `part` and `expo`
  unsigned* part;      // [N, C, tiles]: a tile's largest finite |g|, f32 bits
  int* expo;           // [N, C]: k of each plane
  int n, c, h, w, ho, wo, mode, tiles_x, tiles;
  bool vec;  // Wo % 4 == 0, grid and gout 16-byte aligned
};

// A thread's place in tile `tile` (of N * tiles): its image b, its row y
// and first column x0 in the image's output plane.
struct DimgPlace {
  int b, t, y, x0;
  bool live[kPx];
};

__device__ __forceinline__ DimgPlace dimg_place(const Dimg& a, int tile) {
  DimgPlace q;
  q.b = tile / a.tiles;
  q.t = tile - q.b * a.tiles;
  const int ty = q.t / a.tiles_x;
  q.y = ty * kDimgTile + (int)threadIdx.x / kDimgRowThreads;
  q.x0 = (q.t - ty * a.tiles_x) * kDimgTile + (int)threadIdx.x % kDimgRowThreads * kPx;
#pragma unroll
  for (int k = 0; k < kPx; ++k) q.live[k] = q.y < a.ho && q.x0 + k < a.wo;
  return q;
}

// The upstream gradient of plane `plane` at a thread's four pixels (0
// past the edge).
__device__ __forceinline__ void dimg_gout(const Dimg& a, const DimgPlace& q, int plane,
                                          float (&gv)[kPx]) {
  const float* go = a.gout + plane * (a.ho * a.wo) + q.y * a.wo + q.x0;
  if (a.vec && q.live[0]) {
    const float4 v = *reinterpret_cast<const float4*>(go);
    gv[0] = v.x;
    gv[1] = v.y;
    gv[2] = v.z;
    gv[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k) gv[k] = q.live[k] ? go[k] : 0.0f;
  }
}

// The block's largest `v` (non-negative floats' bits order as unsigned),
// in every thread; with `box`, also the block's box (rows x..y, columns
// z..w) of the threads' boxes.
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* red, int4* box = nullptr,
                                              int4* box_red = nullptr) {
  v = __reduce_max_sync(0xffffffffu, v);
  int4 b;
  if (box) {
    b.x = __reduce_min_sync(0xffffffffu, box->x);
    b.y = __reduce_max_sync(0xffffffffu, box->y);
    b.z = __reduce_min_sync(0xffffffffu, box->z);
    b.w = __reduce_max_sync(0xffffffffu, box->w);
  }
  __syncthreads();  // red's last readers are done
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = v;
    if (box) box_red[threadIdx.x / 32] = b;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kDimgWarps; ++i) {
    v = max(v, red[i]);
    if (box) {
      b.x = min(b.x, box_red[i].x);
      b.y = max(b.y, box_red[i].y);
      b.z = min(b.z, box_red[i].z);
      b.w = max(b.w, box_red[i].w);
    }
  }
  if (box) *box = b;
  return v;
}

// The largest of plane `plane`'s tile maxima this thread reads.
__device__ __forceinline__ unsigned plane_part(const Dimg& a, int plane) {
  unsigned m = 0;
  for (int i = threadIdx.x; i < a.tiles; i += blockDim.x)
    m = max(m, __ldcg(a.part + plane * a.tiles + i));
  return m;
}

// The padded pixel coordinates of a thread's four samples (0 past the
// edge).
__device__ __forceinline__ void dimg_coords(const Dimg& a, const DimgPlace& q,
                                            float (&ix)[kPx], float (&iy)[kPx]) {
  float2 g[kPx];
  const int p0 = (q.b * a.ho + q.y) * a.wo + q.x0;
  if (a.vec && q.live[0]) {
    load_grid4<true>(a.grid, p0, 0, g);
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k) g[k] = q.live[k] ? a.grid[p0 + k] : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    ix[k] = pad_coord(unnormalize(g[k].x, a.w), a.w, a.mode);
    iy[k] = pad_coord(unnormalize(g[k].y, a.h), a.h, a.mode);
  }
}

// Phase 0: zero the words; each tile's largest finite |g| a channel.
__device__ void dimg_zero_and_max(const Dimg& a, unsigned* red) {
  const int64_t words = (int64_t)a.n * a.c * a.h * a.w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  longlong2* w2 = reinterpret_cast<longlong2*>(a.words);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < words / 2; i += stride)
    w2[i] = make_longlong2(0, 0);
  if (words % 2 && blockIdx.x == 0 && threadIdx.x == 0) a.words[words - 1] = 0;
  for (int tile = blockIdx.x; tile < a.n * a.tiles; tile += gridDim.x) {
    const DimgPlace q = dimg_place(a, tile);
    for (int ch = 0; ch < a.c; ++ch) {
      const int plane = q.b * a.c + ch;
      float gv[kPx];
      dimg_gout(a, q, plane, gv);
      float m = 0.0f;
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (isfinite(gv[k])) m = fmaxf(m, fabsf(gv[k]));
      const unsigned bits = block_max(__float_as_uint(m), red);
      if (threadIdx.x == 0) a.part[plane * a.tiles + q.t] = bits;
    }
  }
}

// Phase 1: each tile's contributions, a channel at a time. The grid, the
// first channel's g and its plane's tile maxima are loaded together; one
// block reduction gives the taps' box and the plane's max |g|.
__device__ void dimg_accumulate(const Dimg& a, Window& win, unsigned* red, int4* box_red) {
  const int plane_in = a.h * a.w;
  const int log2_count = 32 - __clz(a.ho * a.wo - 1);  // ceil(log2(Ho Wo))
  for (int i = threadIdx.x; i < kDimgWindow; i += blockDim.x) {
    win.s0[i] = win.s1[i] = 0;
    win.s2[i] = 0;
  }
  for (int tile = blockIdx.x; tile < a.n * a.tiles; tile += gridDim.x) {
    const DimgPlace q = dimg_place(a, tile);
    float ix[kPx], iy[kPx], gv[kPx];
    dimg_coords(a, q, ix, iy);
    dimg_gout(a, q, q.b * a.c, gv);
    unsigned m = plane_part(a, q.b * a.c);
    int4 box = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      if (!q.live[k]) continue;
      const Taps taps = make_taps(ix[k], iy[k], a.h, a.w);
      box.x = min(box.x, taps.row[0]);
      box.y = max(box.y, taps.row[1]);
      box.z = min(box.z, taps.col[0]);
      box.w = max(box.w, taps.col[1]);
    }
    m = block_max(m, red, &box, box_red);
    const int box_w = box.w - box.z + 1;
    const bool fits = (int64_t)(box.y - box.x + 1) * box_w <= kDimgWindow;

    for (int ch = 0; ch < a.c; ++ch) {
      const int plane = q.b * a.c + ch;
      if (ch > 0) {
        dimg_gout(a, q, plane, gv);
        m = block_max(plane_part(a, plane), red);
      }
      int e;
      frexp((double)__uint_as_float(m), &e);
      const int exp2_k = kHeadroomBits - log2_count - e;
      if (q.t == 0 && threadIdx.x == 0) a.expo[plane] = exp2_k;
      const double scale = ldexp(1.0, exp2_k);
      unsigned long long* gw =
          reinterpret_cast<unsigned long long*>(a.words) + (int64_t)plane * plane_in;
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        if (!q.live[k]) continue;
        const Taps taps = make_taps(ix[k], iy[k], a.h, a.w);
        const bool finite = isfinite(gv[k]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float wt = taps.inside[t] ? taps.weight[t] : 0.0f;
          long long add = 0, flag = 0;
          if (finite) {
            if (gv[k] != 0.0f && wt != 0.0f)
              add = 8 * __double2ll_rn(__dmul_rn(__dmul_rn(gv[k], wt), scale));
          } else {
            flag = isnan(gv[k]) || !(wt > 0.0f) ? kNaN : gv[k] > 0.0f ? kPosInf : kNegInf;
          }
          if (add == 0 && flag == 0) continue;
          const int yy = taps.row[t >> 1], xx = taps.col[t & 1];
          if (fits) {
            const int i = (yy - box.x) * box_w + (xx - box.z);
            if (add) window_add(win, i, add);
            if (flag) atomicOr(&win.s0[i], (unsigned)flag);
          } else {
            unsigned long long* dst = gw + yy * a.w + xx;
            if (add) atomicAdd(dst, (unsigned long long)add);
            if (flag) atomicOr(dst, (unsigned long long)flag);
          }
        }
      }
      if (fits) {
        __syncthreads();
        const int words = (box.y - box.x + 1) * box_w;
        for (int i = threadIdx.x; i < words; i += blockDim.x) {
          const unsigned long long v = window_take(win, i);
          if (v == 0) continue;
          const int r = i / box_w;
          unsigned long long* dst = gw + (box.x + r) * a.w + box.z + (i - r * box_w);
          if (v & ~7ull) atomicAdd(dst, v & ~7ull);
          if (v & 7ull) atomicOr(dst, v & 7ull);
        }
        // the next atomics on the window wait for block_max's barriers
      }
    }
  }
}

// A word's value in d_img, at 2^-k = inv.
__device__ __forceinline__ float dimg_value(long long word, double inv) {
  const long long flags = word & 7;
  if (flags == 0) return __double2float_rn(__dmul_rn(__ll2double_rn(word >> 3), inv));
  if (flags == kPosInf) return __int_as_float(0x7f800000);
  if (flags == kNegInf) return __int_as_float(0xff800000);
  return __int_as_float(0x7fffffff);  // NaN, or both infinities
}

// Phase 2: every word to d_img, four a thread where a plane holds a
// multiple of 4 (d_img is a fresh allocation, so 16-byte aligned).
__device__ void dimg_convert(const Dimg& a) {
  const int plane_in = a.h * a.w;
  const int64_t words = (int64_t)a.n * a.c * plane_in;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (plane_in % 4 == 0) {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < words / 4; i += stride) {
      const double inv = ldexp(1.0, -__ldcg(a.expo + (int)(4 * i / plane_in)));
      const longlong2 u = __ldcg(reinterpret_cast<const longlong2*>(a.words) + 2 * i);
      const longlong2 v = __ldcg(reinterpret_cast<const longlong2*>(a.words) + 2 * i + 1);
      reinterpret_cast<float4*>(a.dimg)[i] = make_float4(
          dimg_value(u.x, inv), dimg_value(u.y, inv), dimg_value(v.x, inv), dimg_value(v.y, inv));
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < words; i += stride)
      a.dimg[i] = dimg_value(__ldcg(a.words + i), ldexp(1.0, -__ldcg(a.expo + (int)(i / plane_in))));
  }
}

__global__ void __launch_bounds__(kDimgThreads) grid_sample_bwd_dimg_kernel(Dimg a) {
  __shared__ Window win;
  __shared__ unsigned red[kDimgWarps];
  __shared__ int4 box_red[kDimgWarps];
  dimg_zero_and_max(a, red);
  cooperative_groups::this_grid().sync();
  dimg_accumulate(a, win, red, box_red);
  cooperative_groups::this_grid().sync();
  dimg_convert(a);
}

}  // namespace

// Plain C entry point, loaded with ctypes. img: [N, C, H, W] f32 (is_bf16=0)
// or bf16 (is_bf16=1), contiguous; grid: [N, Ho, Wo, 2] f32, contiguous and
// 8-byte aligned; out: [N, C, Ho, Wo] in the image type. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises and allocates nothing.
extern "C" int san_grid_sample_fwd(const void* img, const void* grid,
                                   void* out, int n, int c, int h, int w,
                                   int ho, int wo, int padding_mode,
                                   int is_bf16, void* stream) {
  if ((int64_t)n * ho * wo == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(img, grid, out, n, c, h, w, ho, wo, padding_mode, s);
  return launch_fwd<float>(img, grid, out, n, c, h, w, ho, wo, padding_mode, s);
}

// d_grid [N, Ho, Wo, 2] f32 from img [N, C, H, W] f32, grid [N, Ho, Wo, 2]
// f32 (8-byte aligned) and the upstream gradient gout [N, C, Ho, Wo] f32,
// all contiguous. Returns cudaGetLastError().
extern "C" int san_grid_sample_bwd_dgrid(const void* img, const void* grid,
                                         const void* gout, void* dgrid, int n,
                                         int c, int h, int w, int ho, int wo,
                                         int padding_mode, void* stream) {
  const int pixels = n * ho * wo;
  if (pixels == 0) return (int)cudaSuccess;
  const int threads = kDgridThreads;
  const unsigned blocks = (unsigned)((pixels + threads * kPx - 1) / (threads * kPx));
  const bool vec = (ho * wo) % kPx == 0 && (uintptr_t)grid % 16 == 0 &&
                   (uintptr_t)gout % 16 == 0 && (uintptr_t)dgrid % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    grid_sample_bwd_dgrid_kernel<true><<<blocks, threads, 0, s>>>(
        (const float*)img, (const float2*)grid, (const float*)gout, (float2*)dgrid,
        pixels, c, h, w, ho * wo, padding_mode);
  else
    grid_sample_bwd_dgrid_kernel<false><<<blocks, threads, 0, s>>>(
        (const float*)img, (const float2*)grid, (const float*)gout, (float2*)dgrid,
        pixels, c, h, w, ho * wo, padding_mode);
  return (int)cudaGetLastError();
}

// d_img [N, C, H, W] f32 from grid [N, Ho, Wo, 2] f32 (8-byte aligned) and
// gout [N, C, Ho, Wo] f32, both contiguous, in one cooperative launch that
// writes every element of dimg (no zeroing needed). scratch: N C (H W +
// tiles + 1) int64 words, 16-byte aligned, tiles = ceil(Ho / 32) ceil(Wo /
// 32) (kernels/grid_sample.py::dimg_scratch_words); its content on entry
// does not matter. Returns the launch's cudaError (0 on success).
extern "C" int san_grid_sample_bwd_dimg(const void* grid, const void* gout,
                                        void* dimg, void* scratch, int n, int c,
                                        int h, int w, int ho, int wo,
                                        int padding_mode, void* stream) {
  const int64_t planes = (int64_t)n * c;
  const int64_t plane_in = (int64_t)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  if (planes * plane_in == 0) return (int)cudaSuccess;
  if (ho * wo == 0)  // no output pixel: d_img is 0
    return (int)cudaMemsetAsync(dimg, 0, (size_t)(planes * plane_in) * sizeof(float), s);
  Dimg a;
  a.grid = (const float2*)grid;
  a.gout = (const float*)gout;
  a.dimg = (float*)dimg;
  a.n = n;
  a.c = c;
  a.h = h;
  a.w = w;
  a.ho = ho;
  a.wo = wo;
  a.mode = padding_mode;
  a.tiles_x = (wo + kDimgTile - 1) / kDimgTile;
  a.tiles = a.tiles_x * ((ho + kDimgTile - 1) / kDimgTile);
  a.words = (long long*)scratch;
  a.part = (unsigned*)(a.words + planes * plane_in);
  a.expo = (int*)(a.words + planes * (plane_in + a.tiles));
  a.vec = wo % kPx == 0 && (uintptr_t)grid % 16 == 0 && (uintptr_t)gout % 16 == 0;
  void* args[] = {&a};
  return launch_cooperative<grid_sample_bwd_dimg_kernel>(kDimgThreads, (int64_t)n * a.tiles,
                                                         args, s);
}
