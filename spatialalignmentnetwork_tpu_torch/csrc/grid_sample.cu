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

// d_grid (`grid_sample_bwd_dgrid`): one thread per output pixel, looping
// over C, so the channel sum needs no atomics and is deterministic. Per
// channel d_ix = g [(1-wy)(I(y0,x0+1) - I(y0,x0)) + wy (I(y0+1,x0+1) -
// I(y0+1,x0))], d_iy likewise; a tap outside the image reads 0, as the
// Pallas iota-tent does (also in border/reflection mode, where only an
// exact upper-edge coordinate has such a tap). The chain through the
// padding transform follows JAX's autodiff of `_apply_padding`: the clamp
// gives half the gradient at an exact bound (jnp.clip is max then min, and
// JAX splits a max/min tie evenly), abs'(0) = +1. Then d_grid = d_coord *
// size / 2.
//
// d_img (`grid_sample_bwd_dimg`): one thread per (output pixel, channel);
// the four weighted taps are atomicAdd-ed into a zeroed f32 d_img. Float
// atomics make the summation order, and so the last bits, change from run
// to run. A gather form over source pixels would be deterministic but
// needs the inverse map of the grid; it is later work.
//
// Bound on the H100 SXM: memory, for all three. At the serving shape (batch
// 8, 1 x 320 x 320, f32) the forward reads 3.3 MB of image and 6.6 MB of
// grid and writes 3.3 MB: about 13.1 MB, or about 3.9 us at 3.35 TB/s,
// against about 0.02 GFLOP of arithmetic; a thread a pixel reached 1 TB/s
// there, held back by the latency of one 8-byte grid load and then four
// dependent gathers a thread, which the four-pixel threads overlap. At the
// train shape (batch 4) the d_grid kernel moves 9.8 MB (image, grid and
// upstream gradient read, d_grid written: 2.9 us) and d_img 8.2 MB (grid
// and upstream gradient read, d_img zeroed and written: 2.4 us). Faster
// backward kernels (several pixels a thread, the source band staged in
// shared memory) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  }
  return t;
}

constexpr int kFwdPx = 4;  // output pixels a forward thread

// Four consecutive outputs in one store (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[kFwdPx]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kFwdPx]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
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
  const int p0 = (int)(blockIdx.x * blockDim.x + threadIdx.x) * kFwdPx;
  if (p0 >= pixels) return;
  const int plane_in = h * w;
  float2 g[kFwdPx];
  if constexpr (kVec) {
    const float4 a = reinterpret_cast<const float4*>(grid)[p0 / 2];
    const float4 b = reinterpret_cast<const float4*>(grid)[p0 / 2 + 1];
    g[0] = make_float2(a.x, a.y);
    g[1] = make_float2(a.z, a.w);
    g[2] = make_float2(b.x, b.y);
    g[3] = make_float2(b.z, b.w);
  } else {
#pragma unroll
    for (int k = 0; k < kFwdPx; ++k)
      g[k] = p0 + k < pixels ? grid[p0 + k] : make_float2(0.0f, 0.0f);
  }
  // per pixel: the four taps' weights (0 for a tap that zeros padding
  // drops; border/reflection coordinates are already inside) and offsets
  // from the first channel of its image, and its first output
  float tw[kFwdPx][4];
  int toff[kFwdPx][4], dst[kFwdPx];
#pragma unroll
  for (int k = 0; k < kFwdPx; ++k) {
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
    float v[kFwdPx][4];
#pragma unroll
    for (int k = 0; k < kFwdPx; ++k)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[k][t] = tw[k][t] == 0.0f ? 0.0f : load_as_float(src + toff[k][t]);
    float acc[kFwdPx];
#pragma unroll
    for (int k = 0; k < kFwdPx; ++k) {
      acc[k] = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k][t], tw[k][t]));
    }
    if constexpr (kVec) {
      store4(o + dst[0], acc);
    } else {
#pragma unroll
      for (int k = 0; k < kFwdPx; ++k)
        if (p0 + k < pixels) store_from_float(o + dst[k], acc[k]);
    }
  }
}

template <typename T>
int launch_fwd(const void* img, const void* grid, void* out, int n, int c, int h,
               int w, int ho, int wo, int mode, cudaStream_t s) {
  const int pixels = n * ho * wo;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pixels + threads * kFwdPx - 1) / (threads * kFwdPx));
  const bool vec = (ho * wo) % kFwdPx == 0 && (uintptr_t)grid % 16 == 0 &&
                   (uintptr_t)out % (kFwdPx * sizeof(T)) == 0;
  if (vec)
    grid_sample_fwd_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)img, (const float2*)grid, (T*)out, pixels, c, h, w, ho * wo, mode);
  else
    grid_sample_fwd_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)img, (const float2*)grid, (T*)out, pixels, c, h, w, ho * wo, mode);
  return (int)cudaGetLastError();
}

// d_grid: one thread per output pixel, channels summed in order.
__global__ void grid_sample_bwd_dgrid_kernel(const float* __restrict__ img,
                                             const float2* __restrict__ grid,
                                             const float* __restrict__ gout,
                                             float2* __restrict__ dgrid,
                                             int n, int c, int h, int w,
                                             int ho, int wo, int mode) {
  const int64_t pixels = (int64_t)n * ho * wo;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const int64_t plane_out = (int64_t)ho * wo;
  const int64_t plane_in = (int64_t)h * w;
  const int64_t b = p / plane_out;
  const int64_t q = p - b * plane_out;

  const float2 g = grid[p];
  const float ux = unnormalize(g.x, w);
  const float uy = unnormalize(g.y, h);
  const Taps taps = make_taps(pad_coord(ux, w, mode), pad_coord(uy, h, mode),
                              h, w);
  const float one_wx = __fsub_rn(1.0f, taps.wx);
  const float one_wy = __fsub_rn(1.0f, taps.wy);

  const float* src = img + b * c * plane_in;
  const float* go = gout + b * c * plane_out + q;
  float dix = 0.0f;
  float diy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = taps.inside[t] ? src[taps.offset[t]] : 0.0f;
    const float ddx = __fadd_rn(__fmul_rn(one_wy, __fsub_rn(v[1], v[0])),
                                __fmul_rn(taps.wy, __fsub_rn(v[3], v[2])));
    const float ddy = __fadd_rn(__fmul_rn(one_wx, __fsub_rn(v[2], v[0])),
                                __fmul_rn(taps.wx, __fsub_rn(v[3], v[1])));
    const float gv = *go;
    dix = __fadd_rn(dix, __fmul_rn(gv, ddx));
    diy = __fadd_rn(diy, __fmul_rn(gv, ddy));
    src += plane_in;
    go += plane_out;
  }
  // chain through the padding transform and the unnormalization
  // ((g + 1) * size - 1) / 2; both factors are exact
  const float sx = pad_coord_slope(ux, w, mode) * (0.5f * (float)w);
  const float sy = pad_coord_slope(uy, h, mode) * (0.5f * (float)h);
  dgrid[p] = make_float2(__fmul_rn(dix, sx), __fmul_rn(diy, sy));
}

// d_img: one thread per (output pixel, channel), scattering its four
// weighted taps into the zeroed d_img with atomics.
__global__ void grid_sample_bwd_dimg_kernel(const float2* __restrict__ grid,
                                            const float* __restrict__ gout,
                                            float* __restrict__ dimg, int n,
                                            int c, int h, int w, int ho,
                                            int wo, int mode) {
  const int64_t total = (int64_t)n * c * ho * wo;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t plane_out = (int64_t)ho * wo;
  const int64_t bc = i / plane_out;  // b * C + ch
  const int64_t q = i - bc * plane_out;
  const int64_t b = bc / c;

  const float gv = gout[i];
  if (gv == 0.0f) return;
  const float2 g = grid[b * plane_out + q];
  const Taps taps = make_taps(pad_coord(unnormalize(g.x, w), w, mode),
                              pad_coord(unnormalize(g.y, h), h, mode), h, w);
  float* dst = dimg + bc * (int64_t)h * w;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (taps.inside[t] && taps.weight[t] != 0.0f)
      atomicAdd(dst + taps.offset[t], __fmul_rn(gv, taps.weight[t]));
  }
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
  const int64_t pixels = (int64_t)n * ho * wo;
  if (pixels == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pixels + threads - 1) / threads);
  grid_sample_bwd_dgrid_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float2*)grid, (const float*)gout,
      (float2*)dgrid, n, c, h, w, ho, wo, padding_mode);
  return (int)cudaGetLastError();
}

// Adds d_img from grid [N, Ho, Wo, 2] f32 (8-byte aligned) and gout
// [N, C, Ho, Wo] f32 into dimg [N, C, H, W] f32, which the caller zeroed.
// Returns cudaGetLastError().
extern "C" int san_grid_sample_bwd_dimg(const void* grid, const void* gout,
                                        void* dimg, int n, int c, int h, int w,
                                        int ho, int wo, int padding_mode,
                                        void* stream) {
  const int64_t total = (int64_t)n * c * ho * wo;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  grid_sample_bwd_dimg_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)grid, (const float*)gout, (float*)dimg, n, c, h, w, ho,
      wo, padding_mode);
  return (int)cudaGetLastError();
}
