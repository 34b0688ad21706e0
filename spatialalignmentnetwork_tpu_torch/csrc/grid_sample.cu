// Bilinear grid sample, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_forward` / `_kernel` in
// spatialalignmentnetwork_tpu/ops/pallas/grid_sample.py (pallas_call at
// :222). That kernel rewrote the 4-tap gather as one-hot MXU contractions
// because the TPU has no fast vector gather; the GPU gathers natively, so
// this is the direct 4-tap form of ops/grid_sample.py:115-167.
//
// Semantics: align_corners=False; padding zeros / border / reflection
// (reflect about [-0.5, size-0.5], then clamp into [0, size-1]); the
// coordinate math is f32 whatever the image type. Image f32 or bf16, grid
// f32 [N, Ho, Wo, 2] (x first), output in the image type, accumulation in
// f32. Gather-only, so the result is deterministic.
//
// Every f32 operation of the coordinate and weight math uses the
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...), which nvcc never
// contracts into FMAs: a contracted ((g + 1) * W - 1) differs from the
// separately rounded plain version by up to one ulp of the pixel
// coordinate (3e-5 at 320), which is a visible error in the output.
//
// Design: one thread per output pixel (n, ho, wo), looping over C, so the
// grid is read once per pixel (one 8-byte load) and the four tap indices
// and weights are shared by every channel.
//
// Bound on the H100 SXM: memory. At the serving shape (batch 8,
// 1 x 320 x 320, f32) the function reads 3.3 MB of image and 6.6 MB of
// grid and writes 3.3 MB: about 13.1 MB, or about 3.9 us at 3.35 TB/s,
// against about 0.02 GFLOP of arithmetic. A faster version (vectorised
// grid loads, several pixels a thread, the source band staged in shared
// memory) is later work; this one is the simple and right first version.

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

// Reflect about the pixel-edge bounds [-0.5, size - 0.5], then clamp.
// The parity of the number of flips is read from fmod(t, 2 * size), which
// is exact, as in the plain version.
__device__ __forceinline__ float reflect(float x, int size) {
  const float low = -0.5f;
  const float span = (float)size;
  const float t = fabsf(__fsub_rn(x, low));
  const float m = fmodf(t, __fmul_rn(2.0f, span));  // exact; t >= 0
  const float out = m < span
                        ? __fadd_rn(m, low)
                        : __fadd_rn(__fsub_rn(span, __fsub_rn(m, span)), low);
  return clampf(out, 0.0f, span - 1.0f);
}

__device__ __forceinline__ float pad_coord(float x, int size, int mode) {
  if (mode == kReflection) return reflect(x, size);
  if (mode == kBorder) return clampf(x, 0.0f, (float)size - 1.0f);
  return x;
}

template <typename T>
__global__ void grid_sample_fwd_kernel(const T* __restrict__ img,
                                       const float2* __restrict__ grid,
                                       T* __restrict__ out, int n, int c,
                                       int h, int w, int ho, int wo,
                                       int mode) {
  const int64_t pixels = (int64_t)n * ho * wo;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const int64_t plane_out = (int64_t)ho * wo;
  const int64_t plane_in = (int64_t)h * w;
  const int64_t b = p / plane_out;
  const int64_t q = p - b * plane_out;  // ho * Wo + wo

  const float2 g = grid[p];
  const float ix = pad_coord(unnormalize(g.x, w), w, mode);
  const float iy = pad_coord(unnormalize(g.y, h), h, mode);

  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  const float wx = __fsub_rn(ix, x0);
  const float wy = __fsub_rn(iy, y0);

  // taps in the order (0,0), (1,0), (0,1), (1,1), as the plain version
  float tw[4];
  int64_t toff[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dx = t & 1;
    const int dy = t >> 1;
    const float xc = __fadd_rn(x0, (float)dx);
    const float yc = __fadd_rn(y0, (float)dy);
    float weight = __fmul_rn(dx ? wx : __fsub_rn(1.0f, wx),
                             dy ? wy : __fsub_rn(1.0f, wy));
    const bool valid = xc >= 0.0f && xc <= (float)(w - 1) && yc >= 0.0f &&
                       yc <= (float)(h - 1);
    if (mode == kZeros && !valid) weight = 0.0f;
    // border/reflection coordinates are already inside; the clamp only
    // keeps a zero-weight tap's address in bounds
    const int xi = (int)clampf(xc, 0.0f, (float)(w - 1));
    const int yi = (int)clampf(yc, 0.0f, (float)(h - 1));
    tw[t] = weight;
    toff[t] = (int64_t)yi * w + xi;
  }

  const T* src = img + b * c * plane_in;
  T* dst = out + b * c * plane_out + q;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float v = tw[t] == 0.0f ? 0.0f : load_as_float(src + toff[t]);
      acc = __fadd_rn(acc, __fmul_rn(v, tw[t]));
    }
    store_from_float(dst, acc);
    src += plane_in;
    dst += plane_out;
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
  const int64_t pixels = (int64_t)n * ho * wo;
  if (pixels == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pixels + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    grid_sample_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float2*)grid, (__nv_bfloat16*)out,
        n, c, h, w, ho, wo, padding_mode);
  } else {
    grid_sample_fwd_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)img, (const float2*)grid, (float*)out, n, c, h, w, ho,
        wo, padding_mode);
  }
  return (int)cudaGetLastError();
}
