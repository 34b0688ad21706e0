// 3x3 stride-1 SAME convolution, NHWC, no bias, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// spatialalignmentnetwork_tpu/ops/pallas/conv.py: `_conv3x3_s2d` (:98,
// pallas_call at :117, body `_conv2x2_valid_kernel` :67). Its custom VJP
// (:142-175) runs the same kernel for the input gradient, with the weights
// rotated 180 degrees and their channels swapped; kernels/conv.py does the
// same with this kernel.
//
// x [N, H, W, Cin] and w [3, 3, Cin, Cout] (HWIO), both f32 or both bf16;
// out [N, H, W, Cout] in the same type. Taps outside the image read zero
// (SAME padding). Products are summed in f32 in a fixed order (input
// channel chunk, channel, ky, kx) and rounded once at the end
// (`__float2bfloat16_rn` for bf16, as the TPU kernel's
// `acc.astype(o_ref.dtype)` at :85): no atomics, no split over blocks, so
// every run gives the same bits.
//
// The TPU kernel regroups 2x2 output pixels into channels (space-to-depth)
// so that a [M/4, 16 Cin] @ [16 Cin, 4 Cout] GEMM fills the MXU's 128
// lanes. That is a TPU lever (and 16/9 more multiply-adds); here the conv
// is an implicit GEMM on NHWC as it stands: M = N H W output pixels,
// N = Cout, K = 9 Cin.
//
// Bound on the H100 SXM in f32: operations, at all but the narrowest of
// the VarNet's convs. At the cascade's widest plane ([8, 320, 320, 18] ->
// 18) the function moves 118 MB (35 us at 3.35 TB/s) and does 4.78 GFLOP
// (71 us at 67 TFLOP/s f32 outside the tensor cores); the convs deeper in
// the ladder do more work per byte. So the design feeds the FMA units:
//   * a block takes a 16-wide tile of output pixels (8 or 16 rows) and a
//     tile of TN output channels (8, 16, 32 or 64, the least that covers
//     Cout, or 64 per tile beyond), 256 threads;
//   * per step it stages 8 input channels of the tile's input rows, with
//     their one-pixel zero halo, channel-major in shared memory, and the
//     matching [9, 8, TN] chunk of w, both converted to f32;
//   * each thread holds RM consecutive output pixels of one row and RN
//     output channels in registers (RM x RN f32 sums). For each (channel,
//     ky) it loads RM + 2 input values once and reuses them for the three
//     kx taps, so a thread does 3 RM RN FMAs per RM + 2 scalar and three
//     vector loads from shared memory.
// Channel counts that are not multiples of 8 (Cin) or of TN (Cout) are
// padded with zeros in shared memory and masked at the store; 2 and 3
// channels (the first conv of each U-Net and its input gradient) waste
// most of their small K. Static shared memory stays under 48 KB (at most
// 24 KB: 1440 + 4608 floats for the 64-channel tile), so no opt-in
// attribute is needed. bf16 runs the same f32 FFMA loop, so its ceiling
// is the same 67 TFLOP/s, where the tensor cores would give 989. wgmma,
// TMA and 3xTF32 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 8;   // input channels staged per step
constexpr int kTW = 16;  // output pixels per tile row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// RN consecutive f32 from shared memory (RN = 2 or 4, aligned to RN).
template <int RN>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (RN == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(RN == 2, "RN is 2 or 4");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// TN output channels a block, RN a thread; RM output pixels a thread, along
// one tile row.
template <typename T, int TN, int RN, int RM>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int h, int wd, int cin, int cout,
                   int tiles_y, int tiles_x) {
  constexpr int kCols = TN / RN;              // threads across channels
  constexpr int kRows = kThreads / kCols;     // threads across pixels
  constexpr int kGroups = kTW / RM;           // pixel groups a tile row
  constexpr int kTH = kRows / kGroups;        // tile rows
  constexpr int kHH = kTH + 2, kHW = kTW + 2;  // staged rows, columns
  static_assert(kRows % kGroups == 0, "tile shape");
  __shared__ __align__(16) float xs[kKC][kHH][kHW];
  __shared__ __align__(16) float ws[9][kKC][TN];

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int b = tile / tiles_y;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int n0 = blockIdx.y * TN;

  const int tid = threadIdx.x;
  const int col = tid % kCols;
  const int row = tid / kCols;
  const int py = row / kGroups;         // tile row of this thread's pixels
  const int px = (row % kGroups) * RM;  // first tile column

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  const T* xb = x + (int64_t)b * h * wd * cin;
  for (int c0 = 0; c0 < cin; c0 += kKC) {
    // input rows y0-1 .. y0+kTH, columns x0-1 .. x0+kTW, channels
    // c0 .. c0+7: channel fastest in device memory, zero outside
    for (int e = tid; e < kKC * kHH * kHW; e += kThreads) {
      const int c = e % kKC;
      const int p = e / kKC;
      const int hy = p / kHW, hx = p % kHW;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + c < cin)
        v = to_f32(xb[((int64_t)gy * wd + gx) * cin + c0 + c]);
      xs[c][hy][hx] = v;
    }
    // w[ky][kx][c0 + c][n0 + n], zero past Cin and Cout
    for (int e = tid; e < 9 * kKC * TN; e += kThreads) {
      const int n = e % TN;
      const int c = (e / TN) % kKC;
      const int tap = e / (TN * kKC);
      float v = 0.0f;
      if (c0 + c < cin && n0 + n < cout)
        v = to_f32(w[((int64_t)tap * cin + c0 + c) * cout + n0 + n]);
      ws[tap][c][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xr[RM + 2];
#pragma unroll
        for (int t = 0; t < RM + 2; ++t) xr[t] = xs[c][py + ky][px + t];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[RN];
          load_vec<RN>(&ws[ky * 3 + kx][c][col * RN], wv);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              acc[i][j] = fmaf(xr[i + kx], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // xs and ws are staged again for the next chunk
  }

  const int gy = y0 + py;
  if (gy >= h) return;
  T* ob = out + ((int64_t)b * h + gy) * wd * cout;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gx = x0 + px + i;
    if (gx >= wd) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + col * RN + j;
      if (n < cout) ob[(int64_t)gx * cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int TN, int RN, int RM>
int launch(const void* x, const void* w, void* out, int n, int h, int wd,
           int cin, int cout, cudaStream_t s) {
  constexpr int kCols = TN / RN;
  constexpr int kTH = (kThreads / kCols) / (kTW / RM);
  const int tiles_y = (h + kTH - 1) / kTH;
  const int tiles_x = (wd + kTW - 1) / kTW;
  const dim3 grid((unsigned)((int64_t)n * tiles_y * tiles_x),
                  (unsigned)((cout + TN - 1) / TN));
  conv3x3_kernel<T, TN, RN, RM><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)w, (T*)out, h, wd, cin, cout, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int n, int h, int wd,
             int cin, int cout, cudaStream_t s) {
  if (cout <= 8) return launch<T, 8, 2, 4>(x, w, out, n, h, wd, cin, cout, s);
  if (cout <= 16) return launch<T, 16, 4, 4>(x, w, out, n, h, wd, cin, cout, s);
  if (cout <= 32) return launch<T, 32, 4, 8>(x, w, out, n, h, wd, cin, cout, s);
  return launch<T, 64, 4, 8>(x, w, out, n, h, wd, cin, cout, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [n, h, w, cin], w [3, 3, cin,
// cout], out [n, h, w, cout], contiguous, all f32 (bf16 = 0) or all bf16
// (bf16 = 1); every element count under 2^31. Launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// shape it does not take); neither synchronises nor allocates.
extern "C" int san_conv3x3(const void* x, const void* w, void* out, int n,
                           int h, int wd, int cin, int cout, int bf16,
                           void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch<__nv_bfloat16>(x, w, out, n, h, wd, cin, cout, s);
  return dispatch<float>(x, w, out, n, h, wd, cin, cout, s);
}
