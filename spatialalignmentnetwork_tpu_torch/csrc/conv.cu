// 3x3 stride-1 SAME convolution, NHWC, no bias, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// spatialalignmentnetwork_tpu/ops/pallas/conv.py: `_conv3x3_s2d` (:98,
// pallas_call at :117, body `_conv2x2_valid_kernel` :67). Its custom VJP
// (:142-175) runs the same kernel for the input gradient, with the weights
// rotated 180 degrees and their channels swapped; kernels/conv.py does the
// same with the f32 kernel (the reference has no bf16 backward).
//
// x [N, H, W, Cin] and w [3, 3, Cin, Cout] (HWIO), both f32 or both bf16;
// out [N, H, W, Cout] in the same type. Taps outside the image read zero
// (SAME padding). Products are summed in f32 in a fixed order and rounded
// once at the end (`__float2bfloat16_rn` for bf16, as the TPU kernel's
// `acc.astype(o_ref.dtype)` at :85): no atomics, no split over blocks, so
// every run gives the same bits.
//
// The TPU kernel regroups 2x2 output pixels into channels (space-to-depth)
// so that a [M/4, 16 Cin] @ [16 Cin, 4 Cout] GEMM fills the MXU's 128
// lanes. That is a TPU lever (and 16/9 more multiply-adds); here the conv
// is an implicit GEMM on NHWC as it stands: M = N H W output pixels,
// N = Cout, K = 9 Cin. There are two kernels, one a type.
//
// f32: `conv3x3_kernel`, FFMA register tiles (67 TFLOP/s outside the
// tensor cores). At the cascade's widest plane ([8, 320, 320, 18] -> 18)
// the function moves 118 MB (35 us at 3.35 TB/s) and does 4.78 GFLOP
// (71 us at 67 TFLOP/s); the convs deeper in the ladder do more work per
// byte, so it is bound by operations. The design feeds the FMA units:
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
// padded with zeros in shared memory and masked at the store. Static
// shared memory stays under 48 KB (at most 24 KB). Sum order: input
// channel chunk, channel, ky, kx.
//
// bf16: `conv3x3_bf16_kernel`, on the tensor cores (989 TFLOP/s dense)
// with warp-level mma.sync.m16n8k16 (bf16 in, f32 sums). What bounds it
// on the H100, shape by shape (batch 8, the VarNet's ladder): at the 320
// and 160 planes and at 80 with 36 inputs, bytes (the 18->18 conv moves
// 59 MB, 17.6 us at 3.35 TB/s, for 4.78 GFLOP, 4.8 us of tensor-core
// time); at 80 with 72 or more inputs and at 40 and 20, operations
// (9.55 GFLOP, 9.7 us, for 288->144 at 40). The design:
//   * a block takes a TH x TW patch of output pixels (16x16, 8x16, 8x8 or
//     4x8, picked from the plane so that small planes still give the card
//     hundreds of blocks) and BN output channels (8, 16, 24, 40 or 72,
//     the least that covers Cout, 72 a tile beyond: Cout 18, 36, 72, 144
//     and 288 waste at most 25%). Each warp takes MI rows of 16 pixels by
//     NI columns of 8 channels (all BN, or a third of 72 on the small
//     planes) as 16x8 mma tiles in registers, so a B fragment feeds MI
//     mma and an A fragment NI;
//   * the K loop takes 16 input channels (the mma's K) a step. It stages
//     the patch's input pixels with their one-pixel zero halo, (TH + 2) x
//     (TW + 2) pixels of 32 bytes, and the [9, 16, BN] slice of w taken
//     straight from HWIO, zero past Cin and Cout;
//   * all nine taps run from that one staged patch: a tap is an address
//     shift of the rows that ldmatrix reads (one row address a lane), so
//     there is no im2col copy and each staged input byte feeds nine MMAs.
//     A pixel's two 16-byte halves swap places every four pixels, so the
//     eight rows of an ldmatrix (eight neighbouring pixels) fall in eight
//     distinct bank groups at every shift; weight rows are padded to an
//     odd number of 16-byte units for the same reason (ldmatrix.trans
//     gives the B fragments from the HWIO [k][n] layout);
//   * cp.async (through L1) fills a two-stage ring, so step c + 1 loads
//     while step c multiplies. The copy width is the widest that Cin (or
//     Cout) and the pointer allow: 16 bytes (Cin 72, 144, 288), 8 (36), 4
//     (18, 2) or, for odd channel counts (Cin 3), plain 2-byte loads of
//     the valid channels into a zeroed pixel. A thread stages whole pixels
//     (and, below 16-byte copies, whole weight rows), so it computes an
//     address once for all of a pixel's copies: at the 320 plane the
//     issue of these copies, not the bytes, set the time. Halo pixels and
//     channels past Cin are zero-filled by the copy itself;
//   * the epilogue rounds each f32 sum once and stores NHWC, two channels
//     a store where Cout is even, masked at the ragged edge of pixels and
//     of Cout.
// Sum order: input channel chunk, ky, kx, then the mma's own 16-term sum.
// With 18 inputs the second chunk is 2/16 full; at the 320 plane that
// costs tensor-core time the byte bound hides. Neither wgmma nor TMA is
// used. The limits that the design's variants on the card point to are
// the issue of the staging copies (320, 160) and each pixel tile
// re-reading its 72-channel weight slice from L2 (40, 20: 373 KB a tile
// at 288 inputs), not the mma rate. TMA (a tile in one instruction,
// multicast across a cluster) answers both and is the next step; wgmma
// follows once the mma issue rate is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 8;   // input channels staged per step
constexpr int kTW = 16;  // output pixels per tile row

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

// ------------------------------------------------------------------ bf16
// The tensor-core kernel (see the note at the top). Fragment layouts are
// those of the PTX ISA for mma.m16n8k16 with .bf16 A (row) and B (col):
// lane = 4 g + t holds A rows g and g + 8 at k 2t, 2t + 1 (+ 8), B column
// g at k 2t, 2t + 1 (+ 8), and C rows g and g + 8 at columns 2t, 2t + 1.

typedef __nv_bfloat16 bf16_t;

constexpr int kTcK = 16;   // input channels a step: the mma's K
constexpr int kPix = 32;   // bytes of a staged pixel (16 bf16)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of the 16-byte half `half` of staged pixel `p`: the halves
// swap every four pixels, so any eight consecutive pixels' same half lie
// in eight distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int p, int half) {
  return p * kPix + ((half ^ ((p >> 2) & 1)) << 4);
}

// Copy BYTES from global to shared memory, or zero-fill them (valid false:
// nothing is read). Through L1 (.ca): a thread's copies of one pixel or
// weight row share 32-byte sectors with its neighbours'.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage input channels c0 .. c0+15 of the patch's (TH + 2) x (TW + 2)
// pixels (rows y0-1 .., columns x0-1 ..), a pixel a thread, V channels a
// copy; zero outside the image and past Cin. V divides Cin, so a copy is
// all in or all out.
template <int V, int TH, int TW>
__device__ __forceinline__ void stage_x(char* xs, const bf16_t* xb, int h, int wd, int cin,
                                        int c0, int y0, int x0) {
  constexpr int kHW = TW + 2;
  for (int p = threadIdx.x; p < (TH + 2) * kHW; p += blockDim.x) {
    const int gy = y0 - 1 + p / kHW, gx = x0 - 1 + p % kHW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd;
    const bf16_t* src = in ? xb + ((int64_t)gy * wd + gx) * cin + c0 : xb;
    char* dst = xs + p * kPix;
    const int flip = ((p >> 2) & 1) << 4;  // swz(): the halves swap
    if constexpr (V == 1) {
      // odd Cin: zero the pixel, then plain 2-byte loads of its channels
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
      const int valid = in ? min(kTcK, cin - c0) : 0;
      for (int j = 0; j < valid; ++j)
        *reinterpret_cast<bf16_t*>(dst + (((j >> 3) << 4) ^ flip) + (j & 7) * 2) = src[j];
    } else {
#pragma unroll
      for (int j = 0; j < kTcK / V; ++j) {
        const bool ok = in && c0 + j * V < cin;
        char* d = dst + ((((j * V) >> 3) << 4) ^ flip) + ((j * V) & 7) * 2;
        cp_async<2 * V>(smem_addr(d), src + (ok ? j * V : 0), ok);
      }
    }
  }
}

// Stage w[tap][c0 + k][n0 .. n0+BN-1] as rows (tap, k) of STRIDE
// elements, V channels a copy; zero past Cin and Cout. 16-byte copies go
// a piece a thread, so that a warp reads whole rows (the deep levels'
// weights are most of their traffic); narrower ones a row a thread, which
// computes the row's address once for its BN / V copies.
template <int V, int BN, int STRIDE>
__device__ __forceinline__ void stage_w(char* ws, const bf16_t* w, int cin, int cout,
                                        int c0, int n0) {
  if constexpr (V == 8) {
    constexpr int kPieces = BN / V;
    for (int e = threadIdx.x; e < 9 * kTcK * kPieces; e += blockDim.x) {
      const int j = e % kPieces, row = e / kPieces;
      const int c = c0 + row % kTcK, tap = row / kTcK;
      const bool ok = c < cin && n0 + j * V < cout;
      const bf16_t* src = ok ? w + ((int64_t)tap * cin + c) * cout + n0 + j * V : w;
      cp_async<2 * V>(smem_addr(ws + (row * STRIDE + j * V) * 2), src, ok);
    }
  } else {
    for (int row = threadIdx.x; row < 9 * kTcK; row += blockDim.x) {
      const int c = c0 + row % kTcK, tap = row / kTcK;
      const bool in = c < cin;
      const bf16_t* src = in ? w + ((int64_t)tap * cin + c) * cout + n0 : w;
      char* dst = ws + row * STRIDE * 2;
      if constexpr (V == 1) {
        // odd Cout: zero the row, then plain 2-byte loads of its channels
        for (int j = 0; j < BN / 8; ++j)
          reinterpret_cast<uint4*>(dst)[j] = make_uint4(0, 0, 0, 0);
        const int valid = in ? min(BN, cout - n0) : 0;
        for (int j = 0; j < valid; ++j) reinterpret_cast<bf16_t*>(dst)[j] = src[j];
      } else {
#pragma unroll
        for (int j = 0; j < BN / V; ++j) {
          const bool ok = in && n0 + j * V < cout;
          cp_async<2 * V>(smem_addr(dst + j * V * 2), src + (ok ? j * V : 0), ok);
        }
      }
    }
  }
}

// A block: a TH x TW patch of output pixels by BN = 8 NI WN output
// channels, WM x WN warps; each warp takes MI = TH TW / (16 WM) rows of 16
// pixels by NI 8-channel columns of mma tiles, so a B fragment loaded once
// feeds MI mma and an A fragment NI. va, vb: channels a copy for x and w.
// (A minimum of one block an SM: with none, ptxas held the 72-channel
// tiles to 80-128 registers and spilled.)
template <int TH, int TW, int WM, int WN, int NI>
__global__ void __launch_bounds__(32 * WM * WN, 1)
    conv3x3_bf16_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ w,
                        bf16_t* __restrict__ out, int h, int wd, int cin, int cout,
                        int tiles_y, int tiles_x, int va, int vb, int pairs) {
  constexpr int kMI = TH * TW / (16 * WM);
  static_assert(kMI * 16 * WM == TH * TW, "pixel tile");
  constexpr int kBN = 8 * NI * WN;
  constexpr int kWS = kBN + (((kBN / 8) & 1) ? 0 : 8);  // odd 16-byte units a row
  constexpr int kXBytes = (TH + 2) * (TW + 2) * kPix;
  constexpr int kStage = kXBytes + 9 * kTcK * kWS * 2;
  extern __shared__ __align__(128) char smem[];

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int b = tile / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * kBN;
  const bf16_t* xb = x + (int64_t)b * h * wd * cin;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  // the staged pixel (at tap ky = kx = 0) whose row this lane hands to
  // ldmatrix for each of its MI A fragments, and which 16-byte half
  int pa[kMI];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
    const int m = (wm * kMI + mi) * 16 + (lane & 15);
    pa[mi] = (m / TW) * (TW + 2) + m % TW;
  }
  const int ahalf = lane >> 4;
  // B: the weight row (k) and first column this lane hands to ldmatrix
  const int bk = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int bcol = wn * NI * 8 + (lane >> 4) * 8;

  float acc[kMI][NI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  auto stage = [&](int s, int c0) {
    char* xs = smem + s * kStage;
    char* ws = xs + kXBytes;
    switch (va) {
      case 8: stage_x<8, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      case 4: stage_x<4, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      case 2: stage_x<2, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      default: stage_x<1, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0);
    }
    switch (vb) {
      case 8: stage_w<8, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      case 4: stage_w<4, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      case 2: stage_w<2, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      default: stage_w<1, kBN, kWS>(ws, w, cin, cout, c0, n0);
    }
    cp_async_commit();
  };

  const int chunks = (cin + kTcK - 1) / kTcK;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage((ch + 1) & 1, (ch + 1) * kTcK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t xs = smem_addr(smem + (ch & 1) * kStage);
    const uint32_t ws = xs + kXBytes;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int shift = ky * (TW + 2) + kx;
        const uint32_t wrow = ws + ((ky * 3 + kx) * kTcK + bk) * kWS * 2;
        uint32_t bfr[NI][2];
#pragma unroll
        for (int j = 0; j + 1 < NI; j += 2)
          ldsm_x4_t(bfr[j][0], bfr[j][1], bfr[j + 1][0], bfr[j + 1][1],
                    wrow + (bcol + j * 8) * 2);
        if constexpr (NI & 1)
          ldsm_x2_t(bfr[NI - 1][0], bfr[NI - 1][1], wrow + (wn + 1) * NI * 8 * 2 - 16);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          uint32_t afr[4];
          ldsm_x4(afr, xs + swz(pa[mi] + shift, ahalf));
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], afr, bfr[ni][0], bfr[ni][1]);
        }
      }
    }
    __syncthreads();  // this stage is filled again two steps on
  }

  const int g = lane >> 2, t = lane & 3;
  bf16_t* ob = out + (int64_t)b * h * wd * cout;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (wm * kMI + mi) * 16 + g + 8 * r;
      const int gy = y0 + m / TW, gx = x0 + m % TW;
      if (gy >= h || gx >= wd) continue;
      bf16_t* op = ob + ((int64_t)gy * wd + gx) * cout;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int nn = n0 + (wn * NI + ni) * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * r], v1 = acc[mi][ni][2 * r + 1];
        if (pairs && nn + 1 < cout) {
          *reinterpret_cast<__nv_bfloat162*>(op + nn) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (nn < cout) op[nn] = __float2bfloat16_rn(v0);
          if (nn + 1 < cout) op[nn + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// The widest copy (8, 4, 2 or 1 bf16) that `c` channels and the pointer's
// alignment allow.
int copy_width(int c, const void* p) {
  for (int v = 8; v > 1; v /= 2)
    if (c % v == 0 && (uintptr_t)p % (2 * v) == 0) return v;
  return 1;
}

template <int TH, int TW, int WM, int WN, int NI>
int launch_bf16(const void* x, const void* w, void* out, int n, int h, int wd,
                int cin, int cout, cudaStream_t s) {
  constexpr int kBN = 8 * NI * WN;
  constexpr int kWS = kBN + (((kBN / 8) & 1) ? 0 : 8);
  constexpr int kSmem = 2 * ((TH + 2) * (TW + 2) * kPix + 9 * kTcK * kWS * 2);
  auto kernel = conv3x3_bf16_kernel<TH, TW, WM, WN, NI>;
  if (kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (h + TH - 1) / TH;
  const int tiles_x = (wd + TW - 1) / TW;
  const dim3 grid((unsigned)((int64_t)n * tiles_y * tiles_x),
                  (unsigned)((cout + kBN - 1) / kBN));
  const int pairs = cout % 2 == 0 && (uintptr_t)out % 4 == 0;
  kernel<<<grid, 32 * WM * WN, kSmem, s>>>(
      (const bf16_t*)x, (const bf16_t*)w, (bf16_t*)out, h, wd, cin, cout,
      tiles_y, tiles_x, copy_width(cin, x), copy_width(cout, w), pairs);
  return (int)cudaGetLastError();
}

// The tile from the shape. Channels: the least of 8, 16, 24 and 40 that
// covers Cout, one warp across them, else tiles of 72. Pixels: on planes
// whose width is a multiple of 16 and at least 64 (320, 160, 80), 16x16
// (8 warps) up to 40 channels and 8x16 (4 warps, each all 72 channels);
// below that 8x8 (40: 25 tiles an image) and, with 72 channels below
// 40x40, 4x8 (20: 15 tiles an image at 83% use), where three warps split
// the 72 channels, so that the deep levels give the card hundreds of
// blocks of 6 warps.
template <int NI>
int launch_narrow(const void* x, const void* w, void* out, int n, int h, int wd,
                  int cin, int cout, bool wide, cudaStream_t s) {
  if (wide) return launch_bf16<16, 16, 8, 1, NI>(x, w, out, n, h, wd, cin, cout, s);
  return launch_bf16<8, 8, 4, 1, NI>(x, w, out, n, h, wd, cin, cout, s);
}

int dispatch_bf16(const void* x, const void* w, void* out, int n, int h, int wd,
                  int cin, int cout, cudaStream_t s) {
  const bool wide = wd % 16 == 0 && wd >= 64;
  if (cout <= 8) return launch_narrow<1>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 16) return launch_narrow<2>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 24) return launch_narrow<3>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 40) return launch_narrow<5>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (wide) return launch_bf16<8, 16, 4, 1, 9>(x, w, out, n, h, wd, cin, cout, s);
  if ((int64_t)h * wd >= 1600)
    return launch_bf16<8, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
  return launch_bf16<4, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
}
}  // namespace

// Plain C entry point, loaded with ctypes. x [n, h, w, cin], w [3, 3, cin,
// cout], out [n, h, w, cout], contiguous, all f32 (bf16 = 0: the FFMA
// kernel) or all bf16 (bf16 = 1: the tensor-core kernel); every element
// count under 2^31. Launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// shape it does not take); neither synchronises nor allocates.
extern "C" int san_conv3x3(const void* x, const void* w, void* out, int n,
                           int h, int wd, int cin, int cout, int bf16,
                           void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch_bf16(x, w, out, n, h, wd, cin, cout, s);
  return dispatch<float>(x, w, out, n, h, wd, cin, cout, s);
}
