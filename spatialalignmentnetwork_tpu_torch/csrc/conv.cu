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
// N = Cout, K = 9 Cin. Both types run on the tensor cores with warp-level
// mma.sync, one kernel a type on one scaffold.
//
// The scaffold:
//   * a block takes a TH x TW patch of output pixels (16x16, 8x16, 8x8 or
//     4x8, picked from the plane so that small planes still give the card
//     hundreds of blocks) and BN output channels (8, 16, 24, 40 or 72,
//     the least that covers Cout, 72 a tile beyond: Cout 18, 36, 72, 144
//     and 288 waste at most 25%). Each warp takes MI rows of 16 pixels by
//     NI columns of 8 channels (all BN, or a third of 72 on the small
//     planes) as 16x8 mma tiles in registers, so a B fragment feeds MI
//     mma and an A fragment NI;
//   * the K loop takes one staged pixel of input channels a step, 32
//     bytes: 16 bf16 or 8 f32, the K of the type's mma. It stages the
//     patch's input pixels with their one-pixel zero halo, (TH + 2) x
//     (TW + 2) pixels, and the [9, K, BN] slice of w taken straight from
//     HWIO, zero past Cin and Cout;
//   * all nine taps run from that one staged patch: a tap is an address
//     shift of the rows that ldmatrix reads (one row address a lane), so
//     there is no im2col copy and each staged input byte feeds nine MMAs.
//     A pixel's two 16-byte halves swap places every four pixels, so the
//     eight rows of an ldmatrix (eight neighbouring pixels) fall in eight
//     distinct bank groups at every shift; weight rows are padded so that
//     the B reads of a warp fall in distinct banks too;
//   * cp.async (through L1) fills a two-stage ring, so step c + 1 loads
//     while step c multiplies. The copy width is the widest that Cin (or
//     Cout) and the pointer allow: 16 bytes (bf16 Cin 72, 144, 288; f32
//     36 and up), 8, 4 or, for odd channel counts in bf16 (Cin 3), plain
//     2-byte loads of the valid channels into a zeroed pixel (f32 takes
//     4-byte copies there). A thread stages whole pixels (and, below
//     16-byte copies, whole weight rows), so it computes an address once
//     for all of a pixel's copies: at the 320 plane the issue of these
//     copies, not the bytes, set the time. Halo pixels and channels past
//     Cin are zero-filled by the copy itself;
//   * the epilogue rounds each f32 sum once (bf16) and stores NHWC, two
//     channels a store where Cout is even, masked at the ragged edge of
//     pixels and of Cout.
// Sum order: input channel step, ky, kx, then the mma's own sum. Neither
// wgmma nor TMA is used.
//
// f32: `conv3x3_tf32_kernel`, 3xTF32 on mma.sync.m16n8k8 (TF32 in, f32
// sums). Each f32 operand v is split into hi = tf32(v) and lo = tf32(v -
// hi), rounded to nearest with ties away from zero as cvt.rna.tf32.f32
// rounds (v - hi is exact), and a product is lo.hi + hi.lo + hi.hi: a
// product of two TF32 values is exact in f32, so what is lost is lo.lo
// and lo's own rounding, about 2^-21 of a product, and the sums.
// The tensor cores do not round an mma's f32 sum to nearest, and a
// running sum so added to a thousand times drifts: with the mma adding
// straight into it, the ladder's 40: 288->144 (K = 2592) landed 2.0e-5 of
// max from float64, twice the bar, on an NVIDIA H100 (variants timed
// with `conv_phases()`). So a K step's 27 mma (9 taps, 3 products, 8
// channels) sum into a fresh partial accumulator, and FADD (round to
// nearest) adds that into the running sum, as FFMA did: 6.2e-7 there, at
// 1% more time. The split is one pass of the
// whole block over a step's staged x patch and w slice, hi in place and
// lo beside it, between the copies' arrival and the mma: a staged word
// feeds 9 taps (x) or all MI tiles (w) of every warp, so splitting it
// where a warp loads it cost each warp three instructions a word a tap,
// and the issue of those, not the mma, set the time. A fragments:
// ldmatrix.x4 on the staged f32 pixels gives the m16n8k8 TF32 fragment as
// it stands (lane 4g + t gets word t of row g; matrices rows 0-7 and 8-15
// by k 0-3 and 4-7), hi and lo alike, and feeds 3 NI mma. B fragments (k
// = t and t + 4, n = g) are 32-bit shared loads from the HWIO [k][n] rows
// (ldmatrix.trans would split a 32-bit value), rows of a word count = 8
// (mod 32) so a warp's 32 loads hit 32 banks, and feed 3 MI mma. What
// bounds it on the H100 (batch 8, the VarNet's ladder; 3xTF32 does three
// TF32 products an f32 product, so operations count at 495 / 3 TFLOP/s):
// bytes where channels are few (the cascade's 320 plane up to 18 inputs,
// the sensitivity net's 320 and 160 planes: the 18->18 conv moves 118 MB,
// 35 us at 3.35 TB/s, for 4.78 GFLOP, 29 us of 3xTF32), operations
// everywhere else. The 72-channel tiles split their channels over three warps
// (NI = 3), which keeps the partial and running sums (2 x 4 MI NI
// registers) in registers. At 40 and 20 each pixel tile reads its [9, Cin,
// 72] weight slice from L2 again (746 KB at 288 inputs) and splits it for
// little mma work: there a tile takes the same pixels of two images where
// the grid stays large enough, which halves those re-reads and splits.
//
// bf16: `conv3x3_bf16_kernel`, mma.sync.m16n8k16 (bf16 in, f32 sums; 989
// TFLOP/s dense). B comes from the HWIO [k][n] rows by ldmatrix.trans,
// rows an odd number of 16-byte units. What bounds it: at the 320 and 160
// planes and at 80 with 36 inputs, bytes (the 18->18 conv moves 59 MB,
// 17.6 us at 3.35 TB/s, for 4.78 GFLOP, 4.8 us of tensor-core time); at 80
// with 72 or more inputs and at 40 and 20, operations (9.55 GFLOP, 9.7 us,
// for 288->144 at 40). With 18 inputs the second step is 2/16 full; at the
// 320 plane that costs tensor-core time the byte bound hides. The limits
// that the design's variants on the card point to are the issue of the
// staging copies (320, 160) and each pixel tile re-reading its 72-channel
// weight slice from L2 (40, 20: 373 KB a tile at 288 inputs), not the mma
// rate. TMA (a tile in one instruction, multicast across a cluster)
// answers both and is the next step; wgmma follows once the mma issue
// rate is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16_t;

constexpr int kPix = 32;  // bytes of a staged pixel: 16 bf16 or 8 f32 channels

// Input channels a K step (the mma's K: m16n8k16 bf16, m16n8k8 TF32).
template <typename T>
constexpr int kChan = kPix / (int)sizeof(T);

// Elements of a staged weight row of BN output channels. bf16: an odd
// number of 16-byte units, so the eight rows of an ldmatrix.trans fall in
// eight bank groups; f32: a word count = 8 (mod 32), so the B reads of a
// warp (rows t and t + 4 by columns g) fall in 32 banks.
template <typename T>
__host__ __device__ constexpr int row_stride(int bn) {
  return sizeof(T) == 2 ? bn + (((bn / 8) & 1) ? 0 : 8) : bn + (40 - bn % 32) % 32;
}

// Staged pixels of one image's TH x TW tile with its halo, rounded up to
// a multiple of 8 so that the patches of a multi-image f32 tile, laid end
// to end, all swizzle as swz() expects.
__host__ __device__ constexpr int patch_pixels(int th, int tw) {
  return ((th + 2) * (tw + 2) + 7) / 8 * 8;
}

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

// c += a b on m16n8k8 TF32 tiles with f32 sums. Fragments (PTX ISA):
// lane = 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// B (k = t, n = g), (k = t + 4, n = g), and C as for m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 word v rounded to TF32: 10 mantissa bits, ties away from zero
// (half the weight of the 13 dropped bits added to the magnitude, then the
// bits dropped). For finite v, the word cvt.rna.tf32.f32 gives, in two
// integer instructions.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t v) { return (v + 0x1000u) & 0xffffe000u; }

// The 3xTF32 split of v: hi = tf32(v), lo = tf32(v - hi); v - hi is exact.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi))));
}

// Split `bytes` (a multiple of 16) of staged f32 words in place, 16 bytes
// a thread at a time: hi where they lie, lo at the same offset in `lo`.
__device__ __forceinline__ void split_stage(char* st, char* lo, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    uint4 v = reinterpret_cast<uint4*>(st)[i], l;
    split_tf32(v.x, v.x, l.x);
    split_tf32(v.y, v.y, l.y);
    split_tf32(v.z, v.z, l.z);
    split_tf32(v.w, v.w, l.w);
    reinterpret_cast<uint4*>(st)[i] = v;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// Stage input channels c0 .. c0 + kChan - 1 of the patch's (TH + 2) x
// (TW + 2) pixels (rows y0-1 .., columns x0-1 ..), a pixel a thread, V
// channels a copy; zero outside the image and past Cin. V divides Cin, so
// a copy is all in or all out.
template <typename T, int V, int TH, int TW>
__device__ __forceinline__ void stage_x(char* xs, const T* xb, int h, int wd, int cin,
                                        int c0, int y0, int x0) {
  constexpr int kS = (int)sizeof(T);
  constexpr int kHW = TW + 2;
  for (int p = threadIdx.x; p < (TH + 2) * kHW; p += blockDim.x) {
    const int gy = y0 - 1 + p / kHW, gx = x0 - 1 + p % kHW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd;
    const T* src = in ? xb + ((int64_t)gy * wd + gx) * cin + c0 : xb;
    char* dst = xs + p * kPix;
    const int flip = ((p >> 2) & 1) << 4;  // swz(): the halves swap
    if constexpr (kS == 2 && V == 1) {
      // odd Cin in bf16: zero the pixel, then plain 2-byte loads of its channels
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
      const int valid = in ? min(kChan<T>, cin - c0) : 0;
      for (int j = 0; j < valid; ++j)
        *reinterpret_cast<T*>(dst + (((j >> 3) << 4) ^ flip) + (j & 7) * 2) = src[j];
    } else {
#pragma unroll
      for (int j = 0; j < kChan<T> / V; ++j) {
        const bool ok = in && c0 + j * V < cin;
        const int byte = j * V * kS;
        char* d = dst + (((byte >> 4) << 4) ^ flip) + (byte & 15);
        cp_async<kS * V>(smem_addr(d), src + (ok ? j * V : 0), ok);
      }
    }
  }
}

// Stage w[tap][c0 + k][n0 .. n0+BN-1] as rows (tap, k) of STRIDE
// elements, V channels a copy; zero past Cin and Cout. 16-byte copies go
// a piece a thread, so that a warp reads whole rows (the deep levels'
// weights are most of their traffic); narrower ones a row a thread, which
// computes the row's address once for its BN / V copies.
template <typename T, int V, int BN, int STRIDE>
__device__ __forceinline__ void stage_w(char* ws, const T* w, int cin, int cout,
                                        int c0, int n0) {
  constexpr int kS = (int)sizeof(T);
  constexpr int kK = kChan<T>;
  if constexpr (V * kS == 16) {
    constexpr int kPieces = BN / V;
    for (int e = threadIdx.x; e < 9 * kK * kPieces; e += blockDim.x) {
      const int j = e % kPieces, row = e / kPieces;
      const int c = c0 + row % kK, tap = row / kK;
      const bool ok = c < cin && n0 + j * V < cout;
      const T* src = ok ? w + ((int64_t)tap * cin + c) * cout + n0 + j * V : w;
      cp_async<16>(smem_addr(ws + (row * STRIDE + j * V) * kS), src, ok);
    }
  } else {
    for (int row = threadIdx.x; row < 9 * kK; row += blockDim.x) {
      const int c = c0 + row % kK, tap = row / kK;
      const bool in = c < cin;
      const T* src = in ? w + ((int64_t)tap * cin + c) * cout + n0 : w;
      char* dst = ws + row * STRIDE * kS;
      if constexpr (kS == 2 && V == 1) {
        // odd Cout in bf16: zero the row, then plain 2-byte loads of its channels
        for (int j = 0; j < BN / 8; ++j)
          reinterpret_cast<uint4*>(dst)[j] = make_uint4(0, 0, 0, 0);
        const int valid = in ? min(BN, cout - n0) : 0;
        for (int j = 0; j < valid; ++j) reinterpret_cast<T*>(dst)[j] = src[j];
      } else {
#pragma unroll
        for (int j = 0; j < BN / V; ++j) {
          const bool ok = in && n0 + j * V < cout;
          cp_async<kS * V>(smem_addr(dst + j * V * kS), src + (ok ? j * V : 0), ok);
        }
      }
    }
  }
}

// Both kernels: a TH x TW patch of output pixels by BN = 8 NI WN output
// channels, WM x WN warps; each warp takes MI = TH TW / (16 WM) rows of 16
// pixels by NI 8-channel columns of mma tiles. va, vb: channels a copy for
// x and w. (A minimum of one block an SM: with none, ptxas held the
// 72-channel tiles to 80-128 registers and spilled.)

// ------------------------------------------------------------------ bf16
// Fragment layouts are those of the PTX ISA for mma.m16n8k16 with .bf16 A
// (row) and B (col): lane = 4 g + t holds A rows g and g + 8 at k 2t,
// 2t + 1 (+ 8), B column g at k 2t, 2t + 1 (+ 8), and C rows g and g + 8
// at columns 2t, 2t + 1.
template <int TH, int TW, int WM, int WN, int NI>
__global__ void __launch_bounds__(32 * WM * WN, 1)
    conv3x3_bf16_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ w,
                        bf16_t* __restrict__ out, int h, int wd, int cin, int cout,
                        int tiles_y, int tiles_x, int va, int vb, int pairs) {
  constexpr int kTcK = kChan<bf16_t>;
  constexpr int kMI = TH * TW / (16 * WM);
  static_assert(kMI * 16 * WM == TH * TW, "pixel tile");
  constexpr int kBN = 8 * NI * WN;
  constexpr int kWS = row_stride<bf16_t>(kBN);
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
      case 8: stage_x<bf16_t, 8, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      case 4: stage_x<bf16_t, 4, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      case 2: stage_x<bf16_t, 2, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0); break;
      default: stage_x<bf16_t, 1, TH, TW>(xs, xb, h, wd, cin, c0, y0, x0);
    }
    switch (vb) {
      case 8: stage_w<bf16_t, 8, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      case 4: stage_w<bf16_t, 4, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      case 2: stage_w<bf16_t, 2, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      default: stage_w<bf16_t, 1, kBN, kWS>(ws, w, cin, cout, c0, n0);
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

// ------------------------------------------------------------------ f32
// 3xTF32 (see the note at the top): the bf16 kernel's tiles and staging,
// 8 channels a step, each product as three m16n8k8 TF32 mma. A step's
// staged words are split once, by the whole block, before its mma: hi in
// place, lo at the same offset in a third region of shared memory. A tile
// may take the same TH x TW pixels of NB images (one patch each, end to
// end), so that small planes share each staged weight slice among more
// pixels.
template <int NB, int TH, int TW, int WM, int WN, int NI>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN <= 6 ? 2 : 1)
    conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int n, int h, int wd, int cin, int cout,
                        int tiles_y, int tiles_x, int va, int vb, int pairs) {
  constexpr int kK = kChan<float>;
  constexpr int kMI = NB * TH * TW / (16 * WM);
  static_assert(kMI * 16 * WM == NB * TH * TW, "pixel tile");
  constexpr int kBN = 8 * NI * WN;
  constexpr int kWS = row_stride<float>(kBN);
  constexpr int kPP = patch_pixels(TH, TW);
  constexpr int kXBytes = NB * kPP * kPix;
  constexpr int kStage = kXBytes + 9 * kK * kWS * 4;
  extern __shared__ __align__(128) char smem[];
  char* lo = smem + 2 * kStage;  // the lo parts of the step being multiplied

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int b0 = tile / tiles_y * NB;
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * kBN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  // A as in the bf16 kernel: a pixel row and a 16-byte half (4 channels)
  // a lane for ldmatrix; pixel m of the tile is pixel m % (TH TW) of image
  // m / (TH TW)
  int pa[kMI];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
    const int m = (wm * kMI + mi) * 16 + (lane & 15), mm = m % (TH * TW);
    pa[mi] = m / (TH * TW) * kPP + (mm / TW) * (TW + 2) + mm % TW;
  }
  const int ahalf = lane >> 4;
  // B: this lane's word (k = t, n = g) of the warp's first 8-channel
  // column in a tap's rows; k = t + 4 is 4 rows on
  const int boff = t * kWS + wn * NI * 8 + g;

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
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // an image past N stages as zeros (a plane of height 0)
      const int b = min(b0 + j, n - 1), hj = b0 + j < n ? h : 0;
      const float* xb = x + (int64_t)b * h * wd * cin;
      char* xj = xs + j * kPP * kPix;
      switch (va) {
        case 4: stage_x<float, 4, TH, TW>(xj, xb, hj, wd, cin, c0, y0, x0); break;
        case 2: stage_x<float, 2, TH, TW>(xj, xb, hj, wd, cin, c0, y0, x0); break;
        default: stage_x<float, 1, TH, TW>(xj, xb, hj, wd, cin, c0, y0, x0);
      }
    }
    switch (vb) {
      case 4: stage_w<float, 4, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      case 2: stage_w<float, 2, kBN, kWS>(ws, w, cin, cout, c0, n0); break;
      default: stage_w<float, 1, kBN, kWS>(ws, w, cin, cout, c0, n0);
    }
    cp_async_commit();
  };

  const int chunks = (cin + kK - 1) / kK;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage((ch + 1) & 1, (ch + 1) * kK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    split_stage(smem + (ch & 1) * kStage, lo, kStage);
    __syncthreads();
    const uint32_t xs = smem_addr(smem + (ch & 1) * kStage);
    const uint32_t xl = smem_addr(lo);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(smem + (ch & 1) * kStage + kXBytes) + boff;
    const uint32_t* wl = reinterpret_cast<const uint32_t*>(lo + kXBytes) + boff;
    float part[kMI][NI][4];  // this step's sums, on the tensor cores
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.0f;
    // a row of taps at a time: unrolled over all nine, ptxas loaded the
    // fragments of taps ahead and held the 72-channel tiles to one block
    // an SM
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int shift = ky * (TW + 2) + kx;
        const int tap = (ky * 3 + kx) * kK * kWS;
        uint32_t b[2][NI][2];  // hi, lo
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          b[0][ni][0] = ws[tap + ni * 8];
          b[0][ni][1] = ws[tap + ni * 8 + 4 * kWS];
          b[1][ni][0] = wl[tap + ni * 8];
          b[1][ni][1] = wl[tap + ni * 8 + 4 * kWS];
        }
        uint32_t a[2][kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          ldsm_x4(a[0][mi], xs + swz(pa[mi] + shift, ahalf));
          ldsm_x4(a[1][mi], xl + swz(pa[mi] + shift, ahalf));
        }
        // lo.hi, hi.lo, hi.hi, each over all tiles before the next, so that
        // MI NI mma stand between two that add into one sum
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_tf32(part[mi][ni], a[p == 0][mi], b[p == 1][ni][0], b[p == 1][ni][1]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], part[mi][ni][r]);
    __syncthreads();  // this stage, and lo, are filled again
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (wm * kMI + mi) * 16 + g + 8 * r, mm = m % (TH * TW);
      const int b = b0 + m / (TH * TW), gy = y0 + mm / TW, gx = x0 + mm % TW;
      if (b >= n || gy >= h || gx >= wd) continue;
      float* op = out + (((int64_t)b * h + gy) * wd + gx) * cout;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int nn = n0 + (wn * NI + ni) * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * r], v1 = acc[mi][ni][2 * r + 1];
        if (pairs && nn + 1 < cout) {
          *reinterpret_cast<float2*>(op + nn) = make_float2(v0, v1);
        } else {
          if (nn < cout) op[nn] = v0;
          if (nn + 1 < cout) op[nn + 1] = v1;
        }
      }
    }
  }
}

// The widest copy (16, 8, 4 or, in bf16, 2 bytes) that `c` channels of T
// and the pointer's alignment allow, in channels.
template <typename T>
int copy_width(int c, const void* p) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2)
    if (c % v == 0 && (uintptr_t)p % (sizeof(T) * v) == 0) return v;
  return 1;
}

// The kernel of x's type (bf16: one image a tile).
template <int NB, int TH, int TW, int WM, int WN, int NI>
auto kernel_of(bf16_t*) {
  static_assert(NB == 1, "bf16 tiles take one image");
  return conv3x3_bf16_kernel<TH, TW, WM, WN, NI>;
}
template <int NB, int TH, int TW, int WM, int WN, int NI>
auto kernel_of(float*) { return conv3x3_tf32_kernel<NB, TH, TW, WM, WN, NI>; }

template <typename T, int TH, int TW, int WM, int WN, int NI, int NB = 1>
int launch(const void* x, const void* w, void* out, int n, int h, int wd, int cin,
           int cout, cudaStream_t s) {
  constexpr int kBN = 8 * NI * WN;
  // two stages (x patches and w slice); f32 adds a third for the lo parts
  constexpr int kWBytes = 9 * kChan<T> * row_stride<T>(kBN) * (int)sizeof(T);
  constexpr int kSmem = sizeof(T) == 2 ? 2 * ((TH + 2) * (TW + 2) * kPix + kWBytes)
                                       : 3 * (NB * patch_pixels(TH, TW) * kPix + kWBytes);
  auto kernel = kernel_of<NB, TH, TW, WM, WN, NI>((T*)nullptr);
  if (kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (h + TH - 1) / TH;
  const int tiles_x = (wd + TW - 1) / TW;
  const dim3 grid((unsigned)((int64_t)(n + NB - 1) / NB * tiles_y * tiles_x),
                  (unsigned)((cout + kBN - 1) / kBN));
  const int pairs = cout % 2 == 0 && (uintptr_t)out % (2 * sizeof(T)) == 0;
  const int va = copy_width<T>(cin, x), vb = copy_width<T>(cout, w);
  // f32 tiles of two images need the batch to drop the one past its end
  if constexpr (sizeof(T) == 2)
    kernel<<<grid, 32 * WM * WN, kSmem, s>>>((const T*)x, (const T*)w, (T*)out, h, wd,
                                              cin, cout, tiles_y, tiles_x, va, vb, pairs);
  else
    kernel<<<grid, 32 * WM * WN, kSmem, s>>>((const T*)x, (const T*)w, (T*)out, n, h,
                                              wd, cin, cout, tiles_y, tiles_x, va, vb,
                                              pairs);
  return (int)cudaGetLastError();
}

// The tile from the shape. Channels: the least of 8, 16, 24 and 40 that
// covers Cout, one warp across them, else tiles of 72 (launch_72). Pixels,
// up to 40 channels: on planes whose width is a multiple of 16 and at
// least 64 (320, 160, 80), 16x16 (8 warps), else 8x8 (4 warps).
template <typename T, int NI>
int launch_narrow(const void* x, const void* w, void* out, int n, int h, int wd,
                  int cin, int cout, bool wide, cudaStream_t s) {
  if (wide) return launch<T, 16, 16, 8, 1, NI>(x, w, out, n, h, wd, cin, cout, s);
  return launch<T, 8, 8, 4, 1, NI>(x, w, out, n, h, wd, cin, cout, s);
}

// 72-channel tiles, bf16: 8x16 (4 warps, each all 72 channels) on the wide
// planes, below that 8x8 (40: 25 tiles an image) and, below 40x40, 4x8 (20:
// 15 tiles an image at 83% use), where three warps split the 72 channels,
// so that the deep levels give the card hundreds of blocks of 6 warps.
template <typename T>
int launch_72(const void* x, const void* w, void* out, int n, int h, int wd, int cin,
              int cout, bool wide, cudaStream_t s) {
  if (wide) return launch<T, 8, 16, 4, 1, 9>(x, w, out, n, h, wd, cin, cout, s);
  if ((int64_t)h * wd >= 1600) return launch<T, 8, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
  return launch<T, 4, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
}

// f32: three warps split the 72 channels everywhere (the partial sums
// double the accumulators), 8x16 on the wide planes; at 40 and 20 a tile
// takes two images (NB = 2: 8x8 by 12 warps, 4x8 by 6) where the grid
// still gives the card some 8 warps an SM (1000 over its 132 SMs), else
// one, as bf16. NVIDIA H100 80GB HBM3 at 700 W, batch 8, ms (variants timed
// in one call with `conv_phases()`): cascade 20: 288->288 NB 2
// 0.149, NB 4 0.153, NB 1 0.220 (cuDNN f32 0.223); sensitivity 20: 128->128
// (120 blocks at NB 2) NB 1 0.0525, NB 2 0.0568; 40: 288->144 NB 2 0.276,
// NB 1 0.291.
template <>
int launch_72<float>(const void* x, const void* w, void* out, int n, int h, int wd,
                     int cin, int cout, bool wide, cudaStream_t s) {
  if (wide) return launch<float, 8, 16, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
  // image pairs by channel tiles: the NB = 2 grid a pixel tile
  const int64_t pair_tiles = (int64_t)(n + 1) / 2 * ((cout + 71) / 72);
  if ((int64_t)h * wd >= 1600) {
    if (pair_tiles * ((h + 7) / 8) * ((wd + 7) / 8) * 12 >= 1000)
      return launch<float, 8, 8, 4, 3, 3, 2>(x, w, out, n, h, wd, cin, cout, s);
    return launch<float, 8, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
  }
  if (pair_tiles * ((h + 3) / 4) * ((wd + 7) / 8) * 6 >= 1000)
    return launch<float, 4, 8, 2, 3, 3, 2>(x, w, out, n, h, wd, cin, cout, s);
  return launch<float, 4, 8, 2, 3, 3>(x, w, out, n, h, wd, cin, cout, s);
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int n, int h, int wd, int cin,
             int cout, cudaStream_t s) {
  const bool wide = wd % 16 == 0 && wd >= 64;
  if (cout <= 8) return launch_narrow<T, 1>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 16) return launch_narrow<T, 2>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 24) return launch_narrow<T, 3>(x, w, out, n, h, wd, cin, cout, wide, s);
  if (cout <= 40) return launch_narrow<T, 5>(x, w, out, n, h, wd, cin, cout, wide, s);
  return launch_72<T>(x, w, out, n, h, wd, cin, cout, wide, s);
}
}  // namespace

// Plain C entry point, loaded with ctypes. x [n, h, w, cin], w [3, 3, cin,
// cout], out [n, h, w, cout], contiguous, all f32 (bf16 = 0: the 3xTF32
// kernel) or all bf16 (bf16 = 1: the bf16 kernel); every element count
// under 2^31. Launches on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for a shape it does not take); neither
// synchronises nor allocates.
extern "C" int san_conv3x3(const void* x, const void* w, void* out, int n,
                           int h, int wd, int cin, int cout, int bf16,
                           void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return dispatch<bf16_t>(x, w, out, n, h, wd, cin, cout, s);
  return dispatch<float>(x, w, out, n, h, wd, cin, cout, s);
}
