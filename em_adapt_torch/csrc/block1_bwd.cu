// Fused VGG block 1 backward (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel em_adapt_tpu/ops/block1_pallas.py::_bwd_kernel
// (launched from _bwd_rule, block1_pallas.py:562). For the block
//   y1 = bf16(relu(conv3x3_same(x, w1) + b1))      3 -> 64 channels
//   y2 = bf16(relu(conv3x3_same(y1, w2) + b2))     64 -> 64 channels
//   out = maxpool3x3_stride2_same(y2)
// and the pooled gradient dy, it returns the weight gradients (dx is zero
// by contract: block 1 is the model's first layer):
//   dz2 = [y2 > 0] * route(dy)   each pooled gradient goes to the first
//                                row-major window maximum; a y2 position
//                                sums its windows' gradients in bf16, one
//                                rounding per window, in window-internal
//                                (u, v) order (block1_pallas.py:326-343)
//   dW2 = sum_p y1(p + tap) dz2(p)      db2 = sum_p dz2(p)       (f32)
//   dy1 = conv_transpose(dz2, w2)  (f32)  dz1 = [y1 > 0] * dy1
//   db1 = sum_q dz1(q) (f32)      dW1 = sum_q x(q + tap) bf16(dz1(q))
// Products take bf16 operands and sum in f32. y1 and y2 are recomputed
// exactly as K2 computes them (csrc/block1_fwd.cu), so the routing sees
// K2's own pooled maxima.
//
// Layout: x [B, 3, H, W] bf16 and dy [B, 64, OH, OW] bf16 (NCHW); w1
// [64, 3, 3, 3] and w2 [64, 64, 3, 3] bf16 (OIHW); b1, b2 [64] f32. Out:
// dw1 [64, 3, 3, 3], db1 [64], dw2 [64, 64, 3, 3], db2 [64], all f32.
//
// Design. Persistent CTAs of 16 warps, one per SM, walk over tiles of
// 5 x 6 pooled positions of one image. A tile OWNS the y2 positions and
// the y1 positions of global rows [2P0-1, 2P0+9) and columns [2Q0-1,
// 2Q0+11): every position of the image belongs to exactly one tile. To
// get the complete dy1 at its own y1 positions it needs dz2 on a ring of
// one more (12 x 14), and so the 7 x 8 pooled windows that cover that
// ring: their y2 is a 15 x 17 region, their y1 17 x 19 and x 19 x 21 --
// the tile geometry of K2, whose recompute code this reuses. Per tile:
//   1. conv1_1 (SIMT f32 FMA), conv1_2 (mma.sync m16n8k16 bf16, M = 255
//      y2 positions, N = 64, K = 576), as K2, from the x tile that the
//      previous tile staged.
//   2. Per window and channel: the max and its first match.
//   3. dz2 on the 12 x 14 grid, four channels of one position a thread,
//      from the windows' dy that the previous tile staged; db2's partial
//      sums over the owned 10 x 12 part.
//   4. dW2 (M = 576 (tap, cin), N = 64, K = 120 owned positions) with
//      ldmatrix.trans fragments of y1 and dz2, tap by tap, each tap's sums
//      sent to the CTA's partial row as soon as they are complete; dy1
//      (M = 120 owned y1 positions, N = 64, K = 576) with w2 read
//      transposed (ldmatrix.trans on the same w2 tile); its epilogue masks
//      by y1 > 0, sums db1 in f32 and rounds dz1 to bf16.
//   5. dW1 (M = 27 -> 32, N = 64, K = 120) from x and dz1.
// Blocks run in no order, so each CTA sums its tiles' dW/db into its own
// row of an f32 `partials` buffer [CTAs, 38720], and a second kernel sums
// the rows in row order and writes the OIHW gradients.
//
// No wait on device memory inside the tile loop. A CTA is the SM's only
// one and its phases are separated by __syncthreads, so a load that all
// 16 warps wait on idles the whole SM. Three such round trips are gone:
//   - The partial row's read-add-write. The first tile stores its sums;
//     each later tile issues fire-and-forget reductions (red.global.add,
//     sm_90) with no load, and the warp goes straight on. The dW2 part is
//     thread-major, ((warp * 9 + tap) * 2 + j) * 128 + lane * 4 + e for the
//     mma sums acc[tap][j][e], so a thread's four sums are 16 contiguous
//     bytes (red.global.add.v4.f32) and a warp's 512; dw1's pairs take .v2,
//     db1 and db2 scalar reductions. Each address has one writer thread,
//     and the PTX memory model orders one thread's writes to one location
//     in program order: the adds land in tile order, the f32 sums of the
//     read-add-write, and two runs give the same bits. red.add.f32 flushes
//     subnormal inputs and results to zero (its SASS for sm_90a is
//     REDG.E.ADD.F32*.FTZ; chip_smoke.py counts them), where a plain add
//     keeps them: a tile sum or a running sum below 2^-126 would differ
//     from the read-add-write's. The checked cases' sums are far above that
//     and give the read-add-write's bits (PERF.md).
//   - The x staging and the dy gather at the top of each phase that needs
//     them. The next tile's x (at most 3 two-byte loads a thread) and the
//     dy of its windows (7) are loaded into registers at the start of a
//     tile, before conv1_1, and written after it into the second of two xs
//     and wdy buffers: conv1_1's microseconds hide their latency, and
//     conv1_2's and dW2's register peaks do not carry them. TMA cannot take
//     these tensors (its strides are multiples of 16 B; x's rows are 642 B
//     apart at 321^2, dy's 322 B), nor cp.async (4 B at least; a row of odd
//     width starts at an odd element). A CTA's first tile loads its own
//     before the loop; its last loads nothing.
// dW2 runs tap by tap so that its 18 reductions a warp go out while the
// product runs, not in one burst at its end, and so that only 8 of its 72
// sums are live at once; all ten builds stay at 128 registers or fewer
// with no spills.
//
// What bounds it: operations. 141 GFLOP at B = 6, 321^2 with the
// recompute (93 without) take 0.14 ms at the 989 TFLOP/s dense bf16 peak;
// x and dy are 23.6 MB, 0.007 ms; the partial rows take 0.83 GB of
// stores and reductions in L2 (155 KB a tile). What is left: K3
// recomputes 255 y2 positions per 120 it owns (a tile of K2's size, held
// to it by the 227 KB of shared memory), runs conv1_1 on the FMA units and
// the products on mma.sync rather than wgmma, runs its phases one after
// another inside a CTA, and still issues the partial row's reductions
// through the SM's load/store path. On an NVIDIA H100 80GB HBM3 at 700 W it takes 1.377 ms
// at B = 6, against 1.709 for the version with the read-add-write and the
// waits, and 1.538 for the cuDNN chain's backward (PERF.md).
//
// No fast-math: flush-to-zero would change small values before rounding.
//
// Per-part builds (em_adapt_torch/tools/bench_block1_bwd_parts.py, the
// counterpart of the probe tools/bench_block1_bwd_parts.py). Each macro
// switches one part off at compile time; with none defined this file is
// the production K3. What a variant then computes is stated beside its
// #if and held against a plain version, except K3_SKIP_UPDATE's:
//   K3_SKIP_FM         no max or first-match search: every window routes to
//                      its position (0, 0)
//   K3_SKIP_POOL       no windows, no routing, dy neither fetched nor read:
//                      dz2 := y2
//   K3_SKIP_CONV2      no conv1_2 product in the recompute: y2 := y1
//   K3_SKIP_DW2        no dW2 product (its reductions add zeros)
//   K3_SKIP_DY1        no dy1 product: dz1 = 0
//   K3_SKIP_DW1        no dW1 product (its reductions add zeros)
//   K3_SKIP_UPDATE     only each CTA's first tile stores into its partial
//                      row; later tiles issue no reductions (timing only:
//                      the result depends on the tile-to-CTA map)
//   K3_RECOMPUTE_ONLY  y1 and y2 only (dy not fetched): db1 := sum of the
//                      owned y1, db2 := sum of the owned y2, dw1 = dw2 = 0

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kF = 64;
constexpr int kCin = 3;
constexpr int kTP = 5;             // pooled rows per tile
constexpr int kTQ = 6;             // pooled cols per tile
constexpr int kY2H = 2 * kTP + 5;  // 15: y2 under the 7 x 8 windows
constexpr int kY2W = 2 * kTQ + 5;  // 17
constexpr int kY1H = kY2H + 2;     // 17
constexpr int kY1W = kY2W + 2;     // 19
constexpr int kXH = kY1H + 2;      // 19
constexpr int kXW = kY1W + 2;      // 21
constexpr int kM = kY2H * kY2W;    // 255
constexpr int kMTiles = (kM + 15) / 16;
constexpr int kNY1 = kY1H * kY1W;  // 323
constexpr int kK2 = 9 * kF;        // 576
constexpr int kRow = 72;           // bf16 per activation row in shared memory
constexpr int kW2Row = kK2 + 8;    // bf16 per w2 row in shared memory
constexpr int kWinH = kTP + 2;     // 7 windows down
constexpr int kWinW = kTQ + 2;     // 8 windows across
constexpr int kWin = kWinH * kWinW;
constexpr int kWdyRow = kF + 4;    // bf16 per window of dy in shared memory (bank spread)
constexpr int kDzH = 2 * kTP + 2;  // 12: the dz2 grid, owned positions and a ring
constexpr int kDzW = 2 * kTQ + 2;  // 14
constexpr int kNDz = kDzH * kDzW;  // 168
constexpr int kOwnW = 2 * kTQ;     // 12
constexpr int kOwn = 2 * kTP * kOwnW;  // 120 owned positions
constexpr int kOwnPad = 128;       // owned positions rounded up to 16

constexpr int kXN = kCin * kXH * kXW;                      // 1197 x values a tile
constexpr int kXPerThread = (kXN + kThreads - 1) / kThreads;  // 3
constexpr int kDyPerThread = kWin * kF / kThreads;          // 7
#if !defined(K3_SKIP_POOL) && !defined(K3_RECOMPUTE_ONLY)
#define K3_READS_DY 1
#endif

// Rows of `partials`: dw1 [(u, v, c)][n], db1, dw2 thread-major (see
// dw2_slot), db2.
constexpr int kDw1Off = 0;
constexpr int kDb1Off = kDw1Off + 27 * kF;
constexpr int kDw2Off = kDb1Off + kF;
constexpr int kDb2Off = kDw2Off + kK2 * kF;
constexpr int kPartFloats = kDb2Off + kF;  // 38720

static_assert(kMTiles == 2 * (kThreads / 32 / 2), "16 warps: 8 M-tile pairs x 2 N halves");
static_assert(kNDz % 2 == 0 && (kNDz / 2 / kDzW) % 2 == 0, "dz2: halves of even rows");
static_assert(kOwnPad / 16 * 2 == kThreads / 32, "dy1: 8 M tiles x 2 N halves");
static_assert(kOwnPad * kRow <= kMTiles * 16 * kRow, "dz1 fits where y2 was");
static_assert(kWin * kF % kThreads == 0, "dy: the same count of loads in every thread");
static_assert(kDw2Off % 4 == 0 && kPartFloats % 4 == 0, "dW2 slots 16-byte aligned");

constexpr size_t kW2Bytes = sizeof(__nv_bfloat16) * kF * kW2Row;
constexpr size_t kY1Bytes = sizeof(__nv_bfloat16) * kNY1 * kRow;
constexpr size_t kY2Bytes = sizeof(__nv_bfloat16) * kMTiles * 16 * kRow;
constexpr size_t kDz2Bytes = sizeof(__nv_bfloat16) * (kNDz + 1) * kRow;  // + one zero row
constexpr size_t kW1Bytes = sizeof(float) * 27 * kF;
constexpr size_t kBiasBytes = sizeof(float) * 2 * kF;
constexpr size_t kRedBytes = sizeof(float) * (8 + kThreads / 32) * kF;
constexpr size_t kXBytes = sizeof(float) * kXN;                     // one of two buffers
constexpr size_t kWdyBytes = sizeof(__nv_bfloat16) * kWin * kWdyRow;  // one of two buffers
constexpr size_t kWfirstBytes = kWin * kF;
constexpr size_t kSmemBytes = kW2Bytes + kY1Bytes + kY2Bytes + kDz2Bytes + kW1Bytes +
                              kBiasBytes + kRedBytes + 2 * kWdyBytes + kWfirstBytes +
                              2 * kXBytes;  // 224,424
static_assert((kW2Bytes + kY1Bytes + kY2Bytes + kDz2Bytes) % 16 == 0, "w1s 16-byte aligned");
static_assert((kW1Bytes + kBiasBytes + kRedBytes) % 8 == 0 && kWdyRow % 4 == 0,
              "wdy rows 8-byte aligned");
static_assert(kWdyBytes % 8 == 0 && kWfirstBytes % 4 == 0,
              "the second wdy 8-byte, wfirst and xs 4-byte aligned");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, each transposed: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives its (row 2*(lane%4) and +1,
// column lane/4) elements.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// max(a, b) that propagates NaN, as jnp.maximum and the plain version's
// ReLU do (fmaxf returns the other operand): K2's helper
// (csrc/block1_fwd.cu). On numbers, +0 and -0 included, it is max.f32.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

#if defined(K3_SKIP_DW2) || defined(K3_SKIP_DY1) || defined(K3_SKIP_DW1)
// A switched-off product leaves its sums 0 in registers the compiler
// cannot see through, so the code after it stays the production code.
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }
#endif

// Stores the tile's sum into the CTA's row (the first tile) or adds it
// there with a fire-and-forget reduction: no result, no wait. On sm_90
// red.add.f32 flushes subnormal inputs and results to zero (see above).
__device__ __forceinline__ void accumulate(float* p, float v, bool first) {
  if (first) {
    *p = v;
#if !defined(K3_SKIP_UPDATE)
  } else {
    asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(__cvta_generic_to_global(p)), "f"(v));
#endif
  }
}

__device__ __forceinline__ void accumulate2(float* p, float lo, float hi, bool first) {
  if (first) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
#if !defined(K3_SKIP_UPDATE)
  } else {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(__cvta_generic_to_global(p)),
                 "f"(lo), "f"(hi));
#endif
  }
}

__device__ __forceinline__ void accumulate4(float* p, const float* v, bool first) {
  if (first) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#if !defined(K3_SKIP_UPDATE)
  } else {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                     __cvta_generic_to_global(p)),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));
#endif
  }
}

// The four dW2 sums acc[tap][j][0..3] of a warp's lane in a partial row:
// thread-major, 16 contiguous bytes a lane, 512 a warp.
__device__ __forceinline__ int dw2_slot(int warp, int tap, int j, int lane) {
  return kDw2Off + ((warp * 9 + tap) * 2 + j) * 128 + lane * 4;
}

// A 16-bit load into a register (bf16 bits), 0 where `in` is false; asm
// volatile keeps it where it is written, ahead of the work that hides it.
__device__ __forceinline__ unsigned short ldg_u16(const __nv_bfloat16* p, bool in) {
  unsigned short v = 0;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "+h"(v)
      : "l"(__cvta_generic_to_global(p)), "r"(static_cast<int>(in)));
  return v;
}

// A tile's origin: its image and first pooled row and column.
struct Origin {
  int b, P0, Q0;
};

__device__ __forceinline__ Origin origin(int tile, int tiles_h, int tiles_w) {
  const int rem = tile % (tiles_h * tiles_w);
  return {tile / (tiles_h * tiles_w), (rem / tiles_w) * kTP, (rem % tiles_w) * kTQ};
}

// A tile's x (19 x 21 per channel from global row 2P0 - 5, column
// 2Q0 - 5) and its windows' dy (pooled (P0 - 1 + wp, Q0 - 1 + wq)), 0
// outside the image, as bf16 bits in registers: this thread's elements
// i = tid + k * kThreads.
__device__ __forceinline__ void fetch_x(unsigned short (&r)[kXPerThread],
                                        const __nv_bfloat16* x, Origin o, int H, int W,
                                        int tid) {
  const __nv_bfloat16* xb = x + static_cast<size_t>(o.b) * kCin * H * W;
  const int xr0 = 2 * o.P0 - 5, xc0 = 2 * o.Q0 - 5;
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int c = i / (kXH * kXW), row = (i / kXW) % kXH, col = i % kXW;
    const int R = xr0 + row, C = xc0 + col;
    r[k] = ldg_u16(xb + (static_cast<size_t>(c) * H + R) * W + C,
                   i < kXN && R >= 0 && R < H && C >= 0 && C < W);
  }
}

__device__ __forceinline__ void fetch_dy(unsigned short (&r)[kDyPerThread],
                                         const __nv_bfloat16* dy, Origin o, int H, int W,
                                         int tid) {
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const __nv_bfloat16* dyb = dy + static_cast<size_t>(o.b) * kF * OH * OW;
#pragma unroll
  for (int k = 0; k < kDyPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int w = i % kWin, ch = i / kWin;
    const int P = o.P0 - 1 + w / kWinW, Q = o.Q0 - 1 + w % kWinW;
    r[k] = ldg_u16(dyb + (static_cast<size_t>(ch) * OH + P) * OW + Q,
                   P >= 0 && P < OH && Q >= 0 && Q < OW);
  }
}

// Writes what fetch_x and fetch_dy loaded into a tile's xs (f32) and wdy
// buffers; dy with neighbouring threads on neighbouring windows, whose
// padded rows keep the stores off each other's banks.
__device__ __forceinline__ void stage_x(const unsigned short (&r)[kXPerThread], float* xs,
                                        int tid) {
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int i = tid + k * kThreads;
    if (i < kXN) xs[i] = __uint_as_float(static_cast<uint32_t>(r[k]) << 16);
  }
}

__device__ __forceinline__ void stage_dy(const unsigned short (&r)[kDyPerThread],
                                         __nv_bfloat16* wdy, int tid) {
#pragma unroll
  for (int k = 0; k < kDyPerThread; ++k) {
    const int i = tid + k * kThreads;
    wdy[(i % kWin) * kWdyRow + i / kWin] = __ushort_as_bfloat16(r[k]);
  }
}

// Word offset (uint32 = 2 bf16) of the y1 row under y2 position m, tap (0, 0).
__device__ __forceinline__ int y1_row_words(int m) {
  m = m < kM ? m : kM - 1;  // the pad row reads a valid position; discarded
  return ((m / kY2W) * kY1W + m % kY2W) * (kRow / 2);
}

__global__ void __launch_bounds__(kThreads, 1)
block1_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ partials, int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sp = smem;
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(sp);
  sp += kW2Bytes;
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(sp);
  sp += kY1Bytes;
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(sp);  // later dz1 [kOwnPad][kRow]
  sp += kY2Bytes;
  __nv_bfloat16* dz2s = reinterpret_cast<__nv_bfloat16*>(sp);  // [kNDz + 1][kRow]
  sp += kDz2Bytes;
  float* w1s = reinterpret_cast<float*>(sp);  // [27][64], k = (u * 3 + v) * 3 + c
  sp += kW1Bytes;
  float* b1s = reinterpret_cast<float*>(sp);
  float* b2s = b1s + kF;
  sp += kBiasBytes;
  float* red1 = reinterpret_cast<float*>(sp);  // [8][64] db1 partials of the 8 M tiles
  float* red2 = red1 + 8 * kF;                 // [16][64] db2 partials of the 16 warps
  sp += kRedBytes;
  // Two buffers each of the windows' dy ([window][kWdyRow], 8-byte rows)
  // and of the x tile: one for this tile, one filled for the next.
  __nv_bfloat16* wdy2 = reinterpret_cast<__nv_bfloat16*>(sp);
  sp += 2 * kWdyBytes;
  unsigned char* wfirst = sp;  // [window][64], 0..8
  sp += kWfirstBytes;
  float* xs2 = reinterpret_cast<float*>(sp);
  __nv_bfloat16* dz1s = y2s;

  const int tid = threadIdx.x;
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int tiles_h = (OH + kTP - 1) / kTP, tiles_w = (OW + kTQ - 1) / kTQ;
  const int tiles = B * tiles_h * tiles_w;
  float* part = partials + static_cast<size_t>(blockIdx.x) * kPartFloats;

  // The first tile's x and dy, staged into buffer 0 below.
  unsigned short x0[kXPerThread], dy0[kDyPerThread];
  fetch_x(x0, x, origin(blockIdx.x, tiles_h, tiles_w), H, W, tid);
#if defined(K3_READS_DY)
  fetch_dy(dy0, dy, origin(blockIdx.x, tiles_h, tiles_w), H, W, tid);
#endif

  // Weights once per CTA, as K2. w2 OIHW [n][cin][u][v] -> w2s[n][(u*3+v)*64 + cin].
  for (int i = tid; i < kF * kK2; i += kThreads) {
    const int n = i / kK2, cin = (i / 9) % kF, tap = i % 9;
    w2s[n * kW2Row + tap * kF + cin] = w2[i];
  }
  for (int i = tid; i < 27 * kF; i += kThreads) {
    const int n = i / 27, c = (i / 9) % kCin, tap = i % 9;
    w1s[(tap * kCin + c) * kF + n] = __bfloat162float(w1[i]);
  }
  for (int i = tid; i < kF; i += kThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  for (int i = tid; i < kRow; i += kThreads) dz2s[kNDz * kRow + i] = __float2bfloat16_rn(0.f);
  stage_x(x0, xs2, tid);
#if defined(K3_READS_DY)
  stage_dy(dy0, wdy2, tid);
#endif
#if defined(K3_SKIP_FM)
  for (int i = tid; i < kWin * kF; i += kThreads) wfirst[i] = 0;  // window position (0, 0)
#endif
#if defined(K3_RECOMPUTE_ONLY)
  for (int i = tid; i < kPartFloats; i += kThreads) part[i] = 0.f;  // dw1 = dw2 = 0
#endif

  const uint32_t* y1w = reinterpret_cast<const uint32_t*>(y1s);
  const uint32_t* w2w = reinterpret_cast<const uint32_t*>(w2s);
  uint32_t* y2w = reinterpret_cast<uint32_t*>(y2s);
  const uint32_t* dzw = reinterpret_cast<const uint32_t*>(dz2s);
  uint32_t* dz1w = reinterpret_cast<uint32_t*>(dz1s);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int pair = warp >> 1, nhalf = warp & 1;
  const int m_lo = 32 * pair + g;
  const int ro[4] = {y1_row_words(m_lo), y1_row_words(m_lo + 8), y1_row_words(m_lo + 16),
                     y1_row_words(m_lo + 24)};

  for (int tile = blockIdx.x, buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const Origin o = origin(tile, tiles_h, tiles_w);
    const int P0 = o.P0, Q0 = o.Q0;
    const int y2r0 = 2 * P0 - 3, y2c0 = 2 * Q0 - 3;  // global origin of the y2 region
    const int y1r0 = y2r0 - 1, y1c0 = y2c0 - 1;
    const float* xs = xs2 + buf * kXN;  // this tile's x and dy
#if defined(K3_READS_DY)
    const __nv_bfloat16* wdy = wdy2 + buf * (kWin * kWdyRow);
#endif
    const int next = tile + static_cast<int>(gridDim.x);
    // The fetch's per-thread indices come from a copy of tid that the
    // compiler cannot see through, so they are worked out again in each
    // tile: hoisted out of the loop, they were held across the products
    // and spilled at 128 registers.
    int ftid = tid;
    asm volatile("" : "+r"(ftid));

    // The previous tile's readers are done, and this tile's x and dy are
    // staged (by the previous tile, or before the loop).
    __syncthreads();

    // The next tile's x and dy, loaded now and stored after conv1_1.
    unsigned short xn[kXPerThread], dyn[kDyPerThread];
    if (next < tiles) {
      fetch_x(xn, x, origin(next, tiles_h, tiles_w), H, W, ftid);
#if defined(K3_READS_DY)
      fetch_dy(dyn, dy, origin(next, tiles_h, tiles_w), H, W, ftid);
#endif
    }

    // ---- 1. recompute y1 and y2 exactly as K2 ---------------------------
    for (int i = tid; i < kNY1 * (kF / 8); i += kThreads) {
      const int p = i % kNY1, cg = i / kNY1;
      const int r = p / kY1W, col = p % kY1W;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
#pragma unroll
          for (int c = 0; c < kCin; ++c) {
            const float xv = xs[(c * kXH + r + u) * kXW + col + v];
            const float4* wr =
                reinterpret_cast<const float4*>(w1s + ((u * 3 + v) * kCin + c) * kF + cg * 8);
            const float4 wa = wr[0], wb = wr[1];
            acc[0] = fmaf(xv, wa.x, acc[0]);
            acc[1] = fmaf(xv, wa.y, acc[1]);
            acc[2] = fmaf(xv, wa.z, acc[2]);
            acc[3] = fmaf(xv, wa.w, acc[3]);
            acc[4] = fmaf(xv, wb.x, acc[4]);
            acc[5] = fmaf(xv, wb.y, acc[5]);
            acc[6] = fmaf(xv, wb.z, acc[6]);
            acc[7] = fmaf(xv, wb.w, acc[7]);
          }
        }
      }
      const int R = y1r0 + r, C = y1c0 + col;
      const bool valid = R >= 0 && R < H && C >= 0 && C < W;
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = valid ? max_nan(acc[2 * j] + b1s[cg * 8 + 2 * j], 0.f) : 0.f;
        const float hi = valid ? max_nan(acc[2 * j + 1] + b1s[cg * 8 + 2 * j + 1], 0.f) : 0.f;
        packed[j] = pack_bf16(lo, hi);
      }
      *reinterpret_cast<uint4*>(y1s + p * kRow + cg * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    // Into the other buffers, read since the top of this tile by no one.
    if (next < tiles) {
      stage_x(xn, xs2 + (buf ^ 1) * kXN, ftid);
#if defined(K3_READS_DY)
      stage_dy(dyn, wdy2 + (buf ^ 1) * (kWin * kWdyRow), ftid);
#endif
    }
    __syncthreads();

#if defined(K3_SKIP_CONV2)
    // y2 := y1 at the same position (y1 local (r + 1, c + 1)); y1 is 0
    // outside the image already.
    for (int i = tid; i < kMTiles * 16 * (kF / 8); i += kThreads) {
      const int m = i % (kMTiles * 16), cg = i / (kMTiles * 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < kM)
        v = *reinterpret_cast<const uint4*>(y1s + ((m / kY2W + 1) * kY1W + m % kY2W + 1) * kRow +
                                            cg * 8);
      *reinterpret_cast<uint4*>(y2s + m * kRow + cg * 8) = v;
    }
#else
    {
      float acc[2][4][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = ((tap / 3) * kY1W + tap % 3) * (kRow / 2);
#pragma unroll
        for (int kc = 0; kc < kF / 16; ++kc) {
          const int cw = kc * 8 + tig;
          uint32_t a[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            a[t][0] = y1w[ro[2 * t] + toff + cw];
            a[t][1] = y1w[ro[2 * t + 1] + toff + cw];
            a[t][2] = y1w[ro[2 * t] + toff + cw + 4];
            a[t][3] = y1w[ro[2 * t + 1] + toff + cw + 4];
          }
          const int kw = tap * (kF / 2) + cw;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = (nhalf * 4 + j) * 8 + g;
            const uint32_t bb0 = w2w[n * (kW2Row / 2) + kw];
            const uint32_t bb1 = w2w[n * (kW2Row / 2) + kw + 4];
#pragma unroll
            for (int t = 0; t < 2; ++t) mma_bf16(acc[t][j], a[t], bb0, bb1);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m_lo + 16 * t + 8 * half;
          const int R = y2r0 + m / kY2W, C = y2c0 + m % kY2W;
          const bool valid = m < kM && R >= 0 && R < H && C >= 0 && C < W;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = (nhalf * 4 + j) * 8 + tig * 2;
            const float lo = valid ? max_nan(acc[t][j][2 * half] + b2s[n], 0.f) : 0.f;
            const float hi = valid ? max_nan(acc[t][j][2 * half + 1] + b2s[n + 1], 0.f) : 0.f;
            y2w[m * (kRow / 2) + n / 2] = pack_bf16(lo, hi);
          }
        }
      }
    }
#endif
    __syncthreads();

#if defined(K3_RECOMPUTE_ONLY)
    // db1 := sum of the owned y1 (warps 0-7), db2 := sum of the owned y2
    // (warps 8-15); four channels a thread, positions over half-warps.
    {
      const int cq = (lane & 15) * 4;
      const bool of_y2 = warp >= 8;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = (warp & 7) * 2 + (lane >> 4); k < kOwn; k += 16) {
        const int r = k / kOwnW, c = k % kOwnW;
        const __nv_bfloat16* src = of_y2 ? y2s + ((r + 2) * kY2W + c + 2) * kRow
                                         : y1s + ((r + 3) * kY1W + c + 3) * kRow;
        const uint2 v = *reinterpret_cast<const uint2*>(src + cq);
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += __bfloat162float(ve[e]);
      }
      float* red = of_y2 ? red2 + (warp - 8) * kF : red1 + warp * kF;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], 16);
        if (lane < 16) red[cq + e] = s[e];
      }
    }
    __syncthreads();
    if (tid < 2 * kF) {
      const float* red = tid < kF ? red1 : red2;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += red[k * kF + tid % kF];
      accumulate(part + (tid < kF ? kDb1Off : kDb2Off) + tid % kF, s, first);
    }
#else
    // ---- 2. windows: max and first match --------------------------------
    // Window (wp, wq) is pooled (P0 - 1 + wp, Q0 - 1 + wq) and covers y2
    // local rows 2wp..2wp+2 and cols 2wq..2wq+2. Outside the image y2 is 0
    // and dy is 0 (fetch_dy fills it so), so whatever they route dies at
    // the ReLU mask. Neighbouring threads take neighbouring channels of one
    // window.
#if !defined(K3_SKIP_POOL)
#if !defined(K3_SKIP_FM)
    for (int i = tid; i < kWin * kF; i += kThreads) {
      const int ch = i % kF, w = i / kF;
      const int wp = w / kWinW, wq = w % kWinW;
      float v[9];
      // Every y2 value is >= 0 or NaN. A NaN maximum equals no value, so
      // fm stays 9 and the window routes nothing, as the first match of
      // pool_route_plain and of the TPU kernel does (== is false on NaN).
      float mx = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        v[k] = __bfloat162float(y2s[((2 * wp + k / 3) * kY2W + 2 * wq + k % 3) * kRow + ch]);
        mx = max_nan(mx, v[k]);
      }
      int fm = 9;
#pragma unroll
      for (int k = 8; k >= 0; --k) fm = v[k] == mx ? k : fm;
      wfirst[w * kF + ch] = static_cast<unsigned char>(fm);
    }
#endif
    __syncthreads();
#endif

    // ---- 3. dz2 on the 12 x 14 grid; db2 over the owned 10 x 12 ----------
    // Grid (i, j) is y2 local (i + 1, j + 1). Thread: four neighbouring
    // channels; the two half-warps take positions 84 apart (six rows), of
    // the same row and column parity, so a warp takes one branch path.
    {
      const int cq = (lane & 15) * 4;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int base = warp; base < kNDz / 2; base += kThreads / 32) {
        const int pos = base + (lane >> 4) * (kNDz / 2);
        const int i = pos / kDzW, j = pos % kDzW;
        const int r = i + 1, c = j + 1;
        float dz[4] = {0.f, 0.f, 0.f, 0.f};
#if !defined(K3_SKIP_POOL)
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if ((r - u) & 1) continue;
          const int wp = (r - u) >> 1;
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            if ((c - v) & 1) continue;
            const int w = wp * kWinW + ((c - v) >> 1);
            const uint32_t fm = *reinterpret_cast<const uint32_t*>(wfirst + w * kF + cq);
            const uint2 d = *reinterpret_cast<const uint2*>(wdy + w * kWdyRow + cq);
            const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&d);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (((fm >> (8 * e)) & 0xffu) == static_cast<uint32_t>(u * 3 + v))
                dz[e] = __bfloat162float(__float2bfloat16_rn(dz[e] + __bfloat162float(dv[e])));
          }
        }
#endif
        const uint2 y = *reinterpret_cast<const uint2*>(y2s + (r * kY2W + c) * kRow + cq);
        const __nv_bfloat16* yv = reinterpret_cast<const __nv_bfloat16*>(&y);
#if defined(K3_SKIP_POOL)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[e] = __bfloat162float(yv[e]);  // dz2 := y2
#endif
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!(__bfloat162float(yv[e]) > 0.f)) dz[e] = 0.f;
        // exact: each dz is a bf16 value
        *reinterpret_cast<uint2*>(dz2s + pos * kRow + cq) =
            make_uint2(pack_bf16(dz[0], dz[1]), pack_bf16(dz[2], dz[3]));
        if (i >= 1 && i <= 2 * kTP && j >= 1 && j <= kOwnW)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[e] += dz[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += __shfl_xor_sync(0xffffffffu, s[e], 16);
        if (lane < 16) red2[warp * kF + cq + e] = s[e];
      }
    }
    __syncthreads();

    if (tid < kF) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) s += red2[k * kF + tid];
      accumulate(part + kDb2Off + tid, s, first);
    }

    // ---- 4a. dW2[(tap, cin)][n] = sum over owned p of y1(p + tap) dz2(p) --
    // Warp: a 16-channel block cb of cin for all 9 taps x 2 n-tiles, tap by
    // tap. The owned positions' dz2 fragments (every tap's B operand) stay
    // in registers; a tap's eight sums a thread (two n-tiles) run over the
    // 8 k-steps in order and go to the partial row at once, so the row's
    // traffic spreads over the product.
    {
      const int cb = warp >> 2, nq = warp & 3;
#if !defined(K3_SKIP_DW2)
      const int ka = (lane & 7) + ((lane >> 4) << 3);        // A: position row of this lane
      const int ma = ((lane >> 3) & 1) * 8;                  // A: cin offset
      const int kb = (lane & 7) + (((lane >> 3) & 1) << 3);  // B: position row
      const int nb = (lane >> 4) * 8;                        // B: n offset
      uint32_t bfr[kOwnPad / 16][4];
      int y1off[kOwnPad / 16];  // y1s element offset of tap (0, 0) per k-step
#pragma unroll
      for (int ks = 0; ks < kOwnPad / 16; ++ks) {
        const int kbk = ks * 16 + kb;
        const int dzrow = kbk < kOwn ? (kbk / kOwnW + 1) * kDzW + kbk % kOwnW + 1 : kNDz;
        ldsm_x4_trans(bfr[ks], dz2s + dzrow * kRow + nq * 16 + nb);
        int kak = ks * 16 + ka;
        kak = kak < kOwn ? kak : kOwn - 1;  // its B row is the zero row
        y1off[ks] = ((kak / kOwnW + 2) * kY1W + kak % kOwnW + 2) * kRow + cb * 16 + ma;
      }
#endif
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        float acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#if !defined(K3_SKIP_DW2)
        const int toff = ((tap / 3) * kY1W + tap % 3) * kRow;
#pragma unroll
        for (int ks = 0; ks < kOwnPad / 16; ++ks) {
          uint32_t afr[4];
          ldsm_x4_trans(afr, y1s + y1off[ks] + toff);
          mma_bf16(acc[0], afr, bfr[ks][0], bfr[ks][1]);
          mma_bf16(acc[1], afr, bfr[ks][2], bfr[ks][3]);
        }
#else
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) opaque(acc[j][e]);
#endif
        // Two stores (the first tile) or reductions, with no wait.
#pragma unroll
        for (int j = 0; j < 2; ++j)
          accumulate4(part + dw2_slot(warp, tap, j, lane), acc[j], first);
      }
    }

    // ---- 4b. dy1 at the owned y1 positions; dz1, db1 ----------------------
    // dy1[q][cin] = sum over (u, v, n) of dz2[q + (1-u, 1-v)][n] w2[n][cin][u][v].
    // Warp: M tile mt (owned positions 16mt..16mt+15) x n half nh (cin).
    {
      const int mt = warp >> 1, nh = warp & 1;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#if !defined(K3_SKIP_DY1)
      int base[2];  // dz2 grid index of q + (1, 1) for rows g and g + 8
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int m = mt * 16 + g + 8 * half;
        m = m < kOwn ? m : kOwn - 1;
        base[half] = (m / kOwnW + 2) * kDzW + m % kOwnW + 2;
      }
      const int kb = (lane & 7) + (((lane >> 3) & 1) << 3);
      const int nb = (lane >> 4) * 8;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * kDzW + tap % 3;
        const int r0 = (base[0] - off) * (kRow / 2), r1 = (base[1] - off) * (kRow / 2);
#pragma unroll
        for (int kc = 0; kc < kF / 16; ++kc) {
          const int cw = kc * 8 + tig;
          const uint32_t afr[4] = {dzw[r0 + cw], dzw[r1 + cw], dzw[r0 + cw + 4], dzw[r1 + cw + 4]};
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bfr[4];
            ldsm_x4_trans(bfr, w2s + (kc * 16 + kb) * kW2Row + tap * kF + (nh * 4 + jp * 2) * 8 + nb);
            mma_bf16(acc[2 * jp], afr, bfr[0], bfr[1]);
            mma_bf16(acc[2 * jp + 1], afr, bfr[2], bfr[3]);
          }
        }
      }
#else
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) opaque(acc[j][e]);
#endif
      float s[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + g + 8 * half;
        const bool valid = m < kOwn;
        const int mc = valid ? m : 0;
        const int y1pos = (mc / kOwnW + 3) * kY1W + mc % kOwnW + 3;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cin = (nh * 4 + j) * 8 + tig * 2;
          const float lo = valid && __bfloat162float(y1s[y1pos * kRow + cin]) > 0.f
                               ? acc[j][2 * half] : 0.f;
          const float hi = valid && __bfloat162float(y1s[y1pos * kRow + cin + 1]) > 0.f
                               ? acc[j][2 * half + 1] : 0.f;
          s[j][0] += lo;
          s[j][1] += hi;
          dz1w[m * (kRow / 2) + cin / 2] = pack_bf16(lo, hi);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = s[j][e];
          t += __shfl_xor_sync(0xffffffffu, t, 4);
          t += __shfl_xor_sync(0xffffffffu, t, 8);
          t += __shfl_xor_sync(0xffffffffu, t, 16);
          if (g == 0) red1[mt * kF + (nh * 4 + j) * 8 + tig * 2 + e] = t;
        }
    }
    __syncthreads();

    if (tid < kF) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s += red1[k * kF + tid];
      accumulate(part + kDb1Off + tid, s, first);
    }

    // ---- 5. dW1[(u, v, c)][n] = sum over owned q of x(q + tap) dz1(q) ------
    // Warp: M tile mt of the 27 (+5 zero) rows x n-tile nt.
    {
      const int mt = warp >> 3, nt = warp & 7;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#if !defined(K3_SKIP_DW1)
      int xo[2];  // xs offset of row m at owned position 0, or -1 for a zero row
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + g + 8 * half;
        const int tap = m / 3, c = m % 3;
        xo[half] = m < 27 ? (c * kXH + tap / 3 + 3) * kXW + tap % 3 + 3 : -1;
      }
      const int n = nt * 8 + g;
#pragma unroll 1
      for (int ks = 0; ks < kOwnPad / 16; ++ks) {
        float xv[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = ks * 16 + 2 * tig + (e & 1) + (e >> 1) * 8;
          const int kc = k < kOwn ? k : kOwn - 1;  // dz1 is 0 there
          const int off = (kc / kOwnW) * kXW + kc % kOwnW;
#pragma unroll
          for (int half = 0; half < 2; ++half) xv[half][e] = xo[half] >= 0 ? xs[xo[half] + off] : 0.f;
        }
        const uint32_t afr[4] = {pack_bf16(xv[0][0], xv[0][1]), pack_bf16(xv[1][0], xv[1][1]),
                                 pack_bf16(xv[0][2], xv[0][3]), pack_bf16(xv[1][2], xv[1][3])};
        const int k0 = ks * 16 + 2 * tig;
        const uint32_t bb0 = pack_bf16(dz1s[k0 * kRow + n], dz1s[(k0 + 1) * kRow + n]);
        const uint32_t bb1 = pack_bf16(dz1s[(k0 + 8) * kRow + n], dz1s[(k0 + 9) * kRow + n]);
        mma_bf16(acc, afr, bb0, bb1);
      }
#else
#pragma unroll
      for (int e = 0; e < 4; ++e) opaque(acc[e]);
#endif
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + g + 8 * half;
        if (m < 27)
          accumulate2(part + kDw1Off + m * kF + nt * 8 + tig * 2, acc[2 * half],
                      acc[2 * half + 1], first);
      }
    }
#endif
  }
}

// out = sum of the `rows` partial rows in row order, in the OIHW layouts.
__global__ void block1_bwd_reduce(const float* __restrict__ partials, int rows,
                                  float* __restrict__ dw1, float* __restrict__ db1,
                                  float* __restrict__ dw2, float* __restrict__ db2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kPartFloats) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[static_cast<size_t>(r) * kPartFloats + i];
  if (i < kDb1Off) {
    const int m = i / kF, n = i % kF;  // m = (u * 3 + v) * 3 + c
    dw1[n * 27 + (m % 3) * 9 + m / 3] = s;
  } else if (i < kDw2Off) {
    db1[i - kDb1Off] = s;
  } else if (i < kDb2Off) {
    // dw2_slot's thread-major index ((warp * 9 + tap) * 2 + j) * 128 +
    // lane * 4 + e, back to the mma fragment's (cin, n) and OIHW.
    const int k = i - kDw2Off;
    const int e = k & 3, lane = (k >> 2) & 31, j = (k >> 7) & 1;
    const int tap = (k >> 8) % 9, warp = (k >> 8) / 9;
    const int cin = (warp >> 2) * 16 + (lane >> 2) + 8 * (e >> 1);
    const int n = ((warp & 3) * 2 + j) * 8 + (lane & 3) * 2 + (e & 1);
    dw2[n * kK2 + cin * 9 + tap] = s;
  } else {
    db2[i - kDb2Off] = s;
  }
}

// The device's SM count, and the kernel's opt-in shared memory, set once
// per device (the attribute persists), not on every launch.
cudaError_t prepare(int* sms) {
  static std::atomic<unsigned long long> done{0};
  static int sm_count[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done.load() & bit)) {
    err = cudaDeviceGetAttribute(&sm_count[dev & 63], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(block1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  *sms = sm_count[dev & 63];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code of the launches (0 =
// ok). `partials` holds [SM count][38720] f32 (the wrapper allocates it).
int em_block1_bwd_launch(const void* x, const void* dy, const void* w1, const float* b1,
                         const void* w2, const float* b2, float* dw1, float* db1, float* dw2,
                         float* db2, float* partials, int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || H % 2 == 0 || W % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int tiles = B * ((OH + kTP - 1) / kTP) * ((OW + kTQ - 1) / kTQ);
  const int grid = tiles < sms ? tiles : sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  block1_bwd_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(w1), b1, static_cast<const __nv_bfloat16*>(w2), b2,
      partials, B, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block1_bwd_reduce<<<(kPartFloats + 255) / 256, 256, 0, s>>>(partials, grid, dw1, db1, dw2, db2);
  return static_cast<int>(cudaGetLastError());
}

// The main kernel's dynamic shared memory per CTA, in bytes.
int em_block1_bwd_smem_bytes() { return static_cast<int>(kSmemBytes); }

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
