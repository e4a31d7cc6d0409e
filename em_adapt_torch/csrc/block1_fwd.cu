// Fused VGG block 1 forward (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel em_adapt_tpu/ops/block1_pallas.py::_fwd_kernel
// (launched from _fwd, block1_pallas.py:516). Same function, in bf16:
//   y1 = bf16(relu(conv3x3_same(x, w1) + b1))      3 -> 64 channels
//   y2 = bf16(relu(conv3x3_same(y1, w2) + b2))     64 -> 64 channels
//   out = maxpool3x3_stride2_same(y2)              H -> (H + 1) / 2
// The products take bf16 inputs and accumulate in f32; each bias is added
// in f32 before the rounding to bf16 (block1_pallas.py:43-45). y1 and y2
// never reach device memory. Positions of y1 outside the image are
// conv1_2's SAME zero padding, and positions of y2 outside it are zero,
// which the pool ignores (every y2 value is >= 0 after the ReLU); both are
// masked to 0 here as _mask_rows_cols does on the TPU, so a positive bias
// never leaks relu(b) into the border.
//
// Layout: x [B, 3, H, W] bf16 and out [B, 64, OH, OW] bf16 (NCHW, the
// model's activations as they are); w1 [64, 3, 3, 3] and w2 [64, 64, 3, 3]
// bf16 (OIHW); b1, b2 [64] f32. H and W odd (SAME pool pad of 1 each side).
//
// Tiles. Persistent CTAs of 16 warps, one per SM, walk over output tiles
// of 7 pooled rows x 8 pooled cols of one image (tile, tile + grid, ...).
// A tile needs x on 19 x 21 positions (f32 in shared memory), y1 on 17 x 19
// (64 channels bf16, rows padded to 72 elements so that the fragment loads
// hit 32 distinct banks) and y2 on 15 x 17 = 255 (+1 pad) positions. w2 is
// loaded once per CTA as [n][k] with k = tap * 64 + cin.
//
// Design: a pipeline of two roles across tiles, so that the next tile's x
// fetch and conv1_1 run while this tile's conv1_2 runs.
//   Producers, warps 8-15: load tile t+1's x into registers (2-byte loads:
//     TMA and cp.async cannot take rows 642 B apart that start at odd
//     element offsets), run tile t's conv1_1 on the FMA units into y1s[t % 2]
//     (per y1 element an f32 fmaf chain over its 27 products in (u, v, c)
//     order, + b1, ReLU, mask, round to nearest even: conv1_plain's bits;
//     a thread makes 8 channels of two positions, so that each w1 load
//     serves both), signal FULL[t % 2], then store the loaded x into
//     xs[(t + 1) % 2].
//   Consumers, warps 0-7 (two whole warpgroups): wait for FULL[t % 2], run
//     conv1_2 as an implicit GEMM on mma.sync.m16n8k16 bf16 -> f32 (M = 256
//     y2 positions, N = 64, K = 576; warp w takes rows 32w..32w+31 and all
//     64 columns, so each A fragment is loaded once; ldmatrix.x4 loads four
//     fragment registers an instruction), signal EMPTY[t % 2] right after
//     their last read of y1s, add b2 in f32, ReLU, mask, round into y2s, and
//     take the 3 x 3 / 2 max pool of y2s into `out`. Each element's products
//     are summed tap by tap, 16 channels at a time, by the same instruction
//     as in the kernel whose phases ran one after another: the same bits.
//   Barriers: named barriers (barrier.sync / barrier.arrive with a thread
//     count) in place of __syncthreads inside the tile loop. FULL[b] (ids
//     3, 4): producers arrive, consumers sync. EMPTY[b] (5, 6): consumers
//     arrive after tile t's conv1_2 only where the CTA has a tile t + 2 to
//     put into y1s[t % 2], and producers sync before that tile's conv1_1,
//     so every arrival is matched and none outlives the kernel. Id 1 orders
//     the producers' x staging, id 2 the consumers' y2s. A CTA with one
//     tile, CTAs with uneven counts, and producers that finish first (they
//     leave while consumers still pool) need nothing else.
//   The pool reads y2s as bf16 pairs: a lane takes two channels of one
//     pooled position, a warp 16 channels of 4 positions, whose words lie
//     on 32 distinct banks (one channel of 32 positions lay on 4). The max
//     is exact, so the order of the window does not matter.
// Shared memory: w2s 74,752 B, y1s 2 x 46,512, y2s 36,864, w1s 6,912,
// biases 512, xs 2 x 4,788: 221,640 B of the 232,448 a block can use.
// Registers: 128 a thread, no spills (chip_smoke.py checks the ptxas report).
//
// What bounds it: operations. 47.7 GFLOP at B = 6, 321^2 (conv1_2 is 96%
// of them) take 0.048 ms at the 989 TFLOP/s dense bf16 peak, the 23.6 MB
// of x and out 0.007 ms at 3.35 TB/s. What is left: the two roles do not
// hide each other. Switched off one at a time, conv1_1 and conv1_2 each
// save about as much as they cost alone: both load their operands from
// shared memory through the SM's one load/store pipe (conv1_2's mma.sync
// fragments warp by warp, not once per warpgroup as wgmma would read B;
// conv1_1's x and w1 for every 8 fused multiply-adds), and that pipe, not
// a wait, sets the pace. The tile also recomputes a halo (255 y2 positions
// per 224 pooled inputs). PERF.md has the times of each part.
//
// No fast-math: flush-to-zero would change small values before rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kConsumers = 256;               // warps 0-7
constexpr int kProducers = kThreads - kConsumers;  // warps 8-15
constexpr int kF = 64;           // channels of y1, y2 and out
constexpr int kCin = 3;          // channels of x
constexpr int kTP = 7;           // pooled rows per tile
constexpr int kTQ = 8;           // pooled cols per tile
constexpr int kY2H = 2 * kTP + 1;  // 15
constexpr int kY2W = 2 * kTQ + 1;  // 17
constexpr int kY1H = kY2H + 2;     // 17
constexpr int kY1W = kY2W + 2;     // 19
constexpr int kXH = kY1H + 2;      // 19
constexpr int kXW = kY1W + 2;      // 21
constexpr int kXN = kCin * kXH * kXW;  // 1,197 x values per tile
constexpr int kXPerThread = (kXN + kProducers - 1) / kProducers;  // 5
constexpr int kM = kY2H * kY2W;    // 255 y2 positions
constexpr int kMTiles = (kM + 15) / 16;  // 16
constexpr int kNY1 = kY1H * kY1W;  // 323 y1 positions
constexpr int kY1Half = (kNY1 + 1) / 2;  // 162: conv1_1's items take p and p + 162
constexpr int kK2 = 9 * kF;        // 576
constexpr int kRow = 72;           // bf16 per y1 / y2 row in shared memory
constexpr int kW2Row = kK2 + 8;    // bf16 per w2 row in shared memory
constexpr int kPoolTasks = kTP * kTQ * kF / 2;  // 1,792: two channels each

static_assert(kMTiles == 2 * (kConsumers / 32), "8 consumer warps x 2 M tiles of 16");
static_assert(kPoolTasks == kTP * kConsumers, "the pool: one pooled row per consumer round");

constexpr size_t kW2Bytes = sizeof(__nv_bfloat16) * kF * kW2Row;
constexpr size_t kY1Bytes = sizeof(__nv_bfloat16) * kNY1 * kRow;
constexpr size_t kY2Bytes = sizeof(__nv_bfloat16) * kMTiles * 16 * kRow;
constexpr size_t kXBytes = sizeof(float) * kXN;
constexpr size_t kW1Bytes = sizeof(float) * 27 * kF;
constexpr size_t kSmemBytes = kW2Bytes + 2 * kY1Bytes + kY2Bytes + kW1Bytes +
                              2 * sizeof(float) * kF + 2 * kXBytes;
static_assert((kW2Bytes + 2 * kY1Bytes + kY2Bytes) % 16 == 0, "w1s must be 16-byte aligned");
static_assert(kY1Bytes % 16 == 0, "each y1s buffer must be 16-byte aligned");
static_assert(kSmemBytes <= 232448, "more shared memory than a block can use");

// Named barriers (id 0 is __syncthreads'). The non-.aligned forms count
// threads, not warps, so a warp need not have reconverged to take part.
constexpr int kBarProducers = 1;
constexpr int kBarConsumers = 2;
constexpr int kBarFull = 3;   // + buffer
constexpr int kBarEmpty = 5;  // + buffer

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1 of matrix i -- mma.sync's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// max(a, b) that propagates NaN, as jnp.maximum and torch's ReLU and max
// pool do (fmaxf returns the other operand). PTX's max.NaN is max.f32 with
// a NaN operand giving NaN; on numbers, +0 and -0 included, it is max.f32.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Word offset (uint32 = 2 bf16) of the y1 row under y2 position m, tap (0, 0).
__device__ __forceinline__ int y1_row_words(int m) {
  m = m < kM ? m : kM - 1;  // the pad row reads a valid position; discarded
  return ((m / kY2W) * kY1W + m % kY2W) * (kRow / 2);
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

// A tile's image and the global row and column of its x tile's corner.
struct Origin {
  int b, P0, Q0;
};

__device__ __forceinline__ Origin origin(int tile, int tiles_h, int tiles_w) {
  const int rem = tile % (tiles_h * tiles_w);
  return {tile / (tiles_h * tiles_w), (rem / tiles_w) * kTP, (rem % tiles_w) * kTQ};
}

// A tile's x (19 x 21 per channel from global row 2P0 - 3, column 2Q0 - 3),
// 0 outside the image, as bf16 bits in registers: this producer's
// elements i = ptid + k * kProducers.
__device__ __forceinline__ void fetch_x(unsigned short (&r)[kXPerThread],
                                        const __nv_bfloat16* x, Origin o, int H, int W,
                                        int ptid) {
  const __nv_bfloat16* xb = x + static_cast<size_t>(o.b) * kCin * H * W;
  const int xr0 = 2 * o.P0 - 3, xc0 = 2 * o.Q0 - 3;
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int i = ptid + k * kProducers;
    const int c = i / (kXH * kXW), row = (i / kXW) % kXH, col = i % kXW;
    const int R = xr0 + row, C = xc0 + col;
    r[k] = ldg_u16(xb + (static_cast<size_t>(c) * H + R) * W + C,
                   i < kXN && R >= 0 && R < H && C >= 0 && C < W);
  }
}

__device__ __forceinline__ void stage_x(const unsigned short (&r)[kXPerThread], float* xs,
                                        int ptid) {
#pragma unroll
  for (int k = 0; k < kXPerThread; ++k) {
    const int i = ptid + k * kProducers;
    if (i < kXN) xs[i] = __uint_as_float(static_cast<uint32_t>(r[k]) << 16);
  }
}

// conv1_1 of one tile: item = (channel group of 8, y1 positions p and
// p + kY1Half), so that each w1 load serves two positions; per position
// f32 sums of the 27 exact bf16 products in (u, v, c) order, then + b1,
// ReLU, mask.
__device__ __forceinline__ void conv1_1(const float* xs, const float* w1s, const float* b1s,
                                        __nv_bfloat16* y1s, int y1r0, int y1c0, int H, int W,
                                        int ptid) {
  for (int i = ptid; i < kY1Half * (kF / 8); i += kProducers) {
    const int p0 = i % kY1Half, cg = i / kY1Half;
    const int p[2] = {p0, p0 + kY1Half < kNY1 ? p0 + kY1Half : p0};
    const int r[2] = {p[0] / kY1W, p[1] / kY1W}, col[2] = {p[0] % kY1W, p[1] % kY1W};
    float acc[2][8];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[s][j] = 0.f;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int c = 0; c < kCin; ++c) {
          const float4* wr =
              reinterpret_cast<const float4*>(w1s + ((u * 3 + v) * kCin + c) * kF + cg * 8);
          const float4 wa = wr[0], wb = wr[1];
          const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float xv = xs[(c * kXH + r[s] + u) * kXW + col[s] + v];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[s][j] = fmaf(xv, w[j], acc[s][j]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 1 && p[1] == p[0]) break;  // the last item has one position
      const int R = y1r0 + r[s], C = y1c0 + col[s];
      const bool valid = R >= 0 && R < H && C >= 0 && C < W;
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = valid ? max_nan(acc[s][2 * j] + b1s[cg * 8 + 2 * j], 0.f) : 0.f;
        const float hi = valid ? max_nan(acc[s][2 * j + 1] + b1s[cg * 8 + 2 * j + 1], 0.f) : 0.f;
        packed[j] = pack_bf16(lo, hi);
      }
      *reinterpret_cast<uint4*>(y1s + p[s] * kRow + cg * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
block1_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int B, int H,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* y1s2 = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);  // two buffers
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes + 2 * kY1Bytes);
  // [27][64], k = (u * 3 + v) * 3 + c; 16-byte aligned for float4 reads.
  float* w1s = reinterpret_cast<float*>(smem + kW2Bytes + 2 * kY1Bytes + kY2Bytes);
  float* b1s = w1s + 27 * kF;
  float* b2s = b1s + kF;
  float* xs2 = b2s + kF;  // two buffers of kXN

  const int tid = threadIdx.x;
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int tiles_h = (OH + kTP - 1) / kTP, tiles_w = (OW + kTQ - 1) / kTQ;
  const int tiles = B * tiles_h * tiles_w;
  const int step = static_cast<int>(gridDim.x);

  if (tid >= kConsumers) {  // the first tile's x, into buffer 0
    unsigned short x0[kXPerThread];
    fetch_x(x0, x, origin(blockIdx.x, tiles_h, tiles_w), H, W, tid - kConsumers);
    stage_x(x0, xs2, tid - kConsumers);
  }
  // Weights once per CTA. w2 OIHW [n][cin][u][v] -> w2s[n][(u*3+v)*64 + cin].
  for (int i = tid; i < kF * kK2; i += kThreads) {
    const int n = i / kK2, cin = (i / 9) % kF, tap = i % 9;
    w2s[n * kW2Row + tap * kF + cin] = w2[i];
  }
  for (int i = tid; i < 27 * kF; i += kThreads) {
    const int n = i / 27, c = (i / 9) % kCin, tap = i % 9;  // OIHW [n][c][u][v]
    w1s[(tap * kCin + c) * kF + n] = __bfloat162float(w1[i]);
  }
  for (int i = tid; i < kF; i += kThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
  }
  __syncthreads();  // the last CTA-wide barrier: from here on the roles part

  if (tid >= kConsumers) {
    // ---- producers: x fetch and conv1_1, one tile ahead ------------------
    const int ptid = tid - kConsumers;
    for (int tile = blockIdx.x, k = 0; tile < tiles; tile += step, ++k) {
      const int buf = k & 1;
      const Origin o = origin(tile, tiles_h, tiles_w);
      const int next = tile + step;
      unsigned short xn[kXPerThread];  // the next tile's x, stored after conv1_1
      if (next < tiles) fetch_x(xn, x, origin(next, tiles_h, tiles_w), H, W, ptid);
      // y1s[buf] last held tile k - 2, which the consumers have multiplied.
      if (k >= 2) bar_sync(kBarEmpty + buf, kThreads);
      conv1_1(xs2 + buf * kXN, w1s, b1s, y1s2 + buf * (kY1Bytes / 2), 2 * o.P0 - 2,
              2 * o.Q0 - 2, H, W, ptid);
      bar_arrive(kBarFull + buf, kThreads);
      // Into the other x buffer, which no producer has read since the last
      // barrier below.
      if (next < tiles) stage_x(xn, xs2 + (buf ^ 1) * kXN, ptid);
      bar_sync(kBarProducers, kProducers);
    }
    return;
  }

  // ---- consumers: conv1_2, epilogue and pool ------------------------------
  uint32_t* y2w = reinterpret_cast<uint32_t*>(y2s);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m_lo = 32 * warp + g;  // the epilogue's rows m_lo, +8, +16, +24
  // ldmatrix rows, in words: of A (M tile t: y2 row 32 warp + 16 t + lane % 8
  // (+ 8 for matrices 1 and 3), channels + 8 for matrices 2 and 3) and of
  // B (n-tile 2 jp + lane / 16: w2 row n = 8 (2 jp + lane / 16) + lane % 8,
  // k + 8 for matrices 1 and 3).
  const int a_row = 32 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_words[2] = {y1_row_words(a_row) + 4 * (lane >> 4),
                          y1_row_words(a_row + 16) + 4 * (lane >> 4)};
  const uint32_t b_addr = static_cast<uint32_t>(__cvta_generic_to_shared(w2s)) +
                          4 * (((lane >> 4) * 8 + (lane & 7)) * (kW2Row / 2) +
                               4 * ((lane >> 3) & 1));
  // The pool's lane: channels 2 * c2, 2 * c2 + 1 of pooled column q.
  const int c2 = (tid / 32 % 4) * 8 + tid % 8, q = (tid / 128) * 4 + tid / 8 % 4;

  for (int tile = blockIdx.x, k = 0; tile < tiles; tile += step, ++k) {
    const int buf = k & 1;
    const Origin o = origin(tile, tiles_h, tiles_w);
    const int y2r0 = 2 * o.P0 - 1, y2c0 = 2 * o.Q0 - 1;  // global origin of the y2 tile

    bar_sync(kBarFull + buf, kThreads);
    const uint32_t y1_addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(y1s2)) + buf * kY1Bytes;
    float acc[2][8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * kY1W + tap % 3) * (kRow / 2);
#pragma unroll
      for (int kc = 0; kc < kF / 16; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
          ldmatrix_x4(y1_addr + 4 * (a_words[t] + toff + kc * 8), a[t]);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // n-tiles 2 jp and 2 jp + 1
          uint32_t b[4];
          ldmatrix_x4(b_addr + 4 * (jp * 16 * (kW2Row / 2) + tap * (kF / 2) + kc * 8), b);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              mma_bf16(acc[t][2 * jp + h], a[t][0], a[t][1], a[t][2], a[t][3], b[2 * h],
                       b[2 * h + 1]);
        }
      }
    }
    // y1s[buf] is read; the producers may fill it with tile k + 2.
    if (tile + 2 * step < tiles) bar_arrive(kBarEmpty + buf, kThreads);

    bar_sync(kBarConsumers, kConsumers);  // the previous tile's pool has read y2s
    // Epilogue: + b2 in f32, ReLU, mask, round to bf16, into y2s.
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m_lo + 16 * t + 8 * half;
        const int R = y2r0 + m / kY2W, C = y2c0 + m % kY2W;
        const bool valid = m < kM && R >= 0 && R < H && C >= 0 && C < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = j * 8 + tig * 2;
          const float lo = valid ? max_nan(acc[t][j][2 * half] + b2s[n], 0.f) : 0.f;
          const float hi = valid ? max_nan(acc[t][j][2 * half + 1] + b2s[n + 1], 0.f) : 0.f;
          y2w[m * (kRow / 2) + n / 2] = pack_bf16(lo, hi);
        }
      }
    }
    bar_sync(kBarConsumers, kConsumers);

    // 3x3 / 2 max pool: pooled (p, q) covers y2 local rows 2p..2p+2 and
    // cols 2q..2q+2; this lane takes channels 2 * c2 and 2 * c2 + 1.
    const int Q = o.Q0 + q;
    __nv_bfloat16* ob = out + (static_cast<size_t>(o.b) * kF + 2 * c2) * OH * OW;
    for (int p = 0; p < kTP; ++p) {
      const int P = o.P0 + p;
      if (P >= OH || Q >= OW) continue;
      float lo = 0.f, hi = 0.f;  // every y2 value is >= 0 or NaN
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const uint32_t pair = y2w[((2 * p + u) * kY2W + 2 * q + v) * (kRow / 2) + c2];
          lo = max_nan(lo, __uint_as_float(pair << 16));
          hi = max_nan(hi, __uint_as_float(pair & 0xffff0000u));
        }
      ob[static_cast<size_t>(P) * OW + Q] = __float2bfloat16_rn(lo);
      ob[static_cast<size_t>(OH + P) * OW + Q] = __float2bfloat16_rn(hi);
    }
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
    err = cudaFuncSetAttribute(block1_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    done.fetch_or(bit);
  }
  *sms = sm_count[dev & 63];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
int em_block1_fwd_launch(const void* x, const void* w1, const float* b1, const void* w2,
                         const float* b2, void* out, int B, int H, int W, void* stream) {
  if (B == 0) return 0;
  if (H % 2 == 0 || W % 2 == 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int tiles = B * ((OH + kTP - 1) / kTP) * ((OW + kTQ - 1) / kTQ);
  const int grid = tiles < sms ? tiles : sms;
  block1_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1), b1,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

int em_block1_fwd_smem_bytes() { return static_cast<int>(kSmemBytes); }

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
