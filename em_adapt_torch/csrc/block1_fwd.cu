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
// Design. Persistent CTAs of 16 warps, one per SM; each walks over output
// tiles of 7 pooled rows x 8 pooled cols of one image. Per tile, in
// shared memory: the x tile (19 x 21 x 3, f32), the y1 tile (17 x 19
// positions x 64 channels, bf16, rows padded to 72 elements so the
// fragment loads hit 32 distinct banks) and the y2 tile (15 x 17 = 255
// positions). w2 is loaded once per CTA as [n][k] with k = tap * 64 + cin.
//   1. conv1_1 (K = 27) is SIMT f32 FMA: each thread makes 8 channels of
//      one y1 position and stores them as one 16-byte word.
//   2. conv1_2 is an implicit GEMM on the tensor cores, M = 255 (+1 pad)
//      y2 positions, N = 64, K = 576: mma.sync.m16n8k16 bf16 -> f32. Warp
//      w takes two M tiles of 16 and half of N (4 n-tiles of 8); its A
//      fragments are read straight from the y1 tile at the tap's offset.
//   3. The epilogue adds b2 in f32, applies the ReLU and the mask, rounds
//      to nearest even (as torch's .to(bfloat16)) and stores y2.
//   4. The pool takes the 3 x 3 / 2 max of the y2 tile and writes bf16.
//
// What bounds it: operations. 47.7 GFLOP at B = 6, 321^2 (conv1_2 is 96%
// of them) take 0.048 ms at the 989 TFLOP/s dense bf16 peak, the 23.6 MB
// of x and out 0.007 ms at 3.35 TB/s. This first version uses mma.sync
// (not wgmma), recomputes a halo (255 y2 positions per 224 pooled inputs),
// and runs its phases one after another inside a CTA, so the tensor cores
// idle through the loads, conv1_1 and the pool.
//
// No fast-math: flush-to-zero would change small values before rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
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
constexpr int kM = kY2H * kY2W;    // 255 y2 positions
constexpr int kMTiles = (kM + 15) / 16;  // 16
constexpr int kNY1 = kY1H * kY1W;  // 323 y1 positions
constexpr int kK2 = 9 * kF;        // 576
constexpr int kRow = 72;           // bf16 per y1 / y2 row in shared memory
constexpr int kW2Row = kK2 + 8;    // bf16 per w2 row in shared memory

static_assert(kMTiles == 2 * (kThreads / 32 / 2), "16 warps: 8 M-tile pairs x 2 N halves");

constexpr size_t kW2Bytes = sizeof(__nv_bfloat16) * kF * kW2Row;
constexpr size_t kY1Bytes = sizeof(__nv_bfloat16) * kNY1 * kRow;
constexpr size_t kY2Bytes = sizeof(__nv_bfloat16) * kMTiles * 16 * kRow;
constexpr size_t kXBytes = sizeof(float) * kCin * kXH * kXW;
constexpr size_t kW1Bytes = sizeof(float) * 27 * kF;
constexpr size_t kSmemBytes = kW2Bytes + kY1Bytes + kY2Bytes + kW1Bytes +
                              2 * sizeof(float) * kF + kXBytes;
static_assert((kW2Bytes + kY1Bytes + kY2Bytes) % 16 == 0, "w1s must be 16-byte aligned");

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word offset (uint32 = 2 bf16) of the y1 row under y2 position m, tap (0, 0).
__device__ __forceinline__ int y1_row_words(int m) {
  m = m < kM ? m : kM - 1;  // the pad row reads a valid position; discarded
  return ((m / kY2W) * kY1W + m % kY2W) * (kRow / 2);
}

__global__ void __launch_bounds__(kThreads, 1)
block1_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                  const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int B, int H,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes + kY1Bytes);
  // [27][64], k = (u * 3 + v) * 3 + c; 16-byte aligned for float4 reads.
  float* w1s = reinterpret_cast<float*>(smem + kW2Bytes + kY1Bytes + kY2Bytes);
  float* b1s = w1s + 27 * kF;
  float* b2s = b1s + kF;
  float* xs = b2s + kF;

  const int tid = threadIdx.x;
  const int OH = (H + 1) / 2, OW = (W + 1) / 2;
  const int tiles_h = (OH + kTP - 1) / kTP, tiles_w = (OW + kTQ - 1) / kTQ;
  const int tiles = B * tiles_h * tiles_w;

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

  const uint32_t* y1w = reinterpret_cast<const uint32_t*>(y1s);
  const uint32_t* w2w = reinterpret_cast<const uint32_t*>(w2s);
  uint32_t* y2w = reinterpret_cast<uint32_t*>(y2s);
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int pair = warp >> 1, nhalf = warp & 1;
  const int m_lo = 32 * pair + g;  // rows m_lo, +8 (tile 0) and +16, +24 (tile 1)
  const int ro[4] = {y1_row_words(m_lo), y1_row_words(m_lo + 8), y1_row_words(m_lo + 16),
                     y1_row_words(m_lo + 24)};

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_h * tiles_w);
    const int rem = tile % (tiles_h * tiles_w);
    const int P0 = (rem / tiles_w) * kTP, Q0 = (rem % tiles_w) * kTQ;
    const int y2r0 = 2 * P0 - 1, y2c0 = 2 * Q0 - 1;  // global origin of the y2 tile
    const int y1r0 = y2r0 - 1, y1c0 = y2c0 - 1;
    const int xr0 = y1r0 - 1, xc0 = y1c0 - 1;

    __syncthreads();  // the previous tile's readers of xs, y1s and y2s are done
    const __nv_bfloat16* xb = x + static_cast<size_t>(b) * kCin * H * W;
    for (int i = tid; i < kCin * kXH * kXW; i += kThreads) {
      const int c = i / (kXH * kXW), r = (i / kXW) % kXH, col = i % kXW;
      const int R = xr0 + r, C = xc0 + col;
      xs[i] = (R >= 0 && R < H && C >= 0 && C < W)
                  ? __bfloat162float(xb[(static_cast<size_t>(c) * H + R) * W + C])
                  : 0.f;
    }
    __syncthreads();

    // conv1_1: item = (channel group of 8, y1 position); f32 sums of the
    // 27 exact bf16 products in (u, v, c) order, then + b1, ReLU, mask.
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
        const float lo = valid ? fmaxf(acc[2 * j] + b1s[cg * 8 + 2 * j], 0.f) : 0.f;
        const float hi = valid ? fmaxf(acc[2 * j + 1] + b1s[cg * 8 + 2 * j + 1], 0.f) : 0.f;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
        packed[j] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      *reinterpret_cast<uint4*>(y1s + p * kRow + cg * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    __syncthreads();

    // conv1_2 on the tensor cores: warp = (M tiles 2*pair, 2*pair+1) x
    // (n-tiles 4*nhalf .. 4*nhalf+3).
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
          for (int t = 0; t < 2; ++t)
            mma_bf16(acc[t][j], a[t][0], a[t][1], a[t][2], a[t][3], bb0, bb1);
        }
      }
    }

    // Epilogue: + b2 in f32, ReLU, mask, round to bf16, into y2s.
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
          const float lo = valid ? fmaxf(acc[t][j][2 * half] + b2s[n], 0.f) : 0.f;
          const float hi = valid ? fmaxf(acc[t][j][2 * half + 1] + b2s[n + 1], 0.f) : 0.f;
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
          y2w[m * (kRow / 2) + n / 2] = *reinterpret_cast<const uint32_t*>(&h2);
        }
      }
    }
    __syncthreads();

    // 3x3 / 2 max pool: pooled (p, q) covers y2 local rows 2p..2p+2 and
    // cols 2q..2q+2. Consecutive threads write consecutive columns.
    __nv_bfloat16* ob = out + static_cast<size_t>(b) * kF * OH * OW;
    for (int i = tid; i < kTP * kTQ * kF; i += kThreads) {
      const int q = i % kTQ, p = (i / kTQ) % kTP, ch = i / (kTP * kTQ);
      const int P = P0 + p, Q = Q0 + q;
      if (P >= OH || Q >= OW) continue;
      float mx = 0.f;  // every y2 value is >= 0
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          mx = fmaxf(mx, __bfloat162float(y2s[((2 * p + u) * kY2W + 2 * q + v) * kRow + ch]));
      ob[(static_cast<size_t>(ch) * OH + P) * OW + Q] = __float2bfloat16_rn(mx);
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

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
