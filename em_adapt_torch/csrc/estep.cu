// Adaptive-bias E-step (EM-Adapt) for Hopper, sm_90a.
//
// Replaces the TPU kernel em_adapt_tpu/ops/estep_pallas.py::_kernel
// (launched from estep_pallas, estep_pallas.py:244). Same function:
//   1. tags: class c is present in image b iff some label equals c (labels
//      are uint8-cast outside; 255 matches no class);
//   2. suppression: an absent class scoring above the per-pixel minimum
//      over present classes is clamped to that minimum minus `margin`; the
//      minimum lifts absent channels by the global batch max `gmax`
//      (reference estep.py:46-55, quirk included);
//   3. L = num_iter * C class visits in the given order; visit t of class j
//      finds the k-th smallest `rowmax - f_j` (k = k_bg for j == 0, else
//      k_fg) by a search on the float bits and adds it to channel j.
//      diff >= 0, so its bit pattern orders like an integer and the result
//      is exactly np.partition(diff, k)[k];
//   4. a per-image shift keeps the mean of the per-pixel max.
//
// Layout: scores and out are [B, C, HW] (the model's NCHW logits as they
// are), labels [B, HW] int32, visit [L] int32, gmax [1] f32 on the device,
// thresholds [B, L] f32 (the bias added at each visit, 0 for an absent
// class).
//
// Design: one CTA of 512 threads per image. The image's [C, HW] state
// lives in dynamic shared memory (21 * 1681 * 4 = 141,204 B at 41x41).
// Thread t owns pixels t, t+512, ... of every channel, so after the first
// barrier no thread reads another's pixel: the per-pixel max and the
// visit's diff bits stay in registers, and the only barriers are the
// block-wide counts of the search. A visit of an absent class adds 0 and
// is skipped without any barrier.
//
// The search: the threshold `cand` is the least 31-bit pattern with at
// least k+1 diff patterns at or below it. Its bits are fixed from the top
// a digit of R = K1_DIGIT_BITS bits at a time (the first digit takes the
// 31 % R bits left over, or R): a round at shift s tests the 2^R - 1
// probes cand | m << s | (1 << s) - 1, m = 0 .. 2^R - 2, and the digit is
// the number of probes with fewer than k+1 patterns at or below them.
// That is the bisection's predicate on the same bits (R = 1 is the
// bisection), so the threshold is the same, in ceil(31 / R) rounds.
// Each pixel's pattern v is at or below probe m iff e <= m, where
// e = min(sat(v >> s - cand >> s), 2^R) (e = 2^R: above every probe).
// A thread counts its pixels as a thermometer code: byte m of a packed
// word counts the pixels with e <= m, computed for four bytes at once as
// bit 5 of (0x20 + m) - e (no borrow between bytes for e <= 32). A warp's
// counts (at most 128) still fit a byte, so the warp sums 2^R / 4 words
// with __reduce_add_sync; lane 0 stores them, one barrier, and lane m of
// every warp sums byte m over the 16 warps (without a branch). The buffer
// alternates between two halves, so one barrier per round suffices: a
// warp can write round t+1's counts while another still reads round t's,
// but not round t+2's before every thread has passed round t+1's barrier.
//
// What bounds it: the chain of (present visits) * ceil(31 / R) dependent
// block rounds, i.e. barrier latency plus each round's own instructions.
// Its byte bound (scores in, scores out) and operation bound are both
// below a microsecond at B = 6; with only B of 132 SMs busy the kernel is
// latency-bound.
//
// No fast-math: flush-to-zero would alter subnormal diffs and with them
// the threshold bits.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#ifndef K1_DIGIT_BITS
#define K1_DIGIT_BITS 4
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kDigitBits = K1_DIGIT_BITS;  // R
static_assert(kDigitBits >= 1 && kDigitBits <= 5, "a round's 2^R - 1 probes need <= 31 lanes");
constexpr int kRounds = (31 + kDigitBits - 1) / kDigitBits;
constexpr int kTopBits = 31 - (kRounds - 1) * kDigitBits;  // the first, shorter digit
constexpr int kWords = kDigitBits <= 2 ? 1 : 1 << (kDigitBits - 2);  // 4 one-byte counts each
constexpr unsigned kOnes = 0x01010101u;

// One round of the search: the digit at shift `s` (a round of `bits`
// bits) of the least pattern with at least k1 of the block's patterns at
// or below it, given the digits above (`cand`, zero at and below s).
// `buf` holds kWarps * kWords words; callers alternate two buffers.
template <int PPT>
__device__ __forceinline__ unsigned search_digit(const unsigned (&dbits)[PPT], unsigned cand,
                                                 int s, int bits, int k1, unsigned* buf) {
  static_assert(PPT <= 4, "a thread's byte counts (0x20 each) must stay below 0x100");
  const int lane = threadIdx.x & 31;
  const unsigned c = cand >> s;
  unsigned acc[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = 0;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const unsigned v = dbits[i] >> s;
    const unsigned d = v > c ? v - c : 0u;
    const unsigned e = d < (1u << kDigitBits) ? d : (1u << kDigitBits);
    const unsigned spread = e * kOnes;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      // byte b: 0x20 + (4w + b) - e, bit 5 set iff 4w + b >= e
      acc[w] += (0x20202020u + 4u * w * kOnes + 0x03020100u - spread) & 0x20202020u;
    }
  }
  unsigned* mine = buf + (threadIdx.x >> 5) * kWords;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const unsigned sum = __reduce_add_sync(0xffffffffu, acc[w] >> 5);
    if (lane == 0) mine[w] = sum;
  }
  __syncthreads();
  // Lane m sums byte m over the warps. Every lane loads (lanes past the
  // bytes wrap onto one): a guard would cost a branch and its
  // reconvergence each round; the ballot leaves out lanes >= probes.
  const unsigned char* bytes =
      reinterpret_cast<const unsigned char*>(buf) + (lane & (4 * kWords - 1));
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += bytes[w * kWords * 4];
  // Totals never fall as m grows: the digit is the count of probes below k1.
  const int probes = (1 << bits) - 1;
  return __popc(__ballot_sync(0xffffffffu, lane < probes && total < k1));
}

// Sum of one float per thread in a fixed order; every thread gets the
// same bits.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // earlier readers of buf are done
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += buf[w];
  return s;
}

template <int PPT>  // pixels per thread: HW <= PPT * kThreads
__global__ void __launch_bounds__(kThreads)
estep_kernel(const float* __restrict__ scores, const int* __restrict__ labels,
             const int* __restrict__ visit, const float* __restrict__ gmax_ptr,
             float* __restrict__ out, float* __restrict__ thresholds, int C, int HW,
             int L, int k_bg, int k_fg, int suppress, float margin) {
  extern __shared__ float smem[];
  float* f = smem;                                     // [C * HW]
  int* tags = reinterpret_cast<int*>(f + C * HW);      // [C]
  unsigned* counts = reinterpret_cast<unsigned*>(tags + C);       // [2][kWarps][kWords]
  float* sums = reinterpret_cast<float*>(counts + 2 * kWarps * kWords);  // [kWarps]

  const int tid = threadIdx.x;
  const size_t img = blockIdx.x;
  const float* src = scores + img * C * HW;
  const int* lab = labels + img * HW;

  for (int c = tid; c < C; c += kThreads) tags[c] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = tid + i * kThreads;
    if (p < HW) {
      const int l = lab[p];
      if (l >= 0 && l < C) atomicOr(&tags[l], 1);
    }
  }
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < HW) f[c * HW + p] = src[c * HW + p];
    }
  }
  __syncthreads();  // tags complete

  const float gmax = *gmax_ptr;
  float rowmax[PPT];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = tid + i * kThreads;
    rowmax[i] = 0.f;
    if (p >= HW) continue;
    if (suppress) {
      float pmin = f[p] + (tags[0] ? 0.f : gmax);
      for (int c = 1; c < C; ++c) pmin = fminf(pmin, f[c * HW + p] + (tags[c] ? 0.f : gmax));
      for (int c = 0; c < C; ++c) {
        if (!tags[c] && f[c * HW + p] > pmin) f[c * HW + p] = pmin - margin;
      }
    }
    float m = f[p];
    for (int c = 1; c < C; ++c) m = fmaxf(m, f[c * HW + p]);
    rowmax[i] = m;
    part += m;
  }
  const float inv_hw = 1.0f / static_cast<float>(HW);
  const float before = block_sum(part, sums) * inv_hw;

  int phase = 0;
  for (int t = 0; t < L; ++t) {
    const int j = visit[t];
    if (!tags[j]) {
      if (tid == 0) thresholds[img * L + t] = 0.f;
      continue;
    }
    float* fj = f + j * HW;
    unsigned dbits[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      // Pixels past HW get a pattern above every probe (probes < 2^31).
      dbits[i] = p < HW ? __float_as_uint(rowmax[i] - fj[p]) : 0xffffffffu;
    }
    const int k1 = (j == 0 ? k_bg : k_fg) + 1;
    unsigned cand = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int bits = r == 0 ? kTopBits : kDigitBits;
      const int s = 31 - kTopBits - r * kDigitBits;
      cand |= search_digit<PPT>(dbits, cand, s, bits, k1, counts + phase * kWarps * kWords) << s;
      phase ^= 1;
    }
    const float th = __uint_as_float(cand);
    if (tid == 0) thresholds[img * L + t] = th;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < HW) {
        const float v = fj[p] + th;
        fj[p] = v;
        rowmax[i] = fmaxf(rowmax[i], v);
      }
    }
  }

  part = 0.f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (tid + i * kThreads < HW) part += rowmax[i];
  }
  const float after = block_sum(part, sums) * inv_hw;
  const float shift = before - after;
  float* dst = out + img * C * HW;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < HW) dst[c * HW + p] = f[c * HW + p] + shift;
    }
  }
}

// Lets estep_kernel<PPT> take the device's whole opt-in shared memory.
// Set once per device (the attribute persists), not on every launch.
template <int PPT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(estep_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int PPT>
cudaError_t launch(const float* scores, const int* labels, const int* visit,
                   const float* gmax, float* out, float* thresholds, int B, int C,
                   int HW, int L, int k_bg, int k_fg, int suppress, float margin,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem<PPT>();
  if (err != cudaSuccess) return err;
  estep_kernel<PPT><<<B, kThreads, smem, stream>>>(scores, labels, visit, gmax, out,
                                                   thresholds, C, HW, L, k_bg, k_fg,
                                                   suppress, margin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one image needs, in bytes.
size_t em_estep_smem_bytes(int C, int HW) {
  return sizeof(float) * static_cast<size_t>(C) * HW + sizeof(int) * C +
         sizeof(unsigned) * 2 * kWarps * kWords + sizeof(float) * kWarps;
}

// R, the bits of the threshold each block round fixes (K1_DIGIT_BITS).
int em_estep_digit_bits() { return kDigitBits; }

int em_estep_max_pixels() { return 4 * kThreads; }

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
int em_estep_launch(const float* scores, const int* labels, const int* visit,
                    const float* gmax, float* out, float* thresholds, int B, int C, int HW,
                    int L, int k_bg, int k_fg, int suppress, float margin, void* stream) {
  if (B == 0) return 0;
  const size_t smem = em_estep_smem_bytes(C, HW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HW <= kThreads)
    return launch<1>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                     suppress, margin, smem, s);
  if (HW <= 2 * kThreads)
    return launch<2>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                     suppress, margin, smem, s);
  if (HW <= 4 * kThreads)
    return launch<4>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                     suppress, margin, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
