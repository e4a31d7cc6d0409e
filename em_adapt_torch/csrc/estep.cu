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
// Large score maps: one image over a thread block cluster of N CTAs. A
// 65x65 map (the 513x513 input's) holds 21 * 4225 * 4 = 354,900 B, more
// than one block's 227 KB, and 4225 pixels, more than 512 threads take at
// four pixels each. The launcher takes the least N (at most 8, the
// portable cluster size) for which ceil(HW / N) pixels fit a CTA: four a
// thread and the block's shared memory (N = 1 up to 2048 pixels at 21
// classes; N = 3 at 65x65, 1409 pixels and 121,212 B a CTA). CTA rank r
// holds the 21 channels of pixels [r * chunk, r * chunk + chunk), so
// each pixel's state stays in one CTA, and only four things cross CTAs,
// all through distributed shared memory:
//   - the tags: each CTA ORs its own pixels' labels, then every CTA ORs
//     the N sets after the first cluster barrier;
//   - a round's per-probe counts: after the block's count, warp 0 writes
//     its 32 totals into slot [phase][rank] of every CTA, one cluster
//     barrier, and each CTA sums the N slots (32-bit: a cluster counts up
//     to 16,384 pixels). The phase alternates as the byte buffer's does,
//     so one cluster barrier a round suffices: a CTA writes round t+2's
//     slots only after every CTA has passed round t+1's barrier, by which
//     time round t's slots have been read;
//   - the two means of the final shift: each CTA's block sum into slot
//     [rank] of every CTA, one cluster barrier, and a sum in rank order,
//     so that every CTA gets the same bits;
//   - nothing else: rank 0 writes the thresholds, each CTA its own pixels.
// N = 1 is launched without a cluster and runs the kernel above unchanged.
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
// block rounds, i.e. barrier latency plus each round's own instructions
// (and in a cluster, a cluster barrier a round). Its byte bound (scores
// in, scores out) and operation bound are both below a microsecond at
// B = 6 (a few at 65x65); with only B (or B * N) of 132 SMs busy the
// kernel is latency-bound.
//
// No fast-math: flush-to-zero would alter subnormal diffs and with them
// the threshold bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#ifndef K1_DIGIT_BITS
#define K1_DIGIT_BITS 4
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerCta = 4 * kThreads;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr size_t kMaxSmemBytes = 232448;  // a block's opt-in shared memory on Hopper

constexpr int kDigitBits = K1_DIGIT_BITS;  // R
static_assert(kDigitBits >= 1 && kDigitBits <= 5, "a round's 2^R - 1 probes need <= 31 lanes");
constexpr int kRounds = (31 + kDigitBits - 1) / kDigitBits;
constexpr int kTopBits = 31 - (kRounds - 1) * kDigitBits;  // the first, shorter digit
constexpr int kWords = kDigitBits <= 2 ? 1 : 1 << (kDigitBits - 2);  // 4 one-byte counts each
constexpr unsigned kOnes = 0x01010101u;

// One round of the search: the digit at shift `s` (a round of `bits`
// bits) of the least pattern with at least k1 of the image's patterns at
// or below it, given the digits above (`cand`, zero at and below s).
// `buf` holds kWarps * kWords words; callers alternate two buffers. In a
// cluster (kCluster) the image's count is the sum of its `ncta` CTAs'
// counts, exchanged through `slots` ([kMaxCluster][32] ints, alternated
// with `buf`).
template <int PPT, bool kCluster>
__device__ __forceinline__ unsigned search_digit(const unsigned (&dbits)[PPT], unsigned cand,
                                                 int s, int bits, int k1, unsigned* buf,
                                                 int* slots, int ncta, int rank) {
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
  if constexpr (kCluster) {
    // Warp 0 writes this CTA's totals into every CTA's slot row `rank`.
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x < 32) {
      for (int r = 0; r < ncta; ++r) *cluster.map_shared_rank(slots + rank * 32 + lane, r) = total;
    }
    cluster.sync();
    total = 0;
    for (int r = 0; r < ncta; ++r) total += slots[r * 32 + lane];
  }
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

// The sum of one float over the cluster's CTAs (`v`, the same in every
// thread of a CTA), in rank order, so that every CTA gets the same bits.
// `slots` holds kMaxCluster floats.
__device__ __forceinline__ float cluster_sum(float v, float* slots, int ncta, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    for (int r = 0; r < ncta; ++r) *cluster.map_shared_rank(slots + rank, r) = v;
  }
  cluster.sync();
  float s = slots[0];
  for (int r = 1; r < ncta; ++r) s += slots[r];
  return s;
}

// Dynamic shared memory of one CTA holding `chunk` pixels of C channels,
// in a cluster of `ncta` CTAs.
size_t smem_bytes(int C, int chunk, int ncta) {
  size_t bytes = sizeof(float) * static_cast<size_t>(C) * chunk + sizeof(int) * C +
                 sizeof(unsigned) * 2 * kWarps * kWords + sizeof(float) * kWarps;
  if (ncta > 1)  // own tags, the count slots, the mean slots
    bytes += sizeof(int) * C + sizeof(int) * 2 * kMaxCluster * 32 + sizeof(float) * 2 * kMaxCluster;
  return bytes;
}

// The least cluster size whose CTAs each hold ceil(HW / N) pixels; 0 if
// none of at most kMaxCluster CTAs does.
int cluster_size(int C, int HW) {
  for (int n = 1; n <= kMaxCluster; ++n) {
    const int chunk = (HW + n - 1) / n;
    if (chunk <= kMaxPixelsPerCta && smem_bytes(C, chunk, n) <= kMaxSmemBytes) return n;
  }
  return 0;
}

// PPT: pixels per thread, chunk <= PPT * kThreads. kCluster: the image is
// spread over a cluster of CTAs, each holding `chunk` of its pixels
// (without, chunk == HW and the grid is one CTA per image).
template <int PPT, bool kCluster>
__global__ void __launch_bounds__(kThreads)
estep_kernel(const float* __restrict__ scores, const int* __restrict__ labels,
             const int* __restrict__ visit, const float* __restrict__ gmax_ptr,
             float* __restrict__ out, float* __restrict__ thresholds, int C, int HW,
             int L, int k_bg, int k_fg, int suppress, float margin, int chunk) {
  int ncta = 1, rank = 0;
  if constexpr (kCluster) {
    ncta = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  } else {
    chunk = HW;
  }
  extern __shared__ float smem[];
  float* f = smem;                                     // [C * chunk]
  int* tags = reinterpret_cast<int*>(f + C * chunk);   // [C]
  unsigned* counts = reinterpret_cast<unsigned*>(tags + C);       // [2][kWarps][kWords]
  float* sums = reinterpret_cast<float*>(counts + 2 * kWarps * kWords);  // [kWarps]
  int* own_tags = reinterpret_cast<int*>(sums + kWarps);          // [C], cluster only
  int* slots = own_tags + C;                                      // [2][kMaxCluster][32]
  float* mean_slots = reinterpret_cast<float*>(slots + 2 * kMaxCluster * 32);  // [2][kMaxCluster]

  const int tid = threadIdx.x;
  const size_t img = blockIdx.x / ncta;
  const int base = rank * chunk;          // this CTA's first pixel
  const int n = min(chunk, HW - base);    // and how many it holds
  const float* src = scores + img * C * HW + base;
  const int* lab = labels + img * HW + base;
  int* my_tags = kCluster ? own_tags : tags;

  for (int c = tid; c < C; c += kThreads) my_tags[c] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = tid + i * kThreads;
    if (p < n) {
      const int l = lab[p];
      if (l >= 0 && l < C) atomicOr(&my_tags[l], 1);
    }
  }
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < n) f[c * chunk + p] = src[c * HW + p];
    }
  }
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's own tags complete
    for (int c = tid; c < C; c += kThreads) {
      int t = 0;
      for (int r = 0; r < ncta; ++r) t |= *cluster.map_shared_rank(own_tags + c, r);
      tags[c] = t;
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
    if (p >= n) continue;
    if (suppress) {
      float pmin = f[p] + (tags[0] ? 0.f : gmax);
      for (int c = 1; c < C; ++c) pmin = fminf(pmin, f[c * chunk + p] + (tags[c] ? 0.f : gmax));
      for (int c = 0; c < C; ++c) {
        if (!tags[c] && f[c * chunk + p] > pmin) f[c * chunk + p] = pmin - margin;
      }
    }
    float m = f[p];
    for (int c = 1; c < C; ++c) m = fmaxf(m, f[c * chunk + p]);
    rowmax[i] = m;
    part += m;
  }
  const float inv_hw = 1.0f / static_cast<float>(HW);
  float before = block_sum(part, sums);
  if constexpr (kCluster) before = cluster_sum(before, mean_slots, ncta, rank);
  before *= inv_hw;

  int phase = 0;
  for (int t = 0; t < L; ++t) {
    const int j = visit[t];
    if (!tags[j]) {
      if (tid == 0 && rank == 0) thresholds[img * L + t] = 0.f;
      continue;
    }
    float* fj = f + j * chunk;
    unsigned dbits[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      // Pixels past the CTA's get a pattern above every probe (probes < 2^31).
      dbits[i] = p < n ? __float_as_uint(rowmax[i] - fj[p]) : 0xffffffffu;
    }
    const int k1 = (j == 0 ? k_bg : k_fg) + 1;
    unsigned cand = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int bits = r == 0 ? kTopBits : kDigitBits;
      const int s = 31 - kTopBits - r * kDigitBits;
      cand |= search_digit<PPT, kCluster>(dbits, cand, s, bits, k1,
                                          counts + phase * kWarps * kWords,
                                          slots + phase * kMaxCluster * 32, ncta, rank)
              << s;
      phase ^= 1;
    }
    const float th = __uint_as_float(cand);
    if (tid == 0 && rank == 0) thresholds[img * L + t] = th;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < n) {
        const float v = fj[p] + th;
        fj[p] = v;
        rowmax[i] = fmaxf(rowmax[i], v);
      }
    }
  }

  part = 0.f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (tid + i * kThreads < n) part += rowmax[i];
  }
  float after = block_sum(part, sums);
  if constexpr (kCluster) after = cluster_sum(after, mean_slots + kMaxCluster, ncta, rank);
  after *= inv_hw;
  const float shift = before - after;
  float* dst = out + img * C * HW + base;
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = tid + i * kThreads;
      if (p < n) dst[c * HW + p] = f[c * chunk + p] + shift;
    }
  }
  // No CTA touches another's shared memory after the last cluster barrier,
  // so a CTA may exit while the others still write their pixels.
}

// Lets estep_kernel<PPT, kCluster> take the device's whole opt-in shared
// memory. Set once per device (the attribute persists), not on every launch.
template <int PPT, bool kCluster>
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
  err = cudaFuncSetAttribute(estep_kernel<PPT, kCluster>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// One CTA per image (ncta == 1), or one cluster of ncta CTAs per image,
// each holding `chunk` pixels.
template <int PPT>
cudaError_t launch(const float* scores, const int* labels, const int* visit,
                   const float* gmax, float* out, float* thresholds, int B, int C,
                   int HW, int L, int k_bg, int k_fg, int suppress, float margin,
                   int ncta, int chunk, size_t smem, cudaStream_t stream) {
  if (ncta == 1) {
    const cudaError_t err = allow_smem<PPT, false>();
    if (err != cudaSuccess) return err;
    estep_kernel<PPT, false><<<B, kThreads, smem, stream>>>(scores, labels, visit, gmax, out,
                                                            thresholds, C, HW, L, k_bg, k_fg,
                                                            suppress, margin, chunk);
    return cudaGetLastError();
  }
  const cudaError_t err = allow_smem<PPT, true>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * ncta);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched =
      cudaLaunchKernelEx(&config, estep_kernel<PPT, true>, scores, labels, visit, gmax, out,
                         thresholds, C, HW, L, k_bg, k_fg, suppress, margin, chunk);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes, at the cluster size the
// launcher takes for C x HW (at kMaxCluster CTAs where none fits).
size_t em_estep_smem_bytes(int C, int HW) {
  const int n = cluster_size(C, HW);
  const int ncta = n ? n : kMaxCluster;
  return smem_bytes(C, (HW + ncta - 1) / ncta, ncta);
}

// R, the bits of the threshold each block round fixes (K1_DIGIT_BITS).
int em_estep_digit_bits() { return kDigitBits; }

// The most pixels an image may have: kMaxCluster CTAs at four a thread.
int em_estep_max_pixels() { return kMaxCluster * kMaxPixelsPerCta; }

// CTAs per image for C x HW (1: one CTA, no cluster); 0 if the image does
// not fit a cluster of kMaxCluster.
int em_estep_cluster_size(int C, int HW) { return cluster_size(C, HW); }

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
int em_estep_launch(const float* scores, const int* labels, const int* visit,
                    const float* gmax, float* out, float* thresholds, int B, int C, int HW,
                    int L, int k_bg, int k_fg, int suppress, float margin, void* stream) {
  if (B == 0) return 0;
  const int ncta = cluster_size(C, HW);
  if (ncta == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (HW + ncta - 1) / ncta;
  const size_t smem = smem_bytes(C, chunk, ncta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk <= kThreads)
    return launch<1>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                     suppress, margin, ncta, chunk, smem, s);
  if (chunk <= 2 * kThreads)
    return launch<2>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                     suppress, margin, ncta, chunk, smem, s);
  return launch<4>(scores, labels, visit, gmax, out, thresholds, B, C, HW, L, k_bg, k_fg,
                   suppress, margin, ncta, chunk, smem, s);
}

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
