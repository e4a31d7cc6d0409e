// The card CRF's separable Gaussian filter (K4) for Hopper, sm_90a.
//
// Replaces no TPU kernel. em_adapt_tpu/eval/crf_tpu.py::_filter1d is jnp
// that XLA fuses into one pass an axis; the port's plain version
// (em_adapt_torch/eval/crf_device.py::_filter1d_plain) makes one multiply
// pass and 2r narrow-and-add passes on strided views an axis, each of
// which reads `out` and `x` and writes `out`. On the bilateral grid
// (5 taps, 22 f32 channels, 1.5 GB at eval batch 6) that is about 14
// grid-sized transfers an axis where 2 suffice; this kernel reads each
// input element once and writes each output element once.
//
// Function: out[i] = sum_d taps[r + d] * x[i + d] along one axis of a
// contiguous f32 tensor viewed as [outer, n, inner], zero padding (terms
// outside the axis are skipped), accumulated in the plain version's order
// and rounding: x[i] * taps[r], then for d = 1 .. r an fma of
// taps[r - d] * x[i - d] and one of taps[r + d] * x[i + d].
//
// Bound: bytes, 8 B an element (one f32 read, one written) at 3.35 TB/s;
// 2r + 1 FMA an element is far below the card's arithmetic rate.
//
// Two walks, which the launcher picks from the shape:
//  - the column walk, for rows of at least kNarrow floats (every grid
//    axis but the last; the spatial filter's first axis): a thread owns
//    V = 4 consecutive floats of a row (float4, where inner % 4 == 0 and
//    both pointers are 16-B aligned; else V = 1) and walks along n,
//    keeping the last 2r + 1 rows it read in a ring of its own in shared
//    memory (no barrier), and the next row in a register, loaded while it
//    computes the current one. Neighbouring threads own neighbouring
//    vectors of a row, so each step's loads and stores are coalesced.
//    Where the columns are too few to fill the card (the spatial filter's
//    first axis, 6 x 2,688 vectors), the axis is cut into chunks of rows,
//    each of which reads the r rows beyond its ends once more (from L2);
//  - the slab walk, for narrower rows (the grid's last axis, 22 floats;
//    the spatial filter's last, 21): a CTA loads whole [n, inner] slabs,
//    contiguous in memory (52 x 22 floats, 4,576 B, on the grid), into
//    shared memory with 16-B loads where aligned, then writes each output
//    from shared memory, neighbouring threads on neighbouring floats.
//
// The taps (at most 2 * kMaxRadius + 1) lie on the card; each CTA copies
// them into the head of its shared memory, where every read of a tap is a
// broadcast.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRadius = 255;
// Rows narrower than this many floats take the slab walk.
constexpr int kNarrow = 32;
constexpr int kThreads = 256;
// Shared memory a slab CTA fills at most, unless one slab is larger.
constexpr int kSlabTarget = 32 * 1024;
// Dynamic shared memory a block may use on Hopper (227 KB opt-in).
constexpr int kMaxSmem = 232448;
// Threads an SM holds; the column walk cuts rows into chunks below twice
// the card's worth of columns.
constexpr int kThreadsPerSm = 2048;
constexpr int kMinChunkRows = 16;

// Bytes of shared memory before a CTA's data: the taps, to 16 B.
__host__ __device__ constexpr int tap_bytes(int r) { return (2 * r + 1 + 3) / 4 * 16; }

__device__ __forceinline__ float vmul(float x, float t) { return __fmul_rn(x, t); }
__device__ __forceinline__ float4 vmul(float4 x, float t) {
  return make_float4(__fmul_rn(x.x, t), __fmul_rn(x.y, t), __fmul_rn(x.z, t), __fmul_rn(x.w, t));
}
__device__ __forceinline__ float vfma(float t, float x, float acc) { return __fmaf_rn(t, x, acc); }
__device__ __forceinline__ float4 vfma(float t, float4 x, float4 acc) {
  return make_float4(__fmaf_rn(t, x.x, acc.x), __fmaf_rn(t, x.y, acc.y),
                     __fmaf_rn(t, x.z, acc.z), __fmaf_rn(t, x.w, acc.w));
}

// Copies taps[0 .. 2r] into the head of the CTA's shared memory; the
// caller passes the barrier before reading them.
__device__ __forceinline__ float* load_taps(unsigned char* smem, const float* taps, int r) {
  float* tap = reinterpret_cast<float*>(smem);
  for (int j = threadIdx.x; j < 2 * r + 1; j += blockDim.x) tap[j] = taps[j];
  return tap;
}

// Column walk. Thread `col` (of outer * row_vecs) owns vector col % row_vecs
// of the rows of slab col / row_vecs, and computes rows [k0, k1) of it, the
// chunk of blockIdx.y. Its ring: slot j holds row k0 - r + j (mod 2r + 1),
// at ring[j * blockDim.x + threadIdx.x], after the taps.
template <typename V>
__global__ void __launch_bounds__(kThreads)
crf_filter_walk(const float* __restrict__ x, float* __restrict__ out, long long columns,
                long long row_vecs, int n, int chunk, const float* __restrict__ taps, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tap = load_taps(smem, taps, r);
  __syncthreads();
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= columns) return;
  const long long slab = col / row_vecs;
  const long long start = slab * n * row_vecs + (col - slab * row_vecs);
  const V* src = reinterpret_cast<const V*>(x) + start;  // row k at src[k * row_vecs]
  V* dst = reinterpret_cast<V*>(out) + start;
  V* ring = reinterpret_cast<V*>(smem + tap_bytes(r)) + threadIdx.x;
  const int stride = blockDim.x;
  const int w = 2 * r + 1;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(n, k0 + chunk);
  for (int j = 0; j < 2 * r; ++j) {
    const int k = k0 - r + j;
    if (k >= 0 && k < n) ring[j * stride] = src[static_cast<long long>(k) * row_vecs];
  }
  V next = V();
  if (k0 + r < n) next = src[static_cast<long long>(k0 + r) * row_vecs];
  const int dmax = min(r, n - 1);
  int centre = r;    // slot of row k
  int last = 2 * r;  // slot of row k + r
  for (int k = k0; k < k1; ++k) {
    ring[last * stride] = next;  // row k + r (never read where it lies past the axis)
    if (k + 1 < k1 && k + 1 + r < n) next = src[static_cast<long long>(k + 1 + r) * row_vecs];
    V acc = vmul(ring[centre * stride], tap[r]);
    for (int d = 1; d <= dmax; ++d) {
      if (k - d >= 0) {
        const int s = centre - d < 0 ? centre - d + w : centre - d;
        acc = vfma(tap[r - d], ring[s * stride], acc);
      }
      if (k + d < n) {
        const int s = centre + d >= w ? centre + d - w : centre + d;
        acc = vfma(tap[r + d], ring[s * stride], acc);
      }
    }
    dst[static_cast<long long>(k) * row_vecs] = acc;
    centre = centre + 1 == w ? 0 : centre + 1;
    last = last + 1 == w ? 0 : last + 1;
  }
}

// Slab walk. CTA b owns slabs [b * per_cta, b * per_cta + per_cta) of
// [n, inner] floats each, contiguous in memory, held after the taps;
// `vec4`: their floats are a multiple of 4 and x is 16-B aligned.
__global__ void __launch_bounds__(kThreads)
crf_filter_slab(const float* __restrict__ x, float* __restrict__ out, long long slabs, int n,
                int inner, int per_cta, int vec4, const float* __restrict__ taps, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tap = load_taps(smem, taps, r);
  float* s = reinterpret_cast<float*>(smem + tap_bytes(r));
  const long long slab_len = static_cast<long long>(n) * inner;
  const long long first = static_cast<long long>(blockIdx.x) * per_cta;
  const int count = static_cast<int>(min(static_cast<long long>(per_cta), slabs - first));
  const int len = count * n * inner;
  const float* src = x + first * slab_len;
  float* dst = out + first * slab_len;
  if (vec4) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int e = threadIdx.x; e < len / 4; e += blockDim.x) s4[e] = src4[e];
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x) s[e] = src[e];
  }
  __syncthreads();
  // Element e is (slab, k, i); k and i advance with e, without a division.
  const int step = blockDim.x;
  const int dk = step / inner, di = step % inner;
  int i = threadIdx.x % inner;
  int k = (threadIdx.x / inner) % n;
  const int dmax = min(r, n - 1);
  for (int e = threadIdx.x; e < len; e += step) {
    float acc = vmul(s[e], tap[r]);
    for (int d = 1; d <= dmax; ++d) {
      if (k - d >= 0) acc = vfma(tap[r - d], s[e - d * inner], acc);
      if (k + d < n) acc = vfma(tap[r + d], s[e + d * inner], acc);
    }
    dst[e] = acc;
    i += di;
    k += dk;
    if (i >= inner) {
      i -= inner;
      ++k;
    }
    while (k >= n) k -= n;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Threads of a column-walk CTA whose rings of 2r + 1 vectors of `vec_bytes`
// fit the block's shared memory beside the taps: at most kThreads, a
// multiple of 32 (0 where 32 do not fit).
int walk_threads(int r, int vec_bytes) {
  const int fit = (kMaxSmem - tap_bytes(r)) / ((2 * r + 1) * vec_bytes) / 32 * 32;
  return fit < kThreads ? fit : kThreads;
}

// The card's SM count, queried at the first launch and kept.
cudaError_t sm_count(int* sms) {
  static int known = 0;
  if (known == 0) {
    int dev = 0, got = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    known = got;
  }
  *sms = known;
  return cudaSuccess;
}

template <typename V>
cudaError_t launch_walk(const float* x, float* out, long long outer, int n, long long inner,
                        const float* taps, int r, int threads, cudaStream_t stream) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  const long long row_vecs = inner / kVec;
  const long long columns = outer * row_vecs;
  // Chunks of rows, where the columns alone leave the card under-filled.
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int chunks = 1;
  const long long want = 2LL * sms * kThreadsPerSm;
  if (columns < want) {
    const int min_rows = 4 * r > kMinChunkRows ? 4 * r : kMinChunkRows;
    const long long by_rows = (n + min_rows - 1) / min_rows;
    const long long by_cols = (want + columns - 1) / columns;
    chunks = static_cast<int>(by_rows < by_cols ? by_rows : by_cols);
    if (chunks < 1) chunks = 1;
  }
  const int chunk = (n + chunks - 1) / chunks;
  chunks = (n + chunk - 1) / chunk;
  const size_t smem = tap_bytes(r) + static_cast<size_t>(2 * r + 1) * sizeof(V) * threads;
  err = allow_smem(crf_filter_walk<V>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((columns + threads - 1) / threads),
                  static_cast<unsigned>(chunks));
  crf_filter_walk<V><<<grid, threads, smem, stream>>>(x, out, columns, row_vecs, n, chunk, taps,
                                                      r);
  return cudaGetLastError();
}

// Whether [outer, n, inner] at radius r takes the slab walk (else the
// column walk): rows narrower than kNarrow floats, a slab that fits.
bool is_slab(int n, long long inner, int r) {
  return inner < kNarrow && static_cast<long long>(n) * inner * 4 <= kMaxSmem - tap_bytes(r);
}

}  // namespace

extern "C" {

// out = the zero-padded correlation of x with taps[0 .. 2r] (on the card)
// along the middle axis of [outer, n, inner] (contiguous f32, out not x),
// launched on `stream`. Returns the CUDA error code of the launch (0 = ok;
// cudaErrorInvalidValue for a radius above kMaxRadius).
int em_crf_filter_launch(const float* x, float* out, long long outer, int n, long long inner,
                         const float* taps, int r, void* stream) {
  if (r < 0 || r > kMaxRadius || outer < 0 || n < 0 || inner < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (outer == 0 || n == 0 || inner == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_slab(n, inner, r)) {
    const long long slab_bytes = static_cast<long long>(n) * inner * 4;
    const int per_cta = slab_bytes >= kSlabTarget ? 1 : static_cast<int>(kSlabTarget / slab_bytes);
    const size_t smem = tap_bytes(r) + static_cast<size_t>(per_cta) * slab_bytes;
    const int vec4 = (static_cast<long long>(n) * inner) % 4 == 0 && aligned16(x);
    cudaError_t err = allow_smem(crf_filter_slab, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long ctas = (outer + per_cta - 1) / per_cta;
    crf_filter_slab<<<static_cast<unsigned>(ctas), kThreads, smem, s>>>(
        x, out, outer, n, static_cast<int>(inner), per_cta, vec4, taps, r);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads4 = walk_threads(r, 16);
  if (inner % 4 == 0 && aligned16(x) && aligned16(out) && threads4 >= 32)
    return static_cast<int>(launch_walk<float4>(x, out, outer, n, inner, taps, r, threads4, s));
  return static_cast<int>(
      launch_walk<float>(x, out, outer, n, inner, taps, r, walk_threads(r, 4), s));
}

const char* em_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
