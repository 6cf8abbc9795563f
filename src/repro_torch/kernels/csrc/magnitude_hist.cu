// Streaming magnitude histogram for the threshold top-k pipeline (Hopper).
//
// Replaces the Pallas TPU kernel repro/kernels/magnitude_hist.py
// (`magnitude_hist`): counts_ge[j] = #{ i : |g[i]| >= edges[j] } over a
// flat gradient, for strictly positive, non-increasing edges. NaN and
// elements below the last edge never count. Counts are int32, exact up to
// 2^31 - 1 per edge (the reference's f32 counts are exact only up to 2^24).
//
// Bound on an H100: one read of g (4 bytes per element for f32, 2 for
// bf16); the edges and counts are a few hundred bytes. At the cnn width
// (d = 1,663,370 f32, 6.65 MB) that is 1.99 us at 3.35 TB/s, at a pod
// shard (d = 832,512) 0.99 us: less than two launch latencies, so the
// design spends its effort on one launch and on keeping loads in flight.
//
// Design.
// - One launch per call. The caller keeps an int32 workspace of
//   MAX_EDGES + 1 words per (device, stream), zero between calls: bins
//   [0, MAX_EDGES) and a done counter at [MAX_EDGES]. Each CTA adds its
//   non-empty bins to the workspace with global atomics, fences, and bumps
//   the counter; the CTA that finishes last reads the bins back from L2,
//   writes counts_ge as their inclusive scan and sets the bins and the
//   counter back to 0 for the next call. No fill kernel, no second kernel,
//   and a captured launch replays correctly.
// - 16-byte loads, several in flight. The caller splits g into a scalar
//   head (up to the first 16-byte boundary), `nvec` 16-byte vectors (4 f32
//   or 8 bf16) and a scalar tail; block 0 places the head and tail. Each
//   thread issues LOADS = 2 vector loads before it searches any of them,
//   and searches all of their elements together one step at a time, so
//   the dependent shared-memory loads of the searches overlap. The first
//   loads go out before the CTA fetches the edges, and each grid-stride
//   step's loads before the search of the step before. `grid_size` makes
//   the grid a multiple of the SM count (4 CTAs per SM at both widths of
//   the main paths), so the vector is spread evenly over the card. Two
//   loads per thread over more CTAs measured faster than four over fewer.
// - "First edge reached" is a branch-free binary search over the edges in
//   shared memory, padded with -inf to `span` (a power of two above
//   n_edges): the number of leading edges e with !(e <= |x|), which stops
//   at n_edges for any |x| but NaN (whose compares are all false, so it
//   runs past n_edges and is dropped).
// - No contention inside a warp. Heavy-tailed gradients put most elements
//   of a warp in a few bins, and lanes adding to one shared word serialise.
//   So the CTA keeps `cols` copies of the bins side by side ([n_edges]
//   [cols] ints, 32 copies where they fit in SMEM_BYTES, 8 at MAX_EDGES),
//   and lane l adds to copy l % cols: the lanes of a warp hit distinct
//   words in distinct banks whatever their bins, one shared atomic each.
//   The copies are summed before the global flush. Integer adds make the
//   result independent of order. This measured faster than a copy per
//   warp with __match_any_sync aggregation (one leader add per distinct
//   bin).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define MAX_EDGES 1024
#define THREADS 256
#define BLOCKS_PER_SM 4   // resident CTAs per SM the grid is sized for
#define SMEM_BYTES 40960  // dynamic shared memory per CTA, at most
#define LOADS 2           // 16-byte loads in flight per thread

// Elements per 16-byte vector.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The f32 values of one 16-byte vector of T (little endian: the lower half
// of a 32-bit word is the lower-addressed bf16; bf16 -> f32 is a shift).
__device__ __forceinline__ void unpack(uint4 v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float* out, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One step of the branch-free search: pos counts the leading edges with
// !(e <= mag); `step` halves from span / 2 down to 1.
__device__ __forceinline__ int search_step(const float* e, int pos, int step,
                                           float mag) {
  return pos + ((e[pos + step - 1] <= mag) ? 0 : step);
}

// Adds one element in bin j (j >= n_edges: no bin) to column `col` of the
// CTA's bins [n_edges][cols]: its lane's, so lanes of a warp hit distinct
// banks.
__device__ __forceinline__ void count(int* bins, int j, int n_edges,
                                      int cols, int col) {
  if (j < n_edges) atomicAdd(&bins[j * cols + col], 1);
}

// Loads the LOADS vectors of one grid-stride step (lane + u * nthr past
// `base`); past the end: zeros, which are below every (positive) edge.
__device__ __forceinline__ void load_step(uint4* v, const uint4* gv,
                                          int64_t base, int64_t nthr,
                                          int64_t nvec, int lane) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int64_t i = base + lane + u * nthr;
    v[u] = i < nvec ? __ldg(gv + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
hist_kernel(const T* __restrict__ g, int head, int64_t nvec, int tail,
            const float* __restrict__ edges, int n_edges, int span,
            int cols, int* __restrict__ ws, int* __restrict__ counts_ge) {
  constexpr int N = Vec<T>::N, E = N * LOADS;
  extern __shared__ int smem[];
  float* s_edges = reinterpret_cast<float*>(smem);    // [span]
  int* s_bins = smem + span;                          // [n_edges][cols]
  __shared__ bool s_last;

  // the first step's loads go out before the edges are fetched, so the two
  // memory latencies overlap; the loop bound is the same for every lane of
  // a warp
  const int lane = threadIdx.x & 31;
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  const int64_t nthr = (int64_t)gridDim.x * THREADS;
  const int64_t stride = LOADS * nthr;
  int64_t base = (int64_t)blockIdx.x * THREADS + (threadIdx.x & ~31);
  uint4 v[LOADS];
  if (base < nvec) load_step(v, gv, base, nthr, nvec, lane);

  for (int j = threadIdx.x; j < span; j += THREADS)
    s_edges[j] = j < n_edges ? __ldg(edges + j) : -INFINITY;
  for (int j = threadIdx.x; j < n_edges * cols; j += THREADS) s_bins[j] = 0;
  __syncthreads();

  const int col = lane & (cols - 1);
  const int half = span >> 1;

  // scalar head and tail (fewer than 2 N elements): block 0
  if (blockIdx.x == 0) {
    const int s = threadIdx.x;
    int j = n_edges;
    if (s < head + tail) {
      const int64_t i = s < head ? s : head + nvec * N + (s - head);
      const float mag = fabsf(to_f32(g[i]));
      int pos = 0;
      for (int step = half; step > 0; step >>= 1)
        pos = search_step(s_edges, pos, step, mag);
      j = pos;
    }
    count(s_bins, j, n_edges, cols, col);
  }

  // the 16-byte body: each step's loads are in flight during the search of
  // the step before
  for (; base < nvec; base += stride) {
    float mag[E];
    int pos[E];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) unpack(v[u], mag + u * N, T());
    if (base + stride < nvec)
      load_step(v, gv, base + stride, nthr, nvec, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mag[e] = fabsf(mag[e]);
      pos[e] = 0;
    }
    for (int step = half; step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        pos[e] = search_step(s_edges, pos[e], step, mag[e]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) count(s_bins, pos[e], n_edges, cols, col);
  }
  __syncthreads();

  // flush: the lane columns summed (thread j starts at column j, so a warp's
  // reads hit distinct banks), one global atomic per non-empty bin
  for (int j = threadIdx.x; j < n_edges; j += THREADS) {
    int c = 0;
    for (int k = 0; k < cols; ++k)
      c += s_bins[j * cols + ((j + k) & (cols - 1))];
    if (c) atomicAdd(&ws[j], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&ws[MAX_EDGES], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last || threadIdx.x >= 32) return;

  // the last CTA: counts_ge = inclusive scan of the bins (read from L2),
  // then bins and done counter back to zero for the next call
  __threadfence();
  int carry = 0;
  for (int j0 = 0; j0 < n_edges; j0 += 32) {
    const int j = j0 + lane;
    int c = 0;
    if (j < n_edges) {
      c = __ldcg(ws + j);
      ws[j] = 0;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c += u;
    }
    if (j < n_edges) counts_ge[j] = carry + c;
    carry += __shfl_sync(0xffffffffu, c, 31);
  }
  if (lane == 0) ws[MAX_EDGES] = 0;
}

// CTAs for nvec vectors at LOADS vectors per thread: enough for one pass,
// at least 1; above one CTA per SM, a multiple of the SM count (so every SM
// gets the same share), capped at BLOCKS_PER_SM per SM (the grid-stride
// loop does the rest).
static int grid_size(long long nvec, int sms) {
  const long long want = nvec / (THREADS * LOADS) +
                         (nvec % (THREADS * LOADS) != 0);
  if (want <= sms) return want > 1 ? (int)want : 1;
  const long long even = (want + sms - 1) / sms * sms;
  return (int)(even < BLOCKS_PER_SM * sms ? even : BLOCKS_PER_SM * sms);
}

template <typename T>
static int launch(const void* g, int head, long long nvec, int tail,
                  const void* edges, int n_edges, void* ws, void* counts_ge,
                  int device, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (head < 0 || head >= N || tail < 0 || tail >= N)
    return (int)cudaErrorInvalidValue;
  const T* gt = (const T*)g;
  if (nvec > 0 && ((uintptr_t)(gt + head) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = grid_size(nvec, sms);
  int span = 2;
  while (span <= n_edges) span <<= 1;
  // lane columns: 32 where they fit in SMEM_BYTES, else the largest power
  // of two that does (8 at MAX_EDGES)
  int cols = 32;
  while (cols > 1 && sizeof(int) * (size_t)(span + n_edges * cols) >
                         SMEM_BYTES)
    cols >>= 1;
  const size_t smem = sizeof(int) * (size_t)(span + n_edges * cols);
  hist_kernel<T><<<blocks, THREADS, smem, s>>>(
      gt, head, (int64_t)nvec, tail, (const float*)edges, n_edges, span,
      cols, (int*)ws, (int*)counts_ge);
  return (int)cudaGetLastError();
}

extern "C" {

// g = head scalars, then nvec 16-byte vectors (g + head 16-byte aligned),
// then tail scalars, on CUDA device `device`; dtype: 0 = float32,
// 1 = bfloat16. `ws` holds MAX_EDGES + 1 int32 that are zero on entry and
// are zero again when the kernel ends; calls that share a workspace must
// run in stream order. Returns the CUDA error of the launch (0 on success).
int repro_magnitude_hist(const void* g, int head, long long nvec, int tail,
                         int dtype, const void* edges, int n_edges, void* ws,
                         void* counts_ge, int device, void* stream) {
  if (n_edges < 1 || n_edges > MAX_EDGES || nvec < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(g, head, nvec, tail, edges, n_edges, ws, counts_ge,
                         device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, head, nvec, tail, edges, n_edges, ws,
                                 counts_ge, device, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
