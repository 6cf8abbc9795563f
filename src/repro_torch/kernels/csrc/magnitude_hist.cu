// Streaming magnitude histogram for the threshold top-k pipeline (Hopper).
//
// Replaces the Pallas TPU kernel repro/kernels/magnitude_hist.py
// (`magnitude_hist`): counts_ge[j] = #{ i : |g[i]| >= edges[j] } over a
// flat gradient, for strictly positive, non-increasing edges.
//
// Design. The TPU kernel builds a [block x n_edges] compare matrix per
// grid step and carries the sum across its sequential grid. Here blocks run
// in parallel with nothing carried between them, so each element is placed
// once: a binary search over the edges (kept in shared memory) finds the
// first edge it reaches, and that bin of a per-block shared-memory int32
// histogram gets one atomicAdd. Each block then flushes its non-empty bins
// to global memory with one atomicAdd per bin, and a second one-warp kernel
// turns the bins into counts_ge with an inclusive scan. Counts are int32,
// exact up to 2^31 - 1 per edge (the reference's f32 counts are exact only
// up to 2^24).
//
// Bound on an H100: one read of g (4 bytes per element for f32, 2 for
// bf16); the edges, bins and counts are a few hundred bytes. At the cnn
// width (d = 1,663,370 f32, 6.65 MB) that is about 2 us at 3.35 TB/s. The
// kernel reads g once, coalesced, in a grid-stride loop over a grid capped
// at a few blocks per SM; everything else stays in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_EDGES 1024
#define THREADS 256

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// First j in [0, n) with e[j] <= mag for non-increasing e; n when mag is
// below every edge (or NaN: every compare is false).
__device__ __forceinline__ int first_reached(const float* e, int n,
                                             float mag) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (e[mid] <= mag) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const T* __restrict__ g, int64_t n,
            const float* __restrict__ edges, int n_edges,
            int* __restrict__ bins) {
  __shared__ float s_edges[MAX_EDGES];
  __shared__ int s_bins[MAX_EDGES];
  for (int j = threadIdx.x; j < n_edges; j += blockDim.x) {
    s_edges[j] = edges[j];
    s_bins[j] = 0;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int j = first_reached(s_edges, n_edges, fabsf(to_f32(g[i])));
    if (j < n_edges) atomicAdd(&s_bins[j], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_edges; j += blockDim.x) {
    const int c = s_bins[j];
    if (c) atomicAdd(&bins[j], c);
  }
}

// One warp: counts_ge[j] = bins[0] + ... + bins[j].
__global__ void prefix_kernel(const int* __restrict__ bins, int n_edges,
                              int* __restrict__ counts_ge) {
  int carry = 0;
  for (int base = 0; base < n_edges; base += 32) {
    const int j = base + threadIdx.x;
    int v = j < n_edges ? bins[j] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if ((int)threadIdx.x >= off) v += u;
    }
    if (j < n_edges) counts_ge[j] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `bins` must be zeroed by the caller.
// Returns cudaGetLastError() after the launches (0 on success).
int repro_magnitude_hist(const void* g, long long n, int dtype,
                         const void* edges, int n_edges, void* bins,
                         void* counts_ge, int max_blocks, void* stream) {
  if (n_edges < 1 || n_edges > MAX_EDGES || n < 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long want = (n + THREADS - 1) / THREADS;
  int blocks = (int)(want < max_blocks ? (want > 0 ? want : 1) : max_blocks);
  if (dtype == 0) {
    hist_kernel<float><<<blocks, THREADS, 0, s>>>(
        (const float*)g, (int64_t)n, (const float*)edges, n_edges,
        (int*)bins);
  } else if (dtype == 1) {
    hist_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)g, (int64_t)n, (const float*)edges, n_edges,
        (int*)bins);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prefix_kernel<<<1, 32, 0, s>>>((const int*)bins, n_edges, (int*)counts_ge);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
