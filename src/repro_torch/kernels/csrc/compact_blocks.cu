// Fixed-budget block compaction: the compact pod-sync wire payload (Hopper).
//
// Replaces the Pallas TPU kernel repro/kernels/compact_topk.py
// (`compact_blocks`). For acc [nb, blk] f32 and a threshold t, block b
// emits
//
//   vals[b, :budget]  f32  the |acc| >= t survivors, front-packed in index
//                          order (the first `budget` of them)
//   idx[b, :budget]   i32  their shard-flat coordinates b*blk + offset
//   cnt[b]            i32  min(#survivors, budget)
//   res[b, :]         f32  acc - shipped (the error-feedback carry)
//
// Slots [cnt, budget) hold (0.0, 0), so scatter-adding the whole payload
// onto zeros rebuilds the shipped selection exactly.
//
// Bound on an H100: one read of acc and one write of the residual
// (2 * 4 * nb * blk bytes) plus the payload (8 * nb * budget + 4 * nb).
// At the pod path's shard [813, 1024], budget 10, that is 6,728,388 bytes,
// 2.0 us at 3.35 TB/s: the kernel is one HBM round trip, so what matters is
// that every load is issued up front and that a CTA waits on as few
// barriers as possible.
//
// Design. The TPU kernel builds a one-hot [blk, budget] matrix from a
// cumsum and packs with an MXU dot. Here one CTA of THREADS = 128 threads
// owns one block, walked in super-chunks of THREADS * V = 1024 elements
// (one at the pod path's blk 1024). In each, a thread owns a contiguous run
// of V = 8 elements and loads all of it first, as two float4s. It counts
// its survivors; one block-wide exclusive scan over the threads in order (a
// __shfl_up_sync warp scan plus a scan of the warp totals in shared memory,
// one __syncthreads) gives it the slot of its first survivor. Runs are
// contiguous and the scan is in thread order, so slots follow the index
// order. Survivors whose slot is < budget write value and index; each
// thread stores its residual as float4s; a running kept-count carries into
// the next super-chunk (the warp totals are double-buffered, so a
// super-chunk still costs one barrier); the CTA zero-fills slots
// [cnt, budget). A block whose length is not a multiple of 4, or whose acc
// or residual row is not 16-byte aligned (a view with a storage offset),
// takes the same code with scalar loads and stores. t is read from device
// memory, so the threshold from the histogram solve never visits the host.
// 128 threads x 8 measured a little faster than 256 x 4 at [813, 1024]
// (PERF.md).
//
// Residual on non-finite input: computed as the plain version does,
// acc - (shipped ? acc : 0), as an explicit IEEE subtraction (inline PTX,
// so no compiler folds x - 0 into x and NaN comes out as the card's
// canonical NaN, as it does from PyTorch's subtraction). The Pallas body
// multiplies (acc * in_budget), which differs only for +-Inf entries past
// the budget (Inf * 0 = NaN).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 128;   // threads per CTA
constexpr int V = 8;           // elements per thread per super-chunk

__device__ __forceinline__ float ieee_sub(float a, float b) {
  float r;
  asm("sub.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const float* __restrict__ acc, int blk,
               const float* __restrict__ threshold, int budget,
               float* __restrict__ vals, int* __restrict__ idx,
               int* __restrict__ cnt, float* __restrict__ res) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int warp_tot[2][WARPS];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float t = __ldg(threshold);
  const float* a = acc + (int64_t)b * blk;
  float* r = res + (int64_t)b * blk;
  float* v = vals + (int64_t)b * budget;
  int* ix = idx + (int64_t)b * budget;
  const int base_idx = b * blk;   // < 2^31: the wrapper checks nb * blk
  const bool vec = (blk & 3) == 0 && (((uintptr_t)a | (uintptr_t)r) & 15) == 0;

  int kept = 0;   // survivors before this super-chunk (same in every thread)
  int buf = 0;
  for (int base = 0; base < blk; base += THREADS * V, buf ^= 1) {
    const int off0 = base + threadIdx.x * V;   // first element of my run
    float x[V];
    if (vec) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        // blk % 4 == 0: a float4 lies wholly inside or outside the block
        const float4 f = off0 + 4 * q < blk
            ? __ldg(reinterpret_cast<const float4*>(a + off0 + 4 * q))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        x[4 * q] = f.x;
        x[4 * q + 1] = f.y;
        x[4 * q + 2] = f.z;
        x[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = off0 + i < blk ? a[off0 + i] : 0.f;
    }
    bool keep[V];
    int c = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      keep[i] = off0 + i < blk && fabsf(x[i]) >= t;
      c += keep[i];
    }
    // exclusive scan of the per-thread counts, in thread order
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_tot[buf][warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_tot[buf][w];
      before += w < warp ? s : 0;
      total += s;
    }
    int slot = kept + before + incl - c;
    float y[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool ship = keep[i] && slot < budget;
      if (ship) {
        v[slot] = x[i];
        ix[slot] = base_idx + off0 + i;
      }
      slot += keep[i];
      y[i] = ieee_sub(x[i], ship ? x[i] : 0.f);
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        if (off0 + 4 * q < blk)
          *reinterpret_cast<float4*>(r + off0 + 4 * q) =
              make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (off0 + i < blk) r[off0 + i] = y[i];
    }
    kept += total;
  }
  const int c = kept < budget ? kept : budget;
  for (int s = c + threadIdx.x; s < budget; s += THREADS) {
    v[s] = 0.0f;
    ix[s] = 0;
  }
  if (threadIdx.x == 0) cnt[b] = c;
}

extern "C" {

// acc [nb, blk] f32 row-major (rows need not be 16-byte aligned); threshold
// one f32 in device memory. Returns cudaGetLastError() after the launch (0
// on success).
int repro_compact_blocks(const void* acc, int nb, int blk,
                         const void* threshold, int budget, void* vals,
                         void* idx, void* cnt, void* res, void* stream) {
  if (nb < 1 || blk < 1 || budget < 1 || budget > blk ||
      (int64_t)nb * blk > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  compact_kernel<<<nb, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)acc, blk, (const float*)threshold, budget, (float*)vals,
      (int*)idx, (int*)cnt, (float*)res);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
