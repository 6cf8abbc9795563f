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
// Design. The TPU kernel builds a one-hot [blk, budget] matrix from a
// cumsum and packs with an MXU dot. Here one CTA owns one block and walks
// it in chunks of THREADS elements, carrying a running kept-count. Within a
// chunk each warp ballots its survivors; a survivor's slot is the running
// count, plus the survivors of the warps before it (a scan of the per-warp
// totals in shared memory), plus __popc of the ballot bits of the lanes
// before it. A survivor whose slot is < budget writes vals and idx
// directly; every element writes its residual. t is read from device
// memory, so the threshold from the histogram solve never visits the host.
//
// Residual on non-finite input: computed as the plain version does,
// acc - (shipped ? acc : 0). The Pallas body multiplies (acc * in_budget),
// which differs only for +-Inf entries past the budget (Inf * 0 = NaN).
//
// Bound on an H100: one read of acc and one write of the residual
// (2 * 4 * nb * blk bytes) plus the payload (8 * nb * budget + 4 * nb).
// At the pod path's shard [813, 1024], budget 10, that is 6,728,388 bytes,
// about 2.0 us at 3.35 TB/s. Loads and residual stores are coalesced, one
// f32 per thread; payload stores are scattered but few.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)

__global__ void __launch_bounds__(THREADS)
compact_kernel(const float* __restrict__ acc, int blk,
               const float* __restrict__ threshold, int budget,
               float* __restrict__ vals, int* __restrict__ idx,
               int* __restrict__ cnt, float* __restrict__ res) {
  __shared__ int warp_tot[WARPS];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_before = (1u << lane) - 1u;
  const float t = *threshold;
  const float* a = acc + (int64_t)b * blk;
  float* r = res + (int64_t)b * blk;
  float* v = vals + (int64_t)b * budget;
  int* ix = idx + (int64_t)b * budget;
  const int base_idx = b * blk;   // < 2^31: the wrapper checks nb * blk

  int kept = 0;   // survivors before this chunk (the same in every thread)
  for (int base = 0; base < blk; base += THREADS) {
    const int off = base + threadIdx.x;
    const bool in = off < blk;
    const float x = in ? a[off] : 0.0f;
    const bool keep = in && fabsf(x) >= t;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_tot[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_tot[w];
      before += (w < warp) ? c : 0;
      total += c;
    }
    const int pos = kept + before + __popc(m & lanes_before);
    const bool ship = keep && pos < budget;
    if (ship) {
      v[pos] = x;
      ix[pos] = base_idx + off;
    }
    if (in) r[off] = x - (ship ? x : 0.0f);
    kept += total;
    __syncthreads();   // warp_tot is rewritten by the next chunk
  }
  const int c = kept < budget ? kept : budget;
  for (int s = c + threadIdx.x; s < budget; s += THREADS) {
    v[s] = 0.0f;
    ix[s] = 0;
  }
  if (threadIdx.x == 0) cnt[b] = c;
}

extern "C" {

// acc [nb, blk] f32 contiguous; threshold one f32 in device memory.
// Returns cudaGetLastError() after the launch (0 on success).
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
