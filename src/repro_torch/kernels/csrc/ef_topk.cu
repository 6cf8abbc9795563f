// Fused error-feedback threshold select (threshold top-k pass 3, Hopper).
//
// Replaces the Pallas TPU kernel repro/kernels/ef_topk.py (`ef_topk`). For
// g and r of d elements (each float32 or bfloat16) and a threshold t (one
// f32 in device memory, never read on the host):
//
//   acc  = f32(g) + f32(r)
//   keep = |acc| >= t              (NaN never; t = 0 keeps +-0)
//   out  = keep ? acc : 0          stored as g's dtype
//   r'   = acc - out               stored as r's dtype
//   nnz  = #keep                   int32
//
// out + r' == g + r bitwise in f32. +-Inf with a finite t is kept and its
// r' is Inf - Inf = NaN.
//
// Bound on an H100: read g, read r, write out, write r' — 16 bytes per
// element in f32: 26,613,920 B at the cnn width (d = 1,663,370), 7.94 us at
// 3.35 TB/s; 26,640,384 B at the pod dense wire's d = 1,665,024. No
// arithmetic to speak of: the kernel is one HBM round trip, so what matters
// is one device operation per call and enough bytes in flight.
//
// Design.
// - One launch per call, no fill, a two-step tail. The caller keeps an
//   8-byte workspace per (device, stream), zero between calls, read as one
//   64-bit word: finished CTAs in the high half, their keeps in the low
//   half. Each thread counts its keeps in a register, each warp sums them
//   with __reduce_add_sync, and thread 0 adds (1 << 32) + the sum of the
//   warps' totals (from shared memory) in one 64-bit atomicAdd. Atomics on
//   one word are totally ordered, so the CTA whose add returns a ticket of
//   gridDim.x - 1 read every other CTA's keeps in the old value: it writes
//   nnz = old keeps + its own and sets the word back to 0. One global
//   atomic per CTA and no fence; a captured launch replays correctly.
// - Wide streams, all in flight. A warp walks the vector in steps of
//   32 * QUADS quads (a quad is 4 elements: 16 bytes of f32, 8 of bf16);
//   lane l owns quads l, l + 32, ... of the step, so every warp-wide load
//   or store is one contiguous 512-byte (f32) or 256-byte (bf16) span, and
//   g and r stay in lockstep whatever their dtypes (the two quads of a
//   "group of 8" sit 32 quads apart rather than side by side, so no load
//   straddles its neighbour's half-sector). Each thread issues all of its
//   QUADS loads of g and of r before it converts, compares or stores
//   anything. g and r are read once, so their loads carry an evict-first
//   L2 policy (ld.global.cs): when out and r' need room in the L2 they
//   evict those clean lines before dirty ones that would have to be
//   written back first. The grid is sized in C from the SM count:
//   THREADS * QUADS quads per CTA, up to BLOCKS_PER_SM CTAs per SM, so the
//   cnn vector (407 CTAs on 132 SMs) is in flight in one wave; longer
//   vectors take a grid-stride loop. Offsets are 64-bit.
// - Alignment. The caller splits the vector into a scalar head, `nquad`
//   quads (every pointer at a quad boundary there) and a scalar tail; when
//   the four pointers' element phases differ (a view at another storage
//   offset) the whole vector is scalars. Scalars are a grid-stride loop of
//   the same kernel, so no view falls back to the plain version.
// - Bitwise with PyTorch on the card. acc is an explicit add.rn.f32 and r'
//   an explicit sub.rn.f32 (inline PTX, so no compiler folds acc - 0 into
//   acc): NaN comes out as the card's canonical NaN, as it does from
//   PyTorch's own add and subtraction. f32 -> bf16 is __float2bfloat16_rn,
//   the conversion c10::BFloat16 compiles to on sm_80 and later (round to
//   nearest even; NaN as the card converts it).
//
// The design was chosen against two quads per thread over twice the CTAs
// and against plain __ldg loads of g and r.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define BLOCKS_PER_SM 4   // resident CTAs per SM the grid is sized for
#define QUADS 4           // quads per thread per step, loaded before use
#define WARPS (THREADS / 32)

// One quad of T as one aligned vector access.
template <typename T> struct Quad;
template <> struct Quad<float> {
  using V = uint4;   // 16 bytes
};
template <> struct Quad<__nv_bfloat16> {
  using V = uint2;   // 8 bytes
};

__device__ __forceinline__ float ieee_add(float a, float b) {
  float c;
  asm("add.rn.f32 %0, %1, %2;" : "=f"(c) : "f"(a), "f"(b));
  return c;
}

__device__ __forceinline__ float ieee_sub(float a, float b) {
  float c;
  asm("sub.rn.f32 %0, %1, %2;" : "=f"(c) : "f"(a), "f"(b));
  return c;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __uint_as_float((unsigned)__bfloat16_as_ushort(x) << 16);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The f32 values of one quad (little endian: the lower half of a 32-bit
// word is the lower-addressed bf16; bf16 -> f32 is a shift).
__device__ __forceinline__ void unpack(uint4 v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint2 v, float* f) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void pack(const float* f, uint4& v) {
  v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                 __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ void pack(const float* f, uint2& v) {
  v = make_uint2(bf16_bits(f[0]) | (bf16_bits(f[1]) << 16),
                 bf16_bits(f[2]) | (bf16_bits(f[3]) << 16));
}

// A load of data this kernel reads once: evict-first.
template <typename V> __device__ __forceinline__ V load_once(const V* p) {
  return __ldcs(p);
}

// One element: returns keep, sets the shipped value and the residual.
__device__ __forceinline__ int ef_select(float g, float r, float t, float& o,
                                      float& res) {
  const float acc = ieee_add(g, r);
  const bool keep = fabsf(acc) >= t;
  o = keep ? acc : 0.0f;
  res = ieee_sub(acc, o);
  return keep;
}

template <typename TG, typename TR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ef_topk_kernel(const TG* __restrict__ g, const TR* __restrict__ r,
               const float* __restrict__ t_ptr, TG* __restrict__ out,
               TR* __restrict__ res, int* __restrict__ nnz, int64_t n,
               int64_t head, int64_t nquad,
               unsigned long long* __restrict__ ws) {
  using VG = typename Quad<TG>::V;
  using VR = typename Quad<TR>::V;
  __shared__ int s_cnt[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const VG* gq = reinterpret_cast<const VG*>(g + head);
  const VR* rq = reinterpret_cast<const VR*>(r + head);
  VG* oq = reinterpret_cast<VG*>(out + head);
  VR* sq = reinterpret_cast<VR*>(res + head);
  const int64_t step = 32 * QUADS;   // quads per warp per step
  const int64_t stride = (int64_t)gridDim.x * WARPS * step;
  int64_t base = ((int64_t)blockIdx.x * WARPS + warp) * step + lane;
  const float t = __ldg(t_ptr);
  int cnt = 0;

  for (; base < nquad; base += stride) {
    VG vg[QUADS];
    VR vr[QUADS];
    // every load of the step goes out before any of them is used
#pragma unroll
    for (int u = 0; u < QUADS; ++u) {
      const int64_t q = base + 32 * u;
      if (q < nquad) {
        vg[u] = load_once(gq + q);
        vr[u] = load_once(rq + q);
      }
    }
#pragma unroll
    for (int u = 0; u < QUADS; ++u) {
      const int64_t q = base + 32 * u;
      if (q < nquad) {
        float a[4], b[4], o[4], s[4];
        unpack(vg[u], a);
        unpack(vr[u], b);
#pragma unroll
        for (int e = 0; e < 4; ++e) cnt += ef_select(a[e], b[e], t, o[e], s[e]);
        VG wo;
        VR wr;
        pack(o, wo);
        pack(s, wr);
        oq[q] = wo;
        sq[q] = wr;
      }
    }
  }

  // scalars: the head and the tail (fewer than 8), or the whole vector
  // when the pointers' phases differ
  const int64_t nscal = n - 4 * nquad;
  for (int64_t s = (int64_t)blockIdx.x * THREADS + threadIdx.x; s < nscal;
       s += (int64_t)gridDim.x * THREADS) {
    const int64_t i = s < head ? s : s + 4 * nquad;
    float o, v;
    cnt += ef_select(to_f32(g[i]), to_f32(r[i]), t, o, v);
    out[i] = from_f32<TG>(o);
    res[i] = from_f32<TR>(v);
  }

  // the count: warp sums, the CTA's sum, one global atomic that also takes
  // a ticket; the last CTA writes nnz and leaves the workspace zero
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += (unsigned)s_cnt[w];
    const unsigned long long old = atomicAdd(ws, (1ull << 32) | c);
    if ((old >> 32) == gridDim.x - 1) {
      *nnz = (int)(unsigned)(old + c);
      *ws = 0ull;
    }
  }
}

// CTAs for `work` quads at THREADS * QUADS quads per CTA: at least 1, at
// most BLOCKS_PER_SM per SM (the grid-stride loops do the rest).
static int grid_size(long long work, int sms) {
  const long long per_cta = (long long)THREADS * QUADS;
  long long want = (work + per_cta - 1) / per_cta;
  if (want < 1) want = 1;
  const long long cap = (long long)BLOCKS_PER_SM * sms;
  return (int)(want < cap ? want : cap);
}

static bool quad_aligned(const void* p, long long head, int itemsize) {
  return ((uintptr_t)p + head * itemsize) % (4u * itemsize) == 0;
}

template <typename TG, typename TR>
static int launch(const void* g, const void* r, const void* t, void* out,
                  void* res, void* nnz, long long n, long long head,
                  long long nquad, void* ws, int device, cudaStream_t s) {
  if ((uintptr_t)ws % 8 != 0) return (int)cudaErrorMisalignedAddress;
  if (nquad > 0 && !(quad_aligned(g, head, sizeof(TG)) &&
                     quad_aligned(out, head, sizeof(TG)) &&
                     quad_aligned(r, head, sizeof(TR)) &&
                     quad_aligned(res, head, sizeof(TR))))
    return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long nscal = n - 4 * nquad;
  const int blocks = grid_size(nquad + (nscal + 3) / 4, sms);
  ef_topk_kernel<TG, TR><<<blocks, THREADS, 0, s>>>(
      (const TG*)g, (const TR*)r, (const float*)t, (TG*)out, (TR*)res,
      (int*)nnz, (int64_t)n, (int64_t)head, (int64_t)nquad,
      (unsigned long long*)ws);
  return (int)cudaGetLastError();
}

extern "C" {

// g (g_dtype) and r (r_dtype) of n elements on CUDA device `device`,
// dtype 0 = float32, 1 = bfloat16; t one float32; out (g's dtype), res
// (r's dtype) of n elements; nnz one int32. Elements [head, head + 4 *
// nquad) are quads: every pointer + head is at a multiple of 4 elements.
// `ws` holds 8 bytes, 8-byte aligned, that are zero on entry and zero
// again when the kernel ends; calls that share a workspace must run in
// stream order. Returns the CUDA error of the launch (0 on success).
int repro_ef_topk(const void* g, int g_dtype, const void* r, int r_dtype,
                  const void* t, void* out, void* res, void* nnz,
                  long long n, long long head, long long nquad, void* ws,
                  int device, void* stream) {
  if (n < 0 || head < 0 || nquad < 0 || head + 4 * nquad > n ||
      n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g_dtype == 0 && r_dtype == 0)
    return launch<float, float>(g, r, t, out, res, nnz, n, head, nquad, ws,
                                device, s);
  if (g_dtype == 0 && r_dtype == 1)
    return launch<float, __nv_bfloat16>(g, r, t, out, res, nnz, n, head,
                                        nquad, ws, device, s);
  if (g_dtype == 1 && r_dtype == 0)
    return launch<__nv_bfloat16, float>(g, r, t, out, res, nnz, n, head,
                                        nquad, ws, device, s);
  if (g_dtype == 1 && r_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(g, r, t, out, res, nnz, n,
                                                head, nquad, ws, device, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
