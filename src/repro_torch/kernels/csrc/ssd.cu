// Chunked SSD (Mamba-2's state-space duality, arXiv:2405.21060 §6) for
// Hopper: the forward in 5 launches and the backward in 10.
//
// Replaces no TPU kernel: the reference's `repro.models.mamba2.ssd_chunked`
// is plain jnp, left to XLA's fusion. Written by hand because the same
// algorithm as an eager einsum and segment-sum chain set much of the pace
// of the mamba2-780m pod round on the H100: ~50 launches a layer's forward,
// [b, nc, H, Q, Q] fp32 decay matrices in device memory (100 MB each at
// 2048 tokens, every layer, again in the backward) and several times these
// kernels' device time (PERF.md §6).
//
// Notation, per chunk of Q steps and head h: u_s = dt_s·x_s, A_q the
// cumulative sum of dtA inside the chunk, G_qs = C_q·B_s (shared by the
// heads: n_groups 1), S_c the state entering chunk c.
//
//   y_q    = Σ_{s≤q} G_qs·exp(A_q − A_s)·u_s + exp(A_q)·S_c C_q
//   S_c+1  = exp(A_last)·S_c + Σ_s exp(A_last − A_s)·u_s ⊗ B_s
//
// Backward: du_s = Σ_{q≥s} G_qs·exp(A_q − A_s)·dy_q + exp(A_last − A_s)·
// dS_c+1 B_s, dA_q = dy_q·y_q − u_q·du_q (+ ⟨dS_c+1, S_c+1⟩ at the chunk's
// last step; y is saved by the forward), d(dtA) the reverse cumulative sum
// of dA inside each chunk, dG_qs = Σ_h exp(A_q − A_s)·dy_q·u_s, and dB, dC
// from dG and the states.
//
// Bound on this card: fp32 FMA throughput, not bytes. At mamba2-780m's
// shapes (1 x 2048, H 48, P 64, N 128, Q 256) a layer's forward is ~2.4 G
// FMA and its backward ~4 G against ~0.1 GB of inputs and outputs. Every
// product is plain fp32 fmaf (the configurations run fp32 with TF32 off).
// What the design does about that bound:
// - Every product runs through `Tile`: a 64 x 64 output tile per block of
//   128 threads, each thread 8 x 4 outputs in registers, operands staged
//   through shared memory 16 deep in two alternating buffers, the next
//   slab loaded into registers while this one's products run. Loaders
//   compute an operand's element (a decay, a mask, a scale) as the slab is
//   filled, so a decayed operand never exists in device memory.
// - Tiles of G wholly above the diagonal are never visited (the causal
//   skip halves the Q x Q work), and no Q x Q matrix per head reaches
//   device memory (G itself is [b, nc, Q, Q], once for all heads).
// - On a diagonal tile the decay exp(A_q − A_s) is made from A and masked;
//   below the diagonal it is split at A_r, a step between s and q, into
//   exp(A_q − A_r)·exp(A_r − A_s), so each factor scales a row of an
//   operand or of the result and the tile is a plain product (dG's tiles
//   become one product over all heads and P). Both factors are at most 1
//   where dtA ≤ 0, as a decay is; one that underflows stands for a product
//   that is smaller still.
// - A chunk's per-step vectors (A, dt and the decays a tile's operands
//   take) are staged in shared memory, so a loader reads one value
//   where it would compute an exp (chunks of at most QMAX = 256 steps).
// - Products with a long inner dimension and few output tiles (dB and dC's
//   state parts over H·P, dG over H·P) split their heads over blocks, and
//   a second kernel sums the splits.
// - The scans over a chunk's steps run one block per (b, c, h) in shared
//   memory, and the recurrences over the chunks keep eight chunks' loads
//   in flight per thread.
// Saved for the backward: the inputs, y, A ([b, H, S]) and the states
// entering each chunk ([b, nc, H, P, N]); the rest is recomputed.
//
// Kernels (every name starts with ssd_, which the benchmark's
// ssd_kernel_ms reads). Forward: ssd_cumsum (A), ssd_bmm (G, lower tiles),
// ssd_chunk_state (each chunk's own state), ssd_state_pass (the recurrence
// over the chunks, one thread per state element carrying it through a
// loop; it turns the chunk states into the states entering each chunk, in
// place), ssd_chunk_scan (y). Backward: ssd_bmm again, ssd_chunk_state on
// dy (each chunk's dS from its y_off), ssd_state_pass_bwd (the reverse
// recurrence: dS and the initial state's gradient), ssd_chunk_scan_bwd_dx
// (du, so dx, d(dt) and dA before its cumulative sum), ssd_bwd_dcb (dG,
// heads split over blocks), ssd_bwd_dbc twice (dC and dB in parts: the
// states' over the head splits, and dG's), ssd_bwd_dbc_sum twice (the
// parts' sum) and ssd_bwd_da (⟨dS, S⟩ and the reverse cumulative sum).
//
// Any b, S, H, P, N and Q = min(chunk, S) ≤ QMAX dividing S: tiles are
// masked at every edge, and P and N wider than a tile take more tiles.
// Strides of the inputs are taken as given (element strides); outputs are
// contiguous. Index arithmetic is int32 within a tensor (the wrapper
// raises at 2**31 elements). Launches go on the caller's stream; nothing
// is allocated here.

#include <cuda_runtime.h>

#include <cstring>

// The blocks per SM that the registers of a chunk's tile kernels and of
// the head-split kernels (ssd_bwd_dcb, ssd_bwd_dbc) leave room for. Timed
// on an H100 at mamba2-780m's and granite's shapes: 4 and 5 blocks beat 3
// (and 5 beat 4 for the head-split kernels, a few spilled registers
// notwithstanding); slabs 16 deep beat 32.
#define SSD_MINB 4
#define SSD_MINB_SPLIT 5

namespace {

constexpr int T = 64;     // output tile side
constexpr int TK = 16;    // depth of a shared-memory slab
constexpr int NT = 128;   // threads of a tile block: 8 x 16, 8 x 4 outputs each
constexpr int NE = 256;   // threads of the element-wise and state kernels
constexpr int PAD = 4;    // keeps slab rows 16-byte aligned
constexpr int R = T * TK / NT;   // slab elements each thread stages
constexpr int QMAX = 256;  // the longest chunk: per-step vectors in shared memory
constexpr int MAXH = 16;   // the most heads of a split (dB, dC and dG)

struct S4 { int b, s, h, p; };   // strides of a [b, S, H, P] tensor
struct S3 { int b, s, n; };      // strides of a [b, S, H] or [b, S, N]

// Shapes, input strides and the backward's splits. `ssd.py` builds it as
// 33 int32 in this order (and raises where a tensor holds 2**31 elements
// or more).
struct Dims {
  int b, S, H, P, N, Q, nc, nt;   // nt = ceil(Q / T)
  S4 x, dy;
  S3 dt, dtA, B, C;
  int hs, hps;                    // ssd_bwd_dcb: splits, heads each
  int ks, kps;                    // ssd_bwd_dbc: splits, heads each
  int nblk;                       // blocks of a state pass per (b, h)
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

int cdiv(int a, int b) { return (a + b - 1) / b; }

struct __align__(16) Slab {
  float a[TK][T + PAD];
  float b[TK][T + PAD];
};
using Slabs = Slab[2];

// One block's 64 x 64 output tile: thread (ty, tx) holds rows ty*8.. and
// columns tx*4.. in registers.
struct Tile {
  float acc[8][4];
  int tx, ty;

  __device__ __forceinline__ Tile()
      : tx(threadIdx.x % 16), ty(threadIdx.x / 16) {
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ int row(int i) const { return ty * 8 + i; }
  __device__ __forceinline__ int col(int j) const { return tx * 4 + j; }
  __device__ __forceinline__ void scale(float f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= f;
  }

  // acc[m][n] += Σ_{k0 ≤ k < k1} a(m, k)·b(k, n). The loaders return an
  // operand's element (0 outside it); AK / BK say that the operand is
  // contiguous in k, so neighbouring threads load neighbouring k (else
  // neighbouring m or n). Slabs alternate between two buffers, and the
  // next slab's elements are loaded into registers while this one's
  // products run. Every thread of the block must call it.
  template <bool AK, bool BK, class LA, class LB>
  __device__ __forceinline__ void mma(int k0, int k1, const LA& la,
                                      const LB& lb, Slabs& sm) {
    float ra[R], rb[R];
    const auto fetch = [&](int kb) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = threadIdx.x + r * NT;
        const int am = AK ? e / TK : e % T, ak = AK ? e % TK : e / T;
        ra[r] = kb + ak < k1 ? la(am, kb + ak) : 0.f;
        const int bn = BK ? e / TK : e % T, bk = BK ? e % TK : e / T;
        rb[r] = kb + bk < k1 ? lb(kb + bk, bn) : 0.f;
      }
    };
    fetch(k0);
    int buf = 0;
    for (int kb = k0; kb < k1; kb += TK, buf ^= 1) {
      Slab& s = sm[buf];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = threadIdx.x + r * NT;
        s.a[AK ? e % TK : e / T][AK ? e / TK : e % T] = ra[r];
        s.b[BK ? e % TK : e / T][BK ? e / TK : e % T] = rb[r];
      }
      __syncthreads();
      if (kb + TK < k1) fetch(kb + TK);
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 8]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&s.a[k][ty * 8 + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
};

// Inclusive sum over v[0..NE) in shared memory, NE threads (Hillis-Steele).
__device__ __forceinline__ void block_scan(float* v) {
  for (int off = 1; off < NE; off <<= 1) {
    const float t = (int)threadIdx.x >= off ? v[threadIdx.x - off] : 0.f;
    __syncthreads();
    v[threadIdx.x] += t;
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward
// A[b, h, c·Q + q] = Σ_{t≤q} dtA[b, c·Q + t, h]: one block per (b, h, c),
// one thread per step.
__global__ void __launch_bounds__(NE)
    ssd_cumsum_kernel(const float* __restrict__ dtA, float* __restrict__ A,
                      Dims d) {
  __shared__ float v[NE];
  const int i = blockIdx.x, c = i % d.nc, h = (i / d.nc) % d.H,
            b = i / (d.nc * d.H), q = threadIdx.x;
  v[q] = q < d.Q ? dtA[(long long)b * d.dtA.b +
                       (long long)(c * d.Q + q) * d.dtA.s + h * d.dtA.n]
                 : 0.f;
  __syncthreads();
  block_scan(v);
  if (q < d.Q) A[(long long)i * d.Q + q] = v[q];
}

// G[b, c, q, s] = C_q·B_s on the tiles (i, j) with j ≤ i.
__global__ void __launch_bounds__(NT, SSD_MINB)
    ssd_bmm_kernel(const float* __restrict__ Cm,
                   const float* __restrict__ Bm, float* __restrict__ G,
                   Dims d) {
  const int i = blockIdx.y, j = blockIdx.z;
  if (j > i) return;
  __shared__ Slabs sm;
  const int bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int q0 = i * T, s0 = j * T, qn = d.Q - q0, sn = d.Q - s0;
  const float* cb = Cm + (long long)b * d.C.b +
                    (long long)(c * d.Q + q0) * d.C.s;
  const float* bb = Bm + (long long)b * d.B.b +
                    (long long)(s0 + c * d.Q) * d.B.s;
  Tile t;
  t.mma<true, true>(
      0, d.N,
      [&](int m, int k) { return m < qn ? cb[m * d.C.s + k * d.C.n] : 0.f; },
      [&](int k, int n) { return n < sn ? bb[n * d.B.s + k * d.B.n] : 0.f; },
      sm);
  float* gb = G + (long long)bc * d.Q * d.Q;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + t.row(a), s = s0 + t.col(e);
      if (q < d.Q && s < d.Q) gb[q * d.Q + s] = t.acc[a][e];
    }
}

// Out[b, c, h, p, n] = Σ_s w_s·V[b, c·Q + s, h, p]·M[b, c·Q + s, n].
// FROM_LAST: w_s = dt_s·exp(A_last − A_s) (V = x, M = B: the chunk's own
// state); else w_s = exp(A_s) (V = dy, M = C: dS from the chunk's y_off).
template <bool FROM_LAST>
__global__ void __launch_bounds__(NT, SSD_MINB)
    ssd_chunk_state_kernel(const float* __restrict__ V, S4 sv,
                           const float* __restrict__ Dt,
                           const float* __restrict__ A,
                           const float* __restrict__ M, S3 smt,
                           float* __restrict__ Out, Dims d) {
  __shared__ Slabs sm;
  __shared__ float wv[QMAX];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int p0 = blockIdx.y * T, n0 = blockIdx.z * T;
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* vb = V + (long long)b * sv.b + cq * sv.s + h * sv.h;
  const float* mb = M + (long long)b * smt.b + cq * smt.s;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.n;
  const float a_last = ab[d.Q - 1];
  for (int s = threadIdx.x; s < d.Q; s += NT)
    wv[s] = FROM_LAST ? db[s * d.dt.s] * expf(a_last - ab[s]) : expf(ab[s]);
  __syncthreads();
  Tile t;
  t.mma<false, false>(
      0, d.Q,
      [&](int m, int s) {
        return p0 + m < d.P ? vb[s * sv.s + (p0 + m) * sv.p] * wv[s] : 0.f;
      },
      [&](int s, int n) {
        return n0 + n < d.N ? mb[s * smt.s + (n0 + n) * smt.n] : 0.f;
      },
      sm);
  float* ob = Out + (long long)pid * d.P * d.N;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + t.row(a), n = n0 + t.col(e);
      if (p < d.P && n < d.N) ob[p * d.N + n] = t.acc[a][e];
    }
}

// The recurrence over the chunks, one thread per (b, h, state element),
// eight chunks' loads in flight at a time: St holds each chunk's own state
// and leaves with the state entering it.
__global__ void __launch_bounds__(NE)
    ssd_state_pass_kernel(float* __restrict__ St,
                          const float* __restrict__ A,
                          const float* __restrict__ Init,
                          float* __restrict__ Final, Dims d) {
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int PN = d.P * d.N, e = blockIdx.y * NE + threadIdx.x;
  if (e >= PN) return;
  const float* ab = A + (long long)bh * d.S + d.Q - 1;
  float* sb = St + ((long long)b * d.nc * d.H + h) * PN + e;
  const long long cs = (long long)d.H * PN;   // chunk stride
  float carry = Init ? Init[(long long)bh * PN + e] : 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += 8) {
    float st[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < d.nc) {
        st[k] = sb[(c0 + k) * cs];
        dec[k] = expf(ab[(c0 + k) * d.Q]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < d.nc) {
        sb[(c0 + k) * cs] = carry;
        carry = carry * dec[k] + st[k];
      }
  }
  Final[(long long)bh * PN + e] = carry;
}

// y for one (b, c, h), a 64-row q tile i and a 64-column p tile.
__global__ void __launch_bounds__(NT, SSD_MINB)
    ssd_chunk_scan_kernel(const float* __restrict__ X,
                          const float* __restrict__ Dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Cm,
                          const float* __restrict__ G,
                          const float* __restrict__ St,
                          float* __restrict__ Y, Dims d) {
  __shared__ Slabs sm;
  __shared__ float av[QMAX], wv[QMAX];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int i = blockIdx.y, q0 = i * T, q1 = imin(q0 + T, d.Q),
            p0 = blockIdx.z * T;
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* sb = St + (long long)pid * d.P * d.N;
  const float* cb = Cm + (long long)b * d.C.b + cq * d.C.s;
  const float* xb = X + (long long)b * d.x.b + cq * d.x.s + h * d.x.h;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.n;
  const float* gb = G + (long long)(b * d.nc + c) * d.Q * d.Q;
  // A_r, the step before this tile (0 before the chunk): for s < q0 ≤ q,
  // exp(A_q − A_s) = exp(A_q − A_r)·exp(A_r − A_s), both ≤ 1. wv holds
  // u's scale: dt_s·exp(A_r − A_s) below the tile, dt_s on it.
  const float a_r = i > 0 ? ab[q0 - 1] : 0.f;
  for (int s = threadIdx.x; s < q1; s += NT) {
    av[s] = ab[s];
    wv[s] = s < q0 ? db[s * d.dt.s] * expf(a_r - av[s]) : db[s * d.dt.s];
  }
  __syncthreads();
  Tile t;
  // the state entering the chunk: exp(A_r)·C_q Sᵀ
  t.mma<true, true>(
      0, d.N,
      [&](int m, int n) {
        return q0 + m < d.Q ? cb[(q0 + m) * d.C.s + n * d.C.n] : 0.f;
      },
      [&](int n, int m) {
        return p0 + m < d.P ? sb[(p0 + m) * d.N + n] : 0.f;
      },
      sm);
  t.scale(expf(a_r));
  const auto u = [&](int s, int m) {
    return p0 + m < d.P ? xb[s * d.x.s + (p0 + m) * d.x.p] * wv[s] : 0.f;
  };
  // the tiles below the diagonal: G (exp(A_r − A_s)·u_s), one product
  t.mma<true, false>(
      0, q0,
      [&](int m, int s) {
        return q0 + m < d.Q ? gb[(q0 + m) * d.Q + s] : 0.f;
      },
      u, sm);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int q = q0 + t.row(a);
    const float f = q < d.Q ? expf(av[imin(q, d.Q - 1)] - a_r) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) t.acc[a][e] *= f;
  }
  // the diagonal tile: exp(A_q − A_s), masked causal
  t.mma<true, false>(
      q0, q1,
      [&](int m, int s) {
        const int q = q0 + m;
        return q < d.Q && s <= q ? gb[q * d.Q + s] * expf(av[q] - av[s])
                                 : 0.f;
      },
      u, sm);
  float* yb = Y + (((long long)b * d.S + c * d.Q) * d.H + h) * d.P;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + t.row(a), p = p0 + t.col(e);
      if (q < d.Q && p < d.P) yb[q * d.H * d.P + p] = t.acc[a][e];
    }
}

// --------------------------------------------------------------- backward
// The reverse recurrence, one thread per (b, h, state element), eight
// chunks' loads in flight at a time: Dst holds each chunk's dS from its
// y_off and leaves with dS_c+1; Dinit = dS_0.
__global__ void __launch_bounds__(NE)
    ssd_state_pass_bwd_kernel(float* __restrict__ Dst,
                              const float* __restrict__ A,
                              const float* __restrict__ Dfinal,
                              float* __restrict__ Dinit, Dims d) {
  const int bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int PN = d.P * d.N, e = blockIdx.y * NE + threadIdx.x;
  if (e >= PN) return;
  const float* ab = A + (long long)bh * d.S + d.Q - 1;
  float* sb = Dst + ((long long)b * d.nc * d.H + h) * PN + e;
  const long long cs = (long long)d.H * PN;   // chunk stride
  float g = Dfinal ? Dfinal[(long long)bh * PN + e] : 0.f;
  for (int c0 = d.nc - 1; c0 >= 0; c0 -= 8) {
    float dyoff[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 - k >= 0) {
        dyoff[k] = sb[(c0 - k) * cs];
        dec[k] = expf(ab[(c0 - k) * d.Q]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 - k >= 0) {
        sb[(c0 - k) * cs] = g;
        g = dyoff[k] + dec[k] * g;
      }
  }
  Dinit[(long long)bh * PN + e] = g;
}

// du for one (b, c, h) and a 64-row s tile j, over all of P in 64-column
// tiles: dx = du·dt, d(dt) = Σ_p du·x, and DA = Σ_p dy·y − dt·d(dt), dA
// before the ⟨dS, S⟩ term and the reverse cumulative sum.
__global__ void __launch_bounds__(NT, SSD_MINB)
    ssd_chunk_scan_bwd_dx_kernel(const float* __restrict__ X,
                                 const float* __restrict__ Dt,
                                 const float* __restrict__ A,
                                 const float* __restrict__ Bm,
                                 const float* __restrict__ G,
                                 const float* __restrict__ Dy,
                                 const float* __restrict__ Y,
                                 const float* __restrict__ Dst,
                                 float* __restrict__ Dx,
                                 float* __restrict__ Ddt,
                                 float* __restrict__ DA, Dims d) {
  __shared__ Slabs sm;
  __shared__ float av[QMAX], wv[QMAX];
  __shared__ float red[2][T][17];
  __shared__ float rsum[2][T];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int j = blockIdx.y, s0 = j * T, s1 = imin(s0 + T, d.Q);
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* bb = Bm + (long long)b * d.B.b + cq * d.B.s;
  const float* dsb = Dst + (long long)pid * d.P * d.N;
  const float* gb = G + (long long)(b * d.nc + c) * d.Q * d.Q;
  const float* yb = Dy + (long long)b * d.dy.b + cq * d.dy.s + h * d.dy.h;
  const float* xb = X + (long long)b * d.x.b + cq * d.x.s + h * d.x.h;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.n;
  const long long row0 = ((long long)b * d.S + cq) * d.H + h;
  // A_r, this tile's last step: for q > r ≥ s, exp(A_q − A_s) =
  // exp(A_q − A_r)·exp(A_r − A_s), both ≤ 1. wv holds dy's scale
  // exp(A_q − A_r) above the tile.
  const float a_r = ab[s1 - 1], a_last = ab[d.Q - 1];
  for (int q = s0 + threadIdx.x; q < d.Q; q += NT) {
    av[q] = ab[q];
    wv[q] = expf(av[q] - a_r);
  }
  if (threadIdx.x < T) rsum[0][threadIdx.x] = rsum[1][threadIdx.x] = 0.f;
  __syncthreads();
  for (int p0 = 0; p0 < d.P; p0 += T) {
    Tile t;
    // the chunk state's part: exp(A_last − A_r)·B_s dSᵀ
    t.mma<true, true>(
        0, d.N,
        [&](int m, int n) {
          return s0 + m < d.Q ? bb[(s0 + m) * d.B.s + n * d.B.n] : 0.f;
        },
        [&](int n, int m) {
          return p0 + m < d.P ? dsb[(p0 + m) * d.N + n] : 0.f;
        },
        sm);
    t.scale(expf(a_last - a_r));
    // the tiles below the diagonal: Gᵀ (exp(A_q − A_r)·dy_q), one product
    t.mma<false, false>(
        s1, d.Q,
        [&](int m, int q) {
          return s0 + m < d.Q ? gb[q * d.Q + s0 + m] : 0.f;
        },
        [&](int q, int m) {
          return p0 + m < d.P ? yb[q * d.dy.s + (p0 + m) * d.dy.p] * wv[q]
                              : 0.f;
        },
        sm);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int s = s0 + t.row(a);
      const float f = s < d.Q ? expf(a_r - av[s]) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) t.acc[a][e] *= f;
    }
    // the diagonal tile: exp(A_q − A_s), masked causal
    t.mma<false, false>(
        s0, s1,
        [&](int m, int q) {
          const int s = s0 + m;
          return s < d.Q && q >= s ? gb[q * d.Q + s] * expf(av[q] - av[s])
                                   : 0.f;
        },
        [&](int q, int m) {
          return p0 + m < d.P ? yb[q * d.dy.s + (p0 + m) * d.dy.p] : 0.f;
        },
        sm);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int s = s0 + t.row(a);
      float pd = 0.f, py = 0.f;
      if (s < d.Q) {
        const float dts = db[s * d.dt.s];
        const long long row = row0 + (long long)s * d.H;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + t.col(e);
          if (p < d.P) {
            Dx[row * d.P + p] = t.acc[a][e] * dts;
            pd += t.acc[a][e] * xb[s * d.x.s + p * d.x.p];
            py += yb[s * d.dy.s + p * d.dy.p] * Y[row * d.P + p];
          }
        }
      }
      red[0][t.row(a)][t.tx] = pd;
      red[1][t.row(a)][t.tx] = py;
    }
    __syncthreads();
    {
      const int k = threadIdx.x / T, r = threadIdx.x % T;
      float sum = 0.f;
      for (int x = 0; x < 16; ++x) sum += red[k][r][x];
      rsum[k][r] += sum;
    }
    __syncthreads();
  }
  if (threadIdx.x < T && s0 + (int)threadIdx.x < d.Q) {
    const int s = s0 + threadIdx.x;
    const long long row = row0 + (long long)s * d.H;
    const float ddt = rsum[0][threadIdx.x];
    Ddt[row] = ddt;
    DA[row] = rsum[1][threadIdx.x] - db[s * d.dt.s] * ddt;
  }
}

// dG[hs, b, c, q, s] = Σ_{h in split hs} exp(A_q − A_s)·dy_q·u_s on the
// tiles (i, j) with j ≤ i; a split holds at most MAXH heads.
__global__ void __launch_bounds__(NT, SSD_MINB_SPLIT)
    ssd_bwd_dcb_kernel(const float* __restrict__ X,
                       const float* __restrict__ Dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Dy,
                       float* __restrict__ DGp, Dims d) {
  const int i = blockIdx.y / d.nt, j = blockIdx.y % d.nt;
  if (j > i) return;
  __shared__ Slabs sm;
  __shared__ float wq[MAXH][T], ws[MAXH][T];
  const int bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int hs = blockIdx.z, h0 = hs * d.hps, h1 = imin(d.H, h0 + d.hps);
  const int q0 = i * T, s0 = j * T, P = d.P;
  const long long cq = (long long)c * d.Q;
  const float* ab = A + (long long)b * d.H * d.S + cq;
  const float* yb = Dy + (long long)b * d.dy.b + cq * d.dy.s;
  const float* xb = X + (long long)b * d.x.b + cq * d.x.s;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s;
  // per head of the split: below the diagonal dy's scale exp(A_q − A_r)
  // and u's dt_s·exp(A_r − A_s), A_r the step before tile i (both ≤ 1);
  // on it A_q and dt_s
  for (int e = threadIdx.x; e < (h1 - h0) * T; e += NT) {
    const int hh = e / T, m = e % T, h = h0 + hh;
    const float* ah = ab + (long long)h * d.S;
    const int q = imin(q0 + m, d.Q - 1), s = imin(s0 + m, d.Q - 1);
    const float dts = db[s * d.dt.s + h * d.dt.n];
    if (j < i) {
      wq[hh][m] = expf(ah[q] - ah[q0 - 1]);
      ws[hh][m] = dts * expf(ah[q0 - 1] - ah[s]);
    } else {
      wq[hh][m] = ah[q];
      ws[hh][m] = dts;
    }
  }
  __syncthreads();
  Tile t;
  if (j < i) {
    // below the diagonal, one product over (head, p)
    t.mma<true, true>(
        h0 * P, h1 * P,
        [&](int m, int k) {
          const int q = q0 + m, h = k / P, p = k - h * P;
          return q < d.Q
                     ? yb[q * d.dy.s + h * d.dy.h + p * d.dy.p] * wq[h - h0][m]
                     : 0.f;
        },
        [&](int k, int m) {
          const int h = k / P, p = k - h * P;
          return xb[(s0 + m) * d.x.s + h * d.x.h + p * d.x.p] * ws[h - h0][m];
        },
        sm);
  } else {
    float dg[8][4] = {};
    for (int h = h0; h < h1; ++h) {
      const int hh = h - h0;
      t.zero();
      t.mma<true, true>(
          0, P,
          [&](int m, int p) {
            return q0 + m < d.Q
                       ? yb[(q0 + m) * d.dy.s + h * d.dy.h + p * d.dy.p]
                       : 0.f;
          },
          [&](int p, int m) {
            return s0 + m < d.Q
                       ? xb[(s0 + m) * d.x.s + h * d.x.h + p * d.x.p] *
                             ws[hh][m]
                       : 0.f;
          },
          sm);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + t.row(a), s = s0 + t.col(e);
          if (q < d.Q && s <= q)
            dg[a][e] += expf(wq[hh][t.row(a)] - wq[hh][t.col(e)]) *
                        t.acc[a][e];
        }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) t.acc[a][e] = dg[a][e];
  }
  float* ob = DGp + ((long long)hs * gridDim.x + bc) * d.Q * d.Q;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + t.row(a), s = s0 + t.col(e);
      if (q < d.Q && s < d.Q) ob[q * d.Q + s] = t.acc[a][e];
    }
}

// dC (IS_DB false, rows q) or dB (rows s) in KS + 1 parts, Part[z, b, c,
// r, n]: z < KS the states' part over the heads of split z (at most MAXH),
// Σ_h exp(A_q)·dy_q S_cᵀ for dC and Σ_h exp(A_last − A_s)·u_s dS_c+1ᵀ for
// dB; z = KS dG's part, Σ_{s≤q} dG_qs B_s for dC and Σ_{q≥s} dG_qs C_q for
// dB, dG the sum of its HS splits.
template <bool IS_DB>
__global__ void __launch_bounds__(NT, SSD_MINB_SPLIT)
    ssd_bwd_dbc_kernel(const float* __restrict__ V, S4 sv,
                       const float* __restrict__ Dt,
                       const float* __restrict__ A,
                       const float* __restrict__ St,
                       const float* __restrict__ DGp,
                       const float* __restrict__ Om, S3 so,
                       float* __restrict__ Part, Dims d) {
  __shared__ Slabs sm;
  __shared__ float wr[MAXH][T];
  const int nbc = gridDim.x, bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int ntn = (d.N + T - 1) / T;
  const int r0 = (blockIdx.y / ntn) * T, n0 = (blockIdx.y % ntn) * T;
  const int z = blockIdx.z, P = d.P;
  const long long cq = (long long)c * d.Q;
  Tile t;
  if (z < d.ks) {
    const int h0 = z * d.kps, h1 = imin(d.H, h0 + d.kps);
    const float* ab = A + (long long)b * d.H * d.S + cq;
    const float* vb = V + (long long)b * sv.b + cq * sv.s;
    const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s;
    const float* stb = St + (long long)bc * d.H * d.P * d.N;
    // each row's scale per head of the split
    for (int e = threadIdx.x; e < (h1 - h0) * T; e += NT) {
      const int hh = e / T, m = e % T, h = h0 + hh;
      const int r = imin(r0 + m, d.Q - 1);
      const float* ah = ab + (long long)h * d.S;
      wr[hh][m] = IS_DB ? db[r * d.dt.s + h * d.dt.n] *
                              expf(ah[d.Q - 1] - ah[r])
                        : expf(ah[r]);
    }
    __syncthreads();
    t.mma<true, false>(
        h0 * P, h1 * P,
        [&](int m, int k) {
          const int r = r0 + m, h = k / P, p = k - h * P;
          return r < d.Q ? vb[r * sv.s + h * sv.h + p * sv.p] * wr[h - h0][m]
                         : 0.f;
        },
        [&](int k, int n) {
          return n0 + n < d.N ? stb[k * d.N + n0 + n] : 0.f;
        },
        sm);
  } else {
    const long long QQ = (long long)d.Q * d.Q;
    const float* gb = DGp + (long long)bc * QQ;
    const float* ob = Om + (long long)b * so.b + cq * so.s;
    const auto other = [&](int o, int n) {
      return n0 + n < d.N ? ob[o * so.s + (n0 + n) * so.n] : 0.f;
    };
    if (IS_DB)   // rows s, inner q ≥ s
      t.mma<false, false>(
          r0, d.Q,
          [&](int m, int q) {
            const int s = r0 + m;
            if (s >= d.Q || q < s) return 0.f;
            float g = 0.f;
            for (int hs = 0; hs < d.hs; ++hs)
              g += gb[hs * nbc * QQ + q * d.Q + s];
            return g;
          },
          other, sm);
    else         // rows q, inner s ≤ q
      t.mma<true, false>(
          0, imin(d.Q, r0 + T),
          [&](int m, int s) {
            const int q = r0 + m;
            if (q >= d.Q || s > q) return 0.f;
            float g = 0.f;
            for (int hs = 0; hs < d.hs; ++hs)
              g += gb[hs * nbc * QQ + q * d.Q + s];
            return g;
          },
          other, sm);
  }
  float* ob = Part + ((long long)z * nbc + bc) * d.Q * d.N;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + t.row(a), n = n0 + t.col(e);
      if (r < d.Q && n < d.N) ob[r * d.N + n] = t.acc[a][e];
    }
}

// dB or dC [b, S, N] (contiguous, as Part's rows): the sum of Part's KS +
// 1 parts, one thread per element.
__global__ void __launch_bounds__(NE)
    ssd_bwd_dbc_sum_kernel(const float* __restrict__ Part,
                           float* __restrict__ Out, Dims d) {
  const long long n = (long long)d.b * d.S * d.N;
  const long long i = (long long)blockIdx.x * NE + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int z = 0; z <= d.ks; ++z) acc += Part[z * n + i];
  Out[i] = acc;
}

// d(dtA), one block per (b, c, h): ⟨dS_c+1, S_c+1⟩ (Dst against the next
// chunk's entering state, or the final state) added to DA (dA before it,
// [b, S, H]) at the chunk's last step, then summed from the last step
// back, in place.
__global__ void __launch_bounds__(NE)
    ssd_bwd_da_kernel(const float* __restrict__ Dst,
                      const float* __restrict__ Prev,
                      const float* __restrict__ Final,
                      float* __restrict__ DA, Dims d) {
  __shared__ float v[NE];
  const int i = blockIdx.x, h = i % d.H, c = (i / d.H) % d.nc,
            b = i / (d.H * d.nc);
  const int PN = d.P * d.N;
  const float* ds = Dst + (long long)i * PN;
  const float* sn = c + 1 < d.nc ? Prev + (long long)(i + d.H) * PN
                                 : Final + ((long long)b * d.H + h) * PN;
  float dd = 0.f;
  for (int e = threadIdx.x; e < PN; e += NE) dd += ds[e] * sn[e];
  v[threadIdx.x] = dd;
  __syncthreads();
  for (int s = NE / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) v[threadIdx.x] += v[threadIdx.x + s];
    __syncthreads();
  }
  dd = v[0];
  __syncthreads();
  // v[k] = dA at step Q − 1 − k: the suffix sums are v's prefix sums
  float* base = DA + ((long long)b * d.S + c * d.Q) * d.H + h;
  const int k = threadIdx.x, q = d.Q - 1 - k;
  v[k] = k < d.Q ? base[q * d.H] + (k == 0 ? dd : 0.f) : 0.f;
  __syncthreads();
  block_scan(v);
  if (k < d.Q) base[q * d.H] = v[k];
}

}  // namespace

extern "C" {

// dims: 33 int32 in the order of `Dims`; Q ≤ QMAX, hps and kps ≤ MAXH.
// Inputs fp32 with the strides in dims; init may be null. Writes A [b, H,
// S], G [b, nc, Q, Q] (scratch), st [b, nc, H, P, N] (the state entering
// each chunk), final [b, H, P, N] and y [b, S, H, P], all contiguous.
// Returns the first launch's CUDA error (0 on success).
int repro_ssd_fwd(const int* dims, const float* x, const float* dtA,
                  const float* dt, const float* B, const float* C,
                  const float* init, float* A, float* G, float* st,
                  float* fin, float* y, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof d);
  if (d.Q > QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  const unsigned nbch = (unsigned)(d.b * d.nc * d.H), nt = (unsigned)d.nt;
  const unsigned ntp = (unsigned)cdiv(d.P, T), ntn = (unsigned)cdiv(d.N, T);
  ssd_cumsum_kernel<<<nbch, NE, 0, s>>>(dtA, A, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bmm_kernel<<<dim3((unsigned)(d.b * d.nc), nt, nt), NT, 0, s>>>(C, B, G,
                                                                     d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_state_kernel<true><<<dim3(nbch, ntp, ntn), NT, 0, s>>>(
      x, d.x, dt, A, B, d.B, st, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_pass_kernel<<<dim3((unsigned)(d.b * d.H), (unsigned)d.nblk), NE,
                          0, s>>>(st, A, init, fin, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_scan_kernel<<<dim3(nbch, nt, ntp), NT, 0, s>>>(x, dt, A, C, G,
                                                           st, y, d);
  return (int)cudaGetLastError();
}

// The forward's x, dt, B, C, A, st (prev), final and y; dy, and dfinal
// (may be null). Scratch: G [b, nc, Q, Q], dst [b, nc, H, P, N], dgp [hs,
// b, nc, Q, Q], part [ks + 1, b, nc, Q, N]. Writes dx [b, S, H, P], ddtA
// and ddt [b, S, H], dB and dC [b, S, N] and dinit [b, H, P, N], all
// contiguous.
int repro_ssd_bwd(const int* dims, const float* x, const float* dt,
                  const float* B, const float* C, const float* A,
                  const float* prev, const float* fin, const float* y,
                  const float* dy, const float* dfinal, float* G, float* dst,
                  float* dgp, float* part, float* dx, float* ddtA, float* ddt,
                  float* dB, float* dC, float* dinit, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof d);
  if (d.Q > QMAX || d.hps > MAXH || d.kps > MAXH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  const unsigned nbch = (unsigned)(d.b * d.nc * d.H), nt = (unsigned)d.nt;
  const unsigned ntp = (unsigned)cdiv(d.P, T), ntn = (unsigned)cdiv(d.N, T);
  const unsigned nbc = (unsigned)(d.b * d.nc);
  const unsigned nbsn = (unsigned)cdiv(d.b * d.S * d.N, NE);
  ssd_bmm_kernel<<<dim3(nbc, nt, nt), NT, 0, s>>>(C, B, G, d);
  if ((err = (int)cudaGetLastError())) return err;
  // each chunk's dS from its y_off: Σ_q exp(A_q)·dy_q ⊗ C_q
  ssd_chunk_state_kernel<false><<<dim3(nbch, ntp, ntn), NT, 0, s>>>(
      dy, d.dy, dt, A, C, d.C, dst, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_pass_bwd_kernel<<<dim3((unsigned)(d.b * d.H), (unsigned)d.nblk),
                              NE, 0, s>>>(dst, A, dfinal, dinit, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_scan_bwd_dx_kernel<<<dim3(nbch, nt), NT, 0, s>>>(
      x, dt, A, B, G, dy, y, dst, dx, ddt, ddtA, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dcb_kernel<<<dim3(nbc, nt * nt, (unsigned)d.hs), NT, 0, s>>>(
      x, dt, A, dy, dgp, d);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 parts(nbc, nt * ntn, (unsigned)d.ks + 1);
  ssd_bwd_dbc_kernel<false><<<parts, NT, 0, s>>>(dy, d.dy, dt, A, prev, dgp,
                                                 B, d.B, part, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_sum_kernel<<<nbsn, NE, 0, s>>>(part, dC, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_kernel<true><<<parts, NT, 0, s>>>(x, d.x, dt, A, dst, dgp, C,
                                                d.C, part, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_sum_kernel<<<nbsn, NE, 0, s>>>(part, dB, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_da_kernel<<<nbch, NE, 0, s>>>(dst, prev, fin, ddtA, d);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
