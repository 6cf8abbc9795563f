// Chunked SSD (Mamba-2's state-space duality, arXiv:2405.21060 §6) for
// Hopper: the forward in 5 launches and the backward in 9.
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
// product is plain fp32 fmaf on the CUDA cores (the configurations run
// fp32 with TF32 off). What keeps a product from that bound is what feeds
// the FMAs: shared-memory loads per FMA, global loads in the way of the
// products, and work per element of an operand. What the design does:
// - Every product runs through one engine, `Gemm<BM, BN>`: a BM x BN output
//   tile (64 or 128 a side), each thread 8 x 8 outputs in registers, so a
//   step of k costs 4 128-bit shared loads for 64 FMAs. Operands arrive as
//   they lie in device memory, by asynchronous copies (cp.async) into a
//   ring of STAGES slabs 16 deep: 16-byte copies where an operand runs
//   along the tile's side, 4-byte ones where it runs along k (they land
//   transposed, a warp's 32 in distinct banks), zeros past every edge. Two
//   slabs are in flight while one is multiplied; no register holds a slab
//   on its way, and a loader's addresses advance by a stride (no
//   per-element division).
// - A decay, a scale or a causal mask is applied to a slab once it has
//   landed, in shared memory, one multiply per element (from per-step
//   factors staged once per block), so a decayed operand never exists in
//   device memory and the copies carry no arithmetic.
// - Each output tile is one pipelined product over every span of k it
//   needs (y's and du's state part, the tiles below the diagonal and the
//   diagonal tile, each span's slabs rewritten in their own way), so the
//   ring never drains between spans.
// - Tiles of G wholly above the diagonal are never visited (the causal
//   skip halves the Q x Q work), and no Q x Q matrix per head reaches
//   device memory (G itself is [b, nc, Q, Q], once for all heads).
// - On a diagonal tile the decay exp(A_q − A_s) is made from A and masked;
//   below the diagonal it is split at A_r, a step between s and q, into
//   exp(A_q − A_r)·exp(A_r − A_s), so each factor scales a row of an
//   operand or of the result and the tile is a plain product (dG's tiles
//   become one product over all heads and P). Both factors are at most 1
//   where dtA ≤ 0, as a decay is; one that underflows stands for a product
//   that is smaller still. dG's tiles that meet the diagonal take one
//   product per head over P, folded into the sum with its exact masked
//   decay after the head's last slab.
// - A chunk's per-step vectors (A, dt and the decays a tile's operands
//   take) are staged in shared memory (chunks of at most QMAX = 256 steps).
// - Products over all heads (dB's and dC's state parts and dG, over H·P)
//   split their heads over blocks, as many as fill one wave; each head's k
//   range is whole slabs, so a slab's scales come from one head. Splits,
//   and du's p tiles' row sums, are summed in a fixed order by a later
//   kernel (no float atomics: a run repeats bitwise).
// - Launch bounds hold every kernel to the registers it can have without
//   spilling at the blocks per SM that timed best (SSD_MINB*).
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
// (du, so dx, and per p tile d(dt) and dA before its cumulative sum),
// ssd_bwd_dcb (dG, heads split over blocks), ssd_bwd_dg_sum (the splits'
// sum, zero above the diagonal), ssd_bwd_dbc (dC and dB in parts, one
// launch: the states' over the head splits, and dG's), ssd_bwd_dbc_sum
// (the parts' sums) and ssd_bwd_da (the p tiles' sums, ⟨dS, S⟩ and the
// reverse cumulative sum).
//
// Any b, S, H, P, N and Q = min(chunk, S) ≤ QMAX dividing S: tiles are
// masked at every edge, and P and N wider than a tile take more tiles.
// x and dy run along p and then h (the wrapper makes them so), B and C
// along n; their other strides, and dt's and dtA's, are taken as given
// (element strides). Outputs are contiguous. Index arithmetic is int32
// within a tensor (the wrapper raises at 2**31 elements). Launches go on
// the caller's stream; nothing is allocated here.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <cstring>

// Blocks per SM the launch bounds ask for, timed on an H100 at
// mamba2-780m's and granite's shapes (PERF.md §6): 3 for the 128-thread
// product kernels (168 registers; at 4 they spill and run slower, at 2
// they run slower), 4 for ssd_bwd_dbc (128 registers, none spilled), 8 for
// ssd_bmm's 64 threads.
#define SSD_MINB 3
#define SSD_MINB_DBC 4
#define SSD_MINB_BMM 8

namespace {

constexpr int BK = 16;      // depth of a slab
constexpr int STAGES = 3;   // slabs of the ring: two in flight, one in use
constexpr int PAD = 4;      // slab rows stay 16-byte aligned
constexpr int NE = 256;     // threads of the element-wise and state kernels
constexpr int QMAX = 256;   // the longest chunk: per-step vectors in shared memory
constexpr int MAXH = 16;    // the most heads of a split of dB and dC
constexpr int MAXH_DCB = 8; // and of dG

struct S3 { int b, s, h; };   // strides of a [b, S, H] tensor

// Shapes, input strides and the backward's splits. `ssd.py` builds it as
// 26 int32 in this order (and raises where a tensor holds 2**31 elements
// or more).
struct Dims {
  int b, S, H, P, N, Q, nc;
  int xb, xs;                     // x [b, S, H, P]: b and s (h is P, p 1)
  int yb, ys;                     // dy, the same
  S3 dt, dtA;
  int Bb, Bs, Cb, Cs;             // B and C [b, S, N]: b and s (n is 1)
  int hs, hps;                    // ssd_bwd_dcb: splits, heads each
  int ks, kps;                    // ssd_bwd_dbc: splits, heads each
  int nblk;                       // blocks of a state pass per (b, h)
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A slab of an operand that runs along the tile's side W: element (k, m)
// at p[k·ld + m] for k < kn and m < mn, zero elsewhere.
template <int W, int NTH>
__device__ __forceinline__ void load_mn(float (*s)[W + PAD], const float* p,
                                        int ld, int kn, int mn) {
  static_assert(NTH % (W / 4) == 0 && BK % (NTH / (W / 4)) == 0,
                "slab and block disagree");
  constexpr int KS = NTH / (W / 4);   // rows of k a pass covers
  const bool vec = (ld & 3) == 0 && aligned16(p);
  const int m = threadIdx.x % (W / 4) * 4, k0 = threadIdx.x / (W / 4);
  const float* g = p + k0 * ld + m;
#pragma unroll
  for (int r = 0; r < BK / KS; ++r, g += KS * ld) {
    const int k = k0 + r * KS;
    float* d = &s[k][m];
    if (vec && k < kn && m + 4 <= mn) {
      __pipeline_memcpy_async(d, g, 16);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k < kn && m + i < mn)
          __pipeline_memcpy_async(d + i, g + i, 4);
        else
          d[i] = 0.f;
      }
    }
  }
}

// A slab of an operand that runs along k: element (k, m) at p[m·ld + k],
// landing transposed. A warp covers 8 k by 4 m at a time: 32-byte runs of
// a row in device memory, 32 distinct banks in the slab (rows W + PAD
// apart, W + PAD ≡ 4 mod 32).
template <int W, int NTH>
__device__ __forceinline__ void load_k(float (*s)[W + PAD], const float* p,
                                       int ld, int kn, int mn) {
  static_assert(NTH % 64 == 0 && W % (NTH / BK) == 0,
                "slab and block disagree");
  constexpr int MS = NTH / BK;        // rows of m a pass covers
  const int k = threadIdx.x % 8 + threadIdx.x / 32 % 2 * 8,
            m0 = threadIdx.x / 8 % 4 + threadIdx.x / 64 * 4;
  const float* g = p + m0 * ld + k;
  const bool kin = k < kn;
#pragma unroll
  for (int r = 0; r < W / MS; ++r, g += MS * ld) {
    const int m = m0 + r * MS;
    if (kin && m < mn)
      __pipeline_memcpy_async(&s[k][m], g, 4);
    else
      s[k][m] = 0.f;
  }
}

// s[k][m] = f(k, m, s[k][m]) over a landed slab, four neighbouring m a
// thread (one 128-bit load and store).
template <int W, int NTH, class F>
__device__ __forceinline__ void each(float (*s)[W + PAD], const F& f) {
  static_assert(BK * W / 4 % NTH == 0, "slab and block disagree");
#pragma unroll
  for (int r = 0; r < BK * W / 4 / NTH; ++r) {
    const int e = threadIdx.x + r * NTH, k = e / (W / 4), m = e % (W / 4) * 4;
    float4& v = *reinterpret_cast<float4*>(&s[k][m]);
    float4 o = v;
    o.x = f(k, m, o.x);
    o.y = f(k, m + 1, o.y);
    o.z = f(k, m + 2, o.z);
    o.w = f(k, m + 3, o.w);
    v = o;
  }
}

struct NoOp {};
template <class T> constexpr bool is_noop = false;
template <> constexpr bool is_noop<NoOp> = true;

// One block's BM x BN output tile, NTH = BM·BN / 64 threads: thread (ty,
// tx) holds rows ty*4 + {0..3, BM/2..BM/2+3} and columns tx*4 + {0..3,
// BN/2..BN/2+3}, so a warp's 128-bit shared loads of a step of k touch
// 8 and 4 distinct addresses.
template <int BM, int BN>
struct Gemm {
  static constexpr int NTH = BM * BN / 64, TC = BN / 8;
  struct __align__(16) Stage {
    float a[BK][BM + PAD];
    float b[BK][BN + PAD];
  };
  using Ring = Stage[STAGES];

  float acc[8][8];
  int ty, tx;

  __device__ __forceinline__ Gemm()
      : ty(threadIdx.x / TC), tx(threadIdx.x % TC) {
    zero();
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ int row(int i) const {
    return ty * 4 + (i & 3) + (i >> 2) * (BM / 2);
  }
  __device__ __forceinline__ int col(int j) const {
    return tx * 4 + (j & 3) + (j >> 2) * (BN / 2);
  }
  __device__ __forceinline__ void scale(float f) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= f;
  }
  // acc[i][·] *= f(row(i))
  template <class F>
  __device__ __forceinline__ void scale_rows(const F& f) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = f(row(i));
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= s;
    }
  }

  // acc += the products of nk slabs: la(a, t) and lb(b, t) issue slab t's
  // copies into a ring stage; xa(a, t) and xb(b, t), where given, rewrite
  // the landed slab in place (a decay, a scale, a mask); after(t), where
  // given, runs once slab t's products are in acc. Every thread of the
  // block calls it; it leaves the ring free.
  template <class LA, class LB, class XA = NoOp, class XB = NoOp,
            class AF = NoOp>
  __device__ __forceinline__ void run(int nk, Ring& ring, const LA& la,
                                      const LB& lb, const XA& xa = {},
                                      const XB& xb = {},
                                      const AF& after = {}) {
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < nk) {
        la(ring[t].a, t);
        lb(ring[t].b, t);
      }
      __pipeline_commit();
    }
    for (int t = 0; t < nk; ++t) {
      __pipeline_wait_prior(STAGES - 2);
      __syncthreads();   // slab t landed for all; slab t − 1 consumed
      const int nx = t + STAGES - 1;
      if (nx < nk) {
        Stage& n = ring[nx % STAGES];
        la(n.a, nx);
        lb(n.b, nx);
      }
      __pipeline_commit();
      Stage& s = ring[t % STAGES];
      if constexpr (!is_noop<XA> || !is_noop<XB>) {
        if constexpr (!is_noop<XA>) xa(s.a, t);
        if constexpr (!is_noop<XB>) xb(s.b, t);
        __syncthreads();
      }
      mma(s);
      if constexpr (!is_noop<AF>) after(t);
    }
    __syncthreads();
  }

  __device__ __forceinline__ void mma(const Stage& s) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[k][ty * 4 + BM / 2]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.b[k][tx * 4 + BN / 2]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // out[r·ld + c] = acc for the tile's rows r < rn and columns c < cn.
  __device__ __forceinline__ void store(float* out, int ld, int rn,
                                        int cn) const {
    const bool vec = (ld & 3) == 0 && aligned16(out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row(i);
      if (r >= rn) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tx * 4 + h * (BN / 2);
        float* o = out + r * ld + c;
        const float* v = &acc[i][h * 4];
        if (vec && c + 4 <= cn) {
          *reinterpret_cast<float4*>(o) = float4{v[0], v[1], v[2], v[3]};
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < cn) o[e] = v[e];
        }
      }
    }
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
                       (long long)(c * d.Q + q) * d.dtA.s + h * d.dtA.h]
                 : 0.f;
  __syncthreads();
  block_scan(v);
  if (q < d.Q) A[(long long)i * d.Q + q] = v[q];
}

// G[b, c, q, s] = C_q·B_s on the 64 x 64 tiles (i, j) with j ≤ i.
__global__ void __launch_bounds__(64, SSD_MINB_BMM)
    ssd_bmm_kernel(const float* __restrict__ Cm,
                   const float* __restrict__ Bm, float* __restrict__ G,
                   Dims d) {
  using E = Gemm<64, 64>;
  const int i = blockIdx.y, j = blockIdx.z;
  if (j > i) return;
  __shared__ E::Ring ring;
  const int bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int q0 = i * 64, s0 = j * 64;
  const float* cb = Cm + (long long)b * d.Cb + (long long)(c * d.Q + q0) * d.Cs;
  const float* bb = Bm + (long long)b * d.Bb + (long long)(c * d.Q + s0) * d.Bs;
  E t;
  t.run(
      cdiv(d.N, BK), ring,
      [&](auto s, int k) {
        load_k<64, 64>(s, cb + k * BK, d.Cs, d.N - k * BK, d.Q - q0);
      },
      [&](auto s, int k) {
        load_k<64, 64>(s, bb + k * BK, d.Bs, d.N - k * BK, d.Q - s0);
      });
  t.store(G + (long long)bc * d.Q * d.Q + q0 * d.Q + s0, d.Q, d.Q - q0,
          d.Q - s0);
}

// Out[b, c, h, p, n] = Σ_s w_s·V[b, c·Q + s, h, p]·M[b, c·Q + s, n], a 64
// x 128 (p, n) tile. FROM_LAST: w_s = dt_s·exp(A_last − A_s) (V = x, M =
// B: the chunk's own state); else w_s = exp(A_s) (V = dy, M = C: dS from
// the chunk's y_off).
template <bool FROM_LAST>
__global__ void __launch_bounds__(128, SSD_MINB)
    ssd_chunk_state_kernel(const float* __restrict__ V, int vsb, int vss,
                           const float* __restrict__ Dt,
                           const float* __restrict__ A,
                           const float* __restrict__ M, int msb, int mss,
                           float* __restrict__ Out, Dims d) {
  using E = Gemm<64, 128>;
  __shared__ E::Ring ring;
  __shared__ float wv[QMAX];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int p0 = blockIdx.y * 64, n0 = blockIdx.z * 128;
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* vb = V + (long long)b * vsb + cq * vss + h * d.P + p0;
  const float* mb = M + (long long)b * msb + cq * mss + n0;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.h;
  const float a_last = ab[d.Q - 1];
  for (int s = threadIdx.x; s < cdiv(d.Q, BK) * BK; s += E::NTH)
    wv[s] = s >= d.Q    ? 0.f
            : FROM_LAST ? db[s * d.dt.s] * expf(a_last - ab[s])
                        : expf(ab[s]);
  __syncthreads();
  E t;
  t.run(
      cdiv(d.Q, BK), ring,
      [&](auto s, int k) {
        load_mn<64, 128>(s, vb + k * BK * vss, vss, d.Q - k * BK, d.P - p0);
      },
      [&](auto s, int k) {
        load_mn<128, 128>(s, mb + k * BK * mss, mss, d.Q - k * BK, d.N - n0);
      },
      [&](auto s, int k) {
        each<64, 128>(s, [&](int kk, int, float v) {
          return v * wv[k * BK + kk];
        });
      });
  t.store(Out + (long long)pid * d.P * d.N + p0 * d.N + n0, d.N, d.P - p0,
          d.N - n0);
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

// y for one (b, c, h), a 128-row q tile and a 64-column p tile, as one
// product over three spans of k: the state entering the chunk (k = n, C_q
// scaled by exp(A_q) against S_c), the tiles below the diagonal (k = s <
// q0, G_qs scaled by exp(A_q − A_r)·dt_s·exp(A_r − A_s) against x_s, A_r
// the step before the tile) and the diagonal tile (G_qs·exp(A_q − A_s)·
// dt_s, masked causal). Every factor is ≤ 1.
__global__ void __launch_bounds__(128, SSD_MINB)
    ssd_chunk_scan_kernel(const float* __restrict__ X,
                          const float* __restrict__ Dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Cm,
                          const float* __restrict__ G,
                          const float* __restrict__ St,
                          float* __restrict__ Y, Dims d) {
  using E = Gemm<128, 64>;
  __shared__ E::Ring ring;
  __shared__ float av[QMAX], wv[QMAX], eq[128], er[128];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int q0 = blockIdx.y * 128, q1 = imin(q0 + 128, d.Q),
            p0 = blockIdx.z * 64;
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* sb = St + (long long)pid * d.P * d.N + p0 * d.N;
  const float* cb = Cm + (long long)b * d.Cb + (cq + q0) * d.Cs;
  const float* xb = X + (long long)b * d.xb + cq * d.xs + h * d.P + p0;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.h;
  const float* gb = G + (long long)(b * d.nc + c) * d.Q * d.Q + q0 * d.Q;
  // wv: dt_s·exp(A_r − A_s) below the tile, dt_s on it; of the tile's
  // rows eq = exp(A_q), er = exp(A_q − A_r)
  const float a_r = q0 > 0 ? ab[q0 - 1] : 0.f;
  for (int s = threadIdx.x; s < cdiv(q1, BK) * BK; s += E::NTH) {
    av[s] = s < q1 ? ab[s] : 0.f;
    wv[s] = s >= q1  ? 0.f
            : s < q0 ? db[s * d.dt.s] * expf(a_r - av[s])
                     : db[s * d.dt.s];
  }
  {
    const int q = imin(q0 + (int)threadIdx.x, d.Q - 1);
    eq[threadIdx.x] = expf(ab[q]);
    er[threadIdx.x] = expf(ab[q] - a_r);
  }
  __syncthreads();
  const int ns = cdiv(d.N, BK), nb = q0 / BK;   // slabs of the first spans
  E t;
  t.run(
      ns + nb + cdiv(q1 - q0, BK), ring,
      [&](auto s, int k) {
        if (k < ns)
          load_k<128, 128>(s, cb + k * BK, d.Cs, d.N - k * BK, d.Q - q0);
        else
          load_k<128, 128>(s, gb + (k - ns) * BK, d.Q, q1 - (k - ns) * BK,
                           d.Q - q0);
      },
      [&](auto s, int k) {
        if (k < ns)
          load_k<64, 128>(s, sb + k * BK, d.N, d.N - k * BK, d.P - p0);
        else
          load_mn<64, 128>(s, xb + (k - ns) * BK * d.xs, d.xs,
                           q1 - (k - ns) * BK, d.P - p0);
      },
      [&](auto s, int k) {
        if (k < ns) {
          each<128, 128>(s, [&](int, int m, float v) { return v * eq[m]; });
        } else if (k < ns + nb) {
          const float* w = wv + (k - ns) * BK;
          each<128, 128>(s, [&](int kk, int m, float v) {
            return v * er[m] * w[kk];
          });
        } else {
          const int sa = (k - ns) * BK;
          each<128, 128>(s, [&](int kk, int m, float v) {
            const int sx = sa + kk, q = q0 + m;
            return sx <= q && q < d.Q ? v * expf(av[q] - av[sx]) * wv[sx]
                                      : 0.f;
          });
        }
      });
  t.store(Y + (((long long)b * d.S + cq + q0) * d.H + h) * d.P + p0,
          d.H * d.P, d.Q - q0, d.P - p0);
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

// du for one (b, c, h), a 128-row s tile and a 64-column p tile, as one
// product over three spans of k: the chunk state's part (k = n, B_s scaled
// by exp(A_last − A_s) against dS_c+1), the tiles below the diagonal (k =
// q, G_qs scaled by exp(A_q − A_r)·exp(A_r − A_s) against dy_q, A_r the
// tile's last step, so both factors are ≤ 1) and the diagonal tile (G_qs·
// exp(A_q − A_s), masked causal). Then dx = du·dt, and for the tile's p,
// Ddt[z] = Σ_p du·x and DA[z] = Σ_p dy·y − dt·Σ_p du·x at z = the p tile:
// ssd_bwd_da sums the p tiles' parts (d(dt), and dA before the ⟨dS, S⟩
// term and the reverse cumulative sum).
__global__ void __launch_bounds__(128, SSD_MINB)
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
  using E = Gemm<128, 64>;
  // the row sums reuse the ring once the products are done
  union Smem {
    E::Ring ring;
    float red[2][128][E::TC + 1];
  };
  __shared__ Smem sm;
  __shared__ float av[QMAX], wv[QMAX], el[128], er[128];
  const int pid = blockIdx.x, h = pid % d.H, c = (pid / d.H) % d.nc,
            b = pid / (d.H * d.nc);
  const int s0 = blockIdx.y * 128, s1 = imin(s0 + 128, d.Q),
            p0 = blockIdx.z * 64;
  const float* ab = A + ((long long)b * d.H + h) * d.S + c * d.Q;
  const long long cq = (long long)c * d.Q;
  const float* bb = Bm + (long long)b * d.Bb + (cq + s0) * d.Bs;
  const float* dsb = Dst + (long long)pid * d.P * d.N + p0 * d.N;
  const float* gb = G + (long long)(b * d.nc + c) * d.Q * d.Q + s0;
  const float* yb = Dy + (long long)b * d.yb + cq * d.ys + h * d.P + p0;
  // wv: exp(A_q − A_r) below the tile; el, er: exp(A_last − A_s) and
  // exp(A_r − A_s) of the tile's rows
  const float a_r = ab[s1 - 1], a_last = ab[d.Q - 1];
  for (int q = s0 + threadIdx.x; q < cdiv(d.Q, BK) * BK; q += E::NTH) {
    av[q] = q < d.Q ? ab[q] : 0.f;
    wv[q] = q < d.Q ? expf(av[q] - a_r) : 0.f;
  }
  {
    const int sx = imin(s0 + (int)threadIdx.x, d.Q - 1);
    el[threadIdx.x] = expf(a_last - ab[sx]);
    er[threadIdx.x] = expf(a_r - ab[sx]);
  }
  __syncthreads();
  const int ns = cdiv(d.N, BK), nb = cdiv(d.Q - s1, BK);
  // k from ns on: q = s1 + (k − ns)·BK below the diagonal, then
  // s0 + (k − ns − nb)·BK on it
  const auto qk = [&](int k) {
    return k < ns + nb ? s1 + (k - ns) * BK : s0 + (k - ns - nb) * BK;
  };
  const auto qend = [&](int k) { return k < ns + nb ? d.Q : s1; };
  E t;
  t.run(
      ns + nb + cdiv(s1 - s0, BK), sm.ring,
      [&](auto s, int k) {
        if (k < ns) {
          load_k<128, 128>(s, bb + k * BK, d.Bs, d.N - k * BK, d.Q - s0);
        } else {
          const int q = qk(k);
          load_mn<128, 128>(s, gb + q * d.Q, d.Q, qend(k) - q, d.Q - s0);
        }
      },
      [&](auto s, int k) {
        if (k < ns) {
          load_k<64, 128>(s, dsb + k * BK, d.N, d.N - k * BK, d.P - p0);
        } else {
          const int q = qk(k);
          load_mn<64, 128>(s, yb + q * d.ys, d.ys, qend(k) - q, d.P - p0);
        }
      },
      [&](auto s, int k) {
        if (k < ns) {
          each<128, 128>(s, [&](int, int m, float v) { return v * el[m]; });
        } else if (k < ns + nb) {
          const float* w = wv + qk(k);
          each<128, 128>(s, [&](int kk, int m, float v) {
            return v * w[kk] * er[m];
          });
        } else {
          const int qa = qk(k);
          each<128, 128>(s, [&](int kk, int m, float v) {
            const int q = qa + kk, sx = s0 + m;
            return sx <= q && q < d.Q ? v * expf(av[q] - av[sx]) : 0.f;
          });
        }
      });
  // (the epilogue's pointers are made here, not held through the run)
  const float* xb = X + (long long)b * d.xb + cq * d.xs + h * d.P;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s + h * d.dt.h;
  const long long row0 = ((long long)b * d.S + cq) * d.H + h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = s0 + t.row(i);
    float pd = 0.f, py = 0.f;
    if (s < d.Q) {
      const float dts = db[s * d.dt.s];
      const long long row = row0 + (long long)s * d.H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + t.col(j);
        if (p < d.P) {
          Dx[row * d.P + p] = t.acc[i][j] * dts;
          pd += t.acc[i][j] * xb[s * d.xs + p];
          py += yb[s * d.ys + p - p0] * Y[row * d.P + p];
        }
      }
    }
    sm.red[0][t.row(i)][t.tx] = pd;
    sm.red[1][t.row(i)][t.tx] = py;
  }
  __syncthreads();
  const int r = threadIdx.x, s = s0 + r;
  if (s < s1) {
    float sd = 0.f, sy = 0.f;
    for (int x = 0; x < E::TC; ++x) {
      sd += sm.red[0][r][x];
      sy += sm.red[1][r][x];
    }
    const long long at =
        (long long)blockIdx.z * d.b * d.S * d.H + row0 + (long long)s * d.H;
    Ddt[at] = sd;
    DA[at] = sy - db[s * d.dt.s] * sd;
  }
}

// dG[hs, b, c, q, s] = Σ_{h in split hs} exp(A_q − A_s)·dy_q·u_s on the
// 128 x 64 (q, s) tiles that hold some s ≤ q; a split holds at most
// MAXH_DCB heads, each head's P whole slabs (the last one zero-padded).
__global__ void __launch_bounds__(128, SSD_MINB)
    ssd_bwd_dcb_kernel(const float* __restrict__ X,
                       const float* __restrict__ Dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Dy,
                       float* __restrict__ DGp, Dims d) {
  using E = Gemm<128, 64>;
  const int ntj = cdiv(d.Q, 64), i = blockIdx.y / ntj, j = blockIdx.y % ntj;
  const int q0 = i * 128, s0 = j * 64;
  if (s0 >= imin(q0 + 128, d.Q)) return;   // wholly above the diagonal
  const bool below = s0 + 64 <= q0;        // wholly below it
  __shared__ E::Ring ring;
  __shared__ float tr[MAXH_DCB][128], tc[2][MAXH_DCB][64];
  const int bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int hs = blockIdx.z, h0 = hs * d.hps, h1 = imin(d.H, h0 + d.hps);
  const int P = d.P, sph = cdiv(P, BK);
  const long long cq = (long long)c * d.Q;
  const float* ab = A + (long long)b * d.H * d.S + cq;
  const float* yq = Dy + (long long)b * d.yb + (cq + q0) * d.ys;
  const float* xs = X + (long long)b * d.xb + (cq + s0) * d.xs;
  const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s;
  // per head of the split: below the diagonal dy's scale exp(A_q − A_r)
  // (tr) and u's dt_s·exp(A_r − A_s) (tc[0]), A_r the step before the
  // tile (both ≤ 1); on it A_q (tr), dt_s (tc[0]) and A_s (tc[1])
  for (int e = threadIdx.x; e < (h1 - h0) * 128; e += E::NTH) {
    const int hh = e / 128, m = e % 128;
    const float* ah = ab + (long long)(h0 + hh) * d.S;
    const float aq = ah[imin(q0 + m, d.Q - 1)];
    tr[hh][m] = below ? expf(aq - ah[q0 - 1]) : aq;
  }
  for (int e = threadIdx.x; e < (h1 - h0) * 64; e += E::NTH) {
    const int hh = e / 64, n = e % 64, h = h0 + hh, sx = imin(s0 + n, d.Q - 1);
    const float* ah = ab + (long long)h * d.S;
    const float dts = db[sx * d.dt.s + h * d.dt.h];
    tc[0][hh][n] = below ? dts * expf(ah[q0 - 1] - ah[sx]) : dts;
    tc[1][hh][n] = ah[sx];
  }
  __syncthreads();
  // slab k: head h0 + k / sph, p from (k % sph)·BK
  const auto la = [&](auto s, int k) {
    const int kk = k % sph * BK;
    load_k<128, 128>(s, yq + (h0 + k / sph) * P + kk, d.ys, P - kk, d.Q - q0);
  };
  const auto lb = [&](auto s, int k) {
    const int kk = k % sph * BK;
    load_k<64, 128>(s, xs + (h0 + k / sph) * P + kk, d.xs, P - kk, d.Q - s0);
  };
  const int nk = (h1 - h0) * sph;
  E t;
  if (below) {
    // one product over (head, p)
    t.run(
        nk, ring, la, lb,
        [&](auto s, int k) {
          const float* w = tr[k / sph];
          each<128, 128>(s, [&](int, int m, float v) { return v * w[m]; });
        },
        [&](auto s, int k) {
          const float* w = tc[0][k / sph];
          each<64, 128>(s, [&](int, int n, float v) { return v * w[n]; });
        });
  } else {
    // one product per head, folded in with its masked decay
    float dg[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) dg[a][e] = 0.f;
    t.run(nk, ring, la, lb, NoOp{}, NoOp{}, [&](int k) {
      if ((k + 1) % sph) return;
      const int hh = k / sph;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = t.row(a), q = q0 + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int cc = t.col(e);
          if (s0 + cc <= q && q < d.Q)
            dg[a][e] = fmaf(expf(tr[hh][r] - tc[1][hh][cc]) * tc[0][hh][cc],
                            t.acc[a][e], dg[a][e]);
          t.acc[a][e] = 0.f;
        }
      }
    });
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) t.acc[a][e] = dg[a][e];
  }
  t.store(DGp + ((long long)hs * gridDim.x + bc) * d.Q * d.Q + q0 * d.Q + s0,
          d.Q, d.Q - q0, d.Q - s0);
}

// dG [b, c, q, s]: the sum of DGp's HS splits where s ≤ q, 0 above the
// diagonal (tiles there were never written), one thread per element.
__global__ void __launch_bounds__(NE)
    ssd_bwd_dg_sum_kernel(const float* __restrict__ DGp,
                          float* __restrict__ DG, Dims d) {
  const long long n = (long long)d.b * d.nc * d.Q * d.Q;
  const long long i = (long long)blockIdx.x * NE + threadIdx.x;
  if (i >= n) return;
  const int s = (int)(i % d.Q), q = (int)(i / d.Q % d.Q);
  float acc = 0.f;
  if (s <= q)
    for (int z = 0; z < d.hs; ++z) acc += DGp[z * n + i];
  DG[i] = acc;
}

// dC (blockIdx.z ≤ KS, rows q) and dB (above, rows s) in KS + 1 parts
// each, Part[w, z, b, c, r, n] for a 128 x 64 (r, n) tile: z < KS the
// states' part over the heads of split z (at most MAXH), Σ_h exp(A_q)·dy_q
// S_cᵀ for dC and Σ_h exp(A_last − A_s)·u_s dS_c+1ᵀ for dB; z = KS dG's
// part, Σ_{s≤q} dG_qs B_s for dC and Σ_{q≥s} dG_qs C_q for dB (dG is zero
// above the diagonal, so its products need no mask).
__global__ void __launch_bounds__(128, SSD_MINB_DBC)
    ssd_bwd_dbc_kernel(const float* __restrict__ X,
                       const float* __restrict__ Dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Dy,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ Prev,
                       const float* __restrict__ Dst,
                       const float* __restrict__ DG,
                       float* __restrict__ Part, Dims d) {
  using E = Gemm<128, 64>;
  __shared__ E::Ring ring;
  __shared__ float wr[MAXH][128];
  const int nbc = gridDim.x, bc = blockIdx.x, b = bc / d.nc, c = bc % d.nc;
  const int ntn = cdiv(d.N, 64);
  const int r0 = blockIdx.y / ntn * 128, n0 = blockIdx.y % ntn * 64;
  const bool is_db = (int)blockIdx.z > d.ks;
  const int z = blockIdx.z - (is_db ? d.ks + 1 : 0), P = d.P;
  const long long cq = (long long)c * d.Q, QQ = (long long)d.Q * d.Q;
  E t;
  if (z < d.ks) {
    const int h0 = z * d.kps, h1 = imin(d.H, h0 + d.kps), sph = cdiv(P, BK);
    const float* ab = A + (long long)b * d.H * d.S + cq;
    const float* vr = is_db ? X + (long long)b * d.xb + (cq + r0) * d.xs
                            : Dy + (long long)b * d.yb + (cq + r0) * d.ys;
    const int vs = is_db ? d.xs : d.ys;
    const float* stb =
        (is_db ? Dst : Prev) + (long long)bc * d.H * P * d.N + n0;
    const float* db = Dt + (long long)b * d.dt.b + cq * d.dt.s;
    // each row's scale per head of the split
    for (int e = threadIdx.x; e < (h1 - h0) * 128; e += E::NTH) {
      const int hh = e / 128, m = e % 128, h = h0 + hh;
      const int r = imin(r0 + m, d.Q - 1);
      const float* ah = ab + (long long)h * d.S;
      wr[hh][m] = is_db ? db[r * d.dt.s + h * d.dt.h] *
                              expf(ah[d.Q - 1] - ah[r])
                        : expf(ah[r]);
    }
    __syncthreads();
    t.run(
        (h1 - h0) * sph, ring,
        [&](auto s, int k) {
          const int kk = k % sph * BK;
          load_k<128, 128>(s, vr + (h0 + k / sph) * P + kk, vs, P - kk,
                           d.Q - r0);
        },
        [&](auto s, int k) {
          const int kk = k % sph * BK;
          load_mn<64, 128>(s, stb + (long long)((h0 + k / sph) * P + kk) * d.N,
                           d.N, P - kk, d.N - n0);
        },
        [&](auto s, int k) {
          const int hh = k / sph;
          each<128, 128>(s, [&](int, int m, float v) {
            return v * wr[hh][m];
          });
        });
  } else if (!is_db) {
    // rows q, inner s < min(Q, r0 + 128)
    const int k1 = imin(d.Q, r0 + 128);
    const float* gq = DG + bc * QQ + (long long)r0 * d.Q;
    const float* bs = Bm + (long long)b * d.Bb + cq * d.Bs + n0;
    t.run(
        cdiv(k1, BK), ring,
        [&](auto s, int k) {
          load_k<128, 128>(s, gq + k * BK, d.Q, k1 - k * BK, d.Q - r0);
        },
        [&](auto s, int k) {
          load_mn<64, 128>(s, bs + (long long)k * BK * d.Bs, d.Bs,
                           k1 - k * BK, d.N - n0);
        });
  } else {
    // rows s, inner q ≥ r0
    const float* gs = DG + bc * QQ + (long long)r0 * d.Q + r0;
    const float* cs = Cm + (long long)b * d.Cb + (cq + r0) * d.Cs + n0;
    t.run(
        cdiv(d.Q - r0, BK), ring,
        [&](auto s, int k) {
          load_mn<128, 128>(s, gs + (long long)k * BK * d.Q, d.Q,
                            d.Q - r0 - k * BK, d.Q - r0);
        },
        [&](auto s, int k) {
          load_mn<64, 128>(s, cs + (long long)k * BK * d.Cs, d.Cs,
                           d.Q - r0 - k * BK, d.N - n0);
        });
  }
  t.store(Part + ((long long)blockIdx.z * nbc + bc) * d.Q * d.N +
              (long long)r0 * d.N + n0,
          d.N, d.Q - r0, d.N - n0);
}

// dC and dB [b, S, N] (contiguous, as Part's rows): the sums of Part's KS
// + 1 parts each, one thread per element.
__global__ void __launch_bounds__(NE)
    ssd_bwd_dbc_sum_kernel(const float* __restrict__ Part,
                           float* __restrict__ DC, float* __restrict__ DB,
                           Dims d) {
  const long long n = (long long)d.b * d.S * d.N;
  const long long i = (long long)blockIdx.x * NE + threadIdx.x;
  if (i >= 2 * n) return;
  const int w = i >= n;
  const float* pp = Part + (long long)w * (d.ks + 1) * n + (i - w * n);
  float acc = 0.f;
  for (int z = 0; z <= d.ks; ++z) acc += pp[z * n];
  (w ? DB : DC)[i - w * n] = acc;
}

// d(dtA) and d(dt), one block per (b, c, h): DA and Ddt hold NTP parts
// ([NTP, b, S, H], one per 64-column p tile of ssd_chunk_scan_bwd_dx);
// Ddt's sum is d(dt), and ⟨dS_c+1, S_c+1⟩ (Dst against the next chunk's
// entering state, or the final state) is added to DA's at the chunk's
// last step, then summed from the last step back into DAout. DA and
// DAout, Ddt and DdtOut may be the same where NTP is 1.
__global__ void __launch_bounds__(NE)
    ssd_bwd_da_kernel(const float* __restrict__ Dst,
                      const float* __restrict__ Prev,
                      const float* __restrict__ Final, const float* DA,
                      float* DAout, const float* Ddt, float* DdtOut,
                      Dims d) {
  __shared__ float v[NE];
  const int i = blockIdx.x, h = i % d.H, c = (i / d.H) % d.nc,
            b = i / (d.H * d.nc);
  const int PN = d.P * d.N, ntp = cdiv(d.P, 64);
  const long long part = (long long)d.b * d.S * d.H;
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
  const long long base = ((long long)b * d.S + c * d.Q) * d.H + h;
  const int k = threadIdx.x, q = d.Q - 1 - k;
  float a = 0.f;
  if (k < d.Q) {
    float g = 0.f;
    for (int z = 0; z < ntp; ++z) {
      a += DA[z * part + base + q * d.H];
      g += Ddt[z * part + base + q * d.H];
    }
    if (ntp > 1) DdtOut[base + q * d.H] = g;
    a += k == 0 ? dd : 0.f;
  }
  v[k] = a;
  __syncthreads();
  block_scan(v);
  if (k < d.Q) DAout[base + q * d.H] = v[k];
}

}  // namespace

extern "C" {

// dims: 26 int32 in the order of `Dims`; Q ≤ QMAX. Inputs fp32 with the
// strides in dims; init may be null. Writes A [b, H, S], G [b, nc, Q, Q]
// (scratch), st [b, nc, H, P, N] (the state entering each chunk), final
// [b, H, P, N] and y [b, S, H, P], all contiguous. Returns the first
// launch's CUDA error (0 on success).
int repro_ssd_fwd(const int* dims, const float* x, const float* dtA,
                  const float* dt, const float* B, const float* C,
                  const float* init, float* A, float* G, float* st,
                  float* fin, float* y, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof d);
  if (d.Q > QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  const unsigned nbch = (unsigned)(d.b * d.nc * d.H);
  const unsigned nt64 = (unsigned)cdiv(d.Q, 64);
  ssd_cumsum_kernel<<<nbch, NE, 0, s>>>(dtA, A, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bmm_kernel<<<dim3((unsigned)(d.b * d.nc), nt64, nt64), 64, 0, s>>>(
      C, B, G, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_state_kernel<true>
      <<<dim3(nbch, (unsigned)cdiv(d.P, 64), (unsigned)cdiv(d.N, 128)), 128,
         0, s>>>(x, d.xb, d.xs, dt, A, B, d.Bb, d.Bs, st, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_pass_kernel<<<dim3((unsigned)(d.b * d.H), (unsigned)d.nblk), NE,
                          0, s>>>(st, A, init, fin, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_scan_kernel<<<dim3(nbch, (unsigned)cdiv(d.Q, 128),
                               (unsigned)cdiv(d.P, 64)),
                          128, 0, s>>>(x, dt, A, C, G, st, y, d);
  return (int)cudaGetLastError();
}

// The forward's x, dt, B, C, A, st (prev), final and y; dy, and dfinal
// (may be null). Scratch: G [b, nc, Q, Q] (G, then dG), dst [b, nc, H, P,
// N], dgp [hs, b, nc, Q, Q], part [2, ks + 1, b, nc, Q, N], and dap and
// ddtp [ceil(P / 64), b, S, H] (ddtA and ddt themselves where P ≤ 64).
// Writes dx [b, S, H, P], ddtA and ddt [b, S, H], dB and dC [b, S, N] and
// dinit [b, H, P, N], all contiguous.
int repro_ssd_bwd(const int* dims, const float* x, const float* dt,
                  const float* B, const float* C, const float* A,
                  const float* prev, const float* fin, const float* y,
                  const float* dy, const float* dfinal, float* G, float* dst,
                  float* dgp, float* part, float* dap, float* ddtp, float* dx,
                  float* ddtA, float* ddt,
                  float* dB, float* dC, float* dinit, void* stream) {
  Dims d;
  std::memcpy(&d, dims, sizeof d);
  if (d.Q > QMAX || d.hps > MAXH_DCB || d.kps > MAXH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  const unsigned nbch = (unsigned)(d.b * d.nc * d.H);
  const unsigned nbc = (unsigned)(d.b * d.nc), nt64 = (unsigned)cdiv(d.Q, 64);
  const unsigned nt128 = (unsigned)cdiv(d.Q, 128);
  ssd_bmm_kernel<<<dim3(nbc, nt64, nt64), 64, 0, s>>>(C, B, G, d);
  if ((err = (int)cudaGetLastError())) return err;
  // each chunk's dS from its y_off: Σ_q exp(A_q)·dy_q ⊗ C_q
  ssd_chunk_state_kernel<false>
      <<<dim3(nbch, (unsigned)cdiv(d.P, 64), (unsigned)cdiv(d.N, 128)), 128,
         0, s>>>(dy, d.yb, d.ys, dt, A, C, d.Cb, d.Cs, dst, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_state_pass_bwd_kernel<<<dim3((unsigned)(d.b * d.H), (unsigned)d.nblk),
                              NE, 0, s>>>(dst, A, dfinal, dinit, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_chunk_scan_bwd_dx_kernel<<<dim3(nbch, nt128, (unsigned)cdiv(d.P, 64)),
                                 128, 0, s>>>(x, dt, A, B, G, dy, y, dst, dx,
                                              ddtp, dap, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dcb_kernel<<<dim3(nbc, nt128 * nt64, (unsigned)d.hs), 128, 0, s>>>(
      x, dt, A, dy, dgp, d);
  if ((err = (int)cudaGetLastError())) return err;
  // G is free once du is: it takes dG
  ssd_bwd_dg_sum_kernel<<<(unsigned)cdiv(d.b * d.nc * d.Q * d.Q, NE), NE, 0,
                          s>>>(dgp, G, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_kernel<<<dim3(nbc, nt128 * (unsigned)cdiv(d.N, 64),
                            2 * ((unsigned)d.ks + 1)),
                       128, 0, s>>>(x, dt, A, dy, B, C, prev, dst, G, part,
                                    d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_sum_kernel<<<(unsigned)cdiv(2 * d.b * d.S * d.N, NE), NE, 0,
                           s>>>(part, dC, dB, d);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_da_kernel<<<nbch, NE, 0, s>>>(dst, prev, fin, dap, ddtA, ddtp, ddt,
                                        d);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
