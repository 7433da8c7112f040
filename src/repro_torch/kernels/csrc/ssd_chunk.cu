// Mamba-2 SSD intra-chunk step (kernel K3), forward and backward, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the Pallas TPU kernel `ssd_chunk_pallas`
// (src/repro/kernels/ssd_chunk.py:62, body `_kernel` :33-58). Per cell
// (sequence b, chunk k, head h), with c tokens, N state and P head dims:
//
//   cum    = cumsum(da)                                  [c]
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0        [c,c]
//   S[i,j] = (C B^T)[i,j] * L[i,j] * dt_j
//   y      = S x                                          [c,P]
//   states = (B * dt * exp(cum_end - cum))^T x            [N,P]
//
// The backward (no TPU model: the Pallas kernel cannot be differentiated)
// is the gradient of that function; see the backward section below.
//
// Layouts (model layout, no copies): C and B are [Bsz, S, N] with a token
// stride `ld_cb` (one B/C group shared by every head, as Mamba-2 has it:
// the TPU path broadcast them to all heads first); x is [Bsz, S, H, P]
// with a token stride `ld_x` and heads contiguous; da, dt, cum are fp32
// [Bsz, S, H]; y is fp32 [Bsz, S, H, P]; states fp32 [Bsz, nc, H, N, P];
// dx is contiguous [Bsz, S, H, P] in x's type, dC and dB [Bsz, S, N].
// C, B and x are fp32 or bf16 and are upcast as they are loaded; all
// arithmetic is fp32. Some products run on the tensor cores in TF32 with
// each fp32 operand split into two TF32 halves, which keeps fp32's
// precision (plain TF32 would miss the 1e-4 limit); bf16 values are exact
// in TF32 and are not split. The others run on the CUDA cores, each
// thread a 4 x 4 (or 8 x 4) register tile fed by 16-byte shared reads.
//
// What bounds it: at mamba2-370m's c=256, N=128, P=64 a cell does some
// 9.4 MFLOP forward on 0.1 MB of inputs, far above the card's ridge, so
// fp32 operations bound it. exp(cum_i - cum_j) is formed only where i >=
// j: above the diagonal it overflows at c=256 (the sum of dt there is
// about 190), and inf * 0 would poison the backward.
//
// C and B are shared by the heads, so C B^T belongs to the (sequence,
// chunk), not to the cell: k3_cb forms it once a chunk, as 64 x 64 tile
// pairs (it, jt), jt <= it, on the tensor cores, for both directions.
//
// Forward: a block per cell formed C B^T again for each of the 32 heads
// (51% of its work) and took the states in a second pass. k3_fwd_heads
// takes a group of heads of a chunk (the count chosen by the waves of
// blocks the card takes). Row tile by row tile, each head of the group
// walks the column tiles jt <= it of the row: the first head loads C
// B^T's tiles of the row into shared memory and every head reads them
// there; a step forms S = C B^T * L * dt_j of the pair and y += S x.
// Off the diagonal L is E_i D F_j, a row's and a column's factor formed
// once a head and one exponential a pair (see the kernel). In the last
// row a step also adds (B w)^T x of its column tile, w = exp(cum_end -
// cum) dt, so the states take no pass of their own. Every step's
// operands (x, and B times w in the last row, through registers into
// fp32; C B^T's tile by cp.async) are loaded while the step before is
// formed, into the other of two stages. cum is a running sum a head
// (see the kernel). Both products run on the tensor cores (mma.sync,
// split TF32: S and B w split, x where it is fp32): on an H100 at one
// 4096-token row they took 31% longer on the CUDA cores.
//
// Backward: C B^T, dC and dB belong to the chunk, not the head, and 62% of
// a per-head block's work formed them again for each of the 32 heads. So
// C B^T is formed once a (sequence, chunk) (k3_cb), a block takes a
// group of up to four heads of a chunk (k3_bwd_heads: the count chosen by
// the waves of blocks the card takes) and sums the score gradient M over
// them, and dC = (sum M) B and dB = (sum M)^T C run once a chunk after the
// groups are summed in order (k3_bwd_dcb): 9.7 GFLOP at one 4096-token
// row against the per-head design's 30.9. The heads block walks 64-wide
// tile pairs and loads each step's operands (cp.async; x through
// registers into fp32) while the step before is formed. C B^T, dS = dy
// x^T and the end-state products run on the tensor cores (mma.sync,
// split TF32: two products a step where x or B is bf16, three where both
// operands are fp32); dx += S^T dy, whose operands are both fp32, runs
// on the CUDA cores, each thread a 4 x 4 register tile fed by 16-byte
// shared reads, and so do dC and dB. No atomics, in either direction:
// two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int T = 32;     // chunk lengths: multiples of T
constexpr int NT = 256;   // threads per block
constexpr int TX = 16;    // thread grid 16 x 16 over every product
constexpr int TY = 16;

constexpr int BT = 64;               // rows and columns of a tile
constexpr int LDT = BT + 4;          // row stride of [*][BT] fp32 tiles
constexpr int BG = 4;                // most heads a k3_bwd_heads block
constexpr int FG = 8;                // most heads a k3_fwd_heads block
constexpr int SLAB = 4;              // C B^T tiles of a row k3_fwd_heads holds
constexpr int RB = 16;               // rows a k3_bwd_dcb block
constexpr int SMEM_MAX = 232448;     // shared memory an H100 block may use

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.f;
}

// V consecutive elements of shared memory as floats (16-byte aligned
// for four floats, 8-byte for four bf16)
template <int V>
__device__ __forceinline__ void ldv(float (&o)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x, o[1] = v.y;
  } else {
    o[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void ldv(float (&o)[V], const __nv_bfloat16* p) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(u.x << 16), o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16), o[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (V == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    o[0] = __uint_as_float(u << 16), o[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    o[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// the column of a thread's n-th output when B is read along n (below)
template <int RN>
__device__ __forceinline__ int ncol(int tx, int n) {
  return RN <= 4 ? tx * RN + n : (n / 4) * 64 + tx * 4 + n % 4;
}

// acc[r][n] += sum_{k < K} A(m_r, k) B(k, col_n) over shared-memory
// operands on the CUDA cores, four k at a time (K % 4 == 0): a thread's
// rows are m_r = ty RM + r, its columns col_n = ncol<RN>(tx, n). A_KC:
// A(m, k) = A[m lda + k], else A[k lda + m]; B(k, n) = B[k ldb + n].
// Each k brings RM + RN values for RM x RN FMAs; a warp reads A at two
// rows (two ty), broadcast, and B along 16 threads' columns.
template <int RM, int RN, bool A_KC, typename TA, typename TB>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], int K, const TA* A,
                                   int lda, const TB* B, int ldb) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float a[RM][4], b[RN][4];
    if constexpr (A_KC) {
#pragma unroll
      for (int r = 0; r < RM; ++r) ldv<4>(a[r], A + (ty * RM + r) * lda + k);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float v[RM];
        ldv<RM>(v, A + (k + kk) * lda + ty * RM);
#pragma unroll
        for (int r = 0; r < RM; ++r) a[r][kk] = v[r];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (RN <= 4) {
        float v[RN];
        ldv<RN>(v, B + (k + kk) * ldb + tx * RN);
#pragma unroll
        for (int n = 0; n < RN; ++n) b[n][kk] = v[n];
      } else {
#pragma unroll
        for (int q = 0; q < RN / 4; ++q) {
          float v[4];
          ldv<4>(v, B + (k + kk) * ldb + q * 64 + tx * 4);
#pragma unroll
          for (int n = 0; n < 4; ++n) b[q * 4 + n][kk] = v[n];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int n = 0; n < RN; ++n)
          acc[r][n] = fmaf(a[r][kk], b[n][kk], acc[r][n]);
  }
}

// d[16 x 8] += a[16 x 8] b[8 x 8] on the tensor cores: TF32 operands,
// fp32 sums. Lane l holds a at rows l/4 (+8), cols l%4 (+4); b at rows
// l%4 (+4), col l/4; d at rows l/4 (+8), cols 2 (l%4) (+1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v as TF32 hi and, when SPLIT, lo = v - hi in TF32 too: an fp32 value
// is carried to some 2^-22 of itself by hi + lo; a bf16 value is exact
// in TF32 (lo is not formed)
template <bool SPLIT, int V>
__device__ __forceinline__ void to_tf32(const float (&v)[V], uint32_t (&hi)[V],
                                        uint32_t (&lo)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    hi[i] = SPLIT ? tf32(v[i]) : __float_as_uint(v[i]);
    if constexpr (SPLIT) lo[i] = tf32(v[i] - __uint_as_float(hi[i]));
  }
}

// The warp's acc[n][e] (rows m0 + l/4 + 8 (e / 2), cols n0 + 8 n + 2 (l%4)
// + e % 2, for lane l) += sum_{k < K} A(m, k) B(k, n) over shared-memory
// operands, eight k at a time on the tensor cores (K % 8 == 0). A(m, k)
// = A[m lda + k] when A_KC, else A[k lda + m]; B(k, n) = B[n ldb + k]
// when B_KC, else B[k ldb + n]. SA / SB: that operand is fp32 and is
// split (hi + lo), and the products hi hi', hi lo', lo hi' are summed
// (lo lo' lies below fp32's precision); else it is taken as exact. With
// every row stride 4 floats past a multiple of 32, a warp's 32 reads of
// an operand fall on 32 banks.
template <int NN, bool A_KC, bool B_KC, bool SA, bool SB, typename TA,
          typename TB>
__device__ __forceinline__ void wmm(float (&acc)[NN][4], int K, const TA* A,
                                    int lda, const TB* B, int ldb, int m0,
                                    int n0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  auto a_at = [&](int m, int k) {
    return ldf(A_KC ? A + m * lda + k : A + k * lda + m);
  };
  auto b_at = [&](int k, int n) {
    return ldf(B_KC ? B + n * ldb + k : B + k * ldb + n);
  };
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a_at(m0 + g, k0 + t), a_at(m0 + g + 8, k0 + t),
                         a_at(m0 + g, k0 + t + 4),
                         a_at(m0 + g + 8, k0 + t + 4)};
    uint32_t ah[4], al[4];
    to_tf32<SA>(av, ah, al);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float bv[2] = {b_at(k0 + t, n0 + 8 * n + g),
                           b_at(k0 + t + 4, n0 + 8 * n + g)};
      uint32_t bh[2], bl[2];
      to_tf32<SB>(bv, bh, bl);
      if constexpr (SB) mma_tf32(acc[n], ah, bl);
      if constexpr (SA) mma_tf32(acc[n], al, bh);
      mma_tf32(acc[n], ah, bh);
    }
  }
}

// nrows rows of W elements from global (row stride ld) into shared
// memory (row stride lds), 16 bytes a cp.async; rows at or past `rows`
// are zero-filled
template <int W, typename E>
__device__ __forceinline__ void tile_async(E* s, int lds, const E* g, long ld,
                                           int rows, int nrows = BT) {
  constexpr int V = 16 / sizeof(E), CPR = W / V;
  for (int q = threadIdx.x; q < nrows * CPR; q += NT) {
    const int r = q / CPR, cc = q - r * CPR;
    const bool in = r < rows;
    cp_async16(s + r * lds + cc * V, in ? g + r * ld + cc * V : g, in);
  }
}

// a 16-byte chunk of In values, stored to shared memory as floats
template <typename In>
__device__ __forceinline__ void st_chunk(float* s, const uint4& v) {
  if constexpr (sizeof(In) == 4) {
    *reinterpret_cast<uint4*>(s) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(s + 4 * i) = make_float4(
          __uint_as_float(w[2 * i] << 16),
          __uint_as_float(w[2 * i] & 0xffff0000u),
          __uint_as_float(w[2 * i + 1] << 16),
          __uint_as_float(w[2 * i + 1] & 0xffff0000u));
  }
}

// inclusive scan of a[0, 32 per) by one warp: prefix sums, or with
// `reverse` suffix sums (a[k] <- sum_{i >= k} a[i]). Each lane sums its
// run of `per` elements in order, then the runs' totals are scanned
// across the lanes
__device__ __forceinline__ void warp_scan(float* a, int per, bool reverse) {
  const int lane = threadIdx.x & 31, n = 32 * per;
  float run = 0.f;
  for (int i = 0; i < per; ++i) {
    const int k = lane * per + i, idx = reverse ? n - 1 - k : k;
    run += a[idx];
    a[idx] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const float up = __shfl_up_sync(0xffffffffu, incl, 1);
  const float excl = lane > 0 ? up : 0.f;
  for (int i = 0; i < per; ++i) {
    const int k = lane * per + i;
    a[reverse ? n - 1 - k : k] += excl;
  }
}

// the pair index of tile pair (it, jt), jt <= it, and back
__device__ __forceinline__ int pair_id(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// C B^T of one tile pair (row tile it of C, column tile jt of B, jt <=
// it) of one (sequence, chunk), fp32, [BT][BT] into cbw: the operand the
// forward and the backward share. Eight warps of 16 x 32; bf16 C and B
// are exact in TF32 (one product), fp32 ones split
template <typename In, int N>
__global__ void __launch_bounds__(NT)
    k3_cb(const In* __restrict__ C, const In* __restrict__ B,
              float* __restrict__ cbw, int S, int c, long ld_cb) {
  constexpr int LDN = N + 16 / sizeof(In);
  constexpr bool F32 = sizeof(In) == 4;
  extern __shared__ float4 smv[];
  In* sC = reinterpret_cast<In*>(smv);
  In* sB = sC + BT * LDN;
  const int nt = (c + BT - 1) / BT, npairs = nt * (nt + 1) / 2;
  const int pr = blockIdx.x, nc = S / c;
  const long bk = blockIdx.y, tok0 = (bk / nc) * S + (bk % nc) * c;
  int it = 0;
  while (pair_id(it + 1, 0) <= pr) ++it;
  const int jt = pr - pair_id(it, 0);
  tile_async<N>(sC, LDN, C + (tok0 + it * BT) * ld_cb, ld_cb, c - it * BT);
  tile_async<N>(sB, LDN, B + (tok0 + jt * BT) * ld_cb, ld_cb, c - jt * BT);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 16 * (warp & 3), wn = 32 * (warp >> 2);
  float acc[4][4];
  zero(acc);
  wmm<4, true, true, F32, F32>(acc, N, sC, LDN, sB, LDN, wm, wn);
  float* out = cbw + (bk * npairs + pr) * (long)(BT * BT);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(wm + (lane >> 2) + 8 * (e >> 1)) * BT + wn + 8 * n +
          2 * (lane & 3) + (e & 1)] = acc[n][e];
}

// ------------------------------------------------------------------ forward
// a 16-byte chunk of In values times w, stored to shared memory as floats
template <typename In>
__device__ __forceinline__ void st_scaled(float* s, const uint4& v, float w) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(In) == 4) {
    *reinterpret_cast<float4*>(s) =
        make_float4(__uint_as_float(u[0]) * w, __uint_as_float(u[1]) * w,
                    __uint_as_float(u[2]) * w, __uint_as_float(u[3]) * w);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(s + 4 * i) = make_float4(
          __uint_as_float(u[2 * i] << 16) * w,
          __uint_as_float(u[2 * i] & 0xffff0000u) * w,
          __uint_as_float(u[2 * i + 1] << 16) * w,
          __uint_as_float(u[2 * i + 1] & 0xffff0000u) * w);
  }
}

// a warp's fragments acc (n8 tile n: rows m0 + l/4 (+ 8), columns n0 +
// 8 n + 2 (l%4) (+ 1), for lane l) loaded from or stored to rows of g
// (row stride ld), two columns at a time; rows at or past `rows` are
// left alone
template <int NN>
__device__ __forceinline__ void frag_io(float (&acc)[NN][4], float* g,
                                        long ld, int m0, int n0, int rows,
                                        bool store) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + (l >> 2) + 8 * h;
      if (r >= rows) continue;
      float2* q = reinterpret_cast<float2*>(g + r * ld + n0 + 8 * n +
                                            2 * (l & 3));
      if (store) {
        *q = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      } else {
        const float2 v = *q;
        acc[n][2 * h] = v.x, acc[n][2 * h + 1] = v.y;
      }
    }
}

// k3_fwd_heads' shared memory, byte offsets (host and device)
struct FwdSmem {
  int cb, s, x, b, vec, total;
  __host__ __device__ FwdSmem(int c, int N, int P, int G) {
    const int nt = (c + BT - 1) / BT;
    cb = 0;                               // C B^T: SLAB tiles of a row
    s = cb + (nt < SLAB ? nt : SLAB) * BT * LDT * 4;  // S of the pair
    x = s + BT * LDT * 4;                 // 2 stages: x's column tile
    b = x + 2 * BT * (P + 8) * 4;         // 2 stages: B's column tile * w
    vec = b + 2 * BT * (N + 8) * 4;       // cum, dt, w, E, F dt: a head each
    total = vec + 5 * G * nt * BT * 4;
  }
};

// a step of k3_fwd_heads: head g of the group on tile pair (it, jt);
// it < 0 is past the last
struct FwdStep {
  int it, g, jt;
};

// y, states and cum of the heads [h0, h0 + Gv) of one (sequence, chunk),
// given C B^T's tile pairs in cbw (k3_cb). Row tiles it in turn; in each,
// the column tiles jt <= it go by segments of SLAB, and in a segment each
// head walks its tiles: the first head loads C B^T's tile of each step
// into the segment's slot, the others read it there. A step forms S =
// C B^T * L * dt_j of the pair (the decay L below) and y_it += S x_jt,
// kept in registers over the head's walk of the segment (over several
// segments, for c > SLAB * BT, added to what the segment before wrote);
// in the last row it also adds (B_jt w)^T x_jt to the head's states.
// Both products run on the tensor cores in split TF32 (S and B w split,
// x where it is fp32): y by warps of 16 rows (wm) and half the columns
// (wh), the states by warps of 16 of the N rows.
template <typename In, int N, int P>
__global__ void __launch_bounds__(NT, 1)
    k3_fwd_heads(const In* __restrict__ B, const In* __restrict__ x,
                 const float* __restrict__ da, const float* __restrict__ dt,
                 const float* __restrict__ cbw, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cum_out,
                 int S, int H, int c, int G, long ld_cb, long ld_x) {
  // x's and B w's row strides, 8 floats past a multiple of 32: a warp's
  // fragment reads down their columns fall on 32 banks
  constexpr int LDP = P + 8, LDB = N + 8;
  constexpr int NY = P / 16, NS = P / 8;    // n8 tiles of a warp's y, states
  constexpr bool F32 = sizeof(In) == 4;
  constexpr int E = 16 / sizeof(In);        // elements a 16-byte load
  constexpr int XCPR = P / E, XV = (BT * XCPR + NT - 1) / NT;
  constexpr int BCPR = N / E, BV = (BT * BCPR + NT - 1) / NT;
  extern __shared__ float4 smv[];
  unsigned char* smb = reinterpret_cast<unsigned char*>(smv);
  const FwdSmem lay(c, N, P, G);
  float* sCB = reinterpret_cast<float*>(smb + lay.cb);
  float* sS = reinterpret_cast<float*>(smb + lay.s);
  float* sX = reinterpret_cast<float*>(smb + lay.x);
  float* sB = reinterpret_cast<float*>(smb + lay.b);
  const int nt = (c + BT - 1) / BT, cpad = nt * BT, npairs = nt * (nt + 1) / 2;
  float* sCum = reinterpret_cast<float*>(smb + lay.vec);
  float* sDt = sCum + G * cpad;
  float* sW = sDt + G * cpad;
  float* sE = sW + G * cpad;
  float* sFd = sE + G * cpad;

  const int tid = threadIdx.x, warp = tid >> 5, nc = S / c;
  const int wm = 16 * (warp & 3), wh = warp >> 2;   // a warp's y rows, half
  const long bk = blockIdx.y, tok0 = (bk / nc) * S + (bk % nc) * c;
  const int h0 = blockIdx.x * G, Gv = min(G, H - h0);
  const long ldh = (long)H * P;  // token stride of y

  for (int t = tid; t < G * cpad; t += NT) {
    const int g = t / cpad, i = t - g * cpad;
    const bool in = g < Gv && i < c;
    const long gi = (tok0 + i) * H + h0 + g;
    sCum[t] = in ? da[gi] : 0.f;
    sDt[t] = in ? dt[gi] : 0.f;
  }
  __syncthreads();
  // cum by a thread a head, in token order: the decay takes cum_i - cum_j
  // of nearby tokens, which a running sum carries within a rounding or
  // two of |cum| (some 200 at c = 256), where warp_scan's lanes, whose
  // totals are scanned by a tree, round apart by several (its y missed
  // the 1e-4 limit)
  if (tid < Gv) {
    float* cum = sCum + tid * cpad;
    float run = 0.f;
    for (int t = 0; t < c; ++t) cum[t] = run += cum[t];
  }
  __syncthreads();
  // off the diagonal (tile pairs it > jt, every i > j) the decay is
  // exp(cum_i - cum_j) = E_i D F_j: E_i = exp(cum_i - cum_s), s the token
  // before i's tile; F_j = exp(cum_r - cum_j), r the last token of j's
  // tile; D = exp(cum_s - cum_r), one a pair. Each factor is at most 1
  // and a step forms no exponential an element
  for (int t = tid; t < Gv * cpad; t += NT) {
    const int g = t / cpad, i = t - g * cpad;
    const float* cum = sCum + g * cpad;
    const int s0 = i / BT * BT, r = min(s0 + BT, c) - 1;
    sW[t] = i < c ? expf(cum[c - 1] - cum[i]) * sDt[t] : 0.f;
    sE[t] = i < c && s0 > 0 ? expf(cum[i] - cum[s0 - 1]) : 0.f;
    sFd[t] = i < c ? expf(cum[r] - cum[i]) * sDt[t] : 0.f;
    if (i < c) cum_out[(tok0 + i) * H + h0 + g] = cum[i];
  }
  __syncthreads();

  // the last column tile of jt's segment in row it
  auto seg_end = [&](int it, int jt) {
    return min((jt / SLAB + 1) * SLAB, it + 1) - 1;
  };
  auto next = [&](const FwdStep& s) -> FwdStep {
    if (s.jt < seg_end(s.it, s.jt)) return {s.it, s.g, s.jt + 1};
    if (s.g + 1 < Gv) return {s.it, s.g + 1, s.jt / SLAB * SLAB};
    if (s.jt < s.it) return {s.it, 0, s.jt + 1};
    if (s.it + 1 < nt) return {s.it + 1, 0, 0};
    return {-1, 0, 0};
  };
  uint4 xr[XV], br[BV];
  // step s's operands: x's column tile (and in the last row B's) into
  // registers, and at a segment's first head C B^T's tile of the pair
  // into its slot by cp.async
  auto issue = [&](const FwdStep& s) {
    const int rows = c - s.jt * BT;
    const In* xg = x + (tok0 + s.jt * BT) * ld_x + (long)(h0 + s.g) * P;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int q = tid + v * NT, r = q / XCPR, cc = q - r * XCPR;
      xr[v] = q < BT * XCPR && r < rows
                  ? __ldg(reinterpret_cast<const uint4*>(xg + r * ld_x + cc * E))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    if (s.it == nt - 1) {
      const In* bg = B + (tok0 + s.jt * BT) * ld_cb;
#pragma unroll
      for (int v = 0; v < BV; ++v) {
        const int q = tid + v * NT, r = q / BCPR, cc = q - r * BCPR;
        br[v] = q < BT * BCPR && r < rows
                    ? __ldg(reinterpret_cast<const uint4*>(bg + r * ld_cb +
                                                            cc * E))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (s.g == 0)
      tile_async<BT>(sCB + (s.jt % SLAB) * BT * LDT, LDT,
                     cbw + (bk * npairs + pair_id(s.it, s.jt)) *
                               (long)(BT * BT),
                     BT, BT);
    cp_async_commit();  // empty where no tile was issued
  };
  // step s's registers into stage st (B times head g's w), and its C
  // B^T tile landed: seen by every thread
  auto land = [&](const FwdStep& s, int st) {
    float* xs = sX + st * BT * LDP;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int q = tid + v * NT, r = q / XCPR, cc = q - r * XCPR;
      if (q < BT * XCPR) st_chunk<In>(xs + r * LDP + cc * E, xr[v]);
    }
    if (s.it == nt - 1) {
      float* bs = sB + st * BT * LDB;
      const float* w = sW + s.g * cpad + s.jt * BT;
#pragma unroll
      for (int v = 0; v < BV; ++v) {
        const int q = tid + v * NT, r = q / BCPR, cc = q - r * BCPR;
        if (q < BT * BCPR) st_scaled<In>(bs + r * LDB + cc * E, br[v], w[r]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  float yacc[NY][4], sacc[NS][4];
  FwdStep cur = {0, 0, 0};
  int st = 0;
  issue(cur);
  land(cur, 0);
  for (;;) {
    const FwdStep nx = next(cur);
    const int slot = cur.jt % SLAB;
    // the next step's C B^T tile would overwrite the slot this step
    // reads: issue it once this step is done
    const bool late = nx.it >= 0 && nx.g == 0 && nx.jt % SLAB == slot;
    if (nx.it >= 0 && !late) issue(nx);
    const int i0 = cur.it * BT, j0 = cur.jt * BT, h = h0 + cur.g;
    const float* cum = sCum + cur.g * cpad;
    const float* dtp = sDt + cur.g * cpad;
    const float* cbt = sCB + slot * BT * LDT;
    // S of the pair: each thread four runs of four columns
    const int c4 = (tid & 15) * 4;
    if (cur.it == cur.jt) {
      float cj[4], dj[4];
      ldv<4>(cj, cum + j0 + c4);
      ldv<4>(dj, dtp + j0 + c4);
#pragma unroll
      for (int q = 0; q < BT * BT / 4 / NT; ++q) {
        const int r = (q * NT + tid) >> 4, gi = i0 + r;
        const float ci = cum[gi];
        float cb[4], s[4];
        ldv<4>(cb, cbt + r * LDT + c4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // exp only where i >= j: above, cum_i - cum_j is a positive
          // sum of dt that overflows at c = 256
          const float L =
              (gi >= j0 + c4 + u && gi < c) ? expf(ci - cj[u]) : 0.f;
          s[u] = cb[u] * L * dj[u];
        }
        stv<4>(sS + r * LDT + c4, s);
      }
    } else {
      const float D = expf(cum[i0 - 1] - cum[j0 + BT - 1]);
      const float* Eg = sE + cur.g * cpad;
      float fd[4];
      ldv<4>(fd, sFd + cur.g * cpad + j0 + c4);
#pragma unroll
      for (int q = 0; q < BT * BT / 4 / NT; ++q) {
        const int r = (q * NT + tid) >> 4;
        const float ed = Eg[i0 + r] * D;
        float cb[4], s[4];
        ldv<4>(cb, cbt + r * LDT + c4);
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = cb[u] * ed * fd[u];
        stv<4>(sS + r * LDT + c4, s);
      }
    }
    __syncthreads();
    const float* xs = sX + st * BT * LDP;
    const bool last_row = cur.it == nt - 1;
    float* yg = y + (tok0 + i0) * ldh + (long)h * P;
    float* sg = states + (bk * H + h) * (long)(N * P);
    if (slot == 0) {
      // the head's first step of the segment: y (and the states) start
      // at 0, or at what the row's segment before wrote
      zero(yacc);
      zero(sacc);
      if (cur.jt > 0) {
        frag_io(yacc, yg, ldh, wm, wh * (P / 2), c - i0, false);
        if (last_row) frag_io(sacc, sg, P, 16 * warp, 0, N, false);
      }
    }
    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,
                                    wh * (P / 2));
    if (last_row && 16 * warp < N)
      wmm<NS, false, false, true, F32>(sacc, BT, sB + st * BT * LDB, LDB,
                                       xs, LDP, 16 * warp, 0);
    if (cur.jt == seg_end(cur.it, cur.jt)) {
      frag_io(yacc, yg, ldh, wm, wh * (P / 2), c - i0, true);
      if (last_row) frag_io(sacc, sg, P, 16 * warp, 0, N, true);
    }
    if (nx.it < 0) break;
    if (late) {
      __syncthreads();
      issue(nx);
    }
    land(nx, st ^ 1);
    cur = nx;
    st ^= 1;
  }
}

// ----------------------------------------------------------------- backward
// Given dy [c,P], dst [N,P] and dcum [c] of a cell (sequence, chunk,
// head), with S_ij = CB_ij L_ij dt_j, M_ij = dS_ij L_ij dt_j and
// Q_ij = dS_ij CB_ij L_ij (all for i >= j, else 0), dS = dy x^T,
// e_j = exp(cum_end - cum_j), w_j = e_j dt_j and q_j = x_j . (B dst)_j:
//
//   dx_j   = sum_i S_ij dy_i + w_j (B dst)_j
//   dC     = (sum_h M_h) B                     (one product a chunk)
//   dB     = (sum_h M_h)^T C + sum_h w_h x_h dst_h^T
//   ddt_j  = sum_i Q_ij + e_j q_j
//   dcum_k = dcum_k + sum_j Q_kj dt_j - dt_k sum_i Q_ik - w_k q_k
//            + [k = c-1] sum_j w_j q_j
//   dda_k  = sum_{i >= k} dcum_i
//
// C B^T and the sums over heads belong to the chunk, not the head, so
// three kernels run in turn: k3_cb forms C B^T once a (sequence,
// chunk); k3_bwd_heads takes a group of heads of a chunk and writes
// everything per head (dx, dda, ddt) and the group's sums of M and of
// w x dst^T; k3_bwd_dcb sums the groups in order and forms dC and dB.
// k3_bwd_heads' shared memory, byte offsets (host and device)
struct HeadsSmem {
  int a, x, s, red, cb, bt, dx, vec, total;
  __host__ __device__ HeadsSmem(int c, int N, int P, int elt, int G) {
    const int ldp = P + 4, ldn = N + 16 / elt;
    const int cpad = (c + BT - 1) / BT * BT;
    a = 0;                           // 2 stages: dy's row tile or dst rows
    x = a + 2 * BT * ldp * 4;        // 2 stages: x's column tile, fp32
    s = x + 2 * BT * ldp * 4;        // S of the tile pair
    red = s + BT * LDT * 4;          // warps' partial row and column sums
    cb = red + 8 * BT * 4;           // C B^T of the tile pair
    bt = cb + BT * LDT * 4;          // B's column tile, In
    dx = bt + (BT * ldn * elt + 15) / 16 * 16;   // dx's column, a head each
    vec = dx + G * BT * P * 4;       // cum, dt, rowR, colQ, q, a head each
    total = vec + 5 * G * cpad * 4;
  }
};

// a step of k3_bwd_heads: kind 0 takes head g's end-state terms of column
// tile jt (rows `half` of dst), kind 1 the tile pair (it, jt) of head
// g; kind -1 is past the last
struct Step {
  int kind, jt, it, g, half;
};

// Everything per head of the heads [h0, h0 + Gv) of one (sequence,
// chunk), and the group's sums of M (per tile pair, into msw) and of
// w x dst^T (into xdw). Column tiles jt in turn; each starts with its
// end-state steps (dx = w B dst, q, the group's w x dst^T), then walks
// the tile pairs (it >= jt) and, inside each, the heads: C B^T is read
// once for the group and M summed over it. Every step's operands (dy
// or dst rows by cp.async, x through registers into fp32) are loaded
// while the step before is formed, into the other of two stages. dS and
// the end-state products run on the tensor cores, by warps of 16 rows
// (wm) and half the columns (wh), their fp32 operands (dy, dst; x and B
// when fp32) split in two TF32 halves; dx += S^T dy runs on the CUDA
// cores
template <typename In, int N, int P>
__global__ void __launch_bounds__(NT, 1)
    k3_bwd_heads(const In* __restrict__ B, const In* __restrict__ x,
                 const float* __restrict__ da, const float* __restrict__ dt,
                 const float* __restrict__ dy, const float* __restrict__ dst,
                 const float* __restrict__ dcum, In* __restrict__ dx,
                 float* __restrict__ dda, float* __restrict__ ddt,
                 const float* __restrict__ cbw, float* __restrict__ msw,
                 float* __restrict__ xdw, int S, int H, int c, int G,
                 long ld_cb, long ld_x) {
  constexpr int LDP = P + 4, LDN = N + 16 / sizeof(In);
  constexpr int NH = N < BT ? N : BT, HALVES = N / NH;  // dst rows a step
  constexpr int NP = P / 16, NQ = NH / 16;  // n8 tiles of a warp's columns
  constexpr int RP = P / TX;                // dx columns of a thread
  constexpr int XE = 16 / sizeof(In), XCPR = P / XE, XV = BT * XCPR / NT;
  constexpr bool F32 = sizeof(In) == 4;
  extern __shared__ float4 smv[];
  unsigned char* smb = reinterpret_cast<unsigned char*>(smv);
  const HeadsSmem lay(c, N, P, sizeof(In), G);
  float* sA = reinterpret_cast<float*>(smb + lay.a);
  float* sX = reinterpret_cast<float*>(smb + lay.x);
  float* sS = reinterpret_cast<float*>(smb + lay.s);
  float* sCQ = reinterpret_cast<float*>(smb + lay.red);  // [4][BT]
  float* sRQ = sCQ + 4 * BT;                             // [2][BT]
  float* sCB = reinterpret_cast<float*>(smb + lay.cb);
  In* sBt = reinterpret_cast<In*>(smb + lay.bt);
  float* sDX = reinterpret_cast<float*>(smb + lay.dx);
  const int nt = (c + BT - 1) / BT, cpad = nt * BT, npairs = nt * (nt + 1) / 2;
  float* sCum = reinterpret_cast<float*>(smb + lay.vec);
  float* sDt = sCum + G * cpad;
  float* sRowR = sDt + G * cpad;
  float* sColQ = sRowR + G * cpad;
  float* sQ = sColQ + G * cpad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid / TX, tx = tid % TX;
  const int fg = lane >> 2, ft = lane & 3;          // fragment row, column
  const int wm = 16 * (warp & 3), wh = warp >> 2;   // warp's rows, half
  const int grp = blockIdx.x, ngroups = gridDim.x, nc = S / c;
  const long bk = blockIdx.y, tok0 = (bk / nc) * S + (bk % nc) * c;
  const int h0 = grp * G, Gv = min(G, H - h0);
  const long ldh = (long)H * P;  // token stride of dy and dx

  for (int t = tid; t < G * cpad; t += NT) {
    const int g = t / cpad, i = t - g * cpad;
    const bool in = g < Gv && i < c;
    const long gi = (tok0 + i) * H + h0 + g;
    sCum[t] = in ? da[gi] : 0.f;
    sDt[t] = in ? dt[gi] : 0.f;
    sRowR[t] = sColQ[t] = sQ[t] = 0.f;
  }
  __syncthreads();
  if (warp < Gv) warp_scan(sCum + warp * cpad, cpad / 32, false);
  __syncthreads();

  auto next = [&](const Step& s) -> Step {
    if (s.kind == 0) {
      if (s.half + 1 < HALVES) return {0, s.jt, 0, s.g, s.half + 1};
      if (s.g + 1 < Gv) return {0, s.jt, 0, s.g + 1, 0};
      return {1, s.jt, s.jt, 0, 0};
    }
    if (s.g + 1 < Gv) return {1, s.jt, s.it, s.g + 1, 0};
    if (s.it + 1 < nt) return {1, s.jt, s.it + 1, 0, 0};
    if (s.jt + 1 < nt) return {0, s.jt + 1, 0, 0, 0};
    return {-1, 0, 0, 0, 0};
  };
  uint4 xr[XV];
  // step s's operands into stage st: x's column tile into registers,
  // dy's row tile or dst's rows by cp.async, with C B^T at a tile pair's
  // first head and B's column tile at a column's first step
  auto issue = [&](const Step& s, int st) {
    const int h = h0 + s.g, rows = c - s.jt * BT;
    const In* xg = x + (tok0 + s.jt * BT) * ld_x + (long)h * P;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int q = tid + v * NT, r = q / XCPR, cc = q - r * XCPR;
      xr[v] = r < rows
                  ? __ldg(reinterpret_cast<const uint4*>(xg + r * ld_x + cc * XE))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    float* a = sA + st * BT * LDP;
    if (s.kind == 1) {
      tile_async<P>(a, LDP, dy + (tok0 + s.it * BT) * ldh + (long)h * P, ldh,
                    c - s.it * BT);
      if (s.g == 0)
        tile_async<BT>(sCB, LDT,
                       cbw + (bk * npairs + pair_id(s.it, s.jt)) *
                                 (long)(BT * BT),
                       BT, BT);
    } else {
      tile_async<P>(a, LDP, dst + ((bk * H + h) * N + s.half * NH) * (long)P,
                    P, NH, NH);
      if (s.g == 0 && s.half == 0)
        tile_async<N>(sBt, LDN, B + (tok0 + s.jt * BT) * ld_cb, ld_cb, rows);
    }
    cp_async_commit();
  };
  // the stage issued last has landed and is seen by every thread
  auto land = [&](int st) {
    float* xs = sX + st * BT * LDP;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int q = tid + v * NT, r = q / XCPR, cc = q - r * XCPR;
      st_chunk<In>(xs + r * LDP + cc * XE, xr[v]);
    }
    cp_async_wait<0>();
    __syncthreads();
  };
  // the row (of a [BT][*] tile) and column of fragment element e of n8
  // tile n, for a warp whose columns start at col0
  auto frow = [&](int e) { return wm + fg + 8 * (e >> 1); };
  auto fcol = [&](int col0, int n, int e) {
    return col0 + 8 * n + 2 * ft + (e & 1);
  };

  Step cur = {0, 0, 0, 0, 0};
  int st = 0;
  issue(cur, 0);
  land(0);
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * BT;
    // end-state steps: dx_h = w_h B dst_h and q_h of the column, and the
    // group's w x dst^T over its rows
    float xd[HALVES][NQ][4];
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) zero(xd[hf]);
    for (int g = 0; g < Gv; ++g) {
      const float* cum = sCum + g * cpad;
      const float cend = cum[c - 1];
      float wv[2], bd[NP][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + wm + fg + 8 * h;
        wv[h] = j < c ? expf(cend - cum[j]) * sDt[g * cpad + j] : 0.f;
      }
      zero(bd);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        const Step nx = next(cur);     // never past the last: pairs follow
        issue(nx, st ^ 1);
        const float* ds = sA + st * BT * LDP;    // dst rows hf NH ...
        const float* xs = sX + st * BT * LDP;
        wmm<NP, true, false, F32, true>(bd, NH, sBt + hf * NH, LDN, ds, LDP,
                                        wm, wh * (P / 2));
        float tp[NQ][4];
        zero(tp);
        wmm<NQ, true, true, F32, true>(tp, P, xs, LDP, ds, LDP, wm,
                                       wh * (NH / 2));
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xd[hf][n][e] += wv[e >> 1] * tp[n][e];
        if (hf == HALVES - 1) {
          // q_j = x_j . (B dst)_j, and dx starts at w_j (B dst)_j
          float* dxs = sDX + g * BT * P;
          float qp[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = frow(e), p = fcol(wh * (P / 2), n, e);
              qp[e >> 1] = fmaf(xs[r * LDP + p], bd[n][e], qp[e >> 1]);
              dxs[r * P + p] = wv[e >> 1] * bd[n][e];
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            qp[h] += __shfl_xor_sync(0xffffffffu, qp[h], 1);
            qp[h] += __shfl_xor_sync(0xffffffffu, qp[h], 2);
            if (ft == 0) sRQ[wh * BT + wm + fg + 8 * h] = qp[h];
          }
          __syncthreads();
          if (tid < BT) sQ[g * cpad + j0 + tid] = sRQ[tid] + sRQ[BT + tid];
        }
        land(st ^ 1);
        cur = nx;
        st ^= 1;
      }
    }
    float* xo = xdw + ((bk * ngroups + grp) * cpad + j0) * (long)N;
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xo[frow(e) * N + hf * NH + fcol(wh * (NH / 2), n, e)] = xd[hf][n][e];

    // the tile pairs (it, jt), it >= jt, each over the group's heads
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * BT;
      float cbr[4][4], msum[4][4];
      for (int g = 0; g < Gv; ++g) {
        if (g == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cbr[n][e] = sCB[frow(e) * LDT + fcol(wh * 32, n, e)];
          zero(msum);
          __syncthreads();             // the C B^T stage is refilled below
        }
        const Step nx = next(cur);
        if (nx.kind >= 0) issue(nx, st ^ 1);
        const float* dys = sA + st * BT * LDP;
        const float* xs = sX + st * BT * LDP;
        // dS = dy x^T on the pair
        float dsc[4][4];
        zero(dsc);
        wmm<4, true, true, true, F32>(dsc, P, dys, LDP, xs, LDP, wm, wh * 32);
        const float* cum = sCum + g * cpad;
        const float* dtp = sDt + g * cpad;
        float ci[2], rr[2] = {0.f, 0.f}, cq[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) ci[h] = cum[i0 + wm + fg + 8 * h];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          cq[n][0] = cq[n][1] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gi = i0 + frow(e), jj = fcol(wh * 32, n, e);
            const int gj = j0 + jj;
            const float cj = cum[gj], dj = dtp[gj];
            // exp only where i >= j: above, cum_i - cum_j is a positive
            // sum of dt that overflows at c = 256
            const float L = (gi >= gj && gi < c) ? expf(ci[e >> 1] - cj) : 0.f;
            const float sdt = L * dj, m = dsc[n][e] * sdt;
            msum[n][e] += m;
            rr[e >> 1] = fmaf(m, cbr[n][e], rr[e >> 1]);           // Q dt_j
            cq[n][e & 1] = fmaf(dsc[n][e] * cbr[n][e], L, cq[n][e & 1]);  // Q
            sS[frow(e) * LDT + jj] = cbr[n][e] * sdt;
          }
        }
        // the warps' partial row sums (over their 32 columns) and column
        // sums (over their 16 rows), added in order below
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rr[h] += __shfl_xor_sync(0xffffffffu, rr[h], 1);
          rr[h] += __shfl_xor_sync(0xffffffffu, rr[h], 2);
          if (ft == 0) sRQ[wh * BT + wm + fg + 8 * h] = rr[h];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cq[n][e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              v += __shfl_xor_sync(0xffffffffu, v, o);
            if (fg == 0) sCQ[(warp & 3) * BT + fcol(wh * 32, n, e)] = v;
          }
        __syncthreads();
        if (tid < BT) {
          sColQ[g * cpad + j0 + tid] += (sCQ[tid] + sCQ[BT + tid]) +
                                        (sCQ[2 * BT + tid] + sCQ[3 * BT + tid]);
          sRowR[g * cpad + i0 + tid] += sRQ[tid] + sRQ[BT + tid];
        }
        // dx_h of the column += S^T dy, on the CUDA cores: both operands
        // are fp32, and their three split products cost the tensor cores
        // more than the 4 x RP register tiles do here
        float* dxs = sDX + g * BT * P + (ty * 4) * P + tx * RP;
        float dacc[4][RP];
#pragma unroll
        for (int a = 0; a < 4; ++a) ldv<RP>(dacc[a], dxs + a * P);
        mm<4, RP, false>(dacc, BT, sS, LDT, dys, LDP);
#pragma unroll
        for (int a = 0; a < 4; ++a) stv<RP>(dxs + a * P, dacc[a]);
        if (nx.kind >= 0) {
          land(st ^ 1);
        } else {
          __syncthreads();
        }
        cur = nx;
        st ^= 1;
      }
      float* mo = msw + ((bk * ngroups + grp) * npairs + pair_id(it, jt)) *
                            (long)(BT * BT);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mo[frow(e) * BT + fcol(wh * 32, n, e)] = msum[n][e];
    }
    // dx of the column, each head; the next column's first steps write
    // the dx stage again
    for (int q = tid; q < Gv * BT * P; q += NT) {
      const int g = q / (BT * P), r = q / P - g * BT, p = q % P;
      if (j0 + r < c)
        stf(dx + (tok0 + j0 + r) * ldh + (long)(h0 + g) * P + p, sDX[q]);
    }
    __syncthreads();
  }

  // ddt and dcum per token; then dda = reverse cumsum of dcum
  if (warp < Gv) {
    const int g = warp;
    const long h = h0 + g;
    const float* cum = sCum + g * cpad;
    const float* dtp = sDt + g * cpad;
    const float* colq = sColQ + g * cpad;
    const float* qv = sQ + g * cpad;
    float* v = sRowR + g * cpad;
    const float cend = cum[c - 1];
    float us = 0.f;
    for (int t = lane; t < cpad; t += 32) {
      float vt = 0.f;
      if (t < c) {
        const long gi = (tok0 + t) * H + h;
        const float e = expf(cend - cum[t]), q = qv[t], u = e * dtp[t] * q;
        ddt[gi] = colq[t] + e * q;
        us += u;
        vt = dcum[gi] + v[t] - dtp[t] * colq[t] - u;
      }
      v[t] = vt;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) us += __shfl_xor_sync(0xffffffffu, us, o);
    __syncwarp();
    if (lane == 0) v[c - 1] += us;
    __syncwarp();
    warp_scan(v, cpad / 32, true);
    __syncwarp();
    for (int t = lane; t < c; t += 32) dda[(tok0 + t) * H + h] = v[t];
  }
}

// dC and dB of RB rows of one (sequence, chunk): the groups' sums of M
// added in group order, then dC = M B and dB = M^T C + the groups' w x
// dst^T, added in group order
template <typename In, int N>
__global__ void __launch_bounds__(NT)
    k3_bwd_dcb(const In* __restrict__ C, const In* __restrict__ B,
               const float* __restrict__ msw, const float* __restrict__ xdw,
               In* __restrict__ dC, In* __restrict__ dB, int S, int c,
               int ngroups, long ld_cb) {
  constexpr int LDN = N + 16 / sizeof(In), RN = N / TX, LDR = RB + 4;
  constexpr int RM = RB / TY;
  extern __shared__ float4 smv[];
  float* sM = reinterpret_cast<float*>(smv);   // [RB][LDT]: rows of M
  float* sMT = sM + RB * LDT;                  // [BT][LDR]: cols of M
  In* sT = reinterpret_cast<In*>(sMT + BT * LDR);  // [BT][LDN]: B or C
  const int nt = (c + BT - 1) / BT, cpad = nt * BT, npairs = nt * (nt + 1) / 2;
  const int r0 = blockIdx.x * RB, t0 = r0 / BT, off = r0 % BT, nc = S / c;
  const long bk = blockIdx.y, tok0 = (bk / nc) * S + (bk % nc) * c;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const long gstride = (long)npairs * BT * BT;
  const float* ms = msw + bk * ngroups * gstride;
  float accC[RM][RN], accB[RM][RN];
  zero(accC);
  zero(accB);
  // dC's rows: tile pairs (t0, jt), jt <= t0
  for (int jt = 0; jt <= t0; ++jt) {
    tile_async<N>(sT, LDN, B + (tok0 + jt * BT) * ld_cb, ld_cb, c - jt * BT);
    cp_async_commit();
    const float* m = ms + pair_id(t0, jt) * (long)(BT * BT) + off * BT;
    for (int q = tid; q < RB * BT / 4; q += NT) {
      const int r = q / (BT / 4), cc = q - r * (BT / 4);
      float4 s = __ldg(reinterpret_cast<const float4*>(m + r * BT + cc * 4));
#pragma unroll 4
      for (int g = 1; g < ngroups; ++g) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(
            m + g * gstride + r * BT + cc * 4));
        s.x += u.x, s.y += u.y, s.z += u.z, s.w += u.w;
      }
      *reinterpret_cast<float4*>(sM + r * LDT + cc * 4) = s;
    }
    cp_async_wait<0>();
    __syncthreads();
    mm<RM, RN, true>(accC, BT, sM, LDT, sT, LDN);
    __syncthreads();
  }
  // dB's rows: tile pairs (it, t0), it >= t0
  for (int it = t0; it < nt; ++it) {
    tile_async<N>(sT, LDN, C + (tok0 + it * BT) * ld_cb, ld_cb, c - it * BT);
    cp_async_commit();
    const float* m = ms + pair_id(it, t0) * (long)(BT * BT) + off;
    for (int q = tid; q < BT * RB / 4; q += NT) {
      const int i = q / (RB / 4), cc = q - i * (RB / 4);
      float4 s = __ldg(reinterpret_cast<const float4*>(m + i * BT + cc * 4));
#pragma unroll 4
      for (int g = 1; g < ngroups; ++g) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(
            m + g * gstride + i * BT + cc * 4));
        s.x += u.x, s.y += u.y, s.z += u.z, s.w += u.w;
      }
      *reinterpret_cast<float4*>(sMT + i * LDR + cc * 4) = s;
    }
    cp_async_wait<0>();
    __syncthreads();
    mm<RM, RN, false>(accB, BT, sMT, LDR, sT, LDN);
    __syncthreads();
  }
  const float* xd = xdw + bk * ngroups * (long)cpad * N;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int r = r0 + ty * RM + a;
    if (r >= c) continue;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int col = ncol<RN>(tx, n);
      float v = accB[a][n];
#pragma unroll 4
      for (int g = 0; g < ngroups; ++g)
        v += xd[((long)g * cpad + r) * N + col];
      stf(dC + (tok0 + r) * N + col, accC[a][n]);
      stf(dB + (tok0 + r) * N + col, v);
    }
  }
}

// ------------------------------------------------------------- launches
// the card's SMs, read once per device
int sm_count() {
  static int sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return sms[dev];
}

// heads a block of a heads kernel: of the counts up to gmax whose shared
// memory (smem(G) bytes) fits a block, the one whose waves of blocks (one
// an SM) over nbk chunks take least, a block's time taken as G + `fixed`
// heads' worth
template <typename Smem>
int heads_per_block(int gmax, double fixed, Smem smem, long nbk, int H) {
  const long sms = sm_count();
  int best = 1;
  double best_t = 0;
  for (int G = gmax < H ? gmax : H; G >= 1; --G) {
    if (smem(G) > SMEM_MAX) continue;
    const long blocks = nbk * ((H + G - 1) / G);
    const double t = (double)((blocks + sms - 1) / sms) * (G + fixed);
    if (best_t == 0 || t < best_t) best = G, best_t = t;
  }
  return best;
}

// heads a k3_bwd_heads block: up to BG whose vectors (5 of cpad floats a
// head) and dx columns fit, a block's time taken as G + 0.55 heads'
// worth (measured on an H100 at one 4096-token row: 0.458, 0.254, 0.154
// ms at G = 4, 2, 1). One 4096-token row takes 4 (128 blocks, one wave);
// three rows of 2048 take 3 (264 blocks, two waves)
int bwd_heads(int c, int N, int P, int elt, int Bsz, int S, int H) {
  const auto smem = [&](int G) { return HeadsSmem(c, N, P, elt, G).total; };
  return heads_per_block(BG, 0.55, smem, (long)Bsz * (S / c), H);
}

// heads a k3_fwd_heads block: up to FG whose vectors (5 of cpad floats a
// head) fit, a block's time taken as G + 0.12 heads' worth (measured on
// an H100 at one 4096-token row: 0.153, 0.157, 0.167 ms at G = 4 in one
// wave, 2 in two, 1 in four). One 4096-token row takes 4 (128 blocks,
// one wave), three rows of 2048 take 3, five take 2, four of 4096 take 4
int fwd_heads(int c, int N, int P, int Bsz, int S, int H) {
  const auto smem = [&](int G) { return FwdSmem(c, N, P, G).total; };
  return heads_per_block(FG, 0.12, smem, (long)Bsz * (S / c), H);
}

// bytes of C B^T's fp32 scratch, a tile pair of each (sequence, chunk)
long long cb_work_bytes(int Bsz, int S, int c) {
  const long long nt = (c + BT - 1) / BT;
  return 4LL * Bsz * (S / c) * (nt * (nt + 1) / 2 * BT * BT);
}

// bytes of the backward's fp32 scratch: C B^T a tile pair, and per
// group of heads its sum of M a tile pair and its w x dst^T a row
long long bwd_work_bytes(int Bsz, int S, int H, int N, int P, int c,
                         int elt) {
  const long long G = bwd_heads(c, N, P, elt, Bsz, S, H);
  const long long ngroups = (H + G - 1) / G, nt = (c + BT - 1) / BT;
  const long long pairs = nt * (nt + 1) / 2 * BT * BT;
  return cb_work_bytes(Bsz, S, c) +
         4LL * Bsz * (S / c) * ngroups * (pairs + nt * BT * N);
}

// kernel (1: the heads kernel), grid x, y, z, threads, shared memory,
// heads a block and scratch bytes of the last forward's k3_fwd_heads and
// the last backward's k3_bwd_heads launch (k3_last_fwd_launch and
// k3_last_bwd_launch read them)
static long long g_fwd_launch[8] = {0, 0, 0, 0, 0, 0, 0, 0};
static long long g_bwd_launch[8] = {0, 0, 0, 0, 0, 0, 0, 0};

// C B^T's tile pairs of every (sequence, chunk) into cbw
template <typename In, int N>
cudaError_t launch_cb(const void* C, const void* B, float* cbw, long nbk,
                      int S, int c, long ld_cb, cudaStream_t stream) {
  constexpr int ldn = N + 16 / sizeof(In);
  static bool set[MAX_DEVICES];
  cudaError_t err = allow_smem(k3_cb<In, N>, SMEM_MAX, set);
  if (err != cudaSuccess) return err;
  const int nt = (c + BT - 1) / BT;
  k3_cb<In, N><<<dim3(nt * (nt + 1) / 2, nbk), NT,
                 2 * BT * ldn * sizeof(In), stream>>>(
      (const In*)C, (const In*)B, cbw, S, c, ld_cb);
  return cudaGetLastError();
}

template <typename In, int N, int P>
cudaError_t launch_fwd(const void* C, const void* B, const void* x,
                       const float* da, const float* dt, float* y,
                       float* states, float* cum, float* work, int Bsz,
                       int S, int H, int c, long ld_cb, long ld_x,
                       cudaStream_t stream) {
  static bool set_heads[MAX_DEVICES];
  cudaError_t err = allow_smem(k3_fwd_heads<In, N, P>, SMEM_MAX, set_heads);
  if (err != cudaSuccess) return err;
  const long nbk = (long)Bsz * (S / c);
  err = launch_cb<In, N>(C, B, work, nbk, S, c, ld_cb, stream);
  if (err != cudaSuccess) return err;
  const int G = fwd_heads(c, N, P, Bsz, S, H);
  const size_t smem = FwdSmem(c, N, P, G).total;
  const dim3 grid((H + G - 1) / G, nbk);
  const long long rec[8] = {1, grid.x, grid.y, grid.z, NT, (long long)smem, G,
                            cb_work_bytes(Bsz, S, c)};
  for (int i = 0; i < 8; ++i) g_fwd_launch[i] = rec[i];
  k3_fwd_heads<In, N, P><<<grid, NT, smem, stream>>>(
      (const In*)B, (const In*)x, da, dt, work, y, states, cum, S, H, c, G,
      ld_cb, ld_x);
  return cudaGetLastError();
}

template <typename In, int N, int P>
cudaError_t launch_bwd(const void* C, const void* B, const void* x,
                       const float* da, const float* dt, const float* dy,
                       const float* dst, const float* dcum, void* dC,
                       void* dB, void* dx, float* dda, float* ddt,
                       float* work, int Bsz, int S, int H, int c, long ld_cb,
                       long ld_x, cudaStream_t stream) {
  constexpr int elt = sizeof(In), ldn = N + 16 / elt;
  static bool set_heads[MAX_DEVICES], set_dcb[MAX_DEVICES];
  cudaError_t err = allow_smem(k3_bwd_heads<In, N, P>, SMEM_MAX, set_heads);
  if (err == cudaSuccess) err = allow_smem(k3_bwd_dcb<In, N>, SMEM_MAX, set_dcb);
  if (err != cudaSuccess) return err;
  const int G = bwd_heads(c, N, P, elt, Bsz, S, H);
  const int ngroups = (H + G - 1) / G;
  const int nt = (c + BT - 1) / BT, npairs = nt * (nt + 1) / 2;
  const long nbk = (long)Bsz * (S / c);
  float* cbw = work;
  float* msw = cbw + nbk * npairs * BT * BT;
  float* xdw = msw + nbk * ngroups * npairs * BT * BT;

  err = launch_cb<In, N>(C, B, cbw, nbk, S, c, ld_cb, stream);
  if (err != cudaSuccess) return err;

  const size_t smem = HeadsSmem(c, N, P, elt, G).total;
  const dim3 grid(ngroups, nbk);
  const long long rec[8] = {1, grid.x, grid.y, grid.z, NT, (long long)smem, G,
                            bwd_work_bytes(Bsz, S, H, N, P, c, elt)};
  for (int i = 0; i < 8; ++i) g_bwd_launch[i] = rec[i];
  k3_bwd_heads<In, N, P><<<grid, NT, smem, stream>>>(
      (const In*)B, (const In*)x, da, dt, dy, dst, dcum, (In*)dx, dda, ddt,
      cbw, msw, xdw, S, H, c, G, ld_cb, ld_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dcb = 4 * (RB * LDT + BT * (RB + 4)) + BT * ldn * elt;
  k3_bwd_dcb<In, N><<<dim3(nt * BT / RB, nbk), NT, smem_dcb, stream>>>(
      (const In*)C, (const In*)B, msw, xdw, (In*)dC, (In*)dB, S, c, ngroups,
      ld_cb);
  return cudaGetLastError();
}

// the (N, P) pairs the kernels are built for: those of the configs
// (mamba2-370m runs N=128 P=64, its reduced config N=16 P=32)
#define K3_DISPATCH(IN, FN, ...)                                          \
  switch (N * 1000 + P) {                                                 \
    case 16032: return FN<IN, 16, 32>(__VA_ARGS__);                       \
    case 128064: return FN<IN, 128, 64>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                                \
  }

cudaError_t fwd_any(int dtype, int N, int P, const void* C, const void* B,
                    const void* x, const float* da, const float* dt,
                    float* y, float* states, float* cum, float* work,
                    int Bsz, int S, int H, int c, long ld_cb, long ld_x,
                    cudaStream_t stream) {
  if (dtype == 0) {
    K3_DISPATCH(float, launch_fwd, C, B, x, da, dt, y, states, cum, work,
                Bsz, S, H, c, ld_cb, ld_x, stream)
  }
  K3_DISPATCH(__nv_bfloat16, launch_fwd, C, B, x, da, dt, y, states, cum,
              work, Bsz, S, H, c, ld_cb, ld_x, stream)
}

cudaError_t bwd_any(int dtype, int N, int P, const void* C, const void* B,
                    const void* x, const float* da, const float* dt,
                    const float* dy, const float* dst, const float* dcum,
                    void* dC, void* dB, void* dx, float* dda, float* ddt,
                    float* work, int Bsz, int S, int H, int c, long ld_cb,
                    long ld_x, cudaStream_t stream) {
  if (dtype == 0) {
    K3_DISPATCH(float, launch_bwd, C, B, x, da, dt, dy, dst, dcum, dC, dB,
                dx, dda, ddt, work, Bsz, S, H, c, ld_cb, ld_x, stream)
  }
  K3_DISPATCH(__nv_bfloat16, launch_bwd, C, B, x, da, dt, dy, dst, dcum,
              dC, dB, dx, dda, ddt, work, Bsz, S, H, c, ld_cb, ld_x, stream)
}

// what both directions take: a chunk length and grid they can launch,
// and operands the kernels can load 16 bytes at a time
cudaError_t check_launch(int Bsz, int S, int H, int c, int elt,
                         long long ld_cb, long long ld_x,
                         std::initializer_list<const void*> vec16) {
  if (!(c >= T && c % T == 0 && c <= 1024 && S > 0 && S % c == 0) ||
      Bsz <= 0 || H <= 0 || (long)Bsz * (S / c) > 65535)
    return cudaErrorInvalidValue;
  for (const void* p : vec16)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  if ((ld_cb * elt) % 16 || (ld_x * elt) % 16)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (C, B, x and dx); returns a cudaError_t.
// `work`: k3_forward_work(...) bytes of fp32 scratch. C, B, x and work
// start on 16-byte boundaries and the token strides of C, B and x are
// whole 16-byte units (the kernels load 16 bytes at a time).
int k3_forward(const void* C, const void* B, const void* x, const void* da,
               const void* dt, void* y, void* states, void* cum, void* work,
               int Bsz, int S, int H, int N, int P, int c, long long ld_cb,
               long long ld_x, int dtype, void* stream) {
  const cudaError_t err = check_launch(Bsz, S, H, c, dtype == 0 ? 4 : 2,
                                       ld_cb, ld_x, {C, B, x, work});
  if (err != cudaSuccess) return err;
  return fwd_any(dtype, N, P, C, B, x, (const float*)da, (const float*)dt,
                 (float*)y, (float*)states, (float*)cum, (float*)work, Bsz,
                 S, H, c, (long)ld_cb, (long)ld_x, (cudaStream_t)stream);
}

long long k3_forward_work(int Bsz, int S, int H, int N, int P, int c,
                          int dtype) {
  return cb_work_bytes(Bsz, S, c);
}

// dC and dB [Bsz, S, N] and dx in the inputs' type, dda and ddt fp32;
// `work`: k3_backward_work(...) bytes of fp32 scratch; alignment as
// k3_forward's, and dy and dst on 16-byte boundaries too.
int k3_backward(const void* C, const void* B, const void* x, const void* da,
                const void* dt, const void* dy, const void* dst,
                const void* dcum, void* dC, void* dB, void* dx, void* dda,
                void* ddt, void* work, int Bsz, int S, int H, int N, int P,
                int c, long long ld_cb, long long ld_x, int dtype,
                void* stream) {
  const cudaError_t err = check_launch(Bsz, S, H, c, dtype == 0 ? 4 : 2,
                                       ld_cb, ld_x, {C, B, x, dy, dst, work});
  if (err != cudaSuccess) return err;
  return bwd_any(dtype, N, P, C, B, x, (const float*)da, (const float*)dt,
                 (const float*)dy, (const float*)dst, (const float*)dcum, dC,
                 dB, dx, (float*)dda, (float*)ddt, (float*)work, Bsz, S, H, c,
                 (long)ld_cb, (long)ld_x, (cudaStream_t)stream);
}

long long k3_backward_work(int Bsz, int S, int H, int N, int P, int c,
                           int dtype) {
  return bwd_work_bytes(Bsz, S, H, N, P, c, dtype == 0 ? 4 : 2);
}

void k3_last_fwd_launch(long long* out) {
  for (int i = 0; i < 8; ++i) out[i] = g_fwd_launch[i];
}

void k3_last_bwd_launch(long long* out) {
  for (int i = 0; i < 8; ++i) out[i] = g_bwd_launch[i];
}

const char* k3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
