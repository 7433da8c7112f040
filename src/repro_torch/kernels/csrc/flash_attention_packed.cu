// Packed variable-length flash attention (kernel K1) for Hopper (sm_90a),
// forward and backward, plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_packed_flat
// (Pallas body `_packed_kernel`) together with its model-layout wrapper
// src/repro/kernels/ops.py :: flash_attention_packed. Same function: all
// sequences of a group live in one packed buffer; attention is
// block-diagonal over `segment_ids` (q padding -1, kv padding -2), causal
// or sliding order is taken in packed coordinates with keys shifted by
// `kv_offset`, and when mode != full an optional span table ORs in
// same-block bidirectional pairs. Softmax in fp32.
//
// What the port adds to the TPU kernel:
//   * the log-sum-exp (LSE) of every row, fp32 [B, H, S] (-inf for a row
//     with no valid key), which the backward needs and the ring-CP merge
//     of a later slice will need;
//   * a backward kernel (dq, dk, dv), the flash-attention-2 backward of
//     src/repro/models/attention.py :: _attn_chunked_bwd (the JAX package
//     has no Pallas backward: its training path differentiates jnp);
//   * native GQA: query head h reads KV head h / (H / Hkv) in place;
//   * a masked pair weighs exactly 0 and a row with no valid key is zeros
//     (the Pallas kernel's -1e30 trick is not copied).
//
// Dead tiles (no valid (q, k) pair) are skipped as `pl.when(live)` skips
// them: a first pass summarises each 32-row slice of every table (min and
// max segment id >= 0, min and max span id >= 0), and a tile pair is
// visited only if its segment ranges overlap and either the positional
// mask or the span ranges can admit a pair. The test is conservative:
// a visited tile with no valid pair adds exactly nothing.
//
// What bounds it on the H100: at the training path's packed buckets
// (1k-4k tokens, D = 128) the valid pairs make the work compute-bound
// (4*D flops per valid pair per query head forward, 10*D backward,
// against q/k/v/o read once), so both directions keep scores and
// probabilities on chip:
//   * bf16 forward, every head dim (packed_fwd_wg_kernel, replacing the
//     Pallas `_packed_kernel` of flash_attention_packed_flat):
//     operations bound it, so every product is a warpgroup MMA (wgmma):
//     S = Q K^T from shared memory, O += P V with P from registers
//     (rounded to bf16) and V read N-major from its row-major tile, fp32
//     accumulation, no transposed copy of any tile. A block is two
//     warpgroups over 128 query rows of one head, sharing each 64-key
//     K/V tile, which arrive by cp.async in a two-stage ring (the next
//     live tile lands while this one is computed). Live key tiles are
//     found 32 at a time by one ballot over the tables' summaries; a
//     tile wholly in the rows' one segment and at or before their first
//     row (sliding: within the last row's window) skips the pair mask;
//     the last query tiles, the heaviest under causal order, are issued
//     first. D = 64 / 128: 98 KB at D = 128, two blocks an SM. D = 256
//     (recurrentgemma-2b, bf16 only): the O share alone is 128 fp32 a
//     thread, so one block an SM (194 KB, up to 255 registers), and
//     O += P V runs as two m64n128 products, V's 64-wide blocks 0-1 and
//     2-3. D = 160 (pixtral-12b: 5120 / 32 heads): tiles of DP = 192
//     columns, three 64-wide blocks, whose upper 32 columns are
//     zero-filled on the load (HBM traffic stays at 160 columns): S =
//     Q K^T over all 192 (the zeros add nothing; 1.2x the products), O
//     += P V as m64n128 over blocks 0-1 and m64n64 over block 2, the
//     upper 32 columns of O formed and never written; one block an SM
//     (146 KB, O's share 96 registers a thread); the scale stays
//     1/sqrt(160).
//   * bf16 backward, every head dim: wgmma, one block per (query head,
//     64-key tile, batch), a group sum of the heads' dK / dV after it and
//     16-byte vector atomics for dQ (P and dS rounded to bf16 before
//     their products; see packed_bwd_kv_kernel). At head_dim 256 each
//     thread's share of dK or dV is 128 registers, so one block an SM;
//     at 160 the tiles are 192 columns wide as in the forward (the
//     upper 32 zeros), dK / dV 96 registers, one block an SM.
//   * fp32 forward at D = 64 (packed_fwd_f32_kernel: whisper-small's
//     encoder and cross-attention in training). What bounds it: at 8 x
//     1500 frames, 12:12 heads, full, 6.91 GFLOP a row (4*D flops a
//     valid pair a head), 0.335 ms for the 8 rows as split TF32 (three
//     TF32 products each, 495 TFLOP/s; the bytes 0.044 ms). The design:
//     split TF32 by wgmma, Q split once into registers, V^T's keys
//     permuted so that P never leaves the registers, two warpgroups over
//     128 query rows sharing every split 64-key tile (half the split
//     work a row of K2's fp32 kernel), a two-stage ring of split tiles.
//     What still holds it back (H100 80GB HBM3 at 700 W: 0.91-0.93 ms at
//     8 x 1500, 2.7x that bound, against the CUDA-core kernel's 5.7 and
//     SDPA fp32's 1.72): the split pass (~20%) and each warpgroup's
//     waits on its own products and softmax, one block an SM; its
//     section says more.
//   * fp32 forward at D = 128 and 160 (packed_fwd_f32_cc_kernel; no
//     config runs 256 in fp32): the CUDA cores, fp32 tiles in shared
//     memory; no main path runs it, not redesigned.
//   * fp32 backward at D = 64 (whisper-small's encoder and
//     cross-attention in training): split TF32 on the tensor cores by
//     wgmma, as two kernels that each write their gradients once
//     (packed_bwd_f32_kernel: dK, dV; packed_bwd_f32_dq_kernel: dQ); its
//     section says what bounds it and what the design does about it.
//   * fp32 backward at D = 128 and 160 (packed_bwd_f32_cc_kernel): the
//     CUDA cores, dQ by scalar atomics; no main path runs it, not
//     redesigned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SUM_T = 32;  // rows per table summary entry

enum Mode { kFull = 0, kCausal = 1, kSliding = 2 };

struct Params {
  int B, Sq, Sk, H, Hkv, mode, window, kv_offset;
  const int* segq;   // [B, Sq]
  const int* segk;   // [B, Sk]
  const int* spanq;  // [B, Sq] or null
  const int* spank;  // [B, Sk] or null
  const int4* sumq;  // [B, nsq] summaries of segq/spanq
  const int4* sumk;  // [B, nsk]
  int nsq, nsk;
};

// ---------------------------------------------------------------------
// Table summaries: one warp per 32-row slice.
// ---------------------------------------------------------------------
__global__ void tile_summary_kernel(const int* __restrict__ seg,
                                    const int* __restrict__ span, int S,
                                    int n_tiles, int4* __restrict__ out) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int i = tile * SUM_T + threadIdx.x;
  int s = -1, p = -1;
  if (i < S) {
    s = seg[(int64_t)b * S + i];
    if (span != nullptr) p = span[(int64_t)b * S + i];
  }
  int smin = s >= 0 ? s : INT_MAX, smax = s >= 0 ? s : -1;
  int pmin = p >= 0 ? p : INT_MAX, pmax = p >= 0 ? p : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    smin = min(smin, __shfl_xor_sync(FULL, smin, o));
    smax = max(smax, __shfl_xor_sync(FULL, smax, o));
    pmin = min(pmin, __shfl_xor_sync(FULL, pmin, o));
    pmax = max(pmax, __shfl_xor_sync(FULL, pmax, o));
  }
  if (threadIdx.x == 0)
    out[(int64_t)b * n_tiles + tile] = make_int4(smin, smax, pmin, pmax);
}

__device__ __forceinline__ int4 range_summary(const int4* sum, int64_t base,
                                              int r0, int r1) {
  int4 acc = make_int4(INT_MAX, -1, INT_MAX, -1);
  for (int t = r0 / SUM_T; t * SUM_T < r1; ++t) {
    const int4 s = sum[base + t];
    acc.x = min(acc.x, s.x);
    acc.y = max(acc.y, s.y);
    acc.z = min(acc.z, s.z);
    acc.w = max(acc.w, s.w);
  }
  return acc;
}

// Can query rows [q0, q1) and key rows [k0, k1) of batch b hold a valid
// pair? Conservative; uniform across a block.
template <bool SPANS>
__device__ __forceinline__ bool tile_live(const Params& p, int b, int q0,
                                          int q1, int k0, int k1) {
  const int4 sq = range_summary(p.sumq, (int64_t)b * p.nsq, q0, q1);
  const int4 sk = range_summary(p.sumk, (int64_t)b * p.nsk, k0, k1);
  if (sq.x > sk.y || sk.x > sq.y) return false;  // no shared segment
  if (p.mode == kFull) return true;
  const int kp_lo = p.kv_offset + k0, kp_hi = p.kv_offset + k1 - 1;
  bool pos = kp_lo <= q1 - 1;
  if (p.mode == kSliding) pos = pos && kp_hi > q0 - p.window;
  if (pos) return true;
  return SPANS && sq.z <= sk.w && sk.z <= sq.w;
}

// The mask of one (query, key) pair, as _packed_kernel builds it: the
// positional test OR'd with the span test (mode != full only), the
// segment test AND'd last.
template <bool SPANS>
__device__ __forceinline__ bool pair_ok(int mode, int window, int qpos,
                                        int kpos, int sq, int sk, int pq,
                                        int pk) {
  if (sq < 0 || sq != sk) return false;
  if (mode == kFull) return true;
  bool ok = kpos <= qpos;
  if (mode == kSliding) ok = ok && kpos > qpos - window;
  if (SPANS) ok = ok || (pq >= 0 && pq == pk);
  return ok;
}

// ---------------------------------------------------------------------
// Forward, fp32, CUDA cores, D = 128 and 160 (no main path runs them;
// not redesigned): block = (64 query rows, head, batch), two threads
// per row each holding half of the row's scores and output.
// ---------------------------------------------------------------------
constexpr int S_BQ = 64, S_BK = 32, S_THREADS = 128;

template <int D>
constexpr size_t fwd_f32_smem() {
  return sizeof(float) * (S_BQ * (D + 1) + S_BK * (D + 1) + S_BK * D +
                          S_BQ * (S_BK + 1)) +
         sizeof(int) * 2 * S_BK;
}

template <int D, bool SPANS>
__global__ void __launch_bounds__(S_THREADS)
packed_fwd_f32_cc_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Params p, float scale) {
  constexpr int QS = D + 1, PS = S_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [S_BQ][QS]
  float* Ks = Qs + S_BQ * QS;  // [S_BK][QS]
  float* Vs = Ks + S_BK * QS;  // [S_BK][D]
  float* Ps = Vs + S_BK * D;   // [S_BQ][PS]
  int* segk_s = reinterpret_cast<int*>(Ps + S_BQ * PS);
  int* spank_s = segk_s + S_BK;

  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * S_BQ, h = blockIdx.y, b = blockIdx.z;
  const int H = p.H, Hkv = p.Hkv, Sq = p.Sq, Sk = p.Sk;
  const int hk = h / (H / Hkv);
  const int q1 = min(q0 + S_BQ, Sq);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  float* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * D;

  for (int i = tid; i < S_BQ * D; i += S_THREADS) {
    const int rr = i / D, d = i % D, qp = q0 + rr;
    Qs[rr * QS + d] = qp < Sq ? qb[(int64_t)qp * q_stride + d] : 0.f;
  }

  const int qpos = q0 + r;
  const bool qin = qpos < Sq;
  const int segq_r = qin ? p.segq[(int64_t)b * Sq + qpos] : -1;
  const int spanq_r = (SPANS && qin) ? p.spanq[(int64_t)b * Sq + qpos] : -1;

  int j_lo = 0, j_hi = Sk;
  if (!SPANS && p.mode != kFull) {
    j_hi = max(0, min(Sk, q1 - p.kv_offset));
    if (p.mode == kSliding) j_lo = max(0, q0 - p.window - p.kv_offset + 1);
  }
  j_lo = (j_lo / S_BK) * S_BK;

  float m = -INFINITY, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j0 = j_lo; j0 < j_hi; j0 += S_BK) {
    if (!tile_live<SPANS>(p, b, q0, q1, j0, min(j0 + S_BK, Sk))) continue;
    __syncthreads();
    for (int i = tid; i < S_BK * D; i += S_THREADS) {
      const int c = i / D, d = i % D, kp = j0 + c;
      const bool in = kp < Sk;
      Ks[c * QS + d] = in ? kb[(int64_t)kp * kv_stride + d] : 0.f;
      Vs[c * D + d] = in ? vb[(int64_t)kp * kv_stride + d] : 0.f;
    }
    if (tid < S_BK) {
      const int kp = j0 + tid;
      segk_s[tid] = kp < Sk ? p.segk[(int64_t)b * Sk + kp] : -2;
      spank_s[tid] = (SPANS && kp < Sk) ? p.spank[(int64_t)b * Sk + kp] : -2;
    }
    __syncthreads();

    float s[S_BK / 2];
    float row_max = -INFINITY;
    const float* qr = Qs + r * QS;
#pragma unroll
    for (int jj = 0; jj < S_BK / 2; ++jj) {
      const int c = half + 2 * jj;
      const bool ok = pair_ok<SPANS>(p.mode, p.window, qpos,
                                     p.kv_offset + j0 + c, segq_r,
                                     segk_s[c], spanq_r, spank_s[c]);
      float dot = 0.f;
      if (ok) {
        const float* kr = Ks + c * QS;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        dot *= scale;
        row_max = fmaxf(row_max, dot);
      }
      s[jj] = ok ? dot : -INFINITY;
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(FULL, row_max, 1));
    const float m_new = fmaxf(m, row_max);
    float corr = 1.f, psum = 0.f;
    float* pr = Ps + r * PS;
    if (m_new == -INFINITY) {
#pragma unroll
      for (int jj = 0; jj < S_BK / 2; ++jj) pr[half + 2 * jj] = 0.f;
    } else {
      corr = expf(m - m_new);  // m = -inf gives 0
#pragma unroll
      for (int jj = 0; jj < S_BK / 2; ++jj) {
        const float pv = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_new);
        psum += pv;
        pr[half + 2 * jj] = pv;
      }
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int c = 0; c < S_BK; ++c) {
      const float pv = pr[c];
      const float* vr = Vs + c * D + half;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(pv, vr[2 * i], acc[i]);
    }
  }

  if (qin) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = ob + (int64_t)qpos * q_stride + half;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[2 * i] = acc[i] * inv;
    if (half == 0)
      lse[((int64_t)b * H + h) * Sq + qpos] =
          l > 0.f ? m + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------
// Backward preprocess: delta[b, h, i] = sum_d dO * O (fp32), one warp
// per (b, i, h) row.
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void bwd_delta_kernel(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int B, int Sq,
                                 int H) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);  // (b*Sq + i)*H + h
  const int lane = threadIdx.x & 31;
  if (row >= B * Sq * H) return;
  const T* orow = o + (int64_t)row * D;
  const T* drow = dout + (int64_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) {
    float a, c;
    if constexpr (std::is_same<T, bf16>::value) {
      a = __bfloat162float(orow[d]);
      c = __bfloat162float(drow[d]);
    } else {
      a = orow[d];
      c = drow[d];
    }
    acc = fmaf(a, c, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
    delta[((int64_t)b * H + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------
// Backward, bf16, tensor cores, D = 64, 128 and 256, designed for the
// H100. The gradient of K1's function (src/repro/kernels/flash_attention.py
// :: flash_attention_packed_flat; the Pallas kernel has no backward, and
// the JAX package differentiates src/repro/models/attention.py ::
// _attn_chunked_bwd's math): dq, dk, dv from q, k, v, dO, the forward's
// LSE and delta = rowsum(dO * O).
//
// What bounds it: 10*D flops per valid (query, key) pair per query head
// (S, dP, dV, dK, dQ), against q, k, v, o, dO, dq, dk, dv crossing HBM
// once: at the training path's 4096-token rows the work is compute-bound
// (the bound is in operations). What the design does about it:
//
//  1. Grid. A block is (query head, 64-key tile, batch), heads fastest,
//     so blocks are issued key tile by key tile and the heaviest tiles
//     of a causal row (tile 0 walks every query tile) start first. One
//     4096-token row gives 768 blocks at internvl3-2b's 12 heads and 640
//     at recurrentgemma-2b's 10 (one KV head: a grid over KV heads would
//     have 64 for 132 SMs). Each block keeps its query head's dK and dV
//     for its 64 keys in registers and writes them once: in bf16 when
//     H == Hkv, else in fp32 to scratch [B, Sk, H, D], which
//     bwd_kv_reduce_kernel sums over the G = H / Hkv heads of each KV
//     head in a fixed order. No atomics touch dK or dV, so both come out
//     the same bits on every call.
//  2. Loads and products. K and V (once) and each live query tile's Q,
//     dO, LSE, delta and table slices arrive by cp.async, the bf16 tiles
//     in the 128-byte-swizzled layout wgmma reads, so every product is a
//     warpgroup MMA (wgmma, sm_90a) with its operands in shared memory,
//     whatever their major, and no transposed copy exists. Warpgroup 0
//     forms S^T = K Q^T, P^T and dV += P^T dO (P^T from registers);
//     warpgroup 1 forms dP^T = V dO^T, takes P^T from warpgroup 0
//     through shared memory (fp32, fragment order), and forms dS^T and
//     dK += dS^T Q. Each thread holds one 64 x D / 128 share of dK or
//     dV; no product is formed twice. At D = 64 / 128 one stage of
//     query tiles (94 KB of shared memory at D = 128, at most 128
//     registers) lets two blocks share an SM, each computing while the
//     other's next tile lands: a two-stage ring would need 126 KB and so
//     one block an SM, and measured slower. At D = 256 the dK / dV share
//     alone is 128 registers a thread, so one block an SM whatever (255
//     registers, no spill); a second stage there (219 KB) measured no
//     faster. The next tile is requested as soon as this one's Q and dO
//     are read, before dQ. Which query tiles are live each warp learns
//     32 at a time (one ballot), so no table summary is read on the way
//     from one tile to the next.
//  3. Masks. A warp whose 16 keys share one segment skips the pair mask
//     for a query tile that lies wholly in that segment and after (and,
//     sliding, within a window of) those keys: below the diagonal of a
//     long sequence, nearly every tile. Other tiles test every pair.
//  4. dQ. dS^T goes to shared memory in bf16, dQ = dS K is formed by
//     wgmma in 64-column chunks, warpgroup w taking chunks w, w + 2, ...
//     (at D = 64 warpgroup 0 the only one; at D = 256 two each, one
//     after the other, to stay within 255 registers), and each pair of
//     lanes swaps halves so that every lane adds four consecutive floats
//     of one row with one 16-byte vector atomic (sm_90): a quarter of
//     the atomic instructions of per-element adds, whole 16-byte lines.
//     dQ's fp32 buffer stays (the order of its sums varies from call to
//     call).
// P and dS are rounded to bf16 before their products, as the forward
// rounds P; a row with no valid key (LSE -inf) has P = 0 exactly.
// ---------------------------------------------------------------------
constexpr int K_BK = 64, K_BQ = 64, K_THREADS = 256;  // two warpgroups

// dst[0:4] += v as one 16-byte vector reduction (sm_90, global memory)
__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

// Per-head-dim traits of packed_bwd_kv_kernel. Tiles are DP columns
// wide, D rounded up to whole 64-column blocks (D = 160: 192, the upper
// 32 zeros). D = 64 / 128: two blocks an SM (94 KB of shared memory at
// D = 128, at most 128 registers a thread). D = 160 / 256: the 64 x DP
// share of dK or dV alone is 96 / 128 fp32 registers a thread, so one
// block an SM (123 / 158 KB, up to 255 registers).
template <int D>
struct BwdKvTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int TB = K_BK * DP * 2;  // bytes of one [64][DP] tile
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
  // K, V, Q, dO, dS^T, P^T (fp32), the query tables, the key tables, and
  // room to align the tiles to 1024 bytes
  static constexpr size_t smem =
      1024 + 4 * TB + K_BK * K_BQ * 2 +
      sizeof(float) * (K_BK * K_BQ + 2 * K_BQ) +
      sizeof(int) * (2 * K_BQ + 2 * K_BK);
};

template <int D, bool SPANS>
__global__ void __launch_bounds__(K_THREADS, BwdKvTile<D>::MIN_BLOCKS)
packed_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc,
                     float* __restrict__ dk_part,
                     float* __restrict__ dv_part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params p, float scale) {
  constexpr int DP = BwdKvTile<D>::DP, TB = BwdKvTile<D>::TB;
  constexpr int CH = D / 8, CHP = DP / 8, NQ = K_BQ / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Ks = sm;             // [64][DP], swizzled
  unsigned char* Vs = Ks + TB;        // [64][DP]
  unsigned char* Qs = Vs + TB;        // [64][DP]
  unsigned char* dOs = Qs + TB;       // [64][DP]
  unsigned char* dSt = dOs + TB;      // [64 keys][64 queries]
  float* Px = reinterpret_cast<float*>(dSt + K_BK * K_BQ * 2);
  float* lse_s = Px + K_BK * K_BQ;                // [K_BQ]
  float* delta_s = lse_s + K_BQ;                  // [K_BQ]
  int* segq_s = reinterpret_cast<int*>(delta_s + K_BQ);
  int* spanq_s = segq_s + K_BQ;                   // [K_BQ]
  int* segk_s = spanq_s + K_BQ;                   // [K_BK]
  int* spank_s = segk_s + K_BK;
  const uint32_t ks_a = smem_u32(Ks), vs_a = smem_u32(Vs),
                 qs_a = smem_u32(Qs), dos_a = smem_u32(dOs),
                 dst_a = smem_u32(dSt);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool dk_warp = warp >= 4;  // warpgroup 1: dP, dS, dK; 0: S, P, dV
  const int kw = warp & 3;         // the warp's 16 keys of the tile
  const int h = blockIdx.x, b = blockIdx.z;
  const int H = p.H, Hkv = p.Hkv, Sq = p.Sq, Sk = p.Sk, G = H / Hkv;
  const int hk = h / G;
  const int k0 = blockIdx.y * K_BK, k1 = min(k0 + K_BK, Sk);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const bf16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const bf16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const bf16* db = dout + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* lseb = lse + ((int64_t)b * H + h) * Sq;
  const float* delb = delta + ((int64_t)b * H + h) * Sq;
  const int* segqb = p.segq + (int64_t)b * Sq;
  const int* spanqb = SPANS ? p.spanq + (int64_t)b * Sq : p.segq;
  float* dqb = dq_acc + (int64_t)b * Sq * q_stride + (int64_t)h * D;

  // keys past Sk and columns past D (the upper 32 of DP = 192) read as
  // zeros
  for (int i = tid; i < K_BK * CHP; i += K_THREADS) {
    const int r = i / CHP, c = i % CHP, kp = k0 + r;
    const bool in = kp < Sk && c < CH;
    const int64_t off =
        (int64_t)(kp < Sk ? kp : k0) * kv_stride + (c < CH ? c : 0) * 8;
    cp_async16(Ks + sw128<K_BK>(r, c), kb + off, in);
    cp_async16(Vs + sw128<K_BK>(r, c), vb + off, in);
  }
  cp_async_commit();
  if (tid < K_BK) {
    const int kp = k0 + tid;
    segk_s[tid] = kp < Sk ? p.segk[(int64_t)b * Sk + kp] : -2;
    spank_s[tid] = (SPANS && kp < Sk) ? p.spank[(int64_t)b * Sk + kp] : -2;
  }

  // the query tile at q0: rows past Sq read as zeros and are masked by
  // position below
  auto load_q = [&](int q0) {
    for (int i = tid; i < K_BQ * CHP; i += K_THREADS) {
      const int r = i / CHP, c = i % CHP, qp = q0 + r;
      const bool in = qp < Sq && c < CH;
      const int64_t off =
          (int64_t)(qp < Sq ? qp : q0) * q_stride + (c < CH ? c : 0) * 8;
      cp_async16(Qs + sw128<K_BQ>(r, c), qb + off, in);
      cp_async16(dOs + sw128<K_BQ>(r, c), db + off, in);
    }
    for (int i = tid; i < 4 * K_BQ; i += K_THREADS) {
      const int which = i / K_BQ, r = i % K_BQ, qp = q0 + r;
      const int qc = qp < Sq ? qp : q0;
      if (which == 0) cp_async4(lse_s + r, lseb + qc, qp < Sq);
      if (which == 1) cp_async4(delta_s + r, delb + qc, qp < Sq);
      if (which == 2) cp_async4(segq_s + r, segqb + qc, qp < Sq);
      if (which == 3 && SPANS) cp_async4(spanq_s + r, spanqb + qc, qp < Sq);
    }
    cp_async_commit();
  };
  // the first live query tile at or after q0 (Sq if none), uniform: each
  // warp tests 32 tiles at once (lane j tile base + j) and keeps the
  // ballot, so the tables' summaries are read once per 32 tiles
  const int n_qt = (Sq + K_BQ - 1) / K_BQ;
  int live_base = -32;
  uint32_t live_bits = 0;
  auto next_live = [&](int q0) {
    for (int j = q0 / K_BQ; j < n_qt;) {
      if (j >= live_base + 32) {
        live_base = j;
        const int qt = (j + lane) * K_BQ;
        live_bits = __ballot_sync(
            FULL, qt < Sq && tile_live<SPANS>(p, b, qt, min(qt + K_BQ, Sq),
                                              k0, k1));
      }
      const uint32_t ahead = live_bits >> (j - live_base);
      if (ahead) return (j + __ffs(ahead) - 1) * K_BQ;
      j = live_base + 32;
    }
    return Sq;
  };

  int i_lo = 0;
  if (!SPANS && p.mode != kFull) i_lo = max(0, p.kv_offset + k0);
  i_lo = (i_lo / K_BQ) * K_BQ;
  int q0 = next_live(i_lo);
  if (q0 < Sq) load_q(q0);

  cp_async_wait<0>();  // K, V (and the first query tile) have landed
  __syncthreads();
  const int kl[2] = {kw * 16 + g, kw * 16 + g + 8};  // local key rows
  int kpos[2], segk_r[2], spank_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = p.kv_offset + k0 + kl[i];
    segk_r[i] = segk_s[kl[i]];
    spank_r[i] = spank_s[kl[i]];
  }
  // the warp's 16 keys lie in one segment (seg_w >= 0): a query tile all
  // in that segment and after (and, sliding, within a window of) the
  // keys then needs no mask
  const int seg_w = segk_s[kw * 16];
  const bool one_seg =
      __all_sync(FULL, segk_s[kw * 16 + (lane & 15)] == seg_w) && seg_w >= 0;
  const int kpos_w = p.kv_offset + k0 + kw * 16;  // the warp's first key
  float* px = Px + kw * (NQ * 4 * 32);

  float acc[DP / 8][4];  // dV (warpgroup 0) or dK (warpgroup 1), 64 keys
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  while (q0 < Sq) {
    cp_async_wait<0>();   // this query tile has landed
    fence_proxy_async();  // the copies are seen by wgmma's reads
    __syncthreads();

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 keys x
    // 64 queries, both operands K-major
    float sc[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    {
      const uint32_t a0 = dk_warp ? vs_a : ks_a, b0 = dk_warp ? dos_a : qs_a;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * SW_BLOCK + (kk & 3) * 32;
        wgmma_ss_n64<0, 0>(&sc[0][0], wg_desc(a0 + off, 16, SW_GROUP),
                           wg_desc(b0 + off, 16, SW_GROUP), 1);
      }
      wgmma_commit();
      wgmma_wait0();
    }
    if (!dk_warp) {
      bool all_ok = one_seg && q0 + K_BQ <= Sq &&
                    (p.mode == kFull ||
                     (kpos_w + 15 <= q0 &&
                      (p.mode != kSliding ||
                       kpos_w > q0 + K_BQ - 1 - p.window)));
      all_ok = __all_sync(FULL, all_ok && segq_s[lane] == seg_w &&
                                    segq_s[lane + 32] == seg_w);
      if (all_ok) {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + t * 2 + (e & 1);
            sc[n][e] = __expf(sc[n][e] * scale - lse_s[c]);
            px[(n * 4 + e) * 32 + lane] = sc[n][e];
          }
      } else {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = n * 8 + t * 2 + (e & 1);
            const bool ok =
                q0 + c < Sq &&
                pair_ok<SPANS>(p.mode, p.window, q0 + c, kpos[i], segq_s[c],
                               segk_r[i], spanq_s[c], spank_r[i]);
            const float pv = ok ? __expf(sc[n][e] * scale - lse_s[c]) : 0.f;
            sc[n][e] = pv;
            px[(n * 4 + e) * 32 + lane] = pv;
          }
      }
    }
    __syncthreads();
    if (dk_warp) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + t * 2 + (e & 1);
          sc[n][e] = px[(n * 4 + e) * 32 + lane] *
                     (sc[n][e] - delta_s[c]) * scale;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(dSt + sw128<K_BK>(kl[i], n) + t * 4) =
              pack_bf16(sc[n][2 * i], sc[n][2 * i + 1]);
      }
      fence_proxy_async();  // dS^T is seen by the dQ wgmma
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): A from
    // registers, B (dO or Q) N-major: 16 queries a step, 64-wide d blocks,
    // at D = 256 as two products of 128 columns, at D = 160 as one of 128
    // and one of 64 (the third block)
    {
      uint32_t a[K_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < K_BQ / 16; ++kk) {
        a[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        a[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        a[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      const uint32_t c0 = dk_warp ? qs_a : dos_a;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K_BQ / 16; ++kk) {
        const uint64_t dsc = wg_desc(c0 + kk * 2048, SW_BLOCK, SW_GROUP);
        if constexpr (D == 64) {
          wgmma_rs_n64<1>(&acc[0][0], a[kk], dsc);
        } else {
          wgmma_rs_n128<1>(&acc[0][0], a[kk], dsc);
        }
        if constexpr (D == 256) {
          const uint32_t hi = c0 + 2 * SW_BLOCK + kk * 2048;
          wgmma_rs_n128<1>(&acc[16][0], a[kk],
                           wg_desc(hi, SW_BLOCK, SW_GROUP));
        }
        if constexpr (DP == 192) {
          const uint32_t hi3 = c0 + 2 * SW_BLOCK + kk * 2048;
          wgmma_rs_n64<1>(&acc[16][0], a[kk],
                          wg_desc(hi3, SW_BLOCK, SW_GROUP));
        }
      }
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // dS^T is whole; this tile's Q, dO are read
    const int q_next = next_live(q0 + K_BQ);
    if (q_next < Sq) load_q(q_next);  // lands while dQ is formed

    // dQ [64 queries x D] = dS K in 64-column chunks: warpgroup w takes
    // chunks w, w + 2, ... (at D = 64 warpgroup 0 the only one), each
    // added before the next is formed; A = dS^T's tile read M-major, B =
    // K N-major. At D = 160 the third chunk's upper 32 columns are formed
    // and not added.
#pragma unroll
    for (int j2 = 0; j2 < (DP / 64 + 1) / 2; ++j2) {
      const int chunk = 2 * j2 + (dk_warp ? 1 : 0);
      if (chunk >= DP / 64) break;
      float dqa[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
      const uint32_t b0 = ks_a + chunk * SW_BLOCK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K_BK / 16; ++kk)
        wgmma_ss_n64<1, 1>(&dqa[0][0],
                           wg_desc(dst_a + kk * 2048, SW_BLOCK, SW_GROUP),
                           wg_desc(b0 + kk * 2048, SW_BLOCK, SW_GROUP), 1);
      wgmma_commit();
      wgmma_wait0();
      const bool odd = t & 1;
      const int col0 = chunk * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0 + j * 8 >= D) break;  // warp-uniform
        const float* c = dqa[j];
        const float r0 = __shfl_xor_sync(FULL, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(FULL, odd ? c[1] : c[3], 1);
        const int row = q0 + kw * 16 + g + (odd ? 8 : 0);
        const int col = col0 + j * 8 + (t & 2) * 2;
        const float4 val = odd ? make_float4(r0, r1, c[2], c[3])
                               : make_float4(c[0], c[1], r0, r1);
        if (row < Sq) red_add_v4(dqb + (int64_t)row * q_stride + col, val);
      }
    }
    q0 = q_next;
  }

  // this head's dK / dV: bf16 into dk / dv when G == 1, else fp32
  // partials [B, Sk, H, D] for bwd_kv_reduce_kernel
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kl[i];
    if (key >= Sk) continue;
    if (G == 1) {
      bf16* out = (dk_warp ? dk : dv) +
                  ((int64_t)b * Sk + key) * kv_stride + (int64_t)hk * D;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<uint32_t*>(out + nd * 8 + t * 2) =
            pack_bf16(acc[nd][2 * i], acc[nd][2 * i + 1]);
    } else {
      float* out = (dk_warp ? dk_part : dv_part) +
                   ((int64_t)b * Sk + key) * q_stride + (int64_t)h * D;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(out + nd * 8 + t * 2) =
            make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    }
  }
}

// dk, dv [B, Sk, Hkv, D] bf16 = the sums over the G query heads of each
// KV head of the fp32 partials [B, Sk, H, D], in head order; a thread
// per 4 consecutive d of one (b, key, KV head) row
template <int D>
__global__ void bwd_kv_reduce_kernel(const float* __restrict__ dk_part,
                                     const float* __restrict__ dv_part,
                                     bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, int64_t n4,
                                     int G) {
  constexpr int C4 = D / 4;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int64_t row = i / C4;  // (b * Sk + key) * Hkv + hk
  const int c = (int)(i % C4);
  // query head hk * G + hh of that row is partial row row * G + hh
  const float4* pk =
      reinterpret_cast<const float4*>(dk_part) + row * G * C4 + c;
  const float4* pv =
      reinterpret_cast<const float4*>(dv_part) + row * G * C4 + c;
  float4 sk = pk[0], sv = pv[0];
  for (int hh = 1; hh < G; ++hh) {
    const float4 a = pk[hh * C4], e = pv[hh * C4];
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
  }
  reinterpret_cast<uint2*>(dk)[i] =
      make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
  reinterpret_cast<uint2*>(dv)[i] =
      make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
}

// ---------------------------------------------------------------------
// Forward, bf16, tensor cores, D = 64, 128 and 256, designed for the H100
// (the source note says what bounds it and what the design does about it).
// A block is two warpgroups over W_BQ query rows of one query head, 64
// rows each; both share each K/V tile of a ring of W_STAGES.
// ---------------------------------------------------------------------
constexpr int W_BQ = 128, W_BK = 64, W_THREADS = 256;
constexpr int W_STAGES = 2;  // K/V tiles: one in use, one landing

// Per-head-dim traits of packed_fwd_wg_kernel. Tiles are DP columns
// wide, D rounded up to whole 64-column blocks (D = 160: 192, the upper
// 32 zeros). D = 64 / 128: two blocks an SM (98 KB of shared memory at
// D = 128, at most 128 registers a thread). D = 160 / 256: the 64 x DP
// share of O alone is 96 / 128 fp32 registers a thread, so one block an
// SM (146 / 194 KB, up to 255 registers).
template <int D>
struct FwdWgTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int TB = 64 * DP * 2;  // bytes of one [64][DP] tile
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  // Q of both warpgroups, the ring's K, V and key tables, and room to
  // align the tiles to 1024 bytes
  static constexpr size_t smem =
      1024 + 2 * TB + W_STAGES * (2 * TB + sizeof(int) * 2 * W_BK);
};

template <int D, bool SPANS>
__global__ void __launch_bounds__(W_THREADS, FwdWgTile<D>::MIN_BLOCKS)
packed_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Params p, float scale) {
  constexpr int DP = FwdWgTile<D>::DP, TB = FwdWgTile<D>::TB;
  constexpr int CH = D / 8, CHP = DP / 8, NK = W_BK / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Qs = sm;             // [2][64][DP], one tile a warpgroup
  unsigned char* ring = Qs + 2 * TB;  // W_STAGES x K, V [64][DP]
  // W_STAGES x the stage's key segments and spans [2][64]
  int* ktab = reinterpret_cast<int*>(ring + W_STAGES * 2 * TB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int H = p.H, Sq = p.Sq, Sk = p.Sk, h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (H / p.Hkv);
  // blocks are issued y by y: the last query tiles, the heaviest under
  // causal order, first
  const int q0 = ((Sq + W_BQ - 1) / W_BQ - 1 - (int)blockIdx.y) * W_BQ;
  const int q1 = min(q0 + W_BQ, Sq);
  const int r0 = q0 + 64 * wg;  // the warpgroup's first row
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)p.Hkv * D;
  const bf16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const int* segqb = p.segq + (int64_t)b * Sq;
  const int* segkb = p.segk + (int64_t)b * Sk;
  const int* spankb = SPANS ? p.spank + (int64_t)b * Sk : segkb;

  // Q, 64 rows a warpgroup; rows past Sq read as zeros (and are
  // masked), and so do columns past D (the upper 32 of DP = 192)
  const bf16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  for (int i = tid; i < W_BQ * CHP; i += W_THREADS) {
    const int r = i / CHP, c = i % CHP, qp = q0 + r;
    cp_async16(Qs + (r / 64) * TB + sw128<64>(r % 64, c),
               qb + (int64_t)(qp < Sq ? qp : q0) * q_stride +
                   (c < CH ? c : 0) * 8,
               qp < Sq && c < CH);
  }
  cp_async_commit();

  // key tile j into ring stage st: K and V in the swizzled layout wgmma
  // reads (columns past D as zeros), the tables beside them (-2 past Sk,
  // as kv padding)
  auto load_kv = [&](int j, int st) {
    const int j0 = j * W_BK;
    unsigned char* Ks = ring + st * 2 * TB;
    for (int i = tid; i < W_BK * CHP; i += W_THREADS) {
      const int r = i / CHP, c = i % CHP, kp = j0 + r;
      const int64_t off =
          (int64_t)(kp < Sk ? kp : j0) * kv_stride + (c < CH ? c : 0) * 8;
      cp_async16(Ks + sw128<W_BK>(r, c), kb + off, kp < Sk && c < CH);
      cp_async16(Ks + TB + sw128<W_BK>(r, c), vb + off, kp < Sk && c < CH);
    }
    if (tid < (SPANS ? 2 : 1) * W_BK) {
      const int kp = j0 + tid % W_BK;
      int* dst = ktab + st * 2 * W_BK + tid;
      if (kp < Sk)
        cp_async4(dst, (tid < W_BK ? segkb : spankb) + kp, true);
      else
        *dst = -2;
    }
    cp_async_commit();
  };

  // the first live key tile at or after j (jt_hi if none), uniform: each
  // warp tests 32 tiles at once (lane i tile base + i) against the rows
  // of both warpgroups and keeps the ballots, so the tables' summaries
  // are read once per 32 tiles; `mine`: the tile is live for this
  // warpgroup's rows (the other's may be all it is live for)
  int j_lo = 0, j_hi = Sk;
  if (!SPANS && p.mode != kFull) {
    j_hi = max(0, min(Sk, q1 - p.kv_offset));
    if (p.mode == kSliding) j_lo = max(0, q0 - p.window - p.kv_offset + 1);
  }
  const int jt_hi = (j_hi + W_BK - 1) / W_BK;
  int live_base = -32;
  uint32_t live_any = 0, live_mine = 0;
  auto next_live = [&](int j, bool& mine) {
    while (j < jt_hi) {
      if (j >= live_base + 32) {
        live_base = j;
        const int k0 = (j + lane) * W_BK, k1 = min(k0 + W_BK, Sk);
        const bool in = j + lane < jt_hi;
        const uint32_t b0 = __ballot_sync(
            FULL, in && tile_live<SPANS>(p, b, q0, min(q0 + 64, Sq), k0, k1));
        const uint32_t b1 = __ballot_sync(
            FULL, in && tile_live<SPANS>(p, b, q0 + 64, min(q0 + 128, Sq),
                                         k0, k1));
        live_any = b0 | b1;
        live_mine = wg ? b1 : b0;
      }
      const uint32_t ahead = live_any >> (j - live_base);
      if (ahead) {
        j += __ffs(ahead) - 1;
        mine = (live_mine >> (j - live_base)) & 1u;
        return j;
      }
      j = live_base + 32;
    }
    mine = false;
    return jt_hi;
  };

  // the thread's two rows: qrow and qrow + 8
  const int qrow = r0 + (warp & 3) * 16 + g;
  const int* spanqb = SPANS ? p.spanq + (int64_t)b * Sq : segqb;
  // the warpgroup's 64 rows lie in one segment (seg_w >= 0): a key tile
  // all in that segment, at or before the first row (and, sliding,
  // within the last row's window) then needs no mask
  const int seg_w = r0 < Sq ? segqb[r0] : -1;
  const bool one_seg = __all_sync(
      FULL, r0 + 64 <= Sq && seg_w >= 0 && segqb[r0 + lane] == seg_w &&
                segqb[r0 + 32 + lane] == seg_w);

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  const uint32_t qa = smem_u32(Qs + wg * TB);

  bool mine;
  int j = next_live(j_lo / W_BK, mine), st = 0;
  if (j < jt_hi) load_kv(j, 0);
  while (j < jt_hi) {
    cp_async_wait<0>();   // tile j (the first time, Q too) has landed
    fence_proxy_async();  // the copies are seen by wgmma's reads
    __syncthreads();      // every warp is done with the other stage
    bool mine_next;
    const int jn = next_live(j + 1, mine_next);
    if (jn < jt_hi) load_kv(jn, st ^ 1);  // lands while tile j is formed
    if (mine) {
      const int kpos0 = p.kv_offset + j * W_BK;
      const uint32_t ka = smem_u32(ring + st * 2 * TB), va = ka + TB;
      const int* segk_s = ktab + st * 2 * W_BK;
      const int* spank_s = segk_s + W_BK;

      // S = Q K^T: 64 rows x 64 keys, both operands K-major
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * SW_BLOCK + (kk & 3) * 32;
        wgmma_ss_n64<0, 0>(&s[0][0], wg_desc(qa + off, 16, SW_GROUP),
                           wg_desc(ka + off, 16, SW_GROUP), 1);
      }
      wgmma_commit();
      wgmma_wait0();

      bool whole = one_seg &&
                   (p.mode == kFull ||
                    (kpos0 + W_BK - 1 <= r0 &&
                     (p.mode != kSliding || kpos0 > r0 + 63 - p.window)));
      whole = __all_sync(FULL, whole && segk_s[lane] == seg_w &&
                                   segk_s[lane + 32] == seg_w);
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= sl2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      } else {
        int segq_r[2], spanq_r[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool in = qrow + 8 * i < Sq;
          segq_r[i] = in ? segqb[qrow + 8 * i] : -1;
          spanq_r[i] = (SPANS && in) ? spanqb[qrow + 8 * i] : -1;
        }
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = n * 8 + t * 2 + (e & 1);
            const bool ok = pair_ok<SPANS>(p.mode, p.window, qrow + 8 * i,
                                           kpos0 + c, segq_r[i], segk_s[c],
                                           spanq_r[i], spank_s[c]);
            s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
            mx[i] = fmaxf(mx[i], s[n][e]);
          }
      }
      // online softmax; a row with no valid key so far keeps m = -inf and
      // subtracts 0, so its probabilities are exactly 0
      float corr[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;
        corr[i] = ex2(m[i] - mu[i]);
        m[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(s[n][e] - mu[e >> 1]);
          psum[e >> 1] += s[n][e];
        }
      // l is the thread's share of its rows' sums until the end
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        acc[nd][0] *= corr[0];
        acc[nd][1] *= corr[0];
        acc[nd][2] *= corr[1];
        acc[nd][3] *= corr[1];
      }
      // O += P V: P from registers (rounded to bf16), V N-major straight
      // from its row-major tile, 16 keys a step; at D = 256 as two
      // products of 128 columns, at D = 160 as one of 128 and one of 64
      // (V's third block)
      uint32_t a[W_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk) {
        a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk) {
        const uint64_t dsc = wg_desc(va + kk * 2048, SW_BLOCK, SW_GROUP);
        if constexpr (D == 64) {
          wgmma_rs_n64<1>(&acc[0][0], a[kk], dsc);
        } else {
          wgmma_rs_n128<1>(&acc[0][0], a[kk], dsc);
        }
        if constexpr (D == 256) {
          const uint32_t vhi = va + 2 * SW_BLOCK + kk * 2048;
          wgmma_rs_n128<1>(&acc[16][0], a[kk],
                           wg_desc(vhi, SW_BLOCK, SW_GROUP));
        }
        if constexpr (DP == 192) {
          const uint32_t v3 = va + 2 * SW_BLOCK + kk * 2048;
          wgmma_rs_n64<1>(&acc[16][0], a[kk],
                          wg_desc(v3, SW_BLOCK, SW_GROUP));
        }
      }
      wgmma_commit();
      wgmma_wait0();
    }
    j = jn;
    mine = mine_next;
    st ^= 1;
  }
  cp_async_wait<0>();  // Q, where no key tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  bf16* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qrow + 8 * i;
    if (qp >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* orow = ob + (int64_t)qp * q_stride + t * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
    if (t == 0)
      lse[((int64_t)b * H + h) * Sq + qp] =
          l[i] > 0.f ? m[i] * 0.6931471805599453f + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------
// Backward, fp32, CUDA cores, D = 128 and 160 (no main path runs them;
// not redesigned). Block = (32-key tile, KV head, batch); thread = (key,
// quarter of D: d = part + 4*i). Per live 32-row query tile, each thread
// forms its key's scores and dP over the tile (a 4-lane shuffle
// reduction), accumulates dK/dV in registers, and writes dS to shared
// memory; then thread (query, quarter) sums dQ over the tile's keys and
// adds it to dq with atomicAdd.
// ---------------------------------------------------------------------
constexpr int BS_BK = 32, BS_BQ = 32, BS_THREADS = 128;

template <int D>
constexpr size_t bwd_f32_smem() {
  return sizeof(float) * (2 * BS_BK * (D + 1) + 2 * BS_BQ * (D + 1) +
                          BS_BQ * (BS_BK + 1) + 2 * BS_BQ) +
         sizeof(int) * (2 * BS_BK + 2 * BS_BQ);
}

template <int D, bool SPANS>
__global__ void __launch_bounds__(BS_THREADS)
packed_bwd_f32_cc_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, Params p, float scale) {
  constexpr int RS = D + 1, SS = BS_BK + 1, NI = D / 4;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BS_BK][RS]
  float* Vs = Ks + BS_BK * RS;      // [BS_BK][RS]
  float* Qs = Vs + BS_BK * RS;      // [BS_BQ][RS]
  float* dOs = Qs + BS_BQ * RS;     // [BS_BQ][RS]
  float* dSs = dOs + BS_BQ * RS;    // [BS_BQ][SS], dS[query][key]
  float* lse_s = dSs + BS_BQ * SS;
  float* delta_s = lse_s + BS_BQ;
  int* segk_s = reinterpret_cast<int*>(delta_s + BS_BQ);
  int* spank_s = segk_s + BS_BK;
  int* segq_s = spank_s + BS_BK;
  int* spanq_s = segq_s + BS_BQ;

  const int tid = threadIdx.x, kl = tid >> 2, part = tid & 3;
  const int k0 = blockIdx.x * BS_BK, hk = blockIdx.y, b = blockIdx.z;
  const int H = p.H, Hkv = p.Hkv, Sq = p.Sq, Sk = p.Sk, G = H / Hkv;
  const int k1 = min(k0 + BS_BK, Sk);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;

  for (int i = tid; i < BS_BK * D; i += BS_THREADS) {
    const int c = i / D, d = i % D, kp = k0 + c;
    const bool in = kp < Sk;
    Ks[c * RS + d] = in ? kb[(int64_t)kp * kv_stride + d] : 0.f;
    Vs[c * RS + d] = in ? vb[(int64_t)kp * kv_stride + d] : 0.f;
  }
  if (tid < BS_BK) {
    const int kp = k0 + tid;
    segk_s[tid] = kp < Sk ? p.segk[(int64_t)b * Sk + kp] : -2;
    spank_s[tid] = (SPANS && kp < Sk) ? p.spank[(int64_t)b * Sk + kp] : -2;
  }
  __syncthreads();
  const int kpos = p.kv_offset + k0 + kl;
  const int segk_r = segk_s[kl], spank_r = spank_s[kl];

  float dka[NI], dva[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) dka[i] = dva[i] = 0.f;

  int i_lo = 0;
  if (!SPANS && p.mode != kFull) i_lo = max(0, p.kv_offset + k0);
  i_lo = (i_lo / BS_BQ) * BS_BQ;

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
    const float* db = dout + (int64_t)b * Sq * q_stride + (int64_t)h * D;
    const float* lseb = lse + ((int64_t)b * H + h) * Sq;
    const float* delb = delta + ((int64_t)b * H + h) * Sq;
    float* dqb = dq + (int64_t)b * Sq * q_stride + (int64_t)h * D;
    for (int q0 = i_lo; q0 < Sq; q0 += BS_BQ) {
      const int q1 = min(q0 + BS_BQ, Sq);
      if (!tile_live<SPANS>(p, b, q0, q1, k0, k1)) continue;
      __syncthreads();
      for (int i = tid; i < BS_BQ * D; i += BS_THREADS) {
        const int c = i / D, d = i % D, qp = q0 + c;
        const bool in = qp < Sq;
        Qs[c * RS + d] = in ? qb[(int64_t)qp * q_stride + d] : 0.f;
        dOs[c * RS + d] = in ? db[(int64_t)qp * q_stride + d] : 0.f;
      }
      if (tid < BS_BQ) {
        const int qp = q0 + tid;
        const bool in = qp < Sq;
        lse_s[tid] = in ? lseb[qp] : 0.f;
        delta_s[tid] = in ? delb[qp] : 0.f;
        segq_s[tid] = in ? p.segq[(int64_t)b * Sq + qp] : -1;
        spanq_s[tid] = (SPANS && in) ? p.spanq[(int64_t)b * Sq + qp] : -1;
      }
      __syncthreads();

      const float* kr = Ks + kl * RS + part;
      const float* vr = Vs + kl * RS + part;
      for (int c = 0; c < BS_BQ; ++c) {
        const float* qr = Qs + c * RS + part;
        const float* dr = dOs + c * RS + part;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          s = fmaf(kr[4 * i], qr[4 * i], s);
          dp = fmaf(vr[4 * i], dr[4 * i], dp);
        }
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        dp += __shfl_xor_sync(FULL, dp, 1);
        dp += __shfl_xor_sync(FULL, dp, 2);
        const bool ok = pair_ok<SPANS>(p.mode, p.window, q0 + c, kpos,
                                       segq_s[c], segk_r, spanq_s[c],
                                       spank_r);
        const float pv = ok ? expf(s * scale - lse_s[c]) : 0.f;
        const float ds = pv * (dp - delta_s[c]) * scale;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          dva[i] = fmaf(pv, dr[4 * i], dva[i]);
          dka[i] = fmaf(ds, qr[4 * i], dka[i]);
        }
        if (part == 0) dSs[c * SS + kl] = ds;
      }
      __syncthreads();

      const int c = tid >> 2;  // query row of the tile
      if (q0 + c < Sq) {
        const float* srow = dSs + c * SS;
        float* dqr = dqb + (int64_t)(q0 + c) * q_stride + part;
#pragma unroll 4
        for (int i = 0; i < NI; ++i) {
          float a = 0.f;
          for (int j = 0; j < BS_BK; ++j)
            a = fmaf(srow[j], Ks[j * RS + part + 4 * i], a);
          atomicAdd(dqr + 4 * i, a);
        }
      }
    }
  }

  const int key = k0 + kl;
  if (key < Sk) {
    float* dkr = dk + (int64_t)b * Sk * kv_stride + (int64_t)key * kv_stride +
                 (int64_t)hk * D + part;
    float* dvr = dv + (int64_t)b * Sk * kv_stride + (int64_t)key * kv_stride +
                 (int64_t)hk * D + part;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      dkr[4 * i] = dka[i];
      dvr[4 * i] = dva[i];
    }
  }
}

// ---------------------------------------------------------------------
// Backward, fp32, D = 64: split TF32 on the tensor cores, designed for
// the H100. The gradient of K1's function, as the other backwards: dq,
// dk, dv from q, k, v, dO, the forward's LSE and delta = rowsum(dO * O)
// (bwd_delta_kernel); every mode, span tables, the ring hop's key tables
// and kv_offset, Sq != Sk, GQA; a row with no valid key gives zeros, a
// masked pair weighs exactly 0.
//
// What bounds it: 10*D flops per valid (query, key) pair per query head
// (S, dP, dV, dK, dQ) against q, k, v, o, dO in and dq, dk, dv out once.
// At whisper-small's training shape (8 x 1500 frames, 12:12 heads, full)
// that is 138 GFLOP against 295 MB: 2.06 ms at the fp32 CUDA-core peak,
// 0.088 ms for the bytes, so operations bound it. Plain TF32 keeps some
// three decimal digits and misses the 1e-4 limit (dK's product alone
// reads 2e-4 at 1 x 1500; tests/test_torch_k1_f32_split.py), so each
// fp32 operand x is carried as hi = tf32(x) and lo = tf32(x - hi) and
// each product formed as hi hi' + hi lo' + lo hi', as K2's fp32 kernel
// does: 15 TF32 products a pair, 0.838 ms at 495 TFLOP/s.
//
// TF32 wgmma reads only K-major operands from shared memory, so dV += P^T
// dO and dK += dS^T Q need dO and Q transposed, dQ = dS K needs K
// transposed, each as hi and lo: one kernel doing all five products over
// 64-row tiles would need 256 KB of shared memory. So two kernels, each
// writing its gradients once (no atomics: the same bits on every call):
//  1. packed_bwd_f32_kernel: dK and dV, a block per (128 keys, KV head,
//     batch), key blocks issued first to last (the heaviest under causal
//     order first). It walks the live query tiles of T_STEP = 32 rows of
//     every query head of its KV head's group and forms S^T = K Q^T, dP^T
//     = V dO^T, P^T, dS^T, dV += P^T dO and dK += dS^T Q.
//  2. packed_bwd_f32_dq_kernel: dQ, a block per (query head, 128
//     queries, batch), the last query rows first. It walks the live key
//     tiles of 32 and forms S = Q K^T, dP = dO V^T, P, dS and dQ += dS K.
// S and dP are formed in both: 21 TF32 products a pair, 1.17 ms at 8 x
// 1500. In each, a block is two warpgroups, each owning 64 rows of its
// fixed side (keys, or queries), split once into shared memory as the A
// operands of S and dP; the walked tiles arrive by 16-byte cp.async into
// a landing tile while the last one is formed, and all 256 threads split
// them: row-major as the B operands of S and dP, and (the queries for dK
// / dV, the keys for dQ) transposed, [64][32] with the rows permuted
// within each group of 8 (kap), the B operand of the second product,
// whose A operand is the first product's accumulator as it lies (K2's
// V^T trick): P and dS never leave the registers. A warpgroup skips the
// pair mask for a tile wholly in its warp's one segment and position
// range. Budget: dK / dV 216,064 bytes of shared memory (K, V hi and lo
// 128 KB; Q, dO hi and lo, row-major and transposed, 64 KB; the landing
// tiles 16 KB; the rows' tables), dQ 200,192 (Q, dO hi and lo 128 KB; K,
// V and K^T's hi and lo 48 KB; the landing tiles 16 KB): one block an SM
// each, 256 threads at up to 255 registers (ptxas: 238-242 and 169-172,
// no spill; k1_fault_check.py prints them). Each walked tile's
// second product goes to a fresh accumulator, added to the running dK,
// dV or dQ in fp32 registers: the tensor cores add into their
// accumulator less exactly than fp32 rounding, and over a walk of 6
// heads x 32 tiles (1024 causal, 12:2) the summed error had reached
// 6.7e-5 of the 1e-4 limit; tile by tile it reads 7.4e-6 at most
// (k1_fault_check.py --shape whisper, H100 80GB HBM3 at 700 W).
// What still holds it back (same card, 8 x 1500: 3.51 ms, 4.2x the
// split-TF32 bound and 3.0x the two kernels' own 1.17, under SDPA
// fp32's 4.20; the dK / dV kernel 1.96, dQ 1.50): the tensor cores
// work a third of the time. One block an SM (shared memory), so a
// warpgroup's products wait on the block's split pass (3.00 ms without
// the walked tiles' splits) and on its own softmax; the lo products
// take a third (2.30 ms with hi hi' alone).
// ---------------------------------------------------------------------
constexpr int T_ROWS = 64;                 // rows a warpgroup owns
constexpr int T_BLOCK = 2 * T_ROWS;        // two warpgroups a block
constexpr int T_STEP = 32;                 // rows of a walked tile
constexpr int T_THREADS = 256;
constexpr int T_D = 64;                    // the head dim it is built for
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the split-TF32 backward: TF bytes of a warpgroup's
// [64][64] fp32 tile, TS of a walked [32][64] tile (or its transpose)
template <int D>
struct F32BwdTile {
  static constexpr int TF = T_ROWS * D * 4;
  static constexpr int TS = T_STEP * D * 4;
  // dK / dV: K's and V's hi and lo (2 tiles each), Q's and dO's hi and
  // lo row-major and transposed (8 walked tiles), Q and dO as they land
  // (2), the landing and current query rows' LSE, delta, segments and
  // spans (8 x T_STEP), the keys' segments and spans, and room to align
  // the tiles to 1024 bytes
  static constexpr size_t kv_smem =
      1024 + 8 * TF + 10 * TS + 4 * (8 * T_STEP + 2 * T_BLOCK);
  // dQ: Q's and dO's hi and lo (2 tiles each), K's and V's hi and lo
  // row-major and K's transposed (6 walked tiles), K and V as they land
  // (2), the landing and current keys' segments and spans (4 x T_STEP),
  // the query rows' LSE, delta, segments and spans (4 x T_BLOCK)
  static constexpr size_t dq_smem =
      1024 + 8 * TF + 8 * TS + 4 * (4 * T_STEP + 4 * T_BLOCK);
};

// The position of row r of a walked tile in its transposed copy: within
// each group of 8, row 2i at i and row 2i + 1 at i + 4, the order in
// which an accumulator's columns serve as a wgmma A operand
__device__ __forceinline__ int kap(int r) {
  const int w = r & 7;
  return (r & ~7) + ((w & 1) ? 4 + (w >> 1) : (w >> 1));
}

// x's lo beside its hi = tf32(x): x - hi rounded to TF32; hi + lo carries
// x to some 2^-22 of itself
__device__ __forceinline__ uint32_t lo_of(float x, uint32_t hi) {
  return tf32(x - __uint_as_float(hi));
}

// A landed walked tile `in` ([ROWS][64], sw128) split by the block: with
// RM hi and lo row-major into `hi` / `lo` (the same layout); with TR
// transposed, [64][ROWS] in 128-byte swizzle blocks of 32 rows of the
// tile, row r of the tile at column kap(r), into `thi` / `tlo`. A warp
// takes 32 consecutive rows of one 16-byte column: no bank conflict
// either way. The backward walks tiles of T_STEP rows, the forward of
// T_KEYS.
template <int ROWS, bool RM, bool TR>
__device__ __forceinline__ void split_step(const unsigned char* in,
                                           unsigned char* hi,
                                           unsigned char* lo,
                                           unsigned char* thi,
                                           unsigned char* tlo, int tid) {
  for (int i = tid; i < ROWS * T_D / 4; i += T_THREADS) {
    const int r = i % ROWS, c = i / ROWS;
    const uint32_t off = sw128<ROWS>(r, c);
    const float4 x = *reinterpret_cast<const float4*>(in + off);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = tf32(xs[e]);
      l[e] = lo_of(xs[e], h[e]);
    }
    if constexpr (RM) {
      *reinterpret_cast<uint4*>(hi + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    if constexpr (TR) {
      const int p = kap(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t to = sw128<T_D>(4 * c + e, p >> 2) + (p & 3) * 4;
        *reinterpret_cast<uint32_t*>(thi + to) = h[e];
        *reinterpret_cast<uint32_t*>(tlo + to) = l[e];
      }
    }
  }
}

// `n` bytes of fixed-side tiles split in place by the block: each fp32 x
// of `hi` becomes tf32(x), its lo goes to the same offset of `lo`
__device__ __forceinline__ void split_fixed(unsigned char* hi,
                                            unsigned char* lo, int n,
                                            int tid) {
  for (int i = tid * 16; i < n; i += T_THREADS * 16) {
    const float4 x = *reinterpret_cast<const float4*>(hi + i);
    const uint4 h = make_uint4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    *reinterpret_cast<uint4*>(lo + i) = make_uint4(
        lo_of(x.x, h.x), lo_of(x.y, h.y), lo_of(x.z, h.z), lo_of(x.w, h.w));
    *reinterpret_cast<uint4*>(hi + i) = h;
  }
}

// An accumulator [64][T_STEP] (T_STEP / 8 groups of 4) as the A operands
// of the T_STEP / 8 k-steps of the product that follows, split: column
// group kk's values in the order kap pairs them with the B operand's rows
template <int NQ>
__device__ __forceinline__ void split_acc(const float (&s)[NQ][4],
                                          uint32_t (&h)[NQ][4],
                                          uint32_t (&l)[NQ][4]) {
#pragma unroll
  for (int kk = 0; kk < NQ; ++kk) {
    const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[kk][e] = tf32(a[e]);
      l[kk][e] = lo_of(a[e], h[kk][e]);
    }
  }
}

// S (+)= A B^T and P (+)= C E^T in split TF32 over D = 64 (8 k-steps):
// A, C the warpgroup's [64][64] fixed tiles (hi `a`, lo `al`; `c`, `cl`),
// B, E walked [T_STEP][64] tiles (hi `b`, lo `bl`; `e`, `el`); the small
// products first
__device__ __forceinline__ void two_products(
    float (&s)[T_STEP / 8][4], float (&dp)[T_STEP / 8][4], uint32_t a,
    uint32_t al, uint32_t b, uint32_t bl, uint32_t c, uint32_t cl,
    uint32_t e, uint32_t el) {
#pragma unroll
  for (int n = 0; n < T_STEP / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[n][x] = dp[n][x] = 0.f;
  pin(s);
  pin(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T_D / 8; ++kk) {
    const uint32_t fo = (kk >> 2) * SW_BLOCK + (kk & 3) * 32;
    const uint32_t wo = (kk >> 2) * (T_STEP * 128) + (kk & 3) * 32;
    wgmma_tf32_ss<T_STEP>(&s[0][0], wg_desc(al + fo, 16, SW_GROUP),
                          wg_desc(b + wo, 16, SW_GROUP));
    wgmma_tf32_ss<T_STEP>(&s[0][0], wg_desc(a + fo, 16, SW_GROUP),
                          wg_desc(bl + wo, 16, SW_GROUP));
    wgmma_tf32_ss<T_STEP>(&s[0][0], wg_desc(a + fo, 16, SW_GROUP),
                          wg_desc(b + wo, 16, SW_GROUP));
    wgmma_tf32_ss<T_STEP>(&dp[0][0], wg_desc(cl + fo, 16, SW_GROUP),
                          wg_desc(e + wo, 16, SW_GROUP));
    wgmma_tf32_ss<T_STEP>(&dp[0][0], wg_desc(c + fo, 16, SW_GROUP),
                          wg_desc(el + wo, 16, SW_GROUP));
    wgmma_tf32_ss<T_STEP>(&dp[0][0], wg_desc(c + fo, 16, SW_GROUP),
                          wg_desc(e + wo, 16, SW_GROUP));
  }
  wgmma_commit();
  wgmma_wait0();
  pin(s);
  pin(dp);
}

// acc += A B over the 8 NK rows of a walked tile (NK k-steps): A from
// registers (split_acc), B a transposed walked tile [64][8 NK] (hi `b`,
// lo `bl`), issued without waiting
template <int NK>
__device__ __forceinline__ void acc_product(float (&acc)[T_D / 8][4],
                                            const uint32_t (&h)[NK][4],
                                            const uint32_t (&l)[NK][4],
                                            uint32_t b, uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t off = (kk >> 2) * (T_D * 128) + (kk & 3) * 32;
    wgmma_tf32<T_D>(&acc[0][0], l[kk], wg_desc(b + off, 16, SW_GROUP));
    wgmma_tf32<T_D>(&acc[0][0], h[kk], wg_desc(bl + off, 16, SW_GROUP));
    wgmma_tf32<T_D>(&acc[0][0], h[kk], wg_desc(b + off, 16, SW_GROUP));
  }
}

// dK, dV of one (128 keys, KV head, batch): S^T = K Q^T, dP^T = V dO^T,
// P^T, dS^T, dV += P^T dO and dK += dS^T Q over every live query tile of
// every query head of the group, written once
template <int D, bool SPANS>
__global__ void __launch_bounds__(T_THREADS, 1)
packed_bwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      Params p, float scale) {
  static_assert(D == T_D, "the split-TF32 backward is built for D = 64");
  constexpr int TF = F32BwdTile<D>::TF, TS = F32BwdTile<D>::TS;
  constexpr int CH = D / 4, NQ = T_STEP / 8, KD = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Khi = sm;             // [2][64][64], a tile a warpgroup
  unsigned char* Klo = sm + 2 * TF;
  unsigned char* Vhi = sm + 4 * TF;
  unsigned char* Vlo = sm + 6 * TF;
  unsigned char* Qhi = sm + 8 * TF;    // [T_STEP][64] each
  unsigned char* Qlo = Qhi + TS;
  unsigned char* dOhi = Qhi + 2 * TS;
  unsigned char* dOlo = Qhi + 3 * TS;
  unsigned char* QThi = Qhi + 4 * TS;  // [64][T_STEP] each, rows kap'd
  unsigned char* QTlo = Qhi + 5 * TS;
  unsigned char* dOThi = Qhi + 6 * TS;
  unsigned char* dOTlo = Qhi + 7 * TS;
  unsigned char* Lq = Qhi + 8 * TS;    // Q and dO as they land
  unsigned char* Ld = Qhi + 9 * TS;
  float* l_lse = reinterpret_cast<float*>(Qhi + 10 * TS);  // landing rows
  float* l_delta = l_lse + T_STEP;
  int* l_segq = reinterpret_cast<int*>(l_delta + T_STEP);
  int* l_spanq = l_segq + T_STEP;
  float* c_lse = reinterpret_cast<float*>(l_spanq + T_STEP);  // current
  float* c_delta = c_lse + T_STEP;
  int* c_segq = reinterpret_cast<int*>(c_delta + T_STEP);
  int* c_spanq = c_segq + T_STEP;
  int* segk_s = c_spanq + T_STEP;      // [T_BLOCK]
  int* spank_s = segk_s + T_BLOCK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, w4 = warp & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = p.H, Hkv = p.Hkv, Sq = p.Sq, Sk = p.Sk, G = H / Hkv;
  const int k0 = blockIdx.x * T_BLOCK, k1 = min(k0 + T_BLOCK, Sk);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;

  // K and V, 64 keys a warpgroup; keys past Sk read as zeros
  for (int i = tid; i < T_BLOCK * CH; i += T_THREADS) {
    const int r = i / CH, c = i % CH, kp = k0 + r;
    const uint32_t off = (r / T_ROWS) * TF + sw128<T_ROWS>(r % T_ROWS, c);
    const int64_t src = (int64_t)(kp < Sk ? kp : k0) * kv_stride + c * 4;
    cp_async16(Khi + off, kb + src, kp < Sk);
    cp_async16(Vhi + off, vb + src, kp < Sk);
  }
  cp_async_commit();
  if (tid < T_BLOCK) {
    const int kp = k0 + tid;
    segk_s[tid] = kp < Sk ? p.segk[(int64_t)b * Sk + kp] : -2;
    spank_s[tid] = (SPANS && kp < Sk) ? p.spank[(int64_t)b * Sk + kp] : -2;
  }

  // query tile q0 of head hk * G + hh into the landing tiles; rows past
  // Sq read as zeros (their tables too: the mask tests the row itself)
  auto load_q = [&](int hh, int q0) {
    const int h = hk * G + hh;
    const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
    const float* db = dout + (int64_t)b * Sq * q_stride + (int64_t)h * D;
    for (int i = tid; i < T_STEP * CH; i += T_THREADS) {
      const int r = i / CH, c = i % CH, qp = q0 + r;
      const uint32_t off = sw128<T_STEP>(r, c);
      const int64_t src = (int64_t)(qp < Sq ? qp : q0) * q_stride + c * 4;
      cp_async16(Lq + off, qb + src, qp < Sq);
      cp_async16(Ld + off, db + src, qp < Sq);
    }
    if (tid < 4 * T_STEP) {
      const int which = tid / T_STEP, r = tid % T_STEP, qp = q0 + r;
      const int qc = qp < Sq ? qp : q0;
      const int64_t row = ((int64_t)b * H + h) * Sq + qc;
      if (which == 0) cp_async4(l_lse + r, lse + row, qp < Sq);
      if (which == 1) cp_async4(l_delta + r, delta + row, qp < Sq);
      if (which == 2)
        cp_async4(l_segq + r, p.segq + (int64_t)b * Sq + qc, qp < Sq);
      if (which == 3 && SPANS)
        cp_async4(l_spanq + r, p.spanq + (int64_t)b * Sq + qc, qp < Sq);
    }
    cp_async_commit();
  };
  // the first live query tile at or after q0 (Sq if none), uniform: each
  // warp tests 32 tiles at once (lane j tile base + j) and keeps the
  // ballot, so the tables' summaries are read once per 32 tiles
  const int n_qt = (Sq + T_STEP - 1) / T_STEP;
  int live_base = -32;
  uint32_t live_bits = 0;
  auto next_live = [&](int q0) {
    for (int j = q0 / T_STEP; j < n_qt;) {
      if (j < live_base || j >= live_base + 32) {
        live_base = j;
        const int qt = (j + lane) * T_STEP;
        const bool live = qt < Sq && tile_live<SPANS>(
                                         p, b, qt, min(qt + T_STEP, Sq), k0, k1);
        live_bits = __ballot_sync(FULL, live);
      }
      const uint32_t ahead = live_bits >> (j - live_base);
      if (ahead) return (j + __ffs(ahead) - 1) * T_STEP;
      j = live_base + 32;
    }
    return Sq;
  };

  int i_lo = 0;
  if (!SPANS && p.mode != kFull) i_lo = max(0, p.kv_offset + k0);
  const int first = next_live((i_lo / T_STEP) * T_STEP);
  int hh = first < Sq ? 0 : G, q0 = first;
  if (hh < G) load_q(0, first);

  cp_async_wait<0>();  // K, V (and the first query tile) have landed
  __syncthreads();
  split_fixed(Khi, Klo, 2 * TF, tid);
  split_fixed(Vhi, Vlo, 2 * TF, tid);

  // the thread's keys: kl and kl + 8 of its warpgroup's 64
  const int kl = wg * T_ROWS + w4 * 16 + g;
  int kpos[2], segk_r[2], spank_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = p.kv_offset + k0 + kl + 8 * i;
    segk_r[i] = segk_s[kl + 8 * i];
    spank_r[i] = spank_s[kl + 8 * i];
  }
  // the warp's 16 keys lie in one segment (seg_w >= 0): a query tile all
  // in that segment and after (and, sliding, within a window of) the
  // keys then needs no mask
  const int kw0 = wg * T_ROWS + w4 * 16;
  const int seg_w = segk_s[kw0];
  const bool one_seg =
      __all_sync(FULL, segk_s[kw0 + (lane & 15)] == seg_w) && seg_w >= 0;
  const int kpos_w = p.kv_offset + k0 + kw0;
  const float sl2 = scale * LOG2E;  // scores in log2 units
  const uint32_t ka = smem_u32(Khi + wg * TF), kla = smem_u32(Klo + wg * TF);
  const uint32_t va = smem_u32(Vhi + wg * TF), vla = smem_u32(Vlo + wg * TF);

  float dka[KD][4], dva[KD][4];  // dK and dV of the thread's two keys
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  while (hh < G) {
    cp_async_wait<0>();  // this query tile has landed
    __syncthreads();     // and the last one's products are done
    split_step<T_STEP, true, true>(Lq, Qhi, Qlo, QThi, QTlo, tid);
    split_step<T_STEP, true, true>(Ld, dOhi, dOlo, dOThi, dOTlo, tid);
    if (tid < T_STEP) {
      c_lse[tid] = l_lse[tid] * LOG2E;
      c_delta[tid] = l_delta[tid];
      c_segq[tid] = l_segq[tid];
      c_spanq[tid] = SPANS ? l_spanq[tid] : -1;
    }
    fence_proxy_async();  // the split tiles are seen by wgmma's reads
    __syncthreads();
    // the next live tile, of this head or the next, lands meanwhile
    int hn = hh, qn = next_live(q0 + T_STEP);
    if (qn >= Sq) {
      hn = hh + 1;
      qn = first;
    }
    if (hn < G) load_q(hn, qn);

    float s[NQ][4], dp[NQ][4];  // S^T, dP^T: 64 keys x T_STEP queries
    two_products(s, dp, ka, kla, smem_u32(Qhi), smem_u32(Qlo), va, vla,
                 smem_u32(dOhi), smem_u32(dOlo));

    bool all_ok = one_seg && q0 + T_STEP <= Sq &&
                  (p.mode == kFull ||
                   (kpos_w + 15 <= q0 &&
                    (p.mode != kSliding ||
                     kpos_w > q0 + T_STEP - 1 - p.window)));
    all_ok = __all_sync(FULL, all_ok && c_segq[lane] == seg_w);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + t * 2 + (e & 1);
        const bool ok =
            all_ok ||
            (q0 + c < Sq && c_lse[c] != -INFINITY &&
             pair_ok<SPANS>(p.mode, p.window, q0 + c, kpos[i], c_segq[c],
                            segk_r[i], c_spanq[c], spank_r[i]));
        const float pv = ok ? ex2(s[n][e] * sl2 - c_lse[c]) : 0.f;
        s[n][e] = pv;
        dp[n][e] = pv * (dp[n][e] - c_delta[c]) * scale;
      }
    // this tile's P^T dO and dS^T Q (P^T and dS^T from registers) into
    // fresh accumulators, added to dV and dK in fp32 registers
    uint32_t ph[NQ][4], pl[NQ][4], dh[NQ][4], dl[NQ][4];
    split_acc(s, ph, pl);
    split_acc(dp, dh, dl);
    float tv[KD][4], tk[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tv[n][e] = tk[n][e] = 0.f;
    pin(ph);
    pin(pl);
    pin(dh);
    pin(dl);
    pin(tv);
    pin(tk);
    wgmma_fence();
    acc_product(tv, ph, pl, smem_u32(dOThi), smem_u32(dOTlo));
    acc_product(tk, dh, dl, smem_u32(QThi), smem_u32(QTlo));
    wgmma_commit();
    wgmma_wait0();
    pin(tv);
    pin(tk);
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[n][e] += tv[n][e];
        dka[n][e] += tk[n][e];
      }
    hh = hn;
    q0 = qn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kl + 8 * i;
    if (key >= Sk) continue;
    const int64_t row = ((int64_t)b * Sk + key) * kv_stride + (int64_t)hk * D;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      *reinterpret_cast<float2*>(dk + row + n * 8 + t * 2) =
          make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + row + n * 8 + t * 2) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// dQ of one (query head, 128 queries, batch): S = Q K^T, dP = dO V^T, P,
// dS and dQ += dS K over every live key tile, written once
template <int D, bool SPANS>
__global__ void __launch_bounds__(T_THREADS, 1)
packed_bwd_f32_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Params p, float scale) {
  static_assert(D == T_D, "the split-TF32 backward is built for D = 64");
  constexpr int TF = F32BwdTile<D>::TF, TS = F32BwdTile<D>::TS;
  constexpr int CH = D / 4, NK = T_STEP / 8, KD = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Qhi = sm;             // [2][64][64], a tile a warpgroup
  unsigned char* Qlo = sm + 2 * TF;
  unsigned char* dOhi = sm + 4 * TF;
  unsigned char* dOlo = sm + 6 * TF;
  unsigned char* Khi = sm + 8 * TF;    // [T_STEP][64] each
  unsigned char* Klo = Khi + TS;
  unsigned char* Vhi = Khi + 2 * TS;
  unsigned char* Vlo = Khi + 3 * TS;
  unsigned char* KThi = Khi + 4 * TS;  // [64][T_STEP] each, rows kap'd
  unsigned char* KTlo = Khi + 5 * TS;
  unsigned char* Lk = Khi + 6 * TS;    // K and V as they land
  unsigned char* Lv = Khi + 7 * TS;
  int* l_segk = reinterpret_cast<int*>(Khi + 8 * TS);  // landing keys
  int* l_spank = l_segk + T_STEP;
  int* c_segk = l_spank + T_STEP;                      // current keys
  int* c_spank = c_segk + T_STEP;
  float* lse_s = reinterpret_cast<float*>(c_spank + T_STEP);  // [T_BLOCK]
  float* delta_s = lse_s + T_BLOCK;
  int* segq_s = reinterpret_cast<int*>(delta_s + T_BLOCK);
  int* spanq_s = segq_s + T_BLOCK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, w4 = warp & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int H = p.H, Hkv = p.Hkv, Sq = p.Sq, Sk = p.Sk;
  const int hk = h / (H / Hkv);
  // blocks are issued y by y: the last query rows, the heaviest under
  // causal order, first
  const int q0 = ((Sq + T_BLOCK - 1) / T_BLOCK - 1 - (int)blockIdx.y) *
                 T_BLOCK;
  const int q1 = min(q0 + T_BLOCK, Sq);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* db = dout + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;

  // Q and dO, 64 rows a warpgroup, and the rows' LSE, delta and tables;
  // rows past Sq read as zeros (and are masked)
  for (int i = tid; i < T_BLOCK * CH; i += T_THREADS) {
    const int r = i / CH, c = i % CH, qp = q0 + r;
    const uint32_t off = (r / T_ROWS) * TF + sw128<T_ROWS>(r % T_ROWS, c);
    const int64_t src = (int64_t)(qp < Sq ? qp : q0) * q_stride + c * 4;
    cp_async16(Qhi + off, qb + src, qp < Sq);
    cp_async16(dOhi + off, db + src, qp < Sq);
  }
  for (int i = tid; i < 4 * T_BLOCK; i += T_THREADS) {
    const int which = i / T_BLOCK, r = i % T_BLOCK, qp = q0 + r;
    const int qc = qp < Sq ? qp : q0;
    const int64_t row = ((int64_t)b * H + h) * Sq + qc;
    if (which == 0) cp_async4(lse_s + r, lse + row, qp < Sq);
    if (which == 1) cp_async4(delta_s + r, delta + row, qp < Sq);
    if (which == 2)
      cp_async4(segq_s + r, p.segq + (int64_t)b * Sq + qc, qp < Sq);
    if (which == 3 && SPANS)
      cp_async4(spanq_s + r, p.spanq + (int64_t)b * Sq + qc, qp < Sq);
  }
  cp_async_commit();

  // key tile j into the landing tiles; keys past Sk read as zeros, their
  // segments as kv padding (-2)
  auto load_k = [&](int j) {
    const int j0 = j * T_STEP;
    for (int i = tid; i < T_STEP * CH; i += T_THREADS) {
      const int r = i / CH, c = i % CH, kp = j0 + r;
      const uint32_t off = sw128<T_STEP>(r, c);
      const int64_t src = (int64_t)(kp < Sk ? kp : j0) * kv_stride + c * 4;
      cp_async16(Lk + off, kb + src, kp < Sk);
      cp_async16(Lv + off, vb + src, kp < Sk);
    }
    if (tid < (SPANS ? 2 : 1) * T_STEP) {
      const int r = tid % T_STEP, kp = j0 + r;
      int* dst = (tid < T_STEP ? l_segk : l_spank) + r;
      if (kp < Sk)
        cp_async4(dst, (tid < T_STEP ? p.segk : p.spank) +
                           (int64_t)b * Sk + kp, true);
      else
        *dst = -2;
    }
    cp_async_commit();
  };
  // the key tiles some row of the block can see by position: [jt_lo,
  // jt_hi); of them the first live one at or after j (jt_hi if none),
  // uniform, found 32 at a time by one ballot
  int j_lo = 0, j_hi = Sk;
  if (!SPANS && p.mode != kFull) {
    j_hi = max(0, min(Sk, q1 - p.kv_offset));
    if (p.mode == kSliding) j_lo = max(0, q0 - p.window - p.kv_offset + 1);
  }
  const int jt_hi = (j_hi + T_STEP - 1) / T_STEP;
  int live_base = -32;
  uint32_t live_bits = 0;
  auto next_live = [&](int j) {
    while (j < jt_hi) {
      if (j >= live_base + 32) {
        live_base = j;
        const int kt = (j + lane) * T_STEP;
        live_bits = __ballot_sync(
            FULL, j + lane < jt_hi &&
                      tile_live<SPANS>(p, b, q0, q1, kt,
                                       min(kt + T_STEP, Sk)));
      }
      const uint32_t ahead = live_bits >> (j - live_base);
      if (ahead) return j + __ffs(ahead) - 1;
      j = live_base + 32;
    }
    return jt_hi;
  };

  int j = next_live(j_lo / T_STEP);
  if (j < jt_hi) load_k(j);
  cp_async_wait<0>();  // Q, dO, the rows' tables (and the first key tile)
  __syncthreads();
  split_fixed(Qhi, Qlo, 2 * TF, tid);
  split_fixed(dOhi, dOlo, 2 * TF, tid);

  // the thread's rows: ql and ql + 8 of the block's 128
  const int ql = wg * T_ROWS + w4 * 16 + g;
  int segq_r[2], spanq_r[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = q0 + ql + 8 * i < Sq;
    segq_r[i] = in ? segq_s[ql + 8 * i] : -1;
    spanq_r[i] = (SPANS && in) ? spanq_s[ql + 8 * i] : -1;
    lse_r[i] = lse_s[ql + 8 * i] * LOG2E;
    delta_r[i] = delta_s[ql + 8 * i];
  }
  // the warp's 16 rows lie in one segment (seg_w >= 0): a key tile all
  // in that segment, at or before the first row (and, sliding, within
  // the last row's window) then needs no mask
  const int qw0 = wg * T_ROWS + w4 * 16, rw = q0 + qw0;
  const int seg_w = rw < Sq ? segq_s[qw0] : -1;
  const bool one_seg =
      __all_sync(FULL, rw + 16 <= Sq && segq_s[qw0 + (lane & 15)] == seg_w) &&
      seg_w >= 0;
  const float sl2 = scale * LOG2E;  // scores in log2 units
  const uint32_t qa = smem_u32(Qhi + wg * TF), qla = smem_u32(Qlo + wg * TF);
  const uint32_t da = smem_u32(dOhi + wg * TF),
                 dla = smem_u32(dOlo + wg * TF);

  float dqa[KD][4];  // dQ of the thread's two rows
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  while (j < jt_hi) {
    cp_async_wait<0>();  // key tile j has landed
    __syncthreads();     // and the last one's products are done
    split_step<T_STEP, true, true>(Lk, Khi, Klo, KThi, KTlo, tid);
    split_step<T_STEP, true, false>(Lv, Vhi, Vlo, nullptr, nullptr,
                                     tid);
    if (tid < T_STEP) {
      c_segk[tid] = l_segk[tid];
      c_spank[tid] = SPANS ? l_spank[tid] : -2;
    }
    fence_proxy_async();  // the split tiles are seen by wgmma's reads
    __syncthreads();
    const int jn = next_live(j + 1);
    if (jn < jt_hi) load_k(jn);  // lands while tile j is formed

    float s[NK][4], dp[NK][4];  // S, dP: 64 rows x T_STEP keys
    two_products(s, dp, qa, qla, smem_u32(Khi), smem_u32(Klo), da, dla,
                 smem_u32(Vhi), smem_u32(Vlo));

    const int kpos0 = p.kv_offset + j * T_STEP;
    bool all_ok = one_seg && (j + 1) * T_STEP <= Sk &&
                  (p.mode == kFull ||
                   (kpos0 + T_STEP - 1 <= rw &&
                    (p.mode != kSliding || kpos0 > rw + 15 - p.window)));
    all_ok = __all_sync(FULL, all_ok && c_segk[lane] == seg_w);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = n * 8 + t * 2 + (e & 1);
        const bool ok =
            all_ok ||
            (lse_r[i] != -INFINITY &&
             pair_ok<SPANS>(p.mode, p.window, q0 + ql + 8 * i, kpos0 + c,
                            segq_r[i], c_segk[c], spanq_r[i], c_spank[c]));
        const float pv = ok ? ex2(s[n][e] * sl2 - lse_r[i]) : 0.f;
        dp[n][e] = pv * (dp[n][e] - delta_r[i]) * scale;
      }
    // this tile's dS K (dS from registers, K^T's keys permuted to
    // match) into a fresh accumulator, added to dQ in fp32 registers
    uint32_t dh[NK][4], dl[NK][4];
    split_acc(dp, dh, dl);
    float tq[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tq[n][e] = 0.f;
    pin(dh);
    pin(dl);
    pin(tq);
    wgmma_fence();
    acc_product(tq, dh, dl, smem_u32(KThi), smem_u32(KTlo));
    wgmma_commit();
    wgmma_wait0();
    pin(tq);
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] += tq[n][e];
    j = jn;
  }

  float* dqb = dq + (int64_t)b * Sq * q_stride + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + ql + 8 * i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      *reinterpret_cast<float2*>(dqb + (int64_t)qp * q_stride + n * 8 +
                                 t * 2) =
          make_float2(dqa[n][2 * i], dqa[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------
// Forward, fp32, D = 64: split TF32 on the tensor cores, designed for
// the H100 (whisper-small's encoder and cross-attention in training,
// and every fp32 model at head_dim 64). K1's function as the CUDA-core
// kernel computes it: every mode, span tables, a ring hop's key tables
// and kv_offset, Sq != Sk, GQA; o in fp32 and the LSE in natural-log
// units (-inf for a row with no valid key, whose o is exact zeros).
//
// What bounds it: 4*D flops per valid (query, key) pair per query head
// (S = Q K^T, O = P V) against q, k, v read and o, the LSE written once.
// At whisper-small's encoder in training (8 x 1500 frames, 12:12 heads,
// full) that is 6.91 GFLOP a row against 18.5 MB: for the 8 rows 0.825
// ms at the fp32 CUDA-core peak, 0.044 ms for the bytes, so operations
// bound it. Plain
// TF32 misses the 1e-4 limit, so each operand is carried as hi = tf32(x)
// and lo = tf32(x - hi) and each product formed as hi hi' + hi lo' + lo
// hi', as K2's fp32 kernel and the backward above do: 0.335 ms at 495
// TFLOP/s.
//
// What the design does about it:
//  1. Products. S = Q K^T and O += P V by wgmma m64n64k8 in TF32, fp32
//     sums. Q's hi and lo are split once a block into registers (the A
//     operands of S); V^T is stored with its keys in kap order, so S's
//     accumulator, split in registers, is P's A operand as it lies: P
//     never leaves the registers.
//  2. Split once a block. A block is two warpgroups over 128 query rows
//     of one query head (the last query tiles first), 64 rows each,
//     sharing every split 64-key tile: all 256 threads split K (hi and
//     lo, row-major) and V (hi and lo, transposed) as they land, half
//     the split work a row of K2's one-warpgroup blocks. The split and
//     O += P V are the backward's helpers (split_step, acc_product) at
//     tiles of 64 keys.
//  3. A ring. Split tiles form a ring of two stages and landing tiles
//     another: a warpgroup forms tile j from one stage, then the block
//     splits tile j + 1 into the other (the other warpgroup's products
//     may still read the first) while tile j + 2 lands by 16-byte
//     cp.async. One barrier a tile. Splitting tile j + 1 between a
//     warpgroup's own products instead measured 5% slower. Shared
//     memory 199,680 bytes (split 128 KB, landing 64 KB), so one block
//     an SM with up to 255 registers a thread: Q's split alone is 64 of
//     them.
//  4. Live tiles and masks as the bf16 kernel's: live key tiles found
//     32 at a time by one ballot over the tables' summaries (a dead
//     tile costs no products); a tile wholly in the warpgroup's one
//     segment and position range skips the pair mask.
//  5. Softmax online in fp32, in log2 units; the LSE written as m ln 2 +
//     log(l) in natural-log units (the backward multiplies it by
//     log2(e)). O is one accumulator over the walk, rescaled in
//     registers before each tile's P V adds into it on the tensor
//     cores: over the longest row the main paths build (4096 tokens
//     with frames, 12:2 causal, up to 64 tiles) o reads 5.5e-6 against
//     the 1e-4 limit (a fresh accumulator a tile: 1.7e-6, but 3.5%
//     slower, its 32 more registers making ptxas spill).
// What still holds it back (H100 80GB HBM3 at 700 W, 8 x 1500: 0.91-0.93
// ms, 2.7x the split-TF32 bound of 0.335 ms, against the CUDA-core
// kernel's 5.7 and SDPA fp32's 1.72; 8 x 448 over 1500: 0.31 against
// 2.3 and 0.59): the split pass takes some 20% (the walk
// without it 0.76 at 8 x 1500); the rest leaves the tensor cores idle
// over half the time: a warpgroup waits on its own two products in
// turn and forms the softmax between them, both warpgroups in step
// after each tile's barrier, and one block an SM (shared memory; ptxas
// 255 registers, 0 / 70 bytes of spill with / without spans) leaves no
// other block to fill the gaps.
// ---------------------------------------------------------------------
constexpr int T_KEYS = 64;                 // keys of a forward tile
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of the split-TF32 forward: TF bytes of a [64][64] fp32
// tile; two stages of split tiles (K's hi and lo, V^T's hi and lo), two
// of landing tiles (K, V), each stage's key segments and spans as they
// land and as split, and room to align the tiles to 1024 bytes
template <int D>
struct F32FwdTile {
  static constexpr int TF = T_KEYS * D * 4;
  static constexpr size_t smem = 1024 + 12 * TF + 4 * (8 * T_KEYS);
};

template <int D, bool SPANS>
__global__ void __launch_bounds__(T_THREADS, 1)
packed_fwd_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Params p, float scale) {
  static_assert(D == T_D, "the split-TF32 forward is built for D = 64");
  constexpr int TF = F32FwdTile<D>::TF;
  constexpr int CH = D / 4;        // 16-byte chunks of a row of K or V
  constexpr int KD = D / 8;        // k-steps of S = Q K^T, and O's groups
  constexpr int NK = T_KEYS / 8;   // k-steps of O += P V, and S's groups
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // split stage st at sm + st * 4 * TF: K's hi, K's lo [64 keys][64],
  // V^T's hi, V^T's lo [64][64 keys, kap'd]
  unsigned char* land = sm + 8 * TF;  // stage st: K, V as they land
  int* ltab = reinterpret_cast<int*>(sm + 12 * TF);  // [2][2][T_KEYS]
  int* ctab = ltab + 4 * T_KEYS;      // the split stages' tables

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.z, Sq = p.Sq, Sk = p.Sk;
  const int hk = h / (p.H / p.Hkv);
  // blocks are issued y by y: the last query tiles, the heaviest under
  // causal order, first
  const int q0 = ((Sq + T_BLOCK - 1) / T_BLOCK - 1 - (int)blockIdx.y) *
                 T_BLOCK;
  const int q1 = min(q0 + T_BLOCK, Sq);
  const int r0 = q0 + T_ROWS * wg;  // the warpgroup's first row
  const int64_t q_stride = (int64_t)p.H * D, kv_stride = (int64_t)p.Hkv * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const int* segqb = p.segq + (int64_t)b * Sq;
  const int* segkb = p.segk + (int64_t)b * Sk;
  const int* spanqb = SPANS ? p.spanq + (int64_t)b * Sq : segqb;
  const int* spankb = SPANS ? p.spank + (int64_t)b * Sk : segkb;

  // key tile j into landing stage st: K and V in the 128-byte swizzle
  // (keys past Sk as zeros), the tables beside them (-2 past Sk, as kv
  // padding)
  auto load_kv = [&](int j, int st) {
    const int j0 = j * T_KEYS;
    unsigned char* L = land + st * 2 * TF;
    for (int i = tid; i < T_KEYS * CH; i += T_THREADS) {
      const int r = i / CH, c = i % CH, kp = j0 + r;
      const int64_t off = (int64_t)(kp < Sk ? kp : j0) * kv_stride + c * 4;
      cp_async16(L + sw128<T_KEYS>(r, c), kb + off, kp < Sk);
      cp_async16(L + TF + sw128<T_KEYS>(r, c), vb + off, kp < Sk);
    }
    if (tid < (SPANS ? 2 : 1) * T_KEYS) {
      const int kp = j0 + tid % T_KEYS;
      int* dst = ltab + st * 2 * T_KEYS + tid;
      if (kp < Sk)
        cp_async4(dst, (tid < T_KEYS ? segkb : spankb) + kp, true);
      else
        *dst = -2;
    }
    cp_async_commit();
  };
  // landing stage st split by the block into split stage st: K's hi and
  // lo in K's layout; V's transposed, key r of the tile to column kap(r)
  // of row d of V^T, the B operand of O += P V; the tables beside them
  auto split_kv = [&](int st) {
    const unsigned char* L = land + st * 2 * TF;
    unsigned char* Kh = sm + st * 4 * TF;
    split_step<T_KEYS, true, false>(L, Kh, Kh + TF, nullptr, nullptr, tid);
    split_step<T_KEYS, false, true>(L + TF, nullptr, nullptr, Kh + 2 * TF,
                                    Kh + 3 * TF, tid);
    if (tid < 2 * T_KEYS)
      ctab[st * 2 * T_KEYS + tid] = ltab[st * 2 * T_KEYS + tid];
  };

  // the key tiles some row of the block can see by position: [j_lo /
  // T_KEYS, jt_hi); of them the first live one at or after j (jt_hi if
  // none), uniform: each warp tests 32 tiles at once (lane i tile base +
  // i) against the rows of both warpgroups and keeps the ballots, so the
  // tables' summaries are read once per 32 tiles; `mine`: the tile is
  // live for this warpgroup's rows (the other's may be all it is live
  // for)
  int j_lo = 0, j_hi = Sk;
  if (!SPANS && p.mode != kFull) {
    j_hi = max(0, min(Sk, q1 - p.kv_offset));
    if (p.mode == kSliding) j_lo = max(0, q0 - p.window - p.kv_offset + 1);
  }
  const int jt_hi = (j_hi + T_KEYS - 1) / T_KEYS;
  int live_base = -32;
  uint32_t live_any = 0, live_mine = 0;
  auto next_live = [&](int j, bool& mine) {
    while (j < jt_hi) {
      if (j >= live_base + 32) {
        live_base = j;
        const int k0 = (j + lane) * T_KEYS, k1 = min(k0 + T_KEYS, Sk);
        const bool in = j + lane < jt_hi;
        const uint32_t b0 = __ballot_sync(
            FULL, in && tile_live<SPANS>(p, b, q0, min(q0 + T_ROWS, Sq),
                                         k0, k1));
        const uint32_t b1 = __ballot_sync(
            FULL, in && tile_live<SPANS>(p, b, q0 + T_ROWS,
                                         min(q0 + T_BLOCK, Sq), k0, k1));
        live_any = b0 | b1;
        live_mine = wg ? b1 : b0;
      }
      const uint32_t ahead = live_any >> (j - live_base);
      if (ahead) {
        j += __ffs(ahead) - 1;
        mine = ((live_mine >> (j - live_base)) & 1u) != 0;
        return j;
      }
      j = live_base + 32;
    }
    mine = false;
    return jt_hi;
  };

  // the thread's two rows, qrow and qrow + 8, and Q's A operands for
  // the D / 8 k-steps of S, split once; rows past Sq read as zeros (they
  // are masked and never written)
  const int qrow = r0 + (warp & 3) * 16 + g;
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  uint32_t qh[KD][4], ql[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qrow + 8 * (e & 1), d = kk * 8 + t + 4 * (e >> 1);
      const float x = row < Sq ? qb[(int64_t)row * q_stride + d] : 0.f;
      qh[kk][e] = tf32(x);
      ql[kk][e] = lo_of(x, qh[kk][e]);
    }
  // the warpgroup's 64 rows lie in one segment (seg_w >= 0): a key tile
  // all in that segment, at or before the first row (and, sliding,
  // within the last row's window) then needs no mask
  const int seg_w = r0 < Sq ? segqb[r0] : -1;
  const bool one_seg = __all_sync(
      FULL, r0 + T_ROWS <= Sq && seg_w >= 0 && segqb[r0 + lane] == seg_w &&
                segqb[r0 + 32 + lane] == seg_w);
  int segq_r[2], spanq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qrow + 8 * i < Sq;
    segq_r[i] = in ? segqb[qrow + 8 * i] : -1;
    spanq_r[i] = (SPANS && in) ? spanqb[qrow + 8 * i] : -1;
  }

  const float sl2 = scale * LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // the first live tile lands and is split; the second lands meanwhile
  bool mine, mine_n, mine_nn;
  int j = next_live(j_lo / T_KEYS, mine);
  if (j < jt_hi) load_kv(j, 0);
  int jn = next_live(j + 1, mine_n);
  cp_async_wait<0>();
  __syncthreads();
  if (jn < jt_hi) load_kv(jn, 1);
  if (j < jt_hi) split_kv(0);
  fence_proxy_async();  // the split tiles are seen by wgmma's reads
  for (int st = 0; j < jt_hi; st ^= 1) {
    cp_async_wait<0>();  // tile jn has landed
    __syncthreads();     // tile j is split, tile j - 1's products done
    const int jnn = next_live(jn + 1, mine_nn);
    if (jnn < jt_hi) load_kv(jnn, st);  // lands while tile j is formed
    if (mine) {
      const uint32_t ka = smem_u32(sm + st * 4 * TF), kla = ka + TF;
      const uint32_t va = ka + 2 * TF, vla = ka + 3 * TF;
      const int* kseg = ctab + st * 2 * T_KEYS;
      const int* kspan = kseg + T_KEYS;

      // S = Q K^T: 64 rows x 64 keys, the small products first
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      pin(s);
      pin(qh);
      pin(ql);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t off = (kk >> 2) * SW_BLOCK + (kk & 3) * 32;
        wgmma_tf32<T_KEYS>(&s[0][0], ql[kk], wg_desc(ka + off, 16, SW_GROUP));
        wgmma_tf32<T_KEYS>(&s[0][0], qh[kk], wg_desc(kla + off, 16, SW_GROUP));
        wgmma_tf32<T_KEYS>(&s[0][0], qh[kk], wg_desc(ka + off, 16, SW_GROUP));
      }
      wgmma_commit();
      wgmma_wait0();
      pin(s);

      const int kpos0 = p.kv_offset + j * T_KEYS;
      bool whole = p.mode == kFull ||
                   (kpos0 + T_KEYS - 1 <= r0 &&
                    (p.mode != kSliding ||
                     kpos0 > r0 + T_ROWS - 1 - p.window));
      whole = __all_sync(FULL, one_seg && whole && kseg[lane] == seg_w &&
                                   kseg[lane + 32] == seg_w);
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= sl2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = n * 8 + t * 2 + (e & 1);
            const bool ok = pair_ok<SPANS>(p.mode, p.window, qrow + 8 * i,
                                           kpos0 + c, segq_r[i], kseg[c],
                                           spanq_r[i], kspan[c]);
            s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
            mx[i] = fmaxf(mx[i], s[n][e]);
          }
      }
      // online softmax; a row with no valid key so far keeps m = -inf and
      // subtracts 0, so its probabilities are exactly 0
      float corr[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;
        corr[i] = ex2(m[i] - mu[i]);
        m[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2(s[n][e] - mu[e >> 1]);
          psum[e >> 1] += s[n][e];
        }
      // l is the thread's share of its rows' sums until the end
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];

      // O rescaled, then O += P V: P's A operand of k-step kk is S's
      // group kk as it lies, split in registers (V^T's keys are permuted
      // to match)
      uint32_t ph[NK][4], pl[NK][4];
      split_acc(s, ph, pl);
#pragma unroll
      for (int nd = 0; nd < KD; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];
      pin(ph);
      pin(pl);
      pin(acc);
      wgmma_fence();
      acc_product(acc, ph, pl, va, vla);
      wgmma_commit();
      wgmma_wait0();
      pin(acc);
    }
    // tile jn split into the other stage, which no warp reads before the
    // next barrier: the other warpgroup's products may still run
    if (jn < jt_hi) split_kv(st ^ 1);
    fence_proxy_async();  // tile jn's split is seen by wgmma's reads
    j = jn;
    mine = mine_n;
    jn = jnn;
    mine_n = mine_nn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  float* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = qrow + 8 * i;
    if (qp >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = ob + (int64_t)qp * q_stride + t * 2;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
      *reinterpret_cast<float2*>(orow + nd * 8) =
          make_float2(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
    if (t == 0)
      lse[((int64_t)b * p.H + h) * Sq + qp] =
          l[i] > 0.f ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

// ---------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------
cudaError_t summarize(const Params& p, int4* sumq, int4* sumk,
                      cudaStream_t stream) {
  tile_summary_kernel<<<dim3(p.nsq, p.B), 32, 0, stream>>>(
      p.segq, p.spanq, p.Sq, p.nsq, sumq);
  tile_summary_kernel<<<dim3(p.nsk, p.B), 32, 0, stream>>>(
      p.segk, p.spank, p.Sk, p.nsk, sumk);
  return cudaGetLastError();
}

// grid x, y, z, threads and shared memory of the last forward launch,
// packed_fwd_wg_kernel, packed_fwd_f32_kernel or packed_fwd_f32_cc_kernel
// (k1_last_fwd_launch reads them)
static long long g_fwd_launch[5] = {0, 0, 0, 0, 0};

template <typename T, int D, bool SPANS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Params& p, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = FwdWgTile<D>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        packed_fwd_wg_kernel<D, SPANS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.H, (p.Sq + W_BQ - 1) / W_BQ, p.B);
    const long long launch[5] = {grid.x, grid.y, grid.z, W_THREADS,
                                 (long long)smem};
    for (int i = 0; i < 5; ++i) g_fwd_launch[i] = launch[i];
    packed_fwd_wg_kernel<D, SPANS><<<grid, W_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, p, scale);
  } else if constexpr (D == T_D) {
    // split TF32 on the tensor cores
    static bool smem_set[MAX_DEVICES];
    constexpr size_t smem = F32FwdTile<D>::smem;
    cudaError_t err =
        allow_smem(packed_fwd_f32_kernel<D, SPANS>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.H, (p.Sq + T_BLOCK - 1) / T_BLOCK, p.B);
    const long long launch[5] = {grid.x, grid.y, grid.z, T_THREADS,
                                 (long long)smem};
    for (int i = 0; i < 5; ++i) g_fwd_launch[i] = launch[i];
    packed_fwd_f32_kernel<D, SPANS><<<grid, T_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, p, scale);
  } else {
    constexpr size_t smem = fwd_f32_smem<D>();
    cudaError_t err = cudaFuncSetAttribute(
        packed_fwd_f32_cc_kernel<D, SPANS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + S_BQ - 1) / S_BQ, p.H, p.B);
    const long long launch[5] = {grid.x, grid.y, grid.z, S_THREADS,
                                 (long long)smem};
    for (int i = 0; i < 5; ++i) g_fwd_launch[i] = launch[i];
    packed_fwd_f32_cc_kernel<D, SPANS><<<grid, S_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, p, scale);
  }
  return cudaGetLastError();
}

// grid x, y, z, threads, shared memory and scratch bytes of the last
// backward launch, packed_bwd_kv_kernel (bf16), packed_bwd_f32_kernel
// (fp32, D = 64: dK and dV) or packed_bwd_f32_cc_kernel (fp32, D = 128 /
// 160) (k1_last_bwd_kv_launch reads them); grid, threads and shared
// memory of the last packed_bwd_f32_dq_kernel (k1_last_bwd_dq_launch)
static long long g_bwd_kv_launch[6] = {0, 0, 0, 0, 0, 0};
static long long g_bwd_dq_launch[5] = {0, 0, 0, 0, 0};

template <typename T, int D, bool SPANS>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, float* dq_acc, void* dk, void* dv,
                       float* work, const Params& p, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const int rows = p.B * p.Sq * p.H;
  bwd_delta_kernel<T, D><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, p.B,
      p.Sq, p.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = BwdKvTile<D>::smem;
    err = cudaFuncSetAttribute(packed_bwd_kv_kernel<D, SPANS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    // the partials of dK and dV, [B, Sk, H, D] each, when H > Hkv
    const bool grouped = p.H != p.Hkv;
    float* dk_part = grouped ? work : nullptr;
    float* dv_part = grouped ? work + (int64_t)p.B * p.Sk * p.H * D : nullptr;
    const dim3 grid(p.H, (p.Sk + K_BK - 1) / K_BK, p.B);
    const long long launch[6] = {
        grid.x, grid.y, grid.z, K_THREADS, (long long)smem,
        grouped ? 2LL * p.B * p.Sk * p.H * D * (long long)sizeof(float)
                : 0};
    for (int i = 0; i < 6; ++i) g_bwd_kv_launch[i] = launch[i];
    packed_bwd_kv_kernel<D, SPANS><<<grid, K_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq_acc, dk_part, dv_part, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), p, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || !grouped) return err;
    const int64_t n4 = (int64_t)p.B * p.Sk * p.Hkv * D / 4;
    bwd_kv_reduce_kernel<D><<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        dk_part, dv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4,
        p.H / p.Hkv);
  } else if constexpr (D == T_D) {
    // split TF32: dK and dV, then dQ, each written once
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
    static bool kv_set[MAX_DEVICES], dq_set[MAX_DEVICES];
    constexpr size_t kv_smem = F32BwdTile<D>::kv_smem;
    err = allow_smem(packed_bwd_f32_kernel<D, SPANS>, kv_smem, kv_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + T_BLOCK - 1) / T_BLOCK, p.Hkv, p.B);
    const long long launch[6] = {grid.x, grid.y, grid.z, T_THREADS,
                                 (long long)kv_smem, 0};
    for (int i = 0; i < 6; ++i) g_bwd_kv_launch[i] = launch[i];
    packed_bwd_f32_kernel<D, SPANS><<<grid, T_THREADS, kv_smem, stream>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), p, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    constexpr size_t dq_smem = F32BwdTile<D>::dq_smem;
    err = allow_smem(packed_bwd_f32_dq_kernel<D, SPANS>, dq_smem, dq_set);
    if (err != cudaSuccess) return err;
    const dim3 dq_grid(p.H, (p.Sq + T_BLOCK - 1) / T_BLOCK, p.B);
    const long long dq_launch[5] = {dq_grid.x, dq_grid.y, dq_grid.z,
                                    T_THREADS, (long long)dq_smem};
    for (int i = 0; i < 5; ++i) g_bwd_dq_launch[i] = dq_launch[i];
    packed_bwd_f32_dq_kernel<D, SPANS>
        <<<dq_grid, T_THREADS, dq_smem, stream>>>(qf, kf, vf, df, lse, delta,
                                                  dq_acc, p, scale);
  } else {
    constexpr size_t smem = bwd_f32_smem<D>();
    err = cudaFuncSetAttribute(packed_bwd_f32_cc_kernel<D, SPANS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + BS_BK - 1) / BS_BK, p.Hkv, p.B);
    const long long launch[6] = {grid.x, grid.y, grid.z, BS_THREADS,
                                 (long long)smem, 0};
    for (int i = 0; i < 6; ++i) g_bwd_kv_launch[i] = launch[i];
    packed_bwd_f32_cc_kernel<D, SPANS><<<grid, BS_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), p,
        scale);
  }
  return cudaGetLastError();
}

Params make_params(int B, int Sq, int Sk, int H, int Hkv, int mode,
                   int window, int kv_offset, const void* segq,
                   const void* segk, const void* spanq, const void* spank,
                   void* sumq, void* sumk) {
  Params p;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hkv = Hkv;
  p.mode = mode;
  p.window = window;
  p.kv_offset = kv_offset;
  p.segq = static_cast<const int*>(segq);
  p.segk = static_cast<const int*>(segk);
  p.spanq = static_cast<const int*>(spanq);
  p.spank = static_cast<const int*>(spank);
  p.sumq = static_cast<const int4*>(sumq);
  p.sumk = static_cast<const int4*>(sumk);
  p.nsq = (Sq + SUM_T - 1) / SUM_T;
  p.nsk = (Sk + SUM_T - 1) / SUM_T;
  return p;
}

// head_dim 64, 128 and 160 (pixtral-12b) in fp32 and bf16; 256
// (recurrentgemma-2b) in bf16 only, the one type a config runs it in
bool bad_args(int B, int Sq, int Sk, int H, int Hkv, int D, int dtype,
              int mode, int window) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 ||
         H % Hkv != 0 || (dtype != 0 && dtype != 1) ||
         !(D == 64 || D == 128 || D == 160 || (D == 256 && dtype == 1)) ||
         mode < 0 ||
         mode > 2 || (mode == kSliding && window < 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. D: 64, 128 or 160, or 256 in
// bfloat16.
// mode: 0 full, 1 causal, 2 sliding.
// Tables are int32 [B, S]; spanq/spank are both null (no span table) or
// both set. sumq/sumk are int32 scratch of 4 * B * ceil(S/32) entries.
// o is q's type [B, Sq, H, D]; lse fp32 [B, H, Sq].
// Returns the cudaError_t of the launches (0 = cudaSuccess).
int k1_forward(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* segq, const void* segk,
               const void* spanq, const void* spank, void* sumq, void* sumk,
               int B, int Sq, int Sk, int H, int Hkv, int D, int dtype,
               int mode, int window, int kv_offset, void* stream) {
  if (bad_args(B, Sq, Sk, H, Hkv, D, dtype, mode, window) ||
      (spanq == nullptr) != (spank == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(B, Sq, Sk, H, Hkv, mode, window, kv_offset,
                               segq, segk, spanq, spank, sumq, sumk);
  cudaError_t err = summarize(p, static_cast<int4*>(sumq),
                              static_cast<int4*>(sumk), s);
  if (err != cudaSuccess) return (int)err;
  float* l = static_cast<float*>(lse);
  const bool spans = spanq != nullptr;
#define K1_FWD(T, DD)                                                     \
  return (int)(spans ? launch_fwd<T, DD, true>(q, k, v, o, l, p, s)       \
                     : launch_fwd<T, DD, false>(q, k, v, o, l, p, s))
  if (dtype == 0) {
    if (D == 64) K1_FWD(float, 64);
    if (D == 160) K1_FWD(float, 160);
    K1_FWD(float, 128);
  }
  if (dtype == 1) {
    if (D == 64) K1_FWD(bf16, 64);
    if (D == 160) K1_FWD(bf16, 160);
    if (D == 256) K1_FWD(bf16, 256);
    K1_FWD(bf16, 128);
  }
#undef K1_FWD
  return (int)cudaErrorInvalidValue;
}

// dq_acc: fp32 [B, Sq, H, D], zeroed by the caller (for fp32 inputs it
// is dq itself; at head_dim 64 the dQ kernel writes every row of it);
// delta: fp32 scratch [B, H, Sq]; dk/dv in k's type
// [B, Sk, Hkv, D], written in full. work: fp32 scratch [2, B, Sk, H, D]
// (the per-query-head dK and dV) for bfloat16 when H > Hkv, else unused
// and may be null.
int k1_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq_acc,
                void* dk, void* dv, void* work, const void* segq,
                const void* segk, const void* spanq, const void* spank,
                void* sumq, void* sumk, int B, int Sq, int Sk, int H,
                int Hkv, int D, int dtype, int mode, int window,
                int kv_offset, void* stream) {
  if (bad_args(B, Sq, Sk, H, Hkv, D, dtype, mode, window) ||
      (spanq == nullptr) != (spank == nullptr) ||
      (work == nullptr && dtype == 1 && H != Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = make_params(B, Sq, Sk, H, Hkv, mode, window, kv_offset,
                               segq, segk, spanq, spank, sumq, sumk);
  cudaError_t err = summarize(p, static_cast<int4*>(sumq),
                              static_cast<int4*>(sumk), s);
  if (err != cudaSuccess) return (int)err;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dqa = static_cast<float*>(dq_acc);
  float* w = static_cast<float*>(work);
  const bool spans = spanq != nullptr;
#define K1_BWD(T, DD)                                                      \
  return (int)(spans ? launch_bwd<T, DD, true>(q, k, v, o, dout, l, dl,    \
                                               dqa, dk, dv, w, p, s)       \
                     : launch_bwd<T, DD, false>(q, k, v, o, dout, l, dl,   \
                                                dqa, dk, dv, w, p, s))
  if (dtype == 0) {
    if (D == 64) K1_BWD(float, 64);
    if (D == 160) K1_BWD(float, 160);
    K1_BWD(float, 128);
  }
  if (dtype == 1) {
    if (D == 64) K1_BWD(bf16, 64);
    if (D == 160) K1_BWD(bf16, 160);
    if (D == 256) K1_BWD(bf16, 256);
    K1_BWD(bf16, 128);
  }
#undef K1_BWD
  return (int)cudaErrorInvalidValue;
}

// The last launch of the backward's key-side kernel (packed_bwd_kv_kernel
// in bfloat16; in float32 packed_bwd_f32_kernel, dK and dV, at head_dim
// 64, packed_bwd_f32_cc_kernel at 128 and 160), as launch_bwd made it:
// out[0..2] its grid, out[3] its threads per block, out[4] its dynamic
// shared memory in bytes, out[5] the bytes of `work` it addressed (0 when
// H == Hkv, and in float32). All 0 before the first such launch.
void k1_last_bwd_kv_launch(long long* out) {
  for (int i = 0; i < 6; ++i) out[i] = g_bwd_kv_launch[i];
}

// The last launch of packed_bwd_f32_dq_kernel (float32, head_dim 64: dQ),
// as launch_bwd made it: out[0..2] its grid, out[3] its threads per
// block, out[4] its dynamic shared memory in bytes. All 0 before the
// first such launch.
void k1_last_bwd_dq_launch(long long* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_bwd_dq_launch[i];
}

// The last launch of the forward kernel (packed_fwd_wg_kernel in
// bfloat16; in float32 packed_fwd_f32_kernel at head_dim 64,
// packed_fwd_f32_cc_kernel at 128 and 160), as
// launch_fwd made it: out[0..2] its grid, out[3] its threads per
// block, out[4] its dynamic shared memory in bytes. All 0 before the
// first such launch.
void k1_last_fwd_launch(long long* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_fwd_launch[i];
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
