// Flash attention forward (kernel K2) for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_flat
// (Pallas body `_kernel`) together with its model-layout wrapper
// src/repro/kernels/ops.py :: flash_attention. Same function: causal /
// full / sliding(window) attention over key positions shifted by
// `kv_offset`, softmax in fp32, output in the input's type.
//
// Differences from the TPU kernel, by design:
//   * Model layout in and out: q/o [B, Sq, H, D], k/v [B, Sk, Hkv, D].
//     KV head h / (H / Hkv) is read in place, so the KV repeat of
//     ops.py (_expand_gqa) and the [BH, S, D] transposes never happen.
//   * A masked score contributes exactly 0 (p = 0, not exp(-1e30 - m)),
//     and a row with no valid key returns zeros. The TPU kernel's -1e30
//     trick gives a masked-but-visited row exp(0) = 1 per entry.
//   * Future and out-of-window KV tiles are skipped by the loop bounds,
//     not visited and masked.
//
// What bounds it on the H100: at the serving path's shapes (S <= 2048,
// D = 128) the least time is set by the bytes at short prompts (q, k, v
// and o cross HBM once: some 30 flops per byte at S = 64) and by the
// tensor-core rate from S of about 700 on (4*D flops per valid pair per
// query head grow with S). So every intermediate (scores,
// probabilities, the running max and sum) stays on chip, each K/V tile
// is read once per block of 128 query rows, and the bf16 path is built
// for Hopper's tensor cores:
//   * bf16: flash_fwd_wg_kernel, D = 32, 64, 128 and 160.
//     1. Grid. A block is two warpgroups (256 threads) over 128 query
//        rows of one (query head, batch), 64 rows each; the grid is
//        (H, ceil(Sq / 128), B), and y is issued in reverse, so the last
//        query tiles, the heaviest under causal order, start first.
//     2. Products. Both by warpgroup MMA (wgmma, sm_90a) with fp32
//        accumulation: S = Q K^T from 128-byte-swizzled shared memory,
//        O += P V with P from registers (rounded to bf16) and V read
//        N-major from its row-major tile: no transposed copy of V.
//     3. Loads. 64-key K/V tiles arrive by cp.async in a two-stage ring
//        in the swizzled layout wgmma reads: the next tile lands while
//        this one is formed.
//     4. Live keys by arithmetic: the block visits the key tiles its
//        rows can see (causal: up to its last row; sliding: from the
//        first row's window on), and a warpgroup skips a tile none of
//        its own 64 rows can see.
//     5. Masks. A tile wholly valid for the warpgroup's 64 rows (full
//        mode; causal at or before its first row; sliding also within
//        its last row's window) skips the pair mask.
//     6. Online softmax in fp32, in log2 units (ex2.approx).
//     7. Two blocks an SM (97 KB of shared memory at D = 128, at most
//        128 registers a thread: 32 bytes spill at D = 128); one at D =
//        160 (145 KB; O's share alone is 96 fp32 registers a thread).
//     What still holds it back at 4 x 2048 (3x its bound): each
//     warpgroup waits on its own products and softmax in turn; only the
//     SM's other warpgroups fill the tensor cores meanwhile.
//     D = 32 (no main path) runs as D = 64 with Q's, K's and V's upper
//     32 columns zero-filled in shared memory: exact, at twice the
//     products. D = 160 (pixtral-12b: 5120 / 32 heads) runs the same
//     way as DP = 192, three 64-column blocks, the third half used:
//     S = Q K^T over all 192 columns (the zeros add nothing, 1.2x the
//     products), O += P V as m64n128 over blocks 0-1 and m64n64 over
//     block 2, whose upper 32 columns are formed and never written.
//     HBM traffic stays at 160 columns; the scale stays 1/sqrt(160).
//   * fp32: flash_fwd_f32_kernel, D = 32, 64 and 128, split TF32 on the
//     tensor cores. What bounds it at whisper-small's encoder (1 x 1500,
//     full, 12:12 heads of 64): 6.91 GFLOP, 0.103 ms at the fp32
//     CUDA-core peak (67 TFLOP/s) and 0.0419 ms as three TF32 products
//     at 495 TFLOP/s; its 1.9 MB of bytes take 0.0006 ms. Plain TF32
//     keeps some three decimal digits and misses the 1e-4 limit (2e-4
//     to 4e-4 at that shape), so each fp32 operand x is carried as hi =
//     tf32(x) and lo = tf32(x - hi), and each product is formed as
//     hi hi' + hi lo' + lo hi' (lo lo' lies below fp32's precision).
//     1. Grid. A block is one warpgroup (128 threads) over 64 query rows
//        of one (query head, batch); the grid is (H, ceil(Sq / 64), B),
//        y issued in reverse as above. Two blocks an SM at D <= 64.
//     2. Products. Both by wgmma m64nNk8 in TF32, A from registers, fp32
//        sums: S = Q K^T with Q's hi and lo split once a block into
//        registers; O += P V with P split in registers. tf32 wgmma reads
//        only K-major operands from shared memory, so V is stored
//        transposed, [D][keys], its keys permuted within each group of
//        8 so that S's accumulator is P's A operand as it lies (key 2i
//        at position i, key 2i + 1 at position i + 4): P never leaves
//        the registers.
//     3. Split once. Each K/V tile is split once a block by the threads
//        that stage it: K's hi in place of the landed tile, its lo
//        beside it; V's hi and lo transposed into tiles of their own.
//     4. Loads. 64-key tiles arrive by 16-byte cp.async in the 128-byte
//        swizzle, K into a two-stage ring, V into one landing tile that
//        is free once split: the next tile lands while this one is
//        formed. Six [64][D] fp32 tiles of shared memory (97 KB at D =
//        64, 255 registers a thread and no spill; 193 KB at D = 128, one
//        block an SM, 148 bytes spilled and its products serialized).
//     5. Live keys, masks and the online softmax as the bf16 kernel's
//        steps 4-6, over the block's 64 rows.
//     What still holds it back (H100 SXM at 700 W, 1 x 1500: 0.205 ms,
//     4.9x its split-TF32 bound, under SDPA's fp32 0.29): every block
//     splits each K/V tile it walks again, 24 blocks a head, and the
//     split passes take some 38% (0.128 ms without them); 288 blocks
//     fill 264 slots and leave a tail of 24; at the cross shapes (1 to
//     448 query rows, 12 to 84 blocks) each block walks all 24 tiles,
//     so 1 x 1 and 1 x 448 both take 0.086 ms.
//     Q's split stays in registers across the key loop. One edited build
//     (P V from P's hi alone, nvcc 12.9) gave P's A operands registers
//     that held Q's lo and never reloaded them: hold any edit of the
//     products against the plain version over more than one key tile.
// Both keep the online softmax in fp32 and write the output in the
// input's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum Mode { kFull = 0, kCausal = 1, kSliding = 2 };

// ---------------------------------------------------------------------
// bf16 path on the tensor cores, designed for the H100 (the source note
// says what bounds it and what the design does about it). A block is
// two warpgroups over W_BQ query rows of one query head, 64 rows each;
// both share each K/V tile of a ring of W_STAGES.
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int W_BQ = 128, W_BK = 64, W_THREADS = 256;
constexpr int W_STAGES = 2;  // K/V tiles: one in use, one landing

// Per-head-dim traits of flash_fwd_wg_kernel: tiles of whole 64-column
// blocks (D = 32 as one, D = 160 as three, the upper columns zeros), and
// the blocks an SM their shared memory and O's registers allow
template <int D>
struct WgTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int TB = 64 * DP * 2;      // bytes of one [64][DP] tile
  static constexpr int MIN_BLOCKS = DP <= 128 ? 2 : 1;
  // Q of both warpgroups, the ring's K and V, and room to align the
  // tiles to 1024 bytes
  static constexpr size_t smem = 1024 + 2 * TB + W_STAGES * 2 * TB;
};

template <int D>
__global__ void __launch_bounds__(W_THREADS, WgTile<D>::MIN_BLOCKS)
flash_fwd_wg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int Sq, int Sk, int H, int Hkv, int mode, int window,
                    int kv_offset, float scale) {
  constexpr int DP = WgTile<D>::DP, TB = WgTile<D>::TB;
  constexpr int CH = D / 8, CHP = DP / 8, NK = W_BK / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Qs = sm;             // [2][64][DP], one tile a warpgroup
  unsigned char* ring = Qs + 2 * TB;  // W_STAGES x K, V [64][DP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // blocks are issued y by y: the last query tiles, the heaviest under
  // causal order, first
  const int q0 = ((Sq + W_BQ - 1) / W_BQ - 1 - (int)blockIdx.y) * W_BQ;
  const int q1 = min(q0 + W_BQ, Sq);
  const int r0 = q0 + 64 * wg;  // the warpgroup's first row
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const bf16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const bf16* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const bf16* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;

  // Q, 64 rows a warpgroup; rows past Sq and columns past D read as
  // zeros (the rows are never written)
  for (int i = tid; i < W_BQ * CHP; i += W_THREADS) {
    const int r = i / CHP, c = i % CHP, qp = q0 + r;
    cp_async16(Qs + (r / 64) * TB + sw128<64>(r % 64, c),
               qb + (int64_t)(qp < Sq ? qp : q0) * q_stride +
                   (c < CH ? c : 0) * 8,
               qp < Sq && c < CH);
  }
  cp_async_commit();

  // key tile j into ring stage st, K and V in the swizzled layout wgmma
  // reads; keys past Sk and columns past D read as zeros
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
    cp_async_commit();
  };

  // the key tiles some row of the block sees: [j_lo / W_BK, jt_hi)
  int j_lo = 0, j_hi = Sk;
  if (mode != kFull) {
    j_hi = max(0, min(Sk, q1 - kv_offset));
    if (mode == kSliding) j_lo = max(0, q0 - window - kv_offset + 1);
  }
  const int jt_hi = (j_hi + W_BK - 1) / W_BK;
  // the warpgroup's rows [r0, w1): `mine` (tile j holds a key one of
  // them sees) and `whole` (every key of tile j is valid for all 64 of
  // them: no pair mask); both uniform across the warpgroup
  const int w1 = min(r0 + 64, Sq);
  auto mine = [&](int j) {
    const int kp0 = kv_offset + j * W_BK;
    return r0 < Sq &&
           (mode == kFull ||
            (kp0 <= w1 - 1 &&
             (mode != kSliding || kp0 + W_BK - 1 > r0 - window)));
  };
  auto whole = [&](int j) {
    const int kp0 = kv_offset + j * W_BK;
    return (j + 1) * W_BK <= Sk &&
           (mode == kFull ||
            (kp0 + W_BK - 1 <= r0 &&
             (mode != kSliding || kp0 > r0 + 63 - window)));
  };

  // the thread's two rows: qrow and qrow + 8
  const int qrow = r0 + (warp & 3) * 16 + g;
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  const uint32_t qa = smem_u32(Qs + wg * TB);

  int j = j_lo / W_BK, st = 0;
  if (j < jt_hi) load_kv(j, 0);
  for (; j < jt_hi; ++j, st ^= 1) {
    cp_async_wait<0>();   // tile j (the first time, Q too) has landed
    fence_proxy_async();  // the copies are seen by wgmma's reads
    __syncthreads();      // every warp is done with the other stage
    if (j + 1 < jt_hi) load_kv(j + 1, st ^ 1);  // lands while j is formed
    if (!mine(j)) continue;
    const uint32_t ka = smem_u32(ring + st * 2 * TB), va = ka + TB;

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

    float mx[2] = {-INFINITY, -INFINITY};
    if (whole(j)) {
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
          const int row = qrow + 8 * (e >> 1);
          const int kj = j * W_BK + n * 8 + t * 2 + (e & 1);
          const int kpos = kv_offset + kj;
          bool ok = kj < Sk;
          if (mode != kFull) {
            ok = ok && kpos <= row;
            if (mode == kSliding) ok = ok && kpos > row - window;
          }
          s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
    // from its row-major tile, 16 keys a step; at D = 160 the third
    // 64-wide block of V as its own m64n64 product
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
      if constexpr (DP == 64) {
        wgmma_rs_n64<1>(&acc[0][0], a[kk], dsc);
      } else {
        wgmma_rs_n128<1>(&acc[0][0], a[kk], dsc);
      }
      if constexpr (DP == 192) {
        const uint32_t v3 = va + 2 * SW_BLOCK + kk * 2048;
        wgmma_rs_n64<1>(&acc[16][0], a[kk], wg_desc(v3, SW_BLOCK, SW_GROUP));
      }
    }
    wgmma_commit();
    wgmma_wait0();
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
  }
}

// ---------------------------------------------------------------------
// fp32 path: split TF32 on the tensor cores (the source note says what
// bounds it and what the design does about it). A block is one
// warpgroup over F_BQ query rows of one query head; K/V tiles of F_BK
// keys.
// ---------------------------------------------------------------------
constexpr int F_BQ = 64, F_BK = 64, F_THREADS = 128;

// Shared memory of flash_fwd_f32_kernel<D>, and the blocks an SM it is
// built for
template <int D>
struct F32Tile {
  static constexpr int TB = F_BK * D * 4;  // bytes of one [64][D] tile
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  // K's two ring stages (as landed, then its hi in place), V as landed,
  // K's lo, V^T's hi and lo, and room to align the tiles to 1024 bytes
  static constexpr size_t smem = 1024 + 6 * TB;
};

template <int D>
__global__ void __launch_bounds__(F_THREADS, F32Tile<D>::MIN_BLOCKS)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Sk, int H, int Hkv, int mode, int window,
                     int kv_offset, float scale) {
  constexpr int TB = F32Tile<D>::TB;
  constexpr int CH = D / 4;       // 16-byte chunks of a row of K or V
  constexpr int KD = D / 8;       // k-steps of S = Q K^T, and O's groups
  constexpr int NK = F_BK / 8;    // k-steps of O += P V, and S's groups
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* Kring = sm;        // 2 stages of K [64][D]
  unsigned char* Vin = sm + 2 * TB; // V [64][D] as it lands
  unsigned char* Klo = sm + 3 * TB; // K's lo [64][D]
  unsigned char* Vhi = sm + 4 * TB; // V^T's hi [D][64], keys permuted
  unsigned char* Vlo = sm + 5 * TB; // V^T's lo

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, hk = h / (H / Hkv), b = blockIdx.z;
  const int q0 = ((Sq + F_BQ - 1) / F_BQ - 1 - (int)blockIdx.y) * F_BQ;
  const int q1 = min(q0 + F_BQ, Sq);
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;

  // key tile j of `src` into `dst` in the 128-byte swizzle; keys past Sk
  // read as zeros
  auto load = [&](const float* src, unsigned char* dst, int j) {
    const int j0 = j * F_BK;
    for (int i = tid; i < F_BK * CH; i += F_THREADS) {
      const int r = i / CH, c = i % CH, kp = j0 + r;
      cp_async16(dst + sw128<F_BK>(r, c),
                 src + (int64_t)(kp < Sk ? kp : j0) * kv_stride + c * 4,
                 kp < Sk);
    }
    cp_async_commit();
  };

  // x's lo beside its hi = tf32(x): x - hi rounded to TF32; hi + lo
  // carries x to some 2^-22 of itself
  auto lo_of = [&](float x, uint32_t hi) {
    return tf32(x - __uint_as_float(hi));
  };

  // the thread's two rows, qrow and qrow + 8, and Q's A operands for
  // the D / 8 k-steps of S, split once; rows past Sq read as zeros (they
  // are never written)
  const int qrow = q0 + warp * 16 + g;
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

  // the key tiles some row of the block sees: [j_lo / F_BK, jt_hi)
  int j_lo = 0, j_hi = Sk;
  if (mode != kFull) {
    j_hi = max(0, min(Sk, q1 - kv_offset));
    if (mode == kSliding) j_lo = max(0, q0 - window - kv_offset + 1);
  }
  const int jt_hi = (j_hi + F_BK - 1) / F_BK;
  // every key of tile j is valid for all 64 rows: no pair mask
  auto unmasked = [&](int j) {
    const int kp0 = kv_offset + j * F_BK;
    return (j + 1) * F_BK <= Sk &&
           (mode == kFull ||
            (kp0 + F_BK - 1 <= q0 &&
             (mode != kSliding || kp0 > q0 + F_BQ - 1 - window)));
  };

  const float sl2 = 1.4426950408889634f * scale;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  int j = j_lo / F_BK, ks = 0;  // ks: tile j's stage of the K ring
  if (j < jt_hi) {
    load(kb, Kring, j);
    load(vb, Vin, j);
  }
  for (; j < jt_hi; ++j, ks ^= 1) {
    cp_async_wait<0>();  // tile j's K and V have landed
    __syncthreads();     // and every warp is done with tile j - 1
    unsigned char* Ks = Kring + ks * TB;
    if (j + 1 < jt_hi) load(kb, Kring + (ks ^ 1) * TB, j + 1);

    // split K: hi in place, lo beside it, in the same swizzled layout
    for (int i = tid; i < F_BK * CH; i += F_THREADS) {
      const uint32_t off = sw128<F_BK>(i / CH, i % CH);
      const float4 x = *reinterpret_cast<const float4*>(Ks + off);
      const uint4 hi = make_uint4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
      *reinterpret_cast<uint4*>(Klo + off) =
          make_uint4(lo_of(x.x, hi.x), lo_of(x.y, hi.y), lo_of(x.z, hi.z),
                     lo_of(x.w, hi.w));
      *reinterpret_cast<uint4*>(Ks + off) = hi;
    }
    // split V transposed: key r of the tile to position kap of row d of
    // V^T (a warp's 32 keys to one row, no bank conflict)
    for (int i = tid; i < F_BK * CH; i += F_THREADS) {
      const int r = i % F_BK, c = i / F_BK, w = r & 7;
      const int kap = (r & ~7) + ((w & 1) ? 4 + (w >> 1) : (w >> 1));
      const float4 x =
          *reinterpret_cast<const float4*>(Vin + sw128<F_BK>(r, c));
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = sw128<D>(4 * c + e, kap >> 2) + (kap & 3) * 4;
        const uint32_t xh = tf32(xs[e]);
        *reinterpret_cast<uint32_t*>(Vhi + off) = xh;
        *reinterpret_cast<uint32_t*>(Vlo + off) = lo_of(xs[e], xh);
      }
    }
    fence_proxy_async();  // the split tiles are seen by wgmma's reads
    __syncthreads();
    if (j + 1 < jt_hi) load(vb, Vin, j + 1);  // V's landing tile is free

    // S = Q K^T: 64 rows x 64 keys, the small products first
    const uint32_t ka = smem_u32(Ks), kl = smem_u32(Klo);
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
      wgmma_tf32<F_BK>(&s[0][0], ql[kk], wg_desc(ka + off, 16, SW_GROUP));
      wgmma_tf32<F_BK>(&s[0][0], qh[kk], wg_desc(kl + off, 16, SW_GROUP));
      wgmma_tf32<F_BK>(&s[0][0], qh[kk], wg_desc(ka + off, 16, SW_GROUP));
    }
    wgmma_commit();
    wgmma_wait0();
    pin(s);

    float mx[2] = {-INFINITY, -INFINITY};
    if (unmasked(j)) {
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
          const int row = qrow + 8 * (e >> 1);
          const int kj = j * F_BK + n * 8 + t * 2 + (e & 1);
          const int kpos = kv_offset + kj;
          bool ok = kj < Sk;
          if (mode != kFull) {
            ok = ok && kpos <= row;
            if (mode == kSliding) ok = ok && kpos > row - window;
          }
          s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    }
    // online softmax; a row with no valid key so far keeps m = -inf and
    // subtracts 0, so its probabilities are exactly 0
    float corr[2], m0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m0[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = ex2(m[i] - m0[i]);
      m[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - m0[e >> 1]);
        psum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];

    // O += P V: P's A operand of k-step kk is S's group kk as it lies
    // (the keys of V^T are permuted to match), split in registers
    uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const float p[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[kk][e] = tf32(p[e]);
        pl[kk][e] = lo_of(p[e], ph[kk][e]);
      }
    }
    const uint32_t vh = smem_u32(Vhi), vl = smem_u32(Vlo);
    pin(ph);
    pin(pl);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t off = (kk >> 2) * (D * 128) + (kk & 3) * 32;
      wgmma_tf32<D>(&acc[0][0], pl[kk], wg_desc(vh + off, 16, SW_GROUP));
      wgmma_tf32<D>(&acc[0][0], ph[kk], wg_desc(vl + off, 16, SW_GROUP));
      wgmma_tf32<D>(&acc[0][0], ph[kk], wg_desc(vh + off, 16, SW_GROUP));
    }
    wgmma_commit();
    wgmma_wait0();
    pin(acc);
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
  }
}

// grid x, y, z, threads and shared memory of the last launch of either
// kernel (k2_last_launch reads them)
static long long g_launch[5] = {0, 0, 0, 0, 0};

static void record_launch(dim3 grid, int threads, size_t smem) {
  const long long rec[5] = {grid.x, grid.y, grid.z, threads,
                            (long long)smem};
  for (int i = 0; i < 5; ++i) g_launch[i] = rec[i];
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int mode,
                   int window, int kv_offset, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  static bool smem_set[MAX_DEVICES];  // one set a template instance
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = WgTile<D>::smem;
    cudaError_t err = allow_smem(flash_fwd_wg_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, (Sq + W_BQ - 1) / W_BQ, B);
    record_launch(grid, W_THREADS, smem);
    flash_fwd_wg_kernel<D><<<grid, W_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, mode,
        window, kv_offset, scale);
  } else {
    constexpr size_t smem = F32Tile<D>::smem;
    cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, (Sq + F_BQ - 1) / F_BQ, B);
    record_launch(grid, F_THREADS, smem);
    flash_fwd_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, mode,
        window, kv_offset, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int Sq, int Sk, int H, int Hkv,
                     int mode, int window, int kv_offset,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, mode, window,
                           kv_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, mode, window,
                           kv_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, mode, window,
                            kv_offset, stream);
    case 160:  // pixtral-12b, bfloat16 only
      if constexpr (std::is_same<T, bf16>::value)
        return launch<T, 160>(q, k, v, o, B, Sq, Sk, H, Hkv, mode, window,
                              kv_offset, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. mode: 0 full, 1 causal, 2 sliding.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Sk, int H, int Hkv,
                        int D, int dtype, int mode, int window,
                        int kv_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, Hkv, mode,
                                window, kv_offset, s);
  if (dtype == 1)
    return (int)launch_d<bf16>(D, q, k, v, o, B, Sq, Sk, H, Hkv, mode,
                               window, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}

// The last launch of either kernel (flash_fwd_wg_kernel for bfloat16,
// flash_fwd_f32_kernel for float32), as launch made it: out[0..2] its
// grid, out[3] its threads per block, out[4] its dynamic shared memory
// in bytes. All 0 before the first launch.
void k2_last_launch(long long* out) {
  for (int i = 0; i < 5; ++i) out[i] = g_launch[i];
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
