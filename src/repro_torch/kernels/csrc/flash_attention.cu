// Flash attention forward for Hopper (sm_90a), plain C interface.
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
// tensor-core rate from S of about 700 on (the flops per byte grow
// with S). So the design keeps every intermediate (scores,
// probabilities, the running max and sum) on chip and reads each KV
// tile once per block of 64 query rows, and the bf16 path puts both
// products on the tensor cores:
//   * bf16: flash_fwd_tc_kernel, mma.sync m16n8k16 with fp32
//     accumulation (the Ampere-style instruction; Hopper's wgmma and TMA
//     are later work), 4 warps x 16 query rows, 64-key tiles.
//   * fp32: flash_fwd_f32_kernel, fp32 FMAs on the CUDA cores (the tensor
//     cores would round the inputs to TF32): two threads per query row,
//     each holding half of the row's scores and of its accumulator in
//     registers; K/V tiles of 32 rows staged in shared memory as fp32
//     (row stride D+1 so the per-row reads do not conflict on banks).
// Both keep the online softmax in fp32 and write the output in the
// input's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // key rows per KV tile
constexpr int NTHREADS = 128;  // two threads per query row

enum Mode { kFull = 0, kCausal = 1, kSliding = 2 };

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

// ---------------------------------------------------------------------
// fp32 path on the CUDA cores.
// ---------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Sk, int H, int Hkv, int mode, int window,
                     int kv_offset, float scale) {
  constexpr int QS = D + 1;   // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;  // padded row stride of the P tile
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* Ks = Qs + BQ * QS;    // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 1;      // query row within the tile
  const int half = tid & 1;    // this thread's interleaved half
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  const int64_t q_stride = (int64_t)H * D;     // between positions
  const int64_t kv_stride = (int64_t)Hkv * D;
  const float* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  float* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    const int qp = q0 + rr;
    Qs[rr * QS + d] = qp < Sq ? qb[(int64_t)qp * q_stride + d] : 0.f;
  }

  // Key indices j in [j_lo, j_hi) can be valid for some row of this
  // tile; tiles outside are never loaded.
  const int q_last = min(q0 + BQ, Sq) - 1;
  int j_lo = 0, j_hi = Sk;
  if (mode != kFull) {
    j_hi = min(Sk, q_last - kv_offset + 1);
    if (mode == kSliding) j_lo = max(0, q0 - window - kv_offset + 1);
  }
  j_lo = (j_lo / BK) * BK;

  const int qpos = q0 + r;
  float m = -INFINITY;   // running row max over valid scores
  float l = 0.f;         // running row sum of exp(s - m)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j0 = j_lo; j0 < j_hi; j0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q is staged
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const int kp = j0 + c;
      const bool in = kp < Sk;
      Ks[c * QS + d] = in ? kb[(int64_t)kp * kv_stride + d] : 0.f;
      Vs[c * D + d] = in ? vb[(int64_t)kp * kv_stride + d] : 0.f;
    }
    __syncthreads();

    // scores of this thread's columns c = half + 2*jj
    float s[BK / 2];
    float row_max = -INFINITY;
    const float* qr = Qs + r * QS;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int c = half + 2 * jj;
      const int j = j0 + c;
      const int kpos = kv_offset + j;
      bool ok = j < Sk;
      if (mode != kFull) {
        ok = ok && kpos <= qpos;
        if (mode == kSliding) ok = ok && kpos > qpos - window;
      }
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
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    const float m_new = fmaxf(m, row_max);

    float corr = 1.f, psum = 0.f;
    float* pr = Ps + r * PS;
    if (m_new == -INFINITY) {
      // nothing valid for this row yet: contributes nothing
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) pr[half + 2 * jj] = 0.f;
    } else {
      corr = expf(m - m_new);  // m = -inf gives 0
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) {
        const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_new);
        psum += p;
        pr[half + 2 * jj] = p;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // both threads of a row live in one warp

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * D + half;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
    }
  }

  if (qpos < Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = ob + (int64_t)qpos * q_stride + half;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[2 * i] = acc[i] * inv;
  }
}

// ---------------------------------------------------------------------
// bf16 path on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
// One block per (64 query rows, head, batch): four warps, each owning
// 16 query rows whose Q fragments stay in registers for the whole KV
// loop. Per 64-key tile: S = Q K^T by mma from K staged [key][d] in
// shared memory; the online softmax runs on the S accumulators in
// registers (a row's entries are spread over the 4 threads of a quad);
// P is rounded to bf16 and re-used as the A operand of O += P V, with
// V staged transposed ([d][key]) so each B fragment is one 32-bit load.
// ---------------------------------------------------------------------
constexpr int TC_BQ = 64;        // 4 warps x 16 query rows
constexpr int TC_BK = 64;        // keys per KV tile
constexpr int TC_THREADS = 128;

template <int D>
struct TcTile {
  static constexpr int QP = D + 8;       // bf16 pitch of Q and K rows
  static constexpr int VP = TC_BK + 8;   // bf16 pitch of V^T rows
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (TC_BQ * QP + TC_BK * QP + D * VP);
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
        "r"(b[1]));
}

// two floats -> one register of two bf16, the lower index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                    int Hkv, int mode, int window, int kv_offset,
                    float scale) {
  using Tile = TcTile<D>;
  constexpr int QP = Tile::QP, VP = Tile::VP;
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int NT = TC_BK / 8;      // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + TC_BQ * QP;   // [TC_BK][QP]
  __nv_bfloat16* Vt = Ks + TC_BK * QP;   // [D][VP], V transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int q0 = blockIdx.x * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  const int64_t q_stride = (int64_t)H * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const __nv_bfloat16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const __nv_bfloat16* kb =
      k + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  const __nv_bfloat16* vb =
      v + (int64_t)b * Sk * kv_stride + (int64_t)hk * D;
  __nv_bfloat16* ob = o + (int64_t)b * Sq * q_stride + (int64_t)h * D;

  for (int i = tid; i < TC_BQ * CH; i += TC_THREADS) {
    const int rr = i / CH, c = i % CH;
    const int qp = q0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qp < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (int64_t)qp * q_stride +
                                            c * 8);
    *reinterpret_cast<uint4*>(Qs + rr * QP + c * 8) = val;
  }
  __syncthreads();

  const int r_lo = warp * 16 + g;          // this thread's rows: r_lo, +8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Qs + r_lo * QP + kk * 16 + t * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * QP);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * QP + 8);
  }

  const int q_last = min(q0 + TC_BQ, Sq) - 1;
  int j_lo = 0, j_hi = Sk;
  if (mode != kFull) {
    j_hi = min(Sk, q_last - kv_offset + 1);
    if (mode == kSliding) j_lo = max(0, q0 - window - kv_offset + 1);
  }
  j_lo = (j_lo / TC_BK) * TC_BK;

  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int j0 = j_lo; j0 < j_hi; j0 += TC_BK) {
    __syncthreads();  // every warp is done with the previous tile
    // key c = i % TC_BK: a warp's transposed V stores hit distinct banks
    for (int i = tid; i < TC_BK * CH; i += TC_THREADS) {
      const int c = i % TC_BK, ch = i / TC_BK;
      const int kp = j0 + c;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kp < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)kp * kv_stride +
                                             ch * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)kp * kv_stride +
                                             ch * 8);
      }
      *reinterpret_cast<uint4*>(Ks + c * QP + ch * 8) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(ch * 8 + e) * VP + c] = ve[e];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = Ks + (n * 8 + g) * QP + kk * 16 + t * 2;
        const uint32_t bfrag[2] = {ld32(p), ld32(p + 8)};
        mma_bf16(s[n], qf[kk], bfrag);
      }
    }

    // mask (exact 0 weight for a masked pair), scale, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qpos[e >> 1];
        const int j = j0 + n * 8 + t * 2 + (e & 1);
        const int kpos = kv_offset + j;
        bool ok = j < Sk;
        if (mode != kFull) {
          ok = ok && kpos <= row;
          if (mode == kSliding) ok = ok && kpos > row - window;
        }
        const float val = ok ? s[n][e] * scale : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = m[i] == -INFINITY ? 0.f : __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[n][e] == -INFINITY ? 0.f : __expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * corr[i] + psum[i];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* p = Vt + (nd * 8 + g) * VP + kk * 16 + t * 2;
        const uint32_t bfrag[2] = {ld32(p), ld32(p + 8)};
        mma_bf16(acc[nd], a, bfrag);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = ob + (int64_t)qpos[i] * q_stride + t * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16(acc[nd][2 * i] * inv, acc[nd][2 * i + 1] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int mode,
                   int window, int kv_offset, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = TcTile<D>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
    flash_fwd_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, mode,
        window, kv_offset, scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    flash_fwd_f32_kernel<D><<<grid, NTHREADS, smem, stream>>>(
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
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, Hkv,
                                        mode, window, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
