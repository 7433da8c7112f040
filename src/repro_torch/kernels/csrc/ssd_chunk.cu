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
// is the gradient of that function; see k3_bwd below.
//
// Layouts (model layout, no copies): C and B are [Bsz, S, N] with a token
// stride `ld_cb` (one B/C group shared by every head, as Mamba-2 has it:
// the TPU path broadcast them to all heads first); x is [Bsz, S, H, P]
// with a token stride `ld_x` and heads contiguous; da, dt, cum are fp32
// [Bsz, S, H]; y is fp32 [Bsz, S, H, P]; states fp32 [Bsz, nc, H, N, P];
// dx is contiguous [Bsz, S, H, P] in x's type.
// C, B and x are fp32 or bf16 and are upcast as they are loaded: all
// arithmetic is fp32 on the CUDA cores (TF32 would miss the 1e-4 limit).
//
// What bounds it: at mamba2-370m's c=256, N=128, P=64 a cell does some
// 16.8 MFLOP on 0.1 MB of inputs, far above the card's ridge, so fp32
// operations bound it. The TPU kernel holds a whole cell ([c,N] C and B,
// [c,P] x, the [c,c] scores: 0.4 MB) in VMEM; an SM has 227 KB. So one
// block per cell walks 32-row tiles: for each row tile i only the key
// tiles j <= i are visited (the causal skip), each C B^T tile is built
// over the full N from shared memory, and states take their own pass.
// exp(cum_i - cum_j) is formed only where i >= j: above the diagonal it
// overflows at c=256 (the sum of dt there is about 190), and inf * 0
// would poison the backward.
//
// Each thread owns a (rows / 16) x (cols / 16) register tile of every
// product (rows ty + 16a, cols tx + 16b); shared tiles are row-major with
// an odd row stride, so that reads along either index hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;     // rows of a tile (and cols of a score tile)
constexpr int NT = 256;   // threads per block
constexpr int TX = 16;    // thread grid 16 x 16 over every product
constexpr int TY = 16;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x cols from global (row stride ldg) into shared (row stride
// cols + 1), upcast to fp32
template <typename In>
__device__ __forceinline__ void load_tile(float* s, const In* g, long ldg,
                                          int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += NT) {
    const int r = idx / cols, c = idx - r * cols;
    s[r * (cols + 1) + c] = ldf(g + r * ldg + c);
  }
}

// acc[a][b] += sum_k A(ty + 16a, k) * B(k, tx + 16b) for k < K
template <int RM, int RN, typename FA, typename FB>
__device__ __forceinline__ void mac(float (&acc)[RM][RN], int K, FA A,
                                    FB B) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int a = 0; a < RM; ++a) av[a] = A(ty + TY * a, k);
#pragma unroll
    for (int b = 0; b < RN; ++b) bv[b] = B(k, tx + TX * b);
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < RN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.f;
}

struct Cell {
  long tok0;  // first token of the chunk, over Bsz * S
  long bk;    // b * nc + k
  int h;
};

__device__ __forceinline__ Cell cell_of(int S, int H, int c) {
  const int nc = S / c;
  const long cell = blockIdx.x;
  Cell r;
  r.h = (int)(cell % H);
  r.bk = cell / H;
  const long b = r.bk / nc, k = r.bk % nc;
  r.tok0 = b * S + k * c;
  return r;
}

// ------------------------------------------------------------------ forward
template <typename In, int N, int P>
__global__ void __launch_bounds__(NT)
    k3_fwd(const In* __restrict__ C, const In* __restrict__ B,
           const In* __restrict__ x, const float* __restrict__ da,
           const float* __restrict__ dt, float* __restrict__ y,
           float* __restrict__ states, float* __restrict__ cum_out, int S,
           int H, int c, long ld_cb, long ld_x) {
  extern __shared__ float sm[];
  const Cell cl = cell_of(S, H, c);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  float* s_cum = sm;                 // c
  float* s_dt = s_cum + c;           // c
  float* s_w = s_dt + c;             // c: exp(cum_end - cum) * dt
  float* s_C = s_w + c;              // T x (N+1)
  float* s_B = s_C + T * (N + 1);    // T x (N+1)
  float* s_X = s_B + T * (N + 1);    // T x (P+1)
  float* s_S = s_X + T * (P + 1);    // T x (T+1)

  for (int t = tid; t < c; t += NT) {
    s_cum[t] = da[(cl.tok0 + t) * H + cl.h];
    s_dt[t] = dt[(cl.tok0 + t) * H + cl.h];
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < c; ++t) {
      acc += s_cum[t];
      s_cum[t] = acc;
    }
  }
  __syncthreads();
  const float cend = s_cum[c - 1];
  for (int t = tid; t < c; t += NT) {
    s_w[t] = expf(cend - s_cum[t]) * s_dt[t];
    cum_out[(cl.tok0 + t) * H + cl.h] = s_cum[t];
  }
  const In* Cg = C + cl.tok0 * ld_cb;
  const In* Bg = B + cl.tok0 * ld_cb;
  const In* Xg = x + cl.tok0 * ld_x + (long)cl.h * P;
  const long ldy = (long)H * P;
  float* Yg = y + cl.tok0 * ldy + (long)cl.h * P;

  for (int i0 = 0; i0 < c; i0 += T) {
    load_tile(s_C, Cg + i0 * ld_cb, ld_cb, T, N);
    float acc[T / TY][P / TX];
    zero(acc);
    for (int j0 = 0; j0 <= i0; j0 += T) {
      load_tile(s_B, Bg + j0 * ld_cb, ld_cb, T, N);
      load_tile(s_X, Xg + j0 * ld_x, ld_x, T, P);
      __syncthreads();
      float cb[T / TY][T / TX];
      zero(cb);
      mac(cb, N, [&](int i, int n) { return s_C[i * (N + 1) + n]; },
          [&](int n, int j) { return s_B[j * (N + 1) + n]; });
#pragma unroll
      for (int a = 0; a < T / TY; ++a)
#pragma unroll
        for (int b = 0; b < T / TX; ++b) {
          const int i = ty + TY * a, j = tx + TX * b;
          const int gi = i0 + i, gj = j0 + j;
          s_S[i * (T + 1) + j] =
              gi >= gj ? cb[a][b] * expf(s_cum[gi] - s_cum[gj]) * s_dt[gj]
                       : 0.f;
        }
      __syncthreads();
      mac(acc, T, [&](int i, int j) { return s_S[i * (T + 1) + j]; },
          [&](int j, int p) { return s_X[j * (P + 1) + p]; });
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < T / TY; ++a)
#pragma unroll
      for (int b = 0; b < P / TX; ++b)
        Yg[(long)(i0 + ty + TY * a) * ldy + tx + TX * b] = acc[a][b];
  }

  float st[N / TY][P / TX];
  zero(st);
  for (int j0 = 0; j0 < c; j0 += T) {
    load_tile(s_B, Bg + j0 * ld_cb, ld_cb, T, N);
    load_tile(s_X, Xg + j0 * ld_x, ld_x, T, P);
    __syncthreads();
    mac(st, T,
        [&](int n, int j) { return s_B[j * (N + 1) + n] * s_w[j0 + j]; },
        [&](int j, int p) { return s_X[j * (P + 1) + p]; });
    __syncthreads();
  }
  float* Sg = states + (cl.bk * H + cl.h) * (long)(N * P);
#pragma unroll
  for (int a = 0; a < N / TY; ++a)
#pragma unroll
    for (int b = 0; b < P / TX; ++b)
      Sg[(ty + TY * a) * P + tx + TX * b] = st[a][b];
}

// ----------------------------------------------------------------- backward
// Given dy [c,P], dst [N,P] and dcum [c] of a cell, with
// S_ij = CB_ij L_ij dt_j, M_ij = dS_ij L_ij dt_j, Q_ij = dS_ij CB_ij L_ij
// (all for i >= j, else 0), dS = dy x^T, e_j = exp(cum_end - cum_j),
// w_j = e_j dt_j and q_j = sum_{n,p} B_jn x_jp dst_np:
//
//   dx_j   = sum_i S_ij dy_i + w_j (B dst)_j
//   dC_i   = sum_j M_ij B_j                      (summed over heads after)
//   dB_j   = sum_i M_ij C_i + w_j (x dst^T)_j    (summed over heads after)
//   ddt_j  = sum_i Q_ij + e_j q_j
//   dcum_k = dcum_k + sum_j Q_kj dt_j - dt_k sum_i Q_ik - w_k q_k
//            + [k = c-1] sum_j w_j q_j
//   dda_k  = sum_{i >= k} dcum_i
//
// Pass A walks row tiles i (dC and the row sums of Q dt), pass B column
// tiles j (dx, dB, the column sums of Q, q); both rebuild C B^T and dS on
// the tile pairs j <= i. dC and dB are written per head, fp32, into
// [Bsz, S, H, N] partials that the wrapper sums over heads.
template <typename In, int N, int P>
__global__ void __launch_bounds__(NT)
    k3_bwd(const In* __restrict__ C, const In* __restrict__ B,
           const In* __restrict__ x, const float* __restrict__ da,
           const float* __restrict__ dt, const float* __restrict__ dy,
           const float* __restrict__ dst, const float* __restrict__ dcum,
           float* __restrict__ dC, float* __restrict__ dB,
           In* __restrict__ dx, float* __restrict__ dda,
           float* __restrict__ ddt, int S, int H, int c, long ld_cb,
           long ld_x) {
  extern __shared__ float sm[];
  const Cell cl = cell_of(S, H, c);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  float* s_cum = sm;                    // c
  float* s_dt = s_cum + c;              // c
  float* s_e = s_dt + c;                // c: exp(cum_end - cum)
  float* s_w = s_e + c;                 // c: e * dt
  float* s_rowR = s_w + c;              // c: sum_j Q_kj dt_j
  float* s_colQ = s_rowR + c;           // c: sum_i Q_ik
  float* s_q = s_colQ + c;              // c
  float* s_dcum = s_q + c;              // c
  float* s_dst = s_dcum + c;            // N x (P+1)
  float* s_C = s_dst + N * (P + 1);     // T x (N+1)
  float* s_B = s_C + T * (N + 1);       // T x (N+1)
  float* s_X = s_B + T * (N + 1);       // T x (P+1)
  float* s_dY = s_X + T * (P + 1);      // T x (P+1)
  float* s_S = s_dY + T * (P + 1);      // T x (T+1)
  float* s_M = s_S + T * (T + 1);       // T x (T+1)

  for (int t = tid; t < c; t += NT) {
    const long g = (cl.tok0 + t) * H + cl.h;
    s_cum[t] = da[g];
    s_dt[t] = dt[g];
    s_dcum[t] = dcum[g];
    s_rowR[t] = 0.f;
    s_colQ[t] = 0.f;
    s_q[t] = 0.f;
  }
  const float* dstg = dst + (cl.bk * H + cl.h) * (long)(N * P);
  load_tile(s_dst, dstg, P, N, P);
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < c; ++t) {
      acc += s_cum[t];
      s_cum[t] = acc;
    }
  }
  __syncthreads();
  const float cend = s_cum[c - 1];
  for (int t = tid; t < c; t += NT) {
    s_e[t] = expf(cend - s_cum[t]);
    s_w[t] = s_e[t] * s_dt[t];
  }
  const In* Cg = C + cl.tok0 * ld_cb;
  const In* Bg = B + cl.tok0 * ld_cb;
  const In* Xg = x + cl.tok0 * ld_x + (long)cl.h * P;
  const long ldy = (long)H * P, ldn = (long)H * N;
  const float* dYg = dy + cl.tok0 * ldy + (long)cl.h * P;
  __syncthreads();

  // C B^T and dy x^T on tile pair (i0, j0), from s_C/s_B and s_dY/s_X
  auto scores = [&](float (&cb)[T / TY][T / TX],
                    float (&ds)[T / TY][T / TX]) {
    zero(cb);
    zero(ds);
    mac(cb, N, [&](int i, int n) { return s_C[i * (N + 1) + n]; },
        [&](int n, int j) { return s_B[j * (N + 1) + n]; });
    mac(ds, P, [&](int i, int p) { return s_dY[i * (P + 1) + p]; },
        [&](int p, int j) { return s_X[j * (P + 1) + p]; });
  };

  // pass A: dC and the row sums of R = Q dt, by row tile
  for (int i0 = 0; i0 < c; i0 += T) {
    load_tile(s_C, Cg + i0 * ld_cb, ld_cb, T, N);
    load_tile(s_dY, dYg + i0 * ldy, ldy, T, P);
    float acc[T / TY][N / TX];
    zero(acc);
    for (int j0 = 0; j0 <= i0; j0 += T) {
      load_tile(s_B, Bg + j0 * ld_cb, ld_cb, T, N);
      load_tile(s_X, Xg + j0 * ld_x, ld_x, T, P);
      __syncthreads();
      float cb[T / TY][T / TX], ds[T / TY][T / TX];
      scores(cb, ds);
#pragma unroll
      for (int a = 0; a < T / TY; ++a)
#pragma unroll
        for (int b = 0; b < T / TX; ++b) {
          const int i = ty + TY * a, j = tx + TX * b;
          const int gi = i0 + i, gj = j0 + j;
          const float L = gi >= gj ? expf(s_cum[gi] - s_cum[gj]) : 0.f;
          const float m = ds[a][b] * L * s_dt[gj];
          s_M[i * (T + 1) + j] = m;
          s_S[i * (T + 1) + j] = m * cb[a][b];    // R_ij = Q_ij dt_j
        }
      __syncthreads();
      if (tid < T) {
        float r = 0.f;
        for (int j = 0; j < T; ++j) r += s_S[tid * (T + 1) + j];
        s_rowR[i0 + tid] += r;
      }
      mac(acc, T, [&](int i, int j) { return s_M[i * (T + 1) + j]; },
          [&](int j, int n) { return s_B[j * (N + 1) + n]; });
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < T / TY; ++a)
#pragma unroll
      for (int b = 0; b < N / TX; ++b)
        dC[(cl.tok0 + i0 + ty + TY * a) * ldn + (long)cl.h * N + tx +
           TX * b] = acc[a][b];
  }

  // pass B: dx, dB, the column sums of Q and q, by column tile
  for (int j0 = 0; j0 < c; j0 += T) {
    load_tile(s_B, Bg + j0 * ld_cb, ld_cb, T, N);
    load_tile(s_X, Xg + j0 * ld_x, ld_x, T, P);
    __syncthreads();
    float adx[T / TY][P / TX], adb[T / TY][N / TX];
    zero(adx);
    zero(adb);
    mac(adx, N, [&](int j, int n) { return s_B[j * (N + 1) + n]; },
        [&](int n, int p) { return s_dst[n * (P + 1) + p]; });
    mac(adb, P, [&](int j, int p) { return s_X[j * (P + 1) + p]; },
        [&](int p, int n) { return s_dst[n * (P + 1) + p]; });
#pragma unroll
    for (int a = 0; a < T / TY; ++a) {
      const int j = ty + TY * a;
      float part = 0.f;
#pragma unroll
      for (int b = 0; b < N / TX; ++b)
        part += s_B[j * (N + 1) + tx + TX * b] * adb[a][b];
      atomicAdd(&s_q[j0 + j], part);
      const float w = s_w[j0 + j];
#pragma unroll
      for (int b = 0; b < P / TX; ++b) adx[a][b] *= w;
#pragma unroll
      for (int b = 0; b < N / TX; ++b) adb[a][b] *= w;
    }
    float colq[T / TX];
#pragma unroll
    for (int b = 0; b < T / TX; ++b) colq[b] = 0.f;
    for (int i0 = j0; i0 < c; i0 += T) {
      load_tile(s_C, Cg + i0 * ld_cb, ld_cb, T, N);
      load_tile(s_dY, dYg + i0 * ldy, ldy, T, P);
      __syncthreads();
      float cb[T / TY][T / TX], ds[T / TY][T / TX];
      scores(cb, ds);
#pragma unroll
      for (int a = 0; a < T / TY; ++a)
#pragma unroll
        for (int b = 0; b < T / TX; ++b) {
          const int i = ty + TY * a, j = tx + TX * b;
          const int gi = i0 + i, gj = j0 + j;
          const float L = gi >= gj ? expf(s_cum[gi] - s_cum[gj]) : 0.f;
          s_S[i * (T + 1) + j] = cb[a][b] * L * s_dt[gj];
          s_M[i * (T + 1) + j] = ds[a][b] * L * s_dt[gj];
          colq[b] += ds[a][b] * cb[a][b] * L;
        }
      __syncthreads();
      mac(adx, T, [&](int j, int i) { return s_S[i * (T + 1) + j]; },
          [&](int i, int p) { return s_dY[i * (P + 1) + p]; });
      mac(adb, T, [&](int j, int i) { return s_M[i * (T + 1) + j]; },
          [&](int i, int n) { return s_C[i * (N + 1) + n]; });
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < T / TX; ++b)
      atomicAdd(&s_colQ[j0 + tx + TX * b], colq[b]);
#pragma unroll
    for (int a = 0; a < T / TY; ++a) {
      const long tok = cl.tok0 + j0 + ty + TY * a;
#pragma unroll
      for (int b = 0; b < P / TX; ++b)
        stf(dx + tok * ldy + (long)cl.h * P + tx + TX * b, adx[a][b]);
#pragma unroll
      for (int b = 0; b < N / TX; ++b)
        dB[tok * ldn + (long)cl.h * N + tx + TX * b] = adb[a][b];
    }
  }
  __syncthreads();

  // ddt and dcum per token; then dda = reverse cumsum of dcum
  for (int t = tid; t < c; t += NT) {
    const float q = s_q[t];
    ddt[(cl.tok0 + t) * H + cl.h] = s_colQ[t] + s_e[t] * q;
    s_q[t] = s_w[t] * q;                                     // u_t
    s_dcum[t] += s_rowR[t] - s_dt[t] * s_colQ[t] - s_q[t];
  }
  __syncthreads();
  if (tid == 0) {
    float usum = 0.f;
    for (int t = 0; t < c; ++t) usum += s_q[t];
    s_dcum[c - 1] += usum;
    float acc = 0.f;
    for (int t = c - 1; t >= 0; --t) {
      acc += s_dcum[t];
      s_dcum[t] = acc;
    }
  }
  __syncthreads();
  for (int t = tid; t < c; t += NT) dda[(cl.tok0 + t) * H + cl.h] = s_dcum[t];
}

size_t fwd_smem(int c, int N, int P) {
  return sizeof(float) *
         (3 * c + 2 * T * (N + 1) + T * (P + 1) + T * (T + 1));
}

size_t bwd_smem(int c, int N, int P) {
  return sizeof(float) * (8 * c + N * (P + 1) + 2 * T * (N + 1) +
                          2 * T * (P + 1) + 2 * T * (T + 1));
}

template <typename In, int N, int P>
cudaError_t launch_fwd(const void* C, const void* B, const void* x,
                       const float* da, const float* dt, float* y,
                       float* states, float* cum, int Bsz, int S, int H,
                       int c, long ld_cb, long ld_x, cudaStream_t stream) {
  auto kern = k3_fwd<In, N, P>;
  const size_t smem = fwd_smem(c, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long cells = (long)Bsz * (S / c) * H;
  kern<<<cells, NT, smem, stream>>>(
      (const In*)C, (const In*)B, (const In*)x, da, dt, y, states, cum, S, H,
      c, ld_cb, ld_x);
  return cudaGetLastError();
}

template <typename In, int N, int P>
cudaError_t launch_bwd(const void* C, const void* B, const void* x,
                       const float* da, const float* dt, const float* dy,
                       const float* dst, const float* dcum, float* dC,
                       float* dB, void* dx, float* dda, float* ddt, int Bsz,
                       int S, int H, int c, long ld_cb, long ld_x,
                       cudaStream_t stream) {
  auto kern = k3_bwd<In, N, P>;
  const size_t smem = bwd_smem(c, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long cells = (long)Bsz * (S / c) * H;
  kern<<<cells, NT, smem, stream>>>(
      (const In*)C, (const In*)B, (const In*)x, da, dt, dy, dst, dcum, dC,
      dB, (In*)dx, dda, ddt, S, H, c, ld_cb, ld_x);
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
                    float* y, float* states, float* cum, int Bsz, int S,
                    int H, int c, long ld_cb, long ld_x,
                    cudaStream_t stream) {
  if (dtype == 0) {
    K3_DISPATCH(float, launch_fwd, C, B, x, da, dt, y, states, cum, Bsz, S,
                H, c, ld_cb, ld_x, stream)
  }
  K3_DISPATCH(__nv_bfloat16, launch_fwd, C, B, x, da, dt, y, states, cum,
              Bsz, S, H, c, ld_cb, ld_x, stream)
}

cudaError_t bwd_any(int dtype, int N, int P, const void* C, const void* B,
                    const void* x, const float* da, const float* dt,
                    const float* dy, const float* dst, const float* dcum,
                    float* dC, float* dB, void* dx, float* dda, float* ddt,
                    int Bsz, int S, int H, int c, long ld_cb, long ld_x,
                    cudaStream_t stream) {
  if (dtype == 0) {
    K3_DISPATCH(float, launch_bwd, C, B, x, da, dt, dy, dst, dcum, dC, dB,
                dx, dda, ddt, Bsz, S, H, c, ld_cb, ld_x, stream)
  }
  K3_DISPATCH(__nv_bfloat16, launch_bwd, C, B, x, da, dt, dy, dst, dcum,
              dC, dB, dx, dda, ddt, Bsz, S, H, c, ld_cb, ld_x, stream)
}

bool shape_ok(int S, int c) {
  return c >= T && c % T == 0 && c <= 1024 && S > 0 && S % c == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (C, B, x and dx); returns a cudaError_t
int k3_forward(const void* C, const void* B, const void* x, const void* da,
               const void* dt, void* y, void* states, void* cum, int Bsz,
               int S, int H, int N, int P, int c, long long ld_cb,
               long long ld_x, int dtype, void* stream) {
  if (!shape_ok(S, c) || Bsz <= 0 || H <= 0) return cudaErrorInvalidValue;
  return fwd_any(dtype, N, P, C, B, x, (const float*)da, (const float*)dt,
                 (float*)y, (float*)states, (float*)cum, Bsz, S, H, c,
                 (long)ld_cb, (long)ld_x, (cudaStream_t)stream);
}

int k3_backward(const void* C, const void* B, const void* x, const void* da,
                const void* dt, const void* dy, const void* dst,
                const void* dcum, void* dC, void* dB, void* dx, void* dda,
                void* ddt, int Bsz, int S, int H, int N, int P, int c,
                long long ld_cb, long long ld_x, int dtype, void* stream) {
  if (!shape_ok(S, c) || Bsz <= 0 || H <= 0) return cudaErrorInvalidValue;
  return bwd_any(dtype, N, P, C, B, x, (const float*)da, (const float*)dt,
                 (const float*)dy, (const float*)dst, (const float*)dcum,
                 (float*)dC, (float*)dB, dx, (float*)dda, (float*)ddt, Bsz,
                 S, H, c, (long)ld_cb, (long)ld_x, (cudaStream_t)stream);
}

const char* k3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
