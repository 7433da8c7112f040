// RG-LRU linear scan (kernel K4) for Hopper (sm_90a), forward and
// backward, plain C interface.
//
// Replaces: src/repro/kernels/rglru_scan.py :: rglru_scan_pallas (Pallas
// body `_kernel`). Same function: h_t = a_t * h_{t-1} + b_t over
// [B, S, W] with h_{-1} = 0, the state carried in fp32 and h written in
// a's type (fp32 or bf16). The TPU kernel pads S to a chunk multiple with
// the identity (a = 1, b = 0); here every loop is bounded by S instead.
//
// What the port adds: the backward (the JAX package has none, and the
// Pallas kernel cannot be differentiated), the reverse scan
//   g_t = dh_t + a_{t+1} g_{t+1}  (g_{S-1} = dh_{S-1}),
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = 0),
// in fp32 from the forward's saved h.
//
// What bounds it on the H100: bytes. The forward reads a and b and writes
// h once each (4 bytes an element in fp32: 126 MB at one 4096-token row
// of width 2560, 0.038 ms at 3.35 TB/s) and does 2 flops an element. The
// TPU kernel walks chunks in order on one core and carries the state in
// VMEM between grid steps; on Hopper blocks run in no order, so the
// carry crosses blocks in a second kernel instead (chunk and carry, laid
// across the card):
//   1. summary: one thread per (row, chunk of CH steps, channel) scans its
//      chunk from a zero state and writes the chunk's affine map
//      h_end = A h_start + Bc (A the product of its a, Bc the local h_end);
//   2. apply: the same threads compose the maps of all earlier chunks of
//      their channel (a few KB per channel, L2-resident) into the carry,
//      scan the chunk again from it and write h.
// Consecutive threads hold consecutive channels, so every load and store
// of a time step is coalesced. The price is one more read of a and b
// (five tensors cross HBM, not three): about 1.7x the byte bound, left
// for a single-pass scan (decoupled look-back) to recover. The backward
// is the same two kernels run from the end of the sequence: the reverse
// map of a chunk is g_start = G + P g_next with P the product of a over
// the chunk shifted by one step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int CH = 64;        // time steps per chunk
constexpr int THREADS = 128;  // channels per block

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Shape {
  int B, S, W, nc;
};

// Per (row, chunk, channel): the chunk's map h_end = A h_start + Bc.
template <typename T>
__global__ void __launch_bounds__(THREADS)
k4_fwd_summary(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ sumA, float* __restrict__ sumB, Shape s) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= s.W) return;
  const int c = blockIdx.y, r = blockIdx.z;
  const int t0 = c * CH, t1 = min(t0 + CH, s.S);
  const int64_t base = (int64_t)r * s.S * s.W + w;
  float A = 1.f, h = 0.f;
  for (int t = t0; t < t1; ++t) {
    const float at = ld(a + base + (int64_t)t * s.W);
    h = fmaf(at, h, ld(b + base + (int64_t)t * s.W));
    A *= at;
  }
  const int64_t o = ((int64_t)r * s.nc + c) * s.W + w;
  sumA[o] = A;
  sumB[o] = h;
}

// Per (row, chunk, channel): the carry from the earlier chunks' maps, then
// the chunk's scan from it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
k4_fwd_apply(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ sumA, const float* __restrict__ sumB,
             T* __restrict__ h_out, Shape s) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= s.W) return;
  const int c = blockIdx.y, r = blockIdx.z;
  const int64_t so = (int64_t)r * s.nc * s.W + w;
  float h = 0.f;
#pragma unroll 4
  for (int k = 0; k < c; ++k)
    h = fmaf(sumA[so + (int64_t)k * s.W], h, sumB[so + (int64_t)k * s.W]);
  const int t0 = c * CH, t1 = min(t0 + CH, s.S);
  const int64_t base = (int64_t)r * s.S * s.W + w;
  for (int t = t0; t < t1; ++t) {
    const int64_t i = base + (int64_t)t * s.W;
    h = fmaf(ld(a + i), h, ld(b + i));
    st(h_out + i, h);
  }
}

// Per (row, chunk, channel): the chunk's reverse map g_start = G + P g_next,
// G the reverse scan of dh over the chunk from a zero g_next, P the
// product of a_{t0+1} .. a_{t1} (a_S counts as 0: nothing follows the
// last step).
template <typename T>
__global__ void __launch_bounds__(THREADS)
k4_bwd_summary(const T* __restrict__ a, const T* __restrict__ dh,
               float* __restrict__ sumP, float* __restrict__ sumG, Shape s) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= s.W) return;
  const int c = blockIdx.y, r = blockIdx.z;
  const int t0 = c * CH, t1 = min(t0 + CH, s.S);
  const int64_t base = (int64_t)r * s.S * s.W + w;
  float anext = t1 < s.S ? ld(a + base + (int64_t)t1 * s.W) : 0.f;
  float P = anext, g = 0.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const int64_t i = base + (int64_t)t * s.W;
    g = fmaf(anext, g, ld(dh + i));
    anext = ld(a + i);
    if (t > t0) P *= anext;
  }
  const int64_t o = ((int64_t)r * s.nc + c) * s.W + w;
  sumP[o] = P;
  sumG[o] = g;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k4_bwd_apply(const T* __restrict__ a, const T* __restrict__ dh,
             const T* __restrict__ h, const float* __restrict__ sumP,
             const float* __restrict__ sumG, T* __restrict__ da,
             T* __restrict__ db, Shape s) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= s.W) return;
  const int c = blockIdx.y, r = blockIdx.z;
  const int64_t so = (int64_t)r * s.nc * s.W + w;
  float g = 0.f;  // g at the first step of chunk c + 1
#pragma unroll 4
  for (int k = s.nc - 1; k > c; --k)
    g = fmaf(sumP[so + (int64_t)k * s.W], g, sumG[so + (int64_t)k * s.W]);
  const int t0 = c * CH, t1 = min(t0 + CH, s.S);
  const int64_t base = (int64_t)r * s.S * s.W + w;
  float anext = t1 < s.S ? ld(a + base + (int64_t)t1 * s.W) : 0.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const int64_t i = base + (int64_t)t * s.W;
    g = fmaf(anext, g, ld(dh + i));
    const float hprev = t > 0 ? ld(h + i - s.W) : 0.f;
    st(db + i, g);
    st(da + i, g * hprev);
    anext = ld(a + i);
  }
}

Shape make_shape(int B, int S, int W) {
  return Shape{B, S, W, (S + CH - 1) / CH};
}

dim3 grid_of(const Shape& s) {
  return dim3((s.W + THREADS - 1) / THREADS, s.nc, s.B);
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* b, void* h, float* sa,
                       float* sb, const Shape& s, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  k4_fwd_summary<T><<<grid_of(s), THREADS, 0, stream>>>(at, bt, sa, sb, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k4_fwd_apply<T><<<grid_of(s), THREADS, 0, stream>>>(
      at, bt, sa, sb, static_cast<T*>(h), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* dh, const void* h,
                       void* da, void* db, float* sp, float* sg,
                       const Shape& s, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* dht = static_cast<const T*>(dh);
  k4_bwd_summary<T><<<grid_of(s), THREADS, 0, stream>>>(at, dht, sp, sg, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k4_bwd_apply<T><<<grid_of(s), THREADS, 0, stream>>>(
      at, dht, static_cast<const T*>(h), sp, sg, static_cast<T*>(da),
      static_cast<T*>(db), s);
  return cudaGetLastError();
}

bool bad_args(int B, int S, int W, int dtype) {
  return B <= 0 || S <= 0 || W <= 0 || B > 65535 ||
         (S + CH - 1) / CH > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it). a, b, h are
// contiguous [B, S, W]; scratch is fp32 of 2 * B * ceil(S / 64) * W
// elements. Returns the cudaError_t of the launches (0 = cudaSuccess).
int k4_forward(const void* a, const void* b, void* h, void* scratch, int B,
               int S, int W, int dtype, void* stream) {
  if (bad_args(B, S, W, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(B, S, W);
  float* sa = static_cast<float*>(scratch);
  float* sb = sa + (int64_t)B * s.nc * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float>(a, b, h, sa, sb, s, st);
  return (int)launch_fwd<bf16>(a, b, h, sa, sb, s, st);
}

// a, dh, h (the forward's output) and the outputs da, db: contiguous
// [B, S, W] in one type; scratch as for k4_forward.
int k4_backward(const void* a, const void* dh, const void* h, void* da,
                void* db, void* scratch, int B, int S, int W, int dtype,
                void* stream) {
  if (bad_args(B, S, W, dtype)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(B, S, W);
  float* sp = static_cast<float*>(scratch);
  float* sg = sp + (int64_t)B * s.nc * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(a, dh, h, da, db, sp, sg, s, st);
  return (int)launch_bwd<bf16>(a, dh, h, da, db, sp, sg, s, st);
}

const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
