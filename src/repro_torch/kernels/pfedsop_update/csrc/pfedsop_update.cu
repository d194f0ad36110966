// Fused pFedSOP round-start update for Hopper (sm_90a): the reduce/update pair.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pfedsop_update/kernel.py:
//   K1  reduce3_batched_pallas (_reduce_batched_kernel)  -> pfedsop_reduce3
//   K2  update_batched_pallas  (_update_batched_kernel)  -> pfedsop_update
//   K3  reduce3_pallas / update_pallas (one client)      -> the same two, C = 1
//
// K1: per (client c, tile t) f32 partials of <d_i[c], d_g>, |d_i[c]|^2 and
//     |d_g|^2 over elements [t*tile, min((t+1)*tile, n)).
// K2: x_new[c] = x[c] - ec[c] * ((1 - beta[c]) * d_i[c] + beta[c] * d_g),
//     f32 math, output in x's type.
// d_g is either one row shared by every client (row stride 0) or one row per
// client (row stride dg_stride).  x, d_i and out share the row stride `ld`
// (>= n): a model-sharded launch passes views of its contiguous tile range,
// [t0*tile, t0*tile + n) of each row of the full (C, N) buffers, with
// ld = N and no copy.  x, d_i and d_g are all f32 or all bf16.
//
// What bounds it on an H100 SXM (80 GB HBM3 at 3.35 TB/s): both kernels are
// one streaming pass doing 1-2 flops per byte moved, far under the card's f32
// ridge (67 TFLOP/s / 3.35 TB/s = 20 flops per byte), so the bytes moved set
// the bound.  At the main-path shape (C = 20 clients, N = 1,249,956 f32,
// shared d_g) K1 reads C*N + N floats (~105.0 MB, ~31 us) and K2 reads x, d_i
// and d_g and writes x_new (~305.0 MB, ~91 us).
//
// What the design does about it:
//  - every element is read once, with 16-byte loads and stores (float4, or
//    8 bf16) whenever every row starts 16-byte aligned, and scalar accesses
//    otherwise; a ragged n is masked, never padded;
//  - the shared d_g row is read at row stride 0 by every client's blocks:
//    no C copies are made, and the 5 MB row stays in the 50 MB L2;
//  - the tile count depends on n alone and each block reduces in a fixed
//    order with warp shuffles: no atomics, so K1's partials are bitwise
//    reproducible run to run.  The caller sums the (C, T, 3) partials and
//    computes beta and the Sherman-Morrison coefficient on the device, so
//    K2 follows on the same stream with no host sync;
//  - K2 rounds each product and sum on its own (__fmul_rn / __fadd_rn, no
//    FMA contraction), in the order of the plain PyTorch version, so the
//    two agree bit for bit given the same beta and coefficient.
//
// The TPU kernel's (rows, 128) tiling is not carried over: a block here is
// 256 threads over a contiguous span of `tile` elements of one client row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of T in one 16-byte access.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[Vec<T>::kN]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::kN; ++k) v[k] = to_f32(e[k]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[Vec<T>::kN]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < Vec<T>::kN; ++k) e[k] = from_f32<T>(v[k]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
reduce3_kernel(const T* __restrict__ di, const T* __restrict__ dg, long long n,
               long long ld, long long dg_stride, long long tile,
               float* __restrict__ partials) {
  const long long c = blockIdx.y;
  const long long t = blockIdx.x;
  const T* dic = di + c * ld;
  const T* dgc = dg + c * dg_stride;
  const long long lo = t * tile;
  const long long hi = lo + tile < n ? lo + tile : n;

  float s_dot = 0.f, s_ii = 0.f, s_gg = 0.f;
  long long i = lo + threadIdx.x;
  if constexpr (kVec) {
    constexpr int V = Vec<T>::kN;
    const long long vhi = lo + (hi - lo) / V * V;
    for (long long j = lo + (long long)threadIdx.x * V; j < vhi;
         j += (long long)kThreads * V) {
      float a[V], g[V];
      load16(dic + j, a);
      load16(dgc + j, g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s_dot += a[k] * g[k];
        s_ii += a[k] * a[k];
        s_gg += g[k] * g[k];
      }
    }
    i = vhi + threadIdx.x;
  }
  for (; i < hi; i += kThreads) {
    const float a = to_f32(dic[i]);
    const float g = to_f32(dgc[i]);
    s_dot += a * g;
    s_ii += a * a;
    s_gg += g * g;
  }

  __shared__ float sh[3][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  s_dot = warp_sum(s_dot);
  s_ii = warp_sum(s_ii);
  s_gg = warp_sum(s_gg);
  if (lane == 0) {
    sh[0][warp] = s_dot;
    sh[1][warp] = s_ii;
    sh[2][warp] = s_gg;
  }
  __syncthreads();
  if (warp == 0) {
    s_dot = warp_sum(lane < kWarps ? sh[0][lane] : 0.f);
    s_ii = warp_sum(lane < kWarps ? sh[1][lane] : 0.f);
    s_gg = warp_sum(lane < kWarps ? sh[2][lane] : 0.f);
    if (lane == 0) {
      float* out = partials + (c * gridDim.x + t) * 3;
      out[0] = s_dot;
      out[1] = s_ii;
      out[2] = s_gg;
    }
  }
}

__device__ __forceinline__ float update_one(float x, float d, float g, float b,
                                            float one_minus_b, float ec) {
  const float dp = __fadd_rn(__fmul_rn(one_minus_b, d), __fmul_rn(b, g));
  return __fsub_rn(x, __fmul_rn(ec, dp));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ x, const T* __restrict__ di,
              const T* __restrict__ dg, long long n, long long ld,
              long long dg_stride, long long tile, const float* __restrict__ beta,
              const float* __restrict__ ec, T* __restrict__ out) {
  const long long c = blockIdx.y;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  const T* xc = x + c * ld;
  const T* dic = di + c * ld;
  const T* dgc = dg + c * dg_stride;
  T* oc = out + c * ld;
  const float b = beta[c];
  const float one_minus_b = __fsub_rn(1.0f, b);
  const float e = ec[c];

  long long i = lo + threadIdx.x;
  if constexpr (kVec) {
    constexpr int V = Vec<T>::kN;
    const long long vhi = lo + (hi - lo) / V * V;
    for (long long j = lo + (long long)threadIdx.x * V; j < vhi;
         j += (long long)kThreads * V) {
      float xv[V], d[V], g[V];
      load16(xc + j, xv);
      load16(dic + j, d);
      load16(dgc + j, g);
#pragma unroll
      for (int k = 0; k < V; ++k) xv[k] = update_one(xv[k], d[k], g[k], b, one_minus_b, e);
      store16(oc + j, xv);
    }
    i = vhi + threadIdx.x;
  }
  for (; i < hi; i += kThreads) {
    oc[i] = from_f32<T>(update_one(to_f32(xc[i]), to_f32(dic[i]), to_f32(dgc[i]),
                                   b, one_minus_b, e));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte accesses need every row start and every tile start 16-byte aligned.
// A tile range's views start at a multiple of `tile` elements, so a range
// launch takes the vector path exactly when the whole-row launch does.
template <typename T>
bool vector_ok(long long ld, long long dg_stride, long long tile,
               std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return (ld * (long long)sizeof(T)) % 16 == 0 &&
         (dg_stride * (long long)sizeof(T)) % 16 == 0 &&
         (tile * (long long)sizeof(T)) % 16 == 0;
}

template <typename T>
int launch_reduce3(const void* di, const void* dg, long long c, long long n,
                   long long ld, long long dg_stride, long long tile, long long tiles,
                   void* partials, cudaStream_t s) {
  const dim3 grid((unsigned)tiles, (unsigned)c);
  const T* a = static_cast<const T*>(di);
  const T* g = static_cast<const T*>(dg);
  float* p = static_cast<float*>(partials);
  if (vector_ok<T>(ld, dg_stride, tile, {di, dg}))
    reduce3_kernel<T, true><<<grid, kThreads, 0, s>>>(a, g, n, ld, dg_stride, tile, p);
  else
    reduce3_kernel<T, false><<<grid, kThreads, 0, s>>>(a, g, n, ld, dg_stride, tile, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(const void* x, const void* di, const void* dg, long long c,
                  long long n, long long ld, long long dg_stride, long long tile,
                  const void* beta, const void* ec, void* out, cudaStream_t s) {
  const dim3 grid((unsigned)((n + tile - 1) / tile), (unsigned)c);
  const T* xp = static_cast<const T*>(x);
  const T* a = static_cast<const T*>(di);
  const T* g = static_cast<const T*>(dg);
  const float* b = static_cast<const float*>(beta);
  const float* e = static_cast<const float*>(ec);
  T* o = static_cast<T*>(out);
  if (vector_ok<T>(ld, dg_stride, tile, {x, di, dg, out}))
    update_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, a, g, n, ld, dg_stride, tile, b, e, o);
  else
    update_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, a, g, n, ld, dg_stride, tile, b, e, o);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ld: the row stride of d_i (and of x and
// out in pfedsop_update), in elements.  Returns a cudaError_t (0 = launched).
extern "C" int pfedsop_reduce3(const void* di, const void* dg, int dtype,
                               long long c, long long n, long long ld,
                               long long dg_stride, long long tile, long long tiles,
                               void* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld < n) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_reduce3<float>(di, dg, c, n, ld, dg_stride, tile, tiles, partials, s);
  if (dtype == 1)
    return launch_reduce3<__nv_bfloat16>(di, dg, c, n, ld, dg_stride, tile, tiles, partials, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pfedsop_update(const void* x, const void* di, const void* dg, int dtype,
                              long long c, long long n, long long ld,
                              long long dg_stride, long long tile, const void* beta,
                              const void* ec, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld < n) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_update<float>(x, di, dg, c, n, ld, dg_stride, tile, beta, ec, out, s);
  if (dtype == 1)
    return launch_update<__nv_bfloat16>(x, di, dg, c, n, ld, dg_stride, tile, beta, ec, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pfedsop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
