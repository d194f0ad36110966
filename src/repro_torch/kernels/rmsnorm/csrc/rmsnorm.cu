// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
//   K4  rmsnorm_pallas (_rmsnorm_kernel)  -> rmsnorm_fwd
//
// Per row of x (rows, d): y = x * rsqrt(mean(x^2) + eps) * (1 + scale), all in
// f32, cast back to x's type.  x, scale and y are all f32 or all bf16.  The
// backward is autograd of the plain reference (as repro's VJP of its oracle),
// so there is no backward kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s): one pass that reads each element
// of x once and writes y once, doing ~4 flops per element: far under the
// card's ridge, so bytes set the bound.  At the LM slice's widest call
// (gemma3-1b, 4,096 tokens x 1,152 bf16) that is 18.9 MB, ~5.6 us.
//
// What the design does about it:
//  - one warp per row, 8 rows per 256-thread block: the row's sum of squares
//    is a register accumulation and a fixed-order warp shuffle (no shared
//    memory, no atomics: bitwise run to run);
//  - 16-byte loads and stores (4 f32 or 8 bf16 per lane) when every row
//    starts 16-byte aligned, scalar accesses otherwise;
//  - the row is read twice, the second time from L1/L2 (a 2.3 KB row), so
//    device memory sees each element once.
//
// The TPU kernel's (256-row, d) VMEM tiles are not carried over: a row is far
// smaller than an SM's share of the work, so rows map to warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, long long rows,
               int d, float eps, T* __restrict__ y) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int V = Vec<T>::kN;

  float ss = 0.f;
  if constexpr (kVec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float v[V];
      load16(xr + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) ss += v[k] * v[k];
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float v = to_f32(xr[c]);
      ss += v * v;
    }
  }
  ss = warp_allsum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  if constexpr (kVec) {
    for (int c = lane * V; c < d; c += 32 * V) {
      float v[V], s[V];
      load16(xr + c, v);
      load16(scale + c, s);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = (v[k] * r) * (1.0f + s[k]);
      store16(yr + c, v);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      yr[c] = from_f32<T>((to_f32(xr[c]) * r) * (1.0f + to_f32(scale[c])));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const void* scale, long long rows, int d, float eps, void* y,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  const bool vec = aligned16(x) && aligned16(scale) && aligned16(y) &&
                   ((long long)d * (long long)sizeof(T)) % 16 == 0;
  if (vec)
    rmsnorm_kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, sp, rows, d, eps, yp);
  else
    rmsnorm_kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, sp, rows, d, eps, yp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, int dtype, long long rows,
                           int d, float eps, void* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, rows, d, eps, y, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, rows, d, eps, y, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
