// Probe of the two tensor-core routes for an f32-accurate product on Hopper
// (sm_90a), built and timed by scripts/torch_tf32_probe.py:
//
//   mma_rate_kernel    mma.sync.m16n8k8 tf32 alone, 8 independent chains a
//                      warp: the legacy instruction's TF32 rate;
//   split_loop_kernel  the inner loop of an f32 product on mma.sync, three
//                      products (lo*hi, hi*lo, hi*hi) into one accumulator, A
//                      pre-split in registers, each B fragment from shared
//                      memory: <0> read as f32 and split in registers with
//                      cvt.rna.tf32.f32 (hi, then lo of b - hi), <1> the same
//                      split by integer rounding (``tf32_int``), <2> read as
//                      (hi, lo) pairs split beforehand; <2, 2> the same
//                      with each B fragment used by two 16-row tiles of A;
//   prep_kernel        the copies each streamed f32 64 x 64 tile costs: <0>
//                      wgmma's route, which reads tf32 operands from shared
//                      memory K-major only, so a tile that is a B operand both
//                      as stored and transposed is read once and written four
//                      times (hi, lo, and both transposed), 128-byte swizzled,
//                      then fenced for the async proxy; <1> mma.sync's, one
//                      (hi, lo) pair an element; each then synchronised;
//   tf32_equal_kernel  every finite f32 pattern: ``tf32_int`` against
//                      cvt.rna.tf32.f32, bit for bit.
//
// Each kernel loops `iters` times; the script reads the device time of one
// launch and turns it into a rate.  Nothing here is part of the port.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// round to nearest, ties away from zero, at TF32's 10 mantissa bits
__device__ __forceinline__ uint32_t tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int kMode>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = kMode == 0 ? tf32(x) : tf32_int(x);
  lo = kMode == 0 ? tf32(x - __uint_as_float(hi)) : tf32_int(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256) mma_rate_kernel(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = tf32(1.0f + 1e-3f * (lane + i));
  b[0] = tf32(0.5f + 1e-3f * lane);
  b[1] = tf32(0.25f - 1e-3f * lane);
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a[0], a[1], a[2], a[3], b[0], b[1]);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kRows = 64, kCols = 64;

// The element (r, c) of a 64-column tile of 8-byte elements: columns
// swizzled in groups of 4 by the row, so that both fragment reads (rows g,
// columns t; rows 2t and 2t + 1, columns g) hit distinct banks.
__device__ __forceinline__ int pair_idx(int r, int c) {
  return r * kCols + (c ^ (4 * ((r + (r >> 2)) & 3)));
}

// A (16 x 64 rows a tile, kTiles tiles) pre-split in registers, B an (8-key x
// 64) slice of a tile read as the dV / dK product reads it: b0 = T[2t][n0 +
// g], b1 = T[2t + 1][n0 + g]; 8 k-steps x 8 n-tiles x kTiles x 3 products an
// iteration, each B fragment used by all kTiles row tiles.
template <int kMode, int kTiles = 1>
__global__ void __launch_bounds__(256) split_loop_kernel(float* out, int iters) {
  __shared__ uint2 tile[(kRows + 24) * kCols];  // <2>: (hi, lo) pairs; else f32 in .x
  for (int i = threadIdx.x; i < (kRows + 24) * kCols; i += blockDim.x) {
    const float x = 1.0f + 1e-4f * (i % 97);
    uint32_t h, l;
    split<1>(x, h, l);
    tile[i] = kMode == 2 ? make_uint2(h, l) : make_uint2(__float_as_uint(x), 0u);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[kTiles][8][4], al[kTiles][8][4];
#pragma unroll
  for (int m = 0; m < kTiles; ++m)
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split<1>(0.5f + 1e-3f * (lane + ks + i + m), ah[m][ks][i], al[m][ks][i]);
  float c[kTiles][8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int r = ks * 8 + 2 * t + 8 * (it & 3);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        const uint2 p0 = tile[pair_idx(r, nt * 8 + g)], p1 = tile[pair_idx(r + 1, nt * 8 + g)];
        if (kMode == 2) {
          bh0 = p0.x, bl0 = p0.y, bh1 = p1.x, bl1 = p1.y;
        } else {
          split<kMode>(__uint_as_float(p0.x), bh0, bl0);
          split<kMode>(__uint_as_float(p1.x), bh1, bl1);
        }
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          mma(c[m][nt], al[m][ks][0], al[m][ks][1], al[m][ks][2], al[m][ks][3], bh0, bh1);
          mma(c[m][nt], ah[m][ks][0], ah[m][ks][1], ah[m][ks][2], ah[m][ks][3], bl0, bl1);
          mma(c[m][nt], ah[m][ks][0], ah[m][ks][1], ah[m][ks][2], ah[m][ks][3], bh0, bh1);
        }
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < kTiles; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) s += c[m][j][0] + c[m][j][1] + c[m][j][2] + c[m][j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Byte offset of f32 element (r, c) of a K-major operand of 32-column
// (128-byte) rows in 8-row atoms, 128-byte swizzled, as wgmma reads it:
// column block c / 32, row r, 16-byte chunk (c % 32) / 4 xor (r % 8).
__device__ __forceinline__ int swz(int r, int c, int rows) {
  const int chunk = ((c & 31) >> 2) ^ (r & 7);
  return (c >> 5) * rows * 128 + r * 128 + chunk * 16 + (c & 3) * 4;
}

template <int kMode>
__global__ void __launch_bounds__(256) prep_kernel(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);  // the tile as it lands
  unsigned char* hi = smem + kRows * kCols * 4;
  unsigned char* lo = hi + kRows * kCols * 4;
  unsigned char* hit = lo + kRows * kCols * 4;  // transposed
  unsigned char* lot = hit + kRows * kCols * 4;
  for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) raw[i] = 1.0f + 1e-4f * i;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (kMode == 0) {
#pragma unroll 4
      for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) {
        const int r = i / kCols, c = i % kCols;
        uint32_t h, l;
        split<1>(raw[i] + (float)it, h, l);
        *reinterpret_cast<uint32_t*>(hi + swz(r, c, kRows)) = h;
        *reinterpret_cast<uint32_t*>(lo + swz(r, c, kRows)) = l;
        *reinterpret_cast<uint32_t*>(hit + swz(c, r, kCols)) = h;
        *reinterpret_cast<uint32_t*>(lot + swz(c, r, kCols)) = l;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    } else {  // 4 elements a thread a step: one 16-byte read, two 16-byte writes
      uint4* pairs = reinterpret_cast<uint4*>(hi);
#pragma unroll 2
      for (int i = threadIdx.x; i < kRows * kCols / 4; i += blockDim.x) {
        const float4 x = reinterpret_cast<const float4*>(raw)[i];
        const int r = (4 * i) / kCols, c = (4 * i) % kCols;
        const int sc = (c ^ (4 * ((r + (r >> 2)) & 3))) / 2;  // in pairs of pairs
        uint32_t h[4], l[4];
        split<1>(x.x + (float)it, h[0], l[0]);
        split<1>(x.y, h[1], l[1]);
        split<1>(x.z, h[2], l[2]);
        split<1>(x.w, h[3], l[3]);
        pairs[r * kCols / 2 + sc] = make_uint4(h[0], l[0], h[1], l[1]);
        pairs[r * kCols / 2 + sc + 1] = make_uint4(h[2], l[2], h[3], l[3]);
      }
    }
    __syncthreads();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      __uint_as_float(*reinterpret_cast<uint32_t*>(lot + 4 * threadIdx.x) & 0x3fffffffu);
}

// mismatches[0] += the finite patterns in this thread's share where
// tf32_int differs from cvt.rna.tf32.f32
__global__ void tf32_equal_kernel(unsigned long long* mismatches) {
  const uint32_t n = gridDim.x * blockDim.x;
  unsigned long long bad = 0;
  for (uint64_t u = blockIdx.x * blockDim.x + threadIdx.x; u < (1ull << 32); u += n) {
    const float x = __uint_as_float((uint32_t)u);
    if (isfinite(x) && tf32(x) != tf32_int(x)) ++bad;
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

constexpr int kPrepSmem = 5 * kRows * kCols * 4;

// Each returns a cudaError_t (0 = launched): `blocks` blocks of 256 threads,
// `out` holds blocks * 256 floats.
extern "C" int probe_mma_rate(void* out, int blocks, int iters, void* stream) {
  mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" int probe_split_loop(void* out, int blocks, int iters, int mode, void* stream) {
  auto kernel = mode == 0   ? split_loop_kernel<0>
                : mode == 1 ? split_loop_kernel<1>
                : mode == 2 ? split_loop_kernel<2>
                            : split_loop_kernel<2, 2>;
  kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" int probe_prep(void* out, int blocks, int iters, int mode, void* stream) {
  auto kernel = mode == 0 ? prep_kernel<0> : prep_kernel<1>;
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kPrepSmem))
    return err;
  kernel<<<blocks, 256, kPrepSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" int probe_tf32_equal(void* mismatches, void* stream) {
  tf32_equal_kernel<<<4 * 132, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return (int)cudaGetLastError();
}
