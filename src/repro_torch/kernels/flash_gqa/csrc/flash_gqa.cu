// Causal GQA flash attention for Hopper (sm_90a): forward and two-pass backward,
// on the CUDA cores.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_gqa/kernel.py:
//   K5  flash_gqa_pallas (_flash_kernel, return_residual)    -> flash_gqa_fwd
//   K6  flash_gqa_bwd_pallas, dq pass (_flash_bwd_dq_kernel)  -> flash_gqa_bwd_dq
//   K7  flash_gqa_bwd_pallas, dk/dv pass (_flash_bwd_dkv_kernel) -> flash_gqa_bwd_dkv
// All three take f32 here; bf16 runs their tensor-core versions in
// flash_gqa_sm90.cu.
//
// Layouts are the model's (repro.kernels.flash_gqa.ops.flash_gqa takes them):
//   q, o, dO, dq  (B, S, H, D)     k, v, dk, dv  (B, S, KV, D)     lse, delta (B, H, S) f32
// all contiguous; q/k/v/o/dO/dq/dk/dv all f32.  Query head h reads
// KV head h / (H/KV).  Positions are the canonical arange(S): key j is visible
// to query i iff j <= i and (no window, or i - j < window).  The optional logit
// softcap c applies s = c*tanh(s/c) to the scaled scores before the mask.
//
//   K5: out = softmax(q k^T * scale) v row by row, online over key tiles, plus
//       lse = m + log(l) per row (the backward's residual).
//   K6: p = exp(s - lse), ds = p * (dO v^T - delta) [* (1 - tanh^2)],
//       dq = scale * ds k.
//   K7: dv = p^T dO, dk = ds^T (scale * q), summed over the G query heads of the
//       KV head and every query tile that sees the key tile.
//   delta = rowsum(dO * out) is computed by the caller, as repro does.
//
// What bounds it on an H100 SXM: at the LM slice (B = 2, S = 2048, H = 4, KV = 1,
// D = 256, bf16) the work is 4D flops per visible (query, key) pair forward, 6D
// (dq) and 8D (dk/dv) backward, over ~1-9 MB of operands: operations set the
// bound, at the 989 TFLOP/s bf16 tensor-core peak.  These kernels do their
// products in f32 on the CUDA cores (67 TFLOP/s at most), so they sit far from
// that bound: in bf16 all three run on the tensor cores in flash_gqa_sm90.cu.
//
// What the design does now:
//  - one 256-thread block per (batch*head, 64-query tile) for K5 and K6, and per
//    (batch*KV head, 32-key tile) for K7; tiles live in shared memory as f32
//    with rows padded to D + 1 floats, so neither the row-wise nor the
//    column-wise reads of a tile hit one bank twice.  At D = 256 that is 137 KB
//    (K5), 201 KB (K6) and 210 KB (K7) of dynamic shared memory, one block per
//    SM; the launch raises the 48 KB default and its return code is checked;
//  - the window prunes exactly: K5/K6 visit key tiles
//    max(0, q0 - W + 1)/32 .. (q0 + 63)/32, K7 query tiles k0/64 ..
//    (k0 + 31 + W - 1)/64, recomputed here for these tiles, not the TPU's 512s;
//    the element mask is computed for the tile actually loaded;
//  - masked scores are -inf and never enter exp: a row that has seen no
//    visible key keeps m = -inf, l = 0 and takes alpha = 1, p = 0, so the
//    tile order does not matter and no NaN arises (the TPU kernel's finite
//    -1e30 relies on the diagonal tile coming last instead);
//  - every sum runs in one fixed order inside one block: K6 loops over its key
//    tiles, K7 over the G heads then the query tiles (the TPU kernel's
//    sequential innermost axis).  No atomics: results are bitwise run to run;
//  - a ragged S is masked: rows past S load as zero and are never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 32;  // key rows per tile
constexpr int kLdp = kBK + 1;  // padded row of a (kBQ, kBK) score tile
// A (kBQ, kBK) score tile: thread (tr = tid / 16, tc = tid % 16) holds rows
// tr*4 .. tr*4+3 and key columns tc, tc + 16.  The 16 threads of one row group
// are one half-warp, so row reductions are 4 xor-shuffles.  A (kBQ, D) output
// tile: the same 4 rows, columns tc + 16*c.  A (kBK, D) tile of K7: rows
// tr*2, tr*2+1, columns tc + 16*c.

struct Shape {
  int b, s, h, kv;
  int window;     // 0 = none
  float softcap;  // 0 = none
  float scale;
};

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r][c] = mul * src[row0 + r][c] for r < nrows (zero past S); src rows are
// row_stride elements apart, dst rows D + 1 floats apart.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          long long row_stride, int row0, int nrows,
                                          int s, float mul) {
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? src[(long long)row * row_stride + c] * mul : 0.f;
  }
}

// acc[i][j] = sum_d A[r0 + i][d] * B[c0 + 16 j][d]
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int r0, int c0,
                                         float (&acc)[4][2]) {
  constexpr int ld = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = B[(c0 + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Rows past a ragged S see nothing, so they add nothing to dk/dv.
__device__ __forceinline__ bool visible(int qi, int kj, const Shape& sh) {
  return kj <= qi && qi < sh.s && (sh.window <= 0 || qi - kj < sh.window);
}

// -- K5: forward ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, Shape sh) {
  constexpr int ld = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x ld, scaled
  float* Ks = Qs + kBQ * ld;    // kBK x ld
  float* Vs = Ks + kBK * ld;    // kBK x ld
  float* Ps = Vs + kBK * ld;    // kBQ x kLdp

  const int bh = blockIdx.y, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = blockIdx.x * kBQ;

  load_rows<D>(Qs, q + q_off, q_rs, q0, kBQ, sh.s, sh.scale);

  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kBK : 0;
  const int kt_last = (min(q0 + kBQ, sh.s) - 1) / kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's Ks/Vs/Ps reads are done
    load_rows<D>(Ks, k + k_off, k_rs, k0, kBK, sh.s, 1.f);
    load_rows<D>(Vs, v + k_off, k_rs, k0, kBK, sh.s, 1.f);
    __syncthreads();

    float sc[4][2];
    tile_dot<D>(Qs, Ks, tr * 4, tc, sc);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      bool ok[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = sc[i][j];
        if (sh.softcap > 0.f) s = sh.softcap * tanhf(s / sh.softcap);
        sc[i][j] = s;
        ok[j] = visible(qi, k0 + tc + 16 * j, sh);
        if (ok[j]) mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float p[2];
      if (m_new == -INFINITY) {  // no visible key in this row yet
        alpha[i] = 1.f;
        p[0] = p[1] = 0.f;
      } else {
        alpha[i] = expf(m[i] - m_new);  // exp(-inf) = 0 on the first visible tile
#pragma unroll
        for (int j = 0; j < 2; ++j) p[j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
      }
      l[i] = alpha[i] * l[i] + group_sum(p[0] + p[1]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 2; ++j) Ps[(tr * 4 + i) * kLdp + tc + 16 * j] = p[j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * ld + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= sh.s) continue;
    const float lz = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + q_off + (long long)qi * q_rs;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tc + 16 * c] = acc[i][c] / lz;
    if (tc == 0) lse[(long long)bh * sh.s + qi] = m[i] + logf(lz);
  }
}

// p and ds for one (kBQ, kBK) tile from the scores s, dO v^T and the row stats.
__device__ __forceinline__ void probs_and_dscores(float (&sc)[4][2], float (&dp)[4][2],
                                                  const float (&lse_r)[4],
                                                  const float (&delta_r)[4], int q0,
                                                  int k0, int tr, int tc, const Shape& sh) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = sc[i][j], t = 0.f;
      if (sh.softcap > 0.f) {
        t = tanhf(s / sh.softcap);
        s = sh.softcap * t;
      }
      const float p = visible(qi, k0 + tc + 16 * j, sh) ? expf(s - lse_r[i]) : 0.f;
      float ds = p * (dp[i][j] - delta_r[i]);
      if (sh.softcap > 0.f) ds *= 1.f - t * t;
      sc[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

// -- K6: dq pass ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, Shape sh) {
  constexpr int ld = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x ld, scaled
  float* dOs = Qs + kBQ * ld;    // kBQ x ld
  float* Ks = dOs + kBQ * ld;    // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* dSs = Vs + kBK * ld;    // kBQ x kLdp

  const int bh = blockIdx.y, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = blockIdx.x * kBQ;

  load_rows<D>(Qs, q + q_off, q_rs, q0, kBQ, sh.s, sh.scale);
  load_rows<D>(dOs, dout + q_off, q_rs, q0, kBQ, sh.s, 1.f);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    lse_r[i] = qi < sh.s ? lse[(long long)bh * sh.s + qi] : 0.f;
    delta_r[i] = qi < sh.s ? delta[(long long)bh * sh.s + qi] : 0.f;
  }

  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kBK : 0;
  const int kt_last = (min(q0 + kBQ, sh.s) - 1) / kBK;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_rows<D>(Ks, k + k_off, k_rs, k0, kBK, sh.s, 1.f);
    load_rows<D>(Vs, v + k_off, k_rs, k0, kBK, sh.s, 1.f);
    __syncthreads();

    float sc[4][2], dp[4][2];
    tile_dot<D>(Qs, Ks, tr * 4, tc, sc);
    tile_dot<D>(dOs, Vs, tr * 4, tc, dp);
    probs_and_dscores(sc, dp, lse_r, delta_r, q0, k0, tr, tc, sh);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dSs[(tr * 4 + i) * kLdp + tc + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(tr * 4 + i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = Ks[j * ld + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= sh.s) continue;
    float* row = dq + q_off + (long long)qi * q_rs;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tc + 16 * c] = acc[i][c] * sh.scale;
  }
}

// -- K7: dk/dv pass ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
           Shape sh) {
  constexpr int ld = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // kBK x ld
  float* Vs = Ks + kBK * ld;     // kBK x ld
  float* Qs = Vs + kBK * ld;     // kBQ x ld, scaled
  float* dOs = Qs + kBQ * ld;    // kBQ x ld
  float* Ps = dOs + kBQ * ld;    // kBQ x kLdp
  float* dSs = Ps + kBQ * kLdp;  // kBQ x kLdp

  const int bkv = blockIdx.y, b = bkv / sh.kv, kvh = bkv % sh.kv;
  const int g = sh.h / sh.kv;
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int k0 = blockIdx.x * kBK;
  const int k1 = min(k0 + kBK, sh.s) - 1;

  load_rows<D>(Ks, k + k_off, k_rs, k0, kBK, sh.s, 1.f);
  load_rows<D>(Vs, v + k_off, k_rs, k0, kBK, sh.s, 1.f);

  const int qt_first = k0 / kBQ;
  const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : sh.s - 1) / kBQ;

  float acc_k[2][NC], acc_v[2][NC];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[jj][c] = acc_v[jj][c] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
    const long long row_off = ((long long)b * sh.h + h) * sh.s;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the last step's Qs/dOs/Ps/dSs reads are done
      load_rows<D>(Qs, q + q_off, q_rs, q0, kBQ, sh.s, sh.scale);
      load_rows<D>(dOs, dout + q_off, q_rs, q0, kBQ, sh.s, 1.f);
      __syncthreads();

      float lse_r[4], delta_r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + tr * 4 + i;
        lse_r[i] = qi < sh.s ? lse[row_off + qi] : 0.f;
        delta_r[i] = qi < sh.s ? delta[row_off + qi] : 0.f;
      }
      float sc[4][2], dp[4][2];
      tile_dot<D>(Qs, Ks, tr * 4, tc, sc);
      tile_dot<D>(dOs, Vs, tr * 4, tc, dp);
      probs_and_dscores(sc, dp, lse_r, delta_r, q0, k0, tr, tc, sh);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          Ps[(tr * 4 + i) * kLdp + tc + 16 * j] = sc[i][j];
          dSs[(tr * 4 + i) * kLdp + tc + 16 * j] = dp[i][j];
        }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float p[2], ds[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          p[jj] = Ps[r * kLdp + tr * 2 + jj];
          ds[jj] = dSs[r * kLdp + tr * 2 + jj];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float qv = Qs[r * ld + tc + 16 * c];
          const float dov = dOs[r * ld + tc + 16 * c];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc_v[jj][c] = fmaf(p[jj], dov, acc_v[jj][c]);
            acc_k[jj][c] = fmaf(ds[jj], qv, acc_k[jj][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int kj = k0 + tr * 2 + jj;
    if (kj >= sh.s) continue;
    float* krow = dk + k_off + (long long)kj * k_rs;
    float* vrow = dv + k_off + (long long)kj * k_rs;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      krow[tc + 16 * c] = acc_k[jj][c];
      vrow[tc + 16 * c] = acc_v[jj][c];
    }
  }
}

// -- launches ------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kLdp);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kLdp);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kLdp);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const Shape& sh, cudaStream_t st) {
  auto kernel = fwd_kernel<D>;
  constexpr size_t smem = fwd_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((sh.s + kBQ - 1) / kBQ, sh.b * sh.h);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(o),
                                       static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Shape& sh,
              cudaStream_t st) {
  auto kernel = dq_kernel<D>;
  constexpr size_t smem = dq_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((sh.s + kBQ - 1) / kBQ, sh.b * sh.h);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
               cudaStream_t st) {
  auto kernel = dkv_kernel<D>;
  constexpr size_t smem = dkv_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid((sh.s + kBK - 1) / kBK, sh.b * sh.kv);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sh);
  return (int)cudaGetLastError();
}

// Returns LAUNCH<D>(args...) for dtype 0 (float32) and D in {64, 128, 256}.
#define FLASH_DISPATCH(LAUNCH, ...)                                \
  do {                                                             \
    if (dtype == 0 && d == 64) return LAUNCH<64>(__VA_ARGS__);     \
    if (dtype == 0 && d == 128) return LAUNCH<128>(__VA_ARGS__);   \
    if (dtype == 0 && d == 256) return LAUNCH<256>(__VA_ARGS__);   \
    return (int)cudaErrorInvalidValue;                             \
  } while (0)

Shape make_shape(int b, int s, int h, int kv, int window, float softcap, float scale) {
  Shape sh;
  sh.b = b;
  sh.s = s;
  sh.h = h;
  sh.kv = kv;
  sh.window = window;
  sh.softcap = softcap;
  sh.scale = scale;
  return sh;
}

}  // namespace

// Returns a cudaError_t (0 = launched).  window 0 = none, softcap 0 = none;
// dtype 0 (float32) only: bfloat16 runs flash_gqa_sm90.cu's kernels.
extern "C" int flash_gqa_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int dtype, int b, int s, int h, int kv, int d,
                             int window, float softcap, float scale, void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, o, lse, sh, st);
}

extern "C" int flash_gqa_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int dtype, int b, int s, int h, int kv, int d,
                                int window, float softcap, float scale, void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, sh, st);
}

extern "C" int flash_gqa_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int dtype, int b, int s, int h,
                                 int kv, int d, int window, float softcap, float scale,
                                 void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, sh, st);
}

extern "C" const char* flash_gqa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
