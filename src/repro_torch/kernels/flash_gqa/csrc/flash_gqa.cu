// Causal GQA flash attention for Hopper (sm_90a) in f32: forward and two-pass
// backward.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_gqa/kernel.py:
//   K5  flash_gqa_pallas (_flash_kernel, return_residual)    -> flash_gqa_fwd
//   K6  flash_gqa_bwd_pallas, dq pass (_flash_bwd_dq_kernel)  -> flash_gqa_bwd_dq
//   K7  flash_gqa_bwd_pallas, dk/dv pass (_flash_bwd_dkv_kernel) -> flash_gqa_bwd_dkv
// All three take f32 here; bf16 runs their tensor-core versions in
// flash_gqa_sm90.cu.  At head_dim 256 K5-K7 run the SIMT kernels below
// (fwd_kernel, dq_kernel, dkv_kernel: products in f32 on the CUDA cores); at
// head_dim 64, 80 and 128 they run f32-accurate products on the tensor cores
// (three TF32 products each, further down): K5 fwd_tf32_kernel (mma.sync)
// at all three, K6 and K7 dq_wgmma_kernel and dkv_wgmma_kernel at 64,
// dq_tf32_kernel and dkv_tf32_kernel (mma.sync) at 80 and 128.
//
// Layouts are the model's (repro.kernels.flash_gqa.ops.flash_gqa takes them):
//   q, o, dO, dq  (B, S, H, D)     k, v, dk, dv  (B, S, KV, D)     lse, delta (B, H, S) f32
// all contiguous; q/k/v/o/dO/dq/dk/dv all f32.  Query head h reads
// KV head h / (H/KV).  Positions are the canonical arange(S): key j is visible
// to query i iff j <= i and (no window, or i - j < window).  The optional logit
// softcap c applies s = c*tanh(s/c) to the scaled scores before the mask.  K5
// also takes a query offset (a rank of a sequence-parallel prefill): its Sq
// queries (q, o (B, Sq, H, D), lse (B, H, Sq)) sit at positions q0 .. q0 + Sq - 1
// of the S keys (q0 + Sq <= S), masked and tiled on those positions; q0 = 0,
// Sq = S is the plain launch.  K6 and K7 take no offset.
//
//   K5: out = softmax(q k^T * scale) v row by row, online over key tiles, plus
//       lse = m + log(l) per row (the backward's residual).
//   K6: p = exp(s - lse), ds = p * (dO v^T - delta) [* (1 - tanh^2)],
//       dq = scale * ds k.
//   K7: dv = p^T dO, dk = ds^T (scale * q), summed over the G query heads of the
//       KV head and every query tile that sees the key tile.
//   delta = rowsum(dO * out) is computed by the caller, as repro does.
//
// What bounds the SIMT kernels on an H100 SXM: at gemma3-1b's layer (B = 2,
// S = 2048, H = 4, KV = 1, D = 256) the work is 4D flops per visible (query,
// key) pair forward, 6D (dq) and 8D (dk/dv) backward, over ~4-17 MB of f32
// operands: operations set the bound, at three TF32 products a flop on the
// tensor cores (495e12 / 3 FLOP/s; kernels/costs.py).  These kernels do their
// products in f32 on the CUDA cores (67 TFLOP/s at most), so they sit far from
// that bound (5-11 % of it).
//
// What the SIMT design does (at D = 256; the templates take any multiple of
// 16):
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
  int sq, q0;     // queries held and the absolute position of query 0 (K5)
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

// qi, kj: absolute positions.  Rows past the last query (a ragged S) see
// nothing, so they add nothing to dk/dv.
__device__ __forceinline__ bool visible(int qi, int kj, const Shape& sh) {
  return kj <= qi && qi < sh.q0 + sh.sq && (sh.window <= 0 || qi - kj < sh.window);
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
  const long long q_off = ((long long)b * sh.sq * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  // q, o and lse rows are local; masks and key tiles use absolute positions
  const int lq0 = blockIdx.x * kBQ;
  const int q0 = sh.q0 + lq0, q_end = sh.q0 + sh.sq;

  load_rows<D>(Qs, q + q_off, q_rs, lq0, kBQ, sh.sq, sh.scale);

  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kBK : 0;
  const int kt_last = (min(q0 + kBQ, q_end) - 1) / kBK;

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
    if (qi >= q_end) continue;
    const int local = qi - sh.q0;
    const float lz = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + q_off + (long long)local * q_rs;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tc + 16 * c] = acc[i][c] / lz;
    if (tc == 0) lse[(long long)bh * sh.sq + local] = m[i] + logf(lz);
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

// -- K6 and K7 on the tensor cores: mma.sync tf32, three-term split ----------
//
// At head_dim 64, 80 and 128 the f32 dq and dk/dv passes (and K5, below
// them) run their products on the tensor cores and keep f32 accuracy: each
// operand x is split as x = hi + lo, hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest with ties away from zero (the bits of
// cvt.rna.tf32.f32, ``to_tf32``), and a product is taken as lo*hi + hi*lo +
// hi*hi, the small terms first, into the f32 accumulator (about 2^-21
// relative a product; one TF32 product keeps about 2^-11).  K6 and K7 run
// at 64 on wgmma (the section after K5); at 80 and 128 on the kernels
// below, mma.sync.m16n8k8 with tf32 operands.  D = 256 stays on the SIMT
// kernels above: a dispatch by width.
//
// Why mma.sync at 80 and 128: wgmma reads tf32 operands from shared memory
// K-major only (no transpose for 32-bit types), so dq = dS K, dV += P^T dO
// and dK += dS^T Q each want a transposed copy of a streamed tile, and the
// split doubles every copy again: four shared-memory copies of each
// streamed tile, and the block's own rows split into registers.  At 80 and
// 128 those outgrow a thread's registers and the block's shared memory
// (the wgmma kernels at 80 spilled and ran within 2-7 % of these; PERF.md,
// Findings).  mma.sync reads its fragments from registers, loaded from a
// row-major tile as each product wants them (as stored or transposed), and
// the accumulator of one product is the A operand of the next without
// leaving registers.
//
// The accumulator-to-A reuse: an m16n8 f32 accumulator holds (row g, columns
// 2t, 2t + 1) and (row g + 8, the same) of each 8-column tile (g = lane / 4,
// t = lane % 4), where the tf32 A fragment wants (g, t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4).  The sum over the 8 columns of a k-step may run in any
// order, so A's column t is taken as column 2t and t + 4 as 2t + 1, and B's
// rows follow the same order (``mma_ab``): no shuffle, no shared memory.
//
// What bounds them on an H100 SXM: at zamba2's training shape (B 2, S
// 2,048, H = KV = 32, D 80) K6 does 6D and K7 8D flops a visible pair over
// ~40 MB: operations, at three TF32 products a flop, 495e12 / 3 FLOP/s
// (``kernels/costs.py``, ``flash_peak``).  mma.sync runs at about two
// thirds of wgmma's peak, and the kernels at about a quarter of that bound.
//
// Design:
//  - K6: one 256-thread block (8 warps, 16 query rows each) per (batch *
//    head, 128-query tile), the tiles with the most keys launched first.  Q
//    and dO stay resident as f32 (A operands, split a k-step at a time); K
//    and V stream in 64-key tiles (32 at D = 128): cp.async lands tile kt +
//    1 while tile kt is multiplied, then all threads split it into (hi, lo)
//    pairs.  Per warp S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K;
//  - K7: one 256-thread block (8 warps, 16 keys each) per (batch * KV head,
//    128-key block), the blocks with the most queries first: S^T = K Q^T,
//    dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  At D = 128, where
//    dK and dV alone take 128 of a thread's registers (and one warp holding
//    both spilled), a block holds 64 keys and warps w and w + 4 share 16:
//    w computes S^T, P^T and dV, w + 4 dP^T, then dS^T from w's P^T (through
//    shared memory, a barrier of the pair) and dK.  K and V stay resident as
//    f32; Q, dO, the LSE and delta stream in 32-query tiles over the G query
//    heads of the KV head and every query tile that sees the block, in that
//    fixed order (G folded inside, no atomics);
//  - every fragment load hits 32 distinct banks: resident f32 tiles swizzle
//    their 4-float chunks by row at D = 128 (``raw_idx``; rows padded to 84
//    floats at 80); pair tiles pad rows to D + 4 pairs and swap rows 4 <->
//    5 and 6 <-> 7 of every 8 (``pair_idx``), so that rows g (columns t) and
//    rows 2t, 2t + 1 (columns g) both spread over the banks;
//  - a warp whose rows see nothing of a tile (causal, window, past S) skips
//    its products; masked pairs are exact zeros; rows and keys past S load
//    as zeros and are never stored;
//  - the scale multiplies the scores after the product (and dq and dk at
//    the end), where the SIMT kernels scale q as they load it.

// tf32(x) rounded to nearest, ties away from zero: the bits cvt.rna.tf32.f32
// gives for every finite x (the probe compared all 2^32 patterns), in two
// integer operations where the conversion is a slower instruction
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b on one m16n8k8 tile, f32-accurate: lo*hi, hi*lo, then hi*hi;
// b0 and b1 are (hi, lo) pairs.
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], uint2 b0, uint2 b1) {
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.x, b1.x);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.y, b1.y);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.x, b1.x);
}

// Element (r, c) of a resident f32 tile of rows of D columns: at D = 64 and
// 128 its 4-float chunks swizzled by the row, at 80 rows padded to 84.
template <int D>
__device__ __forceinline__ int raw_idx(int r, int c) {
  if constexpr (D % 32 == 0) return r * D + (c ^ ((r & 7) << 2));
  else return r * (D + 4) + c;
}
template <int D>
__host__ __device__ constexpr int raw_ld() {
  return D % 32 == 0 ? D : D + 4;
}

// Element (r, c) of a pair tile: rows D + 4 pairs apart, rows 4 <-> 5 and
// 6 <-> 7 of every 8 swapped.
template <int D>
__device__ __forceinline__ int pair_idx(int r, int c) {
  return (r ^ ((r >> 2) & 1)) * (D + 4) + c;
}

// c[n] += A B^T over D: A the 16 rows a0 .. a0 + 15 of the resident f32 tile
// `a`, B the 8N rows of the pair tile `bt`; c[n] holds B's rows 8n .. 8n + 7.
template <int D, int N>
__device__ __forceinline__ void mma_abt(const float* a, int a0, const uint2* bt,
                                        float (&c)[N][4], int g, int t) {
  const uint2* b = bt + pair_idx<D>(g, t);  // row 8n + g: + 8n (D + 4)
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c0 = 8 * ks + t;
    const Split af[4] = {split(a[raw_idx<D>(a0 + g, c0)]), split(a[raw_idx<D>(a0 + g + 8, c0)]),
                         split(a[raw_idx<D>(a0 + g, c0 + 4)]),
                         split(a[raw_idx<D>(a0 + g + 8, c0 + 4)])};
#pragma unroll
    for (int n = 0; n < N; ++n)
      mma3(c[n], af, b[8 * n * (D + 4) + 8 * ks], b[8 * n * (D + 4) + 8 * ks + 4]);
  }
}

// c[n] += A B: A (16 x 8K) in accumulator layout (a[k] its 8-column tile k),
// B the 8K rows of the pair tile `b`; c[n] the output columns 8n .. 8n + 7.
// A's column t is taken as 2t and t + 4 as 2t + 1 (the accumulator's pair),
// and B's rows in the same order.  These are the long sums (dq over the keys,
// dk and dv over every query of G heads), which the tensor cores' own f32
// accumulation would carry over thousands of k-steps without rounding to
// nearest (biasing dk and dv by ~5e-5 of their largest value on an H100):
// so the K k-steps of one tile (at most 24 products) are summed on the
// tensor cores from zero, for 40 output columns at a time (32 at D = 128:
// registers), and each such partial is added to c in f32, rounded to
// nearest.
template <int D, int K>
__device__ __forceinline__ void mma_ab(const float (&a)[K][4], const uint2* b,
                                       float (&c)[D / 8][4], int g, int t) {
  constexpr int kChunk = D == 80 ? 5 : 4;  // output 8-column tiles a partial
  const uint2* b0 = b + pair_idx<D>(2 * t, g);  // row 8kk + 2t: + 8kk (D + 4)
  const uint2* b1 = b + pair_idx<D>(2 * t + 1, g);
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kChunk) {
    float part[kChunk][4] = {};
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const Split af[4] = {split(a[kk][0]), split(a[kk][2]), split(a[kk][1]), split(a[kk][3])};
#pragma unroll
      for (int n = 0; n < kChunk; ++n)
        mma3(part[n], af, b0[8 * kk * (D + 4) + 8 * (n0 + n)],
             b1[8 * kk * (D + 4) + 8 * (n0 + n)]);
    }
#pragma unroll
    for (int n = 0; n < kChunk; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n0 + n][i] += part[n][i];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads) of `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kDqRows = 128;     // K6: query rows a block, 16 a warp

// K6's key tile: 64 keys, 32 at D = 128 (shared memory)
template <int D>
__host__ __device__ constexpr int dq_tile() {
  return D == 128 ? 32 : 64;
}
// K7: at D = 128 two warps share 16 keys (dK and dV together would take
// 128 of a thread's registers, and spilled), so a block holds 64 keys; at
// 80 each warp holds its 16 keys' dK and dV, a block 128 keys.
template <int D>
__host__ __device__ constexpr bool dkv_pairs() {
  return D == 128;
}
template <int D>
__host__ __device__ constexpr int dkv_keys() {
  return dkv_pairs<D>() ? 64 : 128;
}
// K7's query tile: 32 queries (registers at D = 80, shared memory at 128)
template <int D>
__host__ __device__ constexpr int dkv_tile() {
  return 32;
}

// Rows row0 .. row0 + nrows - 1 of an f32 tensor (rows row_stride apart)
// into dst by cp.async, zeros past S: resident (raw_idx) or landing (rows
// of D floats) layout.
template <int D, bool kResident>
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src,
                                                long long row_stride, int row0, int nrows,
                                                int s) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks), row = row0 + r;
    const bool ok = row < s;
    cp_async16(dst + (kResident ? raw_idx<D>(r, c) : r * D + c),
               src + (long long)(ok ? row : 0) * row_stride + c, ok);
  }
}

// A landed tile (nrows rows of D floats) into (hi, lo) pairs (pair_idx).
template <int D>
__device__ __forceinline__ void split_tile(uint2* dst, const float* src, int nrows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const float4 x = *reinterpret_cast<const float4*>(src + r * D + c);
    const Split s0 = split(x.x), s1 = split(x.y), s2 = split(x.z), s3 = split(x.w);
    uint4* d = reinterpret_cast<uint4*>(dst + pair_idx<D>(r, c));
    d[0] = make_uint4(s0.hi, s0.lo, s1.hi, s1.lo);
    d[1] = make_uint4(s2.hi, s2.lo, s3.hi, s3.lo);
  }
}

// p and ds of K6's 16 x 8N tile in accumulator layout, in place (sc -> p, dp
// -> ds): element i of tile n at query row0 + g (+ 8 for i >= 2), key col0 +
// 8n + 2t (+ 1 for odd i); lse_r / delta_r the stats of the rows g, g + 8.
template <int N>
__device__ __forceinline__ void dscores_tc(float (&sc)[N][4], float (&dp)[N][4], int row0,
                                           int col0, int g, int t, const Shape& sh,
                                           const float (&lse_r)[2], const float (&delta_r)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = row0 + g + 8 * (i >> 1), kj = col0 + 8 * n + 2 * t + (i & 1);
      float s = sc[n][i] * sh.scale, th = 0.f;
      if (sh.softcap > 0.f) {
        th = tanhf(s / sh.softcap);
        s = sh.softcap * th;
      }
      const float p = visible(qi, kj, sh) ? __expf(s - lse_r[i >> 1]) : 0.f;
      float ds = p * (dp[n][i] - delta_r[i >> 1]);
      if (sh.softcap > 0.f) ds *= 1.f - th * th;
      sc[n][i] = p;
      dp[n][i] = ds;
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, Shape sh) {
  constexpr int BK = dq_tile<D>(), NK = BK / 8, NC = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // kDqRows resident rows
  float* dOs = Qs + kDqRows * raw_ld<D>();
  float* land = dOs + kDqRows * raw_ld<D>();  // K, V: BK x D each, as they land
  uint2* Kp = reinterpret_cast<uint2*>(land + 2 * BK * D);  // BK x (D + 4) pairs
  uint2* Vp = Kp + BK * (D + 4);

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // the most keys first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;  // this warp's first row

  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / BK : 0;
  const int kt_last = (min(q0 + kDqRows, sh.s) - 1) / BK;
  auto land_kv = [&](int kt) {
    load_rows_async<D, false>(land, k + k_off, k_rs, kt * BK, BK, sh.s);
    load_rows_async<D, false>(land + BK * D, v + k_off, k_rs, kt * BK, BK, sh.s);
    cp_commit();
  };
  load_rows_async<D, true>(Qs, q + q_off, q_rs, q0, kDqRows, sh.s);
  load_rows_async<D, true>(dOs, dout + q_off, q_rs, q0, kDqRows, sh.s);
  land_kv(kt_first);  // one group with Q and dO

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + g + 8 * i;
    lse_r[i] = qi < sh.s ? lse[(long long)bh * sh.s + qi] : 0.f;
    delta_r[i] = qi < sh.s ? delta[(long long)bh * sh.s + qi] : 0.f;
  }

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with the last pairs
    split_tile<D>(Kp, land, BK);
    split_tile<D>(Vp, land + BK * D, BK);
    __syncthreads();  // the pairs are written; the landing buffer is free
    if (kt < kt_last) land_kv(kt + 1);
    const int k0 = kt * BK;
    // warp-uniform: do this warp's 16 rows see any key of the tile?
    if (qw < sh.s && k0 <= qw + 15 &&
        (sh.window <= 0 || k0 + BK - 1 >= qw - sh.window + 1)) {
      float sc[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
      mma_abt<D, NK>(Qs, 16 * warp, Kp, sc, g, t);   // S = Q K^T
      mma_abt<D, NK>(dOs, 16 * warp, Vp, dp, g, t);  // dP = dO V^T
      dscores_tc<NK>(sc, dp, qw, k0, g, t, sh, lse_r, delta_r);
      mma_ab<D, NK>(dp, Kp, acc, g, t);  // dQ += dS K
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + g + 8 * i;
    if (qi >= sh.s) continue;
    float* row = dq + q_off + (long long)qi * q_rs;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * sh.scale, acc[n][2 * i + 1] * sh.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  constexpr bool kPairs = dkv_pairs<D>();
  constexpr int BQ = dkv_tile<D>(), NQ = BQ / 8, NC = D / 8, kKeys = dkv_keys<D>();
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                           // kKeys resident rows
  float* Vs = Ks + kKeys * raw_ld<D>();
  float* land = Vs + kKeys * raw_ld<D>();     // Q, dO: BQ x D each, then LSE, delta
  float* stats = land + 2 * BQ * D + 2 * BQ;  // LSE, delta of the tile multiplied
  float4* pex = reinterpret_cast<float4*>(stats + 2 * BQ);  // pairs: each one's P^T, by lane
  uint2* Qp = reinterpret_cast<uint2*>(pex + (kPairs ? kKeys / 16 * NQ * 32 : 0));
  uint2* dOp = Qp + BQ * (D + 4);             // BQ x (D + 4) pairs each

  const int bkv = blockIdx.x, b = bkv / sh.kv, kvh = bkv % sh.kv;
  const int grp = sh.h / sh.kv;
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int k0 = blockIdx.y * kKeys;  // block 0 sees every query: the most work first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // 16 keys a warp; with pairs, warps w and w + 4 share them: w computes
  // S^T, P^T and dV, w + 4 dP^T, dS^T and dK
  const int group = warp % (kKeys / 16), role = warp / (kKeys / 16);
  const int kw = k0 + 16 * group;
  const int k1 = min(k0 + kKeys, sh.s) - 1;
  const int qt_first = k0 / BQ;
  const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : sh.s - 1) / BQ;
  const int nqt = qt_last - qt_first + 1, items = grp * nqt;

  // item j: query head kvh * G + j / nqt, query tile qt_first + j % nqt
  auto land_item = [&](int j) {
    const int h = kvh * grp + j / nqt, q0 = (qt_first + j % nqt) * BQ;
    const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
    load_rows_async<D, false>(land, q + q_off, q_rs, q0, BQ, sh.s);
    load_rows_async<D, false>(land + BQ * D, dout + q_off, q_rs, q0, BQ, sh.s);
    if (threadIdx.x < 2 * BQ) {  // thread r: row r % BQ of the LSE (r < BQ) or delta
      const int qi = q0 + threadIdx.x % BQ;
      const float* rows = (threadIdx.x < BQ ? lse : delta) + ((long long)b * sh.h + h) * sh.s;
      cp_async4(land + 2 * BQ * D + threadIdx.x, rows + (qi < sh.s ? qi : 0), qi < sh.s);
    }
    cp_commit();
  };
  load_rows_async<D, true>(Ks, k + k_off, k_rs, k0, kKeys, sh.s);
  load_rows_async<D, true>(Vs, v + k_off, k_rs, k0, kKeys, sh.s);
  land_item(0);  // one group with K and V

  // rows kw + g (+ 8): dV (a pair's role 0, or a single warp) and dK (a
  // pair's role 1 in acc, or a single warp's acc_k)
  float acc[NC][4], acc_k[kPairs ? 1 : NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = acc_k[kPairs ? 0 : n][i] = 0.f;

  for (int j = 0; j < items; ++j) {
    cp_wait_all();
    __syncthreads();  // item j landed; every warp is done with the last pairs and P^T
    split_tile<D>(Qp, land, BQ);
    split_tile<D>(dOp, land + BQ * D, BQ);
    if (threadIdx.x < 2 * BQ) stats[threadIdx.x] = land[2 * BQ * D + threadIdx.x];
    __syncthreads();  // the pairs and stats are written; the landing buffer is free
    if (j + 1 < items) land_item(j + 1);
    const int q0 = (qt_first + j % nqt) * BQ;
    // warp-uniform (and the same for both warps of a pair): does any query
    // of the tile see the 16 keys?
    if (!(kw < sh.s && q0 < sh.s && q0 + BQ - 1 >= kw &&
          (sh.window <= 0 || q0 <= kw + 15 + sh.window - 1)))
      continue;
    float f[NQ][4], dp[kPairs ? 1 : NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) f[n][i] = dp[kPairs ? 0 : n][i] = 0.f;
    float4* ex = pex + group * NQ * 32 + lane;  // pairs: this lane's P^T, tile n at 32 n
    if (role == 0) {
      mma_abt<D, NQ>(Ks, 16 * group, Qp, f, g, t);  // S^T = K Q^T
      if constexpr (!kPairs) mma_abt<D, NQ>(Vs, 16 * group, dOp, dp, g, t);  // dP^T
      // P^T = exp(s - lse) on the visible pairs; dS^T = P^T (dP^T - delta)
      // times the softcap's chain factor 1 - tanh^2 (a pair's other warp
      // takes P^T times that factor)
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        float pf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = kw + g + 8 * (i >> 1), c = 8 * n + 2 * t + (i & 1);
          float s = f[n][i] * sh.scale, th = 0.f;
          if (sh.softcap > 0.f) {
            th = tanhf(s / sh.softcap);
            s = sh.softcap * th;
          }
          f[n][i] = visible(q0 + c, kj, sh) ? __expf(s - stats[c]) : 0.f;
          pf[i] = sh.softcap > 0.f ? f[n][i] * (1.f - th * th) : f[n][i];
          if constexpr (!kPairs) dp[n][i] = pf[i] * (dp[n][i] - stats[BQ + c]);
        }
        if constexpr (kPairs) ex[32 * n] = make_float4(pf[0], pf[1], pf[2], pf[3]);
      }
      if constexpr (kPairs) named_sync(1 + group, 64);
      mma_ab<D, NQ>(f, dOp, acc, g, t);  // dV += P^T dO
      if constexpr (!kPairs) mma_ab<D, NQ>(dp, Qp, acc_k, g, t);  // dK += dS^T Q
    } else if constexpr (kPairs) {
      mma_abt<D, NQ>(Vs, 16 * group, dOp, f, g, t);  // dP^T = V dO^T
      named_sync(1 + group, 64);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float4 pf = ex[32 * n];
        const int c = 8 * n + 2 * t;
        f[n][0] = pf.x * (f[n][0] - stats[BQ + c]);
        f[n][1] = pf.y * (f[n][1] - stats[BQ + c + 1]);
        f[n][2] = pf.z * (f[n][2] - stats[BQ + c]);
        f[n][3] = pf.w * (f[n][3] - stats[BQ + c + 1]);
      }
      mma_ab<D, NQ>(f, Qp, acc, g, t);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kw + g + 8 * i;
    if (kj >= sh.s) continue;
    const long long row = k_off + (long long)kj * k_rs;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float2 a = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (kPairs && role == 1) {
        *reinterpret_cast<float2*>(dk + row + 8 * n + 2 * t) =
            make_float2(a.x * sh.scale, a.y * sh.scale);
      } else {
        *reinterpret_cast<float2*>(dv + row + 8 * n + 2 * t) = a;
      }
      if constexpr (!kPairs)
        *reinterpret_cast<float2*>(dk + row + 8 * n + 2 * t) =
            make_float2(acc_k[n][2 * i] * sh.scale, acc_k[n][2 * i + 1] * sh.scale);
    }
  }
}

// -- K5 on the tensor cores: mma.sync tf32, three-term split -----------------
//
// At head_dim 64, 80 and 128 the f32 forward runs its two products, S = Q
// K^T and O += P V, on the tensor cores with the same split as K6 and K7
// (``mma3``: lo*hi + hi*lo + hi*hi a product), so it keeps f32 accuracy.
// What bounds it on an H100 SXM: 4D flops a visible pair over ~10-40 MB at
// the training shapes, operations at three TF32 products a flop (495e12 / 3
// FLOP/s), as K6 and K7.  Design, K6's (``dq_tf32_kernel``) with one
// product fewer:
//  - one 256-thread block (8 warps, 16 query rows each) per (batch * head,
//    128-query tile), the tiles with the most keys launched first; Q stays
//    resident as f32 (``raw_idx``), split a k-step at a time inside
//    ``mma_abt``; K and V stream in K6's 64-key tiles (32 at D = 128): cp.async
//    lands tile kt + 1 while tile kt is multiplied, and all threads split
//    each landed tile once into (hi, lo) pairs;
//  - per warp S = Q K^T (``mma_abt``), scaled after the product, then the
//    softcap, then the mask: masked scores are -inf and become exact zeros
//    in P without entering exp; the online softmax stays in registers (each
//    row's max and sum over the 4 lanes holding it, xor shuffles in one
//    fixed order); O <- alpha O + P V, P taken from the accumulator layout
//    as the A operand (``mma_ab``: each tile's products summed from zero on
//    the tensor cores, then added in f32, the long-sum rule of K6 and K7);
//  - a warp whose 16 rows see nothing of a tile skips its products; rows
//    and keys past the ends load as zeros and are never stored; tiles and
//    masks are on absolute positions, so at a query offset that is a
//    multiple of 128 each row is bitwise the row of the launch without one.

// One key tile of the online softmax for a warp's 16 x 8N score tile in
// accumulator layout (as ``dscores_tc``'s; rows row0 + g and + 8, keys col0
// + 8n + 2t (+ 1)), in place (sc -> p): the rows' max m and sum l move to
// this tile and the output rows o are rescaled by exp(m_old - m_new).
template <int N, int NC>
__device__ __forceinline__ void softmax_tc(float (&sc)[N][4], float (&m)[2], float (&l)[2],
                                           float (&o)[NC][4], int row0, int col0, int g,
                                           int t, const Shape& sh) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = row0 + g + 8 * (i >> 1), kj = col0 + 8 * n + 2 * t + (i & 1);
      float s = sc[n][i] * sh.scale;
      if (sh.softcap > 0.f) s = sh.softcap * tanhf(s / sh.softcap);
      sc[n][i] = visible(qi, kj, sh) ? s : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row that has seen no visible key keeps m = -inf, l = 0, alpha = 1
    alpha[r] = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = sc[n][i];
      sc[n][i] = s == -INFINITY ? 0.f : __expf(s - m[i >> 1]);
      sum[i >> 1] += sc[n][i];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = alpha[r] * l[r] + sum[r];
  }
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                Shape sh) {
  constexpr int BK = dq_tile<D>(), NK = BK / 8, NC = D / 8;  // K6's key tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // kDqRows resident rows
  float* land = Qs + kDqRows * raw_ld<D>();  // K, V: BK x D each, as they land
  uint2* Kp = reinterpret_cast<uint2*>(land + 2 * BK * D);  // BK x (D + 4) pairs
  uint2* Vp = Kp + BK * (D + 4);

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long q_off = ((long long)b * sh.sq * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  // q, o and lse rows are local; masks and key tiles use absolute positions
  const int lq0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;  // the most keys first
  const int q0 = sh.q0 + lq0, q_end = sh.q0 + sh.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;  // this warp's first row

  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / BK : 0;
  const int kt_last = (min(q0 + kDqRows, q_end) - 1) / BK;
  auto land_kv = [&](int kt) {
    load_rows_async<D, false>(land, k + k_off, k_rs, kt * BK, BK, sh.s);
    load_rows_async<D, false>(land + BK * D, v + k_off, k_rs, kt * BK, BK, sh.s);
    cp_commit();
  };
  load_rows_async<D, true>(Qs, q + q_off, q_rs, lq0, kDqRows, sh.sq);
  land_kv(kt_first);  // one group with Q

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with the last pairs
    split_tile<D>(Kp, land, BK);
    split_tile<D>(Vp, land + BK * D, BK);
    __syncthreads();  // the pairs are written; the landing buffer is free
    if (kt < kt_last) land_kv(kt + 1);
    const int k0 = kt * BK;
    // warp-uniform: do this warp's 16 rows see any key of the tile?
    if (qw < q_end && k0 <= qw + 15 &&
        (sh.window <= 0 || k0 + BK - 1 >= qw - sh.window + 1)) {
      float sc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      mma_abt<D, NK>(Qs, 16 * warp, Kp, sc, g, t);  // S = Q K^T
      softmax_tc<NK, NC>(sc, m, l, acc, qw, k0, g, t, sh);
      mma_ab<D, NK>(sc, Vp, acc, g, t);  // O += P V
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qw + g + 8 * i;
    if (qi >= q_end) continue;
    const int local = qi - sh.q0;
    const float lz = l[i] == 0.f ? 1.f : l[i];
    float* row = o + q_off + (long long)local * q_rs;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] / lz, acc[n][2 * i + 1] / lz);
    if (t == 0) lse[(long long)bh * sh.sq + local] = m[i] + logf(lz);
  }
}

// -- K6 and K7 at head_dim 64 on wgmma: three-term TF32 split ----------------
//
// At head_dim 64 the dq and dk/dv passes run their products as wgmma
// (m64nNk8, tf32 operands, f32 accumulators), each product f32-accurate by
// the same three-term split as above.  wgmma reads a tf32 operand from
// shared memory K-major only, so a streamed tile that is a B operand both as
// stored and transposed is written twice: K7 multiplies Q as stored (S^T =
// K Q^T) and transposed (dK += dS^T Q), and dO as stored (dP^T = V dO^T)
// and transposed (dV += P^T dO); K6 multiplies K as stored (S = Q K^T) and
// transposed (dQ += dS K), and V as stored (dP = dO V^T).  Each copy is
// split into hi and lo, 128-byte swizzled.
//
// Design of both: one 384-thread block of three warpgroups with mbarriers
// between them, over one 64-row block (K7: 64 keys of a KV head; K6: 64
// queries of a head; wgmma's M), the blocks with the most work first:
//  - the producer (warpgroup 0) loads each 32-row tile it streams (K7: Q
//    and dO, over the G query heads then every query tile that sees the
//    block; K6: K and V, over every key tile the block sees: the fixed
//    order of the mma.sync kernels, no atomics, bitwise run to run) and
//    writes its copies into a ring of kWgStages stages, with the LSE and
//    delta rows of K7's query tile; its loads for the next tile start
//    before it writes this one;
//  - the scores warpgroup (1) holds the block's own rows (K7: K and V; K6:
//    Q and dO) split into A fragments in registers, but for the second
//    one's lo half, a tile in shared memory (all four halves would outgrow
//    a thread's 168 registers and spill), takes S^T and dP^T (K6: S and dP;
//    m64n32k8, three wgmmas a k-step each), forms P^T and dS^T (K6: dS; the
//    mask, the LSE and delta, the softcap's chain factor) and hands them to
//    the next warpgroup through one of two exchange buffers, in the
//    accumulators' own layout;
//  - the gradients warpgroup (2) splits them into A fragments and takes dV
//    += P^T dO and dK += dS^T Q (K6: dQ += dS K; m64n64k8), each tile's 12
//    products summed on the tensor cores from zero, then added in f32, as
//    mma_ab does (the long sums; dK's products run while dV's part is
//    added).  Accumulator column 2t is A's column t and 2t + 1 is t + 4, so
//    the producer writes each transposed row's 8 entries in the order 0, 2,
//    4, 6, 1, 3, 5, 7;
//  - rows past S load as zeros; masked pairs are exact zeros.
//
// At head_dim 80 the same design spilled (the split fragments of two 80-
// column tiles outgrow a thread's 168 registers, and a third stage or the
// lo tiles outgrow shared memory) and ran within 2-7 % of the mma.sync
// kernels (PERF.md, Findings), so 80 stays on them, as 128 does.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// Orders this thread's shared-memory writes before wgmma's reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b),
               "r"(c), "r"(d)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand, 128-byte swizzle:
// rows of 32 tf32 values, sbo = 1024 (the next 8 rows); a k8 step adds 32
// bytes inside the row.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins the accumulator registers in place around an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = [d +] A B: A (64 x 8, tf32) from registers, a0 .. a3 =
// (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of warp w's 16 rows;
// B (8 x N) K-major in shared memory.  The accumulator: d[4n + 2 rho + j] =
// (16 w + g + 8 rho, 8 n + 2 t + j).
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same with A (64 x 8) K-major in shared memory too, N = 32.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

constexpr int kWgThreads = 384;  // the producer and two consumer warpgroups
constexpr int kWgKeys = 64;      // rows of a block (K7: keys; K6: queries): wgmma's M
constexpr int kWgQ = 32;         // rows of a streamed tile (K7: queries; K6: keys)
constexpr int kWgStages = 2;

// Byte offset of element (r, c) in a 128-byte-swizzled block of rows of 32
// values: the 16-byte chunk c / 4 XORed with r % 8.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}
// Byte offset of element (r, c) of a K-major tile of `rows` rows of D
// columns: D / 32 blocks of `rows` 128-byte rows.
__device__ __forceinline__ uint32_t kmajor(int rows, int r, int c) {
  return (c >> 5) * (rows * 128) + sw128(r, c & 31);
}

// The producers' unit: a 4 x 4 block of a streamed tile, columns c0 .. c0 +
// 3 of the rows 8 grp8 + par + 2 r (r = 0 .. 3), whose transposed places
// are the contiguous 8 grp8 + 4 par + r.  Rows at or past s load as zeros.
__device__ __forceinline__ void load_unit(float4 (&val)[4], const float* src, long long rs,
                                          int row0, int s) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 2 * r;
    val[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s) val[r] = __ldg(reinterpret_cast<const float4*>(src + row * rs));
  }
}
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// The unit split into hi and lo, written as stored at rows (lo at rows +
// lo_rows; kWgQ rows of D columns) and, with `transposed`, at cols (lo at
// cols + lo_cols; rows of kWgQ entries, one a column); each 4 values split
// where written.
__device__ __forceinline__ void store_unit(const float4 (&val)[4], uint32_t rows, uint32_t lo_rows,
                                           uint32_t cols, uint32_t lo_cols, int grp8, int par,
                                           int c0, bool transposed) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Split a = split(val[r].x), b = split(val[r].y), c = split(val[r].z), d = split(val[r].w);
    const uint32_t off = kmajor(kWgQ, 8 * grp8 + par + 2 * r, c0);
    st_shared4(rows + off, a.hi, b.hi, c.hi, d.hi);
    st_shared4(rows + lo_rows + off, a.lo, b.lo, c.lo, d.lo);
  }
  if (!transposed) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split a = split(lane4(val[0], i)), b = split(lane4(val[1], i));
    const Split c = split(lane4(val[2], i)), d = split(lane4(val[3], i));
    const uint32_t off = sw128(c0 + i, 8 * grp8 + 4 * par);
    st_shared4(cols + off, a.hi, b.hi, c.hi, d.hi);
    st_shared4(cols + lo_cols + off, a.lo, b.lo, c.lo, d.lo);
  }
}

// The scores warpgroup's own rows row0 .. row0 + 63 of a tensor (rows rs
// floats apart, zeros past s): their hi halves as A fragments (hi[ks] the
// k-step ks of this thread's rows 16 w + g, + 8) and their lo halves the
// same (``own_frags``), or (``own_rows``) as a K-major tile at lo, written
// by the warpgroup's 128 threads and fenced for wgmma (the caller syncs the
// warpgroup before reading it).
template <int D>
__device__ __forceinline__ void own_frags(uint32_t (&hi)[D / 8][4], uint32_t (&lo)[D / 8][4],
                                          const float* src, long long rs, int row0, int s,
                                          int tid) {
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 16 * w + g + 8 * (i & 1), col = 8 * ks + t + 2 * (i & 2);
      const Split x = split(row < s ? src[row * rs + col] : 0.f);
      hi[ks][i] = x.hi;
      lo[ks][i] = x.lo;
    }
}
template <int D>
__device__ __forceinline__ void own_rows(uint32_t (&hi)[D / 8][4], uint32_t lo, const float* src,
                                         long long rs, int row0, int s, int tid) {
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 16 * w + g + 8 * (i & 1), col = 8 * ks + t + 2 * (i & 2);
      hi[ks][i] = to_tf32(row < s ? src[row * rs + col] : 0.f);
    }
  for (int i = tid; i < kWgKeys * D / 4; i += 128) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4)), row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s) x = __ldg(reinterpret_cast<const float4*>(src + row * rs + c));
    st_shared4(lo + kmajor(kWgKeys, r, c), split(x.x).lo, split(x.y).lo, split(x.z).lo,
               split(x.w).lo);
  }
  fence_async_shared();
}

template <int D>
struct DkvWgLayout {
  static constexpr int kRows = kWgQ * D * 4;  // a streamed tile as stored: a row per query
  static constexpr int kCols = D * 128;       // transposed: a row per column
  static constexpr int kStage = 4 * kRows + 4 * kCols;  // Q hi, lo; dO hi, lo; then transposed
  static constexpr int kLo = kWgStages * kStage;        // V's lo tile
  static constexpr int kStats = kLo + kWgKeys * D * 4;  // each stage's LSE and delta rows
  static constexpr int kExch = kStats + kWgStages * 2 * kWgQ * 4;
  static constexpr int kBars = kExch + 2 * 128 * 32 * 4;  // two exchange buffers
  static constexpr int kBytes = kBars + (2 * kWgStages + 4) * 8 + 1024;  // + alignment slack
  static_assert(D % 32 == 0 && kRows % 1024 == 0 && kCols % 1024 == 0, "swizzle atoms");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkv_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  using L = DkvWgLayout<D>;
  constexpr int KS = D / 8;  // k-steps of S^T and dP^T
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023) & ~1023u;
  uint8_t* gbase = wg_smem + (base - smem_u32(wg_smem));
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };
  auto xfull = [&](int b) { return bars + 8 * (2 * kWgStages + b); };
  auto xempty = [&](int b) { return bars + 8 * (2 * kWgStages + 2 + b); };

  const int bkv = blockIdx.x, b = bkv / sh.kv, kvh = bkv % sh.kv;
  const int grp = sh.h / sh.kv;
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int k0 = blockIdx.y * kWgKeys;  // block 0 sees every query: the most work first
  const int k1 = min(k0 + kWgKeys, sh.s) - 1;
  const int qt_first = k0 / kWgQ;
  const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : sh.s - 1) / kWgQ;
  const int nqt = qt_last - qt_first + 1, items = grp * nqt;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 256);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull(i), 128);
      mbar_init(xempty(i), 128);
    }
  }
  __syncthreads();

  if (wg == 0) {  // producer
    // Units 0 .. kSubs - 1 are Q's tile's (``load_unit``), then dO's;
    // thread tid takes units tid + 128 u
    constexpr int kSubs = (kWgQ / 8) * 2 * (D / 4);
    constexpr int kU = 2 * kSubs / 128;
    static_assert(kU * 128 == 2 * kSubs, "whole units a thread");
    auto load = [&](int j, float4 (&val)[kU][4], float& stat) {
      const int h = kvh * grp + j / nqt, q0 = (qt_first + j % nqt) * kWgQ;
      const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int unit = tid + 128 * u, x = unit / kSubs, sb = unit % kSubs;
        const int cg = sb % (D / 4), par = (sb / (D / 4)) & 1, grp8 = sb / (D / 2);
        load_unit(val[u], (x == 0 ? q : dout) + q_off + 4 * cg, q_rs, q0 + 8 * grp8 + par,
                  sh.s);
      }
      if (tid < 2 * kWgQ) {  // thread r: the LSE (r < 32) or delta of query q0 + r % 32
        const int qi = q0 + tid % kWgQ;
        const float* row = (tid < kWgQ ? lse : delta) + ((long long)b * sh.h + h) * sh.s;
        stat = qi < sh.s ? row[qi] : 0.f;
      }
    };
    // hi and lo as stored (a row per query) and transposed (a row per column)
    auto store = [&](int s, const float4 (&val)[kU][4], float stat) {
      const uint32_t st = base + s * L::kStage;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int unit = tid + 128 * u, x = unit / kSubs, sb = unit % kSubs;
        const int cg = sb % (D / 4), par = (sb / (D / 4)) & 1, grp8 = sb / (D / 2);
        store_unit(val[u], st + 2 * x * L::kRows, L::kRows, st + 4 * L::kRows + 2 * x * L::kCols,
                   L::kCols, grp8, par, 4 * cg, true);
      }
      if (tid < 2 * kWgQ)
        reinterpret_cast<float*>(gbase + L::kStats)[s * 2 * kWgQ + tid] = stat;
    };
    float4 cur[kU][4], nxt[kU][4];
    float st_cur = 0.f, st_nxt = 0.f;
    load(0, cur, st_cur);
    for (int j = 0; j < items; ++j) {
      const int s = j % kWgStages;
      mbar_wait(empty(s), ((j / kWgStages) & 1) ^ 1);
      if (j + 1 < items) load(j + 1, nxt, st_nxt);
      store(s, cur, st_cur);
      fence_async_shared();
      mbar_arrive(full(s));
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[u][r] = nxt[u][r];
      st_cur = st_nxt;
    }
    return;
  }

  const int kr = k0 + 16 * w + g;  // this thread's key rows kr, kr + 8
  float4* exch = reinterpret_cast<float4*>(gbase + L::kExch);

  if (wg == 1) {  // scores: S^T, dP^T, then P^T and dS^T
    const uint32_t v_lo = base + L::kLo;
    uint32_t kh[KS][4], kl[KS][4], vh[KS][4];
    own_frags<D>(kh, kl, k + k_off, k_rs, k0, sh.s, tid);
    own_rows<D>(vh, v_lo, v + k_off, k_rs, k0, sh.s, tid);
    named_sync(1, 128);
    auto vl = [&](int ks) { return desc128(v_lo + (ks >> 2) * (kWgKeys * 128) + (ks & 3) * 32); };
    for (int j = 0; j < items; ++j) {
      const int s = j % kWgStages;
      const int q0 = (qt_first + j % nqt) * kWgQ;
      const uint32_t st = base + s * L::kStage;
      mbar_wait(full(s), (j / kWgStages) & 1);
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks >> 2) * (kWgQ * 128) + (ks & 3) * 32;
        const uint64_t qh = desc128(st + off), ql = desc128(st + L::kRows + off);
        const uint64_t oh = desc128(st + 2 * L::kRows + off), ol = desc128(st + 3 * L::kRows + off);
        wgmma_tf32<32>(sc, kl[ks], qh, ks > 0);
        wgmma_tf32<32>(sc, kh[ks], ql, 1);
        wgmma_tf32<32>(sc, kh[ks], qh, 1);
        wgmma_tf32_ss(dp, vl(ks), oh, ks > 0);
        wgmma_tf32<32>(dp, vh[ks], ol, 1);
        wgmma_tf32<32>(dp, vh[ks], oh, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);
      // P^T = exp(s - lse) on the visible pairs; dS^T = P^T (dP^T - delta)
      // times the softcap's chain factor 1 - tanh^2; the stage's LSE and
      // delta rows are read here, and the stage freed after
      const float* stats = reinterpret_cast<const float*>(gbase + L::kStats) + s * 2 * kWgQ;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 4 * n + i, kj = kr + 8 * (i >> 1), c = 8 * n + 2 * t + (i & 1);
          float sv = sc[x] * sh.scale, th = 0.f;
          if (sh.softcap > 0.f) {
            th = tanhf(sv / sh.softcap);
            sv = sh.softcap * th;
          }
          const float p = visible(q0 + c, kj, sh) ? __expf(sv - stats[c]) : 0.f;
          float ds = p * (dp[x] - stats[kWgQ + c]);
          if (sh.softcap > 0.f) ds *= 1.f - th * th;
          sc[x] = p;
          dp[x] = ds;
        }
      mbar_arrive(empty(s));
      const int xb = j & 1;
      mbar_wait(xempty(xb), ((j >> 1) & 1) ^ 1);
      float4* dst = exch + xb * 8 * 128 + tid;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        dst[128 * n] = make_float4(sc[4 * n], sc[4 * n + 1], sc[4 * n + 2], sc[4 * n + 3]);
        dst[128 * (4 + n)] = make_float4(dp[4 * n], dp[4 * n + 1], dp[4 * n + 2], dp[4 * n + 3]);
      }
      mbar_arrive(xfull(xb));
    }
    return;
  }

  // gradients: dV += P^T dO, then dK += dS^T Q, each tile's products in a
  // part of their own; dK's run while dV's part is added
  float gv[D / 2], gk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gv[i] = gk[i] = 0.f;
  for (int j = 0; j < items; ++j) {
    const int s = j % kWgStages, xb = j & 1;
    const uint32_t st = base + s * L::kStage;
    mbar_wait(full(s), (j / kWgStages) & 1);
    mbar_wait(xfull(xb), (j >> 1) & 1);
    const float4* src = exch + xb * 8 * 128 + tid;
    uint32_t ah[4][4], al[4][4];
    auto split_a = [&](int m) {  // P^T (m = 0) or dS^T from the exchange, as A fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 e = src[128 * (4 * m + kk)];
        const float a[4] = {e.x, e.z, e.y, e.w};  // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Split sp = split(a[i]);
          ah[kk][i] = sp.hi;
          al[kk][i] = sp.lo;
        }
      }
    };
    auto products = [&](float (&part)[D / 2], uint32_t bt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bh = desc128(bt + 32 * kk), bl = desc128(bt + L::kCols + 32 * kk);
        wgmma_tf32<D>(part, al[kk], bh, kk > 0);
        wgmma_tf32<D>(part, ah[kk], bl, 1);
        wgmma_tf32<D>(part, ah[kk], bh, 1);
      }
      wgmma_commit();
    };
    float pv[D / 2], pk[D / 2];
    split_a(0);
    wgmma_fence();
    products(pv, st + 4 * L::kRows + 2 * L::kCols);  // dV += P^T dO: dO transposed
    wgmma_wait0();
    fence_regs(pv);
    split_a(1);
    mbar_arrive(xempty(xb));
    wgmma_fence();
    products(pk, st + 4 * L::kRows);  // dK += dS^T Q: Q transposed
#pragma unroll
    for (int i = 0; i < D / 2; ++i) gv[i] += pv[i];
    wgmma_wait0();
    fence_regs(pk);
    mbar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) gk[i] += pk[i];
  }
#pragma unroll
  for (int rho = 0; rho < 2; ++rho) {
    const int kj = kr + 8 * rho;
    if (kj >= sh.s) continue;
    const long long row = k_off + (long long)kj * k_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int x = 4 * n + 2 * rho;
      *reinterpret_cast<float2*>(dv + row + 8 * n + 2 * t) = make_float2(gv[x], gv[x + 1]);
      *reinterpret_cast<float2*>(dk + row + 8 * n + 2 * t) =
          make_float2(gk[x] * sh.scale, gk[x + 1] * sh.scale);
    }
  }
}

template <int D>
struct DqWgLayout {
  static constexpr int kRows = kWgQ * D * 4;  // a streamed key tile as stored
  static constexpr int kCols = D * 128;       // K's transposed
  static constexpr int kStage = 4 * kRows + 2 * kCols;  // K hi, lo; V hi, lo; K^T hi, lo
  static constexpr int kLo = kWgStages * kStage;        // dO's lo tile
  static constexpr int kExch = kLo + kWgKeys * D * 4;
  static constexpr int kBars = kExch + 2 * 128 * 16 * 4;  // two exchange buffers of dS
  static constexpr int kBytes = kBars + (2 * kWgStages + 4) * 8 + 1024;
  static_assert(D % 32 == 0 && kRows % 1024 == 0 && kCols % 1024 == 0, "swizzle atoms");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, Shape sh) {
  using L = DqWgLayout<D>;
  constexpr int KS = D / 8;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023) & ~1023u;
  uint8_t* gbase = wg_smem + (base - smem_u32(wg_smem));
  const uint32_t bars = base + L::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };
  auto xfull = [&](int b) { return bars + 8 * (2 * kWgStages + b); };
  auto xempty = [&](int b) { return bars + 8 * (2 * kWgStages + 2 + b); };

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const long long q_rs = (long long)sh.h * D, k_rs = (long long)sh.kv * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const long long k_off = ((long long)b * sh.s * sh.kv + kvh) * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgKeys;  // the most keys first
  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kWgQ : 0;
  const int kt_last = (min(q0 + kWgKeys, sh.s) - 1) / kWgQ;
  const int items = kt_last - kt_first + 1;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 256);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull(i), 128);
      mbar_init(xempty(i), 128);
    }
  }
  __syncthreads();

  if (wg == 0) {  // producer: K's units (0 .. kSubs - 1) and V's, as K7's Q's and dO's
    constexpr int kSubs = (kWgQ / 8) * 2 * (D / 4);
    constexpr int kU = 2 * kSubs / 128;
    static_assert(kU * 128 == 2 * kSubs, "whole units a thread");
    auto load = [&](int j, float4 (&val)[kU][4]) {
      const int k0 = (kt_first + j) * kWgQ;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int unit = tid + 128 * u, x = unit / kSubs, sb = unit % kSubs;
        const int cg = sb % (D / 4), par = (sb / (D / 4)) & 1, grp8 = sb / (D / 2);
        load_unit(val[u], (x == 0 ? k : v) + k_off + 4 * cg, k_rs, k0 + 8 * grp8 + par, sh.s);
      }
    };
    // K and V hi and lo as stored (a row per key), K's transposed too
    auto store = [&](int s, const float4 (&val)[kU][4]) {
      const uint32_t st = base + s * L::kStage;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int unit = tid + 128 * u, x = unit / kSubs, sb = unit % kSubs;
        const int cg = sb % (D / 4), par = (sb / (D / 4)) & 1, grp8 = sb / (D / 2);
        store_unit(val[u], st + 2 * x * L::kRows, L::kRows, st + 4 * L::kRows, L::kCols, grp8,
                   par, 4 * cg, x == 0);
      }
    };
    float4 cur[kU][4], nxt[kU][4];
    load(0, cur);
    for (int j = 0; j < items; ++j) {
      const int s = j % kWgStages;
      mbar_wait(empty(s), ((j / kWgStages) & 1) ^ 1);
      if (j + 1 < items) load(j + 1, nxt);
      store(s, cur);
      fence_async_shared();
      mbar_arrive(full(s));
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[u][r] = nxt[u][r];
    }
    return;
  }

  const int qr = q0 + 16 * w + g;  // this thread's query rows qr, qr + 8
  float4* exch = reinterpret_cast<float4*>(gbase + L::kExch);

  if (wg == 1) {  // scores: S, dP, then dS
    const uint32_t o_lo = base + L::kLo;
    uint32_t qh[KS][4], ql[KS][4], oh[KS][4];
    own_frags<D>(qh, ql, q + q_off, q_rs, q0, sh.s, tid);
    own_rows<D>(oh, o_lo, dout + q_off, q_rs, q0, sh.s, tid);
    named_sync(1, 128);
    auto ol = [&](int ks) { return desc128(o_lo + (ks >> 2) * (kWgKeys * 128) + (ks & 3) * 32); };
    float lse_r[2], del_r[2];
#pragma unroll
    for (int rho = 0; rho < 2; ++rho) {
      const int qi = qr + 8 * rho;
      lse_r[rho] = qi < sh.s ? lse[(long long)bh * sh.s + qi] : 0.f;
      del_r[rho] = qi < sh.s ? delta[(long long)bh * sh.s + qi] : 0.f;
    }
    for (int j = 0; j < items; ++j) {
      const int s = j % kWgStages;
      const int k0 = (kt_first + j) * kWgQ;
      const uint32_t st = base + s * L::kStage;
      mbar_wait(full(s), (j / kWgStages) & 1);
      float sc[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks >> 2) * (kWgQ * 128) + (ks & 3) * 32;
        const uint64_t kh = desc128(st + off), kl = desc128(st + L::kRows + off);
        const uint64_t vh = desc128(st + 2 * L::kRows + off), vl = desc128(st + 3 * L::kRows + off);
        wgmma_tf32<32>(sc, ql[ks], kh, ks > 0);
        wgmma_tf32<32>(sc, qh[ks], kl, 1);
        wgmma_tf32<32>(sc, qh[ks], kh, 1);
        wgmma_tf32_ss(dp, ol(ks), vh, ks > 0);
        wgmma_tf32<32>(dp, oh[ks], vl, 1);
        wgmma_tf32<32>(dp, oh[ks], vh, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(empty(s));
      // dS = exp(s - lse) (dP - delta) on the visible pairs, times the
      // softcap's chain factor 1 - tanh^2
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 4 * n + i, qi = qr + 8 * (i >> 1), kj = k0 + 8 * n + 2 * t + (i & 1);
          float sv = sc[x] * sh.scale, th = 0.f;
          if (sh.softcap > 0.f) {
            th = tanhf(sv / sh.softcap);
            sv = sh.softcap * th;
          }
          const float p = visible(qi, kj, sh) ? __expf(sv - lse_r[i >> 1]) : 0.f;
          float ds = p * (dp[x] - del_r[i >> 1]);
          if (sh.softcap > 0.f) ds *= 1.f - th * th;
          dp[x] = ds;
        }
      const int xb = j & 1;
      mbar_wait(xempty(xb), ((j >> 1) & 1) ^ 1);
      float4* dst = exch + xb * 4 * 128 + tid;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        dst[128 * n] = make_float4(dp[4 * n], dp[4 * n + 1], dp[4 * n + 2], dp[4 * n + 3]);
      mbar_arrive(xfull(xb));
    }
    return;
  }

  // gradients: dQ += dS K
  float acc[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < items; ++j) {
    const int s = j % kWgStages, xb = j & 1;
    const uint32_t st = base + s * L::kStage;
    mbar_wait(full(s), (j / kWgStages) & 1);
    mbar_wait(xfull(xb), (j >> 1) & 1);
    const float4* src = exch + xb * 4 * 128 + tid;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 e = src[128 * kk];
      const float a[4] = {e.x, e.z, e.y, e.w};  // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Split sp = split(a[i]);
        ah[kk][i] = sp.hi;
        al[kk][i] = sp.lo;
      }
    }
    mbar_arrive(xempty(xb));
    const uint32_t bt = st + 4 * L::kRows;  // K transposed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bh = desc128(bt + 32 * kk), bl = desc128(bt + L::kCols + 32 * kk);
      wgmma_tf32<D>(part, al[kk], bh, kk > 0);
      wgmma_tf32<D>(part, ah[kk], bl, 1);
      wgmma_tf32<D>(part, ah[kk], bh, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(part);
    mbar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
  }
#pragma unroll
  for (int rho = 0; rho < 2; ++rho) {
    const int qi = qr + 8 * rho;
    if (qi >= sh.s) continue;
    float* row = dq + q_off + (long long)qi * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int x = 4 * n + 2 * rho;
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[x] * sh.scale, acc[x + 1] * sh.scale);
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
  const dim3 grid((sh.sq + kBQ - 1) / kBQ, sh.b * sh.h);
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

// K6: Q and dO resident, the K and V landing tiles, their pairs
template <int D>
constexpr size_t dq_tf32_smem() {
  return sizeof(float) * (2 * kDqRows * raw_ld<D>() + 2 * dq_tile<D>() * D) +
         sizeof(uint2) * 2 * dq_tile<D>() * (D + 4);
}
// K7: K and V resident, the Q and dO landing tiles with the LSE and delta
// rows, those rows again as multiplied, each warp pair's P^T, the pairs
template <int D>
constexpr size_t dkv_tf32_smem() {
  return sizeof(float) * (2 * dkv_keys<D>() * raw_ld<D>() + 2 * dkv_tile<D>() * D +
                          4 * dkv_tile<D>() + (dkv_pairs<D>() ? dkv_keys<D>() * dkv_tile<D>() : 0)) +
         sizeof(uint2) * 2 * dkv_tile<D>() * (D + 4);
}
// K5: Q resident, the K and V landing tiles, their pairs
template <int D>
constexpr size_t fwd_tf32_smem() {
  return sizeof(float) * (kDqRows * raw_ld<D>() + 2 * dq_tile<D>() * D) +
         sizeof(uint2) * 2 * dq_tile<D>() * (D + 4);
}
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory
static_assert(fwd_tf32_smem<64>() <= kMaxSmem && fwd_tf32_smem<80>() <= kMaxSmem &&
                  fwd_tf32_smem<128>() <= kMaxSmem,
              "K5 tf32 shared memory");
static_assert(dq_tf32_smem<80>() <= kMaxSmem && dq_tf32_smem<128>() <= kMaxSmem,
              "K6 tf32 shared memory");
static_assert(dkv_tf32_smem<80>() <= kMaxSmem && dkv_tf32_smem<128>() <= kMaxSmem,
              "K7 tf32 shared memory");
static_assert(DqWgLayout<64>::kBytes <= kMaxSmem, "K6 wgmma shared memory");
static_assert(DkvWgLayout<64>::kBytes <= kMaxSmem, "K7 wgmma shared memory");

template <int D>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o, void* lse,
                    const Shape& sh, cudaStream_t st) {
  auto kernel = fwd_tf32_kernel<D>;
  constexpr size_t smem = fwd_tf32_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.sq + kDqRows - 1) / kDqRows);
  kernel<<<grid, kTcThreads, smem, st>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o),
                                         static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, const Shape& sh,
                   cudaStream_t st) {
  auto kernel = dq_tf32_kernel<D>;
  constexpr size_t smem = dq_tf32_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + kDqRows - 1) / kDqRows);
  kernel<<<grid, kTcThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                    cudaStream_t st) {
  auto kernel = dkv_tf32_kernel<D>;
  constexpr size_t smem = dkv_tf32_smem<D>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.kv, (sh.s + dkv_keys<D>() - 1) / dkv_keys<D>());
  kernel<<<grid, kTcThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, const Shape& sh,
                    cudaStream_t st) {
  auto kernel = dq_wgmma_kernel<D>;
  constexpr size_t smem = DqWgLayout<D>::kBytes;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + kWgKeys - 1) / kWgKeys);
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                     cudaStream_t st) {
  auto kernel = dkv_wgmma_kernel<D>;
  constexpr size_t smem = DkvWgLayout<D>::kBytes;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.kv, (sh.s + kWgKeys - 1) / kWgKeys);
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sh);
  return (int)cudaGetLastError();
}

// The f32 forward's launch by width: TF32<D> (the mma.sync kernel) at D in
// {64, 80, 128}, SIMT<256> (the CUDA-core kernel) at 256.
#define FLASH_FWD_DISPATCH(TF32, SIMT, ...)                        \
  do {                                                             \
    if (dtype == 0 && d == 64) return TF32<64>(__VA_ARGS__);       \
    if (dtype == 0 && d == 80) return TF32<80>(__VA_ARGS__);       \
    if (dtype == 0 && d == 128) return TF32<128>(__VA_ARGS__);     \
    if (dtype == 0 && d == 256) return SIMT<256>(__VA_ARGS__);     \
    return (int)cudaErrorInvalidValue;                             \
  } while (0)

// The f32 backward's launch by width: WGMMA<64> (the wgmma kernels), TF32<D>
// (the mma.sync kernels) at D in {80, 128}, SIMT<256> (the CUDA-core
// kernels) at 256.
#define FLASH_BWD_DISPATCH(WGMMA, TF32, SIMT, ...)                 \
  do {                                                             \
    if (dtype == 0 && d == 64) return WGMMA<64>(__VA_ARGS__);      \
    if (dtype == 0 && d == 80) return TF32<80>(__VA_ARGS__);       \
    if (dtype == 0 && d == 128) return TF32<128>(__VA_ARGS__);     \
    if (dtype == 0 && d == 256) return SIMT<256>(__VA_ARGS__);     \
    return (int)cudaErrorInvalidValue;                             \
  } while (0)

Shape make_shape(int b, int s, int h, int kv, int window, float softcap, float scale) {
  Shape sh;
  sh.b = b;
  sh.s = s;
  sh.h = h;
  sh.kv = kv;
  sh.sq = s;
  sh.q0 = 0;
  sh.window = window;
  sh.softcap = softcap;
  sh.scale = scale;
  return sh;
}

}  // namespace

// Returns a cudaError_t (0 = launched).  window 0 = none, softcap 0 = none;
// dtype 0 (float32) only: bfloat16 runs flash_gqa_sm90.cu's kernels.  The
// forward's sq queries sit at positions q0 .. q0 + sq - 1 of the s keys.
extern "C" int flash_gqa_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int sq, int q0, int dtype, int b, int s, int h,
                             int kv, int d, int window, float softcap, float scale,
                             void* stream) {
  if (sq < 1 || q0 < 0 || q0 + sq > s) return (int)cudaErrorInvalidValue;
  Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  sh.sq = sq;
  sh.q0 = q0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_FWD_DISPATCH(launch_fwd_tf32, launch_fwd, q, k, v, o, lse, sh, st);
}

extern "C" int flash_gqa_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int dtype, int b, int s, int h, int kv, int d,
                                int window, float softcap, float scale, void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_BWD_DISPATCH(launch_dq_wgmma, launch_dq_tf32, launch_dq, q, k, v, dout, lse, delta, dq,
                     sh, st);
}

extern "C" int flash_gqa_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int dtype, int b, int s, int h,
                                 int kv, int d, int window, float softcap, float scale,
                                 void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_BWD_DISPATCH(launch_dkv_wgmma, launch_dkv_tf32, launch_dkv, q, k, v, dout, lse, delta,
                     dk, dv, sh, st);
}

extern "C" const char* flash_gqa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
