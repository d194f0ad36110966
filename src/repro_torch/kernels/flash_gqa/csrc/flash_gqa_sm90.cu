// Causal GQA flash attention on Hopper's tensor cores (sm_90a), bf16:
// the forward and both passes of the backward.
//
// Replaces, for bf16 operands, the Pallas TPU kernels of
// src/repro/kernels/flash_gqa/kernel.py:
//   K5  flash_gqa_pallas (_flash_kernel, return_residual)        -> flash_gqa_sm90_fwd
//   K6  flash_gqa_bwd_pallas, dq pass (_flash_bwd_dq_kernel)     -> flash_gqa_sm90_bwd_dq
//   K7  flash_gqa_bwd_pallas, dk/dv pass (_flash_bwd_dkv_kernel) -> flash_gqa_sm90_bwd_dkv,
//       then flash_gqa_sm90_dkv_sum when G = H / KV > 1
// f32 operands stay on flash_gqa.cu.  The contract is flash_gqa.cu's: q, o,
// dO, dq (B, S, H, D) and k, v (B, S, KV, D) bf16, lse and delta (B, H, S)
// f32, all contiguous; query head h reads KV head h / G; key j is visible to
// query i iff j <= i and (no window, or i - j < window); the softcap c
// applies s = c*tanh(s/c) to the scaled scores before the mask.
//
// What bounds it on an H100 SXM: at the LM slice (B = 2, S = 2048, H = 4,
// KV = 1, D = 256) the work is 4D (forward), 6D (dq) and 8D (dk/dv) flops per
// visible (query, key) pair over ~10-30 MB of operands, so the 989 TFLOP/s
// bf16 tensor-core peak sets the bound.  What the design does about it:
//  - every product is a wgmma (m64nNk16, bf16 in, f32 accumulate) on tiles in
//    shared memory stored as bf16 in the 128-byte swizzled layout wgmma reads:
//    a (rows, D) tile is D/64 column blocks of rows x 128 bytes, and the
//    16-byte chunk c of row r sits at chunk c ^ (r % 8) of its row;
//  - warp specialization: one producer warpgroup (one thread of it starts
//    TMA copies, cp.async.bulk.tensor, that write those swizzled tiles and
//    complete on mbarriers; rows past a ragged S arrive as zeros) and two
//    consumer warpgroups that multiply; setmaxnreg moves the producer's
//    registers to the consumers (24 / 240).  K/V or Q/dO tiles stream
//    through a 2-stage ring with full/empty mbarriers, so the next tile's
//    copy overlaps this tile's math and the consumers load nothing;
//  - K5: one block per (batch*head, 128-query tile), each consumer
//    warpgroup 64 query rows, the last (heaviest causal) tiles launched
//    first; S = Q K^T from shared memory, the scale and softcap on the f32
//    scores, the mask, the online softmax in registers in the accumulator's
//    layout, P rounded to bf16 in registers (where the model's reference
//    rounds it) as the A operand of O += P V, V the transposed B operand;
//    the two warpgroups never wait for each other;
//  - K7: one block per (batch, query head, 64-key tile), K and V resident,
//    Q/dO tiles of 64 queries streamed.  Each consumer warpgroup computes
//    32 query columns of S^T = K Q^T and dP^T = V dO^T, then P^T and
//    dS^T = P^T (dP^T - delta) [(1 - t^2)] in f32, stored to a
//    double-buffered shared tile as bf16; after one named barrier,
//    warpgroup 0 runs dV += P^T dO and warpgroup 1 dK += dS^T Q (each a
//    64 x D f32 accumulator, 128 registers a thread at D = 256);
//  - K6: one block per (batch*head, 128-query tile), heaviest first, as K5;
//    Q and dO stay resident (2 x 64 KB at D = 256), K/V stream through the
//    ring in 32-key tiles (two 64-key stages would not fit in 227 KB at
//    D = 256; one width for every D keeps one tile range).  Each consumer
//    warpgroup computes S = Q K^T and dP = dO V^T for its 64 rows (m64n32),
//    P and dS = P (dP - delta) [(1 - t^2)] in f32 registers, rounds dS to
//    bf16 in registers (the TPU kernel keeps f32) as the A operand of
//    dQ += dS K, K the MN-major B operand: dS never goes through shared
//    memory, and the two warpgroups never wait for each other;
//  - masked scores never enter exp (p = 0; a row with no visible key yet
//    keeps m = -inf, l = 0, alpha = 1), and the window prunes tiles exactly:
//    K5 visits key tiles max(0, q0 - W + 1)/64 .. (q0 + 127)/64 and K6 the
//    same range in 32-key tiles (each warpgroup computes only those its 64
//    rows see), K7 query tiles k0/64 .. (k0 + 63 + W - 1)/64
//    (kernels/flash_gqa/grid.py mirrors all three);
//  - no atomics: at G > 1 each K7 block writes its head's dk/dv partial in
//    f32 to (B, S, H, D) scratch and dkv_sum_kernel adds the G heads in the
//    fixed order g = 0 .. G-1; at G = 1 K7 writes bf16 dk/dv itself; a K6
//    block owns its dq rows.  Every sum has one order, so results are
//    bitwise run to run.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// from the CUDA driver through cudaGetDriverEntryPoint, so the library links
// against the runtime only.

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and the producer warpgroup
constexpr int kTile = 64;  // rows of a K/V or streamed Q/dO tile; wgmma's M
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Shape {
  int b, s, h, kv;
  int window;     // 0 = none
  float softcap;  // 0 = none
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers, TMA, register hand-off -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of TMA writes before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A (rows, D) tile of a (B, S, heads, D) tensor: rows row0 .. row0 + rows - 1
// of head `head`, as D/64 boxes of 64 columns into the swizzled column blocks.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row0, int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) tma_load(dst + cb * ROWS * 128, map, bar, cb * 64, head, row0, b);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The two consumer warpgroups only (named barrier 1; 0 is __syncthreads').
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
template <int N>
__device__ __forceinline__ void set_max_registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operand (rows of
// 64 contiguous K values): sbo = 1024 (the next 8 rows), lbo unused; a k16
// step adds 32 bytes inside the 128-byte row.  MN-major operand (rows of 64
// contiguous M/N values, one row per K index): lbo = the next 64-wide column
// block, sbo = 1024 (the next 8 K rows); a k16 step adds 2048 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins the accumulator registers in place around an asynchronous wgmma, so
// no access to them moves across the fence or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = [d +] A B with A (64 x 16) and B (16 x N) from shared
// memory, A K-major; B K-major (kTransB = 0) or MN-major (kTransB = 1).
template <int N, int kTransB>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);
// The same with A from registers: 4 x bf16x2 per thread, the accumulator's
// layout for a 64 x 16 slice; B MN-major.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32, 0>(float (&d)[16], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 0>(float (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 1>(float (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, 1>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256, 1>(float (&d)[128], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t* a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}



// -- shared helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int qi, int kj, const Shape& sh) {
  return kj <= qi && qi < sh.s && (sh.window <= 0 || qi - kj < sh.window);
}

// Accumulator layout of a 64 x N wgmma tile: thread t (warp w = t / 32 of
// its warpgroup, lane l) holds d[4 n + 2 rho + j] = element (16 w + l / 4 +
// 8 rho, 8 n + 2 (l % 4) + j).
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return warp * 16 + (lane >> 2) + ((i & 2) << 2);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return ((i >> 2) << 3) + ((lane & 3) << 1) + (i & 1);
}

// Shared memory of a block: 1024-byte aligned tiles, then the mbarriers.
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// -- K5: forward ---------------------------------------------------------------

template <int D>
struct FwdLayout {
  static constexpr int kQRows = 2 * kTile;   // one query tile: two warpgroups' rows
  static constexpr int kQ = kQRows * D * 2;
  static constexpr int kKV = kTile * D * 2;  // one K or V tile
  static constexpr int kBars = kQ + 4 * kKV;  // q_full, kv_full[2], kv_empty[2]
  static constexpr int kBytes = kBars + 5 * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, Shape sh) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sQ = base, sKV = base + L::kQ;  // stage st: K at sKV + 2 st kKV, V after
  const uint32_t q_full = base + L::kBars, kv_full = q_full + 8, kv_empty = kv_full + 16;

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const int n_qt = (sh.s + L::kQRows - 1) / L::kQRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * L::kQRows;  // heaviest tiles first
  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kTile : 0;
  const int kt_last = (min(q0 + L::kQRows, sh.s) - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread starts every copy
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      tma_tile<D, L::kQRows>(sQ, &tq, q_full, h, q0, b);
      for (int kt = kt_first; kt <= kt_last; ++kt) {
        const int i = kt - kt_first, st = i & 1;
        if (i >= 2) mbar_wait(kv_empty + 8 * st, ((i >> 1) - 1) & 1);
        const uint32_t full = kv_full + 8 * st, dst = sKV + st * 2 * L::kKV;
        mbar_expect_tx(full, 2 * L::kKV);
        tma_tile<D, kTile>(dst, &tk, full, kvh, kt * kTile, b);
        tma_tile<D, kTile>(dst + L::kKV, &tv, full, kvh, kt * kTile, b);
      }
    }
    return;
  }
  set_max_registers_inc<kConsumerRegs>();

  const int t = threadIdx.x - 128;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const long long q_rs = (long long)sh.h * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const int r0 = q0 + wg * kTile;  // this warpgroup's first row
  const bool live = r0 < sh.s;
  const int wk_first = sh.window > 0 ? max(0, r0 - sh.window + 1) / kTile : 0;
  const int wk_last = (min(r0 + kTile, sh.s) - 1) / kTile;
  const int row[2] = {r0 + acc_row(0, warp, lane), r0 + acc_row(2, warp, lane)};

  const bool capped = sh.softcap > 0.f;
  const float score_mul = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
  const float cap_mul = sh.softcap * kLog2e;
  float acc[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int i = kt - kt_first, st_i = i & 1;
    const uint32_t st = sKV + st_i * 2 * L::kKV;
    mbar_wait(kv_full + 8 * st_i, (i >> 1) & 1);
    if (live && kt >= wk_first && kt <= wk_last) {  // some row of ours sees the tile
      const int k0 = kt * kTile;

      // S = Q K^T (64 x 64 per warpgroup), K-major operands
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk & 3) * 32;
        const uint64_t da =
            desc(sQ + (kk >> 2) * (L::kQRows * 128) + wg * kTile * 128 + ko, 16, 1024);
        const uint64_t db = desc(st + (kk >> 2) * (kTile * 128) + ko, 16, 1024);
        wgmma_ss<64, 0>(s, da, db, kk > 0);
      }
      wgmma_commit_and_wait();
      fence_regs(s);

      // scale, softcap (log2 domain from here), mask; the online softmax
      const bool masked = !(k0 + kTile - 1 <= r0 &&
                            (sh.window <= 0 || r0 + kTile - 1 - k0 < sh.window));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = s[j] * score_mul;
        if (capped) x = cap_mul * tanhf(x);
        if (masked && !visible(row[(j >> 1) & 1], k0 + acc_col(j, lane), sh)) x = -INFINITY;
        s[j] = x;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // exp2(-inf) = 0 on the first visible tile; no visible key yet: keep 1
        alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        const float p = s[j] == -INFINITY ? 0.f : exp2f(s[j] - m[r]);
        l[r] += p;  // this thread's share of the row; summed over the quad at the end
        s[j] = p;
      }
      uint32_t pa[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

      // O += P V: P from registers, V MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs<D>(acc, pa + 4 * kk, desc(st + L::kKV + kk * 2048, kTile * 128, 1024), 1);
      wgmma_commit_and_wait();
      fence_regs(acc);
    }
    mbar_arrive(kv_empty + 8 * st_i);  // this thread is done with the stage
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sh.s) continue;
    const float lz = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / lz;
    bf16* orow = o + q_off + (long long)row[r] * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * (lane & 3)) =
          pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    if ((lane & 3) == 0) lse[(long long)bh * sh.s + row[r]] = (m[r] + log2f(lz)) * kLn2;
  }
}

// -- K7: dk/dv pass ------------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int kT = kTile * D * 2;       // one 64-row bf16 tile
  static constexpr int kPT = kTile * kTile * 2;  // P^T or dS^T
  static constexpr int kStages = 2 * kT;         // + Q, dO of stage 1 after stage 0
  static constexpr int kP = 2 * kT + 2 * kStages;  // P^T[2], dS^T[2] after K, V, stages
  static constexpr int kBars = kP + 4 * kPT;       // kv_full, full[2], empty[2]
  static constexpr int kBytes = kBars + 5 * 8 + 1024;
};

// kPartial: dk/dv are f32 (B, S, H, D) per-head partials (G > 1); otherwise
// bf16 (B, S, KV, D) results (G = 1).
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           void* __restrict__ dk, void* __restrict__ dv, Shape sh) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + L::kT;
  const uint32_t sStage = base + 2 * L::kT;  // stage st: Q at + st kStages, dO after it
  const uint32_t sP = base + L::kP;          // P^T[buf] at + buf 2 kPT, dS^T after it
  const uint32_t kv_full = base + L::kBars, full = kv_full + 8, empty = full + 16;

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const int k0 = blockIdx.y * kTile;
  const int k1 = min(k0 + kTile, sh.s) - 1;
  const int qt_first = k0 / kTile;
  const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : sh.s - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread starts every copy
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kT);
      tma_tile<D, kTile>(sK, &tk, kv_full, kvh, k0, b);
      tma_tile<D, kTile>(sV, &tv, kv_full, kvh, k0, b);
      for (int qt = qt_first; qt <= qt_last; ++qt) {
        const int i = qt - qt_first, st = i & 1;
        if (i >= 2) mbar_wait(empty + 8 * st, ((i >> 1) - 1) & 1);
        const uint32_t bar = full + 8 * st, dst = sStage + st * L::kStages;
        mbar_expect_tx(bar, 2 * L::kT);
        tma_tile<D, kTile>(dst, &tq, bar, h, qt * kTile, b);
        tma_tile<D, kTile>(dst + L::kT, &tdo, bar, h, qt * kTile, b);
      }
    }
    return;
  }
  set_max_registers_inc<kConsumerRegs>();

  const int t = threadIdx.x - 128;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const long long row_off = (long long)bh * sh.s;
  const bool capped = sh.softcap > 0.f;
  const float score_mul = capped ? sh.scale / sh.softcap : sh.scale;
  const int key[2] = {k0 + acc_row(0, warp, lane), k0 + acc_row(2, warp, lane)};
  float acc[D / 2];  // warpgroup 0: dV, warpgroup 1: dK (unscaled)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int qt = qt_first; qt <= qt_last; ++qt) {
    const int i = qt - qt_first, st_i = i & 1;
    const uint32_t st = sStage + st_i * L::kStages;
    const uint32_t sPt = sP + (i & 1) * 2 * L::kPT, sDSt = sPt + L::kPT;
    const int q0 = qt * kTile;
    // this thread's query columns' lse and delta, read while the tiles land
    float lse_c[8], delta_c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + wg * 32 + acc_col(2 * (j >> 1) * 2 + (j & 1), lane);
      lse_c[j] = qi < sh.s ? lse[row_off + qi] : 0.f;
      delta_c[j] = qi < sh.s ? delta[row_off + qi] : 0.f;
    }
    mbar_wait(full + 8 * st_i, (i >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T on this warpgroup's 32 query columns
    float sc[16], dp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (kTile * 128) + (kk & 3) * 32;
      const uint32_t cols = wg * 32 * 128;
      wgmma_ss<32, 0>(sc, desc(sK + off, 16, 1024), desc(st + off + cols, 16, 1024), kk > 0);
      wgmma_ss<32, 0>(dp, desc(sV + off, 16, 1024), desc(st + L::kT + off + cols, 16, 1024),
                      kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(s - lse), dS^T = P^T (dP^T - delta) [(1 - t^2)], as bf16 tiles
    const bool masked = !(q0 >= k0 + kTile - 1 && q0 + kTile - 1 < sh.s &&
                          (sh.window <= 0 || q0 + kTile - 1 - k0 < sh.window));
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const int r = (j >> 1) & 1, c = wg * 32 + acc_col(j, lane);
      const int ci = 2 * (j >> 2);  // index of column c in lse_c / delta_c
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[j + e] * score_mul, th = 0.f;
        if (capped) {
          th = tanhf(x);
          x = sh.softcap * th;
        }
        p[e] = masked && !visible(q0 + c + e, key[r], sh)
                   ? 0.f
                   : exp2f((x - lse_c[ci + e]) * kLog2e);
        ds[e] = p[e] * (dp[j + e] - delta_c[ci + e]);
        if (capped) ds[e] *= 1.f - th * th;
      }
      const int kr = acc_row(j, warp, lane);
      const uint32_t off = kr * 128 + ((((c >> 3) ^ (kr & 7))) << 4) + (c & 7) * 2;
      *reinterpret_cast<uint32_t*>(gbase + (sPt - base) + off) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(gbase + (sDSt - base) + off) = pack_bf16(ds[0], ds[1]);
    }
    fence_async_shared();
    consumer_sync();  // P^T and dS^T are whole

    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q (B MN-major)
    const uint32_t a_tile = wg == 0 ? sPt : sDSt, b_tile = wg == 0 ? st + L::kT : st;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_ss<D, 1>(acc, desc(a_tile + kk * 32, 16, 1024),
                     desc(b_tile + kk * 2048, kTile * 128, 1024), 1);
    wgmma_commit_and_wait();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st_i);  // this thread is done with the Q/dO stage
  }

  const float mul = wg == 0 ? 1.f : sh.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= sh.s) continue;
    if (kPartial) {
      float* row = static_cast<float*>(wg == 0 ? dv : dk) +
                   (((long long)b * sh.s + key[r]) * sh.h + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * (lane & 3)) =
            make_float2(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    } else {
      bf16* row = static_cast<bf16*>(wg == 0 ? dv : dk) +
                  (((long long)b * sh.s + key[r]) * sh.kv + kvh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * (lane & 3)) =
            pack_bf16(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
    }
  }
}

// -- K6: dq pass ---------------------------------------------------------------

constexpr int kDqKeys = 32;  // keys of a K6 K/V tile

template <int D>
struct DqLayout {
  static constexpr int kRows = 2 * kTile;          // one query tile: two warpgroups' rows
  static constexpr int kQ = kRows * D * 2;         // the Q or the dO tile
  static constexpr int kKV = kDqKeys * D * 2;      // one K or V tile
  static constexpr int kBars = 2 * kQ + 4 * kKV;   // qd_full, kv_full[2], kv_empty[2]
  static constexpr int kBytes = kBars + 5 * 8 + 1024;
};

// kWide: dq is the f32 sum before the final rounding; otherwise bf16.
template <int D, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          void* __restrict__ dq, Shape sh) {
  using L = DqLayout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sQ = base, sdO = base + L::kQ;
  const uint32_t sKV = base + 2 * L::kQ;  // stage st: K at sKV + 2 st kKV, V after it
  const uint32_t qd_full = base + L::kBars, kv_full = qd_full + 8, kv_empty = kv_full + 16;

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const int n_qt = (sh.s + L::kRows - 1) / L::kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * L::kRows;  // heaviest tiles first
  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kDqKeys : 0;
  const int kt_last = (min(q0 + L::kRows, sh.s) - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread starts every copy
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * L::kQ);
      tma_tile<D, L::kRows>(sQ, &tq, qd_full, h, q0, b);
      tma_tile<D, L::kRows>(sdO, &tdo, qd_full, h, q0, b);
      for (int kt = kt_first; kt <= kt_last; ++kt) {
        const int i = kt - kt_first, st = i & 1;
        if (i >= 2) mbar_wait(kv_empty + 8 * st, ((i >> 1) - 1) & 1);
        const uint32_t full = kv_full + 8 * st, dst = sKV + st * 2 * L::kKV;
        mbar_expect_tx(full, 2 * L::kKV);
        tma_tile<D, kDqKeys>(dst, &tk, full, kvh, kt * kDqKeys, b);
        tma_tile<D, kDqKeys>(dst + L::kKV, &tv, full, kvh, kt * kDqKeys, b);
      }
    }
    return;
  }
  set_max_registers_inc<kConsumerRegs>();

  const int t = threadIdx.x - 128;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const long long q_rs = (long long)sh.h * D;
  const long long q_off = ((long long)b * sh.s * sh.h + h) * D;
  const int r0 = q0 + wg * kTile;  // this warpgroup's first row
  const bool live = r0 < sh.s;
  const int wk_first = sh.window > 0 ? max(0, r0 - sh.window + 1) / kDqKeys : 0;
  const int wk_last = (min(r0 + kTile, sh.s) - 1) / kDqKeys;
  const int row[2] = {r0 + acc_row(0, warp, lane), r0 + acc_row(2, warp, lane)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < sh.s ? lse[(long long)bh * sh.s + row[r]] : 0.f;
    delta_r[r] = row[r] < sh.s ? delta[(long long)bh * sh.s + row[r]] : 0.f;
  }

  const bool capped = sh.softcap > 0.f;
  const float score_mul = capped ? sh.scale / sh.softcap : sh.scale;
  float acc[D / 2];  // dq / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qd_full, 0);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int i = kt - kt_first, st_i = i & 1;
    const uint32_t sK = sKV + st_i * 2 * L::kKV, sV = sK + L::kKV;
    mbar_wait(kv_full + 8 * st_i, (i >> 1) & 1);
    if (live && kt >= wk_first && kt <= wk_last) {  // some row of ours sees the tile
      const int k0 = kt * kDqKeys;

      // S = Q K^T and dP = dO V^T (64 x 32 each), K-major operands
      float sc[16], dp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) sc[j] = dp[j] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk >> 2) * (L::kRows * 128) + wg * kTile * 128 + (kk & 3) * 32;
        const uint32_t b_off = (kk >> 2) * (kDqKeys * 128) + (kk & 3) * 32;
        wgmma_ss<32, 0>(sc, desc(sQ + a_off, 16, 1024), desc(sK + b_off, 16, 1024), kk > 0);
        wgmma_ss<32, 0>(dp, desc(sdO + a_off, 16, 1024), desc(sV + b_off, 16, 1024), kk > 0);
      }
      wgmma_commit_and_wait();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(s - lse), dS = P (dP - delta) [(1 - t^2)], rounded to bf16 in
      // registers: the A operand of dS K
      const bool masked = !(k0 + kDqKeys - 1 <= r0 && r0 + kTile - 1 < sh.s &&
                            (sh.window <= 0 || r0 + kTile - 1 - k0 < sh.window));
      uint32_t da[8];
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const int r = (j >> 1) & 1;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[j + e] * score_mul, th = 0.f;
          if (capped) {
            th = tanhf(x);
            x = sh.softcap * th;
          }
          const float p = masked && !visible(row[r], k0 + acc_col(j + e, lane), sh)
                              ? 0.f
                              : exp2f((x - lse_r[r]) * kLog2e);
          ds[e] = p * (dp[j + e] - delta_r[r]);
          if (capped) ds[e] *= 1.f - th * th;
        }
        da[j >> 1] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K: dS from registers, K MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        wgmma_rs<D>(acc, da + 4 * kk, desc(sK + kk * 2048, kDqKeys * 128, 1024), 1);
      wgmma_commit_and_wait();
      fence_regs(acc);
    }
    mbar_arrive(kv_empty + 8 * st_i);  // this thread is done with the stage
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sh.s) continue;
    const long long off = q_off + (long long)row[r] * q_rs + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[4 * n + 2 * r] * sh.scale, x1 = acc[4 * n + 2 * r + 1] * sh.scale;
      if (kWide)
        *reinterpret_cast<float2*>(static_cast<float*>(dq) + off + 8 * n) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dq) + off + 8 * n) = pack_bf16(x0, x1);
    }
  }
}

// dk/dv (B, S, KV, D) bf16 = sum over g = 0 .. G-1, in that order, of the f32
// partials (B, S, H, D) of query heads kvh * G + g.  4 columns a thread.
__global__ void __launch_bounds__(256)
dkv_sum_kernel(const float* __restrict__ pk, const float* __restrict__ pv,
               bf16* __restrict__ dk, bf16* __restrict__ dv, long long n4, int g, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int d4 = d / 4;
  const long long row = i / d4;  // (b, s, kvh) flattened
  const int c = (int)(i % d4) * 4;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = (which == 0 ? pk : pv) + row * g * d + c;
    float4 acc = *reinterpret_cast<const float4*>(p);
    for (int gi = 1; gi < g; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(p + (long long)gi * d);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 out;
    out.x = pack_bf16(acc.x, acc.y);
    out.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which == 0 ? dk : dv) + row * d + c) = out;
  }
}

// -- launches ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 (B, S, heads, D) tensor read in boxes of
// 64 columns x `rows` rows of one head, 128-byte swizzled; rows past S read
// as zeros.  Returns a cudaError_t.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const Shape& sh, cudaStream_t st) {
  auto kernel = fwd_kernel<D>;
  constexpr int smem = FwdLayout<D>::kBytes;
  CUtensorMap tq, tk, tv;
  if (int err = make_map(&tq, q, sh.b, sh.s, sh.h, D, FwdLayout<D>::kQRows)) return err;
  if (int err = make_map(&tk, k, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = make_map(&tv, v, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + FwdLayout<D>::kQRows - 1) / FwdLayout<D>::kQRows);
  kernel<<<grid, kThreads, smem, st>>>(tq, tk, tv, static_cast<bf16*>(o),
                                       static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
               cudaStream_t st) {
  auto kernel = sh.h == sh.kv ? dkv_kernel<D, false> : dkv_kernel<D, true>;
  constexpr int smem = DkvLayout<D>::kBytes;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = make_map(&tq, q, sh.b, sh.s, sh.h, D, kTile)) return err;
  if (int err = make_map(&tk, k, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = make_map(&tv, v, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = make_map(&tdo, dout, sh.b, sh.s, sh.h, D, kTile)) return err;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, st>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                                       static_cast<const float*>(delta), dk, dv, sh);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int dq_dtype, const Shape& sh,
              cudaStream_t st) {
  if (dq_dtype < 0 || dq_dtype > 1) return (int)cudaErrorInvalidValue;
  auto kernel = dq_dtype == 1 ? dq_kernel<D, false> : dq_kernel<D, true>;
  using L = DqLayout<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = make_map(&tq, q, sh.b, sh.s, sh.h, D, L::kRows)) return err;
  if (int err = make_map(&tk, k, sh.b, sh.s, sh.kv, D, kDqKeys)) return err;
  if (int err = make_map(&tv, v, sh.b, sh.s, sh.kv, D, kDqKeys)) return err;
  if (int err = make_map(&tdo, dout, sh.b, sh.s, sh.h, D, L::kRows)) return err;
  if (int err = prepare(kernel, L::kBytes)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + L::kRows - 1) / L::kRows);
  kernel<<<grid, kThreads, L::kBytes, st>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                                            static_cast<const float*>(delta), dq, sh);
  return (int)cudaGetLastError();
}

// Returns LAUNCH<D>(args...) for dtype 1 (bfloat16) and D in {64, 128, 256}.
#define SM90_DISPATCH(LAUNCH, ...)                                  \
  do {                                                              \
    if (dtype == 1 && d == 64) return LAUNCH<64>(__VA_ARGS__);      \
    if (dtype == 1 && d == 128) return LAUNCH<128>(__VA_ARGS__);    \
    if (dtype == 1 && d == 256) return LAUNCH<256>(__VA_ARGS__);    \
    return (int)cudaErrorInvalidValue;                              \
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

// Each returns a cudaError_t (0 = launched).  window 0 = none, softcap 0 =
// none; dtype 1 (bfloat16) only: float32 runs flash_gqa.cu's kernels.
extern "C" int flash_gqa_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int dtype, int b, int s, int h, int kv, int d,
                                  int window, float softcap, float scale, void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SM90_DISPATCH(launch_fwd, q, k, v, o, lse, sh, st);
}

// dq (B, S, H, D): bf16 for dq_dtype 1, or for dq_dtype 0 the f32 sums before
// that rounding (what the precision check reads).
extern "C" int flash_gqa_sm90_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int dq_dtype, int dtype, int b, int s, int h,
                                     int kv, int d, int window, float softcap, float scale,
                                     void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SM90_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, dq_dtype, sh, st);
}

// dk/dv: bf16 (B, S, KV, D) when h == kv; otherwise f32 (B, S, H, D)
// per-head partials for flash_gqa_sm90_dkv_sum.
extern "C" int flash_gqa_sm90_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int dtype, int b, int s, int h,
                                      int kv, int d, int window, float softcap, float scale,
                                      void* stream) {
  const Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SM90_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, sh, st);
}

// dk/dv (B, S, KV, D) bf16 from the f32 partials (B, S, H, D); d % 4 == 0.
extern "C" int flash_gqa_sm90_dkv_sum(const void* pk, const void* pv, void* dk, void* dv,
                                      int b, int s, int h, int kv, int d, void* stream) {
  if (d % 4 || h % kv) return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)b * s * kv * d / 4;
  const int blocks = (int)((n4 + 255) / 256);
  dkv_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pk), static_cast<const float*>(pv), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n4, h / kv, d);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_gqa_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
