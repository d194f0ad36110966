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
// applies s = c*tanh(s/c) to the scaled scores before the mask.  K5 also
// takes a query offset (a rank of a sequence-parallel prefill): its Sq
// queries (q, o (B, Sq, H, D), lse (B, H, Sq)) sit at absolute positions
// q0 .. q0 + Sq - 1 of the S keys (q0 + Sq <= S), the mask and the key-tile
// range are computed on those absolute positions, and q0 = 0, Sq = S is the
// plain launch.  The backward passes take no offset.
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
//    through a ring with full/empty mbarriers, so the next tile's copy
//    overlaps this tile's math and the consumers load nothing;
//  - two designs, by head_dim.  fwd_kernel, dq_kernel and dkv_kernel,
//    shaped for D = 256, where the products dominate: tiles are whole
//    64-column blocks, each product is waited for in turn, and the rings
//    have 2 stages; they run K5, K6 and K7 at D = 256.  fwd_narrow_kernel,
//    dq_narrow_kernel and dkv_narrow_kernel run K5, K6 and K7 at D = 64, 80
//    and 128, templates over D on TileN<D>: tiles sit at the true width (at
//    D = 80 a 64-column and a 16-column block, no padded columns), keys come
//    128 to a tile or block, rings have 2 to 4 stages (as many as shared
//    memory holds), products overlap the elementwise work, and the
//    elementwise step has no branch inside; each section below says more;
//  - K5 (fwd_kernel, D = 256): one block per (batch*head, 128-query tile), each
//    consumer warpgroup 64 query rows, the last (heaviest causal) tiles
//    launched first; K/V stream in 64-key tiles; S = Q K^T from shared
//    memory, the scale and softcap on the f32 scores, the mask, the online
//    softmax in registers in the accumulator's layout, P rounded to bf16 in
//    registers (where the model's reference rounds it) as the A operand of
//    O += P V, V the transposed B operand; the two warpgroups never wait for
//    each other;
//  - K7 (dkv_kernel): one block per (batch, query head, 64-key tile), K and
//    V resident, Q/dO tiles of 64 queries streamed.  Each consumer
//    warpgroup computes 32 query columns of S^T = K Q^T and dP^T = V dO^T,
//    then P^T and dS^T = P^T (dP^T - delta) [(1 - t^2)] in f32, stored to a
//    double-buffered shared tile as bf16; after one named barrier,
//    warpgroup 0 runs dV += P^T dO and warpgroup 1 dK += dS^T Q (each a
//    64 x D f32 accumulator, 128 registers a thread at D = 256);
//  - K6 (dq_kernel): one block per (batch*head, 128-query tile), heaviest
//    first, as K5; Q and dO stay resident (2 x 64 KB at D = 256), K/V
//    stream through the ring in 32-key tiles (two 64-key stages would not
//    fit in 227 KB at D = 256).  Each consumer warpgroup computes S = Q K^T
//    and dP = dO V^T for its 64 rows (m64n32), P and dS = P (dP - delta)
//    [(1 - t^2)] in f32 registers, rounds dS to bf16 in registers (the TPU
//    kernel keeps f32) as the A operand of dQ += dS K, K the MN-major B
//    operand: dS never goes through shared memory, and the two warpgroups
//    never wait for each other;
//  - masked scores never enter exp (p = 0; a row with no visible key yet
//    keeps m = -inf, l = 0, alpha = 1), and the window prunes tiles exactly:
//    K5 visits key tiles max(0, q0 - W + 1)/64 .. (q0 + 127)/64 (q0 the
//    block's first absolute position, the last clamped to the last query's;
//    128-key tiles at D = 64, 80 and 128) and K6 the same range in 32-key tiles
//    (128 at D = 64, 80 and 128; each warpgroup computes only those its 64
//    rows see), K7 query tiles k0/64 .. (k0 + 63 + W - 1)/64 (at D = 64, 80
//    and 128 the same for the block's 128 keys and for each warpgroup's 64;
//    kernels/flash_gqa/grid.py mirrors them all);
//  - no atomics: at G > 1 each K7 block writes its head's dk/dv partial in
//    f32 to (B, S, H, D) scratch and dkv_sum_kernel adds the G heads in the
//    fixed order g = 0 .. G-1; at G = 1 K7 writes bf16 dk/dv itself; a K6
//    block owns its dq rows.  Every sum has one order, so results are
//    bitwise run to run.
//
// Why D = 64, 80 and 128 have kernels of their own.  At D <= 80 a tile's
// products are short, and the exp, the mask and the bookkeeping take about
// as long as they do (128 exps a row of a 128-key tile keep the SM's exp
// units about as busy as the tile's products keep its tensor cores), so the
// narrow kernels overlap the two and keep the elementwise step short: no
// branch per element (the mask is an exponent of -inf; the softcap and the
// masked-tile choice are made once a tile), the next tile's products issued
// before this tile's are waited for.  K5, K6 and K7 at D = 128 moved to the
// narrow kernels too: their products are 1.6x as long as at D = 80 for the
// same exps a thread, but the D = 256 kernels' short tiles (64 keys in K5
// and K7, 32 in K6), products waited for in turn and branch per element
// left the tensor cores idle through every softmax (K5 1.74x SDPA's forward
// at internvl2's prefill; K6 and K7 at 20 and 22 % of their bounds at its
// training shape, with the sum pass 2.1x SDPA's backward).  The D = 256
// shapes do not carry over:
// at D = 80 they padded tiles to 128 columns (1.2-1.3x the counted work);
// at D = 64 K6's 32-key tiles made S and dP m64n32 products of 4 k-steps,
// too short to keep the tensor cores fed, and K7's 64-key blocks read Q
// and dO twice as often as 128-key ones.  At D <= 80 a warpgroup holds
// both dV and dK (2 x 32 or 2 x 40 f32 a thread) beside S^T and dP^T, so
// P^T and dS^T stay in registers as A operands, with no shared-memory
// round trip and no barrier between the warpgroups on every tile; at D = 128
// (2 x 64) they still do, in another order (the K6 / K7 section).
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// from the CUDA driver through cudaGetDriverEntryPoint, so the library links
// against the runtime only.

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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
  int sq, q0;     // queries held and the absolute position of query 0 (K5)
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

// A (rows, D) tile of a (B, S, heads, D) tensor, D a multiple of 64: rows
// row0 .. row0 + rows - 1 of head `head`, as D/64 boxes of 64 columns into
// the swizzled column blocks.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row0, int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) tma_load(dst + cb * ROWS * 128, map, bar, cb * 64, head, row0, b);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The reverse of tma_load: one box from shared memory at src into a 4-D
// tensor map's coordinates (rows past the tensor's end are not written),
// as a bulk group of this thread.
__device__ __forceinline__ void tma_store(uint32_t src, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk stores have read their shared memory
// (kRead), or have written their global memory too.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
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
// The 32-byte swizzle (layout 3; the narrow kernels at D = 80) is the same
// with rows of 16 values: K-major, sbo = 256 (the next 8 rows) and one k16
// step a row; MN-major, lbo = the next 16-wide column block, sbo = 256, a
// k16 step adds 512 bytes.
constexpr uint64_t kSw128 = 1, kSw32 = 3;
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout = kSw128) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
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
// The same for the bf16x2 registers of an A operand: they stay as they are
// until the wait after which this stands.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wgmma_ss<128, 0>(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t* a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// -- shared helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// qi, kj: absolute positions; rows past the last query see nothing.
__device__ __forceinline__ bool visible(int qi, int kj, const Shape& sh) {
  return kj <= qi && qi < sh.q0 + sh.sq && (sh.window <= 0 || qi - kj < sh.window);
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
  static_assert(D % 64 == 0,
                "whole 64-column swizzle blocks (D = 64, 80 and 128 run fwd_narrow_kernel)");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sQ = base, sKV = base + L::kQ;  // stage st: K at sKV + 2 st kKV, V after
  const uint32_t q_full = base + L::kBars, kv_full = q_full + 8, kv_empty = kv_full + 16;

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  // rows of q, o and lse are local (0 .. Sq - 1); masks and key tiles use
  // absolute positions, local row + sh.q0
  const int n_qt = (sh.sq + L::kQRows - 1) / L::kQRows;
  const int lq0 = (n_qt - 1 - (int)blockIdx.y) * L::kQRows;  // heaviest tiles first
  const int q0 = sh.q0 + lq0, q_end = sh.q0 + sh.sq;
  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / kTile : 0;
  const int kt_last = (min(q0 + L::kQRows, q_end) - 1) / kTile;

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
      tma_tile<D, L::kQRows>(sQ, &tq, q_full, h, lq0, b);
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
  const long long q_off = ((long long)b * sh.sq * sh.h + h) * D;
  const int r0 = q0 + wg * kTile;  // this warpgroup's first row (absolute)
  const bool live = r0 < q_end;
  const int wk_first = sh.window > 0 ? max(0, r0 - sh.window + 1) / kTile : 0;
  const int wk_last = (min(r0 + kTile, q_end) - 1) / kTile;
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
    if (row[r] >= q_end) continue;
    const int local = row[r] - sh.q0;
    const float lz = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / lz;
    bf16* orow = o + q_off + (long long)local * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * (lane & 3)) =
          pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    if ((lane & 3) == 0) lse[(long long)bh * sh.sq + local] = (m[r] + log2f(lz)) * kLn2;
  }
}

// -- K7: dk/dv pass ------------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int kT = kTile * D * 2;  // one 64-row bf16 tile
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
  static_assert(D % 64 == 0,
                "whole 64-column swizzle blocks (D = 64, 80 and 128 run the narrow kernels)");
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
  static constexpr int kQ = kRows * D * 2;     // the Q or the dO tile
  static constexpr int kKV = kDqKeys * D * 2;  // one K or V tile
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
  static_assert(D % 64 == 0,
                "whole 64-column swizzle blocks (D = 64, 80 and 128 run the narrow kernels)");
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

// -- K6 and K7 at head_dim 64, 80 and 128 --------------------------------------
//
// Templates over D = 64, 80 and 128, since the kernels above, shaped for
// D = 256, pad D = 80 to 128 columns and run D = 64 and 128 on 32-key K6
// tiles and 64-key K7 blocks.  A (rows, D) bf16 tile is held at its own D columns (TileN<D>), so
// every product runs at the counted work, and the passes are shaped for it:
//  - K7 (dkv_narrow_kernel): one block per 128 keys; each consumer warpgroup
//    owns 64 of them and holds both its dV and its dK accumulator (2 x D/2
//    f32 a thread).  For each streamed 64-query tile it computes S^T = K Q^T
//    and dP^T = V dO^T at m64n64, forms P^T and dS^T in f32 and rounds them
//    to bf16 in registers, where they are the A operands of dV += P^T dO and
//    dK += dS^T Q (dO and Q the MN-major B): P^T and dS^T never go through
//    shared memory and no barrier joins the warpgroups on a tile (at D = 64
//    they take turns at issuing, below); the two share each Q/dO stage,
//    into which producer warp 1 writes the tile's lse log2 e and delta (in
//    registers, 32 a thread, they spilled at D = 80);
//  - K6 (dq_narrow_kernel): K/V stream in 128-key tiles (S and dP at
//    m64n128), dS stays in registers as the A operand of dQ += dS K;
//  - inside a warpgroup, products overlap the elementwise work: S and dP are
//    committed as two groups, P is formed while dP runs (wait_group 1), and
//    the dV / dK / dQ products of one tile run on while the next tile's S and
//    dP are issued; a stage is released once the wait of the next tile has
//    seen the products that read it.  A warpgroup with no key (K7) or row
//    (K6) in a tile still waits for it and releases it, after its own
//    products in flight, so arrivals on a stage never run ahead of a use;
//  - at D = 128 the registers do not hold all of that (K6's dQ, S and dP are
//    3 x 64 f32 a thread; K7's dV and dK 2 x 64 beside S^T and dP^T; as
//    above, ptxas serialized both kernels' wgmmas and spilled): K6 waits for
//    its last dQ product before it issues the next tile's S and dP (kDrain),
//    and K7 issues dP^T only once P^T is formed, beside the dV product, and
//    waits for both (kLateDP), so S^T, dP^T and P^T are never held at once;
//    the other warpgroup's products fill those waits.  P^T through shared
//    memory instead also cleared the spills, but was slower (PERF.md,
//    Findings);
//  - at D = 64, K7's two warpgroups take turns (named barriers) at issuing
//    S^T and dP^T, so one's products run while the other's elementwise step
//    does; a warpgroup with no key in a tile takes an empty turn (on an
//    H100 they made K7 faster at D = 64 and slower at D = 80, and left K6
//    as it was; PERF.md, Findings);
//  - rings of 4 stages, or 2 in K6 at D = 128: K7's Q/dO (and lse, delta)
//    4 x 33, 4 x 21 or 4 x 17 KB (D = 128, 80, 64) beside 64, 40 or 32 KB of
//    resident K/V, K6's K/V 2 x 64, 4 x 40 or 4 x 32 KB beside 64, 40 or
//    32 KB of resident Q/dO.
// Masks, windows, the softcap, G > 1 (f32 head partials for the sum pass),
// the f32 dq and the no-atomics ownership are those of the kernels above.

constexpr int kD80 = 80;
constexpr int kDqNarrowKeys = 128;   // keys of a K6 K/V tile
constexpr int kDkvNarrowKeys = 128;  // keys of a K7 block: 64 a warpgroup

// A (rows, D) bf16 tile, D = 64, 80 or 128, of rows * 2D bytes: a 64-column
// block, 128-byte swizzled (rows x 128 bytes), then at D = 80 a 16-column
// block, 32-byte swizzled (rows x 32 bytes; the 16-byte chunk c of row r at
// chunk c ^ ((r / 4) % 2)), or at D = 128 a second 64-column block like the
// first.  At D = 64 the narrow kernels use the first block alone.
template <int D>
struct TileN {
  static_assert(D == 64 || D == kD80 || D == 128, "a TileN holds 64, 80 or 128 columns");
  static constexpr int bytes(int rows) { return rows * 2 * D; }
  // Rows row0 .. row0 + rows - 1 of `head`: `wide` reads boxes of 64
  // columns (twice at D = 128, at columns 0 and 64), `narrow` boxes of 16
  // (read at D = 80 only).
  __device__ static void load(uint32_t dst, const CUtensorMap* wide, const CUtensorMap* narrow,
                              uint32_t bar, int rows, int head, int row0, int b) {
    tma_load(dst, wide, bar, 0, head, row0, b);
    if constexpr (D == kD80) tma_load(dst + rows * 128, narrow, bar, 64, head, row0, b);
    if constexpr (D == 128) tma_load(dst + rows * 128, wide, bar, 64, head, row0, b);
  }
  // load's reverse: the tile at src into rows row0 .. of `head` (TMA
  // stores; rows past the tensor's end are not written).
  __device__ static void store(uint32_t src, const CUtensorMap* wide, const CUtensorMap* narrow,
                               int rows, int head, int row0, int b) {
    tma_store(src, wide, 0, head, row0, b);
    if constexpr (D == kD80) tma_store(src + rows * 128, narrow, 64, head, row0, b);
    if constexpr (D == 128) tma_store(src + rows * 128, wide, 64, head, row0, b);
  }
  // The address of the 16-byte chunk c (columns 8 c .. 8 c + 7) of row r of
  // a tile of `rows` rows, in its block's swizzle.
  __device__ static uint32_t chunk(uint32_t tile, int rows, int r, int c) {
    if (D == kD80 && c >= 8) return tile + rows * 128 + r * 32 + (((c - 8) ^ (r >> 2)) & 1) * 16;
    return tile + (c >> 3) * rows * 128 + r * 128 + ((c ^ r) & 7) * 16;
  }
  // K-major operand: columns 16 kk .. 16 kk + 15 of rows r0 .. of a tile of
  // `rows` rows (64-column block kk / 4, or at D = 80 the 16-column block).
  __device__ static uint64_t kmajor(uint32_t tile, int rows, int r0, int kk) {
    if (D == kD80 && kk >= 4) return desc(tile + rows * 128 + r0 * 32, 16, 256, kSw32);
    return desc(tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32, 16, 1024);
  }
  // acc (64 x D) += A B: A (64 x 16) from the registers a, B the rows 16 kk
  // .. 16 kk + 15 of a tile of `rows` rows (MN-major): m64n64 on the 64-column
  // block, at D = 80 m64n16 on the 16-column one, at D = 128 one m64n128 over
  // both 64-column blocks (rows * 128 bytes apart), the accumulator's columns
  // in order.
  __device__ static void mma(float (&acc)[D / 2], const uint32_t* a, uint32_t tile, int rows,
                             int kk) {
    if constexpr (D == 128) {
      wgmma_rs<128>(acc, a, desc(tile + kk * 2048, rows * 128, 1024), 1);
    } else {
      wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(acc), a,
                   desc(tile + kk * 2048, rows * 128, 1024), 1);
      if constexpr (D == kD80)
        wgmma_rs<16>(*reinterpret_cast<float(*)[8]>(acc + 32), a,
                     desc(tile + rows * 128 + kk * 512, rows * 32, 256, kSw32), 1);
    }
  }
};

// 2^x without branches (a result below 2^-126 flushes to 0; 2^-inf = 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The elementwise step of the narrow K6 and K7 on a 64-row score tile in the
// accumulator's layout (NE values a thread: 64 x 64 in K7, 64 x 128 in K6),
// without a branch inside (kCapped and kMasked are uniform): p = exp(s - lse)
// with s = c tanh(raw scale / c) or raw scale, computed as 2^(s log2 e - lse
// log2 e); p = 0 where the mask hides the pair.  Element j sits at row
// rows[(j / 2) % 2] (a key in K7, kRowsAreKeys; a query in K6) and column
// col0 + acc_col(j); `lse2(j)` is lse log2 e of its query.  The tile keeps
// p [(1 - t^2)] (the factor dS takes); pa, if not null, gets p as bf16 pairs.
struct MaskN {
  int q_end, window;  // window: INT_MAX for none
};

template <bool kCapped, bool kMasked, bool kRowsAreKeys, int NE, typename Lse>
__device__ __forceinline__ void probs_narrow(float (&s)[NE], uint32_t* pa, Lse lse2, float mul,
                                             float softcap, const int (&rows)[2], int col0,
                                             int lane, MaskN mk) {
#pragma unroll
  for (int j = 0; j < NE; j += 2) {
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float raw = s[j + e];
      float arg, chain = 1.f;
      if (kCapped) {
        const float th = tanhf(raw * mul);
        arg = fmaf(softcap * th, kLog2e, -lse2(j + e));
        chain = 1.f - th * th;
      } else {
        arg = fmaf(raw, mul, -lse2(j + e));  // mul = scale log2 e here
      }
      if (kMasked) {
        const int a = rows[(j >> 1) & 1], c = col0 + acc_col(j + e, lane);
        const int qi = kRowsAreKeys ? c : a, kj = kRowsAreKeys ? a : c;
        if (!(kj <= qi && qi < mk.q_end && qi - kj < mk.window)) arg = -INFINITY;
      }
      p[e] = exp2_ftz(arg);
      s[j + e] = kCapped ? p[e] * chain : p[e];
    }
    if (pa) pa[j >> 1] = pack_bf16(p[0], p[1]);
  }
}

// probs_narrow with its uniform choices made once.
template <bool kRowsAreKeys, int NE, typename Lse>
__device__ __forceinline__ void probs_narrow_any(bool capped, bool masked, float (&s)[NE],
                                                 uint32_t* pa, Lse lse2, float mul,
                                                 float softcap, const int (&rows)[2], int col0,
                                                 int lane, MaskN mk) {
  if (capped) {
    if (masked)
      probs_narrow<true, true, kRowsAreKeys>(s, pa, lse2, mul, softcap, rows, col0, lane, mk);
    else
      probs_narrow<true, false, kRowsAreKeys>(s, pa, lse2, mul, softcap, rows, col0, lane, mk);
  } else {
    if (masked)
      probs_narrow<false, true, kRowsAreKeys>(s, pa, lse2, mul, softcap, rows, col0, lane, mk);
    else
      probs_narrow<false, false, kRowsAreKeys>(s, pa, lse2, mul, softcap, rows, col0, lane, mk);
  }
}

// The two consumer warpgroups take turns at issuing products (named
// barriers 2 and 3): warpgroup w waits on barrier 2 + w, issues, and lets the
// other go on barrier 3 - w.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - wg), "n"(kConsumers) : "memory");
}
// Warpgroup w's 128 threads alone (named barrier 4 + w).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(4 + wg) : "memory");
}

// A warpgroup's stage release: once the products that read stage `pending`
// are done (the caller has waited), one arrival of each thread.
__device__ __forceinline__ void release(uint32_t empty, int& pending) {
  if (pending >= 0) mbar_arrive(empty + 8 * pending);
  pending = -1;
}

template <int D>
struct DkvNarrowLayout {
  static constexpr int kStages = 4;  // of the Q/dO ring
  // dP^T is issued once P^T is formed, beside the dV product, so S^T, dP^T
  // and P^T are never in registers at once (at D = 128 beside dV and dK)
  static constexpr bool kLateDP = D == 128;
  static constexpr int kKV = TileN<D>::bytes(kDkvNarrowKeys);  // resident K or V
  static constexpr int kT = TileN<D>::bytes(kTile);            // one Q or dO tile
  static constexpr int kStage = 2 * kT + 2 * kTile * 4;  // Q, dO, then lse, delta
  static constexpr int kBars = 2 * kKV + kStages * kStage;  // kv_full, full[], empty[]
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block takes at most 227 KB of shared memory");
};

// Each map comes twice: 64-column boxes and 16-column boxes (at D = 64 the
// second is the first again, unread).
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
dkv_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tq16, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tk16, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tv16,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdo16, const float* __restrict__ lse,
                  const float* __restrict__ delta, void* __restrict__ dk,
                  void* __restrict__ dv, Shape sh) {
  using L = DkvNarrowLayout<D>;
  using T = TileN<D>;
  constexpr int NS = L::kStages;
  // At D = 64 the warpgroups take turns at issuing S^T and dP^T, so one's
  // products run while the other's elementwise step does (at D = 80 the
  // turns cost more than they gave)
  constexpr bool kTurns = D == 64;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sK = base, sV = base + L::kKV;
  const uint32_t sStage = base + 2 * L::kKV;  // stage st: Q at + st kStage, dO, lse, delta
  const uint32_t kv_full = base + L::kBars, full = kv_full + 8, empty = full + 8 * NS;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const int k0 = blockIdx.y * kDkvNarrowKeys;  // block 0, the heaviest, first
  const int k1 = min(k0 + kDkvNarrowKeys, sh.s) - 1;
  const int qt_first = k0 / kTile;
  const int qt_last = (sh.window > 0 ? min(sh.s - 1, k1 + sh.window - 1) : sh.s - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the copies' thread, then warp 1
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {  // starts every copy
      mbar_expect_tx(kv_full, 2 * L::kKV);
      T::load(sK, &tk, &tk16, kv_full, kDkvNarrowKeys, kvh, k0, b);
      T::load(sV, &tv, &tv16, kv_full, kDkvNarrowKeys, kvh, k0, b);
      for (int qt = qt_first; qt <= qt_last; ++qt) {
        const int i = qt - qt_first, st = i % NS;
        if (i >= NS) mbar_wait(empty + 8 * st, (i / NS - 1) & 1);
        const uint32_t bar = full + 8 * st, dst = sStage + st * L::kStage;
        mbar_expect_tx(bar, 2 * L::kT);
        T::load(dst, &tq, &tq16, bar, kTile, h, qt * kTile, b);
        T::load(dst + L::kT, &tdo, &tdo16, bar, kTile, h, qt * kTile, b);
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {  // warp 1: lse log2 e, delta
      const int lane = threadIdx.x - 32;
      const long long row_off = (long long)bh * sh.s;
      for (int qt = qt_first; qt <= qt_last; ++qt) {
        const int i = qt - qt_first, st = i % NS;
        if (i >= NS) mbar_wait(empty + 8 * st, (i / NS - 1) & 1);
        float* rows = reinterpret_cast<float*>(gbase + st * L::kStage + 2 * (L::kKV + L::kT));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * lane + e, qi = qt * kTile + c;
          rows[c] = qi < sh.s ? lse[row_off + qi] * kLog2e : 0.f;
          rows[kTile + c] = qi < sh.s ? delta[row_off + qi] : 0.f;
        }
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }
  set_max_registers_inc<kConsumerRegs>();

  const int t = threadIdx.x - 128;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const bool capped = sh.softcap > 0.f;
  const float mul = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
  const MaskN mk = {sh.s, sh.window > 0 ? sh.window : INT_MAX};
  const int kw = k0 + wg * kTile;  // this warpgroup's first key
  const bool live = kw < sh.s;
  const int kw_last = min(kw + kTile, sh.s) - 1;
  const int wq_first = kw / kTile;
  const int wq_last =
      (sh.window > 0 ? min(sh.s - 1, kw_last + sh.window - 1) : sh.s - 1) / kTile;
  const int key[2] = {kw + acc_row(0, warp, lane), kw + acc_row(2, warp, lane)};
  float dv_acc[D / 2], dk_acc[D / 2];  // dK unscaled
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  uint32_t pa[16] = {}, da[16] = {};  // P^T, dS^T: A operands of products in flight
  int pending = -1;                   // the stage those products read

  mbar_wait(kv_full, 0);
  if constexpr (kTurns)
    if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  for (int qt = qt_first; qt <= qt_last; ++qt) {
    const int i = qt - qt_first, st_i = i % NS;
    const uint32_t sQ = sStage + st_i * L::kStage, sdO = sQ + L::kT;
    if (!live || qt < wq_first || qt > wq_last) {  // none of our keys sees the tile
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(da);
      release(empty, pending);
      mbar_wait(full + 8 * st_i, (i / NS) & 1);
      mbar_arrive(empty + 8 * st_i);
      if constexpr (kTurns) {  // an empty turn: each warpgroup takes one a tile
        turn_wait(wg);
        turn_pass(wg);
      }
      continue;
    }
    const int q0 = qt * kTile;
    const float* lse_c =  // lse log2 e
        reinterpret_cast<const float*>(gbase + st_i * L::kStage + 2 * (L::kKV + L::kT));
    const float* delta_c = lse_c + kTile;
    mbar_wait(full + 8 * st_i, (i / NS) & 1);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), two groups (at
    // L::kLateDP, dP^T later)
    if constexpr (kTurns) turn_wait(wg);
    float sc[32], dp[32];
    auto issue_dp = [&] {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, 0>(dp, T::kmajor(sV, kDkvNarrowKeys, wg * kTile, kk),
                        T::kmajor(sdO, kTile, 0, kk), kk > 0);
      wgmma_commit();
    };
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    if constexpr (!L::kLateDP) fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64, 0>(sc, T::kmajor(sK, kDkvNarrowKeys, wg * kTile, kk),
                      T::kmajor(sQ, kTile, 0, kk), kk > 0);
    wgmma_commit();
    if constexpr (!L::kLateDP) issue_dp();
    if constexpr (kTurns) turn_pass(wg);
    wgmma_wait<L::kLateDP ? 0 : 1>();  // S^T, and the last tile's dV and dK, are done
    fence_regs(sc);
    fence_regs(pa);
    fence_regs(da);
    release(empty, pending);

    // P^T = exp(s - lse) to bf16 for dV; sc keeps P^T [(1 - t^2)] for dS^T
    const bool masked = !(kw + kTile - 1 <= q0 && q0 + kTile - 1 < sh.s &&
                          (sh.window <= 0 || q0 + kTile - 1 - kw < sh.window));
    probs_narrow_any<true>(capped, masked, sc, pa,
                           [&](int j) { return lse_c[acc_col(j, lane)]; }, mul, sh.softcap, key,
                           q0, lane, mk);
    // dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) T::mma(dv_acc, pa + 4 * kk, sdO, kTile, kk);
    wgmma_commit();
    if constexpr (L::kLateDP) {
      fence_regs(dp);
      wgmma_fence();
      issue_dp();
      wgmma_wait<0>();  // dV and dP^T are done
      fence_regs(pa);
    } else {
      wgmma_wait<1>();  // dP^T is done
    }
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta) [(1 - t^2)] to bf16; dK += dS^T Q
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int ci = acc_col(j, lane);
      da[j >> 1] = pack_bf16(sc[j] * (dp[j] - delta_c[ci]), sc[j + 1] * (dp[j + 1] - delta_c[ci + 1]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) T::mma(dk_acc, da + 4 * kk, sQ, kTile, kk);
    wgmma_commit();
    pending = st_i;
  }
  if constexpr (kTurns)
    if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  fence_regs(pa);
  fence_regs(da);

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= sh.s) continue;
    if (kPartial) {
      const long long off = (((long long)b * sh.s + key[r]) * sh.h + h) * D + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + off + 8 * n) =
            make_float2(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + off + 8 * n) = make_float2(
            dk_acc[4 * n + 2 * r] * sh.scale, dk_acc[4 * n + 2 * r + 1] * sh.scale);
      }
    } else {
      const long long off = (((long long)b * sh.s + key[r]) * sh.kv + kvh) * D + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dv) + off + 8 * n) =
            pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dk) + off + 8 * n) = pack_bf16(
            dk_acc[4 * n + 2 * r] * sh.scale, dk_acc[4 * n + 2 * r + 1] * sh.scale);
      }
    }
  }
}

template <int D>
struct DqNarrowLayout {
  static constexpr int kStages = D == 128 ? 2 : 4;  // of the K/V ring
  // the last tile's dQ product is waited for before the next tile's S and
  // dP are issued, so dS leaves the registers first
  static constexpr bool kDrain = D == 128;
  static constexpr int kRows = 2 * kTile;                     // two warpgroups' rows
  static constexpr int kQ = TileN<D>::bytes(kRows);           // the Q or the dO tile
  static constexpr int kKV = TileN<D>::bytes(kDqNarrowKeys);  // one K or V tile
  static constexpr int kStage = 2 * kKV;                      // K, then V
  static constexpr int kBars = 2 * kQ + kStages * kStage;     // qd_full, full[], empty[]
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block takes at most 227 KB of shared memory");
};

// Each map comes twice, as in dkv_narrow_kernel.
template <int D, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
dq_narrow_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tq16,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tk16,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tv16,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdo16, const float* __restrict__ lse,
                 const float* __restrict__ delta, void* __restrict__ dq, Shape sh) {
  using L = DqNarrowLayout<D>;
  constexpr int NK = kDqNarrowKeys, NS = L::kStages;
  using T = TileN<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sQ = base, sdO = base + L::kQ;
  const uint32_t sKV = base + 2 * L::kQ;  // stage st: K at + st kStage, V after it
  const uint32_t qd_full = base + L::kBars, full = qd_full + 8, empty = full + 8 * NS;

  const int bh = blockIdx.x, b = bh / sh.h, h = bh % sh.h;
  const int kvh = h / (sh.h / sh.kv);
  const int n_qt = (sh.s + L::kRows - 1) / L::kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * L::kRows;  // heaviest tiles first
  const int kt_first = sh.window > 0 ? max(0, q0 - sh.window + 1) / NK : 0;
  const int kt_last = (min(q0 + L::kRows, sh.s) - 1) / NK;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread starts every copy
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * L::kQ);
      T::load(sQ, &tq, &tq16, qd_full, L::kRows, h, q0, b);
      T::load(sdO, &tdo, &tdo16, qd_full, L::kRows, h, q0, b);
      for (int kt = kt_first; kt <= kt_last; ++kt) {
        const int i = kt - kt_first, st = i % NS;
        if (i >= NS) mbar_wait(empty + 8 * st, (i / NS - 1) & 1);
        const uint32_t bar = full + 8 * st, dst = sKV + st * L::kStage;
        mbar_expect_tx(bar, L::kStage);
        T::load(dst, &tk, &tk16, bar, NK, kvh, kt * NK, b);
        T::load(dst + L::kKV, &tv, &tv16, bar, NK, kvh, kt * NK, b);
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
  const int wk_first = sh.window > 0 ? max(0, r0 - sh.window + 1) / NK : 0;
  const int wk_last = (min(r0 + kTile, sh.s) - 1) / NK;
  const int row[2] = {r0 + acc_row(0, warp, lane), r0 + acc_row(2, warp, lane)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row[r] < sh.s ? lse[(long long)bh * sh.s + row[r]] : 0.f;
    delta_r[r] = row[r] < sh.s ? delta[(long long)bh * sh.s + row[r]] : 0.f;
  }

  const bool capped = sh.softcap > 0.f;
  const float mul = capped ? sh.scale / sh.softcap : sh.scale * kLog2e;
  const MaskN mk = {sh.s, sh.window > 0 ? sh.window : INT_MAX};
  const float lse2[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};
  float acc[D / 2];  // dq / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[NK / 4] = {};  // dS: the A operand of the dQ product in flight
  int pending = -1;          // the stage it reads

  mbar_wait(qd_full, 0);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int i = kt - kt_first, st_i = i % NS;
    const uint32_t sK = sKV + st_i * L::kStage, sV = sK + L::kKV;
    if (!live || kt < wk_first || kt > wk_last) {  // no row of ours sees the tile
      wgmma_wait<0>();
      fence_regs(da);
      release(empty, pending);
      mbar_wait(full + 8 * st_i, (i / NS) & 1);
      mbar_arrive(empty + 8 * st_i);
      continue;
    }
    const int k0 = kt * NK;
    mbar_wait(full + 8 * st_i, (i / NS) & 1);
    if constexpr (L::kDrain) {
      wgmma_wait<0>();
      fence_regs(da);
      release(empty, pending);
    }

    // S = Q K^T and dP = dO V^T (64 rows x 128 keys), two groups
    float sc[NK / 2], dp[NK / 2];
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NK, 0>(sc, T::kmajor(sQ, L::kRows, wg * kTile, kk),
                      T::kmajor(sK, NK, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<NK, 0>(dp, T::kmajor(sdO, L::kRows, wg * kTile, kk),
                      T::kmajor(sV, NK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last tile's dQ product, are done
    fence_regs(sc);
    fence_regs(da);
    release(empty, pending);

    // P = exp(s - lse) [(1 - t^2)] while dP runs
    const bool masked = !(k0 + NK - 1 <= r0 && r0 + kTile - 1 < sh.s &&
                          (sh.window <= 0 || r0 + kTile - 1 - k0 < sh.window));
    probs_narrow_any<false>(capped, masked, sc, nullptr,
                            [&](int j) { return lse2[(j >> 1) & 1]; }, mul, sh.softcap, row, k0,
                            lane, mk);
    wgmma_wait<0>();  // dP is done
    fence_regs(dp);

    // dS = P (dP - delta) [(1 - t^2)] to bf16; dQ += dS K (K MN-major)
#pragma unroll
    for (int j = 0; j < NK / 2; j += 2) {
      const int r = (j >> 1) & 1;
      da[j >> 1] = pack_bf16(sc[j] * (dp[j] - delta_r[r]), sc[j + 1] * (dp[j + 1] - delta_r[r]));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) T::mma(acc, da + 4 * kk, sK, NK, kk);
    wgmma_commit();
    pending = st_i;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(da);

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

// -- K5 at head_dim 64, 80 and 128 --------------------------------------------
//
// fwd_kernel above was shaped for D = 256, where the products dominate.  At
// D <= 80 they are short, and the exp, the mask and the softmax's bookkeeping
// are as much of a tile's time as the products: 128 exps a row of a 128-key
// tile take the SM's 16 exp units about as long as the tile's two products
// take its tensor cores; and a short block's start (its Q and first K/V
// loads) and end (its stores) weigh on it.  At D = 128 the products are 1.6x
// as long for the same exps, but fwd_kernel, waiting for each in turn, left
// the tensor cores idle through every softmax.  So the narrow forward
// overlaps them all:
//  - tiles at the true width (TileN<D>: Q, K and V at 80 columns as a
//    64-column and a 16-column block, at 64 as one, at 128 as two 64-column
//    blocks), S = Q K^T at k = D and O += P V at N = D: no padded work;
//  - work items of one (batch*head, 128-query tile), two consumer warpgroups
//    of 64 rows each, as fwd_kernel, but persistent blocks, one an SM, that
//    walk the items heaviest first (NarrowItem): Q buffers and K/V rings
//    that run on across items, so the next item's loads overlap this one's
//    last tiles and its stores;
//  - K/V in 128-key tiles (S at m64n128, 64 f32 a thread) through a K ring
//    and a V ring with barriers of their own: a K stage is released once
//    the S that read it is done, a V stage once its P V is, and K tile t is
//    loaded before V tile t-1, so the next K tile loads while the last P V
//    still reads its V.  Shared memory sets the depth (FwdNarrowLayout): 2 Q
//    buffers and 4 stages a ring at D = 64 and 80; at 128, where a tile is
//    32 KB, 2 stages a ring (1 Q buffer and 3 stages, 64-key tiles in 4
//    stages, and no turns between the warpgroups all read slower there);
//  - O leaves through shared memory: each warpgroup writes its 64 x D tile
//    in the swizzle of the output's tensor map, and one thread stores it
//    with TMA, so the next item starts while the store runs (O written from
//    registers, four bytes a thread at a time, was a third of the kernel's
//    time at D = 128).  With the two O tiles a block takes 176 KB at D =
//    64, 220 KB at 80 and 224 KB at 128;
//  - inside a warpgroup, tile t's S = Q K^T is issued before tile t-1's
//    O += P V, O is rescaled while S runs, and tile t's exp and mask run
//    while P V runs (two commit groups, wait_group 1); P is packed to bf16
//    once P V has read the last P; a Q buffer is released once the item's
//    last S is done;
//  - between the warpgroups, turns (named barriers) at issuing products, so
//    one warpgroup's products run while the other's softmax does;
//  - an elementwise step with no branch inside: the softcap and "is this
//    tile masked for my rows" are uniform choices made once a tile; the mask
//    is an exponent of -inf through ex2.approx.ftz; the row max is taken on
//    the raw scores, so the scale (log2 e folded in) and the max go into one
//    FFMA (the scale must be positive); a row that has seen no visible key
//    subtracts a stand-in of 0, chosen once a row, so p and alpha are 0 (on
//    an O and l still 0) and never NaN.
// Key tiles start at absolute multiples of 128 and a query offset is a
// multiple of the 128-row query tile, so each row of an offset launch visits
// the same tiles in the same order as in the launch without one.  The LSE
// and the row-with-no-visible-key contract are fwd_kernel's.

constexpr int kFwdNarrowKeys = 128;  // keys of a K/V tile of fwd_narrow_kernel
constexpr int kFwdNarrowQBufs = 2;   // its Q buffers

template <int D>
struct FwdNarrowLayout {
  // stages of the K ring and of the V ring: as many as a block's shared
  // memory holds (4-stage rings at D = 128 would take 352 KB in all)
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQRows = 2 * kTile;                      // two warpgroups' rows
  static constexpr int kQ = TileN<D>::bytes(kQRows);            // one Q buffer
  static constexpr int kKV = TileN<D>::bytes(kFwdNarrowKeys);   // one K or V stage
  static constexpr int kO = TileN<D>::bytes(kTile);             // a warpgroup's O tile
  // Q buffers, the K ring, the V ring, the two O tiles; then the barriers
  // q_full[], q_empty[], k_full[], k_empty[], v_full[], v_empty[]
  static constexpr int kBars = kFwdNarrowQBufs * kQ + 2 * kStages * kKV + 2 * kO;
  static constexpr int kBytes = kBars + 2 * (kFwdNarrowQBufs + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block takes at most 227 KB of shared memory");
};

// A block of fwd_narrow_kernel is persistent: it runs the work items (one
// (batch*head, 128-query tile) each) k = 0, 1, .. of a list, item k*P + c on
// even rounds and k*P + P-1-c on odd ones (c the block, P the blocks).  The
// list takes the heads in groups of hg = P / n_qt (P is launched as hg n_qt
// where n_qt <= the SMs), each group's items heaviest first: a round is then
// one group, whose K/V the L2 holds while its blocks read them, and over two
// rounds a block takes a heavy item and a light one, so that each block's
// total is close to the mean.  (Heaviest first over all heads kept every
// head's K/V in use at once, 42 MB at zamba2's shape, and read them slower.)
// Where n_qt > P (S > 16,896 on 132 SMs) a round holds part of one head, and
// the list is heaviest first over all heads, one group.
struct NarrowItem {
  int b, h, kvh, lq0, q0, kt_first, kt_last;  // lq0 local, q0 absolute
};

__device__ __forceinline__ int narrow_item_index(int k, int c, int p) {
  return k * p + ((k & 1) ? p - 1 - c : c);
}

__device__ __forceinline__ NarrowItem narrow_item(int w, const Shape& sh, int n_qt, int p) {
  NarrowItem it;
  // heads in groups of hg = p / n_qt (all of them where p < n_qt), each
  // group's items heaviest first
  const int bhs = sh.b * sh.h, hg = p >= n_qt ? min(bhs, p / n_qt) : bhs;
  const int group = w / (hg * n_qt), in_group = min(hg, bhs - group * hg);
  const int r = w - group * hg * n_qt, bh = group * hg + r % in_group;
  it.b = bh / sh.h;
  it.h = bh % sh.h;
  it.kvh = it.h / (sh.h / sh.kv);
  it.lq0 = (n_qt - 1 - r / in_group) * 2 * kTile;
  it.q0 = sh.q0 + it.lq0;
  it.kt_first = sh.window > 0 ? max(0, it.q0 - sh.window + 1) / kFwdNarrowKeys : 0;
  it.kt_last = (min(it.q0 + 2 * kTile, sh.q0 + sh.sq) - 1) / kFwdNarrowKeys;
  return it;
}

// The online softmax of a 64 x 128 score tile in the accumulator's layout
// (element j at row rows[(j / 2) % 2], key k0 + acc_col(j)), with no branch
// inside (kCapped, kMasked uniform).  s holds the raw scores Q K^T and leaves
// with p = 2^(x - m) in f32, x the log2-domain score (raw * emul, or c log2 e
// tanh(raw scale / c) with emul 1), -inf where the mask hides the pair; m
// (log2 domain), l and alpha (the factor O still owes) are per row.
template <bool kCapped, bool kMasked, int NE>
__device__ __forceinline__ void online_softmax(float (&s)[NE], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float mul, float cap_mul,
                                               float emul, const int (&rows)[2], int k0,
                                               int lane, int window) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    float x = s[j];
    if (kCapped) x = cap_mul * tanhf(x * mul);
    if (kMasked) {
      const int qi = rows[(j >> 1) & 1], kj = k0 + acc_col(j, lane);
      if (!(kj <= qi && qi - kj < window)) x = -INFINITY;
    }
    s[j] = x;
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * emul);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: a finite stand-in
    alpha[r] = exp2_ftz(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int r = (j >> 1) & 1;
    const float p = exp2_ftz(fmaf(s[j], emul, -m_use[r]));
    l[r] += p;  // this thread's share of the row; summed over the quad at the end
    s[j] = p;
  }
}

// S = Q K^T of one 128-key tile (a 64-row warpgroup's slice), issued and
// committed as one group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kFwdNarrowKeys / 2], uint32_t sQ,
                                             uint32_t sK, int wg) {
  using T = TileN<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kFwdNarrowKeys, 0>(s, T::kmajor(sQ, FwdNarrowLayout<D>::kQRows, wg * kTile, kk),
                                T::kmajor(sK, kFwdNarrowKeys, 0, kk), kk > 0);
  wgmma_commit();
}

// O += P V of one 128-key tile, P the bf16 A operands in registers, issued
// and committed as one group.  O (just rescaled) and P (just packed) are
// pinned first: left free, the compiler may sink a write to them below the
// fence (at D = 80, into the 16-column product's operands), and ptxas then
// serializes every wgmma of the kernel.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[kFwdNarrowKeys / 4],
                                         uint32_t sV) {
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kFwdNarrowKeys / 16; ++kk)
    TileN<D>::mma(acc, pa + 4 * kk, sV, kFwdNarrowKeys, kk);
  wgmma_commit();
}

// What a consumer warpgroup of fwd_narrow_kernel holds across its tiles:
// O (f32, 64 x D), the scores S or probabilities P of the tile in hand
// (f32), P as bf16 pairs (the A operand of O += P V), and per row m (log2
// domain), l and alpha (the factor O still owes).
template <int D>
struct NarrowState {
  float acc[D / 2], s[kFwdNarrowKeys / 2], m[2], l[2], alpha[2];
  uint32_t pa[kFwdNarrowKeys / 4];
};

// What stays fixed over a warpgroup's run.
struct NarrowConst {
  uint32_t sQ;
  int wg, lane, window, rows[2];
  float mul, cap_mul, emul;  // scale / c, c log2 e, raw score -> log2 domain
};

// One use of a ring's stage: its tile, its barriers and the parity of this
// use's phase.
struct RingUse {
  uint32_t tile, full, empty, parity;
};

// One tile of a warpgroup's run: S = Q K^T of this tile (K in `k`); unless
// kFirst, O rescaled and O += P V of the last tile (V in `v_prev`) issued
// behind it; this tile's K stage released once S is done; this tile's
// softmax while P V runs; the last tile's V stage released once P V is done;
// P packed to bf16.  The uniform choices are template arguments, made by the
// caller once a tile around the whole step, so no branch is taken while a
// product is in flight.
template <int D, bool kCapped, bool kMasked, bool kFirst>
__device__ __forceinline__ void narrow_tile(NarrowState<D>& st, const NarrowConst& c,
                                            const RingUse& k, const RingUse& v_prev, int k0) {
  mbar_wait(k.full, k.parity);
  if (!kFirst) mbar_wait(v_prev.full, v_prev.parity);
  turn_wait(c.wg);
  issue_scores<D>(st.s, c.sQ, k.tile, c.wg);
  if (kFirst) {
    turn_pass(c.wg);
    wgmma_wait<0>();
  } else {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) st.acc[j] *= st.alpha[(j >> 1) & 1];
    issue_pv<D>(st.acc, st.pa, v_prev.tile);
    turn_pass(c.wg);
    wgmma_wait<1>();  // S is done; the last tile's P V runs on
  }
  fence_regs(st.s);
  mbar_arrive(k.empty);  // no product of ours reads this K stage any more
  online_softmax<kCapped, kMasked>(st.s, st.m, st.l, st.alpha, c.mul, c.cap_mul, c.emul, c.rows,
                                   k0, c.lane, c.window);
  if (!kFirst) {
    wgmma_wait<0>();  // the last tile's P V is done: its V stage and P are free
    fence_regs(st.acc);
    fence_regs(st.pa);
    mbar_arrive(v_prev.empty);
  }
#pragma unroll
  for (int j = 0; j < kFwdNarrowKeys / 4; ++j) st.pa[j] = pack_bf16(st.s[2 * j], st.s[2 * j + 1]);
}

// narrow_tile with its uniform choices made: the softcap, and whether the
// mask hides a pair of the tile from a row of this warpgroup.
template <int D, bool kFirst>
__device__ __forceinline__ void narrow_tile_any(bool capped, bool masked, NarrowState<D>& st,
                                                const NarrowConst& c, const RingUse& k,
                                                const RingUse& v_prev, int k0) {
  if (capped) {
    if (masked)
      narrow_tile<D, true, true, kFirst>(st, c, k, v_prev, k0);
    else
      narrow_tile<D, true, false, kFirst>(st, c, k, v_prev, k0);
  } else {
    if (masked)
      narrow_tile<D, false, true, kFirst>(st, c, k, v_prev, k0);
    else
      narrow_tile<D, false, false, kFirst>(st, c, k, v_prev, k0);
  }
}

// Each map comes twice: 64-column boxes and 16-column boxes (at D = 64 and
// 128 the second is the first again, unread).  Launched with at most one
// block an SM; the blocks walk the work items (NarrowItem).  The K and V
// rings run on across items, and with two Q buffers the next item's Q loads
// while this item's last tiles compute.  O leaves through shared memory: a
// warpgroup writes its 64 x D tile there in the map's swizzle, and one
// thread stores it with TMA while the warpgroup goes on to its next item
// (the tile's buffer is reused once that store has read it).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_narrow_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tq16,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tk16,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tv16,
                  const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap to16,
                  float* __restrict__ lse, Shape sh) {
  using L = FwdNarrowLayout<D>;
  using T = TileN<D>;
  constexpr int NK = kFwdNarrowKeys, NS = L::kStages, QB = kFwdNarrowQBufs;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  // Q buffer qb at base + qb kQ; stage st of the K ring at sK + st kKV, of
  // the V ring at sV + st kKV; warpgroup w's O tile at sV + NS kKV + w kO
  const uint32_t sK = base + QB * L::kQ, sV = sK + NS * L::kKV;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8 * QB, k_full = q_empty + 8 * QB,
                 k_empty = k_full + 8 * NS, v_full = k_empty + 8 * NS, v_empty = v_full + 8 * NS;
  const int n_qt = (sh.sq + L::kQRows - 1) / L::kQRows;
  const int n_items = sh.b * sh.h * n_qt, c0 = blockIdx.x, p = gridDim.x;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < QB; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, kConsumers);
    }
    for (int st = 0; st < NS; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, kConsumers);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread starts every copy
    set_max_registers_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      // K tile g is loaded before V tile g - 1: S needs a tile's K a step
      // before P V needs its V, and a V stage frees a step after a K stage
      int g = 0;                // K/V tiles loaded so far: the rings' running count
      int v_kvh = 0, v_row = 0, v_b = 0;  // where V tile g - 1 comes from
      auto load_v = [&](int gv) {
        const int st = gv % NS;
        if (gv >= NS) mbar_wait(v_empty + 8 * st, (gv / NS - 1) & 1);
        mbar_expect_tx(v_full + 8 * st, L::kKV);
        T::load(sV + st * L::kKV, &tv, &tv16, v_full + 8 * st, NK, v_kvh, v_row, v_b);
      };
      for (int k = 0;; ++k) {
        const int w = narrow_item_index(k, c0, p);
        if (w >= n_items) break;
        const NarrowItem it = narrow_item(w, sh, n_qt, p);
        const int qb = k % QB;
        if (k >= QB) mbar_wait(q_empty + 8 * qb, (k / QB - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, L::kQ);
        T::load(base + qb * L::kQ, &tq, &tq16, q_full + 8 * qb, L::kQRows, it.h, it.lq0, it.b);
        for (int kt = it.kt_first; kt <= it.kt_last; ++kt, ++g) {
          const int st = g % NS;
          if (g >= NS) mbar_wait(k_empty + 8 * st, (g / NS - 1) & 1);
          mbar_expect_tx(k_full + 8 * st, L::kKV);
          T::load(sK + st * L::kKV, &tk, &tk16, k_full + 8 * st, NK, it.kvh, kt * NK, it.b);
          if (g > 0) load_v(g - 1);
          v_kvh = it.kvh, v_row = kt * NK, v_b = it.b;
        }
      }
      if (g > 0) load_v(g - 1);
    }
    return;
  }
  set_max_registers_inc<kConsumerRegs>();

  const int t = threadIdx.x - 128;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const bool capped = sh.softcap > 0.f;
  const int window = sh.window > 0 ? sh.window : INT_MAX, q_end = sh.q0 + sh.sq;
  // the stage of ring tile i: in the K ring, in the V ring
  auto k_use = [&](int i) {
    return RingUse{sK + (i % NS) * L::kKV, k_full + 8 * (i % NS), k_empty + 8 * (i % NS),
                   (uint32_t)((i / NS) & 1)};
  };
  auto v_use = [&](int i) {
    return RingUse{sV + (i % NS) * L::kKV, v_full + 8 * (i % NS), v_empty + 8 * (i % NS),
                   (uint32_t)((i / NS) & 1)};
  };
  // a tile none of our rows reads: wait for its K and V, so that our
  // arrivals count for this use of their stages, then release both; an
  // empty turn (each warpgroup takes one a tile of the item, and one more)
  auto skip = [&](int i) {
    const RingUse ku = k_use(i), vu = v_use(i);
    mbar_wait(ku.full, ku.parity);
    mbar_arrive(ku.empty);
    mbar_wait(vu.full, vu.parity);
    mbar_arrive(vu.empty);
    turn_wait(wg);
    turn_pass(wg);
  };
  if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
  int g = 0;  // the K/V tiles of the items before this one
  for (int k = 0;; ++k) {
    const int w = narrow_item_index(k, c0, p);
    if (w >= n_items) break;
    const NarrowItem it = narrow_item(w, sh, n_qt, p);
    const int qb = k % QB;
    const int r0 = it.q0 + wg * kTile;  // this warpgroup's first row (absolute)
    const bool live = r0 < q_end;
    // this warpgroup's key tiles, a run inside the item's (none if no row of
    // ours is a query)
    const int wk_first =
        live ? (sh.window > 0 ? max(0, r0 - sh.window + 1) / NK : 0) : it.kt_last + 1;
    const int wk_last = live ? (min(r0 + kTile, q_end) - 1) / NK : it.kt_last;
    const int row[2] = {r0 + acc_row(0, warp, lane), r0 + acc_row(2, warp, lane)};
    const NarrowConst c = {base + qb * L::kQ, wg, lane, window, {row[0], row[1]},
                           sh.scale / sh.softcap, sh.softcap * kLog2e,
                           capped ? 1.f : sh.scale * kLog2e};
    NarrowState<D> st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.acc[i] = 0.f;
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
    // some pair of the tile at k0 is hidden from a row of ours
    auto masked = [&](int k0) { return !(k0 + NK - 1 <= r0 && r0 + kTile - 1 - k0 < window); };
    // the rings' running count of the item's tile kt
    auto ring = [&](int kt) { return g + kt - it.kt_first; };

    // every thread waits for this item's Q, so its release below counts for
    // this use of the buffer
    mbar_wait(q_full + 8 * qb, (k / QB) & 1);
    for (int kt = it.kt_first; kt < wk_first; ++kt) skip(ring(kt));
    if (wk_first <= wk_last) {
      narrow_tile_any<D, true>(capped, masked(wk_first * NK), st, c, k_use(ring(wk_first)),
                               RingUse{}, wk_first * NK);
      for (int kt = wk_first + 1; kt <= wk_last; ++kt)
        narrow_tile_any<D, false>(capped, masked(kt * NK), st, c, k_use(ring(kt)),
                                  v_use(ring(kt) - 1), kt * NK);
      mbar_arrive(q_empty + 8 * qb);  // our last S is done: no product of ours reads this Q
      const RingUse last = v_use(ring(wk_last));
      mbar_wait(last.full, last.parity);
      turn_wait(wg);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) st.acc[j] *= st.alpha[(j >> 1) & 1];
      issue_pv<D>(st.acc, st.pa, last.tile);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(st.acc);
      fence_regs(st.pa);
      mbar_arrive(last.empty);
    } else {
      mbar_arrive(q_empty + 8 * qb);
      turn_wait(wg);
      turn_pass(wg);
    }
    for (int kt = wk_last + 1; kt <= it.kt_last; ++kt) skip(ring(kt));  // as before our run
    g += it.kt_last - it.kt_first + 1;

    if (!live) continue;
    // thread 0 of the warpgroup starts its O stores
    const uint32_t so = sV + NS * L::kKV + wg * L::kO;
    if (t % 128 == 0) bulk_wait<true>();  // the last store from this tile has read it
    wg_sync(wg);
    const long long bh = (long long)it.b * sh.h + it.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float lz = l == 0.f ? 1.f : l;
      const float inv = 1.f / lz;
      // the row in the warpgroup's tile, computed here: the addresses below
      // would otherwise be held across the items
      int tr = acc_row(2 * r, warp, lane);
      asm volatile("" : "+r"(tr));
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        st_shared(T::chunk(so, kTile, tr, n) + 4 * (lane & 3),
                  pack_bf16(st.acc[4 * n + 2 * r] * inv, st.acc[4 * n + 2 * r + 1] * inv));
      if (row[r] < q_end && (lane & 3) == 0)
        lse[bh * sh.sq + row[r] - sh.q0] = (st.m[r] + log2f(lz)) * kLn2;
    }
    fence_async_shared();  // the tile's writes, seen by the TMA store
    wg_sync(wg);
    if (t % 128 == 0) {
      T::store(so, &to, &to16, kTile, it.h, r0 - sh.q0, it.b);
      bulk_commit();
    }
  }
  if (wg == 0) turn_wait(wg);
  if (t % 128 == 0) bulk_wait<false>();  // every store written before the block ends
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
// `cols` columns x `rows` rows of one head, 128-byte swizzled (or as `swizzle`
// says); rows past S read as zeros.  Returns a cudaError_t.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows,
             int cols = 64, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
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
  if (int err = make_map(&tq, q, sh.b, sh.sq, sh.h, D, FwdLayout<D>::kQRows)) return err;
  if (int err = make_map(&tk, k, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = make_map(&tv, v, sh.b, sh.s, sh.kv, D, kTile)) return err;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.sq + FwdLayout<D>::kQRows - 1) / FwdLayout<D>::kQRows);
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

// The two maps of a (B, S, heads, D) tensor for TileN<D>: 64-column boxes
// (128-byte swizzle) and, at D = 80, 16-column boxes (32-byte swizzle); at
// D = 64 and 128 the second is the first again (TileN<64> and TileN<128>
// read the first only).
template <int D>
int make_maps_narrow(CUtensorMap* maps, const void* ptr, int b, int s, int heads, int rows) {
  if (int err = make_map(&maps[0], ptr, b, s, heads, D, rows)) return err;
  if constexpr (D == kD80) {
    return make_map(&maps[1], ptr, b, s, heads, D, rows, 16, CU_TENSOR_MAP_SWIZZLE_32B);
  } else {
    maps[1] = maps[0];
    return 0;
  }
}

// K7 at D = 64, 80 and 128: dkv_narrow_kernel.
template <int D>
int launch_dkv_narrow(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                      cudaStream_t st) {
  auto kernel = sh.h == sh.kv ? dkv_narrow_kernel<D, false> : dkv_narrow_kernel<D, true>;
  constexpr int smem = DkvNarrowLayout<D>::kBytes;
  CUtensorMap m[8];
  if (int err = make_maps_narrow<D>(m, q, sh.b, sh.s, sh.h, kTile)) return err;
  if (int err = make_maps_narrow<D>(m + 2, k, sh.b, sh.s, sh.kv, kDkvNarrowKeys)) return err;
  if (int err = make_maps_narrow<D>(m + 4, v, sh.b, sh.s, sh.kv, kDkvNarrowKeys)) return err;
  if (int err = make_maps_narrow<D>(m + 6, dout, sh.b, sh.s, sh.h, kTile)) return err;
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + kDkvNarrowKeys - 1) / kDkvNarrowKeys);
  kernel<<<grid, kThreads, smem, st>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                                       static_cast<const float*>(lse),
                                       static_cast<const float*>(delta), dk, dv, sh);
  return (int)cudaGetLastError();
}

// K6 at D = 64, 80 and 128: dq_narrow_kernel.
template <int D>
int launch_dq_narrow(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int dq_dtype, const Shape& sh,
                     cudaStream_t st) {
  if (dq_dtype < 0 || dq_dtype > 1) return (int)cudaErrorInvalidValue;
  auto kernel = dq_dtype == 1 ? dq_narrow_kernel<D, false> : dq_narrow_kernel<D, true>;
  using L = DqNarrowLayout<D>;
  CUtensorMap m[8];
  if (int err = make_maps_narrow<D>(m, q, sh.b, sh.s, sh.h, L::kRows)) return err;
  if (int err = make_maps_narrow<D>(m + 2, k, sh.b, sh.s, sh.kv, kDqNarrowKeys)) return err;
  if (int err = make_maps_narrow<D>(m + 4, v, sh.b, sh.s, sh.kv, kDqNarrowKeys)) return err;
  if (int err = make_maps_narrow<D>(m + 6, dout, sh.b, sh.s, sh.h, L::kRows)) return err;
  if (int err = prepare(kernel, L::kBytes)) return err;
  const dim3 grid(sh.b * sh.h, (sh.s + L::kRows - 1) / L::kRows);
  kernel<<<grid, kThreads, L::kBytes, st>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
                                            static_cast<const float*>(lse),
                                            static_cast<const float*>(delta), dq, sh);
  return (int)cudaGetLastError();
}

template <>
int launch_dkv<64>(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                   cudaStream_t st) {
  return launch_dkv_narrow<64>(q, k, v, dout, lse, delta, dk, dv, sh, st);
}

template <>
int launch_dkv<80>(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                   cudaStream_t st) {
  return launch_dkv_narrow<80>(q, k, v, dout, lse, delta, dk, dv, sh, st);
}

template <>
int launch_dkv<128>(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, const Shape& sh,
                    cudaStream_t st) {
  return launch_dkv_narrow<128>(q, k, v, dout, lse, delta, dk, dv, sh, st);
}

template <>
int launch_dq<64>(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int dq_dtype, const Shape& sh,
                  cudaStream_t st) {
  return launch_dq_narrow<64>(q, k, v, dout, lse, delta, dq, dq_dtype, sh, st);
}

template <>
int launch_dq<80>(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int dq_dtype, const Shape& sh,
                  cudaStream_t st) {
  return launch_dq_narrow<80>(q, k, v, dout, lse, delta, dq, dq_dtype, sh, st);
}

template <>
int launch_dq<128>(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int dq_dtype, const Shape& sh,
                   cudaStream_t st) {
  return launch_dq_narrow<128>(q, k, v, dout, lse, delta, dq, dq_dtype, sh, st);
}

// K5 at D = 64, 80 and 128: fwd_narrow_kernel.  Its softmax takes the row
// max on the raw scores, so it takes a positive scale only.
template <int D>
int launch_fwd_narrow(const void* q, const void* k, const void* v, void* o, void* lse,
                      const Shape& sh, cudaStream_t st) {
  using L = FwdNarrowLayout<D>;
  if (!(sh.scale > 0.f)) return (int)cudaErrorInvalidValue;
  auto kernel = fwd_narrow_kernel<D>;
  CUtensorMap m[8];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 0 ? L::kQRows : i == 3 ? kTile : kFwdNarrowKeys;
    const int heads = i == 1 || i == 2 ? sh.kv : sh.h, s = i == 1 || i == 2 ? sh.s : sh.sq;
    if (int err = make_maps_narrow<D>(m + 2 * i, ptrs[i], sh.b, s, heads, rows)) return err;
  }
  if (int err = prepare(kernel, L::kBytes)) return err;
  int dev = 0, sms = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) return err;
  const int n_qt = (sh.sq + L::kQRows - 1) / L::kQRows, items = sh.b * sh.h * n_qt;
  const int hg = n_qt <= sms ? min(sh.b * sh.h, sms / n_qt) : sh.b * sh.h;
  kernel<<<min(items, n_qt <= sms ? hg * n_qt : sms), kThreads, L::kBytes, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <>
int launch_fwd<64>(const void* q, const void* k, const void* v, void* o, void* lse,
                   const Shape& sh, cudaStream_t st) {
  return launch_fwd_narrow<64>(q, k, v, o, lse, sh, st);
}

template <>
int launch_fwd<80>(const void* q, const void* k, const void* v, void* o, void* lse,
                   const Shape& sh, cudaStream_t st) {
  return launch_fwd_narrow<80>(q, k, v, o, lse, sh, st);
}

template <>
int launch_fwd<128>(const void* q, const void* k, const void* v, void* o, void* lse,
                    const Shape& sh, cudaStream_t st) {
  return launch_fwd_narrow<128>(q, k, v, o, lse, sh, st);
}

// Returns LAUNCH<D>(args...) for dtype 1 (bfloat16) and D in {64, 80, 128, 256}.
#define SM90_DISPATCH(LAUNCH, ...)                                  \
  do {                                                              \
    if (dtype == 1 && d == 64) return LAUNCH<64>(__VA_ARGS__);      \
    if (dtype == 1 && d == 80) return LAUNCH<80>(__VA_ARGS__);      \
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
  sh.sq = s;
  sh.q0 = 0;
  sh.window = window;
  sh.softcap = softcap;
  sh.scale = scale;
  return sh;
}

}  // namespace

// Each returns a cudaError_t (0 = launched).  window 0 = none, softcap 0 =
// none; dtype 1 (bfloat16) only: float32 runs flash_gqa.cu's kernels.
// The forward's sq queries sit at positions q0 .. q0 + sq - 1 of the s keys.
extern "C" int flash_gqa_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int sq, int q0, int dtype, int b, int s, int h,
                                  int kv, int d, int window, float softcap, float scale,
                                  void* stream) {
  if (sq < 1 || q0 < 0 || q0 + sq > s) return (int)cudaErrorInvalidValue;
  Shape sh = make_shape(b, s, h, kv, window, softcap, scale);
  sh.sq = sq;
  sh.q0 = q0;
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
