// Flash attention: causal GQA attention with an online softmax,
//
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b / group, j] * scale) v[b / group, j]
//
// over the unmasked keys j, with q of shape (BH, Sq, D), k and v of shape
// (BKV, Skv, D), BH = BKV * group, and out a new (BH, Sq, D) tensor in q's
// dtype.  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel).  On the LM path (models/attention.py, impl="kernel") it is
// the attention of every layer of a forward without caches: the prefill and
// scoring forward.  Two instances: bf16 on Hopper's tensor cores (wgmma, TMA,
// warp specialisation; namespace `hopper` below) and f32 on the TF32 tensor
// cores with the 3xTF32 split (the same machinery; namespace `tf32x3`).
//
// Semantics, as _flash_kernel: queries are right-aligned to the keys, so
// query i sits at qpos = i + (Skv - Sq) and key j at kpos = j; a key is
// kept if kpos <= qpos (causal) and kpos > qpos - window (window > 0).
// Masked scores take the reference's constant -1e30, not -inf; the running
// max starts at -1e30, the running sum and the accumulator at 0, and the
// output is acc / max(l, 1e-30).  Query head b reads KV head b / group.
//
// Which key tiles a block visits: only those from the first key the window
// reaches for the block's first query to the last key causality allows for
// its last one.  The reference walks every tile; the result is the same:
//  - a tile fully masked for a row that comes after one of the row's
//    unmasked keys adds exp(-1e30 - m) = 0 to its sum and accumulator;
//  - one that comes before all of them (p = exp(-1e30 - (-1e30)) = 1 for
//    each entry) is wiped out by the correction exp(-1e30 - m_real) = 0 at
//    the row's first unmasked key.
// Every row has an unmasked key (its own position), so both cases hold for
// the tiles skipped and for the masked entries of the tiles visited.  Keys
// past Skv in the last tile are masked the same way; queries past Sq in the
// last query tile are computed on zeros and not written.  Any Sq <= Skv
// works (the TPU kernel needs both divisible by its blocks); offsets are
// 64-bit.
//
// Bound on the card: 4 D flops for each unmasked (query, key) pair.  At the
// path's shape (qwen3-4b prefill: B = 2, S = 4096, 32 query and 8 KV heads,
// D = 128, causal, bf16) that is 4 D S (S + 1) / 2 BH = 2.75e11 flops a
// layer, 0.278 ms at the bf16 tensor-core peak of 989 TFLOP/s, against
// 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s: operations bound it.
//
// The bf16 instance (namespace hopper).  The first kernel ran bf16 through
// an f32 FMA design (the f32 instance's first design, since replaced) and
// reached 24 TFLOP/s; what held it back, and what replaces each part:
//  - FP32 FMAs on the CUDA cores (67 TFLOP/s peak) -> both products on the
//    bf16 tensor cores with wgmma (989 TFLOP/s): S = Q K^T as m64n128k16
//    with Q and K in shared memory, O += P V as m64nDk16 with P in
//    registers;
//  - operands read from shared memory one FMA at a time -> wgmma reads its
//    shared-memory operands itself, through descriptors;
//  - K and V widened to f32 in shared memory, 64 keys a tile, two blocks an
//    SM -> K and V stay bf16, 128 keys a tile, in a ring of 2 stages
//    (Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB at D = 128);
//  - all threads load between two barriers, no overlap -> one producer
//    thread issues TMA loads of the next stage while the consumers compute
//    on this one; each stage has a "full" mbarrier for K, one for V (S can
//    start before V lands) and an "empty" one the consumers arrive on;
//  - the mask evaluated on every tile -> only tiles that hold keys past Skv
//    or cross a consumer's diagonal or window edge take mask arithmetic, and
//    a consumer skips the product of a tile none of its rows can see.
// A block (384 threads) owns 128 queries of one head: warpgroup 0 is the
// producer (setmaxnreg down to 24 registers; one thread issues every TMA),
// warpgroups 1 and 2 are consumers of 64 query rows each, wgmma's M
// (setmaxnreg up to 240).  Query tiles are scheduled longest causal rows
// first.  Tensor maps are 3-D over (heads, rows, D), so TMA fills rows past
// Sq or Skv with zeros within a head and never reads the next head's; they
// are encoded on the host through cudaGetDriverEntryPoint, so the library
// does not link libcuda.  Tiles are stored in D-chunks of 64 columns with
// the 128-byte swizzle (D = 64, 128, 256) or of 32 columns with the 64-byte
// swizzle (D = 32, 96), one chunk region after the other; K is the K-major B
// operand of Q K^T as it lies, V the MN-major B operand of P V through
// wgmma's transpose bit, so nothing is transposed.  The softmax runs in the
// accumulator's fragment layout: a row lives in the 4 lanes of a quad, so
// its max is two shuffles; scores are scaled by scale * log2(e) and
// exponentiated with ex2; the running max starts at -1e30 (in these log2
// units, which changes nothing: the constant only has to be finite, huge
// and shared by the mask and the start).  The sum l is kept per thread and
// reduced over the quad once, at the end.  The f32 scores become the bf16
// A fragment of P V in registers, with no trip through shared memory.  The
// epilogue scales by 1 / max(l, 1e-30), writes bf16 into the consumer's own
// rows of the Q tile (swizzled) and stores them with TMA, which drops rows
// past Sq.  A wait on an mbarrier that never completes traps after about
// ten seconds rather than hanging the card.
//
// The two consumers run S, softmax and P V in turn and interleave on the
// tensor cores by themselves; an explicit ping-pong between them, and
// issuing tile i - 1's P V with tile i's S, measured slower on the H100.
//
// Head dim 256 (RecurrentGemma's local attention) is the same kernel on
// 64-key tiles (Tile<256>): a 128-query Q tile is 64 KB there, and two
// stages of 128-key K and V tiles would bring the block to 320 KB of the
// 227 KB it may use; with 64 keys it takes 192 KB.  S is D / 16 = 16 steps
// of m64n64k16, P V four of m64n256k16 (V's four chunk regions, LBO
// apart); a consumer thread holds 128 floats of O, 32 of S and 16 registers
// of P.  Up to D = 128 the tiles and the code are those of the note above.
// Bound at its path's shape (recurrentgemma-9b prefill: B = 2, S = 4096, 16
// query heads and one KV head, window 2048): 4 D flops for each of the
// 6.29e6 unmasked pairs of each of 32 heads, 2.06e11 flops, 0.208 ms at
// 989 TFLOP/s, against 143 MB of q, k, v and out, 0.043 ms: operations.
//
// P in bf16 is the one rounding this design adds: S is exact products of
// bf16 values summed in f32, as the reference, but P V multiplies P rounded
// to bf16 (l sums the unrounded f32 p).  A plain emulation of this
// arithmetic (tests/test_torch_attention.py) stays within the bf16
// tolerance of the Pallas kernel.  On the card, at the path's shape, the
// output is 7.97e-3 from the f32 result before its rounding to bf16, where
// that rounding alone costs 7.79e-3 (chip_smoke.py, NVIDIA H100 80GB HBM3
// at 700 W): one bf16 ulp of outputs between 2 and 4.  Splitting P into
// bf16 hi and lo parts would cut the added error at 1.5x the flops; it is
// not needed, and this kernel uses the single bf16 P.
//
// The f32 instance (namespace tf32x3) runs both products on the TF32 tensor
// cores with the error-compensated split that CUTLASS calls 3xTF32: an f32
// operand x is hi + lo, hi its tf32 part and lo = x - hi (exact in f32), and
// a b is formed as hi hi + hi lo + lo hi in f32, lo lo dropped.  One TF32
// pass keeps about three decimal digits and would fail the f32 tolerance of
// 2e-5 that the depth-4 f32 check and the f32 tests hold the kernel to; the
// split loses about 2^-20 of each product.
//  - The tensor cores read only the sign, exponent and top 10 mantissa bits
//    of an f32 operand: the low 13 are ignored, not rounded.  The probe of
//    scripts/flash_f32_variants.py (a 64 x 128 by 128 x 64 product, three
//    seeds, NVIDIA H100 80GB HBM3 at 700 W) found a raw tf32 pass equal bit
//    for bit to one on operands with those bits cleared, and unequal to one
//    on operands rounded by cvt.rna.tf32.f32.  So a raw f32 tile is its own
//    hi part, lo = x - (x with its low 13 bits cleared) is the only tile the
//    split has to write, and lo's own low bits are dropped the same way.  On
//    the probe's product this split is at most 5.18e-7 of sum |a_k b_k| from
//    the f64 product, 2.8x the FP32 FMA loop's 1.86e-7 (hi by cvt.rna: 1.7x;
//    one raw pass: 2783x), and its RS form (A's lo from registers) equals
//    its SS form bit for bit.
//  - tf32 wgmma has no transpose bit: A and B must be K-major.  S = Q K^T
//    takes Q and K as they lie (TMA with f32 tensor maps, 32-column chunks
//    of 128 bytes in the 128-byte swizzle; a k8 step is 32 bytes of a row);
//    O += P V needs V K-major in keys, so V is written transposed into
//    shared memory.  A's lo parts are formed in registers (Q lo once, P lo
//    each tile); B's lo parts (K lo, V^T lo) are written into shared memory.
//  - The producer warpgroup: one thread issues the TMA loads of Q and of raw
//    K and V into a ring; its three other warps run the split pass, K lo in
//    raw K's layout and V^T hi and lo, into a ring of split sets with full
//    and empty mbarriers of their own.  Each consumer warpgroup (64 queries)
//    runs S as Q K_lo^T + Q_lo K^T + Q K^T (SS, RS, SS wgmmas, the small
//    terms first), the softmax as the bf16 instance's, and O += P_lo V +
//    P V_lo + P V (three RS wgmmas).  P's A fragment of a k8 step holds
//    columns t and t + 4 (t = lane % 4) where the accumulator gives the
//    thread keys 2 t and 2 t + 1: a sum over keys may take them in any
//    order, so V^T's rows store each 8-key group as its even keys, then its
//    odd ones, and P's fragments are the accumulator's registers as they lie.
//  - The budget (227 KB a block), at D = 128 in f32: a 128-query Q tile is
//    64 KB, a 32-key tile 16 KB for each of raw K, raw V, K lo, V^T hi and
//    V^T lo.  128 queries, 32-key tiles, 2 raw stages (64 KB) and 2 split
//    sets (96 KB) take 224 KB.  Of the launch's 168 registers a thread, the
//    producer drops to 56 and the consumers rise to 224; at D = 128 ptxas
//    reports 128 bytes of spill stores (the same at 40 and 232).
// Bound: 3 x 4 D flops for each unmasked pair at the TF32 peak of
// 495 TFLOP/s; at the depth-4 check's shape (32/8 heads, 4096 x 4096, D =
// 128, causal) 3 x 1.3747e11 flops, 0.833 ms (2.052 ms for one f32 pass on
// the FP32 cores at 67 TFLOP/s).  The variants script timed it there at
// 2.14-2.19 ms over three calls (39%; the FMA kernel it replaces 5.90-5.94),
// and the other layouts that fit slower: one split set 2.77-2.81 ms, 64-key
// tiles with one raw stage and one split set 2.34-2.36, 64 queries a block
// 2.35.  Its ablations: without the split pass 1.98-2.02 ms; with one tf32
// pass a product 1.24-1.26, so the two lo passes cost about 0.9 ms and the
// rest (the softmax, the barriers, the wait on each 32-key tile's wgmmas)
// holds even one pass at 22% of its own bound.  At the decode and q128
// shapes 64 queries a block are faster (0.28 against 0.40-0.48 ms: twice
// the blocks on the card); those shapes are on no path.
#include <cuda.h>  // CUtensorMap and its enums; the library calls no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int kBm = 128;  // queries a block: two consumer warpgroups of 64
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1ll << 34;  // about 10 s at 1.7 GHz

// Shared-memory geometry at head dim D: a Q tile of kBm rows and K and V
// tiles of kBn rows, each stored as D / kChunk chunk regions of its rows x
// kChunkBytes, in the swizzle TMA writes.  Up to D = 128 a key tile has 128
// rows, the rows of a Q tile.  At D = 256 it has 64: Q (64 KB) and two
// stages of K and V (4 x 32 KB) take 192 KB of the block's 227 KB, where
// 128-key tiles would need 320 KB, and the S fragment (kBn / 2 floats a
// thread) stays small beside the 128 floats of O.
template <int D>
struct Tile {
  static_assert(D % 32 == 0 && (D <= 128 || D == 256),
                "head dim must be 32, 64, 96, 128 or 256");
  static constexpr int kBn = D <= 128 ? 128 : 64;       // keys a tile
  static constexpr int kChunk = D % 64 == 0 ? 64 : 32;  // bf16 columns a row
  static constexpr int kChunkBytes = 2 * kChunk;         // 128 or 64
  static constexpr int kChunks = D / kChunk;
  static constexpr int kKPerChunk = kChunk / 16;  // k16 steps in a chunk
  static constexpr uint32_t kLayout = kChunkBytes == 128 ? 1 : 2;  // B128/B64
  static constexpr int kQRegion = kBm * kChunkBytes;
  static constexpr int kKRegion = kBn * kChunkBytes;
  static constexpr int kQBytes = kBm * D * 2;
  static constexpr int kKBytes = kBn * D * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKBytes;
  // + 1024 to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kStages);
  static_assert(kSmem <= 232448, "the tiles need more shared memory than a block has");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Matrix descriptor of a wgmma operand in shared memory: start address,
// leading and stride byte offsets, swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes in place, so the
// compiler neither reads them early nor reuses them before the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128) (+)= A(64 x 16) B(128 x 16)^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 16) B(64 x 16)^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= Q K^T for a tile of N keys: one of the two above.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else {
    static_assert(N == 64, "key tiles of 64 or 128");
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

// D(64 x 32) += A(64 x 16) B(16 x 32), A in registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64) += A(64 x 16) B(16 x 64), A in registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 96) += A(64 x 16) B(16 x 96), A in registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16) B(16 x 128), A in registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256) += A(64 x 16) B(16 x 256), A in registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(o, a, db);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    static_assert(D == 256, "head dim must be 32, 64, 96, 128 or 256");
    wgmma_rs_n256(o, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap, int sq,
                       int skv, int group, float scale_log2, int causal,
                       int window) {
  using T = Tile<D>;
  constexpr int kBn = T::kBn;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kQBytes;            // stage s at + s * kKBytes
  const uint32_t v_s = k_s + kStages * T::kKBytes;  // likewise
  const uint32_t q_full = base + T::kBarOffset;
  const uint32_t full_k = q_full + 8;               // + 8 s
  const uint32_t full_v = full_k + 8 * kStages;     // + 8 s
  const uint32_t empty = full_v + 8 * kStages;      // + 8 s

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kBm;
  const int rows = min(kBm, sq - q0);
  const int off = skv - sq;
  int k_lo = 0, k_hi = skv - 1;
  if (window > 0) k_lo = max(0, q0 + off - window + 1);
  if (causal) k_hi = min(k_hi, q0 + rows - 1 + off);
  const int t_lo = k_lo / kBn;
  const int n_tiles = k_hi / kBn - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // The producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kv = bh / group;
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * T::kQRegion, &qmap, q_full, c * T::kChunk, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int kbase = (t_lo + i) * kBn;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t ks = k_s + s * T::kKBytes, vs = v_s + s * T::kKBytes;
        mbar_expect_tx(full_k + 8 * s, T::kKBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(ks + c * T::kKRegion, &kmap, full_k + 8 * s, c * T::kChunk,
                   kbase, kv);
        }
        mbar_expect_tx(full_v + 8 * s, T::kKBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(vs + c * T::kKRegion, &vmap, full_v + 8 * s, c * T::kChunk,
                   kbase, kv);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, r_a and r_a + 8 of them this
  // thread's, in the accumulator layout of wgmma (warp w holds rows
  // 16 w .. 16 w + 15; lane l rows l / 4 and l / 4 + 8, columns
  // 8 j + 2 (l % 4) + {0, 1} of each 8-column group j).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid & 31;
  const int r_a = 64 * g + 16 * (tid >> 5) + (lane >> 2);  // row in the tile
  const int qpos_a = q0 + r_a + off, qpos_b = qpos_a + 8;
  const int g_rows = min(64, sq - q0 - 64 * g);  // <= 0: no row to write
  const int q_first = q0 + 64 * g + off, q_last = q_first + g_rows - 1;
  const uint32_t k_sbo = 8 * T::kChunkBytes;  // 8-row groups of a chunk

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int kbase = (t_lo + i) * kBn;
    mbar_wait(full_k + 8 * s, phase);
    const bool visible = g_rows > 0 && !(causal && kbase > q_last) &&
                         !(window > 0 && kbase + kBn - 1 <= q_first - window);
    if (visible) {
      // S = Q K^T: D / 16 steps of m64n{kBn}k16, both operands K-major
      float sc[kBn / 2];
#pragma unroll
      for (int e = 0; e < kBn / 2; ++e) sc[e] = 0.f;
      const uint32_t ks = k_s + s * T::kKBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / T::kKPerChunk, w = kk % T::kKPerChunk;
        const uint32_t qa = q_s + c * T::kQRegion + 64 * g * T::kChunkBytes;
        const uint64_t da = smem_desc(qa + 32 * w, 16, k_sbo, T::kLayout);
        const uint64_t db =
            smem_desc(ks + c * T::kKRegion + 32 * w, 16, k_sbo, T::kLayout);
        wgmma_qk<kBn>(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // scores in log2 units; the mask only where a key may be masked
#pragma unroll
      for (int e = 0; e < kBn / 2; ++e) sc[e] *= scale_log2;
      const bool masked = kbase + kBn > skv ||
                          (causal && kbase + kBn - 1 > q_first) ||
                          (window > 0 && kbase <= q_last - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = kbase + 8 * j + 2 * (lane & 3) + c;
            bool keep_a = kpos < skv, keep_b = kpos < skv;
            if (causal) {
              keep_a = keep_a && kpos <= qpos_a;
              keep_b = keep_b && kpos <= qpos_b;
            }
            if (window > 0) {
              keep_a = keep_a && kpos > qpos_a - window;
              keep_b = keep_b && kpos > qpos_b - window;
            }
            if (!keep_a) sc[4 * j + c] = kMasked;
            if (!keep_b) sc[4 * j + 2 + c] = kMasked;
          }
        }
      }

      // online softmax: the row max over the quad, the correction, p
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float corr_a = ex2(m_a - mx_a), corr_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[4 * j + c] = ex2(sc[4 * j + c] - m_a);
          sc[4 * j + 2 + c] = ex2(sc[4 * j + 2 + c] - m_b);
          sum_a += sc[4 * j + c];
          sum_b += sc[4 * j + 2 + c];
        }
      }
      l_a = l_a * corr_a + sum_a;  // this thread's part of the row sum
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr_a;
        o[4 * j + 1] *= corr_a;
        o[4 * j + 2] *= corr_b;
        o[4 * j + 3] *= corr_b;
      }
      // P in bf16 as the A fragments of the kBn / 16 k16 steps of P V
      uint32_t p[kBn / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBn / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: kBn / 16 steps of m64nDk16, V MN-major (transposed B)
      mbar_wait(full_v + 8 * s, phase);
      const uint32_t vs = v_s + s * T::kKBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBn / 16; ++kk) {
        const uint64_t db =
            smem_desc(vs + 16 * kk * T::kChunkBytes, T::kKRegion, k_sbo,
                      T::kLayout);
        wgmma_pv<D>(o, p[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(p);
    } else {
      mbar_wait(full_v + 8 * s, phase);
    }
    mbar_arrive(empty + 8 * s);
  }

  if (g_rows <= 0) return;
  // epilogue: O / max(l, 1e-30) in bf16 into this warpgroup's rows of the Q
  // tile, in its swizzle, then one TMA store a chunk (rows past Sq dropped)
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  named_sync(1 + g, 128);  // every warp's last read of its Q rows is done
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const int c = col / T::kChunk, cc = col % T::kChunk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_a + 8 * h;
      const int swz = T::kLayout == 1 ? (r & 7) : ((r >> 1) & 3);
      const uint32_t addr = q_s + c * T::kQRegion + r * T::kChunkBytes +
                            (((cc >> 3) ^ swz) << 4) + 2 * (cc & 7);
      const float inv = h ? inv_b : inv_a;
      const uint32_t val = pack_bf16(o[4 * j + 2 * h] * inv,
                                     o[4 * j + 2 * h + 1] * inv);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + g, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
      tma_store(&omap, q_s + c * T::kQRegion + 64 * g * T::kChunkBytes,
                c * T::kChunk, q0 + 64 * g, bh);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over a (heads, rows, D) bf16 tensor with boxes of one chunk of
// columns by box_rows rows of one head, in the tile's swizzle; elements
// outside the tensor read as zero and are not written.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
              int box_rows) {
  using T = Tile<D>;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(2 * D),
                                 cuuint64_t(2) * D * cuuint64_t(rows)};
  const cuuint32_t box[3] = {cuuint32_t(T::kChunk), cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kLayout == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, int group, float scale, int causal,
                   int window, cudaStream_t stream) {
  using T = Tile<D>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  const int bkv = bh / group;
  if (!make_map<D>(&qm, q, sq, bh, kBm) ||
      !make_map<D>(&km, k, skv, bkv, T::kBn) ||
      !make_map<D>(&vm, v, skv, bkv, T::kBn) ||
      !make_map<D>(&om, out, sq, bh, kBm / 2)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBm - 1) / kBm, bh);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      qm, km, vm, om, sq, skv, group, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int skv, int d, int group, float scale, int causal,
             int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 64:
      return launch<64>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 96:
      return launch<96>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, out, bh, sq, skv, group, scale, causal,
                         window, st);
    case 256:
      return launch<256>(q, k, v, out, bh, sq, skv, group, scale, causal,
                         window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// The f32 instance: 3xTF32 on the tensor cores (see the note at the top).
namespace tf32x3 {

using hopper::encode_tiled;
using hopper::ex2;
using hopper::kLog2e;
using hopper::kMasked;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_sync;
using hopper::pin;
using hopper::smem_desc;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::tma_store;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait_all;

// The tiling (scripts/flash_f32_variants.py times others, in copies with
// these lines replaced).
constexpr int kWg = 2;           // consumer warpgroups, 64 queries each
constexpr int kBn = 32;          // keys a tile
constexpr int kRawStages = 2;    // raw K and V tiles in the TMA ring
constexpr int kSplitStages = 2;  // K lo, V^T hi and V^T lo sets
constexpr int kProducerRegs = 56;  // setmaxnreg of the producer warpgroup
constexpr int kBm = 64 * kWg;      // queries a block
constexpr int kThreads = 128 * (1 + kWg);  // producer warpgroup + consumers
constexpr int kSplitThreads = 96;          // warps 1-3 of the producer
// the rest of the launch's 168 registers a thread goes to the consumers
constexpr int kConsumerRegs = (168 * 384 - 128 * kProducerRegs) / 256 / 8 * 8;
// A float's sign, exponent and the 10 mantissa bits that tf32 keeps: the
// tensor cores read only these of an f32 operand (the probe of
// scripts/flash_f32_variants.py), so a raw f32 tile is its own hi part.
constexpr uint32_t kTf32Bits = 0xFFFFE000u;
static_assert(kWg == 1 || kWg == 2, "one or two consumer warpgroups");
static_assert(kBn == 32 || kBn == 64, "key tiles of 32 or 64");
static_assert(kWg == 1 || 128 * kProducerRegs + 256 * kConsumerRegs == 168 * 384,
              "the setmaxnreg split hands on exactly the registers of the launch");

// Shared-memory geometry at head dim D.  Every tile is stored in 32-float
// (128-byte) column chunks, one chunk region after the other, rows of 128
// bytes in the 128-byte swizzle: Q (kBm x D), raw K and V (kBn x D, as TMA
// lands them), K lo (the layout of raw K) and V^T hi and lo (D x kBn, keys
// along the row).
template <int D>
struct Geo {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64, 96 or 128");
  static constexpr int kChunks = D / 32;
  static constexpr int kQRegion = kBm * 128;
  static constexpr int kKRegion = kBn * 128;
  static constexpr int kVtRegion = D * 128;  // 32 keys of V^T
  static constexpr int kQBytes = kBm * D * 4;
  static constexpr int kTileBytes = kBn * D * 4;
  static constexpr int kRawBytes = 2 * kTileBytes;    // K, then V
  static constexpr int kSplitBytes = 3 * kTileBytes;  // K lo, V^T hi, V^T lo
  static constexpr int kBarOffset =
      kQBytes + kRawStages * kRawBytes + kSplitStages * kSplitBytes;
  // + 1024 to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem =
      1024 + kBarOffset + 8 * (1 + 2 * kRawStages + 2 * kSplitStages);
  static_assert(kSmem <= 232448, "the tiling needs more shared memory than a block has");
};

// Byte offset of element (r, c) in a tile of 32-column chunk regions of
// `region` bytes.
__device__ __forceinline__ uint32_t swz(int r, int c, int region) {
  return (c >> 5) * region + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         4 * (c & 3);
}

// x minus its tf32 part: exact in f32, and the tensor cores read its own
// tf32 part in turn.
__device__ __forceinline__ float lo_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & kTf32Bits);
}
__device__ __forceinline__ float4 lo_part(float4 x) {
  return make_float4(lo_part(x.x), lo_part(x.y), lo_part(x.z), lo_part(x.w));
}

// The A fragment of wgmma's k8 tf32 step kk, columns 8 kk .. 8 kk + 7, for
// the thread whose rows are r and r + 8 and whose lane is t4 within its quad:
// a0 (r, 8 kk + t4), a1 (r + 8, 8 kk + t4), a2 (r, 8 kk + t4 + 4),
// a3 (r + 8, 8 kk + t4 + 4).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* tile,
                                       int region, int r, int kk, int t4) {
  const int c = 8 * kk + t4;
  a[0] = *reinterpret_cast<const uint32_t*>(tile + swz(r, c, region));
  a[1] = *reinterpret_cast<const uint32_t*>(tile + swz(r + 8, c, region));
  a[2] = *reinterpret_cast<const uint32_t*>(tile + swz(r, c + 4, region));
  a[3] = *reinterpret_cast<const uint32_t*>(tile + swz(r + 8, c + 4, region));
}

// The descriptor of a K-major operand in the 128-byte swizzle: 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, 1);
}

// D(64 x 32) += A(64 x 8) B(32 x 8)^T in tf32, A and B K-major in shared
// memory.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64) += A(64 x 8) B(64 x 8)^T in tf32, A and B K-major in shared
// memory.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 32) += A(64 x 8) B(32 x 8)^T in tf32, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64) += A(64 x 8) B(64 x 8)^T in tf32, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 96) += A(64 x 8) B(96 x 8)^T in tf32, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void mma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 8) B(128 x 8)^T in tf32, A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) {
    mma_ss_n32(d, da, db);
  } else {
    mma_ss_n64(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (N == 32) {
    mma_rs_n32(d, a, db);
  } else if constexpr (N == 64) {
    mma_rs_n64(d, a, db);
  } else if constexpr (N == 96) {
    mma_rs_n96(d, a, db);
  } else {
    mma_rs_n128(d, a, db);
  }
}

__device__ __forceinline__ float elem(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// The split pass of one key tile, by the 96 threads st = 0..95: K lo in raw
// K's layout, element by element; V^T hi (the raw values) and V^T lo.  A
// step takes the 4 keys 8 kk + par + {0, 2, 4, 6} at columns 4 dq .. 4 dq + 3
// and writes them as one 16-byte unit of each of 4 V^T rows: unit par of the
// 8-key group kk.  So a V^T row holds, within each group of 8 keys, the even
// keys and then the odd ones, the order in which P's A fragments hold them
// (the source note says why).  Consecutive threads take consecutive dq; they
// write their 4 rows in a rotated order, so the 8 threads of a 128-bit
// store's phase write 8 distinct units: no bank conflicts.
template <int D>
__device__ __forceinline__ void split_tile(const uint8_t* kr, const uint8_t* vr,
                                           uint8_t* kl, uint8_t* vth, uint8_t* vtl,
                                           int st) {
  using G = Geo<D>;
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  float4* kl4 = reinterpret_cast<float4*>(kl);
  for (int e = st; e < G::kTileBytes / 16; e += kSplitThreads) {
    kl4[e] = lo_part(k4[e]);
  }
  for (int t = st; t < (kBn / 4) * (D / 4); t += kSplitThreads) {
    const int dq = t % (D / 4), kp = t / (D / 4);
    const int kk = kp >> 1, par = kp & 1;
    float4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 8 * kk + par + 2 * j;
      x[j] = *reinterpret_cast<const float4*>(
          vr + (dq >> 3) * G::kKRegion + key * 128 + (((dq & 7) ^ (key & 7)) << 4));
    }
    const int unit = 2 * (kk & 3) + par;
#pragma unroll
    for (int u0 = 0; u0 < 4; ++u0) {
      const int u = (u0 + (dq >> 1)) & 3;
      const float4 y = make_float4(elem(x[0], u), elem(x[1], u), elem(x[2], u),
                                   elem(x[3], u));
      const int d = 4 * dq + u;
      const int off = (kk >> 2) * G::kVtRegion + d * 128 + ((unit ^ (d & 7)) << 4);
      *reinterpret_cast<float4*>(vth + off) = y;
      *reinterpret_cast<float4*>(vtl + off) = lo_part(y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, int sq,
                        int skv, int group, float scale_log2, int causal,
                        int window) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw_base);  // generic view of base
  const uint32_t q_s = base;
  const uint32_t raw_s = q_s + G::kQBytes;  // stage s at + s * kRawBytes
  const uint32_t split_s = raw_s + kRawStages * G::kRawBytes;  // + s * kSplitBytes
  const uint32_t q_full = base + G::kBarOffset;
  const uint32_t raw_full = q_full + 8;                       // + 8 s
  const uint32_t raw_empty = raw_full + 8 * kRawStages;       // + 8 s
  const uint32_t split_full = raw_empty + 8 * kRawStages;     // + 8 s
  const uint32_t split_empty = split_full + 8 * kSplitStages;  // + 8 s

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int bh = blockIdx.y;
  const int q0 = qt * kBm;
  const int rows = min(kBm, sq - q0);
  const int off = skv - sq;
  int k_lo = 0, k_hi = skv - 1;
  if (window > 0) k_lo = max(0, q0 + off - window + 1);
  if (causal) k_hi = min(k_hi, q0 + rows - 1 + off);
  const int t_lo = k_lo / kBn;
  const int n_tiles = k_hi / kBn - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_empty + 8 * s, 128 * kWg + kSplitThreads);
    }
    for (int s = 0; s < kSplitStages; ++s) {
      mbar_init(split_full + 8 * s, kSplitThreads);
      mbar_init(split_empty + 8 * s, 128 * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (kWg == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    if (threadIdx.x == 0) {
      // TMA: Q once, then raw K and V into the ring
      const int kv = bh / group;
      mbar_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) {
        tma_load(q_s + c * G::kQRegion, &qmap, q_full, 32 * c, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kRawStages;
        const int kbase = (t_lo + i) * kBn;
        mbar_wait(raw_empty + 8 * s, ((i / kRawStages) & 1) ^ 1);
        const uint32_t ks = raw_s + s * G::kRawBytes, vs = ks + G::kTileBytes;
        mbar_expect_tx(raw_full + 8 * s, G::kRawBytes);
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(ks + c * G::kKRegion, &kmap, raw_full + 8 * s, 32 * c, kbase, kv);
        }
#pragma unroll
        for (int c = 0; c < G::kChunks; ++c) {
          tma_load(vs + c * G::kKRegion, &vmap, raw_full + 8 * s, 32 * c, kbase, kv);
        }
      }
    } else if (threadIdx.x >= 32) {
      // the split pass: a raw stage into a split stage
      const int st = threadIdx.x - 32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kRawStages, s2 = i % kSplitStages;
        mbar_wait(raw_full + 8 * s, (i / kRawStages) & 1);
        mbar_wait(split_empty + 8 * s2, ((i / kSplitStages) & 1) ^ 1);
        const uint8_t* kr = gbase + (raw_s - base) + s * G::kRawBytes;
        uint8_t* kl = gbase + (split_s - base) + s2 * G::kSplitBytes;
        split_tile<D>(kr, kr + G::kTileBytes, kl, kl + G::kTileBytes,
                      kl + 2 * G::kTileBytes, st);
        // generic writes that wgmma (the async proxy) reads next
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(split_full + 8 * s2);
        mbar_arrive(raw_empty + 8 * s);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, r_a and r_a + 8 of them this
  // thread's, in the accumulator layout of wgmma (warp w holds rows
  // 16 w .. 16 w + 15; lane l rows l / 4 and l / 4 + 8, columns
  // 8 j + 2 (l % 4) + {0, 1} of each 8-column group j).
  if constexpr (kWg == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid & 31, t4 = lane & 3;
  const int r_a = 64 * g + 16 * (tid >> 5) + (lane >> 2);  // row in the tile
  const int qpos_a = q0 + r_a + off, qpos_b = qpos_a + 8;
  const int g_rows = min(64, sq - q0 - 64 * g);  // <= 0: no row to write
  const int q_first = q0 + 64 * g + off, q_last = q_first + g_rows - 1;
  const uint32_t qa = q_s + 64 * g * 128;  // this warpgroup's rows of Q

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);
  // Q lo as the A fragments of the Q lo K^T pass, in registers
  uint32_t qlo[D / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    load_a(qlo[kk], gbase, G::kQRegion, r_a, kk, t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qlo[kk][e] = __float_as_uint(lo_part(__uint_as_float(qlo[kk][e])));
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kRawStages, s2 = i % kSplitStages;
    const int kbase = (t_lo + i) * kBn;
    const uint32_t ks = raw_s + s * G::kRawBytes;
    const uint32_t kl = split_s + s2 * G::kSplitBytes;
    const uint32_t vth = kl + G::kTileBytes, vtl = vth + G::kTileBytes;
    mbar_wait(raw_full + 8 * s, (i / kRawStages) & 1);
    mbar_wait(split_full + 8 * s2, (i / kSplitStages) & 1);
    const bool visible = g_rows > 0 && !(causal && kbase > q_last) &&
                         !(window > 0 && kbase + kBn - 1 <= q_first - window);
    float sc[kBn / 2];
    if (visible) {
      // S = Q K^T as Q K_lo^T + Q_lo K^T + Q K^T, the small terms first; raw
      // Q and K are their own hi parts
#pragma unroll
      for (int e = 0; e < kBn / 2; ++e) sc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = kk >> 2, w = kk & 3;
        mma_ss<kBn>(sc, desc(qa + c * G::kQRegion + 32 * w),
                    desc(kl + c * G::kKRegion + 32 * w));
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = kk >> 2, w = kk & 3;
        mma_rs<kBn>(sc, qlo[kk], desc(ks + c * G::kKRegion + 32 * w));
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = kk >> 2, w = kk & 3;
        mma_ss<kBn>(sc, desc(qa + c * G::kQRegion + 32 * w),
                    desc(ks + c * G::kKRegion + 32 * w));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
    }
    mbar_arrive(raw_empty + 8 * s);  // raw K is read; V^T is in the split set
    if (visible) {
      // scores in log2 units; the mask only where a key may be masked
#pragma unroll
      for (int e = 0; e < kBn / 2; ++e) sc[e] *= scale_log2;
      const bool masked = kbase + kBn > skv ||
                          (causal && kbase + kBn - 1 > q_first) ||
                          (window > 0 && kbase <= q_last - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = kbase + 8 * j + 2 * t4 + c;
            bool keep_a = kpos < skv, keep_b = kpos < skv;
            if (causal) {
              keep_a = keep_a && kpos <= qpos_a;
              keep_b = keep_b && kpos <= qpos_b;
            }
            if (window > 0) {
              keep_a = keep_a && kpos > qpos_a - window;
              keep_b = keep_b && kpos > qpos_b - window;
            }
            if (!keep_a) sc[4 * j + c] = kMasked;
            if (!keep_b) sc[4 * j + 2 + c] = kMasked;
          }
        }
      }

      // online softmax: the row max over the quad, the correction, p
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float corr_a = ex2(m_a - mx_a), corr_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sc[4 * j + c] = ex2(sc[4 * j + c] - m_a);
          sc[4 * j + 2 + c] = ex2(sc[4 * j + 2 + c] - m_b);
          sum_a += sc[4 * j + c];
          sum_b += sc[4 * j + 2 + c];
        }
      }
      l_a = l_a * corr_a + sum_a;  // this thread's part of the row sum
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr_a;
        o[4 * j + 1] *= corr_a;
        o[4 * j + 2] *= corr_b;
        o[4 * j + 3] *= corr_b;
      }
      // P as the A fragments of the k8 steps of P V: the thread holds keys
      // 8 kk + 2 t4 + {0, 1}, which the fragment's columns t4 and t4 + 4
      // stand for (V^T's rows hold the keys in that order); P's hi part is
      // p itself, its lo part p minus that
      uint32_t phi[kBn / 8][4], plo[kBn / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBn / 8; ++kk) {
        phi[kk][0] = __float_as_uint(sc[4 * kk]);
        phi[kk][1] = __float_as_uint(sc[4 * kk + 2]);
        phi[kk][2] = __float_as_uint(sc[4 * kk + 1]);
        phi[kk][3] = __float_as_uint(sc[4 * kk + 3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          plo[kk][e] = __float_as_uint(lo_part(__uint_as_float(phi[kk][e])));
        }
      }

      // O += P V as P_lo V + P V_lo + P V, V^T hi and lo K-major in keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBn / 8; ++kk) {
        mma_rs<D>(o, plo[kk], desc(vth + (kk >> 2) * G::kVtRegion + 32 * (kk & 3)));
      }
#pragma unroll
      for (int kk = 0; kk < kBn / 8; ++kk) {
        mma_rs<D>(o, phi[kk], desc(vtl + (kk >> 2) * G::kVtRegion + 32 * (kk & 3)));
      }
#pragma unroll
      for (int kk = 0; kk < kBn / 8; ++kk) {
        mma_rs<D>(o, phi[kk], desc(vth + (kk >> 2) * G::kVtRegion + 32 * (kk & 3)));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(phi);
      pin(plo);
    }
    mbar_arrive(split_empty + 8 * s2);
  }

  if (g_rows <= 0) return;
  // epilogue: O / max(l, 1e-30) into this warpgroup's rows of the Q tile, in
  // its swizzle, then one TMA store a chunk (rows past Sq dropped)
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  named_sync(1 + g, 128);  // every warp's last read of its Q rows is done
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = h ? inv_b : inv_a;
      *reinterpret_cast<float2*>(gbase + swz(r_a + 8 * h, col, G::kQRegion)) =
          make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + g, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c) {
      tma_store(&omap, qa + c * G::kQRegion, 32 * c, q0 + 64 * g, bh);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A map over a (heads, rows, D) f32 tensor with boxes of 32 columns by
// box_rows rows of one head, in the 128-byte swizzle; elements outside the
// tensor read as zero and are not written.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
              int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(4 * D),
                                 cuuint64_t(4) * D * cuuint64_t(rows)};
  const cuuint32_t box[3] = {32, cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, int group, float scale, int causal,
                   int window, cudaStream_t stream) {
  using G = Geo<D>;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  const int bkv = bh / group;
  if (!make_map<D>(&qm, q, sq, bh, kBm) || !make_map<D>(&km, k, skv, bkv, kBn) ||
      !make_map<D>(&vm, v, skv, bkv, kBn) || !make_map<D>(&om, out, sq, bh, 64)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_tf32x3_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBm - 1) / kBm, bh);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(
      qm, km, vm, om, sq, skv, group, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int skv, int d, int group, float scale, int causal,
             int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 64:
      return launch<64>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 96:
      return launch<96>(q, k, v, out, bh, sq, skv, group, scale, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, out, bh, sq, skv, group, scale, causal,
                         window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tf32x3

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int bh, int sq, int skv, int d,
                                   int group, float scale, int causal,
                                   int window, void* stream) {
  return tf32x3::dispatch(q, k, v, out, bh, sq, skv, d, group, scale, causal,
                          window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int sq,
                                    int skv, int d, int group, float scale,
                                    int causal, int window, void* stream) {
  return hopper::dispatch(q, k, v, out, bh, sq, skv, d, group, scale, causal,
                          window, stream);
}
