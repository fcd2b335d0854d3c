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
// warp specialisation; namespace `hopper` below) and f32 on the FP32 CUDA
// cores (the FMA kernel, `flash_kernel`).
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
// the f32 FMA design below and reached 24 TFLOP/s; what held it back, and
// what replaces each part:
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
// the 128-byte swizzle (D = 64, 128) or of 32 columns with the 64-byte
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
// The f32 instance (flash_kernel) stays on the FP32 CUDA cores: TF32 wgmma
// keeps about three decimal digits and would fail the f32 tolerance of 2e-5
// that the depth-4 f32 check and the f32 tests hold it to.  Its design: the
// TPU grid (BH, Sq / bq, Skv / bk) runs its kv axis in order and carries
// the online-softmax state in VMEM scratch from one step to the next.  Here
// one block of 256 threads owns 64 queries of one head (grid.x over query
// tiles, the longest rows first; grid.y over BH) and a loop inside the
// block takes the place of the kv axis.  The Q tile and the current K and V
// tiles (64 x D each) sit in dynamic shared memory as f32, rows padded to
// D + 1 words so the column reads are free of bank conflicts; at D = 128
// they take 99 KB and the 64 x 64 P tile 16.6 KB, so two blocks share an
// SM.  A thread owns rows ty + 16 i (i < 4) and, of the score tile, columns
// tx + 16 j (j < 4), of the accumulator columns tx + 16 j (j < D / 16): the
// 16 threads of a row are one half-warp, so the row max and row sum are
// shuffles, the running max and sum live in registers, and P goes through
// shared memory read back by the same warp.  What bounds it is the FP32 FMA
// rate and the shared-memory reads that feed it (8 per 16 FMAs of the score
// tile, 12 per 32 of P V).
#include <cuda.h>  // CUtensorMap and its enums; the library calls no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBq = 64;  // queries a block
constexpr int kBk = 64;  // keys a tile
constexpr int kThreads = 256;
constexpr int kLdp = kBk + 1;  // padded row of the P tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(3) * kBq * (D + 1) + size_t(kBq) * kLdp);
}

// dst[r][c] = src[r, c] as f32 for the first `rows` rows of a 64 x D tile,
// zero below them.  Consecutive threads read consecutive elements.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int rows) {
  for (int e = threadIdx.x; e < kBq * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < rows ? to_f32(src[(long long)r * D + c]) : 0.f;
  }
}

// The max (or sum) over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int group, float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBq * kLd;
  float* vs = ks + kBk * kLd;
  float* ps = vs + kBk * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * kBq;
  const int rows = min(kBq, sq - q0);
  const int off = skv - sq;
  const T* qb = q + ((long long)bh * sq + q0) * D;
  const T* kb = k + (long long)(bh / group) * skv * D;
  const T* vb = v + (long long)(bh / group) * skv * D;

  int k_lo = 0, k_hi = skv - 1;
  if (window > 0) k_lo = max(0, q0 + off - window + 1);
  if (causal) k_hi = min(k_hi, q0 + rows - 1 + off);
  const int t_lo = k_lo / kBk, t_hi = k_hi / kBk;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D>(qs, qb, rows);

  float acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int kbase = t * kBk;
    const int keys = min(kBk, skv - kbase);
    __syncthreads();  // the last tile's K, V and P reads are done
    load_tile<T, D>(ks, kb + (long long)kbase * D, keys);
    load_tile<T, D>(vs, vb + (long long)kbase * D, keys);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + off;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kbase + tx + 16 * j;
        bool keep = kpos < skv;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = corr * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a warp reads back only the P rows it wrote

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float w = vs[c * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row < rows) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + ((long long)bh * sq + q0 + row) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int bh, int sq,
                   int skv, int group, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBq - 1) / kBq, bh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, sq, skv, group, scale,
                                           causal, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int skv, int d, int group, float scale, int causal,
             int window, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<T, 32>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 64:
      return launch<T, 64>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 96:
      return launch<T, 96>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 128:
      return launch<T, 128>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                            window, st);
    default:
      return cudaErrorInvalidValue;
  }
}


}  // namespace

namespace hopper {

constexpr int kBm = 128;  // queries a block: two consumer warpgroups of 64
constexpr int kBn = 128;  // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1ll << 34;  // about 10 s at 1.7 GHz

// Shared-memory geometry of a 128-row tile of Q, K or V at head dim D:
// D / kChunk chunk regions of 128 rows x kChunkBytes, each in the swizzle
// TMA writes.
template <int D>
struct Tile {
  static_assert(D % 32 == 0 && D <= 128, "head dim must be 32, 64, 96 or 128");
  static constexpr int kChunk = D % 64 == 0 ? 64 : 32;  // bf16 columns a row
  static constexpr int kChunkBytes = 2 * kChunk;         // 128 or 64
  static constexpr int kChunks = D / kChunk;
  static constexpr int kKPerChunk = kChunk / 16;  // k16 steps in a chunk
  static constexpr uint32_t kLayout = kChunkBytes == 128 ? 1 : 2;  // B128/B64
  static constexpr int kRegion = kBn * kChunkBytes;
  static constexpr int kBytes = kBn * D * 2;
  static constexpr int kBarOffset = kBytes * (1 + 2 * kStages);
  // + 1024 to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 3 * kStages);
};
static_assert(kBm == kBn, "a Q tile has the geometry of a K tile");

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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_n32(o, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(o, a, db);
  } else {
    wgmma_rs_n128(o, a, db);
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
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kBytes;            // stage s at + s * kBytes
  const uint32_t v_s = k_s + kStages * T::kBytes;  // likewise
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
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * T::kRegion, &qmap, q_full, c * T::kChunk, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        const int kbase = (t_lo + i) * kBn;
        mbar_wait(empty + 8 * s, phase ^ 1);
        const uint32_t ks = k_s + s * T::kBytes, vs = v_s + s * T::kBytes;
        mbar_expect_tx(full_k + 8 * s, T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(ks + c * T::kRegion, &kmap, full_k + 8 * s, c * T::kChunk,
                   kbase, kv);
        }
        mbar_expect_tx(full_v + 8 * s, T::kBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(vs + c * T::kRegion, &vmap, full_v + 8 * s, c * T::kChunk,
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
      // S = Q K^T: D / 16 steps of m64n128k16, both operands K-major
      float sc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) sc[e] = 0.f;
      const uint32_t ks = k_s + s * T::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / T::kKPerChunk, w = kk % T::kKPerChunk;
        const uint32_t qa = q_s + c * T::kRegion + 64 * g * T::kChunkBytes;
        const uint64_t da = smem_desc(qa + 32 * w, 16, k_sbo, T::kLayout);
        const uint64_t db =
            smem_desc(ks + c * T::kRegion + 32 * w, 16, k_sbo, T::kLayout);
        wgmma_ss_n128(sc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // scores in log2 units; the mask only where a key may be masked
#pragma unroll
      for (int e = 0; e < 64; ++e) sc[e] *= scale_log2;
      const bool masked = kbase + kBn > skv ||
                          (causal && kbase + kBn - 1 > q_first) ||
                          (window > 0 && kbase <= q_last - window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
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
      for (int j = 0; j < 16; ++j) {
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
      for (int j = 0; j < 16; ++j) {
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
      // P in bf16 as the A fragments of the 8 k16 steps of P V
      uint32_t p[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: 8 steps of m64nDk16, V MN-major (transposed B)
      mbar_wait(full_v + 8 * s, phase);
      const uint32_t vs = v_s + s * T::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db =
            smem_desc(vs + 16 * kk * T::kChunkBytes, T::kRegion, k_sbo,
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
      const uint32_t addr = q_s + c * T::kRegion + r * T::kChunkBytes +
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
      tma_store(&omap, q_s + c * T::kRegion + 64 * g * T::kChunkBytes,
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
  if (!make_map<D>(&qm, q, sq, bh, kBm) || !make_map<D>(&km, k, skv, bkv, kBn) ||
      !make_map<D>(&vm, v, skv, bkv, kBn) ||
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int bh, int sq, int skv, int d,
                                   int group, float scale, int causal,
                                   int window, void* stream) {
  return dispatch<float>(q, k, v, out, bh, sq, skv, d, group, scale, causal,
                         window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int sq,
                                    int skv, int d, int group, float scale,
                                    int causal, int window, void* stream) {
  return hopper::dispatch(q, k, v, out, bh, sq, skv, d, group, scale, causal,
                          window, stream);
}
