// TLR matrix-matrix multiply (TLR-MM, the paper's dominant kernel, §5.3):
//
//   out[b] = acc[b] - U_a[b] (V_a[b]^T V_b[b]) U_b[b]^T
//
// batched over b, with U, V of shape (B, nb, k) and acc, out (B, nb, nb);
// out may be acc itself (the update in place).  Replaces the Pallas TPU
// kernel src/repro/kernels/tlr_mm.py::tlr_mm (body _tlr_mm_kernel).  On the
// TLR Cholesky path it is the SYRK onto the trailing diagonal tiles, with
// a = b, written in place into the diagonal tiles.
//
// Bound on the card: (4 nb k + 2 nb^2) x 8 x B bytes (each input read once,
// out written once) and 2 B (2 nb k^2 + nb^2 k) operations.  At the path's
// shape (B, nb, k) = (63, 512, 128) in f64 that is 396 MB, 0.1183 ms at
// 3.35 TB/s, against 6.3 GFLOP, 0.095 ms at the 67 TFLOP/s of the FP64
// tensor cores: both matter, the bytes a little more.
//
// Two instances, picked by the dtypes:
//
// dmma_f64 (f64): all three products on the FP64 tensor cores (mma.sync
// m16n8k8, dmma.cuh), in two programmatic dependent launches:
//   stage 1  W[b] = V_a[b]^T V_b[b] (k x k): one 128-thread block per (b,
//            64 x 64 tile of W), four warps of 32 x 32, V streamed over nb
//            in 32-row chunks through a cp.async double buffer.  W goes to
//            scratch the caller allocates.
//   stage 2  one 256-thread block per (b, 64-row strip): T = U_a[strip]
//            W[:, p0:p0+128] is formed once (its operands, the strip's U_a
//            and W, loaded together; only W waits for stage 1), and each of
//            the eight warps keeps the A fragments of its 16 rows of T in
//            registers.  Then 64-column chunks of U_b and of acc stream
//            through cp.async double buffers (acc's in the space T took)
//            while out[strip, c0:c0+64] = acc - T U_b[c0:c0+64]^T is
//            written, each thread storing its neighbouring pairs as one
//            16-byte store.  acc is read once and out written once; an
//            element of acc is read (into shared memory) before any thread
//            writes that element of out, so out = acc is safe.  A rank k
//            above 128 takes passes of 128 rank columns, the later ones
//            reading out back.  When B is too small to fill the card, each
//            strip's chunks are split over several blocks, each forming T.
// Shared memory keeps rows of 4 mod 16 doubles, so the fragment loads meet
// no bank conflicts; at 198 KB and 255 registers a thread, one stage-2
// block runs per SM (a variant with two blocks an SM, 32-column chunks and
// at most 128 registers, spilled and ran slower).  At the path's shape
// stage 2 has 504 blocks.  Loads beyond nb or k read zero, so zero-padded
// rank columns add exact zeros.
//
// fma_f32 (f32 factors): on the FP32 CUDA cores in full f32, not TF32 (the
// reference forms the product in f32).  acc and out are f32, or f64 for
// the SYRK of a mixed precision policy: the epilogue then widens the f32
// product y exactly and subtracts in f64, out = acc - (double) y, bit for
// bit the f32 form into a zero batch, cast and added.  At the mixed SYRK's
// first step (15, 512, 128) the operations bound it: 1.51 GFLOP, 0.0225 ms
// at 67 TFLOP/s, against 47 MB, 0.0141 ms at 3.35 TB/s.  Three launches,
// chained by PDL:
//   stage 1  W^T = (V_a^T V_b)^T into scratch, by 64 x 64 tiles.  nb is cut
//            into up to 8 slices of at least 64 rows, one block each, the
//            blocks of a tile forming one cluster, so that B = 1 still has
//            32 blocks (B = 15: 480).  Each block sums its slice in
//            registers (32-row chunks through a cp.async ring); the
//            partials are added through distributed shared memory in slice
//            order, with no atomics, so every run gives the same bits.
//   stage 2  T = U_a W into a second scratch (B, nb, k): formed once, not
//            once per output tile.
//   stage 3  out = acc - T U_b^T, by 64 x 64 tiles at every batch (B = 15
//            at nb = 512: 960 blocks, B = 1: 64).
// Stages 2 and 3 are one product kernel (tlr_mm_gemm_f32): 256 threads, a
// 4 x 4 register tile a thread fed by 16-byte shared loads, 32-wide k-slabs
// through a 3-stage cp.async ring, at least two blocks an SM, and an
// epilogue through shared memory that reads acc and writes out 16 bytes a
// thread.  Every output's sum runs over the rank index in order, so the
// tile edge changes no bit.  A thread reads each element of acc before it
// writes that element of out, and no other thread touches it, so out = acc
// is safe.  Loads beyond nb or k read zero, so zero-padded rank columns add
// exact zeros.  scripts/tlr_mm_f32_variants.py times other work shapes
// against this one (PERF.md section 6): a second stage-3 kernel with
// 128 x 128 tiles and 8 x 8 outputs a thread gained 4% at B = 15 and
// nothing over the mixed sweep, and was left out.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// dmma_f64
// ---------------------------------------------------------------------------

constexpr int kS = 64;          // strip rows, column chunk, W tile edge
constexpr int kKC = 128;        // rank columns a pass
constexpr int kThr = 128;       // stage 1: 4 warps, 2 x 2 of 32 x 32 outputs
constexpr int kOutWarps = 8;    // stage 2
constexpr int kLdH = kS + 4;    // row stride of 64-wide tiles (4 mod 16)
constexpr int kLdC = kKC + 4;   // row stride of T and the U_b chunks
constexpr int kLdA = kS + 2;    // row stride of the acc chunks (16-byte rows)
constexpr int kNC = 32;         // stage 1: rows of V a chunk
constexpr int kWSmem = 4 * kNC * kLdH * (int)sizeof(double);
constexpr int kOutSmem = 3 * kS * kLdC * (int)sizeof(double);

// Stage 1: W[b][i0:i0+64, j0:j0+64] = V_a[b][:, i0:]^T V_b[b][:, j0:].
__global__ void __launch_bounds__(kThr)
    tlr_mm_w_f64(const double* __restrict__ va, const double* __restrict__ vb,
                 double* __restrict__ w, int nb, int k, int vec2) {
  extern __shared__ __align__(16) double wsmem[];
  double* sva[2] = {wsmem, wsmem + kNC * kLdH};
  double* svb[2] = {wsmem + 2 * kNC * kLdH, wsmem + 3 * kNC * kLdH};
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kS, j0 = blockIdx.x * kS;
  const double* A = va + (size_t)b * nb * k + i0;
  const double* B = vb + (size_t)b * nb * k + j0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  auto issue = [&](int ch) {
    const int n0 = ch * kNC;
    dmma::cp_tile<kNC, kS, kThr>(sva[ch & 1], kLdH, A + (size_t)n0 * k, k,
                                 nb - n0, k - i0, vec2, tid);
    dmma::cp_tile<kNC, kS, kThr>(svb[ch & 1], kLdH, B + (size_t)n0 * k, k,
                                 nb - n0, k - j0, vec2, tid);
    dmma::cp_async_commit();
  };
  double acc[2][4][4] = {};
  const int nch = (nb + kNC - 1) / kNC;
  issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      issue(ch + 1);
      dmma::cp_async_wait<1>();
    } else {
      dmma::cp_async_wait<0>();
    }
    __syncthreads();
    const double* sa = sva[ch & 1];
    const double* sb = svb[ch & 1];
#pragma unroll
    for (int k0 = 0; k0 < kNC; k0 += 8) {
      double a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        dmma::load_a_cols(a[mi], sa, kLdH, wm + 16 * mi, k0, g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        dmma::load_b_cols(bf[ni], sb, kLdH, wn + 8 * ni, k0, g, t);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          dmma::mma_16x8x8(acc[mi][ni], a[mi], bf[ni]);
    }
    __syncthreads();
  }
  double* W = w + (size_t)b * k * k;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = i0 + wm + 16 * mi + g + 8 * (v / 2);
        const int c = j0 + wn + 8 * ni + 2 * t + v % 2;
        if (r < k && c < k) W[(size_t)r * k + c] = acc[mi][ni][v];
      }
}

// Stage 2: out[b][r0:r0+64, :] = acc - (U_a[b][r0:r0+64, :] W[b]) U_b[b]^T.
// acc_in and out may be the same storage.  Eight warps: for T they are
// 2 x 4 of 32 x 32; for the sweep 4 x 2 of 16 x 32, each warp holding the A
// fragments of its 16 rows of T for the whole pass in registers (64
// doubles), so the sweep's inner loop loads only U_b fragments.
__global__ void __launch_bounds__(32 * kOutWarps, 1)
    tlr_mm_out_f64(const double* __restrict__ ua, const double* __restrict__ ub,
                   const double* __restrict__ w, const double* acc_in,
                   double* out, int nb, int k, int vec2,
                   int vec2acc) {
  extern __shared__ __align__(16) double smem[];
  double* st = smem;  // [64][kLdC]: T for the pass's rank columns
  double* buf[2] = {smem + kS * kLdC, smem + 2 * kS * kLdC};
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kS;
  const double* Ua = ua + (size_t)b * nb * k;
  const double* Ub = ub + (size_t)b * nb * k;
  const double* W = w + (size_t)b * k * k;
  const size_t base = (size_t)b * nb * nb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // Column chunks of this block: all of them, or a share of them when the
  // batch is too small to fill the card (gridDim.z groups, each forming T).
  const int nall = (nb + kS - 1) / kS;
  const int per = (nall + gridDim.z - 1) / gridDim.z;
  const int cbeg = blockIdx.z * per, nch = min(nall, cbeg + per) - cbeg;
  constexpr int kThreads = 32 * kOutWarps;
  constexpr int TN = 4;  // T phase: 2 x 4 warps of 32 x (8 TN)
  constexpr int ON = 4;  // sweep: 4 x 2 warps of 16 x (8 ON)

  for (int p0 = 0; p0 < k; p0 += kKC) {
    const int kcr = (min(kKC, k - p0) + 7) / 8 * 8;
    const double* src = p0 == 0 ? acc_in : out;
    // ---- T = U_a[strip] W[:, p0:p0+128], 128 rank rows of W at a time:
    // the strip's U_a columns go to buf[0], W's rows to buf[1] and st, all
    // in flight together; warps of 32 x (8 TN).
    {
      const int wm = (warp / 4) * 32, wn = (warp % 4) * 8 * TN;
      double tacc[2][TN][4] = {};
      for (int l0 = 0; l0 < k; l0 += kKC) {
        const int lr = min(kKC, k - l0);
        dmma::cp_tile<kS, kKC, kThreads>(buf[0], kLdC, Ua + (size_t)r0 * k + l0,
                                         k, nb - r0, k - l0, vec2, tid);
        // U_a is not written by stage 1: only W waits for it
        if (p0 == 0 && l0 == 0) dmma::grid_wait();
        dmma::cp_tile<kS, kKC, kThreads>(buf[1], kLdC, W + (size_t)l0 * k + p0,
                                         k, k - l0, k - p0, vec2, tid);
        if (lr > kS)
          dmma::cp_tile<kS, kKC, kThreads>(st, kLdC,
                                           W + (size_t)(l0 + kS) * k + p0, k,
                                           k - l0 - kS, k - p0, vec2, tid);
        dmma::cp_async_commit();
        dmma::cp_async_wait<0>();
        __syncthreads();
#pragma unroll 2
        for (int k0 = 0; k0 < lr; k0 += 8) {
          const double* sw = k0 < kS ? buf[1] : st;
          const int kw = k0 < kS ? k0 : k0 - kS;
          double a[2][4], bf[TN][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            dmma::load_a_rows(a[mi], buf[0], kLdC, wm + 16 * mi, k0, g, t);
#pragma unroll
          for (int ni = 0; ni < TN; ++ni)
            dmma::load_b_cols(bf[ni], sw, kLdC, wn + 8 * ni, kw, g, t);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < TN; ++ni)
              dmma::mma_16x8x8(tacc[mi][ni], a[mi], bf[ni]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < TN; ++ni)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int r = wm + 16 * mi + g + 8 * (v / 2);
            const int c = wn + 8 * ni + 2 * t + v % 2;
            st[r * kLdC + c] = tacc[mi][ni][v];
          }
    }
    __syncthreads();  // T complete
    // ---- this warp's rows of T as A fragments, zero past kcr.
    const int wm = (warp / 2) * 16, wn = (warp % 2) * 8 * ON;
    double ta[kKC / 8][4];
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      if (8 * ks < kcr) {
        dmma::load_a_rows(ta[ks], st, kLdC, wm, 8 * ks, g, t);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) ta[ks][v] = 0.0;
      }
    }
    __syncthreads();  // st is free: it takes two chunks of src from here on
    // Chunk ci of U_b and of src go to buf[ci & 1] and sacc[ci & 1].
    const double* srow = src + base + (size_t)r0 * nb;
    double* sacc[2] = {st, st + kS * kLdA};
    auto issue = [&](int ci) {
      const int c0 = (cbeg + ci) * kS;
      dmma::cp_tile<kS, kKC, kThreads>(buf[ci & 1], kLdC,
                                       Ub + (size_t)c0 * k + p0, k, nb - c0,
                                       k - p0, vec2, tid);
      dmma::cp_tile<kS, kS, kThreads>(sacc[ci & 1], kLdA, srow + c0, nb,
                                      nb - r0, nb - c0, vec2acc, tid);
      dmma::cp_async_commit();
    };
    if (nch > 0) issue(0);
    // ---- out[strip, c0:c0+64] = src - T U_b[c0:c0+64, p0:p0+kc]^T.
    for (int ci = 0; ci < nch; ++ci) {
      const int c0 = (cbeg + ci) * kS;
      if (ci + 1 < nch) issue(ci + 1);
      if (ci + 1 < nch)
        dmma::cp_async_wait<1>();
      else
        dmma::cp_async_wait<0>();
      __syncthreads();
      const double* sb = buf[ci & 1];
      const double* sc = sacc[ci & 1];
      double oacc[ON][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        if (8 * ks < kcr) {
          double bf[ON][2];
#pragma unroll
          for (int ni = 0; ni < ON; ++ni)
            dmma::load_b_rows(bf[ni], sb, kLdC, wn + 8 * ni, 8 * ks, g, t);
#pragma unroll
          for (int ni = 0; ni < ON; ++ni)
            dmma::mma_16x8x8(oacc[ni], ta[ks], bf[ni]);
        }
      }
      // Each thread holds pairs of neighbours (2t, 2t + 1): with even rows
      // they go out as one 16-byte store, so a warp writes whole sectors.
#pragma unroll
      for (int ni = 0; ni < ON; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + g + 8 * h, c = wn + 8 * ni + 2 * t;
          if (r0 + r >= nb || c0 + c >= nb) continue;
          const double x0 = sc[r * kLdA + c] - oacc[ni][2 * h];
          const double x1 = sc[r * kLdA + c + 1] - oacc[ni][2 * h + 1];
          double* o = out + base + (size_t)(r0 + r) * nb + c0 + c;
          if (vec2acc) {
            *reinterpret_cast<double2*>(o) = make_double2(x0, x1);
          } else {
            o[0] = x0;
            if (c0 + c + 1 < nb) o[1] = x1;
          }
        }
      __syncthreads();
    }
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

int launch_f64(const double* ua, const double* va, const double* ub,
               const double* vb, const double* acc, double* w, double* out,
               int batch, int nb, int k, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const int vec2 = k % 2 == 0 && aligned16(ua) && aligned16(va) &&
                   aligned16(ub) && aligned16(vb) && aligned16(w);
  cudaError_t err = cudaFuncSetAttribute(
      tlr_mm_w_f64, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return (int)err;
  const int kt = (k + kS - 1) / kS;
  err = dmma::launch_pdl(tlr_mm_w_f64, dim3(kt, kt, batch), kThr, kWSmem,
                         stream, va, vb, w, nb, k, vec2);
  if (err != cudaSuccess) return (int)err;
  // A batch too small to fill the card splits each strip's columns over
  // several blocks, each of which forms the strip's T itself.
  const int strips = (nb + kS - 1) / kS;
  const int groups =
      std::max(1, std::min(strips, dmma::sm_count() / (strips * batch)));
  const dim3 grid(strips, batch, groups);
  const int vec2acc = nb % 2 == 0 && aligned16(acc) && aligned16(out);
  err = cudaFuncSetAttribute(tlr_mm_out_f64,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOutSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)dmma::launch_pdl(tlr_mm_out_f64, grid, 32 * kOutWarps,
                               kOutSmem, stream, ua, ub, w, acc, out, nb, k,
                               vec2, vec2acc);
}

// ---------------------------------------------------------------------------
// fma_f32
// ---------------------------------------------------------------------------

// Work shapes of the instance; scripts/tlr_mm_f32_variants.py builds copies
// of this file with other values, by replacing text, to time them.
constexpr int kFThreads = 256;      // 16 x 16 threads, warps of 4 x 8
constexpr int kFSlab = 32;          // stages 2, 3: k-slab of the ring
constexpr int kFLd = kFSlab + 4;    // row stride of a staged slab
constexpr int kFStages = 3;         // stages 2, 3: depth of the cp.async ring
constexpr int kFBlocks = 2;         // stages 2, 3: blocks an SM at least
constexpr int kFW = 64;             // stage 1: W tile edge
constexpr int kFWRows = 32;         // stage 1: rows of V a chunk
constexpr int kFWStages = 2;        // stage 1: depth of its cp.async ring
// stage 1's shared memory: the ring, then this block's partial W tile
constexpr int kFWRing = kFWStages * 2 * kFWRows * kFW;
constexpr int kFWSmem = kFWRing > kFW * (kFW + 1) ? kFWRing : kFW * (kFW + 1);
constexpr int kFSliceMin = 64;      // stage 1: rows of a slice at least
constexpr int kFSplitMax = 8;       // stage 1: slices of nb at most (a cluster)
static_assert(kFSplitMax >= 1 && kFSplitMax <= 8, "a portable cluster");

// This thread's place in the 16 x 16 grid of a block: each warp covers 4
// rows x 8 columns of it, so the rows a warp reads in one shared load fall
// in 4 (ty) or 8 (tx) distinct 16-byte bank groups.
__device__ __forceinline__ void f32_place(int tid, int& ty, int& tx) {
  const int warp = tid / 32, lane = tid % 32;
  ty = 4 * (warp / 2) + lane / 8;
  tx = 8 * (warp % 2) + lane % 8;
}

__device__ __forceinline__ void cluster_sync_f32() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at address p of the shared memory of block `rank` of the
// cluster (distributed shared memory).
__device__ __forceinline__ float cluster_load_f32(const float* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned d;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(rank));
  // volatile keeps the load after the cluster barrier; without a memory
  // clobber the loads of one sum may be in flight together
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(d));
  return x;
}

// Stage 1: W^T, Wt[b][j][i] = sum_n V_a[b][n][i] V_b[b][n][j], by 64 x 64
// tiles.  nb is cut into `splits` slices of `slice` rows (the last may be
// short or empty); a cluster of `splits` blocks owns one tile, block s
// forming slice s's partial sum in registers (rows n in order, kFWRows at a
// time through a cp.async ring).  The partials meet in shared memory, and block
// s of the cluster adds up its share of the tile's rows from all of them
// through distributed shared memory, in the order 0, 1, ..., splits - 1:
// the result does not depend on the batch, the schedule or the run.
__global__ void __launch_bounds__(kFThreads)
    tlr_mm_w_f32(const float* __restrict__ va, const float* __restrict__ vb,
                 float* __restrict__ wt, int nb, int k, int splits, int slice,
                 int vec4) {
  __shared__ __align__(16) float wsm[kFWSmem];
  float(*part)[kFW + 1] = reinterpret_cast<float(*)[kFW + 1]>(wsm);  // [j][i]
  const int s = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int kt = (k + kFW - 1) / kFW;
  const int i0 = (tile / kt) * kFW, j0 = (tile % kt) * kFW;
  const int b = blockIdx.y;
  const int n0 = s * slice, n1 = min(nb, n0 + slice);
  const float* A = va + (size_t)b * nb * k + i0;
  const float* B = vb + (size_t)b * nb * k + j0;
  const int tid = threadIdx.x;
  int ty, tx;
  f32_place(tid, ty, tx);
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  float acc[4][4] = {};
  const int nch = n1 > n0 ? (n1 - n0 + kFWRows - 1) / kFWRows : 0;
  auto load = [&](int st, int ch) {
    const int r0 = n0 + ch * kFWRows;
    float* sa = wsm + 2 * st * kFWRows * kFW;
    dmma::cp_tile<kFWRows, kFW, kFThreads>(sa, kFW, A + (size_t)r0 * k, k,
                                           n1 - r0, k - i0, vec4, tid);
    dmma::cp_tile<kFWRows, kFW, kFThreads>(sa + kFWRows * kFW, kFW,
                                           B + (size_t)r0 * k, k, n1 - r0,
                                           k - j0, vec4, tid);
  };
  auto compute = [&](int st, int) {
    const float* sa = wsm + 2 * st * kFWRows * kFW;
    const float* sb = sa + kFWRows * kFW;
#pragma unroll
    for (int r = 0; r < kFWRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(sa + r * kFW + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(sb + r * kFW + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], cv[q], acc[p][q]);
    }
  };
  dmma::cp_async_ring<kFWStages>(nch, load, compute);
  // the ring has drained: the partial takes its place
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[4 * tx + q][4 * ty + p] = acc[p][q];
  cluster_sync_f32();  // every partial of the tile is complete
  float* W = wt + (size_t)b * k * k;
  const int rows = (kFW - s + splits - 1) / splits;  // j = s, s + splits, ...
  for (int e = tid; e < rows * kFW; e += kFThreads) {
    const int j = s + splits * (e / kFW), i = e % kFW;
    float x = cluster_load_f32(&part[j][i], 0);
    for (int r = 1; r < splits; ++r) x += cluster_load_f32(&part[j][i], r);
    if (j0 + j < k && i0 + i < k) W[(size_t)(j0 + j) * k + i0 + i] = x;
  }
  cluster_sync_f32();  // no block leaves while others read its partial
}

// The epilogues of the product kernel, given four neighbouring columns
// (col .. col + 3) of row `row` of batch entry b's product tile.
struct StoreT {  // stage 2: T[b] = the product, (M x N) row-major
  float* t;
  int vec4;
  __device__ __forceinline__ void operator()(int b, int row, int col, int M,
                                             int N, float4 c) const {
    float* o = t + ((size_t)b * M + row) * N;
    if (vec4 && col + 3 < N) {
      *reinterpret_cast<float4*>(o + col) = c;
      return;
    }
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < N) o[col + q] = cv[q];
  }
};

// Stage 3: out[b] = acc[b] - the product, the product widened exactly when
// acc and out are double.  acc and out may be the same storage: a thread
// reads each element of acc before it writes that element of out, and no
// other thread touches it.
template <typename AccT>
struct SubAcc {
  const AccT* acc;
  AccT* out;
  int vec;  // 16-byte accesses: rows of acc and out 16-byte aligned
  __device__ __forceinline__ void operator()(int b, int row, int col, int M,
                                             int N, float4 c) const {
    const size_t base = ((size_t)b * M + row) * N;
    const AccT* a = acc + base;
    AccT* o = out + base;
    const float cv[4] = {c.x, c.y, c.z, c.w};
    if (vec && col + 3 < N) {
      if constexpr (sizeof(AccT) == 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + col);
        *reinterpret_cast<float4*>(o + col) =
            make_float4(x.x - cv[0], x.y - cv[1], x.z - cv[2], x.w - cv[3]);
      } else {
        const double2 x0 = *reinterpret_cast<const double2*>(a + col);
        const double2 x1 = *reinterpret_cast<const double2*>(a + col + 2);
        *reinterpret_cast<double2*>(o + col) =
            make_double2(x0.x - (double)cv[0], x0.y - (double)cv[1]);
        *reinterpret_cast<double2*>(o + col + 2) =
            make_double2(x1.x - (double)cv[2], x1.y - (double)cv[3]);
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < N) o[col + q] = a[col + q] - (AccT)cv[q];
  }
};

// The product kernel of stages 2 and 3 (C = X Y^T for X, Y stored by rows,
// the reduction along their rows):
//   C[b][m][n] = sum_l X[b][m][l] Y[b][n][l],  m < M, n < N, l < K,
// one (16 TM) x (16 TN) tile a block, each thread owning TM x TN outputs
// (rows ty + 16 i, columns tx + 16 j) in registers.  32-wide k-slabs of X's
// and Y's rows stream through a cp.async ring (dmma::cp_async_ring) at a
// row stride of 36 floats, so a warp's 16-byte fragment loads (4 rows of
// X, 8 rows of Y, 4 consecutive l each) meet no bank conflict; a thread
// loads TM + TN float4 for 4 TM TN FMAs.  Every output's sum runs over l in
// order, whatever the tile, so the tile edge changes no bit.
// The tile then goes through shared memory so that the epilogue reads and
// writes whole rows, four columns a thread.
template <int TM, int TN>
struct Gemm {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int STAGE = (BM + BN) * kFLd;  // floats
  static constexpr int LDC = BN + 8;  // the staged tile [BM][LDC]
  static constexpr int RING = kFStages * STAGE;
  static constexpr int SMEM =
      (RING > BM * LDC ? RING : BM * LDC) * (int)sizeof(float);
};

template <int TM, int TN, typename Epi>
__global__ void __launch_bounds__(kFThreads, kFBlocks)
    tlr_mm_gemm_f32(const float* __restrict__ X, const float* __restrict__ Y,
                    int M, int N, int K, int vec4, Epi epi) {
  using G = Gemm<TM, TN>;
  extern __shared__ __align__(16) float fsmem[];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  const float* Xb = X + (size_t)b * M * K + (size_t)m0 * K;
  const float* Yb = Y + (size_t)b * N * K + (size_t)n0 * K;
  const int tid = threadIdx.x;
  int ty, tx;
  f32_place(tid, ty, tx);
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  float acc[TM][TN] = {};
  auto load = [&](int st, int q) {
    const int l0 = q * kFSlab;
    float* sx = fsmem + st * G::STAGE;
    dmma::cp_tile<G::BM, kFSlab, kFThreads>(sx, kFLd, Xb + l0, K, M - m0,
                                            K - l0, vec4, tid);
    dmma::cp_tile<G::BN, kFSlab, kFThreads>(sx + G::BM * kFLd, kFLd, Yb + l0, K,
                                            N - n0, K - l0, vec4, tid);
  };
  auto compute = [&](int st, int) {
    const float* sx = fsmem + st * G::STAGE;
    const float* sy = sx + G::BM * kFLd;
#pragma unroll
    for (int kk = 0; kk < kFSlab; kk += 4) {
      float4 xa[TM], yb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        xa[i] =
            *reinterpret_cast<const float4*>(sx + (ty + 16 * i) * kFLd + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        yb[j] =
            *reinterpret_cast<const float4*>(sy + (tx + 16 * j) * kFLd + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(xa[i].x, yb[j].x, acc[i][j]);
          acc[i][j] = fmaf(xa[i].y, yb[j].y, acc[i][j]);
          acc[i][j] = fmaf(xa[i].z, yb[j].z, acc[i][j]);
          acc[i][j] = fmaf(xa[i].w, yb[j].w, acc[i][j]);
        }
    }
  };
  dmma::cp_async_ring<kFStages>((K + kFSlab - 1) / kFSlab, load, compute);
  float* sc = fsmem;  // the ring has drained: the tile takes its place
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      sc[(ty + 16 * i) * G::LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
  constexpr int Q = G::BN / 4;
#pragma unroll 4
  for (int e = tid; e < G::BM * Q; e += kFThreads) {
    const int r = e / Q, c = 4 * (e % Q);
    if (m0 + r < M && n0 + c < N)
      epi(b, m0 + r, n0 + c, M, N,
          *reinterpret_cast<const float4*>(sc + r * G::LDC + c));
  }
}

template <int TM, int TN, typename Epi>
cudaError_t launch_gemm_f32(const float* x, const float* y, int batch, int M,
                            int N, int K, int vec4, Epi epi,
                            cudaStream_t stream) {
  using G = Gemm<TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      tlr_mm_gemm_f32<TM, TN, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM, batch);
  return dmma::launch_pdl(tlr_mm_gemm_f32<TM, TN, Epi>, grid, kFThreads,
                          G::SMEM, stream, x, y, M, N, K, vec4, epi);
}

template <typename AccT>
int launch_f32(const float* ua, const float* va, const float* ub,
               const float* vb, const AccT* acc, float* w, float* t,
               AccT* out, int batch, int nb, int k, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const int vec4 = k % 4 == 0 && aligned16(ua) && aligned16(va) &&
                   aligned16(ub) && aligned16(vb) && aligned16(w) &&
                   aligned16(t);
  // stage 1: slices of at least 64 rows, at most kFSplitMax of them, each a
  // multiple of the kFWRows-row chunk; one cluster of `splits` blocks a W
  // tile
  const int splits = std::min(kFSplitMax, (nb + kFSliceMin - 1) / kFSliceMin);
  const int per = (nb + splits - 1) / splits;
  const int slice = (per + kFWRows - 1) / kFWRows * kFWRows;
  const int kt = (k + kFW - 1) / kFW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(splits * kt * kt), batch);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tlr_mm_w_f32, va, vb, w, nb, k,
                                       splits, slice, vec4);
  if (err != cudaSuccess) return (int)err;
  // stage 2: T = U_a W, (nb x k), into scratch
  err = launch_gemm_f32<4, 4>(ua, w, batch, nb, k, k, vec4, StoreT{t, vec4},
                              stream);
  if (err != cudaSuccess) return (int)err;
  // stage 3: out = acc - T U_b^T, by 64 x 64 tiles at every batch (B = 15
  // at nb = 512: 960 blocks, B = 1: 64)
  const int vec = nb % (16 / (int)sizeof(AccT)) == 0 && aligned16(acc) &&
                  aligned16(out);
  const SubAcc<AccT> epi{acc, out, vec};
  return (int)launch_gemm_f32<4, 4>(t, ub, batch, nb, nb, k, vec4, epi,
                                    stream);
}

}  // namespace

// ua, va, ub, vb (batch, nb, k); acc, out (batch, nb, nb); w is scratch of
// (batch, k, k).  All contiguous, row-major, on the device; out may be acc
// (the same storage) and may overlap no other argument.  Returns the first
// non-zero cudaGetLastError() after a launch (0 on success).
extern "C" int tlr_mm_f64(const double* ua, const double* va, const double* ub,
                          const double* vb, const double* acc, double* w,
                          double* out, int batch, int nb, int k,
                          void* stream) {
  return launch_f64(ua, va, ub, vb, acc, w, out, batch, nb, k,
                    static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: f32 factors, acc and out; w (batch, k, k) and t
// (batch, nb, k) are f32 scratch the caller allocates (16-byte aligned),
// which may overlap nothing else.
extern "C" int tlr_mm_f32(const float* ua, const float* va, const float* ub,
                          const float* vb, const float* acc, float* w,
                          float* t, float* out, int batch, int nb, int k,
                          void* stream) {
  return launch_f32<float>(ua, va, ub, vb, acc, w, t, out, batch, nb, k,
                           static_cast<cudaStream_t>(stream));
}

// The same instance with f64 acc and out (the SYRK of a mixed precision
// policy): out = acc - (double) y, y the f32 product rounded as the all-f32
// form rounds it.
extern "C" int tlr_mm_f32_wide(const float* ua, const float* va,
                               const float* ub, const float* vb,
                               const double* acc, float* w, float* t,
                               double* out, int batch, int nb, int k,
                               void* stream) {
  return launch_f32<double>(ua, va, ub, vb, acc, w, t, out, batch, nb, k,
                            static_cast<cudaStream_t>(stream));
}
