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
// Two instances, picked by the dtype:
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
// fma_f32 (f32): the first kernel of this file, on the FP32 CUDA
// cores, in the same two stages: W by 64 x 64 tiles reduced over nb in
// chunks of 16 staged in shared memory; then per (b, 64-row panel) T =
// U_a[rows] W formed into dynamic shared memory and out[rows, :] = acc -
// T U_b^T swept by 64-column tiles.  256 threads as 16 x 16, a thread owning
// a 4 x 4 set of outputs; each output element is read from acc and written
// by the same thread, so out = acc is safe here too.
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


constexpr int kTile = 64;  // output tile edge
constexpr int kChunk = 16;  // reduction chunk staged in shared memory
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void fma_chunk(T (*sa)[kTile + 1],
                                          T (*sb)[kTile + 1], T acc[4][4],
                                          int ty, int tx) {
#pragma unroll
  for (int l = 0; l < kChunk; ++l) {
    T ra[4], rb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ra[i] = sa[l][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) rb[j] = sb[l][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ra[i] * rb[j];
  }
}

// Stage 1: W[b][i][j] = sum_n Va[b][n][i] * Vb[b][n][j].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tlr_mm_w_kernel(const T* __restrict__ va, const T* __restrict__ vb,
                    T* __restrict__ w, int nb, int k) {
  __shared__ T sa[kChunk][kTile + 1];
  __shared__ T sb[kChunk][kTile + 1];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const T* A = va + (size_t)b * nb * k;
  const T* B = vb + (size_t)b * nb * k;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  T acc[4][4] = {};
  for (int n0 = 0; n0 < nb; n0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int l = e / kTile, c = e % kTile;  // c runs along k: coalesced
      const int n = n0 + l;
      sa[l][c] = (n < nb && i0 + c < k) ? A[(size_t)n * k + i0 + c] : T(0);
      sb[l][c] = (n < nb && j0 + c < k) ? B[(size_t)n * k + j0 + c] : T(0);
    }
    __syncthreads();
    fma_chunk<T>(sa, sb, acc, ty, tx);
    __syncthreads();
  }
  T* W = w + (size_t)b * k * k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx + 16 * j;
      if (r < k && c < k) W[(size_t)r * k + c] = acc[i][j];
    }
  }
}

// Stage 2: out[b][r0:r0+64, :] = acc - (Ua[b][r0:r0+64, :] W[b]) Ub[b]^T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tlr_mm_out_kernel(const T* __restrict__ ua, const T* __restrict__ ub,
                      const T* __restrict__ w, const T* acc_in, T* out,
                      int nb, int k) {
  extern __shared__ unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // [kTile][k]: T = Ua[rows] W
  __shared__ T sa[kChunk][kTile + 1];
  __shared__ T sb[kChunk][kTile + 1];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const T* Ua = ua + (size_t)b * nb * k;
  const T* Ub = ub + (size_t)b * nb * k;
  const T* W = w + (size_t)b * k * k;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;

  // Phase 1: st = Ua[r0:r0+64, :] W, 64 columns at a time.
  for (int j0 = 0; j0 < k; j0 += kTile) {
    T acc[4][4] = {};
    for (int l0 = 0; l0 < k; l0 += kChunk) {
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int r = e / kChunk, l = e % kChunk;  // l runs along k in Ua
        sa[l][r] = (r0 + r < nb && l0 + l < k)
                       ? Ua[(size_t)(r0 + r) * k + l0 + l] : T(0);
        const int l2 = e / kTile, c = e % kTile;   // c runs along k in W
        sb[l2][c] = (l0 + l2 < k && j0 + c < k)
                        ? W[(size_t)(l0 + l2) * k + j0 + c] : T(0);
      }
      __syncthreads();
      fma_chunk<T>(sa, sb, acc, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = j0 + tx + 16 * j;
        if (c < k) st[(ty + 16 * i) * k + c] = acc[i][j];
      }
  }
  __syncthreads();

  // Phase 2: out[rows, c0:c0+64] = acc - st Ub[c0:c0+64, :]^T.
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    T acc[4][4] = {};
    for (int l0 = 0; l0 < k; l0 += kChunk) {
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int c = e / kChunk, l = e % kChunk;  // l runs along k in Ub
        sb[l][c] = (c0 + c < nb && l0 + l < k)
                       ? Ub[(size_t)(c0 + c) * k + l0 + l] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int l = 0; l < kChunk; ++l) {
        if (l0 + l >= k) break;
        T ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = st[(ty + 16 * i) * k + l0 + l];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = sb[l][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += ra[i] * rb[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (r < nb && c < nb) {
          const size_t idx = ((size_t)b * nb + r) * nb + c;
          out[idx] = acc_in[idx] - acc[i][j];
        }
      }
    }
  }
}

int launch_f32(const float* ua, const float* va, const float* ub,
               const float* vb, const float* acc, float* w, float* out,
               int batch, int nb, int k, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(16, 16);
  const int kt = (k + kTile - 1) / kTile;
  tlr_mm_w_kernel<float><<<dim3(kt, kt, batch), block, 0, stream>>>(va, vb, w,
                                                                   nb, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kTile * k * sizeof(float);
  err = cudaFuncSetAttribute(tlr_mm_out_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + kTile - 1) / kTile, batch);
  tlr_mm_out_kernel<float><<<grid, block, smem, stream>>>(ua, ub, w, acc, out,
                                                          nb, k);
  return (int)cudaGetLastError();
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

// The fma_f32 instance, with the same arguments.
extern "C" int tlr_mm_f32(const float* ua, const float* va, const float* ub,
                          const float* vb, const float* acc, float* w,
                          float* out, int batch, int nb, int k, void* stream) {
  return launch_f32(ua, va, ub, vb, acc, w, out, batch, nb, k,
                    static_cast<cudaStream_t>(stream));
}
