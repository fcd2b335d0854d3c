// POTRF: batched lower Cholesky factor of SPD tiles,
//
//   out[b] = L  with  L L^T = a[b],  L lower triangular, zeros above,
//
// batched over b, a and out of shape (B, nb, nb).  Replaces the Pallas TPU
// kernel src/repro/kernels/chol_tiles.py::potrf (body _potrf_kernel).  On the
// TLR Cholesky path it is the panel-head POTRF of every panel step and the
// POTRF of the last diagonal tile; on the exact path the POTRF of each panel.
//
// Failure: where a pivot is not positive or not finite, the whole tile of
// out becomes NaN (what jnp.linalg.cholesky gives, and what the plain
// version kernels/ref.py::potrf_ref gives), so the factorization status and
// the sentinel log-likelihood see it.  Only the lower triangle of a[b] is
// read.  Any nb >= 1 works.
//
// Bound on the card: nb^3 / 3 flops (nb^3 / 6 FMAs) against 2 nb^2
// itemsize bytes.  At nb = 512 in f64 the bytes bound it: 4.2 MB, 1.25 us at
// 3.35 TB/s.  What really sets the time is the chain of nb dependent pivots
// (each a reciprocal square root and a broadcast) and the steps that must
// follow one another across the card.  At nb = 4096 the operations bound
// it: 22.9 GFLOP, 0.34 ms at the 67 TFLOP/s of the FP64 tensor cores.
//
// Two instances, picked by the dtype:
//
// dmma_f64 (f64): a blocked right-looking Cholesky spread over the card, in
// panels of kP = 64 columns.  The C entry point issues every launch of the
// factorization on the caller's stream, with no host sync: a copy, then per
// panel a panel launch and an update launch, then a NaN pass (2 nb / 64 + 1
// launches at most).  Each is a programmatic dependent launch (Hopper), so
// the next kernel is scheduled while the previous one drains and waits for
// it with griddepcontrol.wait, which shortens the gaps between launches.
//   copy    out = lower(a), zeros above (all blocks of the card).
//   panel   one 256-thread block per 64 rows below the panel (at least one).
//           Each block factors the 64 x 64 diagonal block itself, so no
//           launch separates the diagonal factor from the solve: one warp
//           factors the first 32 columns, the next pivot reaching it by a
//           shuffle from the lane that owns it (the chain from pivot to
//           pivot is a shuffle, a reciprocal square root and two FP64
//           operations), and solves the 32 rows below; three warps apply
//           the rank-32 update of the second half on DMMA; the warp then
//           factors the second half.  Every block reads the unfactored
//           diagonal block, and a grid larger than the blocks the card
//           holds at once runs in waves, so no block may write L_kk over it
//           before all have read it: each block takes a ticket (atomicAdd
//           on a per-tile counter) once its factor is done, and the last
//           one writes L_kk and resets the counter.  Then one thread a row
//           solves x L_kk^T = a right-looking, L_kk read two values at a
//           time from a transposed copy.  Each SM runs this code once a
//           launch, cold: fully unrolled it was far larger than the
//           instruction cache and bound by instruction fetch, so its loops
//           walk 8-column blocks and the loop bodies are reused.
//   update  one 128-thread block per 64 x 64 tile of the trailing lower
//           triangle (32 x 32 while 64 x 64 tiles would fill under two
//           waves of the card): C -= L_i L_c^T, rank 64, on the FP64 tensor
//           cores (mma.sync m16n8k8, dmma.cuh), four warps; the two panel
//           slices arrive by cp.async while the tile's old values are
//           loaded into registers.
//   nan     a tile whose flag is set comes back all NaN.
// A bad pivot sets the tile's flag (an int the wrapper zeroes); every later
// launch of that tile reads it and returns at once.  All blocks of a panel
// launch factor the same data the same way, so a bad pivot fails all of
// them and none writes L_kk.  Folding the next
// panel's factor into this step's update (look-ahead) was not built, so it
// was not measured; at nb = 512 the panel launches take most of the time
// (PERF.md), and their pivot chain is what a look-ahead would have to hide.
//
// fma_f32 (f32): the first kernel of this file, one 256-thread block
// a tile on the FP32 CUDA cores, right-looking in 32-column panels: the
// diagonal block factored unblocked in shared memory, the rows below solved
// against it, the trailing triangle updated in 64 x 64 tiles of 4 x 4
// outputs a thread.  DMMA has no f32 form.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dmma.cuh"

namespace {

template <typename T>
__device__ __forceinline__ bool good_pivot(T p) {
  return p > T(0) && isfinite(p);
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ULL);
}
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}

// ---------------------------------------------------------------------------
// dmma_f64
// ---------------------------------------------------------------------------

constexpr int kP = 64;              // panel width
constexpr int kH = 32;              // half panel: one warp's factor
constexpr int kPanelThreads = 256;
constexpr int kUpdThreads = 128;    // 4 warps, 2 x 2
constexpr int kLd = kP + 4;         // update panels' row stride (4 mod 16)
constexpr int kLs = kP + 2;         // panel kernel's row stride (16-byte rows)
constexpr int kPanelSmem = 3 * kP * kLs * (int)sizeof(double);

__global__ void potrf_copy_f64(const double* __restrict__ a,
                               double* __restrict__ out, int nb) {
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const size_t nn = (size_t)nb * nb;
  const double* A = a + blockIdx.y * nn;
  double* L = out + blockIdx.y * nn;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nn;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / nb), c = (int)(e % nb);
    L[e] = c <= r ? A[e] : 0.0;
  }
}

// The panel kernel runs once per launch on each SM, so its code is fetched
// cold every time: fully unrolled it was far larger than the instruction
// cache and bound by instruction fetch.  Its loops therefore walk 8-column
// blocks, each body unrolled and reused.

// Warp 0 factors the 32 x 32 block at (o, o) of sd (row stride kLs) in
// place, lane i on row o + i, and writes the factor's transpose into slt.
// Within an 8-column block the next pivot comes straight from the lane that
// owns it (a shuffle of x[c+1] - l^2), so the chain from one pivot to the
// next is a shuffle, a reciprocal square root and two FP64 ops; the block's
// columns reach the other lanes through sblk.  Sets *fail on a pivot that is
// not positive and finite.
__device__ __forceinline__ void factor_half(double* sd, double* slt,
                                            double* sblk, double* sinv,
                                            int* fail, int o, int i) {
  double* row = sd + (o + i) * kLs + o;
#pragma unroll 1
  for (int cb = 0; cb < kH; cb += 8) {
    double xb[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) xb[l] = row[cb + l];
    double p = __shfl_sync(0xffffffffu, xb[0], cb);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!good_pivot(p)) {  // p is the same in every lane
        if (i == 0) *fail = 1;
        return;
      }
      const int pc = cb + c;
      const double rinv = rsqrt(p);
      const double lic = i == pc ? p * rinv : (i > pc ? xb[c] * rinv : 0.0);
      if (c + 1 < 8)
        p = __shfl_sync(0xffffffffu, xb[(c + 1) % 8] - lic * lic, pc + 1);
      xb[c] = lic;
      sblk[i * 9 + c] = lic;
      if (i == 0) sinv[o + pc] = rinv;
      __syncwarp();
#pragma unroll
      for (int l = c + 1; l < 8; ++l)
        if (cb + l <= i) xb[l] -= lic * sblk[(cb + l) * 9 + c];
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      row[cb + l] = xb[l];
      slt[(o + cb + l) * kLs + o + i] = xb[l];
    }
    __syncwarp();
    // The row's later columns: x[l] -= sum_c L[i][cb+c] L[l][cb+c], l <= i.
#pragma unroll 1
    for (int lb = cb + 8; lb < kH; lb += 8) {
      double z[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) z[l] = row[lb + l];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int l = 0; l < 8; ++l)
          if (lb + l <= i) z[l] -= xb[c] * sblk[(lb + l) * 9 + c];
#pragma unroll
      for (int l = 0; l < 8; ++l) row[lb + l] = z[l];
    }
    __syncwarp();
  }
}

// One thread solves its row y (in shared memory, 16-byte aligned) against
// the first ncol columns of a lower factor whose transpose is slt:
// y <- y L^{-T}, right-looking, in 8-column blocks.
__device__ __forceinline__ void solve_row(double* y, const double* slt,
                                          const double* sinv, int ncol) {
#pragma unroll 1
  for (int cb = 0; cb < ncol; cb += 8) {
    double yb[8];
#pragma unroll
    for (int l = 0; l < 8; l += 2) {
      const double2 v = *reinterpret_cast<const double2*>(y + cb + l);
      yb[l] = v.x;
      yb[l + 1] = v.y;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      yb[c] *= sinv[cb + c];
#pragma unroll
      for (int l = c + 1; l < 8; ++l) yb[l] -= yb[c] * slt[(cb + c) * kLs + cb + l];
    }
#pragma unroll
    for (int l = 0; l < 8; l += 2)
      *reinterpret_cast<double2*>(y + cb + l) = make_double2(yb[l], yb[l + 1]);
#pragma unroll 1
    for (int lb = cb + 8; lb < ncol; lb += 8) {
      double z[8];
#pragma unroll
      for (int l = 0; l < 8; l += 2) {
        const double2 v = *reinterpret_cast<const double2*>(y + lb + l);
        z[l] = v.x;
        z[l + 1] = v.y;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const double* lc = slt + (cb + c) * kLs + lb;
#pragma unroll
        for (int l = 0; l < 8; l += 2) {
          const double2 v = *reinterpret_cast<const double2*>(lc + l);
          z[l] -= yb[c] * v.x;
          z[l + 1] -= yb[c] * v.y;
        }
      }
#pragma unroll
      for (int l = 0; l < 8; l += 2)
        *reinterpret_cast<double2*>(y + lb + l) = make_double2(z[l], z[l + 1]);
    }
  }
}

// Panel step at columns j0..j0+w-1 (w <= 64).  Every block factors the
// diagonal block: warp 0 the first 32 columns and the rows below them,
// three warps the rank-32 update of the second half on DMMA, warp 0 the
// second half.  The last block to finish its factor writes L_kk; then
// threads 0..63 each solve one of the block's 64 rows below the panel.
// flag holds the tiles' failure flags, then their tickets (2 B ints).
__global__ void __launch_bounds__(kPanelThreads, 1)
    potrf_panel_f64(double* __restrict__ out, int* __restrict__ flag, int nb,
                    int j0, int w, int vec2) {
  extern __shared__ __align__(16) double panel_smem[];
  double* sd = panel_smem;            // [64][kLs]: the diagonal block, L_kk
  double* sy = sd + kP * kLs;         // [64][kLs]: the block's panel rows
  double* slt = sy + kP * kLs;        // [64][kLs]: slt[c][l] = L_kk[l][c]
  __shared__ double sblk[kH * 9];
  __shared__ double sinv[kP];         // 1 / L_kk[c][c]
  __shared__ int fail, last;
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int bt = blockIdx.y;
  if (flag[bt]) return;
  double* L = out + (size_t)bt * nb * nb;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int t0 = j0 + w, r0 = t0 + blockIdx.x * kP;

  // Stage the diagonal block and this block's rows (zero past nb and w).
  const double* diag = L + (size_t)j0 * nb + j0;
  dmma::cp_tile<kP, kP, kPanelThreads>(sd, kLs, diag, nb, w, w, vec2, tid);
  if (r0 < nb)
    dmma::cp_tile<kP, kP, kPanelThreads>(sy, kLs, L + (size_t)r0 * nb + j0, nb,
                                         nb - r0, w, vec2, tid);
  dmma::cp_async_commit();
  if (tid == 0) fail = 0;
  dmma::cp_async_wait<0>();
  __syncthreads();
  // Zeros above the diagonal, the identity past w.
  for (int e = tid; e < kP * kP; e += kPanelThreads) {
    const int r = e / kP, c = e % kP;
    if (c > r) sd[r * kLs + c] = 0.0;
    else if (r >= w && c == r) sd[r * kLs + c] = 1.0;
  }
  __syncthreads();

  // L11, then L21 = A21 L11^{-T} (warp 0, lane i on row 32 + i).
  if (warp == 0) {
    factor_half(sd, slt, sblk, sinv, &fail, 0, lane);
    __syncwarp();
    if (!fail) solve_row(sd + (kH + lane) * kLs, slt, sinv, kH);
  }
  __syncthreads();
  if (fail) {
    if (tid == 0) flag[bt] = 1;
    return;
  }
  // A22 -= L21 L21^T on DMMA: warps 0, 1, 2 take the 16 x 16 quadrants
  // (0, 0), (1, 0), (1, 1) of the lower triangle.
  if (warp < 3) {
    const int mi = warp == 0 ? 0 : 1, ni = warp == 2 ? 1 : 0;
    double acc[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kH; k0 += 8) {
      double a[4], b[2][2];
      dmma::load_a_rows(a, sd, kLs, kH + 16 * mi, k0, g, t);
      dmma::load_b_rows(b[0], sd, kLs, kH + 16 * ni, k0, g, t);
      dmma::load_b_rows(b[1], sd, kLs, kH + 16 * ni + 8, k0, g, t);
      dmma::mma_16x8x8(acc[0], a, b[0]);
      dmma::mma_16x8x8(acc[1], a, b[1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 16 * mi + g + 8 * (v / 2);
        const int c = 16 * ni + 8 * j + 2 * t + v % 2;
        if (c <= r) sd[(kH + r) * kLs + kH + c] -= acc[j][v];
      }
  }
  __syncthreads();
  if (warp == 0) factor_half(sd, slt, sblk, sinv, &fail, kH, lane);
  __syncthreads();
  if (fail) {
    if (tid == 0) flag[bt] = 1;
    return;
  }
  // slt's upper-left block holds L11^T; its lower-left block is L21^T.
  for (int e = tid; e < kH * kH; e += kPanelThreads) {
    const int r = e / kH, c = e % kH;
    slt[c * kLs + kH + r] = sd[(kH + r) * kLs + c];
  }
  // This block's reads of the diagonal block are done (they landed in
  // shared memory before the first barrier).  The last block to get here
  // writes L_kk over it and resets the ticket for the next panel launch.
  if (tid == 0) {
    int* ticket = flag + gridDim.y + bt;
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) {
    for (int e = tid; e < kP * kP; e += kPanelThreads) {
      const int r = e / kP, c = e % kP;
      if (r < w && c <= r) L[(size_t)(j0 + r) * nb + j0 + c] = sd[r * kLs + c];
    }
  }
  if (r0 >= nb) return;
  __syncthreads();

  // Panel solve: row tid of the block, y L_kk^T = a.
  if (tid < kP) solve_row(sy + tid * kLs, slt, sinv, kP);
  __syncthreads();
  for (int e = tid; e < kP * kP; e += kPanelThreads) {
    const int r = e / kP, c = e % kP;
    if (r0 + r < nb && c < w) L[(size_t)(r0 + r) * nb + j0 + c] = sy[r * kLs + c];
  }
}

// Trailing update after the panel at j0..j0+w-1: one block per TM x TM tile
// (ti >= tc) of the lower triangle from row t0 = j0 + w on.  The two panel
// slices come in by cp.async while the tile's old values are loaded into
// registers; the product runs on DMMA, warps of TM/2 x TM/2.
template <int TM>
__global__ void __launch_bounds__(kUpdThreads)
    potrf_update_f64(double* __restrict__ out, const int* __restrict__ flag,
                     int nb, int j0, int w, int vec2) {
  constexpr int MI = TM / 32, NI = TM / 16;
  extern __shared__ __align__(16) double smem[];
  double* sa = smem;             // [TM][kLd]: rows r0.., panel columns
  double* sc = smem + TM * kLd;  // [TM][kLd]: rows c0..
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int bt = blockIdx.y;
  if (flag[bt]) return;
  double* L = out + (size_t)bt * nb * nb;
  const int x = blockIdx.x;
  int ti = (int)((sqrt(8.0 * x + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  while (ti * (ti + 1) / 2 > x) --ti;
  const int tc = x - ti * (ti + 1) / 2;
  const int t0 = j0 + w;
  const int r0 = t0 + ti * TM, c0 = t0 + tc * TM;
  const int tid = threadIdx.x;
  dmma::cp_tile<TM, kP, kUpdThreads>(sa, kLd, L + (size_t)r0 * nb + j0, nb,
                                      nb - r0, w, vec2, tid);
  dmma::cp_tile<TM, kP, kUpdThreads>(sc, kLd, L + (size_t)c0 * nb + j0, nb,
                                      nb - c0, w, vec2, tid);
  dmma::cp_async_commit();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * (TM / 2), wn = (warp % 2) * (TM / 2);
  // The tile's old values at this thread's accumulator positions: pairs of
  // neighbours (2t, 2t + 1), read and written as one 16-byte access where
  // both lie in the lower triangle and rows are even.
  double cv[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm + 16 * mi + g + 8 * h;
        const int col = c0 + wn + 8 * ni + 2 * t;
        const double* p = L + (size_t)row * nb + col;
        double x0 = 0.0, x1 = 0.0;
        if (vec2 && row < nb && col + 1 <= row) {
          const double2 v = *reinterpret_cast<const double2*>(p);
          x0 = v.x;
          x1 = v.y;
        } else if (row < nb && col <= row) {
          x0 = p[0];
          if (col + 1 <= row) x1 = p[1];
        }
        cv[mi][ni][2 * h] = x0;
        cv[mi][ni][2 * h + 1] = x1;
      }
  dmma::cp_async_wait<0>();
  __syncthreads();
  double acc[MI][NI][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kP; k0 += 8) {
    if (k0 >= w) break;
    double a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      dmma::load_a_rows(a[mi], sa, kLd, wm + 16 * mi, k0, g, t);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      dmma::load_b_rows(b[ni], sc, kLd, wn + 8 * ni, k0, g, t);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) dmma::mma_16x8x8(acc[mi][ni], a[mi], b[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm + 16 * mi + g + 8 * h;
        const int col = c0 + wn + 8 * ni + 2 * t;
        double* p = L + (size_t)row * nb + col;
        const double x0 = cv[mi][ni][2 * h] - acc[mi][ni][2 * h];
        const double x1 = cv[mi][ni][2 * h + 1] - acc[mi][ni][2 * h + 1];
        if (vec2 && row < nb && col + 1 <= row) {
          *reinterpret_cast<double2*>(p) = make_double2(x0, x1);
        } else if (row < nb && col <= row) {
          p[0] = x0;
          if (col + 1 <= row) p[1] = x1;
        }
      }
}

template <int TM>
int launch_update(double* out, int* flag, int batch, int nb, int j0, int w,
                  int vec2, cudaStream_t stream) {
  constexpr int smem = 2 * TM * kLd * (int)sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      potrf_update_f64<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (nb - j0 - w + TM - 1) / TM;
  return (int)dmma::launch_pdl(potrf_update_f64<TM>,
                               dim3(nt * (nt + 1) / 2, batch), kUpdThreads,
                               smem, stream, out, flag, nb, j0, w, vec2);
}

__global__ void potrf_nan_f64(double* __restrict__ out,
                              const int* __restrict__ flag, int nb) {
  dmma::grid_wait();
  if (!flag[blockIdx.y]) return;
  const size_t nn = (size_t)nb * nb;
  double* L = out + blockIdx.y * nn;
  const double nan = quiet_nan<double>();
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nn;
       e += (size_t)gridDim.x * blockDim.x)
    L[e] = nan;
}

int launch_f64(const double* a, double* out, int* flag, int batch, int nb,
               cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || nb <= 0 ||
      (long long)nb * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      potrf_panel_f64, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmem);
  if (err != cudaSuccess) return (int)err;
  const long long nn = (long long)nb * nb;
  const int fill_blocks = (int)std::min<long long>((nn + 255) / 256, 1024);
  err = dmma::launch_pdl(potrf_copy_f64, dim3(fill_blocks, batch), 256, 0,
                         stream, a, out, nb);
  if (err != cudaSuccess) return (int)err;
  const int sms = dmma::sm_count();
  // 16-byte copies of the panel slices need even rows and an aligned tile
  const int vec2 = nb % 2 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  for (int j0 = 0; j0 < nb; j0 += kP) {
    const int w = std::min(kP, nb - j0);
    const int rows = nb - j0 - w;
    const int row_blocks = std::max(1, (rows + kP - 1) / kP);
    err = dmma::launch_pdl(potrf_panel_f64, dim3(row_blocks, batch),
                           kPanelThreads, kPanelSmem, stream, out, flag, nb, j0,
                           w, vec2);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0) break;
    // 64 x 64 tiles, or 32 x 32 while the 64 x 64 ones fill under two waves
    const int nt = (rows + kP - 1) / kP;
    const int rc = (long long)nt * (nt + 1) / 2 * batch < 2 * sms
                       ? launch_update<32>(out, flag, batch, nb, j0, w, vec2, stream)
                       : launch_update<64>(out, flag, batch, nb, j0, w, vec2, stream);
    if (rc != 0) return rc;
  }
  return (int)dmma::launch_pdl(potrf_nan_f64, dim3(fill_blocks, batch), 256, 0,
                               stream, out, flag, nb);
}

// ---------------------------------------------------------------------------
// fma_f32
// ---------------------------------------------------------------------------

constexpr int kPanel = 32;   // panel width
constexpr int kOut = 64;     // trailing-update output tile edge
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    potrf_fma_kernel(const T* __restrict__ a, T* __restrict__ out, int nb) {
  __shared__ T sd[kPanel][kPanel + 1];   // diagonal block
  __shared__ T si[kPanel][kOut + 1];     // panel rows of an output tile, l-major
  __shared__ T sc[kPanel][kOut + 1];     // panel rows of its column tile
  __shared__ int fail;
  const int nn = nb * nb;  // the wrapper keeps nb * nb below 2^31
  const T* A = a + (size_t)blockIdx.x * nn;
  T* L = out + (size_t)blockIdx.x * nn;
  const int tid = threadIdx.x;

  // Copy the lower triangle; zeros above it.
  for (int e = tid; e < nn; e += kThreads) {
    const int r = e / nb, c = e % nb;
    L[e] = c <= r ? A[e] : T(0);
  }
  if (tid == 0) fail = 0;
  __syncthreads();

  for (int j0 = 0; j0 < nb; j0 += kPanel) {
    const int w = min(kPanel, nb - j0);
    // ---- 1. factor the diagonal block in shared memory.
    for (int e = tid; e < kPanel * kPanel; e += kThreads) {
      const int r = e / kPanel, c = e % kPanel;
      T x;
      if (r < w && c < w)
        x = c <= r ? L[(size_t)(j0 + r) * nb + j0 + c] : T(0);
      else
        x = r == c ? T(1) : T(0);
      sd[r][c] = x;
    }
    __syncthreads();
    for (int c = 0; c < kPanel; ++c) {
      if (tid == 0) {
        const T p = sd[c][c];
        if (!good_pivot(p)) fail = 1;
        sd[c][c] = sqrt(p);
      }
      __syncthreads();
      if (fail) break;
      if (tid > c && tid < kPanel) sd[tid][c] /= sd[c][c];
      __syncthreads();
      for (int e = tid; e < kPanel * kPanel; e += kThreads) {
        const int r = e / kPanel, l = e % kPanel;
        if (l > c && r >= l) sd[r][l] -= sd[r][c] * sd[l][c];
      }
      __syncthreads();
    }
    if (fail) break;
    for (int e = tid; e < kPanel * kPanel; e += kThreads) {
      const int r = e / kPanel, c = e % kPanel;
      if (r < w && c <= r) L[(size_t)(j0 + r) * nb + j0 + c] = sd[r][c];
    }
    const int t0 = j0 + w;  // first trailing row
    if (t0 >= nb) break;

    // ---- 2. panel solve: L[r, j0:j0+w] = A[r, j0:j0+w] L_D^{-T}.  The
    // diagonal block is read through a volatile pointer so that its 528
    // values are not hoisted out of the row loop into (spilled) registers.
    const volatile T* dv = &sd[0][0];
    for (int r = t0 + tid; r < nb; r += kThreads) {
      T* row = L + (size_t)r * nb + j0;
      T x[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) x[c] = c < w ? row[c] : T(0);
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        T s = x[c];
#pragma unroll
        for (int l = 0; l < c; ++l) s -= x[l] * dv[c * (kPanel + 1) + l];
        x[c] = s / dv[c * (kPanel + 1) + c];
      }
#pragma unroll
      for (int c = 0; c < kPanel; ++c)
        if (c < w) row[c] = x[c];
    }
    __syncthreads();

    // ---- 3. trailing update of the lower triangle, 64 x 64 tiles.
    const int nt = (nb - t0 + kOut - 1) / kOut;
    const int tx = tid % 16, ty = tid / 16;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tc = 0; tc <= ti; ++tc) {
        const int r0 = t0 + ti * kOut, c0 = t0 + tc * kOut;
        for (int e = tid; e < kOut * kPanel; e += kThreads) {
          const int q = e / kPanel, l = e % kPanel;  // l runs along a row
          const bool in_l = l < w;
          si[l][q] = (in_l && r0 + q < nb)
                         ? L[(size_t)(r0 + q) * nb + j0 + l] : T(0);
          sc[l][q] = (in_l && c0 + q < nb)
                         ? L[(size_t)(c0 + q) * nb + j0 + l] : T(0);
        }
        __syncthreads();
        T acc[4][4] = {};
        for (int l = 0; l < w; ++l) {
          T ra[4], rb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ra[i] = si[l][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) rb[j] = sc[l][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += ra[i] * rb[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx + 16 * j;
            if (r < nb && c <= r) L[(size_t)r * nb + c] -= acc[i][j];
          }
        }
        __syncthreads();
      }
    }
  }

  __syncthreads();
  if (fail) {
    const T nan = quiet_nan<T>();
    for (int e = tid; e < nn; e += kThreads) L[e] = nan;
  }
}

int launch_f32(const float* a, float* out, int batch, int nb,
               cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || (long long)nb * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  potrf_fma_kernel<float><<<batch, kThreads, 0, stream>>>(a, out, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// a, out (batch, nb, nb), contiguous, row-major, on the device; out may not
// alias a; flag (2 batch,) int32, zeroed by the caller: flag[b] becomes 1
// for a tile that met a bad pivot, flag[batch + b] is tile b's ticket
// counter.  Issues the whole factorization on the stream and
// returns the first non-zero cudaGetLastError() after a launch (0 on
// success).
extern "C" int potrf_f64(const double* a, double* out, int* flag, int batch,
                         int nb, void* stream) {
  return launch_f64(a, out, flag, batch, nb, static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: a, out as above; one launch.
extern "C" int potrf_f32(const float* a, float* out, int batch, int nb,
                         void* stream) {
  return launch_f32(a, out, batch, nb, static_cast<cudaStream_t>(stream));
}
