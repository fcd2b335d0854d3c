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
// Two instances, picked by the dtype, one code templated on it:
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
// fma_f32 (f32): the same launches, the same blocked schedule and the same
// failure handling, in full f32 on the FP32 CUDA cores (no TF32): the panel
// kernel is the f64 one's code in float, its rank-32 update of the second
// half spread over all 256 threads, and the update kernel takes 256
// threads a tile, each owning a 4 x 4 (2 x 2 on 32 x 32 tiles) block of
// outputs, its operands read as float4 along the panel's columns.  It
// replaces the first kernel of this file, one 256-thread block a tile with
// three barriers a column, which left all but one SM idle at B = 1.
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
// The blocked factorization, both instances
// ---------------------------------------------------------------------------

constexpr int kP = 64;              // panel width
constexpr int kH = 32;              // half panel: one warp's factor
constexpr int kPanelThreads = 256;
constexpr int kUpdThreads = 128;    // dmma_f64 update: 4 warps, 2 x 2
constexpr int kFUpdThreads = 256;   // fma_f32 update: 16 x 16 threads
constexpr int kLd = kP + 4;         // update panels' row stride (4 mod 16
                                    // doubles; 16-byte rows of floats)
constexpr int kLs = kP + 2;         // panel kernel's row stride (8-byte pairs)
template <typename T>
constexpr int kPanelSmem = 3 * kP * kLs * (int)sizeof(T);

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }

template <typename T>
__global__ void potrf_copy(const T* __restrict__ a, T* __restrict__ out,
                           int nb) {
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const size_t nn = (size_t)nb * nb;
  const T* A = a + blockIdx.y * nn;
  T* L = out + blockIdx.y * nn;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nn;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / nb), c = (int)(e % nb);
    L[e] = c <= r ? A[e] : T(0);
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
// next is a shuffle, a reciprocal square root and two operations; the
// column's values reach the block's later lanes by shuffles too, and the
// later blocks through sblk.  A bad pivot is checked once a block, off the
// chain.  Sets *fail on a pivot that is not positive and finite.
template <typename T>
__device__ __forceinline__ void factor_half(T* sd, T* slt, T* sblk, T* sinv,
                                            int* fail, int o, int i) {
  T* row = sd + (o + i) * kLs + o;
#pragma unroll 1
  for (int cb = 0; cb < kH; cb += 8) {
    T xb[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) xb[l] = row[cb + l];
    T p = __shfl_sync(0xffffffffu, xb[0], cb);
    bool bad = false;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      bad |= !good_pivot(p);  // p is the same in every lane
      const int pc = cb + c;
      const T rinv = rsqrt_t(p);
      const T lic = i == pc ? p * rinv : (i > pc ? xb[c] * rinv : T(0));
      if (c + 1 < 8)
        p = __shfl_sync(0xffffffffu, xb[(c + 1) % 8] - lic * lic, pc + 1);
      xb[c] = lic;
      sblk[i * 9 + c] = lic;
      if (i == 0) sinv[o + pc] = rinv;
#pragma unroll
      for (int l = c + 1; l < 8; ++l) {
        const T llc = __shfl_sync(0xffffffffu, lic, cb + l);  // L[cb+l][pc]
        if (cb + l <= i) xb[l] -= lic * llc;
      }
    }
    if (bad) {  // NaN has spread past a bad pivot; the tile fails
      if (i == 0) *fail = 1;
      return;
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
      T z[8];
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

// One thread solves its row y (in shared memory, 8-byte aligned in f32,
// 16 in f64) against the first ncol columns of a lower factor whose
// transpose is slt: y <- y L^{-T}, right-looking, in 8-column blocks, the
// values moved in pairs.
template <typename T>
__device__ __forceinline__ void solve_row(T* y, const T* slt, const T* sinv,
                                          int ncol) {
  using P = typename Pair<T>::type;
#pragma unroll 1
  for (int cb = 0; cb < ncol; cb += 8) {
    T yb[8];
#pragma unroll
    for (int l = 0; l < 8; l += 2) {
      const P v = *reinterpret_cast<const P*>(y + cb + l);
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
      *reinterpret_cast<P*>(y + cb + l) = P{yb[l], yb[l + 1]};
#pragma unroll 1
    for (int lb = cb + 8; lb < ncol; lb += 8) {
      T z[8];
#pragma unroll
      for (int l = 0; l < 8; l += 2) {
        const P v = *reinterpret_cast<const P*>(y + lb + l);
        z[l] = v.x;
        z[l + 1] = v.y;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const T* lc = slt + (cb + c) * kLs + lb;
#pragma unroll
        for (int l = 0; l < 8; l += 2) {
          const P v = *reinterpret_cast<const P*>(lc + l);
          z[l] -= yb[c] * v.x;
          z[l + 1] -= yb[c] * v.y;
        }
      }
#pragma unroll
      for (int l = 0; l < 8; l += 2)
        *reinterpret_cast<P*>(y + lb + l) = P{z[l], z[l + 1]};
    }
  }
}

// y[32 + l] -= sum_c y[c] L21[l][c] for l, c < 32, each sum over c in
// order; L21 is rows 32.. of the diagonal block sd.
template <typename T>
__device__ __forceinline__ void subtract_l21(T* y, const T* sd) {
  using P = typename Pair<T>::type;
  T x[kH];
#pragma unroll
  for (int c = 0; c < kH; c += 2) {
    const P v = *reinterpret_cast<const P*>(y + c);
    x[c] = v.x;
    x[c + 1] = v.y;
  }
#pragma unroll 1
  for (int l = 0; l < kH; ++l) {
    const T* lr = sd + (kH + l) * kLs;
    T z = y[kH + l];
#pragma unroll
    for (int c = 0; c < kH; c += 2) {
      const P v = *reinterpret_cast<const P*>(lr + c);
      z -= x[c] * v.x;
      z -= x[c + 1] * v.y;
    }
    y[kH + l] = z;
  }
}

// Copy a 64 x 64 tile (row stride nb in global memory, kLs in shared
// memory), zero-filled past rv rows and cv columns.  With vec: 16-byte
// copies of doubles; floats in 8-byte pairs (kLs floats are 8-byte rows).
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int nb, int rv,
                                      int cv, int vec, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      dmma::cp_tile<kP, kP / 2, kPanelThreads>(
          reinterpret_cast<double*>(dst), kLs / 2,
          reinterpret_cast<const double*>(src), nb / 2, rv, cv / 2, false, tid);
      return;
    }
  }
  dmma::cp_tile<kP, kP, kPanelThreads>(dst, kLs, src, nb, rv, cv,
                                       sizeof(T) == 8 && vec, tid);
}

// Panel step at columns j0..j0+w-1 (w <= 64), the body of the panel kernel
// of both instances.  Every block factors the diagonal block: warp 0 the
// first 32 columns and the rows below them, then the rank-32 update of the
// second half (three warps on DMMA in f64; all threads on the FP32 units in
// f32), then warp 0 the second half while warps 2 and 3 solve the block's
// 64 rows below the panel against the first half.  The last block to
// finish its factor writes L_kk; then threads 0..63 each finish one row
// against the second half.  flag holds the tiles' failure flags, then
// their tickets (2 B ints); sd is the kernel's dynamic shared memory.
template <typename T>
__device__ __forceinline__ void panel_step(T* __restrict__ out,
                                           int* __restrict__ flag, int nb,
                                           int j0, int w, int vec, T* sd) {
  T* sy = sd + kP * kLs;              // [64][kLs]: the block's panel rows
  T* slt = sy + kP * kLs;             // [64][kLs]: slt[c][l] = L_kk[l][c]
  // sd, [64][kLs]: the diagonal block, then L_kk
  __shared__ T sblk[kH * 9];
  __shared__ T sinv[kP];              // 1 / L_kk[c][c]
  __shared__ int fail, last;
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int bt = blockIdx.y;
  if (flag[bt]) return;
  T* L = out + (size_t)bt * nb * nb;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = j0 + w, r0 = t0 + blockIdx.x * kP;

  // Stage the diagonal block and this block's rows (zero past nb and w).
  // Above the diagonal the block holds zeros (the copy launch wrote them,
  // the updates write only the lower triangle), and no step reads there.
  stage(sd, L + (size_t)j0 * nb + j0, nb, w, w, vec, tid);
  if (r0 < nb) stage(sy, L + (size_t)r0 * nb + j0, nb, nb - r0, w, vec, tid);
  dmma::cp_async_commit();
  if (tid == 0) fail = 0;
  dmma::cp_async_wait<0>();
  __syncthreads();

  // The identity past w, then L11 and L21 = A21 L11^{-T} (warp 0, lane i
  // on rows i and 32 + i).
  if (warp == 0) {
    if (lane >= w) sd[lane * kLs + lane] = T(1);
    if (kH + lane >= w) sd[(kH + lane) * kLs + kH + lane] = T(1);
    __syncwarp();
    factor_half(sd, slt, sblk, sinv, &fail, 0, lane);
    __syncwarp();
    if (!fail) solve_row(sd + (kH + lane) * kLs, slt, sinv, kH);
  }
  __syncthreads();
  if (fail) {
    if (tid == 0) flag[bt] = 1;
    return;
  }
  if constexpr (sizeof(T) == 8) {
    // A22 -= L21 L21^T on DMMA: warps 0, 1, 2 take the 16 x 16 quadrants
    // (0, 0), (1, 0), (1, 1) of the lower triangle.
    const int g = lane / 4, t = lane % 4;
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
  } else {
    // A22 -= L21 L21^T on the FP32 units: each thread forms up to four
    // entries of the lower triangle, each a sum over the 32 columns in
    // order.
    for (int e = tid; e < kH * kH; e += kPanelThreads) {
      const int r = e / kH, c = e % kH;
      if (c > r) continue;
      const T* x = sd + (kH + r) * kLs;
      const T* y = sd + (kH + c) * kLs;
      T acc = T(0);
#pragma unroll 8
      for (int l = 0; l < kH; ++l) acc += x[l] * y[l];
      sd[(kH + r) * kLs + kH + c] -= acc;
    }
  }
  __syncthreads();
  // Warp 0 factors the second half; meanwhile warps 2 and 3 solve the
  // block's rows against L11 and subtract their L21 share from the second
  // half (the same sums, in the same order, as one solve against L_kk).
  if (warp == 0) {
    factor_half(sd, slt, sblk, sinv, &fail, kH, lane);
  } else if (warp / 2 == 1 && r0 < nb) {
    T* y = sy + (tid - kP) * kLs;
    solve_row(y, slt, sinv, kH);
    subtract_l21(y, sd);
  }
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

  // Panel solve, the second half: row tid of the block, y2 L22^T = a2 -
  // y1 L21^T.
  if (tid < kP)
    solve_row(sy + tid * kLs + kH, slt + kH * kLs + kH, sinv + kH, kH);
  __syncthreads();
  for (int e = tid; e < kP * kP; e += kPanelThreads) {
    const int r = e / kP, c = e % kP;
    if (r0 + r < nb && c < w) L[(size_t)(r0 + r) * nb + j0 + c] = sy[r * kLs + c];
  }
}

__global__ void __launch_bounds__(kPanelThreads, 1)
    potrf_panel_f64(double* __restrict__ out, int* __restrict__ flag, int nb,
                    int j0, int w, int vec) {
  extern __shared__ __align__(16) double panel_smem[];
  panel_step(out, flag, nb, j0, w, vec, panel_smem);
}

__global__ void __launch_bounds__(kPanelThreads, 1)
    potrf_panel_f32(float* __restrict__ out, int* __restrict__ flag, int nb,
                    int j0, int w, int vec) {
  extern __shared__ __align__(16) float panel_smem_f32[];
  panel_step(out, flag, nb, j0, w, vec, panel_smem_f32);
}

// Lower-triangle tile x of the trailing update -> its tile row and column.
__device__ __forceinline__ void lower_tile(int x, int& ti, int& tc) {
  ti = (int)((sqrt(8.0 * x + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  while (ti * (ti + 1) / 2 > x) --ti;
  tc = x - ti * (ti + 1) / 2;
}

// dmma_f64 trailing update after the panel at j0..j0+w-1: one block per
// TM x TM tile (ti >= tc) of the lower triangle from row t0 = j0 + w on.
// The two panel slices come in by cp.async while the tile's old values are
// loaded into registers; the product runs on DMMA, warps of TM/2 x TM/2.
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
  int ti, tc;
  lower_tile(blockIdx.x, ti, tc);
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

// fma_f32 trailing update, the same tiles as potrf_update_f64 on the FP32
// units in full f32: 256 threads, each owning (TM/16)^2 outputs (rows
// ty + 16 i, columns tx + 16 j) in registers.  Both panel slices land in
// shared memory by cp.async at a row stride of 68 floats, so that a warp's
// 16-byte loads along the panel's columns (4 rows of one slice, 8 of the
// other) meet no bank conflict, while the tile's old values are loaded;
// each output's sum runs over the panel's columns in order.
template <int TM>
__global__ void __launch_bounds__(kFUpdThreads)
    potrf_update_f32(float* __restrict__ out, const int* __restrict__ flag,
                     int nb, int j0, int w, int vec4) {
  constexpr int R = TM / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* sa = fsmem;             // [TM][kLd]: rows r0.., panel columns
  float* sc = fsmem + TM * kLd;  // [TM][kLd]: rows c0..
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int bt = blockIdx.y;
  if (flag[bt]) return;
  float* L = out + (size_t)bt * nb * nb;
  int ti, tc;
  lower_tile(blockIdx.x, ti, tc);
  const int t0 = j0 + w;
  const int r0 = t0 + ti * TM, c0 = t0 + tc * TM;
  const int tid = threadIdx.x;
  dmma::cp_tile<TM, kP, kFUpdThreads>(sa, kLd, L + (size_t)r0 * nb + j0, nb,
                                       nb - r0, w, vec4, tid);
  dmma::cp_tile<TM, kP, kFUpdThreads>(sc, kLd, L + (size_t)c0 * nb + j0, nb,
                                       nb - c0, w, vec4, tid);
  dmma::cp_async_commit();
  // each warp covers 4 rows x 8 columns of the 16 x 16 thread grid
  const int warp = tid / 32, lane = tid % 32;
  const int ty = 4 * (warp / 2) + lane / 8, tx = 8 * (warp % 2) + lane % 8;
  float cv[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = r0 + ty + 16 * i, col = c0 + tx + 16 * j;
      cv[i][j] = row < nb && col <= row ? L[(size_t)row * nb + col] : 0.0f;
    }
  dmma::cp_async_wait<0>();
  __syncthreads();
  float acc[R][R] = {};
  const int kw = (w + 3) & ~3;  // the slices are zero past w
#pragma unroll 4
  for (int kk = 0; kk < kw; kk += 4) {
    float4 xa[R], yb[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      xa[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * kLd + kk);
#pragma unroll
    for (int j = 0; j < R; ++j)
      yb[j] = *reinterpret_cast<const float4*>(sc + (tx + 16 * j) * kLd + kk);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(xa[i].x, yb[j].x, acc[i][j]);
        acc[i][j] = fmaf(xa[i].y, yb[j].y, acc[i][j]);
        acc[i][j] = fmaf(xa[i].z, yb[j].z, acc[i][j]);
        acc[i][j] = fmaf(xa[i].w, yb[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = r0 + ty + 16 * i, col = c0 + tx + 16 * j;
      if (row < nb && col <= row) L[(size_t)row * nb + col] = cv[i][j] - acc[i][j];
    }
}

template <typename T, int TM>
int launch_update(T* out, int* flag, int batch, int nb, int j0, int w,
                  int vec, cudaStream_t stream) {
  constexpr bool f64 = sizeof(T) == 8;
  constexpr int smem = 2 * TM * kLd * (int)sizeof(T);
  constexpr int threads = f64 ? kUpdThreads : kFUpdThreads;
  void (*kernel)(T*, const int*, int, int, int, int);
  if constexpr (f64)
    kernel = potrf_update_f64<TM>;
  else
    kernel = potrf_update_f32<TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (nb - j0 - w + TM - 1) / TM;
  return (int)dmma::launch_pdl(kernel, dim3(nt * (nt + 1) / 2, batch), threads,
                               smem, stream, out, flag, nb, j0, w, vec);
}

template <typename T>
__global__ void potrf_nan(T* __restrict__ out, const int* __restrict__ flag,
                          int nb) {
  dmma::grid_wait();
  if (!flag[blockIdx.y]) return;
  const size_t nn = (size_t)nb * nb;
  T* L = out + blockIdx.y * nn;
  const T nan = quiet_nan<T>();
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nn;
       e += (size_t)gridDim.x * blockDim.x)
    L[e] = nan;
}

template <typename T>
int launch(const T* a, T* out, int* flag, int batch, int nb,
           cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || nb <= 0 ||
      (long long)nb * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  constexpr bool f64 = sizeof(T) == 8;
  void (*panel)(T*, int*, int, int, int, int);
  if constexpr (f64)
    panel = potrf_panel_f64;
  else
    panel = potrf_panel_f32;
  cudaError_t err = cudaFuncSetAttribute(
      panel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmem<T>);
  if (err != cudaSuccess) return (int)err;
  const long long nn = (long long)nb * nb;
  const int fill_blocks = (int)std::min<long long>((nn + 255) / 256, 1024);
  err = dmma::launch_pdl(potrf_copy<T>, dim3(fill_blocks, batch), 256, 0,
                         stream, a, out, nb);
  if (err != cudaSuccess) return (int)err;
  const int sms = dmma::sm_count();
  // 16-byte copies of the panel slices need rows of whole 16-byte chunks
  // and an aligned tile; the panel kernel's f32 rows (kLs floats) are only
  // 8-byte aligned, so it copies floats in pairs (even nb)
  constexpr int per16 = 16 / (int)sizeof(T);
  const auto aligned = reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int vec = nb % per16 == 0 && aligned;
  const int vec_panel = f64 ? vec : nb % 2 == 0 && aligned;
  for (int j0 = 0; j0 < nb; j0 += kP) {
    const int w = std::min(kP, nb - j0);
    const int rows = nb - j0 - w;
    const int row_blocks = std::max(1, (rows + kP - 1) / kP);
    err = dmma::launch_pdl(panel, dim3(row_blocks, batch), kPanelThreads,
                           kPanelSmem<T>, stream, out, flag, nb, j0, w,
                           vec_panel);
    if (err != cudaSuccess) return (int)err;
    if (rows == 0) break;
    // 64 x 64 tiles, or 32 x 32 while the 64 x 64 ones fill under two waves
    const int nt = (rows + kP - 1) / kP;
    const int rc =
        (long long)nt * (nt + 1) / 2 * batch < 2 * sms
            ? launch_update<T, 32>(out, flag, batch, nb, j0, w, vec, stream)
            : launch_update<T, 64>(out, flag, batch, nb, j0, w, vec, stream);
    if (rc != 0) return rc;
  }
  return (int)dmma::launch_pdl(potrf_nan<T>, dim3(fill_blocks, batch), 256, 0,
                               stream, out, flag, nb);
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
  return launch(a, out, flag, batch, nb, static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: the same operands and launches in float32.
extern "C" int potrf_f32(const float* a, float* out, int* flag, int batch,
                         int nb, void* stream) {
  return launch(a, out, flag, batch, nb, static_cast<cudaStream_t>(stream));
}
