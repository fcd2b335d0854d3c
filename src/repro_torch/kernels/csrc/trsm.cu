// TRSM: batched left lower triangular solve,
//
//   out[b] = L[b]^{-1} B[b]   (left side, lower, not transposed),
//
// with L of shape (B, nb, nb) -- or (1, nb, nb), one factor broadcast over
// the batch -- and B, out of shape (B, nb, r).  Replaces the Pallas TPU
// kernel src/repro/kernels/chol_tiles.py::trsm (body _trsm_kernel).  On the
// TLR Cholesky path it is the panel TRSM on V (one L_kk broadcast over the
// live rows of the panel column) and the forward sweep L alpha = z, one tile
// at a time, with one right-hand side for alpha and B * p for a prediction
// batch; on the exact path the panel solve (r = the rows below the panel)
// and the forward sweep.  Only the lower triangle of L is read.  Any
// nb >= 1 and r >= 1 work.
//
// Bound on the card: nb^2 r / 2 FMAs against (nb (nb + 1) / 2 + 2 nb r)
// itemsize bytes per tile; at the panel TRSM (nb = 512, r = 63 x 128, f64) the operations
// bound it (2.1 GFLOP, 32 us at 67 TFLOP/s), at r = 1 the bytes.
//
// Two instances, picked by the dtype:
//
// dmma_f64 (f64): blocked forward substitution whose products all run on
// the FP64 tensor cores (mma.sync m16n8k8, dmma.cuh).  The C entry point
// issues every launch on the caller's stream, each a programmatic dependent
// launch, with no host sync:
//   inv     once a launch, the 64 x 64 diagonal blocks of L inverted into
//           scratch (D_j = L_jj^{-1}; a ragged last block is padded with
//           the identity) by substitution in f64, a thread a column.
//           With L broadcast every block of the solve then reads the same
//           few D_j.  Inverting 64 x 64 blocks (not L) keeps the solve's
//           accuracy: on the main configuration's Matérn L_kk it agrees
//           with solve_triangular to well inside CHOL_TOL (chip_smoke.py
//           checks it).
//   strip   one 256-thread block per (tile, SC right-hand-side columns),
//           SC in {64, 32, 16, 8} (the wrapper's trsm_plan narrows it while
//           the grid would leave half the SMs idle: r = 1 and 1024 get more
//           blocks).  It walks the 64-row block rows i of a super-block of
//           at most 512 rows: R = B_i - L_i,0:i X_0:i, the product fed by a
//           cp.async ring of k-slabs of L and of the X rows it already
//           wrote (read back from L2), then X_i = D_i R, a 64 x 64 x SC
//           DMMA product, written out.  Narrow strips take 64-wide slabs
//           (fewer waits on their serial chain), SC = 32 16-wide ones so
//           that two blocks fit on an SM, SC = 64 four stages of 32-wide
//           ones.  (Keeping X in shared memory instead of reading it back
//           was not faster.)
//   rows    where 8-column strips, given a cluster each, would fill at
//           most half the SMs (r = 1: alpha), the strip's rows are split
//           instead: a cluster of one 128-thread block per 64-row block
//           row, each streaming only its own rows of L into a ring at
//           once; X_s goes from block s to the later blocks through
//           distributed shared memory, one cluster barrier a block row
//           (trsm_rows_f64 below).  One block streaming all of L through
//           one SM was what bounded the forward sweep's solves; with more
//           clusters than that, their barrier chains lose to one block a
//           strip (scripts/trsm_split.py times both).
//   update  for nb > 512 the rows are spread over the card: after each
//           super-block's strip launch, B_2 -= L_21 X_1 for every later row
//           as a DMMA GEMM of 128 x 128 (or 64 x 64) tiles, k = 512, so the
//           serial chain is the 64-row steps of one super-block at a time
//           and the O(nb^2 r) work runs over all SMs.
// Each strip block streams all of L_kk's lower half through L2, so the
// panel TRSM is bound by L2 traffic (2 x 917 KB a strip of 64 columns),
// not by the tensor cores.  The product inside each kernel is its own DMMA
// code, not a library call.
//
// fma_f32 (f32): the first kernel of this file, on the FP32 CUDA cores.  A
// block owns `rc` (<= 32) columns of one tile's right-hand side; those
// columns, nb x rc, live in dynamic shared memory for the whole solve (the
// wrapper's trsm_cols halves rc until nb x rc fits).  L streams from global
// memory (L2) in 32 x 32 blocks.  For each block row i0 of 32 rows:
//   1. X[i0:i0+32] -= L[i0:i0+32, 0:i0] X[0:i0], a small GEMM whose L blocks
//      are staged in shared memory; each thread owns up to 4 outputs;
//   2. the 32 x 32 diagonal block of L goes to shared memory (a ragged last
//      block is padded with the identity) and each of the first rc threads
//      forward-substitutes its own column with the 32 values in registers.
// Sums run in the input type (the Pallas kernel's promote_types(dtype,
// f32)).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// dmma_f64
// ---------------------------------------------------------------------------

constexpr int kB = 64;          // diagonal block (block-row height)
constexpr int kBB = kB * kB;    // doubles of one inverted diagonal block
constexpr int kDThreads = 256;  // 8 warps
constexpr int kLdD = kB + 4;    // staged D_j [kB][kB]

// D_j = L_jj^{-1} for the diagonal block j = blockIdx.x of tile blockIdx.y,
// row-major into dinv[(tile * nblk + j) * kBB].  All 256 threads stage the
// block (16 loads each in flight); then thread c < 64 solves column c in
// registers: x <- e_c; for each column jj: x[jj] *= 1 / L[jj][jj], then
// x[i] -= L[i][jj] x[jj] below it.  (Four lanes a column with shuffles, or
// the jj loop left rolled, were not faster on the card.)
__global__ void __launch_bounds__(kDThreads)
    trsm_inv_f64(const double* __restrict__ lo, double* __restrict__ dinv,
                 int nb, int nblk) {
  __shared__ double sl[kB][kB + 1];
  __shared__ double sinv[kB];
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int j0 = blockIdx.x * kB, w = min(kB, nb - j0);
  const double* L = lo + (size_t)blockIdx.y * nb * nb;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kBB / kDThreads; ++q) {
    const int e = tid + q * kDThreads, i = e / kB, jj = e % kB;
    double x;
    if (i < w && jj < w)
      x = jj <= i ? L[(size_t)(j0 + i) * nb + j0 + jj] : 0.0;
    else
      x = i == jj ? 1.0 : 0.0;
    sl[i][jj] = x;
  }
  __syncthreads();
  if (tid < kB) sinv[tid] = 1.0 / sl[tid][tid];
  __syncthreads();
  if (tid >= kB) return;
  const int c = tid;
  double x[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) x[i] = i == c ? 1.0 : 0.0;
#pragma unroll
  for (int jj = 0; jj < kB; ++jj) {
    x[jj] *= sinv[jj];
#pragma unroll
    for (int i = jj + 1; i < kB; ++i) x[i] -= sl[i][jj] * x[jj];
  }
  double* D = dinv + ((size_t)blockIdx.y * nblk + blockIdx.x) * kBB;
#pragma unroll
  for (int i = 0; i < kB; ++i) D[i * kB + c] = x[i];
}

// The strip kernel's layout for SC columns: WN x WM warps of (kB / WM) x
// (SC / WN) (at SC = 8 four of the eight warps only copy), k-slabs of KS
// in a ring of STAGES.  The narrow strips take long slabs (few, large
// copies on their serial chain); SC = 32 takes short ones so that two
// blocks fit on an SM; SC = 64 fills its SM's shared memory with four
// stages of 32-wide slabs.
template <int SC>
struct Strip {
  static constexpr int WN = SC / 8 < 4 ? SC / 8 : 4;
  static constexpr int WM = 8 / WN < 4 ? 8 / WN : 4;
  static constexpr int MI = kB / WM / 16, NI = SC / WN / 8;
  static constexpr int KS = SC <= 16 ? 64 : (SC == 32 ? 16 : 32);
  static constexpr int STAGES = SC == 64 ? 4 : 3;
  static constexpr int BLOCKS_PER_SM = SC == 32 ? 2 : 1;
  static constexpr int LDL = KS + 4;  // staged L slab [kB][KS]
  static constexpr int LDX = SC + 4;  // staged X slab [KS][SC], R [kB][SC]
  static constexpr int STAGE = kB * LDL + KS * LDX;
  static constexpr int SMEM =
      (STAGES * STAGE + kB * LDX + kB * kLdD) * (int)sizeof(double);
};

// Rows [R0, R1) of X = L^{-1} src for the SC columns of block x of tile
// blockIdx.y; src's rows [R0, R1) already hold B minus the products with
// the rows above R0.  X's rows [R0, i0) are read back from out.
template <int SC>
__global__ void __launch_bounds__(kDThreads, Strip<SC>::BLOCKS_PER_SM)
    trsm_strip_f64(const double* __restrict__ lo,
                   const double* __restrict__ dinv, const double* src,
                   double* out, int nb, int r, int R0, int R1,
                   long long lo_stride, long long dinv_stride, int vec_l,
                   int vec_x) {
  using P = Strip<SC>;
  constexpr int MI = P::MI, NI = P::NI, KS = P::KS, LDL = P::LDL, LDX = P::LDX;
  extern __shared__ __align__(16) double smem[];
  double* ring = smem;
  double* sr = ring + P::STAGES * P::STAGE;  // [kB][LDX]: B_i, then R
  double* sd = sr + kB * LDX;                // [kB][kLdD]: D_i
  const int c0 = blockIdx.x * SC;
  const double* L = lo + blockIdx.y * lo_stride;
  const double* Bs = src + (size_t)blockIdx.y * nb * r;
  double* X = out + (size_t)blockIdx.y * nb * r;
  const double* Dt = dinv + blockIdx.y * dinv_stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool active = warp < P::WM * P::WN;
  const int wm = (warp / P::WN) * (kB / P::WM), wn = (warp % P::WN) * (SC / P::WN);
  dmma::grid_wait();
  dmma::grid_launch_dependents();

#pragma unroll 1
  for (int i0 = R0; i0 < R1; i0 += kB) {
    const int h = min(kB, nb - i0);
    // D_i and B_i, one commit group ahead of the ring's slabs.
    dmma::cp_tile<kB, kB, kDThreads>(sd, kLdD, Dt + (size_t)(i0 / kB) * kBB, kB,
                                     kB, kB, true, tid);
    dmma::cp_tile<kB, SC, kDThreads>(sr, LDX, Bs + (size_t)i0 * r + c0, r, h,
                                     r - c0, vec_x, tid);
    dmma::cp_async_commit();
    double acc[MI][NI][4] = {};
    auto load = [&](int st, int q) {
      double* sl = ring + st * P::STAGE;
      const int k0 = R0 + q * KS;
      dmma::cp_tile<kB, KS, kDThreads>(sl, LDL, L + (size_t)i0 * nb + k0, nb, h,
                                       KS, vec_l, tid);
      dmma::cp_tile<KS, SC, kDThreads>(sl + kB * LDL, LDX,
                                       X + (size_t)k0 * r + c0, r, KS, r - c0,
                                       vec_x, tid);
    };
    auto compute = [&](int st, int) {
      const double* sl = ring + st * P::STAGE;
      if (active)
        dmma::mma_slab<MI, NI, false, true>(acc, sl, LDL, sl + kB * LDL, LDX,
                                            KS, wm, wn, g, t);
    };
    dmma::cp_async_ring<P::STAGES>((i0 - R0) / KS, load, compute);
    // R = B_i - L_i,R0:i X_R0:i, in place in sr.
    if (active) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int rl = wm + 16 * mi + g + 8 * (v / 2);
            const int cl = wn + 8 * ni + 2 * t + v % 2;
            sr[rl * LDX + cl] -= acc[mi][ni][v];
          }
    }
    __syncthreads();
    // X_i = D_i R, written out (rows < h, columns < r).
    if (active) {
      double x[MI][NI][4] = {};
      dmma::mma_slab<MI, NI, false, true>(x, sd, kLdD, sr, LDX, kB, wm, wn, g, t);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wm + 16 * mi + g + 8 * hh;
          if (rl >= h) continue;
          double* row = X + (size_t)(i0 + rl) * r;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int col = c0 + wn + 8 * ni + 2 * t;
            dmma::store_pair(row, col, r, vec_x, x[mi][ni][2 * hh],
                             x[mi][ni][2 * hh + 1]);
          }
        }
    }
    // X_i is visible to the block's next slab copies, and sd, sr are free.
    __syncthreads();
  }
}

// The row split of an 8-column strip, for grids of a few strips (r = 1:
// alpha).  A cluster of nbr <= 8 blocks a (strip,
// tile), block q of the cluster owning block row q of the super-block: it
// stages D_q and B_q and starts streaming its slabs L_q,s (s < q) into a
// ring at once, so the loads of all the rows run on nbr SMs together; then
// in step s block s forms X_s = D_s (B_s - sum_{j<s} L_s,j X_j), writes it
// out and pushes it into the shared memory of every later block of the
// cluster, the cluster's barrier publishes it, and every block q > s adds
// L_q,s X_s.  The chain is one 64 x 64 x 8 product and one barrier a block
// row, and each block reads only its own rows of L.  X_s lands in buffer
// s % 2 of the later blocks: block s + 2 writes that buffer again only
// after the barrier that every block passes once its reads of X_s are done.
constexpr int kRCols = 8;
constexpr int kRThreads = 128;  // 4 warps of 16 rows x 8 columns
constexpr int kRStages = 3;
constexpr int kRLdL = kB + 4;      // staged L_q,s [kB][kB]
constexpr int kRLdX = kRCols + 4;  // B_q, then R [kB][8]; X_s [2][kB][8]
constexpr int kRSmem =
    (kRStages * kB * kRLdL + kB * kLdD + 3 * kB * kRLdX) * (int)sizeof(double);

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same address in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_map(const double* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ void cluster_store(unsigned addr, double x) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(x)
               : "memory");
}

// Rows [R0, R1) of X = L^{-1} src for the 8 columns of strip blockIdx.x /
// nbr of tile blockIdx.y, launched in clusters of nbr = ceil((R1 - R0) /
// 64) blocks along x; src's rows [R0, R1) already hold B minus the
// products with the rows above R0.
__global__ void __launch_bounds__(kRThreads, 1)
    trsm_rows_f64(const double* __restrict__ lo,
                  const double* __restrict__ dinv, const double* src,
                  double* out, int nb, int r, int R0, int R1,
                  long long lo_stride, long long dinv_stride, int vec_l,
                  int vec_x) {
  extern __shared__ __align__(16) double smem[];
  double* ring = smem;
  double* sd = ring + kRStages * kB * kRLdL;  // [kB][kLdD]: D_q
  double* sr = sd + kB * kLdD;                // [kB][kRLdX]: B_q, then R
  double* sx = sr + kB * kRLdX;               // [2][kB][kRLdX]: X_s
  const int nbr = (R1 - R0 + kB - 1) / kB;
  const int q = blockIdx.x % nbr, c0 = (blockIdx.x / nbr) * kRCols;
  const int i0 = R0 + q * kB, h = min(kB, nb - i0);
  const double* L = lo + blockIdx.y * lo_stride;
  const double* Bs = src + (size_t)blockIdx.y * nb * r;
  double* X = out + (size_t)blockIdx.y * nb * r;
  const double* Dt = dinv + blockIdx.y * dinv_stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wm = warp * 16;
  // No block writes into another's shared memory before all have started.
  cluster_arrive_relaxed();
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  dmma::cp_tile<kB, kB, kRThreads>(sd, kLdD, Dt + (size_t)(i0 / kB) * kBB, kB,
                                   kB, kB, true, tid);
  dmma::cp_tile<kB, kRCols, kRThreads>(sr, kRLdX, Bs + (size_t)i0 * r + c0, r,
                                       h, r - c0, vec_x, tid);
  dmma::cp_async_commit();
  // One commit group a slab (empty past q), as in dmma::cp_async_ring: the
  // wait for kRStages - 1 younger groups in step s waits for slab s.
  auto load = [&](int s) {
    dmma::cp_tile<kB, kB, kRThreads>(ring + (s % kRStages) * kB * kRLdL, kRLdL,
                                     L + (size_t)i0 * nb + R0 + s * kB, nb, h,
                                     kB, vec_l, tid);
  };
#pragma unroll
  for (int s = 0; s < kRStages; ++s) {
    if (s < q) load(s);
    dmma::cp_async_commit();
  }
  double acc[1][1][4] = {};
  cluster_wait();
#pragma unroll 1
  for (int s = 0; s < nbr; ++s) {
    dmma::cp_async_wait<kRStages - 1>();
    __syncthreads();
    double* xs = sx + (s % 2) * kB * kRLdX;
    if (s == q) {
      // R = B_q - sum_{j<q} L_q,j X_j, in place in sr; then X_q = D_q R.
#pragma unroll
      for (int v = 0; v < 4; ++v)
        sr[(wm + g + 8 * (v / 2)) * kRLdX + 2 * t + v % 2] -= acc[0][0][v];
      __syncthreads();
      double x[1][1][4] = {};
      dmma::mma_slab<1, 1, false, true>(x, sd, kLdD, sr, kRLdX, kB, wm, 0, g,
                                        t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = wm + g + 8 * hh;
        for (int dst = q + 1; dst < nbr; ++dst) {
          const unsigned a = cluster_map(xs + rl * kRLdX + 2 * t, dst);
          cluster_store(a, x[0][0][2 * hh]);
          cluster_store(a + 8, x[0][0][2 * hh + 1]);
        }
      }
      // X_q is published by the barrier; its global stores wait on nothing.
      cluster_arrive();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = wm + g + 8 * hh;
        if (rl < h)
          dmma::store_pair(X + (size_t)(i0 + rl) * r, c0 + 2 * t, r, vec_x,
                           x[0][0][2 * hh], x[0][0][2 * hh + 1]);
      }
    } else {
      cluster_arrive();
    }
    cluster_wait();
    if (q > s) {
      dmma::mma_slab<1, 1, false, true>(acc, ring + (s % kRStages) * kB * kRLdL,
                                        kRLdL, xs, kRLdX, kB, wm, 0, g, t);
      __syncthreads();  // every warp is done with the stage before its refill
      if (s + kRStages < q) load(s + kRStages);
    }
    dmma::cp_async_commit();
  }
}

template <int TM>
struct Update {
  static constexpr int MI = TM / 32, NI = TM / 32;  // warps of (TM/2) x (TM/4)
  static constexpr int KS = 32, STAGES = 3;
  static constexpr int LDL = KS + 4;  // staged L slab [TM][KS]
  static constexpr int LDX = TM + 4;  // staged X slab [KS][TM]
  static constexpr int STAGE = TM * LDL + KS * LDX;
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(double);
};

// out[R1:, :] = src[R1:, :] - L[R1:, R0:R1] X[R0:R1, :], one TM x TM tile a
// block; the tiles are walked down the rows first, so the blocks on the
// card at one time share a column panel of X.
template <int TM>
__global__ void __launch_bounds__(kDThreads, 1)
    trsm_update_f64(const double* __restrict__ lo, const double* src,
                    double* out, int nb, int r, int R0, int R1,
                    long long lo_stride, int vec_l, int vec_x) {
  using P = Update<TM>;
  constexpr int MI = P::MI, NI = P::NI, KS = P::KS, LDL = P::LDL, LDX = P::LDX;
  extern __shared__ __align__(16) double smem[];
  const int nr = (nb - R1 + TM - 1) / TM;
  const int r0 = R1 + (blockIdx.x % nr) * TM, c0 = (blockIdx.x / nr) * TM;
  const double* L = lo + blockIdx.y * lo_stride;
  const double* S = src + (size_t)blockIdx.y * nb * r;
  double* X = out + (size_t)blockIdx.y * nb * r;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * (TM / 2), wn = (warp % 4) * (TM / 4);
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  double acc[MI][NI][4] = {};
  auto load = [&](int st, int q) {
    double* sa = smem + st * P::STAGE;
    const int k0 = R0 + q * KS;
    dmma::cp_tile<TM, KS, kDThreads>(sa, LDL, L + (size_t)r0 * nb + k0, nb,
                                     nb - r0, KS, vec_l, tid);
    dmma::cp_tile<KS, TM, kDThreads>(sa + TM * LDL, LDX,
                                     X + (size_t)k0 * r + c0, r, KS, r - c0,
                                     vec_x, tid);
  };
  auto compute = [&](int st, int) {
    const double* sa = smem + st * P::STAGE;
    dmma::mma_slab<MI, NI, false, true>(acc, sa, LDL, sa + TM * LDL, LDX, KS,
                                        wm, wn, g, t);
  };
  dmma::cp_async_ring<P::STAGES>((R1 - R0) / KS, load, compute);
  // out = src - acc; a thread reads only the pairs it writes, so the pairs
  // of one row fragment are loaded together (src may be out itself).
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    double2 sv[2][NI];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = r0 + wm + 16 * mi + g + 8 * hh;
        const int col = c0 + wn + 8 * ni + 2 * t;
        sv[hh][ni] = row < nb ? dmma::load_pair(S + (size_t)row * r, col, r, vec_x)
                              : make_double2(0.0, 0.0);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = r0 + wm + 16 * mi + g + 8 * hh;
        const int col = c0 + wn + 8 * ni + 2 * t;
        if (row < nb)
          dmma::store_pair(X + (size_t)row * r, col, r, vec_x,
                           sv[hh][ni].x - acc[mi][ni][2 * hh],
                           sv[hh][ni].y - acc[mi][ni][2 * hh + 1]);
      }
  }
}

template <int SC>
cudaError_t launch_strip(const double* lo, const double* dinv, const double* src,
                         double* out, int batch, int nb, int r, int R0, int R1,
                         long long lo_stride, long long dinv_stride, int vec_l,
                         int vec_x, cudaStream_t stream) {
  constexpr int smem = Strip<SC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      trsm_strip_f64<SC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return dmma::launch_pdl(trsm_strip_f64<SC>, dim3((r + SC - 1) / SC, batch),
                          kDThreads, smem, stream, lo, dinv, src, out, nb, r,
                          R0, R1, lo_stride, dinv_stride, vec_l, vec_x);
}

cudaError_t launch_rows(const double* lo, const double* dinv, const double* src,
                        double* out, int batch, int nb, int r, int R0, int R1,
                        long long lo_stride, long long dinv_stride, int vec_l,
                        int vec_x, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trsm_rows_f64, cudaFuncAttributeMaxDynamicSharedMemorySize, kRSmem);
  if (err != cudaSuccess) return err;
  const unsigned nbr = (R1 - R0 + kB - 1) / kB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((r + kRCols - 1) / kRCols) * nbr, batch);
  cfg.blockDim = dim3(kRThreads);
  cfg.dynamicSmemBytes = kRSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nbr;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, trsm_rows_f64, lo, dinv, src, out, nb, r, R0,
                            R1, lo_stride, dinv_stride, vec_l, vec_x);
}

template <int TM>
cudaError_t launch_update(const double* lo, const double* src, double* out,
                          int batch, int nb, int r, int R0, int R1,
                          long long lo_stride, int vec_l, int vec_x,
                          cudaStream_t stream) {
  constexpr int smem = Update<TM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      trsm_update_f64<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((nb - R1 + TM - 1) / TM) * ((r + TM - 1) / TM);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  return dmma::launch_pdl(trsm_update_f64<TM>, dim3((unsigned)tiles, batch),
                          kDThreads, smem, stream, lo, src, out, nb, r, R0, R1,
                          lo_stride, vec_l, vec_x);
}

int launch_f64(const double* lo, const double* b, double* out, double* dinv,
               int batch, int nb, int r, int lo_batch, int sc, int super_rows,
               int update_tile, int split, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || nb <= 0 || r <= 0)
    return (int)cudaErrorInvalidValue;
  if (lo_batch != 1 && lo_batch != batch) return (int)cudaErrorInvalidValue;
  if (super_rows <= 0 || super_rows % kB != 0) return (int)cudaErrorInvalidValue;
  // a split strip is a cluster of one block a block row: at most 8
  if (split && (sc != kRCols || super_rows > 8 * kB))
    return (int)cudaErrorInvalidValue;
  if (super_rows < nb && update_tile != 64 && update_tile != 128)
    return (int)cudaErrorInvalidValue;
  const int nblk = (nb + kB - 1) / kB;
  const long long lo_stride = lo_batch == 1 ? 0LL : (long long)nb * nb;
  const long long dinv_stride = lo_batch == 1 ? 0LL : (long long)nblk * kBB;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int vec_l = nb % 2 == 0 && aligned(lo);
  const int vec_x = r % 2 == 0 && aligned(b) && aligned(out);
  cudaError_t err = dmma::launch_pdl(trsm_inv_f64, dim3(nblk, lo_batch),
                                     kDThreads, 0, stream, lo, dinv, nb, nblk);
  if (err != cudaSuccess) return (int)err;
  for (int R0 = 0; R0 < nb; R0 += super_rows) {
    const int R1 = std::min(nb, R0 + super_rows);
    const double* src = R0 == 0 ? b : out;
    switch (split ? 0 : sc) {
      case 0: err = launch_rows(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 64: err = launch_strip<64>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 32: err = launch_strip<32>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 16: err = launch_strip<16>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 8: err = launch_strip<8>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    if (R1 == nb) break;
    err = update_tile == 128
              ? launch_update<128>(lo, src, out, batch, nb, r, R0, R1, lo_stride, vec_l, vec_x, stream)
              : launch_update<64>(lo, src, out, batch, nb, r, R0, R1, lo_stride, vec_l, vec_x, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fma_f32
// ---------------------------------------------------------------------------

constexpr int kRows = 32;    // block-row height
constexpr int kMaxCols = 32;  // right-hand-side columns of one block
constexpr int kThreads = 256;
constexpr int kPerThread = kRows * kMaxCols / kThreads;  // outputs of step 1

template <typename T>
__global__ void __launch_bounds__(kThreads)
    trsm_kernel(const T* __restrict__ lo, const T* __restrict__ b,
                T* __restrict__ out, int nb, int r, int rc,
                long long lo_stride) {
  extern __shared__ unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);  // [nb][rc]
  __shared__ T sl[kRows][kRows + 1];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * rc;
  const int cols = min(rc, r - c0);
  const T* L = lo + (size_t)blockIdx.y * lo_stride;
  const T* Bm = b + (size_t)blockIdx.y * nb * r;
  T* O = out + (size_t)blockIdx.y * nb * r;

  for (int e = tid; e < nb * rc; e += kThreads) {
    const int i = e / rc, c = e % rc;
    X[e] = c < cols ? Bm[(size_t)i * r + c0 + c] : T(0);
  }
  __syncthreads();

  const int n_out = kRows * rc;
  for (int i0 = 0; i0 < nb; i0 += kRows) {
    const int w = min(kRows, nb - i0);
    // ---- 1. X[i0:i0+w] -= L[i0:i0+w, 0:i0] X[0:i0].
    T acc[kPerThread] = {};
    for (int j0 = 0; j0 < i0; j0 += kRows) {
      for (int e = tid; e < kRows * kRows; e += kThreads) {
        const int ii = e / kRows, jj = e % kRows;  // jj runs along a row of L
        sl[ii][jj] = ii < w ? L[(size_t)(i0 + ii) * nb + j0 + jj] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int e = tid + q * kThreads;
        if (e < n_out) {
          const int ii = e / rc, c = e % rc;
          const T* xc = X + (size_t)j0 * rc + c;
          T s = acc[q];
#pragma unroll 8
          for (int jj = 0; jj < kRows; ++jj) s += sl[ii][jj] * xc[jj * rc];
          acc[q] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = tid + q * kThreads;
      if (e < n_out) {
        const int ii = e / rc, c = e % rc;
        if (ii < w) X[(size_t)(i0 + ii) * rc + c] -= acc[q];
      }
    }
    // ---- 2. solve the diagonal block, one column per thread.
    for (int e = tid; e < kRows * kRows; e += kThreads) {
      const int ii = e / kRows, jj = e % kRows;
      T x;
      if (ii < w && jj < w)
        x = jj <= ii ? L[(size_t)(i0 + ii) * nb + i0 + jj] : T(0);
      else
        x = ii == jj ? T(1) : T(0);
      sl[ii][jj] = x;
    }
    __syncthreads();
    if (tid < rc) {
      T x[kRows];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
        x[ii] = ii < w ? X[(size_t)(i0 + ii) * rc + tid] : T(0);
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        T s = x[ii];
#pragma unroll
        for (int jj = 0; jj < ii; ++jj) s -= sl[ii][jj] * x[jj];
        x[ii] = s / sl[ii][ii];
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
        if (ii < w) X[(size_t)(i0 + ii) * rc + tid] = x[ii];
    }
    __syncthreads();
  }

  for (int e = tid; e < nb * rc; e += kThreads) {
    const int i = e / rc, c = e % rc;
    if (c < cols) O[(size_t)i * r + c0 + c] = X[e];
  }
}

template <typename T>
int launch(const T* lo, const T* b, T* out, int batch, int nb, int r, int rc,
           int lo_batch, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || r <= 0 || rc <= 0 || rc > kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (lo_batch != 1 && lo_batch != batch) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)nb * rc * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      trsm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long lo_stride = lo_batch == 1 ? 0LL : (long long)nb * nb;
  const dim3 grid((r + rc - 1) / rc, batch);
  trsm_kernel<T><<<grid, kThreads, smem, stream>>>(lo, b, out, nb, r, rc,
                                                   lo_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// lo (lo_batch, nb, nb) with lo_batch 1 (broadcast) or batch; b, out
// (batch, nb, r); all contiguous, row-major, on the device; out may not
// alias b.  dinv is scratch of lo_batch * ceil(nb / 64) * 64 * 64 doubles.
// sc (64, 32, 16 or 8) is the right-hand-side columns of one strip block,
// super_rows (a multiple of 64) the rows one strip launch solves,
// update_tile (128 or 64) the tile edge of the updates between them, and
// split (0 or 1; 1 needs sc 8 and super_rows <= 512) splits each strip's
// rows over a cluster of blocks.
// Issues every launch on the stream and returns the first non-zero
// cudaGetLastError() after a launch (0 on success).
extern "C" int trsm_f64(const double* lo, const double* b, double* out,
                        double* dinv, int batch, int nb, int r, int lo_batch,
                        int sc, int super_rows, int update_tile, int split,
                        void* stream) {
  return launch_f64(lo, b, out, dinv, batch, nb, r, lo_batch, sc, super_rows,
                    update_tile, split, static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: lo, b, out as above.  rc (1..32) is the number of
// right-hand-side columns one block solves; nb * rc elements must fit in a
// block's shared memory.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int trsm_f32(const float* lo, const float* b, float* out,
                        int batch, int nb, int r, int rc, int lo_batch,
                        void* stream) {
  return launch<float>(lo, b, out, batch, nb, r, rc, lo_batch,
                       static_cast<cudaStream_t>(stream));
}
