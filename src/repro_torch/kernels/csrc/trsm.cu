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
// Two instances, picked by the dtype, with one schedule of launches (the
// launchers below are templated on the element type; the wrapper's
// trsm_plan picks the strip width, super-block, update tile and row split
// of each):
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
// fma_f32 (f32): the same four launches in full f32 on the FP32 CUDA cores
// (no TF32; every sum in f32, as the Pallas kernel's promote_types(f32,
// f32)): inv in f32, then the strip, row-split and update kernels with the
// DMMA fragments replaced by FMA register tiles (fma_slab below).  A
// thread owns RM rows (ty + TY i) and 4 NJ columns of the block's output;
// per 4 k it reads RM float4 of the L (or D) slab along k and 4 NJ float4
// of the X (or R) slab along the columns, 16 RM NJ FMAs, and each output
// sums over k in order.  A strip block is 128 threads for 64 x SC outputs
// (SC = 64: 8 x 4 a thread; 32: 4 x 4; 16: 2 x 4; 8: 1 x 4); an f32 slab is
// half an f64 one's bytes, so three 64-wide strip blocks share an SM (two
// stages of 32-wide slabs), four 32-wide ones, two of the narrower ones
// (three stages of 64-wide slabs).  The strip launch that follows inv is
// not programmatic (see launch_strip).  The row split is a cluster of
// 128-thread blocks, 1 x 4 outputs a thread, X_s pushed as float4 through
// distributed shared memory; the update takes 128 x 128 tiles (8 x 8
// outputs a thread) or 64 x 64 ones (4 x 4).  At the exact_f32 path's
// panel solves the launches take 28-38% of their bound; what holds them
// there is not measured (no profiler of stalls on the card's machine): a
// strip alone on an SM takes about 0.1 ms whatever its width, and 8 x 4
// outputs a thread (against 4 x 4 on 256 threads) or operands double
// buffered in registers moved the sweep by -11% and +4%
// (scripts/trsm_variants.py).
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
// row-major into dinv[(tile * nblk + j) * kBB], in T (both instances).  All
// 256 threads stage the block (16 loads each in flight); then thread c < 64
// solves column c in registers: x <- e_c; for each column jj: x[jj] *= 1 /
// L[jj][jj], then x[i] -= L[i][jj] x[jj] below it.  (Four lanes a column
// with shuffles, or the jj loop left rolled, were not faster on the card.)
template <typename T>
__device__ __forceinline__ void invert_block(const T* __restrict__ lo,
                                             T* __restrict__ dinv, int nb,
                                             int nblk, T (&sl)[kB][kB + 1],
                                             T (&sinv)[kB]) {
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  const int j0 = blockIdx.x * kB, w = min(kB, nb - j0);
  const T* L = lo + (size_t)blockIdx.y * nb * nb;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < kBB / kDThreads; ++q) {
    const int e = tid + q * kDThreads, i = e / kB, jj = e % kB;
    T x;
    if (i < w && jj < w)
      x = jj <= i ? L[(size_t)(j0 + i) * nb + j0 + jj] : T(0);
    else
      x = i == jj ? T(1) : T(0);
    sl[i][jj] = x;
  }
  __syncthreads();
  if (tid < kB) sinv[tid] = T(1) / sl[tid][tid];
  __syncthreads();
  if (tid >= kB) return;
  const int c = tid;
  T x[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) x[i] = i == c ? T(1) : T(0);
#pragma unroll
  for (int jj = 0; jj < kB; ++jj) {
    x[jj] *= sinv[jj];
#pragma unroll
    for (int i = jj + 1; i < kB; ++i) x[i] -= sl[i][jj] * x[jj];
  }
  T* D = dinv + ((size_t)blockIdx.y * nblk + blockIdx.x) * kBB;
#pragma unroll
  for (int i = 0; i < kB; ++i) D[i * kB + c] = x[i];
}

__global__ void __launch_bounds__(kDThreads)
    trsm_inv_f64(const double* __restrict__ lo, double* __restrict__ dinv,
                 int nb, int nblk) {
  __shared__ double sl[kB][kB + 1];
  __shared__ double sinv[kB];
  invert_block(lo, dinv, nb, nblk, sl, sinv);
}

__global__ void __launch_bounds__(kDThreads)
    trsm_inv_f32(const float* __restrict__ lo, float* __restrict__ dinv,
                 int nb, int nblk) {
  __shared__ float sl[kB][kB + 1];
  __shared__ float sinv[kB];
  invert_block(lo, dinv, nb, nblk, sl, sinv);
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
template <typename T>
constexpr int kRSmem =
    (kRStages * kB * kRLdL + kB * kLdD + 3 * kB * kRLdX) * (int)sizeof(T);

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
template <typename T>
__device__ __forceinline__ unsigned cluster_map(const T* p, int rank) {
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

__device__ __forceinline__ void cluster_store(unsigned addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
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

// ---------------------------------------------------------------------------
// fma_f32
// ---------------------------------------------------------------------------

// (ty, tx) of thread tid in a grid of TX four-column groups: a warp spans
// WX = min(8, TX) consecutive tx and 32 / WX consecutive ty, so that its
// float4 loads of B fall on at most 8 consecutive 16-byte words of one row
// and those of A on consecutive rows, whose strides of 4 mod 32 floats put
// 8 of them on distinct banks: no bank conflicts.
template <int TX>
__device__ __forceinline__ void fma_thread(int tid, int& ty, int& tx) {
  constexpr int WX = TX < 8 ? TX : 8, WY = 32 / WX, XW = TX / WX;
  const int warp = tid / 32, lane = tid % 32;
  ty = (warp / XW) * WY + lane / WX;
  tx = (warp % XW) * WX + lane % WX;
}

// acc += A B over the first ks (a multiple of 4) columns of a k-slab in
// shared memory, A stored by rows (A[i][k] = sa[i * lda + k]) and B by rows
// of k (B[k][c] = sb[k * ldb + c]), for thread (ty, tx): rows ty + TY i
// (i < RM), columns 4 (tx + TX j) + {0..3} (j < NJ).  Per 4 k it reads RM
// float4 of A along k and 4 NJ float4 of B along c for 16 RM NJ FMAs; each
// output sums over k in order.  A caller that wants C -= A B subtracts acc
// in its epilogue.
template <int RM, int NJ, int TY, int TX>
__device__ __forceinline__ void fma_slab(float (&acc)[RM][NJ][4],
                                         const float* sa, int lda,
                                         const float* sb, int ldb, int ks,
                                         int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < ks; k += 4) {
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(sa + (ty + TY * i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(sb + (k + kk) * ldb +
                                                4 * (tx + TX * j));
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j][0] = fmaf(x, b[j].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(x, b[j].y, acc[i][j][1]);
          acc[i][j][2] = fmaf(x, b[j].z, acc[i][j][2]);
          acc[i][j][3] = fmaf(x, b[j].w, acc[i][j][3]);
        }
      }
    }
  }
}

// The quad row[col..col + 3] of a row of n floats (zeros past n), and its
// store: one 16-byte access where vec (the row 16-byte aligned, col a
// multiple of 4) and all four lie inside, else one access a value.
__device__ __forceinline__ float4 load_quad(const float* row, int col, int n,
                                            int vec) {
  if (vec && col + 3 < n) return *reinterpret_cast<const float4*>(row + col);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = col + q < n ? row[col + q] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_quad(float* row, int col, int n, int vec,
                                           float4 x) {
  if (vec && col + 3 < n) {
    *reinterpret_cast<float4*>(row + col) = x;
    return;
  }
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < n) row[col + q] = v[q];
}

__device__ __forceinline__ float4 quad(const float (&x)[4]) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The f32 strip kernel's layout for SC columns: 128 threads, TX = SC / 4
// column groups by TY row groups of RM rows (8 x 4 outputs a thread at
// SC = 64, 4 x 4 at 32, 2 x 4 at 16, 1 x 4 at 8), k-slabs of KS in a ring
// of STAGES, BLOCKS blocks an SM (the most the shared memory holds).
template <int SC>
struct StripF {
  static constexpr int THREADS = 128;
  static constexpr int TX = SC / 4, TY = THREADS / TX, RM = kB / TY;
  static constexpr int KS = SC <= 16 ? 64 : 32;
  static constexpr int STAGES = SC <= 16 ? 3 : 2;
  static constexpr int BLOCKS = SC == 64 ? 3 : (SC == 32 ? 4 : 2);
  static constexpr int LDL = KS + 4;  // staged L slab [kB][KS]
  static constexpr int LDX = SC + 4;  // staged X slab [KS][SC], R [kB][SC]
  static constexpr int STAGE = kB * LDL + KS * LDX;
  static constexpr int SMEM =
      (STAGES * STAGE + kB * LDX + kB * kLdD) * (int)sizeof(float);
};

// trsm_strip_f64's walk in f32: rows [R0, R1) of X = L^{-1} src for the SC
// columns of block x of tile blockIdx.y, the two products on FMA register
// tiles.
template <int SC>
__global__ void __launch_bounds__(StripF<SC>::THREADS, StripF<SC>::BLOCKS)
    trsm_strip_f32(const float* __restrict__ lo,
                   const float* __restrict__ dinv, const float* src,
                   float* out, int nb, int r, int R0, int R1,
                   long long lo_stride, long long dinv_stride, int vec_l,
                   int vec_x) {
  using P = StripF<SC>;
  constexpr int RM = P::RM, TY = P::TY, TX = P::TX, KS = P::KS;
  constexpr int LDL = P::LDL, LDX = P::LDX;
  extern __shared__ __align__(16) float fsmem[];
  float* ring = fsmem;
  float* sr = ring + P::STAGES * P::STAGE;  // [kB][LDX]: B_i, then R
  float* sd = sr + kB * LDX;                // [kB][kLdD]: D_i
  const int c0 = blockIdx.x * SC;
  const float* L = lo + blockIdx.y * lo_stride;
  const float* Bs = src + (size_t)blockIdx.y * nb * r;
  float* X = out + (size_t)blockIdx.y * nb * r;
  const float* Dt = dinv + blockIdx.y * dinv_stride;
  const int tid = threadIdx.x;
  int ty, tx;
  fma_thread<TX>(tid, ty, tx);
  dmma::grid_wait();
  dmma::grid_launch_dependents();

#pragma unroll 1
  for (int i0 = R0; i0 < R1; i0 += kB) {
    const int h = min(kB, nb - i0);
    // D_i and B_i, one commit group ahead of the ring's slabs.
    dmma::cp_tile<kB, kB, P::THREADS>(sd, kLdD, Dt + (size_t)(i0 / kB) * kBB,
                                      kB, kB, kB, true, tid);
    dmma::cp_tile<kB, SC, P::THREADS>(sr, LDX, Bs + (size_t)i0 * r + c0, r, h,
                                      r - c0, vec_x, tid);
    dmma::cp_async_commit();
    float acc[RM][1][4] = {};
    auto load = [&](int st, int q) {
      float* sl = ring + st * P::STAGE;
      const int k0 = R0 + q * KS;
      dmma::cp_tile<kB, KS, P::THREADS>(sl, LDL, L + (size_t)i0 * nb + k0, nb,
                                        h, KS, vec_l, tid);
      dmma::cp_tile<KS, SC, P::THREADS>(sl + kB * LDL, LDX,
                                        X + (size_t)k0 * r + c0, r, KS, r - c0,
                                        vec_x, tid);
    };
    auto compute = [&](int st, int) {
      const float* sl = ring + st * P::STAGE;
      fma_slab<RM, 1, TY, TX>(acc, sl, LDL, sl + kB * LDL, LDX, KS, ty, tx);
    };
    dmma::cp_async_ring<P::STAGES>((i0 - R0) / KS, load, compute);
    // R = B_i - L_i,R0:i X_R0:i, in place in sr.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float* p = sr + (ty + TY * i) * LDX + 4 * tx;
#pragma unroll
      for (int v = 0; v < 4; ++v) p[v] -= acc[i][0][v];
    }
    __syncthreads();
    // X_i = D_i R, written out (rows < h, columns < r).
    float x[RM][1][4] = {};
    fma_slab<RM, 1, TY, TX>(x, sd, kLdD, sr, LDX, kB, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = ty + TY * i;
      if (rl < h)
        store_quad(X + (size_t)(i0 + rl) * r, c0 + 4 * tx, r, vec_x,
                   quad(x[i][0]));
    }
    // X_i is visible to the block's next slab copies, and sd, sr are free.
    __syncthreads();
  }
}

// trsm_rows_f64's cluster in f32: 128 threads a block row, thread (ty, tx)
// owning row ty and columns 4 tx..4 tx + 3 of the strip's 8; X_s goes to
// the later blocks as one float4 a thread.
__global__ void __launch_bounds__(kRThreads, 1)
    trsm_rows_f32(const float* __restrict__ lo,
                  const float* __restrict__ dinv, const float* src,
                  float* out, int nb, int r, int R0, int R1,
                  long long lo_stride, long long dinv_stride, int vec_l,
                  int vec_x) {
  constexpr int TX = kRCols / 4, TY = kB;
  static_assert(TX * TY == kRThreads, "one output row a thread");
  extern __shared__ __align__(16) float rsmem[];
  float* ring = rsmem;
  float* sd = ring + kRStages * kB * kRLdL;  // [kB][kLdD]: D_q
  float* sr = sd + kB * kLdD;                // [kB][kRLdX]: B_q, then R
  float* sx = sr + kB * kRLdX;               // [2][kB][kRLdX]: X_s
  const int nbr = (R1 - R0 + kB - 1) / kB;
  const int q = blockIdx.x % nbr, c0 = (blockIdx.x / nbr) * kRCols;
  const int i0 = R0 + q * kB, h = min(kB, nb - i0);
  const float* L = lo + blockIdx.y * lo_stride;
  const float* Bs = src + (size_t)blockIdx.y * nb * r;
  float* X = out + (size_t)blockIdx.y * nb * r;
  const float* Dt = dinv + blockIdx.y * dinv_stride;
  const int tid = threadIdx.x;
  int ty, tx;
  fma_thread<TX>(tid, ty, tx);
  // No block writes into another's shared memory before all have started.
  cluster_arrive_relaxed();
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  dmma::cp_tile<kB, kB, kRThreads>(sd, kLdD, Dt + (size_t)(i0 / kB) * kBB, kB,
                                   kB, kB, true, tid);
  dmma::cp_tile<kB, kRCols, kRThreads>(sr, kRLdX, Bs + (size_t)i0 * r + c0, r,
                                       h, r - c0, vec_x, tid);
  dmma::cp_async_commit();
  // One commit group a slab (empty past q), as in trsm_rows_f64.
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
  float acc[1][1][4] = {};
  cluster_wait();
#pragma unroll 1
  for (int s = 0; s < nbr; ++s) {
    dmma::cp_async_wait<kRStages - 1>();
    __syncthreads();
    float* xs = sx + (s % 2) * kB * kRLdX;
    if (s == q) {
      // R = B_q - sum_{j<q} L_q,j X_j, in place in sr; then X_q = D_q R.
      float* p = sr + ty * kRLdX + 4 * tx;
#pragma unroll
      for (int v = 0; v < 4; ++v) p[v] -= acc[0][0][v];
      __syncthreads();
      float x[1][1][4] = {};
      fma_slab<1, 1, TY, TX>(x, sd, kLdD, sr, kRLdX, kB, ty, tx);
      const float4 xv = quad(x[0][0]);
      for (int dst = q + 1; dst < nbr; ++dst)
        cluster_store(cluster_map(xs + ty * kRLdX + 4 * tx, dst), xv);
      // X_q is published by the barrier; its global stores wait on nothing.
      cluster_arrive();
      if (ty < h) store_quad(X + (size_t)(i0 + ty) * r, c0 + 4 * tx, r, vec_x, xv);
    } else {
      cluster_arrive();
    }
    cluster_wait();
    if (q > s) {
      fma_slab<1, 1, TY, TX>(acc, ring + (s % kRStages) * kB * kRLdL, kRLdL, xs,
                             kRLdX, kB, ty, tx);
      __syncthreads();  // every warp is done with the stage before its refill
      if (s + kRStages < q) load(s + kRStages);
    }
    dmma::cp_async_commit();
  }
}

// The f32 update's layout: 16 x 16 threads, each RM = TM / 16 rows and NJ =
// TM / 64 groups of 4 columns (8 x 8 outputs at TM = 128, 4 x 4 at 64).
template <int TM>
struct UpdateF {
  static constexpr int TX = 16, TY = 16, RM = TM / TY, NJ = TM / (4 * TX);
  static constexpr int KS = 32, STAGES = 3;
  static constexpr int LDL = KS + 4;  // staged L slab [TM][KS]
  static constexpr int LDX = TM + 4;  // staged X slab [KS][TM]
  static constexpr int STAGE = TM * LDL + KS * LDX;
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);
};

// trsm_update_f64 in f32: out[R1:, :] = src[R1:, :] - L[R1:, R0:R1]
// X[R0:R1, :], one TM x TM tile a block, the tiles walked down the rows
// first.
template <int TM>
__global__ void __launch_bounds__(kDThreads, 1)
    trsm_update_f32(const float* __restrict__ lo, const float* src, float* out,
                    int nb, int r, int R0, int R1, long long lo_stride,
                    int vec_l, int vec_x) {
  using P = UpdateF<TM>;
  constexpr int RM = P::RM, NJ = P::NJ, TY = P::TY, TX = P::TX, KS = P::KS;
  constexpr int LDL = P::LDL, LDX = P::LDX;
  extern __shared__ __align__(16) float usmem[];
  const int nr = (nb - R1 + TM - 1) / TM;
  const int r0 = R1 + (blockIdx.x % nr) * TM, c0 = (blockIdx.x / nr) * TM;
  const float* L = lo + blockIdx.y * lo_stride;
  const float* S = src + (size_t)blockIdx.y * nb * r;
  float* X = out + (size_t)blockIdx.y * nb * r;
  const int tid = threadIdx.x;
  int ty, tx;
  fma_thread<TX>(tid, ty, tx);
  dmma::grid_wait();
  dmma::grid_launch_dependents();
  float acc[RM][NJ][4] = {};
  auto load = [&](int st, int q) {
    float* sa = usmem + st * P::STAGE;
    const int k0 = R0 + q * KS;
    dmma::cp_tile<TM, KS, kDThreads>(sa, LDL, L + (size_t)r0 * nb + k0, nb,
                                     nb - r0, KS, vec_l, tid);
    dmma::cp_tile<KS, TM, kDThreads>(sa + TM * LDL, LDX,
                                     X + (size_t)k0 * r + c0, r, KS, r - c0,
                                     vec_x, tid);
  };
  auto compute = [&](int st, int) {
    const float* sa = usmem + st * P::STAGE;
    fma_slab<RM, NJ, TY, TX>(acc, sa, LDL, sa + TM * LDL, LDX, KS, ty, tx);
  };
  dmma::cp_async_ring<P::STAGES>((R1 - R0) / KS, load, compute);
  // out = src - acc; a thread reads only the quads it writes (src may be
  // out itself).
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty + TY * i;
    if (row >= nb) continue;
    float4 sv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      sv[j] = load_quad(S + (size_t)row * r, c0 + 4 * (tx + TX * j), r, vec_x);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 d = make_float4(sv[j].x - acc[i][j][0], sv[j].y - acc[i][j][1],
                                   sv[j].z - acc[i][j][2], sv[j].w - acc[i][j][3]);
      store_quad(X + (size_t)row * r, c0 + 4 * (tx + TX * j), r, vec_x, d);
    }
  }
}

// ---------------------------------------------------------------------------
// The launches, both instances
// ---------------------------------------------------------------------------

// The f32 strip launch that follows the inverses is not programmatic: its
// blocks, scheduled while the inv blocks still ran, were placed two and
// three to an SM while other SMs stayed idle (a grid of 128 strips took
// the time of two waves; scripts/trsm_variants.py).
template <typename T, int SC>
cudaError_t launch_strip(const T* lo, const T* dinv, const T* src, T* out,
                         int batch, int nb, int r, int R0, int R1,
                         long long lo_stride, long long dinv_stride, int vec_l,
                         int vec_x, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int,
                 long long, long long, int, int);
  int smem, threads = kDThreads;
  bool pdl = true;
  if constexpr (sizeof(T) == 8) {
    kernel = trsm_strip_f64<SC>;
    smem = Strip<SC>::SMEM;
  } else {
    kernel = trsm_strip_f32<SC>;
    smem = StripF<SC>::SMEM;
    threads = StripF<SC>::THREADS;
    pdl = R0 > 0;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + SC - 1) / SC, batch);
  if (pdl)
    return dmma::launch_pdl(kernel, grid, threads, smem, stream, lo, dinv, src,
                            out, nb, r, R0, R1, lo_stride, dinv_stride, vec_l,
                            vec_x);
  kernel<<<grid, threads, smem, stream>>>(lo, dinv, src, out, nb, r, R0, R1,
                                          lo_stride, dinv_stride, vec_l, vec_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const T* lo, const T* dinv, const T* src, T* out,
                        int batch, int nb, int r, int R0, int R1,
                        long long lo_stride, long long dinv_stride, int vec_l,
                        int vec_x, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int,
                 long long, long long, int, int);
  if constexpr (sizeof(T) == 8)
    kernel = trsm_rows_f64;
  else
    kernel = trsm_rows_f32;
  constexpr int smem = kRSmem<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned nbr = (R1 - R0 + kB - 1) / kB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((r + kRCols - 1) / kRCols) * nbr, batch);
  cfg.blockDim = dim3(kRThreads);
  cfg.dynamicSmemBytes = smem;
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
  return cudaLaunchKernelEx(&cfg, kernel, lo, dinv, src, out, nb, r, R0, R1,
                            lo_stride, dinv_stride, vec_l, vec_x);
}

template <typename T, int TM>
cudaError_t launch_update(const T* lo, const T* src, T* out, int batch, int nb,
                          int r, int R0, int R1, long long lo_stride,
                          int vec_l, int vec_x, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, T*, int, int, int, int, long long, int,
                 int);
  int smem;
  if constexpr (sizeof(T) == 8) {
    kernel = trsm_update_f64<TM>;
    smem = Update<TM>::SMEM;
  } else {
    kernel = trsm_update_f32<TM>;
    smem = UpdateF<TM>::SMEM;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((nb - R1 + TM - 1) / TM) * ((r + TM - 1) / TM);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  return dmma::launch_pdl(kernel, dim3((unsigned)tiles, batch), kDThreads,
                          smem, stream, lo, src, out, nb, r, R0, R1, lo_stride,
                          vec_l, vec_x);
}

template <typename T>
int launch(const T* lo, const T* b, T* out, T* dinv, int batch, int nb, int r,
           int lo_batch, int sc, int super_rows, int update_tile, int split,
           cudaStream_t stream) {
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
  // 16-byte copies: rows of whole 16-byte words (2 doubles, 4 floats)
  constexpr int per16 = 16 / (int)sizeof(T);
  const int vec_l = nb % per16 == 0 && aligned(lo);
  const int vec_x = r % per16 == 0 && aligned(b) && aligned(out);
  void (*inv)(const T*, T*, int, int);
  if constexpr (sizeof(T) == 8)
    inv = trsm_inv_f64;
  else
    inv = trsm_inv_f32;
  cudaError_t err = dmma::launch_pdl(inv, dim3(nblk, lo_batch), kDThreads, 0,
                                     stream, lo, dinv, nb, nblk);
  if (err != cudaSuccess) return (int)err;
  for (int R0 = 0; R0 < nb; R0 += super_rows) {
    const int R1 = std::min(nb, R0 + super_rows);
    const T* src = R0 == 0 ? b : out;
    switch (split ? 0 : sc) {
      case 0: err = launch_rows(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 64: err = launch_strip<T, 64>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 32: err = launch_strip<T, 32>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 16: err = launch_strip<T, 16>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      case 8: err = launch_strip<T, 8>(lo, dinv, src, out, batch, nb, r, R0, R1, lo_stride, dinv_stride, vec_l, vec_x, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    if (R1 == nb) break;
    err = update_tile == 128
              ? launch_update<T, 128>(lo, src, out, batch, nb, r, R0, R1, lo_stride, vec_l, vec_x, stream)
              : launch_update<T, 64>(lo, src, out, batch, nb, r, R0, R1, lo_stride, vec_l, vec_x, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// lo (lo_batch, nb, nb) with lo_batch 1 (broadcast) or batch; b, out
// (batch, nb, r); all contiguous, row-major, on the device; out may not
// alias b.  dinv is scratch of lo_batch * ceil(nb / 64) * 64 * 64 elements.
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
  return launch(lo, b, out, dinv, batch, nb, r, lo_batch, sc, super_rows,
                update_tile, split, static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: the same operands, plan and launches in float32.
extern "C" int trsm_f32(const float* lo, const float* b, float* out,
                        float* dinv, int batch, int nb, int r, int lo_batch,
                        int sc, int super_rows, int update_tile, int split,
                        void* stream) {
  return launch(lo, b, out, dinv, batch, nb, r, lo_batch, sc, super_rows,
                update_tile, split, static_cast<cudaStream_t>(stream));
}
