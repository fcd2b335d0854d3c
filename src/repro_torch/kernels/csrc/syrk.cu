// SYRK: batched symmetric rank-k update,
//
//   out[b] = C[b] - A[b] A[b]^T,
//
// with C of shape (B, nb, nb), A of shape (B, nb, k) and out a new
// contiguous (B, nb, nb) tensor.  Replaces the Pallas TPU kernel
// src/repro/kernels/chol_tiles.py::syrk (body _syrk_kernel).  On the exact
// blocked Cholesky (core/dist_cholesky.py) it is the trailing update of
// every panel step, trail[panel:, panel:] - pan pan^T, the O(m^3) term.
//
// Form: the full square.  The product P = A A^T is symmetric, so it is
// computed once per block tile of the lower triangle (tile row >= tile
// column); an off-diagonal tile writes both out[I, J] = C[I, J] - P_IJ and
// out[J, I] = C[J, I] - P_IJ^T.  C is read in full, so the result is
// C - A A^T for any C, symmetric or not, as the reference returns it.  C
// may be a row-strided view (the trailing block of the previous trail: no
// copy of it is made); A may be row-major or column-major (the TRSM's
// output, transposed).  Offsets are 64-bit.  Any nb >= 1 and k >= 0 work.
//
// Bound on the card: nb (nb + 1) / 2 * k FMAs against (2 nb^2 + nb k)
// itemsize bytes per matrix.  At the first step of the exact path
// (nb = 32256, k = 512, f64) the operations bound it: 5.3e11 flops, 8 ms at
// 67 TFLOP/s, against 16.8 GB, 5 ms at 3.35 TB/s.
//
// Two instances, picked by the dtype:
//
// dmma_f64 (f64): the lower-triangle products on the FP64 tensor cores
// (mma.sync m16n8k8, dmma.cuh), half the flops of a full-square GEMM.  One
// 256-thread block per 128 x 128 output tile (8 warps of 64 x 32), or per
// 64 x 64 tile (warps of 32 x 16) where the 128 x 128 grid would fill
// under two waves of the card (the wrapper's syrk_tile).  The k dimension
// streams through a three-stage cp.async ring of 32-wide slabs of the two
// row panels of A (dmma::cp_async_ring), so the next slabs load while the
// current one multiplies; row-major A is staged row by row, column-major A
// k-major, both at strides of 4 mod 16 doubles (no bank conflicts).  The
// epilogue reads C where it lies, writes out[I, J] from the accumulators
// in 16-byte pairs and the transposed tile through shared memory, so that
// those writes are coalesced too; each thread keeps eight C loads in
// flight (one at a time, the epilogue alone took as long as the products).
// The tiles are walked in bands of 8 tile rows, column by column inside a
// band, so the blocks on the card at one time share a few row panels of A
// in L2 instead of sweeping all of A.
//
// fma_f32 (f32): the lower-triangle products on the FP32 CUDA cores in
// full f32 (no TF32), the f64 instance's tiling: one 256-thread block per
// 128 x 128 output tile, walked in the same bands, two blocks an SM, each
// thread owning 8 x 8
// outputs in registers (rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns
// likewise), so that four 16-byte shared loads feed 64 FMAs.  The k
// dimension streams through a three-stage cp.async ring of 32-wide slabs,
// staged k-major (column-major A, the path's layout, in 16-byte runs;
// row-major A float by float); C is read where it lies and both writes go
// out as float4, the transposed one through shared memory.  Each output
// sums over k in order.
#include <cuda_runtime.h>

#include <cstdint>

#include "dmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// dmma_f64
// ---------------------------------------------------------------------------

constexpr int kDThreads = 256;  // 8 warps, 2 x 4 over the output tile
constexpr int kDK = 32;         // k-slab
constexpr int kDStages = 3;     // cp.async ring
constexpr int kBand = 8;        // tile rows of a band

// A staged slab: row-major A as [TM][kDK], column-major A k-major as
// [kDK][TM]; both at a stride of 4 mod 16 doubles.  The ring's stages hold
// two slabs (rows of tile I, rows of tile J); after the k loop the same
// memory holds the transposed tile [TM][TM + 4].
template <int TM, bool AK>
struct Slab {
  static constexpr int LD = AK ? TM + 4 : kDK + 4;
  static constexpr int SIZE = AK ? kDK * LD : TM * LD;
  static constexpr int RING = kDStages * 2 * SIZE;
  static constexpr int TRANS = TM * (TM + 4);
  static constexpr int SMEM = (RING > TRANS ? RING : TRANS) * (int)sizeof(double);
};

// Block x -> lower-triangle tile (ti, tj) of a side x side tile grid.  The
// tiles are numbered band by band (kBand tile rows each); inside a band,
// column by column over its rectangle left of the diagonal, then over its
// own small triangle, so that the blocks on the card at one time share rows
// of A in L2.  The order does not change the result: each tile is
// independent.
__device__ __forceinline__ void band_tile(long long x, int side, int& ti,
                                          int& tj) {
  int b0 = 0;
  long long base = 0;
  for (;;) {
    const int h = min(kBand, side - b0);
    const long long n = (long long)h * b0 + h * (h + 1) / 2;
    if (x < base + n) break;
    base += n;
    b0 += kBand;
  }
  const int h = min(kBand, side - b0);
  long long i = x - base;
  if (i < (long long)h * b0) {
    tj = (int)(i / h);
    ti = b0 + (int)(i % h);
  } else {
    i -= (long long)h * b0;
    int cc = 0;
    while (i >= h - cc) {
      i -= h - cc;
      ++cc;
    }
    tj = b0 + cc;
    ti = tj + (int)i;
  }
}

// One TM x TM tile of out = C - A A^T.  AK: A is column-major (a_rs == 1).
// vec_a: the slab copies may be 16 bytes; vec_c: C and out may be read and
// written as 16-byte pairs.
template <int TM, bool AK>
__global__ void __launch_bounds__(kDThreads, 1)
    syrk_dmma_f64(const double* __restrict__ c, const double* __restrict__ a,
                  double* __restrict__ out, int nb, int k, int side,
                  long long c_bs, long long c_rs, long long a_bs,
                  long long a_rs, long long a_cs, int vec_a, int vec_c) {
  constexpr int MI = TM / 32, NI = TM / 32;  // warp tile (TM/2) x (TM/4)
  constexpr int LD = Slab<TM, AK>::LD, SLAB = Slab<TM, AK>::SIZE;
  constexpr int LDT = TM + 4;
  extern __shared__ __align__(16) double smem[];
  int ti, tj;
  band_tile(blockIdx.x, side, ti, tj);
  const int r0 = ti * TM, c0 = tj * TM;
  const double* A = a + blockIdx.y * a_bs;
  const double* C = c + blockIdx.y * c_bs;
  double* O = out + blockIdx.y * (long long)nb * nb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * (TM / 2), wn = (warp % 4) * (TM / 4);

  double acc[MI][NI][4] = {};
  auto load = [&](int st, int q) {
    double* sa = smem + st * 2 * SLAB;
    double* sb = sa + SLAB;
    const int k0 = q * kDK;
    if (AK) {
      dmma::cp_tile<kDK, TM, kDThreads>(sa, LD, A + k0 * a_cs + r0, a_cs,
                                        k - k0, nb - r0, vec_a, tid);
      dmma::cp_tile<kDK, TM, kDThreads>(sb, LD, A + k0 * a_cs + c0, a_cs,
                                        k - k0, nb - c0, vec_a, tid);
    } else {
      dmma::cp_tile<TM, kDK, kDThreads>(sa, LD, A + r0 * a_rs + k0, a_rs,
                                        nb - r0, k - k0, vec_a, tid);
      dmma::cp_tile<TM, kDK, kDThreads>(sb, LD, A + c0 * a_rs + k0, a_rs,
                                        nb - c0, k - k0, vec_a, tid);
    }
  };
  auto compute = [&](int st, int) {
    const double* sa = smem + st * 2 * SLAB;
    dmma::mma_slab<MI, NI, AK, AK>(acc, sa, LD, sa + SLAB, LD, kDK, wm, wn, g,
                                   t);
  };
  dmma::cp_async_ring<kDStages>((k + kDK - 1) / kDK, load, compute);

  // out[I, J] = C[I, J] - P_IJ, pairs of neighbours (2t, 2t + 1); the C
  // pairs of one row fragment are loaded together, so each thread keeps
  // 2 NI loads in flight.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    double2 cv[2][NI];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = r0 + wm + 16 * mi + g + 8 * h;
        const int col = c0 + wn + 8 * ni + 2 * t;
        cv[h][ni] = row < nb ? dmma::load_pair(C + row * c_rs, col, nb, vec_c)
                             : make_double2(0.0, 0.0);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int row = r0 + wm + 16 * mi + g + 8 * h;
        const int col = c0 + wn + 8 * ni + 2 * t;
        if (row < nb)
          dmma::store_pair(O + (long long)row * nb, col, nb, vec_c,
                           cv[h][ni].x - acc[mi][ni][2 * h],
                           cv[h][ni].y - acc[mi][ni][2 * h + 1]);
      }
  }
  if (ti == tj) return;  // a diagonal tile wrote its whole square above

  // out[J, I] = C[J, I] - P_IJ^T through shared memory: st[cl][rl] =
  // P[rl][cl]; then each pass writes ROWS rows of tile J, a pair a thread,
  // eight passes' loads in flight at once.
  double* st = smem;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int rl = wm + 16 * mi + g + 8 * (v / 2);
        const int cl = wn + 8 * ni + 2 * t + v % 2;
        st[cl * LDT + rl] = acc[mi][ni][v];
      }
  __syncthreads();
  constexpr int PAIRS = TM / 2, ROWS = kDThreads / PAIRS, PASSES = TM / ROWS;
  constexpr int BATCH = PASSES < 8 ? PASSES : 8;
  const int il = 2 * (tid % PAIRS), j0 = tid / PAIRS;
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += BATCH) {
    double2 cv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int row = c0 + j0 + (p0 + u) * ROWS;
      cv[u] = row < nb ? dmma::load_pair(C + row * c_rs, r0 + il, nb, vec_c)
                       : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int jl = j0 + (p0 + u) * ROWS, row = c0 + jl;
      if (row < nb)
        dmma::store_pair(O + (long long)row * nb, r0 + il, nb, vec_c,
                         cv[u].x - st[jl * LDT + il],
                         cv[u].y - st[jl * LDT + il + 1]);
    }
  }
}

template <int TM, bool AK>
int launch_dmma(const double* c, const double* a, double* out, int batch,
                int nb, int k, long long c_bs, long long c_rs, long long a_bs,
                long long a_rs, long long a_cs, cudaStream_t stream) {
  constexpr int smem = Slab<TM, AK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      syrk_dmma_f64<TM, AK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long side = (nb + TM - 1) / TM;
  const long long tiles = side * (side + 1) / 2;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  // 16-byte slab copies: the copied runs (rows of A, or its columns when
  // column-major) have even lengths and strides and start aligned
  const long long run = AK ? nb : k, stride = AK ? a_cs : a_rs;
  const int vec_a = aligned(a) && run % 2 == 0 && stride % 2 == 0 && a_bs % 2 == 0;
  const int vec_c = aligned(c) && aligned(out) && nb % 2 == 0 && c_rs % 2 == 0 &&
                    c_bs % 2 == 0;
  syrk_dmma_f64<TM, AK><<<dim3((unsigned)tiles, batch), kDThreads, smem, stream>>>(
      c, a, out, nb, k, (int)side, c_bs, c_rs, a_bs, a_rs, a_cs, vec_a, vec_c);
  return (int)cudaGetLastError();
}

int launch_f64(const double* c, const double* a, double* out, int batch,
               int nb, int k, long long c_bs, long long c_rs, long long a_bs,
               long long a_rs, long long a_cs, int tile, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  // column-major A: its rows are the unit-stride dimension
  const bool ak = a_rs == 1 && a_cs != 1 && k > 1;
  if (tile == 128)
    return ak ? launch_dmma<128, true>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream)
              : launch_dmma<128, false>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream);
  if (tile == 64)
    return ak ? launch_dmma<64, true>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream)
              : launch_dmma<64, false>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fma_f32
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;        // 16 x 16 threads, warps of 4 x 8
constexpr int kFBlocks = 2;           // blocks an SM (128 registers a thread)
constexpr int kFTile = 128;           // output tile edge
constexpr int kFK = 32;               // k-slab
constexpr int kFStages = 3;           // cp.async ring
constexpr int kFLd = kFTile + 4;      // row stride of a k-major slab
constexpr int kFSlab = kFK * kFLd;
constexpr int kFRing = kFStages * 2 * kFSlab;
constexpr int kFTrans = kFTile * kFLd;  // the transposed tile [TM][kFLd]
constexpr int kFSmem = (kFRing > kFTrans ? kFRing : kFTrans) * (int)sizeof(float);

// s[q][r] = A[r0 + r, k0 + q] for a slab of kFK columns of A and the
// kFTile rows from r0 (zero outside the matrix).  Column-major A (AK) is
// copied in runs along its rows (16 bytes with vec); row-major A float by
// float, consecutive threads along its rows' unit stride.
template <bool AK>
__device__ __forceinline__ void load_kslab(float* s, const float* A, int r0,
                                           int k0, int nb, int k,
                                           long long a_rs, long long a_cs,
                                           bool vec, int tid) {
  if (AK) {
    dmma::cp_tile<kFK, kFTile, kFThreads>(s, kFLd, A + k0 * a_cs + r0, a_cs,
                                          k - k0, nb - r0, vec, tid);
    return;
  }
#pragma unroll 4
  for (int e = tid; e < kFTile * kFK; e += kFThreads) {
    const int r = e / kFK, q = e % kFK;
    const bool ok = r0 + r < nb && k0 + q < k;
    const float* src = A + (long long)(r0 + r) * a_rs + (long long)(k0 + q) * a_cs;
    dmma::cp_async_elem(s + q * kFLd + r, ok ? src : A, ok);
  }
}

// Four neighbours row[col..col + 3] of a row of n values (zeros past n),
// and their store: one 16-byte access where vec (the row 16-byte aligned,
// col a multiple of 4) and all four lie inside, else one access a value.
__device__ __forceinline__ float4 load4(const float* row, int col, int n,
                                        int vec) {
  if (vec && col + 3 < n) return *reinterpret_cast<const float4*>(row + col);
  float v[4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < n) v[q] = row[col + q];
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float* row, int col, int n, int vec,
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

__device__ __forceinline__ float4 sub4(float4 c, float p0, float p1, float p2,
                                       float p3) {
  return make_float4(c.x - p0, c.y - p1, c.z - p2, c.w - p3);
}

// One 128 x 128 tile of out = C - A A^T on the FP32 units.  Thread (ty, tx)
// owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns likewise with
// tx: per k it reads four float4 (its 8 rows of the slab of tile I, its 8
// of tile J) for 64 FMAs.  A warp's threads span 4 ty and 8 tx, so its
// loads fall in 4 and 8 distinct 16-byte words of a 528-byte slab row: no
// bank conflicts.  Each output sums over k in order.  Two blocks share an
// SM (2 x 101 KB of ring): at 128 registers the compiler spills a few
// bytes, and the first update ran 12% faster than at one block an SM and
// 151 registers (scripts/chol_f32_variants.py).
template <bool AK>
__global__ void __launch_bounds__(kFThreads, kFBlocks)
    syrk_fma_f32(const float* __restrict__ c, const float* __restrict__ a,
                 float* __restrict__ out, int nb, int k, int side,
                 long long c_bs, long long c_rs, long long a_bs,
                 long long a_rs, long long a_cs, int vec_a, int vec_c) {
  extern __shared__ __align__(16) float fsmem[];
  int ti, tj;
  band_tile(blockIdx.x, side, ti, tj);
  const int r0 = ti * kFTile, c0 = tj * kFTile;
  const float* A = a + blockIdx.y * a_bs;
  const float* C = c + blockIdx.y * c_bs;
  float* O = out + blockIdx.y * (long long)nb * nb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = 4 * (warp / 2) + lane / 8, tx = 8 * (warp % 2) + lane % 8;

  float acc[8][8] = {};
  auto load = [&](int st, int q) {
    float* sa = fsmem + st * 2 * kFSlab;
    load_kslab<AK>(sa, A, r0, q * kFK, nb, k, a_rs, a_cs, vec_a, tid);
    load_kslab<AK>(sa + kFSlab, A, c0, q * kFK, nb, k, a_rs, a_cs, vec_a, tid);
  };
  auto compute = [&](int st, int) {
    const float* sa = fsmem + st * 2 * kFSlab;
    const float* sb = sa + kFSlab;
#pragma unroll 4
    for (int q = 0; q < kFK; ++q) {
      const float* xa = sa + q * kFLd + 4 * ty;
      const float* yb = sb + q * kFLd + 4 * tx;
      const float4 x0 = *reinterpret_cast<const float4*>(xa);
      const float4 x1 = *reinterpret_cast<const float4*>(xa + kFTile / 2);
      const float4 y0 = *reinterpret_cast<const float4*>(yb);
      const float4 y1 = *reinterpret_cast<const float4*>(yb + kFTile / 2);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  };
  dmma::cp_async_ring<kFStages>((k + kFK - 1) / kFK, load, compute);

  // out[I, J] = C[I, J] - P_IJ, four rows' C loads in flight at a time.
  const auto local = [](int i, int t) {
    return (i / 4) * (kFTile / 2) + 4 * t + i % 4;
  };
#pragma unroll
  for (int i0 = 0; i0 < 8; i0 += 4) {
    float4 cv[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + local(i0 + i, ty);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + h * (kFTile / 2) + 4 * tx;
        cv[i][h] = row < nb ? load4(C + row * c_rs, col, nb, vec_c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + local(i0 + i, ty);
      if (row >= nb) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + h * (kFTile / 2) + 4 * tx;
        const int q = 4 * h;
        store4(O + (long long)row * nb, col, nb, vec_c,
               sub4(cv[i][h], acc[i0 + i][q], acc[i0 + i][q + 1],
                    acc[i0 + i][q + 2], acc[i0 + i][q + 3]));
      }
    }
  }
  if (ti == tj) return;  // a diagonal tile wrote its whole square above

  // out[J, I] = C[J, I] - P_IJ^T through shared memory: st[cl][rl] =
  // P[rl][cl]; then each pass writes 8 rows of tile J, four values a
  // thread, eight passes' loads in flight at once.
  float* st = fsmem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st[local(j, tx) * kFLd + local(i, ty)] = acc[i][j];
  __syncthreads();
  constexpr int QUADS = kFTile / 4, ROWS = kFThreads / QUADS;
  constexpr int PASSES = kFTile / ROWS, BATCH = 8;
  const int il = 4 * (tid % QUADS), j0 = tid / QUADS;
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += BATCH) {
    float4 cv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int row = c0 + j0 + (p0 + u) * ROWS;
      cv[u] = row < nb ? load4(C + row * c_rs, r0 + il, nb, vec_c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int jl = j0 + (p0 + u) * ROWS, row = c0 + jl;
      if (row < nb) {
        const float4 p = *reinterpret_cast<const float4*>(st + jl * kFLd + il);
        store4(O + (long long)row * nb, r0 + il, nb, vec_c,
               sub4(cv[u], p.x, p.y, p.z, p.w));
      }
    }
  }
}

template <bool AK>
int launch_fma(const float* c, const float* a, float* out, int batch, int nb,
               int k, long long c_bs, long long c_rs, long long a_bs,
               long long a_rs, long long a_cs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      syrk_fma_f32<AK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (err != cudaSuccess) return (int)err;
  const long long side = (nb + kFTile - 1) / kFTile;
  const long long tiles = side * (side + 1) / 2;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  // 16-byte slab copies (column-major A only): runs of whole float4 along
  // its rows, each starting aligned
  const int vec_a = AK && aligned(a) && nb % 4 == 0 && a_cs % 4 == 0 && a_bs % 4 == 0;
  const int vec_c = aligned(c) && aligned(out) && nb % 4 == 0 && c_rs % 4 == 0 &&
                    c_bs % 4 == 0;
  syrk_fma_f32<AK><<<dim3((unsigned)tiles, batch), kFThreads, kFSmem, stream>>>(
      c, a, out, nb, k, (int)side, c_bs, c_rs, a_bs, a_rs, a_cs, vec_a, vec_c);
  return (int)cudaGetLastError();
}

int launch_f32(const float* c, const float* a, float* out, int batch, int nb,
               int k, long long c_bs, long long c_rs, long long a_bs,
               long long a_rs, long long a_cs, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  // column-major A: its rows are the unit-stride dimension
  const bool ak = a_rs == 1 && a_cs != 1 && k > 1;
  return ak ? launch_fma<true>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream)
            : launch_fma<false>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs, stream);
}

}  // namespace

// c (batch, nb, nb) with element (b, r, s) at c[b * c_bs + r * c_rs + s];
// a (batch, nb, k) with element (b, r, q) at a[b * a_bs + r * a_rs + q * a_cs]
// (a_cs == 1 or a_rs == 1); out (batch, nb, nb) contiguous; all on the
// device.  tile (128 or 64) is the dmma_f64 instance's output tile edge.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int syrk_f64(const double* c, const double* a, double* out,
                        int batch, int nb, int k, long long c_bs,
                        long long c_rs, long long a_bs, long long a_rs,
                        long long a_cs, int tile, void* stream) {
  return launch_f64(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs,
                    tile, static_cast<cudaStream_t>(stream));
}

// The fma_f32 instance: the same operands; 128 x 128 tiles.
extern "C" int syrk_f32(const float* c, const float* a, float* out, int batch,
                        int nb, int k, long long c_bs, long long c_rs,
                        long long a_bs, long long a_rs, long long a_cs,
                        void* stream) {
  return launch_f32(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs,
                    static_cast<cudaStream_t>(stream));
}
