// FP64 tensor-core (DMMA) building blocks shared by the f64 instances of
// potrf.cu, tlr_mm.cu, trsm.cu and syrk.cu; the cp.async copies, the ring
// and the programmatic dependent launch serve the f32 instances too.
//
// Hopper has no wgmma for f64; its FP64 tensor cores are reached through
// mma.sync.  The m16n8k{4,8,16} shapes run at the card's full FP64
// tensor-core rate, m8n8k4 at half of it (scripts/dmma_rates.py measures
// both), so the kernels use m16n8k8.  Fragment layout of one warp
// (g = lane / 4, t = lane % 4), as PTX and CUTLASS's
// SM90_16x8x8_F64F64F64F64_TN give it:
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B ( 8 x 8, "col"):      b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):             c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// Shared-memory tiles read by these fragments keep a row stride of 4 mod 16
// doubles (kLd), so the 16 lanes of a half warp, (g, t) in 4 x 4, fall on 16
// distinct 8-byte bank pairs: the loads are free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

namespace dmma {

// acc += A B for one 16 x 8 x 8 tile.
__device__ __forceinline__ void mma_16x8x8(double (&c)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A fragment of rows r0..r0+15, columns k0..k0+7 of a row-major tile s
// (row stride ld): A[r][c] = s[r * ld + c].
__device__ __forceinline__ void load_a_rows(double (&a)[4], const double* s,
                                            int ld, int r0, int k0, int g,
                                            int t) {
  const double* p = s + (r0 + g) * ld + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// A fragment whose tile is stored transposed: A[r][c] = s[c * ld + r].
__device__ __forceinline__ void load_a_cols(double (&a)[4], const double* s,
                                            int ld, int r0, int k0, int g,
                                            int t) {
  const double* p = s + (k0 + t) * ld + r0 + g;
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[4 * ld];
  a[3] = p[4 * ld + 8];
}

// B fragment (k0..k0+7) x (n0..n0+7) with B[k][n] = s[n * ld + k]: the rows
// of s are B's columns (the "TN" form: C = X Y^T for row-major X and Y).
__device__ __forceinline__ void load_b_rows(double (&b)[2], const double* s,
                                            int ld, int n0, int k0, int g,
                                            int t) {
  const double* p = s + (n0 + g) * ld + k0 + t;
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment with B[k][n] = s[k * ld + n] (B stored row-major).
__device__ __forceinline__ void load_b_cols(double (&b)[2], const double* s,
                                            int ld, int n0, int k0, int g,
                                            int t) {
  const double* p = s + (k0 + t) * ld + n0 + g;
  b[0] = p[0];
  b[1] = p[4 * ld];
}

// acc += A B over the first ks (a multiple of 8) columns of a k-slab held in
// shared memory, for one warp's (16 MI) x (8 NI) block at rows wm, columns
// wn of the block's output.  A is stored row by row, A[r][k] = sa[r * lda +
// k], or with AK k-major, A[r][k] = sa[k * lda + r]; B by its columns,
// B[k][n] = sb[n * ldb + k] (the "TN" form: C = X Y^T for X, Y stored by
// rows), or with BK k-major, B[k][n] = sb[k * ldb + n].  A caller that
// wants C -= A B subtracts acc in its epilogue.  Strides of 4 mod 16
// doubles keep all four loaders free of bank conflicts.
template <int MI, int NI, bool AK, bool BK>
__device__ __forceinline__ void mma_slab(double (&acc)[MI][NI][4],
                                         const double* sa, int lda,
                                         const double* sb, int ldb, int ks,
                                         int wm, int wn, int g, int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < ks; k0 += 8) {
    double a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (AK)
        load_a_cols(a[mi], sa, lda, wm + 16 * mi, k0, g, t);
      else
        load_a_rows(a[mi], sa, lda, wm + 16 * mi, k0, g, t);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if (BK)
        load_b_cols(b[ni], sb, ldb, wn + 8 * ni, k0, g, t);
      else
        load_b_rows(b[ni], sb, ldb, wn + 8 * ni, k0, g, t);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_16x8x8(acc[mi][ni], a[mi], b[ni]);
  }
}

// The pair row[col], row[col + 1] of a row of n values (zeros past n), and
// its store: one 16-byte access where vec (the row 16-byte aligned, col
// even) and both lie inside, else one access a value.
__device__ __forceinline__ double2 load_pair(const double* row, int col, int n,
                                             int vec) {
  if (vec && col + 1 < n) return *reinterpret_cast<const double2*>(row + col);
  double2 v = make_double2(0.0, 0.0);
  if (col < n) v.x = row[col];
  if (col + 1 < n) v.y = row[col + 1];
  return v;
}

__device__ __forceinline__ void store_pair(double* row, int col, int n, int vec,
                                           double x0, double x1) {
  if (vec && col + 1 < n) {
    *reinterpret_cast<double2*>(row + col) = make_double2(x0, x1);
    return;
  }
  if (col < n) row[col] = x0;
  if (col + 1 < n) row[col + 1] = x1;
}

// Asynchronous global -> shared copies (cp.async, Ampere and later) of one
// element (4 or 8 bytes) or of 16 bytes, which zero-fill when `ok` is
// false; the source address is then not read.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool ok) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "a 4- or 8-byte element");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)), "r"(ok ? (int)sizeof(T) : 0)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a ROWS x COLS tile of a row-major global matrix (row stride ld_src)
// into shared memory (row stride ld_dst), zero-filling rows >= rv and
// columns >= cv; issued by the NT threads of the block, tid = this thread's
// index.  The shape is fixed at compile time so that the index arithmetic is
// shifts.  With vec the copies are 16 bytes (V = 16 / sizeof(T) elements):
// cv, ld_src and ld_dst must be multiples of V and src 16-byte aligned.
template <int ROWS, int COLS, int NT, typename T>
__device__ __forceinline__ void cp_tile(T* dst, int ld_dst, const T* src,
                                        long long ld_src, int rv, int cv,
                                        bool vec, int tid) {
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T), HALF = COLS / V, N = ROWS * HALF;
#pragma unroll
    for (int e0 = 0; e0 < N; e0 += NT) {
      const int e = e0 + tid;
      if (N % NT == 0 || e < N) {
        const int r = e / HALF, c = V * (e % HALF);
        const bool ok = r < rv && c < cv;
        cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
      }
    }
  } else {
    constexpr int N = ROWS * COLS;
#pragma unroll 4
    for (int e0 = 0; e0 < N; e0 += NT) {
      const int e = e0 + tid;
      if (N % NT == 0 || e < N) {
        const int r = e / COLS, c = e % COLS;
        const bool ok = r < rv && c < cv;
        cp_async_elem(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
      }
    }
  }
}

// A ring of S stages of k-slabs fed by cp.async, so that the copies of the
// next S - 1 slabs are in flight while the current one multiplies.
// load(stage, slab) issues the cp.async copies of slab `slab` into stage
// `stage` (every thread of the block calls it); compute(stage, slab) reads
// that stage once it has landed.  Each slab is one commit group, empty
// past the last slab, so cp.async.wait_group S - 2 always waits for the
// slab about to be read (groups the caller committed before the ring only
// make the wait stricter).  A stage is refilled only after the barrier
// that follows every warp's reads of it.  On return all copies have landed
// and the block has passed a barrier, so the stages may be reused.
template <int S, typename Load, typename Compute>
__device__ __forceinline__ void cp_async_ring(int nslabs, Load load,
                                              Compute compute) {
  static_assert(S >= 2, "a ring needs two stages at least");
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nslabs) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int q = 0; q < nslabs; ++q) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = q + S - 1;
    if (next < nslabs) load(next % S, next);
    cp_async_commit();
    compute(q % S, q);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Programmatic dependent launch (Hopper): a kernel launched with
// launch_pdl may be scheduled while the previous kernel on the stream still
// runs; it calls grid_wait() before it touches memory that kernel writes,
// and grid_launch_dependents() to let the next kernel be scheduled early.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Streaming multiprocessors of the current device (132 on an H100 SXM), for
// the launchers' choices of tile size and grid; 1 if it cannot be read.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace dmma
