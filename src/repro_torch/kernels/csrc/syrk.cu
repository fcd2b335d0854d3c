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
// computed once per 64 x 64 block tile of the lower triangle (tile row >=
// tile column); an off-diagonal tile writes both out[I, J] = C[I, J] - P_IJ
// and out[J, I] = C[J, I] - P_IJ^T.  C is read in full, so the result is
// C - A A^T for any C, symmetric or not, as the reference returns it.
//
// Bound on the card: nb (nb + 1) / 2 * k FMAs against (2 nb^2 + nb k)
// itemsize bytes per matrix.  At the first step of the exact path
// (nb = 32256, k = 512, f64) the operations bound it: 5.3e11 flops, 8 ms at
// 67 TFLOP/s, against 16.8 GB, 5 ms at 3.35 TB/s.  This simple kernel runs
// on the FP64 CUDA cores (34 TFLOP/s); the DMMA tensor cores, TMA and
// wgmma are later work.
//
// Design.  The TPU kernel is one MXU matmul per (nb, nb) tile held in VMEM.
// Here one block of 256 threads owns one 64 x 64 output tile of the lower
// triangle (a 1-D grid over those tiles, the batch on grid.y).  The k
// dimension is walked in chunks of 32: the two 64 x 32 row slabs of A
// (rows of tile I and of tile J) are staged in shared memory, k-major, and
// each thread accumulates a 4 x 4 set of outputs (rows ty + 16 i, columns
// tx + 16 j) in registers.  The transposed write goes through shared memory
// so both writes are coalesced.  C may be a row-strided view (the trailing
// block of the previous trail: no copy of it is made); A may be row-major
// or column-major (the TRSM's output, transposed).  Offsets are 64-bit.
// Sums run in the input type, which is at least f32 (the Pallas kernel's
// promote_types(dtype, f32)).  Any nb >= 1 and k >= 0 work.
#include <cuda_runtime.h>

namespace {

constexpr int kOut = 64;      // output tile edge
constexpr int kK = 32;        // k chunk staged in shared memory
constexpr int kThreads = 256;
constexpr int kLd = kOut + 1;  // padded row of a staged slab

template <typename T>
__device__ __forceinline__ void load_slab(T* __restrict__ s,
                                          const T* __restrict__ A, int r0,
                                          int k0, int nb, int k,
                                          long long a_rs, long long a_cs,
                                          int tid) {
  // s[q][r] = A[r0 + r, k0 + q], zero outside the matrix.  Consecutive
  // threads walk the unit-stride dimension of A.
  if (a_cs == 1) {
    for (int e = tid; e < kOut * kK; e += kThreads) {
      const int r = e / kK, q = e % kK;
      const int gr = r0 + r, gq = k0 + q;
      s[q * kLd + r] =
          (gr < nb && gq < k) ? A[(long long)gr * a_rs + gq] : T(0);
    }
  } else {
    for (int e = tid; e < kOut * kK; e += kThreads) {
      const int q = e / kOut, r = e % kOut;
      const int gr = r0 + r, gq = k0 + q;
      s[q * kLd + r] = (gr < nb && gq < k)
                           ? A[(long long)gr * a_rs + (long long)gq * a_cs]
                           : T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    syrk_kernel(const T* __restrict__ c, const T* __restrict__ a,
                T* __restrict__ out, int nb, int k, long long c_bs,
                long long c_rs, long long a_bs, long long a_rs,
                long long a_cs) {
  // Two k-major slabs during the k loop; the transposed tile afterwards.
  __shared__ T smem[2 * kK * kLd];
  static_assert(2 * kK * kLd >= kOut * kLd, "transpose buffer too small");
  T* sa = smem;
  T* sb = smem + kK * kLd;

  // Lower-triangle tile t -> (ti, tj), tj <= ti, row-major over the triangle.
  const long long t = blockIdx.x;
  long long ti = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const long long tj = t - ti * (ti + 1) / 2;
  const int r0 = (int)ti * kOut, c0 = (int)tj * kOut;

  const T* C = c + (long long)blockIdx.y * c_bs;
  const T* A = a + (long long)blockIdx.y * a_bs;
  T* O = out + (long long)blockIdx.y * nb * (long long)nb;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += kK) {
    load_slab(sa, A, r0, k0, nb, k, a_rs, a_cs, tid);
    load_slab(sb, A, c0, k0, nb, k, a_rs, a_cs, tid);
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kK; ++q) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[q * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[q * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // out[I, J] = C[I, J] - P_IJ.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + tx + 16 * j;
      if (cc < nb)
        O[(long long)r * nb + cc] = C[(long long)r * c_rs + cc] - acc[i][j];
    }
  }
  if (ti == tj) return;  // a diagonal tile wrote its whole square above

  // out[J, I] = C[J, I] - P_IJ^T, staged so that the writes are coalesced:
  // st[cl][rl] = P[rl][cl] (rl, cl local to the tile).
  T* st = smem;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[(tx + 16 * j) * kLd + ty + 16 * i] = acc[i][j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = c0 + ty + 16 * i;  // a row of tile J
    if (r >= nb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = r0 + tx + 16 * j;  // a column of tile I
      if (cc < nb)
        O[(long long)r * nb + cc] =
            C[(long long)r * c_rs + cc] - st[(ty + 16 * i) * kLd + tx + 16 * j];
    }
  }
}

template <typename T>
int launch(const T* c, const T* a, T* out, int batch, int nb, int k,
           long long c_bs, long long c_rs, long long a_bs, long long a_rs,
           long long a_cs, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const long long side = (nb + kOut - 1) / kOut;
  const long long tiles = side * (side + 1) / 2;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, batch);
  syrk_kernel<T><<<grid, kThreads, 0, stream>>>(c, a, out, nb, k, c_bs, c_rs,
                                                a_bs, a_rs, a_cs);
  return (int)cudaGetLastError();
}

}  // namespace

// c (batch, nb, nb) with element (b, r, s) at c[b * c_bs + r * c_rs + s];
// a (batch, nb, k) with element (b, r, q) at a[b * a_bs + r * a_rs + q * a_cs]
// (a_cs == 1 or a_rs == 1); out (batch, nb, nb) contiguous; all on the
// device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int syrk_f64(const double* c, const double* a, double* out,
                        int batch, int nb, int k, long long c_bs,
                        long long c_rs, long long a_bs, long long a_rs,
                        long long a_cs, void* stream) {
  return launch<double>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int syrk_f32(const float* c, const float* a, float* out, int batch,
                        int nb, int k, long long c_bs, long long c_rs,
                        long long a_bs, long long a_rs, long long a_cs,
                        void* stream) {
  return launch<float>(c, a, out, batch, nb, k, c_bs, c_rs, a_bs, a_rs, a_cs,
                       static_cast<cudaStream_t>(stream));
}
