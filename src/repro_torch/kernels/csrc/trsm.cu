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
// batch.  Only the lower triangle of L is read.
//
// Bound on the card: nb^2 r FMAs against (nb^2 + 2 nb r) itemsize bytes per
// tile; at the panel TRSM (nb = 512, r = 63 x 128, f64) the operations bound
// it (2.1 GFLOP, 32 us at 67 TFLOP/s), at r = 1 the bytes.  This simple
// kernel runs on the FP64 CUDA cores, one block per (tile, 32 columns).
//
// Design.  The TPU kernel held L and all of B in VMEM and did nb row
// updates.  Here a block owns `rc` (<= 32) columns of one tile's right-hand
// side; those columns, nb x rc, live in dynamic shared memory for the whole
// solve (512 x 32 f64 is 128 KB; the wrapper halves rc until nb x rc fits).
// L streams from global memory (L2) in 32 x 32 blocks.  For each block row
// i0 of 32 rows:
//   1. X[i0:i0+32] -= L[i0:i0+32, 0:i0] X[0:i0], a small GEMM whose L blocks
//      are staged in shared memory; each thread owns up to 4 outputs;
//   2. the 32 x 32 diagonal block of L goes to shared memory (a ragged last
//      block is padded with the identity) and each of the first rc threads
//      forward-substitutes its own column with the 32 values in registers.
// Sums run in the input type, which is at least f32 (the Pallas kernel's
// promote_types(dtype, f32)).  Any nb >= 1 and r >= 1 work.
#include <cuda_runtime.h>

namespace {

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
// (batch, nb, r); all contiguous, row-major, on the device.  rc (1..32) is
// the number of right-hand-side columns one block solves; nb * rc elements
// must fit in a block's shared memory.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int trsm_f64(const double* lo, const double* b, double* out,
                        int batch, int nb, int r, int rc, int lo_batch,
                        void* stream) {
  return launch<double>(lo, b, out, batch, nb, r, rc, lo_batch,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int trsm_f32(const float* lo, const float* b, float* out,
                        int batch, int nb, int r, int rc, int lo_batch,
                        void* stream) {
  return launch<float>(lo, b, out, batch, nb, r, rc, lo_batch,
                       static_cast<cudaStream_t>(stream));
}
