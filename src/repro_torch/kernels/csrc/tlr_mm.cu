// TLR matrix-matrix multiply (TLR-MM, the paper's dominant kernel, §5.3):
//
//   out[b] = acc[b] - U_a[b] (V_a[b]^T V_b[b]) U_b[b]^T
//
// batched over b, with U, V of shape (B, nb, k) and acc, out (B, nb, nb).
// Replaces the Pallas TPU kernel src/repro/kernels/tlr_mm.py::tlr_mm (body
// _tlr_mm_kernel).  On the TLR Cholesky path it is the SYRK onto the trailing
// diagonal tiles, with a = b.
//
// Bound on the card: 2 B (nb k^2 + nb k^2 + nb^2 k) operations against
// (4 nb k + 2 nb^2) B itemsize bytes.  At the panel shapes (nb = 512,
// k = 128, f64) that is about 85 operations per byte, above the FP64 balance
// point of the card, so the arithmetic bounds it; these CUDA-core FMAs reach
// a fraction of the FP64 tensor-core rate (wgmma/DMMA is later work).
//
// Design, in two launches:
//   stage 1  W[b] = V_a[b]^T V_b[b] (k x k), one block per (b, 64x64 tile
//            of W), reduced over nb in chunks of 16 staged in shared memory;
//            W goes to a scratch buffer the caller allocates.
//   stage 2  one block per (b, 64-row panel of out): T = U_a[rows] W is
//            formed once into dynamic shared memory (64 k elements: 64 KB in
//            f64 at k = 128, above the 48 KB static limit, hence the
//            attribute), then out[rows, :] = acc - T U_b^T sweeps the
//            column tiles reading T from shared memory.
// Every block has 256 threads as 16 x 16; a thread owns a 4 x 4 set of
// outputs, rows ty + 16 i and columns tx + 16 j, so the shared-memory reads
// of a warp are broadcasts or consecutive.  Sums run in the input type, which
// is at least f32 (the Pallas kernel's promote_types(dtype, f32)).  Loads
// beyond nb or k read zero, so zero-padded rank columns add exact zeros.
#include <cuda_runtime.h>

namespace {

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
                      const T* __restrict__ w, const T* __restrict__ acc_in,
                      T* __restrict__ out, int nb, int k) {
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

template <typename T>
int launch(const T* ua, const T* va, const T* ub, const T* vb, const T* acc,
           T* w, T* out, int batch, int nb, int k, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(16, 16);
  const int kt = (k + kTile - 1) / kTile;
  tlr_mm_w_kernel<T><<<dim3(kt, kt, batch), block, 0, stream>>>(va, vb, w, nb,
                                                               k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kTile * k * sizeof(T);
  err = cudaFuncSetAttribute(tlr_mm_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + kTile - 1) / kTile, batch);
  tlr_mm_out_kernel<T><<<grid, block, smem, stream>>>(ua, ub, w, acc, out, nb,
                                                      k);
  return (int)cudaGetLastError();
}

}  // namespace

// ua, va, ub, vb (batch, nb, k); acc, out (batch, nb, nb); w is scratch of
// (batch, k, k).  All contiguous, row-major, on the device.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int tlr_mm_f64(const double* ua, const double* va, const double* ub,
                          const double* vb, const double* acc, double* w,
                          double* out, int batch, int nb, int k,
                          void* stream) {
  return launch<double>(ua, va, ub, vb, acc, w, out, batch, nb, k,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int tlr_mm_f32(const float* ua, const float* va, const float* ub,
                          const float* vb, const float* acc, float* w,
                          float* out, int batch, int nb, int k, void* stream) {
  return launch<float>(ua, va, ub, vb, acc, w, out, batch, nb, k,
                       static_cast<cudaStream_t>(stream));
}
