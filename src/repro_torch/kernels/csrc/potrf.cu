// POTRF: batched lower Cholesky factor of SPD tiles,
//
//   out[b] = L  with  L L^T = a[b],  L lower triangular, zeros above,
//
// batched over b, a and out of shape (B, nb, nb).  Replaces the Pallas TPU
// kernel src/repro/kernels/chol_tiles.py::potrf (body _potrf_kernel).  On the
// TLR Cholesky path it is the panel-head POTRF of every panel step and the
// POTRF of the last diagonal tile.
//
// Failure: where a pivot is not positive or not finite, the whole tile of
// out becomes NaN (what jnp.linalg.cholesky gives, and what the plain
// version kernels/ref.py::potrf_ref gives), so the factorization status and
// the sentinel log-likelihood see it.  Only the lower triangle of a[b] is
// read.
//
// Bound on the card: nb^3 / 3 FMAs against 2 nb^2 itemsize bytes; at
// nb = 512 in f64 the bytes (4.2 MB, 1.25 us at 3.35 TB/s) bound it.  Each
// tile is a chain of nb dependent pivots, so this simple kernel gives one
// block to a tile and is bound by that block's FMA and shared-memory rate
// instead; a multi-block or tensor-core form is later work.
//
// Design (right-looking, blocked by kPanel = 32 columns).  The TPU kernel
// held the whole tile in VMEM and did nb masked rank-1 updates; an f64 tile
// of nb = 512 is 2 MiB, far above a block's 227 KB of shared memory, so here
// the tile is copied to out once and factored in place there (it stays in
// the 50 MB L2).  For each 32-column panel:
//   1. the diagonal block goes to shared memory and is factored unblocked;
//      a bad pivot sets a flag that ends the loop;
//   2. the rows below solve against it (each thread owns rows, the 32
//      values of a row in registers);
//   3. the trailing lower triangle takes the rank-32 update, in 64 x 64
//      output tiles whose two 64 x 32 panel slices are staged in shared
//      memory; each of the 256 threads owns a 4 x 4 set of outputs.
// Sums run in the input type, which is at least f32 (the Pallas kernel's
// promote_types(dtype, f32)).  Any nb >= 1 works: the ragged last panel is
// padded with the identity in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 32;   // panel width
constexpr int kOut = 64;     // trailing-update output tile edge
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    potrf_kernel(const T* __restrict__ a, T* __restrict__ out, int nb) {
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

template <typename T>
int launch(const T* a, T* out, int batch, int nb, cudaStream_t stream) {
  if (batch <= 0 || nb <= 0 || (long long)nb * nb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  potrf_kernel<T><<<batch, kThreads, 0, stream>>>(a, out, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// a, out (batch, nb, nb), contiguous, row-major, on the device; out may not
// alias a.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int potrf_f64(const double* a, double* out, int batch, int nb,
                         void* stream) {
  return launch<double>(a, out, batch, nb, static_cast<cudaStream_t>(stream));
}

extern "C" int potrf_f32(const float* a, float* out, int batch, int nb,
                         void* stream) {
  return launch<float>(a, out, batch, nb, static_cast<cudaStream_t>(stream));
}
