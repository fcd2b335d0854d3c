// Matérn covariance tile, generated from two location panels (the GEN phase).
//
//   C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range),  nu in {1/2, 3/2, 5/2}
//
// Replaces the Pallas TPU kernel src/repro/kernels/matern_tile.py::matern_tile
// (body _matern_tile_kernel).
//
// Bound on the card: the output.  Each element costs about ten arithmetic
// operations (two differences, a fused square sum, sqrt, exp and the
// polynomial) against one store of n*m*itemsize bytes, so the kernel is bound
// by the 3.35 TB/s of device memory; in f64 the FP64 exp (a few dozen DP
// instructions) is the next limit.
//
// Design: one thread per output element on a 2-D grid over (n, m).  A block
// covers kRows x kCols outputs; its row and column coordinates are staged in
// shared memory once, and threadIdx.x runs along m so each warp writes a
// contiguous row segment (coalesced stores).  Any n and m are allowed: the
// ragged edge is masked, where the TPU kernel had to round its blocks down to
// divisors.  Distances use the difference form (a - b)^2: the
// |a|^2 + |b|^2 - 2 a.b form cancels at small distances, which are the
// near-diagonal entries that matter most.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;  // threads along m (one warp)
constexpr int kRows = 8;   // threads along n

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// Closed-form Matérn correlation for nu = NU2 / 2; M(0) = 1.
template <typename T, int NU2>
__device__ __forceinline__ T matern_halfint(T u) {
  if (u <= T(0)) return T(1);
  const T e = exp_(-u);
  if (NU2 == 1) return e;
  if (NU2 == 3) return (T(1) + u) * e;
  return (T(1) + u + u * u / T(3)) * e;
}

template <typename T, int NU2>
__global__ void __launch_bounds__(kCols * kRows)
    matern_tile_kernel(const T* __restrict__ la, const T* __restrict__ lb,
                       T* __restrict__ out, int n, int m, T inv_range, T amp) {
  __shared__ T sb[2 * kCols];
  __shared__ T sa[2 * kRows];
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  if (tid < 2 * kCols) {
    sb[tid] = (c0 + tid / 2 < m) ? lb[2 * (size_t)c0 + tid] : T(0);
  } else if (tid < 2 * kCols + 2 * kRows) {
    const int t = tid - 2 * kCols;
    sa[t] = (r0 + t / 2 < n) ? la[2 * (size_t)r0 + t] : T(0);
  }
  __syncthreads();
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r >= n || c >= m) return;
  const T dx = sa[2 * threadIdx.y] - sb[2 * threadIdx.x];
  const T dy = sa[2 * threadIdx.y + 1] - sb[2 * threadIdx.x + 1];
  const T d2 = dx * dx + dy * dy;
  const T u = sqrt_(d2 > T(0) ? d2 : T(0)) * inv_range;
  out[(size_t)r * m + c] = amp * matern_halfint<T, NU2>(u);
}

template <typename T>
int launch(const T* la, const T* lb, T* out, int n, int m, T inv_range, T amp,
           int nu2, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 block(kCols, kRows);
  const dim3 grid((m + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  switch (nu2) {
    case 1:
      matern_tile_kernel<T, 1><<<grid, block, 0, stream>>>(la, lb, out, n, m,
                                                           inv_range, amp);
      break;
    case 3:
      matern_tile_kernel<T, 3><<<grid, block, 0, stream>>>(la, lb, out, n, m,
                                                           inv_range, amp);
      break;
    case 5:
      matern_tile_kernel<T, 5><<<grid, block, 0, stream>>>(la, lb, out, n, m,
                                                           inv_range, amp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// locs_a (n, 2), locs_b (m, 2), out (n, m): contiguous, row-major, on the
// device.  nu2 = 2 * nu in {1, 3, 5}.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int matern_tile_f64(const double* la, const double* lb, double* out,
                               int n, int m, double inv_range, double amp,
                               int nu2, void* stream) {
  return launch<double>(la, lb, out, n, m, inv_range, amp, nu2,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int matern_tile_f32(const float* la, const float* lb, float* out,
                               int n, int m, float inv_range, float amp,
                               int nu2, void* stream) {
  return launch<float>(la, lb, out, n, m, inv_range, amp, nu2,
                       static_cast<cudaStream_t>(stream));
}
