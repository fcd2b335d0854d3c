// Matérn covariance tile, generated from two location panels (the GEN phase).
//
//   C[r, c] = amp * M_nu(||a_r - b_c|| * inv_range),  any real nu > 0
//
// Replaces the Pallas TPU kernel src/repro/kernels/matern_tile.py::matern_tile
// (body _matern_tile_kernel), which takes nu in {1/2, 3/2, 5/2} only: the
// reference left general orders on the XLA path (core/matern.kv), a loop
// that does not suit the TPU's vector unit.  Here the instance halfint keeps
// the closed forms and the instance general evaluates K_nu per element
// (matern.cuh), so every order of the GEN phase runs in this kernel.
//
// Bound on the card.  halfint: the output, n * m * itemsize bytes written
// once (about ten arithmetic operations an element, exp and sqrt counted as
// one, against 8 bytes in f64); the FP64 exp, a few dozen DP instructions, is
// the next limit.  general: the FP64 operations of the per-element loops
// (a few hundred an element at the paths' distances), far above the bytes.
//
// Design.  A thread computes the columns of one 16-byte vector of a row (2
// in f64, 4 in f32) and writes them with one vector store; a warp covers 64
// f64 columns of a row, 512 contiguous bytes.  Its column locations are read
// straight into registers; a block is 32 x 4 threads, and the grid has one
// block for each 4 rows and 32 vectors of columns: short blocks, no shared
// memory, no barrier (the rows loop only past gridDim.y's limit).  Measured
// against other shapes by scripts/matern_tile_variants.py (NVIDIA H100 80GB
// HBM3, 700 W, f64 at the main path's 16128 x 256 panel, nu = 1.5): 4 f64
// columns a thread, 8 rows a block and a grid of what the card holds at once
// (looping over the rows) were 5%, 3% and 4% slower, 2 rows a block 19%;
// the general instance was 25% slower on that grid.  The halfint instance is
// held back by its dependent FP64 chain (sqrt, exp, the polynomial) more
// than by the stores: a fill of the same output takes 55% of its time, and
// without the exp it takes 83%, so it takes exp_neg (matern.cuh), which has
// about half the CUDA exp's dependent operations (the CUDA exp: 3% slower).
// A general thread turns its columns round one at a time
// (matern::shift_in), so they stay in registers.  Any n and m are allowed:
// the ragged edge is stored element by element, and so are rows whose start
// is not aligned to the vector (m odd in f64, m % 4 != 0 in f32).  Distances
// use the difference form (a - b)^2: the |a|^2 + |b|^2 - 2 a.b form cancels
// at small distances, which are the near-diagonal entries that matter most.
#include "matern.cuh"

namespace {

using matern::GenArgs;

// The shape of the work (scripts/matern_tile_variants.py builds and times
// copies of this source with other values): a thread's columns fill one
// 16-byte vector, a block is kCols x kRows threads.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // columns a thread
constexpr int kCols = 32;                  // threads along m
constexpr int kRows = 4;                   // threads along n
static_assert(kVec<double> % 2 == 0, "the vector store takes column pairs");

template <typename T, int NU2, bool VEC>
__global__ void __launch_bounds__(kCols * kRows)
    matern_tile_kernel(const T* __restrict__ la, const T* __restrict__ lb,
                       T* __restrict__ out, int n, int m, T inv_range, T amp,
                       GenArgs<T> g) {
  using Pair = typename matern::Vec<T>::pair;
  const int c0 = (blockIdx.x * kCols + threadIdx.x) * kVec<T>;
  if (c0 >= m) return;
  const int nc = min(kVec<T>, m - c0);
  T bx[kVec<T>], by[kVec<T>];
#pragma unroll
  for (int k = 0; k < kVec<T>; ++k) {
    const Pair b = k < nc ? __ldg(reinterpret_cast<const Pair*>(lb) + c0 + k) : Pair{};
    bx[k] = b.x;
    by[k] = b.y;
  }
  for (int r = blockIdx.y * kRows + threadIdx.y; r < n; r += gridDim.y * kRows) {
    const Pair a = __ldg(reinterpret_cast<const Pair*>(la) + r);
    T v[kVec<T>];
    if (NU2 != 0) {
#pragma unroll
      for (int k = 0; k < kVec<T>; ++k) {
        const T dx = a.x - bx[k], dy = a.y - by[k];
        const T d2 = dx * dx + dy * dy;
        const T u = matern::sqrt_(d2 > T(0) ? d2 : T(0)) * inv_range;
        v[k] = amp * matern::correlation<T, NU2>(u, g);
      }
    } else {
      // one element a step, bx and by turned round once (back in order
      // after kVec<T> steps), v filled from the back
#pragma unroll 1
      for (int k = 0; k < kVec<T>; ++k) {
        const T dx = a.x - bx[0], dy = a.y - by[0];
        const T d2 = dx * dx + dy * dy;
        const T u = matern::sqrt_(d2 > T(0) ? d2 : T(0)) * inv_range;
        matern::shift_in(bx, bx[0]);
        matern::shift_in(by, by[0]);
        matern::shift_in(v, amp * matern::general(u, g));
      }
    }
    T* o = out + (size_t)r * m + c0;
    if (VEC && nc == kVec<T>) {
      matern::store(o, v);
    } else {
#pragma unroll
      for (int k = 0; k < kVec<T>; ++k)
        if (k < nc) o[k] = v[k];
    }
  }
}

template <typename T, int NU2, bool VEC>
cudaError_t launch_instance(const T* la, const T* lb, T* out, int n, int m,
                            T inv_range, T amp, const GenArgs<T>& g,
                            cudaStream_t stream) {
  const unsigned gx = (unsigned)((m + kCols * kVec<T> - 1) / (kCols * kVec<T>));
  const unsigned rows = (unsigned)((n + kRows - 1) / kRows);
  // one block a group of kRows rows; past gridDim.y's limit the rows loop
  const unsigned gy = rows < 65535u ? rows : 65535u;
  matern_tile_kernel<T, NU2, VEC><<<dim3(gx, gy), dim3(kCols, kRows), 0, stream>>>(
      la, lb, out, n, m, inv_range, amp, g);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(const T* la, const T* lb, T* out, int n, int m,
                       T inv_range, T amp, int nu2, const GenArgs<T>& g,
                       cudaStream_t stream) {
  switch (nu2) {
    case 0:
      return launch_instance<T, 0, VEC>(la, lb, out, n, m, inv_range, amp, g, stream);
    case 1:
      return launch_instance<T, 1, VEC>(la, lb, out, n, m, inv_range, amp, g, stream);
    case 3:
      return launch_instance<T, 3, VEC>(la, lb, out, n, m, inv_range, amp, g, stream);
    case 5:
      return launch_instance<T, 5, VEC>(la, lb, out, n, m, inv_range, amp, g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* la, const T* lb, T* out, int n, int m, T inv_range, T amp,
           int nu2, const double* general_args, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return 0;
  GenArgs<T> g = {};
  if (nu2 == 0) {
    if (general_args == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = matern::load_general(general_args, g, stream);
    if (err != cudaSuccess) return (int)err;
  }
  // row starts aligned to the vector store: m a multiple of its length in T
  const bool vec = m % kVec<T> == 0;
  const cudaError_t err =
      vec ? launch_vec<T, true>(la, lb, out, n, m, inv_range, amp, nu2, g, stream)
          : launch_vec<T, false>(la, lb, out, n, m, inv_range, amp, nu2, g, stream);
  return (int)err;
}

}  // namespace

// locs_a (n, 2), locs_b (m, 2), out (n, m): contiguous, row-major, on the
// device, the panels aligned to one location (2 * sizeof(T) bytes) and out
// to 16 bytes.  nu2 = 2 nu in {1, 3, 5} runs the halfint instance; nu2 = 0
// the general one, with general_args the host array of
// kernels/matern_tile.py::general_args (float64).  Returns the first CUDA
// error of the table copy or the launch (0 on success).
extern "C" int matern_tile_f64(const double* la, const double* lb, double* out,
                               int n, int m, double inv_range, double amp,
                               int nu2, const double* general_args, void* stream) {
  return launch<double>(la, lb, out, n, m, inv_range, amp, nu2, general_args,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int matern_tile_f32(const float* la, const float* lb, float* out,
                               int n, int m, float inv_range, float amp,
                               int nu2, const double* general_args, void* stream) {
  return launch<float>(la, lb, out, n, m, inv_range, amp, nu2, general_args,
                       static_cast<cudaStream_t>(stream));
}
