// Matérn correlation over a tensor of scaled distances (the GEN phase where
// the distances are given).
//
//   out[i] = amp * M_nu(u[i]),  any real nu > 0
//
// No Pallas counterpart: the reference evaluates it with jnp in while_loops
// (src/repro/core/matern.py::matern_correlation), and the port's plain
// version is kernels/ref.py::matern_corr_ref.  It is what build_sigma,
// build_c0 and build_correlation_matrix run on the card: the exact panel
// path (dist_exact_loglik), the dense oracle, simulate_mgrf and cokrige all
// build Sigma from precomputed distances, with no locations to hand to
// matern_tile.  Both instances of matern.cuh: halfint (nu in {1/2, 3/2, 5/2})
// and general.
//
// Bound on the card.  halfint: the bytes, one read and one write of
// itemsize each an element.  general: the FP64 operations of the
// per-element loops.
//
// Design.  A grid-stride loop over groups of kVec = 4 neighbouring elements:
// a thread reads its group with 16-byte vector loads, computes four values
// and writes them with 16-byte vector stores (when u and out are 16-byte
// aligned; element by element otherwise).  The grid covers the tensor, one
// group a thread: the general instance's threads take different numbers of
// steps, and short blocks let the card balance them (a grid of what the card
// holds at once, looping, took 0.2594 ms at the main path's panel of u, NVIDIA
// H100 80GB HBM3, 700 W, scripts/matern_kernels.py).  The exact path hands it
// 16384^2 = 268M elements, so indices are size_t.
#include "matern.cuh"

namespace {

using matern::GenArgs;

constexpr int kVec = 4;
constexpr int kThreads = 256;
// gridDim.x's limit; a larger tensor loops (grid-stride)
constexpr size_t kMaxBlocks = 2147483647;

template <typename T, int NU2, bool VEC>
__global__ void __launch_bounds__(kThreads)
    matern_corr_kernel(const T* __restrict__ u, T* __restrict__ out, size_t size,
                       T amp, GenArgs<T> g) {
  const size_t groups = size / kVec;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t v = tid; v < groups; v += stride) {
    T x[kVec];
    if (VEC) {
      matern::load4(u + v * kVec, x);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[k] = u[v * kVec + k];
    }
    if (NU2 != 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[k] = amp * matern::correlation<T, NU2>(x[k], g);
    } else {
#pragma unroll 1
      for (int k = 0; k < kVec; ++k) matern::shift_in(x, amp * matern::general(x[0], g));
    }
    if (VEC) {
      matern::store(out + v * kVec, x);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) out[v * kVec + k] = x[k];
    }
  }
  const size_t t = groups * kVec + tid;
  if (t < size) out[t] = amp * matern::correlation<T, NU2>(u[t], g);
}

template <typename T, int NU2, bool VEC>
cudaError_t launch_instance(const T* u, T* out, size_t size, T amp,
                            const GenArgs<T>& g, cudaStream_t stream) {
  const size_t groups = size / kVec;
  size_t blocks = (groups + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  blocks = blocks < 1 ? 1 : blocks;
  matern_corr_kernel<T, NU2, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      u, out, size, amp, g);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_vec(const T* u, T* out, size_t size, T amp, int nu2,
                       const GenArgs<T>& g, cudaStream_t stream) {
  switch (nu2) {
    case 0:
      return launch_instance<T, 0, VEC>(u, out, size, amp, g, stream);
    case 1:
      return launch_instance<T, 1, VEC>(u, out, size, amp, g, stream);
    case 3:
      return launch_instance<T, 3, VEC>(u, out, size, amp, g, stream);
    case 5:
      return launch_instance<T, 5, VEC>(u, out, size, amp, g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* u, T* out, size_t size, T amp, int nu2,
           const double* general_args, cudaStream_t stream) {
  if (size == 0) return 0;
  GenArgs<T> g = {};
  if (nu2 == 0) {
    if (general_args == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = matern::load_general(general_args, g, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(out)) % 16) == 0;
  const cudaError_t err = vec ? launch_vec<T, true>(u, out, size, amp, nu2, g, stream)
                              : launch_vec<T, false>(u, out, size, amp, nu2, g, stream);
  return (int)err;
}

}  // namespace

// u and out: ``size`` contiguous elements on the device.  nu2 = 2 nu in
// {1, 3, 5} runs the halfint instance; nu2 = 0 the general one, with
// general_args the host array of kernels/matern_tile.py::general_args
// (float64).  Returns the first CUDA error of the table copy or the launch
// (0 on success).
extern "C" int matern_corr_f64(const double* u, double* out, size_t size,
                               double amp, int nu2, const double* general_args,
                               void* stream) {
  return launch<double>(u, out, size, amp, nu2, general_args,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int matern_corr_f32(const float* u, float* out, size_t size, float amp,
                               int nu2, const double* general_args, void* stream) {
  return launch<float>(u, out, size, amp, nu2, general_args,
                       static_cast<cudaStream_t>(stream));
}
