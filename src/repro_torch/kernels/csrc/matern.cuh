// The Matérn correlation M_nu(u) on one element, shared by matern_tile.cu
// (a covariance tile from two location panels) and matern_corr.cu (an
// elementwise pass over scaled distances).
//
//   M_nu(u) = u^nu K_nu(u) / (2^(nu-1) Gamma(nu)),  M_nu(0) = 1
//
// Two instances:
//   halfint  nu in {1/2, 3/2, 5/2} (NU2 = 2 nu in {1, 3, 5}): the closed
//            forms, exp and a polynomial.
//   general  any real nu > 0 (NU2 = 0): K_nu by the algorithm of
//            src/repro_torch/core/matern.py::kv (Numerical Recipes' bessik):
//            nu = nl + mu with |mu| <= 1/2; K_mu and K_{mu+1} by Temme's
//            series for x <= 2 or Steed's CF2 for x > 2; nl upward
//            recurrences.  Each element stops at its own convergence, with the
//            plain version's tests (|delk| < |ksum| eps; |dels / sn| < eps,
//            here |dels| < eps |sn|), so it sums the terms that the plain
//            version's frozen accumulators sum.  The plain version runs every
//            element until the slowest one has converged and reads the
//            convergence flag on the host at every step; a thread runs its
//            element's own count (about 20 steps at the geostat paths'
//            distances), so general orders cost a few hundred FP64
//            operations an element and no host round trip.
//
// What depends on nu alone is computed on the host once a launch, in
// float64, by src/repro_torch/kernels/matern_tile.py::general_args: the
// scalars (nu, mu, nl, gam1, gam2, gampl, gammi, fact = pi mu / sin pi mu,
// lognorm = (nu - 1) log 2 + lgamma nu) are passed by value, and the
// reciprocals that the recurrences divide by (1 / i, 1 / (i^2 - mu^2),
// 1 / (i - mu), 1 / (i + mu) and CF2's 1 / a_i) go into a table in
// __constant__ memory, copied on the launch's stream before the kernel.  An
// FP64 division is a long instruction sequence on this card: with the
// tables each Temme step is products only, and each CF2 step has one
// division (d = 1 / (b + a d), which depends on x).  All lanes of a warp that
// are still iterating read the same entry, so the reads are broadcasts.
// Steps past the table's end (none at the paths' distances: CF2 takes at
// most 76 steps there, at x just above 2) divide instead.  The tables are
// per translation unit and per launch: launches of one source that run
// concurrently on two streams with two orders would race on them (the port
// launches on one stream).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <type_traits>

namespace matern {

// Layout of the host array of general_args (float64): kScalars scalars,
// then kTables tables of kTable entries (entry 0 unused).
constexpr int kScalars = 9;
constexpr int kTable = 128;
constexpr int kTables = 5;
enum Table { kInvI = 0, kInvDen = 1, kInvIMinusMu = 2, kInvIPlusMu = 3, kInvA = 4 };
// The plain version's iteration limits.
constexpr int kTemmeMax = 200;
constexpr int kCf2Max = 400;

template <typename T>
struct GenArgs {
  T nu, mu, gam1, gam2, gampl, gammi, fact, lognorm;
  int nl;
};

// The tables, and the functions that read or fill them, are internal to each
// source that includes this header: a template of external linkage that
// named them would be merged across sources by the linker, and fill one
// source's tables for the kernels of another.
namespace {
__constant__ double c_table_f64[kTables][kTable];
__constant__ float c_table_f32[kTables][kTable];

__device__ __forceinline__ double table(double, int t, int i) { return c_table_f64[t][i]; }
__device__ __forceinline__ float table(float, int t, int i) { return c_table_f32[t][i]; }

// The scalars of a general launch into ``g`` and its tables into the
// __constant__ table of this translation unit, on ``stream``.  ``host`` is
// general_args' array.  The copy is from pageable memory, which CUDA stages
// before the call returns.
template <typename T>
cudaError_t load_general(const double* host, GenArgs<T>& g, cudaStream_t stream) {
  g.nu = T(host[0]);
  g.mu = T(host[1]);
  g.nl = int(host[2]);
  g.gam1 = T(host[3]);
  g.gam2 = T(host[4]);
  g.gampl = T(host[5]);
  g.gammi = T(host[6]);
  g.fact = T(host[7]);
  g.lognorm = T(host[8]);
  T tab[kTables * kTable];
  for (int k = 0; k < kTables * kTable; ++k) tab[k] = T(host[kScalars + k]);
  if constexpr (std::is_same<T, double>::value) {
    return cudaMemcpyToSymbolAsync(c_table_f64, tab, sizeof(tab), 0,
                                   cudaMemcpyHostToDevice, stream);
  } else {
    return cudaMemcpyToSymbolAsync(c_table_f32, tab, sizeof(tab), 0,
                                   cudaMemcpyHostToDevice, stream);
  }
}
}  // namespace

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sinh_(float x) { return sinhf(x); }
__device__ __forceinline__ double sinh_(double x) { return sinh(x); }
__device__ __forceinline__ float cosh_(float x) { return coshf(x); }
__device__ __forceinline__ double cosh_(double x) { return cosh(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// exp(-u) for u >= 0 in twelve FP64 operations, for the closed forms:
// -u = (64 k + j) ln2 / 64 + r with |r| <= ln2 / 128, and exp(-u) =
// 2^k 2^(j/64) e^r, e^r by its Taylor polynomial of degree 5 (truncation
// below 4e-17 relative).  Within 2 ulp of the exact value (the CUDA exp
// within 1); about half the dependent FP64 operations of the CUDA exp, whose
// chain sets the halfint tile's time.  u > 708, where exp(-u) < 3e-308, gives
// 0; NaN gives NaN.  f32 keeps expf.
constexpr double kLog2eBy64 = 0x1.71547652b82fep+6;    // 64 / ln 2
constexpr double kLn2By64Hi = 0x1.62e42fefa39efp-7;    // ln 2 / 64, rounded
constexpr double kLn2By64Lo = 0x1.abc9e3b39803fp-62;   // the rest of ln 2 / 64
constexpr double kRoundShift = 0x1.8p+52;              // adding it rounds to an integer
// 2^(j / 64), j = 0..63, correctly rounded (internal to each source)
namespace {
__device__ const double kExp2By64[64] = {
    0x1.0000000000000p+0, 0x1.02c9a3e778061p+0, 0x1.059b0d3158574p+0, 0x1.0874518759bc8p+0,
    0x1.0b5586cf9890fp+0, 0x1.0e3ec32d3d1a2p+0, 0x1.11301d0125b51p+0, 0x1.1429aaea92de0p+0,
    0x1.172b83c7d517bp+0, 0x1.1a35beb6fcb75p+0, 0x1.1d4873168b9aap+0, 0x1.2063b88628cd6p+0,
    0x1.2387a6e756238p+0, 0x1.26b4565e27cddp+0, 0x1.29e9df51fdee1p+0, 0x1.2d285a6e4030bp+0,
    0x1.306fe0a31b715p+0, 0x1.33c08b26416ffp+0, 0x1.371a7373aa9cbp+0, 0x1.3a7db34e59ff7p+0,
    0x1.3dea64c123422p+0, 0x1.4160a21f72e2ap+0, 0x1.44e086061892dp+0, 0x1.486a2b5c13cd0p+0,
    0x1.4bfdad5362a27p+0, 0x1.4f9b2769d2ca7p+0, 0x1.5342b569d4f82p+0, 0x1.56f4736b527dap+0,
    0x1.5ab07dd485429p+0, 0x1.5e76f15ad2148p+0, 0x1.6247eb03a5585p+0, 0x1.6623882552225p+0,
    0x1.6a09e667f3bcdp+0, 0x1.6dfb23c651a2fp+0, 0x1.71f75e8ec5f74p+0, 0x1.75feb564267c9p+0,
    0x1.7a11473eb0187p+0, 0x1.7e2f336cf4e62p+0, 0x1.82589994cce13p+0, 0x1.868d99b4492edp+0,
    0x1.8ace5422aa0dbp+0, 0x1.8f1ae99157736p+0, 0x1.93737b0cdc5e5p+0, 0x1.97d829fde4e50p+0,
    0x1.9c49182a3f090p+0, 0x1.a0c667b5de565p+0, 0x1.a5503b23e255dp+0, 0x1.a9e6b5579fdbfp+0,
    0x1.ae89f995ad3adp+0, 0x1.b33a2b84f15fbp+0, 0x1.b7f76f2fb5e47p+0, 0x1.bcc1e904bc1d2p+0,
    0x1.c199bdd85529cp+0, 0x1.c67f12e57d14bp+0, 0x1.cb720dcef9069p+0, 0x1.d072d4a07897cp+0,
    0x1.d5818dcfba487p+0, 0x1.da9e603db3285p+0, 0x1.dfc97337b9b5fp+0, 0x1.e502ee78b3ff6p+0,
    0x1.ea4afa2a490dap+0, 0x1.efa1bee615a27p+0, 0x1.f50765b6e4540p+0, 0x1.fa7c1819e90d8p+0};
}  // namespace

__device__ __forceinline__ double exp_neg(double u) {
  if (u > 708.0) return 0.0;
  const double t = fma(-u, kLog2eBy64, kRoundShift);
  const int n = __double2loint(t);
  const double nd = t - kRoundShift;
  double r = fma(nd, -kLn2By64Hi, -u);
  r = fma(nd, -kLn2By64Lo, r);
  double p = fma(r, 1.0 / 120, 1.0 / 24);
  p = fma(p, r, 1.0 / 6);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  const double s = __ldg(&kExp2By64[n & 63]) * p;
  return s * __hiloint2double((1023 + (n >> 6)) << 20, 0);
}
__device__ __forceinline__ float exp_neg(float u) { return expf(-u); }

template <typename T>
__device__ __forceinline__ T eps() {
  return std::is_same<T, double>::value ? T(DBL_EPSILON) : T(FLT_EPSILON);
}

// Closed-form Matérn correlation for nu = NU2 / 2; M(0) = 1.
template <typename T, int NU2>
__device__ __forceinline__ T halfint(T u) {
  if (u <= T(0)) return T(1);
  const T e = exp_neg(u);
  if (NU2 == 1) return e;
  if (NU2 == 3) return (T(1) + u) * e;
  return (T(1) + u + u * u * T(1.0 / 3)) * e;
}

// K_mu(x) and K_{mu+1}(x) for 0 < x <= 2 (Temme's series).
template <typename T>
__device__ __forceinline__ void temme(T x, const GenArgs<T>& g, T& rkmu, T& rk1) {
  const T mu = g.mu;
  const T x2 = T(0.5) * x;
  const T d = -log_(x2);
  const T e = mu * d;
  const T fact2 = abs_(e) < T(1e-12) ? T(1) : sinh_(e) / e;
  T ff = g.fact * (g.gam1 * cosh_(e) + g.gam2 * fact2 * d);
  const T ee = exp_(e);
  T p = T(0.5) * ee / g.gampl;
  T q = T(0.5) / (ee * g.gammi);
  T c = T(1);
  const T d2 = x2 * x2;
  T ksum = ff, ksum1 = p;
  for (int i = 1; i <= kTemmeMax; ++i) {
    const T fi = T(i);
    T r_i, r_den, r_m, r_p;
    if (i < kTable) {
      r_i = table(T(), kInvI, i);
      r_den = table(T(), kInvDen, i);
      r_m = table(T(), kInvIMinusMu, i);
      r_p = table(T(), kInvIPlusMu, i);
    } else {
      r_i = T(1) / fi;
      r_den = T(1) / (fi * fi - mu * mu);
      r_m = T(1) / (fi - mu);
      r_p = T(1) / (fi + mu);
    }
    ff = (fi * ff + p + q) * r_den;
    c = c * d2 * r_i;
    p = p * r_m;
    q = q * r_p;
    const T delk = c * ff;
    const T delk1 = c * (p - fi * ff);
    ksum += delk;
    ksum1 += delk1;
    if (abs_(delk) < abs_(ksum) * eps<T>()) break;
  }
  rkmu = ksum;
  rk1 = ksum1 * T(2) / x;
}

// K_mu(x) and K_{mu+1}(x) for x > 2 (Steed's CF2).
template <typename T>
__device__ __forceinline__ void steed(T x, const GenArgs<T>& g, T& rkmu, T& rk1) {
  const T a1 = T(0.25) - g.mu * g.mu;
  T a = -a1;
  T b = T(2) * (T(1) + x);
  T d = T(1) / b;
  T h = d, delh = d;
  T q1 = T(0), q2 = T(1), q = a1, c = a1;
  T s = T(1) + q * delh;
  for (int i = 2; i <= kCf2Max + 1; ++i) {
    const T fi = T(i);
    a = a - T(2) * (fi - T(1));
    const T r_i = i < kTable ? table(T(), kInvI, i) : T(1) / fi;
    const T r_a = i < kTable ? table(T(), kInvA, i) : T(1) / a;
    c = -a * c * r_i;
    const T qnew = (q1 - b * q2) * r_a;
    q1 = q2;
    q2 = qnew;
    q = q + c * qnew;
    b = b + T(2);
    d = T(1) / (b + a * d);
    delh = (b * d - T(1)) * delh;
    h = h + delh;
    const T dels = q * delh;
    s = s + dels;
    if (abs_(dels) < eps<T>() * abs_(s)) break;
  }
  h = a1 * h;
  rkmu = sqrt_(T(3.141592653589793) / (T(2) * x)) * exp_(-x) / s;
  rk1 = rkmu * (g.mu + x + T(0.5) - h) / x;
}

// M_nu(u) for any real nu > 0; M(0) = 1, NaN stays NaN.
template <typename T>
__device__ __forceinline__ T general(T u, const GenArgs<T>& g) {
  if (u <= T(0)) return T(1);
  if (u != u) return u;
  const T xs = u < T(1e-30) ? T(1e-30) : u;
  T rkmu, rk1;
  if (xs <= T(2)) {
    temme(xs, g, rkmu, rk1);
  } else {
    steed(xs, g, rkmu, rk1);
  }
  const T two_x = T(2) / xs;
  for (int i = 1; i <= g.nl; ++i) {
    const T rktemp = (g.mu + T(i)) * two_x * rk1 + rkmu;
    rkmu = rk1;
    rk1 = rktemp;
  }
  return exp_(g.nu * log_(u) - g.lognorm) * rkmu;
}

// M_nu(u) of the instance NU2 (0: general).
template <typename T, int NU2>
__device__ __forceinline__ T correlation(T u, const GenArgs<T>& g) {
  if (NU2 == 0) return general(u, g);
  return halfint<T, NU2>(u);
}

// A location (x, y) as one 2 * sizeof(T) load.
template <typename T> struct Vec;
template <> struct Vec<double> { using pair = double2; };
template <> struct Vec<float> { using pair = float2; };

// x[0..N-2] <- x[1..N-1], x[N-1] <- y.  N calls in a loop that is not
// unrolled run a general evaluation an element with x held in registers:
// an index that varies would put the array in local memory.
template <typename T, int N>
__device__ __forceinline__ void shift_in(T (&x)[N], T y) {
#pragma unroll
  for (int k = 0; k + 1 < N; ++k) x[k] = x[k + 1];
  x[N - 1] = y;
}

// Store v[0..N-1] at p in 16-byte vectors (8-byte float2 for the last two
// floats when N % 4 == 2); p is 16-byte aligned, N even.
template <int N>
__device__ __forceinline__ void store(double* p, const double (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 2)
    reinterpret_cast<double2*>(p)[k / 2] = make_double2(v[k], v[k + 1]);
}
template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
#pragma unroll
  for (int k = 0; k + 3 < N; k += 4)
    reinterpret_cast<float4*>(p)[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  if (N % 4 == 2)
    reinterpret_cast<float2*>(p)[N / 2 - 1] = make_float2(v[N - 2], v[N - 1]);
}
// Load v[0..3] from p (16-byte aligned).
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

}  // namespace matern
