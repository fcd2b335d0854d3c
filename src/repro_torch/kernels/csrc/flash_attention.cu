// Flash attention: causal GQA attention with an online softmax,
//
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b / group, j] * scale) v[b / group, j]
//
// over the unmasked keys j, with q of shape (BH, Sq, D), k and v of shape
// (BKV, Skv, D), BH = BKV * group, and out a new (BH, Sq, D) tensor in q's
// dtype (bf16 or f32 in; f32 arithmetic throughout).  Replaces the Pallas
// TPU kernel src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel).  On the LM path (models/attention.py, impl="kernel") it is
// the attention of every layer of a forward without caches: the prefill and
// scoring forward.
//
// Semantics, as _flash_kernel: queries are right-aligned to the keys, so
// query i sits at qpos = i + (Skv - Sq) and key j at kpos = j; a key is
// kept if kpos <= qpos (causal) and kpos > qpos - window (window > 0).
// Masked scores take the reference's constant -1e30, not -inf; the running
// max starts at -1e30, the running sum and the accumulator at 0, and the
// output is acc / max(l, 1e-30).  Query head b reads KV head b / group.
//
// Which key tiles a block visits: only those from the first key the window
// reaches for the block's first query to the last key causality allows for
// its last one.  The reference walks every tile; the result is the same:
//  - a tile fully masked for a row that comes after one of the row's
//    unmasked keys adds exp(-1e30 - m) = 0 to its sum and accumulator;
//  - one that comes before all of them (p = exp(-1e30 - (-1e30)) = 1 for
//    each entry) is wiped out by the correction exp(-1e30 - m_real) = 0 at
//    the row's first unmasked key.
// Every row has an unmasked key (its own position), so both cases hold for
// the tiles skipped and for the masked entries of the tiles visited.  Keys
// past Skv in the last tile are masked the same way; queries past Sq in the
// last query tile are computed on zeros and not written.  Any Sq <= Skv
// works (the TPU kernel needs both divisible by its blocks); offsets are
// 64-bit.
//
// Bound on the card: 4 D flops for each unmasked (query, key) pair.  At the
// path's shape (qwen3-4b prefill: B = 2, S = 4096, 32 query and 8 KV heads,
// D = 128, causal, bf16) that is 4 D S (S + 1) / 2 BH = 2.75e11 flops a
// layer, 0.278 ms at the bf16 tensor-core peak of 989 TFLOP/s, against
// 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s: operations bound it.
// This kernel runs on the FP32 CUDA cores (67 TFLOP/s), and what bounds it
// in practice is the FP32 FMA rate and the shared-memory reads that feed it
// (8 per 16 FMAs of the score tile, 12 per 32 of P V).  P stays f32, as in
// the reference; bf16 P V on the tensor cores would change the rounding.
// A later redesign would run Q K^T on bf16 with wgmma, feed K and V through
// a TMA ring of tiles with mbarriers, and specialise warps into a producer
// and consumer warpgroups, held to the bf16 tolerance.
//
// Design.  The TPU grid (BH, Sq / bq, Skv / bk) runs its kv axis in order
// and carries the online-softmax state in VMEM scratch from one step to
// the next.  Here one block of 256 threads owns 64 queries of one head
// (grid.x over query tiles, the longest rows first; grid.y over BH) and a
// loop inside the block takes the place of the kv axis.  The Q tile and
// the current K and V tiles (64 x D each) sit in dynamic shared memory as
// f32, rows padded to D + 1 words so the column reads are free of bank
// conflicts; at D = 128 they take 99 KB and the 64 x 64 P tile 16.6 KB, so
// two blocks share an SM.  A thread owns rows ty + 16 i (i < 4) and, of
// the score tile, columns tx + 16 j (j < 4), of the accumulator columns
// tx + 16 j (j < D / 16): the 16 threads of a row are one half-warp, so
// the row max and row sum are shuffles, the running max and sum live in
// registers, and P goes through shared memory read back by the same warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;  // queries a block
constexpr int kBk = 64;  // keys a tile
constexpr int kThreads = 256;
constexpr int kLdp = kBk + 1;  // padded row of the P tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(3) * kBq * (D + 1) + size_t(kBq) * kLdp);
}

// dst[r][c] = src[r, c] as f32 for the first `rows` rows of a 64 x D tile,
// zero below them.  Consecutive threads read consecutive elements.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int rows) {
  for (int e = threadIdx.x; e < kBq * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < rows ? to_f32(src[(long long)r * D + c]) : 0.f;
  }
}

// The max (or sum) over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int group, float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBq * kLd;
  float* vs = ks + kBk * kLd;
  float* ps = vs + kBk * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * kBq;
  const int rows = min(kBq, sq - q0);
  const int off = skv - sq;
  const T* qb = q + ((long long)bh * sq + q0) * D;
  const T* kb = k + (long long)(bh / group) * skv * D;
  const T* vb = v + (long long)(bh / group) * skv * D;

  int k_lo = 0, k_hi = skv - 1;
  if (window > 0) k_lo = max(0, q0 + off - window + 1);
  if (causal) k_hi = min(k_hi, q0 + rows - 1 + off);
  const int t_lo = k_lo / kBk, t_hi = k_hi / kBk;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, D>(qs, qb, rows);

  float acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int kbase = t * kBk;
    const int keys = min(kBk, skv - kbase);
    __syncthreads();  // the last tile's K, V and P reads are done
    load_tile<T, D>(ks, kb + (long long)kbase * D, keys);
    load_tile<T, D>(vs, vb + (long long)kbase * D, keys);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + off;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kbase + tx + 16 * j;
        bool keep = kpos < skv;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        s[i][j] = keep ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * kLdp + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = corr * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a warp reads back only the P rows it wrote

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float w = vs[c * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], w, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row < rows) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + ((long long)bh * sq + q0 + row) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) store(o + tx + 16 * j, acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int bh, int sq,
                   int skv, int group, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBq - 1) / kBq, bh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, sq, skv, group, scale,
                                           causal, window);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int skv, int d, int group, float scale, int causal,
             int window, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<T, 32>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 64:
      return launch<T, 64>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 96:
      return launch<T, 96>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                           window, st);
    case 128:
      return launch<T, 128>(qt, kt, vt, ot, bh, sq, skv, group, scale, causal,
                            window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int bh, int sq, int skv, int d,
                                   int group, float scale, int causal,
                                   int window, void* stream) {
  return dispatch<float>(q, k, v, out, bh, sq, skv, d, group, scale, causal,
                         window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int sq,
                                    int skv, int d, int group, float scale,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, group, scale,
                                 causal, window, stream);
}
