#!/usr/bin/env python3
"""Measure the FP64 tensor-core (DMMA) instruction shapes of the card.

    python3 scripts/dmma_rates.py

Builds a small CUDA program with nvcc (into the git-ignored kernel build
directory) and runs it.  For each f64 ``mma.sync`` shape that sm_90 offers
(m8n8k4, m16n8k4, m16n8k8, m16n8k16) it checks the fragment layout that
``kernels/csrc/dmma.cuh`` assumes against a host product of small integers
(exact in f64), and times a loop of independent products at 32 warps an SM;
then it times m16n8k8, the shape the port's kernels use, at 1, 4 and 8
warps an SM with 4 independent accumulators a warp, the occupancy of the
kernels.  Prints the card's name and power limit, then one JSON line per
measurement.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

// Fragments (g = lane / 4, t = lane % 4), as dmma.cuh documents them:
// m8n8k4 a0 (g,t), b0 (t,g), c{0,1} (g, 2t+i); the m16n8 shapes
// a_i (g + 8 (i % 2), t + 4 (i / 2)), b_i (t + 4 i, g),
// c_i (g + 8 (i / 2), 2t + i % 2).
template <int M, int K>
__device__ void mma(double* c, const double* a, const double* b) {
  if (M == 8)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1}, {%2}, {%3}, {%0,%1};"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  else if (K == 4)
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  else if (K == 8)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
                 "{%0,%1,%2,%3};"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                   "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int M, int K>
__global__ void layout(const double* A, const double* B, double* C) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  const int na = M * K / 32, nc = M * 8 / 32;
  for (int i = 0; i < na; ++i)
    a[i] = M == 8 ? A[g * K + t] : A[(g + 8 * (i % 2)) * K + t + 4 * (i / 2)];
  for (int i = 0; i < K / 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  mma<M, K>(c, a, b);
  for (int i = 0; i < nc; ++i) C[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = c[i];
}

template <int M, int K, int CH>
__global__ void rate(double* out, int iters) {
  double a[8], b[4], c[CH][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < 4; ++i) c[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) mma<M, K>(c[j], a, b);
  }
  double s = 0;
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < 4; ++i) s += c[j][i];
  if (s == 12345.678) out[0] = s;
}

template <int M, int K, int CH>
void run(const char* name, int warps_per_sm, bool check) {
  int bad = -1;
  if (check) {
    double hA[256], hB[128], hC[128], want[128];
    for (int i = 0; i < M * K; ++i) hA[i] = (i * 7) % 17 - 8;
    for (int i = 0; i < K * 8; ++i) hB[i] = (i * 5) % 13 - 6;
    for (int r = 0; r < M; ++r)
      for (int c = 0; c < 8; ++c) {
        double s = 0;
        for (int l = 0; l < K; ++l) s += hA[r * K + l] * hB[l * 8 + c];
        want[r * 8 + c] = s;
      }
    double *A, *B, *C;
    cudaMalloc(&A, sizeof hA);
    cudaMalloc(&B, sizeof hB);
    cudaMalloc(&C, sizeof hC);
    cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
    cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
    layout<M, K><<<1, 32>>>(A, B, C);
    cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
    bad = 0;
    for (int i = 0; i < M * 8; ++i) bad += hC[i] != want[i];
    cudaFree(A);
    cudaFree(B);
    cudaFree(C);
  }
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  double* o;
  cudaMalloc(&o, 8);
  const int iters = 4096;
  const int blocks = warps_per_sm >= 8 ? sms * (warps_per_sm / 8) : sms;
  const int threads = 32 * (warps_per_sm >= 8 ? 8 : warps_per_sm);
  rate<M, K, CH><<<blocks, threads>>>(o, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<M, K, CH><<<blocks, threads>>>(o, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * M * 8 * K * CH * (double)iters * blocks * threads / 32;
  printf("{\"shape\": \"%s\", \"warps_per_sm\": %d, \"accumulators_per_warp\": %d, "
         "\"layout_mismatches\": %d, \"tflops\": %.3f, \"error\": \"%s\"}\n",
         name, warps_per_sm, CH, bad, flops / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(o);
}

int main() {
  run<8, 4, 4>("m8n8k4", 32, true);
  run<16, 4, 4>("m16n8k4", 32, true);
  run<16, 8, 4>("m16n8k8", 32, true);
  run<16, 16, 4>("m16n8k16", 32, true);
  run<16, 8, 4>("m16n8k8", 1, false);
  run<16, 8, 4>("m16n8k8", 4, false);
  run<16, 8, 4>("m16n8k8", 8, false);
  return 0;
}
"""


def main() -> int:
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "dmma_rates.cu"
    exe = _build.BUILD_DIR / "dmma_rates"
    src.write_text(SOURCE)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-o", str(exe), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300)
    lines = [json.loads(line) for line in out.stdout.splitlines() if line]
    for rec in lines:
        print(json.dumps(rec), flush=True)
    ok = out.returncode == 0 and all(
        r["error"] == "no error" and r["layout_mismatches"] in (0, -1) for r in lines
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
