#!/usr/bin/env python3
"""Probe the TF32 tensor cores and scan the f32 flash instance's tilings.

    python3 scripts/flash_f32_variants.py [--probe] [--no-scan] [--parent DIR]

Prints the card's name and power limit first and one JSON line a result;
exits 1 if a check fails.  Needs one CUDA device and nvcc.

``--probe`` builds one small kernel (``PROBE_SRC``, which includes
``csrc/flash_attention.cu`` for its tf32 wgmma wrappers, swizzle and A
fragment loader) and forms one 64 x 128 by 128 x 64 product on a warpgroup
of the card (m64n64k8 wgmmas over 16 k8 steps) in these ways: one raw tf32
pass on the f32 operands; one pass on operands truncated to tf32 (low 13 bits
cleared) and one on operands rounded with ``cvt.rna.tf32.f32``; the 3xTF32
split with hi from ``cvt.rna`` (lo = rna(x - hi)); the split with the raw
tile as hi and lo = x - (x with its low 13 bits cleared), as SS wgmmas and
with A's lo from registers (the kernel's RS form, through its fragment
loader); and a plain FMA loop on the FP32 cores.  It holds each against the
product in f64 on the card (and cuBLAS f32 beside them) over a few seeds,
and reports whether the raw pass equals the truncated or the rounded one
bit for bit: what the tensor cores do with an f32 operand's low 13 bits.

Unless ``--no-scan``: builds copies of ``csrc/flash_attention.cu`` with the
text edits of ``VARIANTS`` (other tilings, and two timing-only ablations:
no split pass; one tf32 pass a product; the script raises if a text to
replace is missing), one nvcc each, all started together, into
``kernels/build/variants_flash/``, prints each build's
registers and spills by kernel, holds the f32 instance at chip_smoke.py's
f32 flash cases against ``attention_ref`` at ``ATTN_TOL["float32"]`` (the
ablations are reported, not held), and times each at the cases chip_smoke
times (``cuda_ms``) beside SDPA f32.

``--parent DIR`` also builds DIR's ``flash_attention.cu`` (an unpacked copy
of an earlier commit: ``git archive <commit> | tar -x -C DIR``), fails
unless the bf16 instance's outputs equal the parent build's bit for bit at
every bf16 case up to D = 128, and times the bf16 path case and the f32 depth-4 case in
both builds in turns (parent, this, this, parent).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    ATTN_TOL,
    FLASH_CASES,
    FLASH_TIMED,
    attention_pairs,
    cuda_ms,
    max_err,
    nvidia_smi,
)

# name -> text edits of the source; the first is the library's own build.
# The tilings: consumer warpgroups (64 queries each), keys a tile, raw
# stages, split sets, and the producer's setmaxnreg (the consumers take the
# rest of the launch's 168 registers a thread).
_TILING = {
    "kWg": "constexpr int kWg = 2;",
    "kBn": "constexpr int kBn = 32;",
    "kRawStages": "constexpr int kRawStages = 2;",
    "kSplitStages": "constexpr int kSplitStages = 2;",
    "kProducerRegs": "constexpr int kProducerRegs = 56;",
}
_NO_SPLIT = (
    """        split_tile<D>(kr, kr + G::kTileBytes, kl, kl + G::kTileBytes,
                      kl + 2 * G::kTileBytes, st);""",
    "        (void)kr; (void)kl; (void)st;",
)
_ONE_PASS = tuple(
    (text, ";")
    for text in (
        """mma_ss<kBn>(sc, desc(qa + c * G::kQRegion + 32 * w),
                    desc(kl + c * G::kKRegion + 32 * w));""",
        "mma_rs<kBn>(sc, qlo[kk], desc(ks + c * G::kKRegion + 32 * w));",
        "mma_rs<D>(o, plo[kk], desc(vth + (kk >> 2) * G::kVtRegion + 32 * (kk & 3)));",
        "mma_rs<D>(o, phi[kk], desc(vtl + (kk >> 2) * G::kVtRegion + 32 * (kk & 3)));",
    )
)
# Q's address made opaque in each tile, so that its descriptors are formed
# there and not held across the loop
_LAUNDER = (
    ("  const uint32_t qa = q_s + 64 * g * 128;", "  uint32_t qa = q_s + 64 * g * 128;"),
    ("    const uint32_t ks = raw_s + s * G::kRawBytes;",
     '    asm volatile("" : "+r"(qa));\n    const uint32_t ks = raw_s + s * G::kRawBytes;'),
)


def _tiling(**values):
    """Edits that set the named constants of the tiling."""
    return tuple(
        (_TILING[name], _TILING[name].rsplit("=", 1)[0] + f"= {value};")
        for name, value in values.items()
    )


VARIANTS = {
    "q128_bn32_raw2_split2": (),
    "q128_bn32_raw2_split1": _tiling(kSplitStages=1),
    "q128_bn64_raw1_split1": _tiling(kBn=64, kRawStages=1, kSplitStages=1),
    "q64_bn32_raw2_split2": _tiling(kWg=1),
    "q64_bn64_raw1_split1": _tiling(kWg=1, kBn=64, kRawStages=1, kSplitStages=1),
    "q128_bn32_raw2_split2_p40": _tiling(kProducerRegs=40),
    "q128_bn32_raw2_split2_p24": _tiling(kProducerRegs=24),
    "launder_qa": _LAUNDER,
    # timing only (wrong results): the library's tiling without the split
    # pass, and with one tf32 pass a product (the lo terms dropped)
    "ablate_no_split": (_NO_SPLIT,),
    "ablate_one_pass": _ONE_PASS,
}
TIMING_ONLY = ("ablate_no_split", "ablate_one_pass")
DEFAULT = "q128_bn32_raw2_split2"
PROBE_SEEDS = (0, 1, 2)
PROBE_MODES = {
    "raw_one_pass": 0,
    "split_rna_hi": 1,
    "split_raw_hi": 2,
    "split_raw_hi_rs": 3,
    "truncated_one_pass": 4,
    "rna_one_pass": 5,
    "fma_fp32_cores": 6,
}
PROBE_SRC = r"""
#include "flash_attention.cu"

namespace {

constexpr int kM = 64, kN = 64, kK = 128;
constexpr int kRegion = 64 * 128, kTile = 64 * 128 * 4;

__device__ float rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// out (64 x 64) = a (64 x 128) bt (64 x 128)^T, row-major, by one warpgroup;
// the modes are the script's PROBE_MODES
__global__ void __launch_bounds__(128) probe_kernel(const float* a, const float* bt,
                                                    float* out, int mode) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = hopper::smem_u32(smem), base = (raw + 1023u) & ~1023u;
  uint8_t* g = smem + (base - raw);  // A hi, A lo, B hi, B lo
  const int tid = threadIdx.x;
  if (mode == 6) {
    for (int e = tid; e < kM * kN; e += 128) {
      const int i = e / kN, j = e % kN;
      float s = 0.f;
      for (int k = 0; k < kK; ++k) s = fmaf(a[i * kK + k], bt[j * kK + k], s);
      out[e] = s;
    }
    return;
  }
  for (int e = tid; e < kM * kK; e += 128) {
    const int r = e / kK, c = e % kK;
    for (int which = 0; which < 2; ++which) {
      const float x = (which ? bt : a)[e];
      float hi = x, lo = 0.f;
      if (mode == 1) {
        hi = rna(x);
        lo = rna(x - hi);
      } else if (mode == 2 || mode == 3) {
        lo = tf32x3::lo_part(x);
      } else if (mode == 4) {
        hi = x - tf32x3::lo_part(x);
      } else if (mode == 5) {
        hi = rna(x);
      }
      uint8_t* t = g + which * 2 * kTile;
      *reinterpret_cast<float*>(t + tf32x3::swz(r, c, kRegion)) = hi;
      *reinterpret_cast<float*>(t + kTile + tf32x3::swz(r, c, kRegion)) = lo;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t ahi = base, alo = base + kTile, bhi = base + 2 * kTile,
                 blo = base + 3 * kTile;
  const int lane = tid & 31, r_a = 16 * (tid >> 5) + (lane >> 2);
  uint32_t afr[kK / 8][4];
  for (int kk = 0; kk < kK / 8; ++kk) {
    tf32x3::load_a(afr[kk], g + kTile, kRegion, r_a, kk, lane & 3);
  }
  float d[32];
  for (int e = 0; e < 32; ++e) d[e] = 0.f;
  auto at = [](uint32_t t, int kk) {
    return tf32x3::desc(t + (kk >> 2) * kRegion + 32 * (kk & 3));
  };
  hopper::wgmma_fence();
  if (mode == 1 || mode == 2) {
    for (int kk = 0; kk < kK / 8; ++kk) tf32x3::mma_ss_n64(d, at(ahi, kk), at(blo, kk));
    for (int kk = 0; kk < kK / 8; ++kk) tf32x3::mma_ss_n64(d, at(alo, kk), at(bhi, kk));
  } else if (mode == 3) {
    for (int kk = 0; kk < kK / 8; ++kk) tf32x3::mma_ss_n64(d, at(ahi, kk), at(blo, kk));
    for (int kk = 0; kk < kK / 8; ++kk) tf32x3::mma_rs_n64(d, afr[kk], at(bhi, kk));
  }
  for (int kk = 0; kk < kK / 8; ++kk) tf32x3::mma_ss_n64(d, at(ahi, kk), at(bhi, kk));
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  hopper::pin(d);
  hopper::pin(afr);
  for (int j = 0; j < 8; ++j) {
    for (int h = 0; h < 2; ++h) {
      for (int c = 0; c < 2; ++c) {
        out[(r_a + 8 * h) * kN + 8 * j + 2 * (lane & 3) + c] = d[4 * j + 2 * h + c];
      }
    }
  }
}

}  // namespace

extern "C" int flash_tf32_probe(const float* a, const float* bt, float* out,
                                int mode, void* stream) {
  const int smem = 1024 + 4 * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(a, bt, out, mode);
  return cudaGetLastError();
}
"""


def _compile(name, src, out_dir, include=None):
    from repro_torch.kernels import _build

    lib = out_dir / f"libflash_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", include or str(_build.CSRC)]
    cmd += ["-shared", str(src), "-o", str(lib)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return lib, proc


def build(probe=False, scan=True, parent=None):
    """{name: CDLL}: the probe, the variants and the parent, one nvcc each,
    all started together."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "flash_attention.cu"
    jobs = {}
    if probe:
        probe_src = out_dir / "probe.cu"
        probe_src.write_text(PROBE_SRC)
        jobs["probe"] = _compile("probe", probe_src, out_dir)
    names = VARIANTS if scan else (DEFAULT,) if parent else ()
    for name in names:
        text = src.read_text()
        edits = VARIANTS[name]
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to replace is not in the source")
            text = text.replace(old, new)
        copy = out_dir / f"{name}.cu"
        copy.write_text(text)
        jobs[name] = _compile(name, copy, out_dir)
    if parent:
        csrc = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
        jobs["parent"] = _compile(
            "parent", os.path.join(csrc, "flash_attention.cu"), out_dir, include=csrc
        )
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
        report = ptxas(out.decode() + err.decode())
        print(json.dumps({"ptxas": name, "kernels": report}), flush=True)
    return libs


def ptxas(text: str) -> dict:
    """Registers and spilled bytes of each kernel in nvcc's -v report, by
    its mangled name."""
    report, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report[name] = {}
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            report[name]["spill_bytes"] = int(m.group(1))
    return report


def probe(torch, lib) -> bool:
    """The product in each of PROBE_MODES against f64; ok unless the
    3xTF32 split with the raw tile as hi is more than four times the FP32
    cores' error, or its RS form differs from its SS form by more than
    that error (a wrong A fragment layout gives an error near 2^-10)."""
    fn = lib.flash_tf32_probe
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    worst = {name: 0.0 for name in PROBE_MODES}
    worst["cublas_f32"] = 0.0
    equal_trunc = equal_rna = rs_same = True
    for seed in PROBE_SEEDS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        a = torch.randn((64, 128), generator=gen, device="cuda")
        bt = torch.randn((64, 128), generator=gen, device="cuda")
        exact = a.double() @ bt.double().T
        scale = a.double().abs() @ bt.double().abs().T  # sum |a_k b_k|
        outs = {}
        for name, mode in PROBE_MODES.items():
            out = torch.empty((64, 64), device="cuda")
            rc = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), mode, stream)
            if rc:
                raise RuntimeError(f"probe mode {name}: cudaError_t {rc}")
            outs[name] = out
        outs["cublas_f32"] = a @ bt.T
        torch.cuda.synchronize()
        for name, out in outs.items():
            rel = float(((out.double() - exact).abs() / scale).max())
            worst[name] = max(worst[name], rel)
        equal_trunc &= torch.equal(outs["raw_one_pass"], outs["truncated_one_pass"])
        equal_rna &= torch.equal(outs["raw_one_pass"], outs["rna_one_pass"])
        rs_same &= torch.equal(outs["split_raw_hi"], outs["split_raw_hi_rs"])
    fp32 = worst["fma_fp32_cores"]
    ok = worst["split_raw_hi"] <= 4 * fp32 and worst["split_raw_hi_rs"] <= 4 * fp32
    print(json.dumps({
        "probe": "tf32 m64n64k8 wgmma, 64 x 128 by 128 x 64",
        "seeds": list(PROBE_SEEDS),
        "max_err_over_sum_abs_products": worst,
        "ratio_to_fp32_cores": {k: v / fp32 for k, v in worst.items()},
        "raw_equals_truncated_bitwise": equal_trunc,
        "raw_equals_rna_rounded_bitwise": equal_rna,
        "rs_equals_ss_bitwise": rs_same,
        "ok": ok,
    }), flush=True)
    return ok


def runner(torch, lib, dtype):
    """run(q, k, v, window) -> out through the C symbol of ``dtype`` in
    ``lib``, with the wrapper's arguments."""
    symbol = "flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention_f32"
    fn = getattr(lib, symbol)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
    fn.restype = ctypes.c_int

    def run(q, k, v, window, out):
        bh, sq, d = q.shape
        bkv, skv, _ = k.shape
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, out)]
        rc = fn(*ptrs, bh, sq, skv, d, bh // bkv, d**-0.5, 1, window, stream)
        if rc:
            raise RuntimeError(f"{symbol}: cudaError_t {rc}")
        return out

    return run


def inputs(torch, seed, bh, bkv, sq, skv, d, dtype):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    return [torch.randn(s, **kw).to(dtype) for s in ((bh, sq, d), (bkv, skv, d), (bkv, skv, d))]


def sdpa(torch, q, k, v, window):
    """SDPA on (1, H, S, D) views with the kernel's right-aligned mask."""
    import torch.nn.functional as F

    sq, skv = q.shape[1], k.shape[1]
    kw = dict(enable_gqa=True)
    if sq == skv and window == 0:
        kw["is_causal"] = True
    else:
        qpos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
        kpos = torch.arange(skv, device="cuda")[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        kw["attn_mask"] = mask
    return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], **kw)


def scan(torch, libs) -> bool:
    from repro_torch.kernels import ref

    runs = {name: runner(torch, libs[name], torch.float32) for name in VARIANTS}
    good = True
    for tag, bh, bkv, sq, skv, d, dtype, window in FLASH_CASES:
        if dtype != "float32":
            continue
        q, k, v = inputs(torch, 3, bh, bkv, sq, skv, d, torch.float32)
        want = ref.attention_ref(q, k, v, window=window)
        out = torch.empty_like(q)
        rec = {"f32_scan": tag, "shape": [bh, bkv, sq, skv, d], "window": window,
               "max_abs_err": {}, "ok": True}
        timed = (tag, "float32") in FLASH_TIMED
        if timed:
            rec["ms"] = {}
            flops = 4 * d * attention_pairs(sq, skv, window) * bh
            rec["bound_ms"] = 3 * flops / 495e12 * 1e3
            rec["bound_fp32_cores_ms"] = flops / 67e12 * 1e3
        for name, run in runs.items():
            err, ok = max_err(torch, run(q, k, v, window, out), want, **ATTN_TOL["float32"])
            rec["max_abs_err"][name] = err
            rec["ok"] = rec["ok"] and (ok or name in TIMING_ONLY)
            if timed:
                rec["ms"][name] = cuda_ms(torch, lambda: run(q, k, v, window, out))
        if timed:
            rec["library_ms"] = cuda_ms(torch, sdpa(torch, q, k, v, window))
            held = {n: ms for n, ms in rec["ms"].items() if n not in TIMING_ONLY}
            rec["best"] = min(held, key=held.get)
        good = good and rec["ok"]
        print(json.dumps(rec), flush=True)
        del q, k, v, want, out
        torch.cuda.empty_cache()
    return good


def against_parent(torch, libs) -> bool:
    """The bf16 instance bit for bit against the parent build at every bf16
    case; the bf16 path and the f32 depth-4 case timed in both builds."""
    good = True
    for tag, bh, bkv, sq, skv, d, dtype, window in FLASH_CASES:
        if d > 128:
            continue  # a parent build before the D = 256 instance has none
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        q, k, v = inputs(torch, 4, bh, bkv, sq, skv, d, tdt)
        runs = {name: runner(torch, libs[name], tdt) for name in ("parent", DEFAULT)}
        outs = {name: run(q, k, v, window, torch.empty_like(q)) for name, run in runs.items()}
        torch.cuda.synchronize()
        rec = {"parent_case": tag, "dtype": dtype, "shape": [bh, bkv, sq, skv, d]}
        if dtype == "bfloat16":
            rec["bit_equal"] = torch.equal(outs["parent"], outs[DEFAULT])
            good = good and rec["bit_equal"]
        else:
            rec["max_abs_diff"] = float((outs["parent"] - outs[DEFAULT]).abs().max())
        if tag in ("path", "depth4_f32"):
            out = torch.empty_like(q)
            rec["ms"] = {"parent": [], "this": []}
            for name in ("parent", DEFAULT, DEFAULT, "parent"):
                key = "parent" if name == "parent" else "this"
                rec["ms"][key].append(
                    cuda_ms(torch, lambda: runs[name](q, k, v, window, out))
                )
        print(json.dumps(rec), flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()
    return good


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="store_true", help="run the tf32 probe")
    ap.add_argument("--no-scan", action="store_true", help="skip the tiling scan")
    ap.add_argument("--parent", help="an unpacked earlier commit to hold bf16 to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    libs = build(args.probe, not args.no_scan, args.parent)
    good = True
    if args.probe:
        good = probe(torch, libs["probe"]) and good
    if not args.no_scan:
        good = scan(torch, libs) and good
    if args.parent:
        good = against_parent(torch, libs) and good
    print(json.dumps({"ok": good}), flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
