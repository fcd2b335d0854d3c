#!/usr/bin/env python3
"""Time shapes of the tlr_mm kernel's fma_f32 instance against each other.

    python3 scripts/tlr_mm_f32_variants.py [--parent DIR] [--only NAME ...]

Builds ``csrc/tlr_mm.cu`` as it is and copies of it (with ``dmma.cuh``) with
one change each, made by replacing text, one nvcc each, all started
together, into ``kernels/build/variants_tlr_mm/``: stage 3 by 128 x 128
tiles (8 x 8 outputs a thread, one or two blocks an SM), stage 3's 64 x 64
tiles at three blocks an SM, stage 2 by 128 x 128 tiles, 16-wide slabs and
a ring of 2 or 4 stages in the product kernel, stage 1 by 16-row chunks,
its split of nb into at most 4 slices or none, and the three launches
without PDL.  With ``--parent DIR`` it also builds ``DIR``'s ``tlr_mm.cu``
(an unpacked copy of an earlier commit, whose f32 symbol has no T scratch
and no float64-acc form: its wide case is the f32 form into a zero batch,
cast and added).

Each build is held against ``tlr_mm_ref`` at chip_smoke.py's
``tlr_mm_f32_tol`` at the mixed SYRK's first step (15, 512, 128) with an
f32 and a float64 acc, at B = 63 and 1, ragged (3, 301, 131) in place with
both accs and with zero-padded rank columns; then timed by chip_smoke's
``cuda_ms`` (the card's time) in place at B = 15 (both accs), 63 and 1, and
summed over the mixed sweep B = 15 down to 1, in two rounds, the second in
the reverse order, beside the f32 library call (bmm + baddbmm).  Prints the
card's name and power limit first, then each build's registers and spills,
the product build's error and the library's against a float64 evaluation,
each kernel's device time by torch.profiler for the builds in PROFILED, and
one JSON line a build; exits 1 if a build disagrees.
Needs one CUDA device and nvcc.
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
    _tlr_mm_inputs,
    _tlr_mm_library,
    cuda_ms,
    max_err,
    nvidia_smi,
    tlr_mm_f32_tol,
)

# name -> (file, text, replacement) changes to the sources; "product" is
# the source as it is
_TILE8 = ("tlr_mm.cu", "__launch_bounds__(kFThreads, kFBlocks)",
          "__launch_bounds__(kFThreads, TM * TN >= 64 ? 1 : kFBlocks)")
_Y128 = ("tlr_mm.cu", "launch_gemm_f32<4, 4>(t, ub,", "launch_gemm_f32<8, 8>(t, ub,")
_PDL_OFF = ("programmaticStreamSerializationAllowed = 1;",
            "programmaticStreamSerializationAllowed = 0;")
VARIANTS = {
    "product": (),
    "y128": (_Y128, _TILE8),
    "y128x2": (_Y128,),
    "blocks3": (("tlr_mm.cu", "kFBlocks = 2;", "kFBlocks = 3;"),),
    "t128": (("tlr_mm.cu", "launch_gemm_f32<4, 4>(ua, w,",
              "launch_gemm_f32<8, 8>(ua, w,"), _TILE8),
    "slab16": (("tlr_mm.cu", "kFSlab = 32;", "kFSlab = 16;"),),
    "stages2": (("tlr_mm.cu", "kFStages = 3;", "kFStages = 2;"),),
    "stages4": (("tlr_mm.cu", "kFStages = 3;", "kFStages = 4;"),),
    "wrows16": (("tlr_mm.cu", "kFWRows = 32;", "kFWRows = 16;"),
                ("tlr_mm.cu", "kFWStages = 2;", "kFWStages = 3;")),
    "split4": (("tlr_mm.cu", "kFSplitMax = 8;", "kFSplitMax = 4;"),),
    "split1": (("tlr_mm.cu", "kFSplitMax = 8;", "kFSplitMax = 1;"),),
    # every launch of the instance (stage 1's own and launch_pdl's) unchained
    "nopdl": (("tlr_mm.cu", *_PDL_OFF), ("dmma.cuh", *_PDL_OFF)),
}
SOURCES = ("tlr_mm.cu", "dmma.cuh")
# builds whose kernels are also profiled one by one (without PDL each
# kernel's time is its own; with it a kernel may start early and wait)
PROFILED = ("product", "nopdl")
# (case, B, nb, k, acc float64, in place, padded)
CHECKS = (
    ("first15", 15, 512, 128, False, False, False),
    ("wide15", 15, 512, 128, True, True, False),
    ("b63", 63, 512, 128, False, True, False),
    ("b1", 1, 512, 128, False, True, False),
    ("ragged", 3, 301, 131, False, True, False),
    ("ragged_wide", 3, 301, 131, True, True, False),
    ("padded15", 15, 512, 128, False, False, True),
)
# (case, B, acc float64), timed in place
TIMED = (("first15", 15, False), ("wide15", 15, True), ("b63", 63, False),
         ("b1", 1, False))
SWEEP_B = 15


def build(variants, parent=None):
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants_tlr_mm"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, changes in variants.items():
        src_dir = out_dir / name
        src_dir.mkdir(exist_ok=True)
        for fname in SOURCES:
            text = (_build.CSRC / fname).read_text()
            for target, old, new in changes:
                if target == fname:
                    if old not in text:
                        raise RuntimeError(f"{name}: {old!r} not in {fname}")
                    text = text.replace(old, new)
            (src_dir / fname).write_text(text)
        sources[name] = src_dir
    if parent:
        sources["parent"] = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
    jobs = {}
    for name, src_dir in sources.items():
        lib = out_dir / f"libtlr_mm_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-shared"]
        cmd += [os.path.join(str(src_dir), "tlr_mm.cu"), "-o", str(lib)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        jobs[name] = (lib, proc)
    libs, reports = {}, {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
        reports[name] = ptxas_f32(out.decode() + err.decode())
    return libs, reports


def ptxas_f32(text: str) -> dict:
    """Registers and spilled bytes of each f32 kernel in nvcc's -v report,
    by a short name: ``w`` or ``gemm<TM,TN,epilogue>``."""
    report, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            gemm = re.search(
                r"gemm_f32ILi(\d+)ELi(\d+)ENS_\d+(StoreT|SubAccI[fd])", mangled
            )
            if gemm:
                name = "gemm<{},{},{}>".format(*gemm.groups())
            else:
                name = "w" if "w_f32" in mangled else None
            if name:
                report[name] = {}
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            report[name]["spill_bytes"] = int(m.group(1))
    return report


def callers(torch, lib, old_abi: bool):
    """(run, run_wide): launch the build's f32 instance on (ua, va, ub, vb,
    acc, out) with an f32 or a float64 acc, allocating its scratch as the
    wrapper does."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"f32": lib.tlr_mm_f32}
    if not old_abi:
        fns["wide"] = lib.tlr_mm_f32_wide
    for fn in fns.values():
        fn.argtypes = [p] * (7 if old_abi else 8) + [i, i, i, p]
        fn.restype = ctypes.c_int

    def launch(fn, ua, va, ub, vb, acc, out):
        b, nb, k = ua.shape
        kw = dict(dtype=torch.float32, device="cuda")
        scratch = [torch.empty((b, k, k), **kw)]
        if not old_abi:
            scratch.append(torch.empty((b, nb, k), **kw))
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (ua, va, ub, vb, acc, *scratch, out)]
        rc = fn(*ptrs, b, nb, k, stream)
        if rc:
            raise RuntimeError(f"tlr_mm f32 launch: cudaError_t {rc}")
        return out

    def run(ua, va, ub, vb, acc, out):
        return launch(fns["f32"], ua, va, ub, vb, acc, out)

    def run_wide(ua, va, ub, vb, acc, out):
        if "wide" in fns:
            return launch(fns["wide"], ua, va, ub, vb, acc, out)
        neg = torch.zeros(acc.shape, dtype=torch.float32, device="cuda")
        launch(fns["f32"], ua, va, ub, vb, neg, neg)
        return torch.add(acc, neg.double(), out=out)

    return run, run_wide


def check(torch, gen, run, run_wide, rec) -> bool:
    from repro_torch.kernels import ref

    good = True
    for case, B, nb, k, wide, in_place, padded in CHECKS:
        acc_dtype = torch.float64 if wide else torch.float32
        ua, va, ub, vb, acc = _tlr_mm_inputs(
            torch, gen, B, torch.float32, padded, nb, k, acc_dtype
        )
        if padded:
            want = ref.tlr_mm_ref(*(t[:, :, : k // 2] for t in (ua, va, ub, vb)), acc)
        else:
            want = ref.tlr_mm_ref(ua, va, ub, vb, acc)
        tol = tlr_mm_f32_tol(nb, k, float((want - acc).abs().max()))
        out = acc if in_place else torch.empty_like(acc)
        got = (run_wide if wide else run)(ua, va, ub, vb, acc, out)
        torch.cuda.synchronize()
        err, ok = max_err(torch, got, want, **tol)
        rec[f"{case}_max_abs_err"] = err
        rec[f"{case}_atol"] = tol["atol"]
        good = good and ok
    return good


def accuracy(torch, gen, run) -> dict:
    """The kernel's and the library's largest error against a float64
    evaluation at (15, 512, 128), beside the size of y."""
    from repro_torch.kernels import ref

    ua, va, ub, vb, acc = _tlr_mm_inputs(torch, gen, 15, torch.float32)
    y64 = ref.tlr_mm_ref(*(t.double() for t in (ua, va, ub, vb)), acc.double())
    got = run(ua, va, ub, vb, acc, torch.empty_like(acc))
    lib = _tlr_mm_library(torch, ua, va, ub, vb, acc)
    y = y64 - acc.double()
    return {
        "kernel_vs_f64": float((got.double() - y64).abs().max()),
        "library_vs_f64": float((lib.double() - y64).abs().max()),
        "kernel_vs_library": float((got - lib).abs().max()),
        "y_max": float(y.abs().max()),
        "y_rms": float(y.pow(2).mean().sqrt()),
        "atol": tlr_mm_f32_tol(512, 128, float(y.abs().max()))["atol"],
    }


def timings(torch, gen, run, run_wide, rec) -> None:
    for case, B, wide in TIMED:
        acc_dtype = torch.float64 if wide else torch.float32
        ua, va, ub, vb, acc = _tlr_mm_inputs(
            torch, gen, B, torch.float32, acc_dtype=acc_dtype
        )
        fn = run_wide if wide else run
        rec.setdefault(f"{case}_ms", []).append(
            cuda_ms(torch, lambda: fn(ua, va, ub, vb, acc, acc))
        )
    ua, va, ub, vb, acc = _tlr_mm_inputs(torch, gen, SWEEP_B, torch.float32)
    total = 0.0
    for B in range(SWEEP_B, 0, -1):
        args = [t[:B] for t in (ua, va, ub, vb)]
        a = acc[:B]
        total += cuda_ms(torch, lambda: run(*args, a, a), reps=5)
    rec.setdefault("sweep15_ms_sum", []).append(total)


def library(torch, gen) -> dict:
    rec = {"build": "library (bmm + baddbmm, f32)"}
    for case, B, wide in TIMED:
        if wide:
            continue
        ua, va, ub, vb, acc = _tlr_mm_inputs(torch, gen, B, torch.float32)
        rec[f"{case}_ms"] = cuda_ms(
            torch, lambda: _tlr_mm_library(torch, ua, va, ub, vb, acc)
        )
    ua, va, ub, vb, acc = _tlr_mm_inputs(torch, gen, SWEEP_B, torch.float32)
    total = 0.0
    for B in range(SWEEP_B, 0, -1):
        args = [t[:B] for t in (ua, va, ub, vb)]
        total += cuda_ms(
            torch, lambda: _tlr_mm_library(torch, *args, acc[:B]), reps=5
        )
    rec["sweep15_ms_sum"] = total
    return rec


def profile(torch, gen, run, B: int) -> dict:
    """Device microseconds a launch of each kernel of the build at (B, 512,
    128) in place, by torch.profiler over 10 launches, and their sum."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    ua, va, ub, vb, acc = _tlr_mm_inputs(torch, gen, B, torch.float32)
    for _ in range(3):
        run(ua, va, ub, vb, acc, acc)
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run(ua, va, ub, vb, acc, acc)
        torch.cuda.synchronize()
    us = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            key = ev.key.replace("(anonymous namespace)::", "")
            found = re.search(r"tlr_mm_\w+(<[^()]*>)?", key)
            name = found.group(0) if found else ev.key[:60]
            us[name] = us.get(name, 0.0) + ev.self_device_time_total / 10
    return {"B": B, "us_per_launch": us, "sum_us": sum(us.values())}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier commit to time beside")
    ap.add_argument("--only", nargs="*", help="build only these variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tlr_mm_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    variants = {n: f for n, f in VARIANTS.items() if not args.only or n in args.only}
    libs, reports = build(variants, args.parent)
    print(json.dumps({"ptxas": reports}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    runs, results, failed = {}, {}, False
    for name, lib in libs.items():
        runs[name] = callers(torch, lib, old_abi=name == "parent")
        results[name] = {"build": name}
        ok = check(torch, gen, *runs[name], results[name])
        results[name]["ok"] = ok
        failed = failed or not ok
    if "product" in runs:
        acc = accuracy(torch, gen, runs["product"][0])
        print(json.dumps({"accuracy_product": acc}), flush=True)
    for name in PROFILED:
        for B in (15, 63, 1) if name in runs else ():
            rec = profile(torch, gen, runs[name][0], B)
            print(json.dumps({f"profile_{name}": rec}), flush=True)
    order = list(libs)
    for keys in (order, order[::-1]):
        for name in keys:
            timings(torch, gen, *runs[name], results[name])
    for rec in results.values():
        print(json.dumps(rec), flush=True)
    print(json.dumps(library(torch, gen)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
