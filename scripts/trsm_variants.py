#!/usr/bin/env python3
"""Hold the f64 trsm to an earlier build's bits and scan the f32 trsm's plans.

    python3 scripts/trsm_variants.py [--parent DIR] [--compare NAME=DIR ...]
                                     [--no-scan]

Builds ``csrc/trsm.cu`` as it is (with ``dmma.cuh``) and, with ``--parent
DIR``, ``DIR``'s ``trsm.cu`` (an unpacked copy of an earlier commit:
``git archive <commit> | tar -x -C DIR``), one nvcc each, started
together, into ``kernels/build/variants_trsm/``, and prints each build's
registers and spills by kernel.

With ``--parent``: at the dmma_f64 instance's path and check shapes it runs
both builds' ``trsm_f64`` on the same inputs with the plan ``trsm_plan``
picks, and fails unless the two outputs are equal bit for bit; it times
both in turns (parent, this, this, parent) with chip_smoke.py's
``cuda_ms`` (the card's time).

Unless ``--no-scan``: the fma_f32 instance (of this tree, and of each
``--compare`` tree: a copy of ``src/repro_torch/kernels/csrc`` under
``DIR/src/repro_torch/kernels/`` with one change, whose ``trsm_f32`` takes
a plan) at the exact_f32 path's 63 panel solves (1, 512, 512 k), k = 63
down to 1, at alpha (1, 512, 1) and at the other f32 check shapes, under
every plan (strip width 64, 32, 16 or 8, super-blocks of 512, 256 or 128
rows with updates of 128 x 128 or 64 x 64 tiles between them, the row
split at width 8), each held against
``solve_triangular`` f32 at chip_smoke's ``CHOL_TOL`` and timed beside the
library; it prints a line a shape (the times by plan, the best, and the
plan ``trsm_plan`` picks) and the sweep's sums under each fixed plan,
under the best plan of each step and under ``trsm_plan``'s.

Prints the card's name and power limit first and one JSON line a result;
exits 1 if a build disagrees.  Needs one CUDA device and nvcc.
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

from chip_smoke import CHOL_TOL, _spd, _trsm_bound, cuda_ms, max_err, nvidia_smi  # noqa: E402

# (case, batch, nb, r, lo_batch): the f64 shapes of chip_smoke's trsm checks
F64_SHAPES = (
    ("panel", 63, 512, 128, 1),
    ("wide", 1, 512, 8064, 1),
    ("alpha", 1, 512, 1, 1),
    ("predict", 1, 512, 1024, 1),
    ("ragged", 3, 200, 37, 3),
    ("tile2048", 4, 2048, 128, 1),
    ("panel4096", 1, 4096, 512, 1),
    ("alpha4096", 1, 4096, 1, 1),
    ("exact4096_last", 1, 4096, 4096, 1),
)
# the f32 shapes scanned besides the exact_f32 sweep's
F32_SHAPES = (
    ("alpha", 1, 512, 1, 1),
    ("panel", 63, 512, 128, 1),
    ("predict", 1, 512, 1024, 1),
    ("tile2048", 4, 2048, 128, 1),
    ("panel4096", 1, 4096, 512, 1),
    ("alpha4096", 1, 4096, 1, 1),
)
TILE, STEPS = 512, 63


def build(parent=None, compare=()):
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants_trsm"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ("src", "repro_torch", "kernels", "csrc")
    sources = {"this": str(_build.CSRC)}
    if parent:
        sources["parent"] = os.path.join(parent, *csrc)
    for item in compare:
        name, tree = item.split("=", 1)
        sources[name] = os.path.join(tree, *csrc)
    jobs = {}
    for name, src_dir in sources.items():
        lib = out_dir / f"libtrsm_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-shared"]
        cmd += [os.path.join(src_dir, "trsm.cu"), "-o", str(lib)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        jobs[name] = (lib, proc)
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err.decode()}")
        libs[name] = ctypes.CDLL(str(lib))
        print(json.dumps({"ptxas": name, "kernels": ptxas(out.decode() + err.decode())}),
              flush=True)
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


def solver(torch, lib, symbol):
    """run(lo, b, plan) -> X through ``symbol`` of ``lib`` (trsm_f64 or
    trsm_f32 of the plan-taking form), its scratch allocated as the wrapper
    does."""
    from repro_torch.kernels.chol_tiles import TRSM_BLOCK

    fn = getattr(lib, symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int

    def run(lo, b, plan, out=None):
        batch, nb, r = b.shape
        out = torch.empty_like(b) if out is None else out
        nblk = -(-nb // TRSM_BLOCK)
        dinv = torch.empty((lo.shape[0], nblk, TRSM_BLOCK, TRSM_BLOCK),
                           dtype=b.dtype, device=b.device)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (lo.data_ptr(), b.data_ptr(), out.data_ptr(), dinv.data_ptr())
        rc = fn(*ptrs, batch, nb, r, lo.shape[0], *plan, stream)
        if rc:
            raise RuntimeError(f"{symbol} plan {plan}: cudaError_t {rc}")
        return out

    return run


def inputs(torch, gen, batch, nb, r, lo_b, dtype):
    lo = torch.linalg.cholesky(_spd(torch, gen, lo_b, nb, torch.float64))
    b = torch.randn((batch, nb, r), generator=gen, dtype=torch.float64, device="cuda")
    return lo.to(dtype).contiguous(), b.to(dtype)


def f64_bits(torch, gen, libs, sms) -> bool:
    from repro_torch.kernels.chol_tiles import trsm_plan

    runs = {name: solver(torch, lib, "trsm_f64") for name, lib in libs.items()}
    good = True
    for case, batch, nb, r, lo_b in F64_SHAPES:
        lo, b = inputs(torch, gen, batch, nb, r, lo_b, torch.float64)
        plan = trsm_plan(batch, nb, r, sms)
        got = {name: run(lo, b, plan) for name, run in runs.items()}
        torch.cuda.synchronize()
        same = torch.equal(got["this"], got["parent"])
        good = good and same
        ms = {"parent": [], "this": []}
        for name in ("parent", "this", "this", "parent"):
            ms[name].append(cuda_ms(torch, lambda: runs[name](lo, b, plan)))
        print(json.dumps({"f64_bits": case, "shape": [batch, nb, r], "plan": plan,
                          "bit_equal": same, "ms": ms}), flush=True)
    return good


def plans(nb):
    """Every plan the f32 instance takes at nb <= 512: strips of 64, 32, 16
    or 8 columns over super-blocks of 512, 256 or 128 rows (an update of
    128 x 128 or 64 x 64 tiles between them), the row split at 8."""
    out = []
    for sc in (64, 32, 16, 8):
        for sup in (512, 256, 128):
            tiles = (0,) if sup >= nb else (128, 64)
            for tile in tiles:
                out.append((sc, sup, tile, 0))
                if sc == 8:
                    out.append((sc, sup, tile, 1))
    return out


def scan_shape(torch, gen, run, sms, batch, nb, r, lo_b) -> dict:
    from repro_torch.kernels.chol_tiles import trsm_plan

    lo, b = inputs(torch, gen, batch, nb, r, lo_b, torch.float32)
    want = torch.linalg.solve_triangular(lo, b, upper=False)
    pick = trsm_plan(batch, nb, r, sms, torch.float32)
    candidates = plans(nb) if nb <= 512 else [pick]
    rec = {"shape": [batch, nb, r], "picked": pick, "ms": {}, "ok": True}
    out = torch.empty_like(b)
    for plan in candidates:
        err, ok = max_err(torch, run(lo, b, plan, out), want, **CHOL_TOL["trsm"]["float32"])
        rec["ok"] = rec["ok"] and ok
        rec["ms"][str(plan)] = cuda_ms(torch, lambda: run(lo, b, plan, out), reps=5)
    rec["library_ms"] = cuda_ms(
        torch, lambda: torch.linalg.solve_triangular(lo, b, upper=False), reps=5
    )
    rec["bound_ms"] = _trsm_bound(batch, nb, r, lo_b, 4)[0]
    rec["best"] = min(rec["ms"], key=rec["ms"].get)
    return rec


def f32_scan(torch, gen, lib, sms, build_name) -> bool:
    run = solver(torch, lib, "trsm_f32")
    good = True
    sums = {"picked": 0.0, "best": 0.0, "library": 0.0, "bound": 0.0}
    for k in range(STEPS, 0, -1):
        rec = scan_shape(torch, gen, run, sms, 1, TILE, k * TILE, 1)
        good = good and rec["ok"]
        for plan, ms in rec["ms"].items():
            sums[plan] = sums.get(plan, 0.0) + ms
        sums["picked"] += rec["ms"][str(rec["picked"])]
        sums["best"] += rec["ms"][rec["best"]]
        sums["library"] += rec["library_ms"]
        sums["bound"] += rec["bound_ms"]
        print(json.dumps({"build": build_name, "f32_scan": f"exact_step_r{k * TILE}",
                          **rec}), flush=True)
    print(json.dumps({"build": build_name, "f32_sweep_exact_panel512_ms_sum": sums}),
          flush=True)
    for case, batch, nb, r, lo_b in F32_SHAPES:
        rec = scan_shape(torch, gen, run, sms, batch, nb, r, lo_b)
        good = good and rec["ok"]
        print(json.dumps({"build": build_name, "f32_scan": case, **rec}), flush=True)
    return good


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier commit to hold f64 to")
    ap.add_argument("--compare", nargs="*", default=(),
                    help="NAME=DIR: another tree whose f32 trsm to scan too")
    ap.add_argument("--no-scan", action="store_true", help="skip the f32 plan scan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trsm_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    libs = build(args.parent, args.compare)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    good = True
    if args.parent:
        good = f64_bits(torch, gen, libs, sms) and good
    for name, lib in libs.items():
        if name != "parent" and not args.no_scan:
            good = f32_scan(torch, gen, lib, sms, name) and good
    print(json.dumps({"ok": good}), flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
