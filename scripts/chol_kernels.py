#!/usr/bin/env python3
"""Build and check the potrf, trsm and syrk kernels alone, with their times.

    python3 scripts/chol_kernels.py [--dtypes float32 float64] [--scan]

Builds the kernels (at first use), prints the card's name and power limit
and the compiler's report (registers, spills) of every kernel of
``csrc/potrf.cu``, ``csrc/trsm.cu`` and ``csrc/syrk.cu``, then runs
chip_smoke.py's potrf, trsm and syrk checks in the dtypes given (both
instances by default): ``check_potrfs`` (the path tile, batches, ragged,
nb = 1, 2048 and 4096, timed beside ``cholesky_ex``), the bad-pivot
checks, ``check_trsms`` (the panel, wide, alpha, predict and nb = 4096
shapes and the exact paths' first and last panel solves, timed beside
``solve_triangular``, ragged shapes, a real Matérn L_kk, and the summed
sweeps of one TLR factorization's panel TRSMs and of the exact_f32
path's 63 panel solves) and ``check_syrks`` (the exact path's first update
in its layout, timed beside ``baddbmm``, the JAX shapes, ragged layouts,
and the summed sweep of the panel-512 path's 63 updates).  One JSON line
a case; exits 1 if a check fails.
With ``--scan`` it also times potrf at (1, nb, nb) for nb = 64 to 512
beside ``cholesky_ex`` (the cost of each 64-column step).  Needs one CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    check_potrf_failure,
    check_potrf_failure_first_panel,
    check_potrfs,
    check_syrks,
    check_trsms,
    emit,
    main_config,
    nvidia_smi,
    ptxas_entries,
)


def scan_potrf(torch, gen, dtype, sizes=(64, 128, 192, 256, 384, 512)):
    """potrf_cuda's and cholesky_ex's milliseconds at (1, nb, nb)."""
    from chip_smoke import _spd, cuda_ms
    from repro_torch.kernels.chol_tiles import potrf_cuda

    out = {}
    for nb in sizes:
        a = _spd(torch, gen, 1, nb, dtype)
        out[nb] = {
            "ms": cuda_ms(torch, lambda: potrf_cuda(a)),
            "library_ms": cuda_ms(torch, lambda: torch.linalg.cholesky_ex(a)),
        }
    return {"scan": "potrf", "dtype": str(dtype), "by_nb": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", nargs="*", default=["float32", "float64"])
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chol_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    lib = _build.build()
    log = lib.with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    for src in ("potrf.cu", "trsm.cu", "syrk.cu"):
        emit({"ptxas": src, "kernels": ptxas_entries(text, src)})
    dtypes = tuple(getattr(torch, name) for name in args.dtypes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    st = {}
    records = check_potrfs(torch, st, gen, dtypes)
    for dtype in dtypes:
        records.append(check_potrf_failure(torch, gen, dtype))
        records.append(check_potrf_failure_first_panel(torch, gen, dtype))
    locs, params, _ = main_config(torch, 128, torch.device("cuda"))
    locs = torch.as_tensor(locs, device="cuda")
    records.extend(check_trsms(torch, st, gen, locs, params, dtypes))
    records.extend(check_syrks(torch, st, gen, dtypes))
    if args.scan:
        for dtype in dtypes:
            emit(scan_potrf(torch, gen, dtype))
    ok = all(rec["ok"] for rec in records)
    emit({"ok": ok, "checks": len(records)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
