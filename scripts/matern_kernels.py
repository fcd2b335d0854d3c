#!/usr/bin/env python3
"""Build and check the two Matérn kernels alone, with their times.

    python3 scripts/matern_kernels.py [--n-side 128]

Builds the kernels (at first use), prints the card's name and power limit,
the compiler's and cuobjdump's report of every instance of
``csrc/matern_tile.cu`` and ``csrc/matern_corr.cu`` (chip_smoke.py's
``matern_report``), then runs chip_smoke.py's ``check_materns``: both
kernels in both instances against their plain versions at the main path's
largest GEN panel (16128 x 256 at n_side 128) for nu in {0.5, 1.0, 1.5, 2.5}
in f64 and f32, on ragged shapes, at the edge values of u, and matern_corr
at the exact path's n^2 scaled distances, each f64 panel and exact case
timed beside its plain version (the card's time, chip_smoke's ``cuda_ms``)
and, at nu = 1, beside ``torch.special.modified_bessel_k1`` (K_1 only).
One JSON line a case; exits 1 if a check fails.  Needs one CUDA device and
nvcc.  About a minute on an H100, most of it the plain version at n^2.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    check_materns,
    emit,
    main_config,
    matern_report,
    nvidia_smi,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-side", type=int, default=128, help="grid side (n = side^2)")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("matern_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    lib = _build.build()
    log = lib.with_suffix(".log")
    report = matern_report(log.read_text() if log.exists() else "", lib)
    emit({"matern_report": report})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    locs, _, _ = main_config(torch, args.n_side, torch.device("cuda"))
    locs = torch.as_tensor(locs, device="cuda")
    records = check_materns(torch, {}, gen, locs)
    ok = report["ok"] and all(rec["ok"] for rec in records)
    emit({"ok": ok, "checks": len(records)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
