#!/usr/bin/env python3
"""Build and check the flash_attention kernel alone, with its times.

    python3 scripts/flash_kernels.py [--cases TAG ...]

Builds the kernels (at first use), prints the card's name and power limit
and the compiler's report of ``csrc/flash_attention.cu`` by instance
(``flash_ptxas``: registers, spills, one entry a head-dim instance) with
the HGMMA and UTMALDG counts of its SASS where cuobjdump sits beside nvcc,
then runs chip_smoke.py's flash checks (``check_flash_attention``) at
every case of ``FLASH_CASES``, or at the cases named, each against
``attention_ref`` at ``ATTN_TOL``, the ``FLASH_TIMED`` ones timed beside the
plain version and SDPA.  One JSON line a case; exits 1 if an instance is
not built to the registers its setmaxnreg split assumes or a check fails.
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    FLASH_CASES,
    FLASH_REGS,
    FLASH_TIMED,
    check_flash_attention,
    emit,
    flash_ptxas,
    flash_sass,
    nvidia_smi,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=None, help="FLASH_CASES tags")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    if not torch.cuda.is_available():
        print("flash_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    lib = _build.build()
    log = lib.with_suffix(".log")
    report = flash_ptxas(log.read_text() if log.exists() else "")
    sass = flash_sass(lib)
    built = sass.get("ok", True)
    for inst, want in FLASH_REGS.items():
        regs = [ln for ln in report[inst] if "registers" in ln]
        built = built and len(regs) == len(HEAD_DIMS[inst])
        built = built and all(f"Used {want} registers" in ln for ln in regs)
    emit({"flash_ptxas": report, "flash_sass": sass, "ok": built})
    if not built:
        return 1  # a launch could hang on a setmaxnreg split it cannot meet
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = []
    for tag, bh, bkv, sq, skv, d, dname, window in FLASH_CASES:
        if args.cases is not None and tag not in args.cases:
            continue
        timed = (tag, dname) in FLASH_TIMED
        dtype = getattr(torch, dname)
        records.append(
            check_flash_attention(
                torch, gen, tag, bh, bkv, sq, skv, d, dtype, window, timed
            )
        )
    ok = built and all(rec["ok"] for rec in records)
    emit({"ok": ok, "checks": len(records)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
