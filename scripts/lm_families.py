#!/usr/bin/env python3
"""Run chip_smoke.py's lm_families phase alone.

    python3 scripts/lm_families.py [--archs NAME ...]

Builds the kernels (chip_smoke.py's device phase: the compiler's report and
the flash instances' register check), then serves each architecture of
``LM_FAMILIES`` (or those named) at full width as the lm_families phase
does: the prefill forward through the flash kernel against the naive path,
``generate`` and its timed steps, decode against a cacheless forward.  One
JSON line an architecture; exits 1 if one fails.  Needs one CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="*", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lm_families: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.archs is not None:
        known = {name for name, _, _ in chip_smoke.LM_FAMILIES}
        unknown = set(args.archs) - known
        if unknown:
            ap.error(f"not in LM_FAMILIES: {sorted(unknown)}")
        chip_smoke.LM_FAMILIES = tuple(
            fam for fam in chip_smoke.LM_FAMILIES if fam[0] in args.archs
        )
    st = {}
    chip_smoke.phase_device(torch, st)
    try:
        chip_smoke.phase_lm_families(torch, st)
    except AssertionError as exc:
        print(f"lm_families: {exc}", file=sys.stderr)
        return 1
    print(st["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
