#!/usr/bin/env python3
"""Run chip_smoke.py's launch-tooling phases alone.

    python3 scripts/launch_tooling.py [--phases dryrun lowerables lm_mesh]

Builds the kernels (chip_smoke.py's device phase), then runs the phases
named, in that order (default: dryrun, then lowerables, as chip_smoke.py
runs them, the lowerables' CPU reference beside the dry-run's traces):
the dry-run's calibration against real runs and its production cells on
the fake meshes; the registry's eight cells on the card against the CPU
and the in-place Cholesky's peak; the LM mesh phase with its cached
prefill and decode steps.  One JSON line a phase; exits 1 if a phase
fails.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", default=["dryrun", "lowerables"],
                    choices=["lowerables", "dryrun", "lm_mesh"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("launch_tooling: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = {}
    chip_smoke.record_plans(st)
    chip_smoke.phase_device(torch, st)
    failed = []
    try:
        for i, name in enumerate(args.phases):
            st["phase"] = name
            kw = {}
            if name == "dryrun":
                kw["lowerables_next"] = "lowerables" in args.phases[i + 1:]
            try:
                getattr(chip_smoke, f"phase_{name}")(torch, st, **kw)
            except Exception as exc:
                traceback.print_exc()
                chip_smoke.emit({"phase": name, "ok": False, "error": repr(exc)})
                failed.append(name)
    finally:
        if "pool" in st:
            st["pool"].shutdown(cancel_futures=True)
    print(st.get("smi", ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
