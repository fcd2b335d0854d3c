#!/usr/bin/env python3
"""Run chip_smoke.py's lm_mesh phase alone.

    python3 scripts/lm_mesh.py

Builds the kernels (chip_smoke.py's device phase: the compiler's report and
the flash instances' register check), then runs the LM multi-device forms
as the lm_mesh phase does: the single-device references on the card, then
four ranks of a (2, 2) mesh over gloo (the sharded qwen3-4b prefill through
the flash kernel and train steps at 8 layers, the sharded mixtral-8x7b
prefill at 2 layers), each held against the references.  (The flash
kernel at a rank's head slice is the kernels phase's ``lm_mesh_rank``
case: ``scripts/flash_kernels.py --cases lm_mesh_rank path``.)  One JSON
line; exits 1 if a check fails.  Needs one CUDA device and nvcc.

    python3 scripts/lm_mesh.py --plant

runs the phase with a fault planted in the ranks (q_norm's and k_norm's
gradients not summed over "model"), and exits 0 only if the parameter
check, and only it, catches the fault.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_mesh: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plant = "--plant" in sys.argv[1:]
    st = {}
    chip_smoke.phase_device(torch, st)
    try:
        chip_smoke.phase_lm_mesh(torch, st, plant=plant)
    except AssertionError as exc:
        print(f"lm_mesh: {exc}", file=sys.stderr)
        if plant and str(exc).endswith("['params']"):
            print("lm_mesh: the planted fault was caught", flush=True)
            return 0
        return 1
    finally:
        print(st.get("smi", ""), flush=True)
    if plant:
        print("lm_mesh: the planted fault was not caught", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
