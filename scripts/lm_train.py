#!/usr/bin/env python3
"""Run chip_smoke.py's train phase alone.

    python3 scripts/lm_train.py

LM training on the card as the train phase runs it: qwen3-4b at full width and depth
in bf16 (remat, naive attention) for a few steps on one repeated batch, the
ten architectures reduced in f32 against the CPU, the trainer's crash and
resume, and examples/torch/train_lm.py.  The training path runs no
hand-written kernel, so nothing is built.  One JSON line a part; exits 1
if one fails.  Needs one CUDA device.
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
        print("lm_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = {}
    try:
        chip_smoke.phase_train(torch, st)
    except AssertionError as exc:
        print(f"lm_train: {exc}", file=sys.stderr)
        return 1
    finally:
        print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
