#!/usr/bin/env python3
"""Two records of chip_smoke.py's lm_families phase, again in float32.

    python3 scripts/lm_f32_checks.py

Builds the kernels (chip_smoke.py's device phase), then runs the
lm_families measurement (``chip_smoke.phase_lm_family``, with its seeds and
depths from ``LM_FAMILIES``) for mixtral-8x7b (8 of its 32 layers) and
mamba2-780m (48 layers), each in its config's bfloat16 and in float32.  In
float32 mixtral's prefill runs flash's f32 instance (``tf32x3_f32``, head
dim 128) against the naive path, so the share of tokens whose experts
differ between the two shows whether bf16 rounding makes mixtral's routing
flips; mamba2's ``decode_rel_gap`` shows whether its decode gap in bf16
comes from bf16 rounding or from its decode state.  Prints each run's
record (the lm_family line; its bf16 checks do not apply to float32) and
one summary line a run.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

RUNS = (
    ("mixtral-8x7b", "bfloat16"),
    ("mixtral-8x7b", "float32"),
    ("mamba2-780m", "bfloat16"),
    ("mamba2-780m", "float32"),
)
KEYS = (
    "prefill_timed_launches_by_instance",
    "moe_layers",
    "routing_flip_share",
    "routing_flip_share_by_layer",
    "prefill_rel_gap",
    "prefill_rel_gap_all_tokens",
    "decode_rel_gap",
    "decode_rel_gap_all_rows",
    "decode_routing_flipped_rows",
    "prefill_forward_ms",
    "peak_bytes",
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_f32_checks: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.configs as configs

    st = {}
    chip_smoke.phase_device(torch, st)
    depth_seed = {name: (depth, seed) for name, depth, seed in chip_smoke.LM_FAMILIES}
    get_arch = configs.get_arch
    failed = False
    try:
        for name, dtype in RUNS:
            configs.get_arch = lambda n, dt=dtype: dataclasses.replace(
                get_arch(n), dtype=dt
            )
            rec = chip_smoke.phase_lm_family(torch, st, name, *depth_seed[name])
            summary = {"arch": name, "dtype": dtype, **{k: rec[k] for k in KEYS}}
            print(json.dumps({"lm_f32_check": summary}), flush=True)
            failed |= not (rec["prefill_finite"] and rec["decode_finite"])
            torch.cuda.empty_cache()
    finally:
        configs.get_arch = get_arch
    print(st["smi"], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
