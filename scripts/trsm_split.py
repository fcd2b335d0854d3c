#!/usr/bin/env python3
"""Time the f64 trsm's row split beside its 8-column strips and the library.

    python3 scripts/trsm_split.py

At alpha (1, 512, 1), (1, 4096, 1) and (1, 64, 1) (one block row: the
fixed cost of a call), where ``trsm_plan`` splits the rows, and at four
shapes of 8-column strips where it does not because the split's clusters
would fill more than half the card ((1, 512, 128), the TLR sweep's last
step, (2, 512, 128), (1, 512, 512) and (1, 4096, 512)), it runs the dmma_f64 instance
twice on the same inputs, with the row split (the cluster kernel) and
without it (the same plan otherwise: one block a strip), holds both
against ``solve_triangular`` at chip_smoke.py's ``CHOL_TOL``, and prints their times beside the library's, each taken by
chip_smoke's ``cuda_ms`` (the card's time, the runs queued behind a sleep).
Prints the card's name and power limit first and one JSON line a shape.
Needs one CUDA device and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import CHOL_TOL, _spd, cuda_ms, max_err, nvidia_smi  # noqa: E402

SHAPES = (
    (1, 64, 1),
    (1, 512, 1),
    (1, 512, 128),
    (2, 512, 128),
    (1, 512, 512),
    (1, 4096, 1),
    (1, 4096, 512),
)


def main() -> int:
    import torch

    from repro_torch.kernels import chol_tiles

    if not torch.cuda.is_available():
        print("trsm_split: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi(), flush=True)
    fn = chol_tiles._trsm_fn(torch.float64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tol = CHOL_TOL["trsm"]["float64"]
    failed = False
    for batch, nb, r in SHAPES:
        lo = torch.linalg.cholesky(_spd(torch, gen, 1, nb, torch.float64))
        lo = lo.contiguous()
        b = torch.randn((batch, nb, r), generator=gen, dtype=torch.float64,
                        device="cuda")
        plan = chol_tiles.trsm_plan(batch, nb, r, sms)
        if plan[0] != 8:
            raise AssertionError(f"{(batch, nb, r)} takes strips of {plan[0]}")
        out = torch.empty_like(b)
        nblk = -(-nb // chol_tiles.TRSM_BLOCK)
        dinv = torch.empty((1, nblk, 64, 64), dtype=b.dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def solve(split):
            args = (*plan[:3], split)
            code = fn(lo.data_ptr(), b.data_ptr(), out.data_ptr(), dinv.data_ptr(),
                      batch, nb, r, 1, *args, stream)
            if code:
                raise RuntimeError(f"trsm_f64 returned {code}")
            return out

        want = torch.linalg.solve_triangular(lo, b, upper=False)
        rec = {"shape": [batch, nb, r], "plan": list(plan)}
        for split in (1, 0):
            err, ok = max_err(torch, solve(split).clone(), want, **tol)
            rec[f"split{split}"] = {
                "max_abs_err": err,
                "ok": ok,
                "ms": cuda_ms(torch, lambda: solve(split)),
            }
            failed = failed or not ok
        rec["library_ms"] = cuda_ms(
            torch, lambda: torch.linalg.solve_triangular(lo, b, upper=False)
        )
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
