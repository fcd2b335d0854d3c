#!/usr/bin/env python3
"""Time and trace the exact panel-form likelihood in a fresh process.

    python3 scripts/exact_profile.py [--n-side 128] [--panels 512 4096]

Builds the main configuration of chip_smoke.py through its
``main_config`` (n = n_side^2 jittered, Morton-ordered locations,
bivariate Matérn, its nugget, z simulated as its main phase does), then
runs ``dist_exact_loglik`` at each panel twice and prints
its ``gen``, ``factorize`` and ``solve`` seconds; then one more evaluation
a panel under ``torch.profiler``, printing the device time of the 16
kernels that take the most (GEN's elementwise kernels, then the
factorization's).  Prints the card's name and power
limit first and one JSON line per result.  Needs one CUDA device and nvcc
(the kernels are built at first use).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import NUGGET, main_config  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-side", type=int, default=128)
    ap.add_argument("--panels", type=int, nargs="+", default=[512, 4096])
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.covariance import pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.core.simulate import simulate_mgrf

    if not torch.cuda.is_available():
        print("exact_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    locs, params, gen = main_config(torch, args.n_side, dev)
    z = simulate_mgrf(gen, locs, params, nugget=NUGGET, device=dev)[0]
    dists = pairwise_distances(torch.as_tensor(locs, device=dev))

    def evaluate(panel):
        torch.cuda.empty_cache()
        times = {}
        res = dist_exact_loglik(
            dists, z, params, nugget=NUGGET, panel=panel, times=times
        )
        return times, float(res.loglik)

    for panel in args.panels:
        for rep in range(2):
            times, ll = evaluate(panel)
            rec = {"panel": panel, "rep": rep, "phase_s": times, "loglik": ll}
            print(json.dumps(rec), flush=True)
    for panel in args.panels:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            times, _ = evaluate(panel)
            torch.cuda.synchronize()
        events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
        kernels = [
            {
                "name": ev.key[:80],
                "calls": ev.count,
                "device_ms": ev.self_device_time_total / 1e3,
            }
            for ev in events
            if ev.self_device_time_total > 0
            and not ev.key.startswith(("aten::", "cuda"))
        ]
        rec = {"panel": panel, "profiled_phase_s": times, "kernels": kernels[:16]}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
