#!/usr/bin/env python3
"""Time the kernels' dispatch: each wrapper called directly, through
``kernels.ops`` and, where the tree has them, through its ``torch.library``
custom op; and three paths end to end.

    python3 scripts/dispatch_cost.py [--src DIR] [--repeat 5]

``--src`` is the ``src`` directory of the tree to time (default this
checkout's): run it on an earlier commit's tree (``git archive <commit> |
tar -x -C archive/parent``, then ``--src archive/parent/src``) and on this
one, in one call, to compare the two.  Prints one JSON line: the card,
the microseconds a call of each (small) kernel through ``ops``, through
its op and through its wrapper, and the median seconds of the exact panel
loglik (n = 128^2, panel 512), the main cell's TLR evaluation at a quarter
of its locations (``chip_smoke.py``'s parameters, tile 512, kmax 128,
n = 64^2, with its compress and factorize seconds) and qwen3-4b's prefill
of (2, 4096) at full width and depth (bf16, the flash kernel).
Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dispatch_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.chol_tiles import potrf_cuda, syrk_cuda, trsm_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tlr_mm import tlr_mm_cuda

    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(1, 64, 64, generator=gen, device=dev, dtype=torch.float64)
    a = a @ a.mT + 64 * torch.eye(64, device=dev, dtype=torch.float64)
    b = torch.randn(1, 64, 8, generator=gen, device=dev, dtype=torch.float64)
    u = torch.randn(1, 64, 8, generator=gen, device=dev, dtype=torch.float64)
    q = torch.randn(8, 128, 64, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, 128, 64, generator=gen, device=dev).to(torch.bfloat16)
    calls = {
        "flash": (lambda: ops.attention(q, kv, kv), lambda: flash_attention_cuda(q, kv, kv)),
        "potrf": (lambda: ops.potrf(a), lambda: potrf_cuda(a)),
        "trsm": (lambda: ops.trsm(a, b), lambda: trsm_cuda(a, b)),
        "syrk": (lambda: ops.syrk(a, b), lambda: syrk_cuda(a, b)),
        "tlr_mm": (lambda: ops.tlr_mm(u, u, u, u, a), lambda: tlr_mm_cuda(u, u, u, u, a)),
    }
    lib = getattr(torch.ops, "repro_torch", None)
    has_ops = lib is not None and hasattr(lib, "potrf")
    op_calls = {}
    if has_ops:
        op_calls = {
            "flash": lambda: lib.flash_attention(q, kv, kv, True, 0, None),
            "potrf": lambda: lib.potrf(a),
            "trsm": lambda: lib.trsm(a, b),
            "syrk": lambda: lib.syrk(a, b),
            "tlr_mm": lambda: lib.tlr_mm(u, u, u, u, a),
        }
    per_call = {}
    for name, (via_ops, direct) in calls.items():
        per_call[name] = {}
        tags = [("ops_us", via_ops), ("wrapper_us", direct)]
        if name in op_calls:
            tags.append(("op_us", op_calls[name]))
        for tag, fn in tags:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            per_call[name][tag] = (time.perf_counter() - t0) / 2000 * 1e6

    from repro_torch.core.covariance import MaternParams, morton_order, pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.core.simulate import grid_locations
    from repro_torch.core.tlr import tlr_loglik

    def timed(fn, reps=args.repeat):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return _median(out)

    params = MaternParams.bivariate(a=0.03, nu11=0.5, nu22=1.5, beta=0.5, device=dev)
    locs = grid_locations(128, jitter=0.3, seed=0)
    locs = torch.as_tensor(locs[morton_order(locs)], device=dev)
    z = torch.randn(2 * len(locs), generator=gen, device=dev, dtype=torch.float64)
    dists = pairwise_distances(locs)
    paths = {"exact_s": timed(lambda: dist_exact_loglik(dists, z, params, panel=512))}
    del dists
    # the main cell (chip_smoke.py's MATERN, NUGGET, TOL_TLR, TILE, KMAX) at
    # a quarter of its locations
    main_params = MaternParams.bivariate(
        sigma11=1.0, sigma22=1.0, a=0.03, nu11=0.5, nu22=1.5, beta=0.5, device=dev)
    main_locs = grid_locations(64, jitter=0.3, seed=0)
    main_locs = main_locs[morton_order(main_locs)]
    main_z = torch.randn(2 * len(main_locs), generator=gen, device=dev,
                         dtype=torch.float64)
    main_times = []

    def main_cell():
        times = {}
        tlr_loglik(None, main_z, main_params, tol=1e-7, max_rank=128, tile_size=512,
                   nugget=1e-8, locs=main_locs, from_tiles=True, gen="kernel",
                   device=dev, times=times)
        main_times.append(times)

    paths["main_quarter_s"] = timed(main_cell, reps=3)
    paths["main_quarter_phase_s"] = {
        k: _median([t[k] for t in main_times[1:]]) for k in main_times[-1]}
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_model

    cfg = get_arch("qwen3-4b")
    model = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 4096)), device=dev)

    def prefill():
        with torch.inference_mode():
            forward(model, cfg, toks, attn_impl="kernel")

    paths["prefill_s"] = timed(prefill)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(src=args.src, card=smi, per_call=per_call, **paths,
                          custom_ops=has_ops)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
