#!/usr/bin/env python3
"""Run chip_smoke.py's mesh phase alone, with the references it needs.

    python3 scripts/mesh_forms.py

Builds the kernel library, then computes on one rank what the mesh phase
compares with, as the dist and exact phases do: ``dist_tlr_loglik`` at the
dist phase's inputs (n = 64^2, tile 512, max rank 128, TLR7, f64),
block-cyclic and masked, with their seconds, peak memory and factor rank
totals, and ``dist_exact_loglik`` at panel 512 on the main cell's inputs
(n = 128^2).  Then it runs the mesh phase (W = 4 ranks over gloo on the
card, and one rank over NCCL), whose JSON line it prints.  Exits 1 if a
check fails.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def references(torch, st) -> None:
    """The dist and exact phases' single-device results the mesh phase reads."""
    from repro_torch.core.covariance import pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.simulate import simulate_mgrf

    cs = chip_smoke
    dev = torch.device("cuda")
    locs, params, gen = cs.main_config(torch, cs.DIST_N_SIDE, dev)
    z = simulate_mgrf(gen, locs, params, nugget=cs.NUGGET, device=dev)[0]
    records = {}
    forms = (("dist_block_cyclic", dict(block_cyclic=True)), ("dist_masked", {}))
    for name, kw in forms:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kept = []
        restore = cs.capture_factorizations(kept)
        t0 = time.perf_counter()
        try:
            res = dist_tlr_loglik(
                None, z, locs=locs, params=params, from_tiles=True, tol=cs.TOL_TLR,
                max_rank=cs.KMAX, tile_size=cs.TILE, nugget=cs.NUGGET, gen="kernel",
                device=dev, **kw,
            )
            ll = float(res.loglik)
        finally:
            restore()
        records[name] = dict(
            loglik=ll, s=time.perf_counter() - t0,
            peak_bytes=torch.cuda.max_memory_allocated(),
            factor_rank_total=kept[0]["factor_rank_total"],
        )
    st["dist_ref"] = dict(locs=locs, z=z.cpu().numpy(), records=records)
    chip_smoke.emit({"phase": "mesh_references", "dist": records})

    locs, params, gen = cs.main_config(torch, 128, dev)
    z = simulate_mgrf(gen, locs, params, nugget=cs.NUGGET, device=dev)[0]
    dists = pairwise_distances(torch.as_tensor(locs, device=dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dist_exact_loglik(dists, z, params, nugget=cs.NUGGET, panel=cs.TILE)
    ll = float(res.loglik)
    st["exact_mesh_ref"] = dict(
        locs=locs, z=z.cpu().numpy(), loglik=ll, s=time.perf_counter() - t0,
        peak_bytes=torch.cuda.max_memory_allocated(),
    )
    chip_smoke.emit({"phase": "mesh_references", "exact": {
        k: v for k, v in st["exact_mesh_ref"].items() if k not in ("locs", "z")}})
    del dists, z
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_forms: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    chip_smoke.emit({"build_s": time.perf_counter() - t0})
    st = {"phase": "mesh"}
    chip_smoke.count_plain_kv(st)
    try:
        references(torch, st)
        t0 = time.perf_counter()
        chip_smoke.phase_mesh(torch, st)
        chip_smoke.emit({"mesh_phase_s": time.perf_counter() - t0})
    except AssertionError as exc:
        print(f"mesh_forms: {exc}", file=sys.stderr)
        return 1
    finally:
        print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
