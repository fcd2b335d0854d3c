#!/usr/bin/env python3
"""Time PyTorch's CUDA SVD and QR back ends at the TLR path's shapes.

    python3 scripts/linalg_drivers.py

The compress phase SVDs (B, 512, 512) float64 tiles; the recompress QRs
(A, 512, 256) concatenations and SVDs (A, 256, 256) cores.  For each back end
(cuSOLVER with each ``driver``, and MAGMA) this prints one JSON line with the
milliseconds per matrix (CUDA events) and the largest singular-value error
against the gesvd driver, relative to each matrix's largest singular value.
Needs one CUDA device; the tiles come from the port's own generator.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def timed(torch, fn, reps=2):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, out


def svd_rows(torch, name, a):
    """One line per back end for the SVD of the batch ``a``."""
    batch = a.shape[0]
    torch.backends.cuda.preferred_linalg_library("cusolver")
    ref = torch.linalg.svdvals(a, driver="gesvd")
    backends = [("cusolver", d) for d in (None, "gesvd", "gesvdj")]
    for lib, drv in backends + [("magma", None)]:
        torch.backends.cuda.preferred_linalg_library(lib)
        row = {"op": "svd", "shape": name, "lib": lib, "driver": drv}
        try:
            ms, (_, s, _) = timed(
                torch, lambda: torch.linalg.svd(a, full_matrices=False, driver=drv)
            )
        except RuntimeError as exc:
            print(json.dumps({**row, "error": str(exc)[:200]}), flush=True)
            continue
        err = float(((s - ref).abs() / ref[:, :1]).max())
        row.update(ms_per_matrix=ms / batch, rel_sv_err=err)
        print(json.dumps(row), flush=True)
    torch.backends.cuda.preferred_linalg_library("default")


def main() -> int:
    import torch

    from repro_torch.core.covariance import (
        MaternParams,
        build_sigma_panel,
        morton_order,
    )
    from repro_torch.core.simulate import grid_locations

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    locs = grid_locations(128, jitter=0.3, seed=0)
    locs = torch.as_tensor(locs[morton_order(locs)], device=dev)
    params = MaternParams.bivariate(a=0.03, nu11=0.5, nu22=1.5, device=dev)
    batch = 16
    rows = locs[256 : 256 * (batch + 1)]
    tiles = build_sigma_panel(rows, locs[:256], params, gen="kernel")
    tiles = tiles.reshape(batch, 512, 512)
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=g, dtype=torch.float64, device=dev)
    cat = torch.randn((batch, 512, 256), **kw)
    core = torch.randn((batch, 256, 256), **kw)
    svd_rows(torch, "tile_512", tiles)
    svd_rows(torch, "core_256", core)
    for lib in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        ms, _ = timed(torch, lambda: torch.linalg.qr(cat))
        row = {"op": "qr", "shape": "cat_512x256", "lib": lib}
        print(json.dumps({**row, "ms_per_matrix": ms / batch}), flush=True)
    torch.backends.cuda.preferred_linalg_library("default")
    return 0


if __name__ == "__main__":
    sys.exit(main())
