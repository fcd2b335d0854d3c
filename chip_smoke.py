#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n-side 128]

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``.  Phases, each printing one JSON line per result:

1. device   the card's name and power limit; the CUDA kernels under
            src/repro_torch/kernels/csrc are built from source (into
            src/repro_torch/kernels/build/) and the build time printed.
2. kernels  each hand-written kernel against its plain PyTorch version on
            the card, at the shapes the main path gives it, with its time,
            the plain version's, a library yardstick where one exists, and
            the least time the card could take (bound).
3. main     the generator-direct TLR log-likelihood (GEN -> compress ->
            TLR Cholesky -> solve) through ``tlr_loglik(from_tiles=True,
            gen="kernel")`` on n = n_side^2 Morton-ordered locations of a
            jittered grid, bivariate parsimonious Matérn (m = 2 n), tile 512,
            max rank 128, TLR7, float64; z is simulated on the card and the
            dense exact log-likelihood is the reference (its Cholesky factor
            is kept as the dense cokriging oracle of the serve phase).  It
            fails unless the factorization status is ok, the relative gap to
            the exact value is <= 1e-5 and every kernel was launched during
            the evaluation.
4. serve    cokriging serving at the same configuration, locations and z:
            ``fit_factor`` once (pair-major GEN + compress, TLR Cholesky,
            both sweeps), then 8 ``predict_batch`` requests of 512 uniform
            locations and one with 16 conditional draws.  It fails unless
            the factor's status is ok, every served mean is within 1e-3
            (max abs gap over max abs) of dense cokriging, variances are
            finite and >= 0, lower <= mean <= upper, a request with a NaN
            location is refused with ``nonfinite_locs``, and every kernel
            was launched during the phase.
5. exact    the exact blocked Cholesky in panel form through
            ``dist_exact_loglik(pairwise_distances(locs), z, params,
            panel=512)`` at the same configuration, locations and z (Sigma
            from the distances, then per panel step POTRF, TRSM and the SYRK
            kernel's trailing update).  It fails unless the loglik is finite,
            within 1e-7 (relative) of the main phase's dense exact loglik,
            and the phase launched syrk nk - 1, potrf nk and trsm 2 nk - 1
            times (nk = m / 512).
6. mle      Nelder–Mead estimation through ``fit`` with the generator-direct
            TLR backend (tile 512, max rank 128, TLR7, all six parameters
            free) on n = 48^2 locations of the same jittered grid (depth cut
            for time: one evaluation at n = 16384 takes minutes), z simulated
            on the card from the main Matérn truth, 3 iterations.  It fails
            unless the fitted loglik is finite, no evaluation was clamped to
            the penalty, the fitted objective is <= the objective at the
            start, a fresh ``tlr_loglik`` at the fitted parameters equals the
            fitted loglik to 1e-10 (relative), and tlr_mm, potrf and trsm
            were launched during the fit.

Then a ``kernels`` JSON line (the per-kernel summary; ``launches`` sums the
main, serve, exact and mle runs, ``launches_by_path`` splits them), the
nvidia-smi line,
and, as the last line, ``{"ok": true, "device": {...}}``.  Any failed phase
makes the script exit non-zero without that last line; so does a missing
CUDA device or a missing checkout around the script.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense):
# HBM3 3.35 TB/s, FP64 34 TFLOP/s on the CUDA cores and 67 TFLOP/s on the
# tensor cores, FP32 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    ("elementwise", "float64"): 34e12,
    ("elementwise", "float32"): 67e12,
    ("matmul", "float64"): 67e12,
    ("matmul", "float32"): 67e12,
}
# Arithmetic operations per matern_tile element (exp and sqrt counted as one).
MATERN_OPS = {0.5: 10, 1.5: 12, 2.5: 15}
# The tolerances of tests/test_kernels.py.
TOL = {
    "float64": dict(rtol=1e-10, atol=1e-12),
    "float32": dict(rtol=2e-3, atol=1e-3),
}
SOURCES = {
    "matern_tile": (
        "src/repro_torch/kernels/csrc/matern_tile.cu",
        "src/repro/kernels/matern_tile.py:82",
    ),
    "tlr_mm": (
        "src/repro_torch/kernels/csrc/tlr_mm.cu",
        "src/repro/kernels/tlr_mm.py:41",
    ),
    "potrf": (
        "src/repro_torch/kernels/csrc/potrf.cu",
        "src/repro/kernels/chol_tiles.py:52",
    ),
    "trsm": (
        "src/repro_torch/kernels/csrc/trsm.cu",
        "src/repro/kernels/chol_tiles.py:88",
    ),
    "syrk": (
        "src/repro_torch/kernels/csrc/syrk.cu",
        "src/repro/kernels/chol_tiles.py:117",
    ),
}
# The tolerances of tests/test_kernels.py::test_potrf_kernel and
# ::test_trsm_kernel.
CHOL_TOL = {
    "potrf": {
        "float64": dict(rtol=1e-9, atol=1e-11),
        "float32": dict(rtol=5e-4, atol=5e-4),
    },
    "trsm": {
        "float64": dict(rtol=1e-9, atol=1e-11),
        "float32": dict(rtol=1e-3, atol=1e-3),
    },
}
# The main configuration (PERF.md section 4).
NUGGET, TOL_TLR, TILE, KMAX = 1e-8, 1e-7, 512, 128
MATERN = dict(sigma11=1.0, sigma22=1.0, a=0.03, nu11=0.5, nu22=1.5, beta=0.5)
# The kernels the main and serve paths run (the exact path adds syrk).
TLR_KERNELS = ("matern_tile", "tlr_mm", "potrf", "trsm")
# The mle phase: grid side (n = 48^2, m = 4608, 9 tiles of 512) and the
# Nelder–Mead iterations.
MLE_N_SIDE, MLE_ITERS = 48, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float, kind: str, dtype: str):
    """(least milliseconds, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at the card's published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[(kind, dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(torch, got, want, rtol: float, atol: float):
    """(max |got - want|, whether |got - want| <= atol + rtol |want| holds)."""
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all())
    ok = ok and bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def phase_device(torch, st):
    from repro_torch.kernels import _build

    st["smi"] = nvidia_smi()
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    report = []
    if log.exists():
        lines = log.read_text().splitlines()
        report = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit(
        {
            "phase": "device",
            "ok": True,
            "nvidia_smi": st["smi"],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "build_s": build_s,
            "library": lib.name,
            "ptxas": report,
        }
    )


def check_matern(torch, tag, la, lb, nu, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.matern_tile import matern_tile_cuda

    inv_range, amp = 1.0 / 0.03, 1.0
    dname = str(la.dtype).split(".")[-1]
    got = matern_tile_cuda(la, lb, inv_range, amp, nu=nu)
    want = ref.matern_tile_ref(la, lb, inv_range, amp, nu)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, **TOL[dname])
    n, m = la.shape[0], lb.shape[0]
    isz = la.element_size()
    nbytes = (n + m) * 2 * isz + n * m * isz
    b_ms, b_by = bound(nbytes, n * m * MATERN_OPS[nu], "elementwise", dname)
    rec = {
        "phase": "kernel_check",
        "kernel": "matern_tile",
        "case": tag,
        "shape": [n, m],
        "nu": nu,
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": TOL[dname],
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if timed:
        rec["ms"] = cuda_ms(
            torch, lambda: matern_tile_cuda(la, lb, inv_range, amp, nu=nu)
        )
        rec["plain_ms"] = cuda_ms(
            torch, lambda: ref.matern_tile_ref(la, lb, inv_range, amp, nu)
        )
        rec["library_ms"] = None
    emit(rec)
    return rec


def check_tlr_mm(torch, gen, tag, dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.tlr_mm import tlr_mm_cuda

    # the largest SYRK of the main path: panel step 0, the T-1 = 63 live rows
    # of (nb, kmax) = (512, 128) factors onto their diagonal tiles
    B, nb, k = 63, 512, 128
    s = (math.sqrt(nb) * k) ** -0.25  # keeps the update of order one
    kw = dict(generator=gen, dtype=dtype, device="cuda")
    ua, va, ub, vb = (s * torch.randn((B, nb, k), **kw) for _ in range(4))
    acc = torch.randn((B, nb, nb), **kw)
    if tag == "padded":
        for t in (ua, va, ub, vb):
            t[:, :, k // 2 :] = 0.0
        short = [t[:, :, : k // 2] for t in (ua, va, ub, vb)]
        want = ref.tlr_mm_ref(*short, acc)
    else:
        want = ref.tlr_mm_ref(ua, va, ub, vb, acc)
    got = tlr_mm_cuda(ua, va, ub, vb, acc)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    # sums run in another order: atol scales with the largest value
    scale = float(torch.maximum(acc.abs().max(), want.abs().max()))
    if dname == "float64":
        tol = dict(rtol=0.0, atol=1e-10 * scale)
    else:
        tol = dict(rtol=2e-3, atol=1e-3 * scale)
    err, ok = max_err(torch, got, want, **tol)
    isz = acc.element_size()
    nbytes = (4 * B * nb * k + 2 * B * nb * nb) * isz
    flops = 2 * B * (2 * nb * k * k + nb * nb * k)
    b_ms, b_by = bound(nbytes, flops, "matmul", dname)
    rec = {
        "phase": "kernel_check",
        "kernel": "tlr_mm",
        "case": tag,
        "shape": [B, nb, k],
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": tol,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if timed:
        rec["ms"] = cuda_ms(torch, lambda: tlr_mm_cuda(ua, va, ub, vb, acc))
        rec["plain_ms"] = cuda_ms(torch, lambda: ref.tlr_mm_ref(ua, va, ub, vb, acc))
        rec["library_ms"] = cuda_ms(
            torch,
            lambda: torch.baddbmm(
                acc, torch.bmm(ua, torch.bmm(va.mT, vb)), ub.mT, alpha=-1.0
            ),
        )
    emit(rec)
    return rec


def _spd(torch, gen, b, nb, dtype):
    """a a^T + nb I, as tests/test_kernels.py::_spd_batch, made in float64."""
    a = torch.randn((b, nb, nb), generator=gen, dtype=torch.float64, device="cuda")
    return (a @ a.mT + nb * torch.eye(nb, dtype=torch.float64, device="cuda")).to(dtype)


def _potrf_bound(b, nb, isz):
    # read the tile once, write the factor once; nb^3/3 flops a tile
    dname = "float64" if isz == 8 else "float32"
    return bound(2 * b * nb * nb * isz, b * nb**3 / 3, "matmul", dname)


def _trsm_bound(b, nb, r, lo_b, isz):
    # read L (once if broadcast) and B, write X; nb^2 r flops a tile
    dname = "float64" if isz == 8 else "float32"
    nbytes = (lo_b * nb * nb + 2 * b * nb * r) * isz
    return bound(nbytes, b * nb * nb * r, "matmul", dname)


def check_potrf(torch, gen, tag, b, nb, dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chol_tiles import potrf_cuda

    dname = str(dtype).split(".")[-1]
    a = _spd(torch, gen, b, nb, dtype)
    got = potrf_cuda(a)
    want = ref.potrf_ref(a)
    torch.cuda.synchronize()
    tol = CHOL_TOL["potrf"][dname]
    err, ok = max_err(torch, got, want, **tol)
    b_ms, b_by = _potrf_bound(b, nb, a.element_size())
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "case": tag,
        "shape": [b, nb, nb],
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": tol,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if timed:
        rec["ms"] = cuda_ms(torch, lambda: potrf_cuda(a))
        rec["plain_ms"] = cuda_ms(torch, lambda: ref.potrf_ref(a))
        rec["library_ms"] = cuda_ms(torch, lambda: torch.linalg.cholesky_ex(a))
    emit(rec)
    return rec


def check_potrf_failure(torch, gen):
    """Two bad tiles (indefinite; a negative last pivot) between good ones:
    the bad ones come back all NaN, the good ones as cholesky_ex gives."""
    from repro_torch.kernels.chol_tiles import potrf_cuda

    nb = 512
    a = _spd(torch, gen, 4, nb, torch.float64)
    a[1] -= 1e4 * torch.eye(nb, dtype=a.dtype, device="cuda")
    a[2, nb - 1, nb - 1] = -1.0
    got = potrf_cuda(a)
    want, info = torch.linalg.cholesky_ex(a)
    torch.cuda.synchronize()
    nan_tiles = [bool(torch.isnan(got[t]).all()) for t in range(4)]
    err, good = max_err(torch, got[0::3], want[0::3], **CHOL_TOL["potrf"]["float64"])
    ok = nan_tiles == [False, True, True, False] and good
    ok = ok and [int(x) for x in info.cpu()][1:3] != [0, 0]
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "case": "non_spd",
        "shape": [4, nb, nb],
        "dtype": "float64",
        "all_nan_tiles": nan_tiles,
        "max_abs_err_good_tiles": err,
        "ok": ok,
    }
    emit(rec)
    return rec


def check_potrf_matern(torch, locs, params):
    """One diagonal tile of the main configuration (the first 256 Morton
    locations), judged by its residual and by cholesky_ex."""
    from repro_torch.core.covariance import build_sigma_panel
    from repro_torch.kernels.chol_tiles import potrf_cuda

    blk = locs[: TILE // 2]
    a = build_sigma_panel(blk, blk, params, gen="kernel")
    a = a + NUGGET * torch.eye(TILE, dtype=a.dtype, device="cuda")
    a = a[None].contiguous()
    got = potrf_cuda(a)
    want, info = torch.linalg.cholesky_ex(a)
    torch.cuda.synchronize()
    norm = torch.linalg.norm(a)
    res = float(torch.linalg.norm(got @ got.mT - a) / norm)
    res_lib = float(torch.linalg.norm(want @ want.mT - a) / norm)
    agree = float((got - want).abs().max() / want.abs().max())
    ok = bool(torch.isfinite(got).all()) and int(info[0]) == 0
    # backward error of a stable Cholesky: a few ulp times nb; the factors
    # themselves may differ by the tile's condition number times the ulp
    ok = ok and res <= 1e-12 and agree <= 1e-4
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "case": "matern_diag_tile",
        "shape": [1, TILE, TILE],
        "dtype": "float64",
        "residual": res,
        "residual_cholesky_ex": res_lib,
        "max_rel_diff_vs_cholesky_ex": agree,
        "ok": ok,
    }
    emit(rec)
    return rec


def check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chol_tiles import trsm_cuda

    dname = str(dtype).split(".")[-1]
    lo = torch.linalg.cholesky(_spd(torch, gen, lo_b, nb, torch.float64))
    lo = lo.to(dtype).contiguous()
    rhs = torch.randn((b, nb, r), generator=gen, dtype=torch.float64, device="cuda")
    rhs = rhs.to(dtype)
    got = trsm_cuda(lo, rhs)
    want = ref.trsm_ref(lo, rhs)
    torch.cuda.synchronize()
    tol = CHOL_TOL["trsm"][dname]
    err, ok = max_err(torch, got, want, **tol)
    b_ms, b_by = _trsm_bound(b, nb, r, lo_b, rhs.element_size())
    rec = {
        "phase": "kernel_check",
        "kernel": "trsm",
        "case": tag,
        "shape": [b, nb, r],
        "lo_batch": lo_b,
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": tol,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if timed:
        rec["ms"] = cuda_ms(torch, lambda: trsm_cuda(lo, rhs))
        rec["plain_ms"] = cuda_ms(torch, lambda: ref.trsm_ref(lo, rhs))
        # the plain version is this one library call
        rec["library_ms"] = cuda_ms(
            torch, lambda: torch.linalg.solve_triangular(lo, rhs, upper=False)
        )
    emit(rec)
    return rec


def _syrk_bound(b, nb, k, isz):
    # read C and A once, write the square once; the lower triangle's
    # nb (nb + 1) / 2 * k FMAs are the least work for the function
    dname = "float64" if isz == 8 else "float32"
    nbytes = (2 * b * nb * nb + b * nb * k) * isz
    return bound(nbytes, 2 * b * nb * (nb + 1) / 2 * k, "matmul", dname)


def check_syrk(torch, gen, tag, b, nb, k, dtype, timed, path_layout=False):
    """syrk_cuda against syrk_ref.  With ``path_layout`` the operands come
    as the exact path passes them: C the trailing block of a larger matrix
    (rows strided) and A the transpose of the TRSM's (1, k, nb) output."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chol_tiles import syrk_cuda

    dname = str(dtype).split(".")[-1]
    kw = dict(generator=gen, dtype=dtype, device="cuda")
    if path_layout:
        c = torch.randn((b, nb + k, nb + k), **kw)[:, k:, k:]
        a = torch.randn((b, k, nb), **kw).mT
    else:
        c = torch.randn((b, nb, nb), **kw)
        a = torch.randn((b, nb, k), **kw)
    got = syrk_cuda(c, a)
    want = ref.syrk_ref(c, a)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got, want, **TOL[dname])
    del got, want
    b_ms, b_by = _syrk_bound(b, nb, k, c.element_size())
    rec = {
        "phase": "kernel_check",
        "kernel": "syrk",
        "case": tag,
        "shape": [b, nb, k],
        "dtype": dname,
        "path_layout": path_layout,
        "max_abs_err": err,
        "ok": ok,
        "tol": TOL[dname],
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if timed:
        rec["ms"] = cuda_ms(torch, lambda: syrk_cuda(c, a))
        rec["plain_ms"] = cuda_ms(torch, lambda: ref.syrk_ref(c, a))
        rec["library_ms"] = cuda_ms(
            torch, lambda: torch.baddbmm(c, a, a.mT, alpha=-1.0)
        )
    emit(rec)
    del c, a
    torch.cuda.empty_cache()
    return rec


def check_syrk_64bit(torch, gen):
    """nb = 46341 (nb^2 > 2^31 elements a matrix): the last rows (direct
    writes) and the last columns (transposed writes) against the plain
    version of those slices."""
    from repro_torch.kernels.chol_tiles import syrk_cuda

    nb, k, w = 46341, 64, 100
    kw = dict(generator=gen, dtype=torch.float64, device="cuda")
    c = torch.randn((1, nb, nb), **kw)
    a = torch.randn((1, nb, k), **kw)
    got = syrk_cuda(c, a)
    rows = c[0, -w:] - a[0, -w:] @ a[0].mT
    cols = c[0, :, -w:] - a[0] @ a[0, -w:].mT
    torch.cuda.synchronize()
    err_r, ok_r = max_err(torch, got[0, -w:], rows, **TOL["float64"])
    err_c, ok_c = max_err(torch, got[0, :, -w:], cols, **TOL["float64"])
    rec = {
        "phase": "kernel_check",
        "kernel": "syrk",
        "case": "offsets_past_2^31",
        "shape": [1, nb, k],
        "dtype": "float64",
        "max_abs_err": max(err_r, err_c),
        "ok": ok_r and ok_c,
        "tol": TOL["float64"],
    }
    emit(rec)
    del c, a, got
    torch.cuda.empty_cache()
    return rec


def phase_kernels(torch, st, n_side: int):
    from repro_torch.core.covariance import MaternParams, morton_order
    from repro_torch.core.simulate import grid_locations

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = []
    # matern_tile at the largest GEN panel of the main path: the strict-lower
    # panel of column 0, (T-1)*nbl rows by nbl = 256 location columns; and a
    # ragged shape
    locs = grid_locations(n_side, jitter=0.3, seed=0)
    locs = torch.as_tensor(locs[morton_order(locs)], device="cuda")
    rag = torch.rand((1000, 2), generator=gen, dtype=torch.float64, device="cuda")
    cases = [("panel", locs[256:], locs[:256]), ("ragged", rag, rag[:77])]
    for tag, la, lb in cases:
        for dtype in (torch.float64, torch.float32):
            la_t, lb_t = la.to(dtype).contiguous(), lb.to(dtype).contiguous()
            for nu in (0.5, 1.5, 2.5) if tag == "panel" else (1.5,):
                timed = tag == "panel" and dtype == torch.float64 and nu == 1.5
                rec = check_matern(torch, tag, la_t, lb_t, nu, timed)
                records.append(rec)
                if timed:
                    st.setdefault("summary", {})["matern_tile"] = rec
    for tag, dtype in (
        ("full", torch.float64),
        ("full", torch.float32),
        ("padded", torch.float64),
    ):
        timed = tag == "full" and dtype == torch.float64
        rec = check_tlr_mm(torch, gen, tag, dtype, timed)
        records.append(rec)
        if timed:
            st.setdefault("summary", {})["tlr_mm"] = rec
    # potrf: the panel-head tile of the main path, a batch, a ragged nb, the
    # README's serving tile (2048), bad tiles and a real Matérn tile
    cases = (
        ("path", 1, 512),
        ("batch", 8, 512),
        ("ragged", 3, 200),
        ("tile2048", 1, 2048),
    )
    for tag, b, nb in cases:
        for dtype in (torch.float64, torch.float32):
            timed = tag == "path" and dtype == torch.float64
            rec = check_potrf(torch, gen, tag, b, nb, dtype, timed)
            records.append(rec)
            if timed:
                st.setdefault("summary", {})["potrf"] = rec
    records.append(check_potrf_failure(torch, gen))
    params = MaternParams.bivariate(**MATERN, device="cuda")
    records.append(check_potrf_matern(torch, locs, params))
    # trsm: the panel TRSM (one L_kk for the 63 live V tiles of step 0:
    # r = 63 x 128 = 8064 columns in all), the sweep for alpha (r = 1), the
    # sweep of a 512-location request (r = 512 x 2), a ragged case and the
    # README's serving tile
    cases = (
        ("panel", 63, 512, 128, 1),
        ("wide", 1, 512, 8064, 1),
        ("alpha", 1, 512, 1, 1),
        ("predict", 1, 512, 1024, 1),
        ("ragged", 3, 200, 37, 3),
        ("tile2048", 4, 2048, 128, 1),
        ("panel4096", 1, 4096, 512, 1),
    )
    for tag, b, nb, r, lo_b in cases:
        for dtype in (torch.float64, torch.float32):
            timed = tag in ("panel", "wide", "alpha", "predict", "panel4096")
            timed = timed and dtype == torch.float64
            rec = check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed)
            records.append(rec)
            if tag == "panel" and timed:
                st.setdefault("summary", {})["trsm"] = rec
    # syrk: the first trailing update of the exact phase (m_k = 32256,
    # panel 512) in the operands' path layout, a batch in both dtypes, the
    # JAX test shapes, a ragged nb, k = 1, and offsets past 2^31
    cases = (
        ("path", 1, 32256, 512, True, (torch.float64,)),
        ("batch", 4, 512, 128, False, (torch.float64, torch.float32)),
        ("jax_2x64x64", 2, 64, 64, False, (torch.float64, torch.float32)),
        ("jax_4x32x16", 4, 32, 16, False, (torch.float64, torch.float32)),
        ("ragged", 2, 1000, 200, False, (torch.float64, torch.float32)),
        ("k1", 2, 300, 1, False, (torch.float64,)),
    )
    for tag, b, nb, k, path_layout, dtypes in cases:
        for dtype in dtypes:
            timed = tag == "path" or (tag == "batch" and dtype == torch.float64)
            rec = check_syrk(torch, gen, tag, b, nb, k, dtype, timed, path_layout)
            records.append(rec)
            if tag == "path":
                st.setdefault("summary", {})["syrk"] = rec
    records.append(check_syrk_64bit(torch, gen))
    if not all(rec["ok"] for rec in records):
        raise AssertionError("a kernel disagrees with its plain version")


def serve_requests():
    """The serve phase's 8 requests of 512 uniform locations, and one more
    for the conditional draws."""
    rng = np.random.default_rng(7)
    return [rng.uniform(0.05, 0.95, size=(512, 2)) for _ in range(9)]


def phase_main(torch, st, n_side: int):
    from repro_torch.core import tlr as tlr_module
    from repro_torch.core.covariance import MaternParams, morton_order
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.prediction import cokrige, dense_factor
    from repro_torch.core.simulate import grid_locations, simulate_mgrf
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    nugget, tol, tile, kmax = NUGGET, TOL_TLR, TILE, KMAX
    locs = grid_locations(n_side, jitter=0.3, seed=0)
    locs = locs[morton_order(locs)]
    params = MaternParams.bivariate(**MATERN, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    z = simulate_mgrf(gen, locs, params, nugget=nugget, device=dev)[0]
    exact = exact_loglik(locs, z, params, nugget=nugget, keep_chol=True, device=dev)
    ll_exact = float(exact.loglik)
    exact_s = time.perf_counter() - t0
    peak_exact = torch.cuda.max_memory_allocated()
    # the exact phase's inputs and its reference (the dense Cholesky)
    st["exact_ref"] = dict(
        locs=locs,
        z=z,
        params=params,
        loglik=ll_exact,
        logdet=float(exact.logdet),
        quad=float(exact.quad),
    )
    # the serve phase's inputs, and its dense cokriging oracle from Sigma's
    # factor, made before the factor is freed
    dense = dense_factor(locs, z, params, chol=exact.chol)
    requests = serve_requests()
    oracle = [cokrige(None, None, pred, factor=dense) for pred in requests]
    st["serve_inputs"] = dict(
        locs=locs, z=z, params=params, requests=requests, oracle=oracle
    )
    del exact, dense
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # Keep the compressed matrix tlr_loglik builds, for its memory footprint.
    kept = {}
    compress = tlr_module.tlr_compress_tiles

    def compress_and_keep(*a, **k):
        kept["t"] = compress(*a, **k)
        return kept["t"]

    tlr_module.tlr_compress_tiles = compress_and_keep
    ops.reset_launch_counts()
    times = {}
    t0 = time.perf_counter()
    try:
        res = tlr_module.tlr_loglik(
            None,
            z,
            params,
            tol=tol,
            max_rank=kmax,
            tile_size=tile,
            nugget=nugget,
            locs=locs,
            from_tiles=True,
            gen="kernel",
            device=dev,
            times=times,
        )
        ll_tlr = float(res.loglik)
    finally:
        tlr_module.tlr_compress_tiles = compress
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_tlr = torch.cuda.max_memory_allocated()
    status = res.status.as_dict()
    t_mat = kept.pop("t")
    foot = tlr_module.memory_footprint(t_mat)
    il, jl = torch.tril_indices(t_mat.n_tiles, t_mat.n_tiles, -1, device=dev)
    ranks = t_mat.ranks[il, jl].double()
    del t_mat

    gap = abs(ll_tlr - ll_exact)
    rel = gap / abs(ll_exact)
    st.setdefault("launches", {})["main"] = launches
    ok = status["ok"] and rel <= 1e-5 and math.isfinite(ll_tlr)
    ok = ok and all(launches[name] > 0 for name in TLR_KERNELS)
    emit(
        {
            "phase": "main",
            "ok": ok,
            "n": len(locs),
            "p": 2,
            "m": 2 * len(locs),
            "tile_size": tile,
            "max_rank": kmax,
            "tol": tol,
            "nugget": nugget,
            "phase_s": times,
            "tlr_loglik_s": total_s,
            "simulate_and_exact_s": exact_s,
            "loglik_tlr": ll_tlr,
            "loglik_exact": ll_exact,
            "abs_gap": gap,
            "rel_gap": rel,
            "status": status,
            "launches": launches,
            "memory_footprint": foot,
            "ranks": {"max": float(ranks.max()), "mean": float(ranks.mean())},
            "peak_bytes_tlr": peak_tlr,
            "peak_bytes_exact": peak_exact,
        }
    )
    if not ok:
        raise AssertionError("main path failed its checks")


def phase_serve(torch, st):
    from repro_torch.core.covariance import build_c0_panels
    from repro_torch.core.dist_tlr import dist_tlr_solve_lower_pairs
    from repro_torch.distribution.block_cyclic import pair_layout
    from repro_torch.kernels import ops
    from repro_torch.serving.cokrige_service import (
        CokrigeServeConfig,
        ServeError,
        fit_factor,
        predict_batch,
    )

    inputs = st.pop("serve_inputs")
    locs, z, params = inputs["locs"], inputs["z"], inputs["params"]
    dev = torch.device("cuda")
    cfg = CokrigeServeConfig(
        tile_size=TILE, max_rank=KMAX, tol=TOL_TLR, nugget=NUGGET, gen="kernel"
    )
    requests, oracle = inputs["requests"], inputs["oracle"]
    batch, n_req, n_draws = 512, 8, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = {}
    t0 = time.perf_counter()
    factor = fit_factor(locs, z, params, cfg, device=dev, times=times)
    status = factor.status.as_dict()
    fit_s = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    served, req_s = [], []
    for pred in requests[:n_req]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict_batch(factor, pred, cfg)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        served.append(out)
    peak_predict = torch.cuda.max_memory_allocated()
    drawn = predict_batch(
        factor, requests[n_req], cfg, generator=gen, n_draws=n_draws
    )
    bad = requests[0].copy()
    bad[5, 1] = np.nan
    try:
        predict_batch(factor, bad, cfg)
        refused = None
    except ServeError as err:
        refused = err.code
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    st.setdefault("launches", {})["serve"] = launches

    # where one request's time goes: the c0 panels, then the forward sweep
    m, nb = factor.m, factor.diag_l.shape[1]
    pred_t = torch.as_tensor(requests[0], device=dev)
    breakdown = {}
    t0 = time.perf_counter()
    nbl = nb // params.p
    c0 = build_c0_panels(factor.locs, pred_t, params, nbl=nbl, gen=cfg.gen)
    torch.cuda.synchronize()
    breakdown["c0_panels_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    layout = pair_layout(factor.diag_l.shape[0], 1)
    dist_tlr_solve_lower_pairs(
        factor.diag_l, factor.u, factor.v, c0.reshape(m, -1), layout=layout
    )
    torch.cuda.synchronize()
    breakdown["forward_sweep_ms"] = 1e3 * (time.perf_counter() - t0)
    del c0

    rels, checks = [], []
    for want, out in zip(oracle, served + [drawn]):
        rels.append(float((out.mean - want).abs().max() / want.abs().max()))
        var = out.variance
        fine = bool(torch.isfinite(var).all() and (var >= 0).all())
        fine = fine and bool((out.lower <= out.mean).all())
        fine = fine and bool((out.mean <= out.upper).all())
        checks.append(fine)
    draws_ok = tuple(drawn.draws.shape) == (n_draws, batch, 2)
    draws_ok = draws_ok and bool(torch.isfinite(drawn.draws).all())
    ms = sorted(1e3 * t for t in req_s)
    ok = status["ok"] and max(rels) <= 1e-3 and all(checks) and draws_ok
    ok = ok and refused == "nonfinite_locs"
    ok = ok and all(launches[name] > 0 for name in TLR_KERNELS)
    emit(
        {
            "phase": "serve",
            "ok": ok,
            "n": len(locs),
            "m": int(factor.m),
            "tile_size": TILE,
            "max_rank": KMAX,
            "tol": TOL_TLR,
            "nugget": NUGGET,
            "gen": cfg.gen,
            "fit_factor_s": fit_s,
            "phase_s": times,
            "status": status,
            "batch": batch,
            "requests": n_req,
            "predict_batch_ms": [1e3 * t for t in req_s],
            "predict_batch_p50_ms": float(np.median(ms)),
            "predict_batch_max_ms": ms[-1],
            "predictions_per_sec": n_req * batch / sum(req_s),
            "predictions_per_sec_p50": batch / (1e-3 * float(np.median(ms))),
            "request_breakdown": breakdown,
            "rel_err_vs_dense": rels,
            "intervals_ok": checks,
            "draws_ok": draws_ok,
            "refused_nan_request": refused,
            "launches": launches,
            "peak_bytes_fit": peak_fit,
            "peak_bytes_predict": peak_predict,
        }
    )
    if not ok:
        raise AssertionError("serve path failed its checks")


def phase_exact(torch, st):
    from repro_torch.core.covariance import pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.kernels import ops

    ref = st.pop("exact_ref")
    locs, z, params = ref["locs"], ref["z"], ref["params"]
    dev = torch.device("cuda")
    panel = TILE
    m = z.shape[-1]
    nk = m // panel
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dists = pairwise_distances(torch.as_tensor(locs, device=dev))
    torch.cuda.synchronize()
    dists_s = time.perf_counter() - t0
    times = {}
    t0 = time.perf_counter()
    res = dist_exact_loglik(
        dists, z, params, nugget=NUGGET, panel=panel, times=times
    )
    ll = float(res.loglik)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st.setdefault("launches", {})["exact"] = launches
    peak = torch.cuda.max_memory_allocated()
    del dists
    rel = abs(ll - ref["loglik"]) / abs(ref["loglik"])
    logdet_gap = abs(float(res.logdet) - ref["logdet"]) / abs(ref["logdet"])
    quad_gap = abs(float(res.quad) - ref["quad"]) / abs(ref["quad"])
    want = {"syrk": nk - 1, "potrf": nk, "trsm": 2 * nk - 1}
    ok = math.isfinite(ll) and rel <= 1e-7
    ok = ok and all(launches[name] == count for name, count in want.items())
    emit(
        {
            "phase": "exact",
            "ok": ok,
            "n": len(locs),
            "m": m,
            "panel": panel,
            "panel_steps": nk,
            "nugget": NUGGET,
            "exact_panel_loglik_s": total_s,
            "phase_s": times,
            "dists_s": dists_s,
            "loglik_panel": ll,
            "loglik_dense": ref["loglik"],
            "rel_gap": rel,
            "logdet_rel_gap": logdet_gap,
            "quad_rel_gap": quad_gap,
            "launches": launches,
            "launches_expected": want,
            "peak_bytes": peak,
        }
    )
    if not ok:
        raise AssertionError("exact panel path failed its checks")


def phase_mle(torch, st, n_side: int):
    from repro_torch.core.covariance import MaternParams
    from repro_torch.core.mle import (
        MLEConfig,
        apply_morton,
        fit,
        initial_guess,
        make_objective,
    )
    from repro_torch.core.simulate import grid_locations, simulate_mgrf
    from repro_torch.core.tlr import tlr_loglik
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    side = min(MLE_N_SIDE, n_side)
    locs = grid_locations(side, jitter=0.3, seed=0)
    truth = MaternParams.bivariate(**MATERN, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    z = simulate_mgrf(gen, locs, truth, nugget=NUGGET, device=dev)[0]
    cfg = MLEConfig(
        p=2,
        backend="tlr",
        tlr_from_tiles=True,
        profile=False,
        tile_size=TILE,
        tlr_max_rank=KMAX,
        tlr_tol=TOL_TLR,
        nugget=NUGGET,
        max_iters=MLE_ITERS,
    )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(locs, z, cfg, device=dev)
    ll = float(res.loglik)
    mle_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st.setdefault("launches", {})["mle"] = launches
    peak = torch.cuda.max_memory_allocated()

    # the objective at the start, and a fresh evaluation at the fitted point
    locs_m, z_m = apply_morton(locs, z, 2)
    objective, _ = make_objective(locs_m, z_m, cfg, device=dev)
    f_start = float(objective(initial_guess(2, False)))
    fresh = tlr_loglik(
        None,
        z_m,
        res.params,
        tol=TOL_TLR,
        max_rank=KMAX,
        tile_size=TILE,
        nugget=NUGGET,
        locs=locs_m,
        from_tiles=True,
        gen=cfg.gen,
        device=dev,
    )
    fresh_rel = abs(float(fresh.loglik) - ll) / abs(ll)
    clamped = int(res.clamped_evals)
    ok = math.isfinite(ll) and clamped == 0 and -ll <= f_start
    ok = ok and fresh_rel <= 1e-10
    ok = ok and all(launches[name] > 0 for name in ("tlr_mm", "potrf", "trsm"))
    fitted = {key: getattr(res.params, key).tolist() for key in res.params._fields}
    emit(
        {
            "phase": "mle",
            "ok": ok,
            "n": len(locs),
            "m": 2 * len(locs),
            "tile_size": TILE,
            "max_rank": KMAX,
            "tol": TOL_TLR,
            "nugget": NUGGET,
            "max_iters": MLE_ITERS,
            "mle_s": mle_s,
            "n_evals": res.n_evals,
            "n_iters": res.n_iters,
            "s_per_eval": mle_s / res.n_evals,
            "loglik": ll,
            "objective_start": f_start,
            "objective_fitted": -ll,
            "fresh_loglik_rel_gap": fresh_rel,
            "clamped_evals": clamped,
            "recovery_retries": int(res.recovery_retries),
            "fitted_params": fitted,
            "truth": MATERN,
            "launches": launches,
            "peak_bytes": peak,
        }
    )
    if not ok:
        raise AssertionError("mle path failed its checks")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--n-side",
        type=int,
        default=128,
        help="grid side: n = n_side^2 locations (default 128)",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = {}
    failed = []
    phases = (
        ("device", lambda: phase_device(torch, st)),
        ("kernels", lambda: phase_kernels(torch, st, args.n_side)),
        ("main", lambda: phase_main(torch, st, args.n_side)),
        ("serve", lambda: phase_serve(torch, st)),
        ("exact", lambda: phase_exact(torch, st)),
        ("mle", lambda: phase_mle(torch, st, args.n_side)),
    )
    for name, fn in phases:
        try:
            fn()
        except Exception as exc:  # report every phase, then fail the run
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(exc)})
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1

    kernels = []
    for name, rec in st["summary"].items():
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        by_path = {path: counts[name] for path, counts in st["launches"].items()}
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                **{key: rec[key] for key in keys},
                "library_ms": rec["library_ms"],
                "shape": rec["shape"],
                "dtype": rec["dtype"],
            }
        )
    emit({"kernels": kernels})
    print(st["smi"], flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
