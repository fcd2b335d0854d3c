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
            dense exact log-likelihood is the reference.  It fails unless the
            factorization status is ok, the relative gap to the exact value
            is <= 1e-5 and every kernel was launched during the evaluation.

Then a ``kernels`` JSON line (the per-kernel summary), the nvidia-smi line,
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
}


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


def phase_kernels(torch, st, n_side: int):
    from repro_torch.core.covariance import morton_order
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
    if not all(rec["ok"] for rec in records):
        raise AssertionError("a kernel disagrees with its plain version")


def phase_main(torch, st, n_side: int):
    from repro_torch.core import tlr as tlr_module
    from repro_torch.core.covariance import MaternParams, morton_order
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.simulate import grid_locations, simulate_mgrf
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    nugget, tol, tile, kmax = 1e-8, 1e-7, 512, 128
    locs = grid_locations(n_side, jitter=0.3, seed=0)
    locs = locs[morton_order(locs)]
    params = MaternParams.bivariate(
        sigma11=1.0, sigma22=1.0, a=0.03, nu11=0.5, nu22=1.5, beta=0.5, device=dev
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    z = simulate_mgrf(gen, locs, params, nugget=nugget, device=dev)[0]
    exact = exact_loglik(locs, z, params, nugget=nugget, device=dev)
    ll_exact = float(exact.loglik)
    exact_s = time.perf_counter() - t0
    peak_exact = torch.cuda.max_memory_allocated()
    del exact
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
    st["launches"] = launches
    ok = status["ok"] and rel <= 1e-5 and math.isfinite(ll_tlr)
    ok = ok and all(v > 0 for v in launches.values())
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
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": st["launches"][name],
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
