#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n-side 128]

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``.  Phases, each printing one JSON line per result:

1. device   the card's name and power limit; the CUDA kernels under
            src/repro_torch/kernels/csrc are built from source (into
            src/repro_torch/kernels/build/) and the build time printed,
            with the compiler's report of the two flash_attention
            instances (registers, spills) and of the f64 (dmma_f64)
            instances of potrf, tlr_mm, trsm and syrk (registers, spills,
            and the DMMA instructions in each kernel's SASS).  It fails
            unless the bf16 flash instance was compiled to the 168
            registers a thread that its setmaxnreg split assumes, unless,
            where cuobjdump sits beside nvcc, its SASS holds HGMMA (wgmma)
            and UTMALDG (TMA loads), unless every product kernel of the
            dmma_f64 instances holds DMMA (the FP64 tensor cores), and unless
            every instance of the two Matérn kernels is built without spills,
            with 128-bit stores where it stores vectors and without local
            memory in the general instance (its tables stay in __constant__).
2. kernels  each of the seven hand-written kernels against its plain
            PyTorch version on the card, at the shapes the main path gives
            it, with its time, the plain version's, a library yardstick
            where one exists, and the least time the card could take
            (bound).  matern_tile (from locations) and matern_corr (from
            scaled distances) are held in both instances (halfint: the
            closed forms; general: K_nu per element) and both dtypes at the
            main path's largest GEN panel for nu in {0.5, 1.0, 1.5, 2.5}, on
            ragged shapes, at the edge values of u (0, 1e-8, 2 and its
            neighbours, 47, 800) for nu from 0.05 to 6 (f64), and
            matern_corr at the exact path's n^2 scaled distances (timed);
            a general record's bound counts the steps each element's loop
            takes on these inputs (``general_steps``), and its ``steps``
            the mean, the largest and the warps' divergence.
            flash_attention is held at every shape its two
            instances take (bf16 on wgmma, f32 on FMAs), potrf, tlr_mm,
            trsm and syrk at the shapes of both of theirs (f64 on DMMA, f32
            on FMAs), each record naming its instance.  potrf is also timed
            at (1, 2048, 2048) and (1, 4096, 4096), and failed on a bad
            pivot in the first panel of a 4096 tile; tlr_mm at B = 63, 8
            and 1, with out=acc (checked against the plain version on a
            copy), and summed over a factorization's sweep of B = 63 down to
            1; at the dist phase's first SYRK (B = 15) in both instances and
            with f32 factors and a float64 acc (the mixed SYRK, which must
            also equal the f32 form, cast and added, bit for bit), and its
            f32 instance summed over the mixed_f32 sweep of B = 15 down to
            1, all f32 and with the float64 acc; the f32 instance is held at
            a tolerance reasoned from its f32 sums (tlr_mm_f32_tol).  trsm
            is timed at the panel, wide, alpha and predict shapes and at
            nb = 4096 (the exact phase's panel, its first and last solves),
            held on a real Matérn L_kk, and held and summed over one TLR
            factorization's panel TRSMs; syrk is timed at the exact phase's
            first update at panel 512 and at panel 4096, and held and
            summed over the panel-512 path's 63 updates, each beside its
            library call.  Times are the card's: cuda_ms queues the runs
            behind a sleep on the card, so the host's launch overhead
            between short calls does not enter.
3. main     the generator-direct TLR log-likelihood (GEN -> compress ->
            TLR Cholesky -> solve) through ``tlr_loglik(from_tiles=True,
            gen="kernel")`` on n = n_side^2 Morton-ordered locations of a
            jittered grid, bivariate parsimonious Matérn (m = 2 n), tile 512,
            max rank 128, TLR7, float64; z is simulated on the card and the
            dense exact log-likelihood is the reference (its Cholesky factor
            is kept as the dense cokriging oracle of the serve phase).  It
            fails unless the factorization status is ok, the relative gap to
            the exact value is <= 1e-5, every kernel was launched during the
            evaluation and the general instance of matern_tile ran (the
            cross pair, nu12 = 1.0).
4. serve    cokriging serving at the same configuration, locations and z:
            ``fit_factor`` once (pair-major GEN + compress, TLR Cholesky,
            both sweeps; the general instance of matern_tile for the cross
            pair), then 8 ``predict_batch`` requests of 512 uniform
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
            kernel's trailing update), then again at the reference's default
            panel=4096 on the same distances.  Each fails unless the loglik
            is finite, within 1e-7 (relative) of the main phase's dense
            exact loglik, and the evaluation launched syrk nk - 1, potrf nk
            and trsm 2 nk - 1 times (nk = m / panel: 63 / 64 / 127 and
            7 / 8 / 15), all of the dmma_f64 instances, and Sigma's pairs
            through matern_corr (its general instance for nu12).
6. mle      Nelder–Mead estimation through ``fit`` with the generator-direct
            TLR backend (tile 512, max rank 128, TLR7, all six parameters
            free) on n = 48^2 locations of the same jittered grid (depth cut
            for time: one evaluation at n = 16384 takes minutes), z simulated
            on the card from the main Matérn truth, 3 iterations.  It fails
            unless the fitted loglik is finite, no evaluation was clamped to
            the penalty, the fitted objective is <= the objective at the
            start, a fresh ``tlr_loglik`` at the fitted parameters equals the
            fitted loglik to 1e-10 (relative), and matern_tile (its general
            instance: nu is free), tlr_mm, potrf and trsm were launched
            during the fit.
7. assess   the paper's Algorithm 1 (MLOE/MMOM) at the main cell's full
            size: n = 16384 observation locations (m = 32768), 1024 uniform
            prediction locations, theta_a the main Matérn with its range
            x 1.2.  ``mloe_mmom`` (GEN: two dense Sigmas through
            matern_corr; FACT: their Cholesky factors; COMP: every location
            at once) first at theta_a = theta, then against theta_a, then
            the naive per-variable criteria.  It fails unless |MLOE| and
            |MMOM| <= 1e-8 at the truth, MLOE >= -1e-9, every E_t > 0 and
            E_t,a >= E_t - 1e-9, the paper's per-location loop (Level 2:
            ``solve_triangular`` against ``torch.linalg.cholesky`` factors of
            freshly built Sigmas) gives E_t, E_t,a and E_a at the first 8
            locations within 1e-9 (relative), the naive MLOE differs from
            the cokriging one by more than 1e-6, and matern_corr ran (its
            general instance for nu12).  It reports the GEN / FACT / COMP
            seconds (the paper's Figs. 10-11 split) and the peak memory.
8. dist     the single-device forms of the distributed TLR likelihood and
            the precision policy at the main cell's widths (tile 512, max
            rank 128, TLR7), n cut to 64^2 = 4096 (m = 8192, 16 tiles) for
            time: (1) ``tlr_loglik(from_tiles=True)``, (2)
            ``dist_tlr_loglik(from_tiles=True)`` (masked grid), (3) the
            same with super_panels=4 and col_block=2, (4) with
            block_cyclic=True, (5) ``tlr_loglik`` with
            dtype_policy="mixed_f32".  Each records its phase seconds, peak
            memory, launches, storage dtypes and factor rank total.  It
            fails unless every status is ok, (2)-(4) are within 1e-8
            (relative) of (1) with the same rank total, f64 storage and no
            fma_f32 launch, and (5) stores U/V in float32 with float64
            diagonal tiles and logdet, launches tlr_mm's fma_f32 instance
            once a panel step (its float64-acc form) and its dmma_f64 never,
            and is within 1e-5 of (2).  The gap of (1) to the dense exact
            loglik is reported, not gated.
   plans    every plan the f64 trsm and syrk took on the main, serve,
            exact, mle, assess and dist paths (trsm: strip columns, update
            tile, row split; syrk: tile edge; each a kernel of its own) is
            one that a kernel check of phase 2 held against the plain
            version.
9. lm       LM serving for qwen3-4b at full width (d 2560, 32/8 heads, head
            dim 128, vocab 151936), random weights from a seeded generator.
            First a depth-4 float32 copy: ``forward(attn_impl="kernel")``
            against ``attn_impl="naive"`` on (1, 4096) tokens, relative gap
            (max abs difference over max abs) <= 1e-4.  Then the full
            36-layer bf16 model (its parameter count must be the reference's,
            4,022,468,096): the prefill forward on (2, 4096) tokens through
            the flash kernel (one warm-up, one run timed by CUDA events),
            finite, within 5e-2 of the naive path and with exactly 36 flash
            launches a forward, all of the bf16 instance (0 on the naive
            path; the depth-4 f32 forward's are all of the f32 instance);
            then the engine,
            ``generate`` on (8, 512) prompts for 64 greedy steps (cached
            attention: 0 flash launches), its prefill and each decode step
            timed, and the last step's logits within 5e-2 of a cacheless
            naive forward over prompt plus generated tokens.

Before each path runs, every kernel's launch count is set to 0, and read
after it: the kernels of a path must have launched during it.  Then a
``kernels`` JSON line (the per-kernel summary; ``launches`` sums the main,
serve, exact (panel 512), exact4096, mle, assess, dist (its five
evaluations) and lm runs, where lm is the timed prefill forward and the
engine's ``generate``, and ``launches_by_path`` splits them), the
nvidia-smi line,
and, as the last line, ``{"ok": true, "device": {...}}``.  Any failed phase
makes the script exit non-zero without that last line; so does a missing
CUDA device or a missing checkout around the script.  The geostat paths
(main, serve, exact, exact4096, mle) fail if an fma_f32 instance of
potrf, tlr_mm, trsm or syrk was launched during them (dist: only its
mixed_f32 evaluation may, and must, launch tlr_mm's), and every geostat
path fails if the plain K_nu (``core.matern.kv``) ran on a CUDA tensor
during it: every order of their GEN runs in matern_tile or matern_corr.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense):
# HBM3 3.35 TB/s, FP64 34 TFLOP/s on the CUDA cores and 67 TFLOP/s on the
# tensor cores, FP32 67 TFLOP/s, BF16 989 TFLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    ("elementwise", "float64"): 34e12,
    ("elementwise", "float32"): 67e12,
    ("matmul", "float64"): 67e12,
    ("matmul", "float32"): 67e12,
    ("matmul", "bfloat16"): 989e12,
}
# Arithmetic operations of the Matérn kernels an element (exp, log, sqrt,
# sinh, cosh and a division counted as one each): a distance from two
# locations (matern_tile only); the halfint instance's closed form and
# amplitude by order; the general instance's (csrc/matern.cuh): its fixed
# part, Temme's series (set-up, a step), Steed's CF2 (set-up, a step) and
# an upward recurrence.
DIST_OPS = 6
HALFINT_OPS = {0.5: 4, 1.5: 6, 2.5: 9}
GENERAL_OPS = {"base": 9, "temme": (21, 16), "cf2": (19, 22), "recurrence": 4}
# The orders the paths run (nu11, nu12 and nu22 of the main cell, and the
# third closed form), and the edge values of u with the orders of the f64
# edge grid: u = 0 (M = 1), 1e-8, 2 and its neighbours (the choice of
# Temme's series or CF2), 47 (about the main cell's largest), 800 (exp(-u)
# underflows: M = 0, not NaN); nl from 0 to 6, mu < 0, = 0 and > 0.
MATERN_PATH_NUS = (0.5, 1.0, 1.5, 2.5)
MATERN_EDGE_US = (0.0, 1e-8, 2.0 - 2.0**-52, 2.0, 2.0 + 2.0**-51, 47.0, 800.0)
MATERN_EDGE_NUS = (0.05, 0.73, 1.0, 2.283, 3.7, 6.0, 0.5, 1.5, 2.5)
# tlr_mm's f32 instance: how many times the estimated rounding difference
# of two f32 evaluations may separate it from its plain version
# (tlr_mm_f32_tol).
F32_SUM_SIGMAS = 8.0
# The tolerances of tests/test_kernels.py.
TOL = {
    "float64": dict(rtol=1e-10, atol=1e-12),
    "float32": dict(rtol=2e-3, atol=1e-3),
}
# Registers a thread of the bf16 flash instance at launch: its setmaxnreg
# split gives 2 x 128 consumers 240 and 128 producers 24.
FLASH_WGMMA_REGS = (2 * 128 * 240 + 128 * 24) // 384
SOURCES = {
    "matern_tile": (
        "src/repro_torch/kernels/csrc/matern_tile.cu",
        "src/repro/kernels/matern_tile.py:82",
    ),
    # no Pallas kernel: the reference's jnp while_loops
    "matern_corr": (
        "src/repro_torch/kernels/csrc/matern_corr.cu",
        "src/repro/core/matern.py:251",
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
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:82",
    ),
}
# The f64 instances' kernels carry this tag in their names; these of them
# run products: each name must match a kernel of the SASS, and every kernel
# it matches (a template may have several instances) must run DMMA.
DMMA_KERNEL_TAG = "_f64"
DMMA_PRODUCT_KERNELS = (
    "potrf_panel_f64",
    "potrf_update_f64",
    "tlr_mm_w_f64",
    "tlr_mm_out_f64",
    "trsm_strip_f64",
    "trsm_rows_f64",
    "trsm_update_f64",
    "syrk_dmma_f64",
)
# The sources of the dmma_f64 instances.
DMMA_SOURCES = ("potrf.cu", "tlr_mm.cu", "trsm.cu", "syrk.cu")
# The sources of the Matérn kernels (instances halfint and general).
MATERN_SOURCES = ("matern_tile.cu", "matern_corr.cu")
# The tolerances of tests/test_kernels.py's flash attention tests: _tol for
# bf16, the window and decode tests' for f32.
ATTN_TOL = {
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float32": dict(rtol=2e-5, atol=2e-5),
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
# Live rows of the first TLR panel step there: T - 1 = 32768 / 512 - 1.
SWEEP_B = 63
# The reference's default panel of dist_exact_loglik, the exact phase's
# second evaluation.
EXACT_PANEL = 4096
MATERN = dict(sigma11=1.0, sigma22=1.0, a=0.03, nu11=0.5, nu22=1.5, beta=0.5)
# The kernels the main and serve paths run (the exact path adds syrk).
TLR_KERNELS = ("matern_tile", "tlr_mm", "potrf", "trsm")
# The mle phase: grid side (n = 48^2, m = 4608, 9 tiles of 512) and the
# Nelder–Mead iterations.
MLE_N_SIDE, MLE_ITERS = 48, 3
# The assess phase: prediction locations, their seed, the range factor of
# the misspecified theta_a (tests/test_prediction_assessment.py's "slight"),
# the locations the per-location oracle recomputes, and the gates: the
# criteria at the truth, LOE >= 0 and E_t,a >= E_t up to rounding, the
# oracle's relative agreement, naive against cokriging.
ASSESS_NPRED, ASSESS_SEED, ASSESS_A_FACTOR, ASSESS_ORACLE = 1024, 11, 1.2, 8
ASSESS_ZERO, ASSESS_ROUND, ASSESS_ORACLE_TOL, ASSESS_NAIVE_GAP = 1e-8, 1e-9, 1e-9, 1e-6
# The dist phase: grid side (n = 64^2, m = 8192, 16 tiles of 512; n cut from
# the main cell's 128^2 for time), the live rows of its first panel step
# (the SYRK batch of the mixed_f32 sweep), its two-level form, and the gates:
# the f64 forms against tlr_loglik, mixed_f32 against the masked form.
DIST_N_SIDE, DIST_SUPER, DIST_COL_BLOCK = 64, 4, 2
DIST_SWEEP_B = 2 * DIST_N_SIDE**2 // TILE - 1
DIST_F64_GAP, DIST_MIXED_GAP = 1e-8, 1e-5
# The lm phase (PERF.md section 4): qwen3-4b at full width and depth, bf16;
# its parameter count as the reference's init_model makes it; prefill batch
# and length; the engine's prompts and greedy steps; the gates.
LM_ARCH, LM_PARAMS = "qwen3-4b", 4_022_468_096
LM_PREFILL = (2, 4096)
LM_PROMPTS, LM_STEPS = (8, 512), 64
LM_F32_GAP, LM_BF16_GAP, LM_DECODE_GAP = 1e-4, 5e-2, 5e-2


# Clock cycles of the sleep that cuda_ms queues its runs behind.
QUEUE_SLEEP_CYCLES = 5_000_000


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
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events.  The
    runs are queued behind a sleep of about 2.5 ms on the card, so that the
    host has issued them before the card reaches the first: the time is the
    card's, without the host's launch overhead between short calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


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
    text = log.read_text() if log.exists() else ""
    lines = text.splitlines()
    report = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    flash = flash_ptxas(text)
    regs = [ln for ln in flash["wgmma_bf16"] if "registers" in ln]
    want = f"Used {FLASH_WGMMA_REGS} registers"
    regs_ok = len(regs) == 4 and all(want in ln for ln in regs)
    sass = flash_sass(lib)
    dmma = dmma_report(text, lib)
    matern = matern_report(text, lib)
    st["flash_ok"] = regs_ok and sass.get("ok", True)
    ok = st["flash_ok"] and dmma["ok"] and matern["ok"]
    emit(
        {
            "phase": "device",
            "ok": ok,
            "nvidia_smi": st["smi"],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "build_s": build_s,
            "library": lib.name,
            "ptxas": report,
            "flash_ptxas": flash,
            "flash_sass": sass,
            "dmma_f64": dmma,
            "matern": matern,
        }
    )
    if not st["flash_ok"]:
        raise AssertionError("the bf16 flash instance is not built as designed")
    if not dmma["ok"]:
        raise AssertionError("a dmma_f64 product kernel has no DMMA in its SASS")
    if not matern["ok"]:
        raise AssertionError("a Matérn kernel is not built as designed")


def flash_ptxas(log_text: str) -> dict:
    """The compiler's report lines of flash_attention.cu's entry functions,
    by instance: ``flash_wgmma_kernel`` (bf16) and ``flash_kernel`` (f32)."""
    section = log_text.split("== flash_attention.cu", 1)[-1].split("\n== ", 1)[0]
    out = {"wgmma_bf16": [], "fma_f32": []}
    key = None
    for line in section.splitlines():
        if "Compiling entry function" in line:
            key = "wgmma_bf16" if "flash_wgmma_kernel" in line else "fma_f32"
            out[key].append(line.split("'")[1])
        elif key and ("registers" in line or "spill" in line or "wgmma" in line):
            out[key].append(line.strip())
    return out


@functools.cache
def sass_functions(lib):
    """Each kernel's SASS in the built library, by mangled name (cuobjdump
    beside nvcc, run once a library); None where cuobjdump is missing."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300
    ).stdout
    parts = sass.split("Function : ")[1:]
    return {part.split("\n", 1)[0].strip(): part for part in parts}


def ptxas_entries(log_text: str, src: str, keep=lambda name: True) -> dict:
    """The compiler's registers and spill lines of each entry function of
    ``src`` that ``keep`` accepts, from the build log."""
    section = log_text.split(f"== {src}", 1)[-1].split("\n== ", 1)[0]
    report, name = {}, None
    for line in section.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if keep(name) else None
            if name:
                report[name] = {"ptxas": []}
        elif name and ("registers" in line or "spill" in line):
            report[name]["ptxas"].append(line.strip())
    return report


def flash_sass(lib) -> dict:
    """Counts of HGMMA, UTMALDG and UTMASTG in each bf16 flash kernel's SASS,
    where cuobjdump sits beside nvcc; ok unless an HGMMA or UTMALDG count is
    0."""
    functions = sass_functions(lib)
    if functions is None:
        return {"cuobjdump": None}
    counts = {}
    for name, part in functions.items():
        if "flash_wgmma_kernel" in name:
            ops = ("HGMMA", "UTMALDG", "UTMASTG")
            counts[name] = {op: part.count(op) for op in ops}
    ok = len(counts) == 4 and all(
        c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in counts.values()
    )
    return {"cuobjdump": True, "kernels": counts, "ok": ok}


def dmma_report(log_text: str, lib) -> dict:
    """For each kernel of the dmma_f64 instances of potrf, tlr_mm, trsm and
    syrk: the compiler's registers and spill lines, and the DMMA
    instructions in its SASS (cuobjdump).  ok unless cuobjdump is missing or
    one of the product kernels (potrf's panel and update, both tlr_mm
    stages, trsm's strip and update, syrk's tile) is missing or has an
    instance without DMMA."""
    report = {}
    for src in DMMA_SOURCES:
        report.update(ptxas_entries(log_text, src, lambda n: DMMA_KERNEL_TAG in n))
    functions = sass_functions(lib)
    if functions is None:
        return {"kernels": report, "cuobjdump": None, "ok": False}
    for name in report:
        if name in functions:
            report[name]["DMMA"] = functions[name].count("DMMA")
    ok = True
    for product in DMMA_PRODUCT_KERNELS:
        matches = [n for n in report if product in n]
        ok = ok and bool(matches)
        ok = ok and all(report[n].get("DMMA", 0) > 0 for n in matches)
    return {"kernels": report, "cuobjdump": True, "ok": ok}


def matern_report(log_text: str, lib) -> dict:
    """For each kernel of matern_tile.cu and matern_corr.cu (instance by
    its template arguments: dtype, NU2 with 0 the general instance, and
    whether it stores vectors): the compiler's registers and spill lines
    and, from its SASS (cuobjdump), its 128-bit global stores, its
    local-memory accesses and its reads of __constant__ bank 3 (the general
    instance's tables).  ok unless cuobjdump is missing, a kernel is
    missing, one spills, a vector instance has no 128-bit store or a general
    instance touches local memory."""
    report = {}
    for src in MATERN_SOURCES:
        report.update(ptxas_entries(log_text, src))
    functions = sass_functions(lib)
    if functions is None:
        return {"kernels": report, "cuobjdump": None, "ok": False}
    for name, rec in report.items():
        part = functions.get(name, "")
        rec["STG128"] = len(re.findall(r"STG\.E[.\w]*\.128", part))
        rec["local"] = len(re.findall(r"\b(?:LDL|STL)\b", part))
        rec["const3"] = part.count("c[0x3]")
    ok = len(report) == 2 * 2 * 4 * 2
    for name, rec in report.items():
        match = re.search(r"I([df])Li(\d)ELb([01])EE", name)
        ok = ok and match is not None and name in functions
        spills = re.findall(r"(\d+) bytes spill", " ".join(rec["ptxas"]))
        ok = ok and not any(int(v) for v in spills)
        if match and match.group(3) == "1":
            ok = ok and rec["STG128"] > 0
        if match and match.group(2) == "0":
            ok = ok and rec["local"] == 0
    return {"kernels": report, "cuobjdump": True, "ok": ok}


def general_work(torch, u, nu):
    """(operations, step statistics) of the general instance on the scaled
    distances u: each element's steps as the plain loop counts them on these
    inputs (``general_steps``: the kernel's arithmetic, its own stop), times
    GENERAL_OPS.  Statistics: the mean and largest steps an element (u > 0),
    the share of elements on Temme's series, and, where the elements fall
    into warps of 32 lanes of 4 neighbouring elements (both kernels' layout
    when u.numel() is a multiple of 128), the mean over warps and element
    slots of the steps the warp runs: the slowest Temme lane's plus the
    slowest CF2 lane's, since a warp runs both branches one after the
    other."""
    from repro_torch.kernels.matern_tile import general_scalars, general_steps

    steps, temme = general_steps(u, nu)
    pos = u.reshape(-1) > 0
    n = steps.double()
    t_base, t_step = GENERAL_OPS["temme"]
    c_base, c_step = GENERAL_OPS["cf2"]
    per = torch.where(temme, t_base + t_step * n, c_base + c_step * n)
    per = per + GENERAL_OPS["recurrence"] * general_scalars(nu).nl
    per = torch.where(pos, per, 0.0) + GENERAL_OPS["base"]
    ops = float(per.sum())
    stats = {
        "steps_mean": float(n[pos].mean()) if bool(pos.any()) else 0.0,
        "steps_max": int(steps.max()),
        "temme_share": float(temme.double().mean()),
    }
    if steps.numel() % 128 == 0:
        w, tw = steps.view(-1, 32, 4), temme.view(-1, 32, 4)
        cf2 = ~tw & pos.view(-1, 32, 4)
        slot = torch.where(tw, w, 0).amax(1) + torch.where(cf2, w, 0).amax(1)
        stats["warp_slot_steps_mean"] = float(slot.double().mean())
    del steps, temme, pos, n, per
    return ops, stats


def _matern_record(torch, kernel, tag, shape, nu, dname, got, want, nbytes, ops):
    from repro_torch.kernels.matern_tile import instance

    err, ok = max_err(torch, got, want, **TOL[dname])
    b_ms, b_by = bound(nbytes, ops, "elementwise", dname)
    return {
        "phase": "kernel_check",
        "kernel": kernel,
        "instance": instance(nu),
        "case": tag,
        "shape": list(shape),
        "nu": nu,
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": TOL[dname],
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def _matern_times(torch, rec, run, plain, u, nu, plain_reps=10):
    """The kernel's, the plain version's and the K_1 yardstick's times into
    ``rec`` (the yardstick at nu = 1 only: no PyTorch call computes M_nu)."""
    rec["ms"] = cuda_ms(torch, run)
    reps = dict(reps=plain_reps, warmup=0 if plain_reps < 10 else 2)
    rec["plain_ms"] = cuda_ms(torch, plain, **reps)
    rec["library_ms"] = None
    if nu == 1.0:
        rec["k1_only_ms"] = cuda_ms(torch, lambda: torch.special.modified_bessel_k1(u))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def check_matern(torch, tag, la, lb, nu, timed):
    """matern_tile_cuda against matern_tile_ref on (n, 2) x (m, 2) panels."""
    from repro_torch.core.covariance import pairwise_distances
    from repro_torch.kernels import ref
    from repro_torch.kernels.matern_tile import instance, matern_tile_cuda

    inv_range, amp = (1.0, 1.0) if tag == "edges" else (1.0 / 0.03, 1.0)
    dname = str(la.dtype).split(".")[-1]
    got = matern_tile_cuda(la, lb, inv_range, amp, nu=nu)
    want = ref.matern_tile_ref(la, lb, inv_range, amp, nu)
    torch.cuda.synchronize()
    n, m = la.shape[0], lb.shape[0]
    isz = la.element_size()
    nbytes = (n + m) * 2 * isz + n * m * isz
    general = instance(nu) == "general"
    u = None
    if general or timed:
        u = pairwise_distances(la, lb) * inv_range
    if general:
        ops, stats = general_work(torch, u, nu)
        ops += n * m * DIST_OPS
    else:
        ops, stats = n * m * (DIST_OPS + HALFINT_OPS[nu]), None
    rec = _matern_record(
        torch, "matern_tile", tag, (n, m), nu, dname, got, want, nbytes, ops
    )
    if stats:
        rec["steps"] = stats
    if tag == "edges":
        rec["zero_at_800"] = float(got[0, -1]) == 0.0
        rec["ok"] = rec["ok"] and rec["zero_at_800"] and float(got[0, 0]) == 1.0
    del got, want
    if timed:
        _matern_times(
            torch,
            rec,
            lambda: matern_tile_cuda(la, lb, inv_range, amp, nu=nu),
            lambda: ref.matern_tile_ref(la, lb, inv_range, amp, nu),
            u,
            nu,
        )
    emit(rec)
    return rec


def check_matern_corr(torch, tag, u, nu, timed):
    """matern_corr_cuda against matern_corr_ref on a tensor of scaled
    distances.  At the exact path's 16384^2 the plain version of a general
    order takes seconds: it is timed once there."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matern_corr import matern_corr_cuda
    from repro_torch.kernels.matern_tile import instance

    amp = 0.7
    dname = str(u.dtype).split(".")[-1]
    got = matern_corr_cuda(u, amp, nu=nu)
    want = ref.matern_corr_ref(u, amp, nu)
    torch.cuda.synchronize()
    general = instance(nu) == "general"
    if general:
        ops, stats = general_work(torch, u, nu)
    else:
        ops, stats = u.numel() * HALFINT_OPS[nu], None
    nbytes = 2 * u.numel() * u.element_size()
    rec = _matern_record(
        torch, "matern_corr", tag, u.shape, nu, dname, got, want, nbytes, ops
    )
    if stats:
        rec["steps"] = stats
    if tag == "edges":
        rec["zero_at_800"] = float(got[-1]) == 0.0
        rec["ok"] = rec["ok"] and rec["zero_at_800"] and float(got[0]) == amp
    del got, want
    torch.cuda.empty_cache()
    if timed:
        big = u.numel() > 1 << 26 and general
        _matern_times(
            torch,
            rec,
            lambda: matern_corr_cuda(u, amp, nu=nu),
            lambda: ref.matern_corr_ref(u, amp, nu),
            u,
            nu,
            plain_reps=1 if big else 10,
        )
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def check_materns(torch, st, gen, locs):
    """Both Matérn kernels (matern_tile from locations, matern_corr from
    scaled distances) in both instances against their plain versions: at the
    main path's largest GEN panel (the strict-lower panel of column 0,
    (T-1)*nbl rows by nbl = 256 location columns) for every order the paths
    run in both dtypes, on ragged shapes (an unaligned, odd-sized u for
    matern_corr), at the edge values of u for the orders of
    MATERN_EDGE_NUS (f64), and matern_corr at the exact path's n^2 scaled
    distances (nu12 = 1.0 and the two half-integer orders, timed)."""
    records = []
    from repro_torch.core.covariance import pairwise_distances

    la, lb = locs[256:], locs[:256]
    u_panel = pairwise_distances(la, lb) / 0.03
    rag = torch.rand((1000, 2), generator=gen, dtype=torch.float64, device="cuda")
    for dtype in (torch.float64, torch.float32):
        la_t, lb_t = la.to(dtype).contiguous(), lb.to(dtype).contiguous()
        for nu in MATERN_PATH_NUS:
            timed = dtype == torch.float64
            rec = check_matern(torch, "panel", la_t, lb_t, nu, timed)
            records.append(rec)
            if timed and nu == 1.5:
                st.setdefault("summary", {})["matern_tile"] = rec
            elif timed:
                st.setdefault("extra", {}).setdefault("matern_tile", []).append(rec)
            rec = check_matern_corr(torch, "panel", u_panel.to(dtype), nu, timed)
            records.append(rec)
            if timed:
                st.setdefault("extra", {}).setdefault("matern_corr", []).append(rec)
        for nu in (1.5, 1.0):
            rag_t = rag.to(dtype)
            records.append(check_matern(torch, "ragged", rag_t, rag_t[:77], nu, False))
            u_rag = (pairwise_distances(rag_t[:301], rag_t[:77]) / 0.03).view(-1)[1:]
            records.append(check_matern_corr(torch, "ragged", u_rag, nu, False))
    edges = torch.tensor(MATERN_EDGE_US, dtype=torch.float64, device="cuda")
    lb_edges = torch.stack([edges, torch.zeros_like(edges)], dim=1).contiguous()
    la_edges = torch.zeros((3, 2), dtype=torch.float64, device="cuda")
    for nu in MATERN_EDGE_NUS:
        records.append(check_matern(torch, "edges", la_edges, lb_edges, nu, False))
        records.append(check_matern_corr(torch, "edges", edges, nu, False))
    del u_panel
    # the exact path's u: n^2 scaled distances
    u = pairwise_distances(locs) / 0.03
    for nu in (1.0, 0.5, 1.5):
        rec = check_matern_corr(torch, "exact", u, nu, True)
        records.append(rec)
        if nu == 1.0:
            st.setdefault("summary", {})["matern_corr"] = rec
        else:
            st.setdefault("extra", {}).setdefault("matern_corr", []).append(rec)
    del u
    torch.cuda.empty_cache()
    return records


def _tlr_mm_inputs(torch, gen, B, dtype, padded=False, nb=TILE, k=KMAX, acc_dtype=None):
    """Factors and acc for B tile pairs, by default at the main path's SYRK
    shape (nb, kmax) = (512, 128); with ``padded`` the upper half of the rank
    columns is zero; acc in ``acc_dtype`` (default: the factors')."""
    s = (math.sqrt(nb) * k) ** -0.25  # keeps the update of order one
    kw = dict(generator=gen, dtype=dtype, device="cuda")
    ua, va, ub, vb = (s * torch.randn((B, nb, k), **kw) for _ in range(4))
    if padded:
        for t in (ua, va, ub, vb):
            t[:, :, k // 2 :] = 0.0
    kw["dtype"] = dtype if acc_dtype is None else acc_dtype
    return ua, va, ub, vb, torch.randn((B, nb, nb), **kw)


def _tlr_mm_bound(B, nb, k, isz, dname, acc_isz=None):
    acc_isz = isz if acc_isz is None else acc_isz
    nbytes = 4 * B * nb * k * isz + 2 * B * nb * nb * acc_isz
    flops = 2 * B * (2 * nb * k * k + nb * nb * k)
    return bound(nbytes, flops, "matmul", dname)


def _tlr_mm_library(torch, ua, va, ub, vb, acc):
    return torch.baddbmm(acc, torch.bmm(ua, torch.bmm(va.mT, vb)), ub.mT, alpha=-1.0)


def tlr_mm_f32_tol(nb: int, k: int, ysize: float) -> dict:
    """Tolerance of tlr_mm's f32 instance against its plain version (cuBLAS
    in f32, TF32 off).  Both form y = U_a (V_a^T V_b) U_b^T by three f32
    sums, over nb, k and k terms, each in its own order.  A sum of n terms
    carries a rounding error of about u sqrt(n) times the size of what it
    sums (u = 2^-24; the random-walk model of Higham and Mary, 2019), and
    each of the three errors reaches y at about y's own size, so each
    result is off by about u sqrt(nb + 2k) |y| and the two differ by
    sqrt(2) times that.  ``ysize`` is the largest |y| of the inputs, and
    F32_SUM_SIGMAS of those bounds every element; the final acc - y rounds
    once in each (2u relative)."""
    u = 2.0**-24
    atol = F32_SUM_SIGMAS * math.sqrt(2.0) * u * math.sqrt(nb + 2 * k) * ysize
    return dict(rtol=2 * u, atol=atol)


def check_tlr_mm(torch, gen, tag, B, dtype, timed, nb=TILE, k=KMAX):
    """tlr_mm_cuda against tlr_mm_ref.  ``tag`` "padded" zeroes half the
    rank columns (they must add exact zeros); "out_acc" and "ragged_out_acc"
    write the result into acc itself (out=acc), checked against the plain
    version of a copy of acc; "wide" gives f32 factors a float64 acc (the
    mixed SYRK), which must also equal the f32 form into a zero batch, cast
    and added, bit for bit (the mixed SYRK's older two-step form); the timed
    cases also time out=acc beside the new-tensor form, and "wide" that
    two-step form."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tlr_mm import instance, tlr_mm_cuda

    padded = tag == "padded"
    wide = tag == "wide"
    acc_dtype = torch.float64 if wide else dtype
    ua, va, ub, vb, acc = _tlr_mm_inputs(
        torch, gen, B, dtype, padded, nb, k, acc_dtype
    )
    if tag == "padded":
        short = [t[:, :, : k // 2] for t in (ua, va, ub, vb)]
        want = ref.tlr_mm_ref(*short, acc)
    else:
        want = ref.tlr_mm_ref(ua, va, ub, vb, acc)
    scale = float(torch.maximum(acc.abs().max(), want.abs().max()))
    ysize = float((want - acc).abs().max())  # the largest |y|, before out=acc
    in_place = tag.endswith("out_acc")
    if in_place:
        got = tlr_mm_cuda(ua, va, ub, vb, acc, out=acc)
        same = got.data_ptr() == acc.data_ptr()
    else:
        got = tlr_mm_cuda(ua, va, ub, vb, acc)
        same = True
    two_step_equal = None
    if wide:
        neg = torch.zeros(acc.shape, dtype=dtype, device="cuda")
        tlr_mm_cuda(ua, va, ub, vb, neg, out=neg)
        two_step_equal = bool(torch.equal(got, acc + neg.to(acc.dtype)))
        del neg
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    # sums run in another order: atol scales with the largest value
    if dname == "float64":
        tol = dict(rtol=0.0, atol=1e-10 * scale)
    else:
        tol = tlr_mm_f32_tol(nb, k, ysize)
    err, ok = max_err(torch, got, want, **tol)
    b_ms, b_by = _tlr_mm_bound(B, nb, k, ua.element_size(), dname, acc.element_size())
    rec = {
        "phase": "kernel_check",
        "kernel": "tlr_mm",
        "instance": instance(dtype, acc_dtype),
        "case": tag,
        "shape": [B, nb, k],
        "dtype": dname if not wide else "float32, acc float64",
        "max_abs_err": err,
        "ok": ok and same and two_step_equal is not False,
        "tol": tol,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if in_place:
        rec["wrote_into_acc"] = same
    if wide:
        rec["equals_two_step"] = two_step_equal
    del got, want
    if timed:
        acc0 = acc.clone()
        rec["ms"] = cuda_ms(torch, lambda: tlr_mm_cuda(ua, va, ub, vb, acc))
        rec["ms_out_acc"] = cuda_ms(
            torch, lambda: tlr_mm_cuda(ua, va, ub, vb, acc0, out=acc0)
        )
        rec["plain_ms"] = cuda_ms(torch, lambda: ref.tlr_mm_ref(ua, va, ub, vb, acc))
        if wide:
            # no one library call mixes the dtypes: the old path is the yardstick
            def two_step():
                neg = torch.zeros(acc0.shape, dtype=dtype, device="cuda")
                tlr_mm_cuda(ua, va, ub, vb, neg, out=neg)
                acc0.add_(neg.to(acc0.dtype))

            rec["ms_two_step"] = cuda_ms(torch, two_step)
            rec["library_ms"] = None
        else:
            rec["library_ms"] = cuda_ms(
                torch, lambda: _tlr_mm_library(torch, ua, va, ub, vb, acc)
            )
        rec["bound_share"] = b_ms / rec["ms"]
        del acc0
    emit(rec)
    del ua, va, ub, vb, acc
    torch.cuda.empty_cache()
    return rec


def check_tlr_mm_sweep(torch, gen, b_max=SWEEP_B, dtype=None, acc_dtype=None):
    """The SYRK of every panel step of one TLR factorization: B = b_max
    live rows down to 1, (512, 128) factors, in place as the path calls it;
    the kernel's summed time beside the library's.  By default the main
    configuration's f64 sweep (63 to 1); the dist phase's mixed_f32
    evaluation runs the f32 instance from 15 down, with a float64 acc
    (``acc_dtype``; no library call mixes the dtypes, so none is timed)."""
    from repro_torch.kernels.tlr_mm import instance, tlr_mm_cuda

    dtype = torch.float64 if dtype is None else dtype
    acc_dtype = dtype if acc_dtype is None else acc_dtype
    dname = str(dtype).split(".")[-1]
    ua, va, ub, vb, acc = _tlr_mm_inputs(
        torch, gen, b_max, dtype, acc_dtype=acc_dtype
    )
    isz, acc_isz = ua.element_size(), acc.element_size()
    ms = bnd = 0.0
    lib = 0.0 if acc_dtype == dtype else None
    for B in range(ua.shape[0], 0, -1):
        args = [t[:B] for t in (ua, va, ub, vb)]
        a = acc[:B]
        ms += cuda_ms(torch, lambda: tlr_mm_cuda(*args, a, out=a), reps=5)
        if lib is not None:
            lib += cuda_ms(torch, lambda: _tlr_mm_library(torch, *args, a), reps=5)
        bnd += _tlr_mm_bound(B, TILE, KMAX, isz, dname, acc_isz)[0]
    wide = "_wide" if acc_dtype != dtype else ""
    rec = {
        "phase": "kernel_check",
        "kernel": "tlr_mm",
        "instance": instance(dtype, acc_dtype),
        "case": f"sweep_{b_max}_to_1{wide}",
        "shapes": [[ua.shape[0], TILE, KMAX], [1, TILE, KMAX]],
        "dtype": dname if not wide else f"{dname}, acc float64",
        "ms_sum": ms,
        "library_ms_sum": lib,
        "bound_ms_sum": bnd,
        "ok": math.isfinite(ms) and bool(torch.isfinite(acc).all()),
    }
    emit(rec)
    del ua, va, ub, vb, acc
    torch.cuda.empty_cache()
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
    # read L's lower triangle (once if broadcast) and B, write X; nb^2 r
    # flops a tile
    dname = "float64" if isz == 8 else "float32"
    nbytes = (lo_b * nb * (nb + 1) / 2 + 2 * b * nb * r) * isz
    return bound(nbytes, b * nb * nb * r, "matmul", dname)


def check_potrf(torch, gen, tag, b, nb, dtype, timed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chol_tiles import potrf_cuda, potrf_instance

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
        "instance": potrf_instance(dtype),
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
    del a, got, want
    torch.cuda.empty_cache()
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


def check_potrf_failure_first_panel(torch, gen):
    """A (1, 4096, 4096) tile whose pivot 10, in the first panel, is bad:
    it comes back all NaN, and cholesky_ex reports the failure."""
    from repro_torch.kernels.chol_tiles import potrf_cuda

    nb = 4096
    a = _spd(torch, gen, 1, nb, torch.float64)
    a[0, 10, 10] = -5.0
    got = potrf_cuda(a)
    info = torch.linalg.cholesky_ex(a)[1]
    torch.cuda.synchronize()
    all_nan = bool(torch.isnan(got).all())
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "instance": "dmma_f64",
        "case": "bad_pivot_first_panel_4096",
        "shape": [1, nb, nb],
        "dtype": "float64",
        "all_nan": all_nan,
        "cholesky_ex_info": int(info[0]),
        "ok": all_nan and int(info[0]) != 0,
    }
    emit(rec)
    del a, got
    torch.cuda.empty_cache()
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


def check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed, lo=None):
    """trsm_cuda against trsm_ref on the factor of a a^T + nb I, or on
    ``lo`` where given."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chol_tiles import trsm_cuda, trsm_instance, trsm_plan

    dname = str(dtype).split(".")[-1]
    if lo is None:
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
        "instance": trsm_instance(dtype),
        "case": tag,
        "shape": [b, nb, r],
        "lo_batch": lo_b,
        # (strip columns, super-block rows, update tile, row split)
        "plan": trsm_plan(b, nb, r, sm_count(torch)) if dtype == torch.float64 else None,
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
    del lo, rhs, got, want
    torch.cuda.empty_cache()
    return rec


def check_trsm_matern(torch, gen, locs, params):
    """The panel TRSM's shape on a real L_kk: the factor of the main
    configuration's first diagonal tile (the first 256 Morton locations,
    nugget 1e-8), broadcast over 63 tiles of 128 right-hand sides."""
    from repro_torch.core.covariance import build_sigma_panel

    blk = locs[: TILE // 2]
    a = build_sigma_panel(blk, blk, params, gen="kernel")
    a = a + NUGGET * torch.eye(TILE, dtype=a.dtype, device="cuda")
    lo = torch.linalg.cholesky(a)[None]
    rec = check_trsm(torch, gen, "matern_lkk", SWEEP_B, TILE, KMAX, 1,
                     torch.float64, False, lo=lo)
    return rec


def check_trsm_sweep(torch, gen):
    """The panel TRSM of every panel step of one TLR factorization at the
    main configuration: one L_kk broadcast over B = 63 live V tiles of
    (512, 128) down to 1, each held against solve_triangular at CHOL_TOL
    (the plan narrows the strips as B falls, and splits the rows at B <= 4);
    the kernel's summed time beside the library's."""
    from repro_torch.kernels.chol_tiles import trsm_cuda, trsm_plan

    lo = torch.linalg.cholesky(_spd(torch, gen, 1, TILE, torch.float64))
    lo = lo.contiguous()
    rhs = torch.randn((SWEEP_B, TILE, KMAX), generator=gen, dtype=torch.float64,
                      device="cuda")
    tol = CHOL_TOL["trsm"]["float64"]
    ms = lib = bnd = err = 0.0
    ok = True
    plans = set()
    for B in range(SWEEP_B, 0, -1):
        x = rhs[:B]
        got = trsm_cuda(lo, x)
        want = torch.linalg.solve_triangular(lo, x, upper=False)
        e, good = max_err(torch, got, want, **tol)
        err, ok = max(err, e), ok and good
        plans.add(tuple(trsm_plan(B, TILE, KMAX, sm_count(torch))))
        ms += cuda_ms(torch, lambda: trsm_cuda(lo, x), reps=5)
        lib += cuda_ms(
            torch,
            lambda: torch.linalg.solve_triangular(lo, x, upper=False),
            reps=5,
        )
        bnd += _trsm_bound(B, TILE, KMAX, 1, 8)[0]
    rec = {
        "phase": "kernel_check",
        "kernel": "trsm",
        "instance": "dmma_f64",
        "case": "sweep_63_to_1",
        "shapes": [[SWEEP_B, TILE, KMAX], [1, TILE, KMAX]],
        "dtype": "float64",
        "plans": sorted(plans),
        "max_abs_err": err,
        "tol": tol,
        "ms_sum": ms,
        "library_ms_sum": lib,
        "bound_ms_sum": bnd,
        "ok": ok and math.isfinite(ms),
    }
    emit(rec)
    del lo, rhs
    torch.cuda.empty_cache()
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
    from repro_torch.kernels.chol_tiles import syrk_cuda, syrk_instance

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
        "instance": syrk_instance(dtype),
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
        "instance": "dmma_f64",
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


def check_syrk_sweep(torch, gen, panel=TILE):
    """The trailing update of every panel step of the exact path at the main
    configuration (m = 32768, panel 512): nb = 32256 down to 512, C the
    trailing block of a larger matrix and A column-major, as the path
    passes them, each held against baddbmm's result; the kernel's summed
    time beside the library's."""
    from repro_torch.kernels.chol_tiles import syrk_cuda

    m = (SWEEP_B + 1) * TILE  # 32768
    kw = dict(generator=gen, dtype=torch.float64, device="cuda")
    big = torch.randn((1, m, m), **kw)
    pan = torch.randn((1, panel, m), **kw)
    ms = lib = bnd = err = 0.0
    ok = True
    for nb in range(m - panel, 0, -panel):
        c = big[:, m - nb :, m - nb :]
        a = pan[:, :, :nb].mT
        got = syrk_cuda(c, a)
        want = torch.baddbmm(c, a, a.mT, alpha=-1.0)
        for r0 in range(0, nb, 4096):  # 1 GB temporaries at a time
            rows = slice(r0, r0 + 4096)
            e, good = max_err(torch, got[:, rows], want[:, rows], **TOL["float64"])
            err, ok = max(err, e), ok and good
        del got, want
        ms += cuda_ms(torch, lambda: syrk_cuda(c, a), reps=3, warmup=1)
        lib += cuda_ms(
            torch, lambda: torch.baddbmm(c, a, a.mT, alpha=-1.0), reps=3, warmup=1
        )
        bnd += _syrk_bound(1, nb, panel, 8)[0]
    rec = {
        "phase": "kernel_check",
        "kernel": "syrk",
        "instance": "dmma_f64",
        "case": "sweep_exact_panel512",
        "shapes": [[1, m - panel, panel], [1, panel, panel]],
        "dtype": "float64",
        "max_abs_err": err,
        "tol": TOL["float64"],
        "ms_sum": ms,
        "library_ms_sum": lib,
        "bound_ms_sum": bnd,
        "ok": ok and math.isfinite(ms),
    }
    emit(rec)
    del big, pan
    torch.cuda.empty_cache()
    return rec


def attention_pairs(sq: int, skv: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention with queries
    right-aligned to the keys and an optional window."""
    qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros_like(qpos)
    return int((qpos - lo + 1).sum())


def check_flash_attention(torch, gen, tag, bh, bkv, sq, skv, d, dtype, window, timed):
    """flash_attention_cuda against attention_ref (causal), and SDPA on the
    same tensors as the library yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, instance

    dname = str(dtype).split(".")[-1]
    kw = dict(generator=gen, device="cuda")
    q = torch.randn((bh, sq, d), **kw).to(dtype)
    k = torch.randn((bkv, skv, d), **kw).to(dtype)
    v = torch.randn((bkv, skv, d), **kw).to(dtype)
    got = flash_attention_cuda(q, k, v, window=window)
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    err, ok = max_err(torch, got.float(), want.float(), **ATTN_TOL[dname])
    isz = q.element_size()
    nbytes = (2 * bh * sq * d + 2 * bkv * skv * d) * isz
    flops = 4 * d * attention_pairs(sq, skv, window) * bh
    b_ms, b_by = bound(nbytes, flops, "matmul", dname)
    rec = {
        "phase": "kernel_check",
        "kernel": "flash_attention",
        "instance": instance(dtype),
        "case": tag,
        "shape": [bh, bkv, sq, skv, d],
        "window": window,
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": ATTN_TOL[dname],
        "flops": flops,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    if dname == "bfloat16":
        # against the f32 result before its rounding to bf16: the kernel's
        # error beside the error of that rounding alone
        exact = ref.attention_ref(q.float(), k.float(), v.float(), window=window)
        rec["max_abs_err_vs_f32"] = float((got.float() - exact).abs().max())
        rec["bf16_rounding_err"] = float((want.float() - exact).abs().max())
        del exact
    del got, want
    if timed:
        import torch.nn.functional as F

        # SDPA on (1, H, S, D) views: query head b reads KV head b // group,
        # as the kernel; top-left causality equals right-alignment only for
        # square shapes, so the others take an explicit mask
        q4, k4, v4 = q[None], k[None], v[None]
        sdpa = dict(enable_gqa=True)
        if sq == skv and window == 0:
            sdpa["is_causal"] = True
        else:
            qpos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
            kpos = torch.arange(skv, device="cuda")[None, :]
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            sdpa["attn_mask"] = mask
        rec["ms"] = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, window=window))
        rec["plain_ms"] = cuda_ms(
            torch, lambda: ref.attention_ref(q, k, v, window=window)
        )
        rec["library_ms"] = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4, **sdpa)
        )
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["bound_share"] = b_ms / rec["ms"]
    emit(rec)
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def phase_kernels(torch, st, n_side: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = []
    # matern_tile and matern_corr, both instances (check_materns)
    locs, params, _ = main_config(torch, n_side, torch.device("cuda"))
    locs = torch.as_tensor(locs, device="cuda")
    records.extend(check_materns(torch, st, gen, locs))
    # tlr_mm: the largest SYRK of the main path (panel step 0: the 63 live
    # rows' (512, 128) factors onto their diagonal tiles) in both instances,
    # with padded rank columns, written into acc, and at B = 8 and 1 (the
    # f32 instance timed at B = 63 and 1); then the summed sweep of one
    # factorization
    f64, f32 = torch.float64, torch.float32
    cases = (
        ("full", 63, f64, True),
        ("full", 63, f32, True),
        ("padded", 63, f64, False),
        ("padded", 63, f32, False),
        ("out_acc", 63, f64, False),
        ("b8", 8, f64, True),
        ("b1", 1, f64, True),
        ("b1", 1, f32, True),
    )
    for tag, B, dtype, timed in cases:
        rec = check_tlr_mm(torch, gen, tag, B, dtype, timed)
        records.append(rec)
        if tag == "full" and dtype == f64:
            st.setdefault("summary", {})["tlr_mm"] = rec
        elif timed:
            st.setdefault("extra", {}).setdefault("tlr_mm", []).append(rec)
    # odd nb and k (the 8-byte copy paths) and k > 128 (a second rank pass,
    # which reads out back), in place, in both instances
    for dtype in (f64, f32):
        records.append(
            check_tlr_mm(torch, gen, "ragged_out_acc", 3, dtype, False, nb=301, k=131)
        )
    rec = check_tlr_mm_sweep(torch, gen)
    records.append(rec)
    st.setdefault("extra", {}).setdefault("tlr_mm", []).append(rec)
    # the dist phase's SYRKs: its first panel step (B = 15) in the f32
    # instance beside the f64 one its f64 forms run, and with the float64
    # acc that its mixed_f32 evaluation gives it (the widening epilogue);
    # the sweep of one mixed factorization, all f32 and as the path runs it
    for tag, dtype in (("dist_first", f32), ("dist_first", f64), ("wide", f32)):
        rec = check_tlr_mm(torch, gen, tag, DIST_SWEEP_B, dtype, True)
        records.append(rec)
        st.setdefault("extra", {}).setdefault("tlr_mm", []).append(rec)
    for acc_dtype in (f32, f64):
        rec = check_tlr_mm_sweep(torch, gen, DIST_SWEEP_B, f32, acc_dtype)
        records.append(rec)
        st.setdefault("extra", {}).setdefault("tlr_mm", []).append(rec)
    # potrf: the panel-head tile of the main path (timed in both instances,
    # though the f32 one runs on no path), a batch, a ragged nb,
    # nb = 1, the README's serving tile (2048) and the reference's default
    # exact panel (4096), bad tiles and a real Matérn tile.  The two
    # multiwave batches give the f64 panel launch more blocks than the card
    # holds at once (about two a SM): 40 x 7 and 8 x 63 at the first panel.
    cases = (
        ("path", 1, 512, (torch.float64, torch.float32)),
        ("batch", 8, 512, (torch.float64, torch.float32)),
        ("multiwave", 40, 512, (torch.float64,)),
        ("multiwave4096", 8, 4096, (torch.float64,)),
        ("ragged", 3, 200, (torch.float64, torch.float32)),
        ("nb1", 1, 1, (torch.float64, torch.float32)),
        ("tile2048", 1, 2048, (torch.float64, torch.float32)),
        ("tile4096", 1, 4096, (torch.float64,)),
    )
    for tag, b, nb, dtypes in cases:
        for dtype in dtypes:
            # the f32 instance, on no path, is timed at the path's shape
            timed = tag == "path" or (tag in ("tile2048", "tile4096") and dtype == f64)
            rec = check_potrf(torch, gen, tag, b, nb, dtype, timed)
            records.append(rec)
            if tag == "path" and dtype == f64:
                st.setdefault("summary", {})["potrf"] = rec
            elif timed:
                st.setdefault("extra", {}).setdefault("potrf", []).append(rec)
    records.append(check_potrf_failure(torch, gen))
    records.append(check_potrf_failure_first_panel(torch, gen))
    records.append(check_potrf_matern(torch, locs, params))
    # trsm in both instances: the panel TRSM (one L_kk for the 63 live V
    # tiles of step 0: r = 63 x 128 = 8064 columns in all; timed in both,
    # though the f32 one runs on no path), the same columns
    # as one tile (wide), the sweep for alpha (r = 1), the sweep of a
    # 512-location request (r = 512 x 2), a ragged case with a factor per
    # tile, nb = 1, the README's serving tile, the reference's exact panel
    # 4096 (eight super-blocks and updates: the f64 instance's large-nb
    # schedule) and its alpha; in f64 only, the exact path's first and last
    # panel solves at panel 4096 (updates of 128 x 128 tiles); then the
    # panel shape on a real Matérn L_kk and the summed sweep of one TLR
    # factorization's panel TRSMs
    cases = (
        ("panel", 63, 512, 128, 1),
        ("wide", 1, 512, 8064, 1),
        ("alpha", 1, 512, 1, 1),
        ("predict", 1, 512, 1024, 1),
        ("ragged", 3, 200, 37, 3),
        ("nb1", 2, 1, 3, 2),
        ("tile2048", 4, 2048, 128, 1),
        ("panel4096", 1, 4096, 512, 1),
        ("alpha4096", 1, 4096, 1, 1),
    )
    timed_trsm = ("panel", "wide", "alpha", "predict", "panel4096", "alpha4096")
    for tag, b, nb, r, lo_b in cases:
        for dtype in (f64, f32):
            timed = tag == "panel" or (tag in timed_trsm and dtype == f64)
            rec = check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed)
            records.append(rec)
            if tag == "panel" and dtype == f64:
                st.setdefault("summary", {})["trsm"] = rec
            elif timed:
                st.setdefault("extra", {}).setdefault("trsm", []).append(rec)
    m = (SWEEP_B + 1) * TILE
    for tag, r in (("exact4096_first", m - EXACT_PANEL), ("exact4096_last", EXACT_PANEL)):
        rec = check_trsm(torch, gen, tag, 1, EXACT_PANEL, r, 1, torch.float64, True)
        records.append(rec)
        st.setdefault("extra", {}).setdefault("trsm", []).append(rec)
    records.append(check_trsm_matern(torch, gen, locs, params))
    rec = check_trsm_sweep(torch, gen)
    records.append(rec)
    st.setdefault("extra", {}).setdefault("trsm", []).append(rec)
    # syrk: the first trailing update of the exact phase (m_k = 32256,
    # panel 512) in the operands' path layout (timed in both instances,
    # though the f32 one runs on no path), a batch in both dtypes, the
    # JAX test shapes, a ragged nb (row-major A; and odd nb and k in the
    # path layout, whose copies are 8 bytes), the path's last step (the f64
    # instance's 64 x 64 tiles), k = 1, and offsets past 2^31
    cases = (
        ("path", 1, 32256, 512, True, (torch.float64, torch.float32)),
        ("batch", 4, 512, 128, False, (torch.float64, torch.float32)),
        ("jax_2x64x64", 2, 64, 64, False, (torch.float64, torch.float32)),
        ("jax_4x32x16", 4, 32, 16, False, (torch.float64, torch.float32)),
        ("ragged", 2, 1000, 200, False, (torch.float64, torch.float32)),
        ("ragged_path", 2, 1001, 203, True, (torch.float64, torch.float32)),
        ("last_step", 1, 512, 512, True, (torch.float64,)),
        ("k1", 2, 300, 1, False, (torch.float64,)),
    )
    for tag, b, nb, k, path_layout, dtypes in cases:
        for dtype in dtypes:
            timed = tag == "path" or (tag == "batch" and dtype == f64)
            rec = check_syrk(torch, gen, tag, b, nb, k, dtype, timed, path_layout)
            records.append(rec)
            if tag == "path" and dtype == f64:
                st.setdefault("summary", {})["syrk"] = rec
            elif timed:
                st.setdefault("extra", {}).setdefault("syrk", []).append(rec)
    records.append(check_syrk_64bit(torch, gen))
    # the exact path's panel-4096 shapes (first step) and the summed sweep
    # of the panel-512 path's 63 updates
    rec = check_syrk(torch, gen, "path4096", 1, 28672, 4096, torch.float64, True, True)
    records.append(rec)
    st.setdefault("extra", {}).setdefault("syrk", []).append(rec)
    rec = check_syrk_sweep(torch, gen)
    records.append(rec)
    st.setdefault("extra", {}).setdefault("syrk", []).append(rec)
    # flash_attention, both instances: qwen3-4b prefill at B = 2, S = 4096
    # (the path's shape, timed), the f32 shape of the lm phase's depth-4
    # check (timed), a window, right-aligned decode and a short query block
    # against a long cache, a ragged length at phi3's head dim, the other
    # head-dim instances, and a length that is not a multiple of 128
    if not st.get("flash_ok"):
        raise AssertionError("the bf16 flash instance failed the device phase")
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (
        ("path", 64, 16, 4096, 4096, 128, bf16, 0),
        ("depth4_f32", 32, 8, 4096, 4096, 128, f32, 0),
        ("window1024", 64, 16, 4096, 4096, 128, bf16, 1024),
        ("decode", 64, 16, 1, 4096, 128, f32, 0),
        ("decode", 64, 16, 1, 4096, 128, bf16, 0),
        ("q128_kv4096", 64, 16, 128, 4096, 128, f32, 0),
        ("q128_kv4096", 64, 16, 128, 4096, 128, bf16, 0),
        ("ragged_d96_mha", 32, 32, 1000, 1000, 96, f32, 0),
        ("ragged_d96_mha", 32, 32, 1000, 1000, 96, bf16, 0),
        ("d64_gqa", 8, 2, 300, 300, 64, f32, 0),
        ("d64_gqa", 8, 2, 300, 300, 64, bf16, 0),
        ("d32_window", 8, 8, 200, 333, 32, f32, 50),
        ("d32_window", 8, 8, 200, 333, 32, bf16, 50),
        ("s4000", 64, 16, 4000, 4000, 128, bf16, 0),
    )
    for tag, bh, bkv, sq, skv, d, dtype, window in cases:
        timed = tag in ("path", "depth4_f32")
        rec = check_flash_attention(
            torch, gen, tag, bh, bkv, sq, skv, d, dtype, window, timed
        )
        records.append(rec)
        if tag == "path":
            st.setdefault("summary", {})["flash_attention"] = rec
        elif timed:
            st["flash_f32"] = rec
    if not all(rec["ok"] for rec in records):
        raise AssertionError("a kernel disagrees with its plain version")


def serve_requests():
    """The serve phase's 8 requests of 512 uniform locations, and one more
    for the conditional draws."""
    rng = np.random.default_rng(7)
    return [rng.uniform(0.05, 0.95, size=(512, 2)) for _ in range(9)]


def main_config(torch, n_side: int, dev):
    """The main configuration (PERF.md section 4): n_side^2 Morton-ordered
    locations of the jittered grid, the bivariate Matérn parameters, and
    the generator (seed 0) that simulates z with ``simulate_mgrf``."""
    from repro_torch.core.covariance import MaternParams, morton_order
    from repro_torch.core.simulate import grid_locations

    locs = grid_locations(n_side, jitter=0.3, seed=0)
    locs = locs[morton_order(locs)]
    params = MaternParams.bivariate(**MATERN, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return locs, params, gen


def phase_main(torch, st, n_side: int):
    from repro_torch.core import tlr as tlr_module
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.prediction import cokrige, dense_factor
    from repro_torch.core.simulate import simulate_mgrf
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    nugget, tol, tile, kmax = NUGGET, TOL_TLR, TILE, KMAX
    locs, params, gen = main_config(torch, n_side, dev)
    torch.cuda.reset_peak_memory_stats()
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
    instances = path_instances(ops, st, "main")
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
    ok = ok and f64_only(instances)
    ok = ok and gen_on_kernels(st, instances, "main", "matern_tile")
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
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("main", 0),
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
    instances = path_instances(ops, st, "serve")

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
    ok = ok and f64_only(instances)
    ok = ok and gen_on_kernels(st, instances, "serve", "matern_tile")
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
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("serve", 0),
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
    m = z.shape[-1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dists = pairwise_distances(torch.as_tensor(locs, device=dev))
    torch.cuda.synchronize()
    dists_s = time.perf_counter() - t0
    failed = []
    # panel 512, the comparable number, then the reference's default 4096,
    # on the same distances
    for path, panel in (("exact", TILE), ("exact4096", min(EXACT_PANEL, m))):
        nk = m // panel
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times = {}
        t0 = time.perf_counter()
        res = dist_exact_loglik(
            dists, z, params, nugget=NUGGET, panel=panel, times=times
        )
        ll = float(res.loglik)
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        st.setdefault("launches", {})[path] = launches
        instances = path_instances(ops, st, path)
        peak = torch.cuda.max_memory_allocated()
        rel = abs(ll - ref["loglik"]) / abs(ref["loglik"])
        logdet_gap = abs(float(res.logdet) - ref["logdet"]) / abs(ref["logdet"])
        quad_gap = abs(float(res.quad) - ref["quad"]) / abs(ref["quad"])
        want = {"syrk": nk - 1, "potrf": nk, "trsm": 2 * nk - 1}
        ok = math.isfinite(ll) and rel <= 1e-7
        ok = ok and all(launches[name] == count for name, count in want.items())
        ok = ok and f64_only(instances)
        ok = ok and gen_on_kernels(st, instances, "exact", "matern_corr")
        del res
        emit(
            {
                "phase": "exact",
                "path": path,
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
                "launches_by_instance": instances,
                "launches_expected": want,
                "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("exact", 0),
                "peak_bytes": peak,
            }
        )
        if not ok:
            failed.append(panel)
    del dists
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"exact panel path failed its checks at panel {failed}")


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
    instances = path_instances(ops, st, "mle")
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
    ok = ok and all(launches[name] > 0 for name in TLR_KERNELS)
    ok = ok and f64_only(instances)
    ok = ok and gen_on_kernels(st, instances, "mle", "matern_tile")
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
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("mle", 0),
            "peak_bytes": peak,
        }
    )
    if not ok:
        raise AssertionError("mle path failed its checks")


def assess_oracle(torch, locs, pred, theta, theta_a, nugget):
    """The paper's own per-location loop (Level 2): E_t, E_t,a and E_a at
    each of ``pred``'s locations, one location at a time, with
    ``solve_triangular`` against ``torch.linalg.cholesky`` factors of
    freshly built Sigmas.  Returns three (len(pred),) tensors."""
    from repro_torch.core.covariance import build_c0, build_sigma, cross_cov_at_zero

    dev = torch.device("cuda")
    sigma_a = build_sigma(locs, theta_a, nugget=nugget, device=dev)
    chol_a = torch.linalg.cholesky(sigma_a)
    del sigma_a
    sigma_t = build_sigma(locs, theta, nugget=nugget, device=dev)
    chol_t = torch.linalg.cholesky(sigma_t)
    c0t = build_c0(pred, locs, theta, device=dev)
    c0a = build_c0(pred, locs, theta_a, device=dev)
    c00_t = torch.trace(cross_cov_at_zero(theta))
    c00_a = torch.trace(cross_cov_at_zero(theta_a))

    def solve(chol, b):
        y = torch.linalg.solve_triangular(chol, b, upper=False)
        return torch.linalg.solve_triangular(chol.mT, y, upper=True)

    e_t, e_ta, e_a = [], [], []
    for loc in range(len(pred)):
        ct, ca = c0t[loc], c0a[loc]  # (pn, p)
        xt = solve(chol_t, ct)
        xa = solve(chol_a, ca)
        e_t.append(c00_t - torch.sum(ct * xt))
        e_ta.append(c00_t - 2.0 * torch.sum(ct * xa) + torch.sum(xa * (sigma_t @ xa)))
        e_a.append(c00_a - torch.sum(ca * xa))
    del sigma_t, chol_t, chol_a
    torch.cuda.empty_cache()
    return torch.stack(e_t), torch.stack(e_ta), torch.stack(e_a)


def phase_assess(torch, st, n_side: int):
    """The paper's Algorithm 1 (MLOE/MMOM) at the main cell's full size."""
    from repro_torch.core.assessment import mloe_mmom, naive_multivariate_mloe_mmom
    from repro_torch.core.simulate import uniform_locations
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    locs, theta, _ = main_config(torch, n_side, dev)
    theta_a = theta._replace(a=theta.a * ASSESS_A_FACTOR)
    pred = uniform_locations(ASSESS_NPRED, seed=ASSESS_SEED)
    kw = dict(nugget=NUGGET, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the criteria at the truth: E_t,a = E_t = E_a
    t0 = time.perf_counter()
    times_truth = {}
    at_truth = mloe_mmom(locs, pred, theta, theta, times=times_truth, **kw)
    zero = (float(at_truth.mloe), float(at_truth.mmom))
    truth_s = time.perf_counter() - t0
    del at_truth

    # the path: theta against the misspecified theta_a
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = {}
    t0 = time.perf_counter()
    res = mloe_mmom(locs, pred, theta, theta_a, times=times, **kw)
    mloe, mmom = float(res.mloe), float(res.mmom)
    total_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st.setdefault("launches", {})["assess"] = launches
    instances = path_instances(ops, st, "assess")
    peak = torch.cuda.max_memory_allocated()
    e_t_pos = bool((res.e_t > 0).all())
    e_ta_ge = bool((res.e_ta >= res.e_t - ASSESS_ROUND).all())
    head = [x[:ASSESS_ORACLE].clone() for x in (res.e_t, res.e_ta, res.e_a)]
    del res
    torch.cuda.empty_cache()

    # the per-location oracle for the first locations
    t0 = time.perf_counter()
    oracle = assess_oracle(torch, locs, pred[:ASSESS_ORACLE], theta, theta_a, NUGGET)
    oracle_s = time.perf_counter() - t0
    oracle_gap = {
        name: float(((got - want).abs() / want.abs()).max())
        for name, got, want in zip(("e_t", "e_ta", "e_a"), head, oracle)
    }

    # the naive per-variable extension (paper section 5.4)
    t0 = time.perf_counter()
    naive_loe, naive_mom = naive_multivariate_mloe_mmom(
        locs, pred, theta, theta_a, nugget=NUGGET, device=dev
    )
    naive_loe, naive_mom = float(naive_loe), float(naive_mom)
    naive_s = time.perf_counter() - t0

    ok = max(abs(v) for v in zero) <= ASSESS_ZERO
    ok = ok and mloe >= -ASSESS_ROUND and e_t_pos and e_ta_ge
    ok = ok and max(oracle_gap.values()) <= ASSESS_ORACLE_TOL
    ok = ok and abs(mloe - naive_loe) > ASSESS_NAIVE_GAP
    ok = ok and math.isfinite(mloe) and math.isfinite(mmom)
    ok = ok and launches["matern_corr"] > 0
    ok = ok and gen_on_kernels(st, instances, "assess", "matern_corr")
    emit(
        {
            "phase": "assess",
            "ok": ok,
            "n": len(locs),
            "m": 2 * len(locs),
            "npred": ASSESS_NPRED,
            "nugget": NUGGET,
            "theta_a_range_factor": ASSESS_A_FACTOR,
            "phase_s": times,
            "mloe_mmom_s": total_s,
            "at_truth": {"mloe": zero[0], "mmom": zero[1], "s": truth_s,
                         "phase_s": times_truth},
            "mloe": mloe,
            "mmom": mmom,
            "e_t_positive": e_t_pos,
            "e_ta_ge_e_t": e_ta_ge,
            "oracle_locations": ASSESS_ORACLE,
            "oracle_rel_gap": oracle_gap,
            "oracle_s": oracle_s,
            "naive_mloe": naive_loe,
            "naive_mmom": naive_mom,
            "naive_s": naive_s,
            "ck_minus_naive_mloe": mloe - naive_loe,
            "launches": launches,
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("assess", 0),
            "peak_bytes": peak,
        }
    )
    if not ok:
        raise AssertionError("assess path failed its checks")


def capture_factorizations(kept: list):
    """Record the storage dtypes and the factor's rank total of every TLR
    factorization (``core.tlr.factorize``, which every form of the TLR
    likelihood runs) into ``kept``; returns a function that restores it."""
    from repro_torch.core import dist_tlr, tlr

    plain = tlr.factorize

    def factorize(loop, diag, u, v, ranks, **kw):
        out = plain(loop, diag, u, v, ranks, **kw)
        kept.append(
            {
                "diag_dtype": str(diag.dtype).split(".")[-1],
                "uv_dtype": str(u.dtype).split(".")[-1],
                "factor_rank_total": int(out[3].sum()),
            }
        )
        return out

    tlr.factorize = dist_tlr.factorize = factorize

    def restore():
        tlr.factorize = dist_tlr.factorize = plain

    return restore


def phase_dist(torch, st, n_side: int):
    """The single-device forms of the distributed TLR likelihood and the
    mixed_f32 policy, at the main cell's widths with n cut for time."""
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.simulate import grid_locations, simulate_mgrf
    from repro_torch.core.tlr import tlr_loglik
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    side = min(DIST_N_SIDE, n_side)
    locs, params, gen = main_config(torch, side, dev)
    z = simulate_mgrf(gen, locs, params, nugget=NUGGET, device=dev)[0]
    ll_exact = float(exact_loglik(locs, z, params, nugget=NUGGET, device=dev).loglik)
    common = dict(tol=TOL_TLR, max_rank=KMAX, tile_size=TILE, nugget=NUGGET,
                  gen="kernel", device=dev)
    runs = (
        ("tlr_loglik", tlr_loglik, {}),
        ("dist_masked", dist_tlr_loglik, {}),
        ("dist_super", dist_tlr_loglik,
         dict(super_panels=DIST_SUPER, col_block=DIST_COL_BLOCK)),
        ("dist_block_cyclic", dist_tlr_loglik, dict(block_cyclic=True)),
        ("tlr_mixed_f32", tlr_loglik, dict(dtype_policy="mixed_f32")),
    )
    records, total, by_inst = {}, {}, {}
    for name, fn, kw in runs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kept = []
        restore = capture_factorizations(kept)
        ops.reset_launch_counts()
        times = {}
        t0 = time.perf_counter()
        try:
            if fn is tlr_loglik:
                res = fn(None, z, params, locs=locs, from_tiles=True, times=times,
                         **common, **kw)
            else:
                res = fn(None, z, locs=locs, params=params, from_tiles=True,
                         times=times, **common, **kw)
            ll = float(res.loglik)
        finally:
            restore()
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        instances = ops.instance_counts()
        for kname, count in launches.items():
            total[kname] = total.get(kname, 0) + count
        for kname, counts in instances.items():
            mine = by_inst.setdefault(kname, {})
            for inst, count in counts.items():
                mine[inst] = mine.get(inst, 0) + count
        records[name] = {
            "loglik": ll,
            "logdet_dtype": str(res.logdet.dtype).split(".")[-1],
            "status": res.status.as_dict(),
            "s": total_s,
            "phase_s": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches,
            "launches_by_instance": instances,
            **(kept[0] if len(kept) == 1 else {"factorizations": kept}),
        }
        del res
    st.setdefault("launches", {})["dist"] = total
    st.setdefault("instances", {})["dist"] = by_inst

    ref = records["tlr_loglik"]
    masked = records["dist_masked"]
    steps = -(-2 * len(locs) // TILE) - 1  # panel steps with live rows
    failed = []
    for name, rec in records.items():
        inst = rec["launches_by_instance"]
        gap_to = masked if name == "tlr_mixed_f32" else ref
        rec["rel_gap"] = abs(rec["loglik"] - gap_to["loglik"]) / abs(gap_to["loglik"])
        rec["rel_gap_to"] = "dist_masked" if name == "tlr_mixed_f32" else "tlr_loglik"
        good = rec["status"]["ok"] and math.isfinite(rec["loglik"])
        good = good and all(rec["launches"][k] > 0 for k in TLR_KERNELS)
        good = good and rec["logdet_dtype"] == rec.get("diag_dtype") == "float64"
        good = good and all(inst[k]["fma_f32"] == 0 for k in ("potrf", "trsm", "syrk"))
        good = good and gen_on_kernels(st, inst, "dist", "matern_tile")
        if name == "tlr_mixed_f32":
            good = good and rec["rel_gap"] <= DIST_MIXED_GAP
            good = good and rec.get("uv_dtype") == "float32"
            # one SYRK a panel step with live rows, each the widening form
            good = good and inst["tlr_mm"]["fma_f32"] == steps
            good = good and inst["tlr_mm"]["dmma_f64"] == 0
        else:
            good = good and rec["rel_gap"] <= DIST_F64_GAP
            good = good and rec.get("uv_dtype") == "float64"
            good = good and inst["tlr_mm"]["fma_f32"] == 0
            good = good and rec.get("factor_rank_total") == ref.get("factor_rank_total")
        rec["ok"] = good
        if not good:
            failed.append(name)
    emit(
        {
            "phase": "dist",
            "ok": not failed,
            "n": len(locs),
            "m": 2 * len(locs),
            "tile_size": TILE,
            "max_rank": KMAX,
            "tol": TOL_TLR,
            "nugget": NUGGET,
            "reduced": {
                "n": {"main_cell": n_side * n_side, "here": len(locs)},
                "why": "each form repeats the main phase's cuSOLVER work",
            },
            "loglik_exact": ll_exact,
            "tlr_rel_gap_to_exact": abs(ref["loglik"] - ll_exact) / abs(ll_exact),
            "evaluations": records,
            "launches": total,
            "launches_by_instance": by_inst,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("dist", 0),
        }
    )
    if failed:
        raise AssertionError(f"dist forms failed their checks: {failed}")


def record_plans(st) -> None:
    """Keep every plan the f64 trsm and syrk pick (trsm's strip columns,
    update tile and row split; syrk's tile edge) under the phase that ran
    it, ``st["phase"]``: the wrappers look the plan functions up in their
    module at each call, so these stand in for them."""
    from repro_torch.kernels import chol_tiles

    plans = st.setdefault("plans", {})

    def recorded(name, fn, key):
        def plan(*args):
            out = fn(*args)
            plans.setdefault(st["phase"], set()).add((name, *key(out)))
            return out

        return plan

    chol_tiles.trsm_plan = recorded(
        "trsm", chol_tiles.trsm_plan, lambda p: (p[0], p[2], p[3])
    )
    chol_tiles.syrk_tile = recorded("syrk", chol_tiles.syrk_tile, lambda t: (t,))


def count_plain_kv(st) -> None:
    """Count the calls of the plain K_nu (``core.matern.kv``) on CUDA
    tensors, under the phase that made them, ``st["phase"]``:
    ``matern_correlation`` looks ``kv`` up in its module at each call, so
    this stands in for it.  The geostat paths must make none: every order
    of their GEN runs in matern_tile or matern_corr."""
    from repro_torch.core import matern

    calls = st.setdefault("kv_cuda", {})
    plain = matern.kv

    def kv(nu, x):
        if x.device.type == "cuda":
            calls[st["phase"]] = calls.get(st["phase"], 0) + 1
        return plain(nu, x)

    matern.kv = kv


def gen_on_kernels(st, instances: dict, path: str, kernel: str) -> bool:
    """The path made no plain K_nu call on the card and ran the general
    instance of ``kernel`` (its cross pair, nu12 = 1.0, or every pair with
    nu free)."""
    return st.get("kv_cuda", {}).get(path, 0) == 0 and (
        instances[kernel]["general"] > 0
    )


def phase_plans(st):
    """Every plan of the f64 trsm and syrk that a path ran is one that the
    kernels phase held against the plain version: each (strip width, update
    tile, row split) and each tile edge is a kernel of its own."""
    plans = st.get("plans", {})
    checked = plans.get("kernels", set())
    paths = ("main", "serve", "exact", "mle", "assess", "dist")
    by_path = {p: plans.get(p, set()) for p in paths}
    missing = sorted(set().union(*by_path.values()) - checked)
    ok = bool(checked) and not missing
    emit(
        {
            "phase": "plans",
            "ok": ok,
            "checked": sorted(checked),
            "by_path": {p: sorted(v) for p, v in by_path.items()},
            "missing": missing,
        }
    )
    if not ok:
        raise AssertionError(f"plans the paths ran but no check held: {missing}")


def path_instances(ops, st, path: str) -> dict:
    """The launches of each kernel instance during a path, kept for the
    summary line."""
    counts = ops.instance_counts()
    st.setdefault("instances", {})[path] = counts
    return counts


def f64_only(instances: dict) -> bool:
    """The geostat paths run in f64: potrf, tlr_mm, trsm and syrk launch
    only their dmma_f64 instance there."""
    names = ("potrf", "tlr_mm", "trsm", "syrk")
    return all(instances[name]["fma_f32"] == 0 for name in names)


def rel_gap(torch, got, want) -> float:
    """max |got - want| over max |want|, in f32, a batch row at a time."""
    diff = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    return diff / max(float(w.float().abs().max()) for w in want)


def phase_lm(torch, st):
    """qwen3-4b serving at full width: the prefill forward through the flash
    kernel against the naive path, and the engine's cached greedy decode."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import forward, init_model
    from repro_torch.serving.engine import generate, make_serve_fns

    if not st.get("flash_ok"):
        raise AssertionError("the bf16 flash instance failed the device phase")
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(LM_ARCH)
    rng = np.random.default_rng(4)

    def generator(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return gen

    def tokens(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, size=shape), device=dev)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop)

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        counts["flash_by_instance"] = dict(flash_attention_cuda.launches_by_instance)
        return out, counts

    rec = {"phase": "lm", "arch": LM_ARCH, "dtype": cfg.dtype}
    with torch.inference_mode():
        # depth 4 at full width in f32: the kernel against the naive path
        # without bf16 rounding in between
        cfg4 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
        model4 = init_model(cfg4, generator=generator(5), device=dev)
        t4 = tokens((1, LM_PREFILL[1]))
        lk, c4 = counted(lambda: forward(model4, cfg4, t4, attn_impl="kernel").logits)
        ln = forward(model4, cfg4, t4, attn_impl="naive").logits
        rec["depth4_f32_rel_gap"] = rel_gap(torch, lk, ln)
        rec["depth4_f32_launches"] = c4["flash_attention"]
        rec["depth4_f32_launches_by_instance"] = c4["flash_by_instance"]
        del model4, lk, ln
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        model = init_model(cfg, generator=generator(0), device=dev)
        torch.cuda.synchronize()
        rec["init_model_s"] = time.perf_counter() - t0
        rec["n_params"] = sum(p.numel() for p in model.parameters())
        rec["param_bytes"] = sum(
            p.numel() * p.element_size() for p in model.parameters()
        )

        # prefill forward, full depth: warm-up, timed, then the naive path
        toks = tokens(LM_PREFILL)

        def prefill_fwd(impl):
            return lambda: forward(model, cfg, toks, attn_impl=impl).logits

        _, c_warm = counted(prefill_fwd("kernel"))
        (lk, ms), c_timed = counted(lambda: timed(prefill_fwd("kernel")))
        (ln, naive_ms), c_naive = counted(lambda: timed(prefill_fwd("naive")))
        rec["prefill_timed_launches_by_instance"] = c_timed.pop("flash_by_instance")
        st.setdefault("launches", {})["lm"] = c_timed
        st.setdefault("instances", {})["lm"] = {
            "flash_attention": dict(rec["prefill_timed_launches_by_instance"])
        }
        n_tok = LM_PREFILL[0] * LM_PREFILL[1]
        rec.update(
            prefill_shape=list(LM_PREFILL),
            prefill_forward_ms=ms,
            prefill_tokens_per_sec=n_tok / (ms / 1e3),
            prefill_naive_ms=naive_ms,
            prefill_rel_gap=rel_gap(torch, lk, ln),
            prefill_finite=bool(torch.isfinite(lk).all()),
            prefill_argmax_agreement=float(
                (lk.argmax(-1) == ln.argmax(-1)).float().mean()
            ),
            prefill_launches={
                "warmup": c_warm["flash_attention"],
                "timed": c_timed["flash_attention"],
                "naive": c_naive["flash_attention"],
            },
        )
        del lk, ln
        torch.cuda.empty_cache()

        # the engine: cached prefill, then greedy decode
        prompts = tokens(LM_PROMPTS)
        gen_toks, c_gen = counted(lambda: generate(model, cfg, prompts, LM_STEPS))
        prefill, serve_step = make_serve_fns(cfg, LM_PROMPTS[1] + LM_STEPS)
        (state, _), prefill_ms = timed(lambda: prefill(model, prompts))
        step_ms, outs = [], []
        for _ in range(LM_STEPS):
            outs.append(state.last_tokens)
            (state, logits), ms_i = timed(lambda: serve_step(model, state))
            step_ms.append(ms_i)
        outs = torch.stack(outs, dim=1)
        seq = torch.cat([prompts, outs], dim=1)
        full = forward(model, cfg, seq, attn_impl="naive").logits[:, -1]
        decode_gap = rel_gap(torch, logits, full)
        launches = st["launches"]["lm"]
        for name, count in c_gen.items():
            if name in launches:
                launches[name] += count
        by_inst = st["instances"]["lm"]["flash_attention"]
        for inst, count in c_gen["flash_by_instance"].items():
            by_inst[inst] += count
        ms_sorted = sorted(step_ms)
        rec.update(
            engine_prompts=list(LM_PROMPTS),
            engine_steps=LM_STEPS,
            engine_prefill_ms=prefill_ms,
            decode_ms_per_token_p50=float(np.median(ms_sorted)),
            decode_ms_per_token_max=ms_sorted[-1],
            decode_tokens_per_sec=LM_PROMPTS[0] * LM_STEPS / (sum(step_ms) / 1e3),
            decode_rel_gap=decode_gap,
            engine_tokens_match_generate=bool(torch.equal(outs, gen_toks)),
            engine_launches=c_gen["flash_attention"],
            peak_bytes=torch.cuda.max_memory_allocated(),
        )
    ok = rec["n_params"] == LM_PARAMS
    ok = ok and rec["depth4_f32_rel_gap"] <= LM_F32_GAP
    ok = ok and rec["depth4_f32_launches"] == cfg4.num_layers
    ok = ok and rec["depth4_f32_launches_by_instance"] == {
        "wgmma_bf16": 0,
        "fma_f32": cfg4.num_layers,
    }
    ok = ok and rec["prefill_timed_launches_by_instance"] == {
        "wgmma_bf16": cfg.num_layers,
        "fma_f32": 0,
    }
    ok = ok and rec["prefill_finite"] and rec["prefill_rel_gap"] <= LM_BF16_GAP
    ok = ok and rec["prefill_launches"] == {
        "warmup": cfg.num_layers,
        "timed": cfg.num_layers,
        "naive": 0,
    }
    ok = ok and decode_gap <= LM_DECODE_GAP and rec["engine_launches"] == 0
    rec["ok"] = ok
    emit(rec)
    del model, state
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("lm path failed its checks")


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
    record_plans(st)
    count_plain_kv(st)
    phases = (
        ("device", lambda: phase_device(torch, st)),
        ("kernels", lambda: phase_kernels(torch, st, args.n_side)),
        ("main", lambda: phase_main(torch, st, args.n_side)),
        ("serve", lambda: phase_serve(torch, st)),
        ("exact", lambda: phase_exact(torch, st)),
        ("mle", lambda: phase_mle(torch, st, args.n_side)),
        ("assess", lambda: phase_assess(torch, st, args.n_side)),
        ("dist", lambda: phase_dist(torch, st, args.n_side)),
        ("plans", lambda: phase_plans(st)),
        ("lm", lambda: phase_lm(torch, st)),
    )
    for name, fn in phases:
        st["phase"] = name
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
        if "ms_out_acc" in rec:
            kernels[-1]["ms_out_acc"] = rec["ms_out_acc"]
        if "instance" in rec:
            kernels[-1]["instance"] = rec["instance"]
            by_inst = {}
            for counts in st["instances"].values():
                for inst, count in counts.get(name, {}).items():
                    by_inst[inst] = by_inst.get(inst, 0) + count
            kernels[-1]["launches_by_instance"] = by_inst
        if name == "flash_attention":
            f32 = st["flash_f32"]
            kernels[-1]["f32_instance"] = {
                key: f32[key] for key in ("instance", "shape", *keys, "library_ms")
            }
        for key in ("nu", "steps", "k1_only_ms", "bound_share"):
            if key in rec:
                kernels[-1][key] = rec[key]
        extra_keys = ("case", "shape", "plan", "ms", "ms_out_acc", "plain_ms")
        extra_keys += ("library_ms", "instance", "nu", "dtype", "k1_only_ms")
        extra_keys += ("bound_by", "steps")
        extra_keys += ("bound_ms", "ms_sum", "library_ms_sum", "bound_ms_sum")
        extra_keys += ("max_abs_err", "bound_share", "ms_two_step")
        if name in st.get("extra", {}):
            kernels[-1]["other_shapes"] = [
                {key: r[key] for key in extra_keys if key in r}
                for r in st["extra"][name]
            ]
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
