#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n-side 128]

(``--recover-child DIR``, not listed in ``--help``, is the recover phase's
child process: the mle phase's fit with a checkpoint after every
iteration, on the data the parent wrote to DIR.)

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
``nvidia-smi``.  Phases, each printing one JSON line per result:

1. device   the card's name and power limit; the CUDA kernels under
            src/repro_torch/kernels/csrc are built from source (into
            src/repro_torch/kernels/build/) and the build time printed,
            with the compiler's report of the two flash_attention
            instances (registers, spills) and of the f64 (dmma_f64)
            instances of potrf, tlr_mm, trsm and syrk (registers, spills,
            and the DMMA instructions in each kernel's SASS).  It fails
            unless both flash instances (bf16 and tf32x3_f32) were compiled
            to the 168 registers a thread that their setmaxnreg splits
            assume, unless, where cuobjdump sits beside nvcc, their SASS
            holds HGMMA (bf16 and tf32 wgmma) and UTMALDG (TMA loads),
            unless every product kernel of the
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
            instances take (FLASH_CASES, recurrentgemma-9b's local
            attention at head dim 256 among them, bf16 only and timed:
            bf16 on wgmma, f32 on tf32 wgmma, and the lm_mesh path's
            shape on a rank timed beside the whole model's
            with the 3xTF32 split, both at ATTN_TOL; the f32 bound at three
            tf32 passes at 495 TFLOP/s, with one f32 pass at 67 TFLOP/s on
            the FP32 cores beside it, and the f32 depth-4, decode and q128
            shapes timed), potrf, tlr_mm,
            trsm and syrk at the shapes of both of theirs (f64 on DMMA, f32
            on FMAs), each record naming its instance.  potrf is also timed
            at (1, 2048, 2048) and (1, 4096, 4096), and failed on bad tiles
            and on a bad pivot in the first panel of a 4096 tile, in both
            instances; tlr_mm at B = 63, 8
            and 1, with out=acc (checked against the plain version on a
            copy), and summed over a factorization's sweep of B = 63 down to
            1; at the dist phase's first SYRK (B = 15) in both instances and
            with f32 factors and a float64 acc (the mixed SYRK, which must
            also equal the f32 form, cast and added, bit for bit), and its
            f32 instance summed over the mixed_f32 sweep of B = 15 down to
            1, all f32 and with the float64 acc; the f32 instance is held at
            a tolerance reasoned from its f32 sums (tlr_mm_f32_tol).  trsm
            is timed in both instances at the panel, wide, alpha and predict
            shapes and at nb = 4096, in f32 at the exact_f32 phase's first
            and last panel solves (1, 512, 32256) and (1, 512, 512), in f64
            at the exact4096 phase's; held on a real Matérn L_kk in both
            (the f32 one the exact_f32 path's own first factor, with both
            f32 solves' errors against an f64 solve), and held and summed
            over one TLR factorization's panel TRSMs (f64) and over the
            exact_f32 path's 63 panel solves (f32); syrk is timed at the
            exact phase's first update at panel 512 (both instances) and at
            panel 4096, and held and summed over the panel-512 paths' 63
            updates in both instances (the exact and exact_f32 phases'),
            each beside its library call.  potrf, trsm and tlr_mm are also
            held in their f64 instance (the examples' only one) at the
            examples' TLR panel steps (EXAMPLE_STEPS: tile edges 100 and
            108, ranks 64 and 32, which no other path takes; the first
            step's live rows and one row, the alpha sweep, the diagonal
            tile), the first step timed.  Times are the card's: cuda_ms
            queues the runs behind a sleep on the card, so the host's
            launch overhead between short calls does not enter.
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
4. serve    cokriging serving at the main configuration's widths (tile
            512, max rank 128, TLR7) on n = 64^2 locations of the same
            jittered grid, z simulated there (seed 0), its dense cokriging
            oracle from the dense Cholesky factor of Sigma (depth cut from
            the main cell's 128^2, whose fit repeated the main phase's
            factorization): ``fit_factor`` once (pair-major GEN + compress,
            TLR Cholesky, both sweeps; the general instance of matern_tile
            for the cross pair), then 8 ``predict_batch`` requests of 512 uniform
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
6. exact_f32 the reference's float32 exact path (``dist_loglik_lowerable``'s
            dtype): ``dist_exact_loglik`` at panel 512 on the same distances,
            Matérn parameters and z cast to float32, at the exact phase's
            nugget 1e-8 where the float32 factor holds there, else at the
            reference's float32 default 1e-6 beside an f64 evaluation at
            that nugget.  It fails unless the loglik is float32 and finite,
            within 1e-3 (relative, the reference's float32 tolerance) of the
            f64 exact loglik at its nugget, and potrf, trsm and syrk
            launched 64, 127 and 63 times, all of their fma_f32 instances,
            with Sigma's pairs through matern_corr.
7. grad     the nugget gradient of ``tlr_loglik(from_tiles=True)`` on the
            card (n = 16^2, tile 64, max rank 16, TLR7, nugget 1e-3, f64):
            autograd through the kernels' Functions (kernels/ops.py) and
            the guarded QR and SVD, against central differences at rel
            1e-4, with matern_tile, tlr_mm, potrf and trsm launched, and a
            Matérn range that requires grad refused by matern_tile.
8. mle      Nelder–Mead estimation through ``fit`` with the generator-direct
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
9. recover crash-tolerant estimation and the recovery machinery, at the
            mle phase's widths, locations and z (n = 48^2, tile 512, max
            rank 128, TLR7, f64, nugget 1e-8).  (1) Crash and resume: the
            parent writes the locations and z to an npz in a temporary
            directory and starts ``chip_smoke.py --recover-child DIR``,
            which runs ``fit(..., checkpoint_dir=DIR/ck,
            checkpoint_every=1)`` with the mle phase's MLEConfig; once
            LATEST names step 1 the parent kills it with SIGKILL.  It fails
            unless the child died of that signal with at least one step
            saved and fewer than all, LATEST names a complete step whose
            manifest and npz load, and no step_* directory is partial;
            then the same call here resumes the checkpoint, and must give
            the mle phase's uninterrupted fit (loglik and parameters within
            1e-10 relative, the same n_iters and n_evals) with fewer
            objective evaluations than that fit ran (counted, as
            ``resumed_evals``).  (2) Injected faults (``repro_torch.testing``)
            on the same locations and z: ``tlr_loglik(from_tiles=True)``
            clean, under ``corrupt_diag_tile(0, 10)`` (ok false,
            breakdown_count >= 1, the loglik equal to ``sentinel_loglik``),
            clean again (equal to the first bit for bit), under
            ``nan_compress_panel(1)`` (ok false, nonfinite_count +
            breakdown_count >= 1, a finite loglik: the NaNs go through
            cuSOLVER's QR and SVD); ``dist_tlr_loglik(block_cyclic=True)``
            under ``zero_shard(0, 4)`` (ok false, min_pivot <= 0, loglik,
            logdet and quad finite); the jitter ladder
            (``jitter_escalate(initial=1e-6, factor=10, max_jitter=1e-2,
            max_attempts=4)``) on four locations copied onto four others at
            nugget 0, which must end ok within 1e-3 of the dense exact
            loglik at the jitter it reached; ``fit_factor`` under
            ``corrupt_diag_tile``, whose ``predict_batch`` of 16 locations
            must raise ServeError ``broken_factor`` with ``status.ok``
            false on the wire; and degraded serving on the duplicated
            locations at nugget 0, whose means (finite) and variances
            (>= 0) must equal those of ``heal_factor``'s handle at 1e-10.
            Each evaluation's launches are recorded; matern_tile (general),
            tlr_mm, potrf and trsm must have launched during the phase.
10. assess  the paper's Algorithm 1 (MLOE/MMOM) at the main cell's full
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
11. dist    the single-device forms of the distributed TLR likelihood and
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
12. mesh    the multi-device forms on a torch.distributed ("data",
            "model") mesh (``repro_torch.launch.mesh``; one process a rank,
            started by ``spawn_ranks`` after the kernel library is built).
            (a) MESH_WORLD = 4 ranks on a (2, 2) mesh on the one card over
            gloo, which carries CUDA tensors (a stand-in: NCCL refuses two
            ranks on one device): ``dist_tlr_loglik(from_tiles=True)`` at
            the dist phase's inputs (n = 64^2, tile 512, max rank 128, TLR7,
            f64), block-cyclic and masked, each rank generating, compressing
            and factoring its own pair slots; ``dist_exact_loglik`` at the
            exact phase's inputs (n = 16384, m = 32768, panel 512), each
            rank holding its own panel-row blocks; then ``corrupt_diag_tile``
            under the mesh (detected, the finite sentinel) and the jitter
            ladder on four colliding locations of the dist inputs at nugget
            0.  (b) One rank over NCCL, the same block-cyclic call.  It
            fails unless every rank's TLR loglik is within 1e-8 (relative)
            of the dist phase's same form, with the ranks' factor rank
            totals summing to its total, the exact loglik within 1e-9 of
            the exact phase's panel-512 loglik, the injected tile detected
            with the sentinel loglik, the ladder ok within 1e-3 of the dense
            loglik at its jitter, and every rank launched matern_tile (its
            general instance), potrf, trsm, tlr_mm and syrk (the NCCL rank:
            all but syrk), no fma_f32 instance, and no plain K_nu on CUDA.
            Per rank it prints each evaluation's seconds, peak memory
            (beside the single-device form's) and launches by instance; a
            rank that fails fails the phase.
13. examples the paper's three geostat examples (examples/torch/) through
            their ``main`` on the card: quickstart (n = 20^2, tile 100,
            rank 64; the dense exact loglik and TLR5/7/9) and tlr_vs_exact
            (n = 18^2, tile 108, rank 64; three dependence strengths, each
            at TLR5/7/9, generator-direct and dense), each also with
            ``--device cpu`` in the same phase, every loglik on the card
            within 1e-9 (relative) of the CPU's; bivariate_fit_predict
            (n = 300 + 30, tile 100, rank 32, 80 iterations) exact and with
            ``--tlr``, which must give finite estimates, a fitted loglik no
            lower than the loglik at the start, a finite MSPE and
            MLOE >= -1e-9.  A second witness for those two fits: the
            script's exact and TLR7 objectives at both fits' end points, on
            the card and on the CPU, card within 1e-9 (relative) of the
            CPU, and the card's TLR7 value at the TLR fit's end equal to
            the loglik that fit reported (within 1e-9).  Each example must
            launch its kernels (EXAMPLE_KERNELS) and reports its seconds.
   plans    every plan the trsm (both instances) and the f64 syrk took on
            the main, serve, exact, exact_f32, mle, recover, assess, dist
            and examples paths
            (trsm: dtype, strip columns, update tile, row split; syrk: tile
            edge; each a kernel of its own) is one that a kernel check of
            phase 2 held against the plain version.
14. lm      LM serving for qwen3-4b at full width (d 2560, 32/8 heads, head
            dim 128, vocab 151936), random weights from a seeded generator.
            First a depth-4 float32 copy: ``forward(attn_impl="kernel")``
            against ``attn_impl="naive"`` on (1, 4096) tokens, relative gap
            (max abs difference over max abs) <= 1e-4.  Then the full
            36-layer bf16 model (its parameter count must be the reference's,
            4,022,468,096): the prefill forward on (2, 4096) tokens through
            the flash kernel (one warm-up, one run timed by CUDA events),
            finite, within 5e-2 of the naive path and with exactly 36 flash
            launches a forward, all of the bf16 instance (0 on the naive
            path; the depth-4 f32 forward's are 4, all of the f32
            instance tf32x3_f32);
            then the engine,
            ``generate`` on (8, 512) prompts for 64 greedy steps (cached
            attention: 0 flash launches), its prefill and each decode step
            timed, and the last step's logits within 5e-2 of a cacheless
            naive forward over prompt plus generated tokens.
15. lm_families the other six LM architectures in turn (LM_FAMILIES), each
            at full width in its config's bf16 with random weights from a
            seeded generator, at full depth where it fits (mamba2 48,
            recurrentgemma 38, pixtral 40, musicgen 48 layers) and cut where
            it does not (mixtral 8 of 32, llama4 one period, 2 of 48; the
            cut is printed), freed before the next loads: the parameter
            count must be ``param_count`` of the config at that depth; the
            cacheless prefill forward on (2, 4096) (tokens, or the frontend
            stub's embeddings for pixtral and musicgen) through
            ``attn_impl="kernel"``, dropless as the serving paths route,
            warm-up then timed, finite and within 5e-2 of the naive path
            with exactly one flash launch an attention layer, all of the
            bf16 instance (recurrentgemma's at head dim 256; mamba2 runs the
            SSD path and launches none).  For the MoE models the gap is held
            on the tokens whose experts agree in both runs in every MoE
            layer, and at most 2% of the tokens for each MoE layer may
            differ there (a router's near tie, flipped by bf16 rounding;
            both gaps, and each layer's share, are reported); the
            aux loss must be finite, positive and within 1e-2 of the naive
            run's.  Then ``generate`` on (8, 512) prompts for 32 greedy steps
            (0 flash launches), the same prefill and steps timed, and the
            last step's logits within 5e-2 of a cacheless naive forward over
            prompt plus generated tokens (on the rows whose last token's
            experts agree).
16. train   LM training (``repro_torch.training``), after every earlier
            model is freed.  (1) qwen3-4b at full width and depth (36
            layers; 4.02e9 parameters, 16 bytes each of state: bf16
            parameters and gradients, f32 master, m and v), bf16, remat
            and naive attention as the reference trains, from a seeded
            generator: TRAIN_STEPS ``train_step`` calls on one repeated
            (1, 4096) batch of ``SyntheticTokens`` with AdamW's warm-up of
            one step; each step's seconds (the first apart), tokens/s, loss
            and grad norm, the peak memory, then one more step split into
            ``grads_fn`` and ``adamw_update``, each timed.  It fails unless
            the parameter count is ``param_count``'s, every loss and grad
            norm is finite, the last loss is below the first, and every
            parameter equals ``master.to(bfloat16)`` bit for bit after the
            steps.  (2) The ten architectures reduced in f32 (TF32 off),
            each from a seeded CPU model copied to the card: one
            ``grads_fn`` with remat on the card against the same call on
            the CPU, and against remat=False on the card; the largest gap
            of the loss and of any gradient leaf over that leaf's largest
            magnitude must be at most 1e-4, every gradient finite.  (3) The
            trainer at the reduced qwen3-4b: a run whose fault hook raises
            at step 8 (checkpoints every 5) is resumed by a fresh Trainer
            with other weights, and must give an uninterrupted run's losses
            and parameters bit for bit; then ``examples/torch/train_lm.py``
            at its default size (100 steps), on the card, must end at step
            100 with finite losses.  The training path runs none of the
            hand-written kernels, as the reference's runs no Pallas kernel:
            its launches (all 0) are recorded, not gated.
17. lm_mesh the LM multi-device forms (``distribution.sharding``,
            ``models.shardspecs``, ``make_train_step(cfg, mesh)``) on
            LM_MESH_WORLD = 4 ranks of a (2, 2) ("data", "model") mesh on
            the one card over gloo (NCCL refuses two ranks on one device).
            First the single-device references on the card: qwen3-4b at
            full width cut to 8 of 36 layers, bf16, seeded: its prefill of
            (2, 4096) through the flash kernel (last-token logits, ms) and
            3 train steps (remat, naive attention, AdamW's warm-up of one
            step; losses, seconds, peak; the final parameters saved to a
            temporary file); mixtral-8x7b at full width cut to 2 of 32
            layers: the forward of each batch row alone (logits at every
            64th position and the last, routing).  Then each rank builds
            the same weights, takes its shard (FSDP over "data", tensor
            parallel over "model": 16 of the 32 query heads, 4 of the 8 KV
            heads; the vocabulary over "model") and its data-parallel row,
            and runs the sharded prefill (one warm-up, one timed), the
            three sharded train steps (each rank's shard of the f32 master
            weights held against the saved ones) and mixtral's sharded
            prefill (TP inside each expert, the shard-local dispatch of its
            row).  It fails unless every rank's last-token logits, losses,
            gradient norms and mixtral's logits at the positions whose
            experts agree in both runs are within 5e-2 (the lm phase's
            gap), no leaf of the master weights has more than 0.75 of its
            elements off the single-device ones by more than 1e-2 of its
            largest movement over the steps, nor more than 0.2 by more
            than 1e-1 (LM_MESH_OFF_SHARE; the gaps over each leaf's
            magnitude and movement are printed),
            each mixtral layer flips at most 2% of a row's tokens
            (lm_families'), and each rank launched the flash kernel 8 times
            in the timed prefill, all ``wgmma_bf16``.  Per rank it prints
            the peak memory, the prefill and step seconds and the time in
            every collective of ``launch.mesh`` (``time_collectives``),
            beside the single-device numbers.  On one card it tests
            placement and collectives, not scaling.

Before each path runs, every kernel's launch count is set to 0, and read
after it: the kernels of a path must have launched during it.  Then a
``kernels`` JSON line (the per-kernel summary; ``launches`` sums the main,
serve, exact (panel 512), exact4096, exact_f32, grad, mle, recover (the
resumed fit and the fault checks; the killed child's launches are another
process's), assess, dist (its five evaluations), examples (the card's runs),
mesh (every rank's evaluations, both backends), lm and lm_<arch> runs,
where each lm run is the timed prefill forward
and the engine's ``generate``, the train run (its full-width steps) and
lm_mesh (every rank's timed sharded prefill);
``launches_by_path`` splits them and
``launches_by_instance_by_path`` splits each path's by instance), the
nvidia-smi line, and, as the last line, ``{"ok": true, "device": {...}}``.
Any failed phase makes the script exit non-zero without that last line; so
does a missing CUDA device or a missing checkout around the script.  The
f64 geostat paths (main, serve, exact, exact4096, grad, mle, recover,
examples) fail if an
fma_f32 instance of potrf, tlr_mm, trsm or syrk was launched during them
(exact_f32 must launch only those of potrf, trsm and syrk; dist: only its
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
# tensor cores, FP32 67 TFLOP/s, TF32 495 TFLOP/s and BF16 989 TFLOP/s on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    ("elementwise", "float64"): 34e12,
    ("elementwise", "float32"): 67e12,
    ("matmul", "float64"): 67e12,
    ("matmul", "float32"): 67e12,
    ("matmul", "tf32"): 495e12,
    ("matmul", "bfloat16"): 989e12,
}
# The tf32 passes of each f32 product in the f32 flash instance (3xTF32).
TF32_PASSES = 3
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
# Registers a thread of the flash instances at launch: their setmaxnreg
# splits give 2 x 128 consumers 240 and 128 producers 24 (bf16), 224 and 56
# (tf32x3_f32).
FLASH_REGS = {
    "wgmma_bf16": (2 * 128 * 240 + 128 * 24) // 384,
    "tf32x3_f32": (2 * 128 * 224 + 128 * 56) // 384,
}
# The flash instances' kernels, by their names in the compiler's report.
FLASH_KERNELS = {"wgmma_bf16": "flash_wgmma_kernel", "tf32x3_f32": "flash_tf32x3_kernel"}
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
# The sources whose fma_f32 kernels the device phase reports (registers,
# spills): the redesigned f32 potrf, trsm and syrk.
FMA_F32_SOURCES = ("potrf.cu", "trsm.cu", "syrk.cu")
# The sources of the Matérn kernels (instances halfint and general).
MATERN_SOURCES = ("matern_tile.cu", "matern_corr.cu")
# The tolerances of tests/test_kernels.py's flash attention tests: _tol for
# bf16, the window and decode tests' for f32.
ATTN_TOL = {
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float32": dict(rtol=2e-5, atol=2e-5),
}
# The flash_attention checks of the kernels phase, (case, BH, BKV, Sq, Skv,
# D, dtype, window): qwen3-4b prefill at B = 2, S = 4096 (the path's shape),
# the f32 shape of the lm phase's depth-4 check, a window, right-aligned
# decode and a short query block against a long cache, a ragged length at
# phi3's head dim, the other head-dim instances, a length that is not a
# multiple of 128, recurrentgemma-9b's local attention at head dim 256
# (prefill at B = 2, S = 4096: 2 x 16 query heads, 2 x 1 KV heads, window
# 2048; bf16 only: the f32 instance has no D = 256), a ragged D = 256
# shape and the lm_mesh path's shape on a rank (one row of the (2, 4096)
# batch, 16 of qwen3-4b's 32 query heads and 4 of its 8 KV heads); and the
# (case, dtype) pairs that are timed.
FLASH_CASES = (
    ("path", 64, 16, 4096, 4096, 128, "bfloat16", 0),
    ("depth4_f32", 32, 8, 4096, 4096, 128, "float32", 0),
    ("window1024", 64, 16, 4096, 4096, 128, "bfloat16", 1024),
    ("decode", 64, 16, 1, 4096, 128, "float32", 0),
    ("decode", 64, 16, 1, 4096, 128, "bfloat16", 0),
    ("q128_kv4096", 64, 16, 128, 4096, 128, "float32", 0),
    ("q128_kv4096", 64, 16, 128, 4096, 128, "bfloat16", 0),
    ("ragged_d96_mha", 32, 32, 1000, 1000, 96, "float32", 0),
    ("ragged_d96_mha", 32, 32, 1000, 1000, 96, "bfloat16", 0),
    ("d64_gqa", 8, 2, 300, 300, 64, "float32", 0),
    ("d64_gqa", 8, 2, 300, 300, 64, "bfloat16", 0),
    ("d32_window", 8, 8, 200, 333, 32, "float32", 50),
    ("d32_window", 8, 8, 200, 333, 32, "bfloat16", 50),
    ("s4000", 64, 16, 4000, 4000, 128, "bfloat16", 0),
    ("recurrentgemma_d256", 32, 2, 4096, 4096, 256, "bfloat16", 2048),
    ("d256_ragged", 6, 2, 300, 333, 256, "bfloat16", 100),
    ("lm_mesh_rank", 16, 4, 4096, 4096, 128, "bfloat16", 0),
)
FLASH_TIMED = (
    ("path", "bfloat16"),
    ("depth4_f32", "float32"),
    ("decode", "float32"),
    ("q128_kv4096", "float32"),
    ("recurrentgemma_d256", "bfloat16"),
    ("lm_mesh_rank", "bfloat16"),
)
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
# The serve phase's grid side (n = 64^2, m = 8192, 16 tiles of 512): depth
# cut from the main cell's 128^2, whose fit_factor repeated the main phase's
# factorization (PERF.md section 4).
SERVE_N_SIDE = 64
# Live rows of the first TLR panel step there: T - 1 = 32768 / 512 - 1.
SWEEP_B = 63
# The reference's default panel of dist_exact_loglik, the exact phase's
# second evaluation.
EXACT_PANEL = 4096
MATERN = dict(sigma11=1.0, sigma22=1.0, a=0.03, nu11=0.5, nu22=1.5, beta=0.5)
# The kernels the main and serve paths run (the exact path adds syrk).
TLR_KERNELS = ("matern_tile", "tlr_mm", "potrf", "trsm")
# The exact_f32 phase: the nuggets it tries in turn (the exact phase's,
# then the reference's float32 default, dist_loglik_lowerable's), and its
# gap to the f64 exact loglik at the same nugget (the reference's float32
# tolerance, tests/test_distributed.py).
EXACT_F32_NUGGETS, EXACT_F32_GAP = (NUGGET, 1e-6), 1e-3
# The grad phase: tests/test_tlr_tiles.py's gradient test at a size the
# kernels take (n = 16^2, m = 512, tile 64, 8 tiles; 2 kmax <= tile), its
# Matérn truth, nugget, difference step and gate.
GRAD_N_SIDE, GRAD_TILE, GRAD_KMAX = 16, 64, 16
GRAD_MATERN = dict(a=0.09, nu11=0.5, nu22=1.5, beta=0.5)
GRAD_NUGGET, GRAD_EPS, GRAD_REL = 1e-3, 1e-6, 1e-4
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
# The mesh phase: W ranks on the one card over gloo (the stand-in transport
# of several ranks on one device: NCCL refuses two ranks on one GPU), and
# one rank over NCCL, the production backend; the gates against the
# single-device forms (the dist phase's TLR logliks at its inputs, the
# exact phase's panel-512 loglik at the main cell's), the kernels every rank
# must launch, and the ranks' time limit in seconds (a rank stuck in a
# collective fails at it).
MESH_WORLD, MESH_TLR_GAP, MESH_EXACT_GAP = 4, 1e-8, 1e-9
MESH_KERNELS = ("matern_tile", "potrf", "trsm", "tlr_mm", "syrk")
MESH_TIMEOUT_S = 480.0
# The recover phase: the step whose save makes the parent kill its child
# (with a save after every iteration, step 1 closes the second of
# MLE_ITERS), the child's time limit in seconds, the gate of the resumed
# fit against the mle phase's and of degraded serving against the healed
# factor; the locations copied onto the last ones for the jitter ladder
# (the reference's 8-device test), its rungs and its gate against the dense
# exact loglik; the prediction locations of the serving checks.
RECOVER_KILL_STEP, RECOVER_CHILD_TIMEOUT, RECOVER_GAP = 1, 300.0, 1e-10
RECOVER_DUPS = 4
RECOVER_LADDER = dict(initial=1e-6, factor=10.0, max_jitter=1e-2, max_attempts=4)
RECOVER_LADDER_GAP = 1e-3
RECOVER_NPRED, RECOVER_PRED_SEED = 16, 3
# The examples phase: each example's TLR panel steps, held in the kernels
# phase at the first step's live rows and at one row, and the forward
# sweep's alpha (tag, live rows, tile edge, rank): quickstart (m = 800, tile
# 100, rank 64), tlr_vs_exact (m = 648, tile 108, rank 64) and
# bivariate_fit_predict --tlr (m = 600, tile 100, rank 32); the kernels each
# example must launch on the card; the gap of an example's logliks on the
# card to the same main on the CPU.
EXAMPLE_STEPS = (
    ("quickstart", 7, 100, 64),
    ("tlr_vs_exact", 5, 108, 64),
    ("bivariate_tlr", 5, 100, 32),
)
EXAMPLE_KERNELS = {
    "quickstart": ("matern_corr", "potrf", "trsm", "tlr_mm"),
    "tlr_vs_exact": ("matern_corr", "matern_tile", "potrf", "trsm", "tlr_mm"),
    "bivariate_fit_predict": ("matern_corr",),
    "bivariate_fit_predict_tlr": ("matern_corr", "potrf", "trsm", "tlr_mm"),
}
EXAMPLE_CPU_GAP = 1e-9
# The lm phase (PERF.md section 4): qwen3-4b at full width and depth, bf16;
# its parameter count as the reference's init_model makes it; prefill batch
# and length; the engine's prompts and greedy steps; the gates.
LM_ARCH, LM_PARAMS = "qwen3-4b", 4_022_468_096
LM_PREFILL = (2, 4096)
LM_PROMPTS, LM_STEPS = (8, 512), 64
LM_F32_GAP, LM_BF16_GAP, LM_DECODE_GAP = 1e-4, 5e-2, 5e-2
# The lm_families phase (PERF.md section 4): the other six LM architectures
# at full width in their configs' bfloat16, each at the depth it runs: full
# depth where the model fits, mixtral cut to 8 of its 32 layers (23.7 GB;
# 32 would be 93 GB) and llama4 to one period, 2 of 48 layers (37 GB: its
# MoE layer alone holds 16.1e9 parameters); a seed for each model's
# weights.  The engine's prompts and greedy steps; the largest share of
# tokens, for each MoE layer of the model, whose expert choice may differ
# between the kernel and the naive prefill (a near tie of the router,
# flipped by bf16 rounding; a token that flips in one layer moves on
# another way, so the shares add up over the layers: mixtral's 8 gave 10%,
# llama4's one 0.9%; the gap is held on the other tokens); the MoE aux
# loss's gap.
LM_FAMILIES = (
    ("mixtral-8x7b", 8, 11),
    ("llama4-maverick-400b-a17b", 2, 12),
    ("mamba2-780m", 48, 13),
    ("recurrentgemma-9b", 38, 14),
    ("pixtral-12b", 40, 15),
    ("musicgen-medium", 48, 16),
)
LM_FAMILY_PROMPTS, LM_FAMILY_STEPS = (8, 512), 32
LM_ROUTING_FLIP_SHARE, LM_AUX_GAP = 2e-2, 1e-2
# The train phase (PERF.md section 4): qwen3-4b at full width and depth in
# bf16 with remat and naive attention (the reference's training path), on
# one repeated batch (batch, sequence); the train steps, the weights' seed
# and AdamW's warm-up of one step.  The ten architectures
# reduced in f32: the batch of one gradient on the card against the CPU,
# with the largest relative gap of any leaf (and of the loss) allowed.
# The trainer's crash-and-resume at the reduced qwen3-4b: its steps, the
# step whose fault hook raises, the checkpoint period.
TRAIN_ARCH, TRAIN_BATCH = "qwen3-4b", (1, 4096)
TRAIN_STEPS, TRAIN_SEED = 5, 21
TRAIN_REDUCED_BATCH, TRAIN_F32_GAP = (2, 64), 1e-4
TRAINER_STEPS, TRAINER_CRASH_STEP, TRAINER_EVERY = 12, 8, 5

# The lm_mesh phase (PERF.md section 4): the LM multi-device forms on
# LM_MESH_WORLD ranks of a LM_MESH_SHAPE ("data", "model") mesh on the one
# card over gloo.  qwen3-4b at full width, cut to LM_MESH_LAYERS of its 36
# layers (1.2e9 parameters), bf16, from LM_MESH_SEED: one sharded prefill of
# LM_MESH_BATCH through the flash kernel, held on the last token's logits,
# and LM_MESH_STEPS sharded train steps (remat, naive attention, the train
# phase's AdamW warm-up of one step), held on the losses and the gathered
# parameters, each against the same on one device; mixtral-8x7b at full
# width cut to LM_MESH_MOE_LAYERS of 32 layers, one sharded prefill (TP
# inside the experts) against the single-device forward of each
# data-parallel rank's row alone, at every LM_MESH_SAMPLE-th token position
# and the last.  The gates are the lm phase's LM_BF16_GAP (logits, losses,
# gradient norms) and the lm_families phase's LM_ROUTING_FLIP_SHARE a MoE
# layer.  The f32 master weights are held, shard by shard, on the share of
# each leaf's elements off the single-device ones by more than 1e-2 and by
# more than 1e-1 of the leaf's largest movement over the steps, at most
# LM_MESH_OFF_SHARE: AdamW's first steps move an element by about lr
# whatever its gradient's size, so an element whose gradient is at bf16
# rounding level moves either way in the two runs, while a wrong gradient
# moves most of its leaf's elements otherwise.  On an H100 sound runs read
# 0.469 and 0.047 at most (q_norm), a run with scripts/lm_mesh.py --plant's
# fault (q_norm's and k_norm's gradients unsummed over "model", which moves
# no gradient norm past 1.2e-3) 0.992 and 0.773.
LM_MESH_ARCH, LM_MESH_LAYERS, LM_MESH_SEED = "qwen3-4b", 8, 31
LM_MESH_WORLD, LM_MESH_SHAPE = 4, (2, 2)
LM_MESH_BATCH, LM_MESH_STEPS = (2, 4096), 3
LM_MESH_MOE, LM_MESH_MOE_LAYERS, LM_MESH_MOE_SEED = "mixtral-8x7b", 2, 32
LM_MESH_SAMPLE, LM_MESH_TIMEOUT_S = 64, 600.0
LM_MESH_OFF_SHARE = (0.75, 0.2)

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
    from repro_torch.kernels.flash_attention import HEAD_DIMS

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
    regs_ok = True
    for inst, want_regs in FLASH_REGS.items():
        # one report a head-dim instance (wgmma_bf16: D 32-256, tf32x3_f32:
        # D 32-128)
        regs = [ln for ln in flash[inst] if "registers" in ln]
        want = f"Used {want_regs} registers"
        n_dims = len(HEAD_DIMS[inst])
        regs_ok = regs_ok and len(regs) == n_dims and all(want in ln for ln in regs)
    sass = flash_sass(lib)
    dmma = dmma_report(text, lib)
    fma = {}
    for src in FMA_F32_SOURCES:
        fma.update(ptxas_entries(text, src, lambda n: "_f32" in n))
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
            "fma_f32": fma,
            "matern": matern,
        }
    )
    if not st["flash_ok"]:
        raise AssertionError("a flash instance is not built as designed")
    if not dmma["ok"]:
        raise AssertionError("a dmma_f64 product kernel has no DMMA in its SASS")
    if not matern["ok"]:
        raise AssertionError("a Matérn kernel is not built as designed")


def flash_ptxas(log_text: str) -> dict:
    """The compiler's report lines of flash_attention.cu's entry functions,
    by instance: ``flash_wgmma_kernel`` (bf16) and ``flash_tf32x3_kernel``
    (f32)."""
    section = log_text.split("== flash_attention.cu", 1)[-1].split("\n== ", 1)[0]
    out = {inst: [] for inst in FLASH_KERNELS}
    key = None
    for line in section.splitlines():
        if "Compiling entry function" in line:
            key = next((i for i, k in FLASH_KERNELS.items() if k in line), None)
            if key:
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
    """Counts of HGMMA (bf16 and tf32 wgmma alike), UTMALDG and UTMASTG in
    each flash kernel's SASS (both instances), where cuobjdump sits beside
    nvcc; ok unless an HGMMA or UTMALDG count is 0."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    functions = sass_functions(lib)
    if functions is None:
        return {"cuobjdump": None}
    counts = {}
    for name, part in functions.items():
        if any(k in name for k in FLASH_KERNELS.values()):
            ops = ("HGMMA", "UTMALDG", "UTMASTG")
            counts[name] = {op: part.count(op) for op in ops}
    ok = len(counts) == sum(map(len, HEAD_DIMS.values())) and all(
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


def check_potrf_failure(torch, gen, dtype):
    """Two bad tiles (indefinite; a negative last pivot) between good ones:
    the bad ones come back all NaN, the good ones as cholesky_ex gives."""
    from repro_torch.kernels.chol_tiles import potrf_cuda, potrf_instance

    nb = 512
    dname = str(dtype).split(".")[-1]
    a = _spd(torch, gen, 4, nb, dtype)
    a[1] -= 1e4 * torch.eye(nb, dtype=a.dtype, device="cuda")
    a[2, nb - 1, nb - 1] = -1.0
    got = potrf_cuda(a)
    want, info = torch.linalg.cholesky_ex(a)
    torch.cuda.synchronize()
    nan_tiles = [bool(torch.isnan(got[t]).all()) for t in range(4)]
    err, good = max_err(torch, got[0::3], want[0::3], **CHOL_TOL["potrf"][dname])
    ok = nan_tiles == [False, True, True, False] and good
    ok = ok and [int(x) for x in info.cpu()][1:3] != [0, 0]
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "instance": potrf_instance(dtype),
        "case": "non_spd",
        "shape": [4, nb, nb],
        "dtype": dname,
        "all_nan_tiles": nan_tiles,
        "max_abs_err_good_tiles": err,
        "ok": ok,
    }
    emit(rec)
    return rec


def check_potrf_failure_first_panel(torch, gen, dtype):
    """A (1, 4096, 4096) tile whose pivot 10, in the first panel, is bad:
    it comes back all NaN, and cholesky_ex reports the failure."""
    from repro_torch.kernels.chol_tiles import potrf_cuda, potrf_instance

    nb = 4096
    a = _spd(torch, gen, 1, nb, dtype)
    a[0, 10, 10] = -5.0
    got = potrf_cuda(a)
    info = torch.linalg.cholesky_ex(a)[1]
    torch.cuda.synchronize()
    all_nan = bool(torch.isnan(got).all())
    rec = {
        "phase": "kernel_check",
        "kernel": "potrf",
        "instance": potrf_instance(dtype),
        "case": "bad_pivot_first_panel_4096",
        "shape": [1, nb, nb],
        "dtype": str(dtype).split(".")[-1],
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


def check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed, lo=None, note=None):
    """trsm_cuda against trsm_ref on the factor of a a^T + nb I, or on
    ``lo`` where given (``note``: fields added to the record).  An f32
    record also gives the kernel's and solve_triangular's f32 errors against
    solve_triangular in f64 on the same f32 inputs."""
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
        "plan": trsm_plan(b, nb, r, sm_count(torch), dtype),
        "dtype": dname,
        "max_abs_err": err,
        "ok": ok,
        "tol": tol,
        "bound_ms": b_ms,
        "bound_by": b_by,
        **(note or {}),
    }
    if dtype == torch.float32:
        exact = torch.linalg.solve_triangular(lo.double(), rhs.double(), upper=False)
        rec["max_abs_err_vs_f64"] = float((got.double() - exact).abs().max())
        rec["library_max_abs_err_vs_f64"] = float((want.double() - exact).abs().max())
        rec["max_abs_x"] = float(exact.abs().max())
        del exact
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


def exact_f32_lkk(torch, locs, params):
    """The exact_f32 path's first L_kk: the float32 factor (potrf_cuda, as
    the path takes it) of the bivariate Sigma of the first 256 Morton
    locations, built from float32 distances and parameters at the first of
    EXACT_F32_NUGGETS whose factor holds; (factor, nugget)."""
    from repro_torch.core.covariance import MaternParams, build_sigma, pairwise_distances
    from repro_torch.kernels.chol_tiles import potrf_cuda

    d32 = pairwise_distances(locs[: TILE // 2]).float()
    params32 = MaternParams(*(x.float() for x in params))
    for nugget in EXACT_F32_NUGGETS:
        a = build_sigma(None, params32, dists=d32, nugget=nugget)
        lo = potrf_cuda(a[None].contiguous())
        if bool(torch.isfinite(lo).all()):
            return lo, nugget
    raise AssertionError("the float32 factor of the first panel failed")


def check_trsm_matern(torch, gen, locs, params, dtype):
    """The panel TRSM's shape on a real L_kk.  f64: the factor of the main
    configuration's first diagonal tile (the first 256 Morton locations,
    nugget 1e-8), broadcast over 63 tiles of 128 right-hand sides.  f32:
    the exact_f32 path's own first L_kk (exact_f32_lkk) at the wide shape
    (1, 512, 8064), with the errors of the kernel and of the f32 library
    against solve_triangular in f64."""
    from repro_torch.core.covariance import build_sigma_panel

    if dtype == torch.float64:
        blk = locs[: TILE // 2]
        a = build_sigma_panel(blk, blk, params, gen="kernel")
        a = a + NUGGET * torch.eye(TILE, dtype=a.dtype, device="cuda")
        lo = torch.linalg.cholesky(a)[None]
        return check_trsm(torch, gen, "matern_lkk", SWEEP_B, TILE, KMAX, 1,
                          dtype, False, lo=lo)
    lo, nugget = exact_f32_lkk(torch, locs, params)
    return check_trsm(torch, gen, "matern_lkk_exact_f32", 1, TILE, SWEEP_B * KMAX,
                      1, dtype, False, lo=lo, note={"nugget": nugget})


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


def check_trsm_exact_sweep(torch, gen, dtype=None):
    """The panel solves of one exact evaluation at panel 512 (the exact and
    exact_f32 phases): one L_kk (1, 512, 512) against r = 512 x 63 down to
    512 right-hand sides, each held against solve_triangular at CHOL_TOL;
    the kernel's, the library's and the bound's sums."""
    from repro_torch.kernels.chol_tiles import trsm_cuda, trsm_instance, trsm_plan

    dtype = dtype or torch.float32
    dname = str(dtype).split(".")[-1]
    lo = torch.linalg.cholesky(_spd(torch, gen, 1, TILE, torch.float64))
    lo = lo.to(dtype).contiguous()
    tol = CHOL_TOL["trsm"][dname]
    ms = lib = bnd = err = 0.0
    ok = True
    plans = set()
    for k in range(SWEEP_B, 0, -1):
        r = k * TILE
        x = torch.randn((1, TILE, r), generator=gen, dtype=torch.float64,
                        device="cuda").to(dtype)
        got = trsm_cuda(lo, x)
        want = torch.linalg.solve_triangular(lo, x, upper=False)
        e, good = max_err(torch, got, want, **tol)
        err, ok = max(err, e), ok and good
        plans.add(tuple(trsm_plan(1, TILE, r, sm_count(torch), dtype)))
        ms += cuda_ms(torch, lambda: trsm_cuda(lo, x), reps=5)
        lib += cuda_ms(
            torch,
            lambda: torch.linalg.solve_triangular(lo, x, upper=False),
            reps=5,
        )
        bnd += _trsm_bound(1, TILE, r, 1, x.element_size())[0]
        del x, got, want
    rec = {
        "phase": "kernel_check",
        "kernel": "trsm",
        "instance": trsm_instance(dtype),
        "case": "sweep_exact_panel512",
        "shapes": [[1, TILE, SWEEP_B * TILE], [1, TILE, TILE]],
        "dtype": dname,
        "plans": sorted(plans),
        "max_abs_err": err,
        "tol": tol,
        "ms_sum": ms,
        "library_ms_sum": lib,
        "bound_ms_sum": bnd,
        "ok": ok and math.isfinite(ms),
    }
    emit(rec)
    del lo
    torch.cuda.empty_cache()
    return rec


def check_trsms(torch, st, gen, locs, params, dtypes=None):
    """trsm at the kernels phase's shapes, in ``dtypes`` (both instances by
    default): the panel TRSM (one L_kk for the 63 live V tiles of step 0:
    r = 63 x 128 = 8064 columns in all), the same columns as one tile
    (wide), the sweep for alpha (r = 1), the sweep of a 512-location
    request (r = 512 x 2), a ragged case with a factor per tile, nb = 1,
    the README's serving tile, the reference's exact panel 4096 (eight
    super-blocks and updates: the large-nb schedule) and its alpha, each
    timed in both instances; the exact path's first and last panel solves
    at panel 512 (timed in f32, the exact_f32 path's) and at panel 4096
    (timed in f64; updates of 128 x 128 tiles); the panel shape on a real
    Matérn L_kk (the f32 one the exact_f32 path's own); the summed sweep
    of one TLR factorization's panel TRSMs (f64) and of the exact_f32
    path's 63 panel solves (f32)."""
    f64, f32 = torch.float64, torch.float32
    both = (f64, f32)
    m = (SWEEP_B + 1) * TILE
    cases = (
        ("panel", 63, 512, 128, 1, both, both),
        ("wide", 1, 512, 8064, 1, both, both),
        ("alpha", 1, 512, 1, 1, both, both),
        ("predict", 1, 512, 1024, 1, both, both),
        ("ragged", 3, 200, 37, 3, both, ()),
        ("nb1", 2, 1, 3, 2, both, ()),
        ("tile2048", 4, 2048, 128, 1, both, ()),
        ("panel4096", 1, 4096, 512, 1, both, both),
        ("alpha4096", 1, 4096, 1, 1, both, both),
        ("exact_first", 1, TILE, m - TILE, 1, (f32,), (f32,)),
        ("exact_last", 1, TILE, TILE, 1, (f32,), (f32,)),
        ("exact4096_first", 1, EXACT_PANEL, m - EXACT_PANEL, 1, (f64,), (f64,)),
        ("exact4096_last", 1, EXACT_PANEL, EXACT_PANEL, 1, (f64,), (f64,)),
    )
    extra = st.setdefault("extra", {}).setdefault("trsm", [])
    records = []
    for tag, b, nb, r, lo_b, kinds, timed_kinds in cases:
        for dtype in kinds:
            if dtypes is not None and dtype not in dtypes:
                continue
            timed = dtype in timed_kinds
            rec = check_trsm(torch, gen, tag, b, nb, r, lo_b, dtype, timed)
            records.append(rec)
            if tag == "panel" and dtype == f64:
                st.setdefault("summary", {})["trsm"] = rec
            elif timed:
                extra.append(rec)
    for dtype in both:
        if dtypes is None or dtype in dtypes:
            records.append(check_trsm_matern(torch, gen, locs, params, dtype))
    if dtypes is None or f64 in dtypes:
        records.append(check_trsm_sweep(torch, gen))
        extra.append(records[-1])
    if dtypes is None or f32 in dtypes:
        records.append(check_trsm_exact_sweep(torch, gen, f32))
        extra.append(records[-1])
    return records


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


def check_syrk_sweep(torch, gen, dtype, panel=TILE):
    """The trailing update of every panel step of the exact path at the main
    configuration (m = 32768, panel 512): nb = 32256 down to 512, C the
    trailing block of a larger matrix and A column-major, as the path
    passes them, each held against baddbmm's result; the kernel's summed
    time beside the library's.  float64 is the exact phase's, float32 the
    exact_f32 phase's."""
    from repro_torch.kernels.chol_tiles import syrk_cuda, syrk_instance

    dname = str(dtype).split(".")[-1]
    m = (SWEEP_B + 1) * TILE  # 32768
    kw = dict(generator=gen, dtype=dtype, device="cuda")
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
            e, good = max_err(torch, got[:, rows], want[:, rows], **TOL[dname])
            err, ok = max(err, e), ok and good
        del got, want
        ms += cuda_ms(torch, lambda: syrk_cuda(c, a), reps=3, warmup=1)
        lib += cuda_ms(
            torch, lambda: torch.baddbmm(c, a, a.mT, alpha=-1.0), reps=3, warmup=1
        )
        bnd += _syrk_bound(1, nb, panel, big.element_size())[0]
    rec = {
        "phase": "kernel_check",
        "kernel": "syrk",
        "instance": syrk_instance(dtype),
        "case": "sweep_exact_panel512",
        "shapes": [[1, m - panel, panel], [1, panel, panel]],
        "dtype": dname,
        "max_abs_err": err,
        "tol": TOL[dname],
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
    if dname == "float32":
        # the 3xTF32 split: three tf32 passes a product on the tensor cores;
        # beside it, one f32 pass on the FP32 cores
        b_ms, b_by = bound(nbytes, TF32_PASSES * flops, "matmul", "tf32")
        fp32 = bound(nbytes, flops, "matmul", "float32")
    else:
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
    if dname == "float32":
        rec["bound_fp32_cores_ms"], rec["bound_fp32_cores_by"] = fp32
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


def check_potrfs(torch, st, gen, dtypes=None):
    """potrf at the kernels phase's shapes (see phase_kernels), in
    ``dtypes`` (both instances by default); the path shape timed in both,
    the serving and exact-panel tiles timed too."""
    f64, f32 = torch.float64, torch.float32
    both = (f64, f32)
    cases = (
        ("path", 1, 512, both),
        ("batch", 8, 512, both),
        ("multiwave", 40, 512, both),
        ("multiwave4096", 8, 4096, both),
        ("ragged", 3, 200, both),
        ("nb1", 1, 1, both),
        ("tile2048", 1, 2048, both),
        ("tile4096", 1, 4096, both),
    )
    records = []
    for tag, b, nb, kinds in cases:
        for dtype in kinds:
            if dtypes is not None and dtype not in dtypes:
                continue
            timed = tag in ("path", "tile2048", "tile4096")
            rec = check_potrf(torch, gen, tag, b, nb, dtype, timed)
            records.append(rec)
            if tag == "path" and dtype == f64:
                st.setdefault("summary", {})["potrf"] = rec
            elif timed:
                st.setdefault("extra", {}).setdefault("potrf", []).append(rec)
    return records


def check_syrks(torch, st, gen, dtypes=None):
    """syrk at the kernels phase's shapes, in ``dtypes`` (both instances by
    default): the exact path's first update at panel 512 (timed in both)
    and 4096 (f64, timed), a batch, the JAX test shapes, a ragged nb
    (row-major A; and odd nb and k in the path layout, whose copies are
    element by element), the path's last step (the f64 instance's 64 x 64
    tiles), k = 1, offsets past 2^31 (f64), and each dtype's sweep of the
    63 updates."""
    f64, f32 = torch.float64, torch.float32
    both = (f64, f32)
    cases = (
        ("path", 1, 32256, 512, True, both),
        ("batch", 4, 512, 128, False, both),
        ("jax_2x64x64", 2, 64, 64, False, both),
        ("jax_4x32x16", 4, 32, 16, False, both),
        ("ragged", 2, 1000, 200, False, both),
        ("ragged_path", 2, 1001, 203, True, both),
        ("last_step", 1, 512, 512, True, both),
        ("k1", 2, 300, 1, False, both),
        ("path4096", 1, 28672, 4096, True, (f64,)),
    )
    extra = st.setdefault("extra", {}).setdefault("syrk", [])
    records = []
    for tag, b, nb, k, path_layout, kinds in cases:
        for dtype in kinds:
            if dtypes is not None and dtype not in dtypes:
                continue
            timed = tag in ("path", "path4096") or (tag == "batch" and dtype == f64)
            rec = check_syrk(torch, gen, tag, b, nb, k, dtype, timed, path_layout)
            records.append(rec)
            if tag == "path" and dtype == f64:
                st.setdefault("summary", {})["syrk"] = rec
            elif timed:
                extra.append(rec)
    if dtypes is None or f64 in dtypes:
        records.append(check_syrk_64bit(torch, gen))
    for dtype in both:
        if dtypes is None or dtype in dtypes:
            records.append(check_syrk_sweep(torch, gen, dtype))
            extra.append(records[-1])
    return records


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
    # potrf, both instances: the panel-head tile of the main path (the f32
    # one's on the exact_f32 path), a batch, a ragged nb, nb = 1, the
    # README's serving tile (2048) and the reference's default exact panel
    # (4096), bad tiles and a real Matérn tile.  The multiwave batches give
    # the panel launch more blocks than the card holds at once (about two a
    # SM): 40 x 7 and 8 x 63 at the first panel.
    records.extend(check_potrfs(torch, st, gen))
    for dtype in (f64, f32):
        records.append(check_potrf_failure(torch, gen, dtype))
        records.append(check_potrf_failure_first_panel(torch, gen, dtype))
    records.append(check_potrf_matern(torch, locs, params))
    # trsm in both instances at the shapes of its paths (check_trsms)
    records.extend(check_trsms(torch, st, gen, locs, params))
    # potrf, trsm and tlr_mm at the examples' tile edges 100 and 108
    records.extend(check_example_steps(torch, st, gen))
    # syrk, both instances: the first trailing update of the exact phase
    # (m_k = 32256, panel 512) in the operands' path layout, the JAX test
    # shapes, ragged nb, the panel-4096 path's first step, offsets past 2^31,
    # and the summed sweeps of the panel-512 paths' 63 updates (check_syrks)
    records.extend(check_syrks(torch, st, gen))
    # flash_attention, both instances, at FLASH_CASES (those of FLASH_TIMED
    # timed: the bf16 path, and the f32 depth-4, decode and q128 shapes)
    if not st.get("flash_ok"):
        raise AssertionError("a flash instance failed the device phase")
    for tag, bh, bkv, sq, skv, d, dname, window in FLASH_CASES:
        timed = (tag, dname) in FLASH_TIMED
        dtype = getattr(torch, dname)
        rec = check_flash_attention(
            torch, gen, tag, bh, bkv, sq, skv, d, dtype, window, timed
        )
        records.append(rec)
        if tag == "path":
            st.setdefault("summary", {})["flash_attention"] = rec
        elif tag == "depth4_f32":
            st["flash_f32"] = rec
        elif timed:
            st.setdefault("extra", {}).setdefault("flash_attention", []).append(rec)
    if not all(rec["ok"] for rec in records):
        raise AssertionError("a kernel disagrees with its plain version")


def check_example_steps(torch, st, gen):
    """potrf, trsm and tlr_mm in their f64 instance (the only one the
    examples run) at the TLR panel steps of the examples (EXAMPLE_STEPS):
    tile edges 100 and 108, ranks 64 and 32, which no other path takes;
    the first step's live rows timed, one row, the forward sweep's alpha
    (trsm, r = 1) and the diagonal tile (potrf)."""
    records, extra = [], st.setdefault("extra", {})
    f64 = torch.float64
    for tag, b, nb, k in EXAMPLE_STEPS:
        for rows in (b, 1):
            first = rows == b
            case = f"{tag}_b{rows}"
            for rec in (
                check_tlr_mm(torch, gen, case, rows, f64, first, nb, k),
                check_trsm(torch, gen, case, rows, nb, k, 1, f64, first),
            ):
                records.append(rec)
                if first:
                    extra.setdefault(rec["kernel"], []).append(rec)
        records.append(check_trsm(torch, gen, f"{tag}_alpha", 1, nb, 1, 1, f64, False))
        rec = check_potrf(torch, gen, tag, 1, nb, f64, True)
        records.append(rec)
        extra.setdefault("potrf", []).append(rec)
    return records


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
    from repro_torch.core.simulate import simulate_mgrf
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    nugget, tol, tile, kmax = NUGGET, TOL_TLR, TILE, KMAX
    locs, params, gen = main_config(torch, n_side, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z = simulate_mgrf(gen, locs, params, nugget=nugget, device=dev)[0]
    exact = exact_loglik(locs, z, params, nugget=nugget, device=dev)
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


def serve_inputs(torch, n_side: int, dev):
    """The serve phase's own inputs: the main configuration at n_side^2
    locations, z simulated there (seed 0), the requests, and their dense
    cokriging oracle from the dense Cholesky factor of Sigma."""
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.prediction import cokrige, dense_factor
    from repro_torch.core.simulate import simulate_mgrf

    locs, params, gen = main_config(torch, n_side, dev)
    z = simulate_mgrf(gen, locs, params, nugget=NUGGET, device=dev)[0]
    exact = exact_loglik(locs, z, params, nugget=NUGGET, keep_chol=True, device=dev)
    dense = dense_factor(locs, z, params, chol=exact.chol)
    requests = serve_requests()
    oracle = [cokrige(None, None, pred, factor=dense) for pred in requests]
    del exact, dense
    torch.cuda.empty_cache()
    return locs, z, params, requests, oracle


def phase_serve(torch, st, n_side: int):
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

    dev = torch.device("cuda")
    side = min(SERVE_N_SIDE, n_side)
    t0 = time.perf_counter()
    locs, z, params, requests, oracle = serve_inputs(torch, side, dev)
    inputs_s = time.perf_counter() - t0
    cfg = CokrigeServeConfig(
        tile_size=TILE, max_rank=KMAX, tol=TOL_TLR, nugget=NUGGET, gen="kernel"
    )
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
            "n_main_cell": n_side * n_side,
            "inputs_and_oracle_s": inputs_s,
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

    ref = st["exact_ref"]  # exact_f32 takes it after this phase
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
        if path == "exact":  # the mesh phase's input and reference
            st["exact_mesh_ref"] = dict(
                locs=np.asarray(locs), z=z.cpu().numpy(), loglik=ll, s=total_s,
                peak_bytes=peak,
            )
    del dists
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"exact panel path failed its checks at panel {failed}")


def phase_exact_f32(torch, st):
    """The reference's float32 exact path: ``dist_exact_loglik`` with the
    distances, the Matérn parameters and z in float32 at panel 512, so that
    POTRF, TRSM and SYRK run their fma_f32 instances; at the exact phase's
    nugget where the float32 factor holds there, else at the reference's
    float32 default, then beside an f64 evaluation at that nugget."""
    from repro_torch.core.covariance import MaternParams, pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.kernels import ops

    ref = st.pop("exact_ref")
    locs, z, params = ref["locs"], ref["z"], ref["params"]
    dev = torch.device("cuda")
    m = z.shape[-1]
    nk = m // TILE
    dists = pairwise_distances(torch.as_tensor(locs, device=dev))
    params32 = MaternParams(*(x.float() for x in params))
    z32 = z.float()
    tried = []
    for nugget in EXACT_F32_NUGGETS:
        dists32 = dists.float()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times = {}
        t0 = time.perf_counter()
        res = dist_exact_loglik(
            dists32, z32, params32, nugget=nugget, panel=TILE, times=times
        )
        ll = float(res.loglik)
        total_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        instances = ops.instance_counts()
        peak = torch.cuda.max_memory_allocated()
        dtype = str(res.loglik.dtype).split(".")[-1]
        del res, dists32
        tried.append({"nugget": nugget, "loglik": ll})
        if math.isfinite(ll):
            break
    st.setdefault("launches", {})["exact_f32"] = launches
    st.setdefault("instances", {})["exact_f32"] = instances
    if nugget == NUGGET:
        want, want_s = ref["loglik"], None
    else:  # the f64 exact loglik at the float32 path's nugget
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dist_exact_loglik(dists, z, params, nugget=nugget, panel=TILE)
        want = float(res.loglik)
        want_s = time.perf_counter() - t0
    del dists
    torch.cuda.empty_cache()
    rel = abs(ll - want) / abs(want)
    expect = {"syrk": nk - 1, "potrf": nk, "trsm": 2 * nk - 1}
    ok = math.isfinite(ll) and rel <= EXACT_F32_GAP and dtype == "float32"
    for name, count in expect.items():
        ok = ok and launches[name] == count
        ok = ok and instances[name] == {"dmma_f64": 0, "fma_f32": count}
    ok = ok and gen_on_kernels(st, instances, "exact_f32", "matern_corr")
    emit(
        {
            "phase": "exact_f32",
            "ok": ok,
            "n": len(locs),
            "m": m,
            "panel": TILE,
            "panel_steps": nk,
            "dtype": dtype,
            "nugget": nugget,
            "nuggets_tried": tried,
            "exact_panel_loglik_s": total_s,
            "phase_s": times,
            "loglik_f32": ll,
            "loglik_f64": want,
            "loglik_f64_s": want_s,
            "rel_gap": rel,
            "rel_gap_limit": EXACT_F32_GAP,
            "launches": launches,
            "launches_by_instance": instances,
            "launches_expected": expect,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("exact_f32", 0),
            "peak_bytes": peak,
        }
    )
    if not ok:
        raise AssertionError("the float32 exact path failed its checks")


def phase_grad(torch, st):
    """The nugget gradient of ``tlr_loglik(from_tiles=True)`` through the
    kernels: autograd's against central differences of the loglik, at a
    small size (n = 16^2, tile 64, max rank 16, TLR7, nugget 1e-3, f64);
    the Matérn kernels must refuse a parameter that requires grad."""
    from repro_torch.core import tlr as tlr_module
    from repro_torch.core.covariance import MaternParams, morton_order
    from repro_torch.core.simulate import grid_locations
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    locs = grid_locations(GRAD_N_SIDE, jitter=0.2, seed=0)
    locs = locs[morton_order(locs)]
    params = MaternParams.bivariate(**GRAD_MATERN, device=dev)
    z = np.random.default_rng(5).normal(size=2 * len(locs))
    kw = dict(tol=TOL_TLR, max_rank=GRAD_KMAX, tile_size=GRAD_TILE, locs=locs)
    kw.update(from_tiles=True, gen="kernel", device=dev)

    def loglik(nugget):
        return tlr_module.tlr_loglik(None, z, params, nugget=nugget, **kw).loglik

    f64 = dict(dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ng = torch.tensor(GRAD_NUGGET, requires_grad=True, **f64)
    ll = loglik(ng)
    (grad,) = torch.autograd.grad(ll, ng)
    g = float(grad)
    grad_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    instances = path_instances(ops, st, "grad")
    st.setdefault("launches", {})["grad"] = launches
    with torch.no_grad():
        hi = float(loglik(torch.tensor(GRAD_NUGGET + GRAD_EPS, **f64)))
        lo = float(loglik(torch.tensor(GRAD_NUGGET - GRAD_EPS, **f64)))
    fd = (hi - lo) / (2 * GRAD_EPS)
    rel = abs(g - fd) / abs(fd)
    # a Matérn parameter that requires grad is refused on the card
    a = params.a.clone().requires_grad_()
    try:
        tlr_module.tlr_loglik(
            None, z, params._replace(a=a), nugget=GRAD_NUGGET, **kw
        )
        refused = None
    except ValueError as err:
        refused = str(err)
    ok = math.isfinite(g) and rel <= GRAD_REL and refused is not None
    ok = ok and all(launches[name] > 0 for name in TLR_KERNELS)
    ok = ok and f64_only(instances)
    emit(
        {
            "phase": "grad",
            "ok": ok,
            "n": len(locs),
            "m": 2 * len(locs),
            "tile_size": GRAD_TILE,
            "max_rank": GRAD_KMAX,
            "nugget": GRAD_NUGGET,
            "loglik": float(ll.detach()),
            "grad": g,
            "finite_difference": fd,
            "eps": GRAD_EPS,
            "rel_gap": rel,
            "rel_gap_limit": GRAD_REL,
            "loglik_and_grad_s": grad_s,
            "matern_grad_refused": refused,
            "launches": launches,
            "launches_by_instance": instances,
        }
    )
    if not ok:
        raise AssertionError("the gradient through the kernels failed its checks")


def mle_config():
    """The mle phase's ``MLEConfig``, which the recover phase and its child
    reuse: the generator-direct TLR backend at the main cell's widths, all
    six parameters free, MLE_ITERS iterations."""
    from repro_torch.core.mle import MLEConfig

    return MLEConfig(
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


def phase_mle(torch, st, n_side: int):
    from repro_torch.core.covariance import MaternParams
    from repro_torch.core.mle import apply_morton, fit, initial_guess, make_objective
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
    cfg = mle_config()
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
    # the recover phase resumes this fit from a crashed child's checkpoint
    st["mle"] = dict(locs=locs, z=z, res=res, mle_s=mle_s, launches=launches)
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


def recover_child(directory: str) -> int:
    """The recover phase's child (``--recover-child DIR``): the mle phase's
    fit on the locations and z the parent wrote to DIR/data.npz, with a
    checkpoint after every iteration under DIR/ck, until the parent kills
    it."""
    import torch

    from repro_torch.core.mle import fit

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(os.path.join(directory, "data.npz")) as data:
        locs, z = data["locs"], data["z"]
    ck = os.path.join(directory, "ck")
    fit(locs, z, mle_config(), checkpoint_dir=ck, checkpoint_every=1, device="cuda")
    return 0


def _launch_diff(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in after}


def _status(res) -> dict:
    """A loglik result's status fields and its loglik, logdet and quad."""
    return dict(
        res.status.as_dict(),
        loglik=float(res.loglik),
        logdet=float(res.logdet),
        quad=float(res.quad),
    )


def crash_and_resume(torch, st, tmp: str) -> dict:
    """The recover phase's first part: a child runs the mle phase's fit
    with a checkpoint after every iteration and is killed with SIGKILL once
    LATEST names step 1; the checkpoint is checked on disk, and the same
    call here resumes it.  Returns the phase record's fields and ``ok``."""
    import signal

    from repro_torch.checkpointing import CheckpointManager, latest_step
    from repro_torch.core import mle as mle_module
    from repro_torch.kernels import ops

    mle = st["mle"]
    ref = mle["res"]
    np.savez(
        os.path.join(tmp, "data.npz"), locs=mle["locs"], z=mle["z"].cpu().numpy()
    )
    ck = os.path.join(tmp, "ck")
    cmd = [sys.executable, os.path.abspath(__file__), "--recover-child", tmp]
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "child.log"), "w") as log:
        child = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + RECOVER_CHILD_TIMEOUT
        while child.poll() is None and time.monotonic() < deadline:
            step = latest_step(ck)
            if step is not None and step >= RECOVER_KILL_STEP:
                break
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "child.log")) as log:
        child_log = log.read()[-2000:]

    # what the kill left on disk: LATEST names a complete step, every
    # step_* directory holds a manifest and an npz that load
    latest = latest_step(ck)
    steps = CheckpointManager(ck).all_steps()
    complete, manifest = [], None
    for step in steps:
        path = os.path.join(ck, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                man = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as data:
                arrays = [data[f"a{i}"] for i in range(len(man["names"]))]
            good = [list(a.shape) for a in arrays] == man["shapes"]
        except (OSError, ValueError, KeyError):
            man, good = None, False
        complete.append(step if good else None)
        if step == latest:
            manifest = man
    saved = None if latest is None else latest + 1
    ok = rc == -signal.SIGKILL and latest is not None
    ok = ok and 1 <= saved < ref.n_iters and complete == steps
    ok = ok and manifest is not None and manifest["extra"]["start_index"] == 0

    # the resume: the same call, counting the objective's evaluations
    real = mle_module.make_objective
    calls = []

    def counted_objective(*args, **kwargs):
        fn, dists = real(*args, **kwargs)

        def counted(x):
            calls.append(1)
            return fn(x)

        return counted, dists

    before = ops.launch_counts()
    mle_module.make_objective = counted_objective
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mle_module.fit(
            mle["locs"],
            mle["z"],
            mle_config(),
            checkpoint_dir=ck,
            checkpoint_every=1,
            device=torch.device("cuda"),
        )
        ll = float(res.loglik)
        resume_s = time.perf_counter() - t0
    finally:
        mle_module.make_objective = real
    ll_gap = abs(ll - float(ref.loglik)) / abs(float(ref.loglik))
    got, want = (
        torch.cat([getattr(r.params, f).reshape(-1) for f in r.params._fields])
        for r in (res, ref)
    )
    params_gap = float((got - want).abs().max() / want.abs().max())
    ok = ok and ll_gap <= RECOVER_GAP and params_gap <= RECOVER_GAP
    ok = ok and (res.n_iters, res.n_evals) == (ref.n_iters, ref.n_evals)
    ok = ok and len(calls) < ref.n_evals
    return dict(
        ok=ok,
        child_returncode=rc,
        child_s=child_s,
        child_steps_saved=saved,
        steps_on_disk=steps,
        latest_manifest_names=None if manifest is None else manifest["names"],
        child_log_tail=child_log if not ok else None,
        resume_s=resume_s,
        mle_s=mle["mle_s"],
        resumed_evals=len(calls),
        mle_n_evals=ref.n_evals,
        n_iters=res.n_iters,
        n_evals=res.n_evals,
        loglik=ll,
        mle_loglik=float(ref.loglik),
        loglik_rel_gap=ll_gap,
        params_rel_gap=params_gap,
        resume_launches=_launch_diff(before, ops.launch_counts()),
    )


def injected_faults(torch, st) -> dict:
    """The recover phase's second part: the fault injectors of
    ``repro_torch.testing`` on the mle phase's locations and z, the jitter
    ladder on duplicated locations, and serving's refusal and degraded
    mode.  Returns the phase record's fields and ``ok``."""
    from repro_torch.core.covariance import MaternParams
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.mle import apply_morton
    from repro_torch.core.recovery import jitter_escalate, sentinel_loglik
    from repro_torch.core.tlr import tlr_loglik
    from repro_torch.kernels import ops
    from repro_torch.serving.cokrige_service import (
        CokrigeServeConfig,
        ServeError,
        fit_factor,
        heal_factor,
        predict_batch,
    )
    from repro_torch.testing import corrupt_diag_tile, nan_compress_panel, zero_shard

    dev = torch.device("cuda")
    mle = st["mle"]
    truth = MaternParams.bivariate(**MATERN, device=dev)
    locs, z = apply_morton(mle["locs"], mle["z"], 2)
    dup = mle["locs"].copy()
    dup[-RECOVER_DUPS:] = dup[:RECOVER_DUPS]
    locs_d, z_d = apply_morton(dup, mle["z"], 2)
    tlr = dict(tol=TOL_TLR, max_rank=KMAX, tile_size=TILE, gen="kernel", device=dev)
    sentinel = sentinel_loglik(torch.float64)
    launches = {}
    out = {}

    def run(name, fn):
        before = ops.launch_counts()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = _launch_diff(before, ops.launch_counts())
        return result

    def single(nugget=NUGGET, at=(locs, z)):
        at_locs, at_z = at
        return tlr_loglik(
            None, at_z, truth, nugget=nugget, locs=at_locs, from_tiles=True, **tlr
        )

    clean = run("clean", lambda: _status(single()))
    with corrupt_diag_tile(tile=0, magnitude=10.0):
        diag = run("corrupt_diag_tile", lambda: _status(single()))
    after = run("clean_after", lambda: _status(single()))
    with nan_compress_panel(panel=1):
        panel = run("nan_compress_panel", lambda: _status(single()))
    with zero_shard(shard=0, n_shards=4):
        shard = run(
            "zero_shard",
            lambda: _status(
                dist_tlr_loglik(
                    None,
                    z,
                    locs=locs,
                    params=truth,
                    from_tiles=True,
                    nugget=NUGGET,
                    block_cyclic=True,
                    **tlr,
                )
            ),
        )
    ok = clean["ok"] and after == clean
    ok = ok and not diag["ok"] and diag["breakdown_count"] >= 1
    ok = ok and diag["loglik"] == sentinel
    ok = ok and not panel["ok"] and math.isfinite(panel["loglik"])
    ok = ok and panel["nonfinite_count"] + panel["breakdown_count"] >= 1
    ok = ok and not shard["ok"] and shard["min_pivot"] <= 0.0
    ok = ok and all(math.isfinite(shard[k]) for k in ("loglik", "logdet", "quad"))
    out.update(
        clean=clean,
        corrupt_diag_tile=diag,
        clean_after_equal=after == clean,
        nan_compress_panel=panel,
        zero_shard=shard,
        sentinel_loglik=sentinel,
    )

    # the jitter ladder on colliding sensors at nugget 0
    def eval_at(j):
        r = single(nugget=j, at=(locs_d, z_d))
        return r.loglik, r.status.ok & torch.isfinite(r.loglik)

    rec = run("ladder", lambda: jitter_escalate(eval_at, **RECOVER_LADDER))
    jitter = float(rec.jitter)
    dense = float(exact_loglik(locs_d, z_d, truth, nugget=jitter, device=dev).loglik)
    ladder_gap = abs(float(rec.loglik) - dense) / abs(dense)
    ok = ok and bool(rec.ok) and ladder_gap <= RECOVER_LADDER_GAP
    out["ladder"] = dict(
        ok=bool(rec.ok),
        attempts=int(rec.attempts),
        jitter=jitter,
        loglik=float(rec.loglik),
        dense_exact_loglik=dense,
        rel_gap=ladder_gap,
    )

    # serving: a broken factor is refused; degraded mode heals and serves
    serve = dict(tile_size=TILE, max_rank=KMAX, tol=TOL_TLR, gen="kernel")
    cfg = CokrigeServeConfig(nugget=NUGGET, **serve)
    rng = np.random.default_rng(RECOVER_PRED_SEED)
    pred = rng.uniform(0.05, 0.95, (RECOVER_NPRED, 2))
    with corrupt_diag_tile(tile=0, magnitude=10.0):
        factor = run(
            "fit_factor_broken", lambda: fit_factor(locs, z, truth, cfg, device=dev)
        )
    refusal = None
    try:
        predict_batch(factor, pred, cfg)
    except ServeError as err:
        refusal = err.to_dict()
    ok = ok and refusal is not None and refusal["code"] == "broken_factor"
    ok = ok and refusal["status"]["ok"] is False
    dcfg = CokrigeServeConfig(
        nugget=0.0, degraded=True, degraded_initial_jitter=1e-6, **serve
    )
    broken = run(
        "fit_factor_dup", lambda: fit_factor(locs_d, z_d, truth, dcfg, device=dev)
    )
    served = run("predict_degraded", lambda: predict_batch(broken, pred, dcfg))
    healed = run("heal_factor", lambda: heal_factor(broken, dcfg))
    want = run("predict_healed", lambda: predict_batch(healed, pred, dcfg))
    mean_gap = float((served.mean - want.mean).abs().max() / want.mean.abs().max())
    var_gap = float(
        (served.variance - want.variance).abs().max() / want.variance.abs().max()
    )
    ok = ok and bool(torch.isfinite(served.mean).all())
    ok = ok and bool((served.variance >= 0).all())
    ok = ok and mean_gap <= RECOVER_GAP and var_gap <= RECOVER_GAP
    out["serve"] = dict(
        refusal=refusal,
        dup_factor_status=broken.status.as_dict(),
        healed_status=healed.status.as_dict(),
        degraded_mean_rel_gap=mean_gap,
        degraded_variance_rel_gap=var_gap,
        n_pred=RECOVER_NPRED,
    )
    out["launches_by_step"] = launches
    out["ok"] = ok
    return out


def phase_recover(torch, st):
    """Crash-tolerant estimation and the recovery machinery on the card:
    see the module docstring, phase 9."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops

    tmp = tempfile.mkdtemp(prefix="chip_smoke_recover_")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        crash = crash_and_resume(torch, st, tmp)
        faults = injected_faults(torch, st)
        phase_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = ops.launch_counts()
    st.setdefault("launches", {})["recover"] = launches
    instances = path_instances(ops, st, "recover")
    ok = crash.pop("ok") and faults.pop("ok")
    ok = ok and all(launches[name] > 0 for name in TLR_KERNELS)
    ok = ok and f64_only(instances)
    ok = ok and gen_on_kernels(st, instances, "recover", "matern_tile")
    emit(
        {
            "phase": "recover",
            "ok": ok,
            "n": len(st["mle"]["locs"]),
            "m": 2 * len(st["mle"]["locs"]),
            "tile_size": TILE,
            "max_rank": KMAX,
            "tol": TOL_TLR,
            "nugget": NUGGET,
            "max_iters": MLE_ITERS,
            "phase_s": phase_s,
            "crash_resume": crash,
            "faults": faults,
            "launches": launches,
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("recover", 0),
        }
    )
    if not ok:
        raise AssertionError("recover path failed its checks")


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
    # the mesh phase's inputs and single-device references
    keep = ("loglik", "s", "peak_bytes", "factor_rank_total")
    st["dist_ref"] = dict(
        locs=np.asarray(locs),
        z=z.cpu().numpy(),
        records={k: {f: r.get(f) for f in keep} for k, r in records.items()},
    )

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


def mesh_rank(mesh, payload: dict) -> dict:
    """One rank of the mesh phase (started by ``spawn_ranks``): the TLR
    forms of ``payload["forms"]`` at the dist inputs, then, where the
    payload holds them, the exact form and the faults, each evaluation with
    its seconds, peak memory, launches and (TLR) the rank total of the
    factor slots it holds."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.covariance import MaternParams, pairwise_distances
    from repro_torch.core.dist_cholesky import dist_exact_loglik
    from repro_torch.core.dist_tlr import dist_tlr_loglik
    from repro_torch.core.recovery import jitter_escalate
    from repro_torch.kernels import ops
    from repro_torch.testing import corrupt_diag_tile

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    st = {"phase": "mesh"}
    record_plans(st)
    count_plain_kv(st)
    params = MaternParams.bivariate(**MATERN, device=dev)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "evaluations": {}}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kept = []
        restore = capture_factorizations(kept)
        ops.reset_launch_counts()
        times = {}
        t0 = time.perf_counter()
        try:
            res = fn(times)
            torch.cuda.synchronize()
        finally:
            restore()
        rec = {
            "s": time.perf_counter() - t0,
            "phase_s": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": ops.launch_counts(),
            "launches_by_instance": ops.instance_counts(),
        }
        if kept:
            rec["factor_rank_total_held"] = sum(k["factor_rank_total"] for k in kept)
        out["evaluations"][name] = rec
        return res, rec

    def parts(res) -> dict:
        rec = {k: float(getattr(res, k)) for k in ("loglik", "logdet", "quad")}
        return rec | {"status": res.status.as_dict()}

    def tlr(times, at, nugget=NUGGET, **kw):
        locs, z = at
        return dist_tlr_loglik(
            None, z, locs=locs, params=params, from_tiles=True, tol=TOL_TLR,
            max_rank=KMAX, tile_size=TILE, nugget=nugget, gen="kernel", device=dev,
            mesh=mesh, times=times, **kw,
        )

    base = (payload["locs"], torch.as_tensor(payload["z"], device=dev))
    for name in payload["forms"]:
        bc = name == "block_cyclic"
        res, rec = run(name, lambda times: tlr(times, base, block_cyclic=bc))
        rec.update(parts(res))
    if "exact" in payload:
        ex = payload["exact"]
        dists = pairwise_distances(torch.as_tensor(ex["locs"], device=dev))
        z = torch.as_tensor(ex["z"], device=dev)

        def exact(times):
            return dist_exact_loglik(
                dists, z, params, nugget=NUGGET, panel=TILE, mesh=mesh, times=times
            )

        res, rec = run("exact", exact)
        rec["loglik"] = float(res.loglik)
        del dists, z
    if "dup" in payload:
        with corrupt_diag_tile(tile=0, magnitude=10.0):
            res, rec = run(
                "corrupt_diag_tile", lambda times: tlr(times, base, block_cyclic=True)
            )
        rec.update(parts(res))
        dup = payload["dup"]
        at = (dup["locs"], torch.as_tensor(dup["z"], device=dev))

        def eval_at(jitter):
            r = tlr(None, at, nugget=jitter, block_cyclic=True)
            return r.loglik, r.status.ok & torch.isfinite(r.loglik)

        lad, rec = run("ladder", lambda _: jitter_escalate(eval_at, **RECOVER_LADDER))
        rec.update(
            ok=bool(lad.ok), attempts=int(lad.attempts), jitter=float(lad.jitter),
            loglik=float(lad.loglik),
        )
    out["plans"] = sorted(st.get("plans", {}).get("mesh", set()))
    out["plain_kv_calls_on_cuda"] = st.get("kv_cuda", {}).get("mesh", 0)
    return out


def _fold(counts: list) -> dict:
    """Sum launch-count dicts (of ints, or of instance dicts)."""
    total = {}
    for c in counts:
        for name, v in c.items():
            if isinstance(v, dict):
                mine = total.setdefault(name, {})
                for inst, n in v.items():
                    mine[inst] = mine.get(inst, 0) + n
            else:
                total[name] = total.get(name, 0) + v
    return total


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def _mesh_checks(ranks: list, kernels: tuple, single: dict, dense) -> list:
    """The mesh phase's gates on one spawn's ranks; adds each evaluation's
    gap and single-device figures to its record, returns the failures."""
    failed = []
    for name in ("block_cyclic", "masked"):
        if name not in ranks[0]["evaluations"]:
            continue
        want = single[name]
        held = sum(r["evaluations"][name]["factor_rank_total_held"] for r in ranks)
        if held != want["factor_rank_total"]:
            failed.append(f"{name}:rank_total")
        for r in ranks:
            rec = r["evaluations"][name]
            rec["rel_gap"] = _rel(rec["loglik"], want["loglik"])
            if not (rec["status"]["ok"] and rec["rel_gap"] <= MESH_TLR_GAP):
                failed.append(f"{name}:rank{r['rank']}")
    for r in ranks:
        ev = r["evaluations"]
        for name in ("block_cyclic", "masked", "exact"):
            if name in ev:
                ev[name]["single_device_s"] = single[name]["s"]
                ev[name]["single_device_peak_bytes"] = single[name]["peak_bytes"]
        if "exact" in ev:
            rec = ev["exact"]
            rec["rel_gap"] = _rel(rec["loglik"], single["exact"]["loglik"])
            if not rec["rel_gap"] <= MESH_EXACT_GAP:
                failed.append(f"exact:rank{r['rank']}")
        if "corrupt_diag_tile" in ev:
            rec, lad = ev["corrupt_diag_tile"], ev["ladder"]
            good = not rec["status"]["ok"] and rec["loglik"] == single["sentinel"]
            good = good and all(math.isfinite(rec[k]) for k in ("logdet", "quad"))
            lad["dense_exact_loglik"] = dense(lad["jitter"])
            lad["rel_gap"] = _rel(lad["loglik"], lad["dense_exact_loglik"])
            if not (good and lad["ok"] and lad["rel_gap"] <= RECOVER_LADDER_GAP):
                failed.append(f"faults:rank{r['rank']}")
        inst = _fold([e["launches_by_instance"] for e in ev.values()])
        r["launches_by_instance"] = inst
        good = all(sum(inst[k].values()) > 0 for k in kernels)
        good = good and f64_only(inst) and inst["matern_tile"]["general"] > 0
        if not (good and r["plain_kv_calls_on_cuda"] == 0):
            failed.append(f"kernels:rank{r['rank']}")
    return failed


def phase_mesh(torch, st):
    """The multi-device forms on a mesh of ranks on the card: see the module
    docstring, phase 12."""
    from repro_torch.core.covariance import MaternParams
    from repro_torch.core.likelihood import exact_loglik
    from repro_torch.core.mle import apply_morton
    from repro_torch.core.recovery import sentinel_loglik
    from repro_torch.launch.mesh import mesh_shape_for, spawn_ranks

    dref, eref = st["dist_ref"], st["exact_mesh_ref"]
    dev = torch.device("cuda")
    dup = dref["locs"].copy()
    dup[-RECOVER_DUPS:] = dup[:RECOVER_DUPS]
    dup_locs, dup_z = apply_morton(dup, dref["z"], 2)
    base = dict(locs=dref["locs"], z=dref["z"])
    gloo = dict(
        base,
        forms=("block_cyclic", "masked"),
        exact=dict(locs=eref["locs"], z=eref["z"]),
        dup=dict(locs=dup_locs, z=dup_z),
    )
    spawns = {
        "gloo": (MESH_WORLD, "gloo", gloo),
        "nccl": (1, "nccl", dict(base, forms=("block_cyclic",))),
    }
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs, spawn_s = {}, {}
    for key, (world, backend, payload) in spawns.items():
        t0 = time.perf_counter()
        runs[key] = spawn_ranks(
            mesh_rank, world, args=(payload,), backend=backend, device_type="cuda",
            timeout_s=MESH_TIMEOUT_S,
        )
        spawn_s[key] = time.perf_counter() - t0

    params = MaternParams.bivariate(**MATERN, device=dev)

    @functools.cache
    def dense(jitter):
        res = exact_loglik(dup_locs, dup_z, params, nugget=jitter, device=dev)
        return float(res.loglik)

    single = {
        "block_cyclic": dref["records"]["dist_block_cyclic"],
        "masked": dref["records"]["dist_masked"],
        "exact": eref,
        "sentinel": sentinel_loglik(torch.float64),
    }
    failed = []
    for key, kernels in (("gloo", MESH_KERNELS), ("nccl", TLR_KERNELS)):
        found = _mesh_checks(runs[key], kernels, single, dense)
        failed += [f"{key}:{f}" for f in found]
    ranks = [r for spawn in runs.values() for r in spawn]
    every = [e for r in ranks for e in r["evaluations"].values()]
    launches = _fold([e["launches"] for e in every])
    instances = _fold([e["launches_by_instance"] for e in every])
    st.setdefault("launches", {})["mesh"] = launches
    st.setdefault("instances", {})["mesh"] = instances
    st.setdefault("plans", {})["mesh"] = {tuple(p) for r in ranks for p in r["plans"]}
    emit(
        {
            "phase": "mesh",
            "ok": not failed,
            "failed": failed,
            "gloo": {
                "world": MESH_WORLD,
                "mesh_shape": list(mesh_shape_for(MESH_WORLD)),
                "transport": "gloo over CUDA tensors, several ranks on one device "
                "(a stand-in: NCCL refuses two ranks on one GPU)",
                "spawn_s": spawn_s["gloo"],
                "ranks": runs["gloo"],
            },
            "nccl": {"world": 1, "spawn_s": spawn_s["nccl"], "ranks": runs["nccl"]},
            "n_tlr": len(dref["locs"]),
            "n_exact": len(eref["locs"]),
            "tile_size": TILE,
            "max_rank": KMAX,
            "tol": TOL_TLR,
            "nugget": NUGGET,
            "reduced": {
                "n": {"main_cell": len(eref["locs"]), "tlr_forms": len(dref["locs"])},
                "why": "the TLR forms at the dist phase's inputs, against its "
                "single-device logliks; four ranks on one card test placement "
                "and collectives, not scaling",
            },
            "launches": launches,
            "launches_by_instance": instances,
        }
    )
    if failed:
        raise AssertionError(f"mesh forms failed their checks: {failed}")


def load_example(name: str):
    """The module of ``examples/torch/<name>.py``."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_logliks(name: str, out: dict) -> list:
    """The log-likelihoods an example's ``main`` returned, in order."""
    if name == "quickstart":
        return [out["exact_loglik"]] + [out["tlr"][k]["loglik"] for k in out["tlr"]]
    keys = ("exact_loglik", "loglik", "loglik_dense")
    return [row[k] for row in out["rows"] for k in keys]


def phase_examples(torch, st):
    """The paper's three geostat examples through their ``main``: see the
    module docstring, phase 13."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    records, ok = [], True

    def run(name, argv):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load_example(name).main(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _launch_diff(before, ops.launch_counts())

    for name in ("quickstart", "tlr_vs_exact"):
        out, seconds, launches = run(name, ["--device", "cuda"])
        cpu, cpu_s, _ = run(name, ["--device", "cpu"])
        got, want = _example_logliks(name, out), _example_logliks(name, cpu)
        gap = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        good = len(got) == len(want) and all(map(math.isfinite, got))
        good = good and gap <= EXAMPLE_CPU_GAP
        good = good and all(launches[k] > 0 for k in EXAMPLE_KERNELS[name])
        records.append(
            dict(
                example=name,
                ok=good,
                seconds=seconds,
                cpu_seconds=cpu_s,
                logliks=got,
                cpu_rel_gap=gap,
                launches=launches,
            )
        )
        ok = ok and good
    ends = {}
    for flag in ([], ["--tlr"]):
        argv = ["--device", "cuda", *flag]
        out, seconds, launches = run("bivariate_fit_predict", argv)
        ends[out["backend"]] = out
        estimates = [*out["sigma2"], out["a"], *out["nu"], out["beta"]]
        good = all(math.isfinite(float(x)) for x in estimates)
        good = good and out["loglik"] >= out["loglik_start"]
        good = good and math.isfinite(out["mspe"]) and out["mloe"] >= -ASSESS_ROUND
        needs = EXAMPLE_KERNELS["bivariate_fit_predict" + "_tlr" * bool(flag)]
        good = good and all(launches[k] > 0 for k in needs)
        records.append(
            dict(
                example="bivariate_fit_predict",
                backend=out["backend"],
                ok=good,
                seconds=seconds,
                fit_s=out["fit_s"],
                n_evals=out["n_evals"],
                loglik_start=out["loglik_start"],
                loglik=out["loglik"],
                estimates=[float(x) for x in estimates],
                mspe=out["mspe"],
                mloe=out["mloe"],
                mmom=out["mmom"],
                launches=launches,
            )
        )
        ok = ok and good
    witness = bivariate_witness(torch, ends)
    records.append(witness)
    ok = ok and witness["ok"]
    launches = ops.launch_counts()
    st.setdefault("launches", {})["examples"] = launches
    instances = path_instances(ops, st, "examples")
    ok = ok and f64_only(instances)
    ok = ok and gen_on_kernels(st, instances, "examples", "matern_corr")
    emit(
        {
            "phase": "examples",
            "ok": ok,
            "examples": records,
            "launches": launches,
            "launches_by_instance": instances,
            "plain_kv_calls_on_cuda": st.get("kv_cuda", {}).get("examples", 0),
        }
    )
    if not ok:
        raise AssertionError("examples path failed its checks")


def bivariate_witness(torch, ends: dict) -> dict:
    """A second witness for bivariate_fit_predict's fits at the script's
    size: its exact and TLR7 objectives at both fits' end points, on the
    card and on the CPU.  The card's values must equal the CPU's within
    ``EXAMPLE_CPU_GAP``, and the card's TLR7 value at the TLR fit's end must
    be the loglik that fit reported; the exact loglik beside the TLR7 one
    at each end shows what the TLR7 surface costs there."""
    ex = load_example("bivariate_fit_predict")
    values, gap = {}, 0.0
    for end, out in ends.items():
        x = torch.tensor(out["x"], dtype=torch.float64)
        row = values.setdefault(f"{end}_end", {})
        for backend in ("exact", "tlr"):
            cfg = ex.mle_config(backend, 100, 80)
            for device in ("cuda", "cpu"):
                _, obs, z_obs, *_ = ex.problem(300, 30, device)
                row[f"{backend}_{device}"] = -float(
                    ex.objective(obs, z_obs, cfg, device)(x)
                )
            card, cpu = row[f"{backend}_cuda"], row[f"{backend}_cpu"]
            gap = max(gap, abs(card - cpu) / abs(cpu))
    reported = ends["tlr"]["loglik"]
    at_end = values["tlr_end"]["tlr_cuda"]
    fit_gap = abs(at_end - reported) / abs(reported)
    return dict(
        example="bivariate_fit_predict",
        backend="witness",
        ok=gap <= EXAMPLE_CPU_GAP and fit_gap <= EXAMPLE_CPU_GAP,
        logliks=values,
        cpu_rel_gap=gap,
        tlr_fit_rel_gap=fit_gap,
        n_iters={end: out["n_iters"] for end, out in ends.items()},
    )


def record_plans(st) -> None:
    """Keep every plan the trsm and the f64 syrk pick (trsm's dtype, strip
    columns, update tile and row split; syrk's tile edge) under the phase
    that ran it, ``st["phase"]``: the wrappers look the plan functions up in
    their module at each call, so these stand in for them."""
    from repro_torch.kernels import chol_tiles

    plans = st.setdefault("plans", {})

    def recorded(name, fn, key):
        def plan(*args):
            out = fn(*args)
            plans.setdefault(st["phase"], set()).add((name, *key(args, out)))
            return out

        return plan

    def trsm_key(args, p):
        dname = str(args[4]).split(".")[-1] if len(args) > 4 else "float64"
        return (dname, p[0], p[2], p[3])

    chol_tiles.trsm_plan = recorded("trsm", chol_tiles.trsm_plan, trsm_key)
    chol_tiles.syrk_tile = recorded(
        "syrk", chol_tiles.syrk_tile, lambda args, t: (t,)
    )


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
    """Every plan of the trsm (both instances) and of the f64 syrk that a
    path ran is one that the kernels phase held against the plain version:
    each (dtype, strip width, update tile, row split) and each tile edge is
    a kernel of its own."""
    plans = st.get("plans", {})
    checked = plans.get("kernels", set())
    paths = ("main", "serve", "exact", "exact_f32", "mle", "recover", "assess")
    paths += ("dist", "mesh", "examples")
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
        raise AssertionError("a flash instance failed the device phase")
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
        "tf32x3_f32": cfg4.num_layers,
    }
    ok = ok and rec["prefill_timed_launches_by_instance"] == {
        "wgmma_bf16": cfg.num_layers,
        "tf32x3_f32": 0,
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


def record_routing(torch, records: list):
    """Wrap the MoE block that the decoder stack calls so that each call
    appends its tokens' chosen experts, (B, S, k) sorted, to ``records``
    (the router's f32 softmax and top-k recomputed on the same input, as
    ``moe_block`` computes them).  Returns a function that unwraps it."""
    from repro_torch.models import transformer

    inner = transformer.moe_block

    def wrapped(params, x, cfg, dropless=False):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ params.router, -1)
        idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
        records.append(idx.sort(dim=-1).values.reshape(*x.shape[:2], -1))
        return inner(params, x, cfg, dropless=dropless)

    transformer.moe_block = wrapped

    def restore():
        transformer.moe_block = inner

    return restore


def same_routing(torch, got: list, want: list, shape):
    """((B, S) bool: tokens whose experts agree in every MoE layer of two
    runs, all True without MoE layers; each layer's share of tokens whose
    experts differ there)."""
    agree = torch.ones(shape, dtype=torch.bool, device="cuda")
    shares = []
    for g, w in zip(got, want, strict=True):
        same = (g == w).all(dim=-1)
        shares.append(1.0 - float(same.float().mean()))
        agree &= same
    return agree, shares


def masked_gap(torch, got, want, keep) -> float:
    """rel_gap over the tokens ``keep`` marks: max |got - want| there over
    max |want|, a batch row at a time."""
    diff = 0.0
    for g, w, k in zip(got, want, keep):
        if bool(k.any()):
            diff = max(diff, float((g[k].float() - w[k].float()).abs().max()))
    return diff / max(float(w.float().abs().max()) for w in want)


def phase_lm_family(torch, st, name: str, depth: int, seed: int) -> dict:
    """One architecture of the lm_families phase (see the module note)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import forward, init_model, param_count
    from repro_torch.models.common import dtype_of
    from repro_torch.models.frontends import frontend_embeddings
    from repro_torch.serving.engine import generate, make_serve_fns

    dev = torch.device("cuda")
    full_cfg = get_arch(name)
    cfg = dataclasses.replace(full_cfg, num_layers=depth)
    n_attn = sum(cfg.layer_kind(i) in ("attn", "swa", "local") for i in range(depth))
    moe = cfg.moe
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

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

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {
        "phase": "lm_family",
        "arch": name,
        "family": cfg.family,
        "dtype": cfg.dtype,
        "num_layers_run": depth,
        "num_layers_config": full_cfg.num_layers,
        "depth_cut": depth < full_cfg.num_layers,
        "d_model": cfg.d_model,
        "head_dim": cfg.resolved_head_dim,
        "attention_layers": n_attn,
    }
    if rec["depth_cut"]:
        print(f"chip_smoke: {name} runs {depth} of its {full_cfg.num_layers} layers")
    routing_k, routing_n = [], []
    with torch.inference_mode():
        t0 = time.perf_counter()
        model = init_model(cfg, generator=gen, device=dev)
        torch.cuda.synchronize()
        rec["init_model_s"] = time.perf_counter() - t0
        rec["n_params"] = sum(p.numel() for p in model.parameters())
        rec["n_params_from_config"] = param_count(cfg)
        rec["param_bytes"] = sum(
            p.numel() * p.element_size() for p in model.parameters()
        )

        # the cacheless prefill forward through the kernel, then the naive
        # path, both dropless (the serving paths' routing)
        if cfg.frontend == "none":
            inputs = dict(tokens=tokens(LM_PREFILL))
        else:
            inputs = dict(
                embeds=frontend_embeddings(
                    cfg.frontend, gen, *LM_PREFILL, cfg.d_model, dtype_of(cfg.dtype)
                )
            )

        def prefill_fwd(impl):
            return lambda: forward(model, cfg, attn_impl=impl, dropless=True, **inputs)

        _, c_warm = counted(prefill_fwd("kernel"))
        restore = record_routing(torch, routing_k)
        try:
            (out_k, ms), c_timed = counted(lambda: timed(prefill_fwd("kernel")))
            restore()
            restore = record_routing(torch, routing_n)
            (out_n, naive_ms), c_naive = counted(lambda: timed(prefill_fwd("naive")))
        finally:
            restore()
        lk, ln = out_k.logits, out_n.logits
        agree, flips_by_layer = same_routing(torch, routing_k, routing_n, LM_PREFILL)
        rec["prefill_timed_launches_by_instance"] = c_timed.pop("flash_by_instance")
        path = f"lm_{name}"
        st.setdefault("launches", {})[path] = c_timed
        st.setdefault("instances", {})[path] = {
            "flash_attention": dict(rec["prefill_timed_launches_by_instance"])
        }
        n_tok = LM_PREFILL[0] * LM_PREFILL[1]
        rec.update(
            prefill_shape=list(LM_PREFILL),
            prefill_inputs="embeds" if cfg.frontend != "none" else "tokens",
            prefill_forward_ms=ms,
            prefill_tokens_per_sec=n_tok / (ms / 1e3),
            prefill_naive_ms=naive_ms,
            prefill_rel_gap=masked_gap(torch, lk, ln, agree),
            prefill_rel_gap_all_tokens=rel_gap(torch, lk, ln),
            moe_layers=len(routing_k),
            routing_flip_share=1.0 - float(agree.float().mean()),
            routing_flip_share_by_layer=flips_by_layer,
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
        if moe:
            rec["aux_loss"] = float(out_k.aux_loss)
            rec["aux_loss_naive"] = float(out_n.aux_loss)
        del out_k, out_n, lk, ln
        torch.cuda.empty_cache()

        # the engine: generate, then the same prefill and greedy steps timed
        prompts = tokens(LM_FAMILY_PROMPTS)
        steps = LM_FAMILY_STEPS
        gen_toks, c_gen = counted(lambda: generate(model, cfg, prompts, steps))
        prefill, serve_step = make_serve_fns(cfg, LM_FAMILY_PROMPTS[1] + steps)
        (state, _), prefill_ms = timed(lambda: prefill(model, prompts))
        step_ms, outs, routing_d = [], [], []
        restore = record_routing(torch, routing_d)
        try:
            for _ in range(steps):
                outs.append(state.last_tokens)
                routing_d.clear()
                (state, logits), ms_i = timed(lambda: serve_step(model, state))
                step_ms.append(ms_i)
            outs = torch.stack(outs, dim=1)
            seq = torch.cat([prompts, outs], dim=1)
            routing_f = []
            restore()
            restore = record_routing(torch, routing_f)
            full = forward(model, cfg, seq, attn_impl="naive", dropless=True)
        finally:
            restore()
        full = full.logits[:, -1]
        last = [r[:, -1:] for r in routing_f]
        agree_d, _ = same_routing(torch, routing_d, last, (LM_FAMILY_PROMPTS[0], 1))
        launches = st["launches"][path]
        for kname, count in c_gen.items():
            if kname in launches:
                launches[kname] += count
        by_inst = st["instances"][path]["flash_attention"]
        for inst, count in c_gen["flash_by_instance"].items():
            by_inst[inst] += count
        ms_sorted = sorted(step_ms)
        rec.update(
            engine_prompts=list(LM_FAMILY_PROMPTS),
            engine_steps=steps,
            engine_prefill_ms=prefill_ms,
            decode_ms_per_token_p50=float(np.median(ms_sorted)),
            decode_ms_per_token_max=ms_sorted[-1],
            decode_tokens_per_sec=LM_FAMILY_PROMPTS[0] * steps / (sum(step_ms) / 1e3),
            decode_rel_gap=masked_gap(
                torch, logits[:, None], full[:, None], agree_d
            ),
            decode_rel_gap_all_rows=rel_gap(torch, logits, full),
            decode_routing_flipped_rows=int((~agree_d).sum()),
            decode_finite=bool(torch.isfinite(logits).all()),
            engine_tokens_match_generate=bool(torch.equal(outs, gen_toks)),
            engine_launches=c_gen["flash_attention"],
            peak_bytes=torch.cuda.max_memory_allocated(),
        )
    del model, state, full, logits
    torch.cuda.empty_cache()

    want_inst = {"wgmma_bf16": n_attn, "tf32x3_f32": 0}
    checks = {
        "n_params": rec["n_params"] == rec["n_params_from_config"],
        "prefill_finite": rec["prefill_finite"],
        "prefill_gap": rec["prefill_rel_gap"] <= LM_BF16_GAP,
        "routing_flips": rec["routing_flip_share"]
        <= LM_ROUTING_FLIP_SHARE * rec["moe_layers"],
        "prefill_launches": rec["prefill_launches"]
        == {"warmup": n_attn, "timed": n_attn, "naive": 0},
        "prefill_instances": rec["prefill_timed_launches_by_instance"] == want_inst,
        "decode_gap": rec["decode_finite"] and rec["decode_rel_gap"] <= LM_DECODE_GAP,
        "decode_rows": rec["decode_routing_flipped_rows"] < LM_FAMILY_PROMPTS[0],
        "engine_launches": rec["engine_launches"] == 0,
        "engine_tokens": rec["engine_tokens_match_generate"],
    }
    if moe:
        aux, aux_n = rec["aux_loss"], rec["aux_loss_naive"]
        checks["aux_loss"] = (
            math.isfinite(aux) and aux > 0 and abs(aux - aux_n) <= LM_AUX_GAP * aux_n
        )
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    return rec


def phase_lm_families(torch, st):
    """The six other LM architectures in turn (LM_FAMILIES), each freed
    before the next loads; fails if one fails."""
    if not st.get("flash_ok"):
        raise AssertionError("a flash instance failed the device phase")
    failed = []
    for name, depth, seed in LM_FAMILIES:
        t0 = time.perf_counter()
        try:
            rec = phase_lm_family(torch, st, name, depth, seed)
            ok = rec["ok"]
        except Exception as exc:  # report the family, go on to the next
            traceback.print_exc()
            emit({"phase": "lm_family", "arch": name, "ok": False, "error": repr(exc)})
            ok = False
        print(f"chip_smoke: {name} {time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            failed.append(name)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"lm families failed their checks: {failed}")


def grads_gap(got, want) -> float:
    """The largest gap of any gradient leaf over that leaf's largest
    magnitude (the leaves compared on the CPU, in f32)."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def train_full_width(torch, st) -> dict:
    """qwen3-4b at full width in bf16: TRAIN_STEPS train steps with remat and
    naive attention on one repeated batch (see the module note)."""
    from repro_torch.configs import get_arch
    from repro_torch.dataio.tokens import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import init_model, param_count
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.training.train_step import TrainConfig, grads_fn, make_train_step

    dev = torch.device("cuda")
    cfg = get_arch(TRAIN_ARCH)
    tcfg = TrainConfig(
        remat=True, attn_impl="naive", optimizer=AdamWConfig(warmup_steps=1)
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, generator=gen, device=dev)
    opt = adamw_init(model)
    torch.cuda.synchronize()
    rec = {
        "phase": "train",
        "part": "full_width",
        "arch": TRAIN_ARCH,
        "dtype": cfg.dtype,
        "num_layers": cfg.num_layers,
        "remat": tcfg.remat,
        "attn_impl": tcfg.attn_impl,
        "batch": list(TRAIN_BATCH),
        "init_s": time.perf_counter() - t0,
        "n_params": sum(p.numel() for p in model.parameters()),
        "n_params_from_config": param_count(cfg),
        "state_bytes": sum(
            p.numel() * (2 * p.element_size() + 12) for p in model.parameters()
        ),
    }
    batch = SyntheticTokens(cfg.vocab_size, TRAIN_BATCH[1], TRAIN_BATCH[0], TRAIN_SEED)
    batch = batch.batch(0)
    step = make_train_step(cfg, None, tcfg)
    losses, gnorms, step_s = [], [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, _, metrics = step(model, opt, None, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    st.setdefault("launches", {})["train"] = ops.launch_counts()
    st.setdefault("instances", {})["train"] = ops.instance_counts()
    n_tok = TRAIN_BATCH[0] * TRAIN_BATCH[1]
    steady = step_s[1:]
    rec.update(
        losses=losses,
        grad_norms=gnorms,
        step_s=step_s,
        first_step_s=step_s[0],
        step_s_median=float(np.median(steady)),
        tokens_per_sec=n_tok / float(np.median(steady)),
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches=st["launches"]["train"],
        params_equal_master_bf16=all(
            torch.equal(p, master.to(p.dtype))
            for p, master in zip(model.parameters(), opt.master, strict=True)
        ),
        opt_step=int(opt.step),
    )
    # one more step in its two halves, each timed: the gradients (forward,
    # each block's recompute, backward) and the optimizer's update
    t0 = time.perf_counter()
    grads, _ = grads_fn(model, cfg, batch, tcfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(tcfg.optimizer, grads, opt, model)
    torch.cuda.synchronize()
    rec["breakdown_s"] = {"grads": t1 - t0, "update": time.perf_counter() - t1}
    del model, opt, metrics, grads
    torch.cuda.empty_cache()
    checks = {
        "n_params": rec["n_params"] == rec["n_params_from_config"],
        "finite": all(math.isfinite(x) for x in losses + gnorms),
        "loss_falls": losses[-1] < losses[0],
        "params_equal_master_bf16": rec["params_equal_master_bf16"],
        "opt_step": rec["opt_step"] == TRAIN_STEPS,
    }
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    return rec


def train_batch(cfg, seed: int) -> dict:
    """A batch of TRAIN_REDUCED_BATCH tokens (numpy, from ``seed``); stub
    embeddings in place of the tokens for the frontend archs."""
    b, s = TRAIN_REDUCED_BATCH
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    batch = dict(tokens=tokens[:, :-1], targets=tokens[:, 1:])
    if cfg.frontend != "none":
        embeds = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch = dict(embeds=embeds, targets=tokens[:, 1:])
    return batch


def train_reduced_archs(torch) -> dict:
    """Each of the ten architectures reduced in f32: one ``grads_fn`` with
    remat on the card against the same call on the CPU from the same
    weights, and remat=True against remat=False on the card."""
    import copy

    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import init_model
    from repro_torch.training.train_step import TrainConfig, grads_fn

    dev = torch.device("cuda")
    remat, plain = TrainConfig(remat=True), TrainConfig(remat=False)
    archs = {}
    for i, name in enumerate(ARCHS):
        cfg = get_arch(name).reduced()
        gen = torch.Generator().manual_seed(TRAIN_SEED + i)
        cpu_model = init_model(cfg, generator=gen, device="cpu")
        model = copy.deepcopy(cpu_model).to(dev)
        batch = train_batch(cfg, TRAIN_SEED + i)
        g_cpu, m_cpu = grads_fn(cpu_model, cfg, batch, remat)
        g_dev, m_dev = grads_fn(model, cfg, batch, remat)
        g_plain, _ = grads_fn(model, cfg, batch, plain)
        loss_cpu, loss_dev = float(m_cpu["loss"]), float(m_dev["loss"])
        archs[name] = {
            "loss_cpu": loss_cpu,
            "loss_card": loss_dev,
            "loss_rel_gap": abs(loss_dev - loss_cpu) / abs(loss_cpu),
            "grads_rel_gap_cpu": grads_gap(g_dev, g_cpu),
            "grads_rel_gap_remat": grads_gap(g_dev, g_plain),
            "grads_finite": all(bool(torch.isfinite(g).all()) for g in g_dev),
        }
        del model, g_dev, g_plain
    torch.cuda.empty_cache()
    gaps = [
        max(a["loss_rel_gap"], a["grads_rel_gap_cpu"], a["grads_rel_gap_remat"])
        for a in archs.values()
    ]
    rec = {
        "phase": "train",
        "part": "reduced_archs",
        "dtype": "float32",
        "batch": list(TRAIN_REDUCED_BATCH),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "archs": archs,
        "max_rel_gap": max(gaps),
        "ok": len(archs) == 10
        and max(gaps) <= TRAIN_F32_GAP
        and all(a["grads_finite"] for a in archs.values()),
    }
    emit(rec)
    return rec


def train_trainer(torch, tmp: str) -> dict:
    """The trainer at the reduced qwen3-4b on the card: a run crashed by its
    fault hook at TRAINER_CRASH_STEP and resumed by a fresh Trainer (other
    weights) against an uninterrupted run; then examples/torch/train_lm.py
    at its default size."""
    from repro_torch.checkpointing.checkpoint import latest_step
    from repro_torch.configs import get_arch
    from repro_torch.dataio.tokens import SyntheticTokens
    from repro_torch.models import init_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig, make_train_step
    from repro_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    cfg = get_arch(TRAIN_ARCH).reduced()
    tcfg = TrainConfig(
        remat=True,
        optimizer=AdamWConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=50),
    )
    step_fn = make_train_step(cfg, None, tcfg)
    data = SyntheticTokens(cfg.vocab_size, 16, 4, seed=4)

    def model(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_model(cfg, generator=gen, device=dev)

    def config(d):
        return TrainerConfig(
            total_steps=TRAINER_STEPS,
            checkpoint_every=TRAINER_EVERY,
            log_every=1,
            checkpoint_dir=os.path.join(tmp, d),
        )

    class Crash(RuntimeError):
        pass

    def crash(step, batch):
        if step == TRAINER_CRASH_STEP:
            raise Crash(step)

    t0 = time.perf_counter()
    crashed = Trainer(step_fn, model(0), data, config("run"), fault_hook=crash)
    try:
        crashed.run()
        raised = False
    except Crash:
        raised = True
    crashed.ckpt.wait()
    saved = latest_step(os.path.join(tmp, "run"))
    resumed = Trainer(step_fn, model(99), data, config("run"))
    out = resumed.run()
    whole = Trainer(step_fn, model(0), data, config("whole"))
    whole.run()
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    after = TRAINER_CRASH_STEP - TRAINER_CRASH_STEP % TRAINER_EVERY
    got = [m["loss"] for m in resumed.metrics_log]
    want = [m["loss"] for m in whole.metrics_log[after:]]
    state = zip(
        list(resumed.params.parameters()) + resumed.opt_state.master,
        list(whole.params.parameters()) + whole.opt_state.master,
    )
    equal = all(torch.equal(a, b) for a, b in state)
    gap = grads_gap(list(resumed.params.parameters()), list(whole.params.parameters()))

    t0 = time.perf_counter()
    ex = load_example("train_lm").main(["--ckpt-dir", os.path.join(tmp, "example")])
    example_s = time.perf_counter() - t0
    ex_losses = [m["loss"] for m in ex["log"]]
    rec = {
        "phase": "train",
        "part": "trainer",
        "arch": cfg.name,
        "crash_raised": raised,
        "checkpoint_at_crash": saved,
        "resumed_final_step": out["final_step"],
        "resumed_losses": got,
        "uninterrupted_losses": want,
        "state_equal": equal,
        "params_rel_gap": gap,
        "trainer_s": trainer_s,
        "example": {
            "device": ex["device"],
            "n_params": ex["n_params"],
            "final_step": ex["final_step"],
            "logged_losses": ex_losses,
            "seconds": example_s,
        },
    }
    checks = {
        "crash": raised and saved == after,
        "resume": out["final_step"] == TRAINER_STEPS and got == want and equal,
        "example": ex["final_step"] == 100
        and ex["device"].startswith("cuda")
        and all(math.isfinite(x) for x in ex_losses),
    }
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    return rec


def phase_train(torch, st):
    """LM training on the card (see the module note); fails if a part
    fails.  Every model of the earlier phases is freed before it runs."""
    import gc
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = [train_full_width(torch, st), train_reduced_archs(torch)]
    with tempfile.TemporaryDirectory() as tmp:
        recs.append(train_trainer(torch, tmp))
    print(f"chip_smoke: train {time.perf_counter() - t0:.1f} s", flush=True)
    failed = [r["part"] for r in recs if not r["ok"]]
    if failed:
        raise AssertionError(f"train parts failed their checks: {failed}")


def lm_mesh_samples(seq: int) -> list:
    """The token positions the mixtral prefill is held at."""
    return sorted(set(range(0, seq, LM_MESH_SAMPLE)) | {seq - 1})


def lm_mesh_setup(torch, name: str, layers: int, seed: int, dev):
    """(config cut to ``layers``, its model from ``seed`` on ``dev``, a
    (2, 4096) batch of tokens as numpy)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_arch(name), num_layers=layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = init_model(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=LM_MESH_BATCH).astype(np.int64)
    return cfg, model, tokens


def lm_mesh_tcfg():
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig

    opt = AdamWConfig(warmup_steps=1)
    return TrainConfig(remat=True, attn_impl="naive", optimizer=opt)


def lm_mesh_batches(cfg) -> list:
    from repro_torch.dataio.tokens import SyntheticTokens

    data = SyntheticTokens(
        cfg.vocab_size, LM_MESH_BATCH[1], LM_MESH_BATCH[0], LM_MESH_SEED
    )
    return [data.batch(i) for i in range(LM_MESH_STEPS)]


def lm_mesh_single(torch, ref_path: str) -> dict:
    """The lm_mesh phase's single-device references on the card: qwen3-4b's
    prefill (last-token logits, ms) and train steps (losses, seconds, peak;
    the final f32 master weights saved to ``ref_path``, each leaf's largest
    movement and magnitude), then mixtral's forward of each row alone
    (sampled logits, routing)."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step

    dev = torch.device("cuda")
    out = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, tokens = lm_mesh_setup(
        torch, LM_MESH_ARCH, LM_MESH_LAYERS, LM_MESH_SEED, dev
    )
    out["n_params"] = sum(p.numel() for p in model.parameters())
    toks = torch.as_tensor(tokens, device=dev)
    with torch.inference_mode():
        forward(model, cfg, toks, attn_impl="kernel")  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = forward(model, cfg, toks, attn_impl="kernel").logits
        stop.record()
        stop.synchronize()
        out["prefill_ms"] = start.elapsed_time(stop)
        out["last_logits"] = logits[:, -1].float().cpu().numpy()
        out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
        del logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(model)
    init = [m.to("cpu", copy=True) for m in opt.master]
    step = make_train_step(cfg, None, lm_mesh_tcfg())
    losses, gnorms, step_s = [], [], []
    for b in lm_mesh_batches(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, _, m = step(model, opt, None, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    out.update(losses=losses, grad_norms=gnorms, step_s=step_s,
               train_peak_bytes=torch.cuda.max_memory_allocated())
    # the final masters; each leaf's largest movement over the steps and
    # largest magnitude (a norm scale w, which starts at 0, as the 1 + w the
    # model applies)
    names = [n for n, _ in model.named_parameters()]
    moved, magnitude = {}, {}
    for n, m, m0 in zip(names, opt.master, init, strict=True):
        moved[n] = float((m - m0.to(dev)).abs().max())
        one = 1.0 if "norm" in n.rsplit(".", 1)[-1] else 0.0
        magnitude[n] = float((m + one).abs().max())
    out.update(param_moved=moved, param_magnitude=magnitude)
    torch.save({n: m.cpu() for n, m in zip(names, opt.master, strict=True)}, ref_path)
    del model, opt, step, init
    torch.cuda.empty_cache()

    cfg, model, tokens = lm_mesh_setup(
        torch, LM_MESH_MOE, LM_MESH_MOE_LAYERS, LM_MESH_MOE_SEED, dev
    )
    pos = lm_mesh_samples(LM_MESH_BATCH[1])
    sampled, routing = [], []
    with torch.inference_mode():
        for r in range(LM_MESH_BATCH[0]):
            rec = []
            restore = record_routing(torch, rec)
            try:
                row = torch.as_tensor(tokens[r : r + 1], device=dev)
                logits = forward(model, cfg, row, attn_impl="kernel").logits
            finally:
                restore()
            sampled.append(logits[0, pos].float().cpu().numpy())
            routing.append([x[0].cpu().numpy() for x in rec])
            del logits
    out.update(moe_sampled=sampled, moe_routing=routing)
    ops.reset_launch_counts()
    del model
    torch.cuda.empty_cache()
    return out


def lm_mesh_rank(mesh, payload: dict) -> dict:
    """One rank of the lm_mesh phase (started by ``spawn_ranks``): the
    sharded qwen3-4b prefill and train steps, the gathered master weights
    held on rank 0 against the single-device ones, then the sharded mixtral
    prefill; each with its times, peak memory and (prefill) launches, and
    the time of every collective (``launch.mesh.time_collectives``: each
    synchronized on both sides, so the timed runs are a little slower)."""
    from repro_torch.launch.mesh import time_collectives

    with time_collectives() as clock:
        return _lm_mesh_rank(mesh, payload, clock)


def _lm_mesh_rank(mesh, payload: dict, clock: dict) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import all_reduce_
    from repro_torch.models import forward
    from repro_torch.models.settings import fsdp_gather
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    if payload.get("plant"):
        # the planted fault of scripts/lm_mesh.py --plant: the gradients of
        # q_norm and k_norm (applied to this rank's heads) not summed over
        # "model"
        from repro_torch.training import train_step as ts

        ts.MODEL_SUMMED = ()
    rows = sh.shard_batch({"r": np.arange(LM_MESH_BATCH[0])}, mesh)["r"]
    out = {"rank": rank, "coordinate": list(mesh.get_coordinate())}
    out["rows"] = rows.tolist()

    def collectives_s():
        now = {k: clock.get(k, 0.0) for k in ("all_gather", "all_reduce", "broadcast")}
        clock.clear()
        return now

    # qwen3-4b: the prefill
    cfg, model, tokens = lm_mesh_setup(
        torch, LM_MESH_ARCH, LM_MESH_LAYERS, LM_MESH_SEED, dev
    )
    sh.shard_params(model, cfg, mesh)
    out["param_shard_elements"] = sum(p.numel() for p in model.parameters())
    local = sh.shard_batch({"t": torch.as_tensor(tokens, device=dev)}, mesh)["t"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), fsdp_gather(mesh):
        forward(model, cfg, local, attn_impl="kernel")  # warm-up
        torch.cuda.synchronize()
        collectives_s()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = forward(model, cfg, local, attn_impl="kernel").logits
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = ops.launch_counts()
        out["prefill_launches_by_instance"] = ops.instance_counts()
        out["prefill_collectives_s"] = collectives_s()
        last = sh.gather_logits(logits[:, -1:], cfg, mesh)[:, 0].float()
    want = torch.as_tensor(payload["last_logits"][rows], device=dev)
    out["prefill_rel_gap"] = rel_gap(torch, last, want)
    out["prefill_finite"] = bool(torch.isfinite(last).all())
    out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
    del logits, last
    torch.cuda.empty_cache()

    # the train steps
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(model)
    tcfg = lm_mesh_tcfg()
    step = make_train_step(cfg, mesh, tcfg)
    losses, gnorms, step_s, coll = [], [], [], []
    for b in lm_mesh_batches(cfg):
        b = sh.shard_batch(b, mesh)
        torch.cuda.synchronize()
        collectives_s()
        t0 = time.perf_counter()
        model, opt, _, m = step(model, opt, None, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        coll.append(collectives_s())
    out.update(losses=losses, grad_norms=gnorms, step_s=step_s,
               step_collectives_s=coll,
               train_peak_bytes=torch.cuda.max_memory_allocated())
    for key, got in (("loss", losses), ("grad_norm", gnorms)):
        want = payload["losses" if key == "loss" else "grad_norms"]
        out[f"{key}_rel_gaps"] = [
            abs(g - w) / abs(w) for g, w in zip(got, want, strict=True)
        ]
    # the master weights held shard by shard against the single-device
    # ones (no gather): each leaf's largest gap over its largest magnitude
    # and over its largest movement, and the shares of its elements off by
    # more than 1e-2 and 1e-1 of that movement (the gates), summed over the
    # ranks (a replicated leaf counts on each rank, in both terms)
    del step
    ref = torch.load(payload["ref_path"], mmap=True)
    names = [n for n, _ in model.named_parameters()]
    moved = payload["param_moved"]
    worst = torch.zeros(len(names), device=dev)
    counts = torch.zeros(len(names), 3, device=dev, dtype=torch.float64)
    for i, (name, master, sharding) in enumerate(
        zip(names, opt.master, sh.param_shardings(model, cfg), strict=True)
    ):
        want = sh.shard_tensor(ref[name], sharding).to(dev)
        diff = (master - want).abs()
        worst[i] = diff.max()
        counts[i, 0] = diff.numel()
        counts[i, 1] = (diff > 1e-2 * moved[name]).sum()
        counts[i, 2] = (diff > 1e-1 * moved[name]).sum()
        del want, diff
    del opt, model, ref
    torch.cuda.empty_cache()
    all_reduce_(worst, op="max", group=None)
    all_reduce_(counts, group=None)
    if rank == 0:
        mag = payload["param_magnitude"]
        worst, counts = worst.tolist(), counts.tolist()
        gaps = {n: w / mag[n] for n, w in zip(names, worst)}
        over_move = {n: w / max(moved[n], 1e-30) for n, w in zip(names, worst)}
        offs = {n: c[1] / c[0] for n, c in zip(names, counts)}
        offs_tenth = {n: c[2] / c[0] for n, c in zip(names, counts)}
        out["param_rel_gap_max"] = max(gaps.values())
        out["param_rel_gap_worst"] = max(gaps, key=gaps.get)
        out["param_off_share_max"] = max(offs.values())
        out["param_off_share_worst"] = max(offs, key=offs.get)
        out["param_off_share"] = offs
        out["param_off_tenth_share_max"] = max(offs_tenth.values())
        out["param_off_tenth_share_worst"] = max(offs_tenth, key=offs_tenth.get)
        out["param_off_tenth_share"] = offs_tenth
        out["param_gap_over_move_max"] = max(over_move.values())
        out["param_gap_over_move_worst"] = max(over_move, key=over_move.get)
        out["params_compared"] = len(gaps)

    # mixtral: the prefill, TP inside the experts
    cfg, model, tokens = lm_mesh_setup(
        torch, LM_MESH_MOE, LM_MESH_MOE_LAYERS, LM_MESH_MOE_SEED, dev
    )
    sh.shard_params(model, cfg, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    local = sh.shard_batch({"t": torch.as_tensor(tokens, device=dev)}, mesh)["t"]
    pos = lm_mesh_samples(LM_MESH_BATCH[1])
    rec = []
    restore = record_routing(torch, rec)
    try:
        with torch.inference_mode(), fsdp_gather(mesh):
            collectives_s()
            t0 = time.perf_counter()
            logits = forward(model, cfg, local, attn_impl="kernel").logits
            torch.cuda.synchronize()
            out["moe_prefill_s"] = time.perf_counter() - t0
            out["moe_prefill_collectives_s"] = collectives_s()
            sampled = sh.gather_logits(logits[:, pos], cfg, mesh)[0].float()
    finally:
        restore()
    row = int(rows[0])
    got_routing = [x[0] for x in rec]
    want_routing = [torch.as_tensor(x, device=dev) for x in payload["moe_routing"][row]]
    agree, shares = same_routing(
        torch, [g[None] for g in got_routing], [w[None] for w in want_routing],
        (1, LM_MESH_BATCH[1]),
    )
    keep = agree[0, pos]
    want = torch.as_tensor(payload["moe_sampled"][row], device=dev)
    out.update(
        moe_flip_share_by_layer=shares,
        moe_sampled_agreeing=int(keep.sum()),
        moe_rel_gap=masked_gap(torch, [sampled], [want], [keep]),
        moe_rel_gap_all_sampled=rel_gap(torch, [sampled], [want]),
        moe_finite=bool(torch.isfinite(sampled).all()),
        moe_peak_bytes=torch.cuda.max_memory_allocated(),
    )
    return out


def phase_lm_mesh(torch, st, plant: bool = False):
    """The LM multi-device forms on a mesh of ranks on the card: see the
    module docstring, phase 17.  ``plant``: with scripts/lm_mesh.py's
    planted fault in the ranks."""
    import gc
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_ranks

    if not st.get("flash_ok"):
        raise AssertionError("a flash instance failed the device phase")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "single_device_params.pt")
        t0 = time.perf_counter()
        single = lm_mesh_single(torch, ref_path)
        single_s = time.perf_counter() - t0
        keys = (
            "last_logits", "losses", "grad_norms", "moe_sampled", "moe_routing",
            "param_moved", "param_magnitude",
        )
        payload = {k: single[k] for k in keys}
        payload.update(ref_path=ref_path, plant=plant)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(
            lm_mesh_rank, LM_MESH_WORLD, args=(payload,), backend="gloo",
            device_type="cuda", timeout_s=LM_MESH_TIMEOUT_S,
            mesh_shape=LM_MESH_SHAPE,
        )
        spawn_s = time.perf_counter() - t0
    launches = _fold([r["prefill_launches"] for r in ranks])
    instances = _fold([r["prefill_launches_by_instance"] for r in ranks])
    st.setdefault("launches", {})["lm_mesh"] = launches
    st.setdefault("instances", {})["lm_mesh"] = {
        "flash_attention": instances["flash_attention"]
    }
    n_moe = LM_MESH_MOE_LAYERS
    checks = {}
    for r in ranks:
        tag = f"rank{r['rank']}"
        by_inst = r["prefill_launches_by_instance"]["flash_attention"]
        checks[f"{tag}:prefill_launches"] = by_inst == {
            "wgmma_bf16": LM_MESH_LAYERS, "tf32x3_f32": 0
        }
        checks[f"{tag}:prefill_gap"] = (
            r["prefill_finite"] and r["prefill_rel_gap"] <= LM_BF16_GAP
        )
        checks[f"{tag}:losses"] = all(
            math.isfinite(x) for x in r["losses"]
        ) and max(r["loss_rel_gaps"] + r["grad_norm_rel_gaps"]) <= LM_BF16_GAP
        checks[f"{tag}:moe_gap"] = r["moe_finite"] and r["moe_rel_gap"] <= LM_BF16_GAP
        checks[f"{tag}:moe_flips"] = (
            max(r["moe_flip_share_by_layer"]) <= LM_ROUTING_FLIP_SHARE
            and len(r["moe_flip_share_by_layer"]) == n_moe
        )
    checks["params"] = (
        ranks[0]["param_off_share_max"] <= LM_MESH_OFF_SHARE[0]
        and ranks[0]["param_off_tenth_share_max"] <= LM_MESH_OFF_SHARE[1]
    )
    failed = [k for k, v in checks.items() if not v]
    rec = {
        "phase": "lm_mesh",
        "ok": not failed,
        "planted_fault": plant,
        "failed": failed,
        "world": LM_MESH_WORLD,
        "mesh_shape": list(LM_MESH_SHAPE),
        "transport": "gloo over CUDA tensors, several ranks on one device "
        "(a stand-in: NCCL refuses two ranks on one GPU)",
        "arch": LM_MESH_ARCH,
        "layers": LM_MESH_LAYERS,
        "batch": list(LM_MESH_BATCH),
        "moe_arch": LM_MESH_MOE,
        "moe_layers": LM_MESH_MOE_LAYERS,
        "reduced": {
            "num_layers": {
                LM_MESH_ARCH: [LM_MESH_LAYERS, 36], LM_MESH_MOE: [n_moe, 32]
            },
            "why": "four ranks and the single-device references share one 80 GB "
            "card and the phase's time; on one card these forms test placement "
            "and collectives, not scaling",
        },
        "single_device": {
            k: v for k, v in single.items()
            if not isinstance(v, (list, dict, np.ndarray))
        }
        | {"losses": single["losses"], "step_s": single["step_s"]},
        "single_device_s": single_s,
        "spawn_s": spawn_s,
        "ranks": ranks,
        "launches": launches,
        "launches_by_instance": instances,
        "gates": {
            "logits_losses_grad_norms": LM_BF16_GAP,
            "flip_share": LM_ROUTING_FLIP_SHARE,
            "param_off_share_1e-2_1e-1": LM_MESH_OFF_SHARE,
        },
        "checks": checks,
        "s": time.perf_counter() - t_phase,
    }
    emit(rec)
    ops.reset_launch_counts()
    print(f"chip_smoke: lm_mesh {rec['s']:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"lm_mesh failed its checks: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--n-side",
        type=int,
        default=128,
        help="grid side: n = n_side^2 locations (default 128)",
    )
    ap.add_argument("--recover-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.recover_child is not None:
        return recover_child(args.recover_child)

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
        ("serve", lambda: phase_serve(torch, st, args.n_side)),
        ("exact", lambda: phase_exact(torch, st)),
        ("exact_f32", lambda: phase_exact_f32(torch, st)),
        ("grad", lambda: phase_grad(torch, st)),
        ("mle", lambda: phase_mle(torch, st, args.n_side)),
        ("recover", lambda: phase_recover(torch, st)),
        ("assess", lambda: phase_assess(torch, st, args.n_side)),
        ("dist", lambda: phase_dist(torch, st, args.n_side)),
        ("mesh", lambda: phase_mesh(torch, st)),
        ("examples", lambda: phase_examples(torch, st)),
        ("plans", lambda: phase_plans(st)),
        ("lm", lambda: phase_lm(torch, st)),
        ("lm_families", lambda: phase_lm_families(torch, st)),
        ("train", lambda: phase_train(torch, st)),
        ("lm_mesh", lambda: phase_lm_mesh(torch, st)),
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
            kernels[-1]["launches_by_instance_by_path"] = {
                path: counts[name]
                for path, counts in st["instances"].items()
                if name in counts
            }
        if name == "flash_attention":
            f32 = st["flash_f32"]
            kernels[-1]["f32_instance"] = {
                key: f32[key]
                for key in ("instance", "shape", *keys, "library_ms", "bound_fp32_cores_ms")
            }
        for key in ("nu", "steps", "k1_only_ms", "bound_share"):
            if key in rec:
                kernels[-1][key] = rec[key]
        extra_keys = ("case", "shape", "plan", "ms", "ms_out_acc", "plain_ms")
        extra_keys += ("library_ms", "instance", "nu", "dtype", "k1_only_ms")
        extra_keys += ("bound_by", "steps")
        extra_keys += ("bound_ms", "ms_sum", "library_ms_sum", "bound_ms_sum")
        extra_keys += ("max_abs_err", "bound_share", "ms_two_step")
        extra_keys += ("max_abs_err_vs_f64", "library_max_abs_err_vs_f64")
        extra_keys += ("bound_fp32_cores_ms",)
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
