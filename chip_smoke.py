"""Smoke run of the PyTorch port (adaprox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. device:   a CUDA device is required; prints nvidia-smi's name and power limit
  2. build:    K1 (csrc/fused_ls.cu), K3 (csrc/fused_logistic.cu), K2/K2c
               (csrc/resident_pg.cu), K4/K4b (csrc/resident_bt.cu), K4's
               aGRAAL core (csrc/resident_agraal.cu), K6d (csrc/resident_pd.cu),
               K6a/K6b/K6c (csrc/resident_dsvm_grid.cu, one kernel a core: K6a is
               the AdaPDM core's launch over one row), K7d and K7c
               (csrc/resident_cv.cu, one kernel: K7d is its launch over one dataset),
               K7a and K7b (csrc/resident_f0_grid.cu, one kernel a core: K7a is its
               launch over one dataset), K5 (csrc/fused_pd.cu), K8 (csrc/ell_matvec.cu),
               K9a and K9b (csrc/bcsr_matvec.cu), K10a-c (csrc/hbm_stream.cu; K2b is in
               csrc/resident_pg.cu), one nvcc each, started together, from this
               checkout's sources
  3. kernels:  K1 against its plain PyTorch version on the card, at the
               headline shape (16384^2, f32 and bf16 storage), the lasso
               driver's padded shape (4000x1024) and an unaligned 1000x300,
               each with its plan (ops/kernels.py::k1_plan: the rows or ring
               kernel, the grid, the slots), timed eager and with the host's
               time hidden (utils.profiling.flushed_ms, warm and cold) beside
               its bound and GB/s against the card's data sheet;
               K2 against its plain version at the padded reference size
               4096x1024 (cases a-d, f), at 1000x300 and at 64x128 (case e);
               K2c at 4096x1024 against its plain version (cases g, h) and,
               bit for bit, against single K2 launches (cases i, j);
               K3 against its plain version at the sparse_logreg datasets'
               [X] shapes (tile-padded) and at 16384^2 f32 and bf16, twice for
               the same bits; K2 with the logistic objective against its plain
               version on mushrooms' padded [X 1] (cases k-m: the rule and
               momentum bodies, f32 and bf16, padded rows) and K2c's logistic
               rows bit for bit against single K2 launches (case n); K2c's
               lockstep groups (ops/resident.py::k2c_plan) bit for bit against
               single K2 launches: ten rows at 4096x1024 in two groups, f32 and
               bf16 (case y), one mixed group with the cubic objective at 128^2
               and with the logistic one at 8128x128 (case z)
  4. driver:   the lasso driver at the reference size 4000x1000x10, with
               --fused (the main path through K1, the backtracking trials and
               aGRAAL included) and with --resident (the four rule rows in one
               K2c launch, the four backtracking rows in one K4b launch, aGRAAL
               in one launch of K4's aGRAAL core), counting each kernel's
               launches
  5. headline: AdaPGM, 200 iterations on 16384^2 f32, fused and two-matmul
  6. resident: the resident reference size (4096x1024 f32, lam 1, tol 1e-4,
               maxit 4000): one K2 solve (the single-solve path,
               resident_adapgm_l1, counted) beside the engine's AdaPGM
               --fused; K2's cost an iteration there, at 8x2176 and past the
               L2; the momentum iteration with and without records; the
               driver's four-row sweep beside four single K2 launches, and
               held against its plain version on the same inputs
  7. logreg:   LogisticLoss(fused=True) in the engine (AdaPGM, 200 iterations
               at mushrooms' X padded to 8128x128 and as loaded, 8124x112)
               beside fused=False, one K3 launch an oracle call; the sparse_logreg driver --resident on
               a5a, mushrooms and phishing at its defaults (exactly one K2c
               launch a dataset, every row's F against the ground truth, and
               the sweep held against its plain version on the driver's own
               inputs); the driver's engine path on mushrooms at --maxit 200
               (depth cut from 2000 to keep the run short); K2's logistic
               iteration
  8. cubic:    K2 with the cubic objective against its plain version (cases
               o-q: mushrooms' cubic model 113 -> 128 with c 1, the worst case
               100 -> 128 with c 0, a 2048^2 logistic Hessian; every body, the
               padded coordinates exactly 0) and K2c's cubic rows bit for bit
               against single K2 launches (case r); cubic_sparse_logreg
               --resident on a5a, mushrooms and phishing (one K2c launch a
               dataset, MM's and AdaPGM's F against the ground truth, the sweep
               held against its plain version) and nesterov_worst_case
               --resident at its defaults (one K2c launch, AdaPGM's F against
               the known optimum); both drivers' engine paths (the worst case
               at --maxit 1000, cut from 10000); the cubic iteration at 128^2
               and 2048^2. Every --resident driver run of phases 4, 7 and 8 is
               exactly one K2c, one K4b and (but the worst case's) one aGRAAL
               launch, every aGRAAL row's F within a CPU-calibrated bound, and
               the engine paths launch no whole-solve kernel
  9. backtracking: K4 against its plain version ([backtracking] lines, cases
               s-v: the padded lasso reference size 4096x1024 in f32 and bf16,
               with and without the exact-Bregman test, mushrooms' [X 1] with
               the logistic objective, the cubic models of phase 8; PG with xi
               1, 1.5 and 2 and Nesterov; trial counts and step sizes equal
               over CPU-calibrated horizons), K4b's rows bit for bit against
               single K4 launches and two launches the same bits (w), the
               large-|f| f32 lasso where the exact-Bregman test takes at least
               10x fewer iterations (x), K4's own path (one solve at the
               reference size, counted), the lasso driver's backtracking sweep
               held against its plain version and timed, and a one-trial PG and
               a Nesterov iteration at 4096x1024 and 8x2176 beside K2's; every
               K4b call timed here and in phases 7-8 also prints its plan
               (ops/resident_bt.py::k4b_plan: lockstep groups, grid, route,
               shared memory; held equal to the launcher's), its grid syncs
               (k4b_syncs of the records, held equal to the kernel's own
               count) and the microseconds a sync
 10. agraal:   K4's aGRAAL core against its plain version ([agraal] lines: the
               padded lasso 4096x1024 f32 and bf16, mushrooms' [X 1], the cubic
               models of phase 8; from the drivers' gamma0 and the secant
               gamma0; rows over CPU-calibrated horizons, the padded
               coordinates exactly 0), its own path on the lasso driver's
               inputs (one solve, counted and timed, held against its plain
               version, two launches the same bits, F within its bound) and its
               iteration at 4096x1024 and 8x2176 beside K2's
 11. pd:       K6a, K6b (csrc/resident_dsvm_grid.cu, the AdaPDM core) and K6d
               (csrc/resident_pd.cu) against their plain versions ([pd] lines) on
               the dual_svm driver's inputs: svmguide3's dense 1280^2,
               heart_scale's 384^2 (f32 and bf16) and mushrooms' factored
               8192x128 (f32 and bf16), C 0.1 and 1, rows over CPU-calibrated
               horizons, the padded coordinates exactly 0, two launches the same
               bits, K6d's plan (route, rows a CTA, shared memory;
               ops/resident_pd.py::k6d_plan) equal to its launcher's; every K6b
               row at the driver's settings (C 0.1, tol 1e-5, maxit 10000) on
               the three stand-ins, f32 and bf16, bit for bit
               against its one-row launch (a dense row also against its K6a
               launch), the 12 couplings reversed giving the rows reversed and
               the 12 twice over in one launch (24 rows, two waves at C 8) each
               row's bits twice, with each case's cluster layout (C, the
               clusters at once, the rows a CTA holds of those it owns);
               dual_svm --resident at its defaults on the three stand-ins
               x C 0.1 and 1 (exactly one K6b, one K6c and one K6d launch each,
               every row's x in [0, C] with |y'x| within its CPU-calibrated
               bound, JAX's fast_methods, the three launches timed on the
               driver's own inputs, K6d beside its times with two or three grid
               syncs an iteration); the plain versions timed on heart_scale
               C 0.1
               (K6b's cut to PD_PLAIN_CUT iterations, beside K6b there); K6a's own
               path (one solve, counted); the
               engine path at --maxit 150 on heart_scale and svmguide3, the
               Malitsky-Pock rows included (no K6 launch); the PD iteration at
               1280^2, 384^2 and 8192x128, f32 and bf16, with its layout, beside
               the cooperative kernel's (PERF.md) and K2's, and K6d's beside its
               iteration with two or three grid syncs; the phase's wall
 12. mp:       K6c (csrc/resident_dsvm_grid.cu, the Malitsky-Pock core) against
               its plain version ([mp]
               lines) on the dual_svm driver's inputs (svmguide3's dense 1280^2,
               heart_scale's 384^2 f32 and bf16, mushrooms' factored 8192x128
               f32 and bf16; C 0.1 and 1; the exact Bregman form and the raw
               one): trial counts equal and gamma, sigma, norm_res within 1e-3
               over a CPU-calibrated horizon, the objective after 300
               iterations, the padded coordinates exactly 0, two launches the
               same bits; every row of the driver's sweeps bit for bit against
               its one-row launch, and at C 0.1 on the three stand-ins in f32
               and bf16 likewise with the couplings reversed and twice over (as
               K6b's in phase 11); the large-|f| f32 instance (the exact form
               beats the raw one); the MP iteration at 1280^2, 384^2 and
               8192x128, f32 and bf16, with its mean trials and layout, beside
               the cooperative kernel's (PERF.md) and K6's PD iteration; the K6c
               sweep and its plain version timed at a cut depth; the phase's wall
 13. f0:       K7d (csrc/resident_cv.cu) and K7a (csrc/resident_f0_grid.cu, its
               Malitsky-Pock and AdaPDM+ cores) against their plain versions ([f0]
               lines) on the square-root lasso driver's padded inputs (housing_scale
               512x128, abalone 4224x128, cpusmall_scale 8192x128), h's inner norm l2
               and l1, A f32 and bf16: K7d at tol -1 and at the drivers' tol 1e-5,
               maxit 5000 (the histories, x and the final objective within
               CPU-calibrated bounds); K7a at five couplings, tol -1 (trial counts and
               ls_failed equal and the rows and x within bounds over a CPU-calibrated
               horizon, the rows within a bound while the trial counts agree, the
               objective after K7A_CUT iterations, the t = 1 row equal to
               its one-row launch, the couplings reversed giving the rows reversed bit
               for bit) and one tol 1e-5 case a core; the padded coordinates exactly 0,
               two launches the same bits; each case's cluster layout (C, the clusters
               at once, the shared memory a CTA, whether A is whole on chip);
               square_root_lasso and least_absolute_deviation --resident on the three
               stand-ins (exactly one K7d, one K7a MP and one K7a AdaPDM+ launch a
               dataset and nothing else, JAX's 31 rows and fast_methods, the Condat-Vu
               row's and every converged t-sweep row's final objective within a
               calibrated bound of an f64 CPU run, the sweeps timed with their bounds
               beside the cooperative kernel's PR 13 times, non-finite gamma/sigma/norm_res
               counted); both drivers' engine paths at
               --maxit 150 on housing_scale (31 finite rows, no K7d or K7a launch); K7d
               and K7a against their plain versions timed on the driver's
               cpusmall_scale call (K7a cut to K7A_CUT iterations), and the K7d and K7a
               iterations beside K6d's (K7a's on one cluster); the phase's wall
 14. grid:     K7b (csrc/resident_f0_grid.cu, both cores) and K7c (csrc/resident_cv.cu)
               against their plain versions ([grid] lines) at D = 3 over the stand-ins
               zero-padded to the common 8192x128, l2 and l1, A f32 and bf16: K7b at
               the couplings K7A_TS over K7A_HORIZON (trial counts and ls_failed
               equal, each cell's rows and x within K7a's bounds), K7c over K7A_CUT
               iterations (K7d's bounds); two launches the same bits; every K7b cell
               bit for bit equal to its one-row K7a launch on its dataset's slice and
               every K7c row to its K7d launch; the couplings reversed giving the cells
               reversed bit for bit; a first dataset that breaks down (an
               infinite bv entry) leaves the next one's bits as they were; both f = 0
               drivers --resident-grid at their defaults (exactly one K7c, one K7b MP
               and one K7b AdaPDM+ launch each and no other kernel; JAX's 31 rows and
               meta rows a file; the recorded calls again, every cell against its
               single launch; converged rows' final objectives within calibrated bounds
               of phase 13's f64 CPU Condat-Vu; nothing non-finite; the grids by CUDA
               events beside phase 13's --resident sweeps and the cooperative kernel's
               PR 13 times); K7b and K7c against their
               plain versions timed at K7A_CUT; the phase's wall
 15. pd_fused: K5 (csrc/fused_pd.cu) against its plain version ([pd_fused] lines) at the
               f = 0 drivers' padded A' (cpusmall_scale 16x8192, abalone 16x4224,
               housing_scale 16x512), 16384^2 and a ragged 64x1000, A' f32 and bf16,
               every prox kind (l1, box, elastic, zero), two launches the same bits; each
               shape timed eager and in a CUDA graph (the device time) beside the plain
               version, the two torch.mv it replaces and its bound; both f = 0 drivers
               --fused on the three stand-ins at --maxit 150 (cut from 5000: the 30
               t-sweep rows run on the engine): the Condat-Vu row on K5, exactly 1 + numit
               launches a solve and no other kernel, JAX's 31 rows and meta rows
               (fast_path "fused", fast_methods ["Condat-Vu"]), all finite;
               fused_condat_vu at the drivers' defaults (tol 1e-5, maxit 5000) on
               cpusmall_scale l2 and l1, its final objective within FUSED_CV_OBJ_RTOL of
               phase 13's f64 CPU Condat-Vu, timed beside the engine's condat_vu; the PD
               headline (AdaPDM, 200 iterations at 16384^2): fused f32 and bf16 A' beside
               the engine's two torch.mv, iterations/s and GB/s of A; the phase's wall
 16. sparse:   the sparse data path ([sparse] lines) on the case of
               experiments/sparse_calibration.py (8192 x 16384 f32, each (64, 512) tile
               nonzero with probability 0.1, Gaussian inside, from a seed): ELLOperator,
               BCSROperator ("pallas", "slab", "xla") and DenseOperator over it; K8
               (csrc/ell_matvec.cu), K9a and K9b (csrc/bcsr_matvec.cu) against their
               plain versions both ways (A x over A's structure; A'y over A's own tiles
               for K9a and K9b, over ELL's A' structure for K8), and K9a and K9b over A''s
               structure (the JAX formulation, which the xla route keeps), within SPARSE_RTOL of
               the largest |a||x| sum, two launches the same bits, K9b equal to K9a bit for
               bit, the "xla" route the same bits twice; each timed by CUDA events back to
               back and with the L2 flushed (a cold rate past 3350 GB/s fails) beside its
               plain version, its bound, cuSPARSE's CSR product, the BSR product at
               (64, 512) where PyTorch takes it and dense torch.mv; K8 with the operator's
               row extents against the plain padded sum, its bytes those its rows hold
               (the extents times value and column bytes, the extents, x, y), printed
               beside the padded arrays' bytes, bound and K8's cold time without
               extents (the padded k); K10a's one pass over A's tiles
               (K9's floor) and over a buffer of K8's held bytes (K8's);
               opnorm2 over ELL, BCSR and dense; then through the engine at SPARSE_MAXIT
               iterations, each solve counted alone: AdaPGM on the lasso over all five
               operators, AdaPDM on the square-root lasso over ELL, BCSR "pallas" and
               dense, AdaPGM on the logistic loss over ELL and dense (each route's kernel
               launched once a matvec, no other kernel; each sparse route's final
               objective within SPARSE_OBJ_RTOL of the dense route's, CPU-calibrated);
               the phase's wall
 17. batch:    K2b (csrc/resident_pg.cu) on bench's batched regularization path
               ([batch] lines): random_lasso(4000, 1000, 10) padded to 4096x1024 f32, 16
               lambdas geomspace(0.05, 5, 16) over one A, gamma0 1/||A||^2, at tol 0 and
               maxit 300 (bench's run) and at tol 1e-4 (maxit 4000: the instances stop
               apart), over the shared A (a zero batch stride) and over 16 materialized
               copies: every instance equal to its own K2 launch bit for bit, the shared
               run equal to the materialized one; four distinct problems (seeds 0-3, lambda
               1, 0.5, 2, 1) in f32 and bf16 storage, likewise; the plain version (the
               fixed rule over 300 iterations at K2's 1e-5, AdaPGM on the four problems
               over K2's horizon at case (a)'s 1e-3); bench's run timed beside the 16 K2
               launches, the plain version and regularization_path on the card (the
               engine), one K2b launch counted; the phase's wall
 18. stream:   K10a, K10b and K10c (csrc/hbm_stream.cu) at bench's stream_ceiling array
               ([stream] lines): |randn| / 128 at 16384^2 f32 (1 GiB, past the L2) and
               bf16, 200 passes in one launch, one launch each counted; each against its
               plain version (the sums within a relative 1e-5 of the sum, which with no
               cancellation a probe that skips 0.1% of A fails; the copy bit for bit),
               timed (CUDA events) with its GB/s, its fraction of the data sheet's
               3350 GB/s (utils.profiling.throughput_report) and its bound,
               beside 200 calls of its yardstick (torch.sum, torch.mul into an output); a
               probe past the card's rate fails; the phase's wall
Then the whole run's wall beside the run before K6 went onto clusters (861.8 s), one JSON line
describing the kernels, and
last the JSON result line.
Imports no JAX: the GPU machine has none.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# K1 vs plain: both accumulate in f32 in different orders; rounding grows like
# sqrt(n) * 6e-8 ~ 1e-5 * max at n = 16384 at worst, and 1-2e-6 was measured
# on an H100. A wrong index or a lost row gives errors of order 1.
KERNEL_RTOL = 1e-5
# |F(x) - F*| after 2000 iterations at 4000x1000x10, f32. Calibrated on the
# CPU with experiments.lasso.run_random_lasso(4000, 1000, 10, ...,
# device="cpu", dtype=torch.float32) on the padded paths (fused=True and
# resident=True gave the same gaps): PGM (fixed) 1.58e-5 (the fixed step is
# far from converged; it contracts rounding, so the card must land close);
# Nesterov (fixed) 5.4e-7, AdaPGM (MM) 6.0e-8 and (Ours) -4.2e-7, all at the
# f32 resolution of F* = 5.54 (its f32 spacing is 4.8e-7). Bounds: 2x the
# fixed gap; 1e-5, 19x the largest of the others, for the three converged
# rows. K2c's rows are held against its plain version on the driver's inputs
# in phase 6; these bounds check the driver's JSONL end to end.
# The backtracking rows, same calibration: xi 1 keeps gamma = 1/||A||^2 and
# contracts like the fixed step (2.44e-5 after 2000 iterations) until the raw
# test's noise shrinks it (on an H100 the --fused run stopped at 1799 iterations,
# 7.0e-5 above F*; --resident 1.9e-5): bound 2.5e-4, 10x the CPU's; xi 1.5
# and 2 converge (478 and 423 iterations, 6.0e-8; bound 1e-5). Nesterov
# (backtracking) is noise-limited in f32: the raw test's eps |f| noise shrinks
# gamma from iteration 704 on (13 spurious shrinks, gamma 1e-13 by 1000; f64 none,
# gap 7.6e-9), and the momentum then drifts (gap 1.0e-5 at 700, 2.8e-3 at 1000,
# 0.0232 at 2000). Where the collapse starts depends on the rounding, so its
# bound is 10x: a sanity bound. K4b itself is held against its plain version on
# the driver's inputs in phase 9.
# aGRAAL does not converge in the 2000 iterations, in f32 or f64: computed with
# resident_agraal_plain (the --resident row) and the engine's agraal under a fused
# LeastSquares (the --fused row) on the driver's padded inputs and companion point,
# both gave F - F* = 7.46e-3 in f32 (f64 6.53e-3; 0.606 at iteration 1000). The
# step-size recurrence amplifies rounding, so where the card lands depends on it:
# bound 0.02, 2.7x the CPU's f32 gap. K4 (aGRAAL) itself is held against its plain
# version in phase 10.
GAP_BOUND = {"PGM (fixed)": 3.2e-5, "PGM (backtracking)-(xi=1.0)": 2.5e-4,
             "PGM (backtracking)-(xi=1.5)": 1e-5, "PGM (backtracking)-(xi=2.0)": 1e-5,
             "Nesterov (backtracking)": 0.25, "Nesterov (fixed)": 1e-5, "AdaPGM (MM)": 1e-5,
             "AdaPGM (Ours)": 1e-5, "aGRAAL": 0.02}
HEADLINE = 16384
HEADLINE_ITERS = 200

# K2 vs its plain version, f32 on an H100 (both accumulate in f32; the kernel's
# warp dot products sum in another order than cuBLAS's gemv). Measured at the
# padded reference size, AdaPGM: the step sizes agree to the bit while the
# growth branch of the rule is active (6 iterations) and to 1.5e-4 through
# iteration 12; the curvature branch then amplifies f32 cancellation, so the
# history rows are held over 12 iterations (6.1e-5; within 1e-3 through 13).
# MM amplifies far less: its rows agreed to 3.4e-5 over all 30 iterations, so
# they are held over 30 at 3e-4. Solved to tol 1e-4 the two stop
# 18% apart (404 vs 493 iterations; bf16 storage 1313 vs 1453) at x within
# 1.0e-7 of max|x| (bf16 5.3e-7). The fixed rule does not amplify: 300
# iterations agreed to 2.1e-7.
K2_HORIZON = {"adapgm": 12, "mm": 30}
K2_CASE_A_RTOL = {"adapgm": 1e-3, "mm": 3e-4}
K2_ROW_RTOL = 1e-3
K2_NUMIT_BAND = 0.25
K2_X_RTOL = 1e-4
K2_FIXED_RTOL = 1e-5
# K2c and the momentum body against the plain version. The momentum body keeps
# the fixed step but, unlike the fixed-step PG iteration, it does not contract
# the summation-order difference: measured on an H100 at 4096x1024 f32, its rows
# agreed to 8.2e-8 over 30 iterations and stayed within 1e-5 through iteration
# 127, then grew to 2.1e-4 at 300. So case (g) holds it like the fixed rule
# (1e-5) over 30, case (h) over 120 at 1e-5 and over all 300 at 1e-3; the
# adaptive rows of the sweep keep K2's horizons. Rows of K2c and single K2
# launches are compared bit for bit.
K2C_MOMENTUM_HORIZON = 120
K2C_MOMENTUM_LONG_RTOL = 1e-3
MENU = (("PGM (fixed)", "fixed", False), ("Nesterov (fixed)", "fixed", True),
        ("AdaPGM (MM)", "mm", False), ("AdaPGM (Ours)", "adapgm", False))
# The logistic problems (the synthetic stand-ins of a5a, mushrooms and phishing)
# converge fast: run with experiments.sparse_logreg.run_logreg_l1_data(ds, ...,
# device="cpu", dtype=torch.float32, resident=True) at the defaults on the CPU,
# the ground truth stopped at 22-24 iterations and every row at 16-434, each
# row's F within 1.2e-7 of the ground truth's (the f32 spacing of F ~ 0.5 is
# 6e-8). Bound: 1e-6 for every row. The engine path at --maxit 200 on
# mushrooms (same call with resident=False): PGM (1/Lf) 2.4e-7 and Nesterov
# (fixed, 100 iterations, not converged) 1.2e-6, the others 6e-8; bounds 1e-6,
# and 2.5e-6 (2x) for Nesterov.
# The backtracking rows (maxit/2 = 1000 iterations), same runs: xi 1 stopped at
# 264-1000 iterations, 4.8e-7 to 8.3e-7 above F* (bound 2x); xi 1.5 and 2 at
# 21-43, within 6e-8 (bound 1e-6); Nesterov (backtracking) ran its 1000 (296 on
# a5a), 1.1e-4 to 2.4e-4 above, noise-limited as on the lasso (bound 10x). The
# engine path at --maxit 200 (100 backtracking iterations): xi 1 7.6e-5 (bound
# 2x), xi 1.5 and 2 0, Nesterov (backtracking) 4.3e-5 (bound 10x).
# aGRAAL (maxit 2000; the same with resident_agraal_plain and the engine's agraal in
# f32 against an f64 AdaPGM optimum): 97-115 iterations, within 6.6e-8 of F* on both
# paths and at --maxit 200 (bound 1e-6, the other rows').
LOGREG_GAP_BOUND = 1e-6
LOGREG_BT_GAP_BOUND = {"PGM (backtracking)-(xi=1.0)": 2e-6, "PGM (backtracking)-(xi=1.5)": 1e-6,
                       "PGM (backtracking)-(xi=2.0)": 1e-6, "Nesterov (backtracking)": 2.5e-3}
LOGREG_ENGINE_GAP_BOUND = {"PGM (1/Lf)": 1e-6, "PGM (backtracking)-(xi=1.0)": 1.5e-4,
                           "PGM (backtracking)-(xi=1.5)": 1e-6,
                           "PGM (backtracking)-(xi=2.0)": 1e-6, "Nesterov (backtracking)": 4.3e-4,
                           "Nesterov (fixed)": 2.5e-6, "AdaPGM (MM)": 1e-6, "AdaPGM (Ours)": 1e-6,
                           "aGRAAL": 1e-6}
LOGREG_DATASETS = ("a5a", "mushrooms", "phishing")
# K2 with the logistic objective against its plain version: the adaptive rules
# amplify the f32 summation-order difference as with least squares (case a),
# and these problems converge within ~25 iterations, after which the curvature
# ratios are rounding noise; held over 12 iterations at 1e-3, like case (a).
# Solved to tol, the kernel and the plain version stop a few iterations apart
# on runs of 16-434 iterations: numit within 10.
LOGREG_HORIZON = {"adapgm": 12, "mm": 12}
LOGREG_CASE_K_RTOL = 1e-3
LOGREG_NUMIT_SLACK = 10
LIBRARY_ITERS = 200
# LogisticLoss(fused=True) against fused=False in the engine, f32 on the card:
# the step sizes of the first iterations within case (a)'s 1e-3, and F at the
# end (converged, ~25 iterations in) within 1e-5 relative
LIBRARY_ROWS = 3
LIBRARY_F_RTOL = 1e-5
# The cubic objective (phase 8), K2 against its plain version in f32, record
# mode, tol -1 (every run takes exactly maxit iterations). Horizons calibrated
# on the CPU: resident_adapgm_plain in f32 against f64 on cubic_inputs(name,
# "cpu") held within 1e-3 (adaptive rules) or 1e-5 (fixed step, momentum):
# mushrooms' model MM through 22, AdaPGM 10, fixed 300, momentum 253 (then the
# f32 run's residual hits 0); the worst case MM 36, AdaPGM 60, fixed and
# momentum 300; 2048^2 MM 21, AdaPGM 18, fixed and momentum 300. Held over
# about two thirds of those.
CUBIC_HORIZON = {"mushrooms": {"fixed": 300, "mm": 15, "adapgm": 7, "momentum": 120},
                 "worst": {"fixed": 300, "mm": 24, "adapgm": 40, "momentum": 300},
                 "2048": {"fixed": 300, "mm": 14, "adapgm": 12, "momentum": 300}}
# cubic_sparse_logreg at its defaults (maxit 100, tol 1e-7, lam 1), run with
# run_cubic_logreg_data(ds, ..., device="cpu", dtype=torch.float32) on both
# paths: the ground truth stopped at 15-17 iterations (phishing's ran to its
# cap of 1000: tol 1e-8 is past f32), MM at 25 and AdaPGM at 13-14, each F
# within 7.5e-9 of the ground truth's (one f32 spacing of F* ~ 0.08). Bound:
# 2e-7, about 25 spacings.
# The backtracking rows there (maxit 100; same runs, and the engine path on
# mushrooms): the PG rows within 2.2e-8 (the bound 2e-7 holds them), Nesterov
# (backtracking) at its cap, 1.3e-6 to 3.4e-6 above; noise-limited, it read
# 2.66e-5 on an H100 (engine path): bound 1e-4. aGRAAL (same calibration as the
# logistic rows'): 98-100 iterations, within 1.2e-8 of the optimum on both paths
# (the bound 2e-7 holds it).
CUBIC_GAP_BOUND = 2e-7
CUBIC_NESTEROV_BT_GAP_BOUND = 1e-4
CUBIC_DATASETS = ("a5a", "mushrooms", "phishing")
# nesterov_worst_case at its defaults (k = n = 100, L = 100, tol 1e-6, maxit
# 10000), run_nesterov_worst_case(..., device="cpu", dtype=torch.float32):
# no row reaches tol in f32; at 10000 AdaPGM's F is 7.1e-7 above the known
# optimum under --resident (-2.5e-7 on the engine path; its f32 spacing is
# 9.5e-7). Bound: 1e-5. The engine path at --maxit 1000 (cut from 10000):
# PGM 0.1915, Nesterov 8.56e-5, MM 0.0484 (0.0459 through the sweep: MM
# amplifies rounding), AdaPGM 0.0567 above; bounds 1.05x the fixed step's and
# Nesterov's (they contract rounding), 1.5x the adaptive rows'.
# The backtracking rows (gamma0 = 1): under --resident f32 stops both early, once
# the raw test's noise has shrunk gamma until z = x (Backtracking PG at 3477
# iterations, 0.0224 above; Backtracking Nesterov at 395, 0.0128): bound 0.25,
# about 10x. The engine path at --maxit 1000: Backtracking PG 0.1285 (it keeps
# the step it found and contracts like the fixed step: bound 1.05x), Backtracking
# Nesterov 1.59e-3 (bound 10x).
WORST_GAP_BOUND = 1e-5
WORST_BT_GAP_BOUND = {"Backtracking PG": 0.25, "Backtracking Nesterov": 0.25}
WORST_ENGINE_MAXIT = 1000
WORST_ENGINE_GAP_BOUND = {"Fixed stepsize PGM": 0.2011, "Backtracking PG": 0.1349,
                          "Fixed Nesterov": 9e-5, "Backtracking Nesterov": 0.016,
                          "AdaPGM (MM)": 0.0726, "AdaPGM": 0.0851}
# K4 against its plain version (phase 9), f32 on the card. Calibrated on the CPU
# with resident_backtracking_plain in f32 against f64, tol -1 (no early stop),
# from gamma0 of the drivers (1/||A||^2, 1/Lf, the cubic secant step, 1/L): the
# iteration where the trial counts first differ (after which the runs part), for
# xi 1, 1.5, 2 and Nesterov: the padded lasso 4096x1024 (lam 1; the same with the
# exact-Bregman test) never in 300; mushrooms' [X 1] 175, 10, 7 and 74; mushrooms'
# cubic model 64, 11, 7 and 27; the worst case (gamma0 0.01) never in 400, never,
# 19 and 194. Before that the step sizes agree to the bit (gamma0 xi^k 0.5^j in
# the same f32 operations) and norm_res and the objective to 1.3e-6 (the lasso:
# within 1e-3 over all 300, 2.7e-4 at xi 2). So trial counts and step sizes are
# held equal, and norm_res and the objective to 1e-3 of their row's largest
# value, over about two thirds of those horizons; the worst case at xi 2 over 6,
# since on an H100 the card and the plain version first took other trial counts
# at iteration 10 there (every other case agreed over its whole horizon).
BT_HORIZON = {"lasso": {1.0: 200, 1.5: 200, 2.0: 200, "nesterov": 200},
              "logreg": {1.0: 115, 1.5: 7, 2.0: 5, "nesterov": 50},
              "mushrooms": {1.0: 42, 1.5: 7, 2.0: 5, "nesterov": 18},
              "worst": {1.0: 260, 1.5: 260, 2.0: 6, "nesterov": 130}}
BT_RTOL = 1e-3
BT_METHODS = ((1.0, False), (1.5, False), (2.0, False), (1.0, True))
# K4 (aGRAAL) against its plain version (phase 10), f32 on the card. Calibrated on
# the CPU with resident_agraal_plain in f32 against f64, tol -1, from the drivers'
# gamma0 ("given") and the secant gamma0, with the drivers' companion point
# (experiments.common.companion_point): the iteration where the step size, norm_res
# or the objective first parts by more than 1e-3 of its row's largest value, given /
# secant: the padded lasso 4096x1024 (lam 1) 62 / 46; mushrooms' [X 1] 41 / 29;
# mushrooms' cubic model 58 / 66; the worst case 42 / 51 (past 1e-5 at 17-41). The
# rows are held to 1e-3 over about two thirds of those.
AGRAAL_HORIZON = {"lasso": {"given": 40, "secant": 30}, "logreg": {"given": 27, "secant": 19},
                  "mushrooms": {"given": 38, "secant": 44}, "worst": {"given": 28, "secant": 34}}
AGRAAL_RTOL = 1e-3
# K6a, K6b and K6d against their plain versions (phase 11), f32 on the card, tol -1.
# Calibrated on the CPU with the plain versions in f32 against f64 on the dual_svm
# driver's own inputs (the three stand-ins x C 0.1 and 1; experiments.dual_svm.
# resident_inputs): the first iteration where an AdaPDM row's step size parted by
# more than 1e-3 of its row's largest value came at 39 to 180 (heart_scale C 1, t =
# 0.15, first), the residual rows at 77 or later, Condat-Vu's rows never in 300. The
# AdaPDM rows are held to 1e-3 over 25 iterations, Condat-Vu's over 300.
PD_HORIZON = {"adapdm": 25, "cv": 300}
PD_RTOL = 1e-3
PD_DATASETS = ("svmguide3", "mushrooms", "heart_scale")
# |y'x| of the driver's rows at its defaults (maxit 10000, tol 1e-5), from the same
# calibration: a converged row stops at norm_res <= tol, and norm_res >= |y'x| at the
# check, so every f32 converged row read |y'x| <= 9.9e-6 (bound 2e-5); the rows that
# run their 10000 iterations (t = 0.01 and the large t; Condat-Vu everywhere) read up
# to these largest values, f32 or f64 (svmguide3 C 1: 0.0274 in f64, 0.0024 in f32):
# bound 2x the largest.
PD_CONVERGED_YX = 2e-5
PD_YX_BOUND = {("heart_scale", 0.1): 0.018, ("heart_scale", 1.0): 0.51,
               ("svmguide3", 0.1): 0.25, ("svmguide3", 1.0): 0.055,
               ("mushrooms", 0.1): 0.19, ("mushrooms", 1.0): 4.8}
PD_ENGINE_MAXIT = 150
# the depth at which K6b's plain sweep (a host sync an iteration) is timed beside K6b
PD_PLAIN_CUT = 1000
# the cooperative kernels K6b and K6c ran before their rows went onto clusters (PERF.md
# section 6; H100 80GB HBM3, 700.00 W), printed beside this run's: the one-row iteration, us, f32,
# {shape: (PD, MP)}; the driver's sweeps, ms, {(dataset, C): (K6b, K6c)}
K6_COOPERATIVE_US = {"Q 384x384": (5.471, 6.577), "Q 1280x1280": (6.824, 8.141),
                     "B 8192x128": (18.722, 21.717)}
K6_COOPERATIVE_MS = {("heart_scale", 0.1): (395.48, 312.47), ("heart_scale", 1.0): (608.60, 301.65),
                     ("svmguide3", 0.1): (780.15, 318.59), ("svmguide3", 1.0): (788.82, 913.24),
                     ("mushrooms", 0.1): (2144.05, 2576.79), ("mushrooms", 1.0): (2182.16, 2560.90)}
# K6d's cooperative kernel before it took one grid sync an iteration (PERF.md section 6;
# H100 80GB HBM3, 700.00 W), printed beside this run's: the driver's calls, ms, {(dataset, C): ms};
# the iteration (C 0.1, tol -1, 1000 iterations), us, {shape: us}
K6D_TWO_SYNC_MS = {("heart_scale", 0.1): 40.29, ("heart_scale", 1.0): 41.50,
                   ("svmguide3", 0.1): 51.64, ("svmguide3", 1.0): 52.74,
                   ("mushrooms", 0.1): 151.02, ("mushrooms", 1.0): 146.96}
K6D_TWO_SYNC_US = {"Q 1280x1280": 5.312, "Q 384x384": 4.239, "B 8192x128": 14.823}
# the whole run's wall before K6 went onto clusters (PERF.md section 6; H100 80GB HBM3, 700.00 W),
# printed beside this run's
PREVIOUS_WALL_S = 861.8
# K6c against its plain version (phase 12), f32 on the card, tol -1. Calibrated on the
# CPU with the plain version in f32 against f64 on the dual_svm driver's inputs (the
# three stand-ins x C 0.1 and 1, the exact and the raw form, 300 iterations): the first
# iteration where a row's trial count differed, or its gamma, sigma or norm_res parted by
# more than 1e-3 of its row's largest value so far, came at 34 (mushrooms, t = 0.5) to
# 300; the trial counts first differed at 42 or later. The rows are held over 20
# iterations: trial counts equal, the rest within 1e-3. 1.49-1.54 trials an iteration.
MP_HORIZON = 20
MP_RTOL = 1e-3
MP_CUT = 300  # the depth at which the plain sweep (a host sync a trial) is held and timed
# The objective after MP_CUT iterations, same calibration: f32 parted from f64 by up to
# 3.7e-2 of its value (mushrooms C 1, t = 0.15: the trajectories have parted by then;
# bf16 Q up to 2.1e-3). Bound 2x the largest.
MP_OBJ_RTOL = 0.075
# |y'x| of the driver's Malitsky-Pock rows at its defaults (maxit 10000, tol 1e-5),
# computed with the plain version on the CPU in f32 with the exact form (the card's
# default) and in f64 with the raw form (the CPU's): the converged rows read at most
# 9.1e-6 (PD_CONVERGED_YX holds them); the others up to heart_scale 1.2e-5 / 2.8e-5 (C
# 0.1 / 1), svmguide3 1.5e-6 / 7.7e-4, mushrooms 7.8e-5 / 8.7e-3. Bound 2x the largest,
# and no tighter than the converged rows'. (The raw form in f32 converges on no row and
# leaves |y'x| up to 0.15: the stall the exact form removes.)
MP_YX_BOUND = {("heart_scale", 0.1): 2.5e-5, ("heart_scale", 1.0): 5.5e-5,
               ("svmguide3", 0.1): 2e-5, ("svmguide3", 1.0): 1.6e-3,
               ("mushrooms", 0.1): 1.6e-4, ("mushrooms", 1.0): 0.018}
# JAX's --resident meta row (adaprox_tpu/experiments/dual_svm.py): fast_methods and the
# wall_s keys
JAX_DSVM_FAST_METHODS = ["AdaPDM t-sweep (resident)", "MP t-sweep (resident)", "Condat-Vu"]
# K7d against its plain version (phase 13), f32 on the card. Calibrated on the CPU with the
# plain version in f32 against f64 on the square-root lasso driver's padded inputs (the
# three stand-ins, l2 and l1, A f32 and bf16, 5000 iterations at tol -1 and at tol 1e-5):
# the norm_res history parted from f64 by at most 1.44e-5 of its row's largest value
# (housing_scale, l1, bf16 A), the objective history by 2.8e-7, x by 6.1e-6 of max |x|,
# and the final objective by 1.15e-6 of its value. Bounds about 7-10x those: rows 1e-4,
# x 5e-5, the final objective 1e-5. In f32 the l2 residual floors near 1e-5, so at tol
# 1e-5 one side may stop and the other run on (cpusmall_scale: f32 ran 5000 iterations,
# f64 stopped at 325): the iteration counts are not compared there, the common prefix
# of the histories and the final objective are.
K7D_RTOL = 1e-4
K7D_X_RTOL = 5e-5
K7D_OBJ_RTOL = 1e-5
# K7a's bounds (phase 13: K7A_TS, K7A_HORIZON, K7A_RTOL, K7A_X_RTOL, K7A_CUT, K7A_OBJ_RTOL,
# K7A_L1_TOL, K7A_L1_TS, K7A_L1_OBJ_RTOL, K7A_DRIVER_OBJ_RTOL) are stated once, beside the
# CPU readings they were set from, in adaprox_tpu_torch/experiments/k7a_calibration.py.
# JAX's --resident meta row (adaprox_tpu/experiments/square_root_lasso.py): fast_methods and
# the wall_s keys
JAX_F0_FAST_METHODS = ["Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
F0_DATASETS = ("housing_scale", "abalone", "cpusmall_scale")
F0_DRIVERS = ("square_root_lasso", "least_absolute_deviation")
F0_ENGINE_MAXIT = 150
# the drivers' sweeps and grids by CUDA events on the cooperative kernels K7a/K7b ran before
# their cells went onto clusters (PR 13's final tree, PERF.md section 6; H100 80GB HBM3,
# 700.00 W), ms: {(driver, dataset or "grid"): (MP, AdaPDM+)}, printed beside this run's
F0_COOPERATIVE_MS = {
    ("square_root_lasso", "housing_scale"): (521.68, 516.54),
    ("square_root_lasso", "abalone"): (856.95, 621.57),
    ("square_root_lasso", "cpusmall_scale"): (1032.78, 884.83),
    ("least_absolute_deviation", "housing_scale"): (787.41, 649.56),
    ("least_absolute_deviation", "abalone"): (796.56, 626.19),
    ("least_absolute_deviation", "cpusmall_scale"): (1017.31, 761.24),
    ("square_root_lasso", "grid"): (2728.53, 2186.87),
    ("least_absolute_deviation", "grid"): (3076.13, 2288.00)}
# peak rates of one H100 SXM (data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def event_ms(fn, reps=20):
    """Mean ms per call of fn() on the card, CUDA events around reps calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    """The least time the card could take, in ms, and what sets it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


_TEMPLATE_ARG = re.compile(r"Li(-?\d+)E|f|13__nv_bfloat16")


def entry_name(mangled):
    """``kernel<args>`` from the mangled name of a kernel in an anonymous
    namespace with int, float and bf16 template arguments."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]  # past the namespace
    m = re.match(r"\d+", rest)
    if not m:
        return mangled
    end = m.end() + int(m.group(0))
    name, rest, args, pos = rest[m.end():end], rest[end:], [], 1
    while rest.startswith("I") and (t := _TEMPLATE_ARG.match(rest, pos)):
        args.append(t.group(1) or ("f32" if t.group(0) == "f" else "bf16"))
        pos = t.end()
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(log):
    """``kernel<args> registers/stack bytes/spill-store bytes`` for each entry
    function in nvcc's ``-Xptxas -v`` output."""
    out, name, stack = [], None, ("?", "?")
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name = entry_name(m.group(1))
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln):
            stack = m.groups()
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            out.append(f"{name} {m.group(1)}/{stack[0]}/{stack[1]}")
            name = None
    return out


def rows_err(got, want, horizon):
    """Largest error of the three history rows over ``horizon`` iterations,
    relative to the plain row's largest magnitude there."""
    return max(float((u[:horizon] - w[:horizon]).abs().max() / w[:horizon].abs().max())
               for u, w in zip(got[4:7], want[4:7]))


def x_err(got, want):
    return float((got[0] - want[0]).abs().max() / want[0].abs().max())


def k2_checks(resident, dev, smi):
    """Phase 3, K2: cases (a)-(f) against the plain version on the card.
    Returns (problem, measurements) for the kernels line."""
    from adaprox_tpu_torch.models.synthetic import random_lasso

    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a = torch.zeros(4096, 1024, device=dev)
    a[:4000, :1000] = torch.as_tensor(prob.a, dtype=torch.float32, device=dev)
    b = torch.zeros(4096, device=dev)
    b[:4000] = torch.as_tensor(prob.b, dtype=torch.float32, device=dev)
    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0 = torch.zeros(1024, device=dev)
    ref = dict(a=a, b=b, x0=x0, gam=gam)

    def pair(a_, b_, x0_, gam_, tol, maxit, **kw):
        got = resident.resident_adapgm(a_, b_, x0_, gam_, tol, maxit, **kw)
        want = resident.resident_adapgm_plain(a_, b_, x0_, gam_, tol, maxit, **kw)
        torch.cuda.synchronize()
        return got, want

    # (a) AdaPGM and MM, record, tol 0, maxit 30: the history rows over each
    # rule's horizon; the longest horizon within the tolerance is printed too
    for rule in ("adapgm", "mm"):
        rtol = K2_CASE_A_RTOL[rule]
        got, want = pair(a, b, x0, gam, 0.0, 30, p1=1.0, rule_kind=rule, record=True)
        err = rows_err(got, want, K2_HORIZON[rule])
        held = max((h for h in range(1, 31) if rows_err(got, want, h) <= rtol), default=0)
        print(f"[kernels] K2 (a) 4096x1024 f32 {rule} l1 tol 0 maxit 30: rows over "
              f"{K2_HORIZON[rule]} it, rel err {err:.2e} (tol {rtol:g}); within tol "
              f"through iteration {held}; over 30 {rows_err(got, want, 30):.2e} ({smi})",
              flush=True)
        check(int(got[1]) == int(want[1]) == 30 and err <= rtol, f"K2 (a) {rule} disagrees")

    # (b) the same solved to tol 1e-4; (c) with bf16 storage of A
    meas = {}
    for case, a_ in (("b", a), ("c", a.to(torch.bfloat16))):
        got, want = pair(a_, b, x0, gam, 1e-4, 4000, p1=1.0)
        nk, npl, err = int(got[1]), int(want[1]), x_err(got, want)
        print(f"[kernels] K2 ({case}) 4096x1024 {'f32' if case == 'b' else 'bf16'} AdaPGM "
              f"tol 1e-4: numit {nk} (plain {npl}, band {K2_NUMIT_BAND:g}), converged "
              f"{bool(got[3])}/{bool(want[3])}, x rel err {err:.2e} (tol {K2_X_RTOL:g})",
              flush=True)
        check(bool(got[3]) and bool(want[3]) and abs(nk - npl) <= K2_NUMIT_BAND * npl
              and err <= K2_X_RTOL, f"K2 ({case}) disagrees")
        if case == "b":
            meas = dict(max_abs_err=float((got[0] - want[0]).abs().max()), numit=nk)

    # (d) the fixed rule, tol 0, maxit 300: no amplification, a tight tolerance
    got, want = pair(a, b, x0, gam, 0.0, 300, p1=1.0, rule_kind="fixed", record=True)
    err = max(rows_err(got, want, 300), x_err(got, want))
    print(f"[kernels] K2 (d) 4096x1024 f32 fixed tol 0 maxit 300: rel err {err:.2e} "
          f"(tol {K2_FIXED_RTOL:g})", flush=True)
    check(int(got[1]) == 300 and err <= K2_FIXED_RTOL, "K2 (d) disagrees")

    # (e) unaligned 1000x300, and the other prox kinds at 64x128: three
    # iterations of the adaptive rule (both buffer parities), 30 of the fixed
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for (m, n), prox, p1, p2 in (((1000, 300), "l1", 0.1, 0.0), ((64, 128), "box", -0.1, 0.1),
                                 ((64, 128), "elastic", 0.1, 0.5), ((64, 128), "zero", 0.0, 0.0)):
        a_ = torch.randn(m, n, generator=gen, device=dev) / math.sqrt(m)
        b_ = torch.randn(m, generator=gen, device=dev)
        gam_ = 1.0 / float(torch.linalg.matrix_norm(a_.double(), 2) ** 2)
        for rule, maxit, tol in (("adapgm", 3, K2_ROW_RTOL), ("fixed", 30, K2_FIXED_RTOL)):
            got, want = pair(a_, b_, torch.zeros(n, device=dev), gam_, 0.0, maxit,
                             prox_kind=prox, p1=p1, p2=p2, rule_kind=rule, record=True)
            err = max(rows_err(got, want, maxit), x_err(got, want))
            print(f"[kernels] K2 (e) {m}x{n} {prox} {rule} maxit {maxit}: rel err {err:.2e} "
                  f"(tol {tol:g})", flush=True)
            check(int(got[1]) == maxit and err <= tol, f"K2 (e) {m}x{n} {prox} {rule} disagrees")

    # (f) two launches, the same bits
    runs = [resident.resident_adapgm(a, b, x0, gam, 1e-4, 4000, p1=1.0, record=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(u, w) for u, w in zip(*runs))
    print(f"[kernels] K2 (f) two launches give the same bits: {same}", flush=True)
    check(same, "K2 (f) is not repeatable")
    return ref, meas


def sweep_row(out, j):
    """Row j of a sweep's output, in the layout of one record-mode K2 solve."""
    return (out[0][j], out[1][j], out[2][j], out[3][j], *(h[j] for h in out[4]))


def menu_horizon(rule):
    """The horizon and tolerance a menu row's history is held over against
    the plain version: the fixed step and the momentum body over 30
    iterations at the fixed rule's tolerance, the adaptive rules as in case (a)."""
    return (30, K2_FIXED_RTOL) if rule == "fixed" else (K2_HORIZON[rule], K2_CASE_A_RTOL[rule])


def same_bits(u, w):
    """torch.equal on the bits of float32 tensors (NaN == NaN, -0 != 0)."""
    return torch.equal(u.view(torch.int32) if u.dtype == torch.float32 else u,
                       w.view(torch.int32) if w.dtype == torch.float32 else w)


def k2c_rows_are_k2(resident, a, b, x0, specs, maxit, **kw):
    """One K2c sweep of ``specs`` and whether each row is its single K2 launch bit for bit
    (x, numit, norm_res, converged, the histories, zero past the cap)."""
    out = resident.resident_rule_sweep(a, b, x0, resident.rule_rows(specs), 0.0, maxit, **kw)
    same = True
    for j, (g0, rule, mom, tol, cap) in enumerate(specs):
        one = resident.resident_adapgm(a, b, x0, g0, tol, cap, rule_kind=rule, momentum=mom,
                                       record=True, **kw)
        row = sweep_row(out, j)
        same &= all(same_bits(u, w) for u, w in zip(row[:4], one[:4]))
        same &= all(same_bits(u[:cap], w) for u, w in zip(row[4:], one[4:]))
        same &= not any(bool(u[cap:].any()) for u in row[4:])
    torch.cuda.synchronize()
    return out, same


def k2c_checks(resident, ref, smi):
    """Phase 3, K2c at the padded reference size: cases (g)-(j)."""
    a, b, x0, gam = ref["a"], ref["b"], ref["x0"], ref["gam"]

    # (g) the lasso menu's four rows, tol 0, maxit 30, against the plain sweep
    rows = resident.rule_rows([(gam, rule, mom) for _, rule, mom in MENU], tol=0.0, maxit=30)
    got = resident.resident_rule_sweep(a, b, x0, rows, 0.0, 30, p1=1.0)
    want = resident.resident_rule_sweep_plain(a, b, x0, rows, 30, p1=1.0)
    torch.cuda.synchronize()
    for j, (name, rule, _) in enumerate(MENU):
        g, w = sweep_row(got, j), sweep_row(want, j)
        horizon, rtol = menu_horizon(rule)
        err = rows_err(g, w, horizon)
        print(f"[kernels] K2c (g) 4096x1024 f32 {name} tol 0 maxit 30: rows over {horizon} it, "
              f"rel err {err:.2e} (tol {rtol:g}); x rel err {x_err(g, w):.2e} ({smi})",
              flush=True)
        check(int(g[1]) == int(w[1]) == 30 and err <= rtol, f"K2c (g) {name} disagrees")

    # (h) the momentum body alone, tol 0, maxit 300
    rows = resident.rule_rows([(gam, "fixed", True)], tol=0.0, maxit=300)
    g = sweep_row(resident.resident_rule_sweep(a, b, x0, rows, 0.0, 300, p1=1.0), 0)
    w = sweep_row(resident.resident_rule_sweep_plain(a, b, x0, rows, 300, p1=1.0), 0)
    torch.cuda.synchronize()
    err = rows_err(g, w, K2C_MOMENTUM_HORIZON)
    long_err = max(rows_err(g, w, 300), x_err(g, w))
    held = max((h for h in range(1, 301) if rows_err(g, w, h) <= K2_FIXED_RTOL), default=0)
    per_row = ", ".join(
        f"{name} {float((g[k] - w[k]).abs().max() / w[k].abs().max()):.2e}"
        for k, name in zip(range(4, 7), ("gamma", "norm_res", "objective")))
    print(f"[kernels] K2c (h) 4096x1024 f32 Nesterov (fixed) tol 0 maxit 300: rows over "
          f"{K2C_MOMENTUM_HORIZON} it, rel err {err:.2e} (tol {K2_FIXED_RTOL:g}); within tol "
          f"through iteration {held}; over 300 {long_err:.2e} (tol {K2C_MOMENTUM_LONG_RTOL:g}: "
          f"{per_row}, x {x_err(g, w):.2e}) ({smi})", flush=True)
    check(int(g[1]) == 300 and err <= K2_FIXED_RTOL and long_err <= K2C_MOMENTUM_LONG_RTOL,
          "K2c (h) disagrees")

    # (i) every row equals the single K2 launch with its arguments, bit for bit:
    # the menu solved to tol 1e-4 and a row capped at 100, in f32 and bf16 storage
    specs = [(gam, rule, mom, 1e-4, 4000) for _, rule, mom in MENU]
    specs.append((gam, "adapgm", False, 0.0, 100))
    for a_ in (a, a.to(torch.bfloat16)):
        out, same = k2c_rows_are_k2(resident, a_, b, x0, specs, 4000, p1=1.0)
        print(f"[kernels] K2c (i) 4096x1024 {str(a_.dtype)[6:]}: numit {out[1].tolist()}, "
              f"every row the same bits as its single K2 launch: {same}", flush=True)
        check(same, "K2c (i): a sweep row differs from its single K2 launch")

    # (j) two launches, the same bits
    runs = [resident.resident_rule_sweep(a, b, x0, resident.rule_rows(specs), 0.0, 4000, p1=1.0)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(u, w) for u, w in zip(sweep_row(runs[0], slice(None)),
                                                  sweep_row(runs[1], slice(None))))
    print(f"[kernels] K2c (j) two launches give the same bits: {same}", flush=True)
    check(same, "K2c (j) is not repeatable")


def menu_checks(got, want, smi):
    """Phase 6, K2c on the inputs the lasso driver gives it (4000x1024 f32,
    lam 1, tol 1e-7, maxit 2000) against its plain version on the same
    inputs: each row's history over its horizon (the momentum row over 300
    iterations too), numit within the band, x at the end. Returns the
    largest |x| error, for the kernels line."""
    max_abs_err, ok = 0.0, True
    for j, (name, rule, mom) in enumerate(MENU):
        g, w = sweep_row(got, j), sweep_row(want, j)
        horizon, rtol = menu_horizon(rule)
        err, xe = rows_err(g, w, horizon), x_err(g, w)
        nk, npl = int(g[1]), int(w[1])
        held = max((h for h in range(1, nk + 1) if rows_err(g, w, h) <= rtol), default=0)
        long = f"; over 300 {rows_err(g, w, 300):.2e} (tol {K2C_MOMENTUM_LONG_RTOL:g})" if mom else ""
        max_abs_err = max(max_abs_err, float((g[0] - w[0]).abs().max()))
        print(f"[resident] K2c vs plain, lasso menu 4000x1024 f32 {name}: rows over {horizon} it, "
              f"rel err {err:.2e} (tol {rtol:g}){long}; within tol through iteration {held}; "
              f"numit {nk} (plain {npl}, band {K2_NUMIT_BAND:g}); x rel err {xe:.2e} "
              f"(tol {K2_X_RTOL:g}) ({smi})", flush=True)
        ok &= (err <= rtol and abs(nk - npl) <= K2_NUMIT_BAND * npl and xe <= K2_X_RTOL
               and (not mom or rows_err(g, w, 300) <= K2C_MOMENTUM_LONG_RTOL))
    check(ok, "K2c disagrees with its plain version on the lasso driver's inputs")
    return max_abs_err


def group_by_method(rows):
    """A driver's JSONL rows by method (None: the ground truth), in order."""
    by = {}
    for r in rows:
        if "it" in r:
            by.setdefault(r.get("method"), []).append(r)
    return by


def once_ms(fn):
    """ms of one call of fn() on the card (CUDA events, no warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def logreg_inputs(name, dev):
    """The sparse_logreg driver's inputs for dataset ``name`` (its synthetic
    stand-in when the file is absent), f32 on the card: X and y as loaded
    (``x_raw``, ``y_raw``) and zero-padded to tiles, [X 1] and y padded as the
    driver pads them for K2c, the unpadded row count and gamma0 = 1/Lf."""
    from adaprox_tpu_torch.experiments.common import pad_tiles
    from adaprox_tpu_torch.experiments.sparse_logreg import lipschitz_estimate
    from adaprox_tpu_torch.utils.datasets import load_or_synthesize

    x_np, y_np, _ = load_or_synthesize(name, labels=(0.0, 1.0))
    m = x_np.shape[0]
    x = torch.as_tensor(x_np, device=dev).to(torch.float32)
    y = torch.as_tensor(y_np, device=dev).to(torch.float32)
    xp, yp = pad_tiles(x, y)
    a, b = pad_tiles(torch.cat([x, torch.ones((m, 1), device=dev)], 1), y)
    return dict(name=name, x=xp, y=yp, a=a, b=b, m_true=float(m), n_feat=x_np.shape[1],
                gam=1.0 / lipschitz_estimate(x_np), x_raw=x, y_raw=y)


def k3_checks(kernels, big, dev, smi):
    """Phase 3, K3 against its plain version: each dataset's X (tile-padded,
    f32) and 16384^2 in f32 and bf16 storage; two calls give the same bits.
    Returns the measurements by case, for the kernels line."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    for name in LOGREG_DATASETS:
        d = logreg_inputs(name, dev)
        m, n = d["x"].shape
        # logits of order 1: the features are ~30% nonzero N(0, 1)
        w = torch.randn(n, generator=gen, device=dev) / math.sqrt(0.3 * n)
        cases.append((f"{name} {m}x{n} f32", d["x"], d["y"], w))
    x_big, b_big, w_big = big
    y_big = (b_big > 0).float()
    cases += [("16384x16384 f32", x_big, y_big, w_big),
              ("16384x16384 bf16", x_big.to(torch.bfloat16), y_big, w_big)]
    bias = torch.tensor(0.1, device=dev)
    meas = {}
    for name, x, y, w in cases:
        out = kernels.fused_logistic_value_grad(x, y, w, bias)
        again = kernels.fused_logistic_value_grad(x, y, w, bias)
        want = kernels.logistic_value_grad_plain(x, y, w, bias)  # bf16: the same values upcast
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(out, again))
        err_f = abs(float(out[0] - want[0])) / abs(float(want[0]))
        g, g_p = torch.cat([out[1], out[2][None]]), torch.cat([want[1], want[2][None]])
        abs_g = float((g - g_p).abs().max())
        err_g = abs_g / float(g_p.abs().max())
        check(math.isfinite(err_f) and math.isfinite(err_g), f"K3 {name}: non-finite result")
        x_plain = x.float()  # the plain version on f32 storage, as LogisticLoss runs it
        ms_k = event_ms(lambda: kernels.fused_logistic_value_grad(x, y, w, bias))
        ms_p = event_ms(lambda: kernels.logistic_value_grad_plain(x_plain, y, w, bias))
        del x_plain
        m, n = x.shape
        # X, y, w and the bias read once, f, grad_w and grad_b written once;
        # 4 m n flops (the two transcendentals a row are not counted)
        bnd = bound(x.element_size() * m * n + 4 * (m + 2 * n + 3), 4 * m * n)
        meas[name] = dict(max_abs_err=abs_g, ms=ms_k, plain_ms=ms_p, bound=bnd)
        print(f"[kernels] K3 {name}: rel err f {err_f:.2e}, grad {err_g:.2e} (max abs "
              f"{abs_g:.2e}; tol {KERNEL_RTOL:g}); two calls the same bits: {same} | K3 "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) ({smi})",
              flush=True)
        check(err_f <= KERNEL_RTOL and err_g <= KERNEL_RTOL and same,
              f"K3 {name} disagrees with plain or is not repeatable")
    return meas


def k2_logreg_checks(resident, d, smi):
    """Phase 3, K2 and K2c with the logistic objective on mushrooms' [X 1]
    padded to 8128x128 (m_true 8124: 4 padded rows), lam 0.01, against the
    plain version on the same inputs."""
    from adaprox_tpu_torch.experiments.sparse_logreg import rule_specs

    a, b, gam = d["a"], d["b"], d["gam"]
    x0 = torch.zeros(a.shape[1], device=a.device)
    kw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=d["m_true"])

    def pair(a_, tol, maxit, **k):
        got = resident.resident_adapgm(a_, b, x0, gam, tol, maxit, **kw, **k)
        want = resident.resident_adapgm_plain(a_, b, x0, gam, tol, maxit, **kw, **k)
        torch.cuda.synchronize()
        return got, want

    # (k) AdaPGM and MM, record, tol 0, maxit 30: the rows over each rule's horizon
    for rule in ("adapgm", "mm"):
        rtol = LOGREG_CASE_K_RTOL
        got, want = pair(a, 0.0, 30, rule_kind=rule, record=True)
        err = rows_err(got, want, LOGREG_HORIZON[rule])
        held = max((h for h in range(1, 31) if rows_err(got, want, h) <= rtol), default=0)
        print(f"[kernels] K2 logreg (k) mushrooms 8128x128 f32 {rule} tol 0 maxit 30: rows over "
              f"{LOGREG_HORIZON[rule]} it, rel err {err:.2e} (tol {rtol:g}); within tol through "
              f"iteration {held}; over 30 {rows_err(got, want, 30):.2e} ({smi})", flush=True)
        check(int(got[1]) == int(want[1]) == 30 and err <= rtol, f"K2 logreg (k) {rule} disagrees")

    # (l) the fixed rule (300 iterations) and the momentum body (120), tol 0,
    # f32 and bf16 storage: no amplification, the fixed rule's tolerance
    for a_ in (a, a.to(torch.bfloat16)):
        for label, maxit, k in (("fixed", 300, dict(rule_kind="fixed")),
                                ("momentum", 120, dict(momentum=True))):
            got, want = pair(a_, 0.0, maxit, record=True, **k)
            err = max(rows_err(got, want, maxit), x_err(got, want))
            pad_zero = not bool(got[0][d["n_feat"] + 1:].any())
            print(f"[kernels] K2 logreg (l) mushrooms 8128x128 {str(a_.dtype)[6:]} {label} tol 0 "
                  f"maxit {maxit}: rel err {err:.2e} (tol {K2_FIXED_RTOL:g}); padded columns "
                  f"stay 0: {pad_zero}", flush=True)
            check(int(got[1]) == maxit and err <= K2_FIXED_RTOL and pad_zero,
                  f"K2 logreg (l) {label} disagrees")

    # (m) AdaPGM solved to the driver's tol 1e-7, f32 and bf16 storage
    for a_ in (a, a.to(torch.bfloat16)):
        got, want = pair(a_, 1e-7, 2000)
        nk, npl, err = int(got[1]), int(want[1]), x_err(got, want)
        print(f"[kernels] K2 logreg (m) mushrooms 8128x128 {str(a_.dtype)[6:]} AdaPGM tol 1e-7: "
              f"numit {nk} (plain {npl}, slack {LOGREG_NUMIT_SLACK}), converged "
              f"{bool(got[3])}/{bool(want[3])}, x rel err {err:.2e} (tol {K2_X_RTOL:g})",
              flush=True)
        check(bool(got[3]) and bool(want[3]) and abs(nk - npl) <= LOGREG_NUMIT_SLACK
              and err <= K2_X_RTOL, "K2 logreg (m) disagrees")

    # (n) the driver's five rows in one sweep, each the same bits as its single
    # K2 launch, f32 and bf16 storage
    specs = rule_specs(gam, 1e-7, 200)
    for a_ in (a, a.to(torch.bfloat16)):
        out, same = k2c_rows_are_k2(resident, a_, b, x0, specs, 2000, **kw)
        print(f"[kernels] K2c logreg (n) mushrooms 8128x128 {str(a_.dtype)[6:]}: numit "
              f"{out[1].tolist()}, every row the same bits as its single K2 launch: {same}",
              flush=True)
        check(same, "K2c logreg (n): a sweep row differs from its single K2 launch")


def k2c_lockstep_checks(resident, ref, logreg, dev, smi):
    """Phase 3, K2c's lockstep groups (cases y, z): every row of a table that spans two
    groups, and of mixed groups with the cubic and the logistic objective, is its single
    K2 launch bit for bit."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def mixed(gam, tol):
        # rule and momentum rows, a cap of 0, tol inf (no iteration), a row run to its cap
        return [(gam, "fixed", False, tol, 300), (gam, "fixed", True, tol, 400),
                (gam, "mm", False, tol, 400), (gam, "adapgm", False, tol, 400),
                (gam, "adapgm", False, tol, 0), (gam, "mm", False, math.inf, 400),
                (2 * gam, "adapgm", False, 0.0, 57), (0.5 * gam, "fixed", True, 10 * tol, 400)]

    # (y) ten rows at the padded reference size: two groups (8 + 2), f32 and bf16
    a, b, x0, gam = ref["a"], ref["b"], ref["x0"], ref["gam"]
    specs = mixed(gam, 1e-4) + [(1.5 * gam, "adapgm", False, 1e-5, 400),
                                (gam, "fixed", True, 1e-5, 250)]
    plan = resident.k2c_plan(resident.rule_rows(specs), *a.shape, 4, sms)
    for a_ in (a, a.to(torch.bfloat16)):
        out, same = k2c_rows_are_k2(resident, a_, b, x0, specs, 400, p1=1.0)
        print(f"[kernels] K2c (y) 4096x1024 {str(a_.dtype)[6:]}, 10 rows: groups "
              f"{plan['groups']}, grid syncs an iteration {plan['syncs']}, passes a row of A "
              f"{plan['row_passes']}; numit {out[1].tolist()}; every row the same bits as its "
              f"single K2 launch: {same} ({smi})", flush=True)
        check(same, "K2c (y): a row of a two-group table differs from its single K2 launch")

    # (z) one mixed group with the cubic objective (the worst case, c = 0, at 128^2) and
    # with the logistic one (mushrooms' [X 1] at 8128x128)
    h, q, c, gam_h, _ = cubic_inputs("worst", dev)
    lkw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=logreg["m_true"])
    cases = {"cubic 128x128": (h, q, mixed(gam_h, 1e-6),
                               dict(prox_kind="zero", obj_kind="cubic", cube_c=c)),
             "logreg 8128x128": (logreg["a"], logreg["b"], mixed(logreg["gam"], 1e-7), lkw)}
    for name, (a_, b_, specs, kw) in cases.items():
        x0_ = torch.zeros(a_.shape[1], device=dev)
        out, same = k2c_rows_are_k2(resident, a_, b_, x0_, specs, 400, **kw)
        print(f"[kernels] K2c (z) {name} f32, one group of {len(specs)} mixed rows: numit "
              f"{out[1].tolist()}; every row the same bits as its single K2 launch: {same} "
              f"({smi})", flush=True)
        check(same, f"K2c (z) {name}: a row of a mixed group differs from its single K2 launch")


def logreg_menu_checks(name, got, want, smi):
    """Phase 7, K2c on the inputs the sparse_logreg driver gives it against
    its plain version: each row's history over its horizon, numit within the
    slack, x at the end. Returns the largest |x| error."""
    from adaprox_tpu_torch.experiments.sparse_logreg import RESIDENT_ROWS

    max_abs_err, ok = 0.0, True
    for j, (row_name, rule, _) in enumerate(RESIDENT_ROWS):
        g, w = sweep_row(got, j), sweep_row(want, j)
        nk, npl = int(g[1]), int(w[1])
        horizon = min(30 if rule == "fixed" else LOGREG_HORIZON[rule], nk, npl)
        rtol = K2_FIXED_RTOL if rule == "fixed" else LOGREG_CASE_K_RTOL
        err, xe = rows_err(g, w, horizon), x_err(g, w)
        max_abs_err = max(max_abs_err, float((g[0] - w[0]).abs().max()))
        print(f"[logreg] K2c vs plain, {name} {row_name or '(ground truth)'}: rows over {horizon} "
              f"it, rel err {err:.2e} (tol {rtol:g}); numit {nk} (plain {npl}, slack "
              f"{LOGREG_NUMIT_SLACK}); x rel err {xe:.2e} (tol {K2_X_RTOL:g}) ({smi})", flush=True)
        ok &= err <= rtol and abs(nk - npl) <= LOGREG_NUMIT_SLACK and xe <= K2_X_RTOL
    check(ok, f"K2c disagrees with its plain version on the sparse_logreg driver's {name} inputs")
    return max_abs_err


def k4b_sync_report(a, rows, out, ms, label, cubic=False):
    """K4b's plan for a call over ``rows`` (k4b_plan, held equal to the launcher's), its grid
    syncs (k4b_syncs of the records ``out``, held equal to the count the kernel kept) and
    the microseconds a sync of its ``ms``, as a line's tail."""
    from adaprox_tpu_torch.ops import kernels, resident_bt

    m, n = a.shape
    sms = kernels._sm_count(a.device.index)
    plan = resident_bt.k4b_plan(len(rows), m, n, a.element_size(), sms)
    card = resident_bt.k4b_card_plan(len(rows), m, n, a.element_size(), sms)
    check(card == {k: plan[k] for k in resident_bt.K4B_PLAN_KEYS},
          f"K4b {label}: k4b_plan {plan} differs from the launcher's plan {card}")
    syncs = resident_bt.k4b_syncs(plan["groups"], out[1].tolist(), out[5][3].tolist(),
                                  [float(r[2]) > 0 for r in rows], cubic)
    counted = int(resident_bt.resident_bt_sweep.last_syncs)
    check(counted == syncs, f"K4b {label}: the kernel took {counted} grid syncs, k4b_syncs "
                            f"counts {syncs}")
    return (f"plan: route {plan['route']}, A held {plan['a_held']}, grid {plan['grid']}, "
            f"groups {plan['groups']}, {plan['smem_bytes']} B shared (= the launcher's); {syncs} "
            f"grid syncs (= the kernel's count), {1e3 * ms / syncs:.3f} us a sync")


def k4b_sweep_timing(a, b, rows, tol, maxit, kw, tag, label, smi):
    """K4b on a driver's own inputs (its backtracking rows, tol and maxit):
    CUDA events (best of 3) beside its plain version (one run) and its bound
    from this run's iteration and trial counts (bt_work)."""
    from adaprox_tpu_torch.ops import resident_bt
    from adaprox_tpu_torch.utils.profiling import timed

    x0 = torch.zeros(a.shape[1], device=a.device)
    secs, got = timed(lambda: resident_bt.resident_bt_sweep(a, b, x0, rows, tol, maxit, **kw),
                      reps=3)
    plain_ms, _ = once_ms(lambda: resident_bt.resident_bt_sweep_plain(a, b, x0, rows, tol, maxit,
                                                                       **kw))
    numits, trials = got[1].tolist(), [int(t) for t in got[5][3].sum(1).tolist()]
    m, n = a.shape
    bnd = bound(*bt_work(m, n, a.element_size(), kw.get("obj_kind", "ls"), numits, trials,
                         [flag > 0 for _, _, flag in rows], maxit))
    syncs = k4b_sync_report(a, rows, got, 1e3 * secs, label, kw.get("obj_kind") == "cubic")
    print(f"[{tag}] K4b sweep {label} {m}x{n} f32 (numit {numits}, trials {trials}, 1 launch): "
          f"{1e3 * secs:.4f} ms, plain {plain_ms:.2f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}); "
          f"{syncs} ({smi})", flush=True)


def logreg_phase(apt, resident, logreg, counting, dev, smi):
    """Phase 7: LogisticLoss(fused=True) in the engine, the sparse_logreg
    driver on the card (--resident on each dataset, the engine path on
    mushrooms) and K2's logistic iteration. ``counting`` is (zero_counts,
    read_counts). Returns (K3 launches of the library run, the sweeps'
    measurements by dataset)."""
    from adaprox_tpu_torch.experiments import sparse_logreg
    from adaprox_tpu_torch.experiments.common import bt_sweep_rows
    from adaprox_tpu_torch.experiments.sparse_logreg import BT_ROWS, RESIDENT_ROWS, rule_specs
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    zero_counts, read_counts = counting
    counts = {}
    # the driver's rows, in its order (the backtracking rows after PGM (1/Lf))
    row_order = [name for name, _, _ in RESIDENT_ROWS] + ["aGRAAL"]
    row_order[2:2] = [name for name, _, _ in BT_ROWS]

    # LogisticLoss(fused=True) in the engine: AdaPGM on mushrooms' X, padded
    # to 8128x128 and as loaded (8124x112: fused=True takes K3 at any shape),
    # the bias folded into w, one K3 launch an oracle call, beside fused=False
    # on the same inputs
    k3_calls = None
    for x, y in ((logreg["x"], logreg["y"]), (logreg["x_raw"], logreg["y_raw"])):
        shape = "x".join(map(str, x.shape))
        w0 = torch.zeros(x.shape[1] + 1, device=dev)
        lib = {}
        for fused in (True, False):
            f, g = apt.LogisticLoss(x, y, fused=fused), apt.L1Norm(0.01)

            def solve(history):
                return apt.adaptive_proxgrad(w0, f=f, g=g, rule=apt.AdaPGMRule(gamma=logreg["gam"]),
                                             tol=0.0, maxit=LIBRARY_ITERS, history=history)

            zero_counts()
            res = solve(True)
            torch.cuda.synchronize()
            counts[fused] = read_counts()
            secs, _ = timed(lambda: solve(False), reps=3)
            lib[fused] = (res, float(f.value(res.x) + g(res.x)), secs)
        (res_k3, obj_k3, secs_k3), (res_mv, obj_mv, secs_mv) = lib[True], lib[False]
        if k3_calls is None:
            k3_calls = counts[True][3]  # the padded run's, for the kernels line
        rows_rel = max(float((getattr(res_k3.records, k)[:LIBRARY_ROWS]
                              - getattr(res_mv.records, k)[:LIBRARY_ROWS]).abs().max()
                             / getattr(res_mv.records, k)[:LIBRARY_ROWS].abs().max())
                       for k in ("gamma", "norm_res", "objective"))
        obj_rel = abs(obj_k3 - obj_mv) / abs(obj_mv)
        print(f"[logreg] LogisticLoss(fused=True) AdaPGM mushrooms {shape} f32, {LIBRARY_ITERS} "
              f"iterations: K3 launches {counts[True][3]} (oracle calls {res_k3.counters.f_evals}; "
              f"fused=False {counts[False][3]}); rows over {LIBRARY_ROWS} it rel err "
              f"{rows_rel:.2e} (tol {LOGREG_CASE_K_RTOL:g}); F {obj_k3:.8f} vs {obj_mv:.8f}, rel "
              f"{obj_rel:.2e} (tol {LIBRARY_F_RTOL:g}) | {1e3 * secs_k3 / LIBRARY_ITERS:.4f} ms an "
              f"iteration fused (K3), {1e3 * secs_mv / LIBRARY_ITERS:.4f} two-matvec ({smi})",
              flush=True)
        check(counts[True][3] == res_k3.counters.f_evals == LIBRARY_ITERS + 1
              and counts[True][:3] == (0, 0, 0) and counts[True][4:] == (0, 0, 0)
              and counts[False] == (0,) * 7,
              f"LogisticLoss {shape}: K3 launches != oracle calls (or a launch without fused)")
        check(rows_rel <= LOGREG_CASE_K_RTOL and obj_rel <= LIBRARY_F_RTOL
              and bool(torch.isfinite(res_k3.x).all()), f"LogisticLoss {shape}: fused and unfused "
              "disagree")

    # the driver, --resident, at its defaults (maxit 2000, tol 1e-7, lam 0.01):
    # one K2c launch a dataset; then the same sweep on the driver's own inputs
    # held against its plain version, and timed
    logreg_sweeps = {}
    for ds in LOGREG_DATASETS:
        outdir = os.path.join("results", "chip_smoke", "sparse_logreg")
        zero_counts()
        sparse_logreg.main(["--resident", "--datasets", ds, "--device", "cuda", "--outdir", outdir,
                            "--no-plot"])
        torch.cuda.synchronize()
        c = read_counts()
        rows = read_jsonl(os.path.join(outdir, f"{ds}.jsonl"))
        by = group_by_method(rows)
        fstar = min(r["objective"] for r in by[None])
        bounds = {name: LOGREG_GAP_BOUND for name, _, _ in RESIDENT_ROWS[1:]}
        bounds.update(LOGREG_BT_GAP_BOUND, aGRAAL=LOGREG_GAP_BOUND)
        gaps = {name: by[name][-1]["objective"] - fstar for name in bounds}
        meta = [r for r in rows if "it" not in r]
        print(f"[logreg] sparse_logreg --resident {ds} f32: numit "
              f"{[rs[-1]['it'] for rs in by.values()]}, F-F* "
              f"{', '.join(f'{k} {v:.3e} (bound {bounds[k]:g})' for k, v in gaps.items())} | "
              f"K1, K2, K2c, K3, K4, K4b, aGRAAL launches {c} | {meta} ({smi})", flush=True)
        check(c == (0, 0, 1, 0, 0, 1, 1),
              f"sparse_logreg --resident {ds}: launches {c}, not one K2c, one K4b and one aGRAAL")
        check(list(by) == row_order
              and all(math.isfinite(v) and abs(v) <= bounds[k] for k, v in gaps.items()),
              f"sparse_logreg --resident {ds}: rows {list(by)}, F-F* {gaps}")
        d = logreg_inputs(ds, dev)
        a_, b_ = d["a"], d["b"]
        m_, n_ = a_.shape
        x0p = torch.zeros(n_, device=dev)
        rows_t = resident.rule_rows(rule_specs(d["gam"], 1e-7, 2000))
        kw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=d["m_true"])
        sweep_s, got = timed(lambda: resident.resident_rule_sweep(a_, b_, x0p, rows_t, 1e-7, 20000,
                                                                  **kw), reps=3)
        plain_ms, want = once_ms(lambda: resident.resident_rule_sweep_plain(
            a_, b_, x0p, rows_t, 20000, **kw))
        err = logreg_menu_checks(ds, got, want, smi)
        numits = got[1].tolist()
        # A read once, b, x0 and the rows in, x, the stats and the histories out;
        # 4 m n flops a rule iteration and warm-up, 6 m n a momentum iteration
        r = len(RESIDENT_ROWS)
        bnd = bound(4 * m_ * n_ + 4 * (m_ + n_) + 20 * r + 4 * r * n_ + 16 * r + 12 * r * 20000,
                    sum(6 * m_ * n_ * k if mom else 4 * m_ * n_ * (k + 1)
                        for (_, _, mom), k in zip(RESIDENT_ROWS, numits)))
        logreg_sweeps[ds] = dict(ms=1e3 * sweep_s, plain_ms=plain_ms, bound=bnd, err=err)
        print(f"[logreg] K2c sweep {ds} {m_}x{n_} f32 (numit {numits}): {1e3 * sweep_s:.4f} ms, "
              f"plain {plain_ms:.2f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) ({smi})", flush=True)
        # the driver's backtracking rows (maxit/2), the K4b sweep its --resident run launched
        k4b_sweep_timing(a_, b_, bt_sweep_rows(BT_ROWS, d["gam"]), 1e-7, 1000, kw, "logreg", ds,
                         smi)

    # the driver's engine path (LogisticLoss without the fused branch, as the
    # JAX driver runs it) on mushrooms, depth cut to --maxit 200
    zero_counts()
    outdir = os.path.join("results", "chip_smoke", "sparse_logreg_engine")
    sparse_logreg.main(["--datasets", "mushrooms", "--maxit", "200", "--device", "cuda",
                        "--outdir", outdir, "--no-plot"])
    torch.cuda.synchronize()
    c = read_counts()
    rows = read_jsonl(os.path.join(outdir, "mushrooms.jsonl"))
    by = group_by_method(rows)
    fstar = min(r["objective"] for r in by[None])
    gaps = {name: by[name][-1]["objective"] - fstar for name in LOGREG_ENGINE_GAP_BOUND}
    print(f"[logreg] sparse_logreg mushrooms --maxit 200 (engine path, depth cut from 2000) f32: "
          f"numit {[rs[-1]['it'] for rs in by.values()]}, F-F* "
          f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} | launches {c} | "
          f"wall_s {rows[-2]['wall_s']} ({smi})", flush=True)
    check(rows[-2]["fast_path"] == "default" and c == (0,) * 7 and list(by) == row_order
          and all(math.isfinite(v) and abs(v) <= LOGREG_ENGINE_GAP_BOUND[k]
                  for k, v in gaps.items()), "sparse_logreg engine path: bad rows")

    # K2's logistic iteration beside its least-squares iteration at the same
    # shape (mushrooms' [X 1], 8128x128): fixed rule, zero prox, 1000 iterations
    a_, b_ = logreg["a"], logreg["b"]
    x0_ = torch.zeros(a_.shape[1], device=dev)
    # (least squares with 1/||A||_F^2 <= 1/||A||^2, a stable step)
    for obj, gam_ in (("logreg", logreg["gam"]), ("ls", 1.0 / float((a_ * a_).sum()))):
        it_secs, it_out = timed(lambda: resident.resident_adapgm(
            a_, b_, x0_, gam_, 0.0, 1000, prox_kind="zero", rule_kind="fixed", obj_kind=obj,
            m_true=logreg["m_true"]), reps=3)
        check(int(it_out[1]) == 1000, f"K2 {obj} 8128x128: not 1000 iterations")
        print(f"[logreg] K2 {obj} 8128x128 f32, fixed rule, zero prox, 1000 iterations: "
              f"{1e3 * it_secs:.3f} us an iteration ({smi})", flush=True)

    return k3_calls, logreg_sweeps


def cubic_inputs(name, dev, dtype=torch.float32):
    """The cubic model (H, q, c, gamma0, n_true) of ``name``: a dataset of the
    cubic_sparse_logreg driver (its synthetic stand-in when the file is
    absent; H and q padded to 128 and gamma0 the secant estimate, as the
    driver makes them), "worst" (the worst case k = n = 100, L = 100 as the
    c = 0 model, padded to 128, gamma0 = 1/L) or "2048" (the logistic Hessian
    at 0 of 4096 sparse rows of 2047 features, c = 1)."""
    from adaprox_tpu_torch.experiments import cubic_sparse_logreg as cubic
    from adaprox_tpu_torch.experiments.nesterov_worst_case import worst_case_model
    from adaprox_tpu_torch.utils.datasets import load_or_synthesize

    if name == "worst":
        h, q = worst_case_model(100, 100, 100.0, dev, dtype)
        return h, q, 0.0, 0.01, 100
    if name == "2048":
        rng = np.random.default_rng(5)
        x = rng.standard_normal((4096, 2047)) * (rng.random((4096, 2047)) < 0.3)
        y = (x @ rng.standard_normal(2047) / np.sqrt(0.3 * 2048)
             + 0.5 * rng.standard_normal(4096) > 0).astype(float)
    else:
        x, y, _ = load_or_synthesize(name, labels=(0.0, 1.0))
    n = x.shape[1] + 1
    h_np, q_np = cubic.logistic_loss_grad_hessian(x, y, np.zeros(n))
    f = cubic.cubic_from_numpy(h_np, q_np, 1.0, device=dev, dtype=dtype)
    gam = cubic.secant_gamma(f, np.zeros(n), 0, dev, dtype)
    h, q = cubic.padded_model(h_np, q_np, dev, dtype)
    return h, q, 1.0, gam, n


def cubic_checks(resident, dev, smi):
    """Phase 8, K2 and K2c with the cubic objective against the plain version
    on the card (cases o-r). Returns the inputs by name."""
    models = {name: cubic_inputs(name, dev) for name in ("mushrooms", "worst", "2048")}
    for case, name in zip("opq", models):
        h, q, c, gam, n_true = models[name]
        n = h.shape[0]
        x0 = torch.zeros(n, device=dev)
        for body, horizon in CUBIC_HORIZON[name].items():
            adaptive = body in ("mm", "adapgm")
            rtol = K2_CASE_A_RTOL[body] if adaptive else K2_FIXED_RTOL
            maxit = max(30, horizon) if adaptive else horizon
            kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c, record=True,
                      rule_kind="fixed" if body == "momentum" else body,
                      momentum=body == "momentum")
            got = resident.resident_adapgm(h, q, x0, gam, -1.0, maxit, **kw)
            want = resident.resident_adapgm_plain(h, q, x0, gam, -1.0, maxit, **kw)
            torch.cuda.synchronize()
            err = rows_err(got, want, horizon)
            held = max((k for k in range(1, maxit + 1) if rows_err(got, want, k) <= rtol),
                       default=0)
            xe = x_err(got, want)
            pad_zero = not bool(got[0][n_true:].any())
            print(f"[cubic] K2 ({case}) {name} {n}x{n} f32 c {c:g} {body} tol -1 maxit {maxit}: "
                  f"rows over {horizon} it, rel err {err:.2e} (tol {rtol:g}; CPU-calibrated "
                  f"horizon); within tol through iteration {held}; x rel err {xe:.2e}; "
                  f"padded coordinates stay 0: {pad_zero} ({smi})", flush=True)
            check(int(got[1]) == int(want[1]) == maxit and err <= rtol and pad_zero
                  and (adaptive or xe <= rtol), f"K2 cubic ({case}) {name} {body} disagrees")

    # (r) the drivers' rows in one sweep, each the same bits as its single K2
    # launch; two launches, the same bits
    from adaprox_tpu_torch.experiments import cubic_sparse_logreg, nesterov_worst_case

    for name, maxit in (("mushrooms", 1000), ("worst", 2000)):
        h, q, c, gam, _ = models[name]
        x0 = torch.zeros(h.shape[0], device=dev)
        if name == "worst":
            specs = [(gam, rule, mom, 1e-6, maxit)
                     for _, rule, mom in nesterov_worst_case.RESIDENT_ROWS]
        else:
            specs = cubic_sparse_logreg.rule_specs(gam, 1e-7, maxit // 10)
        kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c)
        out, same = k2c_rows_are_k2(resident, h, q, x0, specs, maxit, **kw)
        again = resident.resident_rule_sweep(h, q, x0, resident.rule_rows(specs), 0.0, maxit,
                                             **kw)
        same &= all(same_bits(u, w) for u, w in zip(sweep_row(out, slice(None)),
                                                    sweep_row(again, slice(None))))
        print(f"[cubic] K2c (r) {name} f32: numit {out[1].tolist()}, every row the same bits "
              f"as its single K2 launch, and two launches the same bits: {same}", flush=True)
        check(same, f"K2c cubic (r) {name}: a sweep row differs from its single K2 launch")
    return models


def cubic_phase(resident, models, counting, dev, smi):
    """Phase 8: both cubic drivers on the card (--resident and the engine)
    and the cubic iteration. ``counting`` is (zero_counts, read_counts)."""
    from adaprox_tpu_torch.experiments import cubic_sparse_logreg, nesterov_worst_case
    from adaprox_tpu_torch.experiments.common import bt_sweep_rows
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    zero_counts, read_counts = counting

    def sweep_bound(n, numits, moms):
        # H read once, q, x0 and the rows in, x, the stats and the histories
        # out; 2 n^2 flops a rule iteration and the warm-up, 4 n^2 a momentum
        # iteration in record mode (H z and H x_new)
        r = len(numits)
        return bound(4 * n * n + 8 * n + 20 * r + 4 * r * n + 16 * r + 12 * r * max(numits),
                     sum(4 * n * n * k if mom else 2 * n * n * (k + 1)
                         for k, mom in zip(numits, moms)))

    # cubic_sparse_logreg --resident at its defaults: one K2c and one K4b launch a
    # dataset; then the rule sweep on the driver's inputs against its plain
    # version, timed
    names = [name for name, _ in cubic_sparse_logreg.RESIDENT_ROWS]
    bt_names = [name for name, _, _ in cubic_sparse_logreg.BT_ROWS]
    # the driver's rows, in its order (the backtracking rows after the ground truth)
    row_order = names[:1] + bt_names + names[1:] + ["aGRAAL"]
    cubic_bounds = {name: CUBIC_GAP_BOUND for name in row_order[1:]}
    cubic_bounds["Nesterov (backtracking)"] = CUBIC_NESTEROV_BT_GAP_BOUND
    for ds in CUBIC_DATASETS:
        outdir = os.path.join("results", "chip_smoke", "cubic_sparse_logreg")
        zero_counts()
        cubic_sparse_logreg.main(["--resident", "--datasets", ds, "--device", "cuda",
                                  "--outdir", outdir, "--no-plot"])
        torch.cuda.synchronize()
        c = read_counts()
        rows = read_jsonl(os.path.join(outdir, f"{ds}.jsonl"))
        by = group_by_method(rows)
        fstar = by[None][-1]["objective"]
        gaps = {name: by[name][-1]["objective"] - fstar for name in row_order[1:]}
        grid = [r["grid_total_s"] for r in rows if "grid_total_s" in r]
        ag_wall = [r["wall_s"]["aGRAAL"] for r in rows if "wall_s" in r]
        print(f"[cubic] cubic_sparse_logreg --resident {ds} f32: numit "
              f"{[rs[-1]['it'] for rs in by.values()]}, F-F_gt "
              f"{', '.join(f'{k} {v:.3e} (bound {cubic_bounds[k]:g})' for k, v in gaps.items())} "
              f"| K1, K2, K2c, K3, K4, K4b, aGRAAL launches {c} | grid_total_s {grid}, aGRAAL "
              f"wall_s {ag_wall} ({smi})", flush=True)
        check(c == (0, 0, 1, 0, 0, 1, 1), f"cubic_sparse_logreg --resident {ds}: launches {c}")
        check(list(by) == row_order and all(math.isfinite(v) and abs(v) <= cubic_bounds[k]
                                            for k, v in gaps.items()),
              f"cubic_sparse_logreg --resident {ds}: rows {list(by)}, F-F_gt {gaps}")
        h, q, cc, gam, n_true = cubic_inputs(ds, dev)
        n = h.shape[0]
        x0 = torch.zeros(n, device=dev)
        rows = resident.rule_rows(cubic_sparse_logreg.rule_specs(gam, 1e-7, 100))
        kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=cc)
        secs, got = timed(lambda: resident.resident_rule_sweep(h, q, x0, rows, 1e-7, 1000, **kw),
                          reps=3)
        plain_ms, want = once_ms(lambda: resident.resident_rule_sweep_plain(h, q, x0, rows, 1000,
                                                                            **kw))
        ok, max_abs = True, 0.0
        for j, (name, rule) in enumerate(cubic_sparse_logreg.RESIDENT_ROWS):
            g, w = sweep_row(got, j), sweep_row(want, j)
            nk, npl = int(g[1]), int(w[1])
            horizon = min(CUBIC_HORIZON["mushrooms"][rule], nk, npl)
            err, xe = rows_err(g, w, horizon), x_err(g, w)
            max_abs = max(max_abs, float((g[0] - w[0]).abs().max()))
            print(f"[cubic] K2c vs plain, {ds} {name or '(ground truth)'}: rows over {horizon} it, "
                  f"rel err {err:.2e} (tol {K2_CASE_A_RTOL[rule]:g}); numit {nk} (plain {npl}, "
                  f"slack {LOGREG_NUMIT_SLACK}); x rel err {xe:.2e} (tol {K2_X_RTOL:g}); padded "
                  f"coordinates stay 0: {not bool(g[0][n_true:].any())}", flush=True)
            ok &= (err <= K2_CASE_A_RTOL[rule] and abs(nk - npl) <= LOGREG_NUMIT_SLACK
                   and xe <= K2_X_RTOL and not bool(g[0][n_true:].any()))
        check(ok, f"K2c disagrees with its plain version on cubic_sparse_logreg's {ds} inputs")
        numits = got[1].tolist()
        bnd = sweep_bound(n, numits, [False] * len(numits))
        print(f"[cubic] K2c sweep {ds} {n}x{n} f32 (numit {numits}, 1 launch): {1e3 * secs:.4f} "
              f"ms, plain {plain_ms:.2f} ms, bound {bnd[0]:.6f} ms ({bnd[1]}); largest |x| error "
              f"{max_abs:.2e} ({smi})", flush=True)
        k4b_sweep_timing(h, q, bt_sweep_rows(cubic_sparse_logreg.BT_ROWS, gam), 1e-7, 100, kw,
                         "cubic", ds, smi)

    # nesterov_worst_case --resident at its defaults: one K2c and one K4b launch
    outdir = os.path.join("results", "chip_smoke", "nesterov_worst_case")
    zero_counts()
    nesterov_worst_case.main(["--resident", "--device", "cuda", "--outdir", outdir, "--no-plot"])
    torch.cuda.synchronize()
    c = read_counts()
    rows = read_jsonl(os.path.join(outdir, "nesterov_worst_case.jsonl"))
    optimum = rows[0]["objective"]
    by = group_by_method(rows[1:])
    wnames = [name for name, _, _ in nesterov_worst_case.RESIDENT_ROWS]
    wbt = [name for name, _, _ in nesterov_worst_case.BT_ROWS]
    gaps = {name: by[name][-1]["objective"] - optimum for name in by}
    wbounds = dict(WORST_BT_GAP_BOUND, AdaPGM=WORST_GAP_BOUND)
    print(f"[cubic] nesterov_worst_case --resident (k = n = 100, L 100, tol 1e-6, maxit 10000) "
          f"f32: numit {[rs[-1]['it'] for rs in by.values()]}, F-F* "
          f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} (bounds {wbounds}) | K1, K2, "
          f"K2c, K3, K4, K4b, aGRAAL launches {c} | grid_total_s {rows[-2]['grid_total_s']} "
          f"({smi})", flush=True)
    # (its menu has no aGRAAL row)
    check(c == (0, 0, 1, 0, 0, 1, 0), f"nesterov_worst_case --resident: launches {c}")
    check(list(by) == [wnames[0], wbt[0], wnames[1], wbt[1], *wnames[2:]]
          and all(math.isfinite(gaps[k]) and abs(gaps[k]) <= v for k, v in wbounds.items()),
          f"nesterov_worst_case --resident: {gaps}")
    h, q, cc, gam, _ = models["worst"]
    x0 = torch.zeros(h.shape[0], device=dev)
    rows_t = resident.rule_rows([(gam, rule, mom) for _, rule, mom in
                                 nesterov_worst_case.RESIDENT_ROWS], tol=1e-6, maxit=10000)
    secs, got = timed(lambda: resident.resident_rule_sweep(
        h, q, x0, rows_t, 1e-6, 10000, prox_kind="zero", obj_kind="cubic", cube_c=0.0), reps=3)
    numits = got[1].tolist()
    bnd = sweep_bound(h.shape[0], numits, [mom for _, _, mom in nesterov_worst_case.RESIDENT_ROWS])
    print(f"[cubic] K2c sweep worst case 128x128 f32 (numit {numits}, 1 launch): {1e3 * secs:.4f} "
          f"ms, bound {bnd[0]:.6f} ms ({bnd[1]}) ({smi})", flush=True)
    # its two backtracking rows from gamma0 = 1, tol 1e-6, maxit 10000
    k4b_sweep_timing(h, q, bt_sweep_rows(nesterov_worst_case.BT_ROWS, 1.0), 1e-6, 10000,
                     dict(prox_kind="zero", obj_kind="cubic", cube_c=0.0), "cubic", "worst case",
                     smi)

    # the engine paths: cubic_sparse_logreg on mushrooms at its defaults, and
    # the worst case at --maxit 1000 (depth cut from 10000)
    for label, run, rows_of in (
            ("cubic_sparse_logreg mushrooms (engine path, defaults)",
             lambda out: cubic_sparse_logreg.main(["--datasets", "mushrooms", "--device", "cuda",
                                                   "--outdir", out, "--no-plot"]),
             "mushrooms.jsonl"),
            (f"nesterov_worst_case --maxit {WORST_ENGINE_MAXIT} (engine path, depth cut from "
             "10000)", lambda out: nesterov_worst_case.main([
                 "--maxit", str(WORST_ENGINE_MAXIT), "--device", "cuda", "--outdir", out,
                 "--no-plot"]), "nesterov_worst_case.jsonl")):
        outdir = os.path.join("results", "chip_smoke", "cubic_engine")
        zero_counts()
        run(outdir)
        torch.cuda.synchronize()
        c = read_counts()
        rows = read_jsonl(os.path.join(outdir, rows_of))
        meta = [r for r in rows if "wall_s" in r][0]
        if rows_of == "mushrooms.jsonl":
            by = group_by_method(rows)
            ref = by[None][-1]["objective"]
            bounds = cubic_bounds
        else:
            ref = rows[0]["objective"]
            by = group_by_method(rows[1:])
            bounds = WORST_ENGINE_GAP_BOUND
        gaps = {name: by[name][-1]["objective"] - ref for name in bounds}
        print(f"[cubic] {label} f32: numit {[rs[-1]['it'] for rs in by.values()]}, F-F* "
              f"{', '.join(f'{k} {v:.3e} (bound {bounds[k]:g})' for k, v in gaps.items())} | "
              f"launches {c} | wall_s {meta['wall_s']} ({smi})", flush=True)
        check(meta["fast_path"] == "default" and c == (0,) * 7
              and list(gaps) == list(by)[-len(gaps):]
              and all(math.isfinite(v) and -WORST_GAP_BOUND <= v <= bounds[k]
                      for k, v in gaps.items()), f"{label}: bad rows")

    # the cubic iteration: fixed rule, zero prox, c 1, tol -1, 1000 iterations,
    # at mushrooms' model (128^2, 8 CTAs) and at 2048^2 (128 CTAs)
    for name in ("mushrooms", "2048"):
        h, q, cc, gam, _ = models[name]
        n = h.shape[0]
        x0 = torch.zeros(n, device=dev)
        it_secs, it_out = timed(lambda: resident.resident_adapgm(
            h, q, x0, gam, -1.0, 1000, prox_kind="zero", rule_kind="fixed", obj_kind="cubic",
            cube_c=cc), reps=3)
        check(int(it_out[1]) == 1000, f"K2 cubic {n}x{n}: not 1000 iterations")
        # a solve of 1000 iterations: H read once, 2 n^2 flops an iteration and the
        # warm-up; its bound in ms is the bound of one iteration in us
        bnd = bound(4 * n * n + 16 * n + 16, 2 * n * n * 1001)
        print(f"[cubic] K2 cubic {n}x{n} f32, fixed rule, zero prox, 1000 iterations: "
              f"{1e3 * it_secs:.3f} us an iteration, bound {bnd[0]:.6f} us an iteration "
              f"({bnd[1]}) ({smi})", flush=True)


def bt_rows_err(got, want, horizon):
    """K4 (or a K4b row) against its plain version over ``horizon``
    iterations: (trial counts and step sizes equal, the larger relative error
    of norm_res and the objective, the first iteration whose trial counts
    differ or None)."""
    h = min(horizon, int(got[1]), int(want[1]))
    same = torch.equal(got[8][:h], want[8][:h]) and torch.equal(got[5][:h], want[5][:h])
    err = max((float((u[:h] - w[:h]).abs().max() / w[:h].abs().max()) if h else 0.0)
              for u, w in ((got[6], want[6]), (got[7], want[7])))
    k = min(int(got[1]), int(want[1]))
    diff = torch.nonzero(got[8][:k] != want[8][:k]).flatten()
    return same, err, int(diff[0]) if len(diff) else None


def bt_row(out, j):
    """Row j of a K4b output, in the layout of one record-mode K4 solve."""
    return (out[0][j], out[1][j], out[2][j], out[3][j], out[4][j], *(h[j] for h in out[5]))


def bt_work(m, n, elt, obj, numits, trials, nesterovs, hist_len):
    """(bytes, flops) of backtracking solves of one problem in one launch: A read
    once (and A^T where the objective reads it), b and x0 in, x, the stats and
    the histories out; 2 m n flops a trial (A z), and for each iteration that
    goes on, 2 m n more for PG (A^T res; none for "cubic") or 4 m n for a
    momentum point (2 n^2 for "cubic"); the start is one forward pass and one
    gradient."""
    fwd, grad = 2 * m * n, (0 if obj == "cubic" else 2 * m * n)
    r = len(numits)
    moved = (elt * m * n * (1 if obj == "cubic" else 2) + 4 * (m + n) + 12 * r
             + r * (4 * n + 20 + 16 * hist_len))
    flops = sum(fwd + grad + fwd * t + (k - 1 if k else 0) * ((fwd if nest else 0) + grad)
                for k, t, nest in zip(numits, trials, nesterovs))
    return moved, flops


def bt_checks(resident_bt, ref, logreg, cubic_models, dev, smi):
    """Phase 9, K4 against its plain version (cases s-v) and K4b's rows bit for
    bit against single K4 launches (w). Returns K4's largest |x| error."""
    a, b, gam = ref["a"], ref["b"], ref["gam"]
    cases = [("s", "lasso", "lasso 4096x1024 f32", a, b, gam, dict(prox_kind="l1", p1=1.0)),
             ("s", "lasso", "lasso 4096x1024 f32 exact", a, b, gam,
              dict(prox_kind="l1", p1=1.0, exact_bregman=True)),
             ("s", "lasso", "lasso 4096x1024 bf16", a.to(torch.bfloat16), b, gam,
              dict(prox_kind="l1", p1=1.0)),
             ("t", "logreg", "mushrooms [X 1] 8128x128 f32", logreg["a"], logreg["b"],
              logreg["gam"], dict(prox_kind="l1", p1=0.01, obj_kind="logreg",
                                  m_true=logreg["m_true"]))]
    for name in ("mushrooms", "worst"):
        h, q, c, gam_c, n_true = cubic_models[name]
        cases.append(("u" if name == "mushrooms" else "v", name,
                      f"{name} cubic {h.shape[0]}x{h.shape[1]} f32 c {c:g}", h, q, gam_c,
                      dict(prox_kind="zero", obj_kind="cubic", cube_c=c, n_true=n_true)))
    max_abs_err = 0.0
    for case, key, label, a_, b_, gam_, kw in cases:
        kw = dict(kw)
        n_true = kw.pop("n_true", a_.shape[1])
        x0 = torch.zeros(a_.shape[1], device=dev)
        for xi, nest in BT_METHODS:
            horizon = BT_HORIZON[key]["nesterov" if nest else xi]
            got = resident_bt.resident_backtracking(a_, b_, x0, gam_, -1.0, horizon, xi=xi,
                                                    nesterov=nest, record=True, **kw)
            want = resident_bt.resident_backtracking_plain(a_, b_, x0, gam_, -1.0, horizon,
                                                           xi=xi, nesterov=nest, record=True,
                                                           **kw)
            torch.cuda.synchronize()
            same, err, first = bt_rows_err(got, want, horizon)
            xe = x_err(got, want)
            pad_zero = not bool(got[0][n_true:].any())
            if label == "lasso 4096x1024 f32" and xi == 1.5:
                max_abs_err = float((got[0] - want[0]).abs().max())
            method = "Nesterov" if nest else f"PG xi {xi:g}"
            print(f"[backtracking] K4 ({case}) {label} {method} tol -1 maxit {horizon}: trial "
                  f"counts and step sizes equal over {horizon} it (CPU-calibrated): {same} "
                  f"(first differing trial count: {first}); norm_res and objective rel err "
                  f"{err:.2e} (tol {BT_RTOL:g}); trials {int(got[8].sum())}; x rel err "
                  f"{xe:.2e}; padded coordinates stay 0: {pad_zero} ({smi})", flush=True)
            check(int(got[1]) == int(want[1]) == horizon and same and err <= BT_RTOL
                  and pad_zero and not bool(got[4]), f"K4 ({case}) {label} {method} disagrees")

    # (w) the drivers' backtracking rows in one sweep, each the same bits as its
    # single K4 launch; two launches, the same bits
    from adaprox_tpu_torch.experiments.common import BT_ROWS, bt_sweep_rows

    for case, key, label, a_, b_, gam_, kw in cases:
        if kw.get("exact_bregman"):
            continue
        kw = {k: v for k, v in kw.items() if k != "n_true"}
        x0 = torch.zeros(a_.shape[1], device=dev)
        rows = bt_sweep_rows(BT_ROWS, gam_)
        runs = [resident_bt.resident_bt_sweep(a_, b_, x0, rows, 1e-7, 300, **kw)
                for _ in range(2)]
        same = all(torch.equal(u, w) for u, w in zip(bt_row(runs[0], slice(None)),
                                                      bt_row(runs[1], slice(None))))
        for j, (g0, xi, flag) in enumerate(rows):
            one = resident_bt.resident_backtracking(a_, b_, x0, g0, 1e-7, 300, xi=xi,
                                                    nesterov=flag > 0, record=True, **kw)
            same &= all(torch.equal(u, w) for u, w in zip(bt_row(runs[0], j), one))
        torch.cuda.synchronize()
        print(f"[backtracking] K4b (w) {label}: numit {runs[0][1].tolist()}, every row the same "
              f"bits as its single K4 launch, and two launches the same bits: {same}",
              flush=True)
        check(same, f"K4b (w) {label}: a sweep row differs from its single K4 launch")
    return max_abs_err


def bt_phase(resident, resident_bt, ref, counting, dev, smi):
    """Phase 9: the large-|f| exact-Bregman case, K4's own path at the
    reference size, the lasso driver's backtracking sweep against its plain
    version, and the iteration beside K2's. Returns the kernels line's
    measurements of K4 and K4b."""
    from adaprox_tpu_torch.experiments.common import BT_ROWS, bt_sweep_rows, pad_tiles
    from adaprox_tpu_torch.models.synthetic import random_lasso
    from adaprox_tpu_torch.utils.profiling import timed

    zero_counts, read_counts = counting

    # (x) a large-|f| f32 lasso (b = A xs 1e3 + noise, tests/test_kernels.py): the
    # raw test carries eps |f| noise. PG with the exact-Bregman test must converge
    # to tol 1e-4 in at least 10x fewer iterations, or where the raw test does not
    # in 20000. Nesterov reaches tol 1e-4 with neither test in f32 here: its
    # norm_res stalls near 5e-3, the instance's f32 noise floor (the JAX kernel's
    # f32 run "converges" at 92 iterations only because 15 spurious shrinks at
    # iteration 81 collapse gamma until z = x; its f64 run takes 111). So for
    # Nesterov the claim is on F: after 120 iterations, F - F* (F* from an f64 run
    # of the plain version, tol 1e-10) must be at least 10x smaller with the
    # exact test (on the CPU in f32: 2.2e-4 against 1.42).
    rng = np.random.default_rng(0)
    m, n = 1536, 384
    a_np = rng.standard_normal((m, n)) / np.sqrt(n)
    xs = rng.standard_normal(n) * (rng.random(n) < 0.1)
    b_np = a_np @ xs * 1e3 + rng.standard_normal(m)
    a_l = torch.as_tensor(a_np, dtype=torch.float32, device=dev)
    b_l = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    gam_l = 1.0 / float(np.linalg.norm(a_np, 2) ** 2)
    raw, exact = (resident_bt.resident_backtracking(
        a_l, b_l, torch.zeros(n, device=dev), gam_l, 1e-4, 20000, p1=1.0,
        exact_bregman=eb) for eb in (False, True))
    it_r, it_e = int(raw[1]), int(exact[1])
    print(f"[backtracking] K4 (x) large-|f| lasso 1536x384 f32 PG tol 1e-4: raw test {it_r} "
          f"iterations (converged {bool(raw[3])}), exact-Bregman {it_e} (converged "
          f"{bool(exact[3])}) ({smi})", flush=True)
    check(bool(exact[3]) and (10 * it_e <= it_r or not bool(raw[3])),
          f"K4 (x): exact-Bregman PG does not take 10x fewer iterations ({it_e} vs {it_r})")
    a64, b64 = a_l.double(), torch.as_tensor(b_np, device=dev)
    star = resident_bt.resident_backtracking_plain(a64, b64, torch.zeros(n, dtype=torch.float64,
                                                                         device=dev),
                                                   gam_l, 1e-10, 3000, nesterov=True, p1=1.0)

    def objective(x):
        r = a64 @ x.double() - b64
        return float(0.5 * r @ r + x.double().abs().sum())

    fstar = objective(star[0])
    gaps = {}
    for eb in (False, True):
        out = resident_bt.resident_backtracking(a_l, b_l, torch.zeros(n, device=dev), gam_l, 1e-4,
                                                120, p1=1.0, nesterov=True, exact_bregman=eb)
        gaps[eb] = objective(out[0]) - fstar
    print(f"[backtracking] K4 (x) large-|f| lasso 1536x384 f32 Nesterov, 120 iterations: F - F* "
          f"raw test {gaps[False]:.4e}, exact-Bregman {gaps[True]:.4e} (F* {fstar:.6f} from f64, "
          f"{int(star[1])} iterations) ({smi})", flush=True)
    check(math.isfinite(gaps[True]) and 10 * abs(gaps[True]) <= abs(gaps[False]),
          f"K4 (x): exact-Bregman Nesterov not 10x closer to F* ({gaps})")

    # K4's own path: one solve at the resident reference size (4096x1024 f32, lam 1,
    # tol 1e-4, maxit 4000), PG with xi 1.5 as a user calls it, counted
    a, b, x0, gam = ref["a"], ref["b"], ref["x0"], ref["gam"]
    zero_counts()
    resident_bt.resident_backtracking(a, b, x0, gam, 1e-4, 4000, xi=1.5, p1=1.0)
    torch.cuda.synchronize()
    single = read_counts()
    check(single == (0, 0, 0, 0, 1, 0, 0), f"K4 single solve: launches {single}")
    k4_s, out = timed(lambda: resident_bt.resident_backtracking(a, b, x0, gam, 1e-4, 4000,
                                                                xi=1.5, p1=1.0), reps=5)
    plain_s, _ = timed(lambda: resident_bt.resident_backtracking_plain(
        a, b, x0, gam, 1e-4, 4000, xi=1.5, p1=1.0), reps=1)
    rec = resident_bt.resident_backtracking(a, b, x0, gam, 1e-4, 4000, xi=1.5, p1=1.0,
                                            record=True)
    numit = int(out[1])
    check(numit == int(rec[1]) and torch.equal(out[0], rec[0]), "K4: record mode changed the solve")
    k4_syncs = resident_bt.k4b_syncs([[0]], [numit], [rec[8].tolist()], [False])
    check(int(resident_bt.resident_backtracking.last_syncs) == k4_syncs,
          f"K4: the kernel took {int(resident_bt.resident_backtracking.last_syncs)} grid syncs, "
          f"k4b_syncs counts {k4_syncs}")
    mm, nn = a.shape
    k4_bound = bound(*bt_work(mm, nn, 4, "ls", [numit], [int(rec[8].sum())], [False], 0))
    print(f"[backtracking] K4 4096x1024 f32 PG xi 1.5 lam 1 tol 1e-4: solve {1e3 * k4_s:.4f} ms "
          f"(CUDA events, best of 5), numit {numit}, trials {int(rec[8].sum())}, converged "
          f"{bool(out[3])}, ls_failed {bool(out[4])} | plain {1e3 * plain_s:.2f} ms | bound "
          f"{k4_bound[0]:.4f} ms ({k4_bound[1]}) | launches {single} | {k4_syncs} grid syncs (= "
          f"the kernel's count), {1e6 * k4_s / k4_syncs:.3f} us a sync ({smi})", flush=True)

    # the lasso driver's backtracking sweep (4000x1000x10 padded to 4000x1024 f32,
    # maxit 2000, tol 1e-7), timed and held against its plain version: each row's
    # trial counts and step sizes over the lasso horizon, numit within the band, x
    # at the end to 1e-3 (on an H100 the trial counts first parted at iteration
    # 1930 for xi 1, 451 and 377 for xi 1.5 and 2; x then differed by 2.4e-4,
    # 2.3e-5 and 3.7e-5 of max|x|), not for Nesterov (backtracking): its f32 step
    # collapses from iteration ~700 on, where the rounding decides (GAP_BOUND)
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a_d, b_d = pad_tiles(torch.as_tensor(prob.a, dtype=torch.float32, device=dev),
                         torch.as_tensor(prob.b, dtype=torch.float32, device=dev))
    gam_d = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0_d = torch.zeros(a_d.shape[1], device=dev)
    rows = bt_sweep_rows(BT_ROWS, gam_d)
    sweep_s, got = timed(lambda: resident_bt.resident_bt_sweep(a_d, b_d, x0_d, rows, 1e-7, 2000,
                                                               p1=prob.lam), reps=3)
    sweep_plain_s, want = timed(lambda: resident_bt.resident_bt_sweep_plain(
        a_d, b_d, x0_d, rows, 1e-7, 2000, p1=prob.lam), reps=1)
    ok, sweep_err = True, 0.0
    for j, (name, xi, nest) in enumerate(BT_ROWS):
        g, w = bt_row(got, j), bt_row(want, j)
        horizon = BT_HORIZON["lasso"]["nesterov" if nest else xi]
        same, err, first = bt_rows_err(g, w, horizon)
        nk, npl, xe = int(g[1]), int(w[1]), x_err(g, w)
        if not nest:
            sweep_err = max(sweep_err, float((g[0] - w[0]).abs().max()))
        print(f"[backtracking] K4b vs plain, lasso driver 4000x1024 f32 {name}: trial counts and "
              f"step sizes equal over {horizon} it: {same} (first differing trial count: "
              f"{first}); rel err {err:.2e} (tol {BT_RTOL:g}); numit {nk} (plain {npl}, band "
              f"{K2_NUMIT_BAND:g}); x rel err {xe:.2e} (tol {BT_RTOL:g}"
              f"{', not held' if nest else ''}) ({smi})", flush=True)
        ok &= (same and err <= BT_RTOL and abs(nk - npl) <= K2_NUMIT_BAND * npl
               and (nest or xe <= BT_RTOL))
    check(ok, "K4b disagrees with its plain version on the lasso driver's inputs")
    numits, trials = got[1].tolist(), [int(t) for t in got[5][3].sum(1).tolist()]
    mm, nn = a_d.shape
    k4b_bound = bound(*bt_work(mm, nn, 4, "ls", numits, trials, [nest for _, _, nest in BT_ROWS],
                               2000))
    syncs = k4b_sync_report(a_d, rows, got, 1e3 * sweep_s, "lasso driver")
    print(f"[backtracking] K4b lasso driver sweep 4000x1024 f32 (numit {numits}, trials "
          f"{trials}, 1 launch): {1e3 * sweep_s:.4f} ms, plain {1e3 * sweep_plain_s:.2f} ms, "
          f"bound {k4b_bound[0]:.4f} ms ({k4b_bound[1]}); {syncs} ({smi})", flush=True)

    # the iteration: one trial a PG iteration and a Nesterov iteration, zero prox,
    # tol -1, 1000 iterations, beside K2's fixed-rule iteration, at the reference
    # size and at 8x2176 (a full grid with almost no work: the barriers and the
    # latency). gamma = 1e-3/||A||_F^2: far below 1/||A||^2, so every first trial
    # passes, and slow enough that 8x2176 (m < n) does not converge to where the
    # raw test's rounding adds trials (at 1/||A||_F^2 it did)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for m_, n_ in ((4096, 1024), (8, 2176)):
        if (m_, n_) == (4096, 1024):
            a_, b_ = a, b
        else:
            a_ = torch.randn(m_, n_, generator=gen, device=dev) / n_
            b_ = torch.randn(m_, generator=gen, device=dev)
        gam_ = 1e-3 / float((a_ * a_).sum())
        x0_ = torch.zeros(n_, device=dev)
        us = {}
        for label, fn in (
                ("K4 PG", lambda: resident_bt.resident_backtracking(
                    a_, b_, x0_, gam_, -1.0, 1000, prox_kind="zero")),
                ("K4 Nesterov", lambda: resident_bt.resident_backtracking(
                    a_, b_, x0_, gam_, -1.0, 1000, prox_kind="zero", nesterov=True)),
                ("K2 fixed", lambda: resident.resident_adapgm(
                    a_, b_, x0_, gam_, 0.0, 1000, prox_kind="zero", rule_kind="fixed"))):
            secs, res = timed(fn, reps=3)
            check(int(res[1]) == 1000, f"{label} {m_}x{n_}: not 1000 iterations")
            us[label] = 1e3 * secs
        for nest in (False, True):
            rec = resident_bt.resident_backtracking(a_, b_, x0_, gam_, -1.0, 1000,
                                                    prox_kind="zero", nesterov=nest, record=True)
            check(int(rec[8].sum()) == 1000, f"K4 {m_}x{n_}: not one trial an iteration")
        print(f"[backtracking] iteration {m_}x{n_} f32, zero prox, 1000 iterations, one trial "
              f"each: {', '.join(f'{k} {v:.3f} us' for k, v in us.items())} ({smi})",
              flush=True)
    return (dict(launches=single[4], ms=1e3 * k4_s, plain_ms=1e3 * plain_s, bound=k4_bound),
            dict(max_abs_err=sweep_err, ms=1e3 * sweep_s, plain_ms=1e3 * sweep_plain_s,
                 bound=k4b_bound))


def agraal_checks(resident_bt, ref, logreg, cubic_models, dev, smi):
    """Phase 10, K4 (aGRAAL) against its plain version on the card: the padded
    lasso 4096x1024 in f32 and bf16 storage, mushrooms' [X 1] with the
    logistic objective and the cubic models of phase 8, each from the
    drivers' gamma0 and from the secant gamma0 (gamma0 = 0), with the
    drivers' companion point; tol -1, the rows over CPU-calibrated horizons,
    the padded coordinates exactly 0. Returns the largest |x| error of the
    f32 lasso cases, for the kernels line."""
    from adaprox_tpu_torch.experiments.common import companion_point

    a, b, gam = ref["a"], ref["b"], ref["gam"]
    lasso_kw = dict(prox_kind="l1", p1=1.0)
    cases = [("lasso", "lasso 4096x1024 f32", a, b, 1000, gam, lasso_kw),
             ("lasso", "lasso 4096x1024 bf16", a.to(torch.bfloat16), b, 1000, gam, lasso_kw),
             ("logreg", "mushrooms [X 1] 8128x128 f32", logreg["a"], logreg["b"],
              logreg["n_feat"] + 1, logreg["gam"],
              dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=logreg["m_true"]))]
    for name in ("mushrooms", "worst"):
        h, q, c, gam_c, n_true = cubic_models[name]
        cases.append((name, f"{name} cubic {h.shape[0]}x{h.shape[1]} f32 c {c:g}", h, q, n_true,
                      gam_c, dict(prox_kind="zero", obj_kind="cubic", cube_c=c)))
    max_abs_err = 0.0
    for key, label, a_, b_, n_true, gam_, kw in cases:
        x1 = torch.zeros(a_.shape[1], device=dev)
        x0 = companion_point(x1, n_true)
        for mode, g0 in (("given", gam_), ("secant", 0.0)):
            horizon = AGRAAL_HORIZON[key][mode]
            got = resident_bt.resident_agraal(a_, b_, x1, x0, g0, -1.0, horizon, record=True, **kw)
            want = resident_bt.resident_agraal_plain(a_, b_, x1, x0, g0, -1.0, horizon,
                                                     record=True, **kw)
            torch.cuda.synchronize()
            err, xe = rows_err(got, want, horizon), x_err(got, want)
            pad_zero = not bool(got[0][n_true:].any())
            if label == "lasso 4096x1024 f32":
                max_abs_err = max(max_abs_err, float((got[0] - want[0]).abs().max()))
            print(f"[agraal] K4 (aGRAAL) {label} gamma0 {mode} tol -1 maxit {horizon}: rows rel "
                  f"err {err:.2e} (tol {AGRAAL_RTOL:g}; CPU-calibrated horizon); x rel err "
                  f"{xe:.2e}; padded coordinates stay 0: {pad_zero} ({smi})", flush=True)
            check(int(got[1]) == int(want[1]) == horizon and err <= AGRAAL_RTOL and pad_zero,
                  f"K4 (aGRAAL) {label} gamma0 {mode} disagrees with its plain version")
    return max_abs_err


def agraal_phase(resident, resident_bt, counting, dev, smi):
    """Phase 10: K4 (aGRAAL)'s own path on the lasso driver's inputs (one
    solve, counted and timed) held against its plain version, two launches
    the same bits, and the iteration beside K2's. Returns the kernels line's
    measurements."""
    from adaprox_tpu_torch.experiments.common import companion_point, pad_tiles
    from adaprox_tpu_torch.models.synthetic import random_lasso
    from adaprox_tpu_torch.utils.profiling import timed

    zero_counts, read_counts = counting
    # the lasso driver's aGRAAL row on its own inputs: 4000x1000x10 padded to
    # 4000x1024 f32, lam 1, tol 1e-7, maxit 2000, the companion point on the
    # first 1000 coordinates; a solve as a user calls it (no records), counted
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a, b = pad_tiles(torch.as_tensor(prob.a, dtype=torch.float32, device=dev),
                     torch.as_tensor(prob.b, dtype=torch.float32, device=dev))
    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x1 = torch.zeros(a.shape[1], device=dev)
    x0 = companion_point(x1, 1000)
    kw = dict(prox_kind="l1", p1=prob.lam)
    zero_counts()
    resident_bt.resident_agraal(a, b, x1, x0, gam, 1e-7, 2000, **kw)
    torch.cuda.synchronize()
    single = read_counts()
    check(single == (0, 0, 0, 0, 0, 0, 1), f"K4 (aGRAAL) single solve: launches {single}")
    ag_s, out = timed(lambda: resident_bt.resident_agraal(a, b, x1, x0, gam, 1e-7, 2000, **kw),
                      reps=3)
    plain_s, want = timed(lambda: resident_bt.resident_agraal_plain(a, b, x1, x0, gam, 1e-7, 2000,
                                                                    record=True, **kw), reps=1)
    runs = [resident_bt.resident_agraal(a, b, x1, x0, gam, 1e-7, 2000, record=True, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = (all(torch.equal(u, w) for u, w in zip(*runs))
            and all(torch.equal(u, w) for u, w in zip(out, runs[0][:4])))
    got = runs[0]
    horizon = AGRAAL_HORIZON["lasso"]["given"]
    err = rows_err(got, want, horizon)
    a64, b64 = a.double(), b.double()

    def objective(x):
        r = a64 @ x.double() - b64
        return float(0.5 * r @ r + prob.lam * x.double().abs().sum())

    gaps = (objective(got[0]) - prob.optimum, objective(want[0]) - prob.optimum)
    numit = int(got[1])
    m, n = a.shape
    # A read once, b, x1 and x0 in, x and the stats out; 8 m n flops at the start
    # (the forward pass and the gradient at x1 and at x0), 4 m n an iteration
    ag_bound = bound(4 * m * n + 4 * m + 12 * n + 20, 8 * m * n + 4 * m * n * numit)
    print(f"[agraal] K4 (aGRAAL) lasso driver 4000x1024 f32 lam 1 tol 1e-7 maxit 2000: solve "
          f"{1e3 * ag_s:.4f} ms (CUDA events, best of 3), numit {numit} (plain {int(want[1])}), "
          f"converged {bool(got[3])}; rows over {horizon} it rel err {err:.2e} (tol "
          f"{AGRAAL_RTOL:g}); F - F* {gaps[0]:.4e} (plain {gaps[1]:.4e}; bound "
          f"{GAP_BOUND['aGRAAL']:g}); two launches and the record mode the same bits: {same} | "
          f"plain {1e3 * plain_s:.2f} ms | bound {ag_bound[0]:.4f} ms ({ag_bound[1]}) | launches "
          f"{single} ({smi})", flush=True)
    check(same and err <= AGRAAL_RTOL and not bool(got[0][1000:].any())
          and all(math.isfinite(v) and abs(v) <= GAP_BOUND["aGRAAL"] for v in gaps),
          "K4 (aGRAAL) on the lasso driver's inputs: bad solve")

    # the iteration: zero prox, tol -1, 1000 iterations, beside K2's fixed-rule
    # iteration, at the reference size and at 8x2176 (a full grid with almost no
    # work: the barriers and the latency); gamma0 = 1e-3/||A||_F^2, the
    # companion point x1 + N(0, I)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    us = {}
    for m_, n_ in ((4096, 1024), (8, 2176)):
        if (m_, n_) == (4096, 1024):
            a_, b_ = a, b
        else:
            a_ = torch.randn(m_, n_, generator=gen, device=dev) / n_
            b_ = torch.randn(m_, generator=gen, device=dev)
        gam_ = 1e-3 / float((a_ * a_).sum())
        x1_ = torch.zeros(n_, device=dev)
        x0_ = torch.randn(n_, generator=gen, device=dev)
        for label, fn in (
                ("K4 (aGRAAL)", lambda: resident_bt.resident_agraal(
                    a_, b_, x1_, x0_, gam_, -1.0, 1000, prox_kind="zero")),
                ("K2 fixed", lambda: resident.resident_adapgm(
                    a_, b_, x1_, gam_, 0.0, 1000, prox_kind="zero", rule_kind="fixed"))):
            secs, res = timed(fn, reps=3)
            check(int(res[1]) == 1000, f"{label} {m_}x{n_}: not 1000 iterations")
            us[f"{label} {m_}x{n_}"] = 1e3 * secs
        print(f"[agraal] iteration {m_}x{n_} f32, zero prox, 1000 iterations: "
              f"{', '.join(f'{k} {v:.3f} us' for k, v in us.items() if k.endswith(f'{m_}x{n_}'))}"
              f" ({smi})", flush=True)
    return dict(launches=single[6], ms=1e3 * ag_s, plain_ms=1e3 * plain_s, bound=ag_bound)


def pd_inputs(name, big_c, dev):
    """The dual_svm driver's resident inputs for dataset ``name`` (its synthetic
    stand-in) on the card, f32: the dense Gram or the factored B, the padded labels,
    and the scalars the driver passes (norm_a, Condat-Vu's steps from Lf)."""
    from adaprox_tpu_torch.experiments import dual_svm

    x, y, _ = dual_svm.load(name)
    dyx = y[:, None] * x
    q, lab, factored = dual_svm.resident_inputs(dyx, y, torch.float32, dev)
    norm_a = float(np.linalg.norm(y))
    gamma, sigma = dual_svm.cv_steps(float(np.linalg.norm(dyx.T @ dyx)), norm_a)
    return dict(q=q, lab=lab, factored=factored, n=len(y), y=y, norm_a=norm_a, gamma=gamma,
                sigma=sigma, big_c=big_c)


def pd_rows_err(got, want, horizon):
    """Largest error of the history rows over ``horizon`` iterations, each relative
    to its plain row's largest magnitude there."""
    err = 0.0
    for u, w in zip(got, want):
        u, w = u.reshape(-1, u.shape[-1])[:, :horizon], w.reshape(-1, w.shape[-1])[:, :horizon]
        err = max(err, float(((u - w).abs().amax(1) / w.abs().amax(1)).max()))
    return err


def pd_work(inp, numits, hist_len, rows):
    """(bytes, flops) of a K6 launch on ``inp``: Q or B read once, the labels (and
    the couplings) in, x, the stats and the histories out; 2 N^2 flops an iteration
    dense (Q x), 4 N d factored (B'x, then B (B'x))."""
    n, cols = inp["q"].shape
    elt = inp["q"].element_size()
    moved = elt * n * cols + 4 * n + 4 * rows + 4 * rows * n + 16 * rows + 8 * rows * hist_len
    per_it = 4 * n * cols if inp["factored"] else 2 * n * n
    return moved, per_it * sum(numits)


def flat_out(out):
    """A sweep's outputs, its tuple of histories unpacked."""
    return [u for v in out for u in (v if isinstance(v, tuple) else (v,))]


def k6_layout(resident_pd, q, core, rows, factored):
    """The cluster layout of a K6a/K6b ("adapdm") or K6c ("mp") launch of ``rows`` rows."""
    plan = resident_pd.dsvm_grid_plan(q, core, rows, factored=factored)
    return (f"C {plan['cluster']}, {plan['clusters']} clusters at once for {rows} rows, "
            f"{plan['rows_held']} of {plan['rows_per_cta']} rows a CTA in shared memory, "
            f"{plan['smem_bytes']} B")


def k6_rows_checks(tag, core, sweep, p2_of, resident_pd, dev, smi, single=None, **extra):
    """Every row of a K6b or K6c sweep at the driver's settings (the 12 couplings, C 0.1, tol
    1e-5, maxit 10000, record) on the three stand-ins, Q (or B) f32 and bf16, bit for bit
    against its one-row launch, and a dense row against ``single`` (K6a) when given; the
    couplings reversed give the rows reversed; the 12 twice over in one launch (24 rows, more
    than the clusters that run at once at C 8) give each row's bits twice."""
    from adaprox_tpu_torch.experiments.dual_svm import T_VALUES

    for name in PD_DATASETS:
        inp = pd_inputs(name, 0.1, dev)
        lab, n, fac = inp["lab"], inp["n"], inp["factored"]
        for dtype in (torch.float32, torch.bfloat16):
            q = inp["q"].to(dtype)
            kw = dict(n_true=n, factored=fac, record=True, **extra)
            p2 = p2_of(inp["norm_a"])
            out = sweep(q, lab, 0.1, T_VALUES, p2, 1e-5, 10000, **kw)
            rows = all(torch.equal(u[0], w[j]) for j, t in enumerate(T_VALUES)
                       for u, w in zip(flat_out(sweep(q, lab, 0.1, [t], p2, 1e-5, 10000, **kw)),
                                       flat_out(out)))
            k6a = ""
            if single is not None and not fac:
                same_a = True
                for j, t in enumerate(T_VALUES):
                    one = single(q, lab, 0.1, t, p2, 1e-5, 10000, n_true=n)
                    same_a &= all(torch.equal(u, w[j]) for u, w in zip(one, out[:4]))
                rows &= same_a
                k6a = f" (and its K6a launch: {same_a})"
            rev = sweep(q, lab, 0.1, T_VALUES[::-1], p2, 1e-5, 10000, **kw)
            same_rev = all(torch.equal(u, w.flip(0)) for u, w in zip(flat_out(rev), flat_out(out)))
            twice = sweep(q, lab, 0.1, T_VALUES * 2, p2, 1e-5, 10000, **kw)
            same_twice = all(torch.equal(u[:12], w) and torch.equal(u[12:], w)
                             for u, w in zip(flat_out(twice), flat_out(out)))
            label = f"{name} {'B' if fac else 'Q'} {q.shape[0]}x{q.shape[1]} {dtype_name(dtype)}"
            print(f"[{tag}] {'K6b' if core == 'adapdm' else 'K6c'} rows, {label}, C 0.1 tol 1e-5 "
                  f"maxit 10000 (numit {out[1].tolist()}): each row bit for bit its one-row "
                  f"launch{k6a} {rows}; the couplings reversed give the rows reversed {same_rev}; "
                  f"24 rows (the 12 twice) give each row's bits twice {same_twice} | layout: "
                  f"{k6_layout(resident_pd, q, core, 12, fac)}; 24 rows: "
                  f"{resident_pd.dsvm_grid_plan(q, core, 24, factored=fac)['clusters']} clusters "
                  f"at once ({smi})", flush=True)
            check(rows and same_rev and same_twice,
                  f"{core} rows on {label} differ from their one-row launches")


def k6_iterations(tag, core, sweep, p2_of, resident_pd, dev, smi, **extra):
    """The one-row iteration (t 0.5, tol -1, 1000 iterations, record) of K6b or K6c at the
    driver's three shapes, f32 and bf16, with its layout, beside the cooperative kernel's.
    Returns {shape dtype: us an iteration}."""
    from adaprox_tpu_torch.utils.profiling import timed

    us, parts = {}, []
    for name in ("heart_scale", "svmguide3", "mushrooms"):
        inp = pd_inputs(name, 0.1, dev)
        lab, n, fac = inp["lab"], inp["n"], inp["factored"]
        shape = f"{'B' if fac else 'Q'} {inp['q'].shape[0]}x{inp['q'].shape[1]}"
        for dtype in (torch.float32, torch.bfloat16):
            q = inp["q"].to(dtype)
            secs, res = timed(lambda: sweep(q, lab, 0.1, [0.5], p2_of(inp["norm_a"]), -1.0, 1000,
                                            n_true=n, factored=fac, record=True, **extra), reps=3)
            check(int(res[1][0]) == 1000, f"{core} {shape}: not 1000 iterations")
            key = f"{shape} {dtype_name(dtype)}"
            us[key] = 1e3 * secs
            trials = f", {float(res[5][3].mean()):.3f} trials an iteration" if core == "mp" else ""
            old = K6_COOPERATIVE_US[shape][0 if core == "adapdm" else 1]
            parts.append(f"{key}: {us[key]:.3f} us{trials}"
                         + (f" (cooperative kernel {old:.3f} us)" if dtype == torch.float32 else "")
                         + f" [{k6_layout(resident_pd, q, core, 1, fac)}]")
    print(f"[{tag}] the {'PD (K6b' if core == 'adapdm' else 'MP (K6c'} one-row launch) "
          f"iteration, t 0.5, 1000 iterations, tol -1, record: {'; '.join(parts)} ({smi})",
          flush=True)
    return us


def pd_checks(resident_pd, dev, smi):
    """Phase 11, K6a, K6b and K6d against their plain versions on the card, on the
    dual_svm driver's inputs: svmguide3's dense 1280^2, heart_scale's 384^2 (f32 and
    bf16 Q) and mushrooms' factored 8192x128 (f32 and bf16 B), C 0.1 and 1; tol -1,
    the rows over CPU-calibrated horizons, the padded coordinates exactly 0, two
    launches the same bits. Returns the largest |x| error of each kernel on the f32
    cases."""
    from adaprox_tpu_torch.experiments.dual_svm import T_VALUES

    cases = []
    for name in PD_DATASETS:
        for big_c in (0.1, 1.0):
            cases.append((f"{name} C {big_c:g}", pd_inputs(name, big_c, dev)))
    for name in ("heart_scale", "mushrooms"):
        inp = dict(pd_inputs(name, 0.1, dev))
        inp["q"] = inp["q"].to(torch.bfloat16)
        cases.append((f"{name} C 0.1 bf16", inp))
    errs = {"k6a": 0.0, "k6b": 0.0, "k6d": 0.0}
    h_pd, h_cv = PD_HORIZON["adapdm"], PD_HORIZON["cv"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, inp in cases:
        q, lab, n, fac, big_c = inp["q"], inp["lab"], inp["n"], inp["factored"], inp["big_c"]
        shape = f"{'B' if fac else 'Q'} {q.shape[0]}x{q.shape[1]}"
        # K6d's layout: the Python plan the wrapper sizes its scratch from, the launcher's
        plan = resident_pd.k6d_plan(q.shape[0], q.shape[1] if fac else 0, fac, q.element_size(),
                                    sms)
        check(plan == resident_pd.k6d_card_plan(q.shape[0], q.shape[1] if fac else 0, fac,
                                                q.element_size(), sms),
              f"K6d {label}: k6d_plan differs from the launcher's plan")
        kw = dict(n_true=n, record=True, factored=fac)
        args = (q, lab, big_c, T_VALUES, inp["norm_a"], -1.0, h_pd)
        got = resident_pd.resident_adapdm_dsvm_sweep(*args, **kw)
        again = resident_pd.resident_adapdm_dsvm_sweep(*args, **kw)
        want = resident_pd.resident_adapdm_dsvm_sweep_plain(*args, **kw)
        cv_args = (q, lab, big_c, inp["gamma"], inp["sigma"], -1.0, h_cv)
        got_cv = resident_pd.resident_cv_dsvm(*cv_args, **kw)
        again_cv = resident_pd.resident_cv_dsvm(*cv_args, **kw)
        want_cv = resident_pd.resident_cv_dsvm_plain(*cv_args, **kw)
        torch.cuda.synchronize()
        same = (all(torch.equal(u, w) for u, w in zip(got[:4], again[:4]))
                and all(torch.equal(u, w) for u, w in zip(got[4:], again[4:]))
                and all(torch.equal(u, w) for u, w in zip(got_cv[:4], again_cv[:4]))
                and all(torch.equal(u, w) for u, w in zip(got_cv[4], again_cv[4])))
        err_b, err_d = pd_rows_err(got[4:], want[4:], h_pd), pd_rows_err(got_cv[4], want_cv[4],
                                                                          h_cv)
        xb = float((got[0] - want[0]).abs().max())
        xd = float((got_cv[0] - want_cv[0]).abs().max())
        pad_zero = not bool(got[0][:, n:].any()) and not bool(got_cv[0][n:].any())
        numits_ok = (got[1].tolist() == [h_pd] * len(T_VALUES) and int(got_cv[1]) == h_cv)
        line = (f"[pd] {label} {shape}: K6b rows over {h_pd} it rel err {err_b:.2e}, x abs err "
                f"{xb:.2e}; K6d rows over {h_cv} it rel err {err_d:.2e}, x abs err {xd:.2e} "
                f"(K6d's plan, the launcher's too: route {plan['route']}, grid {plan['grid']}, "
                f"{plan['rows_per_cta']} rows a CTA, {plan['smem_bytes']} B of shared memory)")
        ok_a = True
        if not fac:
            t = T_VALUES[1]
            one = resident_pd.resident_adapdm_dsvm(q, lab, big_c, t, inp["norm_a"], -1.0, h_pd,
                                                   n_true=n)
            one_want = resident_pd.resident_adapdm_dsvm_plain(q, lab, big_c, t, inp["norm_a"],
                                                              -1.0, h_pd, n_true=n)
            xa = float((one[0] - one_want[0]).abs().max())
            ok_a = (int(one[1]) == h_pd and xa <= PD_RTOL * float(one_want[0].abs().max())
                    and not bool(one[0][n:].any()))
            line += f"; K6a (t={t}) x abs err {xa:.2e}"
            if "bf16" not in label:
                errs["k6a"] = max(errs["k6a"], xa)
        if "bf16" not in label:
            errs["k6b"], errs["k6d"] = max(errs["k6b"], xb), max(errs["k6d"], xd)
        print(f"{line} (tol {PD_RTOL:g}; CPU-calibrated horizons); padded coordinates stay 0: "
              f"{pad_zero}; two launches the same bits: {same} ({smi})", flush=True)
        check(numits_ok and same and pad_zero and ok_a and err_b <= PD_RTOL
              and err_d <= PD_RTOL and xb <= PD_RTOL * float(want[0].abs().max())
              and xd <= PD_RTOL * float(want_cv[0].abs().max()),
              f"K6 {label} disagrees with its plain version")
    return errs


def mp_work(inp, trials, rows, hist_len):
    """(bytes, flops) of a K6c launch on ``inp``: Q or B read once, the labels and the
    couplings in, x, the stats and the five histories out; 2 N^2 flops a trial dense
    (Q x), 4 N d factored (B'x, then B (B'x)), for the ``trials`` the run took."""
    n, cols = inp["q"].shape
    moved = (inp["q"].element_size() * n * cols + 4 * n + 4 * rows + 4 * rows * n + 16 * rows
             + 20 * rows * hist_len)
    return moved, (4 * n * cols if inp["factored"] else 2 * n * n) * trials


def mp_trials(out):
    """The trials a recorded K6c (or plain) run took: the sum of its trial-count rows."""
    return int(out[5][3].sum())


def pd_phase(resident, resident_pd, resident_mp, ref, counting, dev, smi):
    """Phase 11: K6b's rows bit for bit against their one-row and K6a launches, with the
    couplings reversed and twice over; dual_svm --resident
    at its defaults on the three stand-ins x C 0.1 and 1 (one K6b, one K6c and one K6d
    launch each, every row's x in the box and |y'x| within its bound), the K6b, K6c and
    K6d times on each; K6a's own path (one solve, counted); the engine path at
    --maxit PD_ENGINE_MAXIT; the PD iteration beside K2's. Returns the kernels line's
    measurements and the driver's K6c calls."""
    from adaprox_tpu_torch.experiments import dual_svm
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    zero_counts, read_counts = counting
    k6 = (resident_pd.resident_adapdm_dsvm, resident_pd.resident_adapdm_dsvm_sweep,
          resident_pd.resident_cv_dsvm, resident_mp.resident_mp_dsvm_sweep)

    def k6_counts():
        """Launches of (K6a, K6b, K6d, K6c) since zero_counts()."""
        return tuple(f.launches for f in k6)

    t_values = dual_svm.T_VALUES
    # K6b's rows against their one-row (and K6a) launches, reversed and twice over
    k6_rows_checks("pd", "adapdm", resident_pd.resident_adapdm_dsvm_sweep, lambda na: na,
                   resident_pd, dev, smi, single=resident_pd.resident_adapdm_dsvm)

    # dual_svm --resident at its defaults: each (dataset, C) one K6b and one K6d launch
    # and nothing else; the kernels' x captured from the driver's own calls
    captured = {}
    real_sweep, real_cv = dual_svm.resident_adapdm_dsvm_sweep, dual_svm.resident_cv_dsvm
    real_mp = dual_svm.resident_mp_dsvm_sweep

    def mp_capture(*args, **kw):
        out = real_mp(*args, **kw)
        captured["mp"] = (args, kw, out)
        return out

    def sweep_capture(*args, **kw):
        out = real_sweep(*args, **kw)
        captured["sweep"] = (args, kw, out)
        return out

    def cv_capture(*args, **kw):
        out = real_cv(*args, **kw)
        captured["cv"] = (args, kw, out)
        return out

    meas = {}
    names = ([f"AdaPDM (t={t})" for t in t_values] + [f"Malitsky-Pock (t={t})" for t in t_values]
             + ["Condat-Vu"])
    dual_svm.resident_adapdm_dsvm_sweep, dual_svm.resident_cv_dsvm = sweep_capture, cv_capture
    dual_svm.resident_mp_dsvm_sweep = mp_capture
    try:
        for name in PD_DATASETS:
            for big_c in (0.1, 1.0):
                outdir = os.path.join("results", "chip_smoke", "dual_svm")
                zero_counts()
                dual_svm.main(["--resident", "--datasets", name, "--C", str(big_c), "--device",
                               "cuda", "--outdir", outdir, "--no-plot"])
                torch.cuda.synchronize()
                counts, others = k6_counts(), read_counts()
                rows = read_jsonl(os.path.join(outdir, f"{name}_C_{big_c}.jsonl"))
                order = list(dict.fromkeys(r["method"] for r in rows if "it" in r))
                keys_ok = all(list(r) == dual_svm.KEYS for r in rows if "it" in r)
                meta = rows[-2]
                s_args, s_kw, s_out = captured["sweep"]
                c_args, c_kw, c_out = captured["cv"]
                m_args, m_kw, m_out = captured["mp"]
                xs = torch.cat([s_out[0], c_out[0][None]]).cpu()
                conv = s_out[3].tolist() + [bool(c_out[3])]
                numits = s_out[1].tolist() + [int(c_out[1])]
                n = s_kw["n_true"]
                y = torch.as_tensor(dual_svm.load(name)[1], dtype=torch.float64)
                yx = (xs[:, :n].double() @ y).abs()
                # the clamp's upper end is C in f32 (0.1 rounds up to 0.10000000149)
                box = bool((xs >= 0).all() and (xs <= torch.tensor(big_c)).all()
                           and not xs[:, n:].any())
                yx_bound = PD_YX_BOUND[(name, big_c)]
                yx_ok = all(v <= (PD_CONVERGED_YX if c else yx_bound)
                            for v, c in zip(yx.tolist(), conv))
                # the Malitsky-Pock rows: x in the box, |y'x| within its own bound
                xm = m_out[0].cpu()
                yx_mp = (xm[:, :n].double() @ y).abs()
                box_mp = bool((xm >= 0).all() and (xm <= torch.tensor(big_c)).all()
                              and not xm[:, n:].any())
                mp_bound = MP_YX_BOUND[(name, big_c)]
                mp_ok = (box_mp and not bool(m_out[4].any())
                         and all(v <= (PD_CONVERGED_YX if c else mp_bound)
                                 for v, c in zip(yx_mp.tolist(), m_out[3].tolist())))
                # the CUDA-event times of the two launches on the driver's own inputs (the
                # driver's run loaded the library: one call each)
                sweep_ms, _ = once_ms(lambda: real_sweep(*s_args, **s_kw))
                cv_ms, _ = once_ms(lambda: real_cv(*c_args, **c_kw))
                mp_ms, _ = once_ms(lambda: real_mp(*m_args, **m_kw))
                mp_numits = m_out[1].tolist()
                inp = dict(q=s_args[0], factored=s_kw["factored"])
                form = f"{'factored B' if inp['factored'] else 'dense Q'} {tuple(inp['q'].shape)}"
                hl = resident_pd.hist_len(10000)
                b_sweep = bound(*pd_work(inp, numits[:-1], hl, len(t_values)))
                b_cv = bound(*pd_work(inp, numits[-1:], hl, 1))
                b_mp = bound(*mp_work(inp, mp_trials(m_out), len(t_values), hl))
                yx_conv = max([v for v, c in zip(yx.tolist(), conv) if c], default=0.0)
                meas[(name, big_c)] = dict(counts=counts, sweep_ms=sweep_ms, cv_ms=cv_ms,
                                           bound_sweep=b_sweep, bound_cv=b_cv, numits=numits,
                                           args=(s_args, s_kw, c_args, c_kw), mp_ms=mp_ms,
                                           bound_mp=b_mp, mp=(m_args, m_kw, m_out))
                print(f"[pd] dual_svm --resident {name} C {big_c:g} ({form} f32, maxit 10000, "
                      f"tol 1e-5): numit {numits}, converged {sum(conv)} of 13; max |y'x| of the "
                      f"converged rows {yx_conv:.2e} (bound {PD_CONVERGED_YX:g}), of all "
                      f"{float(yx.max()):.2e} (bound {yx_bound:g}); "
                      f"x in [0, C], padded 0: {box} | Malitsky-Pock (K6c, exact Bregman) numit "
                      f"{mp_numits}, converged {int(m_out[3].sum())} of 12, ls_failed "
                      f"{int(m_out[4].sum())}, max |y'x| {float(yx_mp.max()):.2e} (bound "
                      f"{mp_bound:g}, converged rows {PD_CONVERGED_YX:g}), x in [0, C], padded 0: "
                      f"{box_mp} | K6a/K6b/K6d/K6c launches {counts}, others {others} | K6b "
                      f"sweep {sweep_ms:.4f} ms (bound {b_sweep[0]:.4f} ms, {b_sweep[1]}; the "
                      f"cooperative kernel's {K6_COOPERATIVE_MS[(name, big_c)][0]:.2f}), K6c "
                      f"sweep {mp_ms:.4f} ms ({mp_trials(m_out)} trials; bound {b_mp[0]:.4f} ms, "
                      f"{b_mp[1]}; the cooperative kernel's "
                      f"{K6_COOPERATIVE_MS[(name, big_c)][1]:.2f}), K6d {cv_ms:.4f} ms (bound "
                      f"{b_cv[0]:.4f} ms; two or three grid syncs an iteration: "
                      f"{K6D_TWO_SYNC_MS[(name, big_c)]:.2f}) | fast_methods "
                      f"{meta['fast_methods']} | wall_s {meta['wall_s']} ({smi})", flush=True)
                check(counts == (0, 1, 1, 1) and others == (0,) * 7 and order == names and keys_ok
                      and meta["fast_path"] == "resident"
                      and meta["fast_methods"] == JAX_DSVM_FAST_METHODS and box and yx_ok
                      and mp_ok and list(meta["wall_s"]) == JAX_DSVM_FAST_METHODS
                      and all(math.isfinite(r["norm_res"]) for r in rows if "it" in r),
                      f"dual_svm --resident {name} C {big_c}: bad run")
    finally:
        dual_svm.resident_adapdm_dsvm_sweep, dual_svm.resident_cv_dsvm = real_sweep, real_cv
        dual_svm.resident_mp_dsvm_sweep = real_mp

    # the plain versions on heart_scale C 0.1, the kernels line's case (one call each):
    # the sweep's cut to PD_PLAIN_CUT iterations beside K6b's at the same depth (at the
    # driver's 10000 it took 52-66 s, a host sync an iteration), Condat-Vu's in full
    s_args, s_kw, c_args, c_kw = meas[("heart_scale", 0.1)]["args"]
    cut_args = s_args[:-1] + (PD_PLAIN_CUT,)
    plain_sweep_ms, _ = once_ms(lambda: resident_pd.resident_adapdm_dsvm_sweep_plain(*cut_args,
                                                                                     **s_kw))
    cut_sweep_ms = event_ms(lambda: resident_pd.resident_adapdm_dsvm_sweep(*cut_args, **s_kw),
                            reps=3)
    plain_cv_ms, _ = once_ms(lambda: resident_pd.resident_cv_dsvm_plain(*c_args, **c_kw))
    print(f"[pd] plain versions on the card, heart_scale C 0.1: the sweep cut to maxit "
          f"{PD_PLAIN_CUT} {plain_sweep_ms:.2f} ms (K6b there {cut_sweep_ms:.4f} ms), Condat-Vu "
          f"at the driver's defaults {plain_cv_ms:.2f} ms ({smi})", flush=True)

    # K6a's own path: one AdaPDM solve on heart_scale C 0.1 (t = 0.15, which converges),
    # counted, as a user calls it
    q, lab, _, _, na, tol, maxit = s_args
    t_v, n = 0.15, s_kw["n_true"]
    zero_counts()
    one = resident_pd.resident_adapdm_dsvm(q, lab, 0.1, t_v, na, tol, maxit, n_true=n)
    torch.cuda.synchronize()
    single = k6_counts()
    check(single == (1, 0, 0, 0) and read_counts() == (0,) * 7,
          f"K6a single solve: launches {single}")
    k6a_s, one = timed(lambda: resident_pd.resident_adapdm_dsvm(q, lab, 0.1, t_v, na, tol, maxit,
                                                                n_true=n), reps=3)
    k6a_plain_ms, one_plain = once_ms(lambda: resident_pd.resident_adapdm_dsvm_plain(
        q, lab, 0.1, t_v, na, tol, maxit, n_true=n))
    k6a_bound = bound(*pd_work(dict(q=q, factored=False), [int(one[1])], 0, 1))
    print(f"[pd] K6a heart_scale C 0.1 t {t_v} tol 1e-5: solve {1e3 * k6a_s:.4f} ms (CUDA events, "
          f"best of 3), numit {int(one[1])} (plain {int(one_plain[1])}), converged {bool(one[3])} "
          f"| plain {k6a_plain_ms:.2f} ms | bound {k6a_bound[0]:.5f} ms ({k6a_bound[1]}) | "
          f"launches {single} ({smi})", flush=True)
    check(bool(one[3]) and not bool(one[0][n:].any()), "K6a single solve: not converged")

    # the engine path, depth cut to --maxit PD_ENGINE_MAXIT (it syncs every iteration): no
    # K6 launch
    outdir = os.path.join("results", "chip_smoke", "dual_svm_engine")
    zero_counts()
    dual_svm.main(["--datasets", "heart_scale,svmguide3", "--maxit", str(PD_ENGINE_MAXIT),
                   "--device", "cuda", "--outdir", outdir, "--no-plot"])
    torch.cuda.synchronize()
    counts, others = k6_counts(), read_counts()
    for name in ("heart_scale", "svmguide3"):
        for big_c in (0.1, 1.0):
            rows = read_jsonl(os.path.join(outdir, f"{name}_C_{big_c}.jsonl"))
            last = {r["method"]: r for r in rows if "it" in r}
            res = ", ".join(f"{r['norm_res']:.3e}" for r in last.values())
            print(f"[pd] dual_svm {name} C {big_c:g} --maxit {PD_ENGINE_MAXIT} (engine path, "
                  f"depth cut from 10000) f32: numit {[r['it'] for r in last.values()]}, "
                  f"norm_res {res} | K6 "
                  f"launches {counts}, others {others} | wall_s {rows[-2]['wall_s']} ({smi})",
                  flush=True)
            check(list(last) == names and all(math.isfinite(r["norm_res"]) for r in last.values())
                  and counts == (0, 0, 0, 0) and others == (0,) * 7,
                  f"dual_svm engine path {name} C {big_c}: bad run")

    # the PD iteration: tol -1, 1000 iterations, one-row K6b launches (f32 and bf16, with
    # their layouts) at the driver's three shapes, and K6d's, beside K2's fixed-rule
    # iteration at 4096x1024 and 8x2176 in the same call
    pd_us = k6_iterations("pd", "adapdm", resident_pd.resident_adapdm_dsvm_sweep, lambda na: na,
                          resident_pd, dev, smi)
    us = {}
    for name in ("svmguide3", "heart_scale", "mushrooms"):
        inp = pd_inputs(name, 0.1, dev)
        q, lab, n, fac = inp["q"], inp["lab"], inp["n"], inp["factored"]
        shape = f"{'B' if fac else 'Q'} {q.shape[0]}x{q.shape[1]}"
        secs, res = timed(lambda: resident_pd.resident_cv_dsvm(
            q, lab, 0.1, inp["gamma"], inp["sigma"], -1.0, 1000, n_true=n, factored=fac), reps=3)
        check(int(res[1]) == 1000, f"K6d {shape}: not 1000 iterations")
        us[f"K6d {shape}"] = 1e3 * secs
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for m_, n_ in ((4096, 1024), (8, 2176)):
        if (m_, n_) == (4096, 1024):
            a_, b_ = ref["a"], ref["b"]
        else:
            a_ = torch.randn(m_, n_, generator=gen, device=dev) / n_
            b_ = torch.randn(m_, generator=gen, device=dev)
        gam_ = 1.0 / float((a_ * a_).sum())
        x0_ = torch.zeros(n_, device=dev)
        secs, res = timed(lambda: resident.resident_adapgm(
            a_, b_, x0_, gam_, 0.0, 1000, prox_kind="zero", rule_kind="fixed"), reps=3)
        check(int(res[1]) == 1000, f"K2 {m_}x{n_}: not 1000 iterations")
        us[f"K2 fixed {m_}x{n_}"] = 1e3 * secs
    print(f"[pd] iteration, 1000 iterations, tol -1, f32: "
          f"{'; '.join(f'{k} {v:.3f} us' for k, v in us.items())} (K6d with two or three grid "
          f"syncs an iteration: "
          f"{'; '.join(f'{k} {v:.3f} us' for k, v in K6D_TWO_SYNC_US.items())}) ({smi})",
          flush=True)

    case = meas[("heart_scale", 0.1)]
    return dict(
        k6a=dict(launches=single[0], ms=1e3 * k6a_s, plain_ms=k6a_plain_ms, bound=k6a_bound),
        k6b=dict(launches=case["counts"][1], ms=case["sweep_ms"], plain_ms=plain_sweep_ms,
                 bound=case["bound_sweep"], cut_ms=cut_sweep_ms),
        k6d=dict(launches=case["counts"][2], ms=case["cv_ms"], plain_ms=plain_cv_ms,
                 bound=case["bound_cv"]),
        k6c=dict(launches=case["counts"][3], driver_bound=case["bound_mp"]),
        pd_us=pd_us, driver={k: (v["sweep_ms"], v["mp_ms"]) for k, v in meas.items()}), {
            k: v["mp"] for k, v in meas.items()}


def mp_rows_err(got, want, horizon):
    """(trial counts equal over ``horizon``, the largest error of the gamma, sigma and
    norm_res rows there relative to each plain row's largest magnitude)."""
    same = torch.equal(got[3][:, :horizon], want[3][:, :horizon])
    return same, pd_rows_err(got[:3], want[:3], horizon)


def mp_checks(resident_mp, dev, smi):
    """Phase 12, K6c against its plain version on the card, on the dual_svm driver's
    inputs: svmguide3's dense 1280^2, heart_scale's 384^2 (f32 and bf16 Q) and mushrooms'
    factored 8192x128 (f32 and bf16 B), C 0.1 and 1, the exact Bregman form and the raw
    one; tol -1 and MP_CUT iterations: the trial counts equal and gamma, sigma, norm_res
    within MP_RTOL over MP_HORIZON, the objective at the end within MP_OBJ_RTOL, the
    padded coordinates exactly 0, two launches the same bits. Returns the largest |x|
    error after MP_HORIZON iterations (f32 cases)."""
    from adaprox_tpu_torch.experiments.dual_svm import T_VALUES

    cases = []
    for name in PD_DATASETS:
        for big_c in (0.1, 1.0):
            cases.append((f"{name} C {big_c:g}", pd_inputs(name, big_c, dev)))
    for name in ("heart_scale", "mushrooms"):
        inp = dict(pd_inputs(name, 0.1, dev))
        inp["q"] = inp["q"].to(torch.bfloat16)
        cases.append((f"{name} C 0.1 bf16", inp))
    x_err = 0.0
    for label, inp in cases:
        q, lab, n, fac, big_c = inp["q"], inp["lab"], inp["n"], inp["factored"], inp["big_c"]
        shape = f"{'B' if fac else 'Q'} {q.shape[0]}x{q.shape[1]}"
        parts = []
        ok = True
        for exact in (True, False):
            kw = dict(n_true=n, record=True, factored=fac, exact_bregman=exact)
            args = (q, lab, big_c, T_VALUES, 1.0 / inp["norm_a"], -1.0)
            got = resident_mp.resident_mp_dsvm_sweep(*args, MP_CUT, **kw)
            again = resident_mp.resident_mp_dsvm_sweep(*args, MP_CUT, **kw)
            want = resident_mp.resident_mp_dsvm_sweep_plain(*args, MP_CUT, **kw)
            short = resident_mp.resident_mp_dsvm_sweep(*args, MP_HORIZON, **kw)
            short_want = resident_mp.resident_mp_dsvm_sweep_plain(*args, MP_HORIZON, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(u, w) for u, w in zip(flat_out(got), flat_out(again)))
            trials_ok, err = mp_rows_err(got[5], want[5], MP_HORIZON)
            xe = float((short[0] - short_want[0]).abs().max())
            x_ok = xe <= MP_RTOL * float(short_want[0].abs().max())
            obj = float(((got[5][4][:, -1] - want[5][4][:, -1]).abs()
                         / want[5][4][:, -1].abs()).max())
            pad_zero = not bool(got[0][:, n:].any())
            numits_ok = got[1].tolist() == [MP_CUT] * len(T_VALUES)
            mean_trials = float(got[5][3].mean())
            if exact and "bf16" not in label:
                x_err = max(x_err, xe)
            parts.append(f"{'exact' if exact else 'raw'}: trial counts equal over "
                         f"{MP_HORIZON} it {trials_ok}, rows rel err {err:.2e}, x abs err "
                         f"{xe:.2e}; objective after {MP_CUT} it rel err {obj:.2e} (tol "
                         f"{MP_OBJ_RTOL:g}); {mean_trials:.3f} trials an iteration "
                         f"(plain {float(want[5][3].mean()):.3f}); padded 0: {pad_zero}; "
                         f"two launches the same bits: {same}")
            ok &= (trials_ok and err <= MP_RTOL and x_ok and obj <= MP_OBJ_RTOL and pad_zero
                   and same and numits_ok)
        print(f"[mp] K6c {label} {shape} (tol {MP_RTOL:g}; CPU-calibrated horizon): "
              f"{' | '.join(parts)} ({smi})", flush=True)
        check(ok, f"K6c {label} disagrees with its plain version")
    return x_err


def mp_phase(resident_pd, resident_mp, driver_mp, pd_us, counting, dev, smi):
    """Phase 12: every row of the driver's K6c sweeps (phase 11) bit for bit against
    its one-row launch, and at C 0.1 in f32 and bf16 with the couplings reversed and
    twice over; the large-|f| f32 instance; the MP iteration beside K6's PD iteration
    (``pd_us``, phase 11's); the K6c sweep and its plain version timed at a cut depth on
    one driver input. Returns the kernels line's measurements."""
    zero_counts, read_counts = counting
    # each row of the driver's sweep at its defaults is its one-row launch, bit for bit
    for (name, big_c), (args, kw, out) in sorted(driver_mp.items()):
        q, lab, _, ts, sigma0, tol, maxit = args
        same = True
        for j, t in enumerate(ts):
            one = resident_mp.resident_mp_dsvm_sweep(q, lab, big_c, [t], sigma0, tol, maxit, **kw)
            same &= all(torch.equal(u[0], w[j]) for u, w in zip(one[:5], out[:5]))
            same &= all(torch.equal(u[0], w[j]) for u, w in zip(one[5], out[5]))
        print(f"[mp] K6c rows bit for bit against one-row launches, dual_svm --resident "
              f"{name} C {big_c:g} (tol {tol:g}, maxit {maxit}, numit {out[1].tolist()}): "
              f"{same} ({smi})", flush=True)
        check(same, f"K6c rows on {name} C {big_c} differ from their one-row launches")
    k6_rows_checks("mp", "mp", resident_mp.resident_mp_dsvm_sweep, lambda na: 1 / na, resident_pd,
                   dev, smi, exact_bregman=True)

    # the large-|f| f32 instance (the JAX suite's tests/test_solvers.py: 256 points, B
    # 256x16 times 2, t 0.15, tol 1e-5, maxit 1500): the exact form beats the raw one
    rng = np.random.default_rng(1)
    bmat = rng.standard_normal((256, 16)) * 2.0
    labels = np.where(rng.standard_normal(256) > 0, 1.0, -1.0)
    bmat *= labels[:, None]
    q_l = torch.as_tensor(np.pad(bmat, ((0, 0), (0, 112))), dtype=torch.float32, device=dev)
    lab_l = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    na_l = float(np.linalg.norm(labels))
    large = {eb: resident_mp.resident_mp_dsvm_sweep(q_l, lab_l, 0.1, [0.15], 1 / na_l, 1e-5, 1500,
                                                    n_true=256, factored=True, exact_bregman=eb)
             for eb in (True, False)}
    res = {eb: float(o[2][0]) for eb, o in large.items()}
    print(f"[mp] large-|f| f32 (B 256x16 x 2, t 0.15, tol 1e-5, maxit 1500): exact form "
          f"norm_res {res[True]:.3e} at {int(large[True][1][0])} it, raw form {res[False]:.3e} "
          f"at {int(large[False][1][0])} it ({smi})", flush=True)
    check(res[True] < res[False] / 10 or res[True] <= 1e-5,
          "large-|f|: the exact form does not beat the raw one")

    # the MP iteration: tol -1, 1000 iterations, one-row K6c launches (t 0.5, exact form), with
    # its mean trials an iteration and its layout, beside K6's PD iteration (phase 11)
    mp_us = k6_iterations("mp", "mp", resident_mp.resident_mp_dsvm_sweep, lambda na: 1 / na,
                          resident_pd, dev, smi, exact_bregman=True)
    print(f"[mp] iteration beside the PD's (phase 11), us, MP / PD: "
          f"{'; '.join(f'{k} {v:.3f} / {pd_us[k]:.3f}' for k, v in mp_us.items())} ({smi})",
          flush=True)

    # the K6c sweep and its plain version at a cut depth (the plain version syncs the
    # host every trial) on heart_scale C 0.1, the driver's inputs, tol 1e-5: the
    # kernels line's case; K6c counted on its own call
    args, kw, _ = driver_mp[("heart_scale", 0.1)]
    args = args[:-1] + (MP_CUT,)
    zero_counts()
    cut = resident_mp.resident_mp_dsvm_sweep(*args, **kw)
    torch.cuda.synchronize()
    launches = resident_mp.resident_mp_dsvm_sweep.launches
    check(launches == 1 and read_counts() == (0,) * 7, f"K6c cut-depth sweep: {launches}")
    ms, cut = once_ms(lambda: resident_mp.resident_mp_dsvm_sweep(*args, **kw))
    plain_ms, cut_plain = once_ms(lambda: resident_mp.resident_mp_dsvm_sweep_plain(*args, **kw))
    trials_ok, err = mp_rows_err(cut[5], cut_plain[5], MP_HORIZON)
    inp = dict(q=args[0], factored=kw["factored"])
    b_cut = bound(*mp_work(inp, mp_trials(cut), len(args[3]), resident_pd.hist_len(MP_CUT)))
    print(f"[mp] K6c sweep vs its plain version, heart_scale C 0.1 (dense Q 384x384 f32, "
          f"exact form, tol 1e-5, depth cut from 10000 to maxit {MP_CUT}): numit "
          f"{cut[1].tolist()} (plain {cut_plain[1].tolist()}), {mp_trials(cut)} trials; K6c "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms (one call each, CUDA events); bound "
          f"{b_cut[0]:.5f} ms ({b_cut[1]}); trial counts equal over {MP_HORIZON} it "
          f"{trials_ok}, rows rel err {err:.2e} ({smi})", flush=True)
    check(trials_ok and err <= MP_RTOL, "K6c cut-depth sweep disagrees with its plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound=b_cut, it_us=mp_us)


def f0_inputs(name, dev, dtype=torch.float32):
    """The square-root lasso driver's resident inputs for dataset ``name`` (its
    synthetic stand-in) on ``dev``: A = [X 1] and y zero-padded to multiples of 128 in
    ``dtype``, the unpadded column count, and Condat-Vu's steps (Lf = 0)."""
    from adaprox_tpu_torch.convert import sqrt_lasso_from_numpy
    from adaprox_tpu_torch.experiments import square_root_lasso

    x, y, _ = square_root_lasso.load(name)
    _, _, h, a_op, norm_a = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=dev, dtype=dtype)
    a, bv = square_root_lasso.resident_inputs(a_op.a, -h.b)
    gamma, sigma = square_root_lasso.cv_steps(norm_a)
    return dict(a=a, bv=bv, n=x.shape[1] + 1, gamma=gamma, sigma=sigma, lam=10.0, norm_a=norm_a)


def f0_rows_err(got, want):
    """The largest error of the two history rows over their common prefix, each
    relative to its plain row's largest magnitude there."""
    k = min(int(got[1]), int(want[1]))
    return max(float((u[:k] - w[:k]).abs().max() / w[:k].abs().max())
               for u, w in zip(got[4], want[4]))


def f0_final_obj(out):
    return float(out[4][1][int(out[1]) - 1])


def f0_checks(resident_f0, dev, smi):
    """Phase 13, K7d against its plain version on the card on the square-root lasso
    driver's padded inputs: the three stand-ins, l2 and l1, A f32 and bf16, at tol -1
    and at tol 1e-5 (maxit 5000): the histories over their common prefix, x and the
    final objective within CPU-calibrated bounds, the padded coordinates exactly 0, two
    launches the same bits. Returns the largest |x| error on the f32 cases."""
    x_abs = 0.0
    for name in F0_DATASETS:
        inp = f0_inputs(name, dev)
        for h_kind in resident_f0.H_KINDS:
            for dtype in (torch.float32, torch.bfloat16):
                a, bv, n = inp["a"].to(dtype), inp["bv"], inp["n"]
                parts = []
                ok = True
                want = None
                for tol in (-1.0, 1e-5):
                    args = (a, bv, inp["lam"], inp["gamma"], inp["sigma"], tol, 5000)
                    got = resident_f0.resident_condat_vu(*args, record=True, h_kind=h_kind)
                    again = resident_f0.resident_condat_vu(*args, record=True, h_kind=h_kind)
                    # the plain run at tol 1e-5 is the tol -1 run itself where that run's
                    # residual never fell to the tol (the plain loop stops only there)
                    if want is None or not bool(
                            (want[4][0] > torch.tensor(tol, dtype=want[4][0].dtype)).all()):
                        want = resident_f0.resident_condat_vu_plain(*args, record=True,
                                                                    h_kind=h_kind)
                    torch.cuda.synchronize()
                    same = (all(torch.equal(u, w) for u, w in zip(got[:4], again[:4]))
                            and all(torch.equal(u, w) for u, w in zip(got[4], again[4])))
                    err = f0_rows_err(got, want)
                    dx = float((got[0] - want[0]).abs().max())
                    x_err = dx / float(want[0].abs().max())
                    obj_err = abs(f0_final_obj(got) - f0_final_obj(want)) / abs(
                        f0_final_obj(want))
                    pad_zero = not bool(got[0][n:].any())
                    finite = bool(torch.isfinite(got[0]).all()) and math.isfinite(float(got[2]))
                    numit_ok = tol > 0 or int(got[1]) == int(want[1]) == 5000
                    parts.append(f"tol {tol:g}: numit {int(got[1])} (plain {int(want[1])}), "
                                 f"converged {bool(got[3])} (plain {bool(want[3])}), rows rel "
                                 f"err {err:.2e}, x rel err {x_err:.2e}, final objective rel "
                                 f"err {obj_err:.2e}, padded 0 {pad_zero}, same bits {same}")
                    ok &= (same and pad_zero and finite and numit_ok and err <= K7D_RTOL
                           and x_err <= K7D_X_RTOL and obj_err <= K7D_OBJ_RTOL)
                    if dtype == torch.float32:
                        x_abs = max(x_abs, dx)
                label = f"{name} {tuple(a.shape)} {h_kind} {str(dtype).removeprefix('torch.')}"
                print(f"[f0] K7d vs plain, {label}, maxit 5000: {'; '.join(parts)} (bounds rows "
                      f"{K7D_RTOL:g}, x {K7D_X_RTOL:g}, objective {K7D_OBJ_RTOL:g}; "
                      f"CPU-calibrated) ({smi})", flush=True)
                check(ok, f"K7d {label} disagrees with its plain version")
    return x_abs


def k7a_cores(resident_f0):
    """{label: (kernel entry, plain version, p2 of the drivers' call from ||A||_F)}."""
    return {"MP": (resident_f0.resident_mpls_sweep, resident_f0.resident_mpls_sweep_plain,
                   lambda norm_a: 1.0),
            "AdaPDM+": (resident_f0.resident_adapdmp_sweep,
                        resident_f0.resident_adapdmp_sweep_plain, lambda norm_a: norm_a)}


K7A_ROWS = (0, 1, 2, 4)  # gamma, sigma, norm_res and the objective of the five histories


def k7a_rows_err(got, want, horizon):
    """The largest error of the gamma, sigma, norm_res and objective rows of a sweep over
    ``horizon`` iterations, each relative to its plain row's largest magnitude there."""
    return max(float(((got[k][:, :horizon] - want[k][:, :horizon]).abs().amax(1)
                      / want[k][:, :horizon].abs().amax(1)).max()) for k in K7A_ROWS)


def cell_rel(got, want):
    """The largest error over the rows (cells) of a stacked x or history, each relative to
    its plain row's largest magnitude (absolute where that row is all zero)."""
    scale = want.abs().amax(-1)
    return float(((got - want).abs().amax(-1) / torch.where(scale > 0, scale,
                                                            torch.ones_like(scale))).max())


def k7a_work(a, numits, trials, count, hist_len):
    """(bytes, flops) of a K7a sweep of ``count`` rows: A and A' read once, bv and the t
    values in, x, the stats and the five histories out; 2mn flops a trial (MP's A x,
    AdaPDM+'s A'y') and 2mn an iteration (MP's A'y, AdaPDM+'s A x)."""
    m, n = a.shape
    moved = 2 * a.element_size() * m * n + 4 * m + 4 * count + count * (4 * n + 16 + 20 * hist_len)
    return moved, 2 * m * n * (numits + trials)


def k7a_trials(out):
    return int(out[5][3].sum())


def cluster_layout(resident_f0, a, core, cells):
    """How K7a/K7b lay out ``cells`` cells of ``core`` over A (or a stack): the cluster size,
    the clusters that run at once, the shared memory a CTA, and whether A is whole on
    chip (the rows a CTA holds of those it owns)."""
    p = resident_f0.f0_grid_plan(a, "mp" if core == "MP" else "adapdmp", cells)
    return (f"C {p['cluster']}, {p['clusters']} clusters at once, {p['smem_bytes']} B shared "
            f"a CTA, rows held {p['rows_held']}/{p['rows_per_cta']} a CTA, A whole on chip "
            f"{p['whole']}")


def k7a_checks(resident_f0, dev, smi):
    """Phase 13, K7a against its plain version on the card on the square-root lasso
    driver's padded inputs: both cores, the three stand-ins, l2 and l1, A f32 and bf16, the
    couplings K7A_TS at tol -1: the trial counts and ls_failed equal and the rows within
    K7A_RTOL over K7A_HORIZON, x within K7A_X_RTOL there, the objective after K7A_CUT
    within K7A_OBJ_RTOL, the padded coordinates exactly 0, two launches the same bits, the
    t = 1 row equal to its one-row launch; then one converged case a core with each inner
    norm: l2 at the drivers' tol 1e-5, l1 at K7A_L1_TOL (no f32 l1 row reaches 1e-5), the
    final objectives within a calibrated bound. Returns the largest |x| error over the
    horizon on the f32 cases."""
    from adaprox_tpu_torch.experiments.k7a_calibration import (
        K7A_CUT, K7A_DRIVER_OBJ_RTOL, K7A_HORIZON, K7A_L1_OBJ_RTOL, K7A_L1_TOL, K7A_L1_TS,
        K7A_OBJ_RTOL, K7A_RTOL, K7A_TS, K7A_X_RTOL)

    x_abs = 0.0
    hz = K7A_HORIZON
    flat = lambda out: list(out[:5]) + list(out[5])  # noqa: E731
    for name in F0_DATASETS:
        inp = f0_inputs(name, dev)
        for h_kind in resident_f0.H_KINDS:
            for dtype in (torch.float32, torch.bfloat16):
                a, bv, n = inp["a"].to(dtype), inp["bv"], inp["n"]
                parts, ok = [], True
                for core, (kernel, plain, p2_of) in k7a_cores(resident_f0).items():
                    kw = dict(record=True, h_kind=h_kind)
                    args = (a, bv, inp["lam"], K7A_TS, p2_of(inp["norm_a"]), -1.0)
                    got = kernel(*args, K7A_CUT, **kw)
                    again = kernel(*args, K7A_CUT, **kw)
                    one = kernel(a, bv, inp["lam"], [1.0], args[4], -1.0, K7A_CUT, **kw)
                    rev = kernel(a, bv, inp["lam"], K7A_TS[::-1], args[4], -1.0, K7A_CUT, **kw)
                    want = plain(*args, K7A_CUT, **kw)
                    short = kernel(*args, hz, **kw)
                    short_want = plain(*args, hz, **kw)
                    torch.cuda.synchronize()
                    same = all(torch.equal(u, w) for u, w in zip(flat(got), flat(again)))
                    j = K7A_TS.index(1.0)
                    row_same = all(torch.equal(u[0], w[j]) for u, w in zip(flat(one), flat(got)))
                    rev_same = all(torch.equal(u, w.flip(0)) for u, w in zip(flat(rev), flat(got)))
                    trials_ok = (torch.equal(got[5][3][:, :hz], want[5][3][:, :hz])
                                 and torch.equal(short[4], short_want[4]))
                    err = k7a_rows_err(got[5], want[5], hz)
                    xe = cell_rel(short[0], short_want[0])
                    obj = float(((got[5][4][:, -1] - want[5][4][:, -1]).abs()
                                 / want[5][4][:, -1].abs()).max())
                    pad_zero = not bool(got[0][:, n:].any())
                    numits_ok = got[1].tolist() == want[1].tolist() == [K7A_CUT] * len(K7A_TS)
                    finite = all(bool(torch.isfinite(h).all()) for h in got[5][:3])
                    if dtype == torch.float32:
                        x_abs = max(x_abs, float((short[0] - short_want[0]).abs().max()))
                    parts.append(
                        f"{core}: trial counts and ls_failed equal over {hz} it {trials_ok}, "
                        f"rows rel err {err:.2e}, x rel err {xe:.2e}; objective after {K7A_CUT} "
                        f"it rel err {obj:.2e}; {float(got[5][3].mean()):.3f} trials an "
                        f"iteration (plain {float(want[5][3].mean()):.3f}); ls_failed "
                        f"{int(got[4].sum())}; gamma/sigma/norm_res finite {finite}; padded 0 "
                        f"{pad_zero}; same bits {same}; t 1 row = its one-row launch {row_same}; "
                        f"ts reversed = the rows reversed, bit for bit {rev_same}; "
                        f"{cluster_layout(resident_f0, a, core, len(K7A_TS))}")
                    ok &= (trials_ok and err <= K7A_RTOL and xe <= K7A_X_RTOL
                           and obj <= K7A_OBJ_RTOL and pad_zero and same and row_same
                           and rev_same and numits_ok and finite)
                label = f"{name} {tuple(a.shape)} {h_kind} {str(dtype).removeprefix('torch.')}"
                print(f"[f0] K7a vs plain, {label}, t {K7A_TS}, tol -1, maxit {K7A_CUT}: "
                      f"{' | '.join(parts)} (bounds rows {K7A_RTOL:g}, x {K7A_X_RTOL:g} over "
                      f"{hz} it, objective {K7A_OBJ_RTOL:g}; CPU-calibrated) ({smi})", flush=True)
                check(ok, f"K7a {label} disagrees with its plain version")
    # one converged case a core with each inner norm (housing_scale, f32, maxit 5000): l2 at
    # the drivers' tol 1e-5 and t 1; l1 at K7A_L1_TOL and a coupling K7A_L1_TS where the f32
    # row converges. Past the horizon the two trajectories part, but both converge, so their
    # final objectives are held as two converged runs are (the calibrated bounds).
    inp = f0_inputs("housing_scale", dev)
    for h_kind, tol, t_of, rtol in (
            ("l2", 1e-5, lambda core: 1.0, 2 * K7A_DRIVER_OBJ_RTOL["l2"]),
            ("l1", K7A_L1_TOL, lambda core: K7A_L1_TS["mp" if core == "MP" else "adapdmp"],
             K7A_L1_OBJ_RTOL)):
        parts, ok = [], True
        for core, (kernel, plain, p2_of) in k7a_cores(resident_f0).items():
            args = (inp["a"], inp["bv"], inp["lam"], [t_of(core)], p2_of(inp["norm_a"]), tol,
                    5000)
            kw = dict(record=True, h_kind=h_kind)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            f_got, f_want = (float(o[5][4][0][int(o[1][0]) - 1]) for o in (got, want))
            rel = abs(f_got - f_want) / abs(f_want)
            parts.append(f"{core} (t {t_of(core):g}): numit {int(got[1][0])} (plain "
                         f"{int(want[1][0])}), converged {bool(got[3][0])} (plain "
                         f"{bool(want[3][0])}), final objective rel err {rel:.2e}")
            ok &= bool(got[3][0]) and bool(want[3][0]) and rel <= rtol
        print(f"[f0] K7a vs plain at tol {tol:g}, housing_scale (512, 128) {h_kind} f32, maxit "
              f"5000: {'; '.join(parts)} (bound {rtol:g}: calibrated on two converged runs) "
              f"({smi})", flush=True)
        check(ok, f"K7a at tol {tol:g} ({h_kind}) disagrees with its plain version")
    return x_abs


def f0_work(a, numit, hist_len):
    """(bytes, flops) of a K7d solve: A read once, bv in, x, the stats and the two
    histories out; 4 m n flops an iteration (A x and A'y)."""
    m, n = a.shape
    return a.element_size() * m * n + 4 * m + 4 * n + 12 + 8 * hist_len, 4 * m * n * numit


def f0_phase(resident_f0, resident_pd, counting, dev, smi):
    """Phase 13: both drivers --resident on the three stand-ins (one K7d, one K7a MP and one
    K7a AdaPDM+ launch a dataset; the Condat-Vu row's and every converged t-sweep row's final
    objective against an f64 CPU run; the two sweeps timed by CUDA events), their engine
    paths, K7d and K7a timed against their plain versions, and the iterations beside K6d's.
    Returns the kernels line's measurements."""
    import importlib

    from adaprox_tpu_torch.experiments import resident_timing
    from adaprox_tpu_torch.experiments.k7a_calibration import (
        K7A_CUT, K7A_DRIVER_OBJ_RTOL, K7A_HORIZON, K7A_RTOL, K7A_TS)
    from adaprox_tpu_torch.ops import resident_mp
    from adaprox_tpu_torch.utils.logging import read_jsonl

    zero_counts, read_counts = counting
    cores = k7a_cores(resident_f0)
    records = {"MP": resident_mp.resident_mp_records,
               "AdaPDM+": resident_f0.resident_adapdmp_records}
    fams = {"MP": "Malitsky-Pock", "AdaPDM+": "AdaPDM+"}
    drivers = {d: importlib.import_module(f"adaprox_tpu_torch.experiments.{d}")
               for d in F0_DRIVERS}
    t_values = drivers["square_root_lasso"].T_VALUES
    names = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in t_values]
             + [f"AdaPDM+ (t={t})" for t in t_values])
    walls, total, sweep_ms, k7a_launches = {}, 0, {}, {core: 0 for core in cores}
    f_refs = {}  # (driver, dataset): the f64 CPU Condat-Vu's final objective (phase 14's too)
    for driver, mod in drivers.items():
        h_kind = "l2" if driver == "square_root_lasso" else "l1"
        outdir = os.path.join("results", "chip_smoke", driver)
        zero_counts()
        resident_f0.resident_mpls_sweep.launches = resident_f0.resident_adapdmp_sweep.launches = 0
        mod.main(["--resident", "--device", "cuda", "--outdir", outdir, "--no-plot"])
        torch.cuda.synchronize()
        launches = resident_f0.resident_condat_vu.launches
        mine = {core: kernel.launches for core, (kernel, _, _) in cores.items()}
        others = read_counts() + (resident_pd.resident_adapdm_dsvm.launches,
                                  resident_pd.resident_adapdm_dsvm_sweep.launches,
                                  resident_pd.resident_cv_dsvm.launches,
                                  resident_mp.resident_mp_dsvm_sweep.launches)
        total += launches
        for core in cores:
            k7a_launches[core] += mine[core]
        check(launches == len(F0_DATASETS) and list(mine.values()) == [len(F0_DATASETS)] * 2
              and others == (0,) * 11,
              f"{driver} --resident: {launches} K7d launches and K7a {mine} for "
              f"{len(F0_DATASETS)} datasets, other kernels {others}")
        parts = []
        for name in F0_DATASETS:
            rows = read_jsonl(os.path.join(outdir, f"{name}.jsonl"))
            by = {}
            for r in rows:
                if "norm_res" in r:
                    by.setdefault(r["method"], []).append(r)
            meta = rows[-2]
            check(list(by) == names and meta["fast_path"] == "resident"
                  and meta["fast_methods"] == JAX_F0_FAST_METHODS
                  and list(meta["wall_s"]) == JAX_F0_FAST_METHODS,
                  f"{driver} --resident {name}: rows {list(by)}, meta {meta}")
            walls[(driver, name)] = meta["wall_s"]
            cv = by["Condat-Vu"]
            # the driver's calls again, recorded: their numits and residuals are the rows',
            # and their final objectives are held against the plain Condat-Vu in f64 on the CPU
            inp = f0_inputs(name, dev)
            kw = dict(record=True, h_kind=h_kind)
            args = (inp["lam"], inp["gamma"], inp["sigma"], 1e-5, 5000)
            out = resident_f0.resident_condat_vu(inp["a"], inp["bv"], *args, **kw)
            inp64 = f0_inputs(name, "cpu", torch.float64)
            ref = resident_f0.resident_condat_vu_plain(inp64["a"], inp64["bv"], *args, **kw)
            f_ref = f_refs[(driver, name)] = f0_final_obj(ref)
            same_row = (int(out[1]) == len(cv) and float(out[2]) == cv[-1]["norm_res"]
                        and cv[-1]["A_evals"] == len(cv) + 1)
            obj_err = abs(f0_final_obj(out) - f_ref) / abs(f_ref)
            check(same_row and obj_err <= K7D_OBJ_RTOL,
                  f"{driver} --resident {name}: the Condat-Vu row disagrees")
            sweep_parts = []
            for core, (kernel, _, p2_of) in cores.items():
                fam = fams[core]
                sargs = (inp["a"], inp["bv"], inp["lam"], t_values, p2_of(inp["norm_a"]), 1e-5,
                         5000)
                ms, sw = once_ms(lambda: kernel(*sargs, **kw))
                b = bound(*k7a_work(inp["a"], int(sw[1].sum()), k7a_trials(sw), len(t_values),
                                    resident_pd.hist_len(5000)))
                sweep_ms[(driver, name, core)] = (ms, b)
                same, gaps, nonfinite = True, [], 0
                for i, t in enumerate(t_values):
                    rs = by[f"{fam} (t={t})"]
                    k = int(sw[1][i])
                    rec = records[core](sw[1][i], tuple(h[i] for h in sw[5]), maxit=5000)
                    same &= (k == len(rs) and float(rec.norm_res[k - 1]) == rs[-1]["norm_res"]
                             and float(rec.norm_res[k - 1]) == float(sw[2][i])
                             and int(rec.A_evals[k - 1]) == rs[-1]["A_evals"]
                             and int(rec.At_evals[k - 1]) == rs[-1]["At_evals"])
                    nonfinite += sum(int((~torch.isfinite(h[i][:k])).sum()) for h in sw[5][:3])
                    if bool(sw[3][i]):
                        gaps.append(abs(float(sw[5][4][i][k - 1]) - f_ref) / abs(f_ref))
                gap = max(gaps, default=0.0)
                old = F0_COOPERATIVE_MS[(driver, name)][0 if core == "MP" else 1]
                sweep_parts.append(
                    f"{fam} sweep {ms:.4f} ms (cooperative kernel, PR 13: {old:.2f} ms; "
                    f"{cluster_layout(resident_f0, inp['a'], core, len(t_values))}; bound "
                    f"{b[0]:.5f} ms, {b[1]}), numit "
                    f"{sw[1].tolist()}, {k7a_trials(sw)} trials, converged {int(sw[3].sum())}/15, "
                    f"ls_failed {int(sw[4].sum())}, non-finite gamma/sigma/norm_res {nonfinite}, "
                    f"converged rows' objective rel err <= {gap:.2e}, the recorded call is the "
                    f"rows: {same}")
                check(same and gap <= K7A_DRIVER_OBJ_RTOL[h_kind],
                      f"{driver} --resident {name}: the {fam} rows disagree (objective {gap})")
            parts.append(f"{name}: Condat-Vu numit {len(cv)} (f64 CPU {int(ref[1])}), norm_res "
                         f"{cv[-1]['norm_res']:.3e}, final objective {f0_final_obj(out):.6f} (f64 "
                         f"CPU {f_ref:.6f}, rel err {obj_err:.2e}), the recorded call is the row: "
                         f"{same_row}; {'; '.join(sweep_parts)}; wall_s {walls[(driver, name)]}")
        print(f"[f0] {driver} --resident at its defaults (lam 10, tol 1e-5, maxit 5000): K7d "
              f"launches {launches}, K7a {mine} (one each a dataset), other kernels 0; "
              f"{' | '.join(parts)} (objective bounds: Condat-Vu {K7D_OBJ_RTOL:g}, the sweeps' "
              f"converged rows {K7A_DRIVER_OBJ_RTOL[h_kind]:g}; CPU-calibrated) ({smi})",
              flush=True)

    # the engine path, depth cut from 5000 to F0_ENGINE_MAXIT (a host sync an iteration,
    # the linesearch rows one a trial): no K7d or K7a launch, 31 finite rows
    for driver, mod in drivers.items():
        outdir = os.path.join("results", "chip_smoke", f"{driver}_engine")
        zero_counts()
        resident_f0.resident_mpls_sweep.launches = resident_f0.resident_adapdmp_sweep.launches = 0
        t0 = time.perf_counter()
        mod.main(["--datasets", "housing_scale", "--maxit", str(F0_ENGINE_MAXIT), "--device",
                  "cuda", "--outdir", outdir, "--no-plot"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = read_jsonl(os.path.join(outdir, "housing_scale.jsonl"))
        last = {}
        for r in rows:
            if "norm_res" in r:
                last[r["method"]] = r
        whole = (resident_f0.resident_condat_vu.launches, resident_f0.resident_mpls_sweep.launches,
                 resident_f0.resident_adapdmp_sweep.launches)
        check(len(last) == 31 and all(math.isfinite(r["norm_res"]) for r in last.values())
              and whole == (0, 0, 0),
              f"{driver} engine path: {len(last)} rows, K7d/K7a launches {whole}")
        print(f"[f0] {driver} engine path, housing_scale, --maxit {F0_ENGINE_MAXIT} (cut from "
              f"5000): 31 finite rows, K7d and K7a launches 0, wall {secs:.2f} s, wall_s "
              f"{rows[-2]['wall_s']} ({smi})", flush=True)

    # K7d against its plain version on the driver's largest call (cpusmall_scale 8192x128,
    # l2, tol 1e-5, maxit 5000, record), one call each (the plain version syncs the host
    # every iteration), and the iteration beside K6d's
    inp = f0_inputs("cpusmall_scale", dev)
    args = (inp["a"], inp["bv"], inp["lam"], inp["gamma"], inp["sigma"], 1e-5, 5000)
    resident_f0.resident_condat_vu(*args, record=True)  # warm-up
    ms, out = once_ms(lambda: resident_f0.resident_condat_vu(*args, record=True))
    plain_ms, out_plain = once_ms(lambda: resident_f0.resident_condat_vu_plain(*args, record=True))
    numit = int(out[1])
    b = bound(*f0_work(inp["a"], numit, resident_pd.hist_len(5000)))
    print(f"[f0] K7d vs its plain version, cpusmall_scale 8192x128 f32 l2 (the driver's call: "
          f"tol 1e-5, maxit 5000, record): numit {numit} (plain {int(out_plain[1])}); K7d "
          f"{ms:.4f} ms ({1e3 * ms / max(numit, 1):.3f} us an iteration), plain {plain_ms:.2f} "
          f"ms (one call each, CUDA events); bound {b[0]:.5f} ms ({b[1]}) ({smi})", flush=True)
    # K7a against its plain version on the driver's largest call cut to K7A_CUT iterations
    # (cpusmall_scale 8192x128, l2, the couplings K7A_TS, tol 1e-5, record), one call each
    # (the plain version syncs the host every trial)
    k7a = {}
    for core, (kernel, plain, p2_of) in cores.items():
        sargs = (inp["a"], inp["bv"], inp["lam"], K7A_TS, p2_of(inp["norm_a"]), 1e-5, K7A_CUT)
        zero_counts()
        before = kernel.launches
        kernel(*sargs, record=True)  # warm-up
        torch.cuda.synchronize()
        check(kernel.launches == before + 1 and read_counts() == (0,) * 7,
              f"K7a {core}: cut-depth sweep launches")
        k_ms, cut = once_ms(lambda: kernel(*sargs, record=True))
        p_ms, cut_plain = once_ms(lambda: plain(*sargs, record=True))
        trials_ok = torch.equal(cut[5][3][:, :K7A_HORIZON], cut_plain[5][3][:, :K7A_HORIZON])
        err = k7a_rows_err(cut[5], cut_plain[5], K7A_HORIZON)
        b_cut = bound(*k7a_work(inp["a"], int(cut[1].sum()), k7a_trials(cut), len(K7A_TS),
                                resident_pd.hist_len(K7A_CUT)))
        # what ms, plain_ms and bound_ms were taken at (driver_ms: the full-depth driver run)
        k7a[core] = dict(ms=k_ms, plain_ms=p_ms, bound=b_cut,
                         ms_at=dict(data="cpusmall_scale 8192x128 f32 l2", maxit=K7A_CUT,
                                    ts=K7A_TS, tol=1e-5))
        print(f"[f0] K7a {core} sweep vs its plain version, cpusmall_scale 8192x128 f32 l2, t "
              f"{K7A_TS}, tol 1e-5, depth cut from 5000 to maxit {K7A_CUT}: numit "
              f"{cut[1].tolist()} (plain {cut_plain[1].tolist()}), {k7a_trials(cut)} trials; "
              f"K7a {k_ms:.4f} ms, plain {p_ms:.2f} ms (one call each, CUDA events); bound "
              f"{b_cut[0]:.5f} ms ({b_cut[1]}); trial counts equal over {K7A_HORIZON} it "
              f"{trials_ok}, rows rel err {err:.2e} ({smi})", flush=True)
        check(trials_ok and err <= K7A_RTOL, f"K7a {core} cut-depth sweep disagrees")
    us = resident_timing.cv_timing(dev, 3)
    # an iteration's bound were A and A' read from HBM every iteration: the larger of
    # 4mn flops and 2mn * 4 bytes
    it_bounds_shapes = ((512, 128), (4224, 128), (8192, 128))
    it_bounds = {f"{m}x{n}": bound(2 * m * n * 4, 4 * m * n) for m, n in it_bounds_shapes}
    shapes = {f"{m}x{n}": torch.empty((m, n), device=dev) for m, n in it_bounds_shapes}
    print(f"[f0] iteration, tol -1, 1000 iterations, f32, best of 3 (K7a: a one-row sweep at t "
          f"1 on one cluster ("
          + "; ".join(f"{k}: {cluster_layout(resident_f0, a_, 'MP', 1)}" for k, a_ in
                      shapes.items())
          + "), with its trials an iteration): "
          f"{', '.join(f'{k} {v:.3f}' for k, v in us.items())}; an iteration's bound (4mn "
          f"flops, 2mn*4 bytes) "
          f"{', '.join(f'{k} {1e3 * v[0]:.4f} us ({v[1]})' for k, v in it_bounds.items())} "
          f"({smi})", flush=True)
    for core, key in (("MP", "mp"), ("AdaPDM+", "adapdmp")):
        k7a[core].update(
            launches=k7a_launches[core],
            it_us={k: v for k, v in us.items() if k.startswith(key + "_")},
            driver_ms=sum(v[0] for (d, n, c), v in sweep_ms.items() if c == core),
            driver_bound_ms=sum(v[1][0] for (d, n, c), v in sweep_ms.items() if c == core))
    return dict(launches=total, ms=ms, plain_ms=plain_ms, bound=b,
                it_us={k: v for k, v in us.items() if k.startswith(("cv_", "k6d_"))}, k7a=k7a,
                f_refs=f_refs, sweep_ms=sweep_ms)



# --resident-grid's datasets, in the f = 0 drivers' default order, and their default maxit
GRID_DATASETS = ("cpusmall_scale", "abalone", "housing_scale")
GRID_MAXIT = 5000


def grid_stack(dev, dtype=torch.float32, names=GRID_DATASETS):
    """The f = 0 drivers' --resident-grid inputs on ``dev`` (``grid_inputs``): [X 1] and y of
    the stand-ins zero-padded to the common shape (8192x128 for the three), A in ``dtype``,
    bv f32; each dataset's ||A||_F, its unpadded column count, lam 10 and Condat-Vu's steps."""
    from adaprox_tpu_torch.experiments import square_root_lasso

    _, a, bv, norms, _ = square_root_lasso.grid_inputs(list(names), device=dev,
                                                       dtype=torch.float32)
    steps = [square_root_lasso.cv_steps(na) for na in norms]
    return dict(a=a.to(dtype), bv=bv, norms=norms, lams=[10.0] * len(names),
                ns=[square_root_lasso.load(nm)[0].shape[1] + 1 for nm in names],
                gammas=[g for g, _ in steps], sigmas=[s for _, s in steps])


def k7b_cores(resident_f0):
    """{label: (grid entry, its plain version, the K7a sweep a cell equals, p2s from the
    datasets' ||A||_F)}."""
    return {"MP": (resident_f0.resident_mpls_grid, resident_f0.resident_mpls_grid_plain,
                   resident_f0.resident_mpls_sweep, lambda norms: [1.0] * len(norms)),
            "AdaPDM+": (resident_f0.resident_adapdmp_grid, resident_f0.resident_adapdmp_grid_plain,
                        resident_f0.resident_adapdmp_sweep, lambda norms: list(norms))}


def grid_flat(out):
    return list(out[:5]) + list(out[5])


def cv_flat(out):
    return list(out[:4]) + list(out[4])


def cells_are_rows(out, sweep, inp, p2s, ts, tol, maxit, h_kind):
    """Whether every cell of a K7b output equals the one-row K7a launch on its dataset's
    slice bit for bit, and those launches' ms (CUDA events, one call each)."""
    same, total = True, 0.0
    flat = grid_flat(out)
    for d in range(inp["a"].shape[0]):
        for j, t in enumerate(ts):
            ms, row = once_ms(lambda: sweep(inp["a"][d], inp["bv"][d], inp["lams"][d], [t], p2s[d],
                                            tol, maxit, record=True, h_kind=h_kind))
            total += ms
            same &= all(torch.equal(u[0], w[d, j]) for u, w in zip(grid_flat(row), flat))
    return same, total


def cv_rows_are_k7d(out, resident_f0, inp, tol, maxit, h_kind):
    """Whether every row of a K7c output equals the K7d launch on its dataset's slice bit
    for bit, and those launches' ms (CUDA events, one call each)."""
    same, total = True, 0.0
    flat = cv_flat(out)
    for d in range(inp["a"].shape[0]):
        ms, one = once_ms(lambda: resident_f0.resident_condat_vu(
            inp["a"][d], inp["bv"][d], inp["lams"][d], inp["gammas"][d], inp["sigmas"][d], tol,
            maxit, record=True, h_kind=h_kind))
        total += ms
        same &= all(torch.equal(u[d], w) for u, w in zip(flat, cv_flat(one)))
    return same, total


def grid_checks(resident_f0, dev, smi):
    """Phase 14, K7b and K7c against their plain versions on the card at D = 3 over the
    stand-ins padded to 8192x128, l2 and l1, A f32 and bf16: K7b's two cores at the
    couplings K7A_TS, tol -1, over K7A_HORIZON (trial counts and ls_failed equal, each cell's
    rows within K7A_RTOL and x within K7A_X_RTOL, the padded coordinates 0); K7c at tol -1
    over K7A_CUT iterations (rows within K7D_RTOL, x within K7D_X_RTOL); two launches the
    same bits; every K7b cell equal to its one-row K7a launch on its slice and every K7c row
    to its K7d launch, bit for bit; then a first dataset that breaks down (an infinite bv
    entry) beside one that converges, with the same second dataset. Returns the largest |x|
    errors on the f32 cases, {"K7b": .., "K7c": ..}."""
    from adaprox_tpu_torch.experiments.k7a_calibration import (K7A_CUT, K7A_HORIZON, K7A_RTOL,
                                                               K7A_TS, K7A_X_RTOL)

    hz, x_abs = K7A_HORIZON, {"K7b": 0.0, "K7c": 0.0}
    for h_kind in resident_f0.H_KINDS:
        for dtype in (torch.float32, torch.bfloat16):
            inp = grid_stack(dev, dtype)
            parts, ok = [], True
            for core, (kernel, plain, sweep, p2_of) in k7b_cores(resident_f0).items():
                p2s = p2_of(inp["norms"])
                args = (inp["a"], inp["bv"], inp["lams"], K7A_TS, p2s, -1.0, hz)
                kw = dict(record=True, h_kind=h_kind)
                got, again = kernel(*args, **kw), kernel(*args, **kw)
                rev = kernel(inp["a"], inp["bv"], inp["lams"], K7A_TS[::-1], p2s, -1.0, hz, **kw)
                want = plain(*args, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(u, w) for u, w in zip(grid_flat(got), grid_flat(again)))
                rev_same = all(torch.equal(u, w.flip(1))
                               for u, w in zip(grid_flat(rev), grid_flat(got)))
                rows_same, _ = cells_are_rows(got, sweep, inp, p2s, K7A_TS, -1.0, hz, h_kind)
                trials_ok = torch.equal(got[5][3], want[5][3]) and torch.equal(got[4], want[4])
                numits_ok = got[1].tolist() == want[1].tolist() == [[hz] * len(K7A_TS)] * 3
                err = max(cell_rel(got[5][k], want[5][k]) for k in K7A_ROWS)
                xe = cell_rel(got[0], want[0])
                pad_zero = all(not bool(got[0][d, :, n:].any()) for d, n in enumerate(inp["ns"]))
                finite = all(bool(torch.isfinite(h).all()) for h in got[5][:3])
                if dtype == torch.float32:
                    x_abs["K7b"] = max(x_abs["K7b"], float((got[0] - want[0]).abs().max()))
                parts.append(f"K7b {core}: trial counts and ls_failed equal over {hz} it "
                             f"{trials_ok}, rows rel err {err:.2e}, x rel err {xe:.2e}; "
                             f"{float(got[5][3].mean()):.3f} trials an iteration; gamma/sigma/"
                             f"norm_res finite {finite}; padded 0 {pad_zero}; same bits {same}; "
                             f"every cell = its one-row K7a launch {rows_same}; ts reversed = "
                             f"the cells reversed, bit for bit {rev_same}; "
                             f"{cluster_layout(resident_f0, inp['a'], core, got[1].numel())}")
                ok &= (trials_ok and numits_ok and err <= K7A_RTOL and xe <= K7A_X_RTOL
                       and pad_zero and finite and same and rows_same and rev_same)
            cargs = (inp["a"], inp["bv"], inp["lams"], inp["gammas"], inp["sigmas"], -1.0, K7A_CUT)
            got = resident_f0.resident_cv_grid(*cargs, h_kind=h_kind)
            again = resident_f0.resident_cv_grid(*cargs, h_kind=h_kind)
            want = resident_f0.resident_cv_grid_plain(*cargs, h_kind=h_kind)
            torch.cuda.synchronize()
            same = all(torch.equal(u, w) for u, w in zip(cv_flat(got), cv_flat(again)))
            rows_same, _ = cv_rows_are_k7d(got, resident_f0, inp, -1.0, K7A_CUT, h_kind)
            err = max(cell_rel(u, w) for u, w in zip(got[4], want[4]))
            xe = cell_rel(got[0], want[0])
            numits_ok = got[1].tolist() == want[1].tolist() == [K7A_CUT] * 3
            pad_zero = all(not bool(got[0][d, n:].any()) for d, n in enumerate(inp["ns"]))
            if dtype == torch.float32:
                x_abs["K7c"] = max(x_abs["K7c"], float((got[0] - want[0]).abs().max()))
            parts.append(f"K7c over {K7A_CUT} it: rows rel err {err:.2e}, x rel err {xe:.2e}, "
                         f"padded 0 {pad_zero}, same bits {same}, every row = its K7d launch "
                         f"{rows_same}")
            ok &= (numits_ok and err <= K7D_RTOL and xe <= K7D_X_RTOL and pad_zero and same
                   and rows_same)
            label = f"D = 3 {tuple(inp['a'].shape)} {h_kind} {str(dtype).removeprefix('torch.')}"
            print(f"[grid] K7b and K7c vs plain, {label}, tol -1: {' | '.join(parts)} (bounds "
                  f"K7b rows {K7A_RTOL:g}, x {K7A_X_RTOL:g} over {hz} it; K7c rows {K7D_RTOL:g}, "
                  f"x {K7D_X_RTOL:g}; CPU-calibrated) ({smi})", flush=True)
            check(ok, f"K7b/K7c {label} disagree with their plain versions or their single "
                      "launches")
    # the scratch across datasets: housing_scale with an infinite bv entry (NaN from the first
    # dual step into every slot) before abalone, against housing_scale as it is
    inp = grid_stack(dev, names=("housing_scale", "abalone"))
    broken = inp["bv"].clone()
    broken[0, 0] = float("inf")
    parts, ok = [], True
    for h_kind in resident_f0.H_KINDS:
        for core, (kernel, _, _, p2_of) in k7b_cores(resident_f0).items():
            bad, good = (kernel(inp["a"], b, inp["lams"], K7A_TS, p2_of(inp["norms"]), 1e-5, 1000,
                                record=True, h_kind=h_kind) for b in (broken, inp["bv"]))
            broke = bad[1][0].tolist() == [1] * len(K7A_TS) and bool(torch.isnan(bad[2][0]).all())
            kept = all(torch.equal(u[1], w[1]) for u, w in zip(grid_flat(bad), grid_flat(good)))
            parts.append(f"{h_kind} K7b {core}: broke {broke}, second dataset's bits kept {kept}")
            ok &= broke and kept
        cargs = (inp["lams"], inp["gammas"], inp["sigmas"], 1e-5, 1000)
        bad, good = (resident_f0.resident_cv_grid(inp["a"], b, *cargs, h_kind=h_kind)
                     for b in (broken, inp["bv"]))
        broke = int(bad[1][0]) == 1 and bool(torch.isnan(bad[2][0]))
        kept = all(torch.equal(u[1], w[1]) for u, w in zip(cv_flat(bad), cv_flat(good)))
        parts.append(f"{h_kind} K7c: broke {broke}, second dataset's bits kept {kept}")
        ok &= broke and kept
    print(f"[grid] a first dataset that breaks down (housing_scale, bv[0] = inf) before abalone, "
          f"{tuple(inp['a'].shape)} f32, tol 1e-5, maxit 1000: {'; '.join(parts)} ({smi})",
          flush=True)
    check(ok, "a broken first dataset changed the next dataset's cells")
    return x_abs


def grid_work(a_stack, numits, trials, cells, hist_len):
    """(bytes, flops) of a K7b grid of ``cells`` cells: each dataset's A and A' read once,
    bv, lam, p2 and the t values in, x, the stats and the five histories out; 2mn flops a
    trial and 2mn an iteration at the common shape."""
    d, m, n = a_stack.shape
    moved = (2 * a_stack.element_size() * d * m * n + 4 * d * m + 8 * d + 4 * (cells // d)
             + cells * (4 * n + 16 + 20 * hist_len))
    return moved, 2 * m * n * (numits + trials)


def cv_grid_work(a_stack, numits, hist_len):
    """(bytes, flops) of a K7c launch: each dataset's A read once, bv, lam, gamma and sigma
    in, x, the stats and the two histories out; 4mn flops an iteration at the common shape."""
    d, m, n = a_stack.shape
    return (a_stack.element_size() * d * m * n + 4 * d * m + 12 * d
            + d * (4 * n + 12 + 8 * hist_len)), 4 * m * n * numits


def grid_phase(resident_f0, resident_pd, f0_meas, counting, dev, smi):
    """Phase 14: both drivers --resident-grid at their defaults (one K7c, one K7b MP and one
    K7b AdaPDM+ launch each, nothing else; JAX's 31 rows and meta rows a file; the recorded
    calls again, by CUDA events, bit for bit against the single launches on each slice; the
    Condat-Vu rows' and every converged row's final objective against phase 13's f64 CPU
    Condat-Vu; the grids beside phase 13's --resident sweeps); then K7b and K7c against their
    plain versions timed at K7A_CUT. Returns the kernels line's measurements."""
    import importlib

    from adaprox_tpu_torch.experiments.k7a_calibration import (K7A_CUT, K7A_DRIVER_OBJ_RTOL,
                                                               K7A_TS)
    from adaprox_tpu_torch.ops import resident_mp
    from adaprox_tpu_torch.utils.logging import read_jsonl

    zero_counts, read_counts = counting
    cores = k7b_cores(resident_f0)
    records = {"MP": resident_mp.resident_mp_records,
               "AdaPDM+": resident_f0.resident_adapdmp_records}
    fams = {"MP": "Malitsky-Pock", "AdaPDM+": "AdaPDM+"}
    drivers = {d: importlib.import_module(f"adaprox_tpu_torch.experiments.{d}")
               for d in F0_DRIVERS}
    t_values = drivers["square_root_lasso"].T_VALUES
    names = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in t_values]
             + [f"AdaPDM+ (t={t})" for t in t_values])
    grids = {"K7c": resident_f0.resident_cv_grid, "MP": cores["MP"][0],
             "AdaPDM+": cores["AdaPDM+"][0]}
    singles = (resident_f0.resident_condat_vu, resident_f0.resident_mpls_sweep,
               resident_f0.resident_adapdmp_sweep)
    meas = {k: dict(launches=0, driver_ms=0.0, driver_bound_ms=0.0) for k in grids}
    inp = grid_stack(dev)
    hl = resident_pd.hist_len(GRID_MAXIT)
    for driver, mod in drivers.items():
        h_kind = "l2" if driver == "square_root_lasso" else "l1"
        outdir = os.path.join("results", "chip_smoke", f"{driver}_grid")
        zero_counts()
        mod.main(["--resident-grid", "--maxit", str(GRID_MAXIT), "--device", "cuda", "--outdir",
                  outdir, "--no-plot"])
        torch.cuda.synchronize()
        launches = [g.launches for g in grids.values()]
        others = read_counts() + (resident_pd.resident_adapdm_dsvm.launches,
                                  resident_pd.resident_adapdm_dsvm_sweep.launches,
                                  resident_pd.resident_cv_dsvm.launches,
                                  resident_mp.resident_mp_dsvm_sweep.launches) + tuple(
            k.launches for k in singles)
        check(launches == [1, 1, 1] and others == (0,) * 14,
              f"{driver} --resident-grid: K7c/K7b MP/K7b AdaPDM+ launches {launches}, other "
              f"kernels {others}")
        for key, n in zip(grids, launches):
            meas[key]["launches"] += n
        # the driver's three calls again, recorded and timed (CUDA events, one call each)
        ms, outs = {}, {}
        ms["K7c"], outs["K7c"] = once_ms(lambda: resident_f0.resident_cv_grid(
            inp["a"], inp["bv"], inp["lams"], inp["gammas"], inp["sigmas"], 1e-5, GRID_MAXIT,
            h_kind=h_kind))
        for core, (kernel, _, _, p2_of) in cores.items():
            ms[core], outs[core] = once_ms(lambda: kernel(
                inp["a"], inp["bv"], inp["lams"], t_values, p2_of(inp["norms"]), 1e-5,
                GRID_MAXIT, record=True, h_kind=h_kind))
        bounds = {"K7c": bound(*cv_grid_work(inp["a"], int(outs["K7c"][1].sum()), hl))}
        for core in cores:
            bounds[core] = bound(*grid_work(inp["a"], int(outs[core][1].sum()),
                                            k7a_trials(outs[core]), outs[core][1].numel(), hl))
        for key in grids:
            meas[key]["driver_ms"] += ms[key]
            meas[key]["driver_bound_ms"] += bounds[key][0]
        # each cell and row against its single launch on the slice, bit for bit
        cv_same, k7d_ms = cv_rows_are_k7d(outs["K7c"], resident_f0, inp, 1e-5, GRID_MAXIT,
                                          h_kind)
        cell_same = {core: cells_are_rows(outs[core], sweep, inp, p2_of(inp["norms"]), t_values,
                                          1e-5, GRID_MAXIT, h_kind)[0]
                     for core, (_, _, sweep, p2_of) in cores.items()}
        parts = []
        for i, name in enumerate(GRID_DATASETS):
            rows = read_jsonl(os.path.join(outdir, f"{name}.jsonl"))
            by = {}
            for r in rows:
                if "norm_res" in r:
                    by.setdefault(r["method"], []).append(r)
            meta = rows[-2]
            check(list(by) == names and meta.get("fast_path") == "resident-grid"
                  and list(meta) == ["wall_s", "fast_path", "grid_total_s", "fast_methods"]
                  and meta["fast_methods"] == JAX_F0_FAST_METHODS
                  and list(meta["wall_s"]) == list(meta["grid_total_s"]) == JAX_F0_FAST_METHODS,
                  f"{driver} --resident-grid {name}: rows {list(by)}, meta {meta}")
            f_ref = f0_meas["f_refs"][(driver, name)]
            cv, cvr = outs["K7c"], by["Condat-Vu"]
            k = int(cv[1][i])
            cv_err = abs(float(cv[4][1][i][k - 1]) - f_ref) / abs(f_ref)
            same_row = (k == len(cvr) and float(cv[2][i]) == cvr[-1]["norm_res"]
                        and cvr[-1]["A_evals"] == k + 1)
            check(same_row and cv_err <= K7D_OBJ_RTOL,
                  f"{driver} --resident-grid {name}: the Condat-Vu row disagrees")
            dparts = [f"Condat-Vu numit {k}, objective rel err {cv_err:.2e}"]
            for core in cores:
                out, fam = outs[core], fams[core]
                same, gaps, nonfinite = True, [], 0
                for j, t in enumerate(t_values):
                    rs = by[f"{fam} (t={t})"]
                    kk = int(out[1][i][j])
                    rec = records[core](out[1][i][j], tuple(h[i][j] for h in out[5]),
                                        maxit=GRID_MAXIT)
                    same &= (kk == len(rs) and float(rec.norm_res[kk - 1]) == rs[-1]["norm_res"]
                             and int(rec.A_evals[kk - 1]) == rs[-1]["A_evals"]
                             and int(rec.At_evals[kk - 1]) == rs[-1]["At_evals"])
                    nonfinite += sum(int((~torch.isfinite(h[i][j][:kk])).sum())
                                     for h in out[5][:3])
                    if bool(out[3][i][j]):
                        gaps.append(abs(float(out[5][4][i][j][kk - 1]) - f_ref) / abs(f_ref))
                gap = max(gaps, default=0.0)
                dparts.append(f"{fam} converged {len(gaps)}/15, ls_failed {int(out[4][i].sum())}, "
                              f"non-finite gamma/sigma/norm_res {nonfinite}, converged rows' "
                              f"objective rel err <= {gap:.2e}, the recorded call is the rows: "
                              f"{same}")
                check(same and nonfinite == 0 and gap <= K7A_DRIVER_OBJ_RTOL[h_kind],
                      f"{driver} --resident-grid {name}: the {fam} rows disagree (objective "
                      f"{gap}, non-finite {nonfinite})")
            parts.append(f"{name}: {', '.join(dparts)}; wall_s {meta['wall_s']}")
        check(cv_same and all(cell_same.values()),
              f"{driver} --resident-grid: a cell differs from its single launch on the slice "
              f"(K7c {cv_same}, K7b {cell_same})")
        sweeps = {core: sum(v[0] for (d_, _, c_), v in f0_meas["sweep_ms"].items()
                            if d_ == driver and c_ == core) for core in cores}
        print(f"[grid] {driver} --resident-grid at its defaults (lam 10, tol 1e-5, maxit "
              f"{GRID_MAXIT}, D = 3 padded to {tuple(inp['a'].shape[1:])}): launches K7c 1, K7b "
              f"MP 1, K7b AdaPDM+ 1, every other kernel 0; timed again by CUDA events: K7c "
              f"{ms['K7c']:.4f} ms (bound {bounds['K7c'][0]:.5f} ms, {bounds['K7c'][1]}; the "
              f"three K7d launches on the slices {k7d_ms:.4f} ms), "
              + ", ".join(f"K7b {core} {ms[core]:.4f} ms (cooperative kernel, PR 13: "
                          f"{F0_COOPERATIVE_MS[(driver, 'grid')][0 if core == 'MP' else 1]:.2f} "
                          f"ms; {cluster_layout(resident_f0, inp['a'], core, 45)}; bound "
                          f"{bounds[core][0]:.5f} ms, "
                          f"{bounds[core][1]}; phase 13's three --resident sweeps "
                          f"{sweeps[core]:.4f} ms, ratio {ms[core] / sweeps[core]:.3f}; "
                          f"{k7a_trials(outs[core])} trials, numit {outs[core][1].tolist()})"
                          for core in cores)
              + f"; every K7b cell = its one-row K7a launch {cell_same}, every K7c row = its "
              f"K7d launch {cv_same}; {' | '.join(parts)} (objective bounds: Condat-Vu "
              f"{K7D_OBJ_RTOL:g}, converged rows {K7A_DRIVER_OBJ_RTOL[h_kind]:g}; "
              f"CPU-calibrated) ({smi})", flush=True)

    # K7b and K7c against their plain versions (a host sync a trial or an iteration) on the
    # drivers' stack, l2, tol 1e-5, depth cut from 5000 to K7A_CUT; K7b at the couplings
    # K7A_TS. One call each, CUDA events.
    zero_counts()
    calls = {"K7c": (resident_f0.resident_cv_grid, resident_f0.resident_cv_grid_plain,
                     (inp["a"], inp["bv"], inp["lams"], inp["gammas"], inp["sigmas"], 1e-5,
                      K7A_CUT), {})}
    for core, (kernel, plain, _, p2_of) in cores.items():
        calls[core] = (kernel, plain, (inp["a"], inp["bv"], inp["lams"], K7A_TS,
                                       p2_of(inp["norms"]), 1e-5, K7A_CUT), dict(record=True))
    for key, (kernel, plain, args, kw) in calls.items():
        k_ms, out = once_ms(lambda: kernel(*args, **kw))
        p_ms, out_p = once_ms(lambda: plain(*args, **kw))
        if key == "K7c":
            b = bound(*cv_grid_work(inp["a"], int(out[1].sum()), resident_pd.hist_len(K7A_CUT)))
            counts = f"numit {out[1].tolist()} (plain {out_p[1].tolist()})"
        else:
            b = bound(*grid_work(inp["a"], int(out[1].sum()), k7a_trials(out), out[1].numel(),
                                 resident_pd.hist_len(K7A_CUT)))
            counts = (f"numit {out[1].tolist()} (plain {out_p[1].tolist()}), {k7a_trials(out)} "
                      "trials")
        # what ms, plain_ms and bound_ms were taken at (driver_ms: the full-depth driver runs)
        meas[key].update(ms=k_ms, plain_ms=p_ms, bound=b, ms_at=dict(
            data=f"D = 3 stack {'x'.join(map(str, inp['a'].shape))} f32 l2", maxit=K7A_CUT,
            ts=None if key == "K7c" else K7A_TS, tol=1e-5))
        print(f"[grid] {'K7c' if key == 'K7c' else 'K7b ' + key} vs its plain version, D = 3 "
              f"{tuple(inp['a'].shape)} f32 l2, tol 1e-5, depth cut from {GRID_MAXIT} to maxit "
              f"{K7A_CUT}{'' if key == 'K7c' else f', t {K7A_TS}'}: {counts}; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.2f} ms (one call each, CUDA events); bound "
              f"{b[0]:.5f} ms ({b[1]}) ({smi})", flush=True)
    check(tuple(g.launches for g in grids.values()) == (1, 1, 1),
          "phase 14's cut-depth calls: not one launch of each grid")
    return meas


# the f = 0 drivers' --fused depth: cut from 5000 so that phase 15 stays short (the 30
# t-sweep rows run on the engine, a host sync an iteration and one a trial)
FUSED_DRIVER_MAXIT = 150
# fused_condat_vu's final objective at the drivers' defaults (tol 1e-5, maxit 5000) against
# phase 13's f64 CPU Condat-Vu. Calibrated on the CPU with the fused solver's plain path in
# f32 against that f64 run on the three stand-ins, l2 and l1: at most 3.71e-7 of the
# objective (housing_scale l1; cpusmall_scale l2 4.83e-8, l1 3.31e-7), and 0 in f64 (the
# fused solve in f64 is the plain Condat-Vu's to the last bit). About 10x that.
FUSED_CV_OBJ_RTOL = 4e-6


def graph_ms(fn, reps=20):
    """Mean ms per call of fn() on the card without the host's launch overhead: reps calls
    captured in one CUDA graph, CUDA events around its replay (after a warm-up replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # builds and allocates outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k5_work(at):
    """(bytes, flops) of one K5 call: A' read once, y, x, grad in, A'y, v, x_new and A x_new
    out (f32); 4 flops an element of A'."""
    n, m = at.shape
    return at.element_size() * n * m + 4 * (m + 2 * n) + 4 * (3 * n + m), 4 * n * m


def fused_inputs(name, dev, dtype=torch.float32):
    """The f = 0 drivers' fused operator for dataset ``name`` (its stand-in): [X 1]'
    zero-padded as fused_condat_vu auto-pads it, n to 8 (16 for bf16) and m to 128."""
    from adaprox_tpu_torch.convert import sqrt_lasso_from_numpy
    from adaprox_tpu_torch.experiments import square_root_lasso

    from adaprox_tpu_torch.ops.pd_kernels import LANE, sublane

    x, y, _ = square_root_lasso.load(name)
    _, _, _, a_op, _ = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=dev, dtype=torch.float32)
    m, n = a_op.shape
    sub = sublane(torch.empty((), dtype=dtype).element_size())
    at = torch.zeros(-(-n // sub) * sub, -(-m // LANE) * LANE, device=dev)
    at[:n, :m] = a_op.a.t()
    return at.to(dtype)


def k5_checks(pd_kernels, big, dev, smi):
    """Phase 15, K5 against its plain version on the card: the drivers' padded A' (16 x 8192,
    16 x 4224, 16 x 512), 16384^2 and a ragged m, A' f32 and bf16, every prox kind, two
    launches the same bits; each shape timed (CUDA events, eager and in a CUDA graph) beside
    the plain version, the two torch.mv it replaces and its bound. Returns the
    measurements."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    menu = (("l1", 0.7, 0.0), ("box", -0.5, 0.5), ("elastic", 0.3, 0.2), ("zero", 0.0, 0.0))
    shapes = [(f"{name} {'x'.join(map(str, fused_inputs(name, 'cpu').shape))}",
               lambda dt, name=name: fused_inputs(name, dev, dt))
              for name in ("cpusmall_scale", "abalone", "housing_scale")]
    shapes += [(f"{HEADLINE}x{HEADLINE}", lambda dt: big[0].t().contiguous().to(dt)),
               ("64x1000 (ragged m)", lambda dt: torch.randn(64, 1000, generator=gen,
                                                             device=dev).to(dt) / 1000**0.5)]
    meas = {}
    gamma = torch.tensor(0.37, device=dev)
    for label, make in shapes:
        for dt in (torch.float32, torch.bfloat16):
            at = make(dt)
            n, m = at.shape
            y, x, grad = (torch.randn(k, generator=gen, device=dev) for k in (m, n, n))
            errs, abs_err = [], 0.0
            for kind, p1, p2 in menu:
                got = pd_kernels.fused_pd_primal_update(at, y, x, grad, gamma, p1, p2, kind)
                again = pd_kernels.fused_pd_primal_update(at, y, x, grad, gamma, p1, p2, kind)
                want = pd_kernels.pd_primal_update_plain(at, y, x, grad, gamma, p1, p2, kind)
                torch.cuda.synchronize()
                same = all(torch.equal(u, w) for u, w in zip(got, again))
                err = max(float((u - w).abs().max() / w.abs().max().clamp_min(1e-30))
                          for u, w in zip(got, want))
                abs_err = max(abs_err, max(float((u - w).abs().max()) for u, w in zip(got, want)))
                check(same and math.isfinite(err) and err <= KERNEL_RTOL,
                      f"K5 {label} {dt} {kind}: rel err {err}, same bits twice {same}")
                errs.append(f"{kind} {err:.2e}")
            af = at.float()  # the plain version and the two mv on f32 storage
            ms = event_ms(lambda: pd_kernels.fused_pd_primal_update(at, y, x, grad, gamma, 0.7))
            g_ms = graph_ms(lambda: pd_kernels.fused_pd_primal_update(at, y, x, grad, gamma,
                                                                      0.7))
            plain_ms = event_ms(lambda: pd_kernels.pd_primal_update_plain(af, y, x, grad, gamma,
                                                                          0.7))
            mv_ms = graph_ms(lambda: (torch.mv(af, y), torch.mv(af.t(), x)))
            b = bound(*k5_work(at))
            tag = "f32" if dt == torch.float32 else "bf16"
            meas[f"{label} {tag}"] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, mv_ms=mv_ms,
                                          bound=b, max_abs_err=abs_err)
            print(f"[pd_fused] K5 {label} A' {tag}: rel err {', '.join(errs)} (tol "
                  f"{KERNEL_RTOL:g}; two launches the same bits) | K5 {ms:.4f} ms a call "
                  f"(eager), {g_ms:.4f} ms on the device (CUDA graph); plain {plain_ms:.4f} "
                  f"ms; the two torch.mv it replaces {mv_ms:.4f} ms (CUDA graph); bound "
                  f"{b[0]:.5f} ms ({b[1]}) ({smi})", flush=True)
            del at, af
    return meas


def pd_fused_phase(pd_kernels, others, f_refs, big, dev, smi):
    """Phase 15: both f = 0 drivers --fused on the three stand-ins (the Condat-Vu row on K5,
    1 + numit launches a solve, no other kernel; JAX's 31 rows and meta rows), fused_condat_vu
    at the drivers' defaults on cpusmall_scale l2 and l1 against phase 13's f64 CPU Condat-Vu
    and timed beside the engine's condat_vu, and the PD headline (AdaPDM at 16384^2, fused f32
    and bf16 beside the engine). Returns the kernels line's measurements."""
    import importlib

    import adaprox_tpu_torch as apt
    from adaprox_tpu_torch.experiments.common import sync_wall
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    k5 = pd_kernels.fused_pd_primal_update
    drivers = {d: importlib.import_module(f"adaprox_tpu_torch.experiments.{d}")
               for d in F0_DRIVERS}
    t_values = drivers["square_root_lasso"].T_VALUES
    names = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in t_values]
             + [f"AdaPDM+ (t={t})" for t in t_values])
    launches = 0
    for driver, mod in drivers.items():
        outdir = os.path.join("results", "chip_smoke", f"{driver}_fused")
        before = others()
        k5.launches = 0
        t0 = time.perf_counter()
        mod.main(["--fused", "--device", dev.type, "--maxit", str(FUSED_DRIVER_MAXIT),
                  "--outdir", outdir, "--no-plot"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        parts, want = [], 0
        for name in F0_DATASETS:
            rows = read_jsonl(os.path.join(outdir, f"{name}.jsonl"))
            by = {}
            for r in rows:
                if "norm_res" in r:
                    by.setdefault(r["method"], []).append(r)
            meta = rows[-2]
            cv = by.get("Condat-Vu", [])
            want += 1 + len(cv)
            finite = all(math.isfinite(r["norm_res"]) for rs in by.values() for r in rs)
            check(list(by) == names and meta["fast_path"] == "fused"
                  and meta["fast_methods"] == ["Condat-Vu"]
                  and list(meta["wall_s"]) == JAX_F0_FAST_METHODS and finite
                  and (cv[0]["A_evals"], cv[0]["At_evals"]) == (2, 1)
                  and (cv[-1]["A_evals"], cv[-1]["At_evals"]) == (len(cv) + 1, len(cv)),
                  f"{driver} --fused {name}: rows {list(by)}, meta {meta}, finite {finite}")
            parts.append(f"{name}: Condat-Vu numit {len(cv)}, norm_res {cv[-1]['norm_res']:.3e}, "
                         f"wall_s {meta['wall_s']}")
        launches += k5.launches
        check(k5.launches == want and others() == before,
              f"{driver} --fused: {k5.launches} K5 launches, not 1 + numit a Condat-Vu solve "
              f"({want}), or another kernel ran")
        print(f"[pd_fused] {driver} --fused on the three stand-ins, --maxit "
              f"{FUSED_DRIVER_MAXIT} (cut from 5000): K5 launches {k5.launches} (1 + numit a "
              f"Condat-Vu solve), no other kernel, JAX's 31 rows and meta rows, all finite; "
              f"{' | '.join(parts)}; wall {secs:.2f} s ({smi})", flush=True)

    # fused_condat_vu at the drivers' defaults on the largest stand-in, l2 and l1, beside the
    # engine's condat_vu on the same inputs (one solve each, host clock after a sync)
    from adaprox_tpu_torch.convert import sqrt_lasso_from_numpy
    from adaprox_tpu_torch.experiments import square_root_lasso

    x_np, y_np, _ = square_root_lasso.load("cpusmall_scale")
    cv_meas = {}
    for driver, inner in (("square_root_lasso", "l2"), ("least_absolute_deviation", "l1")):
        f, g, h, a_op, norm_a = sqrt_lasso_from_numpy(x_np, y_np, 10.0, inner, device=dev,
                                                      dtype=torch.float32)
        m, n = a_op.shape
        x0, y0 = torch.zeros(n, device=dev), torch.zeros(m, device=dev)
        at = a_op.a.t().contiguous()
        kw = dict(f=f, g=g, h=h, Lf=0.0, norm_A=norm_a, tol=1e-5, maxit=5000, history=True)
        k5.launches = 0
        res, wall = sync_wall(lambda: apt.fused_condat_vu(x0, y0, A=a_op.a, at=at, **kw))
        n_k5 = k5.launches
        ref, ref_wall = sync_wall(lambda: apt.condat_vu(x0, y0, A=a_op, **kw))
        obj = float(res.records.objective[-1])
        f_ref = f_refs[(driver, "cpusmall_scale")]
        err = abs(obj - f_ref) / abs(f_ref)
        cv_meas[inner] = dict(wall=wall, engine_wall=ref_wall, numit=res.numit)
        print(f"[pd_fused] fused_condat_vu, cpusmall_scale {m}x{n} f32 {inner} (A' padded to "
              f"16x8192), tol 1e-5, maxit 5000: numit {res.numit} (engine {ref.numit}), K5 "
              f"launches {n_k5}, final objective {obj:.6f} (f64 CPU {f_ref:.6f}, rel err "
              f"{err:.2e}, bound {FUSED_CV_OBJ_RTOL:g}, CPU-calibrated), wall {1e3 * wall:.1f} "
              f"ms ({1e3 * wall / max(res.numit, 1):.4f} ms an iteration) beside the engine's "
              f"condat_vu {1e3 * ref_wall:.1f} ms ({1e3 * ref_wall / max(ref.numit, 1):.4f}) "
              f"({smi})", flush=True)
        check(n_k5 == 1 + res.numit and math.isfinite(obj) and err <= FUSED_CV_OBJ_RTOL,
              f"fused_condat_vu cpusmall_scale {inner}: {n_k5} K5 launches, objective {obj}")

    # the PD headline (bench.py's pd_* runners): AdaPDM, f = 0, g = L1Norm(0.01), h =
    # Translate(L2Norm(1), -y), AdaPGMRule.make(t = 1, ||A||_F), 200 iterations at 16384^2
    a, yv, _ = big
    x0, y0 = torch.zeros(HEADLINE, device=dev), torch.zeros(HEADLINE, device=dev)
    h = apt.Translate(apt.L2Norm(1.0), -yv)
    kw = dict(f=apt.ZeroSmooth(), g=apt.L1Norm(0.01), h=h,
              rule=apt.AdaPGMRule.make(t=1.0, norm_a=float(apt.frobenius_norm(a))), tol=0.0,
              maxit=HEADLINE_ITERS)
    at32 = a.t().contiguous()
    at16 = at32.to(torch.bfloat16)
    head = {}
    for label, run, bytes_it in (
            ("fused f32 (K5)", lambda: apt.fused_adaptive_primal_dual(x0, y0, A=a, at=at32, **kw),
             4 * HEADLINE * HEADLINE),
            ("fused bf16 (K5)", lambda: apt.fused_adaptive_primal_dual(
                x0, y0, A=at16.t(), at=at16, **kw), 2 * HEADLINE * HEADLINE),
            ("engine f32 (two torch.mv)", lambda: apt.adaptive_primal_dual(
                x0, y0, A=apt.DenseOperator(a), **kw), 8 * HEADLINE * HEADLINE)):
        secs, res = timed(run, reps=3)
        check(res.numit == HEADLINE_ITERS and math.isfinite(float(res.norm_res))
              and bool(torch.isfinite(res.x).all()),
              f"PD headline {label}: numit {res.numit}, norm_res {float(res.norm_res)}")
        ips = HEADLINE_ITERS / secs
        head[label] = ips
        print(f"[pd_fused] PD headline AdaPDM {HEADLINE}^2 {label}: {ips:.1f} iters/s "
              f"({1e3 * secs / HEADLINE_ITERS:.4f} ms an iteration), {bytes_it * ips / 1e9:.1f} "
              f"GB/s of A (norm_res {float(res.norm_res):.3e}; best of 3 after a warm-up; "
              f"{smi})", flush=True)
    del at32, at16
    return dict(launches=launches, cv=cv_meas, head=head)


# Phase 16, the sparse path: each kernel against its plain version on the slice's case
# (experiments/sparse_calibration.py: 8192 x 16384 f32, 10% of the (64, 512) tiles
# nonzero), both directions, within SPARSE_RTOL of the largest row sum of |a_ij x_j|
# (f32 sums in another order; a lost or doubled tile would be of order 1); the engine's
# solves over it at SPARSE_MAXIT iterations, each sparse route's final objective within
# SPARSE_OBJ_RTOL of the dense route's (calibrated on the CPU, beside the constant).
SPARSE_RTOL = 1e-5
# opnorm2's 50 power iterations over the three operators on the card: the same iteration
# from JAX's draw, in three summation orders
SPARSE_OPNORM_RTOL = 1e-5
SPARSE_KERNELS = (("K8", "ell_matvec", "adaprox_tpu_torch/csrc/ell_matvec.cu",
                   "adaprox_tpu/ops/sparse.py:111"),
                  ("K9a", "bcsr_matvec", "adaprox_tpu_torch/csrc/bcsr_matvec.cu",
                   "adaprox_tpu/ops/bcsr.py:105"),
                  ("K9b", "bcsr_matvec_slab", "adaprox_tpu_torch/csrc/bcsr_matvec.cu",
                   "adaprox_tpu/ops/bcsr.py:182"))


def sparse_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k8_work(vals, lengths, v):
    """(bytes, flops) of one K8 launch: the entries its rows hold (their extents), each
    a value and an int32 column, read once; the extents, x and y."""
    held = int(lengths.sum())
    return (held * (vals.element_size() + 4) + sparse_bytes(lengths, v) + 4 * vals.shape[0],
            2 * held)


def library_ms(fn):
    """CUDA-event ms of one PyTorch call that computes the same product (a yardstick
    only: the port never calls it), or None and the reason where PyTorch refuses it."""
    try:
        return event_ms(fn), None
    except (RuntimeError, NotImplementedError) as exc:
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"


def sparse_checks(sparse, bcsr, ops, d_t, dev, smi):
    """Phase 16, K8, K9a and K9b against their plain versions on the slice's case, both
    directions (A'y: K8 over ELL's A' structure, K9a and K9b over A's own tiles): within
    SPARSE_RTOL of the largest |a| |x| row or column sum, two launches the same bits, K9b
    equal to K9a bit for bit, the "xla" route the same bits twice; then K9a and K9b over
    A''s tiles (the JAX formulation, which the "xla" route keeps) likewise. Each
    timed by CUDA events over 20 calls with the host's time hidden
    (utils.profiling.flushed_ms) twice: back to back (warm: A at 53 MB is about the 50 MB
    L2, so some of it can be served from there) and with a 256 MiB buffer written and read
    between calls (cold, the table's time: a cold rate past the card's 3350 GB/s fails),
    beside its plain version (CUDA events, eager), its bound, cuSPARSE's CSR product and
    dense torch.mv likewise, the BSR product at (64, 512) where PyTorch takes it, and K10a's
    one pass over the same bytes (the stream's floor for one launch of this size). K8
    reads only the entries its rows hold (the operator's row extents): its bytes and
    flops are those (``k8_work``), printed beside the padded arrays' bytes and bound and
    K8's cold time without extents, and its floor is K10a's pass over a buffer of its held
    bytes. Returns {kernel:
    {direction: measurements}} and the floors {"K9": ..., "K8": ...}."""
    from adaprox_tpu_torch.ops.kernels import hbm_read_reduce
    from adaprox_tpu_torch.utils.profiling import flushed_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    ell, bc = ops["ell"], ops["pallas"]
    m, n = ell.shape
    nbr, nbc = bc.rowptr.shape[0] - 1, bc.colptr.shape[0] - 1
    csr = {"A x": d_t.to_sparse_csr(), "A'y": d_t.t().contiguous().to_sparse_csr()}
    try:
        bsr = {"A x": d_t.to_sparse_bsr(bc.vals.shape[1:]),
               "A'y": d_t.t().contiguous().to_sparse_bsr(bc.vals_t.shape[1:])}
    except (RuntimeError, NotImplementedError) as exc:
        bsr = {k: str(exc).splitlines()[0][:120] for k in ("A x", "A'y")}
    meas = {name: {} for name, *_ in SPARSE_KERNELS}
    vecs = {"A x": torch.randn(n, generator=gen, device=dev),
            "A'y": torch.randn(m, generator=gen, device=dev)}
    out_len = {"A x": 4 * nbr * bc.vals.shape[1], "A'y": 4 * nbc * bc.vals.shape[2]}

    def cases(direction, v):
        """(name, kernel, plain, magnitude, bytes, flops) of each kernel this way."""
        ev, ec, el = ((ell.vals, ell.cols, ell.row_len) if direction == "A x" else
                      (ell.vals_t, ell.rows_t, ell.row_len_t))
        k8 = ("K8", lambda: sparse.ell_matvec(ev, ec, v, el),
              lambda: sparse.ell_matvec_plain(ev, ec, v, ev.shape[0]),
              lambda: sparse.ell_matvec_plain(ev.abs(), ec, v.abs(), ev.shape[0]),
              *k8_work(ev, el, v))
        if direction == "A x":
            vals, cols, rowptr, rows = bc.vals, bc.cols, bc.rowptr, bc.rows
            nbytes = sparse_bytes(vals, cols, rowptr, v) + out_len["A x"]
            return (k8, (
                "K9a", lambda: bcsr.bcsr_matvec(vals, cols, rowptr, bc.max_bpr, v),
                lambda: bcsr.bcsr_matvec_plain(vals, cols, rows, v, nbr, rowptr=rowptr),
                lambda: bcsr.bcsr_matvec_plain(vals.abs(), cols, rows, v.abs(), nbr,
                                               rowptr=rowptr), nbytes, 2 * vals.numel()), (
                "K9b", lambda: bcsr.bcsr_matvec_slab(vals, cols, rows, nbr, v),
                lambda: bcsr.bcsr_matvec_plain(vals, cols, rows, v, nbr, rowptr=rowptr),
                lambda: bcsr.bcsr_matvec_plain(vals.abs(), cols, rows, v.abs(), nbr,
                                               rowptr=rowptr),
                sparse_bytes(vals, cols, rows, v) + out_len["A x"], 2 * vals.numel()))
        col = (bc.vals, bc.rows, bc.colptr, bc.col_tiles)
        nbytes = sparse_bytes(*col, v) + out_len["A'y"]
        return (k8, (
            "K9a", lambda: bcsr.bcsr_rmatvec(*col, nbc, v),
            lambda: bcsr.bcsr_rmatvec_plain(*col, v, nbc),
            lambda: bcsr.bcsr_rmatvec_plain(bc.vals.abs(), *col[1:], v.abs(), nbc), nbytes,
            2 * bc.vals.numel()), (
            "K9b", lambda: bcsr.bcsr_rmatvec_slab(*col, nbc, v),
            lambda: bcsr.bcsr_rmatvec_plain(*col, v, nbc),
            lambda: bcsr.bcsr_rmatvec_plain(bc.vals.abs(), *col[1:], v.abs(), nbc), nbytes,
            2 * bc.vals.numel()))

    def run(label, direction, kcases, lib, lib_bsr, dense_ms, y_dense):
        """Check and time each case; returns {name: measurements} and the outputs."""
        got_meas, outs = {}, {}
        for name, kernel, plain, magnitude, nbytes, flops in kcases:
            got, again, want = kernel(), kernel(), plain()
            scale = float(magnitude().max())
            torch.cuda.synchronize()
            abs_err = float((got - want).abs().max())
            same = torch.equal(got, again)
            check(same and math.isfinite(abs_err) and abs_err <= SPARSE_RTOL * scale,
                  f"{name} {label}: max |kernel - plain| {abs_err} (scale {scale}), same "
                  f"bits twice {same}")
            outs[name] = got
            check(float((got[:y_dense.shape[0]] - y_dense).abs().max()) <= SPARSE_RTOL * scale,
                  f"{name} {label} disagrees with the dense torch.mv")
            cold, warm = flushed_ms(kernel), flushed_ms(kernel, flush_bytes=0)
            gbps = nbytes / cold / 1e6
            check(gbps <= HBM_BYTES_S / 1e9,
                  f"{name} {label}: {gbps:.1f} GB/s cold is past the card's "
                  f"{HBM_BYTES_S / 1e9:.0f} GB/s: it cannot have moved every byte")
            got_meas[name] = dict(
                ms=cold, warm_ms=warm, gbps=gbps, plain_ms=event_ms(plain),
                bound=bound(nbytes, flops), max_abs_err=abs_err, library_ms=lib[0],
                library_warm_ms=lib[2], bsr_ms=lib_bsr[0], dense_ms=dense_ms)
            if name == "K8":  # beside the padded arrays, which K8 without extents reads
                ev, ec = (ell.vals, ell.cols) if direction == "A x" else (ell.vals_t, ell.rows_t)
                padded = sparse_bytes(ev, ec, vecs[direction]) + 4 * ev.shape[0]
                got_meas[name].update(
                    held_bytes=nbytes, padded_bytes=padded,
                    padded_bound=bound(padded, 2 * ev.numel()),
                    padded_ms=flushed_ms(lambda: sparse.ell_matvec(ev, ec, vecs[direction])))
        check(torch.equal(outs["K9b"], outs["K9a"]),
              f"{label}: K9b not equal to K9a bit for bit")
        parts = [f"{k} {v['ms']:.4f} ms cold, {v['warm_ms']:.4f} warm ({v['gbps']:.1f} GB/s "
                 f"cold; plain {v['plain_ms']:.4f}, bound {v['bound'][0]:.4f} {v['bound'][1]},"
                 f" max abs err {v['max_abs_err']:.2e}"
                 + (f"; reads the held {v['held_bytes'] / 1e6:.1f} MB of the padded "
                    f"{v['padded_bytes'] / 1e6:.1f} MB, whose bound is "
                    f"{v['padded_bound'][0]:.4f}; without extents (the padded k) "
                    f"{v['padded_ms']:.4f} ms cold" if "held_bytes" in v else "") + ")"
                 for k, v in got_meas.items()]
        print(f"[sparse] {label} at {m}x{n} f32: {'; '.join(parts)}; two launches the same "
              f"bits, K9b = K9a bit for bit (tol {SPARSE_RTOL:g} of the largest |a||x| sum)"
              f" | cuSPARSE CSR "
              f"{'%.4f ms cold, %.4f warm' % (lib[0], lib[2]) if lib[0] is not None else lib[1]}"
              f", BSR {'%.4f ms' % lib_bsr[0] if lib_bsr[0] is not None else lib_bsr[1]}, "
              f"dense torch.mv {dense_ms:.4f} ms ({smi})", flush=True)
        return got_meas

    def yardsticks(direction, v, dense_mv):
        def timed_lib(fn):
            ms, why = library_ms(fn)  # None where PyTorch refuses the product
            return ((flushed_ms(fn), why, flushed_ms(fn, flush_bytes=0)) if ms is not None
                    else (None, why, None))

        lib = timed_lib(lambda: torch.mv(csr[direction], v))
        lib_bsr = (library_ms(lambda: torch.mv(bsr[direction], v))
                   if isinstance(bsr[direction], torch.Tensor) else (None, bsr[direction]))
        return lib, lib_bsr, flushed_ms(lambda: dense_mv(v)), dense_mv(v)

    for direction, dense_mv in (("A x", lambda v: torch.mv(d_t, v)),
                                ("A'y", lambda v: torch.mv(d_t.t(), v))):
        v = vecs[direction]
        label = (f"A x over A's {bc.vals.shape[0]} tiles of {tuple(bc.vals.shape[1:])}, ELL k "
                 f"{ell.vals.shape[1]}" if direction == "A x" else
                 f"A'y over A's {bc.vals.shape[0]} tiles (K9a, K9b), ELL kt "
                 f"{ell.vals_t.shape[1]} (K8)")
        got = run(label, direction, cases(direction, v), *yardsticks(direction, v, dense_mv))
        for name, g in got.items():
            meas[name][direction] = g
    xla_same = torch.equal(ops["xla"].rmatvec(vecs["A'y"]), ops["xla"].rmatvec(vecs["A'y"]))
    check(xla_same and torch.equal(ops["xla"].matvec(vecs["A x"]),
                                   ops["xla"].matvec(vecs["A x"])),
          "the xla route not the same bits twice")
    # K9a and K9b over A''s structure at A's tile shape: A'y in the JAX formulation
    v = vecs["A'y"]
    vt, ct, rpt, rt = bc.vals_t, bc.cols_t, bc.rowptr_t, bc.rows_t
    nbr_t = rpt.shape[0] - 1
    nbytes = sparse_bytes(vt, ct, rpt, v) + 4 * nbr_t * vt.shape[1]
    old = ((
        "K9a", lambda: bcsr.bcsr_matvec(vt, ct, rpt, bc.max_bpr_t, v),
        lambda: bcsr.bcsr_matvec_plain(vt, ct, rt, v, nbr_t, rowptr=rpt),
        lambda: bcsr.bcsr_matvec_plain(vt.abs(), ct, rt, v.abs(), nbr_t, rowptr=rpt), nbytes,
        2 * vt.numel()), (
        "K9b", lambda: bcsr.bcsr_matvec_slab(vt, ct, rt, nbr_t, v),
        lambda: bcsr.bcsr_matvec_plain(vt, ct, rt, v, nbr_t, rowptr=rpt),
        lambda: bcsr.bcsr_matvec_plain(vt.abs(), ct, rt, v.abs(), nbr_t, rowptr=rpt),
        sparse_bytes(vt, ct, rt, v) + 4 * nbr_t * vt.shape[1], 2 * vt.numel()))
    got = run(f"A'y over A''s {vt.shape[0]} tiles (the JAX formulation, the xla route's)",
              "A'y", old, *yardsticks("A'y", v, lambda u: torch.mv(d_t.t(), u)))
    for name, g in got.items():
        meas[name]["A'y over A' tiles"] = g
    flat = bc.vals.reshape(-1, bc.vals.shape[2])
    held = meas["K8"]["A x"]["held_bytes"]
    buf = torch.ones(held // 512, 128, device=dev)  # the size of K8's held bytes
    floors = {}
    for key, what, a, beside in (("K9", "A's tiles", flat, "K9a"),
                                 ("K8", "K8's held bytes (A x)", buf, "K8")):
        floors[key] = flushed_ms(lambda: hbm_read_reduce(a, 1.0, block_rows=a.shape[0]))
        print(f"[sparse] the stream's floor for one launch of {what}, "
              f"{sparse_bytes(a) / 1e6:.1f} MB: K10a, one pass, {floors[key]:.4f} ms cold "
              f"({sparse_bytes(a) / floors[key] / 1e6:.1f} GB/s; the bound "
              f"{bound(sparse_bytes(a), 0)[0]:.4f} ms; {beside} A x "
              f"{meas[beside]['A x']['ms']:.4f} ms cold) ({smi})", flush=True)
    del buf
    return meas, floors


def sparse_phase(sparse, bcsr, others, dev, smi):
    """Phase 16: the slice's case on the card, its operators (ELL, BCSR by "pallas",
    "slab" and "xla", dense), the kernels against their plain versions (sparse_checks),
    opnorm2 over three of them, then the engine's solves through the user's entry points:
    AdaPGM on the lasso over all five, AdaPDM on the square-root lasso over ELL, BCSR
    "pallas" and dense, AdaPGM on the logistic loss over ELL and dense. Each solve is
    counted alone: its route's kernel launched once a matvec (two an oracle call, A_evals
    + At_evals for AdaPDM), no other kernel; its final objective within SPARSE_OBJ_RTOL
    of the dense route's. Returns the kernels line's measurements."""
    from adaprox_tpu_torch.experiments import sparse_calibration as sc

    t0 = time.perf_counter()
    d = sc.sparse_case()
    ops = sc.operators(d, dev)
    d_t = ops["dense"].a
    bc = ops["pallas"]
    print(f"[sparse] the case {d.shape} f32, (64, 512) tiles at {sc.SPARSE_DENSITY:g} (seed "
          f"{sc.SPARSE_SEED}): ELL k {ops['ell'].vals.shape[1]} (A, "
          f"{sparse_bytes(ops['ell'].vals, ops['ell'].cols) / 1e6:.1f} MB padded, rows holding "
          f"{int(ops['ell'].row_len.min())}-{int(ops['ell'].row_len.max())} entries, "
          f"{8e-6 * int(ops['ell'].row_len.sum()):.1f} MB), kt {ops['ell'].vals_t.shape[1]} (A', "
          f"{sparse_bytes(ops['ell'].vals_t, ops['ell'].rows_t) / 1e6:.1f} MB padded, "
          f"{int(ops['ell'].row_len_t.min())}-{int(ops['ell'].row_len_t.max())} entries, "
          f"{8e-6 * int(ops['ell'].row_len_t.sum()):.1f} MB); "
          f"BCSR A {bc.vals.shape[0]} tiles (block density {bc.block_density:.4f}, "
          f"{sparse_bytes(bc.vals) / 1e6:.1f} MB, max_bpr {bc.max_bpr}), A' {bc.vals_t.shape[0]} "
          f"tiles ({bc.vals_t.shape[0] / ((bc.rowptr_t.shape[0] - 1) * -(-d.shape[0] // 512)):.4f}, "
          f"{sparse_bytes(bc.vals_t) / 1e6:.1f} MB, max_bpr_t {bc.max_bpr_t}); dense "
          f"{sparse_bytes(d_t) / 1e6:.1f} MB; built in {time.perf_counter() - t0:.1f} s ({smi})",
          flush=True)
    meas, floors = sparse_checks(sparse, bcsr, ops, d_t, dev, smi)

    norms = {r: float(ops[r].opnorm(iters=50)) for r in ("ell", "pallas", "dense")}
    err = max(abs(v - norms["dense"]) / norms["dense"] for v in norms.values())
    check(err <= SPARSE_OPNORM_RTOL, f"opnorm2 over the operators: {norms}")
    print(f"[sparse] opnorm2 (50 power iterations from JAX's draw): "
          f"{', '.join(f'{r} {v:.6f}' for r, v in norms.items())} (rel spread {err:.2e}, tol "
          f"{SPARSE_OPNORM_RTOL:g}) ({smi})", flush=True)

    def counts():
        return (sparse.ell_matvec.launches, bcsr.bcsr_matvec.launches,
                bcsr.bcsr_matvec_slab.launches)

    launches = [0, 0, 0]
    walls = {}
    for name, routes in (("lasso", ("ell", "pallas", "slab", "xla", "dense")),
                         ("sqrt_lasso", ("ell", "pallas", "dense")), ("logreg", ("ell", "dense"))):
        prob = sc.problem(name, ops["dense"])
        objs = {}
        for route in routes:
            before = others()
            sparse.ell_matvec.launches = bcsr.bcsr_matvec.launches = 0
            bcsr.bcsr_matvec_slab.launches = 0
            t1 = time.perf_counter()
            res = sc.solve(name, ops[route], prob)
            torch.cuda.synchronize()
            walls[(name, route)] = time.perf_counter() - t1
            got = counts()
            c = res.counters
            mvs = c.A_evals + c.At_evals if name == "sqrt_lasso" else 2 * c.f_evals
            want = {"ell": (mvs, 0, 0), "pallas": (0, mvs, 0), "slab": (0, 0, mvs)}.get(
                route, (0, 0, 0))
            check(got == want and others() == before and res.numit == sc.SPARSE_MAXIT,
                  f"{name} over {route}: launches (K8, K9a, K9b) {got}, not {want}, or another "
                  f"kernel ran, or numit {res.numit}")
            launches = [a + b for a, b in zip(launches, got)]
            objs[route] = sc.objective(name, ops["dense"], prob, res.x)
        gaps = {r: abs(v - objs["dense"]) / abs(objs["dense"]) for r, v in objs.items()}
        check(all(math.isfinite(v) for v in objs.values())
              and max(gaps.values()) <= sc.SPARSE_OBJ_RTOL,
              f"{name}: final objectives {objs} (gaps to dense {gaps})")
        print(f"[sparse] {name} through the engine, {sc.SPARSE_MAXIT} iterations (tol 0) over "
              f"{', '.join(routes)}: final objective dense {objs['dense']:.7g}, gaps "
              f"{', '.join(f'{r} {g:.2e}' for r, g in gaps.items() if r != 'dense')} (bound "
              f"{sc.SPARSE_OBJ_RTOL:g}, CPU-calibrated); each route's kernel launched once a "
              f"matvec, no other kernel; ms an iteration "
              f"{', '.join(f'{r} {1e3 * walls[(name, r)] / sc.SPARSE_MAXIT:.4f}' for r in routes)}"
              f" ({smi})", flush=True)
    print(f"[sparse] launches on the path: K8 {launches[0]}, K9a {launches[1]}, K9b "
          f"{launches[2]} ({smi})", flush=True)
    del ops, d_t
    return dict(kernels=meas, launches=dict(zip(("K8", "K9a", "K9b"), launches)), walls=walls,
                floors=floors)


# Phase 17: bench's batched regularization path (bench.py:442-480): random_lasso(4000,
# 1000, 10) padded to 4096x1024 f32, 16 lambdas over one A, gamma0 = 1/||A||^2; bench's run
# is tol 0 at maxit 300, and tol 1e-4 (maxit 4000) makes the instances stop apart.
BATCH_LAMS = np.geomspace(0.05, 5.0, 16)
BATCH_RUNS = ((0.0, 300), (1e-4, 4000))
# the four distinct problems of tests/test_kernels.py:282-289 (seeds, lambdas), at
# full width: random_lasso(4000, 1000, 10, seed) padded to 4096x1024
BATCH_DISTINCT = ((0, 1.0), (1, 0.5), (2, 2.0), (3, 1.0))


def padded_lasso(seed, dev):
    """random_lasso(4000, 1000, 10, seed) zero-padded to 4096x1024 f32 and its
    1/||A||^2."""
    from adaprox_tpu_torch.models.synthetic import random_lasso

    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=seed)
    a = torch.zeros(4096, 1024, device=dev)
    a[:4000, :1000] = torch.as_tensor(prob.a, dtype=torch.float32, device=dev)
    b = torch.zeros(4096, device=dev)
    b[:4000] = torch.as_tensor(prob.b, dtype=torch.float32, device=dev)
    return a, b, 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)


def k2b_equals_k2(resident, a, b, x0, scal, maxit, **kw):
    """K2b over the batch, and whether every instance equals its own K2 launch (with
    its f32 scal row) bit for bit: x, numit, norm_res, converged."""
    got = resident.resident_adapgm_batch(a, b, x0, scal, maxit, **kw)
    sc = scal.float().tolist()
    same = True
    for i in range(a.shape[0]):
        one = resident.resident_adapgm(a[i], b[i], x0[i], sc[i][0], sc[i][1], maxit,
                                       p1=sc[i][2], p2=sc[i][3], **kw)
        same = same and all(torch.equal(u[i], w) for u, w in zip(got, one))
    torch.cuda.synchronize()
    return got, same


def batch_phase(resident, apt, ref, counting, dev, smi):
    """Phase 17, K2b: bench's batched case over a shared and a materialized A, each
    instance against its K2 launch bit for bit; four distinct problems in f32 and bf16;
    the plain version; K2b beside the 16 K2 launches and regularization_path.
    Returns the kernels line's measurements."""
    from adaprox_tpu_torch.solvers.batch import regularization_path

    zero_counts, _ = counting
    a, b, gam = ref["a"], ref["b"], ref["gam"]
    bsz, (m, n) = len(BATCH_LAMS), a.shape
    shared = a.expand(bsz, m, n)
    full = shared.contiguous()
    bb = b.expand(bsz, m).contiguous()
    x0 = torch.zeros(bsz, n, device=dev)
    meas = {}
    for tol, maxit in BATCH_RUNS:
        scal = torch.tensor([[gam, tol, lam, 0.0] for lam in BATCH_LAMS])
        got, same = k2b_equals_k2(resident, shared, bb, x0, scal, maxit)
        got_full, same_full = k2b_equals_k2(resident, full, bb, x0, scal, maxit)
        shared_is_full = all(torch.equal(u, w) for u, w in zip(got, got_full))
        numits = got[1].tolist()
        print(f"[batch] K2b 16 x 4096x1024 f32 (lambda geomspace(0.05, 5, 16)), tol {tol:g}, "
              f"maxit {maxit}: numit {numits}; every instance = its K2 launch bit for bit: "
              f"shared A {same}, materialized A {same_full}; shared = materialized: "
              f"{shared_is_full} ({smi})", flush=True)
        check(same and same_full and shared_is_full, f"K2b tol {tol:g}: not K2's bits")
        check(tol > 0 or numits == [maxit] * bsz, "K2b tol 0: not every instance ran maxit")
        check(tol == 0 or len(set(numits)) > 1, "K2b tol 1e-4: every instance stopped together")
        meas[tol] = dict(numit=numits, scal=scal)

    # four distinct problems, f32 and bf16 storage of A, tol 1e-4
    probs = [padded_lasso(seed, dev) for seed, _ in BATCH_DISTINCT]
    a4 = torch.stack([p[0] for p in probs])
    b4 = torch.stack([p[1] for p in probs])
    scal4 = torch.tensor([[p[2], 1e-4, lam, 0.0] for p, (_, lam) in zip(probs, BATCH_DISTINCT)])
    x04 = torch.zeros(4, n, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        got, same = k2b_equals_k2(resident, a4.to(dtype), b4, x04, scal4, 4000)
        print(f"[batch] K2b four problems (seeds 0-3) 4096x1024 {dtype_name(dtype)}, tol 1e-4: "
              f"numit {got[1].tolist()}, converged {got[3].tolist()}; every instance = its K2 "
              f"launch bit for bit: {same} ({smi})", flush=True)
        check(same, f"K2b four problems {dtype}: not K2's bits")

    # the plain version: the fixed rule (no amplification) over bench's 300 iterations
    # at K2's 1e-5; AdaPGM on the four problems over K2's horizon at case (a)'s
    # tolerance (past it f32 rounding steers the two apart: on an H100 at tol 1e-4 seed
    # 2's plain solve stalled at 4000 iterations where K2b stopped at 2266, x 2.2e-7 apart)
    scal_f = meas[0.0]["scal"]
    got = resident.resident_adapgm_batch(shared, bb, x0, scal_f, 300, rule_kind="fixed")
    want = resident.resident_adapgm_batch_plain(shared, bb, x0, scal_f, 300, rule_kind="fixed")
    torch.cuda.synchronize()
    # relative to the batch's largest |x|: the largest lambdas leave x = 0
    max_abs = float((got[0] - want[0]).abs().max())
    err = max_abs / float(want[0].abs().max())
    print(f"[batch] K2b against its plain version, 16 x 4096x1024 f32, fixed rule, tol 0, "
          f"maxit 300: x rel err {err:.2e} (max abs {max_abs:.2e}; tol {K2_FIXED_RTOL:g})",
          flush=True)
    check(got[1].tolist() == want[1].tolist() == [300] * bsz and err <= K2_FIXED_RTOL,
          "K2b disagrees with its plain version (fixed rule)")
    horizon, rtol = K2_HORIZON["adapgm"], K2_CASE_A_RTOL["adapgm"]
    scal0 = scal4.clone()
    scal0[:, 1] = 0.0
    got = resident.resident_adapgm_batch(a4, b4, x04, scal0, horizon)
    want = resident.resident_adapgm_batch_plain(a4, b4, x04, scal0, horizon)
    torch.cuda.synchronize()
    errs = [float((got[0][i] - want[0][i]).abs().max() / want[0][i].abs().max())
            for i in range(4)]
    print(f"[batch] K2b against its plain version, four problems f32 AdaPGM tol 0, {horizon} "
          f"iterations (K2's horizon): x rel err {', '.join(f'{e:.2e}' for e in errs)} "
          f"(tol {rtol:g})", flush=True)
    check(got[1].tolist() == want[1].tolist() == [horizon] * 4 and max(errs) <= rtol,
          "K2b disagrees with its plain version (AdaPGM)")

    # bench's run timed: K2b over the shared A, the 16 K2 launches, its plain version and
    # regularization_path on the card (the engine, one slice after another), and the
    # path's launches counted alone
    scal = meas[0.0]["scal"]
    sc = scal.tolist()
    zero_counts()
    resident.resident_adapgm_batch(shared, bb, x0, scal, 300)
    torch.cuda.synchronize()
    launches = resident.resident_adapgm_batch.launches
    check(launches == 1 and resident.resident_adapgm.launches == 0,
          f"K2b's path: {launches} K2b launches")
    k2b_ms = event_ms(lambda: resident.resident_adapgm_batch(shared, bb, x0, scal, 300), reps=5)
    k2s_ms = event_ms(lambda: [resident.resident_adapgm(a, b, x0[0], s[0], s[1], 300, p1=s[2])
                               for s in sc], reps=3)
    plain_ms, _ = once_ms(lambda: resident.resident_adapgm_batch_plain(shared, bb, x0, scal,
                                                                      300))
    f = apt.LeastSquares(a, b)
    path_ms, path = once_ms(lambda: regularization_path(x0[0], f=f, lams=BATCH_LAMS, gamma=gam,
                                                        tol=0.0, maxit=300))
    check(path.numit.tolist() == [300] * bsz and bool(torch.isfinite(path.x).all()),
          "regularization_path on the card: bad result")
    total = bsz * 301
    bnd = bound(4 * m * n + 4 * bsz * (m + 2 * n + 5) + 16 * bsz, 4 * m * n * total)
    print(f"[batch] bench's batched_regpath 16 x 4096x1024 f32, AdaPGM tol 0, 300 iterations: "
          f"K2b (shared A) {k2b_ms:.4f} ms, {1e3 * k2b_ms / total:.3f} us an instance iteration; "
          f"16 K2 launches {k2s_ms:.4f} ms; the plain version {plain_ms:.2f} ms; "
          f"regularization_path (the engine) {path_ms:.2f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}) | K2b launches on its path {launches} ({smi})", flush=True)
    return dict(launches=launches, max_abs_err=max_abs, ms=k2b_ms, plain_ms=plain_ms,
                bound=bnd, k2_ms=k2s_ms, path_ms=path_ms)


def dtype_name(dtype):
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


# Phase 18: the stream probes at bench's stream_ceiling array (bench.py:259-276): 16384^2,
# 1 GiB in f32, past the 50 MB L2, 200 passes in one launch. The array is |randn| / 128:
# with no cancellation, the sums' 1e-5 of sum |a| is 1e-5 of the value itself, far above
# f32 summation error (about 1e-7 here) and far below what a probe that skips a part of
# A would lose (K10a without its remainder loop skips 0.1%: tests/test_torch_cuda.py).
STREAM_REPEATS = 200
STREAM_RTOL = 1e-5
STREAM_KERNELS = (("K10a", "hbm_read_reduce", "adaprox_tpu/ops/kernels.py:172"),
                  ("K10b", "hbm_copy", "adaprox_tpu/ops/kernels.py:295"),
                  ("K10c", "hbm_dma_read", "adaprox_tpu/ops/kernels.py:254"))


def stream_phase(kernels, big, dev, smi):
    """Phase 18, K10a-c against their plain versions at |A| (16384^2) f32 and bf16, timed
    beside their yardstick library calls (torch.sum for K10a and K10c, torch.mul
    into an output for K10b, each called once a pass). Returns the kernels line's
    measurements (f32)."""
    from adaprox_tpu_torch.utils.profiling import throughput_report

    reps, scale = STREAM_REPEATS, 0.5
    meas = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = big[0].abs().to(dtype)
        size = a.numel() * a.element_size()
        out, out_p = torch.empty_like(a), torch.empty_like(a)
        s_lib = torch.tensor(scale, dtype=torch.float32, device=dev).to(dtype)
        abs_sum = float(a.float().abs().sum())
        rows_abs = float(a[::128, :128].float().abs().sum())
        kernels.hbm_read_reduce.launches = kernels.hbm_copy.launches = 0
        kernels.hbm_dma_read.launches = 0
        got = {"K10a": kernels.hbm_read_reduce(a, scale, repeats=reps),
               "K10b": kernels.hbm_copy(a, scale, repeats=reps, out=out),
               "K10c": kernels.hbm_dma_read(a, scale, repeats=reps)}
        torch.cuda.synchronize()
        launches = {"K10a": kernels.hbm_read_reduce.launches, "K10b": kernels.hbm_copy.launches,
                    "K10c": kernels.hbm_dma_read.launches}
        check(all(v == 1 for v in launches.values()), f"stream probes' launches {launches}")
        plain = {}
        plain_ms = {}
        plain_ms["K10a"], plain["K10a"] = once_ms(
            lambda: kernels.hbm_read_reduce_plain(a, scale, repeats=reps))
        plain_ms["K10b"], plain["K10b"] = once_ms(
            lambda: kernels.hbm_copy_plain(a, scale, repeats=reps, out=out_p))
        plain_ms["K10c"], plain["K10c"] = once_ms(
            lambda: kernels.hbm_dma_read_plain(a, scale, repeats=reps))
        err = {k: abs(float(got[k]) - float(plain[k])) for k in got}
        tol = {"K10a": STREAM_RTOL * abs(scale) * reps * abs_sum,
               "K10b": 0.0,
               "K10c": STREAM_RTOL * (128 * abs(scale) + reps * rows_abs)}
        copy_same = torch.equal(out, out_p)
        ms = {"K10a": event_ms(lambda: kernels.hbm_read_reduce(a, scale, repeats=reps), reps=3),
              "K10b": event_ms(lambda: kernels.hbm_copy(a, scale, repeats=reps, out=out),
                               reps=3),
              "K10c": event_ms(lambda: kernels.hbm_dma_read(a, scale, repeats=reps), reps=3)}

        def lib_sum():
            for _ in range(reps):
                torch.sum(a)

        def lib_mul():
            for _ in range(reps):
                torch.mul(a, s_lib, out=out_p)

        lib = {"K10a": event_ms(lib_sum, reps=3), "K10b": event_ms(lib_mul, reps=3)}
        lib["K10c"] = lib["K10a"]
        moved = {"K10a": reps * size, "K10b": 2 * reps * size, "K10c": reps * size}
        for key, name, _ in STREAM_KERNELS:
            gbps = moved[key] / ms[key] / 1e6
            lib_gbps = moved[key] / lib[key] / 1e6
            frac = throughput_report(ms[key] / 1e3, reps, moved[key] / reps, dev)["frac_roofline"]
            bnd = bound(moved[key], 0)
            roof = 2 * HBM_BYTES_S / 1e9 if key == "K10b" else HBM_BYTES_S / 1e9
            print(f"[stream] {key} {name} 16384^2 {dtype_name(dtype)}, {reps} passes, scale "
                  f"{scale:g}: {ms[key]:.4f} ms, {gbps:.1f} GB/s ({frac:.4f} of the data "
                  f"sheet's 3350 GB/s; bound {bnd[0]:.4f} ms) | abs err {err[key]:.3e} against "
                  f"the plain version (tol {tol[key]:.3e}"
                  f"{'; the copy equal bit for bit: ' + str(copy_same) if key == 'K10b' else ''})"
                  f", plain {plain_ms[key]:.2f} ms | library ({reps} calls of "
                  f"{'torch.mul' if key == 'K10b' else 'torch.sum'}) {lib[key]:.4f} ms, "
                  f"{lib_gbps:.1f} GB/s | launches {launches[key]} ({smi})", flush=True)
            check(err[key] <= tol[key] and (key != "K10b" or copy_same),
                  f"{key} {dtype}: disagrees with its plain version")
            check(gbps <= roof, f"{key} {dtype}: {gbps:.1f} GB/s is past the card's "
                                f"{roof:.0f} GB/s: it cannot have moved every byte")
            if dtype == torch.float32:
                meas[key] = dict(launches=launches[key], max_abs_err=err[key], ms=ms[key],
                                 plain_ms=plain_ms[key], bound=bnd, library_ms=lib[key],
                                 gbps=gbps, frac=frac, bf16_ms=None)
            else:
                meas[key]["bf16_ms"] = ms[key]
        del out, out_p
    return meas


def main():
    t_start = time.perf_counter()
    # 1. device --------------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(smi)
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    import adaprox_tpu_torch as apt
    from adaprox_tpu_torch.experiments import lasso
    from adaprox_tpu_torch.experiments.common import pad_tiles
    from adaprox_tpu_torch.models.synthetic import random_lasso
    from adaprox_tpu_torch.ops import (bcsr, kernels, pd_kernels, resident, resident_bt,
                                       resident_f0, resident_mp, resident_pd, sparse)
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import chip_bandwidth_gbps, flushed_ms, timed

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(13) as pool:
        builds = [(name, pool.submit(build)) for name, build in
                  (("K1", kernels.build_library),
                   ("K3", lambda: kernels.build_library(kernels.LOGISTIC_SOURCE)),
                   ("K2/K2c", resident.build_library),
                   ("K4/K4b", resident_bt.build_library),
                   ("K4 (aGRAAL)", resident_bt.build_agraal_library),
                   ("K6d", resident_pd.build_library),
                   ("K6a/K6b/K6c", resident_pd.build_grid_library),
                   ("K7d/K7c", resident_f0.build_library),
                   ("K7a/K7b", resident_f0.build_grid_library),
                   ("K5", pd_kernels.build_library),
                   ("K8", sparse.build_library),
                   ("K9a/K9b", bcsr.build_library),
                   ("K10a-c", lambda: kernels.build_library(kernels.STREAM_SOURCE)))]
        for name, fut in builds:
            lib_path = fut.result()
            regs = ptxas_report(lib_path.with_suffix(".log").read_text())
            print(f"[build] {name} {lib_path.name} (ptxas, registers/stack bytes/spill-store "
                  f"bytes: {'; '.join(regs)})", flush=True)
    print(f"[build] all thirteen in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernels vs plain on the card ------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def problem(m, n):
        a = torch.randn(m, n, generator=gen, device=dev) / math.sqrt(n)
        return a, torch.randn(m, generator=gen, device=dev), torch.randn(n, generator=gen, device=dev)

    big = problem(HEADLINE, HEADLINE)
    cases = [("16384x16384 f32", *big),
             ("16384x16384 bf16", big[0].to(torch.bfloat16), *big[1:]),
             ("4000x1024 f32 (driver, padded)", *problem(4000, 1024)),
             ("1000x300 f32 (unaligned)", *problem(1000, 300))]
    measured = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    roof = chip_bandwidth_gbps(dev)
    for name, a, b, x in cases:
        f_k, g_k = kernels.fused_ls_value_grad(a, b, x)
        f_p, g_p = kernels.ls_value_grad_plain(a, b, x)  # bf16: the same values upcast
        torch.cuda.synchronize()
        err_f = abs(float(f_k - f_p)) / abs(float(f_p))
        abs_g = float((g_k - g_p).abs().max())
        err_g = abs_g / float(g_p.abs().max())
        check(math.isfinite(err_f) and math.isfinite(err_g), f"K1 {name}: non-finite result")
        check(err_f <= KERNEL_RTOL and err_g <= KERNEL_RTOL, f"K1 {name} disagrees with plain")
        a_plain = a.float()  # time the plain version on f32 storage, as LeastSquares runs it

        def k1():
            return kernels.fused_ls_value_grad(a, b, x)

        ms_k = event_ms(k1)
        warm, cold = flushed_ms(k1, flush_bytes=0), flushed_ms(k1)
        ms_p = event_ms(lambda: kernels.ls_value_grad_plain(a_plain, b, x))
        km, kn = a.shape
        # A read once, b and x in, f and grad out; 4 m n flops
        k1_bytes = a.element_size() * km * kn + 4 * (km + kn) + 4 * (kn + 1)
        k1_bound = bound(k1_bytes, 4 * km * kn)
        gbps = k1_bytes / cold / 1e6
        check(gbps <= HBM_BYTES_S / 1e9, f"K1 {name}: {gbps:.1f} GB/s cold, past the card's "
              f"{HBM_BYTES_S / 1e9:.0f} GB/s: it cannot have read all of A")
        plan = kernels.k1_plan(km, kn, a.element_size(), sms)
        measured[name] = dict(max_abs_err=abs_g, ms=ms_k, plain_ms=ms_p, warm_ms=warm,
                              cold_ms=cold, plan=plan)
        print(f"[kernels] K1 {name}: rel err f {err_f:.2e}, grad {err_g:.2e} "
              f"(max abs {abs_g:.2e}; tol {KERNEL_RTOL:g}) | K1 {ms_k:.4f} ms eager, host hidden "
              f"warm {warm:.4f} / cold {cold:.4f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), "
              f"cold {gbps:.1f} GB/s ({gbps / roof:.3f} of {roof:.0f}) | plan {plan['regime']}: "
              f"grid {plan['grid']} x {plan['threads']} threads, cluster {plan['cluster']}, "
              f"{plan['slots']} slots of {plan['rows_per_slot']} rows, stages {plan['stages']}, "
              f"shared memory {plan['smem']} B | plain {ms_p:.4f} ms ({smi})", flush=True)
        del a_plain
    ref, k2_meas = k2_checks(resident, dev, smi)
    k2c_checks(resident, ref, smi)
    k3_meas = k3_checks(kernels, big, dev, smi)
    logreg = logreg_inputs("mushrooms", dev)
    k2_logreg_checks(resident, logreg, smi)
    k2c_lockstep_checks(resident, ref, logreg, dev, smi)

    # 4. the driver (main path) ----------------------------------------------
    def zero_counts():
        kernels.fused_ls_value_grad.launches = resident.resident_adapgm.launches = 0
        resident.resident_rule_sweep.launches = kernels.fused_logistic_value_grad.launches = 0
        resident_bt.resident_backtracking.launches = resident_bt.resident_bt_sweep.launches = 0
        resident_bt.resident_agraal.launches = 0
        resident_pd.resident_adapdm_dsvm.launches = 0
        resident_pd.resident_adapdm_dsvm_sweep.launches = resident_pd.resident_cv_dsvm.launches = 0
        resident_mp.resident_mp_dsvm_sweep.launches = 0
        resident_f0.resident_condat_vu.launches = 0
        resident_f0.resident_mpls_sweep.launches = resident_f0.resident_adapdmp_sweep.launches = 0
        resident_f0.resident_cv_grid.launches = resident_f0.resident_mpls_grid.launches = 0
        resident_f0.resident_adapdmp_grid.launches = 0
        pd_kernels.fused_pd_primal_update.launches = sparse.ell_matvec.launches = 0
        bcsr.bcsr_matvec.launches = bcsr.bcsr_matvec_slab.launches = 0
        resident.resident_adapgm_batch.launches = kernels.hbm_read_reduce.launches = 0
        kernels.hbm_copy.launches = kernels.hbm_dma_read.launches = 0

    def read_counts():
        """Launches of (K1, K2, K2c, K3, K4, K4b, K4 (aGRAAL)) since zero_counts()."""
        return (kernels.fused_ls_value_grad.launches, resident.resident_adapgm.launches,
                resident.resident_rule_sweep.launches, kernels.fused_logistic_value_grad.launches,
                resident_bt.resident_backtracking.launches, resident_bt.resident_bt_sweep.launches,
                resident_bt.resident_agraal.launches)

    counts, walls = {}, {}
    for path in ("fused", "resident"):
        outdir = os.path.join("results", "chip_smoke", path)
        zero_counts()
        lasso.main([f"--{path}", "--sizes", "4000x1000x10", "--maxit", "2000", "--tol", "1e-7",
                    "--device", "cuda", "--outdir", outdir, "--no-plot"])
        torch.cuda.synchronize()
        counts[path] = read_counts()
        rows = read_jsonl(os.path.join(outdir, "lasso_4000_1000_10.jsonl"))
        optimum = rows[0]["objective"]
        last = {r["method"]: r for r in rows if r.get("method")}
        check(list(last) == list(GAP_BOUND), f"driver rows {list(last)}")
        check(rows[-1]["fast_path"] == path, f"driver took {rows[-1]['fast_path']}, not {path}")
        walls[path] = rows[-1]["wall_s"]
        # the oracle calls the rows count, and three kinds of K1 call that the last
        # rows do not count: the Nesterov (fixed) row's logging-only f.value(x) of
        # each recorded iteration, the Nesterov (backtracking) row's momentum point
        # after its last record (its f_evals is taken at the record), and aGRAAL's
        # record objective f.value(x) of each iteration and its gradient after the
        # last record (2 + 2 numit calls against the last row's numit + 1)
        oracle_calls = sum(r["f_evals"] for r in last.values())
        logging_calls = last["Nesterov (fixed)"]["it"] + 1 + last["aGRAAL"]["it"] + 1
        parts = []
        for name, r in last.items():
            gap = r["objective"] - optimum
            parts.append(f"{name}: numit {r['it']}, F-F* {gap:.3e} (bound {GAP_BOUND[name]:g})")
            check(math.isfinite(gap) and abs(gap) <= GAP_BOUND[name], f"{name}: F-F* {gap}")
        grid = rows[-2].get("grid_total_s")
        print(f"[driver] lasso 4000x1000x10 --{path} f32: {'; '.join(parts)} | K1 launches "
              f"{counts[path][0]}, K2 launches {counts[path][1]}, K2c launches "
              f"{counts[path][2]}, K4/K4b/aGRAAL launches {counts[path][4:]}, oracle calls "
              f"{oracle_calls}, uncounted f calls {logging_calls} | wall_s {walls[path]}, "
              f"grid_total_s {grid} ({smi})", flush=True)
        if path == "fused":
            check(counts[path][0] == oracle_calls + logging_calls > 0
                  and counts[path][1:] == (0,) * 6,
                  "--fused: K1 launches != oracle calls + uncounted f calls (or another kernel)")
        else:
            check(counts[path] == (0, 0, 1, 0, 0, 1, 1) and grid is not None,
                  "--resident: not exactly one K2c, one K4b and one aGRAAL launch (and nothing "
                  "else)")

    # 5. the headline ----------------------------------------------------------
    a, b, _ = big
    x0 = torch.zeros(HEADLINE, device=dev)
    for fused in (True, False):
        f = apt.LeastSquares(a, b, fused=fused)

        def run():
            return apt.adaptive_proxgrad(x0, f=f, g=apt.L1Norm(0.01),
                                         rule=apt.AdaPGMRule(gamma=1e-3), tol=0.0,
                                         maxit=HEADLINE_ITERS)

        secs, res = timed(run, reps=3)
        check(res.numit == HEADLINE_ITERS and math.isfinite(float(res.norm_res))
              and bool(torch.isfinite(res.x).all()), f"headline fused={fused}: bad result")
        ips = HEADLINE_ITERS / secs
        bytes_per_iter = (1 if fused else 2) * HEADLINE * HEADLINE * 4
        print(f"[headline] AdaPGM 16384^2 f32 {'fused (K1)' if fused else 'two-matmul'}: "
              f"{ips:.1f} iters/s, {bytes_per_iter * ips / 1e9:.1f} GB/s of A "
              f"(norm_res {float(res.norm_res):.3e}; {smi})", flush=True)

    # 6. the resident reference size -------------------------------------------
    # bench.py's resident_reference_size: random_lasso(4000, 1000, 10) padded
    # to 4096x1024, f32, lam 1, tol 1e-4, maxit 4000, gamma0 = 1/||A||^2
    # K2's own path now: one solve through resident_adapgm_l1, counted
    a, b, x0, gam = ref["a"], ref["b"], ref["x0"], ref["gam"]
    zero_counts()
    resident.resident_adapgm_l1(a, b, x0, gam, 1.0, 1e-4, 4000)
    torch.cuda.synchronize()
    counts["single"] = read_counts()
    check(counts["single"] == (0, 1, 0, 0, 0, 0, 0),
          f"single solve: launches {counts['single']}")
    secs, out = timed(lambda: resident.resident_adapgm_l1(a, b, x0, gam, 1.0, 1e-4, 4000),
                      reps=5)
    numit = int(out[1])
    check(bool(out[3]) and numit == k2_meas["numit"], "resident reference size: K2 run differs")
    k2_ms = 1e3 * secs
    print(f"[resident] K2 4096x1024 f32 lam 1 tol 1e-4: solve {k2_ms:.4f} ms (CUDA events, "
          f"best of 5 after a warm-up), numit {numit}, {numit / secs:.1f} iters/s, converged "
          f"{bool(out[3])} ({smi})", flush=True)
    plain_s, _ = timed(lambda: resident.resident_adapgm_plain(a, b, x0, gam, 1e-4, 4000,
                                                              p1=1.0), reps=1)
    f = apt.LeastSquares(a, b, fused=True)
    e_secs, e_res = timed(lambda: apt.adaptive_proxgrad(
        x0, f=f, g=apt.L1Norm(1.0), rule=apt.AdaPGMRule(gamma=gam), tol=1e-4, maxit=4000),
        reps=3)
    e_conv = float(e_res.norm_res) <= 1e-4
    print(f"[resident] engine AdaPGM --fused (K1), same problem and tol: wall {1e3 * e_secs:.2f} "
          f"ms, numit {e_res.numit}, {e_res.numit / e_secs:.1f} iters/s, converged {e_conv} | "
          f"K2's plain version {1e3 * plain_s:.2f} ms ({smi})", flush=True)
    check(e_conv, "resident reference size: the engine did not converge")
    # per-iteration cost, 1000 iterations of the fixed rule with the zero prox
    # (the rule's and the prox's work is a few flops either way; with l1 the
    # iterate can sit at 0, where the residual is exactly 0 and the run stops):
    # the reference size, and a full grid with almost no work (8x2176: one CTA
    # per SM, each warp a dot product of 8), which leaves the three grid syncs
    # and the latency; and 8192x2048, whose A and A^T (134 MB) are past the
    # 50 MB L2, so every iteration streams them from HBM
    for m_, n_ in ((4096, 1024), (8, 2176), (8192, 2048)):
        if (m_, n_) == (4096, 1024):
            a_, b_, gam_ = a, b, gam
        else:
            a_ = torch.randn(m_, n_, generator=gen, device=dev) / n_
            b_ = torch.randn(m_, generator=gen, device=dev)
            gam_ = 1.0 / float((a_ * a_).sum())  # 1/||A||_F^2 <= 1/||A||^2: a stable step
        x0_ = torch.zeros(n_, device=dev)
        it_secs, it_out = timed(lambda: resident.resident_adapgm(
            a_, b_, x0_, gam_, 0.0, 1000, prox_kind="zero", rule_kind="fixed"), reps=3)
        check(int(it_out[1]) == 1000, f"K2 {m_}x{n_}: {int(it_out[1])} of 1000 iterations")
        print(f"[resident] K2 {m_}x{n_} f32, fixed rule, zero prox, 1000 iterations: "
              f"{1e3 * it_secs:.3f} us an iteration ({smi})", flush=True)
    # the momentum iteration at 4096x1024, zero prox, 1000 iterations: a one-row
    # sweep (always record mode), and K2 with and without records
    rows = resident.rule_rows([(gam, "fixed", True)], tol=0.0, maxit=1000)
    for label, fn in (
            ("K2c one-row sweep, record", lambda: resident.resident_rule_sweep(
                a, b, x0, rows, 0.0, 1000, prox_kind="zero")),
            ("K2 momentum, record", lambda: resident.resident_adapgm(
                a, b, x0, gam, 0.0, 1000, prox_kind="zero", momentum=True, record=True)),
            ("K2 momentum, no record", lambda: resident.resident_adapgm(
                a, b, x0, gam, 0.0, 1000, prox_kind="zero", momentum=True))):
        it_secs, it_out = timed(fn, reps=3)
        check(int(it_out[1].reshape(-1)[0]) == 1000, f"{label}: not 1000 iterations")
        print(f"[resident] {label}, 4096x1024 f32, zero prox, 1000 iterations: "
              f"{1e3 * it_secs:.3f} us an iteration ({smi})", flush=True)

    # the lasso driver's four rows at 4000x1000x10 (padded to 4000x1024 f32,
    # maxit 2000, tol 1e-7): one K2c sweep, four single K2 launches, its plain
    # version, beside the engine rows of phase 4 (--fused wall_s)
    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a_d, b_d = pad_tiles(torch.as_tensor(prob.a, dtype=torch.float32, device=dev),
                         torch.as_tensor(prob.b, dtype=torch.float32, device=dev))
    gam_d = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0_d = torch.zeros(a_d.shape[1], device=dev)
    rows_d = resident.rule_rows([(gam_d, rule, mom) for _, rule, mom in MENU], tol=1e-7,
                                maxit=2000)
    sweep_s, sweep_out = timed(lambda: resident.resident_rule_sweep(
        a_d, b_d, x0_d, rows_d, 1e-7, 2000, p1=prob.lam), reps=3)
    singles = [timed(lambda rule=rule, mom=mom: resident.resident_adapgm(
        a_d, b_d, x0_d, gam_d, 1e-7, 2000, p1=prob.lam, rule_kind=rule, momentum=mom,
        record=True), reps=3)[0] for _, rule, mom in MENU]
    # each row alone as a one-row sweep: where a sweep row and its single K2
    # launch differ in time
    ones = [timed(lambda j=j: resident.resident_rule_sweep(
        a_d, b_d, x0_d, rows_d[j:j + 1], 1e-7, 2000, p1=prob.lam), reps=3)[0]
        for j in range(len(MENU))]
    sweep_plain_s, sweep_plain = timed(lambda: resident.resident_rule_sweep_plain(
        a_d, b_d, x0_d, rows_d, 2000, p1=prob.lam), reps=1)
    k2c_err = menu_checks(sweep_out, sweep_plain, smi)
    numits = sweep_out[1].tolist()
    engine_s = sum(walls["fused"].values())
    print(f"[resident] lasso menu 4000x1000x10 f32 (numit {numits}): one K2c sweep "
          f"{1e3 * sweep_s:.4f} ms; four single K2 launches {1e3 * sum(singles):.4f} ms "
          f"({', '.join(f'{1e3 * t:.4f}' for t in singles)}); each row as a one-row sweep "
          f"({', '.join(f'{1e3 * t:.4f}' for t in ones)}); the sweep's plain version "
          f"{1e3 * sweep_plain_s:.2f} ms; the four engine rows under --fused (phase 4 wall_s) "
          f"{1e3 * engine_s:.2f} ms ({smi})", flush=True)

    # 7. sparse logistic regression ---------------------------------------------
    k3_calls, logreg_sweeps = logreg_phase(apt, resident, logreg, (zero_counts, read_counts), dev,
                                           smi)

    # 8. the cubic model -------------------------------------------------------
    cubic_models = cubic_checks(resident, dev, smi)
    cubic_phase(resident, cubic_models, (zero_counts, read_counts), dev, smi)

    # 9. backtracking ------------------------------------------------------------
    k4_err = bt_checks(resident_bt, ref, logreg, cubic_models, dev, smi)
    k4_meas, k4b_meas = bt_phase(resident, resident_bt, ref, (zero_counts, read_counts), dev,
                                 smi)

    # 10. aGRAAL ---------------------------------------------------------------------
    ag_err = agraal_checks(resident_bt, ref, logreg, cubic_models, dev, smi)
    ag_meas = agraal_phase(resident, resident_bt, (zero_counts, read_counts), dev, smi)

    # 11. the dual-SVM primal-dual kernels ---------------------------------------------
    t11 = time.perf_counter()
    pd_err = pd_checks(resident_pd, dev, smi)
    pd_meas, driver_mp = pd_phase(resident, resident_pd, resident_mp, ref,
                                  (zero_counts, read_counts), dev, smi)
    print(f"[pd] phase 11 wall {time.perf_counter() - t11:.1f} s ({smi})", flush=True)

    # 12. the Malitsky-Pock kernel ------------------------------------------------------
    t12 = time.perf_counter()
    mp_err = mp_checks(resident_mp, dev, smi)
    mp_meas = mp_phase(resident_pd, resident_mp, driver_mp, pd_meas["pd_us"],
                       (zero_counts, read_counts), dev, smi)
    print(f"[mp] phase 12 wall {time.perf_counter() - t12:.1f} s ({smi})", flush=True)

    # 13. the f = 0 family's Condat-Vu and t-sweep kernels -------------------------------
    t13 = time.perf_counter()
    f0_err = f0_checks(resident_f0, dev, smi)
    k7a_err = k7a_checks(resident_f0, dev, smi)
    f0_meas = f0_phase(resident_f0, resident_pd, (zero_counts, read_counts), dev, smi)
    print(f"[f0] phase 13 wall {time.perf_counter() - t13:.1f} s ({smi})", flush=True)

    # 14. the f = 0 family's dataset grids ------------------------------------------------
    t14 = time.perf_counter()
    grid_err = grid_checks(resident_f0, dev, smi)
    grid_meas = grid_phase(resident_f0, resident_pd, f0_meas, (zero_counts, read_counts), dev,
                           smi)
    print(f"[grid] phase 14 wall {time.perf_counter() - t14:.1f} s ({smi})", flush=True)

    # 15. the fused primal-dual update ----------------------------------------------------
    t15 = time.perf_counter()

    def other_counts():
        """Launches of every kernel but K5."""
        return read_counts() + tuple(k.launches for k in (
            resident_pd.resident_adapdm_dsvm, resident_pd.resident_adapdm_dsvm_sweep,
            resident_pd.resident_cv_dsvm, resident_mp.resident_mp_dsvm_sweep,
            resident_f0.resident_condat_vu, resident_f0.resident_mpls_sweep,
            resident_f0.resident_adapdmp_sweep, resident_f0.resident_cv_grid,
            resident_f0.resident_mpls_grid, resident_f0.resident_adapdmp_grid))

    k5_meas = k5_checks(pd_kernels, big, dev, smi)
    pdf_meas = pd_fused_phase(pd_kernels, other_counts, f0_meas["f_refs"], big, dev, smi)
    print(f"[pd_fused] phase 15 wall {time.perf_counter() - t15:.1f} s ({smi})", flush=True)

    # 16. the sparse data path -------------------------------------------------------------
    t16 = time.perf_counter()
    sp_meas = sparse_phase(
        sparse, bcsr, lambda: other_counts() + (pd_kernels.fused_pd_primal_update.launches,),
        dev, smi)
    print(f"[sparse] phase 16 wall {time.perf_counter() - t16:.1f} s ({smi})", flush=True)

    # 17. K2b, the batch of independent solves ----------------------------------------------
    t17 = time.perf_counter()
    k2b_meas = batch_phase(resident, apt, ref, (zero_counts, read_counts), dev, smi)
    print(f"[batch] phase 17 wall {time.perf_counter() - t17:.1f} s ({smi})", flush=True)

    # 18. the stream probes -------------------------------------------------------------------
    t18 = time.perf_counter()
    zero_counts()
    st_meas = stream_phase(kernels, big, dev, smi)
    print(f"[stream] phase 18 wall {time.perf_counter() - t18:.1f} s ({smi})", flush=True)
    print(f"[smoke] all phases {time.perf_counter() - t_start:.1f} s (before K6 went onto "
          f"clusters: {PREVIOUS_WALL_S} s)", flush=True)

    head = measured["16384x16384 f32"]
    k5_head = k5_meas[f"{HEADLINE}x{HEADLINE} f32"]
    k3_head = k3_meas["16384x16384 f32"]
    hm = hn = HEADLINE
    k1_bound = bound(4 * hm * hn + 4 * (hm + hn) + 4 * (hn + 1), 4 * hm * hn)
    m, n = a.shape
    # K2: A read once, b and x0 in, x and the stats out; 4 m n flops for each
    # iteration and the warm-up
    k2_bound = bound(a.element_size() * m * n + 4 * (m + n) + 4 * n + 16,
                     4 * m * n * (numit + 1))
    # K2c on the driver's menu: A read once, b, x0 and the rows in, x, the stats
    # and the histories out; 4 m n flops for each rule iteration and warm-up,
    # 6 m n for each momentum iteration in record mode (A z, A'res, A x_new)
    m, n = a_d.shape
    r = len(MENU)
    k2c_bound = bound(4 * m * n + 4 * (m + n) + 20 * r + 4 * r * n + 16 * r + 12 * r * 2000,
                      sum(6 * m * n * k if mom else 4 * m * n * (k + 1)
                          for (_, _, mom), k in zip(MENU, numits)))
    print(json.dumps({"kernels": [{
        "name": "fused_ls_value_grad", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/fused_ls.cu",
        "replaces": "adaprox_tpu/ops/kernels.py:99",
        "launches": counts["fused"][0], "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1], "library_ms": None, "warm_ms": head["warm_ms"],
        "cold_ms": head["cold_ms"], "regime": head["plan"]["regime"]}, {
        "name": "resident_adapgm", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_pg.cu",
        "replaces": "adaprox_tpu/ops/resident.py:442",
        "launches": counts["single"][1], "max_abs_err": k2_meas["max_abs_err"],
        "ms": k2_ms, "plain_ms": 1e3 * plain_s, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None, "objectives": ["ls", "logreg", "cubic"]}, {
        "name": "resident_rule_sweep", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_pg.cu",
        "replaces": "adaprox_tpu/ops/resident.py:616",
        "launches": counts["resident"][2], "max_abs_err": k2c_err,
        "ms": 1e3 * sweep_s, "plain_ms": 1e3 * sweep_plain_s, "bound_ms": k2c_bound[0],
        "bound_by": k2c_bound[1], "library_ms": None, "objectives": ["ls", "logreg", "cubic"]}, {
        "name": "fused_logistic_value_grad", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/fused_logistic.cu",
        "replaces": "adaprox_tpu/ops/kernels.py:381",
        "launches": k3_calls, "max_abs_err": k3_head["max_abs_err"],
        "ms": k3_head["ms"], "plain_ms": k3_head["plain_ms"], "bound_ms": k3_head["bound"][0],
        "bound_by": k3_head["bound"][1], "library_ms": None}, {
        "name": "resident_backtracking", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_bt.cu",
        "replaces": "adaprox_tpu/ops/resident_bt.py:379",
        "launches": k4_meas["launches"], "max_abs_err": k4_err,
        "ms": k4_meas["ms"], "plain_ms": k4_meas["plain_ms"], "bound_ms": k4_meas["bound"][0],
        "bound_by": k4_meas["bound"][1], "library_ms": None,
        "objectives": ["ls", "logreg", "cubic"]}, {
        "name": "resident_bt_sweep", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_bt.cu",
        "replaces": "adaprox_tpu/ops/resident_bt.py:486",
        "launches": counts["resident"][5], "max_abs_err": k4b_meas["max_abs_err"],
        "ms": k4b_meas["ms"], "plain_ms": k4b_meas["plain_ms"], "bound_ms": k4b_meas["bound"][0],
        "bound_by": k4b_meas["bound"][1], "library_ms": None,
        "objectives": ["ls", "logreg", "cubic"]}, {
        "name": "resident_agraal", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_agraal.cu",
        "replaces": "adaprox_tpu/ops/resident_bt.py:423",
        "launches": counts["resident"][6], "max_abs_err": ag_err,
        "ms": ag_meas["ms"], "plain_ms": ag_meas["plain_ms"], "bound_ms": ag_meas["bound"][0],
        "bound_by": ag_meas["bound"][1], "library_ms": None,
        "objectives": ["ls", "logreg", "cubic"]}] + [{
        "name": name, "route": "cuda", "source": f"adaprox_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": pd_meas[key]["launches"], "max_abs_err": pd_err[key],
        "ms": pd_meas[key]["ms"], "plain_ms": pd_meas[key]["plain_ms"],
        "bound_ms": pd_meas[key]["bound"][0], "bound_by": pd_meas[key]["bound"][1],
        "library_ms": None, **({"plain_depth": PD_PLAIN_CUT, "ms_at_plain_depth":
                                pd_meas[key]["cut_ms"], "it_us": pd_meas["pd_us"],
                                "driver_ms": {f"{d} C {c:g}": v[0]
                                              for (d, c), v in pd_meas["driver"].items()}}
                               if key == "k6b" else {})}
        for name, source, replaces, key in (
            ("resident_adapdm_dsvm", "resident_dsvm_grid.cu", "adaprox_tpu/ops/resident.py:1388",
             "k6a"),
            ("resident_adapdm_dsvm_sweep", "resident_dsvm_grid.cu",
             "adaprox_tpu/ops/resident.py:1447", "k6b"),
            ("resident_cv_dsvm", "resident_pd.cu", "adaprox_tpu/ops/resident.py:1284",
             "k6d"))] + [{
        "name": "resident_mp_dsvm_sweep", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_dsvm_grid.cu",
        "replaces": "adaprox_tpu/ops/resident.py:1196", "launches": pd_meas["k6c"]["launches"],
        "max_abs_err": mp_err, "ms": mp_meas["ms"], "plain_ms": mp_meas["plain_ms"],
        "bound_ms": mp_meas["bound"][0], "bound_by": mp_meas["bound"][1], "library_ms": None,
        "depth": MP_CUT, "driver_ms": {f"{d} C {c:g}": v[1]
                                       for (d, c), v in pd_meas["driver"].items()},
        "driver_bound_ms": pd_meas["k6c"]["driver_bound"][0], "it_us": mp_meas["it_us"]}, {
        "name": "resident_condat_vu", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_cv.cu",
        "replaces": "adaprox_tpu/ops/resident.py:2056", "launches": f0_meas["launches"],
        "max_abs_err": f0_err, "ms": f0_meas["ms"], "plain_ms": f0_meas["plain_ms"],
        "bound_ms": f0_meas["bound"][0], "bound_by": f0_meas["bound"][1], "library_ms": None,
        "it_us": f0_meas["it_us"]}] + [{
        "name": name, "route": "cuda", "source": "adaprox_tpu_torch/csrc/resident_f0_grid.cu",
        "replaces": replaces, "launches": f0_meas["k7a"][core]["launches"],
        "max_abs_err": k7a_err, "ms": f0_meas["k7a"][core]["ms"],
        "plain_ms": f0_meas["k7a"][core]["plain_ms"],
        "bound_ms": f0_meas["k7a"][core]["bound"][0],
        "bound_by": f0_meas["k7a"][core]["bound"][1], "library_ms": None,
        "it_us": f0_meas["k7a"][core]["it_us"], "ms_at": f0_meas["k7a"][core]["ms_at"],
        "driver_ms": f0_meas["k7a"][core]["driver_ms"],
        "driver_bound_ms": f0_meas["k7a"][core]["driver_bound_ms"]} for name, replaces, core in (
            ("resident_mpls_sweep", "adaprox_tpu/ops/resident.py:2096", "MP"),
            ("resident_adapdmp_sweep", "adaprox_tpu/ops/resident.py:2282", "AdaPDM+"))] + [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": grid_meas[key]["launches"], "max_abs_err": grid_err[err_key],
        "ms": grid_meas[key]["ms"], "plain_ms": grid_meas[key]["plain_ms"],
        "bound_ms": grid_meas[key]["bound"][0], "bound_by": grid_meas[key]["bound"][1],
        "library_ms": None, "ms_at": grid_meas[key]["ms_at"],
        "driver_ms": grid_meas[key]["driver_ms"],
        "driver_bound_ms": grid_meas[key]["driver_bound_ms"]}
        for name, source, replaces, key, err_key in (
            ("resident_mpls_grid", "adaprox_tpu_torch/csrc/resident_f0_grid.cu",
             "adaprox_tpu/ops/resident.py:2040", "MP", "K7b"),
            ("resident_adapdmp_grid", "adaprox_tpu_torch/csrc/resident_f0_grid.cu",
             "adaprox_tpu/ops/resident.py:2047", "AdaPDM+", "K7b"),
            ("resident_cv_grid", "adaprox_tpu_torch/csrc/resident_cv.cu",
             "adaprox_tpu/ops/resident.py:1988", "K7c", "K7c"))] + [{
        "name": "fused_pd_primal_update", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/fused_pd.cu",
        "replaces": "adaprox_tpu/ops/pd_kernels.py:127", "launches": pdf_meas["launches"],
        "max_abs_err": k5_head["max_abs_err"], "ms": k5_head["ms"],
        "plain_ms": k5_head["plain_ms"], "bound_ms": k5_head["bound"][0],
        "bound_by": k5_head["bound"][1], "library_ms": None, "two_mv_ms": k5_head["mv_ms"],
        "ms_at": {k: {"ms": v["ms"], "graph_ms": v["graph_ms"], "bound_ms": v["bound"][0]}
                  for k, v in k5_meas.items()}}] + [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sp_meas["launches"][key],
        "max_abs_err": max(v["max_abs_err"] for v in sp_meas["kernels"][key].values()),
        "ms": sp_meas["kernels"][key]["A x"]["ms"],
        "plain_ms": sp_meas["kernels"][key]["A x"]["plain_ms"],
        "bound_ms": sp_meas["kernels"][key]["A x"]["bound"][0],
        "bound_by": sp_meas["kernels"][key]["A x"]["bound"][1],
        "library_ms": sp_meas["kernels"][key]["A x"]["library_ms"],
        "warm_ms": sp_meas["kernels"][key]["A x"]["warm_ms"],
        "stream_floor_ms": sp_meas["floors"]["K8" if key == "K8" else "K9"],
        **({k: sp_meas["kernels"][key]["A x"][k]
            for k in ("held_bytes", "padded_bytes", "padded_ms")}
           | {"padded_bound_ms": sp_meas["kernels"][key]["A x"]["padded_bound"][0]}
           if key == "K8" else {}),
        "ms_at": {d: {"ms": v["ms"], "warm_ms": v["warm_ms"], "gbps": v["gbps"],
                      "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                      "csr_ms": v["library_ms"], "csr_warm_ms": v["library_warm_ms"],
                      "bsr_ms": v["bsr_ms"], "dense_mv_ms": v["dense_ms"],
                      **({"held_bytes": v["held_bytes"], "padded_bytes": v["padded_bytes"],
                          "padded_bound_ms": v["padded_bound"][0],
                          "padded_ms": v["padded_ms"]} if key == "K8" else {})}
                  for d, v in sp_meas["kernels"][key].items()}}
        for key, name, source, replaces in SPARSE_KERNELS] + [{
        "name": "resident_adapgm_batch", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_pg.cu",
        "replaces": "adaprox_tpu/ops/resident.py:531", "launches": k2b_meas["launches"],
        "max_abs_err": k2b_meas["max_abs_err"], "ms": k2b_meas["ms"],
        "plain_ms": k2b_meas["plain_ms"], "bound_ms": k2b_meas["bound"][0],
        "bound_by": k2b_meas["bound"][1], "library_ms": None, "k2_launches_ms": k2b_meas["k2_ms"],
        "regularization_path_ms": k2b_meas["path_ms"]}] + [{
        "name": name, "route": "cuda", "source": "adaprox_tpu_torch/csrc/hbm_stream.cu",
        "replaces": replaces, "launches": st_meas[key]["launches"],
        "max_abs_err": st_meas[key]["max_abs_err"], "ms": st_meas[key]["ms"],
        "plain_ms": st_meas[key]["plain_ms"], "bound_ms": st_meas[key]["bound"][0],
        "bound_by": st_meas[key]["bound"][1], "library_ms": st_meas[key]["library_ms"],
        "library_calls": STREAM_REPEATS, "gbps": st_meas[key]["gbps"],
        "frac_roofline": st_meas[key]["frac"], "bf16_ms": st_meas[key]["bf16_ms"]}
        for key, name, replaces in STREAM_KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
