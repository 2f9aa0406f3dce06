"""Times the whole-solve kernels K2 and K2c (``csrc/resident_pg.cu``) and
the backtracking kernels K4 and K4b (``csrc/resident_bt.cu``) on one card, at
the shapes that set their cost, and prints the card's name and power limit,
then one line of JSON.

    python -m adaprox_tpu_torch.experiments.resident_timing [--reps 5]

CUDA events, best of ``--reps`` after a warm-up (``utils.profiling.timed``);
A in f32 unless a case says bf16. Cases:
  build_s          seconds to build (or find built) csrc/resident_pg.cu and
                   csrc/resident_bt.cu
  solve_ms         the resident reference size: random_lasso(4000, 1000, 10)
                   padded to 4096x1024, AdaPGM, l1 (lam 1), tol 1e-4, one K2 launch
  *_it_us          K2 or a one-row K2c sweep, fixed rule, zero prox, tol 0,
                   1000 iterations, per iteration:
    ls_it_us         the reference size's A and b (K2's f32 4,4 instantiation)
    sync_floor_it_us 8x2176 (one CTA per SM, each warp a dot product of 8): the
                     grid syncs and the latency
    ls_bf16_it_us    the same, bf16 storage (bf16 8,8)
    ls_bf16_8_1_it_us  4092x1024, bf16 storage (bf16 8,1: rows of A^T
                     take scalar loads)
    logreg_it_us     the logistic objective at 8128x128 (mushrooms' padded
                     [X 1] shape; random A and labels)
    sweep_1_4_it_us  a one-row sweep at 4096x1022 (the sweep's f32 1,4)
    cubic_128_it_us, cubic_2048_it_us  the cubic objective (c = 1) on a random
                     PSD H, 128^2 and 2048^2, tol -1 (no early stop)
  menu_ms          K2c, the lasso menu's four rows at 4000x1000x10 padded to
                   4000x1024 (maxit 2000, tol 1e-7; the sweep's f32 4,4)
  bt_pg_it_us, bt_nesterov_it_us  K4 at the reference size, xi 1, gamma0
                   1/||A||_F^2 (one trial an iteration), zero prox, tol -1,
                   1000 iterations, per iteration
  bt_menu_ms       K4b, the lasso menu's four backtracking rows on the same
                   inputs as menu_ms

With ``--pd`` it times K6's PD iteration instead (csrc/resident_dsvm_grid.cu, the AdaPDM
core): a one-row K6b launch (one thread-block cluster), t 0.5, tol -1, 1000 iterations, per
iteration, on the dual_svm driver's inputs (``experiments.dual_svm.resident_inputs``, C 0.1):
  pd_384_it_us     heart_scale's dense Q, 384^2
  pd_1280_it_us    svmguide3's dense Q, 1280^2
  pd_8192x128_it_us  mushrooms' factored B, 8192x128
  pd_build_s       seconds to build (or find built) csrc/resident_dsvm_grid.cu

With ``--cv`` it times K7d's iteration (csrc/resident_cv.cu) and K7a's: one Condat-Vu
solve, tol -1, 1000 iterations, per iteration, on the square-root lasso driver's
padded inputs (``experiments.square_root_lasso.resident_inputs``, lam 10), with
h's inner norm l2 and l1, beside K6d's Condat-Vu iteration on the dual_svm
driver's inputs in the same call:
  cv_l2_512x128_it_us, cv_l1_512x128_it_us      housing_scale (506 x 14 -> 512 x 128)
  cv_l2_4224x128_it_us, cv_l1_4224x128_it_us    abalone (4177 x 9 -> 4224 x 128)
  cv_l2_8192x128_it_us, cv_l1_8192x128_it_us    cpusmall_scale (8192 x 13 -> 8192 x 128)
  k6d_384_it_us, k6d_1280_it_us, k6d_8192x128_it_us  K6d at heart_scale's dense Q,
                   svmguide3's dense Q and mushrooms' factored B (C 0.1)
  mp_l2_512x128_it_us, ..., adapdmp_l1_8192x128_it_us  K7a's two cores
                   (csrc/resident_f0_grid.cu) at the same shapes and h: a one-row sweep, t
                   1, tol -1, 1000 iterations, per iteration, and
  mp_l2_512x128_trials, ...  their mean trials an iteration
  cv_build_s       seconds to build (or find built) csrc/resident_cv.cu and
                   csrc/resident_f0_grid.cu

With ``--stream`` it times the stream probes K10a and K10c (csrc/hbm_stream.cu) as
chip_smoke.py's phase 18 runs them: |randn| / 128 at 16384^2 f32 (1 GiB), 200 passes
in one launch, best of ``--reps``:
  k10a_ms, k10c_ms          ms of the launch
  k10a_gbps, k10c_gbps      GB/s (200 x 1 GiB over that time)
  stream_build_s            seconds to build (or find built) csrc/hbm_stream.cu
To A/B a change to that source or its headers against a parent build, copy this script
into the parent's tree (the parent's may have no --stream) and run both in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..experiments.common import pad_tiles
from ..models.synthetic import random_lasso
from ..ops import resident, resident_bt
from ..utils.profiling import timed
from .common import BT_ROWS, bt_sweep_rows

MENU = (("fixed", False), ("fixed", True), ("mm", False), ("adapgm", False))
ITERS = 1000


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--pd", action="store_true", help="time K6's PD iteration only")
    mode.add_argument("--cv", action="store_true",
                      help="time K7d's Condat-Vu iteration and K7a's two cores', beside "
                           "K6d's, only")
    mode.add_argument("--stream", action="store_true",
                      help="time the stream probes K10a and K10c only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resident_timing: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    timing = (pd_timing if args.pd else cv_timing if args.cv else stream_timing if args.stream
              else k2_k4_timing)
    out = timing(dev, args.reps)
    print(smi)
    print(json.dumps(out))


def stream_timing(dev, reps, passes=200):
    """K10a's and K10c's launch at 16384^2 f32 (see the module docstring)."""
    from ..ops import kernels

    t0 = time.perf_counter()
    kernels.build_library(kernels.STREAM_SOURCE)
    out = {"stream_build_s": time.perf_counter() - t0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn(16384, 16384, generator=gen, device=dev).abs_() / 128
    moved = passes * a.numel() * a.element_size()
    for key, fn in (("k10a", lambda: kernels.hbm_read_reduce(a, 0.5, repeats=passes)),
                    ("k10c", lambda: kernels.hbm_dma_read(a, 0.5, repeats=passes))):
        seconds, _ = timed(fn, reps)
        out[f"{key}_ms"] = 1e3 * seconds
        out[f"{key}_gbps"] = moved / seconds / 1e9
    return out


def pd_timing(dev, reps):
    """K6's PD iteration at the dual_svm driver's three shapes (see the module
    docstring)."""
    from . import dual_svm
    from ..ops import resident_pd

    out = {}
    t0 = time.perf_counter()
    resident_pd.build_grid_library()
    out["pd_build_s"] = time.perf_counter() - t0
    for name, key in (("heart_scale", "pd_384_it_us"), ("svmguide3", "pd_1280_it_us"),
                      ("mushrooms", "pd_8192x128_it_us")):
        x, y, _ = dual_svm.load(name)
        q, lab, factored = dual_svm.resident_inputs(y[:, None] * x, y, torch.float32, dev)
        na = float(np.linalg.norm(y))
        secs, res = timed(lambda: resident_pd.resident_adapdm_dsvm_sweep(
            q, lab, 0.1, [0.5], na, -1.0, ITERS, n_true=len(y), factored=factored), reps=reps)
        if int(res[1][0]) != ITERS:
            raise RuntimeError(f"{name}: ran {int(res[1][0])} of {ITERS} iterations")
        out[key] = 1e6 * secs / ITERS
    return out


def cv_timing(dev, reps):
    """K7d's Condat-Vu iteration and K7a's two cores' at the square-root lasso driver's
    three shapes, and K6d's at the dual_svm driver's (see the module docstring)."""
    from . import dual_svm, square_root_lasso
    from ..convert import sqrt_lasso_from_numpy
    from ..ops import resident_f0, resident_pd

    def per_it(fn):
        secs, res = timed(fn, reps=reps)
        if int(res[1].reshape(-1)[0]) != ITERS:
            raise RuntimeError(f"ran {int(res[1].reshape(-1)[0])} of {ITERS} iterations")
        return 1e6 * secs / ITERS, res

    out = {}
    t0 = time.perf_counter()
    resident_f0.build_library()
    resident_f0.build_grid_library()
    out["cv_build_s"] = time.perf_counter() - t0
    sweeps = {"mp": resident_f0.resident_mpls_sweep, "adapdmp": resident_f0.resident_adapdmp_sweep}
    for name in ("housing_scale", "abalone", "cpusmall_scale"):
        x, y, _ = square_root_lasso.load(name)
        _, _, h, a_op, na = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=dev,
                                                  dtype=torch.float32)
        a, bv = square_root_lasso.resident_inputs(a_op.a, -h.b)
        gamma, sigma = square_root_lasso.cv_steps(na)
        shape = f"{a.shape[0]}x{a.shape[1]}"
        for h_kind in resident_f0.H_KINDS:
            out[f"cv_{h_kind}_{shape}_it_us"] = per_it(
                lambda: resident_f0.resident_condat_vu(a, bv, 10.0, gamma, sigma, -1.0, ITERS,
                                                       h_kind=h_kind))[0]
            for core, sweep in sweeps.items():
                p2 = 1.0 if core == "mp" else na
                us, res = per_it(lambda: sweep(a, bv, 10.0, [1.0], p2, -1.0, ITERS, record=True,
                                               h_kind=h_kind))
                out[f"{core}_{h_kind}_{shape}_it_us"] = us
                out[f"{core}_{h_kind}_{shape}_trials"] = float(res[5][3].mean())
    for name, key in (("heart_scale", "k6d_384_it_us"), ("svmguide3", "k6d_1280_it_us"),
                      ("mushrooms", "k6d_8192x128_it_us")):
        x, y, _ = dual_svm.load(name)
        dyx = y[:, None] * x
        q, lab, factored = dual_svm.resident_inputs(dyx, y, torch.float32, dev)
        gamma, sigma = dual_svm.cv_steps(float(np.linalg.norm(dyx.T @ dyx)),
                                         float(np.linalg.norm(y)))
        out[key] = per_it(lambda: resident_pd.resident_cv_dsvm(
            q, lab, 0.1, gamma, sigma, -1.0, ITERS, n_true=len(y), factored=factored))[0]
    return out


def k2_k4_timing(dev, reps):
    """K2, K2c, K4 and K4b at the cases of the module docstring."""
    out = {}
    t0 = time.perf_counter()
    resident.build_library()
    resident_bt.build_library()
    out["build_s"] = time.perf_counter() - t0

    def it_us(fn):
        """Per-iteration microseconds of ``fn``, a run of ITERS iterations."""
        secs, res = timed(fn, reps=reps)
        if int(res[1].reshape(-1)[0]) != ITERS:
            raise RuntimeError(f"ran {int(res[1].reshape(-1)[0])} of {ITERS} iterations")
        return 1e6 * secs / ITERS

    def k2_it_us(a_, b_, gam_, **kw):
        z = torch.zeros(a_.shape[1], device=dev)
        return it_us(lambda: resident.resident_adapgm(a_, b_, z, gam_, 0.0, ITERS,
                                                      prox_kind="zero", rule_kind="fixed", **kw))

    def random_problem(m, n, dtype=torch.float32):
        a_ = torch.randn(m, n, generator=gen, device=dev) / n
        # 1/||A||_F^2 <= 1/||A||^2: a stable fixed step
        b_ = torch.randn(m, generator=gen, device=dev)
        return a_.to(dtype), b_, 1.0 / float((a_ * a_).sum())

    prob = random_lasso(m=4000, n=1000, pfactor=10, seed=0)
    a_np, b_np = prob.a.astype(np.float32), prob.b.astype(np.float32)
    a = torch.zeros(4096, 1024, device=dev)
    a[:4000, :1000] = torch.as_tensor(a_np, device=dev)
    b = torch.zeros(4096, device=dev)
    b[:4000] = torch.as_tensor(b_np, device=dev)
    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0 = torch.zeros(1024, device=dev)
    secs, res = timed(lambda: resident.resident_adapgm_l1(a, b, x0, gam, 1.0, 1e-4, 4000),
                      reps=reps)
    out["solve_ms"], out["solve_numit"] = 1e3 * secs, int(res[1])
    out["ls_it_us"] = k2_it_us(a, b, gam)
    a8 = torch.randn(8, 2176, generator=torch.Generator(device=dev).manual_seed(8),
                     device=dev) / 2176
    out["sync_floor_it_us"] = k2_it_us(a8, torch.ones(8, device=dev), 1.0 / float((a8 * a8).sum()))
    out["ls_bf16_it_us"] = k2_it_us(a.to(torch.bfloat16), b, gam)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out["ls_bf16_8_1_it_us"] = k2_it_us(*random_problem(4092, 1024, torch.bfloat16))
    a_l, _, gam_l = random_problem(8128, 128)
    y_l = (torch.rand(8128, generator=gen, device=dev) < 0.5).float()
    # the logistic loss's gradient is (1/4m)-Lipschitz in ||A||^2
    out["logreg_it_us"] = k2_it_us(a_l, y_l, 4 * 8128 * gam_l, obj_kind="logreg")
    for n in (128, 2048):
        g_c = torch.randn(n, n, generator=gen, device=dev) / n
        h_c = g_c.t() @ g_c
        q_c = torch.randn(n, generator=gen, device=dev) / n
        gam_c = 1.0 / (float(torch.linalg.matrix_norm(h_c.double(), 2)) + 1.0)
        out[f"cubic_{n}_it_us"] = it_us(lambda: resident.resident_adapgm(
            h_c, q_c, torch.zeros(n, device=dev), gam_c, -1.0, ITERS, prox_kind="zero",
            rule_kind="fixed", obj_kind="cubic", cube_c=1.0))
    a_s, b_s, gam_s = random_problem(4096, 1022)
    rows = resident.rule_rows([(gam_s, "fixed", False)], tol=0.0, maxit=ITERS)
    out["sweep_1_4_it_us"] = it_us(lambda: resident.resident_rule_sweep(
        a_s, b_s, torch.zeros(1022, device=dev), rows, 0.0, ITERS, prox_kind="zero"))

    a_d, b_d = pad_tiles(torch.as_tensor(a_np, device=dev), torch.as_tensor(b_np, device=dev))
    rows_d = resident.rule_rows([(gam, rule, mom) for rule, mom in MENU], tol=1e-7, maxit=2000)
    secs, res = timed(lambda: resident.resident_rule_sweep(
        a_d, b_d, torch.zeros(a_d.shape[1], device=dev), rows_d, 1e-7, 2000, p1=prob.lam),
        reps=reps)
    out["menu_ms"], out["menu_numit"] = 1e3 * secs, res[1].tolist()

    gam_f = 1.0 / float((a * a).sum())  # <= 1/||A||^2: every first trial passes
    for label, nesterov in (("bt_pg_it_us", False), ("bt_nesterov_it_us", True)):
        out[label] = it_us(lambda: resident_bt.resident_backtracking(
            a, b, x0, gam_f, -1.0, ITERS, prox_kind="zero", nesterov=nesterov))
    secs, res = timed(lambda: resident_bt.resident_bt_sweep(
        a_d, b_d, torch.zeros(a_d.shape[1], device=dev), bt_sweep_rows(BT_ROWS, gam), 1e-7, 2000,
        p1=prob.lam), reps=reps)
    out["bt_menu_ms"], out["bt_menu_numit"] = 1e3 * secs, res[1].tolist()
    return out


if __name__ == "__main__":
    main()
