"""Smoke run of the PyTorch port (adaprox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. device:   a CUDA device is required; prints nvidia-smi's name and power limit
  2. build:    K1 (csrc/fused_ls.cu) and K2/K2c (csrc/resident_pg.cu), one
               nvcc each, started together, from this checkout's sources
  3. kernels:  K1 against its plain PyTorch version on the card, at the
               headline shape (16384^2, f32 and bf16 storage), the lasso
               driver's padded shape (4000x1024) and an unaligned 1000x300;
               K2 against its plain version at the padded reference size
               4096x1024 (cases a-d, f), at 1000x300 and at 64x128 (case e);
               K2c at 4096x1024 against its plain version (cases g, h) and,
               bit for bit, against single K2 launches (cases i, j)
  4. driver:   the lasso driver at the reference size 4000x1000x10, with
               --fused (the main path through K1) and with --resident (the
               four rows in one K2c launch), counting each kernel's launches
  5. headline: AdaPGM, 200 iterations on 16384^2 f32, fused and two-matmul
  6. resident: the resident reference size (4096x1024 f32, lam 1, tol 1e-4,
               maxit 4000): one K2 solve (the single-solve path,
               resident_adapgm_l1, counted) beside the engine's AdaPGM
               --fused; K2's cost an iteration there, at 8x2176 and past the
               L2; the momentum iteration with and without records; the
               driver's four-row sweep beside four single K2 launches, and
               held against its plain version on the same inputs
Then one JSON line describing the kernels, and last the JSON result line.
Imports no JAX: the GPU machine has none.
"""

import json
import math
import os
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
GAP_BOUND = {"PGM (fixed)": 3.2e-5, "Nesterov (fixed)": 1e-5, "AdaPGM (MM)": 1e-5,
             "AdaPGM (Ours)": 1e-5}
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
        out = resident.resident_rule_sweep(a_, b, x0, resident.rule_rows(specs), 0.0, 4000,
                                           p1=1.0)
        same = True
        for j, (g0, rule, mom, tol, cap) in enumerate(specs):
            one = resident.resident_adapgm(a_, b, x0, g0, tol, cap, p1=1.0, rule_kind=rule,
                                           momentum=mom, record=True)
            row = sweep_row(out, j)
            same &= all(torch.equal(u, w) for u, w in zip(row[:4], one[:4]))
            same &= all(torch.equal(u[:cap], w) for u, w in zip(row[4:], one[4:]))
            same &= not any(bool(u[cap:].any()) for u in row[4:])
        torch.cuda.synchronize()
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


def main():
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
    from adaprox_tpu_torch.ops import kernels, resident
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [(name, pool.submit(build)) for name, build in
                  (("K1", kernels.build_library), ("K2/K2c", resident.build_library))]
        for name, fut in builds:
            lib_path = fut.result()
            regs = [ln.split(":", 1)[1].strip()
                    for ln in lib_path.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln]
            print(f"[build] {name} {lib_path.name} (ptxas: {'; '.join(regs)})", flush=True)
    print(f"[build] both in {time.perf_counter() - t0:.2f} s", flush=True)

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
    for name, a, b, x in cases:
        f_k, g_k = kernels.fused_ls_value_grad(a, b, x)
        f_p, g_p = kernels.ls_value_grad_plain(a, b, x)  # bf16: the same values upcast
        torch.cuda.synchronize()
        err_f = abs(float(f_k - f_p)) / abs(float(f_p))
        abs_g = float((g_k - g_p).abs().max())
        err_g = abs_g / float(g_p.abs().max())
        check(math.isfinite(err_f) and math.isfinite(err_g), f"K1 {name}: non-finite result")
        a_plain = a.float()  # time the plain version on f32 storage, as LeastSquares runs it
        ms_k = event_ms(lambda: kernels.fused_ls_value_grad(a, b, x))
        ms_p = event_ms(lambda: kernels.ls_value_grad_plain(a_plain, b, x))
        measured[name] = dict(max_abs_err=abs_g, ms=ms_k, plain_ms=ms_p)
        print(f"[kernels] K1 {name}: rel err f {err_f:.2e}, grad {err_g:.2e} "
              f"(max abs {abs_g:.2e}; tol {KERNEL_RTOL:g}) | K1 {ms_k:.4f} ms, "
              f"plain {ms_p:.4f} ms ({smi})", flush=True)
        check(err_f <= KERNEL_RTOL and err_g <= KERNEL_RTOL, f"K1 {name} disagrees with plain")
        del a_plain
    ref, k2_meas = k2_checks(resident, dev, smi)
    k2c_checks(resident, ref, smi)

    # 4. the driver (main path) ----------------------------------------------
    def zero_counts():
        kernels.fused_ls_value_grad.launches = resident.resident_adapgm.launches = 0
        resident.resident_rule_sweep.launches = 0

    def read_counts():
        return (kernels.fused_ls_value_grad.launches, resident.resident_adapgm.launches,
                resident.resident_rule_sweep.launches)

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
        # the oracle calls the rows count, and the Nesterov row's logging-only
        # f.value(x) of each recorded iteration, which counts no oracle call
        oracle_calls = sum(r["f_evals"] for r in last.values())
        logging_calls = last["Nesterov (fixed)"]["it"]
        parts = []
        for name, r in last.items():
            gap = r["objective"] - optimum
            parts.append(f"{name}: numit {r['it']}, F-F* {gap:.3e} (bound {GAP_BOUND[name]:g})")
            check(math.isfinite(gap) and abs(gap) <= GAP_BOUND[name], f"{name}: F-F* {gap}")
        grid = rows[-2].get("grid_total_s")
        print(f"[driver] lasso 4000x1000x10 --{path} f32: {'; '.join(parts)} | K1 launches "
              f"{counts[path][0]}, K2 launches {counts[path][1]}, K2c launches "
              f"{counts[path][2]}, oracle calls {oracle_calls}, logging-only f calls "
              f"{logging_calls} | wall_s {walls[path]}, grid_total_s {grid} ({smi})", flush=True)
        if path == "fused":
            check(counts[path][0] == oracle_calls + logging_calls > 0
                  and counts[path][1:] == (0, 0),
                  "--fused: K1 launches != oracle calls + logging-only f calls")
        else:
            check(counts[path] == (0, 0, 1) and grid is not None,
                  "--resident: not exactly one K2c launch (and no K1 or K2 launch)")

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
    check(counts["single"] == (0, 1, 0), f"single solve: launches {counts['single']}")
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

    head = measured["16384x16384 f32"]
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
        "bound_by": k1_bound[1], "library_ms": None}, {
        "name": "resident_adapgm", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_pg.cu",
        "replaces": "adaprox_tpu/ops/resident.py:442",
        "launches": counts["single"][1], "max_abs_err": k2_meas["max_abs_err"],
        "ms": k2_ms, "plain_ms": 1e3 * plain_s, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None}, {
        "name": "resident_rule_sweep", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/resident_pg.cu",
        "replaces": "adaprox_tpu/ops/resident.py:616",
        "launches": counts["resident"][2], "max_abs_err": k2c_err,
        "ms": 1e3 * sweep_s, "plain_ms": 1e3 * sweep_plain_s, "bound_ms": k2c_bound[0],
        "bound_by": k2c_bound[1], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
