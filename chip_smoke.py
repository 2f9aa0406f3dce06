"""Smoke run of the PyTorch port (adaprox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. device:   a CUDA device is required; prints nvidia-smi's name and power limit
  2. build:    K1 (csrc/fused_ls.cu) with nvcc from this checkout's sources
  3. kernels:  K1 against its plain PyTorch version on the card, at the
               headline shape (16384^2, f32 and bf16 storage), the lasso
               driver's padded shape (4000x1024) and an unaligned 1000x300
  4. driver:   the lasso driver at the reference size 4000x1000x10 with
               --fused (the main path), counting K1 launches
  5. headline: AdaPGM, 200 iterations on 16384^2 f32, fused and two-matmul
Then one JSON line describing the kernels, and last the JSON result line.
Imports no JAX: the GPU machine has none.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

# K1 vs plain: both accumulate in f32 in different orders; rounding grows like
# sqrt(n) * 6e-8 ~ 1e-5 * max at n = 16384 at worst, and 1-2e-6 was measured
# on an H100. A wrong index or a lost row gives errors of order 1.
KERNEL_RTOL = 1e-5
# |F(x) - F*| after 2000 iterations at 4000x1000x10, f32. Calibrated with the
# port's plain path in f32 on the CPU: PGM (fixed) 1.58e-5 (the fixed step is
# far from converged; it contracts rounding, so the card must land close);
# AdaPGM (MM) 4.2e-7 and (Ours) 6.0e-8 (the f32 noise floor of F* = 5.54 is
# ~3e-7). Bounds: 2x the fixed gap, 25x the adaptive ones.
GAP_BOUND = {"PGM (fixed)": 3.2e-5, "AdaPGM (MM)": 1e-5, "AdaPGM (Ours)": 1e-5}
HEADLINE = 16384
HEADLINE_ITERS = 200


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
    from adaprox_tpu_torch.ops import kernels
    from adaprox_tpu_torch.utils.logging import read_jsonl
    from adaprox_tpu_torch.utils.profiling import timed

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build_library()
    build_s = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
            if "registers" in ln]
    print(f"[build] K1 {lib_path.name} in {build_s:.2f} s (ptxas: {'; '.join(regs)})", flush=True)

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

    # 4. the driver (main path) ----------------------------------------------
    outdir = os.path.join("results", "chip_smoke")
    kernels.fused_ls_value_grad.launches = 0
    lasso.main(["--fused", "--sizes", "4000x1000x10", "--maxit", "2000", "--tol", "1e-7",
                "--device", "cuda", "--outdir", outdir, "--no-plot"])
    torch.cuda.synchronize()
    launches = kernels.fused_ls_value_grad.launches
    rows = read_jsonl(os.path.join(outdir, "lasso_4000_1000_10.jsonl"))
    optimum = rows[0]["objective"]
    last = {r["method"]: r for r in rows if r.get("method")}
    check(sorted(last) == sorted(GAP_BOUND), f"driver rows {sorted(last)}")
    oracle_calls = sum(r["f_evals"] for r in last.values())
    parts = []
    for name, r in last.items():
        gap = r["objective"] - optimum
        parts.append(f"{name}: numit {r['it']}, F-F* {gap:.3e} (bound {GAP_BOUND[name]:g})")
        check(math.isfinite(gap) and abs(gap) <= GAP_BOUND[name], f"{name}: F-F* {gap}")
    print(f"[driver] lasso 4000x1000x10 --fused f32: {'; '.join(parts)} | K1 launches "
          f"{launches}, oracle calls {oracle_calls}", flush=True)
    check(launches > 0 and launches == oracle_calls, "K1 launches != oracle calls")

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

    head = measured["16384x16384 f32"]
    print(json.dumps({"kernels": [{
        "name": "fused_ls_value_grad", "route": "cuda",
        "source": "adaprox_tpu_torch/csrc/fused_ls.cu",
        "replaces": "adaprox_tpu/ops/kernels.py:99",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
