"""Lasso experiment (counterpart of ``adaprox_tpu/experiments/lasso.py``;
reference experiments/lasso/runme.jl).

Synthetic problem with a known optimum by construction (runme.jl:45-77);
sizes (m, n, pfactor), maxit 2000, tol 1e-7 (runme.jl:191-211). Plot:
F(x_k) - F* vs (grad_f_evals + f_evals).

The menu holds the engine rows ported so far: fixed PG, AdaPGM (MM) and
AdaPGM (Ours). ``--fused`` routes every oracle call through K1
(``ops.kernels.fused_ls_value_grad``) on an A zero-padded as the JAX driver
pads it, so the two drivers' JSONL compare row for row.

    python -m adaprox_tpu_torch.experiments.lasso --fused --sizes 4000x1000x10
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.objectives import LeastSquares
from ..models.synthetic import random_lasso
from ..ops.prox import L1Norm
from ..solvers.primal_dual import adaptive_proxgrad, fixed_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from .common import Sink, group_rows, pad_tiles, plot_lines, run_menu

# rows of the JAX driver's menu whose solvers are not ported yet
NOT_PORTED = ("PGM (backtracking)-(xi=1.0)", "PGM (backtracking)-(xi=1.5)",
              "PGM (backtracking)-(xi=2.0)", "Nesterov (backtracking)",
              "Nesterov (fixed)", "aGRAAL")


def run_random_lasso(m, n, pfactor, sink, *, device, tol=1e-7, maxit=2000, dtype=None,
                     fused=False):
    """Run the menu on ``random_lasso(m, n, pfactor)`` on ``device``.
    ``dtype`` defaults to float64 on the CPU (the reference's regime) and
    float32 on CUDA. Returns the analytic optimum."""
    device = torch.device(device)
    prob = random_lasso(m=m, n=n, pfactor=pfactor, seed=0, lam=1.0)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    a = torch.as_tensor(prob.a, device=device).to(dtype)
    b = torch.as_tensor(prob.b, device=device).to(dtype)
    if fused:
        a, b = pad_tiles(a, b)  # exact; keeps the JSONL comparable with JAX's
    f = LeastSquares(a, b, fused=fused)
    g = L1Norm(torch.as_tensor(prob.lam, dtype=dtype, device=device))

    # pseudo-record with the analytic optimum (runme.jl:79)
    sink.emit_pseudo({"method": None, "it": 1, "objective": prob.optimum})

    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0 = torch.zeros(a.shape[1], dtype=dtype, device=device)
    times = {}
    print(f"  [lasso] skipping rows not ported yet: {', '.join(NOT_PORTED)}")
    base = dict(f=f, g=g, tol=tol)
    menu = [
        ("PGM (fixed)", maxit, lambda **o: fixed_proxgrad(
            x0, gamma=gam, name="PGM (fixed)", **base, **o)),
        ("AdaPGM (MM)", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=MalitskyMishchenkoRule(gamma=gam), name="AdaPGM (MM)",
            **base, **o)),
        ("AdaPGM (Ours)", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=AdaPGMRule(gamma=gam), name="AdaPGM (Ours)", **base, **o)),
    ]
    menu_path = run_menu(sink, times, menu)
    sink.emit_meta(wall_s=times, fast_path="fused" if fused else menu_path,
                   fast_methods=sorted(times) if fused else [])
    return prob.optimum


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    series = [
        (name, [r["grad_f_evals"] + r["f_evals"] for r in rs],
         [r["objective"] - optimum for r in rs])
        for name, rs in group_rows(rows).items()
    ]
    return plot_lines(path, series, f"Lasso ({os.path.basename(path)})",
                      "calls to A, A'", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/lasso")
    p.add_argument("--maxit", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--sizes", default="100x300x10,500x1000x10,4000x1000x10")
    p.add_argument("--fused", action="store_true",
                   help="fused LS oracle (kernel K1) for every solver")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs float32; cpu runs float64, the reference's regime")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")

    for spec in args.sizes.split(","):
        m, n, pf = (int(v) for v in spec.split("x"))
        path = os.path.join(args.outdir, f"lasso_{m}_{n}_{pf}.jsonl")
        sink = Sink(path)
        opt = run_random_lasso(m, n, pf, sink, device=args.device, tol=args.tol,
                               maxit=args.maxit, fused=args.fused)
        print(f"{path}: optimum={opt:.8f}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
