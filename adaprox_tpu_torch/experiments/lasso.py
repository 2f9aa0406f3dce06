"""Lasso experiment (counterpart of ``adaprox_tpu/experiments/lasso.py``;
reference experiments/lasso/runme.jl).

Synthetic problem with a known optimum by construction (runme.jl:45-77);
sizes (m, n, pfactor), maxit 2000, tol 1e-7 (runme.jl:191-211). Plot:
F(x_k) - F* vs (grad_f_evals + f_evals).

The menu, in the reference order: PGM (fixed), PGM (backtracking) with xi
1, 1.5 and 2, Nesterov (backtracking), Nesterov (fixed), AdaPGM (MM), AdaPGM
(Ours) and aGRAAL (its companion point x0 + N(0, I) on the first n
coordinates, drawn as the JAX driver draws it: ``utils.jax_random``).
``--fused`` routes every oracle call through K1
(``ops.kernels.fused_ls_value_grad``) on an A zero-padded as the JAX driver
pads it, so the two drivers' JSONL compare row for row. ``--resident`` runs
the four backtracking rows as ONE record-mode launch of the backtracking
sweep K4b (``ops.resident_bt.resident_bt_sweep``), the four rule rows as ONE
launch of the rule sweep K2c (``ops.resident.resident_rule_sweep``) and
aGRAAL as ONE launch of K4's aGRAAL kernel (``ops.resident_bt.resident_agraal``)
on the same padded A, as the JAX driver does, and emits the two sweeps' walls
in a ``grid_total_s`` meta row. On the card every shape goes to the kernels. On
the CPU the JAX driver's routing rule (``resident_supported``) applies, with
its printed fallback to the engine, so the two drivers' JSONL compare row for
row there too.

    python -m adaprox_tpu_torch.experiments.lasso --fused --sizes 4000x1000x10
    python -m adaprox_tpu_torch.experiments.lasso --resident --sizes 4000x1000x10
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..models.objectives import LeastSquares
from ..models.synthetic import random_lasso
from ..ops.prox import L1Norm
from ..ops.resident import resident_records, resident_rule_sweep, resident_supported, rule_rows
from ..ops.resident_bt import resident_agraal, resident_bt_sweep
from ..solvers.agraal import agraal
from ..solvers.nesterov import fixed_nesterov
from ..solvers.primal_dual import adaptive_proxgrad, fixed_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from .common import (BT_ROWS, Sink, add_agraal_row, add_bt_rows, bt_menu, bt_sweep_rows,
                     companion_point, group_rows, pad_tiles, plot_lines, run_menu, sync_wall)


# the rule sweep's rows as (name, rule_kind, momentum), in the reference order
RESIDENT_ROWS = (("PGM (fixed)", "fixed", False), ("Nesterov (fixed)", "fixed", True),
                 ("AdaPGM (MM)", "mm", False), ("AdaPGM (Ours)", "adapgm", False))


def run_random_lasso(m, n, pfactor, sink, *, device, tol=1e-7, maxit=2000, dtype=None,
                     fused=False, resident=False):
    """Run the menu on ``random_lasso(m, n, pfactor)`` on ``device``.
    ``dtype`` defaults to float64 on the CPU (the reference's regime) and
    float32 on CUDA. Returns the analytic optimum."""
    device = torch.device(device)
    prob = random_lasso(m=m, n=n, pfactor=pfactor, seed=0, lam=1.0)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    a = torch.as_tensor(prob.a, device=device).to(dtype)
    b = torch.as_tensor(prob.b, device=device).to(dtype)
    if fused or resident:
        a, b = pad_tiles(a, b)  # exact; keeps the JSONL comparable with JAX's
    # K2c takes every shape on the card; the CPU follows the JAX driver's routing
    use_resident = resident and (device.type == "cuda" or resident_supported(a))
    if resident and not use_resident:
        print(f"  [resident] unsupported shape/size {tuple(a.shape)} "
              f"({a.dtype}); falling back to the engine")
    f = LeastSquares(a, b, fused=fused)
    g = L1Norm(torch.as_tensor(prob.lam, dtype=dtype, device=device))

    # pseudo-record with the analytic optimum (runme.jl:79)
    sink.emit_pseudo({"method": None, "it": 1, "objective": prob.optimum})

    gam = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    x0 = torch.zeros(a.shape[1], dtype=dtype, device=device)
    # aGRAAL's companion point: noise on the first n coordinates only, so that
    # zero-padded coordinates stay 0 and the padded run draws what the unpadded
    # one does
    x0_ag = companion_point(x0, n)
    times = {}
    if use_resident:
        # ONE record-mode K4b launch for the four backtracking rows, ONE K2c
        # launch for the four rule rows and ONE aGRAAL launch; wall_s carries each
        # row's share of its sweep's wall (aGRAAL its own), grid_total_s the
        # sweeps' walls
        bt_out, bt_wall = sync_wall(lambda: resident_bt_sweep(
            a, b, x0, bt_sweep_rows(BT_ROWS, gam), tol, maxit, prox_kind="l1", p1=prob.lam))
        specs = [(gam, rule_kind, mom) for _, rule_kind, mom in RESIDENT_ROWS]
        (_, numit, _, _, hists), wall = sync_wall(lambda: resident_rule_sweep(
            a, b, x0, rule_rows(specs, tol=tol, maxit=maxit), tol, maxit, prox_kind="l1",
            p1=prob.lam))
        ag_out, ag_wall = sync_wall(lambda: resident_agraal(
            a, b, x0, x0_ag, gam, tol, maxit, prox_kind="l1", p1=prob.lam, record=True))

        def add_rule_row(j):
            name, _, mom = RESIDENT_ROWS[j]
            sink.add(SimpleNamespace(records=resident_records(
                numit[j], *(h[j] for h in hists), maxit=maxit, momentum=mom), name=name))

        # the rows in the reference order
        add_rule_row(0)
        add_bt_rows(sink, BT_ROWS, bt_out, maxit)
        for j in range(1, len(RESIDENT_ROWS)):
            add_rule_row(j)
        add_agraal_row(sink, ag_out, maxit)
        for name, _, _ in BT_ROWS:
            times[name] = round(bt_wall / len(BT_ROWS), 4)
        for name, _, _ in RESIDENT_ROWS:
            times[name] = round(wall / len(RESIDENT_ROWS), 4)
        times["aGRAAL"] = round(ag_wall, 4)
        sink.emit_meta(grid_total_s={"bt sweep": round(bt_wall, 4), "rule sweep": round(wall, 4)})
        fast_path = "resident"
    else:
        base = dict(f=f, g=g, tol=tol)
        menu = [
            ("PGM (fixed)", maxit, lambda **o: fixed_proxgrad(
                x0, gamma=gam, name="PGM (fixed)", **base, **o)),
        ] + bt_menu(BT_ROWS, x0, gam, maxit, base) + [
            ("Nesterov (fixed)", maxit, lambda **o: fixed_nesterov(
                x0, gamma=gam, name="Nesterov (fixed)", **base, **o)),
            ("AdaPGM (MM)", maxit, lambda **o: adaptive_proxgrad(
                x0, rule=MalitskyMishchenkoRule(gamma=gam), name="AdaPGM (MM)",
                **base, **o)),
            ("AdaPGM (Ours)", maxit, lambda **o: adaptive_proxgrad(
                x0, rule=AdaPGMRule(gamma=gam), name="AdaPGM (Ours)", **base, **o)),
            ("aGRAAL", maxit, lambda **o: agraal(
                x0, x0=x0_ag, gamma0=gam, name="aGRAAL", **base, **o)),
        ]
        menu_path = run_menu(sink, times, menu)
        fast_path = "fused" if fused else menu_path
    sink.emit_meta(wall_s=times, fast_path=fast_path,
                   fast_methods=sorted(times) if fast_path != "default" else [])
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
    p.add_argument("--resident", action="store_true",
                   help="the whole-solve kernels: the backtracking rows in one K4b launch, "
                        "the rule rows in one K2c launch, aGRAAL in one launch")
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
                               maxit=args.maxit, fused=args.fused, resident=args.resident)
        print(f"{path}: optimum={opt:.8f}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
