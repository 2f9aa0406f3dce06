"""Nesterov worst-case quadratic experiment (counterpart of
``adaprox_tpu/experiments/nesterov_worst_case.py``; reference
experiments/nesterov_worst_case/runme.jl).

WorstQuadratic(k, L) with the known optimum (L/8)(1/(k+1) - 1) (runme.jl:53),
logged first as a pseudo row with ``method`` null; k = n = 100, L = 100, tol
1e-6, maxit 10_000. A sanity check that the adaptive methods degrade
gracefully against the accelerated one. Plot: F - F* vs grad_f_evals.

The menu holds every row of the reference, in its order: Fixed stepsize
PGM, Backtracking PG, Fixed Nesterov, Backtracking Nesterov, AdaPGM (MM) and
AdaPGM (the backtracking rows from gamma0 = 1). ``--resident`` runs the two
backtracking rows as ONE record-mode launch of the backtracking sweep K4b
(``ops.resident_bt.resident_bt_sweep``) and the four rule rows as ONE launch
of the rule-sweep kernel K2c (``ops.resident.resident_rule_sweep``) on the
worst case written as the cubic model with c = 0: the dense H = (L/4)
tridiag(-1, 2, -1) on the first k coordinates and q = -(L/4) e_1,
zero-padded to a multiple of 128 (the padded coordinates stay exactly 0); the
sweeps' walls go into a ``grid_total_s`` meta row.

    python -m adaprox_tpu_torch.experiments.nesterov_worst_case
    python -m adaprox_tpu_torch.experiments.nesterov_worst_case --resident
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import torch

from ..convert import worst_from_numpy
from ..ops.prox import Zero
from ..ops.resident import resident_records, resident_rule_sweep, rule_rows
from ..ops.resident_bt import resident_bt_sweep
from ..solvers.nesterov import fixed_nesterov
from ..solvers.primal_dual import adaptive_proxgrad, fixed_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from .common import (Sink, add_bt_rows, bt_menu, bt_sweep_rows, group_rows, plot_lines, run_menu,
                     sync_wall)

# the backtracking rows, (name, xi, nesterov), from gamma0 = 1 (runme.jl)
BT_ROWS = (("Backtracking PG", 1.0, False), ("Backtracking Nesterov", 1.0, True))

# the rule sweep's rows, in the JAX driver's order: (name, rule_kind, momentum)
RESIDENT_ROWS = (("Fixed stepsize PGM", "fixed", False), ("Fixed Nesterov", "fixed", True),
                 ("AdaPGM (MM)", "mm", False), ("AdaPGM", "adapgm", False))


def worst_case_model(k, n, lip, device, dtype, mult=128):
    """The worst case as the cubic model's (H, q) with c = 0, zero-padded to
    a multiple of ``mult`` (the JAX driver's TPU tiles): H = (L/4) T with T
    the tridiag(-1, 2, -1) stencil on the first k coordinates, q = -(L/4) e_1."""
    n_pad = -(-n // mult) * mult
    t = torch.zeros((n_pad, n_pad), dtype=torch.float64)
    idx = torch.arange(k)
    t[idx, idx] = 2.0
    t[idx[:-1], idx[:-1] + 1] = t[idx[:-1] + 1, idx[:-1]] = -1.0
    h = (lip / 4 * t).to(device=device, dtype=dtype)
    q = torch.zeros(n_pad, dtype=dtype, device=device)
    q[0] = -lip / 4
    return h, q


def run_nesterov_worst_case(sink, *, device, k=100, n=100, lip=100.0, tol=1e-6, maxit=10_000,
                            dtype=None, resident=False):
    """Run the menu on ``device``; ``dtype`` defaults to float64 on the CPU
    (the reference's regime) and float32 on CUDA. Returns the known optimum."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    f = worst_from_numpy(k, lip, n, device=device, dtype=dtype)
    g = Zero()
    optimum = (lip / 8) * (1 / (k + 1) - 1)
    sink.emit_pseudo({"method": None, "it": 1, "objective": optimum})
    x0 = torch.zeros(n, dtype=dtype, device=device)
    times = {}

    if resident:
        # ONE record-mode K4b launch for the two backtracking rows and ONE K2c
        # launch for the four rule rows; wall_s carries each row's share of its
        # sweep's wall, grid_total_s the sweeps' walls
        h, q = worst_case_model(k, n, lip, device, dtype)
        x0_pad = torch.zeros(h.shape[0], dtype=dtype, device=device)
        skw = dict(prox_kind="zero", obj_kind="cubic", cube_c=0.0)
        bt_out, bt_wall = sync_wall(lambda: resident_bt_sweep(
            h, q, x0_pad, bt_sweep_rows(BT_ROWS, 1.0), tol, maxit, **skw))
        specs = [(1 / lip, rule, mom) for _, rule, mom in RESIDENT_ROWS]
        (_, numit, _, _, hists), wall = sync_wall(lambda: resident_rule_sweep(
            h, q, x0_pad, rule_rows(specs, tol=tol, maxit=maxit), tol, maxit, **skw))

        def add_rule_row(j):
            name, _, mom = RESIDENT_ROWS[j]
            sink.add(SimpleNamespace(records=resident_records(
                numit[j], *(h_[j] for h_ in hists), maxit=maxit, momentum=mom), name=name))

        # the rows in the reference order: each backtracking row after its fixed one
        for j in range(len(RESIDENT_ROWS)):
            add_rule_row(j)
            if j < len(BT_ROWS):
                add_bt_rows(sink, BT_ROWS, bt_out, maxit, only=[BT_ROWS[j][0]])
        for name, _, _ in BT_ROWS:
            times[name] = round(bt_wall / len(BT_ROWS), 4)
        for name, _, _ in RESIDENT_ROWS:
            times[name] = round(wall / len(RESIDENT_ROWS), 4)
        sink.emit_meta(grid_total_s={"bt sweep": round(bt_wall, 4), "rule sweep": round(wall, 4)})
        sink.emit_meta(wall_s=times, fast_path="resident", fast_methods=sorted(times))
        return optimum

    base = dict(f=f, g=g, tol=tol)
    bt_pg, bt_nesterov = bt_menu(BT_ROWS, x0, 1.0, maxit, base)
    menu = [
        ("Fixed stepsize PGM", maxit, lambda **o: fixed_proxgrad(
            x0, gamma=1 / lip, name="Fixed stepsize PGM", **base, **o)),
        bt_pg,
        ("Fixed Nesterov", maxit, lambda **o: fixed_nesterov(
            x0, gamma=1 / lip, name="Fixed Nesterov", **base, **o)),
        bt_nesterov,
        ("AdaPGM (MM)", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=MalitskyMishchenkoRule(gamma=1 / lip), name="AdaPGM (MM)", **base, **o)),
        ("AdaPGM", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=AdaPGMRule(gamma=1 / lip), name="AdaPGM", **base, **o)),
    ]
    menu_path = run_menu(sink, times, menu)
    sink.emit_meta(wall_s=times, fast_path=menu_path, fast_methods=[])
    return optimum


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    series = [
        (name, [r["grad_f_evals"] for r in rs], [r["objective"] - optimum for r in rs])
        for name, rs in group_rows(rows).items()
    ]
    return plot_lines(path, series, "Nesterov's worst case", "grad f evaluations",
                      "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/nesterov_worst_case")
    p.add_argument("--maxit", type=int, default=10_000)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--L", type=float, default=100.0)
    p.add_argument("--resident", action="store_true",
                   help="the sweep kernels: the backtracking rows in one K4b launch, the rule "
                        "rows in one K2c launch, on the dense worst-case quadratic as the c = 0 "
                        "cubic model")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs float32; cpu runs float64, the reference's regime")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")

    path = os.path.join(args.outdir, "nesterov_worst_case.jsonl")
    sink = Sink(path)
    opt = run_nesterov_worst_case(sink, device=args.device, k=args.k, n=args.n, lip=args.L,
                                  tol=args.tol, maxit=args.maxit, resident=args.resident)
    print(f"{path}: optimum={opt:.8f}")
    if not args.no_plot:
        plot_convergence(path)


if __name__ == "__main__":
    main()
