"""Nesterov worst-case quadratic experiment (counterpart of
``adaprox_tpu/experiments/nesterov_worst_case.py``; reference
experiments/nesterov_worst_case/runme.jl).

WorstQuadratic(k, L) with the known optimum (L/8)(1/(k+1) - 1) (runme.jl:53),
logged first as a pseudo row with ``method`` null; k = n = 100, L = 100, tol
1e-6, maxit 10_000. A sanity check that the adaptive methods degrade
gracefully against the accelerated one. Plot: F - F* vs grad_f_evals.

The menu holds the rows ported so far, in the reference order: Fixed
stepsize PGM, Fixed Nesterov, AdaPGM (MM) and AdaPGM; the two backtracking
rows are skipped and printed. ``--resident`` runs the four rows as ONE
record-mode launch of the rule-sweep kernel K2c
(``ops.resident.resident_rule_sweep``) on the worst case written as the
cubic model with c = 0: the dense H = (L/4) tridiag(-1, 2, -1) on the first
k coordinates and q = -(L/4) e_1, zero-padded to a multiple of 128 (the
padded coordinates stay exactly 0); the sweep's wall goes into a
``grid_total_s`` meta row.

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
from ..solvers.nesterov import fixed_nesterov
from ..solvers.primal_dual import adaptive_proxgrad, fixed_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from .common import Sink, group_rows, plot_lines, run_menu, sync_wall

# rows of the JAX driver's menu whose solvers are not ported yet
NOT_PORTED = ("Backtracking PG", "Backtracking Nesterov")

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
    print(f"  [nesterov_worst_case] skipping rows not ported yet: {', '.join(NOT_PORTED)}")

    if resident:
        # ONE record-mode K2c launch for the four rule rows; wall_s carries each
        # row's share, grid_total_s the sweep's wall
        h, q = worst_case_model(k, n, lip, device, dtype)
        x0_pad = torch.zeros(h.shape[0], dtype=dtype, device=device)
        specs = [(1 / lip, rule, mom) for _, rule, mom in RESIDENT_ROWS]
        (_, numit, _, _, hists), wall = sync_wall(lambda: resident_rule_sweep(
            h, q, x0_pad, rule_rows(specs, tol=tol, maxit=maxit), tol, maxit, prox_kind="zero",
            obj_kind="cubic", cube_c=0.0))
        for j, (name, _, mom) in enumerate(RESIDENT_ROWS):
            sink.add(SimpleNamespace(records=resident_records(
                numit[j], *(h_[j] for h_ in hists), maxit=maxit, momentum=mom), name=name))
            times[name] = round(wall / len(RESIDENT_ROWS), 4)
        sink.emit_meta(grid_total_s={"rule sweep": round(wall, 4)})
        sink.emit_meta(wall_s=times, fast_path="resident", fast_methods=sorted(times))
        return optimum

    base = dict(f=f, g=g, tol=tol)
    menu = [
        ("Fixed stepsize PGM", maxit, lambda **o: fixed_proxgrad(
            x0, gamma=1 / lip, name="Fixed stepsize PGM", **base, **o)),
        ("Fixed Nesterov", maxit, lambda **o: fixed_nesterov(
            x0, gamma=1 / lip, name="Fixed Nesterov", **base, **o)),
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
                   help="the rule-sweep kernel K2c: the four rule rows in one launch, on the "
                        "dense worst-case quadratic as the c = 0 cubic model")
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
