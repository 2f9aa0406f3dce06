"""Cubic-regularized logistic-regression subproblem (counterpart of
``adaprox_tpu/experiments/cubic_sparse_logreg.py``; reference
experiments/cubic_sparse_logreg/runme.jl).

Builds the exact logistic Hessian H and gradient q at x0 = 0
(logistic_loss_grad_Hessian, runme.jl:34-45) and solves the cubic model
f = 0.5 x'Hx + q'x + (c/6)||x||^3 with g = 0; gamma0 is a secant estimate
from a random perturbation (runme.jl:72-76); lam (c) 1, maxit 100, tol 1e-7.
Cost metric: f_evals (one f evaluation is one product with H). Datasets
mushrooms, a5a and phishing; a dataset whose LIBSVM file is not in the
datasets directory is replaced by the shape-matched synthetic data of
``utils.datasets`` (``data_source`` says which).

The menu, in the reference order: the ground truth (AdaPGM at tol/10 and
maxit x 10, logged with ``method`` null), PGM (backtracking) with xi 1, 1.5
and 2, Nesterov (backtracking), AdaPGM (MM), AdaPGM (Ours) and aGRAAL (its
companion point drawn as the JAX driver draws it: ``utils.jax_random``).
``--resident`` runs the four backtracking rows as ONE record-mode launch of
the backtracking sweep K4b (``ops.resident_bt.resident_bt_sweep``), the
three rule rows as ONE launch of the rule-sweep kernel K2c
(``ops.resident.resident_rule_sweep``) and aGRAAL as ONE launch of K4's
aGRAAL kernel (``ops.resident_bt.resident_agraal``), all with
``obj_kind="cubic"`` on H and q zero-padded to a multiple of 128, as the JAX
driver pads them, the rule rows with per-row tol and caps, and emits the two
sweeps' walls in a ``grid_total_s`` meta row.

    python -m adaprox_tpu_torch.experiments.cubic_sparse_logreg
    python -m adaprox_tpu_torch.experiments.cubic_sparse_logreg --resident
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..convert import cubic_from_numpy
from ..ops.prox import Zero
from ..ops.resident import resident_records, resident_rule_sweep, rule_rows
from ..ops.resident_bt import resident_agraal, resident_bt_sweep
from ..solvers.agraal import agraal
from ..solvers.primal_dual import adaptive_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from ..utils.datasets import load_or_synthesize
from ..utils.libsvm import load_libsvm_dataset
from .common import (BT_ROWS, Sink, add_agraal_row, add_bt_rows, bt_menu, bt_sweep_rows,
                     companion_point, group_rows, plot_lines, run_menu, run_timed, sync_wall)

# the rule sweep's rows, in the JAX driver's order: (name, rule_kind); the
# ground truth (name None) runs at tol/10 with cap maxit x 10
RESIDENT_ROWS = ((None, "adapgm"), ("AdaPGM (MM)", "mm"), ("AdaPGM (Ours)", "adapgm"))


def logistic_loss_grad_hessian(x_np, y_np, w):
    """Reference runme.jl:34-45 with the bias column folded in last."""
    m = y_np.shape[0]
    logits = x_np @ w[:-1] + w[-1]
    probs = 1.0 / (1.0 + np.exp(-logits))
    g = x_np.T @ (probs - y_np) / m
    g = np.concatenate([g, [np.mean(probs - y_np)]])
    sb = probs * (1 - probs) / m
    xr = x_np.T @ sb  # X' R 1
    h = np.block([
        [x_np.T @ (sb[:, None] * x_np), xr[:, None]],
        [xr[None, :], np.array([[sb.sum()]])],
    ])
    return h, g


def rule_specs(gam, tol, maxit):
    """(gamma0, rule_kind, momentum, tol, cap) of each row of RESIDENT_ROWS."""
    return [(gam, rule, False, tol / 10 if name is None else tol, maxit * 10 if name is None
             else maxit) for name, rule in RESIDENT_ROWS]


def secant_gamma(f, x0_np, seed, device, dtype):
    """gamma0 = |dx|^2 / <grad(x0) - grad(x0 + dx), -dx> with dx ~ N(0, I) from
    ``np.random.default_rng(seed)`` (runme.jl:72-76)."""
    rng = np.random.default_rng(seed)
    x_pert = x0_np + rng.standard_normal(x0_np.shape[0])
    _, g0 = f.value_and_grad(torch.as_tensor(x0_np, device=device).to(dtype))
    _, gp = f.value_and_grad(torch.as_tensor(x_pert, device=device).to(dtype))
    dx = x0_np - x_pert
    return float(dx @ dx / ((g0 - gp).cpu().numpy() @ dx))


def padded_model(q_mat, q_vec, device, dtype, mult=128):
    """H and q zero-padded to a multiple of ``mult`` (the JAX driver's TPU
    tiles): the padded coordinates have zero gradient and stay exactly 0."""
    n = q_vec.shape[0]
    n_pad = -(-n // mult) * mult
    h_pad = torch.zeros((n_pad, n_pad), dtype=dtype, device=device)
    h_pad[:n, :n] = torch.as_tensor(q_mat, device=device).to(dtype)
    q_pad = torch.zeros(n_pad, dtype=dtype, device=device)
    q_pad[:n] = torch.as_tensor(q_vec, device=device).to(dtype)
    return h_pad, q_pad


def run_cubic_logreg_data(name_or_path, sink, *, device, lam=1.0, tol=1e-7, maxit=100,
                          seed=0, dtype=None, resident=False):
    """Run the menu on dataset ``name_or_path`` (a LIBSVM file, or a name of
    ``utils.datasets.DATASET_SHAPES``) on ``device``. ``dtype`` defaults to
    float64 on the CPU (the reference's regime) and float32 on CUDA. Returns
    the data source ("libsvm" or "synthetic")."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path, labels=(0.0, 1.0))
        source = "libsvm"
    else:
        x_np, y_np, source = load_or_synthesize(str(name_or_path), labels=(0.0, 1.0))
    n = x_np.shape[1] + 1

    x0_np = np.zeros(n)
    q_mat, q_vec = logistic_loss_grad_hessian(x_np, y_np, x0_np)
    f = cubic_from_numpy(q_mat, q_vec, float(lam), device=device, dtype=dtype)
    g = Zero()
    gam = secant_gamma(f, x0_np, seed, device, dtype)
    x0 = torch.zeros(n, dtype=dtype, device=device)
    times = {}

    if resident:
        # ONE record-mode K4b launch for the four backtracking rows, ONE K2c
        # launch for the three rule rows, the ground truth included (per-row tol
        # and caps), and ONE aGRAAL launch; wall_s carries each row's share of
        # its sweep's wall (aGRAAL its own), grid_total_s the sweeps' walls
        h_pad, q_pad = padded_model(q_mat, q_vec, device, dtype)
        x0_pad = torch.zeros(h_pad.shape[0], dtype=dtype, device=device)
        skw = dict(prox_kind="zero", obj_kind="cubic", cube_c=float(lam))
        bt_out, bt_wall = sync_wall(lambda: resident_bt_sweep(
            h_pad, q_pad, x0_pad, bt_sweep_rows(BT_ROWS, gam), tol, maxit, **skw))
        specs = rule_specs(gam, tol, maxit)
        (_, numit, _, _, hists), wall = sync_wall(lambda: resident_rule_sweep(
            h_pad, q_pad, x0_pad, rule_rows(specs), tol, maxit * 10, **skw))
        # the companion point: noise on the n unpadded coordinates
        ag_out, ag_wall = sync_wall(lambda: resident_agraal(
            h_pad, q_pad, x0_pad, companion_point(x0_pad, n), gam, tol, maxit, record=True,
            **skw))

        def add_rule_row(j):
            name, cap = RESIDENT_ROWS[j][0], specs[j][4]
            sink.add(SimpleNamespace(records=resident_records(
                numit[j], *(h[j][:cap] for h in hists), maxit=cap), name=name))

        # the rows in the JAX driver's order
        add_rule_row(0)  # the ground truth
        add_bt_rows(sink, BT_ROWS, bt_out, maxit)
        for j in range(1, len(RESIDENT_ROWS)):
            add_rule_row(j)
        add_agraal_row(sink, ag_out, maxit)
        for name, _, _ in BT_ROWS:
            times[name] = round(bt_wall / len(BT_ROWS), 4)
        for name, _ in RESIDENT_ROWS:
            times[name or "(ground truth)"] = round(wall / len(RESIDENT_ROWS), 4)
        times["aGRAAL"] = round(ag_wall, 4)
        sink.emit_meta(grid_total_s={"bt sweep": round(bt_wall, 4), "rule sweep": round(wall, 4)})
        sink.emit_meta(wall_s=times, fast_path="resident", fast_methods=sorted(times))
        return source

    # the ground-truth prerun (tol/10) feeds the optimum the plots normalize against
    sink.add(run_timed(times, "(ground truth)", lambda: adaptive_proxgrad(
        x0, f=f, g=g, rule=AdaPGMRule(gamma=gam), tol=tol / 10, maxit=maxit * 10,
        history=True, name=None)))
    base = dict(f=f, g=g, tol=tol)
    menu = bt_menu(BT_ROWS, x0, gam, maxit, base) + [
        ("AdaPGM (MM)", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=MalitskyMishchenkoRule(gamma=gam), name="AdaPGM (MM)", **base, **o)),
        ("AdaPGM (Ours)", maxit, lambda **o: adaptive_proxgrad(
            x0, rule=AdaPGMRule(gamma=gam), name="AdaPGM (Ours)", **base, **o)),
        # the solver draws the companion point over the whole x
        ("aGRAAL", maxit, lambda **o: agraal(x0, gamma0=gam, name="aGRAAL", **base, **o)),
    ]
    menu_path = run_menu(sink, times, menu)
    sink.emit_meta(wall_s=times, fast_path=menu_path, fast_methods=[])
    return source


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    series = [
        (name, [r["f_evals"] for r in rs], [r["objective"] - optimum for r in rs])
        for name, rs in group_rows(rows).items()
    ]
    return plot_lines(path, series, f"Cubic regularization ({os.path.basename(path)})",
                      "# of calls to Q", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/cubic_sparse_logreg")
    p.add_argument("--maxit", type=int, default=100)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--datasets", default="mushrooms,a5a,phishing")
    p.add_argument("--resident", action="store_true",
                   help="the whole-solve kernels: the backtracking rows in one K4b launch, "
                        "the three rule rows (the ground truth included) in one K2c launch, "
                        "aGRAAL in one launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs float32; cpu runs float64, the reference's regime")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")

    for ds in args.datasets.split(","):
        path = os.path.join(args.outdir, f"{os.path.basename(ds)}.jsonl")
        sink = Sink(path)
        src = run_cubic_logreg_data(ds, sink, device=args.device, lam=args.lam, tol=args.tol,
                                    maxit=args.maxit, resident=args.resident)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
