"""Sparse logistic regression experiment (counterpart of
``adaprox_tpu/experiments/sparse_logreg.py``; reference
experiments/sparse_logreg/runme.jl).

f = mean logistic loss with the bias folded in, g = lam ||.||_1 (lam 0.01);
Lf = ||X1 X1'|| / (4 m) with X1 = [X 1] (runme.jl:58-59; Julia's matrix norm
is the Frobenius norm, ``--spectral-lf`` takes the tighter ||X1||_2^2 / 4m);
the ground truth is a high-accuracy AdaPGM run at tol/10 and maxit x 10
(runme.jl:64-73), logged with ``method`` null; datasets mushrooms, a5a and
phishing, maxit 2000, tol 1e-7 (Nesterov gets maxit/2, runme.jl:94,105).
Plot: F(x_k) - F* vs (grad_f_evals + f_evals). A dataset whose LIBSVM file
is not in the datasets directory is replaced by the shape-matched synthetic
data of ``utils.datasets`` (``data_source`` says which).

The menu, in the reference order: the ground truth, PGM (1/Lf), PGM
(backtracking) with xi 1, 1.5 and 2 and Nesterov (backtracking) (each at
maxit/2), Nesterov (fixed), AdaPGM (MM), AdaPGM (Ours) and aGRAAL (its
companion point drawn as the JAX driver draws it: ``utils.jax_random``).
``--resident`` runs the four backtracking rows as ONE record-mode launch of
the backtracking sweep K4b (``ops.resident_bt.resident_bt_sweep``), the five
rule rows as ONE launch of the rule-sweep kernel K2c
(``ops.resident.resident_rule_sweep``) and aGRAAL as ONE launch of K4's
aGRAAL kernel (``ops.resident_bt.resident_agraal``), all with
``obj_kind="logreg"`` on [X 1] zero-padded as the JAX driver pads it, the
rule rows with per-row tol and caps, and emits the two sweeps' walls in a
``grid_total_s`` meta row. On the card every shape goes to the kernels. On
the CPU the JAX driver's routing rule (``resident_supported``) applies, with
its printed fallback to the engine, so the two drivers' JSONL compare row for
row there too.

    python -m adaprox_tpu_torch.experiments.sparse_logreg
    python -m adaprox_tpu_torch.experiments.sparse_logreg --resident
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..models.objectives import LogisticLoss
from ..ops.prox import L1Norm
from ..ops.resident import resident_records, resident_rule_sweep, resident_supported, rule_rows
from ..ops.resident_bt import resident_agraal, resident_bt_sweep
from ..solvers.agraal import agraal
from ..solvers.nesterov import fixed_nesterov
from ..solvers.primal_dual import adaptive_proxgrad, fixed_proxgrad
from ..solvers.rules import AdaPGMRule, MalitskyMishchenkoRule
from ..utils.datasets import load_or_synthesize
from ..utils.libsvm import load_libsvm_dataset
from .common import (BT_ROWS, Sink, add_agraal_row, add_bt_rows, bt_menu, bt_sweep_rows,
                     companion_point, group_rows, pad_tiles, plot_lines, run_menu, run_timed,
                     sync_wall)

# the rule sweep's rows, in the JAX driver's order: (name, rule_kind, momentum);
# the ground truth (name None) runs at tol/10 with cap maxit x 10, Nesterov
# (fixed) with cap maxit/2
RESIDENT_ROWS = ((None, "adapgm", False), ("PGM (1/Lf)", "fixed", False),
                 ("Nesterov (fixed)", "fixed", True), ("AdaPGM (MM)", "mm", False),
                 ("AdaPGM (Ours)", "adapgm", False))


def lipschitz_estimate(x_np, spectral=False):
    """Lf of the mean logistic loss on X1 = [X 1]: Julia's norm(X1*X1')/4m,
    the Frobenius norm of the Gram, computed gram-free as ||X1' X1||_F (both
    are sqrt(sum sigma_i^4)); ``spectral=True``: the tighter ||X1||_2^2/4m."""
    m = x_np.shape[0]
    x1 = np.hstack([x_np, np.ones((m, 1))])
    if spectral:
        return float(np.linalg.norm(x1, 2) ** 2 / (4 * m))
    return float(np.linalg.norm(x1.T @ x1) / (4 * m))


def rule_specs(gam, tol, maxit):
    """(gamma0, rule_kind, momentum, tol, cap) of each row of RESIDENT_ROWS."""
    caps = (maxit * 10, maxit, maxit // 2, maxit, maxit)
    return [(gam, rule, mom, tol / 10 if name is None else tol, cap)
            for (name, rule, mom), cap in zip(RESIDENT_ROWS, caps)]


def run_logreg_l1_data(name_or_path, sink, *, device, lam=0.01, tol=1e-7, maxit=2000,
                       dtype=None, spectral_lf=False, resident=False):
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
    m, n_feat = x_np.shape
    n = n_feat + 1

    x_mat = torch.as_tensor(x_np, device=device).to(dtype)
    y = torch.as_tensor(y_np, device=device).to(dtype)
    f = LogisticLoss(x_mat, y)
    g = L1Norm(torch.as_tensor(lam, dtype=dtype, device=device))
    gam = 1.0 / lipschitz_estimate(x_np, spectral=spectral_lf)
    x0 = torch.zeros(n, dtype=dtype, device=device)
    times = {}

    use_resident = False
    if resident:  # pad [X 1] only when the fast path is requested
        x1 = torch.cat([x_mat, torch.ones((m, 1), dtype=dtype, device=device)], 1)
        x1_pad, y_pad = pad_tiles(x1, y)
        # K2c takes every shape on the card; the CPU follows the JAX driver's routing
        use_resident = device.type == "cuda" or resident_supported(x1_pad)
        if not use_resident:
            print(f"  [resident] unsupported shape/size {tuple(x1_pad.shape)} "
                  f"({x1_pad.dtype}); falling back to the engine")

    if use_resident:
        # ONE record-mode K4b launch for the four backtracking rows (half
        # budget), ONE K2c launch for the five rule rows, the ground truth
        # included (per-row tol and caps), and ONE aGRAAL launch; wall_s carries
        # each row's share of its sweep's wall (aGRAAL its own), grid_total_s
        # the sweeps' walls
        x0p = torch.zeros(x1_pad.shape[1], dtype=dtype, device=device)
        lkw = dict(prox_kind="l1", p1=float(lam), obj_kind="logreg", m_true=float(m))
        half_it = maxit // 2
        bt_out, bt_wall = sync_wall(lambda: resident_bt_sweep(
            x1_pad, y_pad, x0p, bt_sweep_rows(BT_ROWS, gam), tol, half_it, **lkw))
        specs = rule_specs(gam, tol, maxit)
        (_, numit, _, _, hists), wall = sync_wall(lambda: resident_rule_sweep(
            x1_pad, y_pad, x0p, rule_rows(specs), tol, maxit * 10, **lkw))
        # the companion point: noise on the n = n_feat + 1 unpadded coordinates
        ag_out, ag_wall = sync_wall(lambda: resident_agraal(
            x1_pad, y_pad, x0p, companion_point(x0p, n), gam, tol, maxit, record=True, **lkw))

        def add_rule_row(j):
            (name, _, mom), cap = RESIDENT_ROWS[j], specs[j][4]
            sink.add(SimpleNamespace(records=resident_records(
                numit[j], *(h[j][:cap] for h in hists), maxit=cap, momentum=mom), name=name))

        # the rows in the JAX driver's order
        add_rule_row(0)  # the ground truth
        add_rule_row(1)
        add_bt_rows(sink, BT_ROWS, bt_out, half_it)
        for j in range(2, len(RESIDENT_ROWS)):
            add_rule_row(j)
        add_agraal_row(sink, ag_out, maxit)
        for name, _, _ in BT_ROWS:
            times[name] = round(bt_wall / len(BT_ROWS), 4)
        for name, _, _ in RESIDENT_ROWS:
            times[name or "(ground truth)"] = round(wall / len(RESIDENT_ROWS), 4)
        times["aGRAAL"] = round(ag_wall, 4)
        sink.emit_meta(grid_total_s={"bt sweep": round(bt_wall, 4), "rule sweep": round(wall, 4)})
    else:
        # the ground-truth prerun (tol/10) always runs in history mode: it feeds
        # the optimum the plots normalize against
        sink.add(run_timed(times, "(ground truth)", lambda: adaptive_proxgrad(
            x0, f=f, g=g, rule=AdaPGMRule(gamma=gam), tol=tol / 10, maxit=maxit * 10,
            history=True, name=None)))
        base = dict(f=f, g=g, tol=tol)
        menu = [
            ("PGM (1/Lf)", maxit, lambda **o: fixed_proxgrad(
                x0, gamma=gam, name="PGM (1/Lf)", **base, **o)),
        ] + bt_menu(BT_ROWS, x0, gam, maxit // 2, base) + [
            ("Nesterov (fixed)", maxit // 2, lambda **o: fixed_nesterov(
                x0, gamma=gam, name="Nesterov (fixed)", **base, **o)),
            ("AdaPGM (MM)", maxit, lambda **o: adaptive_proxgrad(
                x0, rule=MalitskyMishchenkoRule(gamma=gam), name="AdaPGM (MM)",
                **base, **o)),
            ("AdaPGM (Ours)", maxit, lambda **o: adaptive_proxgrad(
                x0, rule=AdaPGMRule(gamma=gam), name="AdaPGM (Ours)", **base, **o)),
            # the solver draws the companion point over the whole x
            ("aGRAAL", maxit, lambda **o: agraal(x0, gamma0=gam, name="aGRAAL", **base, **o)),
        ]
        run_menu(sink, times, menu)
    sink.emit_meta(wall_s=times, fast_path="resident" if use_resident else "default",
                   fast_methods=sorted(times) if use_resident else [])
    return source


def plot_convergence(path):
    from ..utils.logging import read_jsonl

    rows = read_jsonl(path)
    optimum = min(r["objective"] for r in rows if "objective" in r)
    series = [
        (name, [r["grad_f_evals"] + r["f_evals"] for r in rs],
         [r["objective"] - optimum for r in rs])
        for name, rs in group_rows(rows).items()
    ]
    return plot_lines(path, series, f"Logistic regression ({os.path.basename(path)})",
                      "calls to A, A'", "F(x_k) - F*")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="results/sparse_logreg")
    p.add_argument("--maxit", type=int, default=2000)
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--lam", type=float, default=0.01)
    p.add_argument("--datasets", default="mushrooms,a5a,phishing")
    p.add_argument("--spectral-lf", action="store_true",
                   help="tighter ||X1||_2^2/4m instead of the reference's "
                        "Frobenius norm(X1*X1')/4m (runme.jl:58-59)")
    p.add_argument("--resident", action="store_true",
                   help="the whole-solve kernels: the backtracking rows in one K4b launch, "
                        "the five rule rows (the ground truth included) in one K2c launch, "
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
        src = run_logreg_l1_data(ds, sink, device=args.device, lam=args.lam, tol=args.tol,
                                 maxit=args.maxit, spectral_lf=args.spectral_lf,
                                 resident=args.resident)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_convergence(path)


if __name__ == "__main__":
    main()
