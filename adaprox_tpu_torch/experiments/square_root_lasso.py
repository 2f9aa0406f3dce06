"""Square-root lasso experiment (counterpart of
``adaprox_tpu/experiments/square_root_lasso.py``; reference
experiments/square_root_lasso/runme.jl).

A fully nonsmooth composite: f = 0, g = lam ||.||_1, h = Translate(NormL2, -y),
i.e. ||A x - y||_2, with A = [X 1] dense (runme.jl:37-42). Datasets
cpusmall_scale, abalone and housing_scale, lam 10, maxit 5000, tol 1e-5; the
JSONL keeps [method, norm_res, A_evals, At_evals] (the cost is A_evals +
At_evals). A dataset whose LIBSVM file is not in the datasets directory is
replaced by the shape-matched synthetic data of ``utils.datasets``
(``data_source`` says which). ``least_absolute_deviation`` is this driver with
h = Translate(NormL1, -y).

The menu, in the JAX driver's order: Condat-Vu with the reference's par steps
(Lf = 0: gamma = 1/||A||, sigma = 0.99/||A||, ||A|| the Frobenius norm),
Malitsky-Pock for the 15 couplings t of ``T_VALUES`` (sigma0 = 1) and AdaPDM+
for the same 15 (eta0 = ||A||): 31 rows.

Where it runs. The default path runs every row through the engine
(``condat_vu``, ``malitsky_pock``, ``adaptive_linesearch_primal_dual``), on the
card or, with ``--device cpu``, on the CPU in f64. ``--resident`` pads A and y
with zeros to multiples of 128 in both dimensions (exact for this f = 0
translate family) and writes all 31 rows from three launches: the Condat-Vu
row from one K7d launch (``ops.resident_f0.resident_condat_vu``), the 15
Malitsky-Pock rows from one K7a launch (``resident_mpls_sweep``) and the 15
AdaPDM+ rows from another (``resident_adapdmp_sweep``), when the padded A fits
the JAX driver's routing limit (24 MiB a layout), else it falls back to the
engine as the JAX driver does. The wall_s of the meta row times the solves
only, not the JSONL writes.

``--fused`` runs the Condat-Vu row on the fused one-pass primal-dual update
(``solvers.pd_fused.fused_condat_vu``: one K5 pass over A' an iteration, A'
formed once and passed as ``at``; the LIBSVM shapes auto-pad, [X 1]' to 16 x m
rounded up to 128) and the 30 t-sweep rows on the engine, as the JAX driver does.
With ``--resident`` as well, the resident path writes the Condat-Vu row when it
is taken.

``--resident-grid`` runs the whole multi-dataset experiment in three launches: the
datasets' [X 1] and y zero-padded to one common shape (the largest multiples of 128
over the datasets), Condat-Vu for all of them in one K7c launch
(``resident_cv_grid``), the 15 couplings x the datasets in one K7b launch a family
(``resident_mpls_grid``, ``resident_adapdmp_grid``). It writes each dataset's 31 rows,
a meta row with the grid totals (``grid_total_s``) and each file's share of them
(``wall_s``, the total over the dataset count), as the JAX driver does. Past the
routing limit it raises, as the JAX driver does: there is no fallback.

    python -m adaprox_tpu_torch.experiments.square_root_lasso
    python -m adaprox_tpu_torch.experiments.square_root_lasso --resident
    python -m adaprox_tpu_torch.experiments.square_root_lasso --fused
    python -m adaprox_tpu_torch.experiments.square_root_lasso --resident-grid
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..convert import sqrt_lasso_from_numpy
from ..ops.resident_f0 import (resident_adapdmp_grid, resident_adapdmp_records,
                               resident_adapdmp_sweep, resident_condat_vu, resident_cv_grid,
                               resident_mpls_grid, resident_mpls_sweep)
from ..ops.resident_mp import resident_mp_records
from ..ops.resident_pd import resident_cv_records
from ..solvers.adapdm_plus import adaptive_linesearch_primal_dual
from ..solvers.malitsky_pock import malitsky_pock
from ..solvers.pd_fused import fused_condat_vu
from ..solvers.primal_dual import condat_vu
from ..utils.datasets import load_or_synthesize
from ..utils.libsvm import load_libsvm_dataset
from .common import Sink, group_rows, pad_tiles, plot_lines, run_timed, sync_wall

T_VALUES = [0.01, 0.15, 0.02, 0.025, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 50, 100]
KEYS = ["method", "norm_res", "A_evals", "At_evals"]
# the JAX driver's routing limit: a layout of A in a TPU core's VMEM
_VMEM_BYTES = 24 * 1024 * 1024
FAST_METHODS = ["Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
NOT_OFFERED = ("--vmap-sweep and --live are not offered yet: they need the batched engine and "
               "utils/live.py")


def load(name_or_path):
    """(X, y, source) of a LIBSVM file or a dataset name."""
    if os.path.isfile(str(name_or_path)):
        x_np, y_np = load_libsvm_dataset(name_or_path)
        return x_np, y_np, "libsvm"
    return load_or_synthesize(str(name_or_path))


def cv_steps(norm_a):
    """Condat-Vu's (gamma, sigma) with Lf = 0 as Python floats (alpha = 1)."""
    return 1.0 / norm_a, 0.99 / norm_a


def resident_inputs(a, y):
    """A and y zero-padded to multiples of 128 in both dimensions, as the JAX
    driver pads them, or None when a layout exceeds the routing limit."""
    a_pad, bv_pad = pad_tiles(a, y, m_mult=128, n_mult=128)
    if a_pad.numel() * a_pad.element_size() > _VMEM_BYTES:
        return None
    return a_pad, bv_pad


def run_composite(name_or_path, sink, inner="l2", *, device, lam=10.0, tol=1e-5, maxit=5000,
                  dtype=None, resident=False, fused=False):
    """Run the menu on dataset ``name_or_path`` on ``device`` with h's inner norm
    ``inner`` ("l2" or "l1"); ``fused`` puts the Condat-Vu row on K5. ``dtype``
    defaults to float64 on the CPU (the reference's regime) and float32 on CUDA.
    Returns the data source ("libsvm" or "synthetic")."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    x_np, y_np, source = load(name_or_path)
    m, n = x_np.shape
    f, g, h, a_op, norm_a = sqrt_lasso_from_numpy(x_np, y_np, lam, inner, device=device,
                                                  dtype=dtype)
    x0 = torch.zeros(n + 1, dtype=dtype, device=device)
    y0 = torch.zeros(m, dtype=dtype, device=device)
    times = {}

    inputs = resident_inputs(a_op.a, -h.b) if resident else None
    if resident and inputs is None:
        print(f"  [resident] {(-(-m // 128) * 128, -(-(n + 1) // 128) * 128)} exceeds the "
              "routing limit; falling back to the engine")
    if inputs is not None:
        a_pad, bv_pad = inputs
        gamma, sigma = cv_steps(norm_a)
        _, numit, _, _, hists = run_timed(times, "Condat-Vu", lambda: resident_condat_vu(
            a_pad, bv_pad, float(lam), gamma, sigma, tol, maxit, record=True, h_kind=inner))
        sink.add(SimpleNamespace(records=resident_cv_records(numit, gamma, sigma, hists,
                                                             maxit=maxit), name="Condat-Vu"),
                 primal_dual=True)
        # each t-sweep is one launch; its rows are written after it
        sweeps = (("Malitsky-Pock", resident_mpls_sweep, 1.0, resident_mp_records),
                  ("AdaPDM+", resident_adapdmp_sweep, norm_a, resident_adapdmp_records))
        for fam, sweep, p2, records in sweeps:
            _, numits, _, _, _, hists = run_timed(times, f"{fam} t-sweep", lambda: sweep(
                a_pad, bv_pad, float(lam), T_VALUES, p2, tol, maxit, record=True,
                h_kind=inner))
            for i, t in enumerate(T_VALUES):
                sink.add(SimpleNamespace(records=records(numits[i], tuple(h[i] for h in hists),
                                                         maxit=maxit),
                                         name=f"{fam} (t={t})"), primal_dual=True)
    else:
        if fused:
            # A' formed once, contiguous: the kernel streams its rows
            at = a_op.a.t().contiguous()
            sink.add(run_timed(times, "Condat-Vu", lambda: fused_condat_vu(
                x0, y0, f=f, g=g, h=h, A=a_op.a, at=at, Lf=0.0, norm_A=norm_a, tol=tol,
                maxit=maxit, history=True, name="Condat-Vu")), primal_dual=True)
        else:
            sink.add(run_timed(times, "Condat-Vu", lambda: condat_vu(
                x0, y0, f=f, g=g, h=h, A=a_op, Lf=0.0, norm_A=norm_a, tol=tol, maxit=maxit,
                history=True, name="Condat-Vu")), primal_dual=True)
        sweeps = (("Malitsky-Pock", lambda t, name: malitsky_pock(
            x0, y0, f=f, g=g, h=h, A=a_op, sigma=1.0, t=t, tol=tol, maxit=maxit, history=True,
            name=name)), ("AdaPDM+", lambda t, name: adaptive_linesearch_primal_dual(
                x0, y0, f=f, g=g, h=h, A=a_op, eta=norm_a, t=t, tol=tol, maxit=maxit,
                history=True, name=name)))
        for fam, solve in sweeps:
            total = 0.0
            for t in T_VALUES:
                res, wall = sync_wall(lambda t=t: solve(float(t), f"{fam} (t={t})"))
                sink.add(res, primal_dual=True)
                total += wall
            times[f"{fam} t-sweep"] = round(total, 4)
    if inputs is not None:
        fast_path, fast_methods = "resident", FAST_METHODS
    elif fused:
        fast_path, fast_methods = "fused", ["Condat-Vu"]
    else:
        fast_path, fast_methods = "default", []
    sink.emit_meta(wall_s=times, fast_path=fast_path, fast_methods=fast_methods)
    return source


def grid_inputs(datasets, *, device, dtype):
    """The datasets of ``--resident-grid`` as the JAX driver stacks them: each [X 1] and y
    zero-padded to the common shape (m_max, n_max), the largest multiples of 128 over the
    datasets, in ``dtype`` on ``device``. Returns (names, a_stack (D, m_max, n_max),
    bv_stack (D, m_max), norm_as (each unpadded [X 1]'s Frobenius norm, from float64),
    sources). Raises ValueError when one padded layout exceeds the routing limit (24 MiB
    a layout), as the JAX driver does."""
    loaded, m_max, n_max = [], 0, 0
    for ds in datasets:
        x_np, y_np, source = load(ds)
        m, n = x_np.shape
        a_np = np.hstack([np.asarray(x_np, dtype=np.float64), np.ones((m, 1))])
        loaded.append((os.path.basename(str(ds)), a_np, np.asarray(y_np, dtype=np.float64),
                       source))
        m_max = max(m_max, -(-m // 128) * 128)
        n_max = max(n_max, -(-(n + 1) // 128) * 128)
    if m_max * n_max * torch.empty((), dtype=dtype).element_size() > _VMEM_BYTES:
        raise ValueError(f"common padded shape ({m_max}, {n_max}) exceeds the resident VMEM "
                         "budget; run per-dataset --resident instead")
    a_stack = np.zeros((len(loaded), m_max, n_max))
    bv_stack = np.zeros((len(loaded), m_max))
    for i, (_, a_np, y_np, _) in enumerate(loaded):
        a_stack[i, :a_np.shape[0], :a_np.shape[1]] = a_np
        bv_stack[i, :y_np.shape[0]] = y_np
    return ([name for name, _, _, _ in loaded],
            torch.as_tensor(a_stack, device=device).to(dtype),
            torch.as_tensor(bv_stack, device=device).to(dtype),
            [float(np.linalg.norm(a_np)) for _, a_np, _, _ in loaded],
            [source for _, _, _, source in loaded])


def run_composite_grid(datasets, outdir, inner="l2", *, device, lam=10.0, tol=1e-5,
                       maxit=5000):
    """The whole multi-dataset experiment in three launches (JAX's ``run_composite_grid``):
    the datasets stacked by ``grid_inputs``, Condat-Vu for all of them in one
    ``resident_cv_grid`` call and each family's (dataset x t) grid in one
    ``resident_mpls_grid`` or ``resident_adapdmp_grid`` call, each timed alone
    (``sync_wall``). Writes ``outdir/<dataset>.jsonl`` for each dataset: its Condat-Vu,
    15 Malitsky-Pock and 15 AdaPDM+ rows, a meta row with each file's share of the
    three walls (``wall_s``, the total over the dataset count), ``fast_path``
    "resident-grid", the totals (``grid_total_s``) and ``fast_methods``, and the data
    source. The datasets are float64 on the CPU (the plain versions) and float32 on CUDA
    (the kernels)."""
    device = torch.device(device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    names, a_stack, bv_stack, norm_as, sources = grid_inputs(datasets, device=device,
                                                             dtype=dtype)
    dcount = len(names)
    lams = [float(lam)] * dcount
    steps = [cv_steps(na) for na in norm_as]
    cv_out, cv_wall = sync_wall(lambda: resident_cv_grid(
        a_stack, bv_stack, lams, [g for g, _ in steps], [s for _, s in steps], tol, maxit,
        h_kind=inner))
    mp_out, mp_wall = sync_wall(lambda: resident_mpls_grid(
        a_stack, bv_stack, lams, T_VALUES, [1.0] * dcount, tol, maxit, record=True,
        h_kind=inner))
    pd_out, pd_wall = sync_wall(lambda: resident_adapdmp_grid(
        a_stack, bv_stack, lams, T_VALUES, norm_as, tol, maxit, record=True, h_kind=inner))
    walls = dict(zip(FAST_METHODS, (cv_wall, mp_wall, pd_wall)))
    for i, (name, source) in enumerate(zip(names, sources)):
        path = os.path.join(outdir, f"{name}.jsonl")
        sink = Sink(path, keys=KEYS)
        gamma, sigma = steps[i]
        sink.add(SimpleNamespace(records=resident_cv_records(
            cv_out[1][i], gamma, sigma, tuple(h[i] for h in cv_out[4]), maxit=maxit),
            name="Condat-Vu"), primal_dual=True)
        for fam, out, records in (("Malitsky-Pock", mp_out, resident_mp_records),
                                  ("AdaPDM+", pd_out, resident_adapdmp_records)):
            for j, t in enumerate(T_VALUES):
                sink.add(SimpleNamespace(records=records(
                    out[1][i][j], tuple(h[i][j] for h in out[5]), maxit=maxit),
                    name=f"{fam} (t={t})"), primal_dual=True)
        sink.emit_meta(wall_s={k: round(v / dcount, 4) for k, v in walls.items()},
                       fast_path="resident-grid",
                       grid_total_s={k: round(v, 4) for k, v in walls.items()},
                       fast_methods=FAST_METHODS)
        sink.emit_meta(data_source=source)
        print(f"{path}: data={source} (grid-batched)")
    return names


def plot_residual(path, title_prefix="Square root lasso"):
    from ..utils.logging import find_best, read_jsonl

    groups = group_rows(read_jsonl(path))
    names = []
    for fam in ["Condat-Vu", "Malitsky-Pock", "AdaPDM+"]:
        matching = [k for k in groups if k.startswith(fam)]
        if matching:
            names.append(find_best(groups, matching, "norm_res", 1e-5,
                                   lambda row: row["A_evals"] + row["At_evals"]))
    series = [(name, [r["A_evals"] + r["At_evals"] for r in groups[name]],
               [r["norm_res"] for r in groups[name]]) for name in names]
    return plot_lines(path, series, f"{title_prefix} ({os.path.basename(path)})",
                      "#calls to A, A'", "||v||")


def main(argv=None, inner="l2", default_outdir="results/square_root_lasso"):
    p = argparse.ArgumentParser(epilog=NOT_OFFERED)
    p.add_argument("--outdir", default=default_outdir)
    p.add_argument("--maxit", type=int, default=5000)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--lam", type=float, default=10.0)
    p.add_argument("--datasets", default="cpusmall_scale,abalone,housing_scale")
    p.add_argument("--resident", action="store_true",
                   help="the whole-solve kernels: Condat-Vu in one K7d launch, each t-sweep in "
                        "one K7a launch")
    p.add_argument("--resident-grid", action="store_true",
                   help="the whole multi-dataset experiment in three launches: Condat-Vu over "
                        "the datasets in one K7c launch, each family's (dataset x t) grid in "
                        "one K7b launch")
    p.add_argument("--fused", action="store_true",
                   help="Condat-Vu on the one-pass fused primal-dual update, K5 (auto-pads "
                        "LIBSVM shapes); the t-sweeps on the engine")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs float32; cpu runs float64, the reference's regime")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but PyTorch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")

    title = "Square root lasso" if inner == "l2" else "Least absolute deviation"
    if args.resident_grid:
        names = run_composite_grid(args.datasets.split(","), args.outdir, inner,
                                   device=args.device, lam=args.lam, tol=args.tol,
                                   maxit=args.maxit)
        if not args.no_plot:
            for name in names:
                plot_residual(os.path.join(args.outdir, f"{name}.jsonl"), title)
        return
    for ds in args.datasets.split(","):
        path = os.path.join(args.outdir, f"{os.path.basename(ds)}.jsonl")
        sink = Sink(path, keys=KEYS)
        src = run_composite(ds, sink, inner, device=args.device, lam=args.lam, tol=args.tol,
                            maxit=args.maxit, resident=args.resident, fused=args.fused)
        sink.emit_meta(data_source=src)
        print(f"{path}: data={src}")
        if not args.no_plot:
            plot_residual(path, title)


if __name__ == "__main__":
    main()
